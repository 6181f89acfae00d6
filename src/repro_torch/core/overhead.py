"""Parsing-overhead model (paper §3.2.1) and profiled-trace preprocessing.

TensorFlow's recorded end time of a communication op includes receiver-side
parsing (deserialization + memory copies).  The paper fits a linear model

    overhead(op) = alpha * op.size + beta

(independent of the DNN model; estimated once per cluster node type) and,
during preprocessing, strips it from each recorded communication op,
re-attaching it as a *dependent compute op* on the receiver's compute
resource.  The transmission itself becomes a pure link op whose service
demand is ``size`` bytes (duration set by the simulated bandwidth share).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .events import Op, StepTemplate


@dataclass(frozen=True)
class OverheadModel:
    alpha: float  # seconds per byte
    beta: float   # seconds

    def __call__(self, size: float) -> float:
        return self.alpha * size + self.beta

    @staticmethod
    def fit(sizes: Sequence[float], overheads: Sequence[float]) -> "OverheadModel":
        """Least-squares fit of the linear overhead model (Fig. 10)."""
        x = np.asarray(sizes, dtype=np.float64)
        y = np.asarray(overheads, dtype=np.float64)
        if x.size < 2:
            raise ValueError("need >= 2 points to fit the overhead model")
        a, b = np.polyfit(x, y, 1)
        return OverheadModel(alpha=float(max(a, 0.0)), beta=float(max(b, 0.0)))

    def r_squared(self, sizes: Sequence[float], overheads: Sequence[float]) -> float:
        x = np.asarray(sizes, dtype=np.float64)
        y = np.asarray(overheads, dtype=np.float64)
        pred = self.alpha * x + self.beta
        ss_res = float(np.sum((y - pred) ** 2))
        ss_tot = float(np.sum((y - np.mean(y)) ** 2))
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0


# ---------------------------------------------------------------------------
# Recorded (TF-style) profile -> simulation-ready StepTemplate
# ---------------------------------------------------------------------------


@dataclass
class RecordedOp:
    """One op as recorded by (emulated) TensorFlow profiling.

    For comm ops, ``start`` is when the transfer was *requested* and ``end``
    when the data was available to the receiver (parse included) — exactly
    the information gap described in §2 of the paper.
    """

    name: str
    res: str                  # downlink[/i], worker, uplink[/i], ps[/i]
    deps: Tuple[int, ...]
    size: float = 0.0         # bytes (comm ops)
    start: float = 0.0
    end: float = 0.0
    priority: float = 0.0
    tags: Dict[str, object] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class RecordedStep:
    ops: List[RecordedOp]
    meta: Dict[str, object] = field(default_factory=dict)


def _receiver_compute_resource(link_res: str) -> str:
    """downlink[:i] is parsed on the worker's recv/parse thread; uplink[:i]
    on the per-worker gRPC server thread at PS i (which then also runs the
    update op, serializing parse -> update as in TensorFlow)."""
    if link_res.startswith("downlink"):
        return "parse"
    if link_res.startswith("uplink"):
        suffix = link_res.split(":", 1)
        return "ps" if len(suffix) == 1 else f"ps:{suffix[1]}"
    raise ValueError(f"not a link resource: {link_res}")


def preprocess_recorded_step(step: RecordedStep,
                             overhead: OverheadModel) -> StepTemplate:
    """Transform a recorded step into a simulation-ready :class:`StepTemplate`.

    Per the paper (§3.4): each communication op becomes (a) a pure link op
    with work = size bytes and (b) an overhead compute op on the receiver's
    compute resource; original dependents of the comm op are re-pointed at
    the overhead op.  Compute ops keep their recorded durations.
    """
    ops: List[Op] = []
    # recorded index -> index (in new list) that dependents should wait on
    tail_of: Dict[int, int] = {}
    # recorded index -> index of the new op carrying the recorded deps
    head_of: Dict[int, int] = {}

    for i, rop in enumerate(step.ops):
        if rop.res.startswith(("downlink", "uplink")):
            comm = Op(name=rop.name, res=rop.res, size=rop.size,
                      priority=rop.priority, tags=dict(rop.tags))
            ops.append(comm)
            head_of[i] = len(ops) - 1
            ov = Op(name=f"{rop.name}/parse",
                    res=_receiver_compute_resource(rop.res),
                    duration=overhead(rop.size),
                    deps=(len(ops) - 1,),
                    tags={"overhead": True, **rop.tags})
            ops.append(ov)
            tail_of[i] = len(ops) - 1
        else:
            comp = Op(name=rop.name, res=rop.res, duration=rop.duration,
                      priority=rop.priority, tags=dict(rop.tags))
            ops.append(comp)
            head_of[i] = tail_of[i] = len(ops) - 1

    # now wire original dependencies: head of each op waits on tails of deps
    for i, rop in enumerate(step.ops):
        hd = head_of[i]
        extra = tuple(tail_of[d] for d in rop.deps)
        ops[hd].deps = tuple(ops[hd].deps) + extra

    return StepTemplate(ops=ops, meta=dict(step.meta))


def preprocess_profile(steps: Sequence[RecordedStep],
                       overhead: OverheadModel) -> List[StepTemplate]:
    return [preprocess_recorded_step(s, overhead) for s in steps]


def estimate_overhead_from_probes(
        probe_sizes: Sequence[float],
        measured_overheads: Sequence[float]) -> OverheadModel:
    """Cluster calibration (paper §4.1): per-platform alpha/beta estimated
    once from tcpdump-vs-trace probes; here from emulator probes."""
    return OverheadModel.fit(probe_sizes, measured_overheads)
