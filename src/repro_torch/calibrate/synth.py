"""Planted-truth trace synthesis: the differential backbone of the
calibration test harness (ArboEstimator-style "hidden truth"), copied from
``repro.calibrate.synth`` draw for draw.

A :class:`PlantedTruth` fixes every parameter the fitter is supposed to
recover — per-op compute seconds, per-link capacity in bytes/s, and the
linear parse-overhead model.  :func:`synthesize_steps` renders it into
``RecordedStep`` traces with the *same recording semantics as the
emulator* (a comm op's interval spans request → parse-done) plus seeded
multiplicative lognormal noise, so

* at ``noise=0`` the fit must recover the truth **exactly** (the
  schedule is strictly sequential: every stream finds its link idle and
  the busy-union denominators are exact), and
* at small noise it must recover it within the estimators' tolerance,
  invariant under trace shuffling.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.overhead import OverheadModel, RecordedOp, RecordedStep


@dataclass(frozen=True)
class PlantedTruth:
    """Ground-truth parameters a synthesized trace is rendered from."""

    # op name -> (resource, compute seconds); order defines the chain
    op_times: Dict[str, Tuple[str, float]]
    # op name -> (link resource, bytes); interleaved into the chain
    transfers: Dict[str, Tuple[str, float]]
    link_capacity: Dict[str, float]          # link resource -> bytes/s
    overhead: OverheadModel
    # chain order over all op names (compute + transfer)
    order: Tuple[str, ...] = ()

    def expected_op_times(self) -> Dict[str, float]:
        return {name: t for name, (_res, t) in self.op_times.items()}


def make_truth(layers: int = 4, seed: int = 0,
               capacity: float = 120e6,
               ps_capacity: Optional[float] = None,
               alpha: float = 8e-10, beta: float = 1e-3,
               compute_scale: float = 1.0,
               capacity_scale: float = 1.0) -> PlantedTruth:
    """A paper-shaped truth: per layer, a downlink pull, fwd and bwd
    compute, an uplink push and a PS update.  Sizes and times vary per
    layer (deterministic in ``seed``) so the overhead line fit sees
    distinct x-values.  ``compute_scale`` / ``capacity_scale`` perturb
    the whole family — the knobs the drift tests turn.
    """
    rng = random.Random(seed)
    op_times: Dict[str, Tuple[str, float]] = {}
    transfers: Dict[str, Tuple[str, float]] = {}
    order: List[str] = []
    for i in range(layers):
        size = (2.0 + 6.0 * rng.random()) * 1e6      # 2–8 MB
        transfers[f"dl{i}"] = ("downlink", size)
        order.append(f"dl{i}")
        op_times[f"fwd{i}"] = ("worker",
                               (2.0 + 3.0 * rng.random()) * 1e-3
                               * compute_scale)
        order.append(f"fwd{i}")
    for i in range(layers):
        op_times[f"bwd{i}"] = ("worker",
                               (3.0 + 4.0 * rng.random()) * 1e-3
                               * compute_scale)
        order.append(f"bwd{i}")
        usize = (2.0 + 6.0 * rng.random()) * 1e6
        transfers[f"ul{i}"] = ("uplink", usize)
        order.append(f"ul{i}")
        op_times[f"upd{i}"] = ("ps",
                               (0.5 + 1.0 * rng.random()) * 1e-3
                               * compute_scale)
        order.append(f"upd{i}")
    caps = {"downlink": capacity * capacity_scale,
            "uplink": (ps_capacity if ps_capacity is not None
                       else capacity) * capacity_scale}
    return PlantedTruth(op_times=op_times, transfers=transfers,
                        link_capacity=caps,
                        overhead=OverheadModel(alpha=alpha, beta=beta),
                        order=tuple(order))


def _lognorm(rng: random.Random, sigma: float) -> float:
    if sigma <= 0.0:
        return 1.0
    return rng.lognormvariate(-0.5 * sigma * sigma, sigma)


def synthesize_steps(truth: PlantedTruth, steps: int = 40,
                     seed: int = 1, noise: float = 0.0
                     ) -> List[RecordedStep]:
    """Render ``steps`` recorded steps from the truth.

    The chain is strictly sequential (op *i* depends on op *i-1* and
    starts exactly when it ends), so every comm op finds its link idle
    and its recorded interval is precisely transmission + parse:

        duration = size / capacity * noise  +  (alpha*size + beta) * noise'

    — the §2 information gap, reproduced with known components.
    """
    rng = random.Random(seed)
    out: List[RecordedStep] = []
    t = 0.0
    for s in range(steps):
        ops: List[RecordedOp] = []
        for i, name in enumerate(truth.order):
            deps = (i - 1,) if i > 0 else ()
            if name in truth.transfers:
                res, size = truth.transfers[name]
                tx = size / truth.link_capacity[res] * _lognorm(rng, noise)
                parse = truth.overhead(size) * _lognorm(rng, noise)
                ops.append(RecordedOp(name=name, res=res, deps=deps,
                                      size=size, start=t,
                                      end=t + tx + parse))
                t += tx + parse
            else:
                res, dur = truth.op_times[name]
                d = dur * _lognorm(rng, noise)
                ops.append(RecordedOp(name=name, res=res, deps=deps,
                                      start=t, end=t + d))
                t += d
        out.append(RecordedStep(ops=ops, meta={"step": s, "synth": True}))
    return out


def synthesize_parse_probes(truth: PlantedTruth,
                            sizes: Tuple[float, ...] = None,
                            seed: int = 2, noise: float = 0.0
                            ) -> List[Tuple[float, float]]:
    """Direct (size, parse duration) probe samples — the planted-truth
    counterpart of ``emulator.cluster.probe_parse_overheads``.  Feeding
    them into ``TraceSamples.parse`` resolves the capacity/parse-rate
    split the same way the paper's dedicated probes do, so the fitter
    must recover alpha/beta exactly at ``noise=0``."""
    if sizes is None:
        sizes = tuple(2.0 ** i * 1e5 for i in range(10))
    rng = random.Random(seed)
    return [(s, truth.overhead(s) * _lognorm(rng, noise)) for s in sizes]


__all__ = ["PlantedTruth", "make_truth", "synthesize_steps",
           "synthesize_parse_probes"]
