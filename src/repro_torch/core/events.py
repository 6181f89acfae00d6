"""Core data structures for trace-driven throughput prediction.

The paper (Li et al., ICPE'20) represents each SGD step as a DAG of
*operations*, each bound to exactly one resource:

  - ``downlink`` / ``uplink``: the parameter server's transmit/receive
    channels (shared among workers, equal-share bandwidth);
  - ``worker`` / ``ps``: compute units (private per worker).

With M parameter servers the link/compute resources are indexed per server
(``downlink:0``, ``uplink:1``, ``ps:0`` ...).  The TPU adapter reuses the
same structures with resources such as ``mxu`` / ``hbm`` / ``ici`` / ``dcn``.

Communication ops carry a payload ``size`` in bytes; their service demand is
``size / bandwidth`` at full-rate.  Compute ops carry a ``duration`` in
seconds.  Internally the simulator works with a uniform ``work`` quantity:
bytes for link resources, seconds for compute resources.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------

LINK = "link"
COMPUTE = "compute"


@dataclass(frozen=True)
class ResourceSpec:
    """A named resource class used by ops.

    ``kind == LINK``    -> shared among active workers; ``bandwidth`` in B/s.
    ``kind == COMPUTE`` -> private per worker (share == 1); work in seconds.
    """

    name: str
    kind: str
    bandwidth: float = 0.0  # bytes/s; only meaningful for LINK resources

    def __post_init__(self):
        if self.kind not in (LINK, COMPUTE):
            raise ValueError(f"bad resource kind: {self.kind!r}")
        if self.kind == LINK and self.bandwidth <= 0:
            raise ValueError(f"link resource {self.name!r} needs bandwidth > 0")


def ps_resources(bandwidth: float, num_ps: int = 1) -> Dict[str, ResourceSpec]:
    """The paper's resource set for ``num_ps`` parameter servers — the thin
    star-topology factory.  ``repro_torch.core.topology.Topology.resources()``
    compiles every topology down to this same canonical resource set;
    heterogeneous capacities and fabric constraints live in the bandwidth
    model's capacity groups, not in the per-link specs.

    For one PS the canonical names are downlink/uplink/worker/ps; for M > 1
    the link and ps-compute resources are indexed per server.
    """
    res: Dict[str, ResourceSpec] = {
        "worker": ResourceSpec("worker", COMPUTE),
        # dedicated recv/parse thread at the worker (gRPC deserialization
        # runs off the main compute unit; see overhead.py)
        "parse": ResourceSpec("parse", COMPUTE),
    }
    if num_ps == 1:
        res["downlink"] = ResourceSpec("downlink", LINK, bandwidth)
        res["uplink"] = ResourceSpec("uplink", LINK, bandwidth)
        res["ps"] = ResourceSpec("ps", COMPUTE)
    else:
        for i in range(num_ps):
            res[f"downlink:{i}"] = ResourceSpec(f"downlink:{i}", LINK, bandwidth)
            res[f"uplink:{i}"] = ResourceSpec(f"uplink:{i}", LINK, bandwidth)
            res[f"ps:{i}"] = ResourceSpec(f"ps:{i}", COMPUTE)
    return res


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------

_uid_counter = itertools.count()


@dataclass
class Op:
    """One operation of a profiled SGD step (template form).

    ``deps`` lists indices (within the owning :class:`StepTemplate`) of ops
    that must complete before this op may start.  For LINK resources ``size``
    (bytes) defines the work; for COMPUTE resources ``duration`` (seconds).
    """

    name: str
    res: str
    size: float = 0.0      # bytes, for link ops
    duration: float = 0.0  # seconds, for compute ops
    deps: Tuple[int, ...] = ()
    # Optional scheduling priority (e.g. TIC order). Lower = served earlier
    # by ordered schedulers; ignored by FIFO/HTTP2 schedulers.
    priority: float = 0.0
    # Free-form tags (layer index, phase, ...) for analysis.
    tags: Dict[str, object] = field(default_factory=dict)

    def work(self, resources: Dict[str, ResourceSpec]) -> float:
        spec = resources[self.res]
        return self.size if spec.kind == LINK else self.duration


@dataclass
class StepTemplate:
    """A profiled SGD step: ops indexed 0..n-1 with intra-step deps."""

    ops: List[Op]
    meta: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        n = len(self.ops)
        for i, op in enumerate(self.ops):
            for d in op.deps:
                if not (0 <= d < n):
                    raise ValueError(f"op {i} ({op.name}) has dep {d} out of range")
                if d == i:
                    raise ValueError(f"op {i} ({op.name}) depends on itself")
        self._check_acyclic()

    def _check_acyclic(self):
        n = len(self.ops)
        indeg = [0] * n
        out: List[List[int]] = [[] for _ in range(n)]
        for i, op in enumerate(self.ops):
            indeg[i] = len(op.deps)
            for d in op.deps:
                out[d].append(i)
        stack = [i for i in range(n) if indeg[i] == 0]
        seen = 0
        while stack:
            i = stack.pop()
            seen += 1
            for j in out[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    stack.append(j)
        if seen != n:
            raise ValueError("step dependency graph has a cycle")

    def roots(self) -> List[int]:
        return [i for i, op in enumerate(self.ops) if not op.deps]

    def total_bytes(self, direction_prefix: str) -> float:
        return sum(op.size for op in self.ops if op.res.startswith(direction_prefix))

    def total_compute(self, res_name: str) -> float:
        return sum(op.duration for op in self.ops if op.res == res_name)


# ---------------------------------------------------------------------------
# Live op instances & chunks (simulator-internal)
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class LiveOp:
    """An op instance bound to a worker inside a running step."""

    uid: int
    template: Op
    worker: int
    step_seq: int                       # per-worker step counter
    remaining_deps: int
    dependents: List["LiveOp"] = field(default_factory=list)
    # HTTP/2 model state: has this stream been preempted once already?
    serviced_once: bool = False
    remaining_work: float = 0.0
    start_time: float = -1.0
    end_time: float = -1.0
    # Worker incarnation this op belongs to (fault injection): a crash
    # bumps the worker's incarnation, orphaning every older LiveOp so
    # stale calendar rejoins can be recognized and dropped.
    gen: int = 0

    @classmethod
    def fresh(cls, template: Op, worker: int, step_seq: int,
              resources: Dict[str, ResourceSpec]) -> "LiveOp":
        return cls(
            uid=next(_uid_counter),
            template=template,
            worker=worker,
            step_seq=step_seq,
            remaining_deps=len(template.deps),
            remaining_work=template.work(resources),
        )

    @property
    def res(self) -> str:
        return self.template.res

    @property
    def name(self) -> str:
        return self.template.name


@dataclass(slots=True)
class Chunk:
    """A schedulable portion of a LiveOp (HTTP/2 WIN chunking)."""

    op: LiveOp
    remaining: float
    is_last: bool
    # Service-start order, assigned by the simulator when the chunk enters
    # service.  Simultaneous completions are processed in start order, which
    # reproduces the reference engine's running-dict insertion order (and
    # hence its RNG draw sequence) exactly.
    seq: int = -1

    @property
    def worker(self) -> int:
        return self.op.worker

    @property
    def res(self) -> str:
        return self.op.res


# ---------------------------------------------------------------------------
# Trace records
# ---------------------------------------------------------------------------


@dataclass
class TraceRecord:
    worker: int
    res: str
    name: str
    step_seq: int
    start: float
    end: float


@dataclass
class Trace:
    """Synthetic execution trace produced by the simulator."""

    records: List[TraceRecord] = field(default_factory=list)
    # (worker, step_seq) -> completion time
    step_completions: List[Tuple[int, int, float]] = field(default_factory=list)
    # per completed step, in completion order: version lag of the applied
    # update (updates by other workers between parameter read and apply) —
    # the staleness accounting of ``repro_torch.core.syncmode``
    staleness: List[int] = field(default_factory=list)
    # fault-injection incidents (``repro_torch.core.faults``): dicts with kind
    # ('crash' | 'preempt' | 'ps_fail' | 'degrade'), target (worker index,
    # shard index or link name), t_down, t_up, recovery, and for worker
    # incidents in_step (was a step in flight when the worker died?)
    incidents: List[Dict[str, object]] = field(default_factory=list)

    def add(self, worker: int, res: str, name: str, step_seq: int,
            start: float, end: float) -> None:
        self.records.append(TraceRecord(worker, res, name, step_seq, start, end))

    def complete_step(self, worker: int, step_seq: int, t: float) -> None:
        self.step_completions.append((worker, step_seq, t))

    def staleness_stats(self) -> Dict[str, float]:
        """mean/p50/p99/max version lag over all completed steps."""
        from .syncmode import staleness_stats
        return staleness_stats(self.staleness)

    def measurement_window(self, warmup_steps: int = 50,
                           window: str = "common"
                           ) -> Tuple[float, float]:
        """The (start, end) measurement window (paper §4.1 convention).

        Per worker, the start boundary is its ``warmup_steps``-th
        completion; the window runs from the latest boundary to the last
        completion overall (``"common"``) or the earliest per-worker last
        completion (``"all-active"``).

        **Incident awareness:** with fault incidents recorded, a worker
        that crashed early could otherwise reach its k-th completion only
        after restarting — silently sliding the window start past the
        churn it is supposed to measure.  A restored worker resumes from
        its checkpoint (its desynchronization persists; there is no
        re-warm), so each worker's warmup boundary is capped at its first
        incident's t_down.
        """
        if window not in ("common", "all-active"):
            raise ValueError(f"unknown throughput window {window!r}")
        if not self.step_completions:
            return (0.0, 0.0)
        per_worker: Dict[int, List[float]] = {}
        for w, _seq, t in self.step_completions:
            per_worker.setdefault(w, []).append(t)
        first_down: Dict[int, float] = {}
        for inc in self.incidents:
            if inc.get("kind") in ("crash", "preempt"):
                wi = inc["target"]
                td = inc["t_down"]
                if wi not in first_down or td < first_down[wi]:
                    first_down[wi] = td
        boundaries = []
        ends = []
        for w, times in per_worker.items():
            times.sort()
            k = warmup_steps if len(times) > warmup_steps else max(1, len(times) // 2)
            b = times[k - 1]
            cap = first_down.get(w)
            if cap is not None and cap < b:
                b = cap
            boundaries.append(b)
            ends.append(times[-1])
        window_start = max(boundaries)
        window_end = max(ends) if window == "common" else min(ends)
        return (window_start, window_end)

    def throughput(self, batch_size: int, warmup_steps: int = 50,
                   window: str = "common") -> float:
        """examples/s over the post-warmup window (paper §4.1).

        The paper discards the first ``warmup_steps`` *per worker* to let the
        workers drift out of their synchronized start, then time-averages.

        ``window="common"`` (default, the paper's convention) ends the
        window at the last completion overall; ``"all-active"`` ends it at
        the *earliest* per-worker last completion, excluding the tail where
        fast workers have already retired and only stragglers still run —
        the fair steady-state window when worker speeds are heterogeneous
        (a fixed per-worker step budget otherwise lets the straggler-only
        tail dominate the average).

        Downtime inside the window is *not* excluded: throughput under
        churn is supposed to show the loss.  :meth:`goodput` additionally
        excludes updates the barrier dropped as stale.
        """
        window_start, window_end = self.measurement_window(warmup_steps,
                                                           window)
        if window_end <= window_start:
            return 0.0
        n_in_window = sum(
            1 for _w, _s, t in self.step_completions if window_start < t <= window_end
        )
        return n_in_window * batch_size / (window_end - window_start)

    def goodput(self, batch_size: int, warmup_steps: int = 50,
                window: str = "common") -> float:
        """examples/s of *applied* updates — throughput-under-churn.

        Counts only steps whose gradient contributed to the model: under
        the sync / allreduce barrier a stale completion (nonzero version
        lag) is a dropped gradient and is excluded; async and SSP apply
        every update, so goodput equals throughput there.  Recovery gaps
        still dilute the window, so worker churn lowers goodput even in
        async mode.
        """
        window_start, window_end = self.measurement_window(warmup_steps,
                                                           window)
        if window_end <= window_start:
            return 0.0
        mode = getattr(self, "meta", {}).get("sync_mode", "async")
        drops = (self.staleness if mode in ("sync", "allreduce")
                 and len(self.staleness) == len(self.step_completions)
                 else None)
        n = 0
        for i, (_w, _s, t) in enumerate(self.step_completions):
            if window_start < t <= window_end:
                if drops is None or drops[i] == 0:
                    n += 1
        return n * batch_size / (window_end - window_start)

    def to_chrome_trace(self, templates=None,
                        trace_name: str = "repro") -> dict:
        """This trace as a Chrome trace-event dict (Perfetto /
        ``chrome://tracing``).  Pass the run's step templates to get
        exact dependency flow arrows; see :mod:`repro_torch.obs.trace_export`.
        Requires a ``record_trace=True`` run (otherwise there are no
        records to lay out)."""
        from repro_torch.obs.trace_export import to_chrome_trace
        return to_chrome_trace(self, templates=templates,
                               trace_name=trace_name)

    def recovery_times(self) -> List[float]:
        """Per-incident recovery time (t_up - t_down), worker churn and PS
        failover alike, in schedule order."""
        return [float(inc["recovery"]) for inc in self.incidents
                if inc.get("kind") != "degrade"]

    def wasted_work_fraction(self) -> float:
        """Fraction of worker busy-time spent on work that never became an
        applied update: step progress lost to a crash/preemption plus
        whole steps whose gradient the barrier dropped as stale.  Engines
        record the two accumulators in ``trace.meta``."""
        meta = getattr(self, "meta", {})
        wasted = float(meta.get("wasted_work_s", 0.0))
        useful = float(meta.get("useful_work_s", 0.0))
        total = wasted + useful
        return wasted / total if total > 0 else 0.0
