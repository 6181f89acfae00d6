"""Synchronization-semantics layer: async / sync / SSP / all-reduce.

The paper's predictor models *asynchronous* PS training only.  Its DES
core, op-DAG builder, and topology layer are exactly the machinery needed
for the other synchronization regimes that dominate practice (Shi et al.,
arXiv:1805.03812, give the DAG model of synchronous SGD; Jin et al.,
arXiv:1611.04581, the sync-vs-async scaling behavior this subsystem must
reproduce qualitatively).  This module makes the regime first-class:

  * :class:`SyncSpec` — the serializable mode configuration threaded
    through ``SimConfig``, ``PredictionRun``, the sweep task payloads,
    ``ClusterEmulator`` and ``launch/whatif.py``;
  * a :func:`make_controller` family — small step-barrier state machines
    shared verbatim by the DES engine and the cluster emulator, invoked at
    step-completion events (no new calendar machinery; the ``async``
    controller is pure bookkeeping, which is what keeps the default path
    bit-identical to the frozen reference engine);
  * per-worker iteration-version tracking: every mode reports a staleness
    distribution (version lag of each applied update) alongside
    throughput;
  * :func:`allreduce_templates` — rewrites profiled async-PS step DAGs
    into decentralized all-reduce step DAGs (uplink/downlink ops replaced
    by per-layer collective phases from ``repro_torch.core.collectives``).

Mode semantics
--------------

``async``      the paper's regime: a worker applies its update and starts
               the next step immediately.  Version lag of a step = number
               of other workers' updates applied between its parameter
               read and its own update.
``sync``       bulk-synchronous with a k-of-n barrier: the global step
               commits when ``n - backup_workers`` gradients of the
               current version have arrived; stragglers' late gradients
               are dropped (they show up as nonzero staleness) and the
               straggler rejoins at the current version, as in
               TensorFlow's SyncReplicasOptimizer.
``ssp``        stale-synchronous parallel: a worker may run ahead of the
               slowest worker by at most ``staleness_bound`` iterations;
               ``s = 0`` degenerates to full sync, ``s -> inf`` to async
               (both are exact-trace test gates).
``allreduce``  bulk-synchronous decentralized SGD: no PS; gradients move
               through per-layer ring/tree collective phases and every
               step ends at a full barrier (staleness identically 0).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .collectives import ALGORITHMS, allreduce_duration
from .events import Op, StepTemplate

SYNC_MODES = ("async", "sync", "ssp", "allreduce")

__all__ = [
    "SYNC_MODES", "SyncSpec", "make_controller", "staleness_stats",
    "allreduce_templates",
]


@dataclass(frozen=True)
class SyncSpec:
    """Synchronization regime of a training run (picklable; rides inside
    ``SimConfig`` and the sweep/measure task payloads)."""

    mode: str = "async"
    backup_workers: int = 0      # sync: barrier commits at n - backup arrivals
    staleness_bound: int = 0     # ssp: max iteration lead over the slowest
    allreduce_algo: str = "ring"  # allreduce: ring | tree

    def __post_init__(self):
        if self.mode not in SYNC_MODES:
            raise ValueError(
                f"unknown sync_mode {self.mode!r} "
                f"(expected one of {SYNC_MODES})")
        if self.backup_workers < 0:
            raise ValueError(
                f"backup_workers must be >= 0, got {self.backup_workers}")
        if self.backup_workers and self.mode != "sync":
            raise ValueError(
                f"backup_workers is a sync-mode knob (k-of-n barrier); "
                f"mode {self.mode!r} has no barrier quorum to relax")
        if self.staleness_bound < 0:
            raise ValueError(
                f"staleness_bound must be >= 0, got {self.staleness_bound}")
        if self.staleness_bound and self.mode != "ssp":
            raise ValueError(
                f"staleness_bound is an ssp-mode knob; mode {self.mode!r} "
                f"does not bound iteration skew")
        if self.allreduce_algo not in ALGORITHMS:
            raise ValueError(
                f"unknown allreduce_algo {self.allreduce_algo!r} "
                f"(expected one of {ALGORITHMS})")


# ---------------------------------------------------------------------------
# Step-barrier controllers (shared by the DES engine and the emulator)
# ---------------------------------------------------------------------------


class SyncController:
    """Base protocol + the ``async`` implementation.

    Engines call :meth:`on_step_start` when a worker begins a step and
    :meth:`on_step_complete` when it finishes one; the latter returns
    ``(lag, released)`` where ``lag`` is the completed step's version lag
    (updates applied by other workers between its parameter read and its
    own update) and ``released`` lists workers now allowed to start their
    next step (possibly including the completer; engines skip workers
    that already reached their step target).  ``version`` counts applied
    updates (async/ssp) or committed global steps (sync/allreduce);
    ``commits`` records barrier-commit times for the trace metadata.

    Fault injection (``repro_torch.core.faults``) adds two hooks: engines call
    :meth:`on_worker_down` when a worker crashes or is preempted (with
    ``in_step`` telling whether a step was in flight) and
    :meth:`on_worker_up` when it rejoins after restore; both return
    workers newly allowed to start a step, exactly like
    ``on_step_complete``'s ``released``.  ``drops_stale`` tells engines
    whether a nonzero-lag completion means the gradient was dropped
    (sync/allreduce barrier) or still applied (async/SSP) — the
    distinction behind goodput and wasted-work accounting.
    """

    drops_stale = False

    def __init__(self, num_workers: int):
        self.num_workers = num_workers
        self.version = 0
        self.v_start = [0] * num_workers
        self.commits: List[float] = []

    def on_step_start(self, w: int) -> None:
        self.v_start[w] = self.version

    def on_step_complete(self, w: int, t: float) -> Tuple[int, Tuple[int, ...]]:
        lag = self.version - self.v_start[w]
        self.version += 1
        return lag, (w,)

    def on_worker_down(self, w: int, in_step: bool,
                       t: float) -> Tuple[int, ...]:
        """A worker left the cluster (crash/preemption); async: no shared
        state to repair, nobody is blocked on it."""
        return ()

    def on_worker_up(self, w: int, ckpt_version: int,
                     t: float) -> Tuple[int, ...]:
        """The worker rejoined after restore; ``ckpt_version`` is the
        iteration its checkpoint rolls it back to (SSP accounting)."""
        return ()


class BarrierController(SyncController):
    """k-of-n barrier (``sync``; ``allreduce`` uses it with k = n).

    A step is *fresh* while the global version has not moved since it
    started; the barrier commits when ``quorum`` fresh gradients arrived
    or when no fresh step remains in flight (end-of-run shrinkage, or a
    quorum larger than the set of workers still participating).  Stale
    completions are dropped gradients: the worker records its version lag
    and immediately rejoins at the current version.

    Under fault injection the quorum k stays *fixed* (TensorFlow's
    ``replicas_to_aggregate``): while at most ``backups`` workers are
    down, the barrier re-elects its backup slack and keeps committing —
    a crash of the last awaited straggler commits the round immediately.
    Plain sync (no backups) instead *stalls* on any crash: the survivors
    hold their gradients at the barrier until the worker restores and
    re-contributes, which is exactly the churn penalty that makes
    backup/SSP modes worth their staleness.
    """

    drops_stale = True

    def __init__(self, num_workers: int, quorum: int):
        super().__init__(num_workers)
        if not (1 <= quorum <= num_workers):
            raise ValueError(
                f"barrier quorum must be in [1, {num_workers}], got "
                f"{quorum} (backup_workers must stay below the worker "
                f"count)")
        self.quorum = quorum
        self.backups = num_workers - quorum
        self.live = num_workers
        self.down = 0           # workers currently crashed/preempted
        self.arrived = 0        # fresh gradients of the current version
        self.in_flight = 0      # running steps started at the current version
        self.waiting: List[int] = []   # fresh arrivals held at the barrier

    def on_step_start(self, w: int) -> None:
        self.v_start[w] = self.version
        self.in_flight += 1

    def on_step_complete(self, w: int, t: float) -> Tuple[int, Tuple[int, ...]]:
        if self.v_start[w] < self.version:
            # gradient computed against an already-superseded version:
            # dropped by the barrier; the worker rejoins immediately
            return self.version - self.v_start[w], (w,)
        self.in_flight -= 1
        self.arrived += 1
        # the in-flight-exhausted commit covers end-of-run shrinkage; a
        # *down* worker beyond the backup slack is expected back, so the
        # barrier holds the round open for it instead
        if self.arrived >= self.quorum or (self.in_flight == 0
                                           and self.down <= self.backups):
            self.version += 1
            self.arrived = 0
            # any step still running was started at the now-superseded
            # version: it will complete through the stale path, so the
            # in-flight census of the new version starts from zero (the
            # released workers re-register via on_step_start)
            self.in_flight = 0
            self.commits.append(t)
            released = tuple(self.waiting) + (w,)
            self.waiting.clear()
            return 0, released
        self.waiting.append(w)
        return 0, ()

    def _commit(self, t: float) -> Tuple[int, ...]:
        self.version += 1
        self.arrived = 0
        self.in_flight = 0
        self.commits.append(t)
        released = tuple(self.waiting)
        self.waiting.clear()
        return released

    def on_worker_down(self, w: int, in_step: bool,
                       t: float) -> Tuple[int, ...]:
        self.live -= 1
        self.down += 1
        if w in self.waiting:
            # its gradient already arrived; it just can't be released
            self.waiting.remove(w)
        elif in_step and self.v_start[w] == self.version:
            self.in_flight -= 1
        if self.down <= self.backups and self.arrived > 0 \
                and (self.arrived >= self.quorum or self.in_flight == 0):
            # within the backup slack the round commits without the
            # crashed straggler; past it the survivors stall until rejoin
            return self._commit(t)
        return ()

    def on_worker_up(self, w: int, ckpt_version: int,
                     t: float) -> Tuple[int, ...]:
        self.live += 1
        self.down -= 1
        return ()


class SspController(SyncController):
    """Stale-synchronous parallel: a worker may start iteration c only
    while ``c - min(completed) <= staleness_bound``.  Version arithmetic
    matches the async controller (every completion applies an update), so
    an unreachable bound reproduces async traces exactly; a bound of 0
    reproduces the full barrier's release order exactly."""

    def __init__(self, num_workers: int, bound: int):
        super().__init__(num_workers)
        self.bound = bound
        self.completed = [0] * num_workers
        self.waiting: List[int] = []
        self.active = set(range(num_workers))

    def _eligible(self, w: int) -> bool:
        # the lead is measured over *live* workers only: a crashed
        # straggler must not freeze the whole cluster at its last count
        floor = min(self.completed[v] for v in self.active) \
            if self.active else self.completed[w]
        return self.completed[w] - floor <= self.bound

    def on_step_complete(self, w: int, t: float) -> Tuple[int, Tuple[int, ...]]:
        lag = self.version - self.v_start[w]
        self.version += 1
        self.completed[w] += 1
        released = []
        # FIFO over earlier-blocked workers first, then the completer: for
        # bound 0 this is exactly the k-of-n barrier's release order, so
        # ssp(0) and sync(k=n) produce identical traces (RNG draws and all)
        for v in list(self.waiting):
            if self._eligible(v):
                self.waiting.remove(v)
                released.append(v)
        if self._eligible(w):
            released.append(w)
        else:
            self.waiting.append(w)
        return lag, tuple(released)

    def on_worker_down(self, w: int, in_step: bool,
                       t: float) -> Tuple[int, ...]:
        self.active.discard(w)
        if w in self.waiting:
            self.waiting.remove(w)
        # the slowest-live floor may have risen: release newly eligible
        released = []
        for v in list(self.waiting):
            if self._eligible(v):
                self.waiting.remove(v)
                released.append(v)
        return tuple(released)

    def on_worker_up(self, w: int, ckpt_version: int,
                     t: float) -> Tuple[int, ...]:
        """The restored worker resumes from its checkpoint: its iteration
        counter rolls back to ``ckpt_version``, which may *lower* the
        slowest-live floor and stall leaders at the bound — the SSP
        version-reset cost of a restart."""
        self.active.add(w)
        if ckpt_version < self.completed[w]:
            self.completed[w] = ckpt_version
        return ()


def make_controller(spec: SyncSpec, num_workers: int) -> SyncController:
    """The barrier state machine for one run of ``num_workers`` workers."""
    if spec.mode == "async":
        return SyncController(num_workers)
    if spec.mode == "sync":
        return BarrierController(num_workers,
                                 num_workers - spec.backup_workers)
    if spec.mode == "ssp":
        return SspController(num_workers, spec.staleness_bound)
    return BarrierController(num_workers, num_workers)   # allreduce


# ---------------------------------------------------------------------------
# Staleness reporting
# ---------------------------------------------------------------------------


def staleness_stats(lags: Sequence[int]) -> Dict[str, float]:
    """Summary of a version-lag distribution: mean / p50 / p99 / max."""
    if not lags:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0}
    s = sorted(lags)
    n = len(s)

    def pct(q: float) -> float:
        return float(s[min(n - 1, int(q * (n - 1) + 0.5))])

    return {"n": n, "mean": sum(s) / n, "p50": pct(0.50),
            "p99": pct(0.99), "max": float(s[-1])}


# ---------------------------------------------------------------------------
# Mode-aware step DAGs: profiled async-PS steps -> all-reduce steps
# ---------------------------------------------------------------------------


def allreduce_templates(templates: Sequence[StepTemplate], num_workers: int,
                        bandwidth: float, algo: str = "ring",
                        rtt: float = 0.0,
                        topology=None) -> List[StepTemplate]:
    """Rewrite profiled async-PS step templates as all-reduce step DAGs.

    The paper's premise — profile once, simulate every configuration —
    extends to the synchronization regime: the 1-worker PS profile already
    carries per-layer gradient sizes (uplink ops) and compute durations,
    which is everything a decentralized step needs.  Per recorded op:

      * ``downlink`` transfers and their receiver-parse ops vanish
        (parameters live on the workers; there is nothing to fetch);
      * each ``uplink`` transfer becomes a per-layer collective phase on
        the private ``collective`` resource, with duration
        ``allreduce_duration(size, num_workers, ...)`` — water-filled over
        the topology if one is given;
      * PS-side parse overhead ops vanish, and each ``ps`` update op
        becomes a local ``apply`` compute op on the worker (every replica
        runs the optimizer step itself);
      * worker compute ops are kept verbatim; dependents of removed ops
        are re-pointed at the removed op's own (surviving) dependencies.

    Durations depend on the worker count (ring volume is 2(n-1)/n of the
    bytes), so callers transform per simulated W.
    """
    return [_allreduce_step(tpl, num_workers, bandwidth, algo, rtt, topology)
            for tpl in templates]


def _short_name(name: str) -> str:
    return name.split("/", 1)[1] if "/" in name else name


def _allreduce_step(tpl: StepTemplate, num_workers: int, bandwidth: float,
                    algo: str, rtt: float, topology) -> StepTemplate:
    new_ops: List[Op] = []
    new_of: Dict[int, Optional[int]] = {}   # old idx -> new idx (None=removed)
    tails: Dict[int, Tuple[int, ...]] = {}  # old idx -> dep targets for users

    def dep_targets(old_deps: Sequence[int]) -> Tuple[int, ...]:
        out: List[int] = []
        for d in old_deps:
            for t in tails[d]:
                if t not in out:
                    out.append(t)
        return tuple(out)

    for i, op in enumerate(tpl.ops):
        if any(d >= i for d in op.deps):
            raise ValueError(
                "allreduce transform expects topologically ordered step "
                f"templates (op {i} depends on a later op)")
        res = op.res
        drop = (res.startswith("downlink")
                or (res == "parse" and op.tags.get("overhead"))
                or (res.startswith("ps") and op.tags.get("overhead")))
        if drop:
            new_of[i] = None
            tails[i] = dep_targets(op.deps)
            continue
        if res.startswith("uplink"):
            new_op = Op(name=f"allreduce/{_short_name(op.name)}",
                        res="collective",
                        # gradient bytes ride along (work() ignores size on
                        # a COMPUTE resource): fleet engines replace the
                        # compiled duration with live per-round flows and
                        # need the payload
                        size=op.size,
                        duration=allreduce_duration(
                            op.size, num_workers, algo, bandwidth,
                            rtt=rtt, topology=topology),
                        deps=dep_targets(op.deps),
                        priority=op.priority,
                        tags={**op.tags, "collective": True})
        elif res.startswith("ps"):
            new_op = Op(name=f"apply/{_short_name(op.name)}", res="worker",
                        duration=op.duration, deps=dep_targets(op.deps),
                        priority=op.priority, tags=dict(op.tags))
        else:
            new_op = Op(name=op.name, res=res, size=op.size,
                        duration=op.duration, deps=dep_targets(op.deps),
                        priority=op.priority, tags=dict(op.tags))
        new_ops.append(new_op)
        new_of[i] = len(new_ops) - 1
        tails[i] = (len(new_ops) - 1,)

    meta = dict(tpl.meta)
    meta["sync_mode"] = "allreduce"
    meta["allreduce_algo"] = algo
    meta["allreduce_workers"] = num_workers
    return StepTemplate(ops=new_ops, meta=meta)
