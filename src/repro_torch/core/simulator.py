"""Incremental event-calendar simulation for synthetic trace generation.

Same fluid semantics as the paper's Algorithm 3.1 (and as the frozen seed
engine in ``simulator_ref.py`` — the golden-trace tests assert equivalence),
but with the steady-state per-event cost reduced from O(running chunks) to
O(log n):

  * **Per-link virtual-service clocks** (the standard processor-sharing
    trick).  Under equal sharing every active connection on a link receives
    service at the same per-connection rate ``B / n``, so the link keeps a
    cumulative attained-service clock ``V`` and each chunk a fixed target
    ``v_target = V(start) + work``: the chunk completes when ``V`` reaches
    ``v_target``, *regardless of how the rate changed in between*.  Rate
    changes (a worker joining or leaving the link) only re-project the
    link's earliest completion onto the real-time axis — no per-chunk state
    is ever touched.
  * **Lazy rate epochs.**  The global calendar holds at most one projection
    per link, tagged with the link's rate epoch; stale projections are
    discarded on pop instead of being searched for and removed.
  * **Incremental share recomputation.**  The general bandwidth model
    (max-min water-filling with NIC coupling, used for M >= 2 parameter
    servers) cannot guarantee uniform per-connection rates within a link,
    so those runs fall back to per-connection projections — but shares are
    recomputed only when some link's active-worker set actually changes,
    never on events that leave the active sets untouched (e.g. a chunk
    completion whose connection immediately starts its next queued chunk).
  * **Batched calendar pops.**  Simultaneous completions and due rejoins
    are drained in one pop and processed in chunk-start order, matching the
    reference engine's batch semantics (and its RNG draw order) exactly.

Compute resources are private (rate 1), so their completions enter the
calendar with exact times and are never invalidated.
"""
from __future__ import annotations

import heapq
import itertools
import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..obs import metrics as obs_metrics
from .bandwidth import BandwidthModel, EqualShareModel, IncrementalWaterfill
from .events import (COMPUTE, LINK, Chunk, LiveOp, ResourceSpec,
                     StepTemplate, Trace)
from .faults import FaultSpec, compile_faults, shard_link_names
from .fluidlink import EqualShareLink
from .schedulers import FifoScheduler, Scheduler, make_link_scheduler
from .syncmode import SyncSpec, make_controller
from .topology import Topology

# A chunk completes when its remaining work is within this of zero — the
# same effective threshold as the reference engine's per-event test
# ``remaining <= _EPS * max(|remaining|, 1)``.
_WORK_EPS = 1e-9
# Batch windows when draining the calendar (seconds).  Compute resources
# run at rate 1, so the reference engine's work epsilon is 1e-9 *seconds*
# there; rejoins use the reference's 1e-15 slack; link projections join a
# batch on exact ties, up to a few ulp of the current time (projection
# arithmetic perturbs genuinely tied completions by ~1 ulp of t).
_EPS_COMPUTE = 1e-9
_EPS_LINK = 1e-15        # + t * _EPS_LINK_REL at drain time
_EPS_LINK_REL = 1e-15
_EPS_REJOIN = 1e-15

# Calendar entry kinds (entries are (time, seq, kind, a, b) tuples).
_K_REJOIN = 0    # a = LiveOp to re-queue
_K_COMPUTE = 1   # a = (worker, res) key, b = Chunk; exact, never stale
_K_LINK = 2      # a = link name, b = rate epoch; stale if epoch moved on
_K_CONN = 3      # a = (worker, res) key, b = conn epoch (general mode)
_K_FAULT = 4     # a = FaultEvent, b = True (down edge) / False (up edge)


_LINK_POLICIES = ("http2", "fifo", "ordered")


def compile_template(tpl: StepTemplate, resources: Dict[str, ResourceSpec]
                     ) -> tuple:
    """Instantiation table for one step template: ``(ops, works, edges,
    roots)``.

    Work amounts and dependency edges don't change between steps, so both
    engines compute them once per (template, resources) pair: the scalar
    engine caches the tuple per run (``tpl_cache``), the batched engine
    (``repro.core.batched``) packs it into its structure-of-arrays
    template bank.  ``edges`` is ``(d, i)`` pairs in ascending dependent
    order — the order dependents are walked at op completion, which fixes
    the RNG draw sequence both engines must share.
    """
    works = [op.work(resources) for op in tpl.ops]
    edges = [(d, i) for i, op in enumerate(tpl.ops) for d in op.deps]
    roots = [i for i, op in enumerate(tpl.ops) if not op.deps]
    return (tpl.ops, works, edges, roots)


@dataclass
class SimConfig:
    # Either an explicit resource dict, or a Topology to compile one from
    # (Topology.bandwidth must then be set).
    resources: Optional[Dict[str, ResourceSpec]] = None
    link_policy: str = "http2"        # http2 | fifo | ordered
    win: float = 28e6                 # HTTP/2 flow-control window (bytes)
    bandwidth_model: Optional[BandwidthModel] = None
    steps_per_worker: int = 400
    warmup_steps: int = 50
    seed: int = 0
    record_trace: bool = False
    record_op_times: bool = False     # per-op (start, end); Table 1 validation
    # Sample per-link allocated rate + active-connection count at every
    # rate change into ``trace.rate_log`` — the Chrome-trace counter
    # tracks of ``repro.obs.trace_export``.  Off by default (the log can
    # dwarf the trace on long runs) and, like record_trace, unbatchable.
    record_rates: bool = False
    # Credit-based flow control: after a WIN-limited burst, the preempted
    # remainder becomes eligible only once the receiver has consumed the
    # burst and returned a WINDOW_UPDATE.  Modeled as
    # ``stall = alpha * burst + rtt`` with the platform's calibrated parse
    # rate alpha (paper Fig. 10) and measured RTT.  This is what lets
    # initially-synchronized workers drift apart (paper Fig. 15/16) in an
    # otherwise self-synchronizing fluid model.
    stall_alpha: float = 0.0          # s/byte
    stall_rtt: float = 0.0            # s
    # Per-chunk service jitter (lognormal sigma on link work): calibrated
    # once per platform from repeated iperf probes.  The paper's equal-share
    # model is deterministic; real links split unevenly (its own §3.1
    # caveat), and this is what lets synchronized workers drift apart the
    # way Fig. 15/16 shows.  0 = paper-faithful deterministic sharing.
    service_jitter: float = 0.0
    # Cluster structure (heterogeneous NICs, rack fabrics, PS placement).
    # None = the paper's flat star; supplies resources, bandwidth model and
    # compute speed factors unless those are given explicitly.
    topology: Optional[Topology] = None
    # Compute speed factors (1.0 = profiled machine): per worker index for
    # 'worker'/'parse' ops, per resource name for PS update ops.
    worker_speed: Optional[Dict[int, float]] = None
    res_speed: Optional[Dict[str, float]] = None
    # Synchronization regime (repro_torch.core.syncmode).  "async" is the paper's
    # semantics and stays bit-identical to the frozen reference engine;
    # "sync" adds a k-of-n barrier (k = W - backup_workers), "ssp" bounds
    # the iteration lead over the slowest worker, "allreduce" runs the
    # decentralized collective DAG under a full barrier.  All modes report
    # a staleness distribution in the trace.
    sync_mode: str = "async"
    backup_workers: int = 0
    staleness_bound: int = 0
    allreduce_algo: str = "ring"
    # General-path (M >= 2 / topology) bandwidth re-solve strategy:
    # "auto" uses the incremental group-local solver whenever the model
    # exposes its group structure (all built-in grouped models do) and is
    # bit-identical in shares to "batch", which re-waterfills the whole
    # active set on every membership change (the pre-incremental engine
    # behavior, kept as the differential baseline and escape hatch).
    # "incremental" insists and errors if the model cannot support it.
    waterfill: str = "auto"
    # Fault injection (repro_torch.core.faults): worker crash/restart churn,
    # spot preemption, PS-shard failover and per-link capacity degradation
    # as ordinary calendar events.  None or an empty spec leaves every
    # code path bit-identical to the healthy engine (golden-trace gates);
    # the schedule is drawn from the spec's own fault_seed, never from the
    # simulation RNG.
    faults: Optional[FaultSpec] = None
    # Digest of the CalibrationProfile whose fitted parameters produced
    # this config (repro.calibrate).  Provenance only: the engine never
    # reads it, but stamps it into ``trace.meta`` so every downstream
    # trace/ledger record names the exact parameter set it was run under.
    calibration_digest: Optional[str] = None

    def sync_spec(self) -> SyncSpec:
        return SyncSpec(mode=self.sync_mode,
                        backup_workers=self.backup_workers,
                        staleness_bound=self.staleness_bound,
                        allreduce_algo=self.allreduce_algo)

    def __post_init__(self):
        if self.resources is None:
            if self.topology is None:
                raise ValueError("SimConfig needs resources= or topology=")
            self.resources = self.topology.resources()
        if not self.resources:
            raise ValueError("SimConfig.resources must not be empty")
        if self.topology is not None:
            # explicit resources must name the topology's links, or every
            # compiled capacity group would silently match nothing
            for p in range(self.topology.num_shards):
                for d in ("downlink", "uplink"):
                    name = self.topology.link_name(d, p)
                    if name not in self.resources:
                        raise ValueError(
                            f"resources= is missing link {name!r} required "
                            f"by the topology ({self.topology.num_shards} "
                            f"PS shard(s)); pass matching resources or let "
                            f"the topology compile them")
        if self.topology is not None:
            if self.worker_speed is None:
                self.worker_speed = self.topology.worker_speeds() or None
            if self.res_speed is None:
                self.res_speed = self.topology.res_speeds() or None
        if self.bandwidth_model is None:
            if self.topology is not None:
                self.bandwidth_model = self.topology.bandwidth_model()
            else:
                # Paper-faithful default: equal share (exact for 1 PS).
                self.bandwidth_model = EqualShareModel()
        if self.link_policy not in _LINK_POLICIES:
            raise ValueError(
                f"unknown link_policy {self.link_policy!r} "
                f"(expected one of {_LINK_POLICIES})")
        if self.waterfill not in ("auto", "incremental", "batch"):
            raise ValueError(
                f"unknown waterfill mode {self.waterfill!r} "
                f"(expected 'auto', 'incremental' or 'batch')")
        if self.win <= 0:
            raise ValueError(
                f"HTTP/2 flow-control window must be > 0 bytes, got "
                f"{self.win} (pass win= a positive byte count)")
        if self.steps_per_worker < 1:
            raise ValueError(
                f"steps_per_worker must be >= 1, got {self.steps_per_worker}")
        if self.warmup_steps < 0:
            raise ValueError(
                f"warmup_steps must be >= 0, got {self.warmup_steps}")
        for name, v in (("service_jitter", self.service_jitter),
                        ("stall_alpha", self.stall_alpha),
                        ("stall_rtt", self.stall_rtt)):
            if v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")
        for w, s in (self.worker_speed or {}).items():
            if s <= 0:
                raise ValueError(
                    f"worker {w}: compute speed must be > 0, got {s}")
        for r, s in (self.res_speed or {}).items():
            if s <= 0:
                raise ValueError(
                    f"resource {r!r}: compute speed must be > 0, got {s}")
        if self.faults is not None and not isinstance(self.faults, FaultSpec):
            raise ValueError(
                f"faults= expects a repro_torch.core.faults.FaultSpec, got "
                f"{type(self.faults).__name__}")
        spec = self.sync_spec()   # validates mode/backup/bound/algo
        if spec.mode == "allreduce" and "collective" not in self.resources:
            # the collective phases of the mode-aware step DAG run on a
            # private per-worker resource (rate compiled from the topology
            # by repro_torch.core.collectives, so no dynamic sharing state)
            self.resources = dict(self.resources)
            self.resources["collective"] = ResourceSpec("collective", COMPUTE)


class Simulation:
    """One synthetic-trace generation run (GenerateTrace in the paper)."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.resources = cfg.resources
        self.rng = random.Random(cfg.seed)

    # -- public API ---------------------------------------------------------

    def run(self, steps: Sequence[StepTemplate], num_workers: int,
            sample: bool = True) -> Trace:
        """Generate a synthetic trace for ``num_workers`` workers.

        ``sample=True`` draws steps with replacement (paper default);
        ``sample=False`` cycles deterministically (useful for tests).
        """
        if not steps:
            raise ValueError("need at least one profiled step")
        cfg = self.cfg
        if cfg.topology is not None and num_workers > cfg.topology.num_workers:
            raise ValueError(
                f"simulating {num_workers} workers but the topology defines "
                f"only {cfg.topology.num_workers} worker nodes")
        resources = self.resources
        rng = self.rng
        trace = Trace()
        sync = cfg.sync_spec()
        # step-barrier state machine + iteration-version (staleness)
        # accounting; the async controller is pure bookkeeping (no RNG, no
        # times), preserving golden-trace equivalence on the default path.
        # (Validates the barrier quorum against num_workers.)
        sync_ctl = make_controller(sync, num_workers)
        # Uniform per-link rates hold exactly for the equal-share rule; any
        # other model may split a link unevenly (NIC coupling) and uses the
        # per-connection fallback.
        uniform = type(cfg.bandwidth_model) is EqualShareModel
        # Group-local incremental re-solves for the general path: only the
        # component(s) whose membership changed are re-waterfilled and only
        # connections whose share actually changed are re-projected.  Needs
        # the model's group structure (conn_groups); a custom shares()
        # override falls back to the batch path.
        incr = (not uniform and cfg.waterfill != "batch"
                and type(cfg.bandwidth_model).shares is BandwidthModel.shares)
        if cfg.waterfill == "incremental" and not incr:
            raise ValueError(
                "waterfill='incremental' needs a grouped bandwidth model: "
                "the uniform equal-share path (1-PS star) never builds a "
                "solver, and a custom shares() override exposes no group "
                "structure; use waterfill='auto' or 'batch'")
        iwf = (IncrementalWaterfill(cfg.bandwidth_model.conn_groups)
               if incr else None)

        # Fault injection: compile the spec into the per-run incident
        # schedule (drawn from its own RNG stream — the simulation RNG is
        # untouched, so an empty schedule leaves this run bit-identical
        # to the healthy engine and no fault branch below is ever taken).
        fs = cfg.faults
        fault_mode = fs is not None and not fs.empty()
        schedule = None
        if fault_mode:
            link_names = [r for r, s in resources.items() if s.kind == LINK]
            if cfg.topology is not None:
                num_shards = cfg.topology.num_shards
            else:
                num_shards = sum(1 for r in resources
                                 if r == "uplink" or r.startswith("uplink:"))
            schedule = compile_faults(fs, num_workers, link_names=link_names,
                                      num_shards=max(1, num_shards))
            fault_mode = bool(schedule.incidents)
        if (fault_mode and schedule.link_events() and not uniform
                and iwf is None):
            raise ValueError(
                "link degradation / PS failover on the general bandwidth "
                "path needs the incremental waterfill (waterfill='auto' or "
                "'incremental' with a grouped model); the batch re-solve "
                "path has no capacity-scaling hook")

        workers = range(num_workers)
        scheds: Dict[Tuple[int, str], Scheduler] = {}
        for w in workers:
            for rname, spec in resources.items():
                if spec.kind == LINK:
                    scheds[(w, rname)] = make_link_scheduler(cfg.link_policy, cfg.win)
                else:
                    scheds[(w, rname)] = FifoScheduler()

        links: Dict[str, EqualShareLink] = {
            r: EqualShareLink(s.bandwidth)
            for r, s in resources.items() if s.kind == LINK
        }
        is_link = {r: s.kind == LINK for r, s in resources.items()}

        # Per-(worker, resource) compute speed factors (topology mode); a
        # compute chunk of d nominal seconds takes d / speed.  Empty in the
        # default star (speed 1.0 everywhere) — zero-overhead path.
        speed: Dict[Tuple[int, str], float] = {}
        if cfg.worker_speed or cfg.res_speed:
            for w in workers:
                for rname, spec in resources.items():
                    if spec.kind == LINK:
                        continue
                    s = 1.0
                    if cfg.worker_speed and rname in ("worker", "parse"):
                        s *= cfg.worker_speed.get(w, 1.0)
                    if cfg.res_speed:
                        s *= cfg.res_speed.get(rname, 1.0)
                    if s != 1.0:
                        speed[(w, rname)] = s

        running: Dict[Tuple[int, str], Chunk] = {}
        calendar: List[tuple] = []
        cal_seq = itertools.count()
        start_seq = itertools.count()
        uid_counter = itertools.count()
        rejoin_pending = 0
        dirty_links: Set[str] = set()   # uniform mode: projections to refresh
        shares_dirty = False            # general mode: global recompute needed
        # general mode per-connection service state
        conn_rate: Dict[Tuple[int, str], float] = {}
        conn_mtime: Dict[Tuple[int, str], float] = {}
        conn_epoch: Dict[Tuple[int, str], int] = {}
        # incremental mode reads shares straight off the solver's cache;
        # batch mode rebuilds this dict on every recompute
        cur_shares: Dict[Tuple[int, str], float] = \
            iwf.shares if iwf is not None else {}
        # incremental mode: conns begun this batch without a trusted rate
        # (their projection is issued at finalize even if the share the
        # solver lands on is numerically unchanged)
        needs_proj: Set[Tuple[int, str]] = set()

        pending_ops: Dict[int, int] = {w: 0 for w in workers}
        completed: Dict[int, int] = {w: 0 for w in workers}
        sample_idx: Dict[int, int] = {w: 0 for w in workers}
        op_times: List[Tuple[int, int, str, str, float, float]] = []
        # observability: run-local counters are plain ints kept
        # unconditionally (an increment next to a heappush is noise);
        # whether they get *published* is decided once per run here, so
        # the metrics-off path differs only by skipped publication.
        collect = obs_metrics.enabled()
        stale_drops = 0    # lazily-invalidated calendar entries discarded
        reproj = 0         # link/conn re-projections issued at batch end
        # (t, link, allocated B/s, active conns) samples at rate changes
        rate_log: Optional[List[Tuple[float, str, float, int]]] = \
            [] if cfg.record_rates else None

        # fault state: down set, per-worker incarnation (orphans stale
        # rejoins/projections of killed steps), per-link capacity scales
        # (uniform path; the general path scales waterfill groups), and
        # the useful/wasted work accounting behind goodput metrics
        down_workers: Set[int] = set()
        incarn: List[int] = [0] * num_workers
        link_scale: Dict[str, float] = {}
        step_start_t: List[float] = [0.0] * num_workers
        useful_s = 0.0
        wasted_s = 0.0
        lost_steps = 0

        stall = cfg.stall_alpha * cfg.win + cfg.stall_rtt
        jitter_sigma = cfg.service_jitter
        jitter_mu = -0.5 * jitter_sigma * jitter_sigma

        def apply_service_jitter(chunk: Chunk) -> None:
            """Lognormal per-chunk link-service jitter (one site; both the
            fresh-start and next-chunk paths go through _begin_chunk)."""
            chunk.remaining *= math.exp(rng.gauss(jitter_mu, jitter_sigma))

        def next_step(w: int) -> StepTemplate:
            if sample:
                return steps[rng.randrange(len(steps))]
            i = sample_idx[w]
            sample_idx[w] += 1
            return steps[i % len(steps)]

        # per-template instantiation cache: work amounts and dependency
        # edges don't change between steps, so compute them once per run
        tpl_cache: Dict[int, tuple] = {}

        def start_step(w: int, t: float) -> None:
            sync_ctl.on_step_start(w)
            tpl = next_step(w)
            cached = tpl_cache.get(id(tpl))
            if cached is None:
                cached = compile_template(tpl, resources)
                tpl_cache[id(tpl)] = cached
            ops, works, edges, roots = cached
            seq = completed[w]
            gen = incarn[w]
            step_start_t[w] = t
            live: List[LiveOp] = [
                LiveOp(uid=next(uid_counter), template=op, worker=w,
                       step_seq=seq, remaining_deps=len(op.deps),
                       remaining_work=wk, gen=gen)
                for op, wk in zip(ops, works)
            ]
            for d, i in edges:
                live[d].dependents.append(live[i])
            pending_ops[w] += len(live)
            for i in roots:
                enqueue_op(live[i], t)

        def begin_chunk(key: Tuple[int, str], chunk: Chunk, t: float) -> None:
            """Place a chunk in service on an idle (worker, resource) pair."""
            nonlocal shares_dirty
            w, rname = key
            if is_link[rname]:
                if jitter_sigma > 0:
                    apply_service_jitter(chunk)
                chunk.seq = next(start_seq)
                running[key] = chunk
                link = links[rname]
                link.materialize(t)
                if uniform:
                    link.active.add(w)
                    heapq.heappush(link.heap,
                                   (link.V + chunk.remaining, chunk.seq,
                                    key, chunk))
                    dirty_links.add(rname)
                else:
                    was_active = w in link.active
                    link.active.add(w)
                    conn_mtime[key] = t
                    epoch = conn_epoch.get(key, 0) + 1
                    conn_epoch[key] = epoch
                    if was_active and not shares_dirty:
                        # immediate successor on a still-active connection:
                        # the active sets are unchanged, so the connection
                        # keeps its current share — no global recompute
                        r = cur_shares.get(key, 0.0) * link.bandwidth
                        conn_rate[key] = r
                        if r > 0.0:
                            heapq.heappush(
                                calendar,
                                (t + chunk.remaining / r, next(cal_seq),
                                 _K_CONN, key, epoch))
                        else:
                            shares_dirty = True
                            if iwf is not None:
                                needs_proj.add(key)
                    else:
                        # real rate assigned by the end-of-batch recompute
                        conn_rate[key] = 0.0
                        shares_dirty = True
                        if iwf is not None:
                            if not was_active:
                                iwf.add(key)
                            needs_proj.add(key)
            else:
                chunk.seq = next(start_seq)
                running[key] = chunk
                dur = chunk.remaining
                if speed:
                    sp = speed.get(key)
                    if sp is not None:
                        dur = dur / sp
                heapq.heappush(calendar,
                               (t + dur, next(cal_seq),
                                _K_COMPUTE, key, chunk))
            if chunk.op.start_time < 0:
                chunk.op.start_time = t

        def try_start_chunk(w: int, rname: str, t: float) -> None:
            """If the pair is idle and has queued work, start its next chunk."""
            key = (w, rname)
            if key in running:
                return
            chunk = scheds[key].remove_chunk()
            if chunk is not None:
                begin_chunk(key, chunk, t)

        def enqueue_op(lop: LiveOp, t: float) -> None:
            rname = lop.template.res
            scheds[(lop.worker, rname)].add(lop)
            try_start_chunk(lop.worker, rname, t)

        def entry_valid(e: tuple) -> bool:
            kind = e[2]
            if kind == _K_LINK:
                return links[e[3]].epoch == e[4]
            if kind == _K_CONN:
                return conn_epoch.get(e[3], -1) == e[4]
            if kind == _K_COMPUTE and fault_mode:
                # a crash pops the worker's chunks from `running`; the
                # exact-time calendar entry left behind is orphaned
                return running.get(e[3]) is e[4]
            return True

        def set_link_scale(lname: str, factor: float) -> None:
            """Apply a degradation epoch edge: scale one link's capacity."""
            nonlocal shares_dirty
            if uniform:
                if factor == 1.0:
                    link_scale.pop(lname, None)
                else:
                    link_scale[lname] = factor
                dirty_links.add(lname)
            else:
                iwf.set_scale(
                    cfg.bandwidth_model.link_group_key(lname), factor)
                shares_dirty = True

        def kill_worker(w: int, t: float) -> None:
            """Remove every trace of a crashed worker from the fabric:
            running chunks, queued streams, link membership, shares."""
            nonlocal shares_dirty
            for rname in resources:
                key = (w, rname)
                # compute chunks: the popped entry orphans the exact-time
                # calendar projection (entry_valid); link chunks: the dead
                # heap entry is dropped lazily at drain/projection time
                running.pop(key, None)
                if is_link[rname]:
                    link = links[rname]
                    if w in link.active:
                        link.active.discard(w)
                        if uniform:
                            dirty_links.add(rname)
                        else:
                            shares_dirty = True
                            conn_epoch[key] = conn_epoch.get(key, 0) + 1
                            conn_rate.pop(key, None)
                            conn_mtime.pop(key, None)
                            needs_proj.discard(key)
                            if iwf is not None:
                                iwf.remove(key)
                    scheds[key] = make_link_scheduler(cfg.link_policy,
                                                      cfg.win)
                else:
                    scheds[key] = FifoScheduler()
            pending_ops[w] = 0

        def fault_event(inc, is_down: bool, t: float) -> None:
            nonlocal wasted_s, lost_steps
            kind = inc.kind
            if kind in ("crash", "preempt"):
                w = inc.target
                if w >= num_workers:
                    return
                if is_down:
                    if w in down_workers:
                        return
                    in_step = pending_ops[w] > 0
                    if in_step:
                        wasted_s += t - step_start_t[w]
                        lost_steps += 1
                    incarn[w] += 1
                    down_workers.add(w)
                    kill_worker(w, t)
                    trace.incidents.append({
                        "kind": kind, "target": w, "t_down": inc.t_down,
                        "t_up": inc.t_up, "recovery": inc.t_up - inc.t_down,
                        "in_step": in_step})
                    released = sync_ctl.on_worker_down(w, in_step, t)
                else:
                    if w not in down_workers:
                        return
                    down_workers.discard(w)
                    k = fs.ckpt_interval_steps
                    floor = (completed[w] // k) * k if k > 0 else completed[w]
                    released = sync_ctl.on_worker_up(w, floor, t)
                    if completed[w] < cfg.steps_per_worker:
                        start_step(w, t)
                for rw in released:
                    if rw not in down_workers \
                            and completed[rw] < cfg.steps_per_worker:
                        start_step(rw, t)
            elif kind == "ps_fail":
                for lname in shard_link_names(inc.target, resources,
                                              cfg.topology):
                    set_link_scale(lname, 0.0 if is_down else 1.0)
                if is_down:
                    trace.incidents.append({
                        "kind": kind, "target": inc.target,
                        "t_down": inc.t_down, "t_up": inc.t_up,
                        "recovery": inc.t_up - inc.t_down})
            else:   # degrade
                set_link_scale(inc.target,
                               inc.factor if is_down else 1.0)
                if is_down:
                    trace.incidents.append({
                        "kind": kind, "target": inc.target,
                        "t_down": inc.t_down, "t_up": inc.t_up,
                        "recovery": inc.t_up - inc.t_down,
                        "factor": inc.factor})

        def sample_link_rates(t: float) -> None:
            """General path: per-link allocated-rate totals off the
            per-connection rates (record_rates runs only)."""
            tot: Dict[str, float] = {}
            cnt: Dict[str, int] = {}
            for (_w, rname), r in conn_rate.items():
                tot[rname] = tot.get(rname, 0.0) + r
                cnt[rname] = cnt.get(rname, 0) + 1
            for rname in sorted(tot):
                rate_log.append((t, rname, tot[rname], cnt[rname]))

        def finalize_batch(t: float) -> None:
            """Refresh rates/projections for links touched in this batch."""
            nonlocal shares_dirty, reproj
            if uniform:
                for rname in dirty_links:
                    link = links[rname]
                    link.materialize(t)
                    n = len(link.active)
                    # (1/n) * B, not B/n: matches the reference engine's
                    # share-then-scale arithmetic to the last ulp
                    link.rate = (1.0 / n) * link.bandwidth if n else 0.0
                    if link_scale:
                        sc = link_scale.get(rname)
                        if sc is not None:
                            link.rate *= sc   # degradation epoch in force
                    if rate_log is not None:
                        rate_log.append((t, rname, link.rate * n, n))
                    link.epoch += 1
                    if fault_mode:
                        # crashed workers leave dead heap entries behind;
                        # drop them before projecting the earliest finish
                        lheap = link.heap
                        while lheap and running.get(lheap[0][2]) \
                                is not lheap[0][3]:
                            heapq.heappop(lheap)
                    if link.heap and link.rate > 0.0:
                        dt = (link.heap[0][0] - link.V) / link.rate
                        heapq.heappush(
                            calendar,
                            (t + (dt if dt > 0.0 else 0.0), next(cal_seq),
                             _K_LINK, rname, link.epoch))
                        reproj += 1
                dirty_links.clear()
            elif shares_dirty:
                if iwf is not None:
                    # group-local re-solve: only components touched by the
                    # batch's joins/leaves are recomputed, and only conns
                    # whose share (or service state) changed re-project —
                    # untouched conns keep epoch, rate and calendar entry
                    touched = iwf.flush()
                    if needs_proj:
                        touched |= needs_proj
                        needs_proj.clear()
                    for key in touched:
                        chunk = running.get(key)
                        if chunk is None:
                            continue      # departed within this batch
                        rname = key[1]
                        r_old = conn_rate.get(key, 0.0)
                        if r_old > 0.0:
                            chunk.remaining -= r_old * (t - conn_mtime[key])
                        conn_mtime[key] = t
                        r_new = cur_shares.get(key, 0.0) \
                            * links[rname].bandwidth
                        conn_rate[key] = r_new
                        epoch = conn_epoch.get(key, 0) + 1
                        conn_epoch[key] = epoch
                        if r_new > 0.0:
                            rem = chunk.remaining
                            heapq.heappush(
                                calendar,
                                (t + (rem if rem > 0.0 else 0.0) / r_new,
                                 next(cal_seq), _K_CONN, key, epoch))
                            reproj += 1
                    if rate_log is not None:
                        sample_link_rates(t)
                    shares_dirty = False
                    return
                cur_shares.clear()
                cur_shares.update(cfg.bandwidth_model.shares(
                    {r: l.active for r, l in links.items() if l.active}))
                shares = cur_shares
                for key, chunk in running.items():
                    rname = key[1]
                    if not is_link[rname]:
                        continue
                    r_old = conn_rate[key]
                    if r_old > 0.0:
                        chunk.remaining -= r_old * (t - conn_mtime[key])
                    conn_mtime[key] = t
                    r_new = shares.get(key, 0.0) * links[rname].bandwidth
                    conn_rate[key] = r_new
                    epoch = conn_epoch.get(key, 0) + 1
                    conn_epoch[key] = epoch
                    if r_new > 0.0:
                        rem = chunk.remaining
                        heapq.heappush(
                            calendar,
                            (t + (rem if rem > 0.0 else 0.0) / r_new,
                             next(cal_seq), _K_CONN, key, epoch))
                        reproj += 1
                if rate_log is not None:
                    sample_link_rates(t)
                shares_dirty = False

        # ---- main loop ----
        t = 0.0
        for w in workers:
            start_step(w, t)
        finalize_batch(t)
        if fault_mode:
            for inc in schedule.incidents:
                heapq.heappush(calendar, (inc.t_down, next(cal_seq),
                                          _K_FAULT, inc, True))
                heapq.heappush(calendar, (inc.t_up, next(cal_seq),
                                          _K_FAULT, inc, False))

        total_steps_target = num_workers * cfg.steps_per_worker
        steps_done = 0
        n_events = 0   # chunk completions + processed rejoins (for perf stats)
        guard = 0
        max_events = 200 * total_steps_target * max(
            1, max(len(s.ops) for s in steps)
        )

        while (running or rejoin_pending or down_workers) \
                and steps_done < total_steps_target:
            guard += 1
            if guard > max_events:
                raise RuntimeError("simulator event-count guard tripped (livelock?)")

            # -- pop the next valid calendar entry, then drain its batch --
            while True:
                if not calendar:
                    raise RuntimeError("no progress possible: all rates zero")
                e = heapq.heappop(calendar)
                if entry_valid(e):
                    break
                stale_drops += 1
            if e[0] > t:
                t = e[0]
            batch = [e]
            eps_link = _EPS_LINK + t * _EPS_LINK_REL
            while calendar:
                e2 = calendar[0]
                kind = e2[2]
                if kind == _K_REJOIN:
                    eps = _EPS_REJOIN
                elif kind == _K_COMPUTE:
                    eps = _EPS_COMPUTE
                elif kind == _K_FAULT:
                    eps = 0.0
                else:
                    eps = eps_link
                if e2[0] > t + eps:
                    break
                heapq.heappop(calendar)
                if entry_valid(e2):
                    batch.append(e2)
                else:
                    stale_drops += 1

            # -- fault edges first: crashes must orphan their worker's
            # chunks before this batch's rejoins/completions are processed
            if fault_mode:
                for e2 in batch:
                    if e2[2] == _K_FAULT:
                        fault_event(e2[3], e2[4], t)

            # -- due rejoins first (reference engine order) --
            for e2 in batch:
                if e2[2] != _K_REJOIN:
                    continue
                rejoin_pending -= 1
                lop = e2[3]
                if fault_mode and lop.gen != incarn[lop.worker]:
                    continue   # rejoin of a pre-crash incarnation
                scheds[(lop.worker, lop.res)].add(lop)
                try_start_chunk(lop.worker, lop.res, t)

            # -- collect completions, in chunk-start order --
            completions: List[Tuple[int, Tuple[int, str], Chunk]] = []
            drained_links: Set[str] = set()
            for e2 in batch:
                kind = e2[2]
                if kind == _K_COMPUTE:
                    if fault_mode and running.get(e2[3]) is not e2[4]:
                        continue   # killed by a crash in this batch
                    completions.append((e2[4].seq, e2[3], e2[4]))
                elif kind == _K_LINK:
                    rname = e2[3]
                    if rname in drained_links:
                        continue
                    drained_links.add(rname)
                    link = links[rname]
                    link.materialize(t)
                    lheap = link.heap
                    # relative term: V is cumulative over the whole run, so
                    # a fixed epsilon would eventually drop below one ulp of
                    # V and a due chunk could never be recognized complete
                    v_lim = link.V + _WORK_EPS + link.V * 1e-12
                    popped = False
                    while lheap and lheap[0][0] <= v_lim:
                        _v, cseq, key, chunk = heapq.heappop(lheap)
                        if fault_mode and running.get(key) is not chunk:
                            continue   # chunk's worker crashed
                        completions.append((cseq, key, chunk))
                        popped = True
                    if fault_mode:
                        # drop dead heads so the stuck-head rescue below
                        # never resurrects a crashed worker's chunk
                        while lheap and running.get(lheap[0][2]) is not lheap[0][3]:
                            heapq.heappop(lheap)
                    if not popped and lheap and link.rate > 0.0:
                        # residual virtual work implies a time step below
                        # one ulp of t: no representable progress is
                        # possible, so the head chunk is due now (the
                        # reference engine's exact per-chunk decrement
                        # reaches zero here too)
                        dt_min = (lheap[0][0] - link.V) / link.rate
                        if t + dt_min <= t:
                            _v, cseq, key, chunk = heapq.heappop(lheap)
                            completions.append((cseq, key, chunk))
                    dirty_links.add(rname)
                elif kind == _K_CONN:
                    key = e2[3]
                    chunk = running.get(key) if fault_mode else running[key]
                    if chunk is None:
                        continue   # worker crashed earlier in this batch
                    completions.append((chunk.seq, key, chunk))
                    conn_epoch[key] += 1   # invalidate residual projections
                    del conn_rate[key], conn_mtime[key]
            completions.sort()
            n_events += len(completions)

            for _cseq, key, chunk in completions:
                del running[key]
                w, rname = key
                lop = chunk.op
                if cfg.record_trace:
                    trace.add(w, rname, lop.name, lop.step_seq,
                              lop.start_time, t)
                if not chunk.is_last:
                    # preempted stream rejoins the back of its queue after
                    # the receiver consumes the burst (WINDOW_UPDATE stall)
                    if stall > 0.0:
                        rejoin_pending += 1
                        heapq.heappush(calendar,
                                       (t + stall, next(cal_seq),
                                        _K_REJOIN, lop, None))
                    else:
                        scheds[key].add(lop)
                if chunk.is_last:
                    lop.end_time = t
                    pending_ops[w] -= 1
                    if cfg.record_op_times:
                        op_times.append((w, lop.step_seq, lop.name, rname,
                                         lop.start_time, t))
                    for dep in lop.dependents:
                        dep.remaining_deps -= 1
                        if dep.remaining_deps == 0:
                            enqueue_op(dep, t)
                # next chunk on this pair (the dependent may already have
                # re-marked the pair busy via enqueue_op -> try_start_chunk)
                if key not in running:
                    nxt = scheds[key].remove_chunk()
                    if nxt is not None:
                        begin_chunk(key, nxt, t)
                    elif is_link[rname]:
                        links[rname].active.discard(w)
                        if uniform:
                            dirty_links.add(rname)
                        else:
                            shares_dirty = True
                            if iwf is not None:
                                iwf.remove(key)

                # step complete?  (pending_ops == 0 implies the worker's
                # schedulers are empty and nothing of its is running: every
                # queued/running chunk belongs to a still-live op)
                if pending_ops[w] == 0:
                    completed[w] += 1
                    steps_done += 1
                    trace.complete_step(w, completed[w] - 1, t)
                    lag, released = sync_ctl.on_step_complete(w, t)
                    trace.staleness.append(lag)
                    if fault_mode:
                        dt_step = t - step_start_t[w]
                        if lag and sync_ctl.drops_stale:
                            wasted_s += dt_step   # stale gradient dropped
                        else:
                            useful_s += dt_step
                    for rw in released:
                        if rw not in down_workers and \
                                completed[rw] < cfg.steps_per_worker:
                            start_step(rw, t)

            finalize_batch(t)

        trace.meta = {  # type: ignore[attr-defined]
            "engine": "scalar",
            "num_workers": num_workers,
            "steps_per_worker": cfg.steps_per_worker,
            "sim_end_time": t,
            "num_events": n_events,
            "sync_mode": sync.mode,
            "num_versions": sync_ctl.version,
            "barrier_commits": list(sync_ctl.commits),
        }
        if cfg.calibration_digest is not None:
            trace.meta["calibration_digest"] = \
                cfg.calibration_digest  # type: ignore[attr-defined]
        if fault_mode:
            trace.meta.update(  # type: ignore[attr-defined]
                useful_work_s=useful_s,
                wasted_work_s=wasted_s,
                lost_steps=lost_steps,
                num_incidents=len(trace.incidents),
            )
        if iwf is not None:
            # solver work profile: lets tests assert that candidate
            # evaluation issues only group-local re-solves
            trace.meta["waterfill"] = dict(iwf.stats)  # type: ignore[attr-defined]
        if cfg.record_trace or cfg.record_rates:
            # lets the Chrome exporter classify tracks without guessing
            # from resource basenames
            trace.meta["link_resources"] = sorted(  # type: ignore[attr-defined]
                r for r, v in is_link.items() if v)
        if rate_log is not None:
            trace.rate_log = rate_log  # type: ignore[attr-defined]
        if collect:
            cal_stats = {"events": n_events, "stale_drops": stale_drops,
                         "batch_drains": guard, "reprojections": reproj}
            run_metrics: Dict[str, Dict[str, int]] = {"calendar": cal_stats}
            obs_metrics.merge_run("sim.calendar", cal_stats)
            if iwf is not None:
                run_metrics["waterfill"] = iwf.metrics_snapshot()
                obs_metrics.merge_run("sim.waterfill",
                                      run_metrics["waterfill"])
            trace.meta["metrics"] = run_metrics  # type: ignore[attr-defined]
        if cfg.record_op_times:
            trace.op_times = op_times  # type: ignore[attr-defined]
        return trace


def predict_throughput(steps: Sequence[StepTemplate], num_workers: int,
                       batch_size: int, cfg: SimConfig) -> float:
    """Convenience wrapper: run the simulation and return examples/s."""
    sim = Simulation(cfg)
    trace = sim.run(steps, num_workers)
    return trace.throughput(batch_size, warmup_steps=cfg.warmup_steps)
