"""Fluid cluster emulator — the ground truth for validating predictions.

Plays the role of the paper's real clusters (private CPU / AWS CPU / AWS
GPU).  It simulates distributed PS training at a much finer granularity than
the predictor and with dynamics the predictor does NOT observe:

  * per-op lognormal compute jitter;
  * HTTP/2 flow-control window drift (AR(1) around the platform mean) — the
    predictor assumes a fixed estimated WIN;
  * per-service bandwidth weight jitter and Poisson background flows (cloud
    profiles) on each link;
  * per-connection transmit stalls after a window-limited burst (the
    remainder becomes eligible only after the receiver parses the burst);
  * gRPC behavior observed in the paper: a stream is preempted at most once
    (first service sends up to the CURRENT window; the second service runs
    to completion);
  * synchronized worker start with emergent de-synchronization (Fig. 15/16).

It produces (a) TF-style 1-worker profiling traces — comm ops recorded with
request-time starts and parse-end ends — and (b) measured multi-worker
throughput.  The predictor only ever sees (a); validation compares against
(b).  The emulator shares no *scheduling* code with `repro_torch.core.simulator`
— only the generic fluid-link clock kernel (`repro_torch.core.fluidlink`) and,
in topology mode, the water-filling allocator (`repro_torch.core.bandwidth`).

With a :class:`~repro_torch.core.topology.Topology` the per-PS independent links
are replaced by one shared-rate pool over the topology's capacity groups
(worker NICs, shard-host NICs, colocated NICs, rack uplinks): weighted
max-min rates recomputed on membership changes — group-locally, through
``IncrementalWaterfill`` (``fabric_mode="batch"`` keeps the historical
full re-solve; both modes are bit-identical) — with per-flow projections
epoch-tagged; the emulator counterpart of the simulator's general
per-connection path.
"""
from __future__ import annotations

import heapq
import itertools
import math
import random
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.bandwidth import IncrementalWaterfill, waterfill
from repro_torch.core.faults import (FaultSpec, compile_faults,
                                     shard_link_names)
from repro_torch.core.fluidlink import Flow, WeightedFluidLink
from repro_torch.core.overhead import RecordedOp, RecordedStep
from repro_torch.core.paper_models import DnnSpec, Platform
from repro_torch.core.syncmode import (SyncSpec, make_controller,
                                       staleness_stats)
from repro_torch.core.topology import Topology, TopologyBandwidthModel
from repro_torch.profiling.tracer import build_job_step

_seq = itertools.count()


@dataclass
class _Stream:
    """One tensor transfer on a connection."""

    op_idx: int
    worker: int
    step_seq: int
    size: float
    remaining: float
    priority: float
    serviced_once: bool = False
    enqueue_time: float = 0.0


class _Fabric:
    """Shared-rate pool over a topology's capacity groups (topology mode).

    Independent per-link virtual clocks cannot express constraints that
    span links (a rack uplink, a colocated PS/worker NIC), so here every
    active flow is registered with its (worker, link) connection and rates
    come from weighted max-min water-filling over the compiled group set.
    Any membership change re-materializes remaining work at the old rates
    and re-projects every finite flow under the new ones; projections carry
    a pool epoch and are lazily dropped when stale.

    By default the shares come from an :class:`IncrementalWaterfill`
    keyed on the model's ``conn_groups`` — only the constraint
    component(s) whose membership changed are re-solved, retiring the old
    O(flows x groups) batch recompute per membership change.  The solver
    is bit-identical to the batch path (``incremental=False``), so the two
    modes produce byte-for-byte equal rate trajectories and traces — the
    parity gate in ``tests/test_fabric_parity.py``.
    """

    def __init__(self, emu: "ClusterEmulator", model: TopologyBandwidthModel,
                 bandwidth: float, incremental: bool = True):
        self.emu = emu
        self.model = model
        self.bandwidth = bandwidth      # nominal NIC rate, bytes/s
        self.flows: Dict[int, Flow] = {}
        self.conn: Dict[int, Tuple[int, str]] = {}
        self.rate: Dict[int, float] = {}
        self.t_mat: Dict[int, float] = {}
        self.epoch = 0
        self.iwf = (IncrementalWaterfill(model.conn_groups, weighted=True)
                    if incremental else None)
        # optional (t, conn, rate) log per rebalance — the golden-trace
        # fixture and the batch/incremental parity test record through it
        self.rate_log: Optional[List[tuple]] = None

    def add_flow(self, t: float, flow: Flow, conn: Tuple[int, str]) -> None:
        self.flows[flow.fid] = flow
        self.conn[flow.fid] = conn
        self.rate[flow.fid] = 0.0
        self.t_mat[flow.fid] = t
        if self.iwf is not None:
            self.iwf.add(conn, weight=flow.weight)
        self._rebalance(t)

    def remove_flow(self, t: float, fid: int) -> None:
        if self.flows.pop(fid, None) is None:
            return
        conn = self.conn.pop(fid)
        del self.rate[fid], self.t_mat[fid]
        if self.iwf is not None:
            self.iwf.remove(conn)
        self._rebalance(t)

    def _rebalance(self, t: float) -> None:
        """Materialize remaining work at the old rates, recompute weighted
        max-min shares, and project only the pool's EARLIEST completion
        (one epoch-tagged timer entry per membership change, not one per
        flow — the pool-level analogue of ``WeightedFluidLink``'s single
        link projection)."""
        self.epoch += 1
        if self.iwf is not None:
            # group-local re-solve: untouched components keep their cached
            # shares (bit-identical to the batch solve below)
            self.iwf.flush()
            shares = self.iwf.shares
            if not self.flows:
                return
        else:
            if not self.flows:
                return
            conns: List[Tuple[int, str]] = []
            weights: Dict[Tuple[int, str], float] = {}
            for fid, flow in self.flows.items():
                c = self.conn[fid]
                conns.append(c)
                weights[c] = flow.weight
            caps, members = self.model.groups_for(conns)
            shares = waterfill(conns, caps, members, weights=weights)
        earliest = None
        for fid, flow in self.flows.items():
            s = shares[self.conn[fid]]
            r_old = self.rate[fid]
            if math.isfinite(flow.remaining):
                if r_old > 0.0:
                    flow.remaining -= r_old * (t - self.t_mat[fid])
                    if flow.remaining < 0.0:
                        flow.remaining = 0.0
                r_new = s * self.bandwidth
                if r_new > 0.0:
                    tc = t + flow.remaining / r_new
                    if earliest is None or tc < earliest:
                        earliest = tc
            else:
                r_new = s * self.bandwidth
            self.t_mat[fid] = t
            self.rate[fid] = r_new
            if self.rate_log is not None:
                self.rate_log.append((t, self.conn[fid], r_new))
        if earliest is not None:
            heapq.heappush(self.emu.timers,
                           (earliest if earliest > t else t, next(_seq),
                            ("flow", None, self.epoch)))

    def flow_event(self, epoch: int) -> None:
        if epoch != self.epoch:
            return                      # rates moved on; projection stale
        t = self.emu.t
        # due = flows whose (unchanged-rate) completion time has arrived;
        # the projection arithmetic is replayed exactly, so the flow that
        # defined the projection always qualifies
        due: List[Tuple[float, int]] = []
        for fid, flow in self.flows.items():
            if not math.isfinite(flow.remaining):
                continue
            r = self.rate[fid]
            if r <= 0.0:
                continue
            tc = self.t_mat[fid] + flow.remaining / r
            if tc <= t + 1e-15 + t * 1e-12:
                due.append((tc, fid))
        due.sort()
        done: List[Flow] = []
        for _tc, fid in due:
            done.append(self.flows.pop(fid))
            conn = self.conn.pop(fid)
            del self.rate[fid], self.t_mat[fid]
            if self.iwf is not None:
                self.iwf.remove(conn)
        self._rebalance(t)
        for flow in done:
            if flow.on_complete:
                flow.on_complete()


class _Conn:
    """One gRPC connection (worker, ps, direction): streams multiplexed."""

    def __init__(self):
        self.queue: Deque[_Stream] = deque()
        self.transmitting: Optional[_Stream] = None
        self.win_state: float = 0.0  # AR(1) state (relative deviation)
        self.flow_fid: Optional[int] = None  # active burst (fault kill path)


class ClusterEmulator:
    """Event-driven fluid emulation of W workers + M parameter servers."""

    def __init__(self, dnn: DnnSpec, batch_size: int, platform: Platform,
                 num_workers: int, num_ps: int = 1, seed: int = 0,
                 flow_control: bool = True, order: str = "profiled",
                 record_profile: bool = False,
                 topology: Optional[Topology] = None,
                 sync: Optional[SyncSpec] = None,
                 fabric_mode: str = "incremental",
                 faults: Optional[FaultSpec] = None):
        if fabric_mode not in ("incremental", "batch"):
            raise ValueError(
                f"unknown fabric_mode {fabric_mode!r} (expected "
                f"'incremental' or 'batch')")
        self.dnn = dnn
        self.batch_size = batch_size
        self.platform = platform
        self.topology = topology
        self.sync = sync if sync is not None else SyncSpec()
        if topology is not None:
            if num_workers > topology.num_workers:
                raise ValueError(
                    f"emulating {num_workers} workers but the topology "
                    f"defines only {topology.num_workers} worker nodes")
            if num_ps not in (1, topology.num_shards):
                # same contract as PredictionRun: the topology owns the
                # shard count; an explicit conflicting num_ps is an error,
                # not a silent override
                raise ValueError(
                    f"num_ps={num_ps} conflicts with topology "
                    f"({topology.num_shards} PS shard(s)); omit num_ps or "
                    f"make them match")
            num_ps = topology.num_shards
        self.W = num_workers
        self.M = num_ps
        self.rng = random.Random(seed)
        self.flow_control = flow_control
        self.order = order
        self.record_profile = record_profile

        # the ideal (noise-free) step DAG; per-step execution jitters it
        # (mode-aware: the allreduce regime gets the collective DAG)
        self.template = build_job_step(dnn, batch_size, platform,
                                       num_ps=num_ps, order=order, seed=seed,
                                       sync=self.sync,
                                       num_workers=num_workers,
                                       topology=topology)
        self.ops = self.template.ops
        # step-barrier controller + staleness accounting (shared with the
        # DES engine; async is pure bookkeeping)
        self.sync_ctl = make_controller(self.sync, num_workers)
        self.staleness: List[int] = []

        # fault replay (same FaultSpec -> same compiled schedule as the
        # DES engine; see repro_torch.core.faults).  incarn orphans the timer
        # closures of a crashed worker's old life — every worker-owned
        # callback captures its generation and returns if it is stale.
        self.faults = faults
        self._fault_mode = False
        self.incarn = [0] * num_workers
        self.down: set = set()
        self.incidents: List[Dict[str, object]] = []
        self.useful_s = 0.0
        self.wasted_s = 0.0
        self.lost_steps = 0

        # event machinery
        self.t = 0.0
        # unified calendar: (time, seq, callback | ("link", lid, epoch)
        #                    | ("flow", fid, epoch) in topology mode)
        self.timers: List[Tuple[float, int, object]] = []
        self.links: Dict[str, WeightedFluidLink] = {}
        self.conns: Dict[Tuple[int, str], _Conn] = {}
        self.fabric: Optional[_Fabric] = None
        self.worker_speed: Optional[Dict[int, float]] = None
        self.ps_speed: Optional[Dict[int, float]] = None
        if topology is not None:
            nominal = topology.bandwidth or platform.bandwidth
            self.fabric = _Fabric(self, topology.grouped_model(), nominal,
                                  incremental=fabric_mode == "incremental")
            self.worker_speed = {i: n.speed
                                 for i, n in enumerate(topology.workers)}
            self.ps_speed = {p: topology.shard_host(p).speed
                             for p in range(num_ps)}
        self._lids: List[str] = []
        for p in range(num_ps):
            for direction in ("downlink", "uplink"):
                lid = direction if num_ps == 1 else f"{direction}:{p}"
                self._lids.append(lid)
                if self.fabric is None:
                    self.links[lid] = WeightedFluidLink(platform.bandwidth)
                for w in range(num_workers):
                    self.conns[(w, lid)] = _Conn()

        # per-worker execution state
        self.worker_busy = [False] * num_workers       # compute unit
        self.worker_q: List[Deque[Tuple[int, int]]] = [deque() for _ in range(num_workers)]
        self.parse_busy = [False] * num_workers        # recv/parse thread
        self.parse_q: List[Deque[Tuple[int, int, float, str]]] = [deque() for _ in range(num_workers)]
        # per-worker collective channel (allreduce mode): the NIC-side
        # phase engine, serialized per worker, off the compute unit
        self.coll_busy = [False] * num_workers
        self.coll_q: List[Deque[Tuple[int, float]]] = [deque() for _ in range(num_workers)]
        # per (worker, ps) server-side thread at PS: parse + update FIFO
        self.ps_busy: Dict[Tuple[int, int], bool] = {}
        self.ps_q: Dict[Tuple[int, int], Deque[Tuple[str, int, int, float]]] = {}
        for w in range(num_workers):
            for p in range(num_ps):
                self.ps_busy[(w, p)] = False
                self.ps_q[(w, p)] = deque()

        self.remaining_deps: List[List[int]] = [[] for _ in range(num_workers)]
        self.pending_ops = [0] * num_workers
        self.completed_steps = [0] * num_workers
        self.steps_target = 0
        self.step_start_time = [0.0] * num_workers
        self.step_completion_times: List[Tuple[int, int, float]] = []

        # profiling records (1-worker mode)
        self.current_records: List[List[Optional[RecordedOp]]] = [
            [] for _ in range(num_workers)
        ]
        self.profiled_steps: List[RecordedStep] = []

        # background traffic
        if platform.bg_rate > 0:
            for lid in self._lids:
                self._schedule_bg_arrival(lid)

    # ------------------------------------------------------------------ utils

    def _timer(self, dt: float, cb: Callable[[], None]) -> None:
        heapq.heappush(self.timers, (self.t + max(dt, 0.0), next(_seq), cb))

    def _lognorm(self, sigma: float) -> float:
        if sigma <= 0:
            return 1.0
        mu = -0.5 * sigma * sigma  # mean 1.0
        return math.exp(self.rng.gauss(mu, sigma))

    def _wspeed(self, w: int) -> float:
        """Compute speed factor of worker ``w``'s node (topology mode)."""
        return self.worker_speed.get(w, 1.0) if self.worker_speed else 1.0

    def _psspeed(self, p: int) -> float:
        """Compute speed factor of PS shard ``p``'s host (topology mode)."""
        return self.ps_speed.get(p, 1.0) if self.ps_speed else 1.0

    def _draw_win(self, conn: _Conn) -> float:
        p = self.platform
        if p.win_sigma <= 0:
            return p.win_mu
        rho = 0.95
        conn.win_state = rho * conn.win_state + self.rng.gauss(0.0, p.win_sigma)
        return max(1e5, p.win_mu * (1.0 + conn.win_state))

    # ------------------------------------------------- link event machinery

    def _schedule_link(self, lid: str) -> None:
        """(Re-)project the link's earliest flow completion onto the
        timer calendar; stale projections are dropped by epoch check."""
        link = self.links[lid]
        tp = link.next_projection(self.t)
        if tp is not None:
            heapq.heappush(self.timers,
                           (tp, next(_seq), ("link", lid, link.epoch)))

    def _link_event(self, lid: str, epoch: int) -> None:
        link = self.links[lid]
        if epoch != link.epoch:
            return                      # rate moved on; projection is stale
        done = link.pop_due(self.t)
        if done:
            epoch_before_cbs = link.epoch
            for flow in done:
                if flow.on_complete:
                    flow.on_complete()
            if link.epoch != epoch_before_cbs:
                # a callback re-filled the link and already projected it;
                # a second same-epoch projection would double link events
                return
        self._schedule_link(lid)

    # ------------------------------------------------------ background flows

    def _schedule_bg_arrival(self, lid: str) -> None:
        p = self.platform
        dt = self.rng.expovariate(p.bg_rate)
        self._timer(dt, lambda: self._bg_arrive(lid))

    def _bg_arrive(self, lid: str) -> None:
        p = self.platform
        flow = Flow(fid=next(_seq), weight=1.0, remaining=math.inf)
        if self.fabric is not None:
            # background traffic rides the same constraint groups as the
            # training flows (unique pseudo-worker: its own NIC group)
            self.fabric.add_flow(self.t, flow, (-flow.fid - 1, lid))
        else:
            self.links[lid].add_flow(self.t, flow)
            self._schedule_link(lid)
        dur = self.rng.expovariate(1.0 / p.bg_mean_duration)
        self._timer(dur, lambda: self._bg_depart(lid, flow.fid))
        self._schedule_bg_arrival(lid)

    def _bg_depart(self, lid: str, fid: int) -> None:
        if self.fabric is not None:
            self.fabric.remove_flow(self.t, fid)
        else:
            self.links[lid].remove_flow(self.t, fid)
            self._schedule_link(lid)

    # --------------------------------------------------------- fault replay

    def _set_link_scale(self, lname: str, factor: float) -> None:
        """Degradation / failover edge: scale one link's capacity."""
        if self.fabric is not None:
            self.fabric.iwf.set_scale(
                self.fabric.model.link_group_key(lname), factor)
            self.fabric._rebalance(self.t)
        else:
            link = self.links[lname]
            link.materialize(self.t)
            link.bandwidth = self.platform.bandwidth * factor
            link._set_rate()
            link.epoch += 1
            self._schedule_link(lid=lname)

    def _kill_worker(self, w: int) -> None:
        """Erase a crashed worker's in-flight state: execution units,
        queued streams, the active burst on every connection.  Timer
        closures of the old incarnation are orphaned by the gen check."""
        self.worker_busy[w] = False
        self.worker_q[w].clear()
        self.parse_busy[w] = False
        self.parse_q[w].clear()
        self.coll_busy[w] = False
        self.coll_q[w].clear()
        for p in range(self.M):
            self.ps_busy[(w, p)] = False
            self.ps_q[(w, p)].clear()
        for lid in self._lids:
            conn = self.conns[(w, lid)]
            conn.queue.clear()
            if conn.transmitting is not None:
                fid = conn.flow_fid
                conn.transmitting = None
                conn.flow_fid = None
                if fid is not None:
                    if self.fabric is not None:
                        self.fabric.remove_flow(self.t, fid)
                    else:
                        self.links[lid].remove_flow(self.t, fid)
                        self._schedule_link(lid)
        self.pending_ops[w] = 0

    def _fault_event(self, inc, is_down: bool) -> None:
        kind = inc.kind
        if kind in ("crash", "preempt"):
            w = inc.target
            if w >= self.W:
                return
            if is_down:
                if w in self.down:
                    return
                in_step = self.pending_ops[w] > 0
                if in_step:
                    self.wasted_s += self.t - self.step_start_time[w]
                    self.lost_steps += 1
                self.incarn[w] += 1
                self.down.add(w)
                self._kill_worker(w)
                self.incidents.append({
                    "kind": kind, "target": w, "t_down": inc.t_down,
                    "t_up": inc.t_up, "recovery": inc.t_up - inc.t_down,
                    "in_step": in_step})
                released = self.sync_ctl.on_worker_down(w, in_step, self.t)
            else:
                if w not in self.down:
                    return
                self.down.discard(w)
                k = self.faults.ckpt_interval_steps
                c = self.completed_steps[w]
                floor = (c // k) * k if k > 0 else c
                released = self.sync_ctl.on_worker_up(w, floor, self.t)
                if c < self.steps_target:
                    self._start_step(w)
            for rw in released:
                if rw not in self.down \
                        and self.completed_steps[rw] < self.steps_target:
                    self._start_step(rw)
        elif kind == "ps_fail":
            names = shard_link_names(
                inc.target, {lid: None for lid in self._lids}, self.topology)
            for lname in names:
                self._set_link_scale(lname, 0.0 if is_down else 1.0)
            if is_down:
                self.incidents.append({
                    "kind": kind, "target": inc.target,
                    "t_down": inc.t_down, "t_up": inc.t_up,
                    "recovery": inc.t_up - inc.t_down})
        else:   # degrade
            self._set_link_scale(inc.target,
                                 inc.factor if is_down else 1.0)
            if is_down:
                self.incidents.append({
                    "kind": kind, "target": inc.target,
                    "t_down": inc.t_down, "t_up": inc.t_up,
                    "recovery": inc.t_up - inc.t_down,
                    "factor": inc.factor})

    # --------------------------------------------------------- op lifecycle

    def _op_ready(self, w: int, op_idx: int) -> None:
        op = self.ops[op_idx]
        res = op.res
        if res.startswith(("downlink", "uplink")):
            stream = _Stream(op_idx=op_idx, worker=w,
                             step_seq=self.completed_steps[w],
                             size=op.size, remaining=op.size,
                             priority=op.priority, enqueue_time=self.t)
            if self.record_profile:
                rec = self.current_records[w][op_idx]
                rec.start = self.t
            conn = self.conns[(w, res)]
            self._conn_enqueue(conn, stream, res)
        elif res == "worker":
            self.worker_q[w].append((op_idx, self.completed_steps[w]))
            self._worker_kick(w)
        elif res == "collective":
            # collective phase: duration compiled from the topology's
            # water-filled lockstep rate, jittered like link service
            dur = (op.end - op.start) * self._lognorm(
                self.platform.noise_bandwidth)
            self.coll_q[w].append((op_idx, dur))
            self._coll_kick(w)
        elif res.startswith("ps"):
            p = 0 if res == "ps" else int(res.split(":")[1])
            dur = (op.end - op.start) * self._lognorm(
                self.platform.noise_compute) / self._psspeed(p)
            self.ps_q[(w, p)].append(("update", op_idx, self.completed_steps[w], dur))
            self._ps_kick(w, p)
        else:
            raise ValueError(f"unexpected resource {res}")

    def _op_done(self, w: int, op_idx: int) -> None:
        if self.record_profile:
            rec = self.current_records[w][op_idx]
            rec.end = self.t
        self.pending_ops[w] -= 1
        for j in self._dependents[op_idx]:
            self.remaining_deps[w][j] -= 1
            if self.remaining_deps[w][j] == 0:
                self._op_ready(w, j)
        if self.pending_ops[w] == 0:
            self._step_done(w)

    # ------------------------------------------------------- worker compute

    def _worker_kick(self, w: int) -> None:
        if self.worker_busy[w] or not self.worker_q[w]:
            return
        op_idx, _seq_ = self.worker_q[w].popleft()
        op = self.ops[op_idx]
        self.worker_busy[w] = True
        dur = (op.end - op.start) * self._lognorm(
            self.platform.noise_compute) / self._wspeed(w)
        if self.record_profile:
            self.current_records[w][op_idx].start = self.t
        gen = self.incarn[w]

        def done():
            if gen != self.incarn[w]:
                return   # worker crashed while this op was running
            self.worker_busy[w] = False
            self._op_done(w, op_idx)
            self._worker_kick(w)

        self._timer(dur, done)

    # --------------------------------------------------------- parse threads

    def _worker_parse_enqueue(self, w: int, op_idx: int, size: float) -> None:
        self.parse_q[w].append((op_idx, self.completed_steps[w], size, ""))
        self._parse_kick(w)

    def _parse_kick(self, w: int) -> None:
        if self.parse_busy[w] or not self.parse_q[w]:
            return
        op_idx, _s, size, _ = self.parse_q[w].popleft()
        self.parse_busy[w] = True
        p = self.platform
        dur = (p.overhead_alpha * size + p.overhead_beta) * self._lognorm(
            p.noise_compute) / self._wspeed(w)
        gen = self.incarn[w]

        def done():
            if gen != self.incarn[w]:
                return
            self.parse_busy[w] = False
            self._op_done(w, op_idx)
            self._parse_kick(w)

        self._timer(dur, done)

    def _coll_kick(self, w: int) -> None:
        if self.coll_busy[w] or not self.coll_q[w]:
            return
        op_idx, dur = self.coll_q[w].popleft()
        self.coll_busy[w] = True
        if self.record_profile:
            self.current_records[w][op_idx].start = self.t
        gen = self.incarn[w]

        def done():
            if gen != self.incarn[w]:
                return
            self.coll_busy[w] = False
            self._op_done(w, op_idx)
            self._coll_kick(w)

        self._timer(dur, done)

    def _ps_kick(self, w: int, p: int) -> None:
        if self.ps_busy[(w, p)] or not self.ps_q[(w, p)]:
            return
        kind, op_idx, _s, dur = self.ps_q[(w, p)].popleft()
        if kind == "update" and self.record_profile:
            # record actual execution start (request time is irrelevant for
            # PS compute ops; TF traces report the executed interval)
            self.current_records[w][op_idx].start = self.t
        gen = self.incarn[w]

        def done():
            if gen != self.incarn[w]:
                return
            self.ps_busy[(w, p)] = False
            self._op_done(w, op_idx)
            self._ps_kick(w, p)

        self.ps_busy[(w, p)] = True
        self._timer(dur, done)

    # ----------------------------------------------------------- connections

    def _conn_enqueue(self, conn: _Conn, stream: _Stream, lid: str) -> None:
        if self.flow_control or self.order == "profiled":
            conn.queue.append(stream)
        else:
            # enforced order: insert by priority (stable)
            q = list(conn.queue)
            q.append(stream)
            q.sort(key=lambda s: s.priority)
            conn.queue = deque(q)
        self._conn_kick(conn, lid)

    def _conn_kick(self, conn: _Conn, lid: str) -> None:
        if conn.transmitting is not None or not conn.queue:
            return
        stream = conn.queue.popleft()
        conn.transmitting = stream
        p = self.platform
        if self.flow_control and not stream.serviced_once:
            win = self._draw_win(conn)
            burst = min(stream.remaining, win)
            preempt = stream.remaining > win
        else:
            burst = stream.remaining
            preempt = False
        weight = self._lognorm(p.noise_bandwidth)
        flow = Flow(fid=next(_seq), weight=weight, remaining=burst)
        conn.flow_fid = flow.fid
        gen = self.incarn[stream.worker]

        def burst_done():
            if gen != self.incarn[stream.worker]:
                return   # crashed mid-burst (flow was force-removed)
            stream.remaining -= burst
            conn.transmitting = None
            conn.flow_fid = None
            if preempt:
                stream.serviced_once = True
                # remainder eligible after the receiver parses this burst
                stall = p.overhead_alpha * burst + p.rtt

                def rejoin():
                    if gen != self.incarn[stream.worker]:
                        return
                    conn.queue.append(stream)
                    self._conn_kick(conn, lid)

                self._timer(stall, rejoin)
            else:
                self._stream_complete(stream, lid)
            self._conn_kick(conn, lid)

        flow.on_complete = burst_done
        if self.fabric is not None:
            self.fabric.add_flow(self.t, flow, (stream.worker, lid))
        else:
            self.links[lid].add_flow(self.t, flow)
            self._schedule_link(lid)

    def _stream_complete(self, stream: _Stream, lid: str) -> None:
        w = stream.worker
        op_idx = stream.op_idx
        if lid.startswith("downlink"):
            # parse on the worker's recv thread, then op is done
            self._worker_parse_enqueue(w, op_idx, stream.size)
        else:
            # parse on the per-worker server thread at this PS
            p = 0 if lid == "uplink" else int(lid.split(":")[1])
            plat = self.platform
            dur = (plat.overhead_alpha * stream.size + plat.overhead_beta) \
                * self._lognorm(plat.noise_compute) / self._psspeed(p)
            self.ps_q[(w, p)].append(("parse", op_idx, stream.step_seq, dur))
            self._ps_kick(w, p)

    # -------------------------------------------------------- step lifecycle

    def _start_step(self, w: int) -> None:
        self.sync_ctl.on_step_start(w)
        n = len(self.ops)
        self.remaining_deps[w] = [len(op.deps) for op in self.ops]
        self.pending_ops[w] = n
        self.step_start_time[w] = self.t
        if self.record_profile:
            self.current_records[w] = [
                RecordedOp(name=op.name, res=op.res, deps=op.deps,
                           size=op.size, start=self.t, end=self.t,
                           priority=op.priority, tags=dict(op.tags))
                for op in self.ops
            ]
        for i, op in enumerate(self.ops):
            if not op.deps:
                self._op_ready(w, i)

    def _step_done(self, w: int) -> None:
        self.completed_steps[w] += 1
        self.step_completion_times.append(
            (w, self.completed_steps[w] - 1, self.t))
        if self.record_profile:
            self.profiled_steps.append(
                RecordedStep(ops=list(self.current_records[w]),
                             meta=dict(self.template.meta)))
        lag, released = self.sync_ctl.on_step_complete(w, self.t)
        self.staleness.append(lag)
        if self._fault_mode:
            dt = self.t - self.step_start_time[w]
            if lag and self.sync_ctl.drops_stale:
                self.wasted_s += dt   # stale gradient dropped at the barrier
            else:
                self.useful_s += dt
        for rw in released:
            if rw not in self.down \
                    and self.completed_steps[rw] < self.steps_target:
                self._start_step(rw)

    # ------------------------------------------------------------- main loop

    def start(self, steps_per_worker: int = 100) -> None:
        """Preamble of :meth:`run`: cache the dependency fan-out, replay
        the fault schedule onto the calendar, and launch every worker's
        first step.  Split out so a fleet orchestrator can start several
        emulators against ONE shared calendar and drain them together."""
        # cache dependents once
        self._dependents: List[List[int]] = [[] for _ in self.ops]
        for i, op in enumerate(self.ops):
            for d in op.deps:
                self._dependents[d].append(i)

        self.steps_target = steps_per_worker
        fs = self.faults
        if fs is not None and not fs.empty():
            schedule = compile_faults(
                fs, self.W, link_names=self._lids, num_shards=self.M,
                resources={lid: None for lid in self._lids},
                topology=self.topology)
            self._fault_mode = bool(schedule.incidents)
            if (self._fault_mode and schedule.link_events()
                    and self.fabric is not None and self.fabric.iwf is None):
                raise ValueError(
                    "link fault events (ps_failures / degradation) need the "
                    "incremental fabric; fabric_mode='batch' has no "
                    "capacity-scaling hook")
            for inc in schedule.incidents:
                heapq.heappush(
                    self.timers,
                    (inc.t_down, next(_seq),
                     lambda inc=inc: self._fault_event(inc, True)))
                heapq.heappush(
                    self.timers,
                    (inc.t_up, next(_seq),
                     lambda inc=inc: self._fault_event(inc, False)))
        for w in range(self.W):
            self._start_step(w)

    def run(self, steps_per_worker: int = 100,
            horizon: float = 1e7) -> None:
        self.start(steps_per_worker)
        guard = 0
        max_events = 2000 * steps_per_worker * self.W * max(1, len(self.ops))
        timers = self.timers
        while self.t < horizon:
            guard += 1
            if guard > max_events:
                raise RuntimeError("emulator event guard tripped")
            if all(c >= self.steps_target for c in self.completed_steps):
                break
            if not timers:
                break  # nothing left to do (link events live here too)

            t_next, _s, item = heapq.heappop(timers)
            if t_next > self.t:
                self.t = t_next
            if type(item) is tuple:       # ("link"|"flow", id, epoch)
                if item[0] == "link":
                    self._link_event(item[1], item[2])
                else:
                    self.fabric.flow_event(item[2])
            else:
                item()

    # ------------------------------------------------------------ public API

    def to_chrome_trace(self) -> dict:
        """The emulator's profiling records as a Chrome trace-event dict
        (Perfetto / ``chrome://tracing``).  Requires a
        ``record_profile=True`` run; flow arrows follow the recorded op
        dependency indices exactly.  See :mod:`repro_torch.obs.trace_export`."""
        from repro_torch.obs.trace_export import recorded_steps_to_chrome_trace
        return recorded_steps_to_chrome_trace(self.profiled_steps,
                                              incidents=self.incidents)

    def _measurement_window(self, warmup_steps: int,
                            window: str) -> Tuple[float, float]:
        """Same boundary logic as ``Trace.measurement_window``, including
        the incident cap: a worker's warmup boundary never slides past its
        first crash/preemption (the restored worker resumes from a
        checkpoint — it does not re-warm)."""
        if window not in ("common", "all-active"):
            raise ValueError(f"unknown throughput window {window!r}")
        per_worker: Dict[int, List[float]] = {}
        for w, _s, t in self.step_completion_times:
            per_worker.setdefault(w, []).append(t)
        if not per_worker:
            return 0.0, 0.0
        first_down: Dict[int, float] = {}
        for inc in self.incidents:
            if inc["kind"] in ("crash", "preempt"):
                w = inc["target"]
                td = inc["t_down"]
                if w not in first_down or td < first_down[w]:
                    first_down[w] = td
        boundaries, ends = [], []
        for w, times in per_worker.items():
            times.sort()
            k = warmup_steps if len(times) > warmup_steps \
                else max(1, len(times) // 2)
            b = times[k - 1]
            cap = first_down.get(w)
            if cap is not None and cap < b:
                b = cap
            boundaries.append(b)
            ends.append(times[-1])
        w0 = max(boundaries)
        w1 = max(ends) if window == "common" else min(ends)
        return w0, w1

    def throughput(self, warmup_steps: int = 50,
                   window: str = "common") -> float:
        """Measured examples/s (paper §4.1: average after warmup window).
        ``window`` follows ``Trace.throughput``: "common" (default) or
        "all-active" (end at the earliest per-worker last completion —
        fair under heterogeneous worker speeds)."""
        w0, w1 = self._measurement_window(warmup_steps, window)
        if w1 <= w0:
            return 0.0
        n = sum(1 for _w, _s, t in self.step_completion_times if w0 < t <= w1)
        return n * self.batch_size / (w1 - w0)

    def goodput(self, warmup_steps: int = 50,
                window: str = "common") -> float:
        """Examples/s of *applied* updates: stale completions dropped by a
        sync/allreduce barrier are excluded from the numerator; downtime
        still dilutes the window (``Trace.goodput``'s counterpart)."""
        w0, w1 = self._measurement_window(warmup_steps, window)
        if w1 <= w0:
            return 0.0
        drops = self.sync_ctl.drops_stale \
            and len(self.staleness) == len(self.step_completion_times)
        n = 0
        for i, (_w, _s, t) in enumerate(self.step_completion_times):
            if w0 < t <= w1 and not (drops and self.staleness[i] > 0):
                n += 1
        return n * self.batch_size / (w1 - w0)

    def staleness_stats(self) -> Dict[str, float]:
        """mean/p50/p99/max version lag over all completed steps (the
        counterpart of ``Trace.staleness_stats`` on the predictor side)."""
        return staleness_stats(self.staleness)


# ---------------------------------------------------------------------------
# High-level helpers
# ---------------------------------------------------------------------------


def profile_single_worker(dnn: DnnSpec, batch_size: int, platform: Platform,
                          num_ps: int = 1, steps: int = 100, seed: int = 0,
                          flow_control: bool = True,
                          order: str = "profiled") -> List[RecordedStep]:
    """Paper §2: profile 100 steps with 1 PS (or M PS) and 1 worker."""
    emu = ClusterEmulator(dnn, batch_size, platform, num_workers=1,
                          num_ps=num_ps, seed=seed, flow_control=flow_control,
                          order=order, record_profile=True)
    emu.run(steps_per_worker=steps)
    # drop the first 2 steps (TF session warmup; stabilizes recorded times)
    return emu.profiled_steps[2:] if len(emu.profiled_steps) > 4 else emu.profiled_steps


def measure_throughput(dnn: DnnSpec, batch_size: int, platform: Platform,
                       num_workers: int, num_ps: int = 1, steps: int = 100,
                       seed: int = 0, flow_control: bool = True,
                       order: str = "profiled",
                       warmup_steps: int = 50,
                       topology: Optional[Topology] = None,
                       sync: Optional[SyncSpec] = None,
                       faults: Optional[FaultSpec] = None) -> float:
    """Ground-truth measurement (the paper's 'real cluster' datapoint)."""
    emu = ClusterEmulator(dnn, batch_size, platform, num_workers=num_workers,
                          num_ps=num_ps, seed=seed, flow_control=flow_control,
                          order=order, topology=topology, sync=sync,
                          faults=faults)
    emu.run(steps_per_worker=steps)
    return emu.throughput(warmup_steps=warmup_steps)


def observe_run(dnn: DnnSpec, batch_size: int, platform: Platform,
                num_workers: int, num_ps: int = 1, steps: int = 100,
                seed: int = 0, flow_control: bool = True,
                order: str = "profiled",
                warmup_steps: int = 50,
                topology: Optional[Topology] = None,
                sync: Optional[SyncSpec] = None,
                faults: Optional[FaultSpec] = None
                ) -> Tuple[float, List[RecordedStep]]:
    """One observed run for the calibration loop: ground-truth
    throughput **plus** the TF-style recorded steps it was measured from
    (``measure_throughput`` discards them).  The calibration loop
    (ROADMAP 1.18b) feeds the steps to the fitter and compares predictions
    to the throughput — predict → execute → compare → refit."""
    emu = ClusterEmulator(dnn, batch_size, platform, num_workers=num_workers,
                          num_ps=num_ps, seed=seed, flow_control=flow_control,
                          order=order, topology=topology, sync=sync,
                          faults=faults, record_profile=True)
    emu.run(steps_per_worker=steps)
    return emu.throughput(warmup_steps=warmup_steps), emu.profiled_steps


def probe_parse_overheads(platform: Platform, sizes: Sequence[float],
                          seed: int = 0) -> List[float]:
    """Microbenchmark of receiver parse cost vs size (Fig. 10 data)."""
    rng = random.Random(seed)
    out = []
    for s in sizes:
        sigma = platform.noise_compute
        mu = -0.5 * sigma * sigma
        jit = math.exp(rng.gauss(mu, sigma)) if sigma > 0 else 1.0
        out.append((platform.overhead_alpha * s + platform.overhead_beta) * jit)
    return out


# --------------------------------------------------------------------- fleet


class _TenantModel:
    """Per-job view of the fleet bandwidth model: local link names map to
    the fleet's namespaced group keys (``uplink`` of job 2 scales the
    ``("link", "j2/uplink")`` group, nobody else's)."""

    def __init__(self, job_index: int):
        self.j = job_index

    def link_group_key(self, lname: str):
        return ("link", f"j{self.j}/{lname}")


class _TenantFabric:
    """Facade a fleet member uses as its ``fabric``: every call forwards
    to the ONE shared :class:`_Fabric` after rewriting the member's local
    ``(worker, link)`` connection into the fleet's namespaced connection
    space, so all jobs' bursts contend in a single weighted waterfill.
    Flow ids come from the module-global ``_seq`` and are already unique
    across members, so removals and projections forward unchanged."""

    def __init__(self, shared: _Fabric, job_index: int, worker_base: int):
        self.shared = shared
        self.j = job_index
        self.base = worker_base
        self.model = _TenantModel(job_index)

    @property
    def iwf(self):
        return self.shared.iwf

    @property
    def rate_log(self):
        return self.shared.rate_log

    def _conn(self, conn: Tuple[int, str]) -> Tuple[int, str]:
        w, lid = conn
        return (self.base + w, f"j{self.j}/{lid}")

    def add_flow(self, t: float, flow: Flow, conn: Tuple[int, str]) -> None:
        self.shared.add_flow(t, flow, self._conn(conn))

    def remove_flow(self, t: float, fid: int) -> None:
        self.shared.remove_flow(t, fid)

    def _rebalance(self, t: float) -> None:
        self.shared._rebalance(t)

    def flow_event(self, epoch: int) -> None:
        self.shared.flow_event(epoch)


class FleetEmulator:
    """Concurrent :class:`ClusterEmulator` members on one shared fabric.

    The ground-truth counterpart of ``repro_torch.core.fleet.FleetSimulation``'s
    merged engine: each job of a ``FleetConfig`` becomes a member emulator
    built against its sub-topology, every member's timer calendar is the
    SAME heap (the module-global ``_seq`` already totally orders entries
    across members), and every member's fabric is a :class:`_TenantFabric`
    facade over one shared weighted-waterfill pool compiled from
    ``repro_torch.core.fleet.FleetBandwidthModel`` — so a burst of job A and a
    burst of job B colocated on one node split that node's NIC exactly as
    the DES merged engine splits it.

    ``workloads`` maps job name -> dict with ``dnn``, ``batch_size``,
    ``platform`` (and optionally ``flow_control``, ``order``).  Members
    keep their own RNGs (job seed), sync controllers and fault replays;
    all-reduce members run the compiled collective DAG (the emulator does
    not model live collective flows — that is the DES engine's job).
    """

    def __init__(self, fleet, workloads: Dict[str, dict],
                 fabric_mode: str = "incremental"):
        from repro_torch.core.fleet import FleetBandwidthModel
        if fleet.topology.bandwidth is None:
            raise ValueError("fleet topology needs an explicit bandwidth")
        self.fleet = fleet
        self.t = 0.0
        self.timers: List[Tuple[float, int, object]] = []
        self.fabric = _Fabric(self, FleetBandwidthModel(fleet),
                              fleet.topology.bandwidth,
                              incremental=fabric_mode == "incremental")
        base = fleet.worker_base()
        self.members: List[ClusterEmulator] = []
        for j, job in enumerate(fleet.jobs):
            if job.name not in workloads:
                raise ValueError(f"workloads is missing job {job.name!r}")
            wl = workloads[job.name]
            m = ClusterEmulator(
                wl["dnn"], wl["batch_size"], wl["platform"],
                num_workers=job.num_workers, seed=job.seed,
                flow_control=wl.get("flow_control", True),
                order=wl.get("order", "profiled"),
                topology=fleet.sub_topology(j),
                sync=fleet.sim_config(j).sync_spec(),
                fabric_mode=fabric_mode, faults=job.faults)
            # adopt the shared calendar (keeping anything the member
            # scheduled during construction, e.g. background traffic)
            for e in m.timers:
                heapq.heappush(self.timers, e)
            m.timers = self.timers
            m.fabric = _TenantFabric(self.fabric, j, base[j])
            self.members.append(m)

    def member(self, name: str) -> ClusterEmulator:
        return self.members[self.fleet.job_index(name)]

    def run(self, steps_per_worker=100, horizon: float = 1e7) -> None:
        """Drain the merged calendar until every job hits its target.
        ``steps_per_worker`` is an int for all jobs or a mapping
        job name -> int."""
        max_events = 0
        for j, job in enumerate(self.fleet.jobs):
            n = (steps_per_worker if isinstance(steps_per_worker, int)
                 else steps_per_worker[job.name])
            m = self.members[j]
            m.start(n)
            max_events += 2000 * n * m.W * max(1, len(m.ops))
        guard = 0
        timers = self.timers
        members = self.members
        while self.t < horizon:
            guard += 1
            if guard > max_events:
                raise RuntimeError("fleet emulator event guard tripped")
            if all(c >= m.steps_target for m in members
                   for c in m.completed_steps):
                break
            if not timers:
                break
            t_next, _s, item = heapq.heappop(timers)
            if t_next > self.t:
                self.t = t_next
                for m in members:
                    m.t = self.t
            if type(item) is tuple:     # ("flow", None, epoch): shared pool
                self.fabric.flow_event(item[2])
            else:
                item()

    def throughputs(self, warmup_steps: int = 50,
                    window: str = "common") -> Dict[str, float]:
        """examples/s per job off each member's completion record."""
        return {job.name: self.members[j].throughput(
                    warmup_steps=warmup_steps, window=window)
                for j, job in enumerate(self.fleet.jobs)}
