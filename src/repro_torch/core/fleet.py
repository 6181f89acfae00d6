"""Multi-tenant fleet fabric: concurrent training jobs on one topology.

The paper predicts throughput for a *single* async-SGD job on a private
cluster; production clusters run dozens of jobs — PS and all-reduce,
different models, different synchronization regimes — contending for the
same racks and NICs.  This module makes the *job* a first-class unit:

  * :class:`FleetJob` — one job's placement on the shared fleet topology
    (worker nodes, PS shard hosts) plus its own workload knobs (steps,
    seed, sync mode, fault spec, jitter, flow control);
  * :class:`FleetConfig` — several jobs mapped onto one shared
    :class:`~repro_torch.core.topology.Topology`; ``sim_config(j)``
    compiles the per-job :class:`~repro_torch.core.simulator.SimConfig`
    against the job's sub-topology (rack uplink capacities pinned to the
    *fleet-level* values, so a run-alone baseline sees the same fabric the
    fleet does);
  * :class:`FleetBandwidthModel` — capacity groups over the shared fabric:
    per-link (keyed by the job-namespaced resource, so a failed shard of
    one job never throttles a co-hosted neighbour's links), per-node NIC
    per direction (jobs colocated on a node share its ports), and
    per-rack-uplink per direction from the fleet's
    ``rack_uplink_caps()``;
  * :class:`FleetSimulation` — a single merged DES event calendar
    advancing every job at once, all flows contending in ONE
    :class:`~repro_torch.core.bandwidth.IncrementalWaterfill`; cross-job
    churn only touches shared connected components, so the group-local
    solver carries the cost.  Each job keeps its own RNG, sync controller
    and :class:`~repro_torch.core.events.Trace` — job A's random stream is
    provably independent of job B's seed (the trace-isolation gate in
    ``tests/test_fleet.py``).

Collective phases are *live flows*: in the merged engine an all-reduce
job's per-layer collective ops are not executed at the fixed rate compiled
at DAG-build time — instead each round's flows (per-round membership
from ``repro_torch.core.collectives.collective_rounds``) enter the shared
waterfill and contend with every other job's transfers.
``collective_k`` enables herring-style k-of-n partial participation: a
round starts once k gradients arrived, and stragglers arriving after the
round completed are merged instantly (their gradient missed the round).

Fleet-level interference metrics (:func:`interference_report`): per-job
slowdown vs. run-alone (same engine, same fabric, contenders removed),
the Jain fairness index over normalized throughputs, and — with
``record_contention=True`` — per-link contention timelines (time, number
of active flows).

A single-job :class:`FleetConfig` delegates to the scalar
:class:`~repro_torch.core.simulator.Simulation` and is bit-identical to
running the corresponding ``SimConfig`` directly (golden-trace acceptance
gate); ``run(..., merged=True)`` forces the merged engine for baselines that
must share arithmetic with the contended run.
"""
from __future__ import annotations

import heapq
import itertools
import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from ..obs import metrics as obs_metrics
from ..obs.timeline import LinkTimeline
from .bandwidth import BandwidthModel, IncrementalWaterfill, _direction_of
from .collectives import ALGORITHMS, collective_rounds
from .events import (LINK, Chunk, LiveOp, Op, ResourceSpec, StepTemplate,
                     Trace)
from .faults import FaultSpec, compile_faults, shard_link_names
from .fluidlink import EqualShareLink
from .schedulers import FifoScheduler, make_link_scheduler
from .simulator import (_EPS_COMPUTE, _EPS_LINK, _EPS_LINK_REL, _EPS_REJOIN,
                        _K_COMPUTE, _K_CONN, _K_FAULT, _K_REJOIN,
                        SimConfig, Simulation, compile_template)
from .syncmode import SYNC_MODES, allreduce_templates, make_controller
from .topology import Placement, Rack, Topology

__all__ = [
    "FleetJob", "FleetConfig", "FleetBandwidthModel", "FleetSimulation",
    "FleetTrace", "jain_index", "interference_report",
]


def jain_index(values: Sequence[float]) -> float:
    """Jain's fairness index (sum x)^2 / (n * sum x^2) over normalized
    per-job throughputs: 1.0 = perfectly fair, 1/n = one job starves the
    rest.  Empty or all-zero inputs count as fair (nothing to divide)."""
    xs = [float(v) for v in values]
    if not xs:
        return 1.0
    s = sum(xs)
    q = sum(x * x for x in xs)
    if q <= 0.0:
        return 1.0
    return (s * s) / (len(xs) * q)


@dataclass(frozen=True)
class FleetJob:
    """One training job of the fleet: placement on the shared topology
    plus its private workload knobs.  ``workers[i]`` is the fleet node
    running the job's worker ``i``; ``ps_hosts[p]`` hosts its PS shard
    ``p`` (empty for all-reduce jobs — they have no parameter servers).
    ``collective_k`` (allreduce mode) starts each collective round after
    ``k`` of the W gradients arrived (0 = full participation)."""

    name: str
    workers: Tuple[str, ...]
    ps_hosts: Tuple[str, ...] = ()
    batch_size: int = 1
    steps_per_worker: int = 400
    warmup_steps: int = 50
    seed: int = 0
    sync_mode: str = "async"
    backup_workers: int = 0
    staleness_bound: int = 0
    allreduce_algo: str = "ring"
    collective_k: int = 0
    sample: bool = True
    record_trace: bool = False
    service_jitter: float = 0.0
    stall_alpha: float = 0.0
    stall_rtt: float = 0.0
    win: float = 28e6
    link_policy: str = "http2"
    faults: Optional[FaultSpec] = None

    def __post_init__(self):
        object.__setattr__(self, "workers", tuple(self.workers))
        object.__setattr__(self, "ps_hosts", tuple(self.ps_hosts))
        if not self.name:
            raise ValueError("fleet job needs a non-empty name")
        if "/" in self.name:
            raise ValueError(
                f"job name {self.name!r} must not contain '/' (reserved "
                f"for the fleet's namespaced resource names)")
        if not self.workers:
            raise ValueError(f"job {self.name!r} needs >= 1 worker node")
        if self.sync_mode not in SYNC_MODES:
            raise ValueError(
                f"job {self.name!r}: unknown sync_mode {self.sync_mode!r}")
        if self.sync_mode != "allreduce" and not self.ps_hosts:
            raise ValueError(
                f"job {self.name!r}: {self.sync_mode} mode needs ps_hosts "
                f"(only allreduce jobs run without parameter servers)")
        if self.collective_k:
            if self.sync_mode != "allreduce":
                raise ValueError(
                    f"job {self.name!r}: collective_k is an allreduce knob")
            if not (2 <= self.collective_k <= len(self.workers)):
                raise ValueError(
                    f"job {self.name!r}: collective_k must be in "
                    f"[2, {len(self.workers)}], got {self.collective_k}")
        if self.allreduce_algo not in ALGORITHMS:
            raise ValueError(
                f"job {self.name!r}: unknown allreduce_algo "
                f"{self.allreduce_algo!r}")
        if self.batch_size < 1:
            raise ValueError(
                f"job {self.name!r}: batch_size must be >= 1")

    @property
    def num_workers(self) -> int:
        return len(self.workers)

    @property
    def num_shards(self) -> int:
        return len(self.ps_hosts)


@dataclass(frozen=True)
class FleetConfig:
    """Several jobs sharing one topology (and one waterfill state when run
    through the merged engine).  ``topology.bandwidth`` must be set — it
    is the nominal NIC rate every job's resources are compiled against."""

    topology: Topology
    jobs: Tuple[FleetJob, ...]
    record_contention: bool = False

    def __post_init__(self):
        object.__setattr__(self, "jobs", tuple(self.jobs))
        if not self.jobs:
            raise ValueError("fleet needs >= 1 job")
        if self.topology.bandwidth is None:
            raise ValueError(
                "fleet topology needs an explicit nominal bandwidth "
                "(Topology(bandwidth=...)): every job's resources are "
                "compiled against it")
        names = set()
        for job in self.jobs:
            if job.name in names:
                raise ValueError(f"duplicate job name {job.name!r}")
            names.add(job.name)
            for nm in job.workers + job.ps_hosts:
                try:
                    self.topology.node(nm)
                except KeyError:
                    raise ValueError(
                        f"job {job.name!r} references unknown fleet node "
                        f"{nm!r}") from None

    @property
    def bandwidth(self) -> float:
        return self.topology.bandwidth

    def job_index(self, name: str) -> int:
        for j, job in enumerate(self.jobs):
            if job.name == name:
                return j
        raise KeyError(name)

    def worker_base(self) -> List[int]:
        """Global worker-id base offset per job (job j's worker w is
        global worker ``base[j] + w`` in the merged engine)."""
        base, acc = [], 0
        for job in self.jobs:
            base.append(acc)
            acc += job.num_workers
        return base

    def sub_topology(self, j: int) -> Topology:
        """Job ``j``'s view of the fleet: its worker/PS nodes with the
        racks they reference, rack uplink capacities PINNED to the
        fleet-level values (the physical fabric does not shrink because
        only one tenant is running — run-alone baselines and the fleet
        model must agree on rack caps)."""
        job = self.jobs[j]
        topo = self.topology
        wnodes = tuple(topo.node(nm) for nm in job.workers)
        wnames = {n.name for n in wnodes}
        ps_nodes, seen = [], set()
        for h in job.ps_hosts:
            if h not in wnames and h not in seen:
                seen.add(h)
                ps_nodes.append(topo.node(h))
        if job.ps_hosts:
            placement = Placement(job.ps_hosts)
        else:
            # allreduce job: no PS traffic ever flows, but Topology (and
            # the canonical resource set) insists on >= 1 shard — park a
            # dummy shard on worker 0's node
            placement = Placement((job.workers[0],))
        referenced = {n.rack for n in wnodes + tuple(ps_nodes)
                      if n.rack is not None}
        caps = topo.rack_uplink_caps()
        racks = tuple(
            Rack(r.name, uplink_capacity=caps[r.name][0])
            if r.name in caps else r
            for r in topo.racks if r.name in referenced)
        return Topology(workers=wnodes, ps_nodes=tuple(ps_nodes),
                        racks=racks, placement=placement,
                        bandwidth=topo.bandwidth,
                        loopback_bypass=topo.loopback_bypass,
                        loopback_capacity=topo.loopback_capacity)

    def sim_config(self, j: int) -> SimConfig:
        """The corresponding single-job ``SimConfig`` — what a single-job
        fleet delegates to (bit-identical by construction)."""
        job = self.jobs[j]
        return SimConfig(topology=self.sub_topology(j),
                         link_policy=job.link_policy, win=job.win,
                         steps_per_worker=job.steps_per_worker,
                         warmup_steps=job.warmup_steps, seed=job.seed,
                         record_trace=job.record_trace,
                         stall_alpha=job.stall_alpha,
                         stall_rtt=job.stall_rtt,
                         service_jitter=job.service_jitter,
                         sync_mode=job.sync_mode,
                         backup_workers=job.backup_workers,
                         staleness_bound=job.staleness_bound,
                         allreduce_algo=job.allreduce_algo,
                         faults=job.faults)


@dataclass
class FleetTrace:
    """Per-job traces plus fleet-level metadata from one fleet run."""

    jobs: Dict[str, Trace]
    meta: Dict[str, object] = field(default_factory=dict)

    def throughputs(self, cfg: FleetConfig,
                    window: str = "common") -> Dict[str, float]:
        """examples/s per job (each job's own batch size and warmup)."""
        out = {}
        for job in cfg.jobs:
            out[job.name] = self.jobs[job.name].throughput(
                job.batch_size, warmup_steps=job.warmup_steps,
                window=window)
        return out


class FleetBandwidthModel(BandwidthModel):
    """Max-min water-filling groups over the shared fleet fabric.

    Connections are ``(global_worker, "j<j>/<local_res>")``.  Groups:

      * ``("link", gres)`` — the shard host's NIC in the link's physical
        direction, keyed per *namespaced* link so PS failover of one job
        scales only that job's links;
      * ``("ntx"|"nrx", node_name)`` — the node's per-direction NIC port,
        keyed by *node*, so different jobs' workers (or shards) colocated
        on one machine contend for the same port;
      * ``("rack", name, "egress"|"ingress")`` — the rack uplink from the
        fleet's ``rack_uplink_caps()``, for connections crossing a rack
        boundary.

    Live collective flows (``j<j>/coll<cid>:<src>><dst>``) ride sender-tx
    and receiver-rx node groups plus any rack crossing; loopback-bypass
    transfers ride their node's loopback group alone.  Unknown
    pseudo-workers (the emulator's background flows) fall back to
    link + own-NIC groups at nominal capacity."""

    def __init__(self, cfg: FleetConfig):
        super().__init__()
        self.cfg = cfg
        self.topo = cfg.topology
        self._rack_caps = self.topo.rack_uplink_caps()
        self._base = cfg.worker_base()
        self._wnodes = [tuple(self.topo.node(nm) for nm in job.workers)
                        for job in cfg.jobs]
        self._hnodes = [tuple(self.topo.node(nm) for nm in job.ps_hosts)
                        for job in cfg.jobs]

    def _parse(self, gres: str) -> Tuple[Optional[int], str]:
        if not gres.startswith("j"):
            return None, gres
        i = gres.find("/")
        if i < 0:
            return None, gres
        try:
            j = int(gres[1:i])
        except ValueError:
            return None, gres
        if not (0 <= j < len(self._wnodes)):
            return None, gres
        return j, gres[i + 1:]

    def _rack_pairs(self, out: list, txn, rxn) -> None:
        if txn.rack == rxn.rack:
            return
        caps = self._rack_caps
        if txn.rack in caps:
            out.append((("rack", txn.rack, "egress"), caps[txn.rack][0]))
        if rxn.rack in caps:
            out.append((("rack", rxn.rack, "ingress"), caps[rxn.rack][1]))

    def conn_groups(self, conn) -> Tuple[Tuple[object, float], ...]:
        gw, gres = conn
        j, local = self._parse(gres)
        if j is None:
            # not a fleet-namespaced resource: nominal fallback
            return ((("link", gres), self.link_capacity),
                    (("nic", gw, _direction_of(gres)),
                     self.worker_nic_capacity))
        wnodes = self._wnodes[j]
        if local.startswith("coll"):
            _head, pair = local.split(":", 1)
            s, d = pair.split(">")
            sn, dn = wnodes[int(s)], wnodes[int(d)]
            if sn.name == dn.name:
                if self.topo.loopback_bypass:
                    return ((("loopback", sn.name),
                             self.topo.loopback_capacity),)
                return ((("ntx", sn.name), sn.tx), (("nrx", dn.name), dn.rx))
            out = [(("ntx", sn.name), sn.tx), (("nrx", dn.name), dn.rx)]
            self._rack_pairs(out, sn, dn)
            return tuple(out)
        d = _direction_of(local)
        p = int(local.split(":", 1)[1]) if ":" in local else 0
        hosts = self._hnodes[j]
        host = hosts[p] if 0 <= p < len(hosts) else None
        lw = gw - self._base[j]
        wnode = wnodes[lw] if 0 <= lw < len(wnodes) else None
        if host is None or wnode is None:
            # pseudo-worker (emulator background flow) or a dummy shard
            cap = self.link_capacity
            if host is not None:
                cap = host.tx if d == "downlink" else host.rx
            return ((("link", gres), cap),
                    (("nic", gw, d), self.worker_nic_capacity))
        if wnode.name == host.name and self.topo.loopback_bypass:
            return ((("loopback", wnode.name), self.topo.loopback_capacity),)
        if d == "downlink":
            txn, rxn, lcap = host, wnode, host.tx
        else:
            txn, rxn, lcap = wnode, host, host.rx
        out = [(("link", gres), lcap),
               (("ntx", txn.name), txn.tx), (("nrx", rxn.name), rxn.rx)]
        self._rack_pairs(out, txn, rxn)
        return tuple(out)


class FleetSimulation:
    """Run a fleet: delegated scalar engine for a lone job, one merged
    event calendar + shared waterfill for concurrent jobs."""

    def __init__(self, cfg: FleetConfig):
        self.cfg = cfg

    # -- public API ---------------------------------------------------------

    def run(self, steps_by_job: Mapping[str, Sequence[StepTemplate]],
            merged: Optional[bool] = None) -> FleetTrace:
        """``steps_by_job`` maps job name -> profiled step templates.

        ``merged=None`` (default) delegates a single-job fleet to the
        scalar :class:`Simulation` (bit-identical to the corresponding
        ``SimConfig``) and runs >= 2 jobs through the merged engine;
        ``merged=True`` forces the merged engine even for one job —
        the run-alone baseline that shares arithmetic with the contended
        fleet run."""
        cfg = self.cfg
        for job in cfg.jobs:
            if job.name not in steps_by_job:
                raise ValueError(
                    f"steps_by_job is missing job {job.name!r}")
            if not steps_by_job[job.name]:
                raise ValueError(
                    f"job {job.name!r} needs >= 1 profiled step")
        if merged is None:
            merged = len(cfg.jobs) > 1
        if not merged:
            if len(cfg.jobs) != 1:
                raise ValueError(
                    "merged=False only applies to single-job fleets; use "
                    "run_alone() for per-job baselines of a larger fleet")
            return self._run_single(0, steps_by_job)
        return self._run_merged(steps_by_job)

    def run_alone(self, name: str,
                  steps_by_job: Mapping[str, Sequence[StepTemplate]],
                  merged: bool = True) -> FleetTrace:
        """One job of the fleet with every contender removed — the
        run-alone baseline behind slowdown/fairness metrics.  ``merged``
        keeps the baseline on the merged engine (same arithmetic as the
        contended run; pass False for the scalar delegation)."""
        j = self.cfg.job_index(name)
        alone = FleetConfig(topology=self.cfg.topology,
                            jobs=(self.cfg.jobs[j],),
                            record_contention=self.cfg.record_contention)
        return FleetSimulation(alone).run(
            {name: steps_by_job[name]}, merged=merged)

    # -- single-job delegation ----------------------------------------------

    def _templates(self, j: int, steps: Sequence[StepTemplate],
                   topology: Topology) -> List[StepTemplate]:
        job = self.cfg.jobs[j]
        if job.sync_mode != "allreduce":
            return list(steps)
        return allreduce_templates(steps, job.num_workers,
                                   bandwidth=self.cfg.bandwidth,
                                   algo=job.allreduce_algo,
                                   topology=topology)

    def _run_single(self, j: int, steps_by_job) -> FleetTrace:
        job = self.cfg.jobs[j]
        scfg = self.cfg.sim_config(j)
        tpls = self._templates(j, steps_by_job[job.name], scfg.topology)
        trace = Simulation(scfg).run(tpls, job.num_workers,
                                     sample=job.sample)
        trace.meta["engine"] = "fleet-delegated"
        return FleetTrace(jobs={job.name: trace},
                          meta={"engine": "fleet-delegated", "num_jobs": 1})

    # -- merged engine ------------------------------------------------------

    def _run_merged(self, steps_by_job) -> FleetTrace:
        cfg = self.cfg
        jobs = cfg.jobs
        J = len(jobs)
        base = cfg.worker_base()
        B = cfg.bandwidth
        model = FleetBandwidthModel(cfg)

        jcfg = [cfg.sim_config(j) for j in range(J)]
        jsteps: List[List[StepTemplate]] = []
        live: List[bool] = []
        for j, job in enumerate(jobs):
            live.append(job.sync_mode == "allreduce")
            if live[j] and job.faults is not None and not job.faults.empty():
                raise ValueError(
                    f"job {job.name!r}: fault injection on a live-collective "
                    f"(allreduce) fleet job is not supported in the merged "
                    f"engine yet")
            jsteps.append(self._templates(j, steps_by_job[job.name],
                                          jcfg[j].topology))

        num_gw = base[-1] + jobs[-1].num_workers
        jid: List[int] = []
        for j, job in enumerate(jobs):
            jid.extend([j] * job.num_workers)

        # per-job state: RNG, barrier controller, trace, jitter, targets
        rng = [random.Random(c.seed) for c in jcfg]
        ctl = [make_controller(c.sync_spec(), jobs[j].num_workers)
               for j, c in enumerate(jcfg)]
        traces = [Trace() for _ in jobs]
        jitter_sigma = [c.service_jitter for c in jcfg]
        jitter_mu = [-0.5 * s * s for s in jitter_sigma]
        stall = [c.stall_alpha * c.win + c.stall_rtt for c in jcfg]
        spw = [c.steps_per_worker for c in jcfg]
        total = [jobs[j].num_workers * spw[j] for j in range(J)]
        steps_done = [0] * J
        n_events_j = [0] * J
        job_end = [0.0] * J
        coll_k = [jobs[j].collective_k or jobs[j].num_workers
                  for j in range(J)]

        # namespaced resources and the global fabric state
        gres: List[Dict[str, str]] = []
        resources_g: Dict[str, ResourceSpec] = {}
        for j in range(J):
            m: Dict[str, str] = {}
            for r, spec in jcfg[j].resources.items():
                gname = f"j{j}/{r}"
                m[r] = gname
                resources_g[gname] = ResourceSpec(gname, spec.kind, B) \
                    if spec.kind == LINK else ResourceSpec(gname, spec.kind)
            gres.append(m)
        is_link_g = {r: s.kind == LINK for r, s in resources_g.items()}
        links: Dict[str, EqualShareLink] = {
            r: EqualShareLink(B) for r, s in resources_g.items()
            if s.kind == LINK}

        scheds: Dict[Tuple[int, str], object] = {}
        speed: Dict[Tuple[int, str], float] = {}
        for gw in range(num_gw):
            j = jid[gw]
            lw = gw - base[j]
            c = jcfg[j]
            for r, spec in c.resources.items():
                key = (gw, gres[j][r])
                if spec.kind == LINK:
                    scheds[key] = make_link_scheduler(c.link_policy, c.win)
                else:
                    scheds[key] = FifoScheduler()
                    s = 1.0
                    if c.worker_speed and r in ("worker", "parse"):
                        s *= c.worker_speed.get(lw, 1.0)
                    if c.res_speed:
                        s *= c.res_speed.get(r, 1.0)
                    if s != 1.0:
                        speed[key] = s

        iwf = IncrementalWaterfill(model.conn_groups)
        cur_shares = iwf.shares
        needs_proj: Set[Tuple[int, str]] = set()
        running: Dict[Tuple[int, str], Chunk] = {}
        calendar: List[tuple] = []
        cal_seq = itertools.count()
        start_seq = itertools.count()
        uid_counter = itertools.count()
        rejoin_pending = 0
        shares_dirty = False
        conn_rate: Dict[Tuple[int, str], float] = {}
        conn_mtime: Dict[Tuple[int, str], float] = {}
        conn_epoch: Dict[Tuple[int, str], int] = {}

        pending_ops = [0] * num_gw
        completed = [0] * num_gw
        sample_idx = [0] * num_gw
        step_start_t = [0.0] * num_gw

        # fault state (per job where it applies)
        down_workers: Set[int] = set()
        incarn = [0] * num_gw
        useful_s = [0.0] * J
        wasted_s = [0.0] * J
        lost_steps = [0] * J
        fault_mode = False
        schedules = []
        for j in range(J):
            fs = jobs[j].faults
            sched = None
            if fs is not None and not fs.empty():
                link_names = [r for r, s in jcfg[j].resources.items()
                              if s.kind == LINK]
                sched = compile_faults(
                    fs, jobs[j].num_workers, link_names=link_names,
                    num_shards=max(1, jcfg[j].topology.num_shards),
                    resources=jcfg[j].resources,
                    topology=jcfg[j].topology)
                if not sched.incidents:
                    sched = None
            schedules.append(sched)
            fault_mode = fault_mode or sched is not None

        # live collective state: group key -> round state
        coll_groups: Dict[tuple, dict] = {}
        coll_of: Dict[Tuple[int, str], tuple] = {}
        coll_cid = itertools.count()

        # contention timelines: (t, gres, active_count) transitions —
        # shared recorder also consumed by the Chrome-trace exporter
        # (repro_torch.obs.trace_export.timeline_counter_events)
        contention = LinkTimeline()
        record_contention = cfg.record_contention

        tpl_cache: Dict[Tuple[int, int], tuple] = {}

        def next_step(gw: int) -> StepTemplate:
            j = jid[gw]
            steps = jsteps[j]
            if jobs[j].sample:
                return steps[rng[j].randrange(len(steps))]
            i = sample_idx[gw]
            sample_idx[gw] += 1
            return steps[i % len(steps)]

        def start_step(gw: int, t: float) -> None:
            j = jid[gw]
            ctl[j].on_step_start(gw - base[j])
            tpl = next_step(gw)
            cached = tpl_cache.get((j, id(tpl)))
            if cached is None:
                cached = compile_template(tpl, jcfg[j].resources)
                tpl_cache[(j, id(tpl))] = cached
            ops, works, edges, roots = cached
            seq = completed[gw]
            gen = incarn[gw]
            step_start_t[gw] = t
            lives: List[LiveOp] = [
                LiveOp(uid=next(uid_counter), template=op, worker=gw,
                       step_seq=seq, remaining_deps=len(op.deps),
                       remaining_work=wk, gen=gen)
                for op, wk in zip(ops, works)
            ]
            for d, i in edges:
                lives[d].dependents.append(lives[i])
            pending_ops[gw] += len(lives)
            for i in roots:
                enqueue_op(lives[i], t)

        def begin_chunk(key: Tuple[int, str], chunk: Chunk,
                        t: float) -> None:
            nonlocal shares_dirty
            gw, gname = key
            if is_link_g[gname]:
                j = jid[gw]
                if jitter_sigma[j] > 0:
                    chunk.remaining *= math.exp(
                        rng[j].gauss(jitter_mu[j], jitter_sigma[j]))
                chunk.seq = next(start_seq)
                running[key] = chunk
                link = links[gname]
                link.materialize(t)
                was_active = gw in link.active
                link.active.add(gw)
                conn_mtime[key] = t
                epoch = conn_epoch.get(key, 0) + 1
                conn_epoch[key] = epoch
                if not was_active and record_contention:
                    contention.record(t, gname, len(link.active))
                if was_active and not shares_dirty:
                    r = cur_shares.get(key, 0.0) * B
                    conn_rate[key] = r
                    if r > 0.0:
                        heapq.heappush(
                            calendar,
                            (t + chunk.remaining / r, next(cal_seq),
                             _K_CONN, key, epoch))
                    else:
                        shares_dirty = True
                        needs_proj.add(key)
                else:
                    conn_rate[key] = 0.0
                    shares_dirty = True
                    if not was_active:
                        iwf.add(key)
                    needs_proj.add(key)
            else:
                chunk.seq = next(start_seq)
                running[key] = chunk
                dur = chunk.remaining
                sp = speed.get(key)
                if sp is not None:
                    dur = dur / sp
                heapq.heappush(calendar,
                               (t + dur, next(cal_seq),
                                _K_COMPUTE, key, chunk))
            if chunk.op.start_time < 0:
                chunk.op.start_time = t

        def try_start_chunk(gw: int, gname: str, t: float) -> None:
            key = (gw, gname)
            if key in running:
                return
            chunk = scheds[key].remove_chunk()
            if chunk is not None:
                begin_chunk(key, chunk, t)

        def enqueue_op(lop: LiveOp, t: float) -> None:
            rname = lop.template.res
            j = jid[lop.worker]
            if rname == "collective" and live[j]:
                coll_arrive(j, lop, t)
                return
            gname = gres[j][rname]
            scheds[(lop.worker, gname)].add(lop)
            try_start_chunk(lop.worker, gname, t)

        # -- live collectives -------------------------------------------

        def coll_arrive(j: int, lop: LiveOp, t: float) -> None:
            gkey = (j, lop.step_seq, lop.name)
            st = coll_groups.get(gkey)
            if st is None:
                st = {"arrived": [], "state": "wait",
                      "size": lop.template.size, "rounds": None,
                      "ri": 0, "out": 0}
                coll_groups[gkey] = st
            st["arrived"].append(lop)
            if st["state"] == "wait" and len(st["arrived"]) >= coll_k[j]:
                start_collective(j, gkey, st, t)
            elif st["state"] == "done":
                # herring-style partial participation: the round already
                # ran with k participants; the straggler's gradient merges
                # instantly (it missed the round)
                finish_coll_op(j, lop, t)
            if st["state"] == "done" \
                    and len(st["arrived"]) >= jobs[j].num_workers:
                coll_groups.pop(gkey, None)

        def start_collective(j: int, gkey: tuple, st: dict,
                             t: float) -> None:
            participants = sorted(lop.worker - base[j]
                                  for lop in st["arrived"])
            rounds = collective_rounds(participants, st["size"],
                                       jobs[j].allreduce_algo)
            if not rounds:
                finish_collective(j, st, t)
                return
            st["state"] = "run"
            st["rounds"] = rounds
            st["ri"] = 0
            st["cid"] = next(coll_cid)
            launch_round(j, gkey, st, t)

        def launch_round(j: int, gkey: tuple, st: dict, t: float) -> None:
            nonlocal shares_dirty
            flows, vol = st["rounds"][st["ri"]]
            st["out"] = len(flows)
            for s, d in flows:
                gname = f"j{j}/coll{st['cid']}:{s}>{d}"
                key = (base[j] + s, gname)
                op = Op(name="collflow", res=gname, size=vol)
                lop = LiveOp(uid=next(uid_counter), template=op,
                             worker=base[j] + s, step_seq=0,
                             remaining_deps=0, remaining_work=vol)
                chunk = Chunk(op=lop, remaining=vol, is_last=True)
                chunk.seq = next(start_seq)
                running[key] = chunk
                conn_mtime[key] = t
                conn_rate[key] = 0.0
                conn_epoch[key] = conn_epoch.get(key, 0) + 1
                iwf.add(key)
                needs_proj.add(key)
                shares_dirty = True
                coll_of[key] = gkey

        def coll_flow_done(key: Tuple[int, str], t: float) -> None:
            nonlocal shares_dirty
            gkey = coll_of.pop(key)
            st = coll_groups[gkey]
            iwf.remove(key)
            shares_dirty = True
            conn_epoch[key] += 1
            conn_rate.pop(key, None)
            conn_mtime.pop(key, None)
            st["out"] -= 1
            if st["out"] == 0:
                j = gkey[0]
                st["ri"] += 1
                if st["ri"] < len(st["rounds"]):
                    launch_round(j, gkey, st, t)
                else:
                    finish_collective(j, st, t)

        def finish_collective(j: int, st: dict, t: float) -> None:
            st["state"] = "done"
            for lop in st["arrived"]:
                finish_coll_op(j, lop, t)

        def finish_coll_op(j: int, lop: LiveOp, t: float) -> None:
            gw = lop.worker
            if lop.start_time < 0:
                lop.start_time = t
            if jcfg[j].record_trace:
                traces[j].add(gw - base[j], "collective", lop.name,
                              lop.step_seq, lop.start_time, t)
            op_finished(gw, lop, t)

        # -- completion plumbing ----------------------------------------

        def op_finished(gw: int, lop: LiveOp, t: float) -> None:
            lop.end_time = t
            pending_ops[gw] -= 1
            for dep in lop.dependents:
                dep.remaining_deps -= 1
                if dep.remaining_deps == 0:
                    enqueue_op(dep, t)
            if pending_ops[gw] == 0:
                step_complete(gw, t)

        def step_complete(gw: int, t: float) -> None:
            j = jid[gw]
            lw = gw - base[j]
            completed[gw] += 1
            steps_done[j] += 1
            job_end[j] = t
            traces[j].complete_step(lw, completed[gw] - 1, t)
            lag, released = ctl[j].on_step_complete(lw, t)
            traces[j].staleness.append(lag)
            if schedules[j] is not None:
                dt_step = t - step_start_t[gw]
                if lag and ctl[j].drops_stale:
                    wasted_s[j] += dt_step
                else:
                    useful_s[j] += dt_step
            for rw in released:
                grw = base[j] + rw
                if grw not in down_workers and completed[grw] < spw[j]:
                    start_step(grw, t)

        def entry_valid(e: tuple) -> bool:
            kind = e[2]
            if kind == _K_CONN:
                return conn_epoch.get(e[3], -1) == e[4]
            if kind == _K_COMPUTE and fault_mode:
                return running.get(e[3]) is e[4]
            return True

        # -- faults ------------------------------------------------------

        def set_link_scale(j: int, lname: str, factor: float) -> None:
            nonlocal shares_dirty
            iwf.set_scale(("link", gres[j][lname]), factor)
            shares_dirty = True

        def kill_worker(gw: int, t: float) -> None:
            nonlocal shares_dirty
            j = jid[gw]
            c = jcfg[j]
            for r in c.resources:
                gname = gres[j][r]
                key = (gw, gname)
                running.pop(key, None)
                if is_link_g[gname]:
                    link = links[gname]
                    if gw in link.active:
                        link.active.discard(gw)
                        if record_contention:
                            contention.record(t, gname, len(link.active))
                        shares_dirty = True
                        conn_epoch[key] = conn_epoch.get(key, 0) + 1
                        conn_rate.pop(key, None)
                        conn_mtime.pop(key, None)
                        needs_proj.discard(key)
                        iwf.remove(key)
                    scheds[key] = make_link_scheduler(c.link_policy, c.win)
                else:
                    scheds[key] = FifoScheduler()
            pending_ops[gw] = 0

        def fault_event(j: int, inc, is_down: bool, t: float) -> None:
            kind = inc.kind
            if kind in ("crash", "preempt"):
                lw = inc.target
                if lw >= jobs[j].num_workers:
                    return
                gw = base[j] + lw
                if is_down:
                    if gw in down_workers:
                        return
                    in_step = pending_ops[gw] > 0
                    if in_step:
                        wasted_s[j] += t - step_start_t[gw]
                        lost_steps[j] += 1
                    incarn[gw] += 1
                    down_workers.add(gw)
                    kill_worker(gw, t)
                    traces[j].incidents.append({
                        "kind": kind, "target": lw, "t_down": inc.t_down,
                        "t_up": inc.t_up,
                        "recovery": inc.t_up - inc.t_down,
                        "in_step": in_step})
                    released = ctl[j].on_worker_down(lw, in_step, t)
                else:
                    if gw not in down_workers:
                        return
                    down_workers.discard(gw)
                    k = jobs[j].faults.ckpt_interval_steps
                    floor = (completed[gw] // k) * k if k > 0 \
                        else completed[gw]
                    released = ctl[j].on_worker_up(lw, floor, t)
                    if completed[gw] < spw[j]:
                        start_step(gw, t)
                for rw in released:
                    grw = base[j] + rw
                    if grw not in down_workers and completed[grw] < spw[j]:
                        start_step(grw, t)
            elif kind == "ps_fail":
                for lname in shard_link_names(inc.target,
                                              jcfg[j].resources,
                                              jcfg[j].topology):
                    set_link_scale(j, lname, 0.0 if is_down else 1.0)
                if is_down:
                    traces[j].incidents.append({
                        "kind": kind, "target": inc.target,
                        "t_down": inc.t_down, "t_up": inc.t_up,
                        "recovery": inc.t_up - inc.t_down})
            else:   # degrade
                set_link_scale(j, inc.target,
                               inc.factor if is_down else 1.0)
                if is_down:
                    traces[j].incidents.append({
                        "kind": kind, "target": inc.target,
                        "t_down": inc.t_down, "t_up": inc.t_up,
                        "recovery": inc.t_up - inc.t_down,
                        "factor": inc.factor})

        def finalize_batch(t: float) -> None:
            nonlocal shares_dirty
            if not shares_dirty:
                return
            touched = iwf.flush()
            if needs_proj:
                touched |= needs_proj
                needs_proj.clear()
            for key in touched:
                chunk = running.get(key)
                if chunk is None:
                    continue
                r_old = conn_rate.get(key, 0.0)
                if r_old > 0.0:
                    chunk.remaining -= r_old * (t - conn_mtime[key])
                conn_mtime[key] = t
                r_new = cur_shares.get(key, 0.0) * B
                conn_rate[key] = r_new
                epoch = conn_epoch.get(key, 0) + 1
                conn_epoch[key] = epoch
                if r_new > 0.0:
                    rem = chunk.remaining
                    heapq.heappush(
                        calendar,
                        (t + (rem if rem > 0.0 else 0.0) / r_new,
                         next(cal_seq), _K_CONN, key, epoch))
            shares_dirty = False

        # ---- main loop ----
        t = 0.0
        for gw in range(num_gw):
            start_step(gw, t)
        finalize_batch(t)
        for j, sched in enumerate(schedules):
            if sched is None:
                continue
            for inc in sched.incidents:
                heapq.heappush(calendar, (inc.t_down, next(cal_seq),
                                          _K_FAULT, (j, inc), True))
                heapq.heappush(calendar, (inc.t_up, next(cal_seq),
                                          _K_FAULT, (j, inc), False))

        n_events = 0
        guard = 0
        max_ops = max(max(len(s.ops) for s in jsteps[j]) for j in range(J))
        max_events = 200 * sum(total) * max(1, max_ops)

        def all_done() -> bool:
            return all(steps_done[j] >= total[j] for j in range(J))

        while (running or rejoin_pending or down_workers) \
                and not all_done():
            guard += 1
            if guard > max_events:
                raise RuntimeError(
                    "fleet event-count guard tripped (livelock?)")

            while True:
                if not calendar:
                    raise RuntimeError(
                        "no progress possible: all rates zero")
                e = heapq.heappop(calendar)
                if entry_valid(e):
                    break
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

            if fault_mode:
                for e2 in batch:
                    if e2[2] == _K_FAULT:
                        fj, inc = e2[3]
                        fault_event(fj, inc, e2[4], t)

            for e2 in batch:
                if e2[2] != _K_REJOIN:
                    continue
                rejoin_pending -= 1
                lop = e2[3]
                if fault_mode and lop.gen != incarn[lop.worker]:
                    continue
                j = jid[lop.worker]
                gname = gres[j][lop.res]
                scheds[(lop.worker, gname)].add(lop)
                try_start_chunk(lop.worker, gname, t)

            completions: List[Tuple[int, Tuple[int, str], Chunk]] = []
            for e2 in batch:
                kind = e2[2]
                if kind == _K_COMPUTE:
                    if fault_mode and running.get(e2[3]) is not e2[4]:
                        continue
                    completions.append((e2[4].seq, e2[3], e2[4]))
                elif kind == _K_CONN:
                    key = e2[3]
                    chunk = running.get(key)
                    if chunk is None:
                        continue
                    completions.append((chunk.seq, key, chunk))
                    conn_epoch[key] += 1
                    conn_rate.pop(key, None)
                    conn_mtime.pop(key, None)
            completions.sort()
            n_events += len(completions)

            for _cseq, key, chunk in completions:
                del running[key]
                gw, gname = key
                j = jid[gw]
                n_events_j[j] += 1
                if key in coll_of:
                    coll_flow_done(key, t)
                    continue
                lop = chunk.op
                lw = gw - base[j]
                if jcfg[j].record_trace:
                    traces[j].add(lw, lop.res, lop.name, lop.step_seq,
                                  lop.start_time, t)
                if not chunk.is_last:
                    if stall[j] > 0.0:
                        rejoin_pending += 1
                        heapq.heappush(calendar,
                                       (t + stall[j], next(cal_seq),
                                        _K_REJOIN, lop, None))
                    else:
                        scheds[key].add(lop)
                if chunk.is_last:
                    op_finished(gw, lop, t)
                if key not in running:
                    nxt = scheds[key].remove_chunk()
                    if nxt is not None:
                        begin_chunk(key, nxt, t)
                    elif is_link_g[gname]:
                        link = links[gname]
                        link.active.discard(gw)
                        if record_contention:
                            contention.record(t, gname, len(link.active))
                        shares_dirty = True
                        iwf.remove(key)

            finalize_batch(t)

        out: Dict[str, Trace] = {}
        for j, job in enumerate(jobs):
            tr = traces[j]
            tr.meta = {
                "num_workers": job.num_workers,
                "steps_per_worker": spw[j],
                "sim_end_time": job_end[j],
                "num_events": n_events_j[j],
                "sync_mode": job.sync_mode,
                "num_versions": ctl[j].version,
                "barrier_commits": list(ctl[j].commits),
                "engine": "fleet-merged",
            }
            if schedules[j] is not None:
                tr.meta.update(useful_work_s=useful_s[j],
                               wasted_s=wasted_s[j],
                               wasted_work_s=wasted_s[j],
                               lost_steps=lost_steps[j],
                               num_incidents=len(tr.incidents))
            out[job.name] = tr
        meta: Dict[str, object] = {
            "engine": "fleet-merged",
            "num_jobs": J,
            "sim_end_time": t,
            "num_events": n_events,
            "waterfill": dict(iwf.stats),
        }
        if record_contention:
            meta["contention"] = contention.fold()
        if obs_metrics.enabled():
            wf = iwf.metrics_snapshot()
            obs_metrics.merge_run("fleet.waterfill", wf)
            meta["metrics"] = {"waterfill": wf}
        return FleetTrace(jobs=out, meta=meta)


def interference_report(cfg: FleetConfig,
                        steps_by_job: Mapping[str, Sequence[StepTemplate]],
                        window: str = "common") -> Dict[str, object]:
    """Run the fleet contended and each job alone (same merged engine,
    same fabric) and report per-job interference:

      * ``throughput`` / ``alone`` — examples/s contended vs. run-alone;
      * ``slowdown`` — alone / contended (>= 1 under pure contention);
      * ``normalized`` — contended / alone, the share of its run-alone
        performance the job keeps;
      * ``jain`` — Jain fairness index over the normalized throughputs.

    The run-alone baseline uses ``merged=True`` so both sides share the
    waterfill arithmetic — adding a contender can then only remove
    bandwidth, which is the monotonicity gate in ``fig_fleet``."""
    sim = FleetSimulation(cfg)
    fleet = sim.run(steps_by_job, merged=True)
    tput = fleet.throughputs(cfg, window=window)
    report: Dict[str, object] = {"jobs": {}, "fleet": fleet}
    normalized = []
    for job in cfg.jobs:
        alone = sim.run_alone(job.name, steps_by_job, merged=True)
        t_alone = alone.jobs[job.name].throughput(
            job.batch_size, warmup_steps=job.warmup_steps, window=window)
        t_fleet = tput[job.name]
        norm = t_fleet / t_alone if t_alone > 0 else 1.0
        normalized.append(norm)
        report["jobs"][job.name] = {
            "throughput": t_fleet,
            "alone": t_alone,
            "slowdown": t_alone / t_fleet if t_fleet > 0 else math.inf,
            "normalized": norm,
        }
    report["jain"] = jain_index(normalized)
    return report
