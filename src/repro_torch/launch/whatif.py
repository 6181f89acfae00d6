"""What-if analysis on GPUs: the paper's technique as a deployment tool.

The paper's use-case (§1, §6 [10]) is letting a scheduler predict
throughput for configurations it never ran.  The port's counterpart of
the TPU mode of ``repro.launch.whatif`` and ``examples/predict_scaling.py``
replays the GPU step DAG (``core/gpu_adapter.py``) in the DES:

    python -m repro_torch.launch.whatif --arch gemma-7b --nodes 1 2 4

prints one row per node count of ``--gpus-per-node`` GPUs:

  * step: the predicted step time (per-layer FSDP all-gather and
    reduce-scatter over NVLink, an all-reduce over the inter-node network
    between nodes), and the throughput per GPU relative to the first row;
  * straggler: one worker's compute slowed by ``--straggler`` — the DES
    shows how much of it the collective overlap hides;
  * compressed: inter-node bytes scaled by ``--compress`` (int8 = 0.25 of
    fp32);
  * one column per ``--win`` chunk size: the paper's HTTP/2 WIN model
    mapped to chunked collectives, which interleave with compute earlier
    at the cost of per-chunk latency.

``--mfu`` is the sustained fraction of the tensor-core peak; a FLOP count
and a measured step on the card give it (``chip_smoke.py`` phase 6).  The
CLI does no tensor work.

PS-cluster mode (``--ps-cluster``), the reference's own: profile one worker
against the PS shards in the cluster emulator once, then predict
throughput under cluster structures the paper never ran — oversubscribed
rack fabrics, heterogeneous PS NICs, PS colocated with worker 0:

    PYTHONPATH=src python -m repro_torch.launch.whatif --ps-cluster \
        --dnn alexnet --batch 8 --workers 1 2 4 8 \
        --num-ps 2 --oversub 4 --ps-nic 2.0 --colocate-ps

  * ``--straggler-worker 1.5`` slows worker 0's compute by the factor
    (via ``Node.speed``) and adds a predicted-degradation column;
  * ``--sync-mode {async,sync,ssp,allreduce}`` with ``--backup-workers``
    (sync: k-of-n barrier), ``--staleness-bound`` (ssp) and
    ``--allreduce-algo {ring,tree}``; every non-async run also reports
    the predicted staleness distribution (mean/p99 version lag);
  * ``--mttf``/``--mttr``/``--preempt-rate``/``--degrade-*`` add a
    failure/churn table (``repro_torch.core.faults``);
  * ``--export-trace OUT.json`` writes one seeded DES run as a Chrome
    trace (``repro_torch.obs.trace_export``).

Its lines are the reference's, character for character.  Run from the repo
root, the mode appends a ``whatif_ps`` record to ``build/ledger.jsonl``
(``REPRO_LEDGER=<path>`` overrides, ``REPRO_LEDGER=0`` turns it off); the
GPU mode writes none.

Fleet mode (``--fleet jobs.json``), the reference's own: several
concurrent jobs on one shared topology, run through the merged fleet
engine (``repro_torch.core.fleet``):

    PYTHONPATH=src python -m repro_torch.launch.whatif \
        --fleet examples/fleet.json --scale-job A:3

reports each job's contended throughput, its run-alone baseline on the
same fabric, the slowdown, and the Jain fairness index over normalized
throughputs.  ``--scale-job NAME:K`` then asks what happens to *everyone's*
throughput if job NAME multiplies its worker count by K (cloned machines
in the same racks, rack uplinks pinned).  ``--export-trace`` writes the
contended fleet's per-job steps and contention counters.  Its lines are
the reference's too, and it writes no ledger record.

``--calibrate`` and ``--optimize-placement`` are ROADMAP 1.18b: they
raise.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Sequence, Tuple

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core.gpu_adapter import (MeshFactors, build_step_dag,
                                          predict_step_time)
from repro_torch.core.sweep import parallel_map

DEFAULT_WINS = (64e6, 16e6, 4e6)


def _nodes_task(args: tuple) -> tuple:
    """One node count's what-if predictions (fanned across cores)."""
    (arch, shape, nodes, gpus_per_node, straggler, compress, wins,
     mfu) = args
    cfg = get_config(arch)
    sp = SHAPES[shape]
    mesh = MeshFactors(data=gpus_per_node, pods=nodes, mfu=mfu)
    tokens = sp.global_batch * sp.seq_len
    dag = build_step_dag(cfg, mesh, tokens)
    t = predict_step_time(dag, num_pods=nodes)
    t_st = predict_step_time(dag, num_pods=nodes,
                             straggler_factor=straggler) \
        if straggler != 1.0 else t
    if compress != 1.0 and nodes > 1:
        dag_c = build_step_dag(cfg, mesh, tokens, compressed_dcn=compress)
        t_c = predict_step_time(dag_c, num_pods=nodes)
    else:
        t_c = t
    t_win = tuple(predict_step_time(dag, num_pods=nodes, win_bytes=w)
                  for w in wins)
    return (nodes, mesh.chips, t, t_st, t_c, t_win)


def node_table(arch: str, shape: str, nodes: Sequence[int],
               gpus_per_node: int = 8, straggler: float = 1.3,
               compress: float = 0.25, wins: Sequence[float] = DEFAULT_WINS,
               mfu: float = 0.5) -> List[Tuple]:
    """``(nodes, gpus, step, rel_tput, straggler, compressed, (win...))``
    for each node count, times in seconds; ``rel_tput`` is the throughput
    per GPU relative to the first node count."""
    tasks = [(arch, shape, n, gpus_per_node, straggler, compress,
              tuple(wins), mfu) for n in nodes]
    rows, base = [], None
    for n, gpus, t, t_st, t_c, t_win in parallel_map(_nodes_task, tasks):
        if base is None:
            base = t * gpus
        rows.append((n, gpus, t, base / (t * gpus), t_st, t_c, t_win))
    return rows


def format_table(rows: Sequence[Tuple], straggler: float, compress: float,
                 wins: Sequence[float]) -> str:
    head = (f"{'nodes':>5s} {'gpus':>5s} {'step':>10s} {'rel_tput':>9s} "
            f"{f'strag{straggler:g}x':>11s} {f'comp{compress:g}':>10s}"
            + "".join(f" {f'win{w / 1e6:g}MB':>10s}" for w in wins))
    lines = [head]
    for n, gpus, t, rel, t_st, t_c, t_win in rows:
        lines.append(f"{n:5d} {gpus:5d} {t * 1e3:8.1f}ms {rel:8.3f}x "
                     f"{t_st * 1e3:9.1f}ms {t_c * 1e3:8.1f}ms"
                     + "".join(f" {x * 1e3:8.1f}ms" for x in t_win))
    return "\n".join(lines)


def build_whatif_topology(num_workers: int, num_ps: int,
                          oversub: float = 1.0, racks: int = 2,
                          ps_nic: float = 1.0,
                          colocate_ps: bool = False):
    """CLI knobs -> Topology.  Oversubscribed fabrics isolate the PS
    shards in rack r0 (workers fill the remaining racks); ``colocate_ps``
    moves shard 0 onto worker 0's node (the dedicated host for shard 0 is
    dropped entirely so its NIC doesn't inflate rack r0's uplink
    capacity)."""
    from repro_torch.core.topology import Node, Placement, Rack, Topology
    # with colocation, dedicated hosts exist only for shards 1..M-1
    dedicated = range(1 if colocate_ps else 0, num_ps)
    if oversub > 1.0 and colocate_ps and num_ps == 1:
        raise ValueError(
            "--oversub with --colocate-ps and --num-ps 1 leaves no PS "
            "behind the oversubscribed fabric (the only shard lives on "
            "worker 0): the ratio would be a silent no-op.  Use more "
            "shards or drop one of the flags.")
    if oversub > 1.0:
        rack_objs = tuple([Rack("r0", oversubscription=oversub)] +
                          [Rack(f"r{k}") for k in range(1, max(racks, 2))])
        nworker_racks = len(rack_objs) - 1
        workers = tuple(Node(f"w{i}", rack=f"r{1 + i % nworker_racks}")
                        for i in range(num_workers))
        ps_nodes = tuple(Node(f"ps{p}", nic=ps_nic, rack="r0")
                         for p in dedicated)
    else:
        rack_objs = ()
        workers = tuple(Node(f"w{i}") for i in range(num_workers))
        ps_nodes = tuple(Node(f"ps{p}", nic=ps_nic) for p in dedicated)
    placement = None
    if colocate_ps:
        placement = Placement(("w0",) + tuple(n.name for n in ps_nodes))
    return Topology(workers=workers, ps_nodes=ps_nodes, racks=rack_objs,
                    placement=placement)


def export_ps_trace(run, num_workers: int, path: str) -> None:
    """One representative seeded DES run of ``run`` at ``num_workers``
    workers, exported as Chrome trace-event JSON (per-worker compute /
    transmission tracks, dependency flow arrows, fault markers, per-link
    rate counter tracks).  Open the file in https://ui.perfetto.dev."""
    from repro_torch.core.simulator import Simulation
    from repro_torch.obs.trace_export import write_chrome_trace
    cfg, templates, W, _b, _w = run.prediction_tasks(num_workers, 1)[0]
    cfg.record_trace = True
    cfg.record_rates = True
    trace = Simulation(cfg).run(templates, W)
    doc = trace.to_chrome_trace(templates=templates)
    write_chrome_trace(doc, path)
    print(f"# exported Chrome trace -> {path} "
          f"({len(doc['traceEvents'])} events; open in ui.perfetto.dev)")


def ps_cluster_main(args) -> None:
    from repro_torch.core.predictor import PredictionRun
    from repro_torch.core.sweep import predict_many
    from repro_torch.core.topology import Topology

    wmax = max(args.workers)
    base = PredictionRun(dnn=args.dnn, batch_size=args.batch,
                         platform=args.cluster_platform, num_ps=args.num_ps,
                         profile_steps=args.profile_steps,
                         sim_steps=args.sim_steps,
                         sync_mode=args.sync_mode,
                         backup_workers=args.backup_workers,
                         staleness_bound=args.staleness_bound,
                         allreduce_algo=args.allreduce_algo,
                         waterfill=args.waterfill).prepare()
    topo = build_whatif_topology(wmax, args.num_ps, oversub=args.oversub,
                                 racks=args.racks, ps_nic=args.ps_nic,
                                 colocate_ps=args.colocate_ps)
    pred_star = predict_many(
        base.with_topology(Topology.star(wmax, args.num_ps)), args.workers)
    pred_topo = predict_many(base.with_topology(topo), args.workers)
    pred_strag = None
    if args.straggler_worker != 1.0:
        strag = topo.with_node_speed("w0", 1.0 / args.straggler_worker)
        pred_strag = predict_many(base.with_topology(strag), args.workers)
    print(f"# {args.dnn} bs={args.batch} on {args.cluster_platform}: "
          f"M={args.num_ps} oversub={args.oversub} ps_nic={args.ps_nic} "
          f"colocate={args.colocate_ps} sync={args.sync_mode}")
    head = f"{'W':>3s} {'star_ex/s':>10s} {'topo_ex/s':>10s} {'ratio':>6s}"
    if pred_strag is not None:
        head += f" {'strag_ex/s':>10s} {'degrade':>7s}"
    print(head)
    for w in args.workers:
        s, t = pred_star[w], pred_topo[w]
        line = f"{w:3d} {s:10.2f} {t:10.2f} {t / s if s else 0:6.2f}"
        if pred_strag is not None:
            g = pred_strag[w]
            line += f" {g:10.2f} {g / t if t else 0:7.2f}"
        print(line)
    if args.sync_mode != "async":
        # staleness is the other half of a synchronization what-if: how
        # far the regime lets gradients lag the parameters they update
        topo_run = base.with_topology(topo)
        for w in args.workers:
            st = topo_run.staleness_report(w)
            print(f"# staleness W={w}: mean={st['mean']:.2f} "
                  f"p50={st['p50']:.0f} p99={st['p99']:.0f} "
                  f"max={st['max']:.0f} versions={st['versions']}")
    fault_spec = None
    if args.mttf or args.preempt_rate or args.degrade_links:
        from dataclasses import replace

        from repro_torch.core.faults import FaultSpec
        spec = FaultSpec(mttf=args.mttf, mttr=args.mttr,
                         preempt_rate=args.preempt_rate,
                         preempt_downtime=args.mttr,
                         degrade_links=tuple(args.degrade_links),
                         degrade_factor=args.degrade_factor,
                         degrade_period=args.degrade_period,
                         degrade_duration=args.degrade_duration,
                         fault_seed=args.fault_seed)
        fault_spec = spec
        churn = replace(base.with_topology(topo), faults=spec)
        print(f"# failure/churn scenario: mttf={args.mttf} mttr={args.mttr} "
              f"preempt_rate={args.preempt_rate} "
              f"degrade={args.degrade_links or '-'} seed={args.fault_seed}")
        print(f"{'W':>3s} {'ex/s':>10s} {'goodput':>10s} {'incid':>6s} "
              f"{'recov_s':>8s} {'wasted%':>8s}")
        for w in args.workers:
            r = churn.robustness_report(w)
            print(f"{w:3d} {r['throughput']:10.2f} {r['goodput']:10.2f} "
                  f"{int(r['incidents']):6d} {r['mean_recovery_s']:8.2f} "
                  f"{100.0 * r['wasted_work_frac']:8.2f}")
    if args.export_trace:
        run_t = base.with_topology(topo)
        if fault_spec is not None:
            from dataclasses import replace as _replace
            run_t = _replace(run_t, faults=fault_spec)
        export_ps_trace(run_t, wmax, args.export_trace)
    from repro_torch.obs import ledger
    ledger.log("whatif", figure="whatif_ps",
               config={"dnn": args.dnn, "batch": args.batch,
                       "platform": args.cluster_platform,
                       "num_ps": args.num_ps, "oversub": args.oversub,
                       "ps_nic": args.ps_nic, "sync": args.sync_mode,
                       "workers": list(args.workers)},
               engine="scalar",
               extra={"predicted": [pred_topo[w] for w in args.workers]})


def _fleet_template(layers: int, seed: int, num_ps: int,
                    size_scale: float = 1.0, compute_scale: float = 1.0):
    """Synthetic PS-training-shaped step for a fleet job (the perf-bench
    template family): per layer download -> fwd, then reverse bwd ->
    upload, layers round-robin over the job's PS shards."""
    import random as _random

    from repro_torch.core.events import Op, StepTemplate
    rng = _random.Random(seed)

    def link(kind, i):
        return kind if num_ps == 1 else f"{kind}:{i % num_ps}"

    ops = []
    fwd_prev = None
    for i in range(layers):
        dl = len(ops)
        ops.append(Op(f"dl{i}", link("downlink", i),
                      size=size_scale * rng.uniform(2e6, 3e7)))
        deps = (dl,) if fwd_prev is None else (dl, fwd_prev)
        fwd_prev = len(ops)
        ops.append(Op(f"fwd{i}", "worker",
                      duration=compute_scale * rng.uniform(.005, .05),
                      deps=deps))
    bwd_prev = fwd_prev
    for i in reversed(range(layers)):
        bwd = len(ops)
        ops.append(Op(f"bwd{i}", "worker",
                      duration=compute_scale * rng.uniform(.01, .08),
                      deps=(bwd_prev,)))
        bwd_prev = bwd
        ops.append(Op(f"ul{i}", link("uplink", i),
                      size=size_scale * rng.uniform(2e6, 3e7), deps=(bwd,)))
    return StepTemplate(ops=ops)


def load_fleet(path: str):
    """Parse a fleet job-spec JSON into ``(FleetConfig, steps_by_job)``.

    Schema (see ``examples/fleet.json``): ``bandwidth`` (nominal NIC
    bytes/s), ``racks`` (name / oversubscription / uplink_capacity),
    ``nodes`` (name / rack / nic / speed; every machine of the cluster),
    ``jobs`` (FleetJob fields plus the synthetic-workload knobs
    ``layers`` / ``size_scale`` / ``compute_scale``)."""
    import json

    from repro_torch.core.fleet import FleetConfig, FleetJob
    from repro_torch.core.topology import Node, Placement, Rack, Topology
    with open(path) as f:
        spec = json.load(f)
    for req in ("bandwidth", "nodes", "jobs"):
        if req not in spec:
            raise ValueError(f"fleet spec {path!r} is missing {req!r}")
    racks = tuple(Rack(r["name"],
                       oversubscription=r.get("oversubscription", 1.0),
                       uplink_capacity=r.get("uplink_capacity"))
                  for r in spec.get("racks", ()))
    nodes = tuple(Node(n["name"], rack=n.get("rack"),
                       nic=n.get("nic", 1.0), speed=n.get("speed", 1.0))
                  for n in spec["nodes"])
    jobs, steps_by_job = [], {}
    known = {"name", "workers", "ps_hosts", "batch_size",
             "steps_per_worker", "warmup_steps", "seed", "sync_mode",
             "backup_workers", "staleness_bound", "allreduce_algo",
             "collective_k", "layers", "size_scale", "compute_scale"}
    for jspec in spec["jobs"]:
        unknown = set(jspec) - known
        if unknown:
            raise ValueError(
                f"fleet job {jspec.get('name', '?')!r}: unknown keys "
                f"{sorted(unknown)}")
        kw = {k: v for k, v in jspec.items()
              if k not in ("layers", "size_scale", "compute_scale")}
        kw["workers"] = tuple(kw.get("workers", ()))
        kw["ps_hosts"] = tuple(kw.get("ps_hosts", ()))
        job = FleetJob(**kw)
        jobs.append(job)
        num_ps = max(1, len(job.ps_hosts))
        if job.sync_mode == "allreduce":
            num_ps = 1      # PS links are rewritten into collective ops
        steps_by_job[job.name] = [
            _fleet_template(jspec.get("layers", 6),
                            seed=101 * job.seed + s, num_ps=num_ps,
                            size_scale=jspec.get("size_scale", 1.0),
                            compute_scale=jspec.get("compute_scale", 1.0))
            for s in range(3)]
    # the fleet Topology carries every machine as a worker-capable node;
    # jobs bind shards by name, so the fleet-level placement is only the
    # constructor's ps_nodes-or-placement requirement — point it anywhere
    topo = Topology(workers=nodes, racks=racks,
                    placement=Placement((nodes[0].name,)),
                    bandwidth=float(spec["bandwidth"]))
    return FleetConfig(topology=topo, jobs=tuple(jobs)), steps_by_job


def scale_fleet(cfg, name: str, k: int):
    """The ``--scale-job`` what-if: job ``name`` with K times its workers.

    New workers are cloned machines (same rack / NIC / speed) named
    ``<src>.x<i>``; rack uplink capacities are PINNED to the original
    fleet's values first, so added NICs don't silently widen an
    oversubscribed fabric."""
    from dataclasses import replace

    from repro_torch.core.fleet import FleetConfig
    from repro_torch.core.topology import Rack, Topology
    if k < 1:
        raise ValueError(f"scale factor must be >= 1, got {k}")
    j = cfg.job_index(name)
    job = cfg.jobs[j]
    if k == 1:
        return cfg
    topo = cfg.topology
    caps = topo.rack_uplink_caps()
    racks = tuple(Rack(r.name, uplink_capacity=caps[r.name][0])
                  if r.name in caps else r for r in topo.racks)
    w0 = len(job.workers)
    clones, clone_names = [], []
    for i in range(w0 * (k - 1)):
        src = topo.node(job.workers[i % w0])
        clone = replace(src, name=f"{src.name}.x{i}")
        clones.append(clone)
        clone_names.append(clone.name)
    topo2 = Topology(workers=topo.workers + tuple(clones),
                     ps_nodes=topo.ps_nodes, racks=racks,
                     placement=topo.placement, bandwidth=topo.bandwidth,
                     loopback_bypass=topo.loopback_bypass,
                     loopback_capacity=topo.loopback_capacity)
    jobs = list(cfg.jobs)
    jobs[j] = replace(job, workers=job.workers + tuple(clone_names))
    return FleetConfig(topology=topo2, jobs=tuple(jobs),
                       record_contention=cfg.record_contention)


def fleet_main(args) -> None:
    from repro_torch.core.fleet import FleetConfig, jain_index
    from repro_torch.core.sweep import simulate_fleets
    cfg, steps = load_fleet(args.fleet)
    scaled_cfg = None
    if args.scale_job:
        sname, _, sk = args.scale_job.rpartition(":")
        if not sname or not sk.isdigit():
            raise SystemExit(
                f"--scale-job expects NAME:K, got {args.scale_job!r}")
        scaled_cfg = scale_fleet(cfg, sname, int(sk))

    def alone(c, j):
        return FleetConfig(topology=c.topology, jobs=(c.jobs[j],),
                           record_contention=c.record_contention)

    # one parallel sweep over every fleet run this report needs:
    # contended + per-job run-alone baselines, for the base fleet and
    # (when --scale-job) the scaled fleet
    tasks = [(cfg, steps, True)]
    tasks += [(alone(cfg, j), {job.name: steps[job.name]}, True)
              for j, job in enumerate(cfg.jobs)]
    if scaled_cfg is not None:
        tasks.append((scaled_cfg, steps, True))
        tasks += [(alone(scaled_cfg, j), {job.name: steps[job.name]}, True)
                  for j, job in enumerate(scaled_cfg.jobs)]
    traces = simulate_fleets(tasks)

    def report(c, contended, alones):
        tput = contended.throughputs(c)
        rows, norm = {}, []
        for j, job in enumerate(c.jobs):
            a = alones[j].throughputs(alone(c, j))[job.name]
            t = tput[job.name]
            share = t / a if a else 0.0
            norm.append(share)
            rows[job.name] = (job.num_workers, t, a,
                              a / t if t else float("inf"), share)
        return rows, jain_index(norm)

    n = len(cfg.jobs)
    rows, jain = report(cfg, traces[0], traces[1:1 + n])
    print(f"# fleet {args.fleet}: {n} jobs on "
          f"{len(cfg.topology.workers)} nodes, "
          f"bw={cfg.topology.bandwidth:.3g} B/s")
    print(f"{'job':>8s} {'W':>3s} {'ex/s':>10s} {'alone':>10s} "
          f"{'slowdown':>8s} {'share':>6s}")
    for name, (w, t, a, slow, share) in rows.items():
        print(f"{name:>8s} {w:3d} {t:10.2f} {a:10.2f} "
              f"{slow:8.2f} {share:6.3f}")
    print(f"# jain fairness index = {jain:.4f}")
    if scaled_cfg is not None:
        m = len(scaled_cfg.jobs)
        srows, sjain = report(scaled_cfg, traces[1 + n],
                              traces[2 + n:2 + n + m])
        sname = args.scale_job.rpartition(":")[0]
        w_old = rows[sname][0]
        w_new = srows[sname][0]
        print(f"# what-if: job {sname} at {w_new // w_old}x workers "
              f"({w_old} -> {w_new})")
        print(f"{'job':>8s} {'W':>3s} {'ex/s':>10s} {'was':>10s} "
              f"{'delta%':>7s} {'share':>6s}")
        for name, (w, t, a, slow, share) in srows.items():
            was = rows[name][1]
            delta = 100.0 * (t - was) / was if was else 0.0
            print(f"{name:>8s} {w:3d} {t:10.2f} {was:10.2f} "
                  f"{delta:+7.1f} {share:6.3f}")
        print(f"# jain fairness index = {sjain:.4f} (was {jain:.4f})")
    if args.export_trace:
        # rerun the contended fleet with contention timelines on; the
        # counter tracks come from the same LinkTimeline machinery that
        # feeds meta["contention"] (fig_fleet's timelines)
        from repro_torch.core.fleet import FleetSimulation
        from repro_torch.obs.trace_export import (fleet_to_chrome_trace,
                                            write_chrome_trace)
        ccfg = FleetConfig(topology=cfg.topology, jobs=cfg.jobs,
                           record_contention=True)
        ftr = FleetSimulation(ccfg).run(steps, merged=True)
        doc = fleet_to_chrome_trace(ftr)
        write_chrome_trace(doc, args.export_trace)
        print(f"# exported Chrome trace -> {args.export_trace} "
              f"({len(doc['traceEvents'])} events; open in ui.perfetto.dev)")


def _unported(flag: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"whatif {flag} is not ported yet: ROADMAP "
                               f"{item}")


# the run ledger's file when the what-if runs from the repo root
LEDGER_PATH = os.path.join("build", "ledger.jsonl")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="DES-predicted GPU training step time over node counts")
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-7b")
    ap.add_argument("--shape", choices=[s for s, sp in SHAPES.items()
                                        if sp.kind == "train"],
                    default="train_4k")
    ap.add_argument("--nodes", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--gpus-per-node", type=int, default=8)
    ap.add_argument("--straggler", type=float, default=1.3,
                    help="compute slowdown of one worker (1.3 = 30%% slower)")
    ap.add_argument("--compress", type=float, default=0.25,
                    help="inter-node byte multiplier (int8 = 0.25 of fp32)")
    ap.add_argument("--win", type=float, nargs="*", default=list(DEFAULT_WINS),
                    help="collective chunk bytes, one column each")
    ap.add_argument("--mfu", type=float, default=0.5,
                    help="sustained fraction of the bf16 tensor-core peak")
    # PS-cluster topology mode
    ap.add_argument("--ps-cluster", action="store_true",
                    help="PS-training what-if over cluster topologies "
                         "instead of the GPU step DAG")
    # multi-tenant fleet mode (repro_torch.core.fleet)
    ap.add_argument("--fleet", metavar="JOBS_JSON", default=None,
                    help="fleet job-spec json: concurrent jobs on one "
                         "shared topology through the merged fleet engine "
                         "(see examples/fleet.json)")
    ap.add_argument("--scale-job", metavar="NAME:K", default=None,
                    help="fleet what-if: job NAME with K times its "
                         "workers (cloned machines, rack uplinks pinned) "
                         "— reports everyone's throughput delta")
    ap.add_argument("--dnn", default="alexnet")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cluster-platform", default="private_cpu")
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--num-ps", type=int, default=1)
    ap.add_argument("--oversub", type=float, default=1.0,
                    help="rack-uplink oversubscription ratio (>1 isolates "
                         "the PS shards behind one rack fabric)")
    ap.add_argument("--racks", type=int, default=2)
    ap.add_argument("--ps-nic", type=float, default=1.0,
                    help="PS NIC capacity in multiples of the nominal")
    ap.add_argument("--colocate-ps", action="store_true",
                    help="place PS shard 0 on worker 0's node")
    ap.add_argument("--straggler-worker", type=float, default=1.0,
                    help="slow worker 0's compute by this factor "
                         "(1.5 = 50%% slower; PS-cluster mode)")
    ap.add_argument("--sync-mode", default="async",
                    choices=["async", "sync", "ssp", "allreduce"],
                    help="synchronization regime of the predicted job "
                         "(PS-cluster mode; default: the paper's async)")
    ap.add_argument("--backup-workers", type=int, default=0,
                    help="sync mode: barrier commits after W-k gradient "
                         "arrivals, dropping the k slowest (k-of-n barrier)")
    ap.add_argument("--staleness-bound", type=int, default=0,
                    help="ssp mode: max iteration lead over the slowest "
                         "worker (0 = full sync)")
    ap.add_argument("--allreduce-algo", default="ring",
                    choices=["ring", "tree"],
                    help="allreduce mode: collective algorithm")
    ap.add_argument("--optimize-placement", nargs="?", const="greedy",
                    default=None,
                    choices=["greedy", "exhaustive", "anneal"],
                    help="search PS shard placements (not ported yet: "
                         "ROADMAP 1.18b)")
    # failure / churn what-ifs (repro_torch.core.faults; PS-cluster mode)
    ap.add_argument("--mttf", type=float, default=0.0,
                    help="mean time to failure per worker in simulated "
                         "seconds (0 = no crashes; PS-cluster mode)")
    ap.add_argument("--mttr", type=float, default=0.0,
                    help="mean repair time per crash/preemption; every "
                         "restart also pays the checkpoint-restore cost")
    ap.add_argument("--preempt-rate", type=float, default=0.0,
                    help="spot preemptions per second per worker")
    ap.add_argument("--degrade-links", nargs="+", default=[],
                    metavar="LINK",
                    help="links with stochastic capacity-degradation "
                         "epochs (e.g. uplink or uplink:0)")
    ap.add_argument("--degrade-factor", type=float, default=0.5,
                    help="capacity multiplier during a degraded epoch")
    ap.add_argument("--degrade-period", type=float, default=60.0,
                    help="mean healthy gap between degraded epochs (s)")
    ap.add_argument("--degrade-duration", type=float, default=15.0,
                    help="mean length of a degraded epoch (s)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the dedicated fault-schedule RNG "
                         "(the simulation RNG is never touched)")
    ap.add_argument("--export-trace", metavar="OUT_JSON", default=None,
                    help="write a Chrome trace-event JSON (open in "
                         "https://ui.perfetto.dev): PS-cluster mode "
                         "exports one seeded DES run at the largest "
                         "worker count (per-worker compute/transmission "
                         "tracks, dependency flow arrows, fault markers, "
                         "per-link rate counters); fleet mode exports "
                         "per-job step timelines plus the shared fabric's "
                         "contention counters")
    ap.add_argument("--calibrate", metavar="TRACES", default=None,
                    help="closed-loop mode from a recorded-step trace "
                         "corpus (not ported yet: ROADMAP 1.18b)")
    ap.add_argument("--profile-steps", type=int, default=30)
    ap.add_argument("--sim-steps", type=int, default=250)
    ap.add_argument("--waterfill", default="auto",
                    choices=["auto", "incremental", "batch"],
                    help="general-path bandwidth re-solves: group-local "
                         "incremental (default) or the historical full "
                         "re-waterfill per membership change (identical "
                         "shares; a perf A/B and differential baseline)")
    return ap


def check_args(ap: argparse.ArgumentParser, args) -> None:
    """The reference's checks of the mode flags against each other."""
    if args.fleet and args.ps_cluster:
        ap.error("--fleet and --ps-cluster are different analysis modes "
                 "(a fleet spec carries its jobs' workloads in the json)")
    if args.scale_job and not args.fleet:
        ap.error("--scale-job scales a job of a fleet spec "
                 "(requires --fleet)")
    if args.straggler_worker < 1.0:
        ap.error(f"--straggler-worker is a slowdown factor and must be "
                 f">= 1, got {args.straggler_worker}")
    if args.export_trace and not (args.ps_cluster or args.fleet):
        ap.error("--export-trace requires --ps-cluster or --fleet (the "
                 "GPU step DAG is analytic — there is no DES trace to "
                 "export)")
    if not args.ps_cluster:
        # PS-cluster-only knobs must not be silently ignored in GPU mode
        # (--straggler-worker is easy to confuse with GPU-mode --straggler)
        if args.optimize_placement:
            ap.error("--optimize-placement requires --ps-cluster")
        if args.straggler_worker != 1.0:
            ap.error("--straggler-worker requires --ps-cluster "
                     "(GPU mode uses --straggler)")
        if args.sync_mode != "async" or args.backup_workers \
                or args.staleness_bound:
            ap.error("--sync-mode/--backup-workers/--staleness-bound "
                     "require --ps-cluster (GPU mode models all-reduce "
                     "natively via the collective ops)")
        if args.mttf or args.mttr or args.preempt_rate or args.degrade_links:
            ap.error("--mttf/--mttr/--preempt-rate/--degrade-links require "
                     "--ps-cluster (fault injection runs in the PS DES)")
        if args.calibrate:
            ap.error("--calibrate requires --ps-cluster (trace-fitted "
                     "profiles apply to the PS prediction pipeline)")
    if args.backup_workers and args.sync_mode != "sync":
        ap.error("--backup-workers only relaxes the sync-mode barrier "
                 "(use --sync-mode sync)")
    if args.staleness_bound and args.sync_mode != "ssp":
        ap.error("--staleness-bound only applies to --sync-mode ssp")
    if args.optimize_placement and args.sync_mode == "allreduce":
        ap.error("--optimize-placement searches PS shard placements; "
                 "the allreduce regime has no parameter servers")


def main(argv=None) -> None:
    ap = build_argparser()
    args = ap.parse_args(argv)
    check_args(ap, args)
    if args.calibrate:
        raise _unported("--calibrate", "1.18b")
    if args.optimize_placement:
        raise _unported("--optimize-placement", "1.18b")

    # run ledger: what-if runs append to build/ledger.jsonl when launched
    # from the repo root (REPRO_LEDGER still overrides; =0 disables)
    from repro_torch.obs import ledger
    if os.path.isdir(os.path.join("src", "repro_torch")):
        ledger.enable(LEDGER_PATH)

    if args.fleet:
        fleet_main(args)
        return
    if args.ps_cluster:
        ps_cluster_main(args)
        return
    if min(args.nodes) < 1 or args.gpus_per_node < 1:
        ap.error("--nodes and --gpus-per-node must be >= 1")
    if args.straggler < 1.0:
        ap.error(f"--straggler is a slowdown factor and must be >= 1, got "
                 f"{args.straggler}")
    if not 0.0 < args.mfu <= 1.0:
        ap.error(f"--mfu must be in (0, 1], got {args.mfu}")
    sp = SHAPES[args.shape]
    print(f"{args.arch} {args.shape} (seq {sp.seq_len} x batch "
          f"{sp.global_batch}), {args.gpus_per_node} GPUs a node, mfu "
          f"{args.mfu:g}: DES-predicted step time")
    rows = node_table(args.arch, args.shape, args.nodes, args.gpus_per_node,
                      args.straggler, args.compress, args.win, args.mfu)
    print(format_table(rows, args.straggler, args.compress, args.win))


if __name__ == "__main__":
    main()
