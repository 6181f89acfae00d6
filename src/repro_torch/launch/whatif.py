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
GPU mode writes none.  ``--calibrate`` and ``--optimize-placement`` are
ROADMAP 1.18b, ``--fleet`` and ``--scale-job`` ROADMAP 1.18a: they raise.
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
    # multi-tenant fleet mode (ROADMAP 1.18a)
    ap.add_argument("--fleet", metavar="JOBS_JSON", default=None,
                    help="fleet job-spec json (not ported yet: ROADMAP "
                         "1.18a)")
    ap.add_argument("--scale-job", metavar="NAME:K", default=None,
                    help="fleet what-if: job NAME with K times its "
                         "workers (not ported yet: ROADMAP 1.18a)")
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
                         "per-link rate counters)")
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
    if args.fleet:
        raise _unported("--fleet", "1.18a")
    if args.calibrate:
        raise _unported("--calibrate", "1.18b")
    if args.optimize_placement:
        raise _unported("--optimize-placement", "1.18b")

    # run ledger: what-if runs append to build/ledger.jsonl when launched
    # from the repo root (REPRO_LEDGER still overrides; =0 disables)
    from repro_torch.obs import ledger
    if os.path.isdir(os.path.join("src", "repro_torch")):
        ledger.enable(LEDGER_PATH)

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
