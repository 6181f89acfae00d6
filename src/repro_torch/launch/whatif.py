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
CLI does no tensor work.  The reference's ``--ps-cluster`` and ``--fleet``
modes and its ledger records are not ported yet (ROADMAP 1.16, 1.18).
"""
from __future__ import annotations

import argparse
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
    return ap


def main(argv=None) -> None:
    ap = build_argparser()
    args = ap.parse_args(argv)
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
