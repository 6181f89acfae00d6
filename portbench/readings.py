"""The readings a cell's limits are set from, on the card at the cell's own
size (the benchmark's own runs never run this):

    python3 portbench/readings.py --workload <cell> --seeds N [N ...] \
        [--control N [N ...]] [--out FILE]

For each of ``--seeds`` the program's sound run (its set-up steps, as a
benchmark run reads them) against the reference; for each of
``--control`` seeds also the control, the reference computed with fp8
weight products, and the fault of half of each batch left out (the mean
over the rest), each put in the program's place and held against the
reference. A state left unchanged reads 1 by construction and needs no
run. One JSON line a reading goes to ``--out`` and standard output.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench import check, harness, reference, spec
    from portbench.reference.model import Precision
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    t = cell.traffic
    hp, rows = harness.hyper(t), t["reference_rows"]
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, got, want, seconds):
        nums = check.numbers(got, want)
        line = json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                           "seconds": seconds, **nums,
                           "losses": got["losses"],
                           "ref_losses": want["losses"]})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in sorted(set(args.seeds) | set(args.control)):
        t0 = time.perf_counter()
        prog, got, batches, _, _ = harness.setup(cell, seed, "cuda")
        peak = torch.cuda.max_memory_allocated()
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        prog_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = reference.follow(cell.config["model"], seed, batches, hp,
                                "cuda", rows=rows)
        ref_s = time.perf_counter() - t0
        print(f"seed {seed}: program {prog_s:.1f} s (peak "
              f"{peak / 1e9:.2f} GB), reference {ref_s:.1f} s", flush=True)
        if seed in args.seeds:
            emit("program", seed, got, want, ref_s)
        if seed not in args.control:
            continue
        for kind, kw in (("control_fp8", {"prec": Precision(fp8=True)}),
                         ("fault_half_batch",
                          {"keep_rows": t["batch"] // 2})):
            t0 = time.perf_counter()
            other = reference.follow(cell.config["model"], seed, batches,
                                     hp, "cuda", rows=rows, **kw)
            emit(kind, seed, other, want, time.perf_counter() - t0)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
