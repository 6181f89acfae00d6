"""Run one cell of ``BENCHMARK.json`` once on this machine's card(s):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window. Either way the run checks the
program's first steps against the plain reference and prints each number
compared beside its limit, last on standard error and under ``check`` in
the result, the JSON line printed last on standard output. A machine
without the card(s) the cell asks for gets no result and exit code 2.
"""
import time

STARTED = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own kernels build into build/ beside src/)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import repro_torch  # noqa: F401  (the system under test must be here)
    import torch

    from portbench import harness, spec
    started = min(STARTED, harness.process_start())
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", started=started)
    return harness.emit(result)


if __name__ == "__main__":
    sys.exit(main())
