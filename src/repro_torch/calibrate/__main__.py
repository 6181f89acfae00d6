"""CLI for the calibration subsystem (the reference's ``python -m
repro.calibrate``: the same lines and exit codes).

    # fit a profile from a trace corpus (file or directory of *.json)
    PYTHONPATH=src python -m repro_torch.calibrate fit traces/ -o profile.json

    # inspect a fitted profile
    PYTHONPATH=src python -m repro_torch.calibrate show profile.json

    # compare two profiles (exit 1 when any shared parameter moved
    # beyond --gate, relative) — the parameter-space view of the
    # ledger's error-space drift gate
    PYTHONPATH=src python -m repro_torch.calibrate check new.json old.json
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

from .extract import extract_runs, load_trace_runs
from .fit import CalibrationProfile, fit_profile


def _cmd_fit(args) -> int:
    runs = load_trace_runs(args.traces)
    samples = extract_runs(runs)
    prior = win = None
    if args.platform:
        # seed the capacity/parse-rate split with the platform's
        # probe-fitted overhead model (the paper's §4.1 calibration)
        from repro_torch.core.paper_models import PLATFORMS
        from repro_torch.core.predictor import calibrate_overhead
        plat = PLATFORMS[args.platform]
        prior = calibrate_overhead(plat)
        win = plat.win_mu
    prof = fit_profile(samples, prior_overhead=prior,
                       win_hint=args.win or win)
    prof.provenance["traces"] = args.traces
    if args.out:
        prof.save(args.out)
        print(f"wrote {args.out} (digest {prof.digest}, "
              f"{samples.steps} steps)")
    else:
        _show(prof)
    return 0


def _show(prof: CalibrationProfile) -> None:
    print(f"CalibrationProfile v{prof.version}  digest {prof.digest}")
    for name, cap in sorted(prof.link_capacity.items()):
        print(f"  link {name:>12s}  {cap / 1e6:10.2f} MB/s")
    if prof.overhead_alpha is not None:
        print(f"  overhead  alpha {prof.overhead_alpha:.3e} s/B  "
              f"beta {prof.overhead_beta:.3e} s")
    if prof.residual_overhead_s:
        print(f"  residual  {prof.residual_overhead_s:.3e} s/step")
    for name, t in sorted(prof.op_times.items()):
        print(f"  op   {name:>12s}  {t * 1e3:10.4f} ms")
    if prof.sample_counts:
        print(f"  samples   {prof.sample_counts}")


def _cmd_show(args) -> int:
    _show(CalibrationProfile.load(args.profile))
    return 0


def _param_drifts(new: CalibrationProfile, old: CalibrationProfile
                  ) -> List[Tuple[str, float, float, float]]:
    """(name, old, new, relative drift) over every shared parameter."""
    out = []
    pairs = [(f"op:{n}", old.op_times.get(n), new.op_times.get(n))
             for n in sorted(set(old.op_times) & set(new.op_times))]
    pairs += [(f"link:{n}", old.link_capacity.get(n),
               new.link_capacity.get(n))
              for n in sorted(set(old.link_capacity)
                              & set(new.link_capacity))]
    pairs += [("overhead_alpha", old.overhead_alpha, new.overhead_alpha),
              ("overhead_beta", old.overhead_beta, new.overhead_beta)]
    for name, a, b in pairs:
        if a is None or b is None or a == 0:
            continue
        out.append((name, a, b, abs(b - a) / abs(a)))
    return out


def _cmd_check(args) -> int:
    new = CalibrationProfile.load(args.new)
    old = CalibrationProfile.load(args.old)
    drifted = False
    for name, a, b, rel in _param_drifts(new, old):
        flag = ""
        if rel > args.gate:
            drifted = True
            flag = "  << DRIFT"
        print(f"{name:>20s}  {a:.6g} -> {b:.6g}  ({rel * 100:+.2f}%){flag}")
    print(f"# verdict: {'DRIFT' if drifted else 'OK'} "
          f"(gate {args.gate * 100:.1f}%)")
    return 1 if drifted else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.calibrate",
        description="fit / inspect / compare calibration profiles")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("fit", help="fit a profile from a trace corpus")
    p.add_argument("traces", help="trace .json file, or directory of them")
    p.add_argument("-o", "--out", help="write profile JSON here "
                                       "(default: print)")
    p.add_argument("--win", type=float, default=None,
                   help="flow-control window (bytes): overhead samples "
                        "only use streams at or below it")
    p.add_argument("--platform", default=None,
                   help="seed the fit with this platform's probe-fitted "
                        "parse-overhead model (resolves the capacity/"
                        "parse-rate split; e.g. private_cpu)")
    p.set_defaults(fn=_cmd_fit)

    p = sub.add_parser("show", help="pretty-print a fitted profile")
    p.add_argument("profile")
    p.set_defaults(fn=_cmd_show)

    p = sub.add_parser("check",
                       help="exit 1 when parameters drifted beyond --gate")
    p.add_argument("new")
    p.add_argument("old")
    p.add_argument("--gate", type=float, default=0.10,
                   help="relative per-parameter tolerance (default 0.10)")
    p.set_defaults(fn=_cmd_check)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
