"""Ledger reporting: per-figure error bands and two-ledger drift.

    PYTHONPATH=src python -m repro_torch.obs.report build/ledger.jsonl
    PYTHONPATH=src python -m repro_torch.obs.report NEW.jsonl --compare OLD.jsonl

The first form prints, per figure, how many runs the ledger holds and
the band (min/mean/max over runs) of each run's mean and max prediction
error — the paper's DES-vs-emulator accuracy, tracked over time.  The
second compares the latest record per figure in two ledgers and exits
nonzero when any figure's mean error drifted by more than ``--gate``
(absolute) — the detection half of closed-loop calibration.  Wall times
are reported but never gated (they are machine-dependent; the error
metrics are deterministic given seeds).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

from . import ledger


def _by_figure(records: List[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for rec in records:
        fig = rec.get("figure") or rec.get("kind") or "?"
        out.setdefault(str(fig), []).append(rec)
    return out


def _band(values: List[float]) -> Optional[Tuple[float, float, float]]:
    vals = [v for v in values if isinstance(v, (int, float))]
    if not vals:
        return None
    return (min(vals), sum(vals) / len(vals), max(vals))


def summarize(records: List[dict]) -> Dict[str, dict]:
    """Per-figure summary: run count, mean/max-error bands over runs,
    latest record's errors and wall time."""
    out: Dict[str, dict] = {}
    for fig, recs in sorted(_by_figure(records).items()):
        latest = recs[-1]
        out[fig] = {
            "runs": len(recs),
            "mean_err_band": _band([r.get("mean_err") for r in recs]),
            "max_err_band": _band([r.get("max_err") for r in recs]),
            "latest_mean_err": latest.get("mean_err"),
            "latest_max_err": latest.get("max_err"),
            "latest_wall_s": latest.get("wall_s"),
        }
    return out


def compare(new: List[dict], old: List[dict],
            gate: float = 0.05) -> Tuple[bool, List[str]]:
    """Drift between the latest record per figure of two ledgers.

    Returns ``(ok, lines)``: ok is False when any common figure's mean
    error moved by more than ``gate`` in absolute terms.  Drift is only
    ever a statement about figures *both* ledgers ran: a new ledger
    covering a strict subset of the baseline (a fast CI smoke vs the
    nightly full suite, or the calibration loop's first partial round)
    is an informational skip per missing figure, never a failure."""
    ok = True
    lines: List[str] = []
    new_by = {f: recs[-1] for f, recs in _by_figure(new).items()}
    old_by = {f: recs[-1] for f, recs in _by_figure(old).items()}
    for fig in sorted(set(new_by) | set(old_by)):
        a, b = new_by.get(fig), old_by.get(fig)
        if a is None or b is None:
            lines.append(f"{fig:>16s}  skip: only in "
                         f"{'new' if b is None else 'baseline'} ledger "
                         f"(informational)")
            continue
        ea, eb = a.get("mean_err"), b.get("mean_err")
        if not isinstance(ea, (int, float)) \
                or not isinstance(eb, (int, float)):
            lines.append(f"{fig:>16s}  skip: no error metric on one side "
                         f"(informational)")
            continue
        drift = ea - eb
        flag = ""
        if abs(drift) > gate:
            ok = False
            flag = "  << DRIFT"
        lines.append(f"{fig:>16s}  mean_err {eb:.4f} -> {ea:.4f} "
                     f"({drift:+.4f}){flag}")
    return ok, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-figure error bands and drift from a run ledger")
    ap.add_argument("ledger", help="ledger.jsonl to report on")
    ap.add_argument("--compare", metavar="BASELINE",
                    help="second ledger; exit 1 when the latest mean "
                         "error per figure drifted beyond --gate")
    ap.add_argument("--gate", type=float, default=0.05,
                    help="absolute mean-error drift tolerance "
                         "(default 0.05)")
    ap.add_argument("--figure", help="restrict to one figure")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable summary")
    args = ap.parse_args(argv)

    try:
        records = ledger.read(args.ledger)
    except FileNotFoundError:
        if args.compare:
            # nothing observed yet (e.g. the calibration loop's first
            # round, or a job that produced no ledger): no drift signal,
            # not a drift failure
            print(f"# drift: no ledger at {args.ledger} — skip")
            print("# verdict: SKIP")
            return 0
        print(f"error: no ledger at {args.ledger}", file=sys.stderr)
        return 2
    if args.figure:
        records = [r for r in records if r.get("figure") == args.figure]
    if args.compare:
        try:
            base = ledger.read(args.compare)
        except FileNotFoundError:
            print(f"# drift: no baseline ledger at {args.compare} — skip")
            print("# verdict: SKIP")
            return 0
        if args.figure:
            base = [r for r in base if r.get("figure") == args.figure]
        ok, lines = compare(records, base, gate=args.gate)
        print(f"# drift: {args.ledger} vs {args.compare} "
              f"(gate {args.gate:.3f})")
        for line in lines:
            print(line)
        print(f"# verdict: {'OK' if ok else 'DRIFT'}")
        return 0 if ok else 1

    summary = summarize(records)
    if args.json:
        print(json.dumps(summary, indent=1))
        return 0
    print(f"# {args.ledger}: {len(records)} records, "
          f"{len(summary)} figures")
    print(f"{'figure':>16s} {'runs':>5s} {'mean_err':>22s} "
          f"{'max_err':>22s} {'wall_s':>8s}")
    def fmt(band):
        if band is None:
            return "-"
        lo, mid, hi = band
        return f"{lo:.4f}/{mid:.4f}/{hi:.4f}"

    for fig, s in summary.items():
        wall = s["latest_wall_s"]
        wall_s = f"{wall:8.1f}" if isinstance(wall, (int, float)) \
            else f"{'-':>8s}"
        print(f"{fig:>16s} {s['runs']:5d} {fmt(s['mean_err_band']):>22s} "
              f"{fmt(s['max_err_band']):>22s} {wall_s}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
