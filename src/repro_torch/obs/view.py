"""Chrome-trace JSON validator / summarizer.

    PYTHONPATH=src python -m repro_torch.obs.view trace.json
    PYTHONPATH=src python -m repro_torch.obs.view trace.json --validate

The first form prints what the trace contains — tracks, event counts by
phase, flow arrows, instants, counters, time span — so you know what to
expect before loading it in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.  ``--validate`` structurally checks the document
(every problem printed, exit 1 when any) and doubles as the CI smoke for
``whatif --export-trace`` output.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List


def validate_chrome_trace(doc) -> List[str]:
    """Structural problems with a Chrome trace-event document (empty
    list == valid).  Checks the subset the exporter emits: complete
    events (X) with non-negative durations, paired flow arrows (s/f on
    the same id), finite non-negative timestamps, and a sorted event
    stream (the exporter sorts its output; Perfetto tolerates unsorted
    input but our writers should not produce it)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["no traceEvents list"]
    if not events:
        problems.append("traceEvents is empty")
    flow_starts: Dict[object, float] = {}
    flow_ends: Dict[object, float] = {}
    last_ts = None
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            problems.append(f"event {i} has no ph")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool) \
                or not math.isfinite(ts) or ts < 0:
            problems.append(f"event {i} ({ph}) has bad ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            problems.append(
                f"event {i} ({ph}) ts {ts} out of order "
                f"(previous {last_ts})")
        last_ts = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or isinstance(dur, bool) \
                    or not math.isfinite(dur) or dur < 0:
                problems.append(f"event {i} (X) has bad dur {dur!r}")
        elif ph == "s":
            flow_starts[ev.get("id")] = ts
        elif ph == "f":
            flow_ends[ev.get("id")] = ts
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                problems.append(f"event {i} (C) has no args")
    for fid, ts_s in flow_starts.items():
        if fid not in flow_ends:
            problems.append(f"flow {fid!r} starts but never finishes")
        elif flow_ends[fid] < ts_s:
            problems.append(
                f"flow {fid!r} finishes at {flow_ends[fid]} before its "
                f"start at {ts_s}")
    for fid in flow_ends:
        if fid not in flow_starts:
            problems.append(f"flow {fid!r} finishes but never starts")
    return problems


def summarize(doc) -> dict:
    """Counts and spans for a Chrome trace-event document."""
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    by_ph: Dict[str, int] = {}
    tracks = set()
    counters = set()
    t_min = t_max = None
    for ev in events:
        if not isinstance(ev, dict):
            continue
        ph = ev.get("ph", "?")
        by_ph[ph] = by_ph.get(ph, 0) + 1
        if ph == "M" and ev.get("name") == "thread_name":
            args = ev.get("args") or {}
            tracks.add((ev.get("pid"), args.get("name")))
        if ph == "C":
            counters.add(ev.get("name"))
        ts = ev.get("ts")
        if isinstance(ts, (int, float)) and not isinstance(ts, bool):
            t_min = ts if t_min is None else min(t_min, ts)
            end = ts + ev.get("dur", 0) if ph == "X" and isinstance(
                ev.get("dur"), (int, float)) else ts
            t_max = end if t_max is None else max(t_max, end)
    return {
        "events": len(events),
        "by_phase": dict(sorted(by_ph.items())),
        "tracks": sorted(str(n) for _, n in tracks if n),
        "counters": sorted(str(c) for c in counters if c),
        "span_ms": None if t_min is None else (t_max - t_min) / 1e3,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="inspect / validate a Chrome trace-event JSON file")
    ap.add_argument("trace", help="trace JSON (whatif --export-trace)")
    ap.add_argument("--validate", action="store_true",
                    help="structural check; exit 1 on any problem")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable summary")
    args = ap.parse_args(argv)

    with open(args.trace) as f:
        doc = json.load(f)

    if args.validate:
        problems = validate_chrome_trace(doc)
        for p in problems:
            print(f"PROBLEM: {p}")
        print(f"# {args.trace}: "
              f"{'OK' if not problems else f'{len(problems)} problems'}")
        return 0 if not problems else 1

    s = summarize(doc)
    if args.json:
        print(json.dumps(s, indent=1))
        return 0
    print(f"# {args.trace}")
    print(f"  events: {s['events']}  span: "
          + (f"{s['span_ms']:.3f} ms" if s["span_ms"] is not None
             else "-"))
    print("  by phase: " + ", ".join(
        f"{ph}={n}" for ph, n in s["by_phase"].items()))
    if s["tracks"]:
        print("  tracks: " + ", ".join(s["tracks"]))
    if s["counters"]:
        print("  counters: " + ", ".join(s["counters"]))
    print("  open in https://ui.perfetto.dev (Open trace file)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
