"""Observed step traces -> fitting samples (the measurement half of the
closed calibration loop), copied from ``repro.calibrate.extract``
expression for expression; its corpus files are the reference's, byte for
byte.

Two trace sources feed the fitter:

* **Emulator recorded steps** (``ClusterEmulator(record_profile=True)``,
  the stand-in for real TensorFlow traces): compute ops carry their true
  execution interval, but a communication op's ``start`` is the *request*
  time and its ``end`` includes receiver-side parsing — the §2
  information gap.  Capacity therefore cannot be read off a single
  stream; it is estimated per (link, run) as transferred bytes over the
  busy-time union of the link's trimmed intervals — the aggregate
  service rate of the shared link — and the parse overhead as the
  residual of streams that found the link idle.
* **DES traces** (``SimConfig(record_trace=True)``): link records are
  pure transmissions and ``*/parse`` ops are explicit, so parse samples
  are direct (sizes come from the step templates via ``size_of``).

The output is a :class:`TraceSamples` bundle; ``repro_torch.calibrate.fit``
turns it into a :class:`~repro_torch.calibrate.fit.CalibrationProfile`.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.overhead import OverheadModel, RecordedOp, RecordedStep

_LINK_PREFIXES = ("downlink", "uplink")


def _is_link(res: str) -> bool:
    return res.startswith(_LINK_PREFIXES)


@dataclass(frozen=True)
class CommSample:
    """One observed communication op on a link."""

    start: float
    end: float
    size: float
    # the link had no earlier-started stream still in flight when this
    # one was requested: its recorded interval contains no queueing wait,
    # so (duration - size/capacity) isolates the parse overhead
    idle_at_start: bool


@dataclass
class TraceSamples:
    """Fitting samples extracted from observed traces.

    ``links`` groups communication ops per link **per run** (one group
    per ``extract_*`` call): all of a run's steps share one wall clock,
    so the group's bytes over its busy-time union measures the link's
    *aggregate* service rate — counting time two workers overlapped
    once, with both workers' bytes in the numerator.  Per-step grouping
    would instead measure each worker's contended share (capacity/W on
    a saturated link).  Merging corpora from several runs appends
    groups; runs never share a time axis, so their intervals are never
    unioned together.
    """

    op_times: Dict[str, List[float]] = field(default_factory=dict)
    links: Dict[str, List[List[CommSample]]] = field(default_factory=dict)
    # direct (size, duration) parse samples — DES traces only
    parse: List[Tuple[float, float]] = field(default_factory=list)
    # per-step makespan (max end - min start): residual-overhead input
    step_spans: List[float] = field(default_factory=list)
    steps: int = 0
    source: str = ""

    def merge(self, other: "TraceSamples") -> "TraceSamples":
        for name, durs in other.op_times.items():
            self.op_times.setdefault(name, []).extend(durs)
        for link, groups in other.links.items():
            self.links.setdefault(link, []).extend(groups)
        self.parse.extend(other.parse)
        self.step_spans.extend(other.step_spans)
        self.steps += other.steps
        if other.source and other.source not in self.source.split("+"):
            self.source = (f"{self.source}+{other.source}"
                           if self.source else other.source)
        return self

    def sample_counts(self) -> Dict[str, int]:
        return {
            "steps": self.steps,
            "compute_ops": sum(len(v) for v in self.op_times.values()),
            "comm_ops": sum(len(g) for groups in self.links.values()
                            for g in groups),
            "parse_ops": len(self.parse),
        }


def _comm_samples(ops: Sequence[RecordedOp]) -> List[CommSample]:
    """Communication samples for the ops of ONE link in ONE run, with
    the idle-at-start flag derived from the recorded intervals (the run
    spans every worker, so idleness is true link idleness)."""
    timed = sorted(ops, key=lambda o: (o.start, o.end))
    out: List[CommSample] = []
    latest_end = float("-inf")
    for op in timed:
        idle = latest_end <= op.start + 1e-12
        latest_end = max(latest_end, op.end)
        out.append(CommSample(start=op.start, end=op.end,
                              size=op.size, idle_at_start=idle))
    return out


def extract_recorded_steps(steps: Sequence[RecordedStep],
                           source: str = "emulator") -> TraceSamples:
    """Samples from TF-style recorded steps (emulator ground truth).

    All steps are assumed to come from ONE run (shared wall clock) —
    each link contributes one whole-run group.  To pool several runs,
    extract each separately and :meth:`TraceSamples.merge`."""
    out = TraceSamples(source=source)
    by_link: Dict[str, List[RecordedOp]] = {}
    for step in steps:
        t0, t1 = float("inf"), float("-inf")
        for op in step.ops:
            if op.end <= op.start:
                continue   # never executed (e.g. crashed mid-step)
            t0, t1 = min(t0, op.start), max(t1, op.end)
            if _is_link(op.res):
                by_link.setdefault(op.res, []).append(op)
            else:
                out.op_times.setdefault(op.name, []).append(op.duration)
        if t1 > t0:
            out.step_spans.append(t1 - t0)
        out.steps += 1
    for link, ops in by_link.items():
        out.links.setdefault(link, []).append(_comm_samples(ops))
    return out


def extract_des_trace(trace, size_of: Optional[Dict[str, float]] = None,
                      source: str = "des") -> TraceSamples:
    """Samples from a DES trace (``SimConfig(record_trace=True)``).

    ``size_of`` maps op name -> bytes (build it from the step templates);
    link and parse records without a known size are skipped.
    """
    size_of = size_of or {}
    out = TraceSamples(source=source)
    by_link: Dict[str, List[RecordedOp]] = {}
    by_step: Dict[Tuple[int, int], List] = {}
    for rec in trace.records:
        by_step.setdefault((rec.worker, rec.step_seq), []).append(rec)
    for recs in by_step.values():
        t0, t1 = float("inf"), float("-inf")
        for rec in recs:
            if rec.end <= rec.start:
                continue
            t0, t1 = min(t0, rec.start), max(t1, rec.end)
            dur = rec.end - rec.start
            if _is_link(rec.res):
                size = size_of.get(rec.name)
                if size:
                    by_link.setdefault(rec.res, []).append(
                        RecordedOp(name=rec.name, res=rec.res, deps=(),
                                   size=size, start=rec.start, end=rec.end))
            elif rec.name.endswith("/parse"):
                size = size_of.get(rec.name[:-len("/parse")])
                if size:
                    out.parse.append((size, dur))
            else:
                out.op_times.setdefault(rec.name, []).append(dur)
        if t1 > t0:
            out.step_spans.append(t1 - t0)
        out.steps += 1
    for link, ops in by_link.items():
        out.links.setdefault(link, []).append(_comm_samples(ops))
    return out


def extract_runs(runs: Sequence[Sequence[RecordedStep]],
                 source: str = "emulator") -> TraceSamples:
    """Merged samples from SEVERAL runs (e.g. the refit loop's
    accumulated corpus).  Each run gets its own per-link group — runs
    have independent wall clocks, so unioning their intervals together
    would double-count bytes over the same busy span."""
    out = TraceSamples(source=source)
    for steps in runs:
        out.merge(extract_recorded_steps(steps, source=source))
    return out


def template_sizes(templates) -> Dict[str, float]:
    """op name -> bytes for every sized op of the given step templates
    (the ``size_of`` input of :func:`extract_des_trace`)."""
    out: Dict[str, float] = {}
    for tpl in templates:
        for op in tpl.ops:
            if op.size:
                out.setdefault(op.name, op.size)
    return out


# ---------------------------------------------------------------------------
# Recorded-step (de)serialization: the on-disk trace corpus the refit
# loop and ``whatif --calibrate traces/`` accumulate and consume.
# ---------------------------------------------------------------------------

TRACE_FORMAT_VERSION = 1
# the reference's marker, kept so that either package reads the other's
# corpus files
TRACE_FORMAT = "repro.calibrate.traces"


def steps_to_json(steps: Sequence[RecordedStep],
                  meta: Optional[dict] = None) -> dict:
    return {
        "format": TRACE_FORMAT,
        "version": TRACE_FORMAT_VERSION,
        "meta": dict(meta or {}),
        "steps": [
            {"meta": {k: v for k, v in s.meta.items()
                      if isinstance(v, (str, int, float, bool))},
             "ops": [
                 {"name": o.name, "res": o.res, "deps": list(o.deps),
                  "size": o.size, "start": o.start, "end": o.end,
                  "priority": o.priority}
                 for o in s.ops]}
            for s in steps],
    }


def steps_from_json(doc: dict) -> List[RecordedStep]:
    if doc.get("format") != TRACE_FORMAT:
        raise ValueError("not a repro.calibrate trace file "
                         "(missing format marker)")
    if doc.get("version") != TRACE_FORMAT_VERSION:
        raise ValueError(f"unsupported trace format version "
                         f"{doc.get('version')!r}")
    steps = []
    for s in doc.get("steps", []):
        ops = [RecordedOp(name=o["name"], res=o["res"],
                          deps=tuple(o.get("deps", ())),
                          size=o.get("size", 0.0), start=o["start"],
                          end=o["end"], priority=o.get("priority", 0.0))
               for o in s["ops"]]
        steps.append(RecordedStep(ops=ops, meta=dict(s.get("meta", {}))))
    return steps


def save_traces(path: str, steps: Sequence[RecordedStep],
                meta: Optional[dict] = None) -> str:
    """Write one trace-corpus JSON file (parent dirs created)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(steps_to_json(steps, meta), f)
    return path


def load_trace_runs(path: str) -> List[List[RecordedStep]]:
    """Load a trace corpus as a list of RUNS — one per ``*.json`` file
    (sorted by name; non-trace json is rejected loudly rather than
    silently skipped).  Each file is assumed to hold one run's steps;
    feed the result to :func:`extract_runs` so capacity estimation
    never unions intervals from unrelated wall clocks."""
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, n) for n in os.listdir(path)
            if n.endswith(".json"))
        if not files:
            raise FileNotFoundError(f"no *.json trace files in {path!r}")
    else:
        files = [path]
    runs: List[List[RecordedStep]] = []
    for fp in files:
        with open(fp) as f:
            runs.append(steps_from_json(json.load(f)))
    return runs


def load_traces(path: str) -> List[RecordedStep]:
    """Flat list of recorded steps from a trace file or directory.
    Convenient for counting/inspection; for fitting prefer
    :func:`load_trace_runs`, which preserves run boundaries."""
    return [s for run in load_trace_runs(path) for s in run]


__all__ = [
    "CommSample", "TraceSamples", "extract_recorded_steps",
    "extract_des_trace", "extract_runs", "template_sizes", "steps_to_json",
    "steps_from_json", "save_traces", "load_traces", "load_trace_runs",
    "OverheadModel",
]
