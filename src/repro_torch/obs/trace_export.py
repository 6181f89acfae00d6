"""Chrome trace-event export: synthetic traces as Perfetto timelines.

Converts the engines' trace objects into the Chrome trace-event JSON
format (the ``traceEvents`` array consumed by Perfetto and
``chrome://tracing``):

  * one *process* per worker, one *thread* (track) per resource the
    worker touched — compute ops and link transmissions appear as
    complete-duration events (``ph: "X"``, microsecond timestamps);
  * flow arrows (``ph: "s"`` / ``"f"``) from a transmission to the
    computation it unblocks — the paper's §3 intra-step dependency
    structure made visible.  With step templates the arrows follow the
    exact dependency edges by op name; without, a received part is
    paired with any same-step compute op starting at its end time;
  * instant markers (``ph: "i"``, global scope) for fault incidents
    (down and recovery edges) and barrier commits;
  * counter tracks (``ph: "C"``) for per-link allocated rate and
    active-connection count (``SimConfig.record_rates`` runs and fleet
    contention timelines) plus the staleness of each applied update.

All functions are pure and import nothing from :mod:`repro_torch.core`; times
are simulation seconds scaled to trace microseconds.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Mapping, Sequence, Tuple

# simulation seconds -> trace microseconds
_US = 1e6
# pid 0 carries global instants and counter tracks; workers are pid 1+
_GLOBAL_PID = 0

_LINK_BASENAMES = ("downlink", "uplink", "dcn", "ici")


def _res_is_link(res: str, link_set) -> bool:
    if link_set is not None:
        return res in link_set
    # fleet resources are namespaced "j{j}/<res>", shards ":<i>"-indexed
    base = res.rsplit("/", 1)[-1].split(":", 1)[0]
    return base in _LINK_BASENAMES


def _meta_event(pid: int, tid: int, name: str, value) -> dict:
    return {"ph": "M", "pid": pid, "tid": tid, "ts": 0,
            "name": name, "args": {"name": value}
            if name in ("process_name", "thread_name")
            else {"sort_index": value}}


def _dedupe_records(records) -> List:
    """One record per (worker, step_seq, name, res), keeping the latest
    end: the scalar engine appends a record per *chunk* completion with
    the op's start time, so the last one spans the whole op."""
    best: Dict[tuple, object] = {}
    for r in records:
        key = (r.worker, r.step_seq, r.name, r.res)
        prev = best.get(key)
        if prev is None or r.end > prev.end:
            best[key] = r
    return list(best.values())


def _template_dep_names(templates) -> Dict[str, Tuple[str, ...]]:
    """op name -> dependency op names, unioned over all templates (a
    figure family's sampled steps share one op-name structure)."""
    deps: Dict[str, set] = {}
    for tpl in templates:
        ops = tpl.ops
        for op in ops:
            deps.setdefault(op.name, set()).update(
                ops[d].name for d in op.deps)
    return {k: tuple(sorted(v)) for k, v in deps.items()}


def to_chrome_trace(trace, templates=None,
                    trace_name: str = "repro") -> dict:
    """A :class:`repro_torch.core.events.Trace` as a Chrome trace-event dict.

    ``templates`` (the run's step templates) makes flow arrows follow
    the exact dependency edges; without them arrows are inferred by
    end/start time coincidence within a (worker, step) group.  Serialize
    with ``json.dump`` and load the file in https://ui.perfetto.dev.
    """
    meta = getattr(trace, "meta", {}) or {}
    link_set = meta.get("link_resources")
    link_set = set(link_set) if link_set is not None else None
    events: List[dict] = []
    flow_ids = itertools.count(1)

    records = _dedupe_records(getattr(trace, "records", ()))
    # --- per-worker process / per-resource thread tracks ---
    tids: Dict[Tuple[int, str], int] = {}
    by_worker: Dict[int, List[str]] = {}
    for r in records:
        lst = by_worker.setdefault(r.worker, [])
        if r.res not in lst:
            lst.append(r.res)
    for w in sorted(by_worker):
        pid = w + 1
        events.append(_meta_event(pid, 0, "process_name", f"worker {w}"))
        events.append(_meta_event(pid, 0, "process_sort_index", pid))
        for tid, res in enumerate(sorted(by_worker[w])):
            tids[(w, res)] = tid
            events.append(_meta_event(pid, tid, "thread_name", res))
            events.append(_meta_event(pid, tid, "thread_sort_index", tid))

    for r in records:
        is_link = _res_is_link(r.res, link_set)
        events.append({
            "ph": "X", "pid": r.worker + 1, "tid": tids[(r.worker, r.res)],
            "ts": r.start * _US, "dur": max(0.0, r.end - r.start) * _US,
            "cat": "transmission" if is_link else "compute",
            "name": r.name, "args": {"step": r.step_seq, "res": r.res},
        })

    # --- flow arrows: transmission -> dependent computation ---
    groups: Dict[Tuple[int, int], List] = {}
    for r in records:
        groups.setdefault((r.worker, r.step_seq), []).append(r)
    dep_names = _template_dep_names(templates) if templates else None
    for (w, _seq), recs in groups.items():
        by_name = {r.name: r for r in recs}
        pairs: List[Tuple[object, object]] = []
        if dep_names is not None:
            for r in recs:
                for dname in dep_names.get(r.name, ()):
                    d = by_name.get(dname)
                    if d is not None and d is not r:
                        pairs.append((d, r))
        else:
            links = [r for r in recs if _res_is_link(r.res, link_set)]
            comps = [r for r in recs if not _res_is_link(r.res, link_set)]
            for d in links:
                eps = 1e-9 * max(1.0, abs(d.end))
                for r in comps:
                    if abs(r.start - d.end) <= eps:
                        pairs.append((d, r))
        for d, r in pairs:
            fid = next(flow_ids)
            common = {"cat": "dep", "name": f"{d.name}->{r.name}",
                      "id": fid}
            events.append({"ph": "s", "pid": d.worker + 1,
                           "tid": tids[(d.worker, d.res)],
                           "ts": d.end * _US, **common})
            events.append({"ph": "f", "bp": "e", "pid": r.worker + 1,
                           "tid": tids[(r.worker, r.res)],
                           "ts": max(r.start, d.end) * _US, **common})

    events.append(_meta_event(_GLOBAL_PID, 0, "process_name", trace_name))
    events.extend(_incident_events(getattr(trace, "incidents", ())))
    events.extend(_barrier_events(meta.get("barrier_commits", ())))
    events.extend(_staleness_events(trace))

    rate_log = getattr(trace, "rate_log", None)
    if rate_log:
        events.extend(rate_counter_events(rate_log))
    else:
        events.extend(_active_counters_from_records(records, link_set))

    events.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "M" else 1))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "engine": meta.get("engine", "unknown"),
            "sync_mode": meta.get("sync_mode", "async"),
            "num_workers": meta.get("num_workers"),
        },
    }


def _incident_events(incidents) -> List[dict]:
    out = []
    for inc in incidents:
        kind = inc.get("kind", "incident")
        target = inc.get("target")
        out.append({"ph": "i", "s": "g", "pid": _GLOBAL_PID, "tid": 0,
                    "ts": float(inc.get("t_down", 0.0)) * _US,
                    "cat": "fault", "name": f"{kind}:{target}",
                    "args": dict(inc)})
        t_up = inc.get("t_up")
        if t_up is not None:
            out.append({"ph": "i", "s": "g", "pid": _GLOBAL_PID, "tid": 0,
                        "ts": float(t_up) * _US, "cat": "fault",
                        "name": f"recover:{kind}:{target}"})
    return out


def _barrier_events(commits) -> List[dict]:
    return [{"ph": "i", "s": "g", "pid": _GLOBAL_PID, "tid": 0,
             "ts": float(t) * _US, "cat": "sync",
             "name": "barrier-commit", "args": {"version": i + 1}}
            for i, t in enumerate(commits)]


def _staleness_events(trace) -> List[dict]:
    completions = getattr(trace, "step_completions", ())
    lags = getattr(trace, "staleness", ())
    if not completions or len(lags) != len(completions):
        return []
    return [{"ph": "C", "pid": _GLOBAL_PID, "tid": 0, "ts": t * _US,
             "name": "staleness", "args": {"version lag": lags[i]}}
            for i, (_w, _s, t) in enumerate(completions)]


def rate_counter_events(rate_log) -> List[dict]:
    """Counter tracks off a scalar-engine rate log: ``(t, link,
    allocated_Bps, active)`` samples from ``SimConfig.record_rates``."""
    out = []
    for t, name, rate, active in rate_log:
        out.append({"ph": "C", "pid": _GLOBAL_PID, "tid": 0, "ts": t * _US,
                    "name": f"rate {name}", "args": {"B/s": rate}})
        out.append({"ph": "C", "pid": _GLOBAL_PID, "tid": 0, "ts": t * _US,
                    "name": f"active {name}", "args": {"conns": active}})
    return out


def _active_counters_from_records(records, link_set) -> List[dict]:
    """Fallback active-transmission counters derived from the records
    themselves (+1 at each transmission start, -1 at its end)."""
    edges: List[Tuple[float, int, str]] = []
    for r in records:
        if _res_is_link(r.res, link_set):
            edges.append((r.start, 1, r.res))
            edges.append((r.end, -1, r.res))
    edges.sort()
    active: Dict[str, int] = {}
    out = []
    for t, delta, res in edges:
        active[res] = active.get(res, 0) + delta
        out.append({"ph": "C", "pid": _GLOBAL_PID, "tid": 0, "ts": t * _US,
                    "name": f"active {res}", "args": {"conns": active[res]}})
    return out


def timeline_counter_events(timelines: Mapping[str, Sequence[Tuple[float,
                                                                   float]]],
                            prefix: str = "active",
                            unit: str = "conns") -> List[dict]:
    """Counter tracks from folded :class:`repro_torch.obs.timeline.LinkTimeline`
    series (the fleet engine's ``meta["contention"]`` shape)."""
    out = []
    for name, series in timelines.items():
        for t, value in series:
            out.append({"ph": "C", "pid": _GLOBAL_PID, "tid": 0,
                        "ts": t * _US, "name": f"{prefix} {name}",
                        "args": {unit: value}})
    return out


def fleet_to_chrome_trace(fleet_trace, cfg=None) -> dict:
    """A ``FleetTrace`` as one Chrome trace: per-job step-completion
    tracks plus the shared fabric's contention counter tracks (its
    ``meta["contention"]``, which ``core/fleet.py`` records when
    ``record_contention`` is on)."""
    events: List[dict] = []
    events.append(_meta_event(_GLOBAL_PID, 0, "process_name", "fleet"))
    for j, (name, trace) in enumerate(sorted(fleet_trace.jobs.items())):
        pid = j + 1
        events.append(_meta_event(pid, 0, "process_name", f"job {name}"))
        events.append(_meta_event(pid, 0, "thread_name", "steps"))
        for w, seq, t in getattr(trace, "step_completions", ()):
            events.append({"ph": "i", "s": "t", "pid": pid, "tid": 0,
                           "ts": t * _US, "cat": "step",
                           "name": f"w{w} step {seq}",
                           "args": {"worker": w, "step": seq}})
        events.extend(_incident_events(getattr(trace, "incidents", ())))
    contention = (fleet_trace.meta or {}).get("contention", {})
    events.extend(timeline_counter_events(contention))
    events.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "M" else 1))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"engine": (fleet_trace.meta or {}).get(
                "engine", "fleet"),
                "num_jobs": len(fleet_trace.jobs)}}


def recorded_steps_to_chrome_trace(steps, incidents=(),
                                   trace_name: str = "emulator") -> dict:
    """Emulator profiling records (``ClusterEmulator.profiled_steps``,
    :class:`repro_torch.core.overhead.RecordedStep`) as a Chrome trace.  Dep
    edges are exact (recorded op indices), so every flow arrow is a true
    §3 dependency."""
    events: List[dict] = []
    flow_ids = itertools.count(1)
    tids: Dict[str, int] = {}
    events.append(_meta_event(_GLOBAL_PID, 0, "process_name", trace_name))
    events.append(_meta_event(1, 0, "process_name", "worker 0"))
    for seq, step in enumerate(steps):
        for op in step.ops:
            if op.res not in tids:
                tid = len(tids)
                tids[op.res] = tid
                events.append(_meta_event(1, tid, "thread_name", op.res))
        for op in step.ops:
            events.append({
                "ph": "X", "pid": 1, "tid": tids[op.res],
                "ts": op.start * _US,
                "dur": max(0.0, op.end - op.start) * _US,
                "cat": ("transmission" if _res_is_link(op.res, None)
                        else "compute"),
                "name": op.name, "args": {"step": seq, "res": op.res}})
        for op in step.ops:
            for d in op.deps:
                dep = step.ops[d]
                fid = next(flow_ids)
                common = {"cat": "dep", "id": fid,
                          "name": f"{dep.name}->{op.name}"}
                events.append({"ph": "s", "pid": 1, "tid": tids[dep.res],
                               "ts": dep.end * _US, **common})
                events.append({"ph": "f", "bp": "e", "pid": 1,
                               "tid": tids[op.res],
                               "ts": max(op.start, dep.end) * _US,
                               **common})
    events.extend(_incident_events(incidents))
    events.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "M" else 1))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"engine": "emulator"}}


def write_chrome_trace(doc: dict, path: str) -> str:
    """Serialize an exported trace to ``path`` (compact JSON)."""
    import json
    with open(path, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    return path
