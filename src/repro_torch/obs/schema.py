"""The one documented schema for ``trace.meta``.

Every engine that produces a :class:`repro_torch.core.events.Trace` — the
scalar DES (``core/simulator.py``), the lockstep batched engine
(``core/batched.py``, including its scalar fallback), and the merged /
delegated fleet engine (``core/fleet.py``) — stamps the same required
keys; engine-specific extras are enumerated below so consumers never
have to guess which ad-hoc keys a given run happened to set.

Required keys (all engines)
---------------------------
  engine            one of :data:`ENGINES`
  num_workers       workers simulated (per job, for fleet traces)
  steps_per_worker  configured step target per worker
  sim_end_time      simulated seconds at the last processed event
  num_events        chunk completions + processed rejoins
  sync_mode         async | sync | ssp | allreduce
  num_versions      parameter versions committed by the sync controller
  barrier_commits   barrier-commit times (empty list in async mode)

Optional keys
-------------
  useful_work_s / wasted_work_s / lost_steps / num_incidents
                    fault-mode work accounting (``wasted_s`` is a
                    deprecated fleet alias of ``wasted_work_s``)
  waterfill         IncrementalWaterfill solver stats (general path)
  metrics           per-run engine counters (obs.metrics enabled runs)
  batch_fallback / batch_fallback_reason
                    why a batched scenario rode the scalar path
  link_resources    LINK-kind resource names (recorded-trace runs; the
                    Chrome exporter uses it to classify tracks)
  contention        fleet meta only: per-link (t, active) timelines
  calibration_digest
                    digest of the CalibrationProfile the run's config
                    was built from (``repro_torch.calibrate``; absent
                    on open-loop runs)
"""
from __future__ import annotations

from typing import Dict, List, Mapping

ENGINES = ("scalar", "batched", "fleet-merged", "fleet-delegated")

REQUIRED_KEYS: Dict[str, type] = {
    "engine": str,
    "num_workers": int,
    "steps_per_worker": int,
    "sim_end_time": float,
    "num_events": int,
    "sync_mode": str,
    "num_versions": int,
    "barrier_commits": list,
}

OPTIONAL_KEYS = frozenset({
    "useful_work_s", "wasted_work_s", "wasted_s", "lost_steps",
    "num_incidents", "waterfill", "metrics", "batch_fallback",
    "batch_fallback_reason", "link_resources", "contention", "num_jobs",
    "calibration_digest",
})

_SYNC_MODES = ("async", "sync", "ssp", "allreduce")


def validate_meta(meta: Mapping[str, object],
                  strict: bool = False) -> List[str]:
    """Problems with a ``trace.meta`` dict (empty list == conforms).

    ``strict=True`` additionally rejects keys outside the documented
    required/optional sets, so tests catch new ad-hoc keys the moment an
    engine grows one."""
    problems: List[str] = []
    for key, typ in REQUIRED_KEYS.items():
        if key not in meta:
            problems.append(f"missing required key {key!r}")
            continue
        v = meta[key]
        if typ is float:
            ok = isinstance(v, (int, float)) and not isinstance(v, bool)
        elif typ is int:
            ok = isinstance(v, int) and not isinstance(v, bool)
        else:
            ok = isinstance(v, typ)
        if not ok:
            problems.append(
                f"{key!r} should be {typ.__name__}, got "
                f"{type(v).__name__}")
    eng = meta.get("engine")
    if isinstance(eng, str) and eng not in ENGINES:
        problems.append(f"unknown engine {eng!r} (expected one of "
                        f"{ENGINES})")
    mode = meta.get("sync_mode")
    if isinstance(mode, str) and mode not in _SYNC_MODES:
        problems.append(f"unknown sync_mode {mode!r}")
    if strict:
        for key in meta:
            if key not in REQUIRED_KEYS and key not in OPTIONAL_KEYS:
                problems.append(f"undocumented meta key {key!r}")
    return problems


def validate_trace_meta(trace, strict: bool = False) -> List[str]:
    """:func:`validate_meta` on a trace object (missing ``meta``
    attribute counts as one problem)."""
    meta = getattr(trace, "meta", None)
    if not isinstance(meta, Mapping):
        return ["trace has no meta dict"]
    return validate_meta(meta, strict=strict)
