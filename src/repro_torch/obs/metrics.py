"""Process-global metrics registry: counters, gauges, histograms.

Designed around one constraint: the simulator hot loops must pay
(essentially) nothing when nobody is looking.  The contract engines
follow:

  * read ``collect = metrics.enabled()`` ONCE at run start;
  * keep plain local integers inside the loop (an int increment next to
    a heappush is noise either way);
  * at run end, publish the per-run numbers into
    ``trace.meta["metrics"]`` and :func:`merge_run` them into the global
    registry **only when** ``collect`` was true.

The disabled path therefore differs from the enabled path only by the
final publication step, and ``benchmarks/perf_sim.py`` measures the
on/off ratio per general-section record (``obs_overhead``) so
``check_regression.py`` can gate any future instrumentation that breaks
this contract.  Regressions of the disabled path itself are caught by
the existing speedup-vs-reference gate.

Enable via ``REPRO_METRICS=1``, :func:`enable`, or the
:func:`collecting` context manager.  Histograms store bounded summaries
(count/sum/min/max), never sample lists.

Device counters (:func:`add`) count inside a training step without
reading the device: each sums a 0-d tensor into a total kept on that
tensor's device; :func:`snapshot` reads the totals into ``counters`` and
:func:`reset` drops them. They record while collection is on or while a
torch profiler records (:func:`counting`, ``spans.tracing``), so a traced
step counts and an untraced one pays one check a site. ``moe.routed``
and ``moe.dropped`` (``models/moe.py``) count a MoE's assignments on the
rank's experts and those left without a slot; a remat replay counts its
forward's again, so only their ratio is defined.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Iterator, Mapping, Tuple

import torch

from .spans import tracing

_enabled = os.environ.get("REPRO_METRICS", "") not in ("", "0")
_lock = threading.Lock()

_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
_hists: Dict[str, Dict[str, float]] = {}
# device counters: (name, device) -> a 0-d running total on that device
_totals: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def enabled() -> bool:
    """Is collection on?  Engines read this once per run."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


@contextlib.contextmanager
def collecting() -> Iterator[None]:
    """Scope with collection forced on (restores the previous state)."""
    global _enabled
    prev = _enabled
    _enabled = True
    try:
        yield
    finally:
        _enabled = prev


def inc(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` (no-op while disabled)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counting() -> bool:
    """Do the device counters record (collection on, or a profiler
    recording)? A site checks this before it computes what it adds."""
    return _enabled or tracing()


def add(name: str, t: torch.Tensor) -> None:
    """Add the 0-d tensor ``t`` to device counter ``name``, on ``t``'s
    device and without a host read (no-op unless :func:`counting`)."""
    if not counting():
        return
    t = t.detach()
    key = (name, t.device)
    with _lock:
        total = _totals.get(key)
        if total is None:
            _totals[key] = t.clone()
        else:
            total.add_(t)


def gauge(name: str, value: float) -> None:
    """Set gauge ``name`` to its latest value (no-op while disabled)."""
    if not _enabled:
        return
    with _lock:
        _gauges[name] = value


def observe(name: str, value: float) -> None:
    """Fold ``value`` into histogram ``name`` (count/sum/min/max)."""
    if not _enabled:
        return
    with _lock:
        h = _hists.get(name)
        if h is None:
            _hists[name] = {"count": 1, "sum": value,
                            "min": value, "max": value}
        else:
            h["count"] += 1
            h["sum"] += value
            if value < h["min"]:
                h["min"] = value
            if value > h["max"]:
                h["max"] = value


def merge_run(prefix: str, counters: Mapping[str, float]) -> None:
    """Fold a run's local counters into the registry as
    ``{prefix}.{key}`` (the end-of-run publication step)."""
    if not _enabled:
        return
    with _lock:
        for k, v in counters.items():
            name = f"{prefix}.{k}"
            _counters[name] = _counters.get(name, 0) + v


def snapshot() -> Dict[str, object]:
    """A JSON-ready copy of the whole registry, the device counters read
    (summed over devices) into ``counters``."""
    with _lock:
        out: Dict[str, object] = {}
        counters = dict(_counters)
        for (name, _), total in _totals.items():
            counters[name] = counters.get(name, 0) + total.item()
        if counters:
            out["counters"] = counters
        if _gauges:
            out["gauges"] = dict(_gauges)
        if _hists:
            out["histograms"] = {k: dict(v) for k, v in _hists.items()}
        return out


def reset() -> None:
    """Drop every recorded value (collection state is untouched)."""
    with _lock:
        _counters.clear()
        _totals.clear()
        _gauges.clear()
        _hists.clear()
