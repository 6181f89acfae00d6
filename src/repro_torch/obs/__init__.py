"""Unified observability layer: trace export, metrics, run ledger, copied
from ``repro.obs``.

Four parts, threaded through every engine:

  * :mod:`repro_torch.obs.trace_export` — convert any synthetic trace
    (scalar DES, fleet per-job, emulator recording) into Chrome
    trace-event JSON
    viewable in Perfetto / ``chrome://tracing``: per-worker tracks for
    compute and transmission records, flow arrows for the paper's §3
    dependency structure, instant markers for fault incidents and
    barrier commits, counter tracks for link rates and staleness.
    ``Trace.to_chrome_trace()`` and ``whatif --export-trace`` are the
    front doors; ``python -m repro_torch.obs.view`` inspects/validates a
    file.
  * :mod:`repro_torch.obs.metrics` — a process-global counters/gauges/
    histograms registry, **off by default** and near-zero cost when off:
    engines read ``metrics.enabled()`` once per run and keep plain local
    integers, publishing a snapshot into ``trace.meta["metrics"]`` only
    when collection is on.
  * :mod:`repro_torch.obs.ledger` — structured JSON-lines run records
    (config digest, engine stats, wall time, predicted throughput,
    DES-vs-emulator error) appended when the ledger is on;
    ``python -m repro_torch.obs.report`` renders per-figure error bands
    and compares two ledgers for drift.
  * :mod:`repro_torch.obs.spans` — the training step's named ranges
    (``repro_torch::forward``, ``::moe``, ``::head`` ...), on the torch
    profiler's clock beside the kernels, recorded only while a profiler
    records.

This package deliberately imports nothing from :mod:`repro_torch.core`,
so every engine may import it without cycles.
"""
from __future__ import annotations

from . import ledger, metrics, spans  # noqa: F401
from .schema import validate_meta  # noqa: F401
from .timeline import LinkTimeline  # noqa: F401
from .trace_export import fleet_to_chrome_trace, to_chrome_trace  # noqa: F401

__all__ = [
    "metrics", "ledger", "validate_meta", "LinkTimeline",
    "to_chrome_trace", "fleet_to_chrome_trace",
]
