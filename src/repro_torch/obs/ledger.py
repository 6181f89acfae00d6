"""Structured run ledger: one JSON-lines record per prediction run.

Library entry points (``PredictionRun.predict``,
``sweep.sweep_parallel``) append only when the ledger is switched on —
``REPRO_LEDGER=<path>`` in the environment, or :func:`enable`
programmatically (``whatif`` enables ``build/ledger.jsonl`` when run from
the repo root) — so unit tests and throwaway runs don't spray files.

A record carries: timestamp, record kind, a config digest (sha256 over
canonical JSON, so "same configuration" is machine-checkable), engine
and solver stats, wall time, predicted throughput and — when both the
DES prediction and the emulator measurement ran — the prediction error.
``python -m repro_torch.obs.report`` renders per-figure error bands off this
file and compares two ledgers for drift — the detection half of
closed-loop calibration.  The calibration loop that closes it (refit a
``CalibrationProfile`` when the drift gate fires and append a
``"recalibrated"`` record) is not ported yet: ROADMAP 1.18b.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional

_default_path: Optional[str] = None


def enable(path: str) -> None:
    """Turn on library-level appends, writing to ``path``."""
    global _default_path
    _default_path = path


def disable() -> None:
    global _default_path
    _default_path = None


def resolve_path(path: Optional[str] = None) -> Optional[str]:
    """The ledger file to append to, or None when the ledger is off.
    Precedence: explicit ``path`` > ``REPRO_LEDGER`` env > programmatic
    :func:`enable`.  ``REPRO_LEDGER=0`` forces the ledger off."""
    env = os.environ.get("REPRO_LEDGER", "")
    if env == "0":
        return None
    return path or (env or None) or _default_path


def config_digest(obj) -> str:
    """sha256 (truncated) over canonical JSON — stable across processes
    and dict orderings; non-JSON values fall back to ``repr``."""
    blob = json.dumps(obj, sort_keys=True, default=repr,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def make_record(kind: str, *, figure: Optional[str] = None,
                config=None, engine: Optional[str] = None,
                predicted: Optional[float] = None,
                measured: Optional[float] = None,
                error: Optional[float] = None,
                mean_err: Optional[float] = None,
                max_err: Optional[float] = None,
                wall_s: Optional[float] = None,
                stats: Optional[Dict[str, object]] = None,
                extra: Optional[Dict[str, object]] = None) -> dict:
    rec: Dict[str, object] = {"ts": time.time(), "kind": kind}
    if figure is not None:
        rec["figure"] = figure
    if config is not None:
        rec["config_digest"] = config_digest(config)
    for key, val in (("engine", engine), ("predicted", predicted),
                     ("measured", measured), ("error", error),
                     ("mean_err", mean_err), ("max_err", max_err),
                     ("wall_s", wall_s), ("stats", stats)):
        if val is not None:
            rec[key] = val
    if extra:
        rec.update(extra)
    return rec


def append(rec: dict, path: Optional[str] = None) -> Optional[str]:
    """Append one record; returns the path written, or None when the
    ledger is off.  Never raises on I/O problems — observability must
    not break the run it observes."""
    dst = resolve_path(path)
    if dst is None:
        return None
    try:
        d = os.path.dirname(dst)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(dst, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        return dst
    except OSError:
        return None


def log(kind: str, path: Optional[str] = None, **fields) -> Optional[str]:
    """:func:`make_record` + :func:`append` in one call."""
    if resolve_path(path) is None:
        return None
    return append(make_record(kind, **fields), path=path)


def read(path: str) -> List[dict]:
    """Load a ledger file (malformed lines are skipped, not fatal)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def figure_record(figure: str, payload: dict,
                  wall_s: Optional[float] = None) -> dict:
    """A ledger record distilled from a figure driver's result payload:
    scalar config values form the digest; error/predicted fields are
    pulled from the conventional keys (``max_err`` / ``mean_err`` /
    ``error`` lists / per-row ``err``)."""
    config = {k: v for k, v in payload.items()
              if isinstance(v, (str, int, float, bool))
              and k not in ("max_err", "mean_err")}
    mean_err = payload.get("mean_err")
    max_err = payload.get("max_err")
    if not isinstance(mean_err, (int, float)) \
            or not isinstance(max_err, (int, float)):
        errs = _collect_errors(payload)
        if errs:
            mean_err = sum(errs) / len(errs)
            max_err = max(errs)
        else:
            mean_err = max_err = None
    predicted = None
    p = payload.get("predicted")
    if isinstance(p, (list, tuple)) and p and all(
            isinstance(x, (int, float)) for x in p):
        predicted = sum(p) / len(p)
    return make_record(
        "figure", figure=figure, config=config, wall_s=wall_s,
        predicted=predicted, mean_err=mean_err, max_err=max_err)


def _collect_errors(payload, depth: int = 0) -> List[float]:
    """Prediction-error samples found in a figure payload: top-level
    ``max_err``/``mean_err`` scalars, ``error`` lists (sweep results),
    and per-row ``err`` values, searched shallowly."""
    errs: List[float] = []
    if depth > 3:
        return errs
    if isinstance(payload, dict):
        for key in ("err", "error", "max_err", "mean_err"):
            v = payload.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                errs.append(float(v))
            elif isinstance(v, (list, tuple)):
                errs.extend(float(x) for x in v
                            if isinstance(x, (int, float))
                            and not isinstance(x, bool))
        for v in payload.values():
            if isinstance(v, (dict, list)):
                errs.extend(_collect_errors(v, depth + 1))
    elif isinstance(payload, list):
        for v in payload:
            if isinstance(v, (dict, list)):
                errs.extend(_collect_errors(v, depth + 1))
    return errs
