"""Robust parameter fitting: observed samples -> CalibrationProfile,
copied from ``repro.calibrate.fit``.  A profile's digest is the
reference's for the same parameters, so a profile file is portable across
the two packages.

Estimators are deliberately order-statistic based so the fit is invariant
under trace shuffling and robust to the heavy one-sided contamination
observed traces carry (queueing waits, flow-control stalls, parse tails):

* per-op compute times: MAD outlier rejection + trimmed mean (the
  emulator's lognormal jitter has mean 1.0, so the location of interest
  is the mean, not the median);
* per-link effective capacity: upper quartile of per-step bytes/busy
  samples — stalls and unmodeled tails only ever bias a step's sample
  *low*, so a high quantile tracks the wire rate;
* parse overhead: Theil–Sen median-of-slopes over (size, residual)
  pairs — resistant to the <50% of samples contaminated by queueing.

The result is a versioned :class:`CalibrationProfile` whose digest is a
canonical-JSON sha256 over the *parameters only* (provenance and sample
counts don't change what a simulation computes), consumed by
``PredictionRun(calibration=...)``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.events import StepTemplate
from repro_torch.core.overhead import OverheadModel
from repro_torch.obs.ledger import config_digest

from .extract import CommSample, TraceSamples

PROFILE_VERSION = 1


# ---------------------------------------------------------------------------
# Robust scalar estimators
# ---------------------------------------------------------------------------


def mad_filter(xs: Sequence[float], k: float = 5.0) -> List[float]:
    """Drop samples more than ``k`` median-absolute-deviations from the
    median (a zero MAD — at least half the samples identical — keeps
    everything: there is no scale to reject against)."""
    vals = sorted(xs)
    if len(vals) < 3:
        return vals
    med = statistics.median(vals)
    mad = statistics.median(abs(x - med) for x in vals)
    if mad <= 0.0:
        return vals
    return [x for x in vals if abs(x - med) <= k * mad]


def trimmed_mean(xs: Sequence[float], trim: float = 0.1) -> float:
    """Mean of the central ``1 - 2*trim`` mass (sorted; shuffle-proof)."""
    vals = sorted(xs)
    if not vals:
        raise ValueError("trimmed_mean of no samples")
    drop = int(len(vals) * trim)
    core = vals[drop:len(vals) - drop] or vals
    return sum(core) / len(core)


def robust_location(xs: Sequence[float], trim: float = 0.1,
                    k: float = 5.0) -> float:
    return trimmed_mean(mad_filter(xs, k=k), trim=trim)


def quantile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over sorted samples (deterministic, exact
    for constant samples — the noise=0 planted-truth case)."""
    vals = sorted(xs)
    if not vals:
        raise ValueError("quantile of no samples")
    idx = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
    return vals[idx]


def theil_sen(points: Sequence[Tuple[float, float]],
              max_pairs: int = 4000) -> Tuple[float, float]:
    """Median-of-pairwise-slopes line fit, clamped non-negative (both
    parse-rate and fixed parse cost are physical ``>= 0`` quantities).

    Points are sorted first so the slope multiset — and therefore the
    fit — is invariant under sample order; for large n a deterministic
    stride keeps the pair count bounded.
    """
    pts = sorted(points)
    xs = [p[0] for p in pts]
    if len(pts) < 2 or max(xs) == min(xs):
        raise ValueError("need >= 2 distinct sizes for a line fit")
    n = len(pts)
    stride = max(1, int(math.isqrt(max(1, n * (n - 1) // 2 // max_pairs))))
    slopes: List[float] = []
    for i in range(0, n, stride):
        xi, yi = pts[i]
        for j in range(i + 1, n, stride):
            xj, yj = pts[j]
            if xj != xi:
                slopes.append((yj - yi) / (xj - xi))
    a = max(0.0, statistics.median(slopes))
    b = max(0.0, statistics.median(y - a * x for x, y in pts))
    return a, b


# ---------------------------------------------------------------------------
# Link capacity + overhead estimation
# ---------------------------------------------------------------------------


def _busy_union(intervals: List[Tuple[float, float]]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def capacity_samples(groups: Sequence[Sequence[CommSample]],
                     overhead: Optional[OverheadModel] = None
                     ) -> List[float]:
    """One bytes/busy-union sample per step for one link.  Each recorded
    interval is trimmed by the estimated parse tail before the union, so
    the denominator approaches pure transmission time."""
    out: List[float] = []
    for grp in groups:
        total = sum(c.size for c in grp)
        ivals = []
        for c in grp:
            end = c.end - (overhead(c.size) if overhead is not None else 0.0)
            if end > c.start:
                ivals.append((c.start, end))
        busy = _busy_union(ivals)
        if busy > 0.0 and total > 0.0:
            out.append(total / busy)
    return out


def fit_link_capacity(groups: Sequence[Sequence[CommSample]],
                      overhead: Optional[OverheadModel] = None,
                      q: float = 0.75) -> Optional[float]:
    samples = capacity_samples(groups, overhead)
    if not samples:
        return None
    return quantile(mad_filter(samples), q)


def overhead_residuals(links: Dict[str, List[List[CommSample]]],
                       capacity: Dict[str, float],
                       win_hint: Optional[float] = None
                       ) -> List[Tuple[float, float]]:
    """(size, residual) parse samples from streams that found their link
    idle: residual = recorded duration - size / fitted capacity.  Streams
    larger than the flow-control window are excluded — their interval
    contains a WINDOW_UPDATE stall plus every stream serviced during it.
    """
    out: List[Tuple[float, float]] = []
    for link, groups in links.items():
        cap = capacity.get(link)
        if not cap:
            continue
        for grp in groups:
            for c in grp:
                if not c.idle_at_start or c.size <= 0.0:
                    continue
                if win_hint is not None and c.size > win_hint:
                    continue
                out.append((c.size, (c.end - c.start) - c.size / cap))
    return out


def fit_residual_overhead(observed_spans: Sequence[float],
                          predicted_spans: Sequence[float],
                          trim: float = 0.1) -> float:
    """Amdahl-style serial residual: the per-step time the observed
    system spends that the fitted components don't explain (ArboEstimator
    feedback term).  Robust location of the span gap, floored at 0."""
    if not observed_spans or not predicted_spans:
        return 0.0
    gap = robust_location(observed_spans, trim=trim) \
        - robust_location(predicted_spans, trim=trim)
    return max(0.0, gap)


# ---------------------------------------------------------------------------
# CalibrationProfile
# ---------------------------------------------------------------------------


def _is_calibratable_compute(op) -> bool:
    """Template compute ops whose durations a profile may rescale: not a
    link transmission and not a ``*/parse`` overhead op (parse durations
    are recomputed from the calibrated alpha/beta instead)."""
    if op.res.startswith(("downlink", "uplink")):
        return False
    if op.name.endswith("/parse") or op.tags.get("overhead"):
        return False
    return op.duration > 0.0


def template_op_medians(templates: Sequence[StepTemplate]
                        ) -> Dict[str, float]:
    """Per-op median duration over a template set — the denominator of
    the multiplicative correction :meth:`CalibrationProfile.apply_to_templates`
    computes.  The identity profile uses the same function, so its
    correction factors are *exactly* 1.0."""
    durs: Dict[str, List[float]] = {}
    for tpl in templates:
        for op in tpl.ops:
            if _is_calibratable_compute(op):
                durs.setdefault(op.name, []).append(op.duration)
    return {name: statistics.median(v) for name, v in durs.items()}


@dataclass
class CalibrationProfile:
    """Versioned fitted parameters that close the calibration loop.

    ``op_times`` are absolute fitted per-op compute seconds; application
    rescales each profiled template op by ``fitted / profiled-median``,
    preserving the profile's step-to-step variance structure.
    ``link_capacity`` overrides the platform's nominal per-link bytes/s
    (``"*"`` applies to every link without an explicit entry), and
    ``overhead_alpha``/``overhead_beta`` replace the probe-fitted parse
    model (both in the templates' ``*/parse`` ops and the engine's
    flow-control stall term).  ``residual_overhead_s`` is the Amdahl-style
    serial remainder, added to each step's final op when nonzero.
    """

    version: int = PROFILE_VERSION
    op_times: Dict[str, float] = field(default_factory=dict)
    link_capacity: Dict[str, float] = field(default_factory=dict)
    overhead_alpha: Optional[float] = None
    overhead_beta: Optional[float] = None
    residual_overhead_s: float = 0.0
    sample_counts: Dict[str, int] = field(default_factory=dict)
    provenance: Dict[str, object] = field(default_factory=dict)

    # -- identity / digest ------------------------------------------------

    def params(self) -> dict:
        """The parameters a simulation actually consumes (digest input:
        provenance and sample counts are excluded on purpose)."""
        return {
            "version": self.version,
            "op_times": self.op_times,
            "link_capacity": self.link_capacity,
            "overhead_alpha": self.overhead_alpha,
            "overhead_beta": self.overhead_beta,
            "residual_overhead_s": self.residual_overhead_s,
        }

    @property
    def digest(self) -> str:
        return config_digest(self.params())

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return {**self.params(), "digest": self.digest,
                "sample_counts": dict(self.sample_counts),
                "provenance": dict(self.provenance)}

    @classmethod
    def from_dict(cls, doc: dict) -> "CalibrationProfile":
        if doc.get("version") != PROFILE_VERSION:
            raise ValueError(f"unsupported CalibrationProfile version "
                             f"{doc.get('version')!r}")
        prof = cls(
            version=doc["version"],
            op_times={str(k): float(v)
                      for k, v in doc.get("op_times", {}).items()},
            link_capacity={str(k): float(v)
                           for k, v in doc.get("link_capacity", {}).items()},
            overhead_alpha=doc.get("overhead_alpha"),
            overhead_beta=doc.get("overhead_beta"),
            residual_overhead_s=doc.get("residual_overhead_s", 0.0),
            sample_counts=dict(doc.get("sample_counts", {})),
            provenance=dict(doc.get("provenance", {})),
        )
        want = doc.get("digest")
        if want is not None and want != prof.digest:
            raise ValueError(
                f"CalibrationProfile digest mismatch: file says {want}, "
                f"parameters hash to {prof.digest} (corrupt or hand-edited "
                f"profile)")
        return prof

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- application ------------------------------------------------------

    def overhead_model(self) -> Optional[OverheadModel]:
        if self.overhead_alpha is None or self.overhead_beta is None:
            return None
        return OverheadModel(alpha=self.overhead_alpha,
                             beta=self.overhead_beta)

    def capacity_for(self, link: str) -> Optional[float]:
        cap = self.link_capacity.get(link)
        if cap is None:
            cap = self.link_capacity.get("*")
        return cap

    def apply_to_templates(self, templates: Sequence[StepTemplate],
                           fallback_overhead: Optional[OverheadModel] = None
                           ) -> List[StepTemplate]:
        """Calibrated copies of preprocessed step templates.

        Compute ops are rescaled multiplicatively (fitted time over the
        template set's own median, so per-step jitter survives); parse
        ops are recomputed from the calibrated — else the fallback —
        overhead model and the size of the comm op they parse.  A profile
        whose values equal the medians/model the templates were built
        with reproduces every duration bit-for-bit (factors are exactly
        1.0 and alpha*size+beta is the same arithmetic).
        """
        med = template_op_medians(templates)
        scale = {name: self.op_times[name] / med[name]
                 for name in self.op_times
                 if med.get(name)}
        oh = self.overhead_model() or fallback_overhead
        out: List[StepTemplate] = []
        for tpl in templates:
            ops = []
            last_compute = None
            for i, op in enumerate(tpl.ops):
                if _is_calibratable_compute(op):
                    last_compute = i
            for i, op in enumerate(tpl.ops):
                if (op.name.endswith("/parse") or op.tags.get("overhead")) \
                        and oh is not None and op.deps:
                    src = tpl.ops[op.deps[0]]
                    if src.size > 0.0:
                        op = replace(op, duration=oh(src.size))
                elif _is_calibratable_compute(op):
                    s = scale.get(op.name, 1.0)
                    d = op.duration * s
                    if i == last_compute and self.residual_overhead_s:
                        d += self.residual_overhead_s
                    if d != op.duration:
                        op = replace(op, duration=d)
                ops.append(op)
            out.append(StepTemplate(ops=ops, meta=dict(tpl.meta)))
        return out


# ---------------------------------------------------------------------------
# Top-level fit
# ---------------------------------------------------------------------------


def fit_profile(samples: TraceSamples,
                prior_overhead: Optional[OverheadModel] = None,
                win_hint: Optional[float] = None,
                capacity_q: float = 0.75,
                iterations: int = 2) -> CalibrationProfile:
    """Fit every parameter the samples support.

    An idle stream's recorded interval is ``size*(1/cap + alpha) +
    beta`` — capacity and the parse *rate* are not separately
    identifiable from it (any split of the combined slope fits equally
    well).  So, like the paper (§4.1: alpha/beta come from dedicated
    per-platform probes, not job traces), the fit resolves the split
    with side information, in preference order:

    1. **direct parse samples** (``samples.parse``: DES ``*/parse`` ops
       or probe measurements) — Theil–Sen fits alpha/beta exactly and
       independently of any capacity;
    2. **a prior overhead model** (the run's probe-fitted alpha/beta) —
       trusted for trimming parse tails; the profile then reports no
       fitted alpha/beta of its own (application falls back to the
       prior), so it never claims a parameter it couldn't identify;
    3. **nothing** — alternate capacity <-> idle-stream-residual fits
       ``iterations`` times; the result is the best *effective* split
       (biased individually, their combination still models the link).

    Capacities are then one busy-union pass under the resolved model.
    """
    op_times = {name: robust_location(durs)
                for name, durs in samples.op_times.items()
                if durs and not name.endswith("/parse")}

    oh: Optional[OverheadModel] = prior_overhead
    fitted_oh: Optional[OverheadModel] = None
    if samples.parse:
        try:
            a, b = theil_sen(samples.parse)
            fitted_oh = OverheadModel(alpha=a, beta=b)
            oh = fitted_oh
        except ValueError:
            fitted_oh = None

    caps: Dict[str, float] = {}
    rounds = 1 if oh is not None else max(1, iterations)
    for _ in range(rounds):
        caps = {}
        for link, groups in samples.links.items():
            cap = fit_link_capacity(groups, overhead=oh, q=capacity_q)
            if cap:
                caps[link] = cap
        if rounds == 1:
            break
        residuals = overhead_residuals(samples.links, caps,
                                       win_hint=win_hint)
        try:
            a, b = theil_sen(residuals)
        except ValueError:
            break   # not enough distinct sizes: leave the split alone
        if a <= 0.0 and b <= 0.0:
            # residuals clamped to nothing: the queueing/stall
            # contamination swamped the parse signal — claim no
            # overhead parameters rather than a false zero model
            fitted_oh = None
            break
        fitted_oh = OverheadModel(alpha=a, beta=b)
        oh = fitted_oh

    return CalibrationProfile(
        op_times=op_times,
        link_capacity=caps,
        overhead_alpha=fitted_oh.alpha if fitted_oh else None,
        overhead_beta=fitted_oh.beta if fitted_oh else None,
        sample_counts=samples.sample_counts(),
        provenance={"source": samples.source, "fitted_at": time.time(),
                    "win_hint": win_hint,
                    "prior_overhead": ([prior_overhead.alpha,
                                        prior_overhead.beta]
                                       if prior_overhead else None)},
    )


__all__ = [
    "CalibrationProfile", "fit_profile", "fit_link_capacity",
    "fit_residual_overhead", "capacity_samples", "overhead_residuals",
    "template_op_medians", "robust_location", "trimmed_mean",
    "mad_filter", "quantile", "theil_sen", "PROFILE_VERSION",
]
