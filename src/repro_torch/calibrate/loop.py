"""The closed calibration loop: predict → execute → compare → refit.

Copied from ``repro.calibrate.loop``.  Ties ``repro_torch.calibrate`` to
the observability layer (``repro_torch.obs``).  A
:class:`ClosedLoop` owns a :class:`~repro_torch.core.predictor.PredictionRun`
and an accumulating trace corpus; each :meth:`round` observes the target
system (by default the cluster emulator, standing in for the real
cluster), compares the current prediction against the measurement, and
— when the drift gate fires, or always under ``refit="always"`` — fits
a fresh :class:`~repro_torch.calibrate.fit.CalibrationProfile` from *all*
accumulated traces, swaps it into the run, re-predicts, and appends a
``"recalibrated"`` ledger record.

This module imports the predictor, so it is deliberately **not**
re-exported from ``repro_torch.calibrate.__init__`` (extract/fit/synth stay
importable from inside core code without a cycle); reach it as
``repro_torch.calibrate.loop``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.events import LINK
from repro_torch.core.overhead import RecordedStep
from repro_torch.core.paper_models import PAPER_DNNS, PLATFORMS
from repro_torch.core.predictor import PredictionRun, prediction_error
from repro_torch.obs import ledger

from .extract import TraceSamples, extract_runs
from .fit import CalibrationProfile, fit_profile, template_op_medians

# Default drift gate: same semantics (absolute mean relative-error
# delta) and default value as ``repro_torch.obs.report --gate``.
DEFAULT_GATE = 0.05


def fit_from_runs(runs: Sequence[Sequence[RecordedStep]],
                  run: Optional[PredictionRun] = None,
                  source: str = "emulator") -> CalibrationProfile:
    """Fit a profile from one or more observation runs, seeding the
    fitter with the run's platform priors (probe-fitted overhead model,
    nominal WIN as the idle-stream size cutoff) when a run is given.
    Each observation run keeps its own wall clock in capacity
    estimation (see :func:`~repro_torch.calibrate.extract.extract_runs`)."""
    samples = extract_runs(runs, source=source)
    prior = win = None
    if run is not None:
        if run.overhead is None:
            run.prepare()
        prior = run.overhead
        win = run.win_estimate or PLATFORMS[run.platform].win_mu
    return fit_profile(samples, prior_overhead=prior, win_hint=win)


def fit_from_steps(steps: Sequence[RecordedStep],
                   run: Optional[PredictionRun] = None,
                   source: str = "emulator") -> CalibrationProfile:
    """Fit a profile from the recorded steps of a SINGLE run."""
    return fit_from_runs([steps], run=run, source=source)


def identity_profile(run: PredictionRun) -> CalibrationProfile:
    """The provably-inert profile for a run: fitted values equal to the
    medians/nominals the run would use anyway, so applying it rescales
    every op by exactly 1.0 and overrides every capacity with the same
    float.  Simulating with and without it gives bit-identical traces."""
    base = run.with_calibration(None)
    if not base.sim_steps_templates:
        base.prepare()
    cfg = base._sim_cfg()
    caps = {name: spec.bandwidth
            for name, spec in cfg.resources.items()
            if spec.kind == LINK}
    return CalibrationProfile(
        op_times=template_op_medians(base.sim_steps_templates),
        link_capacity=caps,
        overhead_alpha=base.overhead.alpha,
        overhead_beta=base.overhead.beta,
        provenance={"identity_of": {"dnn": run.dnn,
                                    "platform": run.platform,
                                    "seed": run.seed}},
    )


def should_recalibrate(pre_err: float, post_err: Optional[float] = None,
                       gate: float = DEFAULT_GATE) -> bool:
    """The drift decision: does the observed prediction error exceed the
    gate (first round), or did it drift beyond the gate since the last
    accepted calibration (``repro_torch.obs.report --compare`` semantics)?"""
    if post_err is None:
        return pre_err > gate
    return abs(pre_err - post_err) > gate


@dataclass
class RoundResult:
    round: int
    measured: float
    predicted_before: float
    err_before: float
    recalibrated: bool
    predicted_after: Optional[float] = None
    err_after: Optional[float] = None
    profile_digest: Optional[str] = None

    @property
    def err(self) -> float:
        """Prediction error at the end of the round."""
        return self.err_after if self.err_after is not None \
            else self.err_before


ObserveFn = Callable[[PredictionRun, int],
                     Tuple[float, List[RecordedStep]]]


def _emulator_observe(run: PredictionRun, num_workers: int,
                      steps: int = 100, seed_offset: int = 1000
                      ) -> Tuple[float, List[RecordedStep]]:
    """Default target system: the cluster emulator with the run's own
    platform (i.e. nothing drifted — the inertness baseline)."""
    from repro_torch.emulator.cluster import observe_run
    return observe_run(
        PAPER_DNNS[run.dnn], run.batch_size, PLATFORMS[run.platform],
        num_workers, num_ps=run.num_ps, steps=steps,
        seed=run.seed + seed_offset, flow_control=run.flow_control,
        order=run.order, warmup_steps=run.warmup_steps,
        topology=run.topology, sync=run.sync_spec(), faults=run.faults)


@dataclass
class ClosedLoop:
    """Predict → execute → compare → refit, with trace accumulation.

    ``refit="drift"`` (default) refits only when the error gate fires —
    an unperturbed system never recalibrates; ``"always"`` refits every
    round (convergence studies); ``"never"`` just measures.
    """

    run: PredictionRun
    num_workers: int
    observe: Optional[ObserveFn] = None
    gate: float = DEFAULT_GATE
    refit: str = "drift"
    n_runs: int = 3
    # one entry per observation run (each has its own wall clock)
    corpus: List[List[RecordedStep]] = field(default_factory=list)
    history: List[RoundResult] = field(default_factory=list)

    def __post_init__(self):
        if self.refit not in ("drift", "always", "never"):
            raise ValueError(f"unknown refit policy {self.refit!r}")
        if not self.run.sim_steps_templates:
            self.run.prepare()

    def samples(self) -> TraceSamples:
        return extract_runs(self.corpus)

    def round(self) -> RoundResult:
        """One loop iteration; appends to history and the ledger."""
        observe = self.observe or _emulator_observe
        t0 = time.perf_counter()
        measured, steps = observe(self.run, self.num_workers)
        if steps:
            self.corpus.append(list(steps))
        predicted = self.run.predict(self.num_workers, n_runs=self.n_runs)
        err = prediction_error(predicted, measured)
        res = RoundResult(round=len(self.history), measured=measured,
                          predicted_before=predicted, err_before=err,
                          recalibrated=False)
        fire = self.refit == "always" or (
            self.refit == "drift" and should_recalibrate(err, gate=self.gate))
        if fire and self.corpus:
            prof = fit_from_runs(self.corpus, run=self.run)
            self.run = self.run.with_calibration(prof)
            res.recalibrated = True
            res.profile_digest = prof.digest
            res.predicted_after = self.run.predict(self.num_workers,
                                                   n_runs=self.n_runs)
            res.err_after = prediction_error(res.predicted_after, measured)
            if ledger.resolve_path() is not None:
                ledger.log(
                    "recalibrated",
                    config={"dnn": self.run.dnn,
                            "platform": self.run.platform,
                            "num_workers": self.num_workers,
                            "seed": self.run.seed},
                    predicted=res.predicted_after, measured=measured,
                    error=res.err_after,
                    wall_s=time.perf_counter() - t0,
                    extra={"calibration_digest": prof.digest,
                           "err_before": err,
                           "round": res.round,
                           "corpus_steps": sum(len(r) for r in
                                               self.corpus)})
        self.history.append(res)
        return res

    def errors(self) -> List[float]:
        """End-of-round prediction errors, one per completed round."""
        return [r.err for r in self.history]


__all__ = ["ClosedLoop", "RoundResult", "fit_from_runs", "fit_from_steps",
           "identity_profile", "should_recalibrate", "DEFAULT_GATE"]
