"""Closed-loop calibration: fit simulator parameters from step traces,
copied from ``repro.calibrate`` (host Python, no tensor work).

The paper predicts from a one-time single-node profile; this package
keeps the prediction accurate as the system drifts.  ``extract`` turns
observed traces (emulator recorded steps, DES traces) into fitting
samples, ``fit`` estimates per-op times / link capacities / parse
overhead into a versioned digest-stamped :class:`CalibrationProfile`
that ``PredictionRun(calibration=...)`` consumes, ``synth`` renders
planted-truth traces for the differential test harness, and ``loop``
(imported explicitly as ``repro_torch.calibrate.loop`` — it depends on the
predictor and is kept out of this namespace to avoid an import cycle)
auto-recalibrates when the ledger drift gate fires.

CLI: ``python -m repro_torch.calibrate fit|show|check`` and
``python -m repro_torch.launch.whatif ... --calibrate traces/``.
"""
from .extract import (TraceSamples, extract_des_trace,
                      extract_recorded_steps, extract_runs,
                      load_trace_runs, load_traces, save_traces,
                      template_sizes)
from .fit import CalibrationProfile, fit_profile, fit_residual_overhead
from .synth import PlantedTruth, make_truth, synthesize_steps

__all__ = [
    "CalibrationProfile", "TraceSamples", "PlantedTruth",
    "fit_profile", "fit_residual_overhead",
    "extract_recorded_steps", "extract_des_trace", "extract_runs",
    "template_sizes", "save_traces", "load_traces", "load_trace_runs",
    "make_truth", "synthesize_steps",
]
