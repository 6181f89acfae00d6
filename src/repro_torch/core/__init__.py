"""The paper's predictor on the GPU, copied from ``repro.core``: the
trace-driven discrete-event simulator (DES) for asynchronous-SGD
throughput prediction (Li et al., ICPE'20), the PS-cluster pipeline
(profile, preprocess, predict, and the coarse baselines it compares
against), plus the GPU step DAG (``gpu_adapter``) and the FLOP count of a
PyTorch step that calibrates it (``flop_count``).

The lockstep batched engine (``batched``) and the multi-tenant fleet
engine (``fleet``) are ported; like the reference, the package does not
re-export their names.  Placement search and calibration (ROADMAP 1.18b)
are not ported yet."""
from .bandwidth import (BandwidthModel, EqualShareModel,
                        GroupedBandwidthModel, IncrementalWaterfill,
                        batched_waterfill, stack_waterfill_problems,
                        waterfill)
from .events import (COMPUTE, LINK, Op, ResourceSpec, StepTemplate, Trace,
                     ps_resources)
from .overhead import (OverheadModel, RecordedOp, RecordedStep,
                       preprocess_profile, preprocess_recorded_step)
from .paper_models import PAPER_DNNS, PLATFORMS
from .collectives import allreduce_duration, ring_volume
from .predictor import PredictionRun, calibrate_overhead, prediction_error
from .simulator import SimConfig, Simulation, predict_throughput
from .syncmode import (SYNC_MODES, SyncSpec, allreduce_templates,
                       make_controller, staleness_stats)
from .topology import (Node, Placement, Rack, Topology,
                       TopologyBandwidthModel)
# NOTE: ``repro_torch.core.sweep`` is the parallel sweep-engine MODULE; the
# figure-sweep convenience function lives at
# ``repro_torch.core.predictor.sweep``.
from .sweep import (measure_many, parallel_map, predict_many,
                    sweep_parallel)

__all__ = [
    "BandwidthModel", "EqualShareModel", "GroupedBandwidthModel",
    "IncrementalWaterfill", "batched_waterfill", "stack_waterfill_problems",
    "waterfill", "COMPUTE", "LINK", "Op",
    "ResourceSpec", "StepTemplate", "Trace", "ps_resources", "OverheadModel",
    "RecordedOp", "RecordedStep", "preprocess_profile",
    "preprocess_recorded_step", "PAPER_DNNS", "PLATFORMS", "PredictionRun",
    "calibrate_overhead", "prediction_error", "SimConfig",
    "Simulation", "predict_throughput",
    "Node", "Placement", "Rack", "Topology", "TopologyBandwidthModel",
    "measure_many", "parallel_map", "predict_many", "sweep_parallel",
    "SYNC_MODES", "SyncSpec", "allreduce_templates", "make_controller",
    "staleness_stats", "allreduce_duration", "ring_volume",
]
