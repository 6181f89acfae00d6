"""The paper's predictor on the GPU: the discrete-event simulator (DES)
that replays one worker's step DAG under a link-sharing model, copied from
``repro.core``, plus the GPU step DAG (``gpu_adapter``) and the FLOP count
of a PyTorch step that calibrates it (``flop_count``).

The reference's PS-cluster pipeline (predictor, emulator, baselines),
batched and fleet engines and placement search are not ported yet
(ROADMAP 1.17, 1.18)."""
from .bandwidth import (BandwidthModel, EqualShareModel,
                        GroupedBandwidthModel, IncrementalWaterfill,
                        batched_waterfill, stack_waterfill_problems,
                        waterfill)
from .events import (COMPUTE, LINK, Op, ResourceSpec, StepTemplate, Trace,
                     ps_resources)
from .simulator import SimConfig, Simulation
from .sweep import parallel_map

__all__ = [
    "BandwidthModel", "EqualShareModel", "GroupedBandwidthModel",
    "IncrementalWaterfill", "batched_waterfill", "stack_waterfill_problems",
    "waterfill", "COMPUTE", "LINK", "Op", "ResourceSpec", "StepTemplate",
    "Trace", "ps_resources", "SimConfig", "Simulation", "parallel_map",
]
