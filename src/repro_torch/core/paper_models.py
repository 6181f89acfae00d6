"""Per-layer tables for the DNNs used in the paper's experiments.

The paper profiles TensorFlow benchmark models (AlexNet, GoogLeNet,
Inception-v3, ResNet-50, VGG-11).  We encode each as a list of layers with
parameter bytes (fp32) and forward MACs per image, from the public
architectures.  These tables drive both the cluster emulator (ground truth)
and the analytic profile generator: a layer's parameters form one
downlink and one uplink stream (TensorFlow transfers per-layer tensors),
forward/backward compute time scales with MACs and batch size.

Backward pass ~ 2x forward MACs (standard for convnets: gradients w.r.t.
inputs + w.r.t. weights).  PS update cost is memory-bound in the parameter
bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class LayerSpec:
    name: str
    params: int          # parameter count
    fwd_macs: float      # forward MACs per image

    @property
    def param_bytes(self) -> int:
        return 4 * self.params  # fp32, as in TF 1.13 PS training


@dataclass(frozen=True)
class DnnSpec:
    name: str
    layers: Tuple[LayerSpec, ...]

    @property
    def total_params(self) -> int:
        return sum(l.params for l in self.layers)

    @property
    def total_param_bytes(self) -> int:
        return sum(l.param_bytes for l in self.layers)

    @property
    def total_fwd_macs(self) -> float:
        return sum(l.fwd_macs for l in self.layers)


def _L(name: str, params: int, fwd_macs: float) -> LayerSpec:
    return LayerSpec(name, params, fwd_macs)


ALEXNET = DnnSpec("alexnet", (
    _L("conv1", 34_944, 105.4e6),
    _L("conv2", 307_456, 223.4e6),
    _L("conv3", 885_120, 149.5e6),
    _L("conv4", 663_936, 112.1e6),
    _L("conv5", 442_624, 74.8e6),
    _L("fc6", 37_752_832, 37.8e6),
    _L("fc7", 16_781_312, 16.8e6),
    _L("fc8", 4_097_000, 4.1e6),
))  # 60.97M params, ~724M MACs

VGG11 = DnnSpec("vgg11", (
    _L("conv1_1", 1_792, 86.7e6),
    _L("conv2_1", 73_856, 924.8e6),
    _L("conv3_1", 295_168, 924.8e6),
    _L("conv3_2", 590_080, 1_849.7e6),
    _L("conv4_1", 1_180_160, 924.8e6),
    _L("conv4_2", 2_359_808, 1_849.7e6),
    _L("conv5_1", 2_359_808, 462.4e6),
    _L("conv5_2", 2_359_808, 462.4e6),
    _L("fc6", 102_764_544, 102.8e6),
    _L("fc7", 16_781_312, 16.8e6),
    _L("fc8", 4_097_000, 4.1e6),
))  # 132.86M params, ~7.6G MACs

GOOGLENET = DnnSpec("googlenet", (
    _L("conv1", 9_472, 118.8e6),
    _L("conv2", 114_944, 360.0e6),
    _L("inception_3a", 163_696, 128.0e6),
    _L("inception_3b", 388_736, 304.0e6),
    _L("inception_4a", 376_176, 73.0e6),
    _L("inception_4b", 449_160, 88.0e6),
    _L("inception_4c", 510_104, 100.0e6),
    _L("inception_4d", 605_376, 119.0e6),
    _L("inception_4e", 868_352, 170.0e6),
    _L("inception_5a", 1_043_456, 54.0e6),
    _L("inception_5b", 1_444_080, 71.0e6),
    _L("fc", 1_025_000, 1.0e6),
))  # ~7.0M params, ~1.59G MACs

INCEPTION_V3 = DnnSpec("inception_v3", (
    _L("stem", 1_000_480, 1_200.0e6),
    _L("mixed_5b", 256_368, 310.0e6),
    _L("mixed_5c", 277_968, 340.0e6),
    _L("mixed_5d", 288_048, 350.0e6),
    _L("mixed_6a", 1_153_280, 420.0e6),
    _L("mixed_6b", 1_297_408, 470.0e6),
    _L("mixed_6c", 1_585_920, 560.0e6),
    _L("mixed_6d", 1_585_920, 560.0e6),
    _L("mixed_6e", 2_089_728, 650.0e6),
    _L("mixed_7a", 1_697_792, 250.0e6),
    _L("mixed_7b", 4_640_256, 300.0e6),
    _L("mixed_7c", 5_906_176, 310.0e6),
    _L("fc", 2_049_000, 2.0e6),
))  # ~23.8M params, ~5.72G MACs

RESNET50 = DnnSpec("resnet50", (
    _L("stem", 9_536, 118.0e6),
    _L("block1_0", 75_008, 240.0e6),
    _L("block1_1", 70_400, 220.0e6),
    _L("block1_2", 70_400, 220.0e6),
    _L("block2_0", 379_392, 300.0e6),
    _L("block2_1", 280_064, 245.0e6),
    _L("block2_2", 280_064, 245.0e6),
    _L("block2_3", 280_064, 245.0e6),
    _L("block3_0", 1_512_448, 290.0e6),
    _L("block3_1", 1_117_184, 245.0e6),
    _L("block3_2", 1_117_184, 245.0e6),
    _L("block3_3", 1_117_184, 245.0e6),
    _L("block3_4", 1_117_184, 245.0e6),
    _L("block3_5", 1_117_184, 245.0e6),
    _L("block4_0", 6_039_552, 290.0e6),
    _L("block4_1", 4_462_592, 245.0e6),
    _L("block4_2", 4_462_592, 245.0e6),
    _L("fc", 2_049_000, 2.0e6),
))  # ~25.56M params, ~4.1G MACs

PAPER_DNNS: Dict[str, DnnSpec] = {
    d.name: d for d in (ALEXNET, VGG11, GOOGLENET, INCEPTION_V3, RESNET50)
}


# ---------------------------------------------------------------------------
# Platform profiles (paper §4.1)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Platform:
    """Hardware/network profile of one of the paper's three test platforms.

    ``worker_flops``: sustained fp32 FLOP/s of a worker for convnet training
    (NOT peak; calibrated to the era's TF 1.13 throughput numbers).
    ``ps_update_bw``: bytes/s at which the PS applies updates (memory-bound).
    ``noise_*``: emulator-only dynamics (the predictor never sees these).
    """

    name: str
    bandwidth: float          # bytes/s per direction
    worker_flops: float
    ps_update_bw: float
    overhead_alpha: float     # true parse cost, s/byte (emulator)
    overhead_beta: float      # true parse cost, s (emulator)
    noise_compute: float      # lognormal sigma on compute ops
    noise_bandwidth: float    # lognormal sigma on per-service link weight
    win_mu: float = 28e6      # mean HTTP/2 flow-control window (bytes)
    win_sigma: float = 0.0    # relative AR(1) std of WIN
    bg_rate: float = 0.0      # background flows per second (per link)
    bg_mean_duration: float = 0.0
    rtt: float = 0.2e-3


# 1 Gbps Ethernet, quad-core Opteron 2376. Calibrated so AlexNet bs=8 runs
# ~0.55 s/step of compute (the paper's Fig 13 regime).
PRIVATE_CPU = Platform(
    name="private_cpu",
    bandwidth=125e6,
    worker_flops=30e9,
    ps_update_bw=4e9,
    overhead_alpha=8.0e-10,   # ~1.25 GB/s parse rate
    overhead_beta=1.0e-3,
    noise_compute=0.05,
    noise_bandwidth=0.08,     # shared GbE + TCP: per-burst goodput spread
    win_mu=28e6,
    win_sigma=0.02,
    bg_rate=0.0,
    bg_mean_duration=0.0,
    rtt=0.2e-3,
)

# AWS c4.8xlarge, 10 Gbps.
AWS_CPU = Platform(
    name="aws_cpu",
    bandwidth=1.25e9,
    worker_flops=180e9,
    ps_update_bw=10e9,
    overhead_alpha=6.0e-10,
    overhead_beta=0.5e-3,
    noise_compute=0.06,
    noise_bandwidth=0.10,
    win_mu=28e6,
    win_sigma=0.10,
    bg_rate=0.05,
    bg_mean_duration=2.0,
    rtt=0.3e-3,
)

# AWS p3.2xlarge (V100), 10 Gbps. Effective convnet training throughput of a
# V100 under TF 1.13: ~2.6 TFLOP/s sustained.
AWS_GPU = Platform(
    name="aws_gpu",
    bandwidth=1.25e9,
    worker_flops=2.6e12,
    ps_update_bw=10e9,
    overhead_alpha=6.0e-10,
    overhead_beta=0.5e-3,
    noise_compute=0.05,
    noise_bandwidth=0.10,
    win_mu=28e6,
    win_sigma=0.10,
    bg_rate=0.05,
    bg_mean_duration=2.0,
    rtt=0.3e-3,
)

PLATFORMS: Dict[str, Platform] = {
    p.name: p for p in (PRIVATE_CPU, AWS_CPU, AWS_GPU)
}


def layer_compute_times(dnn: DnnSpec, batch_size: int,
                        platform: Platform) -> List[Tuple[str, float, float, float]]:
    """Per-layer (name, fwd_s, bwd_s, ps_update_s) at batch ``batch_size``.

    fwd = 2 FLOPs/MAC; bwd = 2x fwd; update = param_bytes / ps_update_bw
    (applied once per step regardless of batch size).
    """
    out = []
    for layer in dnn.layers:
        fwd = 2.0 * layer.fwd_macs * batch_size / platform.worker_flops
        bwd = 2.0 * fwd
        upd = layer.param_bytes / platform.ps_update_bw
        out.append((layer.name, fwd, bwd, upd))
    return out
