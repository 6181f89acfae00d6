"""FLOPs of a training step on the GPU, roofline terms, hardware constants.

The port's counterpart of the reference's compiled-HLO profiler
(``repro/core/hlo_static.py::parse_hlo_profile``) and its roofline module
(``repro/core/hlo_analysis.py``).  There the FLOPs of a step are read from
the compiled HLO's ``dot`` and ``convolution`` ops; here
:func:`count_step_flops` runs the step once under
``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
products at the dispatcher.  Neither side counts elementwise work or the
optimizer.  Remat counts on both: ``torch.utils.checkpoint`` recomputes the
forward as ``jax.checkpoint`` does.  The hand-written flash-attention
kernel launches below the dispatcher, so its op carries its own FLOP
formula (``kernels/ops.py``).

Collective bytes (``CommDebugMode`` over a step on a fake-process-group
mesh) wait for the dry-run (ROADMAP 1.13b): on one GPU there are none.

Hardware constants live in a frozen :class:`GpuSpec`; :data:`H100_SXM`
holds NVIDIA's data-sheet values for the H100 SXM5.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict


@dataclass(frozen=True)
class GpuSpec:
    """Per-device hardware constants the roofline and the step DAG use."""

    name: str
    peak_flops: float    # dense bf16 tensor-core FLOP/s
    hbm_bw: float        # device-memory bytes/s
    link_bw: float       # intra-node bytes/s per device, one direction
    net_bw: float        # inter-node bytes/s per device


H100_SXM = GpuSpec(
    name="H100 SXM5",
    # NVIDIA H100 Tensor Core GPU data sheet, SXM column: BF16 tensor core
    # 1,979 TFLOP/s with sparsity, so 989.4e12 dense.
    peak_flops=989.4e12,
    # same data sheet: GPU memory bandwidth 3.35 TB/s (HBM3).
    hbm_bw=3.35e12,
    # same data sheet: NVLink 900 GB/s per GPU, both directions together.
    link_bw=450e9,
    # NVIDIA DGX H100 system specifications: eight 400 Gb/s ConnectX-7 (NDR
    # InfiniBand) compute-fabric ports, one a GPU: 400e9 / 8 bytes/s.
    net_bw=50e9,
)


def count_step_flops(step_fn: Callable, *args, **kwargs) -> int:
    """FLOPs of one call of ``step_fn(*args, **kwargs)``: every matrix
    product it dispatches, the backward and remat recompute included.

    The call runs for real (a training step updates its parameters), so
    pass copies where the caller needs the inputs unchanged."""
    from torch.utils.flop_counter import FlopCounterMode

    # the flash op's FLOP formula must be registered before the mode
    # copies the registry
    import repro_torch.kernels.ops  # noqa: F401
    with FlopCounterMode(display=False) as counter:
        step_fn(*args, **kwargs)
    return counter.get_total_flops()


def count_train_flops(cfg, batch: int, seq: int) -> int:
    """FLOPs of one AdamW training step of ``cfg`` at ``batch`` x ``seq``,
    counted on fake tensors (``FakeTensorMode``): shapes only, nothing
    allocated or computed, so a configuration too large for one card is
    counted as its step would run. The tensors are fake CPU tensors, so the
    flash op takes its plain path, whose count is the kernel's. The batch
    holds the arch's frame or patch stubs (``configs.shapes.stub_inputs``),
    so Whisper's encoder is counted over its ``encoder_len`` frames."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.shapes import stub_inputs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_map

    with FakeTensorMode():
        params = tree_map(lambda shape: torch.zeros(
            shape, requires_grad=True), param_shapes(cfg))
        opt = make_optimizer("adamw", lr=3e-4)
        toks = torch.zeros((batch, seq), dtype=torch.long)
        inputs = {"tokens": toks, "labels": toks}
        for name, (shape, dtype) in stub_inputs(cfg, batch).items():
            inputs[name] = torch.zeros(shape, dtype=dtype_of(dtype))
        return count_step_flops(make_train_step(cfg, opt), params,
                                opt.init(params), inputs)


@dataclass
class RooflineTerms:
    """All byte/FLOP quantities are PER DEVICE; ``chips`` is used only for
    MFU/global throughput reporting."""

    flops: float                 # per-device FLOPs of one step
    hbm_bytes: float             # per-device memory bytes of one step
    collective_bytes: float      # per-device link wire bytes of one step
    chips: int
    model_flops: float = 0.0     # GLOBAL useful model FLOPs of one step
    spec: GpuSpec = field(default=H100_SXM)

    @property
    def t_compute(self) -> float:
        return self.flops / self.spec.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.spec.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.spec.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """Perfect-overlap bound: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def step_time_serial(self) -> float:
        """No-overlap bound: sum of the three terms."""
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the perfect-overlap bound."""
        t = self.step_time_lower_bound
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * self.spec.peak_flops)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes, "chips": self.chips,
            "model_flops": self.model_flops, "device": self.spec.name,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_lower_bound_s": self.step_time_lower_bound,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops_train(cfg, tokens: int) -> float:
    """6·N_active·D (dense backward included); MoE counts active params."""
    from repro_torch.models.transformer import active_param_count
    return 6.0 * active_param_count(cfg) * tokens


def model_flops_decode(cfg, tokens: int, kv_len: int) -> float:
    """2·N_active per token plus attention reads over the KV cache."""
    from repro_torch.models.transformer import active_param_count
    base = 2.0 * active_param_count(cfg) * tokens
    n_attn = sum(1 for k in (cfg.pattern * cfg.n_groups +
                             cfg.tail_pattern)
                 if k in ("attn", "moe", "encdec"))
    n_local = sum(1 for k in (cfg.pattern * cfg.n_groups +
                              cfg.tail_pattern) if k == "local")
    attn = 2.0 * 2.0 * cfg.n_heads * cfg.head_dim * (
        n_attn * kv_len + n_local * min(kv_len, cfg.window or kv_len))
    return base + attn * tokens
