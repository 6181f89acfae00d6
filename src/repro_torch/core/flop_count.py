"""FLOPs and bytes of a training step on the GPU, roofline terms, hardware
constants.

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

A step on DTensors is counted per device by :func:`count_device`, which
sees the local ops that DTensor lowers each op to: the FLOPs one rank
computes (the work every rank repeats included), the bytes its local ops
read and write, the peak of its live local bytes and its collectives
(``core/comm_count.py``). The dry-run (``launch/dryrun.py``) traces
production meshes this way on fake tensors over a fake process group.

Hardware constants live in a frozen :class:`GpuSpec`; :data:`H100_SXM`
holds NVIDIA's data-sheet values for the H100 SXM5.
"""
from __future__ import annotations

import heapq
import os
import sys
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.comm_count import CollectiveStats, collective_kind
from repro_torch.core.comm_count import record as record_collective


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



# ---------------------------------------------------------------------------
# Per-device counts of a step on DTensors
# ---------------------------------------------------------------------------


@dataclass
class DeviceCounts:
    """One rank's counts of one step.

    ``hbm_bytes`` is the bytes every local op reads and writes: each op's
    tensor inputs and outputs, unfused; views and ops that return no
    tensor count none. XLA's
    ``bytes accessed`` counts a fusion's inputs and outputs once, so this
    counts more. ``peak_bytes`` is the most local bytes alive at once: the
    step's arguments (params, optimizer state, batch) and everything its
    ops allocate while it runs, the counterpart of ``memory_analysis``'s
    argument + output + temp - alias (the optimizer updates in place where
    the reference donates). ``peak_by_op`` splits the peak by the op that
    allocated each live storage (``"arguments"`` for the step's own);
    ``peak_tensors`` names the largest storages live at the peak: bytes, op,
    shape and dtype of the tensor that allocated each, and the call site
    (:func:`_call_site`). ``local_ops`` counts the ops counted; ``ops``
    holds per-op totals by op name."""

    flops: int = 0
    hbm_bytes: int = 0
    local_ops: int = 0
    argument_bytes: int = 0
    peak_bytes: int = 0
    peak_by_op: Dict[str, int] = field(default_factory=dict)
    peak_tensors: List[Dict] = field(default_factory=list)
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    ops: Dict[str, Dict] = field(default_factory=dict)

    def top_ops(self, n: int) -> List[Dict]:
        """The ``n`` ops with the most FLOPs, then bytes."""
        rows = [{"name": k, **v} for k, v in self.ops.items()]
        rows.sort(key=lambda r: (r["flops"], r["bytes"] + r["coll_bytes"]),
                  reverse=True)
        return rows[:n]


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for t in x:
            yield from _tensors(t)
    elif isinstance(x, dict):
        for t in x.values():
            yield from _tensors(t)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _is_view(func) -> bool:
    """An op whose outputs alias its inputs without writing them: by its
    schema, or one of ``_VIEWS``."""
    if func._overloadpacket._qualified_op_name in _VIEWS:
        return True
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


# a view whose schema does not say so, and a functional collective's wait
# and autograd wrapper, which hand back the collective's own output
_VIEWS = ("aten::_unsafe_view", "_c10d_functional::wait_tensor",
          "_c10d_functional::_wrap_tensor_autograd")


# DTensor runs ops of its own to infer shardings (on fake tensors of the
# global shapes); they are none of the rank's work.
_PROPAGATION_FILE = "tensor/_sharding_prop.py"


# the package's root, and the layers below the model that only pass a
# tensor on: a call site is the innermost frame of the package outside them
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_PASS_ON = tuple(_PACKAGE + d + os.sep for d in ("core", "parallel"))

# the live storages ``peak_tensors`` lists
PEAK_TENSORS = 5


def _call_site() -> str:
    """``file:line`` (relative to the package) of the innermost frame of
    ``repro_torch`` outside ``core/`` and ``parallel/``: the model line
    that asked for the op (``models/moe.py:151`` for the MoE's dispatch
    move), or the step's line where autograd runs a backward; "" if
    none."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_PACKAGE) and not name.startswith(_PASS_ON):
            return f"{name[len(_PACKAGE):]}:{f.f_lineno}"
        f = f.f_back
    return ""


def _in_sharding_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION_FILE):
            return True
        f = f.f_back
    return False


class DeviceCounter(TorchDispatchMode):
    """Counts, while active, the local ops of one rank (see
    :class:`DeviceCounts`). An op on DTensors is handed back
    (``NotImplemented``) so that DTensor lowers it to local ops and
    collectives first. Counted are the ops that run in the fake mode that
    was active on entry (none for real tensors), outside DTensor's sharding
    propagation. FLOPs come from ``FlopCounterMode``'s formulas, so an op
    counts what it counts there. ``arguments`` are the tensors alive before
    the step: their local bytes start the live count."""

    def __init__(self, arguments: Iterable[torch.Tensor] = ()):
        from torch._guards import active_fake_mode
        from torch.utils.flop_counter import FlopCounterMode

        import repro_torch.kernels.ops  # noqa: F401  (the flash formula)
        super().__init__()
        self.counts = DeviceCounts()
        self._flops = FlopCounterMode(display=False)
        self._fake_mode = active_fake_mode()
        # storage id -> (bytes, the op that allocated it)
        self._live: Dict[int, Tuple[int, str]] = {}
        # storage id -> (shape, dtype, call site) of the allocating tensor
        self._where: Dict[int, Tuple[Tuple[int, ...], str, str]] = {}
        self._refs: Dict[int, weakref.ref] = {}
        self._live_bytes = 0
        self._by_op: Dict[str, int] = {}
        for t in arguments:
            self._track(_local(t), "arguments", "")
        self.counts.argument_bytes = self.counts.peak_bytes = self._live_bytes
        self.counts.peak_by_op = dict(self._by_op)
        # the live set is the peak's until the next free: ``peak_tensors``
        # is taken then (or at the end), not at every new peak of a climb
        self._peak_pending = True

    def _track(self, t: torch.Tensor, owner: str, site: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        self._live[key] = (st.nbytes(), owner)
        self._where[key] = (tuple(t.shape), str(t.dtype), site)
        self._live_bytes += st.nbytes()
        self._by_op[owner] = self._by_op.get(owner, 0) + st.nbytes()
        self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))

    def _take_peak_tensors(self) -> None:
        if not self._peak_pending:
            return
        self._peak_pending = False
        top = heapq.nlargest(PEAK_TENSORS, self._live.items(),
                             key=lambda kv: kv[1][0])
        self.counts.peak_tensors = [
            {"bytes": nbytes, "op": owner, "shape": list(shape),
             "dtype": dtype, "site": site}
            for key, (nbytes, owner) in top
            for shape, dtype, site in [self._where[key]]]

    def _free(self, key: int) -> None:
        self._take_peak_tensors()
        nbytes, owner = self._live.pop(key, (0, None))
        self._where.pop(key, None)
        self._live_bytes -= nbytes
        if owner is not None:
            self._by_op[owner] -= nbytes
        self._refs.pop(key, None)

    def _counted(self) -> bool:
        from torch._guards import active_fake_mode
        return (active_fake_mode() is self._fake_mode
                and not _in_sharding_propagation())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if not self._counted():
            return func(*args, **kwargs)
        if func is not torch.ops.prim.device.default:
            with self:      # as FlopCounterMode: count what an op lowers to
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        if (func is torch.ops._c10d_functional.wait_tensor.default
                and self._fake_mode is not None):
            # the fake kernel returns a new tensor where the real one
            # returns its input
            return args[0]
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.counts
        before = self._flops.get_total_flops()
        self._flops._count_flops(func._overloadpacket, out, args, kwargs)
        flops = self._flops.get_total_flops() - before
        coll = record_collective(c.collectives, func, args, kwargs, out)
        outs = list(_tensors(out))
        moved = 0
        if outs and not _is_view(func):
            seen = {id(t): t for t in _tensors((args, kwargs))}
            moved = sum(t.numel() * t.element_size()
                        for t in (*seen.values(), *outs))
            site = _call_site()
            for t in outs:
                self._track(t, str(func), site)
        c.flops += flops
        c.hbm_bytes += moved
        c.local_ops += 1
        if self._live_bytes > c.peak_bytes:
            c.peak_bytes = self._live_bytes
            c.peak_by_op = {k: v for k, v in self._by_op.items() if v}
            self._peak_pending = True
        kind = collective_kind(func) or ("dot" if flops else "op")
        row = c.ops.setdefault(str(func), {"kind": kind, "flops": 0,
                                           "bytes": 0, "coll_bytes": 0})
        row["flops"] += flops
        row["bytes"] += moved
        row["coll_bytes"] += coll


def count_device(fn: Callable, *args, arguments: Iterable = (),
                 **kwargs) -> DeviceCounts:
    """One rank's :class:`DeviceCounts` of one call of ``fn(*args,
    **kwargs)``. ``arguments``: the tensors alive before the call (a
    DTensor counts its local shard)."""
    with DeviceCounter(arguments) as counter:
        fn(*args, **kwargs)
    counter._take_peak_tensors()
    return counter.counts

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
