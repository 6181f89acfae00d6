"""Logical-axis sharding (PyTorch): one model code path, any mesh.

The port of ``repro.parallel.sharding`` onto a ``torch`` ``DeviceMesh``
and DTensor placements. Models annotate activations with *logical* names
(``shard(x, "act_ff")``); parameters are matched by their ``"/"``-joined
key paths. A :class:`ShardingRules` object maps logical roles to mesh axis
names. Outside a mesh context every annotation is the identity, so the same
model runs unsharded on one device.

Parallelism forms expressed through the rules (DP / FSDP / TP / EP / SP):
  * batch          -> ("pod", "data")      data parallelism (+ pod DP)
  * d_ff / heads   -> "model"              tensor parallelism
  * experts        -> "model"              expert parallelism
  * sequence       -> "model"/"data"       sequence/context parallelism
  * fsdp           -> "data"               parameter/optimizer sharding

A sharding is a :class:`NamedSharding`: the mesh, the reference's spec (a
tuple per tensor dim of mesh-axis names, or ``None``) and the DTensor
placements derived from it. ``shard`` redistributes a DTensor to its name's
placements and passes a plain tensor through; ``distribute`` is the port's
``jax.device_put`` over a tree.
"""
from __future__ import annotations

import math
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.tree import tree_map

_ctx = threading.local()

Spec = Tuple[Optional[Tuple[str, ...]], ...]


# ---------------------------------------------------------------------------
# Activation annotations
# ---------------------------------------------------------------------------

# logical activation name -> PartitionSpec builder (axes names resolved late)
# Conventions: B=batch, S=sequence, H=heads, K=kv-heads, D=head_dim, F=d_ff,
# E=experts, C=capacity, M=d_model.
_ACT_SPECS: Dict[str, Tuple[Optional[str], ...]] = {
    # (B, S, F)
    "act_ff": ("batch", None, "tp"),
    # (B, S, H, D)
    "act_heads": ("batch", None, "tp", None),
    # (B, S, K, D): kv heads may be fewer than the tp degree; _shard_kv
    # picks the head-sharded variant only when K % tp == 0.
    "act_kv": ("batch", None, None, None),
    "act_kv_heads": ("batch", None, "tp", None),
    # (B, S, H, D) q for odd-head archs: sequence-parallel attention
    "act_heads_seq": ("batch", "sp", None, None),
    # (B, S, M) residual stream, sequence-sharded between blocks (SP)
    "act_seq": ("batch", "sp", None),
    # (B, S, M) residual stream, replicated sequence
    "act_btd": ("batch", None, None),
    # (B, S, V) logits
    "logits": ("batch", None, "tp"),
    # (B, S, K, D) decode KV cache: batch over data, cache seq over model
    # (flash-decoding style partial softmax handled by SPMD partitioner)
    "kv_cache": ("batch", "tp", None, None),
    # (G, E, C, M) expert dispatch
    "moe_ecd": (None, "tp", None, None),
    # hillclimbed variant: groups stay data-sharded through dispatch ->
    # the (group, expert) resharding lowers to all-to-all, not all-gather
    "moe_ecd_grouped": ("batch", "tp", None, None),
    # expert outputs resharded back to group-local (a2a) so the combine
    # einsum needs no all-reduce over the expert axis
    "moe_necd_local": ("batch", None, None, None),
    # (B, S, E) router logits
    "router": ("batch", None, None),
    # (B, S, R) recurrent width activations
    "act_rnn": ("batch", None, "tp"),
    # (n_slots, B, R) recurrent state
    "rnn_state": (None, "batch", "tp"),
}


@dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis roles to (tuples of) mesh axis names."""

    batch: Tuple[str, ...] = ("pod", "data")   # DP over these axes
    tp: Tuple[str, ...] = ("model",)           # tensor/expert parallel axis
    sp: Tuple[str, ...] = ("model",)           # sequence-parallel axis
    fsdp: Tuple[str, ...] = ("data",)          # parameter sharding axis

    def resolve(self, role: Optional[str],
                mesh: DeviceMesh) -> Optional[Tuple[str, ...]]:
        if role is None:
            return None
        axes = tuple(a for a in getattr(self, role)
                     if a in mesh.mesh_dim_names)
        return axes or None


def axes_size(mesh: DeviceMesh, axes: Optional[Tuple[str, ...]]) -> int:
    """The number of shards over the mesh axes ``axes`` (1 for None)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[a] for a in (axes or ()))


def _placements(mesh: DeviceMesh, spec: Spec) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec``: ``Shard(d)`` on each mesh dim that
    tensor dim ``d``'s entry names, ``Replicate()`` on the others.

    DTensor orders the shards of one tensor dim by mesh dim and JAX by the
    entry's tuple, so a dim over several axes must name them in the mesh's
    order; anything else raises."""
    names = list(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        idx = [names.index(a) for a in part]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: dim {d} is sharded over {part}, out of the "
                f"mesh's axis order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 "shards two tensor dims")
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh, the reference's spec over it, and the DTensor placements."""

    mesh: DeviceMesh
    spec: Spec
    placements: Tuple[Placement, ...] = field(init=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "placements",
                           _placements(self.mesh, self.spec))


def _spec(parts) -> Spec:
    """Entries as tuples of axis names, or None."""
    return tuple(None if p is None else tuple(p) for p in parts)


@dataclass
class MeshContext:
    mesh: DeviceMesh
    rules: ShardingRules = field(default_factory=ShardingRules)


def use_mesh(mesh: Optional[DeviceMesh],
             rules: Optional[ShardingRules] = None):
    """Context manager enabling sharding annotations (None disables)."""

    class _Ctx:
        def __enter__(self):
            _ctx.current = MeshContext(mesh, rules or ShardingRules()) \
                if mesh is not None else None
            return self

        def __exit__(self, *a):
            _ctx.current = None

    return _Ctx()


def current_mesh() -> Optional[MeshContext]:
    return getattr(_ctx, "current", None)


def _spec_for(name: str, ndim: int, mc: MeshContext) -> Optional[Spec]:
    roles = _ACT_SPECS.get(name)
    if roles is None or len(roles) != ndim:
        return None
    return tuple(mc.rules.resolve(r, mc.mesh) for r in roles)


def role_size(role: str) -> int:
    """Mesh extent of a logical role (1 when no mesh context active)."""
    mc = current_mesh()
    if mc is None:
        return 1
    axes = mc.rules.resolve(role, mc.mesh)
    if not axes:
        return 1
    return axes_size(mc.mesh, axes)


def _divides(shape, spec: Spec, mesh: DeviceMesh) -> bool:
    return all(part is None or dim % axes_size(mesh, part) == 0
               for dim, part in zip(shape, spec))


def shard(x, name: str):
    """Annotate activation ``x`` with the logical sharding ``name``: a
    DTensor is redistributed to it, a plain tensor passes through. The
    identity with no mesh current, no spec for the name and rank, or a
    sharded dim that does not divide evenly."""
    mc = current_mesh()
    if mc is None or not isinstance(x, DTensor):
        return x
    spec = _spec_for(name, x.ndim, mc)
    if spec is None or not _divides(x.shape, spec, mc.mesh):
        return x
    return x.redistribute(mc.mesh, _placements(mc.mesh, spec))


def constant_like(t: torch.Tensor, ref):
    """A constant ``t`` (positions, masks, RoPE tables: the same on every
    rank, no gradient) as a replicated DTensor on ``ref``'s mesh when
    ``ref`` is a DTensor, so that the two may meet in one op; else ``t``.
    The reference's constants are replicated arrays."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def reduce_partials(x):
    """``x`` with every pending (partial) sum reduced: a DTensor's
    ``Partial`` placements become ``Replicate()``, its shards stay; anything
    else passes through. An embedding over a vocab-sharded table leaves a
    masked partial sum, which DTensor cannot reduce in the same
    redistribution as a move of another mesh dim's shard."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def replicate_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` whole on every rank: a DTensor sharded
    there is redistributed to ``Replicate()`` on those mesh dims (an
    all-gather); anything else passes through. DTensor refuses to unbind or
    index a sharded dim, which the reference's ``scan`` over stacked
    parameters does."""
    if not isinstance(x, DTensor) or Shard(dim) not in x.placements:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p == Shard(dim) else p for p in x.placements])


# ---------------------------------------------------------------------------
# Parameter shardings (by key path)
# ---------------------------------------------------------------------------

# Patterns are matched against '/'-joined pytree key paths. First match wins.
# Axis tuples use role names resolved through ShardingRules.
# None = replicated dim.
_PARAM_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    # embeddings (V, M): vocab over tp, model dim over fsdp
    (r"(^|/)embed$", ("tp", "fsdp")),
    (r"(^|/)lm_head$", ("fsdp", "tp")),
    (r"(^|/)pos_embed$", (None, None)),
    # attention (stacked: leading scan dim handled dynamically)
    (r"wq$", ("fsdp", "tp", None)),    # (M, H, D)
    (r"wk$", ("fsdp", None, None)),    # (M, K, D) kv heads usually < tp
    (r"wv$", ("fsdp", None, None)),
    (r"wo$", ("tp", None, "fsdp")),    # (H, D, M)
    # xLSTM projections
    (r"lstm_wqkv$", ("fsdp", None, "tp", None)),  # (M, 3, H, D)
    (r"lstm_wx$", ("fsdp", None, "tp", None)),    # (M, 4, H, D)
    (r"lstm_wh$", ("tp", None, None, None)),      # (H, D, 4, D)
    (r"lstm_w(if|og)$", ("fsdp", None)),          # (M, ...) projections
    # MLP (M, F) / (F, M): F over tp, M over fsdp
    (r"(mlp|dense_ff)/wi$", ("fsdp", "tp")),
    (r"(mlp|dense_ff)/wg$", ("fsdp", "tp")),
    (r"(mlp|dense_ff)/wo$", ("tp", "fsdp")),
    # MoE experts (E, M, F): experts over tp, F over fsdp
    (r"experts/wi$", ("tp", None, "fsdp")),
    (r"experts/wg$", ("tp", None, "fsdp")),
    (r"experts/wo$", ("tp", "fsdp", None)),
    (r"router/w$", (None, None)),
    # shared experts: like dense MLP
    (r"shared/wi$", ("fsdp", "tp")),
    (r"shared/wg$", ("fsdp", "tp")),
    (r"shared/wo$", ("tp", "fsdp")),
    # RG-LRU / recurrent blocks (M, R) projections: R over tp
    (r"(rg|rnn|lstm)[^/]*/w[a-z]*$", (None, "tp")),
    # norms / gates / scalars: replicated
    (r".*", None),
]


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree, ``path`` the ``"/"``-joined keys, as
    the reference's ``_path_str`` names a pytree's leaves."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_spec(path: str, ndim: int, mesh: DeviceMesh,
               rules: ShardingRules) -> Spec:
    for pat, roles in _PARAM_RULES:
        if re.search(pat, path):
            if roles is None:
                return ()
            roles = tuple(roles)
            if len(roles) < ndim:  # stacked leading scan dims -> replicated
                roles = (None,) * (ndim - len(roles)) + roles
            elif len(roles) > ndim:
                return ()
            return tuple(rules.resolve(r, mesh) for r in roles)
    return ()


def _guarded(shape, parts, mesh: DeviceMesh) -> Spec:
    """``parts`` with every entry whose extent does not divide its dim
    replaced by None, padded with None to the rank."""
    ok = [part if part is None or dim % axes_size(mesh, part) == 0 else None
          for dim, part in zip(shape, parts)]
    return _spec(ok + [None] * (len(shape) - len(ok)))


def params_shardings(params, mesh: DeviceMesh,
                     rules: Optional[ShardingRules] = None):
    """NamedSharding tree for a parameter tree, with divisibility guard.

    Leaves are tensors (``meta`` ones allocate nothing) or anything with a
    ``shape``; a Python ``int`` leaf (the optimizers' step) is replicated."""
    rules = rules or ShardingRules()

    def leaf(path, x):
        if isinstance(x, int):
            return NamedSharding(mesh, ())
        spec = param_spec(path, len(x.shape), mesh, rules)
        return NamedSharding(mesh, _guarded(x.shape, spec, mesh))

    return _map_with_path(leaf, params)


# Decode-state leaf rules (matched by trailing path component). Leading
# ``n_slots`` scan dims are padded with None automatically.
_STATE_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r"(^|/)x?k$", ("batch", "tp", None, None)),   # KV cache (B,S,K,D)
    (r"(^|/)x?v$", ("batch", "tp", None, None)),
    (r"(^|/)h$", ("batch", "tp")),                 # rnn state (B,R)
    (r"(^|/)conv$", ("batch", None, "tp")),        # (B,W-1,R)
    (r"(^|/)C$", ("batch", "tp", None, None)),     # mLSTM (B,H,hd,hd)
    (r"(^|/)[cnm]$", ("batch", "tp", None)),       # sLSTM (B,H,hd) / (B,H)
    (r".*", None),
]


def decode_state_shardings(state, mesh: DeviceMesh,
                           rules: Optional[ShardingRules] = None):
    """NamedSharding tree for a decode state (KV caches / rnn state)."""
    rules = rules or ShardingRules()

    def leaf(path, x):
        ndim = len(x.shape)
        for pat, roles in _STATE_RULES:
            if re.search(pat, path):
                if roles is None or ndim == 0:
                    return NamedSharding(mesh, ())
                r = tuple(roles)[:ndim]
                if len(r) < ndim:   # stacked scan dim(s) on the left
                    r = (None,) * (ndim - len(r)) + r
                parts = [rules.resolve(role, mesh) for role in r]
                return NamedSharding(mesh, _guarded(x.shape, parts, mesh))
        return NamedSharding(mesh, ())

    return _map_with_path(leaf, state)


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_sharding(mesh: DeviceMesh, ndim: int = 2,
                   rules: Optional[ShardingRules] = None) -> NamedSharding:
    """Inputs (B, S, ...) sharded on batch only."""
    rules = rules or ShardingRules()
    axes = rules.resolve("batch", mesh)
    return NamedSharding(mesh, (axes, *([None] * (ndim - 1))))


def distribute(tree, shardings):
    """The port's ``jax.device_put(x, s)`` over a tree: each tensor leaf
    becomes a DTensor with its sharding's placements (a leaf that requires
    grad stays one that does); ``int`` leaves stay ``int``."""
    def leaf(x, s: NamedSharding):
        if isinstance(x, int):
            return x
        out = distribute_tensor(x.detach(), s.mesh, s.placements)
        return out.requires_grad_(x.requires_grad)
    return tree_map(leaf, tree, shardings)
