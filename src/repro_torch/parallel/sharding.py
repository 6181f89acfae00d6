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

import collections
import math
import re
import types
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch.tree import tree_map

# The mesh context is the process's, not a thread's (the reference keeps a
# thread's): on CUDA the autograd engine runs the backward, and with it
# each remat group's recompute, on a thread of its own.
_ctx = types.SimpleNamespace(current=None)

# The regions run under ``local_map`` on DTensors, by name: one a call.
local_map_calls = collections.Counter()

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
    return _ctx.current


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


def shard_over(x, dim: int, role: str):
    """``x`` with tensor dim ``dim`` sharded over ``role``'s mesh axes: a
    DTensor replicated there is sliced (no data moves). Anything else, a
    dim that does not divide, or a mesh axis already in use passes
    through."""
    mc = current_mesh()
    if mc is None or not isinstance(x, DTensor):
        return x
    axes = mc.rules.resolve(role, mc.mesh)
    if not axes or x.shape[dim] % axes_size(mc.mesh, axes):
        return x
    placements = list(x.placements)
    for a in axes:
        i = list(mc.mesh.mesh_dim_names).index(a)
        if not isinstance(placements[i], Replicate):
            return x
        placements[i] = Shard(dim)
    return x.redistribute(mc.mesh, placements)


def constant_like(t: torch.Tensor, ref):
    """A constant ``t`` (positions, masks, RoPE tables: the same on every
    rank, no gradient) as a replicated DTensor on ``ref``'s mesh when
    ``ref`` is a DTensor, so that the two may meet in one op; else ``t``
    (a DTensor already included). The reference's constants are replicated
    arrays."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
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


def write_slot(cache: torch.Tensor, dim: int, index: torch.Tensor,
               row: torch.Tensor) -> torch.Tensor:
    """``cache.index_copy_(dim, index, row)`` for a one-element ``index``:
    ``row`` (size 1 on ``dim``) written in place at ``index``. A DTensor
    cache sharded on ``dim`` is written shard by shard: the rank whose
    shard holds the slot writes it, the others rewrite what they hold.
    DTensor's own ``index_copy_`` there would write into a replicated copy
    and relabel the cache as replicated over its unchanged shard."""
    if not isinstance(cache, DTensor) or Shard(dim) not in cache.placements:
        return cache.index_copy_(dim, index, row)
    mesh, placements = cache.device_mesh, cache.placements
    row = row.redistribute(mesh, [Replicate() if p == Shard(dim) else p
                                  for p in placements]).to_local()
    index = index.full_tensor() if isinstance(index, DTensor) else index
    local = cache.to_local()
    n, offset = local.shape[dim], 0
    for size, coord, p in zip(mesh.shape, mesh.get_coordinate(), placements):
        if p == Shard(dim):    # shards nest in mesh-dim order, evenly
            offset = offset * size + coord
    at = index - offset * n
    here = ((at >= 0) & (at < n)).view(*[1] * row.dim())
    at = at.clamp(0, n - 1)
    local.index_copy_(dim, at, torch.where(here, row,
                                           local.index_select(dim, at)))
    return cache


def attention_placements(q: DTensor, k: DTensor) -> tuple:
    """Where attention computes DTensors: on each mesh dim, q's own shard
    of batch or heads, else replicated. A dim keeps its shard only while
    the product of the sizes sharding batch divides B, and of those sharding
    heads divides both H and Kv."""
    extent = {0: q.shape[0], 2: math.gcd(q.shape[2], k.shape[2])}
    split = {0: 1, 2: 1}
    out = []
    for size, p in zip(q.device_mesh.shape, q.placements):
        d = p.dim if isinstance(p, Shard) else None
        if d in extent and extent[d] % (split[d] * size) == 0:
            split[d] *= size
            out.append(Shard(d))
        else:
            out.append(Replicate())
    return tuple(out)


def on_group_shards(fn, x: DTensor, n_out: int):
    """``fn`` of a DTensor ``x`` whose dim 0 indexes independent groups
    (MoE routing), run by each rank on its own groups: ``x`` keeps its
    dim-0 shards where they divide and is whole elsewhere, and ``fn``'s
    ``n_out`` outputs come back laid out so. DTensor cannot flatten the
    sharded dims that the routing's reshapes meet."""
    split, placements = 1, []
    for size, p in zip(x.device_mesh.shape, x.placements):
        keep = p == Shard(0) and x.shape[0] % (split * size) == 0
        split *= size if keep else 1
        placements.append(Shard(0) if keep else Replicate())
    local_map_calls["group shards"] += 1
    return local_map(fn, out_placements=(placements,) * n_out,
                     in_placements=(placements,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)


def _letters(eq: str, ndims) -> Tuple[List[str], str]:
    """``eq``'s operand and output subscripts with every ``...`` spelled
    out in capitals (broadcast dims align on the right, as in einsum)."""
    lhs, out = eq.replace(" ", "").split("->")
    ins = lhs.split(",")
    k = [n - len(t.replace("...", "")) for t, n in zip(ins, ndims)]
    ell = "".join(chr(ord("A") + i) for i in range(max(k)))
    return ([t.replace("...", ell[len(ell) - j:]) for t, j in zip(ins, k)],
            out.replace("...", ell))


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; over DTensors each rank runs it on its own shards.

    DTensor lowers an einsum to views around a ``bmm`` and cannot flatten
    or split a sharded dim there (torch 2.11 refuses; torch 2.13 shards
    strided). Here the layout is chosen per mesh dim, as XLA's SPMD
    partitioner chooses it, and the local einsum runs under ``local_map``:
    the first subscript that an operand shards and the output keeps is
    kept (operands without it are gathered there, which is the FSDP
    all-gather of a weight), else a contracted subscript that an operand
    shards gives a partial sum. The gradient of an operand without the
    kept subscript is a partial sum over that mesh dim."""
    if not any(isinstance(o, DTensor) for o in operands):
        return torch.einsum(eq, *operands)
    ref = next(o for o in operands if isinstance(o, DTensor))
    mesh = ref.device_mesh
    operands = [reduce_partials(constant_like(o, ref)) for o in operands]
    ins, out = _letters(eq, [o.ndim for o in operands])
    size = {c: d for t, o in zip(ins, operands) for c, d in zip(t, o.shape)}
    split = dict.fromkeys(size, 1)
    whole = Replicate()
    in_pl = [[whole] * mesh.ndim for _ in operands]
    grad_pl = [[whole] * mesh.ndim for _ in operands]
    out_pl: List[Placement] = [whole] * mesh.ndim
    for m, n in enumerate(mesh.shape):
        held = [t[o.placements[m].dim] for t, o in zip(ins, operands)
                if isinstance(o.placements[m], Shard)]
        ok = [c for c in held if size[c] % (split[c] * n) == 0]
        keep = [c for c in ok if c in out] or ok
        if not keep:
            continue
        c = keep[0]
        split[c] *= n
        out_pl[m] = Shard(out.index(c)) if c in out else Partial()
        for i, t in enumerate(ins):
            in_pl[i][m] = Shard(t.index(c)) if c in t else whole
            grad_pl[i][m] = in_pl[i][m] if c in t else Partial()

    def local(*xs):
        return torch.einsum(eq, *xs).contiguous()

    local_map_calls["einsum"] += 1
    return local_map(local, out_placements=out_pl,
                     in_placements=[tuple(p) for p in in_pl],
                     in_grad_placements=[tuple(p) for p in grad_pl],
                     device_mesh=mesh, redistribute_inputs=True)(*operands)


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
