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
``jax.device_put`` over a tree. Every move of a DTensor, a ``local_map``
region's inputs included (``map_local``), goes through ``redistribute``,
which slices before it gathers, as XLA's partitioner does, so that no rank
builds a tensor larger than the move's ends.
"""
from __future__ import annotations

import collections
import contextlib
import math
import re
import types
import weakref
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
    # (each rank attends over its keys, the partial softmaxes combined:
    # ``AttentionLayout.kv_seq``)
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


# ---------------------------------------------------------------------------
# Ordered redistribution
# ---------------------------------------------------------------------------


def _clean(cur: List[Placement], m: int, new: Placement,
           mesh_shape) -> bool:
    """Whether mesh dim ``m`` can go from ``cur[m]`` to ``new`` in one
    collective (or none): every tensor dim that the two shard is sharded on
    no later mesh dim of more than one rank. Shards of one tensor dim nest
    in mesh-dim order, so the innermost alone can be cut, gathered or
    swapped without moving the others' data."""
    dims = {p.dim for p in (cur[m], new) if type(p) is Shard}
    return not any(type(p) is Shard and p.dim in dims and n > 1
                   for p, n in zip(cur[m + 1:], mesh_shape[m + 1:]))


def _rank(p: Placement, q: Placement) -> int:
    """The order of a one-dim move ``p -> q``: slices (no communication),
    then pending sums (a reduce-scatter or an all-reduce), all-to-alls
    (size kept), gathers (size grows); anything else last."""
    if isinstance(p, Replicate) and type(q) is Shard:
        return 0
    if p.is_partial():
        return 1
    if type(p) is Shard:
        return 2 if type(q) is Shard else 3
    return 4


def _to_dim0(cur: List[Placement], m: int, shape, mesh_shape) -> bool:
    """Whether mesh dim ``m``'s shard of a dim other than 0 can move to dim
    0 in one all-to-all (a later gather there then needs no ``cat``, which
    on any other dim doubles the gathered bytes)."""
    if cur[m] == Shard(0) or not _clean(cur, m, Shard(0), mesh_shape):
        return False
    rows = shape[0] // math.prod(n for n, p in zip(mesh_shape, cur)
                                 if p == Shard(0))
    return rows % mesh_shape[m] == 0


def redistribution_plan(src, dst, shape, mesh_shape
                        ) -> List[Tuple[Placement, ...]]:
    """The placements after each step of :func:`redistribute` from ``src``
    to ``dst`` for a tensor of global ``shape`` on a mesh of ``mesh_shape``,
    one mesh dim a step: first every ``Replicate -> Shard`` (a local slice,
    outer mesh dims first), then each pending ``Partial`` (a reduce-scatter
    where ``dst`` shards, else an all-reduce, on the tensor already cut),
    then ``Shard(i) -> Shard(j)`` all-to-alls, then ``Shard -> Replicate``
    gathers (inner mesh dims first; a shard of a dim other than 0 first
    moves to dim 0 where it can, :func:`_to_dim0`). A step is taken only
    where it is one collective (:func:`_clean`), so no step's output is
    larger than the larger of the two ends' local shards.

    Where every move left is blocked by a later mesh dim sharding the same
    tensor dim (``(S0, S1) -> (S1, S0)``, ``(R, S0) -> (S0, S0)``), that
    mesh dim's shard first moves to a tensor dim that neither end shards
    and that it divides (an all-to-all), and back once the move is done.
    With no such dim the first move left runs as DTensor's own move of that
    one mesh dim, which gathers the shards nested inside it and cuts them
    again: DTensor's mesh order cannot be kept otherwise."""
    cur, dst = list(src), list(dst)
    sharded = {p.dim for p in cur + dst if type(p) is Shard}
    parked = set()      # mesh dims moved to a spare dim: they move last
    steps: List[Tuple[Placement, ...]] = []
    # a mesh dim of one rank moves no data: all such at once, first
    ones = [m for m, n in enumerate(mesh_shape) if n == 1 and cur[m] != dst[m]]
    if ones:
        for m in ones:
            cur[m] = dst[m]
        steps.append(tuple(cur))
    for _ in range(4 * len(cur)):
        pending = [m for m in range(len(cur)) if cur[m] != dst[m]]
        if not pending:
            return steps
        pending = [m for m in pending if m not in parked] or pending
        # gathers innermost first, every other move outermost first
        moves = sorted((r, -m if r == 3 else m, m) for m in pending
                       for r in [_rank(cur[m], dst[m])])
        clean = [(r, m) for r, _, m in moves
                 if _clean(cur, m, dst[m], mesh_shape)]
        first = moves[0][2]
        # the first move if it is clean, else a clean one that does not grow
        take = ([first] if clean and clean[0][1] == first
                else [m for r, m in clean if r <= 2])
        if take:
            m = take[0]
            if _rank(cur[m], dst[m]) == 3 and _to_dim0(cur, m, shape,
                                                       mesh_shape):
                # a gather on dim 0 needs no ``cat``: swap the shard there
                cur[m] = Shard(0)
            else:
                cur[m] = dst[m]
        else:
            dims = {p.dim for p in (cur[first], dst[first])
                    if type(p) is Shard}
            inner = max(i for i in range(first + 1, len(cur))
                        if type(cur[i]) is Shard and cur[i].dim in dims)
            spare = [d for d in range(len(shape)) if d not in sharded
                     and shape[d] % mesh_shape[inner] == 0]
            if spare:
                sharded.add(spare[0])
                parked.add(inner)
                cur[inner] = Shard(spare[0])
            else:
                m = clean[0][1] if clean else first
                cur[m] = dst[m]
        steps.append(tuple(cur))
    if cur != dst:          # no progress in the steps' bound: one call
        steps.append(tuple(dst))
    return steps


def _plain(placements) -> bool:
    return all(type(p) in (Shard, Replicate) or isinstance(p, Partial)
               for p in placements)


def _move(x: DTensor, placements: Tuple[Placement, ...]) -> DTensor:
    """``x`` moved to ``placements`` through :func:`redistribution_plan`'s
    steps, each a DTensor ``redistribute`` of one mesh dim. Placements that
    the plan does not know (a strided shard) move in one call."""
    placements = tuple(placements)
    if not (_plain(x.placements) and _plain(placements)):
        return x.redistribute(x.device_mesh, placements)
    steps = redistribution_plan(x.placements, placements, x.shape,
                                x.device_mesh.shape)
    for step in steps or [placements]:      # none: a new DTensor, as is
        x = x.redistribute(x.device_mesh, step)
    return x


class _Redistribute(torch.autograd.Function):
    """:func:`_move` forward, and :func:`_move` of the gradient back to the
    input's placements, a pending sum there given back replicated as
    DTensor's own ``redistribute`` gives it: the backward takes the same
    ordered steps from whatever placements the gradient arrives in."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.src = x.placements
        return _move(x, placements)

    @staticmethod
    def backward(ctx, g):
        want = tuple(Replicate() if p.is_partial() and not q.is_partial()
                     else p for p, q in zip(ctx.src, g.placements))
        return _move(g, want), None


def redistribute(x, placements):
    """A DTensor ``x`` moved to ``placements`` so that no rank builds a
    tensor larger than the larger of its input's and its output's local
    shards, in the forward and in the backward (:func:`redistribution_plan`;
    DTensor's one call gathers before it slices: an all-gather over one
    mesh dim of a tensor that another then cuts). Gathers and slices are
    exact and each pending sum is reduced over the same ranks, so the
    result is the one call's. As DTensor's own, a move to the placements
    ``x`` has still reduces a gradient that arrives as a pending sum where
    ``x`` has none (``shard`` of a residual already so laid out). Anything
    else passes through."""
    if not isinstance(x, DTensor):
        return x
    return _Redistribute.apply(x, tuple(placements))


def map_local(fn, out_placements, in_placements, mesh: DeviceMesh,
              in_grad_placements=None):
    """``local_map(fn, ...)`` whose DTensor inputs are first moved to their
    ``in_placements`` through :func:`redistribute`, so that ``local_map``
    moves nothing itself."""
    mapped = local_map(fn, out_placements=out_placements,
                       in_placements=in_placements,
                       in_grad_placements=in_grad_placements,
                       device_mesh=mesh, redistribute_inputs=False)

    def run(*args):
        return mapped(*(a if p is None or not isinstance(a, DTensor)
                        or a.placements == tuple(p) else redistribute(a, p)
                        for a, p in zip(args, in_placements)))
    return run


def layout_of(x, name: str) -> Optional[Tuple[Placement, ...]]:
    """The placements :func:`shard` moves a DTensor ``x`` to under the
    logical sharding ``name``, or None where it passes ``x`` through: no
    mesh current, not a DTensor, no spec for the name and rank, or a
    sharded dim that does not divide evenly."""
    mc = current_mesh()
    if mc is None or not isinstance(x, DTensor):
        return None
    spec = _spec_for(name, x.ndim, mc)
    if spec is None or not _divides(x.shape, spec, mc.mesh):
        return None
    return _placements(mc.mesh, spec)


def shard(x, name: str):
    """Annotate activation ``x`` with the logical sharding ``name``: a
    DTensor is redistributed to it (:func:`layout_of`), anything else
    passes through."""
    want = layout_of(x, name)
    return x if want is None else redistribute(x, want)


def placements_over(x, dim: int, role: str
                    ) -> Optional[Tuple[Placement, ...]]:
    """A DTensor ``x``'s placements with tensor dim ``dim`` sharded over
    ``role``'s mesh axes where x is replicated there, or None: anything
    else, a dim that does not divide, or a mesh axis already in use."""
    mc = current_mesh()
    if mc is None or not isinstance(x, DTensor):
        return None
    axes = mc.rules.resolve(role, mc.mesh)
    if not axes or x.shape[dim] % axes_size(mc.mesh, axes):
        return None
    placements = list(x.placements)
    for a in axes:
        i = list(mc.mesh.mesh_dim_names).index(a)
        if not isinstance(placements[i], Replicate):
            return None
        placements[i] = Shard(dim)
    return tuple(placements)


def shard_over(x, dim: int, role: str):
    """``x`` sliced to :func:`placements_over` (no data moves); anything
    it gives None for passes through."""
    placements = placements_over(x, dim, role)
    return x if placements is None else redistribute(x, placements)


@dataclass
class _Slice:
    """A saved DTensor kept as its rank's slice (:func:`saved_over`)."""
    part: DTensor
    whole: Tuple[Placement, ...]
    requires_grad: bool


def _even_slice(x, dims: Tuple[int, ...], role: str
                ) -> Optional[Tuple[Placement, ...]]:
    """:func:`placements_over` of the first of ``dims`` whose shards over
    every mesh dim would be even, or None."""
    for dim in dims:
        placements = placements_over(x, dim, role)
        if placements is not None and x.shape[dim] % math.prod(
                n for n, p in zip(x.device_mesh.shape, placements)
                if p == Shard(dim)) == 0:
            return placements
    return None


@contextlib.contextmanager
def saved_over(x, dims: Tuple[int, ...], role: str):
    """Within the block, autograd saves the DTensor ``x`` as its rank's
    slice over ``role``'s mesh axes of the first tensor dim of ``dims``
    that splits evenly (:func:`placements_over`: no data moves, a copy of
    1/n of x's local bytes) and gathers it back to x's placements when the
    saved tensor is unpacked. A checkpoint's input so saved is whole in the
    first forward and gathered once for the replay, as XLA keeps a scan's
    residuals. x itself is not held. Where no dim of ``dims`` splits
    evenly, x is saved as it is."""
    placements = _even_slice(x, dims, role)
    if placements is None:
        yield
        return
    ref = weakref.ref(x)

    def pack(t):
        if t is not ref():
            return t
        with torch.no_grad():
            part = redistribute(t, placements)
            if part._local_tensor._is_view():   # a slice of x's storage
                part = part.clone()
        return _Slice(part, tuple(t.placements), t.requires_grad)

    def unpack(saved):
        if not isinstance(saved, _Slice):
            return saved
        with torch.no_grad():
            t = redistribute(saved.part, saved.whole)
        return t.requires_grad_(saved.requires_grad)

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield


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


def gather_like(y, x, dim: int):
    """``y`` with its shards of tensor dim ``dim`` gathered on each mesh dim
    where the DTensor ``x`` is not sharded so (an all-gather); anything
    else passes through. Attention computed on q's sequence shards hands
    its output back so sharded, and the residual stream it joins keeps its
    own layout: torch 2.11's DTensor refuses the views that flatten a
    sharded sequence (the MoE's token groups)."""
    if not isinstance(y, DTensor) or not isinstance(x, DTensor):
        return y
    want = [Replicate() if p == Shard(dim) and px != p else p
            for p, px in zip(y.placements, x.placements)]
    if want == list(y.placements):
        return y
    return redistribute(y, want)


def reduce_partials(x):
    """``x`` with every pending (partial) sum reduced: a DTensor's
    ``Partial`` placements become ``Replicate()``, its shards stay; anything
    else passes through. An embedding over a vocab-sharded table leaves a
    masked partial sum, which DTensor cannot reduce in the same
    redistribution as a move of another mesh dim's shard."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return redistribute(x, [Replicate() if p.is_partial() else p
                            for p in x.placements])


def replicate_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` whole on every rank: a DTensor sharded
    there is redistributed to ``Replicate()`` on those mesh dims (an
    all-gather); anything else passes through. DTensor refuses to unbind or
    index a sharded dim, which the reference's ``scan`` over stacked
    parameters does."""
    if not isinstance(x, DTensor) or Shard(dim) not in x.placements:
        return x
    return redistribute(x, [Replicate() if p == Shard(dim) else p
                            for p in x.placements])


def move_shards_off(x, dim: int):
    """``x`` with tensor dim ``dim`` whole on every rank: each mesh dim
    that shards it moves its shard to the first other tensor dim that no
    mesh dim shards and that it divides (an all-to-all), else gathers it
    (an all-gather); anything else passes through. XLA so takes a stacked
    parameter sharded over its layers into its scan (starcoder2-7b
    ``decode_32k``: ``all-to-all.8``, the stacked ``mlp/wo`` from its
    layers to its d_ff over ``model``), where :func:`replicate_dim` would
    hold every layer's slice whole on each rank."""
    if not isinstance(x, DTensor) or Shard(dim) not in x.placements:
        return x
    placements = list(x.placements)
    for m, size in enumerate(x.device_mesh.shape):
        if placements[m] != Shard(dim):
            continue
        spare = [d for d in range(x.ndim) if d != dim
                 and Shard(d) not in placements and x.shape[d] % size == 0]
        placements[m] = Shard(spare[0]) if spare else Replicate()
    return redistribute(x, placements)


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
    row = redistribute(row, [Replicate() if p == Shard(dim) else p
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


@dataclass(frozen=True)
class AttentionLayout:
    """Where attention computes DTensors, and what a rank needs for its
    share under ``local_map``.

    ``q``: the placements of q and of the output; ``kv``: of k and v;
    ``kv_grad``: of k's and v's gradients, ``Partial()`` on each mesh dim
    where q is sharded and k, v are whole (a rank's gradient is then a
    partial sum). ``q_offset``: the key-space position of the rank's first
    query, ``(T - S) + index * S_local`` with ``index`` its sequence shard.
    ``kv_heads``: the (start, stop) of the kv heads of its local k, v that
    its q heads read under the global GQA map ``h // (H / Kv)``, or None
    for all of them. ``kv_seq``: the mesh dims on which k and v keep their
    sequence shards (the decode cache's), where each rank attends over its
    own keys and the ranks' partial softmaxes are combined."""

    q: Tuple[Placement, ...]
    kv: Tuple[Placement, ...]
    kv_grad: Tuple[Placement, ...]
    q_offset: int
    kv_heads: Optional[Tuple[int, int]] = None
    kv_seq: Tuple[int, ...] = ()

    def kv_slice(self, x: torch.Tensor) -> torch.Tensor:
        """A rank's local k or v (B, T, Kv, D) cut to ``kv_heads``."""
        if self.kv_heads is None:
            return x
        return x[:, :, self.kv_heads[0]:self.kv_heads[1]]


def attention_placements(q: DTensor, k: DTensor,
                         partial_softmax: bool = False) -> AttentionLayout:
    """The reference's attention layout (``_shard_q``, ``_shard_kv``) as XLA
    partitions it, per mesh dim in mesh order, ``split`` the product of the
    sizes already used on a tensor dim:

    * batch: q, k, v keep ``Shard(0)`` while the split divides B;
    * heads: q keeps ``Shard(2)`` while the split divides H and its local
      heads n and the group G = H / Kv nest (G % n or n % G is 0); k and v
      keep it too while the split divides Kv, else they are whole there and
      the rank reads the kv heads its q heads map to;
    * sequence: q keeps ``Shard(1)`` while the split divides S and the local
      length passes the flash kernel's block rule; k and v are whole. An S
      that does not divide stays replicated;
    * the keys' sequence: where k arrives sharded over its sequence and q
      is not (decode's one-token q over the ``kv_cache``), k and v keep
      ``Shard(1)`` and q is whole there (``kv_seq``): each rank attends
      over its own keys, as XLA attends over the cache where it lies.
      Only a core that combines partial softmaxes can (``partial_softmax``);
      for any other this raises, rather than gather the keys.

    Anything else computes replicated on that dim."""
    from repro_torch.kernels.flash_attention import fits_blocks
    mesh = q.device_mesh
    b, s, h = q.shape[:3]
    t, n_kv = k.shape[1], k.shape[2]
    group = h // n_kv
    coord = mesh.get_coordinate()
    split = {0: 1, 1: 1, 2: 1}
    kv_split, seq_index, head_index = 1, 0, 0
    whole = Replicate()
    pq: List[Placement] = []
    pkv: List[Placement] = []
    pgrad: List[Placement] = []
    kv_seq: List[int] = []
    for m, (size, p) in enumerate(zip(mesh.shape, q.placements)):
        if k.placements[m] == Shard(1) and p != Shard(1):
            if not partial_softmax:
                raise NotImplementedError(
                    f"k and v sharded over their sequence on mesh dim {m} "
                    "and q not (the decode cache's layout) need the plain "
                    "core's partial softmax")
            pq.append(whole)
            pkv.append(Shard(1))
            pgrad.append(Shard(1))
            kv_seq.append(m)
            continue
        d = p.dim if isinstance(p, Shard) else None
        n = split.get(d, 1) * size
        keep = False
        if d == 0:
            keep = b % n == 0
        elif d == 2 and h % n == 0:
            local = h // n
            keep = group % local == 0 or local % group == 0
        elif d == 1:
            keep = s % n == 0 and fits_blocks(s // n)
        if not keep:
            pq.append(whole)
            pkv.append(whole)
            pgrad.append(whole)
            continue
        split[d] = n
        pq.append(Shard(d))
        if d == 1:
            seq_index = seq_index * size + coord[m]
        if d == 2:
            head_index = head_index * size + coord[m]
        if d == 0 or (d == 2 and n_kv % n == 0):
            kv_split = n if d == 2 else kv_split
            pkv.append(Shard(d))
            pgrad.append(Shard(d))
        else:
            pkv.append(whole)
            pgrad.append(Partial())
    kv_heads = None
    if split[2] != kv_split:     # q's heads split further than k's and v's
        local = h // split[2]
        start = head_index % (split[2] // kv_split) * local // group
        kv_heads = (start, start + max(1, local // group))
    return AttentionLayout(tuple(pq), tuple(pkv), tuple(pgrad),
                           (t - s) + seq_index * (s // split[1]), kv_heads,
                           tuple(kv_seq))


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
    return map_local(fn, (placements,) * n_out, (placements,),
                     x.device_mesh)


def einsum_letters(eq: str, ndims) -> Tuple[List[str], str]:
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
    operands = [reduce_partials(constant_like(o, ref)) for o in operands]
    in_pl, out_pl, grad_pl = einsum_layout(eq, *operands)

    def local(*xs):
        return torch.einsum(eq, *xs).contiguous()

    local_map_calls["einsum"] += 1
    return map_local(local, out_pl, in_pl, ref.device_mesh,
                     grad_pl)(*operands)


def einsum_layout(eq: str, *operands: DTensor):
    """The placements :func:`einsum` runs ``eq`` in over DTensor
    ``operands`` (no pending sums): each operand's (tuples), the output's
    (a list, as ``local_map`` takes one output's) and each operand's
    gradient's (tuples)."""
    mesh = operands[0].device_mesh
    ins, out = einsum_letters(eq, [o.ndim for o in operands])
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
    return ([tuple(p) for p in in_pl], out_pl, [tuple(p) for p in grad_pl])


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
