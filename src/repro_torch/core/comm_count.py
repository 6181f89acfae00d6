"""Collective accounting of a sharded step (PyTorch): the port of the
collective half of ``repro.core.hlo_analysis``.

The reference parses the partitioned HLO and sums, for each all-gather,
all-reduce, reduce-scatter, all-to-all and collective-permute, the per-device
ring wire bytes of its local output (``_wire_bytes``). Here the same ops are
the functional collectives that DTensor issues on each rank's local shards
(``torch.ops._c10d_functional``, and ``torch.ops._dtensor``'s all-to-all):
:class:`CollectiveMode` sees them below the DTensor layer, reads each one's
local output bytes and its process group's size, and applies the same ring
rules. A step traced on fake tensors over a fake process group
(``launch/dryrun.py``) issues the collectives a real step issues and moves
no data.

Kind names are the reference's: ``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all``, ``collective-permute``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the collectives' op packets by qualified name -> the reference's kind
_KINDS: Dict[str, str] = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
}


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    ops: List[Tuple[str, str, int, int]] = field(default_factory=list)
    # (kind, op name, bytes, multiplier)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, name: str, wire: int, mult: int = 1) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) \
            + wire * mult
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + mult
        self.ops.append((kind, name, wire, mult))


def _wire_bytes(kind: str, out_bytes: int, n: int) -> int:
    """Per-device ICI wire traffic for one collective, ring algorithms.

    HLO shapes in the partitioned module are PER-DEVICE; ``out_bytes`` is
    the op's local output size.  Ring traffic per device:
      all-reduce       2 * (n-1)/n * local         (local == out)
      all-gather       (n-1)/n * gathered          (gathered == out)
      reduce-scatter   (n-1)/n * unscattered = (n-1) * out
      all-to-all       (n-1)/n * out
      collective-permute  out
    """
    if n <= 1:
        return out_bytes if kind == "collective-permute" else 0
    f = (n - 1) / n
    if kind == "all-reduce":
        return int(2 * f * out_bytes)
    if kind == "all-gather":
        return int(f * out_bytes)
    if kind == "reduce-scatter":
        return int((n - 1) * out_bytes)
    if kind == "all-to-all":
        return int(f * out_bytes)
    return out_bytes  # collective-permute


def collective_kind(func) -> Optional[str]:
    """The reference's kind of a collective op overload, else None."""
    return _KINDS.get(func._overloadpacket._qualified_op_name)


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _group_size(args, kwargs) -> int:
    """Participants of the op's process group, named by its ``group_name``
    (a functional collective's last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in (*args, *kwargs.values()) if isinstance(a, str)]
    return _resolve_process_group(names[-1]).size()


def record(stats: CollectiveStats, func, args, kwargs, out) -> int:
    """Add ``func``'s collective to ``stats`` when it is one; returns its
    wire bytes (0 for any other op)."""
    kind = collective_kind(func)
    if kind is None:
        return 0
    wire = _wire_bytes(kind, _tensor_bytes(out), _group_size(args, kwargs))
    stats.add(kind, str(func), wire)
    return wire


class CollectiveMode(TorchDispatchMode):
    """Records every collective that runs on local tensors while active.

    An op on DTensors is handed back (``NotImplemented``) so that DTensor
    lowers it first: the mode then sees the local ops and the collectives
    they need, one rank's view."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        record(self.stats, func, args, kwargs, out)
        return out


def count_collectives(fn: Callable, *args, **kwargs) -> CollectiveStats:
    """The collectives of one call of ``fn(*args, **kwargs)``, by kind."""
    with CollectiveMode() as mode:
        fn(*args, **kwargs)
    return mode.stats
