"""Builds op-level step DAGs for PS training jobs from DNN layer tables.

The DAG structure mirrors the paper's Fig. 6: per layer i

    downlink_i ----> fwd_i ----> ... ----> bwd_i ----> uplink_i ----> update_i
                      ^                      ^
    fwd_{i-1} --------+       bwd_{i+1} -----+

All downlink ops are roots (TensorFlow requests every tensor at step start,
Fig. 8a).  Backward propagation runs in reverse layer order; each layer's
update is transmitted as soon as it is ready.

With ``num_ps > 1`` layers are assigned to parameter servers greedily by
current total byte size (paper §5, Fig. 23) and ops use per-PS resources.

``order`` controls downlink/uplink priorities for enforced-order scheduling
(§3.3): 'layer' (TIC order for sequential models: transmit layer 0 first),
'reverse', 'random', or 'profiled' (arbitrary arrival order, priority 0).

``sync`` selects the synchronization regime's op graph
(``repro_torch.core.syncmode``): PS modes (async/sync/ssp) share the Fig. 6 DAG
above (the barrier lives in the step controller, which gates every
``update_i`` of a global step on the k-of-n quorum at step granularity);
``allreduce`` drops the PS entirely — no downlink roots, each layer's
gradient moves through a collective phase (ring/tree, compiled onto the
topology by ``repro_torch.core.collectives``) followed by a local ``apply`` op
on the worker.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.collectives import allreduce_duration
from repro_torch.core.overhead import RecordedOp, RecordedStep
from repro_torch.core.paper_models import (DnnSpec, Platform,
                                           layer_compute_times)
from repro_torch.core.syncmode import SyncSpec


def assign_layers_greedy(dnn: DnnSpec, num_ps: int) -> List[int]:
    """Greedy layer -> PS assignment by smallest current total bytes (§5)."""
    totals = [0.0] * num_ps
    assignment = []
    for layer in dnn.layers:
        p = min(range(num_ps), key=lambda i: totals[i])
        assignment.append(p)
        totals[p] += layer.param_bytes
    return assignment


def ps_split_bytes(dnn: DnnSpec, num_ps: int,
                   assignment: Optional[Sequence[int]] = None) -> List[float]:
    if assignment is None:
        assignment = assign_layers_greedy(dnn, num_ps)
    totals = [0.0] * num_ps
    for layer, p in zip(dnn.layers, assignment):
        totals[p] += layer.param_bytes
    return totals


def build_job_step(dnn: DnnSpec, batch_size: int, platform: Platform,
                   num_ps: int = 1,
                   assignment: Optional[Sequence[int]] = None,
                   order: str = "layer",
                   seed: int = 0,
                   sync: Optional[SyncSpec] = None,
                   num_workers: int = 1,
                   topology=None) -> RecordedStep:
    """Noise-free recorded step for a training job (ideal profile).

    The emulator perturbs this with its own dynamics; the analytic form is
    used in unit tests and for what-if prediction without profiling.
    ``sync``/``num_workers``/``topology`` select the mode-aware op graph
    (the all-reduce DAG depends on the worker count and the topology's
    water-filled collective rates).
    """
    L = len(dnn.layers)
    if assignment is None:
        assignment = assign_layers_greedy(dnn, num_ps) if num_ps > 1 else [0] * L
    times = layer_compute_times(dnn, batch_size, platform)
    if sync is not None and sync.mode == "allreduce":
        return _build_allreduce_step(dnn, batch_size, platform, times, sync,
                                     num_workers, topology, order, seed)

    prio = _order_priorities(order, L, seed)

    def link(kind: str, p: int) -> str:
        return kind if num_ps == 1 else f"{kind}:{p}"

    def ps_res(p: int) -> str:
        return "ps" if num_ps == 1 else f"ps:{p}"

    ops: List[RecordedOp] = []
    idx: Dict[Tuple[str, int], int] = {}

    def add(op: RecordedOp, key: Tuple[str, int]) -> int:
        ops.append(op)
        idx[key] = len(ops) - 1
        return len(ops) - 1

    for i, layer in enumerate(dnn.layers):
        add(RecordedOp(name=f"down/{layer.name}", res=link("downlink", assignment[i]),
                       deps=(), size=layer.param_bytes, priority=prio[i],
                       tags={"layer": i}), ("down", i))
    for i, (lname, fwd, _bwd, _upd) in enumerate(times):
        deps = [idx[("down", i)]]
        if i > 0:
            deps.append(idx[("fwd", i - 1)])
        add(RecordedOp(name=f"fwd/{lname}", res="worker", deps=tuple(deps),
                       start=0.0, end=fwd, tags={"layer": i}), ("fwd", i))
    for i in range(L - 1, -1, -1):
        lname, _fwd, bwd, _upd = times[i]
        deps = [idx[("fwd", L - 1)]] if i == L - 1 else [idx[("bwd", i + 1)]]
        add(RecordedOp(name=f"bwd/{lname}", res="worker", deps=tuple(deps),
                       start=0.0, end=bwd, tags={"layer": i}), ("bwd", i))
    for i, layer in enumerate(dnn.layers):
        add(RecordedOp(name=f"up/{layer.name}", res=link("uplink", assignment[i]),
                       deps=(idx[("bwd", i)],), size=layer.param_bytes,
                       priority=prio[i], tags={"layer": i}), ("up", i))
        _lname, _fwd, _bwd, upd = times[i]
        add(RecordedOp(name=f"update/{layer.name}", res=ps_res(assignment[i]),
                       deps=(idx[("up", i)],), start=0.0, end=upd,
                       tags={"layer": i}), ("upd", i))

    return RecordedStep(ops=ops, meta={
        "dnn": dnn.name, "batch_size": batch_size, "platform": platform.name,
        "num_ps": num_ps, "order": order,
        "assignment": list(assignment),
    })


def _order_priorities(order: str, L: int, seed: int) -> List[int]:
    if order == "layer":
        return list(range(L))
    if order == "reverse":
        return list(range(L - 1, -1, -1))
    if order == "random":
        prio = list(range(L))
        random.Random(seed).shuffle(prio)
        return prio
    if order == "profiled":
        return [0] * L
    raise ValueError(f"unknown order {order!r}")


def _build_allreduce_step(dnn: DnnSpec, batch_size: int, platform: Platform,
                          times, sync: SyncSpec, num_workers: int, topology,
                          order: str, seed: int) -> RecordedStep:
    """Decentralized data-parallel step: fwd chain, bwd chain, per-layer
    gradient all-reduce (collective phase on the private ``collective``
    resource; duration water-filled over the topology), local optimizer
    apply on the worker.  No PS, no downlink roots — parameters are
    already replica-local."""
    L = len(dnn.layers)
    prio = _order_priorities(order, L, seed)
    bandwidth = platform.bandwidth
    if topology is not None and topology.bandwidth is not None:
        bandwidth = topology.bandwidth

    ops: List[RecordedOp] = []
    idx: Dict[Tuple[str, int], int] = {}

    def add(op: RecordedOp, key: Tuple[str, int]) -> int:
        ops.append(op)
        idx[key] = len(ops) - 1
        return len(ops) - 1

    for i, (lname, fwd, _bwd, _upd) in enumerate(times):
        deps = () if i == 0 else (idx[("fwd", i - 1)],)
        add(RecordedOp(name=f"fwd/{lname}", res="worker", deps=deps,
                       start=0.0, end=fwd, tags={"layer": i}), ("fwd", i))
    for i in range(L - 1, -1, -1):
        lname, _fwd, bwd, _upd = times[i]
        deps = (idx[("fwd", L - 1)],) if i == L - 1 else (idx[("bwd", i + 1)],)
        add(RecordedOp(name=f"bwd/{lname}", res="worker", deps=deps,
                       start=0.0, end=bwd, tags={"layer": i}), ("bwd", i))
    for i, layer in enumerate(dnn.layers):
        dur = allreduce_duration(layer.param_bytes, num_workers,
                                 sync.allreduce_algo, bandwidth,
                                 rtt=platform.rtt, topology=topology)
        add(RecordedOp(name=f"allreduce/{layer.name}", res="collective",
                       deps=(idx[("bwd", i)],), start=0.0, end=dur,
                       priority=prio[i],
                       tags={"layer": i, "collective": True}), ("coll", i))
        _lname, _fwd, _bwd, upd = times[i]
        add(RecordedOp(name=f"apply/{layer.name}", res="worker",
                       deps=(idx[("coll", i)],), start=0.0, end=upd,
                       tags={"layer": i}), ("apply", i))

    return RecordedStep(ops=ops, meta={
        "dnn": dnn.name, "batch_size": batch_size, "platform": platform.name,
        "num_ps": 0, "order": order, "sync_mode": "allreduce",
        "allreduce_algo": sync.allreduce_algo,
        "allreduce_workers": num_workers,
    })
