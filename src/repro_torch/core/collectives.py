"""Decentralized collective algorithms compiled onto cluster topologies.

The paper predicts throughput for parameter-server training only; practice
is dominated by decentralized all-reduce (ring on bandwidth-bound clusters,
trees on latency-bound ones).  This module models both as *fluid phase
schedules* whose per-round rates come from the same max-min water-filling
over the topology's capacity groups (``bandwidth.waterfill``) that the PS
links use, so a rack uplink or an asymmetric NIC throttles a collective
exactly as it throttles a PS transfer.

Ring all-reduce (n workers, S bytes):

  * 2(n-1) rounds; every worker transmits S/n bytes per round to its ring
    successor, so the per-worker transfer volume is 2(n-1)/n * S — the
    textbook bandwidth-optimal figure (and a unit-test invariant);
  * the ring moves in lockstep, so the effective rate is the *minimum*
    water-filled share over the n simultaneous ring flows (each flow rides
    its transmitter's tx NIC, its receiver's rx NIC, and any rack fabric it
    crosses).

Binomial-tree all-reduce (reduce up + broadcast down):

  * 2*ceil(log2 n) rounds, each moving the full S bytes on the critical
    path — more bytes serialized than the ring, but far fewer rounds, so
    the tree wins when the per-round latency term (RTT) dominates (small
    tensors, large n);
  * each round is water-filled independently (its flow set differs), and
    the round's duration is governed by its slowest flow.

``repro_torch.core.syncmode`` turns these into per-layer collective ops of the
mode-aware step DAG; the resulting op durations are what the simulator
executes (collectives are private per-worker phases — all workers move
through them in lockstep under the step barrier, so no dynamic
link-sharing state is needed beyond the compiled rate).
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

from .bandwidth import waterfill

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (typing only)
    from .topology import Topology

ALGORITHMS = ("ring", "tree")

# A collective flow is (sender worker index, receiver worker index).
_Flow = Tuple[int, int]


def ring_volume(n: int, nbytes: float) -> float:
    """Per-worker transfer volume of a ring all-reduce: 2(n-1)/n * bytes."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * nbytes


def ring_rounds(n: int) -> int:
    """Rounds of a ring all-reduce: n-1 reduce-scatter + n-1 all-gather."""
    return 0 if n <= 1 else 2 * (n - 1)


def tree_rounds(n: int) -> int:
    """Rounds of a binomial-tree all-reduce: log2(n) up + log2(n) down."""
    return 0 if n <= 1 else 2 * math.ceil(math.log2(n))


def tree_serialized_bytes(n: int, nbytes: float) -> float:
    """Critical-path serialized bytes of the unpipelined tree (each round
    moves the full payload): rounds * bytes."""
    return tree_rounds(n) * nbytes


def ring_flows(n: int) -> List[_Flow]:
    """The ring's steady-state flow set: worker i transmits to i+1 mod n."""
    return [(i, (i + 1) % n) for i in range(n)]


def tree_round_flows(n: int) -> List[List[_Flow]]:
    """Per-round flow sets: binomial reduce (children -> parents, rounds of
    doubling stride) followed by the mirrored broadcast."""
    reduce_rounds: List[List[_Flow]] = []
    stride = 1
    while stride < n:
        flows = [(i, i - stride) for i in range(stride, n, 2 * stride)]
        reduce_rounds.append(flows)
        stride *= 2
    broadcast = [[(dst, src) for src, dst in flows]
                 for flows in reversed(reduce_rounds)]
    return reduce_rounds + broadcast


def collective_rounds(participants: List[int], nbytes: float,
                      algo: str) -> List[Tuple[List[_Flow], float]]:
    """Round schedule of one all-reduce over an explicit *membership* —
    ``[(flows, per_flow_bytes), ...]``, flows in participant ids.

    This is the live-flow form of the algorithms above: instead of
    compiling a fixed rate at DAG-build time, a fleet engine launches each
    round's flows into its shared waterfill and starts the next round when
    the current one drains.  Partial participation (herring-style k-of-n)
    falls out: pass whichever k members showed up and the schedule is the
    k-member collective.  Ring: 2(m-1) rounds of m flows moving
    ``nbytes/m`` each; tree: binomial reduce + mirrored broadcast, each
    round moving the full payload.
    """
    if algo not in ALGORITHMS:
        raise ValueError(
            f"unknown all-reduce algorithm {algo!r} "
            f"(expected one of {ALGORITHMS})")
    if nbytes < 0:
        raise ValueError(f"nbytes must be >= 0, got {nbytes}")
    members = sorted(set(participants))
    m = len(members)
    if m <= 1 or nbytes == 0:
        return []
    if algo == "ring":
        flows = [(members[i], members[(i + 1) % m]) for i in range(m)]
        return [(list(flows), nbytes / m)] * ring_rounds(m)
    return [([(members[s], members[d]) for s, d in flows], nbytes)
            for flows in tree_round_flows(m)]


def _round_rate_factor(topology: Optional["Topology"],
                       flows: List[_Flow]) -> float:
    """Water-filled rate (multiples of the nominal NIC bandwidth) of the
    slowest flow in one lockstep round.

    Groups: sender tx NIC, receiver rx NIC, and the rack fabric (egress at
    the sender's rack, ingress at the receiver's) for flows that cross a
    rack boundary.  Without a topology every flow runs at the nominal rate.
    """
    if topology is None or not flows:
        return 1.0
    workers = topology.workers
    caps: Dict[object, float] = {}
    members: Dict[object, list] = {}
    for f in flows:
        src, dst = f
        caps[("tx", src)] = workers[src].tx
        members.setdefault(("tx", src), []).append(f)
        caps[("rx", dst)] = workers[dst].rx
        members.setdefault(("rx", dst), []).append(f)
    rack_caps = topology.rack_uplink_caps()
    for f in flows:
        src, dst = f
        r_src, r_dst = workers[src].rack, workers[dst].rack
        if r_src == r_dst:
            continue
        if r_src in rack_caps:
            key = ("rack", r_src, "egress")
            caps[key] = rack_caps[r_src][0]
            members.setdefault(key, []).append(f)
        if r_dst in rack_caps:
            key = ("rack", r_dst, "ingress")
            caps[key] = rack_caps[r_dst][1]
            members.setdefault(key, []).append(f)
    shares = waterfill(flows, caps, members)
    return min(shares.values())


def ring_rate_factor(topology: Optional["Topology"], n: int) -> float:
    """Lockstep rate of the n-worker ring (multiples of nominal)."""
    if n <= 1:
        return 1.0
    _check_workers(topology, n)
    return _round_rate_factor(topology, ring_flows(n))


def tree_round_factors(topology: Optional["Topology"], n: int) -> List[float]:
    """Per-round lockstep rates of the binomial tree (multiples of
    nominal), reduce rounds first, then broadcast."""
    if n <= 1:
        return []
    _check_workers(topology, n)
    return [_round_rate_factor(topology, flows)
            for flows in tree_round_flows(n)]


def _check_workers(topology: Optional["Topology"], n: int) -> None:
    if topology is not None and n > topology.num_workers:
        raise ValueError(
            f"collective spans {n} workers but the topology defines only "
            f"{topology.num_workers} worker nodes")


def allreduce_duration(nbytes: float, n: int, algo: str, bandwidth: float,
                       rtt: float = 0.0,
                       topology: Optional["Topology"] = None) -> float:
    """Wall-clock seconds of one all-reduce of ``nbytes`` over ``n``
    workers: per-round transfer at the water-filled lockstep rate plus one
    RTT of per-round synchronization latency.
    """
    if algo not in ALGORITHMS:
        raise ValueError(
            f"unknown all-reduce algorithm {algo!r} "
            f"(expected one of {ALGORITHMS})")
    if bandwidth <= 0:
        raise ValueError(f"bandwidth must be > 0, got {bandwidth}")
    if n <= 1:
        return 0.0
    if algo == "ring":
        rate = bandwidth * ring_rate_factor(topology, n)
        return ring_rounds(n) * (nbytes / n / rate + rtt)
    total = 0.0
    for factor in tree_round_factors(topology, n):
        total += nbytes / (bandwidth * factor) + rtt
    return total
