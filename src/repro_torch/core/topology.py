"""Declarative cluster topology & placement, compiled for the predictors.

The paper validates on flat star topologies: one switch, homogeneous NICs,
each parameter server on its own node.  Real clusters have oversubscribed
rack fabrics, heterogeneous NICs, and parameter servers that are sharded
across nodes or colocated with workers.  This module makes that structure
first-class:

  * :class:`Node` — a machine with a NIC capacity and a compute speed
    factor, optionally inside a rack;
  * :class:`Rack` — a top-of-rack switch whose uplink to the core is
    oversubscribed by a ratio (or capped explicitly);
  * :class:`Placement` — PS shard -> node, including several shards on one
    node (sharding) and shards on worker nodes (colocation);
  * :class:`Topology` — the whole graph, with ``star()`` as the
    paper-faithful default factory.

Capacities are expressed in multiples of the *nominal* NIC bandwidth
(``Topology.bandwidth``, bytes/s), matching the share convention of
``repro_torch.core.bandwidth``.

A topology compiles down to:

  * ``resources()``     — the simulator's resource dict (star-compatible
    canonical names: ``downlink[:p]`` / ``uplink[:p]`` / ``ps[:p]``);
  * ``grouped_model()`` — a :class:`TopologyBandwidthModel`, i.e. max-min
    water-filling over the topology's capacity groups: per-link (home-node
    NIC), per-worker NIC, per-node shared NIC for colocated/sharded hosts,
    and per-rack-uplink (both directions);
  * ``bandwidth_model()`` — like ``grouped_model()``, but falling back to
    the paper's exact ``EqualShareModel`` / ``BandwidthModel`` when the
    topology is a plain star (so the default path stays bit-identical to
    the published rules);
  * ``worker_speeds()`` / ``res_speeds()`` — compute speed factors for the
    simulator's compute resources.

Modeling choices (documented, deliberate): rack fabrics are full-duplex
with one capacity per direction; NIC ports may be provisioned
asymmetrically per direction (``Node.nic_tx`` / ``Node.nic_rx``, defaulting
to the symmetric ``nic``).  Loopback transfers of a colocated shard
traverse the host's shared-NIC group by default (gRPC localhost serializes
through the stack; the conservative choice); ``Topology.loopback_bypass``
reroutes them onto a per-node loopback group at ``loopback_capacity``
multiples of the nominal NIC instead.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .bandwidth import BandwidthModel, Conn, EqualShareModel, _direction_of
from .events import ResourceSpec, ps_resources

__all__ = ["Node", "Rack", "Placement", "Topology", "TopologyBandwidthModel"]


@dataclass(frozen=True)
class Node:
    """One machine: NIC capacity and compute speed, both as factors of the
    platform nominal (1.0 = the profiled machine).

    ``nic`` is the symmetric capacity; ``nic_tx`` / ``nic_rx`` override it
    per physical direction (full-duplex ports with asymmetric provisioning,
    e.g. a 25/10 GbE access NIC), defaulting to ``nic`` when unset."""

    name: str
    nic: float = 1.0
    speed: float = 1.0
    rack: Optional[str] = None
    nic_tx: Optional[float] = None
    nic_rx: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("node needs a non-empty name")
        if self.nic <= 0:
            raise ValueError(
                f"node {self.name!r}: nic capacity must be > 0, got {self.nic}")
        for label, v in (("nic_tx", self.nic_tx), ("nic_rx", self.nic_rx)):
            if v is not None and v <= 0:
                raise ValueError(
                    f"node {self.name!r}: {label} capacity must be > 0, "
                    f"got {v}")
        if self.speed <= 0:
            raise ValueError(
                f"node {self.name!r}: compute speed must be > 0, got {self.speed}")

    @property
    def tx(self) -> float:
        """Transmit-direction capacity (falls back to the symmetric nic)."""
        return self.nic_tx if self.nic_tx is not None else self.nic

    @property
    def rx(self) -> float:
        """Receive-direction capacity (falls back to the symmetric nic)."""
        return self.nic_rx if self.nic_rx is not None else self.nic


@dataclass(frozen=True)
class Rack:
    """A top-of-rack switch.  ``oversubscription`` r >= 1 means the uplink
    to the core carries 1/r of the rack's aggregate NIC capacity;
    ``uplink_capacity`` (multiples of nominal) overrides the ratio."""

    name: str
    oversubscription: float = 1.0
    uplink_capacity: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("rack needs a non-empty name")
        if self.oversubscription < 1.0:
            raise ValueError(
                f"rack {self.name!r}: oversubscription must be >= 1 "
                f"(got {self.oversubscription}); use uplink_capacity for "
                f"over-provisioned fabrics")
        if self.uplink_capacity is not None and self.uplink_capacity <= 0:
            raise ValueError(
                f"rack {self.name!r}: uplink_capacity must be > 0")


@dataclass(frozen=True)
class Placement:
    """PS shard i lives on node ``shard_hosts[i]`` (a PS node or, for
    colocation, a worker node).  Several shards may share one host."""

    shard_hosts: Tuple[str, ...]

    def __post_init__(self):
        if not self.shard_hosts:
            raise ValueError("placement needs at least one PS shard host")


@dataclass(frozen=True)
class Topology:
    """The cluster graph.  Worker i (simulator index) runs on
    ``workers[i]``; PS shards are placed by ``placement`` (default: shard i
    on ``ps_nodes[i]``).  ``bandwidth`` is the nominal NIC rate in bytes/s
    (None = take the platform's at compile time)."""

    workers: Tuple[Node, ...]
    ps_nodes: Tuple[Node, ...] = ()
    racks: Tuple[Rack, ...] = ()
    placement: Optional[Placement] = None
    bandwidth: Optional[float] = None
    # Loopback bypass for colocated PS shards: transfers between a worker
    # and a shard hosted on its own node skip every NIC/rack capacity group
    # and ride a per-node loopback group instead (gRPC over localhost still
    # serializes through the stack — hence a finite ``loopback_capacity``
    # in multiples of the nominal NIC, not an infinite rate).  False keeps
    # the historical conservative model (loopback traverses the shared
    # NIC group).
    loopback_bypass: bool = False
    loopback_capacity: float = 8.0

    def __post_init__(self):
        object.__setattr__(self, "workers", tuple(self.workers))
        object.__setattr__(self, "ps_nodes", tuple(self.ps_nodes))
        object.__setattr__(self, "racks", tuple(self.racks))
        if not self.workers:
            raise ValueError("topology needs at least one worker node")
        if self.bandwidth is not None and self.bandwidth <= 0:
            raise ValueError(
                f"nominal bandwidth must be > 0, got {self.bandwidth}")
        if self.loopback_capacity <= 0:
            raise ValueError(
                f"loopback_capacity must be > 0, got "
                f"{self.loopback_capacity}")
        names: Set[str] = set()
        for n in self.workers + self.ps_nodes:
            if n.name in names:
                raise ValueError(f"duplicate node name {n.name!r}")
            names.add(n.name)
        rack_names = set()
        for r in self.racks:
            if r.name in rack_names:
                raise ValueError(f"duplicate rack name {r.name!r}")
            rack_names.add(r.name)
        for n in self.workers + self.ps_nodes:
            if n.rack is not None and n.rack not in rack_names:
                raise ValueError(
                    f"node {n.name!r} references unknown rack {n.rack!r}")
        if self.placement is None and not self.ps_nodes:
            raise ValueError(
                "unplaced parameter servers: provide ps_nodes or an "
                "explicit placement")
        for h in self._shard_hosts():
            if h not in names:
                raise ValueError(
                    f"PS shard placed on unknown node {h!r} "
                    f"(known nodes: {sorted(names)})")

    # ------------------------------------------------------------ structure

    def _shard_hosts(self) -> Tuple[str, ...]:
        if self.placement is not None:
            return self.placement.shard_hosts
        return tuple(n.name for n in self.ps_nodes)

    @property
    def num_workers(self) -> int:
        return len(self.workers)

    @property
    def num_shards(self) -> int:
        return len(self._shard_hosts())

    def shard_hosts(self) -> Tuple[str, ...]:
        """Host node name of every PS shard, in shard order (the explicit
        placement, or ``ps_nodes`` order when none was given)."""
        return self._shard_hosts()

    def node(self, name: str) -> Node:
        for n in self.workers + self.ps_nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def link_name(self, direction: str, shard: int) -> str:
        return direction if self.num_shards == 1 else f"{direction}:{shard}"

    def shard_host(self, shard: int) -> Node:
        return self.node(self._shard_hosts()[shard])

    def is_plain_star(self) -> bool:
        """True when the topology adds no structure beyond the paper's
        setting: no racks, homogeneous NICs, one dedicated node per shard."""
        if self.racks:
            return False
        if any(n.nic != 1.0 or n.tx != 1.0 or n.rx != 1.0
               for n in self.workers + self.ps_nodes):
            return False
        hosts = self._shard_hosts()
        worker_names = {n.name for n in self.workers}
        if any(h in worker_names for h in hosts):        # colocation
            return False
        return len(set(hosts)) == len(hosts)             # one shard per node

    # -------------------------------------------------------------- factories

    @classmethod
    def star(cls, num_workers: int, num_ps: int = 1,
             bandwidth: Optional[float] = None) -> "Topology":
        """The paper's flat topology: one switch, homogeneous nodes, each PS
        shard on its own dedicated node."""
        if num_workers < 1:
            raise ValueError(f"need >= 1 worker, got {num_workers}")
        if num_ps < 1:
            raise ValueError(f"need >= 1 parameter server, got {num_ps}")
        return cls(
            workers=tuple(Node(f"w{i}") for i in range(num_workers)),
            ps_nodes=tuple(Node(f"ps{p}") for p in range(num_ps)),
            bandwidth=bandwidth,
        )

    @classmethod
    def racked(cls, num_workers: int, num_ps: int = 1,
               racks: int = 2, oversubscription: float = 1.0,
               bandwidth: Optional[float] = None,
               worker_nic: float = 1.0, ps_nic: float = 1.0) -> "Topology":
        """Two-tier fabric: nodes spread round-robin over ``racks`` racks,
        each rack uplink oversubscribed by the given ratio."""
        rs = tuple(Rack(f"r{k}", oversubscription=oversubscription)
                   for k in range(racks))
        ws = tuple(Node(f"w{i}", nic=worker_nic, rack=f"r{i % racks}")
                   for i in range(num_workers))
        ps = tuple(Node(f"ps{p}", nic=ps_nic, rack=f"r{p % racks}")
                   for p in range(num_ps))
        return cls(workers=ws, ps_nodes=ps, racks=rs, bandwidth=bandwidth)

    def with_placement(self, shard_hosts: Sequence[str]) -> "Topology":
        return replace(self, placement=Placement(tuple(shard_hosts)))

    def with_node_speed(self, name: str, speed: float) -> "Topology":
        """Clone with node ``name``'s compute speed replaced — the
        straggler what-if: ``speed=0.5`` makes every compute op on that
        node take twice as long (both engines honor it)."""
        if speed <= 0:
            raise ValueError(
                f"node {name!r}: compute speed must be > 0, got {speed}")
        self.node(name)   # KeyError on unknown nodes, before any cloning

        def patch(nodes: Tuple[Node, ...]) -> Tuple[Node, ...]:
            return tuple(replace(n, speed=speed) if n.name == name else n
                         for n in nodes)
        return replace(self, workers=patch(self.workers),
                       ps_nodes=patch(self.ps_nodes))

    # ---------------------------------------------------------- compilation

    def resources(self, default_bandwidth: Optional[float] = None
                  ) -> Dict[str, ResourceSpec]:
        """The simulator's resource dict — identical names, order, and
        specs to ``events.ps_resources`` (heterogeneity lives in the
        bandwidth model's capacity groups, not in the per-link specs).

        An explicit ``Topology.bandwidth`` wins over ``default_bandwidth``
        (the platform's nominal rate) — the same precedence the cluster
        emulator applies, so predictions and ground truth always describe
        the same cluster."""
        bw = self.bandwidth if self.bandwidth is not None else default_bandwidth
        if bw is None:
            raise ValueError(
                "topology has no nominal bandwidth; pass default_bandwidth= "
                "to resources() or set Topology.bandwidth")
        return ps_resources(bw, self.num_shards)

    def rack_uplink_caps(self) -> Dict[str, Tuple[float, float]]:
        """(egress, ingress) fabric capacity per rack, in multiples of the
        nominal NIC bandwidth: the explicit ``uplink_capacity``, or the
        member nodes' aggregate per-direction NIC capacity divided by the
        oversubscription ratio.  Racks without members are omitted."""
        out: Dict[str, Tuple[float, float]] = {}
        for rack in self.racks:
            members = [n for n in self.workers + self.ps_nodes
                       if n.rack == rack.name]
            if not members:
                continue
            if rack.uplink_capacity is not None:
                out[rack.name] = (rack.uplink_capacity, rack.uplink_capacity)
            else:
                out[rack.name] = (
                    sum(n.tx for n in members) / rack.oversubscription,
                    sum(n.rx for n in members) / rack.oversubscription)
        return out

    def loopback_conns(self) -> Set[Tuple[int, str]]:
        """(worker, link) connections that never leave their host node: a
        worker talking to a PS shard colocated on its own machine.  Empty
        unless ``loopback_bypass`` is set."""
        if not self.loopback_bypass:
            return set()
        worker_idx = {n.name: i for i, n in enumerate(self.workers)}
        out: Set[Tuple[int, str]] = set()
        for p in range(self.num_shards):
            w = worker_idx.get(self.shard_host(p).name)
            if w is not None:
                out.add((w, self.link_name("downlink", p)))
                out.add((w, self.link_name("uplink", p)))
        return out

    def grouped_model(self) -> "TopologyBandwidthModel":
        return TopologyBandwidthModel(self)

    def bandwidth_model(self) -> BandwidthModel:
        """The cheapest model that is exact for this topology: the paper's
        published rules for a plain star, general water-filling otherwise."""
        if self.is_plain_star():
            return EqualShareModel() if self.num_shards == 1 \
                else BandwidthModel()
        return self.grouped_model()

    def worker_speeds(self) -> Dict[int, float]:
        """Worker index -> compute speed factor (only non-1.0 entries)."""
        return {i: n.speed for i, n in enumerate(self.workers)
                if n.speed != 1.0}

    def res_speeds(self) -> Dict[str, float]:
        """Compute resource name -> speed factor of its host node (PS
        update ops run where the shard lives; only non-1.0 entries)."""
        out: Dict[str, float] = {}
        for p in range(self.num_shards):
            host = self.shard_host(p)
            if host.speed != 1.0:
                out[self.link_name("ps", p)] = host.speed
        return out


class TopologyBandwidthModel(BandwidthModel):
    """Max-min water-filling over a topology's capacity groups.

    Groups, all in multiples of the nominal NIC bandwidth:

      * per active link resource: the shard host's NIC capacity — the
        direct generalization of the paper's per-PS-link constraint;
      * per (worker, direction): the worker node's NIC capacity;
      * per node hosting several link sources in one physical direction
        (multiple shards, or a shard colocated with a worker): one shared
        group at the node's NIC capacity, covering the shard links homed
        there plus the host worker's own transfers in that direction;
      * per rack and direction: the rack uplink, at aggregate member NIC
        capacity / oversubscription (or the explicit uplink capacity),
        covering every connection that crosses the rack boundary.

    For a plain star the group set degenerates to exactly the two-level
    {per-link, per-worker-NIC} structure of :class:`BandwidthModel`.
    """

    def __init__(self, topology: Topology):
        super().__init__()
        self.topology = topology
        M = topology.num_shards
        dl = [topology.link_name("downlink", p) for p in range(M)]
        ul = [topology.link_name("uplink", p) for p in range(M)]

        # per-link capacity = shard host NIC in the link's physical
        # direction (downlink: host transmits; uplink: host receives)
        self.link_caps: Dict[str, float] = {}
        for p in range(M):
            host = topology.shard_host(p)
            self.link_caps[dl[p]] = host.tx
            self.link_caps[ul[p]] = host.rx
        # per-(worker, direction) NIC capacity (uplink: worker transmits)
        self.worker_dir_caps: Dict[Tuple[int, str], float] = {}
        for i, n in enumerate(topology.workers):
            self.worker_dir_caps[(i, "uplink")] = n.tx
            self.worker_dir_caps[(i, "downlink")] = n.rx

        # loopback-bypass connections skip every NIC/rack group and ride a
        # per-host-node loopback group instead
        self.loopback_conns = frozenset(topology.loopback_conns())
        lb_by_node: Dict[str, List[Tuple[int, str]]] = {}
        if self.loopback_conns:
            wname = {i: n.name for i, n in enumerate(topology.workers)}
            for c in sorted(self.loopback_conns):
                lb_by_node.setdefault(wname[c[0]], []).append(c)
        self.loopback_groups: List[tuple] = [
            (("loopback", name), topology.loopback_capacity, frozenset(ms))
            for name, ms in lb_by_node.items()]
        # conn -> its node's loopback (key, cap), for conn_groups()
        self._loopback_of: Dict[Conn, tuple] = {}
        for key, cap, ms in self.loopback_groups:
            for c in ms:
                self._loopback_of[c] = (key, cap)

        # shared-NIC groups for nodes hosting >= 2 link sources per
        # direction (sharded PS hosts, colocated PS+worker)
        worker_idx = {n.name: i for i, n in enumerate(topology.workers)}
        hosted: Dict[str, List[int]] = {}
        for p in range(M):
            hosted.setdefault(topology.shard_host(p).name, []).append(p)
        # (key, capacity, frozenset of link names, worker index or None,
        #  worker-side direction) per physical direction of the node
        self.node_groups: List[tuple] = []
        for name, shards in hosted.items():
            w = worker_idx.get(name)
            if len(shards) < 2 and w is None:
                continue   # single dedicated shard: the link group suffices
            node = topology.node(name)
            tx_links = frozenset(dl[p] for p in shards)
            rx_links = frozenset(ul[p] for p in shards)
            self.node_groups.append(
                (("node", name, "tx"), node.tx, tx_links, w, "uplink"))
            self.node_groups.append(
                (("node", name, "rx"), node.rx, rx_links, w, "downlink"))

        # rack uplink groups: (key, per-direction capacities, member
        # workers, member links; direction handled dynamically in shares())
        self.rack_groups: List[tuple] = []
        rack_caps = topology.rack_uplink_caps()
        for rack in topology.racks:
            if rack.name not in rack_caps:
                continue
            member_nodes = [n for n in topology.workers + topology.ps_nodes
                            if n.rack == rack.name]
            rworkers = frozenset(worker_idx[n.name] for n in member_nodes
                                 if n.name in worker_idx)
            rlinks = frozenset(
                ln for p in range(M) for ln in (dl[p], ul[p])
                if topology.shard_host(p).rack == rack.name)
            self.rack_groups.append(
                (rack.name, rack_caps[rack.name], rworkers, rlinks))

    def conn_groups(self, conn: Conn) -> Tuple[Tuple[object, float], ...]:
        """All groups one connection rides, as ``(key, capacity)`` pairs —
        membership depends only on the connection identity, so the batch
        ``groups_for``/``shares`` (inherited, aggregated from here) and the
        incremental solver see identical structure.  Loopback-bypass
        connections skip every NIC/rack group and ride their host node's
        loopback group alone; unknown (pseudo-)workers — the emulator's
        background flows — fall back to the nominal NIC capacity."""
        w, r = conn
        lb = self._loopback_of.get(conn)
        if lb is not None:
            return (lb,)
        d = _direction_of(r)
        cap = self.worker_dir_caps.get((w, d))
        if cap is None:
            cap = self.worker_nic_capacity
        out = [(("link", r), self.link_caps.get(r, self.link_capacity)),
               (("nic", w, d), cap)]
        for key, gcap, links, w_host, w_dir in self.node_groups:
            if r in links or (w == w_host and d == w_dir):
                out.append((key, gcap))
        for rname, (cap_out, cap_in), rworkers, rlinks in self.rack_groups:
            # full duplex: one group per fabric direction.  A connection
            # crosses the rack iff exactly one endpoint is inside; it rides
            # the egress group if the transmitter is inside, the ingress
            # group if the receiver is.
            w_in = w in rworkers
            l_in = r in rlinks
            if w_in == l_in:
                continue                   # intra-rack or fully outside
            # downlink: shard host transmits; uplink: worker transmits
            tx_in = l_in if d == "downlink" else w_in
            if tx_in:
                out.append(((("rack", rname, "egress")), cap_out))
            else:
                out.append(((("rack", rname, "ingress")), cap_in))
        return tuple(out)
