"""Bandwidth-sharing models (paper §3.1 and §5), generalized to topologies.

Single PS (§3.1): each of the ``n`` workers actively transmitting or
receiving gets ``1/n`` of the link in that direction; compute resources are
private (share = 1).

Two PS (§5): all active connections to the same PS share its bandwidth
equally, but a worker's NIC caps its total share per direction: a worker
alone on PS1 while sharing PS2 with n-1 others gets 1/n on PS2 and at most
1 - 1/n on PS1.

We implement the general **max-min water-filling** allocation over an
arbitrary set of *capacity groups* — each group caps the total share of its
member connections.  The classic two-level structure {per-PS-link,
per-worker-NIC} is just one choice of groups; a rack uplink, a colocated
PS/worker NIC, or a heterogeneous 10 GbE port is simply another group with
another capacity (see ``repro_torch.core.topology``).  The allocation reduces
exactly to both paper rules:

  * one PS, n active workers -> PS capacity saturates first -> 1/n each;
  * the §5 example -> PS2 conns freeze at 1/n, then the lone PS1 conn rises
    until the worker NIC saturates at 1 - 1/n.

Shares are expressed in multiples of the *nominal* link bandwidth B, so a
capacity of 1.0 means "one nominal NIC" and 2.0 models a double-speed port.

The solver works per **connected component** of the constraint hypergraph
(connections coupled through shared groups), in a canonical order (sorted
connections, sorted member lists), so that the batch solve of any subset of
components is bit-identical to the same components' slice of a full batch
solve.  :class:`IncrementalWaterfill` builds on that invariant: it caches
the allocation across connection arrivals/departures and re-solves only the
component(s) whose membership changed, staying exactly equal — float for
float — to what ``waterfill`` would return from scratch (ratified by the
differential harness in ``tests/test_waterfill_incremental.py`` and, when
``REPRO_CHECK_WATERFILL=1``, cross-validated on every step).
"""
from __future__ import annotations

import os
from typing import (Callable, Dict, FrozenSet, List, Mapping, Optional,
                    Sequence, Set, Tuple)

import numpy as np

# A connection is (worker, link_resource_name); shares are fractions of the
# nominal link bandwidth B.
Conn = Tuple[int, str]

_SAT_EPS = 1e-12


def _direction_of(res_name: str) -> str:
    return res_name.split(":")[0]  # 'downlink' / 'uplink' (index stripped)


def _fill(conns: Sequence[Conn],
          caps: Mapping[object, float],
          members: Mapping[object, Sequence[Conn]],
          weights: Optional[Mapping[Conn, float]],
          ) -> Dict[Conn, float]:
    """Progressive filling over ONE connected component.

    Raise unfrozen conns until some group saturates; freeze its members;
    repeat — at most ``len(caps)`` rounds since each round freezes a group.
    The arithmetic is the historical global loop applied to a component;
    callers must pass canonical inputs (sorted conns, sorted member lists)
    so that repeated solves of the same component are bit-identical.
    """
    share: Dict[Conn, float] = {c: 0.0 for c in conns}
    frozen: Set[Conn] = set()
    remaining_cap = dict(caps)
    for _ in range(len(caps) + 1):
        unfrozen = [c for c in conns if c not in frozen]
        if not unfrozen:
            break
        # headroom per group divided by its unfrozen member count/weight
        best_delta = None
        denoms: Dict[object, float] = {}
        for key, ms in members.items():
            if weights is None:
                denom = sum(1 for c in ms if c not in frozen)
            else:
                denom = sum(weights[c] for c in ms if c not in frozen)
            denoms[key] = denom
            if not denom:
                continue
            delta = remaining_cap[key] / denom
            if best_delta is None or delta < best_delta:
                best_delta = delta
        if best_delta is None:
            break
        # apply the raise
        if weights is None:
            for c in unfrozen:
                share[c] += best_delta
        else:
            for c in unfrozen:
                share[c] += best_delta * weights[c]
        for key, denom in denoms.items():
            remaining_cap[key] -= best_delta * denom
        # freeze members of (now) saturated groups
        for key, ms in members.items():
            if remaining_cap[key] <= _SAT_EPS * max(1.0, caps[key]):
                for c in ms:
                    frozen.add(c)
    return share


def _components(conns: Sequence[Conn],
                members: Mapping[object, Sequence[Conn]],
                ) -> List[Tuple[Set[Conn], List[object]]]:
    """Partition connections into connected components of the constraint
    hypergraph: two connections are coupled iff some group contains both
    (directly or transitively).  Returns ``(component_conns, group_keys)``
    pairs; the allocation of one component is independent of the others."""
    gof: Dict[Conn, List[object]] = {}
    for key, ms in members.items():
        for c in ms:
            gof.setdefault(c, []).append(key)
    comps: List[Tuple[Set[Conn], List[object]]] = []
    visited: Set[Conn] = set()
    for c0 in conns:
        if c0 in visited:
            continue
        visited.add(c0)
        comp = {c0}
        keys: List[object] = []
        seen_keys: Set[object] = set()
        stack = [c0]
        while stack:
            c = stack.pop()
            for key in gof.get(c, ()):
                if key in seen_keys:
                    continue
                seen_keys.add(key)
                keys.append(key)
                for m in members[key]:
                    if m not in visited:
                        visited.add(m)
                        comp.add(m)
                        stack.append(m)
        comps.append((comp, keys))
    return comps


def waterfill(conns: Sequence[Conn],
              caps: Mapping[object, float],
              members: Mapping[object, Sequence[Conn]],
              weights: Optional[Mapping[Conn, float]] = None,
              ) -> Dict[Conn, float]:
    """Max-min progressive filling over arbitrary capacity groups.

    ``caps[k]`` bounds the total share of ``members[k]``; every connection
    should belong to at least one group (an unconstrained connection would
    absorb the whole raise loop).  With ``weights``, shares rise in
    proportion to each connection's weight (weighted max-min).

    The problem decomposes over connected components of the constraint
    hypergraph and each component is solved in canonical order (sorted
    connections / member lists), which makes the output independent of the
    caller's connection ordering and bit-identical to
    :class:`IncrementalWaterfill`'s cached allocation of the same state.
    """
    covered: Set[Conn] = set()
    for ms in members.values():
        covered.update(ms)
    for c in conns:
        if c not in covered:
            # an unconstrained connection would absorb the whole raise
            # loop and come back with a meaningless share — fail loudly
            raise ValueError(
                f"connection {c!r} belongs to no capacity group; every "
                f"connection needs at least one (its link's, typically)")
    share: Dict[Conn, float] = {}
    for comp, keys in _components(conns, members):
        comp_conns = sorted(comp)
        comp_caps = {k: caps[k] for k in keys}
        comp_members = {k: sorted(set(members[k])) for k in keys}
        share.update(_fill(comp_conns, comp_caps, comp_members, weights))
    return share


# ---------------------------------------------------------------------------
# batched waterfill: stacked-array surrogate for scoring many problems at once
# ---------------------------------------------------------------------------


def stack_waterfill_problems(problems: Sequence[tuple]
                             ) -> Tuple[List[list], np.ndarray, np.ndarray,
                                        np.ndarray]:
    """Pad independent waterfill problems into one stacked array problem.

    ``problems`` is a sequence of ``(conns, caps, members)`` or ``(conns,
    caps, members, weights)`` tuples exactly as :func:`waterfill` takes
    them (e.g. straight from ``model.groups_for(conns)``).  Returns
    ``(conn_lists, caps, members, weights)`` for :func:`batched_waterfill`:
    ``conn_lists[b][j]`` names the connection behind column ``j`` of row
    ``b``; group rows are padded with infinite-capacity empty groups and
    connection columns with zero-weight phantoms, both of which the
    batched solver provably ignores.
    """
    B = len(problems)
    if B == 0:
        raise ValueError("stack_waterfill_problems needs >= 1 problem")
    C = max(len(p[0]) for p in problems)
    G = max(len(p[1]) for p in problems)
    caps = np.full((B, G), np.inf)
    members = np.zeros((B, G, C), bool)
    weights = np.zeros((B, C))
    conn_lists: List[list] = []
    for b, prob in enumerate(problems):
        conns, pcaps, pmembers = prob[0], prob[1], prob[2]
        pweights = prob[3] if len(prob) > 3 else None
        col = {c: j for j, c in enumerate(conns)}
        conn_lists.append(list(conns))
        for j, c in enumerate(conns):
            weights[b, j] = 1.0 if pweights is None else pweights[c]
        for g, (key, cap) in enumerate(pcaps.items()):
            caps[b, g] = cap
            for c in pmembers[key]:
                members[b, g, col[c]] = True
        uncovered = ~members[b, :, :len(conns)].any(axis=0)
        if uncovered.any():
            c = conns[int(np.nonzero(uncovered)[0][0])]
            raise ValueError(
                f"problem {b}: connection {c!r} belongs to no capacity "
                f"group; every connection needs at least one (its link's, "
                f"typically)")
    return conn_lists, caps, members, weights


def _batched_fill_np(caps: np.ndarray, members: np.ndarray,
                     weights: np.ndarray) -> np.ndarray:
    """Vectorized progressive filling over ``B`` stacked problems.

    The same raise/freeze loop as :func:`_fill`, advanced for all rows in
    lockstep: each round raises every unfrozen connection by its row's
    bottleneck headroom and freezes the members of newly saturated
    groups.  At most ``G`` rounds freeze a group per row, so ``G + 1``
    iterations always suffice; finished rows (no unsaturated group with
    unfrozen members) degenerate to no-ops.
    """
    B, G, C = members.shape
    mem_f = members.astype(np.float64)
    share = np.zeros((B, C))
    frozen = np.zeros((B, C), bool)
    rem = caps.astype(np.float64).copy()
    capfloor = _SAT_EPS * np.maximum(1.0, caps)
    for _ in range(G + 1):
        wu = np.where(frozen, 0.0, weights)
        denom = np.einsum("bgc,bc->bg", mem_f, wu)
        ok = denom > 0.0
        if not ok.any():
            break
        with np.errstate(divide="ignore", invalid="ignore"):
            delta_g = np.where(ok, rem / np.where(ok, denom, 1.0), np.inf)
        delta = delta_g.min(axis=1)
        d = np.where(np.isfinite(delta), delta, 0.0)
        share += d[:, None] * wu
        rem -= d[:, None] * denom
        sat = rem <= capfloor
        frozen |= (members & sat[:, :, None]).any(axis=1)
    return share


def _batched_fill_torch(caps: np.ndarray, members: np.ndarray,
                        weights: np.ndarray, device: str) -> np.ndarray:
    """:func:`_batched_fill_np` as float64 tensor ops on ``device``.

    The loop runs its full ``G + 1`` rounds (a finished row raises by 0),
    so the device never waits on the host for an early exit."""
    import torch
    cap = torch.as_tensor(caps, dtype=torch.float64, device=device)
    mem = torch.as_tensor(members, device=device)
    mem_f = mem.to(torch.float64)
    wt = torch.as_tensor(weights, dtype=torch.float64, device=device)
    B, G, C = mem.shape
    share = torch.zeros((B, C), dtype=torch.float64, device=device)
    frozen = torch.zeros((B, C), dtype=torch.bool, device=device)
    rem = cap.clone()
    capfloor = _SAT_EPS * torch.clamp(cap, min=1.0)
    for _ in range(G + 1):
        wu = torch.where(frozen, 0.0, wt)
        denom = torch.bmm(mem_f, wu.unsqueeze(-1)).squeeze(-1)
        ok = denom > 0.0
        delta_g = torch.where(ok, rem / torch.where(ok, denom, 1.0),
                              torch.inf)
        delta = delta_g.amin(dim=1)
        d = torch.where(torch.isfinite(delta), delta, 0.0)
        share += d[:, None] * wu
        rem -= d[:, None] * denom
        sat = rem <= capfloor
        frozen |= (mem & sat[:, :, None]).any(dim=1)
    return share.cpu().numpy()


def batched_waterfill(caps: np.ndarray, members: np.ndarray,
                      weights: Optional[np.ndarray] = None,
                      backend: str = "numpy",
                      device: str = "cuda") -> np.ndarray:
    """Max-min progressive filling over ``B`` stacked group problems.

    Array form of :func:`waterfill` for scoring many *independent*
    problems at once (placement-search surrogate pruning, fleet
    what-ifs): ``caps[b, g]`` caps group ``g`` of problem ``b``,
    ``members[b, g, c]`` marks connection column ``c`` as a member, and
    the result ``[B, C]`` holds each connection's share.  Build the
    stacked inputs with :func:`stack_waterfill_problems`.

    ``backend="numpy"`` (default) runs the vectorized raise/freeze loop
    in float64; it matches :func:`waterfill` to float-accumulation
    tolerance (the scalar solver raises each connected component with its
    own delta sequence, the batched one with the row-global bottleneck —
    identical allocations in exact arithmetic, ~1e-12 relative in
    floats).  ``backend="torch"`` runs the same arithmetic as batched
    float64 tensor ops on ``device`` (the card unless the caller asks for
    ``"cpu"``); treat its output as a *scoring surrogate* with ~1e-4
    relative tolerance, never as the bit-exact allocator
    (:class:`IncrementalWaterfill` remains that).
    """
    if backend not in ("numpy", "torch"):
        raise ValueError(
            f"unknown backend {backend!r} (expected 'numpy' or 'torch')")
    caps = np.asarray(caps, np.float64)
    members = np.asarray(members, bool)
    if members.ndim != 3 or caps.shape != members.shape[:2]:
        raise ValueError(
            f"shape mismatch: caps {caps.shape} vs members {members.shape} "
            f"(want caps [B, G], members [B, G, C])")
    if weights is None:
        weights = np.ones((members.shape[0], members.shape[2]))
    weights = np.asarray(weights, np.float64)
    if weights.shape != (members.shape[0], members.shape[2]):
        raise ValueError(
            f"weights shape {weights.shape} != [B, C] "
            f"{(members.shape[0], members.shape[2])}")
    if backend == "torch":
        return _batched_fill_torch(caps, members, weights, device)
    return _batched_fill_np(caps, members, weights)


class BandwidthModel:
    """Max-min fair shares under per-link and per-worker-NIC capacity.

    The two-level special case with homogeneous capacities — the
    paper-§5-faithful model for flat multi-PS clusters.  Heterogeneous or
    nested constraints use :class:`GroupedBandwidthModel` (explicit group
    data) or ``topology.TopologyBandwidthModel`` (compiled from a cluster
    graph).

    Group structure is defined per connection by :meth:`conn_groups` —
    the contract :class:`IncrementalWaterfill` builds on — and the batch
    ``groups_for``/``shares`` are derived from it, so the incremental and
    batch solvers always see identical groups."""

    def __init__(self, worker_nic_capacity: float = 1.0,
                 link_capacity: float = 1.0):
        self.worker_nic_capacity = worker_nic_capacity
        self.link_capacity = link_capacity

    def conn_groups(self, conn: Conn) -> Tuple[Tuple[object, float], ...]:
        """The capacity groups one connection belongs to, as ``(key,
        capacity)`` pairs.  Membership must depend only on the connection
        identity — never on which other connections are active — so the
        incremental solver can maintain group state across arrivals."""
        w, r = conn
        return ((("link", r), self.link_capacity),
                (("nic", w, _direction_of(r)), self.worker_nic_capacity))

    def link_group_key(self, res_name: str) -> object:
        """The capacity-group key that caps one link resource — the handle
        fault injection uses to scale a degraded link's capacity through
        :meth:`IncrementalWaterfill.set_scale`."""
        return ("link", res_name)

    def groups_for(self, conns: Sequence[Conn]
                   ) -> Tuple[Dict[object, float], Dict[object, list]]:
        """Caps/members over an explicit connection list, aggregated from
        :meth:`conn_groups` (one source of truth for both solvers)."""
        caps: Dict[object, float] = {}
        members: Dict[object, list] = {}
        for c in conns:
            for key, cap in self.conn_groups(c):
                ms = members.get(key)
                if ms is None:
                    caps[key] = cap
                    members[key] = [c]
                else:
                    ms.append(c)
        return caps, members

    def shares(self, active: Mapping[str, Set[int]]) -> Dict[Conn, float]:
        """``active`` maps link resource name -> set of active workers.

        Returns share in (0, 1] for every active connection.
        """
        conns = [(w, r) for r, ws in active.items() for w in ws]
        if not conns:
            return {}
        caps, members = self.groups_for(conns)
        return waterfill(conns, caps, members)


class GroupedBandwidthModel(BandwidthModel):
    """Water-filling over an explicit group set.

    ``link_caps``   : link resource name -> capacity (home-node NIC side);
    ``worker_caps`` : worker index -> NIC capacity (both directions);
    ``extra_groups``: sequence of ``(key, capacity, members)`` where
    ``members`` is a frozenset of either link resource names or full
    ``(worker, link)`` connections — a rack uplink, a shared colocated NIC,
    any nested constraint.  Unlisted links/workers default to capacity 1.0,
    so the empty model is exactly :class:`BandwidthModel`.
    """

    def __init__(self, link_caps: Optional[Mapping[str, float]] = None,
                 worker_caps: Optional[Mapping[int, float]] = None,
                 extra_groups: Sequence[tuple] = ()):
        super().__init__()
        self.link_caps = dict(link_caps or {})
        self.worker_caps = dict(worker_caps or {})
        self.extra_groups = tuple(extra_groups)

    def conn_groups(self, conn: Conn) -> Tuple[Tuple[object, float], ...]:
        w, r = conn
        out = [(("link", r), self.link_caps.get(r, self.link_capacity)),
               (("nic", w, _direction_of(r)),
                self.worker_caps.get(w, self.worker_nic_capacity))]
        for key, cap, group_members in self.extra_groups:
            if conn in group_members or r in group_members:
                out.append((("grp", key), cap))
        return tuple(out)


class EqualShareModel(BandwidthModel):
    """The single-PS paper model (§3.1): share = 1/n on each link,
    ignoring NIC coupling entirely. Kept as the paper-faithful default for
    1-PS simulations (identical results to water-filling there, but cheaper
    and exactly the published rule)."""

    def conn_groups(self, conn: Conn) -> Tuple[Tuple[object, float], ...]:
        # link-only groups: water-filling over them is the equal split
        # (the simulator's uniform path never takes this route, but the
        # contract holds for completeness)
        return ((("link", conn[1]), self.link_capacity),)

    def shares(self, active: Mapping[str, Set[int]]) -> Dict[Conn, float]:
        out: Dict[Conn, float] = {}
        for r, ws in active.items():
            if not ws:
                continue
            s = 1.0 / len(ws)
            for w in ws:
                out[(w, r)] = s
        return out


class IncrementalWaterfill:
    """Incremental max-min water-filling over a static group structure.

    Maintains the :func:`waterfill` allocation across connection arrivals
    and departures: per-group residual membership, flow->group mappings and
    the connected-component partition are kept up to date, and a
    :meth:`flush` re-solves only the component(s) whose membership changed
    since the last flush — every other connection keeps its cached share
    untouched.  When the dirty closure exceeds ``FULL_FRACTION`` of the
    active set, the solver falls back to a full re-solve (identical result;
    the fallback is purely an O(...) escape hatch, since solving all
    components is the same code as solving one).

    **Bit-identity contract:** after any add/remove/flush sequence,
    ``self.shares`` equals ``waterfill(active, caps, members)`` float for
    float.  Both sides run the same canonical per-component ``_fill`` on
    the same inputs — group caps come from one ``conn_groups`` callable,
    member lists are sorted, and an untouched component's cached solve is
    exactly what a fresh batch solve of that component computes.  The
    differential harness (``tests/test_waterfill_incremental.py``) ratifies
    this on randomized sequences; setting ``REPRO_CHECK_WATERFILL=1`` (or
    ``check=True``) cross-validates every flush against the batch solver
    and raises on the first divergence.

    Unweighted re-solves are additionally memoized per affected membership
    set (frozenset key -> partition + solved shares): DES steady state
    toggles through a small set of recurring active sets, so most flushes
    become dict lookups.

    ``conn_groups(conn)`` must return the ``(key, capacity)`` pairs of the
    connection's groups, independent of the rest of the active set —
    exactly :meth:`BandwidthModel.conn_groups`.
    """

    FULL_FRACTION = 0.75   # dirty closure above this fraction => full solve
    MEMO_MAX = 4096        # unweighted component-solve memo bound

    def __init__(self,
                 conn_groups: Callable[[Conn],
                                       Sequence[Tuple[object, float]]],
                 weighted: bool = False,
                 check: Optional[bool] = None):
        self._conn_groups_fn = conn_groups
        self._weighted = weighted
        if check is None:
            check = bool(os.environ.get("REPRO_CHECK_WATERFILL"))
        self._check = check
        self._active: Dict[Conn, float] = {}          # conn -> weight
        # per-ACTIVE-conn group keys and per-LIVE-group caps/members; all
        # three are evicted as connections depart, so memory is bounded by
        # the active set even under never-reused connections (the
        # emulator's Poisson background flows)
        self._groups_of: Dict[Conn, tuple] = {}       # conn -> group keys
        self._caps: Dict[object, float] = {}
        self._members: Dict[object, Set[Conn]] = {}   # active members only
        self._comp_of: Dict[Conn, int] = {}
        self._comps: Dict[int, Set[Conn]] = {}
        self._next_cid = 0
        self._dirty: Set[Conn] = set()
        # affected-set -> [(component, solved shares)] (unweighted only)
        self._memo: Dict[FrozenSet[Conn], list] = {}
        # component -> solved shares (unweighted; hit when the same
        # component recurs inside different affected sets)
        self._comp_memo: Dict[FrozenSet[Conn], Dict[Conn, float]] = {}
        self.shares: Dict[Conn, float] = {}
        # per-group capacity multipliers (fault injection: degradation
        # epochs / PS failover); empty in healthy runs, where every code
        # path below is bit-identical to the pre-scaling solver
        self._scale: Dict[object, float] = {}
        self.stats = {"flushes": 0, "full_solves": 0, "comp_solves": 0,
                      "memo_hits": 0, "resolved_conns": 0,
                      "active_conn_events": 0, "scale_events": 0}

    def metrics_snapshot(self) -> Dict[str, int]:
        """A copy of the solver's work profile (``stats``) for
        publication into ``trace.meta["metrics"]`` / the obs registry."""
        return dict(self.stats)

    # ------------------------------------------------------------ mutation

    @property
    def pending(self) -> bool:
        """True when membership changed since the last :meth:`flush`."""
        return bool(self._dirty)

    def add(self, conn: Conn, weight: float = 1.0) -> None:
        """Register an arriving connection (effective at the next flush)."""
        if conn in self._active:
            raise ValueError(f"connection {conn!r} is already active")
        pairs = tuple(self._conn_groups_fn(conn))
        if not pairs:
            raise ValueError(
                f"connection {conn!r} belongs to no capacity group; "
                f"every connection needs at least one (its link's, "
                f"typically)")
        self._groups_of[conn] = tuple(k for k, _cap in pairs)
        self._active[conn] = weight
        for k, cap in pairs:
            ms = self._members.get(k)
            if ms is None:
                self._members[k] = {conn}
                self._caps[k] = cap
            else:
                old = self._caps[k]
                if old != cap:
                    raise ValueError(
                        f"group {k!r} capacity disagrees across "
                        f"connections ({old} vs {cap}); conn_groups must "
                        f"be static")
                ms.add(conn)
        self._dirty.add(conn)

    def remove(self, conn: Conn) -> None:
        """Register a departing connection (effective at the next flush)."""
        del self._active[conn]   # KeyError on unknown conns, deliberately
        for k in self._groups_of.pop(conn):
            ms = self._members.get(k)
            if ms is not None:
                ms.discard(conn)
                if not ms:
                    del self._members[k]
                    del self._caps[k]
        self._dirty.add(conn)

    def set_scale(self, key: object, factor: float) -> None:
        """Scale one capacity group to ``factor`` × its nominal capacity
        (1.0 restores it; 0.0 freezes its members) — a time-varying
        capacity-group update, the waterfill half of fault injection's
        link-degradation and PS-failover epochs.

        The static-structure contract is untouched: ``add`` keeps
        validating *nominal* capacities, and the scale is applied at solve
        time.  Every connection currently riding the group is marked dirty
        so the next :meth:`flush` re-solves exactly the touched
        component(s); solve memos are invalidated (shares now depend on
        the scale state).
        """
        if factor < 0:
            raise ValueError(f"capacity scale must be >= 0, got {factor}")
        prev = self._scale.get(key, 1.0)
        if factor == prev:
            return
        if factor == 1.0:
            del self._scale[key]
        else:
            self._scale[key] = factor
        self.stats["scale_events"] += 1
        self._memo.clear()
        self._comp_memo.clear()
        for c in self._members.get(key, ()):
            self._dirty.add(c)

    # ------------------------------------------------------------- solving

    def flush(self) -> Set[Conn]:
        """Apply pending arrivals/departures and re-solve what they touch.

        Returns the set of connections whose share changed (including the
        newly added ones); everything else keeps its cached share AND its
        cached float value — callers can skip re-projecting those.
        """
        if not self._dirty:
            return set()
        dirty, self._dirty = self._dirty, set()
        self.stats["flushes"] += 1
        active = self._active
        comp_of = self._comp_of
        comps_tbl = self._comps
        # affected region = the old component of every dirty conn (covers
        # departures and splits) + the components an arrival's groups reach
        # (covers merges) + the arrivals themselves.  Edges only appear or
        # vanish at dirty conns, so this union is always a union of whole
        # components of the NEW membership state — re-solving it in
        # isolation is bit-identical to its slice of a full batch solve.
        cids: Set[int] = set()
        fresh: Set[Conn] = set()
        for c in dirty:
            cid = comp_of.get(c)
            if cid is not None:
                cids.add(cid)
            if c in active:
                fresh.add(c)
                for k in self._groups_of[c]:
                    for m in self._members[k]:
                        mcid = comp_of.get(m)
                        if mcid is not None:
                            cids.add(mcid)
                        else:
                            fresh.add(m)
        affected = fresh
        for cid in cids:
            affected |= comps_tbl[cid]
        affected = {c for c in affected if c in active}
        if active and len(affected) > self.FULL_FRACTION * len(active):
            self.stats["full_solves"] += 1
            affected = set(active)
        self.stats["resolved_conns"] += len(affected)
        self.stats["active_conn_events"] += len(active)
        # partition the affected region and solve each component; both the
        # partition and the solved shares recur in steady state, so the
        # whole step is memoized per affected membership set (unweighted)
        solved = None
        akey: Optional[FrozenSet[Conn]] = None
        if not self._weighted:
            akey = frozenset(affected)
            solved = self._memo.get(akey)
        if solved is None:
            solved = [(comp, self._solve(comp))
                      for comp in self._split(affected)]
            if akey is not None:
                if len(self._memo) >= self.MEMO_MAX:
                    self._memo.clear()   # simple bound; recurring sets refill
                self._memo[akey] = solved
        else:
            self.stats["memo_hits"] += 1
        # retire every stale component record touching the affected set
        for c in affected | dirty:
            cid = comp_of.pop(c, None)
            if cid is not None:
                stale = comps_tbl.pop(cid, None)
                if stale:
                    for m in stale:
                        comp_of.pop(m, None)
        changed: Set[Conn] = set()
        shares = self.shares
        for comp, comp_shares in solved:
            cid = self._next_cid
            self._next_cid += 1
            comps_tbl[cid] = comp
            for m in comp:
                comp_of[m] = cid
            for m, s in comp_shares.items():
                old = shares.get(m)
                if old is None or old != s:
                    changed.add(m)
                    shares[m] = s
        for c in dirty:
            if c not in active:
                shares.pop(c, None)
        if self._check:
            self._verify()
        return changed

    def _split(self, affected: Set[Conn]) -> List[FrozenSet[Conn]]:
        """Connected components of the affected region under the current
        membership state.  Every group is expanded at most once —
        components are disjoint, so a group seen from one member never
        needs re-scanning from another."""
        comps: List[FrozenSet[Conn]] = []
        visited: Set[Conn] = set()
        seen_keys: Set[object] = set()
        for c0 in affected:
            if c0 in visited:
                continue
            visited.add(c0)
            comp = {c0}
            stack = [c0]
            while stack:
                c = stack.pop()
                for k in self._groups_of[c]:
                    if k in seen_keys:
                        continue
                    seen_keys.add(k)
                    for m in self._members[k]:
                        if m not in visited:
                            visited.add(m)
                            comp.add(m)
                            stack.append(m)
            comps.append(frozenset(comp))
        return comps

    def _group_data(self, conns: Sequence[Conn]
                    ) -> Tuple[Dict[object, float], Dict[object, list]]:
        """Caps/members over (sorted) active conns from the maintained
        structures — the single aggregation both the component solve and
        the invariant check consume, mirroring the canonical form
        ``BandwidthModel.groups_for`` feeds the batch solver."""
        caps: Dict[object, float] = {}
        members: Dict[object, list] = {}
        for c in conns:
            for k in self._groups_of[c]:
                ms = members.get(k)
                if ms is None:
                    caps[k] = self._caps[k]
                    members[k] = [c]
                else:
                    ms.append(c)
        if self._scale:
            for k, factor in self._scale.items():
                if k in caps:
                    caps[k] = caps[k] * factor
        return caps, members

    def _solve(self, comp: FrozenSet[Conn]) -> Dict[Conn, float]:
        """Canonical solve of one component (the batch solver's own
        ``_fill`` on sorted conns / sorted member lists)."""
        if not self._weighted:
            hit = self._comp_memo.get(comp)
            if hit is not None:
                self.stats["memo_hits"] += 1
                return hit
        self.stats["comp_solves"] += 1
        conns = sorted(comp)
        caps, members = self._group_data(conns)
        weights = ({c: self._active[c] for c in conns}
                   if self._weighted else None)
        out = _fill(conns, caps, members, weights)
        if not self._weighted:
            if len(self._comp_memo) >= self.MEMO_MAX:
                self._comp_memo.clear()
            self._comp_memo[comp] = out
        return out

    def _verify(self) -> None:
        """Invariant mode: cross-validate the cache against a from-scratch
        batch solve (exact float equality) — REPRO_CHECK_WATERFILL=1."""
        conns = sorted(self._active)
        caps, members = self._group_data(conns)
        weights = ({c: self._active[c] for c in conns}
                   if self._weighted else None)
        ref = waterfill(conns, caps, members, weights=weights)
        if ref != self.shares:
            diffs = sorted(set(ref.items()) ^ set(self.shares.items()))
            raise AssertionError(
                f"incremental waterfill diverged from the batch solve on "
                f"{len(diffs)} entr(ies); first few: {diffs[:6]}")
