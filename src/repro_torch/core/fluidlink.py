"""Shared incremental fluid-link kernel (virtual-service clocks).

One module for the processor-sharing state machine that used to live twice:
as ``_LinkState`` in ``repro_torch.core.simulator`` and as ``_Link`` in
``repro.emulator.cluster``.  Both are the same trick — a cumulative
attained-service clock ``V`` so that a job starting with work ``r``
completes when ``V`` reaches ``V(start) + r``, valid across any number of
rate changes without touching per-job state; projections of the earliest
completion onto real time are tagged with a rate epoch and lazily
invalidated on pop.

Two specializations:

  * :class:`EqualShareLink` — the simulator's uniform equal-share link.
    Every active connection receives the same rate; the engine sets
    ``rate`` explicitly (``(1/n) * B``, share-then-scale, to stay
    bit-identical with the frozen reference engine) and manages the chunk
    heap itself.
  * :class:`WeightedFluidLink` — the emulator's weighted link.  Flows carry
    weights (bandwidth jitter, background traffic); the clock advances in
    per-unit-weight service and a flow of ``r`` bytes at weight ``w``
    targets ``U(start) + r / w``.
"""
from __future__ import annotations

import heapq
import math
from typing import Callable, Dict, List, Optional, Set


class _ClockBase:
    """Cumulative attained-service clock with lazy materialization."""

    __slots__ = ("bandwidth", "V", "rate", "t_mat", "heap", "epoch")

    def __init__(self, bandwidth: float):
        self.bandwidth = bandwidth
        self.V = 0.0       # cumulative attained service (per conn / per w)
        self.rate = 0.0    # current clock rate (work/s)
        self.t_mat = 0.0   # time V was last materialized
        self.heap: List[tuple] = []
        self.epoch = 0     # bumped whenever rate / membership changes

    def materialize(self, t: float) -> None:
        if t > self.t_mat:
            self.V += self.rate * (t - self.t_mat)
            self.t_mat = t


class EqualShareLink(_ClockBase):
    """Uniform processor-sharing link state for the DES engine.

    The engine owns the policy: it sets ``rate`` on each membership change
    and pushes ``(V_target, seq, key, chunk)`` entries onto ``heap``.
    """

    __slots__ = ("active",)

    def __init__(self, bandwidth: float):
        super().__init__(bandwidth)
        self.active: Set[int] = set()


class Flow:
    """One fluid flow on a weighted link (a burst, or background traffic)."""

    __slots__ = ("fid", "weight", "remaining", "on_complete")

    def __init__(self, fid: int, weight: float, remaining: float,
                 on_complete: Optional[Callable[[], None]] = None):
        self.fid = fid
        self.weight = weight
        self.remaining = remaining   # bytes; inf for background flows
        self.on_complete = on_complete


class WeightedFluidLink(_ClockBase):
    """Weighted processor-sharing link with an incremental virtual clock.

    Every flow receives service at ``B * w_i / total_w``, i.e. all flows
    share one per-unit-weight rate ``B / total_w``.  The clock ``V`` counts
    per-unit-weight attained service; a finite flow starting with ``r``
    bytes at weight ``w`` completes when ``V`` reaches ``V(start) + r / w``.
    """

    __slots__ = ("flows", "total_w")

    def __init__(self, bandwidth: float):
        super().__init__(bandwidth)
        self.flows: Dict[int, Flow] = {}
        self.total_w = 0.0

    def _set_rate(self) -> None:
        self.rate = self.bandwidth / self.total_w if self.total_w > 0 else 0.0

    def add_flow(self, t: float, flow: Flow) -> None:
        self.materialize(t)
        self.flows[flow.fid] = flow
        self.total_w += flow.weight
        self._set_rate()
        self.epoch += 1
        if math.isfinite(flow.remaining):
            heapq.heappush(self.heap,
                           (self.V + flow.remaining / flow.weight,
                            flow.fid, flow))

    def remove_flow(self, t: float, fid: int) -> None:
        flow = self.flows.pop(fid, None)
        if flow is None:
            return
        self.materialize(t)
        self.total_w -= flow.weight
        if self.total_w < 1e-12:
            # drifted to (near) zero: rebuild from the survivors
            self.total_w = sum(f.weight for f in self.flows.values())
        self._set_rate()
        self.epoch += 1
        # finite flows leave the heap lazily (checked against self.flows)

    def next_projection(self, t: float) -> Optional[float]:
        """Real time of the earliest completion under the current rate."""
        heap = self.heap
        while heap and heap[0][2].fid not in self.flows:
            heapq.heappop(heap)   # flow was force-removed; drop lazily
        if not heap or self.total_w <= 0 or self.bandwidth <= 0:
            return None   # bandwidth 0: link is down (PS failover epoch)
        self.materialize(t)
        dt = (heap[0][0] - self.V) * self.total_w / self.bandwidth
        return t + (dt if dt > 0.0 else 0.0)

    def pop_due(self, t: float) -> List[Flow]:
        """Remove and return every flow whose service is complete at ``t``.

        Bumps the epoch exactly once when anything completed; completion
        callbacks are the caller's business (they may re-fill the link).
        """
        self.materialize(t)
        lim = self.V + 1e-9 + self.V * 1e-12
        heap = self.heap
        done: List[Flow] = []
        while heap and (heap[0][2].fid not in self.flows
                        or heap[0][0] <= lim):
            _v, fid, flow = heapq.heappop(heap)
            if fid in self.flows:
                done.append(flow)
        if done:
            for flow in done:
                del self.flows[flow.fid]
                self.total_w -= flow.weight
            if not self.flows:
                self.total_w = 0.0
            elif self.total_w < 1e-12:
                self.total_w = sum(f.weight for f in self.flows.values())
            self._set_rate()
            self.epoch += 1
        return done
