"""Shared per-link timeline recorder.

One implementation, two consumers: the fleet engine's contention
timelines (``FleetTrace.meta["contention"]``, consumed by ``whatif
--fleet``) and the Chrome-trace counter tracks emitted by
:mod:`repro_torch.obs.trace_export`.

The recorder is deliberately dumb — an append and a fold — because it
sits inside the merged engine's begin/leave hot paths (guarded by
``record_contention``); anything cleverer belongs in the consumers.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

Transition = Tuple[float, str, float]


class LinkTimeline:
    """Records ``(t, name, value)`` transitions for named links/groups.

    ``value`` is whatever the producer tracks — the fleet engine records
    the link's active-connection count after each join/leave; a rate
    producer may record allocated bytes/s.
    """

    __slots__ = ("events",)

    def __init__(self) -> None:
        self.events: List[Transition] = []

    def record(self, t: float, name: str, value: float) -> None:
        self.events.append((t, name, value))

    def fold(self) -> Dict[str, List[Tuple[float, float]]]:
        """Per-name ``[(t, value), ...]`` series, in record order (the
        producers record in event-time order already)."""
        out: Dict[str, List[Tuple[float, float]]] = {}
        for t, name, value in self.events:
            out.setdefault(name, []).append((t, value))
        return out

    def __len__(self) -> int:
        return len(self.events)


def fold_rate_log(rate_log) -> Dict[str, List[Tuple[float, float, float]]]:
    """Group a scalar-engine ``trace.rate_log`` — ``(t, link,
    allocated_Bps, active)`` samples — into per-link series."""
    out: Dict[str, List[Tuple[float, float, float]]] = {}
    for t, name, rate, active in rate_log:
        out.setdefault(name, []).append((t, rate, active))
    return out
