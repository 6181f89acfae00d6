"""What the per-layer readers take from the program's own spans
(``repro_torch.obs.spans``) in a traced window: the device time launched
inside a span, and the card's idle time while a span is open. Each returns
``None`` where the trace holds no span of that name (an untraced run, or
a program without it)."""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


def union(spans: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """The sorted union of intervals."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(spans, cover) -> float:
    """The length of ``spans`` covered by ``cover`` (both sorted unions
    of intervals)."""
    total, j = 0.0, 0
    for a, b in spans:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            total += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return total


def device_ms_under(ctx, span: str) -> Optional[float]:
    """Device time of the kernels launched inside ``span`` on any thread,
    each kernel once, a traced step, in ms."""
    tr = ctx.trace
    if tr is None or not tr.count(span) or not tr.steps():
        return None
    seconds = tr.under({span})
    return 1e3 * seconds / tr.steps() if seconds > 0 else None


def idle_ms_inside(ctx, span: str) -> Optional[float]:
    """The card's idle time within the window while some thread is inside
    ``span`` (each instant once), a traced step, in ms; on several cards
    the mean of theirs."""
    tr = ctx.trace
    if tr is None or not tr.count(span) or not tr.steps():
        return None
    w0, w1 = tr.window()
    inside = union((max(a, w0), min(b, w1)) for a, b, n, _ in tr.host
                   if n == span and b > w0 and a < w1)
    length = sum(b - a for a, b in inside)
    idle = [length - _overlap(inside, tr.busy_intervals(d))
            for d in ctx.devices]
    return 1e-3 * sum(idle) / len(idle) / tr.steps()
