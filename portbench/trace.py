"""The profiler's trace of a traced window, reduced to what the per-layer
readers need: device intervals, host spans, which kernels each host span
launched, the device's busy time and its idle gaps.

The trace is ``torch.profiler``'s Chrome trace (CPU and CUDA activities):
host ops (``cpu_op``, and ``user_annotation`` for ``record_function``
spans), the runtime and driver calls that launch device work, each with a
``correlation`` id, and the device's kernels, copies and sets carrying the
same id. Host and device timestamps share one clock (microseconds).
"""
from __future__ import annotations

import bisect
import itertools
import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")
_HOST = ("cpu_op", "user_annotation")
STEP = "ProfilerStep#"


@dataclass
class Trace:
    # device work: (start us, end us, name, correlation, device index)
    device: List[Tuple[float, float, str, int, int]] = field(
        default_factory=list)
    # launches: correlation -> (host ts us, thread)
    launches: Dict[int, Tuple[float, int]] = field(default_factory=dict)
    # host spans: (start us, end us, name, thread)
    host: List[Tuple[float, float, str, int]] = field(default_factory=list)

    # -- the window -------------------------------------------------------

    def window(self) -> Tuple[float, float]:
        """The traced steps: from the first ``ProfilerStep`` span's start
        to the last one's end (us)."""
        steps = [(a, b) for a, b, n, _ in self.host if n.startswith(STEP)]
        if not steps:
            raise ValueError("no ProfilerStep span in the trace")
        return min(a for a, _ in steps), max(b for _, b in steps)

    def steps(self) -> int:
        return sum(n.startswith(STEP) for _, _, n, _ in self.host)

    def main_thread(self) -> int:
        return next(t for _, _, n, t in self.host if n.startswith(STEP))

    # -- device time ------------------------------------------------------

    def busy_intervals(self, device: Optional[int] = None,
                       keep=lambda name: True) -> List[Tuple[float, float]]:
        """The union of the device's intervals within the window."""
        w0, w1 = self.window()
        spans = sorted((max(a, w0), min(b, w1))
                       for a, b, n, _, d in self.device
                       if (device is None or d == device) and keep(n)
                       and b > w0 and a < w1)
        out: List[List[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self, device: Optional[int] = None) -> float:
        return sum(b - a for a, b in self.busy_intervals(device)) * 1e-6

    def window_s(self) -> float:
        w0, w1 = self.window()
        return (w1 - w0) * 1e-6

    def under(self, names) -> float:
        """Seconds of device work launched inside a host span named in
        ``names`` (on the thread that ran it)."""
        by_thread = defaultdict(list)
        for a, b, n, t in self.host:
            if n in names:
                by_thread[t].append((a, b))
        for t in by_thread:
            by_thread[t].sort()
        starts = {t: [a for a, _ in v] for t, v in by_thread.items()}
        # the latest end of the spans that start before each one
        reach = {t: list(itertools.accumulate((b for _, b in v), max))
                 for t, v in by_thread.items()}

        def inside(ts: float, t: int) -> bool:
            i = bisect.bisect_right(starts.get(t, []), ts) - 1
            return i >= 0 and reach[t][i] >= ts

        total = 0.0
        for a, b, _, corr, _ in self.device:
            launch = self.launches.get(corr)
            if launch is not None and inside(*launch):
                total += b - a
        return total * 1e-6

    def count(self, name: str) -> int:
        return sum(n == name for _, _, n, _ in self.host)

    # -- breakdown --------------------------------------------------------

    def top_ops(self, n: int = 10) -> List[List]:
        w0, w1 = self.window()
        sums: Dict[str, float] = defaultdict(float)
        for a, b, name, _, _ in self.device:
            if b > w0 and a < w1:
                sums[name] += (b - a) * 1e-6
        rows = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], s] for name, s in rows]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time within the window, summed by the
        innermost host span running on the main thread at each gap's
        middle."""
        w0, w1 = self.window()
        busy = self.busy_intervals()
        gaps, at = [], w0
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if w1 > at:
            gaps.append((at, w1))
        main = self.main_thread()
        spans = sorted(((a, b, name) for a, b, name, t in self.host
                        if t == main), key=lambda s: (s[0], -s[1]))
        # one sweep: a stack of the spans open at each gap's middle (host
        # spans of one thread nest)
        sums: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[float, float, str]] = []
        j = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while j < len(spans) and spans[j][0] <= mid:
                while stack and stack[-1][1] < spans[j][0]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "no host span"
            sums[name[:200]] += (b - a) * 1e-6
        rows = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
        return [[name, s] for name, s in rows]


def _int(x) -> int:
    try:
        return int(x)
    except (TypeError, ValueError):
        return 0


def load(path: Path) -> Trace:
    raw = json.loads(Path(path).read_text())
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    tr = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in _DEVICE:
            tr.device.append((ts, ts + dur, e.get("name", ""),
                              int(args.get("correlation", -1)),
                              _int(args.get("device", e.get("pid")))))
        elif cat in _LAUNCH and "correlation" in args:
            tr.launches[int(args["correlation"])] = (ts, e.get("tid"))
        elif cat in _HOST:
            tr.host.append((ts, ts + dur, e.get("name", ""), e.get("tid")))
    return tr
