"""Per-(worker, resource) schedulers.

The paper models gRPC/HTTP/2 stream multiplexing (§3.2.2) as:

  * each pending transmission (stream) joins the link scheduler when its op
    becomes ready;
  * the FIRST time a stream is selected it may transmit up to ``WIN`` bytes;
    if more remains, it is preempted and re-queued (at the back);
  * if the remaining size is < WIN, or the stream is selected the SECOND
    time, it runs to completion ("stream preemption happens only once").

With flow control disabled (§3.3) streams are served whole, in the order in
which they were scheduled (FIFO) or in an enforced order (TIC / reverse /
random) via op priorities.

Compute resources always use a whole-op FIFO scheduler: the worker's GPU/CPU
and the PS update cores process one op at a time.

Only ONE chunk per (worker, resource) is ever outstanding in the simulator's
run queue; the scheduler hands out the next chunk when asked.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Deque, List, Optional, Tuple

from .events import Chunk, LiveOp


class Scheduler:
    """Base interface: a queue of pending LiveOps for one (worker, res)."""

    def add(self, op: LiveOp) -> None:
        raise NotImplementedError

    def remove_chunk(self) -> Optional[Chunk]:
        """Pop the next chunk to run, or None if empty."""
        raise NotImplementedError

    def __bool__(self) -> bool:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class FifoScheduler(Scheduler):
    """Whole-op FIFO service. Used for compute resources and for links when
    HTTP/2 flow control is disabled with no enforced ordering."""

    def __init__(self):
        self._q: Deque[LiveOp] = deque()

    def add(self, op: LiveOp) -> None:
        self._q.append(op)

    def remove_chunk(self) -> Optional[Chunk]:
        if not self._q:
            return None
        op = self._q.popleft()
        return Chunk(op=op, remaining=op.remaining_work, is_last=True)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __len__(self) -> int:
        return len(self._q)


class OrderedScheduler(Scheduler):
    """Whole-op service by priority (enforced transmission order, §3.3).

    Lower ``op.template.priority`` first; ties broken by arrival order.
    Models flow-control-disabled gRPC with an enforced schedule (e.g. TIC):
    once a stream starts it runs to completion, but among *pending* streams
    the enforced order decides who goes next.
    """

    def __init__(self):
        self._heap: List[Tuple[float, int, LiveOp]] = []
        self._arrival = itertools.count()

    def add(self, op: LiveOp) -> None:
        heapq.heappush(self._heap, (op.template.priority, next(self._arrival), op))

    def remove_chunk(self) -> Optional[Chunk]:
        if not self._heap:
            return None
        _, _, op = heapq.heappop(self._heap)
        return Chunk(op=op, remaining=op.remaining_work, is_last=True)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __len__(self) -> int:
        return len(self._heap)


class Http2Scheduler(Scheduler):
    """The paper's HTTP/2 multiplexing model (§3.2.2, Fig. 12).

    Streams queue FIFO. First service: a chunk of ``min(WIN, remaining)``;
    if the stream still has data left it goes to the back of the queue
    (marked as serviced once). Second service (or remaining < WIN at first
    service): the whole remainder as a single final chunk.
    """

    def __init__(self, win: float):
        if win <= 0:
            raise ValueError("WIN must be positive")
        self.win = float(win)
        self._q: Deque[LiveOp] = deque()

    def add(self, op: LiveOp) -> None:
        self._q.append(op)

    def remove_chunk(self) -> Optional[Chunk]:
        if not self._q:
            return None
        op = self._q.popleft()
        if not op.serviced_once and op.remaining_work > self.win:
            op.serviced_once = True
            # Carve the WIN-sized burst OUT of the op's remaining work; the
            # simulator re-adds the remainder at chunk COMPLETION time (the
            # paper's Fig 12: the preempted stream joins the back of the
            # queue when its burst finishes, behind streams that arrived
            # during the burst), and the second service runs to completion.
            op.remaining_work -= self.win
            return Chunk(op=op, remaining=self.win, is_last=False)
        return Chunk(op=op, remaining=op.remaining_work, is_last=True)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __len__(self) -> int:
        return len(self._q)


def make_link_scheduler(policy: str, win: float = 28e6) -> Scheduler:
    """Factory for link schedulers.

    ``policy``:
      * ``"http2"``   -> WIN-chunked multiplexing (flow control on; default)
      * ``"fifo"``    -> whole streams in scheduling order (flow control off)
      * ``"ordered"`` -> whole streams by op priority (TIC / reverse / random)
    """
    if policy == "http2":
        return Http2Scheduler(win)
    if policy == "fifo":
        return FifoScheduler()
    if policy == "ordered":
        return OrderedScheduler()
    raise ValueError(f"unknown link scheduler policy {policy!r}")
