"""Process-pool map for what-if sweeps.

The paper's pitch (§3.4, §4.5) is that profiling once and *simulating*
every what-if configuration is orders of magnitude cheaper than measuring
on a real cluster, and that "multiple runs can be performed in parallel on
separate cores".  :func:`parallel_map` fans fully seeded tasks across a
process pool and reassembles results in task order, so

    serial result == parallel result   (bit-for-bit, for fixed seeds)

holds by construction.  Set ``REPRO_SWEEP_SERIAL=1`` to force in-process
execution (debugging, profiling, or environments where fork is
unavailable).  The rest of the reference's sweep engine (prediction and
measurement sweeps, batched and fleet tasks) is not ported yet: ROADMAP
1.16.
"""
from __future__ import annotations

import multiprocessing
import os
import sys
import threading
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, List, Optional, Sequence

__all__ = ["parallel_map", "default_pool_size"]


def default_pool_size() -> int:
    return max(1, os.cpu_count() or 1)


def _serial_forced() -> bool:
    return os.environ.get("REPRO_SWEEP_SERIAL", "") not in ("", "0")


def _pool_context():
    """Worker-process start method.

    Plain fork is cheapest but unsafe from a multithreaded parent: forking
    can clone a locked mutex into the child (CPython warns about exactly
    this once torch's native thread pools exist).  So: fork while the
    parent is single-threaded and torch-free; otherwise ``forkserver``,
    which forks
    from a clean single-threaded server process.  Forkserver/spawn
    re-import ``__main__`` in workers, which an interactive/stdin parent
    cannot satisfy — those parents are exactly the single-threaded case,
    so they keep fork.  Task functions are module-level and payloads
    picklable by design, as all three methods require.
    """
    if threading.active_count() == 1 and "torch" not in sys.modules:
        try:
            return multiprocessing.get_context("fork")
        except ValueError:  # pragma: no cover - non-Unix platforms
            pass
    try:
        return multiprocessing.get_context("forkserver")
    except ValueError:  # pragma: no cover - non-Unix platforms
        return multiprocessing.get_context()


def parallel_map(fn: Callable, items: Sequence,
                 max_workers: Optional[int] = None,
                 parallel: bool = True,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()) -> List:
    """``[fn(x) for x in items]`` across a process pool, order-preserving.

    ``fn`` must be a module-level callable and ``items`` picklable.  Falls
    back to a plain loop for 0/1 items, a 1-wide pool, or when
    ``REPRO_SWEEP_SERIAL`` is set — the results are identical either way
    (``initializer`` runs in-process on the serial path).
    """
    n = max_workers or default_pool_size()
    if not parallel or n <= 1 or len(items) <= 1 or _serial_forced():
        if initializer is not None:
            initializer(*initargs)
        return [fn(x) for x in items]
    with ProcessPoolExecutor(max_workers=min(n, len(items)),
                             mp_context=_pool_context(),
                             initializer=initializer,
                             initargs=initargs) as pool:
        return list(pool.map(fn, items))
