"""Parallel sweep engine: fan (worker-count, seed) runs across CPU cores.

The paper's pitch (§3.4, §4.5) is that profiling once and *simulating* every
what-if configuration is orders of magnitude cheaper than measuring on a
real cluster — and that "multiple runs can be performed in parallel on
separate cores".  This module is that sentence made concrete: it takes the
cross product of worker counts and per-run seeds that a figure sweep needs,
ships each fully-seeded task to a process pool, and reassembles results in
task order, so

    serial result == parallel result   (bit-for-bit, for fixed seeds)

holds by construction: every task carries its own ``SimConfig`` (seed
included) or emulator seed, and no RNG state is shared across tasks.

Three layers:

  * :func:`parallel_map` — deterministic ordered pool map with a serial
    fallback (used directly by ``launch/whatif.py`` and ``benchmarks/``);
  * :func:`predict_many` / :func:`measure_many` — fan a
    :class:`~repro_torch.core.predictor.PredictionRun`'s simulation (resp.
    emulator ground-truth) runs for many worker counts across the pool;
  * :func:`sweep_parallel` — a full predicted-vs-measured figure sweep
    (the parallel replacement for ``predictor.sweep``): all simulation and
    measurement tasks for all worker counts share ONE pool so cores stay
    busy across the whole figure, not per data point.

Set ``REPRO_SWEEP_SERIAL=1`` to force in-process execution (debugging,
profiling, or environments where fork is unavailable).
"""
from __future__ import annotations

import contextlib
import multiprocessing
import os
import sys
import threading
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.simulator import SimConfig, Simulation
from repro_torch.obs import ledger
from repro_torch.obs import metrics as obs_metrics

__all__ = [
    "parallel_map", "predict_many", "measure_many", "sweep_parallel",
    "simulate_task", "simulate_all", "simulate_batched", "SimulationPool",
    "default_pool_size", "pool",
    "FleetTask", "simulate_fleet_task", "simulate_fleets",
]


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


# --------------------------------------------------------------------- tasks
# Task payloads are plain tuples of picklable values; the functions are
# module-level so the pool can import them by reference.

SimTask = Tuple[SimConfig, list, int, int, int]  # cfg, templates, W, batch, warmup

# Templates shipped once per pool worker (executor initializer) instead of
# being re-pickled inside every task: a figure sweep reuses one template
# list across dozens of tasks.
_worker_templates: Optional[list] = None


def _set_worker_templates(templates: list) -> None:
    global _worker_templates
    _worker_templates = templates


def _strip_templates(task: SimTask) -> SimTask:
    cfg, _templates, num_workers, batch_size, warmup_steps = task
    return (cfg, None, num_workers, batch_size, warmup_steps)


def simulate_task(task: SimTask) -> float:
    """One seeded DES run -> examples/s.  The unit of parallel work.

    ``templates is None`` means "use the per-worker template list" set by
    the pool initializer (see :func:`predict_many`)."""
    cfg, templates, num_workers, batch_size, warmup_steps = task
    if templates is None:
        templates = _worker_templates
    trace = Simulation(cfg).run(templates, num_workers)
    return trace.throughput(batch_size, warmup_steps=warmup_steps)


# A fleet payload: (FleetConfig, {job name -> templates}, merged).  Every
# task is fully seeded by its jobs' own seeds, so the serial == parallel
# bit-identity of the scalar sweep carries over unchanged.
FleetTask = Tuple[object, dict, Optional[bool]]


def simulate_fleet_task(task: FleetTask):
    """One seeded fleet run -> :class:`repro_torch.core.fleet.FleetTrace`
    (the multi-job unit of parallel work; per-job throughputs come off the
    returned per-job traces)."""
    from repro_torch.core.fleet import FleetSimulation
    cfg, steps_by_job, merged = task
    return FleetSimulation(cfg).run(steps_by_job, merged=merged)


def simulate_fleets(tasks: Sequence[FleetTask], parallel: bool = True,
                    max_workers: Optional[int] = None) -> List:
    """Fan pre-seeded fleet payloads across the pool, order-preserving —
    ``simulate_fleet_task`` per task, same results serial or parallel."""
    return parallel_map(simulate_fleet_task, list(tasks),
                        max_workers=max_workers, parallel=parallel)


def measure_task(args: tuple) -> float:
    """One seeded cluster-emulator measurement -> examples/s."""
    (dnn, batch_size, platform, num_workers, num_ps, steps, seed,
     flow_control, order, warmup_steps, topology, sync, faults) = args
    from repro_torch.core.paper_models import PAPER_DNNS, PLATFORMS
    from repro_torch.emulator.cluster import measure_throughput
    return measure_throughput(
        PAPER_DNNS[dnn], batch_size, PLATFORMS[platform], num_workers,
        num_ps=num_ps, steps=steps, seed=seed, flow_control=flow_control,
        order=order, warmup_steps=warmup_steps, topology=topology,
        sync=sync, faults=faults)


def _run_tagged(tagged: tuple) -> float:
    kind, payload = tagged
    if kind == "sim":
        return simulate_task(payload)
    return measure_task(payload)


def _measure_args(run, num_workers: int, steps: int, seed_offset: int) -> tuple:
    sync = run.sync_spec() if hasattr(run, "sync_spec") else None
    return (run.dnn, run.batch_size, run.platform, num_workers, run.num_ps,
            steps, run.seed + seed_offset, run.flow_control, run.order,
            run.warmup_steps, getattr(run, "topology", None), sync,
            getattr(run, "faults", None))


def _shared_templates(run) -> Optional[list]:
    """The template list shared by every simulation task of ``run``, or
    None when templates vary per worker count (the all-reduce regime: the
    collective DAG depends on W, so each task must carry its own list)."""
    if hasattr(run, "sync_spec") and run.sync_spec().mode == "allreduce":
        return None
    return run.sim_steps_templates


def _group_means(outs: Sequence[float], workers: Sequence[int],
                 n_runs: int, offset: int = 0) -> Dict[int, float]:
    """Fold a flat, task-ordered result list (n_runs consecutive entries
    per worker count, starting at ``offset``) into per-count means."""
    result: Dict[int, float] = {}
    for j, w in enumerate(workers):
        chunk = outs[offset + j * n_runs:offset + (j + 1) * n_runs]
        result[w] = sum(chunk) / len(chunk)
    return result


# ------------------------------------------------------------------- facades


def simulate_all(tasks: Sequence[SimTask],
                 templates: Optional[list] = None,
                 parallel: bool = True,
                 max_workers: Optional[int] = None,
                 batch: bool = False) -> List[float]:
    """Run pre-seeded :func:`simulate_task` payloads through the pool,
    order-preserving.  With ``templates``, every task's template slot is
    replaced by the shared list, shipped once per pool worker via the
    executor initializer instead of being re-pickled inside each task
    (candidate batches of placement search and the ``predict_many`` fan
    both reuse one template list across dozens of tasks).

    ``batch=True`` routes through :func:`simulate_batched` — the lockstep
    array engine in ``repro_torch.core.batched`` runs every batchable task
    in one in-process vectorized sweep (non-batchable tasks fall back to
    the scalar simulator), same results, no process pool.

    Inside a :func:`pool` block, tasks go to the ambient shared executor
    instead of a fresh per-call pool (templates then ride inside each
    task rather than via the initializer — the executor reuse is the
    win there)."""
    if obs_metrics.enabled():
        obs_metrics.inc("sweep.tasks", len(tasks))
    if batch:
        return simulate_batched(tasks, templates=templates)
    amb = _ambient_pool
    if amb is not None:
        if templates is not None:
            tasks = [(t[0], templates) + tuple(t[2:]) for t in tasks]
        return amb.map(tasks)
    if templates is None:
        return parallel_map(simulate_task, tasks, max_workers=max_workers,
                            parallel=parallel)
    stripped = [_strip_templates(t) for t in tasks]
    return parallel_map(simulate_task, stripped, max_workers=max_workers,
                        parallel=parallel,
                        initializer=_set_worker_templates,
                        initargs=(templates,))


def simulate_batched(tasks: Sequence[SimTask],
                     templates: Optional[list] = None,
                     engine: str = "auto") -> List[float]:
    """:func:`simulate_all` through the lockstep batched engine.

    Each task becomes a :class:`repro_torch.core.batched.Scenario`; one
    ``run_scenarios`` call simulates every batchable group as stacked
    arrays and punts the rest to the scalar simulator, so the returned
    throughputs are identical to the serial path (``engine="scalar"``
    forces the punt everywhere — useful for differential tests)."""
    from repro_torch.core.batched import Scenario, run_scenarios
    scens = []
    for cfg, tpls, num_workers, _bs, _wu in tasks:
        scens.append(Scenario(cfg, tpls if tpls is not None else templates,
                              num_workers))
    traces = run_scenarios(scens, engine=engine)
    return [tr.throughput(task[3], warmup_steps=task[4])
            for task, tr in zip(tasks, traces)]


_ambient_pool: Optional["SimulationPool"] = None


@contextlib.contextmanager
def pool(parallel: bool = True,
         max_workers: Optional[int] = None) -> Iterator["SimulationPool"]:
    """Ambient :class:`SimulationPool` scope: every :func:`simulate_all`
    call inside the ``with`` block shares ONE executor instead of paying
    pool startup per call.  ``benchmarks/run.py --fast`` wraps its whole
    job loop in this — dozens of small figure fans, one pool.  Nestable;
    the innermost pool wins."""
    global _ambient_pool
    prev = _ambient_pool
    p = SimulationPool(parallel=parallel, max_workers=max_workers)
    _ambient_pool = p
    try:
        yield p
    finally:
        _ambient_pool = prev
        p.close()


class SimulationPool:
    """Reusable executor for :func:`simulate_task` payloads sharing one
    template list.

    :func:`simulate_all` builds and tears down a pool per call — right
    for one-shot figure fans, wasteful for iterative searches
    (placement search's annealing scores one candidate per step; a fresh
    pool per step pays executor startup every iteration).
    The executor is created lazily on first parallel use, ships
    ``templates`` once via the initializer, and keeps the serial-fallback
    semantics of :func:`parallel_map` (including ``REPRO_SWEEP_SERIAL``)
    — results are bit-identical either way.
    """

    def __init__(self, templates: Optional[list] = None,
                 parallel: bool = True,
                 max_workers: Optional[int] = None):
        self.templates = templates
        self.parallel = parallel
        self.max_workers = max_workers or default_pool_size()
        self._executor: Optional[ProcessPoolExecutor] = None

    def map(self, tasks: Sequence[SimTask]) -> List[float]:
        tasks = list(tasks)
        if self.templates is not None:
            tasks = [_strip_templates(t) for t in tasks]
        if (not self.parallel or self.max_workers <= 1 or len(tasks) <= 1
                or _serial_forced()):
            if self.templates is not None:
                _set_worker_templates(self.templates)
            return [simulate_task(t) for t in tasks]
        if self._executor is None:
            init = None if self.templates is None else _set_worker_templates
            initargs = () if self.templates is None else (self.templates,)
            self._executor = ProcessPoolExecutor(
                max_workers=self.max_workers, mp_context=_pool_context(),
                initializer=init, initargs=initargs)
        return list(self._executor.map(simulate_task, tasks))

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None

    def __enter__(self) -> "SimulationPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def predict_many(run, workers: Sequence[int], n_runs: int = 3,
                 parallel: bool = True,
                 max_workers: Optional[int] = None,
                 batch: bool = False) -> Dict[int, float]:
    """Predicted examples/s for each worker count, ``n_runs`` seeded
    simulations per count, fanned over the pool.  Identical to calling
    ``run.predict(w, n_runs)`` per count (same seeds, same mean).
    ``batch=True`` uses the lockstep batched engine instead of the
    process pool (see :func:`simulate_batched`)."""
    if not run.sim_steps_templates:
        run.prepare()
    tasks: List[SimTask] = []
    for w in workers:
        tasks.extend(run.prediction_tasks(w, n_runs))
    outs = simulate_all(tasks, templates=_shared_templates(run),
                        parallel=parallel, max_workers=max_workers,
                        batch=batch)
    return _group_means(outs, workers, n_runs)


def measure_many(run, workers: Sequence[int], steps: int = 100,
                 n_runs: int = 1, parallel: bool = True,
                 max_workers: Optional[int] = None) -> Dict[int, float]:
    """Emulator ground truth for each worker count; ``n_runs == 1`` matches
    ``run.measure(w)``, ``n_runs == 3`` matches ``run.measure_mean(w)``
    (same per-run seed offsets ``1000 + 37*i``)."""
    tasks = [_measure_args(run, w, steps, 1000 + 37 * i)
             for w in workers for i in range(n_runs)]
    outs = parallel_map(measure_task, tasks, max_workers=max_workers,
                        parallel=parallel)
    return _group_means(outs, workers, n_runs)


def predict_and_measure(run, workers: Sequence[int], n_runs: int = 3,
                        measure_steps: int = 100, measure_runs: int = 1,
                        parallel: bool = True,
                        max_workers: Optional[int] = None,
                        ) -> Tuple[Dict[int, float], Dict[int, float]]:
    """Fan ALL of a figure's simulation + measurement tasks in one pool."""
    if not run.sim_steps_templates:
        run.prepare()
    shared = _shared_templates(run)
    tagged: List[tuple] = []
    for w in workers:
        for task in run.prediction_tasks(w, n_runs):
            tagged.append(("sim", _strip_templates(task) if shared is not None
                           else task))
    for w in workers:
        for i in range(measure_runs):
            tagged.append(("meas", _measure_args(run, w, measure_steps,
                                                 1000 + 37 * i)))
    outs = parallel_map(
        _run_tagged, tagged, max_workers=max_workers, parallel=parallel,
        initializer=None if shared is None else _set_worker_templates,
        initargs=() if shared is None else (shared,))
    pred = _group_means(outs, workers, n_runs)
    meas = _group_means(outs, workers, measure_runs,
                        offset=len(workers) * n_runs)
    return pred, meas


def sweep_parallel(run, workers: Sequence[int], measure_steps: int = 100,
                   n_runs: int = 3, measure_runs: int = 1,
                   parallel: bool = True,
                   max_workers: Optional[int] = None) -> Dict[str, list]:
    """Predicted vs measured curves (one paper sub-figure), all tasks in one
    pool.  Same output dict as ``predictor.sweep`` with identical seeds.
    (With ``repro_torch.obs.metrics`` collection on, the dict gains a
    ``"metrics"`` key — sweep queue/latency stats — and, when the run
    ledger is on, a ``sweep`` record is appended.)"""
    import time as _time
    from repro_torch.core.predictor import prediction_error
    t0 = _time.perf_counter()
    pred, meas = predict_and_measure(
        run, workers, n_runs=n_runs, measure_steps=measure_steps,
        measure_runs=measure_runs, parallel=parallel,
        max_workers=max_workers)
    wall = _time.perf_counter() - t0
    p = [pred[w] for w in workers]
    m = [meas[w] for w in workers]
    errs = [prediction_error(a, b) for a, b in zip(p, m)]
    out = {"workers": list(workers), "predicted": p, "measured": m,
           "error": errs}
    n_tasks = len(workers) * (n_runs + measure_runs)
    if obs_metrics.enabled():
        obs_metrics.inc("sweep.runs")
        obs_metrics.inc("sweep.tasks", n_tasks)
        obs_metrics.observe("sweep.wall_s", wall)
        out["metrics"] = {"tasks": n_tasks, "wall_s": wall,
                          "tasks_per_s": n_tasks / wall if wall > 0 else 0.0}
    if ledger.resolve_path() is not None:
        ledger.log(
            "sweep",
            config={"dnn": getattr(run, "dnn", None),
                    "batch_size": getattr(run, "batch_size", None),
                    "platform": getattr(run, "platform", None),
                    "num_ps": getattr(run, "num_ps", None),
                    "workers": list(workers), "n_runs": n_runs,
                    "measure_steps": measure_steps},
            engine="scalar", wall_s=wall,
            mean_err=sum(errs) / len(errs) if errs else None,
            max_err=max(errs) if errs else None,
            extra={"workers": list(workers)})
    return out
