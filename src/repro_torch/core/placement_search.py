"""Topology-aware PS placement search: the predictor as an optimizer,
copied from ``repro.core.placement_search`` expression for expression.

The paper's §6 envisions the throughput model inside a scheduler that
*chooses* transmission and placement policies; the topology layer
can score any shard->node mapping, and this module closes the loop by
searching over them.  Three strategies behind one API:

  * ``exhaustive`` — enumerate every ``hosts^M`` assignment (small
    clusters; the correctness oracle the other strategies are gated
    against);
  * ``greedy``     — marginal-gain construction (coordinate passes: for
    each shard, try every host with the others fixed and keep the best)
    followed by swap-based local search (exchange the hosts of two
    shards), iterated to a fixpoint;
  * ``anneal``     — simulated-annealing refinement (single-shard moves
    and swaps under a geometric temperature schedule), seeded from the
    greedy solution by default;
  * ``surrogate``  — enumerate the candidate space like ``exhaustive``
    but score it with a *waterfill-only* throughput proxy first
    (``bandwidth.batched_waterfill`` over the stacked per-candidate group
    matrices — thousands of candidates per numpy call, no DES at all),
    then spend full DES evaluation on the top ``1/surrogate_prune``
    shortlist only.  The first concrete step on the datacenter-scale
    scheduling roadmap item: ~``surrogate_prune``x fewer simulator runs
    than full enumeration while (gated by the reference's ``benchmarks/fig_placement``)
    returning the same chosen placement on the figure families.

Every candidate is scored by the same objective the paper validates: the
DES's predicted examples/s (proportional to updates/s at fixed batch
size).  Candidate batches fan out through ``repro_torch.core.sweep`` — each
(candidate, seed) task carries a self-contained ``SimConfig``, so serial
and parallel evaluation are bit-identical — and scores are memoized per
placement, so the greedy construction, the swap search, and the
exhaustive oracle share work instead of re-simulating.

Candidate evaluation runs the simulator's general (topology) path, whose
bandwidth re-solves are group-local by default (``SimConfig.waterfill=
"auto"`` -> ``bandwidth.IncrementalWaterfill``): scoring hundreds of
near-identical placements issues component-sized re-solves instead of
full re-waterfills.  Pass ``waterfill="batch"`` through
``evaluator_from_templates(...)``/``PredictionRun`` to pin the historical
batch solver (the differential baseline; identical shares either way).

The searched-over baseline (the topology's own default placement, i.e.
the paper's star convention of shard ``p`` on ``ps_nodes[p]``) is always
scored too, and the returned placement is never worse than it.
"""
from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import (Callable, Dict, List, Optional, Sequence, Tuple)

import numpy as np

from .bandwidth import (_direction_of, batched_waterfill,
                        stack_waterfill_problems)
from .events import LINK
from .simulator import SimConfig, compile_template
from .sweep import SimulationPool
from .topology import Topology

__all__ = [
    "PlacementEvaluator", "SearchResult", "search_placement",
    "evaluator_from_run", "evaluator_from_templates", "STRATEGIES",
    "surrogate_scores",
]

Hosts = Tuple[str, ...]

STRATEGIES = ("exhaustive", "greedy", "anneal", "surrogate")

# Exhaustive enumeration refuses beyond this many candidates: at that
# point the cluster is exactly the regime greedy/anneal exist for.
DEFAULT_MAX_EXHAUSTIVE = 4096

# Relative improvement below this is float noise, not a better placement
# (keeps the greedy fixpoint loop from ping-ponging between ties).
_IMPROVE_EPS = 1e-12


class PlacementEvaluator:
    """Scores shard->node placements by predicted throughput.

    ``make_tasks(hosts)`` returns the seeded ``simulate_task`` payloads
    for one candidate placement (one per simulation run); their mean
    examples/s is the candidate's score.  Batches are deduplicated,
    memoized, and fanned across cores through one persistent
    :class:`sweep.SimulationPool` (iterative strategies evaluate many
    small batches; re-creating an executor per batch would pay startup
    every annealing step).  Use as a context manager, or call
    :meth:`close`, to release the pool's worker processes early.
    """

    def __init__(self, topology: Topology,
                 make_tasks: Callable[[Hosts], list],
                 templates: Optional[list] = None,
                 parallel: bool = True,
                 max_workers: Optional[int] = None):
        self.topology = topology
        self._make_tasks = make_tasks
        self._pool = SimulationPool(templates=templates, parallel=parallel,
                                    max_workers=max_workers)
        self._cache: Dict[Hosts, float] = {}
        self.evaluated = 0          # unique placements simulated so far
        self._node_names = frozenset(
            n.name for n in topology.workers + topology.ps_nodes)

    def close(self) -> None:
        self._pool.close()

    def __enter__(self) -> "PlacementEvaluator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- structure

    @property
    def num_shards(self) -> int:
        return self.topology.num_shards

    def default_placement(self) -> Hosts:
        """The topology's own shard->host mapping (the search baseline)."""
        return self.topology.shard_hosts()

    def candidate_hosts(self, colocation: bool = True) -> Hosts:
        """Every node a shard could live on: dedicated PS nodes first,
        then (with ``colocation``) the worker nodes."""
        names = [n.name for n in self.topology.ps_nodes]
        if colocation or not names:
            names += [n.name for n in self.topology.workers]
        return tuple(names)

    def validate(self, placement: Sequence[str]) -> Hosts:
        hosts = tuple(placement)
        if len(hosts) != self.num_shards:
            raise ValueError(
                f"placement {hosts!r} has {len(hosts)} host(s) but the "
                f"topology has {self.num_shards} PS shard(s)")
        for h in hosts:
            if h not in self._node_names:
                raise ValueError(
                    f"placement host {h!r} is not a node of this topology "
                    f"(known nodes: {sorted(self._node_names)})")
        return hosts

    # ------------------------------------------------------------- scoring

    def score_many(self, placements: Sequence[Sequence[str]]) -> List[float]:
        """Mean predicted examples/s per placement (order-preserving).
        Unseen placements are simulated in one parallel batch."""
        wanted = [self.validate(p) for p in placements]
        todo = [h for h in dict.fromkeys(wanted) if h not in self._cache]
        if todo:
            batches = [self._make_tasks(h) for h in todo]
            flat = [t for b in batches for t in b]
            outs = self._pool.map(flat)
            i = 0
            for hosts, batch in zip(todo, batches):
                chunk = outs[i:i + len(batch)]
                i += len(batch)
                self._cache[hosts] = sum(chunk) / len(chunk)
            self.evaluated += len(todo)
        return [self._cache[h] for h in wanted]

    def score(self, placement: Sequence[str]) -> float:
        return self.score_many([placement])[0]


# ------------------------------------------------------------- constructors


def evaluator_from_run(run, topology: Topology, num_workers: int,
                       n_runs: int = 3, parallel: bool = True,
                       max_workers: Optional[int] = None
                       ) -> PlacementEvaluator:
    """Objective = the full paper pipeline: ``run``'s profiled step
    templates simulated at ``num_workers`` under each candidate placement
    of ``topology`` (profiling happens once — the paper's own premise —
    and every candidate reuses it)."""
    if hasattr(run, "sync_spec") and run.sync_spec().mode == "allreduce":
        raise ValueError(
            "placement search scores PS shard placements; the allreduce "
            "regime has no parameter servers to place")
    if not run.sim_steps_templates:
        run.prepare()

    def make_tasks(hosts: Hosts) -> list:
        r = run.with_topology(topology.with_placement(hosts))
        return r.prediction_tasks(num_workers, n_runs)

    return PlacementEvaluator(topology, make_tasks,
                              templates=run.sim_steps_templates,
                              parallel=parallel, max_workers=max_workers)


def evaluator_from_templates(topology: Topology, templates: list,
                             num_workers: int, *, n_runs: int = 1,
                             steps_per_worker: int = 30,
                             warmup_steps: int = 5, batch_size: int = 32,
                             seed: int = 0, parallel: bool = True,
                             max_workers: Optional[int] = None,
                             **cfg_kwargs) -> PlacementEvaluator:
    """Objective over raw :class:`StepTemplate` lists — synthetic
    workloads and tests, no profiling stage.  ``topology.bandwidth`` must
    be set (``SimConfig(topology=...)`` compiles resources from it);
    extra ``cfg_kwargs`` (link_policy, win, service_jitter, ...) go to
    every candidate's :class:`SimConfig`."""

    def make_tasks(hosts: Hosts) -> list:
        topo = topology.with_placement(hosts)
        tasks = []
        for i in range(n_runs):
            cfg = SimConfig(topology=topo, steps_per_worker=steps_per_worker,
                            warmup_steps=warmup_steps, seed=seed + 101 * i,
                            **cfg_kwargs)
            tasks.append((cfg, templates, num_workers, batch_size,
                          warmup_steps))
        return tasks

    return PlacementEvaluator(topology, make_tasks, templates=templates,
                              parallel=parallel, max_workers=max_workers)


# ----------------------------------------------------------- surrogate proxy


def surrogate_scores(evaluator: PlacementEvaluator,
                     candidates: Sequence[Hosts]) -> np.ndarray:
    """Waterfill-only throughput proxy for every candidate placement.

    No DES runs: each candidate's topology compiles to its capacity
    groups, steady-state allocations for all candidates are solved in
    batched :func:`bandwidth.batched_waterfill` calls, and a candidate's
    score is the straggler-bound rate proxy

        W / max_w (t_compute + sum_links work(link) / share(w, link))

    over the evaluator's own step templates.  Two modelling choices make
    the ranking track the DES:

      * **phase split** — the download and upload halves of a step
        alternate in time, so each fabric direction gets its own
        waterfill problem (downlink conns only, then uplink conns only).
        One all-conns-active problem would charge a colocated host's
        outbound *uploads* against the remote workers' *downloads*
        through the shared node-tx group — contention the simulator
        never exhibits simultaneously — flattening exactly the
        colocation signal the prefilter exists to surface;
      * **straggler max** — the max (not a sum of per-worker rates)
        mirrors the DES objective: every worker runs a fixed step count
        and throughput divides by the END time, so the slowest worker is
        the denominator.

    Scores are a *ranking* surrogate (scheduling, jitter and pipelining
    are ignored); ties preserve candidate order downstream.
    """
    task = evaluator._make_tasks(evaluator.default_placement())[0]
    cfg, templates, W = task[0], task[1], task[2]
    link_work: Dict[str, float] = {}
    comp = 0.0
    for tpl in templates:
        ops, works, _edges, _roots = compile_template(tpl, cfg.resources)
        for op, wk in zip(ops, works):
            spec = cfg.resources[op.res]
            if spec.kind == LINK:
                # link work is in bytes; convert to seconds-at-full-share
                # so it adds to compute durations in one time unit
                link_work[op.res] = (link_work.get(op.res, 0.0)
                                     + wk / spec.bandwidth)
            else:
                comp += wk
    n = len(templates)
    comp /= n
    phases: Dict[str, List[str]] = {}
    for r in sorted(link_work):
        phases.setdefault(_direction_of(r), []).append(r)
    models = [evaluator.topology.with_placement(hosts).grouped_model()
              for hosts in candidates]
    t_step = np.full((len(candidates), W), comp)   # [B, W] per-worker time
    for links in phases.values():
        lw = np.array([link_work[r] / n for r in links])
        conns = [(w, r) for w in range(W) for r in links]
        problems = []
        for model in models:
            caps, members = model.groups_for(conns)
            problems.append((conns, caps, members))
        _cols, caps_m, mem_m, wt_m = stack_waterfill_problems(problems)
        shares = batched_waterfill(caps_m, mem_m, wt_m)
        sh = shares.reshape(len(candidates), W, len(links))
        t_step += (lw / sh).sum(axis=2)
    return W / t_step.max(axis=1)


# ------------------------------------------------------------------ results


@dataclass(frozen=True)
class SearchResult:
    strategy: str
    placement: Hosts                  # best found (never worse than base)
    throughput: float                 # its predicted examples/s
    baseline_placement: Hosts         # the topology's default placement
    baseline_throughput: float
    evaluated: int                    # unique placements this search scored
    rounds: int                       # greedy fixpoint rounds / anneal iters

    @property
    def speedup(self) -> float:
        if self.baseline_throughput == 0:
            return float("inf")
        return self.throughput / self.baseline_throughput

    def summary(self) -> str:
        return (f"{self.strategy}: {'/'.join(self.placement)} "
                f"{self.throughput:.2f} ex/s "
                f"({self.speedup:.2f}x over default "
                f"{'/'.join(self.baseline_placement)}, "
                f"{self.evaluated} candidates)")


# --------------------------------------------------------------- strategies


def _argmax(scores: List[float]) -> int:
    """First index of the maximum — ties break toward the earlier
    candidate, so results are independent of pool scheduling."""
    best = 0
    for i in range(1, len(scores)):
        if scores[i] > scores[best]:
            best = i
    return best


def _improves(new: float, cur: float) -> bool:
    return new > cur + _IMPROVE_EPS * max(1.0, abs(cur))


def _swaps(cur: Hosts) -> List[Hosts]:
    out = []
    for p in range(len(cur)):
        for q in range(p + 1, len(cur)):
            if cur[p] != cur[q]:
                swapped = list(cur)
                swapped[p], swapped[q] = swapped[q], swapped[p]
                out.append(tuple(swapped))
    return out


def _greedy(ev: PlacementEvaluator, hosts: Hosts, start: Hosts,
            max_rounds: int) -> Tuple[Hosts, float, int]:
    """Marginal-gain coordinate passes + swap local search to a fixpoint."""
    cur, cur_s = start, ev.score(start)
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        improved = False
        # construction pass: re-place one shard at a time, others fixed
        for p in range(len(cur)):
            cands = [cur[:p] + (h,) + cur[p + 1:] for h in hosts]
            scores = ev.score_many(cands)
            i = _argmax(scores)
            if _improves(scores[i], cur_s):
                cur, cur_s = cands[i], scores[i]
                improved = True
        # local search: exchange the hosts of two shards
        swaps = _swaps(cur)
        if swaps:
            scores = ev.score_many(swaps)
            i = _argmax(scores)
            if _improves(scores[i], cur_s):
                cur, cur_s = swaps[i], scores[i]
                improved = True
        if not improved:
            break
    return cur, cur_s, rounds


def _anneal(ev: PlacementEvaluator, hosts: Hosts, start: Hosts, seed: int,
            iters: int) -> Tuple[Hosts, float, int]:
    """Metropolis refinement around ``start``.  All randomness comes from
    one seeded generator and all scores are deterministic (memoized,
    explicit per-task seeds), so a fixed seed gives one trajectory —
    serial or parallel."""
    rng = random.Random(seed)
    cur, cur_s = start, ev.score(start)
    best, best_s = cur, cur_s
    t_hot = 0.05 * max(abs(cur_s), 1e-12)
    t_cold = 1e-3 * t_hot
    for k in range(iters):
        temp = t_hot * (t_cold / t_hot) ** (k / max(iters - 1, 1))
        nxt = list(cur)
        if len(cur) >= 2 and rng.random() < 0.3:
            p, q = rng.sample(range(len(cur)), 2)
            nxt[p], nxt[q] = nxt[q], nxt[p]
        else:
            p = rng.randrange(len(cur))
            nxt[p] = hosts[rng.randrange(len(hosts))]
        nxt = tuple(nxt)
        if nxt == cur:
            continue
        s = ev.score(nxt)
        if s >= cur_s or rng.random() < math.exp((s - cur_s) / temp):
            cur, cur_s = nxt, s
            if s > best_s:
                best, best_s = nxt, s
    return best, best_s, iters


# --------------------------------------------------------------- entry point


def search_placement(evaluator: PlacementEvaluator,
                     strategy: str = "greedy", *,
                     hosts: Optional[Sequence[str]] = None,
                     colocation: bool = True,
                     start: Optional[Sequence[str]] = None,
                     seed: int = 0,
                     max_exhaustive: int = DEFAULT_MAX_EXHAUSTIVE,
                     max_rounds: int = 32,
                     anneal_iters: int = 64,
                     surrogate_prune: int = 16,
                     surrogate_cap: int = 1 << 16) -> SearchResult:
    """Search shard->node placements of the evaluator's topology,
    maximizing predicted throughput.

    ``hosts`` restricts the candidate nodes (default: every PS node,
    plus every worker node when ``colocation``); ``start`` seeds greedy
    construction and annealing (default: the topology's own placement).
    The result is never worse than the default placement — the baseline
    is always scored and kept if the search cannot beat it.

    ``surrogate`` enumerates the same space as ``exhaustive`` but scores
    it with :func:`surrogate_scores` (one batched waterfill, no DES),
    then runs the full simulator only on the top ``1/surrogate_prune``
    fraction of candidates.  ``surrogate_cap`` bounds the enumerated
    space (the proxy is vectorized, but not free).
    """
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown strategy {strategy!r} (choose from {STRATEGIES})")
    host_list = tuple(hosts) if hosts is not None \
        else evaluator.candidate_hosts(colocation)
    if not host_list:
        raise ValueError("placement search needs at least one candidate "
                         "host")
    seen = set()
    for h in host_list:
        if h in seen:
            raise ValueError(f"duplicate candidate host {h!r}")
        seen.add(h)
        # every candidate host must exist BEFORE any simulation is spent
        evaluator.validate((h,) * evaluator.num_shards)

    M = evaluator.num_shards
    evaluated_before = evaluator.evaluated
    baseline = evaluator.default_placement()
    base_s = evaluator.score(baseline)
    init = evaluator.validate(start) if start is not None else baseline

    if strategy == "exhaustive":
        space = len(host_list) ** M
        if space > max_exhaustive:
            raise ValueError(
                f"exhaustive search over {len(host_list)} hosts x {M} "
                f"shards is {space} candidates (> {max_exhaustive}); use "
                f"strategy='greedy' or 'anneal', or pass a larger "
                f"max_exhaustive")
        cands = [tuple(c) for c in
                 itertools.product(host_list, repeat=M)]
        scores = evaluator.score_many(cands)
        i = _argmax(scores)
        best, best_s, rounds = cands[i], scores[i], 1
    elif strategy == "surrogate":
        space = len(host_list) ** M
        if space > surrogate_cap:
            raise ValueError(
                f"surrogate search over {len(host_list)} hosts x {M} "
                f"shards is {space} candidates (> {surrogate_cap}); use "
                f"strategy='greedy' or 'anneal', or pass a larger "
                f"surrogate_cap")
        cands = [tuple(c) for c in
                 itertools.product(host_list, repeat=M)]
        proxy = surrogate_scores(evaluator, cands)
        keep = max(1, -(-len(cands) // surrogate_prune))
        order = sorted(range(len(cands)), key=lambda i: (-proxy[i], i))
        # one representative per proxy-tied class first: symmetric
        # placements tie *exactly* (identical stacked-solve rows), so a
        # second member of a tied class spends a shortlist slot on a
        # placement the DES scores identically; leftovers fill by rank
        firsts, dups, seen = [], [], set()
        for i in order:
            v = round(float(proxy[i]), 12)
            if v in seen:
                dups.append(i)
            else:
                seen.add(v)
                firsts.append(i)
        # re-sort the shortlist by candidate index: DES ties then break
        # toward the earlier candidate, exactly as exhaustive does
        short = sorted((firsts + dups)[:keep])
        short_cands = [cands[i] for i in short]
        scores = evaluator.score_many(short_cands)
        i = _argmax(scores)
        best, best_s, rounds = short_cands[i], scores[i], 1
    elif strategy == "greedy":
        best, best_s, rounds = _greedy(evaluator, host_list, init,
                                       max_rounds)
    else:                              # anneal: refine the greedy solution
        g_best, _g_s, _r = _greedy(evaluator, host_list, init, max_rounds)
        best, best_s, rounds = _anneal(evaluator, host_list, g_best, seed,
                                       anneal_iters)

    if base_s > best_s:                # never return worse than the default
        best, best_s = baseline, base_s
    return SearchResult(
        strategy=strategy, placement=best, throughput=best_s,
        baseline_placement=baseline, baseline_throughput=base_s,
        evaluated=evaluator.evaluated - evaluated_before,
        rounds=rounds)
