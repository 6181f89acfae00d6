"""Fault injection: worker churn, PS failover, degraded networks.

The paper's predictor answers "what throughput will this cluster reach?"
under the assumption that every node is healthy and the network clean.
Deployments misbehave exactly where the prediction matters most — spot
preemption, flapping workers, saturated uplinks — so this module makes
failure scenarios first-class DES inputs:

  * :class:`FaultSpec` — a picklable, seedable description of the failure
    processes (worker MTTF/MTTR churn, spot preemption, PS-shard failover
    with a spare/colocated backup policy, stochastic per-link capacity
    degradation) plus explicit incident lists for deterministic tests;
  * :func:`compile_faults` — expands a spec into a :class:`FaultSchedule`,
    a sorted list of ``(t_down, t_up)`` incidents drawn from a *dedicated*
    ``random.Random(fault_seed)`` stream.  The simulation RNG is never
    touched, so an empty schedule is provably inert (golden-trace tests
    pass unchanged) and the same spec replays bit-identically on the DES
    engine, the cluster emulator, and across serial/parallel sweeps;
  * :class:`CheckpointCostModel` — the restore-time model charged on every
    worker restart (``beta + alpha * model_bytes``), calibratable against
    ``repro_torch.checkpoint``'s restore timings.

Both engines deliver incidents as ordinary calendar/timer events: a crash
kills the worker's in-flight chunks and flows (wasted work), the restore
re-enters the step loop after ``MTTR + restore_cost``, and degradation
epochs re-scale link capacity groups through the incremental waterfill.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CheckpointCostModel", "FaultSpec", "FaultEvent", "FaultSchedule",
    "compile_faults", "shard_link_names",
]

BACKUP_POLICIES = ("spare", "colocated")

# Hard per-process event cap: a runaway mttf << horizon must not allocate
# unbounded schedules (the DES would also never get through them).
_MAX_EVENTS_PER_PROCESS = 10_000


@dataclass(frozen=True)
class CheckpointCostModel:
    """Restore cost charged when a worker rejoins after a crash/preemption.

    ``restore_cost = beta + alpha * model_bytes``: a fixed process-restart
    term plus a size-proportional parameter-load term.  Defaults are
    conservative generic-disk numbers; :meth:`calibrate` fits both against
    the real checkpoint manager on synthetic trees.
    """

    alpha: float = 4e-9   # s/byte (parameter load + re-place)
    beta: float = 0.5     # s (process restart, session setup)

    def __post_init__(self):
        if self.alpha < 0 or self.beta < 0:
            raise ValueError(
                f"checkpoint cost terms must be >= 0, got alpha={self.alpha} "
                f"beta={self.beta}")

    def restore_cost(self, model_bytes: float) -> float:
        return self.beta + self.alpha * model_bytes

    @classmethod
    def calibrate(cls, ckpt_dir: str,
                  sizes: Sequence[int] = (1 << 16, 1 << 18, 1 << 20),
                  beta_floor: float = 0.0,
                  device="cuda") -> "CheckpointCostModel":
        """Fit (alpha, beta) by timing real ``repro_torch.checkpoint`` round
        trips on synthetic float32 trees of the given element counts.

        Measures the *restore* path (what a restarting worker pays: the
        read and the copy onto ``device``, the card unless the caller asks
        for the CPU) and least-squares fits time vs bytes; slope and
        intercept are clamped to be non-negative.
        """
        import time

        import torch

        from repro_torch import checkpoint as ck
        from repro_torch.device import require_device

        dev = require_device(device)
        xs: List[float] = []
        ys: List[float] = []
        for j, n in enumerate(sizes):
            tree = {"p": torch.arange(int(n), dtype=torch.float32,
                                      device=dev)}
            d = f"{ckpt_dir}/cal_{j}"
            ck.save(d, 0, tree)
            t0 = time.perf_counter()
            ck.restore(d, tree)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            xs.append(float(n) * 4.0)
            ys.append(dt)
        mx = sum(xs) / len(xs)
        my = sum(ys) / len(ys)
        var = sum((x - mx) ** 2 for x in xs)
        cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        alpha = max(0.0, cov / var) if var > 0 else 0.0
        beta = max(beta_floor, my - alpha * mx)
        return cls(alpha=alpha, beta=beta)


@dataclass(frozen=True)
class FaultSpec:
    """Failure processes of one run (picklable; rides inside ``SimConfig``,
    ``PredictionRun`` and the sweep/measure task payloads).

    Stochastic knobs (all rates/means in simulated seconds; 0 = off):

    ``mttf``/``mttr``        exponential worker crash/repair processes; a
                             crashed worker additionally pays the
                             checkpoint-restore cost before rejoining.
    ``preempt_rate``         spot preemptions per second per worker;
                             ``preempt_downtime`` is the mean outage before
                             replacement capacity arrives.
    ``degrade_*``            per-link capacity-degradation epochs: each
                             link in ``degrade_links`` alternates healthy
                             gaps (mean ``degrade_period``) and degraded
                             epochs (mean ``degrade_duration``) at capacity
                             multiplier ``degrade_factor``.
    ``ps_failures``          explicit ``(time, shard)`` PS-shard outages;
                             the shard's links carry zero capacity until
                             failover completes — ``failover_spare``
                             seconds when a cold spare host must be
                             attached, ``failover_colocated`` when a warm
                             backup shard is colocated with a worker
                             (``backup_policy`` selects which).

    Explicit ``crashes``/``preemptions``/``degrade_epochs`` lists pin
    incidents for deterministic tests; explicit worker incidents use the
    deterministic downtime ``mttr`` (resp. ``preempt_downtime``) with no
    RNG draw.  ``ckpt_interval_steps`` models checkpoint cadence: a
    restored worker's SSP iteration counter rolls back to the last
    multiple (0 = checkpoint every step, no rollback).
    """

    mttf: float = 0.0
    mttr: float = 0.0
    preempt_rate: float = 0.0
    preempt_downtime: float = 0.0
    crashes: Tuple[Tuple[float, int], ...] = ()
    preemptions: Tuple[Tuple[float, int], ...] = ()
    ps_failures: Tuple[Tuple[float, int], ...] = ()
    backup_policy: str = "spare"
    failover_spare: float = 20.0
    failover_colocated: float = 5.0
    degrade_links: Tuple[str, ...] = ()
    degrade_factor: float = 1.0
    degrade_period: float = 0.0
    degrade_duration: float = 0.0
    degrade_epochs: Tuple[Tuple[float, float, str, float], ...] = ()
    ckpt: CheckpointCostModel = field(default_factory=CheckpointCostModel)
    model_bytes: float = 0.0
    ckpt_interval_steps: int = 0
    fault_seed: int = 0
    horizon: float = 3600.0

    def __post_init__(self):
        for name in ("mttf", "mttr", "preempt_rate", "preempt_downtime",
                     "degrade_period", "degrade_duration", "model_bytes",
                     "failover_spare", "failover_colocated", "horizon"):
            v = getattr(self, name)
            if v < 0:
                raise ValueError(f"FaultSpec.{name} must be >= 0, got {v}")
        if not (0.0 <= self.degrade_factor <= 1.0):
            raise ValueError(
                f"degrade_factor is a capacity multiplier in [0, 1], got "
                f"{self.degrade_factor}")
        if self.backup_policy not in BACKUP_POLICIES:
            raise ValueError(
                f"unknown backup_policy {self.backup_policy!r} "
                f"(expected one of {BACKUP_POLICIES})")
        if self.ckpt_interval_steps < 0:
            raise ValueError(
                f"ckpt_interval_steps must be >= 0, got "
                f"{self.ckpt_interval_steps}")
        for t, w in tuple(self.crashes) + tuple(self.preemptions):
            if t < 0 or w < 0:
                raise ValueError(
                    f"explicit incident (t={t}, worker={w}) must be "
                    f"non-negative")
        for t, p in self.ps_failures:
            if t < 0 or p < 0:
                raise ValueError(
                    f"ps failure (t={t}, shard={p}) must be non-negative")
        for t0, t1, _lname, fac in self.degrade_epochs:
            if not (0 <= t0 < t1):
                raise ValueError(
                    f"degrade epoch needs 0 <= t0 < t1, got [{t0}, {t1})")
            if not (0.0 <= fac <= 1.0):
                raise ValueError(
                    f"degrade epoch factor must be in [0, 1], got {fac}")

    def restore_cost(self) -> float:
        return self.ckpt.restore_cost(self.model_bytes)

    def failover_time(self) -> float:
        return (self.failover_colocated if self.backup_policy == "colocated"
                else self.failover_spare)

    def empty(self) -> bool:
        """True when the compiled schedule is guaranteed empty — the
        engines then take their untouched (golden-trace) code paths."""
        stochastic_churn = self.mttf > 0 or self.preempt_rate > 0
        stochastic_degrade = (self.degrade_links
                              and self.degrade_factor < 1.0
                              and self.degrade_period > 0
                              and self.degrade_duration > 0)
        return not (stochastic_churn or stochastic_degrade or self.crashes
                    or self.preemptions or self.ps_failures
                    or self.degrade_epochs)


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled incident: the target is down during [t_down, t_up)."""

    t_down: float
    t_up: float
    kind: str        # 'crash' | 'preempt' | 'ps_fail' | 'degrade'
    target: object   # worker index | PS shard index | link resource name
    factor: float = 0.0   # degrade: capacity multiplier during the epoch

    @property
    def recovery(self) -> float:
        return self.t_up - self.t_down


@dataclass(frozen=True)
class FaultSchedule:
    """A compiled, fully deterministic incident list (sorted by t_down)."""

    incidents: Tuple[FaultEvent, ...]

    def __bool__(self) -> bool:
        return bool(self.incidents)

    def worker_events(self) -> List[FaultEvent]:
        return [e for e in self.incidents if e.kind in ("crash", "preempt")]

    def link_events(self) -> List[FaultEvent]:
        return [e for e in self.incidents if e.kind in ("degrade", "ps_fail")]


def shard_link_names(shard: int, resources: Dict[str, object],
                     topology=None) -> Tuple[str, str]:
    """The (downlink, uplink) resource names served by one PS shard."""
    if topology is not None:
        return (topology.link_name("downlink", shard),
                topology.link_name("uplink", shard))
    if "downlink" in resources and shard == 0:
        return ("downlink", "uplink")
    names = (f"downlink:{shard}", f"uplink:{shard}")
    for n in names:
        if n not in resources:
            raise ValueError(
                f"ps_failures names shard {shard} but the resource set has "
                f"no {n!r} link")
    return names


def _merge_target(events: List[Tuple[float, float, str, float]]
                  ) -> List[Tuple[float, float, str, float]]:
    """Per-target normalization: sort by start, drop incidents that begin
    while a previous one is still open (a down node cannot go down)."""
    out: List[Tuple[float, float, str, float]] = []
    t_clear = -1.0
    for ev in sorted(events):
        if ev[0] < t_clear:
            continue
        out.append(ev)
        t_clear = ev[1]
    return out


def compile_faults(spec: FaultSpec, num_workers: int,
                   link_names: Sequence[str] = (),
                   num_shards: int = 1,
                   resources: Optional[Dict[str, object]] = None,
                   topology=None) -> FaultSchedule:
    """Expand a :class:`FaultSpec` into the per-run incident schedule.

    All stochastic draws come from one dedicated ``Random(fault_seed)``
    stream consumed in a fixed order (worker churn by ascending worker,
    then degradation by ``degrade_links`` order), so the schedule is a
    pure function of ``(spec, num_workers, link_names, num_shards)`` —
    identical for the DES engine, the emulator, and every sweep worker.
    """
    rng = random.Random(spec.fault_seed)
    restore = spec.restore_cost()
    horizon = spec.horizon
    incidents: List[FaultEvent] = []

    # -- worker churn: stochastic crash + preemption streams per worker --
    for w in range(num_workers):
        cand: List[Tuple[float, float, str, float]] = []
        if spec.mttf > 0:
            t, n = 0.0, 0
            while n < _MAX_EVENTS_PER_PROCESS:
                t += rng.expovariate(1.0 / spec.mttf)
                if t >= horizon:
                    break
                down = restore + (rng.expovariate(1.0 / spec.mttr)
                                  if spec.mttr > 0 else 0.0)
                cand.append((t, t + down, "crash", 0.0))
                t += down
                n += 1
        if spec.preempt_rate > 0:
            t, n = 0.0, 0
            while n < _MAX_EVENTS_PER_PROCESS:
                t += rng.expovariate(spec.preempt_rate)
                if t >= horizon:
                    break
                down = restore + (rng.expovariate(
                    1.0 / spec.preempt_downtime)
                    if spec.preempt_downtime > 0 else 0.0)
                cand.append((t, t + down, "preempt", 0.0))
                t += down
                n += 1
        for t, cw in spec.crashes:
            if cw == w:
                cand.append((t, t + spec.mttr + restore, "crash", 0.0))
        for t, cw in spec.preemptions:
            if cw == w:
                cand.append(
                    (t, t + spec.preempt_downtime + restore, "preempt", 0.0))
        for t0, t1, kind, _f in _merge_target(cand):
            incidents.append(FaultEvent(t0, t1, kind, w))

    # -- PS-shard failover (explicit; downtime set by the backup policy) --
    by_shard: Dict[int, List[Tuple[float, float, str, float]]] = {}
    for t, p in spec.ps_failures:
        if p >= num_shards:
            raise ValueError(
                f"ps_failures names shard {p} but the run has only "
                f"{num_shards} shard(s)")
        by_shard.setdefault(p, []).append(
            (t, t + spec.failover_time(), "ps_fail", 0.0))
    for p, evs in sorted(by_shard.items()):
        for t0, t1, kind, _f in _merge_target(evs):
            incidents.append(FaultEvent(t0, t1, kind, p))

    # -- network degradation epochs --
    by_link: Dict[str, List[Tuple[float, float, str, float]]] = {}
    stochastic = (spec.degrade_factor < 1.0 and spec.degrade_period > 0
                  and spec.degrade_duration > 0)
    for lname in spec.degrade_links:
        if link_names and lname not in link_names:
            raise ValueError(
                f"degrade_links names unknown link {lname!r} "
                f"(known: {sorted(link_names)})")
        if not stochastic:
            continue
        t, n = 0.0, 0
        evs = by_link.setdefault(lname, [])
        while n < _MAX_EVENTS_PER_PROCESS:
            t += rng.expovariate(1.0 / spec.degrade_period)
            if t >= horizon:
                break
            dur = rng.expovariate(1.0 / spec.degrade_duration)
            evs.append((t, t + dur, "degrade", spec.degrade_factor))
            t += dur
            n += 1
    for t0, t1, lname, fac in spec.degrade_epochs:
        if link_names and lname not in link_names:
            raise ValueError(
                f"degrade_epochs names unknown link {lname!r} "
                f"(known: {sorted(link_names)})")
        by_link.setdefault(lname, []).append((t0, t1, "degrade", fac))
    for lname in sorted(by_link):
        for t0, t1, kind, fac in _merge_target(by_link[lname]):
            incidents.append(FaultEvent(t0, t1, kind, lname, fac))

    incidents.sort(key=lambda e: (e.t_down, e.kind, str(e.target)))
    return FaultSchedule(incidents=tuple(incidents))
