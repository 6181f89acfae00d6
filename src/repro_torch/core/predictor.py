"""End-to-end prediction pipeline (the paper's workflow, §4.1).

    1. profile the job for ~100 steps with 1 worker (+ M PS) — here via the
       cluster emulator, in the real system via TensorFlow traces;
    2. calibrate the platform once: parse-overhead linear model from probes,
       WIN from captured HTTP/2 headers (we use the platform's nominal mean,
       as the paper does — its drift is a known error source);
    3. preprocess recorded steps -> simulation-ready StepTemplates;
    4. discrete-event simulate W workers for N steps; report examples/s.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

from repro_torch.core import baselines as bl
from repro_torch.core.bandwidth import BandwidthModel, EqualShareModel
from repro_torch.core.events import LINK, StepTemplate, ps_resources
from repro_torch.core.faults import FaultSpec
from repro_torch.core.overhead import (OverheadModel, RecordedStep,
                                       preprocess_profile)
from repro_torch.core.paper_models import PAPER_DNNS, PLATFORMS, Platform
from repro_torch.core.simulator import SimConfig, Simulation
from repro_torch.core.syncmode import SyncSpec, allreduce_templates
from repro_torch.core.topology import Topology
from repro_torch.emulator.cluster import (measure_throughput,
                                          probe_parse_overheads,
                                          profile_single_worker)

# Probe sizes used for the per-platform overhead calibration (Fig. 10).
PROBE_SIZES = [2 ** i * 1e5 for i in range(10)]  # 100 KB .. 51.2 MB


def calibrate_overhead(platform: Platform, seed: int = 0) -> OverheadModel:
    sizes = PROBE_SIZES
    measured = probe_parse_overheads(platform, sizes, seed=seed)
    return OverheadModel.fit(sizes, measured)


@dataclass
class PredictionRun:
    dnn: str
    batch_size: int
    platform: str
    num_ps: int = 1
    flow_control: bool = True
    order: str = "profiled"
    seed: int = 0
    profile_steps: int = 100
    sim_steps: int = 400
    warmup_steps: int = 50
    win_estimate: Optional[float] = None   # None -> platform nominal mean
    bandwidth_model: Optional[BandwidthModel] = None
    # Cluster structure (None = the paper's flat star).  Profiling stays
    # topology-free — the paper's method profiles ONE worker against the
    # PS shards, then simulates any cluster; the topology enters through
    # the bandwidth model, compute speed factors, and the emulator's
    # ground-truth fabric.
    topology: Optional[Topology] = None
    # Synchronization regime (repro_torch.core.syncmode).  Profiling stays
    # async-PS — the 1-worker profile already carries the per-layer sizes
    # and compute durations every regime needs — and the mode enters
    # through the simulator's step-barrier controller (sync/ssp) or a
    # per-W rewrite of the step DAG (allreduce).
    sync_mode: str = "async"
    backup_workers: int = 0
    staleness_bound: int = 0
    allreduce_algo: str = "ring"
    # General-path bandwidth re-solve strategy (SimConfig.waterfill):
    # "auto" = group-local incremental solves (bit-identical shares),
    # "batch" = the historical full re-waterfill per membership change.
    waterfill: str = "auto"
    # Fault schedule (repro_torch.core.faults).  None = healthy cluster.  The
    # same FaultSpec is compiled to the same incident list in the DES
    # engine and the emulator (both keyed off spec.fault_seed), so
    # prediction and ground truth see identical churn.
    faults: Optional["FaultSpec"] = None
    # Fitted parameters from observed traces (the reference's
    # ``repro.calibrate``; fitting is ROADMAP 1.18b here, and any object
    # with its ``apply_to_templates`` / ``overhead_model`` /
    # ``capacity_for`` / ``digest`` interface is accepted).  None =
    # predict from the profile + platform nominals alone (the paper's
    # open-loop mode).  A profile overrides per-op compute times and
    # parse alpha/beta in the preprocessed templates, and per-link
    # capacities / the flow-control stall rate in the sim config; a
    # profile whose values equal the profiled medians and nominals is
    # provably inert (bit-identical traces — see tests/test_calibrate.py).
    calibration: Optional["CalibrationProfile"] = None

    # filled by prepare()
    profile: List[RecordedStep] = field(default_factory=list)
    sim_steps_templates: List[StepTemplate] = field(default_factory=list)
    overhead: Optional[OverheadModel] = None

    def __post_init__(self):
        if self.topology is not None:
            shards = self.topology.num_shards
            if self.num_ps not in (1, shards):
                raise ValueError(
                    f"num_ps={self.num_ps} conflicts with topology "
                    f"({shards} PS shard(s)); omit num_ps or make them match")
            self.num_ps = shards
        self.sync_spec()   # validates mode/backup/bound/algo early

    def sync_spec(self) -> SyncSpec:
        return SyncSpec(mode=self.sync_mode,
                        backup_workers=self.backup_workers,
                        staleness_bound=self.staleness_bound,
                        allreduce_algo=self.allreduce_algo)

    def prepare(self) -> "PredictionRun":
        plat = PLATFORMS[self.platform]
        dnn = PAPER_DNNS[self.dnn]
        self.overhead = calibrate_overhead(plat, seed=self.seed)
        self.profile = profile_single_worker(
            dnn, self.batch_size, plat, num_ps=self.num_ps,
            steps=self.profile_steps, seed=self.seed,
            flow_control=self.flow_control, order=self.order)
        self.sim_steps_templates = preprocess_profile(self.profile, self.overhead)
        if self.calibration is not None:
            self.sim_steps_templates = self.calibration.apply_to_templates(
                self.sim_steps_templates, fallback_overhead=self.overhead)
        return self

    def with_calibration(self, profile) -> "PredictionRun":
        """Clone this (possibly prepared) run under a fitted
        ``CalibrationProfile`` (or back to the
        open loop with ``None``).

        ``replace()`` carries the prepared fields over, so the clone's
        templates are **rebuilt** from the stored 1-worker profile and
        the new calibration — a stale copy of the old calibrated
        templates would silently ignore the profile.  Re-preprocessing
        with the same overhead model is deterministic, so the
        ``profile=None`` round trip is bit-identical to never having
        calibrated."""
        out = replace(self, calibration=profile)
        if self.profile and self.overhead is not None:
            out.sim_steps_templates = preprocess_profile(out.profile,
                                                         out.overhead)
            if profile is not None:
                out.sim_steps_templates = profile.apply_to_templates(
                    out.sim_steps_templates, fallback_overhead=out.overhead)
        return out

    def with_topology(self, topology: Optional[Topology]) -> "PredictionRun":
        """Clone this (possibly prepared) run under a different topology.

        The 1-worker profile depends only on (dnn, batch, platform,
        num_ps) — the paper's own premise: profile once, simulate every
        configuration — so topology variants share the profile (replace()
        carries the prepared fields over) instead of re-profiling.  Shard
        counts must therefore match: a profile's op DAG is bound to its
        per-shard resource names."""
        if topology is not None and topology.num_shards != self.num_ps:
            raise ValueError(
                f"topology has {topology.num_shards} PS shard(s) but this "
                f"run is set up for num_ps={self.num_ps}; build the base "
                f"run with the matching num_ps (the profile's streams are "
                f"bound to per-shard links)")
        return replace(self, topology=topology)

    def _sim_cfg(self) -> SimConfig:
        plat = PLATFORMS[self.platform]
        if self.flow_control:
            policy = "http2"
        else:
            policy = "fifo" if self.order == "profiled" else "ordered"
        bw_model = self.bandwidth_model
        if bw_model is None:
            if self.topology is not None:
                # exact paper rules for a plain star, water-filling over
                # the compiled capacity groups otherwise
                bw_model = self.topology.bandwidth_model()
            else:
                bw_model = (EqualShareModel() if self.num_ps == 1
                            else BandwidthModel())
        # burst-stall parameters: the fitted parse rate (Fig. 10 alpha)
        # and the platform RTT, both part of the paper's one-time
        # per-cluster calibration
        alpha = self.overhead.alpha if self.overhead else 0.0
        resources = (self.topology.resources(plat.bandwidth)
                     if self.topology is not None
                     else ps_resources(plat.bandwidth, self.num_ps))
        cal_digest = None
        if self.calibration is not None:
            # fitted parse rate drives the HTTP/2 burst-stall term, and
            # fitted per-link capacities replace the platform nominal in
            # the per-link specs (the equal-share paper path; compiled
            # topology capacity groups keep their fabric-derived rates)
            cal_oh = self.calibration.overhead_model()
            if cal_oh is not None:
                alpha = cal_oh.alpha
            resources = {
                name: (replace(spec,
                               bandwidth=self.calibration.capacity_for(name))
                       if spec.kind == LINK
                       and self.calibration.capacity_for(name)
                       else spec)
                for name, spec in resources.items()}
            cal_digest = self.calibration.digest
        return SimConfig(
            resources=resources,
            topology=self.topology,
            link_policy=policy,
            win=self.win_estimate or plat.win_mu,
            bandwidth_model=bw_model,
            steps_per_worker=self.sim_steps,
            warmup_steps=self.warmup_steps,
            seed=self.seed + 7919,
            stall_alpha=alpha if policy == "http2" else 0.0,
            stall_rtt=plat.rtt if policy == "http2" else 0.0,
            service_jitter=plat.noise_bandwidth,
            sync_mode=self.sync_mode,
            backup_workers=self.backup_workers,
            staleness_bound=self.staleness_bound,
            allreduce_algo=self.allreduce_algo,
            waterfill=self.waterfill,
            faults=self.faults,
            calibration_digest=cal_digest,
        )

    def templates_for(self, num_workers: int) -> list:
        """Simulation-ready step templates for a W-worker run: the
        profiled templates for the PS regimes, or their per-W all-reduce
        rewrite (collective volume is 2(n-1)/n of the bytes, so the DAG
        depends on the worker count).  Cached per W."""
        if not self.sim_steps_templates:
            self.prepare()
        if self.sync_spec().mode != "allreduce":
            return self.sim_steps_templates
        cache = getattr(self, "_allreduce_tpl_cache", None)
        if cache is None:
            cache = {}
            self._allreduce_tpl_cache = cache
        if num_workers not in cache:
            plat = PLATFORMS[self.platform]
            bw = plat.bandwidth
            if self.topology is not None and self.topology.bandwidth:
                bw = self.topology.bandwidth
            cache[num_workers] = allreduce_templates(
                self.sim_steps_templates, num_workers, bandwidth=bw,
                algo=self.allreduce_algo, rtt=plat.rtt,
                topology=self.topology)
        return cache[num_workers]

    def prediction_tasks(self, num_workers: int, n_runs: int = 3) -> list:
        """The fully-seeded simulation tasks behind :meth:`predict`.

        Each task is self-contained (its own ``SimConfig`` with its own
        seed), so running them serially in-process or fanned across a
        process pool (``repro_torch.core.sweep``) gives bit-identical results.
        """
        templates = self.templates_for(num_workers)
        tasks = []
        for i in range(n_runs):
            cfg = self._sim_cfg()
            cfg.seed = cfg.seed + 101 * i
            tasks.append((cfg, templates, num_workers,
                          self.batch_size, self.warmup_steps))
        return tasks

    def staleness_report(self, num_workers: int) -> Dict[str, float]:
        """Staleness distribution (mean/p50/p99/max version lag) of one
        representative seeded simulation at W workers, plus the number of
        global versions committed."""
        cfg, templates, W, _b, _w = self.prediction_tasks(num_workers, 1)[0]
        trace = Simulation(cfg).run(templates, W)
        stats = trace.staleness_stats()
        stats["versions"] = trace.meta["num_versions"]
        return stats

    def robustness_report(self, num_workers: int) -> Dict[str, float]:
        """Goodput / recovery / wasted-work summary of one seeded
        simulation under this run's fault schedule (requires ``faults``)."""
        if self.faults is None:
            raise ValueError("robustness_report needs a FaultSpec "
                             "(set PredictionRun.faults)")
        cfg, templates, W, batch, warm = self.prediction_tasks(num_workers,
                                                               1)[0]
        trace = Simulation(cfg).run(templates, W)
        recov = trace.recovery_times()
        return {
            "throughput": trace.throughput(batch, warmup_steps=warm),
            "goodput": trace.goodput(batch, warmup_steps=warm),
            "incidents": float(len(trace.incidents)),
            "mean_recovery_s": (sum(recov) / len(recov)) if recov else 0.0,
            "wasted_work_frac": trace.wasted_work_fraction(),
            "lost_steps": float(trace.meta.get("lost_steps", 0)),
        }

    def predict(self, num_workers: int, n_runs: int = 3,
                parallel: bool = False) -> float:
        """Our method's predicted examples/s for W workers.

        Averages ``n_runs`` independent simulation runs (paper §3.4:
        "multiple runs can be performed in parallel on separate cores") —
        small-W configurations are metastable (partial interleaving,
        Fig. 16), so a single run has high variance.  ``parallel=True``
        fans the runs across cores (same seeds, same mean); sweeping many
        worker counts is better served by ``sweep.predict_many``.
        """
        import time as _time

        from repro_torch.core.sweep import parallel_map, simulate_task
        from repro_torch.obs import ledger
        tasks = self.prediction_tasks(num_workers, n_runs)
        t0 = _time.perf_counter()
        outs = parallel_map(simulate_task, tasks, parallel=parallel)
        predicted = sum(outs) / len(outs)
        if ledger.resolve_path() is not None:
            config = {"dnn": self.dnn, "batch_size": self.batch_size,
                      "platform": self.platform, "num_ps": self.num_ps,
                      "num_workers": num_workers, "n_runs": n_runs,
                      "seed": self.seed}
            # key present only when calibrated: open-loop records (and
            # their config digests) are unchanged by this feature
            if self.calibration is not None:
                config["calibration"] = self.calibration.digest
            ledger.log(
                "predict", config=config,
                engine="scalar", predicted=predicted,
                wall_s=_time.perf_counter() - t0)
        return predicted

    def measure_mean(self, num_workers: int, steps: int = 150,
                     n_runs: int = 3, parallel: bool = False) -> float:
        """Ensemble-mean ground truth (the emulator, like the real cluster,
        is itself seed-noisy at small W)."""
        from repro_torch.core.sweep import measure_many
        return measure_many(self, [num_workers], steps=steps, n_runs=n_runs,
                            parallel=parallel)[num_workers]

    def predict_baseline(self, num_workers: int, method: str) -> float:
        if not self.profile:
            self.prepare()
        phases = bl.extract_phases(self.profile)
        if method == "lin":
            return bl.lin_throughput(phases, num_workers, self.batch_size)
        if method == "cynthia":
            return bl.cynthia_throughput(phases, num_workers, self.batch_size)
        if method == "cynthia2":
            return bl.cynthia_throughput(phases, num_workers, self.batch_size,
                                         halve_tc=True)
        raise ValueError(f"unknown baseline {method!r}")

    def measure(self, num_workers: int, steps: int = 100,
                seed_offset: int = 1000) -> float:
        """Ground truth from the cluster emulator (independent seed)."""
        plat = PLATFORMS[self.platform]
        dnn = PAPER_DNNS[self.dnn]
        return measure_throughput(
            dnn, self.batch_size, plat, num_workers, num_ps=self.num_ps,
            steps=steps, seed=self.seed + seed_offset,
            flow_control=self.flow_control, order=self.order,
            warmup_steps=self.warmup_steps, topology=self.topology,
            sync=self.sync_spec(), faults=self.faults)


def prediction_error(predicted: float, measured: float) -> float:
    if measured == 0:
        return float("inf")
    return abs(predicted - measured) / measured


def sweep(run: PredictionRun, workers: Sequence[int],
          measure_steps: int = 100,
          parallel: bool = True) -> Dict[str, List[float]]:
    """Predicted vs measured curves (one paper sub-figure).

    All (worker-count, seed) simulation and measurement tasks are fanned
    across cores by ``repro_torch.core.sweep`` (deterministic per-task seeding:
    identical output to the historical serial loop).
    """
    from repro_torch.core.sweep import sweep_parallel
    run.prepare()
    return sweep_parallel(run, workers, measure_steps=measure_steps,
                          parallel=parallel)
