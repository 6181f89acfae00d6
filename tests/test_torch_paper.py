"""The port's PS-cluster pipeline against the reference's: the paper's own
workflow (§4.1) — profile one worker against the PS shards in the cluster
emulator, preprocess the profile, predict W workers with the DES, measure
the emulated cluster, and compare with the Lin and Cynthia baselines.

``repro_torch`` copies ``paper_models``, ``overhead``, ``baselines``,
``profiling.tracer``, ``emulator.cluster``, ``predictor`` and ``sweep``
expression for expression. Every stage draws from its own
``random.Random`` in a fixed order, so the same arguments give the same
floats, and every comparison here is ``==``: profiles, templates,
predictions, measurements, baselines, staleness and robustness reports,
Chrome traces, ledger records and the ``whatif --ps-cluster`` CLI's
stdout, line for line. Step counts are the reference tests' smallest
(profile 10–40, sim 60–250).
"""
import dataclasses
import hashlib
import json
import os
import pathlib

import pytest

from repro.core import paper_models as ref_pm
from repro.core import predictor as ref_pred
from repro.core import sweep as ref_sweep
from repro.core.faults import FaultSpec as RefFaultSpec
from repro.emulator import cluster as ref_cluster
from repro.launch import whatif as ref_whatif
from repro.obs import ledger as ref_ledger
from repro.profiling import tracer as ref_tracer
from repro_torch.core import paper_models as port_pm
from repro_torch.core import predictor as port_pred
from repro_torch.core import sweep as port_sweep
from repro_torch.core.faults import FaultSpec as PortFaultSpec
from repro_torch.emulator import cluster as port_cluster
from repro_torch.launch import whatif as port_whatif
from repro_torch.obs import ledger as port_ledger
from repro_torch.obs.view import validate_chrome_trace
from repro_torch.profiling import tracer as port_tracer

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = (ref_pm, ref_pred, ref_cluster, ref_tracer, ref_whatif, RefFaultSpec)
PORT = (port_pm, port_pred, port_cluster, port_tracer, port_whatif,
        PortFaultSpec)

# ``tests/test_paper_system.py``'s noise-free platform, added to both
# packages' (mutable, module-global) tables alike
for _pm in (ref_pm, port_pm):
    _pm.PLATFORMS.setdefault("clean_test", dataclasses.replace(
        _pm.PRIVATE_CPU, name="clean_test", noise_compute=0.0,
        noise_bandwidth=0.0, win_sigma=0.0, bg_rate=0.0))


def plain(x):
    """Dataclasses (and lists of them) as plain dicts, to compare objects
    of the two packages field by field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def make_run(pkg, **kw):
    kw.setdefault("profile_steps", 10)
    kw.setdefault("sim_steps", 60)
    kw.setdefault("platform", "private_cpu")
    return pkg[1].PredictionRun(**kw).prepare()


_RUNS = {}


def runs(name, **kw):
    """The prepared (reference, port) runs of one configuration, built
    once a module."""
    if name not in _RUNS:
        _RUNS[name] = (make_run(REF, **kw), make_run(PORT, **kw))
    return _RUNS[name]


CASES = {
    "alexnet b8": dict(dnn="alexnet", batch_size=8),
    "vgg11 2ps": dict(dnn="vgg11", batch_size=8, num_ps=2),
    "flow off reverse": dict(dnn="alexnet", batch_size=8,
                             flow_control=False, order="reverse"),
}


# ------------------------------------------------------- the paper's tables


@pytest.mark.parametrize("dnn", sorted(ref_pm.PAPER_DNNS))
def test_dnn_tables_and_ps_splits_are_the_references(dnn):
    ref, port = ref_pm.PAPER_DNNS[dnn], port_pm.PAPER_DNNS[dnn]
    assert plain(port) == plain(ref)
    assert (port.total_params, port.total_param_bytes, port.total_fwd_macs) \
        == (ref.total_params, ref.total_param_bytes, ref.total_fwd_macs)
    for m in (1, 2, 3):
        assert port_tracer.ps_split_bytes(port, m) \
            == ref_tracer.ps_split_bytes(ref, m)
        assert port_tracer.assign_layers_greedy(port, m) \
            == ref_tracer.assign_layers_greedy(ref, m)
    for name in ("private_cpu", "aws_gpu"):
        assert port_pm.layer_compute_times(port, 16, port_pm.PLATFORMS[name]) \
            == ref_pm.layer_compute_times(ref, 16, ref_pm.PLATFORMS[name])


def test_platform_tables_are_the_references():
    assert list(port_pm.PLATFORMS) == list(ref_pm.PLATFORMS)
    for name, plat in ref_pm.PLATFORMS.items():
        assert plain(port_pm.PLATFORMS[name]) == plain(plat), name
    vgg = port_pm.PAPER_DNNS["vgg11"]
    a, b = port_tracer.ps_split_bytes(vgg, 2)
    assert max(a, b) / min(a, b) > 3.0     # Fig. 23's uneven split


# ---------------------------------------------- profile -> templates -> DES


@pytest.mark.parametrize("case", sorted(CASES))
def test_profile_overhead_and_templates_are_the_references(case):
    ref, port = runs(case, **CASES[case])
    assert plain(port.overhead) == plain(ref.overhead)
    assert plain(port.profile) == plain(ref.profile) and port.profile
    assert plain(port.sim_steps_templates) == plain(ref.sim_steps_templates)
    again = port_pred.preprocess_profile(port.profile, port.overhead)
    assert plain(again) == plain(ref_pred.preprocess_profile(ref.profile,
                                                             ref.overhead))


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_measure_and_baselines_are_the_references(case):
    ref, port = runs(case, **CASES[case])
    for w in (1, 2, 4):
        assert port.predict(w) == ref.predict(w)
        assert port.measure(w, steps=40) == ref.measure(w, steps=40)
        for method in ("lin", "cynthia", "cynthia2"):
            assert port.predict_baseline(w, method) \
                == ref.predict_baseline(w, method)
    assert port.measure_mean(2, steps=40) == ref.measure_mean(2, steps=40)
    with pytest.raises(ValueError, match="unknown baseline"):
        port.predict_baseline(1, "amdahl")


SYNC = {
    "sync backup 1": dict(sync_mode="sync", backup_workers=1),
    "ssp bound 1": dict(sync_mode="ssp", staleness_bound=1),
    "allreduce ring": dict(sync_mode="allreduce"),
}


@pytest.mark.parametrize("mode", sorted(SYNC))
def test_sync_modes_and_staleness_are_the_references(mode):
    ref, port = runs(mode, dnn="alexnet", batch_size=8, **SYNC[mode])
    for w in (2, 4):
        assert port.predict(w) == ref.predict(w)
        assert port.staleness_report(w) == ref.staleness_report(w)
        assert port.measure(w, steps=40) == ref.measure(w, steps=40)
    if mode == "allreduce ring":
        assert plain(port.templates_for(4)) == plain(ref.templates_for(4))


def test_rack_topology_with_a_straggler_is_the_references():
    ref, port = runs("vgg11 2ps", **CASES["vgg11 2ps"])
    topo = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        t = pkg[4].build_whatif_topology(4, 2, oversub=4.0, racks=3,
                                         ps_nic=2.0)
        topo[name] = t.with_node_speed("w0", 1.0 / 1.5)
    assert plain(topo["port"]) == plain(topo["ref"])
    ref_t, port_t = ref.with_topology(topo["ref"]), \
        port.with_topology(topo["port"])
    assert port_t.predict(4) == ref_t.predict(4)
    assert port_t.measure(4, steps=40) == ref_t.measure(4, steps=40)
    with pytest.raises(ValueError, match="PS shard"):
        port.with_topology(port_whatif.build_whatif_topology(4, 1))


def test_fault_churn_and_robustness_are_the_references():
    ref, port = runs("alexnet b8", **CASES["alexnet b8"])
    kw = dict(mttf=20.0, mttr=3.0, preempt_rate=0.01, preempt_downtime=3.0,
              degrade_links=("uplink",), fault_seed=2)
    ref_f = dataclasses.replace(ref, faults=RefFaultSpec(**kw))
    port_f = dataclasses.replace(port, faults=PortFaultSpec(**kw))
    for w in (2, 4):
        rep = port_f.robustness_report(w)
        assert rep == ref_f.robustness_report(w) and rep["incidents"] > 0
        assert port_f.measure(w, steps=40) == ref_f.measure(w, steps=40)
    with pytest.raises(ValueError, match="FaultSpec"):
        port.robustness_report(2)


def test_batch_waterfill_against_auto_is_the_references():
    """Each mode equals the reference's bit for bit; the two modes agree
    to the reference's own bound (``tests/test_placement_search.py``:
    float noise, rel 1e-9)."""
    ref, port = runs("vgg11 2ps", **CASES["vgg11 2ps"])
    out = {}
    for name, run, build in (("ref", ref, ref_whatif.build_whatif_topology),
                             ("port", port,
                              port_whatif.build_whatif_topology)):
        base = run.with_topology(build(4, 2, oversub=4.0))
        out[name] = tuple(dataclasses.replace(base, waterfill=m).predict(4)
                          for m in ("auto", "batch"))
    assert out["port"] == out["ref"]
    auto, batch = out["port"]
    assert batch == pytest.approx(auto, rel=1e-9)


def test_noise_free_platform_is_near_exact_as_in_the_reference():
    """``tests/test_paper_system.py``'s noise-free case on the platform
    both tables gained above."""
    ref, port = runs("clean", dnn="alexnet", batch_size=8,
                     platform="clean_test")
    p, m = port.predict(1), port.measure(1, steps=40)
    assert (p, m) == (ref.predict(1), ref.measure(1, steps=40))
    assert port_pred.prediction_error(p, m) < 0.03
    assert port_pred.prediction_error(1.0, 0.0) == float("inf")


def test_saturated_case_beats_the_baselines_as_in_the_reference():
    """``TestBaselinesWorse``: alexnet, batch 16, W = 6 (profile 40,
    sim 250, measured over 120 steps); the same numbers as the
    reference's, within its gates."""
    errs = []
    for pkg in (REF, PORT):
        r = make_run(pkg, dnn="alexnet", batch_size=16, profile_steps=40,
                     sim_steps=250)
        meas = r.measure(6, steps=120)
        err = pkg[1].prediction_error
        errs.append((err(r.predict(6), meas),
                     err(r.predict_baseline(6, "lin"), meas),
                     err(r.predict_baseline(6, "cynthia"), meas)))
    assert errs[1] == errs[0]
    ours, lin, cyn = errs[1]
    assert ours < max(lin, cyn) and ours < 0.12


# ------------------------------------------------------------- the emulator


def test_emulator_chrome_trace_and_observed_run_are_the_references():
    docs, observed = [], []
    for pkg in (REF, PORT):
        pm, cluster, spec = pkg[0], pkg[2], pkg[5]
        emu = cluster.ClusterEmulator(
            pm.ALEXNET, 8, pm.PLATFORMS["private_cpu"], num_workers=2,
            num_ps=2, seed=4, record_profile=True,
            faults=spec(crashes=((5.0, 1),), mttr=2.0))
        emu.run(steps_per_worker=12)
        docs.append(emu.to_chrome_trace())
        observed.append(cluster.observe_run(
            pm.VGG11, 8, pm.PLATFORMS["aws_cpu"], 2, steps=12, seed=1))
    assert docs[1] == docs[0] and validate_chrome_trace(docs[1]) == []
    assert any(e["name"] == "crash:1" for e in docs[1]["traceEvents"])
    assert observed[1][0] == observed[0][0]
    assert plain(observed[1][1]) == plain(observed[0][1])
    assert port_cluster.probe_parse_overheads(
        port_pm.AWS_GPU, port_pred.PROBE_SIZES, seed=3) \
        == ref_cluster.probe_parse_overheads(ref_pm.AWS_GPU,
                                             ref_pred.PROBE_SIZES, seed=3)


# ------------------------------------------------------- the sweep engine


def test_predict_many_serial_equals_parallel_and_the_reference(monkeypatch):
    ref, port = runs("alexnet b8", **CASES["alexnet b8"])
    workers = [1, 2, 4]
    parallel = port_sweep.predict_many(port, workers, max_workers=2)
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    assert port_sweep.predict_many(port, workers) == parallel \
        == ref_sweep.predict_many(ref, workers)
    assert parallel == {w: port.predict(w) for w in workers}
    assert port_sweep.measure_many(port, workers, steps=40) \
        == ref_sweep.measure_many(ref, workers, steps=40)
    with port_sweep.pool(max_workers=2) as p:
        tasks = port.prediction_tasks(2, 2)
        assert port_sweep.simulate_all(tasks) == p.map(tasks) \
            == ref_sweep.simulate_all(ref.prediction_tasks(2, 2))


def test_sweeps_log_the_references_records(tmp_path, monkeypatch):
    """``sweep_parallel`` (via ``predictor.sweep``) and ``predict`` append
    the reference's ledger records when the ledger is on, and none when it
    is off."""
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    outs, recs = [], []
    for name, pkg, led in (("ref", REF, ref_ledger),
                           ("port", PORT, port_ledger)):
        path = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("REPRO_LEDGER", str(path))
        r = make_run(pkg, dnn="alexnet", batch_size=8)
        outs.append(pkg[1].sweep(r, [1, 2], measure_steps=40))
        r.predict(2)
        recs.append([{k: v for k, v in rec.items()
                      if k not in ("ts", "wall_s")}
                     for rec in led.read(str(path))])
    assert outs[1] == outs[0]
    assert recs[1] == recs[0]
    assert [rec["kind"] for rec in recs[1]] == ["sweep", "predict"]
    monkeypatch.setenv("REPRO_LEDGER", "0")
    make_run(PORT, dnn="alexnet", batch_size=8).predict(1)
    assert len(port_ledger.read(str(tmp_path / "port.jsonl"))) == 2


# --------------------------------------------------- whatif --ps-cluster


CLI = {
    "sync churn trace": ["--num-ps", "2", "--oversub", "4", "--sync-mode",
                         "sync", "--backup-workers", "1", "--mttf", "60",
                         "--mttr", "5", "--fault-seed", "1",
                         "--export-trace", "{tmp}/trace.json"],
    "allreduce degrade": ["--sync-mode", "allreduce", "--allreduce-algo",
                          "tree", "--degrade-links", "uplink",
                          "--degrade-factor", "0.25", "--waterfill",
                          "batch"],
    "topology ssp preempt": ["--num-ps", "2", "--oversub", "2", "--racks",
                             "3", "--ps-nic", "2.0", "--colocate-ps",
                             "--straggler-worker", "1.5", "--sync-mode",
                             "ssp", "--staleness-bound", "2",
                             "--preempt-rate", "0.02", "--mttr", "4"],
}


def _run_cli(main, argv, monkeypatch, capsys, led):
    monkeypatch.setattr("sys.argv", ["whatif"] + argv)
    try:
        if main is ref_whatif.main:
            main()
        else:
            main(argv)
    finally:
        led.disable()
    return capsys.readouterr().out


@pytest.mark.parametrize("case", sorted(CLI))
def test_ps_cluster_cli_prints_the_references_lines(case, tmp_path,
                                                   monkeypatch, capsys):
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    outs, recs, traces = [], [], []
    for name, main, led in (("ref", ref_whatif.main, ref_ledger),
                            ("port", port_whatif.main, port_ledger)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setenv("REPRO_LEDGER", str(d / "ledger.jsonl"))
        argv = ["--ps-cluster", "--workers", "2", "4", "--profile-steps",
                "10", "--sim-steps", "60"] + [a.format(tmp=d)
                                              for a in CLI[case]]
        out = _run_cli(main, argv, monkeypatch, capsys, led)
        outs.append(out.replace(str(d), "<tmp>").splitlines())
        recs.append([{k: v for k, v in r.items() if k != "ts"}
                     for r in led.read(str(d / "ledger.jsonl"))])
        if (d / "trace.json").exists():
            traces.append((d / "trace.json").read_bytes())
    assert outs[1] == outs[0] and len(outs[1]) >= 4
    assert recs[1] == recs[0] and recs[1][0]["figure"] == "whatif_ps"
    assert len(traces) in (0, 2) and traces[1:] == traces[:1]
    if traces:
        assert validate_chrome_trace(json.loads(traces[1])) == []


def _sha(path: pathlib.Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else "absent"


def test_ps_cluster_from_the_repo_root_leaves_the_benchmark_ledger_alone(
        monkeypatch, capsys):
    """Run from the repo root with no ``REPRO_LEDGER``, the what-if logs
    to ``build/ledger.jsonl`` (git-ignored), never to the reference's
    tracked ``benchmarks/results/ledger.jsonl``."""
    tracked = ROOT / "benchmarks" / "results" / "ledger.jsonl"
    before = (_sha(tracked), tracked.stat().st_mtime_ns
              if tracked.exists() else None)
    monkeypatch.chdir(ROOT)
    monkeypatch.delenv("REPRO_LEDGER", raising=False)
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    argv = ["--ps-cluster", "--workers", "1", "2", "--profile-steps", "10",
            "--sim-steps", "60", "--dnn", "googlenet"]
    _run_cli(port_whatif.main, argv, monkeypatch, capsys, port_ledger)
    assert (_sha(tracked), tracked.stat().st_mtime_ns
            if tracked.exists() else None) == before
    last = port_ledger.read(str(ROOT / port_whatif.LEDGER_PATH))[-1]
    assert last["figure"] == "whatif_ps" and last["config_digest"] \
        == port_ledger.config_digest(
            {"dnn": "googlenet", "batch": 8, "platform": "private_cpu",
             "num_ps": 1, "oversub": 1.0, "ps_nic": 1.0, "sync": "async",
             "workers": [1, 2]})
    assert port_ledger.resolve_path() is None
    assert os.path.relpath(port_whatif.LEDGER_PATH) \
        == os.path.join("build", "ledger.jsonl")


def test_gpu_mode_writes_no_ledger_record(tmp_path, monkeypatch, capsys):
    path = tmp_path / "ledger.jsonl"
    monkeypatch.setenv("REPRO_LEDGER", str(path))
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    _run_cli(port_whatif.main, ["--nodes", "1", "2"], monkeypatch, capsys,
             port_ledger)
    assert not path.exists()


FLEET_CLI = {
    "fleet": [],
    "scale export": ["--scale-job", "A:3", "--export-trace",
                     "{tmp}/fleet.json"],
}


@pytest.mark.parametrize("case", sorted(FLEET_CLI))
def test_fleet_cli_prints_the_references_lines(case, tmp_path, monkeypatch,
                                               capsys):
    """``whatif --fleet examples/fleet.json`` prints the reference's lines,
    exports the reference's trace bytes and writes no ledger record."""
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    outs, traces = [], []
    for name, main, led in (("ref", ref_whatif.main, ref_ledger),
                            ("port", port_whatif.main, port_ledger)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setenv("REPRO_LEDGER", str(d / "ledger.jsonl"))
        argv = ["--fleet", str(ROOT / "examples" / "fleet.json")] \
            + [a.format(tmp=d) for a in FLEET_CLI[case]]
        out = _run_cli(main, argv, monkeypatch, capsys, led)
        outs.append(out.replace(str(d), "<tmp>").splitlines())
        assert not (d / "ledger.jsonl").exists()
        if (d / "fleet.json").exists():
            traces.append((d / "fleet.json").read_bytes())
    assert outs[1] == outs[0]
    assert outs[1][1].split() == ["job", "W", "ex/s", "alone", "slowdown",
                                  "share"]
    assert len(outs[1]) == (5 if case == "fleet" else 11)
    assert len(traces) == (0 if case == "fleet" else 2)
    assert traces[1:] == traces[:1]
    if traces:
        assert validate_chrome_trace(json.loads(traces[1])) == []


@pytest.mark.parametrize("argv,item", [
    (["--ps-cluster", "--calibrate", "traces"], "1.18b"),
    (["--ps-cluster", "--optimize-placement"], "1.18b"),
    (["--ps-cluster", "--optimize-placement", "anneal"], "1.18b")])
def test_unported_whatif_modes_raise_naming_their_item(argv, item, tmp_path,
                                                      monkeypatch, capsys):
    """Named for what it held until ROADMAP 1.18b was ported: these three
    modes raised. Now each prints the reference's lines, its own first
    (``# calibration:``) or last (``# placement search``)."""
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    corpus = tmp_path / "traces"
    _m, steps = port_cluster.observe_run(
        port_pm.PAPER_DNNS["alexnet"], 8, port_pm.PLATFORMS["private_cpu"],
        2, steps=12, warmup_steps=2)
    from repro_torch.calibrate.extract import save_traces
    save_traces(str(corpus / "run0.json"), steps)
    argv = [str(corpus) if a == "traces" else a for a in argv] + [
        "--workers", "2", "--profile-steps", "10", "--sim-steps", "30"]
    outs = []
    for name, main, led in (("ref", ref_whatif.main, ref_ledger),
                            ("port", port_whatif.main, port_ledger)):
        monkeypatch.setenv("REPRO_LEDGER", str(tmp_path / f"{name}.jsonl"))
        outs.append(_run_cli(main, argv, monkeypatch, capsys, led)
                    .splitlines())
    assert outs[1] == outs[0]
    if "--calibrate" in argv:
        assert outs[1][0].startswith(f"# calibration: {corpus} -> profile ")
    else:
        assert outs[1][-3].startswith("# placement search (")
    recs = [[{k: v for k, v in r.items() if k != "ts"}
             for r in led.read(str(tmp_path / f"{name}.jsonl"))]
            for name, led in (("ref", ref_ledger), ("port", port_ledger))]
    assert recs[1] == recs[0] and recs[1][-1]["figure"] == "whatif_ps"
    assert item == "1.18b"


@pytest.mark.parametrize("argv", [
    ["--scale-job", "A:2"], ["--straggler-worker", "1.5"],
    ["--sync-mode", "sync"], ["--mttf", "5"], ["--export-trace", "x.json"],
    ["--ps-cluster", "--backup-workers", "1"],
    ["--ps-cluster", "--staleness-bound", "1", "--sync-mode", "sync"],
    ["--ps-cluster", "--straggler-worker", "0.5"],
    ["--calibrate", "traces"], ["--optimize-placement"],
    ["--ps-cluster", "--optimize-placement", "--sync-mode", "allreduce"],
    ["--ps-cluster", "--optimize-placement", "ilp"]])
def test_the_references_flag_checks_refuse(argv, capsys):
    with pytest.raises(SystemExit) as e:
        port_whatif.main(argv)
    assert e.value.code == 2


def _small_fleet(pkg):
    """``examples/fleet.json`` cut to 6 steps a worker."""
    cfg, steps = pkg[4].load_fleet(str(ROOT / "examples" / "fleet.json"))
    jobs = tuple(dataclasses.replace(j, steps_per_worker=6, warmup_steps=1)
                 for j in cfg.jobs)
    return dataclasses.replace(cfg, jobs=jobs), steps


def test_unported_engines_raise_naming_their_item():
    """Named for what it held until ROADMAP 1.18a was ported: these five
    calls raised. Now each returns the reference's result; the batched
    ones return its scalar engine's, which the reference's own batched
    engine misses in the last bits here (``tests/test_torch_batched.py``,
    ROADMAP §3)."""
    ref, port = runs("alexnet b8", **CASES["alexnet b8"])
    tasks, rtasks = port.prediction_tasks(1, 3), ref.prediction_tasks(1, 3)
    assert port_sweep.simulate_all(tasks, batch=True) \
        == port_sweep.simulate_batched(tasks) \
        == ref_sweep.simulate_all(rtasks)
    assert port_sweep.predict_many(port, [1], batch=True) \
        == ref_sweep.predict_many(ref, [1])
    assert ref_sweep.predict_many(ref, [1], batch=True) \
        != ref_sweep.predict_many(ref, [1])
    (rcfg, rsteps), (pcfg, psteps) = _small_fleet(REF), _small_fleet(PORT)
    rft = ref_sweep.simulate_fleet_task((rcfg, rsteps, True))
    pft = port_sweep.simulate_fleet_task((pcfg, psteps, True))
    assert pft.throughputs(pcfg) == rft.throughputs(rcfg)
    assert [t.step_completions for t in pft.jobs.values()] \
        == [t.step_completions for t in rft.jobs.values()]
    tputs = []
    for pkg, cfg in ((REF, rcfg), (PORT, pcfg)):
        wl = dict(dnn=pkg[0].PAPER_DNNS["alexnet"], batch_size=8,
                  platform=pkg[0].PLATFORMS["private_cpu"])
        emu = pkg[2].FleetEmulator(cfg, {"A": dict(wl), "B": dict(wl)})
        emu.run(steps_per_worker=6)
        tputs.append(emu.throughputs(warmup_steps=1))
    assert tputs[1] == tputs[0] and all(v > 0 for v in tputs[1].values())


def test_core_exports_the_references_names_but_placement_search():
    """Named for what it held until ROADMAP 1.18b was ported: the port's
    core lacked the placement-search names. Now it exports all of the
    reference's."""
    import repro.core
    import repro_torch.core
    placement = {"PlacementEvaluator", "SearchResult", "evaluator_from_run",
                 "evaluator_from_templates", "search_placement"}
    assert set(repro.core.__all__) - set(repro_torch.core.__all__) == set()
    assert placement <= set(repro_torch.core.__all__)
    for name in repro_torch.core.__all__:
        assert hasattr(repro_torch.core, name)
