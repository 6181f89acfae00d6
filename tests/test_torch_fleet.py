"""The port's multi-tenant fleet engine (``repro_torch.core.fleet``), the
emulator's ``FleetEmulator`` and whatif's fleet helpers against the
reference's.

Each gate of ``tests/test_fleet.py`` runs in both packages on the same
seeds and templates: the gate holds in the port, and the port's numbers
(``FleetTrace.throughputs``, ``interference_report``, the contention
timelines, the emulator's throughputs, the Chrome trace) equal the
reference's with ``==``. The CLI's ``--fleet`` lines are held in
``tests/test_torch_paper.py`` beside the other what-if modes.
"""
import dataclasses
import json
import pathlib
import random

import pytest

from repro.core import events as ref_events
from repro.core import fleet as ref_fleet
from repro.core import simulator as ref_sim
from repro.core import sweep as ref_sweep
from repro.core import topology as ref_topo
from repro.core.faults import FaultSpec as RefFaultSpec
from repro.launch import whatif as ref_whatif
from repro.obs import trace_export as ref_export
from repro_torch.core import events as port_events
from repro_torch.core import fleet as port_fleet
from repro_torch.core import simulator as port_sim
from repro_torch.core import sweep as port_sweep
from repro_torch.core import topology as port_topo
from repro_torch.core.faults import FaultSpec as PortFaultSpec
from repro_torch.launch import whatif as port_whatif
from repro_torch.obs import trace_export as port_export
from repro_torch.obs.view import validate_chrome_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = (ref_events, ref_fleet, ref_sim, ref_sweep, ref_topo, RefFaultSpec,
       ref_whatif, ref_export)
PORT = (port_events, port_fleet, port_sim, port_sweep, port_topo,
        PortFaultSpec, port_whatif, port_export)
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
STEPS = 40
WARMUP = 8


def _template(pkg, layers=4, seed=0, size_scale=1.0):
    """``tests/test_fleet.py``'s PS-shaped synthetic step."""
    ev = pkg[0]
    rng = random.Random(seed)
    ops = []
    fwd_prev = None
    for i in range(layers):
        dl = len(ops)
        ops.append(ev.Op(f"dl{i}", "downlink",
                         size=size_scale * rng.uniform(2e6, 2e7)))
        deps = (dl,) if fwd_prev is None else (dl, fwd_prev)
        fwd_prev = len(ops)
        ops.append(ev.Op(f"fwd{i}", "worker",
                         duration=rng.uniform(.004, .03), deps=deps))
    bwd_prev = fwd_prev
    for i in reversed(range(layers)):
        bwd = len(ops)
        ops.append(ev.Op(f"bwd{i}", "worker",
                         duration=rng.uniform(.008, .05), deps=(bwd_prev,)))
        bwd_prev = bwd
        ops.append(ev.Op(f"ul{i}", "uplink",
                         size=size_scale * rng.uniform(2e6, 2e7),
                         deps=(bwd,)))
    return ev.StepTemplate(ops=ops)


def _topology(pkg, oversub=1.0):
    tp = pkg[4]
    return tp.Topology(
        workers=(tp.Node("h0", rack="r0", nic=2.0),)
        + tuple(tp.Node(f"w{i}", rack="r1") for i in range(6)),
        racks=(tp.Rack("r0", oversubscription=oversub), tp.Rack("r1")),
        placement=tp.Placement(("h0",)), bandwidth=1e9)


def _job(pkg, name, workers, seed=0, **kw):
    kw.setdefault("ps_hosts", ("h0",))
    kw.setdefault("steps_per_worker", STEPS)
    kw.setdefault("warmup_steps", WARMUP)
    return pkg[1].FleetJob(name=name, workers=tuple(workers), seed=seed,
                           batch_size=8, **kw)


def _pair(pkg, oversub=2.0, seed_b=1, record_contention=False, **kw_b):
    return pkg[1].FleetConfig(
        topology=_topology(pkg, oversub), record_contention=record_contention,
        jobs=(_job(pkg, "A", ("w0", "w1", "w2"), seed=0,
                   service_jitter=0.05),
              _job(pkg, "B", ("w4", "w5"), seed=seed_b, **kw_b)))


def _steps(pkg, cfg, n_tpl=2):
    return {job.name: [_template(pkg, seed=s) for s in range(n_tpl)]
            for job in cfg.jobs}


def _traces(ft):
    """A ``FleetTrace``'s per-job traces as comparable tuples."""
    return {name: (tr.step_completions, tr.staleness, tr.meta)
            for name, tr in sorted(ft.jobs.items())}


def _both(fn):
    """``fn(pkg)`` for the reference and the port; asserts they are equal
    and returns the port's."""
    ref, port = fn(REF), fn(PORT)
    assert port == ref
    return port


def test_single_job_fleet_delegates_bit_identically():
    def run(pkg):
        cfg = pkg[1].FleetConfig(topology=_topology(pkg), jobs=(
            _job(pkg, "A", ("w0", "w1", "w2"), seed=3, service_jitter=0.05),))
        tpls = [_template(pkg, seed=s) for s in range(2)]
        ft = pkg[1].FleetSimulation(cfg).run({"A": tpls}, merged=False)
        direct = pkg[2].Simulation(cfg.sim_config(0)).run(tpls, 3)
        tr = ft.jobs["A"]
        assert tr.step_completions == direct.step_completions
        assert tr.meta["sim_end_time"] == direct.meta["sim_end_time"]
        assert tr.meta["num_events"] == direct.meta["num_events"]
        return _traces(ft), ft.throughputs(cfg)
    _both(run)


def test_job_a_trace_invariant_to_job_b_seed():
    def run(pkg):
        out = []
        for seed_b in (1, 99):
            cfg = _pair(pkg, seed_b=seed_b, sample=False)
            steps = {"A": [_template(pkg, seed=0), _template(pkg, seed=1)],
                     "B": [_template(pkg, seed=7)]}
            ft = pkg[1].FleetSimulation(cfg).run(steps, merged=True)
            out.append((_traces(ft)["A"], ft.throughputs(cfg)["A"]))
        assert out[0] == out[1]
        return out[0]
    _both(run)


def test_fleet_serial_equals_parallel():
    def tasks(pkg):
        out = []
        for oversub in (1.0, 2.0, 4.0):
            cfg = _pair(pkg, oversub=oversub)
            out.append((cfg, _steps(pkg, cfg), True))
        return out
    ts = tasks(PORT)
    serial = [port_sweep.simulate_fleet_task(t) for t in ts]
    par = port_sweep.simulate_fleets(ts, parallel=True, max_workers=2)
    assert par == serial
    ref = [ref_sweep.simulate_fleet_task(t) for t in tasks(REF)]
    assert [_traces(ft) for ft in par] == [_traces(ft) for ft in ref]
    assert [ft.throughputs(t[0]) for ft, t in zip(par, ts)] \
        == [ft.throughputs(t[0]) for ft, t in zip(ref, tasks(REF))]


def test_no_speedup_under_contention():
    def run(pkg):
        cfg = _pair(pkg, oversub=2.0)
        rep = pkg[1].interference_report(cfg, _steps(pkg, cfg))
        for name, r in rep["jobs"].items():
            assert r["throughput"] <= r["alone"] * (1 + 1e-9), name
            assert r["slowdown"] >= 1.0 - 1e-9, name
        assert 0.0 < rep["jain"] <= 1.0
        return rep["jobs"], rep["jain"], _traces(rep["fleet"])
    _both(run)


def test_contention_timelines_are_the_references():
    def run(pkg):
        cfg = _pair(pkg, oversub=4.0, record_contention=True)
        ft = pkg[1].FleetSimulation(cfg).run(_steps(pkg, cfg), merged=True)
        return ft.meta["contention"], ft.throughputs(cfg)
    contention, _ = _both(run)
    assert contention and all(len(s) > 1 for s in contention.values())


def test_kofn_partial_participation_no_slower():
    def run(pkg):
        ends = {}
        for k in (0, 3):
            jobs = (_job(pkg, "A", ("w0", "w1", "w2", "w3"), ps_hosts=(),
                         sync_mode="allreduce", collective_k=k),)
            cfg = pkg[1].FleetConfig(topology=_topology(pkg), jobs=jobs)
            ft = pkg[1].FleetSimulation(cfg).run(
                {"A": [_template(pkg, seed=0)]}, merged=True)
            ends[k] = (ft.jobs["A"].meta["sim_end_time"],
                       ft.throughputs(cfg))
        assert ends[3][0] <= ends[0][0] + 1e-12
        return ends
    _both(run)


@pytest.mark.parametrize("xs", [[1.0, 1.0, 1.0], [1.0, 0.0], [],
                                [0.871, 0.484], [0.3, 0.9, 0.55, 1.2]])
def test_jain_index_is_the_references(xs):
    assert port_fleet.jain_index(xs) == ref_fleet.jain_index(xs)
    assert 0.0 < port_fleet.jain_index(xs) <= 1.0


def test_jain_index_bounds():
    assert port_fleet.jain_index([1.0, 1.0, 1.0]) == pytest.approx(1.0)
    assert port_fleet.jain_index([1.0, 0.0]) == pytest.approx(0.5)
    assert port_fleet.jain_index([]) == 1.0


@BOTH
def test_fault_on_live_collective_job_rejected(pkg):
    jobs = (_job(pkg, "A", ("w0", "w1"), ps_hosts=(), sync_mode="allreduce",
                 faults=pkg[5](mttf=5.0, mttr=1.0, horizon=50.0)),
            _job(pkg, "B", ("w4", "w5"), seed=1))
    cfg = pkg[1].FleetConfig(topology=_topology(pkg), jobs=jobs)
    with pytest.raises(ValueError, match="live-collective"):
        pkg[1].FleetSimulation(cfg).run(_steps(pkg, cfg), merged=True)


def _plain(cfg):
    return dataclasses.asdict(cfg)


def test_scale_fleet_pins_rack_caps():
    def run(pkg):
        cfg = _pair(pkg, oversub=4.0)
        caps_before = cfg.topology.rack_uplink_caps()
        scaled = pkg[6].scale_fleet(cfg, "A", 3)
        assert scaled.jobs[0].num_workers == 3 * cfg.jobs[0].num_workers
        assert scaled.jobs[1].workers == cfg.jobs[1].workers
        caps_after = scaled.topology.rack_uplink_caps()
        for rack, (eg, _in) in caps_before.items():
            assert caps_after[rack][0] == pytest.approx(eg)
        assert pkg[6].scale_fleet(cfg, "A", 1) is cfg
        with pytest.raises(ValueError, match="scale factor"):
            pkg[6].scale_fleet(cfg, "A", 0)
        return _plain(scaled), caps_after
    _both(run)


def test_load_fleet_example_spec():
    path = str(ROOT / "examples" / "fleet.json")

    def run(pkg):
        cfg, steps = pkg[6].load_fleet(path)
        assert {j.name for j in cfg.jobs} == {"A", "B"}
        assert set(steps) == {"A", "B"}
        for job in cfg.jobs:
            assert len(steps[job.name]) == 3
        return _plain(cfg), {n: [dataclasses.asdict(t) for t in ts]
                             for n, ts in steps.items()}
    _both(run)


def test_load_fleet_refuses_bad_specs(tmp_path):
    spec = json.loads((ROOT / "examples" / "fleet.json").read_text())
    bad = [{k: v for k, v in spec.items() if k != "nodes"},
           dict(spec, jobs=[dict(spec["jobs"][0], gpus=8)])]
    for i, s in enumerate(bad):
        p = tmp_path / f"bad{i}.json"
        p.write_text(json.dumps(s))
        msgs = []
        for pkg in (REF, PORT):
            with pytest.raises(ValueError) as e:
                pkg[6].load_fleet(str(p))
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]


def _parity(pkg_core, pkg_fleet, cluster):
    """``tests/test_fleet.py``'s two-job shared-PS-host parity case: the
    merged DES and the ``FleetEmulator`` on one alexnet profile."""
    pm, pred, topo = pkg_core
    plat = pm.PLATFORMS["private_cpu"]
    dnn = pm.PAPER_DNNS["alexnet"]
    batch = 8
    tp = topo.Topology(
        workers=(topo.Node("h0", nic=2.0),)
        + tuple(topo.Node(f"w{i}") for i in range(4)),
        placement=topo.Placement(("h0",)), bandwidth=plat.bandwidth)
    overhead = pred.calibrate_overhead(plat, seed=0)
    profile = cluster.profile_single_worker(dnn, batch, plat, steps=14,
                                            seed=0)
    tpls = pred.preprocess_profile(profile, overhead)
    jobs = tuple(pkg_fleet.FleetJob(
        name=n, workers=ws, ps_hosts=("h0",), batch_size=batch,
        steps_per_worker=30, warmup_steps=6, seed=s, win=plat.win_mu,
        stall_alpha=overhead.alpha, stall_rtt=plat.rtt,
        service_jitter=plat.noise_bandwidth)
        for n, ws, s in (("A", ("w0", "w1"), 0), ("B", ("w2", "w3"), 1)))
    cfg = pkg_fleet.FleetConfig(topology=tp, jobs=jobs)
    des = pkg_fleet.FleetSimulation(cfg).run({"A": tpls, "B": tpls},
                                             merged=True).throughputs(cfg)
    wl = dict(dnn=dnn, batch_size=batch, platform=plat)
    emu = cluster.FleetEmulator(cfg, {"A": dict(wl), "B": dict(wl)})
    with pytest.raises(ValueError, match="missing job"):
        cluster.FleetEmulator(cfg, {"A": dict(wl)})
    emu.run(steps_per_worker=30)
    assert emu.member("B") is emu.members[1]
    return des, emu.throughputs(warmup_steps=6)


def test_fleet_emulator_parity_is_the_references():
    from repro.core import paper_models as ref_pm
    from repro.core import predictor as ref_pred
    from repro.emulator import cluster as ref_cluster
    from repro_torch.core import paper_models as port_pm
    from repro_torch.core import predictor as port_pred
    from repro_torch.emulator import cluster as port_cluster
    ref = _parity((ref_pm, ref_pred, ref_topo), ref_fleet, ref_cluster)
    des, emu = _parity((port_pm, port_pred, port_topo), port_fleet,
                       port_cluster)
    assert (des, emu) == ref
    for name in ("A", "B"):
        assert abs(des[name] - emu[name]) / emu[name] < 0.35, name


def test_fleet_to_chrome_trace_is_the_references(tmp_path):
    """A recorded fleet trace (contention timelines on) exports to the
    reference's dict, with and without its config, and the written files
    are byte-equal and valid."""
    outs = []
    for name, pkg in (("ref", REF), ("port", PORT)):
        cfg = _pair(pkg, oversub=4.0, record_contention=True)
        ft = pkg[1].FleetSimulation(cfg).run(_steps(pkg, cfg), merged=True)
        docs = (pkg[7].fleet_to_chrome_trace(ft),
                pkg[7].fleet_to_chrome_trace(ft, cfg))
        path = tmp_path / f"{name}.json"
        pkg[7].write_chrome_trace(docs[1], str(path))
        outs.append((docs, path.read_bytes()))
    assert outs[1] == outs[0]
    assert validate_chrome_trace(json.loads(outs[1][1])) == []
