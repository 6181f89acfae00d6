"""The port's lockstep batched engine (``repro_torch.core.batched``) against
the reference's (``repro.core.batched``) and both scalar engines.

The batched engine promises traces bit-identical to running each scenario
through ``Simulation(cfg).run(...)``. Every family of
``tests/test_batched_equivalence.py`` is built in both packages from the
same seeds, and the port's batched fingerprints must equal the reference's
batched and scalar ones with ``==``. The key schedule and the draws of the
vectorised MT19937 are held to ``random.Random``, and the fallback reasons
and categories to the reference's.

One case differs on purpose. On the paper's own profiled templates the
reference's batched engine started a dependent released onto the
resource its parent just left ahead of that resource's queue, where the
scalar engine starts the queue's head. The port mirrors the scalar
engine there, so on that case it equals both scalar engines and the
reference's batched engine does not.
"""
import dataclasses
import random

import numpy as np
import pytest

from repro.core import batched as ref_batched
from repro.core import events as ref_events
from repro.core import faults as ref_faults
from repro.core import predictor as ref_pred
from repro.core import simulator as ref_sim
from repro.core import sweep as ref_sweep
from repro_torch.core import batched as port_batched
from repro_torch.core import events as port_events
from repro_torch.core import faults as port_faults
from repro_torch.core import predictor as port_pred
from repro_torch.core import simulator as port_sim
from repro_torch.core import sweep as port_sweep
from repro_torch.obs import metrics as port_metrics
from repro_torch.obs.schema import validate_trace_meta

REF = (ref_batched, ref_events, ref_faults, ref_sim)
PORT = (port_batched, port_events, port_faults, port_sim)
NSEEDS = 4


def make_template(pkg, layers, seed=0, num_ps=1):
    """``tests/test_batched_equivalence.py``'s PS-shaped step."""
    ev = pkg[1]
    rng = random.Random(seed)

    def link(kind, i):
        return kind if num_ps == 1 else f"{kind}:{i % num_ps}"

    ops = []
    fwd_prev = None
    for i in range(layers):
        dl = len(ops)
        ops.append(ev.Op(f"dl{i}", link("downlink", i),
                         size=rng.uniform(2e6, 3e7)))
        deps = (dl,) if fwd_prev is None else (dl, fwd_prev)
        fwd_prev = len(ops)
        ops.append(ev.Op(f"fwd{i}", "worker",
                         duration=rng.uniform(.005, .05), deps=deps))
    bwd_prev = fwd_prev
    for i in reversed(range(layers)):
        bwd = len(ops)
        ops.append(ev.Op(f"bwd{i}", "worker",
                         duration=rng.uniform(.01, .08), deps=(bwd_prev,)))
        bwd_prev = bwd
        ops.append(ev.Op(f"ul{i}", link("uplink", i),
                         size=rng.uniform(2e6, 3e7), deps=(bwd,)))
    return ev.StepTemplate(ops=ops)


def make_cfg(pkg, steps_per_worker, seed=0, num_ps=1, **kw):
    return pkg[3].SimConfig(resources=pkg[1].ps_resources(1e9, num_ps),
                            link_policy="http2", win=2.8e6,
                            steps_per_worker=steps_per_worker,
                            warmup_steps=2, seed=seed, service_jitter=0.08,
                            stall_alpha=2e-9, stall_rtt=5e-4, **kw)


def families(pkg):
    """Every family of the reference's differential suite, at its default
    size, in ``pkg``'s classes."""
    Sc = pkg[0].Scenario
    rep = dataclasses.replace
    tpls = [make_template(pkg, 3, seed=0)]
    tpls2 = [make_template(pkg, 3, seed=0), make_template(pkg, 4, seed=1)]
    tpls_ps2 = [make_template(pkg, 3, seed=0, num_ps=2),
                make_template(pkg, 4, seed=1, num_ps=2)]
    cfg = lambda n, s, **kw: make_cfg(pkg, n, seed=s, **kw)  # noqa: E731
    seeds = range(NSEEDS)
    return {
        "smoke_w4": [Sc(cfg(6, s), tpls, 4) for s in seeds],
        "w8_ps2_2tpl": [Sc(cfg(5, s, num_ps=2), tpls_ps2, 8) for s in seeds],
        "mixed_w": [Sc(cfg(4, s), tpls2, 1 + (s % 8))
                    for s in range(2 * NSEEDS)],
        "fifo": [Sc(rep(cfg(5, s), link_policy="fifo"), tpls, 4)
                 for s in seeds],
        "stall0": [Sc(rep(cfg(5, s), stall_alpha=0.0, stall_rtt=0.0),
                      tpls, 4) for s in seeds],
        "jitter0": [Sc(rep(cfg(4, s), service_jitter=0.0), tpls, 3)
                    for s in seeds],
        "cycle": [Sc(cfg(5, s), tpls2, 4, sample=False) for s in seeds],
    }


def fingerprint(tr):
    return (tr.step_completions, tr.staleness, tr.meta["sim_end_time"],
            tr.meta["num_events"], tr.meta["num_versions"])


FAMILY_NAMES = sorted(families(REF))


@pytest.fixture(scope="module")
def fams():
    """Both packages' families, and each package's batched and scalar
    traces of them, run once a module."""
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        fam = families(pkg)
        out[name] = {
            f: (scens,
                pkg[0].run_scenarios(scens, engine="auto", min_batch=1),
                [pkg[3].Simulation(sc.cfg).run(sc.steps, sc.num_workers,
                                               sample=sc.sample)
                 for sc in scens])
            for f, scens in fam.items()}
    return out


@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_batched_family_is_the_references_and_the_scalar_engines(family,
                                                                 fams):
    _, ref_b, ref_s = fams["ref"][family]
    _, port_b, port_s = fams["port"][family]
    assert [fingerprint(t) for t in port_b] \
        == [fingerprint(t) for t in ref_b] \
        == [fingerprint(t) for t in ref_s] \
        == [fingerprint(t) for t in port_s]
    assert [t.meta for t in port_b] == [t.meta for t in ref_b]


def test_the_lockstep_path_is_taken(fams):
    """The family comparison is not scalar against scalar: the smoke
    family runs lockstep in both packages, and the two-template PS family
    too."""
    for f in ("smoke_w4", "w8_ps2_2tpl"):
        for pkg in ("ref", "port"):
            engines = [t.meta["engine"] for t in fams[pkg][f][1]]
            assert engines.count("batched") >= len(engines) // 2, (f, pkg)


def _classify_cases(pkg):
    cfg = make_cfg(pkg, 4, seed=0)
    rep = dataclasses.replace
    FS = pkg[2].FaultSpec
    return [(cfg, 4), (rep(cfg, sync_mode="sync"), 4),
            (rep(cfg, sync_mode="ssp", staleness_bound=2), 4),
            (rep(cfg, faults=FS(mttf=10.0, mttr=1.0)), 4),
            (rep(cfg, faults=FS()), 4),
            (rep(cfg, link_policy="ordered"), 4),
            (rep(cfg, record_trace=True), 4),
            (rep(cfg, record_rates=True), 4),
            (rep(cfg, worker_speed={0: 2.0}), 4),
            (rep(cfg, seed=None), 4), (cfg, 0)]


def test_classify_reasons_are_the_references():
    ref = [ref_batched.classify(c, w) for c, w in _classify_cases(REF)]
    port = [port_batched.classify(c, w) for c, w in _classify_cases(PORT)]
    assert port == ref and port[0] is None and port[4] is None
    assert all(r is not None for i, r in enumerate(port) if i not in (0, 4))


@pytest.mark.parametrize("reason", [
    "sync_mode='sync' (barrier state machine)", "fault injection",
    "explicit topology",
    "non-uniform bandwidth model (general waterfill path)",
    "heterogeneous compute speeds", "link_policy='ordered'",
    "per-op trace recording",
    "unseeded RNG (no reproducible stream to replicate)",
    "num_workers < 1", "no steps", "forced scalar",
    "group of 1 < min_batch", "batch remainder < min_batch",
    "punt: simultaneous events", "something new"])
def test_fallback_category_is_the_references(reason):
    assert port_batched._fallback_category(reason) \
        == ref_batched._fallback_category(reason)


def _fallback_scens(pkg):
    FS = pkg[2].FaultSpec
    Sc = pkg[0].Scenario
    tpls = [make_template(pkg, 3, seed=0)]
    cfg = lambda **kw: make_cfg(pkg, 5, seed=0, **kw)  # noqa: E731
    return [Sc(cfg(sync_mode="sync"), tpls, 4),
            Sc(cfg(faults=FS(mttf=40.0, mttr=5.0)), tpls, 4),
            Sc(cfg(worker_speed={0: 2.0}), tpls, 4),
            Sc(dataclasses.replace(cfg(), link_policy="ordered"), tpls, 4),
            Sc(cfg(record_trace=True), tpls, 4),
            Sc(cfg(), tpls, 0), Sc(cfg(), [], 2),
            Sc(cfg(), tpls, 2)]


def test_fallback_traces_and_histogram_are_the_references():
    """Unbatchable scenarios, an empty template list and a lone group of
    one (``min_batch`` 2) ride the scalar path with the reference's
    reason, category and trace."""
    outs = []
    for pkg in (REF, PORT):
        scens = _fallback_scens(pkg)
        runnable = [sc for sc in scens if sc.num_workers and sc.steps]
        traces = pkg[0].run_scenarios(runnable, engine="auto", min_batch=2)
        with pytest.raises(ValueError):
            pkg[0].run_scenarios([scens[6]])   # the scalar engine refuses
        outs.append((
            [(t.meta["engine"], t.meta["batch_fallback"],
              t.meta["batch_fallback_reason"], fingerprint(t))
             for t in traces],
            pkg[0].fallback_histogram(traces + [None])))
    assert outs[1] == outs[0]
    assert outs[1][1] == {"barrier": 1, "faults": 1, "hetero": 1,
                          "policy": 1, "trace": 1, "group-size": 1}


def test_forced_scalar_min_batch_and_unknown_engine():
    outs = []
    for pkg in (REF, PORT):
        Sc = pkg[0].Scenario
        tpls = [make_template(pkg, 3, seed=0)]
        scens = [Sc(make_cfg(pkg, 4, seed=s), tpls, 2) for s in range(3)]
        forced = pkg[0].run_scenarios(scens, engine="scalar")
        assert {t.meta["batch_fallback_reason"] for t in forced} \
            == {"forced"}
        (small,) = pkg[0].run_scenarios(scens[:1], min_batch=2)
        assert small.meta["batch_fallback_reason"] == "group-size"
        # max_batch 2 splits the three into a batch and a remainder of one
        split = pkg[0].run_scenarios(scens, min_batch=2, max_batch=2)
        with pytest.raises(ValueError, match="unknown engine"):
            pkg[0].run_scenarios(scens, engine="turbo")
        outs.append([[fingerprint(t) for t in forced],
                     fingerprint(small), [fingerprint(t) for t in split],
                     [t.meta.get("batch_fallback") for t in split]])
    assert outs[1] == outs[0]
    assert outs[1][0] == outs[1][2]
    assert outs[1][3] == [None, None, "batch remainder < min_batch"]


def test_mem_per_scenario_is_the_references():
    for args in [(1, 12, 3, 2, 1, 8), (8, 56, 5, 2, 3, 34)]:
        assert port_batched._mem_per_scenario(*args) \
            == ref_batched._mem_per_scenario(*args)


SEEDS = [0, 1, 7, 123456, 2 ** 32 - 1, 2 ** 40 + 3, -5]


def test_batched_mt_key_schedule_is_cpythons():
    """Row b of the port's vectorised seeder equals CPython's state for
    seed b and the reference's row: the one-word fast path and the
    ``getstate()`` path of the two wider seeds."""
    for seeds in (SEEDS[:5], SEEDS[5:]):
        port = port_batched._BatchedMT(seeds)
        ref = ref_batched._BatchedMT(seeds)
        for b, s in enumerate(seeds):
            want = list(random.Random(s).getstate()[1][:624])
            assert port.key[b].tolist() == want == ref.key[b].tolist()


def test_batched_mt_draws_are_cpythons():
    """``random_``, ``gauss`` (with its cached second value) and
    ``randrange`` interleaved past two refills, per stream, against
    ``random.Random`` and the reference's streams."""
    seeds = SEEDS[:5]
    sel = np.arange(len(seeds))
    mu = np.full(len(seeds), -0.0032)
    sigma = np.full(len(seeds), 0.08)
    got = {}
    for name, mod in (("ref", ref_batched), ("port", port_batched)):
        mt = mod._BatchedMT(seeds)
        rows = []
        for k in range(700):
            rows.append(mt.random_(sel).tolist())
            rows.append(mt.gauss(sel, mu, sigma).tolist())
            rows.append(mt.randrange(sel, 3 + k % 5).tolist())
        got[name] = rows
    cpy = []
    rngs = [random.Random(s) for s in seeds]
    for k in range(700):
        cpy.append([r.random() for r in rngs])
        cpy.append([r.gauss(-0.0032, 0.08) for r in rngs])
        cpy.append([r.randrange(3 + k % 5) for r in rngs])
    assert got["port"] == cpy == got["ref"]


# ------------------------------------------- the repaired mirror (quirk)


def _paper_case(pkg):
    """The smallest input found: alexnet's first two profiled templates,
    W = 2, 5 steps a worker."""
    run = pkg.PredictionRun(dnn="alexnet", batch_size=16,
                            platform="private_cpu", profile_steps=40,
                            sim_steps=250)
    cfg, tpls, _w, _bs, _wu = run.prediction_tasks(2, 1)[0]
    cfg = dataclasses.replace(cfg, steps_per_worker=5, warmup_steps=2)
    return cfg, tpls[:2]


def test_batched_engine_equals_the_scalar_engines_on_the_paper_templates():
    """The port's batched engine equals both scalar engines bit for bit on
    the smallest input found; the reference's batched engine runs the
    case lockstep too and does not (its 9th completion is one ulp early),
    because it starts a released dependent ahead of its resource's queue
    (the ``_enqueue`` mirror in ``core/batched.py``)."""
    rcfg, rtpls = _paper_case(ref_pred)
    pcfg, ptpls = _paper_case(port_pred)
    ref_b = ref_batched.run_scenarios(
        [ref_batched.Scenario(rcfg, rtpls, 2)], min_batch=1)[0]
    port_b = port_batched.run_scenarios(
        [port_batched.Scenario(pcfg, ptpls, 2)], min_batch=1)[0]
    ref_s = ref_sim.Simulation(rcfg).run(rtpls, 2)
    port_s = port_sim.Simulation(pcfg).run(ptpls, 2)
    assert ref_b.meta["engine"] == port_b.meta["engine"] == "batched"
    assert fingerprint(port_b) == fingerprint(port_s) == fingerprint(ref_s)
    assert fingerprint(ref_b) != fingerprint(ref_s)
    assert ref_b.step_completions[8] == (0, 4, 39.38884584318947)
    assert port_b.step_completions[8] == (0, 4, 39.388845843189486)


def test_batched_predict_many_equals_the_serial_pool(monkeypatch):
    """The cheap paper case of the quirk: ``predict_many(batch=True)``
    equals the port's and the reference's serial ``predict_many``, with
    the metrics counters showing every scenario ran lockstep."""
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    kw = dict(dnn="alexnet", batch_size=8, platform="private_cpu",
              profile_steps=10, sim_steps=60)
    ref = ref_pred.PredictionRun(**kw).prepare()
    port = port_pred.PredictionRun(**kw).prepare()
    port_metrics.reset()
    port_metrics.enable()
    try:
        batched = port_sweep.predict_many(port, [2, 4], n_runs=2,
                                          batch=True)
        counts = port_metrics.snapshot()["counters"]
    finally:
        port_metrics.disable()
        port_metrics.reset()
    assert batched == port_sweep.predict_many(port, [2, 4], n_runs=2) \
        == ref_sweep.predict_many(ref, [2, 4], n_runs=2)
    assert counts["batched.scenarios"] == counts["batched.lockstep"] == 4


def test_simulate_all_batch_and_simulate_batched_equal_serial(monkeypatch):
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    kw = dict(dnn="alexnet", batch_size=8, platform="private_cpu",
              profile_steps=10, sim_steps=40)
    ref = ref_pred.PredictionRun(**kw).prepare()
    port = port_pred.PredictionRun(**kw).prepare()
    tasks = port.prediction_tasks(1, 2) + port.prediction_tasks(3, 1)
    rtasks = ref.prediction_tasks(1, 2) + ref.prediction_tasks(3, 1)
    serial = port_sweep.simulate_all(tasks)
    assert port_sweep.simulate_all(tasks, batch=True) == serial \
        == port_sweep.simulate_batched(tasks, engine="scalar") \
        == ref_sweep.simulate_all(rtasks) \
        == ref_sweep.simulate_batched(rtasks, engine="scalar")
    shared = [(t[0], None) + tuple(t[2:]) for t in tasks]
    assert port_sweep.simulate_batched(shared, templates=tasks[0][1]) \
        == serial


def test_batched_and_fallback_traces_pass_the_strict_schema():
    (pkg_b,) = port_batched.run_scenarios(
        [port_batched.Scenario(make_cfg(PORT, 4, seed=0),
                               [make_template(PORT, 3)], 3)], min_batch=1)
    (pkg_f,) = port_batched.run_scenarios(
        [port_batched.Scenario(make_cfg(PORT, 4, seed=0, sync_mode="sync"),
                               [make_template(PORT, 3)], 3)])
    assert pkg_b.meta["engine"] == "batched"
    assert pkg_f.meta["engine"] == "scalar"
    assert validate_trace_meta(pkg_b, strict=True) == []
    assert validate_trace_meta(pkg_f, strict=True) == []
