"""The port's closed-loop calibration (``repro_torch.calibrate``) against the
reference's (``repro.calibrate``).

Both packages draw every synthetic step from one ``random.Random`` in the
same order and fit with the same order statistics, so the same inputs give
the same floats and every comparison here is ``==``: planted-truth steps
and probes, extracted samples, fitted profiles and their digests, profile
and trace-corpus files read across packages, calibrated templates and
predictions, ``ClosedLoop`` histories and their ledger records, and the
CLIs' lines and exit codes. Two fields are left out, as they hold the
clock: a profile's ``provenance["fitted_at"]`` and a ledger record's
``ts`` and ``wall_s``. Sizes are the reference tests' own
(``tests/test_calibrate.py``).
"""
import dataclasses
import json
import random

import pytest

from repro.calibrate import __main__ as ref_cli
from repro.calibrate import extract as ref_extract
from repro.calibrate import fit as ref_fit
from repro.calibrate import loop as ref_loop
from repro.calibrate import synth as ref_synth
from repro.core import paper_models as ref_pm
from repro.core import predictor as ref_pred
from repro.core import simulator as ref_sim
from repro.emulator import cluster as ref_cluster
from repro.launch import whatif as ref_whatif
from repro.obs import ledger as ref_ledger
from repro_torch.calibrate import __main__ as port_cli
from repro_torch.calibrate import extract as port_extract
from repro_torch.calibrate import fit as port_fit
from repro_torch.calibrate import loop as port_loop
from repro_torch.calibrate import synth as port_synth
from repro_torch.core import paper_models as port_pm
from repro_torch.core import predictor as port_pred
from repro_torch.core import simulator as port_sim
from repro_torch.emulator import cluster as port_cluster
from repro_torch.launch import whatif as port_whatif
from repro_torch.obs import ledger as port_ledger
from repro_torch.obs.schema import validate_trace_meta

PKGS = {
    "ref": dict(synth=ref_synth, extract=ref_extract, fit=ref_fit,
                loop=ref_loop, cli=ref_cli, pm=ref_pm, pred=ref_pred,
                sim=ref_sim, cluster=ref_cluster, whatif=ref_whatif,
                ledger=ref_ledger),
    "port": dict(synth=port_synth, extract=port_extract, fit=port_fit,
                 loop=port_loop, cli=port_cli, pm=port_pm, pred=port_pred,
                 sim=port_sim, cluster=port_cluster, whatif=port_whatif,
                 ledger=port_ledger),
}
REF, PORT = PKGS["ref"], PKGS["port"]
CLOCK = ("ts", "wall_s")
# the keys of a ``"recalibrated"`` ledger record, as the reference writes it
RECALIBRATED_KEYS = {"ts", "kind", "config_digest", "predicted", "measured",
                     "error", "wall_s", "calibration_digest", "err_before",
                     "round", "corpus_steps"}


def plain(x):
    """Dataclasses (and lists and tuples of them) as plain values, to
    compare objects of the two packages field by field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def profile_fields(prof) -> dict:
    """A profile's every field but the clock in its provenance."""
    doc = prof.to_dict()
    doc["provenance"] = {k: v for k, v in doc["provenance"].items()
                         if k != "fitted_at"}
    return doc


def both(fn):
    """``fn(pkg)`` for the reference and the port."""
    return fn(REF), fn(PORT)


# ------------------------------------------------------------------ synth


@pytest.mark.parametrize("noise,layers,seed", [(0.0, 4, 3), (0.05, 4, 3),
                                               (0.03, 6, 11)])
def test_planted_truth_steps_and_probes_are_the_references(noise, layers,
                                                           seed):
    def run(pkg):
        truth = pkg["synth"].make_truth(layers=layers, seed=seed,
                                        compute_scale=1.1,
                                        capacity_scale=0.9)
        steps = pkg["synth"].synthesize_steps(truth, steps=12, seed=seed + 1,
                                              noise=noise)
        probes = pkg["synth"].synthesize_parse_probes(truth, seed=seed + 2,
                                                      noise=noise)
        return plain(truth), plain(steps), probes
    ref, port = both(run)
    assert port == ref and len(port[1]) == 12 and len(port[2]) == 10


# ---------------------------------------------------------------- extract


def truth(pkg):
    return pkg["synth"].make_truth(layers=4, seed=3)


def test_extracted_samples_are_the_references():
    def run(pkg):
        steps = pkg["synth"].synthesize_steps(truth(pkg), steps=20, seed=1,
                                              noise=0.05)
        one = pkg["extract"].extract_recorded_steps(steps)
        runs = pkg["extract"].extract_runs([steps[:8], steps[8:]],
                                           source="two")
        merged = pkg["extract"].extract_recorded_steps(steps[:5]).merge(
            pkg["extract"].extract_recorded_steps(steps[5:], source="b"))
        return [(plain(s), s.sample_counts()) for s in (one, runs, merged)]
    ref, port = both(run)
    assert port == ref
    assert port[1][1]["comm_ops"] == port[0][1]["comm_ops"] > 0


# ------------------------------------------------------------------- fit


FITS = {
    "noise 0.05, probes": dict(noise=0.05, steps=60, probes=True),
    "noise 0, probes": dict(noise=0.0, steps=50, probes=True),
    "noise 0, prior": dict(noise=0.0, steps=50, prior=True),
    "noise 0.03, prior": dict(noise=0.03, steps=40, prior=True),
    "noise 0.03, alternating": dict(noise=0.03, steps=40, win=4e6),
}


def fitted(pkg, noise, steps, probes=False, prior=False, win=None):
    t = truth(pkg)
    samples = pkg["extract"].extract_recorded_steps(
        pkg["synth"].synthesize_steps(t, steps=steps, seed=1, noise=noise))
    if probes:
        samples.parse.extend(pkg["synth"].synthesize_parse_probes(
            t, seed=2, noise=noise))
    return pkg["fit"].fit_profile(
        samples, prior_overhead=t.overhead if prior else None, win_hint=win)


@pytest.mark.parametrize("case", sorted(FITS))
def test_fit_profile_and_digest_are_the_references(case):
    ref, port = both(lambda pkg: fitted(pkg, **FITS[case]))
    assert port.params() == ref.params()
    assert port.digest == ref.digest
    assert profile_fields(port) == profile_fields(ref)
    assert isinstance(port.provenance["fitted_at"], float)
    assert port.link_capacity and port.op_times


def test_robust_estimators_are_the_references():
    rng = random.Random(7)
    xs = [rng.lognormvariate(0.0, 0.3) for _ in range(41)] + [50.0, 0.001]
    pts = [(float(x), 3e-9 * x + 2e-3 + rng.gauss(0, 1e-4))
           for x in range(1, 60)]
    rng.shuffle(pts)
    spans = [1.0 + rng.random() * 0.1 for _ in range(20)]

    def run(pkg):
        f = pkg["fit"]
        return (f.mad_filter(xs), f.trimmed_mean(xs),
                f.robust_location(xs, trim=0.2, k=3.0),
                [f.quantile(xs, q) for q in (0.0, 0.25, 0.75, 1.0)],
                f.theil_sen(pts), f.theil_sen(pts, max_pairs=50),
                f.fit_residual_overhead(spans, [0.9 * s for s in spans]),
                f.fit_residual_overhead([], spans))
    ref, port = both(run)
    assert port == ref


# ------------------------------------------------------------ file formats


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_trace_corpus_files_load_in_the_other_package(writer, tmp_path):
    """Each package writes the same bytes, and reads the other's files as
    the same runs (``load_trace_runs`` sorts a directory by name)."""
    reader = "port" if writer == "ref" else "ref"
    w, r = PKGS[writer], PKGS[reader]
    steps = w["synth"].synthesize_steps(truth(w), steps=6, seed=2,
                                        noise=0.01)
    w["extract"].save_traces(str(tmp_path / "b.json"), steps[3:],
                             meta={"run": 1})
    w["extract"].save_traces(str(tmp_path / "a.json"), steps[:3])
    r["extract"].save_traces(str(tmp_path / "own" / "a.json"), steps[:3])
    assert (tmp_path / "own" / "a.json").read_bytes() \
        == (tmp_path / "a.json").read_bytes()
    runs = r["extract"].load_trace_runs(str(tmp_path))
    assert [len(x) for x in runs] == [3, 3]
    assert plain([s for x in runs for s in x]) == plain(steps)
    assert plain(r["extract"].load_traces(str(tmp_path / "b.json"))) \
        == plain(steps[3:])


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_profile_files_load_in_the_other_package(writer, tmp_path):
    reader = "port" if writer == "ref" else "ref"
    prof = fitted(PKGS[writer], **FITS["noise 0.05, probes"])
    path = str(tmp_path / "prof.json")
    prof.save(path)
    back = PKGS[reader]["fit"].CalibrationProfile.load(path)
    assert back.digest == prof.digest
    assert back.to_dict() == prof.to_dict()
    back.save(str(tmp_path / "again.json"))
    assert (tmp_path / "again.json").read_bytes() \
        == (tmp_path / "prof.json").read_bytes()


def _errors(fn):
    try:
        fn()
    except (ValueError, FileNotFoundError) as e:
        return type(e).__name__, str(e)
    return None


def test_the_references_errors_with_their_messages(tmp_path):
    """Every refusal of extract, fit and loop: the same type and text."""
    (tmp_path / "junk.json").write_text("{}")
    (tmp_path / "v9.json").write_text(json.dumps(
        {"format": "repro.calibrate.traces", "version": 9}))
    (tmp_path / "empty").mkdir()
    tampered = fitted(REF, **FITS["noise 0.05, probes"]).to_dict()
    tampered["overhead_beta"] = 123.0
    run = dict(dnn="alexnet", batch_size=64, platform="private_cpu")

    def run_errors(pkg):
        x, f = pkg["extract"], pkg["fit"]
        return [_errors(c) for c in (
            lambda: x.load_traces(str(tmp_path / "junk.json")),
            lambda: x.load_traces(str(tmp_path / "v9.json")),
            lambda: x.load_trace_runs(str(tmp_path / "empty")),
            lambda: f.trimmed_mean([]),
            lambda: f.quantile([], 0.5),
            lambda: f.theil_sen([(1.0, 1.0)]),
            lambda: f.theil_sen([(2.0, 1.0), (2.0, 3.0)]),
            lambda: f.CalibrationProfile.from_dict({"version": 99}),
            lambda: f.CalibrationProfile.from_dict(tampered),
            lambda: pkg["loop"].ClosedLoop(
                run=pkg["pred"].PredictionRun(**run), num_workers=2,
                refit="sometimes"))]
    ref, port = both(run_errors)
    assert port == ref and None not in port
    assert "digest mismatch" in port[8][1]


# ------------------------------------------------- application to the DES


_RUNS = {}


def base_run(pkg):
    """``tests/test_calibrate.py``'s base run, built once a module."""
    name = "ref" if pkg is REF else "port"
    if name not in _RUNS:
        _RUNS[name] = pkg["pred"].PredictionRun(
            "alexnet", 64, "private_cpu", profile_steps=10, sim_steps=40,
            warmup_steps=5).prepare()
    return _RUNS[name]


def trace_of(pkg, run, W=3):
    cfg, tpls, _w, _b, _warm = run.prediction_tasks(W, 1)[0]
    cfg.record_trace = True
    return pkg["sim"].Simulation(cfg).run(tpls, W)


def drifted(pkg, compute=1.2, bw=0.7):
    """``examples/calibration.md``'s drifted ``private_cpu`` by default:
    compute 20% slower, NIC 30% below nominal."""
    plat0 = pkg["pm"].PLATFORMS["private_cpu"]
    return dataclasses.replace(
        plat0, worker_flops=plat0.worker_flops / compute,
        ps_update_bw=plat0.ps_update_bw / compute,
        bandwidth=plat0.bandwidth * bw)


def example_observation(pkg):
    """``examples/calibration.md``'s observed run: W = 3, 50 steps."""
    return pkg["cluster"].observe_run(
        pkg["pm"].PAPER_DNNS["alexnet"], 64, drifted(pkg), num_workers=3,
        steps=50, warmup_steps=50)


def drifted_observe(pkg, compute, bw, steps, warmup):
    """``tests/test_calibrate.py``'s observer of a drifted platform."""
    pert = drifted(pkg, compute, bw)

    def observe(run, W):
        return pkg["cluster"].observe_run(
            pkg["pm"].PAPER_DNNS[run.dnn], run.batch_size, pert, W,
            num_ps=run.num_ps, steps=steps, seed=run.seed + 1000,
            flow_control=run.flow_control, order=run.order,
            warmup_steps=warmup)
    return observe


def test_identity_profile_is_bit_inert_and_the_references():
    def run(pkg):
        r = base_run(pkg)
        prof = pkg["loop"].identity_profile(r)
        cal, healthy = trace_of(pkg, r.with_calibration(prof)), trace_of(pkg, r)
        return prof, cal, healthy
    (rprof, rcal, _), (pprof, pcal, phealthy) = both(run)
    assert pprof.to_dict() == rprof.to_dict()
    assert pcal.step_completions == phealthy.step_completions \
        == rcal.step_completions
    assert [(x.name, x.start, x.end) for x in pcal.records] \
        == [(x.name, x.start, x.end) for x in phealthy.records] \
        == [(x.name, x.start, x.end) for x in rcal.records]
    assert pcal.meta["calibration_digest"] == pprof.digest
    assert "calibration_digest" not in phealthy.meta
    assert validate_trace_meta(pcal, strict=True) == []


def test_des_trace_extraction_and_fit_are_the_references():
    def run(pkg):
        r = base_run(pkg)
        samples = pkg["extract"].extract_des_trace(
            trace_of(pkg, r, W=2),
            size_of=pkg["extract"].template_sizes(r.sim_steps_templates))
        return plain(samples), pkg["fit"].fit_profile(samples)
    (rs, rprof), (ps, pprof) = both(run)
    assert ps == rs and ps["parse"]
    assert profile_fields(pprof) == profile_fields(rprof)


def test_fitted_profiles_apply_and_predict_as_the_references():
    """The drifted case's fitted profile, a doubled identity profile and a
    residual overhead: calibrated templates and predictions ``==``."""
    def run(pkg):
        r = base_run(pkg)
        measured, steps = example_observation(pkg)
        fitted_prof = pkg["loop"].fit_from_steps(steps, run=r)
        ident = pkg["loop"].identity_profile(r)
        doubled = dataclasses.replace(
            ident, op_times={k: 2.0 * v for k, v in ident.op_times.items()},
            residual_overhead_s=0.01)
        out = [measured, r.predict(3, n_runs=2)]
        for prof in (fitted_prof, doubled):
            tpls = prof.apply_to_templates(r.sim_steps_templates,
                                           fallback_overhead=r.overhead)
            out += [prof.digest, plain(tpls),
                    r.with_calibration(prof).predict(3, n_runs=2)]
        out.append(r.with_calibration(fitted_prof).with_calibration(None)
                   .predict(3, n_runs=2))
        return out
    ref, port = both(run)
    assert port == ref
    measured, open_loop, digest = port[0], port[1], port[2]
    assert digest == "5143346ec49c55b2"
    err = port_pred.prediction_error
    assert err(port[4], measured) < 0.5 * err(open_loop, measured)
    assert port[-1] == open_loop


# ------------------------------------------------------------ closed loop


LOOPS = {
    "drift fires": dict(W=3, rounds=2, refit="drift", gate=0.10,
                        drift=(1.25, 0.7)),
    "nominal never fires": dict(W=2, rounds=2, refit="drift", gate=0.10,
                                drift=(1.0, 1.0)),
    "always refits": dict(W=2, rounds=2, refit="always", gate=0.05,
                          drift=(1.2, 0.75)),
}


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_closed_loop_histories_and_records_are_the_references(case, tmp_path,
                                                              monkeypatch):
    c = LOOPS[case]
    out = {}
    for name, pkg in PKGS.items():
        path = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("REPRO_LEDGER", str(path))
        lp = pkg["loop"].ClosedLoop(
            run=base_run(pkg), num_workers=c["W"],
            observe=drifted_observe(pkg, *c["drift"], steps=30,
                                    warmup=base_run(pkg).warmup_steps),
            n_runs=1, gate=c["gate"], refit=c["refit"])
        for _ in range(c["rounds"]):
            lp.round()
        recs = [r for r in pkg["ledger"].read(str(path))
                if r["kind"] == "recalibrated"] if path.exists() else []
        out[name] = (plain(lp.history), lp.errors(),
                     [len(r) for r in lp.corpus],
                     [{k: v for k, v in r.items() if k not in CLOCK}
                      for r in recs], recs)
    assert out["port"][:4] == out["ref"][:4]
    hist, recs = out["port"][0], out["port"][4]
    fired = [h for h in hist if h["recalibrated"]]
    assert len(recs) == len(fired)
    for r in recs:
        assert set(r) == RECALIBRATED_KEYS
        assert r["calibration_digest"] == hist[r["round"]]["profile_digest"]
    if case == "nominal never fires":
        assert not fired
    else:
        assert hist[0]["recalibrated"]
        assert hist[0]["err_after"] < hist[0]["err_before"]


def test_closed_loop_writes_no_record_with_the_ledger_off(monkeypatch):
    monkeypatch.delenv("REPRO_LEDGER", raising=False)
    port_ledger.disable()
    lp = port_loop.ClosedLoop(run=base_run(PORT), num_workers=3,
                              observe=drifted_observe(PORT, 1.25, 0.7, 30,
                                                      5),
                              n_runs=1, gate=0.10)
    res = lp.round()
    assert res.recalibrated and port_ledger.resolve_path() is None
    assert lp.run.calibration.digest == res.profile_digest


@pytest.mark.parametrize("args", [(0.03, None, 0.05), (0.08, None, 0.05),
                                  (0.30, 0.28, 0.05), (0.30, 0.10, 0.05),
                                  (0.05, None, None), (0.051, None, None)])
def test_drift_gate_is_the_references(args):
    pre, post, gate = args
    kw = {} if gate is None else {"gate": gate}
    assert port_loop.should_recalibrate(pre, post, **kw) \
        == ref_loop.should_recalibrate(pre, post, **kw)
    assert port_loop.DEFAULT_GATE == ref_loop.DEFAULT_GATE == 0.05


# -------------------------------------------------------------------- CLIs


def _cli(pkg, argv, capsys, masks):
    code = pkg["cli"].main(argv)
    out = capsys.readouterr().out
    for mask, name in masks:
        out = out.replace(mask, name)
    return code, out.splitlines()


def test_calibrate_cli_prints_the_references_lines(tmp_path, capsys):
    """``fit`` (with and without ``--platform`` and ``-o``), ``show`` and
    ``check`` against the open-loop identity profile (exit 1: drifted) and
    against itself (exit 0), through both packages' ``main``."""
    _m, steps = example_observation(PORT)
    corpus = tmp_path / "traces"
    port_extract.save_traces(str(corpus / "run0.json"), steps)
    ident = tmp_path / "ident.json"
    port_loop.identity_profile(base_run(PORT)).save(str(ident))
    outs = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        prof = str(d / "profile.json")
        runs = [
            ["fit", str(corpus), "--platform", "private_cpu", "-o", prof],
            ["show", prof],
            ["check", prof, str(ident)],
            ["check", prof, prof, "--gate", "0.2"],
            ["fit", str(corpus / "run0.json"), "--win", "3e6"],
        ]
        masks = ((str(d), "<out>"), (str(tmp_path), "<tmp>"))
        outs[name] = [_cli(pkg, argv, capsys, masks) for argv in runs]
    assert outs["port"] == outs["ref"]
    codes = [code for code, _ in outs["port"]]
    assert codes == [0, 0, 1, 0, 0]
    lines = outs["port"]
    assert lines[0][1] == ["wrote <out>/profile.json (digest "
                           "5143346ec49c55b2, 150 steps)"]
    assert lines[2][1][-1] == "# verdict: DRIFT (gate 10.0%)"
    assert lines[3][1][-1] == "# verdict: OK (gate 20.0%)"


@pytest.mark.parametrize("argv", [[], ["nope"], ["fit"], ["check", "a"]])
def test_calibrate_cli_refuses_as_the_reference(argv, capsys):
    codes = []
    for pkg in (REF, PORT):
        with pytest.raises(SystemExit) as e:
            pkg["cli"].main(argv)
        codes.append(e.value.code)
    assert codes == [2, 2]


def test_whatif_calibrate_prints_the_references_lines(tmp_path, monkeypatch,
                                                      capsys):
    """``whatif --ps-cluster ... --calibrate DIR``: the ``# calibration:``
    line with the fitted digest, then the table, and the ``whatif_ps``
    ledger record with its calibrated prediction."""
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    _m, steps = example_observation(PORT)
    corpus = tmp_path / "traces"
    ref_extract.save_traces(str(corpus / "run0.json"), steps)
    argv = ["--ps-cluster", "--dnn", "alexnet", "--batch", "64", "--workers",
            "3", "--profile-steps", "10", "--sim-steps", "40", "--calibrate",
            str(corpus)]
    outs, recs = [], []
    for name, pkg in PKGS.items():
        led = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("REPRO_LEDGER", str(led))
        monkeypatch.setattr("sys.argv", ["whatif"] + argv)
        try:
            pkg["whatif"].main() if pkg is REF else pkg["whatif"].main(argv)
        finally:
            pkg["ledger"].disable()
        outs.append(capsys.readouterr().out.replace(str(tmp_path), "<tmp>")
                    .splitlines())
        recs.append([{k: v for k, v in r.items() if k not in CLOCK}
                     for r in pkg["ledger"].read(str(led))])
    assert outs[1] == outs[0]
    assert outs[1][0] == ("# calibration: <tmp>/traces -> profile "
                          "5143346ec49c55b2 (150 steps, 24 ops, 2 links)")
    assert recs[1] == recs[0] and recs[1][-1]["figure"] == "whatif_ps"
