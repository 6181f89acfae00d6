"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``).

Both packages run the frozen crash scenario of ``tests/test_obs.py`` (W=2,
one PS shard, one injected crash, trace and rate recording) through their
own DES; everything downstream is plain Python on equal inputs, so every
comparison is exact: Chrome-trace dicts, the bytes of the written JSON,
the validator's verdicts, summaries, counter tracks, config digests,
ledger reports and the CLIs' exit codes.
"""
import json

import pytest

from repro.core import events as ref_events
from repro.core import faults as ref_faults
from repro.core import simulator as ref_sim
from repro.core.bandwidth import BandwidthModel as RefBandwidthModel
from repro.obs import ledger as ref_ledger
from repro.obs import report as ref_report
from repro.obs import schema as ref_schema
from repro.obs import timeline as ref_timeline
from repro.obs import trace_export as ref_export
from repro.obs import view as ref_view
from repro_torch import obs as port_obs
from repro_torch.core import events as port_events
from repro_torch.core import faults as port_faults
from repro_torch.core import simulator as port_sim
from repro_torch.core.bandwidth import BandwidthModel as PortBandwidthModel
from repro_torch.obs import ledger as port_ledger
from repro_torch.obs import report as port_report
from repro_torch.obs import schema as port_schema
from repro_torch.obs import timeline as port_timeline
from repro_torch.obs import trace_export as port_export
from repro_torch.obs import view as port_view

BW = 1e8
REF = (ref_events, ref_faults, ref_sim, RefBandwidthModel)
PORT = (port_events, port_faults, port_sim, PortBandwidthModel)


def crash_scenario(pkg):
    """``tests/test_obs.py``'s frozen acceptance scenario in one package:
    the trace and its templates."""
    events, faults, sim, bw_model = pkg
    ops = [events.Op("c0", "worker", duration=0.05),
           events.Op("pull", "downlink", size=2e6),
           events.Op("push", "uplink", size=2e6, deps=(0, 1))]
    tpls = [events.StepTemplate(ops=ops)]
    cfg = sim.SimConfig(
        resources=events.ps_resources(BW, 1), link_policy="http2",
        win=2.8e6, steps_per_worker=12, warmup_steps=2, seed=3,
        record_trace=True, record_rates=True, bandwidth_model=bw_model(),
        faults=faults.FaultSpec(crashes=((0.4, 0),), mttr=0.3))
    return sim.Simulation(cfg).run(tpls, 2), tpls


@pytest.fixture(scope="module")
def crash():
    """(reference trace, port trace, reference doc, port doc)."""
    ref, ref_tpls = crash_scenario(REF)
    port, port_tpls = crash_scenario(PORT)
    return (ref, port, ref.to_chrome_trace(templates=ref_tpls),
            port.to_chrome_trace(templates=port_tpls))


# ------------------------------------------------------------ trace export


def test_chrome_trace_dicts_are_the_references(crash):
    ref, port, ref_doc, port_doc = crash
    assert port_doc == ref_doc
    # and it is a real trace: a crash marker, flows and rate counters
    names = {e["name"] for e in port_doc["traceEvents"]}
    assert {"crash:0", "recover:crash:0", "rate downlink"} <= names
    assert any(e["ph"] == "s" for e in port_doc["traceEvents"])


def test_exporter_without_templates_is_the_references(crash):
    """Without templates the flow arrows are inferred by time
    coincidence."""
    ref, port, _, _ = crash
    doc = port_export.to_chrome_trace(port, trace_name="x")
    assert doc == ref_export.to_chrome_trace(ref, trace_name="x")


def test_written_json_is_byte_equal(crash, tmp_path):
    _, _, ref_doc, port_doc = crash
    a = ref_export.write_chrome_trace(ref_doc, str(tmp_path / "ref.json"))
    b = port_export.write_chrome_trace(port_doc, str(tmp_path / "port.json"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _broken_traces(doc):
    """The reference test's broken traces, and a few more."""
    dangling = {"traceEvents": [dict(e) for e in doc["traceEvents"]]}
    dangling["traceEvents"].append(
        {"ph": "s", "pid": 1, "tid": 0, "ts": 1.0, "id": 999999,
         "name": "dangling", "cat": "flow"})
    return {
        "valid": doc,
        "dangling flow": dangling,
        "ts regression": {"traceEvents": [
            {"ph": "i", "s": "g", "pid": 0, "tid": 0, "ts": 5.0, "name": "a"},
            {"ph": "i", "s": "g", "pid": 0, "tid": 0, "ts": 1.0,
             "name": "b"}]},
        "empty object": {},
        "not an object": [1, 2],
        "no events": {"traceEvents": []},
        "bad dur and counter": {"traceEvents": [
            {"ph": "X", "pid": 1, "tid": 0, "ts": 0.0, "dur": -1.0},
            {"ph": "C", "pid": 0, "tid": 0, "ts": 1.0, "name": "c"},
            {"ph": "f", "pid": 0, "tid": 0, "ts": 2.0, "id": 7},
            {"ph": "", "ts": 3.0}, "junk",
            {"ph": "i", "ts": float("nan")}]},
    }


@pytest.mark.parametrize("case", ["valid", "dangling flow", "ts regression",
                                  "empty object", "not an object",
                                  "no events", "bad dur and counter"])
def test_validator_verdicts_and_summaries_are_the_references(crash, case):
    _, _, ref_doc, port_doc = crash
    ref_case = _broken_traces(ref_doc)[case]
    port_case = _broken_traces(port_doc)[case]
    verdict = port_view.validate_chrome_trace(port_case)
    assert verdict == ref_view.validate_chrome_trace(ref_case)
    assert (verdict == []) == (case == "valid")
    if isinstance(port_case, dict):
        assert port_view.summarize(port_case) == ref_view.summarize(ref_case)


@pytest.mark.parametrize("flags", [[], ["--validate"], ["--json"]])
def test_view_cli_prints_and_exits_as_the_reference(crash, tmp_path, capsys,
                                                    flags):
    _, _, _, doc = crash
    path = port_export.write_chrome_trace(doc, str(tmp_path / "t.json"))
    rc_ref = ref_view.main([path] + flags)
    out_ref = capsys.readouterr().out
    rc_port = port_view.main([path] + flags)
    assert (rc_port, capsys.readouterr().out) == (rc_ref, out_ref)
    assert rc_port == 0
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"traceEvents": [{"ph": "s", "ts": 0.0, "id": 1}]}, f)
    assert port_view.main([bad, "--validate"]) \
        == ref_view.main([bad, "--validate"]) == 1


# ------------------------------------------------------------- meta schema


def test_scalar_meta_conforms_in_strict_mode(crash):
    ref, port, _, _ = crash
    assert port_schema.validate_trace_meta(port, strict=True) == []
    assert port_schema.validate_meta(port.meta, strict=True) == []
    assert port.meta == ref.meta


@pytest.mark.parametrize("meta", [
    {"engine": "warp-drive", "num_workers": "two"},
    {"engine": "scalar", "num_workers": 2, "steps_per_worker": 10,
     "sim_end_time": 1.0, "num_events": 5, "sync_mode": "lockstep",
     "num_versions": True, "barrier_commits": [], "bogus": 1},
    {}])
def test_validate_meta_flags_what_the_reference_flags(meta):
    for strict in (False, True):
        got = port_schema.validate_meta(meta, strict=strict)
        assert got == ref_schema.validate_meta(meta, strict=strict) != []
    assert port_schema.validate_trace_meta(object()) \
        == ref_schema.validate_trace_meta(object())
    assert (port_schema.ENGINES, port_schema.REQUIRED_KEYS,
            port_schema.OPTIONAL_KEYS) == (ref_schema.ENGINES,
                                           ref_schema.REQUIRED_KEYS,
                                           ref_schema.OPTIONAL_KEYS)


# ------------------------------------------------- timelines and counters


def test_timeline_counters_and_rate_folds_are_the_references(crash):
    ref, port, _, _ = crash
    assert port.rate_log == ref.rate_log and port.rate_log
    assert port_timeline.fold_rate_log(port.rate_log) \
        == ref_timeline.fold_rate_log(ref.rate_log)
    tls = []
    for mod in (ref_timeline, port_timeline):
        tl = mod.LinkTimeline()
        for t, name, _rate, active in port.rate_log:
            tl.record(t, name, active)
        tls.append(tl)
    assert len(tls[1]) == len(tls[0]) == len(port.rate_log)
    assert tls[1].fold() == tls[0].fold()
    assert port_export.timeline_counter_events(tls[1].fold(), "n", "u") \
        == ref_export.timeline_counter_events(tls[0].fold(), "n", "u")
    assert port_export.rate_counter_events(port.rate_log) \
        == ref_export.rate_counter_events(ref.rate_log)


def test_obs_package_exports_the_references_names():
    import repro.obs
    assert port_obs.__all__ == repro.obs.__all__
    for name in port_obs.__all__:
        assert hasattr(port_obs, name)


def test_fleet_export_waits_for_the_fleet_engine():
    """``fleet_to_chrome_trace`` on a fleet trace of the ported fleet
    engine (``examples/fleet.json`` with contention timelines, 10 steps a
    worker) is the reference's dict, with and without the config."""
    import dataclasses
    import pathlib

    from repro.core.sweep import simulate_fleets as ref_fleets
    from repro.launch.whatif import load_fleet as ref_load
    from repro_torch.core.sweep import simulate_fleets as port_fleets
    from repro_torch.launch.whatif import load_fleet as port_load
    path = str(pathlib.Path(__file__).resolve().parents[1] / "examples"
               / "fleet.json")
    docs = []
    for load, fleets, export in ((ref_load, ref_fleets, ref_export),
                                 (port_load, port_fleets, port_export)):
        cfg, steps = load(path)
        cfg = dataclasses.replace(cfg, record_contention=True, jobs=tuple(
            dataclasses.replace(j, steps_per_worker=10, warmup_steps=2)
            for j in cfg.jobs))
        assert fleets([]) == []
        (ft,) = fleets([(cfg, steps, True)], parallel=False)
        docs.append((export.fleet_to_chrome_trace(ft),
                     export.fleet_to_chrome_trace(ft, cfg)))
    assert docs[1] == docs[0]
    assert port_view.validate_chrome_trace(docs[1][1]) == []
    assert {e["name"] for e in docs[1][0]["traceEvents"]
            if e["ph"] == "C"}


# ----------------------------------------------------------------- ledger


@pytest.mark.parametrize("obj", [
    {"x": 1, "y": [2, 3]}, {"y": [2, 3], "x": 1}, [1.5, "a", None],
    {"dnn": "alexnet", "workers": (1, 2, 4), "obj": object},
    "plain"])
def test_config_digest_is_the_references(obj):
    assert port_ledger.config_digest(obj) == ref_ledger.config_digest(obj)


def test_ledger_round_trip(tmp_path):
    p = str(tmp_path / "ledger.jsonl")
    for mean_err in (0.02, 0.04):
        port_ledger.log("predict", path=p, figure="f1", config={"a": 1},
                        engine="scalar", predicted=5.0, mean_err=mean_err,
                        wall_s=1.0, extra={"workers": [1, 2]})
    with open(p, "a") as f:
        f.write("\nnot json\n")
    recs = port_ledger.read(p)
    assert recs == ref_ledger.read(p) and len(recs) == 2
    assert recs[0]["config_digest"] == recs[1]["config_digest"] \
        == ref_ledger.config_digest({"a": 1})
    assert recs[1]["workers"] == [1, 2]
    rec = port_ledger.make_record("t", figure="f", error=0.1)
    ref = ref_ledger.make_record("t", figure="f", error=0.1)
    assert {k: v for k, v in rec.items() if k != "ts"} \
        == {k: v for k, v in ref.items() if k != "ts"}
    payload = {"rows": [{"err": 0.3}, {"err": 0.1}], "predicted": [1, 2]}
    a = port_ledger.figure_record("fx", payload, wall_s=3.0)
    b = ref_ledger.figure_record("fx", payload, wall_s=3.0)
    assert {k: v for k, v in a.items() if k != "ts"} \
        == {k: v for k, v in b.items() if k != "ts"}


def test_ledger_path_resolution_is_the_references(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_LEDGER", raising=False)
    assert port_ledger.resolve_path() is None
    port_ledger.enable(str(tmp_path / "on.jsonl"))
    try:
        assert port_ledger.resolve_path() == str(tmp_path / "on.jsonl")
        monkeypatch.setenv("REPRO_LEDGER", "0")
        assert port_ledger.resolve_path() is None
        assert port_ledger.log("x") is None
        monkeypatch.setenv("REPRO_LEDGER", str(tmp_path / "env.jsonl"))
        assert port_ledger.resolve_path() == str(tmp_path / "env.jsonl")
        assert port_ledger.resolve_path("e.jsonl") == "e.jsonl"
    finally:
        port_ledger.disable()
    assert port_ledger.append(port_ledger.make_record("t"),
                              path="/proc/no/such/dir/l.jsonl") is None


# ----------------------------------------------------------------- report


def _records(mod, errs, figure="f1"):
    return [mod.make_record("figure", figure=figure, mean_err=e,
                            max_err=2 * e, wall_s=1.0) for e in errs]


def test_report_summarize_and_compare_are_the_references():
    ref = _records(ref_ledger, (0.02, 0.04)) + _records(ref_ledger, (0.1,),
                                                        "f2")
    port = _records(port_ledger, (0.02, 0.04)) + _records(port_ledger,
                                                          (0.1,), "f2")
    assert port_report.summarize(port) == ref_report.summarize(ref)
    drifted = [dict(r, mean_err=0.5) for r in port]
    for new, old in ((port, port), (drifted, port), (port[:2], port),
                     ([dict(port[0], mean_err=None)], port)):
        assert port_report.compare(new, old, gate=0.05) \
            == ref_report.compare(new, old, gate=0.05)
    assert not port_report.compare(drifted, port)[0]


@pytest.mark.parametrize("argv", [
    ["new"], ["new", "--json"], ["new", "--figure", "f1"],
    ["new", "--compare", "old"], ["old", "--compare", "old"],
    ["new", "--compare", "missing"], ["missing"],
    ["missing", "--compare", "old"]])
def test_report_cli_prints_and_exits_as_the_reference(argv, tmp_path, capsys):
    new, old = str(tmp_path / "new.jsonl"), str(tmp_path / "old.jsonl")
    port_ledger.log("figure", path=old, figure="f1", mean_err=0.02)
    port_ledger.log("figure", path=new, figure="f1", mean_err=0.9,
                    wall_s=2.0)
    port_ledger.log("figure", path=new, figure="f2", mean_err=0.1)
    paths = {"new": new, "old": old, "missing": str(tmp_path / "no.jsonl")}
    args = [paths.get(a, a) for a in argv]
    rc_ref = ref_report.main(args)
    out_ref = capsys.readouterr()
    rc_port = port_report.main(args)
    out_port = capsys.readouterr()
    assert (rc_port, out_port.out, out_port.err) \
        == (rc_ref, out_ref.out, out_ref.err)
    assert rc_port == {"new --compare old": 1, "missing": 2}.get(
        " ".join(argv), 0)
