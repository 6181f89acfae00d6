"""The port's placement search (``repro_torch.core.placement_search``)
against the reference's (``repro.core.placement_search``).

Every candidate is scored by seeded DES runs and every strategy's own
randomness comes from one seeded ``random.Random``, so both packages walk
the same candidates in the same order: each ``SearchResult`` (placement,
throughput, baseline, ``evaluated``, rounds) is compared with ``==``, as
are the surrogate's proxy scores, the process pool against the serial
run, every ``ValueError`` and the what-if's ``--optimize-placement``
lines. The topologies and templates are ``tests/test_placement_search.py``'s
own.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import events as ref_events
from repro.core import placement_search as ref_ps
from repro.core import predictor as ref_pred
from repro.core import topology as ref_topo
from repro.launch import whatif as ref_whatif
from repro.obs import ledger as ref_ledger
from repro_torch.core import events as port_events
from repro_torch.core import placement_search as port_ps
from repro_torch.core import predictor as port_pred
from repro_torch.core import topology as port_topo
from repro_torch.launch import whatif as port_whatif
from repro_torch.obs import ledger as port_ledger

PKGS = {"ref": (ref_events, ref_ps, ref_topo, ref_pred, ref_whatif,
                ref_ledger),
        "port": (port_events, port_ps, port_topo, port_pred, port_whatif,
                 port_ledger)}
BW = 1e2


def comm_heavy_steps(pkg, n_layers=3, size=200.0, compute=0.02, num_ps=1):
    """Bandwidth-bound steps; layers round-robin over ``num_ps`` shards."""
    ev = pkg[0]
    ops = []
    for i in range(n_layers):
        p = i % num_ps
        dn = "downlink" if num_ps == 1 else f"downlink:{p}"
        up = "uplink" if num_ps == 1 else f"uplink:{p}"
        dl = len(ops)
        ops.append(ev.Op(f"d{i}", dn, size=size))
        ops.append(ev.Op(f"f{i}", "worker", duration=compute, deps=(dl,)))
        ops.append(ev.Op(f"u{i}", up, size=size, deps=(dl + 1,)))
    return [ev.StepTemplate(ops=ops)]


def rack_pool_topology(pkg, num_shards=2, oversub=8.0, bypass=False):
    """The default placement behind an oversubscribed rack uplink, as many
    free nodes in the flat rack; ``bypass`` is the surrogate tests'
    ``loopback_bypass`` variant."""
    t = pkg[2]
    bad = tuple(t.Node(f"bad{p}", rack="r0") for p in range(num_shards))
    good = tuple(t.Node(f"good{p}", rack="r1") for p in range(num_shards))
    return t.Topology(
        workers=tuple(t.Node(f"w{i}", rack="r1") for i in range(3)),
        ps_nodes=bad + good,
        racks=(t.Rack("r0", oversubscription=oversub), t.Rack("r1")),
        bandwidth=BW, loopback_bypass=bypass,
    ).with_placement(tuple(n.name for n in bad))


def make_evaluator(pkg, topo, **kw):
    kw.setdefault("link_policy", "fifo")
    return pkg[1].evaluator_from_templates(
        topo, comm_heavy_steps(pkg, num_ps=topo.num_shards), num_workers=3,
        n_runs=1, steps_per_worker=12, **kw)


def search(pkg, strategy, shards=2, oversub=8.0, bypass=False, ev_kw=None,
           **kw):
    topo = rack_pool_topology(pkg, shards, oversub, bypass)
    with make_evaluator(pkg, topo, **(ev_kw or {})) as ev:
        res = pkg[1].search_placement(ev, strategy, **kw)
        return dataclasses.asdict(res), res.speedup, res.summary(), \
            ev.evaluated


SEARCHES = {
    "exhaustive 1": ("exhaustive", dict(shards=1)),
    "exhaustive 2": ("exhaustive", dict(shards=2)),
    "exhaustive 3 of 4 hosts": ("exhaustive", dict(
        shards=3, hosts=("bad0", "good0", "good1", "w0"))),
    "exhaustive 4 of 3 hosts": ("exhaustive", dict(
        shards=4, hosts=("bad0", "good1", "w0"), max_exhaustive=81)),
    "greedy 1": ("greedy", dict(shards=1)),
    "greedy 2": ("greedy", dict(shards=2)),
    "greedy 3": ("greedy", dict(shards=3)),
    "greedy 4 of 5 hosts": ("greedy", dict(
        shards=4, hosts=("bad0", "bad1", "good0", "good1", "w0"))),
    "greedy uniform, no colocation": ("greedy", dict(oversub=1.0,
                                                     colocation=False)),
    "greedy from a start": ("greedy", dict(start=("w2", "bad1"))),
    "greedy batch waterfill": ("greedy", dict(
        shards=3, ev_kw=dict(waterfill="batch"))),
    "anneal seed 11": ("anneal", dict(seed=11)),
    "anneal seed 5, 3 shards": ("anneal", dict(shards=3, seed=5)),
    "anneal 200 iters": ("anneal", dict(seed=7, anneal_iters=200)),
    "anneal batch waterfill": ("anneal", dict(
        seed=5, ev_kw=dict(waterfill="batch"))),
    "surrogate ps hosts 1": ("surrogate", dict(
        shards=1, hosts=("bad0", "good0"))),
    "surrogate 2": ("surrogate", dict()),
    "surrogate bypass": ("surrogate", dict(bypass=True)),
    "surrogate prune 4": ("surrogate", dict(bypass=True,
                                            surrogate_prune=4)),
}


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_search_results_are_the_references(case, monkeypatch):
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    strategy, kw = SEARCHES[case]
    ref = search(PKGS["ref"], strategy, **kw)
    port = search(PKGS["port"], strategy, **kw)
    assert port == ref
    res = port[0]
    assert res["strategy"] == strategy and res["evaluated"] >= 1
    assert res["throughput"] >= res["baseline_throughput"]


def test_the_planted_optimum_is_found_as_in_the_reference(monkeypatch):
    """On the bypass topology every strategy escapes the 8x-oversubscribed
    default, greedy and the surrogate reach the oracle's throughput, anneal
    is no worse than greedy, and the strategies share one evaluator's
    memo."""
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    out = {}
    for name, pkg in PKGS.items():
        with make_evaluator(pkg, rack_pool_topology(pkg, 2, bypass=True)) \
                as ev:
            res = {s: pkg[1].search_placement(ev, s, seed=3)
                   for s in ("exhaustive", "greedy", "anneal", "surrogate")}
            out[name] = ({s: dataclasses.asdict(r) for s, r in res.items()},
                         ev.evaluated)
    assert out["port"] == out["ref"]
    res, evaluated = out["port"]
    assert evaluated == 7 ** 2
    # symmetric placements tie exactly: greedy and the surrogate reach the
    # oracle's throughput, each through a placement of its own
    assert res["greedy"]["throughput"] == res["exhaustive"]["throughput"] \
        == res["surrogate"]["throughput"]
    assert res["greedy"]["evaluated"] == res["anneal"]["evaluated"] == 0
    assert res["anneal"]["throughput"] >= res["greedy"]["throughput"]
    for r in res.values():
        assert not any(h.startswith("bad") for h in r["placement"])
        assert r["throughput"] > 1.5 * r["baseline_throughput"]


@pytest.mark.parametrize("shards,bypass", [(1, False), (2, False),
                                           (2, True), (3, True)])
def test_surrogate_scores_are_the_references(shards, bypass):
    scores = []
    for pkg in PKGS.values():
        topo = rack_pool_topology(pkg, shards, bypass=bypass)
        ev = make_evaluator(pkg, topo)
        cands = list(np.ndindex(*(len(ev.candidate_hosts()),) * shards))
        hosts = ev.candidate_hosts()
        scores.append(pkg[1].surrogate_scores(
            ev, [tuple(hosts[i] for i in c) for c in cands]))
    assert scores[1].dtype == scores[0].dtype == np.float64
    assert np.array_equal(scores[1], scores[0])
    assert scores[1].shape == (len(hosts) ** shards,)


@pytest.mark.parametrize("strategy", ["greedy", "anneal"])
def test_pooled_search_equals_serial_and_the_reference(strategy,
                                                       monkeypatch):
    pooled = search(PKGS["port"], strategy, seed=5)
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    serial = search(PKGS["port"], strategy, seed=5)
    assert pooled == serial == search(PKGS["ref"], strategy, seed=5)


def test_evaluator_memo_hosts_and_default_are_the_references(monkeypatch):
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    out = []
    for pkg in PKGS.values():
        ev = make_evaluator(pkg, rack_pool_topology(pkg, 1))
        s1 = ev.score(("good0",))
        n = ev.evaluated
        many = ev.score_many([("good0",), ("bad0",), ("good0",), ("w1",)])
        out.append((s1, n, many, ev.evaluated, ev.default_placement(),
                    ev.candidate_hosts(), ev.candidate_hosts(False),
                    ev.num_shards))
    assert out[1] == out[0]
    assert out[1][1] == 1 and out[1][3] == 3 and out[1][2][0] == out[1][0]


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def test_every_value_error_is_the_references(monkeypatch):
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    msgs = []
    for pkg in PKGS.values():
        ps = pkg[1]
        one = make_evaluator(pkg, rack_pool_topology(pkg, 1))
        two = make_evaluator(pkg, rack_pool_topology(pkg, 2))
        run = pkg[3].PredictionRun(dnn="alexnet", batch_size=8,
                                   platform="private_cpu",
                                   sync_mode="allreduce")
        msgs.append([_error(c) for c in (
            lambda: ps.search_placement(one, "ilp"),
            lambda: ps.search_placement(one, "greedy",
                                        hosts=("good0", "nope")),
            lambda: ps.search_placement(one, "greedy",
                                        hosts=("good0", "good0")),
            lambda: ps.search_placement(one, "greedy", hosts=()),
            lambda: two.score(("good0",)),
            lambda: ps.search_placement(two, "greedy",
                                        start=("good0", "zzz")),
            lambda: ps.search_placement(two, "exhaustive",
                                        max_exhaustive=3),
            lambda: ps.search_placement(two, "surrogate", surrogate_cap=3),
            lambda: ps.evaluator_from_run(run, pkg[2].Topology.star(2, 1),
                                          2))])
    assert msgs[1] == msgs[0] and None not in msgs[1]
    assert port_ps.STRATEGIES == ref_ps.STRATEGIES
    assert port_ps.DEFAULT_MAX_EXHAUSTIVE == ref_ps.DEFAULT_MAX_EXHAUSTIVE


def _whatif(pkg, argv, tmp_path, name, monkeypatch, capsys):
    led = tmp_path / f"{name}.jsonl"
    monkeypatch.setenv("REPRO_LEDGER", str(led))
    monkeypatch.setattr("sys.argv", ["whatif"] + argv)
    try:
        pkg[4].main() if name == "ref" else pkg[4].main(argv)
    finally:
        pkg[5].disable()
    recs = [{k: v for k, v in r.items() if k != "ts"}
            for r in pkg[5].read(str(led))]
    return capsys.readouterr().out.splitlines(), recs


WHATIF = {
    "greedy": ["--optimize-placement"],
    "exhaustive": ["--optimize-placement", "exhaustive", "--colocate-ps"],
    "anneal": ["--optimize-placement", "anneal"],
}


@pytest.mark.parametrize("case", sorted(WHATIF))
def test_whatif_optimize_placement_prints_the_references_lines(
        case, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    argv = ["--ps-cluster", "--dnn", "alexnet", "--batch", "16", "--workers",
            "1", "2", "--num-ps", "2", "--oversub", "4", "--profile-steps",
            "10", "--sim-steps", "20"] + WHATIF[case]
    ref = _whatif(PKGS["ref"], argv, tmp_path, "ref", monkeypatch, capsys)
    port = _whatif(PKGS["port"], argv, tmp_path, "port", monkeypatch,
                   capsys)
    assert port == ref
    lines = port[0]
    strategy = WHATIF[case][1] if len(WHATIF[case]) > 1 \
        and not WHATIF[case][1].startswith("--") else "greedy"
    assert lines[-3].startswith(f"# placement search ({strategy}, W=")
    assert lines[-2].startswith("#   default   ")
    assert lines[-1].startswith("#   optimized ")
    assert port[1][-1]["figure"] == "whatif_ps"


def test_whatif_optimize_placement_returns_the_search_result(monkeypatch,
                                                             capsys):
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    out = []
    for pkg in PKGS.values():
        base = pkg[3].PredictionRun(dnn="alexnet", batch_size=16,
                                    platform="private_cpu", profile_steps=10,
                                    sim_steps=20).prepare()
        topo = pkg[4].build_whatif_topology(2, 1, oversub=4.0)
        res = pkg[4].optimize_placement_report(base, topo, 2)
        out.append((dataclasses.asdict(res), capsys.readouterr().out))
    assert out[1] == out[0]
    assert out[1][0]["strategy"] == "greedy"
