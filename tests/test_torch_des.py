"""The port's copy of the DES against the reference's.

``repro_torch.core`` copies the simulator and everything it imports from
``repro.core`` (events, bandwidth, fluidlink, schedulers, collectives,
topology, syncmode, faults, the metrics registry).  The same Python on the
same floats and the same ``random.Random`` draws gives the same answer, so
every comparison here is exact: the same step completions and the same
trace records, field for field.  Random step DAGs are built with each
package's own ``Op``/``StepTemplate``, as in ``test_engine_equivalence``.
"""
import json
import math
import random

import numpy as np
import pytest
import torch

from repro.core import bandwidth as ref_bw
from repro.core import events as ref_events
from repro.core import faults as ref_faults
from repro.core import simulator as ref_sim
from repro.core import syncmode as ref_sync
from repro_torch.core import bandwidth as port_bw
from repro_torch.core import events as port_events
from repro_torch.core import faults as port_faults
from repro_torch.core import simulator as port_sim
from repro_torch.core import syncmode as port_sync
from repro_torch.core.sweep import parallel_map

BW = 1e8
REF = (ref_events, ref_bw, ref_sim)
PORT = (port_events, port_bw, port_sim)


def make_steps(events, seed, num_ps, n_ops=10, n_tpl=3):
    """Random DAG-structured steps over the PS resource set, built with one
    package's ``Op`` and ``StepTemplate`` (the draws do not depend on it)."""
    rng = random.Random(1234 + seed)
    if num_ps == 1:
        links = ["downlink", "uplink"]
    else:
        links = [f"{d}:{p}" for d in ("downlink", "uplink")
                 for p in range(num_ps)]
    tpls = []
    for _ in range(n_tpl):
        ops = []
        for i in range(n_ops):
            deps = tuple(sorted(rng.sample(range(i),
                                           min(i, rng.randrange(0, 3)))))
            if rng.random() < 0.4:
                ops.append(events.Op(f"c{i}", "worker",
                                     duration=rng.uniform(0.01, 0.3),
                                     deps=deps))
            else:
                res = links[rng.randrange(len(links))]
                ops.append(events.Op(f"l{i}", res,
                                     size=rng.uniform(1e5, 5e7), deps=deps))
        tpls.append(events.StepTemplate(ops=ops))
    return tpls


def run(pkg, seed, policy, num_ps, workers=3, **extra):
    events, bw, sim = pkg
    kw = dict(resources=events.ps_resources(BW, num_ps), link_policy=policy,
              win=2.8e6, steps_per_worker=20, warmup_steps=5, seed=seed,
              record_trace=True, record_op_times=True, service_jitter=0.12,
              stall_alpha=2e-9, stall_rtt=1e-3, **extra)
    if num_ps > 1:
        kw["bandwidth_model"] = bw.BandwidthModel()
    tpls = make_steps(events, seed, num_ps)
    return sim.Simulation(sim.SimConfig(**kw)).run(tpls, workers)


def records(trace):
    return [(r.worker, r.res, r.name, r.step_seq, r.start, r.end)
            for r in trace.records]


def assert_identical(port, ref):
    assert port.step_completions == ref.step_completions
    assert records(port) == records(ref)
    assert port.staleness == ref.staleness
    assert port.incidents == ref.incidents
    assert len(port.step_completions) > 0


@pytest.mark.parametrize("num_ps", [1, 2])
@pytest.mark.parametrize("policy", ["http2", "fifo", "ordered"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_des_matches_reference_exactly(seed, policy, num_ps):
    assert_identical(run(PORT, seed, policy, num_ps),
                     run(REF, seed, policy, num_ps))


def test_des_with_faults_matches_reference_exactly():
    def spec(faults):
        return faults.FaultSpec(mttf=1.5, mttr=0.5, fault_seed=2,
                                horizon=1e4)
    port = run(PORT, 3, "http2", 2, workers=4,
               faults=spec(port_faults))
    ref = run(REF, 3, "http2", 2, workers=4, faults=spec(ref_faults))
    assert_identical(port, ref)
    assert ref.incidents                     # the spec did inject faults


def test_des_sync_mode_matches_reference_exactly():
    """``SimConfig(sync_mode="sync")`` runs under ``SyncSpec("sync")``."""
    assert vars(port_sync.SyncSpec("sync")) == vars(ref_sync.SyncSpec("sync"))
    port = run(PORT, 1, "fifo", 1, workers=4, sync_mode="sync")
    ref = run(REF, 1, "fifo", 1, workers=4, sync_mode="sync")
    assert_identical(port, ref)
    assert ref.meta["sync_mode"] == "sync"


# ------------------------------------------------------- batched waterfill


def _models(bw):
    """The reference tests' star and grouped structures, in one package."""
    links = [f"{d}:{p}" for d in ("downlink", "uplink") for p in range(2)]
    star = (bw.BandwidthModel(), [(w, r) for w in range(6) for r in links])
    grouped = (bw.GroupedBandwidthModel(
        link_caps={"downlink:0": 2.0, "uplink:1": 0.5},
        worker_caps={0: 0.5, 3: 2.0},
        extra_groups=[
            ("fabric", 1.5, frozenset({"downlink:0", "downlink:1"})),
            ("pair", 0.8, frozenset({(1, "uplink:0"), (2, "uplink:0")})),
        ]), [(w, r) for w in range(5) for r in links])
    return [star, grouped]


def _problems(bw, seed, n):
    rng = random.Random(seed)
    out = []
    for model, universe in _models(bw):
        for _ in range(n):
            k = rng.randrange(1, len(universe) + 1)
            conns = sorted(rng.sample(list(universe), k))
            out.append((conns, *model.groups_for(conns)))
    return out


def test_stacked_problems_match_reference():
    port = port_bw.stack_waterfill_problems(_problems(port_bw, 7, 6))
    ref = ref_bw.stack_waterfill_problems(_problems(ref_bw, 7, 6))
    assert port[0] == ref[0]
    for a, b in zip(port[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)


def test_torch_waterfill_on_cpu_matches_reference_numpy():
    """The torch backend against ``repro``'s numpy backend at the
    reference's own tolerance for its accelerator backend (rtol 2e-4,
    ``test_batched_waterfill.py``); float64 gives far less."""
    _, caps, members, weights = ref_bw.stack_waterfill_problems(
        _problems(ref_bw, 11, 40))
    want = ref_bw.batched_waterfill(caps, members, weights)
    got = port_bw.batched_waterfill(caps, members, weights,
                                    backend="torch", device="cpu")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-12)
    assert np.abs(got - want).max() < 1e-12


def test_torch_waterfill_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="unknown backend"):
        port_bw.batched_waterfill(np.ones((1, 1)), np.ones((1, 1, 2), bool),
                                  backend="jax")
    with pytest.raises(ValueError, match="shape mismatch"):
        port_bw.batched_waterfill(np.ones((2, 1)), np.ones((1, 1, 2), bool),
                                  backend="torch", device="cpu")
    with pytest.raises(ValueError, match="weights shape"):
        port_bw.batched_waterfill(np.ones((1, 1)), np.ones((1, 1, 2), bool),
                                  np.ones((1, 3)), backend="torch",
                                  device="cpu")


# ------------------------------------------------ sweep, trace export


def _square(x):
    return x * x


def test_parallel_map_serial_equals_parallel(monkeypatch):
    items = list(range(5))
    parallel = parallel_map(_square, items, max_workers=2)
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    assert parallel_map(_square, items, max_workers=2) == parallel \
        == [x * x for x in items]


def test_trace_to_chrome_trace_is_the_references():
    """``Trace.to_chrome_trace`` delegates to the ported exporter
    (``repro_torch.obs.trace_export``): the reference's dict, with and
    without the run's templates."""
    port, ref = run(PORT, 0, "fifo", 2), run(REF, 0, "fifo", 2)
    assert port.to_chrome_trace() == ref.to_chrome_trace()
    doc = port.to_chrome_trace(templates=make_steps(port_events, 0, 2),
                               trace_name="port")
    assert doc == ref.to_chrome_trace(templates=make_steps(ref_events, 0, 2),
                                      trace_name="port")
    assert {e["cat"] for e in doc["traceEvents"] if e["ph"] == "X"} \
        == {"compute", "transmission"}


def test_checkpoint_cost_model_calibrates_on_the_ports_manager(tmp_path,
                                                               monkeypatch):
    """The reference's fit over timed restores of the port's checkpoints:
    non-negative finite terms, one checkpoint a size in the reference's
    layout; the card unless the caller asks for the CPU."""
    model = port_faults.CheckpointCostModel.calibrate(
        str(tmp_path), sizes=(1 << 10, 1 << 14, 1 << 16), device="cpu")
    assert math.isfinite(model.alpha) and model.alpha >= 0
    assert math.isfinite(model.beta) and model.beta >= 0
    for j, n in enumerate((1 << 10, 1 << 14, 1 << 16)):
        with open(tmp_path / f"cal_{j}" / "step_00000000" /
                  "manifest.json") as f:
            assert json.load(f)["leaves"] == [
                {"index": 0, "dtype": "float32", "shape": [n]}]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_faults.CheckpointCostModel.calibrate(str(tmp_path / "card"))
