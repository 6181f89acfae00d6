"""The readers of the program's own spans and counters (``moe_ms``,
``moe_idle_ms``, ``head_ms``, ``moe_dropped_pct``) on a hand-built Chrome
trace: two steps on the main thread (tid 1), the MoE's and the head's
spans there and on two other threads, nested and overlapping, one running
past the window, kernels launched inside and outside them, and idle gaps
inside and outside the MoE's spans. Every value is worked by hand below
(microseconds in the trace, ms read)."""
import json

import pytest
import torch

from portbench import harness, spec
from portbench import trace as trace_mod
from repro_torch.obs import metrics

STEPS = [(0, 1000, "ProfilerStep#1", 1), (1000, 2000, "ProfilerStep#2", 1)]
SPANS = [
    (100, 300, "repro_torch::moe", 1),          # the forward
    (110, 150, "repro_torch::moe.route", 1),
    (200, 350, "repro_torch::moe", 3),          # overlaps tid 1's
    (1200, 1600, "repro_torch::moe", 2),        # a backward range ...
    (1250, 1300, "repro_torch::moe", 2),        # ... and one nested in it
    (1900, 2100, "repro_torch::moe", 2),        # runs past the window
    (1700, 1800, "repro_torch::head", 1),
    (1850, 1950, "repro_torch::head", 2),
]
# correlation: (launch ts, launch thread, kernel start, kernel end)
KERNELS = {
    1: (120, 1, 150, 250),      # in tid 1's MoE span: 100
    2: (400, 1, 400, 500),      # in no span
    3: (1260, 2, 1260, 1400),   # in both nested MoE spans: 140, once
    4: (1300, 1, 1400, 1500),   # tid 1 is in no span at 1300
    5: (1710, 1, 1750, 1900),   # head: 150
    6: (1860, 2, 1900, 1950),   # head: 50
    7: (340, 3, 350, 380),      # in tid 3's MoE span: 30
}
# moe_ms: (100 + 140 + 30) / 2 steps; head_ms: (150 + 50) / 2
MOE_MS, HEAD_MS = 0.135, 0.1
# the MoE's spans in the window: [100, 350], [1200, 1600], [1900, 2000];
# busy there: [150, 250]; [1260, 1500]; [1900, 1950]; idle 150 + 160 + 50
# over 2 steps
MOE_IDLE_MS = 0.18


def chrome(spans, kernels):
    events = [{"ph": "X", "cat": "user_annotation" if "::" in n
               else "cpu_op", "name": n, "ts": a, "dur": b - a, "tid": t,
               "pid": 1} for a, b, n, t in spans]
    for corr, (ts, tid, k0, k1) in kernels.items():
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": ts, "dur": 5,
                       "tid": tid, "pid": 1, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                       "ts": k0, "dur": k1 - k0, "tid": 7, "pid": 0,
                       "args": {"correlation": corr, "device": 0}})
    return {"traceEvents": events}


def context(tmp_path, spans=SPANS, kernels=KERNELS):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(chrome(STEPS + spans, kernels)))
    ctx = harness.Context({}, 4, 4096, 1, 1, [0])
    ctx.trace = trace_mod.load(path)
    return ctx


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


@pytest.mark.parametrize("name, want", [("moe_ms", MOE_MS),
                                        ("head_ms", HEAD_MS),
                                        ("moe_idle_ms", MOE_IDLE_MS)])
def test_span_readers_worked_by_hand(tmp_path, name, want):
    assert read(name, context(tmp_path)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["moe_ms", "head_ms", "moe_idle_ms",
                                  "moe_dropped_pct"])
def test_nothing_to_read_without_the_programs_names(tmp_path, name):
    """A program without the spans (the parent's) or an untraced run gives
    no number; phi4's cells have no MoE span."""
    metrics.reset()
    bare = context(tmp_path, spans=[], kernels=KERNELS)
    assert read(name, bare) is None
    assert read(name, harness.Context({}, 4, 4096, 1, 1, [0])) is None


def test_no_moe_span_in_a_dense_trace(tmp_path):
    dense = context(tmp_path, spans=[s for s in SPANS if "moe" not in s[2]])
    assert read("moe_ms", dense) is None
    assert read("moe_idle_ms", dense) is None
    assert read("head_ms", dense) == pytest.approx(HEAD_MS, rel=1e-12)


def test_moe_dropped_pct_reads_the_counters(tmp_path):
    ctx = context(tmp_path)
    metrics.reset()
    try:
        with metrics.collecting():
            metrics.add("moe.routed", torch.tensor(600))
            metrics.add("moe.dropped", torch.tensor(50))
            metrics.add("moe.routed", torch.tensor(400))
            metrics.add("moe.dropped", torch.tensor(75))
        assert read("moe_dropped_pct", ctx) == pytest.approx(12.5)
    finally:
        metrics.reset()
