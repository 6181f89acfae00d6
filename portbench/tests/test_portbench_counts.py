"""The yardstick's counts against hand counts, and the per-layer readers
on a trace built by hand."""
import json

import pytest

from portbench import counts, spec
from portbench.harness import Context
from portbench.trace import Trace

ROOT = spec.ROOT


def model(name: str, **changes):
    m = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                   .read_text())["model"]
    return dict(m, **changes)


PHI16 = model("phi4-mini-3.8b-16l")
PHI32 = model("phi4-mini-3.8b-16l", n_layers=32)
DS4 = model("deepseek-moe-16b-4l")

# by hand: phi4-mini's attention (q, k, v, o) and SwiGLU matrices a layer
PHI_LAYER = 3072 * 24 * 128 * 2 + 3072 * 8 * 128 * 2 + 3 * 3072 * 8192
PHI_HEAD = 3072 * 200064
# deepseek-moe-16b: attention, router, 6 routed + 2 shared experts a layer
DS_LAYER = 4 * 2048 * 16 * 128 + 2048 * 64 + 8 * 3 * 2048 * 1408
DS_HEAD = 2048 * 102400


@pytest.mark.parametrize("m, layers, per_layer, head", [
    (PHI16, 16, PHI_LAYER, PHI_HEAD), (PHI32, 32, PHI_LAYER, PHI_HEAD),
    (DS4, 4, DS_LAYER, DS_HEAD)], ids=["phi4-16l", "phi4-32l", "ds-4l"])
def test_matmul_params(m, layers, per_layer, head):
    assert counts.matmul_params_per_token(m) == layers * per_layer + head


# cells 1-4: (model, global batch, seq, chips, heads of attention a layer)
CELLS = {"1 phi4-16l train-4k": (PHI16, 4, 4096, 1, 16),
         "2 deepseek-4l train-4k": (DS4, 4, 4096, 1, 4),
         "3 phi4-32l train-4k dp2tp2": (PHI32, 16, 4096, 4, 32),
         "4 phi4-16l train-1k": (PHI16, 16, 1024, 1, 16)}


@pytest.mark.parametrize("cell", CELLS)
def test_model_flops(cell):
    m, b, s, _, layers = CELLS[cell]
    nmm = counts.matmul_params_per_token(m)
    attention = 6 * layers * s * m["n_heads"] * 128 * b * s
    assert counts.model_flops_train(m, b, s) == 6 * nmm * b * s + attention


def test_model_flops_cell_1_by_number():
    assert counts.model_flops_train(PHI16, 4, 4096) == pytest.approx(
        2.3854e14, rel=1e-4)
    assert counts.model_flops_train(DS4, 4, 4096) == pytest.approx(
        5.7776e13, rel=1e-4)


@pytest.mark.parametrize("cell", CELLS)
def test_attention_work(cell):
    m, b, s, chips, _ = CELLS[cell]
    # a rank's share: the batch over the data axis on the mesh
    b_rank = b // (2 if chips == 4 else 1)
    h, kv = m["n_heads"], m["n_kv"]
    fwd = counts.flash_fwd_work(m, b_rank, s)
    assert fwd["flops"] == 2 * b_rank * h * s * s * 128
    assert fwd["bytes"] == 2 * (2 * b_rank * s * h * 128
                                + 2 * b_rank * s * kv * 128)
    bwd = counts.attn_bwd_work(m, b_rank, s)
    assert bwd["flops"] == 2.5 * fwd["flops"]
    assert bwd["bytes"] == 2 * (4 * b_rank * s * h * 128
                                + 4 * b_rank * s * kv * 128)
    # causal attention at these lengths is bound by its products
    assert counts.min_seconds(fwd) == fwd["flops"] / 989e12


def test_adamw_bytes():
    w = counts.adamw_work(2_840_693_760)
    assert w["bytes"] == 28 * 2_840_693_760
    assert counts.min_seconds(w) == pytest.approx(28 * 2_840_693_760
                                                  / 3.35e12)


def hand_trace():
    """Two traced steps of 100 ms: in each a flash forward (a 2 ms
    kernel), its backward node (6 ms of two kernels), the optimizer span
    (a 10 ms kernel), a data span, and 40 ms of other kernels; the device
    idle for the rest."""
    tr = Trace()
    corr = 0
    for step, t0 in enumerate((1_000.0, 101_000.0)):
        tr.host.append((t0, t0 + 100_000, f"ProfilerStep#{step + 1}", 1))
        tr.host.append((t0, t0 + 1_000, "portbench::data", 1))

        def launch(at, kernel_at, dur, name, tid=1):
            nonlocal corr
            corr += 1
            tr.launches[corr] = (at, tid)
            tr.device.append((kernel_at, kernel_at + dur, name, corr, 0))

        tr.host.append((t0 + 2_000, t0 + 3_000,
                        "repro_torch::flash_attention_fwd", 1))
        launch(t0 + 2_500, t0 + 3_000, 2_000, "attn_fwd_tc")
        launch(t0 + 4_000, t0 + 5_000, 40_000, "gemm")
        node = "autograd::engine::evaluate_function: _FlashAttentionBackward"
        tr.host.append((t0 + 50_000, t0 + 52_000, node, 2))
        launch(t0 + 50_500, t0 + 52_000, 4_000, "bmm", tid=2)
        launch(t0 + 51_500, t0 + 56_000, 2_000, "softmax_bwd", tid=2)
        tr.host.append((t0 + 60_000, t0 + 61_000,
                        "portbench::optimizer_update", 1))
        launch(t0 + 60_100, t0 + 62_000, 10_000, "adam")
    return tr


def test_trace_reduction():
    tr = hand_trace()
    assert tr.steps() == 2 and tr.window_s() == pytest.approx(0.2)
    # busy: 2 + 40 + 4 + 2 + 10 ms a step
    assert tr.busy_s() == pytest.approx(0.116)
    assert tr.under({"repro_torch::flash_attention_fwd"}) == pytest.approx(
        0.004)
    assert tr.top_ops(2) == [["gemm", pytest.approx(0.08)],
                             ["adam", pytest.approx(0.02)]]
    gaps = dict(tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(0.2 - 0.116)


def test_readers_on_the_hand_trace():
    tr = hand_trace()
    m, b, s = PHI16, 4, 4096
    ctx = Context(m, b, s, 1, 2_840_693_760, [0], tr, [0.001, 0.003])
    read = {n: spec.metric_reader(n)(ctx) for n in (
        "data_ms", "idle_share", "step_mfu", "flash_fwd_roofline",
        "attn_bwd_roofline", "adamw_roofline", "comm_exposed_share")}
    assert read["data_ms"] == pytest.approx(2.0)
    assert read["idle_share"] == pytest.approx(100 * (1 - 0.116 / 0.2))
    flops = counts.model_flops_train(m, b, s)
    assert read["step_mfu"] == pytest.approx(100 * 2 * flops
                                             / (0.2 * 989e12))
    fwd = counts.min_seconds(counts.flash_fwd_work(m, b, s))
    assert read["flash_fwd_roofline"] == pytest.approx(100 * 2 * fwd / 0.004)
    bwd = counts.min_seconds(counts.attn_bwd_work(m, b, s))
    assert read["attn_bwd_roofline"] == pytest.approx(100 * 2 * bwd / 0.012)
    opt = counts.min_seconds(counts.adamw_work(2_840_693_760))
    assert read["adamw_roofline"] == pytest.approx(100 * 2 * opt / 0.020)
    assert read["comm_exposed_share"] is None


def test_comm_exposed_share():
    tr = Trace()
    tr.host.append((0.0, 1_000.0, "ProfilerStep#1", 1))
    tr.device += [(0.0, 300.0, "gemm", 1, 0),
                  (200.0, 500.0, "ncclDevKernel_AllReduce", 2, 0),
                  (100.0, 150.0, "ncclDevKernel_AllGather", 3, 1)]
    ctx = Context(PHI32, 16, 4096, 4, 1, [0, 1], tr)
    # card 0: NCCL alone from 300 to 500 us of 1000; card 1: 50 us
    assert spec.metric_reader("comm_exposed_share")(ctx) == pytest.approx(20)


def test_no_reader_reports_a_number_without_a_trace():
    ctx = Context(PHI16, 4, 4096, 1, 1, [0])
    for m in spec.load_benchmark()["per_layer"]:
        if m["name"] != "data_ms":
            assert spec.metric_reader(m["name"])(ctx) is None
