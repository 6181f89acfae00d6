"""The check at a size the CPU holds: the plain reference against the
port's training step, the control (fp8 weight products) and the faults
that each cell can have failing the cells' limits, and the whole run's
``correct`` coming out false with the timed path broken underneath.

The tiny cells keep each cell's traffic settings and kinds of blocks;
widths, depth and lengths shrink (S = 256, the least the port's flash
path takes), and so do the limits, which are set for this size from the
CPU's readings as the cells' are from the card's (``TINY_LIMITS``)."""
import copy

import pytest

from portbench import check, harness, reference, spec
from portbench.reference.model import Precision

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2**31 + 11


# Read on the CPU at the tiny size, 23 seeds of the sound runs and 6 of the
# fp8 control and the half-batch fault a cell: the sound runs' largest
# loss, gradient and change gaps 2.83e-4, 1.70e-3, 2.22e-3 (deepseek's; its
# 8 experts' routing flips move the router's and the experts' change); the
# control's least 8.35e-4, 1.19e-2, 3.39e-3; the fault's least 5.99e-3,
# 1.01e-1, 1.07e-1. At this size only the gradient separates the control
# (7x), so the loss and the change limits stand above the sound runs.
TINY_LIMITS = {"loss_gap": {"limit": 1e-3}, "grad_gap": {"limit": 5e-3},
               "change_gap": {"limit": 1e-2}}


def tiny(workload: str) -> spec.Cell:
    cell = copy.deepcopy(spec.load_cell(workload))
    m = cell.config["model"]
    m.update(n_layers=2, d_model=64, n_heads=4, head_dim=16, d_ff=128,
             vocab=300, n_kv=4 if m["moe"] else 2)
    if m["moe"]:
        m["moe"].update(num_experts=8, top_k=2, num_shared=1, d_expert=32,
                        group_size=128)
    cell.traffic.update(batch=4, seq=256, reference_rows=2)
    cell.limits = copy.deepcopy(TINY_LIMITS)
    return cell


def readings(cell, seed=SEED, fault=None):
    prog, got, batches, _, _ = harness.setup(cell, seed, "cpu", fault)
    del prog
    return got, batches


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(workload):
    cell = tiny(workload)
    got, batches = readings(cell)
    want = reference.follow(cell.config["model"], SEED, batches,
                            harness.hyper(cell.traffic), "cpu",
                            rows=cell.traffic["reference_rows"])
    nums = check.numbers(got, want)
    assert check.judge(nums, cell.limits)[0], nums
    # the losses are the model's, not a shared constant
    assert abs(want["losses"][0] - want["losses"][2]) > 1e-4


@pytest.mark.parametrize("workload", CELLS)
def test_row_blocks_do_not_change_the_reference(workload):
    cell = tiny(workload)
    _, batches = readings(cell)
    hp = harness.hyper(cell.traffic)
    one = reference.follow(cell.config["model"], SEED, batches[:1], hp,
                           "cpu", rows=1)
    whole = reference.follow(cell.config["model"], SEED, batches[:1], hp,
                             "cpu", rows=4)
    assert one["losses"][0] == pytest.approx(whole["losses"][0], rel=1e-6)
    for k, v in whole["grad_norms"].items():
        # each block's bf16 weight-gradient products round on their own
        assert one["grad_norms"][k] == pytest.approx(v, rel=2e-3, abs=1e-9)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    """The reference in fp8 weight products, put in the program's place,
    is not correct under the cell's limits."""
    cell = tiny(workload)
    _, batches = readings(cell)
    hp, rows = harness.hyper(cell.traffic), cell.traffic["reference_rows"]
    want = reference.follow(cell.config["model"], SEED, batches, hp, "cpu",
                            rows=rows)
    control = reference.follow(cell.config["model"], SEED, batches, hp,
                               "cpu", prec=Precision(fp8=True), rows=rows)
    nums = check.numbers(control, want)
    assert not check.judge(nums, cell.limits)[0], nums


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_step_is_not_correct(workload, fault):
    """A whole run, the look for a card skipped, with the training step
    broken underneath: its state left unchanged, or half of each batch
    left out (the mean over the rest). ``correct`` comes out false; a
    sound run's comes out true."""
    cell = tiny(workload)
    result = harness.run(cell, SEED, 0.2, False, device="cpu", fault=fault)
    assert result["correct"] is False
    assert list(result)[-2:] == ["check", "stderr"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    cell = tiny(workload)
    result = harness.run(cell, SEED + 1, 0.2, False, device="cpu")
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"tokens_per_s", "peak_mem_gb",
                                      "setup_s"}


def test_traced_run_on_the_cpu():
    """The traced path end to end: the profiled steps, the trace's
    reduction and every reader run; off a card the device readers find
    nothing to read and leave their metrics out."""
    cell = tiny(CELLS[0])
    result = harness.run(cell, SEED + 2, 0.2, True, device="cpu")
    assert result["correct"] is True
    assert "data_ms" in result["metrics"]
    for name in ("idle_share", "flash_fwd_roofline", "attn_bwd_roofline",
                 "adamw_roofline"):
        assert name not in result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0
