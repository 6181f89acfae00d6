"""What the port's sharded step holds on a rank, on the CPU.

* The sharding layer's ordered ``redistribute`` on a (2, 2) ("data",
  "model") mesh over a fake process group, forward and backward, for the
  moves the model makes: the peak of live local bytes is at most the
  source's local bytes plus twice the target's (a gather on a dim other
  than 0 holds its buffer and its ``cat``) and below the global tensor's
  bytes wherever the move's output is not whole.
* The same moves on 4 real ``gloo`` ranks: output and gradient
  ``torch.equal`` to DTensor's one-call ``redistribute``; and the
  batch-local embedding's output and table gradient ``torch.equal`` to
  ``F.embedding`` on the whole tensors.
* arctic-480b cut to one layer at ``train_4k`` on 16 x 16 (256 fake
  ranks, fake CPU tensors): the peak, FLOPs and the largest tensors live at
  the peak (``peak_tensors``), which the dry-run's record carries.
* phi4-mini-3.8b and starcoder2-7b cut to 2 layers at ``train_4k`` on
  16 x 16: each remat group saves 1/16 of its input, as XLA's compile of
  the reference does; the live bytes at the forward's end, the peak, the
  FLOPs and the all-gather wire bytes against the whole saves'.
* The embedding on a (2, 2) mesh: each rank's output holds its own batch
  rows, and no tensor of the global batch's shape is built.
"""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor import placement_types

from repro_torch.configs import SHAPES, get_config, get_optimizer_name
from repro_torch.core import flop_count as fc
from repro_torch.launch import dryrun, make_debug_mesh
from repro_torch.models import transformer as tt
from repro_torch.parallel import sharding as sh

R, P, S0, S1, S2 = Replicate(), Partial(), Shard(0), Shard(1), Shard(2)
SHAPE = (8, 8, 4, 16)        # fp32
TIMEOUT_S = 240

# (source, target) placements on the (data, model) mesh
MOVES = {
    # the MoE's dispatched tokens, groups over data to experts over model
    "moe_dispatch": ((S0, R), (R, S1)),
    # the residual after an embedding over the table's fsdp dim
    "embedding": ((S2, R), (S0, R)),
    "swap": ((S0, S1), (S1, S0)),
    # a pending sum reduced where the target shards
    "partial": ((P, R), (S0, S1)),
    # one tensor dim over both mesh dims
    "two_axes": ((R, S1), (S0, S0)),
    # a slice under a shard of the same dim on the later mesh dim
    "nested": ((R, S0), (S0, S0)),
}


def _local_bytes(placements, mesh_shape=(2, 2)) -> int:
    n = int(np.prod(SHAPE))
    for p, size in zip(placements, mesh_shape):
        n //= size if isinstance(p, Shard) else 1
    return 4 * n


def _dtensor(mesh, placements, seed: int, requires_grad=False) -> DTensor:
    """A DTensor of ``SHAPE``: its local shard from ``seed`` (a pending
    sum's whole-shape addend from the rank's coordinate on that mesh dim)."""
    gen = np.random.default_rng(seed)
    whole = torch.from_numpy(gen.standard_normal(SHAPE, dtype=np.float32))
    if any(p.is_partial() for p in placements):
        m = [p.is_partial() for p in placements].index(True)
        whole = whole + mesh.get_coordinate()[m]
        x = DTensor.from_local(whole, mesh, placements, run_check=False)
    else:
        x = distribute_tensor(whole, mesh, placements)
    return x.requires_grad_(requires_grad)


def _alltoall_as_on_the_card(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's all-to-all as it runs on a CUDA group: the collective op
    itself. On a CPU mesh DTensor gathers the whole dim and cuts it
    instead (gloo has no all-to-all), which no card does; the fake group
    accepts the op and moves nothing."""
    import torch.distributed._functional_collectives as funcol
    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, funcol._group_or_group_name(group))


@pytest.fixture
def fake_mesh():
    with dryrun.fake_process_group(4):
        yield make_debug_mesh((2, 2), device_type="cpu")


@pytest.mark.parametrize("name", sorted(MOVES))
def test_redistribute_peak_stays_within_its_ends(name, fake_mesh,
                                                 monkeypatch):
    monkeypatch.setattr(placement_types, "shard_dim_alltoall",
                        _alltoall_as_on_the_card)
    src, dst = MOVES[name]
    whole = 4 * int(np.prod(SHAPE))
    x = _dtensor(fake_mesh, src, 0, requires_grad=True)
    fwd = fc.count_device(lambda: sh.redistribute(x, dst))
    y = sh.redistribute(x, dst)
    assert tuple(y.placements) == dst
    g = _dtensor(fake_mesh, dst, 1)
    bwd = fc.count_device(lambda: torch.autograd.grad(y, x, g))
    back = tuple(R if p.is_partial() else p for p in src)
    for c, a, b in ((fwd, src, dst), (bwd, dst, back)):
        peak, into, out = c.peak_bytes, _local_bytes(a), _local_bytes(b)
        assert 0 < peak <= into + 2 * out, (name, a, b, peak, into, out)
        if out < whole:
            assert all(t["bytes"] < whole for t in c.peak_tensors)
            # (S0, S0) -> (R, S0) ends in an all-to-all of one half of the
            # tensor into the other: its input and output make the whole
            # tensor's bytes, and no other step can end there
            assert peak < whole or (name, b) == ("nested", back), (
                name, a, b, peak)


def test_redistribution_plan_keeps_the_mesh_order():
    """Each step of a plan moves one mesh dim; a shard nested under a
    later mesh dim's shard of the same tensor dim moves to a spare dim
    first, and with none the move is DTensor's own."""
    plan = sh.redistribution_plan
    assert plan((S0, R), (R, S1), SHAPE, (2, 2)) == [(S0, S1), (R, S1)]
    assert plan((P, R), (S0, S1), SHAPE, (2, 2)) == [(P, S1), (S0, S1)]
    assert plan((R, S0), (S0, S0), SHAPE, (2, 2)) == [
        (R, S1), (S0, S1), (S0, S0)]
    assert plan((S0, S0), (S1, S0), (8, 8), (2, 2)) == [(S1, S0)]
    assert plan((S0, S1), (S0, S1), SHAPE, (2, 2)) == []
    for src, dst in MOVES.values():
        steps = plan(src, dst, SHAPE, (2, 2))
        assert steps[-1] == dst
        for a, b in zip([src] + steps, steps):
            assert sum(p != q for p, q in zip(a, b)) == 1


# ---------------------------------------------------------------------------
# 4 gloo ranks: the helper against DTensor's one call, the embedding
# against F.embedding
# ---------------------------------------------------------------------------

VOCAB, B, S, D = 16, 4, 8, 12


def _rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    found = {}
    try:
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        for name, (src, dst) in MOVES.items():
            x = _dtensor(mesh, src, 0, requires_grad=True)
            g = _dtensor(mesh, dst, 1)
            ours = sh.redistribute(x, dst)
            theirs = x.redistribute(mesh, dst)
            gx = torch.autograd.grad(ours, x, g)[0]
            gy = torch.autograd.grad(theirs, x, g)[0]
            found[name] = (torch.equal(ours.to_local(), theirs.to_local())
                           and ours.placements == theirs.placements
                           and torch.equal(gx.to_local(), gy.to_local())
                           and gx.placements == gy.placements)
        gen = np.random.default_rng(2)
        ids = torch.from_numpy(gen.integers(0, VOCAB, (B, S)))
        table = torch.from_numpy(gen.standard_normal((VOCAB, D),
                                                     dtype=np.float32))
        cot = torch.from_numpy(gen.standard_normal((B, S, D),
                                                   dtype=np.float32))
        w = table.clone().requires_grad_()
        want = F.embedding(ids, w)
        (want_grad,) = torch.autograd.grad(want, w, cot)
        wt = distribute_tensor(table, mesh, [S1, S0]).requires_grad_()
        got = sh.reduce_partials(tt._embed_on_shards(
            distribute_tensor(ids, mesh, [S0, R]), wt))
        (got_grad,) = torch.autograd.grad(
            got, wt, distribute_tensor(cot, mesh, [S0, R]))
        found["embedding_placements"] = (
            tuple(got.placements) == (S0, R)
            and tuple(got_grad.placements) == (S1, S0))
        found["embedding_out"] = got.full_tensor().detach().numpy()
        found["embedding_want"] = want.detach().numpy()
        found["embedding_grad"] = got_grad.full_tensor().numpy()
        found["embedding_want_grad"] = want_grad.numpy()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(d, f"rank{rank}.npz"), **found)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """What each of 4 gloo ranks found, by case: True where equal."""
    d = str(tmp_path_factory.mktemp("footprint"))
    ctx = torch.multiprocessing.spawn(_rank_main, args=(4, d), nprocs=4,
                                      join=False)
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks took over {TIMEOUT_S} s")
    return [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(4)]


@pytest.mark.parametrize("name", sorted(MOVES))
def test_equal_to_the_one_call_on_gloo_ranks(name, gloo):
    assert all(bool(rank[name]) for rank in gloo)


def test_embedding_on_gloo_ranks_is_the_whole_lookup(gloo):
    """Each rank's rows in its vocab shard: the output equal to
    ``F.embedding`` on the whole tensors (one nonzero term a row), the
    table's gradient within 1e-6 of it (the two batch halves are summed
    apart, then reduced), in the table's own placements."""
    for rank in gloo:
        assert bool(rank["embedding_placements"])
        np.testing.assert_array_equal(rank["embedding_out"],
                                      rank["embedding_want"])
        np.testing.assert_allclose(rank["embedding_grad"],
                                   rank["embedding_want_grad"],
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Production sizes on fake tensors
# ---------------------------------------------------------------------------

GIB = 2**30
# arctic-480b cut to one layer at ``train_4k`` on 16 x 16, on fake CPU
# tensors: FLOPs a device, the same before and after the moves were ordered
# (3.9159e+13 while every rank computed every expert's dispatch, combine
# and router products; 3.1944e+13 with the rank's experts' alone, while
# its k and v products ran whole over ``model`` and the flash op's backward
# formed the output product; XLA's placement of those since; 2.6292e+13
# while the remat replay ran the combine again)
ONE_LAYER_FLOPS = "2.6141e+13"


@pytest.fixture(scope="module")
def arctic_one_layer():
    cfg = get_config("arctic-480b").replace(n_layers=1,
                                            use_flash_kernel=True)
    with dryrun.fake_process_group(256):
        mesh = dryrun.make_production_mesh(device_type="cpu")
        return dryrun.trace_step(cfg, SHAPES["train_4k"], mesh,
                                 get_optimizer_name("arctic-480b"))


def test_one_arctic_layer_peaks_under_32_gib(arctic_one_layer):
    c = arctic_one_layer["counts"]
    print(f"\narctic-480b, 1 layer, train_4k 16x16: peak "
          f"{c.peak_bytes / GIB:.2f} GiB, FLOPs {c.flops:.4e}; largest live "
          f"at the peak: {c.peak_tensors}")
    assert f"{c.flops:.4e}" == ONE_LAYER_FLOPS
    assert c.peak_bytes <= 32 * GIB


def test_no_tensor_at_the_peak_of_2_5_gib(arctic_one_layer):
    tops = arctic_one_layer["counts"].peak_tensors
    assert len(tops) == fc.PEAK_TENSORS
    assert all(t["bytes"] < 2.5 * GIB for t in tops)
    assert [t["bytes"] for t in tops] == sorted(
        (t["bytes"] for t in tops), reverse=True)


def test_peak_tensors_name_the_model_line(arctic_one_layer):
    """Each entry: bytes, op, the allocating tensor's shape and dtype,
    and the package's line that asked for it; the record carries them."""
    c = arctic_one_layer["counts"]
    for t in c.peak_tensors:
        assert set(t) == {"bytes", "op", "shape", "dtype", "site"}
        assert t["bytes"] >= int(np.prod(t["shape"]))
    assert any(t["site"].startswith("models/moe.py:")
               for t in c.peak_tensors)
    rec = dryrun.record_fields(c, arctic_one_layer["model_flops"], 256,
                               arctic_one_layer["seconds"])
    assert rec["memory"]["peak_tensors"] == c.peak_tensors


def test_extrapolation_keeps_the_longer_traces_peak_tensors():
    a = fc.DeviceCounts(peak_bytes=10, peak_tensors=[{"bytes": 1}])
    b = fc.DeviceCounts(peak_bytes=20, peak_tensors=[{"bytes": 2}])
    out = dryrun.extrapolate(a, b, 3)
    assert out.peak_bytes == 40 and out.peak_tensors == [{"bytes": 2}]


# phi4-mini-3.8b and starcoder2-7b cut to 2 layers at ``train_4k`` on
# 16 x 16 (fake CPU tensors), while each checkpointed group saved its whole
# input: the live local bytes at the end of the forward, the peak, FLOPs
# and all-gather wire bytes a device (the FLOPs stay)
WHOLE_SAVES = {   # arch: (forward's end, peak, FLOPs, all-gather)
    "phi4-mini-3.8b": (3467910676, 5377142932, 24700356919296, 5994516480),
    "starcoder2-7b": (3077271572, 5563703316, 22342419873792, 7839989760),
}


@pytest.fixture(scope="module")
def odd_heads_two_layers():
    """Each ``WHOLE_SAVES`` cut's counts, and the live bytes and the live
    (B/16, S, d) bf16 storages at the end of its forward (as ``loss_fn``
    returns, before the backward)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    loss_fn, ends = tt.loss_fn, []

    def at_forward_end(params, batch, cfg):
        out = loss_fn(params, batch, cfg)
        counter = next(m for m in _get_current_dispatch_mode_stack()
                       if isinstance(m, fc.DeviceCounter))
        whole = (SHAPES["train_4k"].global_batch // 16,
                 SHAPES["train_4k"].seq_len, cfg.d_model)
        ends.append((counter._live_bytes, sum(
            1 for shape, dtype, _ in counter._where.values()
            if shape == whole and dtype == "torch.bfloat16")))
        return out

    out = {}
    tt.loss_fn = at_forward_end
    try:
        for arch in WHOLE_SAVES:
            cfg = get_config(arch).replace(n_layers=2, use_flash_kernel=True)
            with dryrun.fake_process_group(256):
                mesh = dryrun.make_production_mesh(device_type="cpu")
                counts = dryrun.trace_step(cfg, SHAPES["train_4k"], mesh,
                                           get_optimizer_name(arch))["counts"]
            out[arch] = (cfg, counts, ends[-1])
    finally:
        tt.loss_fn = loss_fn
    return out


def _group_input_bytes(cfg) -> int:
    sp = SHAPES["train_4k"]
    return sp.global_batch // 16 * sp.seq_len * cfg.d_model * 2


@pytest.mark.parametrize("arch", sorted(WHOLE_SAVES))
def test_remat_saves_a_slice_of_each_group_input(arch, odd_heads_two_layers):
    """Heads that do not divide ``model`` (24, 36): each checkpointed group
    saves 1/16 of its (16, 4096, d) bf16 input, as XLA's compile of the
    reference saves its scan's residuals (``bf16[32,16,256,d]``). At the
    forward's end the live bytes are the whole saves' less 15/16 of the
    group inputs, and one whole input is live: the last group's output,
    which the final norm saves."""
    cfg, _, (live, whole) = odd_heads_two_layers[arch]
    saved = cfg.n_groups * _group_input_bytes(cfg)
    print(f"\n{arch}, 2 layers, train_4k 16x16: {live} B live at the "
          f"forward's end ({WHOLE_SAVES[arch][0]} saving whole inputs)")
    assert live == WHOLE_SAVES[arch][0] - saved * 15 // 16
    assert whole == 1


@pytest.mark.parametrize("arch", sorted(WHOLE_SAVES))
def test_remat_slices_cost_one_gather_a_group(arch, odd_heads_two_layers):
    """The slices keep the FLOPs, add one all-gather of 15/16 of each
    group's input (for the replay), and lower the peak: phi4's by 15/16 of
    the saved inputs (its peak stays at the forward's end, in the loss);
    starcoder2's moves to the backward and falls by over a third of that.
    No group input is among the five
    largest tensors at the peak: at most one (16, 4096, d) bf16 tensor of
    the model's, the last group's output or one of a replay."""
    cfg, c, _ = odd_heads_two_layers[arch]
    _, peak, flops, gathered = WHOLE_SAVES[arch]
    gather = cfg.n_groups * _group_input_bytes(cfg) * 15 // 16
    print(f"\n{arch}: peak {c.peak_bytes} (whole saves {peak}), all-gather "
          f"{c.collectives.bytes_by_kind['all-gather']} ({gathered}); "
          f"largest live at the peak: {c.peak_tensors}")
    assert c.flops == flops
    assert c.collectives.bytes_by_kind["all-gather"] == gathered + gather
    assert c.peak_bytes <= peak - (gather if arch == "phi4-mini-3.8b"
                                   else gather // 3)
    whole = [16, SHAPES["train_4k"].seq_len, cfg.d_model]
    assert sum(1 for t in c.peak_tensors
               if t["shape"] == whole and t["dtype"] == "torch.bfloat16"
               and t["site"].startswith("models/transformer.py:")) <= 1


class _Shapes(fc.DeviceCounter):
    """The counter, also keeping every allocated local tensor's shape."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def _track(self, t, owner, site):
        self.shapes.append(tuple(t.shape))
        super()._track(t, owner, site)


def test_embedding_looks_up_the_ranks_own_rows(fake_mesh):
    """tokens (B, S) over data, the table (V, d) vocab over model and d
    over data, as the rules lay them out: each rank's output is (B/2, S, d)
    and no tensor of (B, S, d) is built, forward or backward."""
    gen = np.random.default_rng(3)
    ids = distribute_tensor(torch.from_numpy(gen.integers(0, VOCAB, (B, S))),
                            fake_mesh, [S0, R])
    table = distribute_tensor(torch.zeros(VOCAB, D), fake_mesh,
                              [S1, S0]).requires_grad_()
    cot = distribute_tensor(torch.ones(B, S, D), fake_mesh, [S0, R])
    with _Shapes() as seen:
        out = sh.reduce_partials(tt._embed_on_shards(ids, table))
        torch.autograd.grad(out, table, cot)
    assert tuple(out.placements) == (S0, R)
    assert tuple(out.to_local().shape) == (B // 2, S, D)
    assert (B // 2, S, D) in seen.shapes
    assert (B, S, D) not in seen.shapes
