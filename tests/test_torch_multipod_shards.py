"""The 2 x 16 x 16 cells where XLA's compile of the reference runs them, on
the CPU.

* Remat: where a rank's batch rows of a group's input do not divide the
  ``sp`` axes (2 x 16 x 16 ``train_4k``: 8 rows a rank over ``model``'s
  16), each remat group saves the rank's sequence slice of its input, as
  XLA does (``transformer._checkpoint`` through ``sharding.saved_over``).
  A 4-layer cut of phi4-mini-3.8b ``train_4k`` on 512 fake ranks: every
  saved input 1/16 of the rank's x, and the peak holds no group input
  whole but the one being replayed (before: 0.75 GiB of them at the peak,
  6.0 GiB at full depth).
* The router: arctic-480b ``prefill_32k`` on 2 x 16 x 16 runs the router's
  product on the rank's 2 groups (XLA's ``dot.55`` ``f32[2048,128]``):
  FLOPs a device the reference's at 4 digits (before: 1.9825e14, the
  router on 32 groups), bytes under the reference's.
* The mask: recurrentgemma-2b ``prefill_32k``'s windowed local attention
  builds the mask rows of the rank's queries alone, no whole (32768,
  32768) bool tensor (before: 1.00 GiB on every rank); on 2 x 16 x 16 its
  bytes under the reference's 7.97 GiB, on 16 x 16 under 15.07. A mask
  built for a q-row slice equals that slice of the whole mask, bit for
  bit.
* Smoke steps on a (2, 2) mesh of 4 gloo ranks, B = 2 (one row a rank,
  which ``model`` does not divide) and 3 heads (which it does not divide
  either), remat on: phi4-mini-3.8b (the sequence slice saved), arctic-480b
  (the router on the rank's groups) and recurrentgemma-2b (the mask's
  rows): the grad step's loss and gradients and the prefill's logits
  against the unsharded port (loss and logits 1e-5, each gradient 1e-4 of
  its norm, as ``test_torch_moe_shards.py``) and against the reference
  (1e-4).
"""
import os
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.models import transformer as jt
from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import flop_count
from repro_torch.launch import dryrun, make_debug_mesh, steps
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tt
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_map

TP = 16                      # ``model`` on the production meshes
# The reference's counts a device on 2 x 16 x 16 (``test_torch_moe_shards.
# reference_counts(cells, multi_pod=True)``): GiB, FLOPs, wire bytes
REFERENCE_MP = {("arctic-480b", "prefill_32k"): (37.42, 1.9627e14, 7.060e11),
                ("recurrentgemma-2b", "prefill_32k"): (7.97, 1.7674e13,
                                                       4.825e10)}
# The port's bytes a device before its router ran on the rank's groups
BEFORE_GIB = {("arctic-480b", "prefill_32k"): 16.55}
# recurrentgemma-2b ``prefill_32k`` on 16 x 16: the port's GiB a device
# before its mask was built on the rank's rows (the reference's 15.15)
RG_SINGLE_POD_GIB = 15.07


class _SavedSlices(sh._Slice):
    """``sharding._Slice`` that records the local shape of each slice a
    checkpoint saves."""
    seen = []

    def __init__(self, *args):
        super().__init__(*args)
        self.seen.append(tuple(self.part.to_local().shape))


def _trace(arch: str, shape: str, multi_pod: bool, layers_=None):
    """A cell traced on fake ranks: (config, counts, every matrix product's
    operand shapes, every mask's shape, every saved slice's local
    shape)."""
    products, masks = [], []
    count, mask = flop_count.DeviceCounter._count, layers.causal_mask

    def spy(self, func, args, kwargs, res):
        before = self.counts.flops
        count(self, func, args, kwargs, res)
        if self.counts.flops > before:
            products.append(tuple(tuple(a.shape) for a in args[:2]))

    def built(*args, **kwargs):
        out = mask(*args, **kwargs)
        masks.append(tuple(out.shape))
        return out

    cfg = get_config(arch).replace(use_flash_kernel=True)
    if layers_:
        cfg = cfg.replace(n_layers=layers_)
    _SavedSlices.seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flop_count.DeviceCounter, "_count", spy)
        mp.setattr(layers, "causal_mask", built)
        mp.setattr(sh, "_Slice", _SavedSlices)
        with dryrun.fake_process_group(512 if multi_pod else 256):
            mesh = dryrun.make_production_mesh(multi_pod=multi_pod,
                                               device_type="cpu")
            counts = dryrun.trace_step(cfg, SHAPES[shape], mesh)["counts"]
    return cfg, counts, products, masks, list(_SavedSlices.seen)


# ---------------------------------------------------------------------------
# The production cells on 2 x 16 x 16
# ---------------------------------------------------------------------------


def test_remat_saves_the_sequence_slice_where_the_rows_do_not_split():
    """phi4-mini-3.8b ``train_4k`` cut to 4 layers on 2 x 16 x 16: its 24
    heads do not divide ``model``, so each remat group saves 1/16 of its
    input; the rank's 8 rows do not split 16 ways, so the slice is the
    sequence's, (8, 4096 / 16, d). At the peak the all-reduced group
    inputs hold at most one whole x (the group being replayed) and the
    saved slices (before: all four whole, 0.75 GiB)."""
    cfg, c, _, _, saved = _trace("phi4-mini-3.8b", "train_4k", True, 4)
    sp = SHAPES["train_4k"]
    rows = sp.global_batch // 32
    x_bytes = 2 * rows * sp.seq_len * cfg.d_model          # bf16
    reduced = c.peak_by_op.get("_c10d_functional.all_reduce.default", 0)
    print(f"\nphi4-mini-3.8b train_4k 4 layers 2x16x16: saved {saved}; the "
          f"peak's all-reduced bytes {reduced / 2**30:.4f} GiB (x "
          f"{x_bytes / 2**30:.4f}); {c.peak_bytes / 2**30:.4f} GiB, FLOPs "
          f"{c.flops:.4e}")
    assert saved == [(rows, sp.seq_len // TP, cfg.d_model)] * cfg.n_layers
    assert reduced <= x_bytes * (1 + cfg.n_layers / TP)


@pytest.fixture(scope="module")
def arctic():
    return _trace("arctic-480b", "prefill_32k", True)


def test_arctic_prefill_is_the_references(arctic):
    """arctic-480b ``prefill_32k`` on 2 x 16 x 16: the reference's FLOPs a
    device at 4 digits (before 1.9825e14: the router's product on 32
    groups of 1024 tokens a rank, where XLA's runs on 2), bytes under the
    reference's and not above before's."""
    _, c, _, _, _ = arctic
    gib, flops, wire = REFERENCE_MP["arctic-480b", "prefill_32k"]
    got = c.peak_bytes / 2**30
    print(f"\narctic-480b prefill_32k 2x16x16: FLOPs {c.flops:.4e}, "
          f"{got:.2f} GiB, wire {c.collectives.total_bytes:.4e} a device "
          f"(reference {flops:.4e}, {gib}, {wire:.4e})")
    assert f"{c.flops:.4e}" == f"{flops:.4e}"
    assert got <= gib
    assert got <= 1.01 * BEFORE_GIB["arctic-480b", "prefill_32k"]


def test_arctic_router_runs_on_the_ranks_groups(arctic):
    """Every router product (x by the (d, E) weight) contracts the rank's 2
    groups of 1024 tokens: 1024 groups over the 512 ranks, the rank's
    sequence slice of its one row."""
    cfg, _, products, _, _ = arctic
    d, e = cfg.d_model, cfg.moe.num_experts
    router = [a for a, b in products if b[-2:] == (d, e)]
    tokens = {int(np.prod(a)) // d for a in router}
    assert len(router) == cfg.n_layers
    assert tokens == {2 * cfg.moe.group_size}


@pytest.mark.parametrize("multi_pod,limit", [
    (True, REFERENCE_MP["recurrentgemma-2b", "prefill_32k"][0]),
    (False, RG_SINGLE_POD_GIB)], ids=["2x16x16", "16x16"])
def test_recurrentgemma_mask_is_the_ranks_rows(multi_pod, limit):
    """recurrentgemma-2b ``prefill_32k``: each local attention layer's mask
    is the window's band of the rank's 2048 q rows over all 32768 keys;
    no whole (32768, 32768) bool tensor is live at the peak (before: 1.00
    GiB of it); bytes under ``limit``; FLOPs the reference's at 4 digits
    on 2 x 16 x 16 (the scores still span every key)."""
    cfg, c, _, masks, _ = _trace("recurrentgemma-2b", "prefill_32k",
                                 multi_pod)
    s = SHAPES["prefill_32k"].seq_len
    got = c.peak_bytes / 2**30
    whole = [t for t in c.peak_tensors if t["dtype"] == "torch.bool"
             and tuple(t["shape"][-2:]) == (s, s)]
    mesh = "2x16x16" if multi_pod else "16x16"
    print(f"\nrecurrentgemma-2b prefill_32k {mesh}: {got:.4f} GiB (limit "
          f"{limit}), FLOPs {c.flops:.4e}; "
          f"masks {sorted(set(masks))}; the peak's bool bytes "
          f"{c.peak_by_op.get('aten.bitwise_and.Tensor', 0) / 2**30:.4f} "
          f"GiB")
    local = sum(k == "local" for k in cfg.pattern) * cfg.n_layers \
        // len(cfg.pattern)
    assert masks and len(masks) == local
    assert set(masks) == {(1, 1, s // TP, s)}
    assert not whole
    assert got <= limit
    if multi_pod:
        want = REFERENCE_MP["recurrentgemma-2b", "prefill_32k"][1]
        assert f"{c.flops:.4e}" == f"{want:.4e}"


@pytest.mark.parametrize("window", [0, 3, 32])
@pytest.mark.parametrize("rows", [(0, 64), (64, 64), (40, 8), (127, 1)])
def test_a_masks_rows_are_that_slice_of_the_whole_mask(rows, window):
    """``causal_mask(..., rows=(first, count))`` equals rows first to
    first + count of the whole mask, bit for bit, and the whole mask is
    its own rows (0, s)."""
    s, first, count = 128, *rows
    whole = layers.causal_mask(s, s, torch.device("cpu"), window=window)
    part = layers.causal_mask(s, s, torch.device("cpu"), window=window,
                              rows=rows)
    assert part.dtype == torch.bool and part.shape == (1, 1, count, s)
    assert torch.equal(part, whole[:, :, first:first + count])
    assert torch.equal(layers.causal_mask(s, s, torch.device("cpu"), window,
                                          rows=(0, s)), whole)


# ---------------------------------------------------------------------------
# Smoke steps on 4 gloo ranks: one row a rank, 3 heads
# ---------------------------------------------------------------------------

B, S, LR = 2, 256, 1e-3
TOL, JAX_TOL = 1e-5, 1e-4
TIMEOUT_S = 240
OVER = {"n_heads": 3, "n_kv": 1, "remat": True}
CASES = {"remat": "phi4-mini-3.8b", "router": "arctic-480b",
         "mask": "recurrentgemma-2b"}


def _inputs(name: str):
    """A case's config, numpy weights (0.1·N(0, 1), fp32) and token ids
    (B, S + 1), from numpy seed 0."""
    cfg = get_config(CASES[name], smoke=True).replace(**OVER)
    rng = np.random.default_rng(0)
    params = tree_map(lambda s: (0.1 * rng.standard_normal(s))
                      .astype(np.float32), tt.param_shapes(cfg))
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return cfg, params, tokens


def _paths(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _steps(name: str, mesh) -> dict:
    """A case's grad step (loss, gradients) and prefill step (logits), on
    ``mesh`` or (None) unsharded."""
    cfg, params, tokens = _inputs(name)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:])}
    pre = {"tokens": batch["tokens"]}
    tp = params_from_numpy(params, "cpu")
    if mesh is not None:
        opt = make_optimizer("adamw", lr=LR)
        (psh, _, bsh), _, _ = steps.train_in_shardings(cfg, opt, batch, mesh)
        tp, batch = sh.distribute(tp, psh), sh.distribute(batch, bsh)
        pre = sh.distribute(pre, steps.batch_shardings(pre, mesh))
    whole = (lambda x: x.full_tensor()) if mesh is not None else (
        lambda x: x)
    grads, metrics = steps.make_grad_step(cfg, mesh)(tp, batch)
    logits = steps.make_prefill_step(cfg, mesh)(tp, pre)
    return {"loss": float(metrics["loss"]),
            **{"g/" + p: whole(x).detach().numpy() for p, x in _paths(grads)},
            "logits": whole(logits).detach().numpy()}


def _rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)     # 4 ranks on a few cores
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    routed, masks, real_groups = [], [], moe._router_groups
    real_mask = layers.causal_mask

    def router_groups(xg, x, cfg):
        out = real_groups(xg, x, cfg)
        routed.append(tuple(out.to_local().shape))
        return out

    def causal_mask(*args, **kwargs):
        out = real_mask(*args, **kwargs)
        masks.append(tuple(out.shape))
        return out

    try:
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        found = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sh, "_Slice", _SavedSlices)
            mp.setattr(moe, "_router_groups", router_groups)
            mp.setattr(layers, "causal_mask", causal_mask)
            for name in CASES:
                _SavedSlices.seen, routed[:], masks[:] = [], [], []
                found.update({f"{name}/{k}": v
                              for k, v in _steps(name, mesh).items()})
                found[f"{name}/saved"] = np.array(_SavedSlices.seen)
                found[f"{name}/routed"] = np.array(routed)
                found[f"{name}/masks"] = np.array(masks)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(d, "port.npz"), **found)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("multipod_shards"))
    ctx = torch.multiprocessing.spawn(_rank_main, args=(4, d), nprocs=4,
                                      join=False)
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks took over {TIMEOUT_S} s")
    return dict(np.load(os.path.join(d, "port.npz")))


def _of(found: dict, name: str) -> dict:
    return {k[len(name) + 1:]: v for k, v in found.items()
            if k.startswith(name + "/")}


def _reference(name: str) -> dict:
    """The reference's loss, gradients and logits of the same steps,
    unsharded."""
    _, params, tokens = _inputs(name)
    jc = jax_config(CASES[name], smoke=True).replace(**OVER)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    (loss, _), grads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                               static_argnums=2)(params, batch, jc)
    logits, _ = jax.jit(jt.forward, static_argnums=2)(
        params, {"tokens": batch["tokens"]}, jc)
    return {"loss": float(loss), "logits": np.asarray(logits),
            **{"g/" + p: np.asarray(g) for p, g in _paths(grads)}}


@pytest.mark.parametrize("against", ["unsharded port", "reference"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_one_row_a_rank_steps_match(name, against, sharded):
    """The (2, 2) mesh's grad step and prefill against the unsharded
    port's or the reference's: the loss within ``TOL`` relative, each
    gradient within 1e-4 of its norm (an expert no token reached has none
    on either side), the logits within ``TOL`` (the reference: ``JAX_TOL``
    throughout)."""
    got = {k: v for k, v in _of(sharded, name).items()
           if k not in ("saved", "routed", "masks")}
    want, tol = ((_steps(name, None), TOL) if against == "unsharded port"
                 else (_reference(name), JAX_TOL))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=tol)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=tol,
                               atol=tol)
    for k in (k for k in want if k.startswith("g/")):
        scale = np.linalg.norm(want[k])
        if scale == 0:
            assert not got[k].any(), k
            continue
        assert np.linalg.norm(got[k] - want[k]) <= 1e-4 * scale, k


def test_one_row_a_rank_takes_the_ranks_slices(sharded):
    """On the (2, 2) mesh: phi4's and arctic's remat groups (3 heads over
    ``model``'s 2) each saved the rank's half of the sequence of its one
    row, (1, S / 2, d), in each grad step's forward; recurrentgemma's
    (a recurrence first) saved none. arctic's prefill router ran on the
    rank's 2 of its row's 4 groups in each layer. Every mask
    recurrentgemma built was its rank's S / 2 q rows."""
    d = get_config(CASES["remat"], smoke=True).d_model
    for name in ("remat", "router"):
        cfg = _inputs(name)[0]
        saved = [tuple(s) for s in sharded[f"{name}/saved"]]
        assert saved == [(1, S // 2, d)] * cfg.n_layers, name
    assert sharded["mask/saved"].size == 0
    cfg = _inputs("router")[0]
    n = S // cfg.moe.group_size
    routed = [tuple(r) for r in sharded["router/routed"]]
    assert routed == [(n // 2, cfg.moe.group_size, d)] * cfg.n_layers
    masks = {tuple(m) for m in sharded["mask/masks"]}
    assert masks == {(1, 1, S // 2, S)}
