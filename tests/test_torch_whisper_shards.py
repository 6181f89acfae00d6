"""whisper-small's weight gradients where XLA's compile of the reference
takes them: each encoder projection's (q, k, v and the output product:
1500 frames do not divide ``model``) and each decoder layer's cross k and
v on the rank's TP slice (``layers.split_weight_grad``), on the CPU.

* The ``train_4k`` cut to 2 decoder layers (the encoder's 12 whole) on
  16 x 16 (256 fake ranks): no whole (768, 24000) x (24000, 768) weight
  gradient on a rank (before: 52); 40 of (768, 24000) x (24000, 48) and 12
  of (48, 24000) x (24000, 768), as XLA's ``dot.594`` .. ``dot.597`` and
  ``dot.573`` / ``dot.576``; FLOPs a device at most the reference's.
* A smoke grad step (3 heads and 15 frames, which a (2, 2) mesh's
  ``model`` divides neither) on 4 gloo ranks against the unsharded port
  (1e-5) and the reference (1e-4, the fp32 bound of
  ``test_torch_encdec.py``): the loss and every gradient, the encoder's
  and the cross k and v's among them, each relative to its largest
  magnitude; each of those weight gradients went through its TP slice.
"""
import collections
import os
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.models import transformer as jt
from repro_torch.configs import SHAPES, get_config, get_optimizer_name
from repro_torch.convert import params_from_numpy
from repro_torch.core import flop_count
from repro_torch.launch import dryrun, make_debug_mesh, steps
from repro_torch.models import layers
from repro_torch.models import transformer as tt
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_map

from test_torch_serve import with_gates
from test_torch_xattn_shards import _paths

WHISPER = "whisper-small"
LAYERS = 2
# the reference's FLOPs a device of the cut on 16 x 16
# (``test_torch_moe_shards.reference_counts(["whisper-small:train_4k"],
# n_layers=2)``)
REFERENCE_CUT = 13042911805440
B, S, TOL, JAX_TOL = 4, 16, 1e-5, 1e-4
# 3 heads over ``model``'s 2 and 15 frames: TP divides neither
OVER = {"n_heads": 3, "n_kv": 3, "encoder_len": 15, "cross_len": 15}
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def cut():
    """The cut's config, FLOPs a device and every matrix product of its
    backward: (operand shapes, FLOPs)."""
    products, count = [], flop_count.DeviceCounter._count

    def spy(self, func, args, kwargs, res):
        before = self.counts.flops
        count(self, func, args, kwargs, res)
        if (self.counts.flops > before
                and torch._C._current_graph_task_id() != -1):
            products.append((tuple(tuple(a.shape) for a in args[:2]),
                             self.counts.flops - before))

    flop_count.DeviceCounter._count = spy
    try:
        cfg = get_config(WHISPER).replace(n_layers=LAYERS,
                                          use_flash_kernel=True)
        with dryrun.fake_process_group(256):
            mesh = dryrun.make_production_mesh(device_type="cpu")
            counts = dryrun.trace_step(cfg, SHAPES["train_4k"], mesh,
                                       get_optimizer_name(WHISPER))["counts"]
    finally:
        flop_count.DeviceCounter._count = count
    return cfg, counts.flops, products


def test_cut_flops_are_at_most_the_references(cut):
    """Before: 1.4185e13, 1.088x the reference's; the rest below it is the
    decoder's fewer products, as ``prefill_32k``'s."""
    _, flops, _ = cut
    print(f"\n{WHISPER} train_4k, {LAYERS} layers: FLOPs a device {flops} "
          f"(reference {REFERENCE_CUT}, {flops / REFERENCE_CUT:.4f}x)")
    assert flops <= REFERENCE_CUT


def test_cut_takes_no_whole_weight_gradient(cut):
    """Each encoder projection's and each cross k and v weight gradient
    contracts the rank's 24,000 rows into 1/16 of the weight: 768 x 48
    (``wq``, ``wk``, ``wv``: 36 encoder, 4 cross) or 48 x 768 (the encoder's
    ``wo``: 12); none into the whole 768 x 768."""
    cfg, _, products = cut
    d, rows = cfg.d_model, SHAPES["train_4k"].global_batch // 16 \
        * cfg.encoder_len
    part = d // 16
    got = collections.Counter(shapes for shapes, _ in products)
    assert got[((1, d, rows), (1, rows, d))] == 0
    assert got[((1, d, rows), (1, rows, part))] == 3 * cfg.encoder_layers \
        + 2 * LAYERS
    assert got[((1, part, rows), (1, rows, d))] == cfg.encoder_layers


# ---------------------------------------------------------------------------
# A smoke grad step on 4 gloo ranks
# ---------------------------------------------------------------------------


def _inputs():
    cfg = get_config(WHISPER, smoke=True).replace(**OVER)
    rng = np.random.default_rng(0)
    params = with_gates(tree_map(lambda s: (0.1 * rng.standard_normal(s))
                                 .astype(np.float32), tt.param_shapes(cfg)),
                        0.5)
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    frames = (0.1 * rng.standard_normal((B, cfg.encoder_len, cfg.d_model))
              ).astype(np.float32)
    return cfg, params, tokens, frames


def _grads(mesh) -> dict:
    """The smoke step's loss and gradients, on ``mesh`` or (None)
    unsharded."""
    cfg, params, tokens, frames = _inputs()
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:]),
             "frames": torch.from_numpy(frames)}
    tp = params_from_numpy(params, "cpu")
    if mesh is not None:
        opt = make_optimizer("adamw", lr=1e-3)
        (psh, _, bsh), _, _ = steps.train_in_shardings(cfg, opt, batch, mesh)
        tp, batch = sh.distribute(tp, psh), sh.distribute(batch, bsh)
    whole = (lambda x: x.full_tensor()) if mesh is not None else (
        lambda x: x)
    grads, metrics = steps.make_grad_step(cfg, mesh)(tp, batch)
    out = {"loss": float(metrics["loss"])}
    out.update({"g/" + p: whole(g).detach().numpy()
                for p, g in _paths(grads)})
    return out


def _rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)     # 4 ranks on a few cores
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    calls, base = [], layers._WeightGradOnSlice

    class Counted(base):
        @staticmethod
        def backward(ctx, g):
            calls.append(1)
            return base.backward(ctx, g)

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(layers, "_WeightGradOnSlice", Counted)
            found = _grads(make_debug_mesh((2, 2), device_type="cpu"))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(d, "port.npz"), sliced=len(calls), **found)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("whisper_shards"))
    ctx = torch.multiprocessing.spawn(_rank_main, args=(4, d), nprocs=4,
                                      join=False)
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks took over {TIMEOUT_S} s")
    return dict(np.load(os.path.join(d, "port.npz")))


def _reference() -> dict:
    """The reference's loss and gradients of the same step, unsharded."""
    cfg, params, tokens, frames = _inputs()
    jc = jax_config(WHISPER, smoke=True).replace(**OVER)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "frames": frames}
    (loss, _), grads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                               static_argnums=2)(params, batch, jc)
    out = {"loss": float(loss)}
    out.update({"g/" + p: np.asarray(g) for p, g in _paths(grads)})
    return out


@pytest.mark.parametrize("against", ["unsharded port", "reference"])
def test_sharded_whisper_step_matches(against, sharded):
    """The (2, 2) mesh's loss and every gradient against the unsharded
    port's (1e-5) or the reference's (1e-4), a gradient relative to its
    largest magnitude. Each encoder layer's four projections and each
    decoder layer's cross k and v took their weight gradients on the TP
    slice."""
    cfg = get_config(WHISPER, smoke=True)
    got = dict(sharded)
    assert int(got.pop("sliced")) == 4 * cfg.encoder_layers \
        + 2 * cfg.n_layers
    want, tol = ((_grads(None), TOL) if against == "unsharded port"
                 else (_reference(), JAX_TOL))
    assert sorted(got) == sorted(want)
    assert any(k.startswith("g/encoder/") for k in want)
    assert any(k.endswith("xattn/wk") for k in want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=tol)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=tol * np.abs(want[k]).max())
