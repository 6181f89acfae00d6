"""Cross-attention's k and v and a MoE block's output products, placed as
XLA's compile of the reference places them, on the CPU: values and
gradients unchanged.

* A remat'd block (``transformer._apply_block`` under a non-reentrant
  checkpoint) of the deepseek-moe-16b, arctic-480b and
  llama-3.2-vision-90b smoke configs: its output and every gradient within
  1e-6 of the block's with plain einsums for its output products (the MoE
  block: the combine, the shared experts' and the dense residual FFN's
  ``wo``; bit-equal for the cross-attention block, whose products are
  plain einsums off a mesh), and within 1e-4 of the reference's block
  (the fp32 bound of ``test_torch_moe.py``'s and ``test_torch_encdec.py``'s
  smoke models; the block's outputs reach 40).
  The replay runs none of the MoE block's output products, where plain
  einsums replay every one but the last.
* A llama-3.2-vision-90b smoke grad step and prefill step on a (2, 2) mesh
  of 4 gloo ranks, one kv head (which ``model`` does not divide), remat
  off and on, against the unsharded steps: the loss, every gradient and
  the logits within 1e-5. The cross k and v weight gradients went through
  their TP slice (``layers.split_weight_grad``) and the prefill's cross k
  and v split their contraction (``layers.split_source``).
"""
import collections
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro.configs import get_config as jax_config
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import make_debug_mesh, steps
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tt
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_map

from test_torch_serve import with_gates

KEY = jax.random.PRNGKey(7)
LLAMA = "llama-3.2-vision-90b"
BLOCKS = {"deepseek": ("deepseek-moe-16b", "moe"),
          "arctic": ("arctic-480b", "moe"),
          "llama": (LLAMA, "xattn")}
# the block's output products (``moe.apply_moe``)
OUTPUT_EQS = ("necd,ngec->ngd", "...f,fd->...d")
B, S, TOL = 4, 16, 1e-5      # the gloo smoke steps
TIMEOUT_S = 240


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# A remat'd block on the CPU
# ---------------------------------------------------------------------------


def _block_inputs(name):
    """(JAX config, port config, kind, JAX params, numpy x, enc, cotangent),
    every gate at 0.5."""
    arch, kind = BLOCKS[name]
    jc, tc = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = with_gates(jax.tree_util.tree_map(
        np.asarray, jt._init_block(KEY, kind, jc)), 0.5)
    d = tc.d_model
    x, ct = normal((2, 32, d), 1), normal((2, 32, d), 2)
    enc = 0.1 * normal((2, tc.cross_len, d), 3) if kind == "xattn" else None
    return jc, tc, kind, jp, x, enc, ct


def _port_block(name, plain: bool):
    """The port's remat'd block: output, gradients of the params and x, and
    the output-product einsums each pass ran (forward, backward); with
    ``plain`` the MoE's output products are plain einsums."""
    _, tc, kind, jp, x, enc, ct = _block_inputs(name)
    p = params_from_numpy(jp, "cpu")
    tx = torch.from_numpy(x).requires_grad_()
    tenc = None if enc is None else torch.from_numpy(enc)
    positions = torch.arange(x.shape[1])[None, :]
    seen, einsum = collections.Counter(), torch.einsum

    def spy(eq, *ops):
        out = einsum(eq, *ops)     # a replay stopped inside counts none
        if eq in OUTPUT_EQS:
            seen[torch._C._current_graph_task_id() != -1] += 1
        return out

    def fn(x):
        out, aux = tt._apply_block(kind, p, x, tc, positions, tenc)
        return out, aux["aux_loss"] + aux["z_loss"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "einsum", spy)
        if plain:
            mp.setattr(moe, "output_products", lambda products: tuple(
                torch.einsum(eq, a, b) for eq, a, b in products))
        out, aux = checkpoint(fn, tx, use_reentrant=False)
        (torch.sum(out * torch.from_numpy(ct)) + aux).backward()
    grads = {"x": tx.grad, **{path: t.grad for path, t in _paths(p)}}
    return out.detach(), grads, (seen[False], seen[True])


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_remat_block_gradients_are_as_before(name):
    """Output and gradients against the block with plain einsums for the
    output products: within 1e-6 relative to each gradient's norm (the
    same products, each operand's gradient a local einsum where autograd
    took the product's backward), bit-equal where the same einsums run
    (the cross-attention block)."""
    out, grads, _ = _port_block(name, plain=False)
    want_out, want, _ = _port_block(name, plain=True)
    assert torch.equal(out, want_out)
    assert sorted(grads) == sorted(want)
    for k, g in want.items():
        if g is None:
            assert grads[k] is None, k
        elif BLOCKS[name][1] == "xattn":
            assert torch.equal(grads[k], g), k
        else:
            err = torch.linalg.norm(grads[k] - g)
            assert err <= 1e-6 * torch.linalg.norm(g), k


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_remat_block_matches_the_reference(name):
    """Output and every gradient within 1e-4 of the reference's block
    (``jax.grad`` of the same loss), the smoke models' fp32 bound."""
    jc, _, kind, jp, x, enc, ct = _block_inputs(name)
    positions = jnp.arange(x.shape[1])[None, :]
    jenc = None if enc is None else jnp.asarray(enc)

    def jloss(p, x):
        out, aux = jt._apply_block(kind, p, x, jc, positions, jenc)
        return jnp.sum(out * ct) + aux["aux_loss"] + aux["z_loss"], out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    out, grads, _ = _port_block(name, plain=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(grads["x"].numpy(), np.asarray(jgx),
                               atol=1e-4, rtol=1e-4)
    for path, g in _paths(jax.tree_util.tree_map(np.asarray, jgp)):
        np.testing.assert_allclose(grads[path].numpy(), g, atol=1e-4,
                                   rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("name", ["arctic", "deepseek"])
def test_remat_replay_runs_no_output_product(name):
    """The MoE block's output products run once each in the forward and
    never in the replay; with plain einsums the replay, which runs to the
    last op that saves a tensor, runs every one but the last."""
    cfg = get_config(BLOCKS[name][0], smoke=True)
    # the combine, and the shared experts' or the dense FFN's ``wo``
    products = 1 + bool(cfg.moe.num_shared) + bool(cfg.dense_residual_ff)
    assert products == 2
    *_, kept = _port_block(name, plain=False)
    *_, plain = _port_block(name, plain=True)
    assert kept == (products, 0)
    assert plain == (products, products - 1)


# ---------------------------------------------------------------------------
# A llama-3.2-vision-90b smoke step on 4 gloo ranks
# ---------------------------------------------------------------------------


def _inputs():
    cfg = get_config(LLAMA, smoke=True).replace(n_kv=1)
    rng = np.random.default_rng(0)
    params = with_gates(tree_map(lambda s: (0.1 * rng.standard_normal(s))
                                 .astype(np.float32), tt.param_shapes(cfg)),
                        0.5)
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    enc = (0.1 * rng.standard_normal((B, cfg.cross_len, cfg.d_model))
           ).astype(np.float32)
    return cfg, params, tokens, enc


def _steps(mesh, remat: bool) -> dict:
    """Loss, gradients and prefill logits of the smoke step, on ``mesh``
    or (None) unsharded."""
    cfg, params, tokens, enc = _inputs()
    cfg = cfg.replace(remat=remat)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:]),
             "enc_embed": torch.from_numpy(enc)}
    pre = {k: batch[k] for k in ("tokens", "enc_embed")}
    tp = params_from_numpy(params, "cpu")
    if mesh is not None:
        opt = make_optimizer("adamw", lr=1e-3)
        (psh, _, bsh), _, _ = steps.train_in_shardings(cfg, opt, batch, mesh)
        tp, batch = sh.distribute(tp, psh), sh.distribute(batch, bsh)
        pre = sh.distribute(pre, steps.batch_shardings(pre, mesh))
    whole = (lambda x: x.full_tensor()) if mesh is not None else (
        lambda x: x)
    grads, metrics = steps.make_grad_step(cfg, mesh)(tp, batch)
    logits = steps.make_prefill_step(cfg, mesh)(tp, pre)
    out = {"loss": float(metrics["loss"]),
           "logits": whole(logits).detach().numpy()}
    out.update({"g/" + p: whole(g).detach().numpy()
                for p, g in _paths(grads)})
    return out


def _rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)     # 4 ranks on a few cores
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    calls, base = collections.Counter(), layers._WeightGradOnSlice
    split = layers.split_source

    class Counted(base):
        @staticmethod
        def backward(ctx, g):
            calls["sliced"] += 1
            return base.backward(ctx, g)

    def split_source(*args, **kw):
        calls["split"] += 1
        return split(*args, **kw)

    try:
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        found = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(layers, "_WeightGradOnSlice", Counted)
            mp.setattr(layers, "split_source", split_source)
            for remat in (False, True):
                calls.clear()
                found.update({f"remat={remat}/{k}": v for k, v in
                              _steps(mesh, remat).items()})
                for k in ("sliced", "split"):
                    found[f"remat={remat}/{k}"] = calls[k]
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(d, "port.npz"), **found)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("xattn_shards"))
    ctx = torch.multiprocessing.spawn(_rank_main, args=(4, d), nprocs=4,
                                      join=False)
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks took over {TIMEOUT_S} s")
    return dict(np.load(os.path.join(d, "port.npz")))


@pytest.mark.parametrize("remat", [False, True])
def test_sharded_llama_step_matches_the_unsharded_step(remat, sharded):
    """The (2, 2) mesh's loss, every gradient and the prefill's logits
    within 1e-5 of the unsharded steps' (a gradient relative to its
    largest magnitude). Each cross-attention layer's k and v weight
    gradients went through their TP slice (2 a layer) and the prefill's
    cross k and v split their contraction (2 a layer): the source's rows
    a device, 2 x 16, are fewer than d = 64."""
    want = _steps(None, remat)
    got = {k[len(f"remat={remat}/"):]: v for k, v in sharded.items()
           if k.startswith(f"remat={remat}/")}
    cfg = get_config(LLAMA, smoke=True)
    xattn = cfg.pattern.count("xattn") * cfg.n_layers // len(cfg.pattern)
    assert int(got.pop("sliced")) == 2 * xattn
    assert int(got.pop("split")) == 2 * xattn
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    for k in want:     # relative to the leaf's largest magnitude
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=TOL * np.abs(want[k]).max())
