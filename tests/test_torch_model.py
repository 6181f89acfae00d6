"""The port's transformer against ``repro.models.transformer``: smoke
configs with the flash path on (S = 256, the kernel's threshold), remat on
and off; logits, loss and every gradient leaf, from the same weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import transformer as tt
from repro_torch.tree import tree_map

KEY = jax.random.PRNGKey(0)


def batches(vocab, b, s, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})


def setup(arch, s, **kw):
    jc = jax_config(arch, smoke=True).replace(**kw)
    tc = get_config(arch, smoke=True).replace(**kw)
    jp = jt.init_params(KEY, jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jb, tb = batches(jc.vocab, 2, s)
    return jc, tc, jp, tp, jb, tb


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["gemma-7b", "granite-8b"])
def test_flash_path_logits_loss_grads(arch, remat, monkeypatch):
    jc, tc, jp, tp, jb, tb = setup(arch, 256, use_flash_kernel=True,
                                   remat=remat)
    calls = []
    import repro_torch.kernels.ops as ops
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    (jloss, _), jgrads = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jp, jb, jc)
    jlogits, _ = jt.forward(jp, jb, jc)

    loss, metrics = tt.loss_fn(tp, tb, tc)
    loss.backward()
    # one call per layer forward, plus the remat recompute in backward
    assert len(calls) == tc.n_layers * (2 if remat else 1)
    with torch.no_grad():
        logits, _ = tt.forward(tp, tb, tc)

    assert logits.shape == (2, 256, tc.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), float(jloss), rtol=1e-5)
    tree_map(lambda t, g: np.testing.assert_allclose(
        t.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-4), tp, jgrads)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "starcoder2-7b"])
def test_other_dense_archs_forward(arch):
    """swiglu / GQA 3:1 and layernorm / gelu blocks on the naive path."""
    jc, tc, jp, tp, jb, tb = setup(arch, 16)
    jlogits, _ = jt.forward(jp, jb, jc)
    with torch.no_grad():
        logits, _ = tt.forward(tp, tb, tc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)


def test_pad_vocab_masked():
    cfg = get_config("gemma-7b", smoke=True)
    assert cfg.padded_vocab == 512 and cfg.vocab == 256
    params = tt.init_params(torch.Generator().manual_seed(0), cfg)
    _, tb = batches(cfg.vocab, 2, 16)
    with torch.no_grad():
        logits, _ = tt.forward(params, tb, cfg)
    pad, real = logits[..., cfg.vocab:], logits[..., :cfg.vocab]
    assert pad.max() < real.max() - 1e6


@pytest.mark.parametrize("arch", ["gemma-7b", "granite-8b",
                                  "recurrentgemma-2b", "xlstm-350m",
                                  "deepseek-moe-16b", "arctic-480b",
                                  "whisper-small", "llama-3.2-vision-90b"])
def test_init_layout_matches_jax(arch):
    """Same keys, shapes and dtypes as the JAX pytree; leaves need grad."""
    cfg = get_config(arch, smoke=True)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg)
    want = jax.tree_util.tree_map(
        lambda x: (x.shape, str(x.dtype)),
        jt.param_shapes(jax_config(arch, smoke=True)))
    got = tree_map(lambda t: (tuple(t.shape), "float32"), params)
    assert got == want
    assert all(t.requires_grad and t.is_leaf
               for t in jax.tree_util.tree_leaves(params))
    assert tt.param_count(params) == jt.param_count(
        jax_config(arch, smoke=True))


def test_params_round_trip():
    cfg = get_config("gemma-7b", smoke=True)
    params = tt.init_params(torch.Generator().manual_seed(1), cfg)
    back = params_from_numpy(params_to_numpy(params), "cpu")
    tree_map(lambda a, b: torch.testing.assert_close(a, b, atol=0, rtol=0),
             params, back)
