"""The port's RG-LRU block and recurrentgemma-2b against the JAX package:
``_rglru_coeffs``, ``_causal_conv``, ``apply_rglru`` with the kernel path on
and off, the parameter layout, and the smoke model's logits, loss and every
gradient with the scan op on (S = 256, the kernel's threshold). Inputs come
from numpy; JAX-initialised weights are carried across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import recurrent as jr
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import recurrent as tr
from repro_torch.models import transformer as tt
from repro_torch.tree import tree_map

ARCH = "recurrentgemma-2b"
TOL = 1e-4
KEY = jax.random.PRNGKey(4)


def configs(**kw):
    return (jax_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


def rglru_params(cfg):
    jp = jr.init_rglru(KEY, cfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def normal(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def grads_close(tp, jgrads, tol=TOL):
    tree_map(lambda t, g: np.testing.assert_allclose(
        t.grad.numpy(), np.asarray(g), atol=tol, rtol=tol), tp, jgrads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_coeffs(dtype):
    """bf16 u times fp32 gate weights: JAX promotes, the port casts."""
    jc, _ = configs()
    jp, tp = rglru_params(jc)
    u = normal((2, 16, jc.rnn_width))
    ju = jnp.asarray(u).astype(jnp.dtype(dtype))
    tu = torch.from_numpy(u).to(getattr(torch, dtype))
    ja, jb = jr._rglru_coeffs(jp, ju)
    ta, tb = tr._rglru_coeffs(tp, tu)
    assert ta.dtype == tb.dtype == torch.float32
    close(ta, ja)
    close(tb, jb)


def test_rglru_coeffs_grads():
    jc, _ = configs()
    jp, tp = rglru_params(jc)
    u = normal((2, 16, jc.rnn_width))

    def f(p, u):
        a, b = jr._rglru_coeffs(p, u)
        return jnp.sum(a ** 2) + jnp.sum(b ** 2)

    jgp, jgu = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(u))
    tu = torch.from_numpy(u).requires_grad_()
    a, b = tr._rglru_coeffs(tp, tu)
    ((a ** 2).sum() + (b ** 2).sum()).backward()
    close(tu.grad, jgu)
    for k in ("rg_gates", "rg_lambda"):
        grads_close(tp[k], jgp[k])


def test_softplus_is_exact_above_torch_threshold():
    x = torch.tensor([-30.0, 0.0, 19.0, 25.0, 60.0])
    close(tr._softplus(x), jax.nn.softplus(jnp.asarray(x.numpy())), tol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 1e-2)])
def test_causal_conv(dtype, tol):
    x, w = normal((2, 16, 8), seed=1), normal((4, 8), seed=2, scale=0.1)
    want = jr._causal_conv(jnp.asarray(x).astype(jnp.dtype(dtype)),
                           jnp.asarray(w))
    got = tr._causal_conv(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(w))
    assert got.dtype == getattr(torch, dtype)
    close(got, want, tol=tol)


@pytest.mark.parametrize("kernel", [False, True])
def test_apply_rglru_outputs_and_grads(kernel, monkeypatch):
    jc, tc = configs(use_flash_kernel=kernel)
    jp, tp = rglru_params(jc)
    x = normal((2, 256, jc.d_model), seed=3)
    calls = []
    import repro_torch.kernels.ops as ops
    real = ops.rglru_scan
    monkeypatch.setattr(ops, "rglru_scan",
                        lambda *a: calls.append(1) or real(*a))

    def f(p, x):
        return jnp.sum(jr.apply_rglru(p, x, jc) ** 2)

    jgp, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(jp, jnp.asarray(x))
    want = jr.apply_rglru(jp, jnp.asarray(x), jc)
    tx = torch.from_numpy(x).requires_grad_()
    out = tr.apply_rglru(tp, tx, tc)
    (out ** 2).sum().backward()
    assert len(calls) == int(kernel)
    close(out, want)
    close(tx.grad, jgx)
    grads_close(tp, jgp)


def test_init_rglru_layout_and_decay_range():
    jc, tc = configs()
    tp = tr.init_rglru(torch.Generator().manual_seed(0), tc)
    want = jax.tree_util.tree_map(
        lambda x: (x.shape, str(x.dtype)),
        jax.eval_shape(lambda k: jr.init_rglru(k, jc), KEY))
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp) == want
    # a = sigmoid(lam)^c at rgate 1 lies in [0.9, 0.999]
    a = torch.exp(-8.0 * tr._softplus(tp["rg_lambda"]))
    assert float(a.min()) >= 0.9 - 1e-5 and float(a.max()) <= 0.999 + 1e-5


def batches(vocab, b, s, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})


@pytest.mark.parametrize("remat", [False, True])
def test_model_logits_loss_grads(remat, monkeypatch):
    jc, tc = configs(use_flash_kernel=True, remat=remat)
    assert (tc.n_layers, tc.pattern, tc.n_tail, tc.window) == (
        7, ("rglru", "rglru", "local"), 1, 32)
    jp = jt.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jb, tb = batches(jc.vocab, 2, 256)
    calls = []
    import repro_torch.kernels.ops as ops
    real = ops.rglru_scan
    monkeypatch.setattr(ops, "rglru_scan",
                        lambda *a: calls.append(1) or real(*a))

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                                 static_argnums=2)(jp, jb, jc)
    jlogits, _ = jax.jit(jt.forward, static_argnums=2)(jp, jb, jc)

    loss, metrics = tt.loss_fn(tp, tb, tc)
    loss.backward()
    # 5 rglru layers (2 groups of 2, 1 in the tail); remat recomputes the
    # 4 inside the groups in the backward pass
    assert len(calls) == (9 if remat else 5)
    with torch.no_grad():
        logits, _ = tt.forward(tp, tb, tc)
    assert logits.shape == (2, 256, tc.padded_vocab)
    close(logits, jlogits)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), float(jloss), rtol=1e-5)
    grads_close(tp, jgrads)

