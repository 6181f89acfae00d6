"""The port's dense layers against ``repro.models.layers`` in float32, with
the same numpy inputs and the JAX-initialised weights carried across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as tl

TOL = 1e-5
KEY = jax.random.PRNGKey(3)


def arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def both(cfg_kw=None, arch="gemma-7b"):
    kw = cfg_kw or {}
    return (jax_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    jc, tc = both({"norm": norm})
    (x, scale, bias) = arrays((2, 8, 64), (64,), (64,))
    p = {"scale": scale, "bias": bias} if norm == "layernorm" \
        else {"scale": scale}
    want = jl.apply_norm(jax.tree_util.tree_map(jnp.asarray, p),
                         jnp.asarray(x), jc)
    got = tl.apply_norm(params_from_numpy(p, "cpu"), torch.from_numpy(x), tc)
    close(got, want)


def _plain_norm(p, x, norm):
    """The norms' formulas under autograd, whole."""
    xf = x.float()
    if norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]
    else:
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6) \
            * p["scale"]
    return y.to(x.dtype)


def _norm_case(norm, dtype, monkeypatch):
    """x (3, 10, 64) in ``dtype``, the parameters, a cotangent, the config;
    the norms' budget lowered to 4 rows a chunk (8 chunks)."""
    _, tc = both({"norm": norm})
    x, scale, bias, g = arrays((3, 10, 64), (64,), (64,), (3, 10, 64),
                               seed=5)
    p = {"scale": scale, "bias": bias} if norm == "layernorm" \
        else {"scale": scale}
    monkeypatch.setattr(tl, "NORM_CHUNK_BYTES", 4 * 4 * 64)
    assert len(tl._norm_spans(30, 64)) >= 3
    return (p, torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype),
            tc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_in_row_chunks_is_the_plain_formulas(norm, dtype, monkeypatch):
    """The forward ``torch.equal`` to the whole formulas; each gradient
    (x, scale, bias) within 1e-6 of its norm of autograd's, x's in bf16
    within one bf16 rounding (2^-8) of it: the fp32 values it rounds differ
    in their last bits."""
    p, x, g, tc = _norm_case(norm, dtype, monkeypatch)
    got, want = ([t.requires_grad_() for t in
                  [x.clone()] + [torch.from_numpy(v) for v in p.values()]]
                 for _ in range(2))
    y = tl.apply_norm(dict(zip(p, got[1:])), got[0], tc)
    y0 = _plain_norm(dict(zip(p, want[1:])), want[0], norm)
    assert y.dtype == dtype and torch.equal(y, y0)
    for a, b in zip(torch.autograd.grad(y, got, g),
                    torch.autograd.grad(y0, want, g)):
        assert a.dtype == b.dtype
        tol = 2 ** -8 if a.dtype == torch.bfloat16 else 1e-6
        a, b = a.float(), b.float()
        assert (a - b).norm() <= tol * b.norm()


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_gradients_match_the_references(norm, monkeypatch):
    """x's and the parameters' gradients, in row chunks, against
    ``jax.vjp`` of the JAX package's ``apply_norm``."""
    p, x, g, tc = _norm_case(norm, torch.float32, monkeypatch)
    jc, _ = both({"norm": norm})
    _, vjp = jax.vjp(lambda p, x: jl.apply_norm(p, x, jc),
                     jax.tree_util.tree_map(jnp.asarray, p),
                     jnp.asarray(x.numpy()))
    jp, jx = vjp(jnp.asarray(g.numpy()))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xt = x.clone().requires_grad_()
    grads = torch.autograd.grad(tl.apply_norm(tp, xt, tc), [xt, *tp.values()],
                                g)
    close(grads[0], jx)
    for got, k in zip(grads[1:], tp):
        close(got, jp[k], tol=1e-4)


def test_apply_rope():
    (x,) = arrays((2, 16, 4, 16))
    pos = np.arange(16)[None, :]
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    close(got, want)


@pytest.mark.parametrize("mlp", ["geglu", "swiglu", "gelu"])
def test_apply_mlp(mlp):
    jc, tc = both({"mlp": mlp})
    jp = jl.init_mlp(KEY, jc)
    (x,) = arrays((2, 8, 64))
    want = jl.apply_mlp(jp, jnp.asarray(x), jc)
    got = tl.apply_mlp(params_from_numpy(to_np(jp), "cpu"),
                       torch.from_numpy(x), tc)
    close(got, want)


@pytest.mark.parametrize("masked", [True, False])
def test_mha_logits_to_out(masked):
    jc, tc = both()
    q, k, v = arrays((2, 16, 4, 16), (2, 16, 2, 16), (2, 16, 2, 16))
    jm = jl.causal_mask(16, 16) if masked else None
    tm = tl.causal_mask(16, 16, torch.device("cpu")) if masked else None
    want = jl.mha_logits_to_out(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jm, jc)
    got = tl.mha_logits_to_out(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), tm, tc)
    close(got, want)


@pytest.mark.parametrize("window", [0, 8])
def test_chunked_attention(window):
    jc, tc = both({"attention_chunk": 8})
    q, k, v = arrays((2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16))
    want = jl.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jc, window=window)
    got = tl.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), tc, window=window)
    close(got, want)


@pytest.mark.parametrize("window", [0, 4])
def test_causal_mask(window):
    want = np.asarray(jl.causal_mask(6, 9, window=window))
    got = tl.causal_mask(6, 9, torch.device("cpu"), window=window)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("branch,kw,s", [
    ("flash", {"use_flash_kernel": True}, 256),
    ("chunked", {"attention_impl": "chunked", "attention_chunk": 64}, 128),
    ("naive", {}, 64),
])
def test_attention_block_branches(branch, kw, s, monkeypatch):
    jc, tc = both(kw, arch="granite-8b")
    jp = jl.init_attention(KEY, jc)
    (x,) = arrays((2, s, 64))
    pos = np.arange(s)[None, :]
    # Each branch must be the one taken: fail the two others.
    import repro_torch.kernels.ops as ops

    def refuse(*a, **k):
        raise AssertionError("wrong attention branch")
    if branch != "flash":
        monkeypatch.setattr(ops, "flash_attention", refuse)
    if branch != "chunked":
        monkeypatch.setattr(tl, "chunked_attention", refuse)
    if branch != "naive":
        monkeypatch.setattr(tl, "mha_logits_to_out", refuse)
    want = jl.attention_block(jp, jnp.asarray(x), jc, jnp.asarray(pos))
    got = tl.attention_block(params_from_numpy(to_np(jp), "cpu"),
                             torch.from_numpy(x), tc, torch.from_numpy(pos))
    close(got, want)
