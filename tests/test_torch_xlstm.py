"""The port's sLSTM and mLSTM blocks and xlstm-350m against the JAX
package: ``_slstm_cell``, ``apply_slstm`` and ``apply_mlstm`` (outputs and
``jax.grad`` gradients, fp32 and bf16), ``_chunked_time_scan`` with
``time_chunk`` set, the decode steps token by token, the parameter and
state layouts, and the smoke model's logits, loss and every gradient with
remat and ``time_chunk`` on and off. Inputs come from numpy;
JAX-initialised weights are carried across."""
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
from repro_torch.tree import leaves, tree_map

ARCH = "xlstm-350m"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KEY = jax.random.PRNGKey(5)
BLOCKS = {"slstm": (jr.init_slstm, jr.apply_slstm, tr.apply_slstm),
          "mlstm": (jr.init_mlstm, jr.apply_mlstm, tr.apply_mlstm)}


def configs(**kw):
    return (jax_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


def carried(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def normal(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def close(got, want, tol=TOL["float32"]):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def grads_close(tp, jgrads, tol=TOL["float32"]):
    tree_map(lambda t, g: close(t.grad, g, tol), tp, jgrads)


# -- the sLSTM cell -----------------------------------------------------------


@pytest.mark.parametrize("first", [True, False], ids=["first-step", "mid"])
def test_slstm_cell_outputs_and_grads(first):
    """One step from the initial state (m = -1e30, where n is exactly 1 and
    ``max(n, 1)`` ties) and from a random state."""
    b, nh, hd = 2, 4, 16
    gx = normal((b, 4, nh, hd), seed=1)
    wh = normal((nh, hd, 4, hd), seed=2, scale=0.25)
    if first:
        h = c = n = np.zeros((b, nh, hd), np.float32)
        m = np.full((b, nh, hd), -1e30, np.float32)
    else:
        h, c = normal((b, nh, hd), 3), normal((b, nh, hd), 4)
        n = np.abs(normal((b, nh, hd), 5)) + 0.5
        m = normal((b, nh, hd), 6)
    args = [gx, h, c, n, m, wh]

    def f(*a):
        return sum(jnp.sum(o * (i + 1.0))
                   for i, o in enumerate(jr._slstm_cell(*a)[:3]))

    want = jr._slstm_cell(*map(jnp.asarray, args))
    jgrads = jax.grad(f, argnums=(0, 1, 2, 3, 5))(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = tr._slstm_cell(*targs)
    sum(((o * (i + 1.0)).sum() for i, o in enumerate(got[:3]))).backward()
    for g, w in zip(got, want):
        close(g, w)
    for t, g in zip([targs[i] for i in (0, 1, 2, 3, 5)], jgrads):
        close(t.grad, g)


# -- the blocks over a sequence -----------------------------------------------


def block_both(kind, dtype, s=16, time_chunk=0):
    """Outputs and gradients of one block, in both packages."""
    jc, tc = configs(dtype=dtype, time_chunk=time_chunk)
    jinit, japply, tapply = BLOCKS[kind]
    jp = jinit(KEY, jc)
    tp = carried(jp)
    x = normal((2, s, jc.d_model), seed=7)
    r = normal((2, s, jc.d_model), seed=9)      # the output's cotangent
    dt = jnp.dtype(dtype)

    def f(p, x):
        y = japply(p, x.astype(dt), jc)
        return jnp.sum(y.astype(jnp.float32) * r), y

    (_, want), (jgp, jgx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tapply(tp, tx.to(getattr(torch, dtype)), tc)
    (out.float() * torch.from_numpy(r)).sum().backward()
    return out, want, tp, tx, jgp, jgx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_apply_outputs_and_grads(kind, dtype):
    out, want, tp, tx, jgp, jgx = block_both(kind, dtype)
    assert out.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    close(out, want, tol)
    if dtype == "float32":
        close(tx.grad, jgx)
        grads_close(tp, jgp)
    else:
        # bf16 products round differently in the two packages; each
        # gradient within 2e-2 of its own norm
        def rel(t, g):
            g = np.asarray(g, np.float32)
            err = np.linalg.norm(t.detach().float().numpy() - g)
            assert err <= tol * max(np.linalg.norm(g), 1e-30)
        rel(tx.grad, jgx)
        tree_map(lambda t, g: rel(t.grad, g), tp, jgp)


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_chunked_time_scan(kind):
    """``time_chunk`` 4 at S = 16 (four rematerialised chunks): equal to
    the unchunked port, and within 1e-4 of the reference's chunked scan."""
    out, want, tp, tx, jgp, jgx = block_both(kind, "float32", time_chunk=4)
    close(out, want)
    close(tx.grad, jgx)
    grads_close(tp, jgp)
    # the same weights and input through the unchunked port
    _, tc = configs()
    tp0 = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    tx0 = tx.detach().clone().requires_grad_()
    ref = BLOCKS[kind][2](tp0, tx0, tc)
    (ref * torch.from_numpy(normal(ref.shape, seed=9))).sum().backward()
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(tx.grad, tx0.grad, atol=1e-6, rtol=1e-6)
    for a, b in zip(leaves(tp), leaves(tp0)):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=1e-6)


def test_chunked_time_scan_recomputes_each_chunk(monkeypatch):
    """The chunked branch runs each chunk under ``checkpoint``; the plain
    branch when S is not a multiple of the chunk, or not over it."""
    calls = []
    real = tr.checkpoint
    monkeypatch.setattr(tr, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    def cell(carry, x_t):
        carry = carry * 0.5 + x_t
        return carry, carry

    x = torch.randn(2, 16, 3, requires_grad=True)
    for chunk, n in ((4, 4), (5, 0), (16, 0), (0, 0)):
        calls.clear()
        carry, ys = tr._chunked_time_scan(cell, torch.zeros(2, 3), (x,), 16,
                                          chunk)
        assert len(calls) == n and ys.shape == (2, 16, 3)
        torch.testing.assert_close(carry, ys[:, -1])


# -- decode steps -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_steps_match_the_reference_and_the_sequence(kind):
    """12 tokens one at a time: each step against the reference's step, and
    the stacked outputs against ``apply_*`` over the sequence."""
    jc, tc = configs()
    jinit, japply, tapply = BLOCKS[kind]
    jp = jinit(KEY, jc)
    tp = carried(jp)
    jstep_fn = getattr(jr, f"step_{kind}")
    tstep_fn = getattr(tr, f"step_{kind}")
    jst = getattr(jr, f"init_{kind}_state")(jc, 2)
    tst = getattr(tr, f"init_{kind}_state")(tc, 2, device="cpu")
    x = normal((2, 12, jc.d_model), seed=8)
    step = jax.jit(lambda p, x, s: jstep_fn(p, x, s, jc))
    outs = []
    with torch.no_grad():
        for i in range(12):
            jy, jst = step(jp, jnp.asarray(x[:, i:i + 1]), jst)
            ty, tst = tstep_fn(tp, torch.from_numpy(x[:, i:i + 1]), tst, tc)
            close(ty, jy)
            for name in jst:
                assert tst[name].dtype == torch.float32
                close(tst[name], jst[name])
            outs.append(ty)
        full = tapply(tp, torch.from_numpy(x), tc)
    close(torch.cat(outs, 1), full.numpy())


# -- layouts ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_init_layouts(kind):
    jc, tc = configs()
    tp = getattr(tr, f"init_{kind}")(torch.Generator().manual_seed(0), tc)
    want = jax.tree_util.tree_map(
        lambda x: (x.shape, str(x.dtype)),
        jax.eval_shape(lambda k: BLOCKS[kind][0](k, jc), KEY))
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp) == want
    if kind == "mlstm":
        assert torch.equal(tp["lstm_bif"][0], torch.zeros(4))
        assert torch.equal(tp["lstm_bif"][1], torch.full((4,), 3.0))
    else:
        assert torch.equal(tp["lstm_b"], torch.zeros(4, 4, 16))


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_init_states(kind):
    jc, tc = configs()
    want = getattr(jr, f"init_{kind}_state")(jc, 3)
    got = getattr(tr, f"init_{kind}_state")(tc, 3, device="cpu")
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w))
    assert float(got["m"].max()) == float(np.float32(-1e30))


def test_param_count_full_width():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.padded_vocab) == (
        24, 1024, 4, 50688)
    assert tt.param_count_cfg(cfg) == jt.param_count(jax_config(ARCH)) \
        == 242_394_208


# -- the smoke model ----------------------------------------------------------


def batches(vocab, b, s, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})


def rel_norm(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.detach().float().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("dtype,remat,time_chunk", [
    ("float32", False, 0), ("float32", True, 0), ("float32", True, 4),
    ("float32", False, 4), ("bfloat16", True, 0), ("bfloat16", True, 4)])
def test_model_logits_loss_grads(dtype, remat, time_chunk):
    """4 layers (two groups of sLSTM, mLSTM) at S = 16. In fp32 the logits
    and every gradient within 1e-4 and the loss within 1e-5 relative.

    In bf16 each package rounds at its own places (XLA's CPU backend keeps
    excess precision between fused bf16 ops; with it off, both packages'
    bf16 logits are 0.016 from the fp32 ones on average), and the flips
    travel through four recurrent layers: the logits within 2e-2 of their
    norm, the loss within 2e-3 relative and each gradient within 5e-2 of
    its own norm (the bounds of the bf16 model check on the card)."""
    jc, tc = configs(dtype=dtype, remat=remat, time_chunk=time_chunk)
    assert (tc.n_layers, tc.pattern, tc.n_tail, tc.d_ff) == (
        4, ("slstm", "mlstm"), 0, 0)
    jp = jt.init_params(jax.random.PRNGKey(0), jc)
    tp = carried(jp)
    jb, tb = batches(jc.vocab, 2, 16)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                                 static_argnums=2)(jp, jb, jc)
    jlogits, _ = jax.jit(jt.forward, static_argnums=2)(jp, jb, jc)
    loss, metrics = tt.loss_fn(tp, tb, tc)
    loss.backward()
    with torch.no_grad():
        logits, _ = tt.forward(tp, tb, tc)
    assert logits.shape == (2, 16, tc.padded_vocab)
    assert logits.dtype == getattr(torch, dtype)
    if dtype == "float32":
        close(logits, jlogits)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(metrics["ce"].item(), float(jloss),
                                   rtol=1e-5)
        grads_close(tp, jgrads)
    else:
        v = tc.vocab
        assert rel_norm(logits[..., :v], np.asarray(jlogits)[..., :v]) \
            <= 2e-2
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-3)
        errs = tree_map(lambda t, g: rel_norm(t.grad, g), tp, jgrads)
        assert max(leaves(errs)) <= 5e-2
