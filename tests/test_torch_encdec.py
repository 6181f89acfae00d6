"""The port's encoder and cross-attention against the JAX package:
``cross_attention_block`` gated and ungated, Whisper's encoder with remat
on and off, the whisper-small and llama-3.2-vision-90b smoke models
(logits, loss and every gradient in fp32 and bf16), the cross K/V of the
decode state, the data pipeline's frame and patch stubs, the serve loop's
encoder states, the driver's restart and the FLOP count of both archs.

Inputs come from numpy; JAX-initialised weights are carried across, with
every ``xattn`` gate set to 0.5 in both packages: at the reference's init
the gate is 0, tanh(0) = 0, and the cross-attention would add nothing to
the residual, so a check at init would check none of it."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch import train as jax_train
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.configs.shapes import stub_inputs
from repro_torch.convert import params_from_numpy
from repro_torch.core import flop_count
from repro_torch.core.flop_count import count_step_flops
from repro_torch.data import DataState, SyntheticLM
from repro_torch.launch import serve, train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.optim import make_optimizer
from repro_torch.tree import leaves, tree_map

from test_torch_optim import carried_jax_run
from test_torch_serve import with_gates

KEY = jax.random.PRNGKey(3)
ARCHS = ["whisper-small", "llama-3.2-vision-90b"]
GATE = 0.5
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def normal(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def rel_norm(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.detach().float().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


def stub_name(cfg):
    return "frames" if cfg.encoder_layers else "enc_embed"


def setup(arch, gate=GATE, **kw):
    """(JAX config, port config, JAX params, port params): the JAX init
    with every gate at ``gate``, carried across."""
    jc = jax_config(arch, smoke=True).replace(**kw)
    tc = get_config(arch, smoke=True).replace(**kw)
    weights = with_gates(jax.tree_util.tree_map(
        np.asarray, jt.init_params(KEY, jc)), gate)
    return (jc, tc, jax.tree_util.tree_map(jnp.asarray, weights),
            params_from_numpy(weights, "cpu"))


def batches(cfg, b, s, seed=0, stub_seed=1):
    """The same numpy batch for both packages: tokens, labels and the
    arch's stub (0.1·N(0, 1)) in ``cfg.dtype``."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1))
    (shape, _), = stub_inputs(cfg, b).values()
    stub = normal(shape, stub_seed, 0.1)
    name = stub_name(cfg)
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32),
             name: jnp.asarray(stub).astype(JDT[cfg.dtype])},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:]),
             name: torch.from_numpy(stub).to(TDT[cfg.dtype])})


# -- layers -------------------------------------------------------------------


def test_init_attention_cross_has_a_zero_gate():
    cfg = get_config("llama-3.2-vision-90b", smoke=True)
    p = tl.init_attention(torch.Generator().manual_seed(0), cfg, cross=True)
    assert p["gate"].shape == () and p["gate"].dtype == torch.float32
    assert p["gate"].item() == 0.0
    assert "gate" not in tl.init_attention(torch.Generator(), cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [False, True])
def test_cross_attention_block_matches_jax(gated, dtype):
    """q from x (B, 8, d), k and v from enc (B, 12, d): no mask, no RoPE;
    GQA 2:1; the gate (0.5) multiplies as tanh(gate) rounded to x's
    dtype."""
    jc, tc = (f("llama-3.2-vision-90b", smoke=True).replace(dtype=dtype)
              for f in (jax_config, get_config))
    weights = with_gates(jax.tree_util.tree_map(
        np.asarray, jl.init_attention(KEY, jc, cross=True)), GATE)
    x, enc = normal((2, 8, jc.d_model), 1), normal((2, 12, jc.d_model), 2)
    want = jl.cross_attention_block(
        jax.tree_util.tree_map(jnp.asarray, weights),
        jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(enc).astype(
            JDT[dtype]), jc, gated=gated)
    with torch.no_grad():
        got = tl.cross_attention_block(
            params_from_numpy(weights, "cpu"),
            torch.from_numpy(x).to(TDT[dtype]),
            torch.from_numpy(enc).to(TDT[dtype]), tc, gated=gated)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [False, True])
def test_run_encoder_matches_jax(remat, dtype):
    """Whisper's encoder over 16 frames: learned positions, bidirectional
    attention, LayerNorm + GELU; the output and, in fp32, the gradients of
    every encoder leaf and of the frames."""
    jc, tc, jp, tp = setup("whisper-small", remat=remat, dtype=dtype)
    frames = normal((2, jc.encoder_len, jc.d_model), 4, 0.1)
    g = normal((2, jc.encoder_len, jc.d_model), 5)

    def jloss(p, f):
        return jnp.sum(jt._run_encoder(p, f, jc).astype(jnp.float32) * g)

    jf = jnp.asarray(frames).astype(JDT[dtype])
    want = jt._run_encoder(jp["encoder"], jf, jc)
    jgrads, jgf = jax.grad(jloss, argnums=(0, 1))(jp["encoder"], jf)
    tf = torch.from_numpy(frames).to(TDT[dtype]).requires_grad_()
    got = tt._run_encoder(tp["encoder"], tf, tc)
    (got.float() * torch.from_numpy(g)).sum().backward()
    assert got.dtype == TDT[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        tree_map(lambda t, w: np.testing.assert_allclose(
            t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4),
            tp["encoder"], jgrads)
        np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf),
                                   atol=1e-4, rtol=1e-4)
    else:
        assert rel_norm(got, want) <= 2e-2
        errs = tree_map(lambda t, w: rel_norm(t.grad, w), tp["encoder"],
                        jgrads)
        assert max(leaves(errs)) <= 2e-2


# -- the smoke models -----------------------------------------------------------


@pytest.mark.parametrize("dtype,remat", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_loss_grads(arch, dtype, remat):
    """The smoke model at S = 256 with the flash path on (its plain version
    on the CPU), gates at 0.5: fp32 logits and gradients within 1e-4, the
    loss 1e-5 relative; bf16 logits within 2e-2 of their norm, the loss 2e-2
    relative and each gradient 2e-2 of its own norm, but the gate's 5e-2
    (the bound of the other bf16 model tests): it is one sum over B·S·d
    bf16 products, and at these weights the reference's own bf16 gate
    gradient is 0.0325 of its fp32 one."""
    jc, tc, jp, tp = setup(arch, dtype=dtype, remat=remat,
                           use_flash_kernel=True)
    jb, tb = batches(jc, 2, 256)
    (jloss, _), jgrads = jax.jit(
        jax.value_and_grad(jt.loss_fn, has_aux=True), static_argnums=2)(
            jp, jb, jc)
    jlogits, _ = jax.jit(jt.forward, static_argnums=2)(jp, jb, jc)
    loss, metrics = tt.loss_fn(tp, tb, tc)
    loss.backward()
    with torch.no_grad():
        logits, _ = tt.forward(tp, tb, tc)
    v = tc.vocab
    assert logits.dtype == TDT[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        tree_map(lambda t, g: np.testing.assert_allclose(
            t.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-4), tp, jgrads)
    else:
        assert rel_norm(logits[..., :v], np.asarray(jlogits)[..., :v]) \
            <= 2e-2
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-2)
        errs = tree_map(lambda t, g: rel_norm(t.grad, g), tp, jgrads)
        gates = [slot["xattn"].pop("gate") for slot in errs["scan"].values()
                 if "gate" in slot.get("xattn", {})]
        assert max(leaves(errs)) <= 2e-2 and max(gates, default=0) <= 5e-2
    # the cross-attention is live: its weights and (llama) its gate have
    # gradients, and so has every encoder layer
    grads = tree_map(lambda t: float(t.grad.abs().max()), tp)
    for slot in grads["scan"].values():
        if "xattn" in slot:
            assert min(leaves(slot["xattn"])) > 0
    if tc.encoder_layers:
        assert min(leaves(grads["encoder"])) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_another_stub_moves_the_logits(arch):
    """A fresh draw of the frames / patch embeddings moves the fp32 logits
    by more than 10x the model check's tolerance (1e-4), in both
    packages, by the same amount."""
    jc, tc, jp, tp = setup(arch)
    moved = []
    for stub_seed in (1, 2):
        jb, tb = batches(jc, 2, 16, stub_seed=stub_seed)
        jlogits, _ = jt.forward(jp, jb, jc)
        with torch.no_grad():
            logits, _ = tt.forward(tp, tb, tc)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
        moved.append((logits[..., :tc.vocab], np.asarray(jlogits)))
    (a, ja), (b, jb_) = moved
    assert (a - b).abs().max() > 10 * 1e-4
    np.testing.assert_allclose((a - b).numpy(), (ja - jb_)[..., :tc.vocab],
                               atol=1e-4)


def test_zero_gate_leaves_the_logits_unchanged():
    """At the reference's init (every gate 0) the patch embeddings reach
    nothing: another draw leaves the logits bit-equal, in both packages."""
    jc, tc, jp, tp = setup("llama-3.2-vision-90b", gate=0.0)
    outs = []
    for stub_seed in (1, 2):
        jb, tb = batches(jc, 2, 16, stub_seed=stub_seed)
        with torch.no_grad():
            outs.append((tt.forward(tp, tb, tc)[0],
                         np.asarray(jt.forward(jp, jb, jc)[0])))
    assert torch.equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_the_same_gradients(arch):
    """The encoder runs under its own checkpoint a layer and the decoder
    groups under theirs, with ``enc`` an input of each group: every
    gradient, the encoder's included, equals the one without remat."""
    _, tc, _, tp = setup(arch)
    _, tb = batches(tc, 2, 16)
    grads = []
    for remat in (False, True):
        loss, _ = tt.loss_fn(tp, tb, tc.replace(remat=remat))
        grads.append(torch.autograd.grad(loss, list(leaves(tp))))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_and_stub_forward(arch):
    """The port's own init: the reference's keys and shapes (``param_shapes``
    included), a zero gate on each ``xattn`` layer, and a finite forward on
    the pipeline's batch."""
    tc = get_config(arch, smoke=True)
    tp = tt.init_params(torch.Generator().manual_seed(0), tc)
    want = jax.tree_util.tree_map(lambda x: x.shape,
                                  jt.param_shapes(jax_config(arch,
                                                             smoke=True)))
    assert tree_map(lambda t: tuple(t.shape), tp) == want
    assert tt.param_shapes(tc) == want
    assert tt.param_count(tp) == tt.param_count_cfg(tc)
    gates = [slot["xattn"]["gate"] for slot in tp["scan"].values()
             if "gate" in slot.get("xattn", {})]
    assert sum(g.numel() for g in gates) == (
        tc.n_groups if arch != "whisper-small" else 0)
    assert all(float(g.detach().abs().max()) == 0 for g in gates)
    batch = SyntheticLM(tc, 2, 16, seed=0).next_batch()
    with torch.no_grad():
        logits, _ = tt.forward(tp, batch, tc)
    assert logits.shape == (2, 16, tc.padded_vocab)
    assert torch.isfinite(logits[..., :tc.vocab]).all()


# -- decode ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_precompute_cross_kv_matches_jax(arch):
    """The cross K/V slots against the reference's, written in place into
    the state's own tensors: the state ``serve_step`` then updates, never a
    view of ``enc``."""
    jc, tc, jp, tp = setup(arch)
    jb, tb = batches(jc, 2, 8)
    jenc = jt._get_encoder_states(jp, jb, jc)
    jstate = jt.precompute_cross_kv(jp, jt.init_decode_state(jc, 2, 8),
                                    jenc.astype(jc.dtype), jc)
    state = tt.init_decode_state(tc, 2, 8, device="cpu")
    ptrs = [x.data_ptr() for x in leaves(state)]
    with torch.no_grad():
        enc = tt._get_encoder_states(tp, tb, tc)
    out = tt.precompute_cross_kv(tp, state, enc, tc)
    assert out is state and [x.data_ptr() for x in leaves(out)] == ptrs
    n = 0
    for part in ("scan", "tail"):
        for key, st in state.get(part, {}).items():
            for name in ("xk", "xv"):
                if name in st:
                    np.testing.assert_allclose(
                        st[name].numpy(), np.asarray(jstate[part][key][name]),
                        atol=1e-5, rtol=1e-5)
                    n += 1
    assert n == 2 * (len(tc.pattern) if arch == "whisper-small" else 1)
    before = [x.clone() for x in leaves(state)]
    enc.add_(1.0)                               # the encoder states move
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(state)))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_bf16_matches_jax(arch):
    """bf16 decode with the cross K/V filled, 8 steps, against JAX within
    2e-2 of max(|logits|, 1) over the real vocab."""
    jc, tc, jp, tp = setup(arch, dtype="bfloat16")
    jb, tb = batches(jc, 2, 8)
    jstate = jt.precompute_cross_kv(
        jp, jt.init_decode_state(jc, 2, 8),
        jt._get_encoder_states(jp, jb, jc).astype(jc.dtype), jc)
    with torch.no_grad():
        state = tt.precompute_cross_kv(
            tp, tt.init_decode_state(tc, 2, 8, device="cpu"),
            tt._get_encoder_states(tp, tb, tc).to(torch.bfloat16), tc)
    jstep = jax.jit(lambda p, s, t: jt.serve_step(p, s, t, jc))
    for i in range(8):
        jlog, jstate = jstep(jp, jstate, jb["tokens"][:, i])
        got, state = tt.serve_step(tp, state, tb["tokens"][:, i], tc)
        assert got.dtype == torch.bfloat16
        want = np.asarray(jlog, np.float32)[:, :tc.vocab]
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got.float().numpy()[:, :tc.vocab], want,
                                   atol=2e-2 * scale, rtol=0)


def test_serve_step_adds_the_learned_position():
    """Whisper's decoder adds ``pos_embed[pos]`` to the scaled embedding: a
    table whose row 3 is moved leaves the logits of steps 0-2 bit-equal and
    moves step 3's."""
    _, tc, _, tp = setup("whisper-small")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                              (2, 4)))
    moved = dict(tp, pos_embed=tp["pos_embed"].detach().clone())
    # not a uniform shift, which every LayerNorm would remove
    moved["pos_embed"][3] += torch.from_numpy(normal((tc.d_model,), 1))
    outs = []
    for params in (tp, moved):
        state = tt.init_decode_state(tc, 2, 4, device="cpu")
        steps = []
        for i in range(4):
            li, state = tt.serve_step(params, state, toks[:, i], tc)
            steps.append(li)
        outs.append(steps)
    for i in range(3):
        assert torch.equal(outs[0][i], outs[1][i])
    assert (outs[0][3] - outs[1][3]).abs().max() > 1e-2


# -- data pipeline --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_stub_shape_and_dtype(arch, dtype):
    """The reference's oracle (``test_checkpoint_data.py``): ``frames`` of
    (B, encoder_len, d) for whisper, ``enc_embed`` of (B, cross_len, d) for
    llama, in ``cfg.dtype``, with a spread of 0.1."""
    cfg = get_config(arch, smoke=True).replace(dtype=dtype)
    b = SyntheticLM(cfg, 2, 16, seed=0).next_batch()
    name = stub_name(cfg)
    assert set(b) == {"tokens", "labels", name}
    assert tuple(b[name].shape) == (2, cfg.encoder_len or cfg.cross_len,
                                    cfg.d_model)
    assert b[name].dtype == TDT[dtype]
    jb = JaxSyntheticLM(jax_config(arch, smoke=True).replace(dtype=dtype),
                        2, 16, seed=0).next_batch()
    assert tuple(b[name].shape) == jb[name].shape
    assert str(b[name].dtype).split(".")[1] == str(jb[name].dtype)
    assert abs(float(b[name].float().std()) - 0.1) < 0.01


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_stubs_are_pure_functions_of_seed_step_shard(arch):
    """Each batch's stub is drawn from the batch's own generator: a resumed
    pipeline repeats it, another step, seed or shard draws another, and a
    re-sharded pipeline's shard is that shard's rows of nothing else."""
    cfg = get_config(arch, smoke=True)
    name = stub_name(cfg)
    a = SyntheticLM(cfg, 4, 8, seed=3)
    b1, b2 = a.next_batch(), a.next_batch()
    c = SyntheticLM(cfg, 4, 8, seed=3)
    c.load_state_dict(DataState(3, 1, 0, 1).as_dict())
    assert torch.equal(c.next_batch()[name], b2[name])
    assert not torch.equal(b1[name], b2[name])
    assert not torch.equal(
        SyntheticLM(cfg, 4, 8, seed=4).next_batch()[name], b1[name])
    s0 = SyntheticLM(cfg, 4, 8, seed=3, shard=0, num_shards=2)
    s1 = SyntheticLM(cfg, 4, 8, seed=3, shard=1, num_shards=2)
    x0, x1 = s0.next_batch()[name], s1.next_batch()[name]
    assert x0.shape[0] == 2 and not torch.equal(x0, x1)
    s1.load_state_dict(s0.state_dict(), shard=1, num_shards=2)
    assert s1.state.step == 1 and s1.state.shard == 1
    again = SyntheticLM(cfg, 4, 8, seed=3, shard=1, num_shards=2)
    again.next_batch()
    assert torch.equal(s1.next_batch()[name], again.next_batch()[name])


# -- the drivers ----------------------------------------------------------------


def serve_args(**kw):
    ns = serve.build_argparser().parse_args([])
    base = dict(batch=2, prompt_len=8, gen=8, device="cpu")
    base.update(kw)
    return argparse.Namespace(**{**vars(ns), **base})


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_run_returns_its_stubs_and_decode_meets_forward(arch,
                                                              monkeypatch):
    """``serve.run`` fills the cross K/V from its prompt batch and returns
    that batch's stub; ``forward`` on the prompt and the generated ids with
    that stub meets every served position's logits (the reference's
    teacher-forced bound, fp32), and within a tenth of what another draw of
    the stub moves them by, so the check sees the cross-attention; gates
    set to 0.5 in the served weights."""
    real = serve.init_params

    def gated(gen, cfg):
        p = real(gen, cfg)
        with torch.no_grad():
            for slot in p["scan"].values():
                if "gate" in slot.get("xattn", {}):
                    slot["xattn"]["gate"].fill_(GATE)
        return p

    monkeypatch.setattr(serve, "init_params", gated)
    res = serve.run(serve_args(arch=arch))
    cfg, params = res["config"], res["params"]
    name = stub_name(cfg)
    assert set(res["stubs"]) == {name}
    want = SyntheticLM(cfg, 2, 8, seed=0).next_batch()
    assert torch.equal(res["stubs"][name], want[name])
    assert torch.equal(res["prompts"], want["tokens"])
    toks = torch.cat([res["prompts"], res["ids"]], dim=1)
    another = 0.1 * torch.randn(res["stubs"][name].shape,
                                generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        full, _ = tt.forward(params, {"tokens": toks, **res["stubs"]}, cfg)
        other, _ = tt.forward(params, {"tokens": toks, name: another}, cfg)
        enc = tt._get_encoder_states(params, res["stubs"], cfg)
    state = tt.precompute_cross_kv(
        params, tt.init_decode_state(cfg, 2, 16, device="cpu"), enc, cfg)
    v = cfg.vocab
    moved = float((other - full)[..., :v].abs().max())
    scale = max(float(full[..., :v].abs().max()), 1.0)
    errs = []
    for i in range(16):
        li, state = tt.serve_step(params, state, toks[:, i], cfg)
        errs.append(float((li - full[:, i])[:, :v].abs().max()))
        if 7 <= i < 15:
            assert torch.equal(li.argmax(-1), res["ids"][:, i - 7])
    assert max(errs) < 2e-2 * scale and 10 * max(errs) < moved


def test_whisper_restart_tracks_the_jax_train_loop(monkeypatch, tmp_path):
    """``repro.launch.train``'s uninterrupted whisper-small run against the
    port's run crashed at step 9 and resumed, from the JAX init and batches
    (frames included): the last loss within 1e-4 relative."""
    carried_jax_run(monkeypatch, "whisper-small")
    base = ["--arch", "whisper-small", "--steps", "12", "--ckpt-every", "4",
            "--batch", "2", "--seq", "16", "--log-every", "100"]
    want = jax_train.run(jax_train.build_argparser().parse_args(base))
    argv = [*base, "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="simulated node failure"):
        train.run(train.build_argparser().parse_args([*argv, "--fail-at",
                                                      "9"]))
    got = train.run(train.build_argparser().parse_args(argv))
    assert got["steps"] == 3
    assert got["last_loss"] == pytest.approx(want["last_loss"], rel=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_train_flops_on_fake_tensors_equals_the_cpu_count(arch):
    """``count_train_flops`` builds the arch's stubs as fake tensors and
    counts what one step counts on real CPU tensors, the flash path on."""
    cfg = get_config(arch, smoke=True).replace(remat=True,
                                               use_flash_kernel=True)
    opt = make_optimizer("adamw", lr=1e-3)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg)
    batch = SyntheticLM(cfg, 2, 256, seed=0).next_batch()
    want = count_step_flops(make_train_step(cfg, opt), params,
                            opt.init(params), batch)
    assert flop_count.count_train_flops(cfg, 2, 256) == want


def test_encoder_flops_are_counted_over_its_frames():
    """Whisper's encoder is counted over ``encoder_len`` frames, whatever
    the decoder's S: with 16 more frames the step gains what the encoder's
    products (the plain attention's two, 2·B·H·T²·D each) and the decoder's
    cross-attention (K/V products and scores) add for them: 4x their
    forward count (forward, remat recompute, backward), less the recompute
    of each encoder layer's last product, which the checkpoint skips as
    nothing in the backward needs its output (XLA drops it as dead)."""
    base = get_config("whisper-small", smoke=True).replace(remat=True)
    b, d, f, h, hd = 2, base.d_model, base.d_ff, base.n_heads, base.head_dim
    kv = base.n_kv * hd
    per_frame = 2 * (2 * d * h * hd + 2 * d * kv + 2 * d * f)

    def encoder(t):
        return base.encoder_layers * (b * t * per_frame
                                      + 2 * 2 * b * h * t * t * hd)
    # per frame and decoder layer: K and V, and the S = 16 queries' scores
    # and values
    cross = base.n_layers * (2 * 2 * b * d * kv + 2 * 2 * b * h * 16 * hd)
    last = base.encoder_layers * 2 * b * 16 * f * d
    got = (flop_count.count_train_flops(base.replace(encoder_len=32), 2, 16)
           - flop_count.count_train_flops(base, 2, 16))
    assert got == 4 * (encoder(32) - encoder(16) + 16 * cross) - last
