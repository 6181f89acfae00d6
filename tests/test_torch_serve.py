"""The port's decode path against the JAX package: ``decode_attention`` (full
cache and a wrapping ring), ``step_rglru`` and the conv state,
``serve_step`` step by step for the ten archs, decode with teacher forcing
against ``forward``, the decode state's layout, the prefill and grad step
factories and the CPU serve loop. Inputs come from numpy; JAX-initialised
weights are carried across. The cross-attention archs' decode states get
their cross K/V from a numpy stub (whisper-small's frames through its
encoder, llama-3.2-vision-90b's patch embeddings), and every ``xattn``
gate is set to 0.5 in both packages: at 0 the cross-attention adds
nothing."""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch import serve as jax_serve
from repro.launch.steps import make_grad_step as jax_grad_step
from repro.models import layers as jl
from repro.models import recurrent as jr
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.steps import (make_grad_step, make_prefill_step,
                                      make_serve_step)
from repro_torch.models import layers as tl
from repro_torch.models import recurrent as tr
from repro_torch.models import transformer as tt
from repro_torch.tree import leaves, tree_map

TOL = 1e-5
KEY = jax.random.PRNGKey(7)
ARCHS = ["gemma-7b", "granite-8b", "phi4-mini-3.8b", "starcoder2-7b",
         "recurrentgemma-2b", "xlstm-350m", "deepseek-moe-16b", "arctic-480b",
         "whisper-small", "llama-3.2-vision-90b"]
GATE = 0.5


def with_gates(tree, value=GATE):
    """A tree with every ``gate`` leaf (an ``xattn`` layer's) at ``value``."""
    if isinstance(tree, dict):
        return {k: (np.full_like(np.asarray(v), value) if k == "gate"
                    else with_gates(v, value)) for k, v in tree.items()}
    return tree


def carried(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def stubs(cfg, b, seed=9):
    """The arch's frame or patch stub (0.1·N(0, 1), fp32) as numpy, keyed as
    in a batch; empty for a decoder-only arch."""
    if cfg.encoder_layers:
        return {"frames": normal((b, cfg.encoder_len, cfg.d_model), seed)
                * np.float32(0.1)}
    if cfg.cross_len:
        return {"enc_embed": normal((b, cfg.cross_len, cfg.d_model), seed)
                * np.float32(0.1)}
    return {}


def jax_cross_state(jc, jp, stub, state):
    if not jc.cross_len:
        return state
    enc = jt._get_encoder_states(
        jp, {k: jnp.asarray(v) for k, v in stub.items()}, jc)
    return jt.precompute_cross_kv(jp, state, enc.astype(jc.dtype), jc)


def port_cross_state(tc, tp, stub, state):
    if not tc.cross_len:
        return state
    with torch.no_grad():
        enc = tt._get_encoder_states(
            tp, {k: torch.from_numpy(v) for k, v in stub.items()}, tc)
    return tt.precompute_cross_kv(tp, state, enc.to(tl.dtype_of(tc.dtype)),
                                  tc)


def normal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def setup(arch, capacity_factor=None, **kw):
    jc = jax_config(arch, smoke=True).replace(**kw)
    tc = get_config(arch, smoke=True).replace(**kw)
    if capacity_factor is not None:
        jc, tc = (c.replace(moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (jc, tc))
    jp = jax.tree_util.tree_map(jnp.asarray, with_gates(
        jax.tree_util.tree_map(np.asarray, jt.init_params(KEY, jc))))
    return jc, tc, jp, carried(jp)


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("window,max_len", [(0, 12), (4, 12)])
def test_decode_attention_steps(window, max_len):
    """12 steps; with a window of 4 the ring of 4 slots wraps twice."""
    jc = jax_config("gemma-7b", smoke=True)
    tc = get_config("gemma-7b", smoke=True)
    jp = jl.init_attention(KEY, jc)
    tp = carried(jp)
    jcache = jl.init_kv_cache(jc, 2, max_len, 1, window=window)
    tcache = tl.init_kv_cache(tc, 2, max_len, 1, window=window,
                              device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    jk, jv = jcache["k"][0], jcache["v"][0]
    tk, tv = tcache["k"][0], tcache["v"][0]
    step = jax.jit(lambda p, x, k, v, pos: jl.decode_attention(
        p, x, k, v, pos, jc, window=window))
    for i in range(12):
        x = normal((2, 1, jc.d_model), seed=i)
        jy, jk, jv = step(jp, jnp.asarray(x), jk, jv, jnp.int32(i))
        with torch.no_grad():
            ty, tk2, tv2 = tl.decode_attention(
                tp, torch.from_numpy(x), tk, tv,
                torch.tensor(i, dtype=torch.int32), tc, window=window)
        assert tk2 is tk and tv2 is tv          # written in place
        close(ty, jy)
        close(tk, jk)
        close(tv, jv)


@pytest.mark.parametrize("softcap", [0.0, 2.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_logits_to_out_softcap(softcap, dtype):
    jc, tc = (f("gemma-7b", smoke=True).replace(scores_dtype=dtype)
              for f in (jax_config, get_config))
    q, k, v = (normal(s, seed=i) * 3 for i, s in
               enumerate([(2, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16)]))
    mask = np.tril(np.ones((8, 8), bool))[None, None]
    want = jl.mha_logits_to_out(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask), jc,
                                softcap=softcap)
    got = tl.mha_logits_to_out(*(torch.from_numpy(a) for a in (q, k, v)),
                               torch.from_numpy(mask), tc, softcap=softcap)
    close(got, want, tol=TOL if dtype == "float32" else 1e-2)


# -- recurrent ----------------------------------------------------------------


def test_causal_conv_with_state():
    w, x, st = normal((4, 64)), normal((2, 5, 64), 1), normal((2, 3, 64), 2)
    for dt in (jnp.float32, jnp.bfloat16):
        want = jr._causal_conv(jnp.asarray(x).astype(dt), jnp.asarray(w),
                               state=jnp.asarray(st))
        got = tr._causal_conv(torch.from_numpy(x).to(getattr(torch,
                                                             dt.__name__)),
                              torch.from_numpy(w), state=torch.from_numpy(st))
        assert str(got.dtype).endswith(dt.__name__)
        close(got, want, tol=TOL if dt == jnp.float32 else 2e-2)


def test_step_rglru_steps():
    jc = jax_config("recurrentgemma-2b", smoke=True)
    tc = get_config("recurrentgemma-2b", smoke=True)
    jp = jr.init_rglru(KEY, jc)
    tp = carried(jp)
    jst = jr.init_rglru_state(jc, 2)
    tst = tr.init_rglru_state(tc, 2, device="cpu")
    step = jax.jit(lambda p, x, s: jr.step_rglru(p, x, s, jc))
    for i in range(12):
        x = normal((2, 1, jc.d_model), seed=i)
        jy, jst = step(jp, jnp.asarray(x), jst)
        with torch.no_grad():
            ty, tst = tr.step_rglru(tp, torch.from_numpy(x), tst, tc)
        close(ty, jy)
        for name in ("h", "conv"):
            assert tst[name].dtype == torch.float32
            close(tst[name], jst[name])


# -- serve_step ---------------------------------------------------------------


def serve_both(arch, steps, **kw):
    jc, tc, jp, tp = setup(arch, **kw)
    toks = tokens(jc.vocab, 2, steps)
    stub = stubs(jc, 2)
    jstate = jax_cross_state(jc, jp, stub, jt.init_decode_state(jc, 2, steps))
    tstate = port_cross_state(tc, tp, stub, tt.init_decode_state(
        tc, 2, steps, device="cpu"))
    jstep = jax.jit(lambda p, s, t: jt.serve_step(p, s, t, jc))
    for i in range(steps):
        jl_, jstate = jstep(jp, jstate, jnp.asarray(toks[:, i], jnp.int32))
        tl_, tstate = tt.serve_step(tp, tstate, torch.from_numpy(toks[:, i]),
                                    tc)
        yield tl_, jl_


def logits_close(got, want, vocab, tol):
    """Within ``tol * max(|logits|, 1)`` over the real vocab (the padded
    tail holds a huge negative that would make any bound vacuous), and the
    padded tail equal."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want[..., :vocab]).max()), 1.0)
    np.testing.assert_allclose(got[..., :vocab], want[..., :vocab],
                               atol=tol * scale, rtol=0)
    np.testing.assert_array_equal(got[..., vocab:], want[..., vocab:])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_jax(arch):
    vocab = get_config(arch, smoke=True).vocab
    for got, want in serve_both(arch, 12):
        logits_close(got, want, vocab, TOL)


def test_serve_step_ring_wraps_matches_jax():
    """recurrentgemma-2b with a window of 4: its local ring wraps twice."""
    vocab = get_config("recurrentgemma-2b", smoke=True).vocab
    for got, want in serve_both("recurrentgemma-2b", 12, window=4):
        logits_close(got, want, vocab, TOL)


def test_serve_step_bf16_gemma_matches_jax():
    """bf16, at widths whose embedding scale sqrt(96) and attention scale
    1/sqrt(24) are not bf16 numbers: both are weak scalars in JAX."""
    vocab = get_config("gemma-7b", smoke=True).vocab
    for got, want in serve_both("gemma-7b", 8, dtype="bfloat16", d_model=96,
                                head_dim=24):
        assert got.dtype == torch.bfloat16
        logits_close(got, want, vocab, 2e-2)


@pytest.mark.parametrize("arch,heads", [("deepseek-moe-16b", {}),
                                        ("arctic-480b",
                                         {"n_heads": 14, "n_kv": 2})])
def test_serve_step_bf16_moe_matches_jax(arch, heads):
    """bf16 decode of the MoE archs at the capacity factor that drops
    nothing (E/k), the same widths as the gemma case; arctic-480b with 7
    query heads a kv head, as at its full width."""
    moe = get_config(arch, smoke=True).moe
    for got, want in serve_both(arch, 8, dtype="bfloat16", d_model=96,
                                head_dim=24, **heads,
                                capacity_factor=moe.num_experts / moe.top_k):
        assert got.dtype == torch.bfloat16
        logits_close(got, want, 256, 2e-2)


def test_serve_step_bf16_weak_scalars_bit_equal_jax(monkeypatch):
    """The two weak scalars of a bf16 ``serve_step`` bit for bit: the
    embedding scale sqrt(96) (9.80 in fp32, 9.8125 in bf16) and a softcap
    of 5.3 (5.3125 in bf16). The blocks' weights are zero, so each block
    adds an exact 0 and the final norm sees the scaled embedding; the two
    tokens' embedding rows have one nonzero each, so every logit is one
    product, exact in both packages, and the softcap is the only rounding
    after the norm."""
    jc, tc, jp, _ = setup("gemma-7b", dtype="bfloat16", d_model=96,
                          head_dim=24, logits_softcap=5.3)
    rng = np.random.default_rng(11)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    np_params["scan"] = jax.tree_util.tree_map(np.zeros_like,
                                               np_params["scan"])
    toks = np.array([3, 200])
    embed = (rng.standard_normal(np_params["embed"].shape) * 0.4).astype(
        np.float32)
    embed[toks] = 0.0
    embed[toks, [5, 60]] = [0.7, -1.3]
    np_params["embed"] = embed
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu")

    def recording(module, params, seen):
        real = module.apply_norm

        def apply_norm(p, x, cfg):
            if p is params["final_norm"]:
                seen.append(x)
            return real(p, x, cfg)
        monkeypatch.setattr(module, "apply_norm", apply_norm)

    jseen, tseen = [], []
    recording(jt, jp, jseen)
    recording(tt, tp, tseen)
    jlogits, _ = jt.serve_step(jp, jt.init_decode_state(jc, 2, 4),
                               jnp.asarray(toks, jnp.int32), jc)
    tlogits, _ = tt.serve_step(tp, tt.init_decode_state(tc, 2, 4,
                                                        device="cpu"),
                               torch.from_numpy(toks), tc)

    def bits(x):
        if isinstance(x, torch.Tensor):
            return x.view(torch.int16).numpy()
        return np.asarray(x).view(np.int16)

    assert tseen[0].dtype == tlogits.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(tseen[0]), bits(jseen[0]))
    assert np.abs(np.asarray(jlogits, np.float32)[:, :tc.vocab]).max() > 4
    np.testing.assert_array_equal(bits(tlogits), bits(jlogits))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_teacher_forced_matches_forward(arch):
    """The reference's bound (``test_models.py``), on the port alone, over
    the real vocab. An MoE arch runs at a capacity factor of E/k, where
    nothing drops (C = G in the forward, C = B in decode): at its own
    factor the forward drops assignments that decode keeps, in the
    reference too (``test_torch_moe.py``, ROADMAP §3). A cross-attention
    arch's forward and decode read one stub, its gates at 0.5."""
    tc = get_config(arch, smoke=True)
    if tc.moe is not None:
        tc = tc.replace(moe=dataclasses.replace(
            tc.moe, capacity_factor=tc.moe.num_experts / tc.moe.top_k))
    tp = params_from_numpy(with_gates(tree_map(
        lambda t: t.detach().numpy(),
        tt.init_params(torch.Generator().manual_seed(0), tc))), "cpu")
    b, s = 2, 8
    toks = torch.from_numpy(tokens(tc.vocab, b, s, seed=3))
    stub = stubs(tc, b)
    with torch.no_grad():
        full, _ = tt.forward(tp, {"tokens": toks, **{
            k: torch.from_numpy(v) for k, v in stub.items()}}, tc)
    state = port_cross_state(tc, tp, stub,
                             tt.init_decode_state(tc, b, s, device="cpu"))
    for i in range(s):
        li, state = tt.serve_step(tp, state, toks[:, i], tc)
        logits_close(li, full[:, i].numpy(), tc.vocab, 2e-2)
    assert int(state["pos"]) == s


def test_serve_step_writes_the_cache_in_place():
    tc = get_config("recurrentgemma-2b", smoke=True)
    tp = tt.init_params(torch.Generator().manual_seed(0), tc)
    state = tt.init_decode_state(tc, 2, 12, device="cpu")
    ptrs = [x.data_ptr() for x in leaves({k: state[k]
                                          for k in ("scan", "tail")})]
    for i in range(3):
        _, state = tt.serve_step(tp, state, torch.tensor([i, i + 1]), tc)
    assert [x.data_ptr() for x in leaves({k: state[k] for k in
                                          ("scan", "tail")})] == ptrs
    assert state["scan"]["s2_local"]["k"][:, :, :3].abs().sum() > 0
    assert state["scan"]["s2_local"]["k"][:, :, 3:].abs().sum() == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_shapes_match_jax(arch):
    jc, tc = jax_config(arch), get_config(arch)
    want = jax.eval_shape(lambda: jt.init_decode_state(jc, 8, 4096))
    got = tt.decode_state_shapes(tc, 8, 4096)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(list(leaves(got)))
    for path, leaf in flat:
        t = got
        for p in path:
            t = t[p.key]
        assert t.device.type == "meta"
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), path


# -- step factories -----------------------------------------------------------


def test_prefill_step_equals_forward():
    _, tc, _, tp = setup("gemma-7b")
    batch = {"tokens": torch.from_numpy(tokens(tc.vocab, 2, 16))}
    logits = make_prefill_step(tc)(tp, batch)
    assert logits.is_inference() and not logits.requires_grad
    with torch.no_grad():
        want, _ = tt.forward(tp, batch, tc)
    assert torch.equal(logits, want)


def test_serve_step_factory_is_serve_step():
    _, tc, _, tp = setup("gemma-7b")
    tok = torch.tensor([1, 2])
    a, _ = make_serve_step(tc)(
        tp, tt.init_decode_state(tc, 2, 4, device="cpu"), tok)
    b, _ = tt.serve_step(tp, tt.init_decode_state(tc, 2, 4, device="cpu"),
                         tok, tc)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["gemma-7b", "recurrentgemma-2b",
                                  "xlstm-350m", "deepseek-moe-16b",
                                  "arctic-480b", "whisper-small",
                                  "llama-3.2-vision-90b"])
def test_grad_step_matches_jax(arch):
    jc, tc, jp, tp = setup(arch)
    toks = tokens(jc.vocab, 2, 33, seed=1)
    stub = stubs(jc, 2)
    jgrads, jm = jax.jit(jax_grad_step(jc))(jp, {
        "tokens": jnp.asarray(toks[:, :-1], jnp.int32),
        "labels": jnp.asarray(toks[:, 1:], jnp.int32),
        **{k: jnp.asarray(v) for k, v in stub.items()}})
    grads, metrics = make_grad_step(tc)(tp, {
        "tokens": torch.from_numpy(toks[:, :-1]),
        "labels": torch.from_numpy(toks[:, 1:]),
        **{k: torch.from_numpy(v) for k, v in stub.items()}})
    assert set(metrics) == set(jm)
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    tree_map(lambda t, g: np.testing.assert_allclose(
        t.numpy(), np.asarray(g), atol=1e-4, rtol=1e-4), grads, jgrads)


# -- the serve loop -----------------------------------------------------------


def args(**kw):
    ns = serve.build_argparser().parse_args([])
    base = dict(batch=2, prompt_len=8, gen=8, device="cpu")
    base.update(kw)
    return argparse.Namespace(**{**vars(ns), **base})


@pytest.mark.parametrize("arch", ["gemma-7b", "recurrentgemma-2b",
                                  "xlstm-350m", "whisper-small",
                                  "llama-3.2-vision-90b"])
def test_serve_run_matches_jax_serve(arch, monkeypatch, capsys):
    """The JAX serve loop's greedy ids, from its own seeded weights and
    prompt batch (with its frames or patch embeddings) carried into the
    port's serve loop (the two packages' random streams differ); the JAX
    loop's gates set to 0.5 as it initialises them."""
    real_init = jax_serve.init_params
    monkeypatch.setattr(jax_serve, "init_params", lambda key, cfg: with_gates(
        real_init(key, cfg)))
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--batch", "2",
                                     "--prompt-len", "8", "--gen", "8"])
    jax_serve.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    want = eval(line.split(":", 1)[1])
    jc = jax_config(arch, smoke=True)
    jp = with_gates(jax.tree_util.tree_map(
        np.asarray, jt.init_params(jax.random.PRNGKey(0), jc)))
    batch = {k: np.asarray(v) for k, v in JaxSyntheticLM(
        jc, 2, 8, seed=0).next_batch().items()}

    class Prompts:
        def __init__(self, *a, **k):
            pass

        def next_batch(self):
            return {k: torch.from_numpy(v.astype(
                np.int64 if k in ("tokens", "labels") else np.float32))
                for k, v in batch.items()}

    monkeypatch.setattr(serve, "init_params",
                        lambda gen, cfg: params_from_numpy(jp, "cpu"))
    monkeypatch.setattr(serve, "SyntheticLM", Prompts)
    res = serve.run(args(arch=arch))
    assert res["ids"].shape == (2, 8)
    assert res["ids"][0].tolist() == want
    assert len(res["prefill_seconds"]) == len(res["decode_seconds"]) == 8


@pytest.mark.parametrize("arch,layers", [("gemma-7b", 1),
                                         ("recurrentgemma-2b", 4),
                                         ("xlstm-350m", 2),
                                         ("arctic-480b", 1),
                                         ("whisper-small", 1),
                                         ("llama-3.2-vision-90b", 5)])
def test_serve_run_layers_and_what_it_served(arch, layers):
    """``--layers`` cuts the depth; ``run`` returns the prompts, the stubs
    and the weights it served, and feeding the prompt and the generated ids
    back through ``serve_step`` (the cross K/V filled from those stubs)
    reproduces every greedy id."""
    res = serve.run(args(arch=arch, layers=layers))
    cfg = res["config"]
    assert cfg.n_layers == layers
    assert res["prompts"].shape == (2, 8)
    toks = torch.cat([res["prompts"], res["ids"]], dim=1)
    state = port_cross_state(
        cfg, res["params"], {k: v.numpy() for k, v in res["stubs"].items()},
        tt.init_decode_state(cfg, 2, 16, device="cpu"))
    greedy = []
    for i in range(16):
        logits, state = tt.serve_step(res["params"], state, toks[:, i], cfg)
        greedy.append(logits.argmax(-1))
    assert torch.equal(torch.stack(greedy[7:15], dim=1), res["ids"])


def test_serve_run_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.run(args(device="cuda"))


def test_serve_argparser_defaults_match_jax(monkeypatch):
    import repro.launch.serve as js
    seen = {}

    class Stop(Exception):
        pass

    def capture(self, *a, **k):
        seen.update(vars(real(self, *a, **k)))
        raise Stop

    real = argparse.ArgumentParser.parse_args
    monkeypatch.setattr("sys.argv", ["serve"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Stop):
        js.main()
    monkeypatch.undo()
    ours = vars(serve.build_argparser().parse_args([]))
    assert ours.pop("device") == "cuda" and ours.pop("layers") == 0
    assert ours == seen
