"""The port's MoE block (``repro_torch.models.moe``) and the two MoE archs
against the JAX package: ``apply_moe`` and its three aux values in fp32 and
bf16, shared experts and the dense residual FFN, several dispatch groups,
a capacity that overflows (the same assignments dropped in both), the
top-k's tie order, gradients, the deepseek-moe-16b and arctic-480b smoke
models, ``serve_step`` with a decode step that drops, the optimized
configs, and arctic's driver run on adafactor. Inputs come from numpy;
JAX-initialised weights are carried across."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import train as jax_train
from repro.models import moe as jm
from repro.models import transformer as jt
from repro_torch.configs import get_config, get_optimizer_name
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.tree import leaves, tree_map

KEY = jax.random.PRNGKey(5)
ARCHS = ["deepseek-moe-16b", "arctic-480b"]


def carried(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def normal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def rel_norm(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.detach().float().numpy() - want)
                 / max(np.linalg.norm(want), 1e-30))


def configs(arch="deepseek-moe-16b", optimized=False, **moe):
    jc = jax_config(arch, smoke=True, optimized=optimized)
    tc = get_config(arch, smoke=True, optimized=optimized)
    if moe:
        jc = jc.replace(moe=jc.moe.__class__(**{**vars(jc.moe), **moe}))
        tc = tc.replace(moe=tc.moe.__class__(**{**vars(tc.moe), **moe}))
    return jc, tc


class Recorded:
    """``jnp`` for ``repro.models.moe``, recording the reference's
    dispatch and combine tensors as its einsums receive them."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec in ("ngd,ngec->necd", "necd,ngec->ngd"):
            self.seen[spec] = np.asarray(ops[1], np.float32)
        return jnp.einsum(spec, *ops, **kw)


def recorded_slots(monkeypatch):
    """The port's ``assign_slots`` calls, in order: (gate_idx, dispatch,
    combine)."""
    calls = []
    real = tm.assign_slots

    def assign_slots(gate_idx, gate_vals, num_experts, cap):
        dispatch, combine = real(gate_idx, gate_vals, num_experts, cap)
        calls.append((gate_idx, dispatch, combine))
        return dispatch, combine
    monkeypatch.setattr(tm, "assign_slots", assign_slots)
    return calls


def dropped(gate_idx, dispatch) -> int:
    return gate_idx.numel() - int(dispatch.sum())


def both_moe(jc, tc, x, dtype="float32"):
    """apply_moe of both packages on one carried init; x numpy fp32."""
    jp = jm.init_moe(KEY, jc)
    tp = carried(jp)
    jout, jaux = jm.apply_moe(jp, jnp.asarray(x).astype(dtype), jc)
    out, aux = tm.apply_moe(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                            tc)
    return (jout, jaux), (out, aux), (jp, tp)


# -- apply_moe ----------------------------------------------------------------

MOE_CASES = {
    "deepseek": ("deepseek-moe-16b", {}, (2, 32)),      # one shared expert
    "arctic": ("arctic-480b", {}, (2, 32)),             # no shared expert
    "groups": ("deepseek-moe-16b", {"group_size": 16}, (2, 32)),
    "overflow": ("deepseek-moe-16b", {"capacity_factor": 0.5}, (2, 32)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_jax(case, dtype):
    """The output and ``aux_loss``, ``z_loss``, ``expert_load``: fp32 within
    1e-5; bf16 within 2e-2 of the output's norm (the bound of the bf16
    model tests) and the aux values, taken in fp32 from bf16 router
    logits, within 1e-5."""
    arch, moe, (b, s) = MOE_CASES[case]
    jc, tc = configs(arch, **moe)
    (jout, jaux), (out, aux), _ = both_moe(
        jc, tc, normal((b, s, tc.d_model), seed=1), dtype)
    assert out.dtype == getattr(torch, dtype) and set(aux) == set(jaux)
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=1e-5)
    else:
        assert rel_norm(out, np.asarray(jout, np.float32)) <= 2e-2
    for k in jaux:
        np.testing.assert_allclose(aux[k].detach().numpy(), np.asarray(jaux[k]),
                                   atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("case", ["groups", "overflow"])
def test_the_same_assignments_are_dropped(case, monkeypatch):
    """Dispatch equal bit for bit and combine within 1e-6 against the
    reference's (recorded at its einsums); the overflow case drops."""
    arch, moe, (b, s) = MOE_CASES[case]
    jc, tc = configs(arch, **moe)
    rec = Recorded()
    monkeypatch.setattr(jm, "jnp", rec)
    calls = recorded_slots(monkeypatch)
    both_moe(jc, tc, normal((b, s, tc.d_model), seed=2))
    (gate_idx, dispatch, combine), = calls
    n = b * s // min(tc.moe.group_size, b * s)
    assert dispatch.shape == (n, b * s // n, tc.moe.num_experts,
                              tm.capacity(tc, b * s // n))
    np.testing.assert_array_equal(dispatch.detach().numpy(),
                                  rec.seen["ngd,ngec->necd"])
    np.testing.assert_allclose(combine.detach().numpy(), rec.seen["necd,ngec->ngd"],
                               atol=1e-6)
    if case == "overflow":
        assert dropped(gate_idx, dispatch) > 0
    else:
        assert n > 1


@pytest.mark.parametrize("x,k", [([0.1, 0.3, 0.3, 0.2, 0.3, 0.1], 3),
                                 ([0.0] * 8, 3), ([0.5, 0.5], 2)])
def test_top_k_breaks_ties_as_lax_top_k(x, k):
    jv, ji = jax.lax.top_k(jnp.asarray(x, jnp.float32), k)
    v, i = tm.top_k(torch.tensor(x), k)
    assert i.tolist() == np.asarray(ji).tolist()
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_zero_router_picks_the_first_k_experts(monkeypatch):
    """A zero router gives every expert the same probability: every token
    picks experts 0..k-1, in that order, as ``lax.top_k`` does; expert 0
    fills its capacity from the k = 0 slots and the rest drop, the same
    in both packages."""
    jc, tc = configs(top_k=3, num_experts=6)
    jp = jm.init_moe(KEY, jc)
    jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    tp = carried(jp)
    calls = recorded_slots(monkeypatch)
    x = normal((2, 32, tc.d_model), seed=3)
    jout, _ = jm.apply_moe(jp, jnp.asarray(x), jc)
    out, _ = tm.apply_moe(tp, torch.from_numpy(x), tc)
    (gate_idx, dispatch, _), = calls
    assert (gate_idx == torch.arange(3)).all()
    # capacity ceil(64 * 3 * 1.25 / 6) = 40 of 64 tokens an expert
    assert dropped(gate_idx, dispatch) == 3 * (64 - 40)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["deepseek", "arctic", "overflow"])
def test_apply_moe_gradients_match_jax_grad(case):
    """Router, expert, shared-expert and input gradients of the output
    against a fixed cotangent plus both aux losses, within 1e-5."""
    arch, moe, (b, s) = MOE_CASES[case]
    jc, tc = configs(arch, **moe)
    x = normal((b, s, tc.d_model), seed=4)
    ct = normal((b, s, tc.d_model), seed=5)
    jp = jm.init_moe(KEY, jc)

    def jloss(p, x):
        out, aux = jm.apply_moe(p, x, jc)
        return jnp.sum(out * ct) + aux["aux_loss"] + aux["z_loss"]

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = carried(jp)
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tm.apply_moe(tp, tx, tc)
    (torch.sum(out * torch.from_numpy(ct)) + aux["aux_loss"]
     + aux["z_loss"]).backward()
    assert tp["router"]["w"].grad.abs().max() > 0
    tree_map(lambda t, g: np.testing.assert_allclose(
        t.grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-5), tp, jgp)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_optimized_config_equals_the_base_one(arch):
    """``dispatch_local`` only changes the sharding: the optimized MoE
    gives the base one's output bit for bit, and the reference's
    optimized MoE within 1e-5."""
    x = normal((2, 32, 64), seed=6)
    jc, tc = configs(arch, optimized=True)
    assert tc.moe.dispatch_local and jc.moe.dispatch_local
    (jout, _), (out, _), (_, tp) = both_moe(jc, tc, x)
    base, _ = tm.apply_moe(tp, torch.from_numpy(x), configs(arch)[1])
    assert torch.equal(out, base)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)


# -- the smoke models -----------------------------------------------------------


def batches(vocab, b, s, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})


@pytest.mark.parametrize("dtype,remat", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_loss_grads(arch, dtype, remat):
    """The smoke model at S = 256 with the flash path on (its plain version
    on the CPU): fp32 logits and gradients within 1e-4, the loss, ``ce``,
    ``aux_loss`` and ``z_loss`` within 1e-5 relative; in bf16 the logits
    within 2e-2 of their norm, the loss 2e-3 relative and each gradient 5e-2
    of its own norm (the bounds of the other bf16 model tests), the
    router's 1e-1: it flows through the softmax of bf16-rounded logits,
    and at these weights the reference's own bf16 router gradient is 0.077
    (deepseek) and 0.081 (arctic) of its norm from its fp32 one."""
    over = dict(dtype=dtype, remat=remat, use_flash_kernel=True)
    jc = jax_config(arch, smoke=True).replace(**over)
    tc = get_config(arch, smoke=True).replace(**over)
    jp = jt.init_params(KEY, jc)
    tp = carried(jp)
    jb, tb = batches(jc.vocab, 2, 256)
    (jloss, jmet), jgrads = jax.jit(
        jax.value_and_grad(jt.loss_fn, has_aux=True), static_argnums=2)(
            jp, jb, jc)
    jlogits, _ = jax.jit(jt.forward, static_argnums=2)(jp, jb, jc)
    loss, metrics = tt.loss_fn(tp, tb, tc)
    loss.backward()
    with torch.no_grad():
        logits, _ = tt.forward(tp, tb, tc)
    assert set(metrics) == set(jmet)
    v = tc.vocab
    if dtype == "float32":
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
        for k in jmet:
            np.testing.assert_allclose(metrics[k].item(), float(jmet[k]),
                                       rtol=1e-5)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        tree_map(lambda t, g: np.testing.assert_allclose(
            t.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-4), tp, jgrads)
    else:
        assert rel_norm(logits[..., :v], np.asarray(jlogits)[..., :v]) \
            <= 2e-2
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-3)
        errs = tree_map(lambda t, g: rel_norm(t.grad, g), tp, jgrads)
        router = errs["scan"]["s0_moe"]["moe"].pop("router")["w"]
        assert max(leaves(errs)) <= 5e-2 and router <= 1e-1


def test_dense_residual_ff_is_in_the_block():
    """arctic-480b's block adds the dense FFN to the MoE on the same normed
    input: with the dense FFN's output weights zeroed the block equals the
    MoE alone."""
    tc = get_config("arctic-480b", smoke=True)
    p = tt._init_block(torch.Generator().manual_seed(0), "moe", tc)
    assert set(p) == {"norm1", "attn", "norm2", "moe", "dense_ff"}
    assert p["dense_ff"]["wi"].shape == (64, tc.dense_residual_ff)
    x = torch.from_numpy(normal((2, 8, 64), seed=7))
    pos = torch.arange(8)[None]
    with torch.no_grad():
        y, _ = tt._apply_block("moe", p, x, tc, pos)
        p["dense_ff"]["wo"].zero_()
        y0, _ = tt._apply_block("moe", p, x, tc, pos)
    assert (y - y0).abs().max() > 1e-3
    del p["dense_ff"]
    with torch.no_grad():
        assert torch.equal(tt._apply_block("moe", p, x, tc, pos)[0], y0)


# -- decode -----------------------------------------------------------------


def test_serve_step_drops_as_the_reference(monkeypatch):
    """B = 8 at a capacity factor of 0.5: one slot an expert in decode
    (ceil(8 * 2 * 0.5 / 4) = 2), so decode steps drop assignments; every
    step's logits against the reference's ``serve_step``, within 1e-5 of
    max(|logits|, 1) over the real vocab."""
    jc, tc = configs(capacity_factor=0.5)
    jp = jt.init_params(KEY, jc)
    tp = carried(jp)
    b, steps = 8, 6
    toks = np.random.default_rng(8).integers(0, tc.vocab, (b, steps))
    jstate = jt.init_decode_state(jc, b, steps)
    tstate = tt.init_decode_state(tc, b, steps, device="cpu")
    calls = recorded_slots(monkeypatch)
    for i in range(steps):
        jl, jstate = jt.serve_step(jp, jstate, jnp.asarray(toks[:, i]), jc)
        tl, tstate = tt.serve_step(tp, tstate, torch.from_numpy(toks[:, i]),
                                   tc)
        want = np.asarray(jl, np.float32)[:, :tc.vocab]
        np.testing.assert_allclose(tl[:, :tc.vocab].numpy(), want,
                                   atol=1e-5 * max(np.abs(want).max(), 1),
                                   rtol=0)
    assert len(calls) == steps * tc.n_layers
    assert sum(dropped(i, d) for i, d, _ in calls) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_capacity_differs_from_the_forwards_as_in_the_reference(
        arch):
    """The reference's semantics, kept: a decode step routes B tokens in
    one group (C = ceil(B * k * cf / E)), the forward B * S (deepseek smoke
    at B = 1, S = 3: C = 1 and 2), so the forward drops assignments that
    decode keeps, and a later token can take an earlier one's slot. Both
    packages' decode logits and forward logits agree within 1e-5, and in
    both the two disagree by more than the teacher-forced bound,
    2e-2 * max(|logits|, 1), at some position."""
    jc, tc = configs(arch)
    jp = jt.init_params(jax.random.PRNGKey(7), jc)
    tp = carried(jp)
    toks = np.random.default_rng(3).integers(0, tc.vocab, (1, 3))
    jfull, _ = jt.forward(jp, {"tokens": jnp.asarray(toks)}, jc)
    with torch.no_grad():
        full, _ = tt.forward(tp, {"tokens": torch.from_numpy(toks)}, tc)
    v = tc.vocab
    jfull = np.asarray(jfull)[..., :v]
    np.testing.assert_allclose(full[..., :v].numpy(), jfull, atol=1e-5,
                               rtol=1e-5)
    jstate = jt.init_decode_state(jc, 1, 3)
    tstate = tt.init_decode_state(tc, 1, 3, device="cpu")
    errs = []
    for i in range(3):
        jl, jstate = jt.serve_step(jp, jstate, jnp.asarray(toks[:, i]), jc)
        tl, tstate = tt.serve_step(tp, tstate, torch.from_numpy(toks[:, i]),
                                   tc)
        jl = np.asarray(jl)[:, :v]
        np.testing.assert_allclose(tl[:, :v].numpy(), jl, atol=1e-5,
                                   rtol=1e-5)
        errs.append(np.abs(jl - jfull[:, i]).max())
    assert max(errs) > 2e-2 * max(np.abs(jfull).max(), 1.0)


# -- arctic's training driver -------------------------------------------------


LOSS_LINE = re.compile(r"^step\s+(\d+) loss\s+(\S+)", re.M)


def test_arctic_driver_trains_on_adafactor_as_the_jax_driver(monkeypatch,
                                                             capsys):
    """``--full`` picks the arch's optimizer, adafactor for arctic-480b,
    in both drivers (a smoke run falls back to adamw). Both run the smoke
    config under ``--full`` (``get_config`` patched in each), the port's on
    the JAX driver's init and batches: the four losses within 1e-4
    relative (the JAX driver prints 4 decimals), and the port's state is
    adafactor's, factored."""
    from repro.data import SyntheticLM as JaxSyntheticLM
    arch = "arctic-480b"
    assert get_optimizer_name(arch) == "adafactor"
    for mod, real in ((jax_train, jax_config), (train, get_config)):
        monkeypatch.setattr(mod, "get_config",
                            lambda a, smoke=False, real=real: real(
                                a, smoke=True))
    jc = jax_config(arch, smoke=True)
    jp = jt.init_params(jax.random.PRNGKey(0), jc)

    class Batches:
        def __init__(self, cfg, batch, seq, seed=0):
            self.inner = JaxSyntheticLM(jc, batch, seq, seed=seed)

        def next_batch(self):
            return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
                    for k, v in self.inner.next_batch().items()}

    monkeypatch.setattr(train, "init_params", lambda gen, cfg: carried(jp))
    monkeypatch.setattr(train, "SyntheticLM", Batches)
    argv = ["--arch", arch, "--full", "--steps", "4", "--batch", "2",
            "--seq", "16", "--log-every", "1"]
    capsys.readouterr()
    jres = jax_train.run(jax_train.build_argparser().parse_args(argv))
    printed = [float(x) for _, x in
               LOSS_LINE.findall(capsys.readouterr().out)]
    res = train.run(train.build_argparser().parse_args(
        [*argv, "--device", "cpu"]))
    assert len(res["losses"]) == len(printed) == 4
    assert res["first_loss"] == pytest.approx(jres["first_loss"], rel=1e-4)
    assert res["last_loss"] == pytest.approx(jres["last_loss"], rel=1e-4)
    for got, want in zip(res["losses"], printed):
        assert got == pytest.approx(want, rel=1e-4, abs=5e-5)
    wi = res["opt_state"]["v"]["scan"]["s0_moe"]["moe"]["experts"]["wi"]
    assert set(wi) == {"row", "col"}
