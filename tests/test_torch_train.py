"""The port's optimizers, data pipeline and train entry point against the JAX
package: AdamW trajectories from one init and one stream of numpy batches,
single updates of each optimizer, and the CPU/CUDA device rule."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import transformer as jt
from repro.optim import make_optimizer as jax_optimizer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataState, SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_map


def numpy_batches(vocab, n, b, s, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (b, s + 1)) for _ in range(n)]


@pytest.mark.parametrize("arch", ["gemma-7b", "granite-8b",
                                  "recurrentgemma-2b", "xlstm-350m"])
def test_five_adamw_steps_track_jax(arch):
    jc = jax_config(arch, smoke=True)
    tc = get_config(arch, smoke=True)
    jp = jt.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jopt, topt = jax_optimizer("adamw", lr=1e-3), make_optimizer("adamw",
                                                                 lr=1e-3)
    jstep = jax.jit(jax_train_step(jc, jopt))
    tstep = make_train_step(tc, topt)
    jst, tst = jopt.init(jp), topt.init(tp)
    for toks in numpy_batches(jc.vocab, 5, 2, 32):
        jp, jst, jm = jstep(jp, jst, {
            "tokens": jnp.asarray(toks[:, :-1], jnp.int32),
            "labels": jnp.asarray(toks[:, 1:], jnp.int32)})
        tp, tst, tm = tstep(tp, tst, {"tokens": torch.from_numpy(toks[:, :-1]),
                                      "labels": torch.from_numpy(toks[:, 1:])})
        assert set(tm) == set(jm)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
    assert tst["step"] == int(jst["step"]) == 5


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw",
                                  "adamw_bf16", "adafactor"])
def test_one_update_matches_jax(name):
    """Three updates of each optimizer from one init, params and state
    against JAX at 1e-6, on a vector, a matrix and a stacked (2, 6, 5) leaf
    (adafactor factors the last two axes: rows (2, 6), columns (2, 5)).
    bf16 moments agree to one bf16 step (2^-8 relative): both packages
    round the same fp32 value, which may differ in its last fp32 bits."""
    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.standard_normal((8, 4)).astype(np.float32)},
              "b": rng.standard_normal((4,)).astype(np.float32),
              "c": rng.standard_normal((2, 6, 5)).astype(np.float32)}
    grads = tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                     params)
    jopt, topt = jax_optimizer(name, lr=1e-2), make_optimizer(name, lr=1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    tp, tg = params_from_numpy(params, "cpu"), params_from_numpy(grads, "cpu")
    jst, tst = jopt.init(jp), topt.init(tp)
    for _ in range(3):   # bias correction changes with the step
        jp, jst = jopt.update(jg, jst, jp)
        tp, tst = topt.update(tg, tst, tp)
    tree_map(lambda t, j: np.testing.assert_allclose(
        t.detach().numpy(), np.asarray(j), atol=1e-6, rtol=1e-6), tp, jp)

    def same_state(t, j):
        if isinstance(t, int):
            assert t == int(j) == 3
            return
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[1] == str(j.dtype)
        tol = 2 ** -8 if t.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), atol=tol,
                                   rtol=tol)
    tree_map(same_state, tst, jst)


def test_adamw_defaults_match_jax():
    assert make_optimizer("adamw").name == "adamw"
    with pytest.raises(KeyError):
        make_optimizer("lion")


def test_synthetic_batches_are_pure_functions_of_seed_step_shard():
    cfg = get_config("gemma-7b", smoke=True)
    a = SyntheticLM(cfg, 4, 32, seed=3)
    b1, b2 = a.next_batch(), a.next_batch()
    c = SyntheticLM(cfg, 4, 32, seed=3)
    c.load_state_dict(DataState(3, 1, 0, 1).as_dict())
    assert torch.equal(c.next_batch()["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b2["tokens"])
    other = SyntheticLM(cfg, 4, 32, seed=4).next_batch()
    assert not torch.equal(other["tokens"], b1["tokens"])
    toks, labels = b1["tokens"], b1["labels"]
    assert toks.shape == labels.shape == (4, 32)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    # every second token of the stream is its predecessor + 1 mod V
    stream = torch.cat([toks, labels[:, -1:]], dim=1)
    assert torch.equal(stream[:, 1::2], (stream[:, 0::2][:, : stream[:, 1::2]
                                                          .shape[1]] + 1)
                       % cfg.vocab)


def args(**kw):
    ns = train.build_argparser().parse_args([])
    base = dict(steps=3, batch=2, seq=32, log_every=1, device="cpu")
    base.update(kw)
    return argparse.Namespace(**{**vars(ns), **base})


def test_run_on_cpu_ends_finite():
    res = train.run(args())
    assert res["steps"] == 3 and len(res["step_seconds"]) == 3
    assert all(np.isfinite(res["losses"]))


@pytest.mark.parametrize("arch", ["gemma-7b", "recurrentgemma-2b"])
def test_run_overrides_reach_the_config(arch):
    res = train.run(args(arch=arch, steps=1, seq=256), use_flash_kernel=True)
    assert res["config"].use_flash_kernel and np.isfinite(res["last_loss"])


def test_run_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.run(args(device="cuda"))


def test_argparser_defaults_match_jax():
    from repro.launch.train import build_argparser as jax_argparser
    ours = vars(train.build_argparser().parse_args([]))
    theirs = vars(jax_argparser().parse_args([]))
    assert ours.pop("device") == "cuda"
    for k, v in ours.items():
        assert theirs[k] == v, k
