"""The port's optimizers, async SGD and gradient compression against the JAX
package: the reference's own optimizer tests on the torch side, the int8
and top-k payloads bit for bit (ties at the k-th magnitude included),
``async_step`` over staleness 0, 1 and 3, ``outer_apply``, and the train
driver's compressed and async paths against the JAX driver from one init
and one stream of batches. Inputs come from numpy."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.optim as jax_optim
from repro.configs import get_config as jax_config
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch import train as jax_train
from repro.models import transformer as jt
from repro_torch import optim
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train
from repro_torch.optim import (async_init, async_step, compression,
                               make_compressor, make_optimizer, outer_apply)
from repro_torch.tree import leaves, tree_map


def numpy_tree(seed, shapes=None):
    rng = np.random.default_rng(seed)
    shapes = shapes or {"a": {"w": (8, 4)}, "b": (4,), "c": (2, 6, 5)}
    return tree_map(lambda s: rng.standard_normal(s).astype(np.float32),
                    shapes)


def both(tree):
    """The same numpy tree as JAX arrays and as CPU tensors."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tree_map(lambda x: torch.from_numpy(x.copy()), tree))


def test_exports_match_the_reference():
    assert sorted(optim.__all__) == sorted(jax_optim.__all__)
    for name in jax_optim.__all__:
        assert hasattr(optim, name), name


# -- the reference's optimizer tests (tests/test_optim.py) on the torch side


@pytest.mark.parametrize("name,lr", [
    ("sgd", 0.05), ("momentum", 0.02), ("adam", 0.05), ("adamw", 0.05),
    ("adamw_bf16", 0.05), ("adafactor", 0.1),
])
def test_optimizers_minimize_quadratic(name, lr):
    opt = make_optimizer(name, lr=lr)
    p = {"w": torch.full((4, 4), 3.0), "b": torch.full((4,), -2.0)}
    st_ = opt.init(p)
    for _ in range(300):
        g = tree_map(lambda x: 2 * (x - 1.0), p)
        p, st_ = opt.update(g, st_, p)
    for leaf in leaves(p):
        assert float((leaf - 1.0).abs().max()) < 0.05


def test_adafactor_state_is_factored():
    opt = make_optimizer("adafactor", lr=0.1)
    st_ = opt.init({"w": torch.zeros((64, 32))})
    n_state = sum(x.numel() for x in leaves(st_["v"]))
    assert n_state == 64 + 32  # O(n+m), not O(nm)


class TestAsyncSGD:
    def test_zero_staleness_is_sync(self):
        opt = make_optimizer("sgd", lr=0.1)
        s = async_init({"w": torch.ones(())}, opt, staleness=0)
        s = async_step(s, {"w": torch.ones(())}, opt, staleness=0)
        assert float(s.params["w"]) == pytest.approx(0.9)

    def test_staleness_delays_application(self):
        """With staleness tau, the first tau submissions apply zeros."""
        opt = make_optimizer("sgd", lr=1.0)
        tau = 3
        s = async_init({"w": torch.zeros(())}, opt, staleness=tau)
        for i in range(tau):
            s = async_step(s, {"w": torch.ones(()) * (i + 1)}, opt,
                           staleness=tau)
        assert float(s.params["w"]) == pytest.approx(0.0)
        s = async_step(s, {"w": torch.ones(()) * 99}, opt, staleness=tau)
        # now the FIRST submitted gradient (1.0) lands
        assert float(s.params["w"]) == pytest.approx(-1.0)

    def test_async_converges_with_staleness(self):
        opt = make_optimizer("sgd", lr=0.05)
        s = async_init({"w": torch.full((), 3.0)}, opt, staleness=4)
        for _ in range(400):
            g = {"w": 2 * (s.params["w"] - 1.0)}
            s = async_step(s, g, opt, staleness=4)
        assert float((s.params["w"] - 1.0).abs()) < 0.05

    def test_staleness_scaling_damps(self):
        out = outer_apply({"w": torch.ones(()) * 2}, {"w": torch.ones(())},
                          outer_lr=1.0, staleness=3)
        # delta = 1, scale = 1/(1+3) -> new = 2 - 0.25
        assert float(out["w"]) == pytest.approx(1.75)


class TestCompression:
    def test_int8_roundtrip_error_bounded(self):
        comp = make_compressor("int8")
        g = {"w": torch.linspace(-1, 1, 256).reshape(16, 16)}
        payload, _ = comp.compress(g, comp.init(g))
        dec = comp.decompress(payload)
        assert float((dec["w"] - g["w"]).abs().max()) < 1.5 / 127

    def test_int8_wire_is_quarter_fp32(self):
        comp = make_compressor("int8")
        g = {"w": torch.ones((64, 64))}
        payload, _ = comp.compress(g, comp.init(g))
        assert comp.wire_bytes(payload) <= 64 * 64 * 1 + 16

    def test_error_feedback_preserves_signal(self):
        """Sum of decompressed gradients + final residual == sum of raw
        gradients (no lost mass)."""
        comp = make_compressor("int8")
        rng = np.random.default_rng(0)
        g_total = torch.zeros((8, 8))
        d_total = torch.zeros((8, 8))
        err = comp.init({"w": g_total})
        for _ in range(20):
            g = {"w": torch.from_numpy(
                rng.standard_normal((8, 8)).astype(np.float32)) * 0.1}
            payload, err = comp.compress(g, err)
            d_total = d_total + comp.decompress(payload)["w"]
            g_total = g_total + g["w"]
        np.testing.assert_allclose((d_total + err["w"]).numpy(),
                                   g_total.numpy(), atol=1e-4)

    def test_topk_sparsity(self):
        comp = make_compressor("topk", fraction=0.1)
        g = {"w": torch.arange(100.0).reshape(10, 10)}
        payload, _ = comp.compress(g, comp.init(g))
        dec = comp.decompress(payload)
        assert int((dec["w"] != 0).sum()) == 10
        # keeps the largest magnitudes
        assert float(dec["w"][9, 9]) == 99.0

    @settings(max_examples=20, deadline=None)
    @given(st.floats(0.02, 0.5))
    def test_topk_error_feedback_converges(self, frac):
        """With error feedback, repeated compression of a CONSTANT gradient
        keeps the residual bounded: |residual| <= max|g| / frac."""
        comp = make_compressor("topk", fraction=frac)
        g = {"w": torch.linspace(0.1, 1.0, 64).reshape(8, 8)}
        err = comp.init(g)
        for _ in range(60):
            _, err = comp.compress(g, err)
        bound = float(g["w"].max()) / frac + 1.0
        assert float(err["w"].abs().max()) <= bound

    def test_unknown_compressor_raises(self):
        with pytest.raises(KeyError):
            make_compressor("fp8")


# -- payloads against JAX, bit for bit ----------------------------------------


def bits_equal(t, j):
    """Tensors bit for bit (a payload's ``shape`` tuple equal)."""
    if isinstance(t, tuple):
        assert t == tuple(j)
        return
    assert str(t.dtype).split(".")[1] == str(np.asarray(j).dtype)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_int8_payloads_bit_equal_jax():
    """Three rounds with error feedback: q, scale and the residual bit for
    bit, a leaf of exact zeros (scale at its 1e-12 floor) included."""
    shapes = {"a": {"w": (8, 4)}, "b": (4,), "c": (2, 6, 5), "z": (3,)}
    jc, tc = jax_optim.make_compressor("int8"), make_compressor("int8")
    jg0, tg0 = both(numpy_tree(0, shapes))
    jerr, terr = jc.init(jg0), tc.init(tg0)
    for i in range(3):
        g = numpy_tree(i, shapes)
        g["z"][:] = 0.0
        jg, tg = both(g)
        jpay, jerr = jc.compress(jg, jerr)
        tpay, terr = tc.compress(tg, terr)
        tree_map(bits_equal, tpay, jpay)
        tree_map(bits_equal, terr, jerr)
        tree_map(bits_equal, tc.decompress(tpay), jc.decompress(jpay))
        assert tpay["a"]["w"]["q"].dtype == torch.int8
        assert tc.wire_bytes(tpay) == jc.wire_bytes(jpay) == 32 + 4 + 60 + 3 \
            + 4 * 4


@pytest.mark.parametrize("chunk", [1 << 24, 7])
def test_topk_payloads_equal_jax_with_ties(chunk, monkeypatch):
    """Magnitudes drawn from a few values, so ties fill the k-th magnitude
    (and every other): ``jax.lax.top_k`` keeps the lower index first, and
    so must the port, in the selected set and in its order. Three rounds
    with error feedback; ``chunk`` 7 walks the tie search in pieces."""
    monkeypatch.setattr(compression, "_TIE_CHUNK", chunk)
    shapes = {"a": {"w": (8, 40)}, "b": (50,), "c": (2, 6, 25)}
    jc = jax_optim.make_compressor("topk", fraction=0.1)
    tc = make_compressor("topk", fraction=0.1)
    rng = np.random.default_rng(3)

    def tied(s):
        return (rng.choice([0.25, 0.5, 1.0, 2.0], s)
                * rng.choice([-1.0, 1.0], s)).astype(np.float32)

    jg0, tg0 = both(tree_map(tied, shapes))
    jerr, terr = jc.init(jg0), tc.init(tg0)
    for _ in range(3):
        jg, tg = both(tree_map(tied, shapes))
        jpay, jerr = jc.compress(jg, jerr)
        tpay, terr = tc.compress(tg, terr)
        tree_map(bits_equal, tpay, jpay)
        assert tpay["a"]["w"]["shape"] == (8, 40)
        tree_map(bits_equal, terr, jerr)
        tree_map(bits_equal, tc.decompress(tpay), jc.decompress(jpay))
        assert tpay["c"]["idx"].dtype == torch.int32
        assert tc.wire_bytes(tpay) == jc.wire_bytes(jpay) == 8 * (32 + 5 + 30)


# -- async SGD against JAX ------------------------------------------------------


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("tau", [0, 1, 3])
@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_async_step_matches_jax(name, tau, scale):
    """Six steps of fresh gradients: params each step within 1e-6, and the
    ring, rolled to its head, equal to the reference's stack."""
    jopt, topt = jax_optim.make_optimizer(name, lr=1e-2), \
        make_optimizer(name, lr=1e-2)
    jp, tp = both(numpy_tree(0))
    js, ts = jax_optim.async_init(jp, jopt, tau), async_init(tp, topt, tau)
    for i in range(6):
        jg, tg = both(numpy_tree(i + 1))
        js = jax_optim.async_step(js, jg, jopt, tau, scale_by_staleness=scale)
        ts = async_step(ts, tg, topt, tau, scale_by_staleness=scale)
        assert ts.step == js.step == i + 1
        tree_map(lambda t, j: np.testing.assert_allclose(
            t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6), ts.params,
            js.params)
        head = ts.step % tau if tau else 0
        tree_map(lambda t, j: bits_equal(torch.roll(t, -head, 0), j),
                 ts.buffer, js.buffer)
    assert ts.params["b"] is tp["b"]            # updated in place


def test_outer_apply_matches_jax():
    (jg, tg), (jq, tq) = both(numpy_tree(0)), both(numpy_tree(1))
    for staleness, scale in ((0, True), (2, True), (2, False)):
        tree_map(lambda t, j: np.testing.assert_allclose(
            t.numpy(), np.asarray(j), atol=1e-7, rtol=1e-6),
            outer_apply(tg, tq, 0.7, staleness, scale),
            jax_optim.outer_apply(jg, jq, 0.7, staleness, scale))


def test_sync_step_is_the_optimizer_update():
    opt = make_optimizer("adamw", lr=1e-2)
    _, a = both(numpy_tree(0))
    _, b = both(numpy_tree(0))
    _, g = both(numpy_tree(1))
    pa, _ = optim.sync_step(a, opt.init(a), g, opt)
    pb, _ = opt.update(g, opt.init(b), b)
    assert all(torch.equal(x, y) for x, y in zip(leaves(pa), leaves(pb)))


# -- the train driver's compressed and async paths against the JAX driver -----


LOSS_LINE = re.compile(r"^step\s+(\d+) loss\s+(\S+)", re.M)


def carried_jax_run(monkeypatch, arch, seed=0):
    """The port's driver on the JAX driver's init and batches: the two
    packages' random streams differ, so both are carried across."""
    jc = jax_config(arch, smoke=True)
    jp = jt.init_params(jax.random.PRNGKey(seed), jc)

    class Batches:
        def __init__(self, cfg, batch, seq, seed=0):
            self.inner = JaxSyntheticLM(jc, batch, seq, seed=seed)

        def next_batch(self):
            # tokens as int64, a frame or patch stub as fp32
            return {k: torch.from_numpy(np.asarray(v).astype(
                np.int64 if k in ("tokens", "labels") else np.float32))
                for k, v in self.inner.next_batch().items()}

        def state_dict(self):
            return self.inner.state_dict()

        def load_state_dict(self, d):
            self.inner.load_state_dict(d)

    monkeypatch.setattr(train, "init_params", lambda gen, cfg: params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    monkeypatch.setattr(train, "SyntheticLM", Batches)


def driver_args(parser, argv):
    return parser.parse_args(["--steps", "4", "--batch", "2", "--seq", "16",
                              "--log-every", "1", *argv])


def jax_losses(argv, capsys):
    """The JAX driver's result and its printed per-step losses."""
    capsys.readouterr()
    res = jax_train.run(driver_args(jax_train.build_argparser(), argv))
    printed = {int(s): float(x) for s, x in
               LOSS_LINE.findall(capsys.readouterr().out)}
    return res, printed


def port_run(argv):
    return train.run(driver_args(train.build_argparser(),
                                 [*argv, "--device", "cpu"]))


def assert_tracks(port, jax_res, printed):
    """Losses within 1e-4 relative; the JAX driver prints 4 decimals, so
    its printed losses carry 5e-5 more."""
    assert port["first_loss"] == pytest.approx(jax_res["first_loss"],
                                               rel=1e-4)
    assert port["last_loss"] == pytest.approx(jax_res["last_loss"], rel=1e-4)
    first = min(printed)
    assert len(port["losses"]) == len(printed) == jax_res["steps"]
    for i, loss in enumerate(port["losses"]):
        assert loss == pytest.approx(printed[first + i], rel=1e-4, abs=5e-5)


@pytest.mark.parametrize("argv", [["--compress", "int8"],
                                  ["--compress", "topk"],
                                  ["--async-staleness", "2", "--compress",
                                   "int8"]],
                         ids=["int8", "topk", "async2-int8"])
def test_driver_tracks_the_jax_driver(argv, monkeypatch, capsys):
    carried_jax_run(monkeypatch, "gemma-7b")
    jax_res, printed = jax_losses(argv, capsys)
    assert_tracks(port_run(argv), jax_res, printed)


def test_driver_async_saves_the_unused_opt_state(monkeypatch, tmp_path):
    """The reference's quirk, kept: async mode updates ``astate``'s own
    optimizer state, never the driver's ``opt_state``, which is what it
    returns and checkpoints."""
    carried_jax_run(monkeypatch, "gemma-7b")
    res = port_run(["--async-staleness", "2", "--steps", "3", "--ckpt-dir",
                    str(tmp_path)])
    assert res["opt_state"]["step"] == 0
    assert all(float(m.abs().max()) == 0.0
               for m in leaves(res["opt_state"]["mu"]))
    assert res["steps"] == 3 and all(np.isfinite(res["losses"]))


def test_driver_crash_and_resume_tracks_the_jax_driver(monkeypatch, capsys,
                                                       tmp_path):
    """Checkpoints at steps 0 and 2, a simulated failure at step 3, then a
    resume from step 2: the port's sequence against the JAX driver's, and
    the port's resumed losses against its own uninterrupted run."""
    carried_jax_run(monkeypatch, "gemma-7b")
    base = ["--steps", "6", "--ckpt-every", "2"]
    crash = [*base, "--fail-at", "3"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for run, d in ((lambda a: jax_losses(a, capsys), jdir),
                   (port_run, tdir)):
        with pytest.raises(RuntimeError, match="simulated node failure at "
                                               "step 3"):
            run([*crash, "--ckpt-dir", d])
    jax_res, printed = jax_losses([*base, "--ckpt-dir", jdir], capsys)
    port = port_run([*base, "--ckpt-dir", tdir])
    assert min(printed) == 3 and port["steps"] == 3
    assert port["restore_seconds"] is not None
    assert len(port["ckpt_seconds"]) == 2          # steps 4 and 5
    assert_tracks(port, jax_res, printed)
    straight = port_run(base)
    assert port["losses"] == pytest.approx(straight["losses"][3:], rel=1e-4)
