"""xlstm-350m's sharded training step on the CPU, against the reference's
counts and the unsharded step.

* ``train_4k`` cut to 4 layers (two sLSTM / mLSTM groups) on 16 x 16 (256
  fake ranks), traced at S = 16 and 32 and fitted to S = 1024 and 4096:
  FLOPs a device within 0.1% of the reference's (``XLSTM_CUT``). Named products
  at S = 32: each projection's weight gradient runs on 1/16 of its weight
  (``layers.split_weight_grad``), the sLSTM's recurrent product on the
  rank's batch rows at every step, and no product has a contraction of 1
  (the mLSTM readout's backward forms the state's gradient as a broadcast
  product).
* A smoke grad step on a (2, 2) mesh of 4 gloo ranks, 3 heads (which
  ``model`` does not divide, so every input projection's weight is whole
  over it; each ``rg_out/wo`` stack, sharded over its 2 groups there,
  moves that shard to its rows by an all-to-all,
  ``sharding.move_shards_off``), remat off and on: loss and gradients
  within 1e-5 of the unsharded step's, each gradient in its parameter's
  placements.
* The mLSTM readout's gradients bit-equal to autograd of the einsum, and
  ``split_weight_grad`` off a mesh bit-equal to ``torch.einsum``.
"""
import collections
import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import flop_count
from repro_torch.launch import dryrun, make_debug_mesh, steps
from repro_torch.models import layers, recurrent
from repro_torch.models import transformer as tt
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_map
from test_torch_moe_shards import XLSTM_CUT

XLSTM = "xlstm-350m"
TP = 16                      # ``model`` on the production mesh
B, S, TOL = 4, 16, 1e-5      # the gloo smoke step
SMOKE = {"n_heads": 3, "n_kv": 3, "d_model": 48}
TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# The 4-layer cut of ``train_4k`` on 16 x 16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cut():
    """The cut's config, its counts at S = 16 and 32, and every matrix
    product at S = 32: (operand shapes, FLOPs)."""
    cfg = get_config(XLSTM).replace(n_layers=XLSTM_CUT["n_layers"],
                                    use_flash_kernel=True)
    products, count = [], flop_count.DeviceCounter._count

    def spy(self, func, args, kwargs, out):
        before = self.counts.flops
        count(self, func, args, kwargs, out)
        if self.counts.flops > before and seen["s"] == 32:
            products.append((tuple(tuple(a.shape) for a in args[:2]),
                             self.counts.flops - before))

    seen, counts = {}, {}
    flop_count.DeviceCounter._count = spy
    try:
        with dryrun.fake_process_group(256):
            mesh = dryrun.make_production_mesh(device_type="cpu")
            for s in (16, 32):
                seen["s"] = s
                counts[s] = dryrun.trace_step(
                    cfg, dataclasses.replace(SHAPES["train_4k"], seq_len=s),
                    mesh)["counts"]
    finally:
        flop_count.DeviceCounter._count = count
    return cfg, counts, products


@pytest.mark.parametrize("seq", sorted(XLSTM_CUT["flops"]))
def test_cut_flops_are_the_references(seq, cut):
    """Fitted to S = 1024 and 4096, where XLA's count is affine in S, the
    cut's FLOPs a device are the reference's within 0.1% (before: 1.2476x
    and 1.2468x, each projection's weight gradient whole on every
    ``model`` rank)."""
    _, counts, _ = cut
    fit = dryrun.extrapolate(counts[16], counts[32], (seq - 16) // 16)
    want = XLSTM_CUT["flops"][seq]
    print(f"\nxlstm-350m train_4k, {XLSTM_CUT['n_layers']} layers, "
          f"S = {seq}: FLOPs a device {fit.flops:.6e} (reference "
          f"{want:.6e}, {fit.flops / want:.6f}x)")
    assert abs(fit.flops / want - 1) < 1e-3


def _weights(cfg):
    """(name, (d, N)) of each projection of the cut's layers, its output
    dims flattened; ``lstm_wif`` (8 outputs) keeps its whole gradient."""
    d = cfg.d_model
    kinds = {"slstm": [("lstm_wx", 4 * d), ("rg_out/wo", d)],
             "mlstm": [("lstm_wqkv", 3 * d), ("lstm_wog", d),
                       ("rg_out/wo", d)]}
    return [(f"{k}/{name}", (d, n)) for i in range(cfg.n_layers)
            for k in [cfg.pattern[i % len(cfg.pattern)]]
            for name, n in kinds[k]]


def test_each_weight_gradient_runs_on_a_sixteenth(cut):
    """The products that contract the rank's T tokens are the weights'
    gradients: each projection's is its TP slice (d/16 rows of
    ``rg_out/wo``, whose FSDP shard is of its columns; N/16 columns of
    the others), the rest whole: ``lstm_wif`` (8 outputs) and the head's
    vocab shard. Their FLOPs are 2·T·d·N/16 a projection."""
    cfg, _, products = cut
    d, t = cfg.d_model, SHAPES["train_4k"].global_batch // TP * 32
    got = collections.Counter()
    flops = 0
    for (a, b), f in products:
        if a[-1] == t == b[-2] and a[-2] != t:
            got[(a[-2], b[-1])] += 1
            flops += f
    sliced = collections.Counter(
        (d // TP, n) if name.endswith("rg_out/wo") else (d, n // TP)
        for name, (_, n) in _weights(cfg))
    whole = collections.Counter({(d, 2 * cfg.n_heads): cfg.n_layers // 2,
                                 (d, cfg.padded_vocab // TP): 1})
    assert got == sliced + whole
    want = sum(2 * t * d * n // TP for _, (_, n) in _weights(cfg))
    want += sum(2 * t * r * c * k for (r, c), k in whole.items())
    assert flops == want


def test_no_recurrent_product_at_the_global_batch(cut):
    """Every sLSTM recurrent product (by ``lstm_wh``, (nh, hd, 4·hd)) and
    its weight's gradient runs on the rank's B/16 rows, its first step
    too: the zero state is laid out as the inputs (before, a replicated
    state of the global 256 rows at every rank's first step)."""
    cfg, _, products = cut
    nh, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    rows = SHAPES["train_4k"].global_batch // TP
    forward = [a for (a, b), _ in products if b == (nh, hd, 4 * hd)]
    grads = [a for (a, b), _ in products if b[0] == nh and a[0] == nh
             and (a[1], b[2]) == (hd, 4 * hd)]
    assert forward and {a[1] for a in forward} == {rows}
    assert grads and {a[2] for a in grads} == {rows}


def test_no_product_has_a_contraction_of_one(cut):
    """The mLSTM readout's backward forms C's and n's gradients as
    broadcast products (before: bmms of a contraction of 1), and q's by C
    as one product a step, as XLA's HLO has it."""
    cfg, _, products = cut
    assert not [p for p in products if p[0][0][-1] == 1]
    hd = cfg.d_model // cfg.n_heads
    lanes = SHAPES["train_4k"].global_batch // TP * cfg.n_heads
    assert ((lanes, hd, hd), (lanes, hd, 1)) in [p[0] for p in products]


# ---------------------------------------------------------------------------
# A smoke step on 4 gloo ranks against the unsharded step
# ---------------------------------------------------------------------------


def _inputs():
    cfg = get_config(XLSTM, smoke=True).replace(**SMOKE)
    rng = np.random.default_rng(0)
    params = tree_map(lambda s: (0.1 * rng.standard_normal(s))
                      .astype(np.float32), tt.param_shapes(cfg))
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return cfg, params, tokens


def _paths(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


PROJECTIONS = ("lstm_wx", "lstm_wqkv", "lstm_wog", "rg_out/wo")


def _grad_step(mesh, remat: bool) -> dict:
    """Loss and gradients of the smoke grad step, on ``mesh`` or (None)
    unsharded; on the mesh also how many of the projections' gradients
    are not in their parameter's placements ("misplaced"; a replicated
    parameter's gradient is a pending sum, as before)."""
    cfg, params, tokens = _inputs()
    cfg = cfg.replace(remat=remat)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:])}
    tp = params_from_numpy(params, "cpu")
    if mesh is not None:
        opt = make_optimizer("adamw", lr=1e-3)
        (psh, _, bsh), _, _ = steps.train_in_shardings(cfg, opt, batch, mesh)
        tp, batch = sh.distribute(tp, psh), sh.distribute(batch, bsh)
    grads, metrics = steps.make_grad_step(cfg, mesh)(tp, batch)
    out = {"loss": float(metrics["loss"])}
    for (p, g), (_, x) in zip(_paths(grads), _paths(tp)):
        whole = g.full_tensor() if mesh is not None else g
        out["g/" + p] = whole.detach().numpy()
    if mesh is not None:
        out["misplaced"] = sum(g.placements != x.placements
                               for (p, g), (_, x) in zip(_paths(grads),
                                                         _paths(tp))
                               if p.endswith(PROJECTIONS))
    return out


def _rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)     # 4 ranks on a few cores
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    calls, base = collections.Counter(), layers._WeightGradOnSlice

    class Counted(base):
        @staticmethod
        def backward(ctx, g):
            calls["sliced"] += 1
            return base.backward(ctx, g)

    try:
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        found = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(layers, "_WeightGradOnSlice", Counted)
            for remat in (False, True):
                calls.clear()
                found.update({f"remat={remat}/{k}": v for k, v in
                              _grad_step(mesh, remat).items()})
                found[f"remat={remat}/sliced"] = calls["sliced"]
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(d, "port.npz"), **found)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("xlstm_shards"))
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
def test_sharded_smoke_step_matches_the_unsharded_step(remat, sharded):
    """The (2, 2) mesh's loss and every gradient within 1e-5 of the
    unsharded step's (relative; a gradient's to its largest magnitude); every projection's weight gradient went
    through its TP slice and came back in its parameter's placements:
    ``lstm_wx`` (an sLSTM layer's), ``lstm_wqkv`` and ``lstm_wog`` (an
    mLSTM layer's) by ``split_weight_grad``, ``rg_out/wo`` as its weight
    arrives, its rows over ``model`` (before: by ``split_weight_grad``
    too, the stack all-gathered whole)."""
    want = _grad_step(None, remat)
    got = {k[len(f"remat={remat}/"):]: v for k, v in sharded.items()
           if k.startswith(f"remat={remat}/")}
    cfg = get_config(XLSTM, smoke=True)
    assert int(got.pop("sliced")) == 3 * cfg.n_layers // 2
    assert int(got.pop("misplaced")) == 0
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    for k in want:     # relative to the leaf's largest magnitude
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=TOL * np.abs(want[k]).max())


# ---------------------------------------------------------------------------
# Bit-equality off a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state", ["C", "n"])
@pytest.mark.parametrize("shape", [(2, 3, 16), (4, 4, 64), (1, 2, 256)])
def test_readout_gradients_are_the_einsums(state, shape):
    """``recurrent._ReadOut`` of C (B, nh, hd, hd) or n (B, nh, hd) by q:
    the output and both gradients bit-equal to autograd of the einsum it
    replaces (fp32; a product of a contraction of 1 is one rounded
    multiply, as the broadcast product)."""
    gen = torch.Generator().manual_seed(sum(shape))
    b, nh, hd = shape
    a0 = torch.randn(shape + ((hd,) if state == "C" else ()), generator=gen)
    q0 = torch.randn(shape, generator=gen)
    eq = "bhkl,bhl->bhk" if state == "C" else "bhl,bhl->bh"
    outs, grads = [], []
    for fn in (lambda a, q: torch.einsum(eq, a, q), recurrent._ReadOut.apply):
        a, q = a0.clone().requires_grad_(), q0.clone().requires_grad_()
        out = fn(a, q)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
        out.backward(g)
        outs.append(out.detach())
        grads.append((a.grad, q.grad))
    assert torch.equal(outs[0], outs[1])
    for want, got in zip(*grads):
        assert torch.equal(want, got)


@pytest.mark.parametrize("eq,shapes", [
    ("bsd,dghl->bsghl", ((2, 5, 8), (8, 4, 3, 2))),
    ("...d,dk->...k", ((2, 5, 8), (8, 6)))])
def test_split_weight_grad_off_a_mesh_is_einsum(eq, shapes):
    """Off a mesh ``split_weight_grad`` is ``torch.einsum``: output and
    gradients bit-equal."""
    gen = torch.Generator().manual_seed(0)
    x0, w0 = (torch.randn(s, generator=gen) for s in shapes)
    runs = []
    for fn in (torch.einsum, layers.split_weight_grad):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        out = fn(eq, x, w)
        out.backward(torch.ones_like(out))
        runs.append((out.detach(), x.grad, w.grad))
    for want, got in zip(*runs):
        assert torch.equal(want, got)
