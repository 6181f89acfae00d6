"""The one-token step over a batch that the mesh's batch axes do not
divide (``long_500k``: B = 1 over a 524,288-token context), on the CPU.

* The production ``long_500k`` cells on 16 x 16 (256 fake ranks) and
  recurrentgemma-2b's on 2 x 16 x 16 (512) against the reference's counts
  (``REFERENCE_LONG``): FLOPs and bytes a device at most the reference's,
  wire bytes at most 1.5x; no collective's output as large as a rank's
  vocab shard of the embedding table (before: the table gathered over
  ``data``, 1.54e8 wire bytes a device); each product of recurrentgemma's
  one-token RG-LRU step contracting 1/16 of its dim on a rank (before:
  ``rg_in``'s and ``rg_gates``' 2560 whole on every rank).
* One-token ``step_rglru`` (recurrentgemma-2b smoke, B = 1) against the
  reference's, off a mesh and on a 1 x 1 mesh of one gloo rank, at 1e-5.
* A recurrentgemma-2b smoke serve loop at B = 1 on a (2, 2) mesh of 4
  gloo ranks against the unsharded port: the logits and the final state
  at 1e-5, the RG-LRU products through ``layers.split_whole_batch``.
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.models import recurrent as jr
from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import flop_count
from repro_torch.launch import dryrun, make_debug_mesh, steps
from repro_torch.models import recurrent
from repro_torch.models import transformer as tt
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_map

from test_torch_decode_shards import paths

ARCH, XLSTM = "recurrentgemma-2b", "xlstm-350m"
TOL, STEPS, MAX_LEN = 1e-5, 4, 16
TIMEOUT_S = 240

# The reference's ``long_500k`` counts a device (``tests/
# test_torch_moe_shards.py``'s ``reference_counts``: XLA's compile for 256
# or 512 forced host devices, Auto axes): GiB (``memory_analysis``), FLOPs
# and collective wire bytes (``parse_hlo_profile``).
REFERENCE_LONG = {   # (arch, multi_pod): (GiB, FLOPs, wire bytes)
    (ARCH, False): (0.5074, 46612480, 810131),
    (XLSTM, False): (0.1061, 24035328, 1131055),
    (ARCH, True): (0.5074, 45690880, 800051),
}
WIRE_LIMIT = 1.5     # the port's wire bytes over the reference's, at most


def _in_step_rglru() -> bool:
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "step_rglru":
            return True
        f = f.f_back
    return False


@pytest.fixture(scope="module")
def long_cells():
    """Each ``REFERENCE_LONG`` cell traced over fake ranks: its config,
    counts, every collective's output shape, and the operand shapes of
    every product that ``step_rglru`` ran."""
    out = {}
    record = flop_count.record_collective
    count = flop_count.DeviceCounter._count
    for arch, multi_pod in REFERENCE_LONG:
        shapes, products = [], []

        def spy(stats, func, args, kwargs, res):
            wire = record(stats, func, args, kwargs, res)
            if wire and isinstance(res, torch.Tensor):
                shapes.append(tuple(res.shape))
            return wire

        def counted(self, func, args, kwargs, res):
            before = self.counts.flops
            count(self, func, args, kwargs, res)
            if self.counts.flops > before and _in_step_rglru():
                products.append(tuple(tuple(a.shape) for a in args[:2]))

        flop_count.record_collective = spy
        flop_count.DeviceCounter._count = counted
        try:
            cfg = get_config(arch).replace(use_flash_kernel=True)
            with dryrun.fake_process_group(512 if multi_pod else 256):
                mesh = dryrun.make_production_mesh(multi_pod=multi_pod,
                                                   device_type="cpu")
                counts = dryrun.trace_step(cfg, SHAPES["long_500k"],
                                           mesh)["counts"]
        finally:
            flop_count.record_collective = record
            flop_count.DeviceCounter._count = count
        out[arch, multi_pod] = (cfg, counts, shapes, products)
    return out


CELLS = sorted(REFERENCE_LONG)
IDS = [f"{a}-{'2x16x16' if mp else '16x16'}" for a, mp in CELLS]


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_long_cell_flops_are_at_most_the_references(cell, long_cells):
    """recurrentgemma-2b before: 1.0068e8 (the RG-LRU's four one-token
    products whole on every rank); xlstm-350m's fewer by design (its
    one-token projections split their contraction over TP too)."""
    _, c, _, _ = long_cells[cell]
    want = REFERENCE_LONG[cell][1]
    print(f"\n{cell} long_500k: FLOPs a device {c.flops:.4e} (reference "
          f"{want:.4e}, {c.flops / want:.4f}x)")
    assert c.flops <= want


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_long_cell_bytes_are_at_most_the_references(cell, long_cells):
    """Before: 0.798 GiB (recurrentgemma-2b) and 0.114 GiB (xlstm-350m),
    the gathered table and whole weights cast at once."""
    _, c, _, _ = long_cells[cell]
    gib = c.peak_bytes / 2**30
    print(f"\n{cell} long_500k: {gib:.4f} GiB a device (reference "
          f"{REFERENCE_LONG[cell][0]})")
    assert gib <= REFERENCE_LONG[cell][0]


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_long_cell_wire_bytes_are_near_the_references(cell, long_cells):
    """Before: 1.5468e8 (recurrentgemma-2b) and 1.3337e7 (xlstm-350m)."""
    _, c, _, _ = long_cells[cell]
    wire, want = c.collectives.total_bytes, REFERENCE_LONG[cell][2]
    print(f"\n{cell} long_500k: wire bytes a device {wire:.4e} "
          f"{c.collectives.bytes_by_kind} (reference {want:.4e})")
    assert wire <= WIRE_LIMIT * want


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_no_collective_moves_the_embedding_table(cell, long_cells):
    """No collective's output holds as many elements as a rank's vocab
    shard of the table (V / 16 rows by d / 16): the one row is looked up
    on each rank's d_model slice of its vocab shard, as XLA looks it up."""
    cfg, _, shapes, _ = long_cells[cell]
    shard = cfg.padded_vocab // 16 * cfg.d_model // 16
    assert shapes and max(int(np.prod(s)) for s in shapes) < shard


def test_one_token_rglru_products_contract_a_sixteenth(long_cells):
    """recurrentgemma-2b on 16 x 16: every product of the one-token RG-LRU
    step contracts 160 of its 2560 on a rank, the weight left where it
    lies (``rg_in``'s and ``rg_gates``' as XLA's ``dot.197`` / ``.198``,
    the contraction split over ``data``)."""
    cfg, _, _, products = long_cells[ARCH, False]
    width = {cfg.d_model // 16, cfg.rnn_width // 16}
    assert products and all(a[-1] in width and b[-2] == a[-1]
                            for a, b in products)


# ---------------------------------------------------------------------------
# One-token ``step_rglru`` against the reference
# ---------------------------------------------------------------------------


def _rglru_inputs():
    """(JAX config, port config, numpy params, numpy state, tokens' x)."""
    jc = jax_config(ARCH, smoke=True)
    tc = get_config(ARCH, smoke=True)
    jp = jax.tree_util.tree_map(
        np.asarray, jr.init_rglru(jax.random.PRNGKey(4), jc))
    rng = np.random.default_rng(0)
    st = {"h": rng.standard_normal((1, jc.rnn_width)).astype(np.float32),
          "conv": rng.standard_normal((1, jc.conv_width - 1, jc.rnn_width)
                                      ).astype(np.float32)}
    xs = rng.standard_normal((STEPS, 1, 1, jc.d_model)).astype(np.float32)
    return jc, tc, jp, st, xs


def _port_steps(mesh):
    """The port's outputs and final state over ``STEPS`` one-token steps,
    on ``mesh`` (laid out as the serve step lays them out) or (None) off
    one."""
    _, tc, jp, st, xs = _rglru_inputs()
    p = params_from_numpy(jp, "cpu")
    state = {k: torch.from_numpy(v) for k, v in st.items()}
    if mesh is not None:
        psh = sh.params_shardings(p, mesh)
        p = sh.distribute(p, psh)
        state = {k: sh.distribute(v, sh.NamedSharding(mesh, (None,) * v.ndim))
                 for k, v in state.items()}
    ys = []
    with sh.use_mesh(mesh), torch.no_grad():
        for x in xs:
            x = torch.from_numpy(x)
            if mesh is not None:
                x = sh.distribute(x, sh.NamedSharding(mesh, (None,) * 3))
            y, state = recurrent.step_rglru(p, x, state, tc)
            ys.append(y)
    whole = (lambda t: t.full_tensor()) if mesh is not None else (
        lambda t: t)
    return (torch.stack([whole(y) for y in ys]).numpy(),
            {k: whole(v).numpy() for k, v in state.items()})


@pytest.mark.parametrize("on_mesh", [False, True], ids=["off", "1x1"])
def test_one_token_step_rglru_matches_the_reference(on_mesh, tmp_path):
    """B = 1, ``STEPS`` tokens: outputs, carry and conv state within 1e-5
    of the reference's ``step_rglru``."""
    jc, _, jp, st, xs = _rglru_inputs()
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    step = jax.jit(lambda p, x, s: jr.step_rglru(p, x, s, jc))
    want = []
    for x in xs:
        y, jst = step(jp, jnp.asarray(x), jst)
        want.append(np.asarray(y))
    if on_mesh:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                rank=0, world_size=1)
        try:
            got, state = _port_steps(make_debug_mesh((1, 1),
                                                     device_type="cpu"))
        finally:
            dist.destroy_process_group()
    else:
        got, state = _port_steps(None)
    np.testing.assert_allclose(got, np.stack(want), atol=TOL, rtol=TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(state[k], np.asarray(jst[k]), atol=TOL,
                                   rtol=TOL)


# ---------------------------------------------------------------------------
# A B = 1 serve loop on 4 gloo ranks
# ---------------------------------------------------------------------------


def _serve(mesh) -> dict:
    """Logits of ``STEPS`` serve steps at B = 1 and the final state, on
    ``mesh`` or (None) unsharded; numpy weights 0.1·N(0, 1) from seed 0."""
    cfg = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(0)
    params = params_from_numpy(tree_map(
        lambda s: (0.1 * rng.standard_normal(s)).astype(np.float32),
        tt.param_shapes(cfg)), "cpu")
    tokens = rng.integers(0, cfg.vocab, (STEPS, 1)).astype(np.int32)
    state = tt.init_decode_state(cfg, 1, MAX_LEN, device="cpu")
    toks = [torch.from_numpy(t) for t in tokens]
    if mesh is not None:
        (psh, dsh, tsh), _ = steps.serve_in_shardings(cfg, state, 1, mesh)
        params, state = sh.distribute(params, psh), sh.distribute(state, dsh)
        toks = [sh.distribute(t, tsh) for t in toks]
    step = steps.make_serve_step(cfg, mesh)
    logits = []
    with torch.no_grad():
        for t in toks:
            out, state = step(params, state, t)
            logits.append(out)
    whole = (lambda x: x.full_tensor()) if mesh is not None else (
        lambda x: x)
    return {"logits": torch.stack([whole(x) for x in logits]).numpy(),
            **{"state/" + p: whole(x).numpy() for p, x in paths(state)}}


def _rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)     # 4 ranks on a few cores
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    split, calls = recurrent.split_whole_batch, []

    def counted(*args, **kwargs):
        calls.append(1)
        return split(*args, **kwargs)

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(recurrent, "split_whole_batch", counted)
            found = _serve(make_debug_mesh((2, 2), device_type="cpu"))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(d, "port.npz"), calls=len(calls), **found)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("long_shards"))
    ctx = torch.multiprocessing.spawn(_rank_main, args=(4, d), nprocs=4,
                                      join=False)
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks took over {TIMEOUT_S} s")
    return dict(np.load(os.path.join(d, "port.npz")))


def test_one_row_serve_matches_the_unsharded_port(sharded):
    """Each step's logits and the final caches and recurrent states within
    1e-5 of the unsharded port's (relative to each one's largest
    magnitude); each RG-LRU layer's four products of each step went
    through ``split_whole_batch``."""
    cfg = get_config(ARCH, smoke=True)
    got = dict(sharded)
    rglru = cfg.pattern.count("rglru") * cfg.n_groups + sum(
        k == "rglru" for k in cfg.tail_pattern)
    assert int(got.pop("calls")) == 4 * rglru * STEPS
    want = _serve(None)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=TOL * max(np.abs(want[k]).max(), 1))
