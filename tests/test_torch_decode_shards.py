"""Sharded decode over the KV cache where it lies, on the CPU, against the
unsharded port and the reference.

* The partial-softmax combine (``layers.softmax_partials``,
  ``layers.combine_partials``): a row's keys cut into shards, each shard's
  partials combined, against one softmax over the whole row, with an
  all-masked shard, a softcap and grouped heads.
* The kv-sequence layout refuses what it cannot do: the flash op and a
  backward.
* Serve steps on a (2, 2) mesh of 4 gloo ranks, the cache sharded over its
  sequence on ``model``: enough steps that the valid positions cross the
  cache's shard boundary (shard 1 starts all-masked, then fills), for
  gemma-7b smoke (heads divide ``model``), the ``CELLS`` of
  ``test_torch_dryrun.py`` (heads, or kv heads, that do not), a window
  whose ring buffer wraps (recurrentgemma-2b smoke, window 8 under a
  16-position cache), cross-attention over a sequence-sharded ``xk`` /
  ``xv`` (whisper-small smoke, every gate at 0.5) and xlstm-350m smoke with
  3 heads (no cache: its one-token projections keep their weights where
  they lie, ``layers.split_contraction``, ``gather_tokens``). Each case's
  logits and final state against the unsharded port and against the
  reference's ``serve_step`` jitted on 4 forced host devices with
  ``AxisType.Auto`` axes, at 1e-5.
* The production ``decode_32k`` cells on 16 x 16 (256 fake ranks) against
  the reference's counts, xlstm-350m's on 2 x 16 x 16 too. starcoder2-7b's
  32 layers split over ``model``: its stacked ``mlp/wo`` goes into the
  scan by one all-to-all from its layers to its d_ff, as XLA's
  ``all-to-all.8`` (``sharding.move_shards_off``; before, an all-gather of
  every layer's slice, 1.321x the reference's wire bytes with the
  all-to-all as on the card). On the CPU route gloo's fallback gathers
  that all-to-all, and the test names the excess.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import flop_count
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, make_debug_mesh, steps
from repro_torch.models import layers, recurrent
from repro_torch.models import transformer as tt
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, MAX_LEN, STEPS, GATE, TOL = 4, 16, 10, 0.5, 1e-5
TIMEOUT_S = 240
# name: (arch, config overrides); each smoke config, B = 4 over ``data``,
# a 16-position cache over ``model`` (8 a shard), 10 steps
CASES = {
    "gemma": ("gemma-7b", {}),
    "seq": ("gemma-7b", {"n_heads": 3, "n_kv": 1}),
    "heads-whole-kv": ("gemma-7b", {"n_heads": 4, "n_kv": 1}),
    "window": ("recurrentgemma-2b", {"window": 8}),
    "cross": ("whisper-small", {}),
    # 3 heads that do not divide ``model``: the sLSTM / mLSTM projections
    # split their contraction where the weights lie, the out-projections
    # bring the tokens to the weights' shards
    "xlstm": ("xlstm-350m", {"n_heads": 3, "n_kv": 3, "d_model": 48}),
}

JAX_REF = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, "src")
from repro.configs import get_config
from repro.launch.steps import make_serve_step, serve_in_shardings
from repro.models import transformer as jt

d = sys.argv[1]
inp = np.load(os.path.join(d, "inputs.npz"))
with open(os.path.join(d, "cases.json")) as f:
    cases = json.load(f)


def tree(prefix):
    out = {}
    for key in inp.files:
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
            node = out
            for k in path:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(inp[key])
    return out


auto = jax.sharding.AxisType.Auto   # the Explicit default refuses kv_cache
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto,) * 2)
out = {}
for name, (arch, over, b, max_len) in cases.items():
    cfg = get_config(arch, smoke=True).replace(**over)
    params = tree(name + "/p/")
    state = jt.init_decode_state(cfg, b, max_len)
    if cfg.cross_len:
        enc = jt._get_encoder_states(params, tree(name + "/stub/"), cfg)
        state = jt.precompute_cross_kv(params, state, enc.astype(cfg.dtype),
                                       cfg)
    (psh, dsh, tsh), _ = serve_in_shardings(cfg, state, b, mesh)
    step = jax.jit(make_serve_step(cfg, mesh), in_shardings=(psh, dsh, tsh))
    params, state = jax.device_put(params, psh), jax.device_put(state, dsh)
    toks = inp[name + "/tokens"]
    logits = []
    for i in range(toks.shape[1]):
        lg, state = step(params, state, jnp.asarray(toks[:, i]))
        # back to the state's shardings where XLA handed a leaf back in
        # another (xlstm's h, as laid out by its step's products)
        state = jax.device_put(state, dsh)
        logits.append(np.asarray(lg))
    out[name + "/logits"] = np.stack(logits)
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    out.update({name + "/state/" + "/".join(k.key for k in path):
                np.asarray(x) for path, x in flat})
np.savez(os.path.join(d, "jax.npz"), **out)
"""


def paths(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def with_gates(tree):
    """A tree with every ``gate`` leaf at ``GATE``: at its init of 0 the
    cross-attention adds nothing."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, GATE) if k == "gate" else with_gates(v))
                for k, v in tree.items()}
    return tree


def case_inputs(name: str):
    """A case's config, numpy weights (0.1·N(0, 1), fp32), token ids (B,
    STEPS) and the encoder stub, from numpy seed 0."""
    arch, over = CASES[name]
    cfg = get_config(arch, smoke=True).replace(**over)
    rng = np.random.default_rng(0)
    params = with_gates(tree_map(
        lambda s: (0.1 * rng.standard_normal(s)).astype(np.float32),
        tt.param_shapes(cfg)))
    tokens = rng.integers(0, cfg.vocab, (B, STEPS)).astype(np.int32)
    stub = ({"frames": (0.1 * rng.standard_normal(
        (B, cfg.encoder_len, cfg.d_model))).astype(np.float32)}
        if cfg.encoder_layers else {})
    return cfg, params, tokens, stub


def _decode(name: str, mesh) -> dict:
    """Logits of every step and the final state, on ``mesh`` or (None)
    unsharded; the cross K/V filled unsharded, then laid out."""
    cfg, params, tokens, stub = case_inputs(name)
    tp = params_from_numpy(params, "cpu")
    state = tt.init_decode_state(cfg, B, MAX_LEN, device="cpu")
    if cfg.cross_len:
        with torch.no_grad():
            enc = tt._get_encoder_states(
                tp, {k: torch.from_numpy(v) for k, v in stub.items()}, cfg)
        state = tt.precompute_cross_kv(tp, state, enc, cfg)
    toks = [torch.from_numpy(tokens[:, i]) for i in range(STEPS)]
    if mesh is not None:
        (psh, dsh, tsh), _ = steps.serve_in_shardings(cfg, state, B, mesh)
        tp, state = sh.distribute(tp, psh), sh.distribute(state, dsh)
        toks = [sh.distribute(t, tsh) for t in toks]
    step = steps.make_serve_step(cfg, mesh)
    logits = []
    with torch.no_grad():
        for t in toks:
            out, state = step(tp, state, t)
            logits.append(out)
    whole = (lambda x: x.full_tensor()) if mesh is not None else (
        lambda x: x)
    return {"logits": torch.stack([whole(x) for x in logits]).numpy(),
            **{"state/" + p: whole(x).numpy() for p, x in paths(state)}}


def _counted(name: str, calls: dict, module=layers):
    """``module.<name>`` wrapped to count its calls into ``calls``."""
    fn = getattr(module, name)

    def run(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)
    return run


def _rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)     # 4 ranks on a few cores
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        found = {}
        for name in CASES:
            # every attention core on the mesh, and each that combined
            # partial softmaxes
            calls = {}
            with pytest.MonkeyPatch.context() as mp:
                for fn in ("attention_placements", "combine_partials"):
                    mp.setattr(layers, fn, _counted(fn, calls))
                for fn in ("split_contraction", "gather_tokens"):
                    mp.setattr(recurrent, fn, _counted(fn, calls, recurrent))
                found.update({f"{name}/{k}": v
                              for k, v in _decode(name, mesh).items()})
            found.update({f"{name}/calls/{k}": v for k, v in calls.items()})
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(d, "port.npz"), **found)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port on 4 gloo ranks, reference on 4 host devices) side by side."""
    d = str(tmp_path_factory.mktemp("decode_shards"))
    inputs, cases = {}, {}
    for name, (arch, over) in CASES.items():
        _, params, tokens, stub = case_inputs(name)
        inputs[name + "/tokens"] = tokens
        inputs.update({f"{name}/p/{p}": x for p, x in paths(params)})
        inputs.update({f"{name}/stub/{k}": v for k, v in stub.items()})
        cases[name] = [arch, over, B, MAX_LEN]
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    with open(os.path.join(d, "cases.json"), "w") as f:
        json.dump(cases, f)
    ref_run = subprocess.Popen([sys.executable, "-c", JAX_REF, d], cwd=ROOT,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
    try:
        ctx = torch.multiprocessing.spawn(_rank_main, args=(4, d), nprocs=4,
                                          join=False)
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the gloo ranks took over {TIMEOUT_S} s")
        _, err = ref_run.communicate(timeout=TIMEOUT_S)
    finally:
        ref_run.kill()
    assert ref_run.returncode == 0, err[-3000:]
    return (dict(np.load(os.path.join(d, "port.npz"))),
            dict(np.load(os.path.join(d, "jax.npz"))))


@pytest.fixture(scope="module")
def unsharded():
    return {name: _decode(name, None) for name in CASES}


@pytest.mark.parametrize("what", ["logits", "state"])
@pytest.mark.parametrize("against", ["unsharded port", "reference"])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches(name, against, what, runs, unsharded):
    """10 serve steps on the (2, 2) mesh, each layer's keys attended on
    their cache shard and the shards' partial softmaxes combined over
    ``model``: the logits of every step, or every leaf of the final state
    (the caches written shard by shard, the recurrent states), within 1e-5
    of the unsharded port's or of the reference's sharded steps."""
    port, jref = runs
    want = (unsharded[name] if against == "unsharded port" else
            {k[len(name) + 1:]: v for k, v in jref.items()
             if k.startswith(name + "/")})
    got = {k[len(name) + 1:]: v for k, v in port.items()
           if k.startswith(name + "/")}
    keys = sorted(k for k in want if k.split("/")[0] == what)
    assert keys and keys == sorted(k for k in got if k.split("/")[0] == what)
    for k in keys:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


ATTENTION_CASES = [n for n in CASES if CASES[n][0] != "xlstm-350m"]


@pytest.mark.parametrize("name", ATTENTION_CASES)
def test_sharded_decode_attends_on_the_cache_shards(name, runs):
    """Every attention core of every step on the mesh took the cache's
    layout and combined its shards' partials: none gathered the keys."""
    port, _ = runs
    cores = port[f"{name}/calls/attention_placements"]
    assert cores >= STEPS
    assert port[f"{name}/calls/combine_partials"] == cores


def test_sharded_xlstm_decode_keeps_the_weights_where_they_lie(runs):
    """Every step of the xlstm case on the mesh (3 heads over ``model``'s
    2) split the contraction of each layer's weights that hold an FSDP
    shard of d where they lie (sLSTM ``lstm_wx`` and its recurrent
    ``lstm_wh``, mLSTM ``lstm_wqkv`` and ``lstm_wog``) and brought the
    tokens to each ``rg_out/wo``; it attended over no cache."""
    port, _ = runs
    arch, over = CASES["xlstm"]
    cfg = get_config(arch, smoke=True).replace(**over)
    assert cfg.n_heads % 2
    assert port["xlstm/calls/split_contraction"] == STEPS * 2 * cfg.n_layers
    assert port["xlstm/calls/gather_tokens"] == STEPS * cfg.n_layers
    assert "xlstm/calls/attention_placements" not in port


def test_the_cases_cross_the_cache_shards():
    """The steps' positions cross the cache's shard boundary over
    ``model``'s 2 (shard 1 is all masked for the first half), and the
    window's ring of 8 slots wraps."""
    assert MAX_LEN // 2 < STEPS <= MAX_LEN
    arch, over = CASES["window"]
    cfg = get_config(arch, smoke=True).replace(**over)
    assert "local" in cfg.pattern and cfg.window < STEPS
    cross = get_config(CASES["cross"][0], smoke=True)
    assert cross.cross_len % 2 == 0


# ---------------------------------------------------------------------------
# The partial-softmax combine, plain
# ---------------------------------------------------------------------------

# name: (H, Kv, shards, softcap, a mask of the T = 16 keys)
COMBINE_CASES = {
    "two-shards": (4, 4, 2, 0.0, "causal"),
    "four-shards-gqa": (4, 2, 4, 0.0, "causal"),
    "all-masked-shard": (4, 2, 2, 0.0, "first-half"),
    "softcap": (4, 1, 4, 30.0, "first-half"),
    "no-mask": (2, 2, 4, 0.0, None),
}


@pytest.mark.parametrize("name", sorted(COMBINE_CASES))
def test_combined_partials_are_one_softmax(name):
    """Each shard's ``softmax_partials`` over its keys (the mask cut to
    them), combined with the shards as a leading dim, against the core's
    one softmax over the whole row: a shard whose keys are all masked
    weighs exactly 0."""
    h, kv, n, softcap, how = COMBINE_CASES[name]
    gen = torch.Generator().manual_seed(0)
    b, s, t, d = 3, 1, 16, 8
    q = torch.randn(b, s, h, d, generator=gen)
    k, v = (torch.randn(b, t, kv, d, generator=gen) for _ in range(2))
    mask = None
    if how == "causal":
        mask = (torch.arange(t) <= 5)[None, None, None, :]
    elif how == "first-half":
        mask = (torch.arange(t) < t // 2)[None, None, None, :]
    want = layers.mha_logits_to_out(q, k, v, mask, None, softcap)
    cut = t // n
    parts = [layers.softmax_partials(
        q, k[:, i * cut:(i + 1) * cut], v[:, i * cut:(i + 1) * cut],
        None if mask is None else mask[..., i * cut:(i + 1) * cut], None,
        softcap) for i in range(n)]
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    if how == "first-half":
        assert (m[n // 2:] == torch.finfo(torch.float32).min / 2).all()
    got = layers.combine_partials(m, l, acc, lambda x: x.amax(0),
                                  lambda x: x.sum(0))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _cache_layout(mesh, requires_grad: bool = False):
    """q (4, 1, 4, 8) over batch, k and v (4, 16, 2, 8) over batch and
    their sequence on ``model``, as decode lays the cache out."""
    gen = torch.Generator().manual_seed(1)
    q = distribute_tensor(torch.randn(4, 1, 4, 8, generator=gen), mesh,
                          [Shard(0), Replicate()])
    k, v = (distribute_tensor(torch.randn(4, 16, 2, 8, generator=gen), mesh,
                              [Shard(0), Shard(1)]) for _ in range(2))
    return [x.requires_grad_(requires_grad) for x in (q, k, v)]


def test_the_cache_layout_is_refused_where_it_has_no_partials():
    """The flash op and a backward over the cache layout raise, naming it,
    rather than gather the keys."""
    with dryrun.fake_process_group(4):
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        q, k, v = _cache_layout(mesh)
        with pytest.raises(NotImplementedError, match="decode cache"):
            ops.flash_attention(q, k, v, causal=True)
        q, k, v = _cache_layout(mesh, requires_grad=True)
        with pytest.raises(NotImplementedError, match="no backward"):
            layers.mha_logits_to_out(q, k, v, None, None)


def test_the_cache_layout_keeps_the_keys_where_they_lie():
    """``attention_placements`` of decode's q and the cache: q whole on
    ``model``, k and v on their sequence shards there, and ``kv_seq`` the
    ``model`` dim; no partial softmax, no layout."""
    with dryrun.fake_process_group(4):
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        q, k, _ = _cache_layout(mesh)
        lay = sh.attention_placements(q, k, partial_softmax=True)
        with pytest.raises(NotImplementedError):
            sh.attention_placements(q, k)
    assert lay.q == (Shard(0), Replicate())
    assert lay.kv == (Shard(0), Shard(1)) and lay.kv_seq == (1,)


# ---------------------------------------------------------------------------
# The production decode cells against the reference's counts
# ---------------------------------------------------------------------------

# The reference's ``decode_32k`` counts a device on 16 x 16, to 4 digits:
# ``repro.launch.dryrun``'s compile for 256 forced host devices with the
# mesh's axes made ``AxisType.Auto`` (under JAX's default Explicit axes its
# ``kv_cache`` annotation raises), bytes (GiB) from ``memory_analysis``,
# FLOPs and collective wire bytes from ``parse_hlo_profile``.
REFERENCE_DECODE = {   # arch: (GiB, FLOPs, wire bytes)
    "gemma-7b": (25.99, "1.605e+10", 1.498e9),
    "phi4-mini-3.8b": (7.54, "1.481e+10", 7.453e8),
    "deepseek-moe-16b": (12.91, "6.908e+09", 2.908e8),
    "llama-3.2-vision-90b": (26.47, "1.298e+11", 1.351e10),
    "recurrentgemma-2b": (0.76, "3.764e+09", 4.423e8),
    "whisper-small": (3.49, "1.398e+09", 3.789e7),
    "xlstm-350m": (0.29, "6.199e+08", 5.96e7),
    "granite-8b": (8.76, "1.772e+10", 1.324e9),
    "starcoder2-7b": (4.11, "2.703e+10", 1.069e9),
    "arctic-480b": (16.30, "6.311e+10", 1.504e9),
}
COUNTED = ["gemma-7b", "phi4-mini-3.8b", "recurrentgemma-2b",
           "whisper-small", "xlstm-350m", "granite-8b", "starcoder2-7b",
           "arctic-480b"]
WIRE_LIMIT = 1.5       # the port's wire bytes over the reference's, at most


@pytest.fixture(scope="module")
def decode_cells():
    """Each ``COUNTED`` arch's ``decode_32k`` traced on 16 x 16 over 256
    fake ranks: its counts, and the output shape of every collective."""
    out = {}
    record = flop_count.record_collective
    for arch in COUNTED:
        shapes = []

        def spy(stats, func, args, kwargs, res):
            wire = record(stats, func, args, kwargs, res)
            if wire and isinstance(res, torch.Tensor):
                shapes.append(tuple(res.shape))
            return wire

        flop_count.record_collective = spy
        try:
            cfg = get_config(arch).replace(use_flash_kernel=True)
            with dryrun.fake_process_group(256):
                mesh = dryrun.make_production_mesh(device_type="cpu")
                counts = dryrun.trace_step(cfg, SHAPES["decode_32k"],
                                           mesh)["counts"]
        finally:
            flop_count.record_collective = record
        out[arch] = (cfg, counts, shapes)
    return out


@pytest.mark.parametrize("arch", COUNTED)
def test_decode_cell_flops_are_the_references(arch, decode_cells):
    _, c, _ = decode_cells[arch]
    print(f"\n{arch} decode_32k: FLOPs a device {c.flops:.4e} (reference "
          f"{REFERENCE_DECODE[arch][1]})")
    assert f"{c.flops:.4g}" == f"{float(REFERENCE_DECODE[arch][1]):.4g}"


@pytest.mark.parametrize("arch", COUNTED)
def test_decode_cell_bytes_are_at_most_the_references(arch, decode_cells):
    _, c, _ = decode_cells[arch]
    gib = c.peak_bytes / 2**30
    print(f"\n{arch} decode_32k: {gib:.2f} GiB a device (reference "
          f"{REFERENCE_DECODE[arch][0]})")
    assert round(gib, 2) <= REFERENCE_DECODE[arch][0]


@pytest.mark.parametrize("arch", COUNTED)
def test_decode_cell_wire_bytes_are_near_the_references(arch, decode_cells):
    _, c, _ = decode_cells[arch]
    wire = c.collectives.total_bytes
    print(f"\n{arch} decode_32k: wire bytes a device {wire:.4e} "
          f"{c.collectives.bytes_by_kind} (reference "
          f"{REFERENCE_DECODE[arch][2]:.4e})")
    assert wire <= WIRE_LIMIT * REFERENCE_DECODE[arch][2]


@pytest.mark.parametrize("arch", COUNTED)
def test_no_collective_moves_the_cache(arch, decode_cells):
    """No collective's output is a (…, heads, head_dim) tensor as large as
    one layer's cache shard: the cache stays where its sharding put it
    (before, each layer gathered it whole, or moved it to heads)."""
    cfg, c, shapes = decode_cells[arch]
    sp = SHAPES["decode_32k"]
    shard = (sp.global_batch // 16) * (sp.seq_len // 16) * cfg.n_kv \
        * cfg.head_dim
    big = [s for s in shapes if len(s) >= 4 and s[-1] == cfg.head_dim
           and np.prod(s) >= shard]
    assert shapes and not big


def _alltoall_as_on_the_card(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's all-to-all as it runs on a CUDA group (the collective op;
    the fake group accepts it), where on a CPU mesh it gathers and cuts."""
    import torch.distributed._functional_collectives as funcol
    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, funcol._group_or_group_name(group))


def test_starcoder2_decode_wire_bytes_on_the_cards_route(decode_cells,
                                                         monkeypatch):
    """starcoder2-7b ``decode_32k`` with DTensor's all-to-all as on the
    card: wire bytes under the reference's (before 1.4116e9, 1.321x: the
    stacked ``mlp/wo``, (32, 18432, 4608) fp32 over its layers on
    ``model``, all-gathered whole over its layers on every rank), its one
    all-to-all of that stack 15/16 of the rank's slice. The CPU route's
    excess all-gather over the card's, 7.8078e8 (6.3701e8 of it the
    stack), is gloo's fallback for the all-to-alls: each gathers the
    whole of what the all-to-all exchanges, 16 times its wire bytes."""
    from torch.distributed.tensor import placement_types
    arch = "starcoder2-7b"
    cfg, cpu, _ = decode_cells[arch]
    monkeypatch.setattr(placement_types, "shard_dim_alltoall",
                        _alltoall_as_on_the_card)
    with dryrun.fake_process_group(256):
        mesh = dryrun.make_production_mesh(device_type="cpu")
        card = dryrun.trace_step(cfg, SHAPES["decode_32k"], mesh)["counts"]
    stack = 4 * cfg.n_layers * cfg.d_ff * cfg.d_model // 256   # fp32 slice
    moved = stack * 15 // 16
    by_kind = card.collectives.bytes_by_kind
    excess = (cpu.collectives.bytes_by_kind["all-gather"]
              - by_kind["all-gather"])
    print(f"\n{arch} decode_32k, all-to-all as on the card: wire bytes "
          f"{card.collectives.total_bytes:.4e} {dict(by_kind)} (reference "
          f"{REFERENCE_DECODE[arch][2]:.4e}); the CPU route's all-gather "
          f"excess {excess:.4e}, the stack's all-to-all {moved:.4e}")
    assert card.collectives.total_bytes <= REFERENCE_DECODE[arch][2]
    assert by_kind["all-to-all"] >= moved
    assert excess == 16 * by_kind["all-to-all"]
    assert card.flops == cpu.flops


# xlstm-350m ``decode_32k`` on 2 x 16 x 16# xlstm-350m ``decode_32k`` on 2 x 16 x 16 (512 forced host devices, Auto
# axes): GiB, FLOPs, wire bytes a device
REFERENCE_DECODE_PODS = {"xlstm-350m": (0.19, "3.100e+08", 4.925e7)}


@pytest.mark.parametrize("arch", sorted(REFERENCE_DECODE_PODS))
def test_decode_cell_on_two_pods_is_the_references(arch):
    """The cell on the multi-pod mesh (batch over ``pod`` and ``data``):
    FLOPs the reference's at 4 digits, bytes not above, wire bytes at most
    1.5x."""
    cfg = get_config(arch).replace(use_flash_kernel=True)
    with dryrun.fake_process_group(512):
        mesh = dryrun.make_production_mesh(multi_pod=True, device_type="cpu")
        c = dryrun.trace_step(cfg, SHAPES["decode_32k"], mesh)["counts"]
    gib, flops, wire = REFERENCE_DECODE_PODS[arch]
    print(f"\n{arch} decode_32k 2x16x16: FLOPs {c.flops:.4e}, "
          f"{c.peak_bytes / 2**30:.2f} GiB, wire bytes "
          f"{c.collectives.total_bytes:.4e} a device (reference {flops}, "
          f"{gib}, {wire:.4e})")
    assert f"{c.flops:.4g}" == f"{float(flops):.4g}"
    assert round(c.peak_bytes / 2**30, 2) <= gib
    assert c.collectives.total_bytes <= WIRE_LIMIT * wire
