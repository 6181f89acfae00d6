"""The port's sharding layer against the reference's, on the CPU.

* Specs, at production sizes without devices: for every arch on the
  (16, 16) and (2, 16, 16) meshes, every param, optimizer-state (the arch's
  own optimizer, through ``train_in_shardings``), batch and decode-state
  (B = 8, through ``serve_in_shardings``) leaf's spec equals the
  reference's on a ``jax.sharding.AbstractMesh``. The port's come from
  ``DeviceMesh``es over a fake process group of 256 and 512 ranks.
* Numerics: one gemma-7b smoke grad step and train step (fp32, 2 layers,
  B = 4, S = 64, AdamW) on a (2, 2) ("data", "model") mesh of 4 gloo ranks,
  against the reference's steps jitted with ``train_in_shardings`` on 4
  forced host devices; the same steps with remat on three heads (q over
  the sequence), each checkpointed group saving 1/2 of its input on a
  rank, against the reference's remat steps; and the kernels' DTensor
  sharding rules on those ranks against the plain tensors' calls.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import (Partial, Replicate, Shard,
                                      distribute_tensor)

from repro.configs import get_config as jax_config
from repro.configs import get_optimizer_name as jax_optimizer_name
from repro.launch import steps as jsteps
from repro.models import transformer as jt
from repro.optim import make_optimizer as jax_make_optimizer
from repro.parallel import sharding as jsh
from repro_torch.configs import ARCH_IDS, get_config, get_optimizer_name
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.launch import make_debug_mesh, make_production_mesh
from repro_torch.launch import steps
from repro_torch.models import transformer as tt
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.tree import leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
MESH_IDS = ["16x16", "2x16x16"]
TRAIN_BATCH = (32, 128)      # tokens / labels of the train specs
DECODE_B, DECODE_LEN = 8, 2048
R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)


# ---------------------------------------------------------------------------
# Specs at production sizes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def meshes():
    """The port's production meshes over fake process groups of 256 and
    512 ranks (no data moves). The 512-rank group stays up for the module's
    DTensor tests and is destroyed at teardown."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    out = {}
    try:
        for multi_pod in (False, True):
            dist.init_process_group(
                "fake", store=FakeStore(), rank=0,
                world_size=int(np.prod(MESHES[multi_pod][0])))
            out[multi_pod] = make_production_mesh(multi_pod=multi_pod,
                                                  device_type="cpu")
            if not multi_pod:
                dist.destroy_process_group()
        yield out
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def norm(spec) -> tuple:
    """A spec with ``'a'`` as ``('a',)`` and no trailing Nones."""
    parts = [None if p is None else (p,) if isinstance(p, str) else tuple(p)
             for p in spec]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def jax_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): norm(s.spec)
            for path, s in flat}


def paths(tree, prefix: str = ""):
    """(``"/"``-joined key path, leaf) pairs of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def port_specs(tree) -> dict:
    return {path: norm(s.spec) for path, s in paths(tree)}


@functools.lru_cache(maxsize=None)
def reference_specs(arch: str, multi_pod: bool) -> dict:
    mesh = AbstractMesh(*MESHES[multi_pod])
    cfg = jax_config(arch)
    opt = jax_make_optimizer(jax_optimizer_name(arch), lr=1e-3)
    batch = {k: jax.ShapeDtypeStruct(TRAIN_BATCH, np.int32)
             for k in ("tokens", "labels")}
    (psh, osh, bsh), _, _ = jsteps.train_in_shardings(cfg, opt, batch, mesh)
    state = jt.decode_state_shapes(cfg, DECODE_B, DECODE_LEN)
    (_, dsh, tok), _ = jsteps.serve_in_shardings(cfg, state, DECODE_B, mesh)
    return {"params": jax_specs(psh), "opt_state": jax_specs(osh),
            "batch": jax_specs(bsh),
            "decode_state": {**jax_specs(dsh), "token": norm(tok.spec)}}


@functools.lru_cache(maxsize=None)
def port_specs_of(arch: str, mesh) -> dict:
    cfg = get_config(arch)
    opt = make_optimizer(get_optimizer_name(arch), lr=1e-3)
    batch = {k: torch.empty(TRAIN_BATCH, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    (psh, osh, bsh), _, oshapes = steps.train_in_shardings(cfg, opt, batch,
                                                           mesh)
    assert all(x.is_meta for x in leaves(oshapes) if not isinstance(x, int))
    state = tt.decode_state_shapes(cfg, DECODE_B, DECODE_LEN)
    (_, dsh, tok), _ = steps.serve_in_shardings(cfg, state, DECODE_B, mesh)
    return {"params": port_specs(psh), "opt_state": port_specs(osh),
            "batch": port_specs(bsh),
            "decode_state": {**port_specs(dsh), "token": norm(tok.spec)}}


@pytest.mark.parametrize("kind", ["params", "opt_state", "batch",
                                  "decode_state"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_the_reference(arch, multi_pod, kind, meshes):
    want = reference_specs(arch, multi_pod)[kind]
    got = port_specs_of(arch, meshes[multi_pod])[kind]
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad
    # the placements follow the spec: one Shard(d) per mesh axis named
    names = meshes[multi_pod].mesh_dim_names
    for path, spec in got.items():
        placements = sh._placements(meshes[multi_pod], spec)
        for axis, p in zip(names, placements):
            dims = [d for d, part in enumerate(spec) if part and axis in part]
            assert p == (Shard(dims[0]) if dims else Replicate()), path


@pytest.mark.parametrize("name", sorted(sh._ACT_SPECS))
def test_activation_spec_matches_the_reference(name, meshes):
    mesh = meshes[True]
    jmc = jsh.MeshContext(AbstractMesh(*MESHES[True]))
    ndim = len(sh._ACT_SPECS[name])
    assert sh._ACT_SPECS[name] == jsh._ACT_SPECS[name]
    got = sh._spec_for(name, ndim, sh.MeshContext(mesh))
    assert norm(got) == norm(jsh._spec_for(name, ndim, jmc))
    assert sh._spec_for(name, ndim + 1, sh.MeshContext(mesh)) is None
    assert jsh._spec_for(name, ndim + 1, jmc) is None


def test_rules_are_the_references():
    assert sh._PARAM_RULES == jsh._PARAM_RULES
    assert sh._STATE_RULES == jsh._STATE_RULES
    assert dataclasses.asdict(sh.ShardingRules()) \
        == dataclasses.asdict(jsh.ShardingRules())


def test_shard_is_the_identity_off_a_mesh_and_for_a_plain_tensor(meshes):
    x = torch.randn(32, 8, 64)
    assert sh.current_mesh() is None
    assert sh.shard(x, "act_ff") is x
    with sh.use_mesh(meshes[True]):
        assert sh.current_mesh() is not None
        assert sh.shard(x, "act_ff") is x            # plain: passes through
        d = distribute_tensor(x, meshes[True], [Replicate()] * 3)
        assert sh.shard(d, "no_such_name") is d
        assert sh.shard(d, "act_heads") is d         # rank 3, spec rank 4
    assert sh.current_mesh() is None
    with sh.use_mesh(None):
        assert sh.current_mesh() is None


def test_shard_redistributes_a_dtensor(meshes):
    mesh = meshes[True]
    d = distribute_tensor(torch.randn(32, 8, 64), mesh, [Replicate()] * 3)
    with sh.use_mesh(mesh):
        out = sh.shard(d, "act_ff")       # batch over pod x data, F over tp
    assert out.placements == (Shard(0), Shard(0), Shard(2))
    assert out.to_local().shape == (1, 8, 4)


def test_divisibility_guard(meshes):
    mesh = meshes[True]
    d = distribute_tensor(torch.randn(24, 8, 64), mesh, [Replicate()] * 3)
    with sh.use_mesh(mesh):
        assert sh.shard(d, "act_ff") is d    # 24 rows over 32 batch shards
    shapes = {"embed": (24, 64), "mlp": {"wi": (64, 24)}}
    got = sh.params_shardings(tree_map(
        lambda s: torch.empty(s, device="meta"), shapes), mesh)
    assert got["embed"].spec == (None, ("data",))     # vocab 24 over tp 16
    assert got["mlp"]["wi"].spec == (("data",), None)
    jgot = jsh.params_shardings(tree_map(
        lambda s: jax.ShapeDtypeStruct(s, np.float32), shapes),
        AbstractMesh(*MESHES[True]))
    assert jax_specs(jgot) == port_specs(got)


def test_role_size(meshes):
    assert sh.role_size("tp") == 1
    with sh.use_mesh(meshes[True]):
        assert [sh.role_size(r) for r in ("batch", "tp", "sp", "fsdp")] \
            == [32, 16, 16, 16]
    with sh.use_mesh(meshes[False], sh.ShardingRules(tp=("data", "model"))):
        assert sh.role_size("batch") == 16 and sh.role_size("tp") == 256
    assert sh.role_size("batch") == 1


@pytest.mark.parametrize("multi_pod", [False, True], ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flash_keeps_heads_over_model_on_the_production_mesh(arch, multi_pod,
                                                             meshes):
    """q, k, v as the attention block shards them at ``train_4k``'s S =
    4096 on the production meshes: attention computes in batch over pod x
    data and, over model's 16, in the reference's layout: q's heads where
    H divides 16, with k and v too where Kv does, else k and v whole and
    each rank on the kv head its q heads read (llama-3.2-vision-90b,
    granite-8b); q's sequence where H does not divide 16 (arctic-480b,
    phi4-mini, starcoder2-7b, recurrentgemma-2b, whisper-small, and
    xlstm-350m's heads, which no attention reads), k and v whole."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.models.layers import _shard_kv, _shard_q
    cfg, mesh = get_config(arch), meshes[True]
    if not multi_pod:     # 16 x 16 inside the 512-rank group, which is up
        shape, names = MESHES[False]
        mesh = DeviceMesh("cpu", torch.arange(256).view(shape),
                          mesh_dim_names=names)
    h, kv = cfg.n_heads, cfg.n_kv
    batch = (S0,) * (mesh.ndim - 1)

    def dt(n):
        x = torch.zeros(32, 4096, n, 1)
        return distribute_tensor(x, mesh, [R] * mesh.ndim)
    with sh.use_mesh(mesh):
        q, k = _shard_q(dt(h)), _shard_kv(dt(kv))
    lay = ops._flash_placements(q, k)
    if h % 16:
        want = (S1, R, Partial(), None)
    elif kv % 16:
        want = (S2, R, Partial(), (0, 1))   # rank 0's q heads read kv head 0
    else:
        want = (S2, S2, S2, None)
    assert (lay.q, lay.kv, lay.kv_grad, lay.kv_heads) == tuple(
        (*batch, w) if i < 3 else w for i, w in enumerate(want))
    assert lay.q_offset == 0     # rank 0 holds the first queries


def test_a_dim_over_several_axes_keeps_the_mesh_order(meshes):
    mesh = meshes[True]
    s = sh.NamedSharding(mesh, (("pod", "data"), None, ("model",)))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="axis order"):
        sh.NamedSharding(mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="shards two tensor dims"):
        sh.NamedSharding(mesh, (("data",), ("data",)))


# ---------------------------------------------------------------------------
# Numerics: 4 gloo ranks against JAX on 4 host devices
# ---------------------------------------------------------------------------

ARCH, B, S, LR = "gemma-7b", 4, 64, 1e-3
TIMEOUT_S = 240
# The runs of the step, by the prefix of their keys: the smoke config as
# it is, and with remat on three heads, which do not divide ``model``, so
# that attention takes q over the sequence and each checkpointed group
# saves 1/2 of its input (``transformer._checkpoint``).
RUNS = {"": {}, "remat/": {"remat": True, "n_heads": 3, "n_kv": 1}}

JAX_STEP = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
sys.path.insert(0, "src")
from repro.configs import get_config
from repro.launch.steps import (make_grad_step, make_train_step,
                                train_in_shardings)
from repro.optim import make_optimizer

d = sys.argv[1]
# the reference's steps constrain shardings as hints (Auto axes), where
# this JAX's make_mesh defaults to Explicit axes
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
for i, replace in enumerate(json.loads(sys.argv[2])):
    inp = np.load(os.path.join(d, f"inputs{i}.npz"))
    params = {}
    for key in inp.files:
        if key.startswith("p/"):
            *path, last = key[2:].split("/")
            node = params
            for k in path:
                node = node.setdefault(k, {})
            node[last] = inp[key]
    toks = inp["tokens"]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    cfg = get_config("gemma-7b", smoke=True).replace(**replace)
    opt = make_optimizer("adamw", lr=float(inp["lr"]))
    (psh, osh, bsh), _, _ = train_in_shardings(cfg, opt, batch, mesh)
    params = jax.device_put(params, psh)
    batch = jax.device_put(batch, bsh)
    grads, _ = jax.jit(make_grad_step(cfg, mesh),
                       in_shardings=(psh, bsh))(params, batch)
    state = jax.device_put(opt.init(params), osh)
    step = jax.jit(make_train_step(cfg, opt, mesh),
                   in_shardings=(psh, osh, bsh))
    new, _, metrics = step(params, state, batch)
    out = {}
    for prefix, tree in (("g/", grads), ("p/", new)):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        out.update({prefix + "/".join(k.key for k in path): np.asarray(x)
                    for path, x in flat})
    np.savez(os.path.join(d, f"jax{i}.npz"),
             loss=np.float32(metrics["loss"]), **out)
"""

FLASH_CASES = {   # name: ((H, Kv), q/k/v placements on ("data", "model"),
    #                      where q and where k, v compute, rank 0's kv
    #                      heads (None: all), window); B = 2, S = 256
    "replicated": ((4, 4), (R, R), (R, R), (R, R), None, 0),
    "batch-heads": ((4, 4), (S0, S2), (S0, S2), (S0, S2), None, 0),
    "batch-seq": ((4, 4), (S0, S1), (S0, S1), (S0, R), None, 0),
    "seq-heads": ((4, 4), (S1, S2), (S1, S2), (R, S2), None, 0),
    "batch-batch": ((4, 4), (S0, S0), (S0, R), (S0, R), None, 0),  # B = 2
    "heads-heads": ((4, 4), (S2, S2), (S2, S2), (S2, S2), None, 0),
    "two-heads": ((2, 2), (S0, S2), (S0, S2), (S0, S2), None, 0),
    "gqa-batch-heads": ((4, 2), (S0, S2), (S0, S2), (S0, S2), None, 0),
    # Kv = 2 over 4: k, v whole over model, each rank on its one kv head
    "gqa-heads-heads": ((4, 2), (S2, S2), (S2, S2), (S2, R), (0, 1), 0),
    "mqa-batch-heads": ((4, 1), (S0, S2), (S0, S2), (S0, R), (0, 1), 0),
    # the sequence over model, causal, without and with a window, and
    # over both mesh dims (each rank at its own query offset)
    "seq-model": ((4, 2), (R, S1), (R, S1), (R, R), None, 0),
    "seq-model-window": ((4, 2), (R, S1), (R, S1), (R, R), None, 64),
    "seq-seq": ((4, 1), (S1, S1), (S1, S1), (R, R), None, 0),
}
# The plain attention cores on DTensors: q, k, v (2, 256, 4 / 1, 16) with
# q over model's sequence (batch over data), a causal mask sharded by its
# query rows, or the chunked core at the rank's query offset.
CORE_CASES = {"mask": 0, "mask-window": 64, "chunked": 0,
              "chunked-window": 64}
SCAN_CASES = {
    "replicated": (Replicate(), Replicate()),
    "batch-width": (Shard(0), Shard(2)),
    "seq-width": (Shard(1), Shard(2)),
}


def numpy_inputs(replace=None):
    """Smoke gemma-7b weights (its config with ``replace``) and a batch from
    numpy seed 0."""
    cfg = get_config(ARCH, smoke=True).replace(**(replace or {}))
    rng = np.random.default_rng(0)
    params = tree_map(lambda s: (0.1 * rng.standard_normal(s))
                      .astype(np.float32), tt.param_shapes(cfg))
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return cfg, params, tokens


class _SavedSlices(sh._Slice):
    """``sharding._Slice`` that records the local bytes of each slice a
    checkpoint saves."""
    seen = []

    def __init__(self, *args):
        super().__init__(*args)
        self.seen.append(self.part.to_local().untyped_storage().nbytes())


def _sharded_step(mesh, replace) -> dict:
    cfg, params, tokens = numpy_inputs(replace)
    opt = make_optimizer("adamw", lr=LR)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:])}
    (psh, osh, bsh), _, _ = steps.train_in_shardings(cfg, opt, batch, mesh)
    tp = sh.distribute(params_from_numpy(params, "cpu"), psh)
    batch = sh.distribute(batch, bsh)
    _SavedSlices.seen = []
    saved, sh._Slice = sh._Slice, _SavedSlices
    try:
        grads, _ = steps.make_grad_step(cfg, mesh)(tp, batch)
    finally:
        sh._Slice = saved
    grads = {"g/" + path: x.full_tensor().numpy() for path, x in paths(grads)}
    state = opt.init(tp)
    tp, state, metrics = steps.make_train_step(cfg, opt, mesh)(
        tp, state, batch)
    placed = [x.placements == s.placements and x.requires_grad
              for x, s in zip(leaves(tp), leaves(psh))]
    placed += [isinstance(x, int) or x.placements == s.placements
               for x, s in zip(leaves(state), leaves(osh))]
    return {"loss": float(metrics["loss"]), "misplaced": placed.count(False),
            "saved_bytes": np.array(_SavedSlices.seen, dtype=np.int64),
            **grads, **{"p/" + path: x.full_tensor().detach().numpy()
               for path, x in paths(tp)}}


def _kernel_rules(mesh) -> dict:
    """Each op on DTensors against the plain call: the output's and the
    gradients' largest difference, and the placements it computed in."""
    out = {}
    gen = torch.Generator().manual_seed(0)
    for name, ((h, kv), pl, *_, window) in FLASH_CASES.items():
        shapes = [(2, 256, h, 16), (2, 256, kv, 16), (2, 256, kv, 16)]
        q, k, v = (torch.randn(s, generator=gen) for s in shapes)
        g = torch.randn(shapes[0], generator=gen)
        plain = [x.clone().requires_grad_() for x in (q, k, v)]
        want = ref.flash_attention_ref(*plain, causal=True, window=window)
        want.backward(g)
        dts = [distribute_tensor(x, mesh, pl).requires_grad_()
               for x in (q, k, v)]
        got = ops.flash_attention(*dts, causal=True, window=window)
        got.backward(distribute_tensor(g, mesh, got.placements))
        out[f"flash/{name}/err"] = (got.full_tensor() - want).abs().max()
        out[f"flash/{name}/grad_err"] = max(
            (d.grad.full_tensor() - p.grad).abs().max()
            for d, p in zip(dts, plain))
        out[f"flash/{name}/grad_rel"] = max(
            (d.grad.full_tensor() - p.grad).abs().max() / p.grad.abs().max()
            for d, p in zip(dts, plain))
        out[f"flash/{name}/placements"] = str(tuple(got.placements))
        lay = ops._flash_placements(*dts[:2])
        out[f"flash/{name}/kv"] = str((lay.kv, lay.kv_heads))
    out.update(_core_rules(mesh, gen))
    for name, pl in SCAN_CASES.items():
        a = torch.sigmoid(torch.randn(2, 512, 256, generator=gen)) * 0.2 + 0.8
        b = 0.1 * torch.randn(2, 512, 256, generator=gen)
        g = torch.randn(2, 512, 256, generator=gen)
        plain = [x.clone().requires_grad_() for x in (a, b)]
        want = ref.rglru_scan_ref(*plain)
        want.backward(g)
        dts = [distribute_tensor(x, mesh, pl).requires_grad_() for x in (a, b)]
        got = ops.rglru_scan(*dts)
        got.backward(distribute_tensor(g, mesh, got.placements))
        out[f"scan/{name}/err"] = (got.full_tensor() - want).abs().max()
        out[f"scan/{name}/grad_err"] = max(
            (d.grad.full_tensor() - p.grad).abs().max()
            for d, p in zip(dts, plain))
        out[f"scan/{name}/placements"] = str(tuple(got.placements))
    return {k: v.item() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def _core_rules(mesh, gen) -> dict:
    """``CORE_CASES`` on DTensors against the plain calls."""
    from types import SimpleNamespace
    from repro_torch.models import layers
    out = {}
    for name, window in CORE_CASES.items():
        shapes = [(2, 256, 4, 16), (2, 256, 1, 16), (2, 256, 1, 16)]
        qkv = [torch.randn(s, generator=gen) for s in shapes]
        g = torch.randn(shapes[0], generator=gen)
        if name.startswith("mask"):
            mask = layers.causal_mask(256, 256, "cpu", window=window)

            def core(q, k, v):
                return layers.mha_logits_to_out(q, k, v, mask, None)
        else:
            cfg = SimpleNamespace(attention_chunk=64)

            def core(q, k, v):
                return layers.chunked_attention(q, k, v, cfg, window=window)
        plain = [x.clone().requires_grad_() for x in qkv]
        want = core(*plain)
        want.backward(g)
        dts = [distribute_tensor(x, mesh, (S0, S1)).requires_grad_()
               for x in qkv]
        got = core(*dts)
        got.backward(distribute_tensor(g, mesh, got.placements))
        out[f"core/{name}/err"] = (got.full_tensor() - want).abs().max()
        out[f"core/{name}/grad_rel"] = max(
            (d.grad.full_tensor() - p.grad).abs().max() / p.grad.abs().max()
            for d, p in zip(dts, plain))
        out[f"core/{name}/placements"] = str(tuple(got.placements))
    return out


def _rank_main(rank: int, world: int, d: str) -> None:
    """One gloo rank: the sharded step, then the kernels' rules; rank 0
    writes what it found."""
    torch.set_num_threads(1)     # 4 ranks on a few cores
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        found = {prefix + k: v for prefix, replace in RUNS.items()
                 for k, v in _sharded_step(mesh, replace).items()}
        found.update(_kernel_rules(mesh))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(d, "port.npz"), **found)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(port, jax): what the 4 gloo ranks and the reference on 4 host
    devices found, run side by side."""
    d = str(tmp_path_factory.mktemp("sharded"))
    for i, replace in enumerate(RUNS.values()):
        _, params, tokens = numpy_inputs(replace)
        np.savez(os.path.join(d, f"inputs{i}.npz"), tokens=tokens, lr=LR,
                 **{"p/" + path: x for path, x in paths(params)})
    ref_run = subprocess.Popen([sys.executable, "-c", JAX_STEP, d,
                                json.dumps(list(RUNS.values()))],
                               cwd=ROOT, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    try:
        ctx = torch.multiprocessing.spawn(_rank_main, args=(4, d),
                                          nprocs=4, join=False)
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
    want = {}
    for i, prefix in enumerate(RUNS):
        found = np.load(os.path.join(d, f"jax{i}.npz"))
        want.update({prefix + k: found[k] for k in found.files})
    return dict(np.load(os.path.join(d, "port.npz"))), want


def _check_grads(port, want, prefix: str) -> None:
    keys = sorted(k for k in want if k.startswith(prefix + "g/"))
    assert keys and keys == sorted(k for k in port
                                   if k.startswith(prefix + "g/"))
    for k in keys:
        scale = np.linalg.norm(want[k])
        assert scale > 0, k
        assert np.linalg.norm(port[k] - want[k]) <= 1e-4 * scale, k


def _check_params(port, want, prefix: str) -> None:
    keys = sorted(k for k in want if k.startswith(prefix + "p/"))
    assert keys and keys == sorted(k for k in port
                                   if k.startswith(prefix + "p/"))
    for k in keys:
        err = np.abs(port[k] - want[k])
        assert (err <= 1e-4 * (1 + np.abs(want[k]))).all(), (k, err.max())


def test_sharded_step_loss_matches_jax(sharded):
    port, want = sharded
    np.testing.assert_allclose(port["loss"], want["loss"], rtol=1e-5)


def test_sharded_grads_match_jax(sharded):
    """``make_grad_step``'s gradients, leaf by leaf, within 1e-4 of the
    leaf's norm: AdamW's first step moves each weight by about lr·sign(g)
    whatever g's scale, so the params alone would pass a gradient reduced
    twice, or summed where the mean is wanted."""
    _check_grads(*sharded, "")


def test_sharded_step_params_match_jax(sharded):
    """Every updated param within 1e-4 (1 + |x|): the card-vs-CPU bound of
    PERF.md section 2 (AdamW moves each weight by about the lr, 1e-3)."""
    _check_params(*sharded, "")


def test_sharded_step_keeps_every_placement(sharded):
    port, _ = sharded
    assert int(port["misplaced"]) == 0


def test_sharded_remat_step_loss_matches_jax(sharded):
    """The ``remat/`` run: each group's input saved as 1/2 of its local
    bytes and gathered for the replay; the reference's step with remat."""
    port, want = sharded
    np.testing.assert_allclose(port["remat/loss"], want["remat/loss"],
                               rtol=1e-5)


def test_sharded_remat_grads_match_jax(sharded):
    _check_grads(*sharded, "remat/")


def test_sharded_remat_step_params_match_jax(sharded):
    _check_params(*sharded, "remat/")
    assert int(sharded[0]["remat/misplaced"]) == 0


def test_remat_saves_the_ranks_slice_of_each_group_input(sharded):
    """With remat and q over the sequence, the grad step's checkpoint saves
    each group's input (B/2, S, d) fp32 on a rank as its slice over
    ``model``: 1/2 of those bytes, one a group. Without remat it saves
    none."""
    port, _ = sharded
    cfg = get_config(ARCH, smoke=True).replace(**RUNS["remat/"])
    x_bytes = B // 2 * S * cfg.d_model * 4
    assert port["remat/saved_bytes"].tolist() == [x_bytes // 2] * cfg.n_groups
    assert port["saved_bytes"].size == 0


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_rule_on_dtensors(name, sharded):
    """Attention on DTensors equals the plain call (1e-6: a shard's
    products may be blocked otherwise). It keeps q's batch, heads and
    sequence shards where they divide; k and v keep batch and the heads
    shards whose product divides Kv, and are whole elsewhere, each rank
    reading the kv heads its q heads map to. Gradients within 1e-6, of
    their largest magnitude where k's and v's are partial sums."""
    port, _ = sharded
    _, _, q_at, kv_at, heads, _ = FLASH_CASES[name]
    assert port[f"flash/{name}/err"] <= 1e-6
    if any(p != R and pkv == R for p, pkv in zip(q_at, kv_at)):
        # k's and v's gradients are sums over the ranks, in another order
        # of addition than the plain call's: 1e-6 of each one's largest
        assert port[f"flash/{name}/grad_rel"] <= 1e-6
    else:
        assert port[f"flash/{name}/grad_err"] <= 1e-6
    assert str(port[f"flash/{name}/placements"]) == str(q_at)
    assert str(port[f"flash/{name}/kv"]) == str((kv_at, heads))


@pytest.mark.parametrize("name", sorted(CORE_CASES))
def test_attention_core_on_dtensors(name, sharded):
    """The plain cores with q over model's sequence: the output equals the
    plain call's (1e-6) and the gradients within 1e-6 of their largest
    magnitude (k's and v's are sums over the ranks); the output is over
    the sequence as q is."""
    port, _ = sharded
    assert port[f"core/{name}/err"] <= 1e-6
    assert port[f"core/{name}/grad_rel"] <= 1e-6
    assert str(port[f"core/{name}/placements"]) == str((S0, S1))


@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_scan_rule_on_dtensors(name, sharded):
    """The scan on DTensors, forward and reverse, bit-equal to the plain
    call: each element's recurrence is the same arithmetic on any shard."""
    port, _ = sharded
    assert port[f"scan/{name}/err"] == 0.0
    assert port[f"scan/{name}/grad_err"] == 0.0
    assert "Shard(dim=1)" not in str(port[f"scan/{name}/placements"])
