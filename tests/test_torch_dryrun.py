"""The dry-run (``repro_torch.launch.dryrun``) and what it counts, on the CPU,
against the reference's pieces.

* The sharded flash step: gemma-7b smoke (fp32, 2 layers, B = 4,
  S = 256, the flash kernel on) on a (2, 2) mesh of 4 gloo ranks, against
  the unsharded port step (loss 1e-5 relative, each gradient 1e-4 of its
  norm) and against the reference's step with its kernel on (interpret
  mode) jitted on 4 forced host devices; deepseek-moe-16b's smoke step
  and two gemma decode steps on the mesh against the unsharded ones.
* ``shape_applicable`` and the input specs of 10 archs x 4 shapes.
* The collectives: ``_wire_bytes`` rule for rule, and one redistribute of
  each kind over a fake (4,) mesh against ``parse_collectives`` of the same
  reshard jitted on the 4 host devices.
* A (2, 2) smoke train cell's FLOPs a device against ``parse_hlo_profile``
  of the reference's compiled step on the same mesh; two more whose heads
  do not divide ``model`` (``CELLS``: q over the sequence, and q over
  heads with k and v whole), their steps flash on and off against the
  unsharded port's and the reference's, each gradient in its parameter's
  placements, their FLOPs equal to the reference's (flash off); their
  prefills, with the rotation and without, against both.
* A step traced on fake tensors against the same step on real ones.
* A production cell, gemma-7b ``train_4k`` on 16 x 16, ``ok``.
* xlstm-350m's recurrent cells, traced at S = 16 and 32 and extrapolated
  to the cell's S: at a 2-layer cut the fit equals a direct trace at
  S = 48 in every count, for ``train`` and ``prefill``.
* The flash op's fake kernel: the CUDA wrapper's contract on ``cuda``.
* Adafactor's update on DTensors allocates a shard's bytes, not a leaf's.
"""
import dataclasses
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
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import shapes as jax_shapes
from repro.core import hlo_analysis
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, get_config,
                                 input_specs, shape_applicable)
from repro_torch.convert import params_from_numpy
from repro_torch.core import comm_count
from repro_torch.launch import dryrun, make_debug_mesh, steps
from repro_torch.models import transformer as tt
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, B, S, LR = "gemma-7b", 4, 256, 1e-3
MOE = "deepseek-moe-16b"     # its routing and experts on DTensors
DECODE_LEN, DECODE_STEPS = 16, 2
TIMEOUT_S = 240
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

JAX_REF = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, "src")
from repro.configs import get_config
from repro.core.hlo_analysis import parse_collectives
from repro.core.hlo_static import parse_hlo_profile
from repro.launch.steps import (batch_shardings, make_grad_step,
                                make_prefill_step, make_train_step,
                                train_in_shardings)
from repro.optim import make_optimizer

d = sys.argv[1]
inp = np.load(os.path.join(d, "inputs.npz"))
with open(os.path.join(d, "cells.json")) as f:
    cells = json.load(f)      # {prefix: config overrides}; "" is gemma's


def tree(prefix):
    params = {}
    for key in inp.files:
        if key.startswith(prefix + "p/"):
            *path, last = key[len(prefix) + 2:].split("/")
            node = params
            for k in path:
                node = node.setdefault(k, {})
            node[last] = inp[key]
    return params


auto = jax.sharding.AxisType.Auto   # hints, where make_mesh defaults to
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto,) * 2)
opt = make_optimizer("adamw", lr=float(inp["lr"]))
out, counts = {}, {}
for prefix, over in cells.items():
    params = tree(prefix)
    toks = inp[prefix + "tokens"]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for flash in (False, True):
        cfg = get_config("gemma-7b", smoke=True).replace(
            use_flash_kernel=flash, **over)
        (psh, osh, bsh), pshapes, oshapes = train_in_shardings(
            cfg, opt, batch, mesh)
        # gemma's grads with the kernel on; each new cell's with it on and off
        key = prefix + (f"flash={flash}/" if prefix else "")
        if flash or prefix:
            grads, metrics = jax.jit(make_grad_step(cfg, mesh),
                                     in_shardings=(psh, bsh))(
                jax.device_put(params, psh), jax.device_put(batch, bsh))
            flat, _ = jax.tree_util.tree_flatten_with_path(grads)
            out.update({key + "g/" + "/".join(k.key for k in path):
                        np.asarray(x) for path, x in flat})
            out[key + "loss"] = np.float32(metrics["loss"])
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in batch.items()}
        compiled = jax.jit(make_train_step(cfg, opt, mesh),
                           in_shardings=(psh, osh, bsh),
                           donate_argnums=(0, 1)).lower(
            pshapes, oshapes, specs).compile()
        prof = parse_hlo_profile(compiled.as_text())
        m = compiled.memory_analysis()
        counts[f"{prefix}flash={flash}"] = {
            "flops": prof.flops,
            "bytes_by_kind": prof.collective_by_kind,
            "bytes": m.argument_size_in_bytes + m.output_size_in_bytes
            + m.temp_size_in_bytes - m.alias_size_in_bytes}
    # each new cell's prefill (flash off), with its rotation and without
    pre = {"tokens": batch["tokens"]}
    for rope in (True, False) if prefix else ():
        cfg = get_config("gemma-7b", smoke=True).replace(
            **over, **({} if rope else {"rope_theta": 0.0}))
        (psh, _, _), _, _ = train_in_shardings(cfg, opt, batch, mesh)
        ish = (psh, batch_shardings(pre, mesh))
        out[f"{prefix}rope={rope}/logits"] = np.asarray(jax.jit(
            make_prefill_step(cfg, mesh), in_shardings=ish)(
            jax.device_put(params, psh), jax.device_put(pre, ish[1])))
line = jax.make_mesh((4,), ("x",), axis_types=(auto,))
S0, S1, R = (NamedSharding(line, p) for p in (P("x"), P(None, "x"), P()))
# a partial sum on each device (its slice of a (4, 16, 64) stack), summed
# whole or scattered
psum = jax.shard_map(lambda x: jax.lax.psum(x[0], "x"), mesh=line,
                     in_specs=P("x"), out_specs=P())
psum_scatter = jax.shard_map(
    lambda x: jax.lax.psum_scatter(x[0], "x", scatter_dimension=0,
                                   tiled=True),
    mesh=line, in_specs=P("x"), out_specs=P("x"))
RESHARDS = {   # kind: (function, input shape, in / out shardings)
    "all-gather": (lambda x: x, (16, 64), S0, R),
    "all-to-all": (lambda x: x, (16, 64), S0, S1),
    "all-reduce": (psum, (4, 16, 64), S0, R),
    "reduce-scatter": (psum_scatter, (4, 16, 64), S0, S0),
}
for kind, (fn, shape, src, dst) in RESHARDS.items():
    hlo = jax.jit(fn, in_shardings=src, out_shardings=dst).lower(
        jax.ShapeDtypeStruct(shape, jnp.float32)).compile().as_text()
    st = parse_collectives(hlo)
    counts[kind] = {"count": st.count_by_kind, "bytes": st.bytes_by_kind}
np.savez(os.path.join(d, "jax.npz"), **out)
with open(os.path.join(d, "jax.json"), "w") as f:
    json.dump(counts, f)
"""


# Smoke gemma-7b with heads that do not divide ``model``'s 2, as the
# reference lays them out: q over the sequence (H = 3), and q over heads
# with k and v whole (H = 4, Kv = 1).
CELLS = {"seq": {"n_heads": 3, "n_kv": 1},
         "heads-whole-kv": {"n_heads": 4, "n_kv": 1}}


def numpy_inputs(arch: str = ARCH, **over):
    """Smoke weights of ``arch`` (its config ``.replace``d by ``over``) and
    a batch from numpy seed 0."""
    cfg = get_config(arch, smoke=True).replace(**over)
    rng = np.random.default_rng(0)
    params = tree_map(lambda s: (0.1 * rng.standard_normal(s))
                      .astype(np.float32), tt.param_shapes(cfg))
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return cfg, params, tokens


def paths(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _grad_step(mesh, arch: str = ARCH, flash: bool = True,
               train: bool = False, **over) -> dict:
    """The grad step's loss and gradients, on ``mesh`` or (None)
    unsharded, the flash kernel on unless ``flash`` is False; with
    ``train`` also the attention weights' gradients' placements beside
    their parameters' ("pl/"), then one train step on the mesh and the
    count of its new parameter and optimizer-state leaves not in their
    rules' placements ("misplaced")."""
    cfg, params, tokens = numpy_inputs(arch, **over)
    cfg = cfg.replace(use_flash_kernel=flash)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:])}
    tp = params_from_numpy(params, "cpu")
    if mesh is not None:
        opt = make_optimizer("adamw", lr=LR)
        (psh, osh, bsh), _, _ = steps.train_in_shardings(cfg, opt, batch,
                                                         mesh)
        tp, batch = sh.distribute(tp, psh), sh.distribute(batch, bsh)
    grads, metrics = steps.make_grad_step(cfg, mesh)(tp, batch)
    whole = (lambda x: x.full_tensor()) if mesh is not None else (
        lambda x: x)
    out = {"loss": float(metrics["loss"]),
           **{"g/" + p: whole(x).detach().numpy() for p, x in paths(grads)}}
    if train:
        attn = tp["scan"]["s0_attn"]["attn"]
        out.update({"pl/" + n: np.array([str(g.placements),
                                         str(attn[n].placements)])
                    for n, g in grads["scan"]["s0_attn"]["attn"].items()})
        state = opt.init(tp)
        tp, state, _ = steps.make_train_step(cfg, opt, mesh)(tp, state,
                                                             batch)
        placed = [x.placements == s.placements
                  for (_, x), (_, s) in zip(paths(tp), paths(psh))]
        placed += [isinstance(x, int) or x.placements == s.placements
                   for (_, x), (_, s) in zip(paths(state), paths(osh))]
        out["misplaced"] = placed.count(False)
    return out


def _prefill(mesh, rope: bool, **over) -> np.ndarray:
    """The prefill step's logits (flash off), with the config's rotation
    or (``rope`` False) none, on ``mesh`` or (None) unsharded."""
    cfg, params, tokens = numpy_inputs(**over)
    if not rope:
        cfg = cfg.replace(rope_theta=0.0)
    pre = {"tokens": torch.from_numpy(tokens[:, :-1])}
    tp = params_from_numpy(params, "cpu")
    if mesh is not None:
        opt = make_optimizer("adamw", lr=LR)
        (psh, _, _), _, _ = steps.train_in_shardings(
            cfg, opt, {**pre, "labels": pre["tokens"]}, mesh)
        tp = sh.distribute(tp, psh)
        pre = sh.distribute(pre, steps.batch_shardings(pre, mesh))
    logits = steps.make_prefill_step(cfg, mesh)(tp, pre)
    return (logits.full_tensor() if mesh is not None else logits).numpy()


def _decode(mesh) -> dict:
    """Logits and the K cache after ``DECODE_STEPS`` steps from a zero
    state, on ``mesh`` or (None) unsharded."""
    cfg, params, tokens = numpy_inputs()
    tp = params_from_numpy(params, "cpu")
    state = tt.init_decode_state(cfg, B, DECODE_LEN, device="cpu")
    toks = [torch.from_numpy(tokens[:, i]) for i in range(DECODE_STEPS)]
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
            "cache_k": whole(state["scan"]["s0_attn"]["k"]).numpy()}


R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)
EINSUM_CASES = {   # name: (equation, operand shapes, placements on (2, 2))
    "fsdp-tp": ("...d,df->...f", [(4, 6, 8), (8, 4)], [(S0, R), (S0, S1)]),
    "row-parallel": ("...f,fd->...d", [(4, 6, 8), (8, 4)],
                     [(S0, S2), (R, S0)]),
    "heads": ("bskd,btkd->bkst", [(4, 6, 2, 8), (4, 6, 2, 8)],
              [(S0, S2), (S0, R)]),
    # j is contracted and only the first operand holds it: a partial sum,
    # and the second operand's gradient a partial sum too
    "missing-subscript": ("ij,k->ik", [(4, 8), (6,)], [(R, S1), (R, R)]),
}


def _einsum_cases(mesh) -> dict:
    """``sharding.einsum`` on DTensors against ``torch.einsum``: the
    output's and the gradients' largest difference."""
    from torch.distributed.tensor import distribute_tensor
    gen, out = torch.Generator().manual_seed(1), {}
    for name, (eq, shapes, placements) in EINSUM_CASES.items():
        xs = [torch.randn(s, generator=gen) for s in shapes]
        plain = [x.clone().requires_grad_() for x in xs]
        want = torch.einsum(eq, *plain)
        g = torch.randn(want.shape, generator=gen)
        want.backward(g)
        dts = [distribute_tensor(x, mesh, p).requires_grad_()
               for x, p in zip(xs, placements)]
        got = sh.einsum(eq, *dts)
        got.backward(sh.constant_like(g, got))   # whole on every rank
        out[f"einsum/{name}"] = max(
            [float((got.full_tensor() - want).abs().max())]
            + [float((d.grad.full_tensor() - p.grad).abs().max())
               for d, p in zip(dts, plain)])
    return out


def _rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)     # 4 ranks on a few cores
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        found = {**_grad_step(mesh),
                 **{"decode/" + k: v for k, v in _decode(mesh).items()},
                 **{MOE + "/" + k: v
                    for k, v in _grad_step(mesh, MOE).items()},
                 **_einsum_cases(mesh),
                 **{f"{cell}/flash={flash}/{k}": v
                    for cell, flash in CELL_RUNS
                    for k, v in _grad_step(mesh, flash=flash, train=True,
                                           **CELLS[cell]).items()},
                 **{f"{cell}/rope={rope}/logits":
                    _prefill(mesh, rope, **CELLS[cell])
                    for cell in CELLS for rope in (True, False)}}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(d, "port.npz"), **found)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port on 4 gloo ranks, reference on 4 host devices, the reference's
    counts) run side by side."""
    d = str(tmp_path_factory.mktemp("dryrun"))
    cells = {"": {}, **{cell + "/": over for cell, over in CELLS.items()}}
    inputs = {"lr": LR}
    for prefix, over in cells.items():
        _, params, tokens = numpy_inputs(**over)
        inputs[prefix + "tokens"] = tokens
        inputs.update({prefix + "p/" + path: x for path, x in paths(params)})
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    with open(os.path.join(d, "cells.json"), "w") as f:
        json.dump(cells, f)
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
    with open(os.path.join(d, "jax.json")) as f:
        counts = json.load(f)
    return (dict(np.load(os.path.join(d, "port.npz"))),
            dict(np.load(os.path.join(d, "jax.npz"))), counts)


@pytest.fixture(scope="module")
def unsharded():
    return _grad_step(None)


CELL_RUNS = [(cell, flash) for cell in CELLS for flash in (False, True)]


@pytest.fixture(scope="module")
def unsharded_cells():
    return {(cell, flash): _grad_step(None, flash=flash, **CELLS[cell])
            for cell, flash in CELL_RUNS}


# ---------------------------------------------------------------------------
# The sharded flash step (fault 1) and decode on the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("against", ["unsharded port", "reference"])
def test_sharded_flash_step_matches(against, runs, unsharded):
    """The (2, 2) step with the flash kernel on: its backward ran on
    DTensors (the kernel's VJP under ``local_map``) and its loss and every
    gradient hold to the sharding tests' bounds."""
    port, jref, _ = runs
    _assert_step_matches(port, unsharded if against == "unsharded port"
                         else jref)


def _assert_step_matches(port: dict, want: dict) -> None:
    """The loss within 1e-5 relative and each gradient within 1e-4 of its
    norm: the sharding tests' bounds."""
    np.testing.assert_allclose(port["loss"], want["loss"], rtol=1e-5)
    keys = sorted(k for k in want if k.startswith("g/"))
    assert keys and keys == sorted(k for k in port if k.startswith("g/"))
    for k in keys:
        scale = np.linalg.norm(want[k])
        assert scale > 0, k
        assert np.linalg.norm(port[k] - want[k]) <= 1e-4 * scale, k


def _cell_run(found: dict, cell: str, flash: bool) -> dict:
    prefix = f"{cell}/flash={flash}/"
    return {k[len(prefix):]: v for k, v in found.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("against", ["unsharded port", "reference"])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_attention_cell_step_matches(cell, flash, against, runs,
                                     unsharded_cells):
    """The (2, 2) steps whose heads do not divide ``model``, flash on and
    off: "seq" computes attention on q's sequence shards at each rank's
    query offset, q's and k's products on x's sequence shard and v's
    whole; "heads-whole-kv" on q's head shards with k and v whole, each
    rank reading its one kv head. k's and v's gradients come back as
    partial sums, are reduce-scattered to x's sequence shard and their
    weight gradients taken there (with q over the sequence their input
    gradients too). Held as the gemma step is, against the unsharded port
    step and the reference's step on 4 host devices."""
    port, jref, _ = runs
    want = (unsharded_cells[cell, flash] if against == "unsharded port"
            else _cell_run(jref, cell, flash))
    _assert_step_matches(_cell_run(port, cell, flash), want)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_attention_cell_train_step_keeps_the_leaves_placements(cell, flash,
                                                                runs):
    """The (2, 2) cells' steps: the attention weights' gradients in their
    parameters' placements, wk's and wv's too, whose products take their
    backward on x's sequence shard (their pending sums reduced to the
    FSDP shard); after one train step every new parameter and
    optimizer-state leaf in its rule's placements."""
    run = _cell_run(runs[0], cell, flash)
    placed = {k: v for k, v in run.items() if k.startswith("pl/")}
    assert sorted(placed) == ["pl/wk", "pl/wo", "pl/wq", "pl/wv"]
    for k, (grad, param) in placed.items():
        assert grad == param, k
    assert run["misplaced"] == 0


@pytest.mark.parametrize("against", ["unsharded port", "reference"])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_attention_cell_prefill_matches(cell, rope, against, runs):
    """The (2, 2) cells' prefill steps, with the rotation and without:
    with q over the sequence, k's product on x's sequence shard, gathered
    for the core, and v's whole; with q over heads, both whole. Their
    logits within 1e-5 of the unsharded port's prefill and of the
    reference's jitted on 4 host devices."""
    port, jref, _ = runs
    key = f"{cell}/rope={rope}/logits"
    want = (_prefill(None, rope, **CELLS[cell])
            if against == "unsharded port" else jref[key])
    got = port[key]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sharded_moe_step_matches_the_unsharded_step(runs):
    """deepseek-moe-16b's smoke grad step on the (2, 2) mesh: the router,
    its top-k and slots, the dense dispatch and combine and the experts
    on DTensors, held as the gemma step is."""
    port = {k[len(MOE) + 1:]: v for k, v in runs[0].items()
            if k.startswith(MOE + "/")}
    want = _grad_step(None, MOE)
    np.testing.assert_allclose(port["loss"], want["loss"], rtol=1e-5)
    keys = sorted(k for k in want if k.startswith("g/"))
    assert keys and keys == sorted(k for k in port if k.startswith("g/"))
    for k in keys:
        scale = np.linalg.norm(want[k])
        if scale == 0:      # an expert no token reached
            assert not port[k].any(), k
            continue
        assert np.linalg.norm(port[k] - want[k]) <= 1e-4 * scale, k


@pytest.mark.parametrize("name", sorted(EINSUM_CASES))
def test_einsum_on_shards_matches_torch_einsum(name, runs):
    """Each layout ``sharding.einsum`` picks computes the plain einsum and
    its gradients (1e-5: a shard's sums may be split otherwise)."""
    assert runs[0][f"einsum/{name}"] <= 1e-5


@pytest.mark.parametrize("what", ["logits", "cache_k"])
def test_decode_on_the_mesh_matches_the_unsharded_steps(what, runs):
    """Two serve steps on the mesh: the KV cache is sharded over its
    sequence, so each rank writes the new row only where its shard holds
    the slot (``sharding.write_slot``)."""
    port, _, _ = runs
    want = _decode(None)[what]
    got = port["decode/" + what]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Shapes and input specs
# ---------------------------------------------------------------------------


def _spec_tree(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of specs."""
    out = {}
    for path, x in paths(tree, prefix):
        dtype = getattr(x.dtype, "name", None) or str(x.dtype)
        out[path] = (tuple(x.shape), dtype.replace("torch.", ""))
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert shape_applicable(cfg, shape) == jax_shapes.shape_applicable(
        jcfg, shape)
    got = _spec_tree(input_specs(cfg, shape))
    want = _spec_tree(jax_shapes.input_specs(jcfg, shape))
    assert got == want
    assert all(x.is_meta for _, x in paths(input_specs(cfg, shape)))


def test_every_arch_and_shape_is_covered():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert list(SHAPES) == list(jax_shapes.SHAPES)
    assert all(SHAPES[k].__dict__ == jax_shapes.SHAPES[k].__dict__
               for k in SHAPES)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_are_the_references(kind, n):
    for out_bytes in (0, 1, 1000, 4096, 3 * 2**20 + 7):
        assert comm_count._wire_bytes(kind, out_bytes, n) \
            == hlo_analysis._wire_bytes(kind, out_bytes, n)


def _one_reshard(kind: str) -> comm_count.CollectiveStats:
    """One redistribute of a (16, 64) fp32 tensor over a fake (4,) mesh,
    counted. DTensor on a CPU mesh replaces the all-to-all of a shard move
    by an all-gather and a chunk, so that case calls the op its
    redistribute issues on a CUDA mesh on the same local shard."""
    with dryrun.fake_process_group(4):
        mesh = init_device_mesh("cpu", (4,))
        with FakeTensorMode():
            shard, whole = torch.zeros(4, 64), torch.zeros(16, 64)
            if kind == "all-to-all":
                group = mesh.get_group(0).group_name
                return comm_count.count_collectives(
                    torch.ops._dtensor.shard_dim_alltoall, shard, 0, 1, group)
            src, dst = {"all-gather": ([Shard(0)], [Replicate()]),
                        "all-reduce": ([Partial()], [Replicate()]),
                        "reduce-scatter": ([Partial()], [Shard(0)])}[kind]
            x = DTensor.from_local(shard if src == [Shard(0)] else whole,
                                   mesh, src, run_check=False)
            return comm_count.count_collectives(x.redistribute, mesh, dst)


@pytest.mark.parametrize("kind", KINDS[:4])
def test_one_reshard_counts_what_the_reference_parses(kind, runs):
    want = runs[2][kind]
    got = _one_reshard(kind)
    assert got.count_by_kind == want["count"] == {kind: 1}
    assert got.bytes_by_kind == want["bytes"]


# ---------------------------------------------------------------------------
# A (2, 2) train cell against the reference's compiled step
# ---------------------------------------------------------------------------


def _smoke_cell(flash: bool, fake: bool = True, **over):
    cfg = get_config(ARCH, smoke=True).replace(use_flash_kernel=flash,
                                               **over)
    with dryrun.fake_process_group(4):
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        out = dryrun.trace_step(cfg, ShapeSpec("smoke", S, B, "train"),
                                mesh, fake=fake)
    return cfg, out["counts"]


@pytest.mark.parametrize("flash", [False, True])
def test_smoke_cell_flops_a_device_match_the_reference(flash, runs):
    """FLOPs a device, rank 0's local ops against ``parse_hlo_profile`` of
    the reference's step compiled for the same (2, 2) mesh.

    With the flash kernel off they are equal: DTensor computes the same
    products on each device as XLA's partitioner. With it on there is one
    structural gap, 2u per attention layer, u = 2·(B/2)·(H/2)·S·S·D (one
    of attention's two products on one device): the Pallas kernel's two
    products sit in conditional branches that ``parse_hlo_profile`` does
    not follow (``test_torch_predict.py``'s gap, with remat off). The flash
    op's backward forms no output product, which XLA drops from the plain
    VJP as dead. Collective bytes and bytes a device are printed beside
    the reference's."""
    cfg, got = _smoke_cell(flash)
    want = runs[2][f"flash={flash}"]
    gap = 0
    if flash:
        u = 2 * (B // 2) * (cfg.n_heads // 2) * S * S * cfg.head_dim
        gap = cfg.n_layers * 2 * u
    print(f"\nflash={flash}: FLOPs a device {got.flops} (reference "
          f"{want['flops']:.0f} + {gap}); collective wire bytes "
          f"{got.collectives.bytes_by_kind} (reference "
          f"{want['bytes_by_kind']}); bytes a device {got.peak_bytes} "
          f"(reference {want['bytes']}); local op bytes / XLA's "
          f"fusion-bounded bytes not compared here")
    assert got.flops == want["flops"] + gap


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_attention_cell_flops_a_device(cell, flash, runs):
    """FLOPs a device of the cells whose heads do not divide ``model``
    against ``parse_hlo_profile`` of the reference's compiled step: equal
    with flash off, and with it on the reference's plus the gemma cell's
    2u a layer, u = 2·(B/2)·H·S·S·D / 2 (model's 2 split the heads or the
    sequence). The k and v products run where XLA carries ``act_kv`` and
    ``act_heads_seq`` back into them: with q over the sequence, q's and
    k's forward products on x's sequence shard, v's whole, and every k
    and v gradient product on that shard; with q over heads, k and v
    whole, their weight gradients on the shard. Collective bytes and
    bytes a device printed beside the reference's."""
    cfg, got = _smoke_cell(flash, **CELLS[cell])
    want = runs[2][f"{cell}/flash={flash}"]
    gap = 0
    if flash:
        u = 2 * (B // 2) * cfg.n_heads * S * S * cfg.head_dim // 2
        gap = cfg.n_layers * 2 * u
    print(f"\n{cell} flash={flash}: FLOPs a device {got.flops} (reference "
          f"{want['flops']:.0f} + {gap}); collective wire bytes "
          f"{got.collectives.bytes_by_kind} (reference "
          f"{want['bytes_by_kind']}); bytes a device {got.peak_bytes} "
          f"(reference {want['bytes']})")
    assert got.flops == want["flops"] + gap


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fake_trace_counts_what_the_real_step_counts(kind):
    """The same (2, 2) step on fake and on real CPU tensors: FLOPs,
    collectives and the peak of live bytes equal."""
    cfg = get_config(ARCH, smoke=True).replace(use_flash_kernel=True)
    sp = ShapeSpec("smoke", S, B, kind)
    with dryrun.fake_process_group(4):
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        real = dryrun.trace_step(cfg, sp, mesh, fake=False)["counts"]
        fake = dryrun.trace_step(cfg, sp, mesh)["counts"]
    assert fake.flops == real.flops > 0
    assert fake.collectives.count_by_kind == real.collectives.count_by_kind
    assert fake.collectives.bytes_by_kind == real.collectives.bytes_by_kind
    assert fake.peak_bytes == real.peak_bytes >= fake.argument_bytes > 0


def test_flop_counter_sees_dtensor_ops_and_count_device_local_ones():
    """On a fake (4,) mesh one ``bmm`` of (8, 16, 32) by (8, 32, 16),
    batch-sharded: ``FlopCounterMode`` entered last sees the DTensor op
    (the global shapes' FLOPs); ``count_device`` hands DTensor ops back and
    counts rank 0's local op, a quarter of them."""
    from torch.distributed.tensor import distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core import flop_count
    with dryrun.fake_process_group(4):
        mesh = init_device_mesh("cpu", (4,))
        a = distribute_tensor(torch.randn(8, 16, 32), mesh, [S0])
        b = distribute_tensor(torch.randn(8, 32, 16), mesh, [S0])
        with FlopCounterMode(display=False) as counter:
            torch.bmm(a, b)
        local = flop_count.count_device(torch.bmm, a, b)
    assert counter.get_total_flops() == 2 * 8 * 16 * 32 * 16
    assert local.flops == 2 * 2 * 16 * 32 * 16 and local.local_ops == 1


# The reference's count of gemma-7b cut to 2 layers at ``train_4k`` on 16 x
# 16 (``repro.launch.dryrun``'s XLA CPU compile with ``AxisType.Auto`` axes,
# ``parse_hlo_profile``), to 4 digits.
REFERENCE_2_LAYER_FLOPS = "3.843e+13"


def test_two_layer_production_cell_flops_match_the_reference():
    """gemma-7b cut to 2 layers at ``train_4k`` on 16 x 16, flash off as
    the reference's config: FLOPs a device equal to the reference's to its
    quoted digits (the (2, 2) cell above holds them exactly)."""
    cfg = get_config("gemma-7b").replace(n_layers=2)
    with dryrun.fake_process_group(256):
        mesh = dryrun.make_production_mesh(device_type="cpu")
        c = dryrun.trace_step(cfg, SHAPES["train_4k"], mesh)["counts"]
    print(f"\n2-layer gemma-7b train_4k on 16x16: FLOPs a device "
          f"{c.flops}, peak {c.peak_bytes / 2**30:.2f} GiB, collective wire "
          f"bytes {c.collectives.bytes_by_kind}")
    assert f"{c.flops:.4g}" == REFERENCE_2_LAYER_FLOPS


# ---------------------------------------------------------------------------
# A production cell and the CLI's record
# ---------------------------------------------------------------------------

RECORD_KEYS = {"arch", "shape", "optimized", "mesh", "status", "kind",
               "chips", "lower_s", "compile_s", "memory", "cost",
               "collectives", "top_ops", "roofline"}


def test_production_cell_is_ok():
    """gemma-7b ``train_4k`` on 16 x 16 (256 fake ranks), fake CPU
    tensors: an ``ok`` record with the reference's keys."""
    rec = dryrun.dryrun_cell("gemma-7b", "train_4k", device="cpu",
                             verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == RECORD_KEYS
    assert rec["chips"] == 256 and rec["kind"] == "train"
    r = rec["roofline"]
    assert r["flops"] > 0 and r["collective_bytes"] > 0
    assert 0 < r["useful_flops_ratio"] <= 1
    assert set(rec["collectives"]["bytes_by_kind"]) <= set(KINDS)
    assert rec["memory"]["total_bytes_per_device"] \
        > rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["top_ops"][0]["kind"] == "dot"
    assert not dist.is_initialized()


def test_long_context_is_skipped_for_full_attention():
    rec = dryrun.dryrun_cell("gemma-7b", "long_500k", device="cpu")
    assert rec["status"] == "skipped" and rec["reason"]


def test_cuda_without_a_cuda_build_is_an_error_record(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: False)
    rec = dryrun.dryrun_cell("gemma-7b", "decode_32k", device="cuda")
    assert rec["status"] == "error" and "--device cpu" in rec["error"]
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# The flash op's fake kernel
# ---------------------------------------------------------------------------

FLASH_CASES = {   # name: (q shape, k shape, causal, raises on cuda, on cpu)
    "ok": ((2, 256, 4, 64), (2, 256, 4, 64), True, None, None),
    "head-dim": ((2, 256, 4, 32), (2, 256, 4, 32), True, "head_dim", None),
    "t-under-s": ((2, 256, 4, 64), (2, 128, 4, 64), True, "T >= S", None),
    "blocks": ((2, 200, 4, 64), (2, 200, 4, 64), True, "divide blocks",
               "divide blocks"),
    "gqa": ((2, 256, 4, 64), (2, 256, 3, 64), False, "multiple", None),
}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_fake_kernel_holds_the_devices_contract(name, device):
    """On fake ``cuda`` tensors the op refuses what the CUDA wrapper
    refuses, with its message; on fake ``cpu`` tensors it keeps the CPU
    path's block rule."""
    q_shape, k_shape, causal, on_cuda, on_cpu = FLASH_CASES[name]
    want = on_cuda if device == "cuda" else on_cpu
    with FakeTensorMode():
        q = torch.zeros(q_shape, dtype=torch.bfloat16, device=device)
        k = torch.zeros(k_shape, dtype=torch.bfloat16, device=device)
        op = torch.ops.repro_torch.flash_attention_fwd
        if want is None:
            out = op(q, k, k, causal, 0)
            assert out.shape == q.shape and out.device.type == device
        else:
            with pytest.raises(ValueError, match=want):
                op(q, k, k, causal, 0)


# ---------------------------------------------------------------------------
# Recurrent cells: two short traces extrapolated to the cell's S
# ---------------------------------------------------------------------------

XLSTM = "xlstm-350m"


def _fit_fields(c):
    """Every count the extrapolation fits."""
    return (c.flops, c.hbm_bytes, c.local_ops, c.argument_bytes,
            c.peak_bytes, c.collectives.bytes_by_kind,
            c.collectives.count_by_kind)


def _xlstm_counts(shape: str, lengths):
    """xlstm-350m cut to 2 layers, traced at each of ``lengths`` with
    ``shape``'s batch on the 16 x 16 mesh, as ``dryrun_cell`` builds it."""
    cfg = get_config(XLSTM).replace(n_layers=2, use_flash_kernel=True)
    sp = SHAPES[shape]
    with dryrun.fake_process_group(256):
        mesh = dryrun.make_production_mesh(device_type="cpu")
        return [dryrun.trace_step(cfg, dataclasses.replace(sp, seq_len=s),
                                  mesh)["counts"] for s in lengths]


def test_xlstm_train_fit_equals_a_direct_trace():
    """FLOPs, op bytes, argument and peak bytes, local ops and each
    collective kind's bytes and count are affine in S: the line through
    S = 16 and 32 meets a direct trace at S = 48 exactly (the peak falls
    at the same program point at every S)."""
    a, b, direct = _xlstm_counts("train_4k", (16, 32, 48))
    assert _fit_fields(dryrun.extrapolate(a, b, 2)) == _fit_fields(direct)
    assert b.flops > a.flops and b.peak_bytes > a.peak_bytes


def test_xlstm_prefill_cell_is_extrapolated_exactly(monkeypatch):
    """``dryrun_cell`` of ``prefill_32k`` at a 2-layer cut traces S = 16
    and 32 only, and its record holds their fit to S = 32768; the same
    fit to S = 48 equals a direct trace there."""
    seen = {}
    trace = dryrun.trace_step

    def spy(cfg, sp, mesh, *args, **kw):
        out = trace(cfg, sp, mesh, *args, **kw)
        seen[sp.seq_len] = out["counts"]
        return out

    monkeypatch.setattr(dryrun, "trace_step", spy)
    rec = dryrun.dryrun_cell(XLSTM, "prefill_32k", device="cpu",
                             hillclimb={"n_layers": 2}, verbose=False)
    monkeypatch.undo()
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == RECORD_KEYS | {"extrapolated"}
    assert rec["extrapolated"] == {"from_seq": [16, 32], "to_seq": 32768,
                                   "top_ops_seq": 32}
    assert sorted(seen) == [16, 32]
    cfg = get_config(XLSTM).replace(n_layers=2, use_flash_kernel=True)
    fit = dryrun.extrapolate(seen[16], seen[32], (32768 - 16) // 16)
    want = dryrun.record_fields(
        fit, dryrun.model_flops(cfg, SHAPES["prefill_32k"]), 256, 0.0)
    for key in ("memory", "cost", "collectives", "top_ops", "roofline"):
        assert rec[key] == want[key], key
    assert rec["roofline"]["model_flops"] \
        == dryrun.fc.model_flops_train(cfg, 32 * 32768) / 3.0
    (direct,) = _xlstm_counts("prefill_32k", (48,))
    assert _fit_fields(dryrun.extrapolate(seen[16], seen[32], 2)) \
        == _fit_fields(direct)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_only_recurrent_train_and_prefill_cells_are_extrapolated(arch,
                                                                 shape):
    """Every other cell takes the direct trace, with no
    ``extrapolated`` key (``test_production_cell_is_ok`` checks one
    record's keys)."""
    cfg = get_config(arch)
    lengths = dryrun.fit_lengths(cfg, SHAPES[shape])
    recurrent = arch == XLSTM and SHAPES[shape].kind != "decode"
    assert lengths == ((16, 32) if recurrent else None)
    if recurrent:   # the optimized config's time chunks: 2 and 3 of them
        assert dryrun.fit_lengths(cfg.replace(time_chunk=128),
                                  SHAPES[shape]) == (256, 384)
        assert dryrun.fit_lengths(cfg, dataclasses.replace(
            SHAPES[shape], seq_len=32)) is None


# ---------------------------------------------------------------------------
# Adafactor's second moment on DTensors
# ---------------------------------------------------------------------------


def _adafactor_temp_bytes(make, mesh=None):
    """The bytes one Adafactor update of a (4, 64, 128) leaf allocates at
    its peak, its factors replicated on ``mesh`` as the reference's specs
    lay them out."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.core import flop_count as fc
    opt = make_optimizer("adafactor", lr=1e-2)
    p, g = make((4, 64, 128)), make((4, 64, 128))
    state = opt.init({"w": p})
    if mesh is not None:
        state["v"]["w"] = {k: distribute_tensor(torch.zeros(v.shape), mesh,
                                                [R, R])
                           for k, v in state["v"]["w"].items()}
    c = fc.count_device(opt.update, {"w": g}, state, {"w": p},
                        arguments=[p, g, *state["v"]["w"].values()])
    return c.peak_bytes - c.argument_bytes


def test_adafactor_update_on_dtensors_allocates_a_shard():
    """A leaf sharded (data over dim 0, model over dim 2) with the
    reference's replicated row and column factors: the update's second
    moment is built in the gradient's layout, so a rank allocates what the
    same update of its shard alone allocates, not the whole leaf (arctic-
    480b's `train_4k` peak held the stacked experts' estimate whole)."""
    from torch.distributed.tensor import distribute_tensor
    local = _adafactor_temp_bytes(lambda s: torch.ones(s[0] // 2, s[1],
                                                       s[2] // 2))
    with dryrun.fake_process_group(4):
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        sharded = _adafactor_temp_bytes(
            lambda s: distribute_tensor(torch.ones(s), mesh, [S0, S2]), mesh)
    assert local <= sharded < 1.5 * local
