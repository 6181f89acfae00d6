"""The sharded MoE on its rank's experts at every length, on the CPU,
against the unsharded port and the reference.

* deepseek-moe-16b smoke (fp32, 2 layers, 4 experts, B = 4, S = 256) on a
  (2, 2) mesh of 4 gloo ranks: the grad step (loss 1e-5 relative, each
  gradient 1e-4 of its norm) and the prefill step (logits 1e-5), for the
  ``moe_ecd`` dispatch and the ``dispatch_local`` (``moe_ecd_grouped``)
  one, against the unsharded port and against the reference's steps jitted
  on 4 forced host devices with ``AxisType.Auto`` axes. Each rank built
  the slots of its own experts alone (``moe.expert_slots``).
* The same steps' FLOPs a device, rank 0's local ops traced on fake
  tensors, against ``parse_hlo_profile`` of the reference's compiled steps
  on the same mesh: equal.
* The production cells on 16 x 16 (256 fake ranks) against the
  reference's counts: deepseek-moe-16b ``prefill_32k`` and ``train_4k``,
  arctic-480b ``prefill_32k``; no collective moves a dispatch or combine
  tensor (n, g, E, C).
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

from repro_torch.configs import (SHAPES, ShapeSpec, get_config,
                                 get_optimizer_name)
from repro_torch.convert import params_from_numpy
from repro_torch.core import flop_count
from repro_torch.launch import dryrun, make_debug_mesh, steps
from repro_torch.models import moe
from repro_torch.models import transformer as tt
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, B, S, LR = "deepseek-moe-16b", 4, 256, 1e-3
TIMEOUT_S = 240
# name: the smoke config's MoE overrides
CASES = {"ecd": {}, "grouped": {"dispatch_local": True}}

JAX_REF = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, "src")
from repro.configs import get_config
from repro.core.hlo_static import parse_hlo_profile
from repro.launch.steps import (batch_shardings, make_grad_step,
                                make_prefill_step, make_train_step,
                                train_in_shardings)
from repro.optim import make_optimizer
from repro.parallel.sharding import params_shardings

d = sys.argv[1]
inp = np.load(os.path.join(d, "inputs.npz"))
with open(os.path.join(d, "cases.json")) as f:
    cases = json.load(f)


def tree(prefix):
    params = {}
    for key in inp.files:
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
            node = params
            for k in path:
                node = node.setdefault(k, {})
            node[last] = inp[key]
    return params


auto = jax.sharding.AxisType.Auto   # hints, where make_mesh defaults to
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto,) * 2)
opt = make_optimizer("adamw", lr=float(inp["lr"]))
out, counts = {}, {}
for name, (arch, over) in cases.items():
    cfg = get_config(arch, smoke=True)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **over))
    params = tree(name + "/p/")
    toks = inp[name + "/tokens"]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (psh, osh, bsh), pshapes, oshapes = train_in_shardings(cfg, opt, batch,
                                                           mesh)
    grads, metrics = jax.jit(make_grad_step(cfg, mesh),
                             in_shardings=(psh, bsh))(
        jax.device_put(params, psh), jax.device_put(batch, bsh))
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    out.update({name + "/train/g/" + "/".join(k.key for k in path):
                np.asarray(x) for path, x in flat})
    out[name + "/train/loss"] = np.float32(metrics["loss"])
    specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in batch.items()}
    compiled = jax.jit(make_train_step(cfg, opt, mesh),
                       in_shardings=(psh, osh, bsh),
                       donate_argnums=(0, 1)).lower(
        pshapes, oshapes, specs).compile()
    counts[name + "/train"] = parse_hlo_profile(compiled.as_text()).flops
    pre = {"tokens": batch["tokens"]}
    ish = (psh, batch_shardings(pre, mesh))
    prefill = jax.jit(make_prefill_step(cfg, mesh), in_shardings=ish)
    out[name + "/prefill/logits"] = np.asarray(prefill(
        jax.device_put(params, psh), jax.device_put(pre, ish[1])))
    pspecs = {"tokens": jax.ShapeDtypeStruct(pre["tokens"].shape,
                                             pre["tokens"].dtype)}
    compiled = prefill.lower(pshapes, pspecs).compile()
    counts[name + "/prefill"] = parse_hlo_profile(compiled.as_text()).flops
np.savez(os.path.join(d, "jax.npz"), **out)
with open(os.path.join(d, "jax.json"), "w") as f:
    json.dump(counts, f)
"""


def case_config(name: str):
    cfg = get_config(ARCH, smoke=True)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **CASES[name]))


def numpy_inputs(name: str):
    """A case's config, numpy weights (0.1·N(0, 1), fp32) and token ids
    (B, S + 1), from numpy seed 0."""
    cfg = case_config(name)
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


def _steps(name: str, mesh) -> dict:
    """A case's grad step (loss, gradients) and prefill step (logits), on
    ``mesh`` or (None) unsharded."""
    cfg, params, tokens = numpy_inputs(name)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:])}
    pre = {"tokens": batch["tokens"]}
    tp = params_from_numpy(params, "cpu")
    if mesh is not None:
        opt = make_optimizer("adamw", lr=LR)
        (psh, _, bsh), _, _ = steps.train_in_shardings(cfg, opt, batch, mesh)
        tp, batch = sh.distribute(tp, psh), sh.distribute(batch, bsh)
        pre = sh.distribute(pre, steps.batch_shardings(pre, mesh))
    whole = (lambda x: x.full_tensor()) if mesh is not None else (
        lambda x: x)
    grads, metrics = steps.make_grad_step(cfg, mesh)(tp, batch)
    logits = steps.make_prefill_step(cfg, mesh)(tp, pre)
    return {"train/loss": float(metrics["loss"]),
            **{"train/g/" + p: whole(x).detach().numpy()
               for p, x in paths(grads)},
            "prefill/logits": whole(logits).detach().numpy()}


def _rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)     # 4 ranks on a few cores
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    built = []
    real = moe.expert_slots

    def expert_slots(gate_idx, gate_vals, cap, first, count):
        dispatch, combine = real(gate_idx, gate_vals, cap, first, count)
        built.append((count, *dispatch.shape))
        return dispatch, combine

    try:
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        found = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(moe, "expert_slots", expert_slots)
            for name in CASES:
                found.update({f"{name}/{k}": v
                              for k, v in _steps(name, mesh).items()})
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(d, "port.npz"), built=np.array(built),
                 **found)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port on 4 gloo ranks, reference on 4 host devices, the reference's
    FLOPs) run side by side."""
    d = str(tmp_path_factory.mktemp("moe_shards"))
    inputs, cases = {"lr": LR}, {}
    for name, over in CASES.items():
        _, params, tokens = numpy_inputs(name)
        inputs[name + "/tokens"] = tokens
        inputs.update({f"{name}/p/{p}": x for p, x in paths(params)})
        cases[name] = [ARCH, over]
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
    with open(os.path.join(d, "jax.json")) as f:
        counts = json.load(f)
    return (dict(np.load(os.path.join(d, "port.npz"))),
            dict(np.load(os.path.join(d, "jax.npz"))), counts)


@pytest.fixture(scope="module")
def unsharded():
    return {name: _steps(name, None) for name in CASES}


def _of(found: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in found.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("against", ["unsharded port", "reference"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_moe_grad_step_matches(name, against, runs, unsharded):
    """The (2, 2) grad step, dispatch and combine on each rank's experts
    and their gradients too (the gates' a partial sum over ``model``): the
    loss within 1e-5 relative and each gradient within 1e-4 of its norm
    (an expert no token reached has none on either side)."""
    port, jref, _ = runs
    want = (_of(unsharded[name], "train/") if against == "unsharded port"
            else _of(jref, f"{name}/train/"))
    got = _of(port, f"{name}/train/")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    keys = sorted(k for k in want if k.startswith("g/"))
    assert keys and keys == sorted(k for k in got if k.startswith("g/"))
    for k in keys:
        scale = np.linalg.norm(want[k])
        if scale == 0:
            assert not got[k].any(), k
            continue
        assert np.linalg.norm(got[k] - want[k]) <= 1e-4 * scale, k


@pytest.mark.parametrize("against", ["unsharded port", "reference"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_moe_prefill_matches(name, against, runs, unsharded):
    """The (2, 2) prefill step's logits within 1e-5."""
    port, jref, _ = runs
    want = (unsharded[name]["prefill/logits"] if against == "unsharded port"
            else jref[f"{name}/prefill/logits"])
    got = port[f"{name}/prefill/logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_each_rank_built_its_experts_slots(runs):
    """Every ``expert_slots`` call on the mesh built half the experts'
    slots (``model``'s 2 split the 4), for half the groups (``data``'s 2):
    one a layer for each step of each case, its forward only."""
    built = runs[0]["built"]
    cfg = case_config("ecd")
    n, g = moe.group_split(B * S, cfg.moe.group_size)
    cap = moe.capacity(cfg, g)
    e = cfg.moe.num_experts // 2
    assert len(built) == len(CASES) * 2 * cfg.n_layers
    assert {tuple(int(v) for v in row) for row in built} == {
        (e, n // 2, g, e, cap)}


def _smoke_flops(name: str, kind: str) -> int:
    cfg = case_config(name).replace(use_flash_kernel=False)
    with dryrun.fake_process_group(4):
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        out = dryrun.trace_step(cfg, ShapeSpec("smoke", S, B, kind), mesh)
    return out["counts"].flops


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_smoke_moe_flops_a_device_match_the_reference(name, kind, runs):
    """FLOPs a device of the (2, 2) train and prefill steps, rank 0's local
    ops, against ``parse_hlo_profile`` of the reference's step compiled for
    the same mesh: equal. The dispatch and combine products and their
    gradients run on the rank's experts and groups, as XLA partitions
    them, and in the train step the router's products on the rank's
    experts too (remat is off at smoke size)."""
    got = _smoke_flops(name, kind)
    want = runs[2][f"{name}/{kind}"]
    print(f"\n{name} {kind}: FLOPs a device {got} (reference {want:.0f})")
    assert got == want


# ---------------------------------------------------------------------------
# The production cells against the reference's counts
# ---------------------------------------------------------------------------

# ``repro.launch.dryrun.dryrun_cell`` compiled for 256 (or 512) forced host
# devices, the mesh's axes made ``AxisType.Auto`` (under JAX 0.9's default
# Explicit axes its decode cells raise): one JSON line a cell. Run it as
# ``PYTHONPATH=src python tests/test_torch_moe_shards.py [--multi-pod]
# [--hlo DIR] [--layers N] [--seq S] ARCH:SHAPE ...``; with ``--hlo`` each
# cell's compiled HLO text (what ``parse_hlo_profile`` reads) is written to
# ``DIR/ARCH_SHAPE.hlo``; ``--layers`` cuts every cell's depth and ``--seq``
# sets its S (``XLSTM_CUT``: ``--layers 4 --seq 1024 xlstm-350m:train_4k``,
# 18 s).
REFERENCE_CELLS = """
import dataclasses, json, os, sys
devices = sys.argv[1]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=" + devices
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
sys.path.insert(0, "src")
make_mesh = jax.make_mesh


def auto_mesh(shape, axes, **kw):
    kw.setdefault("axis_types", (jax.sharding.AxisType.Auto,) * len(shape))
    return make_mesh(shape, axes, **kw)


jax.make_mesh = auto_mesh
import repro.launch.dryrun as dryrun
hlo_dir = os.environ.get("REFERENCE_HLO_DIR")
layers = os.environ.get("REFERENCE_N_LAYERS")
seq = os.environ.get("REFERENCE_SEQ_LEN")
parse = dryrun.hs.parse_hlo_profile


def write_hlo(text):
    with open(os.path.join(hlo_dir, name + ".hlo"), "w") as f:
        f.write(text)
    return parse(text)


if hlo_dir:
    dryrun.hs.parse_hlo_profile = write_hlo
for cell in sys.argv[2:]:
    arch, shape = cell.split(":")
    name = f"{arch}_{shape}"
    if seq:     # the dict the reference's input specs read too
        dryrun.SHAPES[shape] = dataclasses.replace(dryrun.SHAPES[shape],
                                                   seq_len=int(seq))
    r = dryrun.dryrun_cell(arch, shape, multi_pod=devices == "512",
                           hillclimb={"n_layers": int(layers)} if layers
                           else None, verbose=False)
    out = {"arch": arch, "shape": shape, "status": r["status"]}
    if r["status"] == "ok":
        out.update(flops=r["roofline"]["hlo_flops"],
                   gib=r["memory"]["total_bytes_per_device"] / 2**30,
                   wire=r["collectives"]["total_wire_bytes"],
                   wire_by_kind=r["collectives"]["bytes_by_kind"])
    print(json.dumps(out), flush=True)
"""


def reference_counts(cells, multi_pod: bool = False, hlo_dir=None,
                     n_layers=None, seq_len=None):
    """The reference's counts of ``cells`` ("arch:shape" each), one dict a
    cell: FLOPs and wire bytes a device, GiB a device; with ``hlo_dir``
    each cell's compiled HLO text written there too; ``n_layers`` and
    ``seq_len`` cut every cell's depth and set its S."""
    over = {"REFERENCE_HLO_DIR": hlo_dir and os.path.abspath(hlo_dir),
            "REFERENCE_N_LAYERS": n_layers and str(n_layers),
            "REFERENCE_SEQ_LEN": seq_len and str(seq_len)}
    env = dict(os.environ, **{k: v for k, v in over.items() if v})
    run = subprocess.run([sys.executable, "-c", REFERENCE_CELLS,
                          "512" if multi_pod else "256", *cells], cwd=ROOT,
                         capture_output=True, text=True, check=True, env=env)
    return [json.loads(line) for line in run.stdout.splitlines()
            if line.startswith("{")]


# The reference's counts a device on 16 x 16 (``reference_counts``): FLOPs
# (``parse_hlo_profile``) and GiB (``memory_analysis``).
REFERENCE = {   # (arch, shape): (GiB, FLOPs)
    ("deepseek-moe-16b", "prefill_32k"): (18.49, 62899796049920),
    ("deepseek-moe-16b", "train_4k"): (37.09, 131786776510464),
    ("arctic-480b", "prefill_32k"): (66.01, 321520178036736),
}
# The port's bytes a device on the CPU route while every rank built every
# expert's dispatch and combine: none may rise.
BEFORE_GIB = {("deepseek-moe-16b", "prefill_32k"): 10.91,
              ("deepseek-moe-16b", "train_4k"): 27.57,
              ("arctic-480b", "prefill_32k"): 19.17}
ARCTIC_PREFILL_LIMIT = 3.6e14
# xlstm-350m ``train_4k`` cut to 4 layers (two sLSTM / mLSTM groups): the
# reference's FLOPs a device by S (``reference_counts(["xlstm-350m:
# train_4k"], n_layers=4, seq_len=S)``). Below S of about 1024 XLA's count
# is not affine in S, and one group is not representative: compare a
# recurrent cell at two groups or more and S of 1024 or 4096.
XLSTM_CUT = {"n_layers": 4,
             "flops": {1024: 2683415035904, 4096: 10733660143616}}


@pytest.fixture(scope="module")
def cells():
    """Each ``REFERENCE`` cell traced on 16 x 16 over 256 fake ranks: its
    config, counts and the output shape of every collective."""
    out = {}
    record = flop_count.record_collective
    for arch, shape in REFERENCE:
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
                counts = dryrun.trace_cell(cfg, SHAPES[shape], mesh,
                                           get_optimizer_name(arch))["counts"]
        finally:
            flop_count.record_collective = record
        out[arch, shape] = (cfg, counts, shapes)
    return out


def test_deepseek_prefill_flops_are_the_references(cells):
    _, c, _ = cells["deepseek-moe-16b", "prefill_32k"]
    want = REFERENCE["deepseek-moe-16b", "prefill_32k"][1]
    print(f"\ndeepseek-moe-16b prefill_32k: FLOPs a device {c.flops:.4e} "
          f"(reference {want:.4e})")
    assert f"{c.flops:.4g}" == f"{want:.4g}"


def test_deepseek_train_flops_are_the_references_and_named_products(cells):
    """deepseek-moe-16b ``train_4k``: the reference's FLOPs a device and
    one named product a layer (L = 28; local sizes: B/16 rows, one head):
    the flash op's plain VJP recomputes attention's logits product (u =
    2·(B/16)·1·S·S·D; XLA's plain attention has none to redo; the VJP
    forms no output product). Under 1.015x the reference.

    The remat replay runs none of the block's output products, whose
    outputs no backward reads and which XLA drops as dead: the combine and
    the shared experts' ``wo`` run in one node after their operands are
    kept (``layers.output_products``), and torch's checkpoint replays the
    forward only up to the last op that saves a tensor (before: the shared
    experts' output product, 2·(B/16)·S·d·F_shared/16 a layer, ran in the
    replay, 1.0246x). The dispatch, the combine, the experts and the
    router run on the rank's experts, as in XLA's."""
    cfg, c, _ = cells["deepseek-moe-16b", "train_4k"]
    sp, m = SHAPES["train_4k"], cfg.moe
    rows, layers = sp.global_batch // 16 * sp.seq_len, cfg.n_layers
    flash = 2 * (sp.global_batch // 16) * sp.seq_len ** 2 * cfg.head_dim
    shared = 2 * rows * cfg.d_model * (cfg.d_expert_eff * m.num_shared // 16)
    want = REFERENCE["deepseek-moe-16b", "train_4k"][1]
    named = layers * flash
    print(f"\ndeepseek-moe-16b train_4k: FLOPs a device {c.flops:.6e} = "
          f"reference {want:.6e} + {named:.6e} ({c.flops / want:.4f}x); "
          f"the shared experts' output product replayed before: "
          f"{layers * shared:.6e}")
    assert c.flops == want + named
    assert c.flops <= 1.015 * want


def test_arctic_prefill_flops_are_under_the_limit(cells):
    """arctic-480b ``prefill_32k``: its 56 heads do not divide ``model``,
    so q's and k's products run on x's sequence shard and v's whole, as
    XLA partitions them; the experts' products are the rank's alone. The
    reference's count at 4 digits, under the limit."""
    _, c, _ = cells["arctic-480b", "prefill_32k"]
    want = REFERENCE["arctic-480b", "prefill_32k"][1]
    print(f"\narctic-480b prefill_32k: FLOPs a device {c.flops:.4e} "
          f"(reference {want:.4e}, {c.flops / want:.3f}x)")
    assert f"{c.flops:.4g}" == f"{want:.4g}"
    assert c.flops <= ARCTIC_PREFILL_LIMIT


@pytest.mark.parametrize("cell", sorted(REFERENCE))
def test_moe_cell_bytes_do_not_rise(cell, cells):
    _, c, _ = cells[cell]
    gib = c.peak_bytes / 2**30
    print(f"\n{cell}: {gib:.2f} GiB a device (before {BEFORE_GIB[cell]}, "
          f"reference {REFERENCE[cell][0]})")
    assert round(gib, 2) <= min(BEFORE_GIB[cell], REFERENCE[cell][0])


@pytest.mark.parametrize("cell", sorted(REFERENCE))
def test_no_collective_moves_the_slots(cell, cells):
    """No collective's output is a dispatch or combine tensor (n, g, e, C)
    (before, the combine's gradient was gathered over ``model`` to every
    expert, and over ``data`` to every group)."""
    cfg, _, shapes = cells[cell]
    sp = SHAPES[cell[1]]
    _, g = moe.group_split(sp.global_batch // 16 * sp.seq_len,
                           cfg.moe.group_size)
    cap = moe.capacity(cfg, g)
    slots = [s for s in shapes if len(s) == 4 and s[1] == g
             and s[3] == cap]
    assert shapes and not slots


if __name__ == "__main__":
    args = sys.argv[1:]
    opts = {k: args[args.index(k) + 1] if k in args else None
            for k in ("--hlo", "--layers", "--seq")}
    flags = {"--multi-pod"} | {k for k, v in opts.items() if v} \
        | {v for v in opts.values() if v}
    for rec in reference_counts(
            [a for a in args if a not in flags],
            multi_pod="--multi-pod" in args, hlo_dir=opts["--hlo"],
            n_layers=opts["--layers"], seq_len=opts["--seq"]):
        print(json.dumps(rec))
