"""Multi-pod dry-run (PyTorch): trace every (arch x shape x mesh) cell on
fake tensors. The port of ``repro.launch.dryrun``.

For each cell this proves the distribution config is coherent (every
sharding propagates, every collective is supported, the flash kernel's
contract holds) and extracts the roofline inputs of one device. The
reference lowers and compiles each step for 256 or 512 host devices and
reads XLA's cost, memory and collective analyses. Here the step runs once
on DTensors whose local shards are fake tensors (``FakeTensorMode``: shapes
and dtypes, nothing allocated or computed) over a ``fake`` process group
of the mesh's size, and ``core.flop_count.count_device`` counts rank 0's
local ops: FLOPs, the bytes they read and write, the peak of live local
bytes and the collectives' wire bytes (``core/comm_count.py``).

The fake tensors are on ``cuda`` by default, so the card's route is
traced: the flash kernel on (``use_flash_kernel=True`` in every cell, as
the card's training and serving paths run), its fake kernel holding the
CUDA wrapper's contract. Autograd over fake ``cuda`` tensors needs a CUDA build of torch;
on a CPU-only build pass ``--device cpu``, which traces the same ops with
the CPU path's rule. Nothing is compiled, so a record's ``compile_s`` is 0
and ``lower_s`` is the trace's seconds. ``cost`` holds the counter's totals
under XLA's key names (and the count of local ops traced) and ``top_ops``
its largest per-op totals (``kind``
``dot`` for an op with FLOPs, a collective's kind, else ``op``; ``mult`` is
always 1: nothing is counted once for many trips).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \
        --shape train_4k [--multi-pod] [--device cpu] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, get_config,
                                 get_optimizer_name, input_specs,
                                 shape_applicable)
from repro_torch.core import flop_count as fc
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.optim import make_optimizer
from repro_torch.parallel.sharding import (NamedSharding, ShardingRules,
                                           params_shardings)
from repro_torch.tree import leaves, tree_map


def _unfaked(fn):
    """``fn`` run with fake tensors off."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def run(*args, **kwargs):
        with unset_fake_temporarily():
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def fake_dtensors(device: str):
    """``FakeTensorMode`` for tensors on ``device``, with DTensor's
    ``_StridedShard`` (torch 2.13 flattens a sharded dim that is not the
    first of a view's group into one) sizing its shards on real tensors:
    it builds an index tensor and reads it back, which a fake tensor cannot
    give. Raises on ``cuda`` without a CUDA build of torch, where autograd
    over a fake ``cuda`` tensor aborts the process."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import placement_types

    if device == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("fake cuda tensors need a CUDA build of torch "
                           "(autograd over them aborts); pass --device cpu")
    strided = getattr(placement_types, "_StridedShard", None)
    saved = {n: f for n, f in vars(strided or object).items()
             if n in ("local_shard_size_and_offset",
                      "_local_shard_size_and_offset")}
    try:
        for n, f in saved.items():
            setattr(strided, n, staticmethod(_unfaked(f.__func__))
                    if isinstance(f, staticmethod) else _unfaked(f))
        with FakeTensorMode():
            yield
    finally:
        for n, f in saved.items():
            setattr(strided, n, f)


def _dtensor(x, sharding: NamedSharding, requires_grad: bool = False):
    """A DTensor of ``x``'s global shape with ``sharding``'s placements,
    its local shard zeros on the mesh's device (fake under
    ``FakeTensorMode``); ``int`` leaves (an optimizer's step) stay as they
    are."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if isinstance(x, int):
        return x
    mesh, shape = sharding.mesh, torch.Size(x.shape)
    with unset_fake_temporarily():
        local, _ = compute_local_shape_and_global_offset(
            shape, mesh, sharding.placements)
        stride = torch.empty(shape, device="meta").stride()
    t = torch.zeros(local, dtype=x.dtype, device=mesh.device_type)
    d = DTensor.from_local(t, mesh, sharding.placements, run_check=False,
                           shape=shape, stride=stride)
    return d.requires_grad_() if requires_grad else d


def trace_step(cfg: ModelConfig, sp: ShapeSpec, mesh, optimizer: str =
               "adamw", rules: Optional[ShardingRules] = None,
               fake: bool = True) -> Dict:
    """Trace one ``sp.kind`` step of ``cfg`` at ``sp``'s sizes on ``mesh``
    (its process group initialised by the caller), on fake tensors of the
    mesh's device type. Returns the record's measured fields: ``counts``
    (a :class:`~repro_torch.core.flop_count.DeviceCounts`), ``model_flops``
    and ``seconds``. Raises where the step fails to trace. ``fake=False``
    runs the same step on real zeros, to hold a trace against (small
    shapes only)."""
    rules = rules or ShardingRules()
    specs = input_specs(cfg, sp)
    tokens = sp.global_batch * sp.seq_len
    # (shapes tree, shardings tree, requires grad) a step argument
    if sp.kind == "train":
        opt = make_optimizer(optimizer, lr=1e-3)
        (psh, osh, bsh), pshapes, oshapes = S.train_in_shardings(
            cfg, opt, specs, mesh, rules)
        inputs = [(pshapes, psh, True), (oshapes, osh, False),
                  (specs, bsh, False)]
        step = S.make_train_step(cfg, opt, mesh, rules)
        model_flops = fc.model_flops_train(cfg, tokens)
    elif sp.kind == "prefill":
        from repro_torch.models.transformer import param_shapes
        pshapes = S._meta(param_shapes(cfg))
        inputs = [(pshapes, params_shardings(pshapes, mesh, rules), False),
                  (specs, S.batch_shardings(specs, mesh, rules), False)]
        step = S.make_prefill_step(cfg, mesh, rules)
        model_flops = fc.model_flops_train(cfg, tokens) / 3.0
    else:  # decode
        (psh, dsh, tsh), pshapes = S.serve_in_shardings(
            cfg, specs["state"], sp.global_batch, mesh, rules)
        inputs = [(pshapes, psh, False), (specs["state"], dsh, False),
                  (specs["token"], tsh, False)]
        step = S.make_serve_step(cfg, mesh, rules)
        model_flops = fc.model_flops_decode(cfg, sp.global_batch, sp.seq_len)
    with (fake_dtensors(mesh.device_type) if fake
          else contextlib.nullcontext()):
        t0 = time.time()
        args = [tree_map(lambda x, s, g=grad: _dtensor(x, s, g), shapes, sh)
                for shapes, sh, grad in inputs]
        alive = [x for a in args for x in leaves(a)
                 if isinstance(x, torch.Tensor)]
        counts = fc.count_device(step, *args, arguments=alive)
        seconds = time.time() - t0
    return {"counts": counts, "model_flops": model_flops,
            "seconds": seconds}


def record_fields(counts: "fc.DeviceCounts", model_flops: float,
                  chips: int, seconds: float) -> Dict:
    """A record's measured keys, the reference's names."""
    terms = fc.RooflineTerms(
        flops=counts.flops, hbm_bytes=counts.hbm_bytes,
        collective_bytes=float(counts.collectives.total_bytes),
        chips=chips, model_flops=model_flops)
    coll = counts.collectives
    return {
        "chips": chips,
        "lower_s": round(seconds, 2),
        "compile_s": 0.0,
        "memory": {
            "argument_size_in_bytes": counts.argument_bytes,
            "temp_size_in_bytes": counts.peak_bytes - counts.argument_bytes,
            "total_bytes_per_device": counts.peak_bytes,
        },
        "cost": {"flops": float(counts.flops),
                 "bytes accessed": float(counts.hbm_bytes),
                 "local ops": float(counts.local_ops)},
        "collectives": {
            "bytes_by_kind": dict(coll.bytes_by_kind),
            "count_by_kind": dict(coll.count_by_kind),
            "total_wire_bytes": int(coll.total_bytes),
        },
        "top_ops": [{"kind": o["kind"], "name": o["name"],
                     "flops": o["flops"], "bytes": o["bytes"],
                     "coll_bytes": o["coll_bytes"], "mult": 1}
                    for o in counts.top_ops(12)],
        "roofline": terms.as_dict(),
    }


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process rank
    0: collectives are accepted and move nothing. Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dryrun_cell(arch: str, shape: str, multi_pod: bool = False,
                hillclimb: Optional[Dict] = None, optimized: bool = False,
                verbose: bool = True, device: str = "cuda") -> Dict:
    """Trace one cell on fake ``device`` tensors; returns the roofline
    record."""
    cfg = get_config(arch, optimized=optimized)
    if hillclimb:
        cfg = cfg.replace(**hillclimb)
    cfg = cfg.replace(use_flash_kernel=True)
    ok, reason = shape_applicable(cfg, shape)
    rec: Dict = {"arch": arch, "shape": shape, "optimized": optimized,
                 "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    sp = SHAPES[shape]
    chips = 512 if multi_pod else 256
    try:
        with fake_process_group(chips):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=device)
            out = trace_step(cfg, sp, mesh, get_optimizer_name(arch))
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        return rec

    rec.update({"status": "ok", "kind": sp.kind,
                **record_fields(out["counts"], out["model_flops"], chips,
                                out["seconds"])})
    if verbose:
        r = rec["roofline"]
        mem = rec["memory"]["total_bytes_per_device"] / 2**30
        print(f"[{rec['mesh']}] {arch:22s} {shape:12s} ok "
              f"mem/dev={mem:6.2f}GiB t_comp={r['t_compute_s']*1e3:8.2f}ms "
              f"t_mem={r['t_memory_s']*1e3:8.2f}ms "
              f"t_coll={r['t_collective_s']*1e3:8.2f}ms "
              f"bound={r['bottleneck']:10s} mfu_bound={r['mfu_bound']:.2f}",
              flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="use the hillclimbed config variants (§Perf)")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch, shape) for both meshes")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the fake tensors (cuda: the card's "
                         "route; needs a CUDA build of torch)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    records = []
    if args.all:
        meshes = [False] if args.single_pod_only else [False, True]
        for mp in meshes:
            for arch in ARCH_IDS:
                for shape in SHAPES:
                    records.append(dryrun_cell(arch, shape, multi_pod=mp,
                                               optimized=args.optimized,
                                               device=args.device))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        rec = dryrun_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                          optimized=args.optimized, device=args.device)
        if rec["status"] == "error":
            print(rec["error"])
            print(rec.get("traceback", ""))
        records.append(rec)

    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = len(records) - n_ok - n_skip
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
