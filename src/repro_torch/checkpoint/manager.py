"""Checkpointing (PyTorch), the port of ``repro.checkpoint.manager``: atomic
manifests and restart, in the reference's on-disk layout byte for byte,
so either package restores the other's checkpoints.

Layout:
    <dir>/step_<N>/
        manifest.json      step, leaf dtypes/shapes, metadata
        arr_<i>.npy        one file per leaf (gathered to the host)
    <dir>/LATEST           atomic pointer (written via rename)

Four rules make the layout cross-package:

* leaves are numbered in sorted-key order, as ``jax.tree_util`` flattens
  dicts (``tree.leaves`` visits insertion order);
* a Python ``int`` leaf (the optimizers' step counter) is written as the
  reference's 0-d int32 and restored as an ``int``;
* a bf16 tensor is written as the reference writes its ``ml_dtypes``
  bfloat16 arrays: the raw 2-byte values under the header descr ``<V2``,
  with ``"bfloat16"`` in the manifest; it is rebuilt from the manifest's
  dtype (numpy without ``ml_dtypes`` reads it as ``|V2``);
* ``restore`` copies into the target tree's own tensors, in place and on
  their device: parameters stay leaf tensors with ``requires_grad``, and
  optimizer moments stay the tensors the in-place update mutates.

A DTensor leaf is gathered whole (``full_tensor``, a collective: every
rank of the process group calls ``save`` with the same tree and
directory) and written as the unsharded leaf would be, so a sharded save
and an unsharded one write the same bytes. Rank 0 alone writes, and every
rank returns after a barrier, when the checkpoint is on disk.
``restore(..., mesh=)`` is the elastic re-shard: every leaf is
distributed over the restore-time mesh by its rules, whatever mesh saved
it.

The reference's manifest also holds a serialized JAX treedef, which its
``restore`` never reads; here ``treedef`` is null and ``tree_repr`` lists
the leaves' key paths.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from numpy.lib import format as npy_format
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import (ShardingRules, distribute,
                                           params_shardings)


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in ``jax.tree_util``'s order: dict keys
    sorted, depth first."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}.{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def _unflatten(tree, values):
    """``tree``'s structure with its leaves replaced, in ``_flatten``'s
    order, by ``values`` (an iterator)."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], values) for k in sorted(tree)}
    return next(values)


def _write_leaf(path: str, leaf) -> Dict:
    """Writes one leaf, a tensor or an ``int``, as the reference's
    ``np.save`` would; returns its manifest entry (without the index)."""
    if isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    else:
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            shape = tuple(t.shape)
            with open(path, "wb") as f:
                npy_format.write_array_header_1_0(
                    f, {"descr": "<V2", "fortran_order": False,
                        "shape": shape})
                t.view(torch.int16).numpy().tofile(f)
            return {"dtype": "bfloat16", "shape": list(shape)}
        arr = t.numpy()
    np.save(path, arr)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape)}


def save(ckpt_dir: str, step: int, tree: Any,
         metadata: Optional[Dict] = None) -> str:
    """Write a checkpoint atomically; returns the step directory.

    Overwrites of an existing ``step_dir`` swap via a dot-prefixed trash
    name (rename old aside -> rename tmp in -> delete old) instead of
    rmtree-then-rename, so there is no window in which the step has no
    valid checkpoint; a crash mid-swap is healed on the next call. Leaves
    are gathered to the host one at a time. A tree with DTensor leaves is
    saved by every rank together, as the module docstring says."""
    flat = _flatten(tree)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not any(isinstance(leaf, DTensor) for _, leaf in flat):
        return _write(ckpt_dir, step, step_dir, flat, metadata)
    if dist.get_rank() == 0:
        _write(ckpt_dir, step, step_dir, flat, metadata)
    else:
        for _, leaf in flat:          # each gather is a collective
            if isinstance(leaf, DTensor):
                leaf.full_tensor()
    dist.barrier()
    return step_dir


def _write(ckpt_dir: str, step: int, step_dir: str, flat,
           metadata: Optional[Dict]) -> str:
    """``save``'s writer: the step directory, then the LATEST pointer."""
    os.makedirs(ckpt_dir, exist_ok=True)
    trash = os.path.join(ckpt_dir, f".old_step_{step:08d}")
    # heal an interrupted swap: the old tree was moved aside but the new
    # one never landed — put the old checkpoint back before proceeding
    if os.path.exists(trash) and not os.path.exists(step_dir):
        os.rename(trash, step_dir)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        manifest = {"step": step, "treedef": None,
                    "tree_repr": "repro_torch leaves: "
                    + ", ".join(path for path, _ in flat),
                    "leaves": [], "metadata": metadata or {}}
        for i, (_, leaf) in enumerate(flat):
            entry = _write_leaf(os.path.join(tmp, f"arr_{i}.npy"), leaf)
            manifest["leaves"].append({"index": i, **entry})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        had_old = os.path.exists(step_dir)
        if had_old:
            if os.path.exists(trash):
                shutil.rmtree(trash)
            os.rename(step_dir, trash)
        try:
            os.rename(tmp, step_dir)
        except BaseException:
            if had_old and not os.path.exists(step_dir):
                os.rename(trash, step_dir)   # roll the old checkpoint back
            raise
        if had_old:
            shutil.rmtree(trash, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    latest_tmp = os.path.join(ckpt_dir, ".LATEST_tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(step_dir))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return step_dir


def latest_step(ckpt_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            name = f.read().strip()
        return int(name.split("_")[-1])
    except (FileNotFoundError, ValueError):
        return None


def _read_leaf(path: str, dtype: str):
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def restore(ckpt_dir: str, target_tree: Any, step: Optional[int] = None,
            mesh=None, rules: Optional[ShardingRules] = None,
            shard_fn=None) -> Tuple[Any, Dict]:
    """Load a checkpoint into ``target_tree``; returns ``(tree, metadata)``.

    The checkpoint's leaf count, shapes and dtypes must match the
    target's. Without ``mesh``, every tensor leaf of the target is
    overwritten in place, on its own device, one leaf at a time; the
    returned tree holds those same tensors, and the restored values of
    ``int`` leaves.

    With ``mesh`` (a ``DeviceMesh``), the elastic re-shard: every leaf is
    distributed over the restore-time mesh with ``shard_fn(shapes, mesh)``,
    or else with ``params_shardings(shapes, mesh, rules)``, ``shapes``
    being the target's tree as ``meta`` tensors, whatever mesh saved it. Placements cannot change in place, so the tensor leaves
    returned are new DTensors; each requires grad where its target leaf
    did, and ``int`` leaves stay ``int``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(target_tree)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target needs "
            f"{len(flat)} — structure mismatch")
    for (path, want), entry in zip(flat, manifest["leaves"]):
        shape = () if isinstance(want, int) else tuple(want.shape)
        if tuple(entry["shape"]) != shape:
            raise ValueError(f"shape mismatch at {path}: ckpt "
                             f"{tuple(entry['shape'])} vs target {shape}")
        if not isinstance(want, int) and \
                entry["dtype"] != str(want.dtype).split(".")[-1]:
            raise ValueError(f"dtype mismatch at {path}: ckpt "
                             f"{entry['dtype']} vs target {want.dtype}")
    if mesh is not None:
        dtypes = [e["dtype"] for e in manifest["leaves"]]
        return _restore_onto(step_dir, dtypes, flat, target_tree, mesh,
                             rules, shard_fn), manifest["metadata"]
    values = []
    with torch.no_grad():
        for i, (_, want) in enumerate(flat):
            got = _read_leaf(os.path.join(step_dir, f"arr_{i}.npy"),
                             manifest["leaves"][i]["dtype"])
            if isinstance(want, int):
                values.append(int(got))
            else:
                want.copy_(torch.as_tensor(got))
                values.append(want)
            del got
    return _unflatten(target_tree, iter(values)), manifest["metadata"]


def _restore_onto(step_dir: str, dtypes: List[str], flat, target_tree,
                  mesh, rules: Optional[ShardingRules], shard_fn):
    """``restore``'s re-shard: the target's structure with new DTensor
    leaves over ``mesh``, distributed one leaf at a time."""
    # the placements come from shapes alone: meta tensors allocate nothing
    shapes = _unflatten(target_tree, iter(
        w if isinstance(w, int) else torch.empty(w.shape, device="meta")
        for _, w in flat))
    shardings = (shard_fn(shapes, mesh) if shard_fn is not None
                 else params_shardings(shapes, mesh, rules))
    values = []
    for i, ((_, want), (_, s)) in enumerate(zip(flat, _flatten(shardings))):
        got = _read_leaf(os.path.join(step_dir, f"arr_{i}.npy"), dtypes[i])
        if isinstance(want, int):
            values.append(int(got))
            continue
        t = torch.as_tensor(got).requires_grad_(want.requires_grad)
        values.append(distribute(t, s))
        del got, t
    return _unflatten(target_tree, iter(values))


def cleanup(ckpt_dir: str, keep: int = 3) -> None:
    """Retain the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
