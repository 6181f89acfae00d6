"""The port's checkpoint manager against the JAX package's: the reference's
manager tests on the torch side, the in-place restore, the on-disk layout
byte for byte in both directions (fp32 AdamW, bf16 AdamW moments and
adafactor's factored state), restart equivalence through the port's
``launch.train`` (xlstm-350m's also against ``repro.launch.train``), the
restored state of a run equal to its final state, and, on 8 gloo ranks,
the elastic re-shard on restore and the bytes of a sharded save."""
import filecmp
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import repro.checkpoint as jck
from repro.launch import train as jax_train
from repro.optim import make_optimizer as jax_optimizer
from repro_torch import checkpoint as ck
from repro_torch.convert import params_from_numpy
from repro_torch.launch import make_debug_mesh, train
from repro_torch.optim import make_optimizer
from repro_torch.parallel.sharding import replicated
from repro_torch.tree import leaves, tree_map
from test_torch_optim import carried_jax_run


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(12.0).reshape(3, 4),
                "b": {"c": torch.ones((5,), dtype=torch.int32)}}
        ck.save(str(tmp_path), 7, tree, metadata={"k": "v"})
        target = tree_map(torch.zeros_like, tree)
        out, meta = ck.restore(str(tmp_path), target)
        assert torch.equal(out["a"], tree["a"])
        assert torch.equal(out["b"]["c"], tree["b"]["c"])
        assert meta == {"k": "v"}
        assert ck.latest_step(str(tmp_path)) == 7

    def test_latest_pointer_advances(self, tmp_path):
        tree = {"a": torch.zeros(2)}
        ck.save(str(tmp_path), 1, tree)
        ck.save(str(tmp_path), 5, tree)
        assert ck.latest_step(str(tmp_path)) == 5

    def test_structure_mismatch_rejected(self, tmp_path):
        ck.save(str(tmp_path), 0, {"a": torch.zeros(2)})
        with pytest.raises(ValueError):
            ck.restore(str(tmp_path), {"a": torch.zeros(2),
                                       "b": torch.zeros(3)})

    def test_shape_mismatch_rejected(self, tmp_path):
        ck.save(str(tmp_path), 0, {"a": torch.zeros(2)})
        with pytest.raises(ValueError):
            ck.restore(str(tmp_path), {"a": torch.zeros(3)})

    def test_dtype_mismatch_rejected(self, tmp_path):
        """An in-place restore would round silently: refuse instead."""
        ck.save(str(tmp_path), 0, {"a": torch.zeros(2)})
        with pytest.raises(ValueError, match="dtype mismatch"):
            ck.restore(str(tmp_path), {"a": torch.zeros(2,
                                                        dtype=torch.bfloat16)})

    def test_cleanup_keeps_newest(self, tmp_path):
        tree = {"a": torch.zeros(1)}
        for s in range(6):
            ck.save(str(tmp_path), s, tree)
        ck.cleanup(str(tmp_path), keep=2)
        dirs = sorted(d for d in os.listdir(tmp_path)
                      if d.startswith("step_"))
        assert dirs == ["step_00000004", "step_00000005"]

    def test_overwrite_crash_window_preserves_old_checkpoint(
            self, tmp_path, monkeypatch):
        """A crash in the final rename of an overwrite keeps the old data
        restorable, and the moved-aside copy is healed on the next save."""
        old = {"a": torch.arange(4.0)}
        new = {"a": torch.arange(4.0) * 10.0}
        ck.save(str(tmp_path), 3, old)

        step_dir = os.path.join(str(tmp_path), "step_00000003")
        real_rename = os.rename

        def failing_rename(src, dst):
            if dst == step_dir and os.path.basename(src).startswith(".tmp_"):
                raise OSError("simulated crash mid-swap")
            return real_rename(src, dst)

        monkeypatch.setattr(os, "rename", failing_rename)
        with pytest.raises(OSError, match="mid-swap"):
            ck.save(str(tmp_path), 3, new)
        monkeypatch.undo()

        out, _ = ck.restore(str(tmp_path), {"a": torch.zeros(4)}, step=3)
        assert torch.equal(out["a"], old["a"])
        ck.cleanup(str(tmp_path), keep=5)
        out, _ = ck.restore(str(tmp_path), {"a": torch.zeros(4)}, step=3)
        assert torch.equal(out["a"], old["a"])
        ck.save(str(tmp_path), 3, new)
        out, _ = ck.restore(str(tmp_path), {"a": torch.zeros(4)}, step=3)
        assert torch.equal(out["a"], new["a"])

    def test_interrupted_swap_healed_on_next_save(self, tmp_path):
        """Only the dot-prefixed trash copy left (the crash state): the next
        save puts it back before swapping."""
        ck.save(str(tmp_path), 1, {"a": torch.arange(3.0)})
        step_dir = os.path.join(str(tmp_path), "step_00000001")
        trash = os.path.join(str(tmp_path), ".old_step_00000001")
        os.rename(step_dir, trash)
        new = {"a": torch.arange(3.0) + 5.0}
        ck.save(str(tmp_path), 1, new)
        assert not os.path.exists(trash)
        out, _ = ck.restore(str(tmp_path), {"a": torch.zeros(3)}, step=1)
        assert torch.equal(out["a"], new["a"])

    def test_restore_is_in_place(self, tmp_path):
        """Params stay the same leaf tensors with ``requires_grad``; the
        optimizer's moments stay the tensors its update mutates; the step
        comes back as an ``int``."""
        opt = make_optimizer("adamw", lr=1e-2)
        params = {"w": torch.randn(4, 3, generator=torch.Generator()
                                   .manual_seed(0)).requires_grad_()}
        state = opt.init(params)
        params, state = opt.update({"w": torch.ones(4, 3)}, state, params)
        ck.save(str(tmp_path), 1, {"params": params, "opt_state": state})
        fresh = {"w": torch.zeros(4, 3, requires_grad=True)}
        fstate = opt.init(fresh)
        tree, _ = ck.restore(str(tmp_path),
                             {"params": fresh, "opt_state": fstate})
        assert tree["params"]["w"] is fresh["w"]
        assert fresh["w"].requires_grad and fresh["w"].is_leaf
        assert tree["opt_state"]["mu"]["w"] is fstate["mu"]["w"]
        assert tree["opt_state"]["step"] == 1
        assert isinstance(tree["opt_state"]["step"], int)
        assert torch.equal(fresh["w"], params["w"])
        assert torch.equal(fstate["nu"]["w"], state["nu"]["w"])

    def test_missing_checkpoint_raises(self, tmp_path):
        assert ck.latest_step(str(tmp_path)) is None
        with pytest.raises(FileNotFoundError):
            ck.restore(str(tmp_path), {"a": torch.zeros(2)})


# -- the elastic re-shard on restore, 8 gloo ranks -----------------------------

RANKS = 8
ELASTIC_MESHES = ((4, 2), (8, 1))
GLOO_TIMEOUT_S = 180


def elastic_tree():
    return {"mlp": {"wi": torch.arange(32.0).reshape(4, 8)}}


def mixed_tree():
    """Leaves the layout treats apart: fp32 sharded two ways, an uneven
    dim the guard replicates, bf16 moments and the ``int`` step."""
    gen = torch.Generator().manual_seed(0)
    params = {"embed": torch.randn(16, 8, generator=gen),
              "mlp": {"wi": torch.randn(8, 5, generator=gen)}}
    return {"params": tree_map(lambda x: x.requires_grad_(), params),
            "opt_state": {"step": 3, "mu": tree_map(
                lambda x: x.detach().bfloat16(), params)}}


def _elastic_rank(rank: int, world: int, d: str) -> None:
    """One gloo rank: restores the unsharded checkpoints onto each mesh,
    saves the re-sharded mixed tree with every other rank to one
    directory, and writes what it saw."""
    torch.set_num_threads(1)     # 8 ranks on a few cores
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    found = {}
    try:
        want = elastic_tree()["mlp"]["wi"]
        for shape in ELASTIC_MESHES:
            mesh = make_debug_mesh(shape, device_type="cpu")
            out, _ = ck.restore(os.path.join(d, "elastic"), elastic_tree(),
                                mesh=mesh)
            leaf = out["mlp"]["wi"]
            found[str(shape)] = {
                "dtensor": isinstance(leaf, DTensor),
                "equal": torch.equal(leaf.full_tensor(), want),
                "replicated": all(p.is_replicate() for p in leaf.placements),
                "local": list(leaf.to_local().shape)}
        mesh = make_debug_mesh(ELASTIC_MESHES[0], device_type="cpu")
        out, _ = ck.restore(os.path.join(d, "mixed"), mixed_tree(), mesh=mesh)
        found["mixed"] = {
            "requires_grad": [x.requires_grad for x in leaves(out["params"])],
            "step": out["opt_state"]["step"],
            "embed": str(out["params"]["embed"].placements),
            "wi": str(out["params"]["mlp"]["wi"].placements)}
        step_dir = ck.save(os.path.join(d, "sharded"), 0, out)
        found["saved"] = os.path.isfile(os.path.join(step_dir,
                                                     "manifest.json"))
        rep, _ = ck.restore(os.path.join(d, "mixed"), mixed_tree(), mesh=mesh,
                            shard_fn=lambda t, m: tree_map(
                                lambda _: replicated(m), t))
        found["shard_fn"] = all(p.is_replicate() for x in leaves(rep)
                                if isinstance(x, DTensor)
                                for p in x.placements)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(d, f"rank_{rank}.json"), "w") as f:
        json.dump(found, f)


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """What each of 8 gloo ranks saw; and the directory."""
    d = str(tmp_path_factory.mktemp("elastic"))
    ck.save(os.path.join(d, "elastic"), 0, elastic_tree())
    ck.save(os.path.join(d, "mixed"), 0, mixed_tree())
    ctx = torch.multiprocessing.spawn(_elastic_rank, args=(RANKS, d),
                                      nprocs=RANKS, join=False)
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks took over {GLOO_TIMEOUT_S} s")
    found = []
    for r in range(RANKS):
        with open(os.path.join(d, f"rank_{r}.json")) as f:
            found.append(json.load(f))
    return d, found


def test_elastic_reshard_on_restore(elastic):
    """Saved unsharded, restored onto a (4, 2) and then an (8, 1) mesh:
    values equal on every rank, and on the first mesh the leaf is sharded
    by the restore-time rules (``mlp/wi``: rows over data, columns over
    model), on the second, where 4 rows do not divide 8, columns only."""
    _, found = elastic
    for f in found:
        first, second = f[str(ELASTIC_MESHES[0])], f[str(ELASTIC_MESHES[1])]
        assert first["dtensor"] and first["equal"]
        assert not first["replicated"] and first["local"] == [1, 4]
        assert second["dtensor"] and second["equal"]
        assert second["local"] == [4, 8]


def test_restore_onto_a_mesh_keeps_grads_and_int_leaves(elastic):
    _, found = elastic
    for f in found:
        mixed = f["mixed"]
        assert mixed["requires_grad"] == [True, True] and mixed["step"] == 3
        # (V, M) embed: vocab over model, d_model over data
        assert mixed["embed"] == "(Shard(dim=1), Shard(dim=0))"
        # (M, F) wi: M over data; F = 5 does not divide over model's 2
        assert mixed["wi"] == "(Shard(dim=0), Replicate())"
        assert f["shard_fn"]


def test_sharded_save_writes_the_unsharded_bytes(elastic):
    """The 8 ranks' save of the re-sharded tree (DTensors gathered whole,
    rank 0 the one writer) is the unsharded save, file for file and byte
    for byte; it is on disk when ``save`` returns on any rank, and no
    rank left anything else in the directory."""
    d, found = elastic
    assert all(f["saved"] for f in found)
    assert sorted(os.listdir(os.path.join(d, "sharded"))) \
        == ["LATEST", "step_00000000"]
    plain = os.path.join(d, "mixed", "step_00000000")
    got = os.path.join(d, "sharded", "step_00000000")
    names = sorted(os.listdir(plain))
    assert sorted(os.listdir(got)) == names
    match, mismatch, errors = filecmp.cmpfiles(plain, got, names,
                                               shallow=False)
    assert match == names, (mismatch, errors)


# -- the layout across packages ------------------------------------------------


def jax_state(name):
    """A JAX ``{"params", "opt_state"}`` tree after two updates: leaves in
    insertion order unlike the sorted flattening, a stacked 3-d leaf."""
    rng = np.random.default_rng(0)
    params = {"scan": {"w": rng.standard_normal((2, 6, 5)).astype(
        np.float32)}, "embed": rng.standard_normal((9, 4)).astype(np.float32),
        "b": rng.standard_normal((4,)).astype(np.float32)}
    opt = jax_optimizer(name, lr=1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = opt.init(jp)
    for _ in range(2):
        jp, js = opt.update(jax.tree_util.tree_map(lambda x: 0.5 * x - 1, jp),
                            js, jp)
    return params, {"params": jp, "opt_state": js}


def port_target(name, params):
    """A fresh port tree of the same structure, in the port's insertion
    order, zeroed."""
    tp = params_from_numpy(tree_map(np.zeros_like, params), "cpu")
    return {"params": tp, "opt_state": make_optimizer(name).init(tp)}


def as_port(jtree, target):
    """The JAX tree's values in the port's structure (bf16 bits carried)."""
    def one(t, j):
        j = np.asarray(j)
        if isinstance(t, int):
            return int(j)
        if j.dtype == jnp.bfloat16:
            return torch.from_numpy(j.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(j.copy())
    return tree_map(one, target, jtree)


def assert_bit_equal(t, j):
    if isinstance(t, int):
        assert t == int(j)
        return
    j = np.asarray(j)
    if t.dtype == torch.bfloat16:
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      j.view(np.int16))
    else:
        np.testing.assert_array_equal(t.detach().numpy(), j)


OPTS = ["adamw", "adamw_bf16", "adafactor"]


@pytest.mark.parametrize("name", OPTS)
def test_jax_checkpoint_restores_bit_equal_in_the_port(name, tmp_path):
    params, jtree = jax_state(name)
    jck.save(str(tmp_path), 4, jtree, metadata={"step": 4})
    target = port_target(name, params)
    tree, meta = ck.restore(str(tmp_path), target)
    assert meta == {"step": 4}
    tree_map(assert_bit_equal, tree, jtree)
    assert tree["params"]["embed"] is target["params"]["embed"]


@pytest.mark.parametrize("name", OPTS)
def test_port_checkpoint_files_are_the_references(name, tmp_path):
    """Every ``arr_i.npy`` byte for byte, and the manifest's step, leaves
    and metadata, for the same values written by each package; the JAX
    package restores the port's files where it restores its own, and for
    bf16 leaves fails on both alike."""
    params, jtree = jax_state(name)
    ptree = as_port(jtree, port_target(name, params))
    meta = {"step": 4, "data_state": {"seed": 0, "step": 5}}
    jdir = jck.save(str(tmp_path / "jax"), 4, jtree, metadata=meta)
    tdir = ck.save(str(tmp_path / "port"), 4, ptree, metadata=meta)
    with open(os.path.join(jdir, "manifest.json")) as f:
        jm = json.load(f)
    with open(os.path.join(tdir, "manifest.json")) as f:
        tm = json.load(f)
    for key in ("step", "leaves", "metadata"):
        assert tm[key] == jm[key], key
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for i in range(len(jm["leaves"])):
        assert filecmp.cmp(os.path.join(jdir, f"arr_{i}.npy"),
                           os.path.join(tdir, f"arr_{i}.npy"),
                           shallow=False), i
    if name == "adamw_bf16":
        assert "bfloat16" in {leaf["dtype"] for leaf in tm["leaves"]}
        for d in ("jax", "port"):    # the reference cannot resume bf16
            with pytest.raises(TypeError):
                jck.restore(str(tmp_path / d), jtree)
    else:
        out, _ = jck.restore(str(tmp_path / "port"), jtree)
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)), out, jtree)


# -- restarts through the port's driver ---------------------------------------


def run_args(*argv):
    return train.build_argparser().parse_args(
        ["--batch", "2", "--seq", "16", "--log-every", "100", "--device",
         "cpu", *argv])


@pytest.mark.parametrize("arch", ["gemma-7b", "recurrentgemma-2b",
                                  "xlstm-350m", "whisper-small"])
def test_restart_equivalence(arch, tmp_path):
    """Train N steps straight == train, crash, resume (same losses)."""
    base = ["--arch", arch, "--steps", "12", "--ckpt-every", "4"]
    r1 = train.run(run_args(*base, "--ckpt-dir", str(tmp_path / "a")))
    with pytest.raises(RuntimeError, match="simulated node failure"):
        train.run(run_args(*base, "--ckpt-dir", str(tmp_path / "b"),
                           "--fail-at", "9"))
    r2 = train.run(run_args(*base, "--ckpt-dir", str(tmp_path / "b")))
    assert r2["steps"] == 3                      # resumed from step 8
    assert r2["last_loss"] == pytest.approx(r1["last_loss"], rel=1e-4)


def test_xlstm_restart_tracks_the_jax_train_loop(monkeypatch, tmp_path):
    """The reference's own restart test (``test_checkpoint_data.py``) runs
    on xlstm-350m: ``repro.launch.train``'s uninterrupted run against the
    port's run crashed at step 9 and resumed, from the JAX init and
    batches."""
    carried_jax_run(monkeypatch, "xlstm-350m")
    base = ["--arch", "xlstm-350m", "--steps", "12", "--ckpt-every", "4"]
    want = jax_train.run(jax_train.build_argparser().parse_args(
        ["--batch", "2", "--seq", "16", "--log-every", "100", *base]))
    with pytest.raises(RuntimeError, match="simulated node failure"):
        train.run(run_args(*base, "--ckpt-dir", str(tmp_path),
                           "--fail-at", "9"))
    got = train.run(run_args(*base, "--ckpt-dir", str(tmp_path)))
    assert got["steps"] == 3
    assert got["last_loss"] == pytest.approx(want["last_loss"], rel=1e-4)


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_bf16", "adafactor"])
def test_last_checkpoint_restores_the_final_state(optimizer, tmp_path):
    """The run's last checkpoint, restored into fresh tensors, equals the
    params and optimizer state ``run`` returns."""
    res = train.run(run_args("--steps", "3", "--optimizer", optimizer,
                             "--ckpt-dir", str(tmp_path)))
    assert ck.latest_step(str(tmp_path)) == 2
    assert len(res["ckpt_seconds"]) == 2 and res["restore_seconds"] is None
    fresh = tree_map(lambda x: torch.zeros_like(x) if isinstance(
        x, torch.Tensor) else 0, {"params": res["params"],
                                  "opt_state": res["opt_state"]})
    tree, meta = ck.restore(str(tmp_path), fresh)
    assert meta["step"] == 2 and meta["data_state"]["step"] == 3
    n = 0

    def same(want, got):
        nonlocal n
        n += 1
        assert want == got if isinstance(want, int) else torch.equal(got,
                                                                      want)
    tree_map(same, {"params": res["params"], "opt_state": res["opt_state"]},
             tree)
    assert n == len(list(leaves(fresh)))
