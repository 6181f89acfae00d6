"""The port's predictor path against the reference's: parameter counts,
shapes, the FLOP count of a training step, the roofline terms, the GPU
step DAG and its DES prediction, and the what-if CLI.

The GPU adapter keeps the reference's DAG op for op, so under the
reference's TPU v5e constants it must predict what ``repro.core.tpu_adapter``
predicts (relative 1e-12).  Under the H100 constants it must keep the
orderings ``test_hlo_static.py`` asserts for the TPU adapter.
"""
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import shapes as jax_shapes
from repro.core import hlo_analysis, tpu_adapter
from repro.core.hlo_static import parse_hlo_profile
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import transformer as jax_tf
from repro.optim.optimizers import make_optimizer as jax_optimizer
from repro_torch.configs import SHAPES
from repro_torch.configs import get_config as port_config
from repro_torch.core import flop_count, gpu_adapter
from repro_torch.core.flop_count import (H100_SXM, GpuSpec, RooflineTerms,
                                         count_step_flops)
from repro_torch.kernels import ref
from repro_torch.launch import whatif
from repro_torch.launch.steps import make_train_step as port_train_step
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as port_tf
from repro_torch.optim import make_optimizer as port_optimizer

SRC = Path(__file__).resolve().parents[1] / "src"
# The reference's TPU v5e constants, in the port's GpuSpec.
V5E = GpuSpec("TPU v5e", hlo_analysis.PEAK_FLOPS, hlo_analysis.HBM_BW,
              hlo_analysis.ICI_LINKS * hlo_analysis.ICI_BW,
              hlo_analysis.DCN_BW)
# The port's resources for the reference's.
RES = {"mxu": "tensor", "vpu": "cuda", "ici_ag": "nvlink_ag",
       "ici_rs": "nvlink_rs", "dcn": "net"}
TOKENS = 4096 * 256
S = 256


# -------------------------------------------------------- counts and shapes


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_and_counts_match_jax(arch, smoke):
    """Shapes from the config alone, for every arch (ported block kinds or
    not), equal ``jax.eval_shape`` of the reference's init leaf for leaf."""
    jcfg, pcfg = jax_config(arch, smoke=smoke), port_config(arch, smoke=smoke)
    want = jax.tree_util.tree_map(lambda x: tuple(x.shape),
                                  jax_tf.param_shapes(jcfg))
    assert port_tf.param_shapes(pcfg) == want
    assert port_tf.param_count_cfg(pcfg) == sum(
        math.prod(s) for s in jax.tree_util.tree_leaves(
            want, is_leaf=lambda x: isinstance(x, tuple)))
    assert port_tf.active_param_count(pcfg) == jax_tf.active_param_count(
        jcfg)


def _flat(tree, path=()):
    """{key path: shape} of a tree of tensors or of shape tuples."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = tuple(v.shape) if torch.is_tensor(v) else v
    return out


@pytest.mark.parametrize("arch", ["gemma-7b", "recurrentgemma-2b",
                                  "xlstm-350m", "deepseek-moe-16b",
                                  "arctic-480b"])
def test_param_shapes_match_the_ports_init(arch):
    cfg = port_config(arch, smoke=True)
    params = port_tf.init_params(torch.Generator().manual_seed(0), cfg)
    assert _flat(port_tf.param_shapes(cfg)) == _flat(params)
    assert port_tf.param_count(params) == port_tf.param_count_cfg(cfg)


def test_shapes_equal_the_reference():
    assert list(SHAPES) == list(jax_shapes.SHAPES)
    for name, sp in SHAPES.items():
        assert vars(sp) == vars(jax_shapes.SHAPES[name])


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-moe-16b",
                                  "recurrentgemma-2b"])
def test_model_flops_match_the_reference(arch):
    jcfg, pcfg = jax_config(arch), port_config(arch)
    assert flop_count.model_flops_train(pcfg, TOKENS) == \
        hlo_analysis.model_flops_train(jcfg, TOKENS)
    assert flop_count.model_flops_decode(pcfg, 128, 32768) == \
        hlo_analysis.model_flops_decode(jcfg, 128, 32768)


def test_roofline_terms_match_the_reference_under_its_constants():
    kw = dict(collective_bytes=3e9, chips=256, model_flops=7e17)
    for flops, nbytes in ((4e14, 2e11), (1e12, 9e11), (1e11, 1e9)):
        port = RooflineTerms(flops=flops, hbm_bytes=nbytes, spec=V5E, **kw)
        want = hlo_analysis.RooflineTerms(hlo_flops=flops, hlo_bytes=nbytes,
                                          **kw).as_dict()
        got = port.as_dict()
        for key in ("t_compute_s", "t_memory_s", "t_collective_s",
                    "bottleneck", "step_time_lower_bound_s",
                    "useful_flops_ratio", "mfu_bound"):
            assert got[key] == want[key], key
        assert port.step_time_serial == pytest.approx(
            want["t_compute_s"] + want["t_memory_s"] + want["t_collective_s"],
            rel=1e-15)


def test_h100_constants():
    """The H100 SXM5 data-sheet values and nothing of the TPU's."""
    assert (H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM.link_bw,
            H100_SXM.net_bw) == (989.4e12, 3.35e12, 450e9, 50e9)


# ------------------------------------------------------------ FLOP count


def _jax_step_flops(arch, flash):
    cfg = jax_config(arch, smoke=True).replace(remat=True,
                                               use_flash_kernel=flash)
    opt = jax_optimizer("adamw", lr=1e-3)
    params = jax_tf.init_params(jax.random.PRNGKey(0), cfg)
    toks = jnp.zeros((2, S), jnp.int32)
    compiled = jax.jit(jax_train_step(cfg, opt)).lower(
        params, opt.init(params), {"tokens": toks, "labels": toks}).compile()
    return parse_hlo_profile(compiled.as_text()).flops


def _port_step_flops(arch, flash):
    cfg = port_config(arch, smoke=True).replace(remat=True,
                                                use_flash_kernel=flash)
    opt = port_optimizer("adamw", lr=1e-3)
    params = port_tf.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.zeros((2, S), dtype=torch.long)
    return cfg, count_step_flops(port_train_step(cfg, opt), params,
                                 opt.init(params),
                                 {"tokens": toks, "labels": toks})


@pytest.mark.parametrize("arch,flash", [
    ("gemma-7b", False), ("gemma-7b", True), ("granite-8b", False),
    ("granite-8b", True), ("deepseek-moe-16b", False)])
def test_step_flops_match_the_compiled_jax_step(arch, flash):
    """One smoke training step (S = 256, remat on) counted on the CPU
    against ``parse_hlo_profile`` of the JAX step compiled on the CPU.

    With the flash kernel off the two counts are equal (relative 1e-6):
    the same products, the backward and the remat recompute, which both
    sides end where its last product is dead.  With it on there are two
    structural gaps, each a whole number of u = 2·B·H·S·T·D (one of the
    attention's two products) per attention layer:

      * 4u: the Pallas kernel runs twice a layer (forward and remat) with
        its two products, and in the compiled HLO they sit in conditional
        branches (the kernel's tile skipping), which ``parse_hlo_profile``
        does not follow, so the JAX count loses them; the port counts them
        through the flash op's FLOP formula;
      * u: the plain VJP recomputes the attention forward; XLA drops its
        output product P·V as dead, the port computes it.

    An MoE block has one such gap of its own: the remat recompute ends at
    the shared experts' (or the dense residual FFN's) last needed input,
    which comes after the MoE's combine product ``necd,ngec->ngd``. That
    product's output is dead there: XLA drops it, ``torch.utils.checkpoint``
    computes it, 2·n·G·E·C·d FLOPs a layer.
    """
    cfg, got = _port_step_flops(arch, flash)
    want = _jax_step_flops(arch, flash)
    if cfg.moe is not None:
        t = 2 * S
        _, g = port_moe.group_split(t, cfg.moe.group_size)
        combine = 2 * t * cfg.moe.num_experts * port_moe.capacity(cfg, g) \
            * cfg.d_model
        want += cfg.n_layers * combine
    if flash:
        u = 2 * 2 * cfg.n_heads * S * S * cfg.head_dim
        n_attn = sum(k == "attn" for k in cfg.pattern) * cfg.n_groups
        want += n_attn * (4 * u + u)
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("flash", [False, True])
def test_step_flops_on_fake_tensors_equal_the_cpu_count(flash):
    """``count_train_flops`` counts on fake tensors, with nothing
    allocated, what the same step counts on real CPU tensors."""
    cfg, want = _port_step_flops("gemma-7b", flash)
    assert flop_count.count_train_flops(cfg, 2, S) == want


@pytest.mark.parametrize("shape", [(2, 256, 4, 2, 16, 256),
                                   (1, 128, 8, 8, 64, 384),
                                   (2, 256, 16, 16, 256, 256)])
def test_flash_op_flop_formula_counts_what_the_plain_version_counts(shape):
    """The op that runs the CUDA kernel, on meta tensors, counts what the
    plain version's products count on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode
    b, s, h, kv, d, t = shape
    q, k = torch.randn(b, s, h, d), torch.randn(b, t, kv, d)
    with FlopCounterMode(display=False) as plain:
        ref.flash_attention_ref(q, k, k, True, 0)
    q, k = q.to("meta"), k.to("meta")
    with FlopCounterMode(display=False) as kernel:
        out = torch.ops.repro_torch.flash_attention_fwd(q, k, k, True, 0)
    assert kernel.get_total_flops() == plain.get_total_flops() > 0
    assert out.shape == q.shape


# ---------------------------------------------------------- GPU adapter


def _tpu_dag(arch, pods, compress=1.0):
    return tpu_adapter.build_step_dag(
        jax_config(arch), tpu_adapter.MeshFactors(pods=pods), TOKENS,
        compressed_dcn=compress)


def _gpu_dag(arch, pods, compress=1.0, spec=V5E):
    return gpu_adapter.build_step_dag(
        port_config(arch), gpu_adapter.MeshFactors(data=16, model=16,
                                                   pods=pods),
        TOKENS, compressed_dcn=compress, spec=spec)


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("arch", ["granite-8b", "llama-3.2-vision-90b"])
def test_gpu_adapter_under_v5e_constants_predicts_what_the_tpu_adapter_does(
        arch, pods):
    ref_dag, dag = _tpu_dag(arch, pods), _gpu_dag(arch, pods)
    assert len(dag.ops) == len(ref_dag.ops)
    for a, b in zip(dag.ops, ref_dag.ops):
        assert (a.name, a.res, a.deps, a.tags) == \
            (b.name, RES[b.res], b.deps, b.tags)
        assert a.size == pytest.approx(b.size, rel=1e-12)
        assert a.duration == pytest.approx(b.duration, rel=1e-12)
    assert dag.meta == ref_dag.meta
    for kw in ({}, {"straggler_factor": 1.5}, {"win_bytes": 16e6}):
        want = tpu_adapter.predict_step_time(ref_dag, num_pods=pods, **kw)
        got = gpu_adapter.predict_step_time(dag, num_pods=pods, spec=V5E,
                                            **kw)
        assert got == pytest.approx(want, rel=1e-12), kw
    want = tpu_adapter.predict_step_time(_tpu_dag(arch, pods, 0.25),
                                         num_pods=pods)
    got = gpu_adapter.predict_step_time(_gpu_dag(arch, pods, 0.25),
                                        num_pods=pods, spec=V5E)
    assert got == pytest.approx(want, rel=1e-12)
    flops = 3.7e15
    want = tpu_adapter.predict_step_time(
        tpu_adapter.calibrate(ref_dag, flops, mfu=0.4), num_pods=pods)
    got = gpu_adapter.predict_step_time(
        gpu_adapter.calibrate(dag, flops, mfu=0.4, spec=V5E),
        num_pods=pods, spec=V5E)
    assert got == pytest.approx(want, rel=1e-12)


def test_calibrate_matches_the_counted_flops():
    dag = gpu_adapter.build_step_dag(port_config("gemma-7b"),
                                     gpu_adapter.MeshFactors(), TOKENS)
    cal = gpu_adapter.calibrate(dag, 5e15, mfu=0.3)
    total = sum(op.duration for op in cal.ops if op.res == "tensor")
    assert total == pytest.approx(5e15 / (H100_SXM.peak_flops * 0.3),
                                  rel=1e-12)
    assert [op.duration for op in cal.ops if op.res != "tensor"] == \
        [op.duration for op in dag.ops if op.res != "tensor"]


class TestH100Orderings:
    """``test_hlo_static.py``'s TPU-adapter orderings under the H100
    constants (nodes of 8 GPUs)."""

    def test_dag_acyclic_and_predicts(self):
        dag = gpu_adapter.build_step_dag(port_config("granite-8b"),
                                         gpu_adapter.MeshFactors(), TOKENS)
        assert 0.01 < gpu_adapter.predict_step_time(dag) < 100.0

    def test_straggler_slows_step(self):
        dag = gpu_adapter.build_step_dag(port_config("granite-8b"),
                                         gpu_adapter.MeshFactors(), TOKENS)
        assert gpu_adapter.predict_step_time(dag, straggler_factor=1.5) > \
            gpu_adapter.predict_step_time(dag)

    def test_more_nodes_scale_throughput(self):
        cfg = port_config("granite-8b")
        t1, t2 = (gpu_adapter.predict_step_time(gpu_adapter.build_step_dag(
            cfg, gpu_adapter.MeshFactors(pods=n), TOKENS), num_pods=n)
            for n in (1, 2))
        assert t1 / 2.2 < t2 < t1

    def test_compression_helps_the_inter_node_network(self):
        cfg = port_config("llama-3.2-vision-90b")
        m = gpu_adapter.MeshFactors(pods=2)
        t_fp = gpu_adapter.predict_step_time(
            gpu_adapter.build_step_dag(cfg, m, TOKENS), num_pods=2)
        t_c = gpu_adapter.predict_step_time(gpu_adapter.build_step_dag(
            cfg, m, TOKENS, compressed_dcn=0.25), num_pods=2)
        assert t_c <= t_fp


# ---------------------------------------------------------------- what-if


def test_whatif_table_holds_the_adapters_predictions(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_SWEEP_SERIAL", "1")
    whatif.main(["--arch", "gemma-7b", "--nodes", "1", "2", "--mfu", "0.3",
                 "--win", "16e6"])
    out = capsys.readouterr().out.splitlines()
    assert out[1].split()[:4] == ["nodes", "gpus", "step", "rel_tput"]
    rows = whatif.node_table("gemma-7b", "train_4k", [1, 2], mfu=0.3,
                             wins=[16e6])
    assert len(out) == 4 and [r[:2] for r in rows] == [(1, 8), (2, 16)]
    cfg = port_config("gemma-7b")
    for n, row in zip((1, 2), rows):
        mesh = gpu_adapter.MeshFactors(pods=n, mfu=0.3)
        dag = gpu_adapter.build_step_dag(cfg, mesh, TOKENS)
        t = gpu_adapter.predict_step_time(dag, num_pods=n)
        assert row[2] == t
        assert row[4] == gpu_adapter.predict_step_time(
            dag, num_pods=n, straggler_factor=1.3) >= t
        assert row[5] <= t
        assert row[6] == (gpu_adapter.predict_step_time(
            dag, num_pods=n, win_bytes=16e6),)
        assert out[2 + n - 1].split()[2] == f"{t * 1e3:.1f}ms"
    assert rows[1][2] < rows[0][2]


def test_whatif_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.whatif", "--arch",
         "granite-8b", "--nodes", "2"], cwd=SRC, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("granite-8b train_4k") and len(lines) == 3
    assert lines[2].split()[:2] == ["2", "16"]
