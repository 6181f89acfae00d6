"""The port's kernel ops (plain path on the CPU) against the JAX package's
Pallas kernels in interpret mode: flash attention and the RG-LRU scan over
the ``test_kernels.py`` matrices, gradients, the scan's plain adjoint, the
wrappers' routing to the library's entries (through a stand-in library),
and their refusals. Inputs come from numpy."""
import contextlib
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.ops import flash_attention as jax_flash
from repro.kernels.ops import rglru_scan as jax_rglru_scan
from repro_torch.kernels import flash_attention, rglru_scan
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref
from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_fwd

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def qkv(b, s, h, kv, d, dtype, t=None, seed=7):
    rng = np.random.default_rng(seed)
    t = t or s
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]
    return ([jnp.asarray(a).astype(JNP[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs])


def check(b, s, h, kv, d, dtype, causal=True, window=0, t=None):
    (jq, jk, jv), (q, k, v) = qkv(b, s, h, kv, d, dtype, t=t)
    want = np.asarray(jax_flash(jq, jk, jv, causal, window), np.float32)
    got = flash_attention(q, k, v, causal, window)
    assert got.dtype == TORCH[dtype] and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("b,s,h,kv,d", [
    (1, 128, 1, 1, 64),
    (2, 256, 4, 2, 64),
    (1, 512, 8, 8, 128),
    (2, 384, 6, 2, 64),      # non-power-of-two seq (divisible blocks)
    (1, 256, 4, 1, 128),     # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_sweep(b, s, h, kv, d, dtype):
    check(b, s, h, kv, d, dtype)


@pytest.mark.parametrize("window", [64, 128, 256])
def test_sliding_window(window):
    check(1, 512, 4, 2, 64, "float32", window=window)


def test_noncausal():
    check(2, 256, 4, 4, 64, "float32", causal=False)


@pytest.mark.parametrize("window", [0, 128])
def test_queries_right_aligned_when_t_exceeds_s(window):
    check(1, 128, 4, 2, 64, "float32", window=window, t=384)


def test_head_dim_256_bf16():
    """The gemma-7b head width, at a CPU-sized sequence."""
    check(1, 256, 2, 2, 256, "bfloat16")


def test_grads_match_jax():
    (jq, jk, jv), (q, k, v) = qkv(1, 256, 2, 2, 64, "float32")

    def f(q, k, v):
        return jnp.sum(jax_flash(q, k, v, True, 0) ** 2)

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    (flash_attention(q, k, v, True, 0) ** 2).sum().backward()
    for a, b in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=1e-4, rtol=1e-4)


def test_plain_reference_matches_jax_reference():
    (jq, jk, jv), (q, k, v) = qkv(2, 128, 4, 2, 64, "float32")
    from repro_torch.kernels.ref import flash_attention_ref
    want = np.asarray(jax_ref.flash_attention_ref(jq, jk, jv, causal=True,
                                                  window=32))
    got = flash_attention_ref(q, k, v, causal=True, window=32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


OFFSET_SHARDS = 4     # the sequence cut into 4 shards of S / 4 queries


@pytest.mark.parametrize("shard", [0, OFFSET_SHARDS - 1])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_offset_rows_match_the_whole_sequence(dtype, window, shard):
    """A sequence shard's queries at their own offset: the plain version
    with ``q_offset = r·S/n`` on rows [r·S/n, (r+1)·S/n) and whole k, v
    equals those rows of the JAX package's plain version on the whole
    sequence, causal, with and without a window."""
    from repro_torch.kernels.ref import flash_attention_ref
    (jq, jk, jv), (q, k, v) = qkv(2, 512, 4, 2, 64, dtype)
    rows = slice(shard * 512 // OFFSET_SHARDS,
                 (shard + 1) * 512 // OFFSET_SHARDS)
    want = np.asarray(jax_ref.flash_attention_ref(
        jq, jk, jv, causal=True, window=window), np.float32)[:, rows]
    got = flash_attention_ref(q[:, rows], k, v, causal=True, window=window,
                              q_offset=rows.start)
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("q_offset,ok", [(-1, False), (0, True),
                                         (384, True), (385, False)])
def test_fake_kernel_holds_the_query_offset_range(q_offset, ok):
    """On fake ``cuda`` tensors the op takes a causal offset in [0, T - S]
    (S = 128, T = 512) and refuses one outside, as the CUDA wrapper does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.zeros((1, 128, 4, 64), dtype=torch.bfloat16, device="cuda")
        k = torch.zeros((1, 512, 2, 64), dtype=torch.bfloat16, device="cuda")
        op = torch.ops.repro_torch.flash_attention_fwd
        if ok:
            assert op(q, k, k, True, 0, q_offset).shape == q.shape
        else:
            with pytest.raises(ValueError, match="q_offset"):
                op(q, k, k, True, 0, q_offset)


# The flash op's backward: the plain reference's gradient written out
# (``ref.flash_attention_vjp``, ``ops._flash_vjp``). Each case: batch, the
# whole sequence, q's heads, kv heads, head width, window, the query rows
# a sequence shard takes (None: all, at no layout), and the kv heads its
# layout cuts k and v to (None: all).
VJP_CASES = {
    "gqa-2": (2, 256, 4, 2, 64, 0, None, None),
    "gqa-4-window": (1, 256, 8, 2, 64, 64, None, None),
    "shard-offset": (2, 512, 4, 2, 64, 0, (256, 384), None),
    "shard-offset-window": (1, 512, 4, 1, 64, 64, (128, 256), None),
    "kv-slice": (2, 256, 2, 4, 64, 0, (128, 256), (1, 2)),
}
VJP_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# The same, with B·Kv (Kv after the layout's slice) of 6 or more (batch, kv
# head) slices: at least 3 chunks of 2 under a lowered budget.
CHUNK_CASES = {
    "gqa-chunks": (3, 128, 8, 4, 64, 0, None, None),
    "shard-offset-chunks": (3, 256, 4, 2, 64, 0, (128, 192), None),
    "kv-slice-chunks": (3, 128, 4, 8, 64, 0, (64, 128), (2, 4)),
}


def _vjp_inputs(name, dtype, cases=VJP_CASES):
    """q (B, S, H, D), k, v (B, S, Kv, D) and a cotangent g of q's shape,
    from numpy, in both packages; the case's rows and kv slice."""
    b, s, h, kv, d, window, rows, heads = cases[name]
    (jq, jk, jv), (q, k, v) = qkv(b, s, h, kv, d, dtype)
    g = np.random.default_rng(11).standard_normal((b, s, h, d))
    return ((jq, jk, jv, jnp.asarray(g, jnp.float32).astype(JNP[dtype])),
            (q, k, v, torch.from_numpy(g).float().to(TORCH[dtype])),
            window, slice(*(rows or (0, s))), slice(*(heads or (0, kv))))


def _port_vjp(q, k, v, g, window, rows, heads):
    """``ops._flash_vjp`` on the rows' queries, at the rows' offset and the
    kv slice under a rank's layout, or with none for a whole case."""
    from repro_torch.kernels import ops
    from repro_torch.parallel.sharding import AttentionLayout
    whole = rows.start == 0 and rows.stop == q.shape[1] and \
        heads.stop - heads.start == k.shape[2]
    layout = None if whole else AttentionLayout(
        (), (), (), rows.start, (heads.start, heads.stop))
    return ops._flash_vjp(q[:, rows], k, v, g[:, rows], True, window, layout)


def _assert_grads_close(got, want, dtype):
    """fp32: within 1e-5 of each gradient's max; bf16: 2e-2 of its norm."""
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        if dtype == "float32":
            assert np.abs(a - b).max() <= VJP_TOL[dtype] * np.abs(b).max()
        else:
            assert np.linalg.norm(a - b) <= VJP_TOL[dtype] * np.linalg.norm(b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(VJP_CASES))
def test_flash_vjp_matches_autograd_of_the_plain_version(name, dtype):
    """The written-out gradient against autograd of
    ``ref.flash_attention_ref`` on the same rows, offset and kv slice (k's
    and v's gradients zero outside the slice), in each input's dtype."""
    from repro_torch.kernels.ref import flash_attention_ref
    _, (q, k, v, g), window, rows, heads = _vjp_inputs(name, dtype)
    got = _port_vjp(q, k, v, g, window, rows, heads)
    leaves = [x[:, rows] if i == 0 else x
              for i, x in enumerate((q, k, v))]
    leaves = [x.clone().requires_grad_() for x in leaves]
    out = flash_attention_ref(leaves[0], leaves[1][:, :, heads],
                              leaves[2][:, :, heads], causal=True,
                              window=window, q_offset=rows.start)
    want = torch.autograd.grad(out, leaves, g[:, rows])
    assert [x.dtype for x in got] == [x.dtype for x in want]
    _assert_grads_close([x.float() for x in got], [x.float() for x in want],
                        dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(VJP_CASES))
def test_flash_vjp_matches_the_references_vjp(name, dtype):
    """The written-out gradient against ``jax.vjp`` of the JAX package's
    plain version (its ``_fa_bwd``) on the whole sequence, the cotangent
    zero outside the rows: the rows' dq, and dk and dv of the kv slice
    with zeros outside it."""
    (jq, jk, jv, jg), (q, k, v, g), window, rows, heads = _vjp_inputs(
        name, dtype)
    got = _port_vjp(q, k, v, g, window, rows, heads)
    jg = jg.at[:, :rows.start].set(0).at[:, rows.stop:].set(0)
    _, vjp = jax.vjp(lambda q, k, v: jax_ref.flash_attention_ref(
        q, k, v, causal=True, window=window), jq, jk[:, :, heads],
        jv[:, :, heads])
    dq, dk, dv = (np.asarray(x, np.float32) for x in vjp(jg))
    pad = [(0, 0), (0, 0), (heads.start, jk.shape[2] - heads.stop), (0, 0)]
    want = [dq[:, rows], np.pad(dk, pad), np.pad(dv, pad)]
    _assert_grads_close([x.float().numpy() for x in got], want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CHUNK_CASES))
def test_flash_vjp_in_chunks_is_the_one_chunk_vjp(name, dtype, monkeypatch):
    """``ref.flash_attention_vjp`` over chunks of 2 (batch, kv head)
    slices, at least 3 of them, ``torch.equal`` to the same call in one
    chunk: B and Kv are batch dims of its five products."""
    from repro_torch.kernels import ref
    _, (q, k, v, g), window, rows, heads = _vjp_inputs(name, dtype,
                                                       CHUNK_CASES)
    chunks = []
    real = ref._vjp_slices
    monkeypatch.setattr(ref, "_vjp_slices",
                        lambda *a: chunks.append(a[0].shape) or real(*a))
    monkeypatch.setattr(ref, "VJP_CHUNK_BYTES", 1 << 62)
    whole = _port_vjp(q, k, v, g, window, rows, heads)
    assert len(chunks) == 1
    kv = heads.stop - heads.start
    per_slice = 4 * (q.shape[2] // kv) * (rows.stop - rows.start) * k.shape[1]
    monkeypatch.setattr(ref, "VJP_CHUNK_BYTES", 2 * per_slice)
    del chunks[:]
    got = _port_vjp(q, k, v, g, window, rows, heads)
    assert len(chunks) >= 3
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, whole))


def test_starcoder2_two_layers_hold_no_whole_fp32_score_tensor():
    """starcoder2-7b cut to 2 layers at ``train_4k`` on 16 x 16 (256 fake
    ranks): no fp32 tensor of a whole (16, 4, 9, 256, 4096) P, dP or dS
    (the VJP's chunks), nor of the residual's local (16, 4096, 4608) (the
    norms' chunks), is live at the peak, and the FLOPs hold."""
    from repro_torch.configs import SHAPES, get_config, get_optimizer_name
    from repro_torch.launch import dryrun
    cfg = get_config("starcoder2-7b").replace(n_layers=2,
                                              use_flash_kernel=True)
    with dryrun.fake_process_group(256):
        mesh = dryrun.make_production_mesh(device_type="cpu")
        c = dryrun.trace_step(cfg, SHAPES["train_4k"], mesh,
                              get_optimizer_name("starcoder2-7b"))["counts"]
    print(f"\nstarcoder2-7b, 2 layers, train_4k 16x16: peak "
          f"{c.peak_bytes / 2**30:.2f} GiB; largest live at the peak: "
          f"{c.peak_tensors}")
    assert f"{c.flops:.4e}" == "2.2342e+13"
    residual, scores = 4 * 16 * 4096 * 4608, 4 * 16 * 4 * 9 * 256 * 4096
    assert residual < scores
    assert all(t["bytes"] < residual for t in c.peak_tensors
               if t["dtype"] == "torch.float32")


def test_flash_backward_counts_five_products():
    """One backward of the op counts five products of 2·B·H·S·T·D: the
    logits, dv = Pᵀ·g, dP = g·vᵀ, dq and dk; no output product P·V."""
    from torch.utils.flop_counter import FlopCounterMode
    b, s, h, kv, d = 2, 256, 4, 2, 64
    _, (q, k, v) = qkv(b, s, h, kv, d, "float32")
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = flash_attention(q, k, v, True, 0)
    with FlopCounterMode(display=False) as counter:
        out.backward(torch.ones_like(out))
    assert counter.get_total_flops() == 5 * 2 * b * h * s * s * d


def test_undividable_seq_raises_like_jax():
    (jq, jk, jv), (q, k, v) = qkv(1, 200, 2, 2, 64, "float32")
    with pytest.raises(ValueError, match="must divide blocks"):
        jax_flash(jq, jk, jv, True, 0)
    with pytest.raises(ValueError, match="must divide blocks"):
        flash_attention(q, k, v, True, 0)


def test_kernel_wrapper_refuses_cpu_tensors():
    _, (q, k, v) = qkv(1, 128, 2, 2, 64, "float32")
    before = flash_attention_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches == before


def test_op_refuses_other_devices():
    q = torch.empty((1, 128, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q, True, 0)


class FakeLib:
    """Stands in for a kernel library: records each entry called, with its
    arguments, and returns 0 (success)."""

    def __init__(self, *entries):
        self.calls = []
        for name in entries:
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def fake_launch_env(monkeypatch, module, lib):
    """Lets ``module``'s wrapper run on CPU tensors against ``lib``: its
    device check passes, the library is ``lib``, and the stream is 0."""
    monkeypatch.setattr(module, "_load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("dtype,entry", [
    ("bfloat16", "flash_attention_fwd_bf16"),    # tensor-core kernel
    ("float32", "flash_attention_fwd_fp32"),     # CUDA-core kernel
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 64)])
def test_flash_wrapper_routes_each_dtype(dtype, entry, causal, window,
                                         monkeypatch):
    mod = importlib.import_module("repro_torch.kernels.flash_attention")
    lib = FakeLib(*mod.ENTRIES.values())
    fake_launch_env(monkeypatch, mod, lib)
    monkeypatch.setattr(mod, "_check", lambda *args: None)   # CPU tensors
    _, (q, k, v) = qkv(2, 256, 4, 2, 128, dtype)
    before = mod.flash_attention_fwd.launches
    out = mod.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert [name for name, _ in lib.calls] == [entry]
    args = lib.calls[0][1]
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    # ..., causal, window, the query offset (T - S by default), the stream
    assert args[4:] == (2, 256, 256, 4, 2, 128, int(causal),
                        window if causal else 0, 0, 0)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert mod.flash_attention_fwd.launches == before + 1


@pytest.mark.parametrize("module", ["flash_attention", "rglru_scan"])
def test_build_without_nvcc_raises(module, monkeypatch, tmp_path):
    # the package attributes are the ops; the modules are reached by name
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    build = importlib.import_module("repro_torch.kernels.build")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(mod.SOURCE)


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

RG_TOL = 3e-5


def scan_inputs(shape, bf16_rounded=False, seed=11):
    """The ``TestRglruScan`` inputs: a in (0.8, 1), b ~ 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal(shape))) * 0.2 + 0.8)
    b = 0.1 * rng.standard_normal(shape)
    a, b = (torch.from_numpy(x.astype(np.float32)) for x in (a, b))
    if bf16_rounded:
        a, b = (x.bfloat16().float() for x in (a, b))
    return a, b


def check_scan(a, b):
    want = np.asarray(jax_rglru_scan(jnp.asarray(a.numpy()),
                                     jnp.asarray(b.numpy())))
    got = rglru_scan(a, b)
    assert got.dtype == b.dtype and got.shape == b.shape
    np.testing.assert_allclose(got.numpy(), want, atol=RG_TOL, rtol=RG_TOL)
    return got


@pytest.mark.parametrize("b,s,r", [(1, 256, 128), (2, 512, 256),
                                   (3, 256, 384)])
@pytest.mark.parametrize("bf16_rounded", [False, True])
def test_rglru_scan_sweep(b, s, r, bf16_rounded):
    check_scan(*scan_inputs((b, s, r), bf16_rounded))


def test_rglru_scan_leading_dims():
    check_scan(*scan_inputs((2, 2, 256, 128)))


def test_rglru_scan_decay_stability():
    """|a| < 1 keeps h bounded over long sequences."""
    a = torch.full((1, 2048, 64), 0.99)
    h = check_scan(a, torch.full((1, 2048, 64), 0.01))
    assert float(h.abs().max()) < 2.0


def test_rglru_scan_grads_match_jax():
    a, b = scan_inputs((1, 256, 128))
    a = a * 0.5

    def f(a, b):
        return jnp.sum(jax_rglru_scan(a, b) ** 2)

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(a.numpy()),
                                       jnp.asarray(b.numpy()))
    a, b = (x.requires_grad_() for x in (a, b))
    (rglru_scan(a, b) ** 2).sum().backward()
    for got, w in zip((a.grad, b.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)


def test_rglru_plain_reference_matches_jax_reference():
    a, b = scan_inputs((2, 64, 32))
    want = jax_ref.rglru_scan_ref(jnp.asarray(a.numpy()),
                                  jnp.asarray(b.numpy()))
    np.testing.assert_allclose(rglru_scan_ref(a, b).numpy(), np.asarray(want),
                               atol=RG_TOL, rtol=RG_TOL)


@pytest.mark.parametrize("s,r", [(300, 128), (256, 200)])
def test_rglru_undividable_raises_like_jax(s, r):
    a, b = scan_inputs((1, s, r))
    with pytest.raises(ValueError, match="must divide blocks"):
        jax_rglru_scan(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    with pytest.raises(ValueError, match="must divide blocks"):
        rglru_scan(a, b)


def test_rglru_kernel_wrapper_refuses_cpu_tensors():
    a, b = scan_inputs((1, 256, 128))
    before = rglru_scan_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_fwd(a, b)
    assert rglru_scan_fwd.launches == before


def test_rglru_op_refuses_other_devices():
    a = torch.empty((1, 256, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rglru_scan(a, a)


def test_rglru_bwd_wrapper_refuses_cpu_tensors():
    a, b = scan_inputs((1, 256, 128))
    before = rglru_scan_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_bwd(a, b, b)
    assert rglru_scan_fwd.launches == before


def test_rglru_wrappers_route_to_both_modes_and_count_once_each(monkeypatch):
    mod = importlib.import_module("repro_torch.kernels.rglru_scan")
    lib = FakeLib("rglru_scan_fwd", "rglru_scan_bwd")
    fake_launch_env(monkeypatch, mod, lib)
    monkeypatch.setattr(mod, "_check", lambda **tensors: None)  # CPU tensors
    a, b = scan_inputs((2, 256, 128))
    before = mod.rglru_scan_fwd.launches
    h = mod.rglru_scan_fwd(a, b)
    da, db = mod.rglru_scan_bwd(a, b, h)
    assert [name for name, _ in lib.calls] == ["rglru_scan_fwd",
                                               "rglru_scan_bwd"]
    assert lib.calls[0][1] == (a.data_ptr(), b.data_ptr(), h.data_ptr(),
                               2, 256, 128, 0, 0)
    assert lib.calls[1][1] == (a.data_ptr(), b.data_ptr(), h.data_ptr(),
                               da.data_ptr(), db.data_ptr(), 2, 256, 128, 0,
                               0)
    # one counter for the kernel, both directions
    assert mod.rglru_scan_fwd.launches == before + 2


def jax_scan_vjp(a, b, g):
    """(da, db) from the JAX op's VJP (Pallas forward in interpret mode,
    reverse associative scan backward)."""
    _, vjp = jax.vjp(jax_rglru_scan, jnp.asarray(a.numpy()),
                     jnp.asarray(b.numpy()))
    return [np.asarray(x) for x in vjp(jnp.asarray(g.numpy()))]


@pytest.mark.parametrize("shape", [(1, 256, 128), (2, 512, 256),
                                   (3, 256, 384), (2, 2, 256, 128)])
@pytest.mark.parametrize("bf16_rounded", [False, True])
def test_rglru_plain_adjoint_matches_jax_vjp(shape, bf16_rounded):
    """The plain version of the kernel's reverse mode is the JAX VJP."""
    a, b = scan_inputs(shape, bf16_rounded)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(shape)
                         .astype(np.float32))
    want_da, want_db = jax_scan_vjp(a, b, g)
    da, db = rglru_scan_bwd_ref(a, g, rglru_scan_ref(a, b))
    assert da.dtype == db.dtype == a.dtype
    np.testing.assert_allclose(db.numpy(), want_db, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(da.numpy(), want_da, atol=1e-5, rtol=1e-5)


def test_rglru_scan_grads_match_jax_leading_dims():
    a, b = scan_inputs((2, 2, 256, 128))
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(a.shape)
                         .astype(np.float32))
    want = jax_scan_vjp(a, b, g)
    a, b = (x.requires_grad_() for x in (a, b))
    rglru_scan(a, b).backward(g)
    for got, w in zip((a.grad, b.grad), want):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5, rtol=1e-5)
