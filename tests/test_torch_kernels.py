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
    assert args[4:] == (2, 256, 256, 4, 2, 128, int(causal),
                        window if causal else 0, 0)
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
