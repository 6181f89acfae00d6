"""Hopper flash-attention forward: bind and launch the CUDA kernel.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_fwd`` (the
Pallas TPU kernel ``_attn_kernel``). The kernel source is
``csrc/flash_attention.cu``; its header says what bounds it and how it is
laid out on the card. ``build.py`` compiles it at the first CUDA call. The
library has one entry per input type: bf16 goes to the tensor-core kernel
(``flash_attention_fwd_bf16``), fp32 to the fp32 kernel on the CUDA cores
(``flash_attention_fwd_fp32``).

``flash_attention_fwd`` takes CUDA tensors only and launches the kernel or
raises; the plain version for CPU tensors is ``ref.flash_attention_ref``,
chosen by ``ops.flash_attention``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build as _build

SOURCE = "flash_attention.cu"
HEAD_DIMS = (64, 128, 256)
ENTRIES = {torch.float32: "flash_attention_fwd_fp32",
           torch.bfloat16: "flash_attention_fwd_bf16"}


def fits_blocks(n: int, block: int = 128) -> bool:
    """Whether a sequence length ``n`` divides its block, ``min(block, n)``."""
    return n % min(block, n) == 0


def check_blocks(s: int, t: int, block_q: int = 128,
                 block_k: int = 128) -> None:
    """The Pallas kernel's shape rule: S and T divide ``min(block, len)``."""
    if not (fits_blocks(s, block_q) and fits_blocks(t, block_k)):
        raise ValueError(f"seq lens ({s},{t}) must divide blocks "
                         f"({min(block_q, s)},{min(block_k, t)})")


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for entry in ENTRIES.values():
        fn = getattr(lib, entry)
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _offset(s: int, t: int, q_offset: Optional[int]) -> int:
    """The key-space position of query 0: ``q_offset``, or T - S (right
    alignment) for None."""
    return t - s if q_offset is None else int(q_offset)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int, q_offset: Optional[int] = None) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != q.device:
            raise ValueError("q, k and v must be on one device")
        if x.dtype not in ENTRIES or x.dtype != q.dtype:
            raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                             f"{q.dtype}, {k.dtype}, {v.dtype}")
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-d tensor")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if k.shape != (b, t, kv, d) or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)},"
                         f" v {tuple(v.shape)}")
    if h % kv:
        raise ValueError(f"n_heads {h} must be a multiple of n_kv {kv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if causal and t < s:
        # Rows before the first key see no key at all; the reference then
        # averages every value, which a range-bounded kv loop cannot do.
        raise ValueError(f"causal attention needs T >= S, got T={t}, S={s}")
    off = _offset(s, t, q_offset)
    if causal and not 0 <= off <= t - s:
        # a row past the last key, or before the first, leaves the range
        raise ValueError(f"causal attention needs 0 <= q_offset <= T - S = "
                         f"{t - s}, got {off}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    check_blocks(s, t)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_offset: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, Kv, D) with H % Kv == 0; CUDA only.

    Query i sits at key position ``q_offset + i`` (T - S for None; a shard
    of the sequence passes its own, 0 <= q_offset <= T - S when causal).
    Launches the kernel on the current stream and returns (B, S, H, D) in
    q's dtype. Counts each launch in ``flash_attention_fwd.launches``.
    """
    _check(q, k, v, causal, window, q_offset)
    lib = _load()
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, ENTRIES[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, s, t, h, kv, d, int(causal), int(window) if causal else 0,
            _offset(s, t, q_offset), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} ({err})")
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0
