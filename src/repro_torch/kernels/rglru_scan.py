"""Hopper RG-LRU scan: bind and launch the CUDA kernel.

Replaces ``src/repro/kernels/rglru_scan.py::rglru_scan_fwd`` (the Pallas
TPU kernel ``_rglru_kernel``): ``h_t = a_t * h_{t-1} + b_t`` over S from a
zero state. The kernel source is ``csrc/rglru_scan.cu``; its header says
what bounds it and how it is laid out on the card. ``build.py`` compiles
it at the first CUDA call.

``rglru_scan_fwd`` takes CUDA tensors only and launches the kernel or
raises; the plain version for CPU tensors is ``ref.rglru_scan_ref``,
chosen by ``ops.rglru_scan``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build as _build

SOURCE = "rglru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_blocks(s: int, r: int, block_s: int = 256,
                 block_r: int = 128) -> None:
    """The Pallas kernel's shape rule: S and R divide ``min(block, len)``."""
    bs, br = min(block_s, s), min(block_r, r)
    if s % bs or r % br:
        raise ValueError(f"(S={s}, R={r}) must divide blocks ({bs},{br})")


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.rglru_scan_fwd.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.rglru_scan_fwd.restype = ctypes.c_int
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, x in (("a", a), ("b", b)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dim() != 3 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-d tensor")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")
    if a.dtype not in _DTYPES or a.dtype != b.dtype:
        raise ValueError(f"a and b must both be float32 or both bfloat16, "
                         f"got {a.dtype}, {b.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"bad shapes a {tuple(a.shape)}, b {tuple(b.shape)}")
    check_blocks(a.shape[1], a.shape[2])


def rglru_scan_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, R) on the card -> h: (B, S, R) in b's dtype.

    Launches the kernel on the current stream. Counts each launch in
    ``rglru_scan_fwd.launches``.
    """
    _check(a, b)
    lib = _load()
    bsz, s, r = a.shape
    h = torch.empty_like(b)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                 bsz, s, r, _DTYPES[a.dtype], stream)
    if err != 0:
        msg = lib.rglru_scan_error_string(err).decode()
        raise RuntimeError(f"rglru_scan_fwd launch failed: {msg} ({err})")
    rglru_scan_fwd.launches += 1
    return h


rglru_scan_fwd.launches = 0
