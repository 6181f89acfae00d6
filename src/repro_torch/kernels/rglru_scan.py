"""Hopper RG-LRU scan: bind and launch the CUDA kernel.

Replaces ``src/repro/kernels/rglru_scan.py::rglru_scan_fwd`` (the Pallas
TPU kernel ``_rglru_kernel``): ``h_t = a_t * h_{t-1} + b_t`` over S from a
zero state. The kernel source is ``csrc/rglru_scan.cu``; its header says
what bounds it and how it is laid out on the card. ``build.py`` compiles
it at the first CUDA call. The kernel has a reverse mode, the op's adjoint,
launched by ``rglru_scan_bwd``.

``rglru_scan_fwd`` and ``rglru_scan_bwd`` take CUDA tensors only and launch
the kernel or raise; the plain versions for CPU tensors are
``ref.rglru_scan_ref`` and ``ref.rglru_scan_bwd_ref``, chosen by
``ops.rglru_scan``. Both directions count their launches in the one
counter ``rglru_scan_fwd.launches``.
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
    lib.rglru_scan_bwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.rglru_scan_bwd.restype = ctypes.c_int
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(**tensors: torch.Tensor) -> None:
    """All CUDA, contiguous, 3-d, of one shape, device and dtype."""
    first = next(iter(tensors.values()))
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dim() != 3 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-d tensor")
    names = ", ".join(tensors)
    if any(x.device != first.device for x in tensors.values()):
        raise ValueError(f"{names} must be on one device")
    if first.dtype not in _DTYPES or any(x.dtype != first.dtype
                                         for x in tensors.values()):
        raise ValueError(f"{names} must all be float32 or all bfloat16, got "
                         + ", ".join(str(x.dtype) for x in tensors.values()))
    if any(x.shape != first.shape for x in tensors.values()):
        raise ValueError("bad shapes " + ", ".join(
            f"{n} {tuple(x.shape)}" for n, x in tensors.items()))
    check_blocks(first.shape[1], first.shape[2])


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.rglru_scan_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def rglru_scan_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, R) on the card -> h: (B, S, R) in b's dtype.

    Launches the kernel on the current stream. Counts each launch in
    ``rglru_scan_fwd.launches``.
    """
    _check(a=a, b=b)
    lib = _load()
    bsz, s, r = a.shape
    h = torch.empty_like(b)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                 bsz, s, r, _DTYPES[a.dtype], stream)
    _raise_on(lib, err, "rglru_scan_fwd")
    rglru_scan_fwd.launches += 1
    return h


rglru_scan_fwd.launches = 0


def rglru_scan_bwd(a: torch.Tensor, g: torch.Tensor,
                   h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The adjoint of ``rglru_scan_fwd`` on the card: a, the output
    gradient g and the forward's h, all (B, S, R) of one dtype ->
    (da, db), where db_t = lam_t = g_t + a_{t+1} lam_{t+1} and
    da_t = lam_t h_{t-1}.

    Launches the kernel's reverse mode on the current stream and counts
    the launch in ``rglru_scan_fwd.launches``.
    """
    _check(a=a, g=g, h=h)
    lib = _load()
    bsz, s, r = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_bwd(a.data_ptr(), g.data_ptr(), h.data_ptr(),
                                 da.data_ptr(), db.data_ptr(), bsz, s, r,
                                 _DTYPES[a.dtype], stream)
    _raise_on(lib, err, "rglru_scan_bwd")
    rglru_scan_fwd.launches += 1
    return da, db
