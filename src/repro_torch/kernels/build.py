"""Build the hand-written CUDA kernels with ``nvcc``.

Each source in ``csrc/`` is compiled on its own into a shared library with
a plain C interface, into ``build/`` at the repo root, and bound with
``ctypes`` by its kernel module: no PyTorch headers, so a build takes
seconds. A library's name carries a hash of its source and the flags, so
an edited source is rebuilt. Importing this module needs neither ``nvcc``
nor a card; a kernel module builds its library at its first CUDA call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use")
    return nvcc


def _library(name: str) -> Path:
    src = (CSRC / name).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(name).stem}_{tag}.so"


def build(*names: str) -> Dict[str, Tuple[Path, str]]:
    """Compile the named sources of ``csrc/`` whose libraries are missing,
    one ``nvcc`` for each, all started together.

    Returns ``{name: (library path, compiler output)}``; the output is ""
    for a library that was already built.
    """
    done, running = {}, {}
    for name in names:
        lib = _library(name)
        if lib.exists():
            done[name] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)]
        running[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name} ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        done[name] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The library of source ``name``, built first if it is missing."""
    path, _ = build(name)[name]
    return ctypes.CDLL(str(path))
