"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc into one shared library
with a plain C interface, loaded with ctypes: `nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -fmad=false -shared -Xcompiler -fPIC`.
The library lands in build/splatam_tpu_torch/ under the repository root,
named by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is not. Every entry point takes raw device pointers and the CUDA stream,
launches on that stream and returns the launch's cudaError_t.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "splatam_tpu_torch"
# -fmad=false: no contraction of a*b+c into one FMA, so the kernels round
# exactly like their plain versions' separate tensor ops, and the
# compositing thresholds (alpha < 1/255, T < 1e-4) decide alike in both.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argument types (every function returns int: a cudaError_t)
_SIGNATURES = {
    "composite_forward_ch5": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "composite_backward_ch5": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "fused_forward": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "fused_backward": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "segment_reduce8": [_P, _P, _P, _P, _I, _P, _P],
    "segment_reduce11": [_P, _P, _P, _P, _I, _P, _P],
    "last_error_string": [_I],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsplatam_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels if this source state has no library yet.
    Returns (library path, build seconds (0 if reused), ptxas report)."""
    lib = library_path()
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.time() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    log.write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)
    return lib, secs, res.stdout + res.stderr


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _, _ = build()
    cdll = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int if name != "last_error_string" else ctypes.c_char_p
    return cdll


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().last_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Validate a kernel argument: CUDA, dtype, shape (None = any), contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
