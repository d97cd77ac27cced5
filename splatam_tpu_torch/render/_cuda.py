"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc into one shared library
with a plain C interface, loaded with ctypes: one `nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -fmad=false -Xcompiler -fPIC -c` per
source, all started together, then one `nvcc -shared` link. The library
lands in build/splatam_tpu_torch/ under the repository root, named by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is not. Every entry point takes raw device pointers and the CUDA stream,
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
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "splatam_tpu_torch"
# -fmad=false: no contraction of a*b+c into one FMA, so the kernels round
# exactly like their plain versions' separate tensor ops, and the
# compositing thresholds (alpha < 1/255, T < 1e-4) decide alike in both.
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
# name -> argument types (every function returns int: a cudaError_t)
_SIGNATURES = {
    # K1, K2 and K3 take their channel count (K3: its columns) first
    "composite_forward": [_I, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "composite_backward": [_I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "fused_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "fused_backward": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "segment_reduce": [_I, _P, _P, _P, _P, _I, _P, _P],
    # get_loss's loss and gradient planes (csrc/loss.cu): the route, the five
    # render and frame planes with color's and depth_gt's strides, the
    # outlier threshold, the size, the mask's switches and scalars, outputs
    "loss_forward": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I,
                     _F, _F, _F, _F, _P, _P, _I, _P, _P, _P],
    # the generic render's projection (csrc/projection.cu): n, the camera's
    # floats, the leaves, the outputs; the backward's cotangents with their
    # strides, then its four outputs (null: not asked for)
    "project_forward": [_I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "project_backward": [_I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _P, _I, _I, _P, _I,
                         _P, _P, _P, _P, _P],
    # the structure build's per-pair work (csrc/binning.cu): pairs, Gaussians,
    # offsets, the int64 rectangles and depth keys, grid_x, bits, direct_j, key;
    # then pairs, Gaussians, sorted keys, order, offsets, key bits, tiles, outputs
    "bins_expand": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "bins_scatter": [_I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    # what the compiler gave a kernel (registers, local bytes, blocks per SM)
    "composite_forward_info": [_I, _IP, _IP, _IP],
    "composite_backward_info": [_I, _IP, _IP, _IP],
    "fused_forward_info": [_IP, _IP, _IP],
    "fused_backward_info": [_IP, _IP, _IP],
    "segment_reduce_info": [_I, _IP, _IP, _IP],
    "loss_info": [_I, _IP, _IP, _IP],
    "project_info": [_I, _IP, _IP, _IP],
    "bins_info": [_I, _IP, _IP, _IP],
    # the fused forward's probe kernels (csrc/fused_probes.cu)
    "fused_forward2": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "fused_math_only": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "dma_walk1": [_P, _P, _I, _P, _P],
    "dma_walk2": [_P, _P, _I, _P, _P],
    "dma_walk4": [_P, _P, _I, _P, _P],
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
    """Compile the kernels if this source state has no library yet: the
    sources in parallel (the build's time is that of the slowest source,
    not the sum), then one link. Returns (library path, build seconds (0 if
    reused), ptxas report). Objects and a partial library are removed
    whether the build succeeds or fails."""
    lib = library_path()
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    objdir = BUILD_DIR / f"{lib.stem}.{os.getpid()}.obj"
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    try:
        jobs = [(src, objdir / f"{src.stem}.o") for src in sorted(CSRC.glob("*.cu"))]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in jobs]
        report, failed = "", []
        for (src, _), proc in zip(jobs, procs):
            out, _ = proc.communicate()
            report += out
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode})")
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{report}")
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                              *(str(obj) for _, obj in jobs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        secs = time.time() - t0
        log.write_text(report)
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
        tmp.unlink(missing_ok=True)
    return lib, secs, report


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


def launch(t: torch.Tensor, entry: str, *args, label: str | None = None) -> None:
    """Call the library's `entry` with args and then t's current stream,
    with t's card the runtime's current device for the call (the library
    launches on the current device, which need not be the one t lies on
    when the row bands of parallel/spatial.py span several cards; the
    device is switched only then, so a one-card launch pays one query).
    Raises on a launch error, naming the kernel `label` (default: entry)."""
    fn = getattr(lib(), entry)
    if t.device.index == torch.cuda.current_device():
        err = fn(*args, stream_ptr(t))
    else:
        with torch.cuda.device(t.device):
            err = fn(*args, stream_ptr(t))
    check(err, label or entry)


class KernelInfo(NamedTuple):
    """What the compiler and the runtime give one kernel on this card."""

    registers: int  # per thread
    local_bytes: int  # local memory per thread (register spills, local arrays)
    blocks_per_sm: int  # resident blocks of its launch size on one SM


def kernel_info(name: str, *args) -> KernelInfo:
    """KernelInfo from the library's `name` entry, which takes `args` and
    then the three output pointers (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor on the device)."""
    vals = [ctypes.c_int() for _ in range(3)]
    check(getattr(lib(), name)(*args, *(ctypes.byref(v) for v in vals)), name)
    return KernelInfo(*(v.value for v in vals))


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
