"""Build and load the port's CUDA kernels.

The four sources under ``csrc/`` are compiled with ``nvcc`` into one shared
library with a plain C interface, which is loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds). The library lands in
``ops/_build/``, named by a hash of the sources, so an edited source is
rebuilt at its first use and an unchanged one is loaded as built. A failed
build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("sector_sort.cu", "greedy_nms.cu", "select_points.cu", "knn.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types; every one returns cudaError_t
SIGNATURES = {
    "loam_sector_sort_f64": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "loam_sector_sort_f32": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "loam_greedy_nms": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "loam_select_points_f32": (_P, _P, _I, _I, _I, _P, _P),
    "loam_select_points_f64": (_P, _P, _I, _I, _I, _P, _P),
    "loam_knn": (_P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P),
}

_lib = None
#: Seconds the last build in this process took (0.0 when loaded as built).
last_build_seconds = 0.0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"loam_kernels_{_source_hash()}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        last_build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    last_build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtypes, shape=None, device=None) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of one of
    ``dtypes`` with ``shape`` (``None`` entries match any size) on
    ``device``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and (
        t.ndim != len(shape)
        or any(s is not None and s != d for s, d in zip(shape, t.shape))
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
