"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` (the kernels; ``peer_gather.cu``: the mesh's
gather and sum over peer memory, ``ops/peer_cuda.py``, and ``peer_proxy.cpp``,
its host proxy across hosts, plain C++; and ``graph_if.cu``: the
CUDA-graph conditional nodes of ``program.when``, ``program.while_loop`` and
``program.scan``) are compiled with ``nvcc``, one
process per source and all at once, and linked into one shared library with a plain C
interface, which is loaded with ``ctypes`` (no PyTorch headers, so the build
takes seconds). The library lands in ``ops/_build/``, named by a hash of the
sources and the flags, so an edited source is rebuilt at its first use and an
unchanged one is loaded as built. ``ptxas`` reports every kernel's registers,
shared memory and spills (:func:`resource_summary`). A failed build raises;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("sector_sort.cu", "greedy_nms.cu", "select_points.cu", "knn.cu", "peer_gather.cu", "peer_proxy.cpp",
           "graph_if.cu")
#: Headers the sources include (hashed with them).
HEADERS = ("peer_link.h",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types; every one returns cudaError_t
# (the *_form queries, loam_knn_*_queries / _max_boxes, loam_peer_max_ranks /
# _segments and loam_peer_aborted return a number)
SIGNATURES = {
    "loam_sector_sort_form": (_I, _I, _I, _I),
    "loam_sector_sort_f64": (_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "loam_sector_sort_f32": (_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "loam_greedy_nms_form": (_I, _I, _I),
    "loam_greedy_nms": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "loam_select_points_f32": (_P, _P, _I, _I, _I, _P, _P),
    "loam_select_points_f64": (_P, _P, _I, _I, _I, _P, _P),
    "loam_knn_block_queries": (),
    "loam_knn_wide_block_queries": (),
    "loam_knn_max_boxes": (),
    "loam_knn": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                 _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "loam_knn_dual": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _I, _I, _F, _F, _I, _I,
                      _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # the mesh's gather and sum over peer memory (peer_gather.cu; ops/peer_cuda.py)
    "loam_peer_max_ranks": (),
    "loam_peer_max_segments": (),
    "loam_peer_create": (_I, _I, ctypes.c_double, ctypes.POINTER(_P)),
    "loam_peer_bus_id": (ctypes.c_char_p, _I),
    "loam_peer_can_reach": (ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(_I)),
    "loam_peer_flags_handle": (_P, ctypes.c_char_p),
    "loam_peer_routes": (_P, ctypes.POINTER(_I)),
    "loam_peer_mailbox": (_P, ctypes.c_longlong, ctypes.c_char_p),
    "loam_peer_open": (_P, ctypes.c_char_p, ctypes.POINTER(_I)),
    "loam_peer_proxy": (_P, ctypes.POINTER(_I)),
    "loam_peer_aborted": (_P, ctypes.c_char_p, _I),
    "loam_peer_close": (_P,),
    "loam_peer_free": (_P,),
    "loam_peer_run": (_P, ctypes.POINTER(ctypes.c_longlong), _I, _I, _I, ctypes.c_longlong, ctypes.c_longlong, _P),
    # CUDA-graph conditional nodes (graph_if.cu; program.when, while_loop, scan)
    "loam_stream_create": (ctypes.POINTER(_P),),
    "loam_if_begin": (_P, _P, _P),
    "loam_if_end": (_P, ctypes.POINTER(ctypes.c_size_t)),
    "loam_while_begin": (_P, _P, ctypes.POINTER(ctypes.c_ulonglong), _P),
    "loam_while_end": (_P, ctypes.c_ulonglong, _P, ctypes.POINTER(ctypes.c_size_t)),
    "loam_capture_nodes": (_P, ctypes.POINTER(ctypes.c_size_t)),
}

_lib = None
_extra_flags: tuple = ()
#: Seconds the last build in this process took (0.0 when loaded as built).
last_build_seconds = 0.0
#: What the compilers printed during that build (``ptxas -v`` included).
last_build_log = ""


def use_flags(*flags: str) -> None:
    """Build with extra ``nvcc`` flags (e.g. ``-DLOAM_KNN_QPT=2``) from now
    on: drops the loaded library, so the next use builds or loads the
    variant. For tuning scripts; the package itself never calls it."""
    global _lib, _extra_flags
    _extra_flags = tuple(flags)
    _lib = None


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
    h.update(" ".join(NVCC_FLAGS + _extra_flags).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"loam_kernels_{_source_hash()}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global last_build_seconds, last_build_log
    out = library_path()
    if out.exists():
        last_build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    flags = NVCC_FLAGS + _extra_flags
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        cmds = [[nvcc, *flags, "-c", "-o", o, str(CSRC / s)] for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        results = [p.communicate() + (p.returncode,) for p in procs]  # waits for every one
        lib_tmp = os.path.join(tmp, "lib.so")
        link = [nvcc, "-shared", "-o", lib_tmp, *objs, "-lpthread"]
        if all(rc == 0 for _, _, rc in results):
            done = subprocess.run(link, capture_output=True, text=True)
            cmds.append(link)
            results.append((done.stdout, done.stderr, done.returncode))
        log = "".join(so + se for so, se, _ in results)
        for cmd, (_, _, rc) in zip(cmds, results):
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
        os.replace(lib_tmp, out)  # atomic: a concurrent loader never sees a partial file
    last_build_seconds = time.perf_counter() - t0
    last_build_log = log
    return out


def resource_summary(log: str | None = None) -> str:
    """``ptxas -v``'s figures over every kernel of the last build: the range
    of registers a thread, the largest static shared memory, and the spill
    stores with the kernels that have any (0 means no kernel spills)."""
    log = last_build_log if log is None else log
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    smem = [int(x) for x in re.findall(r"(\d+) bytes smem", log)]
    if not regs:
        return "ptxas: no report (library loaded as built)"
    spilled = []
    for name, nbytes in re.findall(r"Function properties for (\S+)\s+\d+ bytes stack frame, "
                                   r"(\d+) bytes spill stores", log):
        if int(nbytes):
            short = re.search(r"[a-z_]+_kernel(?:ILi\d+E)?", name)
            spilled.append(f"{short.group(0) if short else name} {nbytes} B")
    return (f"ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{max(smem, default=0)} B shared memory at most, "
            f"spills: {', '.join(spilled) if spilled else 'none'}")


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


def launch(fn, what: str, t, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` with PyTorch's current
    stream on ``t``'s device, that device being the current one during the
    call, and raise if it returns a CUDA error. The device is switched only
    when it is not current already, and the stream's raw handle is read
    without building a ``Stream`` object: a kernel of a few microseconds is
    called from a loop that the host's time per call bounds."""
    index = t.device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


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
    if shape is not None and t.shape != shape and (
        t.ndim != len(shape)
        or any(s is not None and s != d for s, d in zip(shape, t.shape))
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
