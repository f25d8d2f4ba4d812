"""ctypes bindings for the native IO runtime (``io/native/loam_io.cpp``).

A JAX-free copy of ``loam_tpu.io.native``. The shared library builds on first
use (plain ``c++ -O3 -shared``; no build system needed) next to this
package's copy of the source, so ``loam_tpu`` and this port never share a
library. Every function has a NumPy fallback, so the package works without a
toolchain: this is host file IO, not a device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_SRC = os.path.join(_DIR, "loam_io.cpp")
_LIB = os.path.join(_DIR, "libloam_io.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(
                _SRC
            ):
                # build under a private name, then rename: processes that
                # build at once never load a half-written library
                tmp = f"{_LIB}.{os.getpid()}.tmp"
                cxx = os.environ.get("CXX", "c++")
                subprocess.run(
                    [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC,
                     "-lpthread"],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _LIB)
            lib = ctypes.CDLL(_LIB)
            lib.loam_read_kitti_bin.restype = ctypes.c_int
            lib.loam_read_pcd.restype = ctypes.c_int
            lib.loam_loader_create.restype = ctypes.c_void_p
            lib.loam_loader_create_ex.restype = ctypes.c_void_p
            lib.loam_loader_next.restype = ctypes.c_int
            lib.loam_loader_next_raw.restype = ctypes.c_int
            _lib = lib
        except Exception:
            _build_failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def read_kitti_bin(path: str, max_points: int = 1 << 21) -> np.ndarray:
    """Read a KITTI velodyne ``.bin`` (float32 x,y,z,intensity records) ->
    (N, 3) float32."""
    lib = _load()
    if lib is not None:
        out = np.empty((max_points, 3), np.float32)
        n = lib.loam_read_kitti_bin(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_points,
        )
        if n < 0:
            raise IOError(f"failed to read {path}")
        return out[:n].copy()
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return raw[:max_points, :3].copy()


def write_pcd(path: str, points: np.ndarray) -> None:
    """Write (N, 3) points as an uncompressed binary PCD (e.g. map export
    for the tuning viewer or any PCL-compatible tool)."""
    pts = np.ascontiguousarray(np.asarray(points)[:, :3], np.float32)
    lib = _load()
    if lib is not None:
        rc = lib.loam_write_pcd(
            path.encode(), pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(pts),
        )
        if rc != 0:
            raise IOError(f"failed to write {path}")
        return
    with open(path, "wb") as f:
        hdr = (
            "VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {len(pts)}\nDATA binary\n"
        )
        f.write(hdr.encode())
        f.write(pts.tobytes())


def read_pcd(path: str, max_points: int = 1 << 21) -> np.ndarray:
    """Read a PCD file (ascii or uncompressed binary) -> (N, 3) float32."""
    lib = _load()
    if lib is not None:
        out = np.empty((max_points, 3), np.float32)
        n = lib.loam_read_pcd(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_points,
        )
        if n < 0:
            raise IOError(f"failed to parse {path}")
        return out[:n].copy()
    return _read_pcd_numpy(path, max_points)


def _read_pcd_numpy(path: str, max_points: int) -> np.ndarray:
    fields, sizes, counts, n_pts, binary = [], [], [], 0, False
    with open(path, "rb") as f:
        while True:
            line = f.readline().decode("latin1")
            if not line:
                raise IOError(f"no DATA section in {path}")
            t = line.split()
            if not t:
                continue
            if t[0] == "FIELDS":
                fields = t[1:]
            elif t[0] == "SIZE":
                sizes = [int(x) for x in t[1:]]
            elif t[0] == "COUNT":
                counts = [int(x) for x in t[1:]]
            elif t[0] == "POINTS":
                n_pts = int(t[1])
            elif t[0] == "DATA":
                binary = t[1] == "binary"
                break
        if not counts:
            counts = [1] * len(fields)
        idx = {n: i for i, n in enumerate(fields)}
        if binary:
            dt = np.dtype(
                {
                    "names": [f"f{i}" for i in range(len(fields))],
                    "formats": [
                        f"({c},)f{s}" if c > 1 else f"f{s}"
                        for s, c in zip(sizes, counts)
                    ],
                }
            )
            rec = np.frombuffer(f.read(dt.itemsize * n_pts), dtype=dt, count=n_pts)
            pts = np.stack(
                [rec[f"f{idx['x']}"], rec[f"f{idx['y']}"], rec[f"f{idx['z']}"]],
                axis=-1,
            ).astype(np.float32)
        else:
            rows = np.loadtxt(f, dtype=np.float64, max_rows=n_pts)
            rows = np.atleast_2d(rows)
            pts = rows[:, [idx["x"], idx["y"], idx["z"]]].astype(np.float32)
    return pts[:max_points]


def project_range_image(
    points: np.ndarray,
    scan_lines: int,
    points_per_line: int,
    elev_lo: float = -0.30,
    elev_hi: float = 0.25,
) -> np.ndarray:
    """Project an unordered (N, 3) cloud into the (L, P, 3) row-major
    range-image layout the extractor consumes (nearest return per cell;
    empty cells are zeros => range 0, invalidated by the range gate)."""
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    lib = _load()
    out = np.zeros((scan_lines, points_per_line, 3), np.float32)
    if lib is not None:
        lib.loam_project_range_image(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(pts),
            scan_lines,
            points_per_line,
            ctypes.c_float(elev_lo),
            ctypes.c_float(elev_hi),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out
    # NumPy fallback (same semantics)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r2 = x * x + y * y + z * z
    keep = r2 > 1e-12
    elev = np.arctan2(z, np.hypot(x, y))
    az = np.mod(np.arctan2(y, x), 2 * np.pi)
    row = np.rint((elev - elev_lo) / (elev_hi - elev_lo) * (scan_lines - 1)).astype(
        int
    )
    col = np.minimum((az / (2 * np.pi) * points_per_line).astype(int),
                     points_per_line - 1)
    keep &= (row >= 0) & (row < scan_lines)
    cell = row * points_per_line + col
    order = np.argsort(r2[keep], kind="stable")[::-1]  # nearest written last
    flat = out.reshape(-1, 3)
    flat[cell[keep][order]] = pts[keep][order]
    return out


class ScanLoader:
    """Prefetching scan loader over a list of .bin / .pcd files.

    Iterates range-image scans in file order; native worker threads read +
    project ahead of the consumer. Falls back to synchronous NumPy loading
    without the native library.

    ``packed=False`` (default): yields (L, P, 3) float32 xyz grids.
    ``packed=True``: yields (4, L, P) uint8 packed planes (the 4-byte/point
    wire format of ``io.packed`` — 3x fewer host->device bytes; decode on
    the device with ``decode_packed``); it needs at least two scan lines and
    raises ``ValueError`` for fewer, as the packed codec does.
    """

    def __init__(
        self,
        paths: Sequence[str],
        scan_lines: int,
        points_per_line: int,
        elev_lo: float = -0.30,
        elev_hi: float = 0.25,
        max_raw_points: int = 1 << 21,
        n_threads: int = 2,
        queue_cap: int = 4,
        packed: bool = False,
        r_max: Optional[float] = None,
    ):
        from .packed import PACKED_R_MAX, _cell_height

        if packed:
            _cell_height(elev_lo, elev_hi, scan_lines)  # the codec's L >= 2 guard
        self.paths: List[str] = list(paths)
        self.packed = packed
        self.r_max = PACKED_R_MAX if r_max is None else float(r_max)
        self.shape = (
            (4, scan_lines, points_per_line)
            if packed
            else (scan_lines, points_per_line, 3)
        )
        self._args = (scan_lines, points_per_line, elev_lo, elev_hi, max_raw_points)
        self._handle = None
        lib = _load()
        if lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            self._keepalive = arr
            self._handle = lib.loam_loader_create_ex(
                arr,
                len(self.paths),
                scan_lines,
                points_per_line,
                ctypes.c_float(elev_lo),
                ctypes.c_float(elev_hi),
                max_raw_points,
                n_threads,
                queue_cap,
                1 if packed else 0,
                ctypes.c_float(self.r_max),
            )
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        lib = _load()
        if self._handle is not None and lib is not None:
            dt = np.uint8 if self.packed else np.float32
            out = np.empty(self.shape, dt)
            idx = lib.loam_loader_next_raw(
                ctypes.c_void_p(self._handle),
                out.ctypes.data_as(ctypes.c_void_p),
            )
            if idx < 0:
                raise StopIteration
            return out
        if self._pos >= len(self.paths):
            raise StopIteration
        p = self.paths[self._pos]
        self._pos += 1
        pts = read_pcd(p) if p.endswith(".pcd") else read_kitti_bin(p)
        L, P = self._args[0], self._args[1]
        if self.packed:
            from .packed import project_packed_numpy

            return project_packed_numpy(
                pts, L, P, *self._args[2:4], r_max=self.r_max
            )
        return project_range_image(pts, L, P, *self._args[2:4])

    def close(self):
        lib = _load()
        if self._handle is not None and lib is not None:
            lib.loam_loader_destroy(ctypes.c_void_p(self._handle))
            self._handle = None

    def __del__(self):  # pragma: no cover - destructor timing
        try:
            self.close()
        except Exception:
            pass
