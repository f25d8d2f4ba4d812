"""Packed 4-byte/point scan transport.

Counterpart of ``loam_tpu.io.packed``: a wire codec that ships a projected
range image as a (4, L, P) uint8 array per frame, a third of the bytes of its
float32 xyz grid:

  ==========  ====================================================
  plane 0     ``r_lo``  low byte of ``round(r / r_max * 65535)``
  plane 1     ``r_hi``  high byte (r_max = 131.07 m -> 2 mm steps)
  plane 2     ``az8``   azimuth offset within the 2*pi/P cell, 8 bits
  plane 3     ``el8``   elevation offset within the row cell, 8 bits
  ==========  ====================================================

The quantization error lies below LiDAR sensor noise: <= 1 mm in range,
<= 1.2e-5 rad in azimuth and <= 1.7e-5 rad in elevation (< 2 mm tangential
at 120 m). Empty cells are all-zero and decode to (0, 0, 0), the float path's
sentinel for an invalid cell.

The encoders are numpy and run on the host; :func:`decode_packed` is
elementwise tensor code that runs where the packed tensor lies, so a chunk
crosses to the GPU packed and is decoded there. The codec's elevation cell is
``(elev_hi - elev_lo) / (L - 1)``: it needs at least two scan lines, and every
entry point here raises ``ValueError`` for fewer (``loam_tpu`` divides by
zero there).
"""

from __future__ import annotations

import numpy as np
import torch

# Default range full-scale: 131.07 m / 65535 = exactly 2 mm per step, above
# any supported sensor's max range (Ouster: 120 m).
PACKED_R_MAX = 131.07

TWO_PI = 6.283185307179586


def _cell_height(elev_lo: float, elev_hi: float, L: int) -> float:
    if L < 2:
        raise ValueError(f"the packed codec needs at least 2 scan lines, got {L}")
    return (elev_hi - elev_lo) / (L - 1)


def decode_packed(packed: torch.Tensor, elev_lo: float = -0.30, elev_hi: float = 0.25,
                  r_max: float = PACKED_R_MAX) -> torch.Tensor:
    """Decode (..., 4, L, P) uint8 packed planes -> (..., L, P, 3) float32
    xyz (dequantizing to interval centers), on ``packed``'s device."""
    if packed.dtype != torch.uint8 or packed.ndim < 3 or packed.shape[-3] != 4:
        raise ValueError(f"decode_packed takes (..., 4, L, P) uint8 planes, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    L, P = packed.shape[-2], packed.shape[-1]
    cell_h = _cell_height(elev_lo, elev_hi, L)
    f32 = dict(dtype=torch.float32, device=packed.device)
    r_lo, r_hi, az8, el8 = (packed[..., i, :, :].to(torch.float32) for i in range(4))
    rq = r_lo + 256.0 * r_hi
    r = rq * (r_max / 65535.0)
    col = torch.arange(P, **f32)
    row = torch.arange(L, **f32)[:, None]
    az = (col + (az8 + 0.5) * (1.0 / 256.0)) * (TWO_PI / P)
    elev = elev_lo + row * cell_h + ((el8 + 0.5) * (1.0 / 256.0) - 0.5) * cell_h
    valid = rq > 0
    rxy = r * torch.cos(elev)
    zero = torch.zeros((), **f32)
    x = torch.where(valid, rxy * torch.cos(az), zero)
    y = torch.where(valid, rxy * torch.sin(az), zero)
    z = torch.where(valid, r * torch.sin(elev), zero)
    return torch.stack([x, y, z], dim=-1)


def project_packed_numpy(points: np.ndarray, scan_lines: int, points_per_line: int,
                         elev_lo: float = -0.30, elev_hi: float = 0.25,
                         r_max: float = PACKED_R_MAX) -> np.ndarray:
    """(N, 3) unordered cloud -> (4, L, P) uint8 packed planes; the nearest
    return wins a cell."""
    pts = np.ascontiguousarray(np.asarray(points)[:, :3], np.float32)
    L, P = scan_lines, points_per_line
    cell_h = _cell_height(elev_lo, elev_hi, L)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r2 = x * x + y * y + z * z
    keep = r2 > 1e-12
    elev = np.arctan2(z, np.hypot(x, y))
    az = np.arctan2(y, x)
    az = np.where(az < 0, az + TWO_PI, az)
    row = np.rint((elev - elev_lo) / (elev_hi - elev_lo) * (L - 1)).astype(int)
    col = np.minimum((az / TWO_PI * P).astype(int), P - 1)
    keep &= (row >= 0) & (row < L)
    out = np.zeros((4, L, P), np.uint8)
    if not keep.any():
        return out
    cell = (row * P + col)[keep]
    r = np.sqrt(r2[keep])
    az_k, elev_k, row_k, col_k = az[keep], elev[keep], row[keep], col[keep]
    # written in descending-range order, so the nearest return lands last
    order = np.argsort(r, kind="stable")[::-1]
    cell, r = cell[order], r[order]
    az_k, elev_k = az_k[order], elev_k[order]
    row_k, col_k = row_k[order], col_k[order]
    rq = np.clip(np.rint(r / r_max * 65535.0).astype(np.int64), 1, 65535)
    aq = np.clip(((az_k - col_k * (TWO_PI / P)) * P / TWO_PI * 256.0)
                 .astype(np.int64), 0, 255)
    eq = np.clip((((elev_k - (elev_lo + row_k * cell_h)) / cell_h + 0.5)
                  * 256.0).astype(np.int64), 0, 255)
    flat = out.reshape(4, -1)
    flat[0, cell] = (rq & 0xFF).astype(np.uint8)
    flat[1, cell] = (rq >> 8).astype(np.uint8)
    flat[2, cell] = aq.astype(np.uint8)
    flat[3, cell] = eq.astype(np.uint8)
    return out


def encode_packed_grid(scan: np.ndarray, elev_lo: float = -0.30, elev_hi: float = 0.25,
                       r_max: float = PACKED_R_MAX) -> np.ndarray:
    """Encode an already-projected (L, P, 3) grid to (4, L, P) packed planes.

    For feeding in-memory grids (synthetic scans, tests) through the packed
    path. Each non-empty cell is re-derived from its xyz, not from its grid
    position, so the decode error stays within the codec's quantization
    bounds even if a point's true angles disagree with its cell (the
    projection guarantees that they agree to within a cell).
    """
    grid = np.asarray(scan, np.float32)
    L, P, _ = grid.shape
    cell_h = _cell_height(elev_lo, elev_hi, L)
    pts = grid.reshape(-1, 3)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r = np.sqrt(x * x + y * y + z * z)
    valid = r > 1e-6
    elev = np.arctan2(z, np.hypot(x, y))
    az = np.arctan2(y, x)
    az = np.where(az < 0, az + TWO_PI, az)
    row = np.repeat(np.arange(L), P)
    col = np.tile(np.arange(P), L)
    out = np.zeros((4, L, P), np.uint8)
    flat = out.reshape(4, -1)
    rq = np.clip(np.rint(r / r_max * 65535.0).astype(np.int64), 1, 65535)
    aq = np.clip(((az - col * (TWO_PI / P)) * P / TWO_PI * 256.0)
                 .astype(np.int64), 0, 255)
    eq = np.clip((((elev - (elev_lo + row * cell_h)) / cell_h + 0.5) * 256.0)
                 .astype(np.int64), 0, 255)
    idx = np.nonzero(valid)[0]
    flat[0, idx] = (rq[idx] & 0xFF).astype(np.uint8)
    flat[1, idx] = (rq[idx] >> 8).astype(np.uint8)
    flat[2, idx] = aq[idx].astype(np.uint8)
    flat[3, idx] = eq[idx].astype(np.uint8)
    return out
