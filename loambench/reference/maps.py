"""A voxel map, plain PyTorch: at most one point a voxel, the stored point
keeping its voxel and, among new points of one voxel, the first in the
order they are handed over; points beyond ``keep_radius`` of the sensor
evicted; occupied voxels past the capacity dropped and counted."""

from __future__ import annotations

import torch

#: Cells per axis of a voxel key (the keys cover +- 512 voxels around the
#: map's origin, as the port's 10-bit Morton keys do).
CELLS = 1024


def cells(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """(N, 3) int64 voxel cells of world points, origin at 0, clamped to the
    key's span."""
    c = torch.floor((points.to(torch.float64) + 0.5 * CELLS * voxel) / voxel)
    return torch.clamp(c, 0, CELLS - 1).to(torch.int64)


def keys(points: torch.Tensor, voxel: float) -> torch.Tensor:
    c = cells(points, voxel)
    return (c[:, 0] * CELLS + c[:, 1]) * CELLS + c[:, 2]


def spread(x: torch.Tensor) -> torch.Tensor:
    """The low 10 bits of ``x`` spread to every third bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton(points: torch.Tensor, cell: float) -> torch.Tensor:
    """Z-order key of each point's ``cell``-sized cell (x the high bit of
    each triple), the order in which scan-to-map hands a frame's features
    to its map."""
    c = cells(points, cell)
    return (spread(c[:, 0]) << 2) | (spread(c[:, 1]) << 1) | spread(c[:, 2])


def insert(points, mask, new_points, new_mask, voxel: float, capacity: int, center, keep_radius: float):
    """The map (points (C, 3), mask (C,)) with ``new_points`` inserted.
    Returns (points, mask, dropped): the kept points first."""
    pts = torch.cat([points, new_points.to(points.dtype)])
    valid = torch.cat([mask, new_mask])
    if keep_radius > 0:
        valid = valid & (torch.linalg.vector_norm(pts.to(torch.float64) - center, dim=-1) <= keep_radius)
    pts, k = pts[valid], keys(pts[valid], voxel)
    sk, order = torch.sort(k, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    kept = pts[order[first]]
    dropped = max(0, kept.shape[0] - capacity)
    kept = kept[:capacity]
    out = torch.zeros((capacity, 3), dtype=points.dtype, device=points.device)
    out[:kept.shape[0]] = kept
    out_mask = torch.arange(capacity, device=points.device) < kept.shape[0]
    return out, out_mask, dropped
