"""Morton (Z-order) keys for spatially coherent storage and tiling.

Counterpart of ``loam_tpu.ops.morton``: a contiguous run of Morton-ordered
cells is a compact 3-D blob, so sorting points by Morton key gives every
contiguous block of them a small bounding box. Keys are 30-bit (10 bits per
axis, 1024 cells per axis) int32, index-exact against ``loam_tpu``.
"""

from __future__ import annotations

import torch

# cells per axis (2^10; 3 x 10 bits = 30-bit keys fit int32)
GRID_CELLS = 1024


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` (int32) to every 3rd bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_key_cells(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor) -> torch.Tensor:
    """Interleave three 10-bit cell coordinates into a 30-bit Morton key."""
    return ((_part1by2(cx) << 2) | (_part1by2(cy) << 1) | _part1by2(cz)).to(torch.int32)


def morton_key(points: torch.Tensor, cell_size, origin=None) -> torch.Tensor:
    """Morton key of each point (..., 3) on a ``cell_size`` grid centred on
    ``origin`` (default 0) and spanning ``GRID_CELLS * cell_size``;
    out-of-span coordinates clamp to the border cell.

    The cell is ``floor((p + half_span) / cell_size)`` in the points' dtype,
    with a true division (a reciprocal multiply rounds differently). It is
    clamped in floating point, before the integer cast, which keeps the
    cast defined far outside the span and gives every cell ``loam_tpu``'s
    cast-then-clip gives.
    """
    if origin is not None:
        points = points - origin
    half_span = 0.5 * GRID_CELLS * cell_size
    c = torch.floor((points + half_span) / cell_size)
    c = torch.clamp(c, 0.0, float(GRID_CELLS - 1)).to(torch.int32)
    return morton_key_cells(c[..., 0], c[..., 1], c[..., 2])
