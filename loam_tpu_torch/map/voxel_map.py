"""Fixed-capacity voxel-downsampled point map.

Counterpart of ``loam_tpu.map.voxel_map``: the map is a padded (capacity, 3)
buffer and a validity mask. Insertion voxel-downsamples the union of the
stored and the incoming points to at most one point per voxel -- stored
points win their voxel (first of its run after a stable sort by voxel key),
so re-observation does not move them -- and then evicts points farther than
a radius from the sensor. Occupied voxels beyond the capacity (those with
the largest keys) are dropped and counted, never silently.

``loam_tpu`` has three insert implementations with identical contents
(``sort2``, ``scatter``, ``bitonic``); here there is one, on a stable
``torch.sort`` (the stability replaces their (key, slot) two-key sort).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import place, resolve
from ..geometry import norm
from ..ops.morton import morton_key

_INT32_MAX = torch.iinfo(torch.int32).max


class VoxelMap(NamedTuple):
    """Padded voxel map.

    Attributes:
      points: (C, 3) stored points (zeros in invalid slots), in voxel-key
        (Morton) order.
      mask: (C,) slot validity; the valid slots are a prefix.
      voxel_size: scalar tensor, the downsampling voxel edge length.
      origin: (3,) fixed grid origin of the voxel keys.
    """

    points: torch.Tensor
    mask: torch.Tensor
    voxel_size: torch.Tensor
    origin: torch.Tensor

    @property
    def size(self) -> torch.Tensor:
        return torch.sum(self.mask, dtype=torch.int32)

    @staticmethod
    def from_numpy(m, device=None) -> "VoxelMap":
        """VoxelMap from any four-field map of array-likes, e.g. a
        ``loam_tpu.VoxelMap`` (leaves go through ``np.asarray``; dtypes
        kept), on the card unless ``device`` says otherwise (``device.py``)."""
        return VoxelMap(
            place(m.points, device),
            place(np.asarray(m.mask).astype(bool), device),
            place(m.voxel_size, device),
            place(m.origin, device),
        )


def voxel_map_empty(capacity: int, voxel_size: float, origin=(0.0, 0.0, 0.0),
                    dtype=torch.float32, device=None) -> VoxelMap:
    """An empty map, on the card unless ``device`` says otherwise
    (``device.py``). The addressable span around ``origin`` is
    ``GRID_CELLS * voxel_size`` (e.g. 1024 * 0.5 m). Made with fills only
    (no copy from the host), so a program's capture can make it."""
    device = resolve(device)
    full = lambda v: torch.full((), float(v), dtype=dtype, device=device)
    return VoxelMap(
        points=torch.zeros((capacity, 3), dtype=dtype, device=device),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        voxel_size=full(voxel_size),
        origin=torch.stack([full(o) for o in origin]),
    )


def _voxel_key(map_: VoxelMap, pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Morton key of each point's voxel in ``map_``'s grid, int32 max where
    not ``valid`` (``loam_tpu``'s ``_voxel_key``; the sharded map's owner of
    a voxel is this key mod the shard count)."""
    return torch.where(valid, morton_key(pts, map_.voxel_size, map_.origin),
                       torch.full_like(valid, _INT32_MAX, dtype=torch.int32))


def voxel_map_insert(
    map_: VoxelMap,
    new_points: torch.Tensor,
    new_mask: torch.Tensor,
    center: Optional[torch.Tensor] = None,
    keep_radius: float = 0.0,
    impl: str = "auto",
) -> Tuple[VoxelMap, torch.Tensor]:
    """Insert points, voxel-downsample, optionally evict far points.

    Args:
      new_points: (N, 3) candidate points (e.g. features moved to the world
        frame); ``new_mask`` their validity.
      center: with ``keep_radius > 0``, points farther than ``keep_radius``
        from ``center`` (the sensor position) are evicted.
      impl: accepted for API compatibility with ``loam_tpu``; every value
        gives the same contents there, and there is one implementation here.

    Returns: (new_map, dropped) -- ``dropped`` (int32 scalar) counts the
      occupied voxels that did not fit in the capacity.
    """
    C = map_.points.shape[0]
    pts = torch.cat([map_.points, new_points.to(map_.points.dtype)])
    valid = torch.cat([map_.mask, new_mask.to(torch.bool)])
    if center is not None and keep_radius > 0:
        valid = valid & (norm(pts - center) <= keep_radius)

    keys = _voxel_key(map_, pts, valid)
    # stable: equal keys keep buffer order, so stored points (first in the
    # concatenation) win their voxel
    skeys, order = torch.sort(keys, stable=True)
    spts = pts[order]
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    first = first & (skeys != _INT32_MAX)
    dest = torch.cumsum(first, dim=0, dtype=torch.int32) - 1
    total = torch.sum(first, dtype=torch.int32)
    dropped = torch.clamp(total - C, min=0)
    # run heads in key order land in slots 0..C-1; everything else in a
    # spare row C that is cut off
    write_to = torch.where(first & (dest < C), dest, C).long()
    out = torch.zeros((C + 1, 3), dtype=pts.dtype, device=pts.device)
    out[write_to] = spts
    out_mask = torch.arange(C, device=pts.device) < torch.clamp(total, max=C)
    out_pts = torch.where(out_mask[:, None], out[:C], torch.zeros_like(out[:C]))
    return VoxelMap(out_pts, out_mask, map_.voxel_size, map_.origin), dropped
