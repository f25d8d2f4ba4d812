"""Voxel-grid kNN for map-scale target sets.

Counterpart of ``loam_tpu.neighbors.grid``: the target points are binned into
a uniform grid with a cell size of at least the search radius and sorted by
their linear cell key; a query is answered by looking up the 27 cells around
its own with two binary searches per (query, cell), taking up to
``max_per_cell`` candidates from each, and keeping the k nearest. Keys are
exact linearised coordinates, so there are no hash collisions.

Exactness: with ``cell_size >= max_dist`` every neighbor within the radius
lies in those 27 cells, so the result equals the brute-force search as long as
no looked-up cell holds more than ``max_per_cell`` points. Candidates beyond
the cap are left out, and every (query, cell) lookup that hit it is counted in
the ``overflow`` that :func:`knn_grid` returns beside its result: the caller
records it, it is never dropped.

Plain tensor code with no kernel of its own (``loam_tpu``'s has none either):
it runs where its tensors lie. Distances are direct coordinate differences.
Every function takes leading batch axes: one grid per pair of a batch.
Nothing here reads or copies from the host (the tile loop is over shapes,
the scalars are kernel arguments), so a registration program captures the
grid's build and its searches into its CUDA graph, the searches inside the
ICF loop's WHILE node, as ``loam_tpu`` jits them into its registration.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .bruteforce import KnnResult, topk_min

# cells per axis: keys fit int32 (K^3 = 2^30); at a 1 m cell this spans ~1 km
_K = 1024


class GridIndex(NamedTuple):
    """Sorted voxel-grid index over a padded point set.

    Attributes:
      points_sorted: (..., M, 3) points permuted to cell-key order.
      keys_sorted: (..., M) int32 linear cell key of each sorted point (the
        sentinel ``_K**3`` for invalid points, which sort last).
      perm: (..., M) int32 original index of each sorted slot.
      origin: (..., 3) grid origin (min corner).
      cell_size: float.
    """

    points_sorted: torch.Tensor
    keys_sorted: torch.Tensor
    perm: torch.Tensor
    origin: torch.Tensor
    cell_size: float


def _cell_coords(points: torch.Tensor, origin: torch.Tensor, cell_size: float) -> torch.Tensor:
    # clamped as floats: a conversion of an out-of-range float to int32 is
    # not defined (an all-masked target puts the origin at the largest float)
    c = torch.floor((points - origin[..., None, :]) / cell_size)
    return c.clamp(0, _K - 1).to(torch.int32)


def _linear_key(coords: torch.Tensor) -> torch.Tensor:
    return (coords[..., 0] * _K + coords[..., 1]) * _K + coords[..., 2]


def build_grid(points: torch.Tensor, mask: torch.Tensor, cell_size: float) -> GridIndex:
    """Build a GridIndex over padded ``points`` (..., M, 3) with validity
    ``mask`` (..., M)."""
    if points.shape[-2] == 0:
        raise ValueError("build_grid requires a target set with at least one slot")
    cell_size = float(cell_size)
    big = torch.finfo(points.dtype).max
    origin = torch.where(mask[..., None], points, big).amin(-2) - 0.5 * cell_size
    keys = _linear_key(_cell_coords(points, origin, cell_size))
    keys = torch.where(mask, keys, _K**3)
    keys_sorted, perm = torch.sort(keys, dim=-1, stable=True)
    points_sorted = torch.gather(points, -2, perm[..., None].expand(points.shape))
    return GridIndex(points_sorted, keys_sorted, perm.to(torch.int32), origin, cell_size)


def _offsets(device) -> torch.Tensor:
    """(27, 3) int32 cell offsets of a neighborhood, x slowest."""
    r = torch.arange(-1, 2, dtype=torch.int32, device=device)
    return torch.cartesian_prod(r, r, r)


def _gather_flat(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``values`` (..., M) at ``index`` (..., Q, C) int64 -> (..., Q, C)."""
    flat = index.reshape(index.shape[:-2] + (-1,))
    return torch.gather(values, -1, flat).reshape(index.shape)


def _tile_knn_grid(index: GridIndex, queries: torch.Tensor, k: int, max_dist: float,
                   C: int) -> Tuple[KnnResult, torch.Tensor]:
    """Grid kNN for one tile of queries (..., Q, 3)."""
    keys = index.keys_sorted
    M = keys.shape[-1]
    batch, Q = queries.shape[:-2], queries.shape[-2]

    qc = _cell_coords(queries, index.origin, index.cell_size)  # (..., Q, 3)
    # (..., Q, 27) linear keys of the neighborhood. Clamping at the grid's
    # border can give one cell twice; the repeats must be masked out, or their
    # candidates crowd genuine neighbors out of the top k.
    nbr = (qc[..., None, :] + _offsets(queries.device)).clamp(0, _K - 1)
    nbr_keys = _linear_key(nbr)
    dup = torch.tril(nbr_keys[..., :, None] == nbr_keys[..., None, :], diagonal=-1).any(-1)

    flat_keys = nbr_keys.reshape(batch + (Q * 27,))
    start = torch.searchsorted(keys, flat_keys, side="left").reshape(nbr_keys.shape)
    end = torch.searchsorted(keys, flat_keys, side="right").reshape(nbr_keys.shape)
    count = torch.where(dup, 0, end - start)
    overflow = (count > C).sum((-1, -2)).to(torch.int32)

    slots = torch.arange(C, device=queries.device)
    cand = start[..., None] + slots  # (..., Q, 27, C) positions in the sorted arrays
    cand_valid = slots < count.clamp(max=C)[..., None]
    cand = cand.clamp(max=M - 1).reshape(batch + (Q, 27 * C))
    cand_valid = cand_valid.reshape(cand.shape)

    pts = index.points_sorted
    dx = _gather_flat(pts[..., 0], cand) - queries[..., 0:1]
    dy = _gather_flat(pts[..., 1], cand) - queries[..., 1:2]
    dz = _gather_flat(pts[..., 2], cand) - queries[..., 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    d2 = torch.where(cand_valid, d2, float("inf"))

    d2k, pos = topk_min(d2, k)
    dist = torch.sqrt(torch.clamp(d2k, min=0.0))
    valid = torch.isfinite(d2k) & (dist < max_dist)
    sorted_idx = torch.gather(cand, -1, pos.long())
    orig_idx = _gather_flat(index.perm, sorted_idx)
    return KnnResult(orig_idx, torch.where(valid, dist, float("inf")), valid), overflow


def knn_grid(index: GridIndex, queries: torch.Tensor, k: int, max_dist: float,
             max_per_cell: int = 32, tile: int = 4096) -> Tuple[KnnResult, torch.Tensor]:
    """The k nearest targets within ``max_dist`` of each query (..., Q, 3),
    through the grid.

    Needs ``max_dist > 0`` and a grid built with ``cell_size >= max_dist``.
    Queries go in tiles of ``tile``, which bounds the (tile, 27 *
    max_per_cell) candidate buffers. Indices are into the unsorted target
    set; entries where ``mask`` is False are arbitrary in-bounds values.

    Returns (KnnResult (..., Q, k), overflow (...) int32): ``overflow`` counts
    the (query, cell) lookups whose cell held more than ``max_per_cell``
    points; nonzero means that neighbors may have been missed. With more than
    one tile the last is filled up with queries at the origin, as
    ``loam_tpu`` fills it, and their lookups count too.
    """
    if max_dist <= 0:
        raise ValueError("knn_grid requires a positive search radius")
    Q = queries.shape[-2]
    if Q <= tile:
        return _tile_knn_grid(index, queries, k, max_dist, max_per_cell)
    n_tiles = -(-Q // tile)
    padded = torch.nn.functional.pad(queries, (0, 0, 0, n_tiles * tile - Q))
    parts = [_tile_knn_grid(index, padded[..., lo : lo + tile, :], k, max_dist, max_per_cell)
             for lo in range(0, n_tiles * tile, tile)]
    res = KnnResult(*(torch.cat([getattr(r, f) for r, _ in parts], dim=-2)[..., :Q, :]
                      for f in KnnResult._fields))
    return res, torch.stack([o for _, o in parts]).sum(0).to(torch.int32)
