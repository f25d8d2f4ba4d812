"""Batched feature association: source features -> target line/plane fits.

Counterpart of ``loam_tpu.registration.associate`` (reference
``registration.cpp:23-103``): every transformed source feature is matched to
its k nearest target features (radius-filtered) and, when enough neighbors
survive, a line or plane is fit to them. The reference's guards keep their
effective semantics (SURVEY 2.3(1,2)): the line condition-number guard is
dead code in the reference and stays off unless
``params.enforce_line_condition``; the plane guard compares the signed mean
residual, identically 0 for the PCA fit, so it never fires.

Two input paths: a :class:`~loam_tpu_torch.ops.knn_cuda.PackedKnn` from the
kNN kernel (fits straight from its (k, N) coordinate planes), or a
``KnnResult`` (or none, then :func:`~loam_tpu_torch.neighbors.knn` runs) with
the neighbors gathered from the target set into the same (k, N) planes. Both
paths then fit with the same arithmetic (``geometry.fit_*_packed``), so the
same neighbours give bit-equal fits whichever search found them (``loam_tpu``
fits gathered neighbours with its matrix-form ``fit_line``/``fit_plane``,
which round differently). Leading batch axes are allowed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import fit_line_packed, fit_plane_packed
from ..neighbors import knn
from ..params import RegistrationParams


class EdgeAssociations(NamedTuple):
    """Per-source-edge-slot results: two points on the fitted line
    (placeholders where not ``valid``) and the nearest target index (-1 when
    invalid)."""

    line_a: torch.Tensor
    line_b: torch.Tensor
    valid: torch.Tensor
    match: torch.Tensor


class PlaneAssociations(NamedTuple):
    """Per-source-planar-slot results."""

    normal: torch.Tensor
    d: torch.Tensor
    valid: torch.Tensor
    match: torch.Tensor


def _neighbor_planes(res, target_pts, neighbor_pts=None):
    """(xs, ys, zs, mask, first) of a search result in the packed (..., k, N)
    layout: a ``PackedKnn`` as it is, a ``KnnResult``'s neighbours gathered
    from ``target_pts`` (..., M, 3) by index, or taken from
    ``neighbor_pts`` (..., N, k, 3) where given. The planes are contiguous
    like the kernel's, so the fits' reductions over k run the same way on
    any of them."""
    if hasattr(res, "xs"):  # PackedKnn
        return res.xs, res.ys, res.zs, res.mask, res.first_idx
    mask = res.mask.transpose(-1, -2).contiguous()
    if neighbor_pts is not None:
        planes = neighbor_pts.movedim(-1, 0).transpose(-1, -2)  # (3, ..., k, N)
        return (*(p.contiguous() for p in planes), mask, res.indices[..., 0])
    idx = res.indices.transpose(-1, -2)  # (..., k, N)
    flat = idx.reshape(idx.shape[:-2] + (-1,)).long()
    xs, ys, zs = (torch.gather(target_pts[..., a], -1, flat).reshape(idx.shape) for a in range(3))
    return xs, ys, zs, mask, res.indices[..., 0]


_CONSTS: dict = {}


def _const(values, like: torch.Tensor) -> torch.Tensor:
    """``values`` as a tensor of ``like``'s dtype and device, made once: a
    CUDA graph cannot copy from the host while it captures (the ICF loop's
    warm-up makes them before)."""
    key = (values, like.dtype, like.device)
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(values, dtype=like.dtype, device=like.device)
    return _CONSTS[key]


def associate_edges(query_pts, query_mask, target_pts, target_mask,
                    params: RegistrationParams, knn_result=None,
                    neighbor_pts=None) -> EdgeAssociations:
    """Edge association (reference ``associateEdges``, ``registration.cpp:23-62``).

    Args:
      query_pts: (..., E, 3) source edges already moved by the estimate.
      query_mask: (..., E) validity of source slots.
      target_pts / target_mask: (..., M, 3) / (..., M) target edge set.
      knn_result: a ``PackedKnn`` or ``KnnResult`` for these queries, or
        None to search here.
      neighbor_pts: optional (..., E, k, 3) coordinates of the result's
        neighbours, gathered beforehand (where ``target_pts`` is not at
        hand, as for sharded targets), used instead of
        ``target_pts[indices]``; ignored for a ``PackedKnn``, which carries
        its own.
    """
    res = knn_result
    if res is None:
        res = knn(query_pts, target_pts, target_mask,
                  k=params.num_edge_neighbors, max_dist=params.max_edge_neighbor_dist)
    xs, ys, zs, mask, first = _neighbor_planes(res, target_pts, neighbor_pts)
    count = torch.sum(mask.to(torch.int32), dim=-2)
    a, b, cond = fit_line_packed(xs, ys, zs, mask)
    enough = count >= params.min_line_fit_points
    # degenerate fits may be non-finite; such slots must never contribute
    finite = torch.isfinite(a).all(-1) & torch.isfinite(b).all(-1)
    valid = query_mask & enough & finite
    if params.enforce_line_condition:
        valid = valid & (cond >= params.min_line_condition_number)
    match = torch.where(valid, first, -1).to(torch.int32)
    a = torch.where(valid[..., None], a, _const((0.0, 0.0, 0.1), a))
    b = torch.where(valid[..., None], b, _const((0.0, 0.0, -0.1), b))
    return EdgeAssociations(a, b, valid, match)


def associate_planes(query_pts, query_mask, target_pts, target_mask,
                     params: RegistrationParams, knn_result=None,
                     neighbor_pts=None) -> PlaneAssociations:
    """Plane association (reference ``associatePlanes``, ``registration.cpp:65-103``);
    arguments as :func:`associate_edges`."""
    res = knn_result
    if res is None:
        res = knn(query_pts, target_pts, target_mask,
                  k=params.num_plane_neighbors, max_dist=params.max_plane_neighbor_dist)
    xs, ys, zs, mask, first = _neighbor_planes(res, target_pts, neighbor_pts)
    count = torch.sum(mask.to(torch.int32), dim=-2)
    normal, d, avg_dist = fit_plane_packed(xs, ys, zs, mask)
    enough = count >= params.min_plane_fit_points
    # a nan avg_dist would slip through ~(x > t): reject non-finite fits
    finite = torch.isfinite(normal).all(-1) & torch.isfinite(d) & torch.isfinite(avg_dist)
    valid = query_mask & enough & finite & ~(avg_dist > params.max_avg_point_plane_dist)
    match = torch.where(valid, first, -1).to(torch.int32)
    normal = torch.where(valid[..., None], normal, _const((0.0, 0.0, 1.0), normal))
    d = torch.where(valid, d, torch.zeros_like(d))
    return PlaneAssociations(normal, d, valid, match)
