"""Exact brute-force kNN with the reference's radius semantics.

Counterpart of ``loam_tpu.neighbors.bruteforce``: the k nearest targets,
distance-ascending with first-index ties, entries at or beyond ``max_dist``
masked out (strict ``<``, reference ``kdtree.cpp:24-26``), invalid targets
never returned. Distances are direct coordinate differences, never the
``|q|^2 + |t|^2 - 2 q.t`` expansion, which cancels at long range.
``knn_oracle`` is the NumPy reference both are held to.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class KnnResult(NamedTuple):
    """k-nearest-neighbor output.

    Attributes:
      indices: (..., Q, k) int32 target indices, distance-ascending. Entries
        where ``mask`` is False are arbitrary in-bounds values.
      distances: (..., Q, k) Euclidean distances (inf where invalid).
      mask: (..., Q, k) bool -- True where a real neighbor within the radius
        fills the slot.
    """

    indices: torch.Tensor
    distances: torch.Tensor
    mask: torch.Tensor


def topk_min(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k smallest along the last axis: (values, int32 indices),
    ascending, first-index ties (``torch.argmin`` returns the first
    minimum; ``torch.topk`` promises no tie order)."""
    shape = d2.shape[:-1] + (k,)
    if k == 0 or d2.shape[-1] == 0:
        return (
            torch.full(shape, float("inf"), dtype=d2.dtype, device=d2.device),
            torch.zeros(shape, dtype=torch.int32, device=d2.device),
        )
    d2 = d2.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmin(d2, dim=-1, keepdim=True)
        vals.append(torch.gather(d2, -1, i))
        idxs.append(i)
        d2.scatter_(-1, i, float("inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1).to(torch.int32)


def pairwise_d2(queries: torch.Tensor, tx, ty, tz) -> torch.Tensor:
    """(..., Q, M) squared distances ``(dx*dx + dy*dy) + dz*dz`` with
    ``dx = t - q`` per coordinate; ``tx/ty/tz`` are (..., M). Computed in
    place in two (..., Q, M) buffers, with the same rounding steps."""
    d2 = tx[..., None, :] - queries[..., :, 0, None]
    d2.mul_(d2)
    t = ty[..., None, :] - queries[..., :, 1, None]
    d2.add_(t.mul_(t))
    torch.sub(tz[..., None, :], queries[..., :, 2, None], out=t)
    return d2.add_(t.mul_(t))


def knn(
    queries: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    k: int,
    max_dist: float = 0.0,
    tile: int = 2048,
) -> KnnResult:
    """Exact k-nearest-neighbor search.

    On CUDA tensors this goes through ``ops.knn_cuda.knn_run``: the kNN
    kernel for float32, any ``k`` (as ``loam_tpu`` dispatches float32 to its
    Pallas kernel on a TPU), the plain search on the card for float64. On
    CPU tensors it is the plain search below, queries in tiles of ``tile``.

    Args:
      queries: (Q, 3); targets: (M, 3); target_mask: (M,) bool.
      k: neighbors per query; max_dist: radius filter (<= 0 disables).
    Returns: KnnResult with (Q, k) leaves.
    """
    if queries.is_cuda:
        from ..ops.knn_cuda import knn_prep, knn_run

        return knn_run(knn_prep(targets, target_mask), queries, k, max_dist)
    M = targets.shape[0]
    inf_row = torch.where(
        target_mask, 0.0, float("inf")
    ).to(queries.dtype)
    kk = min(k, M)  # fewer targets than k: fewer entries (SURVEY 2.3(7))
    vals, idxs = [], []
    for lo in range(0, queries.shape[0], tile):
        d2 = pairwise_d2(queries[lo : lo + tile], targets[:, 0], targets[:, 1], targets[:, 2])
        v, i = topk_min(d2 + inf_row, kk)
        vals.append(v)
        idxs.append(i)
    d2k = torch.cat(vals) if vals else torch.empty((0, kk), dtype=queries.dtype,
                                                    device=queries.device)
    idx = torch.cat(idxs) if idxs else torch.empty((0, kk), dtype=torch.int32,
                                                   device=queries.device)
    if kk < k:
        d2k = torch.nn.functional.pad(d2k, (0, k - kk), value=float("inf"))
        idx = torch.nn.functional.pad(idx, (0, k - kk))
    dist = torch.sqrt(torch.clamp(d2k, min=0.0))
    valid = torch.isfinite(d2k)
    if max_dist > 0:
        valid = valid & (dist < max_dist)
    return KnnResult(idx, torch.where(valid, dist, float("inf")), valid)


def knn_oracle(
    queries: np.ndarray,
    targets: np.ndarray,
    target_mask: np.ndarray,
    k: int,
    max_dist: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NumPy reference oracle replicating ``kdtree_internal::knnSearch``
    (``kdtree.cpp:10-28``): k nearest by full sort, then strict radius filter.
    Returns (indices, distances, mask) shaped (Q, k). A copy of
    ``loam_tpu.neighbors.knn_oracle``, equal to it bit for bit."""
    tgt = np.asarray(targets)[np.asarray(target_mask)]
    orig_idx = np.flatnonzero(np.asarray(target_mask))
    Q = queries.shape[0]
    idx = np.zeros((Q, k), dtype=np.int32)
    dist = np.full((Q, k), np.inf)
    mask = np.zeros((Q, k), dtype=bool)
    for i in range(Q):
        d = np.linalg.norm(tgt - queries[i], axis=-1)
        order = np.argsort(d, kind="stable")[:k]
        m = len(order)
        sel = d[order]
        keep = np.ones(m, dtype=bool) if max_dist <= 0 else sel < max_dist
        idx[i, :m] = orig_idx[order]
        dist[i, :m] = np.where(keep, sel, np.inf)
        mask[i, :m] = keep
    return idx, dist, mask
