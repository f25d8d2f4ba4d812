"""Exact brute-force kNN against fixed targets, with neighbor coordinates.

The API of ``loam_tpu/ops/knn_pallas.py``: :func:`knn_prep` builds the
loop-invariant target state once (the ICF targets stay fixed across
iterations, as the reference builds its KD-trees once,
``registration-inl.h:20-23``), and :func:`knn_run` searches it with moving
queries. :func:`knn_run` launches the CUDA kernel (``csrc/knn.cu``, the port
of ``_knn_kernel``) for CUDA tensors and the plain search for CPU tensors;
:func:`knn_run_reference` is the plain search on any device.

Every array may carry one leading batch axis (the lockstep pairs of the ICF
loop): targets (B, M, 3), queries (B, Q, 3), results (B, k, Q).

Semantics (``knn_pallas.py:16-19, 196-203, 727-738``): ascending squared
distance with first-index ties; slots start at ``(r^2, 0)`` with zero
coordinates when a radius applies, else at ``(+inf, 0)``, and a candidate
fills a slot only when it is below that; invalid targets sit at a ``+3e37``
sentinel; masked queries return the initial slots; a slot is valid when its
distance is finite and ``sqrt(d2) < max_dist``.

The kernel takes float32 (as the Pallas kernel does). The plain version
keeps the targets' dtype, float32 or float64, so a float64 run on the CPU
stays float64; its sentinel is chosen so that the squared distance to it
overflows in either dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from ..neighbors.bruteforce import KnnResult, pairwise_d2, topk_min

#: Coordinates of invalid target slots, per dtype: the squared distance to
#: them overflows to +inf.
SENTINEL = {torch.float32: 3e37, torch.float64: 1e300}


class TargetPrep(NamedTuple):
    """Loop-invariant target state of :func:`knn_run`."""

    tT: torch.Tensor  # (B, 3, M) coordinate planes, sentinel at invalid slots
    batched: bool  # whether the caller passed a leading batch axis


class PackedKnn(NamedTuple):
    """kNN result in the kernel's packed layout (``knn_pallas.PackedKnn``):
    neighbor coordinates come back with the search, so association fits
    lines and planes with no gather (``geometry.fit_*_packed``)."""

    first_idx: torch.Tensor  # (..., Q) nearest target index (garbage if no match)
    mask: torch.Tensor  # (..., k, Q) slot validity (finite + radius)
    xs: torch.Tensor  # (..., k, Q) neighbor coordinates (0 where never filled)
    ys: torch.Tensor
    zs: torch.Tensor


def knn_prep(targets: torch.Tensor, target_mask: torch.Tensor) -> TargetPrep:
    """Target planes for :func:`knn_run`: (M, 3) or (B, M, 3) targets and
    their (M,) / (B, M) mask -> (B, 3, M) planes (float64 stays float64,
    anything else becomes float32) with the sentinel at invalid slots."""
    batched = targets.ndim == 3
    t = targets if batched else targets[None]
    m = target_mask if batched else target_mask[None]
    dtype = torch.float64 if t.dtype == torch.float64 else torch.float32
    t = torch.where(m[..., None], t.to(dtype), SENTINEL[dtype])
    return TargetPrep(t.transpose(-1, -2).contiguous(), batched)


def _init_d2(max_dist: float) -> float:
    return float(max_dist) ** 2 if max_dist > 0 else float("inf")


def _search_reference(tT, queries, k, init_d2, query_mask):
    """Plain search: direct differences in query tiles, k argmin passes."""
    B, _, M = tT.shape
    Q = queries.shape[1]
    init = torch.tensor(init_d2, dtype=tT.dtype, device=tT.device)
    # (B, tile, M) distance tiles: small enough to stay in a CPU's cache,
    # large enough on a GPU that the launches are few
    max_elems = 1 << 26 if tT.is_cuda else 1 << 20
    step = max(1, max_elems // max(B * M, 1))
    idxs, d2s = [], []
    for lo in range(0, Q, step):
        d2 = pairwise_d2(queries[:, lo : lo + step], tT[:, 0], tT[:, 1], tT[:, 2])
        v, i = topk_min(d2, min(k, M))
        if v.shape[-1] < k:
            v = torch.nn.functional.pad(v, (0, k - v.shape[-1]), value=float("inf"))
            i = torch.nn.functional.pad(i, (0, k - i.shape[-1]))
        d2s.append(v)
        idxs.append(i)
    v = torch.cat(d2s, dim=1).transpose(1, 2)  # (B, k, Q)
    i = torch.cat(idxs, dim=1).transpose(1, 2)
    real = v < init
    if query_mask is not None:
        real = real & query_mask[:, None, :]
    idx = torch.where(real, i, 0)
    d2 = torch.where(real, v, init)
    coords = [
        torch.where(real, torch.gather(tT[:, a], 1, idx.reshape(B, -1).long()).reshape(idx.shape), 0.0)
        for a in range(3)
    ]
    return idx, d2, coords


def _search_kernel(tT, queries, k, init_d2, query_mask):
    B, _, M = tT.shape
    Q = queries.shape[1]
    if not 1 <= k <= 8:
        raise ValueError(f"knn kernel supports 1 <= k <= 8, got {k}")
    _build.require(tT, "targets", (torch.float32,), (B, 3, M))
    _build.require(queries, "queries", (torch.float32,), (B, Q, 3), tT.device)
    if query_mask is not None:
        _build.require(query_mask, "query_mask", (torch.bool,), (B, Q), tT.device)
    dev = tT.device
    idx = torch.empty((B, k, Q), dtype=torch.int32, device=dev)
    d2 = torch.empty((B, k, Q), dtype=torch.float32, device=dev)
    coords = [torch.empty((B, k, Q), dtype=torch.float32, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        err = _build.lib().loam_knn(
            tT.data_ptr(), queries.data_ptr(),
            None if query_mask is None else query_mask.data_ptr(),
            B, M, Q, k, init_d2, idx.data_ptr(), d2.data_ptr(),
            coords[0].data_ptr(), coords[1].data_ptr(), coords[2].data_ptr(),
            _build.stream_of(tT),
        )
    _build.check(err, "knn")
    knn_run.launches += 1
    return idx, d2, coords


def _run(prep, queries, k, max_dist, with_coords, query_mask, plain):
    q = queries if prep.batched else queries[None]
    q = q.to(prep.tT.dtype).contiguous()
    qm = None
    if query_mask is not None:
        qm = (query_mask if prep.batched else query_mask[None]).to(torch.bool).contiguous()
    init_d2 = _init_d2(max_dist)
    search = _search_reference if plain else _search_kernel
    idx, d2, (xs, ys, zs) = search(prep.tT, q, k, init_d2, qm)
    valid = torch.isfinite(d2)
    if max_dist > 0:
        # sqrt then strict <, as the reference (kdtree.cpp:24-26)
        valid = valid & (torch.sqrt(torch.clamp(d2, min=0.0)) < max_dist)
    unb = (lambda x: x) if prep.batched else (lambda x: x[0])
    if with_coords:
        return PackedKnn(unb(idx[:, 0]), unb(valid), unb(xs), unb(ys), unb(zs))
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    return KnnResult(
        unb(idx.transpose(1, 2)),
        unb(torch.where(valid, dist, float("inf")).transpose(1, 2)),
        unb(valid.transpose(1, 2)),
    )


def knn_run_reference(prep: TargetPrep, queries, k: int, max_dist: float = 0.0,
                      with_coords: bool = False, query_mask=None, seed_bound=None):
    """Plain version of :func:`knn_run` (any device)."""
    return _run(prep, queries, k, max_dist, with_coords, query_mask, plain=True)


def knn_run(prep: TargetPrep, queries, k: int, max_dist: float = 0.0,
            with_coords: bool = False, query_mask=None, seed_bound=None):
    """Search ``prep``'s targets with ``queries`` (Q, 3) / (B, Q, 3).

    ``with_coords=True`` returns a :class:`PackedKnn`, else a ``KnnResult``
    with (..., Q, k) leaves. ``query_mask`` (Q,) / (B, Q): masked queries
    skip the search and return empty lists. ``seed_bound`` is accepted for
    API compatibility with ``loam_tpu`` and ignored: in the Pallas kernel it
    only prunes visits, never changing an output.
    """
    return _run(prep, queries, k, max_dist, with_coords, query_mask,
                plain=not queries.is_cuda)


#: Kernel launches since the last reset (plain-version calls do not count).
knn_run.launches = 0
