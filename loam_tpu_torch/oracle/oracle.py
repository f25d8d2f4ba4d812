"""NumPy oracle: a direct, scalar re-implementation of the reference
feature-extraction semantics (DanMcGann/loam), used ONLY for checking the
vectorized path and its CUDA kernels against known-exact behavior.

The port's own copy of ``loam_tpu/oracle/oracle.py``: the same arithmetic
line for line, on the port's parameter classes, importing only numpy, so it
runs on a host without JAX. Its results equal
``loam_tpu.oracle``'s bit for bit (``tests/test_torch_oracle.py``).

Each function mirrors the corresponding reference routine step for step
(file:line cites inline), including the behavioral quirks catalogued in
SURVEY.md §2.3:
  * off-by-one sector caps (break fires only after the cap is exceeded),
  * NMS that can cross sector (but never scan-line) boundaries,
  * occlusion case asymmetry (case 1 spares idx, case 2 includes it),
  * -1 curvature sentinel on line-edge points.

One deliberate divergence: sector sorting uses a STABLE sort keyed on
curvature (ties broken by scan index). The reference uses ``std::sort``
(unstable) so exact tie order there is implementation-defined; we pin a
deterministic canonical order and use the same rule in the kernels, so
oracle vs kernel comparisons are exact. On real (noisy) data curvature ties
do not occur and the oracle matches the C++ output.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..params import FeatureExtractionParams, LidarParams


def compute_curvature(
    scan: np.ndarray, lidar: LidarParams, params: FeatureExtractionParams
) -> np.ndarray:
    """Flat (L*P,) curvature, -1 sentinel at line edges (``features-inl.h:53-87``)."""
    L, P = lidar.scan_lines, lidar.points_per_line
    pts = np.asarray(scan, dtype=np.float64).reshape(L, P, 3)
    N = params.neighbor_points
    curv = np.full((L, P), -1.0)
    for li in range(L):
        for j in range(N, P - N):
            d = -(2.0 * N) * pts[li, j]
            for n in range(1, N + 1):
                # association matches the vectorized kernel:
                # d + (p[j-n] + p[j+n]) so f64 results are bitwise identical
                d = d + (pts[li, j - n] + pts[li, j + n])
            curv[li, j] = d @ d
    return curv.reshape(-1)


def compute_valid_points(
    scan: np.ndarray, lidar: LidarParams, params: FeatureExtractionParams
) -> np.ndarray:
    """Flat (L*P,) validity mask (``features-inl.h:90-124`` + ``features.cpp:18-70``)."""
    L, P = lidar.scan_lines, lidar.points_per_line
    pts = np.asarray(scan, dtype=np.float64).reshape(L, P, 3)
    N = params.neighbor_points
    r = np.linalg.norm(pts, axis=-1)
    mask = np.ones(L * P, dtype=bool)
    for li in range(L):
        base = li * P
        for j in range(P):
            idx = base + j
            # CHECK 1: line edges (features.cpp:20-27)
            if j < N or j >= P - N:
                mask[idx] = False
                continue
            pr, cr, nr = r[li, j - 1], r[li, j], r[li, j + 1]
            # CHECK 2: out of range, invalidates +-N neighbors (features.cpp:30-41)
            if cr < lidar.min_range or cr > lidar.max_range:
                mask[idx] = False
                for n in range(1, N + 1):
                    mask[idx + n] = False
                    mask[idx - n] = False
                continue
            # CHECK 3: occlusion (features.cpp:44-54)
            if nr - cr > params.occlusion_thresh:  # case 1: spares idx
                for n in range(1, N + 1):
                    mask[idx + n] = False
                continue
            elif cr - nr > params.occlusion_thresh:  # case 2: includes idx
                for n in range(0, N):
                    mask[idx - n] = False
                continue
            # CHECK 4: beam-parallel surface (features.cpp:57-68)
            diff_next = abs(pr - cr)
            diff_prev = abs(nr - cr)
            if diff_next > params.parallel_thresh * cr and diff_prev > params.parallel_thresh * cr:
                mask[idx] = False
    return mask


def extract_features(
    scan: np.ndarray,
    lidar: LidarParams,
    params: FeatureExtractionParams,
    curv: np.ndarray | None = None,
    mask: np.ndarray | None = None,
) -> Tuple[List[int], List[int]]:
    """Greedy sector feature pick (``features-inl.h:11-50,137-180``).

    Returns (edge_indices, planar_indices): flat scan indices of selected
    features, in the reference's output order (line, sector, curvature rank).

    ``curv``/``mask`` may be supplied to isolate the greedy logic from
    floating-point instruction-selection differences (XLA fuses the curvature
    stencil with FMAs; NumPy does not — bitwise equality of curvature values
    is not achievable, and on noiseless scenes 1e-12-level "ties" would then
    sort differently).
    """
    L, P = lidar.scan_lines, lidar.points_per_line
    if curv is None:
        curv = compute_curvature(scan, lidar, params)
    if mask is None:
        mask = compute_valid_points(scan, lidar, params)
    curv = np.asarray(curv).reshape(-1)
    mask = np.asarray(mask).reshape(-1).copy()
    N = params.neighbor_points
    S = params.number_sectors
    pps = P // S

    edges: List[int] = []
    planars: List[int] = []
    for li in range(L):
        for s in range(S):
            start = li * P + s * pps
            end = (li + 1) * P if s == S - 1 else start + pps
            sector_idx = np.arange(start, end)
            # stable ascending sort by (curvature, index) — canonical tie order
            order = sector_idx[np.argsort(curv[sector_idx], kind="stable")]

            # edge pass: descending curvature (features-inl.h:138-157)
            count = 0
            for idx in order[::-1]:
                if mask[idx] and curv[idx] > params.edge_feat_threshold:
                    edges.append(int(idx))
                    for n in range(0, N):
                        mask[idx + n] = False
                        mask[idx - n] = False
                    count += 1
                if count > params.max_edge_feats_per_sector:
                    break

            # planar pass: ascending curvature (features-inl.h:160-180)
            count = 0
            for idx in order:
                if mask[idx] and curv[idx] < params.planar_feat_threshold:
                    planars.append(int(idx))
                    for n in range(0, N):
                        mask[idx + n] = False
                        mask[idx - n] = False
                    count += 1
                if count > params.max_planar_feats_per_sector:
                    break

    return edges, planars
