"""Vectorized curvature and point validity (reference ``features-inl.h:53-124``,
``features.cpp:18-70``), on torch tensors with any leading batch dimensions.

Curvature is the 1-D stencil ``d_j = sum_{n=1..N}(p_{j-n} + p_{j+n}) - 2N p_j``,
``c_j = |d_j|^2`` along each scan line, with a -1 sentinel on the first and
last ``N`` points. Validity is the complement of an OR of dilated firing
masks of the reference's four sequential checks (the derivation is in
``loam_tpu.features.curvature``).

Precision: with ``precise_selection`` (the default) both run in native
float64 on the upcast points, with the association of the f64 oracle
(``loam_tpu.oracle.compute_curvature``), so a float32 scan selects the
features f64 math selects. ``loam_tpu`` emulates this with double-float
pairs because its TPU has no f64 ALUs; PyTorch on a GPU or CPU has f64, so
the port needs no such layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..params import FeatureExtractionParams, LidarParams


def validate_scan(scan: torch.Tensor, lidar: LidarParams) -> torch.Tensor:
    """Shape-check and reshape a scan to (..., L, P, 3).

    Accepts (..., L, P, 3) or flat row-major (..., L*P, 3); raises on
    mismatch (the analogue of ``validateLidarScan``, ``common.h:104-113``).
    """
    L, P = lidar.scan_lines, lidar.points_per_line
    if scan.ndim >= 3 and tuple(scan.shape[-3:]) == (L, P, 3):
        return scan
    if scan.ndim >= 2 and tuple(scan.shape[-2:]) == (L * P, 3):
        return scan.reshape(scan.shape[:-2] + (L, P, 3))
    raise ValueError(
        f"LOAM: provided lidar scan shape {tuple(scan.shape)} does not match "
        f"provided lidar parameters ({L} x {P})"
    )


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """Shift along the last axis by k (positive = towards higher index),
    zero/False fill -- never wraps across scan lines."""
    if k == 0:
        return x
    n = x.shape[-1]
    if k > 0:
        return F.pad(x[..., : n - k], (k, 0))
    return F.pad(x[..., -k:], (0, -k))


def _selection_points(scan: torch.Tensor, lidar: LidarParams, params: FeatureExtractionParams):
    pts = validate_scan(scan, lidar)
    return pts.to(torch.float64) if params.precise_selection else pts


def compute_curvature(
    scan: torch.Tensor, lidar: LidarParams, params: FeatureExtractionParams
) -> torch.Tensor:
    """Curvature (..., L, P); -1 on the first/last ``neighbor_points`` of each
    line (reference ``features-inl.h:66-69``). float64 when
    ``params.precise_selection``, else the scan's dtype."""
    pts = _selection_points(scan, lidar, params)
    P = lidar.points_per_line
    N = params.neighbor_points
    padded = F.pad(pts, (0, 0, N, N))  # zero rows on both ends of each line
    d = (-2.0 * N) * pts
    for n in range(1, N + 1):
        a = padded[..., N - n : N - n + P, :]
        b = padded[..., N + n : N + n + P, :]
        if params.precise_selection:
            d = d + (a + b)  # the f64 oracle's association
        else:
            d = d + a + b  # loam_tpu's plain-path association
    c = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    j = torch.arange(P, device=pts.device)
    interior = (j >= N) & (j < P - N)
    return torch.where(interior, c, torch.full_like(c, -1.0))


def compute_valid_points(
    scan: torch.Tensor, lidar: LidarParams, params: FeatureExtractionParams
) -> torch.Tensor:
    """Validity mask (..., L, P) bool: the reference's four sequential checks,
    with range comparisons in float64 when ``params.precise_selection``."""
    pts = _selection_points(scan, lidar, params)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    r_next = _shift(r, -1)
    r_prev = _shift(r, 1)
    pr = params.parallel_thresh * r
    return _valid_from_range_checks(
        params.neighbor_points,
        lidar.points_per_line,
        out_of_range=(r < lidar.min_range) | (r > lidar.max_range),
        occl_fwd=r_next - r > params.occlusion_thresh,
        occl_bwd=r - r_next > params.occlusion_thresh,
        parallel=(torch.abs(r_prev - r) > pr) & (torch.abs(r_next - r) > pr),
    )


def _valid_from_range_checks(N, P, out_of_range, occl_fwd, occl_bwd, parallel) -> torch.Tensor:
    """Combine the four checks' raw firing conditions into the validity mask
    (each check gated on earlier checks not firing; dilations per
    ``features.cpp:18-70``)."""
    j = torch.arange(P, device=out_of_range.device)
    # CHECK 1: line edges
    c1 = (j < N) | (j >= P - N)
    not_c1 = ~c1
    # CHECK 2: out-of-range; clears j-N .. j+N
    f2 = not_c1 & out_of_range
    inv2 = torch.zeros_like(f2)
    for n in range(-N, N + 1):
        inv2 = inv2 | _shift(f2, n)
    # CHECK 3: occlusion; case 1 clears j+1..j+N, case 2 clears j-N+1..j
    gate3 = not_c1 & ~f2
    f3a = gate3 & occl_fwd
    f3b = gate3 & occl_bwd
    inv3 = torch.zeros_like(f3a)
    for n in range(1, N + 1):
        inv3 = inv3 | _shift(f3a, n)
    for n in range(0, N):
        inv3 = inv3 | _shift(f3b, -n)
    # CHECK 4: beam-parallel surface; clears self only
    f4 = gate3 & ~(f3a | f3b) & parallel
    return ~(c1 | inv2 | inv3 | f4)
