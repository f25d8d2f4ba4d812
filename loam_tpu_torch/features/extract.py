"""Feature extraction: sector sort, threshold candidates, greedy NMS pick,
coordinate copy-out.

Counterpart of ``loam_tpu.features.extract`` (reference ``extractFeatures``,
``features-inl.h:11-50``, with the sector pickers at ``:137-180``). Every
(line, sector) slice is sorted ascending by curvature; edge candidates
(curvature above the edge threshold) are visited in descending order, planar
candidates (below the planar threshold) in ascending order; each accepted
feature suppresses its ``neighbor_points - 1`` neighbors, across sector
boundaries too; scan lines are independent.

Tie order is the canonical stable ascending (curvature, index) order that
``loam_tpu`` and its f64 oracle pin (the descending pass is its exact
reverse). With ``precise_selection`` the curvature is float64, so the
thresholds are plain f64 comparisons and no ``-0.0`` canonicalisation is
needed.

Frames are a batch dimension written out: the three kernels of this module
(sector sort, greedy NMS, copy-out) each run once for all frames x lines.
The sector layout (``loam_tpu``'s ``_sector_layout``) is
``ops.bitonic_cuda.sector_layout``, beside the sort that uses it.
"""

from __future__ import annotations

import torch

from ..ops.assemble_cuda import select_points
from ..ops.bitonic_cuda import sector_sort
from ..ops.nms_cuda import greedy_nms
from ..params import FeatureExtractionParams, LidarParams
from .curvature import compute_curvature, compute_valid_points, validate_scan
from .types import FeatureSet


def _extract_core(pts, curv, valid, lidar: LidarParams, params: FeatureExtractionParams) -> FeatureSet:
    """Sector sort + greedy pick + copy-out for (B, L, P, ...) inputs;
    returns a FeatureSet with (B, ...) leaves."""
    B = pts.shape[0]
    L, P = lidar.scan_lines, lidar.points_per_line
    S = params.number_sectors
    max_e = params.max_edge_feats_per_sector
    max_p = params.max_planar_feats_per_sector
    n_lines = B * L

    sc, spos = sector_sort(curv.reshape(n_lines, P).contiguous(), S)
    real = sc < float("inf")  # padding slots, and only they, carry +inf
    neg = torch.full_like(spos, -1)
    # candidates in visit order: edges descending (the reversed ascending
    # order), planars ascending; -1 = not a candidate
    cand_e = torch.where(real & (sc > params.edge_feat_threshold), spos, neg).flip(-1).contiguous()
    cand_p = torch.where(real & (sc < params.planar_feat_threshold), spos, neg).contiguous()
    pick_e, pick_p = greedy_nms(
        valid.reshape(n_lines, P).contiguous(), cand_e, cand_p, max_e, max_p,
        params.neighbor_points,
    )

    line_off = (torch.arange(L, device=pts.device, dtype=torch.int32) * P)[None, :, None, None]

    def flat(picks, cap_total):
        picks = picks.reshape((B, L) + picks.shape[1:])
        idx = torch.where(picks >= 0, picks + line_off, -1)
        idx = idx.reshape(B, cap_total).to(torch.int32)
        return idx >= 0, idx

    em, ei = flat(pick_e, params.edge_capacity(lidar))
    pm, pi = flat(pick_p, params.planar_capacity(lidar))

    ce = pick_e.shape[1] * pick_e.shape[2]
    cat = torch.cat([pick_e.reshape(n_lines, -1), pick_p.reshape(n_lines, -1)], dim=1)
    sel = select_points(pts.reshape(n_lines, P, 3).contiguous(), cat.contiguous())
    ep = sel[:, :ce].reshape(B, -1, 3)
    pp = sel[:, ce:].reshape(B, -1, 3)
    return FeatureSet(ep, em, ei, pp, pm, pi)


def extract_features_batch(
    scans: torch.Tensor,
    lidar: LidarParams,
    params: FeatureExtractionParams = FeatureExtractionParams(),
    post=None,
) -> FeatureSet:
    """Extract features of every frame of ``scans`` (F, L, P, 3) or
    (F, L*P, 3); ``post`` (e.g. ``azimuth_sort_features``) is applied to the
    batched result. Returns a FeatureSet with (F, ...) leaves."""
    pts = validate_scan(scans, lidar)
    if pts.ndim != 4:
        raise ValueError(f"expected a batch of scans, got shape {tuple(scans.shape)}")
    curv = compute_curvature(pts, lidar, params)
    valid = compute_valid_points(pts, lidar, params)
    fs = _extract_core(pts, curv, valid, lidar, params)
    return post(fs) if post is not None else fs


def extract_features_given(
    scan: torch.Tensor,
    curv: torch.Tensor,
    valid: torch.Tensor,
    lidar: LidarParams,
    params: FeatureExtractionParams = FeatureExtractionParams(),
) -> FeatureSet:
    """Feature pick from precomputed curvature (L, P) and validity (L, P) of
    one scan, so that a caller controls the exact curvature values the
    tie-sensitive greedy stage sees."""
    pts = validate_scan(scan, lidar)
    if pts.ndim != 3:
        raise ValueError(f"expected one scan, got shape {tuple(scan.shape)}")
    L, P = lidar.scan_lines, lidar.points_per_line
    fs = _extract_core(pts[None], curv.reshape(1, L, P), valid.reshape(1, L, P), lidar, params)
    return fs.map(lambda x: x[0])


def extract_features(
    scan: torch.Tensor,
    lidar: LidarParams,
    params: FeatureExtractionParams = FeatureExtractionParams(),
) -> FeatureSet:
    """Extract LOAM edge/planar features from one range-image scan, (L, P, 3)
    or flat (L*P, 3). Slot order matches the reference's output order."""
    pts = validate_scan(scan, lidar)
    if pts.ndim != 3:
        raise ValueError(f"expected one scan, got shape {tuple(scan.shape)}")
    return extract_features_batch(pts[None], lidar, params).map(lambda x: x[0])
