"""The numbers ``correct`` compares, each against its limit
(``limits/<cell>.json``), and the failures counted against the calls.

* ``pose_gap_m`` / ``pose_gap_rad``: the widest gap, over every judged
  call and frame, between a pose the program returned and the reference's
  (scan-to-scan: each pair's relative pose, the registration's answer;
  scan-to-map: each frame's world pose against the maps).
* ``fits_gap``: the widest share by which the first iteration's line and
  plane fits of a pair or frame differ from the reference's; they follow
  from the feature picks on both sides, so this is the extraction's check.
* ``map_voxel_gap`` (scan-to-map): the share of occupied voxels, of the
  final edge or planar map, held by one side and not by the other.

A call fails (``failed``) when its trajectory misses the ATE gate against
the renderer's ground truth, when a map insert dropped voxels for capacity,
or when a neighbour search overflowed.
"""

from __future__ import annotations

import torch

from .reference import maps, pipelines


def pose_gaps(q, t, ref_q, ref_t) -> dict:
    dt, dq = pipelines.gaps((q, t), (ref_q.to(q.device), ref_t.to(q.device)))
    return {"pose_gap_m": float(dt.max()), "pose_gap_rad": float(dq.max())}


def fits_gap(fits, ref_fits) -> float:
    a = fits.to(torch.float64).cpu()
    b = ref_fits.to(torch.float64).cpu()
    return float((torch.abs(a - b) / torch.clamp(b, min=1.0)).max())


def voxel_gap(points, mask, ref_points, ref_mask, voxel: float, owned=None) -> float:
    """Share of the voxels occupied on either side held by one side only;
    ``owned(keys)`` keeps the reference's voxels a shard of the program
    holds (a sharded map)."""
    a = set(maps.keys(points[mask].cpu(), voxel).tolist())
    ref = ref_points[ref_mask].cpu()
    b = maps.keys(ref, voxel)
    if owned is not None:
        b = b[owned(ref)]
    b = set(b.tolist())
    union = a | b
    return len(a ^ b) / max(len(union), 1)


def worst(readings: list) -> dict:
    """The largest reading of every number over several judgements."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def verdict(numbers: dict, limits: dict) -> list:
    """``[name, number, limit]`` for every limited number; a number that is
    missing or not finite fails."""
    rows = []
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        rows.append([name, v, limit])
    return rows


def correct(rows: list) -> bool:
    return all(v == v and v <= limit for _, v, limit in rows)


def failures(kept: dict, truth_t) -> bool:
    """Whether a call failed: ATE past the gate, voxels dropped, a search
    overflowed, or a pose not finite."""
    t = kept["t"].to(torch.float64).cpu()
    if not bool(torch.isfinite(t).all()):
        return True
    if pipelines.ate(t, truth_t) >= pipelines.ate_limit(truth_t):
        return True
    return int(kept.get("dropped", 0)) > 0 or int(kept.get("overflow", 0)) > 0
