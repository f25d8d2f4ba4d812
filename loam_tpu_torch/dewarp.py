"""Scan dewarping (intra-scan motion compensation).

Counterpart of ``loam_tpu.dewarp``: a spinning LiDAR sweeps its columns over
~100 ms, so under motion each column is seen from another sensor pose.
Given the motion over the sweep (e.g. the previous frame's relative pose, a
constant-velocity prediction), column ``c`` is taken as captured at sweep
fraction ``alpha = (c + 0.5) / P`` and moved into the end-of-sweep frame by
the interpolated motion ``Exp((alpha - 1) * xi)``.
"""

from __future__ import annotations

import torch

from .geometry import Pose3, quat_exp, quat_log, quat_rotate, se3_exp, se3_log
from .params import LidarParams


def dewarp_scan(scan: torch.Tensor, begin_T_end: Pose3, lidar: LidarParams,
                exact: bool = False) -> torch.Tensor:
    """Motion-compensate a scan into its end-of-sweep frame.

    Args:
      scan: (L, P, 3) or flat (L*P, 3) range-image scan, as swept; leading
        axes batch over scans that share the motion.
      begin_T_end: the sensor's motion over this sweep.
      exact: False (default): rotation by ``Exp(beta * log R)`` and
        translation linearly as ``beta * t`` (``loam_tpu``'s default
        approximation, error ~``theta * |t| / 4`` for mixed motion). True:
        the constant-twist screw ``Exp(beta * se3_log(motion))``.

    Returns: the dewarped scan, in the input's shape. Empty cells (all-zero
    points, invalid downstream) stay empty.
    """
    L, P = lidar.scan_lines, lidar.points_per_line
    shape_in = scan.shape
    flat = scan.shape[-2] == L * P and scan.shape[-3:-1] != (L, P)
    pts = scan.reshape(scan.shape[: -2 if flat else -3] + (L, P, 3))
    dtype, dev = pts.dtype, pts.device

    alpha = (torch.arange(P, dtype=dtype, device=dev) + 0.5) / P  # (P,)
    beta = alpha - 1.0
    rot = begin_T_end.rotation.to(dtype)
    trans = begin_T_end.translation.to(dtype)
    if exact:
        xi = se3_log(Pose3(rot, trans))  # (6,)
        rel = se3_exp(beta[:, None] * xi[None, :])
        q, t = rel.rotation, rel.translation  # (P, 4), (P, 3)
    else:
        q = quat_exp(beta[:, None] * quat_log(rot)[None, :])
        t = beta[:, None] * trans[None, :]

    out = quat_rotate(q, pts) + t  # (P, .) against (..., L, P, 3)
    keep = torch.sum(pts * pts, dim=-1, keepdim=True) > 0
    out = torch.where(keep, out, pts)
    return out.reshape(shape_in)
