"""Coordinate copy-out of picked features: ``out[l, c] = pts[l, picks[l, c]]``.

:func:`select_points` launches the CUDA kernel (``csrc/select_points.cu``,
the port of ``loam_tpu/ops/assemble_pallas.py::_select_kernel``) for CUDA
tensors and runs :func:`select_points_reference`, a ``torch.gather``, for
CPU tensors. Negative picks (and picks past the line) yield zero rows.
"""

from __future__ import annotations

import torch

from ..program import Counted
from . import _build


def select_points_reference(pts: torch.Tensor, picks: torch.Tensor) -> torch.Tensor:
    """Plain version: pts (N, P, 3), picks (N, C) int -> (N, C, 3)."""
    P = pts.shape[1]
    ok = (picks >= 0) & (picks < P)
    idx = torch.where(ok, picks, 0).long()
    sel = torch.gather(pts, 1, idx[..., None].expand(-1, -1, 3))
    return torch.where(ok[..., None], sel, torch.zeros((), dtype=pts.dtype, device=pts.device))


def select_points(pts: torch.Tensor, picks: torch.Tensor) -> torch.Tensor:
    """Per-line coordinate selection (see :func:`select_points_reference`)."""
    if not pts.is_cuda:
        return select_points_reference(pts, picks)
    N, P, _ = pts.shape
    C = picks.shape[1]
    _build.require(pts, "pts", (torch.float32, torch.float64), (N, P, 3))
    _build.require(picks, "picks", (torch.int32,), (N, C), pts.device)
    out = torch.empty((N, C, 3), dtype=pts.dtype, device=pts.device)
    lib = _build.lib()
    fn = lib.loam_select_points_f64 if pts.dtype == torch.float64 else lib.loam_select_points_f32
    _build.launch(fn, "select_points", pts, pts.data_ptr(), picks.data_ptr(), N, P, C,
                  out.data_ptr())
    select_points.counter.add()
    return out


#: Kernel launches since the last reset (plain-version calls do not count;
#: read through IF-node bodies, ``program.Counted``).
select_points = Counted(select_points)
