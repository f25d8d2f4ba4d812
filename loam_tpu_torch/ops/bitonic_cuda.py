"""Sector sort: every (line, sector) curvature slice sorted ascending.

:func:`sector_sort` launches the CUDA kernel (``csrc/sector_sort.cu``, the
port of ``loam_tpu/ops/bitonic.py::_sort_kernel``) for a CUDA tensor and runs
:func:`sector_sort_reference`, a stable ``torch.sort``, for a CPU tensor.
Both give the canonical (curvature, position) order of ``loam_tpu``'s
extraction driver (``features/extract.py:30-34``): sector ``s`` covers
``[s*pps, s*pps + size)`` (the last sector absorbs the remainder) and its
padding slots carry ``(+inf, P-1)``, as ``to_sectors`` pads.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build


def sector_layout(P: int, S: int):
    """(pps, s_max, positions (S, s_max) int64 numpy): within-line point
    index of every sector slot, ``P - 1`` in padding slots."""
    pps = P // S
    s_max = P - (S - 1) * pps
    pos = np.full((S, s_max), P - 1, dtype=np.int64)
    for s in range(S):
        size = s_max if s == S - 1 else pps
        pos[s, :size] = s * pps + np.arange(size)
    return pps, s_max, pos


def to_sectors(x: torch.Tensor, S: int, fill) -> torch.Tensor:
    """(N, P) -> (N, S, s_max) sector slices, padded with ``fill``."""
    P = x.shape[-1]
    pps = P // S
    s_max = P - (S - 1) * pps
    parts = []
    for s in range(S):
        size = s_max if s == S - 1 else pps
        sl = x[..., s * pps : s * pps + size]
        if size < s_max:
            sl = F.pad(sl, (0, s_max - size), value=fill)
        parts.append(sl)
    return torch.stack(parts, dim=-2)


def sector_sort_reference(curv: torch.Tensor, n_sectors: int):
    """Plain version: (N, P) curvature -> (sorted curvature (N, S, s_max),
    sorted positions (N, S, s_max) int32) by a stable ``torch.sort``."""
    P = curv.shape[-1]
    _, s_max, pos = sector_layout(P, n_sectors)
    keys = to_sectors(curv, n_sectors, float("inf"))
    sc, order = torch.sort(keys, dim=-1, stable=True)
    pos_t = torch.as_tensor(pos, device=curv.device).expand(keys.shape)
    return sc, torch.gather(pos_t, -1, order).to(torch.int32)


def sector_sort(curv: torch.Tensor, n_sectors: int):
    """Sort every (line, sector) slice of ``curv`` (N, P) ascending by
    (curvature, position). Returns (sorted curvature, sorted positions
    int32), each (N, S, s_max). CUDA tensors go through the kernel."""
    if not curv.is_cuda:
        return sector_sort_reference(curv, n_sectors)
    N, P = curv.shape
    pps, s_max, _ = sector_layout(P, n_sectors)
    npad = 1 << max(int(s_max - 1).bit_length(), 0)
    if npad > 1024:
        raise ValueError(f"sector_sort: sector size {s_max} exceeds 1024")
    _build.require(curv, "curv", (torch.float32, torch.float64), (None, None))
    out_c = torch.empty((N, n_sectors, s_max), dtype=curv.dtype, device=curv.device)
    out_p = torch.empty((N, n_sectors, s_max), dtype=torch.int32, device=curv.device)
    fn = (
        _build.lib().loam_sector_sort_f64
        if curv.dtype == torch.float64
        else _build.lib().loam_sector_sort_f32
    )
    with torch.cuda.device(curv.device):
        err = fn(
            curv.data_ptr(), N, P, n_sectors, pps, s_max, npad,
            out_c.data_ptr(), out_p.data_ptr(), _build.stream_of(curv),
        )
    _build.check(err, "sector_sort")
    sector_sort.launches += 1
    return out_c, out_p


#: Kernel launches since the last reset (plain-version calls do not count).
sector_sort.launches = 0
