"""Sector sort: every (line, sector) curvature slice sorted ascending.

:func:`sector_sort` launches the CUDA kernel (``csrc/sector_sort.cu``, the
port of ``loam_tpu/ops/bitonic.py::_sort_kernel``) for a CUDA tensor and runs
:func:`sector_sort_reference`, a stable ``torch.sort``, for a CPU tensor.
Both give the canonical (curvature, position) order of ``loam_tpu``'s
extraction driver (``features/extract.py:30-34``): sector ``s`` covers
``[s*pps, s*pps + size)`` (the last sector absorbs the remainder) and its
padding slots carry ``(+inf, P-1)``, as ``to_sectors`` pads. The order is
total: negative < -0.0 == +0.0 < positive < +inf < NaN, ties by position, so
a NaN sorts behind the padding slots; the curvature that comes out is the
input's own value (``-0.0`` stays ``-0.0``).

The kernel is a warp a slice with the slice in registers: integer keys, a
bitonic network whose cross-lane stages are shuffles, no block barrier, and
coalesced stores. A sector padded past 1,024 slots is sorted by a block, the
slice in shared memory (or in device memory where it does not fit) and the
network's stages within 1,024 slots still in a warp's registers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve
from ..program import Counted
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
    sorted positions (N, S, s_max) int32) by a stable ``torch.sort``.

    The order: negative < -0.0 == +0.0 < positive < +inf < NaN, ties by
    position. ``torch.sort`` on a CPU tensor gives that by itself; on a CUDA
    tensor it may sort by the keys' bits (negative NaNs first, NaNs by
    payload), so the order is taken on keys whose NaNs are one NaN and whose
    zeros are +0.0, and the curvature returned is the input's own value."""
    P = curv.shape[-1]
    _, s_max, pos = sector_layout(P, n_sectors)
    keys = to_sectors(curv, n_sectors, float("inf"))
    canonical = torch.where(torch.isnan(keys), torch.full_like(keys, float("nan")), keys + 0.0)
    order = torch.sort(canonical, dim=-1, stable=True).indices
    pos_t = torch.as_tensor(pos, device=curv.device).expand(keys.shape)
    return torch.gather(keys, -1, order), torch.gather(pos_t, -1, order).to(torch.int32)


#: The kernel's forms (``csrc/sector_sort.cu``): a warp a slice in
#: registers (slices padded to up to 1,024 slots), a block a slice in shared
#: memory, or a block a slice in a device-memory scratch (a slice too long
#: for shared memory).
FORMS = ("warp", "shared", "global")


def _key_bytes(dtype) -> int:
    """Bytes a slot takes in the block form: a 64-bit key and an int32
    position for float64, one 64-bit item for float32."""
    return 12 if dtype == torch.float64 else 8


def kernel_form(npad: int, dtype, device, form=None) -> str:
    """The form the kernel takes for slices padded to ``npad`` slots of
    ``dtype`` on ``device``: the first of :data:`FORMS` that holds such a
    slice, or ``form`` where it does (else ``ValueError``)."""
    return _form(npad, _key_bytes(dtype), resolve(device).index, form)


@functools.lru_cache(maxsize=None)  # a device's answer never changes
def _form(npad: int, key_bytes: int, index: int, form) -> str:
    got = _build.lib().loam_sector_sort_form(npad, key_bytes, -1 if form is None else FORMS.index(form), index)
    if got < 0:
        raise ValueError(f"sector_sort: the {form} form does not hold slices of {npad} slots")
    return FORMS[got]


def sector_sort(curv: torch.Tensor, n_sectors: int, form=None):
    """Sort every (line, sector) slice of ``curv`` (N, P) ascending by
    (curvature, position). Returns (sorted curvature, sorted positions
    int32), each (N, S, s_max). CUDA tensors go through the kernel, at any
    sector size: ``form`` (one of :data:`FORMS`, for tests) picks its form,
    ``None`` the first that holds the slice (:func:`kernel_form`)."""
    if not curv.is_cuda:
        return sector_sort_reference(curv, n_sectors)
    N, P = curv.shape
    pps = P // n_sectors
    s_max = P - (n_sectors - 1) * pps  # as sector_layout, without its position table
    npad = 1 << max(int(s_max - 1).bit_length(), 0)
    _build.require(curv, "curv", (torch.float32, torch.float64), (None, None))
    form = kernel_form(npad, curv.dtype, curv.device, form)
    scratch = None
    if form == "global":
        # a slice's slots as the block form lays them out: at least one chunk
        # of 1,024, one padding slot every 32
        slots = max(npad, 1024) * 33 // 32
        scratch = torch.empty(N * n_sectors * slots * _key_bytes(curv.dtype), dtype=torch.uint8,
                              device=curv.device)
    out_c = torch.empty((N, n_sectors, s_max), dtype=curv.dtype, device=curv.device)
    out_p = torch.empty((N, n_sectors, s_max), dtype=torch.int32, device=curv.device)
    lib = _build.lib()
    fn = lib.loam_sector_sort_f64 if curv.dtype == torch.float64 else lib.loam_sector_sort_f32
    _build.launch(fn, "sector_sort", curv, curv.data_ptr(), N, P, n_sectors, pps, s_max, npad,
                  FORMS.index(form), None if scratch is None else scratch.data_ptr(),
                  out_c.data_ptr(), out_p.data_ptr())
    sector_sort.counter.add()
    return out_c, out_p


#: Kernel launches since the last reset (plain-version calls do not count;
#: read through IF-node bodies, ``program.Counted``).
sector_sort = Counted(sector_sort)
