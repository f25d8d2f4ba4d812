"""Greedy sector NMS: the serial feature pick of every scan line.

:func:`greedy_nms` launches the CUDA kernel (``csrc/greedy_nms.cu``, the port
of ``loam_tpu/ops/nms_pallas.py::_nms_kernel``) for CUDA tensors and runs
:func:`greedy_nms_reference` for CPU tensors. Semantics (reference
``features-inl.h:137-180``): per line, sector by sector, the edge candidates
then the planar ones are visited in list order; a ``-1`` or already-masked
candidate is a no-op that does not count toward the cap; an accepted one is
recorded, suppresses ``idx-(n-1) .. idx+(n-1)`` (clipped to the line, across
sector boundaries) and counts; up to ``cap + 1`` are admitted.
"""

from __future__ import annotations

import torch

from . import _build


def greedy_nms_reference(valid, cand_e, cand_p, max_e: int, max_p: int, n: int):
    """Plain version, vectorised over lines and serial over candidate slots.

    Args:
      valid: (N, P) bool validity mask.
      cand_e / cand_p: (N, S, s_max) int32 within-line candidates in visit
        order, -1 = not a candidate.
      max_e / max_p: per-sector caps (cap + 1 admitted).
      n: neighbor_points (suppression reach n - 1).
    Returns: (edge picks (N, S, max_e+1), planar picks (N, S, max_p+1))
      int32, -1 padded.
    """
    N, P = valid.shape
    S, s_max = cand_e.shape[1], cand_e.shape[2]
    dev = valid.device
    mask = valid.clone()
    rows = torch.arange(N, device=dev)
    offsets = range(-(n - 1), n)
    outs = []
    for cand, max_f in ((cand_e, max_e), (cand_p, max_p)):
        outs.append(torch.full((N, S, max_f + 1), -1, dtype=torch.int32, device=dev))
    for s in range(S):
        for (cand, max_f), out in zip(((cand_e, max_e), (cand_p, max_p)), outs):
            count = torch.zeros(N, dtype=torch.long, device=dev)
            for t in range(s_max):
                idx = cand[:, s, t].long()
                live = mask[rows, idx.clamp(min=0)]
                ok = (idx >= 0) & (count <= max_f) & live
                slot = count.clamp(max=max_f)
                out[rows, s, slot] = torch.where(ok, idx.to(torch.int32), out[rows, s, slot])
                for o in offsets:
                    # clamping into the line lands inside the clipped window
                    q = (idx + o).clamp(0, P - 1)
                    mask[rows, q] = mask[rows, q] & ~ok
                count = count + ok.long()
    return outs[0], outs[1]


def greedy_nms(valid, cand_e, cand_p, max_e: int, max_p: int, n: int):
    """Greedy sector NMS over all lines in one launch for CUDA tensors (see
    :func:`greedy_nms_reference` for the arguments)."""
    if not valid.is_cuda:
        return greedy_nms_reference(valid, cand_e, cand_p, max_e, max_p, n)
    N, P = valid.shape
    if P > 2048:
        raise ValueError(f"greedy_nms: {P} points per line exceeds 2048")
    S, s_max = cand_e.shape[1], cand_e.shape[2]
    _build.require(valid, "valid", (torch.bool, torch.uint8), (N, P))
    _build.require(cand_e, "cand_e", (torch.int32,), (N, S, s_max), valid.device)
    _build.require(cand_p, "cand_p", (torch.int32,), (N, S, s_max), valid.device)
    out_e = torch.empty((N, S, max_e + 1), dtype=torch.int32, device=valid.device)
    out_p = torch.empty((N, S, max_p + 1), dtype=torch.int32, device=valid.device)
    with torch.cuda.device(valid.device):
        err = _build.lib().loam_greedy_nms(
            valid.data_ptr(), cand_e.data_ptr(), cand_p.data_ptr(),
            N, P, S, s_max, max_e, max_p, n,
            out_e.data_ptr(), out_p.data_ptr(), _build.stream_of(valid),
        )
    _build.check(err, "greedy_nms")
    greedy_nms.launches += 1
    return out_e, out_p


#: Kernel launches since the last reset (plain-version calls do not count).
greedy_nms.launches = 0
