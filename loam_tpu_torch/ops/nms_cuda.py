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

import functools

import torch

from ..device import resolve
from ..program import Counted
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


#: The kernel's forms (``csrc/greedy_nms.cu``), by where a line's validity
#: mask lives: registers (lines of up to 2,048 points), shared memory, or a
#: device-memory scratch (a line too long for shared memory).
FORMS = ("registers", "shared", "global")


def kernel_form(P: int, device, form=None) -> str:
    """The form the kernel takes for lines of ``P`` points on ``device``:
    the first of :data:`FORMS` that holds such a line, or ``form`` where it
    does (else ``ValueError``)."""
    return _form(P, resolve(device).index, form)


@functools.lru_cache(maxsize=None)  # a device's answer never changes
def _form(P: int, index: int, form) -> str:
    got = _build.lib().loam_greedy_nms_form(P, -1 if form is None else FORMS.index(form), index)
    if got < 0:
        raise ValueError(f"greedy_nms: the {form} form does not hold lines of {P} points")
    return FORMS[got]


def greedy_nms(valid, cand_e, cand_p, max_e: int, max_p: int, n: int, form=None):
    """Greedy sector NMS over all lines in one launch for CUDA tensors (see
    :func:`greedy_nms_reference` for the arguments). Lines of any width:
    ``form`` (one of :data:`FORMS`, for tests) picks the kernel's form,
    ``None`` the first that holds the line (:func:`kernel_form`)."""
    if not valid.is_cuda:
        return greedy_nms_reference(valid, cand_e, cand_p, max_e, max_p, n)
    N, P = valid.shape
    if n < 1:
        raise ValueError(f"greedy_nms: neighbor_points must be at least 1, got {n}")
    S, s_max = cand_e.shape[1], cand_e.shape[2]
    _build.require(valid, "valid", (torch.bool, torch.uint8), (N, P))
    _build.require(cand_e, "cand_e", (torch.int32,), (N, S, s_max), valid.device)
    _build.require(cand_p, "cand_p", (torch.int32,), (N, S, s_max), valid.device)
    form = kernel_form(P, valid.device, form)
    # form "global": a line's mask words in device memory
    scratch = (torch.empty((N, (P + 31) // 32), dtype=torch.int32, device=valid.device)
               if form == "global" else None)
    out_e = torch.empty((N, S, max_e + 1), dtype=torch.int32, device=valid.device)
    out_p = torch.empty((N, S, max_p + 1), dtype=torch.int32, device=valid.device)
    _build.launch(
        _build.lib().loam_greedy_nms, "greedy_nms", valid,
        valid.data_ptr(), cand_e.data_ptr(), cand_p.data_ptr(),
        N, P, S, s_max, max_e, max_p, n, FORMS.index(form), None if scratch is None else scratch.data_ptr(),
        out_e.data_ptr(), out_p.data_ptr(),
    )
    greedy_nms.counter.add()
    return out_e, out_p


#: Kernel launches since the last reset (plain-version calls do not count;
#: read through IF-node bodies, ``program.Counted``).
greedy_nms = Counted(greedy_nms)
