"""Exact brute-force kNN against fixed targets, with neighbor coordinates.

The API of ``loam_tpu/ops/knn_pallas.py``: :func:`knn_prep` builds the
loop-invariant target state once (the ICF targets stay fixed across
iterations, as the reference builds its KD-trees once,
``registration-inl.h:20-23``), and :func:`knn_run` searches it with moving
queries. :func:`knn_run` launches the CUDA kernel (``csrc/knn.cu``, the port
of ``_knn_kernel``) for CUDA tensors and the plain search for CPU tensors;
:func:`knn_run_reference` is the plain search on any device. The dual API
(:func:`knn_dual_prep`, :func:`knn_dual_run`, :func:`knn_pallas_dual`) runs
the edge and the planar search of an ICF iteration in one launch of the
second entry point of ``csrc/knn.cu``, the port of ``knn_dual_run``. Which
of the two the ICF loop calls is chosen by ``LOAM_ICF_DUAL_KNN``, carried
over from ``loam_tpu``: it selects an algorithm, as there, and is not an
implementation switch; kernel or plain version is decided by the device
alone, for both.

Every array may carry one leading batch axis (the lockstep pairs of the ICF
loop): targets (B, M, 3), queries (B, Q, 3), results (B, k, Q).

Semantics (``knn_pallas.py:16-19, 196-203, 727-738``): ascending squared
distance with first-index ties; slots start at ``(r^2, 0)`` with zero
coordinates when a radius applies, else at ``(+inf, 0)``, and a candidate
fills a slot only when it is below that; invalid targets sit at a ``+3e37``
sentinel; masked queries return the initial slots; a slot is valid when its
distance is finite and ``sqrt(d2) < max_dist``.

The kernel takes float32 and any ``k >= 1``, as the Pallas kernel does: up
to ``REGISTER_MAX_K`` its lists stay in registers, above it a second entry
of ``csrc/knn.cu`` keeps them in the output planes. The plain version keeps
the targets' dtype, float32 or float64, so a float64 run stays float64; its
sentinel is chosen so that the squared distance to it overflows in either
dtype. Which of the two runs is decided by device and dtype, as
``loam_tpu`` decides (``registration/icf.py:266-275``): the kernel for
float32 CUDA tensors, the plain version on the tensors' own device for
float64 (on the card too) and for any CPU tensor. That is a dispatch by
type, not an implementation switch.

Visit pruning (``knn_pallas.py:78-118, 286-327, 362-432, 475-557,
611-656``). The preps carry, beside the coordinate planes, boxes of ``tt``
target slots: each box's unit xy direction and its bounds in that rotated
frame (:func:`chunk_frames`). The kernel lists, per block of queries, the
boxes near enough, nearest first, and skips a box when no query's lower
bound reaches ``min(running k-th, seed bound)``. :func:`tile_gaps` and
:func:`pack_active_lists` are the plain statement of those lists (the
kernel builds its own in its prologue); :func:`kth_smallest_bound`,
:func:`seed_bound_from_packed`, :func:`window_candidates` and
:func:`seed_bound_from_window` give the ICF loop's seed bounds. None of it
changes an output: the plain versions visit every slot and stay the
independent statement of the result. ``LOAM_KNN_LIST_PRUNE`` (default
``"1"``, ``loam_tpu``'s switch) drops from the lists the boxes beyond every
query's seed bound; the gate skips them either way.

Two more things of the kernel's design are prepared here, from shapes and
masks alone and with no host sync. The preps carry ``n_live``, the index of
each pair's last valid target slot + 1: the kernel visits ``[0, n_live)``
only (the voxel maps keep their valid slots as a prefix). :func:`split_plan`
chooses into how many ranges each class's targets are split across thread
blocks, so that one pair fills the card as well as four do; the wrapper
allocates the scratch for the partial lists.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..program import Counted
from . import _build
from ..neighbors.bruteforce import KnnResult, pairwise_d2, topk_min

#: Largest ``k`` whose lists the kernel keeps in registers; a larger ``k``
#: launches the kernel's wide form (one thread a query, no target splits).
REGISTER_MAX_K = 8

#: Coordinates of invalid target slots, per dtype: the squared distance to
#: them overflows to +inf.
SENTINEL = {torch.float32: 3e37, torch.float64: 1e300}

#: Thread blocks a search launch aims at: eight waves of the H100's 132 SMs,
#: so that the last, partly filled wave is a small share of the run (these
#: three constants are what ``python3 -m loam_tpu_torch.tune_knn`` sweeps).
TARGET_BLOCKS = 1056
#: Fewest target slots a split is worth: below it a block's partial lists
#: cost as much as its search.
MIN_CHUNK = 512
#: Most ranges one class's targets are split into.
MAX_SPLITS = 32

#: Queries a block of the kernel covers (register lists / wide form), as
#: ``csrc/knn.cu`` is built by default: the plain version reports its visits
#: per block of this many queries on the CPU.
BLOCK_QUERIES, WIDE_BLOCK_QUERIES = 1024, 128

#: Relative inflation of every seed bound, with an absolute 1e-35 beside it
#: (``knn_pallas.py:475-481``): the bound stays an upper bound on the k-th
#: squared distance whatever rounding the search's own distances take.
BOUND_SLACK = 1.000001

_BIG = 3e37  # inverted bounds of a box without a valid target


def default_tt(m: int) -> int:
    """Box length (the Pallas chunk length) for an ``m``-slot target:
    ``knn_pallas._auto_tiles`` -- 256 slots, 128 from 32,768 slots."""
    return 128 if m >= 32768 else 256


def chunk_frames(tch: torch.Tensor, vch: torch.Tensor):
    """Per-box rotated bounding boxes (``knn_pallas._chunk_frames``):
    (..., 3, C, tt) boxed targets and their (..., 1, C, tt) validity ->
    ((..., 2, C) unit direction (cx, cy) along each box's mean, (..., 6, C)
    u/v/z lo, hi in that frame). A box without a valid target gets the
    inverted +/-3e37 box, direction (1, 0)."""
    tx, ty, tz = tch[..., 0, :, :], tch[..., 1, :, :], tch[..., 2, :, :]
    v = vch[..., 0, :, :]
    zero = torch.zeros((), dtype=tch.dtype, device=tch.device)
    sx = torch.sum(torch.where(v, tx, zero), dim=-1)
    sy = torch.sum(torch.where(v, ty, zero), dim=-1)
    nrm = torch.sqrt(sx * sx + sy * sy)
    ok = nrm > 0
    safe = torch.where(ok, nrm, torch.ones_like(nrm))
    cx = torch.where(ok, sx / safe, torch.ones_like(sx))
    cy = torch.where(ok, sy / safe, torch.zeros_like(sy))
    u = cx[..., None] * tx + cy[..., None] * ty
    w = cx[..., None] * ty - cy[..., None] * tx

    def lohi(a):
        return (torch.amin(torch.where(v, a, _BIG), dim=-1),
                torch.amax(torch.where(v, a, -_BIG), dim=-1))

    bounds = [*lohi(u), *lohi(w), *lohi(tz)]
    return torch.stack([cx, cy], dim=-2), torch.stack(bounds, dim=-2)


def tile_gaps(qlo, qhi, rot, rbox):
    """Squared separation of query-tile boxes and target boxes in each
    target box's frame (``knn_pallas._tile_gaps``): (..., 3, T) tile bounds,
    (..., 2, C) directions and (..., 6, C) boxes -> ((..., T, C) sep^2,
    (..., T) tile-nonempty flag)."""
    cx, cy = rot[..., 0, :, None], rot[..., 1, :, None]  # (..., C, 1)
    xlo, xhi = qlo[..., 0, None, :], qhi[..., 0, None, :]  # (..., 1, T)
    ylo, yhi = qlo[..., 1, None, :], qhi[..., 1, None, :]

    def interval(ax, ay):  # a linear map's extremes over the tile's xy rectangle
        a0, a1, b0, b1 = ax * xlo, ax * xhi, ay * ylo, ay * yhi
        return (torch.minimum(a0, a1) + torch.minimum(b0, b1),
                torch.maximum(a0, a1) + torch.maximum(b0, b1))

    def gap(alo, ahi, blo, bhi):
        return torch.clamp(torch.maximum(blo - ahi, alo - bhi), min=0.0)

    tulo, tuhi = interval(cx, cy)
    tvlo, tvhi = interval(-cy, cx)
    box = lambda r: rbox[..., r, :, None]
    gu = gap(tulo, tuhi, box(0), box(1))  # (..., C, T)
    gv = gap(tvlo, tvhi, box(2), box(3))
    gz = gap(qlo[..., 2, None, :], qhi[..., 2, None, :], box(4), box(5))
    sep2 = (gu * gu + gv * gv + gz * gz).transpose(-1, -2)
    return sep2, qhi[..., 0, :] >= qlo[..., 0, :]


def pack_active_lists(active: torch.Tensor, sep2: torch.Tensor = None):
    """Left-packed active box indices (``knn_pallas._pack_active_lists``):
    (..., T, C) flags -> ((..., T, C) int32 lists, zero past the count,
    (..., T, 1) int32 counts). With ``sep2`` the lists come nearest first,
    ties by box index; without, in index order."""
    C = active.shape[-1]
    if sep2 is None:
        order = torch.sort((~active).to(torch.uint8), dim=-1, stable=True).indices
    else:
        key = torch.where(active, sep2, torch.full_like(sep2, float("inf")))
        by_key = torch.sort(key, dim=-1, stable=True).indices
        # the active boxes first, in key order (an active box may tie an
        # inactive one at +inf)
        first = torch.sort((~torch.gather(active, -1, by_key)).to(torch.uint8), dim=-1,
                           stable=True).indices
        order = torch.gather(by_key, -1, first)
    cnt = torch.sum(active, dim=-1, keepdim=True, dtype=torch.int32)
    pos = torch.arange(C, device=active.device)
    return torch.where(pos < cnt, order, 0).to(torch.int32), cnt


def kth_smallest_bound(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Sound upper bound on the k-th smallest of (..., W, Q) candidate
    squared distances (+inf = no candidate), per query: k - 1 passes that
    drop every copy of the minimum, then the minimum, inflated by
    :data:`BOUND_SLACK`. Dropping equal values together only loosens it."""
    d = d2
    inf = torch.full_like(d2, float("inf"))
    for _ in range(k - 1):
        d = torch.where(d == torch.amin(d, dim=-2, keepdim=True), inf, d)
    return torch.amin(d, dim=-2) * BOUND_SLACK + 1e-35


def seed_bound_from_packed(queries, xs, ys, zs, mask) -> torch.Tensor:
    """(..., Q) warm-start bound from the last search's packed result
    (``PackedKnn`` coordinates and mask, (..., k, Q)) at the moved
    (..., Q, 3) queries: the largest of the k neighbours' squared distances
    where all k slots were valid, else +inf."""
    dx = queries[..., None, :, 0] - xs
    dy = queries[..., None, :, 1] - ys
    dz = queries[..., None, :, 2] - zs
    d2 = dx * dx + dy * dy + dz * dz  # (..., k, Q)
    b = torch.amax(d2, dim=-2) * BOUND_SLACK + 1e-35
    return torch.where(torch.all(mask, dim=-2), b, torch.full_like(b, float("inf")))


def window_candidates(targets, target_mask, q_count: int, w: int = 8):
    """Cold-seed candidates (``knn_pallas.window_candidates``): for query
    slot i < min(Q, M), the targets at slots i - w/2 .. i + w/2 - 1 (taken
    round the end, valid only inside [0, M) and where the mask holds); zero
    and invalid for the other slots. (..., M, 3) / (..., M) ->
    ``(xs, ys, zs, ok)``, each (..., w, Q). Loop-invariant: hoist it above
    the ICF loop."""
    M, Q = targets.shape[-2], q_count
    n = min(Q, M)
    dev = targets.device
    lead = targets.shape[:-2]
    i = torch.arange(Q, device=dev)
    offs = torch.arange(-(w // 2), w - w // 2, device=dev)[:, None]  # (w, 1)
    j = i + offs  # (w, Q)
    real = i < n
    src = torch.remainder(j, max(M, 1))
    pts = targets[..., src.reshape(-1), :].reshape(*lead, w, Q, 3) if M else \
        torch.zeros((*lead, w, Q, 3), dtype=targets.dtype, device=dev)
    pts = torch.where(real[:, None], pts, torch.zeros((), dtype=targets.dtype, device=dev))
    m = target_mask[..., src.reshape(-1)].reshape(*lead, w, Q) if M else \
        torch.zeros((*lead, w, Q), dtype=torch.bool, device=dev)
    ok = m & real & (j >= 0) & (j < M)
    return pts[..., 0], pts[..., 1], pts[..., 2], ok


def seed_bound_from_window(queries, xs, ys, zs, ok, k: int) -> torch.Tensor:
    """(..., Q) cold-start bound from :func:`window_candidates` at the moved
    (..., Q, 3) queries: :func:`kth_smallest_bound` of their squared
    distances."""
    dx = queries[..., None, :, 0] - xs
    dy = queries[..., None, :, 1] - ys
    dz = queries[..., None, :, 2] - zs
    d2 = torch.where(ok, dx * dx + dy * dy + dz * dz, torch.full_like(dx, float("inf")))
    return kth_smallest_bound(d2, k)


class TargetPrep(NamedTuple):
    """Loop-invariant target state of :func:`knn_run`."""

    tT: torch.Tensor  # (B, 3, M) coordinate planes, sentinel at invalid slots
    batched: bool  # whether the caller passed a leading batch axis
    n_live: torch.Tensor  # (B,) int32: index of the last valid slot + 1
    rot: torch.Tensor  # (B, 2, C) unit direction of each box of tt slots
    rbox: torch.Tensor  # (B, 6, C) each box's u/v/z lo, hi in its frame
    tt: int  # box length


class PackedKnn(NamedTuple):
    """kNN result in the kernel's packed layout (``knn_pallas.PackedKnn``):
    neighbor coordinates come back with the search, so association fits
    lines and planes with no gather (``geometry.fit_*_packed``)."""

    first_idx: torch.Tensor  # (..., Q) nearest target index (garbage if no match)
    mask: torch.Tensor  # (..., k, Q) slot validity (finite + radius)
    xs: torch.Tensor  # (..., k, Q) neighbor coordinates (0 where never filled)
    ys: torch.Tensor
    zs: torch.Tensor


def live_bound(mask: torch.Tensor) -> torch.Tensor:
    """(..., M) validity -> (...,) int32 index of the last valid slot + 1
    (0 where none is valid), computed on ``mask``'s device."""
    M = mask.shape[-1]
    if M == 0:
        return torch.zeros(mask.shape[:-1], dtype=torch.int32, device=mask.device)
    pos = torch.arange(1, M + 1, dtype=torch.int32, device=mask.device)
    return torch.amax(torch.where(mask, pos, 0), dim=-1)


def _boxes(tT: torch.Tensor, mask: torch.Tensor, tt: int):
    """(B, 3, M) planes and (B, M) validity -> boxes of ``tt`` slots, at
    least one: ((B, 2, C), (B, 6, C)), contiguous."""
    B, _, M = tT.shape
    C = max(-(-M // tt), 1)
    pad = C * tt - M
    t = torch.nn.functional.pad(tT, (0, pad), value=SENTINEL[tT.dtype])
    v = torch.nn.functional.pad(mask, (0, pad), value=False)
    rot, rbox = chunk_frames(t.reshape(B, 3, C, tt), v.reshape(B, 1, C, tt))
    return rot.contiguous(), rbox.contiguous()


def knn_prep(targets: torch.Tensor, target_mask: torch.Tensor, tt: int = None) -> TargetPrep:
    """Target planes for :func:`knn_run`: (M, 3) or (B, M, 3) targets and
    their (M,) / (B, M) mask -> (B, 3, M) planes (float64 stays float64,
    anything else becomes float32) with the sentinel at invalid slots, the
    pairs' live-target bounds and the boxes of ``tt`` slots
    (:func:`default_tt` when not given), all on the targets' device with no
    host sync."""
    batched = targets.ndim == 3
    t = targets if batched else targets[None]
    m = (target_mask if batched else target_mask[None]).to(torch.bool)
    dtype = torch.float64 if t.dtype == torch.float64 else torch.float32
    t = torch.where(m[..., None], t.to(dtype), SENTINEL[dtype])
    tT = t.transpose(-1, -2).contiguous()
    tt = tt or default_tt(t.shape[1])
    return TargetPrep(tT, batched, live_bound(m), *_boxes(tT, m, tt), tt)


def split_plan(B: int, classes, block_queries: int):
    """Into how many ranges each class's targets are split across thread
    blocks. ``classes`` is ``((Q, M), ...)``, queries and target slots per
    pair; ``block_queries`` the queries one block covers. From shapes only
    (the live counts would need a host sync): the work of a launch, in
    query blocks x target slots, is cut into about ``TARGET_BLOCKS`` equal
    chunks of at least ``MIN_CHUNK`` slots, so a class gets splits in
    proportion to its targets and every block carries similar work."""
    work = sum(B * -(-q // block_queries) * m for q, m in classes)
    chunk = max(MIN_CHUNK, -(-work // TARGET_BLOCKS))
    return tuple(max(1, min(MAX_SPLITS, -(-m // chunk))) for _, m in classes)


def kernel_takes(t: torch.Tensor) -> bool:
    """Whether the kernel searches targets ``t``: a float32 CUDA tensor."""
    return t.is_cuda and t.dtype == torch.float32


def _splits(B: int, classes, k: int, tt: int = None):
    """:func:`split_plan` for the register lists, with enough splits that a
    block's range holds at most the kernel's list of boxes of ``tt`` slots;
    the wide form takes none."""
    if k > REGISTER_MAX_K:
        return (1,) * len(classes)
    lib = _build.lib()
    plan = split_plan(B, classes, lib.loam_knn_block_queries())
    if tt is None:
        return plan
    most = lib.loam_knn_max_boxes()
    out = []
    for s, (_, m) in zip(plan, classes):
        while -(-(-(-m // s)) // tt) > most:  # boxes in a range of ceil(m / s) slots
            s += 1
        out.append(s)
    return tuple(out)


def _block_queries(k: int, dev) -> int:
    """Queries a kernel block covers: the visit counters' unit."""
    if dev.type != "cuda":
        return WIDE_BLOCK_QUERIES if k > REGISTER_MAX_K else BLOCK_QUERIES
    lib = _build.lib()
    return lib.loam_knn_wide_block_queries() if k > REGISTER_MAX_K else lib.loam_knn_block_queries()


def _init_d2(max_dist: float) -> float:
    return float(max_dist) ** 2 if max_dist > 0 else float("inf")


def _plain_visits(n_live, tt: int, Q: int, k: int):
    """What the plain search visits: every box of [0, n_live), for each
    (B, query block)."""
    nqb = -(-Q // _block_queries(k, n_live.device))
    return (-(-n_live // tt)).to(torch.int32)[:, None].expand(-1, nqb).contiguous()


def _search_reference(prep, queries, k, init_d2, query_mask, seed=None):
    """Plain search: direct differences in query tiles, k argmin passes,
    over every target slot (the seed bound prunes nothing here). Returns
    ``(idx, d2, coords, visits)``."""
    idx, d2, coords = _search_planes(prep.tT, queries, k, init_d2, query_mask)
    return idx, d2, coords, _plain_visits(prep.n_live, prep.tt, queries.shape[1], k)


def _search_planes(tT, queries, k, init_d2, query_mask):
    B, _, M = tT.shape
    Q = queries.shape[1]
    # a device fill, not a copy from the host: the search runs inside CUDA graphs
    init = torch.full((), init_d2, dtype=tT.dtype, device=tT.device)
    # (B, tile, M) distance tiles: small enough to stay in a CPU's cache,
    # large enough on a GPU that the launches are few
    max_elems = 1 << 26 if tT.is_cuda else 1 << 20
    step = max(1, max_elems // max(B * M, 1))
    idxs, d2s = [], []
    for lo in range(0, max(Q, 1), step):  # one empty tile when Q == 0
        d2 = pairwise_d2(queries[:, lo : lo + step], tT[:, 0], tT[:, 1], tT[:, 2])
        v, i = topk_min(d2, min(k, M))
        if v.shape[-1] < k:
            v = torch.nn.functional.pad(v, (0, k - v.shape[-1]), value=float("inf"))
            i = torch.nn.functional.pad(i, (0, k - i.shape[-1]))
        d2s.append(v)
        idxs.append(i)
    # (B, k, Q), contiguous as the kernel writes them: the fits' reductions
    # over k then run alike on either
    v = torch.cat(d2s, dim=1).transpose(1, 2).contiguous()
    i = torch.cat(idxs, dim=1).transpose(1, 2).contiguous()
    real = v < init
    if query_mask is not None:
        real = real & query_mask[:, None, :]
    idx = torch.where(real, i, 0)
    d2 = torch.where(real, v, init)
    coords = [
        torch.where(real, torch.gather(tT[:, a], 1, idx.reshape(B, -1).long()).reshape(idx.shape), 0.0)
        for a in range(3)
    ]
    return idx, d2, coords


def _partial_lists(sizes, dev):
    """Scratch for the partial top-k lists, the classes' (B, splits, k, Q)
    blocks one after the other; none when no class is split."""
    if all(s == 1 for _, s, _, _ in sizes):
        return None, None
    n = sum(B * s * k * Q for B, s, k, Q in sizes)
    return (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _list_prune(init_d2: float) -> bool:
    """``loam_tpu``'s list-level prune on the seed bound (``knn_run``
    :633-652): with a radius, unless ``LOAM_KNN_LIST_PRUNE=0``."""
    return init_d2 < float("inf") and os.environ.get("LOAM_KNN_LIST_PRUNE", "1") != "0"


def _search_kernel(prep, queries, k, init_d2, query_mask, seed=None, visits=False, bound=False,
                   prev=None, window=False):
    """The kernel on (B, Q, 3) queries: ``(idx, d2, coords, visits,
    bound)``. ``seed`` (B, Q) float32 upper bounds on the k-th d2 gate the
    visits; so do the bounds the kernel computes itself from ``prev``, the
    last search's ``(xs, ys, zs, mask)`` (each (B, k, Q)), and, with
    ``window``, from the targets at each query's rank (the ICF loop's warm
    and cold starts: the smallest of the three is the gate's). With
    ``visits`` come back, per (B, query block), the boxes
    staged and the query-box visits (for each box searched, the queries
    whose own gate passed it, summed; times ``prep.tt``, the distance
    evaluations the search needed), as (B,
    blocks, 2) int32 (else None); with ``bound`` the seed bound each query
    was gated with (+inf without a seed; else None) -- the kernel's debug
    plane."""
    tT, n_live = prep.tT, prep.n_live
    B, _, M = tT.shape
    Q = queries.shape[1]
    if k < 1:
        raise ValueError(f"knn kernel needs k >= 1, got {k}")
    _build.require(tT, "targets", (torch.float32,), (B, 3, M))
    _build.require(n_live, "n_live", (torch.int32,), (B,), tT.device)
    C = prep.rot.shape[-1]
    _build.require(prep.rot, "box directions", (torch.float32,), (B, 2, C), tT.device)
    _build.require(prep.rbox, "boxes", (torch.float32,), (B, 6, C), tT.device)
    _build.require(queries, "queries", (torch.float32,), (B, Q, 3), tT.device)
    if query_mask is not None:
        _build.require(query_mask, "query_mask", (torch.bool,), (B, Q), tT.device)
    if seed is not None:
        _build.require(seed, "seed_bound", (torch.float32,), (B, Q), tT.device)
    if prev is not None:
        for name, x, dt in zip(("xs", "ys", "zs", "mask"), prev, (torch.float32,) * 3 + (torch.bool,)):
            _build.require(x, f"seed_prev {name}", (dt,), (B, k, Q), tT.device)
    dev = tT.device
    lib = _build.lib()
    (splits,) = _splits(B, ((Q, M),), k, prep.tt)
    part_d2, part_idx = _partial_lists(((B, splits, k, Q),), dev)
    idx = torch.empty((B, k, Q), dtype=torch.int32, device=dev)
    d2 = torch.empty((B, k, Q), dtype=torch.float32, device=dev)
    coords = [torch.empty((B, k, Q), dtype=torch.float32, device=dev) for _ in range(3)]
    vis = torch.zeros((B, -(-Q // _block_queries(k, dev)), 2), dtype=torch.int32, device=dev) \
        if visits else None
    bnd = torch.empty((B, Q), dtype=torch.float32, device=dev) if bound else None
    _build.launch(
        lib.loam_knn, "knn", tT,
        tT.data_ptr(), n_live.data_ptr(), prep.rot.data_ptr(), prep.rbox.data_ptr(), C, prep.tt,
        queries.data_ptr(), _ptr(query_mask), _ptr(seed),
        *((None,) * 4 if prev is None else (x.data_ptr() for x in prev)), int(window),
        int((seed is not None or prev is not None or window) and _list_prune(init_d2)),
        B, M, Q, k, init_d2, splits, _ptr(part_d2), _ptr(part_idx),
        idx.data_ptr(), d2.data_ptr(),
        coords[0].data_ptr(), coords[1].data_ptr(), coords[2].data_ptr(), _ptr(vis), _ptr(bnd),
    )
    knn_run.counter.add()
    return idx, d2, coords, vis, bnd


def knn_slots(prep: TargetPrep, queries, k: int, max_dist: float = 0.0, query_mask=None):
    """The search's raw slots for (B, Q, 3) queries: ``(idx, d2, (xs, ys,
    zs))``, each (B, k, Q), in (d2, index) order; a slot no target filled
    holds index 0, ``d2 = max_dist ** 2`` (+inf without a radius) and zero
    coordinates. The kernel where :func:`kernel_takes` the targets, the
    plain search elsewhere. :func:`knn_run` packs these; the sharded search
    (``parallel.distributed.sharded_knn``) merges them across shards."""
    return _slots(prep, queries, k, max_dist, query_mask, None, None, False, False,
                  plain=not kernel_takes(prep.tT))[:3]


def _slots(prep, q, k, max_dist, query_mask, seed_bound, seed_prev, seed_window, visits, plain):
    q = q.to(prep.tT.dtype).contiguous()
    qm = None if query_mask is None else query_mask.to(torch.bool).contiguous()
    init = _init_d2(max_dist)
    if plain:
        return _search_reference(prep, q, k, init, qm)
    seed = None if seed_bound is None else seed_bound.to(torch.float32).contiguous()
    prev = None if seed_prev is None else tuple(
        x.contiguous() for x in (seed_prev.xs, seed_prev.ys, seed_prev.zs, seed_prev.mask))
    idx, d2, coords, vis, _ = _search_kernel(prep, q, k, init, qm, seed, visits, prev=prev,
                                             window=seed_window)
    return idx, d2, coords, None if vis is None else vis[..., 0]


def pack_slots(idx, d2, coords, max_dist: float, with_coords: bool):
    """(B, k, Q) slots -> :class:`PackedKnn` (``with_coords``) or a
    ``KnnResult`` with (B, Q, k) leaves."""
    valid = torch.isfinite(d2)
    if max_dist > 0:
        # sqrt then strict <, as the reference (kdtree.cpp:24-26)
        valid = valid & (torch.sqrt(torch.clamp(d2, min=0.0)) < max_dist)
    if with_coords:
        return PackedKnn(idx[:, 0], valid, *coords)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    return KnnResult(idx.transpose(1, 2), torch.where(valid, dist, float("inf")).transpose(1, 2),
                     valid.transpose(1, 2))


def _run(prep, queries, k, max_dist, with_coords, query_mask, seed_bound, return_visits, plain,
         seed_prev=None, seed_window=False):
    lift = (lambda x: x) if prep.batched else (lambda x: x[None])
    qm = None if query_mask is None else lift(query_mask)
    sb = None if seed_bound is None else lift(seed_bound)
    sp = None if seed_prev is None else type(seed_prev)(*(lift(x) for x in seed_prev))
    idx, d2, coords, visits = _slots(prep, lift(queries), k, max_dist, qm, sb, sp, seed_window,
                                     return_visits, plain)
    out = pack_slots(idx, d2, coords, max_dist, with_coords)
    if not prep.batched:
        out = type(out)(*(x[0] for x in out))
    if not return_visits:
        return out
    return out, visits if prep.batched else visits[0]


def knn_run_reference(prep: TargetPrep, queries, k: int, max_dist: float = 0.0,
                      with_coords: bool = False, query_mask=None, seed_bound=None,
                      return_visits: bool = False, seed_prev=None, seed_window: bool = False):
    """Plain version of :func:`knn_run` (any device): it visits every slot,
    so the seed bounds prune nothing, and its visits are every live box."""
    return _run(prep, queries, k, max_dist, with_coords, query_mask, seed_bound, return_visits,
                plain=True)


def knn_run(prep: TargetPrep, queries, k: int, max_dist: float = 0.0,
            with_coords: bool = False, query_mask=None, seed_bound=None,
            return_visits: bool = False, seed_prev=None, seed_window: bool = False):
    """Search ``prep``'s targets with ``queries`` (Q, 3) / (B, Q, 3).

    ``with_coords=True`` returns a :class:`PackedKnn`, else a ``KnnResult``
    with (..., Q, k) leaves. ``query_mask`` (Q,) / (B, Q): masked queries
    skip the search and return empty lists. ``seed_bound`` (Q,) / (B, Q):
    an upper bound on each query's k-th smallest squared distance (+inf
    where unknown), e.g. :func:`seed_bound_from_packed` or
    :func:`seed_bound_from_window`; the kernel visits a box only where some
    query's lower bound is at most ``min(running k-th, seed_bound)``, so a
    sound bound removes visits and never changes an output. The port's
    ``seed_prev`` (the last search's :class:`PackedKnn` for the same query
    slots, or None) and ``seed_window`` have the kernel compute the ICF
    loop's warm and cold bounds itself, in its prologue, equal bit for bit
    to :func:`seed_bound_from_packed` and :func:`seed_bound_from_window`
    over :func:`window_candidates` of the prep's targets, with no launch of
    their own; the gate takes the smallest of those and ``seed_bound``.
    ``return_visits=True`` returns ``(result, visits)``: the boxes searched,
    an int32 per (pair, block of queries) of the kernel; the plain version
    counts every live box. The kernel runs where :func:`kernel_takes` the
    targets, the plain search everywhere else.
    """
    return _run(prep, queries, k, max_dist, with_coords, query_mask, seed_bound, return_visits,
                not kernel_takes(prep.tT), seed_prev, seed_window)


#: Kernel launches since the last reset (plain-version calls do not count;
#: read through IF-node bodies, ``program.Counted``).
knn_run = Counted(knn_run)


# ---- both classes in one launch (knn_pallas.py:778-998) --------------------


class DualTargetPrep(NamedTuple):
    """Loop-invariant target state of :func:`knn_dual_run`: the edge and the
    planar targets as one block of coordinate planes, edges first, and each
    class's own boxes (none straddles the two), edges first."""

    tT: torch.Tensor  # (B, 3, Me + Mp) float32 planes, sentinel at invalid slots
    n_edge: int  # Me: edge target slots (planar indices are relative to Me)
    batched: bool  # whether the caller passed a leading batch axis
    n_live: torch.Tensor  # (B, 2) int32 live-target bounds: edge, planar
    rot: torch.Tensor  # (B, 2, Ce + Cp) box directions, edge boxes first
    rbox: torch.Tensor  # (B, 6, Ce + Cp) boxes in their frames
    tt: int  # box length


def knn_dual_prep(t_edge, t_edge_mask, t_plane, t_plane_mask, tt=None) -> DualTargetPrep:
    """Target planes and boxes for :func:`knn_dual_run` from (M, 3) /
    (B, M, 3) edge and planar targets and their masks; ``tt`` is the box
    length (:func:`default_tt` of both classes' slots when not given)."""
    tt = tt or default_tt(t_edge.shape[-2] + t_plane.shape[-2])
    e = knn_prep(t_edge.to(torch.float32), t_edge_mask, tt)
    p = knn_prep(t_plane.to(torch.float32), t_plane_mask, tt)
    cat = lambda a, b: torch.cat([a, b], dim=-1).contiguous()
    return DualTargetPrep(cat(e.tT, p.tT), t_edge.shape[-2], e.batched,
                          torch.stack([e.n_live, p.n_live], dim=1), cat(e.rot, p.rot),
                          cat(e.rbox, p.rbox), tt)


def _edge_boxes(prep) -> int:
    return max(-(-prep.n_edge // prep.tt), 1)


def _dual_search_reference(prep, qe, qp, k, init_e, init_p):
    Me = prep.n_edge
    ie, de, _ = _search_planes(prep.tT[:, :, :Me], qe, k, init_e, None)
    ip, dp, _ = _search_planes(prep.tT[:, :, Me:], qp, k, init_p, None)
    n_live = prep.n_live
    return (ie, de, ip, dp, _plain_visits(n_live[:, 0], prep.tt, qe.shape[1], k),
            _plain_visits(n_live[:, 1], prep.tt, qp.shape[1], k))


def _dual_search_kernel(prep, qe, qp, k, init_e, init_p, visits=False):
    tT = prep.tT
    B, _, M = tT.shape
    Me = prep.n_edge
    E, P = qe.shape[1], qp.shape[1]
    if k < 1:
        raise ValueError(f"knn kernel needs k >= 1, got {k}")
    _build.require(tT, "targets", (torch.float32,), (B, 3, M))
    _build.require(prep.n_live, "n_live", (torch.int32,), (B, 2), tT.device)
    ne = _edge_boxes(prep)
    C = prep.rot.shape[-1]
    _build.require(prep.rot, "box directions", (torch.float32,), (B, 2, C), tT.device)
    _build.require(prep.rbox, "boxes", (torch.float32,), (B, 6, C), tT.device)
    _build.require(qe, "edge queries", (torch.float32,), (B, E, 3), tT.device)
    _build.require(qp, "planar queries", (torch.float32,), (B, P, 3), tT.device)
    dev = tT.device
    lib = _build.lib()
    s_e, s_p = _splits(B, ((E, Me), (P, M - Me)), k, prep.tt)
    part_d2, part_idx = _partial_lists(((B, s_e, k, E), (B, s_p, k, P)), dev)
    ie = torch.empty((B, k, E), dtype=torch.int32, device=dev)
    de = torch.empty((B, k, E), dtype=torch.float32, device=dev)
    ip = torch.empty((B, k, P), dtype=torch.int32, device=dev)
    dp = torch.empty((B, k, P), dtype=torch.float32, device=dev)
    bq = _block_queries(k, dev)
    ve, vp = ((torch.zeros((B, -(-n // bq), 2), dtype=torch.int32, device=dev) for n in (E, P))
              if visits else (None, None))
    _build.launch(
        lib.loam_knn_dual, "knn_dual", tT,
        tT.data_ptr(), prep.n_live.data_ptr(), prep.rot.data_ptr(), prep.rbox.data_ptr(),
        ne, C - ne, prep.tt, Me, M - Me, qe.data_ptr(), E,
        qp.data_ptr(), P, B, k, init_e, init_p, s_e, s_p,
        _ptr(part_d2), _ptr(part_idx), ie.data_ptr(), de.data_ptr(),
        ip.data_ptr(), dp.data_ptr(), _ptr(ve), _ptr(vp),
    )
    knn_dual_run.counter.add()
    return ie, de, ip, dp, ve, vp


def _unpack_class(idx, d2, kc, max_dist, batched):
    """(B, k, Q) slots -> KnnResult with (..., Q, kc) leaves, as
    ``knn_dual_run``'s ``unpack`` (:987-993): the first kc slots (ascending,
    so the kc nearest), index 0 and distance inf where not valid."""
    v = d2[:, :kc].transpose(1, 2)
    i = idx[:, :kc].transpose(1, 2)
    dist = torch.sqrt(torch.clamp(v, min=0.0))
    valid = torch.isfinite(v) & (dist < max_dist)
    res = KnnResult(torch.where(valid, i, 0), torch.where(valid, dist, float("inf")), valid)
    return res if batched else KnnResult(*(x[0] for x in res))


def _dual_run(prep, q_edge, q_plane, k_edge, k_plane, max_dist_edge, max_dist_plane,
              return_visits, plain):
    if not (max_dist_edge > 0 and max_dist_plane > 0):
        raise ValueError("the dual search needs both radii > 0")
    k = max(k_edge, k_plane)
    lift = (lambda x: x) if prep.batched else (lambda x: x[None])
    qe = lift(q_edge).to(torch.float32).contiguous()
    qp = lift(q_plane).to(torch.float32).contiguous()
    init_e, init_p = _init_d2(max_dist_edge), _init_d2(max_dist_plane)
    if plain:
        ie, de, ip, dp, ve, vp = _dual_search_reference(prep, qe, qp, k, init_e, init_p)
    else:
        ie, de, ip, dp, ve, vp = _dual_search_kernel(prep, qe, qp, k, init_e, init_p, return_visits)
        if return_visits:
            ve, vp = ve[..., 0], vp[..., 0]
    out = (_unpack_class(ie, de, k_edge, max_dist_edge, prep.batched),
           _unpack_class(ip, dp, k_plane, max_dist_plane, prep.batched))
    if not return_visits:
        return out
    return out, (ve, vp) if prep.batched else (ve[0], vp[0])


def knn_dual_run_reference(prep: DualTargetPrep, q_edge, q_plane, k_edge: int, k_plane: int,
                           max_dist_edge: float, max_dist_plane: float, tq=None,
                           return_visits: bool = False):
    """Plain version of :func:`knn_dual_run` (any device)."""
    return _dual_run(prep, q_edge, q_plane, k_edge, k_plane, max_dist_edge,
                     max_dist_plane, return_visits, plain=True)


def knn_dual_run(prep: DualTargetPrep, q_edge, q_plane, k_edge: int, k_plane: int,
                 max_dist_edge: float, max_dist_plane: float, tq=None,
                 return_visits: bool = False):
    """Edge queries (E, 3) / (B, E, 3) against the edge targets and planar
    queries against the planar targets of ``prep``, in one kernel launch.

    Returns ``(KnnResult_edges, KnnResult_planes)`` with (..., E, k_edge) /
    (..., P, k_plane) leaves, equal to two single searches with their own
    radii: invalid slots hold index 0 and distance inf, planar indices are
    relative to the planar targets. Both radii must be positive. There is no
    query mask and no seed bound (``loam_tpu`` passes neither): every query
    slot is searched, and association masks the invalid ones. ``tq`` is
    accepted for API compatibility and ignored. ``return_visits=True`` (the
    port's addition) also returns the boxes searched per block of queries,
    ``(edge, planar)``, as :func:`knn_run` does. The kernel runs where
    :func:`kernel_takes` the targets (always: the dual prep is float32),
    the plain search for CPU tensors.
    """
    return _dual_run(prep, q_edge, q_plane, k_edge, k_plane, max_dist_edge,
                     max_dist_plane, return_visits, plain=not kernel_takes(prep.tT))


#: Kernel launches since the last reset (plain-version calls do not count;
#: read through IF-node bodies, ``program.Counted``).
knn_dual_run = Counted(knn_dual_run)


def knn_pallas_dual(q_edge, q_plane, t_edge, t_edge_mask, t_plane, t_plane_mask,
                    k_edge: int, k_plane: int, max_dist_edge: float,
                    max_dist_plane: float, tq=None, tt=None):
    """Prep and run of the dual search in one call (``knn_pallas_dual``)."""
    prep = knn_dual_prep(t_edge, t_edge_mask, t_plane, t_plane_mask, tt)
    return knn_dual_run(prep, q_edge, q_plane, k_edge, k_plane, max_dist_edge, max_dist_plane)


def knn_pallas(queries, targets, target_mask, k: int, max_dist: float = 0.0, tq=None, tt=None):
    """Prep and run of the single search in one call (``knn_pallas``): the
    drop-in of ``neighbors.knn`` for (Q, 3) queries, a ``KnnResult``. ``tt``
    is the box length; ``tq`` (the Pallas query tile) is accepted for API
    compatibility and ignored."""
    return knn_run(knn_prep(targets, target_mask, tt), queries, k, max_dist)
