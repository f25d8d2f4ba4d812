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

Two things of the kernel's design are prepared here, from shapes and masks
alone and with no host sync. The preps carry ``n_live``, the index of each
pair's last valid target slot + 1: the kernel visits ``[0, n_live)`` only
(the voxel maps keep their valid slots as a prefix). :func:`split_plan`
chooses into how many ranges each class's targets are split across thread
blocks, so that one pair fills the card as well as four do; the wrapper
allocates the scratch for the partial lists. The plain versions use
neither: they visit every slot, and stay the independent statement of the
result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


class TargetPrep(NamedTuple):
    """Loop-invariant target state of :func:`knn_run`."""

    tT: torch.Tensor  # (B, 3, M) coordinate planes, sentinel at invalid slots
    batched: bool  # whether the caller passed a leading batch axis
    n_live: torch.Tensor  # (B,) int32: index of the last valid slot + 1


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


def knn_prep(targets: torch.Tensor, target_mask: torch.Tensor) -> TargetPrep:
    """Target planes for :func:`knn_run`: (M, 3) or (B, M, 3) targets and
    their (M,) / (B, M) mask -> (B, 3, M) planes (float64 stays float64,
    anything else becomes float32) with the sentinel at invalid slots, and
    the pairs' live-target bounds."""
    batched = targets.ndim == 3
    t = targets if batched else targets[None]
    m = (target_mask if batched else target_mask[None]).to(torch.bool)
    dtype = torch.float64 if t.dtype == torch.float64 else torch.float32
    t = torch.where(m[..., None], t.to(dtype), SENTINEL[dtype])
    return TargetPrep(t.transpose(-1, -2).contiguous(), batched, live_bound(m))


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


def _splits(B: int, classes, k: int):
    """:func:`split_plan` for the register lists; the wide form takes none."""
    if k > REGISTER_MAX_K:
        return (1,) * len(classes)
    return split_plan(B, classes, _build.lib().loam_knn_block_queries())


def _init_d2(max_dist: float) -> float:
    return float(max_dist) ** 2 if max_dist > 0 else float("inf")


def _search_reference(prep, queries, k, init_d2, query_mask):
    """Plain search: direct differences in query tiles, k argmin passes,
    over every target slot."""
    return _search_planes(prep.tT, queries, k, init_d2, query_mask)


def _search_planes(tT, queries, k, init_d2, query_mask):
    B, _, M = tT.shape
    Q = queries.shape[1]
    init = torch.tensor(init_d2, dtype=tT.dtype, device=tT.device)
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


def _search_kernel(prep, queries, k, init_d2, query_mask):
    tT, n_live = prep.tT, prep.n_live
    B, _, M = tT.shape
    Q = queries.shape[1]
    if k < 1:
        raise ValueError(f"knn kernel needs k >= 1, got {k}")
    _build.require(tT, "targets", (torch.float32,), (B, 3, M))
    _build.require(n_live, "n_live", (torch.int32,), (B,), tT.device)
    _build.require(queries, "queries", (torch.float32,), (B, Q, 3), tT.device)
    if query_mask is not None:
        _build.require(query_mask, "query_mask", (torch.bool,), (B, Q), tT.device)
    dev = tT.device
    lib = _build.lib()
    (splits,) = _splits(B, ((Q, M),), k)
    part_d2, part_idx = _partial_lists(((B, splits, k, Q),), dev)
    idx = torch.empty((B, k, Q), dtype=torch.int32, device=dev)
    d2 = torch.empty((B, k, Q), dtype=torch.float32, device=dev)
    coords = [torch.empty((B, k, Q), dtype=torch.float32, device=dev) for _ in range(3)]
    _build.launch(
        lib.loam_knn, "knn", tT,
        tT.data_ptr(), n_live.data_ptr(), queries.data_ptr(), _ptr(query_mask),
        B, M, Q, k, init_d2, splits, _ptr(part_d2), _ptr(part_idx),
        idx.data_ptr(), d2.data_ptr(),
        coords[0].data_ptr(), coords[1].data_ptr(), coords[2].data_ptr(),
    )
    knn_run.launches += 1
    return idx, d2, coords


def knn_slots(prep: TargetPrep, queries, k: int, max_dist: float = 0.0, query_mask=None):
    """The search's raw slots for (B, Q, 3) queries: ``(idx, d2, (xs, ys,
    zs))``, each (B, k, Q), in (d2, index) order; a slot no target filled
    holds index 0, ``d2 = max_dist ** 2`` (+inf without a radius) and zero
    coordinates. The kernel where :func:`kernel_takes` the targets, the
    plain search elsewhere. :func:`knn_run` packs these; the sharded search
    (``parallel.distributed.sharded_knn``) merges them across shards."""
    return _slots(prep, queries, k, max_dist, query_mask, plain=not kernel_takes(prep.tT))


def _slots(prep, q, k, max_dist, query_mask, plain):
    q = q.to(prep.tT.dtype).contiguous()
    qm = None if query_mask is None else query_mask.to(torch.bool).contiguous()
    search = _search_reference if plain else _search_kernel
    return search(prep, q, k, _init_d2(max_dist), qm)


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


def _run(prep, queries, k, max_dist, with_coords, query_mask, plain):
    lift = (lambda x: x) if prep.batched else (lambda x: x[None])
    qm = None if query_mask is None else lift(query_mask)
    idx, d2, coords = _slots(prep, lift(queries), k, max_dist, qm, plain)
    out = pack_slots(idx, d2, coords, max_dist, with_coords)
    return out if prep.batched else type(out)(*(x[0] for x in out))


def knn_run_reference(prep: TargetPrep, queries, k: int, max_dist: float = 0.0,
                      with_coords: bool = False, query_mask=None, seed_bound=None):
    """Plain version of :func:`knn_run` (any device)."""
    return _run(prep, queries, k, max_dist, with_coords, query_mask, plain=True)


def knn_run(prep: TargetPrep, queries, k: int, max_dist: float = 0.0,
            with_coords: bool = False, query_mask=None, seed_bound=None):
    """Search ``prep``'s targets with ``queries`` (Q, 3) / (B, Q, 3).

    ``with_coords=True`` returns a :class:`PackedKnn`, else a ``KnnResult``
    with (..., Q, k) leaves. ``query_mask`` (Q,) / (B, Q): masked queries
    skip the search and return empty lists. ``seed_bound`` is accepted for
    API compatibility with ``loam_tpu`` and ignored: in the Pallas kernel it
    only prunes visits, never changing an output. The kernel runs where
    :func:`kernel_takes` the targets, the plain search everywhere else.
    """
    return _run(prep, queries, k, max_dist, with_coords, query_mask,
                plain=not kernel_takes(prep.tT))


#: Kernel launches since the last reset (plain-version calls do not count).
knn_run.launches = 0


# ---- both classes in one launch (knn_pallas.py:778-998) --------------------


class DualTargetPrep(NamedTuple):
    """Loop-invariant target state of :func:`knn_dual_run`: the edge and the
    planar targets as one block of coordinate planes, edges first."""

    tT: torch.Tensor  # (B, 3, Me + Mp) float32 planes, sentinel at invalid slots
    n_edge: int  # Me: edge target slots (planar indices are relative to Me)
    batched: bool  # whether the caller passed a leading batch axis
    n_live: torch.Tensor  # (B, 2) int32 live-target bounds: edge, planar


def knn_dual_prep(t_edge, t_edge_mask, t_plane, t_plane_mask, tt=None) -> DualTargetPrep:
    """Target planes for :func:`knn_dual_run` from (M, 3) / (B, M, 3) edge and
    planar targets and their masks. ``tt`` (the Pallas chunk length) is
    accepted for API compatibility and ignored."""
    e = knn_prep(t_edge.to(torch.float32), t_edge_mask)
    p = knn_prep(t_plane.to(torch.float32), t_plane_mask)
    return DualTargetPrep(torch.cat([e.tT, p.tT], dim=2).contiguous(),
                          t_edge.shape[-2], e.batched,
                          torch.stack([e.n_live, p.n_live], dim=1))


def _dual_search_reference(prep, qe, qp, k, init_e, init_p):
    Me = prep.n_edge
    ie, de, _ = _search_planes(prep.tT[:, :, :Me], qe, k, init_e, None)
    ip, dp, _ = _search_planes(prep.tT[:, :, Me:], qp, k, init_p, None)
    return ie, de, ip, dp


def _dual_search_kernel(prep, qe, qp, k, init_e, init_p):
    tT = prep.tT
    B, _, M = tT.shape
    Me = prep.n_edge
    E, P = qe.shape[1], qp.shape[1]
    if k < 1:
        raise ValueError(f"knn kernel needs k >= 1, got {k}")
    _build.require(tT, "targets", (torch.float32,), (B, 3, M))
    _build.require(prep.n_live, "n_live", (torch.int32,), (B, 2), tT.device)
    _build.require(qe, "edge queries", (torch.float32,), (B, E, 3), tT.device)
    _build.require(qp, "planar queries", (torch.float32,), (B, P, 3), tT.device)
    dev = tT.device
    lib = _build.lib()
    s_e, s_p = _splits(B, ((E, Me), (P, M - Me)), k)
    part_d2, part_idx = _partial_lists(((B, s_e, k, E), (B, s_p, k, P)), dev)
    ie = torch.empty((B, k, E), dtype=torch.int32, device=dev)
    de = torch.empty((B, k, E), dtype=torch.float32, device=dev)
    ip = torch.empty((B, k, P), dtype=torch.int32, device=dev)
    dp = torch.empty((B, k, P), dtype=torch.float32, device=dev)
    _build.launch(
        lib.loam_knn_dual, "knn_dual", tT,
        tT.data_ptr(), prep.n_live.data_ptr(), Me, M - Me, qe.data_ptr(), E,
        qp.data_ptr(), P, B, k, init_e, init_p, s_e, s_p,
        _ptr(part_d2), _ptr(part_idx), ie.data_ptr(), de.data_ptr(),
        ip.data_ptr(), dp.data_ptr(),
    )
    knn_dual_run.launches += 1
    return ie, de, ip, dp


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


def _dual_run(prep, q_edge, q_plane, k_edge, k_plane, max_dist_edge, max_dist_plane, plain):
    if not (max_dist_edge > 0 and max_dist_plane > 0):
        raise ValueError("the dual search needs both radii > 0")
    k = max(k_edge, k_plane)
    lift = (lambda x: x) if prep.batched else (lambda x: x[None])
    qe = lift(q_edge).to(torch.float32).contiguous()
    qp = lift(q_plane).to(torch.float32).contiguous()
    search = _dual_search_reference if plain else _dual_search_kernel
    ie, de, ip, dp = search(prep, qe, qp, k, _init_d2(max_dist_edge), _init_d2(max_dist_plane))
    return (_unpack_class(ie, de, k_edge, max_dist_edge, prep.batched),
            _unpack_class(ip, dp, k_plane, max_dist_plane, prep.batched))


def knn_dual_run_reference(prep: DualTargetPrep, q_edge, q_plane, k_edge: int, k_plane: int,
                           max_dist_edge: float, max_dist_plane: float, tq=None):
    """Plain version of :func:`knn_dual_run` (any device)."""
    return _dual_run(prep, q_edge, q_plane, k_edge, k_plane, max_dist_edge,
                     max_dist_plane, plain=True)


def knn_dual_run(prep: DualTargetPrep, q_edge, q_plane, k_edge: int, k_plane: int,
                 max_dist_edge: float, max_dist_plane: float, tq=None):
    """Edge queries (E, 3) / (B, E, 3) against the edge targets and planar
    queries against the planar targets of ``prep``, in one kernel launch.

    Returns ``(KnnResult_edges, KnnResult_planes)`` with (..., E, k_edge) /
    (..., P, k_plane) leaves, equal to two single searches with their own
    radii: invalid slots hold index 0 and distance inf, planar indices are
    relative to the planar targets. Both radii must be positive. There is no
    query mask (``loam_tpu`` passes none either): every query slot is
    searched, and association masks the invalid ones. ``tq`` is accepted
    for API compatibility and ignored. The kernel runs where
    :func:`kernel_takes` the targets (always: the dual prep is float32),
    the plain search for CPU tensors.
    """
    return _dual_run(prep, q_edge, q_plane, k_edge, k_plane, max_dist_edge,
                     max_dist_plane, plain=not kernel_takes(prep.tT))


#: Kernel launches since the last reset (plain-version calls do not count).
knn_dual_run.launches = 0


def knn_pallas_dual(q_edge, q_plane, t_edge, t_edge_mask, t_plane, t_plane_mask,
                    k_edge: int, k_plane: int, max_dist_edge: float,
                    max_dist_plane: float, tq=None, tt=None):
    """Prep and run of the dual search in one call (``knn_pallas_dual``)."""
    prep = knn_dual_prep(t_edge, t_edge_mask, t_plane, t_plane_mask)
    return knn_dual_run(prep, q_edge, q_plane, k_edge, k_plane, max_dist_edge, max_dist_plane)


def knn_pallas(queries, targets, target_mask, k: int, max_dist: float = 0.0, tq=None, tt=None):
    """Prep and run of the single search in one call (``knn_pallas``): the
    drop-in of ``neighbors.knn`` for (Q, 3) queries, a ``KnnResult``. ``tq``
    and ``tt`` (the Pallas tiles) are accepted for API compatibility and
    ignored."""
    return knn_run(knn_prep(targets, target_mask), queries, k, max_dist)
