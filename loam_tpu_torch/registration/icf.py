"""Iterative Closest Feature: the outer registration loop, lockstep over pairs.

Counterpart of ``loam_tpu.registration.icf`` (reference ``registerFeatures``,
``registration-inl.h:11-78``), with the reference's termination semantics:

  * ``INSUFFICIENT_ASSOCIATIONS`` bails before solving -- the returned pose is
    the estimate entering that iteration, which records no diagnostics
    (SURVEY 2.3(9));
  * convergence is checked after the update is applied (SURVEY 2.3(10));
  * the update composes on the left, ``est = delta o est``.

``loam_tpu`` runs one ``while_loop`` per pair under ``vmap``; here the pairs
are a batch axis. Every outer iteration runs the body for all pairs, computes
both the solve and the insufficient-associations branch and selects between
them, and commits the result only for pairs still running (``torch.where``),
so a finished pair's state stays as it was. The loop stops when every pair
is done or ``max_iterations`` is reached. The body is ``loop.py``'s step
over a carry of its own, scheduled as ``lax.while_loop`` runs it; the whole
registration (sort, preps or grids, loop) is one program on the kNN paths,
the grid path and the sharded path: eager on the CPU, one CUDA-graph replay
on the card with the later iterations under one WHILE node; eager, by
design, only for a caller's ``custom_knn`` and ``LOAM_DEBUG_NANS=1``.

Each iteration searches the edge and the planar targets either with two
single kNN runs (neighbour coordinates packed, fits without a gather) or,
with ``LOAM_ICF_DUAL_KNN=1``, with one dual run whose indices feed the
gathered fits -- ``loam_tpu``'s switch between the same two algorithms
(``icf.py:405-440``), read per call here. The single search with the kernel
carries ``loam_tpu``'s seed bounds (``icf.py:321-329, 392-400, 442-455,
478-505``, ``LOAM_KNN_SEED``, default ``"1"``): each iteration the kernel
gates its visits, per query, on the smaller of the last iteration's
neighbours' distances at the moved query (warm start) and the k-th distance
to the targets at the same sorted rank (cold start). The kernel computes
both in its prologue from the last result; a 3-element ``custom_knn`` gets
them as a tensor. They only prune the kernel's visits. Where the kernel
searches, ``reorder_mode="auto"`` (``loam_tpu``'s default, ``icf.py:256-290``)
azimuth-sorts both feature sets first, so that the gate has wedges to prune;
the drivers whose features are stored sorted pass ``"none"``. With ``search_backend="grid"`` and
both radii positive the searches go through voxel grids built once per
registration (``neighbors/grid.py``; ``loam_tpu`` ``icf.py:315-360``), before
the loop's WHILE node: their indices feed the gathered fits too, and every
iteration's count of cells over ``grid_max_per_cell`` is recorded in the
detail, inside the node.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from .. import program
from ..debug import debug_nans_enabled
from ..features.types import FeatureSet
from ..geometry import Pose3
from ..neighbors.grid import build_grid
from ..ops.knn_cuda import kernel_takes, knn_dual_prep, knn_prep
from ..ops.morton import morton_key
from ..params import RegistrationParams, TerminationType
from .detail import RegistrationDetail, tree_map
from .loop import CAPTURED_PATHS, _Loop, _eager, knob_key


def _permute_features(fs: FeatureSet, e_perm: torch.Tensor, p_perm: torch.Tensor) -> FeatureSet:
    """``fs`` with its edge slots in the order ``e_perm`` and its planar
    slots in the order ``p_perm``; leading axes batch."""

    def g(points, mask, idxs, order):
        return (
            torch.gather(points, -2, order[..., None].expand(points.shape)),
            torch.gather(mask, -1, order),
            torch.gather(idxs, -1, order),
        )

    return FeatureSet(*g(fs.edge_points, fs.edge_mask, fs.edge_indices, e_perm),
                      *g(fs.planar_points, fs.planar_mask, fs.planar_indices, p_perm))


def _sort_features(fs: FeatureSet, key_fn, with_perms: bool = False):
    """``fs`` with edge and planar slots stably sorted by ``key_fn(points,
    mask)``; leading axes batch. ``with_perms`` also returns the two
    orders (sorted slot i holds the caller's slot ``perm[i]``)."""
    e_perm = torch.sort(key_fn(fs.edge_points, fs.edge_mask), dim=-1, stable=True)[1]
    p_perm = torch.sort(key_fn(fs.planar_points, fs.planar_mask), dim=-1, stable=True)[1]
    out = _permute_features(fs, e_perm, p_perm)
    return (out, e_perm, p_perm) if with_perms else out


def _azimuth_key(points, mask):
    az = torch.atan2(points[..., 1], points[..., 0])
    return torch.where(mask, az, torch.full_like(az, 1e9))


def azimuth_sort_features(fs: FeatureSet) -> FeatureSet:
    """``fs`` with edge and planar slots stably sorted by azimuth
    ``atan2(y, x)``, masked slots (key 1e9) last. Leading axes batch."""
    return _sort_features(fs, _azimuth_key)


def spatial_sort_features(fs: FeatureSet, cell_size: float = 1.0) -> FeatureSet:
    """``fs`` with edge and planar slots stably sorted by the Morton key of
    their sensor-frame position on a ``cell_size`` grid, masked slots (key
    int32 max) last (``loam_tpu``'s order for scan-to-map sources, which
    matches the voxel maps' Morton-sorted storage). Leading axes batch."""

    def key(points, mask):
        return torch.where(mask, morton_key(points, cell_size),
                           torch.iinfo(torch.int32).max)

    return _sort_features(fs, key)


def _use_dual_knn(params: RegistrationParams, dtype) -> bool:
    """``loam_tpu``'s fused-search switch (``icf.py:412-418``) with its
    conditions (``:268-275``): ``LOAM_ICF_DUAL_KNN=1`` (default ``"0"``),
    the brute-force backend, both radii positive, float32. It picks the
    algorithm, not the implementation: the dual search is a kernel on a CUDA
    tensor and its plain version on a CPU tensor, as every search is."""
    return (
        os.environ.get("LOAM_ICF_DUAL_KNN", "0") == "1"
        and dtype == torch.float32
        and params.search_backend == "bruteforce"
        and params.max_edge_neighbor_dist > 0
        and params.max_plane_neighbor_dist > 0
    )


def _unpermute_matches(match: torch.Tensor, s_perm: torch.Tensor, t_perm: torch.Tensor):
    """(B, I, Q) match indices of sorted feature sets back in the caller's
    slots (``loam_tpu`` ``icf.py:617-640``): sorted source row i is the
    caller's slot ``s_perm[i]``, a sorted target value v its slot
    ``t_perm[v]``; -1 stays -1."""
    B = match.shape[0]
    flat = torch.gather(t_perm, -1, torch.clamp(match, min=0).reshape(B, -1).long())
    vals = torch.where(match >= 0, flat.reshape(match.shape).to(match.dtype), -1)
    return torch.full_like(match, -1).scatter(-1, s_perm[:, None].expand(match.shape), vals)


def _use_seed() -> bool:
    """``loam_tpu``'s seed-bound switch (``LOAM_KNN_SEED``, default ``"1"``):
    an algorithm for pruning the kernel's visits, never a change of output."""
    return os.environ.get("LOAM_KNN_SEED", "1") != "0"


def _register_impl(
    source: FeatureSet,
    target: FeatureSet,
    init: Pose3,
    params: RegistrationParams,
    with_matches: bool,
    custom_knn=None,
    target_preps=None,
    reorder_mode: str = "auto",
    sharded=None,
) -> Tuple[Pose3, RegistrationDetail]:
    """Register batched feature sets ((B, ...) leaves) from ``init`` (B poses).

    ``custom_knn``: optional ``(edge_fn, plane_fn)``, each mapping the moved
    queries (B, Q, 3) to a ``PackedKnn`` with (B, k, Q) leaves (or a
    ``KnnResult``, whose indices then address ``target``): a caller's own
    search, as ``loam_tpu``'s ``custom_knn`` (``icf.py:222-250``), run
    eagerly (it may read the host). With it, the target is neither
    prepared nor searched here. The 3-element form ``(edge_fn,
    plane_fn, seed_windows)`` is ``loam_tpu``'s too: ``seed_windows`` is the
    ``(edge, planar)`` pair of :func:`window_candidates` tuples, each leaf
    (B, w, Q); the callables then take a second argument, the (B, Q) seed
    bound, and return a ``PackedKnn`` (its coordinates feed the next
    iteration's warm start).

    ``sharded``: optional ``parallel.distributed.ShardedSearch``, the
    sharded registration's path (``"sharded"``): ``target``'s leaves are
    this rank's shards of its mesh, searched by the sharded kNN (``hooks``,
    prepared inside the program), the neighbour lists merged over the
    mesh; cached as the kNN paths are, its key holding the mesh's token.

    ``target_preps``: optional ``(edge, planar)`` :class:`TargetPrep` of
    ``target`` already built (the scan-to-map prep cache): the single
    search uses them and prepares nothing, with the kernel's own seeds.

    ``reorder_mode`` (``loam_tpu``'s ``_register`` argument, ``icf.py:
    256-290``): ``"auto"`` azimuth-sorts both feature sets before the loop
    where the kernel searches (float32 on the card, the brute-force backend,
    both radii, no ``custom_knn`` or ``target_preps``), so the query blocks
    and the target boxes cover narrow wedges and the gate prunes; the detail's
    match indices are mapped back to the caller's slots. ``"none"`` keeps the
    order, for callers whose features are sorted already. Only the order of
    equal-distance neighbours and of the fits' sums can differ.
    """
    if reorder_mode not in ("auto", "none"):
        raise ValueError(f"reorder_mode must be 'auto' or 'none', got {reorder_mode!r}")
    dtype, dev = source.edge_points.dtype, source.edge_points.device
    reorder = (reorder_mode == "auto" and custom_knn is None and sharded is None
               and target_preps is None
               and kernel_takes(source.edge_points) and kernel_takes(target.edge_points)
               and params.search_backend == "bruteforce"
               and params.max_edge_neighbor_dist > 0 and params.max_plane_neighbor_dist > 0)
    # The grid needs both radii (its cell sizes); without them the "grid"
    # backend searches by brute force, as loam_tpu's does.
    radii = params.max_edge_neighbor_dist > 0 and params.max_plane_neighbor_dist > 0
    if sharded is not None:
        path = "sharded"
    elif custom_knn is not None:
        path = "custom"
    elif target_preps is None and params.search_backend == "grid" and radii:
        path = "grid"
    elif target_preps is None and _use_dual_knn(params, dtype):
        path = "dual"
    else:
        path = "preps" if target_preps is not None else "single"
    # where loam_tpu's carry runs: its kernel with both radii (icf.py:
    # 268-275, 392-400), here computed by the kernel itself; the plain search
    # (a CPU tensor, float64) visits everything, so there is nothing to prune
    t_f32 = (target_preps[0].tT.dtype if target_preps is not None else target.edge_points.dtype) \
        != torch.float64
    kernel_seed = path in ("single", "preps") and dev.type == "cuda" and t_f32 and radii and _use_seed()
    tgt = tuple(target_preps) if target_preps is not None else target

    def body(source, init, tgt):
        return _register_body(source, tgt, init, params, with_matches, path,
                              sharded if sharded is not None else custom_knn, reorder, kernel_seed)

    if path not in CAPTURED_PATHS or debug_nans_enabled() or program.nested():
        return body(source, init, tgt)
    inputs = (source, init, tgt)
    key = ("registration", path, kernel_seed, with_matches, reorder, params,
           program.signature(inputs), knob_key()) + (sharded.key if sharded is not None else ())
    mesh = dict(mesh=sharded.mesh.token) if sharded is not None else {}
    prog = program.cached(dev, key, inputs, path=path, seeded=kernel_seed, dtype=str(dtype),
                          pairs=source.edge_mask.shape[0], edge_slots=source.edge_mask.shape[1],
                          planar_slots=source.planar_mask.shape[1], **mesh)
    return prog.own(prog.run(lambda b: body(*b), inputs))


def _register_body(source: FeatureSet, target, init: Pose3, params: RegistrationParams,
                   with_matches: bool, path: str, search_with, reorder: bool, kernel_seed: bool):
    """:func:`_register_impl`'s work once its path is chosen: the feature
    sort, the search's preparation, the loop and the matches mapped back.
    ``target`` is the target :class:`FeatureSet`, or on the ``preps`` path
    the ``(edge, planar)`` :class:`TargetPrep`. ``search_with``: the
    ``custom_knn`` of the ``custom`` path, the ``ShardedSearch`` of the
    ``sharded`` path."""
    if reorder:
        source, se, sp = _sort_features(source, _azimuth_key, with_perms=True)
        target, te, tp = _sort_features(target, _azimuth_key, with_perms=True)
    # the targets are fixed across outer iterations: prepare them once
    if path == "preps":
        # the packed fits read no target: the preps are the search's whole input
        search, tgt = target, None
    else:
        gathered = (target.edge_points, target.edge_mask, target.planar_points, target.planar_mask)
        tgt = gathered
        if path == "custom":
            windows = search_with[2] if len(search_with) > 2 and _use_seed() else None
            search = (search_with[0], search_with[1], windows)
        elif path == "sharded":
            search = (*search_with.hooks(source, target, params), None)
        elif path == "grid":
            search = (build_grid(target.edge_points, target.edge_mask, params.max_edge_neighbor_dist),
                      build_grid(target.planar_points, target.planar_mask,
                                 params.max_plane_neighbor_dist))
        elif path == "dual":
            search = (knn_dual_prep(*gathered),)
        else:
            search, tgt = (knn_prep(target.edge_points, target.edge_mask),
                           knn_prep(target.planar_points, target.planar_mask)), None
    src = (source.edge_points, source.edge_mask, source.planar_points, source.planar_mask)
    loop = _Loop(path, params, with_matches, kernel_seed, src, init, search, tgt)
    loop.schedule()
    est, status, it, detail = loop.results()
    if reorder and with_matches:
        detail = detail._replace(edge_match=_unpermute_matches(detail.edge_match, se, te),
                                 plane_match=_unpermute_matches(detail.plane_match, sp, tp))
    n_rec = torch.where(status == TerminationType.INSUFFICIENT_ASSOCIATIONS, it - 1, it)
    return est, RegistrationDetail(detail, status, n_rec.to(torch.int32))


def _register_eager(*args, **kwargs) -> Tuple[Pose3, RegistrationDetail]:
    """:func:`_register_impl` on the eager loop whatever the path: the plain
    version the CUDA graphs are held against."""
    with _eager():
        return _register_impl(*args, **kwargs)


def register_features_batch(
    source: FeatureSet,
    target: FeatureSet,
    target_T_source_init: Pose3,
    params: RegistrationParams = RegistrationParams(),
    with_matches: bool = False,
    reorder_mode: str = "auto",
) -> Tuple[Pose3, RegistrationDetail]:
    """Batched multi-pair registration: every leaf carries a leading pair
    axis, and the pairs run in lockstep until all have terminated.
    ``reorder_mode``: as ``_register_impl``'s."""
    return _register_impl(source, target, target_T_source_init, params, with_matches,
                          reorder_mode=reorder_mode)


def register_features(
    source: FeatureSet,
    target: FeatureSet,
    target_T_source_init: Optional[Pose3] = None,
    params: RegistrationParams = RegistrationParams(),
    with_matches: bool = True,
    reorder_mode: str = "auto",
) -> Tuple[Pose3, RegistrationDetail]:
    """Register a source feature set to a target feature set (reference
    ``registerFeatures``, ``registration.h:128-131``): the refined
    ``target_T_source`` and fixed-shape diagnostics. ``reorder_mode``: as
    ``_register_impl``'s."""
    if target_T_source_init is None:
        target_T_source_init = Pose3.identity(
            source.edge_points.dtype, device=source.edge_points.device
        )
    add = lambda x: x[None]
    est, det = _register_impl(
        source.map(add), target.map(add),
        Pose3(add(target_T_source_init.rotation), add(target_T_source_init.translation)),
        params, with_matches, reorder_mode=reorder_mode,
    )
    return Pose3(est.rotation[0], est.translation[0]), tree_map(lambda x: x[0], det)
