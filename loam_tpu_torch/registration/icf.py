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
is done or ``max_iterations`` is reached: one host sync per iteration.

Each iteration searches the edge and the planar targets either with two
single kNN runs (neighbour coordinates packed, fits without a gather) or,
with ``LOAM_ICF_DUAL_KNN=1``, with one dual run whose indices feed the
gathered fits -- ``loam_tpu``'s switch between the same two algorithms
(``icf.py:405-440``), read per call here. With ``search_backend="grid"`` and
both radii positive the searches go through voxel grids built once per
registration (``neighbors/grid.py``; ``loam_tpu`` ``icf.py:315-360``): their
indices feed the gathered fits too, and every iteration's count of cells over
``grid_max_per_cell`` is recorded in the detail.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..debug import tap_finite
from ..features.types import FeatureSet
from ..geometry import Pose3, norm, quat_multiply, quat_normalize, quat_rotate
from ..neighbors.grid import build_grid, knn_grid
from ..ops.knn_cuda import knn_dual_prep, knn_dual_run, knn_prep, knn_run
from ..ops.morton import morton_key
from ..params import RegistrationParams, TerminationType
from .associate import associate_edges, associate_planes
from .detail import IterationInfo, RegistrationDetail, tree_map
from .solver import _Problem, _select, lm_solve


def _angle_from_identity(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle of a unit quaternion (Eigen ``angularDistance`` to I)."""
    return 2.0 * torch.atan2(norm(q[..., 1:]), torch.abs(q[..., 0]))


def _sort_features(fs: FeatureSet, key_fn) -> FeatureSet:
    """``fs`` with edge and planar slots stably sorted by ``key_fn(points,
    mask)``; leading axes batch."""

    def s(points, mask, idxs):
        _, order = torch.sort(key_fn(points, mask), dim=-1, stable=True)
        return (
            torch.gather(points, -2, order[..., None].expand(points.shape)),
            torch.gather(mask, -1, order),
            torch.gather(idxs, -1, order),
        )

    ep, em, ei = s(fs.edge_points, fs.edge_mask, fs.edge_indices)
    pp, pm, pi = s(fs.planar_points, fs.planar_mask, fs.planar_indices)
    return FeatureSet(ep, em, ei, pp, pm, pi)


def azimuth_sort_features(fs: FeatureSet) -> FeatureSet:
    """``fs`` with edge and planar slots stably sorted by azimuth
    ``atan2(y, x)``, masked slots (key 1e9) last. Leading axes batch."""

    def key(points, mask):
        az = torch.atan2(points[..., 1], points[..., 0])
        return torch.where(mask, az, torch.full_like(az, 1e9))

    return _sort_features(fs, key)


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


def _register_impl(
    source: FeatureSet,
    target: FeatureSet,
    init: Pose3,
    params: RegistrationParams,
    with_matches: bool,
) -> Tuple[Pose3, RegistrationDetail]:
    """Register batched feature sets ((B, ...) leaves) from ``init`` (B poses)."""
    dtype = source.edge_points.dtype
    dev = source.edge_points.device
    B, E = source.edge_mask.shape
    Q = source.planar_mask.shape[1]
    I = params.max_iterations
    Em = E if with_matches else 0
    Qm = Q if with_matches else 0
    i32 = dict(dtype=torch.int32, device=dev)

    init = Pose3(init.rotation.to(dtype), init.translation.to(dtype))
    est = init
    it = torch.zeros(B, **i32)
    status = torch.full((B,), TerminationType.MAX_ITER, **i32)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    detail = IterationInfo(
        target_T_source_init=Pose3.identity(dtype, (B, I), dev),
        estimate_update=Pose3.identity(dtype, (B, I), dev),
        edge_match=torch.full((B, I, Em), -1, **i32),
        plane_match=torch.full((B, I, Qm), -1, **i32),
        edge_count=torch.zeros((B, I), **i32),
        plane_count=torch.zeros((B, I), **i32),
        edge_knn_overflow=torch.zeros((B, I), **i32),
        plane_knn_overflow=torch.zeros((B, I), **i32),
    )

    # the targets are fixed across outer iterations: prepare them once.
    # The grid needs both radii (its cell sizes); without them the "grid"
    # backend searches by brute force, as loam_tpu's does.
    use_grid = (params.search_backend == "grid" and params.max_edge_neighbor_dist > 0
                and params.max_plane_neighbor_dist > 0)
    dual = _use_dual_knn(params, dtype)
    if use_grid:
        edge_grid = build_grid(target.edge_points, target.edge_mask, params.max_edge_neighbor_dist)
        plane_grid = build_grid(target.planar_points, target.planar_mask,
                                params.max_plane_neighbor_dist)
    elif dual:
        d_prep = knn_dual_prep(target.edge_points, target.edge_mask,
                               target.planar_points, target.planar_mask)
    else:
        e_prep = knn_prep(target.edge_points, target.edge_mask)
        p_prep = knn_prep(target.planar_points, target.planar_mask)
    init_inv = init.inverse()
    identity = Pose3.identity(dtype, (B,), dev)
    iters = torch.arange(I, **i32)

    running = ~done & (it < I)
    while bool(running.any()):
        qe = quat_rotate(est.rotation[:, None], source.edge_points) + est.translation[:, None]
        qp = quat_rotate(est.rotation[:, None], source.planar_points) + est.translation[:, None]
        if use_grid:
            # indices into the unsorted targets: the gathered fits
            e_res, e_ovf = knn_grid(edge_grid, qe, params.num_edge_neighbors,
                                    params.max_edge_neighbor_dist, params.grid_max_per_cell)
            p_res, p_ovf = knn_grid(plane_grid, qp, params.num_plane_neighbors,
                                    params.max_plane_neighbor_dist, params.grid_max_per_cell)
        elif dual:
            # one launch for both classes; its KnnResults take the gathered
            # fits (loam_tpu icf.py:474-477)
            e_res, p_res = knn_dual_run(
                d_prep, qe, qp, params.num_edge_neighbors, params.num_plane_neighbors,
                params.max_edge_neighbor_dist, params.max_plane_neighbor_dist)
        else:
            e_res = knn_run(e_prep, qe, params.num_edge_neighbors,
                            params.max_edge_neighbor_dist, with_coords=True,
                            query_mask=source.edge_mask)
            p_res = knn_run(p_prep, qp, params.num_plane_neighbors,
                            params.max_plane_neighbor_dist, with_coords=True,
                            query_mask=source.planar_mask)
        ea = associate_edges(qe, source.edge_mask, target.edge_points,
                             target.edge_mask, params, knn_result=e_res)
        pa = associate_planes(qp, source.planar_mask, target.planar_points,
                              target.planar_mask, params, knn_result=p_res)
        n_edge = torch.sum(ea.valid, dim=-1, dtype=torch.int32)
        n_plane = torch.sum(pa.valid, dim=-1, dtype=torch.int32)
        insufficient = (n_edge + n_plane) < params.min_associations

        problem = _Problem(qe, ea, qp, pa, prior_offset=est.compose(init_inv))
        solved, _ = lm_solve(problem, params)
        # both branches of loam_tpu's lax.cond, selected per pair
        delta = Pose3(_select(insufficient, identity.rotation, solved.rotation),
                      _select(insufficient, identity.translation, solved.translation))
        new_est = Pose3(
            quat_normalize(quat_multiply(delta.rotation, est.rotation)),
            quat_rotate(delta.rotation, est.translation) + delta.translation,
        )
        # LOAM_DEBUG_NANS=1 checks every iteration's values (no-op otherwise)
        tap_finite({"delta": delta, "est": new_est, "lines": ea.line_a, "planes": pa.normal},
                   where="icf.iteration")
        converged = (_angle_from_identity(delta.rotation) < params.rotation_convergence_thresh) & (
            norm(delta.translation) < params.position_convergence_thresh
        )
        step_status = torch.where(
            insufficient,
            TerminationType.INSUFFICIENT_ASSOCIATIONS,
            torch.where(converged, TerminationType.CONVERGED, TerminationType.MAX_ITER),
        ).to(torch.int32)

        # record this iteration's row (none for an insufficient one, none
        # for a pair that already stopped): iota compare, no scatter
        hit = (iters[None, :] == it[:, None]) & (running & ~insufficient)[:, None]

        def put(buf, val):
            h = hit.reshape(hit.shape + (1,) * (buf.ndim - 2))
            return torch.where(h, val[:, None], buf)

        detail = IterationInfo(
            target_T_source_init=Pose3(put(detail.target_T_source_init.rotation, est.rotation),
                                       put(detail.target_T_source_init.translation, est.translation)),
            estimate_update=Pose3(put(detail.estimate_update.rotation, delta.rotation),
                                  put(detail.estimate_update.translation, delta.translation)),
            edge_match=put(detail.edge_match, ea.match[:, :Em]),
            plane_match=put(detail.plane_match, pa.match[:, :Qm]),
            edge_count=put(detail.edge_count, n_edge),
            plane_count=put(detail.plane_count, n_plane),
            # only the grid can overflow; the exact searches leave the zeros
            edge_knn_overflow=put(detail.edge_knn_overflow, e_ovf) if use_grid
            else detail.edge_knn_overflow,
            plane_knn_overflow=put(detail.plane_knn_overflow, p_ovf) if use_grid
            else detail.plane_knn_overflow,
        )
        commit = running & ~insufficient
        est = Pose3(_select(commit, new_est.rotation, est.rotation),
                    _select(commit, new_est.translation, est.translation))
        status = torch.where(running, step_status, status)
        done = torch.where(running, insufficient | converged, done)
        it = it + running.to(torch.int32)
        running = ~done & (it < I)

    n_rec = torch.where(status == TerminationType.INSUFFICIENT_ASSOCIATIONS, it - 1, it)
    return est, RegistrationDetail(detail, status, n_rec.to(torch.int32))


def register_features_batch(
    source: FeatureSet,
    target: FeatureSet,
    target_T_source_init: Pose3,
    params: RegistrationParams = RegistrationParams(),
    with_matches: bool = False,
) -> Tuple[Pose3, RegistrationDetail]:
    """Batched multi-pair registration: every leaf carries a leading pair
    axis, and the pairs run in lockstep until all have terminated."""
    return _register_impl(source, target, target_T_source_init, params, with_matches)


def register_features(
    source: FeatureSet,
    target: FeatureSet,
    target_T_source_init: Optional[Pose3] = None,
    params: RegistrationParams = RegistrationParams(),
    with_matches: bool = True,
) -> Tuple[Pose3, RegistrationDetail]:
    """Register a source feature set to a target feature set (reference
    ``registerFeatures``, ``registration.h:128-131``): the refined
    ``target_T_source`` and fixed-shape diagnostics."""
    if target_T_source_init is None:
        target_T_source_init = Pose3.identity(
            source.edge_points.dtype, device=source.edge_points.device
        )
    add = lambda x: x[None]
    est, det = _register_impl(
        source.map(add), target.map(add),
        Pose3(add(target_T_source_init.rotation), add(target_T_source_init.translation)),
        params, with_matches,
    )
    return Pose3(est.rotation[0], est.translation[0]), tree_map(lambda x: x[0], det)
