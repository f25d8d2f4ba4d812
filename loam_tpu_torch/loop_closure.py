"""Loop-closure detection and trajectory optimization.

Counterpart of ``loam_tpu.loop_closure``: detect revisits by trajectory
proximity, verify each candidate by feature registration, and feed the
accepted closures plus the odometry chain into the pose-graph optimizer.

The K candidates are a batch axis throughout: candidate selection is a
masked top-K over the pairwise keyframe-distance matrix (``topk_min``, so
equal distances keep the first index, where ``torch.topk`` promises no
order), verification is one ``register_features_batch`` over the K pairs in
lockstep (``loam_tpu`` runs one registration per candidate under ``vmap``;
the lockstep loop leaves a finished pair as it was, so every pair ends with
the same termination and iteration count), and a rejected closure becomes a
masked pose-graph edge, with no branch on the host.

:func:`propose_candidates` and :func:`optimize_trajectory_with_closures` are
one program a call each (``program.py``), as ``loam_tpu`` jits them: eager
on the CPU, one CUDA-graph launch on the card. The end-to-end call runs its
four pieces inline in its one program -- the proposal, the verification
(the registration's ICF loop a WHILE node, ``closure_quality``'s two kNN
launches), the edges (N - 1 + K, static) and the pose-graph solve (its LM
iterations a WHILE node) -- and equals calling them one after another.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import program
from .features.types import FeatureSet
from .geometry import Pose3, norm, quat_conjugate, quat_multiply, quat_rotate
from .neighbors.bruteforce import topk_min
from .ops.knn_cuda import knn_prep, knn_run
from .params import RegistrationParams, TerminationType
from .pose_graph import PoseGraphEdges, odometry_edges, optimize_pose_graph
from .registration.associate import associate_edges, associate_planes
from .registration.icf import register_features_batch
from .registration.loop import driver_program
from .registration.solver import _act, _Problem, _residuals


class LoopClosures(NamedTuple):
    """K candidate/verified closures ((K,) leaves; invalid slots masked)."""

    i: torch.Tensor  # (K,) earlier keyframe
    j: torch.Tensor  # (K,) later keyframe
    measurement: Pose3  # (K, ...) i_T_j from verification
    accepted: torch.Tensor  # (K,) bool
    inlier_frac: torch.Tensor  # (K,) associated fraction of source features
    mean_residual: torch.Tensor  # (K,) mean |point-to-feature| residual at est


def propose_candidates(
    trajectory: Pose3,
    max_candidates: int = 8,
    min_separation: int = 10,
    max_distance: float = 3.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-K closest (i, j) keyframe pairs with ``j - i >= min_separation``.

    Returns (i, j, valid), each (K,) on the trajectory's device; i < j.
    One program a call, cached on the trajectory's shape and the arguments.
    """
    if program.nested():
        return _propose(trajectory, max_candidates, min_separation, max_distance)
    inputs = (trajectory,)
    prog = program.cached(trajectory.translation.device,
                          ("propose_candidates", max_candidates, min_separation, max_distance,
                           program.signature(inputs)), inputs, path="propose_candidates",
                          keyframes=trajectory.translation.shape[0])
    with torch.profiler.record_function(program.DRIVER_RANGE):
        return prog.own(prog.run(lambda b: _propose(b[0], max_candidates, min_separation, max_distance),
                                 inputs))


def _propose(trajectory: Pose3, max_candidates: int, min_separation: int, max_distance: float):
    """:func:`propose_candidates`' work."""
    t = trajectory.translation  # (N, 3)
    N = t.shape[0]
    d = norm(t[:, None, :] - t[None, :, :])
    ii = torch.arange(N, device=t.device)
    sep_ok = (ii[None, :] - ii[:, None]) >= min_separation  # j - i, upper triangle
    flat = torch.where(sep_ok, d, torch.full_like(d, float("inf"))).reshape(1, -1)
    vals, pos = topk_min(flat, min(max_candidates, flat.shape[1]))
    vals, pos = vals[0], pos[0]
    valid = torch.isfinite(vals) & (vals < max_distance)
    return (pos // N).to(torch.int32), (pos % N).to(torch.int32), valid


def closure_quality(
    est: Pose3,
    source: FeatureSet,
    target: FeatureSet,
    reg_params: RegistrationParams = RegistrationParams(),
):
    """Post-fit quality of registrations: (inlier_frac, mean_residual).

    Every leaf carries a leading pair axis (K,), and so do the outputs; or,
    as ``loam_tpu`` calls it, none: one ``Pose3`` (a (3,) translation) and
    unbatched feature sets give two scalars. The source is re-associated
    at the final pose and the raw point-to-line/plane residuals are
    evaluated there: ``inlier_frac`` = valid associations / valid source
    features; ``mean_residual`` = mean absolute residual over the associated
    set (meters). A registration that CONVERGED into a wrong local minimum
    shows up here as few inliers and/or large residuals -- convergence alone
    cannot tell it apart.
    """
    if est.translation.ndim == 1:
        add = lambda x: x[None]
        frac, mean_r = closure_quality(Pose3(add(est.rotation), add(est.translation)),
                                       source.map(add), target.map(add), reg_params)
        return frac[0], mean_r[0]
    dtype, dev = source.edge_points.dtype, source.edge_points.device
    K = source.edge_mask.shape[0]
    qe = _act(est, source.edge_points)
    qp = _act(est, source.planar_points)
    e_res = knn_run(knn_prep(target.edge_points, target.edge_mask), qe,
                    reg_params.num_edge_neighbors, reg_params.max_edge_neighbor_dist,
                    with_coords=True, query_mask=source.edge_mask)
    p_res = knn_run(knn_prep(target.planar_points, target.planar_mask), qp,
                    reg_params.num_plane_neighbors, reg_params.max_plane_neighbor_dist,
                    with_coords=True, query_mask=source.planar_mask)
    ea = associate_edges(qe, source.edge_mask, target.edge_points, target.edge_mask,
                         reg_params, knn_result=e_res)
    pa = associate_planes(qp, source.planar_mask, target.planar_points, target.planar_mask,
                          reg_params, knn_result=p_res)
    r, _, _, mask = _residuals(_Problem(qe, ea, qp, pa), Pose3.identity(dtype, (K,), dev))
    n_assoc = torch.sum(mask, dim=-1, dtype=torch.int32)
    n_src = (torch.sum(source.edge_mask, dim=-1, dtype=torch.int32)
             + torch.sum(source.planar_mask, dim=-1, dtype=torch.int32))
    frac = n_assoc / torch.clamp(n_src, min=1).to(dtype)
    mean_r = torch.sum(torch.where(mask, torch.abs(r), torch.zeros_like(r)), dim=-1) / torch.clamp(
        n_assoc, min=1).to(dtype)
    return frac, mean_r


def verify_closures(
    trajectory: Pose3,
    features: FeatureSet,
    cand_i: torch.Tensor,
    cand_j: torch.Tensor,
    cand_valid: torch.Tensor,
    reg_params: RegistrationParams = RegistrationParams(),
    min_inlier_frac: float = 0.35,
    max_mean_residual: float = 0.25,
) -> LoopClosures:
    """Register keyframe j's features against keyframe i's for each
    candidate, all K pairs in one ``register_features_batch``.

    Args:
      trajectory: (N, ...) current world pose estimates.
      features: FeatureSet with leading axis N (per-keyframe features in
        their own sensor frames).
      min_inlier_frac / max_mean_residual: post-fit quality gates (see
        :func:`closure_quality`).

    Accepts a closure only when registration CONVERGED **and** the post-fit
    quality passes: a converged-but-wrong local minimum (e.g. aliased
    geometry) must not become a high-weight pose-graph edge.
    """
    ci, cj = cand_i.long(), cand_j.long()
    qi, ti = trajectory.rotation[ci], trajectory.translation[ci]
    qj, tj = trajectory.rotation[cj], trajectory.translation[cj]
    inv = quat_conjugate(qi)
    init = Pose3(quat_multiply(inv, qj), quat_rotate(inv, tj - ti))  # i_T_j now
    src = features.map(lambda x: x[cj])
    tgt = features.map(lambda x: x[ci])
    est, detail = register_features_batch(src, tgt, init, reg_params, with_matches=False)
    frac, mean_r = closure_quality(est, src, tgt, reg_params)
    accepted = (
        cand_valid
        & (detail.termination == TerminationType.CONVERGED)
        & (frac >= min_inlier_frac)
        & (mean_r <= max_mean_residual)
    )
    return LoopClosures(cand_i, cand_j, est, accepted, frac, mean_r)


def closure_edges(closures: LoopClosures, weight: float = 10.0) -> PoseGraphEdges:
    """Pose-graph edges from verified closures (rejected ones masked out)."""
    t = closures.measurement.translation
    return PoseGraphEdges(
        i=closures.i,
        j=closures.j,
        measurement=closures.measurement,
        weight=torch.full(closures.i.shape, weight, dtype=t.dtype, device=t.device),
        mask=closures.accepted,
    )


def join_edges(a: PoseGraphEdges, b: PoseGraphEdges) -> PoseGraphEdges:
    """One edge set: ``a``'s edges, then ``b``'s."""
    return PoseGraphEdges(*(
        Pose3(*(torch.cat([u, v]) for u, v in zip(x, y))) if isinstance(x, Pose3) else torch.cat([x, y])
        for x, y in zip(a, b)
    ))


def optimize_trajectory_with_closures(
    trajectory: Pose3,
    features: FeatureSet,
    reg_params: RegistrationParams = RegistrationParams(),
    max_candidates: int = 8,
    min_separation: int = 10,
    max_distance: float = 3.0,
    closure_weight: float = 10.0,
    iterations: int = 10,
    min_inlier_frac: float = 0.35,
    max_mean_residual: float = 0.25,
) -> Tuple[Pose3, LoopClosures]:
    """End to end: propose -> verify -> pose-graph optimize, on the
    trajectory's device. Returns (optimized trajectory, the closures used).
    One program a call (``loop.driver_program``: cached on the shapes and
    the arguments; eager under ``LOAM_DEBUG_NANS=1``), the four pieces
    inline in it."""

    def run(bufs):
        trajectory, features = bufs
        ci, cj, cv = propose_candidates(trajectory, max_candidates, min_separation, max_distance)
        closures = verify_closures(trajectory, features, ci, cj, cv, reg_params,
                                   min_inlier_frac=min_inlier_frac,
                                   max_mean_residual=max_mean_residual)
        edges = join_edges(odometry_edges(trajectory), closure_edges(closures, closure_weight))
        opt, _ = optimize_pose_graph(trajectory, edges, iterations=iterations)
        return opt, closures

    inputs = (trajectory, features)
    if program.nested():
        return run(inputs)
    key = ("loop_closure", max_candidates, min_separation, max_distance, closure_weight, iterations,
           min_inlier_frac, max_mean_residual)
    prog = driver_program(trajectory.translation.device, key, inputs, reg_params, path="loop_closure",
                          keyframes=trajectory.translation.shape[0], candidates=max_candidates)
    with torch.profiler.record_function(program.DRIVER_RANGE):
        return prog.own(prog.run(run, inputs))
