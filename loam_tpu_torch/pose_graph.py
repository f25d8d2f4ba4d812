"""Pose-graph optimization (SE(3) Levenberg-Marquardt) on torch tensors.

Counterpart of ``loam_tpu.pose_graph``: given relative-pose constraints --
sequential odometry edges plus loop closures -- refine the whole trajectory,
the layer above odometry that the reference leaves to its users.

All E edges are processed at once: the residuals and their (6, 6) Jacobian
blocks of the exact quaternion residual (``loam_tpu`` differentiates it with
``jax.jacfwd`` under ``jax.vmap``; here the blocks are in closed form, see
``_edge_jacobians``) are scatter-added into dense 6N x 6N normal equations
and solved by Cholesky with Levenberg-Marquardt damping.
Edges carry a validity mask, so an edge set can be padded to a fixed
capacity; node 0 is the gauge.

The loop runs a fixed number of iterations with no host sync: the Cholesky
is ``torch.linalg.cholesky_ex``, whose failure flag joins the accept test
instead of raising (``loam_tpu``'s Cholesky returns NaNs there, which the
accept test rejects alike), and accept/reject is a ``torch.where``.

Assembly uses ``index_put_(accumulate=True)``. On a CUDA tensor its
additions into one entry run in no fixed order, so a diagonal block of a node
with three or more edges, and the gradient, may differ in their last bits
from run to run (two terms added to zero are exact in either order); the
solution moves by that rounding only.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .device import place
from .geometry import (
    Pose3,
    quat_conjugate,
    quat_exp,
    quat_log,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
)


class PoseGraphEdges(NamedTuple):
    """Relative-pose constraints; every leaf leads with E.

    ``measurement`` is the expected ``node_i_T_node_j``; ``weight`` scales
    each edge's contribution (e.g. inverse variance); invalid slots are
    masked out.
    """

    i: torch.Tensor  # (E,) int32 source node
    j: torch.Tensor  # (E,) int32 target node
    measurement: Pose3  # (E, ...) leaves
    weight: torch.Tensor  # (E,)
    mask: torch.Tensor  # (E,) bool


def make_edges(i, j, measurement: Pose3, weight=None, mask=None) -> PoseGraphEdges:
    """Edges from node indices, measurements and optional weights / mask;
    array-likes go to the measurement's device."""
    dev = measurement.translation.device
    i = place(i, dev, torch.int32)
    if weight is None:
        weight = torch.ones(i.shape, dtype=measurement.translation.dtype, device=dev)
    if mask is None:
        mask = torch.ones(i.shape, dtype=torch.bool, device=dev)
    return PoseGraphEdges(i, place(j, dev, torch.int32), measurement,
                          place(weight, dev), place(mask, dev, torch.bool))


def odometry_edges(trajectory: Pose3) -> PoseGraphEdges:
    """Sequential edges from a trajectory of world poses: the odometry chain
    ``i -> i+1`` with measurement ``T_i^-1 T_{i+1}``."""
    q, t = trajectory
    inv = quat_conjugate(q[:-1])
    rel = Pose3(quat_multiply(inv, q[1:]), quat_rotate(inv, t[1:] - t[:-1]))
    n = t.shape[0]
    ar = torch.arange(n, dtype=torch.int32, device=t.device)
    return make_edges(ar[:-1], ar[1:], rel)


def _edge_residual(xi_i, xi_j, Ti: Pose3, Tj: Pose3, z: Pose3) -> torch.Tensor:
    """``r = Log(z^-1 (Exp(xi_i) Ti)^-1 (Exp(xi_j) Tj))`` in R^6, rotation
    part first; leading axes batch. Evaluated at ``xi = 0`` in the solver,
    where autodiff gives the exact (6, 6) Jacobian blocks."""
    qi, qj = quat_exp(xi_i[..., :3]), quat_exp(xi_j[..., :3])
    Pi = Pose3(quat_multiply(qi, Ti.rotation), quat_rotate(qi, Ti.translation) + xi_i[..., 3:])
    Pj = Pose3(quat_multiply(qj, Tj.rotation), quat_rotate(qj, Tj.translation) + xi_j[..., 3:])
    err = z.inverse().compose(Pi.inverse().compose(Pj))
    return torch.cat([quat_log(err.rotation), err.translation], dim=-1)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """``[v]x`` (..., 3, 3) of vectors (..., 3): ``[v]x w = v x w``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(v.shape + (3,))


def _edge_jacobians(qi, ti, qj, tj, zq, zt):
    """``(Ji, Jj), r`` of every edge at ``xi = 0``: the (E, 6, 6) blocks and
    the (E, 6) residuals, the blocks in closed form.

    With ``Ti = (qi, ti)`` perturbed on the left by ``xi_i = (w_i, v_i)``, the
    residual's rotation is ``Log(q0 Exp(Rj^T (w_j - w_i)))`` to first order
    (``q0`` the residual quaternion at ``xi = 0``) and its translation is
    ``Rz^T (Ri^T (Exp(w_i)^T (Exp(w_j) tj + v_j - v_i) - ti) - zt)``, so with
    ``M = Rz^T Ri^T`` and ``Jr^-1`` the inverse right Jacobian of SO(3) at
    the residual rotation ``theta``::

        Jj = [[ Jr^-1 Rj^T, 0], [-M [tj]x,  M]]
        Ji = [[-Jr^-1 Rj^T, 0], [ M [tj]x, -M]]

    ``Jr^-1 = I + [theta]x / 2 + c [theta]x^2``, ``c = 1 / theta^2 -
    (1 + cos theta) / (2 theta sin theta)``, which is ``1/12 + theta^2 / 720``
    to float64 rounding below ``theta = 1e-4`` (there, at a residual of zero,
    ``Jr^-1 = I``). These equal ``jax.jacfwd`` of ``loam_tpu``'s residual
    (held by the tests). Forward-mode autodiff in PyTorch gives them too, but
    ``torch.func.jacfwd`` under ``vmap`` and dual tensors alike run each
    multiplication through a Python decomposition: ~0.1 s of host time a
    call at 40 edges as at 1,049, which made a 10-iteration solve take 1.0 s
    on an H100 machine.
    """
    zero = torch.zeros_like(ti[..., :1]).expand(ti.shape[:-1] + (6,))
    r = _edge_residual(zero, zero, Pose3(qi, ti), Pose3(qj, tj), Pose3(zq, zt))
    theta = r[..., :3]
    t2 = torch.sum(theta * theta, dim=-1)[..., None, None]
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    c = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                    1.0 / t2s - (1.0 + torch.cos(th)) / (2.0 * th * torch.sin(th)))
    K = _skew(theta)
    eye = torch.eye(3, dtype=ti.dtype, device=ti.device)
    A = (eye + 0.5 * K + c * (K @ K)) @ quat_to_matrix(qj).transpose(-1, -2)
    M = quat_to_matrix(zq).transpose(-1, -2) @ quat_to_matrix(qi).transpose(-1, -2)
    B = M @ _skew(tj)
    O = torch.zeros_like(M)
    Jj = torch.cat([torch.cat([A, O], dim=-1), torch.cat([-B, M], dim=-1)], dim=-2)
    Ji = torch.cat([torch.cat([-A, O], dim=-1), torch.cat([B, -M], dim=-1)], dim=-2)
    return (Ji, Jj), r


def _endpoints(poses: Pose3, edges: PoseGraphEdges):
    ii, jj = edges.i.long(), edges.j.long()
    return (poses.rotation[ii], poses.translation[ii], poses.rotation[jj],
            poses.translation[jj], edges.measurement.rotation, edges.measurement.translation)


def _weights(edges: PoseGraphEdges) -> torch.Tensor:
    return torch.where(edges.mask, edges.weight, torch.zeros_like(edges.weight))


def _cost(poses: Pose3, edges: PoseGraphEdges) -> torch.Tensor:
    """Total weighted squared residual (no Jacobians)."""
    qi, ti, qj, tj, zq, zt = _endpoints(poses, edges)
    zero = torch.zeros_like(ti[..., :1]).expand(ti.shape[:-1] + (6,))
    r = _edge_residual(zero, zero, Pose3(qi, ti), Pose3(qj, tj), Pose3(zq, zt))
    return torch.sum(_weights(edges) * torch.sum(r * r, dim=-1))


def _assemble(poses: Pose3, edges: PoseGraphEdges, dim: int):
    """Dense normal equations ``H`` (dim, dim), gradient ``b`` (dim,)."""
    dtype, dev = poses.translation.dtype, poses.translation.device
    (Ji, Jj), r = _edge_jacobians(*_endpoints(poses, edges))
    w = _weights(edges)
    wj = w[:, None, None]
    Hii = wj * torch.einsum("eri,erj->eij", Ji, Ji)
    Hjj = wj * torch.einsum("eri,erj->eij", Jj, Jj)
    Hij = wj * torch.einsum("eri,erj->eij", Ji, Jj)
    bi = w[:, None] * torch.einsum("eri,er->ei", Ji, r)
    bj = w[:, None] * torch.einsum("eri,er->ei", Jj, r)
    six = torch.arange(6, device=dev)
    oi = (6 * edges.i.long())[:, None] + six  # (E, 6)
    oj = (6 * edges.j.long())[:, None] + six
    H = torch.zeros((dim, dim), dtype=dtype, device=dev)
    for rows, cols, blk in ((oi, oi, Hii), (oj, oj, Hjj), (oi, oj, Hij),
                            (oj, oi, Hij.transpose(-1, -2))):
        H.index_put_((rows[:, :, None].expand(blk.shape), cols[:, None, :].expand(blk.shape)),
                     blk, accumulate=True)
    b = torch.zeros(dim, dtype=dtype, device=dev)
    b.index_put_((oi,), bi, accumulate=True)
    b.index_put_((oj,), bj, accumulate=True)
    return H, b


def _apply_update(poses: Pose3, dx: torch.Tensor) -> Pose3:
    xi = dx.reshape(-1, 6).clone()
    xi[0] = 0.0  # gauge
    dq = quat_exp(xi[:, :3])
    return Pose3(quat_normalize(quat_multiply(dq, poses.rotation)),
                 quat_rotate(dq, poses.translation) + xi[:, 3:])


def optimize_pose_graph(
    initial: Pose3,
    edges: PoseGraphEdges,
    iterations: int = 10,
) -> Tuple[Pose3, torch.Tensor]:
    """Gauss-Newton/LM pose-graph solve on the device of ``initial``.

    Args:
      initial: (N, ...) world poses (node 0 is the fixed gauge).
      edges: padded constraint set.
      iterations: outer LM iterations, all of them run.

    Returns: (optimized trajectory, final total weighted squared error).
    """
    dtype = initial.translation.dtype
    dim = 6 * initial.translation.shape[0]
    poses = Pose3(initial.rotation.to(dtype), initial.translation.to(dtype))
    z = edges.measurement
    edges = edges._replace(measurement=Pose3(z.rotation.to(dtype), z.translation.to(dtype)),
                           weight=edges.weight.to(dtype))
    dev = poses.translation.device
    gauge = torch.zeros(dim, dtype=dtype, device=dev)
    gauge[:6] = 1e12  # clamp node 0
    lam = torch.tensor(1e-6, dtype=dtype, device=dev)
    cost = _cost(poses, edges)
    for _ in range(iterations):
        H, b = _assemble(poses, edges, dim)
        diag = H.diagonal()
        diag.add_(lam * diag + 1e-8 + gauge)
        L, info = torch.linalg.cholesky_ex(H)
        del H
        dx = -torch.cholesky_solve(b[:, None], L)[:, 0]
        del L
        candidate = _apply_update(poses, dx)
        new_cost = _cost(candidate, edges)
        accept = (new_cost < cost) & (info == 0)
        poses = Pose3(torch.where(accept, candidate.rotation, poses.rotation),
                      torch.where(accept, candidate.translation, poses.translation))
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-12), torch.clamp(lam * 4.0, max=1e8))
    return poses, cost
