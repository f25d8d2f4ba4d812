"""Levenberg-Marquardt for the 6-DoF delta pose, batched over pairs.

Counterpart of ``loam_tpu.registration.solver`` (in place of the reference's
Ceres solve, ``registration-inl.h:51-56``): analytic-Jacobian normal
equations with Huber IRLS weights (delta 1.0, ``registration.cpp:56,97``),
``inner_iterations`` damped steps with cost-decrease accept/reject, and a
left-composed twist step ``delta' = (Exp(theta), dt) o delta``, so a moved
point changes by ``theta x q + dt`` and ``J = [q x grad_q r, grad_q r]``.

The normal equations (H, g) at the accepted delta ride along between steps,
so each step costs one residual sweep. The 6x6 solve is the same unrolled
Cholesky formula as ``loam_tpu`` (no ``torch.linalg``), which keeps the two
packages' rounding close. Every tensor may carry leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import Pose3, cross, norm, quat_exp, quat_log, quat_multiply, quat_normalize, quat_rotate
from ..params import RegistrationParams
from .associate import EdgeAssociations, PlaneAssociations


def _edge_residual_grad(q, a, b):
    """Point-to-line residual ``|(q-a) x (q-b)| / |a-b|`` (reference
    ``geometry-inl.h:21-27``) and its gradient ``((a-b) x c) / (|c| |a-b|)``."""
    c = cross(q - a, q - b)
    c_norm = norm(c)
    ab_norm = norm(a - b)
    r = c_norm / torch.where(ab_norm > 0, ab_norm, torch.ones_like(ab_norm))
    big = c_norm > 1e-12
    denom = torch.where(big, c_norm * ab_norm, torch.ones_like(c_norm))
    grad = cross(a - b, c) / denom[..., None]
    grad = torch.where(big[..., None], grad, torch.zeros_like(grad))
    return r, grad


def _plane_residual_grad(q, normal, d):
    """Point-to-plane residual ``|n.q - d|`` and gradient ``sign(n.q - d) n``
    (reference ``geometry-inl.h:30-33``)."""
    s = torch.sum(q * normal, dim=-1) - d
    return torch.abs(s), torch.sign(s)[..., None] * normal


def _huber_rho(r, delta: float):
    """Huber loss on the residual magnitude (Ceres ``HuberLoss``)."""
    a = torch.abs(r)
    return torch.where(a <= delta, r * r, delta * (2.0 * a - delta))


def _huber_weight(r, delta: float):
    """IRLS weight: 1 inside the delta, ``delta / |r|`` outside."""
    a = torch.abs(r)
    return torch.where(a <= delta, torch.ones_like(a), delta / torch.where(a > 0, a, torch.ones_like(a)))


class _Problem(NamedTuple):
    """Fixed associations for one outer ICF iteration. ``prior_offset`` is
    ``est o init^-1``, the deviation from the ICF initialization that the
    optional quadratic prior penalizes."""

    pts_edge: torch.Tensor  # (..., E, 3) pre-transformed source edges
    edge: EdgeAssociations
    pts_plane: torch.Tensor  # (..., Q, 3)
    plane: PlaneAssociations
    prior_offset: Pose3 = None


def _act(delta: Pose3, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (..., 4)/(..., 3) pose to (..., N, 3) points."""
    return quat_rotate(delta.rotation[..., None, :], pts) + delta.translation[..., None, :]


def _residuals(problem: _Problem, delta: Pose3):
    """All residuals and gradients at ``delta``: (r, grad_q, q, mask)."""
    qe = _act(delta, problem.pts_edge)
    re, ge = _edge_residual_grad(qe, problem.edge.line_a, problem.edge.line_b)
    qp = _act(delta, problem.pts_plane)
    rp, gp = _plane_residual_grad(qp, problem.plane.normal, problem.plane.d)
    r = torch.cat([re, rp], dim=-1)
    grad = torch.cat([ge, gp], dim=-2)
    q = torch.cat([qe, qp], dim=-2)
    mask = torch.cat([problem.edge.valid, problem.plane.valid], dim=-1)
    return r, grad, q, mask


def _prior_xi(problem: _Problem, delta: Pose3) -> torch.Tensor:
    total = delta
    if problem.prior_offset is not None:
        total = delta.compose(problem.prior_offset)
    return torch.cat([quat_log(total.rotation), total.translation], dim=-1)


def _chol_solve6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve the damped SPD 6x6 system with an unrolled Cholesky."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = H[..., j, j]
        for kk in range(j):
            d = d - L[j][kk] * L[j][kk]
        Ljj = torch.sqrt(torch.clamp(d, min=1e-30))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            v = H[..., i, j]
            for kk in range(j):
                v = v - L[i][kk] * L[j][kk]
            L[i][j] = v * inv
    y = [None] * n
    for i in range(n):
        v = g[..., i]
        for kk in range(i):
            v = v - L[i][kk] * y[kk]
        y[i] = v / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        v = y[i]
        for kk in range(i + 1, n):
            v = v - L[kk][i] * x[kk]
        x[i] = v / L[i][i]
    return torch.stack(x, dim=-1)


def _apply_twist(delta: Pose3, s: torch.Tensor) -> Pose3:
    """Left-compose the small twist ``s = (theta, dt)`` onto ``delta``."""
    dq = quat_exp(s[..., :3])
    return Pose3(
        quat_normalize(quat_multiply(dq, delta.rotation)),
        quat_rotate(dq, delta.translation) + s[..., 3:],
    )


def _select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where`` with ``cond`` (batch shape) broadcast over trailing axes."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - cond.ndim)), a, b)


def lm_solve(problem: _Problem, params: RegistrationParams):
    """Solve for the delta pose over fixed associations, starting from the
    identity delta each outer iteration (``registration-inl.h:36``).

    Returns (delta Pose3 with the batch shape, final cost)."""
    pts = problem.pts_edge
    dtype, dev = pts.dtype, pts.device
    batch = pts.shape[:-2]
    delta = Pose3.identity(dtype, batch, dev)
    lam = torch.full(batch, 1e-4, dtype=dtype, device=dev)
    eye = torch.eye(6, dtype=dtype, device=dev)

    def linearize(delta):
        r, grad, q, mask = _residuals(problem, delta)
        zero = torch.zeros((), dtype=dtype, device=dev)
        cost = torch.sum(torch.where(mask, _huber_rho(r, params.huber_delta), zero), dim=-1)
        # J = [q x grad, grad]; invalid rows zeroed so no 0 * nan reaches H
        J = torch.cat([cross(q, grad), grad], dim=-1)
        J = torch.where(mask[..., None], J, zero)
        r = torch.where(mask, r, zero)
        w = torch.where(mask, _huber_weight(r, params.huber_delta), zero)
        wJ = w[..., None] * J
        H = wJ.transpose(-1, -2) @ J
        g = torch.sum(wJ * r[..., None], dim=-2)
        if params.prior_weight > 0:
            xi = _prior_xi(problem, delta)
            cost = cost + params.prior_weight * torch.sum(xi * xi, dim=-1)
            H = H + params.prior_weight * eye
            g = g + params.prior_weight * xi
        return cost, H, g

    cost, H, g = linearize(delta)
    for _ in range(params.inner_iterations):
        # Marquardt scaling with a relative floor (degenerate geometry leaves
        # H rank deficient; the floor bounds steps along null directions)
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        damp = lam[..., None] * diag + 1e-6 * torch.amax(diag, dim=-1, keepdim=True) + 1e-10
        step = -_chol_solve6(H + torch.diag_embed(damp), g)
        cand = _apply_twist(delta, step)
        new_cost, new_H, new_g = linearize(cand)
        accept = new_cost < cost
        delta = Pose3(_select(accept, cand.rotation, delta.rotation),
                      _select(accept, cand.translation, delta.translation))
        cost = torch.where(accept, new_cost, cost)
        H = _select(accept, new_H, H)
        g = _select(accept, new_g, g)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-12), torch.clamp(lam * 4.0, max=1e8))
    return delta, cost
