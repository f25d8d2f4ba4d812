"""Trajectory evaluation: ATE / RPE metrics (host-side NumPy).

A JAX-free copy of ``loam_tpu.evaluation``.

The reference publishes no quantitative accuracy (SURVEY §6); BASELINE.json
scores this framework on ATE vs the reference on held-out segments. These
are the standard metrics (Sturm et al., TUM RGB-D benchmark conventions):
absolute trajectory error after SE(3) (optionally Sim(3)) Umeyama alignment,
and relative pose error over a fixed frame delta.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(
    est: np.ndarray, ref: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning ``est`` to ``ref``.

    Args:
      est/ref: (F, 3) positions.
    Returns: (R (3,3), t (3,), s) minimizing ||ref - (s R est + t)||^2.
    """
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    mu_e = est.mean(axis=0)
    mu_r = ref.mean(axis=0)
    ec = est - mu_e
    rc = ref - mu_r
    cov = rc.T @ ec / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec * ec).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_e) if var_e > 0 else 1.0
    else:
        s = 1.0
    t = mu_r - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est_positions: np.ndarray,
    ref_positions: np.ndarray,
    align: bool = True,
    with_scale: bool = False,
) -> float:
    """Absolute trajectory error (RMSE over positions, meters)."""
    est = np.asarray(est_positions, np.float64)
    ref = np.asarray(ref_positions, np.float64)
    if align:
        R, t, s = umeyama_alignment(est, ref, with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - ref
    return float(np.sqrt((err * err).sum(axis=1).mean()))


def _as_rotmats(rotations: np.ndarray) -> np.ndarray:
    """Accept (F, 3, 3) rotation matrices or (F, 4) wxyz quaternions."""
    r = np.asarray(rotations, np.float64)
    if r.ndim == 3 and r.shape[-2:] == (3, 3):
        return r
    if r.ndim == 2 and r.shape[-1] == 4:
        w, x, y, z = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
        n = np.sqrt(w * w + x * x + y * y + z * z)
        w, x, y, z = w / n, x / n, y / n, z / n
        m = np.empty((r.shape[0], 3, 3))
        m[:, 0, 0] = 1 - 2 * (y * y + z * z)
        m[:, 0, 1] = 2 * (x * y - w * z)
        m[:, 0, 2] = 2 * (x * z + w * y)
        m[:, 1, 0] = 2 * (x * y + w * z)
        m[:, 1, 1] = 1 - 2 * (x * x + z * z)
        m[:, 1, 2] = 2 * (y * z - w * x)
        m[:, 2, 0] = 2 * (x * z - w * y)
        m[:, 2, 1] = 2 * (y * z + w * x)
        m[:, 2, 2] = 1 - 2 * (x * x + y * y)
        return m
    raise ValueError(f"rotations must be (F,3,3) or (F,4) wxyz, got {r.shape}")


def rpe(
    est_positions: np.ndarray,
    ref_positions: np.ndarray,
    est_rotations: np.ndarray,
    ref_rotations: np.ndarray,
    delta: int = 1,
) -> Tuple[float, float]:
    """Relative pose error, TUM convention (Sturm et al. 2012).

    Per window i: relative motions ``E_i = est_i^-1 o est_{i+delta}`` and
    ``G_i = ref_i^-1 o ref_{i+delta}``; error ``F_i = G_i^-1 o E_i``.

    Returns ``(trans_rmse, rot_rmse)``: RMSE of ``||trans(F_i)||`` in meters
    and of ``angle(rot(F_i))`` in radians.
    """
    tp = np.asarray(est_positions, np.float64)
    tq = np.asarray(ref_positions, np.float64)
    Rp = _as_rotmats(est_rotations)
    Rq = _as_rotmats(ref_rotations)
    d = delta
    # relative motions expressed in the frame of pose i
    Re = np.einsum("fij,fjk->fik", Rp[:-d].transpose(0, 2, 1), Rp[d:])
    te = np.einsum("fij,fj->fi", Rp[:-d].transpose(0, 2, 1), tp[d:] - tp[:-d])
    Rg = np.einsum("fij,fjk->fik", Rq[:-d].transpose(0, 2, 1), Rq[d:])
    tg = np.einsum("fij,fj->fi", Rq[:-d].transpose(0, 2, 1), tq[d:] - tq[:-d])
    # F = G^-1 o E: rotation Rg^T Re, translation Rg^T (te - tg)
    Rf = np.einsum("fij,fjk->fik", Rg.transpose(0, 2, 1), Re)
    tf = np.einsum("fij,fj->fi", Rg.transpose(0, 2, 1), te - tg)
    trans = np.linalg.norm(tf, axis=1)
    cos = np.clip((np.trace(Rf, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.arccos(cos)
    return (
        float(np.sqrt((trans * trans).mean())),
        float(np.sqrt((ang * ang).mean())),
    )


def rpe_rmse(
    est_positions: np.ndarray,
    ref_positions: np.ndarray,
    delta: int = 1,
    est_rotations: np.ndarray | None = None,
    ref_rotations: np.ndarray | None = None,
) -> float:
    """Translation RPE (RMSE, meters) over ``delta`` frames.

    With rotations supplied this is the exact TUM-convention translation
    component of :func:`rpe`. Without rotations it degrades to the RMSE of
    the world-frame relative-translation *vector* difference
    ``||(est_{i+d}-est_i) - (ref_{i+d}-ref_i)||`` — a position-only drift
    measure that sees direction errors (unlike a norm-of-norms comparison)
    but cannot express the error in the local frame and sees no rotation
    drift. Use :func:`rpe` for the full metric.
    """
    if est_rotations is not None and ref_rotations is not None:
        return rpe(
            est_positions, ref_positions, est_rotations, ref_rotations, delta
        )[0]
    est = np.asarray(est_positions, np.float64)
    ref = np.asarray(ref_positions, np.float64)
    err = (est[delta:] - est[:-delta]) - (ref[delta:] - ref[:-delta])
    n = np.linalg.norm(err, axis=1)
    return float(np.sqrt((n * n).mean()))
