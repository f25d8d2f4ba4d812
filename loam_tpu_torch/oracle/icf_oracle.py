"""Scalar NumPy oracle for the full ICF registration loop.

A plain-Python/NumPy transcription of the reference's registration control
flow (the reference's ``loam/include/loam/registration-inl.h:28-74`` +
``loam/src/registration.cpp:23-103``) with this framework's
solver numerics (f64 LM, analytic Jacobians — the reference's Ceres is not a
dependency, and SURVEY §4 sanctions scalar oracles as the parity
mechanism). It pins every *loop-level* semantic the vectorized loops
(``loam_tpu``'s and this port's) must reproduce, iteration by iteration:

  * brute-force kNN with first-index tie-breaking and the post-hoc strict
    radius filter (quirk §2.3(7));
  * association guards in reference order: count guard, fit, dead
    condition-number guard (never fires), inert signed-mean plane guard;
  * ``INSUFFICIENT_ASSOCIATIONS`` checked BEFORE the solve — pose unchanged,
    iteration records nothing (§2.3(9));
  * left-compose of the delta (``registration-inl.h:65``);
  * convergence checked AFTER the update is applied (§2.3(10)).

The LM inner solve mirrors ``registration/solver.py`` step-for-step so that,
in f64, the vectorized loops and this oracle agree to machine-level precision — which
makes the discrete per-iteration outputs (validity masks, match indices,
iteration count, termination type) exactly comparable.

The port's own copy of ``loam_tpu/oracle/icf_oracle.py`` on the port's
``RegistrationParams`` / ``TerminationType``, importing only numpy. One
change: ``_knn`` evaluates its queries in chunks, so a 64x1024 scan's
~17,000 planar queries against as many targets do not build one (Q, M, 3)
float64 array (7 GB); the rows are independent, so the result is the same
bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..params import RegistrationParams, TerminationType


# --- quaternion helpers (wxyz, mirroring geometry.py) -----------------------

def _quat_multiply(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _quat_rotate(q, v):
    u = q[1:]
    w = q[0]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _quat_exp(rotvec):
    theta = np.linalg.norm(rotvec)
    if theta * theta < 1e-12:
        k = 0.5 - theta * theta / 48.0
        w = 1.0 - theta * theta / 8.0
    else:
        k = np.sin(0.5 * theta) / theta
        w = np.cos(0.5 * theta)
    return np.concatenate([[w], k * np.asarray(rotvec, np.float64)])


def _normalize(q):
    return q / np.linalg.norm(q)


@dataclasses.dataclass
class OraclePose:
    q: np.ndarray  # (4,) wxyz
    t: np.ndarray  # (3,)

    def act(self, pts):
        return _quat_rotate_batch(self.q, pts) + self.t


def _quat_rotate_batch(q, pts):
    u = q[1:]
    w = q[0]
    uv = np.cross(np.broadcast_to(u, pts.shape), pts)
    return pts + 2.0 * (w * uv + np.cross(np.broadcast_to(u, pts.shape), uv))


# --- kNN: k-then-strict-radius, first-index ties (quirk §2.3(7)) ------------

#: Bytes a chunk of ``_knn`` may hold: its (chunk, M, 3) differences and two
#: (chunk, M) distance arrays, 40 bytes a query-target pair in float64.
KNN_CHUNK_BYTES = 256 << 20


def _knn(queries, targets, k, max_dist, chunk=None):
    """Per query: k argmin passes (first-index ties) then strict < radius.

    Queries are taken ``chunk`` at a time (default: as many as keep a chunk
    under ``KNN_CHUNK_BYTES``); each row's arithmetic is the same whatever
    the chunk. Returns (indices (Q, k), valid (Q, k)).
    """
    Q = queries.shape[0]
    if chunk is None:
        chunk = max(1, KNN_CHUNK_BYTES // (40 * max(targets.shape[0], 1)))
    idx = np.zeros((Q, k), np.int64)
    val = np.zeros((Q, k), bool)
    for s in range(0, Q, chunk):
        dif = queries[s : s + chunk, None, :] - targets[None, :, :]
        d2 = np.einsum("qmi,qmi->qm", dif, dif)
        rows = np.arange(d2.shape[0])
        work = d2.copy()
        for j in range(k):
            am = np.argmin(work, axis=1)  # first occurrence on ties
            dj = work[rows, am]
            idx[s : s + chunk, j] = am
            val[s : s + chunk, j] = np.isfinite(dj) & (np.sqrt(dj) < max_dist)
            work[rows, am] = np.inf
    return idx, val


# --- fits (PCA; see geometry.fit_line / fit_plane docstrings) ---------------

def _fit_line(pts):
    center = pts.mean(axis=0)
    c = pts - center
    cov = c.T @ c
    w, v = np.linalg.eigh(cov)
    direction = v[:, 2]
    return center + 0.1 * direction, center - 0.1 * direction


def _fit_plane(pts):
    center = pts.mean(axis=0)
    c = pts - center
    cov = c.T @ c
    w, v = np.linalg.eigh(cov)
    normal = v[:, 0]
    d = float(normal @ center)
    if d < 0:
        normal, d = -normal, -d
    return normal, d


# --- residuals + analytic gradients (solver.py mirrors) ---------------------

def _edge_res_grad(q, a, b):
    c = np.cross(q - a, q - b)
    c_norm = np.linalg.norm(c, axis=-1)
    ab_norm = np.linalg.norm(a - b, axis=-1)
    r = c_norm / np.where(ab_norm > 0, ab_norm, 1.0)
    denom = np.where(c_norm > 1e-12, c_norm * ab_norm, 1.0)
    grad = np.cross(a - b, c) / denom[..., None]
    grad = np.where((c_norm > 1e-12)[..., None], grad, 0.0)
    return r, grad


def _plane_res_grad(q, n, d):
    s = np.einsum("ki,ki->k", q, n) - d
    return np.abs(s), np.sign(s)[:, None] * n


def _huber_rho(r, delta):
    a = np.abs(r)
    return np.where(a <= delta, r * r, delta * (2.0 * a - delta))


def _huber_weight(r, delta):
    a = np.abs(r)
    return np.where(a <= delta, 1.0, delta / np.where(a > 0, a, 1.0))


def _lm_solve(pts_edge, ea, pts_plane, pa, params: RegistrationParams):
    """Mirror of ``solver.lm_solve`` (f64, prior_weight == 0 path)."""

    def residuals(delta: OraclePose):
        qe = delta.act(pts_edge) if len(pts_edge) else pts_edge
        qp = delta.act(pts_plane) if len(pts_plane) else pts_plane
        re, ge = (
            _edge_res_grad(qe, ea["a"], ea["b"])
            if len(qe)
            else (np.zeros(0), np.zeros((0, 3)))
        )
        rp, gp = (
            _plane_res_grad(qp, pa["n"], pa["d"])
            if len(qp)
            else (np.zeros(0), np.zeros((0, 3)))
        )
        r = np.concatenate([re, rp])
        g = np.concatenate([ge, gp])
        q = np.concatenate([qe, qp]) if len(qe) + len(qp) else np.zeros((0, 3))
        return r, g, q

    def cost(delta):
        r, _, _ = residuals(delta)
        return float(np.sum(_huber_rho(r, params.huber_delta)))

    delta = OraclePose(np.array([1.0, 0, 0, 0]), np.zeros(3))
    lam = 1e-4
    c = cost(delta)
    for _ in range(params.inner_iterations):
        r, grad, q = residuals(delta)
        J = np.concatenate([np.cross(q, grad), grad], axis=-1)
        w = _huber_weight(r, params.huber_delta)
        H = np.einsum("n,ni,nj->ij", w, J, J)
        g = np.einsum("n,ni,n->i", w, J, r)
        diag = np.diagonal(H)
        damp = lam * diag + 1e-6 * np.max(diag) + 1e-10
        step = -np.linalg.solve(H + np.diag(damp), g)
        dq = _quat_exp(step[:3])
        candidate = OraclePose(
            _normalize(_quat_multiply(dq, delta.q)),
            _quat_rotate(dq, delta.t) + step[3:],
        )
        nc = cost(candidate)
        if nc < c:
            delta, c, lam = candidate, nc, max(lam / 3.0, 1e-12)
        else:
            lam = min(lam * 4.0, 1e8)
    return delta


@dataclasses.dataclass
class OracleIteration:
    est_in_q: np.ndarray
    est_in_t: np.ndarray
    edge_valid: np.ndarray  # (E,) bool
    edge_match: np.ndarray  # (E,) int, -1 invalid
    plane_valid: np.ndarray
    plane_match: np.ndarray
    delta_q: np.ndarray
    delta_t: np.ndarray


@dataclasses.dataclass
class OracleResult:
    q: np.ndarray
    t: np.ndarray
    termination: int
    iterations: List[OracleIteration]


def register_oracle(
    src_edge: np.ndarray,
    src_planar: np.ndarray,
    tgt_edge: np.ndarray,
    tgt_planar: np.ndarray,
    init_q=(1.0, 0.0, 0.0, 0.0),
    init_t=(0.0, 0.0, 0.0),
    params: RegistrationParams = RegistrationParams(),
) -> OracleResult:
    """Scalar transcription of the full ICF loop (see module docstring)."""
    est = OraclePose(np.asarray(init_q, np.float64), np.asarray(init_t, np.float64))
    E, Q = len(src_edge), len(src_planar)
    iterations: List[OracleIteration] = []
    termination = int(TerminationType.MAX_ITER)

    for _ in range(params.max_iterations):
        qe = est.act(src_edge) if E else src_edge
        qp = est.act(src_planar) if Q else src_planar

        # --- edge association (registration.cpp:23-62) ----------------------
        e_valid = np.zeros(E, bool)
        e_match = np.full(E, -1, np.int64)
        e_a = np.zeros((E, 3))
        e_b = np.zeros((E, 3))
        if E and len(tgt_edge):
            idx, val = _knn(
                qe, tgt_edge, params.num_edge_neighbors, params.max_edge_neighbor_dist
            )
            for s in range(E):
                nb = idx[s][val[s]]
                if len(nb) < params.min_line_fit_points:
                    continue  # count guard
                a, b = _fit_line(tgt_edge[nb])
                # condition-number guard: dead code in the reference
                # (geometry.cpp:55-56) — never rejects
                if not (np.isfinite(a).all() and np.isfinite(b).all()):
                    continue
                e_valid[s] = True
                e_match[s] = nb[0]
                e_a[s], e_b[s] = a, b

        # --- plane association (registration.cpp:65-103) --------------------
        p_valid = np.zeros(Q, bool)
        p_match = np.full(Q, -1, np.int64)
        p_n = np.zeros((Q, 3))
        p_d = np.zeros(Q)
        if Q and len(tgt_planar):
            idx, val = _knn(
                qp, tgt_planar, params.num_plane_neighbors, params.max_plane_neighbor_dist
            )
            for s in range(Q):
                nb = idx[s][val[s]]
                if len(nb) < params.min_plane_fit_points:
                    continue
                n, d = _fit_plane(tgt_planar[nb])
                # avg-dist guard: signed mean residual of the PCA fit is 0
                # (registration.cpp:90 + geometry.cpp:71 effective behavior)
                if not (np.isfinite(n).all() and np.isfinite(d)):
                    continue
                p_valid[s] = True
                p_match[s] = nb[0]
                p_n[s], p_d[s] = n, d

        # --- insufficient check BEFORE solving (§2.3(9)) --------------------
        if int(e_valid.sum()) + int(p_valid.sum()) < params.min_associations:
            termination = int(TerminationType.INSUFFICIENT_ASSOCIATIONS)
            break

        delta = _lm_solve(
            qe[e_valid],
            {"a": e_a[e_valid], "b": e_b[e_valid]},
            qp[p_valid],
            {"n": p_n[p_valid], "d": p_d[p_valid]},
            params,
        )

        iterations.append(
            OracleIteration(
                est_in_q=est.q.copy(),
                est_in_t=est.t.copy(),
                edge_valid=e_valid,
                edge_match=e_match,
                plane_valid=p_valid,
                plane_match=p_match,
                delta_q=delta.q.copy(),
                delta_t=delta.t.copy(),
            )
        )

        # --- left-compose, then convergence check (§2.3(10)) ----------------
        est = OraclePose(
            _normalize(_quat_multiply(delta.q, est.q)),
            _quat_rotate(delta.q, est.t) + delta.t,
        )
        angle = 2.0 * np.arctan2(np.linalg.norm(delta.q[1:]), abs(delta.q[0]))
        if (
            angle < params.rotation_convergence_thresh
            and np.linalg.norm(delta.t) < params.position_convergence_thresh
        ):
            termination = int(TerminationType.CONVERGED)
            break

    return OracleResult(q=est.q, t=est.t, termination=termination, iterations=iterations)
