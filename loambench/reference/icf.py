"""ICF registration, plain PyTorch, batched over pairs: the loop of the
reference library (``registration-inl.h:28-74``, ``registration.cpp:23-103``)
as the NumPy oracle transcribes it, with the port's solver arithmetic
(Huber-weighted Levenberg-Marquardt on a left-composed twist, the optional
quadratic prior toward the initialisation).

Each outer iteration: move the source by the estimate, find every source
feature's k nearest targets (brute force, then the strict radius filter),
fit a line (edges) or a plane (planars) by PCA to those in reach, give up
on a pair with fewer than ``min_associations`` fits before solving, solve
for the delta, left-compose it, and stop a pair once the delta is under
both convergence thresholds.

``dtype`` is the precision of the search and the fits; the solve runs in
float64, or float32 where the search runs below float32 (``torch.linalg``
has no bfloat16)."""

from __future__ import annotations

import torch

from . import geom

#: Query rows a distance block holds, at most (the (rows, M) block of a
#: 131,072-slot map in float64 is 2 GiB at 2,048 rows).
KNN_ROWS = 2048
#: 3x3 eigen-decompositions a call, at most.
EIGH_BATCH = 8192

CONVERGED, MAX_ITER, INSUFFICIENT = 0, 1, 2


def knn(q, qmask, t, tmask, k: int, radius: float):
    """(B, Q, k) indices of the nearest unmasked targets of each query and
    whether each lies strictly within ``radius`` (and the query is
    unmasked), from squared distances in the points' dtype."""
    B, Q, _ = q.shape
    idx = torch.zeros((B, Q, k), dtype=torch.int64, device=q.device)
    ok = torch.zeros((B, Q, k), dtype=torch.bool, device=q.device)
    inf = torch.tensor(float("inf"), dtype=q.dtype, device=q.device)
    tn = torch.sum(t * t, dim=-1)
    for s in range(0, Q, KNN_ROWS):
        qs = q[:, s:s + KNN_ROWS]
        d2 = torch.sum(qs * qs, dim=-1)[..., None] + tn[:, None, :] - 2.0 * (qs @ t.transpose(1, 2))
        d2 = torch.where(tmask[:, None, :], torch.clamp(d2, min=0), inf)
        kk = min(k, t.shape[1])
        val, ind = torch.topk(d2, kk, dim=-1, largest=False, sorted=True)
        idx[:, s:s + KNN_ROWS, :kk] = ind
        ok[:, s:s + KNN_ROWS, :kk] = torch.isfinite(val) & (torch.sqrt(val.float() if val.dtype == torch.bfloat16
                                                                             else val) < radius)
    return idx, ok & qmask[..., None]


def _moments(nb, m):
    """Masked centre and covariance of neighbour sets (..., k, 3)."""
    w = m.to(nb.dtype)[..., None]
    count = torch.clamp(torch.sum(w, dim=-2), min=1.0)
    center = torch.sum(nb * w, dim=-2) / count
    c = (nb - center[..., None, :]) * w
    return center, c.transpose(-1, -2) @ c


def _eigvecs(cov):
    """Eigenvectors (ascending eigenvalues) of a stack of 3x3 covariances,
    ``EIGH_BATCH`` matrices a call: cuSOLVER's batched solver refused the
    planar fits of a chunk of 4 pairs (78,336 matrices) and 32,768, and
    took 19,584. A covariance that is not finite gets NaN vectors, as
    LAPACK gives it, without reaching cuSOLVER."""
    flat = cov.reshape(-1, 3, 3)
    bad = ~torch.isfinite(flat).all(-1).all(-1)
    flat = torch.where(bad[:, None, None], torch.zeros_like(flat), flat)
    out = torch.cat([torch.linalg.eigh(flat[s:s + EIGH_BATCH])[1] for s in range(0, flat.shape[0], EIGH_BATCH)])
    out = torch.where(bad[:, None, None], torch.full_like(out, float("nan")), out)
    return out.reshape(cov.shape)


def associate(q, qmask, t, tmask, k, radius, min_fit, plane: bool, solve_dtype):
    """Fits for every source feature: edges ``(a, b, valid)`` with
    ``a, b = centre +- 0.1 direction``; planes ``(normal, d, valid)`` with
    ``d >= 0``. Fits run in ``solve_dtype``."""
    idx, ok = knn(q, qmask, t, tmask, k, radius)
    B = q.shape[0]
    nb = torch.gather(t, 1, idx.reshape(B, -1, 1).expand(-1, -1, 3)).reshape(idx.shape + (3,))
    nb = nb.to(solve_dtype)
    count = ok.sum(-1)
    center, cov = _moments(nb, ok)
    vecs = _eigvecs(cov)
    if plane:
        n = vecs[..., :, 0]
        d = torch.sum(n * center, dim=-1)
        flip = torch.where(d < 0, -1.0, 1.0).to(n.dtype)
        n, d = n * flip[..., None], d * flip
        valid = qmask & (count >= min_fit) & torch.isfinite(n).all(-1) & torch.isfinite(d)
        return n, d, valid
    v = vecs[..., :, 2]
    a, b = center + 0.1 * v, center - 0.1 * v
    valid = qmask & (count >= min_fit) & torch.isfinite(a).all(-1) & torch.isfinite(b).all(-1)
    return a, b, valid


def _huber(r, delta):
    a = torch.abs(r)
    return torch.where(a <= delta, r * r, delta * (2.0 * a - delta))


def _huber_w(r, delta):
    a = torch.abs(r)
    return torch.where(a <= delta, torch.ones_like(a), delta / torch.where(a > 0, a, torch.ones_like(a)))


def lm(qe, ea, qp, pa, prior_offset, rp: dict):
    """Levenberg-Marquardt for the delta over fixed fits (the port's
    ``solver.lm_solve``): ``inner_iterations`` damped steps, each accepted
    only if it lowers the Huber cost (plus the prior's)."""
    dtype, dev = qe.dtype, qe.device
    B = qe.shape[0]
    a, b, ev = ea
    n, d, pv = pa
    hd, pw = rp["huber_delta"], rp["prior_weight"]
    eye = torch.eye(6, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def linearize(delta):
        xe, xp = geom.act(delta, qe), geom.act(delta, qp)
        c = torch.cross(xe - a, xe - b, dim=-1)
        cn = torch.linalg.vector_norm(c, dim=-1)
        abn = torch.linalg.vector_norm(a - b, dim=-1)
        re = cn / torch.where(abn > 0, abn, torch.ones_like(abn))
        big = cn > 1e-12
        ge = torch.cross(a - b, c, dim=-1) / torch.where(big, cn * abn, torch.ones_like(cn))[..., None]
        ge = torch.where(big[..., None], ge, zero)
        s = torch.sum(xp * n, dim=-1) - d
        r = torch.cat([re, torch.abs(s)], -1)
        g_ = torch.cat([ge, torch.sign(s)[..., None] * n], -2)
        x = torch.cat([xe, xp], -2)
        m = torch.cat([ev, pv], -1)
        cost = torch.sum(torch.where(m, _huber(r, hd), zero), -1)
        J = torch.where(m[..., None], torch.cat([torch.cross(x, g_, dim=-1), g_], -1), zero)
        r = torch.where(m, r, zero)
        w = torch.where(m, _huber_w(r, hd), zero)
        wJ = w[..., None] * J
        H = wJ.transpose(-1, -2) @ J
        g = torch.sum(wJ * r[..., None], -2)
        if pw > 0:
            tq, tt = geom.compose(delta, prior_offset)
            xi = torch.cat([geom.qlog(tq), tt], -1)
            cost = cost + pw * torch.sum(xi * xi, -1)
            H = H + pw * eye
            g = g + pw * xi
        return cost, H, g

    delta = geom.identity((B,), dtype, dev)
    lam = torch.full((B,), 1e-4, dtype=dtype, device=dev)
    cost, H, g = linearize(delta)
    for _ in range(rp["inner_iterations"]):
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        damp = lam[:, None] * diag + 1e-6 * diag.amax(-1, keepdim=True) + 1e-10
        step = -torch.linalg.solve(H + torch.diag_embed(damp), g[..., None])[..., 0]
        dq = geom.qexp(step[:, :3])
        cand = (geom.qnormalize(geom.qmul(dq, delta[0])), geom.qrot(dq, delta[1]) + step[:, 3:])
        nc, nH, ng = linearize(cand)
        acc = nc < cost
        delta = (torch.where(acc[:, None], cand[0], delta[0]), torch.where(acc[:, None], cand[1], delta[1]))
        cost = torch.where(acc, nc, cost)
        H = torch.where(acc[:, None, None], nH, H)
        g = torch.where(acc[:, None], ng, g)
        lam = torch.where(acc, torch.clamp(lam / 3.0, min=1e-12), torch.clamp(lam * 4.0, max=1e8))
    return delta


def register(src, tgt, init, rp: dict, dtype=torch.float64):
    """Register B sources to B targets.

    ``src`` / ``tgt``: (edge points (B, E, 3), edge mask, planar points
    (B, Q, 3), planar mask); ``init``: (quaternions (B, 4), translations
    (B, 3)). Returns (estimate pose, iterations solved (B,), termination
    (B,), the first iteration's fits (edges (B,), planes (B,)))."""
    solve = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
    se, sem, sp, spm = src
    te, tem, tp, tpm = tgt
    se, sp, te, tp = (x.to(dtype) for x in (se, sp, te, tp))
    B, dev = se.shape[0], se.device
    est = (init[0].to(solve), init[1].to(solve))
    init_inv = geom.inverse(est)
    running = torch.ones(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    term = torch.full((B,), MAX_ITER, dtype=torch.int64, device=dev)
    first = None
    for _ in range(rp["max_iterations"]):
        if not bool(running.any()):
            break
        qe = geom.act(est, se.to(solve)).to(dtype)
        qp = geom.act(est, sp.to(solve)).to(dtype)
        ea = associate(qe, sem, te, tem, rp["num_edge_neighbors"], rp["max_edge_neighbor_dist"],
                       rp["min_line_fit_points"], False, solve)
        pa = associate(qp, spm, tp, tpm, rp["num_plane_neighbors"], rp["max_plane_neighbor_dist"],
                       rp["min_plane_fit_points"], True, solve)
        ne, npl = ea[2].sum(-1), pa[2].sum(-1)
        insufficient = running & (ne + npl < rp["min_associations"])
        if first is None:  # an iteration that gave up records no fits
            first = (torch.where(insufficient, 0, ne), torch.where(insufficient, 0, npl))
        term = torch.where(insufficient, INSUFFICIENT, term)
        delta = lm(qe.to(solve), ea, qp.to(solve), pa, geom.compose(est, init_inv), rp)
        live = running & ~insufficient
        new = (geom.qnormalize(geom.qmul(delta[0], est[0])), geom.qrot(delta[0], est[1]) + delta[1])
        est = (torch.where(live[:, None], new[0], est[0]), torch.where(live[:, None], new[1], est[1]))
        conv = live & (geom.angle(delta[0]) < rp["rotation_convergence_thresh"]) & (
            torch.linalg.vector_norm(delta[1], dim=-1) < rp["position_convergence_thresh"])
        term = torch.where(conv, CONVERGED, term)
        iters = iters + live.long()
        running = live & ~conv
    return est, iters, term, first
