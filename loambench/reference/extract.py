"""LOAM feature extraction, plain PyTorch: curvature, the validity mask and
the greedy sector pick of the reference library (DanMcGann/loam,
``features-inl.h`` and ``features.cpp``), vectorised over frames and scan
lines and serial over a sector's points, as the library walks them.

The picks are laid out as the port lays out its feature sets: per line,
per sector, ``cap + 1`` slots in pick order, -1 where nothing was picked
(``edge`` then ``planar``). Sectors are sorted stably by (curvature,
index), the oracle's canonical tie order."""

from __future__ import annotations

import torch


def curvature(pts: torch.Tensor, N: int) -> torch.Tensor:
    """(R, P) curvature of (R, P, 3) lines; -1 on the N points at each end."""
    P = pts.shape[1]
    d = -(2.0 * N) * pts[:, N:P - N]
    for n in range(1, N + 1):
        d = d + (pts[:, N - n:P - N - n] + pts[:, N + n:P - N + n])
    curv = torch.full(pts.shape[:2], -1.0, dtype=pts.dtype, device=pts.device)
    curv[:, N:P - N] = torch.sum(d * d, dim=-1)
    return curv


def valid_points(pts: torch.Tensor, N: int, min_range: float, max_range: float, occlusion: float,
                 parallel: float) -> torch.Tensor:
    """(R, P) validity of (R, P, 3) lines (``features.cpp:18-70``): the
    checks of each interior point, each of which clears the point itself or
    some of its neighbours on the line."""
    R, P = pts.shape[:2]
    r = torch.linalg.vector_norm(pts, dim=-1)
    dev = pts.device
    mask = torch.ones((R, P), dtype=torch.bool, device=dev)
    mask[:, :N] = False
    mask[:, P - N:] = False
    j = torch.arange(N, P - N, device=dev)
    pr, cr, nr = r[:, j - 1], r[:, j], r[:, j + 1]
    out = (cr < min_range) | (cr > max_range)
    case1 = ~out & (nr - cr > occlusion)
    case2 = ~out & ~case1 & (cr - nr > occlusion)
    flat = ~out & ~case1 & ~case2 & (torch.abs(pr - cr) > parallel * cr) & (torch.abs(nr - cr) > parallel * cr)
    clear = torch.zeros((R, P), dtype=torch.bool, device=dev)

    def hit(cond, offsets):
        for o in offsets:
            clear[:, N + o:P - N + o] |= cond

    hit(out, range(-N, N + 1))
    hit(case1, range(1, N + 1))
    hit(case2, range(-(N - 1), 1))
    hit(flat, (0,))
    return mask & ~clear


def pick(curv: torch.Tensor, valid: torch.Tensor, N: int, S: int, max_e: int, max_p: int,
         edge_thr: float, planar_thr: float):
    """The greedy sector pick (``features-inl.h:137-180``) of (R, P) lines:
    per sector, the edge pass by descending curvature, then the planar pass
    by ascending curvature; an accepted point clears ``idx +- (N-1)``.
    Returns (edge picks (R, S, max_e + 1), planar picks (R, S, max_p + 1)),
    int64 point indices within the line, -1 padded."""
    R, P = curv.shape
    dev = curv.device
    pps = P // S
    mask = valid.clone()
    rows = torch.arange(R, device=dev)
    edges = torch.full((R, S, max_e + 1), -1, dtype=torch.int64, device=dev)
    planars = torch.full((R, S, max_p + 1), -1, dtype=torch.int64, device=dev)
    for s in range(S):
        start = s * pps
        end = P if s == S - 1 else start + pps
        key = curv[:, start:end]
        order = torch.argsort(key, dim=1, stable=True) + start  # ascending (curvature, index)
        for out, cap, seq, ok_curv in ((edges, max_e, order.flip(1), lambda c: c > edge_thr),
                                       (planars, max_p, order, lambda c: c < planar_thr)):
            count = torch.zeros(R, dtype=torch.int64, device=dev)
            for t in range(seq.shape[1]):
                idx = seq[:, t]
                ok = mask[rows, idx] & ok_curv(curv[rows, idx]) & (count <= cap)
                slot = count.clamp(max=cap)
                out[rows, s, slot] = torch.where(ok, idx, out[rows, s, slot])
                for o in range(-(N - 1), N):
                    q = (idx + o).clamp(0, P - 1)
                    mask[rows, q] = mask[rows, q] & ~ok
                count = count + ok.long()
    return edges, planars


def features(scans: torch.Tensor, lidar: dict, fp: dict):
    """Edge and planar features of (F, L, P, 3) scans: (edge points (F, E,
    3), edge mask (F, E), planar points (F, Q, 3), planar mask (F, Q)) in
    the scans' dtype, E = L S (max_e + 1) and Q = L S (max_p + 1) slots.
    Curvature and validity are decided in float64 (the configuration's
    ``precise_selection``)."""
    F, L, P, _ = scans.shape
    N, S = fp["neighbor_points"], fp["number_sectors"]
    lines = scans.reshape(F * L, P, 3)
    x = lines.to(torch.float64)
    curv = curvature(x, N)
    valid = valid_points(x, N, lidar["min_range"], lidar["max_range"], fp["occlusion_thresh"],
                         fp["parallel_thresh"])
    e, p = pick(curv, valid, N, S, fp["max_edge_feats_per_sector"], fp["max_planar_feats_per_sector"],
                fp["edge_feat_threshold"], fp["planar_feat_threshold"])
    out = []
    for picks in (e, p):
        flat = picks.reshape(F * L, -1)
        mask = flat >= 0
        pts = torch.gather(lines, 1, flat.clamp(min=0)[..., None].expand(-1, -1, 3))
        pts = torch.where(mask[..., None], pts, torch.zeros_like(pts))
        out += [pts.reshape(F, -1, 3), mask.reshape(F, -1)]
    return tuple(out)
