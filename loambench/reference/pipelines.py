"""The plain reference of each path the benchmark drives, from the scans
alone: its own features, registrations, maps and keyframes, in float64
(or in a lower precision, for the control).

* :func:`offline` -- scan-to-scan odometry over a segment: pair p takes
  frame p + 1 as source and frame p as target; pairs are registered in
  chunks of ``chunk_pairs``, each chunk's pairs starting, with
  ``motion_init``, from the last relative pose of the chunk before.
* :func:`scan_to_map` -- scan-to-map odometry: each frame registered
  against voxel maps of the keyframes so far from a constant-velocity
  prediction (the solver's prior pulls toward it), held at its prediction
  while the maps are empty, and inserted into the maps when it has moved
  ``keyframe_dist`` or turned ``keyframe_angle`` since the last keyframe.
"""

from __future__ import annotations

import torch

from . import extract, geom, icf, maps

#: Precisions below float32: the control's. Scans and maps are rounded to
#: them and the searches run in them; fits and solves run in float32.
LOW = (torch.bfloat16, torch.float16)


def _trajectory(rel_q, rel_t):
    """World poses (F, 4), (F, 3) of F - 1 relative poses, frame 0 at the
    identity."""
    q, t = geom.identity((), rel_q.dtype, rel_q.device)
    qs, ts = [q], [t]
    for i in range(rel_q.shape[0]):
        q, t = geom.compose((q, t), (rel_q[i], rel_t[i]))
        qs.append(geom.qnormalize(q))
        ts.append(t)
    return torch.stack(qs), torch.stack(ts)


def offline(scans, lidar: dict, fp: dict, rp: dict, chunk_pairs: int, motion_init: bool,
            dtype=torch.float64) -> dict:
    """Returns ``trajectory`` ((F, 4), (F, 3)), the relative poses ``rel``
    ((F-1, 4), (F-1, 3)), ``iterations`` and ``first_fits`` (F-1,) a pair."""
    solve = torch.float32 if dtype in LOW else dtype
    feats = extract.features(scans.to(dtype) if dtype in LOW else scans, lidar, fp)
    F, dev = scans.shape[0], scans.device
    n = F - 1
    C = chunk_pairs if 0 < chunk_pairs < n else n
    carry = geom.identity((), solve, dev)
    rq, rt, its, fits = [], [], [], []
    for c0 in range(0, n, C):
        rows = torch.arange(c0, min(c0 + C, n), device=dev)
        src = tuple(x[rows + 1] for x in feats)
        tgt = tuple(x[rows] for x in feats)
        B = rows.shape[0]
        init = (carry[0].expand(B, 4), carry[1].expand(B, 3)) if motion_init else geom.identity((B,), solve, dev)
        est, iters, _, first = icf.register(src, tgt, init, rp, dtype)
        if motion_init and B == C:
            carry = (est[0][-1], est[1][-1])
        rq.append(est[0])
        rt.append(est[1])
        its.append(iters)
        fits.append(first[0] + first[1])
    rel = (torch.cat(rq), torch.cat(rt))
    return {"trajectory": _trajectory(*rel), "rel": rel, "iterations": torch.cat(its),
            "first_fits": torch.cat(fits)}


def scan_to_map(scans, lidar: dict, fp: dict, rp: dict, cfg: dict, source_order: str = "morton",
                dtype=torch.float64) -> dict:
    """Returns ``trajectory`` ((F, 4), (F, 3)), ``iterations`` and
    ``first_fits`` (F,), the keyframe flags (F,), and the final maps
    (``edge_map`` / ``planar_map``: points and mask) and ``dropped``.
    ``source_order``: the order in which a frame's features reach the map
    (``"morton"``: by the Z-order of their 1 m sensor-frame cell, the
    single-device step's; ``"azimuth"``: by ``atan2(y, x)``, the sharded
    step's), which decides which new point keeps a voxel."""
    ex, exm, px, pxm = extract.features(scans.to(dtype) if dtype in LOW else scans, lidar, fp)
    F, dev = scans.shape[0], scans.device
    solve = torch.float32 if dtype in LOW else dtype
    store = dtype if dtype in LOW else torch.float64
    maps_ = {}
    for name, cap, vox in (("edge", cfg["edge_capacity"], cfg["edge_voxel_size"]),
                           ("planar", cfg["planar_capacity"], cfg["planar_voxel_size"])):
        maps_[name] = [torch.zeros((cap, 3), dtype=store, device=dev),
                       torch.zeros(cap, dtype=torch.bool, device=dev), vox, cap]
    cur = geom.identity((), solve, dev)
    prev = geom.identity((), solve, dev)
    kf = geom.identity((), solve, dev)
    since = -1
    dropped = 0
    qs, ts, its, fits, keyframes = [], [], [], [], []
    for f in range(F):
        src = [ex[f], exm[f], px[f], pxm[f]]
        for i in (0, 2):  # the order the frame's features reach the maps
            key = _order_key(src[i], src[i + 1], source_order)
            perm = torch.sort(key, stable=True)[1]
            src[i], src[i + 1] = src[i][perm], src[i + 1][perm]
        init = geom.compose(cur, prev)
        # the live slots are a prefix: search those (at least one slot)
        ne = max(1, int(maps_["edge"][1].sum()))
        npl = max(1, int(maps_["planar"][1].sum()))
        tgt = (maps_["edge"][0][None, :ne], maps_["edge"][1][None, :ne], maps_["planar"][0][None, :npl],
               maps_["planar"][1][None, :npl])
        est, iters, _, first = icf.register(tuple(x[None] for x in src), tgt, (init[0][None], init[1][None]),
                                            rp, dtype)
        new = (est[0][0], est[1][0])
        if since < 0:
            new = cur
        rel_q = geom.qmul(geom.qconj(kf[0]), new[0])
        ang = float(geom.angle(rel_q))
        dist = float(torch.linalg.vector_norm(new[1] - kf[1]))
        insert = since < 0 or dist > cfg["keyframe_dist"] or ang > cfg["keyframe_angle"]
        if insert:
            for name, (pts, m) in (("edge", src[:2]), ("planar", src[2:])):
                mp = maps_[name]
                world = geom.act((new[0].to(torch.float64), new[1].to(torch.float64)), pts.to(torch.float64)[None])[0]
                mp[0], mp[1], d = maps.insert(mp[0], mp[1], world, m, mp[2], mp[3],
                                              new[1].to(torch.float64), cfg["keep_radius"])
                dropped += d
        prev_q, prev_t = geom.compose(geom.inverse(cur), new)
        prev = (geom.qnormalize(prev_q), prev_t)
        cur = (geom.qnormalize(new[0]), new[1])
        if insert:
            kf = new
        since = 0 if insert else max(since, 0) + 1
        qs.append(cur[0])
        ts.append(cur[1])
        its.append(iters[0])
        fits.append(first[0][0] + first[1][0])
        keyframes.append(insert)
    return {"trajectory": (torch.stack(qs), torch.stack(ts)), "iterations": torch.stack(its),
            "first_fits": torch.stack(fits), "keyframes": torch.tensor(keyframes),
            "edge_map": maps_["edge"][:2], "planar_map": maps_["planar"][:2], "dropped": dropped}


def _order_key(points, mask, how: str):
    """Sort key of a frame's feature slots, masked slots last."""
    if how == "azimuth":
        az = torch.atan2(points[:, 1].to(torch.float64), points[:, 0].to(torch.float64))
        return torch.where(mask, az, torch.full_like(az, 1e9))
    k = maps.morton(points, 1.0)
    return torch.where(mask, k, torch.full_like(k, 1 << 40))


def keyframe_count(trajectory, cfg: dict) -> int:
    """Keyframes of a trajectory (F, 4), (F, 3) by the scan-to-map rule,
    frame 0 included."""
    q, t = trajectory
    kq, kt, n = q[0], t[0], 1
    for f in range(1, q.shape[0]):
        ang = float(geom.angle(geom.qmul(geom.qconj(kq), q[f])))
        if float(torch.linalg.vector_norm(t[f] - kt)) > cfg["keyframe_dist"] or ang > cfg["keyframe_angle"]:
            kq, kt, n = q[f], t[f], n + 1
    return n


def gaps(a, b):
    """Per pose (translation gap m, rotation gap rad) between two pose
    stacks ((N, 4), (N, 3)), in float64."""
    aq, at = (x.to(torch.float64) for x in a)
    bq, bt = (x.to(torch.float64) for x in b)
    dt = torch.linalg.vector_norm(at - bt, dim=-1)
    dq = geom.angle(geom.qnormalize(geom.qmul(geom.qconj(aq), bq)))
    return dt, dq


def relative(trajectory):
    """Relative poses ``world_i^-1 world_{i+1}`` of a trajectory."""
    q, t = (x.to(torch.float64) for x in trajectory)
    return geom.compose(geom.inverse((q[:-1], t[:-1])), (q[1:], t[1:]))


def ate(translations, truth) -> float:
    """RMS of the position error against the truth, no alignment
    (``bench.py::_check_accuracy``'s ATE)."""
    d = translations.to(torch.float64) - torch.as_tensor(truth, dtype=torch.float64, device=translations.device)
    return float(torch.sqrt(torch.mean(torch.sum(d * d, dim=-1))))


def ate_limit(truth) -> float:
    """The ATE gate: 5% of the path's length, at least 0.05 m."""
    t = torch.as_tensor(truth, dtype=torch.float64)
    return max(0.05 * float(torch.sum(torch.linalg.vector_norm(t[1:] - t[:-1], dim=-1))), 0.05)

