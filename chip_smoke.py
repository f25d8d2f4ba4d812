#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU: build, kernel checks, main path.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  0. Require CUDA; print the GPU's name and power limit (``nvidia-smi``),
     and the torch and CUDA versions; turn TF32 off.
  1. Build the four CUDA kernels from ``loam_tpu_torch/ops/csrc`` and print
     the build time.
  2. Run every kernel and its plain PyTorch version on the same inputs at
     the main path's shapes (16 synthetic 64x1024 scans, the first chunk of
     4 pairs), require equal results, and time both with CUDA events.
  3. Drive the main path -- ``odometry_offline`` on those 16 frames,
     ``chunk_pairs=4``, ``motion_init=True`` -- with every launch counter
     reset first; require each kernel to have launched, finite poses of the
     right shape and the benchmark's ATE gate; time 3 runs after a warm-up.
  4. Check agreement with the plain versions on a small input: the same
     driver on 6 frames of 16x360 scans on the GPU and on the CPU.

It prints a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

ATOL_SMALL_M = 1e-2  # GPU-vs-CPU trajectory agreement (the ICF position convergence threshold)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(a, b) -> float:
    import torch

    return float(torch.max(torch.abs(a.double() - b.double())).item()) if a.numel() else 0.0


def _require_equal(name, a, b):
    import torch

    if a.shape != b.shape or not torch.equal(a, b):
        bad = int((a != b).sum().item()) if a.shape == b.shape else -1
        raise AssertionError(f"{name}: kernel differs from the plain version ({bad} entries)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    import loam_tpu_torch as T
    from loam_tpu_torch.evaluation import ate_rmse
    from loam_tpu_torch.features.curvature import compute_curvature, compute_valid_points
    from loam_tpu_torch.io import render_trajectory
    from loam_tpu_torch.ops import _build, assemble_cuda, bitonic_cuda, knn_cuda, nms_cuda

    smi = _smi()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.last_build_seconds:.2f} s) -> {_build.library_path().name}")

    # ---- 2. kernels vs plain versions at the main path's shapes -------------
    lidar = T.LidarParams(64, 1024, 0.5, 120.0)
    fp = T.FeatureExtractionParams(precise_selection=True)
    rp = T.RegistrationParams(search_backend="bruteforce")
    frames = 16
    scans_np, poses = render_trajectory(
        lidar, frames, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
        noise=0.005, seed=0, dtype=np.float32,
    )
    scans = torch.from_numpy(scans_np).to(dev)
    L, P, S = lidar.scan_lines, lidar.points_per_line, fp.number_sectors
    n_lines = frames * L
    kernels = []

    curv = compute_curvature(scans, lidar, fp).reshape(n_lines, P).contiguous()
    valid = compute_valid_points(scans, lidar, fp).reshape(n_lines, P).contiguous()
    sc_k, sp_k = bitonic_cuda.sector_sort(curv, S)
    sc_r, sp_r = bitonic_cuda.sector_sort_reference(curv, S)
    torch.cuda.synchronize()
    _require_equal("sector_sort positions", sp_k, sp_r)
    _require_equal("sector_sort keys", sc_k, sc_r)
    kernels.append(dict(
        name="sector_sort", route="cuda", source="loam_tpu_torch/ops/csrc/sector_sort.cu",
        replaces="loam_tpu/ops/bitonic.py:197", shape=f"curv f64 ({n_lines}, {P}), S={S}",
        max_abs_err=max(_max_err(sp_k, sp_r), _max_err(sc_k, sc_r)),
        ms=_time_ms(lambda: bitonic_cuda.sector_sort(curv, S), 20),
        plain_ms=_time_ms(lambda: bitonic_cuda.sector_sort_reference(curv, S), 5),
    ))

    real = sc_k < float("inf")
    neg = torch.full_like(sp_k, -1)
    cand_e = torch.where(real & (sc_k > fp.edge_feat_threshold), sp_k, neg).flip(-1).contiguous()
    cand_p = torch.where(real & (sc_k < fp.planar_feat_threshold), sp_k, neg).contiguous()
    me, mp, n = fp.max_edge_feats_per_sector, fp.max_planar_feats_per_sector, fp.neighbor_points
    pe_k, pp_k = nms_cuda.greedy_nms(valid, cand_e, cand_p, me, mp, n)
    pe_r, pp_r = nms_cuda.greedy_nms_reference(valid, cand_e, cand_p, me, mp, n)
    torch.cuda.synchronize()
    _require_equal("greedy_nms edges", pe_k, pe_r)
    _require_equal("greedy_nms planars", pp_k, pp_r)
    kernels.append(dict(
        name="greedy_nms", route="cuda", source="loam_tpu_torch/ops/csrc/greedy_nms.cu",
        replaces="loam_tpu/ops/nms_pallas.py:85",
        shape=f"valid ({n_lines}, {P}), candidates ({n_lines}, {S}, {cand_e.shape[2]}) x2",
        max_abs_err=max(_max_err(pe_k, pe_r), _max_err(pp_k, pp_r)),
        ms=_time_ms(lambda: nms_cuda.greedy_nms(valid, cand_e, cand_p, me, mp, n), 20),
        plain_ms=_time_ms(lambda: nms_cuda.greedy_nms_reference(valid, cand_e, cand_p, me, mp, n), 1),
    ))

    picks = torch.cat([pe_k.reshape(n_lines, -1), pp_k.reshape(n_lines, -1)], dim=1).contiguous()
    pts = scans.reshape(n_lines, P, 3).contiguous()
    sel_k = assemble_cuda.select_points(pts, picks)
    sel_r = assemble_cuda.select_points_reference(pts, picks)
    torch.cuda.synchronize()
    _require_equal("select_points", sel_k, sel_r)
    kernels.append(dict(
        name="select_points", route="cuda", source="loam_tpu_torch/ops/csrc/select_points.cu",
        replaces="loam_tpu/ops/assemble_pallas.py:37",
        shape=f"pts ({n_lines}, {P}, 3) f32, picks ({n_lines}, {picks.shape[1]})",
        max_abs_err=_max_err(sel_k, sel_r),
        ms=_time_ms(lambda: assemble_cuda.select_points(pts, picks), 50),
        plain_ms=_time_ms(lambda: assemble_cuda.select_points_reference(pts, picks), 50),
    ))

    # kNN: the first chunk's 4 pairs at the first ICF iteration (identity
    # start), both classes, from the port's own extraction
    feats = T.extract_features_batch(scans, lidar, fp, post=T.registration.azimuth_sort_features)
    C = 4
    knn_err, knn_ms, knn_plain_ms, knn_shape = 0.0, None, None, ""
    for cls, k, r in (("planar", rp.num_plane_neighbors, rp.max_plane_neighbor_dist),
                      ("edge", rp.num_edge_neighbors, rp.max_edge_neighbor_dist)):
        tgt_pts = getattr(feats, f"{cls}_points")[:C]
        tgt_mask = getattr(feats, f"{cls}_mask")[:C]
        q = getattr(feats, f"{cls}_points")[1:C + 1].contiguous()
        qm = getattr(feats, f"{cls}_mask")[1:C + 1].contiguous()
        prep = knn_cuda.knn_prep(tgt_pts, tgt_mask)
        a = knn_cuda.knn_run(prep, q, k, r, with_coords=True, query_mask=qm)
        b = knn_cuda.knn_run_reference(prep, q, k, r, with_coords=True, query_mask=qm)
        torch.cuda.synchronize()
        _require_equal(f"knn {cls} mask", a.mask, b.mask)
        m = b.mask
        _require_equal(f"knn {cls} first_idx", a.first_idx[m[:, 0]], b.first_idx[m[:, 0]])
        for ax in ("xs", "ys", "zs"):
            _require_equal(f"knn {cls} {ax}", getattr(a, ax)[m], getattr(b, ax)[m])
        ra = knn_cuda.knn_run(prep, q, k, r, query_mask=qm)
        rb = knn_cuda.knn_run_reference(prep, q, k, r, query_mask=qm)
        torch.cuda.synchronize()
        _require_equal(f"knn {cls} result mask", ra.mask, rb.mask)
        _require_equal(f"knn {cls} indices", ra.indices[rb.mask], rb.indices[rb.mask])
        knn_err = max(knn_err, _max_err(ra.distances[rb.mask], rb.distances[rb.mask]))
        if cls == "planar":
            knn_shape = f"B={C}, Q=M={q.shape[1]} planar (and {feats.edge_points.shape[1]} edge), k={k}"
            knn_ms = _time_ms(lambda: knn_cuda.knn_run(prep, q, k, r, with_coords=True, query_mask=qm), 10)
            knn_plain_ms = _time_ms(lambda: knn_cuda.knn_run_reference(prep, q, k, r, with_coords=True, query_mask=qm), 2)
    if knn_err != 0.0:
        raise AssertionError(f"knn distances differ from the plain version by {knn_err}")
    kernels.append(dict(
        name="knn", route="cuda", source="loam_tpu_torch/ops/csrc/knn.cu",
        replaces="loam_tpu/ops/knn_pallas.py:134", shape=knn_shape,
        max_abs_err=knn_err, ms=knn_ms, plain_ms=knn_plain_ms,
    ))
    for kd in kernels:
        print(f"kernel {kd['name']}: {kd['ms']:.4f} ms (plain {kd['plain_ms']:.4f} ms), "
              f"max_abs_err {kd['max_abs_err']} at {kd['shape']}")

    # ---- 3. the main path ---------------------------------------------------
    counters = {
        "sector_sort": bitonic_cuda.sector_sort,
        "greedy_nms": nms_cuda.greedy_nms,
        "select_points": assemble_cuda.select_points,
        "knn": knn_cuda.knn_run,
    }

    def run():
        return T.odometry_offline(scans, lidar, fp, rp, chunk_pairs=4, motion_init=True)

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj, details = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"main path launches: {launches} (first run {first_s:.3f} s)")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path did not launch: {missing}")
    for kd in kernels:
        kd["launches"] = launches[kd["name"]]

    tr = traj.translation.cpu().numpy()
    if tr.shape != (frames, 3) or traj.rotation.shape != (frames, 4):
        raise AssertionError(f"trajectory shape {tr.shape} / {tuple(traj.rotation.shape)}")
    if not (np.isfinite(tr).all() and torch.isfinite(traj.rotation).all()):
        raise AssertionError("non-finite trajectory")
    gt = np.stack([t for (_, t) in poses])
    ate = ate_rmse(tr, gt, align=False)
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    limit = max(0.05 * path, 0.05)
    print(f"ATE {ate:.6f} m (limit {limit:.6f} m, path {path:.3f} m); "
          f"iterations {details.num_iterations.tolist()}; termination {details.termination.tolist()}")
    if not ate < limit:
        raise AssertionError(f"ATE {ate} m exceeds {limit} m")

    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out, _ = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"main path: {frames * reps / dt:.3f} scans/s ({dt / reps * 1e3:.3f} ms per {frames}-frame run, "
          f"64x1024, chunk_pairs=4) on {smi}")

    # ---- 4. small-input agreement with the plain versions on the CPU -------
    small = T.LidarParams(16, 360, 0.5, 80.0)
    s_np, _ = render_trajectory(small, 6, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                noise=0.003, seed=11, dtype=np.float32)
    tg, dg = T.odometry_offline(torch.from_numpy(s_np).to(dev), small, fp, rp, chunk_pairs=2, motion_init=True)
    tc, dc = T.odometry_offline(torch.from_numpy(s_np), small, fp, rp, chunk_pairs=2, motion_init=True)
    gap = float(np.abs(tg.translation.cpu().numpy() - tc.translation.numpy()).max())
    print(f"small input: GPU vs CPU trajectory max gap {gap:.3e} m (limit {ATOL_SMALL_M}); "
          f"termination {dg.termination.tolist()} vs {dc.termination.tolist()}")
    if not gap < ATOL_SMALL_M:
        raise AssertionError(f"GPU and CPU trajectories differ by {gap} m")

    print(json.dumps({"kernels": [
        {k: kd[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")}
        for kd in kernels
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
