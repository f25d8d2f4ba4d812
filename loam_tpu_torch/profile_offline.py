"""Where the port's drivers spend their time on a CUDA GPU.

    python3 -m loam_tpu_torch.profile_offline [--driver offline] [--dual-knn]
                                              [--frames 16] [--out profile_out]

Runs a driver on synthetic 64x1024 scans as ``chip_smoke.py`` does --
``odometry_offline`` (``chunk_pairs=4``, ``motion_init=True``),
``scan_to_map_offline`` (default ``ScanToMapConfig``; ``scan_to_map_grid``:
the same with ``search_backend="grid"``), a ``scan_to_scan_step(dewarp=True)``
loop, ``odometry_streaming`` (``streaming``: the numpy frames in chunks of
8, packed), or the loop-closed path (``loop_closure``: the 33 keyframes of
``io.square_loop_scans`` written as KITTI ``.bin`` files, read by the native
loader into ``odometry_streaming``, then ``extract_features_batch`` on the
keyframes and ``optimize_trajectory_with_closures``); ``--dual-knn`` sets
``LOAM_ICF_DUAL_KNN=1`` -- then:

  * for ``offline``, stage times on the host clock with a device sync at
    each boundary: batched extraction, then each registration chunk (with
    its ICF iteration count); for ``loop_closure`` likewise: the file-fed
    odometry, the keyframes' extraction, the candidates' verification and
    the pose-graph solve;
  * one ``torch.profiler`` trace of a whole run: device time by kernel name,
    the sum of device kernel time against the wall time (the device's idle
    share), and the number of kernel launches.

Prints a summary and one JSON line; the full kernel table goes to
``<out>/profile_kernels_<driver>.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import loam_tpu_torch as T
from loam_tpu_torch.geometry import Pose3
from loam_tpu_torch.io import render_trajectory, square_loop_scans, write_kitti_bins
from loam_tpu_torch.loop_closure import (
    closure_edges, join_edges, optimize_trajectory_with_closures, propose_candidates, verify_closures)
from loam_tpu_torch.pose_graph import odometry_edges, optimize_pose_graph
from loam_tpu_torch.registration import azimuth_sort_features

#: The loop-closed path's settings: 8 candidates a call, revisits at least
#: half the loop apart and within 1 m, 10 pose-graph iterations.
LOOP_CLOSURE_KW = dict(max_candidates=8, min_separation=16, max_distance=1.0, iterations=10)


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _offline_stages(scans, lidar, fp, rp, frames, dev):
    """odometry_offline's steps, each closed by a device sync: batched
    extraction, then each chunk of 4 pairs."""
    feats, extract_ms = _sync_time(
        lambda: T.extract_features_batch(scans, lidar, fp, post=azimuth_sort_features))
    src, tgt = feats.map(lambda x: x[1:]), feats.map(lambda x: x[:-1])
    C, n_pairs = 4, frames - 1
    carry = Pose3.identity(torch.float32, (), dev)
    chunks = []
    for c in range(-(-n_pairs // C)):
        part = lambda x: x[c * C: (c + 1) * C]
        s, t = src.map(part), tgt.map(part)
        b = s.edge_mask.shape[0]
        init = Pose3(carry.rotation.expand(b, 4), carry.translation.expand(b, 3))
        (rel, det), ms = _sync_time(lambda: T.register_features_batch(s, t, init, rp))
        carry = Pose3(rel.rotation[-1], rel.translation[-1])
        chunks.append({"pairs": b, "ms": ms, "iterations": int(det.num_iterations.max())})
    return extract_ms, chunks


def _loop_closure_stages(paths, scans, lidar, fp, rp):
    """The loop-closed path's steps, each closed by a device sync."""
    kw = LOOP_CLOSURE_KW
    (traj, _), odo_ms = _sync_time(
        lambda: T.odometry_streaming(paths, lidar, fp, rp, chunk_frames=8, packed=True))
    feats, extract_ms = _sync_time(lambda: T.extract_features_batch(scans, lidar, fp))
    cand, propose_ms = _sync_time(lambda: propose_candidates(
        traj, kw["max_candidates"], kw["min_separation"], kw["max_distance"]))
    clo, verify_ms = _sync_time(lambda: verify_closures(traj, feats, *cand, rp))
    edges = join_edges(odometry_edges(traj), closure_edges(clo))
    _, solve_ms = _sync_time(lambda: optimize_pose_graph(traj, edges, kw["iterations"]))
    return {"odometry_ms": odo_ms, "extract_ms": extract_ms, "propose_ms": propose_ms,
            "verify_ms": verify_ms, "solve_ms": solve_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--driver", default="offline",
                    choices=("offline", "scan_to_map", "scan_to_map_grid", "scan_to_scan", "streaming",
                             "loop_closure"))
    ap.add_argument("--dual-knn", action="store_true", help="set LOAM_ICF_DUAL_KNN=1")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_offline: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lidar = T.LidarParams(64, 1024, 0.5, 120.0)
    fp = T.FeatureExtractionParams(precise_selection=True)
    rp = T.RegistrationParams(search_backend="bruteforce")
    if args.driver == "loop_closure":
        scans_np, _, _ = square_loop_scans(lidar)
        args.frames = len(scans_np)
        tmp = tempfile.TemporaryDirectory()
        paths = write_kitti_bins(scans_np, tmp.name)
    else:
        scans_np, _ = render_trajectory(lidar, args.frames, step=np.array([0.08, 0.02, 0.0]),
                                        yaw_rate=0.01, noise=0.005, seed=0, dtype=np.float32)
    scans = torch.from_numpy(scans_np).to(dev)

    if args.dual_knn:
        os.environ["LOAM_ICF_DUAL_KNN"] = "1"

    def run():
        if args.driver == "scan_to_map":
            return T.scan_to_map_offline(scans, lidar, fp, T.default_map_reg_params())
        if args.driver == "scan_to_map_grid":
            return T.scan_to_map_offline(
                scans, lidar, fp, T.RegistrationParams(search_backend="grid", prior_weight=300.0))
        if args.driver == "streaming":
            return T.odometry_streaming(scans_np, lidar, fp, rp, chunk_frames=8, packed=True)
        if args.driver == "loop_closure":
            traj, _ = T.odometry_streaming(paths, lidar, fp, rp, chunk_frames=8, packed=True)
            feats = T.extract_features_batch(scans, lidar, fp)
            return optimize_trajectory_with_closures(traj, feats, rp, **LOOP_CLOSURE_KW)
        if args.driver == "scan_to_scan":
            state = T.scan_to_scan_init(lidar, fp, device=dev)
            for f in range(args.frames):
                state, _, _ = T.scan_to_scan_step(state, scans[f], lidar, fp, rp, dewarp=True)
            return state
        return T.odometry_offline(scans, lidar, fp, rp, chunk_pairs=4, motion_init=True)

    run()  # build + warm-up
    _, wall_ms = _sync_time(run)

    extract_ms, chunks, stages = None, [], None
    if args.driver == "offline":
        extract_ms, chunks = _offline_stages(scans, lidar, fp, rp, args.frames, dev)
    if args.driver == "loop_closure":
        stages = _loop_closure_stages(paths, scans, lidar, fp, rp)

    # device time by kernel over one whole run
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_us, launches = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time > 0:
            kernel_us[ev.name] = kernel_us.get(ev.name, 0.0) + ev.device_time
            launches += 1
    device_ms = sum(kernel_us.values()) / 1e3
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_kernels_{args.driver}.txt"), "w") as f:
        f.write(f"{smi}\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=60))

    print(f"gpu: {smi}")
    print(f"{args.driver}{' (dual kNN)' if args.dual_knn else ''}: wall {wall_ms:.3f} ms per "
          f"{args.frames}-frame run ({args.frames / wall_ms * 1e3:.3f} scans/s)")
    if extract_ms is not None:
        print(f"extraction {extract_ms:.3f} ms; registration chunks {chunks}")
    if stages is not None:
        print(f"stages (ms, a device sync after each): {stages}")
    print(f"profiled run: wall {prof_wall_ms:.3f} ms, device kernels {device_ms:.3f} ms over "
          f"{launches} launches, idle share {1 - device_ms / prof_wall_ms:.4f}")
    for name, us in top[:12]:
        print(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    print(json.dumps({
        "gpu": smi, "driver": args.driver, "dual_knn": args.dual_knn,
        "frames": args.frames, "wall_ms": wall_ms, "extract_ms": extract_ms,
        "chunks": chunks, "stages": stages, "profiled_wall_ms": prof_wall_ms, "device_kernel_ms": device_ms,
        "launches": launches, "idle_share": 1 - device_ms / prof_wall_ms,
        "top_kernels_ms": {n[:80]: us / 1e3 for n, us in top[:8]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
