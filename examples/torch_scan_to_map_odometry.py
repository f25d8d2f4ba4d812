"""Scan-to-map odometry with a local voxel map, keyframing and checkpointing,
on the PyTorch port.

The port's twin of ``examples/scan_to_map_odometry.py``. The checkpoint is
``loam_tpu``'s npz schema, so a state saved by either package resumes in
the other. Runs on the GPU unless ``--device cpu`` asks for the CPU.

    python examples/torch_scan_to_map_odometry.py [--frames 20] [--checkpoint out.npz] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--checkpoint", default=None, help="save state npz here")
    ap.add_argument("--resume", default=None, help="resume from state npz")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args()

    import torch

    from loam_tpu_torch import (
        LidarParams,
        RegistrationParams,
        checkpoint,
        scan_to_map_init,
        scan_to_map_rebuild_cache,
        scan_to_map_step,
        scan_to_map_strip_cache,
    )
    from loam_tpu_torch.device import resolve
    from loam_tpu_torch.evaluation import ate_rmse
    from loam_tpu_torch.io import render_trajectory

    dev = resolve(args.device)
    lidar = LidarParams(16, 512, 0.5, 80.0)
    reg = RegistrationParams(search_backend="grid")
    scans, poses = render_trajectory(
        lidar, args.frames, step=np.array([0.10, 0.02, 0.0]), yaw_rate=0.015,
        noise=0.004, seed=1, dtype=np.float32,
    )
    gt = np.stack([t for (_, t) in poses])

    state = scan_to_map_init(lidar=lidar, device=dev)
    if args.resume:
        # loam_tpu's schema holds no kNN prep cache: it is rebuilt from the maps
        state = scan_to_map_rebuild_cache(
            checkpoint.load(args.resume, scan_to_map_strip_cache(state)), lidar
        )
        print(f"resumed from {args.resume} "
              f"(map sizes {int(state.edge_map.size)}/{int(state.planar_map.size)})")

    est = []
    t0 = time.perf_counter()
    for f in range(args.frames):
        state, pose, detail = scan_to_map_step(
            state, torch.from_numpy(scans[f]).to(dev), lidar, reg_params=reg
        )
        est.append(pose.translation.cpu().numpy())
    dt = time.perf_counter() - t0
    est = np.stack(est)

    print(f"{args.frames} frames in {dt:.2f}s "
          f"({args.frames / dt:.1f} scans/s incl. compile)")
    print(f"map: {int(state.edge_map.size)} edge voxels, "
          f"{int(state.planar_map.size)} planar voxels")
    print(f"ATE vs ground truth: {ate_rmse(est, gt, align=False)*100:.2f} cm")

    if args.checkpoint:
        # without the prep cache and the port's `dropped` count: a file that
        # loam_tpu loads too
        checkpoint.save(args.checkpoint, scan_to_map_strip_cache(state)._replace(dropped=None))
        print(f"state saved to {args.checkpoint}")


if __name__ == "__main__":
    main()
