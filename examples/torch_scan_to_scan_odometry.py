"""Scan-to-scan odometry over a synthetic trajectory, on the PyTorch port.

The port's twin of ``examples/scan_to_scan_odometry.py``: stream scans,
extract features, register each against the previous, accumulate the pose.
Runs on the GPU unless ``--device cpu`` asks for the CPU.

    python examples/torch_scan_to_scan_odometry.py [--frames 20] [--offline] [--device cpu]
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
    ap.add_argument("--offline", action="store_true",
                    help="batched whole-trajectory mode (chunks of pairs in lockstep)")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args()

    import torch

    from loam_tpu_torch import LidarParams, odometry_offline, scan_to_scan_init, scan_to_scan_step
    from loam_tpu_torch.device import resolve
    from loam_tpu_torch.evaluation import ate_rmse
    from loam_tpu_torch.io import render_trajectory

    dev = resolve(args.device)
    lidar = LidarParams(16, 512, 0.5, 80.0)
    scans, poses = render_trajectory(
        lidar, args.frames, step=np.array([0.10, 0.02, 0.0]), yaw_rate=0.015,
        noise=0.004, seed=1, dtype=np.float32,
    )
    gt = np.stack([t for (_, t) in poses])

    if args.offline:
        t0 = time.perf_counter()
        traj, details = odometry_offline(scans, lidar, device=dev)
        est = traj.translation.cpu().numpy()
        dt = time.perf_counter() - t0
    else:
        state = scan_to_scan_init(lidar, device=dev)
        est = []
        t0 = time.perf_counter()
        for f in range(args.frames):
            state, pose, detail = scan_to_scan_step(
                state, torch.from_numpy(scans[f]).to(dev), lidar
            )
            est.append(pose.translation.cpu().numpy())
        dt = time.perf_counter() - t0
        est = np.stack(est)

    print(f"{args.frames} frames in {dt:.2f}s "
          f"({args.frames / dt:.1f} scans/s incl. compile)")
    print(f"ATE vs ground truth: {ate_rmse(est, gt, align=False)*100:.2f} cm")
    for i in range(0, args.frames, max(1, args.frames // 5)):
        print(f"  frame {i:3d}: est {est[i].round(3)}  gt {gt[i].round(3)}")


if __name__ == "__main__":
    main()
