"""Full SLAM pipeline on the PyTorch port: scan-to-map odometry -> loop
closure -> pose graph.

The port's twin of ``examples/full_slam.py``: on a synthetic circular loop,
streaming scan-to-map odometry accumulates keyframes and drift, loop-closure
detection finds the revisit, and the pose-graph solve distributes the
correction. Runs on the GPU unless ``--device cpu`` asks for the CPU.

    python examples/torch_full_slam.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--frames", type=int, default=20, help="keyframes in the loop")
    ap.add_argument("--radius", type=float, default=2.0)
    args = ap.parse_args()

    import torch

    from loam_tpu_torch import FeatureSet, LidarParams, extract_features, scan_to_map_init, scan_to_map_step
    from loam_tpu_torch.device import resolve
    from loam_tpu_torch.geometry import Pose3
    from loam_tpu_torch.io import default_world, render_scan
    from loam_tpu_torch.loop_closure import optimize_trajectory_with_closures
    from loam_tpu_torch.params import RegistrationParams

    dev = resolve(args.device)
    lidar = LidarParams(16, 360, 0.5, 80.0)
    world = default_world(seed=2)

    # ground-truth circular loop (smooth heading changes the odometry can
    # track; ends back at the start)
    positions, yaws = [], []
    for i in range(args.frames + 1):
        a = 2 * np.pi * i / args.frames
        positions.append(
            np.array([args.radius * np.sin(a), args.radius * (1 - np.cos(a)), 0.0])
        )
        yaws.append(a)  # heading tangent to the circle
    gt = np.stack(positions)
    scans = np.stack(
        [
            render_scan(lidar, p, y, world=world, noise=0.004, seed=i,
                        dtype=np.float32)
            for i, (p, y) in enumerate(zip(positions, yaws))
        ]
    )
    n = len(scans)

    # 1) streaming scan-to-map odometry
    state = scan_to_map_init(lidar=lidar, device=dev)
    # tighter convergence than the reference defaults: each frame stops
    # below ~1 mm / 0.1 mrad instead of 1 cm, so drift accumulates slowly
    # prior_weight keeps blind frames (degenerate geometry) anchored to the
    # constant-velocity prediction instead of sliding along walls
    reg = RegistrationParams(
        search_backend="grid",
        position_convergence_thresh=1e-3,
        rotation_convergence_thresh=1e-4,
        prior_weight=300.0,
    )
    traj_q, traj_t, feats = [], [], []
    for f in range(n):
        scan = torch.from_numpy(scans[f]).to(dev)
        state, pose, _ = scan_to_map_step(state, scan, lidar, reg_params=reg)
        traj_q.append(pose.rotation)
        traj_t.append(pose.translation)
        feats.append(extract_features(scan, lidar))
    trajectory = Pose3(torch.stack(traj_q), torch.stack(traj_t))
    features = FeatureSet(*(torch.stack(xs) for xs in zip(*feats)))
    gt_t = torch.as_tensor(gt, dtype=torch.float32, device=dev)

    drift = float(
        torch.linalg.norm(trajectory.translation[-1] - trajectory.translation[0])
    )
    err_odo = float(torch.linalg.norm(trajectory.translation - gt_t, dim=1).mean())

    # 2) loop closure + pose graph
    opt, closures = optimize_trajectory_with_closures(
        trajectory, features, reg_params=reg,
        max_candidates=4, min_separation=args.frames // 2, max_distance=2.0,
    )
    gap = float(torch.linalg.norm(opt.translation[-1] - opt.translation[0]))
    err_opt = float(torch.linalg.norm(opt.translation - gt_t, dim=1).mean())

    print(f"keyframes: {n}, verified closures: {int(closures.accepted.sum())}")
    print(f"loop gap  : {drift*100:.2f} cm -> {gap*100:.2f} cm")
    print(f"mean error: {err_odo*100:.2f} cm -> {err_opt*100:.2f} cm")


if __name__ == "__main__":
    main()
