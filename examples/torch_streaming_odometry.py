"""File-fed streaming odometry on the PyTorch port: the reference README's
usage loop, pipelined.

The port's twin of ``examples/streaming_odometry.py``: native loader threads
read, project and pack scans ahead of the consumer, frames go to the device
in the 4-byte/point codec (``loam_tpu_torch/io/packed.py``), and chunks of
frames upload and register while the next chunk is still being read. Runs
on the GPU unless ``--device cpu`` asks for the CPU.

Run: python examples/torch_streaming_odometry.py [n_frames] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_frames", nargs="?", type=int, default=24)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args()
    n_frames = args.n_frames

    from loam_tpu_torch import LidarParams, odometry_streaming
    from loam_tpu_torch.evaluation import ate_rmse
    from loam_tpu_torch.io import render_trajectory

    lidar = LidarParams(16, 512, 0.5, 80.0)

    # Write a synthetic trajectory as KITTI-format .bin files (stand-in for
    # a real dataset directory).
    with tempfile.TemporaryDirectory(prefix="loam_stream_") as root:
        scans, poses = render_trajectory(
            lidar, n_frames, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.015,
            noise=0.005, seed=0, dtype=np.float32,
        )
        paths = []
        for i, scan in enumerate(scans):
            pts = scan.reshape(-1, 3)
            rec = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
            p = os.path.join(root, f"{i:06d}.bin")
            rec.astype(np.float32).tofile(p)
            paths.append(p)

        trajectory, details = odometry_streaming(
            paths, lidar, chunk_frames=8, packed=True, device=args.device
        )

    est = trajectory.translation.cpu().numpy()
    gt = np.stack([t for (_, t) in poses])
    path_len = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    print(f"frames: {n_frames}  path: {path_len:.2f} m")
    print(f"ATE: {ate_rmse(est, gt, align=False):.4f} m")
    print(f"end position error: {np.linalg.norm(est[-1] - gt[-1]):.4f} m")


if __name__ == "__main__":
    main()
