"""Distributed scan-to-map odometry on a mesh of shards, on the PyTorch port
(BASELINE config 5).

The port's twin of ``examples/distributed_mapping.py``. The registration
target (voxel maps of accumulated features) is sharded over the mesh's
"data" axis: every shard owns capacity/D map slots, kNN runs as a
collective (local top-k, then a global merge), and map insertion is
owner-partitioned (mod-D by voxel key). A mesh is one process's shards on
its device plus a ``torch.distributed`` group (``loam_tpu_torch.parallel``):
on the GPU this runs 4 shards of one card in a world-size-1 NCCL group;
with ``--device cpu``, 8 shards on the CPU in one process.

    python examples/torch_distributed_mapping.py [--device cpu]

It drives the sharded step over a short synthetic trajectory and checks it
against the single-device driver (same world, same parameters).
"""

import argparse
import os
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from loam_tpu_torch import LidarParams, scan_to_map_init, scan_to_map_step
    from loam_tpu_torch.device import resolve
    from loam_tpu_torch.io import render_trajectory
    from loam_tpu_torch.odometry.scan_to_map import ScanToMapConfig
    from loam_tpu_torch.params import RegistrationParams
    from loam_tpu_torch.parallel import make_mesh
    from loam_tpu_torch.parallel.distributed import (
        scan_to_map_init_sharded,
        scan_to_map_step_sharded,
    )

    dev = resolve(args.device)
    group = None
    if dev.type == "cuda":
        # NCCL takes one rank a GPU: this card is one rank holding 4 shards
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
        group = dist.group.WORLD
    mesh = None
    try:
        mesh = make_mesh([dev] * (4 if dev.type == "cuda" else 8), group=group)
        print(f"devices: {mesh.size} x {mesh.device.type}")

        lidar = LidarParams(16, 360, 0.5, 80.0)
        frames = 6
        scans, poses_gt = render_trajectory(
            lidar, frames, step=np.array([0.15, 0.05, 0.0]), yaw_rate=0.02,
            noise=0.005, seed=3, dtype=np.float32,
        )
        scans = torch.from_numpy(scans).to(dev)

        config = ScanToMapConfig(edge_capacity=1 << 12, planar_capacity=1 << 14)
        reg = RegistrationParams(prior_weight=300.0)

        state_s = scan_to_map_init_sharded(config, mesh)
        state_1 = scan_to_map_init(config, lidar=lidar, device=dev)
        traj_s, traj_1 = [], []
        for f in range(frames):
            state_s, pose_s, _ = scan_to_map_step_sharded(
                state_s, scans[f], lidar, mesh, reg_params=reg, config=config
            )
            state_1, pose_1, _ = scan_to_map_step(
                state_1, scans[f], lidar, reg_params=reg, config=config
            )
            traj_s.append(pose_s.translation.cpu().numpy())
            traj_1.append(pose_1.translation.cpu().numpy())
            print(f"frame {f}: sharded t={traj_s[-1].round(3)}  "
                  f"single t={traj_1[-1].round(3)}")
    finally:
        if mesh is not None:
            mesh.release()  # its programs replay the group's collectives: gone first
        if group is not None:
            dist.destroy_process_group()

    err = np.linalg.norm(np.asarray(traj_s) - np.asarray(traj_1), axis=1).max()
    print(f"max |sharded - single-device| translation: {err:.2e} m")
    gt_end = poses_gt[-1][1] - poses_gt[0][1]
    drift = np.linalg.norm(traj_s[-1] - gt_end)
    print(f"end-pose drift vs ground truth: {drift:.3f} m")
    assert err < 5e-2, "sharded driver diverged from single-device"
    print("OK")


if __name__ == "__main__":
    main()
