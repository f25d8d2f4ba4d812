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

    python examples/torch_distributed_mapping.py [--device cpu] [--ranks N]

``--ranks N`` starts N ranks (``torch.multiprocessing``), one shard each:
on the GPU one rank a card, each rank on ``cuda:<rank>`` in an NCCL group
made eagerly on that card (``device_id``); with ``--device cpu``, N
processes in a gloo group. The set-up is the caller's, as here.

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


def _run(rank: int, device, ranks: int, port: int) -> None:
    """One process: its group, its mesh, the drive and the check. ``ranks``
    0 is the one-process run."""
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

    cpu = device is not None and torch.device(device).type == "cpu"
    init = f"tcp://127.0.0.1:{port}"
    group, dev = None, None
    if ranks:
        if cpu:
            dev = torch.device("cpu")
            dist.init_process_group("gloo", init_method=init, world_size=ranks, rank=rank)
        else:
            # one rank a card: this rank's card current, its NCCL communicator
            # made on it now, before any capture
            torch.cuda.set_device(rank)
            dev = torch.device("cuda", rank)
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
            dist.init_process_group("nccl", init_method=init, world_size=ranks, rank=rank, device_id=dev)
        group = dist.group.WORLD
    else:
        dev = resolve(device)
        if dev.type == "cuda":
            # NCCL takes one rank a GPU: this card is one rank holding 4 shards
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
            dist.init_process_group("nccl", init_method=init, world_size=1, rank=0)
            group = dist.group.WORLD
    mesh = None
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        # ranks: one shard each, on this rank's device (make_mesh() is this
        # rank's card); one process: 4 shards of the card or 8 on the CPU
        if ranks:
            mesh = make_mesh(["cpu"] if cpu else None, group=group)
        else:
            mesh = make_mesh([dev] * (4 if dev.type == "cuda" else 8), group=group)
        say(f"devices: {mesh.size} x {mesh.device.type}" + (f", {ranks} ranks" if ranks else ""))

        lidar = LidarParams(16, 360, 0.5, 80.0)
        frames = 6
        scans, poses_gt = render_trajectory(
            lidar, frames, step=np.array([0.15, 0.05, 0.0]), yaw_rate=0.02,
            noise=0.005, seed=3, dtype=np.float32,
        )
        scans = torch.from_numpy(scans).to(mesh.device)

        config = ScanToMapConfig(edge_capacity=1 << 12, planar_capacity=1 << 14)
        reg = RegistrationParams(prior_weight=300.0)

        state_s = scan_to_map_init_sharded(config, mesh)
        state_1 = scan_to_map_init(config, lidar=lidar, device=mesh.device)
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
            say(f"frame {f}: sharded t={traj_s[-1].round(3)}  "
                f"single t={traj_1[-1].round(3)}")
    finally:
        if mesh is not None:
            mesh.release()  # its programs replay the group's collectives: gone first
        if group is not None:
            dist.destroy_process_group()

    err = np.linalg.norm(np.asarray(traj_s) - np.asarray(traj_1), axis=1).max()
    say(f"max |sharded - single-device| translation: {err:.2e} m")
    gt_end = poses_gt[-1][1] - poses_gt[0][1]
    drift = np.linalg.norm(traj_s[-1] - gt_end)
    say(f"end-pose drift vs ground truth: {drift:.3f} m")
    assert err < 5e-2, "sharded driver diverged from single-device"
    say("OK")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks of one shard each: one a card, or processes over gloo with --device cpu")
    args = ap.parse_args()
    port = _free_port()
    if args.ranks:
        import torch.multiprocessing as mp

        mp.spawn(_run, args=(args.device, args.ranks, port), nprocs=args.ranks)
    else:
        _run(0, args.device, 0, port)


if __name__ == "__main__":
    main()
