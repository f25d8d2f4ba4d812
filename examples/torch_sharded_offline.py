"""Offline odometry and batched pair registration with the pairs split over
the shards of one device, on the PyTorch port: ``odometry_offline_sharded``
and ``register_pairs_sharded`` on a mesh of D shards held by one rank (a
world-size-1 group: NCCL on the GPU, gloo with ``--device cpu``), beside
``odometry_offline`` in chunks of the same pairs and
``register_features_batch`` on every pair at once. Prints ms a call of each
and a JSON line.

    python examples/torch_sharded_offline.py [--device cpu] [--shards 4] [--frames 16]
                                             [--beams 64] [--points 1024] [--reps 5]

The defaults are ``chip_smoke.py``'s phase 12: 16 frames of 64x1024, 4
shards, 8 pairs. ``loam_tpu_torch`` is imported from ``PYTHONPATH`` where
it names a checkout, else from this one, so one machine can time two
checkouts of the port in one session.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ms(torch, run, reps: int) -> float:
    """Host ms a call over ``reps`` calls after one warm-up call (which
    captures the call's program on the GPU)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    run()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--beams", type=int, default=64)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    import loam_tpu_torch as T
    from loam_tpu_torch import parallel
    from loam_tpu_torch.device import resolve
    from loam_tpu_torch.io import render_trajectory
    from loam_tpu_torch.registration import azimuth_sort_features

    dev = resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    lidar = T.LidarParams(args.beams, args.points, 0.5, 120.0)
    fp = T.FeatureExtractionParams(precise_selection=True)
    rp = T.RegistrationParams(search_backend="bruteforce")
    scans_np, _ = render_trajectory(lidar, args.frames, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
                                    noise=0.005, seed=0, dtype=np.float32)
    D, F = args.shards, args.frames
    pairs = D * (F // (2 * D)) or D  # half the frames, a multiple of the shards
    scans = torch.from_numpy(scans_np).to(dev)
    feats = T.extract_features_batch(scans, lidar, fp, post=azimuth_sort_features)
    src, tgt = feats.map(lambda x: x[1:pairs + 1]), feats.map(lambda x: x[:pairs])
    ident = T.Pose3.identity(torch.float32, (pairs,), dev)

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: bootstrap on the loopback
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh([dev] * D, group=dist.group.WORLD)
        runs = {
            "offline_sharded": lambda: parallel.odometry_offline_sharded(scans_np, lidar, mesh, fp, rp),
            "offline_chunks": lambda: T.odometry_offline(scans_np, lidar, fp, rp, chunk_pairs=F // D,
                                                          device=dev),
            "pairs_sharded": lambda: parallel.register_pairs_sharded(src, tgt, ident, mesh, rp),
            "pairs_batch": lambda: T.register_features_batch(src, tgt, ident, rp),
        }
        ms = {name: _ms(torch, run, args.reps) for name, run in runs.items()}
        mesh.release()
    finally:
        dist.destroy_process_group()
    card = "cpu"
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                               f"--id={index}"], capture_output=True, text=True).stdout.strip()
    for name, t in ms.items():
        print(f"{name}: {t:.3f} ms a call ({F} frames of {args.beams}x{args.points}, {pairs} pairs, "
              f"{D} shards on {dev}; {card})")
    print(json.dumps({"package": T.__file__, "device": str(dev), "card": card, "shards": D, "frames": F,
                      "pairs": pairs, "reps": args.reps, "ms": ms}))


if __name__ == "__main__":
    main()
