"""The sharded calls on the shards of one device, timed, on the PyTorch port:
``odometry_offline_sharded``, ``register_pairs_sharded`` and the other
sharded calls on a mesh of D shards held by one rank (a world-size-1 group:
NCCL on the GPU, gloo with ``--device cpu``), beside ``odometry_offline`` in
chunks of the same pairs and ``register_features_batch`` on every pair at
once. Prints ms a call of each and a JSON line.

    python examples/torch_sharded_offline.py [--device cpu] [--shards 4] [--frames 16]
                                             [--beams 64] [--points 1024] [--reps 5]
                                             [--cells NAME ...]

The defaults are ``chip_smoke.py``'s phase 12: 16 frames of 64x1024, 4
shards, 8 pairs. Cells (``--cells``; the first four by default):

* ``offline_sharded``, ``offline_chunks``, ``pairs_sharded`` (half the
  frames' pairs, a multiple of the shards: phase 17's 8 at 16 frames),
  ``pairs_batch``;
* ``pairs12_sharded``: phase 15's 12 pairs (a multiple of the shards);
* ``s2m_sharded``: ``scan_to_map_step_sharded`` over the frames (the
  default ``ScanToMapConfig``, its capacities rounded up to a multiple of
  the shards; ms a frame);
* ``extract_sharded``: ``extract_features_sharded`` on the frames;
* ``posegraph_sharded``: ``optimize_pose_graph_sharded`` on phase 11's
  graph (``random_pose_graph(1000, 50, seed=2)``, float64, its edges padded
  with masked ones to a multiple of the shards, 10 iterations).

On the GPU each cell also reports its ms a call back to back (``b2b_ms``:
``--reps`` calls between two CUDA events, no sync between them), its
program's pool bytes, nodes and, where the checkout has them, the graph's
widest fork and its forks (``graph_stats()``). ``loam_tpu_torch`` is
imported from ``PYTHONPATH`` where it names a checkout, else from this one,
so one machine can time two checkouts of the port one after the other.
"""

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DEFAULT_CELLS = ("offline_sharded", "offline_chunks", "pairs_sharded", "pairs_batch")
CELLS = DEFAULT_CELLS + ("pairs12_sharded", "s2m_sharded", "extract_sharded", "posegraph_sharded")
#: The program path of each sharded cell (``graph_stats()``'s ``path``).
PATHS = {"offline_sharded": "offline_sharded", "pairs_sharded": "pairs_sharded", "pairs12_sharded": "pairs_sharded",
         "s2m_sharded": "scan_to_map_sharded", "extract_sharded": "extract_sharded",
         "posegraph_sharded": "pose_graph_sharded"}


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


def _b2b_ms(torch, run, reps: int) -> float:
    """Device ms a call: ``reps`` calls back to back between two CUDA
    events, no sync between them (a warm call first)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    run()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _padded_graph(torch, dev, D: int):
    """Phase 11's pose graph on ``dev`` in float64, its edges padded with
    masked ones (weight 0) to a multiple of ``D``."""
    from loam_tpu_torch.io import random_pose_graph
    from loam_tpu_torch.registration.detail import tree_map

    _, init, edges = random_pose_graph(1000, 50, seed=2)
    init, edges = (tree_map(lambda x: x.to(dev), t) for t in (init, edges))
    n = (-edges.i.shape[0]) % D
    pad = lambda x, v: torch.cat([x, x[:1].expand((n,) + x.shape[1:]) if v is None else v])
    fill = lambda dtype, v: torch.full((n,), v, dtype=dtype, device=dev)
    m = edges.measurement
    return init, type(edges)(pad(edges.i, fill(torch.int32, 0)), pad(edges.j, fill(torch.int32, 1)),
                             type(m)(pad(m.rotation, None), pad(m.translation, None)),
                             pad(edges.weight, fill(torch.float64, 0.0)), pad(edges.mask, fill(torch.bool, False)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--beams", type=int, default=64)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cells", nargs="+", default=list(DEFAULT_CELLS), choices=CELLS)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    import loam_tpu_torch as T
    from loam_tpu_torch import parallel
    from loam_tpu_torch.device import resolve
    from loam_tpu_torch.io import render_trajectory
    from loam_tpu_torch.parallel import distributed as tdist
    from loam_tpu_torch.pose_graph import optimize_pose_graph_sharded
    from loam_tpu_torch.registration import azimuth_sort_features, loop

    dev = resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    lidar = T.LidarParams(args.beams, args.points, 0.5, 120.0)
    fp = T.FeatureExtractionParams(precise_selection=True)
    rp = T.RegistrationParams(search_backend="bruteforce")
    scans_np, _ = render_trajectory(lidar, args.frames, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
                                    noise=0.005, seed=0, dtype=np.float32)
    D, F = args.shards, args.frames
    pairs = D * (F // (2 * D)) or D  # half the frames, a multiple of the shards
    pairs12 = 12 if 12 % D == 0 and F > 12 else pairs
    scans = torch.from_numpy(scans_np).to(dev)
    feats = T.extract_features_batch(scans, lidar, fp, post=azimuth_sort_features)
    cut = lambda n: (feats.map(lambda x: x[1:n + 1]), feats.map(lambda x: x[:n]),
                     T.Pose3.identity(torch.float32, (n,), dev))
    up = lambda n: -(-n // D) * D
    base = T.ScanToMapConfig()
    cfg = dataclasses.replace(base, edge_capacity=up(base.edge_capacity), planar_capacity=up(base.planar_capacity))
    s2m_reg = T.default_map_reg_params()
    graph = _padded_graph(torch, dev, D) if "posegraph_sharded" in args.cells else None

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: bootstrap on the loopback
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh([dev] * D, group=dist.group.WORLD)

        def s2m():
            st = tdist.scan_to_map_init_sharded(cfg, mesh)
            for f in range(F):
                st, pose, _ = tdist.scan_to_map_step_sharded(st, scans[f], lidar, mesh, fp, s2m_reg, cfg)
            return st, pose

        every = {
            "offline_sharded": lambda: parallel.odometry_offline_sharded(scans_np, lidar, mesh, fp, rp),
            "offline_chunks": lambda: T.odometry_offline(scans_np, lidar, fp, rp, chunk_pairs=F // D,
                                                          device=dev),
            "pairs_sharded": lambda: parallel.register_pairs_sharded(*cut(pairs), mesh, rp),
            "pairs_batch": lambda: T.register_features_batch(*cut(pairs), rp),
            "pairs12_sharded": lambda: parallel.register_pairs_sharded(*cut(pairs12), mesh, rp),
            "s2m_sharded": s2m,
            "extract_sharded": lambda: parallel.extract_features_sharded(scans, lidar, mesh, fp),
            "posegraph_sharded": lambda: optimize_pose_graph_sharded(*graph, mesh, 10),
        }
        ms, b2b, programs = {}, {}, {}
        for name in args.cells:
            loop.clear_cache()
            ms[name] = _ms(torch, every[name], args.reps)
            if dev.type != "cuda":
                continue
            b2b[name] = _b2b_ms(torch, every[name], args.reps)
            got = [g for g in loop.graph_stats() if g["path"] == PATHS.get(name, name)]
            programs[name] = [{k: g.get(k) for k in ("nodes", "conditional_nodes", "pool_bytes", "branches",
                                                      "forks", "capture_s")} for g in got]
        loop.clear_cache()
        mesh.release()
    finally:
        dist.destroy_process_group()
    card = "cpu"
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                               f"--id={index}"], capture_output=True, text=True).stdout.strip()
    per = {"s2m_sharded": F}
    for name, t in ms.items():
        shape = f"{pairs12 if name == 'pairs12_sharded' else pairs} pairs" if "pairs" in name else f"{F} frames"
        extra = ""
        if name in b2b:
            extra = f", back to back {b2b[name] / per.get(name, 1):.3f} ms; " + "; ".join(
                f"{g['nodes']} nodes, widest fork {g['branches']}, forks {g['forks']}, pool {g['pool_bytes']} B"
                for g in programs[name])
        print(f"{name}: {t / per.get(name, 1):.3f} ms a {'frame' if name in per else 'call'} ({shape} of "
              f"{args.beams}x{args.points}, {D} shards on {dev}{extra}; {card})")
    print(json.dumps({"package": T.__file__, "device": str(dev), "card": card, "shards": D, "frames": F,
                      "pairs": pairs, "pairs12": pairs12, "reps": args.reps, "ms": ms, "b2b_ms": b2b,
                      "programs": programs}))


if __name__ == "__main__":
    main()
