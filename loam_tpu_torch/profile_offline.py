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
keyframes and ``optimize_trajectory_with_closures``), or
``scan_to_map_sharded``: ``scan_to_map_step_sharded`` frame by frame against
maps of the default capacities split over a mesh of 4 shards of the GPU, in
a world-size-1 NCCL group (one program a frame, its gathers inside the
graph), or ``posegraph``: ``optimize_pose_graph`` in float64 on
``io.random_pose_graph(1000, 50)`` (H 6,000 x 6,000, 10 LM iterations);
``--dual-knn`` sets ``LOAM_ICF_DUAL_KNN=1`` -- then:

  * the wall time of a run through the programs' CUDA graphs (every driver
    call one graph launch, ``scan_to_map_grid``'s and ``posegraph``'s too)
    beside the same run eager (``program.eager()``);

  * for ``offline``, stage times on the host clock with a device sync at
    each boundary: batched extraction, then each registration chunk (with
    its ICF iteration count), each called on its own (the driver runs them
    all in one program); for ``loop_closure`` likewise: the file-fed
    odometry, the keyframes' extraction, the candidates' verification and
    the pose-graph solve;
  * one ``torch.profiler`` trace of a whole run: device time by kernel name,
    the sum of device kernel time against the wall time (the device's idle
    share), and the number of kernel launches; for ``offline`` and the
    scan-to-map drivers also the ICF iterations of the run and the launches
    an iteration; the host's launch calls (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ...) of the run, those inside the ICF loop over
    the loop's outer iterations (only where the loop runs eagerly: on the
    kNN paths a registration is one graph replay and its iterations leave
    no host range), and those and the host's reads of the device inside the
    driver's range (``program.DRIVER_RANGE``: one ``cudaGraphLaunch`` a
    call of ``odometry_offline`` and ``scan_to_map_offline``, a frame or
    chunk of the others). ``LOAM_KNN_SEED=0 LOAM_S2M_PREP_CACHE=0`` in the
    environment profiles the run without the kNN seed bounds and the
    scan-to-map prep cache.

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
from loam_tpu_torch.io import random_pose_graph, render_trajectory, square_loop_scans, write_kitti_bins
from loam_tpu_torch.loop_closure import (
    closure_edges, join_edges, optimize_trajectory_with_closures, propose_candidates, verify_closures)
from loam_tpu_torch.pose_graph import odometry_edges, optimize_pose_graph
from loam_tpu_torch import program
from loam_tpu_torch.profiling import host_reads, kernel_times, launch_calls
from loam_tpu_torch.registration import azimuth_sort_features, loop
from loam_tpu_torch.registration.detail import tree_map

#: Shards of the GPU in the ``scan_to_map_sharded`` driver's mesh.
SHARDS = 4

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
    extraction, then each chunk of 4 pairs (the last padded with copies of
    pair 0, as the driver pads it, so every chunk replays one captured ICF
    loop)."""
    feats, extract_ms = _sync_time(
        lambda: T.extract_features_batch(scans, lidar, fp, post=azimuth_sort_features))
    C, n_pairs = 4, frames - 1
    pad = -(-n_pairs // C) * C - n_pairs
    padded = lambda x: torch.cat([x, x[:1].expand((pad,) + x.shape[1:])]) if pad else x
    src, tgt = feats.map(lambda x: padded(x[1:])), feats.map(lambda x: padded(x[:-1]))
    carry = Pose3.identity(torch.float32, (), dev)
    chunks = []
    for c in range(-(-n_pairs // C)):
        part = lambda x: x[c * C: (c + 1) * C]
        s, t = src.map(part), tgt.map(part)
        init = Pose3(carry.rotation.expand(C, 4), carry.translation.expand(C, 3))
        (rel, det), ms = _sync_time(lambda: T.register_features_batch(s, t, init, rp, reorder_mode="none"))
        carry = Pose3(rel.rotation[-1], rel.translation[-1])
        chunks.append({"pairs": min(C, n_pairs - c * C), "ms": ms,
                       "iterations": int(det.num_iterations.max())})
    return extract_ms, chunks


def _loop_closure_stages(paths, scans, lidar, fp, rp):
    """The loop-closed path's steps, each closed by a device sync: the
    second of two passes (the first captures each step's program)."""
    kw = LOOP_CLOSURE_KW
    for _ in range(2):
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


def _iterations(driver: str, out):
    """The ICF iterations of a run of the offline or a scan-to-map driver
    (the sum of its details' ``num_iterations``), else None."""
    if driver == "offline":
        return int(out[1].num_iterations.sum())
    if driver in ("scan_to_map", "scan_to_map_grid"):
        return int(out[2].num_iterations.sum())
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--driver", default="offline",
                    choices=("offline", "scan_to_map", "scan_to_map_grid", "scan_to_scan", "streaming",
                             "loop_closure", "scan_to_map_sharded", "posegraph"))
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
    elif args.driver == "posegraph":
        _, init, edges = random_pose_graph(1000, 50, seed=2)
        init, edges = (tree_map(lambda x: x.to(dev), t) for t in (init, edges))
        scans_np = np.zeros((1, 1, 1, 3), np.float32)  # no scans: the solve alone
    else:
        scans_np, _ = render_trajectory(lidar, args.frames, step=np.array([0.08, 0.02, 0.0]),
                                        yaw_rate=0.01, noise=0.005, seed=0, dtype=np.float32)
    scans = torch.from_numpy(scans_np).to(dev)

    if args.dual_knn:
        os.environ["LOAM_ICF_DUAL_KNN"] = "1"
    if args.driver == "scan_to_map_sharded":
        import socket

        import torch.distributed as dist
        from loam_tpu_torch import parallel
        from loam_tpu_torch.parallel.distributed import scan_to_map_init_sharded, scan_to_map_step_sharded

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: bootstrap on the loopback
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
        mesh = parallel.make_mesh([dev] * SHARDS, group=dist.group.WORLD)

    def run():
        if args.driver == "posegraph":
            return optimize_pose_graph(init, edges, 10)
        if args.driver == "scan_to_map_sharded":
            cfg, reg = T.ScanToMapConfig(), T.default_map_reg_params()
            state = scan_to_map_init_sharded(cfg, mesh)
            for f in range(args.frames):
                state, _, _ = scan_to_map_step_sharded(state, scans[f], lidar, mesh, fp, reg, cfg)
            return state
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
            with torch.profiler.record_function(program.DRIVER_RANGE):
                for f in range(args.frames):
                    state, _, _ = T.scan_to_scan_step(state, scans[f], lidar, fp, rp, dewarp=True)
            return state
        return T.odometry_offline(scans, lidar, fp, rp, chunk_pairs=4, motion_init=True)

    run()  # build + warm-up (and the programs' captures)
    _, wall_ms = _sync_time(run)
    with program.eager():
        run()
        _, eager_wall_ms = _sync_time(run)

    extract_ms, chunks, stages = None, [], None
    if args.driver == "offline":
        extract_ms, chunks = _offline_stages(scans, lidar, fp, rp, args.frames, dev)
    if args.driver == "loop_closure":
        stages = _loop_closure_stages(paths, scans, lidar, fp, rp)

    # device time by kernel over one whole run
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    iters0 = loop.iterations
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    loop_iterations = loop.iterations - iters0
    host_calls, loop_calls = launch_calls(prof.events())
    _, driver_calls = launch_calls(prof.events(), within=program.DRIVER_RANGE)
    reads = host_reads(prof.events())
    kernel_us = kernel_times(prof.events())
    launches = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.device_time > 0 and e.name in kernel_us)
    device_ms = sum(kernel_us.values()) / 1e3
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_kernels_{args.driver}.txt"), "w") as f:
        f.write(f"{smi}\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=60))

    print(f"gpu: {smi}")
    print(f"{args.driver}{' (dual kNN)' if args.dual_knn else ''}: wall {wall_ms:.3f} ms per "
          + ("solve (10 iterations) through its graph" if args.driver == "posegraph" else
             f"{args.frames}-frame run ({args.frames / wall_ms * 1e3:.3f} scans/s) through the graphs")
          + f", {eager_wall_ms:.3f} ms eager")
    if extract_ms is not None:
        print(f"extraction {extract_ms:.3f} ms; registration chunks {chunks}")
    if stages is not None:
        print(f"stages (ms, a device sync after each): {stages}")
    iterations = _iterations(args.driver, out)
    print(f"profiled run: wall {prof_wall_ms:.3f} ms, device kernels {device_ms:.3f} ms over "
          f"{launches} launches, idle share {1 - device_ms / prof_wall_ms:.4f}"
          + ("" if iterations is None else
             f"; {iterations} ICF iterations, {launches / iterations:.1f} launches an iteration (all "
             f"launches of the run over its iterations)"))
    n_calls, n_loop = sum(host_calls.values()), sum(loop_calls.values())
    print(f"host launch calls: {n_calls} a run {host_calls}; inside the ICF loop {n_loop} {loop_calls} "
          f"over {loop_iterations} outer iterations"
          + (f", {n_loop / loop_iterations:.2f} an iteration" if loop_iterations else ""))
    print(f"inside the driver's loop over frames or chunks: launch calls {driver_calls}, host reads "
          f"{reads or 'none'}")
    for name, us in top[:12]:
        print(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    print(json.dumps({
        "gpu": smi, "driver": args.driver, "dual_knn": args.dual_knn,
        "frames": args.frames, "wall_ms": wall_ms, "eager_wall_ms": eager_wall_ms, "extract_ms": extract_ms,
        "chunks": chunks, "stages": stages, "profiled_wall_ms": prof_wall_ms, "device_kernel_ms": device_ms,
        "launches": launches, "idle_share": 1 - device_ms / prof_wall_ms, "icf_iterations": iterations,
        "host_launch_calls": host_calls, "host_launch_calls_in_loop": loop_calls,
        "loop_iterations": loop_iterations, "host_launch_calls_in_driver_loop": driver_calls,
        "host_reads_in_driver_loop": reads, "programs": loop.graph_stats(),
        "knn_seed": os.environ.get("LOAM_KNN_SEED", "1"),
        "s2m_prep_cache": os.environ.get("LOAM_S2M_PREP_CACHE", "1"),
        "top_kernels_ms": {n[:80]: us / 1e3 for n, us in top[:8]},
    }))
    if args.driver == "scan_to_map_sharded":
        mesh.release()  # the programs replay the group's collectives: gone before the group is
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
