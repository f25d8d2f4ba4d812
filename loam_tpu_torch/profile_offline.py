"""Where the port's main path spends its time on a CUDA GPU.

    python3 -m loam_tpu_torch.profile_offline [--frames 16] [--out profile_out]

Runs ``odometry_offline`` on synthetic 64x1024 scans (``chunk_pairs=4``,
``motion_init=True``, as ``chip_smoke.py``), then:

  * stage times on the host clock with a device sync at each boundary:
    batched extraction, then each registration chunk (with its ICF
    iteration count);
  * one ``torch.profiler`` trace of a whole run: device time by kernel name,
    the sum of device kernel time against the wall time (the device's idle
    share), and the number of kernel launches.

Prints a summary and one JSON line; the full kernel table goes to
``<out>/profile_kernels.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import loam_tpu_torch as T
from loam_tpu_torch.geometry import Pose3
from loam_tpu_torch.io import render_trajectory
from loam_tpu_torch.registration import azimuth_sort_features


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    scans_np, _ = render_trajectory(lidar, args.frames, step=np.array([0.08, 0.02, 0.0]),
                                    yaw_rate=0.01, noise=0.005, seed=0, dtype=np.float32)
    scans = torch.from_numpy(scans_np).to(dev)

    def run():
        return T.odometry_offline(scans, lidar, fp, rp, chunk_pairs=4, motion_init=True)

    run()  # build + warm-up
    _, wall_ms = _sync_time(run)

    # stage split: the driver's steps, each closed by a device sync
    feats, extract_ms = _sync_time(
        lambda: T.extract_features_batch(scans, lidar, fp, post=azimuth_sort_features))
    src, tgt = feats.map(lambda x: x[1:]), feats.map(lambda x: x[:-1])
    C, n_pairs = 4, args.frames - 1
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
    with open(os.path.join(args.out, "profile_kernels.txt"), "w") as f:
        f.write(f"{smi}\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=60))

    print(f"gpu: {smi}")
    print(f"wall {wall_ms:.3f} ms per {args.frames}-frame run ({args.frames / wall_ms * 1e3:.3f} scans/s)")
    print(f"extraction {extract_ms:.3f} ms; registration chunks {chunks}")
    print(f"profiled run: wall {prof_wall_ms:.3f} ms, device kernels {device_ms:.3f} ms over "
          f"{launches} launches, idle share {1 - device_ms / prof_wall_ms:.4f}")
    for name, us in top[:12]:
        print(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    print(json.dumps({
        "gpu": smi, "frames": args.frames, "wall_ms": wall_ms, "extract_ms": extract_ms,
        "chunks": chunks, "profiled_wall_ms": prof_wall_ms, "device_kernel_ms": device_ms,
        "launches": launches, "idle_share": 1 - device_ms / prof_wall_ms,
        "top_kernels_ms": {n[:80]: us / 1e3 for n, us in top[:8]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
