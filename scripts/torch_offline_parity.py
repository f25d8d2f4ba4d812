#!/usr/bin/env python3
"""The port's ``odometry_offline`` against ``loam_tpu``'s on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/torch_offline_parity.py [--lines 64] [--points 1024] [--frames 16]

Both packages get the same rendered scans (``render_trajectory`` with
``chip_smoke.py``'s trajectory: step (0.08, 0.02, 0) m, yaw rate 0.01, noise
0.005, seed 0, float32), ``FeatureExtractionParams(precise_selection=True)``
and ``odometry_offline(chunk_pairs=4, motion_init=True)``. Prints the largest
translation gap between the two trajectories, each one's ATE against the
renderer's poses (no alignment, as ``bench.py::_check_accuracy``), the
termination codes of both, and the seconds each took, as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lines", type=int, default=64)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import loam_tpu as J
    import loam_tpu_torch as T
    from loam_tpu_torch.evaluation import ate_rmse
    from loam_tpu_torch.io import render_trajectory

    lidar_t = T.LidarParams(args.lines, args.points, 0.5, 120.0)
    lidar_j = J.LidarParams(args.lines, args.points, 0.5, 120.0)
    scans, poses = render_trajectory(lidar_t, args.frames, step=np.array([0.08, 0.02, 0.0]),
                                     yaw_rate=0.01, noise=0.005, seed=0, dtype=np.float32)
    gt = np.stack([t for (_, t) in poses])

    t0 = time.perf_counter()
    traj_j, det_j = J.odometry_offline(jnp.asarray(scans), lidar_j,
                                       J.FeatureExtractionParams(precise_selection=True),
                                       J.RegistrationParams(), chunk_pairs=4, motion_init=True)
    tr_j = np.asarray(traj_j.translation)
    s_j = time.perf_counter() - t0

    t0 = time.perf_counter()
    traj_t, det_t = T.odometry_offline(scans, lidar_t, T.FeatureExtractionParams(precise_selection=True),
                                       T.RegistrationParams(), chunk_pairs=4, motion_init=True,
                                       device="cpu")
    tr_t = traj_t.translation.numpy()
    s_t = time.perf_counter() - t0

    print(json.dumps({
        "scans": f"{args.frames} x {args.lines}x{args.points}", "device": "cpu",
        "max_translation_gap_m": float(np.abs(tr_t - tr_j).max()),
        "ate_port_m": float(ate_rmse(tr_t, gt, align=False)),
        "ate_loam_tpu_m": float(ate_rmse(tr_j, gt, align=False)),
        "termination_port": det_t.termination.tolist(),
        "termination_loam_tpu": np.asarray(det_j.termination).tolist(),
        "seconds_port": s_t, "seconds_loam_tpu": s_j,
        "torch_threads": torch.get_num_threads(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
