"""Synthetic structured-LiDAR scan generation (host-side, NumPy).

A JAX-free copy of ``loam_tpu.io.synthetic``: the same seeds give
bit-identical arrays in both packages.

Simulates a spinning LiDAR (rows = elevation rings, columns = azimuth steps)
ray-casting a procedural world of axis-aligned boxes inside a room — giving
realistic range-image scans with walls (planar features), pillar corners
(edge features), occlusions and range gaps. Used by tests, benchmarks and the
odometry demos since no public dataset ships with this repo (zero-egress
environment). Geometry is exact ray/box intersection; optional Gaussian range
noise breaks curvature ties like real sensor noise does.

The scan layout matches the reference's expected row-major range-image input
(``features.h:8-10``): index = line * points_per_line + column, azimuth
sweeping 0..2pi per line.

Beyond ``loam_tpu``'s renderer, the inputs of the loop-closed path:
:func:`square_loop_scans` (keyframes around a closed square),
:func:`write_kitti_bins` (scans as KITTI ``.bin`` files) and
:func:`random_pose_graph` (a pose graph with known truth, as tensors).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry import Pose3, pose_cumcompose, quat_exp, quat_multiply, quat_normalize
from ..params import LidarParams
from ..pose_graph import make_edges


@dataclasses.dataclass
class Box:
    """Axis-aligned box: (min corner, max corner)."""

    lo: np.ndarray
    hi: np.ndarray


def default_world(seed: int = 0, n_pillars: int = 12, room: float = 20.0) -> list:
    """A rectangular room with random box pillars (walls via an inverted box)."""
    rng = np.random.default_rng(seed)
    boxes = []
    for _ in range(n_pillars):
        cx, cy = rng.uniform(-room * 0.4, room * 0.4, size=2)
        w, d = rng.uniform(0.3, 1.5, size=2)
        h = rng.uniform(1.0, 3.5)
        if np.hypot(cx, cy) < 2.0:
            cx += np.sign(cx or 1.0) * 3.0
        boxes.append(
            Box(np.array([cx - w, cy - d, -1.0]), np.array([cx + w, cy + d, -1.0 + h]))
        )
    return boxes


def _ray_box(origins: np.ndarray, dirs: np.ndarray, box: Box) -> np.ndarray:
    """Batched ray/AABB slab intersection. Returns t of entry hit (+inf miss)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / dirs
    t0 = (box.lo - origins) * inv
    t1 = (box.hi - origins) * inv
    tmin = np.nanmax(np.minimum(t0, t1), axis=-1)
    tmax = np.nanmin(np.maximum(t0, t1), axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(tmin > 0, tmin, tmax)  # inside-the-box rays hit the far face
    return np.where(hit, t, np.inf)


def _ray_room(origins: np.ndarray, dirs: np.ndarray, room: float, zlo: float, zhi: float) -> np.ndarray:
    """Intersection with the *inside* of the room box (exit distance)."""
    lo = np.array([-room, -room, zlo])
    hi = np.array([room, room, zhi])
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / dirs
    t0 = (lo - origins) * inv
    t1 = (hi - origins) * inv
    tmax = np.nanmin(np.maximum(t0, t1), axis=-1)
    return np.where(tmax > 0, tmax, np.inf)


def render_scan(
    lidar: LidarParams,
    sensor_position: np.ndarray = np.zeros(3),
    sensor_yaw: float = 0.0,
    world: Optional[Sequence[Box]] = None,
    room: float = 20.0,
    noise: float = 0.0,
    seed: int = 0,
    vertical_fov: Tuple[float, float] = (-0.30, 0.25),
    dtype=np.float64,
) -> np.ndarray:
    """Render one (L, P, 3) scan in the SENSOR frame.

    Args:
      sensor_position / sensor_yaw: sensor pose in the world (z-up).
      noise: Gaussian range noise sigma (meters).
    """
    if world is None:
        world = default_world()
    L, P = lidar.scan_lines, lidar.points_per_line
    elev = np.linspace(vertical_fov[0], vertical_fov[1], L)
    azim = sensor_yaw + np.linspace(0.0, 2 * np.pi, P, endpoint=False)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(azim)[None, :], np.sin(azim)[None, :]
    dirs = np.stack(
        [ce * ca, ce * sa, np.broadcast_to(se, (L, P))], axis=-1
    )  # (L, P, 3), world frame (z-up)
    origins = np.broadcast_to(sensor_position, (L, P, 3))

    t = _ray_room(origins, dirs, room, zlo=-1.0, zhi=4.0)
    for box in world:
        t = np.minimum(t, _ray_box(origins, dirs, box))
    t = np.where(np.isfinite(t), t, lidar.max_range * 2.0)  # "no return" -> far
    if noise > 0:
        rng = np.random.default_rng(seed)
        t = t + rng.normal(0.0, noise, size=t.shape)

    pts_world = origins + t[..., None] * dirs
    # into the sensor frame (rotate back by yaw, translate)
    rel = pts_world - sensor_position
    c, s = np.cos(-sensor_yaw), np.sin(-sensor_yaw)
    x = c * rel[..., 0] - s * rel[..., 1]
    y = s * rel[..., 0] + c * rel[..., 1]
    out = np.stack([x, y, rel[..., 2]], axis=-1)
    return out.astype(dtype)


def render_scan_swept(
    lidar: LidarParams,
    begin_position: np.ndarray,
    begin_yaw: float,
    end_position: np.ndarray,
    end_yaw: float,
    world: Optional[Sequence[Box]] = None,
    room: float = 20.0,
    noise: float = 0.0,
    seed: int = 0,
    vertical_fov: Tuple[float, float] = (-0.30, 0.25),
    dtype=np.float64,
) -> np.ndarray:
    """Render a scan from a MOVING sensor (rolling-shutter sweep).

    Column c is ray-cast from the sensor pose linearly interpolated at sweep
    fraction ``(c + 0.5) / P``.

    Returns (warped, exact): ``warped`` expresses each column's points in
    that column's own instantaneous sensor frame, naively stacked — what a
    real spinning LiDAR outputs and what ``dewarp_scan`` consumes;
    ``exact`` expresses the same ray hits in the END-of-sweep sensor frame —
    the ground truth dewarping should recover.
    """
    if world is None:
        world = default_world()
    L, P = lidar.scan_lines, lidar.points_per_line
    alpha = (np.arange(P) + 0.5) / P
    pos = begin_position[None, :] * (1 - alpha[:, None]) + end_position[None, :] * alpha[:, None]
    yaw = begin_yaw * (1 - alpha) + end_yaw * alpha  # (P,)

    elev = np.linspace(vertical_fov[0], vertical_fov[1], L)
    azim = yaw[None, :] + np.linspace(0.0, 2 * np.pi, P, endpoint=False)[None, :]
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(azim), np.sin(azim)  # (1, P)
    dirs = np.stack(
        [ce * ca, ce * sa, np.broadcast_to(se, (L, P))], axis=-1
    )
    origins = np.broadcast_to(pos[None, :, :], (L, P, 3))

    t = _ray_room(origins, dirs, room, zlo=-1.0, zhi=4.0)
    for box in world:
        t = np.minimum(t, _ray_box(origins, dirs, box))
    t = np.where(np.isfinite(t), t, lidar.max_range * 2.0)
    if noise > 0:
        rng = np.random.default_rng(seed)
        t = t + rng.normal(0.0, noise, size=t.shape)

    pts_world = origins + t[..., None] * dirs

    def to_frame(position, yaw_arr):
        rel = pts_world - position
        c = np.cos(-yaw_arr)
        s = np.sin(-yaw_arr)
        x = c * rel[..., 0] - s * rel[..., 1]
        y = s * rel[..., 0] + c * rel[..., 1]
        return np.stack([x, y, rel[..., 2]], axis=-1).astype(dtype)

    # warped: column c in its own instantaneous frame (pos/yaw broadcast (P,))
    warped = to_frame(pos[None, :, :], yaw[None, :])
    exact = to_frame(np.asarray(end_position)[None, None, :], np.float64(end_yaw))
    return warped, exact


def render_trajectory(
    lidar: LidarParams,
    n_frames: int,
    step: np.ndarray = np.array([0.08, 0.02, 0.0]),
    yaw_rate: float = 0.01,
    world: Optional[Sequence[Box]] = None,
    noise: float = 0.0,
    seed: int = 0,
    dtype=np.float64,
):
    """Render a sequence of scans along a constant-twist trajectory.

    Returns (scans (F, L, P, 3) sensor-frame, poses list of (R(3,3), t(3))
    world_T_sensor ground truth).
    """
    if world is None:
        world = default_world()
    scans, poses = [], []
    pos = np.zeros(3)
    yaw = 0.0
    for f in range(n_frames):
        scans.append(
            render_scan(
                lidar, pos, yaw, world=world, noise=noise, seed=seed + f, dtype=dtype
            )
        )
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        poses.append((R, pos.copy()))
        # advance (step is in the sensor frame)
        pos = pos + R @ step
        yaw += yaw_rate
    return np.stack(scans), poses


def square_loop_scans(lidar, n_side: int = 8, step: float = 0.2, noise: float = 0.002):
    """Keyframes around a square of 4 x ``n_side`` steps that ends where it
    began, in ``default_world(seed=2)``: the loop of
    ``tests/test_loop_closure.py``, two changes made so that frame-to-frame
    odometry can follow it. The heading turns by the same angle every frame
    (a full turn over the loop) instead of 90 degrees at each corner, and the
    square is [0, 1.6 m]^2, which no pillar crosses (that test's 2 m square
    has its corner (2, 0) inside one). The rays sit half a column off the
    renderer's azimuths (``c 2 pi / P``), which are the cell edges of the file
    loader's projection (``io.native.project_range_image``): there, rounding
    would send returns to the neighbouring column and leave cells empty, so
    the scans written as files would come back as other scans.

    Returns (scans (4 n_side + 1, L, P, 3) float32, positions (F, 3), yaws (F,)).
    """
    world = default_world(seed=2)
    half = np.pi / lidar.points_per_line
    c, s = np.cos(half), np.sin(half)
    n = 4 * n_side
    pos, heading, positions = np.zeros(3), 0.0, []
    for _ in range(4):
        for _ in range(n_side):
            positions.append(pos.copy())
            pos = pos + np.array([np.cos(heading), np.sin(heading), 0.0]) * step
        heading += np.pi / 2
    positions.append(positions[0].copy())
    yaws = np.arange(n + 1) * (2 * np.pi / n)
    scans = np.stack([render_scan(lidar, p, y + half, world=world, noise=noise, seed=i)
                      for i, (p, y) in enumerate(zip(positions, yaws))])
    x, y = scans[..., 0], scans[..., 1]  # rendered at yaw + half: turn back by half
    scans = np.stack([c * x - s * y, s * x + c * y, scans[..., 2]], axis=-1).astype(np.float32)
    return scans, np.stack(positions), yaws


def write_kitti_bins(scans, directory: str) -> list:
    """Each (L, P, 3) scan as a KITTI velodyne ``.bin`` file (x, y, z,
    intensity float32 records) in ``directory``; returns the paths."""
    paths = []
    for f, scan in enumerate(scans):
        pts = scan.reshape(-1, 3).astype(np.float32)
        paths.append(os.path.join(directory, f"{f:06d}.bin"))
        np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], axis=1).tofile(paths[-1])
    return paths


def random_pose_graph(N: int, closures: int, seed: int):
    """A chain of N float64 poses (steps of 0.1 rad and 1 m spread) plus
    ``closures`` edges from the first half of the chain to the second, all
    measurements noise-free, and a start perturbed by 0.02 rad and 0.2 m
    (node 0 at the truth). Returns (truth, start, edges) on the CPU."""
    rng = np.random.default_rng(seed)
    steps = Pose3(quat_exp(torch.from_numpy(rng.normal(0, 0.1, (N, 3)))),
                  torch.from_numpy(rng.normal(0, 1.0, (N, 3))))
    steps.rotation[0], steps.translation[0] = torch.tensor([1.0, 0, 0, 0]), 0.0
    gt = pose_cumcompose(steps)
    i = np.r_[np.arange(N - 1), rng.integers(0, N // 2, closures)]
    j = np.r_[np.arange(1, N), rng.integers(N // 2, N, closures)]
    ii, jj = torch.from_numpy(i), torch.from_numpy(j)
    rel = Pose3(gt.rotation[ii], gt.translation[ii]).inverse().compose(
        Pose3(gt.rotation[jj], gt.translation[jj]))
    init = Pose3(quat_normalize(quat_multiply(quat_exp(torch.from_numpy(rng.normal(0, 0.02, (N, 3)))),
                                              gt.rotation)),
                 gt.translation + torch.from_numpy(rng.normal(0, 0.2, (N, 3))))
    init.rotation[0], init.translation[0] = gt.rotation[0], gt.translation[0]
    return gt, init, make_edges(i, j, rel)
