"""The traffic generator: drive segments rendered on the device from the seed.

One general generator for every traffic mix. A mix is a JSON file under
``loambench/traffic/`` whose parameters say what a segment is: its frames,
the constant twist between frames (``step`` in the sensor frame, ``yaw_rate``),
the range noise, how many distinct segments a run cycles through and how
many of them the correctness check judges. The scene is the renderer of
``loam_tpu_torch.io.synthetic`` (a room of axis-aligned box pillars, a
spinning LiDAR ray-cast against it), rewritten in PyTorch so that a run's
scans are made on the card in a few large calls instead of on the host.

What a seed changes and what it does not. Segment ``k``'s geometry (its
pillars, start and heading) comes from ``k`` and the mix alone, so every
seed does the same work; the seed draws the range noise of every frame and
the order in which the closed loop visits the segments. The same seed
gives the same scans.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

#: Height range of the room (m), as ``io.synthetic.render_scan`` has it.
ROOM_Z = (-1.0, 4.0)
#: Elevation of the first and last scan line (rad), as ``render_scan``.
VERTICAL_FOV = (-0.30, 0.25)


class Segment(NamedTuple):
    """One drive segment: scans (F, L, P, 3) in the sensor frame (float32
    on the device) and the ground-truth world positions (F, 3) and yaws (F,)
    of its frames, relative to frame 0 (float64 on the host)."""

    scans: torch.Tensor
    positions: np.ndarray
    yaws: np.ndarray


def pillars(rng: np.random.Generator, n: int, room: float) -> np.ndarray:
    """(n, 2, 3) box pillars (min corner, max corner): ``default_world``'s
    draw (centres within 0.4 room, half widths 0.3-1.5 m, heights 1-3.5 m
    from the floor, none within 2 m of the room's centre)."""
    boxes = []
    for _ in range(n):
        cx, cy = rng.uniform(-room * 0.4, room * 0.4, size=2)
        w, d = rng.uniform(0.3, 1.5, size=2)
        h = rng.uniform(1.0, 3.5)
        if np.hypot(cx, cy) < 2.0:
            cx += np.sign(cx or 1.0) * 3.0
        boxes.append([[cx - w, cy - d, -1.0], [cx + w, cy + d, -1.0 + h]])
    return np.asarray(boxes, np.float64).reshape(n, 2, 3)


def path(start: np.ndarray, heading: float, frames: int, step, yaw_rate: float):
    """Positions (F, 3) and yaws (F,) of ``render_trajectory``'s constant
    twist from ``start`` and ``heading``: each frame moves by ``step`` in
    its own sensor frame, then turns by ``yaw_rate``."""
    pos, yaw = np.asarray(start, np.float64).copy(), float(heading)
    positions, yaws = [], []
    step = np.asarray(step, np.float64)
    for _ in range(frames):
        positions.append(pos.copy())
        yaws.append(yaw)
        c, s = math.cos(yaw), math.sin(yaw)
        pos = pos + np.array([c * step[0] - s * step[1], s * step[0] + c * step[1], step[2]])
        yaw += yaw_rate
    return np.stack(positions), np.asarray(yaws)


def _clear(positions: np.ndarray, boxes: np.ndarray, room: float, wall: float, clearance: float) -> bool:
    """Whether every position keeps ``wall`` from the room's walls and
    ``clearance`` from every pillar."""
    if np.any(np.abs(positions[:, :2]) > room - wall):
        return False
    lo, hi = boxes[None, :, 0, :2] - clearance, boxes[None, :, 1, :2] + clearance
    inside = np.all((positions[:, None, :2] > lo) & (positions[:, None, :2] < hi), axis=-1)
    return not inside.any()


def layout(mix: dict, k: int):
    """Segment ``k``'s pillars and path (positions, yaws) for the mix: a
    world and a start drawn from ``k`` (not the seed), the start and heading
    redrawn until the whole path keeps clear of the walls and pillars."""
    rng = np.random.default_rng([int(mix["layout_salt"]), k])
    room = float(mix["room"])
    boxes = pillars(rng, int(mix["pillars"]), room)
    for _ in range(10000):
        start = np.array([*rng.uniform(-0.6 * room, 0.6 * room, size=2), 0.0])
        heading = float(rng.uniform(-math.pi, math.pi))
        pos, yaw = path(start, heading, int(mix["frames"]), mix["step"], float(mix["yaw_rate"]))
        if _clear(pos, boxes, room, float(mix["wall_margin"]), float(mix["clearance"])):
            return boxes, pos, yaw
    raise RuntimeError(f"no clear path for segment {k} of the mix")


def _slab(origins, dirs, lo, hi, inside: bool):
    """Ray/box slab test: the entry distance (``inside``: the exit
    distance, for the room), +inf on a miss. NaNs of 0 * inf are skipped as
    ``np.nanmax`` / ``np.nanmin`` skip them in ``io.synthetic``."""
    inv = 1.0 / dirs
    t0 = (lo - origins) * inv
    t1 = (hi - origins) * inv
    near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
    tmax = torch.fmin(torch.fmin(far[..., 0], far[..., 1]), far[..., 2])
    inf = torch.full_like(tmax, math.inf)
    if inside:
        return torch.where(tmax > 0, tmax, inf)
    tmin = torch.fmax(torch.fmax(near[..., 0], near[..., 1]), near[..., 2])
    hit = (tmax >= tmin) & (tmax > 0)
    return torch.where(hit, torch.where(tmin > 0, tmin, tmax), inf)


def render(lines: int, points: int, max_range: float, positions, yaws, boxes, room: float,
           noise: torch.Tensor = None, device="cpu") -> torch.Tensor:
    """(F, L, P, 3) float64 scans in each frame's sensor frame, the rays of
    ``io.synthetic.render_scan`` cast from every (position, yaw) at once.
    ``noise``: (F, L, P) range offsets added to every return."""
    f64 = dict(dtype=torch.float64, device=device)
    pos = torch.as_tensor(np.asarray(positions), **f64)[:, None, None, :]
    yaw = torch.as_tensor(np.asarray(yaws), **f64)[:, None, None]
    elev = torch.linspace(VERTICAL_FOV[0], VERTICAL_FOV[1], lines, **f64)[None, :, None]
    azim = yaw + (torch.arange(points, **f64) * (2 * math.pi / points))[None, None, :]
    ce, se = torch.cos(elev), torch.sin(elev)
    x, y, z = torch.broadcast_tensors(ce * torch.cos(azim), ce * torch.sin(azim), se)
    dirs = torch.stack([x, y, z], dim=-1)  # (F, L, P, 3), world frame
    origins = pos.expand(dirs.shape)
    lo = torch.tensor([-room, -room, ROOM_Z[0]], **f64)
    hi = torch.tensor([room, room, ROOM_Z[1]], **f64)
    t = _slab(origins, dirs, lo, hi, inside=True)
    for box in torch.as_tensor(np.asarray(boxes), **f64):
        t = torch.minimum(t, _slab(origins, dirs, box[0], box[1], inside=False))
    t = torch.where(torch.isfinite(t), t, torch.full_like(t, max_range * 2.0))
    if noise is not None:
        t = t + noise
    rel = t[..., None] * dirs
    c, s = torch.cos(-yaw), torch.sin(-yaw)
    x = c * rel[..., 0] - s * rel[..., 1]
    y = s * rel[..., 0] + c * rel[..., 1]
    return torch.stack([x, y, rel[..., 2]], dim=-1)


def noise_generator(seed: int, device) -> torch.Generator:
    """The generator every draw of a run takes from ``seed`` (any whole
    number that fits 64 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def segments(mix: dict, lidar, seed: int, device) -> List[Segment]:
    """The mix's ``segments`` distinct segments, rendered on ``device``,
    the range noise of all of them drawn from ``seed`` in one call."""
    n, F = int(mix["segments"]), int(mix["frames"])
    L, P = lidar["scan_lines"], lidar["points_per_line"]
    noise = torch.randn((n, F, L, P), generator=noise_generator(seed, device), dtype=torch.float32,
                        device=device).to(torch.float64) * float(mix["noise"])
    out = []
    for k in range(n):
        boxes, pos, yaw = layout(mix, k)
        scans = render(L, P, float(lidar["max_range"]), pos, yaw, boxes, float(mix["room"]), noise[k],
                       device).to(torch.float32)
        out.append(Segment(scans, *relative(pos, yaw)))
    return out


def relative(positions: np.ndarray, yaws: np.ndarray):
    """Positions and yaws relative to frame 0's pose (its frame at the
    identity), the frame a trajectory of the port starts in."""
    c, s = math.cos(-yaws[0]), math.sin(-yaws[0])
    d = positions - positions[0]
    rel = np.stack([c * d[:, 0] - s * d[:, 1], s * d[:, 0] + c * d[:, 1], d[:, 2]], axis=-1)
    return rel, yaws - yaws[0]


def order(n_segments: int, seed: int) -> np.ndarray:
    """The closed loop's visiting order of the segments, drawn from the
    seed (the loop cycles through it)."""
    return np.random.default_rng([int(seed) % (1 << 63), 1]).permutation(n_segments)


def judged(mix: dict, seed: int) -> List[int]:
    """The segments whose calls the correctness check judges: ``check``
    of them, drawn from the seed."""
    n = int(mix["segments"])
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    return sorted(int(k) for k in rng.choice(n, size=min(int(mix["check"]), n), replace=False))
