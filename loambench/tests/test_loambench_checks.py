"""The check that decides ``correct`` fails where it should: a run driven on
the CPU at a small size (the harness's look for a card skipped), with the
timed path broken underneath, comes out not correct under the cell's own
limits, once for each fault the cell can have; and the control (the
reference in bfloat16, in the program's place) fails them too.

    python -m pytest loambench/tests -q -n0
"""

from __future__ import annotations

import copy

import pytest
import torch

from loambench import cells, control, judge
from loambench.run import run_cell

SHIFT = 1.0  # m: an answer altered where it is produced


def small(name: str) -> dict:
    cell = copy.deepcopy(cells.cell(name))
    cell["config"]["lidar"].update(scan_lines=16, points_per_line=360, max_range=80.0)
    if "scan_to_map" in cell["config"]:
        cell["config"]["scan_to_map"].update(edge_capacity=2048, planar_capacity=8192)
    cell["traffic"].update(frames=6, segments=1, check=1)
    return cell


def run(cell):
    torch.set_num_threads(4)
    result, rows = run_cell(cell, 2**31 + 77, 0.5, False, torch.device("cpu"), log=lambda s: None)
    return result, rows


def _shifted(fn, where):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        traj = out[where]
        moved = type(traj)(traj.rotation, traj.translation + SHIFT * (torch.arange(
            traj.translation.shape[0], dtype=traj.translation.dtype) % 2)[:, None])
        return tuple(moved if i == where else x for i, x in enumerate(out))
    return wrapped


def test_s2s_answer_altered(monkeypatch):
    from loam_tpu_torch.odometry import offline

    monkeypatch.setattr(offline, "_trajectory", _shifted(offline._trajectory, 0))
    result, rows = run(small("s2s-os1-64-walk16"))
    assert not result["correct"], rows


def test_s2s_half_the_batch_left_out(monkeypatch):
    """Each chunk registers the first half of its pairs; the rest keep
    their initial pose."""
    from loam_tpu_torch.odometry import offline

    real = offline.register_features_batch

    def half(src, tgt, init, params, **kw):
        est, det = real(src, tgt, init, params, **kw)
        keep = torch.arange(est.rotation.shape[0]) < (est.rotation.shape[0] + 1) // 2
        pick = lambda a, b: torch.where(keep.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
        return type(est)(pick(est.rotation, init.rotation), pick(est.translation, init.translation)), det

    monkeypatch.setattr(offline, "register_features_batch", half)
    result, rows = run(small("s2s-os1-64-walk16"))
    assert not result["correct"], rows


S2M = ["s2m-os1-64-walk16", "s2m-os1-64-drive16"]


@pytest.mark.parametrize("name", S2M)
def test_s2m_state_unchanged(monkeypatch, name):
    """A keyframe's insert leaves the maps as they were."""
    from loam_tpu_torch.odometry import scan_to_map

    monkeypatch.setattr(scan_to_map, "_insert_maps", lambda *a, **k: None)
    result, rows = run(small(name))
    assert not result["correct"], rows


@pytest.mark.parametrize("name", S2M)
def test_s2m_answer_altered(monkeypatch, name):
    from loam_tpu_torch.odometry import scan_to_map

    real = scan_to_map._trajectory

    def moved(*a, **k):
        traj, det = real(*a, **k)
        return type(traj)(traj.rotation, traj.translation + SHIFT), det

    monkeypatch.setattr(scan_to_map, "_trajectory", moved)
    result, rows = run(small(name))
    assert not result["correct"], rows


@pytest.mark.parametrize("name", ["s2s-os1-64-walk16"] + S2M)
def test_the_control_fails_the_limits(name):
    """The reference in bfloat16 in the program's place."""
    cell = small(name)
    torch.set_num_threads(4)
    got = control.readings(name, [2**31 + 3], 1, False, torch.device("cpu"), cell, log=lambda s: None)
    rows = judge.verdict(got["upper"], cell["limits"])
    assert not judge.correct(rows), rows
