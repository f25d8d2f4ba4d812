"""Scan-to-scan in the port against ``loam_tpu``: ``dewarp_scan`` and the
streaming ``scan_to_scan_step`` loop on the ``test_odometry.py`` trajectory
(16x360 scans, 6 frames).

Tolerances. ``dewarp_scan`` in float32: atol 1e-5 m (the two packages'
quaternion and screw expressions round alike but for summation order).
The loop: termination codes equal; poses within 1e-2 m / 1e-3 rad in
float32 (the ICF convergence thresholds, see ``test_torch_odometry.py``)
and 1e-4 in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import loam_tpu as J
from loam_tpu.geometry import quat_from_axis_angle
from loam_tpu.io import render_trajectory
from loam_tpu.io.synthetic import render_scan_swept

import loam_tpu_torch as T
from loam_tpu_torch.evaluation import ate_rmse
from loam_tpu_torch.params import from_reference

# the suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing its cores
torch.set_num_threads(1)

LIDAR = J.LidarParams(16, 360, 0.5, 80.0)
N_FRAMES = 6


@pytest.fixture(scope="module")
def trajectory():
    scans, poses = render_trajectory(LIDAR, N_FRAMES, step=np.array([0.10, 0.03, 0.0]),
                                     yaw_rate=0.02, noise=0.003, seed=11, dtype=np.float32)
    return scans, np.stack([t for (_, t) in poses])


@pytest.mark.parametrize("exact", [False, True])
def test_dewarp_matches_loam_tpu(exact):
    # a swept scan under a fast yaw and a long translation, where the two
    # laws differ by cm
    warped, _ = render_scan_swept(LIDAR, np.zeros(3), 0.0, np.array([0.6, 0.2, 0.05]), 0.3,
                                  dtype=np.float32)
    warped[::3, ::7] = 0.0  # empty cells must stay empty
    rot = np.asarray(quat_from_axis_angle(jnp.asarray([0.1, 0.2, 1.0]) / np.sqrt(1.05), 0.3),
                     np.float32)
    trans = np.array([0.6, 0.2, 0.05], np.float32)
    want = np.asarray(J.dewarp_scan(jnp.asarray(warped), J.Pose3(jnp.asarray(rot), jnp.asarray(trans)),
                                    LIDAR, exact=exact))
    motion = T.Pose3(torch.from_numpy(rot), torch.from_numpy(trans))
    got = T.dewarp_scan(torch.from_numpy(warped), motion, from_reference(LIDAR), exact=exact)
    assert got.dtype == torch.float32 and got.shape == warped.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    empty = np.sum(warped * warped, axis=-1) == 0
    assert empty.any() and (got.numpy()[empty] == 0).all()
    # flat (L*P, 3) input gives the same points in the flat shape
    flat = T.dewarp_scan(torch.from_numpy(warped.reshape(-1, 3)), motion, from_reference(LIDAR),
                         exact=exact)
    assert flat.shape == (LIDAR.scan_lines * LIDAR.points_per_line, 3)
    assert torch.equal(flat.reshape(got.shape), got)


_JAX_RUNS = {}


def _jax_loop(scans, dtype, dewarp):
    """loam_tpu's loop over the frames, once per configuration: per-frame
    (rotation, translation, termination) and the numpy state after frame 2."""
    key = (np.dtype(dtype).name, dewarp)
    if key not in _JAX_RUNS:
        js = J.scan_to_scan_init(LIDAR, dtype=jnp.dtype(dtype))
        frames, state2 = [], None
        for f in range(N_FRAMES):
            js, jp, jd = J.scan_to_scan_step(js, jnp.asarray(scans[f].astype(dtype)), LIDAR,
                                             dewarp=dewarp)
            frames.append((np.asarray(jp.rotation), np.asarray(jp.translation), int(jd.termination)))
            if f == 2:
                state2 = jax.tree.map(np.asarray, js)
        _JAX_RUNS[key] = (frames, state2)
    return _JAX_RUNS[key]


@pytest.mark.parametrize(
    "dtype,dewarp,pos_tol,rot_tol",
    [(np.float32, False, 1e-2, 1e-3), (np.float64, True, 1e-4, 1e-4)],
    ids=["f32", "f64-dewarp"],
)
def test_scan_to_scan_loop_matches_loam_tpu(trajectory, dtype, dewarp, pos_tol, rot_tol):
    scans, gt = trajectory
    frames, _ = _jax_loop(scans, dtype, dewarp)
    tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
    ts = T.scan_to_scan_init(from_reference(LIDAR), dtype=tdt, device="cpu")
    t_pos = []
    for f, (j_rot, j_trans, j_term) in enumerate(frames):
        ts, tp, td = T.scan_to_scan_step(ts, torch.from_numpy(scans[f].astype(dtype)),
                                         from_reference(LIDAR), dewarp=dewarp)
        assert tp.translation.dtype == tdt
        np.testing.assert_allclose(tp.translation.numpy(), j_trans, atol=pos_tol, rtol=0)
        np.testing.assert_allclose(tp.rotation.numpy(), j_rot, atol=rot_tol, rtol=0)
        assert int(td.termination) == j_term
        t_pos.append(tp.translation.numpy())
    assert ate_rmse(np.stack(t_pos), gt, align=False) < 0.05  # test_odometry.py's bound


def test_scan_to_scan_state_from_loam_tpu(trajectory):
    """A loam_tpu state after 3 frames, converted to numpy, continues in the
    port along loam_tpu's own trajectory (float32, 1e-2 m / 1e-3 rad)."""
    scans, _ = trajectory
    frames, state2 = _jax_loop(scans, np.float32, False)
    ts = T.ScanToScanState.from_numpy(state2, device="cpu")
    for a, b in zip(ts.prev_features, state2.prev_features):
        np.testing.assert_array_equal(a.numpy(), b)
    for f in range(3, N_FRAMES):
        ts, tp, td = T.scan_to_scan_step(ts, torch.from_numpy(scans[f]), from_reference(LIDAR))
        np.testing.assert_allclose(tp.translation.numpy(), frames[f][1], atol=1e-2, rtol=0)
        np.testing.assert_allclose(tp.rotation.numpy(), frames[f][0], atol=1e-3, rtol=0)
        assert int(td.termination) == frames[f][2]
