"""The slice end to end: the port's ``odometry_offline`` against
``loam_tpu.odometry_offline`` on the ``test_odometry.py`` trajectory
(16x360 scans, 6 frames, ``chunk_pairs=2``, ``motion_init=True``), both on
the CPU, and the benchmark's ATE gate (``bench.py::_check_accuracy``).

Tolerances. float64 (the fixture's float32 scans upcast for both packages):
trajectories within 1e-4 m and 1e-4 rad, termination codes and iteration
counts equal -- the two packages sum the normal equations, and compose the
poses, in different orders. float32: within the ICF convergence thresholds
(1e-2 m, 1e-3 rad): nearly collinear planar neighborhoods amplify the
rounding-order differences to ~2e-3 m there (see test_torch_registration.py).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import loam_tpu as J
from loam_tpu.io import render_trajectory

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


def _ate_gate(est, gt):
    """bench.py::_check_accuracy: ATE < max(5% of the path, 0.05 m)."""
    assert np.isfinite(est).all()
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    ate = ate_rmse(est, gt, align=False)
    assert ate < max(0.05 * path, 0.05), ate


def _run_both(scans, dtype, chunk_pairs=2, motion_init=True):
    fp, rp = J.FeatureExtractionParams(), J.RegistrationParams(search_backend="bruteforce")
    x = scans.astype(dtype)
    tj, dj = J.odometry_offline(jnp.asarray(x), LIDAR, fp, rp, chunk_pairs=chunk_pairs,
                                motion_init=motion_init)
    tt, dt = T.odometry_offline(torch.from_numpy(x), from_reference(LIDAR), from_reference(fp),
                                from_reference(rp), chunk_pairs=chunk_pairs, motion_init=motion_init)
    return tj, dj, tt, dt


@pytest.mark.parametrize(
    "dtype,pos_tol,rot_tol,exact_counts",
    [(np.float64, 1e-4, 1e-4, True), (np.float32, 1e-2, 1e-3, False)],
    ids=["f64", "f32"],
)
def test_odometry_offline_matches_loam_tpu(trajectory, dtype, pos_tol, rot_tol, exact_counts):
    scans, gt = trajectory
    tj, dj, tt, dt = _run_both(scans, dtype)
    assert tt.translation.shape == (N_FRAMES, 3) and tt.rotation.shape == (N_FRAMES, 4)
    assert tt.translation.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    np.testing.assert_allclose(tt.translation.numpy(), np.asarray(tj.translation), atol=pos_tol, rtol=0)
    np.testing.assert_allclose(tt.rotation.numpy(), np.asarray(tj.rotation), atol=rot_tol, rtol=0)
    np.testing.assert_array_equal(dt.termination.numpy(), np.asarray(dj.termination))
    if exact_counts:
        np.testing.assert_array_equal(dt.num_iterations.numpy(), np.asarray(dj.num_iterations))
    _ate_gate(tt.translation.numpy(), gt)


def test_odometry_chunking_matches_single_batch(trajectory):
    # lockstep batches of 2 pairs (no motion prior; 3 pairs, so the last
    # chunk is padded) register every pair exactly as one batch of all pairs
    scans, _ = trajectory
    args = (torch.from_numpy(scans[:4].astype(np.float64)), from_reference(LIDAR))
    ta, da = T.odometry_offline(*args, chunk_pairs=2)
    tb, db = T.odometry_offline(*args, chunk_pairs=0)
    np.testing.assert_allclose(ta.translation.numpy(), tb.translation.numpy(), atol=1e-12)
    np.testing.assert_allclose(ta.rotation.numpy(), tb.rotation.numpy(), atol=1e-12)
    np.testing.assert_array_equal(da.num_iterations.numpy(), db.num_iterations.numpy())
    with pytest.raises(ValueError):
        T.odometry_offline(args[0][:1], args[1])


def test_import_leaves_jax_out():
    code = ("import sys, loam_torch, loam_tpu_torch, loam_tpu_torch.odometry, "
            "loam_tpu_torch.ops.knn_cuda, loam_tpu_torch.adapters, loam_tpu_torch.checkpoint, "
            "loam_tpu_torch.compat, loam_tpu_torch.debug, loam_tpu_torch.io.native, "
            "loam_tpu_torch.loop_closure, loam_tpu_torch.pose_graph, loam_tpu_torch.profiling, "
            "loam_tpu_torch.program, loam_tpu_torch.profile_offline; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'loam_tpu.'))"
            " or m == 'loam_tpu']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
