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

That absolute float32 bound holds at this length only: float32 leans the
same way at every pair in both packages, so the absolute gap grows about
linearly with the frames (``loam_tpu``'s own float32 trajectory leaves its
float64 one by 11.9 mm over 40 frames of 32x512, a CPU read). The tolerance
that holds at any length is per pair (``test_float32_per_pair_tolerance``):
the relative pose ``T[i]^-1 T[i+1]`` of each consecutive pair, the rotation
read from the vector part of the relative quaternion
(``evaluation.relative_pose_gaps``). The port's float32 error per pair
(against its float64 run) is at most ``PAIR_FACTOR`` (1.5) times
``loam_tpu``'s own float32 error (against its float64 run) plus a floor
(``PAIR_FLOOR_M`` 1e-4 m, ``PAIR_FLOOR_RAD`` 2e-5 rad), for the largest and
for the mean over the pairs; port float32 against ``loam_tpu`` float32 per
pair is within ``1 + PAIR_FACTOR`` times ``loam_tpu``'s own error plus the
floor; the port's ATE is at most ``loam_tpu``'s times ``1 + ATE_MARGIN``
(5%); termination codes equal.
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
from loam_tpu_torch.evaluation import ate_rmse, relative_pose_gaps
from loam_tpu_torch.params import from_reference

# the suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing its cores
torch.set_num_threads(1)

LIDAR = J.LidarParams(16, 360, 0.5, 80.0)
N_FRAMES = 6
#: the longer CPU case of the per-pair tolerance: the same drive, 24 frames
LONG_FRAMES = 24
PAIR_FACTOR, PAIR_FLOOR_M, PAIR_FLOOR_RAD, ATE_MARGIN = 1.5, 1e-4, 2e-5, 0.05


def _render(n_frames):
    scans, poses = render_trajectory(LIDAR, n_frames, step=np.array([0.10, 0.03, 0.0]),
                                     yaw_rate=0.02, noise=0.003, seed=11, dtype=np.float32)
    return scans, np.stack([t for (_, t) in poses])


@pytest.fixture(scope="module")
def trajectory():
    return _render(N_FRAMES)


def _ate_gate(est, gt):
    """bench.py::_check_accuracy: ATE < max(5% of the path, 0.05 m)."""
    assert np.isfinite(est).all()
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    ate = ate_rmse(est, gt, align=False)
    assert ate < max(0.05 * path, 0.05), ate


_RUNS = {}  # both packages' runs by input, shared by the tests of this module


def _run_both(scans, dtype, chunk_pairs=2, motion_init=True):
    key = (scans.shape, hash(scans.tobytes()), np.dtype(dtype).name, chunk_pairs, motion_init)
    if key not in _RUNS:
        fp, rp = J.FeatureExtractionParams(), J.RegistrationParams(search_backend="bruteforce")
        x = scans.astype(dtype)
        tj, dj = J.odometry_offline(jnp.asarray(x), LIDAR, fp, rp, chunk_pairs=chunk_pairs,
                                    motion_init=motion_init)
        tt, dt = T.odometry_offline(torch.from_numpy(x), from_reference(LIDAR), from_reference(fp),
                                    from_reference(rp), chunk_pairs=chunk_pairs, motion_init=motion_init)
        _RUNS[key] = tj, dj, tt, dt
    return _RUNS[key]


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


def _pair_gap(a, b):
    """Per-pair translation gap vectors (P, 3) and rotation gaps (P,) of
    two trajectories given as (translation, rotation) numpy arrays."""
    return relative_pose_gaps(a[0], a[1], b[0], b[1])


@pytest.mark.parametrize("n_frames", [N_FRAMES, LONG_FRAMES], ids=["6_frames", "24_frames"])
def test_float32_per_pair_tolerance(trajectory, n_frames):
    """F6 per pair (module docstring): float32 against float64 in each
    package, and the port's float32 run against ``loam_tpu``'s, pair by pair;
    the ATE of both float32 runs against the renderer's poses; termination
    codes. Prints both packages' mean gap vector, where a bias of the port's
    own would show."""
    scans, gt = trajectory if n_frames == N_FRAMES else _render(n_frames)
    runs = {}
    for dtype in (np.float32, np.float64):
        tj, dj, tt, dt = _run_both(scans, dtype)
        runs["loam_tpu", dtype] = (np.asarray(tj.translation), np.asarray(tj.rotation)), np.asarray(dj.termination)
        runs["port", dtype] = (tt.translation.numpy(), tt.rotation.numpy()), dt.termination.numpy()
    err = {}
    for pkg in ("loam_tpu", "port"):
        dt_, ang = _pair_gap(runs[pkg, np.float32][0], runs[pkg, np.float64][0])
        err[pkg] = np.linalg.norm(dt_, axis=-1), ang
        print(f"{n_frames} frames, {pkg} float32 vs float64 per pair: translation max "
              f"{err[pkg][0].max():.4e} mean {err[pkg][0].mean():.4e} m, mean gap vector "
              f"{dt_.mean(axis=0)} m; rotation max {ang.max():.4e} mean {ang.mean():.4e} rad")
    for i, (what, floor) in enumerate((("translation", PAIR_FLOOR_M), ("rotation", PAIR_FLOOR_RAD))):
        port, ref = err["port"][i], err["loam_tpu"][i]
        for stat in (np.max, np.mean):
            assert stat(port) <= PAIR_FACTOR * stat(ref) + floor, (what, stat.__name__, stat(port), stat(ref))
    dt_, ang = _pair_gap(runs["port", np.float32][0], runs["loam_tpu", np.float32][0])
    cross = np.linalg.norm(dt_, axis=-1)
    print(f"{n_frames} frames, port float32 vs loam_tpu float32 per pair: translation max {cross.max():.4e} m, "
          f"mean gap vector {dt_.mean(axis=0)} m; rotation max {ang.max():.4e} rad")
    assert cross.max() <= (1 + PAIR_FACTOR) * err["loam_tpu"][0].max() + PAIR_FLOOR_M, cross.max()
    assert ang.max() <= (1 + PAIR_FACTOR) * err["loam_tpu"][1].max() + PAIR_FLOOR_RAD, ang.max()
    ate = {pkg: ate_rmse(runs[pkg, np.float32][0][0], gt, align=False) for pkg in ("loam_tpu", "port")}
    assert ate["port"] <= ate["loam_tpu"] * (1 + ATE_MARGIN), ate
    np.testing.assert_array_equal(runs["port", np.float32][1], runs["loam_tpu", np.float32][1])


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
