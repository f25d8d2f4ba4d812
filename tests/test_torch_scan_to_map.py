"""Scan-to-map in the port against ``loam_tpu``: Morton keys, the Morton
feature sort, the voxel-map insert and the ``scan_to_map_offline`` driver on
the ``test_odometry.py`` trajectory (16x360 scans, 6 frames), with map
capacities 2048/8192.

Tolerances. Morton keys, sort orders, map contents (points, mask) and
``dropped`` are exact: the same float32 operations on the same inputs.
Trajectories in float32 agree within the ICF convergence thresholds (1e-2 m,
1e-3 rad), with equal termination codes: the two packages sum the normal
equations in different orders (see ``test_torch_odometry.py``).

``loam_tpu`` reaches its dual kNN only on a TPU; as in
``test_odometry.py::test_scan_to_map_prep_cache_path_matches_uncached``, the
test makes it take that path on the CPU with the Pallas kernel in interpret
mode (``conftest.py`` sets ``LOAM_PALLAS_INTERPRET=1``).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import loam_tpu as J
from loam_tpu.io import render_trajectory
from loam_tpu.ops import morton as j_morton
from loam_tpu.odometry import scan_to_map as j_s2m
from loam_tpu.registration.icf import spatial_sort_features as j_spatial

import loam_tpu_torch as T
from loam_tpu_torch.evaluation import ate_rmse, relative_pose_gaps
from loam_tpu_torch.odometry import scan_to_map as t_s2m
from loam_tpu_torch.ops import morton
from loam_tpu_torch.params import from_reference
from loam_tpu_torch.registration import spatial_sort_features

# the suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing its cores
torch.set_num_threads(1)

LIDAR = J.LidarParams(16, 360, 0.5, 80.0)
N_FRAMES = 6
J_CFG = j_s2m.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
J_REG = J.RegistrationParams(search_backend="bruteforce", prior_weight=300.0)
POS_TOL, ROT_TOL = 1e-2, 1e-3
MIXED_PAIR_M, MIXED_PAIR_RAD = 2e-3, 1e-3


@pytest.fixture(scope="module")
def trajectory():
    scans, poses = render_trajectory(LIDAR, N_FRAMES, step=np.array([0.10, 0.03, 0.0]),
                                     yaw_rate=0.02, noise=0.003, seed=11, dtype=np.float32)
    return scans, np.stack([t for (_, t) in poses])


def _close(t_pose, j_rot, j_trans):
    np.testing.assert_allclose(t_pose.translation.numpy(), np.asarray(j_trans), atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(t_pose.rotation.numpy(), np.asarray(j_rot), atol=ROT_TOL, rtol=0)


def test_morton_key_matches_loam_tpu():
    rng = np.random.default_rng(0)
    # in span, near cell borders, and far outside the span (clamped)
    pts = np.concatenate([
        rng.uniform(-80, 80, (500, 3)),
        np.round(rng.uniform(-50, 50, (200, 3)), 1),
        rng.uniform(-1e4, 1e4, (100, 3)),
    ]).astype(np.float32)
    origin = np.array([1.5, -2.0, 0.25], np.float32)
    for cell in (1.0, 0.2, 0.4):
        cs = np.float32(cell)
        want = np.asarray(j_morton.morton_key(jnp.asarray(pts), jnp.asarray(cs), jnp.asarray(origin)))
        got = morton.morton_key(torch.from_numpy(pts), torch.tensor(cs), torch.from_numpy(origin))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        morton.morton_key(torch.from_numpy(pts), 1.0).numpy(),
        np.asarray(j_morton.morton_key(jnp.asarray(pts), 1.0)))


def test_spatial_sort_matches_loam_tpu(trajectory):
    scans, _ = trajectory
    # the port's features (index-exact against loam_tpu's) of two frames
    fs = T.extract_features_batch(torch.from_numpy(scans[:2]), from_reference(LIDAR))
    got = spatial_sort_features(fs)  # leading frame axis
    for f in range(2):
        want = j_spatial(J.FeatureSet(*(jnp.asarray(x[f]) for x in fs.to_numpy())))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[f].numpy(), np.asarray(b))
    # masked slots last
    m = got.planar_mask[0]
    assert m[: int(m.sum())].all() and not m[int(m.sum()):].any()


def test_voxel_map_inserts_match_loam_tpu():
    """Three successive inserts: plain, with eviction around a centre, and
    one past the capacity; contents and ``dropped`` exact."""
    rng = np.random.default_rng(3)
    j_map = J.voxel_map_empty(256, 0.4, origin=(0.5, -0.5, 0.0), dtype=jnp.float32)
    t_map = T.voxel_map_empty(256, 0.4, origin=(0.5, -0.5, 0.0), dtype=torch.float32, device="cpu")
    steps = [
        (rng.uniform(-3, 3, (200, 3)), None, 0.0),  # many shared voxels
        (rng.uniform(-8, 8, (200, 3)), np.array([1.0, 1.0, 0.0]), 6.0),  # eviction
        (rng.uniform(-20, 20, (300, 3)), None, 0.0),  # overflows 256 slots
    ]
    dropped = []
    for pts, center, radius in steps:
        pts = pts.astype(np.float32)
        mask = rng.random(len(pts)) > 0.1
        jc = None if center is None else jnp.asarray(center, jnp.float32)
        tc = None if center is None else torch.tensor(center, dtype=torch.float32)
        j_map, jd = J.voxel_map_insert(j_map, jnp.asarray(pts), jnp.asarray(mask), jc, radius)
        t_map, td = T.voxel_map_insert(t_map, torch.from_numpy(pts), torch.from_numpy(mask), tc, radius)
        np.testing.assert_array_equal(t_map.mask.numpy(), np.asarray(j_map.mask))
        np.testing.assert_array_equal(t_map.points.numpy(), np.asarray(j_map.points))
        assert int(td) == int(jd)
        dropped.append(int(td))
    assert dropped[0] == 0 and dropped[-1] > 0
    assert int(t_map.size) == 256


@pytest.fixture(scope="module")
def jax_dual_run(trajectory):
    """loam_tpu's scan-to-map loop through its own dual kNN path: per-frame
    poses and terminations, the final map sizes, and the numpy state after
    frame 2. (Its ``scan_to_map_offline`` runs the same step under
    ``lax.scan``, ``test_odometry.py::test_scan_to_map_offline_matches_streaming``.)"""
    scans, _ = trajectory
    kp = importlib.import_module("loam_tpu.ops.knn_pallas")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_s2m, "_use_prep_cache", lambda dtype: False)
        mp.setattr(kp, "pallas_supported", lambda: True)
        mp.setenv("LOAM_ICF_DUAL_KNN", "1")
        jax.clear_caches()
        state = j_s2m.scan_to_map_init(J_CFG)
        rots, trans, terms = [], [], []
        for f in range(N_FRAMES):
            state, pose, det = J.scan_to_map_step(state, jnp.asarray(scans[f]), LIDAR,
                                                  reg_params=J_REG, config=J_CFG)
            rots.append(np.asarray(pose.rotation))
            trans.append(np.asarray(pose.translation))
            terms.append(int(det.termination))
            if f == 2:
                state2 = jax.tree.map(np.asarray, state)
        sizes = (int(state.edge_map.size), int(state.planar_map.size))
    jax.clear_caches()
    return np.stack(rots), np.stack(trans), np.asarray(terms), sizes, state2


def test_scan_to_map_offline_dual_matches_loam_tpu(trajectory, jax_dual_run, monkeypatch):
    scans, gt = trajectory
    j_rot, j_trans, j_term, (j_ne, j_np), _ = jax_dual_run
    monkeypatch.setenv("LOAM_ICF_DUAL_KNN", "1")
    cfg = from_reference(J_CFG)
    state, traj, det = T.scan_to_map_offline(torch.from_numpy(scans), from_reference(LIDAR),
                                             reg_params=from_reference(J_REG), config=cfg)
    assert traj.translation.shape == (N_FRAMES, 3)
    _close(traj, j_rot, j_trans)
    np.testing.assert_array_equal(det.termination.numpy(), j_term)
    assert int(state.dropped) == 0
    # the maps hold the same number of voxels (positions differ by the
    # pose tolerance, so an occasional voxel border may move a point)
    assert abs(int(state.edge_map.size) - int(j_ne)) <= 0.02 * int(j_ne)
    assert abs(int(state.planar_map.size) - int(j_np)) <= 0.02 * int(j_np)
    ate = ate_rmse(traj.translation.numpy(), gt, align=False)
    assert ate < 0.05, ate  # test_odometry.py's scan-to-map bound

    # the port's single-search ICF: the dual plain search equals the two
    # single ones and both association paths fit alike, so the trajectory
    # is the same, bit for bit
    monkeypatch.setenv("LOAM_ICF_DUAL_KNN", "0")
    _, traj1, det1 = T.scan_to_map_offline(torch.from_numpy(scans), from_reference(LIDAR),
                                           reg_params=T.default_map_reg_params(), config=cfg)
    assert torch.equal(det1.termination, det.termination)
    assert torch.equal(det1.num_iterations, det.num_iterations)
    assert torch.equal(traj1.translation, traj.translation)
    assert torch.equal(traj1.rotation, traj.rotation)


def test_scan_to_map_state_from_loam_tpu_continues(trajectory, jax_dual_run):
    """A loam_tpu state after 3 frames, carried into the port, continues
    along loam_tpu's own trajectory (the port's single-search ICF here)."""
    scans, _ = trajectory
    j_rot, j_trans, j_term, _, state2 = jax_dual_run
    t_state = T.ScanToMapState.from_numpy(state2, device="cpu")
    np.testing.assert_array_equal(t_state.planar_map.points.numpy(), state2.planar_map.points)
    np.testing.assert_array_equal(t_state.edge_map.mask.numpy(), state2.edge_map.mask)
    assert int(t_state.frames_since_insert) == int(state2.frames_since_insert)
    for f in range(3, N_FRAMES):
        t_state, t_pose, det = T.scan_to_map_step(t_state, torch.from_numpy(scans[f]),
                                                  from_reference(LIDAR),
                                                  reg_params=from_reference(J_REG),
                                                  config=from_reference(J_CFG))
        _close(t_pose, j_rot[f], j_trans[f])
        assert int(det.termination) == j_term[f]


def test_scan_to_map_api():
    assert from_reference(J_CFG) == T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
    assert T.default_map_reg_params() == T.RegistrationParams(search_backend="bruteforce",
                                                              prior_weight=300.0)
    s = T.scan_to_map_init(T.ScanToMapConfig(edge_capacity=16, planar_capacity=32), device="cpu")
    assert s.knn_prep_cache == () and int(s.frames_since_insert) == -1
    assert s.edge_map.points.shape == (16, 3) and s.planar_map.points.shape == (32, 3)
    assert T.scan_to_map_strip_cache(s).knn_prep_cache == ()
    assert T.scan_to_map_rebuild_cache(s, T.LidarParams(16, 360, 0.5, 80.0)).knn_prep_cache == ()


def test_f11_float64_frames_seed_the_kernel_in_the_maps_dtype(trajectory, monkeypatch):
    """F11: float64 frames against float32 maps (``scan_to_map_offline`` on
    float64 scans from its default state, as ``loam_tpu``'s step makes it)
    raised on the card. The search runs in the maps' dtype, the queries
    rounded to it, as on the CPU; on the card that is the float32 kernel,
    and the ICF loop's seeded search carried its last neighbours for the
    kernel's warm start in the frames' float64, which the kernel refuses
    (``TypeError`` on ``seed_prev``). The carry holds the search's dtype
    now. On the CPU the card's dispatch (``kernel_takes``: float32) and the
    kernel's launch are stood in for, the stand-in refusing what the
    kernel refuses and otherwise searching plainly: the seeded loop runs
    and equals the unseeded one bit for bit (the seeds only prune)."""
    from loam_tpu_torch.ops import knn_cuda
    from loam_tpu_torch.registration import icf

    scans, _ = trajectory
    lidar = from_reference(LIDAR)
    cfg = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
    state, traj, _ = T.scan_to_map_offline(torch.from_numpy(scans[:3]), lidar, config=cfg)
    assert state.planar_map.points.dtype == torch.float32
    src = spatial_sort_features(T.extract_features(torch.from_numpy(scans[3].astype(np.float64)), lidar))
    tgt = t_s2m._map_feature_set(state.edge_map, state.planar_map)
    init = T.Pose3(traj.rotation[-1].double(), traj.translation[-1].double())
    launched = []

    def kernel(prep, queries, k, init_d2, query_mask, seed=None, visits=False, bound=False, prev=None,
               window=False):
        for name, x in [("targets", prep.tT), ("queries", queries)] + \
                list(zip(("seed_prev xs", "seed_prev ys", "seed_prev zs"), prev or ())):
            if x.dtype != torch.float32:
                raise TypeError(f"{name} has dtype {x.dtype}, expected float32")
        launched.append(prev is not None)
        idx, d2, coords = knn_cuda._search_planes(prep.tT, queries, k, init_d2, query_mask)
        return idx, d2, coords, None, None

    monkeypatch.setattr(knn_cuda, "kernel_takes", lambda t: t.dtype == torch.float32)
    monkeypatch.setattr(knn_cuda, "_search_kernel", kernel)
    add = lambda x: x[None]
    runs = [icf._register_body(src.map(add), tgt.map(add), T.Pose3(add(init.rotation), add(init.translation)),
                               T.default_map_reg_params(), False, "single", None, False, seeded)
            for seeded in (True, False)]
    assert any(launched) and not all(launched)  # warm-started launches, then unseeded ones
    (est, det), (est0, det0) = runs
    assert est.translation.dtype == torch.float64
    assert torch.equal(est.translation, est0.translation) and torch.equal(est.rotation, est0.rotation)
    assert torch.equal(det.termination, det0.termination) and int(det.num_iterations[0]) > 1


def test_f14_float64_scans_from_the_default_state_follow_loam_tpu():
    """F14: float64 scans through ``scan_to_map_offline`` from the default
    state (float32 maps and poses) against ``loam_tpu``'s nearest run.
    ``loam_tpu``'s own call refuses that state for float64 scans (its scan
    carry would turn float64); its step makes the poses float64 after a
    frame and keeps the maps float32, so its run starts there. In both
    packages the search and the neighbour fits run in the maps' float32,
    the frame's pose and solve in float64. The port had promoted the maps
    into float64 for the registration, so its run followed its float64
    path instead: 2.03 mm and 1.74e-3 rad from ``loam_tpu``'s at pair 10
    here, three pairs past the gate. The gate: every pair's relative pose
    within ``MIXED_PAIR_M`` (2 mm) and ``MIXED_PAIR_RAD`` (1e-3 rad) of
    ``loam_tpu``'s, the per-pair float32 gate ``chip_smoke.py`` holds the
    card's float32 drive to, and equal termination codes. 16 frames of
    16x360 on phase 16's trajectory, maps of 4,096 / 16,384 slots."""
    lidar = J.LidarParams(16, 360, 0.5, 80.0)
    fp = J.FeatureExtractionParams(precise_selection=True)
    scans, _ = render_trajectory(lidar, 16, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01, noise=0.005,
                                 seed=0, dtype=np.float32)
    scans = scans.astype(np.float64)
    j_cfg = j_s2m.ScanToMapConfig(edge_capacity=4096, planar_capacity=16384)
    st0 = j_s2m.scan_to_map_init(j_cfg, lidar=lidar, feat_params=fp)
    f64 = lambda p: J.Pose3(p.rotation.astype(jnp.float64), p.translation.astype(jnp.float64))
    st0 = st0._replace(world_T_current=f64(st0.world_T_current), prev_delta=f64(st0.prev_delta),
                       world_T_keyframe=f64(st0.world_T_keyframe))
    _, jt, jd = J.scan_to_map_offline(jnp.asarray(scans), lidar, fp, config=j_cfg, init_state=st0)
    st, tt, td = T.scan_to_map_offline(torch.from_numpy(scans), from_reference(lidar), from_reference(fp),
                                       config=T.ScanToMapConfig(edge_capacity=4096, planar_capacity=16384))
    assert st.planar_map.points.dtype == torch.float32 and tt.translation.dtype == torch.float64
    dt, angle = relative_pose_gaps(tt.translation.numpy(), tt.rotation.numpy(), np.asarray(jt.translation),
                                   np.asarray(jt.rotation))
    gap = np.linalg.norm(dt, axis=1)
    print(f"float64 scans, float32 maps, port vs loam_tpu per pair: {gap.max():.4e} m, {angle.max():.4e} rad")
    assert gap.max() <= MIXED_PAIR_M and angle.max() <= MIXED_PAIR_RAD, (gap.max(), angle.max())
    np.testing.assert_array_equal(td.termination.numpy(), np.asarray(jd.termination))
