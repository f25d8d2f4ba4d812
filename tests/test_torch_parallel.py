"""The port's multi-device surface (``loam_tpu_torch.parallel``,
``pose_graph.optimize_pose_graph_sharded``) on the CPU, against
``loam_tpu.parallel`` on the conftest's 8 virtual devices and against the
port's own single-device path, at ``test_parallel.py``'s sizes (8x128 scans,
8-10 frames).

The port's mesh here is ``make_mesh(["cpu"] * 8)``: one process, eight
shards on the CPU, the twin of the JAX tests' eight host devices.

Tolerances. Extraction, the sharded kNN, the map shards and ``dropped`` are
exact (the same operations on the same inputs). The sharded registration in
float64 has index-exact matches and counts and poses within
``test_torch_registration.py``'s 1e-4 m / 1e-5 rad of ``loam_tpu``'s;
against the port's single-device registration it is bit-equal (the merged
neighbour lists equal the single search's, and the fits and solve are the
same code). Scan-to-map and offline odometry in float32 agree with
``loam_tpu`` within the ICF convergence thresholds, 1e-2 m / 1e-3 rad, with
equal keyframe decisions (``test_torch_odometry.py``, F6). The sharded
scan-to-map step sorts its source by azimuth, as ``loam_tpu``'s sharded step
does, where both packages' single-device steps sort by Morton key; the
order moves the pose within the ICF's thresholds (mm and mrad at these
sizes). So each step is held to its own twin, frame by frame, translation
and rotation: the port's sharded step at most 1.5x as far from
``loam_tpu``'s sharded step as the port's single-device step is from
``loam_tpu``'s single-device step, plus 1e-6 m / 1e-6 rad (``F15_RATIO``,
``F15_FLOOR``), keyframe decisions and terminations equal; the port's
sharded-vs-single gap at most 1.5x ``loam_tpu``'s own plus the same floor;
and the port's sharded step within 1e-5 of its single-device step fed the
same azimuth-sorted features (``scan_to_map_step_features``: the same
neighbours; equidistant map points may come in another order). Offline
odometry against the port's single-device run: within 1e-5 m with equal
terminations (each shard registers its pairs in one lockstep batch where
the single run takes a pair at a time: sums over other shapes). The pose
graph in float64: within 1e-8 of both (``test_torch_pose_graph.py``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import loam_tpu as J
import loam_tpu.parallel as jpar
from loam_tpu.io import render_trajectory
from loam_tpu.odometry import scan_to_map as j_s2m
from loam_tpu.ops.knn_pallas import knn_pallas as j_knn_pallas
from loam_tpu.parallel import distributed as jdist
from loam_tpu.pose_graph import optimize_pose_graph_sharded as j_opt_sharded

import loam_tpu_torch as T
from loam_tpu_torch import parallel
from loam_tpu_torch.geometry import Pose3
from loam_tpu_torch.io import random_pose_graph
from loam_tpu_torch.neighbors import knn
from loam_tpu_torch.ops import knn_cuda, knn_pallas
from loam_tpu_torch.oracle.compare import pose_gap
from loam_tpu_torch.parallel import distributed as tdist
from loam_tpu_torch.params import from_reference
from loam_tpu_torch.pose_graph import optimize_pose_graph, optimize_pose_graph_sharded
from loam_tpu_torch.registration.icf import _register_impl

torch.set_num_threads(1)

LIDAR = J.LidarParams(8, 128, 0.5, 80.0)
FEAT = J.FeatureExtractionParams(number_sectors=2)
REG = J.RegistrationParams(max_iterations=2, min_associations=10)
S2M_REG = J.RegistrationParams(max_iterations=2, min_associations=10, prior_weight=300.0)
S2M_CFG = dict(edge_capacity=1024, planar_capacity=4096)
POS_TOL, ROT_TOL = 1e-2, 1e-3  # float32 port vs loam_tpu (F6)
F64_POS_TOL, F64_ROT_TOL = 1e-4, 1e-5  # test_torch_registration.py
SINGLE_POS_TOL = 1e-5
# F15: a sharded step's gap to its twin against the single-device steps'
# gap, per frame, translation (m) and rotation (rad)
F15_RATIO, F15_FLOOR = 1.5, 1e-6
GRAPH_TOL = 1e-8


def _t(p):
    return from_reference(p)


def _mesh(line_axis=1):
    return parallel.make_mesh(["cpu"] * 8, line_axis=line_axis)


@pytest.fixture(scope="module")
def scans():
    s, _ = render_trajectory(LIDAR, 10, step=np.array([0.05, 0.0, 0.0]), noise=0.003, seed=5,
                             dtype=np.float32)
    return s


def _gap(a, b):
    """(translation m, rotation rad) between two poses of either package."""
    ref = SimpleNamespace(q=np.asarray(b.rotation, np.float64), t=np.asarray(b.translation, np.float64))
    return pose_gap(np.asarray(a.rotation), np.asarray(a.translation), ref)


def _within(gap, ref, what):
    """F15's rule: ``gap`` at most ``F15_RATIO`` x ``ref`` plus the floor,
    in translation and in rotation."""
    for i, unit in enumerate(("m", "rad")):
        assert gap[i] <= F15_RATIO * ref[i] + F15_FLOOR, f"{what}: {gap[i]:.3e} {unit} against {ref[i]:.3e}"


def _pose_close(t_pose, j_pose, pos_tol, rot_tol):
    np.testing.assert_allclose(t_pose.translation.numpy(), np.asarray(j_pose.translation),
                               atol=pos_tol, rtol=0)
    np.testing.assert_allclose(t_pose.rotation.numpy(), np.asarray(j_pose.rotation),
                               atol=rot_tol, rtol=0)


# ---- the mesh ----------------------------------------------------------------


def test_mesh_layout():
    m = _mesh(2)
    assert m.shape == {"data": 4, "line": 2} and m.size == 8
    assert m.shard_ids == tuple(range(8)) and m.device == torch.device("cpu")
    assert m.group is None and m.rows() == (0, 4)
    assert _mesh().shards_along("data") == (8, tuple(range(8)))
    with pytest.raises(ValueError, match="other mesh axis"):
        m.shards_along("data")


@pytest.mark.parametrize("devices, line_axis, match", [
    (["cpu", "meta"], 1, "share one device"),
    (["cpu"] * 6, 4, "not divisible"),
    ([], 1, "at least one"),
])
def test_make_mesh_rejects(devices, line_axis, match):
    with pytest.raises(ValueError, match=match):
        parallel.make_mesh(devices, line_axis=line_axis)


def test_make_mesh_default_is_the_card():
    """No devices: one shard on this rank's GPU; without one, PyTorch's
    CUDA error, never a CPU mesh (the device rule)."""
    if torch.cuda.is_available():
        assert parallel.make_mesh().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            parallel.make_mesh()


def test_exports_match_loam_tpu():
    assert parallel.__all__ == jpar.__all__
    for name in ("sharded_knn", "register_features_sharded", "sharded_map_insert",
                 "sharded_map_empty", "scan_to_map_init_sharded", "scan_to_map_step_sharded"):
        assert callable(getattr(tdist, name)) and callable(getattr(jdist, name))


# ---- step 0: knn_pallas and the custom_knn hook --------------------------------


def test_knn_pallas_matches_loam_tpu():
    rng = np.random.default_rng(4)
    q = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    t = rng.uniform(-3, 3, (700, 3)).astype(np.float32)
    m = rng.random(700) > 0.2
    for k, r in ((5, 1.0), (1, 0.0), (12, 2.0)):
        want = j_knn_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(m), k, r, tq=256, tt=512)
        got = knn_pallas(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(m), k, r)
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got.indices.numpy()[got.mask.numpy()],
                                      np.asarray(want[0])[np.asarray(want[2])])
        np.testing.assert_allclose(got.distances.numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)


def test_custom_knn_hook_bit_equal(scans):
    """The hook bound to the port's own search gives the loop's result bit
    for bit: the hook replaces the search and nothing else."""
    lidar, rp = _t(LIDAR), T.RegistrationParams()
    f = T.extract_features_batch(torch.from_numpy(scans[:3]), lidar, _t(FEAT),
                                 post=T.registration.azimuth_sort_features)
    src, tgt = f.map(lambda x: x[1:]), f.map(lambda x: x[:-1])
    init = Pose3.identity(torch.float32, (2,))
    e_prep = knn_cuda.knn_prep(tgt.edge_points, tgt.edge_mask)
    p_prep = knn_cuda.knn_prep(tgt.planar_points, tgt.planar_mask)
    calls = []

    def edge(q):
        calls.append("e")
        return knn_cuda.knn_run(e_prep, q, rp.num_edge_neighbors, rp.max_edge_neighbor_dist,
                                with_coords=True, query_mask=src.edge_mask)

    def plane(q):
        return knn_cuda.knn_run(p_prep, q, rp.num_plane_neighbors, rp.max_plane_neighbor_dist,
                                with_coords=True, query_mask=src.planar_mask)

    a = _register_impl(src, tgt, init, rp, True)
    b = _register_impl(src, tgt, init, rp, True, custom_knn=(edge, plane))
    assert calls
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y)


# ---- sharded extraction, pairs and offline odometry ----------------------------


@pytest.mark.parametrize("line_axis", [1, 2])
def test_extract_features_sharded(scans, line_axis):
    x = scans[:8]
    got = parallel.extract_features_sharded(x, _t(LIDAR), _mesh(line_axis), _t(FEAT))
    single = T.extract_features_batch(torch.from_numpy(x), _t(LIDAR), _t(FEAT))
    want = jpar.extract_features_sharded(jnp.asarray(x), LIDAR, jpar.make_mesh(line_axis=line_axis), FEAT)
    for g, s, w in zip(got, single, want):
        assert torch.equal(g, s)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_register_pairs_sharded_equals_batch(scans):
    f = T.extract_features_batch(torch.from_numpy(scans[:9]), _t(LIDAR), _t(FEAT),
                                 post=T.registration.azimuth_sort_features)
    src, tgt = f.map(lambda x: x[1:]), f.map(lambda x: x[:-1])
    init = Pose3.identity(torch.float32, (8,))
    got = parallel.register_pairs_sharded(src, tgt, init, _mesh(), _t(REG))
    want = T.register_features_batch(src, tgt, init, _t(REG))
    for x, y in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert torch.equal(x, y)
    jfs = lambda fs: J.FeatureSet(*(jnp.asarray(x.numpy()) for x in fs))
    jpose, jdet = jpar.register_pairs_sharded(jfs(src), jfs(tgt), J.Pose3.identity(jnp.float32, (8,)),
                                              jpar.make_mesh(), REG)
    np.testing.assert_array_equal(got[1].termination.numpy(), np.asarray(jdet.termination))
    _pose_close(got[0], jpose, POS_TOL, ROT_TOL)


@pytest.mark.parametrize("line_axis", [1, 2])
def test_odometry_offline_sharded(scans, line_axis):
    x = scans[:8]
    traj, det = parallel.odometry_offline_sharded(x, _t(LIDAR), _mesh(line_axis), _t(FEAT), _t(REG))
    single, det1 = T.odometry_offline(torch.from_numpy(x), _t(LIDAR), _t(FEAT), _t(REG))
    np.testing.assert_array_equal(det.termination.numpy(), det1.termination.numpy())
    np.testing.assert_array_equal(det.num_iterations.numpy(), det1.num_iterations.numpy())
    np.testing.assert_allclose(traj.translation.numpy(), single.translation.numpy(),
                               atol=SINGLE_POS_TOL, rtol=0)
    jt, _ = jpar.odometry_offline_sharded(jnp.asarray(x), LIDAR, jpar.make_mesh(line_axis=line_axis),
                                          FEAT, REG)
    _pose_close(traj, jt, POS_TOL, ROT_TOL)


def test_indivisible_frames_and_lines_raise(scans):
    with pytest.raises(ValueError, match="frames"):
        parallel.odometry_offline_sharded(scans[:7], _t(LIDAR), _mesh(), _t(FEAT), _t(REG))
    with pytest.raises(ValueError, match="frames"):
        parallel.extract_features_sharded(scans[:6], _t(LIDAR), _mesh(2), _t(FEAT))
    lidar3 = J.LidarParams(6, 128, 0.5, 80.0)
    with pytest.raises(ValueError, match="scan lines"):
        parallel.extract_features_sharded(np.zeros((4, 6, 128, 3), np.float32), _t(lidar3),
                                          parallel.make_mesh(["cpu"] * 4, line_axis=4))


# ---- F17: offline-sharded extracts a block of frames at a time -----------------

F17_FRAMES = 20  # past EXTRACT_BLOCK, and not a multiple of it


@pytest.fixture(scope="module")
def long_scans():
    s, _ = render_trajectory(LIDAR, F17_FRAMES, step=np.array([0.05, 0.0, 0.0]), noise=0.003, seed=5,
                             dtype=np.float32)
    return s


@pytest.mark.parametrize("line_axis", [1, 2])
def test_f17_offline_sharded_extracts_a_block_at_a_time(long_scans, line_axis, monkeypatch):
    """F17: ``odometry_offline_sharded`` extracted a rank's whole block of
    frames in one batch and registered a data row's pairs in one batch, so
    on the card its pool held the extraction's and the ICF loop's
    workspace for every frame. It extracts ``EXTRACT_BLOCK`` frames and
    registers ``EXTRACT_BLOCK`` pairs at a time: on one data row (one shard,
    or two on the line axis), 20 frames reach the extraction as two blocks
    of 16, a block a line block each, and their 20 pairs the registration
    as two batches of 16 (the last blocks repeat the last frame or pair),
    both in the helper and in the sharded call; every frame's features equal the
    one-batch extraction's (line blocks, then the azimuth sort) bit for
    bit. The trajectory stays within 1e-2 m / 1e-3 rad of ``loam_tpu``'s
    sharded twin on the same mesh (F6) with the terminations of
    ``odometry_offline``."""
    from loam_tpu_torch.features.extract import EXTRACT_BLOCK
    from loam_tpu_torch.parallel import sharding
    from loam_tpu_torch.registration import azimuth_sort_features

    assert F17_FRAMES > EXTRACT_BLOCK and F17_FRAMES % EXTRACT_BLOCK
    lidar, feat, reg = _t(LIDAR), _t(FEAT), _t(REG)
    pts = torch.from_numpy(long_scans)
    seen, pairs = [], []
    core, batch = sharding._extract_core, sharding.register_features_batch

    def spy(p, *args, **kwargs):
        seen.append(p.shape[0])
        return core(p, *args, **kwargs)

    def spy_pairs(src, *args, **kwargs):
        pairs.append(src.edge_mask.shape[0])
        return batch(src, *args, **kwargs)

    monkeypatch.setattr(sharding, "_extract_core", spy)
    monkeypatch.setattr(sharding, "register_features_batch", spy_pairs)
    blocked = sharding._extract_rank(pts, lidar, feat, line_axis)
    assert seen == [EXTRACT_BLOCK] * (2 * line_axis), seen
    one = azimuth_sort_features(sharding._extract_lines(pts, lidar, feat, line_axis))
    for a, b in zip(blocked, one):
        assert a.dtype == b.dtype and torch.equal(a, b)
    seen.clear()
    mesh = parallel.make_mesh(["cpu"] * line_axis, line_axis=line_axis)
    assert mesh.shape == {"data": 1, "line": line_axis}
    traj, det = parallel.odometry_offline_sharded(long_scans, lidar, mesh, feat, reg)
    assert seen == [EXTRACT_BLOCK] * (2 * line_axis) and pairs == [EXTRACT_BLOCK] * 2, (seen, pairs)
    _, det1 = T.odometry_offline(pts, lidar, feat, reg)
    np.testing.assert_array_equal(det.termination.numpy(), det1.termination.numpy())
    jt, _ = jpar.odometry_offline_sharded(jnp.asarray(long_scans), LIDAR,
                                          jpar.make_mesh(jax.devices()[:line_axis], line_axis=line_axis), FEAT, REG)
    _pose_close(traj, jt, POS_TOL, ROT_TOL)


# ---- the sharded kNN -------------------------------------------------------------


def _grid_targets():
    """Targets on a 0.5 m grid (many equidistant neighbours), 8 shards of
    24 slots with shards 2 and 5 empty and the rest partly masked."""
    rng = np.random.default_rng(1)
    t = (rng.integers(-4, 5, (192, 3)) * 0.5).astype(np.float32)
    m = rng.random(192) > 0.3
    m[48:72] = False
    m[120:144] = False
    q = (rng.integers(-4, 5, (60, 3)) * 0.5 + rng.choice([0.0, 0.25], (60, 3))).astype(np.float32)
    return q, t, m


@pytest.mark.parametrize("k, r", [(5, 1.0), (3, 0.0), (8, 0.8)])
def test_sharded_knn_index_exact(k, r):
    q, t, m = _grid_targets()
    res, nbr = tdist.sharded_knn(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(m), k, r,
                                 _mesh())
    want = knn(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(m), k, r)
    # the case the merge must order: equal distances from different shards
    d, i = want.distances, want.indices // 24
    assert ((d[:, 1:] == d[:, :-1]) & (i[:, 1:] != i[:, :-1]) & want.mask[:, 1:]).any()
    assert torch.equal(res.mask, want.mask)
    assert torch.equal(res.indices[res.mask], want.indices[want.mask])
    assert torch.equal(res.distances, want.distances)
    assert torch.equal(nbr[res.mask], torch.from_numpy(t)[res.indices[res.mask].long()])
    jres, jnbr = jdist.sharded_knn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(m), k, r, jpar.make_mesh())
    np.testing.assert_array_equal(res.mask.numpy(), np.asarray(jres.mask))
    np.testing.assert_array_equal(res.indices.numpy()[res.mask.numpy()],
                                  np.asarray(jres.indices)[np.asarray(jres.mask)])


def test_sharded_knn_empty_target():
    q, t, _ = _grid_targets()
    res, _ = tdist.sharded_knn(torch.from_numpy(q), torch.from_numpy(t), torch.zeros(192, dtype=torch.bool),
                               5, 1.0, _mesh())
    assert not res.mask.any() and torch.isinf(res.distances).all()


# ---- sharded registration ---------------------------------------------------------


def _planes_scene(dtype):
    """``test_parallel.py``'s synthetic planes and edges, shard-padded."""
    planar = []
    for y in np.arange(2, 5, 0.12):
        for z in np.arange(-1, 1, 0.12):
            planar.append((-3.0, y, z))
            planar.append((y - 3.0, 5.0, z))
    edge = [(-1.0, 4.0, z) for z in np.arange(-1, 2, 0.05)]
    edge += [(2.0, 2.0, z) for z in np.arange(-1, 2, 0.05)]
    edge, planar = np.asarray(edge), np.asarray(planar)
    e_cap, p_cap = -(-len(edge) // 8) * 8, -(-len(planar) // 8) * 8
    target = J.feature_set_from_points(edge, planar, edge_capacity=e_cap, planar_capacity=p_cap,
                                       dtype=dtype)
    true = J.Pose3(J.quat_from_axis_angle(jnp.asarray([0.2, 0.5, 1.0]) / np.sqrt(1.29), 0.03),
                   jnp.asarray([0.04, -0.02, 0.05]))
    source = J.feature_set_from_points(np.asarray(true.act(jnp.asarray(edge, dtype))),
                                       np.asarray(true.act(jnp.asarray(planar, dtype))),
                                       edge_capacity=e_cap, planar_capacity=p_cap, dtype=dtype)
    return source, target


def test_register_features_sharded():
    js, jt = _planes_scene(jnp.float64)
    params = J.RegistrationParams(min_associations=50)
    src = T.FeatureSet.from_numpy(js, device="cpu")
    tgt = T.FeatureSet.from_numpy(jt, device="cpu")
    init = Pose3.identity(torch.float64)
    pose, det = tdist.register_features_sharded(src, tgt, init, _mesh(), _t(params), with_matches=True)
    single, det1 = T.register_features(src, tgt, init, _t(params))
    for x, y in zip(jax.tree_util.tree_leaves((pose, det)), jax.tree_util.tree_leaves((single, det1))):
        assert torch.equal(x, y)
    jpose, jdet = jdist.register_features_sharded(js, jt, J.Pose3.identity(jnp.float64), jpar.make_mesh(),
                                                  params, with_matches=True)
    assert int(det.termination) == int(jdet.termination)
    assert int(det.num_iterations) == int(jdet.num_iterations)
    for f in ("edge_match", "plane_match", "edge_count", "plane_count"):
        np.testing.assert_array_equal(getattr(det.iteration_info, f).numpy(),
                                      np.asarray(getattr(jdet.iteration_info, f)), err_msg=f)
    _pose_close(pose, jpose, F64_POS_TOL, F64_ROT_TOL)


# ---- the sharded voxel map ------------------------------------------------------


def _occupied(points, mask):
    return set(map(tuple, np.asarray(points)[np.asarray(mask)].round(6).tolist()))


def test_voxel_key_matches_loam_tpu():
    """A voxel's owner shard is its key mod D: the key must be
    ``loam_tpu``'s, int32 max where the point is invalid."""
    from loam_tpu.map.voxel_map import _voxel_key as j_key
    from loam_tpu_torch.map.voxel_map import _voxel_key

    rng = np.random.default_rng(8)
    pts = rng.uniform(-300, 300, (2000, 3)).astype(np.float32)
    valid = rng.random(2000) > 0.2
    jm = J.voxel_map_empty(16, 0.4, origin=(1.0, -2.0, 0.5))
    tm = T.VoxelMap.from_numpy(jm, device="cpu")
    got = _voxel_key(tm, torch.from_numpy(pts), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_key(jm, jnp.asarray(pts), jnp.asarray(valid))))
    assert (got[~torch.from_numpy(valid)] == torch.iinfo(torch.int32).max).all()


def test_sharded_map_insert_matches_loam_tpu():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    mask = rng.random(500) > 0.1
    center = np.array([1.0, -2.0, 0.5], np.float32)
    for cap, radius in ((256, 0.0), (40, 9.0)):  # roomy; then tight, with eviction
        jmesh = jpar.make_mesh()
        jm, jd = jax.jit(lambda m, p, k, c: jdist.sharded_map_insert(m, p, k, jmesh, c, radius))(
            jdist.sharded_map_empty(cap, 0.5, jmesh), jnp.asarray(pts), jnp.asarray(mask),
            jnp.asarray(center))
        tm = tdist.sharded_map_empty(cap, 0.5, _mesh())
        tm, td = tdist.sharded_map_insert(tm, torch.from_numpy(pts), torch.from_numpy(mask), _mesh(),
                                          torch.from_numpy(center), radius)
        assert int(td) == int(jd)
        for s in range(8):
            assert _occupied(tm.points[s], tm.mask[s]) == _occupied(jm.points[s], jm.mask[s])
            np.testing.assert_array_equal(tm.points[s].numpy(), np.asarray(jm.points[s]))
    # roomy: the shards together hold the single map's voxels
    single, _ = T.voxel_map_insert(T.voxel_map_empty(2048, 0.5, device="cpu"), torch.from_numpy(pts),
                                   torch.from_numpy(mask))
    tm, td = tdist.sharded_map_insert(tdist.sharded_map_empty(256, 0.5, _mesh()), torch.from_numpy(pts),
                                      torch.from_numpy(mask), _mesh())
    assert int(td) == 0
    assert _occupied(tm.points.reshape(-1, 3), tm.mask.reshape(-1)) == _occupied(single.points, single.mask)


def test_indivisible_capacities_and_edges_raise():
    with pytest.raises(ValueError, match="capacities"):
        tdist.scan_to_map_init_sharded(T.ScanToMapConfig(edge_capacity=1020, planar_capacity=4096), _mesh())
    gt, init, edges = random_pose_graph(10, 2, seed=0)  # 11 edges over 8 shards
    with pytest.raises(ValueError, match="edges"):
        optimize_pose_graph_sharded(init, edges, _mesh())


# ---- sharded scan-to-map ---------------------------------------------------------


def _state_numpy(state):
    """A port state as the numpy leaves ``loam_tpu``'s state takes."""
    m = lambda v: J.VoxelMap(*(jnp.asarray(x.numpy()) for x in v))
    p = lambda x: J.Pose3(jnp.asarray(x.rotation.numpy()), jnp.asarray(x.translation.numpy()))
    return j_s2m.ScanToMapState(m(state.edge_map), m(state.planar_map), p(state.world_T_current),
                                p(state.prev_delta), p(state.world_T_keyframe),
                                jnp.asarray(state.frames_since_insert.numpy()))


def test_scan_to_map_step_sharded(scans):
    """Against ``loam_tpu``'s sharded step and the port's single-device
    step over 9 frames (F15's rule, module docstring); then the state
    across: ``loam_tpu``'s sharded state loads into the port's and the
    port's into ``loam_tpu``'s, leaf for leaf, and the 10th frame from each
    converted state agrees."""
    cfg, jcfg = T.ScanToMapConfig(**S2M_CFG), j_s2m.ScanToMapConfig(**S2M_CFG)
    mesh, jmesh = _mesh(), jpar.make_mesh()
    lidar, feat, reg = _t(LIDAR), _t(FEAT), _t(S2M_REG)
    sh = tdist.scan_to_map_init_sharded(cfg, mesh)
    assert sh.edge_map.points.shape == (8, 128, 3) and sh.planar_map.mask.shape == (8, 512)
    one = T.scan_to_map_init(cfg, device="cpu")
    jsh = jdist.scan_to_map_init_sharded(jcfg, jmesh)
    jone = J.scan_to_map_init(jcfg)
    for f in range(scans.shape[0] - 1):
        x = torch.from_numpy(scans[f])
        sh, pose, det = tdist.scan_to_map_step_sharded(sh, x, lidar, mesh, feat, reg, cfg)
        one, pose1, _ = T.scan_to_map_step(one, x, lidar, feat, reg, cfg)
        jsh, jpose, jdet = jdist.scan_to_map_step_sharded(jsh, jnp.asarray(scans[f]), LIDAR, jmesh,
                                                          feat_params=FEAT, reg_params=S2M_REG, config=jcfg)
        jone, jpose1, _ = J.scan_to_map_step(jone, jnp.asarray(scans[f]), LIDAR, feat_params=FEAT,
                                             reg_params=S2M_REG, config=jcfg)
        fsi = {int(s.frames_since_insert) for s in (sh, one, jsh, jone)}
        assert len(fsi) == 1, (f, fsi)
        assert int(det.termination) == int(jdet.termination), f
        # the port's sharded-vs-single gap, as loam_tpu's own
        _within(_gap(pose, pose1), _gap(jpose, jpose1), f"frame {f} sharded vs single")
        # F15: the sharded step follows loam_tpu's sharded step
        _within(_gap(pose, jpose), _gap(pose1, jpose1), f"frame {f} sharded vs loam_tpu's sharded")
    assert int(sh.dropped) == 0
    n_sh = int(sh.edge_map.mask.sum()) + int(sh.planar_map.mask.sum())
    n_j = int(jsh.edge_map.mask.sum()) + int(jsh.planar_map.mask.sum())
    n_1 = int(one.edge_map.size) + int(one.planar_map.size)
    assert abs(n_sh - n_j) <= max(5, n_j // 100) and abs(n_sh - n_1) <= max(5, n_1 // 100)

    # the state across, both ways: loam_tpu's (D, C, ...) leaves into the
    # port's sharded state, and the port's out as loam_tpu's
    back = T.ScanToMapState.from_numpy(jsh, mesh=mesh)
    assert back.edge_map.points.shape == sh.edge_map.points.shape
    for name in ("edge_map", "planar_map"):
        for a, b in zip(getattr(back, name), getattr(jsh, name)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    there = T.ScanToMapState.from_numpy(_state_numpy(sh), mesh=mesh)
    for a, b in zip(jax.tree_util.tree_leaves(there[:6]), jax.tree_util.tree_leaves(sh[:6])):
        assert torch.equal(a, b)
    # the last frame from each side's converted state
    nxt = scans[-1]
    s1, p1, _ = tdist.scan_to_map_step_sharded(back, torch.from_numpy(nxt), lidar, mesh, feat, reg, cfg)
    j1, jp1, _ = jdist.scan_to_map_step_sharded(_state_numpy(sh), jnp.asarray(nxt), LIDAR, jmesh,
                                                feat_params=FEAT, reg_params=S2M_REG, config=jcfg)
    assert int(s1.frames_since_insert) == int(j1.frames_since_insert)
    _pose_close(p1, jp1, POS_TOL, ROT_TOL)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_scan_to_map_step_sharded_follows_loam_tpu(scans, dtype):
    """F15: the port's sharded step sorts its source by azimuth, as
    ``loam_tpu``'s sharded step does. Per frame, at most 1.5x as far from
    ``loam_tpu``'s sharded step (translation and rotation) as the port's
    single-device step is from ``loam_tpu``'s, plus 1e-6 m / 1e-6 rad;
    keyframe decisions and terminations equal; within 1e-5 of the
    port's single-device step fed the same azimuth-sorted features."""
    cfg, jcfg = T.ScanToMapConfig(**S2M_CFG), j_s2m.ScanToMapConfig(**S2M_CFG)
    mesh, jmesh = _mesh(), jpar.make_mesh()
    lidar, feat, reg = _t(LIDAR), _t(FEAT), _t(S2M_REG)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    frames = scans[:-1].astype(dtype)
    sh = tdist.scan_to_map_init_sharded(cfg, mesh, dtype=tdt)
    one = T.scan_to_map_init(cfg, dtype=tdt, device="cpu")
    az = T.scan_to_map_init(cfg, dtype=tdt, device="cpu")
    jsh = jdist.scan_to_map_init_sharded(jcfg, jmesh, dtype=jdt)
    jone = J.scan_to_map_init(jcfg, dtype=jdt)
    for f, scan in enumerate(frames):
        x = torch.from_numpy(scan)
        sh, pose, det = tdist.scan_to_map_step_sharded(sh, x, lidar, mesh, feat, reg, cfg)
        one, pose1, det1 = T.scan_to_map_step(one, x, lidar, feat, reg, cfg)
        feats = T.registration.azimuth_sort_features(T.extract_features(x, lidar, feat))
        az, pose_az, _ = T.scan_to_map_step_features(az, feats, reg, cfg)
        jsh, jpose, jdet = jdist.scan_to_map_step_sharded(jsh, jnp.asarray(scan), LIDAR, jmesh,
                                                          feat_params=FEAT, reg_params=S2M_REG, config=jcfg)
        jone, jpose1, jdet1 = J.scan_to_map_step(jone, jnp.asarray(scan), LIDAR, feat_params=FEAT,
                                                 reg_params=S2M_REG, config=jcfg)
        assert pose.translation.dtype == tdt and jpose.translation.dtype == jdt
        fsi = [int(s.frames_since_insert) for s in (sh, jsh, one, jone, az)]
        assert len(set(fsi)) == 1, (f, fsi)
        assert int(det.termination) == int(jdet.termination), f
        assert int(det1.termination) == int(jdet1.termination), f
        _within(_gap(pose, jpose), _gap(pose1, jpose1), f"frame {f} sharded vs loam_tpu's sharded")
        for a, b in ((pose.translation, pose_az.translation), (pose.rotation, pose_az.rotation)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=SINGLE_POS_TOL, rtol=0)
    assert int(sh.dropped) == 0


def test_from_numpy_needs_the_mesh_shard_count():
    """A sharded state of 8 shards loads onto a mesh of 8, each rank its
    own rows, and is refused by a mesh of 4."""
    cfg = T.ScanToMapConfig(**S2M_CFG)
    state = _state_numpy(tdist.scan_to_map_init_sharded(cfg, _mesh()))
    assert T.ScanToMapState.from_numpy(state, mesh=_mesh()).edge_map.mask.shape == (8, 128)
    with pytest.raises(ValueError, match="8 shards, the mesh 4"):
        T.ScanToMapState.from_numpy(state, mesh=parallel.make_mesh(["cpu"] * 4))


# ---- the distributed pose graph ----------------------------------------------------


def test_optimize_pose_graph_sharded():
    gt, init, edges = random_pose_graph(60, 5, seed=3)  # 64 edges over 8 shards
    assert edges.i.shape[0] % 8 == 0
    # mask a few edges: a masked edge adds nothing wherever it lands
    edges = edges._replace(mask=edges.mask.clone())
    edges.mask[[3, 40]] = False
    got, cost = optimize_pose_graph_sharded(init, edges, _mesh(), iterations=5)
    single, cost1 = optimize_pose_graph(init, edges, iterations=5)
    np.testing.assert_allclose(got.translation.numpy(), single.translation.numpy(), atol=GRAPH_TOL, rtol=0)
    np.testing.assert_allclose(got.rotation.numpy(), single.rotation.numpy(), atol=GRAPH_TOL, rtol=0)
    np.testing.assert_allclose(float(cost), float(cost1), rtol=1e-8, atol=1e-20)
    jp = lambda p: J.Pose3(jnp.asarray(p.rotation.numpy()), jnp.asarray(p.translation.numpy()))
    from loam_tpu.pose_graph import PoseGraphEdges as JEdges
    jedges = JEdges(jnp.asarray(edges.i.numpy()), jnp.asarray(edges.j.numpy()), jp(edges.measurement),
                    jnp.asarray(edges.weight.numpy()), jnp.asarray(edges.mask.numpy()))
    jmesh = jpar.make_mesh()
    jgot, jcost = jax.jit(lambda i, e: j_opt_sharded(i, e, jmesh, iterations=5))(jp(init), jedges)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(jgot.translation), atol=GRAPH_TOL, rtol=0)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(jgot.rotation), atol=GRAPH_TOL, rtol=0)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-8, atol=1e-20)
