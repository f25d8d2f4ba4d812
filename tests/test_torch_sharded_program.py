"""The sharded drivers as one program each (``parallel/``, ``program.py``)
on the CPU, at 16x360 over 4 frames, maps of 2,048 / 8,192 slots on a mesh
of 4 CPU shards (``make_mesh(["cpu"] * 4)``), against ``loam_tpu``'s twins
on 4 of the conftest's virtual devices.

On the card each call of ``scan_to_map_step_sharded``,
``register_features_sharded``, ``odometry_offline_sharded``,
``extract_features_sharded`` and ``register_pairs_sharded`` is one CUDA
graph with the gathers inside (held against ``program.eager()`` by
``test_torch_cuda.py -k sharded_program`` and ``chip_smoke.py`` phase 15).
What the CPU shows: each call goes through one cached program of its own
path (the registration inline in the scan-to-map frame), bit-equal to the
same call under ``program.eager()`` and to the step functions it composes;
the keyframe insert goes through ``program.when``, never through a host
read of its flag; a program made on one process group is never run after
that group is destroyed.

Tolerances, those of ``tests/test_torch_parallel.py``. Extraction and the
pair registration's terminations are exact. The sharded registration in
float64 has index-exact matches and counts and poses within 1e-4 m / 1e-5
rad of ``loam_tpu``'s. Offline odometry and the pairs in float32: 1e-2 m /
1e-3 rad (F6). Scan-to-map (F15): keyframe decisions and terminations equal;
per frame, translation and rotation, the port's sharded step at most 1.5x
as far from ``loam_tpu``'s sharded step as the port's single-device step is
from ``loam_tpu``'s, and from the port's single-device step at most 1.5x
``loam_tpu``'s own sharded-vs-single gap, each plus 1e-6 m / 1e-6 rad (both
sharded steps sort their source by azimuth, both single-device steps by
Morton key). The port against itself: bit for bit.
"""

import socket

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import loam_tpu as J
import loam_tpu.parallel as jpar
from loam_tpu.io import render_trajectory
from loam_tpu.odometry import scan_to_map as j_s2m
from loam_tpu.parallel import distributed as jdist

import loam_tpu_torch as T
from loam_tpu_torch import parallel, program
from loam_tpu_torch.geometry import Pose3, norm, quat_conjugate, quat_multiply
from loam_tpu_torch.odometry.offline import compose_trajectory
from loam_tpu_torch.oracle.compare import pose_gap
from loam_tpu_torch.params import from_reference
from loam_tpu_torch.parallel import distributed as tdist
from loam_tpu_torch.registration import azimuth_sort_features, loop
from loam_tpu_torch.registration.icf import _register_impl

torch.set_num_threads(1)

LIDAR = J.LidarParams(16, 360, 0.5, 80.0)
N_FRAMES = 4
D = 4
FEAT = J.FeatureExtractionParams()
J_CFG = j_s2m.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
S2M_REG = J.RegistrationParams(prior_weight=300.0)
REG = J.RegistrationParams(max_iterations=4, min_associations=10)
POS_TOL, ROT_TOL = 1e-2, 1e-3  # float32 port vs loam_tpu (F6)
F64_POS_TOL, F64_ROT_TOL = 1e-4, 1e-5  # test_torch_registration.py
SINGLE_POS_TOL = 1e-5
# F15: a sharded step's gap to its twin against the single-device steps'
# gap, per frame, translation (m) and rotation (rad)
F15_RATIO, F15_FLOOR = 1.5, 1e-6
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scans():
    s, _ = render_trajectory(LIDAR, N_FRAMES, step=np.array([0.2, 0.05, 0.0]), yaw_rate=0.02,
                             noise=0.003, seed=11, dtype=np.float32)
    return s


def _mesh(line_axis=1):
    return parallel.make_mesh(["cpu"] * D, line_axis=line_axis)


def _jmesh(line_axis=1):
    return jpar.make_mesh(jax.devices()[:D], line_axis=line_axis)


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for part in tree for x in _leaves(part)]
    return []


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) > 0 and all(x.dtype == y.dtype and torch.equal(x, y)
                                          for x, y in zip(la, lb))


def _paths() -> list:
    return [p.info["path"] for p in loop._cache.get(CPU, {}).values()]


def _gap(a, b):
    """(translation m, rotation rad) between two poses of either package."""
    ref = SimpleNamespace(q=np.asarray(b.rotation, np.float64), t=np.asarray(b.translation, np.float64))
    return pose_gap(np.asarray(a.rotation), np.asarray(a.translation), ref)


def _within(gap, ref, what):
    """F15's rule: ``gap`` at most ``F15_RATIO`` x ``ref`` plus the floor,
    in translation and in rotation."""
    for i, unit in enumerate(("m", "rad")):
        assert gap[i] <= F15_RATIO * ref[i] + F15_FLOOR, f"{what}: {gap[i]:.3e} {unit} against {ref[i]:.3e}"


def _composed_step(state, scan, lidar, mesh, feat, reg, cfg):
    """The sharded scan-to-map step composed eagerly from its steps, with a
    host branch on the keyframe flag (the step before it was one program)."""
    feats = azimuth_sort_features(T.extract_features(scan, lidar, feat))
    init = state.world_T_current.compose(state.prev_delta)
    em, pm = state.edge_map, state.planar_map
    none = lambda n: torch.full((n,), -1, dtype=torch.int32)
    target = T.FeatureSet(em.points.reshape(-1, 3), em.mask.reshape(-1), none(em.mask.numel()),
                          pm.points.reshape(-1, 3), pm.mask.reshape(-1), none(pm.mask.numel()))
    pose, det = tdist.register_features_sharded(feats, target, init, mesh, reg)
    first = state.frames_since_insert < 0
    pose = Pose3(torch.where(first, state.world_T_current.rotation, pose.rotation),
                 torch.where(first, state.world_T_current.translation, pose.translation))
    rel_q = quat_multiply(quat_conjugate(state.world_T_keyframe.rotation), pose.rotation)
    angle = 2.0 * torch.atan2(norm(rel_q[1:]), torch.abs(rel_q[0]))
    dist_ = norm(pose.translation - state.world_T_keyframe.translation)
    insert = first | (dist_ > cfg.keyframe_dist) | (angle > cfg.keyframe_angle)
    dropped = state.dropped
    if bool(insert):
        em, de = tdist.sharded_map_insert(em, pose.act(feats.edge_points), feats.edge_mask, mesh,
                                          pose.translation, cfg.keep_radius)
        pm, dp = tdist.sharded_map_insert(pm, pose.act(feats.planar_points), feats.planar_mask, mesh,
                                          pose.translation, cfg.keep_radius)
        dropped = dropped + de + dp
    new = T.ScanToMapState(
        em, pm, pose.normalize(), state.world_T_current.inverse().compose(pose).normalize(),
        Pose3(torch.where(insert, pose.rotation, state.world_T_keyframe.rotation),
              torch.where(insert, pose.translation, state.world_T_keyframe.translation)),
        torch.where(insert, 0, torch.clamp(state.frames_since_insert, min=0) + 1).to(torch.int32),
        dropped=dropped)
    return new, pose, det


def test_scan_to_map_step_sharded_is_one_program(scans, monkeypatch):
    """Four frames through the step's program: one cached program of path
    ``scan_to_map_sharded`` (the registration inline), bit-equal to the
    calls under ``program.eager()`` and to the step composed eagerly from
    its parts; the keyframe insert through ``program.when`` on the frame's
    keyframe decision, its flag never read on the host outside it; against
    ``loam_tpu``'s sharded and single-device steps and the port's
    single-device step by F15's rule (module docstring), keyframe decisions
    and terminations equal."""
    lidar, feat = from_reference(LIDAR), from_reference(FEAT)
    cfg, reg = from_reference(J_CFG), from_reference(S2M_REG)
    mesh = _mesh()
    preds, outside, inside = [], [], [False]
    real_when, real_bool = program.when, torch.Tensor.__bool__

    def when(pred, body):
        preds.append(pred)
        inside[0] = True
        try:
            return real_when(pred, body)
        finally:
            inside[0] = False

    def spy_bool(self):
        if not inside[0]:
            outside.append(self)
        return real_bool(self)

    loop.clear_cache()
    st = tdist.scan_to_map_init_sharded(cfg, mesh)
    runs = []
    with monkeypatch.context() as m:
        m.setattr(program, "when", when)
        m.setattr(torch.Tensor, "__bool__", spy_bool)
        for f in range(N_FRAMES):
            st, pose, det = tdist.scan_to_map_step_sharded(st, torch.from_numpy(scans[f]), lidar, mesh,
                                                           feat, reg, cfg)
            runs.append((st, pose, det))
    assert _paths() == ["scan_to_map_sharded"]
    fsi = [int(s.frames_since_insert) for s, _, _ in runs]
    assert len(preds) == N_FRAMES and [bool(p) for p in preds] == [x == 0 for x in fsi]
    assert fsi[0] == 0 and not all(x == 0 for x in fsi), fsi
    assert not any(b is p for b in outside for p in preds)

    eager = tdist.scan_to_map_init_sharded(cfg, mesh)
    composed = tdist.scan_to_map_init_sharded(cfg, mesh)
    one = T.scan_to_map_init(cfg, device="cpu")
    jst = jdist.scan_to_map_init_sharded(J_CFG, _jmesh())
    jone = J.scan_to_map_init(J_CFG)
    for f in range(N_FRAMES):
        x = torch.from_numpy(scans[f])
        with program.eager():
            eager, pose_e, det_e = tdist.scan_to_map_step_sharded(eager, x, lidar, mesh, feat, reg, cfg)
        composed, pose_c, det_c = _composed_step(composed, x, lidar, mesh, feat, reg, cfg)
        assert _same(runs[f], (eager, pose_e, det_e)), f
        assert _same(runs[f], (composed, pose_c, det_c)), f
        one, pose1, _ = T.scan_to_map_step(one, x, lidar, feat, reg, cfg)
        jst, jpose, jdet = jdist.scan_to_map_step_sharded(jst, jnp.asarray(scans[f]), LIDAR, _jmesh(),
                                                          reg_params=S2M_REG, config=J_CFG)
        jone, jpose1, _ = J.scan_to_map_step(jone, jnp.asarray(scans[f]), LIDAR, reg_params=S2M_REG,
                                             config=J_CFG)
        pose, det = runs[f][1], runs[f][2]
        assert fsi[f] == int(one.frames_since_insert) == int(jst.frames_since_insert) \
            == int(jone.frames_since_insert), f
        assert int(det.termination) == int(jdet.termination), f
        _within(_gap(pose, pose1), _gap(jpose, jpose1), f"frame {f} sharded vs single")
        _within(_gap(pose, jpose), _gap(pose1, jpose1), f"frame {f} sharded vs loam_tpu's sharded")
    final = runs[-1][0]
    assert int(final.dropped) == 0
    n_sh = int(final.edge_map.mask.sum()) + int(final.planar_map.mask.sum())
    n_j = int(jst.edge_map.mask.sum()) + int(jst.planar_map.mask.sum())
    assert abs(n_sh - n_j) <= max(5, n_j // 100)


def _planes_scene(dtype):
    """``test_torch_parallel.py``'s synthetic planes and edges, padded to a
    multiple of the 4 shards."""
    planar = []
    for y in np.arange(2, 5, 0.12):
        for z in np.arange(-1, 1, 0.12):
            planar.append((-3.0, y, z))
            planar.append((y - 3.0, 5.0, z))
    edge = [(-1.0, 4.0, z) for z in np.arange(-1, 2, 0.05)]
    edge += [(2.0, 2.0, z) for z in np.arange(-1, 2, 0.05)]
    edge, planar = np.asarray(edge), np.asarray(planar)
    e_cap, p_cap = -(-len(edge) // D) * D, -(-len(planar) // D) * D
    target = J.feature_set_from_points(edge, planar, edge_capacity=e_cap, planar_capacity=p_cap,
                                       dtype=dtype)
    true = J.Pose3(J.quat_from_axis_angle(jnp.asarray([0.2, 0.5, 1.0]) / np.sqrt(1.29), 0.03),
                   jnp.asarray([0.04, -0.02, 0.05]))
    source = J.feature_set_from_points(np.asarray(true.act(jnp.asarray(edge, dtype))),
                                       np.asarray(true.act(jnp.asarray(planar, dtype))),
                                       edge_capacity=e_cap, planar_capacity=p_cap, dtype=dtype)
    return source, target


def test_register_features_sharded_is_one_program():
    """The sharded registration in float64 through its program (path
    ``sharded``, its key holding the mesh's token): bit-equal to the call
    under ``program.eager()``, to the loop run eagerly with the same
    sharded search as a ``custom_knn`` (which is not cached) and to the
    single-device registration; matches and counts index-exact with
    ``loam_tpu``'s, poses within 1e-4 m / 1e-5 rad."""
    js, jt = _planes_scene(jnp.float64)
    params = J.RegistrationParams(min_associations=50)
    src = T.FeatureSet.from_numpy(js, device="cpu")
    tgt = T.FeatureSet.from_numpy(jt, device="cpu")
    init = Pose3.identity(torch.float64)
    mesh = _mesh()
    loop.clear_cache()
    got = tdist.register_features_sharded(src, tgt, init, mesh, from_reference(params), with_matches=True)
    (prog,) = loop._cache[CPU].values()
    assert prog.info["path"] == "sharded" and prog.info["mesh"] == mesh.token
    assert any(k[-2:] == (mesh.token, "data") for k in loop._cache[CPU])
    with program.eager():
        eager = tdist.register_features_sharded(src, tgt, init, mesh, from_reference(params),
                                                with_matches=True)
    assert _same(got, eager)
    add = lambda x: x[None]
    b_src, b_tgt = src.map(add), tgt.map(add)
    search = tdist.ShardedSearch(mesh, "data")
    est, det = _register_impl(b_src, b_tgt, Pose3(add(init.rotation), add(init.translation)),
                              from_reference(params), True,
                              custom_knn=search.hooks(b_src, b_tgt, from_reference(params)))
    assert len(loop._cache[CPU]) == 1  # a custom_knn runs eagerly, uncached
    assert _same(got, (Pose3(est.rotation[0], est.translation[0]), jax.tree.map(lambda x: x[0], det)))
    assert _same(got, T.register_features(src, tgt, init, from_reference(params)))
    jpose, jdet = jdist.register_features_sharded(js, jt, J.Pose3.identity(jnp.float64), _jmesh(), params,
                                                  with_matches=True)
    pose, det = got
    assert int(det.termination) == int(jdet.termination)
    assert int(det.num_iterations) == int(jdet.num_iterations)
    for f in ("edge_match", "plane_match", "edge_count", "plane_count"):
        np.testing.assert_array_equal(getattr(det.iteration_info, f).numpy(),
                                      np.asarray(getattr(jdet.iteration_info, f)), err_msg=f)
    np.testing.assert_allclose(pose.translation.numpy(), np.asarray(jpose.translation), atol=F64_POS_TOL,
                               rtol=0)
    np.testing.assert_allclose(pose.rotation.numpy(), np.asarray(jpose.rotation), atol=F64_ROT_TOL, rtol=0)


@pytest.mark.parametrize("line_axis", [1, 2])
def test_odometry_offline_sharded_is_one_program(scans, line_axis):
    """One program for the call (extraction, the halo gather, the batch
    registration and the composition inside), bit-equal to the call under
    ``program.eager()`` and to the composition of its steps (the batched
    extraction, one lockstep batch of the pairs and the last frame against
    itself, ``compose_trajectory``); terminations equal to
    ``odometry_offline``'s, poses within 1e-5 m, and (on the data axis)
    within 1e-2 m / 1e-3 rad of ``loam_tpu``'s sharded run."""
    lidar, feat, reg = from_reference(LIDAR), from_reference(FEAT), from_reference(REG)
    mesh = _mesh(line_axis)
    loop.clear_cache()
    traj, det = parallel.odometry_offline_sharded(scans, lidar, mesh, feat, reg)
    assert _paths() == ["offline_sharded"]
    with program.eager():
        assert _same((traj, det), parallel.odometry_offline_sharded(scans, lidar, mesh, feat, reg))
    f = T.extract_features_batch(torch.from_numpy(scans), lidar, feat, post=azimuth_sort_features)
    frames = f.map(lambda x: torch.cat([x, x[-1:]]))
    rel, details = T.register_features_batch(frames.map(lambda x: x[1:]), frames.map(lambda x: x[:-1]),
                                             Pose3.identity(torch.float32, (N_FRAMES,)), reg,
                                             reorder_mode="none")
    cut = lambda x: x[:N_FRAMES - 1]
    assert _same((traj, det), (compose_trajectory(jax.tree.map(cut, rel)), jax.tree.map(cut, details)))
    single, det1 = T.odometry_offline(torch.from_numpy(scans), lidar, feat, reg)
    np.testing.assert_array_equal(det.termination.numpy(), det1.termination.numpy())
    np.testing.assert_allclose(traj.translation.numpy(), single.translation.numpy(), atol=SINGLE_POS_TOL,
                               rtol=0)
    if line_axis == 2:
        return  # loam_tpu's twin once (a compile each mesh); the line blocks are held above
    jt, _ = jpar.odometry_offline_sharded(jnp.asarray(scans), LIDAR, _jmesh(), reg_params=REG)
    np.testing.assert_allclose(traj.translation.numpy(), np.asarray(jt.translation), atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(traj.rotation.numpy(), np.asarray(jt.rotation), atol=ROT_TOL, rtol=0)


@pytest.mark.parametrize("line_axis", [1, 2])
def test_extract_features_sharded_is_one_program(scans, line_axis):
    """One program a call; bit-equal to the call under ``program.eager()``
    and to ``extract_features_batch``, index-exact with ``loam_tpu``'s."""
    lidar = from_reference(LIDAR)
    mesh = _mesh(line_axis)
    loop.clear_cache()
    got = parallel.extract_features_sharded(scans, lidar, mesh)
    assert _paths() == ["extract_sharded"]
    with program.eager():
        assert _same(got, parallel.extract_features_sharded(scans, lidar, mesh))
    assert _same(got, T.extract_features_batch(torch.from_numpy(scans), lidar))
    want = jpar.extract_features_sharded(jnp.asarray(scans), LIDAR, _jmesh(line_axis))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_register_pairs_sharded_is_one_program(scans):
    """One program a call (the batch registration inline, the blocks
    gathered): bit-equal to the call under ``program.eager()`` and to
    ``register_features_batch``; terminations equal to ``loam_tpu``'s,
    poses within 1e-2 m / 1e-3 rad."""
    lidar, reg = from_reference(LIDAR), from_reference(REG)
    f = T.extract_features_batch(torch.from_numpy(scans), lidar, post=azimuth_sort_features)
    pair = lambda x: torch.cat([x, x[:1]])  # 4 pairs over the 4 shards
    src, tgt = f.map(lambda x: pair(x[1:])), f.map(lambda x: pair(x[:-1]))
    init = Pose3.identity(torch.float32, (D,))
    mesh = _mesh()
    loop.clear_cache()
    got = parallel.register_pairs_sharded(src, tgt, init, mesh, reg)
    assert _paths() == ["pairs_sharded"]
    with program.eager():
        assert _same(got, parallel.register_pairs_sharded(src, tgt, init, mesh, reg))
    assert _same(got, T.register_features_batch(src, tgt, init, reg))
    jfs = lambda fs: J.FeatureSet(*(jnp.asarray(x.numpy()) for x in fs))
    jpose, jdet = jpar.register_pairs_sharded(jfs(src), jfs(tgt), J.Pose3.identity(jnp.float32, (D,)),
                                              _jmesh(), REG)
    np.testing.assert_array_equal(got[1].termination.numpy(), np.asarray(jdet.termination))
    np.testing.assert_allclose(got[0].translation.numpy(), np.asarray(jpose.translation), atol=POS_TOL,
                               rtol=0)
    np.testing.assert_allclose(got[0].rotation.numpy(), np.asarray(jpose.rotation), atol=ROT_TOL, rtol=0)


def _group():
    """A world-size-1 gloo group in this process, on a free local port."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    return dist.group.WORLD


def test_a_program_is_not_run_after_its_group_is_destroyed(scans, monkeypatch):
    """A program made on one process group is never run again once that
    group is destroyed: a call on the old mesh raises before any program
    runs, the new group's mesh (another token) gets a program of its own,
    and ``Mesh.release`` drops a mesh's programs. Over gloo the gathers
    cross the group and the results equal the group-less mesh's."""
    lidar, feat, reg = from_reference(LIDAR), from_reference(FEAT), from_reference(REG)
    ran = []
    real_run = program.Program.run

    def run(self, fn, inputs):
        ran.append(self)
        return real_run(self, fn, inputs)

    monkeypatch.setattr(program.Program, "run", run)
    loop.clear_cache()
    x = scans[:D]
    want = parallel.extract_features_sharded(x, lidar, _mesh(), feat)
    assert dist.is_available() and not dist.is_initialized()
    try:
        mesh_a = parallel.make_mesh(["cpu"] * D, group=_group())
        assert _same(parallel.extract_features_sharded(x, lidar, mesh_a, feat), want)
        prog_a = ran[-1]
        assert prog_a.info["mesh"] == mesh_a.token
        dist.destroy_process_group()
        n_ran = len(ran)
        with pytest.raises(RuntimeError, match="destroyed"):
            parallel.extract_features_sharded(x, lidar, mesh_a, feat)
        with pytest.raises(RuntimeError, match="destroyed"):
            tdist.scan_to_map_step_sharded(tdist.scan_to_map_init_sharded(from_reference(J_CFG), mesh_a),
                                           torch.from_numpy(x[0]), lidar, mesh_a, feat)
        assert len(ran) == n_ran
        mesh_b = parallel.make_mesh(["cpu"] * D, group=_group())
        assert mesh_b.token != mesh_a.token
        assert _same(parallel.extract_features_sharded(x, lidar, mesh_b, feat), want)
        assert ran[-1] is not prog_a and ran[-1].info["mesh"] == mesh_b.token
        tokens = lambda: {p.info.get("mesh") for p in loop._cache[CPU].values()}
        assert mesh_b.token in tokens()
        mesh_b.release()
        assert mesh_b.token not in tokens()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
