"""The grid search and the loop-closed back end as one program each
(``program.py``) on the CPU, against ``loam_tpu``.

On the card a registration through the voxel grid (``search_backend=
"grid"``), each driver call over it, ``optimize_pose_graph``,
``optimize_pose_graph_sharded``, ``propose_candidates`` and
``optimize_trajectory_with_closures`` are one CUDA graph each: the grid's
searches inside the ICF loop's WHILE node, the LM iterations a
``program.scan`` (held against ``program.eager()`` by ``test_torch_cuda.py
-k last_programs`` and ``chip_smoke.py`` phase 15). What the CPU shows: each
call goes through one cached program of its own path, with nothing of it
read on the host (``Tensor.__bool__``, ``.item()`` and ``.tolist()`` raise
inside a program; the WHILE and IF nodes' flags are read by the nodes' host
twins); ``program.while_loop``, ``program.scan`` and ``program.when`` are
reached as many times as the path has nodes; the result is bit-equal to the
same call under ``program.eager()`` and to the pieces it composes; the LM
scan's operations do not depend on ``iterations``.

Sizes: 16x360 scans, maps of 2,048 / 8,192 slots, a 50-node graph with 5
closures, the 13 keyframes of a small closed square. Tolerances, those of
the files named. Grid registration and grid scan-to-map in float64 against
``loam_tpu``: index-exact matches, overflow counts, terminations and
iteration counts equal, poses within 1e-4 m / 1e-4 rad
(``test_torch_grid.py``); against the port's brute force at overflow 0: 1e-12.
The pose graph in float64: poses within 1e-8, cost within rtol 1e-8
(``test_torch_pose_graph.py``); the sharded solve within 1e-8 of the single
one. The loop-closed call in float64: closures index-exact, poses within
1e-4 m / 1e-4 rad of ``loam_tpu``'s chain. The port against itself: bit for
bit.
"""

import contextlib
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import loam_tpu as J
import loam_tpu.loop_closure as jlc
import loam_tpu.pose_graph as jpg
from loam_tpu.geometry import quat_exp as j_quat_exp
from loam_tpu.io import default_world, render_scan, render_trajectory
from loam_tpu.odometry import scan_to_map as j_s2m

import loam_tpu_torch as T
import loam_tpu_torch.loop_closure as tlc
from loam_tpu_torch import parallel, program
from loam_tpu_torch.io import random_pose_graph
from loam_tpu_torch.params import from_reference
from loam_tpu_torch.pose_graph import odometry_edges, optimize_pose_graph, optimize_pose_graph_sharded
from loam_tpu_torch.registration import loop

torch.set_num_threads(1)

LIDAR = J.LidarParams(16, 360, 0.5, 80.0)
N_FRAMES = 4
J_CFG = j_s2m.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
J_GRID = J.RegistrationParams(search_backend="grid", prior_weight=300.0)
POS_TOL = ROT_TOL = 1e-4  # float64 registration vs loam_tpu (test_torch_grid.py)
SAME_TOL = 1e-12  # grid vs brute force at overflow 0 (test_torch_grid.py)
POSE_TOL, COST_RTOL = 1e-8, 1e-8  # test_torch_pose_graph.py
CPU = torch.device("cpu")


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


@contextlib.contextmanager
def _watched(monkeypatch):
    """Inside: ``Tensor.__bool__``, ``.item()`` and ``.tolist()`` raise while
    a program runs; ``program.while_loop`` and ``program.when`` run as their
    nodes run on the host (the flag read by the node, not by the program);
    yields the number of calls of each, and of ``program.scan``."""
    calls = {"while_loop": 0, "when": 0, "scan": 0}
    real = {name: getattr(torch.Tensor, name) for name in ("__bool__", "item", "tolist")}
    real_scan = program.scan

    def guard(name):
        def read(self, *args, **kwargs):
            if program.nested():
                raise AssertionError(f"Tensor.{name} inside a program")
            return real[name](self, *args, **kwargs)
        return read

    def while_loop(flag, body):
        calls["while_loop"] += 1
        while real["__bool__"](flag):
            body()

    def when(pred, body):
        calls["when"] += 1
        if real["__bool__"](pred):
            body()
            return True
        return False

    def scan(n, body, device):
        calls["scan"] += 1
        return real_scan(n, body, device)

    with monkeypatch.context() as m:
        for name in real:
            m.setattr(torch.Tensor, name, guard(name))
        m.setattr(program, "while_loop", while_loop)
        m.setattr(program, "when", when)
        m.setattr(program, "scan", scan)
        yield calls


# ---- the grid search inside the registration's program ---------------------------

@pytest.fixture(scope="module")
def scans():
    s, poses = render_trajectory(LIDAR, N_FRAMES, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float32)
    return s.astype(np.float64), np.stack([t for (_, t) in poses])


@pytest.fixture(scope="module")
def pairs(scans):
    """Float64 features of the frames from ``loam_tpu``, azimuth-sorted, in
    both packages: [(jax source, jax target, port source, port target)]."""
    from loam_tpu.features import extract_features_batch as j_batch
    from loam_tpu.registration.icf import azimuth_sort_features as j_azimuth

    fs = [np.asarray(x) for x in j_batch(jnp.asarray(scans[0][:3]), LIDAR, J.FeatureExtractionParams(),
                                         post=j_azimuth)]
    out = []
    for i in range(2):
        js = J.FeatureSet(*(jnp.asarray(x[i + 1]) for x in fs))
        jt = J.FeatureSet(*(jnp.asarray(x[i]) for x in fs))
        out.append((js, jt, T.FeatureSet.from_numpy(js, dtype=torch.float64, device="cpu"),
                    T.FeatureSet.from_numpy(jt, dtype=torch.float64, device="cpu")))
    return out


@pytest.mark.parametrize("pair,cap", [(0, 64), (1, 3)], ids=["pair0", "pair1_cap3"])
def test_grid_registration_is_one_program(pairs, monkeypatch, pair, cap):
    """A grid registration: one cached program of path ``grid`` (both grids
    built inside it, before the loop), its later iterations one
    ``while_loop``, nothing read on the host inside; bit-equal under
    ``program.eager()``; ``loam_tpu``'s matches, overflow counts,
    termination and iterations, and its pose within 1e-4."""
    js, jt, ts, tt = pairs[pair]
    rp = J.RegistrationParams(search_backend="grid", grid_max_per_cell=cap)
    loop.clear_cache()
    with _watched(monkeypatch) as calls:
        got = T.register_features(ts, tt, params=from_reference(rp))
        again = T.register_features(ts, tt, params=from_reference(rp))
    assert _paths() == ["grid"]
    (key,) = loop._cache[CPU]
    assert key[:2] == ("registration", "grid")
    assert calls == {"while_loop": 2, "when": 0, "scan": 0}
    with program.eager():
        eager = T.register_features(ts, tt, params=from_reference(rp))
    assert _same(got, again) and _same(got, eager)

    pj, dj = J.register_features(js, jt, params=rp)
    pt, dt = got
    np.testing.assert_allclose(pt.rotation.numpy(), np.asarray(pj.rotation), atol=ROT_TOL, rtol=0)
    np.testing.assert_allclose(pt.translation.numpy(), np.asarray(pj.translation), atol=POS_TOL, rtol=0)
    assert int(dt.termination) == int(dj.termination)
    n = int(dj.num_iterations)
    assert int(dt.num_iterations) == n
    ij, it = dj.iteration_info, dt.iteration_info
    for name in ("edge_knn_overflow", "plane_knn_overflow", "edge_count", "plane_count"):
        np.testing.assert_array_equal(getattr(it, name).numpy(), np.asarray(getattr(ij, name)), err_msg=name)
    np.testing.assert_array_equal(it.edge_match.numpy()[:n], np.asarray(ij.edge_match)[:n])
    np.testing.assert_array_equal(it.plane_match.numpy()[:n], np.asarray(ij.plane_match)[:n])
    # the planar points near the sensor crowd their 2 m cells past either cap
    assert int(it.edge_knn_overflow.sum() + it.plane_knn_overflow.sum()) > 0


def test_grid_registration_program_equals_bruteforce(pairs, monkeypatch):
    """At overflow 0 the grid program's registration is the brute-force
    program's, within 1e-12, with the same matches."""
    _, _, ts, tt = pairs[0]
    radii = dict(max_edge_neighbor_dist=0.5, max_plane_neighbor_dist=0.5)
    loop.clear_cache()
    with _watched(monkeypatch):
        pg, dg = T.register_features(ts, tt, params=T.RegistrationParams(search_backend="grid", **radii))
    pb, db = T.register_features(ts, tt, params=T.RegistrationParams(search_backend="bruteforce", **radii))
    assert _paths() == ["grid", "single"]
    info = dg.iteration_info
    assert int(info.edge_knn_overflow.sum() + info.plane_knn_overflow.sum()) == 0
    assert int(dg.termination) == int(db.termination)
    assert int(dg.num_iterations) == int(db.num_iterations)
    assert torch.equal(info.edge_match, db.iteration_info.edge_match)
    assert torch.equal(info.plane_match, db.iteration_info.plane_match)
    np.testing.assert_allclose(pg.translation.numpy(), pb.translation.numpy(), atol=SAME_TOL, rtol=0)
    np.testing.assert_allclose(pg.rotation.numpy(), pb.rotation.numpy(), atol=SAME_TOL, rtol=0)


@pytest.fixture(scope="module")
def jax_grid_s2m(scans):
    """``loam_tpu``'s grid scan-to-map over the frames in float64."""
    state = j_s2m.scan_to_map_init(J_CFG, dtype=jnp.float64)
    _, traj, det = J.scan_to_map_offline(jnp.asarray(scans[0]), LIDAR, reg_params=J_GRID, config=J_CFG,
                                         init_state=state)
    return jax.tree.map(np.asarray, (traj, det))


def test_grid_scan_to_map_is_one_program(scans, jax_grid_s2m, monkeypatch):
    """``scan_to_map_offline`` through the grid: one cached program (the
    extraction, each frame's grids, registration and keyframe insert inline),
    its extraction's blocks one ``scan`` and its frames one, each frame's
    ICF loop one ``while_loop`` and
    its insert one ``when``, nothing read on the host inside; bit-equal
    under ``program.eager()``; ``loam_tpu``'s terminations, iterations and
    overflow counts, poses within 1e-4; the brute-force run's within 1e-12."""
    lidar, cfg, reg = from_reference(LIDAR), from_reference(J_CFG), from_reference(J_GRID)
    x = torch.from_numpy(scans[0])
    state0 = T.scan_to_map_init(cfg, dtype=torch.float64, device="cpu")
    loop.clear_cache()
    with _watched(monkeypatch) as calls:
        got = T.scan_to_map_offline(x, lidar, reg_params=reg, config=cfg, init_state=state0)
    assert _paths() == ["scan_to_map_offline"]
    assert calls == {"while_loop": N_FRAMES, "when": N_FRAMES, "scan": 2}
    with program.eager():
        eager = T.scan_to_map_offline(x, lidar, reg_params=reg, config=cfg, init_state=state0)
    assert _same(got, eager)

    traj, det = jax_grid_s2m
    state, t_traj, t_det = got
    np.testing.assert_allclose(t_traj.translation.numpy(), traj.translation, atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(t_traj.rotation.numpy(), traj.rotation, atol=ROT_TOL, rtol=0)
    np.testing.assert_array_equal(t_det.termination.numpy(), det.termination)
    np.testing.assert_array_equal(t_det.num_iterations.numpy(), det.num_iterations)
    for name in ("edge_knn_overflow", "plane_knn_overflow", "edge_count", "plane_count"):
        np.testing.assert_array_equal(getattr(t_det.iteration_info, name).numpy(),
                                      getattr(det.iteration_info, name), err_msg=name)
    assert not t_det.iteration_info.edge_knn_overflow.any() and int(state.dropped) == 0
    assert t_det.termination[1:].eq(T.TerminationType.CONVERGED).any()

    _, b_traj, b_det = T.scan_to_map_offline(x, lidar, reg_params=T.default_map_reg_params(), config=cfg,
                                             init_state=state0)
    assert torch.equal(t_det.termination, b_det.termination)
    np.testing.assert_allclose(t_traj.translation.numpy(), b_traj.translation.numpy(), atol=SAME_TOL, rtol=0)
    np.testing.assert_allclose(t_traj.rotation.numpy(), b_traj.rotation.numpy(), atol=SAME_TOL, rtol=0)


# ---- the pose graph ---------------------------------------------------------------

@pytest.fixture(scope="module")
def graph():
    """A chain of 50 float64 nodes and 5 closures, started off the truth."""
    return random_pose_graph(50, 5, seed=3)


def _j_edges(edges):
    m = edges.measurement
    return jpg.make_edges(jnp.asarray(edges.i.numpy()), jnp.asarray(edges.j.numpy()),
                          J.Pose3(jnp.asarray(m.rotation.numpy()), jnp.asarray(m.translation.numpy())))


@pytest.mark.parametrize("iterations", [3, 12])
def test_pose_graph_is_one_program(graph, monkeypatch, iterations):
    """``optimize_pose_graph``: one cached program of path ``pose_graph``
    (one a signature and ``iterations``), the LM iterations one ``scan``,
    nothing read on the host inside; bit-equal under ``program.eager()``;
    ``loam_tpu``'s poses within 1e-8 and cost within rtol 1e-8."""
    gt, init, edges = graph
    loop.clear_cache()
    with _watched(monkeypatch) as calls:
        got = optimize_pose_graph(init, edges, iterations)
        again = optimize_pose_graph(init, edges, iterations)
    assert _paths() == ["pose_graph"] and calls == {"while_loop": 0, "when": 0, "scan": 2}
    with program.eager():
        eager = optimize_pose_graph(init, edges, iterations)
    assert _same(got, again) and _same(got, eager)
    optimize_pose_graph(init.__class__(init.rotation.float(), init.translation.float()), edges, iterations)
    assert _paths() == ["pose_graph", "pose_graph"]

    j_init = J.Pose3(jnp.asarray(init.rotation.numpy()), jnp.asarray(init.translation.numpy()))
    jo, jc = jpg.optimize_pose_graph(j_init, _j_edges(edges), iterations=iterations)
    to, tc = got
    np.testing.assert_allclose(to.translation.numpy(), np.asarray(jo.translation), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(to.rotation.numpy(), np.asarray(jo.rotation), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(float(tc), float(jc), rtol=COST_RTOL, atol=1e-20)
    if iterations == 12:
        assert float((to.translation - gt.translation).abs().max()) < 1e-5


def _traced_ops(init, edges, iterations, monkeypatch):
    """The aten operations of a solve: those around the LM scan, and those of
    each run of its body."""
    from torch.utils._python_dispatch import TorchDispatchMode

    log = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            log.append(str(func))
            return func(*args, **(kwargs or {}))

    real_scan = program.scan
    starts, ends = [], []

    def scan(n, body, device):
        def marked(i):
            starts.append(len(log))
            return body(i)
        out = real_scan(n, marked, device)
        ends.append(len(log))
        return out

    loop.clear_cache()
    with monkeypatch.context() as m, Ops():
        m.setattr(program, "scan", scan)
        optimize_pose_graph(init, edges, iterations)
    # a run of the node's body: the scan's body and the scan's own counter
    bodies = [log[a:b] for a, b in zip(starts, starts[1:] + ends)]
    return log[:starts[0]] + log[ends[0]:], bodies


def test_pose_graph_scan_does_not_depend_on_iterations(graph, monkeypatch):
    """The LM scan at 3 and at 12 iterations: the same operations around it,
    and every run of its body the same operations -- the one body a WHILE
    node holds, whatever ``iterations`` is."""
    _, init, edges = graph
    outer3, bodies3 = _traced_ops(init, edges, 3, monkeypatch)
    outer12, bodies12 = _traced_ops(init, edges, 12, monkeypatch)
    assert len(bodies3) == 3 and len(bodies12) == 12
    assert outer3 == outer12 and len(outer3) > 0
    assert all(b == bodies3[0] for b in bodies3 + bodies12) and len(bodies3[0]) > 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pose_graph_sharded_is_one_program(graph, monkeypatch):
    """``optimize_pose_graph_sharded`` on a gloo world-size-1 mesh of 2
    shards: one cached program of path ``pose_graph_sharded`` (keyed on the
    mesh's token), the LM iterations one ``scan``, nothing read on the host
    inside; bit-equal under ``program.eager()``; the single solve within
    1e-8."""
    _, init, edges = graph
    assert edges.i.shape[0] % 2 == 0
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh(["cpu"] * 2, group=dist.group.WORLD)
        loop.clear_cache()
        with _watched(monkeypatch) as calls:
            got = optimize_pose_graph_sharded(init, edges, mesh, 10)
            again = optimize_pose_graph_sharded(init, edges, mesh, 10)
        assert _paths() == ["pose_graph_sharded"] and calls["scan"] == 2
        assert loop._cache[CPU][next(iter(loop._cache[CPU]))].info["mesh"] == mesh.token
        with program.eager():
            eager = optimize_pose_graph_sharded(init, edges, mesh, 10)
        assert _same(got, again) and _same(got, eager)
        single = optimize_pose_graph(init, edges, 10)
        for a, b in zip(_leaves(got), _leaves(single)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=POSE_TOL, rtol=COST_RTOL)
        mesh.release()
        assert _paths() == ["pose_graph"]
    finally:
        dist.destroy_process_group()


# ---- the loop-closed call ------------------------------------------------------------

def _square_loop(n_side=3, step=0.5):
    """``test_torch_loop_closure.py``'s keyframes around a small square (of
    3 steps a side here), ending back at the start, with a random-walk
    drift on the positions."""
    world = default_world(seed=2)
    positions, yaws = [], []
    pos, yaw = np.zeros(3), 0.0
    for _ in range(4):
        for _ in range(n_side):
            positions.append(pos.copy())
            yaws.append(yaw)
            pos = pos + np.array([np.cos(yaw), np.sin(yaw), 0.0]) * step
        yaw += np.pi / 2
    positions.append(positions[0].copy())
    yaws.append(yaws[0] + 2 * np.pi)
    scans = np.stack([render_scan(LIDAR, p, y, world=world, noise=0.002, seed=i, dtype=np.float32)
                      for i, (p, y) in enumerate(zip(positions, yaws))]).astype(np.float64)
    z = np.array([0.0, 0.0, 1.0])
    rot = np.stack([np.asarray(j_quat_exp(jnp.asarray(z * y))) for y in yaws])
    drift = np.cumsum(np.random.default_rng(0).normal(0, 0.01, (len(yaws), 3)) * [1, 1, 0.2], axis=0)
    return scans, rot, np.stack(positions) + drift


@pytest.fixture(scope="module")
def loop_data():
    scans, rot, trans = _square_loop()
    j_feats = jax.vmap(lambda s: J.extract_features(s, LIDAR))(jnp.asarray(scans))
    t_feats = T.extract_features_batch(torch.from_numpy(scans), from_reference(LIDAR))
    return (J.Pose3(jnp.asarray(rot), jnp.asarray(trans)), j_feats,
            T.Pose3(torch.from_numpy(rot), torch.from_numpy(trans)), t_feats)


LOOP_KW = dict(max_candidates=2, min_separation=8, max_distance=1.5)


def test_propose_candidates_is_one_program(loop_data, monkeypatch):
    """``propose_candidates``: one cached program, nothing read on the host
    inside, bit-equal under ``program.eager()``, index-exact with
    ``loam_tpu``'s."""
    jt, _, tt, _ = loop_data
    loop.clear_cache()
    with _watched(monkeypatch) as calls:
        got = tlc.propose_candidates(tt, **LOOP_KW)
        again = tlc.propose_candidates(tt, **LOOP_KW)
    assert _paths() == ["propose_candidates"] and calls == {"while_loop": 0, "when": 0, "scan": 0}
    with program.eager():
        eager = tlc.propose_candidates(tt, **LOOP_KW)
    assert _same(got, again) and _same(got, eager)
    for a, b in zip(got, jlc.propose_candidates(jt, **LOOP_KW)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(got[2].any())


def test_loop_closed_call_is_one_program(loop_data, monkeypatch):
    """``optimize_trajectory_with_closures``: one cached program of path
    ``loop_closure`` (the proposal, the verification's registration, the
    edges and the solve inline: no program of their own), the ICF loop one
    ``while_loop`` and the LM iterations one ``scan``, nothing read on the
    host inside; bit-equal under ``program.eager()`` and to the four pieces
    called one after another; in float64 ``loam_tpu``'s closures and its
    optimized poses within 1e-4 m / 1e-4 rad."""
    jt, j_feats, tt, t_feats = loop_data
    kw = dict(LOOP_KW, iterations=8)
    loop.clear_cache()
    with _watched(monkeypatch) as calls:
        got = tlc.optimize_trajectory_with_closures(tt, t_feats, **kw)
    assert _paths() == ["loop_closure"]
    assert calls == {"while_loop": 1, "when": 0, "scan": 1}
    with program.eager():
        eager = tlc.optimize_trajectory_with_closures(tt, t_feats, **kw)
    assert _same(got, eager)

    ci, cj, cv = tlc.propose_candidates(tt, **LOOP_KW)
    clo = tlc.verify_closures(tt, t_feats, ci, cj, cv)
    edges = tlc.join_edges(odometry_edges(tt), tlc.closure_edges(clo))
    opt, _ = optimize_pose_graph(tt, edges, iterations=8)
    assert _same(got, (opt, clo))
    assert edges.i.shape[0] == tt.translation.shape[0] - 1 + LOOP_KW["max_candidates"]

    j_opt, j_clo = jlc.optimize_trajectory_with_closures(jt, j_feats, **kw)
    t_opt, t_clo = got
    for name in ("i", "j", "accepted"):
        np.testing.assert_array_equal(getattr(t_clo, name).numpy(), np.asarray(getattr(j_clo, name)), name)
    assert bool(t_clo.accepted.any())
    np.testing.assert_allclose(t_opt.translation.numpy(), np.asarray(j_opt.translation), atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(t_opt.rotation.numpy(), np.asarray(j_opt.rotation), atol=ROT_TOL, rtol=0)
