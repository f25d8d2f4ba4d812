"""A rank's shards side by side (``program.branches``) on the CPU.

``program.branches`` is the port's twin of ``loam_tpu``'s devices running
their blocks of a ``shard_map`` at once: on the card each shard's work runs
on a CUDA stream of its own, forked and joined inside the call's one graph;
eagerly (here, and on the card under ``program.eager``) it is a host loop in
order. These tests hold the eager form, and that every shard loop of the
mesh goes through it:

* the primitive returns its branches' outputs in order and runs them in
  order, outside any program, inside a CPU program, under
  ``program.eager``, and inside ``program.scan``, ``while_loop`` and
  ``when``;
* each of the five shard loops -- ``sharding._per_row`` (the pairs), the data
  rows of ``odometry_offline_sharded``, ``_extract_lines`` (a rank's (data
  row, line block) shards), ``distributed.sharded_map_insert`` and the
  sharded pose graph's assembly and cost -- forks once per call site with
  one branch a shard, on ``make_mesh(["cpu"] * 4)`` and with ``line_axis=2``
  (offline's rows as many at once as F17's block of pairs holds);
* the sharded results still equal ``loam_tpu``'s twins on 4 virtual
  devices, at ``test_torch_parallel.py``'s tolerances (its sizes and
  parameters: 8x128 scans, float32, 2 ICF iterations): extraction and the
  map shards exact, registration and odometry within 1e-2 m / 1e-3 rad with
  equal terminations, the pose graph within 1e-8;
* counts stay exact across branches: a counter's host part adds every
  branch's launches, and a count's device part sums every lane's row of
  the tally.

The card's forms (the graph's parallel branches, its ``branches`` width,
bit-equality to eager) are ``tests/test_torch_cuda.py``'s ``cuda`` tests and
``chip_smoke.py`` phases 12, 15 and 17.
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import loam_tpu as J
import loam_tpu.parallel as jpar
from loam_tpu.odometry import scan_to_map as j_s2m
from loam_tpu.parallel import distributed as jdist
from loam_tpu.pose_graph import PoseGraphEdges as JEdges
from loam_tpu.pose_graph import optimize_pose_graph_sharded as j_opt_sharded

import loam_tpu_torch as T
from loam_tpu_torch import parallel, program
from loam_tpu_torch.geometry import Pose3
from loam_tpu_torch.io import random_pose_graph
from loam_tpu_torch.parallel import distributed as tdist
from loam_tpu_torch.pose_graph import optimize_pose_graph_sharded
from loam_tpu_torch.registration import loop

from test_torch_parallel import (FEAT, GRAPH_TOL, LIDAR, POS_TOL, REG, ROT_TOL, S2M_CFG, S2M_REG,  # noqa: F401
                                 _occupied, _pose_close, _t, long_scans, scans)

CPU = torch.device("cpu")
D = 4  # shards of the mesh


def _meshes(line_axis: int = 1):
    """The port's mesh of 4 CPU shards and ``loam_tpu``'s of 4 devices."""
    return (parallel.make_mesh(["cpu"] * D, line_axis=line_axis),
            jpar.make_mesh(jax.devices()[:D], line_axis=line_axis))


@pytest.fixture
def widths(monkeypatch):
    """The width of every ``program.branches`` call, in call order."""
    seen, real = [], program.branches

    def spy(fns, device):
        fns = list(fns)
        seen.append(len(fns))
        return real(fns, device)

    monkeypatch.setattr(program, "branches", spy)
    return seen


# ---- the primitive ---------------------------------------------------------------


def test_branches_in_order_outside_a_program():
    seen = []
    out = program.branches([lambda i=i: seen.append(i) or torch.full((2,), float(i)) for i in range(4)], CPU)
    assert seen == [0, 1, 2, 3]
    assert [x.tolist() for x in out] == [[float(i)] * 2 for i in range(4)]
    assert program.branches([], CPU) == []
    assert program.branches([lambda: 7], CPU) == [7]


def _structured(order: list):
    """A program's function over a (4,) float64 buffer that forks at every
    depth: a scan of 3 steps forking 3 branches each, a while loop of 2
    iterations forking 2, and a ``when`` forking 2; ``order`` records the
    branches as they run."""

    def fn(bufs):
        (x,) = bufs
        acc = torch.zeros(4, dtype=torch.float64)

        def step(i):
            parts = program.branches([lambda b=b: order.append(("scan", b)) or x * (b + 1) + i for b in range(3)],
                                     x.device)
            acc.add_(parts[0] - parts[1] + parts[2])
            return torch.stack(parts)

        ys = program.scan(3, step, x.device)
        k = torch.zeros((), dtype=torch.int64)
        going = k < 2

        def body():
            a, b = program.branches([lambda b=b: order.append(("while", b)) or acc * (b + 2) for b in range(2)],
                                    x.device)
            acc.copy_(a - b / 4)
            k.add_(1)
            torch.lt(k, 2, out=going)

        program.while_loop(going, body)
        ran = program.when(acc.sum() != 0, lambda: acc.add_(torch.stack(program.branches(
            [lambda b=b: order.append(("when", b)) or acc * b for b in range(2)], x.device)).sum(0)))
        return ys, acc, ran

    return fn


def _plain(x):
    """:func:`_structured`'s outputs with no branches."""
    acc = torch.zeros(4, dtype=torch.float64)
    ys = []
    for i in range(3):
        parts = [x * (b + 1) + i for b in range(3)]
        acc += parts[0] - parts[1] + parts[2]
        ys.append(torch.stack(parts))
    for _ in range(2):
        acc = acc * 2 - acc * 3 / 4
    return torch.stack(ys), acc + (acc * 0 + acc * 1)


@pytest.mark.parametrize("how", ["outside", "program", "eager"])
def test_branches_inside_scan_while_and_when(how):
    """In order at every depth, outside a program, in a CPU program and
    under ``program.eager``; the outputs those of the same work without
    branches."""
    x = torch.tensor([1.0, -2.0, 0.5, 3.0], dtype=torch.float64)
    order = []
    fn = _structured(order)
    if how == "outside":
        ys, acc, ran = fn((x,))
    else:
        prog = program.Program(CPU, (x,))
        with program.eager() if how == "eager" else contextlib.nullcontext():
            ys, acc, ran = prog.run(fn, (x,))
        assert prog.graph is None
    want = [("scan", b) for _ in range(3) for b in range(3)] + [("while", b) for _ in range(2) for b in range(2)]
    assert order == want + [("when", 0), ("when", 1)] and ran is True
    wys, wacc = _plain(x)
    assert torch.equal(ys, wys) and torch.equal(acc, wacc)


def test_counts_add_up_across_branches(scans):
    """A counter's host part counts every branch's work: the ICF iterations
    of ``register_pairs_sharded`` on 4 shards are those of its 4 rows'
    batches called one by one, and a counted function called in each
    branch counts every call."""
    f = T.extract_features_batch(torch.from_numpy(scans[:9]), _t(LIDAR), _t(FEAT),
                                 post=T.registration.azimuth_sort_features)
    src, tgt = f.map(lambda x: x[1:]), f.map(lambda x: x[:-1])
    init = Pose3.identity(torch.float32, (8,))
    mesh, _ = _meshes()
    n0 = loop.iterations
    parallel.register_pairs_sharded(src, tgt, init, mesh, _t(REG))
    sharded = loop.iterations - n0
    n0 = loop.iterations
    for r in range(D):
        part = lambda x, r=r: x[2 * r:2 * r + 2]
        T.register_features_batch(src.map(part), tgt.map(part), Pose3(part(init.rotation), part(init.translation)),
                                  _t(REG))
    assert sharded == loop.iterations - n0 > 0

    counted = program.Counted(lambda: None)
    try:
        counted.launches = 5
        program.branches([lambda b=b: [counted.counter.add() for _ in range(b + 1)] for b in range(D)], CPU)
        assert counted.launches == 5 + 1 + 2 + 3 + 4
    finally:
        program.Counter.all.remove(counted.counter)


def test_counter_sums_every_lane(monkeypatch):
    """A count's device part is one row of the tally a lane (branches that
    run at once add to rows of their own): ``Counter.value`` sums every
    row, ``Counter.set`` zeroes every row."""
    counter = program.Counter("lanes")
    try:
        rows = {key: torch.zeros(program.TALLY_SLOTS, dtype=torch.int64) for key in ((), (0,), (1,), (1, 0))}
        for key, row in rows.items():
            monkeypatch.setitem(program._lanes, ("test", key), SimpleNamespace(tally=row))
        for n, row in enumerate(rows.values()):
            row[counter.slot] = 10 ** n
        counter.host = 3
        assert counter.value == 3 + 1 + 10 + 100 + 1000
        counter.set(2)
        assert counter.value == 2 and all(int(row[counter.slot]) == 0 for row in rows.values())
    finally:
        program.Counter.all.remove(counter)


# ---- the five shard loops ----------------------------------------------------------


def _pairs(scans, widths):
    f = T.extract_features_batch(torch.from_numpy(scans[:9]), _t(LIDAR), _t(FEAT),
                                 post=T.registration.azimuth_sort_features)
    src, tgt = f.map(lambda x: x[1:]), f.map(lambda x: x[:-1])
    init = Pose3.identity(torch.float32, (8,))
    mesh, jmesh = _meshes()
    got = parallel.register_pairs_sharded(src, tgt, init, mesh, _t(REG))
    assert widths == [D]
    jfs = lambda fs: J.FeatureSet(*(jnp.asarray(x.numpy()) for x in fs))
    return got, jpar.register_pairs_sharded(jfs(src), jfs(tgt), J.Pose3.identity(jnp.float32, (8,)), jmesh, REG)


def _offline(scans, widths, line_axis):
    x = scans[:8]
    mesh, jmesh = _meshes(line_axis)
    got = parallel.odometry_offline_sharded(x, _t(LIDAR), mesh, _t(FEAT), _t(REG))
    # the extraction's fork (a block of frames by line blocks), then the data rows'
    assert widths == [line_axis, D // line_axis]
    return got, jpar.odometry_offline_sharded(jnp.asarray(x), LIDAR, jmesh, FEAT, REG)


def _check_poses(got, want):
    (pose, det), (jpose, jdet) = got, want
    np.testing.assert_array_equal(det.termination.numpy(), np.asarray(jdet.termination))
    _pose_close(pose, jpose, POS_TOL, ROT_TOL)


def test_pairs_fork_a_branch_a_shard(scans, widths):
    _check_poses(*_pairs(scans, widths))


@pytest.mark.parametrize("line_axis", [1, 2])
def test_offline_rows_fork_a_branch_a_row(scans, widths, line_axis):
    _check_poses(*_offline(scans, widths, line_axis))


def test_offline_rows_at_once_within_f17s_block(long_scans, widths):
    """A rank's rows register side by side while their blocks together hold
    at most ``EXTRACT_BLOCK`` pairs (or a pair a row), one at a time once a
    row fills a block: F17's bound on the call's memory. 20 frames on 2
    shards are rows of 10 pairs, so no fork (two extraction blocks, then
    the rows one after the other); the same shapes, so the trajectory
    still follows ``loam_tpu``'s twin on 2 devices with the terminations of
    ``odometry_offline``."""
    from loam_tpu_torch.parallel.sharding import _side_by_side

    assert [_side_by_side(r, p) for r, p in ((4, 4), (4, 16), (4, 40), (4, 8), (2, 8), (24, 1), (8, 2))] == \
        [4, 1, 1, 2, 2, 24, 8]
    mesh = parallel.make_mesh(["cpu"] * 2)
    traj, det = parallel.odometry_offline_sharded(long_scans, _t(LIDAR), mesh, _t(FEAT), _t(REG))
    assert widths == [1, 1, 1, 1]
    _, det1 = T.odometry_offline(torch.from_numpy(long_scans), _t(LIDAR), _t(FEAT), _t(REG))
    np.testing.assert_array_equal(det.termination.numpy(), det1.termination.numpy())
    jt, _ = jpar.odometry_offline_sharded(jnp.asarray(long_scans), LIDAR, jpar.make_mesh(jax.devices()[:2]), FEAT,
                                          REG)
    _pose_close(traj, jt, POS_TOL, ROT_TOL)


@pytest.mark.parametrize("line_axis", [1, 2])
def test_extraction_forks_a_branch_a_shard(scans, widths, line_axis):
    """A rank's (data row, line block) shards, 4 branches on either mesh;
    ``_extract_lines`` itself at ``line_axis=2`` and 2 rows: each frame's
    features those of the one-batch extraction, bit for bit."""
    from loam_tpu_torch.parallel import sharding

    x = scans[:8]
    mesh, jmesh = _meshes(line_axis)
    got = parallel.extract_features_sharded(x, _t(LIDAR), mesh, _t(FEAT))
    assert widths == [D]
    want = jpar.extract_features_sharded(jnp.asarray(x), LIDAR, jmesh, FEAT)
    single = T.extract_features_batch(torch.from_numpy(x), _t(LIDAR), _t(FEAT))
    for g, s, w in zip(got, single, want):
        assert torch.equal(g, s)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    widths.clear()
    lines = sharding._extract_lines(torch.from_numpy(x[:4]), _t(LIDAR), _t(FEAT), 2, rows=2)
    assert widths == [4]
    for a, b in zip(lines, T.extract_features_batch(torch.from_numpy(x[:4]), _t(LIDAR), _t(FEAT))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_map_insert_forks_a_branch_a_shard(widths):
    """Exact against ``loam_tpu``'s sharded insert on 4 devices, roomy and
    tight with eviction."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    mask = rng.random(500) > 0.1
    center = np.array([1.0, -2.0, 0.5], np.float32)
    mesh, jmesh = _meshes()
    for cap, radius in ((512, 0.0), (80, 9.0)):
        widths.clear()
        jm, jd = jax.jit(lambda m, p, k, c: jdist.sharded_map_insert(m, p, k, jmesh, c, radius))(
            jdist.sharded_map_empty(cap, 0.5, jmesh), jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(center))
        tm, td = tdist.sharded_map_insert(tdist.sharded_map_empty(cap, 0.5, mesh), torch.from_numpy(pts),
                                          torch.from_numpy(mask), mesh, torch.from_numpy(center), radius)
        assert widths == [D] and int(td) == int(jd)
        for s in range(D):
            assert _occupied(tm.points[s], tm.mask[s]) == _occupied(jm.points[s], jm.mask[s])
            np.testing.assert_array_equal(tm.points[s].numpy(), np.asarray(jm.points[s]))
            np.testing.assert_array_equal(tm.mask[s].numpy(), np.asarray(jm.mask[s]))


def test_scan_to_map_keyframes_fork_a_branch_a_shard(scans, widths):
    """Each keyframe inserts into the edge and the planar map, a fork of 4
    each; frame by frame the keyframe decisions and terminations of
    ``loam_tpu``'s sharded step on 4 devices, the poses within 1e-2 m / 1e-3
    rad (F6)."""
    cfg, jcfg = T.ScanToMapConfig(**S2M_CFG), j_s2m.ScanToMapConfig(**S2M_CFG)
    mesh, jmesh = _meshes()
    lidar, feat, reg = _t(LIDAR), _t(FEAT), _t(S2M_REG)
    sh = tdist.scan_to_map_init_sharded(cfg, mesh)
    jsh = jdist.scan_to_map_init_sharded(jcfg, jmesh)
    keyframes = 0
    for f in range(4):
        sh, pose, det = tdist.scan_to_map_step_sharded(sh, torch.from_numpy(scans[f]), lidar, mesh, feat, reg, cfg)
        jsh, jpose, jdet = jdist.scan_to_map_step_sharded(jsh, jnp.asarray(scans[f]), LIDAR, jmesh,
                                                          feat_params=FEAT, reg_params=S2M_REG, config=jcfg)
        assert int(sh.frames_since_insert) == int(jsh.frames_since_insert), f
        assert int(det.termination) == int(jdet.termination), f
        _pose_close(pose, jpose, POS_TOL, ROT_TOL)
        keyframes += int(sh.frames_since_insert) == 0
    assert keyframes > 0 and widths == [D, D] * keyframes and int(sh.dropped) == 0


def test_pose_graph_assembly_and_cost_fork_a_branch_a_shard(widths):
    """The cost before the LM loop, then each iteration's assembly and cost:
    a fork of 4 each; within 1e-8 of ``loam_tpu``'s sharded solve on 4
    devices."""
    _, init, edges = random_pose_graph(60, 5, seed=3)  # 64 edges over 4 shards
    edges = edges._replace(mask=edges.mask.clone())
    edges.mask[[3, 40]] = False
    mesh, jmesh = _meshes()
    got, cost = optimize_pose_graph_sharded(init, edges, mesh, iterations=5)
    assert widths == [D] * (1 + 2 * 5)
    jp = lambda p: J.Pose3(jnp.asarray(p.rotation.numpy()), jnp.asarray(p.translation.numpy()))
    jedges = JEdges(jnp.asarray(edges.i.numpy()), jnp.asarray(edges.j.numpy()), jp(edges.measurement),
                    jnp.asarray(edges.weight.numpy()), jnp.asarray(edges.mask.numpy()))
    jgot, jcost = jax.jit(lambda i, e: j_opt_sharded(i, e, jmesh, iterations=5))(jp(init), jedges)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(jgot.translation), atol=GRAPH_TOL, rtol=0)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(jgot.rotation), atol=GRAPH_TOL, rtol=0)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-8, atol=1e-20)


def test_one_shard_a_rank_forks_nothing(scans, widths):
    """On a mesh of one shard each loop is one branch: no fork (on the card
    the graph of N ranks x 1 keeps its nodes)."""
    f = T.extract_features_batch(torch.from_numpy(scans[:3]), _t(LIDAR), _t(FEAT),
                                 post=T.registration.azimuth_sort_features)
    src, tgt = f.map(lambda x: x[1:]), f.map(lambda x: x[:-1])
    mesh = parallel.make_mesh(["cpu"])
    got = parallel.register_pairs_sharded(src, tgt, Pose3.identity(torch.float32, (2,)), mesh, _t(REG))
    want = T.register_features_batch(src, tgt, Pose3.identity(torch.float32, (2,)), _t(REG))
    assert widths == [1]
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)
