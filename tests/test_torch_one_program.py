"""One driver call, one program (``loam_tpu_torch/program.py``) on the CPU.

On the card each registration, scan-to-map frame, scan-to-scan frame and
streaming chunk is one CUDA graph, and so is each call of the trajectory
drivers, ``lax.while_loop``'s later iterations and ``lax.scan`` under WHILE
nodes, the keyframe ``lax.cond`` under an IF node; the CPU runs the same
buffers and steps eagerly, with host branches and loops (held against the
graphs by ``test_torch_cuda.py`` and ``chip_smoke.py`` phase 15). What the
CPU shows: the loop schedule (the first iteration, then a WHILE node on the
loop's flag) equals the while loop bit for bit; the scan-to-map runner,
whose state stays in the program's buffers from frame to frame, equals
fresh ``scan_to_map_step_features`` calls bit for bit (poses, details, maps,
``dropped``, the prep cache) on frames that insert and frames that do not;
the drivers equal ``loam_tpu``'s; a ``loam_tpu`` state continues through
the runner as ``loam_tpu`` continues it; the counts that WHILE bodies keep
on the device add up to the eager loop's.

Tolerances (those of the files named). Scan-to-map in float32 against
``loam_tpu``: 1e-2 m / 1e-3 rad, terminations equal
(``test_torch_scan_to_map.py``: the packages sum the normal equations in
other orders). Offline ``chunk_pairs=4, motion_init=True`` in float64: 1e-4
m / 1e-4 rad, terminations and iteration counts equal
(``test_torch_odometry.py``). The ``scan_to_scan_step(dewarp=True)`` loop in
float64: 1e-4 m / 1e-4 rad, terminations equal
(``test_torch_scan_to_scan.py``). The port against itself: bit for bit.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import loam_tpu as J
from loam_tpu import checkpoint as j_checkpoint
from loam_tpu.io import render_trajectory
from loam_tpu.odometry import scan_to_map as j_s2m

import loam_tpu_torch as T
from loam_tpu_torch import checkpoint, program
from loam_tpu_torch.odometry import scan_to_map as s2m
from loam_tpu_torch.ops import knn_cuda
from loam_tpu_torch.params import TerminationType, from_reference
from loam_tpu_torch.registration import azimuth_sort_features, loop, spatial_sort_features

torch.set_num_threads(1)

LIDAR = J.LidarParams(16, 360, 0.5, 80.0)
N_FRAMES = 6
J_CFG = j_s2m.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
J_REG = J.RegistrationParams(search_backend="bruteforce", prior_weight=300.0)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scans():
    s, _ = render_trajectory(LIDAR, N_FRAMES, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                             noise=0.003, seed=11, dtype=np.float32)
    return s


@pytest.fixture(scope="module")
def jax_s2m(scans):
    """``loam_tpu.scan_to_map_offline`` over frames 0-2 and, from its state,
    over frames 3-5 (one compile: both calls have 3 frames): the two
    trajectories, terminations and the state after frame 2 as numpy."""
    first = J.scan_to_map_offline(jnp.asarray(scans[:3]), LIDAR, reg_params=J_REG, config=J_CFG)
    second = J.scan_to_map_offline(jnp.asarray(scans[3:]), LIDAR, reg_params=J_REG, config=J_CFG,
                                   init_state=first[0])
    out = [(np.asarray(traj.rotation), np.asarray(traj.translation), np.asarray(det.termination))
           for _, traj, det in (first, second)]
    return out, jax.tree.map(np.asarray, first[0]), first[0]


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


def _chunk_ending_three_ways(scans, max_iterations):
    """Float64 features of three pairs whose loops end differently: pair 0
    starts at its converged pose (CONVERGED at once), pair 1 at the identity
    (MAX_ITER within 2 iterations), pair 2 with its source emptied
    (INSUFFICIENT)."""
    f = T.extract_features_batch(torch.from_numpy(scans[:4].astype(np.float64)), from_reference(LIDAR),
                                 post=azimuth_sort_features)
    src, tgt = f.map(lambda x: x[1:]), f.map(lambda x: x[:-1])
    keep = torch.tensor([True, True, False])
    src = src._replace(edge_mask=src.edge_mask & keep[:, None], planar_mask=src.planar_mask & keep[:, None])
    ident = T.Pose3.identity(torch.float64, (3,))
    warm, _ = T.register_features_batch(src, tgt, ident, reorder_mode="none")
    init = T.Pose3(torch.where(torch.tensor([True, False, False])[:, None], warm.rotation, ident.rotation),
                   torch.where(torch.tensor([True, False, False])[:, None], warm.translation,
                               ident.translation))
    return src, tgt, init, T.RegistrationParams(search_backend="bruteforce", max_iterations=max_iterations)


@pytest.mark.parametrize("max_iterations", [1, 2, 10])
def test_unrolled_schedule_equals_the_while_loop(scans, monkeypatch, max_iterations):
    """``_Loop.schedule`` -- the first iteration, then
    ``program.while_loop(any_running, step)`` -- against a while loop over
    ``_Loop.step`` that reads the flag after each iteration: estimates,
    terminations, iteration counts and every detail row bit-equal, and the
    same outer iterations counted. The schedule runs eagerly and as its
    WHILE node runs (the flag read on entry and after each run of the body,
    one node whatever ``max_iterations`` is, none for 1)."""
    src, tgt, init, params = _chunk_ending_three_ways(scans, max_iterations)
    parts = (src.edge_points, src.edge_mask, src.planar_points, src.planar_mask)
    search = (knn_cuda.knn_prep(tgt.edge_points, tgt.edge_mask),
              knn_cuda.knn_prep(tgt.planar_points, tgt.planar_mask))
    make = lambda: loop._Loop("single", params, True, False, parts, init, search, None)

    n0 = loop.iterations
    want = make()
    want.reset()
    go, first = True, True
    while go:
        want.step(first)
        first, go = False, bool(want.any_running)
    n_while = loop.iterations - n0
    term = want.status.tolist()
    assert term[0] == TerminationType.CONVERGED and term[2] == TerminationType.INSUFFICIENT_ASSOCIATIONS
    assert max_iterations == 10 or term[1] == TerminationType.MAX_ITER

    eager = make()
    n0 = loop.iterations
    eager.schedule()
    assert loop.iterations - n0 == n_while
    assert _same(eager.results(), want.results())

    ran, nodes = [], []

    def node(flag, body):
        """A WHILE node's semantics on the host: the flag read on entry and
        after each run of the body, the body run while it holds."""
        nodes.append(flag)
        while True:
            ran.append(bool(flag))
            if not ran[-1]:
                break
            body()

    monkeypatch.setattr(program, "while_loop", node)
    unrolled = make()
    n0 = loop.iterations
    unrolled.schedule()
    assert len(nodes) == (max_iterations > 1) and ran[-1:] == [False] * (max_iterations > 1)
    assert loop.iterations - n0 == n_while == 1 + sum(ran)
    assert _same(unrolled.results(), want.results())


def test_scan_to_map_runner_equals_fresh_steps(scans, monkeypatch):
    """``scan_to_map_offline``'s resident state (copied into the frame
    program's buffers once, updated there frame by frame) against fresh
    ``scan_to_map_step_features`` calls (the state copied in and cloned out
    each frame), with the prep cache forced on so that the keyframe insert
    also rebuilds it: poses, details, maps, ``dropped``, the cache and the
    carry bit-equal, on frames that insert and frames that do not. The
    trajectory is one program, the extraction one and a step one."""
    monkeypatch.setattr(s2m, "_use_prep_cache", lambda points: True)
    lidar, cfg, reg = from_reference(LIDAR), from_reference(J_CFG), from_reference(J_REG)
    state0 = T.scan_to_map_init(cfg, lidar=lidar, device="cpu")
    assert len(state0.knn_prep_cache) == 16
    loop.clear_cache()
    final, traj, det = T.scan_to_map_offline(torch.from_numpy(scans), lidar, reg_params=reg, config=cfg,
                                             init_state=state0)
    feats = T.extract_features_batch(torch.from_numpy(scans), lidar, post=spatial_sort_features)
    st, inserted = state0, []
    for f in range(N_FRAMES):
        st, pose, d = T.scan_to_map_step_features(st, feats.map(lambda x: x[f]), reg, cfg)
        assert _same((pose, d), jax.tree.map(lambda x: x[f], (traj, det)))
        inserted.append(int(st.frames_since_insert) == 0)
    assert inserted[0] and not all(inserted), inserted
    assert _same(final, st)
    assert int(final.dropped) == 0 and len(final.knn_prep_cache) == 16
    # the cache the inserts rebuilt is the one built afresh from the final maps
    assert _same(final.knn_prep_cache, s2m.scan_to_map_rebuild_cache(final, lidar).knn_prep_cache)
    assert [p.info["path"] for p in loop._cache[CPU].values()] == ["scan_to_map_offline", "extract",
                                                                   "scan_to_map"]


def test_scan_to_map_runner_matches_loam_tpu(scans, jax_s2m):
    """The runner over the 6 frames against ``loam_tpu``'s two runs of 3."""
    (a, b), _, _ = jax_s2m
    lidar, cfg, reg = from_reference(LIDAR), from_reference(J_CFG), from_reference(J_REG)
    state, traj, det = T.scan_to_map_offline(torch.from_numpy(scans), lidar, reg_params=reg,
                                             config=cfg, device="cpu")
    np.testing.assert_allclose(traj.rotation.numpy(), np.concatenate([a[0], b[0]]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(traj.translation.numpy(), np.concatenate([a[1], b[1]]), atol=1e-2, rtol=0)
    np.testing.assert_array_equal(det.termination.numpy(), np.concatenate([a[2], b[2]]))
    assert int(state.dropped) == 0


def test_loam_tpu_state_continues_through_the_runner(scans, jax_s2m, tmp_path):
    """``loam_tpu``'s state after frame 2, converted (``from_numpy``) and
    read back from ``loam_tpu``'s checkpoint, continues through the runner
    over frames 3-5 along ``loam_tpu``'s own continuation; both routes give
    the same run bit for bit."""
    (_, b), state_np, state_j = jax_s2m
    lidar, cfg, reg = from_reference(LIDAR), from_reference(J_CFG), from_reference(J_REG)
    path = str(tmp_path / "s2m.npz")
    j_checkpoint.save(path, state_j)
    runs = []
    for st in (T.ScanToMapState.from_numpy(state_np, device="cpu"),
               checkpoint.load(path, T.scan_to_map_init(cfg, device="cpu"))):
        runs.append(T.scan_to_map_offline(torch.from_numpy(scans[3:]), lidar, reg_params=reg,
                                          config=cfg, init_state=st))
    _, traj, det = runs[0]
    np.testing.assert_allclose(traj.rotation.numpy(), b[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(traj.translation.numpy(), b[1], atol=1e-2, rtol=0)
    np.testing.assert_array_equal(det.termination.numpy(), b[2])
    assert _same(runs[0], runs[1])


def test_offline_and_scan_to_scan_match_loam_tpu(scans):
    """``odometry_offline(chunk_pairs=4, motion_init=True)`` (a full chunk
    and a padded one, one program for the call) and a
    ``scan_to_scan_step(dewarp=True)`` loop (each frame one program) in
    float64 against ``loam_tpu``'s."""
    x = scans.astype(np.float64)
    fp, rp = J.FeatureExtractionParams(), J.RegistrationParams(search_backend="bruteforce")
    tj, dj = J.odometry_offline(jnp.asarray(x), LIDAR, fp, rp, chunk_pairs=4, motion_init=True)
    loop.clear_cache()
    tt, dt = T.odometry_offline(torch.from_numpy(x), from_reference(LIDAR), from_reference(fp),
                                from_reference(rp), chunk_pairs=4, motion_init=True)
    assert [p.info["path"] for p in loop._cache[CPU].values()] == ["odometry_offline"]
    np.testing.assert_allclose(tt.translation.numpy(), np.asarray(tj.translation), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tt.rotation.numpy(), np.asarray(tj.rotation), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(dt.termination.numpy(), np.asarray(dj.termination))
    np.testing.assert_array_equal(dt.num_iterations.numpy(), np.asarray(dj.num_iterations))

    js = J.scan_to_scan_init(LIDAR, dtype=jnp.float64)
    ts = T.scan_to_scan_init(from_reference(LIDAR), dtype=torch.float64, device="cpu")
    for f in range(N_FRAMES):
        js, jp, jd = J.scan_to_scan_step(js, jnp.asarray(x[f]), LIDAR, dewarp=True)
        ts, tp, td = T.scan_to_scan_step(ts, torch.from_numpy(x[f]), from_reference(LIDAR), dewarp=True)
        np.testing.assert_allclose(tp.translation.numpy(), np.asarray(jp.translation), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tp.rotation.numpy(), np.asarray(jp.rotation), atol=1e-4, rtol=0)
        assert int(td.termination) == int(jd.termination)
    assert sum(p.info["path"] == "scan_to_scan" for p in loop._cache[CPU].values()) == 1


def test_device_counts_equal_the_eager_loops(scans, monkeypatch):
    """The counts a replay keeps on the device: a WHILE body adds what it
    launched to its lane's row of the tally each time it runs and leaves the
    host's count as it was. With the root lane's row on the CPU and the
    WHILE node's semantics on the host, the outer iterations
    (``loop.iterations``) and each kernel wrapper's ``launches`` read the
    same as the eager loop's, and setting a count zeroes its slot."""
    tally = torch.zeros(program.TALLY_SLOTS, dtype=torch.int64)
    monkeypatch.setitem(program._lanes, (CPU, ()), SimpleNamespace(tally=tally))
    src, tgt, init, params = _chunk_ending_three_ways(scans, 10)
    run = lambda: T.register_features_batch(src, tgt, init, params, with_matches=True, reorder_mode="none")

    n0 = loop.iterations
    eager = run()
    n_eager = loop.iterations - n0

    def replayed(flag, body):
        while bool(flag):
            before = [c.host for c in program.Counter.all]
            body()
            for c, n in zip(program.Counter.all, before):
                tally[c.slot] += c.host - n
                c.host = n

    monkeypatch.setattr(program, "while_loop", replayed)
    host0, n0 = loop.ITERATIONS.host, loop.iterations
    got = run()
    assert _same(got, eager)
    assert loop.iterations - n0 == n_eager > loop.ITERATIONS.host - host0 == 1
    assert int(tally[loop.ITERATIONS.slot]) == n_eager - 1 > 0
    # a kernel wrapper's count reads its slot too, and setting it zeroes it
    counted = knn_cuda.knn_run
    counted.launches = 5
    tally[counted.counter.slot] += 3
    assert counted.launches == 8
    counted.launches = 0
    assert counted.launches == 0 and int(tally[counted.counter.slot]) == 0


def test_program_inputs_and_host_branches():
    """``Program.run`` copies its inputs into its own buffers (a ``None``
    leaf keeps the buffer: a carry updated in place), and ``when`` is a
    host branch that says whether it ran."""
    carry, x = torch.zeros(3), torch.arange(3.0)
    prog = program.Program(CPU, (carry, x))

    def fn(bufs):
        c, xs = bufs
        ran = program.when(xs.sum() > 4, lambda: c.add_(xs))
        return ran, c.clone()

    ran, c = prog.run(fn, (carry, x))  # x sums to 3: no add
    assert ran is False and torch.equal(c, carry)
    ran, c = prog.run(fn, (carry, x + 1.0))
    assert ran is True and torch.equal(c, x + 1.0)
    ran, c = prog.run(fn, (None, x + 1.0))  # the carry stays in the buffers
    assert ran is True and torch.equal(c, 2 * (x + 1.0))
    assert torch.equal(carry, torch.zeros(3))  # the caller's tensor is never written
    ran, c = prog.run(fn, (carry, x * 0))
    assert ran is False and torch.equal(c, carry)
