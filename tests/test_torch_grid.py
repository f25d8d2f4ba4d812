"""The port's voxel-grid search (``neighbors/grid.py``) and the
``search_backend="grid"`` registration against ``loam_tpu``'s on the same
numpy inputs, on the CPU.

Tolerances. Cell keys, the sort permutation, neighbor indices, masks and the
overflow counts are exact: the same float and integer operations on the same
inputs. Distances agree at rtol 1e-6 (XLA may contract the distance expression
into FMAs). Registration in float64 agrees within 1e-4 m / 1e-4 rad with equal
termination codes, iteration counts and overflow arrays; the float32
scan-to-map run within 1e-2 m / 1e-3 rad (the ICF convergence thresholds: the
two packages sum the normal equations in different orders, see
``test_torch_odometry.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import loam_tpu as J
from loam_tpu.features import extract_features_batch as j_batch
from loam_tpu.io import render_trajectory
from loam_tpu.neighbors import grid as j_grid
from loam_tpu.odometry import scan_to_map as j_s2m
from loam_tpu.registration.icf import azimuth_sort_features as j_azimuth

import loam_tpu_torch as T
from loam_tpu_torch.evaluation import ate_rmse
from loam_tpu_torch.neighbors import grid as t_grid
from loam_tpu_torch.neighbors import knn as t_knn
from loam_tpu_torch.params import from_reference

# the suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing its cores
torch.set_num_threads(1)

LIDAR = J.LidarParams(16, 360, 0.5, 80.0)


def _room(seed, m, q, spread=12.0):
    rng = np.random.default_rng(seed)
    targets = rng.uniform(-spread, spread, size=(m, 3)).astype(np.float32)
    tmask = rng.random(m) > 0.15
    queries = rng.uniform(-spread, spread, size=(q, 3)).astype(np.float32)
    return queries, targets, tmask


def _crowded_cell():
    """60 targets inside one cell, more than ``max_per_cell``, with queries
    beside them: lookups overflow and neighbors are missed, alike in both."""
    q, t, m = _room(1, 900, 150)
    rng = np.random.default_rng(2)
    t[:60] = np.array([3.2, 3.3, 3.1], np.float32) + rng.uniform(0, 0.5, (60, 3)).astype(np.float32)
    m[:60] = True
    q[:40] = np.array([3.4, 3.4, 3.4], np.float32) + rng.uniform(-0.8, 0.8, (40, 3)).astype(np.float32)
    return q, t, m


def _clamped_border():
    """Targets and queries beyond the grid's 1,024 cells an axis: their cells
    clamp to the border, where a neighborhood names one cell several times."""
    q, t, m = _room(3, 800, 120)
    rng = np.random.default_rng(4)
    far = (np.array([1500.0, 0.0, -3.0]) + rng.uniform(-2, 2, (200, 3))).astype(np.float32)
    t[-200:] = far
    m[-200:] = True
    q[-60:] = far[:60] + np.float32(0.1)
    q[0] = t[0]  # a query on the min corner's side
    return q, t, m


def _all_masked():
    q, t, m = _room(5, 300, 50)
    return q, t, np.zeros_like(m)


def _crowd_at_the_origin():
    """Ten targets in the cell that holds (0, 0, 0), over a cap of 4: the
    queries at the origin that fill up the last tile overflow there too."""
    q, t, m = _room(8, 1500, 400)
    t[:10] = np.random.default_rng(9).uniform(0.0, 0.3, (10, 3)).astype(np.float32)
    m[:10] = True
    return q, t, m


#: name -> (() -> queries, targets, target mask), k, max_dist, max_per_cell, tile
GRID_CASES = {
    "room": (lambda: _room(0, 1500, 400), 5, 1.0, 32, 4096),
    "wide_cells": (lambda: _room(6, 1200, 300), 5, 2.0, 64, 4096),
    "one_neighbor": (lambda: _room(7, 700, 200), 1, 1.5, 32, 4096),
    "cell_over_max_per_cell": (_crowded_cell, 5, 1.0, 8, 4096),
    "clamped_border": (_clamped_border, 5, 1.0, 32, 4096),
    "all_masked_target": (_all_masked, 5, 1.0, 32, 4096),
    # 400 queries in tiles of 128: the last tile is filled up with queries at the origin
    "queries_above_the_tile": (_crowd_at_the_origin, 5, 1.0, 4, 128),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_build_grid_matches_loam_tpu(case):
    make, _, max_dist, _, _ = GRID_CASES[case]
    _, t, m = make()
    ji = j_grid.build_grid(jnp.asarray(t), jnp.asarray(m), max_dist)
    ti = t_grid.build_grid(torch.from_numpy(t), torch.from_numpy(m), max_dist)
    assert ti.keys_sorted.dtype == torch.int32 and ti.perm.dtype == torch.int32
    np.testing.assert_array_equal(ti.keys_sorted.numpy(), np.asarray(ji.keys_sorted))
    np.testing.assert_array_equal(ti.perm.numpy(), np.asarray(ji.perm))
    np.testing.assert_array_equal(ti.points_sorted.numpy(), np.asarray(ji.points_sorted))
    np.testing.assert_array_equal(ti.origin.numpy(), np.asarray(ji.origin))
    # invalid points carry the sentinel key and sort last
    n = int(m.sum())
    assert (ti.keys_sorted[n:] == 1024**3).all() and (ti.keys_sorted[:n] < 1024**3).all()


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_knn_grid_matches_loam_tpu(case):
    make, k, max_dist, cap, tile = GRID_CASES[case]
    q, t, m = make()
    ji = j_grid.build_grid(jnp.asarray(t), jnp.asarray(m), max_dist)
    jr, j_ovf = j_grid.knn_grid(ji, jnp.asarray(q), k, max_dist, cap, tile)
    ti = t_grid.build_grid(torch.from_numpy(t), torch.from_numpy(m), max_dist)
    tr, t_ovf = t_grid.knn_grid(ti, torch.from_numpy(q), k, max_dist, cap, tile)
    jm = np.asarray(jr.mask)
    assert tr.indices.dtype == torch.int32 and tr.indices.shape == (len(q), k)
    np.testing.assert_array_equal(tr.mask.numpy(), jm)
    np.testing.assert_array_equal(tr.indices.numpy()[jm], np.asarray(jr.indices)[jm])
    np.testing.assert_allclose(tr.distances.numpy()[jm], np.asarray(jr.distances)[jm], rtol=1e-6)
    assert np.isinf(tr.distances.numpy()[~jm]).all()
    assert int(t_ovf) == int(j_ovf)
    assert (int(t_ovf) > 0) == (case in ("cell_over_max_per_cell", "queries_above_the_tile"))
    if case == "all_masked_target":
        assert not jm.any()
    else:
        assert jm.any() and m[tr.indices.numpy()[jm]].all()  # only valid targets are returned


@pytest.mark.parametrize("case", ["room", "wide_cells", "one_neighbor", "clamped_border"])
def test_knn_grid_equals_bruteforce_without_overflow(case):
    """Exact at overflow 0: the port's brute-force search finds the same
    neighbors at bit-equal distances (the same difference formula)."""
    make, k, max_dist, cap, tile = GRID_CASES[case]
    q, t, m = (torch.from_numpy(x) for x in make())
    res, ovf = t_grid.knn_grid(t_grid.build_grid(t, m, max_dist), q, k, max_dist, cap, tile)
    assert int(ovf) == 0
    want = t_knn(q, t, m, k, max_dist)
    assert torch.equal(res.mask, want.mask)
    assert torch.equal(res.indices[want.mask], want.indices[want.mask])
    assert torch.equal(res.distances, want.distances)


def test_knn_grid_batched_equals_per_pair():
    cases = [_room(s, 600, 130, spread=3.0) for s in (11, 12, 13)]  # ~3 points a cell, cap 2
    cases[1] = (cases[1][0], cases[1][1], np.zeros_like(cases[1][2]))  # one empty target set
    q, t, m = (torch.from_numpy(np.stack([c[i] for c in cases])) for i in range(3))
    index = t_grid.build_grid(t, m, 1.0)
    res, ovf = t_grid.knn_grid(index, q, 5, 1.0, 2, tile=50)
    assert ovf.shape == (3,) and int(ovf[0]) > 0 and int(ovf[1]) == 0
    for b in range(3):
        one, o = t_grid.knn_grid(t_grid.build_grid(t[b], m[b], 1.0), q[b], 5, 1.0, 2, tile=50)
        assert int(o) == int(ovf[b])
        for x, y in zip(res, one):
            assert torch.equal(x[b], y)


def test_knn_grid_refuses_what_it_cannot_search():
    q, t, m = (torch.from_numpy(x) for x in _room(0, 20, 5))
    index = t_grid.build_grid(t, m, 1.0)
    with pytest.raises(ValueError, match="positive search radius"):
        t_grid.knn_grid(index, q, 5, 0.0)
    with pytest.raises(ValueError, match="at least one slot"):
        t_grid.build_grid(t[:0], m[:0], 1.0)


# ---- registration through the grid -------------------------------------------

@pytest.fixture(scope="module")
def frames():
    scans, _ = render_trajectory(LIDAR, 4, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float32)
    fs = j_batch(jnp.asarray(scans), LIDAR, J.FeatureExtractionParams(), post=j_azimuth)
    return [np.asarray(x) for x in fs]


def _pair(frames, i):
    """(jax source, jax target, port source, port target), float64."""
    up = lambda leaves: [x.astype(np.float64) if x.dtype == np.float32 else x for x in leaves]
    js = J.FeatureSet(*map(jnp.asarray, up([x[i + 1] for x in frames])))
    jt = J.FeatureSet(*map(jnp.asarray, up([x[i] for x in frames])))
    return (js, jt, T.FeatureSet.from_numpy(js, dtype=torch.float64, device="cpu"),
            T.FeatureSet.from_numpy(jt, dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("pair,cap", [(0, 64), (1, 64), (2, 3)], ids=["pair0", "pair1", "pair2_cap3"])
def test_register_features_grid_matches_loam_tpu(frames, pair, cap):
    """float64, the grid backend in both packages. A scan's planar points
    near the sensor crowd the 2 m cells past the default cap of 64, and past
    a cap of 3 everywhere: the two packages record the same counts."""
    js, jt, ts, tt = _pair(frames, pair)
    rp = J.RegistrationParams(search_backend="grid", grid_max_per_cell=cap)
    pj, dj = J.register_features(js, jt, params=rp)
    pt, dt = T.register_features(ts, tt, params=from_reference(rp))
    np.testing.assert_allclose(pt.rotation.numpy(), np.asarray(pj.rotation), atol=1e-4, rtol=0)
    np.testing.assert_allclose(pt.translation.numpy(), np.asarray(pj.translation), atol=1e-4, rtol=0)
    assert int(dt.termination) == int(dj.termination)
    assert int(dt.num_iterations) == int(dj.num_iterations)
    ij, it = dj.iteration_info, dt.iteration_info
    for name in ("edge_knn_overflow", "plane_knn_overflow", "edge_count", "plane_count"):
        np.testing.assert_array_equal(getattr(it, name).numpy(), np.asarray(getattr(ij, name)), err_msg=name)
    n = int(dj.num_iterations)
    np.testing.assert_array_equal(it.edge_match.numpy()[:n], np.asarray(ij.edge_match)[:n])
    total = int(it.edge_knn_overflow.sum() + it.plane_knn_overflow.sum())
    assert total > 0


def test_register_grid_equals_bruteforce_without_overflow(frames):
    """The grid is exact at overflow 0, and the packed fits (brute force) and
    the gathered fits (grid) share their arithmetic: the port's two backends
    give the same registration."""
    _, _, ts, tt = _pair(frames, 0)
    radii = dict(max_edge_neighbor_dist=0.5, max_plane_neighbor_dist=0.5)  # 0.5 m cells stay under the cap
    pg, dg = T.register_features(ts, tt, params=T.RegistrationParams(search_backend="grid", **radii))
    pb, db = T.register_features(ts, tt, params=T.RegistrationParams(search_backend="bruteforce", **radii))
    assert int(dg.iteration_info.edge_knn_overflow.sum() + dg.iteration_info.plane_knn_overflow.sum()) == 0
    assert int(dg.termination) == int(db.termination)
    assert int(dg.num_iterations) == int(db.num_iterations)
    assert torch.equal(dg.iteration_info.edge_match, db.iteration_info.edge_match)
    np.testing.assert_allclose(pg.translation.numpy(), pb.translation.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(pg.rotation.numpy(), pb.rotation.numpy(), atol=1e-12, rtol=0)


def test_grid_backend_without_a_radius_searches_by_bruteforce(frames):
    """``loam_tpu`` builds no grid unless both radii are positive and leaves
    the search to the association's own brute force; so does the port."""
    js, jt, ts, tt = _pair(frames, 1)
    rp = J.RegistrationParams(search_backend="grid", max_edge_neighbor_dist=0.0)
    pj, dj = J.register_features(js, jt, params=rp)
    pt, dt = T.register_features(ts, tt, params=from_reference(rp))
    np.testing.assert_allclose(pt.translation.numpy(), np.asarray(pj.translation), atol=1e-4, rtol=0)
    assert int(dt.termination) == int(dj.termination)
    pb, _ = T.register_features(ts, tt, params=T.RegistrationParams(max_edge_neighbor_dist=0.0))
    assert torch.equal(pt.translation, pb.translation)
    assert not dt.iteration_info.edge_knn_overflow.any()


# ---- scan-to-map through the grid ---------------------------------------------

N_FRAMES = 6
J_CFG = j_s2m.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
J_REG = J.RegistrationParams(search_backend="grid", prior_weight=300.0)


@pytest.fixture(scope="module")
def trajectory():
    scans, poses = render_trajectory(LIDAR, N_FRAMES, step=np.array([0.10, 0.03, 0.0]),
                                     yaw_rate=0.02, noise=0.003, seed=11, dtype=np.float32)
    return scans, np.stack([t for (_, t) in poses])


@pytest.fixture(scope="module")
def jax_grid_run(trajectory):
    scans, _ = trajectory
    state = j_s2m.scan_to_map_init(J_CFG)
    out = []
    for f in range(N_FRAMES):
        state, pose, det = J.scan_to_map_step(state, jnp.asarray(scans[f]), LIDAR,
                                              reg_params=J_REG, config=J_CFG)
        info = det.iteration_info
        out.append((np.asarray(pose.rotation), np.asarray(pose.translation), int(det.termination),
                    np.asarray(info.edge_knn_overflow), np.asarray(info.plane_knn_overflow)))
    return out, (int(state.edge_map.size), int(state.planar_map.size))


def test_scan_to_map_grid_matches_loam_tpu(trajectory, jax_grid_run):
    scans, gt = trajectory
    j_frames, (j_ne, j_np) = jax_grid_run
    state, traj, det = T.scan_to_map_offline(scans, from_reference(LIDAR), reg_params=from_reference(J_REG),
                                             config=from_reference(J_CFG), device="cpu")
    info = det.iteration_info
    for f, (rot, trans, term, e_ovf, p_ovf) in enumerate(j_frames):
        np.testing.assert_allclose(traj.translation[f].numpy(), trans, atol=1e-2, rtol=0)
        np.testing.assert_allclose(traj.rotation[f].numpy(), rot, atol=1e-3, rtol=0)
        assert int(det.termination[f]) == term
        # the default cap of 64 points a cell is never reached at this size, in either
        assert not e_ovf.any() and not p_ovf.any()
    assert not info.edge_knn_overflow.any() and not info.plane_knn_overflow.any()
    # the first frame meets the empty map: no associations, the init pose
    assert int(det.termination[0]) == T.TerminationType.INSUFFICIENT_ASSOCIATIONS
    assert int(state.dropped) == 0
    assert abs(int(state.edge_map.size) - j_ne) <= 0.02 * j_ne
    assert abs(int(state.planar_map.size) - j_np) <= 0.02 * j_np
    assert ate_rmse(traj.translation.numpy(), gt, align=False) < 0.05


def test_scan_to_map_grid_equals_bruteforce(trajectory):
    """At overflow 0 the grid finds the brute-force search's neighbors, so the
    port's two backends give the same scan-to-map trajectory: bit for bit on
    the CPU (both feed fits of the same arithmetic)."""
    scans, _ = trajectory
    cfg = from_reference(J_CFG)
    run = lambda rp: T.scan_to_map_offline(scans, from_reference(LIDAR), reg_params=rp, config=cfg,
                                           device="cpu")
    _, tg, dg = run(from_reference(J_REG))
    _, tb, db = run(T.default_map_reg_params())
    assert torch.equal(dg.termination, db.termination)
    assert torch.equal(dg.num_iterations, db.num_iterations)
    assert torch.equal(tg.translation, tb.translation)
    assert torch.equal(tg.rotation, tb.rotation)
