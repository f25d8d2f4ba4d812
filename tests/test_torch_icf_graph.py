"""The ICF loop's static-buffer runner (``registration/loop.py``) on the CPU,
against ``loam_tpu``'s ``register_features_batch`` and against itself.

On the CPU the runner steps its buffers eagerly; on the card the same step
is replayed as CUDA graphs (held against this eager runner by
``test_torch_cuda.py`` and ``chip_smoke.py`` phase 15). What the CPU shows:
the carry starts afresh every call (a cached loop reused across chunks
equals a fresh call bit for bit), results never alias the buffers, one key
serves every chunk of a run, the eager-only paths are not cached, and the
outputs equal ``loam_tpu``'s.

Tolerances. float64 on both sides: termination codes and iteration counts
equal, the matches index-exact, the estimates (entering each iteration,
and the result) within 1e-9 and each iteration's solved update within 1e-8
-- the tolerances ``oracle.compare.check_icf`` holds a float64 loop to: the
same neighbours, with the normal equations summed in other orders (the
updates near convergence, ~1e-5 m, differ by up to 1.3e-9 m here); the
returned pose, the last estimate with its update applied, within 1e-8. The offline run: the
tolerances of ``test_torch_odometry.py`` (float64 1e-4 m / 1e-4 rad,
terminations and iteration counts equal).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import loam_tpu as J
from loam_tpu.io import render_trajectory

import loam_tpu_torch as T
from loam_tpu_torch.params import TerminationType, from_reference
from loam_tpu_torch.registration import azimuth_sort_features, icf, loop

torch.set_num_threads(1)

LIDAR = J.LidarParams(16, 360, 0.5, 80.0)
EST_TOL, UPDATE_TOL = 1e-9, 1e-8


@pytest.fixture(scope="module")
def feats():
    """Features of 6 frames of 16x360 in float64, azimuth-sorted as the
    offline driver keeps them, for both packages."""
    scans, _ = render_trajectory(LIDAR, 6, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float32)
    x = scans.astype(np.float64)
    tf = T.extract_features_batch(torch.from_numpy(x), from_reference(LIDAR),
                                  post=azimuth_sort_features)
    jf = J.FeatureSet(*(jnp.asarray(a.numpy()) for a in tf))
    return jf, tf


def _chunk(feats, pairs, empty=()):
    """(source, target) of ``pairs`` (frame j against frame i), pair
    indices in ``empty`` with every source slot masked off."""
    jf, tf = feats
    ii, jj = np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])
    src, tgt = tf.map(lambda x: x[torch.from_numpy(jj)]), tf.map(lambda x: x[torch.from_numpy(ii)])
    if empty:
        keep = torch.ones(len(pairs), dtype=torch.bool)
        keep[list(empty)] = False
        src = src._replace(edge_mask=src.edge_mask & keep[:, None],
                           planar_mask=src.planar_mask & keep[:, None])
    return src, tgt


def _init(rot, trans):
    return T.Pose3(torch.from_numpy(np.asarray(rot, np.float64)),
                   torch.from_numpy(np.asarray(trans, np.float64)))


def _jax(x):
    return jax.tree.map(lambda a: jnp.asarray(a.numpy()), x)


def _same(a, b):
    """Two ``(Pose3, RegistrationDetail)`` results equal bit for bit."""
    la = [x for x in jax.tree.leaves(a) if x is not None]
    lb = [x for x in jax.tree.leaves(b) if x is not None]
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _three_endings(feats, max_iterations):
    """A chunk whose pairs end differently: pair 0 starts at its converged
    pose (CONVERGED at once), pair 1 at the identity (it needs more than 2
    iterations), pair 2 with its source emptied (INSUFFICIENT)."""
    params = T.RegistrationParams(search_backend="bruteforce", max_iterations=max_iterations)
    src, tgt = _chunk(feats, [(0, 1), (1, 2), (2, 3)], empty=(2,))
    warm, _ = T.register_features_batch(src, tgt, _init(np.tile([1.0, 0, 0, 0], (3, 1)), np.zeros((3, 3))),
                                        T.RegistrationParams(search_backend="bruteforce"),
                                        reorder_mode="none")
    rot = np.stack([warm.rotation[0].numpy(), [1.0, 0, 0, 0], [1.0, 0, 0, 0]])
    trans = np.stack([warm.translation[0].numpy(), np.zeros(3), np.zeros(3)])
    return src, tgt, _init(rot, trans), params


@pytest.mark.parametrize("max_iterations", [2, 10], ids=["max_iter_2", "default_10"])
def test_runner_matches_loam_tpu(feats, max_iterations):
    """The cached runner against ``loam_tpu`` in float64 on a chunk whose
    pairs end differently (with ``max_iterations=2`` all three codes), and
    bit-equal to the eager loop made for one call."""
    src, tgt, init, params = _three_endings(feats, max_iterations)
    loop.clear_cache()
    est, det = T.register_features_batch(src, tgt, init, params, with_matches=True, reorder_mode="none")
    assert len(loop._cache[torch.device("cpu")]) == 1
    j_est, j_det = J.register_features_batch(_jax(src), _jax(tgt), J.Pose3(*_jax(tuple(init))),
                                             from_reference(params), with_matches=True)
    want = [TerminationType.CONVERGED, TerminationType.MAX_ITER if max_iterations == 2
            else TerminationType.CONVERGED, TerminationType.INSUFFICIENT_ASSOCIATIONS]
    assert det.termination.tolist() == want
    np.testing.assert_array_equal(det.termination.numpy(), np.asarray(j_det.termination))
    np.testing.assert_array_equal(det.num_iterations.numpy(), np.asarray(j_det.num_iterations))
    assert det.num_iterations.tolist()[1:] == [min(max_iterations, int(det.num_iterations[1])), 0]
    info, j_info = det.iteration_info, j_det.iteration_info
    for name, tol in (("target_T_source_init", EST_TOL), ("estimate_update", UPDATE_TOL)):
        for a, b in zip(getattr(info, name), getattr(j_info, name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0)
    for name in ("edge_match", "plane_match", "edge_count", "plane_count"):
        np.testing.assert_array_equal(getattr(info, name).numpy(), np.asarray(getattr(j_info, name)))
    np.testing.assert_allclose(est.translation.numpy(), np.asarray(j_est.translation), atol=UPDATE_TOL, rtol=0)
    np.testing.assert_allclose(est.rotation.numpy(), np.asarray(j_est.rotation), atol=UPDATE_TOL, rtol=0)
    eager = icf._register_eager(src, tgt, init, params, True, reorder_mode="none")
    assert _same((est, det), eager)


def test_chunks_reuse_the_loop_bit_equal_to_fresh_calls(feats):
    """Two chunks of one key back to back through one cached loop, each
    bit-equal to a fresh call (a new loop) and to the eager loop; nothing
    of the first chunk's carry (rows, done, iteration count) reaches the
    second, which stops earlier."""
    params = T.RegistrationParams(search_backend="bruteforce")
    a, b = _chunk(feats, [(0, 1), (1, 2)]), _chunk(feats, [(3, 4), (2, 3)], empty=(1,))
    ident = _init(np.tile([1.0, 0, 0, 0], (2, 1)), np.zeros((2, 3)))
    run = lambda c: T.register_features_batch(*c, ident, params, with_matches=True, reorder_mode="none")
    fresh = []
    for c in (a, b):
        loop.clear_cache()
        fresh.append(run(c))
    loop.clear_cache()
    first, second = run(a), run(b)
    (only,) = loop._cache[torch.device("cpu")].values()
    assert only.graph is None  # one program served both; the CPU runs it eagerly
    assert _same(first, fresh[0]) and _same(second, fresh[1])
    assert _same(second, icf._register_eager(*b, ident, params, True, reorder_mode="none"))
    assert second[1].num_iterations[1] == 0 and first[1].num_iterations[1] > 0
    assert _same(run(a), fresh[0])  # and back: the loop holds nothing of b


def test_results_do_not_alias_the_buffers(feats):
    """What a call returns is its own: no tensor shares storage with the
    loop's buffers, and a later call through the same loop leaves it as it
    was (offline keeps every chunk's result)."""
    params = T.RegistrationParams(search_backend="bruteforce")
    ident = _init(np.tile([1.0, 0, 0, 0], (2, 1)), np.zeros((2, 3)))
    loop.clear_cache()
    out = T.register_features_batch(*_chunk(feats, [(0, 1), (1, 2)]), ident, params,
                                    with_matches=True, reorder_mode="none")
    kept = jax.tree.map(lambda x: x.clone(), out)
    (prog,) = loop._cache[torch.device("cpu")].values()
    buffers = {x.untyped_storage().data_ptr() for x in jax.tree.leaves(prog.buffers)
               if isinstance(x, torch.Tensor)}
    got = [x.untyped_storage().data_ptr() for x in jax.tree.leaves(out) if isinstance(x, torch.Tensor)]
    assert got and not buffers.intersection(got)
    T.register_features_batch(*_chunk(feats, [(3, 4), (2, 3)]), ident, params, with_matches=True,
                              reorder_mode="none")
    assert _same(out, kept)


def test_offline_chunks_share_one_key_and_match_loam_tpu(feats):
    """``odometry_offline(chunk_pairs=4, motion_init=True)`` on 6 frames (5
    pairs: a full chunk and a padded one) runs both chunks through one
    cached loop, equals the eager loop bit for bit, and ``loam_tpu``'s run
    at ``test_torch_odometry.py``'s float64 tolerances."""
    scans, _ = render_trajectory(LIDAR, 6, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float32)
    x = scans.astype(np.float64)
    fp, rp = J.FeatureExtractionParams(), J.RegistrationParams(search_backend="bruteforce")
    args = (torch.from_numpy(x), from_reference(LIDAR), from_reference(fp), from_reference(rp))
    loop.clear_cache()
    n0 = loop.iterations
    traj, det = T.odometry_offline(*args, chunk_pairs=4, motion_init=True)
    assert len(loop._cache[torch.device("cpu")]) == 1
    n1 = loop.iterations
    with loop._eager():
        e_traj, e_det = T.odometry_offline(*args, chunk_pairs=4, motion_init=True)
    assert _same((traj, det), (e_traj, e_det))
    # the same outer iterations, at least the slowest real pair's a chunk
    assert n1 - n0 == loop.iterations - n1 >= int(det.num_iterations[:4].max()) + int(det.num_iterations[4])
    tj, dj = J.odometry_offline(jnp.asarray(x), LIDAR, fp, rp, chunk_pairs=4, motion_init=True)
    np.testing.assert_allclose(traj.translation.numpy(), np.asarray(tj.translation), atol=1e-4, rtol=0)
    np.testing.assert_allclose(traj.rotation.numpy(), np.asarray(tj.rotation), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(det.termination.numpy(), np.asarray(dj.termination))
    np.testing.assert_array_equal(det.num_iterations.numpy(), np.asarray(dj.num_iterations))


def test_eager_paths_are_not_cached(feats, monkeypatch):
    """``LOAM_DEBUG_NANS=1`` and a caller's own ``custom_knn`` run on a loop
    made for the call (the card would not capture them: both may read the
    host), with the cached runner's results; the grid search is a captured
    path with a key of its own, as are the single and the dual search, and
    the cache keeps at most ``CACHE_KEYS`` loops a device."""
    from loam_tpu_torch.ops import knn_cuda

    src, tgt = _chunk(feats, [(0, 1)])
    ident = _init([[1.0, 0, 0, 0]], [[0.0, 0, 0]])
    cpu = torch.device("cpu")
    rp = T.RegistrationParams()
    loop.clear_cache()
    monkeypatch.setenv("LOAM_DEBUG_NANS", "1")
    debug = T.register_features_batch(src, tgt, ident)
    monkeypatch.delenv("LOAM_DEBUG_NANS")
    e_prep = knn_cuda.knn_prep(tgt.edge_points, tgt.edge_mask)
    p_prep = knn_cuda.knn_prep(tgt.planar_points, tgt.planar_mask)
    custom = (lambda q: knn_cuda.knn_run(e_prep, q, rp.num_edge_neighbors, rp.max_edge_neighbor_dist,
                                         with_coords=True, query_mask=src.edge_mask),
              lambda q: knn_cuda.knn_run(p_prep, q, rp.num_plane_neighbors, rp.max_plane_neighbor_dist,
                                         with_coords=True, query_mask=src.planar_mask))
    mine = icf._register_impl(src, tgt, ident, rp, False, custom_knn=custom)
    assert cpu not in loop._cache or not loop._cache[cpu]
    plain = T.register_features_batch(src, tgt, ident)
    assert _same(debug, plain) and _same(mine, plain)
    assert len(loop._cache[cpu]) == 1
    grid = T.RegistrationParams(search_backend="grid")
    T.register_features_batch(src, tgt, ident, grid)
    assert [p.info["path"] for p in loop._cache[cpu].values()] == ["single", "grid"]
    f32 = (src.map(lambda x: x.float() if x.is_floating_point() else x),
           tgt.map(lambda x: x.float() if x.is_floating_point() else x))
    single = T.register_features_batch(*f32, ident)
    monkeypatch.setenv("LOAM_ICF_DUAL_KNN", "1")
    dual = T.register_features_batch(*f32, ident)
    assert {p.info["path"] for p in loop._cache[cpu].values()} == {"single", "grid", "dual"}
    assert len(loop._cache[cpu]) == 4
    np.testing.assert_allclose(dual[0].translation.numpy(), single[0].translation.numpy(), atol=1e-5)
    for iters in range(1, loop.CACHE_KEYS + 2):
        T.register_features_batch(src, tgt, ident, T.RegistrationParams(max_iterations=iters))
    assert len(loop._cache[cpu]) == loop.CACHE_KEYS
