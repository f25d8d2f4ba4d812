"""The port's float64 oracle (``loam_tpu_torch.oracle``) against
``loam_tpu.oracle``, and the port's float64 ICF loop against the port's
oracle.

The oracle is a copy, so its results must equal ``loam_tpu``'s bit for bit:
curvature, validity, feature picks, ``knn_oracle`` and every field of every
``register_oracle`` iteration. Its ``_knn`` takes its queries in chunks;
chunked and unchunked must be equal too. The port's ``register_features``
in float64 must then follow the port's oracle iteration by iteration, as
``tests/test_icf_oracle.py`` holds ``loam_tpu``'s loop: validity and matches
equal, entering estimates within 1e-9, deltas within 1e-8. The oracle must
import neither JAX nor ``loam_tpu``. Also here: ``compute_curvature_df`` /
``compute_valid_points_df`` against ``loam_tpu``'s (``hi + lo`` within
rtol 1e-12 of it, as ``test_torch_features.py`` holds curvature; masks
equal), and the ``neighbor_pts`` argument of ``associate_edges`` /
``associate_planes`` against ``loam_tpu``'s.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import loam_tpu as J
from loam_tpu import oracle as j_oracle
from loam_tpu.features.curvature import compute_curvature_df as j_curv_df
from loam_tpu.features.curvature import compute_valid_points_df as j_valid_df
from loam_tpu.io import render_scan, render_trajectory
from loam_tpu.neighbors import knn_oracle as j_knn_oracle
from loam_tpu.oracle import icf_oracle as j_icf
from loam_tpu.registration import associate as j_assoc

import loam_tpu_torch as T
from loam_tpu_torch import oracle as t_oracle
from loam_tpu_torch.features.curvature import compute_curvature_df, compute_valid_points_df
from loam_tpu_torch.neighbors import knn as t_knn
from loam_tpu_torch.neighbors import knn_oracle
from loam_tpu_torch.oracle import compare, icf_oracle as t_icf
from loam_tpu_torch.params import from_reference
from loam_tpu_torch.registration import associate as t_assoc

from test_registration import simple_scene

# the suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing its cores
torch.set_num_threads(1)

LIDAR = J.LidarParams(16, 360, 0.5, 80.0)
ALT = J.FeatureExtractionParams(neighbor_points=5, number_sectors=4, max_edge_feats_per_sector=3,
                                max_planar_feats_per_sector=7, edge_feat_threshold=50.0,
                                planar_feat_threshold=2.0, occlusion_thresh=0.3, parallel_thresh=0.5)


@pytest.fixture(scope="module")
def frames():
    """Two 16x360 frames of the test trajectory and their features (compact,
    float64 of the float32 coordinates), extracted by the port on the CPU."""
    scans, _ = render_trajectory(LIDAR, 2, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float32)
    tl = from_reference(LIDAR)
    fs = [T.extract_features(torch.from_numpy(s), tl).compact() for s in scans]
    return [tuple(np.asarray(x, np.float64) for x in f) for f in fs]


@pytest.mark.parametrize("params", [J.FeatureExtractionParams(), ALT], ids=["default", "alt"])
@pytest.mark.parametrize("seed", [0, 1])
def test_feature_oracle_equals_loam_tpu(seed, params):
    scan = render_scan(LIDAR, noise=0.01, seed=seed, dtype=np.float32).astype(np.float64)
    tl, tp = from_reference(LIDAR), from_reference(params)
    c = t_oracle.compute_curvature(scan, tl, tp)
    v = t_oracle.compute_valid_points(scan, tl, tp)
    assert np.array_equal(c, j_oracle.compute_curvature(scan, LIDAR, params))
    assert np.array_equal(v, j_oracle.compute_valid_points(scan, LIDAR, params))
    e, p = t_oracle.extract_features(scan, tl, tp)
    assert (e, p) == j_oracle.extract_features(scan, LIDAR, params)
    assert len(e) > 0 and len(p) > 100
    # given curvature and mask, as the kernels' tests pass them
    assert t_oracle.extract_features(scan, tl, tp, c, v) == (e, p)


@pytest.mark.parametrize("max_dist", [0.0, 0.7])
@pytest.mark.parametrize("k", [1, 5])
def test_knn_oracle_equals_loam_tpu(k, max_dist):
    rng = np.random.default_rng(k)
    t = rng.uniform(-2, 2, size=(300, 3)).astype(np.float32)
    t[7] = t[3]  # an exact tie: first index first
    q = np.concatenate([rng.uniform(-2, 2, size=(40, 3)).astype(np.float32), t[3:4]])
    m = rng.random(300) > 0.2
    m[3] = m[7] = True
    got = knn_oracle(q, t, m, k, max_dist)
    want = j_knn_oracle(q, t, m, k, max_dist)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_knn_oracle_holds_the_plain_search():
    """The port's brute-force search against the oracle by the rule the card
    is held to (compare.check_knn): float32 coordinates, no row outside the
    near-tie margin may differ."""
    rng = np.random.default_rng(3)
    t = rng.uniform(-3, 3, size=(2000, 3)).astype(np.float32)
    m = rng.random(2000) > 0.1
    q = rng.uniform(-3, 3, size=(256, 3)).astype(np.float32)
    res = t_knn(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(m), 5, 0.5)
    got = compare.check_knn("plain knn", q, t, m, 5, 0.5, res.indices.numpy(), res.distances.numpy(),
                            res.mask.numpy())
    assert got["rows"] == 256 and got["d2_rtol"] <= compare.KNN_D2_RTOL
    # a wrong neighbour outside the margin is caught
    bad = res.indices.numpy().copy()
    row = int(np.flatnonzero(res.mask.numpy()[:, 0])[0])
    bad[row, 0] = (bad[row, 0] + 1) % 2000
    with pytest.raises(AssertionError, match="near-tie margin"):
        compare.check_knn("broken", q, t, m, 5, 0.5, bad, res.distances.numpy(), res.mask.numpy())


@pytest.mark.parametrize("chunk", [1, 7, 64, None])
def test_chunked_knn_equals_unchunked(frames, chunk):
    (_, tgt), (_, src) = frames[0][::-1], frames[1][::-1]  # planar sets
    src = src[:300]
    want = j_icf._knn(src, tgt, 5, 2.0)
    whole = t_icf._knn(src, tgt, 5, 2.0, chunk=len(src))
    got = t_icf._knn(src, tgt, 5, 2.0, chunk=chunk)
    for a, b, c in zip(got, whole, want):
        assert np.array_equal(a, b) and np.array_equal(b, c)


def _assert_oracle_results_equal(a, b):
    assert a.termination == b.termination and len(a.iterations) == len(b.iterations)
    assert np.array_equal(a.q, b.q) and np.array_equal(a.t, b.t)
    for ia, ib in zip(a.iterations, b.iterations):
        for field in ("est_in_q", "est_in_t", "edge_valid", "edge_match", "plane_valid", "plane_match",
                      "delta_q", "delta_t"):
            assert np.array_equal(getattr(ia, field), getattr(ib, field)), field


@pytest.mark.parametrize("overrides,code", [
    ({}, 0), ({"max_iterations": 2, "rotation_convergence_thresh": 0.0,
               "position_convergence_thresh": 0.0}, 1), ({"min_associations": 10**6}, 2)],
    ids=["converged", "max_iter", "insufficient"])
def test_register_oracle_equals_loam_tpu(frames, overrides, code):
    (te, tp), (se, sp) = frames
    rp = J.RegistrationParams(**overrides)
    init = ((0.9999875, 0.0, 0.0, 0.005), (0.04, -0.01, 0.0))
    got = t_oracle.register_oracle(se, sp, te, tp, *init, params=from_reference(rp))
    want = j_icf.register_oracle(se, sp, te, tp, *init, params=rp)
    assert got.termination == code
    _assert_oracle_results_equal(got, want)


@pytest.fixture(scope="module")
def noisy_scene():
    # as tests/test_icf_oracle.py: noise breaks the grid's exact distance ties
    edge, planar = simple_scene(step=0.2)
    rng = np.random.default_rng(9)
    return (edge + rng.normal(scale=0.01, size=edge.shape),
            planar + rng.normal(scale=0.01, size=planar.shape))


def _moved(pts, q, t):
    pose = T.Pose3(torch.tensor(q, dtype=torch.float64), torch.tensor(t, dtype=torch.float64))
    return pose.act(torch.from_numpy(pts)).numpy()


def _register_both(src_e, src_p, edge, planar, params, init_q, init_t):
    fs = lambda e, p: T.feature_set_from_points(e, p, dtype=torch.float64, device="cpu")
    init = T.Pose3(torch.tensor(init_q, dtype=torch.float64), torch.tensor(init_t, dtype=torch.float64))
    est, detail = T.register_features(fs(src_e, src_p), fs(edge, planar), init, params)
    return est, detail, t_oracle.register_oracle(src_e, src_p, edge, planar, init_q, init_t, params)


@pytest.mark.parametrize("case", ["converged", "max_iter", "insufficient"])
def test_port_icf_loop_matches_port_oracle(noisy_scene, case):
    edge, planar = noisy_scene
    q = np.array([0.9995, 0.015, 0.02, 0.01] if case != "max_iter" else [0.999, 0.02, -0.025, 0.015])
    q = q / np.linalg.norm(q)
    t = [0.05, -0.03, 0.02] if case != "max_iter" else [-0.04, 0.06, -0.02]
    src_e, src_p = _moved(edge, q, t), _moved(planar, q, t)
    params, init_t = T.RegistrationParams(), (0.0, 0.0, 0.0)
    if case == "max_iter":  # thresholds of 0 never fire: all iterations run
        params = T.RegistrationParams(rotation_convergence_thresh=0.0, position_convergence_thresh=0.0,
                                      max_iterations=5)
    if case == "insufficient":  # too small a source: bails before solving
        src_e, src_p, init_t = edge[:10], planar[:40], (0.3, -0.1, 0.2)
    est, detail, oracle = _register_both(src_e, src_p, edge, planar, params, (1.0, 0, 0, 0), init_t)
    n = compare.check_icf(case, detail, oracle)
    code = {"converged": T.TerminationType.CONVERGED, "max_iter": T.TerminationType.MAX_ITER,
            "insufficient": T.TerminationType.INSUFFICIENT_ASSOCIATIONS}[case]
    assert oracle.termination == code
    assert n == {"converged": n, "max_iter": 5, "insufficient": 0}[case] and (n > 0) == (case != "insufficient")
    np.testing.assert_allclose(est.rotation.numpy(), oracle.q, atol=1e-8)
    np.testing.assert_allclose(est.translation.numpy(), oracle.t, atol=1e-8)
    gap_m, gap_rad = compare.pose_gap(est.rotation, est.translation, oracle)
    assert gap_m <= 1e-8 and gap_rad <= 1e-8


def test_port_icf_loop_matches_port_oracle_on_scans(frames):
    """A pair of the 16x360 trajectory's feature sets, as the card's check
    runs it at full width: float64 equal per iteration; float32 within the
    odometry tests' 1e-2 m / 1e-3 rad with the oracle's termination."""
    (te, tp), (se, sp) = frames
    rp = T.RegistrationParams()
    _, detail, oracle = _register_both(se, sp, te, tp, rp, (1.0, 0, 0, 0), (0.0, 0, 0))
    assert compare.check_icf("16x360 pair", detail, oracle) > 0
    fs = lambda e, p: T.feature_set_from_points(e, p, dtype=torch.float32, device="cpu")
    est, det32 = T.register_features(fs(se, sp), fs(te, tp), params=rp)
    assert int(det32.termination) == oracle.termination
    gap_m, gap_rad = compare.pose_gap(est.rotation, est.translation, oracle)
    assert gap_m <= 1e-2 and gap_rad <= 1e-3


def test_oracle_imports_no_jax():
    code = ("import sys, loam_tpu_torch.oracle, loam_tpu_torch.oracle.compare, loam_tpu_torch.neighbors; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'loam_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("params", [J.FeatureExtractionParams(), ALT], ids=["default", "alt"])
@pytest.mark.parametrize("precise", [True, False])
def test_double_float_functions_match(params, precise):
    scan = render_scan(LIDAR, noise=0.01, seed=2, dtype=np.float32)
    tl = from_reference(LIDAR)
    tp = T.FeatureExtractionParams(**{**from_reference(params).__dict__, "precise_selection": precise})
    hi, lo = compute_curvature_df(torch.from_numpy(scan), tl, tp)
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == (16, 360)
    jhi, jlo = j_curv_df(jnp.asarray(scan), LIDAR, params)
    got = hi.double().numpy() + lo.double().numpy()
    want = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # the pair is the float64 curvature split in two: hi its rounding, lo
    # the rest to float32's 24 bits, so hi + lo holds ~48 of its 53 bits
    c64 = T.compute_curvature(torch.from_numpy(scan), tl, from_reference(params)).numpy()
    assert np.array_equal(hi.numpy(), c64.astype(np.float32))
    np.testing.assert_allclose(got, c64, rtol=2.0 ** -46, atol=0)
    assert np.array_equal(compute_valid_points_df(torch.from_numpy(scan), tl, tp).numpy(),
                          np.asarray(j_valid_df(jnp.asarray(scan), LIDAR, params)))


@pytest.mark.parametrize("cls", ["edges", "planes"])
def test_associate_takes_neighbor_pts(frames, cls):
    """Coordinates gathered beforehand stand in for ``target_pts[indices]``:
    with the gathered ones the result is the plain call's, with others (the
    targets moved) it follows them, as ``loam_tpu``'s does."""
    (te, tp), (se, sp) = frames
    rp = J.RegistrationParams()
    k, r = ((rp.num_edge_neighbors, rp.max_edge_neighbor_dist) if cls == "edges"
            else (rp.num_plane_neighbors, rp.max_plane_neighbor_dist))
    src, tgt = (se, te) if cls == "edges" else (sp, tp)
    qm, tm = np.ones(len(src), bool), np.ones(len(tgt), bool)
    res = t_knn(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(tm), k, r)
    t_fn = getattr(t_assoc, f"associate_{cls}")
    j_fn = getattr(j_assoc, f"associate_{cls}")
    args = lambda pts, lib: (lib(src), lib(qm), lib(pts), lib(tm))
    plain = t_fn(*args(tgt, torch.from_numpy), from_reference(rp), knn_result=res)
    gathered = torch.from_numpy(tgt)[res.indices.long()]
    same = t_fn(*args(tgt, torch.from_numpy), from_reference(rp), knn_result=res, neighbor_pts=gathered)
    for a, b in zip(plain, same):
        assert torch.equal(a, b)
    shifted = gathered + torch.tensor([0.0, 0.0, 0.25], dtype=torch.float64)
    got = t_fn(*args(tgt, torch.from_numpy), from_reference(rp), knn_result=res, neighbor_pts=shifted)
    j_res = J.neighbors.bruteforce.KnnResult(*(jnp.asarray(x.numpy()) for x in res))
    want = j_fn(*args(tgt, jnp.asarray), rp, knn_result=j_res, neighbor_pts=jnp.asarray(shifted.numpy()))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.match.numpy(), np.asarray(want.match))
    for name in got._fields[:2]:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-4 * 80.0 if cls == "planes" else 1e-9, rtol=0, err_msg=name)
    # the shift moved the fits: the argument was used
    assert not torch.allclose(getattr(got, got._fields[0]), getattr(plain, plain._fields[0]))
