"""The port's loop closure (``loop_closure.py``) against ``loam_tpu``'s on the
same numpy inputs, on the CPU: twins of ``test_loop_closure.py``'s three
cases on the same 17 keyframes of 16x360 around a closed square.

Tolerances. Selections are index-exact: the proposed candidates
``(i, j, valid)`` and the ``accepted`` set. The verified measurements and the
optimized trajectory are float32 registrations and solves, which the two
packages sum in different orders (F6 in ``ROADMAP.md``): within 1e-2 m and
1e-3 rad, the ICF convergence thresholds. ``inlier_frac`` agrees within 0.02
and ``mean_residual`` within 5e-3 m; every candidate's quality must sit
farther than those from its gate (0.35 and 0.25 m), or the accepted sets
could not be held index-exact, and the test says which one does not. The
wrong-minimum twin runs in float64 (its docstring says why), with the same
tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import loam_tpu.loop_closure as jlc
from loam_tpu import LidarParams, extract_features
from loam_tpu.geometry import Pose3 as JPose3
from loam_tpu.geometry import quat_exp as j_quat_exp
from loam_tpu.io import default_world, render_scan

import loam_tpu_torch.loop_closure as tlc
from loam_tpu_torch import FeatureSet, Pose3, extract_features_batch
from loam_tpu_torch.params import from_reference

torch.set_num_threads(1)

LIDAR = LidarParams(16, 360, 0.5, 80.0)
POS_TOL, ROT_TOL = 1e-2, 1e-3
FRAC_TOL, RES_TOL = 0.02, 5e-3
GATES = dict(min_inlier_frac=0.35, max_mean_residual=0.25)


def _square_loop_scans(n_side=4, step=0.5):
    """Keyframes around a small square, ending back at the start (as
    ``test_loop_closure.py`` renders them)."""
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
    scans = [render_scan(LIDAR, p, y, world=world, noise=0.002, seed=i, dtype=np.float32)
             for i, (p, y) in enumerate(zip(positions, yaws))]
    return np.stack(scans), np.stack(positions), np.asarray(yaws)


@pytest.fixture(scope="module")
def loop_data():
    scans, gt_pos, gt_yaw = _square_loop_scans()
    j_feats = jax.vmap(lambda s: extract_features(jnp.asarray(s), LIDAR))(jnp.asarray(scans))
    t_feats = extract_features_batch(torch.from_numpy(scans), from_reference(LIDAR))
    for a, b in zip(j_feats, t_feats):  # the extraction is index-exact
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    z = np.array([0.0, 0.0, 1.0])
    rot = np.stack([np.asarray(j_quat_exp(jnp.asarray(z * y))) for y in gt_yaw]).astype(np.float32)
    return rot, gt_pos.astype(np.float32), j_feats, t_feats


def _both(rot, trans):
    return (JPose3(jnp.asarray(rot), jnp.asarray(trans)),
            Pose3(torch.from_numpy(rot), torch.from_numpy(trans)))


def _check_closures(t, j):
    """Index-exact selections, measurements and quality within tolerance,
    and every candidate clear of the gates by more than the tolerance."""
    for name in ("i", "j", "accepted"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), name)
    np.testing.assert_allclose(t.measurement.translation.numpy(),
                               np.asarray(j.measurement.translation), atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(t.measurement.rotation.numpy(),
                               np.asarray(j.measurement.rotation), atol=ROT_TOL, rtol=0)
    frac, res = t.inlier_frac.numpy(), t.mean_residual.numpy()
    np.testing.assert_allclose(frac, np.asarray(j.inlier_frac), atol=FRAC_TOL, rtol=0)
    np.testing.assert_allclose(res, np.asarray(j.mean_residual), atol=RES_TOL, rtol=0)
    near = (np.abs(frac - GATES["min_inlier_frac"]) <= FRAC_TOL) | (
        np.abs(res - GATES["max_mean_residual"]) <= RES_TOL)
    assert not near.any(), f"candidates {np.flatnonzero(near)} sit within tolerance of a gate"


def test_propose_candidates_finds_revisit(loop_data):
    rot, trans, _, _ = loop_data
    jt, tt = _both(rot, trans)
    kw = dict(max_candidates=4, min_separation=8, max_distance=1.0)
    got = tlc.propose_candidates(tt, **kw)
    want = jlc.propose_candidates(jt, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    i, j, valid = (x.numpy() for x in got)
    assert any(b - a >= 12 for a, b, v in zip(i, j, valid) if v)  # the start/end revisit


def test_end_to_end_loop_closure(loop_data):
    rot, trans, j_feats, t_feats = loop_data
    N = len(trans)
    rng = np.random.default_rng(0)
    drift = np.cumsum(rng.normal(0, 0.01, (N + 1, 3)) * np.array([1, 1, 0.2]), axis=0)
    jt, tt = _both(rot, (trans + drift[:N]).astype(np.float32))
    kw = dict(max_candidates=4, min_separation=8, max_distance=1.5, iterations=8)
    j_opt, j_clo = jlc.optimize_trajectory_with_closures(jt, j_feats, **kw)
    t_opt, t_clo = tlc.optimize_trajectory_with_closures(tt, t_feats, **kw)
    _check_closures(t_clo, j_clo)
    assert t_clo.accepted.any(), "no closure verified"
    np.testing.assert_allclose(t_opt.translation.numpy(), np.asarray(j_opt.translation),
                               atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(t_opt.rotation.numpy(), np.asarray(j_opt.rotation),
                               atol=ROT_TOL, rtol=0)
    t = t_opt.translation.numpy()
    end0 = np.linalg.norm(tt.translation[-1].numpy() - tt.translation[0].numpy())
    end1 = np.linalg.norm(t[-1] - t[0])
    assert end1 < 0.5 * end0 or end1 < 0.02, (end0, end1)


def test_wrong_minimum_closure_rejected(loop_data):
    """A candidate between viewpoints that do not align (offered by a
    collapsed trajectory) is held out by the quality gates; the true revisit
    passes them. In float64: the wrong minimum's float32 registrations
    wander apart (0.12 m between the packages), its float64 ones agree
    within 1e-6 m."""
    rot, trans, j_feats, t_feats = loop_data
    N = len(trans)
    j64 = jax.tree.map(lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, j_feats)
    t64 = FeatureSet(*(x.double() if x.is_floating_point() else x for x in t_feats))
    rot = rot.astype(np.float64)
    one = lambda x: np.asarray([x])
    for traj, i, j in (((rot, np.zeros_like(rot[:, :3])), 0, N // 2),
                       ((rot, trans.astype(np.float64)), 0, N - 1)):
        jt, tt = _both(*traj)
        j_clo = jlc.verify_closures(jt, j64, jnp.asarray(one(i), jnp.int32),
                                    jnp.asarray(one(j), jnp.int32), jnp.asarray([True]))
        t_clo = tlc.verify_closures(tt, t64, torch.tensor(one(i), dtype=torch.int32),
                                    torch.tensor(one(j), dtype=torch.int32), torch.tensor([True]))
        _check_closures(t_clo, j_clo)
        assert bool(t_clo.accepted[0]) == (j == N - 1)
    assert float(t_clo.inlier_frac[0]) > 0.5


def _closure_pair_inputs(loop_data, pairs):
    """Keyframe j's features against keyframe i's for each ``(i, j)`` in
    ``pairs``, at the true relative pose moved by a fixed small offset
    (so the residuals are not all zero): numpy (rotation, translation) and
    the two packages' feature sets, each with a leading pair axis."""
    rot, trans, j_feats, t_feats = loop_data
    off = np.asarray(j_quat_exp(jnp.asarray([0.0, 0.0, 0.01])), np.float32)
    q, t = [], []
    for i, j in pairs:
        inv = tlc.quat_conjugate(torch.from_numpy(rot[i]))
        rel_q = tlc.quat_multiply(inv, torch.from_numpy(rot[j]))  # i_T_j
        rel_t = tlc.quat_rotate(inv, torch.from_numpy(trans[j] - trans[i]))
        q.append(tlc.quat_multiply(torch.from_numpy(off), rel_q).numpy())
        t.append(rel_t.numpy() + np.float32([0.03, -0.02, 0.01]))
    ii, jj = np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])
    j_src, j_tgt = (jax.tree.map(lambda x, s=s: x[s], j_feats) for s in (jj, ii))
    t_src, t_tgt = (t_feats.map(lambda x, s=s: x[torch.from_numpy(s)]) for s in (jj, ii))
    return np.stack(q), np.stack(t), (j_src, j_tgt), (t_src, t_tgt)


def test_closure_quality_unbatched_matches_loam_tpu(loop_data):
    """F10: ``closure_quality`` called as ``loam_tpu`` calls it (one Pose3,
    feature sets without a pair axis) gives two scalars equal to
    ``loam_tpu``'s: the same associations counted (``inlier_frac`` within
    1e-6) and the mean residual within ``RES_TOL`` (the packed and the
    matrix-form fits round differently: 1.3e-4 m apart on this pair)."""
    q, t, (j_src, j_tgt), (t_src, t_tgt) = _closure_pair_inputs(loop_data, [(0, 1)])
    jp, tp = _both(q[0], t[0])
    want = jlc.closure_quality(jp, jax.tree.map(lambda x: x[0], j_src),
                               jax.tree.map(lambda x: x[0], j_tgt))
    got = tlc.closure_quality(tp, t_src.map(lambda x: x[0]), t_tgt.map(lambda x: x[0]))
    for g, w, tol in zip(got, want, (1e-6, RES_TOL)):
        assert g.shape == () == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=0)
    assert 0.5 < float(got[0]) <= 1.0 and float(got[1]) > 0.0


def test_closure_quality_batched_matches_vmap(loop_data):
    """F10: K pairs against ``jax.vmap`` of ``loam_tpu``'s unbatched
    ``closure_quality``, within the unbatched test's tolerances: the port's
    batched call gives (K,) outputs, and its unbatched call on each pair
    (what the vmap maps) the K scalars."""
    pairs = [(0, 1), (3, 4), (0, 16), (5, 9)]
    q, t, (j_src, j_tgt), (t_src, t_tgt) = _closure_pair_inputs(loop_data, pairs)
    jp, tp = _both(q, t)
    want = jax.vmap(jlc.closure_quality)(jp, j_src, j_tgt)
    got = tlc.closure_quality(tp, t_src, t_tgt)
    one = lambda k: tlc.closure_quality(Pose3(tp.rotation[k], tp.translation[k]),
                                        t_src.map(lambda x: x[k]), t_tgt.map(lambda x: x[k]))
    each = [torch.stack(x) for x in zip(*(one(k) for k in range(len(pairs))))]
    for g, e, w, tol in zip(got, each, want, (1e-6, RES_TOL)):
        assert g.shape == e.shape == (len(pairs),) == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=0)
        np.testing.assert_allclose(e.numpy(), np.asarray(w), atol=tol, rtol=0)
