"""The PyTorch port's foundation against ``loam_tpu``: parameter dataclasses,
geometry, and the JAX-free copies of the synthetic renderer and the metrics.

Inputs come from numpy with a seed and go through both packages. Geometry
runs in float64 on both sides (tolerance 1e-12, both evaluate the same
expressions) unless a test states float32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import loam_tpu.evaluation as jeval
import loam_tpu.geometry as jg
import loam_tpu.params as jp
from loam_tpu.io import synthetic as jsyn

import loam_tpu_torch.evaluation as teval
import loam_tpu_torch.geometry as tg
import loam_tpu_torch.params as tp
from loam_tpu_torch.io import synthetic as tsyn

PARAM_CLASSES = ["LidarParams", "FeatureExtractionParams", "RegistrationParams"]


@pytest.mark.parametrize("name", PARAM_CLASSES)
def test_params_fields_and_defaults_equal(name):
    jf = dataclasses.fields(getattr(jp, name))
    tf = dataclasses.fields(getattr(tp, name))
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        assert a.default == b.default, a.name
    assert getattr(jp, name).__dataclass_params__.frozen


def test_termination_codes_equal():
    for code in ("CONVERGED", "MAX_ITER", "INSUFFICIENT_ASSOCIATIONS"):
        assert getattr(jp.TerminationType, code) == getattr(tp.TerminationType, code)


@pytest.mark.parametrize(
    "ref",
    [
        jp.LidarParams(64, 1024, 0.5, 120.0),
        jp.FeatureExtractionParams(),
        jp.FeatureExtractionParams(neighbor_points=5, number_sectors=4,
                                   precise_selection=False, greedy_nms="xla"),
        jp.RegistrationParams(),
        jp.RegistrationParams(max_iterations=3, prior_weight=300.0,
                              search_backend="grid", enforce_line_condition=True),
    ],
    ids=["lidar", "feat-default", "feat-alt", "reg-default", "reg-alt"],
)
def test_from_reference_round_trips(ref):
    port = tp.from_reference(ref)
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert type(ref)(**dataclasses.asdict(port)) == ref


def test_params_checks_match():
    for cls in ("FeatureExtractionParams",):
        for bad in ({"neighbor_points": 0}, {"number_sectors": 0}, {"sector_sort": "x"}):
            with pytest.raises(ValueError):
                getattr(jp, cls)(**bad)
            with pytest.raises(ValueError):
                getattr(tp, cls)(**bad)
    for bad in ({"lm_impl": "pallas"}, {"search_backend": "kd"}):
        with pytest.raises(ValueError):
            jp.RegistrationParams(**bad)
        with pytest.raises(ValueError):
            tp.RegistrationParams(**bad)
    with pytest.raises(ValueError):
        tp.LidarParams(0, 10, 0.1, 1.0)
    lidar_j, lidar_t = jp.LidarParams(16, 360, 0.5, 80.0), tp.LidarParams(16, 360, 0.5, 80.0)
    fj, ft = jp.FeatureExtractionParams(), tp.FeatureExtractionParams()
    for m in ("points_per_sector", "max_sector_size", "edge_capacity", "planar_capacity"):
        assert getattr(fj, m)(lidar_j) == getattr(ft, m)(lidar_t)


def _rand_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(a, b, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a), b.numpy() if torch.is_tensor(b) else b, atol=atol, rtol=0)


def test_quaternion_ops_match():
    rng = np.random.default_rng(0)
    q1, q2 = _rand_quats(rng, 64), _rand_quats(rng, 64)
    v = rng.normal(size=(64, 3))
    t = torch.from_numpy
    _close(jg.quat_multiply(jnp.asarray(q1), jnp.asarray(q2)), tg.quat_multiply(t(q1), t(q2)))
    _close(jg.quat_normalize(jnp.asarray(3.0 * q1)), tg.quat_normalize(t(3.0 * q1)))
    _close(jg.quat_rotate(jnp.asarray(q1), jnp.asarray(v)), tg.quat_rotate(t(q1), t(v)))
    # exp: include the small-angle Taylor branch
    rv = np.concatenate([rng.normal(size=(32, 3)), 1e-7 * rng.normal(size=(32, 3))])
    _close(jg.quat_exp(jnp.asarray(rv)), tg.quat_exp(t(rv)))
    # log: both hemispheres and the small-angle branch
    qs = np.concatenate([q1, -q1[:8], np.asarray(jg.quat_exp(jnp.asarray(rv[32:])))])
    _close(jg.quat_log(jnp.asarray(qs)), tg.quat_log(t(qs)), atol=1e-10)


def test_se3_exp_log_match():
    rng = np.random.default_rng(1)
    xi = np.concatenate([rng.normal(size=(16, 6)), 1e-6 * rng.normal(size=(16, 6))])
    pj = jg.se3_exp(jnp.asarray(xi))
    pt = tg.se3_exp(torch.from_numpy(xi))
    _close(pj.rotation, pt.rotation)
    _close(pj.translation, pt.translation)
    _close(jg.se3_log(pj), tg.se3_log(pt), atol=1e-10)


def test_pose3_ops_match():
    rng = np.random.default_rng(2)
    a = (_rand_quats(rng, 20), rng.normal(size=(20, 3)))
    b = (_rand_quats(rng, 20), rng.normal(size=(20, 3)))
    p = rng.normal(size=(20, 3))
    ja, jb = jg.Pose3(*map(jnp.asarray, a)), jg.Pose3(*map(jnp.asarray, b))
    ta, tb = tg.Pose3.from_numpy(a), tg.Pose3.from_numpy(b)
    for x, y in zip(ja.compose(jb), ta.compose(tb)):
        _close(x, y)
    for x, y in zip(ja.inverse(), ta.inverse()):
        _close(x, y)
    _close(ja.act(jnp.asarray(p)), ta.act(torch.from_numpy(p)))
    ij, it = jg.Pose3.identity(jnp.float64, (3,)), tg.Pose3.identity(torch.float64, (3,))
    _close(ij.rotation, it.rotation)
    _close(ij.translation, it.translation)


def test_pose_cumcompose_f32():
    # loam_tpu composes with an associative scan (tree order), the port
    # sequentially: float32 rounding differs, stated tolerance 1e-6
    rng = np.random.default_rng(3)
    rv = 0.05 * rng.normal(size=(15, 3))
    tr = 0.1 * rng.normal(size=(15, 3))
    q = np.asarray(jg.quat_exp(jnp.asarray(rv)))
    jr = jg.pose_cumcompose(jg.Pose3(jnp.asarray(q, jnp.float32), jnp.asarray(tr, jnp.float32)))
    trr = tg.pose_cumcompose(tg.Pose3.from_numpy((q, tr), dtype=torch.float32))
    _close(jr.rotation, trr.rotation, atol=1e-6)
    _close(jr.translation, trr.translation, atol=1e-6)


def _spd(rng, n, degenerate=False):
    a = rng.normal(size=(n, 5, 3))
    if degenerate:
        a[: n // 2, :, 2] = 0.0  # rank-2 half: a repeated eigenvalue 0
    return np.einsum("nki,nkj->nij", a, a)


def test_sym3x3_eigensolvers_match():
    rng = np.random.default_rng(4)
    A = _spd(rng, 64, degenerate=True)
    A[0] = 2.0 * np.eye(3)  # p == 0 branch
    ej = jg.sym3x3_eigvalsh(jnp.asarray(A))
    et = tg.sym3x3_eigvalsh(torch.from_numpy(A))
    _close(ej, et, atol=1e-10)
    np.testing.assert_allclose(et.numpy(), np.linalg.eigvalsh(A), atol=1e-8)
    vj = jg.sym3x3_principal_eigvec(jnp.asarray(A[1:]), ej[1:, 2])
    vt = tg.sym3x3_principal_eigvec(torch.from_numpy(A[1:]), et[1:, 2])
    _close(vj, vt, atol=1e-10)
    comps = [A[:, 0, 0], A[:, 0, 1], A[:, 0, 2], A[:, 1, 1], A[:, 1, 2], A[:, 2, 2]]
    cj = jg._sym3x3_eigvalsh_c(*map(jnp.asarray, comps))
    ct = tg._sym3x3_eigvalsh_c(*map(torch.from_numpy, comps))
    for x, y in zip(cj, ct):
        _close(x, y, atol=1e-10)
    wj = jg._sym3x3_eigvec_c(*map(jnp.asarray, comps), cj[0])
    wt = tg._sym3x3_eigvec_c(*map(torch.from_numpy, comps), ct[0])
    for x, y in zip(wj, wt):
        _close(x, y, atol=1e-8)


def _neighborhoods(rng, n, k=5):
    base = rng.uniform(-10, 10, size=(n, 1, 3))
    d = rng.normal(size=(n, 1, 3))
    line = base + np.linspace(-1, 1, k)[None, :, None] * d + 0.01 * rng.normal(size=(n, k, 3))
    mask = rng.random((n, k)) > 0.2
    mask[:, :3] = True
    return line, mask


def test_fit_line_and_plane_match():
    rng = np.random.default_rng(5)
    pts, mask = _neighborhoods(rng, 48)
    pts[24:] += rng.normal(size=(24, 5, 3))  # planar-ish spread
    t = torch.from_numpy
    *ab_j, cond_j = jg.fit_line(jnp.asarray(pts), jnp.asarray(mask))
    *ab_t, cond_t = tg.fit_line(t(pts), t(mask))
    for x, y in zip(ab_j, ab_t):
        _close(x, y, atol=1e-8)
    # the condition number divides by the smallest eigenvalue, near 0 for a
    # line: relative tolerance
    np.testing.assert_allclose(np.asarray(cond_j), cond_t.numpy(), rtol=1e-5)
    # half the neighborhoods are line-like, so their plane normal sits on a
    # near-repeated smallest eigenvalue and amplifies rounding: 1e-6
    for x, y in zip(jg.fit_plane(jnp.asarray(pts), jnp.asarray(mask)), tg.fit_plane(t(pts), t(mask))):
        _close(x, y, atol=1e-6)


def test_fit_packed_forms_match():
    rng = np.random.default_rng(6)
    pts, mask = _neighborhoods(rng, 40)
    pts[20:] += rng.normal(size=(20, 5, 3))
    xs, ys, zs = (np.ascontiguousarray(pts[..., a].T) for a in range(3))  # (K, N)
    m = np.ascontiguousarray(mask.T)
    j = [jnp.asarray(x) for x in (xs, ys, zs, m)]
    t = [torch.from_numpy(x) for x in (xs, ys, zs, m)]
    *ab_j, cond_j = jg.fit_line_packed(*j)
    *ab_t, cond_t = tg.fit_line_packed(*t)
    for x, y in zip(ab_j, ab_t):
        _close(x, y, atol=1e-8)
    np.testing.assert_allclose(np.asarray(cond_j), cond_t.numpy(), rtol=1e-5)
    for x, y in zip(jg.fit_plane_packed(*j), tg.fit_plane_packed(*t)):
        _close(x, y, atol=1e-6)
    # batched (pairs, K, N) layout equals the unbatched one per pair
    tb = [torch.stack([x, x]) for x in t]
    for x, y in zip(tg.fit_plane_packed(*t), tg.fit_plane_packed(*tb)):
        np.testing.assert_array_equal(y[1].numpy(), x.numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_render_trajectory_copy_bit_equal(dtype):
    lj, lt = jp.LidarParams(8, 90, 0.5, 60.0), tp.LidarParams(8, 90, 0.5, 60.0)
    sj, pj = jsyn.render_trajectory(lj, 3, noise=0.01, seed=5, dtype=dtype)
    st, pt = tsyn.render_trajectory(lt, 3, noise=0.01, seed=5, dtype=dtype)
    np.testing.assert_array_equal(sj, st)
    assert sj.dtype == st.dtype
    for (rj, tj), (rt, tt) in zip(pj, pt):
        np.testing.assert_array_equal(rj, rt)
        np.testing.assert_array_equal(tj, tt)


def test_evaluation_copy_bit_equal():
    rng = np.random.default_rng(7)
    est, ref = rng.normal(size=(10, 3)), rng.normal(size=(10, 3))
    qe, qr = _rand_quats(rng, 10), _rand_quats(rng, 10)
    for align in (True, False):
        assert jeval.ate_rmse(est, ref, align=align) == teval.ate_rmse(est, ref, align=align)
    assert jeval.rpe(est, ref, qe, qr, delta=2) == teval.rpe(est, ref, qe, qr, delta=2)
    assert jeval.rpe_rmse(est, ref) == teval.rpe_rmse(est, ref)
    for x, y in zip(jeval.umeyama_alignment(est, ref, True), teval.umeyama_alignment(est, ref, True)):
        np.testing.assert_array_equal(x, y)
