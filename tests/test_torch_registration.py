"""The port's registration (association, LM solve, ICF loop) against
``loam_tpu`` on identical feature sets.

The feature sets come from ``loam_tpu``'s extraction of the
``test_odometry.py`` trajectory and cross over with
``FeatureSet.from_numpy``. Both packages then run in float64: in float32,
planar neighborhoods that lie on one scan line are nearly collinear, their
plane normal sits on a near-repeated eigenvalue, and the two packages'
different summation orders move such normals far enough to shift a pose by
~1e-3 m. In float64 the poses must agree within 1e-5 rad and 1e-4 m, and
termination codes and iteration counts must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import loam_tpu as J
from loam_tpu.features import extract_features_batch as j_batch
from loam_tpu.io import render_trajectory
from loam_tpu.ops.knn_pallas import PackedKnn as JPackedKnn
from loam_tpu.registration import associate as j_assoc
from loam_tpu.registration import solver as j_solver
from loam_tpu.registration.icf import azimuth_sort_features as j_azimuth

import loam_tpu_torch as T
from loam_tpu_torch.ops import knn_cuda
from loam_tpu_torch.params import from_reference
from loam_tpu_torch.registration import associate as t_assoc
from loam_tpu_torch.registration import solver as t_solver

# the suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing its cores
torch.set_num_threads(1)

LIDAR = J.LidarParams(16, 360, 0.5, 80.0)
ROT_TOL, POS_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def frames():
    scans, _ = render_trajectory(LIDAR, 4, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float32)
    fs = j_batch(jnp.asarray(scans), LIDAR, J.FeatureExtractionParams(), post=j_azimuth)
    return [np.asarray(x) for x in fs]


def _pair(frames, i):
    """(jax source, jax target, port source, port target), float64."""
    src = [x[i + 1] for x in frames]
    tgt = [x[i] for x in frames]
    up = lambda leaves: [x.astype(np.float64) if x.dtype == np.float32 else x for x in leaves]
    js, jt = J.FeatureSet(*map(jnp.asarray, up(src))), J.FeatureSet(*map(jnp.asarray, up(tgt)))
    ts = T.FeatureSet.from_numpy(js, dtype=torch.float64, device="cpu")
    tt = T.FeatureSet.from_numpy(jt, dtype=torch.float64, device="cpu")
    return js, jt, ts, tt


def _moved(fs, angle=0.01, shift=(0.05, -0.02, 0.0)):
    q = np.array([np.cos(angle / 2), 0.0, 0.0, np.sin(angle / 2)])
    pose = J.Pose3(jnp.asarray(q), jnp.asarray(shift, jnp.float64))
    return pose, np.asarray(pose.act(fs.edge_points)), np.asarray(pose.act(fs.planar_points))


def _assert_assoc(ja, ta, atols):
    """Masks and matches exact; the two fit fields to ``atols``."""
    np.testing.assert_array_equal(ta.valid.numpy(), np.asarray(ja.valid))
    np.testing.assert_array_equal(ta.match.numpy(), np.asarray(ja.match))
    for name, atol in zip(ja._fields[:2], atols):
        np.testing.assert_allclose(getattr(ta, name).numpy(), np.asarray(getattr(ja, name)),
                                   atol=atol, rtol=0, err_msg=name)


# Line fits take the principal eigenvector: well conditioned, 1e-9. Plane
# fits take the smallest eigenvalue's vector from the trigonometric closed
# form, whose small eigenvalues carry ~sqrt(eps) relative error; for the
# many nearly collinear neighborhoods (consecutive points of one scan line
# on a wall) the gap to the next eigenvalue is ~noise^2, so an ulp of
# difference upstream moves the normal by up to ~3e-5 in float64 (measured)
# and the offset d = n . centroid by that times the range (<= 80 m here).
EDGE_ATOLS = (1e-9, 1e-9)
PLANE_ATOLS = (1e-4, 1e-4 * 80.0)


def test_associate_gathered_path_matches(frames):
    js, jt, ts, tt = _pair(frames, 0)
    rp = J.RegistrationParams()
    trp = from_reference(rp)
    _, qe, qp = _moved(js)
    ja = j_assoc.associate_edges(jnp.asarray(qe), js.edge_mask, jt.edge_points, jt.edge_mask, rp)
    ta = t_assoc.associate_edges(torch.from_numpy(qe), ts.edge_mask, tt.edge_points, tt.edge_mask, trp)
    _assert_assoc(ja, ta, EDGE_ATOLS)
    jp = j_assoc.associate_planes(jnp.asarray(qp), js.planar_mask, jt.planar_points, jt.planar_mask, rp)
    tp = t_assoc.associate_planes(torch.from_numpy(qp), ts.planar_mask, tt.planar_points, tt.planar_mask, trp)
    _assert_assoc(jp, tp, PLANE_ATOLS)
    assert int(tp.valid.sum()) > 100


@pytest.mark.parametrize("enforce", [False, True])
def test_associate_packed_path_matches(frames, enforce):
    """The same PackedKnn (the port's search, itself equal to the Pallas
    kernel in test_torch_kernels.py) through both packages' packed fits."""
    js, jt, ts, tt = _pair(frames, 1)
    rp = J.RegistrationParams(enforce_line_condition=enforce)
    trp = from_reference(rp)
    _, qe, qp = _moved(js)
    for cls, k, r, j_fn, t_fn, q in (
        ("edge", rp.num_edge_neighbors, rp.max_edge_neighbor_dist,
         j_assoc.associate_edges, t_assoc.associate_edges, qe),
        ("planar", rp.num_plane_neighbors, rp.max_plane_neighbor_dist,
         j_assoc.associate_planes, t_assoc.associate_planes, qp),
    ):
        prep = knn_cuda.knn_prep(getattr(tt, f"{cls}_points"), getattr(tt, f"{cls}_mask"))
        pk = knn_cuda.knn_run(prep, torch.from_numpy(q), k, r, with_coords=True,
                              query_mask=getattr(ts, f"{cls}_mask"))
        jpk = JPackedKnn(*(jnp.asarray(x.numpy()) for x in pk))
        args = lambda m, pts: (getattr(m, f"{cls}_mask"), getattr(pts, f"{cls}_points"), getattr(pts, f"{cls}_mask"))
        ja = j_fn(jnp.asarray(q), *args(js, jt), rp, knn_result=jpk)
        ta = t_fn(torch.from_numpy(q), *args(ts, tt), trp, knn_result=pk)
        _assert_assoc(ja, ta, PLANE_ATOLS if cls == "planar" else EDGE_ATOLS)


def test_lm_solve_matches(frames):
    js, jt, ts, tt = _pair(frames, 2)
    rp = J.RegistrationParams(prior_weight=10.0)
    trp = from_reference(rp)
    init, qe, qp = _moved(js)
    ja = j_assoc.associate_edges(jnp.asarray(qe), js.edge_mask, jt.edge_points, jt.edge_mask, rp)
    jpl = j_assoc.associate_planes(jnp.asarray(qp), js.planar_mask, jt.planar_points, jt.planar_mask, rp)
    ta = t_assoc.EdgeAssociations(*(torch.from_numpy(np.asarray(x)) for x in ja))
    tpl = t_assoc.PlaneAssociations(*(torch.from_numpy(np.asarray(x)) for x in jpl))
    offset_j = init.compose(init)
    offset_t = T.Pose3.from_numpy(offset_j, device="cpu")
    dj, cj = j_solver.lm_solve(j_solver._Problem(jnp.asarray(qe), ja, jnp.asarray(qp), jpl, offset_j), rp)
    dt, ct = t_solver.lm_solve(t_solver._Problem(torch.from_numpy(qe), ta, torch.from_numpy(qp), tpl, offset_t), trp)
    np.testing.assert_allclose(dt.rotation.numpy(), np.asarray(dj.rotation), atol=1e-9)
    np.testing.assert_allclose(dt.translation.numpy(), np.asarray(dj.translation), atol=1e-9)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-9)


def _compare_registration(pj, dj, pt, dt):
    np.testing.assert_allclose(pt.rotation.numpy(), np.asarray(pj.rotation), atol=ROT_TOL, rtol=0)
    np.testing.assert_allclose(pt.translation.numpy(), np.asarray(pj.translation), atol=POS_TOL, rtol=0)
    assert int(dt.termination) == int(dj.termination)
    assert int(dt.num_iterations) == int(dj.num_iterations)
    n = int(dj.num_iterations)
    ij, it = dj.iteration_info, dt.iteration_info
    np.testing.assert_array_equal(it.edge_count.numpy()[:n], np.asarray(ij.edge_count)[:n])
    np.testing.assert_array_equal(it.plane_count.numpy()[:n], np.asarray(ij.plane_count)[:n])
    np.testing.assert_allclose(it.estimate_update.translation.numpy()[:n],
                               np.asarray(ij.estimate_update.translation)[:n], atol=POS_TOL)


@pytest.mark.parametrize("pair", [0, 1, 2])
def test_register_features_matches(frames, pair):
    js, jt, ts, tt = _pair(frames, pair)
    rp = J.RegistrationParams()
    pj, dj = J.register_features(js, jt, params=rp)
    pt, dt = T.register_features(ts, tt, params=from_reference(rp))
    _compare_registration(pj, dj, pt, dt)
    assert int(dt.termination) == J.TerminationType.CONVERGED
    n = int(dj.num_iterations)
    np.testing.assert_array_equal(dt.iteration_info.edge_match.numpy()[:n],
                                  np.asarray(dj.iteration_info.edge_match)[:n])


@pytest.mark.parametrize(
    "overrides,code",
    [({"min_associations": 10**6}, 2), ({"max_iterations": 1}, 1)],
    ids=["insufficient", "max_iter"],
)
def test_register_termination_codes_match(frames, overrides, code):
    js, jt, ts, tt = _pair(frames, 0)
    rp = J.RegistrationParams(**overrides)
    init = J.Pose3(jnp.asarray([1.0, 0.0, 0.0, 0.0]), jnp.asarray([0.05, 0.0, 0.0]))
    pj, dj = J.register_features(js, jt, init, params=rp)
    pt, dt = T.register_features(ts, tt, T.Pose3.from_numpy(init, device="cpu"), params=from_reference(rp))
    _compare_registration(pj, dj, pt, dt)
    assert int(dt.termination) == code
    if code == 2:  # bails before solving: the initial estimate, no records
        assert int(dt.num_iterations) == 0
        np.testing.assert_array_equal(pt.translation.numpy(), [0.05, 0.0, 0.0])


def test_register_batch_equals_single(frames):
    pairs = [_pair(frames, i) for i in range(3)]
    rp = from_reference(J.RegistrationParams())
    stack = lambda sets: T.FeatureSet(*(torch.stack(x) for x in zip(*sets)))
    init = T.Pose3.identity(torch.float64, (3,))
    pb, db = T.register_features_batch(stack([p[2] for p in pairs]), stack([p[3] for p in pairs]), init, rp)
    for i, (_, _, ts, tt) in enumerate(pairs):
        ps, ds = T.register_features(ts, tt, params=rp, with_matches=False)
        # batched reductions may associate differently: float64 rounding only
        np.testing.assert_allclose(pb.translation[i].numpy(), ps.translation.numpy(), atol=1e-12)
        np.testing.assert_allclose(pb.rotation[i].numpy(), ps.rotation.numpy(), atol=1e-12)
        assert int(db.num_iterations[i]) == int(ds.num_iterations)
