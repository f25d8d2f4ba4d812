"""The port against ``loam_tpu`` on ``loam_tpu``'s degenerate inputs and on
scan widths past the CUDA kernels' register forms.

The cases are ``tests/test_edge_cases.py`` and
``tests/test_adversarial_scenes.py`` (inputs in ``torch_edge_scenes.py``):
each goes through both packages on the CPU, on the same numpy inputs, and
must give equal termination codes and iteration counts, poses within 1e-12
in float64 and 1e-6 in float32 (translation in m, quaternion components),
and index-exact feature picks. Each case also keeps the behaviour that
``loam_tpu``'s own test asserts, checked on the port. The wide scans (lines
of 2,083, 3,600 and 8,192 points, sectors of 2,048 and 8,192 slots) are the
shapes that the card's greedy NMS and sector sort take in their memory forms;
here the port runs their plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import loam_tpu as J

import loam_tpu_torch as T
from torch_edge_scenes import EXTRACTION_SCENES, LIDAR, REGISTRATION_SCENES

# the suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing its cores
torch.set_num_threads(1)

#: pose agreement by float type: translation (m) and quaternion components
POSE_TOL = {"float64": 1e-12, "float32": 1e-6}

INSUFFICIENT = int(T.TerminationType.INSUFFICIENT_ASSOCIATIONS)


def _wall_bounded(est, det, normal_tol, free_tol):
    t = est.translation.numpy()
    assert abs(t[0] + 0.05) < normal_tol, t  # the wall's normal, x, is recovered
    assert abs(t[1]) < free_tol and abs(t[2]) < free_tol, t  # y, z stay near the start


def _single_wall(est, det):
    _wall_bounded(est, det, 1e-3, 0.05)
    assert int(det.termination) in (int(T.TerminationType.CONVERGED), int(T.TerminationType.MAX_ITER))


def _far_planes(est, det):
    np.testing.assert_allclose(est.translation.numpy(), [-0.02, 0.01, -0.015], atol=5e-3)


def _solved_at_174(est, det):
    assert int(det.termination) != INSUFFICIENT
    assert int(det.iteration_info.edge_count[0]) + int(det.iteration_info.plane_count[0]) == 174


def _insufficient(est, det):
    # bails before solving: the pose is the start (identity), no iteration
    assert int(det.termination) == INSUFFICIENT
    np.testing.assert_array_equal(est.translation.numpy(), 0.0)
    assert int(det.num_iterations) == 0


def _finite(est, det):
    assert np.isfinite(est.translation.numpy()).all() and np.isfinite(est.rotation.numpy()).all()


#: what loam_tpu's test of each scene asserts, checked on the port's result
EXPECT = {
    "single_wall": _single_wall,
    "single_wall_with_prior": lambda est, det: _wall_bounded(est, det, 2e-3, 1e-2),
    "far_planes_f32": _far_planes,
    "min_associations_174": _solved_at_174,
    "min_associations_175": _insufficient,
    "minimal_line_fit_f64": _finite,
    "minimal_line_fit_f32": _finite,
    "empty_source": _insufficient,
}


@pytest.mark.parametrize("name", sorted(REGISTRATION_SCENES))
def test_registration_scene_matches_loam_tpu(name):
    scene = REGISTRATION_SCENES[name]()
    jdt, tdt = getattr(jnp, scene["dtype"]), getattr(torch, scene["dtype"])
    j_est, j_det = J.register_features(
        J.feature_set_from_points(*scene["source"], dtype=jdt, **scene["capacities"]),
        J.feature_set_from_points(*scene["target"], dtype=jdt), None,
        J.RegistrationParams(**scene["reg"]))
    t_est, t_det = T.register_features(
        T.feature_set_from_points(*scene["source"], dtype=tdt, device="cpu", **scene["capacities"]),
        T.feature_set_from_points(*scene["target"], dtype=tdt, device="cpu"), None,
        T.RegistrationParams(**scene["reg"]))
    assert int(t_det.termination) == int(j_det.termination)
    assert int(t_det.num_iterations) == int(j_det.num_iterations)
    tol = POSE_TOL[scene["dtype"]]
    np.testing.assert_allclose(t_est.translation.numpy(), np.asarray(j_est.translation), atol=tol, rtol=0)
    np.testing.assert_allclose(t_est.rotation.numpy(), np.asarray(j_est.rotation), atol=tol, rtol=0)
    EXPECT[name](t_est, t_det)


def _extract_both(scene):
    """(loam_tpu's (edges, planars), the port's), compact flat indices."""
    scan, lidar, fp = scene["scan"], scene["lidar"], scene["fp"]
    j = J.extract_features(jnp.asarray(scan), J.LidarParams(**lidar), J.FeatureExtractionParams(**fp))
    t = T.extract_features(torch.from_numpy(scan), T.LidarParams(**lidar), T.FeatureExtractionParams(**fp))
    return ([np.asarray(x).tolist() for x in j.compact_indices()],
            [np.asarray(x).tolist() for x in t.compact_indices()])


@pytest.mark.parametrize("name", sorted(EXTRACTION_SCENES))
def test_extraction_scene_matches_loam_tpu(name):
    scene = EXTRACTION_SCENES[name]()
    (je, jp), (te, tp) = _extract_both(scene)
    assert te == je
    assert tp == jp
    fp = T.FeatureExtractionParams(**scene["fp"])
    if name == "all_out_of_range":
        assert te == [] and tp == []
    elif name == "huge_thresholds":
        # caps still honoured: max + 1 a sector a line
        cap = scene["lidar"]["scan_lines"] * fp.number_sectors * (fp.max_planar_feats_per_sector + 1)
        assert te == [] and 0 < len(tp) <= cap
    else:
        assert tp, "no planar features"


def test_flat_and_grid_inputs_agree():
    scene = EXTRACTION_SCENES["one_sector"]()
    lidar = T.LidarParams(**LIDAR)
    scan = torch.from_numpy(scene["scan"])
    a = T.extract_features(scan, lidar)
    b = T.extract_features(scan.reshape(-1, 3), lidar)
    assert torch.equal(a.edge_indices, b.edge_indices)
    assert torch.equal(a.planar_indices, b.planar_indices)
    j = J.extract_features(jnp.asarray(scene["scan"]).reshape(-1, 3), J.LidarParams(**LIDAR))
    np.testing.assert_array_equal(b.edge_indices.numpy(), np.asarray(j.edge_indices))


@pytest.mark.parametrize("make", [
    lambda P: P.FeatureExtractionParams(neighbor_points=0),
    lambda P: P.FeatureExtractionParams(number_sectors=0),
    lambda P: P.LidarParams(0, 128, 0.5, 80.0),
], ids=["neighbor_points_0", "number_sectors_0", "scan_lines_0"])
def test_invalid_params_raise_in_both(make):
    for pkg in (J, T):
        with pytest.raises(ValueError):
            make(pkg)

