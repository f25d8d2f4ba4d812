"""The port's feature extraction against ``loam_tpu`` and its f64 oracle.

Curvature and validity: the validity mask must be equal, the port's float64
curvature equal to the JAX double-float ``hi + lo`` to rtol 1e-12 (the two
are ~49-bit and 53-bit evaluations of the same expression). Extraction must
be index-exact: feature indices, masks and coordinates.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import loam_tpu.features as jf
from loam_tpu import oracle
from loam_tpu.features.curvature import compute_curvature_df, compute_valid_points_df
from loam_tpu.io import render_scan
from loam_tpu.params import FeatureExtractionParams as JFP
from loam_tpu.params import LidarParams as JLP
from loam_tpu.registration.icf import azimuth_sort_features as j_azimuth

import loam_tpu_torch.features as tf
from loam_tpu_torch.params import from_reference
from loam_tpu_torch.registration import azimuth_sort_features as t_azimuth

# the suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing its cores
torch.set_num_threads(1)

ALT = JFP(neighbor_points=5, number_sectors=4, max_edge_feats_per_sector=3,
          max_planar_feats_per_sector=7, edge_feat_threshold=50.0,
          planar_feat_threshold=2.0, occlusion_thresh=0.3, parallel_thresh=0.5)
REF_TEST = JFP(neighbor_points=5, number_sectors=6, max_edge_feats_per_sector=5,
               max_planar_feats_per_sector=5, edge_feat_threshold=100.0,
               planar_feat_threshold=0.1, occlusion_thresh=0.25, parallel_thresh=0.02)


def _leaves_equal(j, t):
    for name, a, b in zip(j._fields, j, t.to_numpy()):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


@pytest.mark.parametrize("params", [JFP(), ALT], ids=["default", "alt"])
@pytest.mark.parametrize("seed", [0, 1])
def test_curvature_and_validity_match(seed, params):
    lidar = JLP(8, 100, 0.5, 60.0)  # 100 % 6 != 0: a remainder sector
    scan32 = render_scan(lidar, noise=0.01, seed=seed, dtype=np.float32)
    tl, tp = from_reference(lidar), from_reference(params)
    c_t = tf.compute_curvature(torch.from_numpy(scan32), tl, tp)
    v_t = tf.compute_valid_points(torch.from_numpy(scan32), tl, tp)
    assert c_t.dtype == torch.float64 and v_t.dtype == torch.bool
    hi, lo = compute_curvature_df(jnp.asarray(scan32), lidar, params)
    c_j = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    np.testing.assert_allclose(c_t.numpy(), c_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(compute_valid_points_df(jnp.asarray(scan32), lidar, params)))
    s64 = np.asarray(scan32, np.float64)
    np.testing.assert_allclose(c_t.numpy().reshape(-1), oracle.compute_curvature(s64, lidar, params), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(v_t.numpy().reshape(-1), oracle.compute_valid_points(s64, lidar, params))


def _line(pts):
    return np.asarray(pts, np.float64)[None]


# the reference's synthetic-scene unit tests (test_feature_extraction.cpp,
# as ported in tests/test_features.py): same clouds through both packages
REF_CLOUDS = {
    "plane": (_line([[i, 1.0, 0.0] for i in range(-5, 6)]), JLP(1, 11, 0.1, 10.0)),
    "corner": (_line([[i, abs(i) + 1.0, 0.0] for i in range(-5, 6)]), JLP(1, 11, 0.1, 50.0)),
    "ranges": (_line([[i, 1.0, 0.0] for i in range(-5, 0)] + [[-0.5, 20.0, 0.0], [0.0, 0.2, 0.0]]
                     + [[i, 1.0, 0.0] for i in range(1, 6)]), JLP(1, 12, 0.5, 6.0)),
    "occlusion1": (_line([[i * 0.1, 4.0, 0.0] for i in range(-15, 0)] + [[i * 0.1, 6.0, 0.0] for i in range(15)]),
                   JLP(1, 30, 0.1, 100.0)),
    "occlusion2": (_line([[i * 0.1, 6.0, 0.0] for i in range(-15, 0)] + [[i * 0.1, 4.0, 0.0] for i in range(15)]),
                   JLP(1, 30, 0.1, 100.0)),
    "parallel": (_line([[i * 0.1, 2.0, 0.0] for i in range(-15, 0)] + [[0.0, 0.0, 2.05]]
                       + [[i * 0.1, 2.1, 0.0] for i in range(1, 16)]), JLP(1, 31, 0.1, 100.0)),
}


@pytest.mark.parametrize("case", sorted(REF_CLOUDS))
def test_reference_unit_clouds_match(case):
    pts, lidar = REF_CLOUDS[case]
    tl, tp = from_reference(lidar), from_reference(REF_TEST)
    c_j = np.asarray(jf.compute_curvature(jnp.asarray(pts), lidar, REF_TEST))
    v_j = np.asarray(jf.compute_valid_points(jnp.asarray(pts), lidar, REF_TEST))
    np.testing.assert_allclose(tf.compute_curvature(torch.from_numpy(pts), tl, tp).numpy(), c_j, rtol=1e-12, atol=1e-9)
    np.testing.assert_array_equal(tf.compute_valid_points(torch.from_numpy(pts), tl, tp).numpy(), v_j)
    if case == "corner":
        assert abs(tf.compute_curvature(torch.from_numpy(pts), tl, tp)[0, 5].item() - 900.0) < 1e-9


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("precise", [True, False], ids=["precise", "plain"])
@pytest.mark.parametrize("params", [JFP(), ALT], ids=["default", "alt"])
def test_extract_features_index_exact(params, precise, dtype):
    import dataclasses

    params = dataclasses.replace(params, precise_selection=precise)
    lidar = JLP(8, 100, 0.5, 60.0)
    scan = render_scan(lidar, noise=0.01, seed=2, dtype=dtype)
    fj = jf.extract_features(jnp.asarray(scan), lidar, params)
    ft = tf.extract_features(torch.from_numpy(scan), from_reference(lidar), from_reference(params))
    _leaves_equal(fj, ft)
    # f64 math decides the selection whenever the scan is f64 or precise is on
    if precise or dtype == np.float64:
        e_o, p_o = oracle.extract_features(np.asarray(scan, np.float64), lidar, params)
        e, p = ft.compact_indices()
        np.testing.assert_array_equal(e, np.asarray(e_o))
        np.testing.assert_array_equal(p, np.asarray(p_o))
        flat = scan.reshape(-1, 3)
        ep, pp = ft.compact()
        np.testing.assert_array_equal(ep, flat[e])
        np.testing.assert_array_equal(pp, flat[p])


def test_flat_scan_layout_and_shape_errors():
    lidar = JLP(4, 64, 0.5, 60.0)
    scan = render_scan(lidar, noise=0.01, seed=3, dtype=np.float32)
    tl = from_reference(lidar)
    a = tf.extract_features(torch.from_numpy(scan), tl)
    b = tf.extract_features(torch.from_numpy(scan.reshape(-1, 3)), tl)
    for x, y in zip(a.to_numpy(), b.to_numpy()):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        tf.extract_features(torch.zeros(4, 63, 3), tl)


def test_extract_features_batch_with_azimuth_sort_matches():
    from loam_tpu.features import extract_features_batch as j_batch

    lidar = JLP(8, 128, 0.5, 80.0)
    scans = np.stack([render_scan(lidar, noise=0.01, seed=s, dtype=np.float32) for s in range(3)])
    params = JFP()
    fj = j_batch(jnp.asarray(scans), lidar, params, post=j_azimuth)
    ft = tf.extract_features_batch(torch.from_numpy(scans), from_reference(lidar),
                                   from_reference(params), post=t_azimuth)
    _leaves_equal(fj, ft)
    # batch rows equal single-frame extraction (before sorting)
    one = tf.extract_features(torch.from_numpy(scans[1]), from_reference(lidar))
    fb = tf.extract_features_batch(torch.from_numpy(scans), from_reference(lidar))
    for x, y in zip(one.to_numpy(), fb.to_numpy()):
        np.testing.assert_array_equal(x, y[1])


@pytest.mark.slow
def test_f32_full_scale_oracle_parity():
    # the scan of test_features.py::TestOracleParity::test_f32_full_scale_oracle_parity
    # (Ouster-64 scale, default params): PARITY.md records 426 edges and
    # 17,205 planars, index-exact with the f64 oracle
    lidar = JLP(64, 1024, 0.5, 120.0)
    params = JFP()
    scan32 = np.asarray(render_scan(lidar, noise=0.01, seed=7, dtype=np.float32), np.float32)
    fs = tf.extract_features(torch.from_numpy(scan32), from_reference(lidar), from_reference(params))
    got_e, got_p = fs.compact_indices()
    oe, op = oracle.extract_features(np.asarray(scan32, np.float64), lidar, params)
    assert got_e.tolist() == list(oe)
    assert got_p.tolist() == list(op)
    assert (len(got_e), len(got_p)) == (426, 17205)
