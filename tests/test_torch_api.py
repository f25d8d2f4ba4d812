"""The port's public surface against ``loam_tpu``'s, on the CPU: the geometry
and feature helpers (``geometry.py``, ``features/``), the package root's
names, the reference-named API (``compat.py``, ``loam_torch.py``),
checkpoints (``checkpoint.py``), the numerical-health checks (``debug.py``),
the timing helpers (``profiling.py``) and the kNN dispatch by dtype and
``k``.

Tolerances. The geometry helpers evaluate the same expressions in float64:
within 1e-12 of the ``loam_tpu`` twins, and within the golden values'
tolerances of ``tests/test_geometry.py``. Features are index-exact. The
compat registration is a float64 registration in both packages: within
1e-6 m / 1e-6 rad, with equal termination and association counts.
Checkpoints are bit-exact.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import loam_tpu as J
import loam_tpu.geometry as jg
from loam_tpu import checkpoint as j_ckpt
from loam_tpu import compat as j_compat
from loam_tpu.io import render_trajectory

import loam_tpu_torch as T
import loam_tpu_torch.geometry as tg
from loam_tpu_torch import checkpoint as t_ckpt
from loam_tpu_torch import compat as t_compat
from loam_tpu_torch import debug as t_debug
from loam_tpu_torch import profiling as t_prof
from loam_tpu_torch.ops import knn_cuda
from loam_tpu_torch.params import from_reference

torch.set_num_threads(1)

GEO_TOL = 1e-12


# ---- F1: geometry and feature helpers -----------------------------------------------

def _q(*wxyz):
    return torch.tensor(wxyz, dtype=torch.float64)


def test_pose_matrix_golden():
    """``tests/test_geometry.py::test_matrix``'s golden values (GTSAM)."""
    q1 = _q(0.9693342323515085, 0.018781217536151106, 0.15609411554196426, 0.18887307630401792)
    expected = np.array([[0.87992318, -0.360299, 0.30970927, 1.0],
                         [0.37202555, 0.92794845, 0.0225534, -5.0],
                         [-0.29552021, 0.09537451, 0.95056379, 2.0],
                         [0.0, 0.0, 0.0, 1.0]])
    m = tg.Pose3(q1, torch.tensor([1.0, -5.0, 2.0], dtype=torch.float64)).matrix()
    np.testing.assert_allclose(m.numpy(), expected, atol=1e-6)


def test_axis_angle_identity_roundtrip_and_act_matches_matrix():
    p = tg.Pose3(tg.quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64), 0.7),
                 torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64))
    r = p.compose(p.inverse())
    assert float(tg.quat_angular_distance(r.rotation, tg.quat_identity(torch.float64))) < 1e-12
    rng = np.random.default_rng(0)
    v, axis = rng.normal(size=3), rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    p = tg.Pose3(tg.quat_from_axis_angle(torch.from_numpy(axis), 0.9), torch.from_numpy(rng.normal(size=3)))
    np.testing.assert_allclose(p.act(torch.from_numpy(v)).numpy(),
                               (p.matrix().numpy() @ np.append(v, 1.0))[:3], atol=1e-12)


def test_distances_golden():
    """``tests/test_geometry.py``'s closed-form grids
    (``test_geometry.cpp:91-114``)."""
    xs = np.arange(-5, 5, 0.5)
    pts = torch.from_numpy(np.array([[x, y, x + y] for x in xs for y in xs]))
    la, lb = torch.zeros(3, dtype=torch.float64), torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    p = pts.numpy()
    np.testing.assert_allclose(tg.point_to_line_distance(pts, la, lb).numpy(),
                               np.hypot(p[:, 0], p[:, 1]), atol=1e-8)
    n = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    np.testing.assert_allclose(tg.point_to_plane_distance(pts, n, 2.25).numpy(),
                               np.abs(p[:, 0] - 2.25), atol=1e-8)


@pytest.mark.parametrize("name", ["quat_to_matrix", "quat_from_axis_angle", "quat_angular_distance",
                                  "pose_matrix", "pose_from_rotvec", "point_to_line_distance",
                                  "point_to_plane_distance"])
def test_geometry_helpers_match_loam_tpu(name):
    rng = np.random.default_rng(len(name))
    q1, q2 = (rng.normal(size=(5, 4)) for _ in range(2))
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    v, a, b = (rng.normal(size=(5, 3)) * 3 for _ in range(3))
    d = rng.normal(size=5)
    t_, j_ = torch.from_numpy, jnp.asarray
    cases = {
        "quat_to_matrix": (lambda m, c: m.quat_to_matrix(c(q1))),
        "quat_from_axis_angle": (lambda m, c: m.quat_from_axis_angle(c(a / np.linalg.norm(a, axis=1)[:, None]), c(d))),
        "quat_angular_distance": (lambda m, c: m.quat_angular_distance(c(q1), c(q2))),
        "pose_matrix": (lambda m, c: m.Pose3(c(q1), c(v)).matrix()),
        "pose_from_rotvec": (lambda m, c: m.pose_from_rotvec(c(v * 0.3), c(a)).rotation),
        "point_to_line_distance": (lambda m, c: m.point_to_line_distance(c(v), c(a), c(b))),
        "point_to_plane_distance": (lambda m, c: m.point_to_plane_distance(c(v), c(q1[:, 1:]), c(d))),
    }
    got = cases[name](tg, t_).numpy()
    np.testing.assert_allclose(got, np.asarray(cases[name](jg, j_)), atol=GEO_TOL, rtol=0)


def test_feature_helpers_match_loam_tpu():
    rng = np.random.default_rng(5)
    e, p = rng.normal(size=(7, 3)), rng.normal(size=(11, 3))
    jf = J.feature_set_from_points(e, p, edge_capacity=9, planar_capacity=16)
    tf = T.feature_set_from_points(e, p, edge_capacity=9, planar_capacity=16, device="cpu")
    for x, y in zip(tf, jf):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert int(tf.num_edge) == int(jf.num_edge) == 7 and int(tf.num_planar) == 11
    with pytest.raises(ValueError, match="capacity"):
        T.feature_set_from_points(e, p, edge_capacity=3, device="cpu")

    lidar = J.LidarParams(16, 360, 0.5, 80.0)
    scans, _ = render_trajectory(lidar, 1, noise=0.003, seed=2, dtype=np.float64)
    s = scans[0]
    # curvature rounded to a coarse grid: plenty of exact ties for the pick
    curv = np.round(np.asarray(J.compute_curvature(jnp.asarray(s), lidar, J.FeatureExtractionParams())), 2)
    valid = np.array(J.compute_valid_points(jnp.asarray(s), lidar, J.FeatureExtractionParams()))
    want = J.features.extract_features_given(jnp.asarray(s), jnp.asarray(curv), jnp.asarray(valid), lidar)
    got = T.features.extract_features_given(torch.from_numpy(s), torch.from_numpy(curv),
                                            torch.from_numpy(valid), from_reference(lidar))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# ---- F2: the package root ---------------------------------------------------------------

def test_root_exports_every_loam_tpu_name():
    missing = [n for n in J.__all__ if n not in T.__all__ or not hasattr(T, n)]
    assert not missing, missing
    for mod in ("checkpoint", "debug", "evaluation", "loop_closure", "pose_graph"):
        assert getattr(T, mod).__name__ == f"loam_tpu_torch.{mod}"


# ---- F3: the kNN dispatch -----------------------------------------------------------------

def test_knn_dispatch_by_dtype_and_k():
    """The kernel takes float32 CUDA targets at any k (its register lists up
    to 8, its wide form above, which splits no targets); float64 and CPU
    tensors take the plain search (the CUDA side runs in
    ``tests/test_torch_cuda.py``)."""
    cuda = lambda dt: types.SimpleNamespace(is_cuda=True, dtype=dt)
    assert knn_cuda.REGISTER_MAX_K == 8
    assert knn_cuda.kernel_takes(cuda(torch.float32))
    assert not knn_cuda.kernel_takes(cuda(torch.float64))
    assert not knn_cuda.kernel_takes(torch.zeros(3))
    assert knn_cuda._splits(4, ((100, 5000), (300, 9000)), 9) == (1, 1)
    # k above the register lists on a plain search: padded like loam_tpu's
    g = torch.Generator().manual_seed(3)
    t, q = torch.rand((6, 3), generator=g), torch.rand((4, 3), generator=g)
    res = T.knn(q, t, torch.ones(6, dtype=torch.bool), 9)
    want = J.knn(jnp.asarray(q.numpy()), jnp.asarray(t.numpy()), jnp.ones(6, bool), 9)
    np.testing.assert_array_equal(res.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(res.mask.numpy(), np.asarray(want.mask))
    # float32 distances: the two frameworks round the last bit apart
    np.testing.assert_allclose(res.distances.numpy(), np.asarray(want.distances), rtol=1e-6)


# ---- compat ---------------------------------------------------------------------------------

def test_compat_quaternion_and_pose():
    for loam in (t_compat, j_compat):
        q = loam.Quaterniond(1.0, 0.0, 0.0, 0.0)
        assert q.w() == 1.0 and q.z() == 0.0
        p2 = loam.Pose3d(loam.Quaterniond(0.9, 0.1, -0.3, 0.2), np.array([1.0, 2.0, 3.0]))
        p2.rotation = loam.Quaterniond._from_wxyz(p2.rotation._wxyz / np.linalg.norm(p2.rotation._wxyz))
        assert np.allclose(p2.compose(p2.inverse()).translation, 0, atol=1e-12)
    tp = t_compat.Pose3d(t_compat.Quaterniond(0.9, 0.1, -0.3, 0.2), np.array([1.0, 2.0, 3.0]))
    jp = j_compat.Pose3d(j_compat.Quaterniond(0.9, 0.1, -0.3, 0.2), np.array([1.0, 2.0, 3.0]))
    np.testing.assert_allclose(tp.compose(tp).translation, jp.compose(jp).translation, atol=GEO_TOL)
    np.testing.assert_allclose(tp.inverse().rotation._wxyz, jp.inverse().rotation._wxyz, atol=GEO_TOL)
    np.testing.assert_allclose(tp.act(np.ones(3)), jp.act(np.ones(3)), atol=GEO_TOL)
    np.testing.assert_allclose(tp.matrix(), jp.matrix(), atol=GEO_TOL)
    assert set(j_compat.__all__) == set(t_compat.__all__)


def test_compat_readme_flow_matches_loam_tpu():
    """The README's flow through the reference names, in both packages, on
    the same float64 scans."""
    import loam_torch

    assert loam_torch.registerFeatures is t_compat.registerFeatures
    lidar = t_compat.LidarParams(16, 256, 0.5, 80.0)
    scans, _ = render_trajectory(J.LidarParams(16, 256, 0.5, 80.0), 2, noise=0.004, seed=3,
                                 dtype=np.float64)
    out = {}
    for name, loam, lp in (("t", t_compat, lidar), ("j", j_compat, J.LidarParams(16, 256, 0.5, 80.0))):
        kw = {"device": "cpu"} if name == "t" else {}
        fp = loam.FeatureExtractionParams()
        fp.number_sectors = 6
        prev = loam.extractFeatures(scans[0].reshape(-1, 3), lp, fp, **kw)
        curr = loam.extractFeatures(scans[1].reshape(-1, 3), lp, fp, **kw)
        detail = loam.RegistrationDetail()
        pose = loam.registerFeatures(curr, prev, loam.Pose3d.Identity(), loam.RegistrationParams(),
                                     detail, **kw)
        curv = loam.computeCurvature(scans[0].reshape(-1, 3), lp, **kw)
        valid = loam.computeValidPoints(scans[0].reshape(-1, 3), lp, **kw)
        out[name] = (prev, curr, pose, detail, curv, valid)
    (tp_, tc, tpose, tdet, tcurv, tvalid), (jp_, jc, jpose, jdet, jcurv, jvalid) = out["t"], out["j"]
    for a, b in ((tp_, jp_), (tc, jc)):
        np.testing.assert_array_equal(a.edge_points, b.edge_points)
        np.testing.assert_array_equal(a.planar_points, b.planar_points)
    assert tvalid == jvalid and isinstance(tvalid[0], bool)
    np.testing.assert_allclose(tcurv, jcurv, rtol=1e-12, atol=1e-12)
    assert tdet.termination_type == jdet.termination_type == t_compat.CONVERGED
    assert len(tdet.iteration_info) == len(jdet.iteration_info) >= 1
    for a, b in zip(tdet.iteration_info, jdet.iteration_info):
        assert len(a.edge_associations) == len(b.edge_associations)
        assert len(a.plane_associations) == len(b.plane_associations)
    s, t = tdet.iteration_info[0].plane_associations[0]
    assert isinstance(s, int) and isinstance(t, int)
    np.testing.assert_allclose(tpose.translation, jpose.translation, atol=1e-6)
    np.testing.assert_allclose(tpose.rotation._wxyz, jpose.rotation._wxyz, atol=1e-6)


# ---- checkpoints ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mapped_states():
    """A ``loam_tpu`` scan-to-map state after two frames, its port twin
    (``from_numpy``) and both packages' fresh templates."""
    cfg = dict(edge_capacity=512, planar_capacity=2048)
    lidar = J.LidarParams(8, 128, 0.5, 80.0)
    scans, _ = render_trajectory(lidar, 2, noise=0.003, seed=4, dtype=np.float32)
    j_tpl = J.scan_to_map_strip_cache(J.scan_to_map_init(J.ScanToMapConfig(**cfg)))
    js = j_tpl
    for s in scans:
        js, _, _ = J.scan_to_map_step(js, jnp.asarray(s), lidar)
    js = J.scan_to_map_strip_cache(js)
    t_tpl = T.scan_to_map_init(T.ScanToMapConfig(**cfg), device="cpu")
    ts = T.ScanToMapState.from_numpy(js, device="cpu")._replace(dropped=torch.tensor(3, dtype=torch.int32))
    return js, j_tpl, ts, t_tpl


def _leaves(state):
    return [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
            for _, x in t_ckpt._flatten(state)]


def test_checkpoint_schema_matches_loam_tpu(tmp_path, mapped_states):
    js, _, ts, _ = mapped_states
    j_names, _ = j_ckpt._leaf_names(js)
    t_names, _ = t_ckpt._leaf_names(ts._replace(dropped=None))
    assert t_names == j_names
    tree = {"b": torch.zeros(2), "a": (torch.ones(1), T.Pose3.identity(device="cpu"))}
    jtree = {"b": jnp.zeros(2), "a": (jnp.ones(1), J.Pose3.identity())}
    assert t_ckpt._leaf_names(tree)[0] == j_ckpt._leaf_names(jtree)[0]


def test_checkpoint_roundtrip_and_cross_load(tmp_path, mapped_states):
    js, j_tpl, ts, t_tpl = mapped_states
    # the port's own round trip keeps its extra leaf
    p = str(tmp_path / "port.npz")
    t_ckpt.save(p, ts)
    back = t_ckpt.load(p, t_tpl)
    assert int(back.dropped) == 3 and back.edge_map.points.device.type == "cpu"
    for a, b in zip(_leaves(back), _leaves(ts)):
        np.testing.assert_array_equal(a, b)
    # loam_tpu's file loads into the port's template (no dropped leaf there)
    pj = str(tmp_path / "jax.npz")
    j_ckpt.save(pj, js)
    from_j = t_ckpt.load(pj, t_tpl)
    assert from_j.dropped == t_tpl.dropped
    for a, b in zip(_leaves(from_j._replace(dropped=None)), _leaves(ts._replace(dropped=None))):
        np.testing.assert_array_equal(a, b)
    # the port's file without its extra leaf loads into loam_tpu's template
    pt = str(tmp_path / "for_jax.npz")
    t_ckpt.save(pt, ts._replace(dropped=None))
    into_j = j_ckpt.load(pt, j_tpl)
    for a, b in zip(j_ckpt._leaf_names(into_j)[1], j_ckpt._leaf_names(js)[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a restored state steps on
    lidar = T.LidarParams(8, 128, 0.5, 80.0)
    scans, _ = render_trajectory(J.LidarParams(8, 128, 0.5, 80.0), 3, noise=0.003, seed=4,
                                 dtype=np.float32)
    _, pose, _ = T.scan_to_map_step(back, torch.from_numpy(scans[2]), lidar)
    assert torch.isfinite(pose.translation).all()


def test_checkpoint_nested_state_cross_loads(tmp_path, mapped_states):
    """A state inside a nest (a tuple beside a pose, a dict) saved by
    ``loam_tpu`` loads into the port's template: the missing ``dropped``
    leaf is matched by its field name, whatever the path before it."""
    js, j_tpl, ts, t_tpl = mapped_states
    pose_j, pose_t = J.Pose3.identity(), T.Pose3.identity(device="cpu")
    for j_tree, t_tree in (((js, pose_j), (t_tpl, pose_t)), ({"s": js}, {"s": t_tpl})):
        p = str(tmp_path / "nested.npz")
        j_ckpt.save(p, j_tree)
        got = t_ckpt.load(p, t_tree)
        state = got[0] if isinstance(got, tuple) else got["s"]
        assert state.dropped == t_tpl.dropped
        for a, b in zip(_leaves(state._replace(dropped=None)), _leaves(ts._replace(dropped=None))):
            np.testing.assert_array_equal(a, b)


def test_checkpoint_schema_mismatch_rejected(tmp_path):
    p = str(tmp_path / "x.npz")
    t_ckpt.save(p, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        t_ckpt.load(p, {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError):
        t_ckpt.load(p, {"c": torch.zeros(3)})


# ---- debug and profiling ----------------------------------------------------------------------

def test_check_finite_names_offending_leaves():
    t_debug.check_finite({"a": torch.ones(3), "b": np.zeros((2, 2))})
    tree = {"good": torch.ones(4), "bad": torch.tensor([1.0, float("nan"), float("inf")]),
            "ints": torch.arange(3)}
    with pytest.raises(FloatingPointError) as e:
        t_debug.check_finite(tree, where="unit")
    msg = str(e.value)
    assert "[unit]" in msg and "['bad']: 2 non-finite of 3" in msg and "good" not in msg


def test_tap_finite_gated(monkeypatch):
    monkeypatch.delenv("LOAM_DEBUG_NANS", raising=False)
    assert not t_debug.debug_nans_enabled()
    bad = {"x": torch.tensor([float("nan"), 1.0])}
    t_debug.tap_finite(bad, where="noop")  # off: passes silently
    t_debug.tap_finite({"x": torch.ones(2)}, force=True)  # clean: no raise
    with pytest.raises(FloatingPointError, match="non-finite"):
        t_debug.tap_finite(bad, where="forced", force=True)
    monkeypatch.setenv("LOAM_DEBUG_NANS", "1")
    with pytest.raises(FloatingPointError, match="non-finite"):
        t_debug.tap_finite(bad)


def test_registration_tap_fires_on_poisoned_state(monkeypatch):
    """With ``LOAM_DEBUG_NANS=1`` the ICF loop's tap reports a non-finite
    initial pose; a NaN source point is scrubbed by the association guards
    and stays quiet (twins of ``test_debug.py``'s two registration cases)."""
    monkeypatch.setenv("LOAM_DEBUG_NANS", "1")
    rng = np.random.default_rng(1)
    tgt_e = rng.normal(size=(41, 3)).astype(np.float32)
    tgt_p = rng.normal(size=(163, 3)).astype(np.float32)
    params = T.RegistrationParams(min_associations=5)
    tgt = T.feature_set_from_points(tgt_e, tgt_p, device="cpu")
    src_p = tgt_p.copy()
    src_p[0, 0] = np.nan
    pose, _ = T.register_features(T.feature_set_from_points(tgt_e.copy(), src_p, device="cpu"),
                                  tgt, None, params)
    t_debug.check_finite({"pose": pose}, where="scrubbed")
    bad_init = T.Pose3(torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.tensor([float("nan"), 0.0, 0.0]))
    with pytest.raises(FloatingPointError, match="icf.iteration"):
        T.register_features(T.feature_set_from_points(tgt_e, tgt_p, device="cpu"), tgt, bad_init, params)


def test_profiling_helpers(tmp_path):
    x = torch.arange(1000, dtype=torch.float32)
    s = t_prof.device_time(lambda a, k: torch.sort(a * k)[0], x, 2.0, n_inner=3, reps=2)
    assert 0 < s < 1.0
    t_prof.force({"a": x, "b": (x, None)})
    with t_prof.trace(str(tmp_path / "tr")) as prof:
        torch.sort(x)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any("sort" in e.key for e in prof.key_averages())
