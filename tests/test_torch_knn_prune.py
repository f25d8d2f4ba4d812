"""The kNN kernel's visit pruning in the port against ``loam_tpu``, on the CPU.

``loam_tpu``'s ``_chunk_frames``, ``_tile_gaps`` and ``_pack_active_lists``
are plain jnp and are called directly; ``window_candidates`` and the seed
bounds likewise. Inputs are made from numpy seeds and handed to both.

Tolerances. Active lists, counts, window candidates and their masks, the
inverted boxes of all-invalid chunks and the tile-nonempty flags are exact.
Box directions, box bounds, separations and seed bounds agree at rtol 1e-6,
with an absolute part of 1e-6 times the largest coordinate: a box's
across-wedge bounds sit near 0, where XLA's and PyTorch's summation orders
and XLA's FMA contractions move the same float32 expressions by an ulp of
the coordinates, not of the result. Every seed bound must be at least the
true k-th squared distance of the plain search (the soundness that lets the
kernel's gate skip visits).

On the CPU the plain search visits every slot, so pruning cannot change a
result here; the registration and scan-to-map tests pin that the seed carry
and the prep cache are pure restructurings (poses bit-equal), and that the
bounds they hand the search are sound. The kernel's pruning is held to its
plain version on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import importlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from loam_tpu.map import VoxelMap as JVoxelMap
from loam_tpu.odometry import scan_to_map as j_s2m

import loam_tpu_torch as T
from loam_tpu_torch.io import render_trajectory
from loam_tpu_torch.odometry import scan_to_map as s2m
from loam_tpu_torch.ops import knn_cuda as K
from loam_tpu_torch.registration import icf
from loam_tpu_torch.registration.icf import _register_impl

J = importlib.import_module("loam_tpu.ops.knn_pallas")

# the suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing its cores
torch.set_num_threads(1)

LIDAR = T.LidarParams(16, 360, 0.5, 80.0)
SMALL_MAP = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
RTOL = 1e-6


def _close(a, b, scale):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=RTOL * scale)


@pytest.fixture(scope="module")
def scans():
    s, _ = render_trajectory(LIDAR, 6, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                             noise=0.003, seed=11, dtype=np.float32)
    return s


@pytest.fixture(scope="module")
def feats(scans):
    return T.extract_features_batch(torch.from_numpy(scans[:2]), LIDAR,
                                    post=T.registration.azimuth_sort_features)


# ---- lists, boxes, gaps --------------------------------------------------------


@pytest.mark.parametrize("with_sep2", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_active_lists_index_exact(with_sep2, seed):
    rng = np.random.default_rng(seed)
    T_, C = 9, 37
    active = rng.random((T_, C)) > 0.55
    active[2] = False  # an empty tile
    active[5] = True  # a full one
    sep2 = rng.integers(0, 6, (T_, C)).astype(np.float32)  # many ties
    sep2[7] = 1.5  # one tile all tied
    want_l, want_c = J._pack_active_lists(jnp.asarray(active),
                                          jnp.asarray(sep2) if with_sep2 else None)
    got_l, got_c = K.pack_active_lists(torch.from_numpy(active),
                                       torch.from_numpy(sep2) if with_sep2 else None)
    assert got_l.dtype == torch.int32 and got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    # batched: a leading axis lists each entry alike
    bl, bc = K.pack_active_lists(torch.from_numpy(np.stack([active, active])),
                                 torch.from_numpy(np.stack([sep2, sep2])) if with_sep2 else None)
    assert torch.equal(bl[1], got_l) and torch.equal(bc[0], got_c)


@pytest.mark.parametrize("tt", [128, 256])
def test_chunk_frames_and_tile_gaps_match(feats, tt):
    pts, m = feats.planar_points[0].numpy(), feats.planar_mask[0].numpy()
    m = m.copy()
    m[:tt] = False  # a whole chunk without a valid target: an inverted box
    jp = J.knn_prep(jnp.asarray(pts), jnp.asarray(m), tt=tt)
    tp = K.knn_prep(torch.from_numpy(pts), torch.from_numpy(m), tt)
    assert tp.tt == tt and tp.rot.shape == (1,) + jp.rot.shape and tp.rbox.shape == (1,) + jp.rbox.shape
    scale = float(np.abs(pts[m]).max())
    jr, jb = np.asarray(jp.rot), np.asarray(jp.rbox)
    _close(tp.rot[0], jr, 1.0)
    _close(tp.rbox[0], jb, scale)
    inverted = ~(jb[0] <= jb[1])
    assert inverted.sum() >= 1
    np.testing.assert_array_equal(tp.rbox[0].numpy()[:, inverted], jb[:, inverted])
    np.testing.assert_array_equal(tp.rot[0].numpy()[:, inverted], jr[:, inverted])
    # query tiles of 256 sorted queries (the next frame's), one empty tile
    q = feats.planar_points[1].numpy()
    qm = feats.planar_mask[1].numpy().copy()
    tiles = q.shape[0] // 256
    qch = q[: tiles * 256].T.reshape(3, tiles, 256)
    valid = qm[: tiles * 256].reshape(tiles, 256).copy()
    valid[-1] = False
    qlo = np.where(valid, qch, 3e37).min(-1).astype(np.float32)
    qhi = np.where(valid, qch, -3e37).max(-1).astype(np.float32)
    js, jn = J._tile_gaps(jnp.asarray(qlo), jnp.asarray(qhi), jp.rot, jp.rbox)
    ts, tn = K.tile_gaps(torch.from_numpy(qlo), torch.from_numpy(qhi), tp.rot[0], tp.rbox[0])
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert not tn[-1] and tn.any()
    live = ~inverted[None, :] & tn.numpy()[:, None]
    _close(ts.numpy()[live], np.asarray(js)[live], scale ** 2)
    # the lists the Pallas wrapper builds from them, within the radius
    r2 = 1.0
    act = (ts < r2) & tn[:, None]
    gl, gc = K.pack_active_lists(act, ts)
    wl, wc = J._pack_active_lists(jnp.asarray(np.asarray(js) < r2) & jnp.asarray(jn)[:, None], js)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_dual_prep_boxes_per_class(feats):
    """Each class has its own boxes: the dual prep's are the two single
    preps' side by side, edges first, none straddling the boundary."""
    f = feats.map(lambda x: x[0])
    d = K.knn_dual_prep(f.edge_points, f.edge_mask, f.planar_points, f.planar_mask, tt=128)
    e = K.knn_prep(f.edge_points, f.edge_mask, 128)
    p = K.knn_prep(f.planar_points, f.planar_mask, 128)
    assert torch.equal(d.rot, torch.cat([e.rot, p.rot], -1))
    assert torch.equal(d.rbox, torch.cat([e.rbox, p.rbox], -1))
    assert d.tt == 128 and K._edge_boxes(d) == e.rot.shape[-1]


# ---- seed bounds ----------------------------------------------------------------


@pytest.mark.parametrize("Q,M", [(300, 300), (300, 211), (150, 400), (5, 3)])
def test_window_candidates_exact(Q, M):
    rng = np.random.default_rng(Q + M)
    t = rng.normal(0, 5, (M, 3)).astype(np.float32)
    m = rng.random(M) > 0.3
    want = J.window_candidates(jnp.asarray(t), jnp.asarray(m), Q)
    got = K.window_candidates(torch.from_numpy(t), torch.from_numpy(m), Q)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # batched: each entry alike
    bt = K.window_candidates(torch.from_numpy(np.stack([t, t])), torch.from_numpy(np.stack([m, m])), Q)
    for g, b in zip(got, bt):
        assert torch.equal(b[1], g)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_seed_bounds_match(k):
    rng = np.random.default_rng(k)
    M, Q = 400, 300
    t = rng.uniform(-4, 4, (M, 3)).astype(np.float32)
    t[50:60] = t[40:50]  # duplicated targets: equal candidate distances
    m = rng.random(M) > 0.2
    q = (t[:Q] + rng.normal(0, 0.3, (Q, 3))).astype(np.float32)
    jw = J.window_candidates(jnp.asarray(t), jnp.asarray(m), Q)
    tw = K.window_candidates(torch.from_numpy(t), torch.from_numpy(m), Q)
    want = J.seed_bound_from_window(jnp.asarray(q), *jw, k)
    got = K.seed_bound_from_window(torch.from_numpy(q), *tw, k)
    fin = np.isfinite(np.asarray(want))
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
    _close(got.numpy()[fin], np.asarray(want)[fin], 0.0)
    d2 = rng.uniform(0, 9, (8, Q)).astype(np.float32)
    d2[3] = d2[1]  # ties
    d2[:, :7] = np.inf
    np.testing.assert_allclose(K.kth_smallest_bound(torch.from_numpy(d2), k).numpy(),
                               np.asarray(J.kth_smallest_bound(jnp.asarray(d2), k)), rtol=RTOL)
    # warm start from the neighbours of a plain search at other positions
    prep = K.knn_prep(torch.from_numpy(t), torch.from_numpy(m))
    prev = K.knn_run_reference(prep, torch.from_numpy(q + 0.05), k, 1.0, with_coords=True)
    want = J.seed_bound_from_packed(jnp.asarray(q), *(jnp.asarray(x.numpy()) for x in prev[2:]),
                                    jnp.asarray(prev.mask.numpy()))
    got = K.seed_bound_from_packed(torch.from_numpy(q), prev.xs, prev.ys, prev.zs, prev.mask)
    fin = np.isfinite(np.asarray(want))
    assert fin.any() and not fin.all()
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
    _close(got.numpy()[fin], np.asarray(want)[fin], 0.0)


def _true_kth(t, m, q, k):
    """The k-th smallest d2 over all valid targets (+inf with fewer), plain."""
    prep = K.knn_prep(t, m)
    _, d2, _, _ = K._search_reference(prep, q[None], k, float("inf"), None)
    return d2[0, k - 1]


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), M=st.integers(1, 60), Q=st.integers(1, 60),
       k=st.integers(1, 6), dup=st.booleans(), r=st.sampled_from([0.3, 1.0, 5.0]))
def test_every_seed_bound_is_sound(seed, M, Q, k, dup, r):
    """Window and warm-start bounds are never below the true k-th d2, with
    duplicated targets and with fewer than k targets within the radius."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-2, 2, (M, 3)).astype(np.float32)
    if dup:
        t[M // 2:] = t[: M - M // 2]
    m = torch.from_numpy(rng.random(M) > 0.25)
    t = torch.from_numpy(t)
    q = (t[torch.arange(Q) % M] + torch.from_numpy(rng.normal(0, 0.2, (Q, 3)).astype(np.float32)))
    kth = _true_kth(t, m, q, k)
    wb = K.seed_bound_from_window(q, *K.window_candidates(t, m, Q), k)
    assert bool((wb >= kth).all())
    prev = K.knn_run_reference(K.knn_prep(t, m), q + 0.1, k, r, with_coords=True)
    pb = K.seed_bound_from_packed(q, prev.xs, prev.ys, prev.zs, prev.mask)
    assert bool((pb >= kth).all())
    assert bool((torch.minimum(wb, pb) >= kth).all())


# ---- the seed carry in the ICF loop ---------------------------------------------


def test_seeded_custom_registration_matches_unseeded(scans, monkeypatch):
    """``_register_impl`` with a 3-element ``custom_knn``: the callables get a
    bound every iteration, each sound at the queries it came with, and the
    poses and details equal the run without seeds bit for bit (the twin of
    ``tests/test_knn_pallas.py::test_warm_start_registration_matches_unseeded``)."""
    f = T.extract_features_batch(torch.from_numpy(scans[:3]), LIDAR,
                                 post=T.registration.azimuth_sort_features)
    src, tgt = f.map(lambda x: x[1:3]), f.map(lambda x: x[0:2])  # two pairs in lockstep
    p = T.RegistrationParams()
    E, Q = src.edge_mask.shape[1], src.planar_mask.shape[1]
    e_prep = K.knn_prep(tgt.edge_points, tgt.edge_mask)
    p_prep = K.knn_prep(tgt.planar_points, tgt.planar_mask)
    windows = (K.window_candidates(tgt.edge_points, tgt.edge_mask, E),
               K.window_candidates(tgt.planar_points, tgt.planar_mask, Q))
    seen = []

    def search(prep, pts, mask, k, r, qmask, cls):
        def fn(q, bound=None):
            if bound is not None:
                seen.append((cls, pts, mask, q.clone(), bound.clone(), k))
            return K.knn_run(prep, q, k, r, with_coords=True, query_mask=qmask, seed_bound=bound)
        return fn

    custom = (search(e_prep, tgt.edge_points, tgt.edge_mask, p.num_edge_neighbors,
                     p.max_edge_neighbor_dist, src.edge_mask, "edge"),
              search(p_prep, tgt.planar_points, tgt.planar_mask, p.num_plane_neighbors,
                     p.max_plane_neighbor_dist, src.planar_mask, "planar"), windows)
    init = T.Pose3.identity(torch.float32, (2,))
    runs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("LOAM_KNN_SEED", flag)
        seen.clear()
        runs[flag] = _register_impl(src, tgt, init, p, True, custom_knn=custom)
        if flag == "0":
            assert not seen
    n_it = int(runs["1"][1].num_iterations.max())
    assert n_it >= 2 and len(seen) == 2 * n_it
    for cls, pts, mask, q, bound, k in seen:
        for b in range(2):
            kth = _true_kth(pts[b], mask[b], q[b], k)
            assert bool((bound[b] >= kth).all()), cls
    # the warm start tightens: after the first iteration most searching
    # planar queries have a finite bound
    assert bool(torch.isfinite(seen[-1][4])[src.planar_mask].float().mean() > 0.5)
    (est0, det0), (est1, det1) = runs["0"], runs["1"]
    assert torch.equal(est0.rotation, est1.rotation) and torch.equal(est0.translation, est1.translation)
    for a, b in zip(det0, det1):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    for a, b in zip(det0.iteration_info, det1.iteration_info):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    # ... and the 2-element hook gives the same
    est2, _ = _register_impl(src, tgt, init, p, True, custom_knn=custom[:2])
    assert torch.equal(est2.translation, est1.translation)


# ---- scan-to-map's rebuild-on-insert prep cache ---------------------------------


def _offline(scans, cached, monkeypatch):
    monkeypatch.setattr(s2m, "_use_prep_cache", lambda points: cached)
    return T.scan_to_map_offline(scans, LIDAR, config=SMALL_MAP, device="cpu")


def test_cached_scan_to_map_matches_uncached(scans, monkeypatch):
    """The cache forced on the CPU (as ``tests/test_odometry.py:194-224`` does
    for ``loam_tpu``): the seeded single search through the cached preps,
    poses and maps equal to the uncached run; the final cache equals one
    built fresh from the final maps."""
    reg = T.default_map_reg_params()
    out = {}
    for cached in (True, False):
        state, traj, det = _offline(scans, cached, monkeypatch)
        out[cached] = (state, traj, det)
        assert (len(state.knn_prep_cache) == 16) == cached
    (sc, tc, dc), (su, tu, du) = out[True], out[False]
    assert sc.knn_prep_cache and not su.knn_prep_cache
    np.testing.assert_array_equal(tc.translation.numpy(), tu.translation.numpy())
    np.testing.assert_array_equal(tc.rotation.numpy(), tu.rotation.numpy())
    np.testing.assert_array_equal(dc.termination.numpy(), du.termination.numpy())
    np.testing.assert_array_equal(dc.num_iterations.numpy(), du.num_iterations.numpy())
    for a, b in ((sc.edge_map, su.edge_map), (sc.planar_map, su.planar_map)):
        assert torch.equal(a.points, b.points) and torch.equal(a.mask, b.mask)
    fp = T.FeatureExtractionParams()
    fresh = s2m._build_prep_cache(sc.edge_map, sc.planar_map, fp.edge_capacity(LIDAR),
                                  fp.planar_capacity(LIDAR))
    assert len(fresh) == 16
    for a, b in zip(sc.knn_prep_cache, fresh):
        assert torch.equal(a, b)
    assert reg.search_backend == "bruteforce"


def test_strip_and_rebuild_cache_round_trip(scans, monkeypatch):
    state, _, _ = _offline(scans[:3], True, monkeypatch)
    stripped = T.scan_to_map_strip_cache(state)
    assert stripped.knn_prep_cache == () and torch.equal(stripped.edge_map.points, state.edge_map.points)
    rebuilt = T.scan_to_map_rebuild_cache(stripped, LIDAR)
    assert len(rebuilt.knn_prep_cache) == 16
    for a, b in zip(rebuilt.knn_prep_cache, state.knn_prep_cache):
        assert torch.equal(a, b)
    # where the cache is inactive, the rebuild leaves none
    monkeypatch.setattr(s2m, "_use_prep_cache", lambda points: False)
    assert T.scan_to_map_rebuild_cache(state, LIDAR).knn_prep_cache == ()
    assert T.scan_to_map_init(SMALL_MAP, lidar=LIDAR, device="cpu").knn_prep_cache == ()
    # the cached state resumes from a stripped one with the same poses
    monkeypatch.setattr(s2m, "_use_prep_cache", lambda points: True)
    feats = T.extract_features_batch(torch.from_numpy(scans[3:5]), LIDAR,
                                     post=T.registration.spatial_sort_features)
    a, b = rebuilt, stripped
    for f in range(2):
        a, pa, _ = T.scan_to_map_step_features(a, feats.map(lambda x: x[f]), config=SMALL_MAP)
        b, pb, _ = T.scan_to_map_step_features(b, feats.map(lambda x: x[f]), config=SMALL_MAP)
        assert torch.equal(pa.translation, pb.translation)
    assert len(a.knn_prep_cache) == 16 and b.knn_prep_cache == ()


def test_prep_cache_matches_loam_tpu(scans, monkeypatch):
    """The first 14 entries against ``loam_tpu``'s ``_build_prep_cache``
    called directly on the same maps: planes exact (``loam_tpu`` pads them
    to whole chunks), boxes within the tolerance, windows exact; the last
    two are the live bounds."""
    state, _, _ = _offline(scans[:3], True, monkeypatch)
    fp = T.FeatureExtractionParams()
    qe, qp = fp.edge_capacity(LIDAR), fp.planar_capacity(LIDAR)
    jm = [JVoxelMap(jnp.asarray(m.points.numpy()), jnp.asarray(m.mask.numpy()),
                    jnp.asarray(m.voxel_size.numpy()), jnp.asarray(m.origin.numpy()))
          for m in (state.edge_map, state.planar_map)]
    want = j_s2m._build_prep_cache(jm[0], jm[1], qe, qp)
    got = state.knn_prep_cache
    assert len(want) == 14 and len(got) == 16
    for cls, (tT, rot, rbox), (jt, jr, jb), vmap in (
            ("edge", got[0:3], want[0:3], state.edge_map),
            ("planar", got[3:6], want[3:6], state.planar_map)):
        M = tT.shape[-1]
        np.testing.assert_array_equal(tT[0].numpy(), np.asarray(jt)[:, :M])
        scale = float(vmap.points[vmap.mask].abs().max())
        _close(rot[0], jr, 1.0)
        _close(rbox[0], jb, scale)
    for g, w in zip(got[6:14], want[6:14]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[14].tolist() == [int(state.edge_map.mask.sum())]
    assert got[15].tolist() == [int(state.planar_map.mask.sum())]


# ---- the registration's azimuth reorder where the kernel searches ----------------


@pytest.mark.parametrize("seed", [0, 1])
def test_unpermute_matches_round_trip(seed):
    """Matches of sorted feature sets map back to the caller's slots exactly,
    -1 staying -1 (``loam_tpu`` ``icf.py:617-640``)."""
    rng = np.random.default_rng(seed)
    B, I, Q, M = 2, 3, 40, 25
    s_perm = torch.from_numpy(np.stack([rng.permutation(Q) for _ in range(B)]))
    t_perm = torch.from_numpy(np.stack([rng.permutation(M) for _ in range(B)]))
    want = torch.from_numpy(rng.integers(-1, M, (B, I, Q)).astype(np.int32))
    inv_t = torch.argsort(t_perm, dim=-1)
    sorted_match = torch.full_like(want, -1)
    for b in range(B):
        for r in range(Q):
            m = want[b, :, s_perm[b, r]]
            sorted_match[b, :, r] = torch.where(m >= 0, inv_t[b, m.clamp(min=0).long()].to(torch.int32), -1)
    got = icf._unpermute_matches(sorted_match, s_perm, t_perm)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_reorder_sorts_where_the_kernel_searches(scans, monkeypatch):
    """``reorder_mode="auto"`` where the kernel would search (forced on the
    CPU by patching the registration's ``kernel_takes``): the run equals a
    ``"none"`` run on the azimuth-sorted features bit for bit, with its
    matches mapped back to the caller's slots; on the CPU tensors as they
    are, nothing is sorted."""
    f = T.extract_features_batch(torch.from_numpy(scans[:2]), LIDAR)  # extractor order
    src, tgt = f.map(lambda x: x[1]), f.map(lambda x: x[0])
    p = T.RegistrationParams()
    plain = T.register_features(src, tgt, params=p)
    assert _same_run(plain, T.register_features(src, tgt, params=p, reorder_mode="none"))
    monkeypatch.setattr(icf, "kernel_takes", lambda t: t.dtype == torch.float32)
    est, det = T.register_features(src, tgt, params=p)
    ss, se, sp = icf._sort_features(src.map(lambda x: x[None]), icf._azimuth_key, with_perms=True)
    ts, te, tp = icf._sort_features(tgt.map(lambda x: x[None]), icf._azimuth_key, with_perms=True)
    est_s, det_s = T.register_features(ss.map(lambda x: x[0]), ts.map(lambda x: x[0]), params=p,
                                       reorder_mode="none")
    assert torch.equal(est.rotation, est_s.rotation) and torch.equal(est.translation, est_s.translation)
    # the fits' sums ran in another order than the unsorted run's: it did sort
    assert not torch.equal(est.translation, plain[0].translation)
    assert torch.equal(det.num_iterations, det_s.num_iterations)
    info, info_s = det.iteration_info, det_s.iteration_info
    assert torch.equal(info.edge_match, icf._unpermute_matches(info_s.edge_match[None], se, te)[0])
    assert torch.equal(info.plane_match, icf._unpermute_matches(info_s.plane_match[None], sp, tp)[0])
    assert int((info.plane_match >= 0).sum()) > 0
    with pytest.raises(ValueError):
        T.register_features(src, tgt, params=p, reorder_mode="given")


def _same_run(a, b):
    (ea, da), (eb, db) = a, b
    return (torch.equal(ea.rotation, eb.rotation) and torch.equal(ea.translation, eb.translation)
            and torch.equal(da.iteration_info.plane_match, db.iteration_info.plane_match))
