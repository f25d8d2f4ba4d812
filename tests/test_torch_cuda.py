"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test carries the ``cuda`` marker and skips without a CUDA device: the
kernels have no CPU mode. The file imports neither JAX nor ``loam_tpu``, so
on a machine without JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts= -m cuda -q

Selections (sort positions, NMS picks, kNN indices and masks, copied
coordinates) and kNN squared distances must be exactly equal: the kNN kernels
round every step of the distance on their own, as the plain versions do,
and (d2, index) is a total order, so neither the live-target bound nor the
target splits may change an output.
The scan-to-map run on the GPU agrees with the same run on the CPU within
1e-2 m (the ICF position convergence threshold).
"""

import contextlib

import numpy as np
import pytest
import torch

from torch_edge_scenes import EXTRACTION_SCENES, REGISTRATION_SCENES
from torch_nms_cases import NMS_CASES, random_candidates as _candidates
from torch_sort_cases import SORT_CASES, corner_values

from loam_tpu_torch.ops import assemble_cuda, bitonic_cuda, knn_cuda, nms_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,S", [(1024, 6), (100, 6), (64, 1)])
def test_sector_sort_matches_plain(dev, dtype, P, S):
    rng = np.random.default_rng(P + S)
    # rounded values: plenty of exact ties, which the position key orders
    curv = np.round(rng.exponential(2.0, size=(64, P)), 1)
    curv[:, :3] = -1.0
    c = torch.from_numpy(curv).to(dev, dtype)
    before = bitonic_cuda.sector_sort.launches
    a = bitonic_cuda.sector_sort(c, S)
    b = bitonic_cuda.sector_sort_reference(c, S)
    assert bitonic_cuda.sector_sort.launches == before + 1
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_sector_sort_matches_plain_at_kernel_branches(dev, case, dtype):
    """Ties, -0.0, NaN, +inf in real slots and every padded width (32 to
    1,024 slots): positions equal, keys equal bit for bit (-0.0 stays -0.0,
    a NaN keeps its payload)."""
    make, S, _ = SORT_CASES[case]
    c = torch.from_numpy(make()).to(dev, dtype)
    (ka, pa), (kb, pb) = bitonic_cuda.sector_sort(c, S), bitonic_cuda.sector_sort_reference(c, S)
    assert torch.equal(pa, pb)
    as_bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(ka.view(as_bits), kb.view(as_bits))


@pytest.mark.parametrize("lines", [1, 3, 64, 512, 1024])
def test_sector_sort_line_counts(dev, lines):
    """One line, three, one frame, a streaming chunk and 16 frames of
    64x1024 (6 sectors of 174 slots in 256)."""
    g = torch.Generator().manual_seed(lines)
    c = torch.randn((lines, 1024), generator=g, dtype=torch.float64).round(decimals=1).to(dev)
    for x, y in zip(bitonic_cuda.sector_sort(c, 6), bitonic_cuda.sector_sort_reference(c, 6)):
        assert torch.equal(x, y)


@pytest.mark.parametrize(
    "L,P,S,max_e,max_p,n",
    [(32, 1024, 6, 10, 50, 3), (9, 100, 4, 2, 5, 1),
     # one line; one frame; lines not a multiple of the warps a block
     (1, 1024, 6, 10, 50, 3), (64, 1024, 6, 10, 50, 3), (7, 360, 6, 10, 50, 3),
     # two mask words a lane, and a window that covers whole words there
     (5, 2048, 6, 10, 50, 3), (3, 1500, 4, 2, 40, 35)],
)
def test_greedy_nms_matches_plain(dev, L, P, S, max_e, max_p, n):
    rng = np.random.default_rng(L)
    valid = torch.from_numpy(rng.random((L, P)) > 0.2).to(dev)
    ce, cp = (torch.from_numpy(_candidates(rng, L, P, S)).to(dev) for _ in range(2))
    before = nms_cuda.greedy_nms.launches
    a = nms_cuda.greedy_nms(valid, ce, cp, max_e, max_p, n)
    assert nms_cuda.greedy_nms.launches == before + 1
    b = nms_cuda.greedy_nms_reference(valid, ce, cp, max_e, max_p, n)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_greedy_nms_matches_plain_at_kernel_branches(dev, case):
    valid, ce, cp, max_e, max_p, n = NMS_CASES[case]()
    valid, ce, cp = (torch.from_numpy(x).to(dev) for x in (valid, ce, cp))
    a = nms_cuda.greedy_nms(valid, ce, cp, max_e, max_p, n)
    b = nms_cuda.greedy_nms_reference(valid, ce, cp, max_e, max_p, n)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    if case == "suppressed_inside_a_group":
        assert a[1][0, 0].tolist() == [10, 13, 7, 20, 23] + [-1] * 8


def test_greedy_nms_padded_sector_past_count_bound(dev):
    # the regression of test_nms_pallas.py: two dead slots, then eight real
    # edge candidates, n=1; a count-derived bound would drop the last one
    valid = torch.ones((1, 64), dtype=torch.bool, device=dev)
    cand_e = torch.full((1, 2, 24), -1, dtype=torch.int32, device=dev)
    cand_e[0, 0, 2:10] = torch.arange(10, 50, 5, dtype=torch.int32, device=dev)
    cand_p = torch.full_like(cand_e, -1)
    ep, _ = nms_cuda.greedy_nms(valid, cand_e, cand_p, 12, 12, 1)
    got = ep[0, 0].cpu()
    assert sorted(got[got >= 0].tolist()) == list(range(10, 50, 5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "N,P,C,picks",
    [(64, 1024, 372, "mixed"), (1024, 1024, 372, "mixed"),
     # picks not a multiple of a warp's 32 slots, fewer than 32, one line
     (5, 100, 45, "mixed"), (3, 64, 7, "mixed"), (1, 360, 372, "mixed"),
     (4, 200, 70, "all negative"), (4, 200, 70, "past the line")],
)
def test_select_points_matches_plain(dev, dtype, N, P, C, picks):
    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.standard_normal((N, P, 3))).to(dev, dtype)
    idx = rng.integers(-1, P, (N, C)).astype(np.int32)
    if picks == "all negative":
        idx[:] = rng.integers(-5, 0, (N, C))
    elif picks == "past the line":  # P and beyond yield zeros and read nothing
        idx[:, ::2] = rng.integers(P, 4 * P, (N, (C + 1) // 2))
    idx = torch.from_numpy(idx).to(dev)
    before = assemble_cuda.select_points.launches
    got = assemble_cuda.select_points(pts, idx)
    assert assemble_cuda.select_points.launches == before + 1
    assert torch.equal(got, assemble_cuda.select_points_reference(pts, idx))
    if picks == "all negative":
        assert not got.any()


def _knn_sets(seed, B, m, q, spread=5.0):
    rng = np.random.default_rng(seed)
    targets = rng.uniform(-spread, spread, size=(B, m, 3)).astype(np.float32)
    tmask = rng.random((B, m)) > 0.15
    queries = rng.uniform(-spread, spread, size=(B, q, 3)).astype(np.float32)
    qmask = rng.random((B, q)) > 0.3
    return queries, targets, tmask, qmask


@pytest.mark.parametrize("k,max_dist,m", [(5, 1.5, 3000), (8, 0.0, 3000), (1, 1.0, 3000), (5, 0.0, 3)])
def test_knn_matches_plain(dev, k, max_dist, m):
    q, t, tm, qm = (torch.from_numpy(x).to(dev) for x in _knn_sets(k, 2, m, 2500))
    prep = knn_cuda.knn_prep(t, tm)
    a = knn_cuda.knn_run(prep, q, k, max_dist, with_coords=True, query_mask=qm)
    b = knn_cuda.knn_run_reference(prep, q, k, max_dist, with_coords=True, query_mask=qm)
    for x, y in zip(a, b):  # unfilled slots hold index 0 and zero coordinates in both
        assert torch.equal(x, y)
    ra = knn_cuda.knn_run(prep, q, k, max_dist, query_mask=qm)
    rb = knn_cuda.knn_run_reference(prep, q, k, max_dist, query_mask=qm)
    for x, y in zip(ra, rb):
        assert torch.equal(x, y)


@pytest.mark.parametrize(
    "B,E,P,k_e,k_p,empty_edges",
    [(1, 1100, 2600, 5, 5, False), (3, 700, 1500, 3, 7, False),
     (2, 300, 1200, 5, 5, True), (2, 0, 1300, 5, 5, False)],
    ids=["B1", "B3-distinct-k", "empty-class", "no-edge-queries"],
)
def test_knn_dual_matches_plain_and_two_singles(dev, B, E, P, k_e, k_p, empty_edges):
    qe, te, me, _ = (torch.from_numpy(x).to(dev) for x in _knn_sets(E + 1, B, 900, E))
    qp, tp, mp, _ = (torch.from_numpy(x).to(dev) for x in _knn_sets(P, B, 2600, P))
    if empty_edges:
        me = torch.zeros_like(me)
    r_e, r_p = 1.0, 2.0
    prep = knn_cuda.knn_dual_prep(te, me, tp, mp)
    before = knn_cuda.knn_dual_run.launches
    a = knn_cuda.knn_dual_run(prep, qe, qp, k_e, k_p, r_e, r_p)
    assert knn_cuda.knn_dual_run.launches == before + 1
    b = knn_cuda.knn_dual_run_reference(prep, qe, qp, k_e, k_p, r_e, r_p)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert torch.equal(x, y)
    # ... and equal to two launches of the single kernel
    for res, (q, t, m, k, r) in zip(a, ((qe, te, me, k_e, r_e), (qp, tp, mp, k_p, r_p))):
        one = knn_cuda.knn_run(knn_cuda.knn_prep(t, m), q, k, r)
        assert torch.equal(res.mask, one.mask)
        assert torch.equal(res.indices, torch.where(one.mask, one.indices, 0))
        assert torch.equal(res.distances, one.distances)
    if empty_edges:
        assert not a[0].mask.any()


# ---- the kNN kernels' tiling, live bound and target splits -------------------

def _to(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)


def _assert_single_equal(prep, q, k, r, qm=None):
    """Both output forms of the single search, kernel against plain."""
    before = knn_cuda.knn_run.launches
    for form in (dict(with_coords=True), dict()):
        a = knn_cuda.knn_run(prep, q, k, r, query_mask=qm, **form)
        b = knn_cuda.knn_run_reference(prep, q, k, r, query_mask=qm, **form)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert knn_cuda.knn_run.launches == before + 2
    return a


def _assert_dual_equal(prep, qe, qp, k_e, k_p, r_e, r_p):
    a = knn_cuda.knn_dual_run(prep, qe, qp, k_e, k_p, r_e, r_p)
    b = knn_cuda.knn_dual_run_reference(prep, qe, qp, k_e, k_p, r_e, r_p)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert torch.equal(x, y)
    return a


def _block_queries():
    from loam_tpu_torch.ops import _build

    return _build.lib().loam_knn_block_queries()


def _plan(monkeypatch, split, chunk=64):
    """Make the planner split small shapes into chunks of ``chunk`` slots,
    or keep every class in one range."""
    if split:
        monkeypatch.setattr(knn_cuda, "MIN_CHUNK", chunk)
        monkeypatch.setattr(knn_cuda, "TARGET_BLOCKS", 1 << 20)
    else:
        monkeypatch.setattr(knn_cuda, "MAX_SPLITS", 1)


SPLIT = pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])


@SPLIT
@pytest.mark.parametrize("k", range(1, 9))
def test_knn_every_k_matches_plain(dev, monkeypatch, k, split):
    # M and Q multiples neither of 4, nor of the tile, nor of the block
    _plan(monkeypatch, split)
    q, t, tm, qm = _to(dev, *_knn_sets(100 + k, 2, 2331, 1219))
    _assert_single_equal(knn_cuda.knn_prep(t, tm), q, k, 1.5, qm)
    qe, te, me, _ = _to(dev, *_knn_sets(200 + k, 2, 1027, 515))
    prep = knn_cuda.knn_dual_prep(te, me, t, tm)
    _assert_dual_equal(prep, qe, q, k, 9 - k, 1.0, 1.5)


@SPLIT
@pytest.mark.parametrize("live", ["0", "1", "k-1", "k", "M"])
def test_knn_live_bound(dev, monkeypatch, live, split):
    """n_live in {0, 1, k-1, k, M}: the valid targets are that prefix."""
    k, M = 5, 1500
    n = {"0": 0, "1": 1, "k-1": k - 1, "k": k, "M": M}[live]
    _plan(monkeypatch, split)
    q, t, _, qm = _to(dev, *_knn_sets(7, 2, M, 700, spread=2.0))
    tm = (torch.arange(M, device=dev) < n)[None].expand(2, M).contiguous()
    prep = knn_cuda.knn_prep(t, tm)
    assert prep.n_live.tolist() == [n, n]
    (splits,) = knn_cuda.split_plan(2, ((700, M),), _block_queries())
    assert (splits > 1) == split
    for r in (0.0, 3.0):  # +inf and r^2 slot init
        res = _assert_single_equal(prep, q, k, r, qm)
        assert int(res.mask.sum(-1).max()) == min(n, k) or r > 0
    _assert_dual_equal(knn_cuda.knn_dual_prep(t[:, :403], tm[:, :403], t, tm), q[:, :90], q, 3, k,
                       3.0, 3.0)


@SPLIT
@pytest.mark.parametrize("k", [6, 20])
def test_knn_duplicate_targets_keep_first_index(dev, monkeypatch, k, split):
    """Every target is one of 16 points, each repeated ~190 times in slots
    spread over the tiles and the splits: each query's k neighbors are the k
    lowest slots of its nearest point (k = 20: the wide form, unsplit)."""
    _plan(monkeypatch, split, chunk=200)
    rng = np.random.default_rng(5)
    M, Q = 3001, 640
    sites = rng.uniform(-3, 3, size=(16, 3)).astype(np.float32)
    owner = rng.integers(0, 16, size=(1, M))
    q, t = _to(dev, rng.uniform(-3, 3, size=(1, Q, 3)).astype(np.float32), sites[owner])
    tm = torch.ones((1, M), dtype=torch.bool, device=dev)
    prep = knn_cuda.knn_prep(t, tm)
    (splits,) = knn_cuda.split_plan(1, ((Q, M),), _block_queries())
    assert (splits > 1) == split
    res = _assert_single_equal(prep, q, k, 0.0)
    idx = res.indices[0].cpu().numpy()
    nearest = owner[0][idx[:, 0]]
    for i in range(Q):
        assert idx[i].tolist() == np.flatnonzero(owner[0] == nearest[i])[:k].tolist()
    _assert_dual_equal(knn_cuda.knn_dual_prep(t[:, :1001], tm[:, :1001], t, tm), q[:, :77], q,
                       k, k, 9.0, 9.0)


@SPLIT
def test_knn_all_queries_masked(dev, monkeypatch, split):
    _plan(monkeypatch, split)
    q, t, tm, _ = _to(dev, *_knn_sets(9, 2, 1300, 600))
    qm = torch.zeros((2, 600), dtype=torch.bool, device=dev)
    assert not _assert_single_equal(knn_cuda.knn_prep(t, tm), q, 5, 1.5, qm).mask.any()


@pytest.mark.parametrize("k,r,m", [(9, 1.5, 2331), (16, 0.0, 2331), (40, 2.0, 1027), (12, 0.0, 7)])
def test_knn_wide_k_matches_plain(dev, k, r, m):
    """k above the register lists (the Pallas kernel takes any k): the
    kernel's wide form, one launch a call, equal to the plain search in both
    output forms, with masked queries and with fewer targets than k; the
    dual search likewise."""
    q, t, tm, qm = _to(dev, *_knn_sets(300 + k, 2, m, 1219))
    _assert_single_equal(knn_cuda.knn_prep(t, tm), q, k, r, qm)
    qe, te, me, _ = _to(dev, *_knn_sets(400 + k, 2, 515, 301))
    before = knn_cuda.knn_dual_run.launches
    _assert_dual_equal(knn_cuda.knn_dual_prep(te, me, t, tm), qe, q, k, k - 3, max(r, 1.0), max(r, 1.5))
    assert knn_cuda.knn_dual_run.launches == before + 1


def test_knn_one_pair_splits_and_four_pairs_of_few_targets_do_not(dev):
    """At the planner's own constants: one pair at scan scale takes the
    split path, four pairs against few targets do not."""
    bq = _block_queries()
    q, t, tm, qm = _to(dev, *_knn_sets(13, 1, 19584, 19584, spread=30.0))
    assert knn_cuda.split_plan(1, ((19584, 19584),), bq)[0] > 1
    _assert_single_equal(knn_cuda.knn_prep(t, tm), q, 5, 2.0, qm)
    q4, t4, tm4, qm4 = _to(dev, *_knn_sets(14, 4, 500, 3000))
    assert knn_cuda.split_plan(4, ((3000, 500),), bq) == (1,)
    _assert_single_equal(knn_cuda.knn_prep(t4, tm4), q4, 5, 2.0, qm4)
    # the dual search: edge class unsplit, planar class split
    qe, te, me, _ = _to(dev, *_knn_sets(15, 1, 401, 300))
    s_e, s_p = knn_cuda.split_plan(1, ((300, 401), (19584, 19584)), bq)
    assert s_e == 1 and s_p > 1
    _assert_dual_equal(knn_cuda.knn_dual_prep(te, me, t, tm), qe, q, 5, 5, 1.0, 2.0)


@SPLIT
@pytest.mark.parametrize("Me", [1, 2, 3, 401, 1023, 1026])
def test_knn_dual_edge_block_not_a_multiple_of_four(dev, monkeypatch, Me, split):
    """The planar planes start Me floats into the block: any alignment."""
    _plan(monkeypatch, split)
    qe, te, me, _ = _to(dev, *_knn_sets(Me, 2, Me, 130))
    qp, tp, mp, _ = _to(dev, *_knn_sets(Me + 1, 2, 2049, 770))
    _assert_dual_equal(knn_cuda.knn_dual_prep(te, me, tp, mp), qe, qp, 5, 5, 2.0, 2.0)


def test_entry_points_default_to_the_card(dev):
    """Numpy in and no ``device``: the odometry functions run on the card, the inits
    build their state there; ``device="cpu"`` runs on the CPU."""
    import loam_tpu_torch as T
    from loam_tpu_torch.io import render_trajectory

    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    scans, _ = render_trajectory(lidar, 3, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float32)
    cfg = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
    s2s, s2m = T.scan_to_scan_init(lidar), T.scan_to_map_init(cfg)
    assert s2s.prev_features.edge_points.is_cuda and s2s.world_T_current.rotation.is_cuda
    assert s2m.planar_map.points.is_cuda and s2m.frames_since_insert.is_cuda
    assert T.Pose3.from_numpy((np.array([1.0, 0, 0, 0]), np.zeros(3))).rotation.is_cuda
    before = knn_cuda.knn_run.launches
    traj, _ = T.odometry_offline(scans, lidar, chunk_pairs=2)
    assert traj.translation.is_cuda and knn_cuda.knn_run.launches > before
    state, traj_m, _ = T.scan_to_map_offline(scans, lidar, config=cfg)
    assert traj_m.translation.is_cuda and state.edge_map.points.is_cuda
    for f in range(len(scans)):  # the README loop: a CUDA scan meets the default state
        s2s, pose, _ = T.scan_to_scan_step(s2s, torch.from_numpy(scans[f]).to(dev), lidar)
    assert pose.translation.is_cuda
    traj_c, _ = T.odometry_offline(scans, lidar, chunk_pairs=2, device="cpu")
    assert traj_c.translation.device.type == "cpu"
    np.testing.assert_allclose(traj.translation.cpu().numpy(), traj_c.translation.numpy(),
                               atol=1e-2, rtol=0)


def test_scan_to_map_gpu_matches_cpu(dev, monkeypatch):
    """scan_to_map_offline on 6 frames of 16x360 scans (map capacities
    2048/8192), on the GPU and on the CPU: with the dual kNN (the prep cache
    off, so the registration takes the dual search), and with the default
    rebuild-on-insert prep cache, which searches the maps with the seeded
    single kNN on the card."""
    import loam_tpu_torch as T
    from loam_tpu_torch.io import render_trajectory

    monkeypatch.setenv("LOAM_ICF_DUAL_KNN", "1")
    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    scans, _ = render_trajectory(lidar, 6, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float32)
    cfg = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
    sc, tc, dc = T.scan_to_map_offline(torch.from_numpy(scans), lidar, config=cfg)
    assert sc.knn_prep_cache == ()
    for cache, counter in (("0", knn_cuda.knn_dual_run), ("1", knn_cuda.knn_run)):
        monkeypatch.setenv("LOAM_S2M_PREP_CACHE", cache)
        before = counter.launches
        sg, tg, dg = T.scan_to_map_offline(torch.from_numpy(scans).to(dev), lidar, config=cfg)
        assert counter.launches > before
        assert len(sg.knn_prep_cache) == (16 if cache == "1" else 0)
        assert torch.equal(dg.termination.cpu(), dc.termination)
        np.testing.assert_allclose(tg.translation.cpu().numpy(), tc.translation.numpy(), atol=1e-2, rtol=0)
        assert int(sg.dropped) == 0 and int(sc.dropped) == 0


def test_knn_grid_gpu_matches_cpu_and_bruteforce(dev):
    """The voxel-grid search is plain tensor code: on the GPU it gives the
    CPU's neighbors and masks exactly, distances within rtol 1e-6 (the two
    devices' square roots may round the last bit differently), and at
    overflow 0 the kNN kernel's neighbors."""
    from loam_tpu_torch.neighbors import build_grid, knn, knn_grid

    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.uniform(-12, 12, (3000, 3)).astype(np.float32))
    m = torch.from_numpy(rng.random(3000) > 0.15)
    q = torch.from_numpy(rng.uniform(-12, 12, (5000, 3)).astype(np.float32))  # above one tile of 4,096
    on_cpu, o_cpu = knn_grid(build_grid(t, m, 1.0), q, 5, 1.0)
    on_gpu, o_gpu = knn_grid(build_grid(t.to(dev), m.to(dev), 1.0), q.to(dev), 5, 1.0)
    assert int(o_cpu) == int(o_gpu) == 0 and on_gpu.indices.is_cuda
    assert torch.equal(on_gpu.mask.cpu(), on_cpu.mask) and on_cpu.mask.any()
    assert torch.equal(on_gpu.indices.cpu()[on_cpu.mask], on_cpu.indices[on_cpu.mask])
    torch.testing.assert_close(on_gpu.distances.cpu(), on_cpu.distances, rtol=1e-6, atol=0)
    kernel = knn(q.to(dev), t.to(dev), m.to(dev), 5, 1.0)
    assert torch.equal(kernel.mask, on_gpu.mask)
    assert torch.equal(kernel.indices[kernel.mask], on_gpu.indices[kernel.mask])
    torch.testing.assert_close(kernel.distances, on_gpu.distances, rtol=1e-6, atol=0)


def test_grid_and_streaming_drivers_gpu_match_cpu(dev):
    """scan_to_map_offline through the grid and odometry_streaming (numpy in,
    no ``device``: on the card) on 6 frames of 16x360 scans, beside the same
    runs on the CPU: within 1e-2 m, equal terminations; the pushed form
    equals the offline form exactly."""
    import loam_tpu_torch as T
    from loam_tpu_torch.io import render_trajectory

    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    scans, _ = render_trajectory(lidar, 6, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float32)
    cfg = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
    grid = T.RegistrationParams(search_backend="grid", prior_weight=300.0)
    before = knn_cuda.knn_run.launches, knn_cuda.knn_dual_run.launches
    _, tg, dg = T.scan_to_map_offline(scans, lidar, reg_params=grid, config=cfg)
    assert (knn_cuda.knn_run.launches, knn_cuda.knn_dual_run.launches) == before  # no kNN kernel
    _, tc, dc = T.scan_to_map_offline(scans, lidar, reg_params=grid, config=cfg, device="cpu")
    assert tg.translation.is_cuda and torch.equal(dg.termination.cpu(), dc.termination)
    np.testing.assert_allclose(tg.translation.cpu().numpy(), tc.translation.numpy(), atol=1e-2, rtol=0)
    assert not dg.iteration_info.plane_knn_overflow.any()

    sorts = bitonic_cuda.sector_sort.launches
    sg, dsg = T.odometry_streaming(scans, lidar, chunk_frames=4)
    assert sg.translation.is_cuda and bitonic_cuda.sector_sort.launches == sorts + 2  # once a chunk
    sc, dsc = T.odometry_streaming(scans, lidar, chunk_frames=4, device="cpu")
    assert torch.equal(dsg.termination.cpu(), dsc.termination)
    np.testing.assert_allclose(sg.translation.cpu().numpy(), sc.translation.numpy(), atol=1e-2, rtol=0)
    odo = T.StreamingOdometry(lidar, chunk_frames=4)
    out = [p for s in scans for p in odo.push(s)] + odo.finish()
    assert [i for i, _ in out] == list(range(6)) and not out[0][1].translation.is_cuda
    assert torch.equal(torch.stack([p.translation for _, p in out]), sg.translation.cpu())


def test_wrappers_refuse_bad_inputs(dev):
    with pytest.raises(TypeError):
        assemble_cuda.select_points(torch.zeros((2, 8, 3), device=dev),
                                    torch.zeros((2, 4), dtype=torch.int64, device=dev))
    # any k >= 1 launches the kernel (k = 9 its wide form); k = 0 is refused
    g = torch.Generator().manual_seed(9)
    prep = knn_cuda.knn_prep(torch.rand((40, 3), generator=g).to(dev),
                             torch.ones(40, dtype=torch.bool, device=dev))
    q = torch.rand((6, 3), generator=g).to(dev)
    before = knn_cuda.knn_run.launches
    got = knn_cuda.knn_run(prep, q, 9, 1.0)
    assert knn_cuda.knn_run.launches == before + 1 and got.indices.is_cuda
    for x, y in zip(got, knn_cuda.knn_run_reference(prep, q, 9, 1.0)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        knn_cuda.knn_run(prep, q, 0, 1.0)
    with pytest.raises(ValueError):  # not contiguous
        bitonic_cuda.sector_sort(torch.zeros((64, 8), device=dev).t(), 2)
    cand = torch.full((2, 1, 8), -1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # no suppression window: the kernel needs n >= 1
        nms_cuda.greedy_nms(torch.ones((2, 8), dtype=torch.bool, device=dev), cand, cand, 2, 2, 0)


def _pair_features(lidar, dtype, dev):
    """Features of the first two frames of the 16x360 test trajectory."""
    import loam_tpu_torch as T
    from loam_tpu_torch.io import render_trajectory

    scans, _ = render_trajectory(lidar, 2, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float64)
    feats = T.extract_features_batch(torch.from_numpy(scans).to(dev, dtype), lidar)
    return feats.map(lambda x: x[1]), feats.map(lambda x: x[0])


def test_float64_registration_runs_the_plain_search_on_the_card(dev):
    """float64 targets take the plain search on the card (no kernel launch,
    no TypeError), as ``loam_tpu`` takes its plain search for float64: a
    float64 registration on the card equals its CPU run within 1e-9 m.
    ``neighbors.knn`` with k = 9 equals the plain search exactly: the plain
    search itself in float64, the kernel's wide form in float32."""
    import loam_tpu_torch as T

    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    src, tgt = _pair_features(lidar, torch.float64, dev)
    before = knn_cuda.knn_run.launches, knn_cuda.knn_dual_run.launches
    est, det = T.register_features(src, tgt)
    assert (knn_cuda.knn_run.launches, knn_cuda.knn_dual_run.launches) == before
    assert est.translation.is_cuda and est.translation.dtype == torch.float64
    est_c, det_c = T.register_features(src.map(lambda x: x.cpu()), tgt.map(lambda x: x.cpu()))
    assert int(det.termination) == int(det_c.termination) == int(T.TerminationType.CONVERGED)
    assert int(det.num_iterations) == int(det_c.num_iterations)
    np.testing.assert_allclose(est.translation.cpu().numpy(), est_c.translation.numpy(), atol=1e-9, rtol=0)
    np.testing.assert_allclose(est.rotation.cpu().numpy(), est_c.rotation.numpy(), atol=1e-9, rtol=0)

    q, t, m = src.planar_points, tgt.planar_points, tgt.planar_mask
    for dtype, launched in ((torch.float64, 0), (torch.float32, 1)):
        got = T.knn(q.to(dtype), t.to(dtype), m, 9, 1.0)
        want = knn_cuda.knn_run_reference(knn_cuda.knn_prep(t.to(dtype), m), q.to(dtype), 9, 1.0)
        assert knn_cuda.knn_run.launches == before[0] + launched and got.indices.is_cuda
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_registration_reorders_where_the_kernel_searches(dev):
    """float32 features in the extractor's order on the card: the
    registration azimuth-sorts both sets before its loop (``loam_tpu``'s
    ``reorder_mode="auto"``), so it equals a ``"none"`` run on the sorted
    sets bit for bit, its matches mapped back to the caller's slots; its
    kernel visits fewer boxes than the unsorted search would."""
    import loam_tpu_torch as T
    from loam_tpu_torch.registration import icf

    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    src, tgt = _pair_features(lidar, torch.float32, dev)
    est, det = T.register_features(src, tgt)
    ss, se, sp = icf._sort_features(src.map(lambda x: x[None]), icf._azimuth_key, with_perms=True)
    ts, te, tp = icf._sort_features(tgt.map(lambda x: x[None]), icf._azimuth_key, with_perms=True)
    est_s, det_s = T.register_features(ss.map(lambda x: x[0]), ts.map(lambda x: x[0]),
                                       reorder_mode="none")
    assert torch.equal(est.rotation, est_s.rotation) and torch.equal(est.translation, est_s.translation)
    assert int(det.termination) == int(det_s.termination) == int(T.TerminationType.CONVERGED)
    info, info_s = det.iteration_info, det_s.iteration_info
    assert torch.equal(info.plane_match, icf._unpermute_matches(info_s.plane_match[None], sp, tp)[0])
    assert torch.equal(info.edge_match, icf._unpermute_matches(info_s.edge_match[None], se, te)[0])
    p = T.RegistrationParams()
    visits = {}
    for what, (s_, t_) in (("sorted", (ss, ts)), ("unsorted", (src.map(lambda x: x[None]),
                                                                tgt.map(lambda x: x[None])))):
        prep = knn_cuda.knn_prep(t_.planar_points, t_.planar_mask)
        _, v = knn_cuda.knn_run(prep, s_.planar_points, p.num_plane_neighbors, p.max_plane_neighbor_dist,
                                query_mask=s_.planar_mask, return_visits=True)
        visits[what] = int(v[..., 0].sum())
    assert visits["sorted"] < visits["unsorted"]


def test_pose_graph_gpu_matches_cpu(dev):
    """``optimize_pose_graph`` on a 60-node chain with 6 closures: in float64
    the card's solve equals the CPU's within 1e-8 (the card's
    ``index_put_(accumulate=True)`` adds in another order than the CPU's) and recovers the
    true poses; in float32 it lowers the cost and holds the float32
    tolerance of ``test_torch_pose_graph.py`` with the CPU's float32 solve
    in ``loam_tpu``'s place: its largest position error against the truth at
    most 3x the CPU solve's plus 5e-5 m, its poses within 2e-3 m and 5e-5
    (quaternion components) of the CPU solve's."""
    from loam_tpu_torch.pose_graph import _cost, optimize_pose_graph
    from loam_tpu_torch.io import random_pose_graph

    gt, init, edges = random_pose_graph(60, 6, seed=0)
    to = lambda tree, dtype=None: type(tree)(*(
        to(x, dtype) if isinstance(x, tuple) else x.to(dev, dtype if x.is_floating_point() else x.dtype)
        for x in tree))
    opt, cost = optimize_pose_graph(to(init), to(edges), 10)
    opt_c, cost_c = optimize_pose_graph(init, edges, 10)
    assert opt.translation.is_cuda
    np.testing.assert_allclose(opt.translation.cpu().numpy(), opt_c.translation.numpy(), atol=1e-8, rtol=0)
    np.testing.assert_allclose(opt.rotation.cpu().numpy(), opt_c.rotation.numpy(), atol=1e-8, rtol=0)
    np.testing.assert_allclose(opt.translation.cpu().numpy(), gt.translation.numpy(), atol=1e-5)
    assert float(cost) < 1e-12
    init32, edges32 = to(init, torch.float32), to(edges, torch.float32)
    opt32, cost32 = optimize_pose_graph(init32, edges32, 10)
    assert torch.isfinite(opt32.translation).all()
    assert float(cost32) < float(_cost(init32, edges32))
    cast = lambda tree: type(tree)(*(cast(x) if isinstance(x, tuple) else
                                     (x.float() if x.is_floating_point() else x) for x in tree))
    cpu32, _ = optimize_pose_graph(cast(init), cast(edges), 10)
    truth = gt.translation.numpy()
    err_card = np.abs(opt32.translation.cpu().numpy().astype(np.float64) - truth).max()
    err_cpu = np.abs(cpu32.translation.numpy().astype(np.float64) - truth).max()
    assert err_card <= 3.0 * err_cpu + 5e-5, (err_card, err_cpu)
    np.testing.assert_allclose(opt32.translation.cpu().numpy(), cpu32.translation.numpy(), atol=2e-3, rtol=0)
    np.testing.assert_allclose(opt32.rotation.cpu().numpy(), cpu32.rotation.numpy(), atol=5e-5, rtol=0)


def _loop_keyframes(dev):
    """Features of 17 keyframes of 16x360 around a closed square (the
    smoke's phase-4 loop), and the true poses."""
    import loam_tpu_torch as T
    from loam_tpu_torch.geometry import Pose3, quat_exp
    from loam_tpu_torch.io import square_loop_scans

    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    scans, positions, yaws = square_loop_scans(lidar, n_side=4, step=0.4)
    rot = quat_exp(torch.tensor([[0.0, 0.0, y] for y in yaws])).float()
    feats = T.extract_features_batch(torch.from_numpy(scans).to(dev), lidar)
    return feats, Pose3(rot.to(dev), torch.from_numpy(positions).float().to(dev))


def test_loop_closure_gpu_matches_cpu(dev):
    """``optimize_trajectory_with_closures`` on the closed square with drift:
    on the card the kNN kernel verifies the candidates; candidates and the
    accepted set equal the CPU run's, the closures' measurements and the
    optimized trajectory agree within 1e-2 m, and the end gap shrinks."""
    from loam_tpu_torch.geometry import Pose3
    from loam_tpu_torch.loop_closure import optimize_trajectory_with_closures

    feats, gt = _loop_keyframes(dev)
    N = gt.translation.shape[0]
    rng = np.random.default_rng(0)
    drift = np.cumsum(rng.normal(0, 0.01, (N, 3)) * np.array([1, 1, 0.2]), axis=0)
    noisy = Pose3(gt.rotation, gt.translation + torch.from_numpy(drift).float().to(dev))
    kw = dict(max_candidates=4, min_separation=8, max_distance=1.5, iterations=8)
    before = knn_cuda.knn_run.launches
    opt, clo = optimize_trajectory_with_closures(noisy, feats, **kw)
    assert knn_cuda.knn_run.launches > before and opt.translation.is_cuda
    cpu = lambda p: type(p)(*(x.cpu() for x in p))
    opt_c, clo_c = optimize_trajectory_with_closures(cpu(noisy), feats.map(lambda x: x.cpu()), **kw)
    for name in ("i", "j", "accepted"):
        assert torch.equal(getattr(clo, name).cpu(), getattr(clo_c, name)), name
    assert clo.accepted.any()
    np.testing.assert_allclose(clo.measurement.translation.cpu().numpy(),
                               clo_c.measurement.translation.numpy(), atol=1e-2, rtol=0)
    np.testing.assert_allclose(opt.translation.cpu().numpy(), opt_c.translation.numpy(), atol=1e-2, rtol=0)
    t, t0 = opt.translation.cpu().numpy(), noisy.translation.cpu().numpy()
    assert np.linalg.norm(t[-1] - t[0]) < 0.5 * np.linalg.norm(t0[-1] - t0[0])


def test_odometry_streaming_over_paths_on_the_card(dev, tmp_path):
    """A list of KITTI ``.bin`` paths through the native loader, packed and
    not, runs on the card by default, equals the card's run over the frames
    the loader reads, agrees with the CPU's run over the paths (equal
    terminations, within 1e-2 m) and passes the ATE gate of
    ``test_dataset_e2e.py``. The frames are the first 6 of the smoke's loop,
    whose returns sit mid-cell, so that the files read back as the scans
    that were written."""
    import loam_tpu_torch as T
    from loam_tpu_torch.evaluation import ate_rmse
    from loam_tpu_torch.io import ScanLoader, native_available
    from loam_tpu_torch.io import square_loop_scans, write_kitti_bins

    assert native_available()
    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    scans, gt, _ = square_loop_scans(lidar)
    scans, gt = scans[:6], gt[:6]
    paths = write_kitti_bins(scans, str(tmp_path))
    limit = max(0.05 * float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1))), 0.05)
    for packed in (False, True):
        loader = ScanLoader(paths, 16, 360, packed=packed)
        loaded = np.stack(list(loader))
        loader.close()
        sorts = bitonic_cuda.sector_sort.launches
        got, det = T.odometry_streaming(paths, lidar, chunk_frames=4, packed=packed)
        assert got.translation.is_cuda and bitonic_cuda.sector_sort.launches == sorts + 2
        want, det_w = T.odometry_streaming(loaded, lidar, chunk_frames=4, packed=packed)
        assert torch.equal(got.translation, want.translation) and torch.equal(got.rotation, want.rotation)
        assert torch.equal(det.termination, det_w.termination)
        cpu, det_c = T.odometry_streaming(paths, lidar, chunk_frames=4, packed=packed, device="cpu")
        assert torch.equal(det.termination.cpu(), det_c.termination)
        np.testing.assert_allclose(got.translation.cpu().numpy(), cpu.translation.numpy(), atol=1e-2, rtol=0)
        assert ate_rmse(got.translation.cpu().numpy(), gt, align=False) < limit


@pytest.mark.parametrize("case", ["one_empty_shard", "all_empty", "ties"])
def test_sharded_knn_on_the_card_matches_plain(dev, case):
    """``sharded_knn`` on a mesh of four shards of the card: one batched
    launch of the kNN kernel for the four shards, then the merge, equal to
    the plain search over the whole target (indices where valid, masks,
    distances, neighbour coordinates) and to the same sharded search on the
    CPU (masks and indices equal, distances and coordinates within 1e-6:
    the two devices' square roots). An empty shard, or an empty target,
    gives no neighbour from it."""
    from loam_tpu_torch.parallel import make_mesh
    from loam_tpu_torch.parallel.distributed import sharded_knn

    rng = np.random.default_rng(17)
    S = 4096
    if case == "ties":  # a 0.5 m grid: many equidistant targets across shards
        t = (rng.integers(-6, 7, (4 * S, 3)) * 0.5).astype(np.float32)
        q = (rng.integers(-6, 7, (3000, 3)) * 0.5).astype(np.float32)
    else:
        t = rng.uniform(-20, 20, (4 * S, 3)).astype(np.float32)
        q = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    m = rng.random(4 * S) > 0.3
    m[S:2 * S] = False
    if case == "all_empty":
        m[:] = False
    tq, tt, tm = (torch.from_numpy(x).to(dev) for x in (q, t, m))
    for k, r in ((5, 1.0), (5, 0.0), (2, 3.0)):
        before = knn_cuda.knn_run.launches
        res, nbr = sharded_knn(tq, tt, tm, k, r, make_mesh([dev] * 4))
        assert knn_cuda.knn_run.launches == before + 1
        plain = knn_cuda.knn_run_reference(knn_cuda.knn_prep(tt, tm), tq, k, r)
        assert torch.equal(res.mask, plain.mask)
        assert torch.equal(res.indices[res.mask], plain.indices[plain.mask])
        assert torch.equal(res.distances, plain.distances)
        assert torch.equal(nbr[res.mask], tt[res.indices[res.mask].long()])
        if case == "all_empty":
            assert not res.mask.any()
        cpu, nbr_c = sharded_knn(*(x.cpu() for x in (tq, tt, tm)), k, r, make_mesh(["cpu"] * 4))
        assert torch.equal(res.mask.cpu(), cpu.mask)
        assert torch.equal(res.indices.cpu()[cpu.mask], cpu.indices[cpu.mask])
        torch.testing.assert_close(res.distances.cpu(), cpu.distances, atol=1e-6, rtol=0)
        torch.testing.assert_close(nbr.cpu()[cpu.mask], nbr_c[cpu.mask], atol=1e-6, rtol=0)


# ---- the visit pruning: boxes, lists, the gate and the seed bounds ------------


def _sorted_sets(dev, seed, B, m, q, spread=10.0):
    """Targets and queries sorted along x, so the boxes of consecutive slots
    are compact and the gate has something to skip."""
    qs, t, tm, qm = _knn_sets(seed, B, m, q, spread)
    t = t[:, np.argsort(t[0, :, 0], kind="stable")]
    qs = qs[:, np.argsort(qs[0, :, 0], kind="stable")]
    return _to(dev, qs, t, tm, qm)


def _assert_pruned_equal(prep, q, k, r, qm=None, seed=None, **seeds):
    """Both output forms with the gate (and ``seed``, or the seeds the
    kernel computes: ``seed_prev``, ``seed_window``) against the plain
    search; the boxes the kernel visits never exceed the live ones."""
    for form in (dict(with_coords=True), dict()):
        a, va = knn_cuda.knn_run(prep, q, k, r, query_mask=qm, seed_bound=seed, return_visits=True,
                                 **seeds, **form)
        b, vb = knn_cuda.knn_run_reference(prep, q, k, r, query_mask=qm, return_visits=True, **form)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert va.shape == vb.shape and bool((va <= vb).all())
    return a, va, vb


@SPLIT
@pytest.mark.parametrize("seed_kind", ["none", "cold", "warm", "exact"])
def test_knn_seed_bounds_match_plain(dev, monkeypatch, seed_kind, split):
    """Cold (rank window), warm (last neighbours at moved queries, and the
    window) and the exact k-th distance as the seed bound: equal outputs,
    fewer visits. The cold and warm bounds also as the kernel computes them
    in its prologue: its debug plane equal to the plain functions' bits."""
    _plan(monkeypatch, split)
    k, r = 5, 1.0
    q, t, tm, qm = _sorted_sets(dev, 21, 2, 3001, 2100)
    prep = knn_cuda.knn_prep(t, tm)
    seed, seeds = None, {}
    window = lambda: knn_cuda.seed_bound_from_window(q, *knn_cuda.window_candidates(t, tm, q.shape[1]), k)
    if seed_kind == "cold":
        seed, seeds = window(), dict(seed_window=True)
    elif seed_kind == "warm":
        prev = knn_cuda.knn_run_reference(prep, q + 0.02, k, r, with_coords=True, query_mask=qm)
        seed = torch.minimum(knn_cuda.seed_bound_from_packed(q, prev.xs, prev.ys, prev.zs, prev.mask),
                             window())
        seeds = dict(seed_prev=prev, seed_window=True)
    elif seed_kind == "exact":
        seed = knn_cuda._search_reference(prep, q, k, float("inf"), None)[1][:, k - 1].contiguous()
    _, va, vb = _assert_pruned_equal(prep, q, k, r, qm, seed)
    assert int(va.sum()) < int(vb.sum())
    _, vk, _ = _assert_pruned_equal(prep, q, k, r, qm, **seeds)
    assert torch.equal(vk, va) or not seeds
    # the debug plane: the bound each query was gated with, as given or as
    # the prologue computed it
    bound = knn_cuda._search_kernel(prep, q, k, r * r, qm, seed, bound=True)[4]
    want = torch.full_like(bound, float("inf")) if seed is None else seed
    assert torch.equal(bound, want)
    if seeds:
        prev = seeds.get("seed_prev")
        raw = None if prev is None else (prev.xs, prev.ys, prev.zs, prev.mask)
        assert torch.equal(knn_cuda._search_kernel(prep, q, k, r * r, qm, bound=True, prev=raw,
                                                   window=True)[4], seed)


@SPLIT
@pytest.mark.parametrize("k", [1, 5, 8, 9, 16])
def test_knn_pruned_every_form(dev, monkeypatch, k, split):
    """Splits, the wide form (k = 9, 16), masked queries and boxes without a
    valid target (a masked run of slots), with a seed bound."""
    _plan(monkeypatch, split)
    q, t, tm, qm = _sorted_sets(dev, 30 + k, 2, 2600, 1300)
    tm[:, 700:1300] = False  # whole boxes without a valid target
    prep = knn_cuda.knn_prep(t, tm, 128)
    assert bool((prep.rbox[:, 0] > prep.rbox[:, 1]).any())
    seed = knn_cuda.seed_bound_from_window(q, *knn_cuda.window_candidates(t, tm, q.shape[1]), k)
    for s in (None, seed):
        _assert_pruned_equal(prep, q, k, 1.5, qm, s)
    none = torch.zeros_like(qm)
    res, va, _ = _assert_pruned_equal(prep, q, k, 1.5, none, seed)
    assert not res.mask.any() and int(va.sum()) == 0


@pytest.mark.parametrize("empty", [None, "edge", "planar"])
def test_knn_dual_pruned_matches_plain(dev, monkeypatch, empty):
    """The dual search with its per-class boxes and lists, one class empty."""
    _plan(monkeypatch, True)
    qe, te, me, _ = _sorted_sets(dev, 51, 2, 900, 700)
    qp, tp, mp, _ = _sorted_sets(dev, 52, 2, 3001, 2100)
    if empty == "edge":
        me = torch.zeros_like(me)
    if empty == "planar":
        mp = torch.zeros_like(mp)
    prep = knn_cuda.knn_dual_prep(te, me, tp, mp)
    a, (ve, vp) = knn_cuda.knn_dual_run(prep, qe, qp, 3, 5, 1.0, 1.5, return_visits=True)
    b, (we, wp) = knn_cuda.knn_dual_run_reference(prep, qe, qp, 3, 5, 1.0, 1.5, return_visits=True)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert torch.equal(x, y)
    assert bool((ve <= we).all()) and bool((vp <= wp).all())
    if empty is not None:
        assert int((ve if empty == "edge" else vp).sum()) == 0


@pytest.mark.parametrize("box", [64, 256])
@pytest.mark.parametrize("k,r", [(1, 0.3), (5, 0.6), (8, 0.51), (9, 0.8)])
def test_knn_gate_on_axis_aligned_faces(dev, k, r, box):
    """Targets on an axis-aligned grid, in slab order, and queries on grid
    points and half-way between layers: lower bounds land on box faces and
    many distances tie. Rounding in the rotated frame must not skip an
    equal-distance, lower-index candidate."""
    g = np.stack(np.meshgrid(np.arange(32), np.arange(16), np.arange(8), indexing="ij"), -1)
    t = (g.reshape(-1, 3) * 0.5 + np.array([20.0, -3.0, 1.0])).astype(np.float32)
    rng = np.random.default_rng(box + k)
    q = t[np.sort(rng.integers(0, len(t), 1500))].copy()
    q[::3, 0] += 0.25
    q[1::3, 1] += 0.25
    qq, tt = _to(dev, q[None], t[None])
    prep = knn_cuda.knn_prep(tt, torch.ones((1, len(t)), dtype=torch.bool, device=dev), box)
    exact = knn_cuda._search_reference(prep, qq, k, float("inf"), None)[1][:, k - 1].contiguous()
    for seed in (None, exact):
        _, va, vb = _assert_pruned_equal(prep, qq, k, r, None, seed)
        assert int(va.sum()) < int(vb.sum())


# ---- full width against the float64 oracle, and the dense case -------------


@pytest.fixture(scope="module")
def full_width():
    """The first two 64x1024 frames of the smoke's trajectory (float32) and
    their features' compact coordinates, extracted on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    import loam_tpu_torch as T
    from loam_tpu_torch.io import render_trajectory

    lidar = T.LidarParams(64, 1024, 0.5, 120.0)
    fp = T.FeatureExtractionParams(precise_selection=True)
    scans, _ = render_trajectory(lidar, 2, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
                                 noise=0.005, seed=0, dtype=np.float32)
    feats = T.extract_features_batch(torch.from_numpy(scans).cuda(), lidar, fp)
    return lidar, fp, scans, feats


def test_oracle_extraction_full_width(dev, full_width):
    """The three extraction kernels' picks on one 64x1024 scan, index-exact
    with the f64 oracle, their coordinates the scan's."""
    from loam_tpu_torch.oracle import extract_features

    lidar, fp, scans, feats = full_width
    one = feats.map(lambda x: x[0])
    e, p = one.compact_indices()
    oe, op = extract_features(scans[0].astype(np.float64), lidar, fp)
    assert e.tolist() == oe and p.tolist() == op and len(e) > 100 and len(p) > 10000
    ep, pp = one.compact()
    flat = scans[0].reshape(-1, 3)
    assert np.array_equal(ep, flat[e]) and np.array_equal(pp, flat[p])


def test_oracle_knn_sample_full_width(dev, full_width):
    """Both kNN entry points on one 64x1024 pair against knn_oracle on 512
    sampled queries a class: indices exact outside the near-tie margin, d2
    within 1e-6 (``oracle.compare.check_knn``)."""
    import loam_tpu_torch as T
    from loam_tpu_torch.oracle import compare

    _, _, _, feats = full_width
    rp = T.RegistrationParams()
    tgt, src = feats.map(lambda x: x[:1]), feats.map(lambda x: x[1:2].contiguous())
    k_e, k_p, r_e, r_p = (rp.num_edge_neighbors, rp.num_plane_neighbors, rp.max_edge_neighbor_dist,
                          rp.max_plane_neighbor_dist)
    single = knn_cuda.knn_run(knn_cuda.knn_prep(tgt.planar_points, tgt.planar_mask), src.planar_points,
                              k_p, r_p, query_mask=src.planar_mask, seed_window=True)
    dual = knn_cuda.knn_dual_run(knn_cuda.knn_dual_prep(tgt.edge_points, tgt.edge_mask, tgt.planar_points,
                                                        tgt.planar_mask),
                                 src.edge_points, src.planar_points, k_e, k_p, r_e, r_p)
    rng = np.random.default_rng(5)
    np_ = lambda x: x[0].cpu().numpy()
    for res, cls, k, r in ((single, "planar", k_p, r_p), (dual[0], "edge", k_e, r_e),
                           (dual[1], "planar", k_p, r_p)):
        qm = np_(getattr(src, f"{cls}_mask"))
        rows = np.sort(rng.choice(np.flatnonzero(qm), size=min(512, int(qm.sum())), replace=False))
        got = compare.check_knn(cls, np_(getattr(src, f"{cls}_points"))[rows],
                                np_(getattr(tgt, f"{cls}_points")), np_(getattr(tgt, f"{cls}_mask")), k, r,
                                *(np_(x)[rows] for x in res))
        assert got["rows"] == len(rows) and got["near_ties"] < len(rows) // 10


@pytest.fixture(scope="module")
def full_width_oracle(full_width):
    """register_oracle on the 64x1024 pair (~25 s of host time)."""
    from loam_tpu_torch.oracle import register_oracle
    import loam_tpu_torch as T

    _, _, _, feats = full_width
    (te, tp), (se, sp) = (feats.map(lambda x: x[i]).compact() for i in range(2))
    up = lambda a: a.astype(np.float64)
    orc = register_oracle(up(se), up(sp), up(te), up(tp), params=T.RegistrationParams())
    return (se, sp, te, tp), orc


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_oracle_icf_pair_full_width(dev, full_width_oracle, dtype):
    """The 64x1024 pair against register_oracle: in float64 on the card (the
    plain search) equal iteration by iteration (``oracle.compare.check_icf``:
    validity and matches equal, estimates within 1e-9, deltas within 1e-8);
    in float32 through the kernel, the oracle's termination and its pose
    within tests/test_torch_odometry.py's 1e-2 m / 1e-3 rad."""
    import loam_tpu_torch as T
    from loam_tpu_torch.oracle import compare

    (se, sp, te, tp), orc = full_width_oracle
    sets = [T.feature_set_from_points(e, p, dtype=dtype, device=dev) for e, p in ((se, sp), (te, tp))]
    before = knn_cuda.knn_run.launches
    est, det = T.register_features(*sets, params=T.RegistrationParams())
    gap_m, gap_rad = compare.pose_gap(est.rotation, est.translation, orc)
    if dtype == torch.float64:
        assert knn_cuda.knn_run.launches == before
        assert compare.check_icf("64x1024 pair", det, orc) == len(orc.iterations) > 0
    else:
        assert knn_cuda.knn_run.launches > before
        assert int(det.termination) == orc.termination
        assert gap_m <= 1e-2 and gap_rad <= 1e-3


def test_knn_mapfull_matches_plain(dev):
    """Maps whose every slot is live, points uniform in a 40 m cube (nothing
    to prune): the dual search and the single one with the cold seed bit-equal
    to the plain versions; no more boxes visited than are live."""
    rng = np.random.default_rng(17)
    full = lambda n: torch.from_numpy(((rng.random((n, 3)) - 0.5) * 40.0).astype(np.float32)).to(dev)
    te, tp = full(32768), full(131072)
    me = torch.ones(32768, dtype=torch.bool, device=dev)
    mp = torch.ones(131072, dtype=torch.bool, device=dev)
    qe, qp = full(4000), full(19000)
    prep = knn_cuda.knn_dual_prep(te, me, tp, mp)
    _assert_dual_equal(prep, qe, qp, 5, 5, 1.0, 2.0)
    qm = torch.from_numpy(rng.random(19000) > 0.1).to(dev)
    _assert_pruned_equal(knn_cuda.knn_prep(tp[None], mp[None]), qp[None], 5, 2.0, qm[None], seed_window=True)


# ---- F9: lines of more than 2,048 points and sectors of more than 1,024 slots


@pytest.mark.parametrize("P", [2049, 2083, 3600, 4096, 8192, 16384, 65536])
def test_greedy_nms_wide_lines_match_plain(dev, P):
    """Lines wider than the register forms hold (the mask in shared memory),
    index-exact against the plain version (run on the CPU, where its serial
    loop over the slots is faster)."""
    L, S = (3, 6) if P <= 8192 else (1, 4)
    rng = np.random.default_rng(P)
    valid = torch.from_numpy(rng.random((L, P)) > 0.2)
    ce, cp = (torch.from_numpy(_candidates(rng, L, P, S)) for _ in range(2))
    assert nms_cuda.kernel_form(P, dev) == "shared"
    before = nms_cuda.greedy_nms.launches
    got = nms_cuda.greedy_nms(valid.to(dev), ce.to(dev), cp.to(dev), 10, 50, 3)
    assert nms_cuda.greedy_nms.launches == before + 1
    for x, y in zip(got, nms_cuda.greedy_nms_reference(valid, ce, cp, 10, 50, 3)):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("form", nms_cuda.FORMS)
@pytest.mark.parametrize("P", [1500, 3600])
def test_greedy_nms_every_form(dev, form, P):
    """Each form forced where it holds the line; the registers refuse a line
    of more than 2,048 points when forced."""
    if form == "registers" and P > 2048:
        with pytest.raises(ValueError):
            nms_cuda.kernel_form(P, dev, form)
        return
    rng = np.random.default_rng(P + 1)
    valid = torch.from_numpy(rng.random((5, P)) > 0.2)
    ce, cp = (torch.from_numpy(_candidates(rng, 5, P, 6)) for _ in range(2))
    got = nms_cuda.greedy_nms(valid.to(dev), ce.to(dev), cp.to(dev), 4, 30, 4, form=form)
    for x, y in zip(got, nms_cuda.greedy_nms_reference(valid, ce, cp, 4, 30, 4)):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("form", ["shared", "global"])
def test_greedy_nms_wide_bound_from_last_real_candidate(dev, form):
    """The regression of test_nms_pallas.py on a 5,000-point line: dead
    slots, eight real edge candidates, and one more at slot 2,400 of 2,500;
    a count-derived bound would drop it."""
    P = 5000
    valid = torch.ones((1, P), dtype=torch.bool, device=dev)
    cand_e = torch.full((1, 2, 2500), -1, dtype=torch.int32, device=dev)
    cand_e[0, 0, 2:10] = torch.arange(10, 50, 5, dtype=torch.int32, device=dev)
    cand_e[0, 0, 2400] = 2100
    ep, _ = nms_cuda.greedy_nms(valid, cand_e, torch.full_like(cand_e, -1), 12, 12, 1, form=form)
    got = ep[0, 0].cpu()
    assert sorted(got[got >= 0].tolist()) == list(range(10, 50, 5)) + [2100]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("size", [1025, 2048, 4096, 8192, 16384])
def test_sector_sort_wide_sectors_match_plain(dev, dtype, size):
    """Sectors of more than 1,024 slots (a block a slice, in shared memory)
    with NaNs, +inf, -0.0 beside +0.0 and ties: positions equal, keys equal
    bit for bit."""
    c = torch.from_numpy(corner_values(size, 3, size)).to(dev, dtype)
    npad = 1 << (size - 1).bit_length()
    assert bitonic_cuda.kernel_form(npad, dtype, dev) == "shared"
    before = bitonic_cuda.sector_sort.launches
    (ka, pa), (kb, pb) = bitonic_cuda.sector_sort(c, 1), bitonic_cuda.sector_sort_reference(c, 1)
    assert bitonic_cuda.sector_sort.launches == before + 1
    assert torch.equal(pa, pb)
    as_bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(ka.view(as_bits), kb.view(as_bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", bitonic_cuda.FORMS)
@pytest.mark.parametrize("P,S", [(1000, 3), (5000, 2), (40000, 1)])
def test_sector_sort_every_form(dev, dtype, form, P, S):
    """Each form forced where it holds the slice (the warp form refuses a
    slice padded past 1,024 slots when forced); a 40,000-slot sector takes
    device memory by itself."""
    npad = 1 << (P // S + P % S - 1).bit_length()
    if form == "warp" and npad > 1024:
        with pytest.raises(ValueError):
            bitonic_cuda.kernel_form(npad, dtype, dev, form)
        return
    if form == "shared" and npad > 16384:
        with pytest.raises(ValueError):
            bitonic_cuda.kernel_form(npad, dtype, dev, form)
        return
    if P == 40000:
        assert bitonic_cuda.kernel_form(npad, dtype, dev) == "global"
    c = torch.from_numpy(corner_values(P, 2, P)).to(dev, dtype)
    (ka, pa), (kb, pb) = bitonic_cuda.sector_sort(c, S, form=form), bitonic_cuda.sector_sort_reference(c, S)
    assert torch.equal(pa, pb)
    as_bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(ka.view(as_bits), kb.view(as_bits))


#: F9's shapes: (lines, points a line, sectors)
WIDE_SCANS = {"16x3600": (16, 3600, 6), "64x2083": (64, 2083, 6), "64x2048_one_sector": (64, 2048, 1)}


@pytest.mark.parametrize("shape", sorted(WIDE_SCANS))
def test_f9_wide_scans_extract_on_the_card(dev, shape):
    """F9: at these widths the sort and the NMS refused the launch, so every
    extraction path failed on the card. ``extract_features_batch`` launches
    both kernels and its output equals the CPU path's (picks, masks and
    coordinates) and its picks the f64 oracle's, index for index."""
    import loam_tpu_torch as T
    from loam_tpu_torch.io import render_scan
    from loam_tpu_torch.oracle import extract_features as oracle_extract

    L, P, S = WIDE_SCANS[shape]
    lidar = T.LidarParams(L, P, 0.5, 80.0)
    fp = T.FeatureExtractionParams(number_sectors=S, precise_selection=True)
    scan = render_scan(lidar, noise=0.005, seed=3, dtype=np.float32)
    before = bitonic_cuda.sector_sort.launches, nms_cuda.greedy_nms.launches
    on_card = T.extract_features_batch(torch.from_numpy(scan[None]).to(dev), lidar, fp)
    assert (bitonic_cuda.sector_sort.launches, nms_cuda.greedy_nms.launches) == (before[0] + 1, before[1] + 1)
    on_cpu = T.extract_features_batch(torch.from_numpy(scan[None]), lidar, fp)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    e, p = on_card.map(lambda x: x[0].cpu()).compact_indices()
    oe, op = oracle_extract(scan.astype(np.float64), lidar, fp)
    assert len(e) > 0 and len(p) > 0
    assert e.tolist() == oe and p.tolist() == op


def test_f11_float64_scan_to_map_on_the_card(dev):
    """F11: ``scan_to_map_offline`` on float64 scans from its default state
    (float32 maps) raised on the card: the search runs in the maps' float32
    (the kernel), and the ICF loop carried the kernel's warm start in the
    frames' float64 (``TypeError`` on ``seed_prev``). It runs now, the
    kernel launched, and each pair's relative pose is within 2 mm and
    1e-3 rad of the CPU's run (the per-pair float32 gate: the search and
    the fits run in float32), with equal termination codes."""
    import loam_tpu_torch as T
    from loam_tpu_torch.evaluation import relative_pose_gaps
    from loam_tpu_torch.io import render_trajectory

    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    scans, _ = render_trajectory(lidar, 6, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float64)
    cfg = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
    before = knn_cuda.knn_run.launches
    st, tr, det = T.scan_to_map_offline(torch.from_numpy(scans).to(dev), lidar, config=cfg)
    assert knn_cuda.knn_run.launches > before
    assert len(st.knn_prep_cache) == 16 and tr.translation.dtype == torch.float64
    _, tr_c, det_c = T.scan_to_map_offline(torch.from_numpy(scans), lidar, config=cfg)
    dt, angle = relative_pose_gaps(tr.translation.cpu().numpy(), tr.rotation.cpu().numpy(),
                                   tr_c.translation.numpy(), tr_c.rotation.numpy())
    assert np.linalg.norm(dt, axis=1).max() <= 2e-3 and angle.max() <= 1e-3
    assert torch.equal(det.termination.cpu(), det_c.termination)


@pytest.mark.parametrize("cell", ["offline-c4", "s2m"])
def test_f12_whole_call_pool_follows_what_it_holds(dev, cell):
    """F12: a trajectory call's memory pool grew with the frames 20x faster
    than what the call holds, the extraction's workspace (~8 MB a 64x1024
    frame) kept for every frame. At 16 and at 48 frames of 64x1024 the
    pool's growth is at most 1.25x the growth of the call's outputs and
    hoisted features plus 64 MiB (the allocator's rounding of each stacked
    buffer), as ``chip_smoke.py`` phase 16 holds it at 128 frames."""
    import loam_tpu_torch as T
    from loam_tpu_torch.io import render_trajectory
    from loam_tpu_torch.registration import loop

    lidar = T.LidarParams(64, 1024, 0.5, 120.0)
    fp = T.FeatureExtractionParams(precise_selection=True)
    scans_np, _ = render_trajectory(lidar, 48, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
                                    noise=0.005, seed=0, dtype=np.float32)
    scans = torch.from_numpy(scans_np).to(dev)
    frame = sum(x.numel() * x.element_size() for x in T.extract_features_batch(scans[:1], lidar, fp))
    rows = []
    for n in (16, 48):
        loop.clear_cache()
        if cell == "s2m":
            out = T.scan_to_map_offline(scans[:n], lidar, fp)[1:]
        else:
            out = T.odometry_offline(scans[:n], lidar, fp, chunk_pairs=4, motion_init=True)
        (g,) = loop.graph_stats()
        held = sum(x.numel() * x.element_size() for x in _tensor_leaves(out)) + frame * n
        rows.append((g["pool_bytes"], held))
    loop.clear_cache()
    grow, need = rows[1][0] - rows[0][0], rows[1][1] - rows[0][1]
    assert grow <= 1.25 * need + (64 << 20), rows


@pytest.mark.parametrize("name", sorted(EXTRACTION_SCENES))
def test_edge_extraction_scenes_on_the_card(dev, name):
    """The degenerate extraction scenes of ``test_torch_edge_cases.py``
    through the kernels: picks equal to the CPU path's."""
    import loam_tpu_torch as T

    scene = EXTRACTION_SCENES[name]()
    lidar, fp = T.LidarParams(**scene["lidar"]), T.FeatureExtractionParams(**scene["fp"])
    before = nms_cuda.greedy_nms.launches
    got = T.extract_features(torch.from_numpy(scene["scan"]).to(dev), lidar, fp)
    assert nms_cuda.greedy_nms.launches == before + 1
    want = T.extract_features(torch.from_numpy(scene["scan"]), lidar, fp)
    for a, b in zip(got.map(lambda x: x.cpu()).compact_indices(), want.compact_indices()):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(REGISTRATION_SCENES))
def test_edge_registration_scenes_on_the_card(dev, name):
    """The degenerate registration scenes of ``test_torch_edge_cases.py`` on
    the card against the CPU: termination and iterations equal; poses within
    1e-9 in float64 (the same plain search, sums in another order) and 1e-4
    in float32 (the kNN kernel's matches equal the plain search's; the normal
    equations of up to 3,675 points at 100 m round in another order)."""
    import loam_tpu_torch as T

    scene = REGISTRATION_SCENES[name]()
    dtype = getattr(torch, scene["dtype"])
    params = T.RegistrationParams(**scene["reg"])
    out = []
    for d in (dev, "cpu"):
        src = T.feature_set_from_points(*scene["source"], dtype=dtype, device=d, **scene["capacities"])
        out.append(T.register_features(src, T.feature_set_from_points(*scene["target"], dtype=dtype, device=d),
                                       None, params))
    (eg, dg), (ec, dc) = out
    assert int(dg.termination) == int(dc.termination)
    assert int(dg.num_iterations) == int(dc.num_iterations)
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(eg.translation.cpu().numpy(), ec.translation.numpy(), atol=tol, rtol=0)
    np.testing.assert_allclose(eg.rotation.cpu().numpy(), ec.rotation.numpy(), atol=tol, rtol=0)


def _tensor_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for part in tree for x in _tensor_leaves(part)]
    return []


def _icf_chunk(dev):
    """Three pairs of 16x360 features on the card, azimuth-sorted: two real
    pairs from the identity and one whose source is emptied
    (INSUFFICIENT)."""
    import loam_tpu_torch as T
    from loam_tpu_torch.io import render_trajectory
    from loam_tpu_torch.registration import azimuth_sort_features

    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    scans, _ = render_trajectory(lidar, 4, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float32)
    f = T.extract_features_batch(torch.from_numpy(scans).to(dev), lidar, post=azimuth_sort_features)
    src, tgt = f.map(lambda x: x[1:]), f.map(lambda x: x[:-1])
    keep = torch.tensor([True, True, False], device=dev)
    src = src._replace(edge_mask=src.edge_mask & keep[:, None], planar_mask=src.planar_mask & keep[:, None])
    return src, tgt, T.Pose3.identity(torch.float32, (3,), dev)


@pytest.mark.parametrize("max_iterations", [2, 10])
@pytest.mark.parametrize("path", ["seeded", "unseeded", "preps", "dual"])
def test_icf_graph_matches_eager_loop(dev, monkeypatch, path, max_iterations):
    """The ICF loop replayed as CUDA graphs against the eager loop on the
    same inputs: poses, terminations, iteration counts and every detail row
    bit-equal, the kNN launch counters moved alike; a second call through the
    cached graphs equal again. Paths: the single kNN with its seed bounds
    (graphs A and B), without them (one graph), on preps handed over as
    scan-to-map's cache hands them (seeded: two graphs), and the dual kNN."""
    from loam_tpu_torch.params import RegistrationParams, TerminationType
    from loam_tpu_torch.registration import icf, loop

    monkeypatch.setenv("LOAM_KNN_SEED", "0" if path == "unseeded" else "1")
    monkeypatch.setenv("LOAM_ICF_DUAL_KNN", "1" if path == "dual" else "0")
    src, tgt, init = _icf_chunk(dev)
    kw = {}
    if path == "preps":
        kw["target_preps"] = (knn_cuda.knn_prep(tgt.edge_points, tgt.edge_mask),
                              knn_cuda.knn_prep(tgt.planar_points, tgt.planar_mask))
    params = RegistrationParams(max_iterations=max_iterations)
    args = (src, tgt, init, params, True)

    def counted(fn):
        before = [c.launches for c in loop.COUNTED]
        out = fn(*args, reorder_mode="none", **kw)
        torch.cuda.synchronize()
        return out, [c.launches - b for c, b in zip(loop.COUNTED, before)]

    loop.clear_cache()
    eager, n_eager = counted(icf._register_eager)
    graph, n_graph = counted(icf._register_impl)
    again, n_again = counted(icf._register_impl)
    assert n_graph == n_eager == n_again and sum(n_eager) > 0
    want = _tensor_leaves(eager)
    for got in (graph, again):
        got = _tensor_leaves(got)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    term = eager[1].termination.tolist()
    assert term[2] == TerminationType.INSUFFICIENT_ASSOCIATIONS
    assert max_iterations == 10 or TerminationType.MAX_ITER in term
    (stats,) = loop.graph_stats()
    assert stats["path"] == ("single" if path in ("seeded", "unseeded") else path)
    assert stats["seeded"] == (path in ("seeded", "preps"))
    # one graph a registration: the later iterations under one WHILE node
    assert stats["if_nodes"] == 1 and stats["conditional_nodes"] == {"if": 0, "while": 1}
    assert stats["replays"] == 2  # one a call
    assert stats["pool_bytes"] > 0 and stats["capture_s"] > 0


def test_icf_eager_paths_capture_nothing(dev, monkeypatch):
    """Two paths stay on the eager loop by design: ``LOAM_DEBUG_NANS=1``
    (its checks read values on the host) and a caller's own ``custom_knn``
    (which may read the host): no graph is captured, and each equals the
    graph of the same search bit for bit. The grid search is a captured
    path (one graph, bit-equal to its eager run), and float64 (the plain
    search on the card) is captured like float32."""
    from loam_tpu_torch.params import RegistrationParams
    from loam_tpu_torch.registration import icf, loop

    src, tgt, init = _icf_chunk(dev)
    rp = RegistrationParams()
    loop.clear_cache()
    monkeypatch.setenv("LOAM_DEBUG_NANS", "1")
    debug = icf._register_impl(src, tgt, init, rp, True)
    assert loop.graph_stats() == []
    monkeypatch.delenv("LOAM_DEBUG_NANS")
    # the caller's own search: the single kNN on preps made outside, unseeded
    e_prep = knn_cuda.knn_prep(tgt.edge_points, tgt.edge_mask)
    p_prep = knn_cuda.knn_prep(tgt.planar_points, tgt.planar_mask)
    custom = (lambda q: knn_cuda.knn_run(e_prep, q, rp.num_edge_neighbors, rp.max_edge_neighbor_dist,
                                         with_coords=True, query_mask=src.edge_mask),
              lambda q: knn_cuda.knn_run(p_prep, q, rp.num_plane_neighbors, rp.max_plane_neighbor_dist,
                                         with_coords=True, query_mask=src.planar_mask))
    mine = icf._register_impl(src, tgt, init, rp, True, custom_knn=custom)
    assert loop.graph_stats() == []
    monkeypatch.setenv("LOAM_KNN_SEED", "0")
    unseeded = icf._register_impl(src, tgt, init, rp, True, reorder_mode="none")
    monkeypatch.delenv("LOAM_KNN_SEED")
    graph = icf._register_impl(src, tgt, init, rp, True)
    assert [s["seeded"] for s in loop.graph_stats()] == [False, True]
    for a, b in zip(_tensor_leaves(graph), _tensor_leaves(debug)):
        assert torch.equal(a, b)
    for a, b in zip(_tensor_leaves(unseeded), _tensor_leaves(mine)):
        assert torch.equal(a, b)
    grid = RegistrationParams(search_backend="grid")
    loop.clear_cache()
    got = icf._register_impl(src, tgt, init, grid, True)
    (g,) = loop.graph_stats()
    assert g["path"] == "grid" and g["conditional_nodes"] == {"if": 0, "while": 1}
    with loop._eager():
        want = icf._register_impl(src, tgt, init, grid, True)
    for a, b in zip(_tensor_leaves(got), _tensor_leaves(want)):
        assert torch.equal(a, b)
    f64 = lambda fs: fs.map(lambda x: x.double() if x.is_floating_point() else x)
    icf._register_impl(f64(src), f64(tgt), _pose64(init), RegistrationParams(), False)
    assert [s["seeded"] for s in loop.graph_stats()] == [False, False]


def _pose64(pose):
    return type(pose)(pose.rotation.double(), pose.translation.double())


def test_if_node_runs_its_body_only_where_the_flag_holds(dev):
    """``program.when`` captured as a CUDA-graph IF node: a replay with the
    flag true runs the body, one with it false leaves the body's buffer as
    it was; one graph, one IF node."""
    from loam_tpu_torch import program

    out = torch.zeros(4, device=dev)

    def fn(bufs):
        flag, v = bufs
        program.when(flag, lambda: out.copy_(v * 2.0))

    v = torch.arange(4.0, device=dev)
    yes, no = torch.tensor(True, device=dev), torch.tensor(False, device=dev)
    prog = program.Program(dev, (yes, v))
    prog.run(fn, (yes, v))
    torch.cuda.synchronize()
    assert prog.graph is not None and prog.if_nodes == 1 and torch.equal(out, 2.0 * v)
    out.fill_(-1.0)
    prog.run(fn, (no, v + 1.0))
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, -1.0))
    prog.run(fn, (yes, v + 1.0))
    torch.cuda.synchronize()
    assert torch.equal(out, 2.0 * (v + 1.0)) and prog.replays == 3


def test_while_node_with_a_nested_if_matches_eager(dev):
    """``program.while_loop`` captured as a CUDA-graph WHILE node with an IF
    node inside its body: replays with 7, 0, 1 and 7 iterations (the limit a
    buffer of the program) equal the eager run bit for bit, the IF body
    running only in the iterations whose flag holds; one graph, one WHILE
    and one IF node."""
    from loam_tpu_torch import program

    def fn(bufs):
        n, v = bufs
        acc = torch.zeros(4, device=dev)
        k = torch.zeros((), dtype=torch.int64, device=dev)
        going = k < n

        def body():
            acc.mul_(0.5).add_(v)
            program.when(acc.sum() > 10.0, lambda: acc.sub_(3.0))
            k.add_(1)
            torch.lt(k, n, out=going)

        program.while_loop(going, body)
        return acc, k

    v = torch.arange(4.0, device=dev) + 1.5
    prog = program.Program(dev, (torch.zeros((), dtype=torch.int64, device=dev), v))
    for i, limit in enumerate((7, 0, 1, 7)):
        n = torch.full((), limit, dtype=torch.int64, device=dev)
        got = prog.own(prog.run(fn, (n, v * (i + 1))))
        with program.eager():
            want = program.Program(dev, (n, v)).run(fn, (n, v * (i + 1)))
        torch.cuda.synchronize()
        assert int(got[1]) == limit
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (limit, a, b)
    assert prog.graph is not None and prog.conditional == {"if": 1, "while": 1} and prog.replays == 4
    assert prog.nodes > 4  # the graph's and both bodies'


DRIVER_CELLS = ("s2m", "s2m-dewarp", "s2s-dewarp-dual", "offline-c4", "offline-c4-dual", "stream-k8")


def _driver_run(dev, cell, F=9):
    """A driver's run on ``F`` frames of 16x360 on the card, and how many
    program launches its loop makes: one a call for the trajectory drivers,
    one a frame or a chunk for scan-to-scan and streaming."""
    import loam_tpu_torch as T
    from loam_tpu_torch import program
    from loam_tpu_torch.io import render_trajectory

    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    scans_np, _ = render_trajectory(lidar, F, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                    noise=0.003, seed=11, dtype=np.float32)
    scans = torch.from_numpy(scans_np).to(dev)
    cfg = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
    if cell.startswith("s2m"):
        return (lambda: T.scan_to_map_offline(scans, lidar, config=cfg, dewarp=cell == "s2m-dewarp")), 1
    if cell.startswith("offline"):
        return (lambda: T.odometry_offline(scans, lidar, chunk_pairs=4, motion_init=True)), 1
    if cell == "stream-k8":
        return (lambda: T.odometry_streaming(scans_np, lidar, chunk_frames=8, device=dev)), 2

    def s2s():
        s, out = T.scan_to_scan_init(lidar, device=dev), []
        with torch.profiler.record_function(program.DRIVER_RANGE):
            for f in range(F):
                s, pose, det = T.scan_to_scan_step(s, scans[f], lidar, dewarp=True)
                out.append((pose, det))
        return s, out
    return s2s, F


@pytest.mark.parametrize("cell", DRIVER_CELLS)
def test_one_program_drivers_match_the_eager_loop(dev, monkeypatch, cell):
    """Each driver with one program a call (``odometry_offline``,
    ``scan_to_map_offline``) or a frame or chunk (scan-to-scan, streaming):
    one CUDA-graph launch, the scan over chunks or frames and the ICF loop's
    later iterations under WHILE nodes, the keyframe insert under an IF
    node; against the same driver eager (``program.eager``: host branches
    and loops, the graphs' plain version): every output tensor bit-equal
    (poses, terminations, iteration counts, detail rows, maps, the prep
    cache), every kernel's launches and the outer iterations equal; inside
    the driver's range one ``cudaGraphLaunch`` a call, frame or chunk and no
    read of the device."""
    from torch.profiler import ProfilerActivity, profile

    from loam_tpu_torch import program
    from loam_tpu_torch.profiling import host_reads, launch_calls
    from loam_tpu_torch.registration import loop

    monkeypatch.setenv("LOAM_ICF_DUAL_KNN", "1" if "dual" in cell else "0")
    run, launches = _driver_run(dev, cell)
    counted = (bitonic_cuda.sector_sort, nms_cuda.greedy_nms, assemble_cuda.select_points,
               knn_cuda.knn_run, knn_cuda.knn_dual_run)

    def counts(fn):
        for c in counted:
            c.launches = 0
        n0 = loop.iterations
        out = fn()
        torch.cuda.synchronize()
        return out, [c.launches for c in counted] + [loop.iterations - n0]

    loop.clear_cache()
    graph, n_graph = counts(run)
    with loop._eager():
        eager, n_eager = counts(run)
    assert n_graph == n_eager and n_graph[-1] > 0, (n_graph, n_eager)
    got, want = _tensor_leaves(graph), _tensor_leaves(eager)
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    stats = loop.graph_stats()
    assert stats and all(s["if_nodes"] > 0 for s in stats)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = run()
        torch.cuda.synchronize()
    events = prof.events()
    _, inside = launch_calls(events, within=program.DRIVER_RANGE)
    assert inside.get("cudaGraphLaunch", 0) == launches, inside
    assert host_reads(events) == {}
    for a, b in zip(_tensor_leaves(again), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell", ["offline-c4", "s2m"])
def test_whole_call_graph_size_does_not_depend_on_frames(dev, cell):
    """A trajectory call's graph at 9 and at 17 frames (8 and 16 pairs: no
    padded chunk in either) holds the same nodes, counted with its bodies
    once each, and one WHILE node for the extraction's blocks (one block at
    9 frames, two at 17; F12), one for the scan, one for the ICF loop inside
    it (offline: two more for the composition's tree; scan-to-map: the
    keyframe's IF node); each run one
    ``cudaGraphLaunch``, bit-equal to its eager run with the same launches
    and ICF iterations."""
    from torch.profiler import ProfilerActivity, profile

    from loam_tpu_torch import program
    from loam_tpu_torch.profiling import host_reads, launch_calls
    from loam_tpu_torch.registration import loop

    counted = (bitonic_cuda.sector_sort, nms_cuda.greedy_nms, assemble_cuda.select_points,
               knn_cuda.knn_run, knn_cuda.knn_dual_run)
    stats = []
    for F in (9, 17):
        run, _ = _driver_run(dev, cell, F)
        outs = []
        for eager in (False, True):
            for c in counted:
                c.launches = 0
            n0 = loop.iterations
            loop.clear_cache() if not eager else None
            with program.eager() if eager else contextlib.nullcontext():
                out = run()
            torch.cuda.synchronize()
            outs.append((out, [c.launches for c in counted] + [loop.iterations - n0]))
            if not eager:
                (g,) = loop.graph_stats()
                stats.append(g)
        (graph, n_graph), (want, n_eager) = outs
        assert n_graph == n_eager and n_graph[-1] > 0
        for a, b in zip(_tensor_leaves(graph), _tensor_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        _, inside = launch_calls(prof.events(), within=program.DRIVER_RANGE)
        assert inside.get("cudaGraphLaunch", 0) == 1 and host_reads(prof.events()) == {}
    assert stats[0]["nodes"] == stats[1]["nodes"] > 0, stats
    # the extraction's blocks, the scan and the ICF loop; offline's
    # composition is two scans more
    want_nodes = {"if": 1, "while": 3} if cell == "s2m" else {"if": 0, "while": 5}
    assert stats[0]["conditional_nodes"] == stats[1]["conditional_nodes"] == want_nodes, stats
    assert stats[1]["pool_bytes"] >= stats[0]["pool_bytes"]


# ---- the sharded drivers as one program each, collectives inside the graph ----------


@pytest.fixture(scope="module")
def nccl_meshes():
    """A mesh of 4 shards of the card, and a (2 data x 2 line) one, in a
    world-size-1 NCCL group started in this process (NCCL takes one rank a
    GPU); the meshes' programs are released before the group is destroyed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    import os
    import socket

    import torch.distributed as dist

    from loam_tpu_torch import parallel

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    dev = torch.device("cuda", 0)
    meshes = (parallel.make_mesh([dev] * 4, group=dist.group.WORLD),
              parallel.make_mesh([dev] * 4, line_axis=2, group=dist.group.WORLD))
    yield meshes
    for mesh in meshes:
        mesh.release()
    dist.destroy_process_group()


SHARDED_CELLS = ("s2m", "offline", "extract", "pairs", "register")


def _sharded_run(meshes, cell, F=8, max_iterations=10):
    """A sharded driver's run on ``F`` frames of 16x360 on the card, and how
    many program launches it makes: one a frame for scan-to-map, one a call
    for the others."""
    import loam_tpu_torch as T
    from loam_tpu_torch import parallel, program
    from loam_tpu_torch.io import render_trajectory
    from loam_tpu_torch.parallel import distributed as tdist
    from loam_tpu_torch.registration import azimuth_sort_features, spatial_sort_features

    mesh, mesh22 = meshes
    dev = mesh.device
    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    scans_np, _ = render_trajectory(lidar, F, step=np.array([0.2, 0.05, 0.0]), yaw_rate=0.02,
                                    noise=0.003, seed=11, dtype=np.float32)
    scans = torch.from_numpy(scans_np).to(dev)
    reg = T.RegistrationParams(max_iterations=max_iterations)
    if cell == "s2m":
        cfg = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
        s2m_reg = T.RegistrationParams(max_iterations=max_iterations, prior_weight=300.0)

        def s2m():
            st, out = tdist.scan_to_map_init_sharded(cfg, mesh), []
            for f in range(F):
                st, pose, det = tdist.scan_to_map_step_sharded(st, scans[f], lidar, mesh, config=cfg,
                                                               reg_params=s2m_reg)
                out.append((pose, det))
            return st, out
        return s2m, F
    if cell == "offline":
        return (lambda: parallel.odometry_offline_sharded(scans, lidar, mesh, reg_params=reg)), 1
    if cell == "extract":
        return (lambda: parallel.extract_features_sharded(scans, lidar, mesh22)), 1
    feats = T.extract_features_batch(scans, lidar, post=azimuth_sort_features)
    if cell == "pairs":
        src, tgt = feats.map(lambda x: x[1:5]), feats.map(lambda x: x[:4])
        ident = T.Pose3.identity(torch.float32, (4,), dev)
        return (lambda: parallel.register_pairs_sharded(src, tgt, ident, mesh, reg)), 1
    src = spatial_sort_features(feats.map(lambda x: x[1]))
    tgt = feats.map(lambda x: x[0])  # 192 / 384 slots: 48 / 96 a shard

    def register():
        with torch.profiler.record_function(program.DRIVER_RANGE):
            return tdist.register_features_sharded(src, tgt, T.Pose3.identity(torch.float32, device=dev), mesh,
                                                   reg, with_matches=True)
    return register, 1


@pytest.mark.parametrize("cell", SHARDED_CELLS)
def test_sharded_program_matches_eager(nccl_meshes, cell):
    """Each sharded driver call (a scan-to-map frame) one CUDA graph with
    its gathers inside, on a world-size-1 NCCL group: every output tensor
    bit-equal to the same calls eager (``program.eager``), every kernel's
    launches and the outer ICF iterations equal; conditional nodes in every
    program but extraction's; inside the driver's range one
    ``cudaGraphLaunch`` a call or frame and no read of the device."""
    from torch.profiler import ProfilerActivity, profile

    from loam_tpu_torch import program
    from loam_tpu_torch.profiling import host_reads, launch_calls
    from loam_tpu_torch.registration import loop

    from loam_tpu_torch.ops import peer_cuda

    run, launches = _sharded_run(nccl_meshes, cell)
    counted = (bitonic_cuda.sector_sort, nms_cuda.greedy_nms, assemble_cuda.select_points,
               knn_cuda.knn_run, knn_cuda.knn_dual_run, peer_cuda.peer_sum, peer_cuda.peer_gather)

    def counts(fn):
        for c in counted:
            c.launches = 0
        n0 = loop.iterations
        out = fn()
        torch.cuda.synchronize()
        return out, [c.launches for c in counted] + [loop.iterations - n0]

    loop.clear_cache()
    graph, n_graph = counts(run)
    with loop._eager():
        eager, n_eager = counts(run)
    assert n_graph == n_eager and sum(n_graph) > 0 and n_graph[-2] > 0, (n_graph, n_eager)
    assert (n_graph[-1] > 0) == (cell != "extract")
    got, want = _tensor_leaves(graph), _tensor_leaves(eager)
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    stats = loop.graph_stats()
    assert len(stats) == 1 and (stats[0]["if_nodes"] > 0) == (cell != "extract"), stats

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = run()
        torch.cuda.synchronize()
    events = prof.events()
    _, inside = launch_calls(events, within=program.DRIVER_RANGE)
    assert inside.get("cudaGraphLaunch", 0) == launches, inside
    assert host_reads(events) == {}
    for a, b in zip(_tensor_leaves(again), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell", ["s2m", "offline"])
def test_sharded_program_nodes_do_not_depend_on_frames_or_iterations(nccl_meshes, cell):
    """The sharded scan-to-map frame's and offline call's graphs hold the
    same conditional nodes at 4 and 8 frames and at 2 and 10 ICF
    iterations: the loop one WHILE node with the sharded search inside,
    scan-to-map's keyframe insert one IF node; offline's loop one WHILE
    node a shard (each shard registers its block of pairs in one batch,
    ``sharding._per_row``) and its composition two WHILE nodes more. Their
    nodes (bodies once) are the same at 2 and 10 iterations, and
    scan-to-map's (a program a frame) at 4 and 8 frames; a shard's batch
    of pairs has a kNN split plan (``knn_cuda._splits``: a merge kernel
    where the targets split) that follows the number of pairs, so
    offline's nodes may follow the frames."""
    from loam_tpu_torch.registration import loop

    stats = []
    for F, iters in ((4, 2), (8, 2), (8, 10)):
        run, _ = _sharded_run(nccl_meshes, cell, F, iters)
        loop.clear_cache()
        run()
        torch.cuda.synchronize()
        (g,) = loop.graph_stats()
        stats.append((g["nodes"], g["conditional_nodes"]))
    want = {"if": 1, "while": 1} if cell == "s2m" else {"if": 0, "while": 2 + nccl_meshes[0].size}
    assert [c for _, c in stats] == [want] * 3 and stats[1][0] == stats[2][0], stats
    assert cell != "s2m" or stats[0][0] == stats[1][0], stats


# ---- the mesh's gather over peer memory (ops/csrc/peer_gather.cu) ---------------------


def _peer_inputs(dev):
    """Per-shard blocks of 4 shards: float64 past the first mailbox slot (it
    grows), odd sizes that take the kernel's byte path, int32, bool."""
    g = torch.Generator().manual_seed(3)
    return [torch.randn((4, 40_001), generator=g, dtype=torch.float64).to(dev),
            torch.randn((4, 3, 7), generator=g).to(dev),
            torch.randint(-2**31, 2**31 - 1, (4, 5, 33), generator=g, dtype=torch.int32).to(dev),
            (torch.rand((4, 13), generator=g) > 0.5).to(dev)]


@pytest.mark.parametrize("kind", ["while", "if", "if_not", "plain"])
def test_peer_gather_captured_matches_nccl(nccl_meshes, kind):
    """The kernel's gather on a world-size-1 NCCL group's mesh, captured in
    a WHILE body (3 iterations), an IF body (taken and not) and a plain
    graph, replayed: bit-equal to NCCL's ``all_gather_into_tensor`` of the
    same blocks (float64 past the first mailbox slot, float32 and int32 of
    odd sizes, bool), one counted launch a gather that ran."""
    from loam_tpu_torch import program
    from loam_tpu_torch.ops import peer_cuda
    from loam_tpu_torch.parallel import collectives

    mesh, _ = nccl_meshes
    dev = mesh.device
    for x in _peer_inputs(dev):
        want = peer_cuda.peer_gather_reference(x, mesh.group)  # NCCL's all_gather_into_tensor

        def fn(bufs):
            xb, n = bufs
            out = torch.zeros_like(want)
            if kind == "while":
                i = torch.zeros((), dtype=torch.int64, device=dev)
                going = i < n

                def body():
                    out.copy_(collectives.gather(mesh, xb))
                    i.add_(1)
                    going.copy_(i < n)

                program.while_loop(going, body)
            elif kind == "plain":
                out.copy_(collectives.gather(mesh, xb))
            else:
                program.when(n > 2, lambda: out.copy_(collectives.gather(mesh, xb)))
            return out

        n = torch.full((), 2 if kind == "if_not" else 3, dtype=torch.int64, device=dev)
        prog = program.Program(dev, (x, n))
        prog.run(fn, (x, n))  # the capture
        peer_cuda.peer_gather.launches = 0
        got = program.clone(prog.run(fn, (x, n)))
        torch.cuda.synchronize()
        ran = {"while": 3, "if": 1, "if_not": 0, "plain": 1}[kind]
        assert peer_cuda.peer_gather.launches == ran
        assert prog.graph is not None and prog.conditional == {
            "if": int(kind.startswith("if")), "while": int(kind == "while")}
        if ran:
            assert got.dtype == want.dtype and torch.equal(got, want)
        else:
            assert not got.any()


@pytest.mark.parametrize("kind", ["while", "if", "if_not", "plain"])
def test_peer_tree_and_sum_captured_match_plain(nccl_meshes, kind):
    """The kernel's tree gather (every leaf of ``_peer_inputs`` in one
    launch, and a 0-length leaf) and its fixed-order sum (float32, float64,
    int32 and int64 blocks of 4 shards, magnitudes far apart) on a
    world-size-1 NCCL group's mesh, captured in a WHILE body (3
    iterations), an IF body (taken and not) and a plain graph, replayed:
    each leaf bit-equal to NCCL's gather of it, each sum to the gather then
    the adds in shard order; one counted launch a collective that ran, and
    one graph node each when captured alone."""
    from loam_tpu_torch import program
    from loam_tpu_torch.ops import peer_cuda
    from loam_tpu_torch.parallel import collectives

    mesh, _ = nccl_meshes
    dev = mesh.device
    g = torch.Generator().manual_seed(5)
    tree = tuple(_peer_inputs(dev)) + (torch.zeros((4, 0, 3), dtype=torch.int32, device=dev),)
    sums = [(torch.randn((4, 1001), generator=g, dtype=d) * 10.0 ** torch.randint(-6, 7, (4, 1001), generator=g)
             ).to(dev, d) for d in (torch.float32, torch.float64)]
    sums += [torch.randint(-2**30, 2**30, (4, 7, 5), generator=g, dtype=d).to(dev) for d in (torch.int32, torch.int64)]
    want_tree = peer_cuda.peer_gather_reference(list(tree), mesh.group)
    want_sums = [peer_cuda.peer_sum_reference(x, mesh.group) for x in sums]

    def fn(bufs):
        xs, ys, n = bufs
        outs = [torch.zeros_like(w) for w in want_tree] + [torch.zeros_like(w) for w in want_sums]

        def record():
            for o, v in zip(outs, list(collectives.gather(mesh, xs)) + [collectives.sum(mesh, y) for y in ys]):
                o.copy_(v)

        if kind == "while":
            i = torch.zeros((), dtype=torch.int64, device=dev)
            going = i < n

            def body():
                record()
                i.add_(1)
                going.copy_(i < n)

            program.while_loop(going, body)
        elif kind == "plain":
            record()
        else:
            program.when(n > 2, record)
        return tuple(outs)

    n = torch.full((), 2 if kind == "if_not" else 3, dtype=torch.int64, device=dev)
    inputs = (tree, tuple(sums), n)
    prog = program.Program(dev, inputs)
    prog.run(fn, inputs)  # the capture
    peer_cuda.peer_gather.launches = peer_cuda.peer_sum.launches = 0
    got = program.clone(prog.run(fn, inputs))
    torch.cuda.synchronize()
    ran = {"while": 3, "if": 1, "if_not": 0, "plain": 1}[kind]
    assert (peer_cuda.peer_gather.launches, peer_cuda.peer_sum.launches) == (ran, ran * len(sums))
    assert prog.graph is not None and prog.conditional == {
        "if": int(kind.startswith("if")), "while": int(kind == "while")}
    for a, b in zip(got, want_tree + want_sums):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b) if ran else not a.any()

    import ctypes

    from loam_tpu_torch.ops import _build

    for one in (lambda: collectives.gather(mesh, tree), lambda: collectives.sum(mesh, sums[1])):
        stream, nodes = torch.cuda.Stream(), ctypes.c_size_t()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
            one()
            assert _build.lib().loam_capture_nodes(stream.cuda_stream, ctypes.byref(nodes)) == 0
        assert nodes.value == 1


def test_peer_gather_at_one_rank_is_a_copy_without_a_mailbox(nccl_meshes):
    """At world size 1 the gather is one copy kernel and the mesh makes no
    mailbox: a gather of any size runs inside a capture and equals NCCL's.
    (Past one rank, phase 17's probe checks that a gather past the mailbox
    raises inside a capture and that a graph captured before the mailbox
    grew still replays.)"""
    from loam_tpu_torch.ops import peer_cuda
    from loam_tpu_torch.parallel import collectives

    mesh = nccl_meshes[0]
    assert mesh.peer.cap == 0
    x = torch.randn((4, peer_cuda.FIRST_SLOT_BYTES // 4 + 1), device=mesh.device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = collectives.gather(mesh, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, peer_cuda.peer_gather_reference(x, mesh.group)) and mesh.peer.cap == 0


def test_sharded_s2m_replays_after_the_pose_graph(dev, request):
    """Scan-to-map frames, the sharded pose graph, then the same frames
    again on one mesh: the second run replays the frames' cached program
    after the pose graph's larger gathers, bit-equal to the first run and
    to the eager loop."""
    from loam_tpu_torch.registration import loop

    s2m, _ = _sharded_run(request.getfixturevalue("nccl_meshes"), "s2m")
    posegraph, _ = _last_run(dev, "posegraph_sharded", request)
    first = _tensor_leaves(s2m())
    posegraph()
    again = _tensor_leaves(s2m())
    with loop._eager():
        eager = _tensor_leaves(s2m())
    torch.cuda.synchronize()
    assert len(first) == len(again) == len(eager) > 0
    for a, b, c in zip(first, again, eager):
        assert a.dtype == b.dtype == c.dtype and torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("cell", ["s2m", "posegraph"])
def test_sharded_drivers_through_the_peer_gather_one_launch_a_call(dev, request, cell):
    """``scan_to_map_step_sharded`` (8 frames) and
    ``optimize_pose_graph_sharded`` (3 calls) on a world-size-1 group's
    mesh: one cached program, replayed once a frame or call
    (``graph_stats``), its gathers (scan-to-map) and sums (the pose graph)
    the kernel's."""
    from loam_tpu_torch.ops import peer_cuda
    from loam_tpu_torch.registration import loop

    if cell == "s2m":
        run, calls = _sharded_run(request.getfixturevalue("nccl_meshes"), "s2m")
        runs = [run]
    else:
        run, _ = _last_run(dev, "posegraph_sharded", request)
        calls, runs = 3, [run] * 3
    loop.clear_cache()
    peer_cuda.peer_gather.launches = peer_cuda.peer_sum.launches = 0
    for r in runs:
        r()
    torch.cuda.synchronize()
    (stats,) = loop.graph_stats()
    assert stats["replays"] == calls and stats["conditional_nodes"]["while"] >= 1, stats
    if cell == "posegraph":  # the pose graph's collectives are sums: no gather
        assert peer_cuda.peer_sum.launches > 0 and peer_cuda.peer_gather.launches == 0
    else:
        assert peer_cuda.peer_gather.launches > 0


# ---- the mesh across hosts: the cross-host leg (peer_link.h, peer_proxy.cpp) ---------


def _cross_host_ranks(tmp_path, world: int, hosts: str, mode: str) -> list:
    """``world`` ranks of ``tests/torch_cross_host_worker.py`` (a gloo group,
    rank r on card r % cards, one shard a rank, ``hosts``), each rank's
    record."""
    import json
    import socket
    import subprocess
    import sys
    from pathlib import Path

    worker = Path(__file__).resolve().parent / "torch_cross_host_worker.py"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(world), str(port), hosts, mode, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = range(world - 1) if mode == "lost" else range(world)  # the lost rank leaves without a record
    for r in ranks:
        assert (tmp_path / f"rank{r}.json").exists(), f"rank {r}:\n{logs[r][-4000:]}"
    return [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in ranks]


@pytest.mark.parametrize("world,hosts,islands", [(2, "0,1", [[0], [1]]), (2, "machine", [[0, 1]]),
                                                 (4, "0,0,1,1", [[0, 1], [2, 3]]),
                                                 (4, "0,1,2,3", [[0], [1], [2], [3]])])
def test_cross_host_gather_and_sum_match_plain(dev, tmp_path, world, hosts, islands):
    """The kernel's tree gather and fixed-order sum on ``world`` ranks of a
    gloo group (rank r on card r % cards: ranks may share a card) whose
    ``make_mesh(hosts=)`` puts them on hosts that talk through the proxy
    over loopback TCP (``"0,1"``, 2 x 1; ``"0,0,1,1"``, 2 x 2 with an island
    of two on each; ``"0,1,2,3"``, 4 x 1) or on one island (each rank's
    machine): eager, in a plain graph, in a WHILE body and an IF body (taken
    and not), each bit-equal to its plain version over the group, one
    counted launch a collective that ran; a gather past the mailbox raising
    inside a capture, growing eagerly, and the graph captured before still
    replaying; the islands as ``hosts`` and the cards' reach make them."""
    for r, rec in enumerate(_cross_host_ranks(tmp_path, world, hosts, "check")):
        assert rec["islands"] == islands, rec
        assert rec["remote"] == [t for t in range(world) if not any(r in i and t in i for i in islands)], rec
        assert rec["eager"] and rec["eager_launches"] == [1, 4], rec
        for name in ("while3", "if3", "if2", "plain1"):
            assert rec[f"{name}_graph"] and rec[name], (name, rec)
            assert rec[f"{name}_launches"] == rec[f"{name}_want_launches"], (name, rec)
        assert rec["capture_past_mailbox"] is True and rec["grown"] and rec["replay_after_growth"], rec


def test_cross_host_lost_peer_raises(dev, tmp_path):
    """Two ranks on two hosts: the second leaves without releasing the mesh
    while the first waits in a gather for it. The first rank's proxy loses
    its socket, the kernel reads the abort word and traps, and the call
    raises within ``peer_cuda.WAIT_SECONDS``: no hang, no eager fallback."""
    from loam_tpu_torch.ops import peer_cuda

    (rec,) = _cross_host_ranks(tmp_path, 2, "0,1", "lost")
    assert rec["raised"] and rec["seconds"] < peer_cuda.WAIT_SECONDS, rec


# ---- the grid search and the loop-closed back end as one program each -------------

LAST_CELLS = ("grid_register", "grid_s2m", "posegraph64", "posegraph32", "posegraph_sharded", "closures")


def _to_dev(tree, dev, dtype=None):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, dtype if dtype is not None and tree.is_floating_point() else tree.dtype)
    return type(tree)(*(_to_dev(x, dev, dtype) for x in tree))


def _last_run(dev, cell, request, length=None):
    """A run of one of the last paths made programs, on the card, at a small
    size: the run, and the conditional nodes its one program holds.
    ``length``: frames (grid_s2m) or LM iterations (the pose graph)."""
    import loam_tpu_torch as T
    from loam_tpu_torch import program
    from loam_tpu_torch.geometry import Pose3, quat_exp
    from loam_tpu_torch.io import random_pose_graph, render_trajectory, square_loop_scans
    from loam_tpu_torch.loop_closure import optimize_trajectory_with_closures
    from loam_tpu_torch.pose_graph import optimize_pose_graph, optimize_pose_graph_sharded

    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    grid = T.RegistrationParams(search_backend="grid", prior_weight=300.0)
    if cell == "grid_register":
        src, tgt, init = _icf_chunk(dev)

        def register():
            with torch.profiler.record_function(program.DRIVER_RANGE):
                return T.register_features_batch(src, tgt, init, grid, with_matches=True)
        return register, {"if": 0, "while": 1}
    if cell == "grid_s2m":
        F = length or 9
        scans_np, _ = render_trajectory(lidar, F, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                        noise=0.003, seed=11, dtype=np.float32)
        scans = torch.from_numpy(scans_np).to(dev)
        cfg = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
        return (lambda: T.scan_to_map_offline(scans, lidar, reg_params=grid, config=cfg)), {"if": 1, "while": 3}
    if cell.startswith("posegraph"):
        _, init, edges = random_pose_graph(200, 20, seed=4)
        dtype = torch.float32 if cell == "posegraph32" else torch.float64
        init, edges = _to_dev(init, dev, dtype), _to_dev(edges, dev, dtype)
        iterations = length or 10
        if cell != "posegraph_sharded":
            return (lambda: optimize_pose_graph(init, edges, iterations)), {"if": 0, "while": 1}
        mesh, _ = request.getfixturevalue("nccl_meshes")
        # 199 + 20 edges and masked ones (weight 0) to a multiple of the 4 shards
        n = (-edges.i.shape[0]) % 4
        pad = lambda x, v: torch.cat([x, x[:1].expand((n,) + x.shape[1:]) if v is None else v])
        fill = lambda dtype, v: torch.full((n,), v, dtype=dtype, device=dev)
        padded = type(edges)(pad(edges.i, fill(torch.int32, 0)), pad(edges.j, fill(torch.int32, 1)),
                             type(edges.measurement)(*(pad(x, None) for x in edges.measurement)),
                             pad(edges.weight, fill(dtype, 0.0)), pad(edges.mask, fill(torch.bool, False)))

        def sharded():
            with torch.profiler.record_function(program.DRIVER_RANGE):
                return optimize_pose_graph_sharded(init, padded, mesh, iterations)
        return sharded, {"if": 0, "while": 1}
    lo_np, lo_pos, lo_yaw = square_loop_scans(lidar, n_side=4, step=0.4)
    drift = np.cumsum(np.random.default_rng(0).normal(0, 0.01, lo_pos.shape) * [1, 1, 0.2], axis=0)
    traj = Pose3(quat_exp(torch.tensor([[0.0, 0.0, y] for y in lo_yaw])).float().to(dev),
                 torch.from_numpy(lo_pos + drift).float().to(dev))
    feats = T.extract_features_batch(torch.from_numpy(lo_np).to(dev), lidar)
    kw = dict(max_candidates=4, min_separation=8, max_distance=1.5, iterations=8)
    return (lambda: optimize_trajectory_with_closures(traj, feats, T.RegistrationParams(), **kw)), \
        {"if": 0, "while": 2}


@pytest.mark.parametrize("cell", LAST_CELLS)
def test_last_programs_match_eager(dev, request, cell):
    """The grid registration, scan-to-map through the grid, the pose-graph
    solve (float64, float32, on a mesh of 4 shards in a world-size-1 NCCL
    group) and the loop-closed call, each one CUDA graph (the grid's
    searches and the sharded sums inside WHILE nodes, the LM iterations a
    WHILE node): inside the driver's range one ``cudaGraphLaunch`` a call
    and no read of the device; every output tensor bit-equal to the same
    call eager, every kernel's launches and the ICF iterations equal."""
    from torch.profiler import ProfilerActivity, profile

    from loam_tpu_torch import program
    from loam_tpu_torch.profiling import host_reads, launch_calls
    from loam_tpu_torch.registration import loop

    from loam_tpu_torch.ops import peer_cuda

    run, want_nodes = _last_run(dev, cell, request)
    counted = (bitonic_cuda.sector_sort, nms_cuda.greedy_nms, assemble_cuda.select_points,
               knn_cuda.knn_run, knn_cuda.knn_dual_run, peer_cuda.peer_gather, peer_cuda.peer_sum)

    def counts(fn):
        for c in counted:
            c.launches = 0
        n0 = loop.iterations
        out = program.clone(fn())
        torch.cuda.synchronize()
        return out, [c.launches for c in counted] + [loop.iterations - n0]

    loop.clear_cache()
    graph, n_graph = counts(run)
    with loop._eager():
        eager, n_eager = counts(run)
    assert n_graph == n_eager, (n_graph, n_eager)
    assert (n_graph[-1] > 0) == (not cell.startswith("posegraph"))
    assert (n_graph[-2] > 0) == (cell == "posegraph_sharded")
    got, want = _tensor_leaves(graph), _tensor_leaves(eager)
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    (stats,) = loop.graph_stats()
    assert stats["conditional_nodes"] == want_nodes and stats["replays"] == 1, stats

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = run()
        torch.cuda.synchronize()
    events = prof.events()
    _, inside = launch_calls(events, within=program.DRIVER_RANGE)
    assert inside.get("cudaGraphLaunch", 0) == 1, inside
    assert host_reads(events) == {}
    for a, b in zip(_tensor_leaves(again), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell", ["grid_s2m", "posegraph"])
def test_last_programs_nodes_do_not_depend_on_length(dev, request, cell):
    """Scan-to-map through the grid at 9 and 17 frames, and the float64
    pose-graph solve at 10 and 40 LM iterations: the same graph nodes
    (bodies counted once) and conditional nodes, each run bit-equal to its
    eager run."""
    from loam_tpu_torch import program
    from loam_tpu_torch.registration import loop

    stats = []
    name = "posegraph64" if cell == "posegraph" else cell
    for length in ((9, 17) if cell == "grid_s2m" else (10, 40)):
        run, want_nodes = _last_run(dev, name, request, length)
        loop.clear_cache()
        got = program.clone(run())
        (g,) = loop.graph_stats()
        stats.append(g)
        assert g["conditional_nodes"] == want_nodes
        with loop._eager():
            want = run()
        for a, b in zip(_tensor_leaves(got), _tensor_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert stats[0]["nodes"] == stats[1]["nodes"] > 0, stats


# ---- one rank a card: chip_smoke.py phase 17 ------------------------------------------


def test_one_rank_a_card(dev):
    """``chip_smoke.py --ranks-only`` (the build, then phase 17) at this
    machine's card count: N ranks, the largest power of two no greater than
    min(cards, 8), each on its own card in an NCCL group made with
    ``device_id``, running the sharded drivers at full width; every rank's
    outputs bit-equal to rank 0's and to 1 rank x N shards of ``cuda:0``,
    one ``cudaGraphLaunch`` and no host read a call or frame on every rank
    and every cell (the gathers the kernel's over peer memory, in the
    conditional bodies too), no rank holding a context or reserving memory
    on another card; the probe's kernel cases (a gather in a WHILE body, an
    IF body and a plain graph; past one rank a gather past the mailbox
    raising inside a capture, and a graph captured before the mailbox grew
    replayed) accepted and equal to NCCL's, the kernel's gathers and sums
    equal to their plain versions at the cells' shapes on every rank, one
    graph node each, and the scan-to-map frames run again after the pose
    graph equal to their first run."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--ranks-only"], cwd=root,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stdout[-6000:] + run.stderr[-6000:]
    (line,) = [x for x in run.stdout.splitlines() if x.startswith('{"ranks"')]
    rec = json.loads(line)["ranks"]
    n = 1 << (min(torch.cuda.device_count(), 8).bit_length() - 1)
    assert rec["ranks"] == n and rec["cards"] == torch.cuda.device_count() and rec["cross_card"] == (n > 1)
    assert rec["contexts"] == {str(r): [r] for r in range(n)}
    assert sorted(rec["cells"]) == ["extract", "offline", "pairs", "posegraph", "s2m"]
    assert all(rec["probe"][f"peer_{case}"] == "accepted" for case in ("while", "if", "plain")), rec["probe"]
    assert rec["cells"]["s2m"]["again_after_posegraph_equal"] == [True] * n
    assert rec["peer_equal_nccl"] == [True] * n
    assert all(k == 1 for nodes in rec["peer_gather"]["graph_nodes"] for k in nodes.values())
    for name, cell in rec["cells"].items():
        assert cell["graph_launches_per_unit"] == [1.0] * n and cell["host_reads_per_unit"] == [0.0] * n
    # across hosts: every split of the ranks (2 x 2 and 4 x 1 on four cards), or on one card two
    # ranks of two hosts sharing it; phase 17 fails on any output that differs, so the record's
    # cells are the ones that passed
    splits = rec["splits"] if n > 1 else rec["one_card_two_hosts"]
    assert sorted(splits) == (["2x2", "4x1"] if n == 4 else [f"{n}x1"] if n > 1 else ["2x1 on one card"])
    for split in splits.values():
        assert sorted(split["cells"]) == ["extract", "offline", "pairs", "posegraph", "s2m"]
        for cell in split["cells"].values():
            ranks = len(cell["graph_launches_per_unit"])
            assert cell["graph_launches_per_unit"] == [1.0] * ranks and cell["host_reads_per_unit"] == [0.0] * ranks
    if n > 1:
        assert rec["probe"]["peer_bodies@across"] == "accepted"
