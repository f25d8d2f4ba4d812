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

import numpy as np
import pytest
import torch

from torch_nms_cases import NMS_CASES, random_candidates as _candidates
from torch_sort_cases import SORT_CASES

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
    """scan_to_map_offline with the dual kNN on 6 frames of 16x360 scans
    (map capacities 2048/8192), on the GPU and on the CPU."""
    import loam_tpu_torch as T
    from loam_tpu_torch.io import render_trajectory

    monkeypatch.setenv("LOAM_ICF_DUAL_KNN", "1")
    lidar = T.LidarParams(16, 360, 0.5, 80.0)
    scans, _ = render_trajectory(lidar, 6, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float32)
    cfg = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
    before = knn_cuda.knn_dual_run.launches
    sg, tg, dg = T.scan_to_map_offline(torch.from_numpy(scans).to(dev), lidar, config=cfg)
    assert knn_cuda.knn_dual_run.launches > before
    sc, tc, dc = T.scan_to_map_offline(torch.from_numpy(scans), lidar, config=cfg)
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


def test_pose_graph_gpu_matches_cpu(dev):
    """``optimize_pose_graph`` on a 60-node chain with 6 closures: in float64
    the card's solve equals the CPU's within 1e-8 (the card's
    ``index_put_(accumulate=True)`` adds in no fixed order) and recovers the
    true poses; in float32 it stays finite and lowers the cost."""
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
