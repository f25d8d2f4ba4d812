"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test carries the ``cuda`` marker and skips without a CUDA device: the
kernels have no CPU mode. The file imports neither JAX nor ``loam_tpu``, so
on a machine without JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts= -m cuda -q

Selections (sort positions, NMS picks, kNN indices and masks, copied
coordinates) and kNN squared distances must be exactly equal: the kNN kernels
round every step of the distance on their own, as the plain versions do.
The scan-to-map run on the GPU agrees with the same run on the CPU within
1e-2 m (the ICF position convergence threshold).
"""

import numpy as np
import pytest
import torch

from loam_tpu_torch.ops import assemble_cuda, bitonic_cuda, knn_cuda, nms_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _candidates(rng, L, P, S, density=0.5):
    """(L, S, s_max) int32 candidate lists: a random subset of each sector's
    positions, shuffled, at a random offset among -1 slots."""
    pps = P // S
    s_max = P - (S - 1) * pps
    c = np.full((L, S, s_max), -1, np.int32)
    for li in range(L):
        for s in range(S):
            size = s_max if s == S - 1 else pps
            pos = s * pps + rng.permutation(size)[: int(size * density)]
            off = rng.integers(0, s_max - len(pos) + 1)
            c[li, s, off : off + len(pos)] = pos
    return c


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


@pytest.mark.parametrize("L,P,S,max_e,max_p,n", [(32, 1024, 6, 10, 50, 3), (9, 100, 4, 2, 5, 1)])
def test_greedy_nms_matches_plain(dev, L, P, S, max_e, max_p, n):
    rng = np.random.default_rng(L)
    valid = torch.from_numpy(rng.random((L, P)) > 0.2).to(dev)
    ce, cp = (torch.from_numpy(_candidates(rng, L, P, S)).to(dev) for _ in range(2))
    a = nms_cuda.greedy_nms(valid, ce, cp, max_e, max_p, n)
    b = nms_cuda.greedy_nms_reference(valid, ce, cp, max_e, max_p, n)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


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
def test_select_points_matches_plain(dev, dtype):
    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.standard_normal((64, 1024, 3))).to(dev, dtype)
    picks = torch.from_numpy(rng.integers(-1, 1024, (64, 372)).astype(np.int32)).to(dev)
    assert torch.equal(assemble_cuda.select_points(pts, picks),
                       assemble_cuda.select_points_reference(pts, picks))


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


def test_wrappers_refuse_bad_inputs(dev):
    with pytest.raises(TypeError):
        assemble_cuda.select_points(torch.zeros((2, 8, 3), device=dev),
                                    torch.zeros((2, 4), dtype=torch.int64, device=dev))
    prep = knn_cuda.knn_prep(torch.zeros((4, 3), device=dev), torch.ones(4, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):  # k above the kernel's template range
        knn_cuda.knn_run(prep, torch.zeros((2, 3), device=dev), 9, 1.0)
    with pytest.raises(ValueError):  # not contiguous
        bitonic_cuda.sector_sort(torch.zeros((64, 8), device=dev).t(), 2)
