"""The port's kernels (sector sort, NMS, copy-out, kNN and the dual-class
kNN): their plain PyTorch versions against the JAX Pallas kernels (interpret mode on the CPU; ``conftest.py`` sets
``LOAM_PALLAS_INTERPRET=1``). The CUDA kernels against their plain versions
are in ``test_torch_cuda.py``.

Selections (sort positions, NMS picks, kNN indices and masks, copied
coordinates) must be exactly equal. kNN squared distances are compared at
rtol 1e-6 against JAX (XLA may contract the distance expression into FMAs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from loam_tpu.ops.assemble_pallas import select_points as j_select
from loam_tpu.ops.bitonic import bitonic_sort as j_bitonic
from loam_tpu.ops.knn_pallas import knn_pallas_dual as j_knn_dual
from loam_tpu.ops.knn_pallas import knn_prep as j_knn_prep
from loam_tpu.ops.knn_pallas import knn_run as j_knn_run
from loam_tpu.ops.nms_pallas import greedy_nms as j_nms

from torch_nms_cases import NMS_CASES, random_candidates
from torch_sort_cases import SORT_CASES, lexsort_reference

from loam_tpu_torch.neighbors import knn as t_knn
from loam_tpu_torch.ops import assemble_cuda, bitonic_cuda, knn_cuda, nms_cuda

# the suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing its cores
torch.set_num_threads(1)


# ---- sector sort ------------------------------------------------------------

def _curvature(rng, N, P, dtype=np.float32):
    # rounded values: plenty of exact ties, which the position key orders
    c = np.round(rng.exponential(2.0, size=(N, P)), 1).astype(dtype)
    c[:, :3] = -1.0
    return c


@pytest.mark.parametrize("N,P,S", [(4, 64, 2), (3, 100, 6), (2, 50, 3)])
def test_sector_sort_plain_matches_pallas(N, P, S):
    rng = np.random.default_rng(N * P)
    curv = _curvature(rng, N, P)
    sc_t, sp_t = bitonic_cuda.sector_sort_reference(torch.from_numpy(curv), S)
    _, s_max, pos = bitonic_cuda.sector_layout(P, S)
    keys = bitonic_cuda.to_sectors(torch.from_numpy(curv), S, float("inf")).numpy()
    k_t = jnp.asarray(keys.reshape(N * S, s_max).T)
    p_t = jnp.asarray(np.broadcast_to(pos, (N, S, s_max)).reshape(N * S, s_max).T.astype(np.int32))
    sk, sp = j_bitonic((k_t, p_t), num_keys=2, impl="pallas")
    back = lambda x: np.asarray(x).T.reshape(N, S, s_max)
    np.testing.assert_array_equal(sp_t.numpy(), back(sp))
    np.testing.assert_array_equal(sc_t.numpy(), back(sk))


@pytest.mark.parametrize("P,S", [(1024, 6), (360, 6), (100, 6), (50, 3), (64, 1)])
def test_sector_layout_matches_loam_tpu(P, S):
    from loam_tpu.features.extract import _sector_layout
    from loam_tpu.params import FeatureExtractionParams, LidarParams

    pos_j, slot_valid, s_max_j = _sector_layout(LidarParams(1, P, 0.5, 60.0),
                                                FeatureExtractionParams(number_sectors=S))
    pps, s_max, pos = bitonic_cuda.sector_layout(P, S)
    assert (pps, s_max) == (P // S, s_max_j)
    np.testing.assert_array_equal(pos, np.asarray(pos_j))
    # the padding slots, and only they, sit at P - 1 past a sector's end
    assert (pos[~np.asarray(slot_valid)] == P - 1).all()


def test_sector_sort_layout_padding():
    # 50 points in 3 sectors: 16, 16, 18 -> the short sectors carry two
    # (+inf, P-1) padding slots at their ends
    curv = torch.arange(50, dtype=torch.float64).flip(0)[None]
    sc, sp = bitonic_cuda.sector_sort_reference(curv, 3)
    assert sc.shape == (1, 3, 18)
    assert torch.isinf(sc[0, 0, 16:]).all() and (sp[0, 0, 16:] == 49).all()
    assert sp[0, 2].tolist() == list(range(49, 31, -1))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_sector_sort_plain_at_kernel_branches(case, dtype):
    """The inputs the CUDA kernel's key mapping and slice widths could get
    wrong (ties, -0.0, NaN, +inf in a real slot, slices padded to 32..1,024
    slots): the plain version's positions equal a numpy lexsort's, its keys
    are the input's values at those positions bit for bit, and where
    ``loam_tpu``'s kernel takes the case (float32, no NaN, a small slice) its
    output is the same."""
    make, S, pallas_ok = SORT_CASES[case]
    curv = make().astype(dtype)
    N, P = curv.shape
    sc_t, sp_t = bitonic_cuda.sector_sort_reference(torch.from_numpy(curv), S)
    assert sc_t.dtype == torch.from_numpy(curv).dtype and sp_t.dtype == torch.int32
    want = lexsort_reference(curv, S)
    np.testing.assert_array_equal(sp_t.numpy(), want)
    _, s_max, pos = bitonic_cuda.sector_layout(P, S)
    bits = np.uint32 if dtype == np.float32 else np.uint64
    picked = np.take_along_axis(curv[:, None, :], want.astype(np.int64), axis=2)
    got = sc_t.numpy()
    # outside the last sector (which has no padding) only padding slots carry P - 1
    padding = (want == P - 1) & (np.arange(S) != S - 1)[None, :, None]
    np.testing.assert_array_equal(got[~padding].view(bits), picked[~padding].view(bits))
    assert np.isposinf(got[padding]).all()
    if pallas_ok and dtype == np.float32:
        keys = bitonic_cuda.to_sectors(torch.from_numpy(curv), S, float("inf")).numpy()
        k_t = jnp.asarray(keys.reshape(N * S, s_max).T)
        p_t = jnp.asarray(np.broadcast_to(pos, (N, S, s_max)).reshape(N * S, s_max).T.astype(np.int32))
        sk, sp = j_bitonic((k_t, p_t), num_keys=2, impl="pallas")
        back = lambda x: np.asarray(x).T.reshape(N, S, s_max)
        np.testing.assert_array_equal(sp_t.numpy(), back(sp))
        np.testing.assert_array_equal(got.view(bits), back(sk).view(bits))


# ---- greedy NMS -------------------------------------------------------------

def _nms_case(rng, L, P, S):
    valid = rng.random((L, P)) > 0.2
    ce, cp = random_candidates(rng, L, P, S), random_candidates(rng, L, P, S)
    return valid, ce, cp, P // S, ce.shape[2]


@pytest.mark.parametrize(
    "L,P,S,max_e,max_p,n",
    [(4, 64, 2, 2, 5, 2), (3, 50, 3, 1, 3, 1), (6, 128, 4, 3, 7, 3)],
)
def test_greedy_nms_plain_matches_pallas(L, P, S, max_e, max_p, n):
    rng = np.random.default_rng(L + P)
    valid, ce, cp, pps, s_max = _nms_case(rng, L, P, S)
    ej, pj = j_nms(jnp.asarray(valid), jnp.asarray(ce), jnp.asarray(cp), max_e, max_p, n, pps, s_max)
    et, pt = nms_cuda.greedy_nms_reference(torch.from_numpy(valid), torch.from_numpy(ce),
                                           torch.from_numpy(cp), max_e, max_p, n)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_greedy_nms_plain_matches_pallas_at_kernel_branches(case):
    """The shapes the CUDA kernel branches on (mask words, groups of 32
    candidates, caps, windows): integer-exact."""
    valid, ce, cp, max_e, max_p, n = NMS_CASES[case]()
    P, (S, s_max) = valid.shape[1], ce.shape[1:]
    ej, pj = j_nms(jnp.asarray(valid), jnp.asarray(ce), jnp.asarray(cp), max_e, max_p, n, P // S, s_max)
    et, pt = nms_cuda.greedy_nms_reference(torch.from_numpy(valid), torch.from_numpy(ce),
                                           torch.from_numpy(cp), max_e, max_p, n)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    if case == "cap_reached_at_a_group_end":
        assert pt[0, 0].tolist() == [1, 2, 3, 4, 5, 6]
    if case == "suppressed_inside_a_group":
        assert pt[0, 0].tolist() == [10, 13, 7, 20, 23] + [-1] * 8
    if case in ("lists_all_minus_one", "all_points_invalid"):
        assert (et == -1).all() and (pt == -1).all()


def test_padded_sector_edge_candidates_past_count_bound():
    """Port of test_nms_pallas.py's regression: in a padded sector the
    reversed edge list starts with -1 slots, and a bound derived from the
    candidate count dropped the last real candidate. Two dead slots then
    eight real candidates, n=1 (no suppression): all eight are accepted."""
    L, P, S, s_max = 1, 64, 2, 24
    valid = torch.ones((L, P), dtype=torch.bool)
    cand_e = torch.full((L, S, s_max), -1, dtype=torch.int32)
    cand_e[0, 0, 2:10] = torch.arange(10, 50, 5, dtype=torch.int32)
    cand_p = torch.full((L, S, s_max), -1, dtype=torch.int32)
    ep, _ = nms_cuda.greedy_nms_reference(valid, cand_e, cand_p, max_e=12, max_p=12, n=1)
    got = ep[0, 0]
    assert sorted(got[got >= 0].tolist()) == list(range(10, 50, 5))


# ---- coordinate copy-out ----------------------------------------------------

@pytest.mark.parametrize("L,P,C", [(4, 64, 16), (8, 256, 130), (3, 100, 7)])
def test_select_points_plain_matches_pallas(L, P, C):
    rng = np.random.default_rng(C)
    pts = rng.standard_normal((L, P, 3)).astype(np.float32)
    picks = rng.integers(-1, P, (L, C)).astype(np.int32)
    picks[:, 1] = picks[:, 0]  # duplicate picks are legal
    want = np.asarray(j_select(jnp.asarray(pts), jnp.asarray(picks), impl="pallas"))
    got = assemble_cuda.select_points_reference(torch.from_numpy(pts), torch.from_numpy(picks))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[picks < 0] == 0).all()


# ---- kNN --------------------------------------------------------------------

def _knn_sets(seed, m, q, spread=5.0):
    rng = np.random.default_rng(seed)
    targets = rng.uniform(-spread, spread, size=(m, 3)).astype(np.float32)
    tmask = rng.random(m) > 0.15
    queries = rng.uniform(-spread, spread, size=(q, 3)).astype(np.float32)
    qmask = rng.random(q) > 0.3
    return queries, targets, tmask, qmask


@pytest.mark.parametrize("k,max_dist", [(5, 1.5), (5, 1.0), (3, 2.5), (1, 0.8)])
def test_knn_plain_matches_pallas(k, max_dist):
    q, t, tm, qm = _knn_sets(k, 700, 300)
    jp = j_knn_prep(jnp.asarray(t), jnp.asarray(tm))
    j_pk = j_knn_run(jp, jnp.asarray(q), k, max_dist, with_coords=True, query_mask=jnp.asarray(qm))
    tprep = knn_cuda.knn_prep(torch.from_numpy(t), torch.from_numpy(tm))
    t_pk = knn_cuda.knn_run(tprep, torch.from_numpy(q), k, max_dist, with_coords=True,
                            query_mask=torch.from_numpy(qm))
    # loam_tpu leaves masked queries unspecified (its sentinel queries can
    # match sentinel targets at d2 = 0 in interpret mode); the port returns
    # empty lists for them. Compare the unmasked queries.
    assert not t_pk.mask.numpy()[:, ~qm].any()
    mask = np.asarray(j_pk.mask)[:, qm]
    np.testing.assert_array_equal(t_pk.mask.numpy()[:, qm], mask)
    m0 = mask[0]
    np.testing.assert_array_equal(t_pk.first_idx.numpy()[qm][m0], np.asarray(j_pk.first_idx)[qm][m0])
    for ax in ("xs", "ys", "zs"):
        np.testing.assert_array_equal(getattr(t_pk, ax).numpy()[:, qm][mask],
                                      np.asarray(getattr(j_pk, ax))[:, qm][mask])
    # index/distance form
    j_r = j_knn_run(jp, jnp.asarray(q), k, max_dist)
    t_r = knn_cuda.knn_run(tprep, torch.from_numpy(q), k, max_dist)
    rm = np.asarray(j_r.mask)
    np.testing.assert_array_equal(t_r.mask.numpy(), rm)
    np.testing.assert_array_equal(t_r.indices.numpy()[rm], np.asarray(j_r.indices)[rm])
    np.testing.assert_allclose(t_r.distances.numpy()[rm] ** 2, np.asarray(j_r.distances)[rm] ** 2, rtol=1e-6)


def test_knn_batched_equals_per_pair():
    sets = [_knn_sets(s, 400, 150) for s in (11, 12)]
    stack = lambda i: torch.from_numpy(np.stack([s[i] for s in sets]))
    prep = knn_cuda.knn_prep(stack(1), stack(2))
    batched = knn_cuda.knn_run(prep, stack(0), 5, 1.5, with_coords=True, query_mask=stack(3))
    for b, (q, t, tm, qm) in enumerate(sets):
        one = knn_cuda.knn_run(knn_cuda.knn_prep(torch.from_numpy(t), torch.from_numpy(tm)),
                               torch.from_numpy(q), 5, 1.5, with_coords=True,
                               query_mask=torch.from_numpy(qm))
        for x, y in zip(one, batched):
            np.testing.assert_array_equal(x.numpy(), y[b].numpy())


@pytest.mark.parametrize("max_dist", [0.0, 1.5])
def test_bruteforce_knn_matches_xla(max_dist):
    from loam_tpu.neighbors.bruteforce import _knn_xla

    q, t, tm, _ = _knn_sets(21, 600, 250)
    ref = _knn_xla(jnp.asarray(q), jnp.asarray(t), jnp.asarray(tm), 5, max_dist)
    got = t_knn(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(tm), 5, max_dist, tile=64)
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_array_equal(got.indices.numpy()[m], np.asarray(ref.indices)[m])
    np.testing.assert_allclose(got.distances.numpy()[m], np.asarray(ref.distances)[m], rtol=1e-6)


# ---- dual-class kNN ---------------------------------------------------------

# the three cases of test_knn_pallas.py's dual tests: (edge set seed, M, Q,
# planar set seed, M, Q, k_e, k_p, r_e, r_p, edge targets all invalid)
_DUAL_CASES = {
    "two_singles": (5, 1100, 400, 6, 2600, 900, 5, 5, 1.0, 2.0, False),
    "distinct_k": (7, 600, 150, 8, 1500, 500, 3, 7, 1.2, 2.2, False),
    "empty_class": (9, 300, 80, 10, 1200, 400, 5, 5, 1.0, 2.0, True),
}


def _dual_inputs(case):
    se, me_, qe_, sp, mp_, qp_, k_e, k_p, r_e, r_p, empty = _DUAL_CASES[case]
    qe, te, me, _ = _knn_sets(se, me_, qe_)
    qp, tp, mp, _ = _knn_sets(sp, mp_, qp_)
    if empty:
        me = np.zeros_like(me)
    return (qe, qp, te, me, tp, mp), (k_e, k_p, r_e, r_p)


@pytest.mark.parametrize("case", sorted(_DUAL_CASES))
def test_knn_dual_plain_matches_pallas(case):
    arrays, (k_e, k_p, r_e, r_p) = _dual_inputs(case)
    j_res = j_knn_dual(*(jnp.asarray(a) for a in arrays), k_e, k_p, r_e, r_p, tq=256, tt=512)
    t_res = knn_cuda.knn_pallas_dual(*(torch.from_numpy(a) for a in arrays), k_e, k_p, r_e, r_p)
    for (jr, tr), k in zip(zip(j_res, t_res), (k_e, k_p)):
        m = np.asarray(jr.mask)
        assert tr.indices.shape == (m.shape[0], k)
        np.testing.assert_array_equal(tr.mask.numpy(), m)
        # loam_tpu's unpack zeroes the invalid slots' indices: all equal
        np.testing.assert_array_equal(tr.indices.numpy(), np.asarray(jr.indices))
        assert np.isinf(tr.distances.numpy()[~m]).all()
        np.testing.assert_allclose(tr.distances.numpy()[m] ** 2, np.asarray(jr.distances)[m] ** 2,
                                   rtol=1e-6)
    if _DUAL_CASES[case][-1]:
        assert not t_res[0].mask.any()


@pytest.mark.parametrize("case", sorted(_DUAL_CASES))
def test_knn_dual_plain_equals_two_singles(case):
    (qe, qp, te, me, tp, mp), (k_e, k_p, r_e, r_p) = _dual_inputs(case)
    t = lambda a: torch.from_numpy(np.stack([a, a[::-1].copy()]))  # B = 2 pairs
    prep = knn_cuda.knn_dual_prep(t(te), t(me), t(tp), t(mp))
    re, rp = knn_cuda.knn_dual_run_reference(prep, t(qe), t(qp), k_e, k_p, r_e, r_p)
    for got, (q, tg, tm, k, r) in ((re, (qe, te, me, k_e, r_e)), (rp, (qp, tp, mp, k_p, r_p))):
        one = knn_cuda.knn_run_reference(knn_cuda.knn_prep(t(tg), t(tm)), t(q), k, r)
        assert torch.equal(got.mask, one.mask)
        assert torch.equal(got.indices, torch.where(one.mask, one.indices, 0))
        assert torch.equal(got.distances, one.distances)


def test_knn_dual_no_edge_queries():
    """E = 0: the planar side is unaffected, the edge side empty."""
    (qe, qp, te, me, tp, mp), (k_e, k_p, r_e, r_p) = _dual_inputs("two_singles")
    args = [torch.from_numpy(a) for a in (qe[:0], qp, te, me, tp, mp)]
    re, rp = knn_cuda.knn_pallas_dual(*args, k_e, k_p, r_e, r_p)
    assert re.indices.shape == (0, k_e) and re.mask.shape == (0, k_e)
    one = knn_cuda.knn_run_reference(knn_cuda.knn_prep(args[4], args[5]), args[1], k_p, r_p)
    assert torch.equal(rp.mask, one.mask) and torch.equal(rp.distances, one.distances)
