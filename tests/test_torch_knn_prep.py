"""What the port prepares for its kNN kernels on the host side, and the
device rule of its entry points, on the CPU.

* ``n_live`` of ``knn_prep`` / ``knn_dual_prep`` (the index of the last valid
  target slot + 1) against numpy, and the plain searches on such preps
  against ``loam_tpu``'s Pallas kernel in interpret mode (``conftest.py`` sets
  ``LOAM_PALLAS_INTERPRET=1``): masks and indices exact, squared distances at
  rtol 1e-6 (XLA may contract the distance expression into FMAs). The plain
  searches ignore ``n_live``: they stay the independent statement of the
  result that the kernels are held to on the card (``test_torch_cuda.py``).
* ``split_plan``: the target splits the wrapper chooses from shapes.
* The device rule (``loam_tpu_torch/device.py``): ``device="cpu"`` runs a
  numpy input on the CPU with the trajectory of a CPU tensor, exactly; with
  no card and no ``device`` the entry points raise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from loam_tpu.ops.knn_pallas import knn_pallas_dual as j_knn_dual
from loam_tpu.ops.knn_pallas import knn_prep as j_knn_prep
from loam_tpu.ops.knn_pallas import knn_run as j_knn_run

import loam_tpu_torch as T
from loam_tpu_torch.io import render_trajectory
from loam_tpu_torch.ops import knn_cuda

# the suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing its cores
torch.set_num_threads(1)


def _mask(kind, rng, m):
    if kind == "prefix":
        return np.arange(m) < (2 * m) // 5
    if kind == "scattered":
        mask = rng.random(m) > 0.4
        mask[-7:] = False  # the last valid slot is not the last slot
        return mask
    assert kind == "all_false"
    return np.zeros(m, bool)


def _want_live(mask):
    hits = np.flatnonzero(mask)
    return int(hits[-1]) + 1 if hits.size else 0


MASKS = ["prefix", "scattered", "all_false"]


@pytest.mark.parametrize("kind", MASKS + ["batch"])
def test_n_live_matches_numpy(kind):
    rng = np.random.default_rng(3)
    me, mp = 90, 301
    kinds = MASKS if kind == "batch" else [kind]  # a batch with different counts
    e_mask = np.stack([_mask(k, rng, me) for k in kinds])
    p_mask = np.stack([_mask(k, rng, mp) for k in reversed(kinds)])
    te = torch.from_numpy(rng.standard_normal((len(kinds), me, 3)).astype(np.float32))
    tp = torch.from_numpy(rng.standard_normal((len(kinds), mp, 3)).astype(np.float32))
    want_e = [_want_live(m) for m in e_mask]
    want_p = [_want_live(m) for m in p_mask]

    prep = knn_cuda.knn_prep(te, torch.from_numpy(e_mask))
    assert prep.n_live.dtype == torch.int32 and prep.n_live.tolist() == want_e
    one = knn_cuda.knn_prep(te[0], torch.from_numpy(e_mask[0]))  # unbatched: B = 1
    assert one.n_live.tolist() == want_e[:1]
    dual = knn_cuda.knn_dual_prep(te, torch.from_numpy(e_mask), tp, torch.from_numpy(p_mask))
    assert dual.n_live.dtype == torch.int32
    assert dual.n_live.tolist() == [list(x) for x in zip(want_e, want_p)]
    assert dual.n_live.is_contiguous() and prep.n_live.is_contiguous()


def test_n_live_of_no_slots():
    prep = knn_cuda.knn_prep(torch.zeros((2, 0, 3)), torch.zeros((2, 0), dtype=torch.bool))
    assert prep.n_live.tolist() == [0, 0]


def _sets(seed, m, q, kind, spread=5.0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-spread, spread, size=(m, 3)).astype(np.float32)
    qs = rng.uniform(-spread, spread, size=(q, 3)).astype(np.float32)
    return qs, t, _mask(kind, rng, m)


@pytest.mark.parametrize("kind", MASKS)
def test_plain_knn_on_masked_targets_matches_pallas(kind):
    q, t, tm = _sets(31, 700, 300, kind)
    k, r = 5, 1.5
    j_r = j_knn_run(j_knn_prep(jnp.asarray(t), jnp.asarray(tm)), jnp.asarray(q), k, r)
    prep = knn_cuda.knn_prep(torch.from_numpy(t), torch.from_numpy(tm))
    assert prep.n_live.tolist() == [_want_live(tm)]
    t_r = knn_cuda.knn_run(prep, torch.from_numpy(q), k, r)
    m = np.asarray(j_r.mask)
    np.testing.assert_array_equal(t_r.mask.numpy(), m)
    np.testing.assert_array_equal(t_r.indices.numpy()[m], np.asarray(j_r.indices)[m])
    np.testing.assert_allclose(t_r.distances.numpy()[m] ** 2, np.asarray(j_r.distances)[m] ** 2,
                               rtol=1e-6)
    assert m.any() == (kind != "all_false")
    if m.any():  # no neighbor lies beyond the live bound
        assert t_r.indices.numpy()[m].max() < _want_live(tm)


@pytest.mark.parametrize("kind", MASKS)
def test_plain_knn_dual_on_masked_targets_matches_pallas(kind):
    qe, te, me = _sets(41, 600, 150, kind)
    qp, tp, mp = _sets(42, 1500, 500, "scattered" if kind == "all_false" else kind)
    k_e, k_p, r_e, r_p = 3, 5, 1.2, 2.2
    arrays = (qe, qp, te, me, tp, mp)
    j_res = j_knn_dual(*(jnp.asarray(a) for a in arrays), k_e, k_p, r_e, r_p, tq=256, tt=512)
    t_res = knn_cuda.knn_pallas_dual(*(torch.from_numpy(a) for a in arrays), k_e, k_p, r_e, r_p)
    for jr, tr in zip(j_res, t_res):
        m = np.asarray(jr.mask)
        np.testing.assert_array_equal(tr.mask.numpy(), m)
        np.testing.assert_array_equal(tr.indices.numpy(), np.asarray(jr.indices))
        np.testing.assert_allclose(tr.distances.numpy()[m] ** 2, np.asarray(jr.distances)[m] ** 2,
                                   rtol=1e-6)
    if kind == "all_false":
        assert not t_res[0].mask.any() and t_res[1].mask.any()


@pytest.mark.parametrize(
    "B,classes",
    [(4, ((19584, 19584),)), (4, ((4224, 4224), (19584, 19584))),
     (1, ((4224, 32768), (19584, 131072))), (1, ((4224, 4224), (19584, 19584))),
     (2, ((300, 3),)), (1, ((0, 64), (100, 0)))],
    ids=["single-scan-B4", "dual-scan-B4", "dual-map-B1", "dual-scan-B1", "tiny", "empty-class"],
)
def test_split_plan(B, classes):
    bq = 1024  # the kernels' block: 512 threads x 2 queries
    plan = knn_cuda.split_plan(B, classes, bq)
    assert len(plan) == len(classes)
    blocks = 0
    for s, (q, m) in zip(plan, classes):
        assert 1 <= s <= knn_cuda.MAX_SPLITS
        # a split never holds fewer slots than it is worth, unless it is alone
        assert s == 1 or -(-m // s) >= knn_cuda.MIN_CHUNK // 2
        blocks += B * -(-q // bq) * s
    if len(classes) == 2 and all(m > 0 for _, m in classes):
        # splits in proportion to the targets: the blocks of both classes
        # search ranges of similar length
        (se, sp), ((_, me), (_, mp)) = plan, classes
        if sp < knn_cuda.MAX_SPLITS and se > 1:
            assert 0.5 <= (me / se) / (mp / sp) <= 2.0
    # one pair fills the card as well as four do
    if sum(q * m for q, m in classes) * B > 1e8:
        assert blocks >= 4 * 132
    # a larger batch never needs more splits
    more = knn_cuda.split_plan(4 * B, classes, bq)
    assert all(a <= b for a, b in zip(more, plan))


# ---- the device rule ---------------------------------------------------------

LIDAR = T.LidarParams(16, 360, 0.5, 80.0)
SMALL_MAP = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)


@pytest.fixture(scope="module")
def scans():
    s, _ = render_trajectory(LIDAR, 3, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                             noise=0.003, seed=11, dtype=np.float32)
    return s


def _run(path, x, **kw):
    if path == "offline":
        traj, det = T.odometry_offline(x, LIDAR, chunk_pairs=2, **kw)
    else:
        _, traj, det = T.scan_to_map_offline(x, LIDAR, config=SMALL_MAP, **kw)
    return traj, det


@pytest.mark.parametrize("path", ["offline", "scan_to_map"])
def test_numpy_input_on_device_cpu_equals_cpu_tensor(path, scans):
    a, da = _run(path, scans, device="cpu")
    b, db = _run(path, torch.from_numpy(scans))  # a tensor keeps its device
    assert a.translation.device.type == "cpu" and b.translation.device.type == "cpu"
    assert torch.equal(a.translation, b.translation) and torch.equal(a.rotation, b.rotation)
    assert torch.equal(da.termination, db.termination)


def test_inits_on_device_cpu():
    s = T.scan_to_scan_init(LIDAR, device="cpu")
    m = T.scan_to_map_init(SMALL_MAP, device="cpu")
    v = T.voxel_map_empty(16, 0.4, device="cpu")
    leaves = [s.world_T_current.rotation, s.prev_features.edge_points, s.prev_features.planar_mask,
              m.edge_map.points, m.planar_map.mask, m.world_T_current.translation,
              m.frames_since_insert, v.points, v.voxel_size]
    assert all(x.device.type == "cpu" for x in leaves)


@pytest.mark.parametrize(
    "entry",
    ["odometry_offline", "scan_to_map_offline", "scan_to_map_init", "scan_to_scan_init",
     "voxel_map_empty", "Pose3.from_numpy", "FeatureSet.from_numpy"],
)
def test_without_a_card_and_without_device_raises(entry, scans):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    calls = {
        "odometry_offline": lambda: T.odometry_offline(scans, LIDAR),
        "scan_to_map_offline": lambda: T.scan_to_map_offline(scans, LIDAR, config=SMALL_MAP),
        "scan_to_map_init": lambda: T.scan_to_map_init(SMALL_MAP),
        "scan_to_scan_init": lambda: T.scan_to_scan_init(LIDAR),
        "voxel_map_empty": lambda: T.voxel_map_empty(16, 0.4),
        "Pose3.from_numpy": lambda: T.Pose3.from_numpy((np.array([1.0, 0, 0, 0]), np.zeros(3))),
        "FeatureSet.from_numpy": lambda: T.FeatureSet.from_numpy(
            T.scan_to_scan_init(LIDAR, device="cpu").prev_features),
    }
    # PyTorch's own error for a missing card: no silent run on the CPU
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        calls[entry]()
