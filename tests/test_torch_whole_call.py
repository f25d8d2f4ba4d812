"""One trajectory call, one program (``loam_tpu_torch/program.py``) on the CPU.

On the card a call of ``odometry_offline`` or ``scan_to_map_offline`` is one
CUDA graph: the extraction, then ``lax.scan`` over chunks or frames as a
WHILE node (``program.scan``), each registration's ``lax.while_loop`` a
WHILE node inside it (``program.while_loop``), the keyframe ``lax.cond`` an
IF node. The CPU runs the same program eagerly, with host loops (held
against the graphs by ``test_torch_cuda.py -k whole_call`` and
``chip_smoke.py`` phase 15). What the CPU shows: ``while_loop`` and ``scan``
have ``jax.lax``'s semantics on a toy carry (the first false flag stops the
loop, the carry is threaded, zero iterations run nothing); both drivers
agree with ``loam_tpu``'s; and each call is bit-equal to the composition of
the public step functions it replaces, chunk by chunk
(``register_features_batch``) and frame by frame
(``scan_to_map_step_features``, ``scan_to_map_step``).

Tolerances (``test_torch_odometry.py``'s and ``test_torch_scan_to_map.py``'s).
float64: trajectories within 1e-4 m and 1e-4 rad, terminations equal (and
iteration counts for the offline driver): the packages sum the normal
equations, and compose the poses, in other orders. float32: 1e-2 m and 1e-3
rad, the ICF's convergence thresholds, terminations equal. The port against
its own step functions: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import loam_tpu as J
from loam_tpu.io import render_trajectory
from loam_tpu.odometry import scan_to_map as j_s2m

import loam_tpu_torch as T
from loam_tpu_torch import program
from loam_tpu_torch.odometry.offline import compose_trajectory
from loam_tpu_torch.params import from_reference
from loam_tpu_torch.registration import azimuth_sort_features, loop, spatial_sort_features
from loam_tpu_torch.registration.detail import tree_map

torch.set_num_threads(1)

LIDAR = J.LidarParams(16, 360, 0.5, 80.0)
N_FRAMES = 4
J_CFG = j_s2m.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
J_REG = J.RegistrationParams(search_backend="bruteforce", prior_weight=300.0)
TOL = {np.float64: (1e-4, 1e-4), np.float32: (1e-2, 1e-3)}  # (m, rad)


@pytest.fixture(scope="module")
def scans():
    s, _ = render_trajectory(LIDAR, N_FRAMES, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                             noise=0.003, seed=11, dtype=np.float32)
    return s


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for part in tree for x in _leaves(part)]
    return []


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) > 0 and all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
                                          for x, y in zip(la, lb))


def _close(traj, j_traj, dtype):
    pos, rot = TOL[dtype]
    np.testing.assert_allclose(traj.translation.numpy(), np.asarray(j_traj.translation), atol=pos, rtol=0)
    np.testing.assert_allclose(traj.rotation.numpy(), np.asarray(j_traj.rotation), atol=rot, rtol=0)


# ---- program.while_loop and program.scan against jax.lax -------------------------------

@pytest.mark.parametrize("start,iterations", [(5.0, 0), (0.5, 2), (-40.0, 7)],
                         ids=["no_iteration", "flag_stops", "limit_stops"])
def test_while_loop_has_lax_semantics(start, iterations):
    """``program.while_loop`` on a device flag that the body updates, against
    ``jax.lax.while_loop`` on the same carry: the loop stops at the first
    false flag (here before any iteration, on the value, and on the
    iteration limit), the carry threaded through the iterations."""
    limit, thresh = 7, 3.0
    cond = lambda x, k: (k < limit) & (x < thresh)
    step = lambda x, k: (x * 1.5 + 1.0, k + 1)
    jx, jk = jax.lax.while_loop(lambda c: cond(*c), lambda c: step(*c),
                                (jnp.float64(start), jnp.int32(0)))

    x, k = torch.tensor(start, dtype=torch.float64), torch.tensor(0, dtype=torch.int32)
    flag = cond(x, k)
    runs = []

    def body():
        runs.append(int(k))
        nx, nk = step(x, k)
        x.copy_(nx)
        k.copy_(nk)
        flag.copy_(cond(x, k))

    program.while_loop(flag, body)
    assert float(x) == float(jx) and int(k) == int(jk) and runs == list(range(int(jk)))
    assert not bool(flag) and int(jk) == iterations


@pytest.mark.parametrize("n", [0, 1, 5])
def test_scan_has_lax_semantics(n):
    """``program.scan`` over a device counter against ``jax.lax.scan``: the
    carry (a buffer the body updates in place) threaded, the outputs (a
    tuple, one of them a NamedTuple) stacked on a leading axis of ``n``,
    ``i`` the iteration's index as a device int64 scalar; ``n = 0`` runs
    nothing and returns None (``lax.scan`` returns empty outputs)."""
    rng = np.random.default_rng(3)
    xs_np, c0 = rng.standard_normal((n, 4)), rng.standard_normal(4)

    def j_step(c, x):
        c = c * 0.5 + x
        return c, (c, x * 2.0)

    jc, (jys, jxs2) = jax.lax.scan(j_step, jnp.asarray(c0), jnp.asarray(xs_np), length=n)

    xs, carry = torch.from_numpy(xs_np), torch.from_numpy(c0.copy())
    seen = []

    def body(i):
        assert i.dtype == torch.int64 and i.ndim == 0
        seen.append(int(i))
        x = xs.index_select(0, i.view(1))[0]
        carry.copy_(carry * 0.5 + x)
        return carry.clone(), T.Pose3(x * 2.0, i.view(1).clone())

    out = program.scan(n, body, torch.device("cpu"))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(jc))
    if n == 0:
        assert out is None and seen == []
        return
    ys, pair = out
    assert seen == list(range(n)) and isinstance(pair, T.Pose3)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(pair.rotation.numpy(), np.asarray(jxs2))
    np.testing.assert_array_equal(pair.translation.numpy(), np.arange(n)[:, None])


# ---- odometry_offline ------------------------------------------------------------------

OFFLINE_CASES = {
    # frames, chunk_pairs, motion_init, dtype: 3 pairs in chunks of 2 leave
    # a padded last chunk
    "padded_chunk_motion": (4, 2, True, np.float64),
    "padded_chunk": (4, 2, False, np.float64),
    "one_batch": (4, 0, False, np.float64),
    "two_frames_f32": (2, 2, True, np.float32),
}


def _offline_by_chunks(scans, lidar, fp, rp, chunk_pairs, motion_init):
    """The composition the whole call replaces: the batched extraction, one
    ``register_features_batch`` a chunk (the last padded with pair 0, the
    motion carry read on the host side of the loop), the composition."""
    feats = T.extract_features_batch(scans, lidar, fp, post=azimuth_sort_features)
    src, tgt = feats.map(lambda x: x[1:]), feats.map(lambda x: x[:-1])
    n, dtype = scans.shape[0] - 1, scans.dtype
    if chunk_pairs <= 0 or n <= chunk_pairs:
        rel, det = T.register_features_batch(src, tgt, T.Pose3.identity(dtype, (n,)), rp,
                                             reorder_mode="none")
        return compose_trajectory(rel), det
    C = chunk_pairs
    nc = -(-n // C)
    pad = lambda x: torch.cat([x, x[:1].expand((nc * C - n,) + x.shape[1:])])
    src, tgt = src.map(pad), tgt.map(pad)
    carry, rels, dets = T.Pose3.identity(dtype), [], []
    for c in range(nc):
        part = lambda x: x[c * C:(c + 1) * C]
        init = (T.Pose3(carry.rotation.expand(C, 4), carry.translation.expand(C, 3)) if motion_init
                else T.Pose3.identity(dtype, (C,)))
        rel, det = T.register_features_batch(src.map(part), tgt.map(part), init, rp, reorder_mode="none")
        carry = T.Pose3(rel.rotation[-1], rel.translation[-1])
        rels.append(rel)
        dets.append(det)
    cat = lambda *xs: torch.cat(xs)[:n]
    return compose_trajectory(tree_map(cat, *rels)), tree_map(cat, *dets)


@pytest.mark.parametrize("case", list(OFFLINE_CASES))
def test_offline_whole_call_matches_loam_tpu_and_the_chunks(scans, case):
    """``odometry_offline`` as one program (one key in the cache: the
    extraction and the registrations inline) against ``loam_tpu``'s at the
    stated tolerances, and bit-equal to the chunk-by-chunk composition of
    the public step functions; the same outer ICF iterations."""
    frames, chunk_pairs, motion_init, dtype = OFFLINE_CASES[case]
    x = scans[:frames].astype(dtype)
    fp, rp = J.FeatureExtractionParams(), J.RegistrationParams(search_backend="bruteforce")
    args = (torch.from_numpy(x), from_reference(LIDAR), from_reference(fp), from_reference(rp))
    loop.clear_cache()
    n0 = loop.iterations
    traj, det = T.odometry_offline(*args, chunk_pairs=chunk_pairs, motion_init=motion_init)
    n_call = loop.iterations - n0
    assert [p.info["path"] for p in loop._cache[torch.device("cpu")].values()] == ["odometry_offline"]
    assert traj.translation.shape == (frames, 3) and det.termination.shape == (frames - 1,)

    n0 = loop.iterations
    want = _offline_by_chunks(*args, chunk_pairs, motion_init)
    assert _same((traj, det), want) and loop.iterations - n0 == n_call

    tj, dj = J.odometry_offline(jnp.asarray(x), LIDAR, fp, rp, chunk_pairs=chunk_pairs,
                                motion_init=motion_init)
    _close(traj, tj, dtype)
    np.testing.assert_array_equal(det.termination.numpy(), np.asarray(dj.termination))
    if dtype == np.float64:
        np.testing.assert_array_equal(det.num_iterations.numpy(), np.asarray(dj.num_iterations))


# ---- scan_to_map_offline ---------------------------------------------------------------

S2M_CASES = ("hoisted", "dewarp", "init_state")


def _s2m_by_frames(scans, lidar, fp, reg, cfg, state, dewarp):
    """The composition the whole call replaces: ``scan_to_map_step`` a frame
    (dewarp) or the batched extraction and ``scan_to_map_step_features`` a
    frame."""
    if not dewarp:
        feats = T.extract_features_batch(scans, lidar, fp, post=spatial_sort_features)
    poses, dets = [], []
    for f in range(scans.shape[0]):
        if dewarp:
            state, pose, det = T.scan_to_map_step(state, scans[f], lidar, fp, reg, cfg, dewarp=True)
        else:
            state, pose, det = T.scan_to_map_step_features(state, feats.map(lambda x: x[f]), reg, cfg)
        poses.append(pose)
        dets.append(det)
    stack = lambda *xs: torch.stack(xs)
    return state, tree_map(stack, *poses), tree_map(stack, *dets)


@pytest.mark.parametrize("case", S2M_CASES)
def test_scan_to_map_whole_call_matches_loam_tpu_and_the_frames(scans, case):
    """``scan_to_map_offline`` as one program: with the state made inside it
    (hoisted extraction), with ``dewarp=True`` (the extraction inside the
    scan over frames), both in float32 (``loam_tpu``'s own state is
    float32), and from a float64 ``init_state`` in float64; against
    ``loam_tpu``'s at the tolerances of the type, and bit-equal (state,
    poses, details) to the frame-by-frame composition of the public step
    functions."""
    dtype = np.float64 if case == "init_state" else np.float32
    x = scans.astype(dtype)
    lidar, cfg, reg = from_reference(LIDAR), from_reference(J_CFG), from_reference(J_REG)
    fp = T.FeatureExtractionParams()
    dewarp = case == "dewarp"
    init = T.scan_to_map_init(cfg, dtype=torch.float64, lidar=lidar, device="cpu") \
        if case == "init_state" else None
    loop.clear_cache()
    state, traj, det = T.scan_to_map_offline(torch.from_numpy(x), lidar, fp, reg, cfg, dewarp=dewarp,
                                             init_state=init, device="cpu")
    assert [p.info["path"] for p in loop._cache[torch.device("cpu")].values()] == ["scan_to_map_offline"]
    assert traj.translation.shape == (N_FRAMES, 3) and int(state.dropped) == 0

    start = init if init is not None else T.scan_to_map_init(cfg, lidar=lidar, device="cpu")
    want = _s2m_by_frames(torch.from_numpy(x), lidar, fp, reg, cfg, start, dewarp)
    assert _same((state, traj, det), want)

    j_init = j_s2m.scan_to_map_init(J_CFG, dtype=jnp.float64) if case == "init_state" else None
    _, tj, dj = J.scan_to_map_offline(jnp.asarray(x), LIDAR, reg_params=J_REG, config=J_CFG,
                                      dewarp=dewarp, init_state=j_init)
    _close(traj, tj, dtype)
    np.testing.assert_array_equal(det.termination.numpy(), np.asarray(dj.termination))
