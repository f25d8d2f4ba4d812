"""The port's packed codec (``io/packed.py``) and streaming drivers
(``odometry/streaming.py``) against ``loam_tpu``'s on the same numpy inputs,
on the CPU: 7 frames of 16x360 scans in chunks of 3, so the last chunk is a
tail of one frame filled up with copies.

Tolerances. The encoders are numpy in both packages: bytes exact. The decode
is float32 elementwise with the two frameworks' own sin/cos: within 1e-5 m.
Trajectories in float32 agree within the ICF convergence thresholds (1e-2 m,
1e-3 rad) with equal termination codes, as in ``test_torch_odometry.py``: the
two packages sum the normal equations in different orders. The port's
``odometry_streaming`` and ``StreamingOdometry`` run the same chunk steps and
must agree exactly. Beside the port's ``odometry_offline`` with
``chunk_pairs`` equal to the chunk the chunks' boundaries differ by one pair
(a stream's first pair is the empty one), so the motion priors do, and the
results agree within the convergence thresholds, with equal terminations.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import loam_tpu as J
from loam_tpu.io import packed as j_packed
from loam_tpu.io import render_trajectory
from loam_tpu.odometry import streaming as j_stream

import loam_tpu_torch as T
from loam_tpu_torch.io import packed as t_packed
from loam_tpu_torch.odometry import streaming as t_stream
from loam_tpu_torch.params import from_reference

# the suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's CPU kernels from oversubscribing its cores
torch.set_num_threads(1)

LIDAR = J.LidarParams(16, 360, 0.5, 80.0)
T_LIDAR = from_reference(LIDAR)
N_FRAMES, K = 7, 3
POS_TOL, ROT_TOL = 1e-2, 1e-3
CFG = (-0.30, 0.25, j_packed.PACKED_R_MAX)


@pytest.fixture(scope="module")
def scans():
    s, _ = render_trajectory(LIDAR, N_FRAMES, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                             noise=0.003, seed=11, dtype=np.float32)
    return s


# ---- the codec ------------------------------------------------------------------

def test_encode_packed_grid_matches_loam_tpu(scans):
    assert t_packed.PACKED_R_MAX == j_packed.PACKED_R_MAX
    for f in (0, 3):
        got = t_packed.encode_packed_grid(scans[f])
        assert got.dtype == np.uint8 and got.shape == (4, 16, 360)
        np.testing.assert_array_equal(got, j_packed.encode_packed_grid(scans[f]))
    # another field of view and full scale
    np.testing.assert_array_equal(t_packed.encode_packed_grid(scans[1], -0.4, 0.3, 100.0),
                                  j_packed.encode_packed_grid(scans[1], -0.4, 0.3, 100.0))


def test_project_packed_numpy_matches_loam_tpu(scans):
    rng = np.random.default_rng(0)
    cloud = scans[2].reshape(-1, 3)
    cloud = cloud[np.linalg.norm(cloud, axis=1) > 0]
    cloud = np.concatenate([cloud[rng.permutation(len(cloud))],           # unordered
                            cloud[:200] * np.float32(1.5),                # farther returns in taken cells
                            np.zeros((5, 3), np.float32),                 # empty points
                            np.array([[0.0, 0.0, 5.0]], np.float32)])     # above the field of view
    got = t_packed.project_packed_numpy(cloud, 16, 360)
    np.testing.assert_array_equal(got, j_packed.project_packed_numpy(cloud, 16, 360))
    assert got.any()
    np.testing.assert_array_equal(t_packed.project_packed_numpy(np.zeros((4, 3)), 16, 360),
                                  np.zeros((4, 16, 360), np.uint8))


def test_decode_packed_matches_loam_tpu(scans):
    holed = scans[:3].copy()
    holed[:, 2:5, 40:90] = 0.0  # cells with no return
    planes = np.stack([j_packed.encode_packed_grid(s) for s in holed])
    want = np.asarray(j_packed.decode_packed(planes))
    got = t_packed.decode_packed(torch.from_numpy(planes))
    assert got.dtype == torch.float32 and got.shape == (3, 16, 360, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # empty cells decode to the invalid-cell sentinel, exactly
    empty = planes[:, :2].astype(np.int32).sum(1) == 0
    assert empty.any() and (got.numpy()[empty] == 0).all()
    # and the round trip stays inside the quantization (1 mm of range, 2 mm
    # tangential) wherever the point's angles lie in its own cell: all but the
    # few that the renderer's noise pushed across column 0's edge
    assert np.quantile(np.abs(got.numpy() - holed).max(-1), 0.99) < 3e-3
    one = t_packed.decode_packed(torch.from_numpy(planes[0]), -0.30, 0.25, j_packed.PACKED_R_MAX)
    assert torch.equal(one, got[0])


def test_codec_refuses_a_single_scan_line():
    """``loam_tpu`` divides by ``L - 1``; the port raises."""
    with pytest.raises(ValueError, match="at least 2 scan lines"):
        t_packed.encode_packed_grid(np.ones((1, 8, 3), np.float32))
    with pytest.raises(ValueError, match="at least 2 scan lines"):
        t_packed.project_packed_numpy(np.ones((5, 3), np.float32), 1, 8)
    with pytest.raises(ValueError, match="at least 2 scan lines"):
        t_packed.decode_packed(torch.zeros((4, 1, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        t_packed.decode_packed(torch.zeros((4, 2, 8)))


def test_unpacked_path_refuses_packed_planes(scans):
    """``loam_tpu`` casts a uint8 frame to float silently when
    ``packed=False``; the port raises, from the helper and from both drivers."""
    planes = t_packed.encode_packed_grid(scans[0])
    with pytest.raises(ValueError, match="packed planes"):
        t_stream._prep_frame(planes, False, None)
    with pytest.raises(ValueError, match="packed planes"):
        T.StreamingOdometry(T_LIDAR, chunk_frames=2, packed=False, device="cpu").push(planes)
    with pytest.raises(ValueError, match="packed planes"):
        T.odometry_streaming([planes, planes], T_LIDAR, chunk_frames=2, packed=False, device="cpu")
    # the packed path takes planes as they are and grids encoded
    assert t_stream._prep_frame(planes, True, CFG) is planes
    np.testing.assert_array_equal(t_stream._prep_frame(scans[0], True, CFG), planes)
    assert t_stream._prep_frame(scans[0].astype(np.float64), False, None).dtype == np.float32


# ---- the drivers ----------------------------------------------------------------

def _close(t_pose, j_pose):
    np.testing.assert_allclose(t_pose.translation.numpy(), np.asarray(j_pose.translation),
                               atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(t_pose.rotation.numpy(), np.asarray(j_pose.rotation), atol=ROT_TOL, rtol=0)


#: the two configurations loam_tpu's chunk step is compiled for here
CONFIGS = {"packed": dict(packed=True, dewarp=False), "unpacked_dewarp": dict(packed=False, dewarp=True)}


@pytest.fixture(scope="module")
def jax_runs(scans):
    return {name: j_stream.odometry_streaming(scans, LIDAR, chunk_frames=K, **kw)
            for name, kw in CONFIGS.items()}


@pytest.fixture(scope="module")
def torch_runs(scans):
    """The port's runs: the packed one fed an iterable of packed planes (the
    pushed grids of ``StreamingOdometry`` must give the same), the other the
    stacked array of grids."""
    planes = (t_packed.encode_packed_grid(s) for s in scans)
    return {name: T.odometry_streaming(planes if kw["packed"] else scans, T_LIDAR, chunk_frames=K,
                                       device="cpu", **kw)
            for name, kw in CONFIGS.items()}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_odometry_streaming_matches_loam_tpu(jax_runs, torch_runs, config):
    (j_traj, j_det), (t_traj, t_det) = jax_runs[config], torch_runs[config]
    assert t_traj.translation.shape == (N_FRAMES, 3) and t_traj.rotation.shape == (N_FRAMES, 4)
    assert t_det.termination.shape == (N_FRAMES - 1,)  # the tail chunk's copies are cut off
    _close(t_traj, j_traj)
    np.testing.assert_array_equal(t_det.termination.numpy(), np.asarray(j_det.termination))
    assert (t_det.termination == T.TerminationType.CONVERGED).all()
    assert torch.equal(t_traj.translation[0], torch.zeros(3))  # frame 0 at the identity


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_stream_chunk_step_matches_loam_tpu(scans, jax_runs, config):
    """Two chunk steps, each package on its own carry. The first pair meets
    the empty feature set of ``stream_init`` inside a batch whose other pairs
    are live: INSUFFICIENT_ASSOCIATIONS at the identity, no record."""
    kw = CONFIGS[config]
    cfg = CFG if kw["packed"] else None
    prep = lambda lo: np.stack([t_stream._prep_frame(s, kw["packed"], cfg) for s in scans[lo:lo + K]])
    jc, tc = j_stream.stream_init(LIDAR), t_stream.stream_init(T_LIDAR, device="cpu")
    assert not tc.prev_feats.edge_mask.any() and not tc.prev_feats.planar_mask.any()
    # the second step, from a live carry, in one configuration
    for step, lo in enumerate((0, K) if config == "packed" else (0,)):
        jc, j_world, j_det = j_stream.stream_chunk_step(jc, jnp.asarray(prep(lo)), LIDAR, packed_cfg=cfg,
                                                        dewarp=kw["dewarp"])
        tc, t_world, t_det = t_stream.stream_chunk_step(tc, torch.from_numpy(prep(lo)), T_LIDAR,
                                                        packed_cfg=cfg, dewarp=kw["dewarp"])
        _close(t_world, j_world)
        _close(tc.world, jc.world)
        _close(tc.prev_delta, jc.prev_delta)
        np.testing.assert_array_equal(t_det.termination.numpy(), np.asarray(j_det.termination))
        np.testing.assert_array_equal(tc.prev_feats.planar_mask.numpy(), np.asarray(jc.prev_feats.planar_mask))
        if step == 0:
            assert int(t_det.termination[0]) == T.TerminationType.INSUFFICIENT_ASSOCIATIONS
            assert int(t_det.num_iterations[0]) == 0
            assert t_world.translation[0].tolist() == [0.0, 0.0, 0.0]
            assert t_world.rotation[0].tolist() == [1.0, 0.0, 0.0, 0.0]
            assert (t_det.termination[1:] == T.TerminationType.CONVERGED).all()


def test_streaming_odometry_matches_loam_tpu_and_the_offline_form(scans, jax_runs, torch_runs):
    """Pushed frame by frame: poses come one chunk late, ``finish`` flushes
    the tail; the same poses as the port's ``odometry_streaming``, exactly,
    and ``loam_tpu``'s ``StreamingOdometry`` within the tolerances."""
    t_odo = T.StreamingOdometry(T_LIDAR, chunk_frames=K, packed=True, device="cpu")
    j_odo = J.StreamingOdometry(LIDAR, chunk_frames=K, packed=True)
    handed = []
    t_out, j_out = [], []
    for f in range(N_FRAMES):
        got = t_odo.push(scans[f])
        handed.append(len(got))
        t_out += got
        j_out += j_odo.push(scans[f])
    assert handed == [0, 0, 0, 0, 0, K, 0]  # the first chunk's poses come with the second's dispatch
    assert t_odo.frames_pushed == N_FRAMES
    t_out += t_odo.finish()
    j_out += j_odo.finish()
    assert [i for i, _ in t_out] == list(range(N_FRAMES)) == [i for i, _ in j_out]
    assert not t_out[0][1].translation.is_cuda
    pushed = T.Pose3(torch.stack([p.rotation for _, p in t_out]), torch.stack([p.translation for _, p in t_out]))
    offline_form = torch_runs["packed"][0]
    assert torch.equal(pushed.translation, offline_form.translation)
    assert torch.equal(pushed.rotation, offline_form.rotation)
    _close(pushed, J.Pose3(np.stack([np.asarray(p.rotation) for _, p in j_out]),
                           np.stack([np.asarray(p.translation) for _, p in j_out])))
    with pytest.raises(RuntimeError, match="after finish"):
        t_odo.push(scans[0])
    assert t_odo.finish() == []


def test_odometry_streaming_beside_odometry_offline(scans):
    t_traj, t_det = T.odometry_streaming(scans, T_LIDAR, chunk_frames=K, packed=False, device="cpu")
    o_traj, o_det = T.odometry_offline(scans, T_LIDAR, chunk_pairs=K, motion_init=True, device="cpu")
    np.testing.assert_allclose(t_traj.translation.numpy(), o_traj.translation.numpy(), atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(t_traj.rotation.numpy(), o_traj.rotation.numpy(), atol=ROT_TOL, rtol=0)
    assert torch.equal(t_det.termination, o_det.termination)


def test_odometry_streaming_sources(scans, tmp_path):
    """A list of paths (``os.PathLike`` too) goes through the native loader
    and equals the run over the frames it loads; an empty source and a chunk
    of no frames are refused."""
    from loam_tpu_torch.io import ScanLoader

    paths = []
    for f in range(2):
        p = tmp_path / f"{f:06d}.bin"
        pts = scans[f].reshape(-1, 3)
        np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], axis=1).tofile(p)
        paths.append(p)
    loader = ScanLoader([str(p) for p in paths], 16, 360)
    loaded = np.stack(list(loader))
    loader.close()
    ta, _ = T.odometry_streaming(paths, T_LIDAR, chunk_frames=K, packed=False, device="cpu")
    tb, _ = T.odometry_streaming(loaded, T_LIDAR, chunk_frames=K, packed=False, device="cpu")
    assert torch.equal(ta.translation, tb.translation) and torch.equal(ta.rotation, tb.rotation)
    with pytest.raises(ValueError, match="empty source"):
        T.odometry_streaming([], T_LIDAR, device="cpu")
    with pytest.raises(ValueError, match="chunk_frames"):
        T.odometry_streaming(scans, T_LIDAR, chunk_frames=0, device="cpu")
