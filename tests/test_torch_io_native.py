"""The port's native IO runtime (``io/native.py`` with its copy of
``native/loam_io.cpp``), ``adapters.as_points`` and the file-fed
``odometry_streaming`` against ``loam_tpu``'s, on files written here.

Tolerances. Readers, projections and the loader are host code on the same
bytes: their outputs must be byte-equal to ``loam_tpu``'s, with the native
library and with the NumPy fallbacks. ``odometry_streaming`` over a list of
paths must equal, exactly, the same run over the frames the loader yields.
"""

import inspect

import numpy as np
import pytest
import torch

from loam_tpu import adapters as j_adapters
from loam_tpu.io import native as j_native
from loam_tpu.io import render_trajectory
from loam_tpu.odometry import streaming as j_stream

import loam_tpu_torch as T
import loam_tpu_torch.io as t_io
from loam_tpu_torch import adapters as t_adapters
from loam_tpu_torch.io import native as t_native
from loam_tpu_torch.params import LidarParams

torch.set_num_threads(1)

LIDAR = LidarParams(16, 360, 0.5, 80.0)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    az = rng.uniform(0, 2 * np.pi, 5000)
    elev = rng.uniform(-0.25, 0.2, 5000)
    r = rng.uniform(1.0, 30.0, 5000)
    return np.stack([r * np.cos(elev) * np.cos(az), r * np.cos(elev) * np.sin(az),
                     r * np.sin(elev)], axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Five synthetic 16x360 frames written as KITTI .bin files and as
    binary PCD files."""
    root = tmp_path_factory.mktemp("port_seq")
    scans, _ = render_trajectory(LIDAR, 5, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                 noise=0.003, seed=11, dtype=np.float32)
    bins, pcds = [], []
    for i, scan in enumerate(scans):
        pts = scan.reshape(-1, 3)
        p = str(root / f"{i:06d}.bin")
        np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], axis=1).tofile(p)
        bins.append(p)
        q = str(root / f"{i:06d}.pcd")
        j_native.write_pcd(q, pts)
        pcds.append(q)
    return bins, pcds


@pytest.fixture(params=["native", "numpy"])
def backend(request):
    """Both packages with their native library, or both on their NumPy
    fallbacks."""
    assert t_native.native_available() and j_native.native_available()
    if request.param == "native":
        yield request.param
        return
    saved = [(m, m._lib) for m in (t_native, j_native)]
    for m, _ in saved:
        m._lib, m._build_failed = None, True
    yield request.param
    for m, lib in saved:
        m._lib, m._build_failed = lib, False


def test_exports_and_source_copy():
    import loam_tpu.io as j_io

    assert set(j_io.__all__) <= set(t_io.__all__)
    # the port builds its own library from its own copy of the source
    assert t_native._SRC != j_native._SRC and t_native._LIB != j_native._LIB
    assert t_native.native_available() and t_native._LIB.startswith(t_native._DIR)
    assert "loam_tpu_torch" in t_native._LIB


def test_readers_match_loam_tpu(tmp_path, cloud, frames, backend):
    bins, pcds = frames
    np.testing.assert_array_equal(t_native.read_kitti_bin(bins[0]), j_native.read_kitti_bin(bins[0]))
    np.testing.assert_array_equal(t_native.read_pcd(pcds[1]), j_native.read_pcd(pcds[1]))
    a, b = str(tmp_path / "a.pcd"), str(tmp_path / "b.pcd")
    t_native.write_pcd(a, cloud[:300])
    j_native.write_pcd(b, cloud[:300])
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("shape,fov", [((16, 256), (-0.30, 0.25)), ((64, 1024), (-0.40, 0.30))])
def test_projection_matches_loam_tpu(cloud, backend, shape, fov):
    got = t_native.project_range_image(cloud, *shape, *fov)
    np.testing.assert_array_equal(got, j_native.project_range_image(cloud, *shape, *fov))
    assert (np.linalg.norm(got.reshape(-1, 3), axis=1) > 0).sum() > 1000


@pytest.mark.parametrize("packed", [False, True])
def test_scan_loader_matches_loam_tpu(frames, backend, packed):
    bins, pcds = frames
    paths = [bins[0], pcds[1], bins[2], pcds[3], bins[4]]
    args = (paths, LIDAR.scan_lines, LIDAR.points_per_line)
    kw = dict(n_threads=3, queue_cap=2, packed=packed)
    t_loader, j_loader = t_native.ScanLoader(*args, **kw), j_native.ScanLoader(*args, **kw)
    got, want = list(t_loader), list(j_loader)
    t_loader.close()
    j_loader.close()
    assert len(got) == len(want) == len(paths)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_packed_loader_refuses_one_scan_line(frames):
    with pytest.raises(ValueError, match="2 scan lines"):
        t_native.ScanLoader(frames[0], 1, 360, packed=True)


def test_as_points_matches_loam_tpu():
    import collections

    P = collections.namedtuple("P", "x y z")
    structured = np.array([(1.0, 2.0, 3.0), (4.0, 5.0, 6.0)],
                          dtype=[("x", "f4"), ("y", "f4"), ("z", "f4")])
    for obj in (structured, [P(1, 2, 3), P(4, 5, 6)], [[1, 2, 3]], np.zeros((2, 4, 3)),
                np.arange(12.0).reshape(4, 3)):
        got, want = t_adapters.as_points(obj), j_adapters.as_points(obj)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError):
        t_adapters.as_points(np.zeros((4, 2)))


def test_streaming_signature_matches_loam_tpu():
    """F4: the same parameters in the same order (n_threads and queue_cap
    after motion_init), with the port's ``device`` last."""
    j = list(inspect.signature(j_stream.odometry_streaming).parameters.values())
    t = list(inspect.signature(T.odometry_streaming).parameters.values())
    assert t[-1].name == "device" and t[-1].default is None
    assert [p.name for p in t[:-1]] == [p.name for p in j]
    for a, b in zip(t[:-1], j):
        if b.name not in ("feat_params", "reg_params"):  # each package's own dataclass
            assert a.default == b.default, a.name


@pytest.mark.parametrize("packed", [True, False])
def test_odometry_streaming_over_paths(frames, packed):
    """A list of paths runs through the loader and equals the run over the
    loader's frames."""
    bins = frames[0][:3]
    loader = t_native.ScanLoader(bins, LIDAR.scan_lines, LIDAR.points_per_line, packed=packed)
    loaded = np.stack(list(loader))
    loader.close()
    kw = dict(chunk_frames=2, packed=packed, device="cpu")  # a tail chunk of one frame
    ta, da = T.odometry_streaming(bins, LIDAR, n_threads=2, queue_cap=2, **kw)
    tb, db = T.odometry_streaming(loaded, LIDAR, **kw)
    assert ta.translation.shape == (len(bins), 3)
    assert torch.equal(ta.translation, tb.translation) and torch.equal(ta.rotation, tb.rotation)
    assert torch.equal(da.termination, db.termination)
