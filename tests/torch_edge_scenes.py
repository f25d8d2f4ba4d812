"""Degenerate scenes and wide scans, shared by the CPU tests (the port against
``loam_tpu``, ``test_torch_edge_cases.py``) and the GPU tests (the port on the
card against its CPU path, ``test_torch_cuda.py``). They are ``loam_tpu``'s
``tests/test_edge_cases.py`` and ``tests/test_adversarial_scenes.py`` as
inputs: numpy arrays and parameter keyword arguments that either package's
dataclasses take. Numpy and the port's numpy renderer only.
"""

import numpy as np

from loam_tpu_torch.io import render_scan
from loam_tpu_torch.params import LidarParams

LIDAR = dict(scan_lines=8, points_per_line=96, min_range=0.5, max_range=80.0)


def grid_plane(n=40, extent=2.0, origin=(0.0, 0.0, 0.0), axes=((1, 0, 0), (0, 1, 0))):
    """Dense grid of points on a plane patch."""
    u = np.linspace(-extent, extent, n)
    a, b = np.asarray(axes[0], float), np.asarray(axes[1], float)
    return np.asarray([np.asarray(origin) + x * a + y * b for x in u for y in u])


def _yaw(points, angle, t):
    """``points`` rotated by ``angle`` about z, then moved by ``t``."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return points @ rot.T + np.asarray(t, float)


def _wall():
    return grid_plane(n=45, extent=3.0, origin=(5.0, 0.0, 0.0), axes=((0, 1, 0), (0, 0, 1)))


def _far_planes():
    return np.concatenate([
        grid_plane(n=35, extent=4.0, origin=(100.0, 0.0, 0.0), axes=((0, 1, 0), (0, 0, 1))),
        grid_plane(n=35, extent=4.0, origin=(0.0, 100.0, 0.0), axes=((1, 0, 0), (0, 0, 1))),
        grid_plane(n=35, extent=4.0, origin=(0.0, 0.0, -2.0), axes=((1, 0, 0), (0, 1, 0))),
    ])


def _corner():
    """30 edge points on a vertical line and 144 on a wall: 174 associable."""
    edge = np.asarray([(2.0, 2.0, z) for z in np.linspace(-1, 1, 30)])
    return edge, grid_plane(n=12, extent=1.0, origin=(4.0, 0.0, 0.0), axes=((0, 1, 0), (0, 0, 1)))


def _coincident_lines():
    """Clusters of exactly 3 nearly coincident edge points beside a wall."""
    rng = np.random.default_rng(0)
    centers = np.asarray([(3.0, y, 0.0) for y in np.linspace(-2, 2, 40)])
    edge = np.concatenate([c + 1e-5 * rng.standard_normal((3, 3)) for c in centers])
    return edge, grid_plane(n=20, extent=2.0, origin=(6.0, 0.0, 0.0), axes=((0, 1, 0), (0, 0, 1)))


def _moved(edge, planar, angle, t, dtype, reg=None, capacities=None):
    """A registration scene: target (edge, planar), the source the target
    moved by (yaw ``angle``, ``t``), the float type's name, registration
    keyword arguments and feature-set capacities."""
    src_e = _yaw(edge, angle, t) if len(edge) else edge
    return dict(target=(edge, planar), source=(src_e, _yaw(planar, angle, t)), dtype=dtype,
                reg=reg or {}, capacities=capacities or {})


def _empty_source():
    target = (np.random.default_rng(0).uniform(-3, 3, (50, 3)),
              np.random.default_rng(1).uniform(-3, 3, (200, 3)))
    return dict(target=target, source=(np.zeros((0, 3)), np.zeros((0, 3))), dtype="float64",
                reg={}, capacities=dict(edge_capacity=8, planar_capacity=8))


_NONE = np.zeros((0, 3))

#: name -> () -> registration scene (see ``_moved``)
REGISTRATION_SCENES = {
    # one wall: 1 translational DoF and 2 rotations observable
    "single_wall": lambda: _moved(_NONE, _wall(), 0.0, (0.05, 0.0, 0.0), "float64"),
    "single_wall_with_prior": lambda: _moved(_NONE, _wall(), 0.0, (0.05, 0.0, 0.0), "float64",
                                             dict(prior_weight=1.0)),
    # planes at ~100 m in float32
    "far_planes_f32": lambda: _moved(_NONE, _far_planes(), 1e-3, (0.02, -0.01, 0.015), "float32"),
    # 174 associations: solved at min_associations=174, insufficient at 175
    "min_associations_174": lambda: _moved(*_corner(), 0.0, (0.01, 0.0, 0.0), "float64",
                                           dict(min_associations=174)),
    "min_associations_175": lambda: _moved(*_corner(), 0.0, (0.01, 0.0, 0.0), "float64",
                                           dict(min_associations=175)),
    "minimal_line_fit_f64": lambda: _moved(*_coincident_lines(), 0.0, (0.01, -0.005, 0.0), "float64",
                                           dict(min_associations=50)),
    "minimal_line_fit_f32": lambda: _moved(*_coincident_lines(), 0.0, (0.01, -0.005, 0.0), "float32",
                                           dict(min_associations=50)),
    "empty_source": _empty_source,
}


def _scan(lidar, dtype="float64", seed=9, render_as=None):
    """A scan rendered for ``render_as`` (default ``lidar``) keyword
    arguments of ``LidarParams``."""
    return render_scan(LidarParams(**(render_as or lidar)), noise=0.004, seed=seed, dtype=np.dtype(dtype))


def _wide(lines, points, sectors=6, seed=5):
    lidar = dict(scan_lines=lines, points_per_line=points, min_range=0.5, max_range=80.0)
    return dict(lidar=lidar, scan=_scan(lidar, "float32", seed), fp=dict(number_sectors=sectors))


#: name -> () -> dict(lidar=LidarParams keyword arguments, scan=(L, P, 3)
#: numpy, fp=FeatureExtractionParams keyword arguments)
EXTRACTION_SCENES = {
    "one_sector": lambda: dict(lidar=LIDAR, scan=_scan(LIDAR), fp=dict(number_sectors=1)),
    "neighbor_points_1": lambda: dict(lidar=LIDAR, scan=_scan(LIDAR), fp=dict(neighbor_points=1)),
    "one_sector_neighbor_points_1": lambda: dict(lidar=LIDAR, scan=_scan(LIDAR),
                                                 fp=dict(number_sectors=1, neighbor_points=1)),
    "caps_of_one": lambda: dict(lidar=LIDAR, scan=_scan(LIDAR),
                                fp=dict(max_edge_feats_per_sector=1, max_planar_feats_per_sector=1)),
    # every point beyond max_range (1 m): no features
    "all_out_of_range": lambda: dict(
        lidar=dict(scan_lines=4, points_per_line=64, min_range=0.5, max_range=1.0),
        scan=_scan(dict(scan_lines=4, points_per_line=64, min_range=0.5, max_range=80.0), seed=0), fp={}),
    # planar threshold above every curvature: planar candidates everywhere
    "huge_thresholds": lambda: dict(lidar=LIDAR, scan=_scan(LIDAR),
                                    fp=dict(planar_feat_threshold=1e12, edge_feat_threshold=1e12)),
    # widths past the register forms of the kernels: lines of more than 2,048
    # points (greedy NMS) and sectors of more than 1,024 slots (sector sort)
    "wide_4x2083": lambda: _wide(4, 2083),
    "wide_4x3600": lambda: _wide(4, 3600),
    "wide_4x2048_one_sector": lambda: _wide(4, 2048, sectors=1),
    "wide_2x8192_one_sector": lambda: _wide(2, 8192, sectors=1),
}
