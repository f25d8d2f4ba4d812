"""Host-side IO: the synthetic scan renderer, the packed scan codec and the
native readers and loader (``native``: PCD/KITTI readers, spherical
range-image projection and a threaded prefetch loader in C++, with NumPy
fallbacks)."""

from .native import (
    ScanLoader,
    native_available,
    project_range_image,
    read_kitti_bin,
    read_pcd,
    write_pcd,
)
from .packed import PACKED_R_MAX, decode_packed, encode_packed_grid, project_packed_numpy
from .synthetic import (
    Box,
    default_world,
    random_pose_graph,
    render_scan,
    render_trajectory,
    square_loop_scans,
    write_kitti_bins,
)

__all__ = [
    "Box",
    "PACKED_R_MAX",
    "ScanLoader",
    "decode_packed",
    "default_world",
    "encode_packed_grid",
    "native_available",
    "project_packed_numpy",
    "project_range_image",
    "random_pose_graph",
    "read_kitti_bin",
    "read_pcd",
    "render_scan",
    "render_trajectory",
    "square_loop_scans",
    "write_kitti_bins",
    "write_pcd",
]
