"""Host-side IO: the synthetic scan renderer and the packed scan codec."""

from .packed import PACKED_R_MAX, decode_packed, encode_packed_grid, project_packed_numpy
from .synthetic import Box, default_world, render_scan, render_trajectory

__all__ = [
    "Box",
    "PACKED_R_MAX",
    "decode_packed",
    "default_world",
    "encode_packed_grid",
    "project_packed_numpy",
    "render_scan",
    "render_trajectory",
]
