"""Local map layer for scan-to-map odometry: a fixed-capacity
voxel-downsampled point map per feature class (``loam_tpu.map``)."""

from .voxel_map import VoxelMap, voxel_map_empty, voxel_map_insert

__all__ = ["VoxelMap", "voxel_map_empty", "voxel_map_insert"]
