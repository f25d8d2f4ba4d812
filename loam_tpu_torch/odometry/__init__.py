"""Odometry drivers: batched offline scan-to-scan, the frame-by-frame
scan-to-scan loop, the chunked streaming drivers, and scan-to-map against
voxel maps."""

from .offline import odometry_offline
from .scan_to_map import (
    ScanToMapConfig,
    ScanToMapState,
    default_map_reg_params,
    scan_to_map_init,
    scan_to_map_offline,
    scan_to_map_rebuild_cache,
    scan_to_map_step,
    scan_to_map_step_features,
    scan_to_map_strip_cache,
)
from .scan_to_scan import ScanToScanState, scan_to_scan_init, scan_to_scan_step
from .streaming import (
    StreamCarry,
    StreamingOdometry,
    odometry_streaming,
    stream_chunk_step,
    stream_init,
)

__all__ = [
    "ScanToMapConfig",
    "ScanToMapState",
    "ScanToScanState",
    "StreamCarry",
    "StreamingOdometry",
    "default_map_reg_params",
    "odometry_offline",
    "odometry_streaming",
    "scan_to_map_init",
    "scan_to_map_offline",
    "scan_to_map_rebuild_cache",
    "scan_to_map_step",
    "scan_to_map_step_features",
    "scan_to_map_strip_cache",
    "scan_to_scan_init",
    "scan_to_scan_step",
    "stream_chunk_step",
    "stream_init",
]
