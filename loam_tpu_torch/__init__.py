"""loam-tpu's PyTorch port: LiDAR odometry on torch tensors, with
hand-written CUDA kernels for an NVIDIA Hopper GPU.

The package mirrors ``loam_tpu``'s layout and names and is held against it
by the tests; it imports neither JAX nor ``loam_tpu``. Kernels run for CUDA
tensors and their plain PyTorch versions for CPU tensors (see ``ops``).
"""

from .dewarp import dewarp_scan
from .features import FeatureSet, extract_features, extract_features_batch
from .geometry import Pose3
from .map import VoxelMap, voxel_map_empty, voxel_map_insert
from .odometry import (
    ScanToMapConfig,
    ScanToMapState,
    ScanToScanState,
    StreamingOdometry,
    default_map_reg_params,
    odometry_offline,
    odometry_streaming,
    scan_to_map_init,
    scan_to_map_offline,
    scan_to_map_rebuild_cache,
    scan_to_map_step,
    scan_to_map_step_features,
    scan_to_map_strip_cache,
    scan_to_scan_init,
    scan_to_scan_step,
)
from .params import (
    FeatureExtractionParams,
    LidarParams,
    RegistrationParams,
    TerminationType,
)
from .registration import register_features, register_features_batch

__version__ = "0.1.0"

__all__ = [
    "FeatureExtractionParams",
    "FeatureSet",
    "LidarParams",
    "Pose3",
    "RegistrationParams",
    "ScanToMapConfig",
    "ScanToMapState",
    "ScanToScanState",
    "StreamingOdometry",
    "TerminationType",
    "VoxelMap",
    "default_map_reg_params",
    "dewarp_scan",
    "extract_features",
    "extract_features_batch",
    "odometry_offline",
    "odometry_streaming",
    "register_features",
    "register_features_batch",
    "scan_to_map_init",
    "scan_to_map_offline",
    "scan_to_map_rebuild_cache",
    "scan_to_map_step",
    "scan_to_map_step_features",
    "scan_to_map_strip_cache",
    "scan_to_scan_init",
    "scan_to_scan_step",
    "voxel_map_empty",
    "voxel_map_insert",
]
