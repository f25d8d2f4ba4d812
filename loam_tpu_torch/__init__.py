"""loam-tpu's PyTorch port: LiDAR odometry on torch tensors, with
hand-written CUDA kernels for an NVIDIA Hopper GPU.

The package mirrors ``loam_tpu``'s layout and names -- every name of
``loam_tpu.__all__`` is here -- and is held against it by the tests; it
imports neither JAX nor ``loam_tpu``. Kernels run for CUDA tensors and their
plain PyTorch versions for CPU tensors (see ``ops``).
"""

from .geometry import (
    Pose3,
    fit_line,
    fit_plane,
    point_to_line_distance,
    point_to_plane_distance,
    quat_angular_distance,
    quat_exp,
    quat_from_axis_angle,
    quat_log,
    quat_multiply,
    quat_rotate,
    quat_to_matrix,
)
from .params import (
    FeatureExtractionParams,
    LidarParams,
    RegistrationParams,
    TerminationType,
)
from .features import (
    FeatureSet,
    compute_curvature,
    compute_valid_points,
    extract_features,
    extract_features_batch,
    feature_set_from_points,
)
from . import checkpoint, debug, evaluation, loop_closure, pose_graph
from .dewarp import dewarp_scan
from .map import VoxelMap, voxel_map_empty, voxel_map_insert
from .neighbors import knn
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
from .registration import (
    IterationInfo,
    RegistrationDetail,
    register_features,
    register_features_batch,
)

__version__ = "0.1.0"

__all__ = [
    "FeatureExtractionParams",
    "FeatureSet",
    "IterationInfo",
    "LidarParams",
    "Pose3",
    "RegistrationDetail",
    "RegistrationParams",
    "ScanToMapConfig",
    "ScanToMapState",
    "ScanToScanState",
    "StreamingOdometry",
    "TerminationType",
    "VoxelMap",
    "compute_curvature",
    "compute_valid_points",
    "default_map_reg_params",
    "dewarp_scan",
    "extract_features",
    "extract_features_batch",
    "feature_set_from_points",
    "fit_line",
    "fit_plane",
    "knn",
    "odometry_offline",
    "odometry_streaming",
    "point_to_line_distance",
    "point_to_plane_distance",
    "quat_angular_distance",
    "quat_exp",
    "quat_from_axis_angle",
    "quat_log",
    "quat_multiply",
    "quat_rotate",
    "quat_to_matrix",
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
