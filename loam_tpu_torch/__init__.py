"""loam-tpu's PyTorch port: LiDAR odometry on torch tensors, with
hand-written CUDA kernels for an NVIDIA Hopper GPU.

The package mirrors ``loam_tpu``'s layout and names and is held against it
by the tests; it imports neither JAX nor ``loam_tpu``. Kernels run for CUDA
tensors and their plain PyTorch versions for CPU tensors (see ``ops``).
"""

from .features import FeatureSet, extract_features, extract_features_batch
from .geometry import Pose3
from .odometry import odometry_offline
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
    "TerminationType",
    "extract_features",
    "extract_features_batch",
    "odometry_offline",
    "register_features",
    "register_features_batch",
]
