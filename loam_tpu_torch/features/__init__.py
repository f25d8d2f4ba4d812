from .curvature import compute_curvature, compute_valid_points, validate_scan
from .extract import extract_features, extract_features_batch
from .types import FeatureSet

__all__ = [
    "FeatureSet",
    "compute_curvature",
    "compute_valid_points",
    "extract_features",
    "extract_features_batch",
    "validate_scan",
]
