from .curvature import compute_curvature, compute_valid_points, validate_scan
from .extract import extract_features, extract_features_batch, extract_features_given
from .types import FeatureSet, feature_set_from_points

__all__ = [
    "FeatureSet",
    "compute_curvature",
    "compute_valid_points",
    "extract_features",
    "extract_features_batch",
    "extract_features_given",
    "feature_set_from_points",
    "validate_scan",
]
