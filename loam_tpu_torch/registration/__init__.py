"""Feature registration ("Iterative Closest Feature"): kNN association to
line/plane fits and an analytic-Jacobian LM solve of the delta pose,
batched over pairs."""

from .detail import IterationInfo, RegistrationDetail
from .icf import azimuth_sort_features, register_features, register_features_batch

__all__ = [
    "IterationInfo",
    "RegistrationDetail",
    "azimuth_sort_features",
    "register_features",
    "register_features_batch",
]
