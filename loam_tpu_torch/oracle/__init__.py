"""The float64 NumPy oracle: scalar transcriptions of the reference's feature
extraction (``oracle.py``) and ICF loop (``icf_oracle.py``), the ground truth
the vectorized path and its kernels are held to. The port's own copy of
``loam_tpu.oracle``: numpy only, no JAX, so it also runs beside the GPU."""

from .icf_oracle import register_oracle
from .oracle import compute_curvature, compute_valid_points, extract_features

__all__ = ["compute_curvature", "compute_valid_points", "extract_features", "register_oracle"]
