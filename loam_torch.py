"""Repo-root shim: ``import loam_torch`` resolves to the reference-compatible
API of the PyTorch port, as ``import loam`` does to ``loam_tpu``'s.

Lets code written against the reference's pybind11 module run on the port
from a checkout of this repo. See ``loam_tpu_torch/compat.py``.
"""

from loam_tpu_torch.compat import *  # noqa: F401,F403
from loam_tpu_torch.compat import __all__  # noqa: F401
