"""Point-type adapters: accept any common point-cloud representation.

A numpy-only copy of ``loam_tpu.adapters``.

The reference's accessor templates (``common.h:53-93``: ``FieldAccessor`` for
PCL-style ``.x/.y/.z`` structs, ``ParenAccessor`` for Eigen, ``AtAccessor``
for ``std::vector``/numpy) let user point types plug in without conversion.
The Python-facing analogue is one coercion function that takes whatever the
user has and produces the dense (N, 3) array the kernels consume:

  * (N, 3) / (L, P, 3) numeric arrays (zero-copy views where possible),
  * numpy structured arrays with ``x``/``y``/``z`` fields (PCL dumps,
    ros_numpy clouds),
  * iterables of 3-sequences,
  * iterables of objects exposing ``.x``/``.y``/``.z`` attributes.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def as_points(obj: Any, dtype=np.float64) -> np.ndarray:
    """Coerce ``obj`` to an (N, 3) array (flattening an (L, P, 3) grid)."""
    if isinstance(obj, np.ndarray) and obj.dtype.names:
        for fields in (("x", "y", "z"), ("X", "Y", "Z")):
            if all(f in obj.dtype.names for f in fields):
                flat = obj.reshape(-1)
                return np.stack(
                    [flat[f].astype(dtype) for f in fields], axis=-1
                )
        raise TypeError(
            f"structured array lacks x/y/z fields (has {obj.dtype.names})"
        )
    if isinstance(obj, np.ndarray) or hasattr(obj, "__array__"):
        arr = np.asarray(obj, dtype=dtype)
        if arr.ndim == 3 and arr.shape[-1] == 3:
            return arr.reshape(-1, 3)
        if arr.ndim == 2 and arr.shape[-1] == 3:
            return arr
        raise TypeError(f"cannot interpret array of shape {arr.shape} as points")
    seq = list(obj)
    if seq and hasattr(seq[0], "x") and hasattr(seq[0], "y"):
        return np.array([[p.x, p.y, p.z] for p in seq], dtype=dtype)
    return np.asarray(seq, dtype=dtype).reshape(-1, 3)
