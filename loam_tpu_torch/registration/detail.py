"""Registration diagnostics: fixed-shape ``RegistrationDetail``.

The counterpart of ``loam_tpu.registration.detail`` (reference
``registration.h:79-109``): per-iteration records stacked on an iteration
axis, association lists as (max_iterations, capacity) index arrays with -1
padding, and the termination reason as an int32 code
(``params.TerminationType``). Leading axes batch over pairs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import Pose3


class IterationInfo(NamedTuple):
    """Stacked per-iteration diagnostics (iteration axis after any batch
    axis). Iterations at index >= ``num_iterations`` did not run.

    Attributes:
      target_T_source_init: Pose3 -- estimate entering each iteration.
      estimate_update: Pose3 -- the solved delta (identity for iterations
        that bailed before solving).
      edge_match: (..., I, E) int32 -- nearest associated target index per
        source edge slot, or -1 (empty when matches are not recorded).
      plane_match: (..., I, Q) int32 -- the same for planar features.
      edge_count / plane_count: (..., I) int32 valid associations.
      edge_knn_overflow / plane_knn_overflow: (..., I) int32, always 0 for
        the exact brute-force search (the field the grid backend fills in
        ``loam_tpu``).
    """

    target_T_source_init: Pose3
    estimate_update: Pose3
    edge_match: torch.Tensor
    plane_match: torch.Tensor
    edge_count: torch.Tensor
    plane_count: torch.Tensor
    edge_knn_overflow: torch.Tensor = None
    plane_knn_overflow: torch.Tensor = None


class RegistrationDetail(NamedTuple):
    """Fixed-shape analogue of reference ``RegistrationDetail``.

    Attributes:
      iteration_info: stacked per-iteration records.
      termination: int32 code, see ``params.TerminationType``.
      num_iterations: int32 -- outer iterations that produced a record.
    """

    iteration_info: IterationInfo
    termination: torch.Tensor
    num_iterations: torch.Tensor


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over nested NamedTuples of tensors (``None``
    leaves stay ``None``)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *parts) for parts in zip(*trees)))
    return fn(*trees)
