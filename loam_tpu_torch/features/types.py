"""Feature containers: fixed-capacity, masked feature sets.

The reference returns variable-length feature lists (``features.h:68-76``);
as in ``loam_tpu``, a set here has a fixed capacity of ``scan_lines *
number_sectors * (max_*_feats_per_sector + 1)`` slots plus a mask, in
(scan line, sector, curvature rank) slot order -- the reference's output
order. Leading dimensions batch (frames, pairs).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import place

_FIELDS = (
    "edge_points", "edge_mask", "edge_indices",
    "planar_points", "planar_mask", "planar_indices",
)


class FeatureSet(NamedTuple):
    """Padded LOAM feature sets (edge + planar).

    Attributes:
      edge_points:    (..., E, 3) edge feature positions (zeros in invalid slots).
      edge_mask:      (..., E) bool slot validity.
      edge_indices:   (..., E) int32 flat scan index of each feature, -1 when
                      invalid.
      planar_points / planar_mask / planar_indices: the same for planar
                      features, (..., Q, ...).
    """

    edge_points: torch.Tensor
    edge_mask: torch.Tensor
    edge_indices: torch.Tensor
    planar_points: torch.Tensor
    planar_mask: torch.Tensor
    planar_indices: torch.Tensor

    def map(self, fn) -> "FeatureSet":
        """Apply ``fn`` to every leaf (e.g. a slice over the batch axis)."""
        return FeatureSet(*(fn(x) for x in self))

    @staticmethod
    def from_numpy(fs, device=None, dtype=None) -> "FeatureSet":
        """FeatureSet from any six-field feature set of array-likes, e.g. a
        ``loam_tpu.FeatureSet`` (its leaves go through ``np.asarray``), on
        the card unless ``device`` says otherwise (``device.py``). ``dtype``
        applies to the point arrays only."""
        leaves = [np.asarray(getattr(fs, f)) for f in _FIELDS]
        out = []
        for name, x in zip(_FIELDS, leaves):
            if name.endswith("points"):
                out.append(place(x, device, dtype))
            elif name.endswith("mask"):
                out.append(place(x.astype(bool), device))
            else:
                out.append(place(x.astype(np.int32), device))
        return FeatureSet(*out)

    def to_numpy(self) -> Tuple[np.ndarray, ...]:
        """The six leaves as numpy arrays (host copies)."""
        return tuple(x.detach().cpu().numpy() for x in self)

    def compact(self) -> Tuple[np.ndarray, np.ndarray]:
        """Dense (n_edge, 3), (n_planar, 3) numpy arrays in the reference's
        output order (unbatched sets only)."""
        ep, em, _, pp, pm, _ = self.to_numpy()
        return ep[em], pp[pm]

    def compact_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        """Dense flat scan indices of the selected features."""
        _, em, ei, _, pm, pi = self.to_numpy()
        return ei[em], pi[pm]
