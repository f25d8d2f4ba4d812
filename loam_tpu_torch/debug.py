"""Numerical-health checks.

Counterpart of ``loam_tpu.debug``. The failure mode these make loud is
silent NaN/Inf poisoning: one non-finite value entering a masked
normal-equation reduction corrupts every downstream pose with no crash (the
``0 * nan`` pitfall the port zeroes masked rows to avoid).

  * :func:`check_finite` -- assert over any nest of tensors / arrays; raises
    ``FloatingPointError`` naming each offending leaf path and its
    non-finite count.
  * :func:`tap_finite` -- the same check at a library tap point, gated by
    ``LOAM_DEBUG_NANS`` (or ``force=True``). ``loam_tpu`` stages it into a
    compiled program through ``jax.debug.callback``; eager tensors need no
    callback, so here it checks at once when enabled (a device-to-host read,
    which synchronizes the stream) and costs nothing otherwise.
  * :func:`debug_nans_enabled` / ``LOAM_DEBUG_NANS=1`` -- the switch, read
    per call.

``torch.autograd.detect_anomaly`` is PyTorch's op-level tool; these helpers
are the complement for forward values.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from .checkpoint import _flatten


def debug_nans_enabled() -> bool:
    """True when ``LOAM_DEBUG_NANS=1``: library tap points check their
    values; otherwise they do nothing."""
    return os.environ.get("LOAM_DEBUG_NANS", "0") == "1"


def _float_leaves(tree: Any):
    for path, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() or leaf.is_complex():
                yield path, leaf
        elif np.issubdtype(np.asarray(leaf).dtype, np.inexact):
            yield path, torch.as_tensor(np.asarray(leaf))


def _report(where: str, counts) -> None:
    bad = [f"{path}: {n} non-finite of {size}" for path, n, size in counts if n]
    if bad:
        prefix = f"[{where}] " if where else ""
        raise FloatingPointError(prefix + "non-finite values detected:\n  " + "\n  ".join(bad))


def check_finite(tree: Any, where: str = "") -> None:
    """Raise ``FloatingPointError`` if any float leaf holds NaN/Inf.

    The message lists every offending leaf as ``path: <n> non-finite of
    <size>``, so a poisoned state is diagnosable in one shot.
    """
    leaves = list(_float_leaves(tree))
    if not leaves:
        return
    # one count per leaf on its device, stacked there: one read back per device
    n = [0] * len(leaves)
    by_device = {}
    for i, (_, x) in enumerate(leaves):
        by_device.setdefault(x.device, []).append(i)
    for idx in by_device.values():
        counts = torch.stack([torch.sum(~torch.isfinite(leaves[i][1])) for i in idx]).tolist()
        for i, c in zip(idx, counts):
            n[i] = c
    _report(where, [(p, c, x.numel()) for (p, x), c in zip(leaves, n)])


def tap_finite(tree: Any, where: str = "", force: bool = False) -> None:
    """:func:`check_finite` at a library tap point: a no-op unless
    ``LOAM_DEBUG_NANS=1`` or ``force=True``."""
    if force or debug_nans_enabled():
        check_finite(tree, where)
