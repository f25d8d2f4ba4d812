"""Where the port's entry points put their data.

The rule: on the card unless the caller asks for the CPU. An entry point
that builds state (``scan_to_map_init``, ``scan_to_scan_init``,
``voxel_map_empty``) or takes host data (a numpy array handed to
``odometry_offline`` / ``scan_to_map_offline``, the ``from_numpy``
converters) takes ``device=None``, which means this process's current
card; ``device="cpu"`` asks for the CPU, as the CPU tests do. A tensor input
keeps its own device (PyTorch's idiom) unless ``device`` names another. With
no card and no ``device`` the call raises PyTorch's own error: nothing runs
on the CPU silently.

A CUDA device always carries its index here: ``"cuda"`` becomes
``cuda:<torch.cuda.current_device()>``. On a rank of a mesh that holds one
card each (``torch.cuda.set_device(local_rank)``, ``parallel.sharding``)
that is the rank's own card, and the caches keyed on a device (the
programs, their body streams and tallies, ``program.py``) see one key for
it, never both ``cuda`` and ``cuda:r``.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """``device``, or the current card when it is ``None``; a CUDA device
    with its index."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def place(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor by the rule above: a tensor stays where it is
    unless ``device`` is given; anything else goes through ``np.asarray``
    onto ``resolve(device)``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=resolve(device))
