"""Where the port's entry points put their data.

The rule: on the card unless the caller asks for the CPU. An entry point
that builds state (``scan_to_map_init``, ``scan_to_scan_init``,
``voxel_map_empty``) or takes host data (a numpy array handed to
``odometry_offline`` / ``scan_to_map_offline``, the ``from_numpy``
converters) takes ``device=None``, which means ``torch.device("cuda")``;
``device="cpu"`` asks for the CPU, as the CPU tests do. A tensor input keeps
its own device (PyTorch's idiom) unless ``device`` names another. With no
card and no ``device`` the call raises PyTorch's own error: nothing runs on
the CPU silently.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """``device``, or the card when it is ``None``."""
    return torch.device("cuda" if device is None else device)


def place(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor by the rule above: a tensor stays where it is
    unless ``device`` is given; anything else goes through ``np.asarray``
    onto ``resolve(device)``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=resolve(device))
