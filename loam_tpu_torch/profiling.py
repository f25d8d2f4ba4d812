"""Profiling and timing utilities.

Counterpart of ``loam_tpu.profiling``:

  * :func:`trace` -- context manager around ``torch.profiler`` writing a
    Chrome trace (``trace.json``, loadable in Perfetto or
    ``chrome://tracing``) into a directory;
  * :func:`force` -- a completion barrier for the devices a result lives on;
  * :func:`device_time` -- average time per call of a function: CUDA events
    around the calls on the card, the host clock after a barrier on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from .checkpoint import _flatten


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("trace_dir") as prof:`` -- a ``torch.profiler`` trace of
    the host and (when there is one) the card, written to
    ``log_dir/trace.json`` on exit; ``prof.key_averages()`` tables it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def force(tree) -> None:
    """Wait until the work producing ``tree``'s tensors has finished:
    synchronize every CUDA device one of its leaves lies on (CPU tensors are
    ready when they are returned)."""
    devs = {leaf.device for _, leaf in _flatten(tree)
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devs:
        torch.cuda.synchronize(dev)


def device_time(
    fn: Callable,
    x: torch.Tensor,
    *static_args,
    n_inner: int = 10,
    reps: int = 2,
) -> float:
    """Average seconds per call of ``fn(x, *static_args)`` on ``x``'s device.

    One warm-up call (kernel builds, allocator) is excluded. On the card the
    ``reps * n_inner`` calls are enqueued back to back between two CUDA
    events, so the time is the device's (the host's time per call shows
    only where it exceeds the device's); on the CPU the host clock is read
    around them.
    """
    force(fn(x, *static_args))
    n = reps * n_inner
    if x.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(x, *static_args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn(x, *static_args)
    return (time.perf_counter() - t0) / n
