"""Profiling and timing utilities.

Counterpart of ``loam_tpu.profiling``:

  * :func:`trace` -- context manager around ``torch.profiler`` writing a
    Chrome trace (``trace.json``, loadable in Perfetto or
    ``chrome://tracing``) into a directory;
  * :func:`force` -- a completion barrier for the devices a result lives on;
  * :func:`device_time` -- average time per call of a function: CUDA events
    around the calls on the card, the host clock after a barrier on the CPU;
  * :func:`kernel_times` / :func:`launch_calls` / :func:`host_reads` -- a
    ``torch.profiler`` trace's device time by kernel, the host's kernel and
    graph launch calls (all of them, and those inside a range: the ICF
    loop's or a driver's loop over frames or chunks), and the host's reads
    of the device inside a range.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from .checkpoint import _flatten
from .program import DRIVER_RANGE
from .registration.loop import LOOP_RANGE


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


#: The runtime and driver calls that launch device work from the host: a
#: kernel each, or a whole CUDA graph.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch")


def kernel_times(events) -> dict:
    """Device microseconds by kernel name in a ``torch.profiler`` trace's
    ``events()``: the card's kernels (those a CUDA graph launches, its
    conditional nodes' bodies included, as the trace records them), not the
    device-side spans of ``record_function`` ranges (the ICF loop's, the
    drivers'), which cover kernels."""
    out = {}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.device_time > 0
                and not getattr(e, "is_user_annotation", False)
                and e.name not in (LOOP_RANGE, DRIVER_RANGE)):
            out[e.name] = out.get(e.name, 0.0) + e.device_time
    return out


def _inside(events, within: str):
    """Whether a host event starts inside a host range named ``within``."""
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == within and e.device_type == torch.autograd.DeviceType.CPU]
    return lambda e: any(a <= e.time_range.start <= b for a, b in spans)


def launch_calls(events, within: str = LOOP_RANGE) -> tuple:
    """Host launch calls in a ``torch.profiler`` trace's ``events()``, by
    name: ``(all, inside)``, ``inside`` those that start within a range
    named ``within`` (by default the ICF loop's; ``program.DRIVER_RANGE``
    for a driver's loop, where a frame or chunk is one ``cudaGraphLaunch``)."""
    inside_range = _inside(events, within)
    every, inside = {}, {}
    for e in events:
        if e.name in LAUNCH_CALLS:
            every[e.name] = every.get(e.name, 0) + 1
            if inside_range(e):
                inside[e.name] = inside.get(e.name, 0) + 1
    return every, inside


#: Host calls that wait for the device: a scalar read (``.item()``,
#: ``bool()``) and the synchronisations a blocking copy to the host makes.
HOST_WAITS = ("aten::_local_scalar_dense", "cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def host_reads(events, within: str = DRIVER_RANGE) -> dict:
    """The host's reads of the device inside the ranges named ``within``,
    by name: the calls of :data:`HOST_WAITS`, and under ``"DtoH copies"``
    the host operations whose device work is a device-to-host copy
    (``Memcpy DtoH``, a ``cudaMemcpyAsync`` to the host). Empty where the
    range reads nothing back."""
    inside_range = _inside(events, within)
    out = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not inside_range(e):
            continue
        name = e.name if e.name in HOST_WAITS else None
        if name is None and any(k.name.startswith("Memcpy DtoH") for k in getattr(e, "kernels", ())):
            name = "DtoH copies"
        if name is not None:
            out[name] = out.get(name, 0) + 1
    return out
