"""A traced stretch of calls: ``torch.profiler`` around them, its Chrome
trace read back into the device's kernels and copies, the host's runtime
calls and the ranges the program and the benchmark open. The arithmetic
of ``loam_tpu_torch/profiling.py`` (kernel time by name, launch calls
inside a range), copied here so that the program cannot change it."""

from __future__ import annotations

import json
import os
import tempfile
from typing import List, NamedTuple

from . import measure

#: The benchmark's range around the traced calls.
WINDOW = "loambench.traced_calls"
#: The program's range around a driver call (``program.DRIVER_RANGE``).
DRIVER = "driver_loop"
#: Host calls that launch device work: a kernel each, or a whole graph.
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaGraphLaunch", "cuGraphLaunch")
#: Trace categories of device work.
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


class Event(NamedTuple):
    name: str
    start: float  # seconds on the trace's clock
    end: float


class Trace(NamedTuple):
    device: List[Event]  # kernels, copies and fills on the card
    host: List[Event]  # the host's operators, runtime calls and ranges
    window: Event  # the benchmark's range around the traced calls
    calls: int
    graphs: List[Event] = []  # the program's driver ranges on the card's timeline

    def kernels(self, *needles: str) -> List[Event]:
        """Kernels whose name holds one of ``needles``."""
        return [e for e in self.device if any(n in e.name for n in needles)]

    def device_seconds(self, *needles: str) -> float:
        return sum(e.end - e.start for e in self.kernels(*needles))

    def busy(self, graphs: bool = True) -> float:
        """Seconds in the window in which the card ran something: the union
        of its intervals (branches of one graph overlap) and, with
        ``graphs``, of the spans in which it ran a driver range's work
        (first to last kernel of a graph launch: CUPTI records only part of
        what a graph's WHILE bodies run, so their kernels alone leave most
        of a graph's time out)."""
        w = self.window
        spans = self.device + (self.graphs if graphs else [])
        return measure.union((max(e.start, w.start), min(e.end, w.end)) for e in spans
                             if e.end > w.start and e.start < w.end)

    def launches(self, within: str = None) -> int:
        """Host launch calls, those inside ranges named ``within`` where given."""
        spans = [e for e in self.host if e.name == within] if within else None
        return sum(1 for e in self.host if e.name in LAUNCHES
                   and (spans is None or any(s.start <= e.start <= s.end for s in spans)))

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for e in self.device:
            by[e.name] = by.get(e.name, 0.0) + (e.end - e.start)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with nothing on the card, each named by the
        innermost host event open at its start."""
        w = self.window
        out = []
        for a, b in measure.gaps([(e.start, e.end) for e in self.device + self.graphs], w.start, w.end)[:n]:
            open_ = [e for e in self.host if e.start <= a <= e.end and e.name != WINDOW]
            name = min(open_, key=lambda e: e.end - e.start).name if open_ else "host between calls"
            out.append([name, b - a])
        return out


def read(path: str, calls: int) -> Trace:
    """The Chrome trace at ``path`` (``prof.export_chrome_trace``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, graphs, window = [], [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ev = Event(e.get("name", ""), e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
        if e.get("cat") in DEVICE:
            device.append(ev)
        elif e.get("cat") == "gpu_user_annotation" and ev.name == DRIVER:
            graphs.append(ev)
        elif e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"):
            host.append(ev)
            if ev.name == WINDOW and e.get("cat") == "user_annotation":
                window = ev
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    return Trace(device, host, window, calls, graphs)


def record(run, calls: int) -> Trace:
    """Trace ``run()`` (which makes ``calls`` calls and waits for them) under
    the benchmark's range; the trace file goes to a temporary directory
    (under ``TMPDIR``) and is removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                run()
        prof.export_chrome_trace(path)
        return read(path, calls)
