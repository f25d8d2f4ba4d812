#!/usr/bin/env python3
"""loambench: run one cell of ``BENCHMARK.json`` once.

    python3 loambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for (it exits with code 2 and prints no result without them). A cell is a
configuration (``configs/<name>.json``: the path and its parameters, the
entry module ``entries/<entry>.py`` that drives it) under a traffic mix
(``traffic/<name>.json``). The run:

1. set-up (``setup_s``, from the interpreter's start): renders the mix's
   segments on the card from the seed, builds the entry, and calls it
   twice (the capture of its CUDA graph, then one replay);
2. the window: one caller in a closed loop, each call a segment through the
   entry, timed from issue until its outputs are ready on the card, for
   ``--seconds`` seconds (the last call ends past it); ``scans_per_s`` is
   the frames of every call over the window, ``call_p95_ms`` the tail of
   every call, ``peak_mem_mb`` the allocator's peak reserved bytes;
3. with ``--trace 1``, a few more calls under ``torch.profiler``, read by
   each per-layer metric's reader (``metrics/<name>.py``);
4. the check: the program's state freed, the plain reference
   (``reference/``) recomputes the judged segments from their scans, and
   every judged call is compared with it (``judge.py``, limits in
   ``limits/<cell>.json``).

The last line of standard output is the result, one JSON object; the
numbers compared, each beside its limit, end standard error and the
result. A configuration with ``ranks`` > 1 runs as that many processes, one
a card, which this script starts (``--rank``) and whose results it merges.
``--calls-out FILE`` writes every window call's segment, issue time, host
time and latency as JSON (for a look at how the calls spread).
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level modules that may not be loaded: the JAX package and JAX.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "loam_tpu"})
#: Calls traced with ``--trace 1``.
TRACED_CALLS = 3
#: Seconds a rank of a multi-card cell may take, set-up and check included.
RANK_LIMIT_S = 330


def forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    p.add_argument("--started", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--calls-out", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = ROOT / ".loambench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Alone:
    """The stop rule of one process: the window ends when its clock says."""

    def agree(self, stop: bool) -> bool:
        return stop


class Ranks:
    """The stop rule of several ranks: rank 0's clock, broadcast on a gloo
    group after every call, so every rank makes the same calls."""

    def __init__(self, group, world: int):
        import torch

        self.group, self.world, self.flag = group, world, torch.zeros(1, dtype=torch.int32)

    def agree(self, stop: bool) -> bool:
        import torch.distributed as dist

        self.flag[0] = int(stop)
        dist.broadcast(self.flag, src=0, group=self.group)
        return bool(self.flag[0])


def _host(kept: dict) -> dict:
    """A call's kept outputs copied to the host (its final maps, kept for a
    judged segment's first call, stay on the card): what the window keeps
    for the check then adds nothing to the card's memory, so that
    ``peak_mem_mb`` reads the program's and not the number of calls."""
    import torch

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, (tuple, list)):
            parts = [move(y) for y in x]
            return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)
        return x

    return {name: x if name == "maps" else move(x) for name, x in kept.items()}


class Context:
    """What a per-layer metric's reader gets: the traced calls' ``trace``
    (``trace.Trace``) and settled outputs (``traced``), the window's host
    times a call (``host_s``), the configuration, the entry and the frames
    of a call."""

    def __init__(self, trace, traced, host_s, config, entry, frames):
        self.trace, self.traced, self.host_s = trace, traced, host_s
        self.config, self.entry, self.frames = config, entry, frames


def run_cell(cell: dict, seed: int, seconds: float, trace_on: bool, device, mesh=None, comm=None,
             t0: float = None, log=print, calls_out: str = None):
    """One run of ``cell`` on ``device`` (a CUDA device, or the CPU where a
    test drives the harness without a card). Returns (result, compared)."""
    import torch

    from loambench import cells, judge, measure, scene
    from loambench import trace as tracing

    t0 = _T0 if t0 is None else t0
    comm = comm or Alone()
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    config, mix = cell["config"], cell["traffic"]
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # --- set-up: the segments, the entry, its shapes warmed
    segs = scene.segments(mix, config["lidar"], seed, device)
    path = cells.entry(config)
    entry = path.Entry(config, device, mesh)
    order, judged = scene.order(len(segs), seed), set(scene.judged(mix, seed))
    frames = int(mix["frames"])
    for _ in range(2):
        entry.call(segs[order[0]].scans)
    sync()
    setup_s = time.perf_counter() - t0

    # --- the window
    calls, kept, seen = [], [], set()
    start = time.perf_counter()
    i = 0
    while True:
        k = int(order[i % len(segs)])
        a = time.perf_counter()
        out = entry.call(segs[k].scans)
        b = time.perf_counter()
        sync()
        c = time.perf_counter()
        full = k in judged and k not in seen
        if full:
            seen.add(k)
        kept.append((k, _host(entry.keep(out, full))))
        del out
        calls.append((a, b, c))
        i += 1
        if comm.agree(c - start >= seconds):
            break
    window_s = calls[-1][2] - calls[0][0]
    if calls_out:
        with open(calls_out, "w") as f:
            json.dump({"segment": [int(order[j % len(segs)]) for j in range(len(calls))],
                       "issue_s": [a - start for a, _, _ in calls], "host_s": [b - a for a, b, _ in calls],
                       "latency_s": [c - a for a, _, c in calls]}, f)
    peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    latencies = [c - a for a, _, c in calls]
    host_s = [b - a for a, b, _ in calls]
    metrics = {
        "scans_per_s": {"value": measure.rate(len(calls) * frames, window_s), "unit": "scans/s"},
        "call_p95_ms": {"value": 1e3 * measure.percentile(latencies, 95), "unit": "ms"},
        "peak_mem_mb": {"value": peak / 1e6, "unit": "MB"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    kept = [(k, entry.settle(x)) for k, x in kept]
    failed = sum(judge.failures(x, segs[k].positions) for k, x in kept)
    log(f"window: {len(calls)} calls in {window_s:.3f} s, {failed} failed; set-up {setup_s:.3f} s")

    # --- the traced calls
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": getattr(comm, "world", 1), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace_on:
        traced_outs = []

        def traced():
            for j in range(TRACED_CALLS):
                traced_outs.append(entry.call(segs[int(order[j % len(segs)])].scans))
            sync()

        tr = tracing.record(traced, TRACED_CALLS)
        log(f"trace: {len(tr.device)} device events, their union {tr.busy(False):.6f} s; "
            f"{len(tr.graphs)} driver ranges on the card, {sum(e.end - e.start for e in tr.graphs):.6f} s; "
            f"busy {tr.busy():.6f} s of {tr.window.end - tr.window.start:.6f} s")
        settled = [entry.settle(entry.keep(o, True)) for o in traced_outs]
        del traced_outs
        ctx = Context(tr, settled, host_s, config, entry, frames)
        metrics = {}
        for m in cell["per_layer"]:
            v = cells.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info["busy_s"] = tr.busy()
        device_info["window_s"] = tr.window.end - tr.window.start
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        metrics = {m["name"]: metrics[m["name"]] for m in cell["end_to_end"]}

    # --- the check, the program's state freed first
    judging = {k: [x for kk, x in kept if kk == k] for k in judged}
    kept = None
    import loam_tpu_torch.program as program

    program.clear_cache()
    if cuda:
        torch.cuda.empty_cache()
    readings = []
    for k, xs in judging.items():
        if not xs:
            continue
        ref = path.reference(config, segs[k].scans)
        readings += [path.compare(config, x, ref, getattr(entry, "shard", None)) for x in xs]
    numbers = judge.worst(readings)
    rows = judge.verdict(numbers, cell["limits"])
    result = {"correct": judge.correct(rows), "attempted": len(calls), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, rows


def _finish(result: dict, rows: list) -> int:
    """Print the compared numbers and the result line; refuse a run that
    loaded the JAX package or JAX."""
    found = forbidden()
    if found:
        print(f"loambench: modules that may not be loaded are loaded: {found}", file=sys.stderr)
        return 3
    for name, v, limit in rows:
        print(f"compared {name} {v!r} limit {limit!r}", file=sys.stderr)
    result["compared"] = {name: {"value": v, "limit": limit} for name, v, limit in rows}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _rank_main(args, cell: dict) -> int:
    """Rank ``args.rank`` of a multi-card cell: its card, the NCCL group on
    loopback, the mesh, a gloo group for the stop rule; its result to
    ``args.out``."""
    import datetime

    import torch
    import torch.distributed as dist

    world = int(cell["config"]["ranks"])
    torch.cuda.set_device(args.rank)
    device = torch.device("cuda", args.rank)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{args.port}", world_size=world,
                            rank=args.rank, device_id=device, timeout=datetime.timedelta(seconds=RANK_LIMIT_S))
    try:
        from loam_tpu_torch import parallel, program

        control = dist.new_group(backend="gloo")
        mesh = parallel.make_mesh(group=dist.group.WORLD)
        comm = Ranks(control, world)
        # set-up counts from the start of the process that started the ranks
        t0 = time.perf_counter() - (time.time() - args.started)
        result, rows = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, mesh, comm, t0,
                                log=lambda s: print(f"rank {args.rank}: {s}", file=sys.stderr))
        program.clear_cache()
        torch.cuda.synchronize(device)
        dist.barrier(group=control)
        mesh.release()
        dist.barrier(group=control)
    finally:
        dist.destroy_process_group()
    result["forbidden"] = forbidden()
    with open(args.out, "w") as f:
        json.dump({"result": result, "rows": rows}, f)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(args, cell: dict) -> int:
    """Start the cell's ranks (this script, ``--rank``), wait for all, merge:
    the slowest rank's rate and tail, the fullest card's peak, every rank's
    numbers compared (the worst of each), the traced metrics of rank 0 but
    the collectives' time, the slowest rank's."""
    world = int(cell["config"]["ranks"])
    port = _free_port()
    started = time.time() - (time.perf_counter() - _T0)
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
                                   "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
                                   str(args.trace), "--rank", str(r), "--port", str(port), "--out", outs[r],
                                   "--started", repr(started)],
                                  cwd=str(ROOT)) for r in range(world)]
        deadline = time.perf_counter() + RANK_LIMIT_S
        try:
            while any(p.poll() is None for p in procs):
                if time.perf_counter() > deadline or any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    time.sleep(2.0)
                    p.kill() if p.poll() is None else None
            for p in procs:
                p.wait()
        codes = [p.returncode for p in procs]
        if any(codes) or not all(os.path.exists(o) for o in outs):
            print(f"loambench: ranks ended with codes {codes}", file=sys.stderr)
            return 1
        got = [json.load(open(o)) for o in outs]
    results = [g["result"] for g in got]
    bad = sorted({m for r in results for m in r.pop("forbidden")})
    if bad:
        print(f"loambench: a rank loaded modules that may not be loaded: {bad}", file=sys.stderr)
        return 3
    merged = dict(results[0])
    m = merged["metrics"]
    pick = {"scans_per_s": min, "call_p95_ms": max, "peak_mem_mb": max, "setup_s": max,
            "mesh.collective_ms_per_frame": max}
    for name, how in pick.items():
        if name in m:
            m[name] = dict(m[name], value=how(r["metrics"][name]["value"] for r in results))
    merged["failed"] = max(r["failed"] for r in results)
    merged["correct"] = all(r["correct"] for r in results)
    dev = dict(merged["device"], count=world,
               memory_peak_bytes=max(r["device"]["memory_peak_bytes"] for r in results))
    if "busy_s" in dev:
        dev["busy_s"] = sum(r["device"]["busy_s"] for r in results) / world
        dev["window_s"] = max(r["device"]["window_s"] for r in results)
    merged["device"] = dev
    rows = [[name, max(g["rows"][i][1] for g in got), limit] for i, (name, _, limit) in enumerate(got[0]["rows"])]
    merged["correct"] = merged["correct"] and all(v == v and v <= limit for _, v, limit in rows)
    return _finish(merged, rows)


def main(argv=None) -> int:
    args = _args(argv)
    _caches()
    from loambench import cells

    cell = cells.cell(args.workload)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"loambench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if int(cell["config"].get("ranks", 1)) > 1:
        if args.rank is not None:
            return _rank_main(args, cell)
        return _ranks(args, cell)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, rows = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                            log=lambda s: print(s, file=sys.stderr), calls_out=args.calls_out)
    return _finish(result, rows)


if __name__ == "__main__":
    sys.exit(main())
