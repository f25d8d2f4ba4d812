"""Where a sharded call's collectives spend their time, one rank a card: each
gather (and fixed-order sum) of the call timed on the card, split into the
wait for the slowest rank and the transfer.

    python examples/torch_gather_split.py [--trees DIR ...] [--cells offline ...]
                                          [--ranks N] [--hosts 2x2] [--reps 5] [--out DIR]

Each entry of ``--trees`` is a checkout of this repository whose
``loam_tpu_torch`` is timed, in the order given (``A B B A`` times A and B
in turns); the default is this checkout. For each, N ranks (this script as
the worker, one card each, an NCCL group made eagerly on it, ``make_mesh()``
one shard a rank) run the cells on ``chip_smoke.py``'s 16 frames of 64x1024:
``offline`` (``odometry_offline_sharded``, the default), ``pairs`` (8 pairs),
``extract``, ``posegraph`` (``random_pose_graph(1000, 50)``, float64, 10
LM iterations) and ``s2m`` (16 frames of ``scan_to_map_step_sharded``).
``--hosts`` makes the mesh across hosts (``make_mesh(hosts=)``): one label a
rank, comma-separated (``0,0,1,1``), or a split of ``chip_smoke.py``'s phase
17 by name (``2x2``: hosts of two ranks, ``4x1``: of one), so the split reads
the cross-host leg (the proxy over loopback TCP) beside the island's NVLink.

Every call of ``collectives.gather`` and ``collectives.sum`` inside the call
is wrapped in two stamps: a one-thread kernel that writes the card's
``%globaltimer`` (ns) into a buffer, captured into the call's CUDA graph
with the collective, in the bodies of its conditional nodes too (a body's
slots hold its last iteration). A collective's time on a rank is its
stamps' difference; over the ranks, the least of them is the transfer (the
slowest rank to arrive waits for no one) and the rest of each rank's is its
wait. The stamps add two kernel nodes a collective to the graph, alike on
every tree. Ms a call is the host clock over ``--reps`` calls after the
first (which captures), slowest rank. Prints a table a turn and a JSON line
``{"gather_split": [...]}``; needs one card a rank. The ranks' group, inputs
and cells are ``chip_smoke.py``'s own (``_rank_group``, ``_ranks_inputs``,
``_rank_cells``, from this checkout's copy), so the split times the calls
that its phase 17 gates.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("offline", "pairs", "extract", "posegraph", "s2m")
STAMP_SLOTS = 1 << 14

# the stamp kernel: one thread writes the card's nanosecond timer
_STAMP_CU = r"""
#include <cuda_runtime.h>
__global__ void stamp_kernel(unsigned long long* buf, int i) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[i] = t;
}
extern "C" int loam_split_stamp(void* buf, int i, cudaStream_t s) {
  stamp_kernel<<<1, 1, 0, s>>>(static_cast<unsigned long long*>(buf), i);
  return (int)cudaGetLastError();
}
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _stamp_lib(out_dir: str):
    """The stamp kernel built with ``nvcc`` into ``out_dir`` (once a
    process, from a source file of the process's own)."""
    src, lib = (os.path.join(out_dir, f"stamp_{os.getpid()}.{ext}") for ext in ("cu", "so"))
    with open(src, "w") as f:
        f.write(_STAMP_CU)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, src], check=True, capture_output=True)
    handle = ctypes.CDLL(lib)
    handle.loam_split_stamp.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    handle.loam_split_stamp.restype = ctypes.c_int
    return handle


class Stamps:
    """Wraps a module's collectives: each call's two stamp slots and what
    it moved, in call order (``records``)."""

    def __init__(self, torch, dev, out_dir):
        self.torch, self.dev = torch, dev
        self.buf = torch.zeros(STAMP_SLOTS, dtype=torch.int64, device=dev)
        self.lib = _stamp_lib(out_dir)
        self.next, self.records, self.depth = 0, [], 0

    def stamp(self) -> int:
        i, self.next = self.next, (self.next + 1) % STAMP_SLOTS
        stream = self.torch.cuda.current_stream(self.dev).cuda_stream
        if self.lib.loam_split_stamp(self.buf.data_ptr(), i, stream) != 0:
            raise RuntimeError("the stamp kernel did not launch")
        return i

    def wrap(self, kind: str, fn):
        torch = self.torch

        def wrapped(mesh, x, *args, **kwargs):
            if self.depth:  # a sum made of gathers: stamped once, as the sum
                return fn(mesh, x, *args, **kwargs)
            leaves = [t for t in (x if isinstance(x, (tuple, list)) else [x]) if isinstance(t, torch.Tensor)]
            if not leaves:
                leaves = [t for t in _flat(x) if isinstance(t, torch.Tensor)]
            self.depth += 1
            try:
                a = self.stamp()
                out = fn(mesh, x, *args, **kwargs)
                b = self.stamp()
            finally:
                self.depth -= 1
            self.records.append({
                "kind": kind, "slots": (a, b), "leaves": len(leaves),
                "bytes": sum(t.numel() * t.element_size() for t in leaves),
                "first": f"{str(leaves[0].dtype).removeprefix('torch.')} {tuple(leaves[0].shape)}" if leaves else "",
                "captured": torch.cuda.is_current_stream_capturing()})
            return out

        return wrapped

    def read(self) -> list:
        return self.buf.tolist()


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [y for x in tree for y in _flat(x)]
    return [tree]


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (loaded by its path: a
    tree under test may hold a ``chip_smoke.py`` of its own)."""
    spec = importlib.util.spec_from_file_location("loam_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _labels(hosts, world, smoke):
    """``--hosts`` as one label a rank, or None."""
    if not hosts:
        return None
    splits = smoke._host_splits(world)
    return splits[hosts] if hosts in splits else hosts.split(",")


def worker(tree, rank, world, port, out_dir, turn, cells, reps, hosts=None) -> None:
    sys.path.insert(0, tree)
    import torch
    import torch.distributed as dist

    import loam_tpu_torch as T
    from loam_tpu_torch import parallel
    from loam_tpu_torch.parallel import collectives, sharding

    if not os.path.samefile(os.path.dirname(os.path.dirname(T.__file__)), tree):
        raise RuntimeError(f"imported {T.__file__}, not the tree {tree}")
    smoke = _chip_smoke()
    dev = smoke._rank_group(torch, rank, world, port, smoke.RANKS_COLLECTIVE_TIMEOUT_S)
    try:
        labels = _labels(hosts, world, smoke)
        mesh = parallel.make_mesh(group=dist.group.WORLD, **({"hosts": labels} if labels else {}))
        stamps = Stamps(torch, dev, out_dir)
        for mod in (collectives, sharding):
            if hasattr(mod, "gather"):
                mod.gather = stamps.wrap("gather", mod.gather)
        collectives.sum = stamps.wrap("sum", collectives.sum)
        scans, lidar, fp, rp, graph = smoke._ranks_inputs(T, torch, dev, out_dir, world)
        result = {}
        for cell, (run, _, _) in smoke._rank_cells(T, torch, mesh, scans, lidar, fp, rp, graph, cells).items():
            stamps.records = []
            run()  # the capture
            torch.cuda.synchronize()
            captured = [r for r in stamps.records if r["captured"]]
            walls, splits = [], []
            for _ in range(reps):
                stamps.records = []
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                recs = stamps.records or captured  # a replay runs no Python
                t = stamps.read()
                splits.append([(t[r["slots"][1]] - t[r["slots"][0]]) / 1e3 for r in recs])
            result[cell] = {"wall_ms": walls, "us": splits,
                            "collectives": [{k: r[k] for k in ("kind", "leaves", "bytes", "first")} for r in recs]}
        mesh.release()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"split_{turn}_{rank}.json"), "w") as f:
        json.dump({"tree": tree, "rank": rank, "cells": result}, f)


def _summary(ranks: list, cell: str) -> dict:
    """Per collective over the reps: the slowest rank's mean us, the
    transfer (the least rank's), each rank's wait; their sums; ms a call."""
    per = [np.asarray(r["cells"][cell]["us"]) for r in ranks]  # (reps, collectives) a rank
    us = np.stack(per)  # (ranks, reps, collectives)
    transfer = us.min(axis=0)  # (reps, collectives)
    wait = us - transfer  # (ranks, reps, collectives)
    walls = np.asarray([r["cells"][cell]["wall_ms"] for r in ranks]).max(axis=0)
    return {"ms_a_call": float(walls.mean()), "ms_calls": walls.tolist(),
            "collectives": ranks[0]["cells"][cell]["collectives"],
            "us_slowest": us.max(axis=0).mean(axis=0).tolist(),
            "transfer_us": transfer.mean(axis=0).tolist(),
            "wait_us_mean_rank": wait.mean(axis=(0, 1)).tolist(),
            "wait_us_a_rank": wait.mean(axis=1).sum(axis=1).tolist(),
            "sum_us_a_rank": us.mean(axis=1).sum(axis=1).tolist(),
            "sum_transfer_us": float(transfer.mean(axis=0).sum())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=[HERE])
    ap.add_argument("--cells", nargs="+", default=["offline"], choices=CELLS)
    ap.add_argument("--ranks", type=int, default=None, help="default: the largest power of two <= min(cards, 8)")
    ap.add_argument("--hosts", default=None,
                    help="the mesh across hosts: a label a rank, comma-separated, or 2x2 / 4x1 (chip_smoke.py's splits)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", nargs=5, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        tree, rank, world, port, turn = args.worker
        worker(tree, int(rank), int(world), int(port), args.out, int(turn), args.cells, args.reps, args.hosts)
        return 0

    sys.path.insert(0, HERE)
    import torch

    from loam_tpu_torch.io import render_trajectory
    from loam_tpu_torch.params import LidarParams

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card a rank")
    cards = torch.cuda.device_count()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True).stdout.strip()
    world = args.ranks or 1 << (min(cards, 8).bit_length() - 1)
    out_dir = os.path.abspath(args.out or tempfile.mkdtemp(prefix="gather_split_"))
    os.makedirs(out_dir, exist_ok=True)
    lidar = LidarParams(64, 1024, 0.5, 120.0)
    scans, _ = render_trajectory(lidar, 16, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
                                 noise=0.005, seed=0, dtype=np.float32)
    np.save(os.path.join(out_dir, "scans.npy"), scans)
    turns = []
    for turn, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        port = _free_port()
        env = dict(os.environ, NCCL_SOCKET_IFNAME=os.environ.get("NCCL_SOCKET_IFNAME", "lo"))
        env["PYTHONPATH"] = tree + os.pathsep + env.get("PYTHONPATH", "")
        cmd = lambda r: [sys.executable, os.path.abspath(__file__), "--worker", tree, str(r), str(world), str(port),
                         str(turn), "--out", out_dir, "--reps", str(args.reps), "--cells", *args.cells,
                         *(["--hosts", args.hosts] if args.hosts else [])]
        logs = [open(os.path.join(out_dir, f"split_{turn}_{r}.log"), "w") for r in range(world)]
        procs = [subprocess.Popen(cmd(r), stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=tree)
                 for r in range(world)]
        codes = [p.wait(timeout=900) for p in procs]
        for f in logs:
            f.close()
        if any(codes):
            for r in range(world):
                print(open(os.path.join(out_dir, f"split_{turn}_{r}.log")).read()[-3000:])
            raise SystemExit(f"turn {turn} ({tree}): exit codes {codes}")
        ranks = [json.load(open(os.path.join(out_dir, f"split_{turn}_{r}.json"))) for r in range(world)]
        cells = {cell: _summary(ranks, cell) for cell in args.cells}
        turns.append({"turn": turn, "tree": tree, "cells": cells})
        for cell, s in cells.items():
            print(f"turn {turn} {tree} {cell}: {s['ms_a_call']:.3f} ms a call (slowest rank; {world} ranks, "
                  f"hosts {args.hosts or 'one'}, "
                  f"{card}); {len(s['collectives'])} collectives, us a rank {np.round(s['sum_us_a_rank'], 1).tolist()}"
                  f" of which wait {np.round(s['wait_us_a_rank'], 1).tolist()}, transfer {s['sum_transfer_us']:.1f}")
            for c, slow, tr, w in zip(s["collectives"], s["us_slowest"], s["transfer_us"], s["wait_us_mean_rank"]):
                print(f"    {c['kind']} {c['leaves']} leaves {c['bytes']} B ({c['first']}): slowest {slow:.2f} us, "
                      f"transfer {tr:.2f}, wait {w:.2f} (mean rank)")
    print(json.dumps({"gather_split": turns, "ranks": world, "hosts": args.hosts, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
