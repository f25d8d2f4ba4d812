"""Times the kNN kernels' build-time and launch-time choices on a CUDA GPU.

    python3 -m loam_tpu_torch.tune_knn [--out tune_out] [--quick]
        [--variant="-DNAME=VALUE ..."]... [--csrc DIR]

For every variant -- threads a block, queries a thread and tile length
(``-DLOAM_KNN_THREADS/QPT/TILE`` of ``ops/csrc/knn.cu``), and the split
planner's ``TARGET_BLOCKS`` / ``MAX_SPLITS`` (``ops/knn_cuda.py``) -- it
builds the library, checks both entry points against their plain versions
(exactly equal) and times, with CUDA events, the shapes the odometry paths
launch, each twice: the wrapper as the ICF loop calls it (its small PyTorch
operations around the launch included; with a short kernel this is the
host's launch rate, not the device's time) and the launch alone (search and
merge kernels with their output allocations, the ``raw`` figures):

  * ``single``: 4 pairs of 64x1024 scans, the planar search as the ICF
    calls it (packed coordinates, query mask), no seed bound; ``nohit``:
    the same with a radius of 5 cm, which next to no target is within, so
    no list changes: the evaluations alone; ``cold`` / ``warm``: with the
    ICF loop's seed bounds from the kernel's prologue, the rank window at
    the first iteration and the last result at queries moved (0.012,
    -0.005, 0.002) m;
  * ``dual4`` / ``dual1``: the dual search of 4 pairs and of 1 pair
    (scan-to-scan) at scan scale;
  * ``map4`` / ``map15``: the dual search of one frame against the voxel
    maps after 4 and after 15 frames at the default ``ScanToMapConfig``;
    ``mapc``: the single planar search of that frame against the map after
    4 frames with the cold seed, as scan-to-map's prep cache runs it;
  * ``mapfull``: the dual search against maps whose every slot is live
    (nothing to prune); ``mapfull1``: the single planar search there, with
    the cold seed.

``--variant`` (repeatable; write it with ``=``) builds the given ``-D``
flags instead of the sweep, at the planner's defaults; ``--csrc`` builds the kernels from another directory of sources with
the same C interface (an earlier tree's, to time it beside this one in one
process).

Prints one line per variant with the ``ptxas`` figures and one JSON line;
the table also goes to ``<out>/tune_knn.json``. The defaults in the sources
are the variant this script found fastest on an NVIDIA H100.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import loam_tpu_torch as T
from loam_tpu_torch.io import render_trajectory
from loam_tpu_torch.ops import _build, knn_cuda


def _time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _ptxas(log: str, kernel: str = "knn_search_kernelILi5E") -> str:
    """Registers and spill stores of one kernel (default: the k = 5 search)."""
    m = re.search(rf"Function properties for \S*{kernel}\S*\s+(\d+) bytes stack frame, (\d+) bytes "
                  r"spill stores, (\d+) bytes spill loads.*\n.*Used (\d+) registers", log)
    return "not reported" if m is None else (f"{m.group(4)} registers, {m.group(2)} B spill stores, "
                                             f"{m.group(3)} B spill loads")


def _shapes(dev):
    """name -> (wrapper call, plain call, launch alone) at the odometry paths' shapes."""
    lidar = T.LidarParams(64, 1024, 0.5, 120.0)
    fp = T.FeatureExtractionParams(precise_selection=True)
    rp = T.RegistrationParams(search_backend="bruteforce")
    mrp = T.default_map_reg_params()
    scans_np, _ = render_trajectory(lidar, 16, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
                                    noise=0.005, seed=0, dtype=np.float32)
    scans = torch.from_numpy(scans_np).to(dev)
    feats = T.extract_features_batch(scans, lidar, fp, post=T.registration.azimuth_sort_features)
    shapes = {}

    def dual(prep, qe, qp, p):
        args = (prep, qe, qp, p.num_edge_neighbors, p.num_plane_neighbors,
                p.max_edge_neighbor_dist, p.max_plane_neighbor_dist)
        lift = (lambda x: x) if prep.batched else (lambda x: x[None])
        raw = (prep, lift(qe).contiguous(), lift(qp).contiguous(),
               max(p.num_edge_neighbors, p.num_plane_neighbors),
               p.max_edge_neighbor_dist ** 2, p.max_plane_neighbor_dist ** 2)
        return (lambda: sum(knn_cuda.knn_dual_run(*args), ()),
                lambda: sum(knn_cuda.knn_dual_run_reference(*args), ()),
                lambda: knn_cuda._dual_search_kernel(*raw))

    for name, C in (("4", 4), ("1", 1)):
        tgt = feats.map(lambda x: x[:C])
        src = feats.map(lambda x: x[1:C + 1].contiguous())
        if C == 4:
            prep = knn_cuda.knn_prep(tgt.planar_points, tgt.planar_mask)
            args = (prep, src.planar_points, rp.num_plane_neighbors, rp.max_plane_neighbor_dist)
            kw = dict(with_coords=True, query_mask=src.planar_mask)
            raw = (prep, src.planar_points, rp.num_plane_neighbors,
                   rp.max_plane_neighbor_dist ** 2, src.planar_mask)
            shapes["single"] = (lambda: knn_cuda.knn_run(*args, **kw),
                                lambda: knn_cuda.knn_run_reference(*args, **kw),
                                lambda: knn_cuda._search_kernel(*raw))
            cold = dict(seed_window=True)
            shapes["cold"] = (lambda: knn_cuda.knn_run(*args, **kw, **cold),
                              lambda: knn_cuda.knn_run_reference(*args, **kw),
                              lambda: knn_cuda._search_kernel(*raw, window=True))
            prev = knn_cuda.knn_run(*args, **kw, **cold)
            moved = (src.planar_points + torch.tensor([0.012, -0.005, 0.002], device=dev)).contiguous()
            wargs = (prep, moved) + args[2:]
            wraw = (prep, moved) + raw[2:]
            wprev = (prev.xs, prev.ys, prev.zs, prev.mask)
            shapes["warm"] = (lambda: knn_cuda.knn_run(*wargs, **kw, seed_prev=prev, seed_window=True),
                              lambda: knn_cuda.knn_run_reference(*wargs, **kw),
                              lambda: knn_cuda._search_kernel(*wraw, prev=wprev, window=True))
            near = args[:3] + (0.05,)
            raw_near = raw[:3] + (0.05 ** 2,) + raw[4:]
            shapes["nohit"] = (lambda: knn_cuda.knn_run(*near, **kw),
                               lambda: knn_cuda.knn_run_reference(*near, **kw),
                               lambda: knn_cuda._search_kernel(*raw_near))
        d_prep = knn_cuda.knn_dual_prep(tgt.edge_points, tgt.edge_mask,
                                        tgt.planar_points, tgt.planar_mask)
        shapes["dual" + name] = dual(d_prep, src.edge_points, src.planar_points, rp)

    def cached(points, mask, q, qm, p):
        """The single planar search of one frame against a map, cold seed."""
        prep = knn_cuda.knn_prep(points[None], mask[None])
        q, qm = q[None].contiguous(), qm[None].contiguous()
        args = (prep, q, p.num_plane_neighbors, p.max_plane_neighbor_dist)
        kw = dict(with_coords=True, query_mask=qm)
        return (lambda: knn_cuda.knn_run(*args, **kw, seed_window=True),
                lambda: knn_cuda.knn_run_reference(*args, **kw),
                lambda: knn_cuda._search_kernel(prep, q, p.num_plane_neighbors,
                                                p.max_plane_neighbor_dist ** 2, qm, window=True))

    os.environ["LOAM_ICF_DUAL_KNN"] = "1"
    for n_map in (4, 15):
        st, _, _ = T.scan_to_map_offline(scans[:n_map], lidar, fp, mrp)
        f_next = T.registration.spatial_sort_features(T.extract_features(scans[n_map], lidar, fp))
        guess = st.world_T_current.compose(st.prev_delta)
        qe = guess.act(f_next.edge_points).contiguous()
        qp = guess.act(f_next.planar_points).contiguous()
        em, pm = st.edge_map, st.planar_map
        shapes[f"map{n_map}"] = dual(knn_cuda.knn_dual_prep(em.points, em.mask, pm.points, pm.mask),
                                     qe, qp, mrp)
        if n_map == 4:
            shapes["mapc"] = cached(pm.points, pm.mask, qp, f_next.planar_mask, mrp)
    # every slot live: points spread over the room the scans see
    g = torch.Generator(device="cpu").manual_seed(0)
    full = lambda n: ((torch.rand((n, 3), generator=g) - 0.5) * 40.0).to(dev)
    ones = lambda n: torch.ones(n, dtype=torch.bool, device=dev)
    ne, npl = em.points.shape[0], pm.points.shape[0]
    fe, fpl = full(ne), full(npl)
    shapes["mapfull"] = dual(knn_cuda.knn_dual_prep(fe, ones(ne), fpl, ones(npl)), qe, qp, mrp)
    shapes["mapfull1"] = cached(fpl, ones(npl), qp, f_next.planar_mask, mrp)
    return shapes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="tune_out")
    ap.add_argument("--quick", action="store_true", help="the sources' defaults only")
    ap.add_argument("--variant", action="append", default=None,
                    help="-D flags of one build to time instead of the sweep (repeatable; '' = defaults)")
    ap.add_argument("--csrc", default=None, help="build the kernels from this directory of sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_knn: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"gpu: {smi}")
    dev = torch.device("cuda", 0)
    if args.csrc is not None:
        _build.CSRC = Path(args.csrc).resolve()
    shapes = _shapes(dev)
    plain = {}

    variant = lambda threads, qpt, tile=1024: (
        f"-DLOAM_KNN_THREADS={threads}", f"-DLOAM_KNN_QPT={qpt}", f"-DLOAM_KNN_TILE={tile}")
    builds = [tuple(v.split()) for v in args.variant] if args.variant else [()] if args.quick else [
        (), variant(512, 2), variant(256, 2), variant(128, 2), variant(256, 1), variant(128, 4),
        variant(256, 4), variant(512, 2, 512), variant(512, 2, 2048),
    ]
    default_plan = (knn_cuda.TARGET_BLOCKS, knn_cuda.MAX_SPLITS)
    plans = [default_plan] if args.quick or args.variant else list(
        itertools.product((264, 528, 1056, 2112), (8, 16, 32)))
    rows = []
    for flags in builds:
        _build.use_flags(*flags)
        _build.lib()
        res = _build.resource_summary()
        # the planner's constants are swept on the default build only
        for target_blocks, max_splits in plans if flags == () else [default_plan]:
            knn_cuda.TARGET_BLOCKS, knn_cuda.MAX_SPLITS = target_blocks, max_splits
            row = {"flags": list(flags), "csrc": str(_build.CSRC), "target_blocks": target_blocks,
                   "max_splits": max_splits, "nvcc_s": _build.last_build_seconds, "ptxas": res,
                   "ptxas_k5": _ptxas(_build.last_build_log)}
            for name, (kernel, ref, raw) in shapes.items():
                if name not in plain:
                    plain[name] = ref()
                if not _equal(kernel(), plain[name]):
                    raise AssertionError(f"{flags} {target_blocks}/{max_splits}: {name} differs "
                                         "from the plain version")
                row[name] = _time_ms(kernel)
                row[name + "_raw"] = _time_ms(raw)
            rows.append(row)
            print(" ".join(flags) or "(defaults)", f"blocks {target_blocks} splits<={max_splits}:",
                  " ".join(f"{n} {row[n]:.4f}/{row[n + '_raw']:.4f}" for n in shapes),
                  "ms (wrapper/raw);", res, "; k = 5 search:", row["ptxas_k5"], flush=True)
    knn_cuda.TARGET_BLOCKS, knn_cuda.MAX_SPLITS = default_plan
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "tune_knn.json"), "w") as f:
        json.dump({"gpu": smi, "rows": rows}, f, indent=1)
    print(json.dumps({"gpu": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
