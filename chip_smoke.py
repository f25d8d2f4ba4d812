#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU: build, kernel checks, the
odometry drivers.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  0. Require CUDA; print the GPU's name and power limit (``nvidia-smi``),
     and the torch and CUDA versions; turn TF32 off.
  1. Build the five CUDA kernels from ``loam_tpu_torch/ops/csrc`` (one
     ``nvcc`` per source, all at once) and print the build time and what
     ``ptxas`` reports (registers, shared memory, spills).
  2. Run every kernel and its plain PyTorch version on the same inputs at
     the paths' shapes (16 synthetic 64x1024 scans: all 1,024 lines for the
     extraction kernels, one frame's 64 lines, which is what scan-to-scan
     launches, and a streaming chunk's 512; the sector sort also with its
     float32 key and on ties, -0.0, infinities and slices padded to 32 and
     1,024 slots; the first chunk of 4 pairs for
     the kNN; for the dual kNN also
     a voxel map built from the first frames), require equal results, and
     time both with CUDA events, beside the kernel's bound on this GPU (the
     larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s
     float32, from this run's inputs) and, where one PyTorch call computes
     the same function (a stable ``torch.sort``, ``torch.gather``), that
     call's time. Every kernel is timed as its wrapper is called (``ms``) and
     as a launch alone (``launch_ms``: for the extraction kernels a CUDA
     graph of 20 calls replayed, so no Python runs between the launches; for
     the kNN the search and merge kernels without the wrapper's PyTorch
     operations); the extraction wrappers' host microseconds a call are
     printed too, and the greedy NMS's chain floor (the accepts of its
     longest line, one dependent step each). The NMS is also checked on
     lines of 2,048 points. Both kNN entry points are also checked on one
     pair (the targets split across thread blocks), on four pairs with the
     splits switched off, on an empty map, with ``k_edge != k_plane`` and
     with a k above the register lists (the kernel's wide form: 9 and 16,
     dual (9, 12));
     print the A/B of one dual kNN launch against the two single launches it
     replaces. ``--extraction-only`` stops here, after the three extraction
     kernels, and prints their rows.
  3. Drive ``odometry_offline`` on those 16 frames, handed over as the numpy
     array the renderer returns and with no ``device`` (so it runs on the
     GPU), ``chunk_pairs=4``, ``motion_init=True`` (single kNN) with every
     launch counter reset first; require each kernel to have launched,
     finite poses of the right shape and the benchmark's ATE gate; time 3
     runs after a warm-up.
  4. Check agreement with the plain versions on a small input: the offline,
     scan-to-map (brute force and grid), scan-to-scan and streaming drivers
     on 6 frames of 16x360 scans on the GPU and on the CPU;
     ``optimize_trajectory_with_closures`` on a closed loop of 17 keyframes
     of 16x360 (candidates and accepted closures equal, poses within 1e-2 m);
     ``optimize_pose_graph`` in float64 on a 60-node graph (poses within
     1e-8); a float64 ``register_features`` (the plain kNN on the card, within
     1e-9 m) and a k = 9 search (the kernel's wide form, equal to the plain
     one).
  5. ``odometry_offline`` with ``LOAM_ICF_DUAL_KNN=1``: the dual kNN instead
     of the single one, the same terminations and iteration counts as phase
     3, poses within 1e-5 m of it, the ATE gate; scans/s beside phase 3's.
  6. ``scan_to_map_offline`` on the 16 frames with the default
     ``ScanToMapConfig`` and ``default_map_reg_params()``, dual kNN: every
     extraction kernel and the dual kNN launched, no single kNN; the ATE
     gate; no voxel dropped; map sizes and scans/s over 3 runs.
  7. A ``scan_to_scan_step(dewarp=True)`` loop over the 16 frames, dual kNN:
     the same checks as 6, and scans/s.
  8. ``scan_to_map_offline`` with ``RegistrationParams(search_backend="grid",
     prior_weight=300)``: the voxel-grid search instead of the kNN kernel. The
     ATE gate, no voxel dropped, the grid's overflow count (required 0 at the
     default ``grid_max_per_cell``, where the grid is exact), terminations
     equal to phase 6's and poses within 1e-5 m of it, no kNN kernel
     launched, every extraction kernel launched; scans/s.
  9. ``odometry_streaming`` on the 16 frames handed over as numpy, in chunks
     of 8, packed and unpacked, and ``StreamingOdometry`` pushed frame by
     frame (single kNN): the same poses from both entry points, the unpacked
     trajectory within 1e-2 m of phase 3's (the same math; the motion prior
     is constant over a chunk of 8 frames here and of 4 pairs there), the ATE
     gate for both, each extraction kernel launched once a chunk and the kNN
     kernel launched; scans/s.
 10. The loop-closed path at full width: 33 keyframes of 64x1024 around a
     closed square (``io.square_loop_scans``) written as KITTI
     ``.bin`` files, ``odometry_streaming`` over the paths through the native
     loader (packed, chunks of 8), the keyframes' features by
     ``extract_features_batch``, ``optimize_trajectory_with_closures`` (8
     candidates, 10 iterations). Requires the native loader, the start/end
     revisit among the accepted closures, the end gap shrinking, the
     optimized trajectory's ATE no worse than the odometry's and under the
     gate, and every extraction kernel and the single kNN launched by both
     counted runs. Holds the kernels against their plain versions at this
     path's shapes: the extraction kernels on the keyframes' 2,112 lines and
     the single kNN on the candidate pairs that ``verify_closures``
     registers, with their query masks, at the first ICF iteration and at
     the verified poses (rows ``*_loop``). Prints scans/s of the file-fed
     run, ms per ``verify_closures`` call and per pose-graph solve.
 11. ``optimize_pose_graph`` at drive scale: a chain of 1,000 nodes plus 50
     closures, noise-free measurements, a perturbed start (H is 6,000 x
     6,000), in float64 and float32 on the card. Requires the float64 solve
     to recover the true poses within 1e-5 m and both costs to fall; prints
     ms per solve and the peak device memory.

``LOAM_ICF_DUAL_KNN`` is set and restored around the phases that use it.
It prints a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ATOL_SMALL_M = 1e-2  # GPU-vs-CPU trajectory agreement (the ICF position convergence threshold)
# dual vs single kNN in the ICF loop: bit-equal neighbours, only the
# gathered and the packed line/plane fits round differently
ATOL_DUAL_M = 1e-5
# grid vs brute-force search in scan-to-map: the grid is exact at overflow 0
# and both feed the gathered fits; only equidistant neighbours may come in
# another order (the grid visits cells, the kernel target indices)
ATOL_GRID_M = 1e-5
# streaming (chunks of 8 frames) vs offline (chunks of 4 pairs): the same
# registrations from other constant-velocity priors, each converged to the
# ICF's position threshold
ATOL_STREAM_M = 1e-2
# float64 on the card vs the CPU: the same plain kNN and solver, summed in
# other orders
ATOL_F64_M = 1e-9
# the float64 pose graph, card vs CPU: index_put_(accumulate=True) adds into
# H in no fixed order on the card
ATOL_GRAPH = 1e-8
# the float64 pose-graph solve of noise-free edges vs the truth (the
# tolerance of tests/test_pose_graph.py::test_recovers_exact_graph)
ATOL_GRAPH_TRUTH_M = 1e-5


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PEAK_BYTES_S = 3.35e12  # H100 SXM device memory (published)
PEAK_FP32_S = 67e12  # H100 SXM float32 outside the tensor cores (published)


def _bound(nbytes: float, operations: float) -> dict:
    """The least time this GPU could take: each input read once and each
    output written once at the memory rate, or the operations at the
    float32 rate, whichever is larger."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_S * 1e3, operations / PEAK_FP32_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _knn_operations(classes) -> int:
    """8 float32 operations (3 subtractions, 3 products, 2 additions) for
    every distance this run's data needs: each searching query against each
    valid target of its pair. ``classes``: (target mask (B, M), queries per
    pair or a (B, Q) query mask)."""
    total = 0
    for tmask, q in classes:
        nq = q.sum(-1) if hasattr(q, "sum") else q
        total += int((tmask.sum(-1) * nq).sum().item())
    return 8 * total


@contextlib.contextmanager
def _unsplit(knn_cuda):
    """Keep every class's targets in one range for the block."""
    old = knn_cuda.MAX_SPLITS
    knn_cuda.MAX_SPLITS = 1
    try:
        yield
    finally:
        knn_cuda.MAX_SPLITS = old


def _max_err(a, b) -> float:
    import torch

    return float(torch.max(torch.abs(a.double() - b.double())).item()) if a.numel() else 0.0


def _require_equal(name, a, b):
    import torch

    if a.shape != b.shape or not torch.equal(a, b):
        bad = int((a != b).sum().item()) if a.shape == b.shape else -1
        raise AssertionError(f"{name}: kernel differs from the plain version ({bad} entries)")


@contextlib.contextmanager
def _dual_knn(on: bool):
    """Set ``LOAM_ICF_DUAL_KNN`` for the block and restore it after."""
    old = os.environ.get("LOAM_ICF_DUAL_KNN")
    os.environ["LOAM_ICF_DUAL_KNN"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["LOAM_ICF_DUAL_KNN"]
        else:
            os.environ["LOAM_ICF_DUAL_KNN"] = old


def _check_single_knn(what, knn_cuda, prep, q, k, r, qm):
    """The single kernel against its plain version in both output forms,
    all exactly equal. Returns the max abs error of the valid distances."""
    import torch

    a = knn_cuda.knn_run(prep, q, k, r, with_coords=True, query_mask=qm)
    b = knn_cuda.knn_run_reference(prep, q, k, r, with_coords=True, query_mask=qm)
    torch.cuda.synchronize()
    _require_equal(f"{what} mask", a.mask, b.mask)
    m = b.mask
    _require_equal(f"{what} first_idx", a.first_idx[m[..., 0, :]], b.first_idx[m[..., 0, :]])
    for ax in ("xs", "ys", "zs"):
        _require_equal(f"{what} {ax}", getattr(a, ax)[m], getattr(b, ax)[m])
    ra = knn_cuda.knn_run(prep, q, k, r, query_mask=qm)
    rb = knn_cuda.knn_run_reference(prep, q, k, r, query_mask=qm)
    torch.cuda.synchronize()
    _require_equal(f"{what} result mask", ra.mask, rb.mask)
    _require_equal(f"{what} indices", ra.indices[rb.mask], rb.indices[rb.mask])
    _require_equal(f"{what} distances", ra.distances, rb.distances)
    return _max_err(ra.distances[rb.mask], rb.distances[rb.mask])


def _knn_row(name, knn_cuda, prep, q, k, r, qm, tmask, err, shape) -> dict:
    """The single kNN's entry: the wrapper call by call (``ms``), the search
    and merge kernels without the wrapper's PyTorch operations
    (``launch_ms``), the wrapper's host microseconds a call and the plain
    version, beside the bound from this run's targets and searching
    queries."""
    run = lambda: knn_cuda.knn_run(prep, q, k, r, with_coords=True, query_mask=qm)
    out = run()
    return dict(
        name=name, counter="knn", route="cuda", source="loam_tpu_torch/ops/csrc/knn.cu",
        replaces="loam_tpu/ops/knn_pallas.py:134", shape=shape, max_abs_err=err,
        ms=_time_ms(run, 10), launch_ms=_time_ms(lambda: knn_cuda._search_kernel(prep, q, k, r * r, qm), 10),
        host_us=_host_us(run, 50),
        plain_ms=_time_ms(lambda: knn_cuda.knn_run_reference(prep, q, k, r, with_coords=True, query_mask=qm), 2),
        library_ms=None,  # cdist + topk is two calls and another arithmetic
        # index, d2 and three coordinate planes out
        **_bound(_nbytes(prep.tT, prep.n_live, q, qm) + 5 * _nbytes(out.xs), _knn_operations([(tmask, qm)])))


def _seconds_per_run(run, reps: int) -> float:
    """Host seconds per call over ``reps`` calls, ended by a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def _check_trajectory(what, translation, rotation, frames, gt, ate_rmse):
    """Finite poses of the right shape and the benchmark's ATE gate
    (``bench.py::_check_accuracy``): ATE < max(5% of the path, 0.05 m)."""
    tr = translation.cpu().numpy()
    if tr.shape != (frames, 3) or tuple(rotation.shape) != (frames, 4):
        raise AssertionError(f"{what}: trajectory shape {tr.shape} / {tuple(rotation.shape)}")
    if not (np.isfinite(tr).all() and np.isfinite(rotation.cpu().numpy()).all()):
        raise AssertionError(f"{what}: non-finite trajectory")
    ate = ate_rmse(tr, gt, align=False)
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    limit = max(0.05 * path, 0.05)
    if not ate < limit:
        raise AssertionError(f"{what}: ATE {ate} m exceeds {limit} m")
    return ate, limit, path


def _check_dual_knn(what, knn_cuda, prep, qe, qp, e_prep, p_prep, k_e, k_p, r_e, r_p):
    """The dual kernel against its plain version and against two launches
    of the single kernel, all exactly equal. Returns the max abs error of
    the valid distances against the plain version."""
    import torch

    a = knn_cuda.knn_dual_run(prep, qe, qp, k_e, k_p, r_e, r_p)
    b = knn_cuda.knn_dual_run_reference(prep, qe, qp, k_e, k_p, r_e, r_p)
    singles = (knn_cuda.knn_run(e_prep, qe, k_e, r_e), knn_cuda.knn_run(p_prep, qp, k_p, r_p))
    torch.cuda.synchronize()
    err = 0.0
    for cls, ra, rb, rs in zip(("edge", "planar"), a, b, singles):
        _require_equal(f"{what} {cls} mask", ra.mask, rb.mask)
        _require_equal(f"{what} {cls} indices", ra.indices, rb.indices)
        _require_equal(f"{what} {cls} distances", ra.distances, rb.distances)
        _require_equal(f"{what} {cls} mask vs single", ra.mask, rs.mask)
        _require_equal(f"{what} {cls} indices vs single", ra.indices,
                       torch.where(rs.mask, rs.indices, 0))
        _require_equal(f"{what} {cls} distances vs single", ra.distances, rs.distances)
        err = max(err, _max_err(ra.distances[rb.mask], rb.distances[rb.mask]))
    return err


def _graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device ms per call of ``fn`` with no Python between the launches:
    ``launches`` calls are captured into one CUDA graph (their allocations
    come from the graph's pool, their kernels go to the capturing stream)
    and the graph is replayed ``replays`` times between two CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return _time_ms(graph.replay, replays) / launches


def _host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call: the caller's clock over ``calls`` calls
    with no synchronisation inside, i.e. what enqueueing one costs."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


# The greedy pick's own floor: its accepts are a dependent chain (find the
# next live candidate, suppress around it, find the next), one after another
# within a line, whatever the card's width. A step is a warp reduction, a
# compare and a select, each waiting for the one before: ~60 cycles (an
# estimate from those instructions' latencies, not a measurement) at the
# H100 SXM's 1.98 GHz boost clock.
NMS_STEP_CYCLES = 60
BOOST_HZ = 1.98e9


def _kernel_row(name, suffix, source, replaces, shape, err, kernel, plain, plain_reps, library, bound,
                **extra) -> dict:
    """One extraction kernel's entry: timed three ways -- the wrapper call by
    call (``ms``: with a kernel of a few microseconds this is the host's call
    rate), the launch alone from a CUDA graph (``launch_ms``: the device's
    time) and the wrapper's host microseconds a call -- beside the bound, the
    plain version and the one PyTorch call for the same function (call by
    call and from a graph too)."""
    return dict(
        name=name + suffix, counter=name, route="cuda",
        source=f"loam_tpu_torch/ops/csrc/{source}", replaces=replaces, shape=shape,
        max_abs_err=err, ms=_time_ms(kernel, 50), launch_ms=_graph_ms(kernel),
        host_us=_host_us(kernel), plain_ms=_time_ms(plain, plain_reps),
        library_ms=None if library is None else _time_ms(library, 20),
        library_launch_ms=None if library is None else _graph_ms(library),
        **bound, **extra)


def _sector_sort_row(curv, S: int, suffix: str):
    """``sector_sort`` on the (lines, P) curvature against its plain version
    (positions and keys exactly equal), timed. Returns (row, sorted keys,
    sorted positions)."""
    import torch

    from loam_tpu_torch.ops import bitonic_cuda

    sort_keys = bitonic_cuda.to_sectors(curv, S, float("inf")).contiguous()
    sc_k, sp_k = bitonic_cuda.sector_sort(curv, S)
    sc_r, sp_r = bitonic_cuda.sector_sort_reference(curv, S)
    torch.cuda.synchronize()
    _require_equal(f"sector_sort{suffix} positions", sp_k, sp_r)
    _require_equal(f"sector_sort{suffix} keys", sc_k, sc_r)
    kind = "f64" if curv.dtype == torch.float64 else "f32"
    row = _kernel_row(
        "sector_sort", suffix, "sector_sort.cu", "loam_tpu/ops/bitonic.py:197",
        f"curv {kind} ({curv.shape[0]}, {curv.shape[1]}), S={S}",
        max(_max_err(sp_k, sp_r), _max_err(sc_k, sc_r)),
        lambda: bitonic_cuda.sector_sort(curv, S),
        lambda: bitonic_cuda.sector_sort_reference(curv, S), 5,
        # the same slices, already cut, through one stable torch.sort
        lambda: torch.sort(sort_keys, dim=-1, stable=True),
        # n log2 n comparisons per slice, far below the bytes
        _bound(_nbytes(curv, sc_k, sp_k), sp_k.numel() * np.log2(sp_k.shape[-1])))
    return row, sc_k, sp_k


def _check_sort_cases(dev):
    """``sector_sort`` where its key mapping and its slice widths could go
    wrong: ties, -0.0 beside +0.0, +inf and -inf in real slots, NaNs of
    either sign (behind +inf and behind the padding, by position), slices
    padded to 32 and to 1,024 slots, both key types. Positions equal to the
    plain version's and keys equal bit for bit."""
    import torch

    from loam_tpu_torch.ops import bitonic_cuda

    g = torch.Generator().manual_seed(0)
    pool = torch.tensor([-0.0, 0.0, -1.5, 1.5, float("inf"), float("-inf"), 0.25, -0.0,
                         float("nan"), -float("nan")], dtype=torch.float64)
    n = 0
    for lines, P, S in ((7, 50, 3), (5, 64, 2), (3, 1000, 1), (64, 1024, 6)):  # 32, 32, 1,024, 256 slots
        draw = pool[torch.randint(0, len(pool), (lines, P), generator=g)]
        for dtype, as_bits in ((torch.float64, torch.int64), (torch.float32, torch.int32)):
            c = draw.to(dev, dtype)
            (ka, pa), (kb, pb) = bitonic_cuda.sector_sort(c, S), bitonic_cuda.sector_sort_reference(c, S)
            torch.cuda.synchronize()
            _require_equal(f"sector_sort ({lines}, {P}) S={S} {dtype} positions", pa, pb)
            _require_equal(f"sector_sort ({lines}, {P}) S={S} {dtype} key bits",
                           ka.view(as_bits), kb.view(as_bits))
            n += 1
    print(f"sector_sort on ties, -0.0, +inf, -inf and NaNs of either sign in real slots, slices padded to 32, 256 and "
          f"1,024 slots, f64 and f32: {n} inputs equal to the plain version bit for bit")


def _extraction_kernels(scans, lidar, fp, suffix: str) -> list:
    """The three extraction kernels on all lines of ``scans`` (F, L, P, 3):
    each against its plain version (exactly equal), then timed
    (:func:`_kernel_row`)."""
    import torch

    from loam_tpu_torch.features.curvature import compute_curvature, compute_valid_points
    from loam_tpu_torch.ops import assemble_cuda, nms_cuda

    L, P, S = lidar.scan_lines, lidar.points_per_line, fp.number_sectors
    n_lines = scans.shape[0] * L
    rows = []

    def row(name, *args, **extra):
        rows.append(_kernel_row(name, suffix, *args, **extra))

    curv = compute_curvature(scans, lidar, fp).reshape(n_lines, P).contiguous()
    valid = compute_valid_points(scans, lidar, fp).reshape(n_lines, P).contiguous()
    sort_row, sc_k, sp_k = _sector_sort_row(curv, S, suffix)
    rows.append(sort_row)

    real = sc_k < float("inf")
    neg = torch.full_like(sp_k, -1)
    cand_e = torch.where(real & (sc_k > fp.edge_feat_threshold), sp_k, neg).flip(-1).contiguous()
    cand_p = torch.where(real & (sc_k < fp.planar_feat_threshold), sp_k, neg).contiguous()
    me, mp, n = fp.max_edge_feats_per_sector, fp.max_planar_feats_per_sector, fp.neighbor_points
    pe_k, pp_k = nms_cuda.greedy_nms(valid, cand_e, cand_p, me, mp, n)
    pe_r, pp_r = nms_cuda.greedy_nms_reference(valid, cand_e, cand_p, me, mp, n)
    torch.cuda.synchronize()
    _require_equal(f"greedy_nms{suffix} edges", pe_k, pe_r)
    _require_equal(f"greedy_nms{suffix} planars", pp_k, pp_r)
    accepts = (pe_r >= 0).sum((1, 2)) + (pp_r >= 0).sum((1, 2))  # per line
    row("greedy_nms", "greedy_nms.cu", "loam_tpu/ops/nms_pallas.py:85",
        f"valid ({n_lines}, {P}), candidates ({n_lines}, {S}, {cand_e.shape[2]}) x2",
        max(_max_err(pe_k, pe_r), _max_err(pp_k, pp_r)),
        lambda: nms_cuda.greedy_nms(valid, cand_e, cand_p, me, mp, n),
        lambda: nms_cuda.greedy_nms_reference(valid, cand_e, cand_p, me, mp, n), 1,
        None,  # no PyTorch call picks greedily with suppression
        # one visit per candidate slot
        _bound(_nbytes(valid, cand_e, cand_p, pe_k, pp_k), cand_e.numel() + cand_p.numel()),
        accepts_mean=float(accepts.float().mean().item()), accepts_max=int(accepts.max().item()),
        # the line with the most accepts ends last
        chain_floor_ms=int(accepts.max().item()) * NMS_STEP_CYCLES / BOOST_HZ * 1e3)

    picks = torch.cat([pe_k.reshape(n_lines, -1), pp_k.reshape(n_lines, -1)], dim=1).contiguous()
    pts = scans.reshape(n_lines, P, 3).contiguous()
    gather_idx = picks.clamp(min=0).long()[..., None].expand(-1, -1, 3).contiguous()
    sel_k = assemble_cuda.select_points(pts, picks)
    sel_r = assemble_cuda.select_points_reference(pts, picks)
    torch.cuda.synchronize()
    _require_equal(f"select_points{suffix}", sel_k, sel_r)
    row("select_points", "select_points.cu", "loam_tpu/ops/assemble_pallas.py:37",
        f"pts ({n_lines}, {P}, 3) f32, picks ({n_lines}, {picks.shape[1]})", _max_err(sel_k, sel_r),
        lambda: assemble_cuda.select_points(pts, picks),
        lambda: assemble_cuda.select_points_reference(pts, picks), 20,
        lambda: torch.gather(pts, 1, gather_idx),
        # the picks, the picked points and the output: what this run's picks need
        _bound(_nbytes(picks, sel_k) + int((picks >= 0).sum().item()) * 3 * pts.element_size(), 0))
    return rows


def _check_wide_nms(dev):
    """``greedy_nms`` on lines of 2,048 points (two mask words a lane in the
    kernel) against the plain version."""
    import torch

    from loam_tpu_torch.ops import nms_cuda

    N, P, S = 64, 2048, 6
    s_max = P - (S - 1) * (P // S)
    g = torch.Generator().manual_seed(0)
    valid = (torch.rand((N, P), generator=g) > 0.2).to(dev)
    # every point of a sector a candidate, in a random order, in both lists
    base = (torch.arange(S) * (P // S))[None, :, None]
    order = lambda: (torch.rand((N, S, s_max), generator=g).argsort(-1) + base).clamp(max=P - 1)
    cand_e, cand_p = (order().to(torch.int32).to(dev).contiguous() for _ in range(2))
    got = nms_cuda.greedy_nms(valid, cand_e, cand_p, 10, 50, 3)
    want = nms_cuda.greedy_nms_reference(valid, cand_e, cand_p, 10, 50, 3)
    torch.cuda.synchronize()
    for what, a, b in zip(("edges", "planars"), got, want):
        _require_equal(f"greedy_nms P={P} {what}", a, b)
    ms = _graph_ms(lambda: nms_cuda.greedy_nms(valid, cand_e, cand_p, 10, 50, 3))
    print(f"greedy_nms at P={P} ({N} lines, {S} sectors of {s_max}): equal to the plain version, "
          f"launch alone {ms:.4f} ms")


def _to(tree, dev, dtype=None):
    """Every tensor of a nest of NamedTuples on ``dev`` (floats in ``dtype``)."""
    if isinstance(tree, tuple):
        return type(tree)(*(_to(x, dev, dtype) for x in tree))
    return tree.to(dev, dtype if dtype is not None and tree.is_floating_point() else tree.dtype)


def _print_kernels(kernels):
    """One line a kernel: its times beside its bound."""
    for kd in kernels:
        lib_ms = "none" if kd["library_ms"] is None else f"{kd['library_ms']:.4f} ms"
        line = (f"kernel {kd['name']}: {kd['ms']:.4f} ms (launch alone {kd['launch_ms']:.4f} ms, plain "
                f"{kd['plain_ms']:.4f} ms, one PyTorch call {lib_ms}")
        if kd.get("library_launch_ms") is not None:
            line += f" and {kd['library_launch_ms']:.4f} ms alone"
        line += (f", bound {kd['bound_ms']:.6f} ms by {kd['bound_by']}, share of bound "
                 f"{kd['bound_ms'] / kd['launch_ms']:.4f})")
        if "host_us" in kd:
            line += f", wrapper {kd['host_us']:.2f} us of host time a call"
        if "chain_floor_ms" in kd:
            line += (f", chain floor {kd['chain_floor_ms']:.6f} ms ({kd['accepts_max']} accepts in the "
                     f"longest line, {kd['accepts_mean']:.1f} a line on average)")
        print(line + f", max_abs_err {kd['max_abs_err']} at {kd['shape']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    extraction_only = sys.argv[1:] == ["--extraction-only"]
    if sys.argv[1:] and not extraction_only:
        print("usage: chip_smoke.py [--extraction-only]", file=sys.stderr)
        return 2

    import loam_tpu_torch as T
    from loam_tpu_torch.evaluation import ate_rmse
    from loam_tpu_torch.features.curvature import compute_curvature
    from loam_tpu_torch.io import render_trajectory
    from loam_tpu_torch.ops import _build, assemble_cuda, bitonic_cuda, knn_cuda, nms_cuda

    smi = _smi()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.last_build_seconds:.2f} s) -> "
          f"{_build.library_path().name}; {_build.resource_summary()}")

    for fn, stack, spill, regs in re.findall(
            r"Function properties for (\S*sector_sort\S*)\s+(\d+) bytes stack frame, (\d+) bytes spill "
            r"stores.*\n.*Used (\d+) registers", _build.last_build_log):
        slots = re.search(r"I([df])Li(\d+)E", fn)
        what = f"<{'f64' if slots.group(1) == 'd' else 'f32'}, {slots.group(2)} slots a lane>" if slots else fn
        print(f"ptxas sector_sort_kernel{what}: {regs} registers, {stack} B stack, {spill} B spill stores")

    # ---- 2. kernels vs plain versions at the main path's shapes -------------
    lidar = T.LidarParams(64, 1024, 0.5, 120.0)
    fp = T.FeatureExtractionParams(precise_selection=True)
    rp = T.RegistrationParams(search_backend="bruteforce")
    frames = 16
    scans_np, poses = render_trajectory(
        lidar, frames, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
        noise=0.005, seed=0, dtype=np.float32,
    )
    scans = torch.from_numpy(scans_np).to(dev)
    kernels = _extraction_kernels(scans, lidar, fp, "")
    # ... and at one frame's shape, what scan-to-scan launches once a frame
    kernels += _extraction_kernels(scans[:1], lidar, fp, "_frame")
    # ... at a streaming chunk's shape (8 frames), and the sort with the
    # float32 key (precise_selection=False) on all 16 frames' lines
    kernels += _extraction_kernels(scans[:8], lidar, fp, "_chunk")
    fp32 = T.FeatureExtractionParams(precise_selection=False)
    curv32 = compute_curvature(scans, lidar, fp32).reshape(-1, lidar.points_per_line).contiguous()
    if curv32.dtype != torch.float32:
        raise AssertionError(f"precise_selection=False gave {curv32.dtype} curvature")
    kernels.append(_sector_sort_row(curv32, fp32.number_sectors, "_f32")[0])
    if extraction_only:
        # the times first: a kernel that fails a corner case below (an earlier
        # tree's, built here for comparison) has still shown them
        _print_kernels(kernels)
        print(json.dumps({"extraction_kernels": kernels}))
    _check_sort_cases(dev)
    _check_wide_nms(dev)
    if extraction_only:
        print(smi)
        return 0

    # kNN: the first chunk's 4 pairs at the first ICF iteration (identity
    # start), both classes, from the port's own extraction
    feats = T.extract_features_batch(scans, lidar, fp, post=T.registration.azimuth_sort_features)
    C = 4
    bq = _build.lib().loam_knn_block_queries()
    knn_err = 0.0
    for cls, k, r in (("planar", rp.num_plane_neighbors, rp.max_plane_neighbor_dist),
                      ("edge", rp.num_edge_neighbors, rp.max_edge_neighbor_dist)):
        tgt_pts = getattr(feats, f"{cls}_points")[:C]
        tgt_mask = getattr(feats, f"{cls}_mask")[:C]
        q = getattr(feats, f"{cls}_points")[1:C + 1].contiguous()
        qm = getattr(feats, f"{cls}_mask")[1:C + 1].contiguous()
        prep = knn_cuda.knn_prep(tgt_pts, tgt_mask)
        knn_err = max(knn_err, _check_single_knn(f"knn {cls}", knn_cuda, prep, q, k, r, qm))
        # one pair: the targets are split across thread blocks; four pairs
        # with the splits switched off: every block searches all live targets
        prep1 = knn_cuda.knn_prep(tgt_pts[:1], tgt_mask[:1])
        knn_err = max(knn_err, _check_single_knn(f"knn {cls} B=1", knn_cuda, prep1, q[:1], k, r, qm[:1]))
        with _unsplit(knn_cuda):
            knn_err = max(knn_err, _check_single_knn(f"knn {cls} unsplit", knn_cuda, prep, q, k, r, qm))
        if cls == "planar":
            Qp = q.shape[1]
            plan4, plan1 = (knn_cuda.split_plan(b, ((Qp, Qp),), bq)[0] for b in (C, 1))
            if plan1 <= 1:
                raise AssertionError("knn: one pair at scan scale did not take the split path")
            knn_shape = (f"B={C}, Q=M={Qp} planar (and {feats.edge_points.shape[1]} edge), k={k}, "
                         f"n_live {prep.n_live.tolist()}, {int(qm.sum())} searching queries")
            knn_row = _knn_row("knn", knn_cuda, prep, q, k, r, qm, tgt_mask, 0.0, knn_shape)
            knn_b1_ms = _time_ms(lambda: knn_cuda.knn_run(prep1, q[:1], k, r, with_coords=True,
                                                          query_mask=qm[:1]), 10)
            with _unsplit(knn_cuda):
                knn_unsplit_ms = _time_ms(lambda: knn_cuda.knn_run(prep, q, k, r, with_coords=True,
                                                                   query_mask=qm), 10)
            print(f"knn planar: {knn_row['ms']:.4f} ms at B={C} in {plan4} target splits (launch alone "
                  f"{knn_row['launch_ms']:.4f} ms), {knn_unsplit_ms:.4f} ms unsplit; {knn_b1_ms:.4f} ms at "
                  f"B=1 in {plan1} splits")
            # k above the register lists (the Pallas kernel takes any k): the
            # kernel's wide form, one thread a query, at the same chunk
            for k_wide in (9, 16):
                knn_err = max(knn_err, _check_single_knn(f"knn planar k={k_wide}", knn_cuda, prep, q,
                                                         k_wide, r, qm))
            wide_ms = _time_ms(lambda: knn_cuda._search_kernel(prep, q, 16, r * r, qm), 3)
    if knn_err != 0.0:
        raise AssertionError(f"knn distances differ from the plain version by {knn_err}")
    knn_row["max_abs_err"] = knn_err
    kernels.append(knn_row)
    # dual kNN, scan scale: the same chunk, both classes in one launch; no
    # query mask (as knn_dual_run), so every source slot searches
    k_e, k_p = rp.num_edge_neighbors, rp.num_plane_neighbors
    r_e, r_p = rp.max_edge_neighbor_dist, rp.max_plane_neighbor_dist
    tgt = feats.map(lambda x: x[:C])
    src = feats.map(lambda x: x[1:C + 1].contiguous())
    d_prep = knn_cuda.knn_dual_prep(tgt.edge_points, tgt.edge_mask, tgt.planar_points, tgt.planar_mask)
    e_prep = knn_cuda.knn_prep(tgt.edge_points, tgt.edge_mask)
    p_prep = knn_cuda.knn_prep(tgt.planar_points, tgt.planar_mask)
    qe, qp = src.edge_points, src.planar_points
    dual_err = _check_dual_knn("knn_dual scan scale", knn_cuda, d_prep, qe, qp, e_prep, p_prep,
                               k_e, k_p, r_e, r_p)
    # ... on one pair (scan-to-scan's launch: split targets), and on four
    # with the splits switched off
    tgt1 = tgt.map(lambda x: x[:1])
    d_prep1 = knn_cuda.knn_dual_prep(tgt1.edge_points, tgt1.edge_mask, tgt1.planar_points, tgt1.planar_mask)
    dual_err = max(dual_err, _check_dual_knn(
        "knn_dual scan scale B=1", knn_cuda, d_prep1, qe[:1], qp[:1],
        knn_cuda.knn_prep(tgt1.edge_points, tgt1.edge_mask),
        knn_cuda.knn_prep(tgt1.planar_points, tgt1.planar_mask), k_e, k_p, r_e, r_p))
    with _unsplit(knn_cuda):
        dual_err = max(dual_err, _check_dual_knn("knn_dual scan scale unsplit", knn_cuda, d_prep, qe, qp,
                                                 e_prep, p_prep, k_e, k_p, r_e, r_p))
    dual_err = max(dual_err, _check_dual_knn("knn_dual scan scale k=(9,12)", knn_cuda, d_prep, qe, qp,
                                             e_prep, p_prep, 9, 12, r_e, r_p))
    print(f"knn wide form (k above {knn_cuda.REGISTER_MAX_K}): single k = 9 and 16, dual k = (9, 12) at "
          f"the chunk's shapes equal to the plain version; single k = 16 planar launch alone "
          f"{wide_ms:.4f} ms")
    sizes = ((qe.shape[1], tgt.edge_points.shape[1]), (qp.shape[1], tgt.planar_points.shape[1]))
    plan4, plan1 = knn_cuda.split_plan(C, sizes, bq), knn_cuda.split_plan(1, sizes, bq)
    if max(plan1) <= 1:
        raise AssertionError("knn_dual: one pair at scan scale did not take the split path")
    run_dual = lambda: knn_cuda.knn_dual_run(d_prep, qe, qp, k_e, k_p, r_e, r_p)
    dual_scan_ms = _time_ms(run_dual, 10)
    k_max = max(k_e, k_p)
    dual_scan_launch_ms = _time_ms(
        lambda: knn_cuda._dual_search_kernel(d_prep, qe, qp, k_max, r_e * r_e, r_p * r_p), 10)
    dual_scan_host_us = _host_us(run_dual, 50)
    dual_scan_plain_ms = _time_ms(
        lambda: knn_cuda.knn_dual_run_reference(d_prep, qe, qp, k_e, k_p, r_e, r_p), 2)
    two_ms = _time_ms(lambda: (knn_cuda.knn_run(e_prep, qe, k_e, r_e),
                               knn_cuda.knn_run(p_prep, qp, k_p, r_p)), 10)
    two_icf_ms = _time_ms(lambda: (
        knn_cuda.knn_run(e_prep, qe, k_e, r_e, with_coords=True, query_mask=src.edge_mask),
        knn_cuda.knn_run(p_prep, qp, k_p, r_p, with_coords=True, query_mask=src.planar_mask)), 10)
    dual_scan_ms_2 = _time_ms(run_dual, 10)
    dual_b1_ms = _time_ms(lambda: knn_cuda.knn_dual_run(d_prep1, qe[:1], qp[:1], k_e, k_p, r_e, r_p), 10)
    with _unsplit(knn_cuda):
        dual_unsplit_ms = _time_ms(run_dual, 10)
    print(f"knn A/B, scan scale (B={C}, {qe.shape[1]} edge + {qp.shape[1]} planar queries per pair): "
          f"one dual launch {dual_scan_ms:.4f} / {dual_scan_ms_2:.4f} ms in {plan4} (edge, planar) target "
          f"splits (launch alone {dual_scan_launch_ms:.4f} ms), {dual_unsplit_ms:.4f} ms unsplit; "
          f"two single launches "
          f"{two_ms:.4f} ms unmasked, {two_icf_ms:.4f} ms as the ICF calls them (packed, masked "
          f"queries skipped); dual plain version {dual_scan_plain_ms:.4f} ms; one pair "
          f"{dual_b1_ms:.4f} ms in {plan1} splits")
    scan_shape = (f"B={C}, {qe.shape[1]} edge + {qp.shape[1]} planar queries vs the same per pair, "
                  f"k={k_p}, n_live (edge, planar) {d_prep.n_live.tolist()}")

    def dual_bound(prep, e_mask, p_mask, q_e, q_p, k):
        """Targets, bounds and queries in; index and d2 planes of both classes out."""
        lift = lambda m: m if m.ndim == 2 else m[None]
        n_q = (q_e.numel() + q_p.numel()) // 3
        return _bound(_nbytes(prep.tT, prep.n_live, q_e, q_p) + 2 * 4 * k * n_q,
                      _knn_operations([(lift(e_mask), q_e.shape[-2]), (lift(p_mask), q_p.shape[-2])]))

    kernels.append(dict(
        name="knn_dual_scan", counter="knn_dual", route="cuda", source="loam_tpu_torch/ops/csrc/knn.cu",
        replaces="loam_tpu/ops/knn_pallas.py:946", shape=scan_shape,
        max_abs_err=dual_err, ms=dual_scan_ms, launch_ms=dual_scan_launch_ms,
        host_us=dual_scan_host_us, plain_ms=dual_scan_plain_ms, library_ms=None,
        **dual_bound(d_prep, tgt.edge_mask, tgt.planar_mask, qe, qp, max(k_e, k_p)),
    ))

    # dual kNN, map scale: the voxel maps after the first frames at the
    # default ScanToMapConfig, searched by the next frame's features at the
    # constant-velocity prediction
    s2m_cfg = T.ScanToMapConfig()
    s2m_reg = T.default_map_reg_params()
    n_map = 4
    with _dual_knn(True):
        st, _, _ = T.scan_to_map_offline(scans[:n_map], lidar, fp, s2m_reg, s2m_cfg)
    f_next = T.registration.spatial_sort_features(T.extract_features(scans[n_map], lidar, fp))
    guess = st.world_T_current.compose(st.prev_delta)
    mqe, mqp = guess.act(f_next.edge_points).contiguous(), guess.act(f_next.planar_points).contiguous()
    em, pm = st.edge_map, st.planar_map
    m_prep = knn_cuda.knn_dual_prep(em.points, em.mask, pm.points, pm.mask)
    me_prep = knn_cuda.knn_prep(em.points, em.mask)
    mp_prep = knn_cuda.knn_prep(pm.points, pm.mask)
    k_e, k_p = s2m_reg.num_edge_neighbors, s2m_reg.num_plane_neighbors
    r_e, r_p = s2m_reg.max_edge_neighbor_dist, s2m_reg.max_plane_neighbor_dist
    map_err = _check_dual_knn("knn_dual map scale", knn_cuda, m_prep, mqe, mqp,
                              me_prep, mp_prep, k_e, k_p, r_e, r_p)
    # the valid slots of a voxel map are a prefix: the live bound is their count
    if m_prep.n_live.tolist() != [[int(em.size), int(pm.size)]]:
        raise AssertionError(f"map n_live {m_prep.n_live.tolist()} is not the maps' sizes")
    # distinct k per class (the launch runs max(k) slots and cuts each class)
    for ke, kp in ((3, 5), (5, 2)):
        map_err = max(map_err, _check_dual_knn(f"knn_dual map scale k=({ke},{kp})", knn_cuda, m_prep,
                                               mqe, mqp, me_prep, mp_prep, ke, kp, r_e, r_p))
    # the empty maps of scan-to-map's first frame (built on the GPU by
    # default): nothing is live, every slot stays at its initial value
    st0 = T.scan_to_map_init(s2m_cfg)
    e0, p0 = st0.edge_map, st0.planar_map
    if not e0.points.is_cuda:
        raise AssertionError("scan_to_map_init() without a device did not build its state on the GPU")
    prep0 = knn_cuda.knn_dual_prep(e0.points, e0.mask, p0.points, p0.mask)
    pe0, pp0 = knn_cuda.knn_prep(e0.points, e0.mask), knn_cuda.knn_prep(p0.points, p0.mask)
    map_err = max(map_err, _check_dual_knn("knn_dual empty map", knn_cuda, prep0, mqe, mqp,
                                           pe0, pp0, k_e, k_p, r_e, r_p))
    _check_single_knn("knn empty map", knn_cuda, pp0, mqp, k_p, r_p, f_next.planar_mask)
    empty = knn_cuda.knn_dual_run(prep0, mqe, mqp, k_e, k_p, r_e, r_p)
    if prep0.n_live.any() or empty[0].mask.any() or empty[1].mask.any():
        raise AssertionError("knn_dual found neighbors in an empty map")
    map_plan = knn_cuda.split_plan(1, ((mqe.shape[0], em.points.shape[0]),
                                       (mqp.shape[0], pm.points.shape[0])), bq)
    if max(map_plan) <= 1:
        raise AssertionError("knn_dual: the map-scale launch did not take the split path")
    map_shape = (f"B=1, {mqe.shape[0]} edge + {mqp.shape[0]} planar queries vs "
                 f"{em.points.shape[0]} + {pm.points.shape[0]} map slots "
                 f"({int(em.size)} + {int(pm.size)} filled after {n_map} frames), k={k_p}, "
                 f"{map_plan} (edge, planar) target splits")
    map_ms = _time_ms(lambda: knn_cuda.knn_dual_run(m_prep, mqe, mqp, k_e, k_p, r_e, r_p), 10)
    map_host_us = _host_us(lambda: knn_cuda.knn_dual_run(m_prep, mqe, mqp, k_e, k_p, r_e, r_p), 50)
    map_launch_ms = _time_ms(lambda: knn_cuda._dual_search_kernel(
        m_prep, mqe[None], mqp[None], max(k_e, k_p), r_e * r_e, r_p * r_p), 10)
    map_plain_ms = _time_ms(
        lambda: knn_cuda.knn_dual_run_reference(m_prep, mqe, mqp, k_e, k_p, r_e, r_p), 2)
    map_two_ms = _time_ms(lambda: (knn_cuda.knn_run(me_prep, mqe, k_e, r_e),
                                   knn_cuda.knn_run(mp_prep, mqp, k_p, r_p)), 10)
    map_empty_ms = _time_ms(lambda: knn_cuda.knn_dual_run(prep0, mqe, mqp, k_e, k_p, r_e, r_p), 10)
    print(f"knn_dual map scale: {map_ms:.4f} ms (launch alone {map_launch_ms:.4f} ms, plain "
          f"{map_plain_ms:.4f} ms, two single launches {map_two_ms:.4f} ms, empty maps "
          f"{map_empty_ms:.4f} ms) at {map_shape}")
    if max(dual_err, map_err) != 0.0:
        raise AssertionError(f"knn_dual distances differ from the plain version by {max(dual_err, map_err)}")
    kernels.append(dict(
        name="knn_dual", route="cuda", source="loam_tpu_torch/ops/csrc/knn.cu",
        replaces="loam_tpu/ops/knn_pallas.py:946", shape=map_shape,
        max_abs_err=map_err, ms=map_ms, launch_ms=map_launch_ms, host_us=map_host_us,
        plain_ms=map_plain_ms, library_ms=None,
        **dual_bound(m_prep, em.mask, pm.mask, mqe, mqp, max(k_e, k_p)),
    ))
    _print_kernels(kernels)

    # ---- 3. the offline driver (single kNN) ----------------------------------
    counters = {
        "sector_sort": bitonic_cuda.sector_sort,
        "greedy_nms": nms_cuda.greedy_nms,
        "select_points": assemble_cuda.select_points,
        "knn": knn_cuda.knn_run,
        "knn_dual": knn_cuda.knn_dual_run,
    }
    extraction = ("sector_sort", "greedy_nms", "select_points")
    gt = np.stack([t for (_, t) in poses])
    path_launches = {}

    def drive(path, run, must, must_not):
        """One counted run of a path: every counter at 0 just before it,
        read just after; ``must`` kernels launched, ``must_not`` not."""
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        path_launches[path] = launches
        print(f"{path} launches: {launches} (first run {first_s:.3f} s)")
        missing = [k for k in must if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{path} did not launch: {missing}")
        extra = [k for k in must_not if launches[k] != 0]
        if extra:
            raise AssertionError(f"{path} launched {extra}, which it must not")
        return out

    def run_offline():
        # the renderer's numpy array, no device: odometry_offline moves it to the GPU
        return T.odometry_offline(scans_np, lidar, fp, rp, chunk_pairs=4, motion_init=True)

    reps = 3
    with _dual_knn(False):
        traj, details = drive("offline", run_offline, extraction + ("knn",), ("knn_dual",))
        if not traj.translation.is_cuda:
            raise AssertionError("odometry_offline ran a numpy input off the GPU")
        ate, limit, path = _check_trajectory("offline", traj.translation, traj.rotation, frames, gt,
                                             ate_rmse)
        print(f"ATE {ate:.6f} m (limit {limit:.6f} m, path {path:.3f} m); "
              f"iterations {details.num_iterations.tolist()}; termination {details.termination.tolist()}")
        dt = _seconds_per_run(run_offline, reps)
    offline_sps = frames / dt
    print(f"main path: {offline_sps:.3f} scans/s ({dt * 1e3:.3f} ms per {frames}-frame run, "
          f"64x1024, chunk_pairs=4) on {smi}")

    # ---- 4. small-input agreement with the plain versions on the CPU -------
    small = T.LidarParams(16, 360, 0.5, 80.0)
    s_np, _ = render_trajectory(small, 6, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                noise=0.003, seed=11, dtype=np.float32)
    s_gpu, s_cpu = torch.from_numpy(s_np).to(dev), torch.from_numpy(s_np)
    small_cfg = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
    grid_reg = T.RegistrationParams(search_backend="grid", prior_weight=300.0)

    def s2s_loop(x, lid):
        state = T.scan_to_scan_init(lid, fp, device=x.device)
        out = []
        for f in range(x.shape[0]):
            state, pose, det = T.scan_to_scan_step(state, x[f], lid, fp, rp, dewarp=True)
            out.append((pose, det))
        return out

    def small_runs(x):
        t_off, d_off = T.odometry_offline(x, small, fp, rp, chunk_pairs=2, motion_init=True)
        with _dual_knn(True):
            _, t_map, d_map = T.scan_to_map_offline(x, small, fp, s2m_reg, small_cfg)
            s2s = s2s_loop(x, small)
        _, t_grid, d_grid = T.scan_to_map_offline(x, small, fp, grid_reg, small_cfg)
        t_str, d_str = T.odometry_streaming(s_np, small, fp, rp, chunk_frames=4, device=x.device)
        t_s2s = torch.stack([p.translation for p, _ in s2s])
        term_s2s = torch.stack([d.termination for _, d in s2s])
        return {"offline": (t_off.translation, d_off.termination),
                "scan_to_map": (t_map.translation, d_map.termination),
                "scan_to_map_grid": (t_grid.translation, d_grid.termination),
                "scan_to_scan": (t_s2s, term_s2s),
                "streaming": (t_str.translation, d_str.termination)}

    on_gpu, on_cpu = small_runs(s_gpu), small_runs(s_cpu)
    for drv in on_gpu:
        (tg, dg), (tc, dc) = on_gpu[drv], on_cpu[drv]
        gap = float(np.abs(tg.cpu().numpy() - tc.numpy()).max())
        print(f"small input, {drv}: GPU vs CPU trajectory max gap {gap:.3e} m (limit {ATOL_SMALL_M}); "
              f"termination {dg.tolist()} vs {dc.tolist()}")
        if not gap < ATOL_SMALL_M:
            raise AssertionError(f"{drv}: GPU and CPU trajectories differ by {gap} m")

    # ... the loop-closed path on 17 keyframes of 16x360 around the closed
    # square, from the true poses plus a random-walk drift
    from loam_tpu_torch.geometry import Pose3, quat_conjugate, quat_exp, quat_multiply, quat_rotate
    from loam_tpu_torch.loop_closure import optimize_trajectory_with_closures
    from loam_tpu_torch.pose_graph import _cost, optimize_pose_graph
    from loam_tpu_torch.io import random_pose_graph, square_loop_scans, write_kitti_bins
    from loam_tpu_torch.profile_offline import LOOP_CLOSURE_KW

    lo_np, lo_pos, lo_yaw = square_loop_scans(small, n_side=4, step=0.4)
    drift = np.cumsum(np.random.default_rng(0).normal(0, 0.01, lo_pos.shape) * [1, 1, 0.2], axis=0)
    lo_traj = Pose3(quat_exp(torch.tensor([[0.0, 0.0, y] for y in lo_yaw])).float(),
                    torch.from_numpy(lo_pos + drift).float())
    small_kw = dict(max_candidates=4, min_separation=8, max_distance=1.5, iterations=8)
    (opt_g, clo_g), (opt_c, clo_c) = (
        optimize_trajectory_with_closures(_to(lo_traj, d), T.extract_features_batch(
            torch.from_numpy(lo_np).to(d), small, fp), rp, **small_kw) for d in (dev, "cpu"))
    for what in ("i", "j", "accepted"):
        _require_equal(f"small loop closures {what} (GPU vs CPU)", getattr(clo_g, what).cpu(),
                       getattr(clo_c, what))
    if not clo_c.accepted.any():
        raise AssertionError("small loop: no closure accepted")
    gap = _max_err(opt_g.translation.cpu(), opt_c.translation)
    print(f"small input, loop closure: candidates {list(zip(clo_c.i.tolist(), clo_c.j.tolist()))}, "
          f"accepted {clo_c.accepted.tolist()} on both; GPU vs CPU optimized trajectory max gap "
          f"{gap:.3e} m (limit {ATOL_SMALL_M})")
    if not gap < ATOL_SMALL_M:
        raise AssertionError(f"loop closure: GPU and CPU trajectories differ by {gap} m")

    # ... the pose graph in float64 (a chain of 60 nodes and 6 closures)
    gt60, init60, edges60 = random_pose_graph(60, 6, seed=1)
    (pg_g, cost_g), (pg_c, cost_c) = (optimize_pose_graph(_to(init60, d), _to(edges60, d), 10)
                                      for d in (dev, "cpu"))
    gap = max(_max_err(pg_g.translation.cpu(), pg_c.translation),
              _max_err(pg_g.rotation.cpu(), pg_c.rotation))
    print(f"small input, pose graph (60 nodes, float64): GPU vs CPU max gap {gap:.3e} (limit "
          f"{ATOL_GRAPH}); cost {float(cost_g):.3e} vs {float(cost_c):.3e}")
    if not gap < ATOL_GRAPH:
        raise AssertionError(f"pose graph: GPU and CPU differ by {gap}")

    # ... F3: a float64 registration takes the plain search on the card, with
    # no kernel launch; a float32 k = 9 search launches the kernel's wide form
    f64 = T.extract_features_batch(torch.from_numpy(s_np[:2]).to(dev, torch.float64), small, fp)
    src64, tgt64 = f64.map(lambda x: x[1]), f64.map(lambda x: x[0])
    knn_cuda.knn_run.launches = knn_cuda.knn_dual_run.launches = 0
    est_g, det_g64 = T.register_features(src64, tgt64, params=rp)
    if knn_cuda.knn_run.launches or knn_cuda.knn_dual_run.launches:
        raise AssertionError("a float64 registration launched the kNN kernel")
    q9, t9, m9 = src64.planar_points.float(), tgt64.planar_points.float(), tgt64.planar_mask
    k9 = T.knn(q9, t9, m9, 9, rp.max_plane_neighbor_dist)
    if knn_cuda.knn_run.launches != 1:
        raise AssertionError("a float32 k = 9 search did not launch the kNN kernel")
    est_c, det_c64 = T.register_features(src64.map(lambda x: x.cpu()), tgt64.map(lambda x: x.cpu()),
                                         params=rp)
    _require_equal("float64 registration termination", det_g64.termination.cpu(), det_c64.termination)
    gap = max(_max_err(est_g.translation.cpu(), est_c.translation),
              _max_err(est_g.rotation.cpu(), est_c.rotation))
    p9 = knn_cuda.knn_run_reference(knn_cuda.knn_prep(t9, m9), q9, 9, rp.max_plane_neighbor_dist)
    _require_equal("k = 9 search mask vs the plain one", k9.mask, p9.mask)
    for what in ("indices", "distances"):
        _require_equal(f"k = 9 search {what} vs the plain one", getattr(k9, what)[p9.mask],
                       getattr(p9, what)[p9.mask])
    print(f"small input, float64 register_features: GPU vs CPU {gap:.3e} m (limit {ATOL_F64_M}), "
          f"{int(det_g64.num_iterations)} iterations, no kNN kernel launched; k = 9 search (the kernel's "
          f"wide form) equal to the plain one")
    if not gap < ATOL_F64_M:
        raise AssertionError(f"float64 registration: GPU and CPU differ by {gap} m")

    # ---- 5. the offline driver with the dual kNN ------------------------------
    with _dual_knn(True):
        traj_d, details_d = drive("offline dual", run_offline,
                                  extraction + ("knn_dual",), ("knn",))
        ate_d, _, _ = _check_trajectory("offline dual", traj_d.translation, traj_d.rotation,
                                        frames, gt, ate_rmse)
        _require_equal("offline dual termination", details_d.termination, details.termination)
        _require_equal("offline dual iterations", details_d.num_iterations, details.num_iterations)
        gap = _max_err(traj_d.translation, traj.translation)
        print(f"offline dual: ATE {ate_d:.6f} m; pose gap to the single-kNN run {gap:.3e} m "
              f"(limit {ATOL_DUAL_M})")
        if not gap < ATOL_DUAL_M:
            raise AssertionError(f"offline dual differs from single by {gap} m")
        dt_d = _seconds_per_run(run_offline, reps)
    with _dual_knn(False):
        dt_s = _seconds_per_run(run_offline, reps)
    print(f"offline A/B: dual kNN {frames / dt_d:.3f} scans/s, single kNN {offline_sps:.3f} "
          f"(phase 3) and {frames / dt_s:.3f} (after) scans/s, 64x1024, chunk_pairs=4, on {smi}")

    # ---- 6. scan-to-map ---------------------------------------------------------
    def run_s2m():
        return T.scan_to_map_offline(scans, lidar, fp, s2m_reg, s2m_cfg)

    with _dual_knn(True):
        st, traj_m, det_m = drive("scan_to_map", run_s2m, extraction + ("knn_dual",), ("knn",))
        ate_m, limit_m, _ = _check_trajectory("scan_to_map", traj_m.translation, traj_m.rotation,
                                              frames, gt, ate_rmse)
        if int(st.dropped) != 0:
            raise AssertionError(f"scan_to_map dropped {int(st.dropped)} voxels")
        dt_m = _seconds_per_run(run_s2m, reps)
    print(f"scan_to_map: ATE {ate_m:.6f} m (limit {limit_m:.6f} m); maps {int(st.edge_map.size)} / "
          f"{st.edge_map.points.shape[0]} edge, {int(st.planar_map.size)} / "
          f"{st.planar_map.points.shape[0]} planar slots, dropped 0; iterations "
          f"{det_m.num_iterations.tolist()}; termination {det_m.termination.tolist()}")
    print(f"scan_to_map: {frames / dt_m:.3f} scans/s ({dt_m * 1e3:.3f} ms per {frames}-frame run, "
          f"64x1024, default ScanToMapConfig, dual kNN) on {smi}")

    # ---- 7. scan-to-scan with dewarping ----------------------------------------
    def run_s2s():
        return s2s_loop(scans, lidar)

    with _dual_knn(True):
        out = drive("scan_to_scan", run_s2s, extraction + ("knn_dual",), ("knn",))
        t_s2s = torch.stack([p.translation for p, _ in out])
        q_s2s = torch.stack([p.rotation for p, _ in out])
        ate_s, limit_s, _ = _check_trajectory("scan_to_scan", t_s2s, q_s2s, frames, gt, ate_rmse)
        dt_s2s = _seconds_per_run(run_s2s, reps)
    print(f"scan_to_scan: ATE {ate_s:.6f} m (limit {limit_s:.6f} m); termination "
          f"{[int(d.termination) for _, d in out]}")
    print(f"scan_to_scan: {frames / dt_s2s:.3f} scans/s ({dt_s2s * 1e3:.3f} ms per {frames}-frame "
          f"loop, 64x1024, dewarp=True, dual kNN) on {smi}")

    # ---- 8. scan-to-map through the voxel grid ----------------------------------
    def run_s2m_grid():
        return T.scan_to_map_offline(scans, lidar, fp, grid_reg, s2m_cfg)

    st_g, traj_g, det_g = drive("scan_to_map_grid", run_s2m_grid, extraction, ("knn", "knn_dual"))
    ate_g, limit_g, _ = _check_trajectory("scan_to_map_grid", traj_g.translation, traj_g.rotation,
                                          frames, gt, ate_rmse)
    if int(st_g.dropped) != 0:
        raise AssertionError(f"scan_to_map_grid dropped {int(st_g.dropped)} voxels")
    info_g = det_g.iteration_info
    overflow = int(info_g.edge_knn_overflow.sum().item()), int(info_g.plane_knn_overflow.sum().item())
    gap_g = _max_err(traj_g.translation, traj_m.translation)
    print(f"scan_to_map_grid: ATE {ate_g:.6f} m (limit {limit_g:.6f} m); overflow (edge, planar) "
          f"{overflow} at grid_max_per_cell={grid_reg.grid_max_per_cell}; pose gap to the brute-force "
          f"run {gap_g:.3e} m (limit {ATOL_GRID_M}); termination {det_g.termination.tolist()}")
    if overflow != (0, 0):
        raise AssertionError(f"scan_to_map_grid: {overflow} lookups over grid_max_per_cell")
    _require_equal("scan_to_map_grid termination", det_g.termination, det_m.termination)
    if not gap_g < ATOL_GRID_M:
        raise AssertionError(f"scan_to_map_grid differs from the brute-force run by {gap_g} m")
    dt_g = _seconds_per_run(run_s2m_grid, reps)
    print(f"scan_to_map_grid: {frames / dt_g:.3f} scans/s ({dt_g * 1e3:.3f} ms per {frames}-frame run, "
          f"64x1024, default ScanToMapConfig, search_backend=grid) on {smi}")

    # ---- 9. the streaming drivers ---------------------------------------------------
    chunk = 8

    def run_stream(packed):
        return T.odometry_streaming(scans_np, lidar, fp, rp, chunk_frames=chunk, packed=packed)

    def run_pushed():
        odo = T.StreamingOdometry(lidar, fp, rp, chunk_frames=chunk, packed=True)
        out = [pose for f in range(frames) for pose in odo.push(scans_np[f])]
        return out + odo.finish()

    with _dual_knn(False):
        traj_p, det_p = drive("streaming", lambda: run_stream(True), extraction + ("knn",), ("knn_dual",))
        per_chunk = {k: path_launches["streaming"][k] for k in extraction}
        if any(n != frames // chunk for n in per_chunk.values()):
            raise AssertionError(f"streaming: extraction kernels launched {per_chunk}, expected "
                                 f"{frames // chunk} each (once a chunk)")
        if not traj_p.translation.is_cuda:
            raise AssertionError("odometry_streaming ran a numpy input off the GPU")
        traj_u, det_u = drive("streaming_unpacked", lambda: run_stream(False), extraction + ("knn",),
                              ("knn_dual",))
        pushed = run_pushed()
        if [i for i, _ in pushed] != list(range(frames)):
            raise AssertionError(f"StreamingOdometry handed out frames {[i for i, _ in pushed]}")
        t_pushed = torch.stack([p.translation for _, p in pushed])
        _require_equal("StreamingOdometry vs odometry_streaming translations", t_pushed,
                       traj_p.translation.cpu())
        _require_equal("StreamingOdometry vs odometry_streaming rotations",
                       torch.stack([p.rotation for _, p in pushed]), traj_p.rotation.cpu())
        ate_p, limit_p, _ = _check_trajectory("streaming packed", traj_p.translation, traj_p.rotation,
                                              frames, gt, ate_rmse)
        ate_u, _, _ = _check_trajectory("streaming unpacked", traj_u.translation, traj_u.rotation,
                                        frames, gt, ate_rmse)
        gap_u = _max_err(traj_u.translation, traj.translation)
        gap_pu = _max_err(traj_p.translation, traj_u.translation)
        print(f"streaming: ATE packed {ate_p:.6f} m, unpacked {ate_u:.6f} m (limit {limit_p:.6f} m); "
              f"unpacked vs the offline run of phase 3 {gap_u:.3e} m (limit {ATOL_STREAM_M}); packed vs "
              f"unpacked {gap_pu:.3e} m; StreamingOdometry equal to odometry_streaming; termination "
              f"{det_p.termination.tolist()}")
        if not gap_u < ATOL_STREAM_M:
            raise AssertionError(f"streaming differs from the offline run by {gap_u} m")
        dt_p = _seconds_per_run(lambda: run_stream(True), reps)
        dt_u = _seconds_per_run(lambda: run_stream(False), reps)
        dt_push = _seconds_per_run(run_pushed, reps)
    print(f"streaming: packed {frames / dt_p:.3f} scans/s ({dt_p * 1e3:.3f} ms per {frames}-frame run), "
          f"unpacked {frames / dt_u:.3f}, StreamingOdometry pushed frame by frame {frames / dt_push:.3f} "
          f"scans/s, 64x1024, chunk_frames={chunk}, host encode and upload included, on {smi}")

    # ---- 10. the loop-closed path at full width ------------------------------------
    from loam_tpu_torch.io import native_available
    from loam_tpu_torch.loop_closure import closure_edges, join_edges, propose_candidates, verify_closures
    from loam_tpu_torch.pose_graph import odometry_edges

    if not native_available():
        raise AssertionError("the native loader (io/native/loam_io.cpp) did not build")
    loop_np, loop_pos, _ = square_loop_scans(lidar)
    n_kf = len(loop_np)
    loop_path = float(np.sum(np.linalg.norm(np.diff(loop_pos, axis=0), axis=-1)))
    with tempfile.TemporaryDirectory() as tmp, _dual_knn(False):
        paths = write_kitti_bins(loop_np, tmp)

        def run_file_odometry():
            return T.odometry_streaming(paths, lidar, fp, rp, chunk_frames=8, packed=True)

        traj_l, det_l = drive("loop_odometry", run_file_odometry, extraction + ("knn",), ("knn_dual",))
        dt_file = _seconds_per_run(run_file_odometry, reps)
        loop_scans = torch.from_numpy(loop_np).to(dev)

        def run_closures():
            feats = T.extract_features_batch(loop_scans, lidar, fp)
            return feats, optimize_trajectory_with_closures(traj_l, feats, rp, **LOOP_CLOSURE_KW)

        feats_l, (opt_l, clo_l) = drive("loop_closure", run_closures, extraction + ("knn",), ("knn_dual",))
        kw = LOOP_CLOSURE_KW
        cand = propose_candidates(traj_l, kw["max_candidates"], kw["min_separation"], kw["max_distance"])
        # the kernels at this path's shapes against their plain versions: the
        # extraction kernels on the keyframes' lines, and the single kNN on
        # the candidate pairs verify_closures registers (keyframe j's
        # features against keyframe i's, masked queries), at its first ICF
        # iteration (the odometry's relative poses) and at the verified poses
        loop_rows = _extraction_kernels(loop_scans, lidar, fp, "_loop")
        ci, cj = cand[0].long(), cand[1].long()
        inv = quat_conjugate(traj_l.rotation[ci])
        first = Pose3(quat_multiply(inv, traj_l.rotation[cj]),
                      quat_rotate(inv, traj_l.translation[cj] - traj_l.translation[ci]))
        src_l, tgt_l = feats_l.map(lambda x: x[cj]), feats_l.map(lambda x: x[ci])
        loop_knn_err = 0.0
        for at, pose in (("first iteration", first), ("verified", clo_l.measurement)):
            for cls, k, r in (("planar", rp.num_plane_neighbors, rp.max_plane_neighbor_dist),
                              ("edge", rp.num_edge_neighbors, rp.max_edge_neighbor_dist)):
                prep = knn_cuda.knn_prep(getattr(tgt_l, f"{cls}_points"), getattr(tgt_l, f"{cls}_mask"))
                q = (quat_rotate(pose.rotation[:, None], getattr(src_l, f"{cls}_points"))
                     + pose.translation[:, None]).contiguous()
                qm = getattr(src_l, f"{cls}_mask").contiguous()
                loop_knn_err = max(loop_knn_err, _check_single_knn(f"knn loop {cls} {at}", knn_cuda, prep, q,
                                                                   k, r, qm))
                if cls == "planar" and at == "first iteration":
                    loop_knn = (prep, q, k, r, qm, getattr(tgt_l, f"{cls}_mask"))
        if loop_knn_err != 0.0:
            raise AssertionError(f"knn on the loop's pairs differs from the plain version by {loop_knn_err}")
        prep, q, k, r, qm, tmask = loop_knn
        loop_rows.append(_knn_row(
            "knn_loop", knn_cuda, prep, q, k, r, qm, tmask, loop_knn_err,
            f"B={len(ci)} candidate pairs, Q=M={q.shape[1]} planar (and {src_l.edge_points.shape[1]} edge), "
            f"k={k}, n_live {prep.n_live.tolist()}, {int(qm.sum())} searching queries, first ICF iteration"))
        _print_kernels(loop_rows)
        kernels += loop_rows
        dt_verify = _seconds_per_run(lambda: verify_closures(traj_l, feats_l, *cand, rp), reps)
        edges_l = join_edges(odometry_edges(traj_l), closure_edges(clo_l))
        dt_solve = _seconds_per_run(lambda: optimize_pose_graph(traj_l, edges_l, kw["iterations"]), reps)
    pairs = list(zip(clo_l.i.tolist(), clo_l.j.tolist()))
    accepted = [p for p, a in zip(pairs, clo_l.accepted.tolist()) if a]
    ate_o = ate_rmse(traj_l.translation.cpu().numpy(), loop_pos, align=False)
    ate_l, limit_l, _ = _check_trajectory("loop closure", opt_l.translation, opt_l.rotation, n_kf,
                                          loop_pos, ate_rmse)
    t_o, t_l = traj_l.translation.cpu().numpy(), opt_l.translation.cpu().numpy()
    end0, end1 = float(np.linalg.norm(t_o[-1] - t_o[0])), float(np.linalg.norm(t_l[-1] - t_l[0]))
    print(f"loop closure: {n_kf} keyframes of 64x1024 from .bin files through the native loader, "
          f"min_separation={kw['min_separation']}, max_distance={kw['max_distance']} m; candidates "
          f"{pairs}, accepted {accepted}; inlier_frac {[round(x, 4) for x in clo_l.inlier_frac.tolist()]}, "
          f"mean_residual {[round(x, 5) for x in clo_l.mean_residual.tolist()]}; odometry termination "
          f"{det_l.termination.tolist()}")
    print(f"loop closure: ATE odometry {ate_o:.6f} m -> optimized {ate_l:.6f} m (limit {limit_l:.6f} m, "
          f"path {loop_path:.3f} m); end gap {end0:.6f} -> {end1:.6f} m")
    if (0, n_kf - 1) not in accepted:
        raise AssertionError(f"loop closure: the start/end revisit (0, {n_kf - 1}) was not accepted")
    if not (end1 < 0.5 * end0 or end1 < 0.02):
        raise AssertionError(f"loop closure: the end gap went {end0} -> {end1} m")
    if not ate_l <= ate_o:
        raise AssertionError(f"loop closure: ATE rose from {ate_o} to {ate_l} m")
    print(f"loop closure: file-fed odometry {n_kf / dt_file:.3f} scans/s ({dt_file * 1e3:.3f} ms per "
          f"{n_kf}-frame run, 64x1024, chunk_frames=8, packed, files read and projected by the native "
          f"loader); verify_closures {dt_verify * 1e3:.3f} ms a call ({len(pairs)} pairs); pose-graph "
          f"solve {dt_solve * 1e3:.3f} ms ({n_kf} nodes, {int(edges_l.mask.sum())} live edges, "
          f"{kw['iterations']} iterations) on {smi}")

    # ---- 11. the pose graph at drive scale ---------------------------------------------
    gt1k, init1k, edges1k = random_pose_graph(1000, 50, seed=2)
    for dtype in (torch.float64, torch.float32):
        init_d, edges_d = _to(init1k, dev, dtype), _to(edges1k, dev, dtype)
        cost0 = float(_cost(init_d, edges_d))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        opt_k, cost_k = optimize_pose_graph(init_d, edges_d, 10)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        dt_k = _seconds_per_run(lambda: optimize_pose_graph(init_d, edges_d, 10), reps)
        err = _max_err(opt_k.translation.cpu(), gt1k.translation)
        print(f"pose graph, 1,000 nodes + 50 closures, {str(dtype)[6:]}: cost {cost0:.6e} -> "
              f"{float(cost_k):.6e}; max position error vs the truth {err:.3e} m; {dt_k * 1e3:.3f} ms a "
              f"solve (10 iterations, H 6,000 x 6,000); peak device memory {peak / 2**20:.1f} MiB above "
              f"the {held / 2**20:.1f} MiB held before, on {smi}")
        if not float(cost_k) < cost0:
            raise AssertionError(f"pose graph {dtype}: the cost did not fall ({cost0} -> {float(cost_k)})")
        if dtype == torch.float64 and not err < ATOL_GRAPH_TRUTH_M:
            raise AssertionError(f"pose graph float64: {err} m from the true poses")

    for kd in kernels:
        counter = kd.get("counter", kd["name"])
        kd["launches_by_path"] = {path: lc[counter] for path, lc in path_launches.items()}
        kd["launches"] = sum(kd["launches_by_path"].values())

    print(json.dumps({"kernels": [
        {k: kd[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                            "plain_ms", "bound_ms", "bound_by", "library_ms", "launch_ms", "launches_by_path",
                            "shape")}
        | {k: kd[k] for k in ("host_us", "library_launch_ms", "chain_floor_ms", "accepts_max",
                              "accepts_mean") if k in kd}
        for kd in kernels
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
