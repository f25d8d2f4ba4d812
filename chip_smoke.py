#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU: build, kernel checks, the
odometry drivers.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  0. Require CUDA; print the GPU's name and power limit (``nvidia-smi``),
     and the torch and CUDA versions; turn TF32 off.
  1. Build the five CUDA kernels, the mesh's gather over peer memory
     (``peer_gather.cu``) and the CUDA-graph IF nodes (``graph_if.cu``)
     from ``loam_tpu_torch/ops/csrc`` (one ``nvcc`` per source, all at
     once) and print the build time and what ``ptxas`` reports
     (registers, shared memory, spills).
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
     replaces. The kNN kernels prune their visits (boxes of the targets, a
     nearest-first list a block of queries, the per-visit gate, the seed
     bounds): the single search runs with the ICF loop's cold seed bound at
     the first iteration (row ``knn``), with the warm one from the last
     result at moved queries (``knn_warm``), in the wide form at k = 16
     (``knn_wide16``), and at map scale as scan-to-map's prep cache runs it
     (``knn_map``); against maps whose every slot is live (points uniform in
     a 40 m cube: nothing to prune), the dual search (``knn_dual_mapfull``)
     and the single one with the cold seed (``knn_mapfull``); every seed bound
     computed on the card is bit-equal to the plain functions' on the CPU,
     and the bound the kernel gated with (its debug plane) to the one it was
     given. Each kNN row prints its visits against the live boxes, the bound
     from the distance evaluations the search needed (``bound_ms``: the
     query-box visits that passed the gate) beside the dense bound, and the
     row's launch-alone time before the pruning (from ``PERF.md``; printed,
     not in the JSON line). ``--extraction-only`` stops here, after the three
     extraction kernels, and prints their rows.
  3. Drive ``odometry_offline`` on those 16 frames, handed over as the numpy
     array the renderer returns and with no ``device`` (so it runs on the
     GPU), ``chunk_pairs=4``, ``motion_init=True`` (single kNN) with every
     launch counter reset first; require each kernel to have launched,
     finite poses of the right shape and the benchmark's ATE gate; time 2
     runs after a warm-up. Run again with ``LOAM_KNN_SEED=0`` and
     ``LOAM_S2M_PREP_CACHE=0``: poses bit-equal, terminations and iteration
     counts equal.
  4. Check agreement with the plain versions on a small input: the offline,
     scan-to-map (brute force and grid), scan-to-scan and streaming drivers
     on 6 frames of 16x360 scans on the GPU and on the CPU;
     ``optimize_trajectory_with_closures`` on a closed loop of 17 keyframes
     of 16x360 (candidates and accepted closures equal, poses within 1e-2 m);
     ``optimize_pose_graph`` in float64 on a 60-node graph (poses within
     1e-8); a float64 ``register_features`` (the plain kNN on the card, one
     captured program with its later iterations under one WHILE node,
     bit-equal to the eager loop, within 1e-9 m of the CPU, no kNN kernel
     launched) and a
     k = 9 search (the kernel's wide form, equal to the plain one).
  5. ``odometry_offline`` with ``LOAM_ICF_DUAL_KNN=1``: the dual kNN instead
     of the single one, the same terminations and iteration counts as phase
     3, poses within 1e-5 m of it, the ATE gate; scans/s beside phase 3's.
  6. ``scan_to_map_offline`` on the 16 frames with the default
     ``ScanToMapConfig`` and ``default_map_reg_params()``: the
     rebuild-on-insert prep cache and the seeded single kNN, as ``loam_tpu``
     runs it; every extraction kernel and the single kNN launched, no dual
     kNN; the ATE gate; no voxel dropped; the cache after the inserts, and
     stripped and rebuilt, equal to one built fresh; again without the seeds
     and the cache: poses bit-equal, terminations and iteration counts
     equal; map sizes and scans/s over 2 runs of both.
  7. A ``scan_to_scan_step(dewarp=True)`` loop over the 16 frames, dual kNN:
     every extraction kernel and the dual kNN launched, no single kNN; the
     ATE gate; scans/s.
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
     counted runs; both runs again without the seed bounds: odometry poses
     bit-equal, terminations and iteration counts equal, the same closures
     and optimized poses. Holds the kernels against their plain versions at this
     path's shapes: the extraction kernels on the keyframes' 2,112 lines and
     the single kNN on the candidate pairs that ``verify_closures``
     registers, with their query masks, at the first ICF iteration and at
     the verified poses (rows ``*_loop``). Prints scans/s of the file-fed
     run, ms per ``verify_closures`` call and per pose-graph solve.
 11. ``optimize_pose_graph`` at drive scale: a chain of 1,000 nodes plus 50
     closures, noise-free measurements, a perturbed start (H is 6,000 x
     6,000), in float64 and float32 on the card. Requires the float64 solve
     to recover the true poses within 1e-5 m, both costs to fall, and the
     float32 solve within 2e-3 m of the float64 solve and of the truth (the
     float32 tolerance ``tests/test_torch_pose_graph.py`` states); prints
     ms per solve and the peak device memory.
 12. The multi-device surface (``loam_tpu_torch.parallel``) on a mesh of 4
     shards of this GPU, in a world-size-1 NCCL group started in-process
     (TCP store on 127.0.0.1; NCCL takes one rank a GPU). Drives
     ``scan_to_map_step_sharded`` over the 16 frames at the default
     capacities (8,192 / 32,768 slots a shard) beside the single-device
     ``scan_to_map_step`` (single kNN): the sharded step sorts its source by
     azimuth (``loam_tpu``'s sharded step), ``scan_to_map_step`` by Morton
     key (F15), so the sharded step is held to the single-device steps fed
     the same azimuth-sorted features (``scan_to_map_step_features``: the
     same neighbours): keyframes and terminations equal, poses within 1e-5;
     its gap per pair to ``scan_to_map_step`` printed; map sizes within 1%,
     ``dropped`` 0, the ATE gate, every extraction kernel and the kNN
     launched; scans/s of both. Holds
     the kNN at the sharded shape (one frame's planar queries against the 4
     shards of the planar map in one launch) against its plain version on
     the final maps and on the empty maps of frame 0 (rows ``knn_shard``,
     ``knn_shard_empty``). ``odometry_offline_sharded`` (each shard's 4
     pairs one lockstep batch) against ``odometry_offline`` in chunks of 4
     pairs without the motion prior (terminations equal, poses within 1e-5
     m, the ATE gate) and against one pair a call (poses within 1e-4 m);
     ``extract_features_sharded`` on a (2 data x 2 line) mesh equal to
     ``extract_features_batch``;
     ``optimize_pose_graph_sharded`` on phase 11's graph in float64, its
     edges padded with masked ones to a multiple of 4, within 1e-8 of phase
     11's solve and 1e-5 m of the truth; ms per solve, peak memory. Each
     sharded call (a scan-to-map frame) is one program, its gathers and
     sums (the kernel's over peer memory, ``peer_gather.cu``; a gather
     launched on every sharded path but the pose graph's, a sum on
     scan-to-map's and the pose graph's) inside the CUDA graph. Then the
     collectives at the main path's shapes: the sharded search's planar
     and edge values, (4, 4, 5, Q) float32, and the search's planar
     indices and values as one tree; a frame's features a shard and a
     registration's poses and details as one tree each (offline's two
     gathers); the pose graph's normal matrix, (4, 6,000, 6,000) float64,
     gathered; the sums of the normal matrix and of the right-hand side
     (the indices too, unrowed): every gather bit-equal to NCCL's
     ``all_gather_into_tensor`` a leaf, every sum to that gather then the
     adds in shard order; each one node of a graph that captures it alone,
     and a sum's eager call allocating under twice its output (no gathered
     blocks); timed beside the plain version, the library's call
     (for a sum, timed only: ``x.sum(0)`` at one rank, ``all_reduce`` of a
     block past one) and the bound (the
     larger of the bytes received over NVLink at 450 GB/s a direction and
     the local reads and writes at 3.35 TB/s): rows ``peer_gather_*`` and
     ``peer_sum_*``. The meshes are released before the group is
     destroyed.
 13. The card's full-width output against the float64 oracle
     (``loam_tpu_torch.oracle``, numpy on the host): ``extract_features_batch``
     on 4 of the 16 frames, every edge and planar pick index-exact with
     ``oracle.extract_features`` on the same scans in float64; both kNN
     entry points -- the single search on the main path's chunk with the
     cold seed, the dual one at scan scale, on the map after 4 frames and on
     the live map of phase 2 -- on 2,048 sampled searching queries a launch
     against ``knn_oracle`` by ``oracle.compare.check_knn`` (indices and
     masks exact on every row whose f64 gaps between ranks 1..k+1 and to the
     radius exceed 2^-20 of d2, the float32 rounding of a distance being 5 *
     2^-24 at most; the rows inside the margin counted; d2 within 1e-6 of the
     oracle's); one ICF pair of 32x512 scans in float32 through the kNN
     kernel (the oracle's termination, the pose within 1e-2 m / 1e-3 rad of
     the oracle's, the gap printed: F6 on the card) and in float64 on the
     card, which takes the plain search (no kernel launch; validity and
     matches equal to ``register_oracle``'s in every iteration, estimates
     within 1e-9, deltas within 1e-8).
 14. Widths past the kernels' register forms (F9: the port refused them
     before): ``extract_features_batch`` on 16x3600, 64x2083 (lines of more
     than 2,048 points: the NMS keeps its mask in shared memory), 64x2048
     with one sector and 8x8192 with one sector (sectors of 2,048 and 8,192
     slots: the sort's block form), each a counted path that launches the
     three extraction kernels, equal to the CPU path and index-exact with the
     f64 oracle; the three kernels against their plain versions at each
     shape, timed (rows ``*_wide_<shape>``). ``odometry_offline`` on 8 frames
     of 64x2083 under phase 3's ATE gate. The five ``examples/torch_*.py`` at
     their defaults on the card, side by side, each exiting 0 (their own
     asserts included).
 15. One program a driver call (``program.py``; phases 3-14 already ran
     through them): each call of ``odometry_offline`` and
     ``scan_to_map_offline`` one CUDA graph (``lax.scan`` over chunks or
     frames and each registration's ``lax.while_loop`` as WHILE nodes, the
     keyframe ``lax.cond`` as an IF node), each scan-to-scan frame and
     streaming chunk one CUDA graph, against the same drivers eager
     (``program.eager``, the graphs' plain version), at full width on
     offline-64x1024-c4, its dual-kNN twin, scan-to-map, scan-to-map with
     dewarping (first driven alone: the ATE gate, ``dropped`` 0),
     scan-to-scan with dewarping and streaming in chunks of 8: every output
     tensor bit-equal (poses, terminations, iteration counts, detail rows,
     maps, the prep cache), every kernel's launches and the outer ICF
     iterations equal; each program's conditional nodes by type, graph
     nodes (bodies counted once), capture seconds (warm-up included), pool
     bytes and replays; scans/s of both in turns (graph, eager, eager,
     graph). A ``torch.profiler`` trace of each graph run: inside the
     driver's range (``program.DRIVER_RANGE``) the ``cudaGraphLaunch``
     calls and the host's reads of the device a unit -- a call for the
     trajectory drivers, a frame or chunk for the others -- (required 1 and
     0), the host's launch calls a run, device kernel ms and the idle share;
     the graph run's device span by CUDA events and, for the trajectory
     drivers, a trace of the eager run (device kernel ms: a trace counts a
     WHILE body's kernels once, not each time the body runs). Then
     offline-64x1024-c4 and scan-to-map on 16 and on 64 frames: the
     graph's nodes, conditional nodes by type, capture seconds, pool bytes
     and ms a call at each, the node counts and conditional nodes required
     equal (at 16, 64 and 128 frames in phase 16). Then the sharded cells,
     on 4 shards of this GPU in a
     world-size-1 NCCL group started afresh: s2m-64x1024-sharded4
     (``scan_to_map_step_sharded``, one program a frame: the sharded
     search's gathers inside the ICF loop's WHILE node, the sharded insert
     and its sum inside the keyframe's IF node), offline-64x1024-sharded4
     (``odometry_offline_sharded``), extract-64x1024-2x2
     (``extract_features_sharded`` on a 2 data x 2 line mesh; no
     conditional node) and pairs-64x1024-sharded4
     (``register_pairs_sharded``, 12 consecutive pairs), one program a call
     each, through the same checks; then the sharded scan-to-map and
     offline cells at 16 and 64 frames (offline's nodes may follow the
     frames: its pairs are one lockstep batch, whose kNN split plan follows
     the pairs; conditional nodes required equal). The grid, pose-graph and
     closure cells, through the same checks, each also held to its phase's
     gates:
     s2m-64x1024-grid (phase 8's call: the grids built inside the frames'
     scan, searched inside the ICF loop's WHILE node; the ATE gate,
     ``dropped`` 0, overflow (0, 0); graph nodes equal at 16 and 64 frames),
     posegraph-1000-f64 and -f32 (phase 11's solve, the LM iterations one
     WHILE node; the cost falls, float64 within 1e-5 m of the truth; nodes
     equal at 10 and 40 iterations), loop-64x1024-closures
     (``optimize_trajectory_with_closures`` on phase 10's 33 keyframes: the
     proposal, the verification's ICF loop and ``closure_quality``'s kNN
     launches, the edges and the solve in one graph; the start/end revisit
     accepted, the end gap halved, the ATE no worse) and, in the fresh NCCL
     group, posegraph-1000-sharded4 (phase 12's solve on 4 shards, within
     1e-8 of phase 11's). For each call-sized cell the graph's calls back to
     back and the eager run's device span by CUDA events, no profiler, beside
     the eager trace's kernel sum. Prints them as a ``{"one_program": ...}``
     line.
 16. The drive at a user's length: the trajectory's 128 frames (12.8 s of
     an Ouster-64 at 10 Hz; every shorter run above is its first frames),
     ``odometry_offline`` (``chunk_pairs=4``, ``motion_init``) and
     ``scan_to_map_offline`` (default config and registration) each one
     program, in float32 and in float64 (the plain kNN on the card, the
     dtype rule; scan-to-map from float64 maps and poses): every pair's
     relative pose in float32 within 2 mm and
     1e-3 rad of float64's (F6 per pair; the largest and median gaps, the
     mean gap vector and the absolute gap by frames 64 and 128
     printed), the pairs whose termination codes differ named, the ATE gate
     for every run and float32's ATE within 10% of float64's. Scan-to-map
     on the float64 scans from its default state (float32 maps, searched
     and fitted in float32) is held to the float32 run the same way until
     the two runs' keyframe decisions part (the frame and both runs'
     distances from the last keyframe printed), and float32 on the scans
     nudged by 1e-6 m is printed beside it: how near the drive's keyframe
     decisions lie to their threshold. The maps' live slots, ``dropped``
     0, overflow (0, 0), the kNN's visit share at the last frame. Then
     offline-c4, s2m and s2m-grid captured afresh at 16, 64 and 128
     frames: graph nodes and conditional nodes equal at every length, the
     pool growing no faster than 1.25x what the call must hold (outputs
     and hoisted features) plus 64 MiB; ms a call (the mean of 2 replays
     after one), peak device memory. A ``{"drive": ...}`` line.
     ``--drive-only`` runs phase 1 and this phase alone.
 17. One rank a card. N ranks, N the largest power of two no greater than
     ``min(torch.cuda.device_count(), 8)`` (one on a one-card machine: the
     whole path but the cross-card traffic), each this script started again
     as a worker (``--rank-worker``) on ``cuda:<rank>``
     (``torch.cuda.set_device``) in an NCCL group made eagerly on that card
     (``init_process_group(device_id=)``), the README's recipe. First the
     collective probe, each case N throwaway ranks of its own (a refusal
     ends them, and the case records it): the kernel's gather
     (``collectives.gather``, over peer memory) captured into a WHILE body
     (3 and 2 iterations), an IF body (taken and not) and a plain graph,
     replayed, each output bit-equal to NCCL's eager gather of the same
     blocks (required); and NCCL's own gather in the same WHILE and IF
     bodies, and a rank's first NCCL gather on a side stream then captured
     into a plain graph (the order in which a four-card run once hung),
     printed as measured: NCCL 2.28.9 refuses the bodies past world size 1,
     which is why the port gathers with its own kernel. Then each rank, on
     ``make_mesh()`` (one shard on its card) at full width on
     phase 12's 16 frames of 64x1024: ``scan_to_map_step_sharded`` over the
     16 frames (default ``ScanToMapConfig``, ``default_map_reg_params()``),
     ``odometry_offline_sharded``, ``extract_features_sharded``,
     ``register_pairs_sharded`` on 8 pairs and ``optimize_pose_graph_sharded``
     on phase 11's float64 graph (edges padded to a multiple of N): each a
     counted run (every counter at 0 just before, read just after: the
     extraction kernels, the kNN and the gather or the sum launched, the
     dual kNN not),
     a traced run (inside ``program.DRIVER_RANGE``: 1 ``cudaGraphLaunch``
     and 0 host reads a call or frame, required of every cell) and ms a run;
     then the kernel's collectives against their plain versions at the
     cells' own shapes (phase 12's, one shard a rank; bit-equal and one
     graph node each required, both timed); then the cards it holds a CUDA context
     on (the driver API) and ``torch.cuda.memory_reserved`` on every other
     card, both required to be its card alone and 0. A rank past
     ``RANKS_TIMEOUT_S`` or failing kills every rank, and the phase fails
     naming it and its last stamp. Then every rank's outputs are required
     bit-equal to rank 0's (scan-to-map's maps aside: each rank holds its
     own rows of them), and rank 0's to the same calls in this process on N
     shards of ``cuda:0`` in a world-size-1 NCCL group, the ranks' rows of
     the maps in rank order to its maps (the fixed sum order and a batch a
     shard make N ranks x 1 shard equal 1 rank x N shards); the ATE gate
     and ``dropped`` 0. Past one rank, every cell's collectives' time
     split into the wait for the slowest rank and the transfer
     (``examples/torch_gather_split.py``, each collective between two
     ``%globaltimer`` stamps on every rank). Ms a call or frame and
     scans/s on N ranks beside 1 rank x N shards, the collectives' ms
     beside their plain versions', and a ``{"ranks": ...}`` line
     (``cards``, ``ranks``, ``cross_card``, the probe, the contexts, the
     cells, the collectives, the split). ``--ranks-only`` runs phase 1 and
     this phase alone; ``--ranks-only <cell> ...`` the cells named, without
     the probe, the collectives' check and the split. Across hosts (BASELINE
     config 5): past one rank the same ranks also run every cell on each mesh
     of ``_host_splits`` -- at 4 ranks 2 hosts x 2 (``make_mesh(hosts=[0,
     0, 1, 1])``: two islands over NVLink, the cross-host leg between them)
     and 4 x 1 (every pair through the host proxies over loopback TCP) --
     through the same gates (1 ``cudaGraphLaunch`` and 0 host reads a unit,
     every rank bit-equal to rank 0's and to 1 rank x N shards, every
     collective bit-equal to its plain version and one graph node, timed
     beside its bound: NVLink within the island, PCIe at 64 GB/s each way
     to the staging for the remote peers); the probe's kernel cases in a
     WHILE and an IF body on each split (required accepted); and the wire's
     own rate beside each collective (``--wire-worker``: a plain socket
     copy of the bytes the kernel sends each remote peer, between the same
     kind of processes, and NCCL's gather or all-reduce over its network
     transport, the ranks' hosts named by ``NCCL_HOSTID``). On one card: two
     ranks on ``cuda:0`` in a gloo group, each its own host
     (``--share-worker``: the cross-host leg with the card time-sliced
     between the two processes), every cell through the same gates against
     1 rank x 2 shards.

``LOAM_ICF_DUAL_KNN``, ``LOAM_KNN_SEED`` and ``LOAM_S2M_PREP_CACHE`` are set
and restored around the phases that use them.
It prints a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ATOL_SMALL_M = 1e-2  # GPU-vs-CPU trajectory agreement (the ICF position convergence threshold)
ATOL_SMALL_RAD = 1e-3  # the same in rotation, as tests/test_torch_odometry.py
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
# H in another order on the card
ATOL_GRAPH = 1e-8
# the float64 pose-graph solve of noise-free edges vs the truth (the
# tolerance of tests/test_pose_graph.py::test_recovers_exact_graph)
ATOL_GRAPH_TRUTH_M = 1e-5
# the sharded drivers vs the single-device ones: the same neighbours (the
# scan-to-map merge is exact; equidistant map points may come in shard
# order), offline pairs in a shard's lockstep batch against the same
# batches of odometry_offline's chunks
ATOL_SHARD = 1e-5
# odometry_offline_sharded against odometry_offline one pair a call: each
# shard's pairs are one batch of 4, whose float32 sums round apart from a
# batch of one (phase 12 read 2.831e-05 m on an H100 80GB HBM3 at 700 W)
ATOL_OFFLINE_ONE_PAIR_M = 1e-4
# the float32 pose-graph solve: within 2e-3 m of the float64 solve and of the
# truth (the bound tests/test_torch_pose_graph.py holds the port's float32
# solve to against loam_tpu's: float32's own rounding sets it)
ATOL_GRAPH_F32_M = 2e-3
# phase 16: one drive of an Ouster-64 at 10 Hz, 12.8 s
DRIVE_FRAMES = 128
# the shorter lengths each whole-call program is also captured at
DRIVE_SIZES = (16, 64)
# F6 on the card, every pair's relative pose float32 vs float64: 2x and 3.7x
# loam_tpu's own float32 error per pair at 32x512 on the CPU (0.95 mm,
# 2.7e-4 rad; tests/test_torch_odometry.py states the CPU tolerance)
DRIVE_PAIR_M, DRIVE_PAIR_RAD = 2e-3, 1e-3
# float32's ATE within 10% of float64's (3.8-5.1% at 40 frames of 32x512 on
# the CPU, both packages)
DRIVE_ATE_RATIO = 0.10
# the scan perturbation (m, Gaussian, seed 7) of phase 16's float32 run
# that shows how near its keyframe decisions lie to the threshold
DRIVE_NUDGE_M = 1e-6
# a whole-call program's pool grows with the frames no faster than what the
# call must hold (its outputs and the hoisted feature batch), give or take the
# allocator's rounding of each buffer
POOL_GROWTH_RATIO, POOL_SLACK_B = 1.25, 64 << 20


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


_T0 = time.perf_counter()


def _stamp(what: str) -> None:
    """Seconds since the script started, as a phase begins."""
    print(f"[{time.perf_counter() - _T0:.1f} s] {what}", flush=True)


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
def _env(**values):
    """Set environment variables for the block and restore them after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _dual_knn(on: bool):
    """Set ``LOAM_ICF_DUAL_KNN`` for the block and restore it after."""
    return _env(LOAM_ICF_DUAL_KNN="1" if on else "0")


#: The pruning's switches off: no seed bounds, no scan-to-map prep cache.
UNSEEDED = dict(LOAM_KNN_SEED="0", LOAM_S2M_PREP_CACHE="0")

#: Each kNN row's launch-alone time before the pruning, as PERF.md section 6
#: gives it (NVIDIA H100 80GB HBM3, 700 W); printed beside the row, not in
#: the JSON line. The warm row has the cold row's shape.
EARLIER_LAUNCH_MS = {"knn": 0.7324, "knn_warm": 0.7324, "knn_dual_scan": 0.7999, "knn_dual": 0.1011,
                     "knn_shard": 0.1368, "knn_shard_empty": 0.0480, "knn_wide16": 5.2558,
                     "knn_dual_mapfull": 1.1152}


def _check_single_knn(what, knn_cuda, prep, q, k, r, qm, seed=None):
    """The single kernel (with ``seed``, ``knn_run``'s seed arguments, if
    any) against its plain version in both output forms, all exactly equal;
    the kernel visits no more boxes than are live. Returns the max abs error
    of the valid distances."""
    import torch

    seed = seed or {}
    a, va = knn_cuda.knn_run(prep, q, k, r, with_coords=True, query_mask=qm, return_visits=True,
                             **seed)
    b, vb = knn_cuda.knn_run_reference(prep, q, k, r, with_coords=True, query_mask=qm,
                                       return_visits=True)
    torch.cuda.synchronize()
    if va.shape != vb.shape or not bool((va <= vb).all()):
        raise AssertionError(f"{what}: the kernel visited more boxes than are live")
    _require_equal(f"{what} mask", a.mask, b.mask)
    m = b.mask
    _require_equal(f"{what} first_idx", a.first_idx[m[..., 0, :]], b.first_idx[m[..., 0, :]])
    for ax in ("xs", "ys", "zs"):
        _require_equal(f"{what} {ax}", getattr(a, ax)[m], getattr(b, ax)[m])
    ra = knn_cuda.knn_run(prep, q, k, r, query_mask=qm, **seed)
    rb = knn_cuda.knn_run_reference(prep, q, k, r, query_mask=qm)
    torch.cuda.synchronize()
    _require_equal(f"{what} result mask", ra.mask, rb.mask)
    _require_equal(f"{what} indices", ra.indices[rb.mask], rb.indices[rb.mask])
    _require_equal(f"{what} distances", ra.distances, rb.distances)
    return _max_err(ra.distances[rb.mask], rb.distances[rb.mask])


def _visit_fields(name, visits, plain_visits, tt, nbytes, dense_ops) -> dict:
    """The pruning's figures of a kNN row: ``visits`` (B, blocks, 2) of the
    kernel's debug counter (boxes staged, query-box visits) against the
    plain search's every live box; ``bound_ms`` from the distance
    evaluations the search needed (the query-box visits that passed the
    gate x box length, 8 float32 operations each), ``dense_bound_ms`` from
    every searching query against every valid target."""
    done = int(visits[..., 1].sum().item()) * tt
    staged, live = int(visits[..., 0].sum().item()), int(plain_visits.sum().item())
    dense = _bound(nbytes, dense_ops)
    return dict(visits=staged, live_boxes=live, visits_share=staged / max(live, 1), evaluations=done,
                dense_bound_ms=dense["bound_ms"], earlier_launch_ms=EARLIER_LAUNCH_MS.get(name),
                **_bound(nbytes, 8 * done))


def _knn_row(name, knn_cuda, prep, q, k, r, qm, tmask, err, shape, seed=None, want=None) -> dict:
    """The single kNN's entry: the wrapper call by call (``ms``), the search
    and merge kernels without the wrapper's PyTorch operations
    (``launch_ms``), the wrapper's host microseconds a call and the plain
    version, beside the bound from the evaluations the kernel did and the
    dense bound from this run's targets and searching queries; the visit
    share. ``seed`` holds ``knn_run``'s seed arguments; the bound the kernel
    gated each query with (its debug plane) must equal ``want`` bit for bit
    (+inf without a seed)."""
    import torch

    seed = seed or {}
    run = lambda: knn_cuda.knn_run(prep, q, k, r, with_coords=True, query_mask=qm, **seed)
    out = run()
    prev = seed.get("seed_prev")
    raw = dict(prev=None if prev is None else (prev.xs, prev.ys, prev.zs, prev.mask),
               window=seed.get("seed_window", False))
    sb = seed.get("seed_bound")
    _, _, _, visits, used = knn_cuda._search_kernel(prep, q, k, r * r, qm, sb, visits=True, bound=True,
                                                    **raw)
    if want is None:
        want = torch.full_like(used, float("inf"))
    if not torch.equal(used.cpu(), want.cpu()):
        raise AssertionError(f"{name}: the kernel gated with another bound than the plain functions give")
    # index, d2 and three coordinate planes out
    nbytes = (_nbytes(prep.tT, prep.n_live, prep.rot, prep.rbox, q, qm, sb, *(raw["prev"] or ()))
              + 5 * _nbytes(out.xs))
    return dict(
        name=name, counter="knn", route="cuda", source="loam_tpu_torch/ops/csrc/knn.cu",
        replaces="loam_tpu/ops/knn_pallas.py:134", shape=shape, max_abs_err=err,
        ms=_time_ms(run, 10),
        launch_ms=_time_ms(lambda: knn_cuda._search_kernel(prep, q, k, r * r, qm, sb, **raw), 10),
        host_us=_host_us(run, 50),
        plain_ms=_time_ms(lambda: knn_cuda.knn_run_reference(prep, q, k, r, with_coords=True, query_mask=qm), 2),
        library_ms=None,  # cdist + topk is two calls and another arithmetic
        seeded=bool(seed),
        **_visit_fields(name, visits, knn_cuda._plain_visits(prep.n_live, prep.tt, q.shape[1], k),
                        prep.tt, nbytes, _knn_operations([(tmask, qm)])))


def _plain_seed(knn_cuda, q, t_points, t_mask, k, prev=None):
    """The ICF loop's seed bound for moved queries ``q`` (B, Q, 3) by the
    plain functions on the CPU: min(warm start from the packed result
    ``prev``, or none yet, cold start from the rank window of the
    targets)."""
    import torch

    q, t, m = q.cpu(), t_points.cpu(), t_mask.cpu()
    B, Q = q.shape[:2]
    if prev is None:  # the carry before the first iteration: no neighbours
        z = torch.zeros((B, k, Q), dtype=q.dtype)
        prev_t = (z, z, z, torch.zeros((B, k, Q), dtype=torch.bool))
    else:
        prev_t = tuple(x.cpu() for x in (prev.xs, prev.ys, prev.zs, prev.mask))
    win = knn_cuda.window_candidates(t, m, Q)
    return torch.minimum(knn_cuda.seed_bound_from_packed(q, *prev_t),
                         knn_cuda.seed_bound_from_window(q, *win, k))


def _seconds_per_run(run, reps: int) -> float:
    """Host seconds per call over ``reps`` calls after one warm-up call
    (which captures the ICF loop's graphs where the cache lacks them),
    ended by a synchronize."""
    import torch

    run()
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
        if "graph_nodes" in kd:
            line += f", {kd['graph_nodes']} graph node(s) captured alone"
        if "visits" in kd:
            earlier = kd["earlier_launch_ms"]
            line += (f", visits {kd['visits']} of {kd['live_boxes']} live boxes (share "
                     f"{kd['visits_share']:.4f}), {kd['evaluations']} distance evaluations done, dense "
                     f"bound {kd['dense_bound_ms']:.6f} ms, launch alone before the pruning "
                     + ("not measured" if earlier is None else f"{earlier:.4f} ms (PERF.md)"))
            if kd.get("seeded"):
                line += ", seed bound bit-equal to the plain functions' on the CPU"
        if "chain_floor_ms" in kd:
            line += (f", chain floor {kd['chain_floor_ms']:.6f} ms ({kd['accepts_max']} accepts in the "
                     f"longest line, {kd['accepts_mean']:.1f} a line on average)")
        print(line + f", max_abs_err {kd['max_abs_err']} at {kd['shape']}")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def _nccl_group():
    """A world-size-1 NCCL group started in-process (TCP store on
    127.0.0.1; NCCL takes one rank a GPU, so this card holds one rank),
    destroyed on the way out."""
    import torch.distributed as dist

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: bootstrap on the loopback
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _sharded_phase(T, torch, dev, smi, scans, scans_np, lidar, fp, rp, gt, frames, drive, extraction,
                   ate_rmse, knn_cuda, gt1k, init1k, edges1k, opt64, reps) -> list:
    """Phase 12: the multi-device surface on a mesh of 4 shards of this GPU
    in a world-size-1 NCCL group. Returns the kernel rows ``knn_shard`` and
    ``knn_shard_empty``."""
    from loam_tpu_torch import parallel
    from loam_tpu_torch.parallel.distributed import scan_to_map_init_sharded, scan_to_map_step_sharded
    from loam_tpu_torch.pose_graph import optimize_pose_graph_sharded

    with _nccl_group() as group:
        return _sharded_checks(T, torch, dev, smi, scans, scans_np, lidar, fp, rp, gt, frames, drive,
                               extraction, ate_rmse, knn_cuda, gt1k, init1k, edges1k, opt64, reps,
                               parallel, scan_to_map_init_sharded, scan_to_map_step_sharded,
                               optimize_pose_graph_sharded, group)


def _sharded_checks(T, torch, dev, smi, scans, scans_np, lidar, fp, rp, gt, frames, drive, extraction,
                    ate_rmse, knn_cuda, gt1k, init1k, edges1k, opt64, reps, parallel, init_sharded,
                    step_sharded, solve_sharded, group) -> list:
    from loam_tpu_torch.evaluation import relative_pose_gaps

    D = 4
    mesh = parallel.make_mesh([dev] * D, group=group)
    cfg, reg = T.ScanToMapConfig(), T.default_map_reg_params()
    if mesh.shape != {"data": D, "line": 1} or mesh.device != dev:
        raise AssertionError(f"mesh {mesh.shape} on {mesh.device}")

    # scan-to-map against maps sharded 4 ways, and the single-device steps
    def run_sharded():
        st = init_sharded(cfg, mesh)
        out = []
        for f in range(frames):
            st, pose, det = step_sharded(st, scans[f], lidar, mesh, fp, reg, cfg)
            out.append((pose, det, int(st.frames_since_insert)))
        return st, out

    def run_single(sort=None):
        # ``sort``: the steps fed features sorted so (the sharded step's
        # azimuth order), else ``scan_to_map_step`` (Morton)
        st = T.scan_to_map_init(cfg)
        out = []
        for f in range(frames):
            if sort is None:
                st, pose, det = T.scan_to_map_step(st, scans[f], lidar, fp, reg, cfg)
            else:
                feats = sort(T.extract_features(scans[f], lidar, fp))
                st, pose, det = T.scan_to_map_step_features(st, feats, reg, cfg)
            out.append((pose, det, int(st.frames_since_insert)))
        return st, out

    with _dual_knn(False):
        st_sh, out_sh = drive("scan_to_map_sharded", run_sharded, extraction + ("knn", "peer_gather", "peer_sum"),
                              ("knn_dual",))
        st_1, out_1 = run_single()
        st_az, out_az = run_single(T.registration.azimuth_sort_features)
        dt_sh = _seconds_per_run(run_sharded, reps)
        dt_1 = _seconds_per_run(run_single, reps)
    t_sh = torch.stack([p.translation for p, _, _ in out_sh])
    t_1 = torch.stack([p.translation for p, _, _ in out_1])
    q_sh = torch.stack([p.rotation for p, _, _ in out_sh])
    q_1 = torch.stack([p.rotation for p, _, _ in out_1])
    ate, limit, _ = _check_trajectory("scan_to_map_sharded", t_sh, q_sh, frames, gt, ate_rmse)
    # F15: the sharded step sorts its source by azimuth (loam_tpu's sharded
    # step), scan_to_map_step by Morton key: held to the single-device steps
    # fed the same azimuth-sorted features (the same neighbours); against
    # the Morton steps the gap per pair is printed
    t_az = torch.stack([p.translation for p, _, _ in out_az])
    q_az = torch.stack([p.rotation for p, _, _ in out_az])
    gap = max(_max_err(t_sh, t_az), _max_err(q_sh, q_az))
    host = lambda x: x.cpu().double().numpy()
    d_t, d_ang = relative_pose_gaps(host(t_sh), host(q_sh), host(t_1), host(q_1))
    pair_m, pair_rad = float(np.linalg.norm(d_t, axis=1).max()), float(d_ang.max())
    fsi_sh, fsi_1, fsi_az = ([f for _, _, f in out] for out in (out_sh, out_1, out_az))
    term_sh, term_1, term_az = ([int(d.termination) for _, d, _ in out] for out in (out_sh, out_1, out_az))
    n_sh = int(st_sh.edge_map.mask.sum()) + int(st_sh.planar_map.mask.sum())
    n_1 = int(st_az.edge_map.size) + int(st_az.planar_map.size)
    print(f"scan_to_map_sharded: {D} shards of {dev} ({cfg.edge_capacity // D} / {cfg.planar_capacity // D} "
          f"slots a shard); ATE {ate:.6f} m (limit {limit:.6f} m); pose gap to the single-device steps on the "
          f"same azimuth-sorted features {gap:.3e} (limit {ATOL_SHARD}); to scan_to_map_step (Morton) "
          f"{pair_m:.4e} m, {pair_rad:.4e} rad a pair at most, absolute {_max_err(t_sh, t_1):.4e} m, keyframes "
          f"{'equal' if fsi_1 == fsi_sh else fsi_1}, termination {term_1}; keyframes {fsi_sh}; termination "
          f"{term_sh}; map voxels {n_sh} vs {n_1} single; dropped {int(st_sh.dropped)}")
    if fsi_sh != fsi_az:
        raise AssertionError(f"scan_to_map_sharded keyframes {fsi_sh} != single {fsi_az}")
    if term_sh != term_az:
        raise AssertionError(f"scan_to_map_sharded termination {term_sh} != single {term_az}")
    if not gap < ATOL_SHARD:
        raise AssertionError(f"scan_to_map_sharded differs from the single-device steps by {gap}")
    if abs(n_sh - n_1) > max(5, n_1 // 100):
        raise AssertionError(f"scan_to_map_sharded holds {n_sh} voxels, the single map {n_1}")
    if int(st_sh.dropped) != 0:
        raise AssertionError(f"scan_to_map_sharded dropped {int(st_sh.dropped)} voxels")
    print(f"scan_to_map_sharded: {frames / dt_sh:.3f} scans/s ({dt_sh * 1e3:.3f} ms per {frames}-frame "
          f"run, 64x1024, default ScanToMapConfig over {D} shards, single kNN) beside the single-device "
          f"steps' {frames / dt_1:.3f} scans/s, on {smi}")

    # the kNN at the sharded path's shape: one frame's planar queries against
    # each 32,768-slot shard of the planar map (the four shards one launch),
    # on the final maps and on the empty maps of frame 0
    k, r = reg.num_plane_neighbors, reg.max_plane_neighbor_dist
    feats = T.registration.azimuth_sort_features(T.extract_features(scans[frames - 1], lidar, fp))
    guess = st_sh.world_T_current.compose(st_sh.prev_delta)
    q = guess.act(feats.planar_points).expand(D, -1, -1).contiguous()
    qm = feats.planar_mask.expand(D, -1).contiguous()
    rows = []
    for name, pm in (("knn_shard", st_sh.planar_map), ("knn_shard_empty", init_sharded(cfg, mesh).planar_map)):
        prep = knn_cuda.knn_prep(pm.points, pm.mask)
        err = _check_single_knn(name, knn_cuda, prep, q, k, r, qm)
        if err != 0.0:
            raise AssertionError(f"{name} distances differ from the plain version by {err}")
        if name == "knn_shard_empty":
            out = knn_cuda.knn_run(prep, q, k, r, with_coords=True, query_mask=qm)
            if prep.n_live.any() or out.mask.any():
                raise AssertionError("knn_shard_empty found neighbours in empty shards")
        rows.append(_knn_row(name, knn_cuda, prep, q, k, r, qm, pm.mask, err,
                             f"B={D} shards, Q={q.shape[1]} planar queries ({int(qm[0].sum())} searching) vs "
                             f"{pm.points.shape[1]} slots a shard, k={k}, n_live {prep.n_live.tolist()}"))
    _print_kernels(rows)

    # offline odometry with the frames split 4 ways (each shard's pairs one
    # lockstep batch), against odometry_offline in chunks of the same pairs
    # (no motion prior) and one pair a call (its defaults)
    with _dual_knn(False):
        run_off = lambda: parallel.odometry_offline_sharded(scans_np, lidar, mesh, fp, rp)
        traj_sh, det_sh = drive("offline_sharded", run_off, extraction + ("knn", "peer_gather"), ("knn_dual",))
        run_off1 = lambda: T.odometry_offline(scans_np, lidar, fp, rp, chunk_pairs=frames // D)
        traj_1, det_1 = run_off1()
        traj_p, _ = T.odometry_offline(scans_np, lidar, fp, rp)
        dt_off = _seconds_per_run(run_off, reps)
        dt_off1 = _seconds_per_run(run_off1, reps)
    ate_o, limit_o, _ = _check_trajectory("offline_sharded", traj_sh.translation, traj_sh.rotation, frames,
                                          gt, ate_rmse)
    gap_o = _max_err(traj_sh.translation, traj_1.translation)
    gap_p = _max_err(traj_sh.translation, traj_p.translation)
    print(f"offline_sharded: ATE {ate_o:.6f} m (limit {limit_o:.6f} m); pose gap to odometry_offline in "
          f"chunks of {frames // D} pairs {gap_o:.3e} m (limit {ATOL_SHARD}), to one pair a call "
          f"{gap_p:.3e} m (limit {ATOL_OFFLINE_ONE_PAIR_M}); termination "
          f"{det_sh.termination.tolist()}; {frames / dt_off:.3f} scans/s ({dt_off * 1e3:.3f} ms per "
          f"{frames}-frame run) beside odometry_offline's {frames / dt_off1:.3f} (chunks of {frames // D} "
          f"pairs), on {smi}")
    _require_equal("offline_sharded termination", det_sh.termination, det_1.termination)
    if not gap_o < ATOL_SHARD:
        raise AssertionError(f"offline_sharded differs from odometry_offline by {gap_o} m")
    if not gap_p < ATOL_OFFLINE_ONE_PAIR_M:
        raise AssertionError(f"offline_sharded differs from odometry_offline one pair a call by {gap_p} m")

    # extraction on a (2 data x 2 line) mesh: index-exact
    mesh22 = parallel.make_mesh([dev] * D, line_axis=2, group=group)
    got = drive("extract_sharded", lambda: parallel.extract_features_sharded(scans, lidar, mesh22, fp),
                extraction + ("peer_gather",), ("knn", "knn_dual"))
    want = T.extract_features_batch(scans, lidar, fp)
    for field, a, b in zip(want._fields, got, want):
        _require_equal(f"extract_features_sharded {field}", a, b)
    print(f"extract_features_sharded: (2 data x 2 line) mesh, {frames} frames of 64x1024, equal to "
          f"extract_features_batch in every leaf")

    # the pose graph of phase 11, its 1,049 edges padded with masked ones to a
    # multiple of 4 and split over the shards, float64
    init_d, edges_d = _to(init1k, dev, torch.float64), _to(edges1k, dev, torch.float64)
    edges_p, pad = _padded_edges(torch, edges_d, D)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    opt_sh, cost_sh = solve_sharded(init_d, edges_p, mesh, 10)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    dt_pg = _seconds_per_run(lambda: solve_sharded(init_d, edges_p, mesh, 10), reps)
    gap_pg = max(_max_err(opt_sh.translation, opt64.translation), _max_err(opt_sh.rotation, opt64.rotation))
    err_pg = _max_err(opt_sh.translation.cpu(), gt1k.translation)
    print(f"pose graph sharded: {edges_d.i.shape[0]} + {pad} masked edges over {D} shards, float64: cost "
          f"{float(cost_sh):.6e}; gap to optimize_pose_graph {gap_pg:.3e} (limit {ATOL_GRAPH}); "
          f"{err_pg:.3e} m from the truth; {dt_pg * 1e3:.3f} ms a solve (10 iterations); peak device "
          f"memory {peak / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB held before, on {smi}")
    if not gap_pg < ATOL_GRAPH:
        raise AssertionError(f"pose graph sharded differs from optimize_pose_graph by {gap_pg}")
    if not err_pg < ATOL_GRAPH_TRUTH_M:
        raise AssertionError(f"pose graph sharded: {err_pg} m from the true poses")
    peer_rows = _peer_rows(T, torch, mesh, scans, lidar, fp)
    _print_kernels(peer_rows)
    mesh.release()  # their graphs replay the mesh's gathers: gone before the group is
    mesh22.release()
    return rows + peer_rows


NVLINK_BYTES_S = 450e9  # H100 SXM NVLink, each way (published)
PCIE_BYTES_S = 64e9  # PCIe Gen5 x16, each way (published): the cross-host leg's staging


def _gather_bound(nbytes: int, world: int, island: int = None) -> dict:
    """The least time a gather of ``nbytes`` a rank could take on ``world``
    ranks, ``island`` of them on this rank's island (all by default): the
    largest of the island peers' blocks received over NVLink, the remote
    peers' blocks staged out and in over PCIe (each way at once) and the
    rank's own block read and the output written at the memory rate (they
    overlap)."""
    island = world if island is None else island
    ms = max((island - 1) * nbytes / NVLINK_BYTES_S, (world - island) * nbytes / PCIE_BYTES_S,
             (1 + world) * nbytes / PEAK_BYTES_S) * 1e3
    return {"bound_ms": ms, "bound_by": "bytes"}


def _sum_bound(block: int, L: int, world: int, island: int = None) -> dict:
    """The least time the fixed-order sum of ``L`` blocks of ``block`` bytes
    a rank could take on ``world`` ranks, ``island`` of them on this rank's
    island (all by default): the largest of what a reduce-scatter and an
    all-gather receive over NVLink from the island peers and over PCIe from
    the remote ones (a slice of the L blocks, then of the sums, from each;
    an all-reduce can take no less) and the rank's L blocks read and the
    one block written at the memory rate."""
    island = world if island is None else island
    ms = max((island - 1) / world * (L + 1) * block / NVLINK_BYTES_S,
             (world - island) / world * (L + 1) * block / PCIE_BYTES_S, (L + 1) * block / PEAK_BYTES_S) * 1e3
    return {"bound_ms": ms, "bound_by": "bytes"}


# the rows of the mesh's collectives: (name in _peer_shapes, the XLA
# collective it stands for)
PEER_ROWS = (("knn_planar_val", "loam_tpu/parallel/distributed.py:83"),
             ("knn_edge_val", "loam_tpu/parallel/distributed.py:83"),
             ("search_planar", "loam_tpu/parallel/distributed.py:83"),
             ("heads", "loam_tpu/parallel/sharding.py (the all-gather of a sharded output)"),
             ("details", "loam_tpu/parallel/sharding.py (the all-gather of a sharded output)"),
             ("H", "loam_tpu/pose_graph.py:281"),
             ("sum_H", "loam_tpu/pose_graph.py:281"),
             ("sum_b", "loam_tpu/pose_graph.py:282"))


def _peer_rows(T, torch, mesh, scans, lidar, fp) -> list:
    """The kernel rows of the mesh's collectives over peer memory on
    ``mesh`` (phase 12's 4 shards, a world-size-1 NCCL group) at the main
    path's shapes (:func:`_peer_shapes`, every one checked bit-equal to its
    plain version by :func:`_peer_check`, one graph node each): the sharded
    search's values, planar and edge, and its tree (indices and values, one
    gather), the tree of a frame's features a shard (offline's gather of
    heads), the tree of poses and details (a registration's output), the
    pose graph's normal matrix gathered, and the sums of H and b. A
    gather's plain version is NCCL's ``all_gather_into_tensor`` a leaf,
    which is also the library's (a single tensor: one PyTorch call); a
    sum's is that gather and the adds in shard order, its library call
    ``x.sum(0)`` over the L blocks at one rank and ``dist.all_reduce`` of
    one block past one (another order of adds: timed only).
    ``plain_ms`` is the plain version back to back, ``library_launch_ms``
    the library's in a graph, beside the kernel's ``launch_ms``."""
    import torch.distributed as dist

    world = dist.get_world_size(mesh.group)
    shapes = _peer_shapes(T, torch, mesh, scans, lidar, fp)
    check = _peer_check(torch, mesh, shapes, 10)
    unequal = [name for name, row in check.items() if not row["equal"]]
    if unequal:
        raise AssertionError(f"the peer collectives differ from their plain versions at {unequal}")
    nodes = {name: row["graph_nodes"] for name, row in check.items() if row["graph_nodes"] != 1}
    if nodes:
        raise AssertionError(f"a peer collective is more than one graph node: {nodes}")
    heavy = {name: row["peak_bytes"] for name, row in check.items()
             if row["kind"] == "sum" and row["peak_bytes"] >= 2 * row["out_bytes"]}
    if heavy:
        raise AssertionError(f"a peer sum allocated more than its output (the gathered blocks?): {heavy}")
    rows = []
    for name, replaces in PEER_ROWS:
        kind, x = shapes[name]
        row = check[name]
        L, nbytes = row["L"], row["bytes"]
        bound = _gather_bound(nbytes, world) if kind == "gather" else _sum_bound(nbytes // L, L, world)
        rows.append(dict(
            name=f"peer_{kind}_{name.removeprefix('sum_')}", counter=f"peer_{kind}", route="cuda",
            source="loam_tpu_torch/ops/csrc/peer_gather.cu",
            replaces=f"{replaces} (an XLA collective: no pallas_call)",
            shape=f"{row['what']} a rank, {world} rank(s)", max_abs_err=0.0,
            ms=row["ms"], launch_ms=row["graph_us"] / 1e3, plain_ms=row["plain_ms"],
            library_ms=row["library_ms"], library_launch_ms=row["library_graph_us"] / 1e3,
            host_us=row["host_us"], graph_nodes=row["graph_nodes"], **bound))
    return rows


def _padded_edges(torch, edges, D: int):
    """``edges`` padded with masked ones (weight 0) to a multiple of ``D``,
    and the padding's length."""
    pad, dev = (-edges.i.shape[0]) % D, edges.i.device
    return type(edges)(
        torch.cat([edges.i, torch.zeros(pad, dtype=torch.int32, device=dev)]),
        torch.cat([edges.j, torch.ones(pad, dtype=torch.int32, device=dev)]),
        type(edges.measurement)(*(torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
                                  for x in edges.measurement)),
        torch.cat([edges.weight, torch.zeros(pad, dtype=edges.weight.dtype, device=dev)]),
        torch.cat([edges.mask, torch.zeros(pad, dtype=torch.bool, device=dev)])), pad


def _oracle_phase(T, torch, dev, smi, scans_np, lidar, fp, rp, oracle_knn, counters):
    """Phase 13: the card's full-width output against the float64 oracle
    (``loam_tpu_torch.oracle``, numpy on the host): the extraction kernels'
    picks, both kNN entry points on sampled queries, and one ICF pair in
    float32 through the kernel and in float64. Raises on any departure."""
    from loam_tpu_torch.io import render_trajectory
    from loam_tpu_torch.oracle import compare, extract_features, register_oracle

    # extraction: the three kernels on 4 frames, index-exact with the oracle
    n = 4
    before = {k: counters[k].launches for k in ("sector_sort", "greedy_nms", "select_points")}
    fb = T.extract_features_batch(torch.from_numpy(scans_np[:n]).to(dev), lidar, fp)
    torch.cuda.synchronize()
    idle = [k for k, v in before.items() if counters[k].launches == v]
    if idle:
        raise AssertionError(f"oracle phase: extraction did not launch {idle}")
    t0 = time.perf_counter()
    sizes = []
    for f in range(n):
        one = fb.map(lambda x: x[f])
        e, p = one.compact_indices()
        oe, op = extract_features(scans_np[f].astype(np.float64), lidar, fp)
        if e.tolist() != oe or p.tolist() != op:
            raise AssertionError(f"oracle phase: frame {f}: {len(e)} edges / {len(p)} planars picked on the card, "
                                 f"the f64 oracle {len(oe)} / {len(op)}, not index-exact")
        flat = scans_np[f].reshape(-1, 3)
        ep, pp = one.compact()
        if not (np.array_equal(ep, flat[e]) and np.array_equal(pp, flat[p])):
            raise AssertionError(f"oracle phase: frame {f}: picked coordinates are not the scan's")
        sizes.append((len(e), len(p)))
    print(f"oracle extraction: {n} frames of {lidar.scan_lines}x{lidar.points_per_line}, precise_selection: "
          f"edges and planars {sizes} index-exact with the f64 oracle (sector sort, greedy NMS, copy-out on "
          f"the card; oracle {time.perf_counter() - t0:.1f} s of host time)")

    # kNN: both entry points on 2,048 sampled searching queries a launch
    rng = np.random.default_rng(13)
    for what, run, classes in oracle_knn:
        results = run()
        torch.cuda.synchronize()
        per = 2048 // len(classes)
        tot = dict(rows=0, near_ties=0, d2_rtol=0.0)
        t0 = time.perf_counter()
        for cls, at, q, qm, tp, tm, k, r in classes:
            idx, dist, m = (x.reshape((-1,) + x.shape[-2:]).cpu().numpy() for x in results[at])  # (B, Q, k)
            qn, qmn, tpn, tmn = (x.cpu().numpy() for x in (q, qm, tp, tm))
            bs, rows = np.nonzero(qmn)
            pick = rng.choice(len(bs), size=min(per, len(bs)), replace=False)
            for b in np.unique(bs[pick]):
                sel = rows[pick][bs[pick] == b]
                got = compare.check_knn(f"{what} {cls} pair {b}", qn[b, sel], tpn[b], tmn[b], k, r,
                                        idx[b, sel], dist[b, sel], m[b, sel])
                tot["rows"] += got["rows"]
                tot["near_ties"] += got["near_ties"]
                tot["d2_rtol"] = max(tot["d2_rtol"], got["d2_rtol"])
        print(f"oracle {what}: {tot['rows']} sampled queries against knn_oracle in f64 on the same f32 "
              f"coordinates: indices and masks exact on every row outside the near-tie margin (gaps of at "
              f"most 2^-20 of d2), {tot['near_ties']} rows inside it; d2 within {tot['d2_rtol']:.3e} "
              f"(relative, limit {compare.KNN_D2_RTOL}) ({time.perf_counter() - t0:.1f} s of host time)")

    # one ICF pair at 32x512: float32 through the kernel, float64 on the card
    # (the dtype rule sends it to the plain search), against register_oracle
    small = T.LidarParams(32, 512, 0.5, 120.0)
    pair_np, _ = render_trajectory(small, 2, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01, noise=0.005,
                                   seed=0, dtype=np.float32)
    fs = T.extract_features_batch(torch.from_numpy(pair_np).to(dev), small, fp)
    (te, tp), (se, sp) = (fs.map(lambda x: x[i]).compact() for i in range(2))
    up = lambda a: a.astype(np.float64)
    t0 = time.perf_counter()
    orc = register_oracle(up(se), up(sp), up(te), up(tp), params=rp)
    oracle_s = time.perf_counter() - t0
    sets = lambda dt: (T.feature_set_from_points(se, sp, dtype=dt, device=dev),
                       T.feature_set_from_points(te, tp, dtype=dt, device=dev))
    knn_fns = (counters["knn"], counters["knn_dual"])
    for fn in knn_fns:
        fn.launches = 0
    est, det = T.register_features(*sets(torch.float32), params=rp)
    torch.cuda.synchronize()
    if counters["knn"].launches + counters["knn_dual"].launches == 0:
        raise AssertionError("oracle phase: the float32 registration did not launch a kNN kernel")
    gap_m, gap_rad = compare.pose_gap(est.rotation, est.translation, orc)
    if int(det.termination) != orc.termination:
        raise AssertionError(f"oracle phase: float32 termination {int(det.termination)}, the oracle's "
                             f"{orc.termination}")
    if not (gap_m <= ATOL_SMALL_M and gap_rad <= ATOL_SMALL_RAD):
        raise AssertionError(f"oracle phase: float32 pose {gap_m:.3e} m / {gap_rad:.3e} rad from the oracle's")
    print(f"oracle ICF pair, {small.scan_lines}x{small.points_per_line} ({len(se)} + {len(sp)} source "
          f"features), float32 through the kNN kernel: termination {int(det.termination)} after "
          f"{int(det.num_iterations)} iterations as the oracle's ({len(orc.iterations)}); pose "
          f"{gap_m:.3e} m / {gap_rad:.3e} rad from the oracle's (F6 on the card; limits {ATOL_SMALL_M} m / "
          f"{ATOL_SMALL_RAD} rad); oracle {oracle_s:.1f} s of host time, on {smi}")
    for fn in knn_fns:
        fn.launches = 0
    est64, det64 = T.register_features(*sets(torch.float64), params=rp)
    torch.cuda.synchronize()
    if counters["knn"].launches + counters["knn_dual"].launches != 0:
        raise AssertionError("oracle phase: the float64 registration launched a kNN kernel")
    iters = compare.check_icf("oracle phase float64 pair", det64, orc)
    gap_m, gap_rad = compare.pose_gap(est64.rotation, est64.translation, orc)
    print(f"oracle ICF pair in float64 on the card (plain search): {iters} iterations, validity and matches "
          f"equal to the oracle's in each, entering estimates within {compare.ICF_INPUT_ATOL} and deltas "
          f"within {compare.ICF_DELTA_ATOL}; final pose {gap_m:.3e} m / {gap_rad:.3e} rad from the oracle's")


#: Phase 14's scans, past the kernels' register forms: (label, lines, points
#: a line, sectors, frames). 16x3600: a 16-beam spinning LiDAR at 0.1 degree;
#: 64x2083: a 64-beam scan at its native azimuth spacing; one sector of
#: 2,048 and of 8,192 slots.
WIDE_SCANS = (("16x3600", 16, 3600, 6, 4), ("64x2083", 64, 2083, 6, 2),
              ("64x2048_one_sector", 64, 2048, 1, 2), ("8x8192_one_sector", 8, 8192, 1, 2))

#: The examples (``examples/torch_*.py``), run at their defaults on the card.
EXAMPLES = ("torch_scan_to_scan_odometry.py", "torch_scan_to_map_odometry.py", "torch_streaming_odometry.py",
            "torch_full_slam.py", "torch_distributed_mapping.py")


def _wide_phase(T, torch, dev, smi, drive, extraction, rp, ate_rmse) -> list:
    """Phase 14: the widths past the kernels' register forms (F9), the
    offline driver at 64x2083 and the examples. Returns the extraction
    kernels' rows at the wide shapes (names ``*_wide_<shape>``)."""
    from loam_tpu_torch.io import render_scan, render_trajectory
    from loam_tpu_torch.oracle import extract_features as oracle_extract
    from loam_tpu_torch.ops import bitonic_cuda, nms_cuda

    rows = []
    for label, L, P, S, n in WIDE_SCANS:
        lidar = T.LidarParams(L, P, 0.5, 120.0)
        fp = T.FeatureExtractionParams(number_sectors=S, precise_selection=True)
        npad = 1 << (P - (S - 1) * (P // S) - 1).bit_length()
        forms = (bitonic_cuda.kernel_form(npad, torch.float64, dev), nms_cuda.kernel_form(P, dev))
        if (npad > 1024) == (forms[0] == "warp") or (P > 2048) == (forms[1] == "registers"):
            raise AssertionError(f"wide {label}: sort and NMS took the forms {forms}")
        scans_np = np.stack([render_scan(lidar, np.array([0.1 * f, 0.0, 0.0]), 0.01 * f, noise=0.005, seed=f,
                                         dtype=np.float32) for f in range(n)])
        scans = torch.from_numpy(scans_np).to(dev)
        feats = drive(f"wide_{label}", lambda: T.extract_features_batch(scans, lidar, fp), extraction,
                      ("knn", "knn_dual"))
        plain = T.extract_features_batch(torch.from_numpy(scans_np), lidar, fp)
        for name, a, b in zip(feats._fields, feats, plain):
            _require_equal(f"wide {label} {name} vs the CPU path", a.cpu(), b)
        t0 = time.perf_counter()
        sizes = []
        for f in range(n):
            e, p = feats.map(lambda x: x[f].cpu()).compact_indices()
            oe, op = oracle_extract(scans_np[f].astype(np.float64), lidar, fp)
            if e.tolist() != oe or p.tolist() != op:
                raise AssertionError(f"wide {label} frame {f}: {len(e)} / {len(p)} picks on the card, the f64 "
                                     f"oracle {len(oe)} / {len(op)}, not index-exact")
            sizes.append((len(e), len(p)))
        print(f"wide {label} ({n} frames, {S} sectors; sort {forms[0]}, NMS {forms[1]}): edges and planars "
              f"{sizes} equal to the CPU path and index-exact with the f64 oracle (oracle "
              f"{time.perf_counter() - t0:.1f} s of host time)")
        rows += _extraction_kernels(scans, lidar, fp, f"_wide_{label}")
    _print_kernels(rows)

    # the offline driver on 8 frames of 64x2083 under phase 3's gate
    lidar = T.LidarParams(64, 2083, 0.5, 120.0)
    fp = T.FeatureExtractionParams(precise_selection=True)
    scans_np, poses = render_trajectory(lidar, 8, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01, noise=0.005,
                                        seed=0, dtype=np.float32)
    gt = np.stack([t for (_, t) in poses])
    run = lambda: T.odometry_offline(scans_np, lidar, fp, rp, chunk_pairs=4, motion_init=True)
    traj, det = drive("wide_offline_64x2083", run, extraction + ("knn",), ("knn_dual",))
    ate, limit, _ = _check_trajectory("offline 64x2083", traj.translation, traj.rotation, 8, gt, ate_rmse)
    dt = _seconds_per_run(run, 3)
    print(f"offline 64x2083: ATE {ate:.6f} m (limit {limit:.6f} m); termination {det.termination.tolist()}; "
          f"{8 / dt:.3f} scans/s ({dt * 1e3:.3f} ms per 8-frame run, chunk_pairs=4) on {smi}")

    # the examples at their defaults, side by side on this card
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {ex: subprocess.Popen([sys.executable, os.path.join(root, "examples", ex)], cwd=root,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for ex in EXAMPLES}
    t0 = time.perf_counter()
    try:
        for ex, proc in procs.items():
            out = proc.communicate(timeout=600)[0]
            if proc.returncode != 0:
                raise AssertionError(f"example {ex} exited with {proc.returncode}:\n{out[-3000:]}")
            keep = [ln for ln in out.splitlines() if not ln.startswith(("  frame", "frame "))]
            print(f"example {ex} (defaults, on the card): " + " | ".join(keep))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"examples: all {len(EXAMPLES)} exited 0 in {time.perf_counter() - t0:.1f} s, side by side, on {smi}")
    return rows


def _leaves(tree) -> list:
    """The tensors of a driver's output, in order (NamedTuples, tuples and
    lists walked; other leaves skipped)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for part in tree for x in _leaves(part)]
    return []


def _profile_run(torch, run, units: int):
    """One ``torch.profiler`` trace of ``run``: wall ms, device kernel ms,
    the idle share, the host's launch calls (all of them, and inside the
    driver's loop over frames or chunks), ``cudaGraphLaunch`` calls and the
    host's reads of the device inside that loop a frame or chunk (``units``
    of them), the outer ICF iterations."""
    from torch.profiler import ProfilerActivity, profile

    from loam_tpu_torch import program
    from loam_tpu_torch.profiling import host_reads, kernel_times, launch_calls
    from loam_tpu_torch.registration import loop

    torch.cuda.synchronize()
    n0 = loop.iterations
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = sum(kernel_times(events).values()) / 1e3
    every, _ = launch_calls(events)
    _, inside = launch_calls(events, within=program.DRIVER_RANGE)
    reads = host_reads(events)
    return {"wall_ms": wall, "device_kernel_ms": device, "idle_share": 1 - device / wall,
            "kernel_us": kernel_times(events),
            "host_launch_calls": every, "host_launch_calls_in_driver_loop": inside,
            "graph_launches_per_unit": inside.get("cudaGraphLaunch", 0) / units,
            "host_reads_in_driver_loop": reads, "host_reads_per_unit": sum(reads.values()) / units,
            "loop_iterations": loop.iterations - n0}


def _device_span_ms(torch, run, reps: int = 2) -> float:
    """Mean device span of ``run`` by CUDA events, no profiler: from the
    call (the host's work before the first launch included) to its last
    kernel. For a graph with WHILE nodes this is the device figure to
    read: a ``torch.profiler`` trace does not count the kernels of a body
    once each time the body runs."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        run()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _back_to_back_ms(torch, run, reps: int = 3) -> float:
    """Mean ms a call of ``run`` called ``reps`` times back to back between
    two CUDA events, no sync between the calls: the host's work for a call
    overlaps the device's for the one before, and the device's runs follow
    each other on one stream, so this bounds a run's device time from
    above with no profiler attached."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    run()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_phase(torch, smi, frames, drive, path_launches, cells, reps) -> dict:
    """Phase 15: every driver at full width with one program a unit (a call
    of the trajectory drivers, a frame or a chunk of the others: one CUDA
    graph, the scans over chunks or frames and the ICF loop's later
    iterations under WHILE nodes, the keyframe insert under an IF node)
    against the same driver eager (``program.eager``: host branches and
    loops, the graphs' plain version): all output tensors bit-equal (poses,
    terminations, iteration counts, detail rows, maps, the prep cache),
    every kernel's launches and the outer ICF iterations equal; one
    ``cudaGraphLaunch`` and no host read a unit inside the driver's range;
    capture seconds, nodes and pool bytes a key; scans/s of both in turns
    (graph, eager, eager, graph); a trace of the graph run (host launch
    calls a run, device kernel ms, idle share) and its device span by CUDA
    events; for a trajectory call (one unit), a trace of the eager run too,
    whose device kernel ms are the same kernels', each counted."""
    from loam_tpu_torch.registration import loop

    out = {}
    for cell, (run, units, env, must, must_not, *opts) in cells.items():
        _stamp(f"phase 15: {cell}")
        # a cell's programs have conditional nodes unless it says they have
        # none; ``check`` holds the graph's output to its phase's gates;
        # ``rate``: a run is the 16 frames (scans/s), else another unit
        opts = opts[0] if opts else {}
        branches, check, rate = opts.get("branches", True), opts.get("check"), opts.get("rate", True)
        with _env(**env):
            loop.clear_cache()
            n0 = loop.iterations
            got = drive(f"graph_{cell}", run, must, must_not)
            n_graph = loop.iterations - n0
            if check is not None:
                check(got)
            stats = loop.graph_stats()
            if not stats or not all((g["if_nodes"] > 0) == branches for g in stats):
                raise AssertionError(f"{cell}: no program {'with' if branches else 'without'} conditional "
                                     f"nodes was captured: {stats}")
            with loop._eager():
                n0 = loop.iterations
                want = drive(f"eager_{cell}", run, must, must_not)
                n_eager = loop.iterations - n0
            if path_launches[f"graph_{cell}"] != path_launches[f"eager_{cell}"] or n_graph != n_eager:
                raise AssertionError(f"{cell}: launches {path_launches[f'graph_{cell}']}, {n_graph} ICF "
                                     f"iterations through the graphs; {path_launches[f'eager_{cell}']}, "
                                     f"{n_eager} eager")
            a, b = _leaves(got), _leaves(want)
            if len(a) != len(b):
                raise AssertionError(f"{cell}: {len(a)} output tensors through the graphs, {len(b)} eager")
            for i, (x, y) in enumerate(zip(a, b)):
                _require_equal(f"{cell} output tensor {i} (graph vs eager)", x, y)
            ms = []
            for graph in (True, False, False, True):
                with contextlib.nullcontext() if graph else loop._eager():
                    ms.append(_seconds_per_run(run, reps) * 1e3)
            row = {"units": units, "graph_ms": (ms[0] + ms[3]) / 2, "eager_ms": (ms[1] + ms[2]) / 2,
                   "turns_ms": ms, "icf_iterations": n_graph, "programs": loop.graph_stats()}
            row["graph_scans_s"], row["eager_scans_s"] = frames / row["graph_ms"] * 1e3, frames / row["eager_ms"] * 1e3
            # the trace of the graph run only: a trace's cost grows with its
            # events, and the eager run's scans/s are in the turns above
            pg = row["profile_graph"] = _profile_run(torch, run, units)
            row["graph_device_span_ms"] = _device_span_ms(torch, run)
            if units == 1:
                # no profiler: back-to-back graph calls bound the graph's
                # device time a run from above (one stream: runs cannot
                # overlap); the eager run's span from its call to its last kernel
                row["graph_back_to_back_ms"] = _back_to_back_ms(torch, run)
                with loop._eager():
                    row["profile_eager"] = _profile_run(torch, run, units)
                    row["eager_device_span_ms"] = _device_span_ms(torch, run)
                print(f"{cell} (eager): device kernels {row['profile_eager']['device_kernel_ms']:.3f} ms of "
                      f"{row['profile_eager']['wall_ms']:.3f} ms (profiler trace); by CUDA events: the eager "
                      f"run's device span {row['eager_device_span_ms']:.3f} ms, the graph's "
                      f"{row['graph_device_span_ms']:.3f} ms, the graph's calls back to back "
                      f"{row['graph_back_to_back_ms']:.3f} ms a run, on {smi}")
            print(f"{cell} (graph): {pg['graph_launches_per_unit']:.2f} cudaGraphLaunch and "
                  f"{pg['host_reads_per_unit']:.2f} host reads a unit inside the driver's range "
                  f"({units} units; launch calls there {pg['host_launch_calls_in_driver_loop']}, reads "
                  f"{pg['host_reads_in_driver_loop'] or 'none'}); {sum(pg['host_launch_calls'].values())} "
                  f"host launch calls a run; device kernels {pg['device_kernel_ms']:.3f} ms of "
                  f"{pg['wall_ms']:.3f} ms, idle share {pg['idle_share']:.4f}, on {smi}")
            if pg["graph_launches_per_unit"] != 1 or pg["host_reads_per_unit"] != 0:
                raise AssertionError(f"{cell}: {pg['graph_launches_per_unit']} cudaGraphLaunch and "
                                     f"{pg['host_reads_per_unit']} host reads a unit")
            out[cell] = row
            if not rate:
                del row["graph_scans_s"], row["eager_scans_s"]
            speed = (f"{row['graph_scans_s']:.3f} scans/s through the graphs, {row['eager_scans_s']:.3f} eager "
                     f"(turns graph/eager/eager/graph {', '.join(f'{x:.3f}' for x in ms)} ms a {frames}-frame "
                     f"run)" if rate else f"{row['graph_ms']:.3f} ms a call through the graph, "
                     f"{row['eager_ms']:.3f} eager (turns graph/eager/eager/graph "
                     f"{', '.join(f'{x:.3f}' for x in ms)} ms)")
            print(f"{cell}: graph vs eager bit-equal ({len(a)} output tensors), launches equal "
                  f"{path_launches[f'graph_{cell}']}, {n_graph} ICF iterations; {speed}; captured " + "; ".join(
                      f"{g['path']}: conditional nodes {g['conditional_nodes']}, {g['nodes']} nodes in "
                      f"{g['capture_s']:.3f} s, pool {g['pool_bytes']} B, {g['replays']} replays"
                      for g in row["programs"]) + f", on {smi}")
    return out


def _sharded_graph_phase(T, torch, dev, smi, scans, long, lidar, fp, rp, frames, drive, path_launches,
                         extraction, reps, pg64, gt1k, opt64) -> dict:
    """Phase 15's sharded cells, on a mesh of 4 shards of this GPU in a
    world-size-1 NCCL group (BASELINE config 5 cut to one card), each call
    one program: ``scan_to_map_step_sharded`` a frame (the sharded search's
    gathers inside the ICF loop's WHILE node, the sharded insert and its sum
    inside the keyframe's IF node), ``odometry_offline_sharded``,
    ``extract_features_sharded`` on a (2 data x 2 line) mesh and
    ``register_pairs_sharded`` (12 consecutive pairs of the frames) a call,
    and ``optimize_pose_graph_sharded`` on phase 11's float64 graph (its
    edges padded to a multiple of 4; the shards' sums inside the LM loop's
    WHILE node; within 1e-8 of phase 11's solve and 1e-5 m of the truth):
    through :func:`_graph_phase` against the same calls eager, then the
    scan-to-map and offline cells' graphs at 16 and 64 frames
    (:func:`_graph_size_phase`)."""
    from loam_tpu_torch import parallel
    from loam_tpu_torch.parallel.distributed import scan_to_map_init_sharded, scan_to_map_step_sharded
    from loam_tpu_torch.pose_graph import optimize_pose_graph_sharded

    cfg, s2m_reg = T.ScanToMapConfig(), T.default_map_reg_params()
    edges_p, _ = _padded_edges(torch, pg64[1], 4)

    def check_graph(out):
        opt, _ = out
        gap = max(_max_err(opt.translation, opt64.translation), _max_err(opt.rotation, opt64.rotation))
        err = _max_err(opt.translation.cpu(), gt1k.translation)
        if not (gap < ATOL_GRAPH and err < ATOL_GRAPH_TRUTH_M):
            raise AssertionError(f"posegraph-1000-sharded4: {gap} from phase 11's solve, {err} m from the truth")

    feats = T.extract_features_batch(scans, lidar, fp, post=T.registration.azimuth_sort_features)
    pairs = 12
    src, tgt = feats.map(lambda x: x[1:pairs + 1]), feats.map(lambda x: x[:pairs])
    ident = T.Pose3.identity(torch.float32, (pairs,), dev)
    no_knn = ("knn", "knn_dual")
    with _nccl_group() as group:
        mesh = parallel.make_mesh([dev] * 4, group=group)
        mesh22 = parallel.make_mesh([dev] * 4, line_axis=2, group=group)

        def run_s2m(x=scans, n=frames):
            # one program a frame, no host read between the frames
            st, out = scan_to_map_init_sharded(cfg, mesh), []
            for f in range(n):
                st, pose, det = scan_to_map_step_sharded(st, x[f], lidar, mesh, fp, s2m_reg, cfg)
                out.append((pose, det))
            return st, out

        run_off = lambda x=scans: parallel.odometry_offline_sharded(x, lidar, mesh, fp, rp)
        cells = {
            "s2m-64x1024-sharded4": (run_s2m, frames, dict(LOAM_ICF_DUAL_KNN="0"),
                                     extraction + ("knn", "peer_gather", "peer_sum"), ("knn_dual",)),
            "offline-64x1024-sharded4": (run_off, 1, dict(LOAM_ICF_DUAL_KNN="0"),
                                         extraction + ("knn", "peer_gather"), ("knn_dual",)),
            "extract-64x1024-2x2": (lambda: parallel.extract_features_sharded(scans, lidar, mesh22, fp), 1,
                                    dict(LOAM_ICF_DUAL_KNN="0"), extraction + ("peer_gather",), no_knn,
                                    dict(branches=False)),
            "pairs-64x1024-sharded4": (lambda: parallel.register_pairs_sharded(src, tgt, ident, mesh, rp), 1,
                                       dict(LOAM_ICF_DUAL_KNN="0"), ("knn", "peer_gather"),
                                       ("knn_dual",) + extraction),
            "posegraph-1000-sharded4": (lambda: optimize_pose_graph_sharded(pg64[0], edges_p, mesh, 10), 1, {},
                                        ("peer_sum",), no_knn + extraction + ("peer_gather",),
                                        dict(check=check_graph, rate=False)),
        }
        out = _graph_phase(torch, smi, frames, drive, path_launches, cells, reps)
        with _dual_knn(False):
            out["graph_size_sharded"] = _graph_size_phase(smi, {
                "s2m-64x1024-sharded4": {n: (lambda n=n: run_s2m(long, n)) for n in (16, 64)},
                "offline-64x1024-sharded4": {n: (lambda n=n: run_off(long[:n])) for n in (16, 64)},
            }, vary={"offline-64x1024-sharded4": "its pairs are one lockstep batch, and the kNN's split plan "
                     "(knn_cuda._splits: a merge kernel where the targets split) follows the pairs"})
        mesh.release()
        mesh22.release()
    return out


def _graph_size_phase(smi, cells, vary=None, unit=None, held=None, phase=15) -> dict:
    """A trajectory call's graph at several lengths (``cells``: cell ->
    {frames: run}; ``unit``: cell -> what a length counts where it is not
    frames, e.g. the pose graph's LM iterations), captured afresh at each:
    its nodes (bodies counted once), conditional nodes by type, capture
    seconds, pool bytes and ms a call (the mean of 2 replays after the
    capture); the nodes and conditional nodes required equal at every
    length, but for a cell of ``vary`` (cell -> why), whose nodes may follow
    the length: its conditional nodes are required equal and the reason is
    printed. ``held`` (cell -> f(output, frames)): the bytes the call must
    hold at that length, printed beside the pool, whose growth from the
    shortest length to the longest is held to ``POOL_GROWTH_RATIO`` times
    theirs plus ``POOL_SLACK_B``. Gates that fail raise after every cell
    is printed."""
    from loam_tpu_torch.registration import loop

    out, failed = {}, []
    for cell, runs in cells.items():
        rows = {}
        what = (unit or {}).get(cell, "frames")
        need = (held or {}).get(cell)
        for frames, run in runs.items():
            _stamp(f"phase {phase}: {cell} at {frames} {what}")
            loop.clear_cache()
            got = run()
            (g,) = loop.graph_stats()
            rows[frames] = {k: g[k] for k in ("nodes", "conditional_nodes", "capture_s", "pool_bytes")}
            beside = ""
            if need:
                rows[frames]["need_bytes"] = need(got, frames)
                beside = f" beside {rows[frames]['need_bytes']} B the call must hold"
            del got
            rows[frames]["ms_per_call"] = _seconds_per_run(run, 2) * 1e3
            print(f"{cell} at {frames} {what}: {g['nodes']} graph nodes, conditional nodes "
                  f"{g['conditional_nodes']}, captured in {g['capture_s']:.3f} s, pool {g['pool_bytes']} B"
                  f"{beside}, {rows[frames]['ms_per_call']:.3f} ms a call, on {smi}")
        why = (vary or {}).get(cell)
        sizes = {(None if why else r["nodes"], str(r["conditional_nodes"])) for r in rows.values()}
        if len(sizes) != 1:
            failed.append(f"{cell}: the graph's size depends on the {what}: {rows}")
        if why and len({r["nodes"] for r in rows.values()}) > 1:
            print(f"{cell}: the graph's nodes follow the frames: {why}")
        if need:
            n0, n1 = min(rows), max(rows)
            grow = rows[n1]["pool_bytes"] - rows[n0]["pool_bytes"]
            must = rows[n1]["need_bytes"] - rows[n0]["need_bytes"]
            print(f"{cell}: from {n0} to {n1} {what} the pool grew {grow} B ({grow / (n1 - n0):.0f} B a "
                  f"frame), what it must hold {must} B ({must / (n1 - n0):.0f} B a frame)")
            if grow > POOL_GROWTH_RATIO * must + POOL_SLACK_B:
                failed.append(f"{cell}: the pool grew {grow} B from {n0} to {n1} {what}, what it must hold "
                              f"{must} B")
        out[cell] = rows
    loop.clear_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def _keyframes(traj, config):
    """Scan-to-map's keyframe decisions, from a trajectory on the host (the
    rule of ``odometry.scan_to_map._frame``: the first frame, and each
    frame farther than ``keyframe_dist`` or turned more than
    ``keyframe_angle`` from the last keyframe): (F,) bools and the (F,)
    distances from the last keyframe."""
    t = traj.translation.cpu().double().numpy()
    q = traj.rotation.cpu().double().numpy()
    ins, dist = np.zeros(len(t), bool), np.zeros(len(t))
    ins[0], k = True, 0
    for f in range(1, len(t)):
        w1, x1, y1, z1 = q[k] * np.array([1.0, -1.0, -1.0, -1.0])
        w2, x2, y2, z2 = q[f]
        v = np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2, w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])
        w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
        dist[f] = np.linalg.norm(t[f] - t[k])
        if dist[f] > config.keyframe_dist or 2.0 * np.arctan2(np.linalg.norm(v), abs(w)) > config.keyframe_angle:
            ins[f], k = True, f
    return ins, dist


def _drive_phase(T, torch, dev, smi, drive_np, drive_gt, lidar, fp, rp, s2m_reg, s2m_cfg, grid_reg, drive,
                 extraction, knn_cuda, ate_rmse) -> dict:
    """Phase 16: the drive at a user's length, each call one program.
    ``odometry_offline`` (``chunk_pairs=4``, ``motion_init``) and
    ``scan_to_map_offline`` over the drive in float32 and in float64 (which
    takes the plain kNN on the card, as ``loam_tpu`` takes its plain search
    for float64; scan-to-map's float64 run starts from float64 maps and
    poses, ``scan_to_map_init(dtype=float64)``), and scan-to-map on the
    float64 scans from its default state, whose float32 maps its search
    and fits work in (the kernel), and float32 on the scans nudged by
    ``DRIVE_NUDGE_M``: every pair's relative pose within ``DRIVE_PAIR_M`` /
    ``DRIVE_PAIR_RAD`` of float64's for the float32 runs, and of float32's
    for the default-state run until the two runs' keyframe decisions
    (:func:`_keyframes`) part, after which their maps differ (the frame and
    both runs' distances from the last keyframe printed; the nudged run,
    printed only, shows how near the threshold the drive's decisions lie);
    the pairs whose termination codes differ named, the ATE gate for every
    run and the ATE within ``DRIVE_ATE_RATIO`` of the run it is held to
    where the keyframes never part; the maps' live slots, ``dropped`` 0,
    overflow (0, 0) and the kNN's visit share at the last frame. Then each
    whole-call program (offline-c4, s2m and s2m-grid) captured afresh at
    16, 64 and all the frames (:func:`_graph_size_phase`): graph nodes and
    conditional nodes equal at every length, and the pool growing no faster
    than what the call must hold (its outputs and the hoisted feature
    batch; ``POOL_GROWTH_RATIO``, ``POOL_SLACK_B``). Peak device memory and
    ms a call. Gates that fail raise after everything is printed."""
    from loam_tpu_torch.evaluation import relative_pose_gaps
    from loam_tpu_torch.registration import loop

    D = drive_np.shape[0]
    scans = torch.from_numpy(drive_np).to(dev)
    scans64 = scans.double()
    nudge = np.random.default_rng(7).normal(0.0, DRIVE_NUDGE_M, drive_np.shape)
    nudged = torch.from_numpy((drive_np + nudge).astype(np.float32)).to(dev)
    state64 = T.scan_to_map_init(s2m_cfg, dtype=torch.float64, lidar=lidar, feat_params=fp, device=dev)
    kernel = (extraction + ("knn",), ("knn_dual",))
    plain_knn = ((), ("knn", "knn_dual"))
    failed = []
    out = {"frames": D, "runs": {}, "pairs": {}, "sizes": {}}
    cells = {
        "offline_f32": (lambda: T.odometry_offline(scans, lidar, fp, rp, chunk_pairs=4, motion_init=True),
                        D, kernel),
        "offline_f64": (lambda: T.odometry_offline(scans64, lidar, fp, rp, chunk_pairs=4, motion_init=True),
                        D, plain_knn),
        "s2m_f32": (lambda: T.scan_to_map_offline(scans, lidar, fp, s2m_reg, s2m_cfg), D, kernel),
        "s2m_f64": (lambda: T.scan_to_map_offline(scans64, lidar, fp, s2m_reg, s2m_cfg, init_state=state64), D,
                    plain_knn),
        "s2m_f64_default": (lambda: T.scan_to_map_offline(scans64, lidar, fp, s2m_reg, s2m_cfg), D, kernel),
        "s2m_f32_nudged": (lambda: T.scan_to_map_offline(nudged, lidar, fp, s2m_reg, s2m_cfg), D, kernel),
    }
    res = {}
    with _dual_knn(False):
        for name, (run, n, (must, must_not)) in cells.items():
            _stamp(f"phase 16: {name}, {n} frames")
            loop.clear_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            got = drive(f"drive_{name}", run, must, must_not)
            first_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - held
            (g,) = [x for x in loop.graph_stats() if x["path"] in ("odometry_offline", "scan_to_map_offline")]
            state, traj, det = got if name.startswith("s2m") else (None, *got)
            ate, limit, _ = _check_trajectory(f"drive {name}", traj.translation, traj.rotation, n,
                                              drive_gt[:n], ate_rmse)
            row = {"frames": n, "ate_m": ate, "ate_limit_m": limit, "first_call_s": first_s,
                   "peak_bytes": peak, "pool_bytes": g["pool_bytes"], "nodes": g["nodes"],
                   "conditional_nodes": g["conditional_nodes"], "capture_s": g["capture_s"],
                   "iterations": int(det.num_iterations.sum())}
            res[name] = (state, traj, det)
            if state is not None:
                info = det.iteration_info
                row.update(edge_live=int(state.edge_map.size), edge_slots=state.edge_map.points.shape[0],
                           planar_live=int(state.planar_map.size), planar_slots=state.planar_map.points.shape[0],
                           dropped=int(state.dropped), overflow=[int(info.edge_knn_overflow.sum()),
                                                                 int(info.plane_knn_overflow.sum())])
                if row["dropped"] != 0 or row["overflow"] != [0, 0]:
                    failed.append(f"{name}: dropped {row['dropped']}, overflow {row['overflow']}")
            out["runs"][name] = row
            maps = (f"; maps {row['edge_live']} / {row['edge_slots']} edge, {row['planar_live']} / "
                    f"{row['planar_slots']} planar slots live, dropped {row['dropped']}, overflow "
                    f"{tuple(row['overflow'])}" if state is not None else "")
            print(f"drive {name}: {n} frames of 64x1024, ATE {ate:.6f} m (limit {limit:.6f} m), "
                  f"{row['iterations']} ICF iterations, first call {first_s:.3f} s (capture "
                  f"{g['capture_s']:.3f} s); pool {g['pool_bytes']} B, {g['nodes']} nodes, conditional "
                  f"nodes {g['conditional_nodes']}; peak device memory {peak} B above the {held} B held "
                  f"before{maps}, on {smi}")

    # F6 per pair: float32 against float64, every pair; scan-to-map's
    # float64 scans from the default state (float32 maps, which its search
    # and fits work in) against float32, every pair until the two runs'
    # keyframes part (after, the maps differ), and against float64, printed;
    # float32 on scans nudged by DRIVE_NUDGE_M against float32, printed
    keyframes = {name: _keyframes(r[1], s2m_cfg) for name, r in res.items() if r[0] is not None}
    for label, a_name, b_name, gate in (("offline", "offline_f32", "offline_f64", "every pair"),
                                        ("s2m", "s2m_f32", "s2m_f64", "every pair"),
                                        ("s2m-default-f64", "s2m_f64_default", "s2m_f32", "until keyframes part"),
                                        ("s2m-default-f64 vs f64", "s2m_f64_default", "s2m_f64", None),
                                        ("s2m-nudged", "s2m_f32_nudged", "s2m_f32", None)):
        a, b = res[a_name], res[b_name]
        n = min(a[1].translation.shape[0], b[1].translation.shape[0])
        ta, qa = a[1].translation.cpu().double().numpy()[:n], a[1].rotation.cpu().double().numpy()[:n]
        tb, qb = b[1].translation.cpu().double().numpy()[:n], b[1].rotation.cpu().double().numpy()[:n]
        dt, ang = relative_pose_gaps(ta, qa, tb, qb)
        nt = np.linalg.norm(dt, axis=1)
        absgap = np.linalg.norm(ta - tb, axis=1)
        # the terminations of the pairs (offline) or frames (scan-to-map) both runs made
        m = min(len(a[2].termination), len(b[2].termination))
        term_a, term_b = a[2].termination.cpu().numpy()[:m], b[2].termination.cpu().numpy()[:m]
        differ = np.flatnonzero(term_a != term_b).tolist()
        # offline's i-th code is pair (i, i + 1)'s, scan-to-map's f-th frame f's: pair (f - 1, f)
        first = 0 if label == "offline" else -1
        ate_a, ate_b = ate_rmse(ta, drive_gt[:n], align=False), ate_rmse(tb, drive_gt[:n], align=False)
        # the first frame whose keyframe decision differs: its pose comes
        # before the insert, so pairs up to (split - 1, split) share the maps
        split = None
        if a_name in keyframes:
            ka, kb = keyframes[a_name][0][:n], keyframes[b_name][0][:n]
            parted = np.flatnonzero(ka != kb)
            split = int(parted[0]) if parted.size else None
        row = {"runs": [a_name, b_name], "frames": n, "translation_max_m": float(nt.max()),
               "translation_median_m": float(np.median(nt)),
               "rotation_max_rad": float(ang.max()), "rotation_median_rad": float(np.median(ang)),
               "mean_gap_vector_m": dt.mean(axis=0).tolist(),
               "absolute_gap_m": {f: float(absgap[:f].max()) for f in (64, 128, 256) if f <= n},
               "termination_differs": [{"pair": [i + first, i + first + 1], a_name: int(term_a[i]),
                                        b_name: int(term_b[i]),
                                        "translation_m": float(nt[i + first]) if i + first >= 0 else 0.0,
                                        "rotation_rad": float(ang[i + first]) if i + first >= 0 else 0.0}
                                       for i in differ],
               "ate_a_m": ate_a, "ate_b_m": ate_b, "ate_ratio": ate_a / ate_b, "keyframes_part_at": split}
        parted = ""
        if split is not None:
            da, db = keyframes[a_name][1][split], keyframes[b_name][1][split]
            row["keyframe_distance_at_split_m"] = [float(da), float(db)]
            row["before_split"] = {"translation_max_m": float(nt[:split].max()) if split else 0.0,
                                   "rotation_max_rad": float(ang[:split].max()) if split else 0.0}
            parted = (f"; keyframes part at frame {split} (distance since the last keyframe {da:.6f} m in "
                      f"{a_name}, {db:.6f} m in {b_name}, threshold {s2m_cfg.keyframe_dist} m): before it "
                      f"translation max {row['before_split']['translation_max_m']:.4e} m, rotation max "
                      f"{row['before_split']['rotation_max_rad']:.4e} rad")
        out["pairs"][label] = row
        limits = gate is not None
        worst = int(np.argmax(nt / DRIVE_PAIR_M + ang / DRIVE_PAIR_RAD))
        print(f"drive {label} per pair, {a_name} vs {b_name} over {n} frames ({n - 1} pairs; gated: "
              f"{gate or 'no'}): translation max {row['translation_max_m']:.4e} m, median "
              f"{row['translation_median_m']:.4e} m (limit {DRIVE_PAIR_M if limits else 'none'}); rotation max "
              f"{row['rotation_max_rad']:.4e} rad, median {row['rotation_median_rad']:.4e} rad (limit "
              f"{DRIVE_PAIR_RAD if limits else 'none'}); mean gap vector "
              f"({', '.join(f'{x * 1e3:.4f}' for x in row['mean_gap_vector_m'])}) mm; largest absolute gap "
              + ", ".join(f"{v:.4e} m by frame {f}" for f, v in row["absolute_gap_m"].items())
              + f"; ATE {a_name} {ate_a:.6f} m, {b_name} {ate_b:.6f} m (ratio {row['ate_ratio']:.4f}); "
              f"termination codes differ at {len(differ)} of {m}: {row['termination_differs'] or 'none'}; "
              f"worst pair ({worst}, {worst + 1}){parted}")
        if gate is None:
            continue
        upto = n - 1 if gate == "every pair" or split is None else split
        bad = np.flatnonzero((nt[:upto] > DRIVE_PAIR_M) | (ang[:upto] > DRIVE_PAIR_RAD)).tolist()
        if bad:
            failed.append(f"{label}: pairs past the per-pair tolerance: "
                          + ", ".join(f"{i}->{i + 1} {nt[i]:.3e} m {ang[i]:.3e} rad" for i in bad))
        if upto == n - 1 and abs(row["ate_ratio"] - 1) > DRIVE_ATE_RATIO:
            failed.append(f"{label}: {a_name} ATE {ate_a} m against {b_name}'s {ate_b} m")

    # the kNN's visit share at the last frame: its planar queries at the
    # final pose against the final planar map, the cold seed bound
    st, traj = res["s2m_f32"][0], res["s2m_f32"][1]
    last = T.registration.spatial_sort_features(T.extract_features(scans[-1], lidar, fp))
    pose = T.Pose3(traj.rotation[-1], traj.translation[-1])
    q = pose.act(last.planar_points)[None].contiguous()
    prep = knn_cuda.knn_prep(st.planar_map.points[None], st.planar_map.mask[None])
    k = s2m_reg.num_plane_neighbors
    _, visits = knn_cuda.knn_run(prep, q, k, s2m_reg.max_plane_neighbor_dist,
                                 query_mask=last.planar_mask[None].contiguous(), return_visits=True,
                                 seed_window=True)
    live = knn_cuda._plain_visits(prep.n_live, prep.tt, q.shape[1], k)
    out["last_frame_visit_share"] = int(visits.sum()) / max(int(live.sum()), 1)
    print(f"drive s2m_f32: the last frame's planar search visits {int(visits.sum())} of {int(live.sum())} "
          f"live boxes (share {out['last_frame_visit_share']:.4f}; phase 2's mapfull, every slot live, "
          f"is the dense case) against {int(st.planar_map.size)} live map slots")

    # each whole-call program at 16, 64 and all the frames: its size, and
    # its pool against what it must hold: its outputs (the trajectory and
    # the details) and the hoisted feature batch
    per_frame = _nbytes(*_leaves(T.extract_features_batch(scans[:1], lidar, fp)))
    calls = {
        "offline-64x1024-c4": lambda n: T.odometry_offline(scans[:n], lidar, fp, rp, chunk_pairs=4,
                                                           motion_init=True),
        "s2m-64x1024": lambda n: T.scan_to_map_offline(scans[:n], lidar, fp, s2m_reg, s2m_cfg)[1:],
        "s2m-64x1024-grid": lambda n: T.scan_to_map_offline(scans[:n], lidar, fp, grid_reg, s2m_cfg)[1:],
    }
    held = {cell: (lambda got, n: _nbytes(*_leaves(got)) + per_frame * n) for cell in calls}
    try:
        with _dual_knn(False):
            out["sizes"] = _graph_size_phase(
                smi, {cell: {n: (lambda n=n, call=call: call(n)) for n in (*DRIVE_SIZES, D)}
                      for cell, call in calls.items()}, held=held, phase=16)
    except AssertionError as e:
        failed.append(str(e))
    print(json.dumps({"drive": out}))
    if failed:
        raise AssertionError("phase 16: " + "; ".join(failed))
    return out


# ---- phase 17: one rank a card ---------------------------------------------------------

# a rank's wall-clock limit in phase 17: past it every rank is killed and the
# phase fails, naming the rank and its last stamp (a rank whose control flow
# parted from the others' would wait in a collective with no watchdog)
RANKS_TIMEOUT_S = 600
# a rank's NCCL watchdog: a collective launched outside a graph that has not
# completed after this long aborts its communicator and ends the rank with
# the collective's name (phase 17's ranks)
RANKS_COLLECTIVE_TIMEOUT_S = 120
# a probe case's wall-clock limit, and its ranks' NCCL watchdog
PROBE_TIMEOUT_S = 45
PROBE_COLLECTIVE_TIMEOUT_S = 60
# register_pairs_sharded's pairs in phase 17: a multiple of every rank count
# up to 8
RANKS_PAIRS = 8
# phase 17's cells, in the order they run
RANKS_CELLS = ("s2m", "offline", "extract", "pairs", "posegraph")


def _host_splits(world: int) -> dict:
    """Phase 17's meshes across hosts on ``world`` ranks of this machine,
    by name (hosts x ranks a host): one host label a rank
    (``make_mesh(hosts=)``), the ranks of a label an island over NVLink,
    every other rank across the proxy over loopback TCP. Hosts of two
    ranks (from 4 ranks on) and hosts of one."""
    if world < 2:
        return {}
    out = {f"{world // 2}x2": [r // 2 for r in range(world)]} if world >= 4 else {}
    out[f"{world}x1"] = list(range(world))
    return out


def _rank_count(torch) -> int:
    """Phase 17's ranks: the largest power of two no greater than
    ``min(torch.cuda.device_count(), 8)``."""
    return 1 << (min(torch.cuda.device_count(), 8).bit_length() - 1)


def _primary_contexts() -> list:
    """The cards on which this process holds an active CUDA primary context
    (the driver API's ``cuDevicePrimaryCtxGetState``)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_int()
    if cu.cuDeviceGetCount(ctypes.byref(count)) != 0:
        raise RuntimeError("cuDeviceGetCount failed")
    held = []
    for j in range(count.value):
        dev, flags, active = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
        if cu.cuDeviceGet(ctypes.byref(dev), j) != 0 or cu.cuDevicePrimaryCtxGetState(
                dev, ctypes.byref(flags), ctypes.byref(active)) != 0:
            raise RuntimeError(f"cuDevicePrimaryCtxGetState failed for card {j}")
        if active.value:
            held.append(j)
    return held


def _stamper(out_dir: str, name: str, rank: int):
    """A rank's ``stamp(what)``: prints its progress and keeps the last line
    in ``<name><rank>.stamp``, where the parent names it if the rank fails."""
    t0 = time.perf_counter()

    def stamp(what):
        line = f"[{name} {rank}, {time.perf_counter() - t0:.1f} s] {what}"
        print(line, flush=True)
        with open(os.path.join(out_dir, f"{name}{rank}.stamp"), "w") as f:
            f.write(line)

    return stamp


def _rank_group(torch, rank: int, world: int, port: int, timeout_s: int):
    """The README's recipe for rank ``rank`` of ``world``: ``cuda:<rank>``
    current and an NCCL group made eagerly on it (``device_id``), whose
    collectives launched outside a graph abort after ``timeout_s``. Returns
    the rank's device."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: bootstrap on the loopback
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            device_id=dev, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _probe_worker(case: str, rank: int, world: int, port: int, out_dir: str) -> int:
    """One throwaway rank of the collective probe's ``case``. NCCL's cases,
    the record of why the port gathers with its own kernel: ``"while"`` and
    ``"if"``: after ``make_mesh``'s eager gather, one NCCL
    ``all_gather_into_tensor`` captured into the body of a WHILE node
    (``program.while_loop``, 3 and 2 iterations) or an IF node
    (``program.when``, taken and not), replayed 3 times and checked;
    ``"side_first"``: this rank's first gather on a side stream, then one
    captured into a plain CUDA graph, replayed twice and checked. The
    kernel's cases, ``"peer_while"``, ``"peer_if"`` and ``"peer_plain"``:
    ``collectives.gather`` (the gather over peer memory) of a random block
    of this rank captured in the same WHILE and IF bodies and in a plain
    graph, each replay's output bit-equal to NCCL's eager gather of the
    same blocks; past one rank ``"peer_plain"`` then gathers a block past
    the mailbox, which must raise inside a capture, grow the mailbox
    eagerly and equal NCCL's, and replays the graph captured before. A
    refusal raises and ends the rank: its error is the case's record.
    ``"peer_bodies@across"``: the kernel's WHILE and IF cases on each mesh
    across hosts of :func:`_host_splits`, one after another."""
    import torch
    import torch.distributed as dist

    from loam_tpu_torch import parallel, program
    from loam_tpu_torch.ops.peer_cuda import peer_gather_reference
    from loam_tpu_torch.parallel import collectives

    stamp = _stamper(out_dir, f"probe_{case}_", rank)
    stamp("init_process_group")
    dev = _rank_group(torch, rank, world, port, PROBE_COLLECTIVE_TIMEOUT_S)
    case, _, split = case.partition("@")
    x = torch.full((1, 4), float(rank + 1), device=dev)
    total = 4.0 * world * (world + 1) / 2  # the sum of every rank's x
    peer = case.startswith("peer_")
    if peer:
        mesh = parallel.make_mesh(group=dist.group.WORLD)
        x = torch.randn((2, 3001), generator=torch.Generator(dev).manual_seed(rank), device=dev)
        want = torch.empty((2 * world, 3001), device=dev)
        dist.all_gather_into_tensor(want, x)

    def gathered(xb):
        if peer:
            return collectives.gather(mesh, xb)
        out = torch.empty((world, 4), device=dev)
        dist.all_gather_into_tensor(out, xb)
        return out.sum()

    if case == "peer_plain":
        stamp("the kernel's gather in a plain graph: capture and replays")
        out = torch.zeros_like(want)
        out.copy_(gathered(x))  # the eager warm-up
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out.copy_(gathered(x))
        got, nodes = [], {"if": 0, "while": 0}
        for _ in range(3):
            out.zero_()
            graph.replay()
            got.append(torch.equal(out, want))
        want_got = [True] * 3
        if world > 1:
            stamp("a gather past the mailbox: in a capture, then eager, then the earlier graph again")
            big = torch.randn((1, mesh.peer.cap // 4 + 1), generator=torch.Generator(dev).manual_seed(rank),
                              device=dev)
            try:
                with torch.cuda.graph(torch.cuda.CUDAGraph()):
                    gathered(big)
                raised = "no error"
            except RuntimeError as err:
                raised = "inside a capture" in str(err)
            grown = torch.equal(gathered(big), peer_gather_reference(big, mesh.group))
            out.zero_()
            graph.replay()  # captured on the first mailbox, which the mesh keeps
            got += [raised, grown, torch.equal(out, want)]
            want_got += [True] * 3
    elif case == "side_first":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        stamp("the first gather, on a side stream")
        with torch.cuda.stream(side):
            first = gathered(x)
        torch.cuda.current_stream(dev).wait_stream(side)
        got = [float(first)]
        stamp("a plain graph")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = gathered(x)
        for _ in range(2):
            graph.replay()
            got.append(float(y))
        want_got, nodes = [total] * 3, None
    else:
        if not peer:
            parallel.make_mesh(group=dist.group.WORLD)

        def bodies(kind):
            """(what the replays gave, what they must give, the conditional
            nodes) of a gather in a ``kind`` body on ``mesh``."""
            def fn(bufs):
                xb, n = bufs
                # NCCL's cases: the sum of the gathers; the kernel's: the last
                # gather and how many ran
                acc = torch.zeros((), device=dev)
                out = torch.zeros_like(want) if peer else None
                record = (lambda: (out.copy_(gathered(xb)), acc.add_(1))) if peer else \
                    (lambda: acc.add_(gathered(xb)))
                if kind == "while":
                    i = torch.zeros((), dtype=torch.int64, device=dev)
                    going = i < n

                    def body():
                        record()
                        i.add_(1)
                        going.copy_(i < n)

                    program.while_loop(going, body)
                else:
                    program.when(n > 2, record)
                return (acc, out) if peer else acc

            count = lambda k: torch.full((), k, dtype=torch.int64, device=dev)
            prog = program.Program(dev, (x, count(3)))
            stamp(f"a {'kernel' if peer else 'NCCL'} gather in a {kind.upper()} body: capture and replays")
            ran = lambda k: (k if kind == "while" else int(k > 2))
            got = []
            for k in (3, 2, 3):  # read each replay's output before the next overwrites it
                res = prog.run(fn, (x, count(k)))
                if peer:
                    acc, out = res
                    got.append((int(acc), torch.equal(out, want) if ran(k) else not out.any()))
                else:
                    got.append(float(res))
            want_got = [(ran(k), True) if peer else ran(k) * total for k in (3, 2, 3)]
            nodes = prog.conditional if prog.graph is not None else None
            if nodes != dict({"if": 0, "while": 0}, **{kind: 1}):
                raise AssertionError(f"probe {case}: conditional nodes {nodes}")
            return got, want_got, nodes

        if split == "across":  # a WHILE body, then an IF body, on each mesh across hosts
            got, want_got = [], []
            for name, labels in _host_splits(world).items():
                mesh.release()
                mesh = parallel.make_mesh(group=dist.group.WORLD, hosts=labels)
                for kind in ("while", "if"):
                    stamp(f"across hosts {name}")
                    g, w, nodes = bodies(kind)
                    got, want_got = got + [(name, kind, g)], want_got + [(name, kind, w)]
        else:
            got, want_got, nodes = bodies(case.removeprefix("peer_"))
    if got != want_got:
        raise AssertionError(f"probe {case}: got {got}, want {want_got}")
    if peer:
        mesh.release()  # its buffers, which the other ranks map, freed after every rank's last read
    # a refusal above ends the rank with its group alive: NCCL aborts it at exit
    dist.destroy_process_group()
    stamp("accepted" if nodes is not None else "completed")
    return 0


def _start_ranks(argv: list, name: str, world: int, out_dir: str, limit_s: int, tail=()) -> list:
    """``world`` copies of this script, ``argv + [rank, world, port,
    out_dir] + tail`` each, logging to ``<name><rank>.log``; waits for all, and
    past ``limit_s``, or once one fails, kills every rank still running.
    Returns per rank (exit code, None where killed; its last stamp; the end
    of its log)."""
    port = _free_port()
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    here = os.path.abspath(__file__)
    logs = [open(os.path.join(out_dir, f"{name}{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, here] + argv + [str(r), str(world), str(port), out_dir]
                              + list(tail),
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=os.path.dirname(here))
             for r in range(world)]
    deadline = time.perf_counter() + limit_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes) or time.perf_counter() > deadline:
                break
            if any(c not in (None, 0) for c in codes):
                time.sleep(2.0)  # the others' own errors, where they have one
                codes = [p.poll() for p in procs]
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for f in logs:
            f.close()
    out = []
    for r, c in enumerate(codes):
        stamp_path = os.path.join(out_dir, f"{name}{r}.stamp")
        last = open(stamp_path).read() if os.path.exists(stamp_path) else "no stamp"
        out.append((c, last, open(os.path.join(out_dir, f"{name}{r}.log")).read()[-3000:]))
    return out


def _probe_case(case: str, world: int, out_dir: str) -> str:
    """The collective probe's ``case`` on ``world`` throwaway ranks: what
    happened, as rank 0 saw it (``"accepted"``, ``"completed"``, the error
    that ended it, or where it hung)."""
    ends = _start_ranks(["--probe-worker", case], f"probe_{case}_", world, out_dir, PROBE_TIMEOUT_S)
    code, last, tail = ends[0]
    if code == 0:
        return last.rsplit("] ", 1)[-1]
    if code is None:
        return f"hung: killed after {PROBE_TIMEOUT_S} s at \"{last.rsplit('] ', 1)[-1]}\""
    errors = [ln.strip() for ln in tail.splitlines() if re.search(r"\b\w*(Error|Exception)\b:", ln)]
    return f"raised at \"{last.rsplit('] ', 1)[-1]}\": {errors[-1] if errors else f'exit code {code}'}"


def _rank_cells(T, torch, mesh, scans, lidar, fp, rp, graph, cells=RANKS_CELLS):
    """Phase 17's calls on ``mesh`` at full width: ``{cell: (run, units,
    kernels it must launch)}``, every one a program whose gathers are the
    kernel's over peer memory. ``graph``: the pose graph's (initial, edges)
    on the mesh's card, its edges padded to a multiple of the shards.
    ``cells``: those to run."""
    from loam_tpu_torch import parallel
    from loam_tpu_torch.parallel.distributed import scan_to_map_init_sharded, scan_to_map_step_sharded
    from loam_tpu_torch.pose_graph import optimize_pose_graph_sharded
    from loam_tpu_torch.registration import azimuth_sort_features

    cfg, s2m_reg = T.ScanToMapConfig(), T.default_map_reg_params()
    frames = scans.shape[0]

    def s2m():
        st, out = scan_to_map_init_sharded(cfg, mesh), []
        for f in range(frames):
            st, pose, det = scan_to_map_step_sharded(st, scans[f], lidar, mesh, fp, s2m_reg, cfg)
            out.append((pose, det))
        return st, out

    feats = T.extract_features_batch(scans, lidar, fp, post=azimuth_sort_features)
    src = feats.map(lambda x: x[1:RANKS_PAIRS + 1])
    tgt = feats.map(lambda x: x[:RANKS_PAIRS])
    ident = T.Pose3.identity(torch.float32, (RANKS_PAIRS,), mesh.device)
    extraction = ("sector_sort", "greedy_nms", "select_points")
    every = {
        "s2m": (s2m, frames, extraction + ("knn", "peer_gather", "peer_sum")),
        "offline": (lambda: parallel.odometry_offline_sharded(scans, lidar, mesh, fp, rp), 1,
                    extraction + ("knn", "peer_gather")),
        "extract": (lambda: parallel.extract_features_sharded(scans, lidar, mesh, fp), 1,
                    extraction + ("peer_gather",)),
        "pairs": (lambda: parallel.register_pairs_sharded(src, tgt, ident, mesh, rp), 1, ("knn", "peer_gather")),
        "posegraph": (lambda: optimize_pose_graph_sharded(*graph, mesh, 10), 1, ("peer_sum",)),
    }
    return {cell: every[cell] for cell in cells}


def _noise(torch, tree, g):
    """A tree of the same shapes and dtypes as ``tree``, random from the
    generator ``g`` (NamedTuples kept, ``None`` leaves too)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        parts = [_noise(torch, x, g) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    dev = tree.device
    if tree.dtype == torch.bool:
        return torch.rand(tree.shape, generator=g, device=dev) > 0.5
    if tree.is_floating_point():
        return torch.randn(tree.shape, generator=g, dtype=tree.dtype, device=dev)
    return torch.randint(-2**31, 2**31 - 1, tree.shape, generator=g, dtype=torch.int64, device=dev).to(tree.dtype)


def _peer_shapes(T, torch, mesh, scans, lidar, fp, nodes: int = 1000) -> dict:
    """The collectives of the sharded cells at their own shapes on ``mesh``
    (``L`` = this rank's shards), ``{name: (kind, tensor or tree)}``,
    random, seeded by this rank's first shard: the ICF's sharded search's
    indices (L, k, Q) int32 and values (L, 4, k, Q) float32 for a 64x1024
    frame's planar and edge slots, and the planar pair as one tree
    (``distributed._shard_search``); a frame's features a shard, as
    ``odometry_offline_sharded`` gathers its heads; a registration's poses
    and details for L pairs, as offline and the pairs gather them; the pose
    graph's normal matrix (L, 6 nodes, 6 nodes) float64 gathered (the
    large gather's row) and summed, and its right-hand side (L, 6 nodes) summed
    (``optimize_pose_graph_sharded``)."""
    from loam_tpu_torch.registration import azimuth_sort_features

    L, dev = len(mesh.shard_ids), mesh.device
    feats = azimuth_sort_features(T.extract_features_batch(scans[:L + 1], lidar, fp))
    reg = T.default_map_reg_params()
    g = torch.Generator(dev).manual_seed(mesh.shard_ids[0])
    out = {}
    for cls, Q, k in (("planar", feats.planar_mask.shape[1], reg.num_plane_neighbors),
                      ("edge", feats.edge_mask.shape[1], reg.num_edge_neighbors)):
        out[f"knn_{cls}_idx"] = ("gather", torch.randint(0, 2**31 - 1, (L, k, Q), generator=g, dtype=torch.int32,
                                                         device=dev))
        out[f"knn_{cls}_val"] = ("gather", torch.randn((L, 4, k, Q), generator=g, device=dev))
    out["search_planar"] = ("gather", (out["knn_planar_idx"][1], out["knn_planar_val"][1]))
    out["heads"] = ("gather", _noise(torch, feats.map(lambda x: x[:L]), g))
    src, tgt = feats.map(lambda x: x[1:L + 1]), feats.map(lambda x: x[:L])
    pose, detail = T.register_features_batch(src, tgt, T.Pose3.identity(torch.float32, (L,), dev),
                                             T.RegistrationParams(search_backend="bruteforce"),
                                             reorder_mode="none")
    out["details"] = ("gather", _noise(torch, (pose, detail), g))
    H = torch.randn((L, 6 * nodes, 6 * nodes), generator=g, dtype=torch.float64, device=dev)
    out["H"] = ("gather", H)
    out["sum_H"] = ("sum", H)
    out["sum_b"] = ("sum", torch.randn((L, 6 * nodes), generator=g, dtype=torch.float64, device=dev))
    return out


def _graph_nodes(torch, fn) -> int:
    """The nodes of a CUDA graph that captures ``fn`` alone (after an eager
    warm-up)."""
    import ctypes

    from loam_tpu_torch.ops import _build

    fn()
    torch.cuda.synchronize()
    stream, n = torch.cuda.Stream(), ctypes.c_size_t()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
        err = _build.lib().loam_capture_nodes(stream.cuda_stream, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"counting a graph's nodes failed with cudaError_t {err}")
    torch.cuda.synchronize()
    return n.value


def _peer_check(torch, mesh, shapes: dict, reps: int, big: int = 2) -> dict:
    """Each of ``shapes`` through the kernel (``collectives.gather`` of the
    tensor or tree, ``collectives.sum``) and through its plain version
    (``peer_gather_reference``: NCCL's eager ``all_gather_into_tensor`` a
    leaf; ``peer_sum_reference``: that gather, then the adds in global shard
    order): whether they are bit-equal, ms a call of each back to back, us
    a call of each inside a plain CUDA graph of 20 (the normal matrix: 2)
    replayed (CUDA events), and the kernel's graph nodes when captured
    alone. A sum also: the bytes its eager call allocated at its peak
    beside its output's, and the library's yardstick timed (``x.sum(0)``
    at world size 1, where ``all_reduce`` adds nothing; ``dist.all_reduce``
    of one block past one rank; another order of adds, so never compared).
    Host us: a kernel call enqueued, no sync (:func:`_host_us`). A row past
    64 MB: ``big`` calls captured into the graph (at 1, replayed once), and
    as many host calls."""
    import torch.distributed as dist

    from loam_tpu_torch.ops.peer_cuda import peer_gather_reference, peer_sum_reference
    from loam_tpu_torch.parallel import collectives

    rows = {}
    for name, (kind, x) in shapes.items():
        leaves = _leaves(x)
        if kind == "gather":
            kernel = lambda x=x: collectives.gather(mesh, x)
            plain = lambda x=x: peer_gather_reference(_leaves(x), mesh.group)
            what = (f"{str(x.dtype).removeprefix('torch.')} {tuple(x.shape)}" if len(leaves) == 1 else
                    f"a tree of {len(leaves)} leaves")
        else:
            kernel = lambda x=x: collectives.sum(mesh, x)
            plain = lambda x=x: peer_sum_reference(x, mesh.group)
            what = f"the sum of {str(x.dtype).removeprefix('torch.')} {tuple(x.shape)}"
        a, b = _leaves(kernel()), _leaves(plain())
        torch.cuda.synchronize()
        nbytes = _nbytes(*leaves)
        row = {"kind": kind, "what": what, "shape": list(leaves[0].shape), "leaves": len(leaves),
               "dtype": str(leaves[0].dtype).removeprefix("torch."), "bytes": nbytes, "L": leaves[0].shape[0],
               "equal": len(a) == len(b) and all(p.dtype == q.dtype and torch.equal(p, q) for p, q in zip(a, b))}
        del a, b
        n = big if nbytes > 64 << 20 else 20
        replays = 1 if n == 1 else 3
        row.update(ms=_time_ms(kernel, reps), plain_ms=_time_ms(plain, reps),
                   graph_us=_graph_ms(kernel, n, replays) * 1e3, plain_graph_us=_graph_ms(plain, n, replays) * 1e3,
                   graph_nodes=_graph_nodes(torch, kernel), host_us=_host_us(kernel, 2 * n if n < 20 else 100))
        if kind == "gather":
            row.update(library_ms=row["plain_ms"], library_graph_us=row["plain_graph_us"])
        else:
            block = x[0].clone()
            if dist.get_world_size(mesh.group) > 1:
                library = lambda: dist.all_reduce(block, group=mesh.group)
            else:  # one rank: all_reduce adds nothing; the sum of its L blocks is x.sum(0)
                library = lambda x=x: x.sum(0)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernel()
            torch.cuda.synchronize()
            row.update(library_ms=_time_ms(library, reps), library_graph_us=_graph_ms(library, n, 3) * 1e3,
                       peak_bytes=torch.cuda.max_memory_allocated() - before, out_bytes=nbytes // row["L"])
            del block
        rows[name] = row
    return rows


def _rank_runs(torch, cells, counters, reps, stamp, traced=True) -> tuple:
    """Each of ``cells`` on its mesh: a counted first run (every counter at
    0 just before, read just after; the kernels it must launch, and never
    the dual kNN), where ``traced`` and the cell is one program a
    ``torch.profiler`` run
    (``cudaGraphLaunch`` calls and host reads a unit inside
    ``program.DRIVER_RANGE``), then ms a run over ``reps`` after a warm-up.
    Where the pose graph follows scan-to-map, the frames run once more at
    the end and must equal their first run (their program replayed after
    the pose graph's larger gathers grew the mesh's mailbox). Returns (the
    first run's output tensors on the host, a cell's a list, scan-to-map's
    maps under ``"s2m_maps"``; a row a cell; the trajectories' summary)."""

    def s2m_leaves(got):
        # this rank's rows of the maps, apart: the ranks' rows in rank order
        # are the maps of 1 rank x N shards
        st, out = got
        maps = (st.edge_map.points, st.edge_map.mask, st.planar_map.points, st.planar_map.mask)
        rest = (st._replace(edge_map=st.edge_map._replace(points=None, mask=None),
                            planar_map=st.planar_map._replace(points=None, mask=None)), out)
        return [x.cpu() for x in maps], [x.cpu() for x in _leaves(rest)]

    outputs, rows, summary = {}, {}, {}
    for cell, (run, units, must) in cells.items():
        stamp(f"{cell}: first run")
        for fn in counters.values():
            fn.launches = 0
        got = run()
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        missing = [k for k in must if launches[k] <= 0]
        if missing or launches["knn_dual"]:
            raise AssertionError(f"phase 17 {cell}: launches {launches}, must launch {list(must)} and not "
                                 f"knn_dual")
        if cell == "s2m":
            st, out = got
            outputs["s2m_maps"], outputs[cell] = s2m_leaves(got)
        else:
            outputs[cell] = [x.cpu() for x in _leaves(got)]
        if cell == "s2m":
            summary[cell] = {"t": torch.stack([p.translation for p, _ in out]).cpu(),
                             "q": torch.stack([p.rotation for p, _ in out]).cpu(),
                             "dropped": int(st.dropped),
                             "termination": [int(d.termination) for _, d in out]}
        elif cell == "offline":
            traj, det = got
            summary[cell] = {"t": traj.translation.cpu(), "q": traj.rotation.cpu(),
                             "termination": det.termination.tolist()}
        rows[cell] = {"units": units, "launches": launches}
        if traced:
            stamp(f"{cell}: traced run")
            pg = _profile_run(torch, run, units)
            rows[cell].update({k: pg[k] for k in ("graph_launches_per_unit", "host_reads_per_unit",
                                                  "host_reads_in_driver_loop", "idle_share", "wall_ms",
                                                  "device_kernel_ms")})
            # the gather's kernels in the trace (a conditional body's counted once)
            rows[cell]["peer_kernel_us"] = {k: us for k, us in pg["kernel_us"].items() if "peer_" in k}
        stamp(f"{cell}: timed runs")
        ms = _seconds_per_run(run, reps) * 1e3
        rows[cell].update(ms=ms, ms_per_unit=ms / units)
    if "s2m" in cells and "posegraph" in list(cells)[list(cells).index("s2m"):]:
        # the frames' program replayed after the pose graph's larger gathers
        # grew the mesh's mailbox: the same bits as its first run
        stamp("s2m again, after the pose graph")
        maps, rest = s2m_leaves(cells["s2m"][0]())
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(maps + rest, outputs["s2m_maps"] + outputs["s2m"]))
        if not same:
            raise AssertionError("phase 17 s2m: the frames run again after the pose graph differ from their "
                                 "first run")
        rows["s2m"]["again_after_posegraph_equal"] = True
    return outputs, rows, summary


def _ranks_inputs(T, torch, dev, out_dir, world):
    """Phase 12's inputs on ``dev``: the 16 frames the parent wrote, the
    parameters, and phase 11's pose graph in float64, its edges padded to
    a multiple of the ``world`` ranks."""
    from loam_tpu_torch.io import random_pose_graph

    lidar = T.LidarParams(64, 1024, 0.5, 120.0)
    fp = T.FeatureExtractionParams(precise_selection=True)
    rp = T.RegistrationParams(search_backend="bruteforce")
    scans = torch.from_numpy(np.load(os.path.join(out_dir, "scans.npy"))).to(dev)
    _, init1k, edges1k = random_pose_graph(1000, 50, seed=2)
    edges, _ = _padded_edges(torch, _to(edges1k, dev, torch.float64), world)
    return scans, lidar, fp, rp, (_to(init1k, dev, torch.float64), edges)


def _share_group(torch, rank: int, world: int, port: int):
    """Rank ``rank`` of ``world`` ranks that share ``cuda:0``: that card
    current and a gloo group (NCCL takes one rank a card). Returns the
    device."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=RANKS_COLLECTIVE_TIMEOUT_S))
    return torch.device("cuda", 0)


def _rank_worker(rank: int, world: int, port: int, out_dir: str, cells=RANKS_CELLS, share: bool = False) -> int:
    """Phase 17's rank ``rank`` of ``world``: ``cuda:<rank>`` and an NCCL
    group made eagerly on it (:func:`_rank_group`, the README's recipe),
    then :func:`_rank_cells` on ``make_mesh()`` (one shard on this card)
    and, with every cell, :func:`_peer_check` at the cells' shapes; then
    the same on each mesh across hosts of :func:`_host_splits`
    (``make_mesh(hosts=)``). ``share``: the ranks share ``cuda:0`` in a gloo
    group, each its own host (the cross-host leg on one card), the cells
    alone. Its outputs, rows, the gather's check, the cards it holds a
    context on and the bytes it reserved on every other card to
    ``rank<r>.pt``. Stamps its progress to ``rank<r>.stamp``."""
    import torch
    import torch.distributed as dist

    import loam_tpu_torch as T
    from loam_tpu_torch import parallel
    from loam_tpu_torch.ops import assemble_cuda, bitonic_cuda, knn_cuda, nms_cuda, peer_cuda

    stamp = _stamper(out_dir, "rank", rank)
    stamp("init_process_group")
    dev = _share_group(torch, rank, world, port) if share else \
        _rank_group(torch, rank, world, port, RANKS_COLLECTIVE_TIMEOUT_S)
    counters = {"sector_sort": bitonic_cuda.sector_sort, "greedy_nms": nms_cuda.greedy_nms,
                "select_points": assemble_cuda.select_points, "knn": knn_cuda.knn_run,
                "knn_dual": knn_cuda.knn_dual_run, "peer_gather": peer_cuda.peer_gather,
                "peer_sum": peer_cuda.peer_sum}
    full = tuple(cells) == RANKS_CELLS and not share
    meshes = {f"{world}x1 on one card": list(range(world))} if share else {"one host": None, **_host_splits(world)}
    results = {}
    try:
        scans, lidar, fp, rp, graph = _ranks_inputs(T, torch, dev, out_dir, world)
        for name, hosts in meshes.items():
            stamp(f"{name}: make_mesh(hosts={hosts})")
            mesh = parallel.make_mesh([dev] if share else None, group=dist.group.WORLD, hosts=hosts)
            if mesh.device != dev or mesh.shape != {"data": world, "line": 1} or mesh.shard_ids != (rank,):
                raise AssertionError(f"rank {rank}: make_mesh() gave {mesh.shape} shards {mesh.shard_ids} on "
                                     f"{mesh.device}")
            mark = lambda what, name=name: stamp(f"{name}: {what}")
            # across hosts the wire bounds the large collectives: one timed run a cell, fewer calls of them
            across = hosts is not None
            with _env(LOAM_ICF_DUAL_KNN="0"):
                outputs, rows, summary = _rank_runs(torch, _rank_cells(T, torch, mesh, scans, lidar, fp, rp, graph,
                                                                       cells), counters, 1 if across else 2, mark)
            peer = None
            if full:
                mark("the kernel's collectives against their plain versions at the cells' shapes")
                peer = _peer_check(torch, mesh, _peer_shapes(T, torch, mesh, scans, lidar, fp), 2 if across else 5,
                                   1 if across else 2)
            results[name] = {"outputs": outputs, "rows": rows, "summary": summary, "peer": peer, "hosts": hosts,
                             "islands": mesh.islands, "remote": list(mesh.peer.remote)}
            mesh.release()  # its graphs replay the mesh's collectives, its buffers mapped by the others
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    others = [j for j in range(torch.cuda.device_count()) if j != dev.index]
    contexts = _primary_contexts()
    reserved = {j: torch.cuda.memory_reserved(j) for j in others}
    first = results[next(iter(meshes))]
    torch.save({"outputs": first["outputs"], "rows": first["rows"], "summary": first["summary"], "peer": first["peer"],
                "splits": {k: v for k, v in results.items() if k != "one host"}, "contexts": contexts,
                "reserved": reserved, "device": str(dev), "nccl": ".".join(map(str, torch.cuda.nccl.version()))},
               os.path.join(out_dir, f"rank{rank}.pt"))
    stamp(f"done: contexts on cards {contexts}, reserved on the others {reserved}")
    return 0


def _spawn_ranks(world: int, out_dir: str, cells=RANKS_CELLS, share: bool = False) -> None:
    """Start phase 17's ranks (this script as the worker; ``share``: the
    ranks on ``cuda:0``) and wait for all; past ``RANKS_TIMEOUT_S``, or when
    one fails, kill every rank and raise, naming each rank that did not end
    well and its last stamp."""
    failed = []
    for r, (c, last, tail) in enumerate(_start_ranks(["--share-worker" if share else "--rank-worker"], "rank", world,
                                                     out_dir, RANKS_TIMEOUT_S, cells)):
        if c == 0:
            continue
        why = f"killed after {RANKS_TIMEOUT_S} s" if c is None else f"exit code {c}"
        failed.append(f"rank {r} {why}, last stamp: {last}")
        print(f"phase 17: rank {r} {why}; its log ends:\n{tail}", flush=True)
    if failed:
        raise AssertionError("phase 17: " + "; ".join(failed))


# the collectives whose wire rate phase 17 measures: a small gather, a tree,
# the large sum and a small one
WIRE_ROWS = ("knn_planar_val", "details", "sum_H", "sum_b")


def _wire_worker(split: str, rank: int, world: int, port: int, out_dir: str) -> int:
    """The wire's own rate beside the cross-host rows of phase 17's mesh
    ``split``: rank ``rank`` on ``cuda:<rank>`` in an NCCL group whose
    ranks name their hosts by the split's labels (``NCCL_HOSTID``, read at
    the communicator's start: NCCL then joins ranks of two labels through
    its network transport, over sockets here, and a label's ranks over
    NVLink). For each row of ``wire_rows.json`` (kind, bytes a rank, L):
    NCCL's ``all_gather_into_tensor`` (a gather) or ``all_reduce`` of a
    block (a sum) back to back (CUDA events, mean of 3 after one), and a
    plain socket copy between the same processes of what the kernel sends
    each remote peer (a gather: the rank's block; a sum: (L + 1) slices),
    to every remote peer at once while receiving theirs (host clock, the
    median of 3 after a barrier). Writes ``wire<r>.json``."""
    import socket
    import threading

    import torch
    import torch.distributed as dist

    from loam_tpu_torch.ops.peer_cuda import sum_slice

    labels = _host_splits(world)[split]
    os.environ["NCCL_HOSTID"] = f"loam-host-{labels[rank]}"
    os.environ["NCCL_DEBUG"], os.environ["NCCL_DEBUG_SUBSYS"] = "INFO", "INIT,NET"
    dev = _rank_group(torch, rank, world, port, RANKS_COLLECTIVE_TIMEOUT_S)
    remote = [t for t in range(world) if labels[t] != labels[rank]]
    # plain sockets to every remote peer: connect to those above, accept those below
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(world)
    ports = torch.zeros(world, dtype=torch.int64, device=dev)
    ports[rank] = listener.getsockname()[1]
    dist.all_reduce(ports)
    socks = {}
    for t in remote:
        if t > rank:
            sock = socket.create_connection(("127.0.0.1", int(ports[t])), timeout=60)
            sock.sendall(rank.to_bytes(4, "little"))
            socks[t] = sock
    while len(socks) < len(remote):
        sock, _ = listener.accept()
        socks[int.from_bytes(sock.recv(4, socket.MSG_WAITALL), "little")] = sock
    listener.close()
    for sock in socks.values():
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def copy(n: int) -> float:
        out, ins = bytes(n), {t: bytearray(n) for t in socks}

        def recv(t):
            view, got = memoryview(ins[t]), 0
            while got < n:
                got += socks[t].recv_into(view[got:], min(n - got, 4 << 20))

        threads = [threading.Thread(target=socks[t].sendall, args=(out,)) for t in socks]
        threads += [threading.Thread(target=recv, args=(t,)) for t in socks]
        dist.barrier()
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return (time.perf_counter() - t0) * 1e3

    rows = json.load(open(os.path.join(out_dir, "wire_rows.json")))
    out = {}
    for name, (kind, nbytes, L) in rows.items():
        block = nbytes // L
        x = torch.zeros(nbytes if kind == "gather" else block, dtype=torch.uint8, device=dev)
        if kind == "gather":
            every = torch.empty(world * nbytes, dtype=torch.uint8, device=dev)
            nccl = lambda: dist.all_gather_into_tensor(every, x)
        else:
            y = x.view(torch.float64) if block % 8 == 0 else x.float()
            nccl = lambda: dist.all_reduce(y)
        sent = nbytes if kind == "gather" else (L + 1) * sum_slice(block, world)
        ms = sorted(copy(sent) for _ in range(3))[1] if socks else 0.0
        out[name] = {"nccl_ms": _time_ms(nccl, 3), "socket_ms": ms, "socket_bytes_a_peer": sent,
                     "socket_peers": len(socks)}
    for sock in socks.values():
        sock.close()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"wire{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _wire_rates(N: int, out_dir: str, peer_rows: dict) -> dict:
    """:func:`_wire_worker` on every mesh across hosts at ``N`` ranks, for
    the rows ``peer_rows`` (``_peer_check``'s, rank 0's): ``{split: {row:
    the slowest rank's NCCL ms and socket ms, the bytes a peer, whether
    NCCL logged its socket transport}}``, or ``{split: "the error"}``."""
    spec = {n: (row["kind"], row["bytes"], row["L"]) for n, row in peer_rows.items() if n in WIRE_ROWS}
    with open(os.path.join(out_dir, "wire_rows.json"), "w") as f:
        json.dump(spec, f)
    out = {}
    for split in _host_splits(N):
        _stamp(f"phase 17: the wire's rate, {split}")
        ends = _start_ranks(["--wire-worker", split], f"wire_{split}_", N, out_dir, RANKS_TIMEOUT_S)
        if any(c != 0 for c, _, _ in ends):
            out[split] = f"failed: {[(c, last) for c, last, _ in ends]}; {ends[0][2][-800:]}"
            continue
        ranks = [json.load(open(os.path.join(out_dir, f"wire{r}.json"))) for r in range(N)]
        log = open(os.path.join(out_dir, f"wire_{split}_0.log")).read()
        out[split] = {n: {"nccl_ms": max(r[n]["nccl_ms"] for r in ranks),
                          "socket_ms": max(r[n]["socket_ms"] for r in ranks),
                          "socket_bytes_a_peer": ranks[0][n]["socket_bytes_a_peer"],
                          "nccl_socket_transport": "NET/Socket" in log} for n in spec}
    return out


def _gather_split(N: int, out_dir: str, smi: str) -> dict:
    """Where each four-rank cell's collectives spend their time:
    ``examples/torch_gather_split.py`` on every cell at ``N`` ranks (each
    collective's time on each rank from two ``%globaltimer`` stamps around
    it, the least rank's the transfer, the rest the wait), printed a cell a
    line; its summaries by cell."""
    here = os.path.dirname(os.path.abspath(__file__))
    _stamp(f"phase 17: the collectives' time split, {N} ranks")
    done = subprocess.run([sys.executable, os.path.join(here, "examples", "torch_gather_split.py"), "--trees", here,
                           "--cells", *RANKS_CELLS, "--ranks", str(N), "--reps", "3",
                           "--out", os.path.join(out_dir, "split")],
                          capture_output=True, text=True, timeout=RANKS_TIMEOUT_S, cwd=here)
    if done.returncode != 0:
        raise AssertionError(f"phase 17: the split of the collectives' time failed:\n{done.stdout[-3000:]}"
                             f"{done.stderr[-3000:]}")
    cells = json.loads(done.stdout.strip().splitlines()[-1])["gather_split"][0]["cells"]
    for cell, c in cells.items():
        print(f"phase 17 {cell}: collectives' time split at {N} ranks: {len(c['collectives'])} collectives a call "
              f"(a conditional body's once), us a rank {[round(x, 1) for x in c['sum_us_a_rank']]}, of which the "
              f"wait for the slowest rank {[round(x, 1) for x in c['wait_us_a_rank']]} and the transfer "
              f"{c['sum_transfer_us']:.1f}; {c['ms_a_call']:.3f} ms a call with the stamps, on {smi}", flush=True)
    return cells


def _ranks_phase(T, torch, smi, scans_np, gt, counters, path_launches, ate_rmse, reps,
                 cells=RANKS_CELLS) -> dict:
    """Phase 17: one rank a card. ``N = _rank_count()`` ranks, each
    :func:`_rank_worker` on its own card; every rank's outputs bit-equal to
    rank 0's, and rank 0's to the same calls in this process on N shards of
    ``cuda:0`` in a world-size-1 NCCL group; every call or frame of every
    cell one ``cudaGraphLaunch`` with no host read on every rank, the
    gathers the kernel's over peer memory; the kernel's gather bit-equal to
    NCCL's at the cells' shapes on every rank (:func:`_peer_check`); no
    rank holds a context or reserves memory on another card; the ATE gate
    and ``dropped == 0``. Before the ranks, the collective probe
    (:func:`_probe_case`): the kernel's gather in a WHILE body, an IF body
    and a plain graph must be accepted and equal to NCCL's (a gate); NCCL's
    own cases are printed as measured, the record of why the kernel exists.
    Ms a unit and scans/s of both. The meshes across hosts
    (:func:`_host_splits`, run by the same ranks) through
    :func:`_split_checks`, the probe's kernel cases on each, and the wire's
    rate (:func:`_wire_rates`); on one card two ranks of two hosts sharing
    it (:func:`_share_phase`). ``cells``: those to run; fewer than all
    skips the probe, the gather check and the wire (a focused run,
    ``--ranks-only <cell> ...``). Returns the ``{"ranks": ...}`` record."""
    from loam_tpu_torch import parallel
    from loam_tpu_torch.registration import loop

    N = _rank_count(torch)
    cards = torch.cuda.device_count()
    out_dir = tempfile.mkdtemp(prefix="loam_ranks_")
    np.save(os.path.join(out_dir, "scans.npy"), scans_np)
    # this process's programs and cached blocks off the card before the ranks start
    loop.clear_cache()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    failed, probe = [], None
    full = tuple(cells) == RANKS_CELLS
    if full:
        probe = {}
        across = ["peer_bodies@across"] if N > 1 else []
        for case in ("peer_while", "peer_if", "peer_plain", "while", "if", "side_first", *across):
            _stamp(f"phase 17: collective probe, {case}, {N} rank(s)")
            probe[case] = _probe_case(case, N, out_dir)
        print(f"phase 17: collective probe at {N} rank(s): the kernel's gather (peer memory) in a WHILE body "
              f"{probe['peer_while']}, an IF body {probe['peer_if']}, a plain graph {probe['peer_plain']}; across "
              f"hosts {({c: probe[c] for c in across})}; NCCL's "
              f"(the record): WHILE body {probe['while']}; IF body {probe['if']}; first gather on a side stream, "
              f"then a plain graph: {probe['side_first']}", flush=True)
        refused = {c: probe[c] for c in ("peer_while", "peer_if", "peer_plain", *across) if probe[c] != "accepted"}
        if refused:
            failed.append(f"the kernel's gather probe at {N} rank(s): {refused}")
    t0 = time.perf_counter()
    _spawn_ranks(N, out_dir, cells)
    spawn_s = time.perf_counter() - t0
    split = _gather_split(N, out_dir, smi) if full and N > 1 else None
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(N)]
    for r in range(N):
        print(open(os.path.join(out_dir, f"rank{r}.log")).read().rstrip(), flush=True)
    for r, res in enumerate(ranks):
        if res["contexts"] != [r] or any(res["reserved"].values()):
            failed.append(f"rank {r}: contexts on cards {res['contexts']}, reserved on the others "
                          f"{res['reserved']}")
        for cell, row in res["rows"].items():
            if row["graph_launches_per_unit"] != 1 or row["host_reads_per_unit"] != 0:
                failed.append(f"rank {r} {cell}: {row['graph_launches_per_unit']} cudaGraphLaunch and "
                              f"{row['host_reads_per_unit']} host reads a unit (one program a unit)")
        if full and not all(row["equal"] for row in res["peer"].values()):
            failed.append(f"rank {r}: the kernel's gather differs from NCCL's at "
                          f"{[n for n, row in res['peer'].items() if not row['equal']]}")
        for cell, leaves in res["outputs"].items():
            if cell == "s2m_maps":  # each rank holds its own rows of the maps
                continue
            want = ranks[0]["outputs"][cell]
            if len(leaves) != len(want) or not all(a.dtype == b.dtype and torch.equal(a, b)
                                                   for a, b in zip(leaves, want)):
                failed.append(f"rank {r} {cell}: outputs differ from rank 0's")

    # the same calls in this process: N shards of cuda:0, a world-size-1 group
    dev = torch.device("cuda", 0)
    scans, lidar, fp, rp, graph = _ranks_inputs(T, torch, dev, out_dir, N)
    one_peer = None
    with _nccl_group() as group, _dual_knn(False):
        mesh = parallel.make_mesh([dev] * N, group=group)
        stamp = lambda what: _stamp(f"phase 17, 1 rank x {N} shard(s): {what}")
        one_outputs, one_rows, _ = _rank_runs(torch, _rank_cells(T, torch, mesh, scans, lidar, fp, rp, graph,
                                                                 cells), counters, reps, stamp, traced=False)
        if full:
            one_peer = _peer_check(torch, mesh, _peer_shapes(T, torch, mesh, scans, lidar, fp), 5)
            if not all(row["equal"] for row in one_peer.values()):
                failed.append(f"1 rank x {N} shards: the kernel's gather differs from NCCL's")
        mesh.release()
    for cell, leaves in one_outputs.items():
        want = ranks[0]["outputs"][cell]
        if cell == "s2m_maps":
            want = [torch.cat([res["outputs"][cell][i] for res in ranks]) for i in range(len(want))]
        same = len(leaves) == len(want) and all(a.dtype == b.dtype and torch.equal(a, b)
                                                for a, b in zip(leaves, want))
        if not same:
            what = "the ranks' rows of the maps" if cell == "s2m_maps" else "rank 0's outputs"
            failed.append(f"{cell}: {what} differ from 1 rank x {N} shards of cuda:0")
    summary = ranks[0]["summary"]
    for cell, s in summary.items():
        ate, limit, _ = _check_trajectory(f"phase 17 {cell}", s["t"], s["q"], scans_np.shape[0], gt, ate_rmse)
        s.update(ate_m=ate, ate_limit_m=limit)
    if summary.get("s2m", {}).get("dropped", 0) != 0:
        failed.append(f"s2m dropped {summary['s2m']['dropped']} voxels")
    frames = scans_np.shape[0]
    peer = None
    if full:
        slowest = lambda key: {n: max(res["peer"][n][key] for res in ranks) for n in ranks[0]["peer"]}
        peer = {"equal_nccl": [all(row["equal"] for row in res["peer"].values()) for res in ranks],
                "graph_nodes": [{n: row["graph_nodes"] for n, row in res["peer"].items()} for res in ranks],
                **{f"{key}_slowest_rank": slowest(key) for key in ("ms", "plain_ms", "graph_us", "plain_graph_us",
                                                                   "library_graph_us")},
                "one_rank": one_peer, "rank0": ranks[0]["peer"]}
        for n, row in ranks[0]["peer"].items():
            one = one_peer[n]
            print(f"phase 17 {row['kind']} {n}, {row['what']} a rank: the kernel "
                  f"{peer['ms_slowest_rank'][n]:.4f} ms back to back, {peer['graph_us_slowest_rank'][n]:.2f} us in "
                  f"a graph ({row['graph_nodes']} node); plain {peer['plain_ms_slowest_rank'][n]:.4f} ms, "
                  f"{peer['plain_graph_us_slowest_rank'][n]:.2f} us; library "
                  f"{peer['library_graph_us_slowest_rank'][n]:.2f} us in a graph, on {N} x 1 (slowest rank); on 1 x "
                  f"{N} the kernel {one['ms']:.4f} ms, {one['graph_us']:.2f} us, plain {one['plain_ms']:.4f} ms, "
                  f"{one['plain_graph_us']:.2f} us, library {one['library_graph_us']:.2f} us; bit-equal on every "
                  f"rank: {all(peer['equal_nccl'])}", flush=True)
        many = {r: {n: k for n, k in nodes.items() if k != 1} for r, nodes in enumerate(peer["graph_nodes"])}
        if any(many.values()):
            failed.append(f"a peer collective is more than one graph node: {many}")
    record = {"cards": cards, "ranks": N, "cross_card": N > 1, "shards_a_rank": 1, "nccl": ranks[0]["nccl"],
              "probe": probe, "peer_equal_nccl": peer and peer["equal_nccl"], "peer_gather": peer,
              "spawn_s": spawn_s,
              "contexts": {r: res["contexts"] for r, res in enumerate(ranks)},
              "reserved_elsewhere": {r: res["reserved"] for r, res in enumerate(ranks)},
              "ate_m": {c: s["ate_m"] for c, s in summary.items()},
              "dropped": summary.get("s2m", {}).get("dropped"), "gather_split": split, "cells": {}}
    for cell, row in ranks[0]["rows"].items():
        path_launches[f"ranks_{cell}"] = row["launches"]
        one = one_rows[cell]
        slowest = max(res["rows"][cell]["ms"] for res in ranks)
        rec = {"units": row["units"], "launches_rank0": row["launches"],
               "ms_rank0": row["ms"], "ms_slowest_rank": slowest, "ms_a_unit": slowest / row["units"],
               "one_rank_ms": one["ms"], "one_rank_ms_a_unit": one["ms_per_unit"],
               "graph_launches_per_unit": [res["rows"][cell].get("graph_launches_per_unit") for res in ranks],
               "host_reads_per_unit": [res["rows"][cell].get("host_reads_per_unit") for res in ranks],
               "idle_share_rank0": row.get("idle_share"),
               "traced_wall_ms_rank0": row.get("wall_ms"), "device_kernel_ms_rank0": row.get("device_kernel_ms"),
               "peer_kernel_us_rank0": row.get("peer_kernel_us"),
               "again_after_posegraph_equal": [res["rows"][cell].get("again_after_posegraph_equal")
                                               for res in ranks] if cell == "s2m" else None}
        if cell in ("s2m", "offline", "extract"):
            rec["scans_s"], rec["one_rank_scans_s"] = frames / slowest * 1e3, frames / one["ms"] * 1e3
        record["cells"][cell] = rec
        rate = (f"; {rec['scans_s']:.3f} scans/s on {N} x 1, {rec['one_rank_scans_s']:.3f} on 1 x {N}"
                if "scans_s" in rec else "")
        print(f"phase 17 {cell}: ranks x shards {N} x 1, one a card: {rec['ms_a_unit']:.3f} ms a "
              f"{'frame' if row['units'] > 1 else 'call'} (slowest rank; rank 0 {row['ms']:.3f} ms a run), "
              f"1 x {N} shards of cuda:0 {one['ms_per_unit']:.3f}{rate}; one program: cudaGraphLaunch a unit "
              f"{rec['graph_launches_per_unit']}, host reads {rec['host_reads_per_unit']}; rank 0's traced run "
              f"{rec['traced_wall_ms_rank0']:.3f} ms, kernels {rec['device_kernel_ms_rank0']:.3f} ms, of which the "
              f"gather's {rec['peer_kernel_us_rank0']} us (a conditional body's counted once); rank 0's launches "
              f"{row['launches']}, on {smi}")
    print(f"phase 17: {N} rank(s) on {cards} card(s) (cross-card traffic: {'yes' if N > 1 else 'no'}), NCCL "
          f"{record['nccl']}; every rank's outputs bit-equal to "
          f"rank 0's and to 1 rank x {N} shard(s): {'no' if any('differ' in f for f in failed) else 'yes'}; "
          f"contexts "
          f"{record['contexts']}; ATE {record['ate_m']} m; dropped {record['dropped']}", flush=True)
    record["splits"] = _split_checks(torch, ranks, one_outputs, failed, smi)
    if full and N > 1:
        wire = _wire_rates(N, out_dir, ranks[0]["splits"][next(iter(_host_splits(N)))]["peer"])
        for split, rates in wire.items():
            record["splits"][split]["wire"] = rates
            if isinstance(rates, str):
                print(f"phase 17 {split}: the wire's rate {rates}", flush=True)
                continue
            for n, w in rates.items():
                row = record["splits"][split]["peer"][n]
                print(f"phase 17 {split} {row['kind']} {n}, {row['what']} a rank: the kernel {row['graph_us']:.1f} us "
                      f"in a graph (slowest rank), bound {row['bound_ms'] * 1e3:.1f} us; the wire alone: a socket "
                      f"copy of {w['socket_bytes_a_peer']} B to each remote peer at once {w['socket_ms'] * 1e3:.1f} us, "
                      f"NCCL over its network transport {w['nccl_ms'] * 1e3:.1f} us (NET/Socket logged: "
                      f"{w['nccl_socket_transport']}), on {smi}", flush=True)
    if N == 1 and cells == RANKS_CELLS:
        record["one_card_two_hosts"] = _share_phase(T, torch, counters, out_dir, failed, smi)
    print(json.dumps({"ranks": record}))
    if failed:
        raise AssertionError("phase 17: " + "; ".join(failed))
    return record


def _same(torch, a: list, b: list) -> bool:
    """Two lists of tensors bit-equal, leaf by leaf."""
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _split_checks(torch, ranks: list, one_outputs: dict, failed: list, smi: str) -> dict:
    """Phase 17's gates on every mesh across hosts the ranks ran
    (``splits`` of each rank's record): every cell one ``cudaGraphLaunch``
    and no host read a unit on every rank, every rank's outputs bit-equal to
    rank 0's and rank 0's to 1 rank x N shards (``one_outputs``; the maps:
    the ranks' rows in rank order), every collective bit-equal to its plain
    version and one graph node; failures appended to ``failed``. Prints a
    line a cell and a collective; returns the splits' records (ms of the
    slowest rank, the collectives' rows with their bounds)."""
    N = len(ranks)
    out = {}
    for split in ranks[0]["splits"]:
        mine = [res["splits"][split] for res in ranks]
        first = mine[0]
        island = len(next(i for i in first["islands"] if 0 in i))
        rec = {"hosts": first["hosts"], "islands": [list(i) for i in first["islands"]],
               "remote_rank0": first["remote"], "cells": {}, "peer": None}
        for r, res in enumerate(mine):
            for cell, row in res["rows"].items():
                if row["graph_launches_per_unit"] != 1 or row["host_reads_per_unit"] != 0:
                    failed.append(f"{split} rank {r} {cell}: {row['graph_launches_per_unit']} cudaGraphLaunch and "
                                  f"{row['host_reads_per_unit']} host reads a unit (one program a unit)")
            for cell, leaves in res["outputs"].items():
                if cell != "s2m_maps" and not _same(torch, leaves, first["outputs"][cell]):
                    failed.append(f"{split} rank {r} {cell}: outputs differ from rank 0's")
            if res["peer"] is not None and not all(row["equal"] and row["graph_nodes"] == 1
                                                   for row in res["peer"].values()):
                failed.append(f"{split} rank {r}: a collective differs from its plain version or is more than one "
                              f"graph node")
        for cell, leaves in one_outputs.items():
            want = first["outputs"][cell]
            if cell == "s2m_maps":
                want = [torch.cat([res["outputs"][cell][i] for res in mine]) for i in range(len(want))]
            if not _same(torch, leaves, want):
                failed.append(f"{split} {cell}: rank 0's outputs differ from 1 rank x {N} shards")
        for cell, row in first["rows"].items():
            slowest = max(res["rows"][cell]["ms"] for res in mine)
            rec["cells"][cell] = {"units": row["units"], "ms_slowest_rank": slowest, "ms_a_unit": slowest / row["units"],
                                  "graph_launches_per_unit": [res["rows"][cell]["graph_launches_per_unit"]
                                                              for res in mine],
                                  "host_reads_per_unit": [res["rows"][cell]["host_reads_per_unit"] for res in mine],
                                  "launches_rank0": row["launches"], "idle_share_rank0": row.get("idle_share"),
                                  "peer_kernel_us_rank0": row.get("peer_kernel_us")}
            print(f"phase 17 {cell} across hosts {split} (islands {rec['islands']}): {slowest / row['units']:.3f} ms a "
                  f"{'frame' if row['units'] > 1 else 'call'} (slowest rank); cudaGraphLaunch a unit "
                  f"{rec['cells'][cell]['graph_launches_per_unit']}, host reads "
                  f"{rec['cells'][cell]['host_reads_per_unit']}; rank 0's launches {row['launches']}, on {smi}",
                  flush=True)
        if first["peer"] is not None:
            rec["peer"] = {}
            for n, row in first["peer"].items():
                slow = {k: max(res["peer"][n][k] for res in mine) for k in ("ms", "graph_us", "plain_ms",
                                                                            "plain_graph_us", "host_us")}
                L, nbytes = row["L"], row["bytes"]
                bound = (_gather_bound(nbytes, N, island) if row["kind"] == "gather" else
                         _sum_bound(nbytes // L, L, N, island))
                rec["peer"][n] = {"kind": row["kind"], "what": row["what"], "bytes": nbytes, "L": L,
                                  "equal_every_rank": all(res["peer"][n]["equal"] for res in mine),
                                  "graph_nodes": row["graph_nodes"], **slow, **bound}
                print(f"phase 17 {row['kind']} {n} across hosts {split}, {row['what']} a rank: the kernel "
                      f"{slow['ms']:.4f} ms back to back, {slow['graph_us']:.2f} us in a graph, host {slow['host_us']:.2f}"
                      f" us a call; plain (NCCL) {slow['plain_ms']:.4f} ms, {slow['plain_graph_us']:.2f} us; bound "
                      f"{bound['bound_ms'] * 1e3:.2f} us (island of {island}, PCIe to {N - island}); bit-equal on "
                      f"every rank: {rec['peer'][n]['equal_every_rank']}; slowest rank, on {smi}", flush=True)
        out[split] = rec
    return out


def _share_phase(T, torch, counters, out_dir: str, failed: list, smi: str) -> dict:
    """Two ranks on ``cuda:0``, each its own host (``--share-worker``: a
    gloo group, ``make_mesh(hosts=[0, 1])``): the cross-host leg with the
    card time-sliced between the two processes. Every cell through
    :func:`_split_checks` against 1 rank x 2 shards of ``cuda:0``."""
    from loam_tpu_torch import parallel

    _stamp("phase 17: two ranks on one card, two hosts")
    t0 = time.perf_counter()
    _spawn_ranks(2, out_dir, RANKS_CELLS, share=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(2)]
    for r in range(2):
        print(open(os.path.join(out_dir, f"rank{r}.log")).read().rstrip(), flush=True)
    dev = torch.device("cuda", 0)
    scans, lidar, fp, rp, graph = _ranks_inputs(T, torch, dev, out_dir, 2)
    with _nccl_group() as group, _dual_knn(False):
        mesh = parallel.make_mesh([dev] * 2, group=group)
        stamp = lambda what: _stamp(f"phase 17, 1 rank x 2 shards: {what}")
        one_outputs, one_rows, _ = _rank_runs(torch, _rank_cells(T, torch, mesh, scans, lidar, fp, rp, graph),
                                              counters, 1, stamp, traced=False)
        mesh.release()
    rec = _split_checks(torch, ranks, one_outputs, failed, smi)
    (split,) = rec
    rec[split]["spawn_s"] = spawn_s
    rec[split]["one_rank_ms_a_unit"] = {cell: row["ms_per_unit"] for cell, row in one_rows.items()}
    return rec



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--rank-worker"]:
        # phase 17's rank: <rank> <world> <port> <out_dir> <cell> ...
        return _rank_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                            tuple(sys.argv[6:]))
    if sys.argv[1:2] == ["--share-worker"]:
        # phase 17's ranks on one card: <rank> <world> <port> <out_dir> <cell> ...
        return _rank_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                            tuple(sys.argv[6:]), share=True)
    if sys.argv[1:2] == ["--wire-worker"]:
        # phase 17's wire rates: <split> <rank> <world> <port> <out_dir>
        return _wire_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]), sys.argv[6])
    if sys.argv[1:2] == ["--probe-worker"]:
        # phase 17's probe: <case> <rank> <world> <port> <out_dir>
        return _probe_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]), sys.argv[6])
    extraction_only = sys.argv[1:] == ["--extraction-only"]
    drive_only = sys.argv[1:] == ["--drive-only"]
    ranks_only = sys.argv[1:2] == ["--ranks-only"]
    ranks_cells = tuple(sys.argv[2:]) if ranks_only and sys.argv[2:] else RANKS_CELLS
    if sys.argv[1:] and not (extraction_only or drive_only or ranks_only) or set(ranks_cells) - set(RANKS_CELLS):
        print(f"usage: chip_smoke.py [--extraction-only | --drive-only | --ranks-only [cell ...]], cells "
              f"{' '.join(RANKS_CELLS)}", file=sys.stderr)
        return 2

    import loam_tpu_torch as T
    from loam_tpu_torch import program
    from loam_tpu_torch.evaluation import ate_rmse
    from loam_tpu_torch.features.curvature import compute_curvature
    from loam_tpu_torch.io import render_trajectory
    from loam_tpu_torch.ops import _build, assemble_cuda, bitonic_cuda, knn_cuda, nms_cuda, peer_cuda

    smi = _smi()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build ----------------------------------------------------------
    _stamp("phase 1")
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
    _stamp("phase 2")
    lidar = T.LidarParams(64, 1024, 0.5, 120.0)
    fp = T.FeatureExtractionParams(precise_selection=True)
    rp = T.RegistrationParams(search_backend="bruteforce")
    frames = 16
    # the drive of phase 16, rendered once: render_trajectory seeds frame f
    # with seed + f, so the shorter runs' scans are its first frames
    drive_np, drive_poses = render_trajectory(
        lidar, frames if extraction_only or ranks_only else DRIVE_FRAMES, step=np.array([0.08, 0.02, 0.0]),
        yaw_rate=0.01, noise=0.005, seed=0, dtype=np.float32,
    )
    drive_gt = np.stack([t for (_, t) in drive_poses])
    scans_np, poses = drive_np[:frames], drive_poses[:frames]
    scans = torch.from_numpy(scans_np).to(dev)
    counters = {
        "sector_sort": bitonic_cuda.sector_sort,
        "greedy_nms": nms_cuda.greedy_nms,
        "select_points": assemble_cuda.select_points,
        "knn": knn_cuda.knn_run,
        "knn_dual": knn_cuda.knn_dual_run,
        "peer_gather": peer_cuda.peer_gather,
        "peer_sum": peer_cuda.peer_sum,
    }
    extraction = ("sector_sort", "greedy_nms", "select_points")
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

    s2m_cfg = T.ScanToMapConfig()
    s2m_reg = T.default_map_reg_params()
    grid_reg = T.RegistrationParams(search_backend="grid", prior_weight=300.0)
    if ranks_only:
        # phase 17 alone, after the build
        _stamp("phase 17")
        _ranks_phase(T, torch, smi, scans_np, drive_gt[:frames], counters, path_launches, ate_rmse, 2,
                     ranks_cells)
        _stamp("phases done")
        print(smi)
        return 0
    if drive_only:
        # phase 16 alone, after the build
        _stamp("phase 16")
        _drive_phase(T, torch, dev, smi, drive_np, drive_gt, lidar, fp, rp, s2m_reg, s2m_cfg, grid_reg,
                     drive, extraction, knn_cuda, ate_rmse)
        _stamp("phases done")
        print(smi)
        return 0
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
        # the first ICF iteration's cold seed bound (the rank window), and a
        # mid-run iteration's warm one: the last result at moved queries
        # (the kernel computes both in its prologue, as the ICF loop runs it)
        cold = dict(seed_window=True)
        prev = knn_cuda.knn_run(prep, q, k, r, with_coords=True, query_mask=qm, **cold)
        q_warm = (q + torch.tensor([0.012, -0.005, 0.002], device=dev)).contiguous()
        warm = dict(seed_prev=prev, seed_window=True)
        for what, qq, seed in (("", q, None), (" cold", q, cold), (" warm", q_warm, warm)):
            knn_err = max(knn_err, _check_single_knn(f"knn {cls}{what}", knn_cuda, prep, qq, k, r, qm, seed))
        # one pair: the targets are split across thread blocks; four pairs
        # with the splits switched off: every block searches all live targets
        prep1 = knn_cuda.knn_prep(tgt_pts[:1], tgt_mask[:1])
        knn_err = max(knn_err, _check_single_knn(f"knn {cls} B=1", knn_cuda, prep1, q[:1], k, r, qm[:1],
                                                 cold))
        with _unsplit(knn_cuda):
            knn_err = max(knn_err, _check_single_knn(f"knn {cls} unsplit", knn_cuda, prep, q, k, r, qm, cold))
        if cls == "planar":
            Qp = q.shape[1]
            plan4, plan1 = (knn_cuda.split_plan(b, ((Qp, Qp),), bq)[0] for b in (C, 1))
            if plan1 <= 1:
                raise AssertionError("knn: one pair at scan scale did not take the split path")
            knn_shape = (f"B={C}, Q=M={Qp} planar (and {feats.edge_points.shape[1]} edge), k={k}, "
                         f"n_live {prep.n_live.tolist()}, {int(qm.sum())} searching queries")
            knn_row = _knn_row("knn", knn_cuda, prep, q, k, r, qm, tgt_mask, 0.0,
                               knn_shape + ", first ICF iteration, cold seed bound", cold,
                               _plain_seed(knn_cuda, q, tgt_pts, tgt_mask, k))
            warm_row = _knn_row("knn_warm", knn_cuda, prep, q_warm, k, r, qm, tgt_mask, 0.0,
                                knn_shape + ", queries moved (0.012, -0.005, 0.002) m, warm seed bound "
                                "from the last result", warm,
                                _plain_seed(knn_cuda, q_warm, tgt_pts, tgt_mask, k, prev))
            if not warm_row["visits"] < warm_row["live_boxes"] or not knn_row["visits"] < knn_row["live_boxes"]:
                raise AssertionError("knn at scan scale visited every live box")
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
                knn_err = max(knn_err, _check_single_knn(
                    f"knn planar k={k_wide} seeded", knn_cuda, prep, q, k_wide, r, qm, cold))
            wide_ms = _time_ms(lambda: knn_cuda._search_kernel(prep, q, 16, r * r, qm), 3)
            wide_row = _knn_row("knn_wide16", knn_cuda, prep, q, 16, r, qm, tgt_mask, 0.0,
                                knn_shape.replace("k=5", "k=16 (the wide form)") + ", cold seed bound",
                                cold, _plain_seed(knn_cuda, q, tgt_pts, tgt_mask, 16))
            # the same distances as k = 5, index, d2 and three coordinate planes of 16 slots out
            wide_bound = _bound(_nbytes(prep.tT, prep.n_live, q, qm) + 5 * 4 * 16 * qm.numel(),
                                _knn_operations([(tgt_mask, qm)]))
    if knn_err != 0.0:
        raise AssertionError(f"knn distances differ from the plain version by {knn_err}")
    knn_row["max_abs_err"] = warm_row["max_abs_err"] = wide_row["max_abs_err"] = knn_err
    kernels += [knn_row, warm_row, wide_row]
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
          f"{wide_ms:.4f} ms, bound {wide_bound['bound_ms']:.6f} ms by {wide_bound['bound_by']}, share "
          f"{wide_bound['bound_ms'] / wide_ms:.4f}")
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

    def dual_bound(name, prep, e_mask, p_mask, q_e, q_p, k, r_e, r_p):
        """Targets, boxes, bounds and queries in; index and d2 planes of both
        classes out; the visits of one launch."""
        lift = lambda m: m if m.ndim == 2 else m[None]
        n_q = (q_e.numel() + q_p.numel()) // 3
        le, lp = q_e.reshape(-1, q_e.shape[-2], 3), q_p.reshape(-1, q_p.shape[-2], 3)
        *_, ve, vp = knn_cuda._dual_search_kernel(prep, le.contiguous(), lp.contiguous(), k, r_e * r_e,
                                                  r_p * r_p, visits=True)
        plain = torch.cat([knn_cuda._plain_visits(prep.n_live[:, 0], prep.tt, le.shape[1], k),
                           knn_cuda._plain_visits(prep.n_live[:, 1], prep.tt, lp.shape[1], k)], dim=1)
        return _visit_fields(name, torch.cat([ve, vp], dim=1), plain, prep.tt,
                             _nbytes(prep.tT, prep.n_live, prep.rot, prep.rbox, q_e, q_p) + 2 * 4 * k * n_q,
                             _knn_operations([(lift(e_mask), q_e.shape[-2]), (lift(p_mask), q_p.shape[-2])]))

    kernels.append(dict(
        name="knn_dual_scan", counter="knn_dual", route="cuda", source="loam_tpu_torch/ops/csrc/knn.cu",
        replaces="loam_tpu/ops/knn_pallas.py:946", shape=scan_shape,
        max_abs_err=dual_err, ms=dual_scan_ms, launch_ms=dual_scan_launch_ms,
        host_us=dual_scan_host_us, plain_ms=dual_scan_plain_ms, library_ms=None,
        **dual_bound("knn_dual_scan", d_prep, tgt.edge_mask, tgt.planar_mask, qe, qp, max(k_e, k_p),
                     r_e, r_p),
    ))

    # dual kNN, map scale: the voxel maps after the first frames at the
    # default ScanToMapConfig, searched by the next frame's features at the
    # constant-velocity prediction
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
        **dual_bound("knn_dual", m_prep, em.mask, pm.mask, mqe, mqp, max(k_e, k_p), r_e, r_p),
    ))
    # the single search at map scale, as scan-to-map's prep cache runs it:
    # one frame's queries (masked) against the maps, the cold seed bound
    # from the kernel's prologue
    map_err = 0.0
    for cls, vm, qq, qmask, k, r in (("planar", pm, mqp, f_next.planar_mask, k_p, r_p),
                                     ("edge", em, mqe, f_next.edge_mask, k_e, r_e)):
        cprep = knn_cuda.knn_prep(vm.points[None], vm.mask[None])
        cq, cqm = qq[None].contiguous(), qmask[None].contiguous()
        map_err = max(map_err, _check_single_knn(f"knn map {cls}", knn_cuda, cprep, cq, k, r, cqm,
                                                 dict(seed_window=True)))
        if cls == "planar":
            map_row = (cprep, cq, k, r, cqm, vm.mask[None],
                       _plain_seed(knn_cuda, cq, vm.points[None], vm.mask[None], k))
    if map_err != 0.0:
        raise AssertionError(f"knn at map scale differs from the plain version by {map_err}")
    cprep, cq, k, r, cqm, cmask, want = map_row
    kernels.append(_knn_row(
        "knn_map", knn_cuda, cprep, cq, k, r, cqm, cmask, map_err,
        f"B=1, {cq.shape[1]} planar queries ({int(cqm.sum())} searching) vs {cmask.shape[1]} map slots "
        f"({int(cmask.sum())} filled after {n_map} frames), k={k}, box {cprep.tt}, cold seed bound: "
        f"scan-to-map's cached search", dict(seed_window=True), want))

    # every map slot live, the points spread over the room the scans see
    # (tune_knn's mapfull): nothing to prune, the search's dense case; the
    # dual search and the single one as scan-to-map's cache runs it
    g = torch.Generator(device="cpu").manual_seed(0)
    full = lambda n: ((torch.rand((n, 3), generator=g) - 0.5) * 40.0).to(dev)
    ne, npl = em.points.shape[0], pm.points.shape[0]
    fe, fpl = full(ne), full(npl)
    ones_e, ones_p = (torch.ones(n, dtype=torch.bool, device=dev) for n in (ne, npl))
    f_prep = knn_cuda.knn_dual_prep(fe, ones_e, fpl, ones_p)
    k_e, k_p = s2m_reg.num_edge_neighbors, s2m_reg.num_plane_neighbors
    full_err = _check_dual_knn("knn_dual mapfull", knn_cuda, f_prep, mqe, mqp, knn_cuda.knn_prep(fe, ones_e),
                               knn_cuda.knn_prep(fpl, ones_p), k_e, k_p, r_e, r_p)
    run_full = lambda: knn_cuda.knn_dual_run(f_prep, mqe, mqp, k_e, k_p, r_e, r_p)
    full_shape = (f"B=1, {mqe.shape[0]} edge + {mqp.shape[0]} planar queries vs {ne} + {npl} map slots, "
                  f"every one live, uniform in a 40 m cube, k={k_p}")
    kernels.append(dict(
        name="knn_dual_mapfull", counter="knn_dual", route="cuda", source="loam_tpu_torch/ops/csrc/knn.cu",
        replaces="loam_tpu/ops/knn_pallas.py:946", shape=full_shape, max_abs_err=full_err,
        ms=_time_ms(run_full, 10), host_us=_host_us(run_full, 50),
        launch_ms=_time_ms(lambda: knn_cuda._dual_search_kernel(
            f_prep, mqe[None], mqp[None], max(k_e, k_p), r_e * r_e, r_p * r_p), 10),
        plain_ms=_time_ms(lambda: knn_cuda.knn_dual_run_reference(f_prep, mqe, mqp, k_e, k_p, r_e, r_p), 2),
        library_ms=None, **dual_bound("knn_dual_mapfull", f_prep, ones_e, ones_p, mqe, mqp, max(k_e, k_p),
                                      r_e, r_p)))
    f1_prep = knn_cuda.knn_prep(fpl[None], ones_p[None])
    full1_err = _check_single_knn("knn mapfull", knn_cuda, f1_prep, cq, k_p, r_p, cqm, dict(seed_window=True))
    kernels.append(_knn_row(
        "knn_mapfull", knn_cuda, f1_prep, cq, k_p, r_p, cqm, ones_p[None], full1_err,
        f"B=1, {cq.shape[1]} planar queries ({int(cqm.sum())} searching) vs {npl} map slots, every one "
        f"live, uniform in a 40 m cube, k={k_p}, box {f1_prep.tt}, cold seed bound", dict(seed_window=True),
        _plain_seed(knn_cuda, cq, fpl[None], ones_p[None], k_p)))
    if max(full_err, full1_err) != 0.0:
        raise AssertionError(f"knn mapfull differs from the plain version by {max(full_err, full1_err)}")
    _print_kernels(kernels)

    # what phase 13 holds to knn_oracle: (label, run, [(class, result index,
    # queries, query mask, targets, target mask, k, radius)]), batched
    lift = lambda *xs: tuple(x[None] for x in xs)
    map_cls = lambda qe_, qp_, e_pts, e_m, p_pts, p_m: [
        ("edge", 0, *lift(qe_, f_next.edge_mask, e_pts, e_m), k_e, r_e),
        ("planar", 1, *lift(qp_, f_next.planar_mask, p_pts, p_m), k_p, r_p)]
    k_s, r_s = rp.num_plane_neighbors, rp.max_plane_neighbor_dist
    p_src = feats.planar_points[1:C + 1].contiguous()
    p_qm = feats.planar_mask[1:C + 1].contiguous()
    s_prep = knn_cuda.knn_prep(feats.planar_points[:C], feats.planar_mask[:C])
    oracle_knn = [
        ("knn (single), main path's chunk, cold seed",
         lambda: (knn_cuda.knn_run(s_prep, p_src, k_s, r_s, query_mask=p_qm, seed_window=True),),
         [("planar", 0, p_src, p_qm, feats.planar_points[:C], feats.planar_mask[:C], k_s, r_s)]),
        ("knn_dual, scan scale", lambda: knn_cuda.knn_dual_run(d_prep, qe, qp, rp.num_edge_neighbors,
                                                              rp.num_plane_neighbors,
                                                              rp.max_edge_neighbor_dist, r_s),
         [("edge", 0, qe, src.edge_mask, tgt.edge_points, tgt.edge_mask, rp.num_edge_neighbors,
           rp.max_edge_neighbor_dist),
          ("planar", 1, qp, src.planar_mask, tgt.planar_points, tgt.planar_mask, k_s, r_s)]),
        (f"knn_dual, map after {n_map} frames", lambda: knn_cuda.knn_dual_run(m_prep, mqe, mqp, k_e, k_p, r_e, r_p),
         map_cls(mqe, mqp, em.points, em.mask, pm.points, pm.mask)),
        ("knn_dual, mapfull", run_full, map_cls(mqe, mqp, fe, ones_e, fpl, ones_p)),
    ]

    # ---- 3. the offline driver (single kNN) ----------------------------------
    _stamp("phase 3")
    gt = drive_gt[:frames]

    def run_offline():
        # the renderer's numpy array, no device: odometry_offline moves it to the GPU
        return T.odometry_offline(scans_np, lidar, fp, rp, chunk_pairs=4, motion_init=True)

    def same_run(what, traj_a, det_a, traj_b, det_b):
        """The pruning's switches move no pose bit, termination or iteration count."""
        _require_equal(f"{what} translations, seeded vs not", traj_a.translation, traj_b.translation)
        _require_equal(f"{what} rotations, seeded vs not", traj_a.rotation, traj_b.rotation)
        _require_equal(f"{what} terminations, seeded vs not", det_a.termination, det_b.termination)
        _require_equal(f"{what} iterations, seeded vs not", det_a.num_iterations, det_b.num_iterations)
        print(f"{what}: poses bit-equal, terminations and iteration counts equal with and without "
              f"{' and '.join(UNSEEDED)}")

    reps = 2  # timed runs after a warm-up, for every scans/s figure
    with _dual_knn(False):
        traj, details = drive("offline", run_offline, extraction + ("knn",), ("knn_dual",))
        if not traj.translation.is_cuda:
            raise AssertionError("odometry_offline ran a numpy input off the GPU")
        ate, limit, path = _check_trajectory("offline", traj.translation, traj.rotation, frames, gt,
                                             ate_rmse)
        print(f"ATE {ate:.6f} m (limit {limit:.6f} m, path {path:.3f} m); "
              f"iterations {details.num_iterations.tolist()}; termination {details.termination.tolist()}")
        dt = _seconds_per_run(run_offline, reps)
        with _env(**UNSEEDED):
            same_run("offline", traj, details, *run_offline())
            dt_unseeded = _seconds_per_run(run_offline, reps)
    offline_sps = frames / dt
    print(f"main path: {offline_sps:.3f} scans/s ({dt * 1e3:.3f} ms per {frames}-frame run, "
          f"64x1024, chunk_pairs=4; {frames / dt_unseeded:.3f} scans/s with LOAM_KNN_SEED=0) on {smi}")

    # ---- 4. small-input agreement with the plain versions on the CPU -------
    _stamp("phase 4")
    small = T.LidarParams(16, 360, 0.5, 80.0)
    s_np, _ = render_trajectory(small, 6, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.02,
                                noise=0.003, seed=11, dtype=np.float32)
    s_gpu, s_cpu = torch.from_numpy(s_np).to(dev), torch.from_numpy(s_np)
    small_cfg = T.ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)

    def s2s_loop(x, lid):
        state = T.scan_to_scan_init(lid, fp, device=x.device)
        out = []
        with torch.profiler.record_function(program.DRIVER_RANGE):
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
    from loam_tpu_torch.registration import loop as icf_loop

    icf_loop.clear_cache()
    est_g, det_g64 = T.register_features(src64, tgt64, params=rp)
    if knn_cuda.knn_run.launches or knn_cuda.knn_dual_run.launches:
        raise AssertionError("a float64 registration launched the kNN kernel")
    # ... through the one-program loop: one graph, its later iterations under one WHILE node
    f64_programs = [g for g in icf_loop.graph_stats() if g.get("dtype") == "torch.float64"]
    if len(f64_programs) != 1 or f64_programs[0]["conditional_nodes"] != {"if": 0, "while": 1}:
        raise AssertionError(f"the float64 registration was not one captured program: {icf_loop.graph_stats()}")
    with icf_loop._eager():
        est_e, det_e64 = T.register_features(src64, tgt64, params=rp)
    for a, b in zip(_leaves((est_g, det_g64)), _leaves((est_e, det_e64))):
        _require_equal("float64 registration, graph vs eager", a, b)
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
    print(f"small input, float64 register_features: one captured program (one WHILE node, "
          f"{f64_programs[0]['nodes']} nodes), bit-equal to the eager loop; GPU vs CPU {gap:.3e} m (limit {ATOL_F64_M}), "
          f"{int(det_g64.num_iterations)} iterations, no kNN kernel launched; k = 9 search (the kernel's "
          f"wide form) equal to the plain one")
    if not gap < ATOL_F64_M:
        raise AssertionError(f"float64 registration: GPU and CPU differ by {gap} m")

    # ---- 5. the offline driver with the dual kNN ------------------------------
    _stamp("phase 5")
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
    _stamp("phase 6")
    def run_s2m():
        return T.scan_to_map_offline(scans, lidar, fp, s2m_reg, s2m_cfg)

    # the rebuild-on-insert prep cache and the seeded single kNN, as
    # loam_tpu runs scan-to-map on its accelerator; then neither
    from loam_tpu_torch.odometry.scan_to_map import _build_prep_cache

    with _dual_knn(False):
        st, traj_m, det_m = drive("scan_to_map", run_s2m, extraction + ("knn",), ("knn_dual",))
        ate_m, limit_m, _ = _check_trajectory("scan_to_map", traj_m.translation, traj_m.rotation,
                                              frames, gt, ate_rmse)
        if int(st.dropped) != 0:
            raise AssertionError(f"scan_to_map dropped {int(st.dropped)} voxels")
        if len(st.knn_prep_cache) != 16:
            raise AssertionError(f"scan_to_map on the card carried a cache of {len(st.knn_prep_cache)} entries")
        fresh = _build_prep_cache(st.edge_map, st.planar_map, fp.edge_capacity(lidar),
                                  fp.planar_capacity(lidar))
        rebuilt = T.scan_to_map_rebuild_cache(T.scan_to_map_strip_cache(st), lidar, fp)
        for i, (a, b, c) in enumerate(zip(st.knn_prep_cache, fresh, rebuilt.knn_prep_cache)):
            _require_equal(f"scan_to_map prep cache entry {i} after the inserts vs built fresh", a, b)
            _require_equal(f"scan_to_map prep cache entry {i} rebuilt vs built fresh", c, b)
        print("scan_to_map: the prep cache after the inserts equals one built fresh from the final maps, "
              "and so does strip + rebuild (16 entries)")
        dt_m = _seconds_per_run(run_s2m, reps)
        with _env(**UNSEEDED):
            st0, traj0, det0 = run_s2m()
            if st0.knn_prep_cache != ():
                raise AssertionError("LOAM_S2M_PREP_CACHE=0 still carried a cache")
            same_run("scan_to_map", traj_m, det_m, traj0, det0)
            _require_equal("scan_to_map planar map, cached vs not", st.planar_map.points, st0.planar_map.points)
            dt_m0 = _seconds_per_run(run_s2m, reps)
    print(f"scan_to_map: ATE {ate_m:.6f} m (limit {limit_m:.6f} m); maps {int(st.edge_map.size)} / "
          f"{st.edge_map.points.shape[0]} edge, {int(st.planar_map.size)} / "
          f"{st.planar_map.points.shape[0]} planar slots, dropped 0; iterations "
          f"{det_m.num_iterations.tolist()}; termination {det_m.termination.tolist()}")
    print(f"scan_to_map: {frames / dt_m:.3f} scans/s ({dt_m * 1e3:.3f} ms per {frames}-frame run, "
          f"64x1024, default ScanToMapConfig, the prep cache and the seeded single kNN; "
          f"{frames / dt_m0:.3f} scans/s with neither) on {smi}")

    # ---- 7. scan-to-scan with dewarping ----------------------------------------
    _stamp("phase 7")
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
    _stamp("phase 8")
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
    _stamp("phase 9")
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
    _stamp("phase 10")
    from loam_tpu_torch.io import native_available
    from loam_tpu_torch.loop_closure import closure_edges, join_edges, propose_candidates, verify_closures
    from loam_tpu_torch.pose_graph import odometry_edges
    from loam_tpu_torch.registration import azimuth_sort_features

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
        with _env(**UNSEEDED):
            same_run("loop odometry", traj_l, det_l, *run_file_odometry())
            _, (opt_u, clo_u) = run_closures()
            for what in ("accepted", "inlier_frac", "mean_residual"):
                _require_equal(f"loop closures {what}, seeded vs not", getattr(clo_l, what), getattr(clo_u, what))
            _require_equal("loop closure optimized translations, seeded vs not", opt_l.translation,
                           opt_u.translation)
        kw = LOOP_CLOSURE_KW
        cand = propose_candidates(traj_l, kw["max_candidates"], kw["min_separation"], kw["max_distance"])
        # the kernels at this path's shapes against their plain versions: the
        # extraction kernels on the keyframes' lines, and the single kNN on
        # the candidate pairs verify_closures registers (keyframe j's
        # features against keyframe i's, masked queries, both azimuth-sorted
        # as the registration sorts them), at its first ICF iteration (the
        # odometry's relative poses) and at the verified poses
        loop_rows = _extraction_kernels(loop_scans, lidar, fp, "_loop")
        ci, cj = cand[0].long(), cand[1].long()
        inv = quat_conjugate(traj_l.rotation[ci])
        first = Pose3(quat_multiply(inv, traj_l.rotation[cj]),
                      quat_rotate(inv, traj_l.translation[cj] - traj_l.translation[ci]))
        src_l = azimuth_sort_features(feats_l.map(lambda x: x[cj]))
        tgt_l = azimuth_sort_features(feats_l.map(lambda x: x[ci]))
        loop_knn_err = 0.0
        for at, pose in (("first iteration", first), ("verified", clo_l.measurement)):
            for cls, k, r in (("planar", rp.num_plane_neighbors, rp.max_plane_neighbor_dist),
                              ("edge", rp.num_edge_neighbors, rp.max_edge_neighbor_dist)):
                prep = knn_cuda.knn_prep(getattr(tgt_l, f"{cls}_points"), getattr(tgt_l, f"{cls}_mask"))
                q = (quat_rotate(pose.rotation[:, None], getattr(src_l, f"{cls}_points"))
                     + pose.translation[:, None]).contiguous()
                qm = getattr(src_l, f"{cls}_mask").contiguous()
                loop_knn_err = max(loop_knn_err, _check_single_knn(f"knn loop {cls} {at}", knn_cuda, prep, q,
                                                                   k, r, qm, dict(seed_window=True)))
                if cls == "planar" and at == "first iteration":
                    loop_knn = (prep, q, k, r, qm, getattr(tgt_l, f"{cls}_mask"),
                                _plain_seed(knn_cuda, q, tgt_l.planar_points, tgt_l.planar_mask, k))
        if loop_knn_err != 0.0:
            raise AssertionError(f"knn on the loop's pairs differs from the plain version by {loop_knn_err}")
        prep, q, k, r, qm, tmask, want = loop_knn
        loop_rows.append(_knn_row(
            "knn_loop", knn_cuda, prep, q, k, r, qm, tmask, loop_knn_err,
            f"B={len(ci)} candidate pairs, Q=M={q.shape[1]} planar (and {src_l.edge_points.shape[1]} edge), "
            f"k={k}, n_live {prep.n_live.tolist()}, {int(qm.sum())} searching queries, first ICF iteration, "
            f"cold seed bound", dict(seed_window=True), want))
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
    _stamp("phase 11")
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
        if dtype == torch.float64:
            opt64 = opt_k
    # float32's rounding against the float64 solve and the truth
    gap_t = _max_err(opt_k.translation.double(), opt64.translation)
    gap_q = _max_err(opt_k.rotation.double(), opt64.rotation)
    print(f"pose graph float32 vs float64: {gap_t:.3e} m, {gap_q:.3e} (quaternion); vs the truth {err:.3e} m "
          f"(limit {ATOL_GRAPH_F32_M} m)")
    if not (gap_t <= ATOL_GRAPH_F32_M and err <= ATOL_GRAPH_F32_M):
        raise AssertionError(f"pose graph float32: {gap_t} m from the float64 solve, {err} m from the truth")

    # ---- 12. the sharded paths on a mesh of four shards of this GPU ----------------------
    _stamp("phase 12")
    kernels += _sharded_phase(T, torch, dev, smi, scans, scans_np, lidar, fp, rp, gt, frames, drive,
                              extraction, ate_rmse, knn_cuda, gt1k, init1k, edges1k, opt64, reps)

    # ---- 13. the f64 oracle on the card ----------------------------------------------------
    _stamp("phase 13")
    _oracle_phase(T, torch, dev, smi, scans_np, lidar, fp, rp, oracle_knn, counters)

    # ---- 14. widths past the register forms, the offline driver at 64x2083, the examples
    _stamp("phase 14")
    kernels += _wide_phase(T, torch, dev, smi, drive, extraction, rp, ate_rmse)

    # ---- 15. one program a frame or chunk against the eager drivers, at full width ----
    _stamp("phase 15")
    single = (extraction + ("knn",), ("knn_dual",))
    dual = (extraction + ("knn_dual",), ("knn",))

    def run_s2m_dewarp():
        return T.scan_to_map_offline(scans, lidar, fp, s2m_reg, s2m_cfg, dewarp=True)

    with _dual_knn(False):
        st_w, traj_w, _ = drive("scan_to_map_dewarp", run_s2m_dewarp, single[0], single[1])
    ate_w, limit_w, _ = _check_trajectory("scan_to_map dewarp", traj_w.translation, traj_w.rotation,
                                          frames, gt, ate_rmse)
    if int(st_w.dropped) != 0:
        raise AssertionError(f"scan_to_map dewarp dropped {int(st_w.dropped)} voxels")
    print(f"scan_to_map dewarp: ATE {ate_w:.6f} m (limit {limit_w:.6f} m), dropped 0")
    # units: one a call for the trajectory drivers, a frame or chunk for the others
    graph_cells = {
        "offline-64x1024-c4": (run_offline, 1, dict(LOAM_ICF_DUAL_KNN="0"), *single),
        "offline-64x1024-c4-dual": (run_offline, 1, dict(LOAM_ICF_DUAL_KNN="1"), *dual),
        "s2m-64x1024": (run_s2m, 1, dict(LOAM_ICF_DUAL_KNN="0"), *single),
        "s2m-64x1024-dewarp": (run_s2m_dewarp, 1, dict(LOAM_ICF_DUAL_KNN="0"), *single),
        "s2s-64x1024-dewarp": (run_s2s, frames, dict(LOAM_ICF_DUAL_KNN="1"), *dual),
        "stream-64x1024-k8": (lambda: run_stream(True), -(-frames // chunk), dict(LOAM_ICF_DUAL_KNN="0"),
                              *single),
    }
    # the grid and the loop-closed back end: phase 8's grid call, phase
    # 11's graph, phase 10's closures, each held to its phase's gates
    no_kernel = extraction + ("knn", "knn_dual")
    pg64 = (_to(init1k, dev, torch.float64), _to(edges1k, dev, torch.float64))
    pg32 = (_to(init1k, dev, torch.float32), _to(edges1k, dev, torch.float32))
    pg_cost0 = {torch.float64: float(_cost(*pg64)), torch.float32: float(_cost(*pg32))}

    def check_grid(out):
        st, traj_, det_ = out
        _check_trajectory("s2m-64x1024-grid", traj_.translation, traj_.rotation, frames, gt, ate_rmse)
        info = det_.iteration_info
        ovf = int(info.edge_knn_overflow.sum()), int(info.plane_knn_overflow.sum())
        if int(st.dropped) != 0 or ovf != (0, 0):
            raise AssertionError(f"s2m-64x1024-grid: dropped {int(st.dropped)}, overflow {ovf}")

    def check_graph(out):
        opt, cost = out
        dtype = opt.translation.dtype
        if not float(cost) < pg_cost0[dtype]:
            raise AssertionError(f"posegraph-1000 {dtype}: the cost did not fall")
        err = _max_err(opt.translation.cpu(), gt1k.translation)
        if dtype == torch.float64 and not err < ATOL_GRAPH_TRUTH_M:
            raise AssertionError(f"posegraph-1000 float64: {err} m from the true poses")

    def check_closures(out):
        opt, clo = out
        got = [p for p, a in zip(zip(clo.i.tolist(), clo.j.tolist()), clo.accepted.tolist()) if a]
        t = opt.translation.cpu().numpy()
        ate, _, _ = _check_trajectory("loop-64x1024-closures", opt.translation, opt.rotation, n_kf,
                                      loop_pos, ate_rmse)
        end = float(np.linalg.norm(t[-1] - t[0]))
        if (0, n_kf - 1) not in got or not (end < 0.5 * end0 or end < 0.02) or not ate <= ate_o:
            raise AssertionError(f"loop-64x1024-closures: accepted {got}, end gap {end0} -> {end} m, "
                                 f"ATE {ate_o} -> {ate} m")

    loop_closures = lambda: optimize_trajectory_with_closures(traj_l, feats_l, rp, **LOOP_CLOSURE_KW)
    graph_cells.update({
        "s2m-64x1024-grid": (run_s2m_grid, 1, dict(LOAM_ICF_DUAL_KNN="0"), extraction, ("knn", "knn_dual"),
                             dict(check=check_grid)),
        "posegraph-1000-f64": (lambda: optimize_pose_graph(*pg64, 10), 1, {}, (), no_kernel,
                               dict(check=check_graph, rate=False)),
        "posegraph-1000-f32": (lambda: optimize_pose_graph(*pg32, 10), 1, {}, (), no_kernel,
                               dict(check=check_graph, rate=False)),
        "loop-64x1024-closures": (loop_closures, 1, dict(LOAM_ICF_DUAL_KNN="0"), ("knn",),
                                  extraction + ("knn_dual",), dict(check=check_closures, rate=False)),
    })
    one_program = _graph_phase(torch, smi, frames, drive, path_launches, graph_cells, reps)
    # the drive's first 64 frames: the sharded cells at 16 and 64 frames
    # (offline-c4, s2m and s2m-grid at 16, 64 and 128: phase 16)
    long = torch.from_numpy(drive_np[:64]).to(dev)
    one_program["graph_size"] = _graph_size_phase(smi, {
        "posegraph-1000-f64": {n: (lambda n=n: optimize_pose_graph(*pg64, n)) for n in (10, 40)},
    }, unit={"posegraph-1000-f64": "iterations"})
    one_program.update(_sharded_graph_phase(T, torch, dev, smi, scans, long, lidar, fp, rp, frames, drive,
                                            path_launches, extraction, reps, pg64, gt1k, opt64))
    print(json.dumps({"one_program": one_program}))

    # ---- 16. the drive: 128 frames, float32 against float64, each call one program ----
    _stamp("phase 16")
    _drive_phase(T, torch, dev, smi, drive_np, drive_gt, lidar, fp, rp, s2m_reg, s2m_cfg, grid_reg, drive,
                 extraction, knn_cuda, ate_rmse)

    # ---- 17. one rank a card: the sharded drivers over NCCL across the cards ----
    _stamp("phase 17")
    _ranks_phase(T, torch, smi, scans_np, gt, counters, path_launches, ate_rmse, reps)

    _stamp("phases done")
    for kd in kernels:
        counter = kd.get("counter", kd["name"])
        # an extraction row counts the launches of its own shape's paths: a
        # wide row those of phase 14 at its shape, the others those of
        # phases 3-12
        shape = kd["name"].split("_wide_")[1] if "_wide_" in kd["name"] else None
        kd["launches_by_path"] = {
            path: lc[counter] for path, lc in path_launches.items()
            if counter not in extraction
            or (path.endswith(f"_{shape}") if shape else not path.startswith("wide_"))}
        kd["launches"] = sum(kd["launches_by_path"].values())

    print(json.dumps({"kernels": [
        {k: kd[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                            "plain_ms", "bound_ms", "bound_by", "library_ms", "launch_ms", "launches_by_path",
                            "shape")}
        | {k: kd[k] for k in ("host_us", "library_launch_ms", "graph_nodes", "accepts_max",
                              "accepts_mean", "visits", "live_boxes", "visits_share", "evaluations",
                              "seeded") if k in kd}
        for kd in kernels
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
