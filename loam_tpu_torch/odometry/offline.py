"""Batched offline odometry: the whole trajectory from stacked scans.

Counterpart of ``loam_tpu.odometry.offline`` (the reference leaves the
odometry loop to user code, ``README.md:44-60``). A call is one program
(``program.py``: eager on the CPU, one CUDA-graph launch on the card), as
``loam_tpu``'s is one ``jax.jit``:

  1. features of all frames extracted before the registrations, a block
     of frames at a time (``features.extract.extract_in_blocks``), each
     frame azimuth-sorted once (it serves as source and as target);
  2. the consecutive (source, target) pairs registered in lockstep chunks of
     ``chunk_pairs``, a ``program.scan`` over a device chunk index (one WHILE
     node on the card, ``loam_tpu``'s ``lax.scan``), each chunk's features
     gathered from the frames' by index; the last chunk is padded with pair
     0, whose results are dropped; with ``motion_init``
     every pair of a chunk starts from the last relative pose of the chunk
     before (a constant-velocity prior), carried in a buffer of the program;
  3. relative poses composed into world poses.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import program
from ..device import place
from ..features.extract import extract_in_blocks
from ..features.curvature import validate_scan
from ..geometry import Pose3, pose_cumcompose
from ..params import FeatureExtractionParams, LidarParams, RegistrationParams
from ..registration import RegistrationDetail, azimuth_sort_features, register_features_batch
from ..registration.detail import tree_map
from ..registration.loop import driver_program


def odometry_offline(
    scans,
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: RegistrationParams = RegistrationParams(),
    chunk_pairs: int = 1,
    motion_init: bool = False,
    device=None,
) -> Tuple[Pose3, RegistrationDetail]:
    """Whole-trajectory scan-to-scan odometry.

    Args:
      scans: (F, L, P, 3) or (F, L*P, 3) stacked scans. A numpy array is
        moved to the card, or to ``device``; a tensor runs where it lies
        unless ``device`` names another (``device.py``).
      chunk_pairs: pairs registered per lockstep batch; ``<= 0`` registers
        all pairs in one batch.
      motion_init: start each chunk's pairs from the previous chunk's last
        relative pose (needs chunking).

    Returns:
      (trajectory, details): ``trajectory`` is a Pose3 with (F, ...) leaves,
      ``world_T_frame_i`` with frame 0 at identity; ``details`` stacks the
      RegistrationDetail of the F-1 pairs.
    """
    scans = place(scans, device)
    F = scans.shape[0]
    if F < 2:
        raise ValueError(f"odometry needs at least 2 frames, got {F}")
    validate_scan(scans, lidar)
    chunk_pairs = chunk_pairs if 0 < chunk_pairs < F - 1 else 0
    prog = driver_program(scans.device, ("odometry_offline", lidar, feat_params, chunk_pairs,
                                         motion_init), scans, reg_params, path="odometry_offline",
                          frames=F)
    with torch.profiler.record_function(program.DRIVER_RANGE):
        out = prog.run(lambda s: _trajectory(s, lidar, feat_params, reg_params, chunk_pairs,
                                             motion_init), scans)
    return prog.own(out)


def _trajectory(scans, lidar, feat_params, reg_params, chunk_pairs, motion_init):
    """The program of :func:`odometry_offline`: ``chunk_pairs`` 0 registers
    every pair in one batch."""
    feats = extract_in_blocks(scans, lidar, feat_params, post=azimuth_sort_features)
    dtype, dev = feats.edge_points.dtype, feats.edge_points.device
    n_pairs = scans.shape[0] - 1
    if not chunk_pairs:
        src = feats.map(lambda x: x[1:])
        tgt = feats.map(lambda x: x[:-1])
        init = Pose3.identity(dtype, (n_pairs,), dev)
        rel, details = register_features_batch(src, tgt, init, reg_params, reorder_mode="none")
        return compose_trajectory(rel), details

    C = chunk_pairs
    nc = -(-n_pairs // C)
    carry = Pose3.identity(dtype, (), dev)  # the motion_init carry, before the scan
    offsets = torch.arange(C, device=dev)

    def chunk(c):
        """Chunk ``c`` (a device index): its registration, pair p taking
        frame p + 1 as source and frame p as target (a padding row pair
        0); the carry updated once the registration has read it."""
        rows = c * C + offsets
        rows = torch.where(rows < n_pairs, rows, torch.zeros_like(rows))
        src = feats.map(lambda x: x.index_select(0, rows + 1))
        tgt = feats.map(lambda x: x.index_select(0, rows))
        if motion_init:
            init = Pose3(carry.rotation.expand(C, 4), carry.translation.expand(C, 3))
        else:
            init = Pose3.identity(dtype, (C,), dev)
        rel_c, det_c = register_features_batch(src, tgt, init, reg_params, reorder_mode="none")
        program.copy_into(carry, Pose3(rel_c.rotation[-1], rel_c.translation[-1]))
        return rel_c, det_c

    rel, details = program.scan(nc, chunk, dev)
    pairs = lambda x: x.reshape((nc * C,) + x.shape[2:])[:n_pairs]
    return compose_trajectory(tree_map(pairs, rel)), tree_map(pairs, details)


def compose_trajectory(rel: Pose3) -> Pose3:
    """World poses from relative ones: ``rel[i] = frame_i_T_frame_{i+1}``
    (F-1 leaves) prefix-composed, with frame 0 at identity (F leaves)."""
    world = pose_cumcompose(rel)
    first = Pose3.identity(rel.translation.dtype, (1,), rel.translation.device)
    return Pose3(
        torch.cat([first.rotation, world.rotation]),
        torch.cat([first.translation, world.translation]),
    )
