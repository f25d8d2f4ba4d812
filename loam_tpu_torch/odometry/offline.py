"""Batched offline odometry: the whole trajectory from stacked scans.

Counterpart of ``loam_tpu.odometry.offline`` (the reference leaves the
odometry loop to user code, ``README.md:44-60``):

  1. features of all frames extracted in one batch, each frame
     azimuth-sorted once (it serves as source and as target);
  2. the consecutive (source, target) pairs registered in lockstep chunks of
     ``chunk_pairs``, a Python loop over chunks, each one registration
     program (one CUDA-graph launch on the card); the last chunk is padded
     with copies of pair 0, whose results are dropped; with ``motion_init``
     every pair of a chunk starts from the last relative pose of the chunk
     before (a constant-velocity prior);
  3. relative poses composed into world poses.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import program
from ..device import place
from ..features import extract_features_batch
from ..geometry import Pose3, pose_cumcompose
from ..params import FeatureExtractionParams, LidarParams, RegistrationParams
from ..registration import RegistrationDetail, azimuth_sort_features, register_features_batch
from ..registration.detail import tree_map


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
    feats = extract_features_batch(scans, lidar, feat_params, post=azimuth_sort_features)
    dtype, dev = feats.edge_points.dtype, feats.edge_points.device
    src = feats.map(lambda x: x[1:])
    tgt = feats.map(lambda x: x[:-1])
    n_pairs = F - 1

    if chunk_pairs <= 0 or n_pairs <= chunk_pairs:
        init = Pose3.identity(dtype, (n_pairs,), dev)
        rel, details = register_features_batch(src, tgt, init, reg_params, reorder_mode="none")
    else:
        C = chunk_pairs
        nc = -(-n_pairs // C)
        pad = nc * C - n_pairs

        def padded(x):
            return torch.cat([x, x[:1].expand((pad,) + x.shape[1:])]) if pad else x

        src_p, tgt_p = src.map(padded), tgt.map(padded)
        carry = Pose3.identity(dtype, (), dev)
        rels, dets = [], []
        # one registration program a chunk (one CUDA-graph launch on the
        # card), the motion_init carry on the device: no read between chunks
        with torch.profiler.record_function(program.DRIVER_RANGE):
            for c in range(nc):
                part = lambda x: x[c * C : (c + 1) * C]
                if motion_init:
                    init = Pose3(carry.rotation.expand(C, 4), carry.translation.expand(C, 3))
                else:
                    init = Pose3.identity(dtype, (C,), dev)
                rel_c, det_c = register_features_batch(src_p.map(part), tgt_p.map(part), init,
                                                       reg_params, reorder_mode="none")
                carry = Pose3(rel_c.rotation[-1], rel_c.translation[-1])
                rels.append(rel_c)
                dets.append(det_c)
        rel = tree_map(lambda *xs: torch.cat(xs)[:n_pairs], *rels)
        details = tree_map(lambda *xs: torch.cat(xs)[:n_pairs], *dets)

    return compose_trajectory(rel), details


def compose_trajectory(rel: Pose3) -> Pose3:
    """World poses from relative ones: ``rel[i] = frame_i_T_frame_{i+1}``
    (F-1 leaves) prefix-composed, with frame 0 at identity (F leaves)."""
    world = pose_cumcompose(rel)
    first = Pose3.identity(rel.translation.dtype, (1,), rel.translation.device)
    return Pose3(
        torch.cat([first.rotation, world.rotation]),
        torch.cat([first.translation, world.translation]),
    )
