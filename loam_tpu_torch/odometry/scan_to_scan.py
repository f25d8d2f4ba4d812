"""Streaming scan-to-scan odometry.

Counterpart of ``loam_tpu.odometry.scan_to_scan`` (the reference README's
user loop, ``README.md:44-60``): extract features from each incoming scan,
register them against the previous scan's features, accumulate the relative
pose. Optional: a constant-velocity motion prior (start each registration
from the previous relative pose) and dewarping of the sweep with it.

The first frame needs no special case: registering against the initial
empty feature set ends with ``INSUFFICIENT_ASSOCIATIONS`` before solving,
leaving the pose at its init, the identity.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import program
from ..device import resolve
from ..dewarp import dewarp_scan
from ..features import FeatureSet, extract_features
from ..geometry import Pose3
from ..params import FeatureExtractionParams, LidarParams, RegistrationParams
from ..registration import RegistrationDetail, azimuth_sort_features, register_features
from ..registration.loop import driver_program


class ScanToScanState(NamedTuple):
    """Carry of the loop. ``prev_delta`` is last frame's ``prev_T_current``,
    the constant-velocity prior of the next registration."""

    world_T_current: Pose3
    prev_features: FeatureSet
    prev_delta: Pose3

    @staticmethod
    def from_numpy(state, device=None) -> "ScanToScanState":
        """The state of any three-field carry of array-likes, e.g. a
        ``loam_tpu`` ``ScanToScanState`` (dtypes kept), on the card unless
        ``device`` says otherwise (``device.py``)."""
        pose = lambda p: Pose3.from_numpy(p, device=device)
        return ScanToScanState(pose(state.world_T_current),
                               FeatureSet.from_numpy(state.prev_features, device=device),
                               pose(state.prev_delta))


def scan_to_scan_init(
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    dtype=torch.float32,
    device=None,
) -> ScanToScanState:
    """Initial state: identity pose, empty previous features, on the card
    unless ``device`` says otherwise (``device.py``)."""
    device = resolve(device)
    e_cap = feat_params.edge_capacity(lidar)
    p_cap = feat_params.planar_capacity(lidar)
    i32 = dict(dtype=torch.int32, device=device)
    empty = FeatureSet(
        edge_points=torch.zeros((e_cap, 3), dtype=dtype, device=device),
        edge_mask=torch.zeros((e_cap,), dtype=torch.bool, device=device),
        edge_indices=torch.full((e_cap,), -1, **i32),
        planar_points=torch.zeros((p_cap, 3), dtype=dtype, device=device),
        planar_mask=torch.zeros((p_cap,), dtype=torch.bool, device=device),
        planar_indices=torch.full((p_cap,), -1, **i32),
    )
    return ScanToScanState(
        world_T_current=Pose3.identity(dtype, device=device),
        prev_features=empty,
        prev_delta=Pose3.identity(dtype, device=device),
    )


def scan_to_scan_step(
    state: ScanToScanState,
    scan: torch.Tensor,
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: RegistrationParams = RegistrationParams(),
    use_motion_prior: bool = True,
    dewarp: bool = False,
) -> Tuple[ScanToScanState, Pose3, RegistrationDetail]:
    """Process one scan; returns (new_state, world_T_current, detail).

    ``dewarp=True`` motion-compensates the sweep with the previous relative
    pose (constant velocity) before extraction. The frame (dewarp,
    extraction, azimuth sort, registration, compose) is one program
    (``program.py``): eager on the CPU, one CUDA-graph launch on the card;
    the state is copied in and returned as clones.
    """
    inputs = (state, scan)

    def fn(bufs):
        return _frame(*bufs, lidar, feat_params, reg_params, use_motion_prior, dewarp)

    prog = driver_program(scan.device, ("scan_to_scan", lidar, feat_params, use_motion_prior, dewarp),
                          inputs, reg_params, path="scan_to_scan")
    world, detail = prog.own(prog.run(fn, inputs))
    return program.clone(prog.buffers[0]), world, detail


def _frame(state: ScanToScanState, scan, lidar, feat_params, reg_params, use_motion_prior,
           dewarp) -> Tuple[Pose3, RegistrationDetail]:
    """One frame over ``state``'s tensors, updated in place once every read
    of them is done: returns (world_T_current, detail)."""
    if dewarp:
        scan = dewarp_scan(scan, state.prev_delta, lidar)
    feats = azimuth_sort_features(extract_features(scan, lidar, feat_params))
    dtype = feats.edge_points.dtype
    init = state.prev_delta if use_motion_prior else Pose3.identity(dtype, device=scan.device)
    # prev_T_current: the current scan is the source, the previous the
    # target; both sides are stored azimuth-sorted
    delta, detail = register_features(feats, state.prev_features, init, reg_params,
                                      with_matches=False, reorder_mode="none")
    world = state.world_T_current.compose(delta).normalize()
    program.copy_into(state, (world, feats, delta))
    return world, detail
