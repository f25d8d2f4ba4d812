"""Scan-to-map odometry against local voxel maps.

Counterpart of ``loam_tpu.odometry.scan_to_map`` (BASELINE config 3): the
registration targets are fixed-capacity voxel maps of the accumulated edge
and planar features, in the world frame, instead of the previous scan. The
initial estimate is a constant-velocity prediction, which the solver also
uses as a prior (``prior_weight``); a frame is inserted into the maps when
it has moved far enough from the last keyframe.

Differences from ``loam_tpu``, none of which changes a result:

  * The keyframe ``lax.cond`` is a host ``if`` on one synced bool a frame.
  * ``knn_prep_cache`` is always ``()``, as ``loam_tpu`` carries it on any
    non-TPU backend: its cached Pallas chunk boxes and seed windows only
    prune kNN visits, and the port's kernel visits every target.
  * The state also counts the voxels the map inserts dropped for capacity
    (``dropped``), which ``loam_tpu``'s driver discards.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import place, resolve
from ..dewarp import dewarp_scan
from ..features import FeatureSet, extract_features, extract_features_batch
from ..geometry import Pose3, norm, quat_conjugate, quat_multiply
from ..map import VoxelMap, voxel_map_empty, voxel_map_insert
from ..params import FeatureExtractionParams, LidarParams, RegistrationParams
from ..registration import RegistrationDetail, register_features, spatial_sort_features
from ..registration.detail import tree_map


@dataclasses.dataclass(frozen=True)
class ScanToMapConfig:
    """Static configuration of the scan-to-map driver (``loam_tpu``'s fields
    and defaults)."""

    #: Voxel edge length for the edge-feature map (m).
    edge_voxel_size: float = 0.2
    #: Voxel edge length for the planar-feature map (m).
    planar_voxel_size: float = 0.4
    #: Capacity (slots) of the edge map.
    edge_capacity: int = 1 << 15
    #: Capacity (slots) of the planar map.
    planar_capacity: int = 1 << 17
    #: Evict map points farther than this from the sensor (0 disables).
    keep_radius: float = 100.0
    #: Insert a keyframe when translation since the last one exceeds this (m).
    keyframe_dist: float = 0.5
    #: ... or when rotation since the last one exceeds this (rad).
    keyframe_angle: float = 0.1


class ScanToMapState(NamedTuple):
    """Carry of the scan-to-map loop."""

    edge_map: VoxelMap
    planar_map: VoxelMap
    world_T_current: Pose3
    prev_delta: Pose3
    world_T_keyframe: Pose3
    frames_since_insert: torch.Tensor  # int32; -1 means "no keyframe yet"
    #: Always () in the port (see the module docstring).
    knn_prep_cache: tuple = ()
    #: Count of occupied voxels the inserts so far dropped for capacity
    #: (an int32 tensor once a keyframe was inserted).
    dropped: torch.Tensor = 0

    @staticmethod
    def from_numpy(state, device=None, mesh=None) -> "ScanToMapState":
        """The state of a ``loam_tpu`` ``ScanToMapState`` (leaves through
        ``np.asarray``, dtypes kept; its prep cache is dropped, ``dropped``
        starts at 0), on the card unless ``device`` says otherwise
        (``device.py``). With a ``mesh`` (``parallel.make_mesh``) the state is
        a sharded one, its map leaves (D, C, ...) over every shard
        (``parallel.distributed.scan_to_map_init_sharded``): this rank keeps
        its shards' rows, on the mesh's device."""
        if mesh is not None:
            device = mesh.device
            rows = list(mesh.shard_ids)
            state = state._replace(**{
                name: VoxelMap(np.asarray(m.points)[rows], np.asarray(m.mask)[rows], m.voxel_size,
                               m.origin)
                for name, m in (("edge_map", state.edge_map), ("planar_map", state.planar_map))})
        pose = lambda p: Pose3.from_numpy(p, device=device)
        return ScanToMapState(
            edge_map=VoxelMap.from_numpy(state.edge_map, device),
            planar_map=VoxelMap.from_numpy(state.planar_map, device),
            world_T_current=pose(state.world_T_current),
            prev_delta=pose(state.prev_delta),
            world_T_keyframe=pose(state.world_T_keyframe),
            frames_since_insert=place(state.frames_since_insert, device, torch.int32),
        )


def scan_to_map_init(
    config: ScanToMapConfig = ScanToMapConfig(),
    origin=(0.0, 0.0, 0.0),
    dtype=torch.float32,
    lidar: Optional[LidarParams] = None,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    device=None,
) -> ScanToMapState:
    """Initial mapping state: empty maps around ``origin``, identity poses,
    on the card unless ``device`` says otherwise (``device.py``).
    ``lidar`` and ``feat_params`` are accepted for API compatibility (they
    size ``loam_tpu``'s prep cache)."""
    device = resolve(device)
    return ScanToMapState(
        edge_map=voxel_map_empty(config.edge_capacity, config.edge_voxel_size, origin, dtype, device),
        planar_map=voxel_map_empty(config.planar_capacity, config.planar_voxel_size, origin, dtype, device),
        world_T_current=Pose3.identity(dtype, device=device),
        prev_delta=Pose3.identity(dtype, device=device),
        world_T_keyframe=Pose3.identity(dtype, device=device),
        frames_since_insert=torch.tensor(-1, dtype=torch.int32, device=device),
    )


def scan_to_map_strip_cache(state: ScanToMapState) -> ScanToMapState:
    """``state`` with the kNN prep cache dropped (it is derived state)."""
    return state._replace(knn_prep_cache=())


def scan_to_map_rebuild_cache(
    state: ScanToMapState,
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
) -> ScanToMapState:
    """The inverse of :func:`scan_to_map_strip_cache`: the cache is inactive
    in the port, as in ``loam_tpu`` on a non-TPU backend, so it stays ()."""
    return state._replace(knn_prep_cache=())


def _map_feature_set(edge_map: VoxelMap, planar_map: VoxelMap) -> FeatureSet:
    e, p = edge_map.points.shape[0], planar_map.points.shape[0]
    dev = edge_map.points.device
    return FeatureSet(
        edge_points=edge_map.points,
        edge_mask=edge_map.mask,
        edge_indices=torch.full((e,), -1, dtype=torch.int32, device=dev),
        planar_points=planar_map.points,
        planar_mask=planar_map.mask,
        planar_indices=torch.full((p,), -1, dtype=torch.int32, device=dev),
    )


def default_map_reg_params() -> RegistrationParams:
    """Map-target registration defaults: the exact brute-force search (the
    kNN kernel) with the solver prior, ``loam_tpu``'s choice on its
    accelerator. ``loam_tpu`` picks its voxel grid off the accelerator; the
    port's is there for the asking, ``RegistrationParams(search_backend=
    "grid", prior_weight=300.0)``, and is plain tensor code on either
    device."""
    return RegistrationParams(search_backend="bruteforce", prior_weight=300.0)


def scan_to_map_step(
    state: ScanToMapState,
    scan: torch.Tensor,
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: Optional[RegistrationParams] = None,
    config: ScanToMapConfig = ScanToMapConfig(),
    dewarp: bool = False,
) -> Tuple[ScanToMapState, Pose3, RegistrationDetail]:
    """Process one scan against the maps; returns (state, world pose,
    detail). Flow: optional dewarp with the constant-velocity motion,
    extraction, Morton sort, then :func:`scan_to_map_step_features`.
    ``reg_params=None`` uses :func:`default_map_reg_params`."""
    if dewarp:
        scan = dewarp_scan(scan, state.prev_delta, lidar)
    feats = spatial_sort_features(extract_features(scan, lidar, feat_params))
    return scan_to_map_step_features(state, feats, reg_params=reg_params, config=config)


def scan_to_map_step_features(
    state: ScanToMapState,
    feats: FeatureSet,
    reg_params: Optional[RegistrationParams] = None,
    config: ScanToMapConfig = ScanToMapConfig(),
) -> Tuple[ScanToMapState, Pose3, RegistrationDetail]:
    """:func:`scan_to_map_step` from extracted, Morton-sorted features."""
    if reg_params is None:
        reg_params = default_map_reg_params()

    init = state.world_T_current.compose(state.prev_delta)  # constant velocity
    target = _map_feature_set(state.edge_map, state.planar_map)
    world_T_new, detail = register_features(feats, target, init, reg_params, with_matches=False)
    # first frame (empty map): registration bails at the init pose; the
    # trajectory starts at the state's pose instead of the prediction
    first = state.frames_since_insert < 0
    world_T_new = Pose3(torch.where(first, state.world_T_current.rotation, world_T_new.rotation),
                        torch.where(first, state.world_T_current.translation, world_T_new.translation))

    # keyframe decision: motion since the last inserted keyframe
    rel_q = quat_multiply(quat_conjugate(state.world_T_keyframe.rotation), world_T_new.rotation)
    angle = 2.0 * torch.atan2(norm(rel_q[1:]), torch.abs(rel_q[0]))
    dist = norm(world_T_new.translation - state.world_T_keyframe.translation)
    insert = first | (dist > config.keyframe_dist) | (angle > config.keyframe_angle)

    edge_map, planar_map, dropped = state.edge_map, state.planar_map, state.dropped
    if bool(insert):
        center = world_T_new.translation
        edge_map, de = voxel_map_insert(edge_map, world_T_new.act(feats.edge_points),
                                        feats.edge_mask, center, config.keep_radius)
        planar_map, dp = voxel_map_insert(planar_map, world_T_new.act(feats.planar_points),
                                          feats.planar_mask, center, config.keep_radius)
        dropped = dropped + de + dp

    prev_delta = state.world_T_current.inverse().compose(world_T_new).normalize()
    new_state = ScanToMapState(
        edge_map=edge_map,
        planar_map=planar_map,
        world_T_current=world_T_new.normalize(),
        prev_delta=prev_delta,
        world_T_keyframe=Pose3(
            torch.where(insert, world_T_new.rotation, state.world_T_keyframe.rotation),
            torch.where(insert, world_T_new.translation, state.world_T_keyframe.translation)),
        frames_since_insert=torch.where(
            insert, 0, torch.clamp(state.frames_since_insert, min=0) + 1).to(torch.int32),
        knn_prep_cache=(),
        dropped=dropped,
    )
    return new_state, world_T_new, detail


def scan_to_map_offline(
    scans,
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: Optional[RegistrationParams] = None,
    config: ScanToMapConfig = ScanToMapConfig(),
    dewarp: bool = False,
    init_state: Optional[ScanToMapState] = None,
    hoist_extraction: bool = True,
    device=None,
) -> Tuple[ScanToMapState, Pose3, RegistrationDetail]:
    """Whole-trajectory scan-to-map odometry over stacked scans (F, L, P, 3)
    or (F, L*P, 3). A numpy array is moved to the card, or to ``device``; a
    tensor runs where it lies unless ``device`` names another (``device.py``).

    The frames run in order (each registers against the maps built so far).
    With ``hoist_extraction`` and no ``dewarp`` the features of all frames
    are extracted in one batch first; dewarping needs each frame's motion,
    so it extracts frame by frame.

    Returns: (final state, trajectory Pose3 with (F, ...) leaves, per-frame
    RegistrationDetail stacked on a leading axis).
    """
    scans = place(scans, device)
    if reg_params is None:
        reg_params = default_map_reg_params()
    state = init_state if init_state is not None else scan_to_map_init(
        config, lidar=lidar, feat_params=feat_params, device=scans.device)

    poses, details = [], []
    if dewarp or not hoist_extraction:
        for f in range(scans.shape[0]):
            state, pose, det = scan_to_map_step(state, scans[f], lidar, feat_params,
                                                reg_params, config, dewarp)
            poses.append(pose)
            details.append(det)
    else:
        feats_all = extract_features_batch(scans, lidar, feat_params, post=spatial_sort_features)
        for f in range(scans.shape[0]):
            state, pose, det = scan_to_map_step_features(
                state, feats_all.map(lambda x: x[f]), reg_params, config)
            poses.append(pose)
            details.append(det)
    traj = tree_map(lambda *xs: torch.stack(xs), *poses)
    return state, traj, tree_map(lambda *xs: torch.stack(xs), *details)
