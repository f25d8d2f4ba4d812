"""Scan-to-map odometry against local voxel maps.

Counterpart of ``loam_tpu.odometry.scan_to_map`` (BASELINE config 3): the
registration targets are fixed-capacity voxel maps of the accumulated edge
and planar features, in the world frame, instead of the previous scan. The
initial estimate is a constant-velocity prediction, which the solver also
uses as a prior (``prior_weight``); a frame is inserted into the maps when
it has moved far enough from the last keyframe.

A call of :func:`scan_to_map_step` is one program (``program.py``): eager
on the CPU, one CUDA-graph launch on the card, the keyframe insert under an
IF node where ``loam_tpu`` has its ``lax.cond``; it copies the state in and
returns clones. A call of :func:`scan_to_map_offline` is one program for the
whole trajectory: the frames a ``program.scan`` (one WHILE node) whose carry
is the state, as ``loam_tpu``'s ``lax.scan`` carries it.

Differences from ``loam_tpu``, none of which changes a result:

  * ``knn_prep_cache`` (``loam_tpu``'s rebuild-on-insert prep cache,
    ``scan_to_map.py:60-115, 271-324``) holds both maps' kNN planes, boxes
    and cold-seed windows, and also their live bounds ``n_live``, which the
    port's kernel reads; it is rebuilt only when a keyframe is inserted, and
    the step then searches the maps with the seeded single kNN. It is active
    where the kernel takes the maps (float32 on the card) and
    ``LOAM_S2M_PREP_CACHE`` is not ``"0"``, and ``()`` elsewhere, as
    ``loam_tpu`` carries it only on its accelerator; results are the same
    either way.
  * The state also counts the voxels the map inserts dropped for capacity
    (``dropped``), which ``loam_tpu``'s driver discards.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import program
from ..device import place, resolve
from ..dewarp import dewarp_scan
from ..features import FeatureSet, extract_features
from ..features.curvature import validate_scan
from ..features.extract import extract_in_blocks
from ..geometry import Pose3, norm, quat_conjugate, quat_multiply
from ..map import VoxelMap, voxel_map_empty, voxel_map_insert
from ..params import FeatureExtractionParams, LidarParams, RegistrationParams
from ..ops.knn_cuda import TargetPrep, default_tt, kernel_takes, knn_prep, window_candidates
from ..registration import RegistrationDetail, register_features, spatial_sort_features
from ..registration.detail import tree_map
from ..registration.icf import _register_impl
from ..registration.loop import driver_program


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
    #: kNN target state of both maps, rebuilt only on keyframe inserts:
    #: ``loam_tpu``'s (tT_e, rot_e, rbox_e, tT_p, rot_p, rbox_p,
    #: *edge_window(4), *planar_window(4)) and the port's (n_live_e,
    #: n_live_p); () where the cache is inactive (:func:`_use_prep_cache`).
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
            shards = np.shape(state.edge_map.mask)[0]
            if shards != mesh.size:
                raise ValueError(f"the state's maps hold {shards} shards, the mesh {mesh.size}")
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


def _use_prep_cache(points: torch.Tensor) -> bool:
    """Whether the state carries the rebuild-on-insert kNN prep cache
    (``loam_tpu``'s ``_use_prep_cache``): ``LOAM_S2M_PREP_CACHE`` (default
    ``"1"``) and the kernel takes the maps' ``points`` (float32 on the
    card). It only moves the maps' prep out of the frames without an insert
    and hands the search its seed windows; results are the same either
    way."""
    return os.environ.get("LOAM_S2M_PREP_CACHE", "1") == "1" and kernel_takes(points)


def _build_prep_cache(edge_map: VoxelMap, planar_map: VoxelMap, qe: Optional[int] = None,
                      qp: Optional[int] = None) -> tuple:
    """The kNN state of the current maps (:data:`ScanToMapState.knn_prep_cache`),
    with the cold-seed windows when the scan-side capacities ``qe`` / ``qp``
    are given: 16 entries, else 8."""
    e = knn_prep(edge_map.points, edge_map.mask)
    p = knn_prep(planar_map.points, planar_map.mask)
    base = (e.tT, e.rot, e.rbox, p.tT, p.rot, p.rbox)
    live = (e.n_live, p.n_live)
    if qe is None or qp is None:
        return base + live
    return (base + window_candidates(edge_map.points, edge_map.mask, qe)
            + window_candidates(planar_map.points, planar_map.mask, qp) + live)


def scan_to_map_init(
    config: ScanToMapConfig = ScanToMapConfig(),
    origin=(0.0, 0.0, 0.0),
    dtype=torch.float32,
    lidar: Optional[LidarParams] = None,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    device=None,
) -> ScanToMapState:
    """Initial mapping state: empty maps around ``origin``, identity poses,
    on the card unless ``device`` says otherwise (``device.py``). With
    ``lidar`` (and ``feat_params``) the state carries the kNN prep cache
    where it is active (:func:`_use_prep_cache`), its seed windows sized to
    the scan's feature capacities; without, it carries none, and the step
    prepares the maps every frame (the same results)."""
    device = resolve(device)
    edge_map = voxel_map_empty(config.edge_capacity, config.edge_voxel_size, origin, dtype, device)
    planar_map = voxel_map_empty(config.planar_capacity, config.planar_voxel_size, origin, dtype,
                                 device)
    cache = ()
    if lidar is not None and _use_prep_cache(edge_map.points):
        cache = _build_prep_cache(edge_map, planar_map, feat_params.edge_capacity(lidar),
                                  feat_params.planar_capacity(lidar))
    return ScanToMapState(
        edge_map=edge_map,
        planar_map=planar_map,
        world_T_current=Pose3.identity(dtype, device=device),
        prev_delta=Pose3.identity(dtype, device=device),
        world_T_keyframe=Pose3.identity(dtype, device=device),
        frames_since_insert=torch.full((), -1, dtype=torch.int32, device=device),
        knn_prep_cache=cache,
    )


def scan_to_map_strip_cache(state: ScanToMapState) -> ScanToMapState:
    """``state`` with the kNN prep cache dropped: it is derived state, so
    strip it before a checkpoint; the stripped state loads into a plain
    ``scan_to_map_init()`` template, and :func:`scan_to_map_rebuild_cache`
    derives it again."""
    return state._replace(knn_prep_cache=())


def scan_to_map_rebuild_cache(
    state: ScanToMapState,
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
) -> ScanToMapState:
    """The inverse of :func:`scan_to_map_strip_cache`: the kNN prep cache
    and seed windows of ``state``'s maps, or () where the cache is inactive
    (:func:`_use_prep_cache`)."""
    if not _use_prep_cache(state.edge_map.points):
        return state._replace(knn_prep_cache=())
    return state._replace(knn_prep_cache=_build_prep_cache(
        state.edge_map, state.planar_map, feat_params.edge_capacity(lidar),
        feat_params.planar_capacity(lidar)))


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
    "grid", prior_weight=300.0)``: plain tensor code on either device, and
    on the card captured like the kNN path, each frame's grids built and
    searched inside the trajectory's one CUDA graph (the searches inside
    the ICF loop's WHILE node)."""
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
    extraction, Morton sort, then :func:`scan_to_map_step_features`'s
    frame, all in one program (one CUDA-graph launch on the card).
    ``reg_params=None`` uses :func:`default_map_reg_params`."""
    return _step(state, scan, (lidar, feat_params, dewarp), reg_params, config)


def scan_to_map_step_features(
    state: ScanToMapState,
    feats: FeatureSet,
    reg_params: Optional[RegistrationParams] = None,
    config: ScanToMapConfig = ScanToMapConfig(),
) -> Tuple[ScanToMapState, Pose3, RegistrationDetail]:
    """:func:`scan_to_map_step` from extracted, Morton-sorted features."""
    return _step(state, feats, None, reg_params, config)


def _step(state, frame, extract, reg_params, config):
    """One frame through its program: the state copied in, clones out."""
    state = _with_dropped(state)
    prog, fn = _frame_program(state, frame, extract, reg_params, config)
    out = prog.run(fn, (state, frame))
    pose, det = prog.own(out)
    return program.clone(prog.buffers[0]), pose, det


def _with_dropped(state: ScanToMapState) -> ScanToMapState:
    """``state`` with ``dropped`` an int32 tensor on the maps' device (a
    fresh state carries the int 0): the frame adds to it in place."""
    d = state.dropped
    if isinstance(d, torch.Tensor) and d.dtype == torch.int32:
        return state
    return state._replace(dropped=torch.full((), int(d), dtype=torch.int32,
                                             device=state.edge_map.points.device))


def _frame_program(state, frame, extract, reg_params, config):
    """The program of one frame (``loop.driver_program``) and its function
    over ``(state, frame)`` buffers. ``extract``: None when ``frame`` is
    features, else ``(lidar, feat_params, dewarp)`` and ``frame`` a scan."""
    if reg_params is None:
        reg_params = default_map_reg_params()

    def fn(bufs):
        st, fr = bufs
        if extract is not None:
            lidar, feat_params, dewarp = extract
            if dewarp:
                fr = dewarp_scan(fr, st.prev_delta, lidar)
            fr = spatial_sort_features(extract_features(fr, lidar, feat_params))
        return _frame(st, fr, reg_params, config)

    prog = driver_program(state.edge_map.points.device, ("scan_to_map", extract, config),
                          (state, frame), reg_params, path="scan_to_map",
                          frame="scan" if extract else "features")
    return prog, fn


def _frame(state: ScanToMapState, feats: FeatureSet, reg_params: RegistrationParams,
           config: ScanToMapConfig, register=None, insert_maps=None) -> Tuple[Pose3, RegistrationDetail]:
    """One frame against the maps, ``state``'s tensors updated in place
    (``loam_tpu``'s ``scan_to_map_step`` body): the constant-velocity init,
    the registration, the first-frame and keyframe logic, the insert of both
    maps and the prep cache's rebuild under ``program.when(insert)`` (a
    host branch eagerly, an IF node in a capture: ``lax.cond`` at
    ``loam_tpu/odometry/scan_to_map.py:374``), and the carry. Every read of
    the old state comes before the write that replaces it. Returns the
    frame's world pose and detail.

    ``register(state, feats, init, reg_params)`` -> (pose, detail) and
    ``insert_maps(state, feats, world_T_new, config)`` stand in for
    :func:`_register_maps` and :func:`_insert_maps`: the sharded step's
    (``parallel.distributed``)."""
    init = state.world_T_current.compose(state.prev_delta)  # constant velocity
    world_T_new, detail = (register or _register_maps)(state, feats, init, reg_params)
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

    program.when(insert, lambda: (insert_maps or _insert_maps)(state, feats, world_T_new, config))

    prev_delta = state.world_T_current.inverse().compose(world_T_new).normalize()
    carry = (world_T_new.normalize(), prev_delta,
             Pose3(torch.where(insert, world_T_new.rotation, state.world_T_keyframe.rotation),
                   torch.where(insert, world_T_new.translation, state.world_T_keyframe.translation)),
             torch.where(insert, 0, torch.clamp(state.frames_since_insert, min=0) + 1).to(torch.int32))
    program.copy_into((state.world_T_current, state.prev_delta, state.world_T_keyframe,
                       state.frames_since_insert), carry)
    return world_T_new, detail


def _register_maps(state: ScanToMapState, feats: FeatureSet, init: Pose3,
                   reg_params: RegistrationParams) -> Tuple[Pose3, RegistrationDetail]:
    """:func:`_frame`'s registration against the maps: from the prep cache
    where it is carried, else with the maps prepared inside. The search
    runs in the maps' dtype: a float64 frame searches float32 maps and fits
    their neighbours in float32, as ``loam_tpu``'s does, its pose and solve
    in float64."""
    target = _map_feature_set(state.edge_map, state.planar_map)
    cache = state.knn_prep_cache
    if (len(cache) == 16 and reg_params.search_backend == "bruteforce"
            and reg_params.max_edge_neighbor_dist > 0 and reg_params.max_plane_neighbor_dist > 0
            and _use_prep_cache(state.edge_map.points)):
        return _register_cached(feats, target, init, reg_params, cache)
    # the maps' storage is spatially compact: no reordering (loam_tpu
    # scan_to_map.py:270)
    return register_features(feats, target, init, reg_params, with_matches=False,
                             reorder_mode="none")


def _insert_maps(state: ScanToMapState, feats: FeatureSet, world_T_new: Pose3,
                 config: ScanToMapConfig) -> None:
    """:func:`_frame`'s keyframe insert (the body of its ``program.when``):
    both maps, ``dropped`` and the prep cache updated in place."""
    center = world_T_new.translation
    em, de = voxel_map_insert(state.edge_map, world_T_new.act(feats.edge_points),
                              feats.edge_mask, center, config.keep_radius)
    pm, dp = voxel_map_insert(state.planar_map, world_T_new.act(feats.planar_points),
                              feats.planar_mask, center, config.keep_radius)
    state.dropped.add_(de + dp)
    # the prep cache mirrors the maps: rebuilt here only, in its own shape
    cache = state.knn_prep_cache
    if cache:
        qe, qp = (feats.edge_mask.shape[0], feats.planar_mask.shape[0]) if len(cache) == 16 \
            else (None, None)
        program.copy_into(cache, _build_prep_cache(em, pm, qe, qp))
    program.copy_into((state.edge_map[:2], state.planar_map[:2]), (em[:2], pm[:2]))


def _register_cached(feats: FeatureSet, target: FeatureSet, init: Pose3,
                     reg_params: RegistrationParams, cache: tuple):
    """The registration against the maps from the prep cache
    (``loam_tpu`` ``scan_to_map.py:271-324``): the single kNN kernel on the
    cached preps, with the query masks and the loop's seed bounds. The
    kernel computes the bounds in its prologue, reading the rank window
    straight from the cached planes, so the cached windows (entries 6-13)
    are not read here: they are ``loam_tpu``'s state, and the seed windows
    a 3-element ``custom_knn`` takes. Returns (pose, detail), unbatched."""
    tT_e, rot_e, rbox_e, tT_p, rot_p, rbox_p = cache[:6]
    live_e, live_p = cache[-2:]
    preps = (TargetPrep(tT_e, True, live_e, rot_e, rbox_e, default_tt(tT_e.shape[-1])),
             TargetPrep(tT_p, True, live_p, rot_p, rbox_p, default_tt(tT_p.shape[-1])))
    add = lambda x: x[None]
    est, det = _register_impl(feats.map(add), target.map(add),
                              Pose3(add(init.rotation), add(init.translation)), reg_params, False,
                              target_preps=preps, reorder_mode="none")
    return Pose3(est.rotation[0], est.translation[0]), tree_map(lambda x: x[0], det)


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

    The call is one program (one CUDA-graph launch on the card, no host read
    until the return), as ``loam_tpu``'s is one ``jax.jit``: the state
    (:func:`scan_to_map_init`'s, unless ``init_state`` is given), then the
    frames in order as a ``program.scan`` whose carry is the state (one
    WHILE node on the card, each frame registering against the maps built
    so far, the keyframe insert an IF node inside it). With
    ``hoist_extraction`` and no ``dewarp`` the features of all frames are
    extracted before the scan, a block of frames at a time
    (``features.extract.extract_in_blocks``); dewarping needs each frame's
    motion, so it extracts frame by frame, inside the scan.

    Returns: (final state, trajectory Pose3 with (F, ...) leaves, per-frame
    RegistrationDetail stacked on a leading axis).
    """
    scans = place(scans, device)
    validate_scan(scans, lidar)
    if init_state is not None:
        init_state = _with_dropped(init_state)
    if reg_params is None:
        reg_params = default_map_reg_params()
    extract = (lidar, feat_params, dewarp or not hoist_extraction, dewarp)

    def fn(bufs):
        sc, st = bufs
        made = st is None
        if made:
            st = _with_dropped(scan_to_map_init(config, lidar=lidar, feat_params=feat_params,
                                                device=sc.device))
        traj, det = _trajectory(st, sc, extract, reg_params, config)
        return (st if made else None), traj, det

    prog = driver_program(scans.device, ("scan_to_map_offline", extract, config),
                          (scans, init_state), reg_params, path="scan_to_map_offline",
                          frames=scans.shape[0])
    with torch.profiler.record_function(program.DRIVER_RANGE):
        out = prog.run(fn, (scans, init_state))
    state, traj, det = prog.own(out)
    # a state handed over is carried in the program's buffers
    return (state if init_state is None else program.clone(prog.buffers[1])), traj, det


def _trajectory(state: ScanToMapState, scans, extract, reg_params, config):
    """The frames of ``scans`` against ``state``, updated in place, as one
    ``program.scan``: (trajectory, details) stacked. ``extract``: ``(lidar,
    feat_params, per_frame, dewarp)``."""
    lidar, feat_params, per_frame, dewarp = extract
    if not per_frame:
        feats = extract_in_blocks(scans, lidar, feat_params, post=spatial_sort_features)

    def frame(i):
        one = lambda x: x.index_select(0, i.view(1))[0]
        if per_frame:
            scan = one(scans)
            if dewarp:
                scan = dewarp_scan(scan, state.prev_delta, lidar)
            fr = spatial_sort_features(extract_features(scan, lidar, feat_params))
        else:
            fr = feats.map(one)
        return _frame(state, fr, reg_params, config)

    return program.scan(scans.shape[0], frame, scans.device)
