"""Sharded-target registration, the sharded voxel map and scan-to-map.

Counterpart of ``loam_tpu.parallel.distributed`` (BASELINE config 5: the map
is split over the mesh's shards):

  * **Sharded kNN**: the target is split over the shards; the queries are
    replicated. Every shard searches its slice, all of a rank's shards in one
    batched search (the kNN kernel on the card), and its lists come back
    with global indices and the neighbours' coordinates, so no shard ever
    reads another's targets. The (d2, index) lists are gathered and merged
    on every rank, in global shard order, which is global index order, by
    ``topk_min``'s first-index rule: exactly the single-device search.
  * **Sharded registration**: ``_register_impl`` -- the whole single-device
    loop and its ``RegistrationDetail`` -- on a path of its own,
    ``"sharded"``, whose kNN is the sharded search. Association, fits and
    solve run replicated on the same bits on every rank, so every rank's
    loop ends at the same iteration. The path is captured like the
    single-device ones: one program a registration (inline in a
    scan-to-map frame), the search's gathers inside the loop's WHILE node on
    the card at every world size; its key holds the mesh's token. A
    caller's own ``custom_knn`` still runs eagerly, since it may read the
    host.
  * **Sharded voxel map**: a voxel's owner is its Morton key mod the shard
    count, so each voxel has one owner, insertion and dedup stay local, and
    the shards together hold the single-device map's voxels.

Layout: a sharded target or map leaf leads with this rank's shards, ``(L,
C, ...)`` (or flat ``(L*C, ...)`` where a target is passed), ``loam_tpu``'s
``(D, C, ...)`` when one rank holds every shard. Global index of slot ``c``
of shard ``g``: ``g * C + c``. These functions shard the mesh's ``axis``
and need its other axis to be 1.

:func:`scan_to_map_step_sharded` is one program a frame, as the
single-device step's: extraction, the azimuth sort (``loam_tpu``'s sharded
step's, ``distributed.py:301``), the registration inline, the first-frame
and keyframe logic, the insert of both maps under ``program.when(insert)``
(``lax.cond``, ``loam_tpu``'s ``distributed.py:352``), an IF node on the
card whose body holds the inserts' fixed-order sum of ``dropped``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import program
from ..features import FeatureSet, extract_features
from ..geometry import Pose3
from ..map import VoxelMap, voxel_map_empty, voxel_map_insert
from ..map.voxel_map import _voxel_key
from ..neighbors.bruteforce import KnnResult, topk_min
from ..odometry.scan_to_map import (ScanToMapConfig, ScanToMapState, _frame, _map_feature_set,
                                    _with_dropped)
from ..ops.knn_cuda import TargetPrep, _init_d2, knn_prep, knn_slots, pack_slots
from ..params import FeatureExtractionParams, LidarParams, RegistrationParams
from ..registration.detail import RegistrationDetail, tree_map
from ..registration.icf import _register_impl, azimuth_sort_features
from . import collectives
from .sharding import Mesh, require_live, run_program


class _ShardTargets(NamedTuple):
    """This rank's shards of a target, prepared for the search."""

    prep: TargetPrep  # (L, 3, S) planes, one batch entry a shard
    offset: torch.Tensor  # (L, 1, 1) int32 global index of each shard's slot 0


def _shard_targets(t_points, t_mask, mesh: Mesh, axis: str) -> _ShardTargets:
    _, mine = mesh.shards_along(axis)
    L = len(mine)
    tp = t_points.to(mesh.device).reshape(L, -1, 3)
    S = tp.shape[1]
    # a rank's shards are consecutive: the offsets made on the device, no
    # copy from the host (which a capture refuses)
    offset = torch.arange(mine[0] * S, (mine[0] + L) * S, S, dtype=torch.int32,
                          device=mesh.device).reshape(L, 1, 1)
    return _ShardTargets(knn_prep(tp, t_mask.to(mesh.device).reshape(L, S)), offset)


def _shard_search(st: _ShardTargets, queries, k: int, max_dist: float, mesh: Mesh, query_mask=None):
    """Replicated queries (Q, 3) against every shard: the merged slots
    ``(idx, d2, (xs, ys, zs))``, each (k, Q), as ``knn_slots`` gives them
    for the whole target."""
    L = st.offset.shape[0]
    q = queries.to(mesh.device).expand(L, -1, -1)
    qm = None if query_mask is None else query_mask.to(mesh.device).expand(L, -1)
    idx, d2, coords = knn_slots(st.prep, q, k, max_dist, qm)
    # the lists of every shard, global shard order: (D, k, Q), one gather
    g_idx, g_val = collectives.gather(mesh, (idx + st.offset, torch.stack([d2, *coords], dim=1)))
    D, Q = g_idx.shape[0], g_idx.shape[-1]
    init = _init_d2(max_dist)
    # per query, shard-major then slot: global index order, so the first of
    # equal distances is the lowest index; unfilled slots never win
    per_query = lambda x: x.permute(2, 0, 1).reshape(Q, D * k)
    cand = g_val[:, 0]
    best, pos = topk_min(per_query(torch.where(cand < init, cand, torch.inf)), k)
    real = torch.isfinite(best)
    pos = pos.long()
    slots = lambda x, fill: torch.where(real, x, fill).T.contiguous()  # (Q, k) -> (k, Q)
    pick = lambda x, fill: slots(torch.gather(per_query(x), 1, pos), fill)
    return (pick(g_idx, 0), slots(best, init),
            tuple(pick(g_val[:, 1 + a], 0.0) for a in range(3)))


def sharded_knn(
    queries: torch.Tensor,
    t_points: torch.Tensor,
    t_mask: torch.Tensor,
    k: int,
    max_dist: float,
    mesh: Mesh,
    axis: str = "data",
) -> Tuple[KnnResult, torch.Tensor]:
    """kNN against a target sharded over ``axis``.

    ``queries`` (Q, 3) are replicated; ``t_points`` / ``t_mask`` are this
    rank's shards of the target, (L*S, 3) / (L*S,) (the whole (M, 3) target
    when one rank holds every shard). Exact: every true neighbour is in its
    shard's top k.

    Returns (KnnResult with GLOBAL indices and (Q, k) leaves, neighbour
    coordinates (Q, k, 3)).
    """
    idx, d2, coords = _shard_search(_shard_targets(t_points, t_mask, mesh, axis), queries, k,
                                    max_dist, mesh)
    res = pack_slots(idx[None], d2[None], [c[None] for c in coords], max_dist, with_coords=False)
    return KnnResult(*(x[0] for x in res)), torch.stack(coords, dim=-1).transpose(0, 1)


class ShardedSearch(NamedTuple):
    """The sharded registration's search (``_register_impl(sharded=)``):
    the target's leaves are this rank's shards of ``mesh``'s ``axis``."""

    mesh: Mesh
    axis: str

    @property
    def key(self) -> tuple:
        """What a registration program's key holds of it."""
        return self.mesh.token, self.axis

    def hooks(self, source: FeatureSet, target: FeatureSet, params: RegistrationParams):
        """The loop's edge and planar searches, each mapping the moved
        (1, Q, 3) queries to a ``PackedKnn``, against ``target``'s shards
        ((1, L*C, ...) leaves), prepared here once a registration; the
        queries masked by ``source``'s masks."""

        def hook(points, mask, k, r, query_mask):
            st = _shard_targets(points[0], mask[0], self.mesh, self.axis)

            def search(q):
                idx, d2, coords = _shard_search(st, q[0], k, r, self.mesh, query_mask[0])
                return pack_slots(idx[None], d2[None], [c[None] for c in coords], r, with_coords=True)

            return search

        return (hook(target.edge_points, target.edge_mask, params.num_edge_neighbors,
                     params.max_edge_neighbor_dist, source.edge_mask),
                hook(target.planar_points, target.planar_mask, params.num_plane_neighbors,
                     params.max_plane_neighbor_dist, source.planar_mask))


def register_features_sharded(
    source: FeatureSet,
    target: FeatureSet,
    target_T_source_init: Pose3,
    mesh: Mesh,
    params: RegistrationParams = RegistrationParams(),
    axis: str = "data",
    with_matches: bool = False,
) -> Tuple[Pose3, RegistrationDetail]:
    """ICF registration of one pair against a target whose features are
    sharded over ``axis``: ``target``'s leaves are this rank's shards
    ((L*C, ...), capacities multiples of the shard count), ``source`` and
    the init are replicated. Runs the whole single-device loop
    (``_register_impl``) on its sharded path, one program a call, so it
    returns what ``register_features`` returns: (pose, full
    RegistrationDetail), with match indices global."""
    require_live(mesh)
    dev = mesh.device
    add = lambda x: x.to(dev)[None]
    est, det = _register_impl(
        source.map(add), target.map(add),
        Pose3(add(target_T_source_init.rotation), add(target_T_source_init.translation)),
        params, with_matches, sharded=ShardedSearch(mesh, axis))
    return Pose3(est.rotation[0], est.translation[0]), tree_map(lambda x: x[0], det)


def sharded_map_insert(
    maps: VoxelMap,
    new_points: torch.Tensor,
    new_mask: torch.Tensor,
    mesh: Mesh,
    center: Optional[torch.Tensor] = None,
    keep_radius: float = 0.0,
    axis: str = "data",
) -> Tuple[VoxelMap, torch.Tensor]:
    """Insert replicated points into a sharded voxel map.

    ``maps`` leaves lead with this rank's shards, (L, C, ...). Shard ``g``
    inserts the points whose voxel key mod D is ``g``, with its own eviction
    around ``center``. Returns the updated map and the dropped-voxel count
    summed over every shard.

    A rank's shards insert side by side (``program.branches``: on the card
    a stream each, at once, inside the keyframe's IF node too), each with
    the launches and shapes of a rank that holds that shard alone; the sum
    of the dropped counts runs after them, so its order of adds is the
    global shard order whatever ran beside what.
    """
    D, mine = mesh.shards_along(axis)
    dev = mesh.device
    pts, mask = new_points.to(dev), new_mask.to(dev)
    ctr = None if center is None else center.to(dev)

    def insert(s, g):
        local = VoxelMap(maps.points[s], maps.mask[s], maps.voxel_size, maps.origin)
        own = (_voxel_key(local, pts, mask) % D) == g
        return voxel_map_insert(local, pts, mask & own, ctr, keep_radius)

    out, dropped = zip(*program.branches([lambda s=s, g=g: insert(s, g) for s, g in enumerate(mine)], dev))
    return (VoxelMap(torch.stack([m.points for m in out]), torch.stack([m.mask for m in out]),
                     maps.voxel_size, maps.origin),
            collectives.sum(mesh, torch.stack(dropped)))


def sharded_map_empty(
    capacity_per_device: int,
    voxel_size: float,
    mesh: Mesh,
    origin=(0.0, 0.0, 0.0),
    dtype=torch.float32,
    axis: str = "data",
) -> VoxelMap:
    """An empty sharded map: (L, C, ...) leaves of this rank's shards, on the
    mesh's device."""
    _, mine = mesh.shards_along(axis)
    base = voxel_map_empty(capacity_per_device, voxel_size, origin, dtype, mesh.device)
    L = len(mine)
    return VoxelMap(base.points.expand((L,) + base.points.shape).clone(),
                    base.mask.expand((L,) + base.mask.shape).clone(), base.voxel_size, base.origin)


def scan_to_map_init_sharded(
    config: ScanToMapConfig,
    mesh: Mesh,
    origin=(0.0, 0.0, 0.0),
    dtype=torch.float32,
    axis: str = "data",
) -> ScanToMapState:
    """Scan-to-map state whose voxel maps are sharded over ``axis``: each
    shard owns ``capacity / D`` slots of each map (the capacities must be
    multiples of the shard count)."""
    D, _ = mesh.shards_along(axis)
    if config.edge_capacity % D or config.planar_capacity % D:
        raise ValueError(f"map capacities {config.edge_capacity} / {config.planar_capacity} must "
                         f"split evenly over the {D} shards of mesh axis {axis!r}")
    dev = mesh.device
    return ScanToMapState(
        edge_map=sharded_map_empty(config.edge_capacity // D, config.edge_voxel_size, mesh,
                                   origin, dtype, axis),
        planar_map=sharded_map_empty(config.planar_capacity // D, config.planar_voxel_size, mesh,
                                     origin, dtype, axis),
        world_T_current=Pose3.identity(dtype, device=dev),
        prev_delta=Pose3.identity(dtype, device=dev),
        world_T_keyframe=Pose3.identity(dtype, device=dev),
        frames_since_insert=torch.full((), -1, dtype=torch.int32, device=dev),
    )


def scan_to_map_step_sharded(
    state: ScanToMapState,
    scan: torch.Tensor,
    lidar: LidarParams,
    mesh: Mesh,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: RegistrationParams = RegistrationParams(prior_weight=300.0),
    config: ScanToMapConfig = ScanToMapConfig(),
    axis: str = "data",
):
    """One scan-to-map step against sharded voxel maps: ``loam_tpu``'s
    ``scan_to_map_step_sharded``.

    The flow of the single-device ``scan_to_map_step`` (constant-velocity
    init, first-frame hold, keyframe-gated insert; its ``_frame``):
    extraction, the azimuth sort, :func:`register_features_sharded` against
    the maps (no reordering, ``loam_tpu``'s ``reorder_mode="none"``), and
    :func:`sharded_map_insert` on a keyframe, one program a call (the module
    docstring) that copies the state in and returns clones. Every rank
    passes the same scan. Returns (state, world pose, full
    RegistrationDetail).

    The source is sorted by azimuth, as ``loam_tpu``'s sharded step sorts
    it, where both packages' single-device steps sort it by Morton key. The
    order of the source changes the order of the ICF's sums, so the sharded
    step follows ``loam_tpu``'s sharded step and not the single-device one:
    the two land within the ICF's convergence thresholds of each other (a
    few mm at 32x512). Fed the same azimuth-sorted features
    (``scan_to_map_step_features``), the single-device step finds the same
    neighbours, except that equidistant map points come in shard order, not
    map order.
    """
    state = _with_dropped(state)

    def register(st, feats, init, params):
        em, pm = st.edge_map, st.planar_map
        target = _map_feature_set(
            VoxelMap(em.points.reshape(-1, 3), em.mask.reshape(-1), em.voxel_size, em.origin),
            VoxelMap(pm.points.reshape(-1, 3), pm.mask.reshape(-1), pm.voxel_size, pm.origin))
        return register_features_sharded(feats, target, init, mesh, params, axis)

    def insert(st, feats, world_T_new, cfg):
        # under program.when: every rank holds the same flag, so every rank
        # inserts, or none, and the sum's gather runs on all or on none
        center = world_T_new.translation
        em, de = sharded_map_insert(st.edge_map, world_T_new.act(feats.edge_points), feats.edge_mask,
                                    mesh, center, cfg.keep_radius, axis)
        pm, dp = sharded_map_insert(st.planar_map, world_T_new.act(feats.planar_points),
                                    feats.planar_mask, mesh, center, cfg.keep_radius, axis)
        st.dropped.add_(de + dp)
        program.copy_into((st.edge_map[:2], st.planar_map[:2]), (em[:2], pm[:2]))

    def fn(bufs):
        st, sc = bufs
        feats = azimuth_sort_features(extract_features(sc, lidar, feat_params))
        return _frame(st, feats, reg_params, config, register, insert)

    # the sharded search is the registration's whatever ``search_backend`` says
    prog, out = run_program(mesh, ("scan_to_map_sharded", axis, lidar, feat_params, reg_params, config),
                            (state, scan.to(mesh.device)), fn, None, path="scan_to_map_sharded")
    pose, det = prog.own(out)
    return program.clone(prog.buffers[0]), pose, det
