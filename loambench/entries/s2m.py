"""Entry: ``loam_tpu_torch.scan_to_map_offline`` -- one call is a segment's
whole scan-to-map trajectory from empty maps, one CUDA-graph launch on the
card (the frames a WHILE node, a keyframe's insert and prep-cache rebuild
an IF node inside it)."""

from __future__ import annotations

import torch

from loambench import judge
from loambench.reference import maps, pipelines


class Entry:
    def __init__(self, config: dict, device, mesh=None):
        import loam_tpu_torch as T

        self.T, self.config = T, config
        self.lidar = T.LidarParams(**config["lidar"])
        self.fp = T.FeatureExtractionParams(**config["features"])
        self.rp = T.RegistrationParams(**config["registration"])
        self.cfg = T.ScanToMapConfig(**config["scan_to_map"])

    def call(self, scans):
        return self.T.scan_to_map_offline(scans, self.lidar, self.fp, self.rp, self.cfg)

    def keep(self, out, full: bool) -> dict:
        """What a call's check reads, held as the program returned it: the
        trajectory, each frame's ICF counts, ``dropped`` and, with ``full``
        (a judged segment's first call), the final maps."""
        state, traj, det = out
        info = det.iteration_info
        return {"q": traj.rotation, "t": traj.translation, "iterations": det.num_iterations,
                "termination": det.termination,
                "edge_count": info.edge_count, "plane_count": info.plane_count,
                "overflow": (info.edge_knn_overflow, info.plane_knn_overflow), "dropped": state.dropped,
                "maps": ((state.edge_map.points, state.edge_map.mask),
                         (state.planar_map.points, state.planar_map.mask)) if full else None}

    def settle(self, kept: dict) -> dict:
        out = dict(kept, fits=kept["edge_count"][:, 0] + kept["plane_count"][:, 0])
        out["overflow"] = sum(int(x.sum()) for x in kept["overflow"] if x is not None)
        out["dropped"] = int(kept["dropped"])
        return out


def reference(config: dict, scans, dtype=torch.float64, source_order: str = "morton") -> dict:
    """The plain reference of a segment (nothing of the program)."""
    c = config
    return pipelines.scan_to_map(scans, c["lidar"], c["features"], c["registration"], c["scan_to_map"],
                                 source_order, dtype)


def compare(config: dict, kept: dict, ref: dict, shard=None) -> dict:
    """Each frame's world pose and first fits, and the final maps' voxels,
    against the reference's. ``shard``: (shards, this one) of a sharded
    map, whose voxels are compared with the reference's it owns (a voxel's
    owner is its Z-order key modulo the shards)."""
    out = judge.pose_gaps(kept["q"], kept["t"], *ref["trajectory"])
    out["fits_gap"] = judge.fits_gap(kept["fits"], ref["first_fits"])
    if kept["maps"] is None:
        return out
    c = config["scan_to_map"]
    gaps = []
    for (pts, m), name, vox in zip(kept["maps"], ("edge_map", "planar_map"),
                                   (c["edge_voxel_size"], c["planar_voxel_size"])):
        owned = None if shard is None else (lambda p, vox=vox: (maps.morton(p, vox) % shard[0]) == shard[1])
        gaps.append(judge.voxel_gap(pts.reshape(-1, 3), m.reshape(-1), *ref[name], vox, owned))
    out["map_voxel_gap"] = max(gaps)
    return out
