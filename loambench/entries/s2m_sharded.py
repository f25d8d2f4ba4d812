"""Entry: scan-to-map with both voxel maps sharded over the mesh's ranks --
one call is ``parallel.distributed.scan_to_map_init_sharded`` then one
``scan_to_map_step_sharded`` a frame of the segment (a CUDA-graph launch a
frame), every rank fed the same scans. The sharded search gathers every
rank's neighbours in each ICF iteration and an insert sums the dropped
counts: the mesh's collectives over NVLink."""

from __future__ import annotations

import torch

from loambench import cells

s2m = cells.load(cells.HERE / "entries" / "s2m.py", "loambench_entry_s2m")


class Entry:
    def __init__(self, config: dict, device, mesh):
        import loam_tpu_torch as T
        from loam_tpu_torch.parallel import distributed

        self.T, self.D, self.config, self.mesh = T, distributed, config, mesh
        self.lidar = T.LidarParams(**config["lidar"])
        self.fp = T.FeatureExtractionParams(**config["features"])
        self.rp = T.RegistrationParams(**config["registration"])
        self.cfg = T.ScanToMapConfig(**config["scan_to_map"])

    def call(self, scans):
        st = self.D.scan_to_map_init_sharded(self.cfg, self.mesh)
        poses, dets = [], []
        for f in range(scans.shape[0]):
            st, pose, det = self.D.scan_to_map_step_sharded(st, scans[f], self.lidar, self.mesh, self.fp,
                                                           self.rp, self.cfg)
            poses.append(pose)
            dets.append(det)
        return st, poses, dets

    def keep(self, out, full: bool) -> dict:
        """The frames' poses and ICF counts, ``dropped`` and, with ``full``,
        this rank's shard of the final maps, as the program returned them."""
        st, poses, dets = out
        return {"poses": poses, "iterations": [d.num_iterations for d in dets],
                "termination": [d.termination for d in dets],
                "counts": [(d.iteration_info.edge_count, d.iteration_info.plane_count) for d in dets],
                "dropped": st.dropped,
                "maps": ((st.edge_map.points, st.edge_map.mask),
                         (st.planar_map.points, st.planar_map.mask)) if full else None}

    def settle(self, kept: dict) -> dict:
        out = {"q": torch.stack([p.rotation for p in kept["poses"]]),
               "t": torch.stack([p.translation for p in kept["poses"]]),
               "iterations": torch.stack(kept["iterations"]), "termination": torch.stack(kept["termination"]),
               "fits": torch.stack([e[0] + p[0] for e, p in kept["counts"]]),
               "dropped": int(kept["dropped"]), "overflow": 0, "maps": kept["maps"]}
        return out

    @property
    def shard(self):
        """(shards, this rank's shard) of the sharded maps."""
        D, (g,) = self.mesh.shards_along("data")
        return D, g


def reference(config: dict, scans, dtype=torch.float64) -> dict:
    """The plain reference of a segment: scan-to-map with the sharded
    step's source order (by azimuth), which decides which new point keeps a
    voxel."""
    return s2m.reference(config, scans, dtype, "azimuth")


compare = s2m.compare
