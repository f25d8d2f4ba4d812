"""Entry: ``loam_tpu_torch.odometry_offline`` -- one call is a segment's
whole scan-to-scan trajectory, one CUDA-graph launch on the card."""

from __future__ import annotations

import torch

from loambench import judge
from loambench.reference import pipelines


class Entry:
    """The program's side of a cell on one device; ``mesh`` is unused (the
    path runs on one card)."""

    def __init__(self, config: dict, device, mesh=None):
        import loam_tpu_torch as T

        self.T, self.config = T, config
        self.lidar = T.LidarParams(**config["lidar"])
        self.fp = T.FeatureExtractionParams(**config["features"])
        self.rp = T.RegistrationParams(**config["registration"])

    def call(self, scans):
        c = self.config
        return self.T.odometry_offline(scans, self.lidar, self.fp, self.rp, c["chunk_pairs"], c["motion_init"])

    def keep(self, out, full: bool) -> dict:
        """What a call's check reads, held as the program returned it (no
        work and no host read inside the window)."""
        traj, det = out
        info = det.iteration_info
        return {"q": traj.rotation, "t": traj.translation, "iterations": det.num_iterations,
                "termination": det.termination,
                "edge_count": info.edge_count, "plane_count": info.plane_count,
                "overflow": (info.edge_knn_overflow, info.plane_knn_overflow)}

    def settle(self, kept: dict) -> dict:
        """``kept`` with each pair's first-iteration fits and the searches'
        overflow worked out (after the window)."""
        out = dict(kept, fits=kept["edge_count"][:, 0] + kept["plane_count"][:, 0])
        out["overflow"] = sum(int(x.sum()) for x in kept["overflow"] if x is not None)
        return out


def reference(config: dict, scans, dtype=torch.float64) -> dict:
    """The plain reference of a segment (nothing of the program)."""
    c = config
    return pipelines.offline(scans, c["lidar"], c["features"], c["registration"], c["chunk_pairs"],
                             c["motion_init"], dtype)


def compare(config: dict, kept: dict, ref: dict, shard=None) -> dict:
    """Each pair's relative pose and first fits against the reference's."""
    rq, rt = pipelines.relative((kept["q"], kept["t"]))
    out = judge.pose_gaps(rq, rt, *ref["rel"])
    out["fits_gap"] = judge.fits_gap(kept["fits"], ref["first_fits"])
    return out
