"""Parameter structures for the PyTorch port.

Field names, defaults and checks are those of ``loam_tpu.params`` (which in
turn mirror the reference library's ``LidarParams``, ``common.h:29-41``;
``FeatureExtractionParams``, ``features.h:37-66``; ``RegistrationParams``,
``registration.h:40-75``), so a configuration moves between the two packages
unchanged: :func:`from_reference` converts a ``loam_tpu`` dataclass into the
port's.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LidarParams:
    """Intrinsic LiDAR parameters (reference: ``common.h:29-41``)."""

    #: Number of scan lines (e.g. Ouster OS1-64 has 64).
    scan_lines: int
    #: Number of points per scan line (e.g. 1024).
    points_per_line: int
    #: Minimum valid range of the sensor.
    min_range: float
    #: Maximum valid range of the sensor.
    max_range: float

    def __post_init__(self):
        if self.scan_lines <= 0 or self.points_per_line <= 0:
            raise ValueError(
                f"LidarParams requires positive scan_lines/points_per_line, got "
                f"{self.scan_lines} x {self.points_per_line}"
            )


@dataclasses.dataclass(frozen=True)
class FeatureExtractionParams:
    """Feature-extraction parameters (reference: ``features.h:37-66``)."""

    #: Number of neighbor points on either side used for curvature ([1] Eq. 1).
    neighbor_points: int = 3
    #: Number of sectors each scan line is split into for feature detection.
    number_sectors: int = 6
    #: Max edge features detected per sector. Like the reference
    #: (``features-inl.h:155``) up to ``max_edge_feats_per_sector + 1``
    #: features are admitted (the break fires only after the cap is exceeded).
    max_edge_feats_per_sector: int = 10
    #: Max planar features per sector (same off-by-one admission as above).
    max_planar_feats_per_sector: int = 50
    #: Unnormalized curvature must exceed this to be an edge feature.
    edge_feat_threshold: float = 100.0
    #: Unnormalized curvature must be below this to be a planar feature.
    planar_feat_threshold: float = 1.0
    #: Range jump between consecutive points flagged as occlusion boundary.
    occlusion_thresh: float = 0.5
    #: Range difference (as proportion of range) for beam-parallel surfaces.
    parallel_thresh: float = 1.0
    #: For float32 scans, compute curvature and validity in native float64
    #: on the upcast points, so feature SELECTION follows the reference's
    #: f64 decisions. The selected coordinates stay in the scan's dtype.
    #: float64 scans are unaffected.
    precise_selection: bool = True
    #: Accepted for configuration compatibility with ``loam_tpu``; ignored
    #: by the port (the sector sort is always the CUDA kernel on a CUDA
    #: tensor and its plain version on a CPU tensor).
    sector_sort: str = "auto"
    #: Accepted for configuration compatibility; ignored (see above).
    feature_assemble: str = "auto"
    #: Accepted for configuration compatibility; ignored (see above).
    greedy_nms: str = "auto"

    def __post_init__(self):
        if self.neighbor_points < 1:
            raise ValueError("neighbor_points must be >= 1")
        if self.number_sectors < 1:
            raise ValueError("number_sectors must be >= 1")
        for field, allowed in (
            ("sector_sort", ("auto", "xla", "bitonic")),
            ("feature_assemble", ("auto", "gather", "pallas")),
            ("greedy_nms", ("auto", "xla", "pallas")),
        ):
            if getattr(self, field) not in allowed:
                raise ValueError(f"{field} must be one of {allowed}")

    # ---- derived static shapes -------------------------------------------
    def points_per_sector(self, lidar: LidarParams) -> int:
        return lidar.points_per_line // self.number_sectors

    def max_sector_size(self, lidar: LidarParams) -> int:
        """Size of the largest sector (the last sector absorbs the remainder,
        reference ``features-inl.h:32-35``)."""
        pps = self.points_per_sector(lidar)
        return lidar.points_per_line - (self.number_sectors - 1) * pps

    def edge_capacity(self, lidar: LidarParams) -> int:
        """Fixed per-scan edge feature capacity (honors the reference's +1
        admission quirk, ``features-inl.h:155``)."""
        return lidar.scan_lines * self.number_sectors * (self.max_edge_feats_per_sector + 1)

    def planar_capacity(self, lidar: LidarParams) -> int:
        return lidar.scan_lines * self.number_sectors * (self.max_planar_feats_per_sector + 1)


@dataclasses.dataclass(frozen=True)
class RegistrationParams:
    """Registration (ICF) parameters (reference: ``registration.h:40-75``)."""

    #: k for the edge-point neighbor search in the target.
    num_edge_neighbors: int = 5
    #: Radius filter on edge neighbors (<= 0 disables).
    max_edge_neighbor_dist: float = 1.0
    #: Minimum neighbors required to fit a line.
    min_line_fit_points: int = 3
    #: Minimum line condition number. Dead code in the reference
    #: (``geometry.cpp:55-56`` never assigns the ratio), so the guard never
    #: rejects unless ``enforce_line_condition`` is set.
    min_line_condition_number: float = 10.0

    #: k for the planar-point neighbor search in the target.
    num_plane_neighbors: int = 5
    #: Radius filter on plane neighbors (<= 0 disables).
    max_plane_neighbor_dist: float = 2.0
    #: Minimum neighbors required to fit a plane.
    min_plane_fit_points: int = 4
    #: Maximum average (signed) point-to-plane distance for a valid plane
    #: fit. Structurally inert: the PCA plane fit's signed mean residual is
    #: exactly 0 by construction (``geometry.fit_plane``).
    max_avg_point_plane_dist: float = 0.1

    #: Maximum outer ICF iterations.
    max_iterations: int = 10
    #: Convergence threshold on the rotation update magnitude (radians).
    rotation_convergence_thresh: float = 1e-3
    #: Convergence threshold on the translation update magnitude.
    position_convergence_thresh: float = 1e-2
    #: Minimum total associations required to attempt a solve.
    min_associations: int = 100

    #: Inner Levenberg-Marquardt iterations per outer ICF iteration (the
    #: reference hard-codes Ceres ``max_num_iterations = 4``).
    inner_iterations: int = 4
    #: Huber loss delta (reference ``HuberLoss(1.0)``).
    huber_delta: float = 1.0
    #: If True, enforce the line condition-number guard the reference
    #: intended but dead-coded (see ``min_line_condition_number``).
    enforce_line_condition: bool = False
    #: Quadratic prior pulling the accumulated update toward the ICF
    #: initialization. 0 disables (reference behavior).
    prior_weight: float = 0.0
    #: Accepted for configuration compatibility with ``loam_tpu``; ignored
    #: by the port (the LM solve has one implementation).
    lm_impl: str = "auto"
    #: Neighbor-search backend. The port implements "bruteforce" (the exact
    #: kNN kernel); "grid" is accepted for configuration compatibility and
    #: rejected by :func:`register_features` until the voxel-hash search is
    #: ported.
    search_backend: str = "bruteforce"
    #: Per-voxel candidate cap for the "grid" backend.
    grid_max_per_cell: int = 64

    def __post_init__(self):
        for field, allowed in (
            ("lm_impl", ("auto", "xla")),
            ("search_backend", ("bruteforce", "grid")),
        ):
            if getattr(self, field) not in allowed:
                raise ValueError(f"{field} must be one of {allowed}")


@dataclasses.dataclass(frozen=True)
class TerminationType:
    """Registration termination codes (reference ``registration.h:83``)."""

    CONVERGED = 0
    MAX_ITER = 1
    INSUFFICIENT_ASSOCIATIONS = 2


_BY_NAME = {
    "LidarParams": LidarParams,
    "FeatureExtractionParams": FeatureExtractionParams,
    "RegistrationParams": RegistrationParams,
}


def from_reference(p):
    """Build the port's dataclass from a ``loam_tpu`` parameter dataclass
    (matched by class name; fields copied via ``dataclasses.asdict``)."""
    cls = _BY_NAME.get(type(p).__name__)
    if cls is None or not dataclasses.is_dataclass(p):
        raise TypeError(f"no port counterpart for {type(p)!r}")
    return cls(**dataclasses.asdict(p))
