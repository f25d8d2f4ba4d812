"""Drop-in compatibility layer mirroring the reference's Python module.

Counterpart of ``loam_tpu.compat``: the reference ships a pybind11 module
``loam`` (``python/loam_bindings.cpp``) whose API this module reproduces name
for name -- ``LidarParams``, ``Pose3d``, ``Quaterniond``,
``FeatureExtractionParams``, ``LoamFeatures``, ``extractFeatures`` /
``computeCurvature`` / ``computeValidPoints``, ``RegistrationParams``,
``registerFeatures``, ``RegistrationDetail`` / ``RegistrationIterationInfo``
/ ``RegistrationTerminationType`` -- on top of the PyTorch port. A reference
user can switch with::

    import loam_tpu_torch.compat as loam   # or: import loam_torch (repo-root shim)

Semantics notes:
  * Feature lists come back as dense (N, 3) float64 NumPy arrays in the
    reference's output order (line, sector, curvature rank).
  * ``registerFeatures`` fills a passed ``RegistrationDetail`` exactly like
    the reference's shared-ptr out-param (``loam_bindings.cpp:141-144``).
  * The four functions take a trailing ``device=None`` keyword with the
    port's device rule (``device.py``): the NumPy input goes to the card
    unless ``device`` names another. ``Pose3d``'s own arithmetic is host
    convenience and runs on the CPU in float64.
  * This layer converts to and from NumPy around the port's tensor code.
    Pipelines that want device-resident throughput should use the
    ``loam_tpu_torch`` API (FeatureSet etc.) directly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import geometry as _geom
from . import params as _params
from .device import place as _place
from .features import extract_features as _extract
from .features.curvature import compute_curvature as _curv
from .features.curvature import compute_valid_points as _validpts
from .features.types import feature_set_from_points as _fs_from_points
from .registration import register_features as _register


class Quaterniond:
    """Mirrors the bound ``Eigen::Quaterniond`` (``loam_bindings.cpp:51-57``):
    constructed from (w, x, y, z), accessors are methods."""

    def __init__(self, w: float = 1.0, x: float = 0.0, y: float = 0.0, z: float = 0.0):
        self._wxyz = np.array([w, x, y, z], dtype=np.float64)

    def w(self) -> float:
        return float(self._wxyz[0])

    def x(self) -> float:
        return float(self._wxyz[1])

    def y(self) -> float:
        return float(self._wxyz[2])

    def z(self) -> float:
        return float(self._wxyz[3])

    @staticmethod
    def _from_wxyz(arr) -> "Quaterniond":
        q = Quaterniond()
        q._wxyz = np.asarray(arr, dtype=np.float64).copy()
        return q

    def __repr__(self):
        w, x, y, z = self._wxyz
        return f"Quaterniond(w={w}, x={x}, y={y}, z={z})"


class Pose3d:
    """Mirrors reference ``Pose3d`` (``geometry.h:27-50``, bindings
    ``loam_bindings.cpp:41-49``)."""

    def __init__(
        self,
        rotation: Optional[Quaterniond] = None,
        translation=None,
    ):
        self.rotation = rotation if rotation is not None else Quaterniond()
        self.translation = (
            np.zeros(3) if translation is None else np.asarray(translation, np.float64)
        )

    @staticmethod
    def Identity() -> "Pose3d":
        return Pose3d()

    def _pose3(self, device="cpu") -> _geom.Pose3:
        return _geom.Pose3(
            _place(self.rotation._wxyz, device, torch.float64),
            _place(self.translation, device, torch.float64),
        )

    @staticmethod
    def _from_pose3(p: _geom.Pose3) -> "Pose3d":
        return Pose3d(
            Quaterniond._from_wxyz(p.rotation.cpu().numpy()),
            p.translation.cpu().numpy().astype(np.float64),
        )

    def inverse(self) -> "Pose3d":
        return Pose3d._from_pose3(self._pose3().inverse())

    def compose(self, other: "Pose3d") -> "Pose3d":
        return Pose3d._from_pose3(self._pose3().compose(other._pose3()))

    def act(self, point) -> np.ndarray:
        return self._pose3().act(_place(point, "cpu", torch.float64)).numpy()

    def matrix(self) -> np.ndarray:
        """4x4 homogeneous matrix. NOTE: the reference's Python bindings
        forget to expose ``matrix`` (``loam_bindings.cpp:41-49``, SURVEY
        §2.3(11)); provided here because its absence is an oversight."""
        return self._pose3().matrix().numpy()

    def __repr__(self):
        return f"Pose3d({self.rotation!r}, {self.translation.tolist()})"


# direct re-exports: already frozen dataclasses with reference names/defaults
LidarParams = _params.LidarParams


class FeatureExtractionParams:
    """Mutable parameter object (the reference binds ``def_readwrite``
    fields); converted to the frozen dataclass per call."""

    def __init__(self, **kw):
        defaults = _params.FeatureExtractionParams()
        for f in dataclasses.fields(defaults):
            setattr(self, f.name, kw.pop(f.name, getattr(defaults, f.name)))
        if kw:
            raise TypeError(f"unknown parameters: {sorted(kw)}")

    def _frozen(self) -> _params.FeatureExtractionParams:
        names = [f.name for f in dataclasses.fields(_params.FeatureExtractionParams)]
        return _params.FeatureExtractionParams(**{n: getattr(self, n) for n in names})


class RegistrationParams:
    """Mutable registration params mirroring ``registration.h:40-75``."""

    def __init__(self, **kw):
        defaults = _params.RegistrationParams()
        for f in dataclasses.fields(defaults):
            setattr(self, f.name, kw.pop(f.name, getattr(defaults, f.name)))
        if kw:
            raise TypeError(f"unknown parameters: {sorted(kw)}")

    def _frozen(self) -> _params.RegistrationParams:
        names = [f.name for f in dataclasses.fields(_params.RegistrationParams)]
        return _params.RegistrationParams(**{n: getattr(self, n) for n in names})


class LoamFeatures:
    """Mirrors ``LoamFeatures<py::array_t<double>>`` — plain containers of
    edge / planar points (``loam_bindings.cpp:80-83``)."""

    def __init__(self, edge_points=None, planar_points=None):
        self.edge_points = (
            np.zeros((0, 3)) if edge_points is None else np.asarray(edge_points)
        )
        self.planar_points = (
            np.zeros((0, 3)) if planar_points is None else np.asarray(planar_points)
        )


class RegistrationTerminationType:
    """Mirrors the bound enum (``loam_bindings.cpp:129-133``)."""

    CONVERGED = _params.TerminationType.CONVERGED
    MAX_ITER = _params.TerminationType.MAX_ITER
    INSUFFICIENT_ASSOCIATIONS = _params.TerminationType.INSUFFICIENT_ASSOCIATIONS


# export_values() semantics: enum values also live at module scope
CONVERGED = RegistrationTerminationType.CONVERGED
MAX_ITER = RegistrationTerminationType.MAX_ITER
INSUFFICIENT_ASSOCIATIONS = RegistrationTerminationType.INSUFFICIENT_ASSOCIATIONS


class RegistrationIterationInfo:
    """Mirrors ``RegistrationDetail::IterationInfo`` (``registration.h:85-104``)."""

    def __init__(
        self,
        target_T_source_init: Optional[Pose3d] = None,
        edge_associations: Optional[List[Tuple[int, int]]] = None,
        plane_associations: Optional[List[Tuple[int, int]]] = None,
        estimate_update: Optional[Pose3d] = None,
    ):
        self.target_T_source_init = target_T_source_init or Pose3d()
        self.edge_associations = edge_associations or []
        self.plane_associations = plane_associations or []
        self.estimate_update = estimate_update or Pose3d()


class RegistrationDetail:
    """Mirrors reference ``RegistrationDetail`` (``registration.h:79-109``) —
    pass an instance to ``registerFeatures`` to receive diagnostics."""

    def __init__(self):
        self.iteration_info: List[RegistrationIterationInfo] = []
        self.termination_type = RegistrationTerminationType.MAX_ITER


def _as_scan_array(input_scan, device) -> torch.Tensor:
    from .adapters import as_points

    return _place(as_points(input_scan, dtype=np.float64), device)


def extractFeatures(
    input_scan, lidar_params: LidarParams, params: Optional[FeatureExtractionParams] = None,
    device=None,
) -> LoamFeatures:
    """Reference ``extractFeatures`` (``features.h:108-111``): returns dense
    edge/planar arrays in the reference's output order."""
    p = (params or FeatureExtractionParams())._frozen()
    fs = _extract(_as_scan_array(input_scan, device), lidar_params, p)
    edge, planar = fs.compact()
    return LoamFeatures(edge.astype(np.float64), planar.astype(np.float64))


def computeCurvature(
    input_scan, lidar_params: LidarParams, params: Optional[FeatureExtractionParams] = None,
    device=None,
) -> List[float]:
    """Reference ``computeCurvature`` (``features.h:119-122``): flat list,
    -1.0 sentinel at line edges."""
    p = (params or FeatureExtractionParams())._frozen()
    c = _curv(_as_scan_array(input_scan, device), lidar_params, p)
    return c.reshape(-1).tolist()


def computeValidPoints(
    input_scan, lidar_params: LidarParams, params: Optional[FeatureExtractionParams] = None,
    device=None,
) -> List[bool]:
    """Reference ``computeValidPoints`` (``features.h:166-169``)."""
    p = (params or FeatureExtractionParams())._frozen()
    v = _validpts(_as_scan_array(input_scan, device), lidar_params, p)
    return v.reshape(-1).tolist()


def _host_pose(q, t) -> Pose3d:
    return Pose3d(Quaterniond._from_wxyz(q), t.astype(np.float64))


def registerFeatures(
    source: LoamFeatures,
    target: LoamFeatures,
    target_T_source_init: Pose3d,
    params: Optional[RegistrationParams] = None,
    detail: Optional[RegistrationDetail] = None,
    device=None,
) -> Pose3d:
    """Reference ``registerFeatures`` (``registration.h:128-131``)."""
    p = (params or RegistrationParams())._frozen()
    fs = lambda f: _fs_from_points(
        np.asarray(f.edge_points, np.float64).reshape(-1, 3),
        np.asarray(f.planar_points, np.float64).reshape(-1, 3),
        device=device,
    )
    src, tgt = fs(source), fs(target)
    est, det = _register(
        src, tgt, target_T_source_init._pose3(src.edge_points.device), p,
        with_matches=detail is not None,
    )
    if detail is not None:
        detail.termination_type = int(det.termination)
        detail.iteration_info = []
        info = det.iteration_info
        n = int(det.num_iterations)
        em, pm = info.edge_match[:n].cpu().numpy(), info.plane_match[:n].cpu().numpy()
        init_q, init_t, up_q, up_t = (x[:n].cpu().numpy() for x in (
            *info.target_T_source_init, *info.estimate_update))
        for i in range(n):
            detail.iteration_info.append(
                RegistrationIterationInfo(
                    target_T_source_init=_host_pose(init_q[i], init_t[i]),
                    edge_associations=[
                        (int(s), int(t)) for s, t in enumerate(em[i]) if t >= 0
                    ],
                    plane_associations=[
                        (int(s), int(t)) for s, t in enumerate(pm[i]) if t >= 0
                    ],
                    estimate_update=_host_pose(up_q[i], up_t[i]),
                )
            )
    return Pose3d._from_pose3(est)


__all__ = [
    "LidarParams",
    "Pose3d",
    "Quaterniond",
    "FeatureExtractionParams",
    "LoamFeatures",
    "extractFeatures",
    "computeCurvature",
    "computeValidPoints",
    "RegistrationParams",
    "registerFeatures",
    "RegistrationDetail",
    "RegistrationIterationInfo",
    "RegistrationTerminationType",
    "CONVERGED",
    "MAX_ITER",
    "INSUFFICIENT_ASSOCIATIONS",
]
