"""Holding the port's outputs to the float64 oracle: the rules that
``chip_smoke.py`` and the tests share.

* :func:`check_knn`: a search's result for sampled queries against
  :func:`~loam_tpu_torch.neighbors.knn_oracle` in float64 on the same
  float32 coordinates. A float32 squared distance, ``(dx*dx + dy*dy) +
  dz*dz`` with ``dx = t - q`` each step rounded, is within 5 units of
  float32 rounding (5 * 2^-24) of the exact value, so two neighbours can
  only trade places, and a neighbour can only cross the radius, where the
  exact values lie within 10 such units. A row is a near tie when a gap
  between consecutive ranks 1..k+1, or the gap of a rank 1..k to the
  squared radius, is at most ``KNN_MARGIN`` (2^-20, 16 units) of the larger
  value; every other row must have the oracle's indices and mask exactly.
  Every row's squared distances, rank by rank where both are valid, must be
  within ``KNN_D2_RTOL`` of the oracle's (order statistics move no more
  than the values do).
* :func:`check_icf`: one registration's detail against
  :func:`~loam_tpu_torch.oracle.register_oracle`: the termination code and
  iteration count, and per iteration the association masks and matches
  exactly and the poses within ``tests/test_icf_oracle.py``'s 1e-9
  (inputs) and 1e-8 (deltas).
* :func:`pose_gap`: translation and rotation distance of a pose from the
  oracle's, for float32 runs, which are held to a tolerance instead.
"""

from __future__ import annotations

import numpy as np

from ..neighbors.bruteforce import knn_oracle
from .icf_oracle import _quat_multiply

KNN_MARGIN = 2.0 ** -20
KNN_D2_RTOL = 1e-6
ICF_INPUT_ATOL = 1e-9
ICF_DELTA_ATOL = 1e-8


def check_knn(what, queries, targets, target_mask, k, max_dist, indices, distances, mask) -> dict:
    """Raise AssertionError where the search's ``indices`` / ``distances``
    / ``mask`` ((S, k), numpy; Euclidean distances) for ``queries`` (S, 3)
    against ``targets`` (M, 3) / ``target_mask`` (M,) disagree with the
    oracle outside the near-tie margin (module docstring). Returns the
    counts: rows, near ties, and the largest relative d2 error."""
    q = np.asarray(queries, np.float64)
    t = np.asarray(targets, np.float64)
    tm = np.asarray(target_mask, bool)
    oi, _, om = knn_oracle(q, t, tm, k + 1)  # no radius: the k + 1 nearest
    d2 = np.where(om, np.sum((t[oi] - q[:, None, :]) ** 2, axis=-1), np.inf)
    r2 = float(max_dist) ** 2 if max_dist > 0 else np.inf
    o_valid = d2[:, :k] < r2
    with np.errstate(invalid="ignore"):
        close = np.isfinite(d2[:, 1:]) & (np.diff(d2, axis=1) <= KNN_MARGIN * d2[:, 1:])
    edge = np.abs(d2[:, :k] - r2) <= KNN_MARGIN * r2 if np.isfinite(r2) else np.zeros_like(o_valid)
    near = close.any(1) | edge.any(1)
    far = ~near
    idx, dist, m = np.asarray(indices), np.asarray(distances, np.float64), np.asarray(mask, bool)
    bad = far & ((m != o_valid).any(1) | (np.where(o_valid, idx, 0) != np.where(o_valid, oi[:, :k], 0)).any(1))
    if bad.any():
        r = int(np.flatnonzero(bad)[0])
        raise AssertionError(
            f"{what}: {int(bad.sum())} rows outside the near-tie margin differ from the f64 oracle; row "
            f"{r}: indices {idx[r].tolist()} mask {m[r].tolist()}, oracle {oi[r, :k].tolist()} "
            f"{o_valid[r].tolist()}, oracle d2 {d2[r].tolist()}")
    both = m & o_valid
    rel = np.abs(dist ** 2 - d2[:, :k]) / np.maximum(d2[:, :k], np.finfo(np.float64).tiny)
    err = float(rel[both].max()) if both.any() else 0.0
    if not err <= KNN_D2_RTOL:
        raise AssertionError(f"{what}: squared distances {err:.3e} (relative) from the f64 oracle's, "
                             f"above {KNN_D2_RTOL}")
    return dict(rows=len(q), near_ties=int(near.sum()), d2_rtol=err)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def check_icf(what, detail, oracle) -> int:
    """Raise AssertionError where a registration's ``detail`` (one pair's
    ``RegistrationDetail``, float64, with matches) departs from the
    ``OracleResult``: termination and iteration count equal; per iteration,
    validity and matches of every source slot the oracle has equal, the
    entering estimate within ``ICF_INPUT_ATOL`` and the delta within
    ``ICF_DELTA_ATOL``. Returns the iteration count."""
    n = int(detail.num_iterations)
    if int(detail.termination) != oracle.termination or n != len(oracle.iterations):
        raise AssertionError(f"{what}: termination {int(detail.termination)} after {n} iterations, the "
                             f"oracle {oracle.termination} after {len(oracle.iterations)}")
    info = detail.iteration_info
    for i, it in enumerate(oracle.iterations):
        for cls, valid, match in (("edge", it.edge_valid, it.edge_match),
                                  ("plane", it.plane_valid, it.plane_match)):
            got = _np(getattr(info, f"{cls}_match")[i])[: len(match)]
            if not (np.array_equal(got >= 0, valid) and np.array_equal(got, match)):
                raise AssertionError(f"{what}: iteration {i}: {int((got != match).sum())} {cls} matches "
                                     "differ from the oracle's")
        for name, pose, q, t, atol in (
                ("entering estimate", info.target_T_source_init, it.est_in_q, it.est_in_t, ICF_INPUT_ATOL),
                ("delta", info.estimate_update, it.delta_q, it.delta_t, ICF_DELTA_ATOL)):
            gap = max(np.abs(_np(pose.rotation[i]) - q).max(), np.abs(_np(pose.translation[i]) - t).max())
            if not gap <= atol:
                raise AssertionError(f"{what}: iteration {i}: {name} {gap:.3e} from the oracle's (limit {atol})")
    return n


def pose_gap(rotation, translation, oracle):
    """(metres, radians) between a pose and the oracle's final one."""
    q = _np(rotation).astype(np.float64)
    t = _np(translation).astype(np.float64)
    inv = oracle.q * np.array([1.0, -1.0, -1.0, -1.0])
    rel = _quat_multiply(inv, q / np.linalg.norm(q))
    return (float(np.linalg.norm(t - oracle.t)),
            float(2.0 * np.arctan2(np.linalg.norm(rel[1:]), abs(rel[0]))))
