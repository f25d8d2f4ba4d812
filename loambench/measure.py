"""The yardstick's arithmetic: tails and rates of a run, the union of
device intervals, the table of peaks and the bytes a kernel's work needs
at the least (counted from the shapes, so the same work reads the same
bound whatever implements it)."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

#: NVIDIA H100 SXM, data sheet: HBM3 bandwidth (bytes/s).
HBM_BYTES_PER_S = 3.35e12


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def rate(units: float, seconds: float) -> float:
    """Work completed over the whole window."""
    return units / seconds


def union(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by a set of intervals (overlaps counted once)."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float, stop: float) -> List[Tuple[float, float]]:
    """The uncovered stretches of [start, stop], longest first."""
    out, end = [], start
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, stop)))
        end = max(end, b)
        if end >= stop:
            break
    if end < stop:
        out.append((end, stop))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])


def extract_bytes(rows: int, points: int, sectors: int, slots: int, edge_cap: int, planar_cap: int,
                  curvature_bytes: int = 8) -> int:
    """The three extraction kernels over ``rows`` scan lines of ``points``:
    the sector sort reads the curvature and writes it sorted with the
    positions; the greedy pick reads the validity mask and both candidate
    lists and writes the picks; the copy-out reads the picks and the picked
    float32 points and writes them. ``slots`` is a sector's padded length,
    ``edge_cap`` / ``planar_cap`` the picks a sector admits."""
    cands = sectors * slots
    picks = sectors * (edge_cap + planar_cap)
    sort = points * curvature_bytes + cands * (curvature_bytes + 4)
    pick = points + 2 * cands * 4 + picks * 4
    copy = picks * 4 + picks * 12 + picks * 12
    return rows * (sort + pick + copy)


def share(bound_s: float, measured_s: float):
    """A roofline share in %, or None where nothing was measured."""
    if measured_s <= 0:
        return None
    return 100.0 * bound_s / measured_s
