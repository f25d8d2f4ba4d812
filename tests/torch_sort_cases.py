"""Inputs for the sector sort where its CUDA kernel's key mapping and slice
widths could go wrong, shared by the CPU tests (plain version against
``loam_tpu``'s bitonic kernel in interpret mode, where that takes the case,
and against a numpy lexsort) and the GPU tests (CUDA kernel against the plain
version). The kernel maps a curvature to an unsigned integer key and sorts a
slice padded to 32 * E slots in a warp's registers. Numpy only.
"""

import numpy as np


def _ties(seed, N, P):
    rng = np.random.default_rng(seed)
    # rounded values: plenty of exact ties, which the position key orders
    c = np.round(rng.exponential(2.0, size=(N, P)), 1)
    c[:, :3] = -1.0
    return c


def _zeros(seed, N, P):
    """-0.0 and +0.0 interleaved among small values of both signs: equal as
    keys, so the position alone orders them."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([-0.0, 0.0, -1e-30, 1e-30, -2.5, 2.5, 0.0, -0.0]), size=(N, P))


def _infinities(seed, N, P):
    """+inf and -inf in real slots beside the (+inf, P-1) padding slots."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((N, P))
    c[rng.random((N, P)) < 0.2] = np.inf
    c[rng.random((N, P)) < 0.05] = -np.inf
    c[:, -1] = np.inf  # the real slot whose key equals a padding slot's
    return c


def corner_values(seed, N, P):
    """NaNs of both signs and two payloads, with +inf, -0.0 and ties around
    them: every corner of the key, at any width."""
    rng = np.random.default_rng(seed)
    c = _zeros(seed, N, P) + np.round(rng.standard_normal((N, P)), 0)
    nan = np.array([0x7FF8000000000000, 0xFFF8000000000000, 0x7FF8000100000000],
                   np.uint64).view(np.float64)
    hit = rng.random((N, P)) < 0.2
    c[hit] = rng.choice(nan, size=int(hit.sum()))
    c[rng.random((N, P)) < 0.1] = np.inf
    return c


def _negatives(seed, N, P):
    rng = np.random.default_rng(seed)
    return -np.round(rng.exponential(3.0, size=(N, P)), 1) + (rng.random((N, P)) < 0.3) * 4.0


#: name -> (() -> curvature (N, P) float64, number of sectors, whether
#: loam_tpu's kernel takes the case: no NaN (its ``<`` does not order one)
#: and a slice small enough for interpret mode)
SORT_CASES = {
    "ties": (lambda: _ties(1, 3, 100), 6, True),
    "ties_one_sector": (lambda: _ties(2, 4, 64), 1, True),
    "negative_and_positive_zero": (lambda: _zeros(3, 3, 50), 3, True),
    "negative_keys": (lambda: _negatives(4, 3, 64), 2, True),
    "inf_in_real_slots": (lambda: _infinities(5, 3, 50), 3, True),
    "nan_sorts_last": (lambda: corner_values(6, 3, 50), 3, False),
    "all_equal": (lambda: np.full((2, 40), 1.5), 3, True),
    "all_nan": (lambda: np.full((2, 40), np.nan), 3, False),
    # slice widths: padded to 32 (s_max 5 and 32), 64, 128, 256, 512, 1,024
    "npad_below_32": (lambda: _ties(7, 3, 17), 4, True),
    "npad_32": (lambda: _ties(8, 2, 64), 2, True),
    "npad_64": (lambda: corner_values(9, 2, 100), 2, False),
    "npad_128": (lambda: _ties(10, 2, 200), 2, False),
    "npad_256": (lambda: _infinities(11, 5, 1024), 6, False),
    "npad_512": (lambda: corner_values(12, 2, 1000), 3, False),
    "npad_1024": (lambda: _zeros(13, 3, 1000), 1, False),
    # more sectors than points a sector: every short sector is all padding
    "empty_sectors": (lambda: _ties(14, 2, 5), 8, True),
    # slices not a multiple of the four a block: 7 lines x 3 sectors
    "slices_not_a_multiple_of_the_block": (lambda: _ties(15, 7, 50), 3, True),
}


def lexsort_reference(curv, S):
    """The (curvature, position) order by numpy, independent of the plain
    version: NaN after +inf, -0.0 equal to +0.0, padding slots (+inf, P-1)
    behind a sector's real slots. Returns positions (N, S, s_max) int32."""
    N, P = curv.shape
    pps = P // S
    s_max = P - (S - 1) * pps
    out = np.empty((N, S, s_max), np.int32)
    for li in range(N):
        for s in range(S):
            size = s_max if s == S - 1 else pps
            pos = np.concatenate([s * pps + np.arange(size), np.full(s_max - size, P - 1)])
            key = np.concatenate([curv[li, s * pps : s * pps + size], np.full(s_max - size, np.inf)])
            # rank: NaN above +inf; np.lexsort is stable and its last key is primary
            rank = np.where(np.isnan(key), np.inf, key)
            order = np.lexsort((np.arange(s_max), rank, np.isnan(key)))
            out[li, s] = pos[order]
    return out
