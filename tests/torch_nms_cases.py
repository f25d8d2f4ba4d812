"""Inputs for the greedy NMS at the shapes its CUDA kernel branches on, shared
by the CPU tests (plain version against ``loam_tpu``'s kernel in interpret
mode) and the GPU tests (CUDA kernel against the plain version). The kernel
keeps a line's mask 32 points a word and a lane, and walks the candidate
lists 32 slots at a time. Numpy only; small enough for interpret mode.
"""

import numpy as np


def random_candidates(rng, L, P, S, density=0.5):
    """(L, S, s_max) int32 candidate lists: a random subset of each sector's
    positions, shuffled, at a random offset among -1 slots."""
    pps = P // S
    s_max = P - (S - 1) * pps
    c = np.full((L, S, s_max), -1, np.int32)
    for li in range(L):
        for s in range(S):
            size = s_max if s == S - 1 else pps
            pos = s * pps + rng.permutation(size)[: int(size * density)]
            off = rng.integers(0, s_max - len(pos) + 1)
            c[li, s, off : off + len(pos)] = pos
    return c


def _random(seed, L, P, S, max_e, max_p, n, density=0.5, valid=None):
    rng = np.random.default_rng(seed)
    v = rng.random((L, P)) > 0.2 if valid is None else np.full((L, P), valid)
    return (v, random_candidates(rng, L, P, S, density), random_candidates(rng, L, P, S, density),
            max_e, max_p, n)


def _listed(P, n, edges, planars, max_e=12, max_p=12):
    """One fully valid line, one sector: the lists as given, then -1."""
    def pad(xs):
        c = np.full((1, 1, P), -1, np.int32)
        c[0, 0, : len(xs)] = xs
        return c

    return np.ones((1, P), bool), pad(edges), pad(planars), max_e, max_p, n


def _all_minus_one():
    v, ce, cp, *rest = _random(8, 3, 70, 2, 2, 4, 2)
    return (v, np.full_like(ce, -1), np.full_like(cp, -1), *rest)


#: name -> () -> (valid (L, P) bool, cand_e, cand_p (L, S, s_max) int32,
#: max_e, max_p, n)
NMS_CASES = {
    # a last mask word that is partly used, and a line shorter than a word
    "P_not_a_multiple_of_32": lambda: _random(1, 3, 100, 2, 3, 6, 2),
    "P_below_32": lambda: _random(2, 2, 24, 2, 1, 2, 2),
    # 75 slots a list: two full groups of 32 and a ragged third
    "s_max_not_a_multiple_of_32": lambda: _random(3, 2, 150, 2, 4, 20, 3),
    # the edge 63 clears 61..65 across the word boundary (61 and 65 die), the
    # planar 31 clears 29..33 (33 and 30 die, 34 lives); 64 and 62 are dead
    # from the edge pass, 66 lives
    "reach_crosses_a_word": lambda: _listed(96, 3, [63, 61, 65, 95], [31, 33, 30, 34, 64, 62, 66, 0]),
    # n - 1 = 39 points each way: a window covers whole words
    "reach_wider_than_a_word": lambda: _random(5, 3, 128, 2, 3, 7, 40),
    "n_1": lambda: _random(6, 3, 64, 2, 2, 30, 1),
    # every point a live candidate and no suppression beyond itself: the
    # planar cap (cap + 1 = 5 accepts) and the edge cap (1) are reached inside
    # a list's first group of 32
    "cap_reached_inside_a_group": lambda: _random(7, 2, 128, 2, 0, 4, 1, density=1.0, valid=True),
    # the 6th accept is the last slot of the first group of 32, the list goes on
    "cap_reached_at_a_group_end": lambda: _listed(
        80, 1, [], [-1] * 26 + [1, 2, 3, 4, 5, 6, 7, 8, 9], max_p=5),
    "lists_all_minus_one": _all_minus_one,
    "all_points_invalid": lambda: _random(9, 3, 70, 2, 2, 4, 2, valid=False),
    # a candidate that an accept earlier in the same group of 32 suppressed,
    # and one that occurs twice
    "suppressed_inside_a_group": lambda: _listed(64, 3, [], [10, 12, 13, 11, 9, 8, 7, 10, 20, 18, 22, 23]),
}
