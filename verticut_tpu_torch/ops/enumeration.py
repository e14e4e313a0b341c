"""Hamming-ball enumeration via precomputed XOR flip masks.

The reference enumerates all substring values at Hamming distance exactly
``r`` from the query substring with a recursive bit-flipper
(``src/search_worker.cc:230-264``: flip bit ``len``, recurse with ``rr-1``).
Recursion and data-dependent branching do not map to TPU; but the visited set
is data-independent given ``(s_bits, r)`` — it is ``query ^ mask`` for every
``mask`` with popcount ``r``. So we precompute the C(s_bits, r) masks once on
the host and the device applies them with a single vectorized XOR.

Masks are emitted in the same order the reference's recursion visits them
(lowest flipped-bit-set first in its traversal); order only matters for
deterministic tie behavior in tests.
"""

from __future__ import annotations

import functools
import math
from itertools import combinations

import numpy as np


@functools.lru_cache(maxsize=None)
def n_masks(s_bits: int, radius: int) -> int:
    """C(s_bits, radius) — number of substring values at exact distance r."""
    if radius < 0 or radius > s_bits:
        return 0
    return math.comb(s_bits, radius)


@functools.lru_cache(maxsize=None)
def flip_masks(s_bits: int, radius: int) -> np.ndarray:
    """All ``uint32`` masks with exactly ``radius`` of the low ``s_bits`` set.

    ``uint32[C(s_bits, radius)]``, deterministic order. ``query ^ masks``
    enumerates the radius-``r`` Hamming sphere around ``query``.
    """
    if radius == 0:
        return np.zeros(1, dtype=np.uint32)
    if radius > s_bits:
        return np.zeros(0, dtype=np.uint32)
    # combinations() is lexicographic over bit positions; cheap up to r~6
    # (C(32,6) = 906,192 masks, 3.6 MB).
    combos = np.fromiter(
        (sum(1 << b for b in c) for c in combinations(range(s_bits), radius)),
        dtype=np.uint32, count=math.comb(s_bits, radius))
    return combos


def ball_size(s_bits: int, radius: int) -> int:
    """Number of substring values within Hamming distance <= radius."""
    return sum(n_masks(s_bits, r) for r in range(radius + 1))


def enumeration_cost(s_bits: int, radius: int, n_entries: int,
                     n_tables: int) -> float:
    """Expected candidate count for one more radius step (uniform buckets).

    Used by the search driver to decide when enumerating radius ``r`` costs
    more than a brute-force scan of the table shard — the TPU-native
    replacement for the reference's unconditional radius loop (which is only
    viable because its per-bucket RDMA reads are latency- not compute-bound).
    """
    avg_bucket = n_entries / float(1 << s_bits)
    return n_masks(s_bits, radius) * max(avg_bucket, 0.0) * n_tables
