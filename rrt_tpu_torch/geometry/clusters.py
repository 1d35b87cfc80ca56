"""Morton-ordered triangle clustering: the TPU-native acceleration
structure.

The reference accelerates traversal with a pointer-tree BVH
(`bvh.cpp:49-96`) — hostile to TPU vector units (data-dependent tree walks,
per-ray stacks, gathers). The TPU-native equivalent is a dense two-level
structure:

  1. triangles are sorted by the Morton code of their bbox centroid so that
     spatially-close triangles are contiguous rows;
  2. consecutive runs of `cluster_size` rows form clusters with precomputed
     bboxes.

Traversal tests a whole *ray tile* against each cluster bbox (a dense
(R×K) slab test) and runs the per-triangle Möller–Trumbore chunk only for
clusters some ray in the tile touches — a scalar `@pl.when` predicate in
the Pallas kernel, so the skip costs one vector reduce instead of a branchy
tree walk. Same asymptotic culling as a 2-level BVH, zero divergence.

The port's copy of `rrt_tpu/geometry/clusters.py`, numpy only (the JAX
package may take the same results from its native library).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v 3 apart (Morton interleave helper)."""
    v = v.astype(np.uint64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3(p: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for points p (N,3) normalized to the unit cube."""
    lo = p.min(axis=0)
    hi = p.max(axis=0)
    ext = np.where(hi - lo > 0, hi - lo, 1.0)
    q = np.clip(((p - lo) / ext) * 1023.0, 0, 1023).astype(np.uint64)
    return (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) \
        | _expand_bits(q[:, 2])


def morton_order(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Permutation sorting triangles by centroid Morton code."""
    c = (v0 + v1 + v2) / 3.0
    return np.argsort(morton3(c), kind="stable")


def cluster_bboxes(v0, v1, v2, valid, cluster_size: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cluster AABBs over consecutive `cluster_size` triangle rows.

    Invalid (padding) rows contribute nothing; empty clusters get an
    inverted bbox that fails every slab test.
    """
    t = len(v0)
    assert t % cluster_size == 0
    k = t // cluster_size
    lo = np.full((k, 3), np.inf)
    hi = np.full((k, 3), -np.inf)
    mins = np.minimum(np.minimum(v0, v1), v2)
    maxs = np.maximum(np.maximum(v0, v1), v2)
    for i in range(k):
        sl = slice(i * cluster_size, (i + 1) * cluster_size)
        m = valid[sl]
        if m.any():
            lo[i] = mins[sl][m].min(axis=0)
            hi[i] = maxs[sl][m].max(axis=0)
    # inverted boxes (lo=+big, hi=-big) for empty clusters fail slab tests
    lo[~np.isfinite(lo)] = 3e37
    hi[~np.isfinite(hi)] = -3e37
    return lo, hi
