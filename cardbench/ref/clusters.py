"""Morton order of triangles: the scene build sorts triangles by the
Morton code of their centroid, so that spatially close triangles are
contiguous rows, which the traversal's clusters and parts then group
(`traverse.build_tables`). The port's copy of
`rrt_tpu/geometry/clusters.py`'s ordering, numpy only.
"""
from __future__ import annotations

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
