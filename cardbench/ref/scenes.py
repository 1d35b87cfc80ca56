"""The UV-sphere mesh that a configuration may put in its scene's
spheres' place (`inputs.scene_info`): a frozen copy of the port's
`rrt_tpu_torch/scenes/__init__.py` `_uv_sphere`.
"""
from __future__ import annotations

import numpy as np


def uv_sphere(stacks, slices, center, radius):
    """Vertices and triangles of a closed UV sphere: 2·slices·(stacks - 1)
    triangles."""
    verts = []
    for i in range(stacks + 1):
        th = np.pi * i / stacks
        for j in range(slices):
            ph = 2.0 * np.pi * j / slices
            verts.append([np.sin(th) * np.cos(ph), np.cos(th),
                          np.sin(th) * np.sin(ph)])
    verts = np.asarray(verts) * radius + np.asarray(center)
    polys = []
    for i in range(stacks):
        for j in range(slices):
            a = i * slices + j
            b = i * slices + (j + 1) % slices
            c, d = a + slices, b + slices
            if i > 0:
                polys.append([a, b, d])
            if i < stacks - 1:
                polys.append([a, d, c])
    return verts, polys
