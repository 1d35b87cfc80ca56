"""Scenes that ship with the port.

`CBOX_SPHERES` is a hand-written COLLADA file in the CGL profile: a diffuse
Cornell box (floor at y = 0, two units across) with two diffuse spheres and
one area light under the ceiling, in the shape of CBspheres_lambertian; the
default black hole at (0, 1, 0) lies inside it. `CBOX_MIRROR_GLASS` is
the same box with a mirror sphere (left) and a glass sphere of index 1.5
(right), in the shape of BASELINE config 3's CBspheres. `uv_sphere_box` builds a
procedural scene of more than 4096 triangles, so that traversal runs over
several triangle parts. `cbox_dense` is the bench's BVH-scale scene: the
same box, light and camera with a 28,560-triangle mesh in place of the
spheres.
"""
from __future__ import annotations

import os

import numpy as np

from rrt_tpu_torch.io import collada

CBOX_SPHERES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cbox_spheres.dae")
CBOX_MIRROR_GLASS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "cbox_mirror_glass.dae")


def _uv_sphere(stacks, slices, center, radius):
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


def uv_sphere_box() -> collada.SceneInfo:
    """A UV-sphere mesh of 4512 triangles (48 stacks × 48 slices, radius
    0.5) inside a closed diffuse box [-1, 1]³, with a camera: 4524
    triangles, padded to 4544 rows, make three parts of 2048 rows."""
    verts, polys = _uv_sphere(48, 48, (0.3, 0.4, -0.1), 0.5)
    box = np.array([[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0)
                    for z in (-1.0, 1.0)])
    quads = [[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1], [2, 3, 7, 6],
             [0, 2, 6, 4], [1, 5, 7, 3]]
    box_polys = [[q[0], q[1], q[2]] for q in quads] \
        + [[q[0], q[2], q[3]] for q in quads]
    white = collada.MaterialInfo(reflectance=np.full(3, 0.7))
    eye = np.eye(4)
    return collada.SceneInfo(nodes=[
        collada.Node(transform=eye, instance=collada.CameraInfo(),
                     name="camera"),
        collada.Node(transform=eye, name="sphere", instance=collada.PolymeshInfo(
            vertices=verts, polygons=polys, material=white)),
        collada.Node(transform=eye, name="box", instance=collada.PolymeshInfo(
            vertices=box, polygons=box_polys, material=white)),
    ])


def cbox_dense(stacks: int = 120, slices: int = 120) -> collada.SceneInfo:
    """The bench's BVH-scale scene, standing in for CBbunny (28.6k
    triangles): `CBOX_SPHERES` with its two spheres replaced by one closed
    white UV-sphere mesh of 120 stacks × 120 slices (28,560 triangles,
    radius 0.4, on the floor at (0.15, 0.4, -0.1), so the default hole at
    (0, 1, 0) stays 0.62 from its centre, outside it). With the box's 16
    triangles that is 28,576 triangles in 28,608 rows, CBbunny's row
    count: more than 8192, so clusters of 8, in 14 parts of 2048 rows.
    Other `stacks` and `slices` give the same scene at other sizes (160 ×
    160: 50,880 mesh triangles, whose box tables outgrow a block's shared
    memory in the trace kernel)."""
    info = collada.load(CBOX_SPHERES)
    white = info.find(collada.SphereInfo)[0].instance.material
    verts, polys = _uv_sphere(stacks, slices, (0.15, 0.4, -0.1), 0.4)
    mesh = collada.Node(transform=np.eye(4), name="dense_mesh",
                        instance=collada.PolymeshInfo(
                            vertices=verts, polygons=polys,
                            material=white))
    info.nodes = [n for n in info.nodes
                  if not isinstance(n.instance, collada.SphereInfo)] + [mesh]
    return info
