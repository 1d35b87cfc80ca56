"""SceneInfo → flat SceneData + configured Camera (the port of
`rrt_tpu/scene/build.py`).

The numpy stage is the JAX package's, line for line: node transforms are
baked into world-space triangle and sphere arrays, triangles are Morton
ordered and padded to a multiple of 64 rows, spheres to 8 rows with the
live count kept, materials become BSDFTable rows and area lights
LightTable rows. Materials other than diffuse and emission, and lights
other than area lights, are refused: the reference shades only what the
configured scenes hold.
The result is a dictionary of numpy arrays that
`convert.scene_from_arrays` turns into tensors on the caller's device.
The orbit camera is placed from the scene bbox as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from cardbench.ref.convert import scene_from_arrays
from cardbench.ref import clusters as cl
from cardbench.ref import collada
from cardbench.ref import mesh as meshlib
from cardbench.ref.camera import Camera
from cardbench.ref.types import (BSDF_DIFFUSE, BSDF_EMISSION, LIGHT_AREA,
                                 SceneData)

# triangle rows are padded to a multiple of this
PAD_TRIS = 64

_BSDF_KIND = {"diffuse": BSDF_DIFFUSE, "emission": BSDF_EMISSION}


def _xf_point(m: np.ndarray, p) -> np.ndarray:
    """(m · (p,1)).to3D(): no w-divide, as the reference's light and
    camera wrappers use it."""
    out = m @ np.append(np.asarray(p, dtype=np.float64), 1.0)
    return out[:3]


def _xf_point_proj(m: np.ndarray, p) -> np.ndarray:
    """(m · (p,1)).projectTo3D(): with w-divide, for sphere centers."""
    out = m @ np.append(np.asarray(p, dtype=np.float64), 1.0)
    return out[:3] / out[3]


def _bsdf_table(rows, dtype) -> dict:
    """One row per material instance; a missing material is the gray
    DiffuseBSDF(0.5) of dynamic_scene/mesh.cpp:31-34."""
    rows = rows or [collada.MaterialInfo()]
    other = sorted({m.kind for m in rows} - set(_BSDF_KIND))
    if other:
        raise ValueError(f"materials {other}: the reference shades diffuse "
                         "and emission rows only")
    return dict(
        kind=np.asarray([_BSDF_KIND[m.kind] for m in rows], np.int32),
        reflectance=np.asarray([m.reflectance for m in rows], dtype),
        transmittance=np.asarray([m.transmittance for m in rows], dtype),
        emission=np.asarray([m.emission for m in rows], dtype),
        eta=np.asarray([m.eta for m in rows], dtype),
        k=np.asarray([m.k for m in rows], dtype),
        alpha=np.asarray([m.alpha for m in rows], dtype),
        ior=np.asarray([m.ior for m in rows], dtype),
    )


def _light_row(node: collada.Node) -> dict:
    """The DynamicScene area light wrapper composed with the StaticScene
    constructor (area_light.h:9-26, static_scene/light.cpp)."""
    li: collada.LightInfo = node.instance
    if li.light_type != "area":
        raise ValueError(f"a {li.light_type} light: the reference samples "
                         "area lights only")
    t = node.transform
    pos = _xf_point(t, np.zeros(3))
    d = _xf_point(t, li.direction) - pos
    dim_x = _xf_point(t, np.cross(li.up, li.direction)) - pos
    dim_y = _xf_point(t, li.up) - pos
    return dict(kind=LIGHT_AREA,
                radiance=np.asarray(li.spectrum, dtype=np.float64),
                position=pos, direction=d / np.linalg.norm(d), dim_x=dim_x,
                dim_y=dim_y,
                area=np.linalg.norm(dim_x) * np.linalg.norm(dim_y))


def _light_table(rows, dtype) -> dict:
    if not rows:
        z3 = np.zeros((0, 3), dtype)
        return dict(kind=np.zeros((0,), np.int32), radiance=z3, position=z3,
                    direction=z3, dim_x=z3, dim_y=z3,
                    area=np.zeros((0,), dtype), kind_host=())
    col = lambda k: np.asarray([r[k] for r in rows], dtype)
    return dict(kind=np.asarray([r["kind"] for r in rows], np.int32),
                radiance=col("radiance"), position=col("position"),
                direction=col("direction"), dim_x=col("dim_x"),
                dim_y=col("dim_y"), area=col("area"),
                kind_host=tuple(int(r["kind"]) for r in rows))


def _scene_arrays(info: collada.SceneInfo):
    """The numpy stage of the build: (arrays dict, camera info, camera
    view direction, scene bbox lo, scene bbox hi)."""
    dtype = np.float32
    materials = []
    tv0, tv1, tv2, tn0, tn1, tn2, tb = [], [], [], [], [], [], []
    sph_c, sph_r, sph_b = [], [], []
    light_rows = []
    cam_info: Optional[collada.CameraInfo] = None
    c_dir = np.array([0.0, 0.0, -1.0])
    bbox_min = np.full(3, np.inf)
    bbox_max = np.full(3, -np.inf)

    def add_material(mat):
        materials.append(mat if mat is not None else collada.MaterialInfo())
        return len(materials) - 1

    for node in info.nodes:
        inst = node.instance
        if isinstance(inst, collada.CameraInfo):
            cam_info = inst
            # c_dir = (T·(view_dir,1)).unit(), as a point
            # (application.cpp:238-240)
            d = _xf_point(node.transform, inst.view_dir)
            c_dir = d / np.linalg.norm(d)
        elif isinstance(inst, collada.LightInfo):
            light_rows.append(_light_row(node))
        elif isinstance(inst, collada.SphereInfo):
            # application.cpp:330-343
            pos = _xf_point_proj(node.transform, np.zeros(3))
            scale = np.linalg.norm(
                node.transform[:3, :3] @ np.array([1.0, 0, 0]))
            r = inst.radius * scale
            sph_c.append(pos)
            sph_r.append(r)
            sph_b.append(add_material(inst.material))
            bbox_min = np.minimum(bbox_min, pos - r)
            bbox_max = np.maximum(bbox_max, pos + r)
        elif isinstance(inst, collada.PolymeshInfo):
            if len(inst.polygons) == 0 or len(inst.vertices) == 0:
                continue
            verts = meshlib.transform_vertices(node.transform, inst.vertices)
            tris = meshlib.triangulate(inst.polygons)
            normals = meshlib.reference_vertex_normals(verts, inst.polygons)
            bid = add_material(inst.material)
            tv0.append(verts[tris[:, 0]])
            tv1.append(verts[tris[:, 1]])
            tv2.append(verts[tris[:, 2]])
            tn0.append(normals[tris[:, 0]])
            tn1.append(normals[tris[:, 1]])
            tn2.append(normals[tris[:, 2]])
            tb.append(np.full(len(tris), bid, dtype=np.int32))
            bbox_min = np.minimum(bbox_min, verts.min(axis=0))
            bbox_max = np.maximum(bbox_max, verts.max(axis=0))

    if tv0:
        tv0, tv1, tv2, tn0, tn1, tn2 = (np.concatenate(a) for a in
                                        (tv0, tv1, tv2, tn0, tn1, tn2))
        tb = np.concatenate(tb)
    else:
        tv0 = tv1 = tv2 = tn0 = tn1 = tn2 = np.zeros((0, 3))
        tb = np.zeros((0,), dtype=np.int32)

    n_t = len(tb)
    if n_t > 0:
        order = cl.morton_order(tv0, tv1, tv2)
        tv0, tv1, tv2 = tv0[order], tv1[order], tv2[order]
        tn0, tn1, tn2 = tn0[order], tn1[order], tn2[order]
        tb = tb[order]

    # pad triangles to a chunk multiple with degenerate far-away rows
    n_pad = (-n_t) % PAD_TRIS if n_t else PAD_TRIS
    if n_pad:
        far = np.full((n_pad, 3), 1e30)
        zn = np.zeros((n_pad, 3))
        tv0, tv1, tv2 = (np.concatenate([a, far]) for a in (tv0, tv1, tv2))
        tn0, tn1, tn2 = (np.concatenate([a, zn]) for a in (tn0, tn1, tn2))
        tb = np.concatenate([tb, np.full(n_pad, -1, dtype=np.int32)])

    # spheres padded to 8 rows; the live count rides along so traversal
    # only visits the live prefix
    n_live_spheres = len(sph_c)
    while len(sph_c) < 8:
        sph_c.append(np.full(3, 1e30))
        sph_r.append(0.0)
        sph_b.append(-1)

    arrays = dict(
        tri_v0=np.asarray(tv0, dtype), tri_v1=np.asarray(tv1, dtype),
        tri_v2=np.asarray(tv2, dtype), tri_n0=np.asarray(tn0, dtype),
        tri_n1=np.asarray(tn1, dtype), tri_n2=np.asarray(tn2, dtype),
        tri_bsdf=np.asarray(tb, np.int32),
        sph_center=np.asarray(np.asarray(sph_c), dtype),
        sph_radius=np.asarray(np.asarray(sph_r), dtype),
        sph_bsdf=np.asarray(np.asarray(sph_b), np.int32),
        bsdfs=_bsdf_table(materials, dtype),
        lights=_light_table(light_rows, dtype),
        n_live_spheres=n_live_spheres,
    )
    return arrays, cam_info, c_dir, bbox_min, bbox_max


def build_scene(info: collada.SceneInfo, device, screen_w: int = 800,
                screen_h: int = 600) -> Tuple[SceneData, Camera]:
    """Build the flat SceneData on `device` and a camera placed like the
    reference: configured at 800×600 and then resized, as the reference's
    headless path does."""
    arrays, cam_info, c_dir, bbox_min, bbox_max = _scene_arrays(info)
    scene = scene_from_arrays(arrays, device)

    # camera placement from the scene bbox (application.cpp:263-288)
    cam = Camera()
    if cam_info is not None:
        cam.configure(cam_info, 800, 600)
        if (screen_w, screen_h) != (800, 600):
            cam.set_screen_size(screen_w, screen_h)
    if np.all(np.isfinite(bbox_min)):
        target = 0.5 * (bbox_min + bbox_max)
        cvd = np.linalg.norm(bbox_max - bbox_min) / 2 * 1.5
        cam.place(target, math.acos(np.clip(c_dir[1], -1.0, 1.0)),
                  math.atan2(c_dir[0], c_dir[2]), cvd * 2, cvd / 10.0,
                  cvd * 20.0)
    return scene, cam
