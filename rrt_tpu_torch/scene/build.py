"""SceneInfo → flat SceneData + configured Camera (the port of
`rrt_tpu/scene/build.py`).

The numpy stage is the JAX package's, line for line: node transforms are
baked into world-space triangle and sphere arrays, triangles are Morton
ordered and padded to a multiple of 64 rows, spheres to 8 rows with the
live count kept, materials become BSDFTable rows and light wrappers
LightTable rows, with an environment light's row last when there is one.
The result is a dictionary of numpy arrays that
`convert.scene_from_arrays` turns into tensors on the caller's device.
The orbit camera is placed from the scene bbox as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from rrt_tpu_torch.convert import scene_from_arrays
from rrt_tpu_torch.geometry import clusters as cl
from rrt_tpu_torch.io import collada
from rrt_tpu_torch.scene import mesh as meshlib
from rrt_tpu_torch.scene.camera import Camera
from rrt_tpu_torch.types import (
    BSDF_DIFFUSE, BSDF_EMISSION, BSDF_GLASS, BSDF_MICROFACET, BSDF_MIRROR,
    BSDF_REFRACTION, LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_ENV,
    LIGHT_HEMISPHERE, LIGHT_POINT, LIGHT_SPOT, EnvMap, SceneData,
)
from rrt_tpu_torch.utils import stats

# triangle rows are padded to a multiple of this, which is also the
# cluster size of SceneData's bboxes
PAD_TRIS = 64

_BSDF_KIND = {
    "diffuse": BSDF_DIFFUSE,
    "mirror": BSDF_MIRROR,
    "microfacet": BSDF_MICROFACET,
    "refraction": BSDF_REFRACTION,
    "glass": BSDF_GLASS,
    "emission": BSDF_EMISSION,
}


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


def _light_row(node: collada.Node) -> Optional[dict]:
    """The DynamicScene light wrappers composed with the StaticScene light
    constructors (dynamic_scene/*_light.h, static_scene/light.cpp)."""
    li: collada.LightInfo = node.instance
    t = node.transform
    row = dict(kind=-1, radiance=np.asarray(li.spectrum, dtype=np.float64),
               position=np.zeros(3), direction=np.zeros(3),
               dim_x=np.zeros(3), dim_y=np.zeros(3), area=0.0)
    if li.light_type == "ambient":
        row["kind"] = LIGHT_HEMISPHERE
    elif li.light_type == "directional":
        # net dirToLight = unit(T·(d,1)): the reference transforms the
        # direction as a point (directional_light.h, light.cpp:11-15)
        d = _xf_point(t, li.direction)
        row["kind"] = LIGHT_DIRECTIONAL
        row["direction"] = d / np.linalg.norm(d)
    elif li.light_type == "point":
        row["kind"] = LIGHT_POINT
        row["position"] = _xf_point(t, li.position)
    elif li.light_type == "spot":
        pos = _xf_point(t, li.position)
        d = _xf_point(t, li.direction) - pos
        row["kind"] = LIGHT_SPOT
        row["position"] = pos
        row["direction"] = d / np.linalg.norm(d)
    elif li.light_type == "area":
        # area_light.h:9-26
        pos = _xf_point(t, np.zeros(3))
        d = _xf_point(t, li.direction) - pos
        dim_x = _xf_point(t, np.cross(li.up, li.direction)) - pos
        dim_y = _xf_point(t, li.up) - pos
        row["kind"] = LIGHT_AREA
        row["position"] = pos
        row["direction"] = d / np.linalg.norm(d)
        row["dim_x"] = dim_x
        row["dim_y"] = dim_y
        row["area"] = np.linalg.norm(dim_x) * np.linalg.norm(dim_y)
    else:
        return None
    return row


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


def _scene_arrays(info: collada.SceneInfo, with_env: bool = False):
    """The numpy stage of the build: (arrays dict, camera info, camera
    view direction, scene bbox lo, scene bbox hi). `with_env` appends the
    environment light's row, as the reference appends it to
    scene->lights (pathtracer.cpp:107-109)."""
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
            row = _light_row(node)
            if row is not None:
                light_rows.append(row)
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

    if with_env:
        light_rows.append(dict(kind=LIGHT_ENV, radiance=np.zeros(3),
                               position=np.zeros(3), direction=np.zeros(3),
                               dim_x=np.zeros(3), dim_y=np.zeros(3),
                               area=0.0))

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

    cluster_lo, cluster_hi = cl.cluster_bboxes(
        tv0, tv1, tv2, tb >= 0, PAD_TRIS)

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
        cluster_lo=np.asarray(cluster_lo, dtype),
        cluster_hi=np.asarray(cluster_hi, dtype),
        cluster_size=PAD_TRIS,
        n_live_spheres=n_live_spheres,
    )
    return arrays, cam_info, c_dir, bbox_min, bbox_max


@stats.span("setup.scene")
def build_scene(info: collada.SceneInfo, device, screen_w: int = 800,
                screen_h: int = 600, fov_mode: str = "reference",
                env: Optional[EnvMap] = None) -> Tuple[SceneData, Camera]:
    """Build the flat SceneData on `device` and a camera placed like the
    reference. With fov_mode "reference" the camera is configured at
    800×600 and then resized, as the reference's headless path does;
    "native" fits the FoV to the target resolution directly. An
    environment map `env` becomes the scene's last light."""
    arrays, cam_info, c_dir, bbox_min, bbox_max = _scene_arrays(
        info, with_env=env is not None)
    scene = scene_from_arrays(arrays, device)
    if env is not None:
        scene = scene.replace(env=env.to(device))

    # camera placement from the scene bbox (application.cpp:263-288)
    cam = Camera()
    if cam_info is not None:
        if fov_mode == "reference":
            cam.configure(cam_info, 800, 600)
            if (screen_w, screen_h) != (800, 600):
                cam.set_screen_size(screen_w, screen_h)
        else:
            cam.configure(cam_info, screen_w, screen_h)
    if np.all(np.isfinite(bbox_min)):
        target = 0.5 * (bbox_min + bbox_max)
        cvd = np.linalg.norm(bbox_max - bbox_min) / 2 * 1.5
        cam.place(target, math.acos(np.clip(c_dir[1], -1.0, 1.0)),
                  math.atan2(c_dir[0], c_dir[2]), cvd * 2, cvd / 10.0,
                  cvd * 20.0)
    return scene, cam


def load_scene(path: str, device, screen_w: int = 800, screen_h: int = 600,
               fov_mode: str = "reference", env: Optional[EnvMap] = None):
    """Parse a .dae and build the flat scene and camera on `device`, lit
    also by the environment map `env` when one is given."""
    return build_scene(collada.load(path), device, screen_w, screen_h,
                       fov_mode=fov_mode, env=env)
