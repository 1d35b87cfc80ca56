"""COLLADA (.dae) scene parser for the CGL profile.

A from-scratch implementation of the subset the reference consumes
(reference `pathtracer/src/collada/collada.cpp`):

* up-axis correction to Y-up via a global entry transform
  (collada.cpp:162-201),
* recursive node walk composing `matrix`/`rotate`/`translate`/`scale`
  (collada.cpp:234-349; note the reference's `rotate`/`scale` readers are
  buggy — they scatter raw floats into matrix slots — but no shipped scene
  uses them, so we implement them *correctly* here),
* instances: perspective cameras (collada.cpp:432-473), lights from
  `technique_common` or the CGL `extra` profile (collada.cpp:475-576),
  CGL `<sphere>` extras (collada.cpp:578-601), polymeshes
  (collada.cpp:604-850), and materials that map directly to BSDF rows
  (collada.cpp:852-936).

Output is plain Python/numpy "info" records (the analog of
`collada/*_info.h`); `rrt_tpu_torch.scene.build` turns them into the flat
`SceneData` tensors.

The port's copy of `rrt_tpu/io/collada.py`, numpy and `xml` only: number
lists are parsed in Python at every size (the JAX package hands long ones
to its native library; the results are the same floats and ints).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import xml.etree.ElementTree as ET

from rrt_tpu_torch.utils import stats


# ---------------------------------------------------------------- info types

@dataclasses.dataclass
class CameraInfo:
    h_fov: float = 50.0
    v_fov: float = 35.0
    n_clip: float = 0.001
    f_clip: float = 1000.0
    # default view direction is -z, up from the up-axis (collada.cpp:439-441)
    view_dir: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -1.0]))
    up_dir: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0]))


@dataclasses.dataclass
class LightInfo:
    light_type: str = "none"  # ambient|directional|area|point|spot
    spectrum: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    # COLLADA defaults (light_info.cpp:13-15)
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -1.0]))
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    # the reference's write-only catch-all (see _parse_light)
    constant_att: float = 1.0


@dataclasses.dataclass
class MaterialInfo:
    """A BSDF description; `kind` ∈ diffuse|mirror|microfacet|refraction|
    glass|emission, parameters per collada.cpp:852-936."""

    kind: str = "diffuse"
    reflectance: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, 0.5))
    transmittance: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    emission: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    eta: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    k: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    alpha: float = 0.0
    ior: float = 1.0


@dataclasses.dataclass
class SphereInfo:
    radius: float = 1.0
    material: Optional[MaterialInfo] = None


@dataclasses.dataclass
class PolymeshInfo:
    vertices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    # list of per-polygon vertex index lists
    polygons: List[List[int]] = dataclasses.field(default_factory=list)
    material: Optional[MaterialInfo] = None
    # authored NORMAL/TEXCOORD sources + per-polygon corner index lists
    # (collada.cpp:718-846). The reference parses these but its renderer
    # never consumes them (normals come from the halfedge recompute);
    # carried here for the same round-trip completeness and for textured
    # extensions.
    normals: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    texcoords: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2)))
    normal_indices: List[List[int]] = dataclasses.field(default_factory=list)
    texcoord_indices: List[List[int]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class Node:
    transform: np.ndarray  # (4,4) world transform (global up-fix included)
    instance: object       # one of the *Info types
    name: str = ""


@dataclasses.dataclass
class SceneInfo:
    nodes: List[Node] = dataclasses.field(default_factory=list)

    def find(self, cls):
        return [n for n in self.nodes if isinstance(n.instance, cls)]


# ---------------------------------------------------------------- helpers

def _strip_ns(tag: str) -> str:
    return tag.split("}", 1)[-1]


def _floats(text: str) -> np.ndarray:
    return np.array([float(t) for t in text.split()])


def _spectrum(text: str) -> np.ndarray:
    v = _floats(text)
    return v[:3].astype(np.float64)


class _Doc:
    """Flattened XML document with an id→element table (uri_load analog)."""

    def __init__(self, root: ET.Element):
        self.root = root
        self.by_id: Dict[str, ET.Element] = {}
        for el in root.iter():
            eid = el.get("id")
            if eid is not None:
                self.by_id[eid] = el

    def child(self, el: ET.Element, name: str) -> Optional[ET.Element]:
        for c in el:
            if _strip_ns(c.tag) == name:
                return c
        return None

    def children(self, el: ET.Element, name: str) -> List[ET.Element]:
        return [c for c in el if _strip_ns(c.tag) == name]

    def get(self, el: ET.Element, query: str) -> Optional[ET.Element]:
        """Walk a 'a/b/c' path, following url="#id" indirection at the end
        (reference get_element, collada.cpp:77-97)."""
        e = el
        for token in query.split("/"):
            if e is None:
                return None
            e = self.child(e, token)
        if e is not None:
            url = e.get("url")
            if url:
                e = self.by_id.get(url[1:])
        return e

    def technique_common(self, el: ET.Element) -> Optional[ET.Element]:
        """profile_COMMON technique sid="common", else technique_common
        (collada.cpp:100-114)."""
        prof = self.child(el, "profile_COMMON")
        if prof is not None:
            for t in self.children(prof, "technique"):
                if t.get("sid") == "common":
                    return t
        return self.child(el, "technique_common")

    def technique_cgl(self, el: ET.Element) -> Optional[ET.Element]:
        """extra/technique with profile="CGL" (collada.cpp:117-128)."""
        extra = self.child(el, "extra")
        if extra is None:
            return None
        for t in self.children(extra, "technique"):
            if t.get("profile") == "CGL":
                return t
        return None


def _up_axis_transform(up_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Global entry transform fixing the scene to Y-up
    (collada.cpp:169-200)."""
    m = np.eye(4)
    if up_dir == "X_UP":
        m[0, 0] = 0.0
        m[0, 1] = 1.0
        m[1, 0] = 1.0
        m[1, 1] = 0.0
        m[2, 2] = -1.0
        up = np.array([1.0, 0.0, 0.0])
    elif up_dir == "Z_UP":
        m[1, 1] = 0.0
        m[1, 2] = 1.0
        m[2, 1] = 1.0
        m[2, 2] = 0.0
        m[0, 0] = -1.0
        up = np.array([0.0, 0.0, 1.0])
    elif up_dir == "Y_UP":
        up = np.array([0.0, 1.0, 0.0])
    else:
        raise ValueError(f"invalid up direction {up_dir!r}")
    return m, up


def _node_local_transform(doc: _Doc, el: ET.Element) -> np.ndarray:
    """Compose a node's transformation list (collada.cpp:247-331).

    A `<matrix>` wins outright (the reference `break`s on it); otherwise
    rotate/translate/scale compose in declaration order as m_i · acc.
    """
    acc = np.eye(4)
    for c in el:
        name = _strip_ns(c.tag)
        if name == "matrix":
            v = _floats(c.text)
            if len(v) < 16:
                # Malformed matrices exist in shipped scenes (CBgems.dae has
                # a 15-float camera matrix). The reference's stream reads
                # leave missing entries uninitialized; we deterministically
                # zero-fill instead.
                v = np.concatenate([v, np.zeros(16 - len(v))])
            return v[:16].reshape(4, 4)
        if name == "rotate":
            v = _floats(c.text)
            axis, ang = v[:3], math.radians(v[3])
            axis = axis / (np.linalg.norm(axis) or 1.0)
            x, y, z = axis
            cth, sth, ct1 = math.cos(ang), math.sin(ang), 1 - math.cos(ang)
            r = np.array([
                [cth + x * x * ct1, x * y * ct1 - z * sth, x * z * ct1 + y * sth],
                [y * x * ct1 + z * sth, cth + y * y * ct1, y * z * ct1 - x * sth],
                [z * x * ct1 - y * sth, z * y * ct1 + x * sth, cth + z * z * ct1],
            ])
            m = np.eye(4)
            m[:3, :3] = r
            acc = m @ acc
        elif name == "translate":
            v = _floats(c.text)
            m = np.eye(4)
            m[:3, 3] = v[:3]
            acc = m @ acc
        elif name == "scale":
            v = _floats(c.text)
            m = np.diag([v[0], v[1], v[2], 1.0])
            acc = m @ acc
    return acc


# ---------------------------------------------------------------- parsers

def _parse_camera(doc: _Doc, el: ET.Element, up: np.ndarray) -> CameraInfo:
    cam = CameraInfo(up_dir=up.copy())
    persp = doc.get(el, "optics/technique_common/perspective")
    if persp is None:
        raise ValueError("camera without perspective optics")
    xfov = doc.child(persp, "xfov")
    yfov = doc.child(persp, "yfov")
    znear = doc.child(persp, "znear")
    zfar = doc.child(persp, "zfar")
    cam.h_fov = float(xfov.text) if xfov is not None else 50.0
    cam.v_fov = float(yfov.text) if yfov is not None else 35.0
    cam.n_clip = float(znear.text) if znear is not None else 0.001
    cam.f_clip = float(zfar.text) if zfar is not None else 1000.0
    if yfov is None:
        ar_el = doc.child(persp, "aspect_ratio")
        if ar_el is None:
            raise ValueError("incomplete perspective definition")
        ar = float(ar_el.text)
        cam.v_fov = math.degrees(
            2 * math.atan(math.tan(math.radians(0.5 * cam.h_fov)) / ar))
    return cam


def _parse_light(doc: _Doc, el: ET.Element) -> LightInfo:
    light = LightInfo()
    # CGL profile wins over technique_common (collada.cpp:482-486)
    tech = doc.technique_cgl(el)
    if tech is None:
        tech = doc.technique_common(el)
    if tech is None:
        raise ValueError("light with no supported profile")
    e_light = next(iter(tech), None)
    if e_light is None:
        return light
    ltype = _strip_ns(e_light.tag)
    if ltype not in ("ambient", "directional", "area", "point", "spot"):
        raise ValueError(f"unsupported light type {ltype!r}")
    light.light_type = ltype
    color = doc.child(e_light, "color")
    if color is not None:
        light.spectrum = _spectrum(color.text)
    # attenuation / falloff: the reference funnels EVERY one of these
    # values into the same `constant_att` field, last assignment winning
    # (collada.cpp:533-571 assigns falloff_angle, falloff_exponent,
    # constant/linear/quadratic_attenuation all to constant_att) — and
    # never reads it. Replicated, minus the hard exit() on absence.
    for tag in ("falloff_angle", "falloff_exponent",
                "constant_attenuation", "linear_attenuation",
                "quadratic_attenuation"):
        e = doc.child(e_light, tag)
        if e is not None and e.text:
            light.constant_att = float(e.text)
    return light


def _parse_sphere(doc: _Doc, el: ET.Element) -> SphereInfo:
    tech = doc.technique_cgl(el)
    if tech is None:
        raise ValueError("sphere geometry without CGL profile")
    radius = doc.get(tech, "sphere/radius")
    if radius is None:
        raise ValueError("invalid sphere definition")
    return SphereInfo(radius=float(radius.text))


def _parse_polymesh(doc: _Doc, el: ET.Element) -> PolymeshInfo:
    mesh = doc.child(el, "mesh")
    if mesh is None:
        raise ValueError("geometry without mesh data")
    out = PolymeshInfo()

    sources: Dict[str, np.ndarray] = {}
    for src in doc.children(mesh, "source"):
        arr = doc.child(src, "float_array")
        if arr is not None:
            n = int(arr.get("count"))
            sources[src.get("id")] = _floats(arr.text)[:n]

    verts_el = doc.child(mesh, "vertices")
    if verts_el is None:
        raise ValueError("geometry without vertices")
    vertices_id = verts_el.get("id")
    for inp in doc.children(verts_el, "input"):
        if inp.get("semantic") == "POSITION":
            src = inp.get("source")[1:]
            out.vertices = sources[src].reshape(-1, 3)

    poly = doc.child(mesh, "polylist")
    if poly is None:
        # some exporters use <triangles>; treat as a polylist of 3s
        poly = doc.child(mesh, "triangles")
        if poly is None:
            return out
        tri_mode = True
    else:
        tri_mode = False

    vertex_offset = 0
    stride = 0
    has_vertex = False
    normal_offset = texcoord_offset = None
    for inp in doc.children(poly, "input"):
        sem = inp.get("semantic")
        off = int(inp.get("offset", 0))
        stride = max(stride, off + 1)
        if sem == "VERTEX":
            has_vertex = True
            vertex_offset = off
            if inp.get("source")[1:] != vertices_id:
                raise ValueError("VERTEX input does not reference vertices")
        elif sem == "NORMAL":
            normal_offset = off
            s = sources.get(inp.get("source")[1:])
            if s is not None:
                out.normals = s.reshape(-1, 3)
        elif sem == "TEXCOORD":
            texcoord_offset = off
            s = sources.get(inp.get("source")[1:])
            if s is not None:
                out.texcoords = s.reshape(-1, 2)
    if not has_vertex:
        return out

    count = int(poly.get("count"))
    p_el = doc.child(poly, "p")
    idx = np.array([int(t) for t in p_el.text.split()], dtype=np.int64)
    if tri_mode:
        sizes = np.full(count, 3, dtype=np.int64)
    else:
        vcount = doc.child(poly, "vcount")
        sizes = np.array([int(t) for t in vcount.text.split()],
                         dtype=np.int64)[:count]
    # per-corner flat index into idx: corner k of the whole list uses
    # idx[k*stride + offset] (collada.cpp:804-844)
    k = 0
    for sz in sizes:
        out.polygons.append(
            [int(idx[(k + j) * stride + vertex_offset]) for j in range(sz)])
        if normal_offset is not None:
            out.normal_indices.append(
                [int(idx[(k + j) * stride + normal_offset])
                 for j in range(sz)])
        if texcoord_offset is not None:
            out.texcoord_indices.append(
                [int(idx[(k + j) * stride + texcoord_offset])
                 for j in range(sz)])
        k += sz
    return out


def _parse_material(doc: _Doc, el: ET.Element) -> MaterialInfo:
    eff = doc.get(el, "instance_effect")
    if eff is None:
        raise ValueError("material without effect")
    tech_cgl = doc.technique_cgl(eff)
    tech_common = doc.technique_common(eff)
    mat = MaterialInfo()
    if tech_cgl is not None:
        for e in tech_cgl:
            kind = _strip_ns(e.tag)
            if kind == "emission":
                mat.kind = "emission"
                mat.emission = _spectrum(doc.get(e, "radiance").text)
            elif kind == "mirror":
                mat.kind = "mirror"
                mat.reflectance = _spectrum(doc.get(e, "reflectance").text)
            elif kind == "microfacet":
                mat.kind = "microfacet"
                refl = doc.get(e, "reflectance")
                if refl is not None:
                    mat.reflectance = _spectrum(refl.text)
                mat.alpha = float(doc.get(e, "alpha").text)
                mat.eta = _spectrum(doc.get(e, "eta").text)
                mat.k = _spectrum(doc.get(e, "k").text)
            elif kind == "refraction":
                mat.kind = "refraction"
                mat.transmittance = _spectrum(doc.get(e, "transmittance").text)
                mat.ior = float(doc.get(e, "ior").text)
            elif kind == "glass":
                mat.kind = "glass"
                mat.transmittance = _spectrum(doc.get(e, "transmittance").text)
                mat.reflectance = _spectrum(doc.get(e, "reflectance").text)
                mat.ior = float(doc.get(e, "ior").text)
    elif tech_common is not None:
        diffuse = doc.get(tech_common, "phong/diffuse/color")
        if diffuse is not None:
            mat.kind = "diffuse"
            mat.reflectance = _spectrum(diffuse.text)
        # else keep the gray 0.5 default (collada.cpp:923)
    return mat


def _instance_material(doc: _Doc, node_el: ET.Element) -> Optional[MaterialInfo]:
    im = doc.get(
        node_el,
        "instance_geometry/bind_material/technique_common/instance_material")
    if im is None:
        return None
    target = im.get("target")
    if not target:
        raise ValueError("instance_material without target")
    mat_el = doc.by_id.get(target[1:])
    if mat_el is None:
        raise ValueError(f"invalid material id {target[1:]!r}")
    return _parse_material(doc, mat_el)


@stats.span("setup.scene")
def load(path: str) -> SceneInfo:
    """Parse a .dae file into a SceneInfo (reference ColladaParser::load)."""
    tree = ET.parse(path)
    root = tree.getroot()
    if _strip_ns(root.tag) != "COLLADA":
        raise ValueError(f"{path}: not a COLLADA file")
    doc = _Doc(root)

    up_el = doc.get(root, "asset/up_axis")
    if up_el is None:
        raise ValueError("no up direction defined")
    global_xf, up = _up_axis_transform(up_el.text.strip())

    scene_el = doc.get(root, "scene/instance_visual_scene")
    if scene_el is None:
        raise ValueError("no scene description found")

    info = SceneInfo()

    def walk(el: ET.Element, parent_xf: np.ndarray):
        local = _node_local_transform(doc, el)
        world = parent_xf @ local
        for child in doc.children(el, "node"):
            walk(child, world)

        name = el.get("name", "")
        cam_el = doc.get(el, "instance_camera")
        light_el = doc.get(el, "instance_light")
        geo_el = doc.get(el, "instance_geometry")
        if cam_el is not None:
            info.nodes.append(Node(world, _parse_camera(doc, cam_el, up), name))
        elif light_el is not None:
            info.nodes.append(Node(world, _parse_light(doc, light_el), name))
        elif geo_el is not None:
            # mesh data wins; else a CGL <extra> marks a sphere
            # (collada.cpp:365-425)
            if doc.child(geo_el, "mesh") is not None:
                pm = _parse_polymesh(doc, geo_el)
                pm.material = _instance_material(doc, el)
                info.nodes.append(Node(world, pm, name))
            elif doc.child(geo_el, "extra") is not None:
                sp = _parse_sphere(doc, geo_el)
                sp.material = _instance_material(doc, el)
                info.nodes.append(Node(world, sp, name))

    for node_el in doc.children(scene_el, "node"):
        walk(node_el, global_xf)

    return info
