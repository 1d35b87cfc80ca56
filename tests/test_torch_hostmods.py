"""The port's own host modules against the JAX package's originals.

The port keeps numpy copies of the JAX package's config, stats, COLLADA,
PNG, film, cluster and mesh modules, so that it imports nothing of
`rrt_tpu`. Each copy must give what its original gives on the same
inputs: the same fields and defaults, the same parsed arrays, the same
Morton order, boxes and normals, and the same PNG bytes.
"""
import dataclasses

import numpy as np
import pytest

from rrt_tpu.geometry import clusters as jclusters
from rrt_tpu.io import collada as jcollada
from rrt_tpu.render import film as jfilm
from rrt_tpu.scene import mesh as jmesh
from rrt_tpu.utils import config as jconfig
from rrt_tpu.utils import native as jnative
from rrt_tpu.utils import stats as jstats
from rrt_tpu_torch.geometry import clusters as tclusters
from rrt_tpu_torch.io import collada as tcollada
from rrt_tpu_torch.render import film as tfilm
from rrt_tpu_torch.scene import mesh as tmesh
from rrt_tpu_torch.scenes import CBOX_SPHERES, cbox_dense, uv_sphere_box
from rrt_tpu_torch.utils import config as tconfig
from rrt_tpu_torch.utils import stats as tstats


def jax_scene_info(info):
    """The JAX package's SceneInfo holding the same values as the port's
    `info`: every record rebuilt as the JAX class of the same name."""
    def conv(x):
        if dataclasses.is_dataclass(x):
            cls = getattr(jcollada, type(x).__name__)
            return cls(**{f.name: conv(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x
    return conv(info)


def jax_config(cfg):
    """The JAX package's RenderConfig holding the port config's values."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["black_hole"] = jconfig.BlackHoleConfig(
        **dataclasses.asdict(cfg.black_hole))
    return jconfig.RenderConfig(**kw)


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["RenderConfig", "BlackHoleConfig"])
def test_config_fields_and_defaults_match_jax(name):
    tcls, jcls = getattr(tconfig, name), getattr(jconfig, name)
    tf, jf = _fields(tcls), _fields(jcls)
    assert [n for n, _ in tf] == [n for n, _ in jf]
    for (n, tv), (_, jv) in zip(tf, jf):
        if name == "RenderConfig" and n == "black_hole":
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        else:
            assert tv == jv, n
    assert {k: v for k, v in vars(tconfig.Illum).items()
            if not k.startswith("_")} == {
        k: v for k, v in vars(jconfig.Illum).items() if not k.startswith("_")}
    cfg = tconfig.RenderConfig(width=8, seed=3).replace(ns_aa=4)
    assert dataclasses.asdict(jax_config(cfg)) == dataclasses.asdict(cfg)


def _same(a, b, where):
    """Two parsed records hold equal values, field by field."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_collada_parse_matches_jax():
    t, j = tcollada.load(CBOX_SPHERES), jcollada.load(CBOX_SPHERES)
    assert len(t.nodes) == len(j.nodes) > 0
    _same(t, j, "scene")
    assert len(t.find(tcollada.SphereInfo)) == 2


def test_collada_long_arrays_match_jax(tmp_path):
    """Number lists longer than 4096 characters, which the JAX package
    hands to its native parser, parse to the same floats and ints."""
    verts, polys = np.random.default_rng(0).normal(size=(2400, 3)), []
    for i in range(0, 2400, 3):
        polys.append([i, i + 1, i + 2])
    src = open(CBOX_SPHERES).read()
    pos = " ".join(repr(float(v)) for v in verts.ravel())
    idx = " ".join(str(i) for p in polys for i in p)
    mesh = (f'<geometry id="big"><mesh><source id="big-pos"><float_array '
            f'id="big-arr" count="{verts.size}">{pos}</float_array></source>'
            f'<vertices id="big-v"><input semantic="POSITION" '
            f'source="#big-pos"/></vertices><triangles count="{len(polys)}">'
            f'<input semantic="VERTEX" source="#big-v" offset="0"/>'
            f'<p>{idx}</p></triangles></mesh></geometry>')
    assert len(pos) > 4096 and len(idx) > 4096
    src = src.replace("</library_geometries>", mesh + "</library_geometries>")
    src = src.replace("</visual_scene>", '<node id="bign" name="bign">'
                      '<instance_geometry url="#big"/></node></visual_scene>')
    path = tmp_path / "big.dae"
    path.write_text(src)
    t, j = tcollada.load(str(path)), jcollada.load(str(path))
    _same(t, j, "scene")
    big = [n for n in t.nodes if n.name == "bign"][0].instance
    np.testing.assert_array_equal(big.vertices, verts)


def _world_triangles(info):
    """(v0, v1, v2) of every mesh triangle in world space, and the meshes'
    (vertices, polygons), through the JAX package's mesh module."""
    tris, meshes = [], []
    for node in info.find(jcollada.PolymeshInfo):
        verts = jmesh.transform_vertices(node.transform, node.instance.vertices)
        idx = jmesh.triangulate(node.instance.polygons)
        meshes.append((verts, node.instance.polygons))
        tris.append(verts[idx])
    t = np.concatenate(tris)
    return t[:, 0], t[:, 1], t[:, 2], meshes


def _same_normals(port, jax_package):
    """The port sums each vertex's faces in the order of the JAX package's
    native library: equal to it bit for bit. Where that library is not
    built, the JAX package sums in another order, equal to a few ulps."""
    if jnative.available():
        np.testing.assert_array_equal(port, jax_package)
    else:
        np.testing.assert_allclose(port, jax_package, rtol=0, atol=1e-15)


@pytest.mark.parametrize("scene", ["cbox_dense", "uv_sphere_box"])
def test_clusters_and_mesh_match_jax(scene):
    info = {"cbox_dense": cbox_dense, "uv_sphere_box": uv_sphere_box}[scene]()
    v0, v1, v2, meshes = _world_triangles(jax_scene_info(info))
    order = tclusters.morton_order(v0, v1, v2)
    np.testing.assert_array_equal(order, jclusters.morton_order(v0, v1, v2))
    np.testing.assert_array_equal(tclusters.morton3(v0),
                                  jclusters.morton3(v0))
    n = len(v0) - len(v0) % 64
    valid = np.arange(n) % 7 != 3
    for cs in (8, 16, 64):
        got = tclusters.cluster_bboxes(v0[order][:n], v1[order][:n],
                                       v2[order][:n], valid, cs)
        want = jclusters.cluster_bboxes(v0[order][:n], v1[order][:n],
                                        v2[order][:n], valid, cs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for verts, polys in meshes:
        tris = tmesh.triangulate(polys)
        np.testing.assert_array_equal(tris, jmesh.triangulate(polys))
        _same_normals(tmesh.vertex_normals(verts, tris),
                      jmesh.vertex_normals(verts, tris))
        _same_normals(tmesh.reference_vertex_normals(verts, polys),
                      jmesh.reference_vertex_normals(verts, polys))
        xf = np.diag([2.0, 1.0, 0.5, 1.0])
        xf[:3, 3] = (0.1, -0.2, 0.3)
        np.testing.assert_array_equal(tmesh.transform_vertices(xf, verts),
                                      jmesh.transform_vertices(xf, verts))


def test_film_png_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    hdr = rng.gamma(0.5, 0.3, (12, 17, 3))
    count = rng.integers(0, 9, (12, 17))
    for name in ("save_image", "save_sampling_rate_image"):
        args = (hdr,) if name == "save_image" else (count, 8)
        getattr(tfilm, name)(str(tmp_path / "t.png"), *args)
        getattr(jfilm, name)(str(tmp_path / "j.png"), *args)
        assert (tmp_path / "t.png").read_bytes() \
            == (tmp_path / "j.png").read_bytes(), name
    np.testing.assert_array_equal(tfilm.tonemap(hdr), jfilm.tonemap(hdr))
    from rrt_tpu.io.png import read_png as jread
    from rrt_tpu_torch.io.png import read_png as tread
    np.testing.assert_array_equal(tread(str(tmp_path / "t.png")),
                                  jread(str(tmp_path / "t.png")))


@pytest.mark.parametrize("illum", [0, 1, 2, 3])
def test_stats_match_jax(illum):
    assert [f.name for f in dataclasses.fields(tstats.RenderStats)] == \
        [f.name for f in dataclasses.fields(jstats.RenderStats)]
    cfg = tconfig.RenderConfig(illum=illum, max_ray_depth=5,
                               ns_area_light=4)
    t = tstats.expected_stats(cfg, 4, 256 * 256 * 16)
    j = jstats.expected_stats(jax_config(cfg), 4, 256 * 256 * 16)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.geodesic_segments_max == 63
    t.wall_seconds = j.wall_seconds = 0.25
    t.measured_isect_tests = j.measured_isect_tests = 1e6
    assert t.report() == j.report()
    flat = cfg.replace(black_hole=tconfig.BlackHoleConfig(enabled=False))
    assert tstats.expected_stats(flat, 1, 10).geodesic_segments_max == 0
