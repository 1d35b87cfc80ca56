"""The port's host tools against the JAX package and over real HTTP: the
live preview server (`utils/serve.py`), the accel walk over the trace
kernel's own tables (`utils/accel_walk.py`), the accel dump
(`utils/accel_viz.py`), the ray log (`utils/ray_debug.py`), the CLI's
dump flags, `tools/run_config.py` (with the mirror and glass scene of its
config 3) and `tools/kbench.py`."""
import json
import os
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rrt_tpu.render.renderer import make_black_hole as jax_black_hole
from rrt_tpu.scene.build import build_scene as jax_build_scene
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu.utils import accel_viz as jav
from rrt_tpu.utils import accel_walk as jaw
from rrt_tpu.utils import ray_debug as jrd
from rrt_tpu.scene.build import load_scene as jax_load
from rrt_tpu_torch import cli
from rrt_tpu_torch.io.png import read_png
from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.physics.schwarzschild import chaotic_lanes
from rrt_tpu_torch.render import film
from rrt_tpu_torch.render.renderer import Renderer, make_black_hole
from rrt_tpu_torch.scene.build import build_scene, load_scene
from rrt_tpu_torch.scenes import CBOX_MIRROR_GLASS, CBOX_SPHERES, cbox_dense
from rrt_tpu_torch.tools import kbench, run_config, scaling_bench
from rrt_tpu_torch.utils import accel_viz, ray_debug
from rrt_tpu_torch.utils.accel_walk import AccelWalk
from rrt_tpu_torch.utils.config import BlackHoleConfig, RenderConfig
from rrt_tpu_torch.utils.serve import PreviewServer
from test_torch_hostmods import jax_config, jax_scene_info

TIMEOUT = 10      # seconds per HTTP request


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=TIMEOUT) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(base, body: bytes):
    req = urllib.request.Request(base + "/control", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


@pytest.fixture
def server(tmp_path):
    """A PreviewServer on an ephemeral port, stopped after the test."""
    made = []

    def start(png=None, accel=None):
        srv = PreviewServer(str(png or tmp_path / "p.png"), 0,
                            accel=accel).start()
        made.append(srv)
        return srv, f"http://127.0.0.1:{srv.port}"
    yield start
    for srv in made:
        srv.stop()


@pytest.fixture(scope="module")
def dense():
    """cbox_dense built once by both packages, cameras of a 128×128
    frame: (port scene, port camera, JAX scene, JAX camera)."""
    info = cbox_dense()
    scene, cam = build_scene(info, "cpu", 128, 128)
    js, jcam = jax_build_scene(jax_scene_info(info), 128, 128)
    return scene, cam, js, jcam


def test_serve_routes(tmp_path, server):
    png = tmp_path / "p.png"
    srv, base = server(png)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base, "/preview.png")           # no preview yet
    assert e.value.code == 404
    png.write_bytes(b"\x89PNG-fake")
    status, ctype, body = _get(base, "/")
    assert status == 200 and ctype == "text/html"
    assert b"preview.png" in body and b"/control" in body
    assert _get(base, "/preview.png")[2] == b"\x89PNG-fake"
    srv.update(3, 16)
    assert json.loads(_get(base, "/status.json")[2]) == {
        "samples": 3, "total": 16, "done": False}
    for path in ("/nothing", "/accel.png"):       # no walk: 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base, path)
        assert e.value.code == 404
    for body in (b"{not json", b"[1, 2]"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, body)
        assert e.value.code == 400
    req = urllib.request.Request(base + "/elsewhere", data=b"{}",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=TIMEOUT)
    assert e.value.code == 404
    resp = _post(base, json.dumps({"spp_cap": 4, "preview_every": 2,
                                   "bogus": 1}).encode())
    assert resp["ok"] and srv.control == {"spp_cap": 4, "preview_every": 2}


def _flat_cbox(w=24, h=16, spp=16):
    scene, cam = load_scene(CBOX_SPHERES, "cpu", w, h, fov_mode="native")
    cfg = RenderConfig(width=w, height=h, ns_aa=spp, max_ray_depth=1,
                       seed=1, max_pass_lanes=w * h,
                       black_hole=BlackHoleConfig(enabled=False))
    return scene, cam, cfg


def test_serve_control_reaches_a_render(server):
    """POST /control from another thread ends a live render: the spp cap
    at 4 samples, then the stop action on the next render's first pass."""
    srv, base = server()
    scene, cam, cfg = _flat_cbox()
    posted = threading.Event()

    def post_once(s, total):
        if s == 1 and not posted.is_set():
            t = threading.Thread(target=lambda: _post(
                base, json.dumps({"spp_cap": 4}).encode()))
            t.start()
            t.join(TIMEOUT)
            assert not t.is_alive()
            posted.set()

    r = Renderer(scene, cam, cfg, "cpu")
    r.render(control=srv.control, progress=post_once)
    assert posted.is_set() and r.cancelled and r.samples_done == 4
    assert _post(base, json.dumps({"action": "stop"}).encode())["control"][
        "stop"] is True
    srv.control.pop("spp_cap")
    r2 = Renderer(scene, cam, cfg, "cpu")
    r2.render(control=srv.control)
    assert r2.cancelled and r2.samples_done == 1


KEYS = ["up", "left", "left", "right", "left", "right", "right", "right",
        "up", "right", "up", "left", "right", "up", "up", "up"]


def test_accel_walk_matches_jax_walk():
    """The same key sequence walks the same (level, index, triangle rows,
    depth) on the in-repo Cornell box in both packages."""
    js, jcam = jax_load_scene(CBOX_SPHERES, 32, 32)
    ts, tcam = load_scene(CBOX_SPHERES, "cpu", 32, 32)
    jw, tw = jaw.AccelWalk(js, jcam), AccelWalk(ts, tcam)
    seen = []
    for key in KEYS:
        assert tw.key(key) == jw.key(key), key
        assert tw.status() == jw.status(), key
        seen.append(tw.status()["level"])
    assert set(seen) == {"root", "part", "supercluster", "cluster"}
    np.testing.assert_array_equal(tw.render(), jw.render())


def test_accel_walk_counts_are_the_kernel_tables(dense):
    """On cbox_dense (14 parts) every count and box is the trace kernel's
    own; the JAX walk's floor division gives 31 superclusters a part
    where the tables hold 32."""
    scene, cam, js, _ = dense
    tab = tk.build_tables(scene, None)
    w = AccelWalk(scene, cam)
    assert (w.h.n_children(0, 0), w.h.n_children(1, 3),
            w.h.n_children(2, 7), w.h.n_children(3, 9)) == (
        tab.n_parts, tab.spp, tk.SUP, 0) == (14, 32, 8, 0)
    assert jaw.KernelHierarchy(js).n_children(1, 3) == 31
    for level, t in ((1, tab.part), (2, tab.sup), (3, tab.cl)):
        np.testing.assert_array_equal(w.h.boxes(level), t[:, :6].numpy())
    # the walk reaches the last supercluster of the last part
    for key in ["left"] + ["right"] * 13 + ["left"] + ["right"] * 31:
        assert w.key(key)
    assert w.selected == (2, 14 * 32 - 1)
    assert w.status()["tri_rows"] == [scene.n_tris, scene.n_tris]
    assert w.key("left") and w.status()["index"] == (14 * 32 - 1) * 8


def test_accel_overlay_is_the_same_way_up_as_the_preview(tmp_path, server,
                                                         dense):
    """/accel.png with a part of cbox_dense's sphere mesh selected, over a
    preview that shows where the mesh is (written as the renderer writes
    its previews): the edges of the part's triangles fall on the mesh in
    the served preview; flipped upside down (the JAX package's overlay)
    they would not."""
    scene, cam, _, _ = dense
    w_, h_ = cam.screen_w, cam.screen_h
    # the sphere mesh: rows within 0.41 of its centre (scenes.cbox_dense)
    centre = torch.tensor([0.15, 0.4, -0.1])
    on_sphere = (torch.linalg.vector_norm(scene.tri_v0 - centre, dim=1)
                 < 0.41).numpy()
    tab = tk.build_tables(scene, None)
    prim = tk.kernel_trace(scene, tab, accel_viz.pixel_rays(
        cam, w_, h_, "cpu")).prim_id.numpy().reshape(h_, w_)
    mesh = on_sphere[np.clip(prim, 0, scene.n_tris - 1)] & (prim >= 0)
    prev = tmp_path / "prev.png"
    film.save_image(str(prev), np.repeat(mesh[..., None], 3, -1) * 1.0)
    walk = AccelWalk(scene, cam)
    rows = tk.PART_TRIS
    part = next(p for p in range(tab.n_parts)
                if on_sphere[p * rows:(p + 1) * rows].all())
    srv, base = server(prev, walk)
    for key in ["left"] + ["right"] * part:
        assert _post(base, json.dumps({"accel": key}).encode())["moved"]
    assert json.loads(_get(base, "/status.json")[2])["accel"]["index"] \
        == part
    images = {}
    for path in ("/preview.png", "/accel.png"):
        status, ctype, body = _get(base, path)
        assert status == 200 and ctype == "image/png"
        (tmp_path / "got.png").write_bytes(body)
        images[path] = read_png(str(tmp_path / "got.png"))[..., :3]
    shown = images["/preview.png"].max(-1) > 0          # the mesh, top-down
    assert 0.05 < shown.mean() < 0.5
    # the triangle edges, drawn opaque in (0.6, 0.6, 1.0)
    edges = (np.abs(images["/accel.png"].astype(int) - (153, 153, 255))
             <= 1).all(-1)
    assert edges.sum() > 100
    near = shown.copy()                                 # dilate by a pixel
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        near |= np.roll(shown, (dy, dx), axis=(0, 1))
    assert near[edges].mean() > 0.9
    assert near[edges[::-1]].mean() < 0.5


def test_dump_accel_matches_jax(tmp_path, monkeypatch, dense):
    """The JSON and the heatmap equal the JAX package's; the touched
    counts equal its counts in one chunk and with the rays cut into
    chunks of 7."""
    js, jcam = jax_load_scene(CBOX_SPHERES, 256, 256)
    ts, tcam = load_scene(CBOX_SPHERES, "cpu", 256, 256)
    jb, tb = str(tmp_path / "j"), str(tmp_path / "t")
    jc = jav.dump_accel(js, jcam, 16, 12, jb)
    tc = accel_viz.dump_accel(ts, tcam, 16, 12, tb)
    np.testing.assert_array_equal(tc, jc)
    assert json.load(open(tb + "_accel.json")) \
        == json.load(open(jb + "_accel.json"))
    assert open(tb + "_accel.png", "rb").read() \
        == open(jb + "_accel.png", "rb").read()
    td, tdcam, jd, jdcam = dense
    rays = accel_viz.pixel_rays(tdcam, 16, 12, "cpu")
    import jax.numpy as jnp
    jrays = jdcam.generate_rays(jnp.asarray(
        np.stack(np.meshgrid((np.arange(16) + 0.5) / 16,
                             (np.arange(12) + 0.5) / 12), -1)
        .reshape(-1, 2), jnp.float32))
    np.testing.assert_array_equal(np.asarray(jrays.d), rays.d.numpy())
    want = jav.touched_cluster_counts(jd, jrays)
    assert want.max() > 10
    n_clusters = td.cluster_lo.shape[0]
    for chunk in (16 * 12, 7):
        monkeypatch.setattr(accel_viz, "TEMP_BYTES",
                            chunk * 4 * accel_viz._LIVE_TEMPS * n_clusters)
        assert accel_viz.chunk_rays(n_clusters) == chunk
        np.testing.assert_array_equal(
            accel_viz.touched_cluster_counts(td, rays), want)


@pytest.mark.parametrize("curved", [True, False], ids=["curved", "flat"])
def test_ray_log_matches_jax(curved):
    """16×16 camera rays through the main path's view: outcome, winning
    chord, primitive and clusters equal the JAX package's XLA log on calm
    lanes and on ≥ 99.5% of all. In flat mode the JAX package's XLA trace
    reports chord 0 for a miss against its docstring's n_seg (1; the
    Pallas kernel's value), so misses are held to n_seg there."""
    cfg = RenderConfig(width=16, height=16,
                       black_hole=BlackHoleConfig(enabled=curved))
    js, jcam = jax_load_scene(CBOX_SPHERES, 256, 256)
    ts, tcam = load_scene(CBOX_SPHERES, "cpu", 256, 256)
    jbh = jax_black_hole(jax_config(cfg))
    tbh = make_black_hole(cfg, "cpu")
    jlog = jrd.ray_log(js, jbh, jcam, 16, 16, n_seg=63 if curved else 1)
    tlog = ray_debug.ray_log(ts, tbh, tcam, 16, 16)
    rays = accel_viz.pixel_rays(tcam, 16, 16, "cpu")
    calm = (~chaotic_lanes(rays.o, rays.d, tbh, 63)).numpy().reshape(16, 16) \
        if curved else np.ones((16, 16), bool)
    assert calm.mean() > 0.2
    outcomes = np.bincount(tlog["outcome"].ravel(), minlength=3)
    assert outcomes[1] > 0 and outcomes[0] > 0
    assert outcomes[2] > 0 if curved else outcomes[2] == 0
    if not curved:
        miss = tlog["outcome"] == 0
        assert (tlog["win_seg"][miss] == 1).all()
        assert (jlog["win_seg"][miss] == 0).all()
        jlog["win_seg"] = np.where(miss, 1, jlog["win_seg"])
    for key in ("outcome", "win_seg", "marched", "clusters", "prim"):
        assert tlog[key].dtype == jlog[key].dtype, key
        eq = tlog[key] == jlog[key]
        assert eq[calm].all(), key
        assert eq.mean() >= 0.995, (key, eq.mean())


def test_cli_writes_every_dump(tmp_path):
    out = str(tmp_path / "o.png")
    base = str(tmp_path / "d")
    cli.main(["-f", out, "-r", "16", "12", "-s", "1", "--illum", "0",
              "--dump-accel", base, "--dump-rays", base, "--device", "cpu",
              CBOX_SPHERES])
    for suffix in ("_accel.json", "_accel.png", "_raylog.npz",
                   "_raylog_hit.png", "_raylog_cost.png", "_raylog_seg.png"):
        assert os.path.getsize(base + suffix) > 0, suffix
    z = np.load(base + "_raylog.npz")
    assert z["outcome"].shape == (12, 16)
    assert (z["marched"] >= 1).all() and (z["marched"] <= 63).all()
    assert z["clusters"].max() > 0
    assert read_png(base + "_raylog_hit.png").shape == (12, 16, 4)


def _jax_run_config_keys():
    """The keys of the JAX tool's JSON line, read from its source."""
    src = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "run_config.py")).read()
    body = src[src.index("out = {"):]
    body = body[:body.index("}\n")]
    return set(re.findall(r'^\s+"(\w+)":', body, re.M))


def test_run_config_prints_the_jax_keys(capsys):
    keys = _jax_run_config_keys()
    assert {"wall_s", "compile_s", "steady_s", "camera_rays_per_sec",
            "mean_radiance"} <= keys
    assert run_config.main([CBOX_SPHERES, "--size", "8", "8", "--spp", "2",
                            "-m", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert keys <= set(out), keys - set(out)
    assert out["compile_s"] > 0 and out["steady_s"] > 0
    assert out["camera_rays_per_sec"] > 0 and out["mean_radiance"] > 0
    assert out["total_traces"] == 8 * 8 * 2 * (1 + 2 + 1)
    assert out["trace_calls"] == 4 and out["device"] == "cpu"
    assert out["config"] == "8x8 2spp l1 d2 curved"


def test_run_config_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_config.main([CBOX_SPHERES]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert kbench.main(["8"]) == 2
    with pytest.raises(ValueError):
        run_config.run([CBOX_SPHERES, "--backend", "kernel", "--device",
                        "cpu"])


@pytest.mark.parametrize("argv", [[], ["--card"], ["--breakdown"],
                                  ["--card", "--device", "cpu"]])
def test_scaling_bench_refuses_without_a_card(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert scaling_bench.main(argv) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_scaling_bench_spawns_gloo_ranks_on_the_cpu(capsys):
    assert scaling_bench.main(["--size", "8", "--configs", "1x1,2x1",
                               "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "1 proc x 1 dev: 64 lanes" in out and "(gloo on cpu)" in out
    assert re.search(r"^\| 2 \| 2 \| [\d,]+ \| [\d.]+x \|$", out, re.M)


def test_mirror_glass_scene_loads_the_same_in_both_packages():
    """Config 3's scene: a mirror and a glass sphere, read alike by both
    packages' COLLADA readers."""
    js, _ = jax_load(CBOX_MIRROR_GLASS, 32, 32)
    ts, _ = load_scene(CBOX_MIRROR_GLASS, "cpu", 32, 32)
    for f in ("kind", "reflectance", "transmittance", "emission", "ior"):
        np.testing.assert_array_equal(getattr(ts.bsdfs, f).numpy(),
                                      np.asarray(getattr(js.bsdfs, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(ts.sph_bsdf.numpy(), np.asarray(js.sph_bsdf))
    kinds = ts.bsdfs.kind.numpy()[ts.sph_bsdf.numpy()[:2]]
    assert sorted(kinds.tolist()) == [1, 4]       # mirror, glass
    assert np.asarray(js.bsdfs.ior).max() == pytest.approx(1.5)


def test_kbench_prints_both_ray_sets(capsys):
    assert kbench.main(["8", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("scene=cbox_dense tris=28608")
    assert [ln.split(":")[0] for ln in lines[1:10]] == [
        "coherent", "  measured", "  sorted", "incoherent", "  measured",
        "  sorted", "bounce", "  measured", "  sorted"]
    rows = json.loads(lines[-1])["kbench"]
    assert [r["rays"] for r in rows] == ["coherent", "incoherent", "bounce"]
    # the same rays in another lane order: the same hits and tests
    assert rows[0]["hits"] == rows[1]["hits"] > 0
    assert rows[0]["prim_tests_per_ray"] == rows[1]["prim_tests_per_ray"]
    # one bounce from each camera hit; in the lane sort's order every set
    # traces to the same Hit
    assert rows[2]["n"] == rows[0]["hits"]
    assert all(r["sorted_equal"] and r["sort_ms"] > 0 for r in rows)
