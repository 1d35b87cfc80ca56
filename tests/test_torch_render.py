"""Renders of the PyTorch port against the JAX package, and its CLI.

Both packages load the in-repo Cornell box with the reference camera of a
256×256 frame (28° FoV, the main path's view) and render a smaller frame
through it, with the default black hole on.
"""
import json
import os
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rrt_tpu.io.png import read_png
from rrt_tpu.render.renderer import Renderer as JaxRenderer
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu_torch import cli
from rrt_tpu_torch.geometry import trace as ttrace
from rrt_tpu_torch.render import renderer as renderer_mod
from rrt_tpu_torch.render.renderer import Renderer
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.utils.config import BlackHoleConfig, Illum, RenderConfig
from rrt_tpu_torch.utils.profile import profile_render
from test_torch_hostmods import jax_config


def _scenes():
    js, jcam = jax_load_scene(CBOX_SPHERES, 256, 256)
    ts, tcam = load_scene(CBOX_SPHERES, "cpu", 256, 256)
    return js, jcam, ts, tcam


def _jax_accumulators(scene, cam, cfg):
    """The JAX renderer's pass loop (Renderer.render) with its
    accumulators (radiance sum, s1, s2, count, done) returned."""
    r = JaxRenderer(scene, cam, jax_config(cfg))
    w, h = cfg.width, cfg.height
    n = w * h
    k, band_rows, n_bands = r._dispatch_plan(n, w, h)
    assert n_bands == 1
    zero = (np.zeros((n, 3), np.float32), np.zeros(n, np.float32),
            np.zeros(n, np.float32), np.zeros(n, np.int32), np.zeros(n, bool))
    acc = r._split_bands(zero, (0, 0, w, h), band_rows, 1)[0]
    fn = r._pass_fn(k, w, band_rows)
    base = jax.random.key(cfg.seed)
    s = 0
    while s < cfg.ns_aa:
        ks = min(k, cfg.ns_aa - s)
        key = jax.random.fold_in(jax.random.fold_in(base, s), 0)
        acc, _ = fn(acc, key, jnp.asarray(s, jnp.int32),
                    jnp.asarray(ks, jnp.int32), jnp.zeros(2, jnp.int32))
        s += ks
    return [np.asarray(a) for a in acc]


def test_normal_shading_matches_jax():
    """Illum.NORMAL at 1 spp traces centred, deterministic camera rays:
    the two images agree pixel by pixel, up to the chaotic lanes."""
    js, jcam, ts, tcam = _scenes()
    cfg = RenderConfig(width=32, height=32, ns_aa=1, illum=Illum.NORMAL,
                       max_dispatch_seconds=0)
    jimg, _ = JaxRenderer(js, jcam, jax_config(cfg)).render()
    r = Renderer(ts, tcam, cfg, "cpu")
    timg, count = r.render()
    assert (count == 1).all()
    assert (timg.sum(-1) > 0).mean() > 0.5       # the box fills the view
    close = np.isclose(timg, jimg, atol=1e-4).all(-1).mean()
    assert close >= 0.995, close
    np.testing.assert_array_equal(r.render()[0], timg)   # deterministic
    assert r.last_trace_calls == 1


def _mean_and_sigma(acc):
    """Image-mean luminance and its standard error, from the per-pixel
    luminance sums s1, s2 over n samples."""
    _, s1, s2, count, _ = acc
    n = count.astype(np.float64)
    mean_px = s1 / n
    var_px = (s2 - s1 * mean_px) / (n - 1)
    return mean_px.mean(), np.sqrt((var_px / n).sum()) / len(n)


def test_global_illumination_matches_jax():
    """Illum.FULL at 24×24, 8 spp, -l 1, -m 3: the image-mean luminances
    of the two packages differ by at most 4σ. Both draw the same uniforms
    from the seed; in curved space a few flipped shadow rays still move
    the mean by more than the per-pixel rule's 1e-3, so the mean is held
    statistically (tests/test_torch_curved_parity.py holds this render's
    paths and a 1-spp render pixel by pixel)."""
    js, jcam, ts, tcam = _scenes()
    cfg = RenderConfig(width=24, height=24, ns_aa=8, ns_area_light=1,
                       max_ray_depth=3, illum=Illum.FULL, seed=3,
                       max_dispatch_seconds=0)
    jm, jsig = _mean_and_sigma(_jax_accumulators(js, jcam, cfg))
    r = Renderer(ts, tcam, cfg, "cpu")
    hdr, count = r.render()
    tm, tsig = _mean_and_sigma(r.last_accumulators)
    assert np.isfinite(hdr).all() and (count == 8).all()
    assert tm > 0 and jm > 0
    assert abs(tm - jm) <= 4 * np.hypot(tsig, jsig), (tm, jm, tsig, jsig)
    # one pass: camera + 2 bounces, 3 shadow queries of one chunk each
    assert r.last_trace_calls == 6
    st = r.stats()
    assert st.camera_rays == 24 * 24 * 8
    assert st.measured_isect_tests > 0 and st.geodesic_segments_max == 63


def test_cli_without_cuda_refuses(tmp_path, monkeypatch, capsys):
    """The CLI renders on cuda unless told otherwise: with no card it
    exits with an error instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "x.png")
    with pytest.raises(SystemExit) as e:
        cli.main(["-f", out, "-r", "8", "8", CBOX_SPHERES])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not os.path.exists(out)


def test_render_builds_tables_once(monkeypatch):
    """A render builds the traversal's tables once, in Renderer, and every
    trace of every pass reuses them."""
    built = []
    for mod in (renderer_mod, ttrace):
        real = mod.build_tables
        monkeypatch.setattr(mod, "build_tables",
                            lambda *a, real=real: built.append(1) or real(*a))
    r = _flat_renderer(ns_aa=2, ns_area_light=1, max_ray_depth=3, seed=2)
    r.render()
    r.render()
    assert r.last_trace_calls == 1 + 3 + 2 and len(built) == 1


def test_cli_accepts_every_flag_of_the_jax_cli():
    """Every option of `rrt_tpu.cli` exists in the port's CLI, with the
    same number of arguments; the port adds --device."""
    from rrt_tpu.cli import build_argparser as jax_argparser
    ours = {o: a for a in cli.build_argparser()._actions
            for o in a.option_strings}
    theirs = {o: a for a in jax_argparser()._actions
              for o in a.option_strings}
    assert set(ours) - set(theirs) == {"--device"}
    for flag, action in theirs.items():
        assert (ours[flag].nargs, ours[flag].dest, ours[flag].default,
                ours[flag].const) == (action.nargs, action.dest,
                                      action.default, action.const), flag


def test_cli_writes_png(tmp_path):
    out = str(tmp_path / "cbox.png")
    r = cli.main(["-f", out, "-r", "16", "16", "-s", "1", "--device", "cpu",
                  CBOX_SPHERES])
    img = read_png(out)
    assert img.shape == (16, 16, 4)
    assert os.path.exists(str(tmp_path / "cbox_rate.png"))
    assert r.samples_done == 1


@pytest.mark.parametrize("flag", [["-p", "0", "0", "4", "4"],
                                  ["--checkpoint", "c.npz"], ["--serve", "0"],
                                  ["--dump-rays", "r"]])
def test_cli_refuses_unported_flags(flag, tmp_path, monkeypatch):
    """The flags that the port once refused as not yet ported now run on a
    16×16 CPU render and leave their output: the cell image, the
    checkpoint, a status served over HTTP during the render, the ray
    log."""
    from rrt_tpu_torch.utils.serve import PreviewServer
    monkeypatch.chdir(tmp_path)
    served = []
    if flag[0] == "--serve":
        real = PreviewServer.update

        def update(self, *a, **kw):
            real(self, *a, **kw)
            url = f"http://127.0.0.1:{self.port}/status.json"
            with urllib.request.urlopen(url, timeout=10) as r:
                served.append(json.loads(r.read()))
        monkeypatch.setattr(PreviewServer, "update", update)
    extra = {"-p": ["--illum", "0"], "--checkpoint": ["-s", "8"]}.get(
        flag[0], [])
    r = cli.main(["-f", "o.png", "-r", "16", "16", "--device", "cpu"]
                 + extra + flag + [CBOX_SPHERES])
    img = read_png("o.png")
    assert img.shape == (16, 16, 4) and os.path.exists("o_rate.png")
    if flag[0] == "-p":
        # the cell is rows 0-3 from the bottom: the PNG's last four rows
        assert r.last_sample_count.shape == (4, 4)
        assert img[12:, :4, :3].max() > 0 and img[:12, :, :3].max() == 0
    elif flag[0] == "--checkpoint":
        with np.load("c.npz") as z:
            assert int(z["s"]) == 8 and z["rad_sum"].shape == (256, 3)
    elif flag[0] == "--serve":
        assert served[0]["samples"] == 0 and served[-1] == {
            "samples": 1, "total": 1, "done": True,
            "accel": {"level": "root", "index": 0, "tri_rows": [0, 64],
                      "depth": 1}}
        assert os.path.getsize("o.png.preview.png") > 0
    else:
        with np.load("r_raylog.npz") as z:
            assert z["outcome"].shape == (16, 16)


def _flat_renderer(**kw):
    """A small flat-spacetime render of the Cornell box on the CPU."""
    ts, tcam = load_scene(CBOX_SPHERES, "cpu", 256, 256)
    cfg = RenderConfig(width=16, height=16,
                       black_hole=BlackHoleConfig(enabled=False), **kw)
    return Renderer(ts, tcam, cfg, "cpu")


def test_adaptive_sampling_stops_early():
    r = _flat_renderer(ns_aa=32, ns_area_light=1, max_ray_depth=1,
                       adaptive=True, samples_per_batch=8, max_tolerance=0.5,
                       seed=7)
    hdr, count = r.render()
    assert np.isfinite(hdr).all()
    assert count.min() >= 8 and (count % 8 == 0).all()
    assert (count < 32).mean() > 0.5


@pytest.mark.parametrize("illum,hemi", [(Illum.DIRECT, False),
                                        (Illum.INDIRECT, False),
                                        (Illum.FULL, True)],
                         ids=["direct", "indirect", "hemisphere"])
def test_illumination_modes(illum, hemi):
    """Every integrator mode renders a finite image, and the trace calls
    follow the mode: one camera query, then per vertex one shadow
    query (skipped at the first vertex when indirect) and one bounce."""
    r = _flat_renderer(ns_aa=4, ns_area_light=2, max_ray_depth=3,
                       illum=illum, direct_hemisphere_sample=hemi, seed=1)
    hdr, _ = r.render()
    assert np.isfinite(hdr).all()
    # hemisphere sampling only picks up emissive surfaces, and the box's
    # light is an area light, not geometry: the reference renders black
    assert (hdr == 0).all() if hemi else hdr.mean() > 0
    expected = {Illum.DIRECT: 2, Illum.INDIRECT: 1 + 2 + 2,
                Illum.FULL: 1 + 3 + 2}[illum]
    assert r.last_trace_calls == expected
    st = r.stats()
    if illum == Illum.INDIRECT:
        assert st.shadow_rays == 16 * 16 * 4 * 2 * 2


def test_thin_lens_cli(tmp_path):
    out = str(tmp_path / "lens.png")
    r = cli.main(["-f", out, "-r", "8", "8", "-s", "2", "--flat",
                  "--thin-lens", "-b", "0.1", "-d", "4.0", "--device", "cpu",
                  CBOX_SPHERES])
    assert r.camera.lens_radius == 0.1 and r.camera.focal_distance == 4.0
    assert read_png(out).shape == (8, 8, 4)


def test_profile_needs_a_card():
    """The render profile reads device events: a CPU renderer is refused."""
    with pytest.raises(ValueError, match="CUDA renderer"):
        profile_render(_flat_renderer(ns_aa=1))
