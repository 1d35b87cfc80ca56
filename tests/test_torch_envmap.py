"""The port's environment light (`scene.envmap`, `io.exr`, the light row,
miss radiance and `-e`) against the JAX package's.

The map is a seeded lat-long sky: a vertical gradient, a small bright sun
disk (so that importance sampling matters) and one black row (a zero
marginal). Uniforms are the JAX package's own draws, handed to the port.
"""
import os
import struct
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rrt_tpu import types as jt
from rrt_tpu.io import exr as jexr
from rrt_tpu.render import lights as jlights
from rrt_tpu.render.renderer import Renderer as JaxRenderer
from rrt_tpu.scene import envmap as jenvmap
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu_torch import cli
from rrt_tpu_torch import types as tt
from rrt_tpu_torch.io import exr as texr
from rrt_tpu_torch.io.png import read_png
from rrt_tpu_torch.render import lights as tlights
from rrt_tpu_torch.render.renderer import Renderer
from rrt_tpu_torch.scene import envmap as tenvmap
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.types import LIGHT_ENV
from rrt_tpu_torch.utils.config import Illum, RenderConfig
from test_torch_hostmods import jax_config
from test_torch_render import _jax_accumulators, _mean_and_sigma


def sky(h=16, w=32, seed=0, sun=True):
    """(h, w, 3) float32: a sky gradient, a sun disk, a black row."""
    rng = np.random.default_rng(seed)
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    img = np.empty((h, w, 3))
    img[...] = (0.2 + 0.8 * np.cos(theta / 2) ** 2)[:, None, None] \
        * np.array([0.4, 0.6, 1.0])
    img *= 1.0 + 0.05 * rng.random((h, w, 1))
    sun_t, sun_p = theta[h // 4], phi[w // 3]
    near = (np.abs(theta[:, None] - sun_t) < np.pi / h) \
        & (np.abs(phi[None, :] - sun_p) < 2 * np.pi / w)
    if sun:
        img[near] = [60.0, 55.0, 40.0]
    img[h - 2] = 0.0
    return img.astype(np.float32)


def _maps(data=None):
    data = sky() if data is None else data
    return jenvmap.build_envmap(data), tenvmap.build_envmap(data, "cpu")


def test_tables_and_debug_image_match_jax():
    jenv, tenv = _maps()
    for f in ("data", "pdf", "cond_cdf", "marg_cdf"):
        np.testing.assert_array_equal(getattr(tenv, f).numpy(),
                                      np.asarray(getattr(jenv, f)), f)
    np.testing.assert_array_equal(tenvmap.probability_debug_image(tenv),
                                  jenvmap.probability_debug_image(jenv))


def _dirs(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v[:4] = [[0, 1, 0], [0, -1, 0], [-1, 0, 0], [-1, 0, 1e-9]]  # poles, seam
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_sample_dir_matches_jax():
    """Radiance to rtol 1e-5 on >= 99.9% of directions: XLA's and
    PyTorch's acos and atan2 may put a lane on the other side of a
    rounding boundary of the bilinear lookup. The map here has no sun: at
    its edge (a 120× step within a pixel) an ulp of φ moves the dim side's
    value by ~1e-4 relative."""
    jenv, tenv = _maps(sky(sun=False))
    d = _dirs(20000, 1)
    j = np.asarray(jenvmap.sample_dir(jenv, jnp.asarray(d)))
    t = tenvmap.sample_dir(tenv, torch.tensor(d)).numpy()
    close = np.isclose(t, j, rtol=1e-5, atol=1e-6).all(-1)
    assert close.mean() >= 0.999, close.mean()
    _, sunny = _maps()
    assert np.isfinite(tenvmap.sample_dir(sunny, torch.tensor(d))).all()


def test_upper_bound_is_exact_at_ties():
    """Uniforms exactly equal to CDF entries (the marginal's and each
    row's), and 0 and the largest float below 1: the search counts
    the entries <= ξ, as the JAX package's sum does."""
    _, tenv = _maps()
    marg, cond = tenv.marg_cdf.numpy(), tenv.cond_cdf.numpy()
    xi1 = np.concatenate([marg, [0.0, np.nextafter(np.float32(1), 0)],
                          np.random.default_rng(2).random(500)]
                         ).astype(np.float32)
    got = tenvmap.upper_bound(tenv.marg_cdf, torch.tensor(xi1))
    np.testing.assert_array_equal(got.numpy(),
                                  (marg[None, :] <= xi1[:, None]).sum(-1))
    rows = np.repeat(np.arange(cond.shape[0]), cond.shape[1])
    xi0 = cond.reshape(-1)
    got = tenvmap.upper_bound(tenv.cond_cdf, torch.tensor(xi0),
                              row=torch.tensor(rows))
    np.testing.assert_array_equal(
        got.numpy(), (cond[rows] <= xi0[:, None]).sum(-1))


def test_sample_L_matches_jax_with_handed_uniforms():
    """Importance sampling: the JAX package's draws from a key, and the
    same uniforms with ties to the CDF entries mixed in; indices exact,
    wi, pdf and radiance to rtol 1e-6."""
    jenv, tenv = _maps()
    n = 4000
    key = jax.random.key(3)
    jr, jwi, jdist, jpdf = jenvmap.sample_L(jenv, key, (n,))
    xi = np.asarray(jax.random.uniform(key, (n, 2), jnp.float32))
    tr, twi, tdist, tpdf = tenvmap.sample_L(tenv, torch.tensor(xi))
    for a, b in ((tr, jr), (twi, jwi), (tpdf, jpdf)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert np.isinf(tdist.numpy()).all() and np.isinf(np.asarray(jdist)).all()

    # ties: ξ₁ on every marginal entry, ξ₀ on an entry of the row it picks
    marg, cond = tenv.marg_cdf.numpy(), tenv.cond_cdf.numpy()
    y = np.clip((marg[None, :] <= marg[:, None]).sum(-1), 0, len(marg) - 1)
    xi = np.stack([cond[y, np.arange(len(marg)) % cond.shape[1]], marg], -1)
    _, twi, _, tpdf = tenvmap.sample_L(tenv, torch.tensor(xi))
    x = np.clip((cond[y] <= xi[:, :1]).sum(-1), 0, cond.shape[1] - 1)
    h, w = cond.shape
    theta, phi = y / h * np.pi, x / w * 2 * np.pi
    want = np.stack([np.cos(phi - np.pi) * np.sin(theta), np.cos(theta),
                     -np.sin(phi - np.pi) * np.sin(theta)], -1)
    np.testing.assert_allclose(twi.numpy(), want, rtol=1e-5, atol=1e-6)
    pdf = tenv.pdf.numpy()[y, x] * w * h / (
        2 * np.pi ** 2 * np.maximum(np.sin(theta), 1e-8))
    np.testing.assert_allclose(tpdf.numpy(), pdf, rtol=1e-5)


def _env_lights():
    kh = (LIGHT_ENV,)
    z3 = np.zeros((1, 3), np.float32)
    rows = dict(kind=np.array(kh, np.int32), radiance=z3, position=z3,
                direction=z3, dim_x=z3, dim_y=z3,
                area=np.zeros(1, np.float32))
    return (jt.LightTable(**{k: jnp.asarray(v) for k, v in rows.items()},
                          kind_host=kh),
            tt.LightTable(**{k: torch.tensor(v) for k, v in rows.items()},
                          kind_host=kh))


@pytest.mark.parametrize("importance", [True, False],
                         ids=["importance", "uniform-sphere"])
def test_env_light_sample_matches_jax(importance):
    """The light row's sample_L: importance-sampled from the map, or
    uniform over the sphere (pdf 1/4π) with ξ₀ → z, ξ₁ → φ, as the JAX
    package's two split keys."""
    jenv, tenv = _maps()
    jl, tl = _env_lights()
    n = 3000
    p = np.random.default_rng(6).uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    key = jax.random.key(9)
    js = jlights.sample_light(jl, 0, jnp.asarray(p), key, jenv,
                              env_importance=importance)
    if importance:
        xi = np.asarray(jax.random.uniform(key, (n, 2), jnp.float32))
    else:
        k1, k2 = jax.random.split(key)
        xi = np.stack([np.asarray(jax.random.uniform(k, (n,), jnp.float32))
                       for k in (k1, k2)], -1)
    ts = tlights.sample_light(tl, 0, torch.tensor(p), torch.tensor(xi),
                              tenv, env_importance=importance)
    for f in ("wi", "dist", "pdf") + (("radiance",) if importance else ()):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    if not importance:    # looked up along wi: sample_dir's rule
        close = np.isclose(ts.radiance.numpy(), np.asarray(js.radiance),
                           rtol=1e-5, atol=1e-6).all(-1)
        assert close.mean() >= 0.999, close.mean()
    assert not tlights.is_delta_light(tl, 0)
    with pytest.raises(ValueError, match="EnvMap"):
        tlights.sample_light(tl, 0, torch.tensor(p), torch.tensor(xi))


def test_exr_round_trip_and_jax_file(tmp_path):
    rgb = sky(9, 13)
    texr.write_exr(str(tmp_path / "t.exr"), rgb)
    np.testing.assert_array_equal(texr.read_exr(str(tmp_path / "t.exr")), rgb)
    jexr.write_exr(str(tmp_path / "j.exr"), rgb)
    assert (tmp_path / "j.exr").read_bytes() \
        == (tmp_path / "t.exr").read_bytes()
    np.testing.assert_array_equal(texr.read_exr(str(tmp_path / "j.exr")), rgb)
    with pytest.raises(ValueError, match="not an EXR"):
        texr.read_exr(__file__)


def _zip_exr(path, rgb, comp, half):
    """A scanline EXR with ZIPS (2, one line a block) or ZIP (3, sixteen)
    compression and HALF or FLOAT channels: bytes interleaved by halves,
    delta-predicted, then deflated (the OpenEXR spec's zip filter)."""
    h, w = rgb.shape[:2]
    ptype, dt = (1, np.float16) if half else (2, np.float32)

    def attr(name, typ, payload):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<I", len(payload)) + payload)
    chans = b"".join(c.encode() + b"\0" + struct.pack("<I12x", ptype)
                     for c in "BGR") + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (attr("channels", "chlist", chans)
              + attr("compression", "compression", bytes([comp]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0") + b"\0")
    lines = 1 if comp == 2 else 16
    blocks = []
    for y0 in range(0, h, lines):
        raw = b"".join(rgb[y, :, c].astype(dt).tobytes()
                       for y in range(y0, min(y0 + lines, h))
                       for c in (2, 1, 0))
        b = np.frombuffer(raw, np.uint8)
        t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
        stored = np.concatenate([t[:1], (t[1:] - t[:-1] + 128) % 256])
        blocks.append((y0, zlib.compress(stored.astype(np.uint8).tobytes())))
    head = struct.pack("<ii", 20000630, 2) + header
    pos = len(head) + 8 * len(blocks)
    offsets, body = [], b""
    for y0, data in blocks:
        offsets.append(pos + len(body))
        body += struct.pack("<iI", y0, len(data)) + data
    with open(path, "wb") as f:
        f.write(head + struct.pack(f"<{len(blocks)}Q", *offsets) + body)


@pytest.mark.parametrize("comp,half", [(2, True), (3, False), (3, True)],
                         ids=["zips-half", "zip-float", "zip-half"])
def test_exr_zip_files_decode_as_jax(tmp_path, comp, half):
    rgb = sky(37, 21, seed=5)
    path = str(tmp_path / "z.exr")
    _zip_exr(path, rgb, comp, half)
    t = texr.read_exr(path)
    np.testing.assert_array_equal(t, jexr.read_exr(path))
    want = rgb.astype(np.float16).astype(np.float32) if half else rgb
    np.testing.assert_array_equal(t, want)


def _scenes(data):
    jenv = jenvmap.build_envmap(data)
    js, jcam = jax_load_scene(CBOX_SPHERES, 256, 256, env=jenv)
    ts, tcam = load_scene(CBOX_SPHERES, "cpu", 256, 256,
                          env=tenvmap.build_envmap(data, "cpu"))
    assert ts.lights.kind_host == js.lights.kind_host
    assert ts.lights.kind_host[-1] == LIGHT_ENV
    return js, jcam, ts, tcam


def test_env_lit_normal_render_matches_jax():
    """Curved Illum.NORMAL at 32×32: hits shade by normal, misses take the
    map along the camera ray's original direction; pixel by pixel."""
    js, jcam, ts, tcam = _scenes(sky())
    cfg = RenderConfig(width=32, height=32, ns_aa=1, illum=Illum.NORMAL,
                       max_dispatch_seconds=0)
    jimg, _ = JaxRenderer(js, jcam, jax_config(cfg)).render()
    timg, _ = Renderer(ts, tcam, cfg, "cpu").render()
    close = np.isclose(timg, jimg, atol=1e-4).all(-1).mean()
    assert close >= 0.995, close
    plain, _ = Renderer(load_scene(CBOX_SPHERES, "cpu", 256, 256)[0], tcam,
                        cfg, "cpu").render()
    miss = (plain == 0).all(-1)
    assert miss.any() and (timg[miss] > 0).all()


def test_env_lit_global_illumination_matches_jax():
    """Illum.FULL at 16×16, 8 spp, -l 1, -m 3 with the env light: the
    image-mean luminances differ by at most 4σ."""
    js, jcam, ts, tcam = _scenes(sky())
    cfg = RenderConfig(width=16, height=16, ns_aa=8, ns_area_light=1,
                       max_ray_depth=3, illum=Illum.FULL, seed=3,
                       max_dispatch_seconds=0)
    jm, jsig = _mean_and_sigma(_jax_accumulators(js, jcam, cfg))
    r = Renderer(ts, tcam, cfg, "cpu")
    hdr, _ = r.render()
    tm, tsig = _mean_and_sigma(r.last_accumulators)
    assert np.isfinite(hdr).all() and tm > 0
    assert abs(tm - jm) <= 4 * np.hypot(tsig, jsig), (tm, jm, tsig, jsig)


def test_cli_env_flag(tmp_path, monkeypatch):
    """-e reads the EXR, builds the map, writes probability_debug.png into
    the working directory, and lights the render."""
    monkeypatch.chdir(tmp_path)
    texr.write_exr("sky.exr", sky())
    r = cli.main(["-f", "out.png", "-r", "8", "8", "-s", "1", "-e",
                  "sky.exr", "--device", "cpu", CBOX_SPHERES])
    assert read_png("out.png").shape == (8, 8, 4)
    dbg = read_png("probability_debug.png")
    assert dbg.shape == (16, 32, 4)
    assert r.scene.env is not None
    assert r.scene.lights.kind_host[-1] == LIGHT_ENV
    assert os.path.exists("out_rate.png")
