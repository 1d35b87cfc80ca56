"""Per-pixel parity of the port's renders with the JAX package's on the
CPU, in flat spacetime (`--flat`).

Both packages load the in-repo Cornell box with the reference camera of
a 256×256 frame and render 24×24 through it. One seed gives both the same
uniforms: the port splits the JAX package's threefry keys as the JAX
package splits them and draws their bits (`rrt_tpu_torch.utils.prng`),
so the pixels differ only through float arithmetic (ROADMAP's standing
differences: XLA contracts multiply-adds on the CPU, the port does not;
flat hit points agree to ~6e-5). The JAX package renders with one row
band (`max_dispatch_seconds=0`), so its pass keys are fold_in(fold_in(
key(seed), s), 0), as the port's.

The rule: at least 99% of the pixels within atol 1e-4 + rtol 1e-3 of the
JAX package's, the image means within 1e-3 relative, and the same
sample count in every pixel. A fault in a BSDF lobe, a light's weight or
a pdf moves a pixel by far more than that. The pixels that miss it are
those where one of the pixel's shadow rays, leaving from a hit point
that differs at ~1e-5, grazes an occluder's edge and is occluded in one
package and not in the other (seen lane by lane on the direct render:
every differing lane was such a flip). Each flip takes a share of a
pixel's samples, so the share of pixels within the rule falls with the
samples and shadow rays a pixel holds: at 8 spp and two light samples
98.8% of the direct render's pixels hold it, at 2 spp 99.65%.
tests/test_torch_curved_parity.py holds the curved renders.
"""
import numpy as np
import pytest

from rrt_tpu.render.renderer import Renderer as JaxRenderer
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu_torch import convert
from rrt_tpu_torch.render.renderer import Renderer
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.utils.config import BlackHoleConfig, Illum, RenderConfig
from test_torch_diff import _emissive
from test_torch_hostmods import jax_config

ATOL, RTOL = 1e-4, 1e-3       # a pixel's rule
SHARE = 0.99                  # of the pixels
MEAN_RTOL = 1e-3              # the image means

FLAT = BlackHoleConfig(enabled=False)


def _cfg(**kw):
    return RenderConfig(**dict(dict(
        width=24, height=24, ns_aa=2, ns_area_light=2, max_ray_depth=3,
        illum=Illum.FULL, seed=3, max_dispatch_seconds=0, black_hole=FLAT),
        **kw))


def renders(cfg, region=None, emissive=False):
    """(JAX image, JAX counts, port image, port counts) of one config on
    the box, the ceiling made emissive with `emissive`."""
    js, jcam = jax_load_scene(CBOX_SPHERES, 256, 256)
    if emissive:
        js, _ = _emissive(js)
    ts = convert.scene_from_arrays(convert.to_arrays(js), "cpu")
    _, tcam = load_scene(CBOX_SPHERES, "cpu", 256, 256)
    jimg, jcount = JaxRenderer(js, jcam, jax_config(cfg)).render(
        region=region)
    timg, tcount = Renderer(ts, tcam, cfg, "cpu").render(region=region)
    return np.asarray(jimg), np.asarray(jcount), timg, tcount


def hold(jimg, timg, share=SHARE, mean_rtol=MEAN_RTOL, **tol):
    """The share of pixels within `tol` (ATOL, RTOL by default) and the
    image means' relative difference, each held to its limit; returns
    the share."""
    tol = tol or dict(atol=ATOL, rtol=RTOL)
    close = np.isclose(timg, jimg, **tol).all(-1).mean()
    assert close >= share, close
    if mean_rtol is not None:
        assert abs(timg.mean() / jimg.mean() - 1) <= mean_rtol, (
            timg.mean(), jimg.mean())
    assert np.isfinite(timg).all() and timg.mean() > 0
    return close


MODES = {
    # the four --illum modes at 2 spp, -l 2, -m 3 (found: 100%, 99.65%,
    # 100%, 100% of the pixels)
    "normal": dict(illum=Illum.NORMAL),
    "direct": dict(illum=Illum.DIRECT),
    "indirect": dict(illum=Illum.INDIRECT),
    "full": dict(),
    # -H: hemisphere directions see emissive geometry only, so the
    # ceiling is made emissive; direct and global illumination (found:
    # 100% and 100%)
    "hemisphere direct": dict(illum=Illum.DIRECT,
                              direct_hemisphere_sample=True),
    "hemisphere full": dict(direct_hemisphere_sample=True),
    # the main path's -l 4 -m 5 (found: 99.83%)
    "main path settings": dict(ns_area_light=4, max_ray_depth=5),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_flat_render_matches_jax_per_pixel(mode):
    """Every --illum mode, -H, and the main path's light samples and
    depth: the rule, pixel by pixel."""
    kw = MODES[mode]
    jimg, jcount, timg, tcount = renders(
        _cfg(**kw), emissive=kw.get("direct_hemisphere_sample", False))
    assert np.array_equal(tcount, jcount)
    hold(jimg, timg)


def test_flat_tail_pass_matches_jax_per_pixel():
    """3 spp in passes of 2 (`max_pass_lanes`): the tail pass runs the
    pass of 2 with its second sample masked, from the key of sample 2
    (found: 100% of the pixels)."""
    cfg = _cfg(ns_aa=3, max_pass_lanes=2 * 24 * 24)
    jimg, jcount, timg, tcount = renders(cfg)
    assert (tcount == 3).all() and np.array_equal(tcount, jcount)
    hold(jimg, timg)


def test_flat_cell_matches_jax_per_pixel():
    """A `-p 2 2 20 18` cell: its rays and draws are the cell's lanes'
    (found: 100% of its 360 pixels; a 12×10 cell at the same settings
    had 2 of its 120 pixels off, 98.3%: one pixel is 0.83% of it)."""
    jimg, jcount, timg, tcount = renders(_cfg(), region=(2, 2, 20, 18))
    assert timg.shape == (18, 20, 3) and np.array_equal(tcount, jcount)
    hold(jimg, timg)


def test_flat_adaptive_render_matches_jax_per_pixel():
    """Adaptive sampling, 16 spp in batches of 4, tolerance 0.5, -m 1: the
    same pixels freeze at the same batch boundaries, so the sample counts
    agree, and the images hold the rule (found: 99.48% of the pixels). A
    freeze can part at its threshold: at 32 spp in batches of 8, -l 1, one
    pixel of the 576 froze a batch apart in the two packages (seed 3;
    none at seed 7), and 98.8% of the pixels held the rule."""
    cfg = _cfg(ns_aa=16, adaptive=True, samples_per_batch=4,
               max_tolerance=0.5, max_ray_depth=1,
               max_pass_lanes=4 * 24 * 24)
    jimg, jcount, timg, tcount = renders(cfg)
    assert (tcount < 16).mean() > 0.2
    assert np.array_equal(tcount, jcount)
    hold(jimg, timg)
