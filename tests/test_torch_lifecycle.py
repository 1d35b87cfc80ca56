"""The port's render lifecycle against the JAX package and against itself:
cell renders, checkpoint and resume, cancellation, runtime control and the
progressive preview (rrt_tpu/render/renderer.py; the reference's stop(),
raytrace_cell and update_screen, pathtracer.cpp:180-202, 583-609,
156-178)."""
import os

import numpy as np
import pytest
import torch

from rrt_tpu.render.renderer import Renderer as JaxRenderer
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu_torch.io.png import read_png
from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.render.renderer import Renderer
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.utils.config import BlackHoleConfig, Illum, RenderConfig
from test_torch_hostmods import jax_config

W, H = 48, 36
CELL = (10, 6, 16, 12)


def _cfg(spp=4, **kw):
    # one sample per pass (max_pass_lanes = the frame), so that checkpoints
    # and stops can land between samples
    kw.setdefault("max_pass_lanes", W * H)
    return RenderConfig(width=W, height=H, ns_aa=spp, max_ray_depth=1,
                        illum=kw.pop("illum", Illum.FULL), seed=7,
                        black_hole=BlackHoleConfig(enabled=False), **kw)


def _renderer(spp=4, **kw):
    # the native FoV: the reference's 800x600-then-resize FoV makes a small
    # frame see (and light) little of the box
    scene, cam = load_scene(CBOX_SPHERES, "cpu", W, H, fov_mode="native")
    return Renderer(scene, cam, _cfg(spp, **kw), "cpu")


def test_cell_matches_jax_render_cell():
    """A flat NORMAL cell of the port against the JAX package's
    render_cell: centred, deterministic rays through the same window.
    Triangle pixels agree to rtol 1e-5. On the spheres the two packages'
    intersection forms round apart (XLA contracts multiply-adds on the
    CPU; ROADMAP.md Queue 3): hit points differ by up to 3e-5 there, so
    those pixels are held to the full frame's atol 1e-4
    (test_torch_render.py)."""
    cfg = _cfg(1, illum=Illum.NORMAL)
    js, jcam = jax_load_scene(CBOX_SPHERES, W, H, fov_mode="native")
    jcell = JaxRenderer(js, jcam, jax_config(cfg.replace(
        max_dispatch_seconds=0))).render_cell(*CELL)
    r = _renderer(1, illum=Illum.NORMAL)
    cell = r.render_cell(*CELL)
    assert cell.shape == (12, 16, 3) and cell.max() > 0
    x, y, dx, dy = CELL
    xy = torch.stack(torch.meshgrid(
        (torch.arange(x, x + dx) + 0.5) / W,
        (torch.arange(y, y + dy) + 0.5) / H, indexing="xy"), -1)
    prim = tk.kernel_trace(r.scene, r.tables, r.camera.generate_rays(
        xy.to(torch.float32))).prim_id.numpy()
    tri = prim < r.scene.n_tris
    assert tri.mean() > 0.5 and (~tri).any()
    np.testing.assert_allclose(cell[tri], jcell[tri], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(cell[~tri], jcell[~tri], rtol=0, atol=1e-4)


def test_cell_equals_the_crop_of_the_full_frame():
    r = _renderer(1, illum=Illum.NORMAL)
    full, _ = r.render()
    x, y, dx, dy = CELL
    np.testing.assert_array_equal(r.render_cell(*CELL),
                                  full[y:y + dy, x:x + dx])


def test_cell_allocations_scale_with_the_cell():
    r = _renderer(2, illum=Illum.NORMAL)
    hdr, count = r.render(region=(0, 0, 8, 4))
    assert hdr.shape == (4, 8, 3) and count.shape == (4, 8)
    assert [a.shape[0] for a in r.last_accumulators] == [32] * 5
    assert r.stats().camera_rays == 2 * 32


def test_checkpoint_resume_bit_exact(tmp_path):
    """Cancelled after 2 of 4 samples, then resumed from the checkpoint:
    equal to the uninterrupted render bit for bit."""
    ckpt = str(tmp_path / "state.npz")
    full, full_count = _renderer().render()
    r2 = _renderer()
    r2.render(checkpoint_path=ckpt, checkpoint_every=1, stop_after=2)
    assert r2.cancelled and r2.samples_done == 2 and os.path.exists(ckpt)
    assert int(np.load(ckpt)["s"]) == 2
    r3 = _renderer()
    resumed, resumed_count = r3.render(checkpoint_path=ckpt, resume=True)
    assert not r3.cancelled and r3.samples_done == 4
    np.testing.assert_array_equal(resumed, full)
    np.testing.assert_array_equal(resumed_count, full_count)


def test_checkpoint_fingerprint_mismatch(tmp_path):
    ckpt = str(tmp_path / "state.npz")
    r = _renderer()
    r.render(checkpoint_path=ckpt, stop_after=2)
    with pytest.raises(ValueError, match="does not match"):
        r.load_checkpoint(ckpt, (0, 0, 32, 32))
    with pytest.raises(ValueError, match="does not match"):
        _renderer(spp=8).load_checkpoint(ckpt, (0, 0, W, H))
    acc, s = r.load_checkpoint(ckpt, (0, 0, W, H))
    assert s == 2 and acc[0].shape == (W * H, 3)


def test_checkpoint_keys_match_jax(tmp_path):
    """The port's npz holds the JAX package's keys, dtypes and shapes, and
    the same fingerprint for the same render."""
    cfg = _cfg(4, max_dispatch_seconds=0)
    js, jcam = jax_load_scene(CBOX_SPHERES, W, H, fov_mode="native")
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JaxRenderer(js, jcam, jax_config(cfg)).render(
        checkpoint_path=jpath, stop_after=2)
    _renderer().render(checkpoint_path=tpath, stop_after=2)
    with np.load(jpath) as j, np.load(tpath) as t:
        assert sorted(t.files) == sorted(j.files) == sorted(
            ["rad_sum", "s1", "s2", "count", "done", "s", "fingerprint"])
        for key in j.files:
            assert (t[key].dtype, t[key].shape) == (j[key].dtype,
                                                    j[key].shape), key
        np.testing.assert_array_equal(t["fingerprint"], j["fingerprint"])
        assert int(t["s"]) == int(j["s"]) == 2


@pytest.mark.parametrize("how", ["stop", "stop_after", "control_stop",
                                 "spp_cap"])
def test_cancellation(how):
    r = _renderer(spp=6)
    kw = {}
    if how == "stop":
        kw["progress"] = lambda s, total: r.stop() if s == 2 else None
    elif how == "stop_after":
        kw["stop_after"] = 2
    elif how == "control_stop":
        control = {}
        kw["control"] = control
        kw["progress"] = lambda s, total: control.update(stop=True) \
            if s == 2 else None
    else:
        kw["control"] = {"spp_cap": 2}
    hdr, count = r.render(**kw)
    assert r.cancelled and r.samples_done == 2
    assert (count == 2).all() and np.isfinite(hdr).all()
    r.render()                      # the next render starts afresh
    assert not r.cancelled and r.samples_done == 6


def test_ctrl_c_saves_the_checkpoint(tmp_path):
    """A KeyboardInterrupt raised in `progress` cancels the render and
    saves its state; resuming then equals the uninterrupted render."""
    ckpt = str(tmp_path / "state.npz")

    def interrupt(s, total):
        if s == 3:
            raise KeyboardInterrupt

    r = _renderer()
    r.render(progress=interrupt, checkpoint_path=ckpt)
    assert r.cancelled and r.samples_done == 3
    assert int(np.load(ckpt)["s"]) == 3
    resumed, _ = _renderer().render(checkpoint_path=ckpt, resume=True)
    np.testing.assert_array_equal(resumed, _renderer().render()[0])


def test_progressive_preview(tmp_path):
    """The preview is written between passes with samples left to do: at
    s = 1, 2, 3 of 4 with preview_every 1, only at s = 2 with 2; the
    control mapping changes the cadence live."""
    prev = str(tmp_path / "prev.png")
    written, r_s = [], []
    r = _renderer()
    real = r._write_preview
    r._write_preview = lambda *a: written.append(r_s[-1]) or real(*a)
    r.render(preview_path=prev, preview_every=1,
             progress=lambda s, total: r_s.append(s))
    assert written == [1, 2, 3]
    img = read_png(prev)
    assert img.shape == (H, W, 4) and img[..., :3].max() > 0
    written.clear()
    r.render(preview_path=prev, preview_every=2,
             progress=lambda s, total: r_s.append(s))
    assert written == [2]
    written.clear()
    r.render(preview_path=prev, preview_every=2, control={"preview_every": 3},
             progress=lambda s, total: r_s.append(s))
    assert written == [3]
