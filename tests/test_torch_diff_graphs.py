"""The compiled gradient step on the CPU: `render/diff.LossAndGrad`, the
port of the JAX package's `jax.jit(jax.value_and_grad(image_loss))` and
jitted `train_step` (tests/test_inverse.py:46-47, 79-80), and the hole's
row that every evaluation writes on the device
(`ops/trace_kernel.with_hole`).

The CPU has no CUDA graphs, so the step runs under the stand-in for the
graph of tests/test_torch_graphs.py (the `stand_in` fixture: the warm-up
runs the step, the "capture" runs it and puts its output buffers and
generator back, a replay runs it again without the Python launcher's
count). At 24×16 with `-m 2` and `-l 1`: the curved global-illumination
estimate of config 4's radius loop and the flat direct-lit estimate of
its albedo loop. The `cuda`-marked twin in tests/test_torch_kernel_cuda.py
holds the real graph to the eager step bit for bit on a card.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrt_tpu.render import diff as jdiff
from rrt_tpu.render.renderer import make_black_hole as jax_black_hole
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu_torch import convert
from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.parallel.sharding import LaneMesh
from rrt_tpu_torch.render import diff, integrator
from rrt_tpu_torch.render.renderer import make_black_hole
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.tools.inverse import RADIUS_FRAME, pixel_rays
from rrt_tpu_torch.types import Rays
from rrt_tpu_torch.utils.config import BlackHoleConfig, Illum, RenderConfig
from test_torch_diff import (HOLE_RTOL, MATERIAL_RTOL, _calm_hits,
                             _direct_uniforms, _gi_uniforms)
from test_torch_graphs import stand_in  # noqa: F401  (the graph stand-in)
from test_torch_hostmods import jax_config

W, H = 24, 16
# config 4's two estimates at the small size: the radius loop's curved
# global illumination and the albedo loop's flat direct light
CASES = {
    "curved GI": dict(),
    "flat direct": dict(illum=Illum.DIRECT, max_ray_depth=1,
                        black_hole=BlackHoleConfig(enabled=False)),
}
HOLE = ("bh_position", "bh_radius", "bh_delta_theta")


def _cfg(case):
    kw = dict(dict(width=W, height=H, ns_aa=1, ns_area_light=1,
                   max_ray_depth=2, seed=0), **CASES[case])
    return RenderConfig(**kw)


def _problem(case):
    """(params, scene, hole, rays, cfg) of the port on the in-repo box."""
    cfg = _cfg(case)
    scene, cam = load_scene(CBOX_SPHERES, "cpu", W, H, fov_mode="native")
    bh = make_black_hole(cfg, "cpu")
    return (diff.params_from_scene(scene, bh), scene, bh,
            pixel_rays(cam, W, H, "cpu", RADIUS_FRAME), cfg)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _step(scene, bh, cfg, rays, target, **kw):
    """A `LossAndGrad` whose calls go through the stand-in's graph (a CPU
    step builds none by itself)."""
    step = diff.LossAndGrad(scene, bh, cfg, rays, target, **kw)
    step.graphs = True
    return step


def _moved(params, i):
    """The params of step i: radius and the reflectance table moved."""
    return params.replace(bh_radius=params.bh_radius + 0.004 * i,
                          reflectance=params.reflectance * (1 - 0.05 * i))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.leaves(), b.leaves()))


@pytest.mark.parametrize("case", list(CASES))
def test_compiled_step_equals_eager(stand_in, case):
    """Four steps of the compiled step (eager warm-up, capture and replay,
    two replays), with the radius and the reflectance moved and a new seed
    at each, new rays handed to the third and a new target to the fourth,
    against the eager `loss_and_grad`: loss and all eleven
    gradient leaves equal bit for bit, and the caller's generator left
    where the eager step leaves it. The kernel's runs equal the step's
    trace calls at every step; only the warm-up launches through Python."""
    params, scene, bh, rays, cfg = _problem(case)
    with torch.no_grad():
        target = diff.render_radiance(params, scene, bh, rays, cfg, _gen(9))
    step = _step(scene, bh, cfg, rays, target)
    for i in range(4):
        p, kw = _moved(params, i), {}
        if i == 2:            # new rays, kept by the step for step 3
            rays = kw["rays"] = rays.replace(o=rays.o + 0.01)
        if i == 3:
            target = kw["target"] = target * 0.5
        ge, gc = _gen(i), _gen(i)
        want = diff.loss_and_grad(p, scene, bh, rays, target, cfg, ge)
        tk.reset_counts()
        got = step(p, gc, **kw)
        assert torch.equal(got[0], want[0]) and _same(got[1], want[1])
        assert torch.equal(ge.get_state(), gc.get_state())
        assert tk.kernel_runs() == step.trace_calls > 0
        assert tk.LAUNCHES == (step.trace_calls if i == 0 else 0)
    assert step.call.replays == 3
    assert float(want[0]) > 0
    assert any(g.abs().max() > 0 for g in want[1].leaves())


def _dead_lanes(rays, keep, bh):
    """The rays with the lanes outside `keep` ending at once (the
    integrator's masked lanes: origin at the hole's centre, dead on
    segment 0), so that they add no radiance and no gradient in either
    package, while every lane keeps its draws."""
    o = torch.where(torch.as_tensor(keep)[:, None], rays.o,
                    bh.position.expand_as(rays.o))
    return rays.replace(o=o)


@pytest.mark.parametrize("case", list(CASES))
def test_compiled_step_matches_jax_jit_value_and_grad(stand_in, monkeypatch,
                                                     case):
    """The compiled step against the JAX package's
    `jax.jit(jax.value_and_grad(image_loss))` on the same rays and target,
    the port handed the uniforms JAX draws from its key at every run of
    the step: the loss and the material gradients (reflectance, light
    radiance) to MATERIAL_RTOL, the hole's gradients to HOLE_RTOL (rtol
    5e-3). In curved space only lanes that are calm up to their hits and
    whose radiance agrees between the packages are traced (the rule of
    test_torch_diff.py's GI test): the others end at once in both."""
    cfg = _cfg(case)
    curved = cfg.black_hole.enabled
    js, jcam = jax_load_scene(CBOX_SPHERES, W, H, fov_mode="native")
    jbh = jax_black_hole(jax_config(cfg))
    ys, xs = np.meshgrid((np.arange(H) + 0.5) / H, (np.arange(W) + 0.5) / W,
                         indexing="ij")
    xy = 0.5 + (np.stack([xs, ys], -1).reshape(-1, 2) - 0.5) * RADIUS_FRAME
    jrays = jcam.generate_rays(jnp.asarray(xy, jnp.float32))
    ts = convert.scene_from_arrays(convert.to_arrays(js), "cpu")
    tbh = (convert.black_hole_from_arrays(
        np.asarray(jbh.position), np.asarray(jbh.radius),
        np.asarray(jbh.delta_theta), "cpu") if curved else None)
    trays = Rays(**{k: torch.tensor(np.asarray(getattr(jrays, k)))
                    for k in ("o", "d", "min_t", "max_t")})
    n = trays.o.shape[0]
    key = jax.random.key(5)
    jp = jdiff.params_from_scene(js, jbh)
    tp = diff.params_from_arrays(convert.to_arrays(jp), "cpu")
    jcfg = jax_config(cfg)
    draws = (_gi_uniforms(key, n, cfg.ns_area_light) if curved
             else _direct_uniforms(key, n, cfg, 1))
    shared = itertools.cycle(draws)     # one set for every run of the step

    def handed(gen, shape, like):
        xi = torch.tensor(next(shared))
        assert tuple(xi.shape) == tuple(shape)
        return xi
    monkeypatch.setattr(integrator, "_uniform", handed)

    if curved:
        replayed = []
        trace_diff = integrator.tracer.trace_diff

        def recorded(scene, bh, rays, **kw):
            replayed.append(rays)
            return trace_diff(scene, bh, rays, **kw)
        monkeypatch.setattr(integrator.tracer, "trace_diff", recorded)
        with torch.no_grad():
            img = diff.render_radiance(tp, ts, tbh, trays, cfg, None)
        monkeypatch.setattr(integrator.tracer, "trace_diff", trace_diff)
        jimg = np.asarray(jax.jit(lambda p: jdiff.render_radiance(
            p, js, jbh, jrays, jcfg, key))(jp))
        keep = np.isclose(img.numpy(), jimg, rtol=1e-4, atol=1e-6).all(-1)
        assert len(replayed) == 2            # the camera and the bounce
        for r in replayed:              # a missed ray adds nothing
            hit, calm = _calm_hits(ts, tbh, r)
            keep &= calm | ~hit
        assert keep.sum() >= 50, int(keep.sum())
        trays = _dead_lanes(trays, keep, tbh)
        jrays = jrays.replace(o=jnp.asarray(trays.o.numpy()))

    target = np.random.default_rng(3).uniform(0, 0.5, (n, 3)).astype(
        np.float32)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p: jdiff.image_loss(
        p, js, jbh, jrays, jnp.asarray(target), jcfg, key)))(jp)
    step = _step(ts, tbh, cfg, trays, torch.tensor(target))
    for _ in range(2):                   # eager, then captured and replayed
        loss, g = step(tp, _gen(0))
    assert step.call.replays == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=MATERIAL_RTOL)
    names = ("reflectance", "light_radiance") + (HOLE if curved else ())
    for name in names:
        a, b = getattr(g, name).numpy(), np.asarray(getattr(jg, name))
        rtol = HOLE_RTOL if name in HOLE else MATERIAL_RTOL
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("enabled", [True, False, None],
                         ids=["hole", "disabled hole", "no hole"])
def test_device_hole_row_equals_build_tables(enabled):
    """The hole's row written on the device (`with_hole` over the tables
    built without a hole) equals `build_tables`' row bit for bit, and the
    mode, the chord count and every geometry table with it: a hole of
    another position, radius and Δθ than the default, disabled, or none."""
    scene, _ = load_scene(CBOX_SPHERES, "cpu", W, H)
    bh = None if enabled is None else convert.black_hole_from_arrays(
        (0.2, 1.1, -0.3), 0.13, 0.07, "cpu").replace(enabled=enabled)
    want = tk.build_tables(scene, bh)
    got = tk.with_hole(tk.build_tables(scene, None), bh, 90)
    assert torch.equal(got.params, want.params)
    assert (got.curved, got.n_seg) == (want.curved, want.n_seg) == (
        (True, 90) if enabled else (False, 1))
    for name in ("tri", "cl", "sup", "part", "sph"):
        assert torch.equal(getattr(got, name), getattr(want, name))
    if enabled:
        assert torch.equal(tk.hole_row(bh, "cpu"), want.params[:tk.P_GLO])


def test_compiled_train_step_lowers_the_loss(stand_in):
    """Five compiled `train_step`s at lr 0.5 on the flat direct-lit box
    (the loop of tests/test_diff.py:101-110) lower the loss, and each
    equals the eager `train_step` bit for bit: the updated params, the
    passed-through optimiser state and the loss. A step built for another
    config is refused."""
    params, scene, bh, rays, cfg = _problem("flat direct")
    target = torch.full((rays.o.shape[0], 3), 0.3)
    with torch.no_grad():
        loss0 = float(diff.image_loss(params, scene, bh, rays, target, cfg,
                                      _gen(0)))
    step = _step(scene, bh, cfg, rays, target)
    pe = pc = params
    for _ in range(5):
        pe, _, le = diff.train_step(pe, None, scene, bh, rays, target, cfg,
                                    _gen(0), lr=0.5)
        pc, state, lc = diff.train_step(pc, "state", scene, bh, rays,
                                        target, cfg, _gen(0), lr=0.5,
                                        step=step)
        assert state == "state" and torch.equal(lc, le) and _same(pc, pe)
    assert float(lc) < loss0
    assert not any(x.requires_grad for x in pc.leaves())
    assert step.call.replays == 4
    with pytest.raises(ValueError, match="another scene, hole, config"):
        diff.train_step(pc, None, scene, bh, rays, target,
                        cfg.replace(ns_area_light=2), _gen(0), step=step)


def test_graphs_refused_with_a_mesh_and_on_the_cpu():
    """On the CPU, asking for graphs raises for the device, with a mesh (a
    world of 1) or without; a mesh alone refuses nothing, since a card
    captures the sharded step as two graphs around its all-reduce. Without
    asking, a CPU step, with a mesh or without, builds no graph and equals
    the eager `loss_and_grad` bit for bit."""
    params, scene, bh, rays, cfg = _problem("flat direct")
    target = torch.zeros_like(rays.o)
    mesh = LaneMesh(None, 0, 1, torch.device("cpu"), None)
    for kw in (dict(), dict(mesh=mesh)):
        with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
            diff.LossAndGrad(scene, bh, cfg, rays, target, graphs=True, **kw)
    for kw in (dict(), dict(mesh=mesh)):
        step = diff.LossAndGrad(scene, bh, cfg, rays, target, **kw)
        got = step(params, _gen(1))
        want = diff.loss_and_grad(params, scene, bh, rays, target, cfg,
                                  _gen(1), **kw)
        assert not step.graphs and step.call is None
        assert torch.equal(got[0], want[0]) and _same(got[1], want[1])
