"""The port's differentiable path on its own: gradients against finite
differences (the analogs of tests/test_diff.py), an SGD step, gradient
finiteness at image scale, and the kernel's counters on the path.

A loss evaluated twice under the same threefry key draws the same
uniforms, so that finite differences see one objective.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rrt_tpu_torch.render import diff
from rrt_tpu_torch.render.renderer import make_black_hole
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.types import (BSDF_EMISSION, BSDF_GLASS, BSDF_MICROFACET,
                                 BSDF_MIRROR)
from rrt_tpu_torch.utils import prng
from rrt_tpu_torch.utils.config import BlackHoleConfig, RenderConfig
from rrt_tpu_torch.utils.profile import range_ops, split_device_time

# the JAX package's own finite-difference tolerance (tests/test_diff.py)
FD_RTOL = 5e-2


def _setup(curved, md=2, n=24, **kw):
    cfg = RenderConfig(width=64, height=64, ns_aa=1, ns_area_light=2,
                       max_ray_depth=md, seed=0, differentiable=True,
                       black_hole=BlackHoleConfig(enabled=curved), **kw)
    scene, cam = load_scene(CBOX_SPHERES, "cpu", 64, 64, fov_mode="native")
    bh = make_black_hole(cfg, "cpu")
    xy = np.random.default_rng(0).uniform(0.2, 0.8, (n, 2))
    rays = cam.generate_rays(torch.tensor(xy, dtype=torch.float32))
    return scene, bh, cfg, rays, diff.params_from_scene(scene, bh)


def _mean_radiance(scene, bh, cfg, rays, seed=1):
    def f(params):
        return torch.mean(diff.render_radiance(
            params, scene, bh, rays, cfg, prng.key(seed)))
    return f


def _grad(f, params):
    leaves = [x.detach().requires_grad_(True) for x in params.leaves()]
    grads = torch.autograd.grad(f(diff.SceneParams.from_leaves(leaves)),
                                leaves, allow_unused=True)
    return diff.SceneParams.from_leaves(
        [torch.zeros_like(x) if g is None else g
         for x, g in zip(leaves, grads)])


def _fd(f, params, name, index, eps):
    def at(sign):
        v = getattr(params, name).clone()
        v[index] += sign * eps
        with torch.no_grad():
            return float(f(params.replace(**{name: v})))
    return (at(+1) - at(-1)) / (2 * eps)


@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
def test_grad_albedo_matches_fd(curved):
    scene, bh, cfg, rays, params = _setup(curved)
    f = _mean_radiance(scene, bh, cfg, rays)
    g = _grad(f, params).reflectance
    assert torch.isfinite(g).all() and g.abs().max() > 0
    idx = np.unravel_index(int(g.abs().argmax()), g.shape)
    fd = _fd(f, params, "reflectance", idx, 3e-3)
    np.testing.assert_allclose(float(g[idx]), fd, rtol=FD_RTOL, atol=1e-5)


def _emissive(scene):
    """The box with its ceiling's material an emission BSDF of radiance
    (2, 2, 2): the in-repo box is lit by an area light only, and
    hemisphere sampling sees emissive geometry only."""
    top = torch.where(scene.tri_bsdf >= 0, scene.tri_v0[:, 1], -np.inf)
    row = int(scene.tri_bsdf[int(top.argmax())])
    b = scene.bsdfs
    kind, em = b.kind.clone(), b.emission.clone()
    kind[row], em[row] = BSDF_EMISSION, 2.0
    return scene.replace(bsdfs=b.replace(kind=kind, emission=em))


def test_grad_emission_matches_fd():
    """-H: hemisphere direct sampling gathers the emission of whatever it
    hits (part1_code.cpp:15-31)."""
    scene, bh, cfg, rays, _ = _setup(curved=False)
    scene = _emissive(scene)
    params = diff.params_from_scene(scene, bh)
    cfg = cfg.replace(direct_hemisphere_sample=True, ns_area_light=16)
    f = _mean_radiance(scene, bh, cfg, rays)
    g = _grad(f, params).emission
    assert torch.isfinite(g).all() and g.abs().max() > 0
    idx = np.unravel_index(int(g.abs().argmax()), g.shape)
    fd = _fd(f, params, "emission", idx, 1e-2)
    np.testing.assert_allclose(float(g[idx]), fd, rtol=FD_RTOL, atol=1e-6)


def test_grad_bh_radius_sign_matches_fd():
    """d(radiance)/d(Schwarzschild radius) through the geodesic replay:
    the sign, or a rough magnitude, of the central difference (visibility
    events allow no tighter rule, as in the JAX package)."""
    scene, bh, cfg, rays, params = _setup(curved=True, md=1, n=64)
    f = _mean_radiance(scene, bh, cfg, rays)
    g = float(_grad(f, params).bh_radius)
    assert np.isfinite(g)
    fd = _fd(f, params, "bh_radius", (), 2e-3)
    if abs(fd) > 1e-4 or abs(g) > 1e-4:
        assert np.sign(fd) == np.sign(g) or abs(fd - g) < 0.5 * max(
            abs(fd), abs(g)), (g, fd)


def test_train_step_reduces_loss():
    scene, bh, cfg, rays, params = _setup(curved=False, md=1)
    target = torch.full((rays.o.shape[0], 3), 0.3)
    gen = lambda: prng.key(0)
    with torch.no_grad():
        loss0 = float(diff.image_loss(params, scene, bh, rays, target, cfg,
                                      gen()))
    p = params
    for _ in range(5):
        p, _, loss = diff.train_step(p, None, scene, bh, rays, target, cfg,
                                     gen(), lr=0.5)
    assert float(loss) < loss0
    assert not any(x.requires_grad for x in p.leaves())


def _materials(scene, kind):
    """The box as built ("lambertian"); with a glass sphere, a sharp
    conductor sphere and a mirror wall ("glossy": the TIR boundary,
    grazing microfacet lobes); or with its spheres removed ("no-spheres":
    every lane gathers a dead sphere row)."""
    if kind == "lambertian":
        return scene
    if kind == "no-spheres":
        return scene.replace(
            sph_radius=torch.zeros_like(scene.sph_radius),
            sph_center=torch.full_like(scene.sph_center, 1e30),
            sph_bsdf=torch.full_like(scene.sph_bsdf, -1), n_live_spheres=0)
    b = scene.bsdfs
    rows = dict(kind=b.kind.clone(), reflectance=b.reflectance.clone(),
                transmittance=b.transmittance.clone(), eta=b.eta.clone(),
                k=b.k.clone(), alpha=b.alpha.clone(), ior=b.ior.clone())
    glass, metal = (int(i) for i in scene.sph_bsdf[:2])
    mirror = int(scene.tri_bsdf[0])
    for key, row, value in (
            ("kind", glass, BSDF_GLASS), ("reflectance", glass, 1.0),
            ("transmittance", glass, 1.0), ("ior", glass, 1.5),
            ("kind", metal, BSDF_MICROFACET), ("alpha", metal, 0.05),
            ("eta", metal, torch.tensor([0.2, 0.9, 1.1])),
            ("k", metal, torch.tensor([3.9, 2.4, 2.2])),
            ("kind", mirror, BSDF_MIRROR), ("reflectance", mirror, 0.9)):
        rows[key][row] = value
    return scene.replace(bsdfs=b.replace(**rows))


@pytest.mark.parametrize("kind,size", [("lambertian", 48), ("glossy", 32),
                                       ("no-spheres", 24)])
def test_image_scale_grads_finite_and_counted(kind, size):
    """size² curved global illumination at depth 5: every leaf's gradient
    is finite (the JAX package's r1 verdict found NaNs at 48×48: grazing
    sphere hits, the TIR boundary, zero-area light denominators), and the
    path's traces are counted by the kernel's real counters."""
    cfg = RenderConfig(width=size, height=size, ns_aa=1, ns_area_light=1,
                       max_ray_depth=5, seed=0, differentiable=True)
    scene, cam = load_scene(CBOX_SPHERES, "cpu", size, size)
    scene = _materials(scene, kind)
    bh = make_black_hole(cfg, "cpu")
    n = size * size
    i = torch.arange(n)
    xy = torch.stack([(i % size + 0.5) / size, (i // size + 0.5) / size],
                     dim=-1)
    rays = cam.generate_rays(xy)
    params = diff.params_from_scene(scene, bh)
    leaves = [x.detach().requires_grad_(True) for x in params.leaves()]
    img, work = diff.render_radiance(
        diff.SceneParams.from_leaves(leaves), scene, bh, rays, cfg,
        prng.key(0), with_work=True)
    grads = torch.autograd.grad(torch.mean(img ** 2), leaves,
                                allow_unused=True)
    for f, g in zip(diff.SceneParams.__dataclass_fields__, grads):
        assert g is None or torch.isfinite(g).all(), f
    assert grads[0] is not None and grads[0].abs().max() > 0
    assert grads[9] is not None and grads[9] != 0        # bh_radius
    # camera + 4 bounces, and one shadow query per vertex
    assert work.calls == 1 + 4 + 5
    assert (work.tests > 0).all()


def _ev(name, start, end, device="cpu", seq=-1, kernels=(), dev_us=0.0,
        annotation=False):
    """A profiler event with the fields `split_device_time` reads."""
    dt = getattr(torch.autograd.DeviceType, device.upper())
    return SimpleNamespace(
        name=name, device_type=dt, thread=1, sequence_nr=seq,
        is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start),
        kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels],
        device_time_total=dev_us)


def test_profile_call_attributes_the_replay():
    """`split_device_time` on events shaped as a card trace gives them: a
    range's forward time is its ops' own kernels (not its span on the
    device), its backward time the device time of those ops' autograd
    nodes; the trace kernel and the rest apart. Then `range_ops` on a real
    trace of the replay's gradient (host events, Δθ 0.5: 13 chords) finds
    the replay's ops and their backward nodes."""
    R = "trace_diff.replay"
    bwd = "autograd::engine::evaluate_function: MulBackward0"
    evs = [
        _ev(R, 10, 50),
        _ev("aten::mul", 12, 14, seq=7, kernels=[("mul_k", 3.0)]),
        _ev("aten::add", 20, 22, seq=8, kernels=[("add_k", 5.0),
                                                 (R, 40.0)]),
        _ev("aten::sub", 60, 62, seq=9, kernels=[("sub_k", 11.0)]),
        _ev(bwd, 70, 80, seq=7, dev_us=13.0),
        _ev(bwd, 81, 90, seq=9, dev_us=17.0),
        _ev("mul_k", 0, 3, device="cuda"),
        _ev("add_k", 3, 8, device="cuda"),
        _ev("sub_k", 8, 19, device="cuda"),
        _ev("trace_kernel<1>", 19, 119, device="cuda"),
        _ev("bwd_k", 119, 149, device="cuda"),
        _ev(R, 0, 40, device="cuda", annotation=True),
    ]
    device_ms, kernel_ms, ranges, rows = split_device_time(evs, (R,))
    assert device_ms == pytest.approx(0.149)
    assert kernel_ms == pytest.approx(0.1)
    assert ranges[R] == (pytest.approx(0.008), pytest.approx(0.013))
    assert rows[0][:2] == ("trace_kernel<1>", 1)
    assert R not in [name for name, _, _ in rows]

    cfg = RenderConfig(width=64, height=64, ns_aa=1, max_ray_depth=1,
                       differentiable=True,
                       black_hole=BlackHoleConfig(delta_theta=0.5))
    scene, bh, _, rays, params = _setup(curved=True, md=1, n=16)
    bh = make_black_hole(cfg, "cpu")
    params = diff.params_from_scene(scene, bh)
    f = _mean_radiance(scene, bh, cfg, rays)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _grad(f, params)
    inside, nodes = range_ops(prof.events(), R)
    assert sum(ev.name == "aten::mul" for ev in inside) >= 13
    assert len(nodes) >= 13
