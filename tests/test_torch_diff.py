"""The port's differentiable path (`render.diff`, `geometry.trace.
trace_diff`, the gradient guards) against the JAX package's, and on its
own.

Both packages start from identical data: the JAX package's Cornell box
(the in-repo scene, 64×64 native FoV) and its camera rays go through
`convert`, and its SceneParams through `diff.params_from_arrays`. Gradients
with respect to the hole are compared on calm lanes only (`chaotic_lanes`:
a lane whose march wraps or passes within 5 radii of the hole rounds onto
another trajectory in either package). Both packages render under one
key: the port splits the JAX package's threefry key as the JAX package
does and draws its uniforms (`utils.prng`).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rrt_tpu.geometry import trace as jtrace
from rrt_tpu.render import diff as jdiff
from rrt_tpu.render.renderer import make_black_hole as jax_black_hole
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu_torch import convert
from rrt_tpu_torch.geometry import trace as ttrace
from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.physics import schwarzschild as tss
from rrt_tpu_torch.render import diff
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.types import BSDF_EMISSION, BlackHoleParams, Rays
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.utils import prng
from rrt_tpu_torch.utils.config import BlackHoleConfig, Illum, RenderConfig
from test_torch_hostmods import jax_config

N_SEG = 63
# gradients with respect to the hole, summed over calm lanes: 63 float32
# chords whose Jacobians amplify rounding. Here the JAX package's d/dΔθ
# of the weighted hit points is 0.4% and the port's 0.1% off a float64
# replay of the same lanes (single sphere lanes up to 1%), so 1e-3 is
# below what float32 gives either package
HOLE_RTOL = 5e-3
# gradients with respect to materials and light radiance: the same
# arithmetic on the same uniforms, summed in another order
MATERIAL_RTOL = 1e-4


def _setup(curved, n=400, seed=0, span=(0.2, 0.8), **kw):
    """(JAX scene, hole, rays; the port's scene, hole, rays; config); the
    rays pass through `span` of the frame on both axes."""
    kw = dict(dict(width=64, height=64, ns_aa=1, ns_area_light=2,
                   max_ray_depth=2, seed=0, differentiable=True), **kw)
    cfg = RenderConfig(black_hole=BlackHoleConfig(enabled=curved), **kw)
    js, jcam = jax_load_scene(CBOX_SPHERES, 64, 64, fov_mode="native")
    jbh = jax_black_hole(jax_config(cfg))
    xy = np.random.default_rng(seed).uniform(*span, (n, 2))
    jrays = jcam.generate_rays(jnp.asarray(xy, jnp.float32))
    ts = convert.scene_from_arrays(convert.to_arrays(js), "cpu")
    tbh = (convert.black_hole_from_arrays(np.asarray(jbh.position),
                                          np.asarray(jbh.radius),
                                          np.asarray(jbh.delta_theta), "cpu")
           if curved else None)
    trays = Rays(**{k: torch.tensor(np.asarray(getattr(jrays, k)))
                    for k in ("o", "d", "min_t", "max_t")})
    return js, jbh, jrays, ts, tbh, trays, cfg


def _hole(p, like):
    return BlackHoleParams(position=p[0], radius=p[1], delta_theta=p[2],
                           enabled=like.enabled)


def _hole_leaves(bh):
    return [x.detach().clone().requires_grad_(True)
            for x in (bh.position, bh.radius, bh.delta_theta)]


def test_grad_guard_forward_and_backward():
    x = torch.tensor([1.0, -2.0, 3.0, 4.0, 5.0], requires_grad=True)
    y = tss.grad_guard(x)
    assert torch.equal(y, x)
    ct = torch.tensor([float("nan"), float("inf"), -float("inf"), 5e3, -0.5])
    y.backward(ct)
    assert torch.equal(x.grad, torch.tensor([0.0, 0.0, 0.0, 1e3, -0.5]))
    plain = torch.ones(3)
    assert tss.grad_guard(plain) is plain        # no autograd: a no-op


def _near_radial(n, seed, centre):
    """Lanes 0.2 .. 1 from the hole's centre moving almost straight out:
    at dy ≈ Δθ the step's u' cancels u, and u_new ≈ 0 throws the chord
    across the scene (the u ≤ 0 wrap and its neighbours)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.2, 1.0, n)
    x = rng.normal(size=(n, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = rng.normal(size=(n, 3))
    y -= (y * x).sum(1, keepdims=True) * x
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    d = x + np.linspace(0.05, 0.2, n)[:, None] * y
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    return f32(centre + r[:, None] * x), f32(d)


def test_micro_step_grads_finite_on_wrapped_lanes():
    """One step of lanes that wrap: the chord ends' gradients with respect
    to the hole are finite, and the forward values equal the step's
    outside autograd. Then the march of those lanes replayed by
    trace_diff, from origins aimed past the hole: finite gradients."""
    centre = np.array([0.0, 1.0, 0.0])
    pos, d = _near_radial(4096, 3, centre)
    bh = convert.black_hole_from_arrays(centre, 0.1, 0.1, "cpu")
    leaves = _hole_leaves(bh)
    nd, clen, dead = tss.micro_step(pos, d, _hole(leaves, bh))
    with torch.no_grad():
        nd0, clen0, dead0 = tss.micro_step(pos, d, bh)
    assert torch.equal(nd, nd0) and torch.equal(clen, clen0)
    assert torch.equal(dead, dead0)
    assert (clen.detach() > 50.0).sum() >= 10
    end = pos + nd * torch.where(dead, 0.0, clen)[:, None]
    for g in torch.autograd.grad(end.sum(), leaves):
        assert torch.isfinite(g).all()

    ts, _ = load_scene(CBOX_SPHERES, "cpu", 64, 64)
    rays = Rays(o=pos, d=d, min_t=torch.zeros(4096),
                max_t=torch.full((4096,), 1e9))
    assert tss.chaotic_lanes(pos, d, bh, N_SEG).sum() >= 1000
    leaves = _hole_leaves(bh)
    h = ttrace.trace_diff(ts, _hole(leaves, bh), rays,
                          tables=tk.build_tables(ts, bh))
    assert h.hit.any()
    loss = torch.sum(torch.where(h.hit[:, None], h.p, 0.0))
    for g in torch.autograd.grad(loss, leaves):
        assert torch.isfinite(g).all()


def _trace_parity(hd, ref_hit, ref_prim, ref_p):
    """hit and prim equal; >= 99.5% of hit lanes have p within 1e-4 (the
    JAX package's rule, tests/test_diff.py:113-127)."""
    hit = hd.hit.numpy()
    np.testing.assert_array_equal(hit, ref_hit)
    np.testing.assert_array_equal(hd.prim_id.numpy()[hit], ref_prim[hit])
    close = np.abs(hd.p.detach().numpy()[hit] - ref_p[hit]).max(-1) < 1e-4
    assert hit.sum() >= 50 and close.mean() > 0.995, close.mean()


def test_trace_diff_matches_its_primal_and_jax():
    js, jbh, jrays, ts, tbh, trays, _ = _setup(curved=True)
    hd, st = ttrace.trace_diff(ts, tbh, trays, return_stats=True)
    hk = ttrace.trace(ts, tbh, trays)
    _trace_parity(hd, hk.hit.numpy(), hk.prim_id.numpy(), hk.p.numpy())
    jd = jtrace.trace_diff(js, jbh, jrays, n_seg=N_SEG, backend="xla")
    _trace_parity(hd, np.asarray(jd.hit), np.asarray(jd.prim_id),
                  np.asarray(jd.p))
    assert (st > 0).all()       # the kernel's real counters


def _calm_hits(ts, tbh, rays):
    """(hit, calm): the lanes that hit, and of them those that are calm up
    to their winning chord (the rule of `chaotic_lanes`, applied to the
    chords that trace_diff replays into the result)."""
    h, seg, _ = ttrace.trace_with_seg(ts, tbh, rays)
    pos, dirn = rays.o, rays.d
    dead = torch.zeros_like(h.hit)
    calm = h.hit.clone()
    for s in range(N_SEG):
        nd, clen, sdead = tss.micro_step(pos, dirn, tbh)
        dead = dead | sdead
        clen = torch.where(dead, 0.0, clen)
        near = torch.linalg.vector_norm(pos - tbh.position, dim=-1) \
            < 5.0 * tbh.radius
        calm &= ~(((clen > 50.0) | near) & (s <= seg))
        pos, dirn = pos + nd * clen[:, None], nd
    return h.hit.numpy(), calm.numpy()


def _calm_weights(ts, trays, tbh, n_out, seed):
    """Seeded weights (n, n_out), zero on the lanes that are chaotic up to
    their winning chord and on misses."""
    _, calm = _calm_hits(ts, tbh, trays)
    assert calm.sum() >= 50, int(calm.sum())
    w = np.random.default_rng(seed).normal(size=(calm.shape[0], n_out))
    return (w * calm[:, None]).astype(np.float32)


def _assert_hole_grads(tg, jg, rtol):
    for name, a, b in zip(("position", "radius", "delta_theta"), tg, jg):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol,
                                   atol=rtol * np.abs(b).max(), err_msg=name)


def test_hole_grads_of_trace_diff_match_jax():
    """d/d(hole) of a weighted sum of trace_diff's hit points."""
    js, jbh, jrays, ts, tbh, trays, _ = _setup(curved=True)
    w = _calm_weights(ts, trays, tbh, 3, 1)

    def jf(pos, r, dt):
        h = jtrace.trace_diff(js, jbh.replace(position=pos, radius=r,
                                              delta_theta=dt),
                              jrays, n_seg=N_SEG, backend="xla")
        return jnp.sum(jnp.where(h.hit[:, None], h.p, 0.0) * w)
    jg = jax.grad(jf, argnums=(0, 1, 2))(jbh.position, jbh.radius,
                                         jbh.delta_theta)
    leaves = _hole_leaves(tbh)
    h = ttrace.trace_diff(ts, _hole(leaves, tbh), trays,
                          tables=tk.build_tables(ts, tbh))
    loss = torch.sum(torch.where(h.hit[:, None], h.p, 0.0)
                     * torch.tensor(w))
    _assert_hole_grads(torch.autograd.grad(loss, leaves), jg, HOLE_RTOL)


def test_hole_grads_of_normal_render_match_jax():
    """d/d(hole) of a weighted sum of a curved Illum.NORMAL render."""
    js, jbh, jrays, ts, tbh, trays, cfg = _setup(curved=True,
                                                 illum=Illum.NORMAL)
    w = _calm_weights(ts, trays, tbh, 3, 2)
    jp = jdiff.params_from_scene(js, jbh)
    jcfg = jax_config(cfg)

    def jf(pos, r, dt):
        p = jp.replace(bh_position=pos, bh_radius=r, bh_delta_theta=dt)
        return jnp.sum(jdiff.render_radiance(p, js, jbh, jrays, jcfg,
                                             jax.random.key(0)) * w)
    jg = jax.grad(jf, argnums=(0, 1, 2))(jp.bh_position, jp.bh_radius,
                                         jp.bh_delta_theta)
    tp = diff.params_from_arrays(convert.to_arrays(jp), "cpu")
    leaves = _hole_leaves(tbh)
    tp = tp.replace(bh_position=leaves[0], bh_radius=leaves[1],
                    bh_delta_theta=leaves[2])
    img = diff.render_radiance(tp, ts, tbh, trays, cfg, prng.key(0))
    loss = torch.sum(img * torch.tensor(w))
    _assert_hole_grads(torch.autograd.grad(loss, leaves), jg, HOLE_RTOL)


def test_hole_grads_of_gi_render_match_jax(monkeypatch):
    """d/d(hole) of a weighted sum of a curved depth-2 global-illumination
    render (the radius loop's integrator: NEE, a BSDF bounce, NEE), both
    packages under key 5, rays on the box. Weighted are the lanes
    whose radiance agrees between the packages (a shadow ray or a hit can
    round the other way) and whose replayed traces are calm up to their
    hits."""
    js, jbh, jrays, ts, tbh, trays, cfg = _setup(
        curved=True, n=1024, span=(0.35, 0.65), ns_area_light=1)
    n = trays.o.shape[0]
    key = jax.random.key(5)
    jp = jdiff.params_from_scene(js, jbh)
    jcfg = jax_config(cfg)
    jimg, jvjp = jax.vjp(
        lambda pos, r, dt: jdiff.render_radiance(
            jp.replace(bh_position=pos, bh_radius=r, bh_delta_theta=dt),
            js, jbh, jrays, jcfg, key),
        jp.bh_position, jp.bh_radius, jp.bh_delta_theta)

    replayed = []

    def recorded(scene, bh, rays, **kw):
        replayed.append((rays.o.detach(), rays.d.detach()))
        return trace_diff(scene, bh, rays, **kw)
    trace_diff = ttrace.trace_diff
    monkeypatch.setattr(ttrace, "trace_diff", recorded)
    tp = diff.params_from_arrays(convert.to_arrays(jp), "cpu")
    leaves = _hole_leaves(tbh)
    tp = tp.replace(bh_position=leaves[0], bh_radius=leaves[1],
                    bh_delta_theta=leaves[2])
    img = diff.render_radiance(tp, ts, tbh, trays, cfg, prng.key(5))

    jimg = np.asarray(jimg)
    calm = np.isclose(img.detach().numpy(), jimg, rtol=1e-4,
                      atol=1e-6).all(-1) & (jimg.sum(-1) > 0)
    assert len(replayed) == 2           # the camera and the bounce
    with torch.no_grad():
        for o, d in replayed:
            hit, calm_hit = _calm_hits(ts, tbh, Rays(
                o=o, d=d, min_t=torch.zeros(n), max_t=torch.full((n,), 1e9)))
            calm &= calm_hit | ~hit     # a missed bounce adds nothing
    assert calm.sum() >= 50, int(calm.sum())
    w = (np.random.default_rng(3).normal(size=(n, 3))
         * calm[:, None]).astype(np.float32)
    jg = jvjp(jnp.asarray(w))
    loss = torch.sum(img * torch.tensor(w))
    _assert_hole_grads(torch.autograd.grad(loss, leaves), jg, HOLE_RTOL)


def _emissive(js):
    """The JAX scene with the ceiling's material turned into an emission
    BSDF of radiance (2, 2, 2): the in-repo box is lit by an area light
    only, and hemisphere sampling sees emissive geometry only."""
    top = np.asarray(js.tri_v0)[:, 1].copy()
    top[np.asarray(js.tri_bsdf) < 0] = -np.inf
    row = int(np.asarray(js.tri_bsdf)[np.argmax(top)])
    b = js.bsdfs
    return js.replace(bsdfs=b.replace(
        kind=b.kind.at[row].set(BSDF_EMISSION),
        emission=b.emission.at[row].set(2.0))), row


@pytest.mark.parametrize("hemi", [False, True], ids=["importance", "hemi"])
def test_material_grads_of_direct_render_match_jax(hemi):
    """d/d(reflectance, emission, light radiance) of a weighted sum of a
    flat Illum.DIRECT render, both packages under key 5."""
    js, jbh, jrays, ts, tbh, trays, cfg = _setup(
        curved=False, illum=Illum.DIRECT, direct_hemisphere_sample=hemi,
        ns_area_light=4 if hemi else 2)
    js, _ = _emissive(js)
    ts = convert.scene_from_arrays(convert.to_arrays(js), "cpu")
    n = trays.o.shape[0]
    w = np.random.default_rng(4).normal(size=(n, 3)).astype(np.float32)
    key = jax.random.key(5)
    jp = jdiff.params_from_scene(js, None)
    jcfg = jax_config(cfg)
    jg = jax.grad(lambda p: jnp.sum(jdiff.render_radiance(
        p, js, None, jrays, jcfg, key) * w))(jp)

    tp = diff.params_from_arrays(convert.to_arrays(jp), "cpu")
    leaves = [x.detach().requires_grad_(True) for x in tp.leaves()]
    img = diff.render_radiance(diff.SceneParams.from_leaves(leaves), ts,
                               None, trays, cfg, prng.key(5))
    grads = torch.autograd.grad(torch.sum(img * torch.tensor(w)), leaves,
                                allow_unused=True)
    tg = diff.SceneParams.from_leaves(grads)
    names = ("reflectance", "emission") if hemi else ("reflectance",
                                                      "light_radiance")
    for name in names:
        a, b = getattr(tg, name).numpy(), np.asarray(getattr(jg, name))
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=MATERIAL_RTOL,
                                   atol=MATERIAL_RTOL * np.abs(b).max(),
                                   err_msg=name)
