"""Wavefront path-tracing integrator over the plain traversal: a frozen
copy of the full global illumination of the port's
`rrt_tpu_torch/render/integrator.py` (the reference renderer's
est_radiance_global_illumination, part1_code.cpp:15-123) with
importance-sampled direct lighting, for the diffuse surfaces and area
lights that the configured scenes hold, without its sharded route and
its compiled forward.

Every path vertex shades all lanes in lockstep, traces one batched
shadow query per chunk of (light, sample) pairs and one batched bounce,
and carries (L, β, alive) to the next vertex; Russian roulette continues
with probability 0.7 from the second vertex on. No BSDF of these scenes
is a delta, so every vertex adds its NEE and no bounce adds the emission
it hits. The draws split the key tree of the program's integrator lane
by lane (`prng`): `lanes` = (idx, n) says which lane of its pass's draw
every lane is, so lanes of any pixels and passes estimate together what
the frame drew for them.

`precision.q` rounds the path's state (hits, throughput, radiance) where
a lower-precision estimator would store it; it is the identity unless
the control asks for bfloat16.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from cardbench.ref import trace as tracer
from cardbench.ref.traverse import TraceTables
from cardbench.ref import bsdf as bsdflib
from cardbench.ref import lights as lightlib
from cardbench.ref.types import BlackHoleParams, Hit, Rays, SceneData
from cardbench.ref import math3d as m3
from cardbench.ref import prng
from cardbench.ref.prng import lane_uniform
from cardbench.ref.config import RenderConfig
from cardbench.ref.precision import q

PI = math.pi
RR_PROB = 0.7  # Russian roulette continue probability (part1_code.cpp:82)


def _trace(scene, bh, tab: TraceTables, rays, cfg: RenderConfig,
           occlusion=False):
    """One batched query: the hit bool of a shadow query, else the Hit.
    Under `cfg.differentiable` a closest hit is `trace_diff`'s."""
    if occlusion:
        return tracer.occluded(scene, bh, rays, tables=tab)
    if cfg.differentiable:
        return tracer.trace_diff(scene, bh, rays, tables=tab)
    with torch.no_grad():
        return tracer.trace(scene, bh, rays, tables=tab)


def _mask_rays(rays: Rays, active, bh) -> Rays:
    """Inactive lanes become rays that end at once: origin at the hole's
    centre in curved mode (dead on segment 0), max_t < min_t in flat."""
    if bh is not None and bh.enabled:
        o = torch.where(active[..., None], rays.o,
                        torch.broadcast_to(bh.position, rays.o.shape))
        return rays.replace(o=o)
    return rays.replace(max_t=torch.where(active, rays.max_t, -1.0))


def _frames(hit: Hit):
    return m3.make_coord_space(hit.n)


def light_samples(scene: SceneData, hit: Hit, cfg: RenderConfig, key,
                  lanes=None) -> list:
    """The (light, sample) draws of one vertex's NEE, in order: per light,
    ns_area_light samples, each from its own key (`key, k = split(key)`,
    rrt_tpu/render/integrator.py:116), their (..., 2) uniforms made in
    one launch for all of them, as the program makes them."""
    lights, shape = scene.lights, hit.t.shape
    keys = []
    for li in range(lights.kind.shape[0]):
        for _ in range(cfg.ns_area_light):
            key, k = prng.split(key)
            keys.append((li, k))
    if not keys:
        return []
    u = lane_uniform(torch.stack([k for _, k in keys]), shape + (2,), lanes)
    return [lightlib.sample_light(lights, li, hit.p, xi)
            for (li, _), xi in zip(keys, u)]


def shadow_rays(bh, hit: Hit, frames, chunk: list, cfg: RenderConfig):
    """The shadow query of a chunk of light samples, stacked on a leading
    axis: returns (local directions, facing mask, masked rays). Lanes
    that miss or face away from the light end at once."""
    fx, fy, fz = frames
    wi_w = torch.stack([s.wi for s in chunk])
    dist = torch.stack([s.dist for s in chunk])
    wi_l = m3.to_local(fx[None], fy[None], fz[None], wi_w)
    facing = wi_l[..., 2] >= 0     # the reference skips w_in.z < 0
    rays = Rays(o=hit.p[None] + cfg.ray_eps * wi_w, d=wi_w,
                min_t=torch.zeros_like(dist), max_t=dist)
    return wi_l, facing, _mask_rays(rays, facing & hit.hit[None], bh)


def direct_lighting(scene: SceneData, bh, tab: TraceTables, hit: Hit,
                    cfg: RenderConfig, key, lanes=None):
    """estimate_direct_lighting_importance (part1_code.cpp:33-57): the
    (light, sample) axis of `light_samples` is stacked and traced in
    chunks of at most cfg.nee_chunk, one shadow query per chunk."""
    if scene.lights.kind.shape[0] == 0:
        return torch.zeros_like(hit.p)
    frames = _frames(hit)
    wo = m3.to_local(*frames, hit.w_out)
    samples = light_samples(scene, hit, cfg, key, lanes)
    total = len(samples)

    L = torch.zeros_like(hit.p)
    c = max(1, cfg.nee_chunk)
    for start in range(0, total, c):
        chunk = samples[start:start + c]
        wi_l, facing, shadow = shadow_rays(bh, hit, frames, chunk, cfg)
        occ = _trace(scene, bh, tab, shadow, cfg, occlusion=True)
        rad = torch.stack([s.radiance for s in chunk])
        pdf = torch.stack([s.pdf for s in chunk])
        f_val = bsdflib.evaluate(scene.bsdfs, hit.bsdf_id[None], wo[None],
                                 wi_l)
        contrib = rad * f_val * wi_l[..., 2:3] / pdf[..., None]
        ok = (facing & ~occ & hit.hit[None])[..., None]
        L = L + torch.sum(torch.where(ok, contrib, 0.0), dim=0)
    return q(L / total)


def est_radiance(scene: SceneData, bh: Optional[BlackHoleParams],
                 rays: Rays, cfg: RenderConfig, key, tab: TraceTables,
                 lanes=None):
    """est_radiance_global_illumination (part1_code.cpp:103-123) for a
    flat batch of camera rays, traced through `tab` =
    `build_tables(scene, bh)`, with uniforms from `key`, one (2,) key a
    lane, (m, 2). `lanes` = (idx, n): lane i is lane idx[i] of its pass's
    n lanes, and draws that lane's elements. Returns the (..., 3)
    radiance."""
    key = key.to(rays.o.device)
    hit = _trace(scene, bh, tab, rays, cfg)
    md = cfg.max_ray_depth
    L = bsdflib.emission(scene.bsdfs, hit.bsdf_id)       # zero bounce
    if md == 0:
        return L

    def vertex(L, beta, alive, hit, kk, do_bounce, rr):
        """One path vertex from its key kk: NEE, then optionally a
        (roulette) bounce."""
        k_nee, k_coin, k_bsdf = prng.split(kk, 3)
        nee = direct_lighting(scene, bh, tab, hit, cfg, k_nee, lanes)
        L = q(L + torch.where(alive[..., None], beta * nee, 0.0))
        if not do_bounce:
            return L, beta, alive, hit
        cont = alive
        if rr:
            cont = cont & (lane_uniform(k_coin, alive.shape, lanes)
                           < RR_PROB)
        fx, fy, fz = _frames(hit)
        wo = m3.to_local(fx, fy, fz, hit.w_out)
        # the first of bsdf.sample's three draws, the cosine lobe's
        # (rrt_tpu/render/bsdf.py:184-227)
        xi = lane_uniform(prng.split(k_bsdf, 3)[0], hit.t.shape + (2,),
                          lanes)
        smp = bsdflib.sample(scene.bsdfs, hit.bsdf_id, wo, xi)
        cont = cont & (smp.pdf > 0)
        wi_w = m3.to_world(fx, fy, fz, smp.wi)
        nxt = Rays(o=hit.p + cfg.ray_eps * wi_w, d=wi_w,
                   min_t=torch.zeros_like(hit.t),
                   max_t=torch.full_like(hit.t, math.inf))
        h2 = _trace(scene, bh, tab, _mask_rays(nxt, cont, bh), cfg)
        cont = cont & h2.hit
        wt = smp.value * (torch.abs(smp.wi[..., 2:3])
                          / torch.clamp(smp.pdf, min=1e-30)[..., None]) \
            / RR_PROB
        beta2 = q(beta * wt)
        return L, torch.where(cont[..., None], beta2, beta), cont, h2

    state = (L, torch.ones_like(rays.d), hit.hit, hit)
    # vertex d = md: NEE + an unconditional bounce (when md ≥ 2)
    key, k0 = prng.split(key)
    state = vertex(*state, k0, do_bounce=md >= 2, rr=False)
    # vertices d = md-1 .. 2: NEE + a roulette bounce, a key each
    if md >= 3:
        key, ks = prng.split(key)
        for kk in prng.split(ks, md - 2):
            state = vertex(*state, kk, do_bounce=True, rr=True)
    # final vertex d = 1: NEE only
    if md >= 2:
        key, k_last = prng.split(key)
        state = vertex(*state, k_last, do_bounce=False, rr=False)
    return state[0]
