"""Wavefront path-tracing integrator (the port of
`rrt_tpu/render/integrator.py`).

The reference's per-pixel recursion (part1_code.cpp:15-123) becomes an
iterative wavefront over a flat lane batch: every path vertex shades all
lanes in lockstep, traces one batched shadow query per chunk of
(light, sample) pairs and one batched bounce, and carries (L, β, alive)
to the next vertex. Russian roulette continues with probability 0.7, is
skipped at the first vertex, and its 1/0.7 weight is applied there too,
as the reference does. Delta BSDFs pick up the next hit's emission. A
camera ray that misses takes the environment map's radiance along its
original direction, when the scene has one.

With `cfg.differentiable` every closest-hit query goes through
`trace_diff` (the kernel's primal, the continuous payload re-derived under
autograd); shadow queries and the hemisphere-direct trace, which yield
only masks and material ids, go through the kernel outside autograd.
Gradients reach the materials, the light radiance and the hole through
the continuous factors; discrete decisions carry none.

Random numbers come from the caller's `torch.Generator`, drawn in a fixed
order per vertex: light samples, the roulette coin, the BSDF sample.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from rrt_tpu_torch.geometry import trace as tracer
from rrt_tpu_torch.ops.trace_kernel import TraceTables
from rrt_tpu_torch.render import bsdf as bsdflib
from rrt_tpu_torch.render import lights as lightlib
from rrt_tpu_torch.scene import envmap as envlib
from rrt_tpu_torch.types import BlackHoleParams, Hit, Rays, SceneData
from rrt_tpu_torch.utils import math3d as m3
from rrt_tpu_torch.utils.config import Illum, RenderConfig

PI = math.pi
RR_PROB = 0.7  # Russian roulette continue probability (part1_code.cpp:82)


@dataclasses.dataclass
class TraceWork:
    """Traversal work of the traces an estimate made: the summed
    [primitive tests, bbox tests] and the number of trace calls."""

    tests: torch.Tensor    # (2,) float64
    calls: int = 0

    def __add__(self, other: "TraceWork") -> "TraceWork":
        return TraceWork(self.tests + other.tests, self.calls + other.calls)


def _no_work(device) -> TraceWork:
    return TraceWork(torch.zeros(2, dtype=torch.float64, device=device))


def _uniform(gen: torch.Generator, shape, like: torch.Tensor):
    return torch.rand(shape, generator=gen, dtype=like.dtype,
                      device=like.device)


def _trace(scene, bh, tab: TraceTables, rays, cfg: RenderConfig,
           occlusion=False, discrete=False):
    """One batched query; returns (Hit or hit bool, TraceWork). Under
    `cfg.differentiable` a closest hit is `trace_diff`'s, unless only its
    `discrete` part (hit mask, material id) is used."""
    if occlusion:
        hit, st = tracer.occluded(scene, bh, rays, return_stats=True,
                                  tables=tab)
    elif cfg.differentiable and not discrete:
        hit, st = tracer.trace_diff(scene, bh, rays, tables=tab,
                                    return_stats=True)
    else:
        with torch.no_grad():
            hit, st = tracer.trace(scene, bh, rays, return_stats=True,
                                   tables=tab)
    return hit, TraceWork(st, 1 if rays.min_t.numel() else 0)


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


def light_samples(scene: SceneData, hit: Hit, cfg: RenderConfig,
                  gen: torch.Generator) -> list:
    """The (light, sample) draws of one vertex's NEE, in order: per
    light, 1 (delta) or ns_area_light samples."""
    samples = []
    for li in range(scene.lights.kind.shape[0]):
        ns = 1 if lightlib.is_delta_light(scene.lights, li) \
            else cfg.ns_area_light
        for _ in range(ns):
            xi = _uniform(gen, hit.t.shape + (2,), hit.p)
            samples.append(lightlib.sample_light(
                scene.lights, li, hit.p, xi, scene.env,
                cfg.env_importance_sampling))
    return samples


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


def direct_lighting_importance(scene: SceneData, bh, tab: TraceTables,
                               hit: Hit, cfg: RenderConfig,
                               gen: torch.Generator):
    """estimate_direct_lighting_importance (part1_code.cpp:33-57): the
    (light, sample) axis of `light_samples` is stacked and traced in
    chunks of at most cfg.nee_chunk, one shadow query per chunk."""
    if scene.lights.kind.shape[0] == 0:
        return torch.zeros_like(hit.p), _no_work(hit.p.device)
    frames = _frames(hit)
    wo = m3.to_local(*frames, hit.w_out)
    samples = light_samples(scene, hit, cfg, gen)
    total = len(samples)

    L = torch.zeros_like(hit.p)
    work = _no_work(hit.p.device)
    c = max(1, cfg.nee_chunk)
    for start in range(0, total, c):
        chunk = samples[start:start + c]
        wi_l, facing, shadow = shadow_rays(bh, hit, frames, chunk, cfg)
        occ, w = _trace(scene, bh, tab, shadow, cfg, occlusion=True)
        work = work + w
        rad = torch.stack([s.radiance for s in chunk])
        pdf = torch.stack([s.pdf for s in chunk])
        f_val = bsdflib.evaluate(scene.bsdfs, hit.bsdf_id[None], wo[None],
                                 wi_l)
        contrib = rad * f_val * wi_l[..., 2:3] / pdf[..., None]
        ok = (facing & ~occ & hit.hit[None])[..., None]
        L = L + torch.sum(torch.where(ok, contrib, 0.0), dim=0)
    return L / total, work


def direct_lighting_hemisphere(scene: SceneData, bh, tab: TraceTables,
                               hit: Hit, cfg: RenderConfig,
                               gen: torch.Generator):
    """estimate_direct_lighting_hemisphere (part1_code.cpp:15-31): uniform
    hemisphere directions, the emission of whatever they hit."""
    n_lights = scene.lights.kind.shape[0]
    num = max(n_lights * cfg.ns_area_light, 1)
    fx, fy, fz = _frames(hit)
    wo = m3.to_local(fx, fy, fz, hit.w_out)
    shape = hit.t.shape
    xi = _uniform(gen, (num,) + shape + (2,), hit.p)
    theta = torch.acos(xi[..., 0])
    phi = 2.0 * PI * xi[..., 1]
    wi_l = torch.stack([torch.sin(theta) * torch.cos(phi),
                        torch.sin(theta) * torch.sin(phi),
                        torch.cos(theta)], dim=-1)
    wi_w = m3.to_world(fx[None], fy[None], fz[None], wi_l)
    rays = Rays(o=hit.p[None] + cfg.ray_eps * wi_w, d=wi_w,
                min_t=torch.zeros((num,) + shape, device=hit.p.device),
                max_t=torch.full((num,) + shape, math.inf,
                                 device=hit.p.device))
    # only h2.hit and h2.bsdf_id are used; the emission gather reads the
    # live material table
    h2, work = _trace(scene, bh, tab, rays, cfg, discrete=True)
    emit = bsdflib.emission(scene.bsdfs, h2.bsdf_id)
    f_val = bsdflib.evaluate(scene.bsdfs, hit.bsdf_id[None], wo[None], wi_l)
    contrib = emit * f_val * wi_l[..., 2:3]
    ok = (h2.hit & hit.hit[None])[..., None]
    return (torch.sum(torch.where(ok, contrib, 0.0), dim=0) * 2.0 * PI / num,
            work)


def _direct(scene, bh, tab, hit, cfg, gen):
    if cfg.direct_hemisphere_sample:
        return direct_lighting_hemisphere(scene, bh, tab, hit, cfg, gen)
    return direct_lighting_importance(scene, bh, tab, hit, cfg, gen)


def est_radiance(scene: SceneData, bh: Optional[BlackHoleParams],
                 rays: Rays, cfg: RenderConfig, gen: torch.Generator,
                 tab: TraceTables):
    """est_radiance_global_illumination (part1_code.cpp:103-123) for a
    flat batch of camera rays, traced through `tab` =
    `build_tables(scene, bh)`. Returns ((..., 3) radiance, TraceWork)."""
    hit, work = _trace(scene, bh, tab, rays, cfg)
    L = torch.zeros_like(rays.d)
    if scene.env is not None:          # along the ORIGINAL direction
        L = torch.where(hit.hit[..., None], 0.0,
                        envlib.sample_dir(scene.env, rays.d))

    if cfg.illum == Illum.NORMAL:
        # normal_shading(isect.n): the raw interpolated normal
        return torch.where(hit.hit[..., None], hit.n * 0.5 + 0.5, L), work

    if cfg.illum == Illum.DIRECT:
        Ld, w = _direct(scene, bh, tab, hit, cfg, gen)
        return L + Ld, work + w

    md = cfg.max_ray_depth
    if cfg.illum == Illum.FULL:
        L = L + bsdflib.emission(scene.bsdfs, hit.bsdf_id)   # zero bounce
        if md == 0:
            return L, work

    beta = torch.ones_like(rays.d)
    alive = hit.hit

    def vertex(L, beta, alive, hit, work, first, do_bounce, rr):
        """One path vertex: NEE, then optionally a (roulette) bounce."""
        delta = bsdflib.is_delta(scene.bsdfs, hit.bsdf_id)
        if not (first and cfg.illum == Illum.INDIRECT):
            nee, w = _direct(scene, bh, tab, hit, cfg, gen)
            L = L + torch.where((alive & ~delta)[..., None], beta * nee, 0.0)
            work = work + w
        if not do_bounce:
            return L, beta, alive, hit, work
        cont = alive
        if rr:
            cont = cont & (_uniform(gen, alive.shape, hit.t) < RR_PROB)
        fx, fy, fz = _frames(hit)
        wo = m3.to_local(fx, fy, fz, hit.w_out)
        shape = hit.t.shape
        smp = bsdflib.sample(scene.bsdfs, hit.bsdf_id, wo,
                             _uniform(gen, shape + (2,), hit.t),
                             _uniform(gen, shape + (2,), hit.t),
                             _uniform(gen, shape, hit.t),
                             microfacet_hemi=cfg.microfacet_hemi)
        cont = cont & (smp.pdf > 0)
        wi_w = m3.to_world(fx, fy, fz, smp.wi)
        nxt = Rays(o=hit.p + cfg.ray_eps * wi_w, d=wi_w,
                   min_t=torch.zeros_like(hit.t),
                   max_t=torch.full_like(hit.t, math.inf))
        h2, w = _trace(scene, bh, tab, _mask_rays(nxt, cont, bh), cfg)
        work = work + w
        cont = cont & h2.hit
        wt = smp.value * (torch.abs(smp.wi[..., 2:3])
                          / torch.clamp(smp.pdf, min=1e-30)[..., None]) \
            / RR_PROB
        beta2 = beta * wt
        emit2 = bsdflib.emission(scene.bsdfs, h2.bsdf_id)
        L = L + torch.where((cont & delta)[..., None], beta2 * emit2, 0.0)
        return L, torch.where(cont[..., None], beta2, beta), cont, h2, work

    # vertex d = md: NEE + an unconditional bounce (when md ≥ 2)
    state = vertex(L, beta, alive, hit, work, first=True,
                   do_bounce=md >= 2, rr=False)
    # vertices d = md-1 .. 2: NEE + a roulette bounce
    for _ in range(md - 2):
        state = vertex(*state, first=False, do_bounce=True, rr=True)
    # final vertex d = 1: NEE only
    if md >= 2:
        state = vertex(*state, first=False, do_bounce=False, rr=False)
    return state[0], state[4]
