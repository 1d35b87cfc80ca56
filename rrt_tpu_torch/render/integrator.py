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

Random numbers come from the caller's threefry key (`utils.prng`),
split as the JAX package splits it (rrt_tpu/render/integrator.py:116,
194, 253, 277, 291, 319-345): one key for the first vertex, one split
into a key per scanned vertex, one for the last; at each vertex one key
each for the light samples, the roulette coin and the BSDF sample. So the
port draws the JAX package's uniforms on any device, and the functions
that take uniforms (`lights.sample_light`, `bsdf.sample`,
`envmap.sample_L`) get them from the key here. With `lanes` = (lo, hi,
n) the rays are the lanes [lo, hi) of a batch of n (a rank's block of a
sharded batch), and every draw computes only its block of the whole
batch's draw (`prng.uniform(window=)`), so that the blocks equal the
whole batch's estimate. With `mesh=` every trace runs over the mesh's
ranks (`geometry.trace`), each rank holding the whole batch.

`Forward` is `est_radiance` of one batch as a compiled call, a CUDA
graph on a card (the counterpart of the JAX package's jitted forward);
with a mesh over NCCL its per-trace collectives are inside the graph.
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
from rrt_tpu_torch.types import (LIGHT_ENV, BlackHoleParams, Hit, Rays,
                                 SceneData)
from rrt_tpu_torch.utils import math3d as m3
from rrt_tpu_torch.utils import prng, stats
from rrt_tpu_torch.utils.config import Illum, RenderConfig
from rrt_tpu_torch.utils.graphs import CapturedCall, run_call

PI = math.pi
RR_PROB = 0.7  # Russian roulette continue probability (part1_code.cpp:82)


@dataclasses.dataclass
class TraceWork:
    """Work of an estimate: the traces' summed [primitive tests, bbox
    tests], the number of trace calls, the live lanes entering each
    vertex (0-d float64 tensors, in vertex order) and the lanes its
    vertices ran (the widths of their batches, summed)."""

    tests: torch.Tensor    # (2,) float64
    calls: int = 0
    live: list = dataclasses.field(default_factory=list)
    run: int = 0

    def __add__(self, other: "TraceWork") -> "TraceWork":
        return TraceWork(self.tests + other.tests, self.calls + other.calls,
                         self.live + other.live, self.run + other.run)

    def entering(self, alive: torch.Tensor) -> "TraceWork":
        """This work with a vertex entered by the lanes `alive`."""
        return dataclasses.replace(
            self, live=self.live + [alive.sum(dtype=torch.float64)],
            run=self.run + alive.numel())


def _no_work(device) -> TraceWork:
    return TraceWork(torch.zeros(2, dtype=torch.float64, device=device))


def lane_uniform(key, shape, lanes=None, axis: int = 0):
    """`prng.uniform(key, shape)`; with `lanes` = (lo, hi, n), `shape`'s
    axis `axis` holds the lanes [lo, hi) of a batch of n, and the result
    is that block of the batch's draw."""
    if lanes is None:
        return prng.uniform(key, shape)
    lo, hi, n = lanes
    if shape[axis] != hi - lo:
        raise ValueError(f"lane axis {axis} of {tuple(shape)} is not the "
                         f"lanes [{lo}, {hi})")
    whole = list(shape)
    whole[axis] = n
    return prng.uniform(key, whole, window=(axis, lo, hi))


def _trace(scene, bh, tab: TraceTables, rays, cfg: RenderConfig,
           occlusion=False, discrete=False, mesh=None):
    """One batched query; returns (Hit or hit bool, TraceWork). Under
    `cfg.differentiable` a closest hit is `trace_diff`'s, unless only its
    `discrete` part (hit mask, material id) is used."""
    if occlusion:
        hit, st = tracer.occluded(scene, bh, rays, return_stats=True,
                                  tables=tab, mesh=mesh)
    elif cfg.differentiable and not discrete:
        hit, st = tracer.trace_diff(scene, bh, rays, tables=tab,
                                    return_stats=True, mesh=mesh)
    else:
        with torch.no_grad():
            hit, st = tracer.trace(scene, bh, rays, return_stats=True,
                                   tables=tab, mesh=mesh)
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


def light_samples(scene: SceneData, hit: Hit, cfg: RenderConfig, key,
                  lanes=None) -> list:
    """The (light, sample) draws of one vertex's NEE, in order: per
    light, 1 (delta) or ns_area_light samples, each from its own key
    (`key, k = split(key)`, rrt_tpu/render/integrator.py:116). A draw's
    uniforms are the JAX package's `sample_light`'s from k: (..., 2) of
    k for the hemisphere, area and importance-sampled environment lights,
    made in one launch for all of them (rrt_tpu/render/lights.py:66,
    108; scene/envmap.py:130); (z, φ) from the two keys of split(k) for
    the uniformly sampled environment (lights.py:138-140); none for a
    delta light."""
    lights, shape = scene.lights, hit.t.shape
    keys = []
    for li in range(lights.kind.shape[0]):
        ns = 1 if lightlib.is_delta_light(lights, li) else cfg.ns_area_light
        for _ in range(ns):
            key, k = prng.split(key)
            keys.append((li, k))
    pairs = [i for i, (li, _) in enumerate(keys)
             if not lightlib.is_delta_light(lights, li)
             and not (lights.kind_host[li] == LIGHT_ENV
                      and not cfg.env_importance_sampling)]
    xi = dict.fromkeys(range(len(keys)))
    if pairs:
        u = lane_uniform(torch.stack([keys[i][1] for i in pairs]),
                         shape + (2,), lanes)
        xi.update(zip(pairs, u))
    samples = []
    for i, (li, k) in enumerate(keys):
        if lights.kind_host[li] == LIGHT_ENV and xi[i] is None:
            zphi = lane_uniform(prng.split(k), shape, lanes)
            xi[i] = torch.stack([zphi[0], zphi[1]], dim=-1)
        samples.append(lightlib.sample_light(
            lights, li, hit.p, xi[i], scene.env, cfg.env_importance_sampling))
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
                               hit: Hit, cfg: RenderConfig, key, mesh=None,
                               lanes=None):
    """estimate_direct_lighting_importance (part1_code.cpp:33-57): the
    (light, sample) axis of `light_samples` is stacked and traced in
    chunks of at most cfg.nee_chunk, one shadow query per chunk."""
    if scene.lights.kind.shape[0] == 0:
        return torch.zeros_like(hit.p), _no_work(hit.p.device)
    frames = _frames(hit)
    wo = m3.to_local(*frames, hit.w_out)
    samples = light_samples(scene, hit, cfg, key, lanes)
    total = len(samples)

    L = torch.zeros_like(hit.p)
    work = _no_work(hit.p.device)
    c = max(1, cfg.nee_chunk)
    for start in range(0, total, c):
        chunk = samples[start:start + c]
        wi_l, facing, shadow = shadow_rays(bh, hit, frames, chunk, cfg)
        occ, w = _trace(scene, bh, tab, shadow, cfg, occlusion=True,
                        mesh=mesh)
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
                               hit: Hit, cfg: RenderConfig, key, mesh=None,
                               lanes=None):
    """estimate_direct_lighting_hemisphere (part1_code.cpp:15-31): uniform
    hemisphere directions, the emission of whatever they hit."""
    n_lights = scene.lights.kind.shape[0]
    num = max(n_lights * cfg.ns_area_light, 1)
    fx, fy, fz = _frames(hit)
    wo = m3.to_local(fx, fy, fz, hit.w_out)
    shape = hit.t.shape
    xi = lane_uniform(key, (num,) + shape + (2,), lanes, axis=1)
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
    h2, work = _trace(scene, bh, tab, rays, cfg, discrete=True, mesh=mesh)
    emit = bsdflib.emission(scene.bsdfs, h2.bsdf_id)
    f_val = bsdflib.evaluate(scene.bsdfs, hit.bsdf_id[None], wo[None], wi_l)
    contrib = emit * f_val * wi_l[..., 2:3]
    ok = (h2.hit & hit.hit[None])[..., None]
    return (torch.sum(torch.where(ok, contrib, 0.0), dim=0) * 2.0 * PI / num,
            work)


def _direct(scene, bh, tab, hit, cfg, key, mesh, lanes):
    direct = (direct_lighting_hemisphere if cfg.direct_hemisphere_sample
              else direct_lighting_importance)
    return direct(scene, bh, tab, hit, cfg, key, mesh, lanes)


def est_radiance(scene: SceneData, bh: Optional[BlackHoleParams],
                 rays: Rays, cfg: RenderConfig, key, tab: TraceTables,
                 mesh=None, lanes=None):
    """est_radiance_global_illumination (part1_code.cpp:103-123) for a
    flat batch of camera rays, traced through `tab` =
    `build_tables(scene, bh)`, with uniforms from the (2,) threefry `key`
    (moved to the rays' device). `lanes` = (lo, hi, n): the rays are the
    lanes [lo, hi) of a batch of n, and the draws that block of the
    batch's. With `mesh` every trace runs over its ranks. Returns ((...,
    3) radiance, TraceWork).

    Its device spans (`utils.stats`): "pass.camera_hit" (the camera rays'
    closest hit and the zero-bounce terms), then at every vertex
    "vertex.nee" (its keys, the light samples, the shadow rays' any-hit,
    the BSDF evaluations, the `L` update) and "vertex.bounce" (the rest:
    the roulette coin, `bsdf.sample`, the bounce's closest hit, β and the
    emission it picks up); the trace kernel's launches are spans of their
    own inside them. The lanes alive entering each vertex are counted
    into the `TraceWork`."""
    dev = rays.o.device
    key = key.to(dev)
    with stats.span("pass.camera_hit", dev):
        hit, work = _trace(scene, bh, tab, rays, cfg, mesh=mesh)
        L = torch.zeros_like(rays.d)
        if scene.env is not None:          # along the ORIGINAL direction
            L = torch.where(hit.hit[..., None], 0.0,
                            envlib.sample_dir(scene.env, rays.d))

        if cfg.illum == Illum.NORMAL:
            # normal_shading(isect.n): the raw interpolated normal
            return torch.where(hit.hit[..., None], hit.n * 0.5 + 0.5, L), \
                work
        if cfg.illum == Illum.FULL:
            L = L + bsdflib.emission(scene.bsdfs, hit.bsdf_id)  # zero bounce

    if cfg.illum == Illum.DIRECT:
        with stats.span("vertex.nee", dev):
            work = work.entering(hit.hit)
            key, k = prng.split(key)
            Ld, w = _direct(scene, bh, tab, hit, cfg, k, mesh, lanes)
            return L + Ld, work + w

    md = cfg.max_ray_depth
    if cfg.illum == Illum.FULL and md == 0:
        return L, work
    beta = torch.ones_like(rays.d)
    alive = hit.hit

    def vertex(L, beta, alive, hit, work, kk, first, do_bounce, rr):
        """One path vertex from its key kk: NEE, then optionally a
        (roulette) bounce."""
        with stats.span("vertex.nee", dev):
            work = work.entering(alive)
            k_nee, k_coin, k_bsdf = prng.split(kk, 3)
            delta = bsdflib.is_delta(scene.bsdfs, hit.bsdf_id)
            if not (first and cfg.illum == Illum.INDIRECT):
                nee, w = _direct(scene, bh, tab, hit, cfg, k_nee, mesh, lanes)
                L = L + torch.where((alive & ~delta)[..., None], beta * nee,
                                    0.0)
                work = work + w
        if not do_bounce:
            return L, beta, alive, hit, work
        with stats.span("vertex.bounce", dev):
            return bounce(L, beta, alive, hit, work, delta, k_coin, k_bsdf,
                          rr)

    def bounce(L, beta, alive, hit, work, delta, k_coin, k_bsdf, rr):
        """The vertex's roulette bounce, after its NEE."""
        cont = alive
        if rr:
            cont = cont & (lane_uniform(k_coin, alive.shape, lanes)
                           < RR_PROB)
        fx, fy, fz = _frames(hit)
        wo = m3.to_local(fx, fy, fz, hit.w_out)
        shape = hit.t.shape
        # bsdf.sample's three draws (rrt_tpu/render/bsdf.py:184-227):
        # the two (..., 2) in one launch
        k_xi = prng.split(k_bsdf, 3)
        xi = lane_uniform(k_xi[:2], shape + (2,), lanes)
        smp = bsdflib.sample(scene.bsdfs, hit.bsdf_id, wo, xi[0], xi[1],
                             lane_uniform(k_xi[2], shape, lanes),
                             microfacet_hemi=cfg.microfacet_hemi)
        cont = cont & (smp.pdf > 0)
        wi_w = m3.to_world(fx, fy, fz, smp.wi)
        nxt = Rays(o=hit.p + cfg.ray_eps * wi_w, d=wi_w,
                   min_t=torch.zeros_like(hit.t),
                   max_t=torch.full_like(hit.t, math.inf))
        h2, w = _trace(scene, bh, tab, _mask_rays(nxt, cont, bh), cfg,
                       mesh=mesh)
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
    key, k0 = prng.split(key)
    state = vertex(L, beta, alive, hit, work, k0, first=True,
                   do_bounce=md >= 2, rr=False)
    # vertices d = md-1 .. 2: NEE + a roulette bounce, a key each
    if md >= 3:
        key, ks = prng.split(key)
        for kk in prng.split(ks, md - 2):
            state = vertex(*state, kk, first=False, do_bounce=True, rr=True)
    # final vertex d = 1: NEE only
    if md >= 2:
        key, k_last = prng.split(key)
        state = vertex(*state, k_last, first=False, do_bounce=False,
                       rr=False)
    return state[0], state[4]


class Forward:
    """`est_radiance` of one batch as a compiled call: the port's
    counterpart of the JAX package's jitted forward, `jax.jit(lambda s, b,
    r: est_radiance(s, b, r, cfg, key, mesh=mesh))`
    (rrt_tpu/render/renderer.py:177-182, tools/scaling_bench.py:203-210).

    `rays` are the call's static buffers (copy new rays into them between
    calls), and so is `key`, the (2,) threefry key that a call copies its
    argument into. With `window` = (lo, hi, n) the rays are the lanes
    [lo, hi) of a batch of n, and the draws that block of the batch's
    (the block a rank of a sharded pass estimates). With `mesh` every
    trace runs over its ranks, its gather and its all-reduce inside the
    call.

    With `graphs` the call is a `CapturedCall`, made at the first call:
    the first call eager, the second captured and replayed, every later
    call a replay, the mesh's collectives inside the graph. Graphs are the
    default on a card, without a mesh or over NCCL; gloo runs its
    collectives on the host, so a forward over a gloo mesh runs eagerly,
    and one asked for graphs raises at its capture. A call returns
    (radiance, TraceWork); with graphs they are the graph's outputs,
    which the next call overwrites."""

    def __init__(self, scene: SceneData, bh: Optional[BlackHoleParams],
                 rays: Rays, cfg: RenderConfig, tab: TraceTables,
                 mesh=None, window=None, graphs: Optional[bool] = None):
        dev = rays.o.device
        if graphs and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
        self.graphs = (dev.type == "cuda" and (
            mesh is None or mesh.backend != "gloo")
            if graphs is None else bool(graphs))
        self.device, self.mesh = dev, mesh
        # the call reads the key buffer, not self: a forward dropped is
        # freed at once, its graph (and a graph's NCCL work) with it
        key = self.key = torch.zeros(2, dtype=torch.int64, device=dev)
        self.fn = lambda: est_radiance(scene, bh, rays, cfg, key, tab,
                                       mesh=mesh, lanes=window)
        self.call = None

    def __call__(self, key: torch.Tensor):
        """The forward under the (2,) threefry `key`."""
        if self.graphs and self.call is None:
            route = "per-trace sharded " if self.mesh is not None else ""
            self.call = CapturedCall(self.fn, self.device,
                                     name=f"the {route}forward")
        self.key.copy_(key)
        return run_call(self.call, self.fn)
