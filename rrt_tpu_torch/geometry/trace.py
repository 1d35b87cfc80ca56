"""Closest-hit and shadow queries (the port of `rrt_tpu/geometry/trace.py`).

Both go through the traversal kernel (`ops/trace_kernel.trace_rays`): on
CUDA tensors the hand-written kernel, on CPU tensors its plain version.
Curved mode (a black hole given and enabled) keeps the reference's
semantics (bvh.cpp:103-113): each chord carries its own [0, len] range, so
the rays' min_t/max_t are ignored; absorption beats same-segment geometry;
a full 2π march without an event is an escape. Flat mode honours
[min_t, max_t].

`trace_diff` is the differentiable closest hit: the kernel decides the
discrete structure (which primitive, on which chord) without autograd,
then the winning chord and the winning primitive's intersection are
re-derived from the live parameters in plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from rrt_tpu_torch.geometry.intersect import (build_hit, sphere_intersect,
                                              tri_intersect)
from rrt_tpu_torch.ops.trace_kernel import (TraceTables, build_tables,
                                            kernel_trace)
from rrt_tpu_torch.physics.schwarzschild import grad_guard, micro_step
from rrt_tpu_torch.types import BlackHoleParams, Rays, SceneData

# chords longer than this are wrapped (u ≤ 0 teleport) or about to be
CHAOS_CHORD = 50.0


def trace(scene: SceneData, bh: Optional[BlackHoleParams], rays: Rays,
          return_stats: bool = False, occlusion: bool = False,
          tables: Optional[TraceTables] = None):
    """First event of every ray. Returns Hit, plus the summed (2,)
    [primitive tests, bbox tests] with `return_stats`. `occlusion=True`
    is the any-hit mode: the hit bool is exact, the rest of Hit is that
    of some hit on the first hitting chord. `tables` are
    `build_tables(scene, bh)`, which fix the mode and the chord count;
    they are made here when not given."""
    tab = build_tables(scene, bh) if tables is None else tables
    return kernel_trace(scene, tab, rays, occlusion=occlusion,
                        return_stats=return_stats)


def trace_with_seg(scene: SceneData, bh: Optional[BlackHoleParams],
                   rays: Rays, tables: Optional[TraceTables] = None):
    """Closest hit, the winning chord index of every ray (n_seg when there
    is no event, 0 for a flat hit) and the summed (2,) work counters."""
    tab = build_tables(scene, bh) if tables is None else tables
    return kernel_trace(scene, tab, rays, return_seg=True, return_stats=True)


def _replay(o, d, bh: BlackHoleParams, sgc, n_seg: int):
    """The march of (o, d) replayed under autograd for n_seg chords; each
    lane's chord number `sgc` gives its (origin, direction). A profiler
    sees it as the range "trace_diff.replay"."""
    with torch.profiler.record_function("trace_diff.replay"):
        pos, dirn = o, d
        dead = torch.zeros(sgc.shape, dtype=torch.bool, device=sgc.device)
        so, sd = pos, dirn
        for s in range(n_seg):
            nd, clen, sdead = micro_step(pos, dirn, bh)
            wrapped = clen.detach() > CHAOS_CHORD
            nd = torch.where(wrapped[..., None], nd.detach(), nd)
            clen = torch.where(wrapped, clen.detach(), clen)
            nd, clen = grad_guard(nd), grad_guard(clen)
            dead = dead | sdead
            win = (sgc == s)[..., None]
            so = torch.where(win, pos, so)
            sd = torch.where(win, nd, sd)
            clen = torch.where(dead | (s >= sgc), 0.0, clen)
            pos, dirn = grad_guard(pos + nd * clen[..., None]), nd
        return so, sd


def trace_diff(scene: SceneData, bh: Optional[BlackHoleParams], rays: Rays,
               tables: Optional[TraceTables] = None,
               return_stats: bool = False):
    """Differentiable closest hit: the kernel's discrete primal, then the
    continuous payload re-derived under autograd.

    The winning primitive and chord come from `trace_with_seg` under
    `no_grad`. In curved mode the march is then
    replayed for the tables' n_seg chords with `micro_step` on the live
    hole parameters, keeping the winning chord's (o, d). A lane is frozen
    past its winning chord (marching an absorbed lane on would integrate
    u = 1/d to infinity inside the horizon, and inf forward values NaN
    the backward pass even under zero cotangents); a wrapped chord
    (length > 50) passes its value on but not its gradient; the chord's
    direction, length and end pass through `grad_guard`. Only the ONE
    winning triangle or sphere is re-intersected, differentiably.
    Visibility gradients are out of scope, as in the JAX package
    (rrt_tpu/geometry/trace.py:662-756). Returns Hit, plus the kernel's
    summed (2,) work counters with `return_stats`."""
    tab = build_tables(scene, bh) if tables is None else tables
    with torch.no_grad():
        h0, seg, stats = trace_with_seg(scene, bh, rays, tab)
    hitm, prim = h0.hit, h0.prim_id
    shape = hitm.shape

    if tab.curved:
        so, sd = _replay(rays.o, rays.d, bh,
                         torch.clamp(seg, 0, tab.n_seg - 1), tab.n_seg)
    else:
        so, sd = rays.o, rays.d

    n_t = scene.n_tris
    is_tri = hitm & (prim >= 0) & (prim < n_t)
    is_sph = hitm & (prim >= n_t)
    tid = torch.clamp(prim, 0, n_t - 1).long()
    sid = torch.clamp(prim - n_t, 0, scene.n_spheres - 1).long()
    inf = torch.full(shape, math.inf, dtype=so.dtype, device=so.device)
    _, tT, b1, b2 = tri_intersect(
        so, sd, -inf, inf, scene.tri_v0[tid][..., None, :],
        scene.tri_v1[tid][..., None, :], scene.tri_v2[tid][..., None, :],
        torch.ones(shape + (1,), dtype=torch.bool, device=so.device))
    _, tS = sphere_intersect(so, sd, torch.zeros_like(inf), inf,
                             scene.sph_center[sid][..., None, :],
                             scene.sph_radius[sid][..., None])
    t = torch.where(is_tri, tT[..., 0], torch.where(is_sph, tS[..., 0], 0.0))
    b1 = torch.clamp(torch.where(is_tri, b1[..., 0], 0.0), 0.0, 1.0)
    b2 = torch.clamp(torch.where(is_tri, b2[..., 0], 0.0), 0.0, 1.0)
    b2 = torch.minimum(b2, 1.0 - b1)
    h = build_hit(scene, so, sd, hitm, t, prim, b1, b2)
    return (h, stats) if return_stats else h


def occluded(scene: SceneData, bh: Optional[BlackHoleParams], rays: Rays,
             return_stats: bool = False,
             tables: Optional[TraceTables] = None):
    """Shadow query: does the ray hit anything? In curved mode the shadow
    ray's distance to the light is ignored (chords carry their own
    ranges) and a path absorbed by the hole is not occluded
    (bvh.cpp:107-108), as in the reference. Occlusion is a bool, so the
    query never enters autograd."""
    with torch.no_grad():
        out = trace(scene, bh, rays, return_stats=return_stats,
                    occlusion=True, tables=tables)
    if return_stats:
        h, st = out
        return h.hit, st
    return out.hit
