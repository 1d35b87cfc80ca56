"""Closest-hit, shadow and differentiable queries over the plain
traversal: a frozen copy of the port's `rrt_tpu_torch/geometry/trace.py`
without its sharded route. Curved mode keeps the reference's semantics
(bvh.cpp:103-113); `trace_diff` takes the discrete primal from the
traversal and re-derives the winning chord and primitive under autograd.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from cardbench.ref.intersect import (build_hit, sphere_intersect,
                                              tri_intersect)
from cardbench.ref.traverse import (TraceTables, build_tables,
                                            kernel_trace)
from cardbench.ref.schwarzschild import grad_guard, micro_step
from cardbench.ref.precision import q
from cardbench.ref.types import BlackHoleParams, Hit, Rays, SceneData

# chords longer than this are wrapped (u ≤ 0 teleport) or about to be
CHAOS_CHORD = 50.0


def trace(scene: SceneData, bh: Optional[BlackHoleParams], rays: Rays,
          occlusion: bool = False, tables: Optional[TraceTables] = None):
    """First event of every ray, as a Hit. `occlusion=True` is the any-hit
    mode: the hit bool is exact, the rest of Hit is that
    of some hit on the first hitting chord. `tables` are
    `build_tables(scene, bh)`, which fix the mode and the chord count;
    they are made here when not given."""
    tab = build_tables(scene, bh) if tables is None else tables
    return kernel_trace(scene, tab, rays, occlusion=occlusion)


def trace_with_seg(scene: SceneData, bh: Optional[BlackHoleParams],
                   rays: Rays, tables: Optional[TraceTables] = None):
    """Closest hit and the winning chord index of every ray (n_seg when
    there is no event, 0 for a flat hit)."""
    tab = build_tables(scene, bh) if tables is None else tables
    return kernel_trace(scene, tab, rays, return_seg=True)


def _replay(o, d, bh: BlackHoleParams, sgc, n_seg: int):
    """The march of (o, d) replayed under autograd for n_seg chords; each
    lane's chord number `sgc` gives its (origin, direction)."""
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
               tables: Optional[TraceTables] = None):
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
    (rrt_tpu/geometry/trace.py:662-756). Returns the Hit."""
    tab = build_tables(scene, bh) if tables is None else tables
    with torch.no_grad():
        h0, seg = trace_with_seg(scene, bh, rays, tab)
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
    h = Hit(**{f.name: q(getattr(h, f.name)) for f in dataclasses.fields(h)})
    return h


def occluded(scene: SceneData, bh: Optional[BlackHoleParams], rays: Rays,
             tables: Optional[TraceTables] = None):
    """Shadow query: does the ray hit anything? In curved mode the shadow
    ray's distance to the light is ignored (chords carry their own
    ranges) and a path absorbed by the hole is not occluded
    (bvh.cpp:107-108), as in the reference. Occlusion is a bool, so the
    query never enters autograd."""
    with torch.no_grad():
        return trace(scene, bh, rays, occlusion=True, tables=tables).hit
