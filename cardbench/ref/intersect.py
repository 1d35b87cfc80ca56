"""Primitive intersection: batched Möller–Trumbore and sphere tests, a
brute-force closest hit used as a test oracle, and the shading payload
of resolved hits (the port of `rrt_tpu/geometry/intersect.py`).

Semantics are the reference's: triangles accept min_t ≤ t ≤ max_t with
all barycentrics ≥ 0 and carry the unnormalised barycentric blend of
their vertex normals (triangle.cpp:25-55); spheres prefer the near root
and accept the far one when the origin is inside (sphere.cpp:10-53).
"""
from __future__ import annotations

import torch

from cardbench.ref.types import Hit, SceneData


def tri_intersect(o, d, min_t, max_t, v0, v1, v2, valid):
    """Rays (..., 3) against a chunk of triangles (C, 3). Returns
    (ok, t, b1, b2), each (..., C)."""
    o = o[..., None, :]
    d = d[..., None, :]
    e1 = v1 - v0
    e2 = v2 - v0
    s = o - v0
    s1 = torch.linalg.cross(*torch.broadcast_tensors(d, e2), dim=-1)
    s2 = torch.linalg.cross(*torch.broadcast_tensors(s, e1), dim=-1)
    denom = torch.sum(s1 * e1, dim=-1)
    ok_denom = denom != 0
    inv = 1.0 / torch.where(ok_denom, denom, torch.ones_like(denom))
    t = torch.sum(s2 * e2, dim=-1) * inv
    b1 = torch.sum(s1 * s, dim=-1) * inv
    b2 = torch.sum(s2 * d, dim=-1) * inv
    b0 = 1.0 - b1 - b2
    ok = ((min_t[..., None] <= t) & (t <= max_t[..., None])
          & (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & valid & ok_denom)
    return ok, t, b1, b2


def sphere_intersect(o, d, min_t, max_t, center, radius):
    """Rays (..., 3) against spheres (S, 3)/(S,). Returns (ok, t), each
    (..., S). Dead rows (radius ≤ 0, centre at 1e30) get a benign centre
    so that no inf - inf reaches the discriminant."""
    live = radius > 0
    center = torch.where(live[..., None], center, torch.zeros_like(center))
    tmp = o[..., None, :] - center
    b = 2.0 * torch.sum(tmp * d[..., None, :], dim=-1)
    c = torch.sum(tmp * tmp, dim=-1) - radius * radius
    disc = b * b - 4.0 * c
    has = disc >= 0
    pos = disc > 1e-24
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc,
                                                 torch.ones_like(disc))),
                     torch.zeros_like(disc))
    t1 = (-b - sq) / 2.0
    t2 = (-b + sq) / 2.0
    ok1 = (min_t[..., None] <= t1) & (t1 <= max_t[..., None])
    ok2 = (min_t[..., None] <= t2) & (t2 <= max_t[..., None])
    t = torch.where(ok1, t1, t2)
    ok = has & (ok1 | ok2) & live
    return ok, t


def closest_hit_brute(scene: SceneData, o, d, min_t, max_t):
    """Closest hit over every primitive, with no culling: the oracle the
    traversal is checked against. Returns (hit, t, prim_id, b1, b2);
    prim ids are triangles first, then spheres; a miss keeps t = max_t."""
    ok, t, b1, b2 = tri_intersect(o, d, min_t, max_t, scene.tri_v0,
                                  scene.tri_v1, scene.tri_v2,
                                  scene.tri_bsdf >= 0)
    t = torch.where(ok, t, torch.full_like(t, float("inf")))
    bt, j = torch.min(t, dim=-1)
    pick = lambda a: torch.gather(a, -1, j[..., None])[..., 0]
    bb1, bb2 = pick(b1), pick(b2)
    bp = j.to(torch.int32)
    oks, ts = sphere_intersect(o, d, min_t, max_t, scene.sph_center,
                               scene.sph_radius)
    oks = oks & (scene.sph_bsdf >= 0)
    ts = torch.where(oks, ts, torch.full_like(ts, float("inf")))
    st, js = torch.min(ts, dim=-1)
    better = st < bt
    bt = torch.where(better, st, bt)
    bp = torch.where(better, (scene.n_tris + js).to(torch.int32), bp)
    bb1 = torch.where(better, torch.zeros_like(bb1), bb1)
    bb2 = torch.where(better, torch.zeros_like(bb2), bb2)
    hit = torch.isfinite(bt)
    return hit, torch.where(hit, bt, max_t), bp, bb1, bb2


def build_hit(scene: SceneData, o, d, hit, t, prim_id, b1, b2) -> Hit:
    """Shading data of resolved hits (reference triangle.cpp:46-52,
    sphere.cpp:32-47)."""
    n_t = scene.n_tris
    is_tri = prim_id < n_t
    tid = torch.clamp(prim_id, 0, n_t - 1).long()
    sid = torch.clamp(prim_id - n_t, 0, scene.n_spheres - 1).long()
    b0 = 1.0 - b1 - b2
    n_tri = (b0[..., None] * scene.tri_n0[tid]
             + b1[..., None] * scene.tri_n1[tid]
             + b2[..., None] * scene.tri_n2[tid])
    # a miss keeps t = max_t (possibly inf): anchor its point at the origin
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    p = o + t_safe[..., None] * d
    # a dead sphere row (radius 0) is never a hit, but a scene without a
    # live sphere gathers one for every lane: divide by a safe radius so
    # that the unselected branch's gradient stays finite
    r = torch.where(scene.sph_radius[sid] > 0, scene.sph_radius[sid], 1.0)
    n_sph = (p - scene.sph_center[sid]) / r[..., None]
    n = torch.where(is_tri[..., None], n_tri, n_sph)
    bsdf = torch.where(is_tri, scene.tri_bsdf[tid], scene.sph_bsdf[sid])
    bsdf = torch.where(hit, bsdf, torch.full_like(bsdf, -1))
    return Hit(hit=hit, t=t, p=p, n=n, w_out=-d,
               prim_id=torch.where(hit, prim_id, torch.full_like(prim_id, -1)),
               bsdf_id=bsdf)
