"""Curved and flat ray traversal: host tables, the CUDA kernel's wrapper,
and its plain PyTorch version.

This replaces the JAX package's fused Pallas kernel
(`rrt_tpu/ops/trace_kernel.py`, `pallas_trace_raw` and its `_kernel`),
whose lazy (`_phase2_lazy`), windowed (`_phase2_windowed`), any-hit and
flat modes are one function: for every ray, march Schwarzschild chords
one Δθ step at a time (`march`, `absorb`), test each chord that touches
the scene bbox against the part → supercluster (SUP = 8) → cluster
(CS_K = 16, or 8 above 8192 triangles) → triangle hierarchy plus the
live spheres, and stop at the ray's first event. The TPU kernel's tile
layouts (8×128 tiles, chord tables in VMEM, 8-segment windows, block
gates and the lane sort) answered TPU constraints and are not carried
over; the parked layouts (v2 per-segment loop, v4 `_blocked_tris`,
`scan_part`, `scan_part_box`, `RRT_WREL=march`, `RRT_ABLATE`) compute the
same function and are left out on purpose.

What is kept exactly (reference bvh.cpp:103-113):
  * each chord carries its own [0, len] range;
  * absorption on segment s beats geometry on segment s;
  * a degenerate (radial) lane dies with no hit;
  * 2π exhaustion is an escape, and an escaped lane keeps its o and d;
  * a wrapped (u ≤ 0 teleport) lane keeps marching, |1/u| ≤ 1e9;
  * within a chord the smaller t wins, then the lower prim id (sphere
    ids follow the triangle rows, so triangles win ties);
  * in any-hit mode a ray stops after the first part (or the sphere
    list) whose sweep finds a hit; the hit bool equals closest-hit's;
  * flat mode is one segment honouring [min_t, max_t]; "no event" is
    segment 1;
  * ray directions are padded away from zero (|d| ≥ 1e-20).

Work counters are per ray: +1 per part slab, +n_sup when the part is
reached, +SUP per supercluster reached, +CS_K per cluster swept, and for
the live spheres +1 for the sphere-union slab and +SL when it is reached.

The march uses the JAX kernel's op forms (`march`, `trace_kernel.py:
802-862`) with cos Δθ and sin Δθ computed once in float32 (on the host by
`build_tables`; on the tables' device by `with_hole`, the differentiable
path's), so the kernel, built with --fmad=false and IEEE division and
square root, and `trace_rays_reference` read the same row and agree bit
for bit on calm lanes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from rrt_tpu_torch.geometry.intersect import build_hit, tri_intersect
from rrt_tpu_torch.physics.schwarzschild import n_segments
from rrt_tpu_torch.types import BlackHoleParams, Hit, Rays, SceneData
from rrt_tpu_torch.utils import stats

BIG = 3e37
# triangle rows per Morton-contiguous part, and clusters per supercluster:
# the same hierarchy as the JAX kernel, so counters and parts line up
PART_TRIS = 2048
SUP = 8
# layout of TraceTables.params
P_BH, P_R, P_DT, P_COS, P_SIN = 0, 3, 4, 5, 6
P_GLO, P_GHI, P_SLO, P_SHI = 7, 10, 13, 16
N_PARAMS = 20

# kernel launches made by `trace_rays` (a launch recorded into a CUDA
# graph is not one, and a replay of it goes round `trace_rays`); read by
# tests and chip_smoke.py
LAUNCHES = 0
# device index -> (1,) int64 counter in device memory that the kernel adds
# one to at each of its runs, launched or replayed (`kernel_runs`)
_RUNS: dict = {}
# the last launch's grid, block width, resident blocks per SM, traversal
# ("per-lane" or "cooperative") and where its box and triangle tables were
# read from ("shared" memory or "device" memory)
LAST_LAUNCH: dict = {}


def cs_k(n_tris: int) -> int:
    """Triangles per cluster: 8 above 8192 triangle rows, else 16 (the JAX
    kernel's `_cs_k`)."""
    return 8 if n_tris > 8192 else 16


@dataclasses.dataclass
class TraceTables:
    """The traversal's read-only inputs, on one device.

    tri rows are [v0 xyz, e1 xyz, e2 xyz, valid, 0, 0]; box rows are
    [lo xyz, hi xyz, skip, 0]; sphere rows are [centre xyz, radius] with
    dead rows at radius 0. `skip` lets the kernel pass over work whose
    result is known: on a cluster row it is the length of the prefix of
    its triangle rows that holds every valid one, on a supercluster row the
    bitmask of its clusters with any valid row (an empty cluster's box
    fails every slab); the plain version does not read it. Superclusters
    of part p are rows [p·spp, (p+1)·spp), clusters of supercluster u are
    [u·SUP, (u+1)·SUP), triangles of cluster k are [k·cs_k, (k+1)·cs_k).
    Sphere prim ids start at `n_tri_rows` and are remapped to the scene's
    after the trace. `curved` and `n_seg` (the hole's chord count, 1 in
    flat space) are the mode that every trace through these tables runs
    in."""

    params: torch.Tensor   # (N_PARAMS,) f32
    tri: torch.Tensor      # (R, 12) f32
    cl: torch.Tensor       # (K_pad, 8) f32
    sup: torch.Tensor      # (K_pad / SUP, 8) f32
    part: torch.Tensor     # (n_parts, 8) f32
    sph: torch.Tensor      # (S, 4) f32
    n_parts: int
    spp: int
    cs_k: int
    n_live_sph: int
    n_tri_rows: int
    curved: bool
    n_seg: int


@dataclasses.dataclass
class TraceOut:
    """Per-ray result: the first event and the measured work."""

    hit: torch.Tensor      # (n,) bool
    absd: torch.Tensor     # (n,) bool, absorbed by the hole
    t: torch.Tensor        # (n,) f32, chord-local t of the hit (0 if none)
    prim: torch.Tensor     # (n,) i32 in padded-tri space, -1 if none
    seg: torch.Tensor      # (n,) i32, event segment (n_seg / 1 if none)
    seg_o: torch.Tensor    # (n, 3) f32, winning chord origin
    seg_d: torch.Tensor    # (n, 3) f32, winning chord direction
    nisect: torch.Tensor   # (n,) i32, primitive tests
    ncull: torch.Tensor    # (n,) i32, bbox slab tests


def _fail_empty(lo, hi):
    """An all-padding box comes out inverted (lo=+BIG, hi=-BIG), which the
    min/max slab treats as a box spanning everything; a point box at +BIG
    fails every slab instead (trace_kernel.py:1733-1745)."""
    bad = torch.any(lo > hi, dim=1, keepdim=True)
    return (torch.where(bad, BIG, lo), torch.where(bad, BIG, hi))


def _box_rows(lo, hi, skip=None):
    skip = torch.zeros_like(lo[:, 0]) if skip is None else skip.to(lo.dtype)
    return torch.cat([lo, hi, skip[:, None], torch.zeros_like(lo[:, :1])],
                     dim=1).contiguous()


@stats.span("setup.scene")
def build_tables(scene: SceneData, bh: Optional[BlackHoleParams]
                 ) -> TraceTables:
    """The host side of `pallas_trace_raw` (trace_kernel.py:1674-1791):
    triangle rows, cluster / supercluster / part boxes, the scene bbox
    over triangles and live spheres, the sphere-union box and the hole's
    row, on the scene's device. A hole that is None or disabled gives
    flat-space tables. Build them once per (scene, hole) and hand them to
    every trace: they cost ~30 tensor ops and a host read of the hole."""
    f32 = torch.float32
    dev = scene.device
    T = scene.n_tris
    cs = cs_k(T)
    n_parts = max(1, -(-T // PART_TRIS))
    T_pad = n_parts * PART_TRIS if n_parts > 1 else T
    v0, v1, v2 = (a.to(f32) for a in (scene.tri_v0, scene.tri_v1,
                                      scene.tri_v2))
    live_t = (scene.tri_bsdf >= 0)[:, None]
    rows = torch.cat([v0, v1 - v0, v2 - v0, live_t.to(f32),
                      torch.zeros((T, 2), dtype=f32, device=dev)], dim=1)
    tmin = torch.where(live_t, torch.minimum(torch.minimum(v0, v1), v2), BIG)
    tmax = torch.where(live_t, torch.maximum(torch.maximum(v0, v1), v2), -BIG)
    if T_pad > T:
        tmin = torch.cat([tmin, torch.full((T_pad - T, 3), BIG, device=dev)])
        tmax = torch.cat([tmax, torch.full((T_pad - T, 3), -BIG, device=dev)])
    K = T_pad // cs
    K_pad = -(-K // SUP) * SUP
    cl_lo = tmin.reshape(K, cs, 3).amin(dim=1)
    cl_hi = tmax.reshape(K, cs, 3).amax(dim=1)
    if K_pad > K:
        cl_lo = torch.cat([cl_lo, torch.full((K_pad - K, 3), BIG, device=dev)])
        cl_hi = torch.cat([cl_hi, torch.full((K_pad - K, 3), -BIG,
                                             device=dev)])
    sup_lo = cl_lo.reshape(K_pad // SUP, SUP, 3).amin(dim=1)
    sup_hi = cl_hi.reshape(K_pad // SUP, SUP, 3).amax(dim=1)
    part_lo = tmin.reshape(n_parts, T_pad // n_parts, 3).amin(dim=1)
    part_hi = tmax.reshape(n_parts, T_pad // n_parts, 3).amax(dim=1)
    cl_lo, cl_hi = _fail_empty(cl_lo, cl_hi)
    sup_lo, sup_hi = _fail_empty(sup_lo, sup_hi)
    part_lo, part_hi = _fail_empty(part_lo, part_hi)
    # every cluster row, padding included, owns cs triangle rows; rows past
    # the scene are zero (valid = 0) and never hit
    n_rows = K_pad * cs
    tri = torch.zeros((n_rows, 12), dtype=f32, device=dev)
    tri[:T] = rows
    valid = (tri[:, 9] > 0).reshape(K_pad, cs)
    last = torch.arange(1, cs + 1, device=dev)
    cl_prefix = torch.where(valid, last, 0).amax(dim=1)
    sup_mask = ((cl_prefix > 0).reshape(-1, SUP).to(torch.int64)
                << torch.arange(SUP, device=dev)).sum(dim=1)

    center = scene.sph_center.to(f32)
    radius = scene.sph_radius.to(f32)
    sph = torch.cat([center, torch.where(scene.sph_bsdf >= 0, radius,
                                         0.0)[:, None]], dim=1)
    live_s = radius > 0
    sr_pad = torch.where(live_s, radius, 0.0)[:, None]
    glo = torch.minimum(
        part_lo.amin(dim=0),
        (torch.where(live_s[:, None], center, BIG) - sr_pad).amin(dim=0))
    ghi = torch.maximum(
        part_hi.amax(dim=0),
        (torch.where(live_s[:, None], center, -BIG) + sr_pad).amax(dim=0))
    s_live = (live_s & (scene.sph_bsdf >= 0))[:, None]
    sb_lo = torch.where(s_live, center - sr_pad, BIG).amin(dim=0)
    sb_hi = torch.where(s_live, center + sr_pad, -BIG).amax(dim=0)

    curved = bh is not None and bh.enabled
    n_seg = 1
    if curved:
        # cos Δθ and sin Δθ once, in float32 on the host: the kernel and
        # the plain version read the same two numbers
        dt = bh.delta_theta.detach().to("cpu", f32).reshape(())
        n_seg = n_segments(dt.item())
        bh_row = torch.cat([bh.position.detach().to("cpu", f32).reshape(3),
                            bh.radius.detach().to("cpu", f32).reshape(1),
                            dt.reshape(1), torch.cos(dt).reshape(1),
                            torch.sin(dt).reshape(1)])
    else:
        bh_row = torch.zeros(7, dtype=f32)
    params = torch.cat([
        bh_row.to(dev), glo, ghi, sb_lo, sb_hi,
        torch.zeros(N_PARAMS - 19, dtype=f32, device=dev)]).contiguous()

    S = scene.n_spheres
    n_live = scene.n_live_spheres
    return TraceTables(
        params=params, tri=tri.contiguous(),
        cl=_box_rows(cl_lo, cl_hi, cl_prefix),
        sup=_box_rows(sup_lo, sup_hi, sup_mask),
        part=_box_rows(part_lo, part_hi), sph=sph.contiguous(),
        n_parts=n_parts, spp=K_pad // n_parts // SUP, cs_k=cs,
        n_live_sph=S if n_live < 0 else min(n_live, S),
        n_tri_rows=T_pad, curved=curved, n_seg=n_seg)


def hole_row(bh: Optional[BlackHoleParams], device) -> torch.Tensor:
    """The hole's row of `TraceTables.params` (`params[:P_GLO]`: position,
    radius, Δθ, cos Δθ, sin Δθ) in float32 on `device`, from the hole's
    live values and without a host read, so that a captured step builds it
    inside its graph; zeros for a hole that is None or disabled. On the
    CPU it equals `build_tables`' row bit for bit; on a card cos and sin
    are the card's."""
    f32 = torch.float32
    if bh is None or not bh.enabled:
        return torch.zeros(P_GLO, dtype=f32, device=device)
    dt = bh.delta_theta.detach().to(device, f32).reshape(())
    return torch.cat([bh.position.detach().to(device, f32).reshape(3),
                      bh.radius.detach().to(device, f32).reshape(1),
                      dt.reshape(1), torch.cos(dt).reshape(1),
                      torch.sin(dt).reshape(1)])


def with_hole(tab: TraceTables, bh: Optional[BlackHoleParams],
              n_seg: int) -> TraceTables:
    """`tab` with the hole's row rewritten on the device (`hole_row`) and
    the mode set: curved with `n_seg` chords for a hole that is given and
    enabled, else flat. Every other table is geometry, which no hole
    changes, so a caller whose hole moves builds `tab` once (e.g.
    `build_tables(scene, None)`) and calls this on every evaluation."""
    curved = bh is not None and bh.enabled
    params = torch.cat([hole_row(bh, tab.params.device),
                        tab.params[P_GLO:]])
    return dataclasses.replace(tab, params=params, curved=curved,
                               n_seg=n_seg if curved else 1)


# ---------------------------------------------------------------- plain


def _slab(lo, hi, o, inv, tmin, tmax):
    """Does the ray interval [tmin, tmax] touch the box? NaN-propagating
    min/max, as the kernel's; a lane with tmax < tmin reaches nothing."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    mn = torch.minimum(t0, t1)
    mx = torch.maximum(t0, t1)
    tmn = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]), mn[..., 2])
    tmx = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]), mx[..., 2])
    return (tmn <= tmx) & (tmn <= tmax) & (tmx >= tmin) & (tmax >= tmin)


def _tri_test(rows, o, d, tmin, tmax):
    """Möller–Trumbore on gathered rows (..., 12) in the kernel's op
    forms. Returns (ok, t)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, valid = \
        rows[..., :10].unbind(-1)
    px, py, pz = o.unbind(-1)
    ux, uy, uz = d.unbind(-1)
    sx, sy, sz = px - v0x, py - v0y, pz - v0z
    s1x = uy * e2z - uz * e2y
    s1y = uz * e2x - ux * e2z
    s1z = ux * e2y - uy * e2x
    s2x = sy * e1z - sz * e1y
    s2y = sz * e1x - sx * e1z
    s2z = sx * e1y - sy * e1x
    denom = s1x * e1x + s1y * e1y + s1z * e1z
    okd = denom != 0.0
    inv = 1.0 / torch.where(okd, denom, 1.0)
    t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv
    b1 = (s1x * sx + s1y * sy + s1z * sz) * inv
    b2 = (s2x * ux + s2y * uy + s2z * uz) * inv
    b0 = 1.0 - b1 - b2
    ok = (okd & (valid > 0.0) & (t >= tmin) & (t <= tmax)
          & (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0))
    return ok, t


def _sphere_test(row, o, d, tmin, tmax):
    """One sphere row [c xyz, r] against rays, the kernel's op forms."""
    cx, cy, cz, r = row.tolist()
    tx, ty, tz = o[:, 0] - cx, o[:, 1] - cy, o[:, 2] - cz
    b = 2.0 * (tx * d[:, 0] + ty * d[:, 1] + tz * d[:, 2])
    c = tx * tx + ty * ty + tz * tz - r * r
    disc = b * b - 4.0 * c
    has = (disc >= 0.0) & (r > 0.0)
    sq = torch.sqrt(torch.where(has, disc, 1.0))
    t1 = (-b - sq) * 0.5
    t2 = (-b + sq) * 0.5
    ok1 = (t1 >= tmin) & (t1 <= tmax)
    ok2 = (t2 >= tmin) & (t2 <= tmax)
    return has & (ok1 | ok2), torch.where(ok1, t1, t2)


def _traverse(tab: TraceTables, prm, o, d, inv, tmin, tmax0, occlusion):
    """Best (t, prim) of each ray's [tmin, tmax0] interval, and its work
    counters, by the kernel's traversal order: parts in order, each with
    tmax narrowed to the best hit of the earlier parts; within a part the
    lowest t, then the lowest prim; the live spheres last."""
    m, dev = o.shape[0], o.device
    i32 = torch.int32
    bt = torch.full((m,), BIG, dtype=torch.float32, device=dev)
    bp = torch.full((m,), -1, dtype=i32, device=dev)
    nis = torch.zeros((m,), dtype=i32, device=dev)
    ncu = torch.zeros((m,), dtype=i32, device=dev)
    ar_sup = torch.arange(SUP, device=dev)
    ar_cs = torch.arange(tab.cs_k, device=dev)
    no_tri = torch.iinfo(i32).max

    def narrowed():
        found = bp >= 0
        live = ~found if occlusion else torch.ones_like(found)
        return torch.where(found, torch.minimum(tmax0, bt), tmax0), live

    for p in range(tab.n_parts):
        tmax, live = narrowed()
        ncu += live.to(i32)
        box = tab.part[p]
        ri = torch.nonzero(_slab(box[0:3], box[3:6], o, inv, tmin, tmax)
                           & live).squeeze(1)
        if ri.numel() == 0:
            continue
        ncu[ri] += tab.spp
        sup = tab.sup[p * tab.spp:(p + 1) * tab.spp]
        sr = _slab(sup[:, 0:3], sup[:, 3:6], o[ri, None], inv[ri, None],
                   tmin[ri, None], tmax[ri, None])              # (mr, spp)
        ncu.index_add_(0, ri, (SUP * sr.sum(dim=1)).to(i32))
        a, u = torch.nonzero(sr, as_tuple=True)
        if a.numel() == 0:
            continue
        ray = ri[a]
        cid = (p * tab.spp + u)[:, None] * SUP + ar_sup         # (pairs, SUP)
        box = tab.cl[cid]
        cr = _slab(box[..., 0:3], box[..., 3:6], o[ray, None], inv[ray, None],
                   tmin[ray, None], tmax[ray, None])
        nis.index_add_(0, ray, (tab.cs_k * cr.sum(dim=1)).to(i32))
        b, c = torch.nonzero(cr, as_tuple=True)
        if b.numel() == 0:
            continue
        ray = ray[b]
        tri = cid[b, c][:, None] * tab.cs_k + ar_cs             # (m2, cs_k)
        ok, t = _tri_test(tab.tri[tri], o[ray, None], d[ray, None],
                          tmin[ray, None], tmax[ray, None])
        t = torch.where(ok, t, BIG)
        idx = ray[:, None].expand_as(t).reshape(-1)
        tp = torch.full((m,), BIG, dtype=torch.float32, device=dev)
        tp.scatter_reduce_(0, idx, t.reshape(-1), reduce="amin")
        cand = ok & (t == tp[ray, None])
        pid = torch.where(cand, tri, no_tri)
        pp = torch.full((m,), no_tri, dtype=torch.int64, device=dev)
        pp.scatter_reduce_(0, idx, pid.reshape(-1), reduce="amin")
        better = (pp < no_tri) & (tp < bt)
        bt = torch.where(better, tp, bt)
        bp = torch.where(better, pp.to(i32), bp)

    if tab.n_live_sph > 0:
        tmax, live = narrowed()
        ncu += live.to(i32)
        sr = _slab(torch.tensor(prm[P_SLO:P_SLO + 3], device=dev),
                   torch.tensor(prm[P_SHI:P_SHI + 3], device=dev),
                   o, inv, tmin, tmax) & live
        nis += (tab.n_live_sph * sr).to(i32)
        for si in range(tab.n_live_sph):
            ok, ts = _sphere_test(tab.sph[si], o, d, tmin, tmax)
            better = ok & sr & (ts < bt)
            bt = torch.where(better, ts, bt)
            bp = torch.where(better, tab.n_tri_rows + si, bp)
    return bt, bp, nis, ncu


def _march(prm, p, u):
    """One Δθ geodesic step in the kernel's op forms
    (trace_kernel.py:802-862). Returns (new dir, inverse dir, chord
    length, dead)."""
    bx, by, bz = prm[P_BH:P_BH + 3]
    r, dt, ct, st = prm[P_R], prm[P_DT], prm[P_COS], prm[P_SIN]
    px, py, pz = p.unbind(-1)
    ux, uy, uz = u.unbind(-1)
    xax, xay, xaz = px - bx, py - by, pz - bz
    d2 = xax * xax + xay * xay + xaz * xaz
    at_c = d2 <= 0.0
    dist = torch.sqrt(torch.where(at_c, 1.0, d2))
    uu = 1.0 / dist
    xhx, xhy, xhz = xax * uu, xay * uu, xaz * uu
    ddx = ux * xhx + uy * xhy + uz * xhz
    yax, yay, yaz = ux - ddx * xhx, uy - ddx * xhy, uz - ddx * xhz
    y2 = yax * yax + yay * yay + yaz * yaz
    dead = (y2 < 1e-24) | at_c
    rdyn = 1.0 / torch.sqrt(torch.where(dead, 1.0, y2))
    yhx, yhy, yhz = yax * rdyn, yay * rdyn, yaz * rdyn
    up = -uu * ddx * rdyn

    def f(v):
        return -v + 1.5 * r * v * v

    f1 = f(uu)
    f2 = f(uu + up * dt / 2.0)
    f3 = f(uu + up * dt / 2.0 + f1 * dt * dt / 4.0)
    # a true division: on CUDA tensors PyTorch turns `x / 6.0` into
    # x * (1/6), which rounds differently from the kernel's x / 6
    u_new = uu + up * dt + (f1 + f2 + f3) * dt * dt / torch.full_like(
        uu, 6.0)
    tiny = 1e-30
    u_safe = torch.where(torch.abs(u_new) > tiny, u_new,
                         torch.where(u_new >= 0.0, tiny, -tiny))
    d_new = torch.clamp(1.0 / u_safe, -1e9, 1e9)
    cx = bx + d_new * ct * xhx + d_new * st * yhx - px
    cy = by + d_new * ct * xhy + d_new * st * yhy - py
    cz = bz + d_new * ct * xhz + d_new * st * yhz - pz
    c2 = cx * cx + cy * cy + cz * cz
    zl = c2 <= 0.0
    clen = torch.sqrt(torch.where(zl, 1.0, c2))
    rclen = 1.0 / clen
    nd = torch.stack([cx * rclen, cy * rclen, cz * rclen], dim=-1)
    clen = torch.where(zl, 0.0, clen)
    return nd, 1.0 / nd, clen, dead | zl


def _absorb(prm, p, u, clen):
    """Does the chord [0, clen] cross the event horizon (the kernel's
    `absorb`, trace_kernel.py:864-877)?"""
    bx, by, bz = prm[P_BH:P_BH + 3]
    r = prm[P_R]
    tx, ty, tz = p[:, 0] - bx, p[:, 1] - by, p[:, 2] - bz
    b = 2.0 * (tx * u[:, 0] + ty * u[:, 1] + tz * u[:, 2])
    c = tx * tx + ty * ty + tz * tz - r * r
    disc = b * b - 4.0 * c
    has = disc >= 0.0
    sq = torch.sqrt(torch.where(has, disc, 1.0))
    t1 = (-b - sq) * 0.5
    t2 = (-b + sq) * 0.5
    ok1 = (t1 >= 0.0) & (t1 <= clen)
    ok2 = (t2 >= 0.0) & (t2 <= clen)
    return has & (ok1 | ok2) & (r > 0.0)


def pad_dirs(d):
    """Ray directions padded away from zero (trace_kernel.py:1674)."""
    return torch.where(torch.abs(d) < 1e-20, 1e-20, d)


def trace_rays_reference(tab: TraceTables, o, d, min_t, max_t,
                         occlusion: bool = False) -> TraceOut:
    """The plain PyTorch version of the kernel: the same algorithm,
    vectorised over rays. A Python loop over segments marches the lanes
    still open; their touching chords go through masked (rays × boxes)
    slabs and (rays × triangles) tests; the first event and the counters
    follow the kernel's rules exactly."""
    n, dev = o.shape[0], o.device
    curved, n_seg = tab.curved, tab.n_seg
    i32 = torch.int32
    d = pad_dirs(d)
    prm = tab.params.tolist()
    out = TraceOut(
        hit=torch.zeros((n,), dtype=torch.bool, device=dev),
        absd=torch.zeros((n,), dtype=torch.bool, device=dev),
        t=torch.zeros((n,), dtype=torch.float32, device=dev),
        prim=torch.full((n,), -1, dtype=i32, device=dev),
        seg=torch.full((n,), n_seg if curved else 1, dtype=i32, device=dev),
        seg_o=o.clone(), seg_d=d.clone(),
        nisect=torch.zeros((n,), dtype=i32, device=dev),
        ncull=torch.zeros((n,), dtype=i32, device=dev))
    if not curved:
        bt, bp, out.nisect, out.ncull = _traverse(
            tab, prm, o, d, 1.0 / d, min_t, max_t, occlusion)
        out.hit = bp >= 0
        out.t = torch.where(out.hit, bt, 0.0)
        out.prim = bp
        out.seg = torch.where(out.hit, 0, 1).to(i32)
        return out

    glo = torch.tensor(prm[P_GLO:P_GLO + 3], device=dev)
    ghi = torch.tensor(prm[P_GHI:P_GHI + 3], device=dev)
    lane = torch.arange(n, device=dev)
    pos, u = o, d
    for s in range(n_seg):
        if lane.numel() == 0:
            break
        nd, inv, clen, dead = _march(prm, pos, u)
        ab = _absorb(prm, pos, nd, clen) & ~dead
        closed = dead | ab
        out.seg[lane[closed]] = s
        out.absd[lane[ab]] = True
        touch = _slab(glo, ghi, pos, inv, 0.0, clen) & ~closed
        ti = torch.nonzero(touch).squeeze(1)
        if ti.numel():
            bt, bp, nis, ncu = _traverse(
                tab, prm, pos[ti], nd[ti], inv[ti],
                torch.zeros_like(clen[ti]), clen[ti], occlusion)
            out.nisect[lane[ti]] += nis
            out.ncull[lane[ti]] += ncu
            h = bp >= 0
            hl = lane[ti[h]]
            out.hit[hl] = True
            out.t[hl] = bt[h]
            out.prim[hl] = bp[h]
            out.seg[hl] = s
            out.seg_o[hl] = pos[ti[h]]
            out.seg_d[hl] = nd[ti[h]]
            closed[ti[h]] = True
        keep = ~closed
        pos = (pos + nd * clen[:, None])[keep]
        u = nd[keep]
        lane = lane[keep]
    return out


# ---------------------------------------------------------------- kernel


def _check(name, a, dev, shape, table=False):
    """float32 of the given shape on `dev`, contiguous; tables are read
    as float4 and must also be 16-byte aligned."""
    if a.device != dev or a.dtype != torch.float32 \
            or tuple(a.shape) != shape:
        raise ValueError(
            f"{name}: expected float32 {shape} on {dev}, got {a.dtype} "
            f"{tuple(a.shape)} on {a.device}")
    if not a.is_contiguous() or (table and a.data_ptr() % 16):
        raise ValueError(f"{name}: must be contiguous"
                         + (" and 16-byte aligned" if table else ""))


# where the tables of a launch lived, by the layout code `rrt_trace` reports
_LAYOUTS = (("shared", "shared"), ("shared", "device"), ("device", "device"))
# the traversal's device spans, closest hit and any hit
_SPANS = ("trace.closest", "trace.anyhit")
_FN = None


def _trace_fn():
    """The library's `rrt_trace`, resolved once per process."""
    global _FN
    if _FN is None:
        from rrt_tpu_torch.ops import build
        lib = build.load_library("trace")
        _FN = (lib.rrt_trace, lib.rrt_error_string)
    return _FN


def kernel_runs() -> int:
    """The trace kernel's runs since the last `reset_counts`, as the
    kernel counted them on the device: its launches and the launches that
    CUDA graphs replayed. Waits for the devices."""
    return sum(int(c.item()) for c in _RUNS.values())


def reset_counts():
    """`LAUNCHES` and every device's `kernel_runs` counter set to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for c in _RUNS.values():
        c.zero_()


def _runs_counter(dev) -> torch.Tensor:
    """The device's run counter, made on its first eager launch: made
    inside a capture, it would be a graph's buffer that a replay resets."""
    c = _RUNS.get(dev.index)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the trace kernel's first launch on a device "
                               "cannot be inside a CUDA graph capture")
        c = _RUNS[dev.index] = torch.zeros(1, dtype=torch.int64, device=dev)
    return c


def _launch(tab: TraceTables, o, d, min_t, max_t, occlusion) -> TraceOut:
    global LAUNCHES, LAST_LAUNCH
    n, dev = o.shape[0], o.device
    f32, i32 = torch.float32, torch.int32
    for name, a, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("min_t", min_t, (n,)), ("max_t", max_t, (n,))):
        _check(name, a, dev, shape)
    for name, a, shape in (("params", tab.params, (N_PARAMS,)),
                           ("tri", tab.tri, (tab.cl.shape[0] * tab.cs_k, 12)),
                           ("cl", tab.cl, (tab.sup.shape[0] * SUP, 8)),
                           ("sup", tab.sup, (tab.n_parts * tab.spp, 8)),
                           ("part", tab.part, (tab.n_parts, 8)),
                           ("sph", tab.sph, (tab.sph.shape[0], 4))):
        _check(name, a, dev, shape, table=True)
    if tab.n_live_sph > tab.sph.shape[0]:
        raise ValueError("more live spheres than sphere rows")
    if tab.cs_k not in (8, 16) or not 1 <= tab.spp <= 32:
        raise ValueError(f"clusters of {tab.cs_k} and {tab.spp} "
                         "superclusters a part: the kernel takes 8 or 16 "
                         "and 1 to 32")
    if 3 * n >= 2 ** 31:
        raise ValueError(f"{n} rays: the kernel indexes with 32-bit ints")
    if tab.cl.shape[0] >= 2 ** 21:
        raise ValueError(f"{tab.cl.shape[0]} clusters: the kernel packs a "
                         "cluster's index in 21 bits")
    out = TraceOut(
        hit=torch.empty((n,), dtype=torch.bool, device=dev),
        absd=torch.empty((n,), dtype=torch.bool, device=dev),
        t=torch.empty((n,), dtype=f32, device=dev),
        prim=torch.empty((n,), dtype=i32, device=dev),
        seg=torch.empty((n,), dtype=i32, device=dev),
        seg_o=torch.empty((n, 3), dtype=f32, device=dev),
        seg_d=torch.empty((n, 3), dtype=f32, device=dev),
        nisect=torch.empty((n,), dtype=i32, device=dev),
        ncull=torch.empty((n,), dtype=i32, device=dev))
    if n == 0:
        return out
    fn, err = _trace_fn()
    runs = _runs_counter(dev)
    queue = torch.zeros(1, dtype=i32, device=dev)   # the launch's ray queue
    info = (ctypes.c_int * 6)()
    p = lambda a: a.data_ptr()
    with stats.span(_SPANS[bool(occlusion)], dev):
        rc = fn(p(o), p(d), p(min_t), p(max_t), n,
                p(tab.params), p(tab.tri), p(tab.cl), p(tab.sup),
                p(tab.part), p(tab.sph), tab.n_parts, tab.spp, tab.cs_k,
                tab.n_live_sph, tab.n_tri_rows, tab.sph.shape[0], tab.n_seg,
                int(tab.curved), int(occlusion), p(out.hit), p(out.absd),
                p(out.t), p(out.prim), p(out.seg), p(out.seg_o),
                p(out.seg_d), p(out.nisect), p(out.ncull), p(queue),
                p(runs), ctypes.addressof(info), dev.index,
                torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError("trace kernel launch failed: "
                           + err(rc).decode())
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    boxes, tris = _LAYOUTS[info[2]]
    LAST_LAUNCH = dict(grid=info[0], threads=info[4],
                       blocks_per_sm=info[1], tables_in=boxes,
                       traversal="cooperative" if info[5] else "per-lane",
                       triangles_in=tris, smem_bytes=info[3])
    return out


def trace_rays(tab: TraceTables, o, d, min_t, max_t,
               occlusion: bool = False) -> TraceOut:
    """First event of every ray (o, d, min_t, max_t: (n,3), (n,3), (n,),
    (n,) float32, contiguous, on the tables' device), in the tables' mode.

    A CPU tensor goes to `trace_rays_reference`. A CUDA tensor goes to the
    hand-written kernel `ops/csrc/trace_kernel.cu`, built on first use;
    anything else raises. Each kernel launch adds one to `LAUNCHES`, and
    each run of the kernel, replays included, one to `kernel_runs()`. The
    traversal is the device span "trace.closest", or "trace.anyhit" with
    `occlusion` (`utils.stats`)."""
    if o.device.type == "cpu":
        with stats.span(_SPANS[bool(occlusion)], o.device):
            return trace_rays_reference(tab, o, d, min_t, max_t, occlusion)
    if o.device.type != "cuda":
        raise ValueError(f"no trace kernel for device {o.device}")
    return _launch(tab, o, d, min_t, max_t, occlusion)


def kernel_trace(scene: SceneData, tab: TraceTables, rays: Rays,
                 occlusion: bool = False, return_seg: bool = False,
                 return_stats: bool = False,
                 stats_lanes: Optional[int] = None):
    """Closest (or any) hit of a ray batch through `trace_rays`, in the
    tables' mode (`build_tables(scene, bh)`), with the shading payload
    rebuilt outside: the winning triangle's barycentrics are re-derived
    and clamped to the simplex (trace_kernel.py:1977-1996) before
    `build_hit`. The port of `pallas_trace`, without its lane sort.
    Returns Hit, plus the (n,) winning segment with `return_seg`, plus
    the summed (2,) [primitive tests, bbox tests] with `return_stats`,
    over the first `stats_lanes` lanes when given (a sharded trace
    leaves its padded lanes out)."""
    shape = rays.o.shape[:-1]
    f32 = torch.float32
    o = rays.o.reshape(-1, 3).to(f32).contiguous()
    d = pad_dirs(rays.d.reshape(-1, 3).to(f32)).contiguous()
    min_t = rays.min_t.reshape(-1).to(f32).contiguous()
    max_t = rays.max_t.reshape(-1).to(f32).contiguous()
    r = trace_rays(tab, o, d, min_t, max_t, occlusion)
    T = scene.n_tris
    prim = torch.where(r.prim >= tab.n_tri_rows,
                       r.prim - (tab.n_tri_rows - T), r.prim)
    t = torch.where(r.hit, r.t, 0.0)
    is_tri = (prim >= 0) & (prim < T)
    tid = torch.clamp(prim, 0, T - 1).long()
    inf = torch.full_like(t, math.inf)
    _, _, b1, b2 = tri_intersect(
        r.seg_o, r.seg_d, -inf, inf, scene.tri_v0[tid][:, None],
        scene.tri_v1[tid][:, None], scene.tri_v2[tid][:, None],
        torch.ones((t.shape[0], 1), dtype=torch.bool, device=t.device))
    b1 = torch.clamp(torch.where(is_tri, b1[:, 0], 0.0), 0.0, 1.0)
    b2 = torch.clamp(torch.where(is_tri, b2[:, 0], 0.0), 0.0, 1.0)
    b2 = torch.minimum(b2, 1.0 - b1)
    h = build_hit(scene, r.seg_o, r.seg_d, r.hit, t, prim, b1, b2)
    if tuple(shape) != tuple(t.shape):
        h = Hit(**{f.name: getattr(h, f.name).reshape(
            tuple(shape) + getattr(h, f.name).shape[1:])
            for f in dataclasses.fields(h)})
    out = (h,)
    if return_seg:
        out += (r.seg.reshape(shape),)
    if return_stats:
        m = stats_lanes
        out += (torch.stack([r.nisect[:m].sum(dtype=torch.float64),
                             r.ncull[:m].sum(dtype=torch.float64)]),)
    return out if len(out) > 1 else h
