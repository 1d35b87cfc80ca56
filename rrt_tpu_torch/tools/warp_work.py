"""What a warp issues, against what its lanes need: the trace kernel's
work model, counted on the CPU.

For a batch of lanes in a trace mode, `count(tab, o, d, min_t, max_t,
occlusion)` walks the plain version's traversal chord by chord and keeps,
for every lane and chord, which part, supercluster and cluster boxes it
passed. From those sets it counts, with warps of 32 consecutive lanes:

* `useful`: what the lanes' own counters (`ncull`, `nisect`) report:
  chords marched, box tests and triangle tests, summed over lanes.
* `need`: what the lanes need, box and triangle tests: the counters count
  every cluster box of a supercluster that passed and every row of a
  cluster that passed, but an empty cluster (not in its supercluster's
  mask of non-empty clusters) fails every slab and a cluster's rows past
  its valid prefix never hit, so a lane needs only the masked cluster
  boxes and the valid prefix. These are the tests the kernel makes, and
  the work a launch's bound counts.
* `simt`: what a warp issues when one thread carries one ray through all
  its chords (the one-thread-per-ray kernel), in lane slots (32 per warp
  instruction): a warp marches while any of its lanes marches, and at a
  chord step it tests a part, a supercluster's clusters or a cluster's
  triangles when any of its lanes reached that node (the union of its
  lanes' passing nodes).
* `coop`: what a warp issues when it spreads (lane, node) pairs over its
  lanes (the persistent, cooperative kernel): a pass of 32 lanes takes
  32 / pow2(spp) (lane, part) pairs, 4 (lane, supercluster) pairs or
  32 / cs_k (lane, cluster) pairs; chords cost a lane slot each, since a
  lane that ends takes the next ray. The warps keep the batch's grouping
  here; the kernel's refill mixes rays of neighbouring indices.

`python -m rrt_tpu_torch.tools.warp_work` counts the first pass of the
main path's Cornell box at 256×256 and 1 spp (camera lanes, closest hit;
then the first vertex's shadow lanes, any hit) and 16,384 of
`chip_smoke.py`'s seeded rays in `cbox_dense`, on the CPU, and prints one
JSON line per batch.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from rrt_tpu_torch.ops import trace_kernel as tk

WARP = 32


def _pow2(v: int) -> int:
    return 1 << max(0, math.ceil(math.log2(v)))


def _warp_any(mask, warp):
    """(n_warps, ...) any over the lanes of each warp."""
    n_w = int(warp.max()) + 1 if warp.numel() else 0
    out = torch.zeros((n_w,) + tuple(mask.shape[1:]), dtype=torch.int32,
                      device=mask.device)
    out.index_add_(0, warp, mask.to(torch.int32))
    return out > 0


def _warp_sum(v, warp):
    n_w = int(warp.max()) + 1 if warp.numel() else 0
    out = torch.zeros((n_w,), dtype=torch.int64, device=v.device)
    out.index_add_(0, warp, v.to(torch.int64))
    return out


def _passes(pairs, per):
    """Passes of 32 lanes for `pairs` pairs, `per` pairs a pass."""
    return (pairs + per - 1) // per


def _step(tab, prm, o, d, inv, tmin, tmax0, occlusion, warp, acc):
    """The traversal of one chord per lane (lanes of `warp`), as
    `trace_kernel._traverse`, adding its issue counts to `acc`; returns
    (bt, bp)."""
    m, dev = o.shape[0], o.device
    i64 = torch.int64
    bt = torch.full((m,), tk.BIG, device=dev)
    bp = torch.full((m,), -1, dtype=torch.int32, device=dev)
    cs, spp = tab.cs_k, tab.spp
    sw = _pow2(spp)
    bits = torch.arange(tk.SUP, device=dev)
    for p in range(tab.n_parts):
        live = (bp < 0) if occlusion else torch.ones(m, dtype=torch.bool,
                                                     device=dev)
        tmax = torch.where(bp >= 0, torch.minimum(tmax0, bt), tmax0)
        box = tab.part[p]
        reach = tk._slab(box[0:3], box[3:6], o, inv, tmin, tmax) & live
        sup = tab.sup[p * spp:(p + 1) * spp]
        sr = tk._slab(sup[:, 0:3], sup[:, 3:6], o[:, None], inv[:, None],
                      tmin[:, None], tmax[:, None]) & reach[:, None]
        cl = tab.cl[p * spp * tk.SUP:(p + 1) * spp * tk.SUP]
        cr = tk._slab(cl[:, 0:3], cl[:, 3:6], o[:, None], inv[:, None],
                      tmin[:, None], tmax[:, None])
        cr = cr & sr.repeat_interleave(tk.SUP, dim=1)
        n_sup, n_cl = sr.sum(1), cr.sum(1)
        acc["useful_box"] += int(live.sum() + reach.sum() * spp
                                 + n_sup.sum() * tk.SUP)
        acc["useful_tri"] += int(n_cl.sum()) * cs
        # the non-empty clusters of each supercluster, and each cluster's
        # prefix of valid rows (the tables' skip columns)
        n_full = ((sup[:, 6].to(i64)[:, None] >> bits) & 1).sum(1)
        acc["need_box"] += int(live.sum() + reach.sum() * spp
                               + (sr.to(i64) * n_full).sum())
        acc["need_tri"] += int((cr.to(i64) * cl[:, 6].to(i64)).sum())
        any_live = _warp_any(live, warp)
        acc["simt_box"] += WARP * int(
            any_live.sum() + _warp_any(reach, warp).sum() * spp
            + _warp_any(sr, warp).sum() * tk.SUP)
        acc["simt_tri"] += WARP * cs * int(_warp_any(cr, warp).sum())
        acc["coop_box"] += WARP * int(
            any_live.sum()
            + _passes(_warp_sum(reach, warp), WARP // sw).sum()
            + _passes(_warp_sum(n_sup, warp), WARP // tk.SUP).sum())
        acc["coop_tri"] += WARP * int(
            _passes(_warp_sum(n_cl, warp), WARP // cs).sum())
        # the part's best hit, as the plain version finds it
        lane, c = torch.nonzero(cr, as_tuple=True)
        if lane.numel():
            k = p * spp * tk.SUP + c
            tri = k[:, None] * cs + torch.arange(cs, device=dev)
            ok, t = tk._tri_test(tab.tri[tri], o[lane, None], d[lane, None],
                                 tmin[lane, None], tmax[lane, None])
            t = torch.where(ok, t, tk.BIG)
            best = torch.full((m,), tk.BIG, device=dev)
            best.scatter_reduce_(0, lane[:, None].expand_as(t).reshape(-1),
                                 t.reshape(-1), reduce="amin")
            cand = ok & (t == best[lane, None])
            pid = torch.where(cand, tri, torch.iinfo(torch.int32).max)
            bid = torch.full((m,), torch.iinfo(torch.int32).max,
                             dtype=i64, device=dev)
            bid.scatter_reduce_(0, lane[:, None].expand_as(t).reshape(-1),
                                pid.reshape(-1), reduce="amin")
            better = (bid < torch.iinfo(torch.int32).max) & (best < bt)
            bt = torch.where(better, best, bt)
            bp = torch.where(better, bid.to(torch.int32), bp)
    if tab.n_live_sph > 0:
        live = (bp < 0) if occlusion else torch.ones(m, dtype=torch.bool,
                                                     device=dev)
        tmax = torch.where(bp >= 0, torch.minimum(tmax0, bt), tmax0)
        sr = tk._slab(torch.tensor(prm[tk.P_SLO:tk.P_SLO + 3], device=dev),
                      torch.tensor(prm[tk.P_SHI:tk.P_SHI + 3], device=dev),
                      o, inv, tmin, tmax) & live
        for key in ("useful", "need"):
            acc[key + "_box"] += int(live.sum())
            acc[key + "_tri"] += int(sr.sum()) * tab.n_live_sph
        n_any = int(_warp_any(live, warp).sum())
        n_pass = int(_warp_any(sr, warp).sum())
        for key in ("simt", "coop"):
            acc[key + "_box"] += WARP * n_any
            acc[key + "_tri"] += WARP * n_pass * tab.n_live_sph
        for si in range(tab.n_live_sph):
            ok, ts = tk._sphere_test(tab.sph[si], o, d, tmin, tmax)
            better = ok & sr & (ts < bt)
            bt = torch.where(better, ts, bt)
            bp = torch.where(better, tab.n_tri_rows + si, bp)
    return bt, bp


def count(tab: tk.TraceTables, o, d, min_t, max_t, occlusion=False) -> dict:
    """The work model of one trace (lanes in launch order, on the tables'
    device): chords, box tests and triangle tests as the lanes' counters
    report them (`useful_*`), as the lanes need them (`need_*`) and as warps
    issue them (`simt_*`, `coop_*`, in lane slots)."""
    n, dev = o.shape[0], o.device
    d = tk.pad_dirs(d)
    prm = tab.params.tolist()
    acc = dict.fromkeys(("useful_chords", "simt_chords", "useful_box",
                         "need_box", "simt_box", "coop_box", "useful_tri",
                         "need_tri", "simt_tri", "coop_tri"), 0)
    lane = torch.arange(n, device=dev)
    if not tab.curved:
        acc["useful_chords"] = n
        acc["simt_chords"] = WARP * -(-n // WARP)
        _step(tab, prm, o, d, 1.0 / d, min_t, max_t, occlusion,
              lane // WARP, acc)
        return dict(lanes=n, **acc)
    glo = torch.tensor(prm[tk.P_GLO:tk.P_GLO + 3], device=dev)
    ghi = torch.tensor(prm[tk.P_GHI:tk.P_GHI + 3], device=dev)
    pos, u = o, d
    for _ in range(tab.n_seg):
        if lane.numel() == 0:
            break
        warp = lane // WARP
        acc["useful_chords"] += lane.numel()
        acc["simt_chords"] += WARP * int(torch.unique(warp).numel())
        nd, inv, clen, dead = tk._march(prm, pos, u)
        closed = dead | (tk._absorb(prm, pos, nd, clen) & ~dead)
        touch = tk._slab(glo, ghi, pos, inv, 0.0, clen) & ~closed
        ti = torch.nonzero(touch).squeeze(1)
        if ti.numel():
            _, bp = _step(tab, prm, pos[ti], nd[ti], inv[ti],
                          torch.zeros_like(clen[ti]), clen[ti], occlusion,
                          warp[ti], acc)
            closed[ti[bp >= 0]] = True
        keep = ~closed
        pos = (pos + nd * clen[:, None])[keep]
        u = nd[keep]
        lane = lane[keep]
    return dict(lanes=n, **acc)


def _main_path_batches(width, height):
    """The first pass's camera lanes and first vertex's shadow lanes of the
    main path's Cornell box at width × height, 1 spp, on the CPU."""
    from rrt_tpu_torch.render import integrator
    from rrt_tpu_torch.render.renderer import (Renderer, make_black_hole,
                                               pass_generator)
    from rrt_tpu_torch.scene.build import load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES
    from rrt_tpu_torch.utils import math3d as m3
    from rrt_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig(width=width, height=height, ns_aa=1, ns_area_light=4,
                       max_ray_depth=5)
    cpu = torch.device("cpu")
    scene, cam = load_scene(CBOX_SPHERES, cpu, 256, 256)
    rend = Renderer(scene, cam, cfg, cpu)
    bh = make_black_hole(cfg, cpu)
    gen = pass_generator(cfg.seed, 0, 0, cpu)
    cam_rays = rend.camera_rays(
        torch.rand((width * height, 2), generator=gen), gen, 1)
    hit = tk.kernel_trace(scene, rend.tables, cam_rays)
    samples = integrator.light_samples(scene, hit, cfg, gen)
    _, _, shadow = integrator.shadow_rays(
        bh, hit, m3.make_coord_space(hit.n), samples, cfg)
    return rend.tables, (("camera closest-hit", cam_rays, False),
                         ("shadow any-hit", shadow, True))


def _flat(rays):
    return (rays.o.reshape(-1, 3).contiguous(),
            rays.d.reshape(-1, 3).contiguous(),
            rays.min_t.reshape(-1).contiguous(),
            rays.max_t.reshape(-1).contiguous())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-r", type=int, nargs=2, default=(256, 256),
                    metavar=("W", "H"))
    ap.add_argument("--dense-lanes", type=int, default=16384)
    args = ap.parse_args(argv)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    tab, batches = _main_path_batches(*args.r)
    rows = []
    for name, rays, occ in batches:
        o, d, mn, mx = _flat(rays)
        rows.append(dict(batch=name, **count(tab, o, d, mn, mx, occ)))
    if args.dense_lanes:
        import numpy as np
        from rrt_tpu_torch.render.renderer import make_black_hole
        from rrt_tpu_torch.scene.build import build_scene
        from rrt_tpu_torch.scenes import cbox_dense
        from rrt_tpu_torch.utils.config import RenderConfig
        cpu = torch.device("cpu")
        dense, _ = build_scene(cbox_dense(), cpu, 128, 128)
        dtab = tk.build_tables(dense, make_black_hole(RenderConfig(), cpu))
        # chip_smoke.py's seeded dense check: origins in the box, uniform
        # directions
        n = args.dense_lanes
        rng = np.random.default_rng(7)
        o = rng.uniform((-0.8, 0.35, -0.8), (0.8, 1.15, 0.8),
                        (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        rows.append(dict(batch="cbox_dense closest-hit", **count(
            dtab, torch.tensor(o), torch.tensor(d), torch.zeros(n),
            torch.full((n,), 1e9), False)))
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
