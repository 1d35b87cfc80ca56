"""Per-pixel ray log, the headless counterpart of the reference's rayLog and
ray drawing (pathtracer.cpp:330-423: key `V` draws logged camera rays,
yellow for a hit, red for a miss). The port of `rrt_tpu/utils/ray_debug.py`.

  * `<base>_raylog.npz`, per pixel (rows from the bottom):
      outcome    (H,W) int8: 0 miss or escape, 1 geometry hit, 2 absorbed
                 by the event horizon
      win_seg    (H,W) int16: the winning chord (n_seg when there is none)
      marched    (H,W) int16: chords marched up to the ray's event
      clusters   (H,W) int32: cluster boxes its marched chords touch, the
                 per-ray traversal cost
      prim       (H,W) int32: the winning primitive (-1 when none)
  * `<base>_raylog_cost.png`: the `clusters` heatmap (blue → green → red)
  * `<base>_raylog_seg.png`: the `win_seg` heatmap
  * `<base>_raylog_hit.png`: yellow hit, red miss (the reference's ray
    colours), black absorbed

The hit, prim and winning chord come from `geometry/trace.trace_with_seg`,
which on a CUDA scene is the hand-written trace kernel. The march is then
replayed with `physics/schwarzschild.micro_step` over chunks of rays to
classify absorption and count the clusters each chord touches.
"""
from __future__ import annotations

import numpy as np
import torch

from rrt_tpu_torch.geometry.trace import trace_with_seg
from rrt_tpu_torch.ops.trace_kernel import build_tables
from rrt_tpu_torch.physics.schwarzschild import absorbed_by_hole, micro_step
from rrt_tpu_torch.render import film
from rrt_tpu_torch.types import SceneData
from rrt_tpu_torch.utils.accel_viz import (chunk_rays, pixel_rays,
                                          reach_counts,
                                          touched_cluster_counts)


def _replay(scene: SceneData, bh, o, d, seg, n_seg: int):
    """The march of (o, d) replayed for n_seg chords (the reference's
    bvh.cpp:103-113 loop): returns (absorbed at or before the winning
    chord, chords marched, clusters touched by those chords). Chord s
    counts while s ≤ seg and no earlier chord was absorbed, which is the
    JAX module's `s < marched`."""
    lo, hi = scene.cluster_lo, scene.cluster_hi
    n = o.shape[0]
    pos, dirn = o, d
    dead = torch.zeros(n, dtype=torch.bool, device=o.device)
    absorbed_before = torch.zeros_like(dead)
    abs_seg = torch.full((n,), n_seg, dtype=torch.int32, device=o.device)
    clusters = torch.zeros(n, dtype=torch.int32, device=o.device)
    zero = torch.zeros(n, dtype=o.dtype, device=o.device)
    for s in range(n_seg):
        nd, clen, sdead = micro_step(pos, dirn, bh)
        dead = dead | sdead
        clen = torch.where(dead, 0.0, clen)
        absorbed = absorbed_by_hole(pos, nd, clen, bh) & ~dead
        counted = (s <= seg) & ~absorbed_before
        clusters += torch.where(
            counted, reach_counts(lo, hi, pos, nd, zero, clen), 0)
        abs_seg = torch.where(absorbed & ~absorbed_before, s, abs_seg)
        absorbed_before = absorbed_before | absorbed
        pos = pos + nd * clen[..., None]
        dirn = nd
    marched = torch.clamp(torch.minimum(seg, abs_seg) + 1, max=n_seg)
    return absorbed_before & (abs_seg <= seg), marched, clusters


def ray_log(scene: SceneData, bh, cam, width: int, height: int) -> dict:
    """The per-pixel ray log of one centred camera ray per pixel: a dict
    of (height, width) numpy arrays (see the module doc)."""
    dev = scene.device
    rays = pixel_rays(cam, width, height, dev)
    tab = build_tables(scene, bh)
    with torch.no_grad():
        hit, seg, _ = trace_with_seg(scene, bh, rays, tab)
        # the winning chord of a geometry hit; n_seg for every other lane
        # (the kernel reports an absorbed or dead lane's own chord there)
        seg = torch.where(hit.hit, seg, tab.n_seg)
        n = width * height
        if tab.curved:
            step = chunk_rays(scene.cluster_lo.shape[0])
            parts = [_replay(scene, bh, rays.o[i:i + step],
                             rays.d[i:i + step], seg[i:i + step], tab.n_seg)
                     for i in range(0, n, step)]
            absorbed, marched, clusters = (torch.cat(p) for p in zip(*parts))
            clusters = clusters.cpu().numpy()
            absorbed = absorbed & ~hit.hit
        else:
            marched = torch.ones(n, dtype=torch.int32, device=dev)
            absorbed = torch.zeros(n, dtype=torch.bool, device=dev)
            clusters = touched_cluster_counts(scene, rays)
        outcome = torch.where(hit.hit, 1, torch.where(absorbed, 2, 0))
    shape = (height, width)
    host = lambda t, dtype: t.cpu().numpy().astype(dtype).reshape(shape)
    return {"outcome": host(outcome, np.int8),
            "win_seg": host(seg, np.int16),
            "marched": host(marched, np.int16),
            "clusters": np.asarray(clusters, np.int32).reshape(shape),
            "prim": host(hit.prim_id, np.int32)}


def dump_ray_log(scene: SceneData, bh, cam, width: int, height: int,
                 base: str) -> dict:
    """Write `<base>_raylog.npz` and the three PNG panels; returns the
    log."""
    log = ray_log(scene, bh, cam, width, height)
    np.savez(base + "_raylog.npz", **log)
    n_seg = build_tables(scene, bh).n_seg
    film.save_sampling_rate_image(base + "_raylog_cost.png", log["clusters"],
                                  max(int(log["clusters"].max()), 1))
    film.save_sampling_rate_image(base + "_raylog_seg.png",
                                  log["win_seg"].astype(np.int32), n_seg)
    out = log["outcome"]
    img = np.zeros(out.shape + (4,), np.uint8)
    img[..., 3] = 255
    img[out == 1] = (255, 230, 0, 255)     # hit: yellow (pathtracer.cpp:403)
    img[out == 0] = (200, 30, 30, 255)     # miss: red (pathtracer.cpp:412)
    img[out == 2] = (0, 0, 0, 255)         # absorbed: black (the hole)
    film.write_png(base + "_raylog_hit.png", img[::-1])
    return log
