"""Acceleration-structure diagnostics as files, the headless counterpart of
the reference's BVH visualizer (pathtracer.cpp:330-423, key `V`). The port
of `rrt_tpu/utils/accel_viz.py`.

  * `<base>_accel.json`: the scene's cluster table (each cluster's box and
    triangle rows) and the scene's box, the data the reference's visualizer
    draws as wireframes;
  * `<base>_accel.png`: per pixel, the number of cluster boxes that the
    straight camera ray's [min_t, max_t] touches, on the blue → green → red
    map of the sampling-rate heatmap: the traversal-cost heatmap.

The counts run on the scene's device over chunks of rays, so that the
(rays × clusters) temporaries stay near `TEMP_BYTES` at any frame size.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from rrt_tpu_torch.render import film
from rrt_tpu_torch.types import Rays, SceneData

# bytes of (rays × clusters) temporaries a chunk of rays may hold at once
TEMP_BYTES = 1 << 30
# float32 (rays × clusters) tensors live at once in `reach_counts`
_LIVE_TEMPS = 6


def chunk_rays(n_clusters: int) -> int:
    """Rays per chunk, so that a chunk's temporaries fit in TEMP_BYTES."""
    return max(1, TEMP_BYTES // (4 * _LIVE_TEMPS * max(n_clusters, 1)))


def reach_counts(lo, hi, o, d, t_lo, t_hi) -> torch.Tensor:
    """Per ray, the number of boxes [lo, hi] (K, 3) that the segment
    [t_lo, t_hi] of o + t·d touches (the slab test of the JAX module, one
    axis at a time)."""
    sd = torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    inv = 1.0 / sd
    tmn = tmx = None
    for a in range(3):
        t0 = (lo[None, :, a] - o[:, None, a]) * inv[:, None, a]
        t1 = (hi[None, :, a] - o[:, None, a]) * inv[:, None, a]
        mn, mx = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tmn = mn if tmn is None else torch.maximum(tmn, mn)
        tmx = mx if tmx is None else torch.minimum(tmx, mx)
    reach = (tmn <= tmx) & (tmx >= t_lo[:, None]) & (tmn <= t_hi[:, None])
    return reach.sum(dim=1, dtype=torch.int32)


def touched_cluster_counts(scene: SceneData, rays: Rays) -> np.ndarray:
    """Per ray, the number of cluster boxes its straight [min_t, max_t]
    segment touches, on the scene's device in chunks of `chunk_rays`."""
    dev = scene.device
    lo, hi = scene.cluster_lo.to(dev), scene.cluster_hi.to(dev)
    o = rays.o.reshape(-1, 3).to(dev)
    d = rays.d.reshape(-1, 3).to(dev)
    mn = rays.min_t.reshape(-1).to(dev)
    mx = rays.max_t.reshape(-1).to(dev)
    step = chunk_rays(lo.shape[0])
    return torch.cat([reach_counts(lo, hi, o[i:i + step], d[i:i + step],
                                   mn[i:i + step], mx[i:i + step])
                      for i in range(0, o.shape[0], step)]).cpu().numpy()


def pixel_rays(cam, width: int, height: int, device) -> Rays:
    """One centred camera ray per pixel, rows from the bottom (y up)."""
    ys, xs = np.meshgrid((np.arange(height) + 0.5) / height,
                         (np.arange(width) + 0.5) / width, indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    return cam.generate_rays(torch.as_tensor(xy, device=device))


def dump_accel(scene: SceneData, cam, width: int, height: int,
               base: str) -> np.ndarray:
    """Write `<base>_accel.json` and `<base>_accel.png` (see the module
    doc); returns the (height, width) touched-cluster counts."""
    lo = scene.cluster_lo.cpu().numpy()
    hi = scene.cluster_hi.cpu().numpy()
    cs = scene.cluster_size
    valid = scene.tri_bsdf.cpu().numpy() >= 0
    lo_ok = lo[np.isfinite(lo).all(1) & (lo[:, 0] < 1e30)]
    hi_ok = hi[np.isfinite(hi).all(1) & (hi[:, 0] > -1e30)]
    doc = {
        "cluster_size": cs,
        "n_tris": int(scene.n_tris),
        "n_spheres": int(scene.n_spheres),
        "scene_bbox": {
            "lo": np.minimum.reduce(lo_ok).tolist() if len(lo) else None,
            "hi": np.maximum.reduce(hi_ok).tolist() if len(hi) else None,
        },
        "clusters": [
            {"id": k, "lo": lo[k].tolist(), "hi": hi[k].tolist(),
             "tri_rows": [k * cs, (k + 1) * cs],
             "n_valid_tris": int(valid[k * cs:(k + 1) * cs].sum())}
            for k in range(len(lo))],
    }
    with open(base + "_accel.json", "w") as f:
        json.dump(doc, f, indent=1)
    rays = pixel_rays(cam, width, height, scene.device)
    counts = touched_cluster_counts(scene, rays).reshape(height, width)
    film.save_sampling_rate_image(base + "_accel.png", counts,
                                  max(int(counts.max()), 1))
    return counts
