"""Benchmark of the port on one CUDA card: `python -m rrt_tpu_torch.bench`.

The port of the JAX package's `bench.py`. It runs on a card only, and in
this order; any failure raises:

1. `ops.probe.probe`: the toolchain probe kernel must build, launch and
   sum to 2048 (the JAX bench's `PROBE`, without its subprocess, sleep
   and fallback backend);
2. the build of the trace kernel's library, timed apart from the renders
   (`build_cached` when a library of the same hash was already built);
3. the primary cell: the in-repo Cornell box (`scenes.CBOX_SPHERES`),
   256×256, 16 spp, 4 area-light samples, depth 5, seed 0, default black
   hole; two warm-up renders (the first runs the pass eagerly, the second
   captures it as a CUDA graph), then `TIMED_RENDERS` timed renders, each
   ending in a device sync; the headline is their median;
4. the BVH-scale cell: `scenes.cbox_dense()` (28,608 triangle rows, 14
   parts, clusters of 8), 128×128, 1 spp, 1 light sample, depth 2; timed
   the same way.

It prints one JSON line on stdout with the JAX bench's keys where they
still mean something on this card (`vs_baseline` is gone: its denominator
was measured on another host; `bunny_camera_rays_per_sec` is
`bvh_camera_rays_per_sec`, since the scene is not the bunny), after a line
on stderr with every timed wall (their spread) and each cell's host spans
(`utils.stats.report`).
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from rrt_tpu_torch.utils.config import RenderConfig
from rrt_tpu_torch.utils import stats
from rrt_tpu_torch.utils.stats import RenderStats

METRIC = "camera_rays_per_sec_curved_gi_256x256_16spp_d5"
PRIMARY = dict(width=256, height=256, ns_aa=16, ns_area_light=4,
               max_ray_depth=5, seed=0)
BVH = dict(width=128, height=128, ns_aa=1, ns_area_light=1, max_ray_depth=2,
           seed=0)
# the JAX bench's model of USEFUL flops (bench.py): the geodesic march,
# one Moller-Trumbore test per trace for the winning primitive, and a
# shading estimate per camera ray; traversal over-testing is not useful
FLOPS_PER_GEODESIC_STEP = 58
FLOPS_PER_TRACE = 40
FLOPS_PER_CAMERA_RAY = 200
# timed renders of each cell; the headline takes their median
TIMED_RENDERS = 5


def useful_flops(st: RenderStats) -> float:
    """Modelled useful flops of a render with these trace counts."""
    return float(st.total_rays * st.geodesic_segments_max
                 * FLOPS_PER_GEODESIC_STEP
                 + st.total_rays * FLOPS_PER_TRACE
                 + st.camera_rays * FLOPS_PER_CAMERA_RAY)


def bench_result(primary: RenderStats, bvh: RenderStats,
                 mean_radiance: float, build_seconds: float,
                 build_cached: bool, fp32_peak: float, card: str) -> dict:
    """The bench's JSON object from the two timed renders' stats (their
    `wall_seconds` set), the primary image's mean radiance, the trace
    library's build, the card's float32 peak (flop/s) and its
    `name, power limit` line."""
    wall, bwall = primary.wall_seconds, bvh.wall_seconds
    name, _, power = card.rpartition(", ")
    return {
        "metric": METRIC,
        "value": primary.camera_rays / wall,
        "unit": "rays/s/gpu",
        "marched_rays_per_sec": primary.total_rays / wall,
        "geodesic_steps_per_sec":
            primary.total_rays * primary.geodesic_segments_max / wall,
        "mfu_lower_bound_pct":
            100.0 * useful_flops(primary) / wall / fp32_peak,
        "fp32_peak_tflops": fp32_peak / 1e12,
        "bvh_camera_rays_per_sec": bvh.camera_rays / bwall,
        "trace_backend": "cuda",
        "build_seconds": build_seconds,
        "build_cached": build_cached,
        "prim_tests_per_ray": primary.isect_tests_per_ray,
        "bbox_tests_per_ray":
            primary.measured_bbox_tests / max(primary.total_rays, 1),
        "bvh_prim_tests_per_ray": bvh.isect_tests_per_ray,
        "bvh_bbox_tests_per_ray":
            bvh.measured_bbox_tests / max(bvh.total_rays, 1),
        "mean_radiance": mean_radiance,
        "wall_seconds": wall,
        "bvh_wall_seconds": bwall,
        "device": name,
        "power_limit": power,
    }


def _timed_render(renderer, device, reps: int = TIMED_RENDERS):
    """Two warm-up renders (the pass's eager run and its capture), then
    `reps` timed renders, each ending in a device sync. Returns (hdr,
    stats with the median wall, the walls, the trace calls of all the
    renders)."""
    calls = 0
    for _ in range(2):
        renderer.render()
        calls += renderer.last_trace_calls
    torch.cuda.synchronize(device)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        hdr, _ = renderer.render()
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
        calls += renderer.last_trace_calls
    return hdr, renderer.stats(float(np.median(walls))), walls, calls


def _walls(walls) -> str:
    return ",".join(f"{w:.4f}" for w in walls)


def run(device):
    """The four phases on the CUDA `device`. Returns (the JSON object,
    the stderr diagnostics, the trace calls of the renders)."""
    from rrt_tpu_torch.ops import build
    from rrt_tpu_torch.ops.probe import probe
    from rrt_tpu_torch.render.renderer import Renderer
    from rrt_tpu_torch.scene.build import build_scene, load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES, cbox_dense
    from rrt_tpu_torch.utils.card import (card_line, fp32_peak_flops,
                                          max_sm_clock_mhz)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the bench measures a CUDA card, not {device}")
    probe(device)

    build_cached = build.library_path("trace").exists()
    t0 = time.perf_counter()
    build.load_library("trace")
    build_seconds = time.perf_counter() - t0

    stats.reset()
    cfg = RenderConfig(**PRIMARY)
    scene, cam = load_scene(CBOX_SPHERES, device, cfg.width, cfg.height)
    r = Renderer(scene, cam, cfg, device)
    hdr, st, walls, calls = _timed_render(r, device)
    phases = stats.report()

    stats.reset()
    bcfg = RenderConfig(**BVH)
    bscene, bcam = build_scene(cbox_dense(), device, bcfg.width, bcfg.height)
    br = Renderer(bscene, bcam, bcfg, device)
    _, bst, bwalls, bcalls = _timed_render(br, device)

    card = card_line()
    peak = fp32_peak_flops(device, max_sm_clock_mhz())
    out = bench_result(st, bst, float(np.mean(hdr)), build_seconds,
                       build_cached, peak, card)
    diag = (f"# wall={st.wall_seconds:.4f}s (median of {_walls(walls)}) "
            f"bvh_wall={bst.wall_seconds:.4f}s (median of {_walls(bwalls)}) "
            f"mean_radiance={out['mean_radiance']:.4f} device={device} "
            f"({card}) phases[{phases}] bvh_phases[{stats.report()}] "
            f"trace_calls={calls + bcalls}")
    return out, diag, calls + bcalls


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the bench measures a card",
              file=sys.stderr)
        return 2
    out, diag, _ = run(torch.device("cuda", torch.cuda.current_device()))
    print(diag, file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
