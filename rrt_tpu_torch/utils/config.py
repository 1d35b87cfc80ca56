"""Render configuration, mirroring the reference's CLI/AppConfig surface
(the port's copy of `rrt_tpu/utils/config.py`: the same fields, names and
defaults).

Reference: `pathtracer/src/main.cpp:28-150` (flags), `application.h:41-85`
(AppConfig defaults), `pathtracer.h:4-6` (ILLUM/ADAPTIVE/THIN_LENS compile
switches — here they are runtime config fields). Two fields steer parts
of the JAX package that the port does not have and steer nothing in the
port (`trace_backend`, `max_dispatch_seconds`); they are kept so that one
set of values configures both packages. `differentiable` is ported
(`render/integrator.py`, `render/diff.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


class Illum:
    """Integrator mode (reference compile-time `ILLUM`, pathtracer.h:4)."""

    NORMAL = 0      # normal shading, deterministic (debug/regression)
    DIRECT = 1      # direct lighting only
    FULL = 2        # full global illumination (default)
    INDIRECT = 3    # indirect only


@dataclasses.dataclass(frozen=True)
class BlackHoleConfig:
    """Schwarzschild black hole parameters (`-B X Y Z R DTHETA`).

    Matches `global_black_hole` defaults: position (0,1,0), r=0.1 (doubles as
    event-horizon and Schwarzschild radius), Δθ=0.1
    (reference `pathtracer/src/static_scene/blackhole.cpp:5`). In the
    reference curvature is ALWAYS on; `enabled=False` is a new capability
    (true flat-spacetime traversal, single straight-segment intersect).
    """

    position: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    radius: float = 0.1
    delta_theta: float = 0.1
    enabled: bool = True


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # -s: camera rays (samples) per pixel
    ns_aa: int = 1
    # -l: samples per area light
    ns_area_light: int = 1
    # -m: max ray depth
    max_ray_depth: int = 1
    # -r W H
    width: int = 800
    height: int = 600
    # -a INT FLOAT: adaptive sampling batch size and tolerance
    samples_per_batch: int = 32
    max_tolerance: float = 0.05
    adaptive: bool = False          # reference compile switch ADAPTIVE
    # -H: direct lighting via uniform hemisphere sampling
    direct_hemisphere_sample: bool = False
    # -b / -d: thin lens
    lens_radius: float = 0.25
    focal_distance: float = 4.7
    thin_lens: bool = False         # reference compile switch THIN_LENS
    # integrator mode (reference ILLUM)
    illum: int = Illum.FULL
    # black hole (-B)
    black_hole: BlackHoleConfig = dataclasses.field(
        default_factory=BlackHoleConfig)
    # env light importance sampling (reference ENV_HEMI == 0 means importance)
    env_importance_sampling: bool = True
    # microfacet cosine-hemisphere fallback (reference MICROFACET_HEMI == 1)
    microfacet_hemi: bool = False
    # acceleration: "bvh" | "brute" (reference ACCEL switch, bvh.h:4)
    accel: str = "bvh"
    # rays per batch of the JAX package's megabatches
    rays_per_batch: int = 1 << 17
    # lane budget per sample pass: small frames fold several jittered
    # samples per pixel into one batch to fill the device
    max_pass_lanes: int = 1 << 20
    # RNG seed for the whole render (reference used unseeded std::rand())
    seed: int = 0
    # self-intersection offset along the shading normal. The reference uses
    # EPS_D=1e-11 on ray origins in double precision (misc.h:12); at f32 an
    # absolute offset of ~1e-4·scene-scale is required instead.
    ray_eps: float = 1e-4
    # closest hits through `trace_diff`, so that renders carry gradients
    # (render/integrator.py, render/diff.py)
    differentiable: bool = False
    # trace backend of the JAX package: "auto" | "pallas" | "xla"; steers
    # nothing in the port (its traces go to the kernel on a card)
    trace_backend: str = "auto"
    # NEE shadow-ray chunking: at -l 64 the reference's per-light sample
    # loop (part1_code.cpp:33-57) becomes a 64-128x lane multiplier if all
    # (light, sample) pairs stack into one occlusion trace; cap the stacked
    # axis at this many entries per trace and loop over chunks instead.
    nee_chunk: int = 16
    # per-dispatch wall budget of the JAX package's dispatch planner
    # (seconds, 0 disables it); steers nothing in the port, which has no
    # planner
    max_dispatch_seconds: float = 120.0

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
