"""Render configuration: the fields of the port's
`rrt_tpu_torch/utils/config.py` (the reference CLI's surface) that the
configured cells set or that the reference reads, with the same names and
defaults.

Reference: `pathtracer/src/main.cpp:28-150` (flags), `application.h:41-85`
(AppConfig defaults).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
    # black hole (-B)
    black_hole: BlackHoleConfig = dataclasses.field(
        default_factory=BlackHoleConfig)
    # lane budget per sample pass: small frames fold several jittered
    # samples per pixel into one batch to fill the device
    max_pass_lanes: int = 1 << 20
    # RNG seed for the whole render
    seed: int = 0
    # self-intersection offset along the shading normal (at f32 an
    # absolute offset of ~1e-4·scene-scale)
    ray_eps: float = 1e-4
    # closest hits through `trace_diff`, so that renders carry gradients
    differentiable: bool = False
    # NEE shadow-ray chunking: the stacked (light, sample) axis of one
    # occlusion trace holds at most this many entries
    nee_chunk: int = 16
