"""Render statistics and timing (the port's copy of
`rrt_tpu/utils/stats.py`).

The reference's only perf telemetry is CGL::Timer wall-clocks and the BVH
counters `total_rays`/`total_isects` printed at completion
(`pathtracer.cpp:636-638`, `bvh.h:140`). Here the trace counts are
computed from the render configuration and the measured sample counts,
the traversal work comes from the trace kernel's counters, and phases are
timed on the host clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict

from rrt_tpu_torch.physics.schwarzschild import n_segments
from rrt_tpu_torch.utils.config import Illum, RenderConfig


@dataclasses.dataclass
class RenderStats:
    """Trace-call accounting for one render (reference counters analog)."""

    camera_rays: int = 0
    shadow_rays: int = 0
    bounce_rays: int = 0
    geodesic_segments_max: int = 0
    wall_seconds: float = 0.0
    # MEASURED traversal work from the trace kernel's counters: primitive
    # tests and bbox slab tests actually paid, summed over every traced
    # lane. The reference's analog: total_isects, avg ~112 tests/ray on
    # CBbunny (bvh.h:140, pathtracer.cpp:637-638).
    measured_isect_tests: float = 0.0
    measured_bbox_tests: float = 0.0

    @property
    def total_rays(self):
        """= the reference's BVHAccel::total_rays (every bvh->intersect)."""
        return self.camera_rays + self.shadow_rays + self.bounce_rays

    @property
    def isect_tests_per_ray(self) -> float:
        """Measured primitive tests per trace (reference prints ~112 on
        CBbunny config 2)."""
        return self.measured_isect_tests / max(self.total_rays, 1)

    def report(self) -> str:
        lines = [
            f"[PathTracer] Traced {self.total_rays} rays "
            f"({self.camera_rays} camera, {self.shadow_rays} shadow, "
            f"{self.bounce_rays} bounce).",
        ]
        if self.measured_isect_tests:
            lines.append(
                f"[PathTracer] Averaged {self.isect_tests_per_ray:.1f} "
                f"primitive tests and "
                f"{self.measured_bbox_tests / max(self.total_rays, 1):.1f} "
                f"bbox tests per ray (kernel-measured).")
        if self.geodesic_segments_max:
            lines.append(
                f"[PathTracer] Geodesic marching: up to "
                f"{self.geodesic_segments_max} segments per ray.")
        if self.wall_seconds:
            lines.append(
                f"[PathTracer] {self.total_rays / self.wall_seconds:.3g} "
                f"rays/sec over {self.wall_seconds:.2f} sec.")
        return "\n".join(lines)


def expected_stats(cfg: RenderConfig, n_lights_total_samples: int,
                   total_lane_samples: int) -> RenderStats:
    """Exact trace counts for a render.

    n_lights_total_samples = Σ over lights of (1 if delta else
    ns_area_light) — the per-vertex NEE batch height.
    total_lane_samples = Σ over pixels of the measured per-pixel sample
    count (exact under adaptive sampling, not a mean).
    """
    lanes = total_lane_samples
    st = RenderStats(camera_rays=lanes)
    md = cfg.max_ray_depth
    if cfg.illum == Illum.NORMAL:
        pass
    elif cfg.illum == Illum.DIRECT:
        st.shadow_rays = lanes * n_lights_total_samples
    else:
        n_vertices = md if md >= 1 else 0
        if cfg.illum == Illum.INDIRECT:
            # the first vertex skips its whole NEE call (occlusion trace
            # included) — integrator.est_radiance vertex(first=True)
            n_vertices = max(md - 1, 0)
        st.shadow_rays = lanes * n_lights_total_samples * n_vertices
        st.bounce_rays = lanes * max(md - 1, 0)
    if cfg.black_hole.enabled:
        st.geodesic_segments_max = n_segments(cfg.black_hole.delta_theta)
    return st


class PhaseTimer:
    """Named wall-clock phases (CGL::Timer analog)."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - t0

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.2f}s" for k, v in self.phases.items())
