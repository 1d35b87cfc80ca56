"""Render loop (the port of `rrt_tpu/render/renderer.py`).

A render is a host loop over sample passes. Each pass traces k jittered
samples for every pixel as one batch of k·W·H lanes,
k = min(ns_aa, max_pass_lanes // (W·H)), and accumulates the radiance sum,
the luminance sums s1, s2 and the per-pixel sample count. The tail pass
runs the same k with its surplus samples masked. Adaptive sampling
(part1_code.cpp:147-159) freezes a pixel once 1.96·σ/√n ≤ tol·mean at a
batch boundary; a frozen pixel's lanes end at once.

Every pass draws its random numbers from its own `torch.Generator`,
seeded from (cfg.seed, first sample index of the pass, band index), so a
render is reproducible on one device. The port renders the whole frame
as one band (index 0).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from rrt_tpu_torch.convert import black_hole_from_arrays
from rrt_tpu_torch.ops.trace_kernel import build_tables
from rrt_tpu_torch.render import film
from rrt_tpu_torch.render.integrator import _mask_rays, est_radiance
from rrt_tpu_torch.render.lights import is_delta_light
from rrt_tpu_torch.scene.camera import Camera
from rrt_tpu_torch.types import BlackHoleParams, SceneData
from rrt_tpu_torch.utils.config import Illum, RenderConfig
from rrt_tpu_torch.utils.stats import PhaseTimer, RenderStats


def make_black_hole(cfg: RenderConfig, device) -> Optional[BlackHoleParams]:
    b = cfg.black_hole
    if not b.enabled:
        return None
    return black_hole_from_arrays(b.position, b.radius, b.delta_theta, device)


def pass_generator(seed: int, sample_idx: int, band: int, device
                   ) -> torch.Generator:
    """The generator of one (pass, band), derived from the render seed."""
    state = np.random.SeedSequence([seed, sample_idx, band]).generate_state(2)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


class Renderer:
    """Progressive whole-frame renderer with adaptive sampling, on the
    scene's device."""

    def __init__(self, scene: SceneData, camera: Camera, cfg: RenderConfig,
                 device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if scene.device != self.device:
            raise ValueError(f"scene is on {scene.device}, renderer on "
                             f"{self.device}")
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.bh = make_black_hole(cfg, self.device)
        # the traversal's tables, built once for every trace of the render
        self.tables = build_tables(scene, self.bh)
        self.timer = PhaseTimer()
        self.last_accumulators = None
        self.last_sample_count = None
        self.last_trace_tests = None
        self.last_trace_calls = 0
        self.samples_done = 0

    def samples_per_pass(self, n: int) -> int:
        cfg = self.cfg
        k = max(1, min(cfg.ns_aa, cfg.max_pass_lanes // max(n, 1)))
        if cfg.adaptive:
            while cfg.samples_per_batch % k != 0:
                k -= 1
        return k

    def camera_rays(self, jitter, gen, k: int):
        """The k·W·H camera rays of one pass, pixel (x + jitter) / size,
        sample-major; a jitter of one row is shared by every lane."""
        cfg, dev = self.cfg, self.device
        ys, xs = torch.meshgrid(
            torch.arange(cfg.height, dtype=torch.float32, device=dev),
            torch.arange(cfg.width, dtype=torch.float32, device=dev),
            indexing="ij")
        px = torch.stack([xs, ys], dim=-1).reshape(-1, 2).repeat(k, 1)
        m = px.shape[0]
        if jitter.shape[0] != m:                 # centred single sample
            jitter = jitter[:1].expand(m, 2)
        xy = (px + jitter) / torch.tensor([cfg.width, cfg.height],
                                          dtype=torch.float32, device=dev)
        if cfg.thin_lens:
            rnd_r = torch.rand((m,), generator=gen, device=dev)
            rnd_th = torch.rand((m,), generator=gen, device=dev) * 2.0 * math.pi
            return self.camera.generate_rays_thin_lens(xy, rnd_r, rnd_th)
        return self.camera.generate_rays(xy)

    def _sample_pass(self, acc, gen, sample_idx: int, n_valid: int, k: int):
        """Trace k samples of every pixel in one batch of k·n lanes and
        accumulate the first n_valid of them into acc = (radiance sum
        (n,3), s1, s2, count, done)."""
        cfg, dev = self.cfg, self.device
        rad_sum, s1, s2, count, done = acc
        n = cfg.width * cfg.height
        if cfg.ns_aa == 1:
            jitter = torch.full((n, 2), 0.5, device=dev)
        else:
            jitter = torch.rand((k * n, 2), generator=gen, device=dev)
        rays = self.camera_rays(jitter, gen, k)
        active = ~done
        valid_k = torch.arange(k, device=dev) < n_valid
        lane_live = active.repeat(k) & valid_k.repeat_interleave(n)
        rays = _mask_rays(rays, lane_live, self.bh)
        L, work = est_radiance(self.scene, self.bh, rays, cfg, gen,
                               self.tables)
        L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        L = torch.where(valid_k[:, None, None], L.reshape(k, n, 3), 0.0)

        rad_sum = rad_sum + torch.where(active[:, None], L.sum(0), 0.0)
        illum = 0.2126 * L[..., 0] + 0.7152 * L[..., 1] + 0.0722 * L[..., 2]
        s1 = s1 + torch.where(active, illum.sum(0), 0.0)
        s2 = s2 + torch.where(active, (illum * illum).sum(0), 0.0)
        count = count + n_valid * active.to(torch.int32)
        if cfg.adaptive and (sample_idx + n_valid) % cfg.samples_per_batch == 0:
            i1 = count.to(torch.float32)
            avg = s1 / torch.clamp(i1, min=1.0)
            var = (s2 - avg * s1) / torch.clamp(i1 - 1.0, min=1.0)
            sd = torch.sqrt(torch.clamp(var, min=0.0))
            conv = (1.96 * sd / torch.sqrt(torch.clamp(i1, min=1.0))
                    <= cfg.max_tolerance * avg)
            done = done | (active & conv)
        return (rad_sum, s1, s2, count, done), work

    def render(self, progress=None) -> Tuple[np.ndarray, np.ndarray]:
        """Render the frame. Returns (hdr (H,W,3), sample count (H,W)) as
        numpy arrays; the accumulators stay on the device until the end."""
        cfg, dev = self.cfg, self.device
        n = cfg.width * cfg.height
        k = self.samples_per_pass(n)
        acc = (torch.zeros((n, 3), device=dev), torch.zeros(n, device=dev),
               torch.zeros(n, device=dev),
               torch.zeros(n, dtype=torch.int32, device=dev),
               torch.zeros(n, dtype=torch.bool, device=dev))
        tests = torch.zeros(2, dtype=torch.float64, device=dev)
        calls = 0
        s = 0
        while s < cfg.ns_aa:
            ks = min(k, cfg.ns_aa - s)
            with self.timer.phase("passes"):
                acc, work = self._sample_pass(
                    acc, pass_generator(cfg.seed, s, 0, dev), s, ks, k)
                tests = tests + work.tests
                calls += work.calls
            s += ks
            if cfg.adaptive and s % cfg.samples_per_batch == 0 \
                    and bool(torch.all(acc[4])):
                break
            if progress is not None:
                progress(s, cfg.ns_aa)
        with self.timer.phase("passes"):        # waits for the device
            rad_sum = acc[0].cpu().numpy()
            count = acc[3].cpu().numpy().reshape(cfg.height, cfg.width)
        self.last_accumulators = tuple(a.cpu().numpy() for a in acc)
        self.last_sample_count = count
        self.last_trace_tests = tests.cpu().numpy()
        self.last_trace_calls = calls
        self.samples_done = s
        hdr = (rad_sum.reshape(cfg.height, cfg.width, 3)
               / np.maximum(count[..., None], 1))
        return hdr, count

    def stats(self, wall_seconds: float = 0.0) -> RenderStats:
        """Trace counts of the last render (the reference's total_rays;
        every lane is traced in lockstep, so the counts are exact), with
        the kernel-measured primitive and bbox tests."""
        cfg = self.cfg
        nls = sum(1 if is_delta_light(self.scene.lights, i)
                  else cfg.ns_area_light
                  for i in range(len(self.scene.lights.kind_host)))
        lanes = (int(self.last_sample_count.sum())
                 if self.last_sample_count is not None
                 else cfg.ns_aa * cfg.width * cfg.height)
        st = RenderStats(camera_rays=lanes, wall_seconds=wall_seconds)
        md = cfg.max_ray_depth
        if cfg.illum == Illum.DIRECT:
            st.shadow_rays = lanes * nls
        elif cfg.illum != Illum.NORMAL:
            # an INDIRECT render skips the first vertex's shadow queries
            n_vertices = max(md - 1, 0) if cfg.illum == Illum.INDIRECT \
                else max(md, 0)
            st.shadow_rays = lanes * nls * n_vertices
            st.bounce_rays = lanes * max(md - 1, 0)
        if self.tables.curved:
            st.geodesic_segments_max = self.tables.n_seg
        if self.last_trace_tests is not None:
            st.measured_isect_tests = float(self.last_trace_tests[0])
            st.measured_bbox_tests = float(self.last_trace_tests[1])
        return st

    def render_to_file(self, path: str, progress=None) -> np.ndarray:
        """Headless render → PNG, plus the reference's sampling-rate
        heatmap `<name>_rate.png` (pathtracer.cpp:684)."""
        hdr, count = self.render(progress=progress)
        film.save_image(path, hdr)
        base = path[:-4] if path.endswith(".png") else path
        film.save_sampling_rate_image(base + "_rate.png", count,
                                      self.cfg.ns_aa)
        return hdr
