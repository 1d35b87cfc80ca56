"""Light sampling for next-event estimation (the port of
`rrt_tpu/render/lights.py`).

Each call samples one light row for a whole lane batch, as the reference's
per-light loop does (part1_code.cpp:41-55); the environment light
delegates to `scene.envmap`. Uniforms come in as a tensor `xi` (..., 2) so
that the caller decides where they come from.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from rrt_tpu_torch.scene import envmap as envlib
from rrt_tpu_torch.types import (
    LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_ENV, LIGHT_HEMISPHERE, LIGHT_POINT,
    LIGHT_SPOT, EnvMap, LightTable,
)

PI = math.pi


class LightSample(NamedTuple):
    radiance: torch.Tensor  # (..., 3)
    wi: torch.Tensor        # (..., 3) world direction toward the light
    dist: torch.Tensor      # (...,) distance to the light
    pdf: torch.Tensor       # (...,)


def sample_light(lights: LightTable, light_idx: int, p: torch.Tensor,
                 xi: torch.Tensor, env: Optional[EnvMap] = None,
                 env_importance: bool = True) -> LightSample:
    """sample_L of light row `light_idx` (a Python int) at shading points
    p (..., 3), with uniforms xi (..., 2) in [0, 1). An environment row
    reads the map `env`: importance-sampled, or with `env_importance`
    False uniform over the sphere."""
    kind = lights.kind_host[light_idx]
    shape = p.shape[:-1]
    full = lambda v: torch.full(shape, v, dtype=p.dtype, device=p.device)
    rad = torch.broadcast_to(lights.radiance[light_idx], p.shape)

    if kind == LIGHT_DIRECTIONAL:
        return LightSample(
            radiance=rad,
            wi=torch.broadcast_to(lights.direction[light_idx], p.shape),
            dist=full(math.inf), pdf=full(1.0))

    if kind == LIGHT_HEMISPHERE:
        # UniformHemisphereSampler3D (sampler.cpp:15-29), then the z-up
        # sampler frame mapped to the y-up hemisphere (light.cpp:27-32)
        theta = torch.acos(xi[..., 0])
        phi = 2.0 * PI * xi[..., 1]
        dx = torch.sin(theta) * torch.cos(phi)
        dy = torch.sin(theta) * torch.sin(phi)
        dz = torch.cos(theta)
        return LightSample(radiance=rad,
                           wi=torch.stack([dx, -dz, dy], dim=-1),
                           dist=full(math.inf), pdf=full(1.0 / (2.0 * PI)))

    if kind == LIGHT_POINT:
        d = lights.position[light_idx] - p
        sq = torch.sum(d * d, dim=-1)
        pos_ok = sq > 0
        dist = torch.sqrt(torch.where(pos_ok, sq, 1.0))
        return LightSample(radiance=rad, wi=d / dist[..., None],
                           dist=torch.where(pos_ok, dist, 0.0),
                           pdf=full(1.0))

    if kind == LIGHT_SPOT:
        # the reference's SpotLight::sample_L is a stub: zero radiance
        up = torch.zeros_like(p)
        up[..., 1] = 1.0      # filled on the device: no host copy in a pass
        return LightSample(radiance=torch.zeros_like(p), wi=up,
                           dist=full(math.inf), pdf=full(1.0))

    if kind == LIGHT_AREA:
        # AreaLight::sample_L (light.cpp:80-92); a point on the light or a
        # grazing direction gets a large finite pdf, i.e. no contribution
        u = xi - 0.5
        pos = (lights.position[light_idx]
               + u[..., 0:1] * lights.dim_x[light_idx]
               + u[..., 1:2] * lights.dim_y[light_idx])
        d = pos - p
        sq = torch.sum(d * d, dim=-1)
        pos_ok = sq > 0
        dist = torch.sqrt(torch.where(pos_ok, sq, 1.0))
        wi = d / dist[..., None]
        cos_t = torch.sum(wi * lights.direction[light_idx], dim=-1)
        den = lights.area[light_idx] * torch.abs(cos_t)
        den_ok = pos_ok & (den > 0)
        pdf = torch.where(den_ok, sq / torch.where(den_ok, den, 1.0), 1e30)
        rad = torch.where((den_ok & (cos_t < 0))[..., None], rad, 0.0)
        return LightSample(radiance=rad, wi=wi,
                           dist=torch.where(pos_ok, dist, 0.0), pdf=pdf)

    if kind == LIGHT_ENV:
        if env is None:
            raise ValueError("an environment light row without an EnvMap")
        if env_importance:
            rad, wi, dist, pdf = envlib.sample_L(env, xi)
        else:
            # ENV_HEMI == 1 (environment_light.cpp:139-142): ξ₀ gives z,
            # ξ₁ gives φ; pdf 1/4π, radiance looked up along wi
            z = 2.0 * xi[..., 0] - 1.0
            phi = 2.0 * PI * xi[..., 1]
            s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
            wi = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z],
                             dim=-1)
            rad, dist, pdf = (envlib.sample_dir(env, wi), full(math.inf),
                              full(0.25 / PI))
        return LightSample(radiance=rad, wi=wi, dist=dist, pdf=pdf)
    raise ValueError(f"unknown light kind {kind}")


def is_delta_light(lights: LightTable, light_idx: int) -> bool:
    """Delta lights get one NEE sample instead of ns_area_light."""
    return lights.kind_host[light_idx] in (LIGHT_DIRECTIONAL, LIGHT_POINT,
                                           LIGHT_SPOT)
