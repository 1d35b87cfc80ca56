"""Light sampling for next-event estimation of the kind that the
configured scenes hold: a frozen copy of the area light of the port's
`rrt_tpu_torch/render/lights.py`.

Each call samples one light row for a whole lane batch, as the reference's
per-light loop does (part1_code.cpp:41-55). Uniforms come in as a tensor
`xi` (..., 2): the integrator draws them from each sample's key as the
program draws them. The scene build refuses every other kind of light.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from cardbench.ref.types import LIGHT_AREA, LightTable


class LightSample(NamedTuple):
    radiance: torch.Tensor  # (..., 3)
    wi: torch.Tensor        # (..., 3) world direction toward the light
    dist: torch.Tensor      # (...,) distance to the light
    pdf: torch.Tensor       # (...,)


def sample_light(lights: LightTable, light_idx: int, p: torch.Tensor,
                 xi: torch.Tensor) -> LightSample:
    """sample_L of the area light row `light_idx` (a Python int) at shading
    points p (..., 3), with uniforms xi (..., 2) in [0, 1)
    (AreaLight::sample_L, light.cpp:80-92); a point on the light or a
    grazing direction gets a large finite pdf, i.e. no contribution."""
    if lights.kind_host[light_idx] != LIGHT_AREA:
        raise ValueError(f"light kind {lights.kind_host[light_idx]}: the "
                         "reference samples area lights only")
    rad = torch.broadcast_to(lights.radiance[light_idx], p.shape)
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
