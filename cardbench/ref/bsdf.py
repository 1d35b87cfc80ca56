"""Table-driven BSDF evaluation and sampling of the kinds that the
configured scenes hold: a frozen copy of the diffuse and emission rows of
the port's `rrt_tpu_torch/render/bsdf.py`.

Each lane gathers its material row from the BSDFTable. Directions are in
the local shading frame (z = shading normal). A diffuse row is sampled
cosine-weighted with pdf √(1−ξ₁)/π and evaluates to reflectance/π; an
emission row scatters nothing (bsdf.cpp:33-50). The scene build refuses
every other kind.

Sampling takes its uniforms as tensors: the integrator draws them from
the three keys of `split(key, 3)`, as the program does (the Beckmann and
glass draws are made and not read here).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cardbench.ref.types import BSDF_DIFFUSE, BSDF_EMISSION, BSDFTable

PI = math.pi


class BSDFSample(NamedTuple):
    wi: torch.Tensor      # (..., 3) local sampled direction
    pdf: torch.Tensor     # (...,)
    value: torch.Tensor   # (..., 3) the sample_f return


def _gather(table: BSDFTable, bsdf_id):
    """Per-lane (kind, reflectance, emission) rows (ids < 0 are clipped;
    callers mask them)."""
    i = torch.clamp(bsdf_id, 0, table.kind.shape[0] - 1).long()
    return table.kind[i], table.reflectance[i], table.emission[i]


def emission(table: BSDFTable, bsdf_id):
    """get_emission(): radiance of EmissionBSDF rows, black otherwise."""
    kind, _, emit = _gather(table, bsdf_id)
    is_em = (kind == BSDF_EMISSION) & (bsdf_id >= 0)
    return torch.where(is_em[..., None], emit, 0.0)


def evaluate(table: BSDFTable, bsdf_id, wo, wi):
    """f(wo, wi): reflectance/π on diffuse rows, else 0."""
    kind, refl, _ = _gather(table, bsdf_id)
    out = torch.where((kind == BSDF_DIFFUSE)[..., None], refl / PI, 0.0)
    return torch.where((bsdf_id >= 0)[..., None], out, 0.0)


def sample(table: BSDFTable, bsdf_id, wo, xi) -> BSDFSample:
    """sample_f(wo) for every lane from the uniforms xi (..., 2) in [0, 1):
    a cosine-weighted direction; the value is reflectance/π on diffuse
    rows and 0 on emission rows."""
    kind, refl, _ = _gather(table, bsdf_id)
    xi1, xi2 = xi[..., 0], xi[..., 1]
    r = torch.sqrt(xi1)
    th = 2.0 * PI * xi2
    cos_z = torch.sqrt(1.0 - xi1)
    wi = torch.stack([r * torch.cos(th), r * torch.sin(th), cos_z], dim=-1)
    val = torch.where((kind == BSDF_DIFFUSE)[..., None], refl / PI, 0.0)
    bad = bsdf_id < 0
    pdf = torch.where(bad, 0.0, cos_z / PI)
    val = torch.where(bad[..., None], 0.0, val)
    return BSDFSample(wi=wi, pdf=pdf, value=val)
