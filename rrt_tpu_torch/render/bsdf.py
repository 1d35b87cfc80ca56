"""Table-driven BSDF evaluation and sampling (the port of
`rrt_tpu/render/bsdf.py`).

Each lane gathers its material row from the BSDFTable; all six models
are evaluated and the lane's kind selects the result. Directions are in
the local shading frame (z = shading normal). The reference's quirks are
kept: cosine-weighted diffuse sampling with pdf √(1−ξ₁)/π, the erf-form
Smith Λ and conductor Fresnel of the microfacet model, the refraction stub
that scatters nothing, and glass feeding the refracted cosine into
Schlick (bsdf.cpp:33-171).

Sampling takes its uniforms as tensors (`xi`, `xim`, `xic`): the
integrator draws them from the three keys of `split(key, 3)`, as the JAX
package's `sample` does (rrt_tpu/render/bsdf.py:184-227), and tests hand
both packages the same ones.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rrt_tpu_torch.types import (
    BSDF_DIFFUSE, BSDF_EMISSION, BSDF_GLASS, BSDF_MICROFACET, BSDF_MIRROR,
    BSDF_REFRACTION, BSDFTable,
)

PI = math.pi


class BSDFSample(NamedTuple):
    wi: torch.Tensor      # (..., 3) local sampled direction
    pdf: torch.Tensor     # (...,)
    value: torch.Tensor   # (..., 3) the sample_f return (f or delta weight)


def _gather(table: BSDFTable, bsdf_id) -> BSDFTable:
    """Per-lane material rows (ids < 0 are clipped; callers mask them)."""
    i = torch.clamp(bsdf_id, 0, table.kind.shape[0] - 1).long()
    return BSDFTable(kind=table.kind[i], reflectance=table.reflectance[i],
                     transmittance=table.transmittance[i],
                     emission=table.emission[i], eta=table.eta[i],
                     k=table.k[i], alpha=table.alpha[i], ior=table.ior[i])


def emission(table: BSDFTable, bsdf_id):
    """get_emission(): radiance of EmissionBSDF rows, black otherwise."""
    m = _gather(table, bsdf_id)
    is_em = (m.kind == BSDF_EMISSION) & (bsdf_id >= 0)
    return torch.where(is_em[..., None], m.emission, 0.0)


def is_delta(table: BSDFTable, bsdf_id):
    m = _gather(table, bsdf_id)
    return m.is_delta() & (bsdf_id >= 0)


def _safe_alpha(alpha):
    return torch.clamp(alpha, min=1e-4)


def _mf_lambda(w, alpha):
    """Smith Λ in the reference's erf form, θ clamped through
    acos(clamp(z, ±(1−1e-5))) (bsdf.h:169-173)."""
    z = torch.clamp(w[..., 2], -1.0 + 1e-5, 1.0 - 1e-5)
    tan_t = torch.clamp(torch.tan(torch.acos(z)), 1e-6, 1e6)
    a = 1.0 / (_safe_alpha(alpha) * tan_t)
    return 0.5 * (torch.erf(a) - 1.0 + torch.exp(-a * a) / (a * PI))


def _mf_G(wo, wi, alpha):
    return 1.0 / (1.0 + _mf_lambda(wi, alpha) + _mf_lambda(wo, alpha))


def _mf_D(h, alpha):
    z = torch.clamp(h[..., 2], -1.0 + 1e-5, 1.0 - 1e-5)
    tan_t = torch.tan(torch.acos(z))
    cos2 = torch.clamp(h[..., 2] * h[..., 2], min=1e-12)
    a2 = _safe_alpha(alpha) ** 2
    return torch.exp(-tan_t * tan_t / a2) / (PI * a2 * cos2 * cos2)


def _mf_F(wi, eta, k):
    """Air→conductor Fresnel, (Rs + Rp)/2 (bsdf.cpp:58-66); denominators
    that vanish only on rows the kind selects away are guarded."""
    e2k2 = eta * eta + k * k
    ci = wi[..., 2:3]
    ci2 = ci * ci
    two_eta_ci = 2.0 * eta * ci
    den_s = e2k2 + two_eta_ci + ci2
    den_p = e2k2 * ci2 + two_eta_ci + 1.0
    safe = lambda dd: torch.where(torch.abs(dd) < 1e-12, 1.0, dd)
    rs = (e2k2 - two_eta_ci + ci2) / safe(den_s)
    rp = (e2k2 * ci2 - two_eta_ci + 1.0) / safe(den_p)
    return (rs + rp) / 2.0


def _mf_f(wo, wi, eta, k, alpha):
    ok = (wo[..., 2] > 0) & (wi[..., 2] > 0)
    up = torch.zeros_like(wo)
    up[..., 2] = 1.0
    wo = torch.where(ok[..., None], wo, up)
    wi = torch.where(ok[..., None], wi, up)
    hsum = wo + wi
    n2 = torch.sum(hsum * hsum, dim=-1, keepdim=True)
    h = hsum / torch.sqrt(torch.where(n2 > 0, n2, 1.0))
    val = (_mf_F(wi, eta, k)
           * (_mf_G(wo, wi, alpha) * _mf_D(h, alpha))[..., None]
           / (4.0 * wo[..., 2:3] * wi[..., 2:3]))
    return torch.where(ok[..., None], val, 0.0)


def evaluate(table: BSDFTable, bsdf_id, wo, wi):
    """f(wo, wi): nonzero only for diffuse and microfacet rows."""
    m = _gather(table, bsdf_id)
    f_mf = _mf_f(wo, wi, m.eta, m.k, m.alpha)
    out = torch.where((m.kind == BSDF_DIFFUSE)[..., None],
                      m.reflectance / PI, 0.0)
    out = torch.where((m.kind == BSDF_MICROFACET)[..., None], f_mf, out)
    return torch.where((bsdf_id >= 0)[..., None], out, 0.0)


def _reflect(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def _refract(wo, ior):
    """Snell with total internal reflection (bsdf.cpp:146-159). Returns
    (ok, wi); non-glass rows (ior = 0) are clamped to 1."""
    ior = torch.where(ior > 0, ior, 1.0)
    eta = torch.where(wo[..., 2] > 0, 1.0 / ior, ior)
    wi_z2 = 1.0 - eta * eta * (1.0 - wo[..., 2] * wo[..., 2])
    ok = wi_z2 >= 0
    pos = wi_z2 > 1e-12
    z = torch.where(pos, torch.sqrt(torch.where(pos, wi_z2, 1.0)), 0.0)
    z = torch.where(wo[..., 2] > 0, -z, z)
    wi = torch.stack([-eta * wo[..., 0], -eta * wo[..., 1], z], dim=-1)
    return ok, wi


def sample(table: BSDFTable, bsdf_id, wo, xi, xim, xic,
           microfacet_hemi: bool = False) -> BSDFSample:
    """sample_f(wo) for every lane, every model computed, kind-selected.

    xi (..., 2) drives the cosine-hemisphere sampler, xim (..., 2) the
    Beckmann half-vector, xic (...,) the glass coin; all uniform in [0,1).
    `microfacet_hemi=True` is the reference's MICROFACET_HEMI switch:
    cosine-hemisphere proposals for the microfacet lobe."""
    m = _gather(table, bsdf_id)
    xi1, xi2 = xi[..., 0], xi[..., 1]

    # diffuse / emission: cosine-weighted
    r = torch.sqrt(xi1)
    th = 2.0 * PI * xi2
    cos_z = torch.sqrt(1.0 - xi1)
    wi_cos = torch.stack([r * torch.cos(th), r * torch.sin(th), cos_z],
                         dim=-1)
    pdf_cos = cos_z / PI
    val_diff = m.reflectance / PI

    # mirror
    wi_mir = _reflect(wo)
    val_mir = m.reflectance / torch.clamp(torch.abs(wi_mir[..., 2:3]),
                                          min=1e-12)

    # microfacet: Beckmann half-vector importance sampling
    a2 = _safe_alpha(m.alpha) ** 2
    # a safe square root: ξ = 0 gives tan²θ_h = 0, whose d/dα is 0/0
    tan2_h = -a2 * torch.log1p(-xim[..., 0])
    pos_h = tan2_h > 0
    theta_h = torch.atan(torch.where(
        pos_h, torch.sqrt(torch.where(pos_h, tan2_h, 1.0)), 0.0))
    phi_h = 2.0 * PI * xim[..., 1]
    sin_h, cos_h = torch.sin(theta_h), torch.cos(theta_h)
    tan_h = torch.tan(theta_h)
    p_theta = (2.0 * sin_h * torch.exp(-tan_h * tan_h / a2)
               / (a2 * cos_h * cos_h * cos_h))
    p_phi = 0.5 / PI
    h = torch.stack([sin_h * torch.cos(phi_h), sin_h * torch.sin(phi_h),
                     cos_h], dim=-1)
    wi_mf = 2.0 * torch.sum(wo * h, dim=-1, keepdim=True) * h - wo
    below = wi_mf[..., 2] <= 0
    mf_denom = sin_h * 4.0 * torch.sum(wi_mf * h, dim=-1)
    small = torch.abs(mf_denom) <= 1e-12
    pdf_mf = p_theta * p_phi / torch.where(small, 1.0, mf_denom)
    pdf_mf = torch.where(below | small, 0.0, pdf_mf)
    val_mf = torch.where(below[..., None], 0.0,
                         _mf_f(wo, wi_mf, m.eta, m.k, m.alpha))

    # glass
    can_refract, wi_refr = _refract(wo, m.ior)
    ior_g = torch.where(m.ior > 0, m.ior, 1.0)
    r0 = ((1.0 - ior_g) / (1.0 + ior_g)) ** 2
    tt = 1.0 - torch.abs(wi_refr[..., 2])
    schlick = r0 + (1.0 - r0) * tt * tt * tt * tt * tt
    coin = xic < schlick
    eta_g = torch.where(wo[..., 2] > 0, 1.0 / ior_g, ior_g)
    use_reflect = ~can_refract | coin
    wi_glass = torch.where(use_reflect[..., None], _reflect(wo), wi_refr)
    pdf_glass = torch.where(~can_refract, 1.0,
                            torch.where(coin, schlick, 1.0 - schlick))
    w_refl = torch.where(~can_refract, 1.0, schlick)[..., None] \
        * m.reflectance
    abs_z = torch.clamp(torch.abs(wi_glass[..., 2:3]), min=1e-12)
    val_glass = torch.where(
        use_reflect[..., None], w_refl / abs_z,
        ((1.0 - schlick) / (abs_z[..., 0] * eta_g * eta_g))[..., None]
        * m.transmittance)

    if microfacet_hemi:
        wi_mf = wi_cos
        pdf_mf = pdf_cos
        val_mf = _mf_f(wo, wi_cos, m.eta, m.k, m.alpha)

    kind = m.kind
    sel3 = lambda k, a, b: torch.where((kind == k)[..., None], a, b)
    wi = sel3(BSDF_MIRROR, wi_mir, wi_cos)
    wi = sel3(BSDF_MICROFACET, wi_mf, wi)
    wi = sel3(BSDF_GLASS, wi_glass, wi)

    pdf = torch.where(kind == BSDF_MIRROR, 1.0, pdf_cos)
    pdf = torch.where(kind == BSDF_MICROFACET, pdf_mf, pdf)
    pdf = torch.where(kind == BSDF_GLASS, pdf_glass, pdf)
    pdf = torch.where(kind == BSDF_REFRACTION, 0.0, pdf)

    val = torch.where((kind == BSDF_DIFFUSE)[..., None], val_diff, 0.0)
    val = sel3(BSDF_MIRROR, val_mir, val)
    val = sel3(BSDF_MICROFACET, val_mf, val)
    val = sel3(BSDF_GLASS, val_glass, val)

    bad = bsdf_id < 0
    pdf = torch.where(bad, 0.0, pdf)
    val = torch.where(bad[..., None], 0.0, val)
    return BSDFSample(wi=wi, pdf=pdf, value=val)
