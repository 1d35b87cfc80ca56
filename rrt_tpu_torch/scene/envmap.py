"""Lat-long HDR environment light: CDF tables, importance sampling and
direction lookup (the port of `rrt_tpu/scene/envmap.py`).

As in the reference (environment_light.cpp): the tables are a
sin θ-weighted luminance pdf with row-marginal and per-row conditional
CDFs (:21-49); `sample_L` inverts both CDFs with upper_bound and turns the
pixel probability into the solid-angle pdf p·w·h/(2π² sin θ) (:123-144);
`sample_dir` maps a direction to (θ, φ) and to pixel coordinates, then
takes the seam- and pole-robust bilinear lookup (:86-120, 146-148). The y
axis is up: θ = acos(y), φ = atan2(−z, x) + π.

The upper_bound is `torch.searchsorted(..., right=True)`: the JAX package
counts `cdf <= ξ` over a (lanes, W) temporary, which at millions of
shadow lanes and a 2048-wide map would take tens of GB. A CDF is
non-decreasing, so the first index with cdf > ξ is that count, ties
included.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from rrt_tpu_torch.types import EnvMap
from rrt_tpu_torch.utils import stats

PI = math.pi


def build_envmap(data: np.ndarray, device) -> EnvMap:
    """CDF tables of an (H, W, 3) radiance map, built in float64 on the
    host and stored as float32 on `device`."""
    data = np.asarray(data, np.float64)
    h = data.shape[0]
    illum = (0.2126 * data[..., 0] + 0.7152 * data[..., 1]
             + 0.0722 * data[..., 2])
    j = np.arange(h)
    pdf = illum * np.sin(PI * (j[:, None] + 0.5) / h)
    pdf /= pdf.sum()
    marg = pdf.sum(axis=1)
    cond = pdf / np.where(marg[:, None] == 0, 1.0, marg[:, None])
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return EnvMap(data=f32(data), pdf=f32(pdf),
                  cond_cdf=f32(np.cumsum(cond, axis=1)),
                  marg_cdf=f32(np.cumsum(marg)))


def probability_debug_image(env: EnvMap) -> np.ndarray:
    """The RGBA image the reference writes as probability_debug.png on
    init (environment_light.cpp:53-68): R = marginal CDF, G = conditional
    CDF."""
    h, w = env.pdf.shape
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 3] = 255
    img[..., 0] = np.clip(255 * env.marg_cdf.cpu().numpy()[:, None], 0,
                          255).astype(np.uint8)
    img[..., 1] = np.clip(255 * env.cond_cdf.cpu().numpy(), 0,
                          255).astype(np.uint8)
    return img


def _dir_to_theta_phi(d):
    u = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    theta = torch.acos(torch.clamp(u[..., 1], -1.0, 1.0))
    phi = torch.atan2(-u[..., 2], u[..., 0]) + PI
    return theta, phi


def _theta_phi_to_dir(theta, phi):
    y = torch.cos(theta)
    x = torch.cos(phi - PI) * torch.sin(theta)
    z = -torch.sin(phi - PI) * torch.sin(theta)
    return torch.stack([x, y, z], dim=-1)


def _bilerp(env: EnvMap, x, y):
    """Seam- and pole-robust bilinear lookup (environment_light.cpp:
    105-120) at continuous pixel coordinates x ∈ [0, w], y ∈ [0, h]."""
    h, w = env.pdf.shape
    right = torch.round(x).to(torch.int64)      # half to even, as rint
    v = torch.round(y).to(torch.int64)
    u1 = right.to(x.dtype) - x + 0.5
    wrap = (right == 0) | (right == w)
    left = torch.where(wrap, w - 1, right - 1)
    right = torch.where(wrap, 0, right % w)

    v_low = v == 0
    v_high = v == h
    v1 = torch.where(v_low, 1.0,
                     torch.where(v_high, 0.0, v.to(y.dtype) - y + 0.5))
    v = torch.where(v_low, 1, torch.where(v_high, h - 1, v))
    bottom, top = v, v - 1
    u0 = 1.0 - u1

    def px(row, col):
        return env.data[torch.clamp(row, 0, h - 1), torch.clamp(col, 0, w - 1)]

    u1e, u0e, v1e = u1[..., None], u0[..., None], v1[..., None]
    return ((px(top, left) * u1e + px(top, right) * u0e) * v1e
            + (px(bottom, left) * u1e + px(bottom, right) * u0e)
            * (1.0 - v1e))


def sample_dir(env: EnvMap, d):
    """Radiance along directions d (..., 3) (environment_light.cpp:
    146-148): the device span "envmap.sample_dir" (`utils.stats`), which a
    profiler sees as a range of that name."""
    h, w = env.pdf.shape
    with stats.span("envmap.sample_dir", d.device):
        theta, phi = _dir_to_theta_phi(d)
        return _bilerp(env, phi / (2.0 * PI) * w, theta / PI * h)


def upper_bound(cdf, xi, row=None):
    """First index i with cdf[i] > xi for every lane: the count of entries
    <= xi, since a CDF is non-decreasing. `cdf` is one (n,) table shared by
    the lanes or, with `row` (the lanes' row indices), an (m, n) table.
    The rows are searched as one sorted sequence: row r shifted by 2r in
    float64, where every float32 entry in [0, 1] and ξ + 2r stay exact."""
    if row is None:
        return torch.searchsorted(cdf, xi.contiguous(), right=True)
    m, n = cdf.shape
    shift = 2.0 * torch.arange(m, dtype=torch.float64, device=cdf.device)
    flat = (cdf.to(torch.float64) + shift[:, None]).reshape(-1)
    key = xi.to(torch.float64) + 2.0 * row.to(torch.float64)
    return torch.searchsorted(flat, key.contiguous(), right=True) - row * n


def sample_L(env: EnvMap, xi):
    """Importance-sample the map (the reference's ENV_HEMI == 0 path) with
    uniforms xi (..., 2): ξ₁ picks the row, ξ₀ the column. The integer
    upper_bound bins feed the direction and the lookup, as in the
    reference (environment_light.cpp:128-138). Returns (radiance, wi,
    dist, pdf): the device span "envmap.sample_L" (`utils.stats`), which a
    profiler sees as a range of that name."""
    h, w = env.pdf.shape
    dtype = xi.dtype
    with stats.span("envmap.sample_L", xi.device):
        y = torch.clamp(upper_bound(env.marg_cdf, xi[..., 1]), 0, h - 1)
        x = torch.clamp(upper_bound(env.cond_cdf, xi[..., 0], row=y), 0,
                        w - 1)
        theta = y.to(dtype) / h * PI
        phi = x.to(dtype) / w * 2.0 * PI
        wi = _theta_phi_to_dir(theta, phi)
        # row 0 has sin θ = 0, which the reference divides by; the clamp
        # keeps the pdf finite and rad/pdf ≈ 0 either way
        pdf = (env.pdf[y, x] * w * h
               / (2.0 * PI * PI * torch.clamp(torch.sin(theta), min=1e-8)))
        rad = _bilerp(env, x.to(dtype), y.to(dtype))
        return rad, wi, torch.full(xi.shape[:-1], math.inf, dtype=dtype,
                                   device=xi.device), pdf
