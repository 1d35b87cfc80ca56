"""Schwarzschild photon-orbit micro-ray marching (the port of
`rrt_tpu/physics/schwarzschild.py`).

Every ray is marched as a chain of straight chords. In the plane spanned
by the ray and the hole centre the inverse radius u(φ) obeys
u'' = -u + (3/2) r_s u² (blackhole.cpp:13-15), advanced one Δθ per step
with the reference's update u += u'Δθ + (f1+f2+f3)Δθ²/6. The reference
re-derives u' from the secant chord at every step, which halves the
effective curvature; that is kept, since render parity depends on it.

The operations are written in the same forms as the JAX package's
(reciprocal multiplies for the normalisations, the same clamps), so that
both packages round alike on calm lanes.

Under autograd three stages of the step (u', the new radius and the
chord) pass through `grad_guard`, whose backward scrubs and clips the
cotangent, as the JAX package's `grad_guard` does.
"""
from __future__ import annotations

import math

import torch

from rrt_tpu_torch.types import BlackHoleParams

_DY_EPS = 1e-12


def ode_rhs(u, r):
    """f(u) = -u + (3/2)·r·u² (blackhole.cpp:13-15)."""
    return -u + 1.5 * r * u * u


class GradGuard(torch.autograd.Function):
    """Identity whose cotangent is sanitised: NaN and ±inf become 0, then
    it is clipped to ±1e3 (the JAX package's `grad_guard`). Near-wrap
    steps are chaotic: reverse-mode products through u → 1/u → 1e9-scale
    positions overflow float32 inside one step, and one poisoned lane
    would NaN the whole summed parameter gradient. Guards between the
    step's stages bound every backward product; forward values are
    untouched."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        ct = torch.nan_to_num(ct, nan=0.0, posinf=0.0, neginf=0.0)
        return torch.clamp(ct, -1e3, 1e3)


def grad_guard(x):
    """`GradGuard` where autograd records `x`, else `x` itself: a render
    outside autograd launches nothing extra."""
    return GradGuard.apply(x) if x.requires_grad else x


def micro_step(pos, direction, bh: BlackHoleParams):
    """One Δθ step for a batch of rays.

    Args:
      pos: (..., 3) start of the new chord.
      direction: (..., 3) unit direction of travel at `pos`.
    Returns:
      (new_dir, chord_len, dead): the chord's unit direction, its length,
      and the mask of degenerate (radial) rays.
    """
    dt = bh.delta_theta
    x_axis = pos - bh.position
    d2 = torch.sum(x_axis * x_axis, dim=-1)
    at_center = d2 <= 0
    dist = torch.sqrt(torch.where(at_center, torch.ones_like(d2), d2))
    rdist = 1.0 / dist
    x_hat = x_axis * rdist[..., None]
    u = 1.0 / torch.clamp(dist, min=1e-12)
    dx = torch.sum(direction * x_hat, dim=-1)
    y_axis = direction - dx[..., None] * x_hat
    y2 = torch.sum(y_axis * y_axis, dim=-1)
    dead = (y2 < _DY_EPS * _DY_EPS) | at_center
    safe_dy = torch.sqrt(torch.where(dead, torch.ones_like(y2), y2))
    rdy = 1.0 / safe_dy
    y_hat = y_axis * rdy[..., None]
    up = grad_guard(torch.clamp(-u * dx * rdy, -1e15, 1e15))
    r = bh.radius
    fclip = lambda f: torch.clamp(f, -1e30, 1e30)
    f1 = fclip(ode_rhs(u, r))
    f2 = fclip(ode_rhs(u + up * dt / 2.0, r))
    f3 = fclip(ode_rhs(u + up * dt / 2.0 + f1 * dt * dt / 4.0, r))
    # a true division: on CUDA tensors PyTorch turns `x / 6.0` into
    # x * (1/6), which rounds apart from the CPU's division
    u_new = u + up * dt + (f1 + f2 + f3) * dt * dt / torch.full_like(u, 6.0)
    # u_new <= 0 "teleports" the path through the hole to the mirrored
    # polar position (blackhole.cpp:33-36); |1/u| is clamped at 1e9 so the
    # squared chord length stays finite in float32
    clip_region = torch.abs(u_new) < 1e-9
    u_den = torch.where(clip_region, torch.ones_like(u_new), u_new)
    d_new = grad_guard(torch.where(
        clip_region,
        torch.where(u_new >= 0, torch.full_like(u_new, 1e9),
                    torch.full_like(u_new, -1e9)),
        1.0 / u_den))
    next_pt = (bh.position
               + (d_new * torch.cos(dt))[..., None] * x_hat
               + (d_new * torch.sin(dt))[..., None] * y_hat)
    chord = grad_guard(next_pt - pos)
    c2 = torch.sum(chord * chord, dim=-1)
    zero_len = c2 <= 0
    chord_len = torch.sqrt(torch.where(zero_len, torch.ones_like(c2), c2))
    new_dir = chord * (1.0 / chord_len)[..., None]
    chord_len = torch.where(zero_len, torch.zeros_like(chord_len), chord_len)
    dead = dead | ~torch.isfinite(chord_len) | zero_len
    return new_dir, chord_len, dead


def absorbed_by_hole(o, d, max_t, bh: BlackHoleParams):
    """Does the chord [0, max_t] hit the event-horizon sphere? Near root
    preferred, far root accepted, so chords starting inside the horizon
    are absorbed too (bvh.cpp:107, sphere.cpp:26-53)."""
    tmp = o - bh.position
    b = 2.0 * torch.sum(tmp * d, dim=-1)
    c = torch.sum(tmp * tmp, dim=-1) - bh.radius * bh.radius
    disc = b * b - 4.0 * c
    has = disc >= 0
    sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    t1 = (-b - sq) / 2.0
    t2 = (-b + sq) / 2.0
    ok1 = (0.0 <= t1) & (t1 <= max_t)
    ok2 = (0.0 <= t2) & (t2 <= max_t)
    return has & (ok1 | ok2)


def chaotic_lanes(o, d, bh: BlackHoleParams, n_seg: int):
    """Lanes whose march ever takes a wrapped (u ≤ 0 teleport) or
    near-wrap chord (length > 50) or passes within 5 radii of the hole:
    there float32 rounding differences between two implementations grow
    without bound, so parity checks hold these lanes to a statistical
    rule and every other ("calm") lane to exact agreement (the classifier
    of tests/test_pallas.py)."""
    pos, dirn = o, d
    dead = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
    chaotic = torch.zeros_like(dead)
    for _ in range(n_seg):
        nd, clen, sdead = micro_step(pos, dirn, bh)
        dead = dead | sdead
        clen = torch.where(dead, torch.zeros_like(clen), clen)
        near = torch.linalg.vector_norm(pos - bh.position, dim=-1) \
            < 5.0 * bh.radius
        chaotic = chaotic | (clen > 50.0) | near
        pos, dirn = pos + nd * clen[..., None], nd
    return chaotic


def n_segments(delta_theta: float) -> int:
    """Segment count: j advances while j·Δθ < 2π (bvh.cpp:105)."""
    return int(math.ceil(2.0 * math.pi / float(delta_theta) - 1e-12))
