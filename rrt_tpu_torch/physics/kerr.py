"""Kerr null geodesics (the port of `rrt_tpu/physics/kerr.py`).

Spinning holes bend rays along the full Kerr geodesics, integrated in
Kerr–Schild (Cartesian) form, which is regular at the horizon and free of
the Boyer–Lindquist coordinate singularities:

    g^{μν} = η^{μν} − 2H lᵘ lᵛ,     H = M r³ / (r⁴ + a² z²),
    l_μ = (1, (r x + a y)/(r²+a²), (r y − a x)/(r²+a²), z/r),

with r(x,y,z) the Kerr radius, r² = ½(ρ²−a²) + √(¼(ρ²−a²)² + a² z²).

Null rays follow Hamilton's equations of ℋ(x,p) = ½ g^{μν} p_μ p_ν, by RK4
in an affine parameter. ∂ℋ/∂p and ∂ℋ/∂x are the closed-form scalar's
gradient written out by hand (`_rhs`), where the JAX package takes them
from `jax.grad`: no Christoffel symbol is written out, and `_rhs` is the
plain version of the Kerr march kernel's (`ops/csrc/kerr_march.cu`). The
op forms and epsilons of ℋ are the JAX module's, in float32. At a = 0
this is exact GR Schwarzschild (M = r_s/2), not the reference's chord
stepper of `physics/schwarzschild.py`, which bends rays half as much.

Each RK4 step gives one straight chord, which callers test against the
accretion disk; rays inside the horizon are captured and far rays
escape.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from rrt_tpu_torch.types import _Tensors


@dataclasses.dataclass
class KerrParams(_Tensors):
    position: torch.Tensor   # (3,) hole centre (world frame; spin axis +y)
    mass: torch.Tensor       # () geometric mass M (r_s = 2M)
    spin: torch.Tensor       # () a = J/M in [0, M)

    @property
    def horizon_radius(self):
        return self.mass + torch.sqrt(
            torch.clamp(self.mass ** 2 - self.spin ** 2, min=0.0))


def _kerr_r2(x, y, z, a):
    """Kerr radius² in Kerr–Schild coordinates (spin along z here)."""
    rho2 = x * x + y * y + z * z
    b = rho2 - a * a
    return 0.5 * b + torch.sqrt(0.25 * b * b + a * a * z * z + 1e-30)


def _h_and_l(x3, mass, a):
    """H and the spatial l of the metric at x3 (the shared head of
    `hamiltonian` and `init_momentum`)."""
    x, y, z = x3[..., 0], x3[..., 1], x3[..., 2]
    r2 = _kerr_r2(x, y, z, a)
    r = torch.sqrt(r2)
    H = mass * r2 * r / (r2 * r2 + a * a * z * z + 1e-30)
    r2a2 = r2 + a * a
    lx = (r * x + a * y) / r2a2
    ly = (r * y - a * x) / r2a2
    lz = z / torch.clamp(r, min=1e-20)
    return H, lx, ly, lz


def hamiltonian(x3, p3, pt, mass, a):
    """ℋ = ½ g^{μν} p_μ p_ν for covariant momentum (pt, p3) at x3, per
    batch element. The spin axis is +z in this local frame (callers rotate
    world → hole frame); pt = p_t is conserved."""
    H, lx, ly, lz = _h_and_l(x3, mass, a)
    # g^{μν} p_μ p_ν = η^{μν} p_μ p_ν − 2H (l^μ p_μ)², η = diag(−1,1,1,1),
    # l_μ = (1, lx, ly, lz) ⇒ l^μ p_μ = −p_t + l⃗·p⃗
    p_sq = torch.sum(p3 * p3, dim=-1)
    lp = -pt + p3[..., 0] * lx + p3[..., 1] * ly + p3[..., 2] * lz
    return 0.5 * (-pt * pt + p_sq - 2.0 * H * lp * lp)


def init_momentum(x3, d3, mass, a):
    """Covariant momentum of a null ray through x3 along the unit spatial
    direction d3 (hole frame), normalised to p_t = −1.

    With p3 = κ·d3 (exact as H → 0, far from the hole where camera rays
    start) the null condition 2ℋ(κ) = κ²(1 − 2H·ld²) − 4H·ld·κ − (1 + 2H)
    = 0 fixes κ; C < 0, so the roots straddle zero, and (−B + √disc)/(2A)
    is the forward one for A > 0 (outside the ergosphere)."""
    pt = -1.0
    H, lx, ly, lz = _h_and_l(x3, mass, a)
    ld = d3[..., 0] * lx + d3[..., 1] * ly + d3[..., 2] * lz
    A = 1.0 - 2.0 * H * ld * ld
    B = -4.0 * H * ld
    C = -1.0 - 2.0 * H
    disc = torch.clamp(B * B - 4.0 * A * C, min=0.0)
    kappa = (-B + torch.sqrt(disc)) / (2.0 * A)
    return (torch.full(x3.shape[:-1], pt, dtype=x3.dtype, device=x3.device),
            kappa[..., None] * d3)


def _rhs(x3, p3, pt, mass, a):
    """Hamilton's equations: (∂ℋ/∂p, −∂ℋ/∂x), written out by hand.

    With b = ρ² − a², D = √(b²/4 + a²z² + ε), r² = b/2 + D, den = r⁴ +
    a²z² + ε, H = M r³/den, s = r² + a², l as in `hamiltonian` and
    lp = l·p − p_t:
      ∂ℋ/∂p_i = p_i − c l_i,                       c = 2H lp;
      ∂r²/∂x_i = g_i = f x_i (i = x, y), (f + a²/D) z,  f = 1 + b/(2D);
      ∂H/∂x_i = hr g_i − [i = z] 2H a² z/den,      hr = H (3/(2r²) − 2r²/den);
      ∂lp/∂x_i = k g_i + ((r p_x − a p_y)/s, (r p_y + a p_x)/s, p_z/r),
        k = (u/(2r) − p_x l_x − p_y l_y)/s − p_z l_z/(2r²), u = p_x x + p_y y;
      −∂ℋ/∂x_i = lp² ∂H/∂x_i + c ∂lp/∂x_i.
    The march never differentiates it (no graph is made). This is the
    plain version of `ops/csrc/kerr_march.cu`'s `rhs`, op for op in its
    order: every division is by a tensor (on a card PyTorch turns a
    division by a Python number into a multiply by its reciprocal), so
    both round alike. r ≥ 1e-20 wherever a lane marches, so the clamp of
    l_z's r passes ∂r through."""
    x, y, z = x3.unbind(-1)
    px, py, pz = p3.unbind(-1)
    a2 = a * a
    az2 = a2 * z * z
    b = x * x + y * y + z * z - a2
    d = torch.sqrt(0.25 * b * b + az2 + 1e-30)
    r2 = 0.5 * b + d
    r = torch.sqrt(r2)
    den = r2 * r2 + az2 + 1e-30
    h = mass * r2 * r / den
    s = r2 + a2
    lx = (r * x + a * y) / s
    ly = (r * y - a * x) / s
    rz = torch.clamp(r, min=1e-20)
    lz = z / rz
    lp = -pt + px * lx + py * ly + pz * lz
    c = 2.0 * h * lp
    f = 1.0 + b / (d + d)
    gx = f * x
    gy = f * y
    gz = (f + a2 / d) * z
    hr = h * (1.5 * den - 2.0 * r2 * r2) / (r2 * den)
    k = (px * x + py * y - 2.0 * r * (px * lx + py * ly)) / (2.0 * r * s) \
        - pz * lz / (2.0 * r * rz)
    w = lp * lp * hr + c * k
    fx = w * gx + c * (r * px - a * py) / s
    fy = w * gy + c * (r * py + a * px) / s
    fz = w * gz + c * pz / rz - lp * lp * (2.0 * h * a2 * z / den)
    return (torch.stack([px - c * lx, py - c * ly, pz - c * lz], -1),
            torch.stack([fx, fy, fz], -1))


def rk4_step(x3, p3, pt, mass, a, dlam):
    """One RK4 step of Hamilton's equations (batched; dlam a scalar or
    per lane (...,))."""
    dlam = torch.as_tensor(dlam, dtype=x3.dtype, device=x3.device)
    if dlam.ndim == x3.ndim - 1:
        dlam = dlam[..., None]
    k1x, k1p = _rhs(x3, p3, pt, mass, a)
    k2x, k2p = _rhs(x3 + 0.5 * dlam * k1x, p3 + 0.5 * dlam * k1p,
                    pt, mass, a)
    k3x, k3p = _rhs(x3 + 0.5 * dlam * k2x, p3 + 0.5 * dlam * k2p,
                    pt, mass, a)
    k4x, k4p = _rhs(x3 + dlam * k3x, p3 + dlam * k3p, pt, mass, a)
    # a true division by a tensor: on CUDA PyTorch turns `x / 6.0` into a
    # multiply by its reciprocal, which rounds differently
    six = torch.full_like(dlam, 6.0)
    nx = x3 + dlam / six * (k1x + 2 * k2x + 2 * k3x + k4x)
    np_ = p3 + dlam / six * (k1p + 2 * k2p + 2 * k3p + k4p)
    return nx, np_


class MarchState(NamedTuple):
    x: torch.Tensor          # (..., 3) position (hole frame)
    p: torch.Tensor          # (..., 3) covariant spatial momentum
    pt: torch.Tensor         # (...,)
    captured: torch.Tensor   # (...,) bool
    escaped: torch.Tensor    # (...,) bool


def make_state(o_world, d_world, bh: KerrParams) -> MarchState:
    """World rays → hole-frame march state. The world's spin axis is +y
    (the reference's up); the hole frame puts it along +z:
    (x, y, z)_world → (x, −z, y)_hole."""
    o = o_world - bh.position
    x3 = torch.stack([o[..., 0], -o[..., 2], o[..., 1]], dim=-1)
    d3 = torch.stack([d_world[..., 0], -d_world[..., 2], d_world[..., 1]],
                     dim=-1)
    pt, p3 = init_momentum(x3, d3, bh.mass, bh.spin)
    flags = torch.zeros(x3.shape[:-1], dtype=torch.bool, device=x3.device)
    return MarchState(x=x3, p=p3, pt=pt, captured=flags, escaped=flags)


def to_world(x3, bh: KerrParams):
    """Hole frame → world points (the inverse of `make_state`'s
    rotation)."""
    return torch.stack([x3[..., 0], x3[..., 2], -x3[..., 1]],
                       dim=-1) + bh.position


def march_step(st: MarchState, bh: KerrParams, dlam,
               r_escape: float = 50.0) -> Tuple[MarchState, Tuple]:
    """One RK4 step: returns (new state, (chord start, chord end)) in the
    hole frame. Captured and escaped rays stay where they are."""
    active = ~(st.captured | st.escaped)
    nx, np_ = rk4_step(st.x, st.p, st.pt, bh.mass, bh.spin, dlam)
    nx = torch.where(active[..., None], nx, st.x)
    np_ = torch.where(active[..., None], np_, st.p)
    r2 = _kerr_r2(nx[..., 0], nx[..., 1], nx[..., 2], bh.spin)
    rh = bh.horizon_radius
    captured = st.captured | (active & (r2 <= (rh * 1.02) ** 2))
    escaped = st.escaped | (active & (r2 > r_escape * r_escape))
    return MarchState(nx, np_, st.pt, captured, escaped), (st.x, nx)
