"""Batched 3D math on tensors whose last axis is the vector dimension
(the port of `rrt_tpu/utils/math3d.py`)."""
from __future__ import annotations

import torch


def dot(a, b):
    """Batched dot product over the last axis, keepdims dropped."""
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(a, eps: float = 0.0):
    """Unit vector; `eps` guards the zero vector."""
    n2 = torch.sum(a * a, dim=-1, keepdim=True)
    return a / torch.sqrt(n2 + eps)


def make_coord_space(n):
    """Orthonormal frame with `n` as the z column (reference
    bsdf.cpp:13-29): h = n with its smallest-|component| set to 1,
    y = normalize(h × z), x = normalize(z × y). Returns (x, y, z)."""
    z = normalize(n)
    an = torch.abs(n)
    x_min = (an[..., 0] <= an[..., 1]) & (an[..., 0] <= an[..., 2])
    y_min = (~x_min) & (an[..., 1] <= an[..., 0]) & (an[..., 1] <= an[..., 2])
    bump = torch.stack([x_min, y_min, ~(x_min | y_min)], dim=-1)
    h = torch.where(bump, torch.ones_like(n), n)
    y = normalize(cross(h, z))
    x = normalize(cross(z, y))
    return x, y, z


def to_local(x, y, z, v):
    """World → local frame."""
    return torch.stack([dot(x, v), dot(y, v), dot(z, v)], dim=-1)


def to_world(x, y, z, v):
    """Local → world: v.x·x + v.y·y + v.z·z."""
    return v[..., 0:1] * x + v[..., 1:2] * y + v[..., 2:3] * z
