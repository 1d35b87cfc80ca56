"""Threefry-2x32 keys and uniforms in plain PyTorch, drawn lane by lane.

The counter-based stream of `jax.random` with `jax_threefry_partitionable`
on, which the program draws from: a key is an int64 (..., 2) tensor of
two uint32 words; `split(key, num)` hashes the counters (0, i),
`fold_in(key, data)` the counter (0, data mod 2³²), and element g (its
flat index) of `uniform(key, shape)` hashes (g >> 32, g & 0xFFFFFFFF)
into the float (bits >> 9 | 0x3F800000) − 1. The hash is a frozen copy
of the port's plain version (`rrt_tpu_torch/ops/threefry.py`,
`threefry2x32`).

Here every lane carries its own key: `split` returns a list of keys of
the lanes' shape, and `lane_uniform` draws, for lanes that may come from
different passes, each lane's elements of its pass's whole draw. So a
sample of pixels from every pass of a frame is estimated in one batch
and draws what the frame drew for them.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of the counters (x0, x1) under the key (k0,
    k1): 20 rounds with the key injected every 4. Integer tensors holding
    uint32 values, broadcast together; returns two int64 words."""
    k2 = k0 ^ k1 ^ PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """The (2,) key of an integer seed: (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def _derive(keys: torch.Tensor, count: int, offset: int = 0):
    c = (torch.arange(count, dtype=torch.int64, device=keys.device)
         + offset) & M32
    x0, x1 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(c), c)
    return torch.stack([x0, x1], dim=-1)          # (..., count, 2)


def split(key: torch.Tensor, num: int = 2) -> list:
    """`num` keys from each key of `key` (..., 2), as a list."""
    return list(_derive(key, num).unbind(-2))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """The keys of `key` (..., 2) with the integer `data` folded in."""
    return _derive(key, 1, int(data) & M32)[..., 0, :]


def lane_uniform(key, shape, lanes, axis: int = 0) -> torch.Tensor:
    """Float32 uniforms in [0, 1) of `shape`, whose axis `axis` holds m
    lanes. `lanes` = (idx, n): lane i is lane idx[i] of a draw whose axis
    holds n lanes, and its elements are that draw's. `key` is (..., m, 2),
    one key a lane (or a list of such, stacked on a new leading axis);
    the result is key.shape[:-2] + shape."""
    if isinstance(key, (list, tuple)):
        key = torch.stack(list(key))
    idx, n = lanes
    shape = tuple(int(s) for s in shape)
    if axis < 0:
        axis += len(shape)
    m = shape[axis]
    if idx.shape != (m,) or key.shape[-2] != m:
        raise ValueError(f"{m} lanes on axis {axis} of {shape}, "
                         f"{tuple(idx.shape)} indices, keys {tuple(key.shape)}")
    dev = key.device
    outer = math.prod(shape[:axis])
    inner = math.prod(shape[axis + 1:])
    g = ((torch.arange(outer, dtype=torch.int64, device=dev)[:, None, None]
          * n + idx.to(torch.int64)[None, :, None]) * inner
         + torch.arange(inner, dtype=torch.int64, device=dev)[None, None])
    lead = key.shape[:-2]
    k0 = key[..., 0].reshape(lead + (1, m, 1))
    k1 = key[..., 1].reshape(lead + (1, m, 1))
    x0, x1 = threefry2x32(k0, k1, g >> 32, g & M32)
    bits = (((x0 ^ x1) >> 9) | 0x3F800000).to(torch.int32)
    return (bits.view(torch.float32) - 1.0).reshape(lead + shape)
