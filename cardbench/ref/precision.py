"""The precision the reference computes in.

The program computes in float32 and has no setting for less, so the
benchmark's control is this reference run in the nearest precision
below: bfloat16 storage of the path's state. Inside `lowered()`, `q`
rounds a tensor to bfloat16 and back where the reference stores camera
rays, hits, throughput, radiance and sums (a gradient passes `q`
unchanged, as a straight-through rounding); outside it `q` is the
identity, and the reference computes in float32.
"""
from __future__ import annotations

import contextlib

import torch

_DTYPE = [None]


def q(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to the lowered precision, or `x` itself."""
    dtype = _DTYPE[0]
    if dtype is None or not x.is_floating_point():
        return x
    r = x.detach().to(dtype).to(x.dtype)
    return x + (r - x.detach()) if x.requires_grad else r


@contextlib.contextmanager
def lowered(dtype=torch.bfloat16):
    """Run the reference with its state stored in `dtype`."""
    _DTYPE[0] = dtype
    try:
        yield
    finally:
        _DTYPE[0] = None
