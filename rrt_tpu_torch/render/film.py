"""Film: HDR sample buffer → display color, PNG output, diagnostics.

Mirrors the reference's image pipeline:
  * `toColor` gamma conversion with γ=2.2 and exposure √2
    (image.h:183-198) and u8 clamping (`ImageBuffer::update_pixel`),
  * vertical flip + forced alpha on save (pathtracer.cpp:646-684),
  * the blue→green→red sampling-rate heatmap `<name>_rate.png`
    (pathtracer.cpp:686-717),
  * the (unused-by-default) Reinhard-style global `tonemap`
    (image.h:151-178) kept for completeness.

The port's copy of `rrt_tpu/render/film.py`.
"""
from __future__ import annotations

import numpy as np

from rrt_tpu_torch.io.png import write_png

GAMMA = 2.2
EXPOSURE = np.sqrt(2.0 ** 1.0)


def to_color(hdr: np.ndarray) -> np.ndarray:
    """(H,W,3) float radiance → (H,W,4) uint8 with the reference's fixed
    gamma conversion."""
    v = np.power(np.maximum(hdr, 0.0) * EXPOSURE, 1.0 / GAMMA)
    v = np.clip(v, 0.0, 1.0)
    out = np.empty(hdr.shape[:2] + (4,), np.uint8)
    out[..., :3] = (v * 255).astype(np.uint8)
    out[..., 3] = 255
    return out


def tonemap(hdr: np.ndarray, gamma=2.2, level=1.0, key=0.18,
            wht=5.0) -> np.ndarray:
    """Reinhard-style global tonemap (image.h:151-178); the reference ships
    it but leaves the call commented out (pathtracer.cpp:171)."""
    illum = (0.2126 * hdr[..., 0] + 0.7152 * hdr[..., 1]
             + 0.0722 * hdr[..., 2])
    avg = np.exp(np.mean(np.log(1e-7 + illum)))
    s = hdr * (key / avg)
    s = s * (((illum + 1.0) / (wht * wht)) / (illum + 1.0))[..., None]
    exposure = np.sqrt(2.0 ** level)
    v = np.clip(np.power(np.maximum(s, 0) * exposure, 1.0 / gamma), 0, 1)
    out = np.empty(hdr.shape[:2] + (4,), np.uint8)
    out[..., :3] = (v * 255).astype(np.uint8)
    out[..., 3] = 255
    return out


def save_image(path: str, hdr: np.ndarray):
    """Gamma-convert and save, flipped vertically like the reference
    (its framebuffer is y-up; PNG rows are top-down)."""
    rgba = to_color(hdr)
    write_png(path, rgba[::-1])


def sampling_rate_image(sample_count: np.ndarray, ns_aa: int) -> np.ndarray:
    """Blue→green→red heatmap of per-pixel sample counts
    (pathtracer.cpp:686-717)."""
    rate = sample_count.astype(np.float64) / max(ns_aa, 1)
    lo = rate <= 0.5
    r_lo = (0.5 - rate) / 0.5
    c_lo = (np.stack([np.zeros_like(rate), 1.0 - r_lo, r_lo], axis=-1))
    r_hi = (1.0 - rate) / 0.5
    c_hi = (np.stack([1.0 - r_hi, r_hi, np.zeros_like(rate)], axis=-1))
    c = np.where(lo[..., None], c_lo, c_hi)
    out = np.empty(rate.shape + (4,), np.uint8)
    out[..., :3] = (np.clip(c, 0, 1) * 255).astype(np.uint8)
    out[..., 3] = 255
    return out


def save_sampling_rate_image(path: str, sample_count: np.ndarray, ns_aa: int):
    img = sampling_rate_image(sample_count, ns_aa)
    write_png(path, img[::-1])
