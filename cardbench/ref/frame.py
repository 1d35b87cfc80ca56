"""The reference's frame: the HDR of chosen pixels of one frame of the
program's progressive renderer (`rrt_tpu_torch/render/renderer.py`),
worked out again from the scene file with the plain traversal.

A frame of cfg.ns_aa samples runs in passes of k = min(ns_aa,
max_pass_lanes // (W·H)) samples; lane j·n + pix of a pass is sample j of
pixel pix (n = W·H), and the pass's key is fold_in(fold_in(key(seed),
first sample), 0), split into the jitter's, the lens's (unused by the
pinhole camera) and the integrator's keys. Here the chosen pixels' lanes of every pass make one
batch, each lane with its pass's keys and its place in its pass's draws,
so the batch draws what the frame drew for them. The radiance is
accumulated as the renderer does: a pass's samples summed, the passes
added in order, the sum over the count.
"""
from __future__ import annotations

import numpy as np
import torch

from cardbench.ref import prng
from cardbench.ref.build import build_scene
from cardbench.ref.convert import black_hole_from_arrays
from cardbench.ref.integrator import est_radiance
from cardbench.ref.precision import q
from cardbench.ref.traverse import build_tables, recording


class FrameReference:
    """The scene of `info` (a `collada.SceneInfo` of the reference's own
    parser) at the config `cfg` on `device`, built once for every frame
    checked."""

    def __init__(self, info, cfg, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.scene, self.camera = build_scene(info, self.device, cfg.width,
                                              cfg.height)
        b = cfg.black_hole
        self.bh = (black_hole_from_arrays(b.position, b.radius,
                                          b.delta_theta, self.device)
                   if b.enabled else None)
        self.tables = build_tables(self.scene, self.bh)

    def passes(self):
        """[(first sample, live samples)] of a frame, and k."""
        cfg = self.cfg
        n = cfg.width * cfg.height
        k = max(1, min(cfg.ns_aa, cfg.max_pass_lanes // n))
        return [(s, min(k, cfg.ns_aa - s)) for s in range(0, cfg.ns_aa, k)], k

    def pixels(self, seed: int, pix: torch.Tensor, record: bool = False):
        """The (m, 3) HDR of the pixels `pix` (flat indices y·W + x) of
        the frame of `seed`; with `record`, also the traces' rows
        (`traverse.recording`)."""
        cfg, dev = self.cfg, self.device
        w, h = cfg.width, cfg.height
        n = w * h
        pix = pix.to(dev, torch.int64)
        m = pix.shape[0]
        passes, k = self.passes()
        base = prng.key(cfg.seed if seed is None else seed, dev)
        keys, idx = [], []
        for s, ks in passes:
            pk = prng.fold_in(prng.fold_in(base, s), 0)
            j = torch.arange(ks, device=dev)
            lane = (j[:, None] * n + pix[None]).reshape(-1)
            idx.append(lane)
            keys.append(pk.expand(lane.shape[0], 2))
        idx, keys = torch.cat(idx), torch.cat(keys)
        # the pass key's three: the jitter's, the lens's (a pinhole draws
        # none) and the integrator's
        k_jit, _, k_rad = prng.split(keys, 3)
        lanes = (idx, k * n)
        if cfg.ns_aa == 1:
            jitter = torch.full((idx.shape[0], 2), 0.5, device=dev)
        else:
            jitter = prng.lane_uniform(k_jit, (idx.shape[0], 2), lanes)
        p = idx % n
        px = torch.stack([p % w, p // w], dim=-1).to(torch.float32)
        size = torch.tensor([w, h], dtype=torch.float32, device=dev)
        rays = self.camera.generate_rays((px + jitter) / size)
        rays = rays.replace(o=q(rays.o), d=q(rays.d))
        with recording() as rows:
            L = est_radiance(self.scene, self.bh, rays, cfg, k_rad,
                                self.tables, lanes=lanes)
        L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        total = torch.zeros((m, 3), dtype=torch.float32, device=dev)
        at = 0
        for _, ks in passes:
            total = q(total + L[at:at + ks * m].reshape(ks, m, 3).sum(0))
            at += ks * m
        hdr = total / float(cfg.ns_aa)
        return (hdr, rows) if record else hdr


def sample_pixels(n_pixels: int, count: int, rng: np.random.Generator):
    """`count` distinct flat pixel indices drawn by `rng`, sorted."""
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels),
                              replace=False))
