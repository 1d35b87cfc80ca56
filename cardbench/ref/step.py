"""The reference's inverse-rendering step: the program's SGD step on the
L2 image loss over the eleven differentiable leaves
(`rrt_tpu_torch/render/diff.py`: `SceneParams`, `bind_params`,
`image_loss`, `train_step`), worked out again with the plain traversal
and autograd, eagerly.

The leaves are the BSDF table's reflectance, transmittance, emission,
eta, k, alpha and ior, the lights' radiance, and the hole's position,
radius and Δθ. A step renders the ray batch under its key with every
closest hit's payload re-derived under autograd (`trace.trace_diff`),
takes the mean squared error against the target, its gradient over the
leaves, and the update p − lr · nan_to_num(g).
"""
from __future__ import annotations

import dataclasses

import torch

from cardbench.ref import prng
from cardbench.ref.integrator import est_radiance
from cardbench.ref.precision import q
from cardbench.ref.schwarzschild import n_segments
from cardbench.ref.traverse import build_tables, with_hole
from cardbench.ref.types import BlackHoleParams

LEAVES = ("reflectance", "transmittance", "emission", "eta", "k", "alpha",
          "ior", "light_radiance", "bh_position", "bh_radius",
          "bh_delta_theta")


def leaves_of(scene, bh) -> list:
    """The eleven leaves' values in the scene and the hole."""
    b = scene.bsdfs
    return [b.reflectance, b.transmittance, b.emission, b.eta, b.k,
            b.alpha, b.ior, scene.lights.radiance, bh.position, bh.radius,
            bh.delta_theta]


def _bind(scene, bh, leaves, geometry, n_seg):
    p = dict(zip(LEAVES, leaves))
    scene2 = scene.replace(
        bsdfs=scene.bsdfs.replace(**{k: p[k] for k in LEAVES[:7]}),
        lights=scene.lights.replace(radiance=p["light_radiance"]))
    bh2 = BlackHoleParams(position=p["bh_position"], radius=p["bh_radius"],
                          delta_theta=p["bh_delta_theta"],
                          enabled=bh.enabled)
    return scene2, bh2, with_hole(geometry, bh2, n_seg)


class StepReference:
    """Steps of the problem (scene, hole, cfg, rays, target), the rays
    made by the reference's own camera."""

    def __init__(self, scene, bh, cfg, rays, target):
        self.scene, self.bh, self.rays, self.target = scene, bh, rays, target
        self.cfg = dataclasses.replace(cfg, differentiable=True)
        self.geometry = build_tables(scene, None)
        self.n_seg = n_segments(cfg.black_hole.delta_theta)
        m = rays.o.shape[0]
        self.lanes = (torch.arange(m, device=rays.o.device), m)

    def loss_and_grad(self, leaves, seed: int):
        """(loss, gradients) at `leaves` under the key of `seed`."""
        leaves = [q(x.detach()).requires_grad_(True) for x in leaves]
        scene2, bh2, tab = _bind(self.scene, self.bh, leaves, self.geometry,
                                 self.n_seg)
        m = self.lanes[1]
        key = prng.key(seed, self.rays.o.device).expand(m, 2)
        img = est_radiance(scene2, bh2, self.rays, self.cfg, key, tab,
                              lanes=self.lanes)
        loss = torch.mean((q(img) - self.target) ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else q(g)
                 for x, g in zip(leaves, grads)]
        return loss.detach(), grads

    def train_step(self, leaves, seed: int, lr: float):
        """(new leaves, loss, gradients) of one SGD step."""
        loss, grads = self.loss_and_grad(leaves, seed)
        new = [q(p.detach() - lr * torch.nan_to_num(g))
               for p, g in zip(leaves, grads)]
        return new, loss, grads
