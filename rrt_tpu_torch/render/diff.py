"""Differentiable rendering: gradients of radiance with respect to scene
and hole parameters (the port of `rrt_tpu/render/diff.py`).

`SceneParams` holds the eleven differentiable leaves: the BSDF table's
reflectance, transmittance, emission, eta, k, alpha and ior, the lights'
radiance, and the hole's position, radius (the Schwarzschild mass analog)
and Δθ. `render_radiance` binds them into the scene and runs the
integrator in differentiable mode: every closest hit is the trace
kernel's discrete primal with its continuous payload re-derived under
autograd (`geometry.trace.trace_diff`). Gradients flow through BSDF
values, light radiance and geodesic chords; hit selection, roulette
coins, CDF inversion and visibility carry none.

`train_step` is the inverse-rendering step: the L2 image loss against a
target, its gradient over the leaves, one SGD update on the
`nan_to_num`'d gradient.

Random numbers come from the caller's `torch.Generator`. An objective
evaluated again with "the same key" takes a fresh generator with the same
seed, so that it is deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rrt_tpu_torch.ops.trace_kernel import build_tables
from rrt_tpu_torch.physics.schwarzschild import n_segments
from rrt_tpu_torch.render.integrator import est_radiance
from rrt_tpu_torch.types import BlackHoleParams, Rays, SceneData, _Tensors
from rrt_tpu_torch.utils.config import RenderConfig


@dataclasses.dataclass
class SceneParams(_Tensors):
    """The differentiable leaves, with the JAX package's names."""

    reflectance: torch.Tensor    # (B, 3)
    transmittance: torch.Tensor  # (B, 3)
    emission: torch.Tensor       # (B, 3)
    eta: torch.Tensor            # (B, 3)
    k: torch.Tensor              # (B, 3)
    alpha: torch.Tensor          # (B,)
    ior: torch.Tensor            # (B,)
    light_radiance: torch.Tensor  # (L, 3)
    bh_position: torch.Tensor    # (3,)
    bh_radius: torch.Tensor      # ()
    bh_delta_theta: torch.Tensor  # ()

    def leaves(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    @classmethod
    def from_leaves(cls, leaves) -> "SceneParams":
        return cls(*leaves)


def params_from_scene(scene: SceneData,
                      bh: Optional[BlackHoleParams]) -> SceneParams:
    """The scene's and the hole's current values; without a hole, position
    0, radius 0 and Δθ 0.1."""
    b, dev = scene.bsdfs, scene.device
    return SceneParams(
        reflectance=b.reflectance, transmittance=b.transmittance,
        emission=b.emission, eta=b.eta, k=b.k, alpha=b.alpha, ior=b.ior,
        light_radiance=scene.lights.radiance,
        bh_position=(bh.position if bh is not None
                     else torch.zeros(3, device=dev)),
        bh_radius=(bh.radius if bh is not None
                   else torch.zeros((), device=dev)),
        bh_delta_theta=(bh.delta_theta if bh is not None
                        else torch.tensor(0.1, device=dev)))


def params_from_arrays(d: dict, device) -> SceneParams:
    """`SceneParams` on `device` from a `convert.to_arrays` dict of the
    same eleven leaves (the JAX package's `SceneParams` included), as
    float32 leaf tensors."""
    return SceneParams(**{
        f.name: torch.tensor(np.asarray(d[f.name]), dtype=torch.float32,
                             device=device)
        for f in dataclasses.fields(SceneParams)})


def bind_params(scene: SceneData, bh: Optional[BlackHoleParams],
                p: SceneParams):
    """The scene and hole with the leaves of `p` bound in, and the
    traversal's tables built from their detached values (the tables
    depend on the hole). Returns (scene, hole, tables)."""
    scene2 = scene.replace(
        bsdfs=scene.bsdfs.replace(
            reflectance=p.reflectance, transmittance=p.transmittance,
            emission=p.emission, eta=p.eta, k=p.k, alpha=p.alpha,
            ior=p.ior),
        lights=scene.lights.replace(radiance=p.light_radiance))
    bh2 = None
    if bh is not None:
        bh2 = BlackHoleParams(position=p.bh_position, radius=p.bh_radius,
                              delta_theta=p.bh_delta_theta,
                              enabled=bh.enabled)
    return scene2, bh2, build_tables(scene2, bh2)


def render_radiance(params: SceneParams, scene: SceneData,
                    bh: Optional[BlackHoleParams], rays: Rays,
                    cfg: RenderConfig, gen: torch.Generator,
                    with_work: bool = False):
    """Differentiable radiance (..., 3) of a ray batch; with `with_work`
    also the integrator's `TraceWork` (the kernel's counters and trace
    calls). The chord count is the config's nominal Δθ's, so that a Δθ
    under optimisation does not change it."""
    cfg = cfg.replace(differentiable=True)
    scene2, bh2, tab = bind_params(scene, bh, params)
    if tab.curved:
        tab = dataclasses.replace(
            tab, n_seg=n_segments(cfg.black_hole.delta_theta))
    L, work = est_radiance(scene2, bh2, rays, cfg, gen, tab)
    return (L, work) if with_work else L


def image_loss(params: SceneParams, scene: SceneData,
               bh: Optional[BlackHoleParams], rays: Rays,
               target: torch.Tensor, cfg: RenderConfig,
               gen: torch.Generator) -> torch.Tensor:
    """Mean L2 loss between the rendered radiance and a target batch."""
    img = render_radiance(params, scene, bh, rays, cfg, gen)
    return torch.mean((img - target) ** 2)


def loss_and_grad(params: SceneParams, scene: SceneData,
                  bh: Optional[BlackHoleParams], rays: Rays,
                  target: torch.Tensor, cfg: RenderConfig,
                  gen: torch.Generator):
    """(loss, gradient as SceneParams) of `image_loss`; a leaf the loss
    does not reach gets a zero gradient."""
    leaves = [x.detach().requires_grad_(True) for x in params.leaves()]
    loss = image_loss(SceneParams.from_leaves(leaves), scene, bh, rays,
                      target, cfg, gen)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), SceneParams.from_leaves(
        [torch.zeros_like(x) if g is None else g
         for x, g in zip(leaves, grads)])


def train_step(params: SceneParams, opt_state, scene: SceneData,
               bh: Optional[BlackHoleParams], rays: Rays, target, cfg,
               gen: torch.Generator, lr: float = 1e-2):
    """One inverse-rendering SGD step on the `nan_to_num`'d gradient.
    Returns (params, opt_state, loss)."""
    loss, g = loss_and_grad(params, scene, bh, rays, target, cfg, gen)
    new = [(p.detach() - lr * torch.nan_to_num(d))
           for p, d in zip(params.leaves(), g.leaves())]
    return SceneParams.from_leaves(new), opt_state, loss
