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
`nan_to_num`'d gradient. `LossAndGrad` is the step compiled, the
counterpart of `jax.jit(jax.value_and_grad(image_loss))` and of a jitted
`train_step`: on a card one CUDA graph, captured at its second call,
runs the forward estimate, the backward pass and the update at every
later call. It builds the traversal's geometry tables once
(`render_radiance` and `image_loss` build them per call unless given
`tables`); every evaluation, eager or compiled, writes the hole's row
from the leaves on the device (`trace_kernel.with_hole`).

Random numbers come from the caller's threefry key (`utils.prng`), as
the JAX package's functions take a `jax.random` key
(rrt_tpu/render/diff.py:96-122): the same key evaluates the same
objective, and it draws the JAX package's uniforms.

With `mesh=` (a `parallel.sharding.LaneMesh`) every rank holds the whole
ray batch and target and renders its block of the lanes with its block
of the batch's draws (`prng.uniform(window=)`); its share of the loss is
Σ (img − target)² over its lanes / the batch's elements. Each rank takes
the gradient of its share by itself, and the loss and every gradient
leaf are then summed over the ranks by one all-reduce of one flat buffer:
no collective inside autograd. This stands for the all-reduce that GSPMD
inserts for the JAX package's sharded `jax.grad`
(rrt_tpu/render/diff.py:109-124). `LossAndGrad(mesh=)` compiles it as
two CUDA graphs around that all-reduce, the counterpart of the jitted
sharded step of `__graft_entry__.dryrun_multichip`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rrt_tpu_torch.ops import row_adjoint
from rrt_tpu_torch.ops.trace_kernel import (TraceTables, build_tables,
                                            with_hole)
from rrt_tpu_torch.parallel import distributed as pdist
from rrt_tpu_torch.parallel.sharding import shard_bounds
from rrt_tpu_torch.physics.schwarzschild import n_segments
from rrt_tpu_torch.render.integrator import est_radiance
from rrt_tpu_torch.types import BlackHoleParams, Rays, SceneData, _Tensors
from rrt_tpu_torch.utils import stats
from rrt_tpu_torch.utils.config import RenderConfig
from rrt_tpu_torch.utils.graphs import CapturedCall, run_call


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
                p: SceneParams, tables: TraceTables, n_seg: int):
    """The scene and hole with the leaves of `p` bound in, and the
    traversal's tables: `tables`, the scene's geometry
    (`build_tables(scene, None)`), with the hole's row written from the
    leaves' detached values on the device and `n_seg` chords
    (`trace_kernel.with_hole`). Nothing is read back to the host, so a
    captured step binds them inside its graph. Returns (scene, hole,
    tables)."""
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
    return scene2, bh2, with_hole(tables, bh2, n_seg)


def render_radiance(params: SceneParams, scene: SceneData,
                    bh: Optional[BlackHoleParams], rays: Rays,
                    cfg: RenderConfig, key: torch.Tensor,
                    with_work: bool = False,
                    tables: Optional[TraceTables] = None, lanes=None):
    """Differentiable radiance (..., 3) of a ray batch under the threefry
    `key`; with `with_work` also the integrator's `TraceWork` (the
    kernel's counters and trace calls). The chord count is the config's
    nominal Δθ's, so that a Δθ under optimisation does not change it.
    `tables` are the scene's geometry tables, `build_tables(scene,
    None)`; they are made here when not given. `lanes` = (lo, hi, n):
    the rays are those lanes of a batch of n (`est_radiance`'s)."""
    cfg = cfg.replace(differentiable=True)
    geometry = build_tables(scene, None) if tables is None else tables
    scene2, bh2, tab = bind_params(scene, bh, params, geometry,
                                   n_segments(cfg.black_hole.delta_theta))
    L, work = est_radiance(scene2, bh2, rays, cfg, key, tab, lanes=lanes)
    return (L, work) if with_work else L


def image_loss(params: SceneParams, scene: SceneData,
               bh: Optional[BlackHoleParams], rays: Rays,
               target: torch.Tensor, cfg: RenderConfig,
               key: torch.Tensor, mesh=None,
               tables: Optional[TraceTables] = None,
               with_work: bool = False):
    """Mean L2 loss between the rendered radiance and a target batch; with
    `mesh`, this rank's share of it (the shares sum to the loss). With
    `with_work` also the integrator's `TraceWork`; `tables` as
    `render_radiance`'s."""
    if mesh is None:
        img, work = render_radiance(params, scene, bh, rays, cfg, key, True,
                                    tables)
        loss = torch.mean((img - target) ** 2)
        return (loss, work) if with_work else loss
    n = rays.min_t.shape[0]
    lo, hi = shard_bounds(n, mesh.rank, mesh.world)
    lo, hi = min(lo, n), min(hi, n)
    block = Rays(o=rays.o[lo:hi], d=rays.d[lo:hi], min_t=rays.min_t[lo:hi],
                 max_t=rays.max_t[lo:hi])
    img, work = render_radiance(params, scene, bh, block, cfg, key, True,
                                tables, (lo, hi, n))
    loss = torch.sum((img - target[lo:hi]) ** 2) / target.numel()
    return (loss, work) if with_work else loss


def _local_value_and_grad(leaves, scene, bh, rays, target, cfg, key, mesh,
                          tables):
    """(loss, gradients, trace calls) of `image_loss` at `leaves`, tensors
    that require grad, with `mesh` this rank's share of both (no
    collective); a leaf the loss does not reach gets a zero gradient. The
    forward and the loss are the device span "step.forward", the
    backward pass "step.backward" (`utils.stats`), which the spans of the
    BSDF gathers' adjoints ("step.gather_adjoint", on autograd's own
    thread on a card) nest in."""
    dev = rays.o.device
    with stats.span("step.forward", dev):
        loss, work = image_loss(SceneParams.from_leaves(leaves), scene, bh,
                                rays, target, cfg, key, mesh, tables, True)
    with stats.span("step.backward", dev), stats.lend():
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
    return loss.detach(), grads, work.calls


def _value_and_grad(leaves, scene, bh, rays, target, cfg, key, mesh,
                    tables):
    """(loss, gradients, trace calls) of `image_loss` at `leaves`. With
    `mesh` the loss and the gradients are summed over the ranks after each
    rank's own backward pass, by one all-reduce of one flat buffer
    (`pack_flat`, `all_reduce_sum`, `unpack_flat`): the ops that
    `LossAndGrad`'s two halves run on either side of it."""
    loss, grads, calls = _local_value_and_grad(
        leaves, scene, bh, rays, target, cfg, key, mesh, tables)
    if mesh is not None:
        flat = pdist.all_reduce_sum(pdist.pack_flat([loss, *grads]), mesh)
        loss, *grads = pdist.unpack_flat(flat, [loss, *grads])
    return loss, grads, calls


def _sgd(leaves, grads, lr):
    """p − lr · nan_to_num(g) for every leaf; `lr` a number or a 0-d
    tensor (the same float32 product either way)."""
    return [p.detach() - lr * torch.nan_to_num(g)
            for p, g in zip(leaves, grads)]


def loss_and_grad(params: SceneParams, scene: SceneData,
                  bh: Optional[BlackHoleParams], rays: Rays,
                  target: torch.Tensor, cfg: RenderConfig,
                  key: torch.Tensor, mesh=None):
    """(loss, gradient as SceneParams) of `image_loss`, eagerly; a leaf the
    loss does not reach gets a zero gradient. With `mesh` both are summed
    over the ranks after each rank's own backward pass. `LossAndGrad` is
    the compiled form."""
    leaves = [x.detach().requires_grad_(True) for x in params.leaves()]
    loss, grads, _ = _value_and_grad(leaves, scene, bh, rays, target, cfg,
                                     key, mesh, None)
    return loss, SceneParams.from_leaves(grads)


def train_step(params: SceneParams, opt_state, scene: SceneData,
               bh: Optional[BlackHoleParams], rays: Rays, target, cfg,
               key: torch.Tensor, lr: float = 1e-2, mesh=None,
               step: Optional["LossAndGrad"] = None):
    """One inverse-rendering SGD step on the `nan_to_num`'d gradient
    (summed over the ranks of `mesh`). With `step`, a `LossAndGrad` built
    for this scene, hole, config and mesh, the step's compiled update runs
    on `rays` and `target` instead of the eager one, with the same
    results. Returns (params, opt_state, loss)."""
    if step is not None:
        if (step.scene is not scene or step.bh is not bh
                or step.cfg != cfg or step.mesh is not mesh):
            raise ValueError("the step was built for another scene, hole, "
                             "config or mesh")
        return step.train_step(params, opt_state, key, lr, rays, target)
    loss, g = loss_and_grad(params, scene, bh, rays, target, cfg, key, mesh)
    with stats.span("step.update", rays.o.device):
        new = _sgd(params.leaves(), g.leaves(), lr)
    return SceneParams.from_leaves(new), opt_state, loss


class LossAndGrad:
    """The compiled gradient step: the port's counterpart of
    `jax.jit(jax.value_and_grad(image_loss))` and of a jitted
    `train_step`, built once for a scene, a hole, a config and a ray
    batch (whose shape and device it keeps).

    Static buffers: the eleven leaves (made once, requiring grad), the
    rays, the target, a 0-d `lr`, and the outputs: the loss, the eleven
    gradients and the eleven updated leaves. The traversal's geometry
    tables are built once; every evaluation writes the hole's row from the
    leaves on the device (`bind_params`). A call copies the caller's
    params (and rays and target, when given) into the buffers and the
    caller's key into the static (2,) buffer `key`; it runs the forward
    estimate, `torch.autograd.grad` over the leaves and the
    `nan_to_num`'d SGD update, and returns copies (a caller may keep an
    earlier step's results). So the step draws what the eager step draws
    under the same key, and one key at every call evaluates one
    objective.

    With `mesh` the step is split at its one all-reduce: half A
    (`_half_a`: this rank's forward and backward, its loss share and
    gradients packed into the static buffer `flat`), the seam (the
    all-reduce of `flat` into the static buffer `summed`, eagerly) and
    half B (`_half_b`: the unpack, the outputs and the update), the ops
    `loss_and_grad(mesh=)` runs in the same order.

    With `graphs` (the default on a card, with or without a mesh) the
    step, or each half, is a `CapturedCall`: the first call runs eagerly
    on a side stream, the second is captured and replayed, later calls
    replay, the seam running between the halves. Without graphs (the CPU,
    or `graphs=False`) every call runs the same step eagerly.

    While the program's spans are collected (`utils.stats`), a call
    counts the lanes that the BSDF gathers' adjoints reduced under
    "adjoint.lanes": the step copies the adjoints' lane counter
    (`ops.row_adjoint.counter`) into `lanes_at` before and after its
    backward, on the device, and a collected call reads the two once."""

    def __init__(self, scene: SceneData, bh: Optional[BlackHoleParams],
                 cfg: RenderConfig, rays: Rays, target: torch.Tensor,
                 graphs: Optional[bool] = None, mesh=None):
        dev = scene.device
        if graphs and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
        self.graphs = dev.type == "cuda" if graphs is None else bool(graphs)
        self.scene, self.bh, self.cfg, self.mesh = scene, bh, cfg, mesh
        self.tables = build_tables(scene, None)
        self.leaves = [x.detach().clone().requires_grad_(True)
                       for x in params_from_scene(scene, bh).leaves()]
        self.rays = Rays(o=rays.o.clone(), d=rays.d.clone(),
                         min_t=rays.min_t.clone(), max_t=rays.max_t.clone())
        self.target = target.detach().clone()
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        # the outputs: loss, gradients, updated leaves
        self.out = [torch.zeros((), dtype=torch.float32, device=dev)] + [
            torch.zeros_like(x) for x in self.leaves * 2]
        if mesh is not None:
            # the loss share and the gradients, before and after the
            # all-reduce
            size = 1 + sum(x.numel() for x in self.leaves)
            self.flat = torch.zeros(size, dtype=torch.float32, device=dev)
            self.summed = torch.zeros_like(self.flat)
        self.key = torch.zeros(2, dtype=torch.int64, device=dev)
        # the row adjoints' lanes reduced, before and after the backward
        self.lanes_at = torch.zeros(2, dtype=torch.int64, device=dev)
        self.lanes = row_adjoint.counter(dev)[1]
        # the CapturedCalls, made at the first call: the step (or half A)
        # and, with a mesh, half B
        self.call = self.update = None
        self.trace_calls = 0      # trace calls of one evaluation

    def _write(self, out, loss, grads):
        """The loss, the gradients and the SGD update into `out`: the
        device span "step.update"."""
        with stats.span("step.update", self.scene.device):
            for buf, v in zip(out, [loss, *grads,
                                    *_sgd(self.leaves, grads, self.lr)]):
                buf.copy_(v)

    def _run(self, out) -> int:
        """One unsharded step on the static buffers, its results written
        into `out`; returns its trace calls."""
        self.lanes_at[0].copy_(self.lanes)
        loss, grads, calls = _value_and_grad(
            self.leaves, self.scene, self.bh, self.rays, self.target,
            self.cfg, self.key, None, self.tables)
        self.lanes_at[1].copy_(self.lanes)
        self._write(out, loss, grads)
        return calls

    def _half_a(self, flat) -> int:
        """The sharded step up to its all-reduce: this rank's loss share
        and gradients packed into `flat`; returns its trace calls."""
        self.lanes_at[0].copy_(self.lanes)
        loss, grads, calls = _local_value_and_grad(
            self.leaves, self.scene, self.bh, self.rays, self.target,
            self.cfg, self.key, self.mesh, self.tables)
        self.lanes_at[1].copy_(self.lanes)
        flat.copy_(pdist.pack_flat([loss, *grads]))
        return calls

    def _half_b(self, summed, out):
        """The sharded step after its all-reduce: the summed loss and
        gradients unpacked from `summed`, written into `out` with the
        update."""
        loss, *grads = pdist.unpack_flat(summed, [out[0], *self.leaves])
        self._write(out, loss, grads)

    def _evaluate(self) -> int:
        """One evaluation on the static buffers into `out`, eager or
        through the graphs; returns its trace calls."""
        if self.graphs and self.call is None:
            dev, sharded = self.scene.device, self.mesh is not None
            self.call = CapturedCall(
                LossAndGrad._half_a if sharded else LossAndGrad._run, dev,
                name=("half A of the sharded gradient step" if sharded
                      else "the gradient step"))
            if sharded:
                self.update = CapturedCall(
                    LossAndGrad._half_b, dev,
                    name="half B of the sharded gradient step")
        if self.mesh is None:
            return run_call(self.call, LossAndGrad._run, self, self.out)
        calls = run_call(self.call, LossAndGrad._half_a, self, self.flat)
        self.summed.copy_(pdist.all_reduce_sum(self.flat, self.mesh))
        run_call(self.update, LossAndGrad._half_b, self, self.summed,
                 self.out)
        return calls

    @stats.span("step")
    def _step(self, params: SceneParams, key: torch.Tensor, lr,
              rays: Optional[Rays], target: Optional[torch.Tensor]):
        with torch.no_grad():
            for name, buf, x in zip(
                    [f.name for f in dataclasses.fields(SceneParams)],
                    self.leaves, params.leaves()):
                if tuple(x.shape) != tuple(buf.shape):
                    raise ValueError(f"{name}: shape {tuple(x.shape)}, the "
                                     f"step's is {tuple(buf.shape)}")
                buf.copy_(x)
            if rays is not None:
                for name in ("o", "d", "min_t", "max_t"):
                    getattr(self.rays, name).copy_(getattr(rays, name))
            if target is not None:
                self.target.copy_(target)
            self.lr.fill_(lr)
            self.key.copy_(key)
        self.trace_calls = self._evaluate()
        if stats.collecting():
            before, after = self.lanes_at.tolist()
            if after > before:
                stats.count("adjoint.lanes", after - before)
        n = len(self.leaves)
        out = [b.clone() for b in self.out]
        return (out[0], SceneParams.from_leaves(out[1:1 + n]),
                SceneParams.from_leaves(out[1 + n:]))

    def __call__(self, params: SceneParams, key: torch.Tensor,
                 rays: Optional[Rays] = None,
                 target: Optional[torch.Tensor] = None):
        """(loss, gradient as SceneParams) at `params`, as `loss_and_grad`
        gives them; `rays` and `target` replace the step's when given."""
        loss, grads, _ = self._step(params, key, 0.0, rays, target)
        return loss, grads

    def train_step(self, params: SceneParams, opt_state,
                   key: torch.Tensor, lr: float = 1e-2,
                   rays: Optional[Rays] = None,
                   target: Optional[torch.Tensor] = None):
        """(params, opt_state, loss) of one SGD step, as `train_step`
        gives them."""
        loss, _, new = self._step(params, key, lr, rays, target)
        return new, opt_state, loss
