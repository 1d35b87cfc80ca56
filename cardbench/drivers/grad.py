"""Gradient steps: an inverse-rendering loop of back-to-back SGD steps.

One `LossAndGrad` (the program's compiled step: the forward estimate,
`autograd.grad` over the eleven leaves and the SGD update, one CUDA
graph from its second call) is built for the configuration at the mix's
`spp`, with one camera ray through every pixel's centre and a target
image that the benchmark draws from the seed. Step i runs under the key
of `inputs.step_seed(seed, i)` and reads its loss back; the parameters
carry from step to step.

Set-up builds the step and drives it from the scene's parameters
through its first `compared_steps` steps (eager, captured, replayed),
keeping the loss of each and the parameters after each; the same object
then runs the window. `step_s` is the window's seconds over the steps it
completed. Once the window has closed and the program is freed, the
reference (`ref.step`) takes the same steps from its own scene and
rays (`reference_steps`), and `step_numbers` holds the program's losses,
its first gradient (the change of the first step over the learning rate)
and its change after the compared steps to the reference's.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from cardbench import compare, harness, inputs, tracing


def _np(leaves):
    return [x.detach().double().cpu().numpy() for x in leaves]


def run(ctx) -> dict:
    conf, mix = ctx.cell["config"], ctx.cell["traffic"]
    dev, seed = ctx.device, ctx.seed
    lr, steps0 = mix["lr"], mix["compared_steps"]
    from rrt_tpu_torch.io import collada
    from rrt_tpu_torch.ops import build
    from rrt_tpu_torch.render import diff
    from rrt_tpu_torch.render.renderer import make_black_hole
    from rrt_tpu_torch.scene.build import build_scene
    from rrt_tpu_torch.utils import config as pconfig
    from rrt_tpu_torch.utils import prng
    phases = {"imports": harness.process_seconds()}
    if dev.type == "cuda":
        build.build_all(["trace", "threefry"])
    phases["build"] = harness.process_seconds()
    cfg = inputs.render_config(pconfig, conf, ns_aa=mix["spp"])
    w, h = cfg.width, cfg.height
    scene, cam = build_scene(inputs.scene_info(collada, conf["scene"]), dev,
                             w, h)
    bh = make_black_hole(cfg, dev)
    xy = inputs.pixel_centres(w, h, dev)
    target = inputs.target_image(seed, (w * h, 3), mix["target_scale"], dev)
    step = diff.LossAndGrad(scene, bh, cfg, cam.generate_rays(xy), target)
    params = diff.params_from_scene(scene, bh)
    states, losses = [_np(params.leaves())], []
    phases["scene"] = harness.process_seconds()

    def one(i, params):
        key = prng.key(inputs.step_seed(seed, i), dev)
        params, _, loss = step.train_step(params, None, key, lr)
        return params, loss.item()

    for i in range(steps0):
        params, loss = one(i, params)
        losses.append(loss)
        states.append(_np(params.leaves()))
    ctx.sync()
    setup_s = phases["warm"] = harness.process_seconds()
    harness.check_modules("after set-up")

    i, walls, bad = steps0, [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        t = time.perf_counter()
        params, loss = one(i, params)
        walls.append(time.perf_counter() - t)
        bad += not np.isfinite(loss)
        i += 1
    window_s = time.perf_counter() - t0
    call = step.call
    if call is not None and (call.graph is None
                             or call.calls != call.replays + 1):
        raise RuntimeError(f"{call.name}: {call.calls} calls, "
                           f"{call.replays} replays")
    summaries = []
    if ctx.trace:
        box = [params]

        def traced(j):
            box[0], _ = one(i + j, box[0])
        summaries.append(tracing.trace_units(traced, mix["trace_steps"], dev))
    peak = ctx.memory_peak()
    del step, params, scene, cam, bh, target
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(conf, mix, seed, dev)
    numbers = step_numbers((states, losses), ref, lr)
    correct, checks = compare.judge(numbers, ctx.limits)
    e2e = dict(step_s=window_s / len(walls), setup_s=setup_s)
    return dict(correct=correct, attempted=len(walls), failed=bad,
                end_to_end=e2e, summaries=summaries, peak=peak, work=None,
                checks=checks, numbers=numbers, walls=walls,
                window_s=window_s, phases=phases)


def reference_steps(conf, mix, seed, dev, half=False):
    """The reference's compared steps of a run of `seed`, from its own
    scene, camera and hole and the benchmark's target: (the leaves before
    and after each step, the losses, the exact first gradient). With
    `half`, the planted fault: the loss over the first half of the batch."""
    from cardbench.ref import collada as rcollada
    from cardbench.ref import config as rconfig
    from cardbench.ref.build import build_scene as rbuild
    from cardbench.ref.convert import black_hole_from_arrays
    from cardbench.ref.step import StepReference, leaves_of
    lr = mix["lr"]
    rcfg = inputs.render_config(rconfig, conf, ns_aa=mix["spp"])
    w, h = rcfg.width, rcfg.height
    rscene, rcam = rbuild(inputs.scene_info(rcollada, conf["scene"]), dev,
                          w, h)
    b = rcfg.black_hole
    rbh = black_hole_from_arrays(b.position, b.radius, b.delta_theta, dev)
    rays = rcam.generate_rays(inputs.pixel_centres(w, h, dev))
    target = inputs.target_image(seed, (w * h, 3), mix["target_scale"], dev)
    if half:
        m = w * h // 2
        rays = type(rays)(o=rays.o[:m], d=rays.d[:m], min_t=rays.min_t[:m],
                          max_t=rays.max_t[:m])
        target = target[:m]
    ref = StepReference(rscene, rbh, rcfg, rays, target)
    leaves = [x.detach().clone() for x in leaves_of(rscene, rbh)]
    states, losses, grad = [_np(leaves)], [], None
    for j in range(mix["compared_steps"]):
        leaves, loss, g = ref.train_step(leaves, inputs.step_seed(seed, j),
                                         lr)
        losses.append(loss.item())
        states.append(_np(leaves))
        grad = _np(g) if grad is None else grad
    return states, losses, grad


def step_numbers(prog, ref, lr) -> dict:
    """`compare.step_numbers` of the program's compared steps `prog` =
    (leaves before and after each step, losses) against the reference's
    `ref` = (the same, its exact first gradient): the first gradient is
    the first step's change over the learning rate, the change the last
    leaves' less the first."""
    first = lambda s: [(a - b) / lr for a, b in zip(s[0], s[1])]
    change = lambda s: [b - a for a, b in zip(s[0], s[-1])]
    (ps, pl), (rs, rl, rg) = prog, ref
    return compare.step_numbers(pl, rl, first(ps), first(rs), change(ps),
                                change(rs), rg)
