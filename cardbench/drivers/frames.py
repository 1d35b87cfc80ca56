"""Frames: one user rendering whole frames back to back, a closed loop.

Frame i renders the configuration with the seed `inputs.frame_seed(seed,
i)` through `Renderer.render()`; only the render's seed changes, so every
frame runs the same pass shapes, each captured once as a CUDA graph in
set-up and replayed after. With `ranks` > 1 (the mix's key) every frame
is lane-sharded over that many processes, one card each
(`Renderer(sharding=)` over NCCL), and rank 0 times the frames and ends
the window for all.

Set-up: the kernels built or loaded from the checkout's build directory,
the scene parsed and built on the card, `warm_frames` frames (the pass's
eager first run and its capture). The window: frames until `--seconds`
have passed; the last frame ends the window. `samples_per_s` is the
camera samples (width × height × spp) of every frame over the window's
seconds (`sharded_samples_per_s` over ranks); `frame_p95_s` the 95th
percentile of the frames' walls, each ending in the device read-back of
the image.

The check: `check_pixels` pixels drawn from the seed, kept from every
frame of the window; `check_frames` of those frames, drawn from the seed,
are worked out again by the reference (`ref.frame`) once the program is
freed, and compared (`compare.frame_numbers`). With `--trace 1` a few
more frames (about `trace_seconds` of them) are profiled after the
window, and the reference's traces of the checked frames give the work
of the trace kernel's roofline.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from cardbench import compare, harness, inputs, roofline, tracing


def _agree(value: int, world: int, device) -> int:
    """Rank 0's `value`, the same on every rank."""
    if world == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    torch.distributed.broadcast(t, src=0)
    return int(t.item())


def run(ctx) -> dict:
    conf, mix = ctx.cell["config"], ctx.cell["traffic"]
    dev, seed, world, rank = ctx.device, ctx.seed, ctx.world, ctx.rank
    if mix["ranks"] != world:
        raise RuntimeError(f"the mix runs {mix['ranks']} ranks, the cell "
                           f"{world}")
    from rrt_tpu_torch.io import collada
    from rrt_tpu_torch.ops import build
    from rrt_tpu_torch.render.renderer import Renderer
    from rrt_tpu_torch.scene.build import build_scene
    from rrt_tpu_torch.utils import config as pconfig
    phases = {"imports": harness.process_seconds()}
    if dev.type == "cuda":
        build.build_all(["trace", "threefry"])
    phases["build"] = harness.process_seconds()
    sharding = None
    if world > 1:
        from rrt_tpu_torch.parallel import distributed as pdist
        from rrt_tpu_torch.parallel import sharding as psh
        pdist.initialize(f"127.0.0.1:{ctx.port}", world, rank,
                         backend=ctx.backend, device=dev.type)
        sharding = psh.batch_sharding(psh.make_mesh(dev))
    cfg = inputs.render_config(pconfig, conf)
    scene, cam = build_scene(inputs.scene_info(collada, conf["scene"]), dev,
                             cfg.width, cfg.height)
    r = Renderer(scene, cam, cfg, dev, sharding=sharding)
    phases["scene"] = harness.process_seconds()
    n = cfg.width * cfg.height
    pix = checked_pixels(conf, mix, seed)

    def render(i):
        r.cfg = dataclasses.replace(cfg, seed=inputs.frame_seed(seed, i))
        hdr, _ = r.render()
        return hdr

    for i in range(mix["warm_frames"]):
        render(i)
    ctx.sync()
    setup_s = phases["warm"] = harness.process_seconds()
    harness.check_modules("after set-up")

    kept, walls = {}, []
    i = mix["warm_frames"]
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        hdr = render(i)
        walls.append(time.perf_counter() - t)
        kept[i] = np.asarray(hdr, np.float64).reshape(-1, 3)[pix]
        i += 1
        if _agree(time.perf_counter() - t0 >= ctx.seconds, world, dev):
            break
    window_s = time.perf_counter() - t0
    frames = len(walls)

    # every pass shape was captured once in set-up and replayed since
    if len(r._pass_fns) != 1:
        raise RuntimeError(f"{len(r._pass_fns)} pass shapes, expected 1")
    for call in (c for p in r._pass_fns.values()
                 for c in (p.call, p.accumulate) if c is not None):
        if call.graph is None or call.calls != call.replays + 1:
            raise RuntimeError(f"{call.name}: {call.calls} calls, "
                               f"{call.replays} replays")

    summaries = []
    if ctx.trace:
        units = max(1, min(mix["trace_max_frames"],
                           round(mix["trace_seconds"] / np.median(walls))))
        units = _agree(units, world, dev)
        summaries.append(tracing.trace_units(lambda j: render(i + j),
                                             units, dev))
    peak = ctx.memory_peak()
    summaries, peaks = ctx.gather((summaries, peak))
    if world > 1:
        pdist.shutdown()
    del r, scene, cam
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return None

    # the reference, after the window, with the program's state freed
    fr = frame_reference(conf, dev)
    order = sorted(kept)
    chosen = sorted(inputs.rng(seed, 2).choice(
        order, size=min(mix["check_frames"], len(order)), replace=False))
    ref, rows = [], []
    pix_t = torch.from_numpy(pix)
    for j in chosen:
        hdr, rec = fr.pixels(inputs.frame_seed(seed, int(j)), pix_t,
                             record=True)
        ref.append(hdr.double().cpu().numpy())
        rows.append(rec)
    prog = np.stack([kept[int(j)] for j in chosen])
    numbers = compare.frame_numbers(prog, np.stack(ref))
    correct, checks = compare.judge(numbers, ctx.limits)
    failed = sum(not np.isfinite(v).all() for v in kept.values())

    samples = n * cfg.ns_aa
    # lane-sharded frames are their own throughput metric, whose noise
    # (the slowest rank, the collectives) differs from one card's
    rate = "sharded_samples_per_s" if world > 1 else "samples_per_s"
    e2e = {rate: frames * samples / window_s,
           "frame_p95_s": harness.percentile(walls, 95), "setup_s": setup_s}
    work = roofline.trace_work(rows, n / len(pix))
    return dict(correct=correct, attempted=frames, failed=failed,
                end_to_end=e2e, summaries=[s for ss in summaries for s in ss],
                peak=max(peaks), work=work, checks=checks,
                numbers=numbers, walls=walls, window_s=window_s,
                phases=phases)


def checked_pixels(conf, mix, seed):
    """The flat indices of the pixels that a run of `seed` keeps from
    every frame, drawn from the seed."""
    from cardbench.ref.frame import sample_pixels
    return sample_pixels(conf["width"] * conf["height"],
                         inputs.check_pixels(mix, conf), inputs.rng(seed, 1))


def frame_reference(conf, dev):
    """The reference's frames of the configuration, from its own parse of
    the scene file."""
    from cardbench.ref import collada as rcollada
    from cardbench.ref import config as rconfig
    from cardbench.ref.frame import FrameReference
    return FrameReference(inputs.scene_info(rcollada, conf["scene"]),
                          inputs.render_config(rconfig, conf), dev)
