#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rrt_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases:

1. the card: fail without CUDA; print its name and power limit;
2. build every kernel library from the sources in the checkout (trace,
   probe, r5prim, threefry), one nvcc each, all started together, and
   print ptxas's registers and spills;
3. trace kernel against its plain PyTorch version on the card. First
   65,536 seeded rays in the in-repo Cornell box, in a procedural scene
   of three triangle parts and in the bench's BVH-scale scene
   (`cbox_dense`: 14 parts, clusters of 8): flat, curved closest-hit and
   curved any-hit. Then the main path's own sizes: its 1,048,576 jittered
   camera rays (closest hit) and the 4,194,304 shadow lanes that the
   integrator stacks from their hits (4 area-light samples, any hit), each
   timed on the kernel and on the plain version. Rules: calm lanes agree exactly on hit, prim,
   segment and counters, and on t and the hit point to rtol 1e-5; all
   lanes agree on ≥ 99.9% of hits and prims. Then the trace kernel's own
   cases, each flat, curved and any-hit, in the default build and in the
   builds that fix its traversal lane by lane and cooperative
   (`trace_modes.VARIANTS`): 1, 31 and 33 lanes and one more than the
   launch's resident threads, from spread origins and from one point (a
   warp of rays from one point refills as a whole); a seeded half of the
   lanes parked at the hole's centre; a scene whose box tables outgrow
   shared memory; two launches back to back. Each launch's bound counts
   the tests its lanes need (`trace_modes.trace_work`). With `--old PATH` (a copy of an earlier trace_kernel.cu with
   the same C interface as PR 2's), that kernel and this one are timed in
   turns (old, new, new, old) at the main path's two shapes and the
   `cbox_dense` check. Then the toolchain probe kernel against
   `probe_reference` (exact), its host time per call and device time per
   launch against `x * 2`'s, and the eight cost probes against their
   plain versions at n_iter 1 and 64 (exact for fori_chain and when_rt,
   rtol 1e-6 for the others);
3e. the threefry kernel (`ops/csrc/threefry.cu`, every draw of the
   port) against its plain version bit for bit at the main path's
   shapes (the jitter (1,048,576, 2), four light samples of (1,048,576,
   2) in one launch, a roulette coin (1,048,576,), and a quarter of the
   lanes of each), a window of a draw of 2^31 + 5 elements, and its key
   entry (`threefry_phase`), each timed beside the
   plain version and `torch.rand` at the same shape;
4. the main path through the CLI: 256×256, 16 spp, -l 4, -m 5, curved
   global illumination on cuda, with every trace and every draw counted
   at its kernel (65 uniforms a lane: the JAX package's draws);
   then a profile of the same render (warm walls, peak memory, device
   time by kernel, host launches a pass, and each trace launch's time
   beside its live-lane share, chords and tests per lane and bound, on a
   renderer with eager passes, whose launches go through the Python
   launcher; with `--old`, the render's ten launches of both kernels in
   turns); a first profile of the
   BVH-scale render; a small normal-shaded render on the card checked
   against the CPU, and 32×32 global illumination at -m 5, flat and
   curved, the card's render against the CPU's under the per-pixel rule
   of the JAX parity tests (`card_vs_cpu_phase`: one seed, one image on
   either device);
4b. the differentiable path at full width: one `image_loss` gradient
   step of the main path's render (256×256, 1 spp, -l 4, -m 5, curved
   GI) through `diff.LossAndGrad`, eager and compiled (a CUDA graph
   captured at its second call, `grad_step_case`): the compiled step
   equal to the eager one bit for bit at every call, the kernel's runs
   equal to the trace calls, no eager launch in a replayed step, every
   leaf's gradient finite and the radius's nonzero; walls in turns, host
   launches and the busy share of a step, peak memory, the capture seconds
   and the graph pool, the memory one replayed trace of 65,536 lanes
   saves, and the eager step's device time split into the trace kernel,
   the replay's ops (forward and backward) and the rest;
4c. BASELINE config 4's closed loops (`rrt_tpu_torch.tools.inverse`,
   rays framed on the box), compiled and eager, which must end at equal
   values: the radius loop's first step must move from the start toward
   the truth and its radius stay inside the clip, and the red wall's
   albedo must end within 0.08. At `RADIUS_SEED`, the key at which the
   JAX package's loop recovers, the port's radius loop does not end
   within 0.015 of the truth on either device (ROADMAP Queue 3): a few
   lanes whose shadow rays orbit the hole flip with rounding, and the
   loss rests on them (tests/test_torch_inverse.py holds the first step
   to the JAX package's lane by lane); where it ends is printed. The
   loop's first step is held to the CPU's lane by lane
   (`inverse.radius_step_parity`): every lane whose trace outcome parts
   between the card and the CPU undecided at float32 (at most 4 of
   1,024), ≥ 99% of the others within rtol 1e-2, and with the parted
   lanes left out the loss within 1e-3 and the radius gradient within
   5e-3; then one radius step and one albedo step through
   `grad_step_case`;
4d. `trace_diff` against the kernel's primal: 400 seeded camera rays,
   curved; equal hits and prims, >= 99.5% of hit points within 1e-4;
4e. the env-lit main path through the CLI: a seeded 1024×2048 sky with a
   sun disk written as EXR, `-e` at the main path's settings in a
   temporary directory: launches equal to trace calls, a finite image
   brighter than the same render without `-e`, probability_debug.png
   written there; its wall and a profile of `sample_L` and `sample_dir`
   (on eager passes, whose ranges hold their ops);
4f. the render lifecycle on the main path (256×256, 16 spp, -l 4, -m 5,
   one sample a pass): a render checkpointed every 4 samples, stopped
   after 8 and resumed equals the uninterrupted render bit for bit; a
   NORMAL-mode `-p 64 32 96 80` cell equals the crop of the full frame
   (walls of both); a preview every 4 samples;
4g. `--serve 0` through the CLI at 1024×1024, 16 spp: a second thread
   reads the port from the CLI's output, GETs /status.json, /accel.png and
   /preview.png (200 each) and POSTs {"spp_cap": 4}, in a second run
   {"action": "stop"}: both renders end early, cancelled; the accel walk
   steps left, right and up on cbox_dense over HTTP;
4h. `--dump-rays` and `--dump-accel` through the CLI, then each dump on
   the Cornell box (curved and `--flat`) and on cbox_dense at 256×256
   with its walls, trace launches and peak memory; the ray log from the
   kernel equals the plain traversal's on calm lanes, ≥ 99.5% overall;
4i. Kerr, BASELINE config 5 at full width (1024×1024, spin 0.9, disk
   [3, 12], 600 RK4 steps, one batch of 1 << 20 lanes, 1 spp where config
   5 has 16): the structure checks of tests/test_kerr.py, wall (in
   captured blocks of steps, and step by step: equal bit for bit), rays/s,
   RK4 steps/s, peak memory, launches per RK4 step and the busy share;
   a 32×32, 300-step render on the card against the CPU (≥ 99% of lanes
   agree on the disk and escape masks, radiance to rtol 1e-3 there);
4j. the lane-sharded main path on a world of 1 over NCCL
   (`parallel.distributed.initialize`), compiled: `Renderer(sharding=)`
   with each pass's rank half and accumulate half captured as CUDA graphs
   and the gather between them, against the eager sharded renderer and
   the unsharded graph renderer, bit for bit, with the kernel's runs
   equal to the trace calls, at 256×256, 16 spp, -l 4, -m 5, with a tail
   pass and adaptive (walls in turns, host launches a pass, busy share,
   capture seconds, pool); `trace(mesh=)` on 65,536 seeded rays compiled
   (its collectives inside the graph) and `occluded(mesh=)`, equal to the
   unsharded queries; the per-trace forward `est_radiance(mesh=)` at
   1024² (1,048,576 lanes), flat and curved, as one CUDA graph with its
   NCCL gathers and all-reduces inside, equal bit for bit to itself eager
   and to the unsharded graph forward, radiance and counters (walls in
   turns, host launches a forward, collectives and bytes, capture
   seconds, graph pool); phase 4b's gradient step through
   `LossAndGrad(mesh=)`, compiled (two graphs around the all-reduce)
   against eager bit for bit, and against the unsharded step (rtol 1e-4
   on the material leaves, 5e-3 on the hole's); `kerr_cli --sharded` at
   64×64, 300 steps in captured blocks, equal bit for bit to the sharded
   march step by step and to the unsharded CLI;
4k. two ranks of `rrt_tpu_torch.parallel.worker` on the one card over
   gloo at 255×255 (an odd lane count), with graphs around the
   collectives: the blocks tile the frame, the forward equals the whole
   frame's rows and the sharded render this process's single-process
   render bit for bit; the compiled sharded step equals the eager one and
   the two ranks' shares summed in this process bit for bit; the kernel's
   runs equal the trace calls in each rank; each rank's times;
4l. the tools: `scaling_bench --card` (sharded against unsharded, in
   turns, both compiled), `run_config` configs 1-3 (the box at 256² 4 spp
   direct; `cbox_dense` and the mirror and glass box at 512² 64 spp, -m 5
   -l 1:
   a finite, lit image, launches equal to trace calls; their JSON
   lines) and `kbench 20` on `cbox_dense` and the Cornell box;
4m. the compiled pass: every renderer above captures each pass shape as a
   CUDA graph and replays it (`Renderer._pass_fn`), and Kerr marches in
   captured blocks (`kerr_scene.DiskMarch`); here each is held against the
   eager path (`graphs=False`) bit for bit in accumulators, counters and
   trace calls, on the primary cell, a tail pass, two `-p` cells of one
   size, an adaptive render, the 16-pass lifecycle render stopped at 8
   samples and resumed, `cbox_dense`, a flat and an env-lit render and
   Kerr at 64×64 in blocks: walls in turns (5 each), host launches a
   pass, busy share, peak memory, the graph pool and capture time
   (`first_frame_phase(DIR, card)`, run alone from a script, times the
   CLI's main path from fresh processes of an earlier checkout and of
   this one in turns: the time to the first frame);
4n. the lane-sharded user paths on several cards, one rank of
   `rrt_tpu_torch.parallel.worker` a card in one NCCL group, with CUDA
   graphs around every collective (`multicard_phase`), on 2 cards, then
   3, up to all of them or 4: the primary render, a tail pass,
   adaptive and a stop on the last rank alone, each equal bit for bit to
   the one-card render made here on card 0 before the ranks start; the
   sharded 256² step equal to eager at every call and within the
   order-free bound of the ranks' shares summed here; Kerr config 5 equal
   to the one-card frame; the per-trace `mesh=` forward at 1024², flat
   and curved, compiled with its collectives inside the graph, equal to
   itself eager and to the unsharded forward (as in 4j); walls in turns
   with the one-card render, host
   launches, collectives and bytes, busy share, capture seconds, the
   NCCL transport (`NCCL_DEBUG=INFO`); then `scaling_bench --size 1024`
   over 1, 2, ... ranks and its `--breakdown` under the largest group
   (the JAX tool's keys, every forward compiled).
   On one card it prints `[smoke] phase 4n: not run: 1 card, needs 2 or
   more` and the smoke goes on. `--phase 4n` runs phases 1-2 and 4n
   alone;
5. the bench (`rrt_tpu_torch.bench`, in-process): probe, build, the
   primary and the BVH-scale cell (the median of 5 timed renders each);
   its JSON line is printed;
6. the cost-probe tool's path (`rrt_tpu_torch.tools.r5prim`): every probe
   timed at two iteration counts, beside its plain version;
7. a JSON line of the kernels, then the ok line.

Each of the paths (4, 4b, 4c, 4e, 4f, 4h, 4j, 4k, 4l, 4m, 4n, 5, 6) is driven
with the kernels' launch counts set to 0 just before it and read just
after: every kernel of the path must have launched in it. A replayed CUDA
graph runs the trace kernel without its Python wrapper, so on the paths
that replay (4f, 4j, 4k, 4l, 4m, 4n, 5) the trace kernel's count is the one
the kernel keeps on the device (`trace_kernel.kernel_runs`: one for each
run, launched or replayed), and it must equal the trace calls.

Any failure raises, and the script exits non-zero without the ok line.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_CHECK = 65536
RTOL = 1e-5
# the plain version runs in slices of this many lanes to bound its memory
PLAIN_SLICE = 1 << 20


def plain(tab, o, d, min_t, max_t, occlusion):
    """The plain version over slices of PLAIN_SLICE lanes, joined."""
    import torch
    from rrt_tpu_torch.ops import trace_kernel as tk
    outs = [tk.trace_rays_reference(tab, o[i:i + PLAIN_SLICE],
                                    d[i:i + PLAIN_SLICE],
                                    min_t[i:i + PLAIN_SLICE],
                                    max_t[i:i + PLAIN_SLICE], occlusion)
            for i in range(0, o.shape[0], PLAIN_SLICE)]
    return tk.TraceOut(**{f.name: torch.cat([getattr(x, f.name)
                                             for x in outs])
                          for f in dataclasses.fields(tk.TraceOut)})


def check(name, k, r, o, d, hole, n_seg):
    """Kernel output k against plain output r on the lanes (o, d); returns
    the max abs error of t and of the hit point over calm hit lanes."""
    import torch
    from rrt_tpu_torch.physics.schwarzschild import chaotic_lanes
    calm = (~chaotic_lanes(o, d, hole, n_seg) if n_seg > 1
            else torch.ones_like(k.hit))
    for field in ("hit", "absd", "prim", "seg", "nisect", "ncull"):
        if not torch.equal(getattr(k, field)[calm], getattr(r, field)[calm]):
            raise AssertionError(f"{name}: calm lanes differ in {field}")
    agree_hit = (k.hit == r.hit).float().mean().item()
    agree_prim = (k.prim == r.prim).float().mean().item()
    if min(agree_hit, agree_prim) < 0.999:
        raise AssertionError(f"{name}: hit/prim agree on {agree_hit:.5f}/"
                             f"{agree_prim:.5f} of lanes")
    m = calm & k.hit
    pk = k.seg_o + k.t[:, None] * k.seg_d
    pr = r.seg_o + r.t[:, None] * r.seg_d
    torch.testing.assert_close(k.t[m], r.t[m], rtol=RTOL, atol=1e-6)
    torch.testing.assert_close(pk[m], pr[m], rtol=RTOL, atol=1e-6)
    err = max((k.t[m] - r.t[m]).abs().max().item() if m.any() else 0.0,
              (pk[m] - pr[m]).abs().max().item() if m.any() else 0.0)
    print(f"[smoke] {name}: {k.hit.shape[0]} lanes, calm "
          f"{calm.float().mean().item():.3f}, hits "
          f"{k.hit.float().mean().item():.3f}, agree hit {agree_hit:.6f} "
          f"prim {agree_prim:.6f}, max abs err {err:.3g}")
    return err


def device_us_per_launch(fn, reps, match):
    """Mean device time of the launches of fn whose kernel name contains
    `match` (all device events when it is empty), from torch.profiler."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):      # a profile that caught no device event: again
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and match in ev.name]
        if us:
            return sum(us) / len(us)
    return float("nan")


def finite(obj):
    """obj with every float that is not finite (a time not measured)
    made None, so that it prints as JSON."""
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def host_us_per_call(fn, reps):
    """Host microseconds per call of fn over `reps` back-to-back calls,
    ending in a device sync."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def event_ms(fn, reps):
    """Median device milliseconds of fn over `reps` calls, each between two
    CUDA events, after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _peak_mib(dev):
    import torch
    return torch.cuda.max_memory_allocated(dev) / 2 ** 20


def _timed_call(dev, fn):
    """(seconds, result, peak MiB) of fn, host clock ending in a device
    sync, with the peak device memory counted from its start."""
    import torch
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, out, _peak_mib(dev)


def threefry_phase(dev, card, peak, n=1 << 20, reps=20):
    """The threefry kernel (`ops/csrc/threefry.cu`) against its plain
    version (`ops.threefry`'s, on the CPU) bit for bit at the main path's
    shapes, each also as a quarter of the lanes (a rank of four's window:
    the lanes [n/4, n/2)): the first pass's jitter (n, 2), a vertex's
    four light samples (four keys, (n, 2) each: one launch) and a roulette
    coin (n,), with n = 1,048,576 lanes; then a window of a draw of 2^31
    + 5 elements (64-bit indexing), and the key entry (split, fold_in of
    an int and of a device tensor, a batch of keys). Each shape timed on
    the device (`torch.profiler`, the mean of `reps` launches) and as an
    eager call between CUDA events (median of `reps`: the host's launch
    included), beside the plain
    version on the card (events) and `torch.rand` at the same shape (its
    device time), and its least time: the larger of its operations
    (`UNIFORM_OPS` a uniform) at the card's float32 peak `peak` and its
    bytes (4 a uniform written) at the memory rate. Returns the rows."""
    import torch
    from rrt_tpu_torch.ops import threefry
    from rrt_tpu_torch.tools.trace_modes import HBM_BYTES_PER_S
    from rrt_tpu_torch.utils import prng

    cpu = torch.device("cpu")
    # the main path's keys: the pass key of seed 0, its jitter's, and a
    # vertex's light-sample, coin and BSDF keys
    base = prng.key(0, dev)
    key = prng.fold_in(prng.fold_in(base, torch.zeros((), dtype=torch.int32,
                                                      device=dev)), 0)
    k_jit, _, k_rad = prng.split(key, 3)
    k_nee, k_coin, _ = prng.split(prng.split(k_rad)[1], 3)
    lights = []
    for _ in range(4):
        k_nee, k = prng.split(k_nee)
        lights.append(k)
    lights = torch.stack(lights)
    quarter = (n // 4, n // 2)
    cases = {
        "jitter": (k_jit, (n, 2), None),
        "light samples": (lights, (n, 2), None),
        "coin": (k_coin, (n,), None),
        "jitter, a quarter": (k_jit, (n, 2), (0, *quarter)),
        "light samples, a quarter": (lights, (n, 2), (0, *quarter)),
        "coin, a quarter": (k_coin, (n,), (0, *quarter)),
    }
    rows, err = {}, 0.0
    for name, (keys, shape, window) in cases.items():
        axis, lo, hi = window or (0, 0, shape[0])
        got = threefry.uniform(keys, shape, axis, lo, hi)
        want = threefry.uniform_reference(keys.to(cpu), shape, axis, lo, hi)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"threefry {name}: the kernel differs from "
                                 f"its plain version")
        err = max(err, float((got.cpu() - want).abs().max()))
        count = got.numel()
        fn = lambda: threefry.uniform(keys, shape, axis, lo, hi)
        ms = device_us_per_launch(fn, reps, "uniform_kernel") / 1e3
        call_ms = event_ms(fn, reps)
        plain_ms = event_ms(lambda: threefry.uniform_reference(
            keys, shape, axis, lo, hi), max(reps // 4, 3))
        library_ms = device_us_per_launch(
            lambda: torch.rand(got.shape, device=dev), reps, "") / 1e3
        t_ops = count * threefry.UNIFORM_OPS / peak
        t_bytes = (4 * count + 16 * keys.numel() // 2) / HBM_BYTES_PER_S
        rows[name] = dict(uniforms=count, ms=ms, call_ms=call_ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=1e3 * max(t_ops, t_bytes),
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes")
        print(f"[smoke] threefry {name}: {tuple(got.shape)}, equal to the "
              f"plain version bit for bit; kernel {ms:.4f} ms on the device "
              f"({call_ms:.4f} ms an eager call), plain {plain_ms:.3f} ms, "
              f"torch.rand {library_ms:.4f} ms on the device, bound "
              f"{rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']}; "
              f"{card})")
    # a window past 2^31 (64-bit indexing)
    args = ((2 ** 31 + 5,), 0, 2 ** 31 - 995, 2 ** 31 + 5)
    got = threefry.uniform(k_coin, *args)
    if not torch.equal(got.cpu(),
                       threefry.uniform_reference(k_coin.cpu(), *args)):
        raise AssertionError("threefry 2^31 + 5 elements: the kernel differs")
    print("[smoke] threefry 2^31 + 5 elements, its last 1000: equal to the "
          "plain version")
    # the key entry: split, fold_in of an int and of a device tensor
    s = torch.tensor(16, dtype=torch.int32, device=dev)
    key_err = 0
    for name, fn in (("split 3", lambda k: threefry.derive(k, 3)),
                     ("fold_in 0", lambda k: threefry.derive(k, 1, offset=0)),
                     ("fold_in of a device tensor",
                      lambda k: threefry.derive(k, 1, data=s if k.is_cuda
                                                else s.cpu())),
                     ("split 2 of four keys",
                      lambda k: threefry.derive(torch.stack([k] * 4), 2))):
        got, want = fn(key).cpu(), fn(key.cpu())
        if not torch.equal(got, want):
            raise AssertionError(f"threefry keys {name}: the kernel differs")
        key_err = max(key_err, int((got - want).abs().max()))
    key_ms = device_us_per_launch(lambda: threefry.derive(key, 3), reps,
                                  "keys_kernel") / 1e3
    key_call_ms = event_ms(lambda: threefry.derive(key, 3), reps)
    key_plain_ms = event_ms(lambda: threefry.derive_reference(key, 3), reps)
    t_key = (3 * threefry.KEY_OPS / peak, 64 / HBM_BYTES_PER_S)
    rows["keys"] = dict(ms=key_ms, call_ms=key_call_ms, max_abs_err=key_err,
                        plain_ms=key_plain_ms,
                        bound_ms=1e3 * max(t_key),
                        bound_by="operations" if t_key[0] >= t_key[1]
                        else "bytes")
    print(f"[smoke] threefry keys: split, fold_in (int, device tensor), a "
          f"batch, equal to the plain version; split 3: kernel "
          f"{key_ms:.4f} ms on the device ({key_call_ms:.4f} ms an eager "
          f"call), plain {key_plain_ms:.4f} ms ({card})")
    return dict(rows=rows, max_abs_err=err)


def card_vs_cpu_phase(dev, card, size=32):
    """The port's render of one small config on the card against its
    render on the CPU, both drawing the same threefry uniforms from the
    seed: global illumination at -m 5, flat (4 spp, -l 4) and curved (1
    spp, -l 1), held to the per-pixel rule of the JAX parity tests: flat,
    ≥ 99% of the pixels within atol 1e-4 + rtol 1e-3; curved, ≥ 99%
    within rtol 1e-2 (tests/test_torch_render_parity.py,
    tests/test_torch_curved_parity.py); the means within 1e-3 in both.
    Returns the shares."""
    import torch
    from rrt_tpu_torch.render.renderer import Renderer
    from rrt_tpu_torch.scene.build import load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES
    from rrt_tpu_torch.utils.config import (BlackHoleConfig, Illum,
                                            RenderConfig)
    out = {}
    for name, kw, tol in (
            ("flat", dict(ns_aa=4, ns_area_light=4,
                          black_hole=BlackHoleConfig(enabled=False)),
             dict(atol=1e-4, rtol=1e-3)),
            ("curved", dict(ns_aa=1, ns_area_light=1), dict(rtol=1e-2))):
        cfg = RenderConfig(width=size, height=size, max_ray_depth=5, seed=3,
                           illum=Illum.FULL, **kw)
        imgs = []
        for d in (dev, torch.device("cpu")):
            sc, cm = load_scene(CBOX_SPHERES, d, size, size)
            imgs.append(Renderer(sc, cm, cfg, d).render()[0])
        share = float(np.isclose(imgs[0], imgs[1], **tol).all(-1).mean())
        mean = abs(float(imgs[0].mean()) / float(imgs[1].mean()) - 1)
        out[name] = dict(share=share, mean_rel=mean)
        print(f"[smoke] {size}x{size} {name} GI -m 5 {cfg.ns_aa} spp -l "
              f"{cfg.ns_area_light}, card vs CPU: {share:.4f} of pixels "
              f"within {tol}, means {mean:.2e} apart ({card})")
        if share < 0.99 or mean > 1e-3:
            raise AssertionError(f"card and CPU {name} renders disagree")
    return out


def lifecycle_phase(dev, card, tmp, size=256, spp=16, cell=(64, 32, 96, 80)):
    """The render lifecycle on the main path (256×256, 16 spp, -l 4, -m 5,
    one sample a pass): an uninterrupted render twice, a render
    checkpointed every 4 samples and stopped after 8, its resume (equal to
    the uninterrupted render bit for bit), a NORMAL-mode cell against the
    crop of the full frame, and a preview every 4 samples."""
    import torch
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.render.renderer import Renderer
    from rrt_tpu_torch.scene.build import load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES
    from rrt_tpu_torch.utils.config import Illum, RenderConfig
    cfg = RenderConfig(width=size, height=size, ns_aa=spp, ns_area_light=4,
                       max_ray_depth=5, max_pass_lanes=size * size)
    scene, cam = load_scene(CBOX_SPHERES, dev, size, size)
    out = {}
    tk.reset_counts()
    r1 = Renderer(scene, cam, cfg, dev)
    out["wall"], (full, full_count), out["peak_mib"] = _timed_call(
        dev, r1.render)
    out["launches"] = tk.kernel_runs()      # the first pass's and replays
    if out["launches"] != r1.last_trace_calls or out["launches"] == 0:
        raise AssertionError(f"lifecycle: {out['launches']} kernel runs "
                             f"for {r1.last_trace_calls} trace calls")
    # a second uninterrupted render: the first pays its shapes' first use
    out["warm_wall"], (again, _), _ = _timed_call(
        dev, Renderer(scene, cam, cfg, dev).render)
    out["repeat_equal"] = bool(np.array_equal(again, full))
    ckpt = os.path.join(tmp, "state.npz")
    r2 = Renderer(scene, cam, cfg, dev)
    out["stopped_wall"], _, _ = _timed_call(dev, lambda: r2.render(
        checkpoint_path=ckpt, checkpoint_every=4, stop_after=spp // 2))
    if not (r2.cancelled and r2.samples_done == spp // 2):
        raise AssertionError(f"lifecycle: stop_after ended at "
                             f"{r2.samples_done}, cancelled {r2.cancelled}")
    out["checkpoint_bytes"] = os.path.getsize(ckpt)
    acc = tuple(torch.as_tensor(a, device=dev) for a in r2.last_accumulators)
    saves = []
    for _ in range(3):
        t0 = time.perf_counter()
        r2.save_checkpoint(os.path.join(tmp, "again.npz"), acc, spp // 2,
                           (0, 0, size, size))
        saves.append(time.perf_counter() - t0)
    out["checkpoint_s"] = min(saves)
    r3 = Renderer(scene, cam, cfg, dev)
    out["resume_wall"], (resumed, resumed_count), _ = _timed_call(
        dev, lambda: r3.render(checkpoint_path=ckpt, resume=True))
    out["resume_equal"] = bool(
        np.array_equal(resumed, full) and np.array_equal(resumed_count,
                                                         full_count)
        and all(np.array_equal(a, b) for a, b in zip(r3.last_accumulators,
                                                      r1.last_accumulators)))
    out["resume_overhead"] = (out["stopped_wall"] + out["resume_wall"]
                              - out["warm_wall"])
    print(f"[smoke] lifecycle {size}x{size} {spp}spp -l 4 -m 5, one sample a "
          f"pass: uninterrupted {out['wall']:.3f} s ({out['launches']} "
          f"kernel launches = trace calls, peak {out['peak_mib']:.1f} MiB), "
          f"again {out['warm_wall']:.3f} s and equal {out['repeat_equal']}; "
          f"checkpointed every 4 and stopped at {spp // 2}: "
          f"{out['stopped_wall']:.3f} s, resumed: {out['resume_wall']:.3f} "
          f"s, equal to the uninterrupted render bit for bit "
          f"{out['resume_equal']}, overhead against the second render "
          f"{out['resume_overhead']:.3f} s; checkpoint "
          f"{out['checkpoint_bytes']} bytes, saved in "
          f"{out['checkpoint_s'] * 1e3:.2f} ms ({card})")
    if not out["resume_equal"]:
        raise AssertionError("lifecycle: the resumed render differs from "
                             "the uninterrupted one (repeat equal "
                             f"{out['repeat_equal']})")
    ncfg = cfg.replace(illum=Illum.NORMAL, ns_aa=1)
    rn = Renderer(scene, cam, ncfg, dev)
    out["normal_wall"], (nfull, _), _ = _timed_call(dev, rn.render)
    x, y, dx, dy = cell
    out["cell_wall"], ncell, _ = _timed_call(
        dev, lambda: rn.render_cell(x, y, dx, dy))
    if not np.array_equal(ncell, nfull[y:y + dy, x:x + dx]):
        raise AssertionError("lifecycle: the cell differs from the crop")
    print(f"[smoke] NORMAL -p {x} {y} {dx} {dy}: equal to the crop of the "
          f"full frame; cell {out['cell_wall']:.4f} s, full frame "
          f"{out['normal_wall']:.4f} s ({card})")
    prev = os.path.join(tmp, "prev.png")
    r4 = Renderer(scene, cam, cfg, dev)
    written = []
    real = r4._write_preview
    r4._write_preview = lambda *a: written.append(done[-1]) or real(*a)
    done = []
    out["preview_wall"], _, _ = _timed_call(dev, lambda: r4.render(
        preview_path=prev, preview_every=4,
        progress=lambda s_, total: done.append(s_)))
    from rrt_tpu_torch.io.png import read_png
    if written != list(range(4, spp, 4)) \
            or read_png(prev).shape != (size, size, 4):
        raise AssertionError(f"lifecycle: {len(written)} previews")
    print(f"[smoke] preview every 4 samples: {len(written)} written, render "
          f"{out['preview_wall']:.3f} s ({card})")
    return out


class _Tee:
    """A stdout that also keeps what is written, and signals once a line
    holds `needle`."""

    def __init__(self, stream, needle):
        import threading
        self.stream, self.needle = stream, needle
        self.text = ""
        self.seen = threading.Event()

    def write(self, s):
        self.text += s
        if self.needle in self.text:
            self.seen.set()
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def serve_phase(dev, card, tmp, size=1024):
    """`--serve 0` through the CLI, twice: a second thread reads the
    server's port from the CLI's output, GETs /status.json, /accel.png and
    (once written) /preview.png, then POSTs {"spp_cap": 4} in the first
    run and {"action": "stop"} in the second; each render must end early
    and cancelled. Then the accel walk on cbox_dense over HTTP."""
    import contextlib
    import re
    import threading
    import urllib.error
    import urllib.request
    from rrt_tpu_torch import cli
    from rrt_tpu_torch.scene.build import build_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES, cbox_dense
    from rrt_tpu_torch.utils.accel_walk import AccelWalk
    from rrt_tpu_torch.utils.serve import PreviewServer

    def get(base, path):
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.read()

    def post(base, body):
        req = urllib.request.Request(base + "/control",
                                     data=json.dumps(body).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())

    out = {}
    for name, body in (("spp_cap", {"spp_cap": 4}),
                       ("stop", {"action": "stop"})):
        tee = _Tee(sys.stdout, "Live preview: http://localhost:")
        codes, errors = {}, []

        def client():
            try:
                if not tee.seen.wait(300):
                    raise TimeoutError("the CLI printed no server address")
                port = re.search(r"localhost:(\d+)/", tee.text).group(1)
                base = f"http://127.0.0.1:{port}"
                for path in ("/status.json", "/accel.png"):
                    codes[path] = get(base, path)[0]
                if name == "spp_cap":
                    for _ in range(3000):
                        try:
                            codes["/preview.png"] = get(base,
                                                        "/preview.png")[0]
                            break
                        except urllib.error.HTTPError:
                            time.sleep(0.01)
                codes["POST /control"] = post(base, body)[0]
            except Exception as e:      # reported and failed below
                errors.append(repr(e))

        thread = threading.Thread(target=client)
        thread.start()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rend = cli.main(["-f", os.path.join(tmp, f"serve_{name}.png"),
                             "-r", str(size), str(size), "-s", "16", "-l",
                             "4", "-m", "5", "--serve", "0", "--device",
                             dev.type, CBOX_SPHERES])
        wall = time.perf_counter() - t0
        thread.join(60)
        if thread.is_alive() or errors:
            raise AssertionError(f"serve {name}: client {errors}")
        want = {"/status.json", "/accel.png", "POST /control"} | (
            {"/preview.png"} if name == "spp_cap" else set())
        if set(codes) != want or set(codes.values()) != {200}:
            raise AssertionError(f"serve {name}: answers {codes}")
        lo = 4 if name == "spp_cap" else 1
        if not (rend.cancelled and lo <= rend.samples_done < 16):
            raise AssertionError(f"serve {name}: ended at "
                                 f"{rend.samples_done} samples, cancelled "
                                 f"{rend.cancelled}")
        out[name] = dict(samples=rend.samples_done, wall=wall)
        print(f"[smoke] --serve 0 {size}x{size} 16spp, POST {body}: answers "
              f"{codes}, render cancelled after {rend.samples_done} "
              f"samples/pixel, wall {wall:.2f} s ({card})")
    dense, dcam = build_scene(cbox_dense(), dev, 256, 256)
    srv = PreviewServer(os.path.join(tmp, "none.png"), 0,
                        accel=AccelWalk(dense, dcam)).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        steps = []
        for key in ("left", "left", "right", "up"):
            _, resp = post(base, {"accel": key})
            st = json.loads(get(base, "/status.json")[1])["accel"]
            steps.append((key, resp["moved"], st["level"], st["index"]))
        code, png = get(base, "/accel.png")
    finally:
        srv.stop()
    if not all(moved for _, moved, _, _ in steps) or code != 200 \
            or steps[2][3] != 1 or steps[3][2] != "part":
        raise AssertionError(f"accel walk on cbox_dense: {steps}, {code}")
    print(f"[smoke] accel walk on cbox_dense over HTTP: {steps}, "
          f"/accel.png {len(png)} bytes")
    return out


def dumps_phase(dev, card, tmp, size=256):
    """--dump-rays and --dump-accel: the CLI with both flags on the
    Cornell box, then each dump alone on the Cornell box (curved and flat)
    and on cbox_dense, timed with its trace launches and peak memory; the
    ray log from the kernel against the same log from the plain traversal
    on the card's tensors."""
    import torch
    from rrt_tpu_torch import cli
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.physics.schwarzschild import chaotic_lanes
    from rrt_tpu_torch.render.renderer import make_black_hole
    from rrt_tpu_torch.scene.build import build_scene, load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES, cbox_dense
    from rrt_tpu_torch.utils import accel_viz, ray_debug
    from rrt_tpu_torch.utils.config import BlackHoleConfig, RenderConfig

    base = os.path.join(tmp, "cli")
    tk.LAUNCHES = 0
    cli_wall, rend, _ = _timed_call(dev, lambda: cli.main([
        "-f", base + ".png", "-r", str(size), str(size), "-s", "1",
        "--illum", "0", "--dump-rays", base, "--dump-accel", base,
        "--device", dev.type, CBOX_SPHERES]))
    cli_launches = tk.LAUNCHES
    if cli_launches != rend.last_trace_calls + 1:
        raise AssertionError(f"dumps: {cli_launches} launches through the "
                             f"CLI for {rend.last_trace_calls} + 1")
    for suffix in ("_accel.json", "_accel.png", "_raylog.npz",
                   "_raylog_hit.png", "_raylog_cost.png", "_raylog_seg.png"):
        if not os.path.getsize(base + suffix):
            raise AssertionError(f"dumps: empty {suffix}")
    print(f"[smoke] CLI --dump-rays --dump-accel {size}x{size}: wall "
          f"{cli_wall:.2f} s, {cli_launches} kernel launches ({card})")
    cfg = RenderConfig(width=size, height=size)
    rows = []
    for name, info_or_path, curved in (
            ("cbox curved", CBOX_SPHERES, True),
            ("cbox flat", CBOX_SPHERES, False),
            ("dense curved", None, True)):
        if info_or_path is None:
            scene, cam = build_scene(cbox_dense(), dev, size, size)
        else:
            scene, cam = load_scene(info_or_path, dev, size, size)
        bh = make_black_hole(cfg.replace(black_hole=BlackHoleConfig(
            enabled=curved)), dev)
        stem = os.path.join(tmp, name.replace(" ", "_"))
        tk.LAUNCHES = 0
        rays_wall, log, rays_mib = _timed_call(
            dev, lambda: ray_debug.dump_ray_log(scene, bh, cam, size, size,
                                                stem))
        launches = tk.LAUNCHES
        accel_wall, counts, accel_mib = _timed_call(
            dev, lambda: accel_viz.dump_accel(scene, cam, size, size, stem))
        # the same log with the plain traversal on the card's tensors
        kernel = tk.trace_rays
        tk.trace_rays = tk.trace_rays_reference
        try:
            tk.LAUNCHES = 0
            plain = ray_debug.ray_log(scene, bh, cam, size, size)
            if tk.LAUNCHES:
                raise AssertionError("the plain ray log launched the kernel")
        finally:
            tk.trace_rays = kernel
        rays = accel_viz.pixel_rays(cam, size, size, dev)
        calm = (~chaotic_lanes(rays.o, rays.d, bh, 63) if curved
                else torch.ones(size * size, dtype=torch.bool, device=dev))
        calm = calm.cpu().numpy().reshape(size, size)
        agree = {}
        for key in ("outcome", "win_seg", "prim", "marched", "clusters"):
            eq = log[key] == plain[key]
            if not eq[calm].all():
                raise AssertionError(f"dumps {name}: calm lanes differ in "
                                     f"{key}")
            agree[key] = float(eq.mean())
        if min(agree.values()) < 0.995:
            raise AssertionError(f"dumps {name}: agreement {agree}")
        if launches != 1:
            raise AssertionError(f"dumps {name}: {launches} launches")
        outcomes = np.bincount(log["outcome"].ravel(), minlength=3).tolist()
        rows.append(dict(name=name, rays_wall=rays_wall, rays_mib=rays_mib,
                         launches=launches, accel_wall=accel_wall,
                         accel_mib=accel_mib, agree=agree,
                         calm=float(calm.mean()), outcomes=outcomes,
                         clusters=int(scene.cluster_lo.shape[0])))
        print(f"[smoke] dumps {name} {size}x{size}: ray log {rays_wall:.3f} "
              f"s ({launches} kernel launch, peak {rays_mib:.1f} MiB), accel "
              f"dump {accel_wall:.3f} s (peak {accel_mib:.1f} MiB, "
              f"{rows[-1]['clusters']} clusters, touched mean "
              f"{counts.mean():.1f}); outcomes miss/hit/absorbed "
              f"{outcomes}; kernel vs plain: calm "
              f"{rows[-1]['calm']:.3f} equal, all {agree} ({card})")
    return dict(cli_wall=cli_wall, cli_launches=cli_launches, rows=rows,
                launches=cli_launches + sum(r["launches"] for r in rows))


def kerr_phase(dev, card, size=1024, n_steps=600, small=32):
    """BASELINE config 5 at full width on the card (1024×1024, spin 0.9,
    mass 1, disk [3, 12], 600 RK4 steps, one batch of 1 << 20 lanes; 1 spp
    where config 5 has 16), with the structure checks of
    tests/test_kerr.py; the frame in captured blocks of steps (the
    default) and step by step, equal bit for bit, both timed; a 32×32,
    300-step render on the card against the CPU; launches per RK4 step and
    the device's busy share from eager profiles of 10- and 30-step renders,
    and from a 40-step march whose blocks are replayed."""
    import torch
    from rrt_tpu_torch.convert import disk_from_arrays, kerr_params_from_arrays
    from rrt_tpu_torch.render import kerr_scene as K
    from rrt_tpu_torch.utils.profile import profile_call

    def hole(d):
        return (kerr_params_from_arrays((0.0, 0.0, 0.0), 1.0, 0.9, d),
                disk_from_arrays(3.0, 12.0, (1.0, 0.85, 0.6), 2.0, True, d))
    bh, disk = hole(dev)
    K.render_image(64, 64, bh, disk, n_steps=4, device=dev)     # warm-up
    wall, img, peak = _timed_call(dev, lambda: K.render_image(
        size, size, bh, disk, n_steps=n_steps, batch=1 << 20, device=dev))
    h, w = img.shape[:2]
    c = img[h // 2 - 2:h // 2 + 2, w // 2 - 2:w // 2 + 2]
    left, right = img[:, :w // 2].sum(), img[:, w // 2:].sum()
    asym = abs(left - right) / max(left, right)
    corners = [img[0, 0].sum(), img[0, -1].sum(), img[-1, 0].sum(),
               img[-1, -1].sum()]
    checks = {"finite": bool(np.isfinite(img).all()),
              "shadow": bool(c.max() < 1e-3), "disk": bool(img.max() > 0.5),
              "corners": bool(min(corners) > 0.0), "asymmetry": bool(
                  asym > 0.2)}
    n = size * size
    # the same frame with the steps one by one (the march's blocks are
    # CUDA graphs by default): equal bit for bit
    ewall, eimg, _ = _timed_call(dev, lambda: K.render_image(
        size, size, bh, disk, n_steps=n_steps, batch=1 << 20, device=dev,
        graphs=False))
    checks["blocks equal steps"] = bool(np.array_equal(img, eimg))
    # launches a step and the busy share: eager at 10 and 30 steps; in
    # captured blocks, 40 steps through a march whose blocks a first call
    # captured
    prof = {}
    for steps in (10, 30):
        prof[steps] = profile_call(lambda: K.render_image(
            size, size, bh, disk, n_steps=steps, batch=1 << 20, device=dev,
            graphs=False), device=dev)
    per_step = (prof[30].launches - prof[10].launches) / 20
    busy = prof[30].device_ms / (1e3 * prof[30].wall)
    o, d = K.look_at_rays((0.0, 3.0, 22.0), (0.0, 0.0, 0.0),
                          (0.0, 1.0, 0.0), 30.0, size, size, device=dev)
    march = K.DiskMarch(bh, disk)
    K.render_rays(o, d, bh, disk, n_steps=40, march=march)
    gprof = profile_call(lambda: K.render_rays(
        o, d, bh, disk, n_steps=40, march=march), device=dev)
    gbusy = gprof.device_ms / (1e3 * gprof.wall)
    del o, d, march
    print(f"[smoke] Kerr {size}x{size} 1spp {n_steps} RK4 steps, spin 0.9, "
          f"disk [3, 12]: wall {wall:.2f} s in captured blocks of "
          f"{K.MARCH_BLOCK} steps, {ewall:.2f} s step by step; "
          f"{n / wall:.4g} rays/s, "
          f"{n * n_steps / wall:.4g} RK4 steps/s, peak {peak:.1f} MiB; "
          f"checks {checks} (centre max {c.max():.3g}, max "
          f"{img.max():.3g}, corners {[round(float(x), 4) for x in corners]}"
          f", asymmetry {asym:.3f}); {per_step:.1f} launches a step, "
          f"30-step eager profile: wall {prof[30].wall:.3f} s, device "
          f"{prof[30].device_ms:.1f} ms ({busy:.1%} busy); 40 steps in "
          f"blocks: wall {gprof.wall:.3f} s, device {gprof.device_ms:.1f} "
          f"ms ({gbusy:.1%} busy), {gprof.host_launches / 40:.2f} host "
          f"launches a step ({card})")
    print(f"[smoke] Kerr 30-step profile: {prof[30].report()}")
    if not all(checks.values()):
        raise AssertionError(f"Kerr structure checks {checks}")
    # the card against the CPU at 32x32, 300 steps
    res = []
    for d in (dev, torch.device("cpu")):
        b, dk = hole(d)
        o, dd = K.look_at_rays((0.0, 3.0, 22.0), (0.0, 0.0, 0.0),
                               (0.0, 1.0, 0.0), 30.0, small, small,
                               device=d)
        st, _, hit = K.trace_disk(o, dd, b, dk, 300)
        res.append((hit.cpu().numpy(), (st.escaped & ~hit).cpu().numpy(),
                    K.render_rays(o, dd, b, dk, n_steps=300).cpu().numpy()))
    (hc, ec, rc), (hp, ep, rp) = res
    agree = (hc == hp) & (ec == ep)
    close = bool(np.allclose(rc[agree], rp[agree], rtol=1e-3, atol=1e-6))
    print(f"[smoke] Kerr {small}x{small} 300 steps, card vs CPU: disk and "
          f"escape masks agree on {agree.mean():.4f} of lanes, radiance "
          f"within rtol 1e-3 there {close}")
    if agree.mean() < 0.99 or not close:
        raise AssertionError("Kerr: card and CPU disagree")
    return dict(wall=wall, eager_wall=ewall, rays_per_s=n / wall,
                steps_per_s=n * n_steps / wall, peak_mib=peak,
                launches_per_step=per_step, busy=busy, graph_busy=gbusy,
                graph_host_launches_per_step=gprof.host_launches / 40,
                agree=float(agree.mean()))


def _spread(xs):
    """median, min and max of a list, as a short string."""
    return (f"median {float(np.median(xs)):.4f} s "
            f"[{min(xs):.4f}, {max(xs):.4f}]")


def grad_step_case(dev, card, name, problem, reps=5, ranges=(), mesh=None):
    """One inverse-rendering step of `problem` = (params, scene, hole,
    rays, cfg, target, seed) through `diff.LossAndGrad`, eagerly
    (`graphs=False`) and compiled (a CUDA graph captured at its second
    call and replayed after): the compiled step equal to the eager one bit
    for bit at every call (loss and all eleven gradients; the SGD update
    of `train_step` at the end), the kernel's own count of its runs equal
    to the step's trace calls at every call, the Python launcher's count
    too in an eager step and 0 in a replayed one; walls in turns, `reps`
    each; host launches and the busy share of a profiled step of each
    (`ranges` split the eager one's device time); peak memory above the
    case's start, eager and at the capture; the capture seconds and the
    graph pool's reserved MiB. Returns (row, the eager (loss, grads), the
    eager step's profile). With `mesh`, the sharded step: its two halves
    captured around the all-reduce, the capture seconds of both."""
    import gc
    import torch
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.render import diff
    from rrt_tpu_torch.utils import prng
    from rrt_tpu_torch.utils.profile import profile_call

    params, scene, bh, rays, cfg, target, seed = problem
    gen = lambda: prng.key(seed, dev)
    mib = 2 ** 20
    t_case = time.perf_counter()
    held = torch.cuda.memory_allocated(dev) / mib
    steps = {g: diff.LossAndGrad(scene, bh, cfg, rays, target, graphs=g,
                                 mesh=mesh)
             for g in (False, True)}

    def same(a, b):
        return torch.equal(a[0], b[0]) and all(
            torch.equal(x, y) for x, y in zip(a[1].leaves(), b[1].leaves()))

    runs = {}     # graphs -> the kernel's runs in the last call

    def counted(g, eager=False):
        """A call of the step; it launches through Python only when it
        runs eagerly (`graphs=False`, or the compiled step's warm-up)."""
        tk.reset_counts()
        w, out, peak = _timed_call(dev, lambda: steps[g](params, gen()))
        calls, runs[g] = steps[g].trace_calls, tk.kernel_runs()
        if runs[g] != calls or calls == 0 or tk.LAUNCHES != (
                calls if eager or not g else 0):
            raise AssertionError(
                f"{name} (graphs {g}): {runs[g]} kernel runs and "
                f"{tk.LAUNCHES} eager launches for {calls} trace calls")
        return w, out, peak

    _, ref, eager_peak = counted(False)
    first, got, _ = counted(True, eager=True)     # the warm-up
    equal = [same(got, ref)]
    second, got, cap_peak = counted(True)         # captured and replayed
    equal.append(same(got, ref))
    walls = {False: [], True: []}
    for g in (False, True, True, False) * ((reps + 1) // 2):
        if len(walls[g]) == reps:
            continue
        w, got, _ = counted(g)
        walls[g].append(w)
        equal.append(same(got, ref))
    trained = [steps[g].train_step(params, None, gen(), lr=0.5)
               for g in (False, True)]
    equal.append(torch.equal(trained[0][2], trained[1][2]) and all(
        torch.equal(x, y) for x, y in zip(trained[0][0].leaves(),
                                          trained[1][0].leaves())))
    prof = {g: profile_call(lambda: steps[g](params, gen()),
                            ranges=() if g else ranges, device=dev)
            for g in (False, True)}
    call = steps[True].call
    capture, replays = call.capture_seconds, call.replays
    if mesh is not None:
        capture += steps[True].update.capture_seconds
    trace_calls = steps[True].trace_calls
    # the graph's memory pool: what the compiled step keeps reserved, the
    # eager step and the cached blocks gone, against the same without it
    del steps[False], trained, got, call
    gc.collect()
    torch.cuda.empty_cache()
    pool = torch.cuda.memory_reserved(dev) / mib
    del steps
    gc.collect()
    torch.cuda.empty_cache()
    pool -= torch.cuda.memory_reserved(dev) / mib
    row = dict(
        equal=all(equal), calls=len(equal), trace_calls=trace_calls,
        replay_kernel_runs=runs[True], eager=walls[False],
        graph=walls[True], first_graph_call=first, capture_call=second,
        capture_s=capture, replays=replays,
        host_launches={str(g): p.host_launches for g, p in prof.items()},
        busy={str(g): p.device_ms / (1e3 * p.wall) for g, p in prof.items()},
        # the profiled step's device time over the median unprofiled wall
        # (tracing every kernel slows a profiled replay)
        device_over_wall={str(g): p.device_ms / (1e3 * np.median(walls[g]))
                          for g, p in prof.items()},
        device_ms={str(g): p.device_ms for g, p in prof.items()},
        peak_mib=dict(eager=eager_peak - held, graph_capture=cap_peak - held),
        pool_mib=pool, seconds=time.perf_counter() - t_case)
    print(f"[smoke] gradient step, {name}: compiled = eager bit for bit "
          f"{row['equal']} ({row['calls']} calls, loss, 11 gradients and "
          f"the SGD update); eager {_spread(walls[False])}, compiled "
          f"{_spread(walls[True])}; first compiled call (eager) {first:.4f} "
          f"s, second {second:.4f} s (capture {capture:.4f} s); host "
          f"launches a step eager {prof[False].host_launches}, compiled "
          f"{prof[True].host_launches} ({prof[True].graph_launches} graph "
          f"replays); busy eager {row['busy']['False']:.1%}, compiled "
          f"{row['busy']['True']:.1%} (device over the median wall: "
          f"{row['device_over_wall']['False']:.1%} / "
          f"{row['device_over_wall']['True']:.1%}; device "
          f"{prof[False].device_ms:.1f} / "
          f"{prof[True].device_ms:.1f} ms); peak above the case's start "
          f"eager {row['peak_mib']['eager']:.1f} MiB, at the capture "
          f"{row['peak_mib']['graph_capture']:.1f} MiB; graph pool "
          f"{pool:.1f} MiB reserved; case {row['seconds']:.1f} s ({card})")
    if not row["equal"]:
        raise AssertionError(f"gradient step, {name}: the compiled step "
                             f"differs from the eager one")
    return row, ref, prof[False]


def graphs_phase(dev, card, tmp, reps=5):
    """4m: each pass shape captured as a CUDA graph and replayed
    (`Renderer._pass_fn`, `kerr_scene.DiskMarch`) against the eager path
    (`graphs=False`), bit for bit in accumulators, counters and trace
    calls, on the primary cell, a render with a tail pass, two `-p` cells
    of one size (the second replays the first's graph), an adaptive render
    across its batch boundaries, the 16-pass lifecycle render stopped at 8
    samples and resumed, `cbox_dense`, a flat render, the env-lit render,
    and Kerr at 64×64 (the march in blocks). For each: eager and graph
    walls in turns, host launches a pass, the busy share, peak memory above
    what the case started with, the graph pool's reserved memory and the
    capture time."""
    import gc
    import torch
    from rrt_tpu_torch.convert import disk_from_arrays, kerr_params_from_arrays
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.render import kerr_scene as K
    from rrt_tpu_torch.render.renderer import Renderer
    from rrt_tpu_torch.scene.build import build_scene, load_scene
    from rrt_tpu_torch.scene.envmap import build_envmap
    from rrt_tpu_torch.scenes import CBOX_SPHERES, cbox_dense
    from rrt_tpu_torch.utils import prng
    from rrt_tpu_torch.utils.config import BlackHoleConfig, RenderConfig
    from rrt_tpu_torch.utils.profile import passes_run, profile_call

    size = 256
    base = RenderConfig(width=size, height=size, ns_aa=16, ns_area_light=4,
                        max_ray_depth=5)
    box = load_scene(CBOX_SPHERES, dev, size, size)
    theta = (np.arange(256) + 0.5) / 256 * np.pi
    phi = (np.arange(512) + 0.5) / 512 * 2 * np.pi
    sky = (0.2 + 0.8 * np.cos(theta / 2) ** 2)[:, None, None] \
        * np.array([0.4, 0.6, 1.0]) * np.ones((1, 512, 1))
    sky[((theta[:, None] - 0.6) ** 2 + (phi[None, :] - 2.0) ** 2)
        < 0.05 ** 2] = (2e3, 1.8e3, 1.4e3)
    env = build_envmap(sky.astype(np.float32), dev)
    lit = load_scene(CBOX_SPHERES, dev, size, size, env=env)
    dense = build_scene(cbox_dense(), dev, 128, 128)
    ckpt = os.path.join(tmp, "graphs.npz")

    def state(r):
        return [*r.last_accumulators, r.last_trace_tests,
                np.array([r.last_trace_calls, r.samples_done])]

    def render(**kw):
        def run(r):
            r.render(**kw)
            return state(r), r.last_trace_calls
        return run

    def cells(r):
        out, calls = [], 0
        for x, y in ((64, 32), (0, 0)):
            r.render(region=(x, y, 96, 80))
            out += state(r)
            calls += r.last_trace_calls
        return out, calls

    def stop_resume(r):
        r.render(checkpoint_path=ckpt, checkpoint_every=4, stop_after=8)
        calls = r.last_trace_calls
        r.render(checkpoint_path=ckpt, resume=True)
        os.remove(ckpt)
        return list(r.last_accumulators), calls + r.last_trace_calls

    cases = [
        ("primary 256x256 16spp, one pass", box, base, render()),
        ("tail pass: 10 spp at k=4", box, base.replace(
            ns_aa=10, max_pass_lanes=4 * size * size), render()),
        ("two -p cells 96x80, one graph", box, base.replace(ns_aa=4),
         cells),
        ("adaptive -a, batch 4 at k=2", box, base.replace(
            ns_aa=16, adaptive=True, samples_per_batch=4,
            max_pass_lanes=2 * size * size), render()),
        ("lifecycle stopped at 8 and resumed", box, base.replace(
            max_pass_lanes=size * size), stop_resume),
        ("cbox_dense 128x128 1spp -l 1 -m 2", dense, RenderConfig(
            width=128, height=128, ns_aa=1, ns_area_light=1,
            max_ray_depth=2), render()),
        ("flat", box, base.replace(black_hole=BlackHoleConfig(
            enabled=False)), render()),
        ("env-lit", lit, base, render()),
    ]
    out = {}
    mib = 2 ** 20
    for name, (scene, cam), cfg, run in cases:
        t_case = time.perf_counter()
        held = torch.cuda.memory_allocated(dev) / mib
        rs = {g: Renderer(scene, cam, cfg, dev, graphs=g)
              for g in (False, True)}
        _, (ref, _), ref_peak = _timed_call(dev, lambda: run(rs[False]))

        def counted(g):
            """A render of rs[g]: (wall, accumulators, peak); the kernel's
            own count of its runs must equal the trace calls, and a graph
            render after the first two replays every pass, so that the
            Python launcher launches nothing."""
            tk.reset_counts()
            w, (got, calls), peak = _timed_call(dev, lambda: run(rs[g]))
            if tk.kernel_runs() != calls or calls == 0:
                raise AssertionError(f"graphs, {name}: {tk.kernel_runs()} "
                                     f"kernel runs for {calls} trace calls "
                                     f"(graphs {g})")
            if g and steady and tk.LAUNCHES:
                raise AssertionError(f"graphs, {name}: {tk.LAUNCHES} eager "
                                     f"launches in a replayed render")
            return w, got, peak

        # the graph renderer's first render runs each shape's first pass
        # eagerly and captures a shape at its second pass; the second
        # render captures the shapes that ran once
        steady = False
        first, got, cap_peak = counted(True)
        equal = [all(np.array_equal(a, b) for a, b in zip(got, ref))]
        second, got, peak = counted(True)
        cap_peak = max(cap_peak, peak)
        equal.append(all(np.array_equal(a, b) for a, b in zip(got, ref)))
        steady = True
        walls = {False: [], True: []}
        for g in (False, True, True, False) * ((reps + 1) // 2):
            if len(walls[g]) == reps:
                continue
            w, got, _ = counted(g)
            walls[g].append(w)
            equal.append(all(np.array_equal(a, b) for a, b in zip(got, ref)))
        prof = {}
        for g, r in rs.items():
            before = passes_run(r)
            prof[g] = profile_call(lambda: run(r), device=dev)
            prof[g].passes = passes_run(r) - before
        runners = rs[True]._pass_fns.values()
        capture = sum(p.call.capture_seconds for p in runners)
        replays = sum(p.call.replays for p in runners)
        # the graphs' memory pool: what the graph renderer keeps reserved,
        # the eager one and the cached blocks gone, against the same with
        # the graph renderer gone too
        del rs[False], runners, r
        gc.collect()
        torch.cuda.empty_cache()
        pool = torch.cuda.memory_reserved(dev) / mib
        del rs
        gc.collect()
        torch.cuda.empty_cache()
        pool -= torch.cuda.memory_reserved(dev) / mib
        ref_peak, cap_peak = ref_peak - held, cap_peak - held
        row = dict(
            equal=all(equal), eager=walls[False], graph=walls[True],
            first_graph_render=first, second_graph_render=second,
            capture_s=capture, replays=replays,
            peak_mib=dict(eager=ref_peak, graph_first=cap_peak),
            pool_mib=pool,
            host_launches_per_pass={str(g): p.host_launches / max(
                p.passes, 1) for g, p in prof.items()},
            busy={str(g): p.device_ms / (1e3 * p.wall)
                  for g, p in prof.items()},
            device_ms={str(g): p.device_ms for g, p in prof.items()},
            seconds=time.perf_counter() - t_case)
        out[name] = row
        print(f"[smoke] graphs, {name}: graph = eager bit for bit "
              f"{row['equal']} ({len(equal)} graph renders); eager "
              f"{_spread(walls[False])}, graph {_spread(walls[True])}; "
              f"first graph render {first:.4f} s, second {second:.4f} s "
              f"(capture {capture:.4f} s); host launches a pass eager "
              f"{row['host_launches_per_pass']['False']:.1f}, graph "
              f"{row['host_launches_per_pass']['True']:.1f}; busy eager "
              f"{row['busy']['False']:.1%}, graph {row['busy']['True']:.1%}"
              f" (device {prof[False].device_ms:.1f} / "
              f"{prof[True].device_ms:.1f} ms); peak above the case's start "
              f"eager {ref_peak:.1f} MiB, graph with capture "
              f"{cap_peak:.1f} MiB; graph pool {pool:.1f} MiB reserved; "
              f"case {row['seconds']:.1f} s ({card})")
        if not row["equal"]:
            raise AssertionError(f"graphs, {name}: the graph renders "
                                 f"differ from the eager render")

    # autograd inside a capture, as Kerr's `_rhs` uses it: the gradient of
    # sum(x·x·x) through a CapturedCall (eager, then captured and replayed,
    # then replayed) on new inputs each call, against eager autograd on the
    # same inputs and against the formula 3·x·x (a rounding apart: autograd
    # sums three products)
    from rrt_tpu_torch.utils.graphs import CapturedCall
    xs, gs = (torch.empty(4096, 3, device=dev) for _ in range(2))

    def grad_of_cube(x, g):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad((xg * xg * xg).sum(), (xg,))
        g.copy_(gx)

    call, probe = CapturedCall(grad_of_cube, dev, name="a cube's grad"), []
    keys = prng.split(prng.key(3, dev), 3)
    for i in range(3):
        xs.copy_(prng.uniform(keys[i], (4096, 3)))
        call(xs, gs)
        want = torch.empty_like(gs)
        grad_of_cube(xs, want)
        probe.append((bool(torch.equal(gs, want)),
                      float((gs - 3 * xs * xs).abs().max())))
    print(f"[smoke] graphs, autograd in a capture (grad of sum(x^3), 4096x3, "
          f"calls eager / captured / replayed): equal to eager autograd "
          f"{[e for e, _ in probe]}, max |grad - 3x^2| "
          f"{[d for _, d in probe]} ({card})")
    out["autograd probe"] = dict(equal=[e for e, _ in probe],
                                 formula_max_abs=[d for _, d in probe])
    if not all(e for e, _ in probe):
        raise AssertionError("graphs: a captured autograd.grad differs from "
                             "eager autograd")

    # Kerr at 64x64: render_rays with a DiskMarch kept across calls (the
    # first call runs each block eagerly, the second captures, the others
    # replay), then render_image both ways
    t_case = time.perf_counter()
    ksize, steps = 64, 30        # a block of 20 and a block of 10
    bh = kerr_params_from_arrays((0.0, 0.0, 0.0), 1.0, 0.9, dev)
    disk = disk_from_arrays(3.0, 12.0, (1.0, 0.85, 0.6), 2.0, True, dev)
    o, d = K.look_at_rays((0.0, 3.0, 22.0), (0.0, 0.0, 0.0),
                          (0.0, 1.0, 0.0), 30.0, ksize, ksize, device=dev)
    march = K.DiskMarch(bh, disk)
    held = torch.cuda.memory_allocated(dev) / mib
    _, ref, ref_peak = _timed_call(dev, lambda: K.render_rays(
        o, d, bh, disk, n_steps=steps))
    first, got, cap_peak = _timed_call(dev, lambda: K.render_rays(
        o, d, bh, disk, n_steps=steps, march=march))
    equal = [bool(torch.equal(got, ref))]
    second, got, peak = _timed_call(dev, lambda: K.render_rays(
        o, d, bh, disk, n_steps=steps, march=march))
    equal.append(bool(torch.equal(got, ref)))
    ref_peak, cap_peak = ref_peak - held, max(cap_peak, peak) - held
    walls = {False: [], True: []}
    for g in (False, True, True, False) * ((reps + 1) // 2):
        if len(walls[g]) == reps:
            continue
        w, got, _ = _timed_call(dev, lambda: K.render_rays(
            o, d, bh, disk, n_steps=steps, march=march if g else None))
        walls[g].append(w)
        equal.append(bool(torch.equal(got, ref)))
    img = {g: K.render_image(ksize, ksize, bh, disk, n_steps=steps,
                             device=dev, graphs=g) for g in (False, True)}
    equal.append(bool(np.array_equal(img[False], img[True])))
    prof = {g: profile_call(lambda: K.render_rays(
        o, d, bh, disk, n_steps=steps, march=march if g else None),
        device=dev) for g in (False, True)}
    calls = march.calls.values()
    row = dict(equal=all(equal), eager=walls[False], graph=walls[True],
               first_graph_call=first, second_graph_call=second,
               capture_s=sum(c.capture_seconds for c in calls),
               peak_mib=dict(eager=ref_peak, graph_first=cap_peak),
               host_launches_per_step={str(g): p.host_launches / steps
                                       for g, p in prof.items()},
               busy={str(g): p.device_ms / (1e3 * p.wall)
                     for g, p in prof.items()},
               device_ms={str(g): p.device_ms for g, p in prof.items()},
               block=K.MARCH_BLOCK, seconds=time.perf_counter() - t_case)
    out["kerr 64x64"] = row
    print(f"[smoke] graphs, Kerr {ksize}x{ksize} {steps} steps in blocks "
          f"of {K.MARCH_BLOCK}: graph = eager bit for bit {row['equal']} "
          f"(render_rays and render_image); eager {_spread(walls[False])}, "
          f"graph {_spread(walls[True])}; first graph call {first:.4f} s, "
          f"second {second:.4f} s (capture {row['capture_s']:.4f} s); host launches a step "
          f"eager {row['host_launches_per_step']['False']:.1f}, graph "
          f"{row['host_launches_per_step']['True']:.2f}; busy eager "
          f"{row['busy']['False']:.1%}, graph {row['busy']['True']:.1%}; "
          f"peak above the case's start eager {ref_peak:.1f} MiB, graph "
          f"with capture {cap_peak:.1f} MiB; case {row['seconds']:.1f} s "
          f"({card})")
    if not row["equal"]:
        raise AssertionError("graphs, Kerr: the blocks differ from the "
                             "step-by-step march")
    return out


# the CLI's main path in a fresh process of a checkout, from the call of
# `cli.main` to the device sync after it (scene load, the render, the PNG):
# the time to the first frame, imports and the kernel's build left out;
# with the argument "eager", the CLI's renderer is built with graphs=False
FIRST_FRAME = r'''
import functools, json, os, sys, tempfile, time
sys.path.insert(0, os.getcwd())
import torch
from rrt_tpu_torch import cli
from rrt_tpu_torch.ops import build
from rrt_tpu_torch.scenes import CBOX_SPHERES
if sys.argv[1:] == ["eager"]:
    cli.Renderer = functools.partial(cli.Renderer, graphs=False)
build.load_library("trace")
torch.zeros(1, device="cuda")
with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
    t0 = time.perf_counter()
    r = cli.main(["-f", os.path.join(tmp, "c.png"), "-r", "256", "256",
                  "-s", "16", "-l", "4", "-m", "5", "--device", "cuda",
                  CBOX_SPHERES])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
print(json.dumps({"wall": wall, "phases": dict(r.timer.phases)}))
'''


def first_frame_phase(parent, card, reps=4):
    """The CLI's main path (256², 16 spp, -l 4 -m 5: one pass) from a
    fresh process of `parent` (an earlier checkout), of this checkout, and
    of this checkout with an eager renderer (`graphs=False`), in turns
    (forward, then backward; `reps` each, after one untimed run of each
    that builds its kernels): the time to the first frame,
    `FIRST_FRAME`'s wall, and the renderer's phases."""
    import subprocess
    variants = {"parent": (os.path.abspath(parent), []), "this": (ROOT, []),
                "this, eager": (ROOT, ["eager"])}

    def once(name):
        cwd, extra = variants[name]
        res = subprocess.run([sys.executable, "-c", FIRST_FRAME, *extra],
                             cwd=cwd, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"first frame, {name}: "
                                 f"{res.stderr[-2000:]}")
        return json.loads(res.stdout.strip().splitlines()[-1])

    for name in variants:
        once(name)
    runs = {name: [] for name in variants}
    order = list(variants) + list(variants)[::-1]
    for name in order * ((reps + 1) // 2):
        if len(runs[name]) < reps:
            runs[name].append(once(name))
    out = {name: dict(wall=[r["wall"] for r in rs],
                      first_pass=[r["phases"]["compile+first-pass"]
                                  for r in rs])
           for name, rs in runs.items()}
    print("[smoke] first frame through the CLI (256x256 16spp -l 4 -m 5, "
          "one pass) in turns: " + "; ".join(
              f"{name} {_spread(o['wall'])} (first pass "
              f"{_spread(o['first_pass'])})" for name, o in out.items())
          + f" ({card})")
    return out


def sharded_render_case(dev, card, name, scene, cam, cfg, sharding, reps=3):
    """One sharded render of phase 4j on a world of 1: `Renderer(sharding=)`
    with graphs (each pass shape's rank half and accumulate half captured
    at its second pass, the gather between them eagerly) against the eager
    sharded renderer (`graphs=False`), the reference, and the unsharded
    graph renderer, bit for bit in accumulators, counters, trace calls and
    samples done, at every render; the kernel's runs equal to the trace
    calls in every render, and no Python launch in a steady graph render.
    Walls in turns (`reps` each), host launches a pass and the busy share
    of a profiled render of each, the collectives of a steady sharded
    graph render, the capture seconds of both halves and the sharded graph
    renderer's pool."""
    import gc
    import torch
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.parallel import distributed as pdist
    from rrt_tpu_torch.render.renderer import Renderer
    from rrt_tpu_torch.utils.profile import passes_run, profile_call

    mib = 2 ** 20
    t_case = time.perf_counter()
    held = torch.cuda.memory_allocated(dev) / mib
    labels = ("eager sharded", "graph sharded", "graph unsharded")
    rs = {"eager sharded": Renderer(scene, cam, cfg, dev, sharding=sharding,
                                    graphs=False),
          "graph sharded": Renderer(scene, cam, cfg, dev, sharding=sharding),
          "graph unsharded": Renderer(scene, cam, cfg, dev)}

    def run(r):
        r.render()
        return [*r.last_accumulators, r.last_trace_tests,
                np.array([r.last_trace_calls, r.samples_done])]

    steady = False

    def counted(label):
        tk.reset_counts()
        w, got, peak = _timed_call(dev, lambda: run(rs[label]))
        calls = rs[label].last_trace_calls
        if tk.kernel_runs() != calls or calls == 0:
            raise AssertionError(f"sharded graphs, {name}: {tk.kernel_runs()}"
                                 f" kernel runs for {calls} trace calls "
                                 f"({label})")
        if steady and rs[label].graphs and tk.LAUNCHES:
            raise AssertionError(f"sharded graphs, {name}: {tk.LAUNCHES} "
                                 f"eager launches in a replayed render "
                                 f"({label})")
        return w, got, peak

    _, ref, ref_peak = counted("eager sharded")
    equal, first, second, cap_peak = [], {}, {}, {}
    for label in labels[1:]:        # the shapes' eager passes, captures
        first[label], got, p1 = counted(label)
        equal.append(all(np.array_equal(a, b) for a, b in zip(got, ref)))
        second[label], got, p2 = counted(label)
        equal.append(all(np.array_equal(a, b) for a, b in zip(got, ref)))
        cap_peak[label] = max(p1, p2) - held
    steady = True
    walls = {label: [] for label in labels}
    for label in (labels + labels[::-1]) * ((reps + 1) // 2):
        if len(walls[label]) == reps:
            continue
        w, got, _ = counted(label)
        walls[label].append(w)
        equal.append(all(np.array_equal(a, b) for a, b in zip(got, ref)))
    # a steady sharded graph render: its collectives, and the kernel's
    # runs (every pass replayed) against its trace calls
    tk.reset_counts()
    pdist.COLLECTIVES.update(calls=0, bytes=0)
    run(rs["graph sharded"])
    collectives = dict(pdist.COLLECTIVES)
    runs, calls = tk.kernel_runs(), rs["graph sharded"].last_trace_calls
    if runs != calls or tk.LAUNCHES:
        raise AssertionError(f"sharded graphs, {name}: {runs} kernel runs "
                             f"and {tk.LAUNCHES} eager launches for {calls} "
                             f"trace calls")
    prof = {}
    for label, r in rs.items():
        before = passes_run(r)
        prof[label] = profile_call(lambda: run(r), device=dev)
        prof[label].passes = passes_run(r) - before
    calls_ = [c for p in rs["graph sharded"]._pass_fns.values()
              for c in (p.call, p.accumulate)]
    capture = sum(c.capture_seconds for c in calls_)
    replays = sum(c.replays for c in calls_)
    # the sharded graph renderer's pool: what it keeps reserved with the
    # other renderers gone, against the same with it gone too
    del rs["eager sharded"], rs["graph unsharded"], calls_, r
    gc.collect()
    torch.cuda.empty_cache()
    pool = torch.cuda.memory_reserved(dev) / mib
    del rs
    gc.collect()
    torch.cuda.empty_cache()
    pool -= torch.cuda.memory_reserved(dev) / mib
    row = dict(
        equal=all(equal), renders=len(equal) + 1, walls=walls,
        first_graph_render=first, second_graph_render=second,
        capture_s=capture, replays=replays, collectives=collectives,
        kernel_runs=runs, trace_calls=calls,
        peak_mib=dict(eager=ref_peak - held, graph_first=cap_peak),
        pool_mib=pool,
        host_launches_per_pass={k: p.host_launches / max(p.passes, 1)
                                for k, p in prof.items()},
        busy={k: p.device_ms / (1e3 * p.wall) for k, p in prof.items()},
        device_ms={k: p.device_ms for k, p in prof.items()},
        seconds=time.perf_counter() - t_case)
    print(f"[smoke] sharded graphs, {name} on a world of 1 over nccl: graph "
          f"sharded = eager sharded = graph unsharded bit for bit "
          f"{row['equal']} ({row['renders']} renders); walls in turns "
          + "; ".join(f"{k} {_spread(v)}" for k, v in walls.items())
          + "; host launches a pass " + ", ".join(
              f"{k} {v:.1f}" for k, v in
              row["host_launches_per_pass"].items())
          + "; busy " + ", ".join(f"{k} {v:.1%}" for k, v in
                                  row["busy"].items())
          + f"; capture of both halves {capture:.4f} s, {replays} replays; "
          f"{collectives['calls']} collectives, {collectives['bytes']} bytes "
          f"a steady render; peak above the case's start eager "
          f"{ref_peak - held:.1f} MiB; sharded graph pool {pool:.1f} MiB "
          f"reserved; case {row['seconds']:.1f} s ({card})")
    if not row["equal"]:
        raise AssertionError(f"sharded graphs, {name}: the renders differ")
    return row


def forward_case_check(name, row, card):
    """Print one per-trace forward case of `scaling_bench.forward_case`
    (phases 4j and 4n) and return what failed: not compiled, not equal
    to eager or to unsharded, a count off, or ten host launches or more
    in a replayed forward."""
    w, coll = row["walls"], row["collectives"]
    hl = row["host_launches"]
    print(f"[smoke] per-trace forward est_radiance(mesh=), {name}: "
          f"{row['size']}² {'curved' if row['curved'] else 'flat'} over "
          f"{row['backend']}, compiled {row['compiled']}: equal to eager "
          f"{row['equal_eager']}, to unsharded {row['equal_unsharded']} "
          f"({row['calls']} calls, radiance and counters); walls in turns "
          f"graph {_spread(w['graph'])}, eager {_spread(w['eager'])}, "
          f"unsharded graph {_spread(w['unsharded'])}; host launches a "
          f"forward graph {hl['graph']}, eager {hl['eager']}, unsharded "
          f"graph {hl['unsharded']}; {coll['calls']} collectives, "
          f"{coll['bytes']} bytes a forward (a replay adds "
          f"{row['graph_collectives']}); capture {row['capture_s']:.3f} s; "
          f"graph pool {row['pool_mib']:.1f} MiB"
          + (f" ({card})" if card else ""))
    bad = list(row["faults"])
    if not (row["compiled"] and row["equal_eager"]
            and row["equal_unsharded"]):
        bad.append(f"compiled {row['compiled']}, equal to eager "
                   f"{row['equal_eager']}, to unsharded "
                   f"{row['equal_unsharded']}")
    if row["graph_collectives"] != coll:
        bad.append(f"the graph holds {row['graph_collectives']} "
                   f"collectives, the eager forward makes {coll}")
    if hl["graph"] is None or hl["graph"] >= 10:
        bad.append(f"{hl['graph']} host launches in a replayed forward")
    return bad


def sharded_phase(dev, card, tmp, size=256, spp=16, n_rays=65536,
                  kerr_size=64, kerr_steps=300, forward_size=1024):
    """4j: the lane-sharded main path at full width on a world of 1 over
    NCCL, compiled: `Renderer(sharding=)` with graphs (the rank half and
    the accumulate half of each pass captured, the gather between them)
    against the eager sharded and the unsharded graph renders, bit for
    bit, on the primary (256×256, 16 spp, -l 4, -m 5), a tail pass and an
    adaptive render (`sharded_render_case`); `trace(mesh=)` on 65,536
    seeded rays compiled (its gather and all-reduce inside the graph; one
    kernel run a call) and `occluded(mesh=)`, equal to the unsharded
    queries; the per-trace forward `est_radiance(mesh=)` at 1024², flat
    and curved, compiled as one graph with its collectives inside, against
    itself eager and the unsharded graph (`scaling_bench.forward_case`,
    `forward_case_check`); phase 4b's
    gradient step through `LossAndGrad(mesh=)` compiled (half A and half
    B around the all-reduce) against eager bit for bit (`grad_step_case`),
    and the eager sharded step against the unsharded one (rtol 1e-4 on the
    material leaves, 5e-3 on the hole's); `kerr_cli --sharded` at 64×64,
    300 steps (the block's march in captured blocks) against the sharded
    march step by step and the unsharded CLI, bit for bit."""
    import torch
    import torch.distributed as dist
    from rrt_tpu_torch import kerr_cli
    from rrt_tpu_torch.geometry import trace as tracer
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.parallel import distributed as pdist
    from rrt_tpu_torch.parallel import sharding as sh
    from rrt_tpu_torch.parallel import worker
    from rrt_tpu_torch.render import diff
    from rrt_tpu_torch.render import kerr_scene as K
    from rrt_tpu_torch.render.renderer import make_black_hole
    from rrt_tpu_torch.scene.build import load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES
    from rrt_tpu_torch.tools import inverse, scaling_bench
    from rrt_tpu_torch.tools.scaling_bench import free_port
    from rrt_tpu_torch.tools.trace_modes import BOX, box_rays
    from rrt_tpu_torch.utils import prng
    from rrt_tpu_torch.utils.config import RenderConfig
    from rrt_tpu_torch.utils.graphs import CapturedCall
    out = {}
    pdist.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        mesh = sh.make_mesh(dev)
        sharding = sh.batch_sharding(mesh)
        cfg = RenderConfig(width=size, height=size, ns_aa=spp,
                           ns_area_light=4, max_ray_depth=5)
        scene, cam = load_scene(CBOX_SPHERES, dev, size, size)
        cases = {
            f"primary {size}x{size} {spp}spp -l 4 -m 5, one pass": cfg,
            "tail pass: 10 spp at k=4": cfg.replace(
                ns_aa=10, max_pass_lanes=4 * size * size),
            "adaptive -a, batch 4 at k=2": cfg.replace(
                adaptive=True, samples_per_batch=4,
                max_pass_lanes=2 * size * size),
        }
        out["renders"] = {
            name: sharded_render_case(dev, card, name, scene, cam, c,
                                      sharding)
            for name, c in cases.items()}
        primary = next(iter(out["renders"].values()))
        out["launches"] = primary["kernel_runs"]
        out["trace_calls"] = primary["trace_calls"]

        rays = box_rays(n_rays, 11, dev, *BOX)
        bh = make_black_hole(cfg, dev)
        tab = tk.build_tables(scene, bh)
        for occ in (False, True):
            h, st = tracer.trace(scene, bh, rays, return_stats=True,
                                 occlusion=occ, tables=tab)
            # compiled, its gather and all-reduce inside the graph: eager,
            # captured and replayed, then replayed; the kernel's own count
            # of its runs on each call
            call = CapturedCall(lambda: tracer.trace(
                scene, bh, rays, return_stats=True, occlusion=occ,
                tables=tab, mesh=mesh), dev, name="trace(mesh=)")
            for i in range(3):
                tk.reset_counts()
                hm, stm = call()
                if tk.kernel_runs() != 1 or tk.LAUNCHES != (i == 0):
                    raise AssertionError(
                        f"trace(mesh=) call {i}: {tk.kernel_runs()} kernel "
                        f"runs, {tk.LAUNCHES} eager launches")
                same = all(torch.equal(getattr(hm, f), getattr(h, f))
                           for f in ("hit", "t", "p", "n", "w_out",
                                     "prim_id", "bsdf_id"))
                if not (same and torch.equal(stm, st)):
                    raise AssertionError(f"trace(mesh=, occlusion={occ}) "
                                         f"call {i} differs")
        o = tracer.occluded(scene, bh, rays, tables=tab)
        if not torch.equal(tracer.occluded(scene, bh, rays, tables=tab,
                                           mesh=mesh), o):
            raise AssertionError("occluded(mesh=) differs")
        print(f"[smoke] trace(mesh=) on {n_rays} seeded rays, compiled "
              f"(eager, captured, replayed; one kernel run a call), and "
              f"occluded(mesh=): equal to the unsharded queries, counters "
              f"too")

        # the per-trace forward est_radiance(mesh=) at 1024², flat and
        # curved: one graph with its collectives inside
        out["forwards"] = {}
        for kind in ("flat", "curved"):
            row = scaling_bench.forward_case(mesh, forward_size,
                                             kind == "curved")
            bad = forward_case_check(f"{kind}, a world of 1", row, card)
            if bad:
                raise AssertionError(f"per-trace forward {kind}: "
                                     + "; ".join(bad))
            out["forwards"][kind] = row
            torch.cuda.empty_cache()

        dcfg = cfg.replace(ns_aa=1)
        dbh = make_black_hole(dcfg, dev)
        drays = inverse.pixel_rays(cam, size, size, dev)
        params = diff.params_from_scene(scene, dbh)
        target = torch.zeros_like(drays.o)
        row, (loss, g), _ = grad_step_case(
            dev, card, f"sharded diff step {size}x{size} 1spp -l 4 -m 5 "
            f"on a world of 1 over nccl",
            (params, scene, dbh, drays, dcfg, target, 0), reps=3, mesh=mesh)
        out["grad"] = row
        out["grad_launches"] = row["replay_kernel_runs"]
        t0 = time.perf_counter()
        uloss, ug = diff.loss_and_grad(
            params, scene, dbh, drays, target, dcfg, prng.key(0, dev))
        torch.cuda.synchronize(dev)
        out["unsharded_grad_s"] = time.perf_counter() - t0
        names = [f.name for f in dataclasses.fields(diff.SceneParams)]
        worst = {}
        for name, a, b in zip(names, g.leaves(), ug.leaves()):
            rtol = 5e-3 if name.startswith("bh_") else 1e-4
            if not torch.allclose(a, b, rtol=rtol, atol=1e-7):
                raise AssertionError(f"sharded gradient of {name} differs")
            worst[name] = float((a - b).abs().max())
        print(f"[smoke] sharded diff step: loss {loss.item():.6g} "
              f"(unsharded {uloss.item():.6g}), every leaf within its rtol "
              f"of the unsharded step's, max abs differences {worst}; the "
              f"unsharded eager step {out['unsharded_grad_s']:.4f} s "
              f"({card})")

        k_args = ["-r", str(kerr_size), str(kerr_size), "--steps",
                  str(kerr_steps), "--device", "cuda"]
        t0 = time.perf_counter()
        img_s = kerr_cli.main(["-f", os.path.join(tmp, "ks.png"),
                               "--sharded"] + k_args)
        ks_wall = time.perf_counter() - t0
        kbh, disk, kw, _ = worker.kerr_args(dev, os.path.join(tmp, "k.png"))
        kw.update(width=kerr_size, height=kerr_size, n_steps=kerr_steps)
        t0 = time.perf_counter()
        img_e = K.render_image(bh=kbh, disk=disk, sharding=sharding,
                               graphs=False, **kw)
        ke_wall = time.perf_counter() - t0
        img_u = kerr_cli.main(["-f", os.path.join(tmp, "ku.png")] + k_args)
        if not (np.array_equal(img_s, img_e) and np.array_equal(img_s,
                                                                img_u)):
            raise AssertionError("kerr_cli --sharded differs from the "
                                 "sharded march step by step or the "
                                 "unsharded CLI")
        out["kerr_sharded_s"] = ks_wall
        out["kerr_sharded_step_by_step_s"] = ke_wall
        print(f"[smoke] kerr_cli --sharded {kerr_size}x{kerr_size} "
              f"{kerr_steps} steps in captured blocks (capture included): "
              f"{ks_wall:.2f} s, equal bit for bit to the sharded march "
              f"step by step ({ke_wall:.2f} s) and to the unsharded CLI "
              f"({card})")
    finally:
        pdist.shutdown()
    return out


def two_process_phase(dev, card, tmp, size="255x255"):
    """4k: two ranks of `rrt_tpu_torch.parallel.worker` on the one card
    over gloo (NCCL refuses two ranks on one card), on a ragged frame,
    with CUDA graphs around the collectives (the default on a card): both
    exit 0, their forward blocks tile the frame and equal this process's
    whole-frame forward rows (checked in each rank), and their sharded
    render's accumulators equal this process's single-process render bit
    for bit, with the kernel's runs equal to the trace calls in each rank;
    the `step` check's `LossAndGrad(mesh=)` (eager, captured and
    replayed, replayed) equals each rank's `loss_and_grad(mesh=)` at every
    call and, at its last, the two ranks' shares summed in this process,
    bit for bit."""
    from rrt_tpu_torch.parallel import worker
    from rrt_tpu_torch.tools.scaling_bench import spawn_workers
    w, h = worker.frame_size(size)
    checks = ["render", "step"]
    t0 = time.perf_counter()
    res, logs = spawn_workers(2, size, tmp, device="cuda", backend="gloo",
                              checks=",".join(checks), timeout=600)
    wall = time.perf_counter() - t0
    ref = worker.reference(checks, w, h, dev, os.path.join(tmp, "r.png"))
    bounds = [(int(r["lo"]), int(r["hi"])) for r in res]
    if bounds[0][0] != 0 or bounds[0][1] != bounds[1][0] \
            or bounds[1][1] != w * h:
        raise AssertionError(f"blocks {bounds} do not tile {w * h} lanes")
    leaves = ["loss"] + list(worker._LEAVES)
    for rank, r in enumerate(res):
        for key in ("rad_sum", "s1", "s2", "count", "done"):
            if not np.array_equal(r[f"render_{key}"], ref[f"render_{key}"]):
                raise AssertionError(f"rank {rank}: render {key} differs")
        if not bool(r["render_graphs"]) or int(r["render_kernel_runs"]) \
                != int(r["render_calls"]) or int(r["render_calls"]) == 0:
            raise AssertionError(f"rank {rank}: graphs "
                                 f"{bool(r['render_graphs'])}, "
                                 f"{r['render_kernel_runs']} kernel runs for "
                                 f"{r['render_calls']} calls")
        if not (bool(r["step_graphs"]) and all(r["step_equal"])
                and int(r["step_replays"]) == worker.STEP_CALLS - 1
                and list(r["step_kernel_runs"]) == list(r["step_calls"])):
            raise AssertionError(f"rank {rank}: step equal "
                                 f"{list(r['step_equal'])}, replays "
                                 f"{r['step_replays']}, kernel runs "
                                 f"{list(r['step_kernel_runs'])} for calls "
                                 f"{list(r['step_calls'])}")
        for key in leaves:
            if not np.array_equal(r[f"step_{key}"], ref[f"step_{key}"]):
                raise AssertionError(f"rank {rank}: step {key} differs from "
                                     f"the two shares summed")
    for log in logs:
        print(f"[smoke] rank: {log.strip().splitlines()[-1]}")
    out = dict(wall=wall, blocks=bounds,
               dt=[float(r["dt"]) for r in res],
               render_dt=[float(r["render_dt"]) for r in res],
               launches=[int(r["render_kernel_runs"]) for r in res],
               python_launches=[int(r["render_launches"]) for r in res],
               step_kernel_runs=[[int(c) for c in r["step_kernel_runs"]]
                                 for r in res],
               max_err=[float(r["max_err"]) for r in res])
    print(f"[smoke] two ranks on one card over gloo with graphs, {w}x{h} "
          f"({w * h} lanes): blocks {bounds}, forward dt {out['dt']} s, "
          f"sharded render {out['render_dt']} s (kernel runs "
          f"{out['launches']} = trace calls, {out['python_launches']} of "
          f"them eager), accumulators equal to the single-process render; "
          f"the compiled sharded step equal to the eager one at each of "
          f"{worker.STEP_CALLS} calls (kernel runs {out['step_kernel_runs']} "
          f"= trace calls) and to the two shares summed here, bit for bit; "
          f"{wall:.1f} s with the processes' start ({card})")
    return out


def tools_phase(dev, card):
    """4l: `scaling_bench --card` (the sharding layer's cost: sharded and
    unsharded forwards of 65,536 lanes in turns, both compiled, equal
    results),
    `run_config` for configs 1-3 (a finite image with mean > 0, launches
    equal to trace calls) and `kbench 20` on cbox_dense and the Cornell
    box (launches equal to trace calls)."""
    from rrt_tpu_torch.scenes import CBOX_SPHERES
    from rrt_tpu_torch.tools import kbench, run_config, scaling_bench
    gap = scaling_bench.card_gap(256)
    print(f"[smoke] scaling_bench --card: {json.dumps(gap)}")
    if not (gap["equal"] and all(gap["compiled"].values())):
        raise AssertionError(f"scaling_bench --card: sharded != unsharded "
                             f"or not compiled {gap['compiled']}")
    configs = {}
    for i in sorted(run_config.CONFIGS):
        res, hdr, report = run_config.run(run_config.CONFIGS[i]
                                          + ["--device", "cuda"])
        print(f"[smoke] run_config {i}: {json.dumps(res)} ({card})")
        print(f"[smoke] run_config {i}: {report.replace(chr(10), ' | ')}")
        if not (np.isfinite(hdr).all() and res["mean_radiance"] > 0):
            raise AssertionError(f"run_config {i}: image not finite or dark")
        if res["launches"] != res["trace_calls"] or res["launches"] == 0:
            raise AssertionError(f"run_config {i}: {res['launches']} "
                                 f"launches for {res['trace_calls']} calls")
        configs[i] = res
    kb = {}
    for scene in ("cbox_dense", CBOX_SPHERES):
        head, rows = kbench.run(20, "kernel", scene=scene, device=dev)
        name = os.path.basename(scene)
        print(f"[smoke] kbench 20: {head}")
        for r in rows:
            print(f"[smoke] kbench {name} {json.dumps(r)} ({card})")
            if r["launches"] != r["trace_calls"]:
                raise AssertionError(f"kbench {name}: {r['launches']} "
                                     f"launches for {r['trace_calls']}")
        kb[name] = rows
    return dict(card_gap=gap, configs=configs, kbench=kb)


def _nccl_transports(logs):
    """The transports NCCL reported under NCCL_DEBUG=INFO in the ranks'
    logs (`... via P2P/CUMEM`, `via SHM`, `NET/...`), and its version."""
    import re
    via, version = set(), set()
    for log in logs:
        for line in log.splitlines():
            if "NCCL INFO" not in line:
                continue
            m = re.search(r" via (\S+)", line)
            if m:
                via.add(m.group(1))
            m = re.search(r"NCCL version (\S+)", line)
            if m:
                version.add(m.group(1))
    return sorted(via), sorted(version)


def check_world(world, res, ref):
    """Phase 4n's checks of one world's ranks (`res`, their npz dicts)
    against the one-card reference (`worker.full_reference`): returns
    (the world's row of numbers, the list of what failed)."""
    from rrt_tpu_torch.parallel import worker
    names = ("loss",) + worker._LEAVES
    bad, worst = [], 0.0
    for rank, r in enumerate(res):
        if not bool(r["build_cached"]):
            bad.append(f"rank {rank} built a kernel")
        for case in worker.FULL_CASES:
            same = all(np.array_equal(r[f"{case}_{k}"], ref[f"{case}_{k}"])
                       for k in worker._ACC)
            calls = list(r[f"{case}_calls"])
            runs = list(r[f"{case}_kernel_runs"])
            launches = list(r[f"{case}_launches"])
            if not (same and bool(r[f"{case}_same"])):
                bad.append(f"rank {rank}: {case} differs from the "
                           f"one-card render")
            if not bool(r[f"{case}_graphs"]):
                bad.append(f"rank {rank}: {case} ran without graphs")
            if runs != calls or min(calls) == 0 or any(launches[1:]):
                bad.append(f"rank {rank}: {case} kernel runs {runs} for "
                           f"calls {calls}, Python launches {launches}")
            if int(r[f"{case}_samples"]) != int(ref[f"{case}_samples"]):
                bad.append(f"rank {rank}: {case} ended at "
                           f"{int(r[f'{case}_samples'])} samples")
        if not bool(r["primary_unsharded_same"]):
            bad.append(f"rank {rank}: its own card's unsharded render "
                       f"differs")
        step = [r[f"step_{k}"] for k in names]
        if not (bool(r["step_graphs"]) and all(r["step_equal"])
                and list(r["step_kernel_runs"]) == list(r["step_calls"])
                and list(r["step_launches"][1:]) == [0, 0]):
            bad.append(f"rank {rank}: step equal {list(r['step_equal'])}"
                       f", kernel runs {list(r['step_kernel_runs'])} for "
                       f"calls {list(r['step_calls'])}, launches "
                       f"{list(r['step_launches'])}")
        shares = ref[f"shares_{world}"]
        off = {k: worker.off_bound(a, [s[i] for s in shares])
               for i, (k, a) in enumerate(zip(names, step))}
        worst = max(worst, *off.values())
        if max(off.values()) > 1.0 or (world == 2 and max(off.values())):
            bad.append(f"rank {rank}: step off its shares' sum "
                       f"(in bounds) {off}")
        for k, a, b in zip(names, step, ref["unsharded_step"]):
            rtol = 5e-3 if k.startswith("bh_") else 1e-4
            if not np.allclose(a, b, rtol=rtol, atol=1e-7):
                bad.append(f"rank {rank}: step {k} off the unsharded "
                           f"step")
        if any(not np.array_equal(r[f"step_{k}"], res[0][f"step_{k}"])
               for k in names):
            bad.append(f"rank {rank}: step differs from rank 0's")
        if not (np.array_equal(r["kerr"], ref["kerr"])
                and bool(r["kerr_same"])):
            bad.append(f"rank {rank}: Kerr differs from the one-card "
                       f"frame")
        for kind in ("flat", "curved"):
            case = json.loads(str(r[f"mesh_trace_{kind}"]))
            bad += [f"rank {rank}: per-trace forward {kind}: {b}" for b in
                    forward_case_check(f"{kind}, rank {rank} of {world}",
                                       case, "")]
    med = lambda a: float(np.median(a))
    cases = {k: [json.loads(str(r[f"mesh_trace_{k}"])) for r in res]
             for k in ("flat", "curved")}
    row = dict(
        build_cached=[bool(r["build_cached"]) for r in res],
        primary_s=[med(r["primary_walls"]) for r in res],
        primary_walls=[list(map(float, r["primary_walls"])) for r in res],
        one_card_s=[med(r["primary_unsharded_walls"]) for r in res],
        host_launches=[int(r["primary_host_launches"]) for r in res],
        passes=int(res[0]["primary_passes"]),
        collectives=int(res[0]["primary_collectives"]),
        collective_bytes=int(res[0]["primary_collective_bytes"]),
        busy=[float(r["primary_busy"]) for r in res],
        device_ms=[float(r["primary_device_ms"]) for r in res],
        nccl_ms=[float(r["primary_nccl_ms"]) for r in res],
        busy_without_nccl=[
            (float(r["primary_device_ms"]) - float(r["primary_nccl_ms"]))
            / (1e3 * float(r["primary_profiled_s"])) for r in res],
        capture_s=[float(r["primary_capture_s"]) for r in res],
        kernel_runs=[int(r["primary_kernel_runs"][-1]) for r in res],
        step_eager_s=[float(r["step_walls"][0]) for r in res],
        step_s=[med(r["step_replay_walls"]) for r in res],
        step_capture_s=[float(r["step_capture_s"]) for r in res],
        step_off_bound=worst,
        kerr_s=[list(map(float, r["kerr_walls"])) for r in res],
        kerr_one_card_s=[list(map(float, r["kerr_unsharded_walls"]))
                         for r in res],
        forward_s=[float(r["dt"]) for r in res],
        per_trace_s={k: [med(c["walls"]["graph"]) for c in v]
                     for k, v in cases.items()},
        per_trace_eager_s={k: [med(c["walls"]["eager"]) for c in v]
                           for k, v in cases.items()},
        per_trace_unsharded_s={k: [med(c["walls"]["unsharded"]) for c in v]
                               for k, v in cases.items()},
        per_trace_host_launches={k: [c["host_launches"] for c in v]
                                 for k, v in cases.items()},
        per_trace_collectives={k: v[0]["collectives"]
                               for k, v in cases.items()})
    return row, bad


def multicard_phase(tmp):
    """4n: the lane-sharded user paths at full width on several cards, one
    rank of `rrt_tpu_torch.parallel.worker` a card in one NCCL group, with
    CUDA graphs around every collective, on 2 cards, then 3, up to all of
    them or 4. The one-card
    reference runs here on card 0 before any rank starts
    (`worker.full_reference`), and the kernels are built here first, so
    that no rank compiles. Each rank (`worker.CARD_CHECKS`):
      - the primary render (256², 16 spp, -l 4, -m 5), a tail pass (10
        spp, k = 4), adaptive (k = 2) and a stop on the last rank alone,
        each three renders, equal to the one-card unsharded render bit for
        bit, kernel runs equal to trace calls, no Python launch once the
        passes replay; the primary's walls in turns with the unsharded
        render on the rank's own card, host launches, busy share,
        collectives and bytes of a steady render;
      - phase 4b's 256² step through `LossAndGrad(mesh=)`, three calls
        (eager, captured, replayed), each equal to the rank's eager
        `loss_and_grad(mesh=)` bit for bit; the last within the order-free
        bound of the ranks' shares summed here (`worker.off_bound`; bit for
        bit on 2 ranks) and within rtol 1e-4 (material leaves) and 5e-3
        (the hole's) of the unsharded step;
      - Kerr config 5 (1024², 600 steps) equal to the one-card frame bit
        for bit;
      - the per-trace `mesh=` forward at 1024², flat and curved, one
        graph with its collectives inside, equal to itself eager and to
        the unsharded forward (`scaling_bench.forward_case`).
    Then `scaling_bench --size 1024` (1, 2 and 4 ranks) and its
    `--breakdown` under the largest group, every forward compiled. On one
    card it prints that it did not run and returns None."""
    import subprocess
    import torch
    from rrt_tpu_torch.ops import build
    from rrt_tpu_torch.parallel import worker
    from rrt_tpu_torch.tools.scaling_bench import (free_port, run_ranks,
                                                   spawn_workers)
    from rrt_tpu_torch.utils.card import card_lines, topology
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[smoke] phase 4n: not run: {n_cards} card, needs 2 or more")
        return None
    top = min(n_cards, 4)
    worlds = list(range(2, top + 1))
    cards = card_lines()
    for i, line in enumerate(cards):
        print(f"[smoke] card {i}: {line}")
    topo = topology()
    print("[smoke] nvidia-smi topo -m:\n" + topo)
    t_phase = time.perf_counter()
    build.build_all()
    dev0 = torch.device("cuda", 0)
    t0 = time.perf_counter()
    ref = worker.full_reference(dev0, worlds)
    ref_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"[smoke] 4n: the one-card reference on card 0 in {ref_s:.1f} s "
          f"({cards[0]})")
    out = dict(cards=cards, topology=topo, reference_s=ref_s, worlds={})
    for world in worlds:
        t0 = time.perf_counter()
        res, logs = spawn_workers(
            world, str(worker.FULL_SIZE), tmp, device="cuda",
            backend="nccl", checks=",".join(worker.CARD_CHECKS),
            timeout=420, env=dict(NCCL_DEBUG="INFO"))
        wall = time.perf_counter() - t0
        via, version = _nccl_transports(logs)
        transport = ", ".join(via) or "no transport reported"
        row, bad = check_world(world, res, ref)
        row.update(ranks=world, seconds=wall, nccl=via, nccl_version=version)
        slow = max(row["primary_s"])
        one = float(np.median(row["one_card_s"]))
        row.update(slowest_s=slow, ratio=one / slow,
                   lanes_per_s=worker.FULL_SIZE ** 2 * 16 / slow)
        out["worlds"][world] = row
        print(f"[smoke] 4n world {world} over nccl ({transport}; NCCL "
              f"{', '.join(version)}): primary "
              f"256² 16 spp sharded, slowest rank's median "
              f"{slow:.4f} s against the one-card graph render's {one:.4f} s "
              f"in turns ({row['ratio']:.2f}×, {row['lanes_per_s']:,.0f} "
              f"lanes/s); host launches a render {row['host_launches']}; "
              f"{row['collectives']} collectives, {row['collective_bytes']} "
              f"bytes a render of {row['passes']} pass(es) on rank 0; busy "
              f"{[round(b, 3) for b in row['busy']]} (NCCL's kernels "
              f"{[round(b, 1) for b in row['nccl_ms']]} ms of it; without "
              f"them {[round(b, 3) for b in row['busy_without_nccl']]}); "
              f"pass captures "
              f"{[round(c, 3) for c in row['capture_s']]} s; step "
              f"{[round(s, 4) for s in row['step_s']]} s replayed, eager "
              f"{[round(s, 3) for s in row['step_eager_s']]} s, capture "
              f"{[round(s, 2) for s in row['step_capture_s']]} s, at most "
              f"{row['step_off_bound']:.3g} bounds off the shares' sum; Kerr "
              f"config 5 sharded {row['kerr_s']} s, on one card "
              f"{row['kerr_one_card_s']} s in turns (each frame captures its "
              f"blocks); forward {[round(f, 5) for f in row['forward_s']]} "
              f"s; per-trace forward at {worker.MESH_TRACE_SIZE}² "
              f"(graph, slowest rank's median) "
              + ", ".join(f"{k} {max(v):.4f} s (eager "
                          f"{max(row['per_trace_eager_s'][k]):.4f} s, "
                          f"unsharded graph "
                          f"{max(row['per_trace_unsharded_s'][k]):.4f} s)"
                          for k, v in row["per_trace_s"].items())
              + f"; kernels "
              f"built before the ranks {row['build_cached']}; "
              f"{wall:.1f} s with the processes' start ({cards[0]} × "
              f"{world})")
        if bad:
            raise AssertionError(f"4n world {world}: " + "; ".join(bad))
        print(f"[smoke] 4n world {world}: primary, tail, adaptive and stop "
              f"renders equal to the one-card render bit for bit on every "
              f"rank; the step equal to eager at every call and within the "
              f"shares' bound; Kerr config 5 equal; the per-trace "
              f"forward, compiled, equal to eager and to unsharded")

    configs = ",".join(f"{w}x1" for w in [1] + worlds)
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    sb = subprocess.run(
        [sys.executable, "-m", "rrt_tpu_torch.tools.scaling_bench",
         "--configs", configs, "--size", "1024"], env=env,
        capture_output=True, text=True, timeout=600)
    print(f"[smoke] scaling_bench --configs {configs} --size 1024 "
          f"({time.perf_counter() - t0:.1f} s):")
    for line in sb.stdout.strip().splitlines():
        print(f"[smoke]   {line}")
    if sb.returncode != 0:
        raise AssertionError(f"scaling_bench failed ({sb.returncode}):\n"
                             f"{sb.stderr[-3000:]}")
    out["scaling_bench"] = sb.stdout
    world, port = worlds[-1], free_port()
    logs = run_ranks(
        [[sys.executable, "-m", "rrt_tpu_torch.tools.scaling_bench",
          "--breakdown", "--size", "1024"]] * world,
        [os.path.join(tmp, f"breakdown{i}.log") for i in range(world)],
        [dict(env, RRT_COORDINATOR=f"127.0.0.1:{port}",
              RRT_NUM_PROCESSES=str(world), RRT_PROCESS_ID=str(i))
         for i in range(world)], timeout=300)
    rows = [json.loads([line for line in log.splitlines()
                        if line.startswith("{")][-1]) for log in logs]
    for row in rows:
        print(f"[smoke] scaling_bench --breakdown --size 1024, world "
              f"{world}: {json.dumps(row)} ({cards[0]})")
        keys = ("flat_sharded_ms", "flat_device0_ms", "flat_collectives",
                "flat_block_sharded_ms", "curved_nosort_ms")
        if not (all(row.get(k) for k in keys)
                and all(row["compiled"].values())):
            raise AssertionError(f"scaling_bench --breakdown: a key missing "
                                 f"or a forward not compiled: {row}")
    out["breakdown"] = rows
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[smoke] phase 4n: {out['seconds']:.1f} s")
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="smoke test of the port on "
                                 "one CUDA card")
    ap.add_argument("--old", metavar="PATH",
                    help="an earlier trace_kernel.cu (PR 2's C interface) "
                    "to time in turns with this one")
    ap.add_argument("--old-envmap", metavar="PATH",
                    help="an earlier scene/envmap.py whose sample_L is "
                    "checked equal to this one's and timed with it in turns")
    ap.add_argument("--phase", choices=("4n",),
                    help="run phases 1-2 and this phase alone (4n: the "
                    "sharded paths on 2 and up to 4 cards)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from rrt_tpu_torch import bench, cli
    from rrt_tpu_torch.geometry import trace as tracer
    from rrt_tpu_torch.io.exr import write_exr
    from rrt_tpu_torch.ops import build, probe as tprobe, threefry
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.render import diff
    from rrt_tpu_torch.render.renderer import Renderer, make_black_hole
    from rrt_tpu_torch.scene import envmap
    from rrt_tpu_torch.scene.build import build_scene, load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES, cbox_dense, uv_sphere_box
    from rrt_tpu_torch.tools import inverse, r5prim
    from rrt_tpu_torch.tools.trace_modes import (
        BOX, HBM_BYTES_PER_S, box_rays, compile_trace, finish_build,
        flat_args, in_turns, load_variant, main_path_batches, old_trace_fn,
        ptxas_report, render_launches, start_variants, timed, trace_work,
        using, work_line)
    from rrt_tpu_torch.utils import prng
    from rrt_tpu_torch.utils.card import (card_line, fp32_peak_flops,
                                          max_sm_clock_mhz)
    from rrt_tpu_torch.utils.config import BlackHoleConfig, Illum, RenderConfig
    from rrt_tpu_torch.types import BlackHoleParams
    from rrt_tpu_torch.utils.profile import profile_call, profile_render

    # ---- 1. the card
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(card)
    print(f"[smoke] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} × {torch.cuda.device_count()}")

    # ---- 2. build every library, one nvcc each, all at once (and the
    # earlier trace kernel with --old, beside them)
    t0 = time.perf_counter()
    old_build = compile_trace(args.old, "old") if args.old else None
    old_envmap_path = args.old_envmap
    started = start_variants(("per-lane", "cooperative"))
    for family in build.FAMILIES:   # a clean build, with ptxas's report
        build.library_path(family).unlink(missing_ok=True)
    paths = build.build_all()
    for family, path in paths.items():
        build.load_library(family)
        log = build.BUILD_LOG[family]
        print(f"[smoke] built {os.path.relpath(path, ROOT)} in "
              f"{log['seconds']:.1f} s" + (" (cached)" if log["cached"]
                                           else ""))
        for line in log["output"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[smoke] ptxas {family}: {line.strip()}")
    builds = {"default": tk._trace_fn()}
    for name, proc in started.items():
        builds[name] = load_variant(proc)[0]
        print(f"[smoke] built the trace kernel with its traversal fixed "
              f"{name}")
    old_trace = None
    if old_build is not None:
        finish_build(old_build[0])
        old_trace = old_trace_fn(old_build[1])
        print(f"[smoke] built the --old trace kernel {args.old}")
    print(f"[smoke] all libraries in {time.perf_counter() - t0:.1f} s")
    ptx = ptxas_report(build.BUILD_LOG["trace"]["output"])
    curved_ptx = [v for k, v in ptx.items() if "trace_kernelILb1E" in k]
    if not curved_ptx:
        raise AssertionError("ptxas reported no curved trace kernel")
    registers = max(v[0] for v in curved_ptx)
    spill_bytes = max(v[1] for v in curved_ptx)
    print(f"[smoke] trace kernel, curved instances: at most {registers} "
          f"registers, {spill_bytes} spill bytes, "
          f"{max(v[2] for v in curved_ptx)} stack bytes")
    if args.phase == "4n":
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
            multi = multicard_phase(tmp)
        print("[smoke] phase 4n: " + json.dumps(multi))
        if multi is None:
            raise SystemExit("chip_smoke --phase 4n: needs 2 or more cards")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    peak = fp32_peak_flops(dev, max_sm_clock_mhz())

    # ---- 3a. kernel vs plain version, seeded rays, three scenes
    mp = main_path_batches(dev)
    cfg, bh, cbox, cam = mp["cfg"], mp["bh"], mp["scene"], mp["cam"]
    parts, _ = build_scene(uv_sphere_box(), dev)
    dense, dense_cam = build_scene(cbox_dense(), dev, 128, 128)
    bh_parts = make_black_hole(cfg.replace(black_hole=BlackHoleConfig(
        position=(-0.45, -0.35, 0.4), radius=0.08, delta_theta=0.1)), dev)
    errs = []
    times, work, turns = {}, {}, {}
    for scene_name, scene, hole, lo, hi in (
            ("cbox", cbox, bh, *BOX),
            ("parts", parts, bh_parts, (-0.9,) * 3, (0.9,) * 3),
            ("dense", dense, bh, *BOX)):
        flat_tab = tk.build_tables(scene, None)
        print(f"[smoke] {scene_name}: {scene.n_tris} tri rows, "
              f"{flat_tab.n_parts} parts, clusters of {flat_tab.cs_k}")
        if scene_name == "dense" and not (flat_tab.cs_k == 8
                                          and flat_tab.n_parts >= 14):
            raise AssertionError("cbox_dense is not a BVH-scale scene")
        args = flat_args(box_rays(N_CHECK, 7, dev, lo, hi))
        for mode, tab_hole, occ in (("flat", None, False),
                                    ("curved", hole, False),
                                    ("any-hit", hole, True)):
            tab = tk.build_tables(scene, tab_hole)
            if scene_name == "cbox" and mode == "flat":
                ms, k = timed(lambda: tk.trace_rays(tab, *args, occ), 10)
                plain_ms, r = timed(
                    lambda: tk.trace_rays_reference(tab, *args, occ), 1)
                times["flat"] = (ms, plain_ms)
                work["flat"] = trace_work(tab, args, occ, k, peak)
                print(f"[smoke] {N_CHECK}-lane cbox flat closest-hit trace: "
                      f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
                      f"{work_line(work['flat'])}, {tk.LAST_LAUNCH} ({card})")
            elif scene_name == "dense" and mode == "curved":
                ms, k = timed(lambda: tk.trace_rays(tab, *args, occ), 10)
                launch = dict(tk.LAST_LAUNCH)
                plain_ms, r = timed(
                    lambda: tk.trace_rays_reference(tab, *args, occ), 1)
                times["dense"] = (ms, plain_ms)
                work["dense"] = trace_work(tab, args, occ, k, peak)
                print(f"[smoke] {N_CHECK}-lane dense curved closest-hit "
                      f"trace: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
                      f"{work_line(work['dense'])}, {launch} ({card})")
                if old_trace is not None:
                    turns["dense"] = in_turns({
                        "old": lambda: old_trace(tab, *args, occ),
                        "new": lambda: tk.trace_rays(tab, *args, occ)}, 10)
                    print(f"[smoke] dense closest-hit in turns: "
                          f"{turns['dense']} ms ({card})")
            else:
                k = tk.trace_rays(tab, *args, occ)
                r = tk.trace_rays_reference(tab, *args, occ)
            errs.append(check(f"{scene_name} {mode}", k, r, args[0],
                              args[1], hole, tab.n_seg))
        del args, k, r

    # ---- 3b. kernel vs plain version at the main path's sizes: the first
    # pass's camera rays, and the first vertex's NEE shadow queries built
    # from their hits by the integrator's own functions
    tab = mp["tab"]
    n_px = cfg.width * cfg.height
    for name, args, occ in (("closest-hit", mp.pop("camera"), False),
                            ("any-hit", mp.pop("shadow"), True)):
        ms, k = timed(lambda: tk.trace_rays(tab, *args, occ), 10)
        launch = dict(tk.LAST_LAUNCH)
        plain_ms, r = timed(lambda: plain(tab, *args, occ), 1)
        errs.append(check(f"main-path {name}", k, r, args[0], args[1], bh,
                          tab.n_seg))
        times[name] = (ms, plain_ms)
        work[name] = trace_work(tab, args, occ, k, peak)
        print(f"[smoke] {args[0].shape[0]}-lane curved {name} trace: "
              f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"{work_line(work[name])}, {launch} ({card})")
        if old_trace is not None:
            turns[name] = in_turns({
                "old": lambda: old_trace(tab, *args, occ),
                "new": lambda: tk.trace_rays(tab, *args, occ)}, 10)
            print(f"[smoke] {name} in turns: {turns[name]} ms ({card})")
    del k, r, args

    # ---- 3c. the trace kernel's own cases, each flat, curved and any-hit,
    # in the default build and with the traversal fixed either way
    big, _ = build_scene(cbox_dense(200, 200), dev, 128, 128)
    box = BOX

    def one_point(rays):
        return rays.replace(o=torch.broadcast_to(rays.o[:1],
                                                 rays.o.shape).contiguous())
    for (mode, occ), bname in itertools.product(
            (("flat", False), ("curved", False), ("any-hit", True)), builds):
        curved = mode != "flat"
        ctab = tk.build_tables(cbox, bh if curved else None)
        with using(builds[bname]):
            tk.trace_rays(ctab, *flat_args(box_rays(64, 1, dev, *box)), occ)
        resident = tk.LAST_LAUNCH["grid"] * tk.LAST_LAUNCH["threads"]
        cases = [(f"{n} lanes{where}", ctab, f(box_rays(n, n, dev, *box)), bh)
                 for n in (1, 31, 33, resident + 1)
                 for where, f in (("", lambda r: r),
                                  (" from one point", one_point))]
        masked_rays = box_rays(N_CHECK, 11, dev, *box)
        masked = torch.tensor(np.random.default_rng(12).random(N_CHECK) < 0.5,
                              device=dev)
        masked_rays.o[masked] = bh.position.to(torch.float32)
        cases.append(("half the lanes at the hole's centre", ctab,
                      masked_rays, bh))
        btab = tk.build_tables(big, bh if curved else None)
        cases.append(("box tables in device memory", btab,
                      box_rays(16384, 13, dev, *box), bh))
        ptab = tk.build_tables(parts, bh_parts if curved else None)
        ra = box_rays(20000, 21, dev, (-0.9,) * 3, (0.9,) * 3)
        rb = box_rays(30000, 22, dev, (-0.9,) * 3, (0.9,) * 3)
        with using(builds[bname]):
            runs = []
            for name, ctab_, rays, hole in cases:
                a = flat_args(rays)
                runs.append((name, ctab_, a, hole,
                             tk.trace_rays(ctab_, *a, occ)))
                placed = tk.LAST_LAUNCH["tables_in"]
                want = "device" if ctab_ is btab else "shared"
                if placed != want:
                    raise AssertionError(f"{name}: tables in {placed} memory")
            a, b = flat_args(ra), flat_args(rb)
            ka, kb = tk.trace_rays(ptab, *a, occ), tk.trace_rays(ptab, *b, occ)
        runs += [("back to back, first", ptab, a, bh_parts, ka),
                 ("back to back, second", ptab, b, bh_parts, kb)]
        for name, ctab_, a, hole, k in runs:
            errs.append(check(f"case {mode}, {bname} build, {name}", k,
                              tk.trace_rays_reference(ctab_, *a, occ), a[0],
                              a[1], hole, ctab_.n_seg))
    del big, btab, masked_rays, runs

    # ---- 3c'. the toolchain probe kernel against its plain version: host
    # time per call and device time per launch of both
    x = torch.tensor(np.random.default_rng(3).normal(size=tprobe.SHAPE),
                     dtype=torch.float32, device=dev)
    probe_ms, k = timed(lambda: tprobe.probe_kernel(x), 100)
    probe_plain_ms, r = timed(lambda: tprobe.probe_reference(x), 100)
    probe_err = (k - r).abs().max().item()
    if not torch.equal(k, r):
        raise AssertionError(f"probe kernel differs from x * 2 by {probe_err}")
    probe_host = {"kernel": [], "x * 2": []}
    for name in ("kernel", "x * 2", "x * 2", "kernel") * 2:
        fn = tprobe.probe_kernel if name == "kernel" else tprobe.probe_reference
        probe_host[name].append(host_us_per_call(lambda: fn(x), 5000))
    # where the wrapper's host time goes: the output's allocation, and the
    # bare ctypes call that launches the kernel
    fn, _ = tprobe._probe_fn()
    out_, idx = torch.empty_like(x), x.get_device()
    probe_parts = {
        "empty_like": host_us_per_call(lambda: torch.empty_like(x), 5000),
        "ctypes launch": host_us_per_call(lambda: fn(
            x.data_ptr(), out_.data_ptr(), idx,
            torch._C._cuda_getCurrentRawStream(idx)), 5000)}
    probe_dev = {"kernel": device_us_per_launch(
        lambda: tprobe.probe_kernel(x), 100, "probe_kernel"),
        "x * 2": device_us_per_launch(lambda: tprobe.probe_reference(x),
                                      100, "")}
    probe_bound_ms = 1e3 * 2 * x.numel() * 4 / HBM_BYTES_PER_S
    print(f"[smoke] probe kernel: equal to x * 2, kernel {probe_ms:.4f} ms, "
          f"plain {probe_plain_ms:.4f} ms by events over 100 calls; host "
          f"us per call (in turns) kernel {probe_host['kernel']} x * 2 "
          f"{probe_host['x * 2']}; device us per launch kernel "
          f"{probe_dev['kernel']:.3f} x * 2 {probe_dev['x * 2']:.3f}; the "
          f"wrapper's parts, host us per call: {probe_parts}; bound "
          f"{probe_bound_ms * 1e3:.4f} us (bytes) ({card})")

    # ---- 3d. the eight cost probes against their plain versions
    probe_errs = {}
    x = torch.tensor(np.random.default_rng(4).uniform(0.5, 2.0, r5prim.SHAPE),
                     dtype=torch.float32, device=dev)
    for prim in r5prim.PROBES:
        for n_iter in (1, 64):
            k, place = r5prim.probe_kernel(prim, x, n_iter, return_place=True)
            r = r5prim.probe_reference(prim, x, n_iter)
            if prim in ("fori_chain", "when_rt"):
                if not torch.equal(k, r):
                    raise AssertionError(f"r5prim {prim} n_iter={n_iter}: "
                                         "kernel differs from plain")
            else:
                torch.testing.assert_close(k, r, rtol=1e-6, atol=0,
                                           msg=f"r5prim {prim} {n_iter}")
            err = (k - r).abs().max().item()
            probe_errs[prim] = max(probe_errs.get(prim, 0.0), err)
        print(f"[smoke] r5prim {prim}: kernel = plain at n_iter 1 and 64, "
              f"max abs err {probe_errs[prim]:.3g}"
              + (f", table in {place} memory" if prim == "dynread7" else ""))

    # ---- 3e. the threefry kernel against its plain version at the main
    # path's shapes, bit for bit, timed beside torch.rand
    draws = threefry_phase(dev, card, peak)

    # ---- 4. the main path, every trace and every draw counted at its
    # kernel, and the uniforms it draws tallied
    drawn = []
    real_uniform = threefry.uniform

    def tallied(*a, **kw):
        out = real_uniform(*a, **kw)
        drawn.append(out.numel())
        return out
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tk.reset_counts()
        threefry.reset_counts()
        threefry.uniform = tallied
        t0 = time.perf_counter()
        try:
            renderer = cli.main(["-f", os.path.join(tmp, "cbox.png"), "-r",
                                 "256", "256", "-s", "16", "-l", "4", "-m",
                                 "5", "--device", "cuda", CBOX_SPHERES])
            torch.cuda.synchronize()
        finally:
            threefry.uniform = real_uniform
        wall = time.perf_counter() - t0
        launches = tk.LAUNCHES
        rng_launches = dict(uniform=threefry.LAUNCHES,
                            keys=threefry.KEY_LAUNCHES,
                            runs=threefry.kernel_runs())
        if not os.path.getsize(os.path.join(tmp, "cbox.png")):
            raise AssertionError("main path wrote an empty PNG")
    # one eager pass: every draw and key went through the kernel, and the
    # draws are the JAX package's: per lane 2 jitter uniforms, 2 for each
    # of 4 light samples at each of 5 vertices, 5 for the BSDF at 4
    # vertices, 1 roulette coin at 3
    lanes = 256 * 256 * 16
    if not (rng_launches["uniform"] == len(drawn) > 0
            and rng_launches["keys"] > 0 and rng_launches["runs"]
            == rng_launches["uniform"] + rng_launches["keys"]):
        raise AssertionError(f"threefry on the main path: {rng_launches}, "
                             f"{len(drawn)} draws")
    if sum(drawn) != lanes * (2 + 5 * 4 * 2 + 4 * 5 + 3):
        raise AssertionError(f"the main path drew {sum(drawn)} uniforms, "
                             f"not {lanes * 65}")
    print(f"[smoke] main path draws: {sum(drawn)} uniforms in "
          f"{rng_launches['uniform']} uniform launches and "
          f"{rng_launches['keys']} key launches of the threefry kernel, "
          f"{rng_launches['runs']} runs (one pass)")
    # the render's one pass runs eagerly (a shape is captured at its
    # second pass): the wrapper's launches, the kernel's own runs and the
    # trace calls agree
    if not launches == tk.kernel_runs() == renderer.last_trace_calls > 0:
        raise AssertionError(f"{launches} kernel launches, "
                             f"{tk.kernel_runs()} kernel runs for "
                             f"{renderer.last_trace_calls} trace calls")
    rad_sum, _, _, count, _ = renderer.last_accumulators
    hdr = rad_sum / np.maximum(count[:, None], 1)
    if hdr.shape != (n_px, 3) or not np.isfinite(hdr).all():
        raise AssertionError("main path image is not finite")
    mean_rad = float(hdr.mean())
    if not mean_rad > 0.0:
        raise AssertionError(f"main path mean radiance {mean_rad}")
    st = renderer.stats(wall)
    print(f"[smoke] main path 256x256 16spp -l 4 -m 5: wall {wall:.2f} s, "
          f"{n_px * 16 / wall:.0f} camera rays/s, "
          f"{st.total_rays / wall:.0f} marched rays/s, "
          f"{st.isect_tests_per_ray:.1f} prim tests/ray, "
          f"{st.measured_bbox_tests / st.total_rays:.1f} bbox tests/ray, "
          f"mean radiance {mean_rad:.5f}, {launches} kernel launches "
          f"({card})")
    main_launch = dict(tk.LAST_LAUNCH)
    prof = profile_render(renderer, reps=5)
    for line in prof.report().splitlines():
        print(f"[smoke] profile: {line}")
    # each trace launch of a further render: its time (CUDA events around
    # it) beside its work; with --old, both kernels' renders in turns. An
    # eager renderer: a replayed pass calls no Python launcher to time
    eager = Renderer(renderer.scene, renderer.camera, renderer.cfg, dev,
                     graphs=False)
    eager.render()                       # warm, as the profile above was
    _, render_rows = render_launches(eager, peak)
    for i, w in enumerate(render_rows):
        print(f"[smoke] render launch {i + 1}: "
              f"{'any-hit' if w['anyhit'] else 'closest-hit'}, {w['lanes']} "
              f"lanes, {w['ms']:.3f} ms, {work_line(w)} ({card})")
    if len(render_rows) != launches:
        raise AssertionError(f"{len(render_rows)} trace launches in a render, "
                             f"not {launches}")
    render_turns = {}
    if old_trace is not None:
        render_turns = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            wall_, rows_ = render_launches(
                eager, peak, old_trace if name == "old" else None,
                work=False)
            render_turns[name].append(dict(
                wall=wall_, launches=[r_["ms"] for r_ in rows_]))
        print(f"[smoke] render trace launches in turns (ms): "
              f"{json.dumps(render_turns)} ({card})")

    # a first profile of the BVH-scale render (the bench's secondary cell)
    bcfg = RenderConfig(width=128, height=128, ns_aa=1, ns_area_light=1,
                        max_ray_depth=2)
    brend = Renderer(dense, dense_cam, bcfg, dev)
    bprof = profile_render(brend, reps=3)
    for line in bprof.report().splitlines():
        print(f"[smoke] bvh profile: {line}")
    beager = Renderer(dense, dense_cam, bcfg, dev, graphs=False)
    beager.render()
    for i, w in enumerate(render_launches(beager, peak)[1]):
        print(f"[smoke] bvh render launch {i + 1}: "
              f"{'any-hit' if w['anyhit'] else 'closest-hit'}, {w['lanes']} "
              f"lanes, {w['ms']:.3f} ms, {work_line(w)} ({card})")

    # a small curved normal-shaded render: the card against the CPU
    small = RenderConfig(width=32, height=32, ns_aa=1, illum=Illum.NORMAL)
    imgs = []
    for d in (dev, torch.device("cpu")):
        sc, cm = load_scene(CBOX_SPHERES, d, 32, 32)
        imgs.append(Renderer(sc, cm, small, d).render()[0])
    close = np.isclose(imgs[0], imgs[1], atol=1e-4).all(-1).mean()
    print(f"[smoke] 32x32 normal shading, card vs CPU: {close:.4f} of "
          f"pixels within 1e-4")
    if close < 0.995:
        raise AssertionError("card and CPU renders disagree")
    # global illumination: the card draws the CPU's uniforms
    card_cpu = card_vs_cpu_phase(dev, card)

    # ---- 4b. the differentiable path at full width: one image_loss
    # gradient step of the main path's render at 1 spp, eager and compiled
    # (`diff.LossAndGrad`: a CUDA graph captured at its second call)
    dcfg = RenderConfig(width=256, height=256, ns_aa=1, ns_area_light=4,
                        max_ray_depth=5)
    dscene, dcam = load_scene(CBOX_SPHERES, dev, 256, 256)
    dbh = make_black_hole(dcfg, dev)
    drays = inverse.pixel_rays(dcam, 256, 256, dev)
    dparams = diff.params_from_scene(dscene, dbh)
    dtarget = torch.zeros_like(drays.o)
    names = [f.name for f in dataclasses.fields(diff.SceneParams)]
    grad_rows = {}
    grad_rows["diff step"], (dloss, dgrads), dprof = grad_step_case(
        dev, card, "diff step 256x256 1spp -l 4 -m 5 curved GI",
        (dparams, dscene, dbh, drays, dcfg, dtarget, 0),
        ranges=("trace_diff.replay",))
    diff_launches = grad_rows["diff step"]["trace_calls"]
    for name, g in zip(names, dgrads.leaves()):
        if not torch.isfinite(g).all():
            raise AssertionError(f"diff step: {name} gradient not finite")
    g_r = dgrads.bh_radius
    if not g_r.item() != 0.0:
        raise AssertionError(f"diff step: bh_radius gradient {g_r}")
    # what one replayed trace of the camera's 65,536 lanes keeps for its
    # backward pass: the allocation its live output holds
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (dbh.position, dbh.radius, dbh.delta_theta)]
    torch.cuda.synchronize(dev)
    mem1 = torch.cuda.memory_allocated(dev)
    hd = tracer.trace_diff(dscene, BlackHoleParams(*leaves), drays,
                           tables=tk.build_tables(dscene, dbh))
    torch.cuda.synchronize(dev)
    replay_mib = (torch.cuda.memory_allocated(dev) - mem1) / 2 ** 20
    del hd, leaves
    # the hole's row as the step writes it on the card, against the row
    # `build_tables` computes on the host (cos and sin of Δθ may differ
    # by an ulp; the step's eager and compiled runs read the same one)
    row_card = tk.hole_row(dbh, dev).cpu()
    row_host = tk.build_tables(dscene, dbh).params[:tk.P_GLO].cpu()
    print(f"[smoke] diff step 256x256 1spp -l 4 -m 5 curved GI: loss "
          f"{dloss.item():.6g}, d/d radius {g_r.item():.6g}, every "
          f"gradient finite; one replayed trace of 65536 lanes keeps "
          f"{replay_mib:.1f} MiB; the hole's row on the card equals the "
          f"host's {torch.equal(row_card, row_host)} (max abs difference "
          f"{float((row_card - row_host).abs().max()):.3g}) ({card})")
    print(f"[smoke] diff step profile (eager): {dprof.report()} ({card})")

    # ---- 4c. BASELINE config 4's closed loops on the card, through the
    # compiled step and eagerly: the same end values; then one step of
    # each, eager and compiled, in turns
    ends = {}
    for graphs in (True, False):
        tk.reset_counts()
        track = []
        radius, radius_true, radius_ms = inverse.recover_radius(
            dev, graphs=graphs,
            record=lambda loss, p: track.append(float(p.bh_radius)))
        radius_launches = (tk.LAUNCHES, tk.kernel_runs())
        tk.reset_counts()
        albedo, albedo_true, albedo_ms = inverse.recover_albedo(
            dev, graphs=graphs)
        albedo_launches = (tk.LAUNCHES, tk.kernel_runs())
        albedo_err = float(np.abs(albedo - albedo_true).max())
        how = "compiled" if graphs else "eager"
        ends[how] = (radius, albedo)
        print(f"[smoke] config 4 radius loop, {how} (seed "
              f"{inverse.RADIUS_SEED}): {inverse.RADIUS_STEPS} steps "
              f"from {inverse.RADIUS_START} end at {radius:.5f} (true "
              f"{radius_true:.5f}), {radius_ms:.2f} ms per step, "
              f"{radius_launches[1]} kernel runs, {radius_launches[0]} "
              f"through the Python launcher; within 0.015 of the truth: "
              f"{abs(radius - radius_true) < 0.015} (ROADMAP Queue 3: "
              f"the JAX package's loop recovers at this key, the port's "
              f"does not); radius after each step "
              f"{[round(r, 5) for r in track]} ({card})")
        print(f"[smoke] config 4 albedo loop, {how}: red wall "
              f"{albedo.tolist()} (true {albedo_true.tolist()}), max err "
              f"{albedo_err:.4f}, {albedo_ms:.2f} ms per step, "
              f"{albedo_launches[1]} kernel runs, {albedo_launches[0]} "
              f"through the Python launcher ({card})")
        if min(radius_launches[1], albedo_launches[1]) == 0:
            raise AssertionError("config 4's loops launched no kernel")
        # the first step goes from the start toward the truth, and the
        # loop stays finite inside its clip
        lo_clip, hi_clip = inverse.RADIUS_CLIP
        if not (radius_true < track[0] < inverse.RADIUS_START
                and all(lo_clip <= r <= hi_clip for r in track)):
            raise AssertionError(f"config 4 radius loop {track} ({how})")
        if not albedo_err < 0.08:
            raise AssertionError(f"config 4 albedo error {albedo_err} "
                                 f"({how})")
    if not (ends["compiled"][0] == ends["eager"][0]
            and np.array_equal(ends["compiled"][1], ends["eager"][1])):
        raise AssertionError(f"config 4's loops end at {ends['compiled']} "
                             f"compiled and {ends['eager']} eager")
    print(f"[smoke] config 4's loops: compiled and eager end values equal "
          f"bit for bit ({card})")
    t0 = time.perf_counter()
    step = inverse.radius_step_parity(dev, "cpu")
    rel = [abs(a / b - 1) for a, b in (step["loss"], step["grad"])]
    print(f"[smoke] config 4 radius loop's first step, card vs CPU lane by "
          f"lane: lanes parted {step['parted']}, undecided at float32 "
          f"{step['undecided']} (rays {step['ray_diff']:.3g} apart), "
          f"{step['kept_close']:.4f} of the others within rtol 1e-2; with "
          f"the parted lanes left out, loss {step['loss'][0]:.7g} / "
          f"{step['loss'][1]:.7g} ({rel[0]:.2e} apart), d/d radius "
          f"{step['grad'][0]:.7g} / {step['grad'][1]:.7g} ({rel[1]:.2e} "
          f"apart); {time.perf_counter() - t0:.1f} s ({card})")
    if not (all(step["undecided"]) and len(step["parted"]) <= 4
            and step["kept_close"] >= 0.99 and rel[0] <= 1e-3
            and rel[1] <= 5e-3):
        raise AssertionError(f"config 4 radius step, card vs CPU: {step}")
    radius_launches = radius_launches[0]
    albedo_launches = albedo_launches[0]
    rparams, rscene, rbh, rrays, rcfg = inverse.radius_setup(dev)
    rseed = inverse.RADIUS_SEED
    with torch.no_grad():
        rtarget = diff.render_radiance(
            rparams, rscene, rbh, rrays, rcfg, prng.key(rseed, dev))
    grad_rows["radius step"], _, _ = grad_step_case(
        dev, card, "config 4 radius step 32x32 -l 1 -m 2 curved GI",
        (rparams.replace(bh_radius=torch.full_like(
            rparams.bh_radius, inverse.RADIUS_START)), rscene, rbh, rrays,
         rcfg, rtarget, rseed))
    aparams, ascene, arays, acfg, arow = inverse.albedo_setup(dev)
    with torch.no_grad():
        atarget = diff.render_radiance(
            aparams, ascene, None, arays, acfg, prng.key(inverse.SEED, dev))
    astart = aparams.reflectance.clone()
    astart[arow] = torch.tensor(inverse.ALBEDO_START, device=dev)
    grad_rows["albedo step"], _, _ = grad_step_case(
        dev, card, "config 4 albedo step 48x48 -l 1 -m 1 flat direct",
        (aparams.replace(reflectance=astart), ascene, None, arays, acfg,
         atarget, inverse.SEED))
    print(f"[smoke] gradient steps: {json.dumps(grad_rows)}")

    # ---- 4d. trace_diff against the kernel's primal: 400 seeded camera
    # rays, curved (the JAX package's rule, tests/test_diff.py:113-127)
    cscene, ccam = load_scene(CBOX_SPHERES, dev, 64, 64, fov_mode="native")
    xy = torch.tensor(np.random.default_rng(0).uniform(0.2, 0.8, (400, 2)),
                      dtype=torch.float32, device=dev)
    crays = ccam.generate_rays(xy)
    ctab = tk.build_tables(cscene, bh)
    hdiff = tracer.trace_diff(cscene, bh, crays, tables=ctab)
    hprim = tracer.trace(cscene, bh, crays, tables=ctab)
    if not (torch.equal(hdiff.hit, hprim.hit)
            and torch.equal(hdiff.prim_id, hprim.prim_id)):
        raise AssertionError("trace_diff's hits or prims differ from the "
                             "kernel's")
    m = hprim.hit
    diff_close = ((hdiff.p[m] - hprim.p[m]).abs().amax(-1) < 1e-4
                  ).float().mean().item()
    print(f"[smoke] trace_diff vs the kernel's primal: 400 rays, "
          f"{int(m.sum())} hits, equal hits and prims, {diff_close:.4f} of "
          f"hit points within 1e-4")
    if not diff_close >= 0.995:
        raise AssertionError(f"trace_diff hit points agree on {diff_close}")

    # ---- 4e. the env-lit main path through the CLI
    rng = np.random.default_rng(21)
    eh, ew = 1024, 2048
    theta = (np.arange(eh) + 0.5) / eh * np.pi
    phi = (np.arange(ew) + 0.5) / ew * 2 * np.pi
    sky = (0.2 + 0.8 * np.cos(theta / 2) ** 2)[:, None, None] \
        * np.array([0.4, 0.6, 1.0]) * (1 + 0.05 * rng.random((eh, ew, 1)))
    sun = ((theta[:, None] - 0.6) ** 2 + (phi[None, :] - 2.0) ** 2) < 0.03 ** 2
    sky[sun] = (2e3, 1.8e3, 1.4e3)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        write_exr(os.path.join(tmp, "sky.exr"), sky.astype(np.float32))
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            tk.LAUNCHES = 0
            t0 = time.perf_counter()
            erend = cli.main(["-f", "env.png", "-r", "256", "256", "-s", "16",
                              "-l", "4", "-m", "5", "-e", "sky.exr",
                              "--device", "cuda", CBOX_SPHERES])
            torch.cuda.synchronize()
            env_wall = time.perf_counter() - t0
            env_launches = tk.LAUNCHES
            if not (os.path.getsize("env.png")
                    and os.path.getsize("probability_debug.png")):
                raise AssertionError("-e wrote an empty PNG")
        finally:
            os.chdir(cwd)
    if env_launches != erend.last_trace_calls or env_launches == 0:
        raise AssertionError(f"{env_launches} kernel launches for "
                             f"{erend.last_trace_calls} env trace calls")
    rad_sum, _, _, count, _ = erend.last_accumulators
    ehdr = rad_sum / np.maximum(count[:, None], 1)
    env_mean = float(ehdr.mean())
    if not np.isfinite(ehdr).all() or not env_mean > mean_rad:
        raise AssertionError(f"env-lit mean radiance {env_mean}, without "
                             f"-e {mean_rad}")
    # the ranges' split needs eager passes: a replayed pass runs no Python,
    # so its record_function ranges hold no ops
    eager_env = Renderer(erend.scene, erend.camera, erend.cfg, dev,
                         graphs=False)
    eager_env.render()
    eprof = profile_call(eager_env.render,
                         ranges=("envmap.sample_L", "envmap.sample_dir"),
                         device=dev)
    del eager_env
    print(f"[smoke] env-lit main path 256x256 16spp -l 4 -m 5 -e "
          f"{eh}x{ew}: wall {env_wall:.2f} s, mean radiance {env_mean:.5f} "
          f"(without -e {mean_rad:.5f}), {env_launches} kernel launches = "
          f"trace calls ({card})")
    print(f"[smoke] env render profile (eager passes): {eprof.report()} "
          f"({card})")
    # sample_L alone on the lanes of one NEE sample of the main path
    # (256x256 at 16 spp); with --old-envmap, an earlier sample_L in turns
    xi = prng.uniform(prng.key(3, dev), (1 << 20, 2))
    env = erend.scene.env
    sl_times = {"new": []}
    sl_fns = {"new": lambda: envmap.sample_L(env, xi)}
    if old_envmap_path:
        import importlib.util
        spec = importlib.util.spec_from_file_location("old_envmap",
                                                      old_envmap_path)
        old_envmap = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(old_envmap)
        for got, want in zip(old_envmap.sample_L(env, xi), sl_fns["new"]()):
            if not torch.equal(got, want):
                raise AssertionError("sample_L differs from --old-envmap's")
        sl_fns["old"] = lambda: old_envmap.sample_L(env, xi)
        sl_times["old"] = []
    for name in (["old", "new", "new", "old"] if old_envmap_path
                 else ["new"]):
        sl_times[name].append(event_ms(sl_fns[name], 5))
    print("[smoke] sample_L alone, 1048576 lanes, 1024x2048 map: " + "; ".join(
        f"{name} " + ", ".join(f"{t:.3f}" for t in ts) + " ms"
        for name, ts in sl_times.items()) + f" ({card})")

    # ---- 4f-4i. the render lifecycle, --serve, the dumps and Kerr
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        life = lifecycle_phase(dev, card, tmp)
        served = serve_phase(dev, card, tmp)
        dumps = dumps_phase(dev, card, tmp)
    kerr_out = kerr_phase(dev, card)

    # ---- 4j-4l. the lane-sharded path, two ranks on the card, the tools
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        sharded = sharded_phase(dev, card, tmp)
        two = two_process_phase(dev, card, tmp)
    tools_out = tools_phase(dev, card)

    # ---- 4m. captured passes and march blocks against the eager path
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        graphs_out = graphs_phase(dev, card, tmp)

    # ---- 4n. the sharded paths on several cards over NCCL
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        multi = multicard_phase(tmp)

    # ---- 5. the bench, in-process: the probe kernel and the trace kernel
    tk.reset_counts()
    tprobe.LAUNCHES = 0
    bench_out, diag, bench_calls = bench.run(dev)
    # the trace kernel's runs, replays included
    bench_launches = {"trace_kernel": tk.kernel_runs(),
                      "probe": tprobe.LAUNCHES}
    if bench_launches["trace_kernel"] != bench_calls:
        raise AssertionError(f"bench: {bench_launches['trace_kernel']} "
                             f"trace kernel runs for {bench_calls} calls")
    print(f"[smoke] bench {diag}")
    print(f"[smoke] bench json: {json.dumps(bench_out)}")
    if min(bench_launches.values()) == 0:
        raise AssertionError(f"bench launches {bench_launches}")
    for key in ("value", "bvh_camera_rays_per_sec", "mfu_lower_bound_pct",
                "mean_radiance", "bvh_prim_tests_per_ray"):
        if not (np.isfinite(bench_out[key]) and bench_out[key] > 0):
            raise AssertionError(f"bench {key} = {bench_out[key]}")

    # ---- 6. the cost-probe tool's path: every probe timed
    r5prim.LAUNCHES = dict.fromkeys(r5prim.PROBES, 0)
    clock = max_sm_clock_mhz()
    rows = r5prim.measure(dev, clock)
    r5_launches = dict(r5prim.LAUNCHES)
    for row in rows:
        print(f"[smoke] r5prim {r5prim.format_row(row, card, clock)}")
    if min(r5_launches.values()) == 0:
        raise AssertionError(f"r5prim tool launches {r5_launches}")

    print(f"[smoke] phases 4f-4i: " + json.dumps(dict(
        lifecycle=life, serve=served, dumps=dumps, kerr=kerr_out)))
    print(f"[smoke] phases 4j-4l: " + json.dumps(dict(
        sharded=sharded, two_ranks=two, tools=tools_out)))
    print(f"[smoke] phase 4m: " + json.dumps(graphs_out))
    if multi is not None:
        print(f"[smoke] phase 4n: " + json.dumps(multi))

    # ---- 7. result lines
    ms, plain_ms = times["closest-hit"]
    # the cost probes' one launch each at N_PLAIN iterations: operations
    # per lane and iteration from the source, 4 KiB in and out per launch
    r5_ops = float(sum(r5prim.OPS_PER_ITER[row["probe"]] for row in rows)
                   * r5prim.N_PLAIN * np.prod(r5prim.SHAPE))
    r5_t = (r5_ops / peak, 8192 * len(rows) / HBM_BYTES_PER_S)
    print(json.dumps(finite({"kernels": [{
        "name": "trace_kernel",
        "route": "cuda",
        "source": "rrt_tpu_torch/ops/csrc/trace_kernel.cu",
        "replaces": "rrt_tpu/ops/trace_kernel.py:1639",
        "launches": launches,
        "bench_launches": bench_launches["trace_kernel"],
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": work["closest-hit"]["bound_ms"],
        "bound_by": work["closest-hit"]["bound_by"],
        "library_ms": None,
        "grid": main_launch["grid"],
        "threads": main_launch["threads"],
        "blocks_per_sm": main_launch["blocks_per_sm"],
        "tables_in": main_launch["tables_in"],
        "traversal": main_launch["traversal"],
        "triangles_in": main_launch["triangles_in"],
        "registers": registers,
        "spill_bytes": spill_bytes,
        "anyhit_ms": times["any-hit"][0],
        "anyhit_plain_ms": times["any-hit"][1],
        "anyhit_bound_ms": work["any-hit"]["bound_ms"],
        "dense_ms": times["dense"][0],
        "dense_plain_ms": times["dense"][1],
        "dense_bound_ms": work["dense"]["bound_ms"],
        "flat_ms": times["flat"][0],
        "flat_plain_ms": times["flat"][1],
        "flat_bound_ms": work["flat"]["bound_ms"],
        "render_launch_ms": [w["ms"] for w in render_rows],
        "render_launch_bound_ms": [w["bound_ms"] for w in render_rows],
        "old_vs_new_ms": turns or None,
        "diff_launches": diff_launches,
        "grad_step_replay_runs": {k: r_["replay_kernel_runs"]
                                  for k, r_ in grad_rows.items()},
        "env_launches": env_launches,
        "config4_launches": radius_launches + albedo_launches,
        "lifecycle_launches": life["launches"],
        "dump_launches": dumps["launches"],
        "dump_rays_launches": [r_["launches"] for r_ in dumps["rows"]],
        "sharded_launches": sharded["launches"],
        "sharded_grad_launches": sharded["grad_launches"],
        "two_rank_launches": two["launches"],
        "multicard_launches": None if multi is None else {
            w: r_["kernel_runs"] for w, r_ in multi["worlds"].items()},
        "run_config_launches": {i: c["launches"] for i, c in
                                tools_out["configs"].items()},
        "kbench_launches": {name: [r_["launches"] for r_ in rows_]
                            for name, rows_ in tools_out["kbench"].items()},
    }, {
        "name": "probe",
        "route": "cuda",
        "source": "rrt_tpu_torch/ops/csrc/probe.cu",
        "replaces": "bench.py:49",
        "launches": bench_launches["probe"],
        "max_abs_err": probe_err,
        "ms": probe_ms,
        "plain_ms": probe_plain_ms,
        "bound_ms": probe_bound_ms,
        "bound_by": "bytes",
        "library_ms": probe_plain_ms,
        "host_us": probe_host["kernel"],
        "library_host_us": probe_host["x * 2"],
        "device_us": probe_dev["kernel"],
        "library_device_us": probe_dev["x * 2"],
        "host_parts_us": probe_parts,
    }, {
        "name": "r5prim",
        "route": "cuda",
        "source": "rrt_tpu_torch/ops/csrc/r5prim.cu",
        "replaces": "tools/r5prim.py:27",
        "launches": sum(r5_launches.values()),
        "max_abs_err": max(probe_errs.values()),
        "ms": sum(row["kernel_ms"] for row in rows),
        "plain_ms": sum(row["plain_ms"] for row in rows),
        "bound_ms": 1e3 * max(r5_t),
        "bound_by": "operations" if r5_t[0] >= r5_t[1] else "bytes",
        "library_ms": None,
        "n_iter": r5prim.N_PLAIN,
        "probes": {row["probe"]: {
            "launches": r5_launches[row["probe"]],
            "max_abs_err": probe_errs[row["probe"]],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "ns_per_iter": row["ns_per_iter"],
            "cycles_per_iter": row["cycles_per_iter"],
            "plain_ns_per_iter": row["plain_ns_per_iter"]}
            for row in rows},
    }, {
        "name": "threefry_uniform",
        "route": "cuda",
        "source": "rrt_tpu_torch/ops/csrc/threefry.cu",
        "replaces": "rrt_tpu/render/integrator.py:194",
        "replaces_note": "jax.random.uniform, XLA's threefry2x32: no "
                         "Pallas kernel",
        "launches": rng_launches["uniform"],
        "main_path_uniforms": sum(drawn),
        "max_abs_err": draws["max_abs_err"],
        **{k: v for k, v in draws["rows"]["light samples"].items()
           if k != "uniforms"},
        "shape": [4, 1 << 20, 2],
        "shapes": {k: v for k, v in draws["rows"].items() if k != "keys"},
        "card_vs_cpu": card_cpu,
    }, {
        "name": "threefry_keys",
        "route": "cuda",
        "source": "rrt_tpu_torch/ops/csrc/threefry.cu",
        "replaces": "rrt_tpu/render/integrator.py:277",
        "replaces_note": "jax.random.split and fold_in, XLA's "
                         "threefry2x32: no Pallas kernel",
        "launches": rng_launches["keys"],
        **draws["rows"]["keys"],
        "library_ms": None,
    }]})))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
