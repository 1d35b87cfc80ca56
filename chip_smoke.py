#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rrt_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases:

1. the card: fail without CUDA; print its name and power limit;
2. build every kernel library from the sources in the checkout (trace,
   probe, r5prim), one nvcc each, all started together, and print
   ptxas's registers and spills;
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
4. the main path through the CLI: 256×256, 16 spp, -l 4, -m 5, curved
   global illumination on cuda, with every trace counted at the kernel;
   then a profile of the same render (warm walls, peak memory, device
   time by kernel, and each trace launch's time beside its live-lane
   share, chords and tests per lane and bound; with `--old`, the render's
   ten launches of both kernels in turns); a first profile of the
   BVH-scale render; a small normal-shaded render on the card checked
   against the CPU;
4b. the differentiable path at full width: one `image_loss` gradient
   step of the main path's render (256×256, 1 spp, -l 4, -m 5, curved
   GI): trace launches equal to its trace calls, every leaf's gradient
   finite and the radius's nonzero; warm walls, peak memory, the memory
   one replayed trace of 65,536 lanes saves, and the device time split
   into the trace kernel, the replay's ops (forward and backward) and the
   rest;
4c. BASELINE config 4's closed loops (`rrt_tpu_torch.tools.inverse`,
   rays framed on the box): the radius must come within 0.015 of the
   truth (at the card's `RADIUS_SEED`: on the in-repo box the loss moves
   mostly through discrete events, and the loop recovers at some seeds
   only, in the JAX package too; see that module), the red wall's albedo
   within 0.08;
4d. `trace_diff` against the kernel's primal: 400 seeded camera rays,
   curved; equal hits and prims, >= 99.5% of hit points within 1e-4;
4e. the env-lit main path through the CLI: a seeded 1024×2048 sky with a
   sun disk written as EXR, `-e` at the main path's settings in a
   temporary directory: launches equal to trace calls, a finite image
   brighter than the same render without `-e`, probability_debug.png
   written there; its wall and a profile of `sample_L` and `sample_dir`;
5. the bench (`rrt_tpu_torch.bench`, in-process): probe, build, the
   primary and the BVH-scale cell; its JSON line is printed;
6. the cost-probe tool's path (`rrt_tpu_torch.tools.r5prim`): every probe
   timed at two iteration counts, beside its plain version;
7. a JSON line of the kernels, then the ok line.

Each of the paths (4, 4b, 4c, 4e, 5, 6) is driven with the kernels'
launch counts set to 0 just before it and read just after: every kernel
of the path must have launched in it.

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
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA
          and match in ev.name]
    return sum(us) / len(us) if us else float("nan")


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
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from rrt_tpu_torch import bench, cli
    from rrt_tpu_torch.geometry import trace as tracer
    from rrt_tpu_torch.io.exr import write_exr
    from rrt_tpu_torch.ops import build, probe as tprobe, trace_kernel as tk
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

    # ---- 4. the main path
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tk.LAUNCHES = 0
        t0 = time.perf_counter()
        renderer = cli.main(["-f", os.path.join(tmp, "cbox.png"), "-r", "256",
                             "256", "-s", "16", "-l", "4", "-m", "5",
                             "--device", "cuda", CBOX_SPHERES])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tk.LAUNCHES
        if not os.path.getsize(os.path.join(tmp, "cbox.png")):
            raise AssertionError("main path wrote an empty PNG")
    if launches != renderer.last_trace_calls or launches == 0:
        raise AssertionError(f"{launches} kernel launches for "
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
    # it) beside its work; with --old, both kernels' renders in turns
    _, render_rows = render_launches(renderer, peak)
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
                renderer, peak, old_trace if name == "old" else None,
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
    for i, w in enumerate(render_launches(brend, peak)[1]):
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

    # ---- 4b. the differentiable path at full width: one image_loss
    # gradient step of the main path's render at 1 spp
    dcfg = RenderConfig(width=256, height=256, ns_aa=1, ns_area_light=4,
                        max_ray_depth=5)
    dscene, dcam = load_scene(CBOX_SPHERES, dev, 256, 256)
    dbh = make_black_hole(dcfg, dev)
    drays = inverse.pixel_rays(dcam, 256, 256, dev)
    dparams = diff.params_from_scene(dscene, dbh)
    dtarget = torch.zeros_like(drays.o)
    names = [f.name for f in dataclasses.fields(diff.SceneParams)]

    def diff_step():
        """image_loss and its gradient, as `diff.loss_and_grad` takes them,
        with the integrator's trace work."""
        leaves = [x.detach().requires_grad_(True) for x in dparams.leaves()]
        img, work = diff.render_radiance(
            diff.SceneParams.from_leaves(leaves), dscene, dbh, drays, dcfg,
            torch.Generator(device=dev).manual_seed(0), with_work=True)
        loss = torch.mean((img - dtarget) ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize(dev)
        return loss, grads, work

    tk.LAUNCHES = 0
    dloss, dgrads, dwork = diff_step()
    diff_launches = tk.LAUNCHES
    if diff_launches != dwork.calls or diff_launches == 0:
        raise AssertionError(f"{diff_launches} kernel launches for "
                             f"{dwork.calls} trace calls of a diff step")
    for name, g in zip(names, dgrads):
        if g is not None and not torch.isfinite(g).all():
            raise AssertionError(f"diff step: {name} gradient not finite")
    g_r = dgrads[names.index("bh_radius")]
    if g_r is None or not g_r.item() != 0.0:
        raise AssertionError(f"diff step: bh_radius gradient {g_r}")
    diff_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        diff_step()
        diff_walls.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    diff_step()
    diff_peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
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
    dprof = profile_call(diff_step, ranges=("trace_diff.replay",),
                         device=dev)
    print(f"[smoke] diff step 256x256 1spp -l 4 -m 5 curved GI: loss "
          f"{dloss.item():.6g}, d/d radius {g_r.item():.6g}, "
          f"{diff_launches} kernel launches = trace calls; warm walls (s) "
          f"{[round(w, 4) for w in diff_walls]}, peak memory "
          f"{diff_peak_mib:.1f} MiB ({mem0 / 2 ** 20:.1f} MiB before), one "
          f"replayed trace of 65536 lanes keeps {replay_mib:.1f} MiB "
          f"({card})")
    print(f"[smoke] diff step profile: {dprof.report()} ({card})")

    # ---- 4c. BASELINE config 4's closed loops on the card
    tk.LAUNCHES = 0
    radius, radius_true, radius_ms = inverse.recover_radius(dev)
    radius_launches = tk.LAUNCHES
    tk.LAUNCHES = 0
    albedo, albedo_true, albedo_ms = inverse.recover_albedo(dev)
    albedo_launches = tk.LAUNCHES
    albedo_err = float(np.abs(albedo - albedo_true).max())
    print(f"[smoke] config 4 radius loop (seed "
          f"{inverse.RADIUS_SEED['cuda']}): {inverse.RADIUS_STEPS} steps "
          f"from {inverse.RADIUS_START} end at "
          f"{radius:.5f} (true {radius_true:.5f}), {radius_ms:.2f} ms per "
          f"step, {radius_launches} kernel launches ({card})")
    print(f"[smoke] config 4 albedo loop: red wall {albedo.tolist()} (true "
          f"{albedo_true.tolist()}), max err {albedo_err:.4f}, "
          f"{albedo_ms:.2f} ms per step, {albedo_launches} kernel launches "
          f"({card})")
    if min(radius_launches, albedo_launches) == 0:
        raise AssertionError("config 4's loops launched no kernel")
    if not abs(radius - radius_true) < 0.015:
        raise AssertionError(f"config 4 radius {radius}, true {radius_true}")
    if not albedo_err < 0.08:
        raise AssertionError(f"config 4 albedo error {albedo_err}")

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
    eprof = profile_call(erend.render,
                         ranges=("envmap.sample_L", "envmap.sample_dir"),
                         device=dev)
    print(f"[smoke] env-lit main path 256x256 16spp -l 4 -m 5 -e "
          f"{eh}x{ew}: wall {env_wall:.2f} s, mean radiance {env_mean:.5f} "
          f"(without -e {mean_rad:.5f}), {env_launches} kernel launches = "
          f"trace calls ({card})")
    print(f"[smoke] env render profile: {eprof.report()} ({card})")
    # sample_L alone on the lanes of one NEE sample of the main path
    # (256x256 at 16 spp); with --old-envmap, an earlier sample_L in turns
    gen = torch.Generator(device=dev).manual_seed(3)
    xi = torch.rand((1 << 20, 2), generator=gen, device=dev)
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

    # ---- 5. the bench, in-process: the probe kernel and the trace kernel
    tk.LAUNCHES, tprobe.LAUNCHES = 0, 0
    bench_out, diag = bench.run(dev)
    bench_launches = {"trace_kernel": tk.LAUNCHES, "probe": tprobe.LAUNCHES}
    print(f"[smoke] bench json: {json.dumps(bench_out)}")
    print(f"[smoke] bench {diag}")
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

    # ---- 7. result lines
    ms, plain_ms = times["closest-hit"]
    # the cost probes' one launch each at N_PLAIN iterations: operations
    # per lane and iteration from the source, 4 KiB in and out per launch
    r5_ops = float(sum(r5prim.OPS_PER_ITER[row["probe"]] for row in rows)
                   * r5prim.N_PLAIN * np.prod(r5prim.SHAPE))
    r5_t = (r5_ops / peak, 8192 * len(rows) / HBM_BYTES_PER_S)
    print(json.dumps({"kernels": [{
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
        "env_launches": env_launches,
        "config4_launches": radius_launches + albedo_launches,
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
