#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rrt_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases:

1. the card: fail without CUDA; print its name and power limit;
2. build every kernel library from the sources in the checkout (trace,
   probe, r5prim), one nvcc each, all started together;
3. trace kernel against its plain PyTorch version on the card. First
   65,536 seeded rays in the in-repo Cornell box, in a procedural scene
   of three triangle parts and in the bench's BVH-scale scene
   (`cbox_dense`: 14 parts, clusters of 8): flat, curved closest-hit and
   curved any-hit. Then
   the main path's own sizes: its 1,048,576 jittered camera rays (closest
   hit), and the 4,194,304 shadow lanes that the integrator stacks from
   their hits (4 area-light samples, any hit), each timed on the kernel
   and on the plain version. Rules: calm lanes agree exactly on hit, prim,
   segment and counters, and on t and the hit point to rtol 1e-5; all
   lanes agree on ≥ 99.9% of hits and prims. Then the toolchain probe
   kernel against `probe_reference` (exact), and the eight cost probes
   against their plain versions at n_iter 1 and 64 (exact for fori_chain
   and when_rt, rtol 1e-6 for the others);
4. the main path through the CLI: 256×256, 16 spp, -l 4, -m 5, curved
   global illumination on cuda, with every trace counted at the kernel;
   then a profile of the same render (warm walls, peak memory, device
   time by kernel); a small normal-shaded render on the card checked
   against the CPU;
5. the bench (`rrt_tpu_torch.bench`, in-process): probe, build, the
   primary and the BVH-scale cell; its JSON line is printed;
6. the cost-probe tool's path (`rrt_tpu_torch.tools.r5prim`): every probe
   timed at two iteration counts, beside its plain version;
7. a JSON line of the kernels, then the ok line.

Each of the three paths (4, 5, 6) is driven with the kernels' launch
counts set to 0 just before it and read just after: every kernel of the
path must have launched in it.

Any failure raises, and the script exits non-zero without the ok line.
"""
from __future__ import annotations

import dataclasses
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


def box_rays(n, seed, device, lo, hi):
    """Seeded rays with origins in a box and uniform directions."""
    import torch
    from rrt_tpu_torch.types import Rays
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = lambda a: torch.tensor(a, device=device)
    return Rays(o=t(o), d=t(d), min_t=t(np.zeros(n, np.float32)),
                max_t=t(np.full(n, 1e9, np.float32)))


def flat_args(rays):
    """(o, padded d, min_t, max_t) as flat contiguous lanes, the way
    `kernel_trace` hands a batch to `trace_rays`."""
    from rrt_tpu_torch.ops import trace_kernel as tk
    return (rays.o.reshape(-1, 3).contiguous(),
            tk.pad_dirs(rays.d.reshape(-1, 3)).contiguous(),
            rays.min_t.reshape(-1).contiguous(),
            rays.max_t.reshape(-1).contiguous())


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


def timed(fn, reps):
    """(ms per call, output of the last call) over `reps` calls after a
    warm-up call, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from rrt_tpu.utils.config import BlackHoleConfig, Illum, RenderConfig
    from rrt_tpu_torch import bench, cli
    from rrt_tpu_torch.ops import build, probe as tprobe, trace_kernel as tk
    from rrt_tpu_torch.render import integrator
    from rrt_tpu_torch.render.renderer import (Renderer, make_black_hole,
                                               pass_generator)
    from rrt_tpu_torch.scene.build import build_scene, load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES, cbox_dense, uv_sphere_box
    from rrt_tpu_torch.tools import r5prim
    from rrt_tpu_torch.utils import math3d as m3
    from rrt_tpu_torch.utils.card import card_line, max_sm_clock_mhz
    from rrt_tpu_torch.utils.profile import profile_render

    # ---- 1. the card
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(card)
    print(f"[smoke] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} × {torch.cuda.device_count()}")

    # ---- 2. build every library, one nvcc each, all at once
    t0 = time.perf_counter()
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
    print(f"[smoke] all libraries in {time.perf_counter() - t0:.1f} s")

    # ---- 3a. kernel vs plain version, seeded rays, three scenes
    cfg = RenderConfig(width=256, height=256, ns_aa=16, ns_area_light=4,
                       max_ray_depth=5)
    bh = make_black_hole(cfg, dev)
    cbox, cam = load_scene(CBOX_SPHERES, dev, 256, 256)
    parts, _ = build_scene(uv_sphere_box(), dev)
    dense, _ = build_scene(cbox_dense(), dev, 128, 128)
    bh_parts = make_black_hole(cfg.replace(black_hole=BlackHoleConfig(
        position=(-0.45, -0.35, 0.4), radius=0.08, delta_theta=0.1)), dev)
    errs = []
    times = {}
    for scene_name, scene, hole, lo, hi in (
            ("cbox", cbox, bh, (-0.8, 0.35, -0.8), (0.8, 1.15, 0.8)),
            ("parts", parts, bh_parts, (-0.9,) * 3, (0.9,) * 3),
            ("dense", dense, bh, (-0.8, 0.35, -0.8), (0.8, 1.15, 0.8))):
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
            if scene_name == "dense" and mode == "curved":
                ms, k = timed(lambda: tk.trace_rays(tab, *args, occ), 10)
                plain_ms, r = timed(
                    lambda: tk.trace_rays_reference(tab, *args, occ), 1)
                times["dense"] = (ms, plain_ms)
                print(f"[smoke] {N_CHECK}-lane dense curved closest-hit "
                      f"trace: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms "
                      f"({card})")
            else:
                k = tk.trace_rays(tab, *args, occ)
                r = tk.trace_rays_reference(tab, *args, occ)
            errs.append(check(f"{scene_name} {mode}", k, r, args[0],
                              args[1], hole, tab.n_seg))
        del args, k, r

    # ---- 3b. kernel vs plain version at the main path's sizes: the first
    # pass's camera rays, and the first vertex's NEE shadow queries built
    # from their hits by the integrator's own functions
    rend = Renderer(cbox, cam, cfg, dev)
    tab = rend.tables
    n_px = cfg.width * cfg.height
    k_pass = rend.samples_per_pass(n_px)
    gen = pass_generator(cfg.seed, 0, 0, dev)
    cam_rays = rend.camera_rays(
        torch.rand((k_pass * n_px, 2), generator=gen, device=dev), gen,
        k_pass)
    hit = tk.kernel_trace(cbox, tab, cam_rays)
    samples = integrator.light_samples(cbox, hit, cfg, gen)
    if not len(samples) <= cfg.nee_chunk:
        raise AssertionError("the NEE samples span more than one chunk")
    _, _, shadow = integrator.shadow_rays(
        bh, hit, m3.make_coord_space(hit.n), samples, cfg)
    for name, rays, occ in (("closest-hit", cam_rays, False),
                            ("any-hit", shadow, True)):
        args = flat_args(rays)
        ms, k = timed(lambda: tk.trace_rays(tab, *args, occ), 10)
        plain_ms, r = timed(lambda: plain(tab, *args, occ), 1)
        errs.append(check(f"main-path {name}", k, r, args[0], args[1], bh,
                          tab.n_seg))
        times[name] = (ms, plain_ms)
        print(f"[smoke] {args[0].shape[0]}-lane curved {name} trace: "
              f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms ({card})")
    del rend, cam_rays, hit, samples, shadow, k, r, args

    # ---- 3c. the toolchain probe kernel against its plain version
    x = torch.tensor(np.random.default_rng(3).normal(size=tprobe.SHAPE),
                     dtype=torch.float32, device=dev)
    probe_ms, k = timed(lambda: tprobe.probe_kernel(x), 100)
    probe_plain_ms, r = timed(lambda: tprobe.probe_reference(x), 100)
    probe_err = (k - r).abs().max().item()
    if not torch.equal(k, r):
        raise AssertionError(f"probe kernel differs from x * 2 by {probe_err}")
    print(f"[smoke] probe kernel: equal to x * 2, kernel {probe_ms:.4f} ms, "
          f"plain {probe_plain_ms:.4f} ms ({card})")

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
    prof = profile_render(renderer, reps=5)
    for line in prof.report().splitlines():
        print(f"[smoke] profile: {line}")

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
        "anyhit_ms": times["any-hit"][0],
        "anyhit_plain_ms": times["any-hit"][1],
        "dense_ms": times["dense"][0],
        "dense_plain_ms": times["dense"][1],
    }, {
        "name": "probe",
        "route": "cuda",
        "source": "rrt_tpu_torch/ops/csrc/probe.cu",
        "replaces": "bench.py:49",
        "launches": bench_launches["probe"],
        "max_abs_err": probe_err,
        "ms": probe_ms,
        "plain_ms": probe_plain_ms,
    }, {
        "name": "r5prim",
        "route": "cuda",
        "source": "rrt_tpu_torch/ops/csrc/r5prim.cu",
        "replaces": "tools/r5prim.py:27",
        "launches": sum(r5_launches.values()),
        "max_abs_err": max(probe_errs.values()),
        "ms": sum(row["kernel_ms"] for row in rows),
        "plain_ms": sum(row["plain_ms"] for row in rows),
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
