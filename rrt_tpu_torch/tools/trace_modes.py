"""The trace kernel's design choices, measured on a CUDA card:
`python -m rrt_tpu_torch.tools.trace_modes [--old PATH]`.

The kernel (`ops/csrc/trace_kernel.cu`) keeps warps resident and has them
take rays from a queue; it makes three choices for itself: whether a warp
walks a chord's hierarchy lane by lane or cooperatively (by the scene),
when a warp's idle lanes take new rays (by the warp's rays), and where its
tables are read from (shared memory where they fit). This tool builds each
choice fixed as a variant of the same source (nvcc -D, `VARIANTS`), checks
that every variant computes exactly what the default build does, and
times them in turns on one card, for the main path's batches (the first
pass's 1,048,576 camera rays, the first vertex's 4,194,304 shadow lanes,
the same shadow lanes with a seeded half parked at the hole's centre) and
for 65,536 seeded rays in `cbox_dense`:

1. traversal: per lane against cooperative;
2. refill: the kernel's rule against a fixed 1 or 32 idle lanes, alone
   and per launch of a render;
3. tables: where they fit, in shared memory, against the triangles or
   every table in device memory;
4. block width, with ptxas's registers and spills;
5. with `--old PATH`, an earlier trace_kernel.cu with PR 2's C interface
   (one thread per ray), against this kernel;
6. each batch's work: its counters, the tests it needs, and its bound.

Each line of output is one JSON object with the card's name and power
limit. The helpers here (timing in turns, the work and bound of a launch,
variant builds, per-launch render timing, the earlier kernel's loader) are
also what `chip_smoke.py` and the card tests use.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

# The kernel's operation model, from ops/csrc/trace_kernel.cu: a marched
# chord (march, absorb, scene-box slab) ~150 float operations, a box test
# 24, a triangle (or sphere) test 47; a lane reads 32 bytes and writes 46.
# Device memory moves 3.35 TB/s (H100 SXM).
OPS_CHORD, OPS_BOX, OPS_TRI, BYTES_LANE = 150, 24, 47, 78
HBM_BYTES_PER_S = 3.35e12
BOX = ((-0.8, 0.35, -0.8), (0.8, 1.15, 0.8))


def box_rays(n, seed, device, lo, hi):
    """Seeded rays with origins in a box and uniform directions."""
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


def timed(fn, reps):
    """(ms per call, output of the last call) over `reps` calls after a
    warm-up call, by CUDA events."""
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


def in_turns(fns: dict, reps: int) -> dict:
    """{name: [ms, ms]}: each of fns timed twice, in the order of the dict
    and then back (old, new, new, old for two)."""
    names = list(fns)
    res = {name: [] for name in names}
    for name in names + names[::-1]:
        res[name].append(timed(fns[name], reps)[0])
    return res


def trace_work(tab, args, occlusion, out, peak, slice_lanes=1 << 20):
    """One launch's work: lanes, live-lane share (lanes that did more than
    die on their first chord), chords, and box and triangle tests per lane
    from its own counters (`box_per_lane`, `tri_per_lane`) and as its lanes
    need them (`need_box_per_lane`, `need_tri_per_lane`: the tests the
    kernel makes, counted by `warp_work.count` on the launch's inputs
    `args` = (o, d, min_t, max_t), in slices of `slice_lanes`). The bound is
    the larger of the needed operations over the float32 peak and the
    bytes over the memory rate."""
    from rrt_tpu_torch.tools import warp_work
    n = out.hit.shape[0]
    i64 = torch.int64
    if tab.curved:
        chords = torch.clamp(out.seg.to(i64) + 1, max=tab.n_seg)
        parked = (out.seg == 0) & ~out.hit & ~out.absd & (out.ncull == 0)
    else:
        chords = torch.zeros_like(out.seg, dtype=i64)
        parked = torch.zeros_like(out.hit)
    need = dict(need_box=0, need_tri=0)
    for i in range(0, n, slice_lanes):
        c = warp_work.count(tab, *(a[i:i + slice_lanes] for a in args),
                            occlusion)
        for k in need:
            need[k] += c[k]
    n_chords = chords.sum().item()
    ops = (OPS_CHORD * n_chords + OPS_BOX * need["need_box"]
           + OPS_TRI * need["need_tri"])
    t_ops, t_bytes = ops / peak, BYTES_LANE * n / HBM_BYTES_PER_S
    return dict(lanes=n, live=1.0 - parked.float().mean().item(),
                chords_per_lane=n_chords / n,
                box_per_lane=out.ncull.sum(dtype=i64).item() / n,
                tri_per_lane=out.nisect.sum(dtype=i64).item() / n,
                need_box_per_lane=need["need_box"] / n,
                need_tri_per_lane=need["need_tri"] / n, ops=ops,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def work_line(w):
    return (f"live {w['live']:.3f}, {w['chords_per_lane']:.2f} chords, "
            f"{w['box_per_lane']:.1f} box and {w['tri_per_lane']:.1f} "
            f"triangle tests a lane by the counters, "
            f"{w['need_box_per_lane']:.1f} and {w['need_tri_per_lane']:.1f} "
            f"needed, bound {w['bound_ms']:.4f} ms ({w['bound_by']})")


def ptxas_report(output):
    """{kernel's mangled name: [registers, spill bytes (stores + loads),
    stack frame bytes]} from `nvcc -Xptxas -v` output."""
    import re
    rows, name = {}, None
    for line in output.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows[name] = [0, int(m.group(2)) + int(m.group(3)),
                          int(m.group(1))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name in rows:
            rows[name][0] = int(m.group(1))
    return rows


def compile_trace(src, tag, defines=()):
    """Start nvcc on a trace kernel source with the port's flags (and
    -D defines) into the build directory; returns (Popen, library path)."""
    from rrt_tpu_torch.ops import build
    key = open(src, "rb").read() + " ".join(defines).encode()
    out = build.BUILD_DIR / (f"libtrace_{tag}_"
                             f"{hashlib.sha256(key).hexdigest()[:16]}.so")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
           "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def finish_build(proc):
    """Wait for a compile_trace nvcc; returns its output, raises if it
    failed."""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log}")
    return log


def old_trace_fn(lib_path):
    """trace(tab, o, d, min_t, max_t, occlusion) through an earlier kernel
    with PR 2's C interface (one thread per ray)."""
    from rrt_tpu_torch.ops import trace_kernel as tk
    lib = ctypes.CDLL(str(lib_path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rrt_trace.argtypes = ([vp] * 4 + [i] + [vp] * 6 + [i] * 8 + [vp] * 9
                              + [i, vp])
    lib.rrt_trace.restype = i

    def trace(tab, o, d, min_t, max_t, occlusion=False):
        n, dev = o.shape[0], o.device
        e = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                         device=dev)
        out = tk.TraceOut(hit=e(n, dt=torch.bool), absd=e(n, dt=torch.bool),
                          t=e(n), prim=e(n, dt=torch.int32),
                          seg=e(n, dt=torch.int32), seg_o=e(n, 3),
                          seg_d=e(n, 3), nisect=e(n, dt=torch.int32),
                          ncull=e(n, dt=torch.int32))
        p = lambda a: a.data_ptr()
        rc = lib.rrt_trace(
            p(o), p(d), p(min_t), p(max_t), n, p(tab.params), p(tab.tri),
            p(tab.cl), p(tab.sup), p(tab.part), p(tab.sph), tab.n_parts,
            tab.spp, tab.cs_k, tab.n_live_sph, tab.n_tri_rows, tab.n_seg,
            int(tab.curved), int(occlusion), p(out.hit), p(out.absd),
            p(out.t), p(out.prim), p(out.seg), p(out.seg_o), p(out.seg_d),
            p(out.nisect), p(out.ncull), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"earlier trace kernel launch failed: {rc}")
        return out
    return trace


# the kernel's own choices built fixed, and other block widths: name ->
# nvcc -D defines of ops/csrc/trace_kernel.cu
VARIANTS = {
    "per-lane": ("RRT_TRACE_TRAVERSAL=0",),
    "cooperative": ("RRT_TRACE_TRAVERSAL=1",),
    "refill 1": ("RRT_TRACE_REFILL=1",),
    "refill 32": ("RRT_TRACE_REFILL=32",),
    "device triangles": ("RRT_TRACE_LAYOUT=1",),
    "device tables": ("RRT_TRACE_LAYOUT=2",),
    "lane 768": ("RRT_TRACE_LANE_THREADS=768",),
    "lane 896": ("RRT_TRACE_LANE_THREADS=896",),
    "coop 768": ("RRT_TRACE_COOP_THREADS=768",),
    "coop 1024": ("RRT_TRACE_COOP_THREADS=1024",),
}


def start_variants(names):
    """Start one nvcc per variant of the trace kernel, all at once;
    returns {name: (Popen, library path)} for `load_variant`."""
    from rrt_tpu_torch.ops import build
    src = build.FAMILIES["trace"].sources[0]
    return {name: compile_trace(src, name.replace(" ", "_"), VARIANTS[name])
            for name in names}


def load_variant(started):
    """(the library's rrt_trace and rrt_error_string, nvcc's output) of a
    `start_variants` build, once nvcc is done."""
    from rrt_tpu_torch.ops import build
    proc, path = started
    log = finish_build(proc)
    lib = ctypes.CDLL(str(path))
    build.FAMILIES["trace"].declare(lib)
    return (lib.rrt_trace, lib.rrt_error_string), log


@contextlib.contextmanager
def _swap(name: str, value):
    """`ops.trace_kernel`'s attribute `name` is `value` inside the block:
    the one switch of the trace's route that the tools use."""
    from rrt_tpu_torch.ops import trace_kernel as tk
    saved = getattr(tk, name)
    setattr(tk, name, value)
    try:
        yield
    finally:
        setattr(tk, name, saved)


def using(fns):
    """`trace_rays` launches through another build's functions (from
    `load_variant`) inside the block."""
    from rrt_tpu_torch.ops import trace_kernel as tk
    tk._trace_fn()
    return _swap("_FN", fns)


def plain():
    """Every trace inside the block goes through the plain version
    (`trace_rays_reference`), on the card too: the tools' `--backend
    plain`, the counterpart of the JAX package's XLA traversal."""
    from rrt_tpu_torch.ops import trace_kernel as tk
    return _swap("trace_rays", tk.trace_rays_reference)


def backend(name: str, device):
    """The context of a tool's `--backend`: "auto" (the device's: the
    kernel on a card, the plain version on the CPU), "kernel" (a card's
    only) or "plain"."""
    if name == "plain":
        return plain()
    if name == "kernel" and torch.device(device).type != "cuda":
        raise ValueError("--backend kernel needs a CUDA device")
    if name not in ("auto", "kernel"):
        raise ValueError(f"backend {name!r}: auto, kernel or plain")
    return contextlib.nullcontext()


def render_launches(renderer, peak, launch=None, work=True):
    """One render of `renderer` with every trace launch timed by CUDA
    events around it and, with `work`, its work read from its inputs and
    outputs (`trace_work`); `launch` replaces the kernel's launcher
    (`trace_kernel._launch`) for this render. The renderer must run its
    passes eagerly (`Renderer(..., graphs=False)`): a replayed pass calls
    no Python launcher, so the swaps would not see it. Returns (wall
    seconds, [dict per launch])."""
    from rrt_tpu_torch.ops import trace_kernel as tk
    if renderer.graphs:
        raise ValueError("render_launches times each launch through the "
                         "Python launcher: build the renderer with "
                         "graphs=False")
    rows, real_trace, real_launch = [], tk.trace_rays, tk._launch

    def timed_trace(tab, o, d, min_t, max_t, occlusion=False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_trace(tab, o, d, min_t, max_t, occlusion)
        end.record()
        rows.append((occlusion, start, end, out, tab, (o, d, min_t, max_t)))
        return out
    tk.trace_rays = timed_trace
    if launch is not None:
        tk._launch = launch
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tk.trace_rays, tk._launch = real_trace, real_launch
    return wall, [dict(trace_work(tab, args, occ, out, peak) if work else {},
                       anyhit=bool(occ), ms=start.elapsed_time(end))
                  for occ, start, end, out, tab, args in rows]


def main_path_batches(device):
    """The main path's Cornell box, config, hole and tables, and the
    flat lanes of its first pass's camera rays and of its first vertex's
    shadow rays, built by the renderer's and integrator's own functions."""
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.render import integrator
    from rrt_tpu_torch.render.renderer import (Renderer, make_black_hole,
                                               pass_generator)
    from rrt_tpu_torch.scene.build import load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES
    from rrt_tpu_torch.utils import math3d as m3
    from rrt_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig(width=256, height=256, ns_aa=16, ns_area_light=4,
                       max_ray_depth=5)
    bh = make_black_hole(cfg, device)
    scene, cam = load_scene(CBOX_SPHERES, device, 256, 256)
    rend = Renderer(scene, cam, cfg, device)
    n_px = cfg.width * cfg.height
    k_pass = rend.samples_per_pass(n_px)
    gen = pass_generator(cfg.seed, 0, 0, device)
    cam_rays = rend.camera_rays(
        torch.rand((k_pass * n_px, 2), generator=gen, device=device), gen,
        k_pass)
    hit = tk.kernel_trace(scene, rend.tables, cam_rays)
    samples = integrator.light_samples(scene, hit, cfg, gen)
    if not len(samples) <= cfg.nee_chunk:
        raise AssertionError("the NEE samples span more than one chunk")
    _, _, shadow = integrator.shadow_rays(
        bh, hit, m3.make_coord_space(hit.n), samples, cfg)
    return dict(scene=scene, cam=cam, cfg=cfg, bh=bh, tab=rend.tables,
                camera=flat_args(cam_rays), shadow=flat_args(shadow))


def _emit(what, card, **kw):
    print(json.dumps(dict(what=what, card=card, **kw)), flush=True)


def _same(a, b):
    """Do two TraceOuts hold the same values in every field?"""
    from rrt_tpu_torch.ops import trace_kernel as tk
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(tk.TraceOut))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", metavar="PATH",
                    help="an earlier trace_kernel.cu (PR 2's C interface)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_modes: no CUDA device", file=sys.stderr)
        return 2
    from rrt_tpu_torch.ops import build, trace_kernel as tk
    from rrt_tpu_torch.render.renderer import Renderer
    from rrt_tpu_torch.scene.build import build_scene
    from rrt_tpu_torch.scenes import cbox_dense
    from rrt_tpu_torch.utils.card import (card_line, fp32_peak_flops,
                                          max_sm_clock_mhz)
    card = card_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    peak = fp32_peak_flops(dev, max_sm_clock_mhz())
    started = start_variants(VARIANTS)
    old_build = compile_trace(args.old, "old") if args.old else None
    build.build_all(["trace"])
    libs = {"default": tk._trace_fn()}
    logs = {"default": build.BUILD_LOG["trace"]["output"]}
    for name in VARIANTS:
        libs[name], logs[name] = load_variant(started[name])
    for name, log in logs.items():
        _emit("ptxas", card, build=name, kernels={
            k[k.index("trace_kernel"):]: v
            for k, v in ptxas_report(log).items() if "trace_kernelILb1E" in k})
    if old_build is not None:
        finish_build(old_build[0])
        old = old_trace_fn(old_build[1])

    mp = main_path_batches(dev)
    tab = mp["tab"]
    parked = mp["shadow"][0].clone()
    half = torch.rand(parked.shape[0], device=dev,
                      generator=torch.Generator(device=dev).manual_seed(5))
    parked[half < 0.5] = mp["bh"].position.to(torch.float32)
    dense, _ = build_scene(cbox_dense(), dev, 128, 128)
    dtab = tk.build_tables(dense, mp["bh"])
    shapes = [("camera closest-hit", tab, mp["camera"], False),
              ("shadow any-hit", tab, mp["shadow"], True),
              ("shadow any-hit, half parked", tab,
               (parked,) + mp["shadow"][1:], True),
              ("cbox_dense closest-hit", dtab,
               flat_args(box_rays(65536, 7, dev, *BOX)), False)]

    def call(name, t, a, occ):
        with using(libs[name]):
            return tk.trace_rays(t, *a, occ)

    def turns(names, t, a, occ):
        return in_turns({name: (lambda name=name: call(name, t, a, occ))
                         for name in names}, 10)

    # 0. every variant computes what the default build computes
    for label, t, a, occ in shapes:
        ref = call("default", t, a, occ)
        differ = [name for name in VARIANTS
                  if not _same(call(name, t, a, occ), ref)]
        if differ:
            raise AssertionError(f"{label}: {differ} differ from the default")
        _emit("same as default", card, batch=label, variants=list(VARIANTS),
              launch=dict(tk.LAST_LAUNCH))
    # 1.-4. the kernel's choices and block widths, each in turns with the
    # default build
    groups = (("traversal", ("per-lane", "cooperative"), shapes),
              ("refill", ("default", "refill 1", "refill 32"), shapes[:3]),
              ("tables", ("default", "device triangles", "device tables"),
               shapes),
              ("width", ("default", "lane 768", "lane 896", "coop 768",
                         "coop 1024"), shapes))
    for what, names, batches in groups:
        for label, t, a, occ in batches:
            _emit(what, card, batch=label, ms=turns(names, t, a, occ))
    # eager passes: the builds are swapped in through the Python launcher
    rend = Renderer(mp["scene"], mp["cam"], mp["cfg"], dev, graphs=False)
    rend.render()
    res = {}
    for name in ("default", "refill 1", "refill 32", "refill 32", "refill 1",
                 "default"):
        with using(libs[name]):
            wall, rows = render_launches(rend, peak, work=False)
        res.setdefault(name, []).append(dict(
            wall=wall, launches=[r["ms"] for r in rows]))
    _emit("render refill", card, ms=res)
    # 5. the earlier kernel
    if args.old:
        for label, t, a, occ in shapes:
            _emit("old", card, batch=label, ms=in_turns({
                "old": lambda: old(t, *a, occ),
                "new": lambda: tk.trace_rays(t, *a, occ)}, 10))
    # 6. each batch's work and bound
    for label, t, a, occ in shapes:
        _emit("work", card, batch=label,
              **trace_work(t, a, occ, tk.trace_rays(t, *a, occ), peak))
    return 0


if __name__ == "__main__":
    sys.exit(main())
