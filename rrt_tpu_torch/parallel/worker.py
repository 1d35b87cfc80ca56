"""One rank of the multi-process check and of `tools/scaling_bench.py`
(the port of tests/mp_worker.py).

    python -m rrt_tpu_torch.parallel.worker PID NPROC PORT OUT.npz [SIZE]
        [--device cpu|cuda] [--backend gloo|nccl] [--checks render,...]

SIZE is W or WxH (default 16). Each rank joins a process group of NPROC
ranks at 127.0.0.1:PORT, takes its contiguous share of a frame's centred
camera rays through `make_global_batch`, and estimates their radiance as
its block of the whole batch (its block of the draws of key(0), as the
JAX worker's jitted forward draws; flat spacetime, 1 spp, -l 1, -m 2),
twice to warm up and `FWD_REPS` times timed (`dts`, their median `dt`);
on a card the forward is a CUDA graph (`render/integrator.Forward`: the
first call eager, the second captured, later calls replayed), as the JAX
worker jits it, so that `dt` is the card's time and not the host's
launches. It then estimates the whole frame in this process alone and
holds its rows to rtol 2e-5, atol 2e-6, as the JAX worker does (the
block's draws make them equal), and writes OUT.npz with `local, lo, hi,
dt, dts, nproc, ndev`, the max error and
`build_cached` (whether the trace kernel's library was built before this
process started).

`--checks` adds sharded runs whose results go into OUT.npz for the caller
to hold against a single-process run (`reference`):
  render — a curved GI render (2 spp, one sample a pass, -l 1, -m 3)
           with `Renderer(sharding=)`: its accumulators, trace calls, the
           trace kernel's Python launches and its own count of its runs;
  stop   — the same render with `stop_after=1` on the last rank only;
  grad   — `loss_and_grad(mesh=)` of that frame's camera rays;
  step   — `LossAndGrad(mesh=)` of the same problem called three times
           with moved params and key(i) at call i (on a card the first
           call eager, the second captured and replayed, the third
           replayed; on the CPU all eager): each call against
           `loss_and_grad(mesh=)` bit for bit, its trace calls and the
           kernel's runs, and the last call's loss and gradients;
  kerr   — a 32×32, 80-step Kerr image with `render_image(sharding=)`;
  cli    — `kerr_cli --sharded` at the same settings;
  mesh   — the per-trace sharded forward (`est_radiance(mesh=)`) of a W²
           frame, flat and curved, held in the rank to itself eager and
           to the unsharded forward (`tools/scaling_bench.forward_case`,
           one timed call each; compiled on a card over NCCL); its rows
           as JSON, needing no reference.
The renders, the step and the Kerr march take the defaults: CUDA graphs
on a card, around their collectives.

`CARD_CHECKS` are the same paths at full width, for several cards
(`chip_smoke.py` phase 4n), held to `full_reference`; they are kept out
of `CHECKS`, so that the CPU tests never run them:
  full_render — the primary cell (256², 16 spp, -l 4, -m 5), a tail
                pass, adaptive and a stop on the last rank alone
                (`FULL_CASES`), three renders each, then the primary's
                walls in turns with the unsharded render on this rank's
                own card, a profile and the collectives of a steady one;
  full_step   — phase 4b's 256² step through `LossAndGrad(mesh=)`, three
                calls, then replays timed;
  full_kerr   — BASELINE config 5's Kerr frame (1024², 600 RK4 steps);
  mesh_trace  — the forward with every trace sharded
                (`est_radiance(mesh=)`), flat and curved, at
                `MESH_TRACE_SIZE`², compiled with its collectives inside
                the graph, against itself eager and the unsharded
                forward on this rank's card
                (`tools/scaling_bench.forward_case`; its rows as JSON).

The step's reference is the ranks' shares computed in one process. NCCL
does not say in which order it sums them, so the all-reduce is held to
their sum in rank order within the order-free bound of a float32 sum
(`sum_bound`); two shares sum alike in either order, so a world of 2 is
bit for bit.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from rrt_tpu_torch.utils import prng

CHECKS = ("render", "stop", "grad", "step", "kerr", "cli", "mesh")
# the differentiable leaves, in `diff.SceneParams` order
_LEAVES = ("reflectance", "transmittance", "emission", "eta", "k", "alpha",
           "ior", "light_radiance", "bh_position", "bh_radius",
           "bh_delta_theta")
KERR = dict(size=32, n_steps=80)


def frame_size(size: str):
    """(W, H) of a SIZE argument: W or WxH."""
    w, _, h = size.partition("x")
    return int(w), int(h or w)


def forward_setup(w: int, h: int, device):
    """The forward's scene, hole, tables, config and the frame's centred
    camera rays (the JAX worker's settings, on the in-repo box)."""
    from rrt_tpu_torch.ops.trace_kernel import build_tables
    from rrt_tpu_torch.render.renderer import make_black_hole
    from rrt_tpu_torch.scene.build import load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES
    from rrt_tpu_torch.utils.config import BlackHoleConfig, RenderConfig
    cfg = RenderConfig(width=w, height=h, ns_aa=1, ns_area_light=1,
                       max_ray_depth=2, seed=0,
                       black_hole=BlackHoleConfig(enabled=False))
    scene, cam = load_scene(CBOX_SPHERES, device, w, h)
    bh = make_black_hole(cfg, device)
    ys, xs = torch.meshgrid((torch.arange(h, device=device) + 0.5) / h,
                            (torch.arange(w, device=device) + 0.5) / w,
                            indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
    return scene, bh, build_tables(scene, bh), cfg, cam.generate_rays(xy)


def render_setup(w: int, h: int, device):
    """The checks' scene, camera and curved GI config: 2 spp, one sample a
    pass, -l 1, -m 3, the default hole."""
    from rrt_tpu_torch.scene.build import load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES
    from rrt_tpu_torch.utils.config import RenderConfig
    scene, cam = load_scene(CBOX_SPHERES, device, w, h)
    cfg = RenderConfig(width=w, height=h, ns_aa=2, ns_area_light=1,
                       max_ray_depth=3, seed=0, max_pass_lanes=w * h)
    return scene, cam, cfg


def grad_setup(scene, cam, cfg, device):
    """The gradient check's hole, parameters, camera rays (one centred ray
    a pixel) and a grey target."""
    from rrt_tpu_torch.render import diff
    from rrt_tpu_torch.render.renderer import make_black_hole
    bh = make_black_hole(cfg, device)
    w, h = cfg.width, cfg.height
    ys, xs = torch.meshgrid((torch.arange(h, device=device) + 0.5) / h,
                            (torch.arange(w, device=device) + 0.5) / w,
                            indexing="ij")
    rays = cam.generate_rays(
        torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32))
    target = torch.full((w * h, 3), 0.2, device=device)
    return bh, diff.params_from_scene(scene, bh), rays, target


def step_params(params, i: int):
    """The step check's params at call i: the radius and the reflectance
    table moved."""
    return params.replace(bh_radius=params.bh_radius + 0.004 * i,
                          reflectance=params.reflectance * (1 - 0.05 * i))


# the step check's calls; call i draws from key(i)
STEP_CALLS = 3
# the forward's timed runs (after one warm-up); `dt` is their median
FWD_REPS = 5


def step_shares(problem, world: int, call: int = STEP_CALLS - 1):
    """The ranks' shares of the step's call `call` on `problem` = (params,
    scene, hole, rays, target, cfg), each `loss_and_grad` over a
    `LaneMesh` of that rank without a group (no collective): a list over
    the ranks of [loss, *the eleven gradients] as numpy arrays."""
    from rrt_tpu_torch.parallel.sharding import LaneMesh
    from rrt_tpu_torch.render import diff
    params, scene, bh, rays, target, cfg = problem
    dev = scene.device
    p = step_params(params, call)
    out = []
    for rank in range(world):
        mesh = LaneMesh(None, rank, world, dev, None)
        loss, g = diff.loss_and_grad(p, scene, bh, rays, target, cfg,
                                     prng.key(call, dev), mesh=mesh)
        out.append([v.cpu().numpy() for v in (loss, *g.leaves())])
    return out


def sum_bound(shares):
    """(b, bound) of one value's shares over the ranks (axis 0, float32):
    b their sum in rank order, and the order-free bound of a float32 sum,
    (N − 1)·2⁻²⁴·Σᵢ|shareᵢ| plus one ulp of b: an all-reduce that adds
    the same shares in any order lands within it of b."""
    s = np.asarray(shares, np.float32)
    b = s[0].copy()
    for x in s[1:]:
        b = b + x
    bound = ((len(s) - 1) * 2.0 ** -24
             * np.abs(s).astype(np.float64).sum(0)
             + np.spacing(np.abs(b)).astype(np.float64))
    return b, bound


def off_bound(a, shares) -> float:
    """The largest |a − b| / bound over the elements (`sum_bound`): at
    most 1 when `a` is a sum of `shares` in some order."""
    b, bound = sum_bound(shares)
    d = np.abs(np.asarray(a, np.float64) - b.astype(np.float64))
    return float((d / bound).max()) if d.size else 0.0


def kerr_args(device, out_png: str):
    """The Kerr check's hole, disk, render_image keywords and the matching
    kerr_cli arguments (writing `out_png`)."""
    from rrt_tpu_torch.convert import disk_from_arrays, kerr_params_from_arrays
    bh = kerr_params_from_arrays((0.0, 0.0, 0.0), 1.0, 0.9, device)
    disk = disk_from_arrays(3.0, 12.0, (1.0, 0.85, 0.6), 2.0, True, device)
    s = KERR["size"]
    cli = ["-f", out_png, "-r", str(s), str(s), "--steps",
           str(KERR["n_steps"]), "--device", torch.device(device).type]
    return bh, disk, dict(width=s, height=s, n_steps=KERR["n_steps"],
                          device=device), cli


def reference(checks, w: int, h: int, device, tmp_png: str,
              world: int = 2) -> dict:
    """The single-process results of `checks`, keyed as the worker writes
    the sharded ones, for a world of `world` ranks. The step's last call
    is `step_shares`: their sum in rank order under `step_<leaf>` (an
    all-reduce of two shares gives it bit for bit) and the shares stacked
    under `step_shares_<leaf>`, for `off_bound`."""
    from rrt_tpu_torch.render import diff
    from rrt_tpu_torch.render import kerr_scene as K
    from rrt_tpu_torch.render.renderer import Renderer
    out = {}
    scene, cam, cfg = render_setup(w, h, device)
    if "render" in checks:
        r = Renderer(scene, cam, cfg, device)
        r.render()
        for key, a in zip(("rad_sum", "s1", "s2", "count", "done"),
                          r.last_accumulators):
            out[f"render_{key}"] = a
    if "grad" in checks:
        bh, params, rays, target = grad_setup(scene, cam, cfg, device)
        loss, g = diff.loss_and_grad(params, scene, bh, rays, target, cfg,
                                     prng.key(0, device))
        out["grad_loss"] = loss.cpu().numpy()
        for f, v in zip(_LEAVES, g.leaves()):
            out[f"grad_{f}"] = v.cpu().numpy()
    if "step" in checks:
        bh, params, rays, target = grad_setup(scene, cam, cfg, device)
        shares = step_shares((params, scene, bh, rays, target, cfg), world)
        for i, f in enumerate(("loss",) + _LEAVES):
            each = [s[i] for s in shares]
            out[f"step_{f}"] = sum_bound(each)[0]
            out[f"step_shares_{f}"] = np.stack(each)
    if "kerr" in checks or "cli" in checks:
        bh, disk, kw, _ = kerr_args(device, tmp_png)
        out["kerr"] = K.render_image(bh=bh, disk=disk, **kw)
    return out


def run_checks(checks, w: int, h: int, mesh, out_png: str) -> dict:
    """The sharded runs of `checks` on this rank."""
    from rrt_tpu_torch import kerr_cli
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.parallel import sharding as sh
    from rrt_tpu_torch.render import diff
    from rrt_tpu_torch.render import kerr_scene as K
    from rrt_tpu_torch.render.renderer import Renderer
    dev = mesh.device
    sharding = sh.batch_sharding(mesh)
    scene, cam, cfg = render_setup(w, h, dev)
    out = {}
    if "render" in checks:
        r = Renderer(scene, cam, cfg, dev, sharding=sharding)
        tk.reset_counts()
        t0 = time.perf_counter()
        r.render()
        out["render_dt"] = time.perf_counter() - t0
        out["render_launches"] = tk.LAUNCHES
        out["render_kernel_runs"] = tk.kernel_runs()
        out["render_calls"] = r.last_trace_calls
        out["render_graphs"] = r.graphs
        for key, a in zip(("rad_sum", "s1", "s2", "count", "done"),
                          r.last_accumulators):
            out[f"render_{key}"] = a
    if "stop" in checks:
        r = Renderer(scene, cam, cfg, dev, sharding=sharding)
        r.render(stop_after=1 if mesh.rank == mesh.world - 1 else None)
        out["stop_samples"] = r.samples_done
        out["stop_cancelled"] = r.cancelled
    if "grad" in checks:
        bh, params, rays, target = grad_setup(scene, cam, cfg, dev)
        loss, g = diff.loss_and_grad(params, scene, bh, rays, target, cfg,
                                     prng.key(0, dev), mesh=mesh)
        out["grad_loss"] = loss.cpu().numpy()
        for f, v in zip(_LEAVES, g.leaves()):
            out[f"grad_{f}"] = v.cpu().numpy()
    if "step" in checks:
        bh, params, rays, target = grad_setup(scene, cam, cfg, dev)
        step = diff.LossAndGrad(scene, bh, cfg, rays, target, mesh=mesh)
        gen = lambda i: prng.key(i, dev)
        equal, calls, runs = [], [], []
        for i in range(STEP_CALLS):
            p = step_params(params, i)
            tk.reset_counts()
            loss, g = step(p, gen(i))
            calls.append(step.trace_calls)
            runs.append(tk.kernel_runs())
            want = diff.loss_and_grad(p, scene, bh, rays, target, cfg,
                                      gen(i), mesh=mesh)
            equal.append(torch.equal(loss, want[0]) and all(
                torch.equal(a, b) for a, b in zip(g.leaves(),
                                                  want[1].leaves())))
        out.update(step_equal=equal, step_calls=calls, step_kernel_runs=runs,
                   step_graphs=step.graphs,
                   step_replays=step.call.replays if step.graphs else 0)
        out["step_loss"] = loss.cpu().numpy()
        for f, v in zip(_LEAVES, g.leaves()):
            out[f"step_{f}"] = v.cpu().numpy()
    if "kerr" in checks or "cli" in checks:
        bh, disk, kw, cli = kerr_args(dev, out_png)
        if "kerr" in checks:
            out["kerr"] = K.render_image(bh=bh, disk=disk, sharding=sharding,
                                         **kw)
        if "cli" in checks:
            out["cli"] = kerr_cli.main(cli + ["--sharded"])
    if "mesh" in checks:
        from rrt_tpu_torch.tools.scaling_bench import forward_case
        for kind in ("flat", "curved"):
            out[f"mesh_{kind}"] = json.dumps(
                forward_case(mesh, w, kind == "curved", reps=1))
    return out


# the full-width checks: the primary cell's settings (256², 16 spp, -l 4,
# -m 5, seed 0, the default hole) and its cases, each (config changes,
# stop_after on the last rank); BASELINE config 5's Kerr frame
FULL_SIZE = 256
FULL_CASES = {
    "primary": (dict(), None),
    "tail": (dict(ns_aa=10, max_pass_lanes=4 * FULL_SIZE ** 2), None),
    "adaptive": (dict(adaptive=True, samples_per_batch=4,
                      max_pass_lanes=2 * FULL_SIZE ** 2), None),
    "stop": (dict(ns_aa=10, max_pass_lanes=4 * FULL_SIZE ** 2), 4),
}
FULL_KERR = dict(size=1024, n_steps=600, batch=1 << 20)
CARD_CHECKS = ("full_render", "full_step", "full_kerr", "mesh_trace")
# the per-trace forward's frame: the JAX tool's 1024² (1,048,576 lanes)
MESH_TRACE_SIZE = 1024
# renders of each case held to the reference (the eager pass, the
# capture, a replay), and the primary's timed renders in turns
FULL_RENDERS, FULL_REPS = 3, 5
_ACC = ("rad_sum", "s1", "s2", "count", "done")


def full_setup(device):
    """The full-width checks' scene, camera and configs: {case: (config,
    stop_after)}, and the step's problem (params, scene, hole, rays,
    target, config): phase 4b's 256² step (1 spp, one ray through every
    pixel centre, a black target)."""
    from rrt_tpu_torch.render import diff
    from rrt_tpu_torch.render.renderer import make_black_hole
    from rrt_tpu_torch.scene.build import load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES
    from rrt_tpu_torch.tools.inverse import pixel_rays
    from rrt_tpu_torch.utils.config import RenderConfig
    n = FULL_SIZE
    scene, cam = load_scene(CBOX_SPHERES, device, n, n)
    cfg = RenderConfig(width=n, height=n, ns_aa=16, ns_area_light=4,
                       max_ray_depth=5, seed=0)
    cases = {k: (cfg.replace(**kw), stop) for k, (kw, stop)
             in FULL_CASES.items()}
    dcfg = cfg.replace(ns_aa=1)
    bh = make_black_hole(dcfg, device)
    rays = pixel_rays(cam, n, n, device)
    problem = (diff.params_from_scene(scene, bh), scene, bh, rays,
               torch.zeros_like(rays.o), dcfg)
    return scene, cam, cases, problem


def full_kerr(device, sharding=None) -> np.ndarray:
    """BASELINE config 5's Kerr frame (1024², spin 0.9, disk [3, 12], 600
    RK4 steps, one batch of 1 << 20 lanes), sharded over `sharding`."""
    from rrt_tpu_torch.render import kerr_scene as K
    bh, disk, _, _ = kerr_args(device, "")
    k = FULL_KERR
    return K.render_image(k["size"], k["size"], bh, disk,
                          n_steps=k["n_steps"], batch=k["batch"],
                          device=device, sharding=sharding)


def full_reference(device, worlds) -> dict:
    """The one-card results that `CARD_CHECKS` are held to, on `device`:
    each case's unsharded render (graphs), the unsharded step's last call,
    its shares for each world in `worlds` (`step_shares`) and the Kerr
    frame."""
    from rrt_tpu_torch.render import diff
    from rrt_tpu_torch.render.renderer import Renderer
    scene, cam, cases, problem = full_setup(device)
    out = {}
    for name, (cfg, stop) in cases.items():
        r = Renderer(scene, cam, cfg, device)
        r.render(stop_after=stop)
        for key, a in zip(_ACC, r.last_accumulators):
            out[f"{name}_{key}"] = a
        out[f"{name}_samples"] = r.samples_done
    params, scene, bh, rays, target, cfg = problem
    i = STEP_CALLS - 1
    loss, g = diff.loss_and_grad(step_params(params, i), scene, bh, rays,
                                 target, cfg, prng.key(i, device))
    out["unsharded_step"] = [v.cpu().numpy() for v in (loss, *g.leaves())]
    for world in worlds:
        out[f"shares_{world}"] = step_shares(problem, world)
    out["kerr"] = full_kerr(device)
    return out


def _wall(fn, dev):
    """(seconds, result) of fn() on the host clock, ending in a sync of
    the card `dev`."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, res


def run_card_checks(checks, mesh, w: int, h: int) -> dict:
    """The full-width sharded runs of `checks` (`CARD_CHECKS`) on this
    rank's card, with CUDA graphs. Every render, step call and Kerr frame
    is kept for the caller to hold against `full_reference`; the checks
    that need no reference (a render equal to the rank's earlier ones,
    kernel runs against trace calls, a step call against the rank's eager
    `loss_and_grad(mesh=)`) are recorded here."""
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.parallel import distributed as pdist
    from rrt_tpu_torch.parallel import sharding as sh
    from rrt_tpu_torch.render import diff
    from rrt_tpu_torch.render.renderer import Renderer
    from rrt_tpu_torch.utils.profile import passes_run, profile_call
    dev = mesh.device
    sharding = sh.batch_sharding(mesh)
    last = mesh.rank == mesh.world - 1
    out = {}
    if "full_render" in checks:
        scene, cam, cases, _ = full_setup(dev)

        def render(r, stop=None):
            tk.reset_counts()
            wall, _ = _wall(lambda: r.render(stop_after=stop), dev)
            return (wall, [*r.last_accumulators], r.last_trace_calls,
                    tk.kernel_runs(), tk.LAUNCHES)
        for name, (cfg, stop) in cases.items():
            r = Renderer(scene, cam, cfg, dev, sharding=sharding)
            stop = stop if last else None
            rows = [render(r, stop) for _ in range(FULL_RENDERS)]
            acc = rows[-1][1]
            out[f"{name}_same"] = all(
                all(np.array_equal(a, b) for a, b in zip(row[1], acc))
                for row in rows)
            out[f"{name}_calls"] = [row[2] for row in rows]
            out[f"{name}_kernel_runs"] = [row[3] for row in rows]
            out[f"{name}_launches"] = [row[4] for row in rows]
            out[f"{name}_samples"] = r.samples_done
            out[f"{name}_graphs"] = r.graphs
            for key, a in zip(_ACC, acc):
                out[f"{name}_{key}"] = a
            if name != "primary":
                continue
            # walls in turns with the unsharded render on this card
            u = Renderer(scene, cam, cfg, dev)
            for _ in range(2):
                u.render()
            out["primary_unsharded_same"] = all(
                np.array_equal(a, b) for a, b in zip(u.last_accumulators,
                                                     acc))
            walls = {"sharded": [], "unsharded": []}
            for i in range(FULL_REPS):
                for label in (("sharded", "unsharded") if i % 2 == 0
                              else ("unsharded", "sharded")):
                    walls[label].append(render(
                        r if label == "sharded" else u)[0])
            out["primary_walls"] = np.array(walls["sharded"])
            out["primary_unsharded_walls"] = np.array(walls["unsharded"])
            pdist.COLLECTIVES.update(calls=0, bytes=0)
            before = passes_run(r)
            prof = profile_call(r.render, device=dev)
            out["primary_passes"] = passes_run(r) - before
            out["primary_collectives"] = pdist.COLLECTIVES["calls"]
            out["primary_collective_bytes"] = pdist.COLLECTIVES["bytes"]
            out["primary_host_launches"] = prof.host_launches
            out["primary_busy"] = prof.device_ms / (1e3 * prof.wall)
            out["primary_device_ms"] = prof.device_ms
            out["primary_nccl_ms"] = prof.nccl_ms
            out["primary_profiled_s"] = prof.wall
            runners = list(r._pass_fns.values())
            out["primary_capture_s"] = sum(
                c.capture_seconds for p in runners
                for c in (p.call, p.accumulate))
    if "full_step" in checks:
        _, _, _, (params, scene, bh, rays, target, cfg) = full_setup(dev)
        step = diff.LossAndGrad(scene, bh, cfg, rays, target, mesh=mesh)
        gen = lambda i: prng.key(i, dev)
        equal, calls, runs, launches, walls = [], [], [], [], []
        for i in range(STEP_CALLS):
            p = step_params(params, i)
            tk.reset_counts()
            wall, (loss, g) = _wall(lambda: step(p, gen(i)), dev)
            walls.append(wall)
            calls.append(step.trace_calls)
            runs.append(tk.kernel_runs())
            launches.append(tk.LAUNCHES)
            want = diff.loss_and_grad(p, scene, bh, rays, target, cfg,
                                      gen(i), mesh=mesh)
            equal.append(torch.equal(loss, want[0]) and all(
                torch.equal(a, b) for a, b in zip(g.leaves(),
                                                  want[1].leaves())))
        for f, v in zip(("loss",) + _LEAVES, (loss, *g.leaves())):
            out[f"step_{f}"] = v.cpu().numpy()
        p = step_params(params, STEP_CALLS - 1)
        replays = [_wall(lambda: step(p, gen(0)), dev)[0]
                   for _ in range(FULL_REPS)]
        out.update(step_equal=equal, step_calls=calls, step_kernel_runs=runs,
                   step_launches=launches, step_walls=np.array(walls),
                   step_replay_walls=np.array(replays),
                   step_graphs=step.graphs,
                   step_capture_s=step.call.capture_seconds
                   + step.update.capture_seconds)
    if "full_kerr" in checks:
        # in turns with the unsharded frame on this card; every frame
        # captures its march blocks anew
        walls = {"sharded": [], "unsharded": []}
        imgs = []
        for label in ("sharded", "unsharded", "unsharded", "sharded"):
            wall, img = _wall(lambda: full_kerr(
                dev, sharding if label == "sharded" else None), dev)
            walls[label].append(wall)
            imgs.append(img)
        out.update(kerr=imgs[0], kerr_same=all(np.array_equal(a, imgs[0])
                                               for a in imgs),
                   kerr_walls=np.array(walls["sharded"]),
                   kerr_unsharded_walls=np.array(walls["unsharded"]))
    if "mesh_trace" in checks:
        from rrt_tpu_torch.tools.scaling_bench import forward_case
        for kind in ("flat", "curved"):
            row = forward_case(mesh, MESH_TRACE_SIZE, kind == "curved")
            out[f"mesh_trace_{kind}"] = json.dumps(row)
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rrt_tpu_torch.parallel.worker")
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port")
    ap.add_argument("out")
    ap.add_argument("size", nargs="?", default="16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--checks", default="",
                    help="comma-separated: " + ",".join(CHECKS + CARD_CHECKS))
    args = ap.parse_args(argv)
    checks = [c for c in args.checks.split(",") if c]
    if not set(checks) <= set(CHECKS + CARD_CHECKS):
        ap.error(f"--checks takes {','.join(CHECKS + CARD_CHECKS)}")
    if set(checks) & set(CARD_CHECKS) and \
            torch.device(args.device).type != "cuda":
        ap.error(f"{','.join(CARD_CHECKS)} run on cards only")

    from rrt_tpu_torch.parallel import distributed as pdist
    from rrt_tpu_torch.render.integrator import Forward, est_radiance
    from rrt_tpu_torch.types import Rays

    pdist.initialize(coordinator_address=f"127.0.0.1:{args.port}",
                     num_processes=args.nproc, process_id=args.pid,
                     backend=args.backend, device=args.device)
    if pdist.process_count() != args.nproc:
        raise RuntimeError(f"world {pdist.process_count()}, not {args.nproc}")
    mesh = pdist.global_mesh(args.device)
    w, h = frame_size(args.size)
    scene, bh, tab, cfg, rays_full = forward_setup(w, h, mesh.device)
    n = w * h
    lo, hi = args.pid * n // args.nproc, (args.pid + 1) * n // args.nproc
    local = Rays(o=rays_full.o[lo:hi].cpu(), d=rays_full.d[lo:hi].cpu(),
                 min_t=rays_full.min_t[lo:hi].cpu(),
                 max_t=rays_full.max_t[lo:hi].cpu())
    rays, (glo, ghi, ng) = pdist.make_global_batch(local, mesh)
    if (glo, ghi, ng) != (lo, hi, n):
        raise RuntimeError(f"global window {(glo, ghi, ng)}, not "
                           f"{(lo, hi, n)}")

    # the forward is compiled on a card (the JAX worker jits it): its
    # first call eager, its second captured, later calls replayed
    forward = Forward(scene, bh, rays, cfg, tab, window=(lo, hi, n))

    key = prng.key(0, mesh.device)

    def fwd():
        return forward(key)[0]

    for _ in range(2):
        fwd()
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else (lambda: None))
    dts = []
    for _ in range(FWD_REPS):
        sync()
        t0 = time.perf_counter()
        local_rows = fwd()
        sync()
        dts.append(time.perf_counter() - t0)
    dt = float(np.median(dts))
    local_rows = local_rows.cpu().numpy()
    # the whole frame in this process alone: its rows [lo, hi)
    whole = est_radiance(scene, bh, rays_full, cfg, key,
                         tab)[0].cpu().numpy()
    err = float(np.abs(local_rows - whole[lo:hi]).max()) if hi > lo else 0.0
    np.testing.assert_allclose(local_rows, whole[lo:hi], rtol=2e-5,
                               atol=2e-6)
    extra = run_checks(checks, w, h, mesh, args.out + ".png")
    extra.update(run_card_checks([c for c in checks if c in CARD_CHECKS],
                                 mesh, w, h))
    from rrt_tpu_torch.ops.build import BUILD_LOG
    np.savez(args.out, local=local_rows, lo=lo, hi=hi, dt=dt, dts=dts,
             nproc=pdist.process_count(), ndev=mesh.world, max_err=err,
             build_cached=BUILD_LOG.get("trace", {}).get("cached", False),
             **extra)
    pdist.all_processes_done()
    print(f"p{args.pid}: OK lanes=[{lo},{hi}) dt={dt:.4f}s max_err={err:.3g} "
          f"world={mesh.world} {mesh.backend} on {mesh.device}"
          + (f" checks={','.join(checks)}" if checks else ""), flush=True)
    pdist.shutdown()


if __name__ == "__main__":
    main()
