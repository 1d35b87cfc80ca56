"""One rank of the multi-process check and of `tools/scaling_bench.py`
(the port of tests/mp_worker.py).

    python -m rrt_tpu_torch.parallel.worker PID NPROC PORT OUT.npz [SIZE]
        [--device cpu|cuda] [--backend gloo|nccl] [--checks render,...]

SIZE is W or WxH (default 16). Each rank joins a process group of NPROC
ranks at 127.0.0.1:PORT, takes its contiguous share of a frame's centred
camera rays through `make_global_batch`, and estimates their radiance as
its block of the whole batch (`LaneWindow` draws; flat spacetime, 1 spp,
-l 1, -m 2, as the JAX worker). It then estimates the whole frame in
this process alone and holds its rows to rtol 2e-5, atol 2e-6, as the
JAX worker does (the windowed draws make them equal), and writes OUT.npz
with `local, lo, hi, dt, nproc, ndev` and the max error.

`--checks` adds sharded runs whose results go into OUT.npz for the caller
to hold against a single-process run (`reference`):
  render — a curved GI render (2 spp, one sample a pass, -l 1, -m 3)
           with `Renderer(sharding=)`: its accumulators, trace calls, the
           trace kernel's Python launches and its own count of its runs;
  stop   — the same render with `stop_after=1` on the last rank only;
  grad   — `loss_and_grad(mesh=)` of that frame's camera rays;
  step   — `LossAndGrad(mesh=)` of the same problem called three times
           with moved params and a new seed each (on a card the first
           call eager, the second captured and replayed, the third
           replayed; on the CPU all eager): each call against
           `loss_and_grad(mesh=)` bit for bit, its trace calls and the
           kernel's runs, and the last call's loss and gradients;
  kerr   — a 32×32, 80-step Kerr image with `render_image(sharding=)`;
  cli    — `kerr_cli --sharded` at the same settings.
The renders, the step and the Kerr march take the defaults: CUDA graphs
on a card, around their collectives.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

CHECKS = ("render", "stop", "grad", "step", "kerr", "cli")
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


# the step check's calls; call i draws from a generator seeded with i
STEP_CALLS = 3
# the ranks whose step `reference` sums
STEP_RANKS = 2


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


def reference(checks, w: int, h: int, device, tmp_png: str) -> dict:
    """The single-process results of `checks`, keyed as the worker writes
    the sharded ones, for a world of STEP_RANKS. The step's last call is
    the two ranks' shares (`loss_and_grad` over a `LaneMesh` of each rank
    without a group) added: the all-reduce's sum bit for bit, since a sum
    of two floats does not depend on their order (a sum of three or more
    would)."""
    from rrt_tpu_torch.parallel.sharding import LaneMesh
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
                                     torch.Generator(device).manual_seed(0))
        out["grad_loss"] = loss.cpu().numpy()
        for f, v in zip(_LEAVES, g.leaves()):
            out[f"grad_{f}"] = v.cpu().numpy()
    if "step" in checks:
        bh, params, rays, target = grad_setup(scene, cam, cfg, device)
        i = STEP_CALLS - 1
        p, loss, grads = step_params(params, i), None, None
        for rank in range(STEP_RANKS):
            mesh = LaneMesh(None, rank, STEP_RANKS, torch.device(device),
                            None)
            l, g = diff.loss_and_grad(p, scene, bh, rays, target, cfg,
                                      torch.Generator(device).manual_seed(i),
                                      mesh=mesh)
            loss = l if loss is None else loss + l
            grads = g.leaves() if grads is None else [
                a + b for a, b in zip(grads, g.leaves())]
        out["step_loss"] = loss.cpu().numpy()
        for f, v in zip(_LEAVES, grads):
            out[f"step_{f}"] = v.cpu().numpy()
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
                                     torch.Generator(dev).manual_seed(0),
                                     mesh=mesh)
        out["grad_loss"] = loss.cpu().numpy()
        for f, v in zip(_LEAVES, g.leaves()):
            out[f"grad_{f}"] = v.cpu().numpy()
    if "step" in checks:
        bh, params, rays, target = grad_setup(scene, cam, cfg, dev)
        step = diff.LossAndGrad(scene, bh, cfg, rays, target, mesh=mesh)
        gen = lambda i: torch.Generator(dev).manual_seed(i)
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
                    help="comma-separated: " + ",".join(CHECKS))
    args = ap.parse_args(argv)
    checks = [c for c in args.checks.split(",") if c]
    if not set(checks) <= set(CHECKS):
        ap.error(f"--checks takes {','.join(CHECKS)}")

    from rrt_tpu_torch.parallel import distributed as pdist
    from rrt_tpu_torch.parallel.sharding import LaneWindow
    from rrt_tpu_torch.render.integrator import est_radiance
    from rrt_tpu_torch.render.renderer import pass_generator
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

    def fwd():
        gen = LaneWindow(pass_generator(cfg.seed, 0, 0, mesh.device), lo, hi,
                         n)
        return est_radiance(scene, bh, rays, cfg, gen, tab)[0]

    fwd()
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    local_rows = fwd()
    sync()
    dt = time.perf_counter() - t0
    local_rows = local_rows.cpu().numpy()
    # the whole frame in this process alone: its rows [lo, hi)
    whole = est_radiance(scene, bh, rays_full, cfg,
                         pass_generator(cfg.seed, 0, 0, mesh.device),
                         tab)[0].cpu().numpy()
    err = float(np.abs(local_rows - whole[lo:hi]).max()) if hi > lo else 0.0
    np.testing.assert_allclose(local_rows, whole[lo:hi], rtol=2e-5,
                               atol=2e-6)
    extra = run_checks(checks, w, h, mesh, args.out + ".png")
    np.savez(args.out, local=local_rows, lo=lo, hi=hi, dt=dt,
             nproc=pdist.process_count(), ndev=mesh.world, max_err=err,
             **extra)
    pdist.all_processes_done()
    print(f"p{args.pid}: OK lanes=[{lo},{hi}) dt={dt:.4f}s max_err={err:.3g} "
          f"world={mesh.world} {mesh.backend} on {mesh.device}"
          + (f" checks={','.join(checks)}" if checks else ""), flush=True)
    pdist.shutdown()


if __name__ == "__main__":
    main()
