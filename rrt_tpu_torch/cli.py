"""Command-line entry point of the port: `python -m rrt_tpu_torch.cli`.

The flags are those of `rrt_tpu.cli` (reference main.cpp:28-150) that the
port serves: -s -l -t -m -e -f -r -c -a -H -b -d -B, --flat, --illum,
--seed and --thin-lens, plus --device (default cuda; without a card the CLI
exits with an error, and the CPU renders only when asked for with
`--device cpu`). The JAX package's other flags are refused with an error
that says they are not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from rrt_tpu_torch.io.exr import read_exr
from rrt_tpu_torch.io.png import write_png
from rrt_tpu_torch.render.renderer import Renderer
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scene.envmap import build_envmap, probability_debug_image
from rrt_tpu_torch.utils.config import BlackHoleConfig, Illum, RenderConfig

# flags of rrt_tpu.cli that this port does not serve yet (see ROADMAP.md)
NOT_PORTED = {
    "-p": dict(nargs=4, dest="cell"),
    "--preview": dict(), "--preview-every": dict(),
    "--checkpoint": dict(), "--checkpoint-every": dict(),
    "--resume": dict(action="store_true"),
    "--serve": dict(nargs="?", const="8000"),
    "--serve-wait": dict(action="store_true"),
    "--dump-accel": dict(), "--dump-rays": dict(),
}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rrt_tpu_torch",
        description="relativistic path tracer, PyTorch/CUDA port")
    p.add_argument("scene", help="COLLADA .dae scene file")
    p.add_argument("-s", type=int, default=1, dest="ns_aa")
    p.add_argument("-l", type=int, default=1, dest="ns_area_light")
    p.add_argument("-t", type=int, default=1, dest="threads",
                   help="accepted for compatibility; unused")
    p.add_argument("-m", type=int, default=1, dest="max_ray_depth")
    p.add_argument("-e", dest="envmap", default=None,
                   help="environment map (.exr)")
    p.add_argument("-f", dest="outfile", default="out.png")
    p.add_argument("-r", nargs=2, type=int, default=[800, 600],
                   metavar=("W", "H"))
    p.add_argument("-c", dest="cam_settings", default=None)
    p.add_argument("-a", nargs=2, default=None, metavar=("BATCH", "TOL"))
    p.add_argument("-H", dest="hemisphere", action="store_true")
    p.add_argument("-b", type=float, default=0.25, dest="lens_radius")
    p.add_argument("-d", type=float, default=4.7, dest="focal_distance")
    p.add_argument("-B", nargs=5, type=float, default=None,
                   metavar=("X", "Y", "Z", "R", "DTHETA"))
    p.add_argument("--flat", action="store_true",
                   help="disable black-hole ray bending")
    p.add_argument("--illum", type=int, default=Illum.FULL)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--thin-lens", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; `cpu` runs the plain "
                        "PyTorch traversal)")
    for flag, kw in NOT_PORTED.items():
        p.add_argument(flag, default=None, help=argparse.SUPPRESS, **kw)
    return p


def config_from_args(args) -> RenderConfig:
    if args.B is not None:
        bh = BlackHoleConfig(position=tuple(args.B[:3]), radius=args.B[3],
                             delta_theta=args.B[4], enabled=not args.flat)
    else:
        bh = BlackHoleConfig(enabled=not args.flat)
    adaptive = args.a is not None
    spb, tol = (int(args.a[0]), float(args.a[1])) if adaptive else (32, 0.05)
    return RenderConfig(
        ns_aa=args.ns_aa, ns_area_light=args.ns_area_light,
        max_ray_depth=args.max_ray_depth, width=args.r[0], height=args.r[1],
        samples_per_batch=spb, max_tolerance=tol, adaptive=adaptive,
        direct_hemisphere_sample=args.hemisphere,
        lens_radius=args.lens_radius, focal_distance=args.focal_distance,
        thin_lens=args.thin_lens, illum=args.illum, black_hole=bh,
        seed=args.seed)


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    for flag, kw in NOT_PORTED.items():
        dest = kw.get("dest") or flag.lstrip("-").replace("-", "_")
        if getattr(args, dest) not in (None, False):
            parser.error(f"{flag} is not yet ported to rrt_tpu_torch "
                         "(see ROADMAP.md)")
    cfg = config_from_args(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("CUDA is not available; pass --device cpu to render "
                     "on the CPU")
    print(f"[PathTracer] Device: {device}")

    env = None
    if args.envmap:
        print(f"[PathTracer] Loading environment map {args.envmap}")
        env = build_envmap(read_exr(args.envmap), device)
        # the reference writes it on every env-light init
        # (environment_light.cpp:44-47), into the working directory
        write_png("probability_debug.png", probability_debug_image(env))

    print(f"[PathTracer] Input scene file: {args.scene}")
    t0 = time.time()
    scene, camera = load_scene(args.scene, device, cfg.width, cfg.height,
                               env=env)
    print(f"[PathTracer] Scene loaded ({time.time() - t0:.2f} sec), "
          f"{scene.n_tris} tri rows, {scene.n_spheres} sphere rows")
    if args.cam_settings:
        camera.load_settings(args.cam_settings)
        print(f"[Camera] Loaded settings from {args.cam_settings}")
    camera.lens_radius = cfg.lens_radius
    camera.focal_distance = cfg.focal_distance

    renderer = Renderer(scene, camera, cfg, device)

    def progress(done, total):
        sys.stdout.write(f"\r[PathTracer] Rendering... {100.0 * done / total:.0f}%")
        sys.stdout.flush()

    t0 = time.time()
    renderer.render_to_file(args.outfile, progress=progress)
    dt = time.time() - t0
    print(f"\n[PathTracer] Rendering complete, {dt:.2f} sec")
    print(renderer.stats(dt).report())
    print(f"[PathTracer] Phases: {renderer.timer.report()}")
    print(f"[PathTracer] Saved to {args.outfile}")
    return renderer


if __name__ == "__main__":
    main()
    sys.exit(0)
