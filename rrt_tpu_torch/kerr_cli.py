"""Command line of the Kerr black hole with its accretion disk (BASELINE
config 5): `python -m rrt_tpu_torch.kerr_cli`. The port of
`rrt_tpu/kerr_cli.py`.

    python -m rrt_tpu_torch.kerr_cli -f kerr.png -r 1024 1024 --mass 1 \\
        --spin 0.9 --eye 0 3 22 --steps 600 -s 4

The flags are the JAX CLI's, plus --device (default cuda; without a card
it exits with an error, and the CPU renders only when asked for with
`--device cpu`). --sharded splits every batch's lanes over the ranks of
the process group that the RRT_COORDINATOR / RRT_NUM_PROCESSES /
RRT_PROCESS_ID variables describe (one process per device; a world of 1
without them); rank 0 writes the image.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from rrt_tpu_torch.convert import disk_from_arrays, kerr_params_from_arrays
from rrt_tpu_torch.render import film
from rrt_tpu_torch.render import kerr_scene as K


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rrt_tpu_torch.kerr_cli")
    p.add_argument("-f", dest="outfile", default="kerr.png")
    p.add_argument("-r", nargs=2, type=int, default=[512, 512],
                   metavar=("W", "H"))
    p.add_argument("-s", dest="spp", type=int, default=1)
    p.add_argument("-e", dest="envmap", default=None, help=".exr envmap")
    p.add_argument("--mass", type=float, default=1.0)
    p.add_argument("--spin", type=float, default=0.9)
    p.add_argument("--disk", nargs=2, type=float, default=[3.0, 12.0],
                   metavar=("R_IN", "R_OUT"))
    p.add_argument("--no-beaming", action="store_true")
    p.add_argument("--eye", nargs=3, type=float, default=[0.0, 3.0, 22.0])
    p.add_argument("--fov", type=float, default=30.0)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sharded", action="store_true",
                   help="lane-shard batches over the processes of the "
                        "RRT_* group (parallel/sharding mesh)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    return p


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("CUDA is not available; pass --device cpu to render "
                     "on the CPU")
    sharding, joined = None, False
    if args.sharded:
        from rrt_tpu_torch.parallel import distributed as pdist
        from rrt_tpu_torch.parallel import sharding as sh
        joined = not pdist.is_initialized() \
            and pdist.initialize_from_env(device=device.type)
        mesh = sh.make_mesh(device)
        device = mesh.device
        sharding = sh.batch_sharding(mesh)
        print(f"[KerrTracer] lane-sharded over {mesh.world} device(s)")
    env = None
    if args.envmap:
        from rrt_tpu_torch.io.exr import read_exr
        from rrt_tpu_torch.scene.envmap import build_envmap
        env = build_envmap(read_exr(args.envmap), device)
    bh = kerr_params_from_arrays((0.0, 0.0, 0.0), args.mass, args.spin,
                                 device)
    disk = disk_from_arrays(args.disk[0], args.disk[1], (1.0, 0.85, 0.6),
                            2.0, not args.no_beaming, device)
    w, h = args.r
    print(f"[KerrTracer] {w}x{h}, {args.spp} spp, M={args.mass}, "
          f"a={args.spin}, steps={args.steps}, device {device}")
    t0 = time.time()
    img = K.render_image(w, h, bh, disk, eye=tuple(args.eye),
                         fov_deg=args.fov, env=env, spp=args.spp,
                         seed=args.seed, n_steps=args.steps, device=device,
                         sharding=sharding)
    dt = time.time() - t0
    n_rays = w * h * args.spp
    print(f"[KerrTracer] {dt:.1f}s — {n_rays / dt:.3g} rays/s, "
          f"{n_rays * args.steps / dt:.3g} RK4 steps/s")
    if sharding is None or sharding.mesh.rank == 0:
        film.save_image(args.outfile, img[::-1])
        print(f"[KerrTracer] Saved {args.outfile}")
    if sharding is not None:
        pdist.all_processes_done("image")
    if joined:
        pdist.shutdown()
    return img


if __name__ == "__main__":
    main()
    sys.exit(0)
