"""Run one BASELINE config end to end and print a stats JSON line (the port
of tools/run_config.py):

    python -m rrt_tpu_torch.tools.run_config SCENE --size 512 512 --spp 64 \\
        -l 1 -m 5 [--backend auto|kernel|plain] [--flat] [--out x.png] \\
        [--seed 0] [--max-pass-lanes N] [--device cuda|cpu]

SCENE is a .dae file or the name of a procedural scene of
`rrt_tpu_torch.scenes` (`cbox_dense`). The render runs on the card; the
CPU only with `--device cpu`. The first pass, and on a card the pass that
captures it as a CUDA graph, are timed apart from the rest (the render
waits for the device after them: the kernel's build, its first launches
and the capture, up to the progress report after them) and the rates are
over the steady passes alone; a render without a steady pass is rendered
again, its passes all warm. The JSON line
has the JAX tool's keys (wall, first pass, steady seconds, camera, marched
and geodesic-step rates, total traces, mean radiance), plus the device,
the trace calls of a render and the trace kernel's runs in it, as the
kernel counted them on the device (`trace_kernel.kernel_runs`), replays
included.

The ROADMAP's configurations on in-repo scenes (`CONFIGS`):
  1. the Cornell box, 256×256, 4 spp, direct lighting (-m 1 -l 1);
  2. `cbox_dense` (CBbunny-shaped), 512×512, 64 spp, GI, -m 5 -l 1;
  3. `scenes/cbox_mirror_glass.dae` (a mirror and a glass sphere),
     512×512, 64 spp, -m 5 -l 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from rrt_tpu_torch.scenes import CBOX_MIRROR_GLASS, CBOX_SPHERES, cbox_dense

PROCEDURAL = {"cbox_dense": cbox_dense}

CONFIGS = {
    1: [CBOX_SPHERES, "--size", "256", "256", "--spp", "4", "-l", "1",
        "-m", "1"],
    2: ["cbox_dense", "--size", "512", "512", "--spp", "64", "-l", "1",
        "-m", "5"],
    3: [CBOX_MIRROR_GLASS, "--size", "512", "512", "--spp", "64", "-l", "1",
        "-m", "5"],
}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rrt_tpu_torch.tools.run_config")
    ap.add_argument("scene")
    ap.add_argument("--size", type=int, nargs=2, default=[512, 512])
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("-l", "--light-samples", type=int, default=1)
    ap.add_argument("-m", "--depth", type=int, default=5)
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "kernel", "plain"))
    ap.add_argument("--flat", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-pass-lanes", type=int, default=None,
                    help="cap lanes per pass")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    return ap


def load(scene: str, device, w: int, h: int):
    """(scene, camera) of a .dae path or a procedural scene's name."""
    from rrt_tpu_torch.scene.build import build_scene, load_scene
    if scene in PROCEDURAL:
        return build_scene(PROCEDURAL[scene](), device, w, h)
    return load_scene(scene, device, w, h)


def run(argv):
    """Render the config of `argv` (the command line's arguments). Returns
    (the JSON object, the HDR image, the stats report)."""
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.render.renderer import Renderer
    from rrt_tpu_torch.tools.trace_modes import backend
    from rrt_tpu_torch.utils.config import BlackHoleConfig, RenderConfig
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    w, h = args.size
    cfg = RenderConfig(
        width=w, height=h, ns_aa=args.spp, ns_area_light=args.light_samples,
        max_ray_depth=args.depth, seed=args.seed,
        black_hole=BlackHoleConfig(enabled=not args.flat),
        **({"max_pass_lanes": args.max_pass_lanes}
           if args.max_pass_lanes else {}))
    scene, cam = load(args.scene, device, w, h)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    with backend(args.backend, device):
        # the plain traversal reads the host inside a pass, so it cannot be
        # captured; a replay would not call the swapped-in function anyway
        r = Renderer(scene, cam, cfg, device,
                     graphs=False if args.backend == "plain" else None)
        tk.reset_counts()
        marks = {}           # seconds since t0 at each pass's report

        def progress(s, total):
            marks[s] = time.perf_counter() - t0
            print(f"# {s}/{total} samples t={marks[s]:.1f}s",
                  file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        hdr, _ = r.render(progress=progress)
        sync()
        wall = time.perf_counter() - t0
        launches, calls = tk.kernel_runs(), r.last_trace_calls
        st = r.stats(wall)
        compile_s = marks.get(r.last_warm_samples, 0.0)
        steady = wall - compile_s
        steady_rays = (r.samples_done - r.last_warm_samples) * w * h
        if steady_rays == 0:     # no steady pass: render again, warm
            t1 = time.perf_counter()
            r.render()
            sync()
            steady = time.perf_counter() - t1
            steady_rays = r.samples_done * w * h
    share = steady_rays / max(st.camera_rays, 1)
    per_s = 1.0 / max(steady, 1e-9)
    out = {
        "scene": args.scene.rsplit("/", 1)[-1],
        "config": f"{w}x{h} {args.spp}spp l{args.light_samples} "
                  f"d{args.depth} {'flat' if args.flat else 'curved'}",
        "backend": args.backend,
        "wall_s": wall,
        "compile_s": compile_s,
        "steady_s": steady,
        "camera_rays_per_sec": steady_rays * per_s,
        "marched_rays_per_sec": st.total_rays * share * per_s,
        "geodesic_steps_per_sec": (st.total_rays * share
                                   * st.geodesic_segments_max * per_s),
        "total_traces": st.total_rays,
        "mean_radiance": float(hdr.mean()),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "trace_calls": calls,
        "launches": launches,
    }
    return out, hdr, st.report()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = build_argparser().parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("run_config: CUDA is not available; pass --device cpu to "
              "render on the CPU", file=sys.stderr)
        return 2
    out, hdr, report = run(argv)
    if args.out:
        from rrt_tpu_torch.render import film
        film.save_image(args.out, hdr)
    print(json.dumps(out))
    print("# " + report.replace("\n", " | "), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
