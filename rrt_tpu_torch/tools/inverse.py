"""Closed-loop inverse rendering (BASELINE config 4): recover a parameter
from a target rendered with its true value, by gradient descent on the L2
image loss (the port of tests/test_inverse.py's two loops), on the in-repo
Cornell box.

Both loops frame the box: their rays pass through the central part of the
native-FoV frame (`RADIUS_FRAME`, `ALBEDO_FRAME` of its width). The
in-repo scene's wide xfov (76°, chosen for the reference's FoV rule at
256²) leaves the whole frame to the box only at that size; at a native
32×32 the box covers 7% of it and 0.5% of the pixels are lit, where the
reference scene's own camera fills the frame with its box. The loops are
otherwise config 4's:

* radius: 32×32 curved global illumination (-m 2, -l 1); `bh_radius`
  starts at 0.14 (true 0.1), 40 steps of lr 2.0, clipped to [0.01, 0.5].
  On this box the loss moves with r mostly through discrete events (a
  shadow ray leaving through the ceiling's opening or not, a path
  switching surfaces), which carry no gradient, so whether the loop
  recovers the radius depends on the seed, in the JAX package as here:
  at this framing some seeds settle within 0.015 of the truth and others
  wander off. The loop runs at `RADIUS_SEED`, one that recovers; torch's
  CPU and CUDA generators draw different streams, so the seed is chosen
  per device. `radius_sweep` puts the autodiff gradient beside the loss's
  finite-difference slope;
* albedo: the red wall's reflectance row from a 48×48 flat direct-lit
  target (the default hole starves direct light of signal); the row
  starts at (0.3, 0.4, 0.4), 120 steps of lr 60, clipped to [0, 1], at
  seed `SEED`.

Every loss evaluation takes a fresh generator of the same seed, so that
the objective is deterministic. Each loop (and the sweep) runs its steps
through one `diff.LossAndGrad`: on a card its first step runs eagerly,
its second is captured as a CUDA graph, and every later step replays it
(the counterpart of the jitted `value_and_grad` of tests/test_inverse.py);
with `graphs=False` every step runs eagerly, with the same results.
`python3 chip_smoke.py` runs both loops on the card both ways; `python -m
rrt_tpu_torch.tools.inverse [--device D] [--seeds S ...] [--frame F]`
prints the sweep, the radius loop for each seed and the albedo loop.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from rrt_tpu_torch.render import diff
from rrt_tpu_torch.render.renderer import make_black_hole
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.utils.config import BlackHoleConfig, Illum, RenderConfig

SEED = 7
RADIUS_SEED = {"cpu": 1, "cuda": 0}   # seeds at which the radius recovers
RADIUS_FRAME = 0.65     # the share of the native frame the radius rays span
ALBEDO_FRAME = 0.3      # the same for the albedo loop
RED_WALL = (0.65, 0.05, 0.05)   # the in-repo box's red wall reflectance
RADIUS_START, RADIUS_STEPS, RADIUS_LR = 0.14, 40, 2.0
RADIUS_CLIP = (0.01, 0.5)
ALBEDO_START, ALBEDO_STEPS, ALBEDO_LR = (0.3, 0.4, 0.4), 120, 60.0


def pixel_rays(cam, w: int, h: int, device, frame: float = 1.0):
    """One camera ray through every pixel centre, row-major, over the
    central `frame` of the camera's frame."""
    ys, xs = torch.meshgrid((torch.arange(h, device=device) + 0.5) / h,
                            (torch.arange(w, device=device) + 0.5) / w,
                            indexing="ij")
    xy = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
    return cam.generate_rays(0.5 + (xy - 0.5) * frame)


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def radius_setup(device):
    """(params, scene, hole, rays, cfg) of the radius loop."""
    w = h = 32
    cfg = RenderConfig(width=w, height=h, ns_aa=1, ns_area_light=1,
                       max_ray_depth=2, seed=0)
    scene, cam = load_scene(CBOX_SPHERES, device, w, h, fov_mode="native")
    bh = make_black_hole(cfg, device)
    return (diff.params_from_scene(scene, bh), scene, bh,
            pixel_rays(cam, w, h, device, RADIUS_FRAME), cfg)


def _loop(params, scene, bh, rays, cfg, device, steps, update, seed,
          graphs=None):
    """Render the target from `params`, then `steps` gradient steps from
    `update(params)`'s start through one `diff.LossAndGrad` (on a card a
    CUDA graph captured at its second step, unless `graphs` is False),
    each followed by `update(params, grads)`."""
    with torch.no_grad():
        target = diff.render_radiance(params, scene, bh, rays, cfg,
                                      _gen(device, seed))
    step = diff.LossAndGrad(scene, bh, cfg, rays, target, graphs=graphs)
    p = update(params, None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        _, g = step(p, _gen(device, seed))
        p = update(p, g)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return p, 1e3 * (time.perf_counter() - t0) / steps


def _radius_seed(device, seed):
    return RADIUS_SEED[device.type] if seed is None else seed


def recover_radius(device, seed=None, graphs=None):
    """Returns (recovered radius, true radius, ms per step); `seed`
    defaults to the device's `RADIUS_SEED`; `graphs` as `_loop`'s."""
    device = torch.device(device)
    seed = _radius_seed(device, seed)
    params, scene, bh, rays, cfg = radius_setup(device)

    def update(p, g):
        r = (torch.full_like(p.bh_radius, RADIUS_START) if g is None
             else torch.clamp(p.bh_radius - RADIUS_LR * g.bh_radius,
                              *RADIUS_CLIP))
        return p.replace(bh_radius=r)
    p, ms = _loop(params, scene, bh, rays, cfg, device, RADIUS_STEPS,
                  update, seed, graphs)
    return float(p.bh_radius), float(params.bh_radius), ms


def radius_sweep(device, radii, seed=None):
    """The radius loop's loss and its autodiff gradient at each radius:
    a list of (radius, loss, d loss / d radius), all through one
    `diff.LossAndGrad`."""
    device = torch.device(device)
    seed = _radius_seed(device, seed)
    params, scene, bh, rays, cfg = radius_setup(device)
    with torch.no_grad():
        target = diff.render_radiance(params, scene, bh, rays, cfg,
                                      _gen(device, seed))
    step = diff.LossAndGrad(scene, bh, cfg, rays, target)
    rows = []
    for r in radii:
        p = params.replace(bh_radius=torch.full_like(params.bh_radius, r))
        loss, g = step(p, _gen(device, seed))
        rows.append((float(r), float(loss), float(g.bh_radius)))
    return rows


def albedo_setup(device):
    """(params, scene, rays, cfg, row) of the albedo loop: flat direct
    light at 48×48, and the red wall's row of the reflectance table."""
    w = h = 48
    cfg = RenderConfig(width=w, height=h, ns_aa=1, ns_area_light=1,
                       max_ray_depth=1, seed=0, illum=Illum.DIRECT,
                       black_hole=BlackHoleConfig(enabled=False))
    scene, cam = load_scene(CBOX_SPHERES, device, w, h, fov_mode="native")
    params = diff.params_from_scene(scene, None)
    rows = torch.nonzero(torch.all(torch.isclose(
        params.reflectance, torch.tensor(RED_WALL, device=device)), dim=-1))
    if rows.shape[0] != 1:
        raise ValueError(f"{rows.shape[0]} rows of reflectance {RED_WALL}")
    return (params, scene, pixel_rays(cam, w, h, device, ALBEDO_FRAME), cfg,
            int(rows[0, 0]))


def recover_albedo(device, seed: int = SEED, graphs=None):
    """Returns (recovered row, true row, ms per step) of the red wall;
    `graphs` as `_loop`'s."""
    device = torch.device(device)
    params, scene, rays, cfg, row = albedo_setup(device)

    def update(p, g):
        if g is None:
            r = p.reflectance.clone()
            r[row] = torch.tensor(ALBEDO_START, device=device)
        else:
            r = torch.clamp(p.reflectance - ALBEDO_LR * g.reflectance, 0.0,
                            1.0)
        return p.replace(reflectance=r)
    p, ms = _loop(params, scene, None, rays, cfg, device, ALBEDO_STEPS,
                  update, seed, graphs)
    return (p.reflectance[row].cpu().numpy(),
            np.asarray(RED_WALL, np.float32), ms)


def main(argv=None):
    global RADIUS_FRAME
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="radius loop seeds (default: the device's "
                    "RADIUS_SEED)")
    ap.add_argument("--frame", type=float, default=RADIUS_FRAME,
                    help="the share of the native frame the radius rays "
                    "span")
    args = ap.parse_args(argv)
    RADIUS_FRAME = args.frame
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("inverse: no CUDA device (pass --device cpu)")
    radii = np.round(np.arange(0.08, 0.1201, 0.005), 4)
    rows = radius_sweep(args.device, radii)
    print("radius  loss        autodiff    slope to the next radius")
    for (r, loss, g), nxt in zip(rows, rows[1:] + [None]):
        slope = "" if nxt is None else f"{(nxt[1] - loss) / (nxt[0] - r):+.4e}"
        print(f"{r:.4f}  {loss:.4e}  {g:+.4e}  {slope}")
    for seed in args.seeds or [None]:
        r, true, ms = recover_radius(args.device, seed)
        seed = _radius_seed(torch.device(args.device), seed)
        print(f"radius loop, seed {seed}: {RADIUS_START} -> {r:.5f} "
              f"(true {true:.5f}), {ms:.1f} ms per step")
    got, true, ms = recover_albedo(args.device)
    print(f"albedo loop: {got.tolist()} (true {true.tolist()}), max err "
          f"{float(np.abs(got - true).max()):.4f}, {ms:.1f} ms per step")


if __name__ == "__main__":
    main()
