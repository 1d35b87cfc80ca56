"""The inputs the benchmark makes and hands to both sides: the scene
description, the render settings, the frame seeds, the pixel sample.

A configuration's scene is a COLLADA file under the benchmark
(`scenes/`), optionally with its spheres replaced by a UV-sphere mesh
that the benchmark makes here (`mesh`: stacks, slices, centre, radius).
Each side parses the file with its own parser and gets the same mesh
arrays; `collada` is the side's module (the program's
`rrt_tpu_torch.io.collada` or the reference's `cardbench.ref.collada`,
which share their types' names).
"""
from __future__ import annotations

import numpy as np

from cardbench.harness import CHECKOUT
from cardbench.ref.scenes import uv_sphere

# frames of one run: frame i renders with the seed (run seed) · 2**16 + i
FRAME_SEED_SHIFT = 16


def scene_info(collada, spec: dict):
    """The configuration's scene (`spec` = config["scene"]) as a
    `collada.SceneInfo` of the side's module."""
    info = collada.load(str(CHECKOUT / spec["file"]))
    mesh = spec.get("mesh")
    if mesh:
        white = info.find(collada.SphereInfo)[0].instance.material
        verts, polys = uv_sphere(mesh["stacks"], mesh["slices"],
                                  tuple(mesh["center"]), mesh["radius"])
        node = collada.Node(transform=np.eye(4), name="mesh",
                            instance=collada.PolymeshInfo(
                                vertices=verts, polygons=polys,
                                material=white))
        info.nodes = [n for n in info.nodes
                      if not isinstance(n.instance, collada.SphereInfo)] \
            + [node]
    return info


def render_config(config_mod, conf: dict, **over):
    """The side's `RenderConfig` (`config_mod`: the program's
    `rrt_tpu_torch.utils.config` or the reference's `cardbench.ref.config`)
    at the configuration's settings, `over` replacing any."""
    h = conf["hole"]
    kw = dict(width=conf["width"], height=conf["height"], ns_aa=conf["spp"],
              ns_area_light=conf["area_light_samples"],
              max_ray_depth=conf["max_ray_depth"],
              black_hole=config_mod.BlackHoleConfig(
                  position=tuple(h["position"]), radius=h["radius"],
                  delta_theta=h["delta_theta"]))
    kw.update(over)
    return config_mod.RenderConfig(**kw)


def check_pixels(mix: dict, conf: dict) -> int:
    """How many pixels a frame's check samples: the mix's budget of
    checked lanes over the configuration's samples a pixel."""
    return max(1, min(conf["width"] * conf["height"],
                      mix["check_lanes"] // conf["spp"]))


def frame_seed(seed: int, i: int) -> int:
    return (int(seed) << FRAME_SEED_SHIFT) + int(i)


def rng(seed: int, salt: int) -> np.random.Generator:
    """The run's generator for what it samples (`salt` tells the uses
    apart)."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, salt])


def pixel_centres(width: int, height: int, device):
    """(W·H, 2) screen coordinates of the pixels' centres, row-major."""
    import torch
    ys, xs = torch.meshgrid(
        (torch.arange(height, device=device) + 0.5) / height,
        (torch.arange(width, device=device) + 0.5) / width, indexing="ij")
    return torch.stack([xs, ys], dim=-1).reshape(-1, 2)


def target_image(seed: int, shape, scale: float, device):
    """The inverse-rendering target: uniforms in [0, scale) of `shape`,
    drawn on the device from the run's seed in one call."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return torch.rand(shape, generator=g, device=device) * scale


def step_seed(seed: int, i: int) -> int:
    """The key's seed of gradient step i of a run."""
    return frame_seed(seed, i)
