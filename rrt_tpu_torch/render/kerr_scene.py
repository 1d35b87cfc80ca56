"""Kerr black hole with an emissive accretion disk (BASELINE config 5; the
port of `rrt_tpu/render/kerr_scene.py`).

Camera rays are integrated through the Kerr metric (`physics/kerr.py`) and
shaded against a thin, opaque, Keplerian disk in the equatorial plane:

  * a disk crossing is a sign change of the spin-axis coordinate along a
    chord, within [r_in, r_out]; the first crossing wins;
  * emission I(r) ∝ (r_in/r)^q, boosted by g⁴, where g = E_obs/E_emit is
    the Doppler and gravitational factor of a circular Keplerian emitter
    (Ω = √M/(r^{3/2} + a√M)): the bright approaching side;
  * a captured ray is black; an escaped ray looks up the environment map
    along its final momentum (`scene/envmap.sample_dir`), or a soft
    gradient without one.

The JAX package runs this as one `lax.scan` over RK4 steps, jitted per
batch (rrt_tpu/render/kerr_scene.py:186); here it is a Python loop of
PyTorch ops over the steps, with a per-lane adaptive step. On a card
(`render_image`, sharded or not, unless `graphs=False`) the loop runs
through a `DiskMarch`: blocks of `MARCH_BLOCK` steps, each captured once
per batch shape as a CUDA graph (autograd's `_rhs` included) and
replayed, plus a block of the remaining steps; the march state is the
graphs' static buffers. The march equals the step-by-step loop bit for
bit. A sharded batch marches this rank's block so, and its one
collective, the gather of the blocks, runs eagerly after the march.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from rrt_tpu_torch.parallel.distributed import all_gather_lanes
from rrt_tpu_torch.parallel.sharding import pad_to_multiple, shard_batch
from rrt_tpu_torch.physics import kerr
from rrt_tpu_torch.scene import envmap as envlib
from rrt_tpu_torch.types import EnvMap, _Tensors
from rrt_tpu_torch.utils.graphs import CapturedCall

# march steps a captured block holds: a 1024² step launches ~840 kernels,
# so a block of 20 is a graph of ~17,000 nodes, and 600 steps (BASELINE
# config 5) or 300 make whole blocks
MARCH_BLOCK = 20


@dataclasses.dataclass
class DiskParams(_Tensors):
    r_in: torch.Tensor       # () inner radius (≥ ISCO for realism)
    r_out: torch.Tensor      # ()
    emission: torch.Tensor   # (3,) base radiance colour
    q: torch.Tensor          # () radial falloff exponent
    beaming: bool = True


def default_disk(mass: float = 1.0, device="cuda") -> DiskParams:
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return DiskParams(r_in=f32(3.0 * mass), r_out=f32(12.0 * mass),
                      emission=f32([1.0, 0.85, 0.6]), q=f32(2.0))


def _safe(v, eps=1e-20):
    return torch.clamp(v, min=eps)


def _doppler_g(x, y, p, mass, a):
    """g = E_obs/E_emit of a Keplerian circular emitter at (x, y, 0).

    The photon's E = −p_t = 1 (`init_momentum`'s normalisation) and
    L_z = x p_y − y p_x; the emitter's 4-velocity is u^t(1, 0, 0, Ω). The
    floors only keep lanes finite that the disk's extent masks anyway
    (inside r_isco, where no Keplerian emitter exists; see the JAX
    module)."""
    r = torch.sqrt(_safe(x * x + y * y))
    sq_m = torch.sqrt(mass)
    omega = sq_m / (r ** 1.5 + a * sq_m)
    ut_inner = 1.0 - 3.0 * mass / r + 2.0 * a * sq_m / r ** 1.5
    ut = 1.0 / torch.sqrt(torch.clamp(ut_inner, min=1e-3))
    lz = x * p[..., 1] - y * p[..., 0]
    denom = ut * (1.0 - omega * lz)
    return 1.0 / torch.clamp(denom, min=1e-3)


def _disk_step(st, acc, hit_disk, bh: kerr.KerrParams, disk: DiskParams,
               r_escape: float):
    """One march step against the disk: returns (state, acc, hit_disk)."""
    rh = bh.horizon_radius
    # adaptive step: fine near the hole, coarse far away
    r = torch.sqrt(kerr._kerr_r2(st.x[..., 0], st.x[..., 1], st.x[..., 2],
                                 bh.spin))
    dlam = torch.clamp(0.18 * (r - 0.5 * rh), 0.02, 2.0)
    frozen = st.captured | st.escaped | hit_disk
    dlam = torch.where(frozen, 0.0, dlam)
    st2, (xa, xb) = kerr.march_step(st, bh, dlam, r_escape)
    # disk crossing: the chord's z changes sign (hole frame)
    za, zb = xa[..., 2], xb[..., 2]
    crossing = (za * zb < 0.0) & ~frozen
    s = za / torch.where(torch.abs(za - zb) > 1e-20, za - zb, 1.0)
    cx = xa[..., 0] + s * (xb[..., 0] - xa[..., 0])
    cy = xa[..., 1] + s * (xb[..., 1] - xa[..., 1])
    cr = torch.sqrt(_safe(cx * cx + cy * cy))
    on_disk = crossing & (cr >= disk.r_in) & (cr <= disk.r_out)
    profile = (disk.r_in / cr) ** disk.q
    if disk.beaming:
        boost = _doppler_g(cx, cy, st2.p, bh.mass, bh.spin) ** 4
    else:
        boost = torch.ones_like(cr)
    radiance = disk.emission * (profile * boost)[..., None]
    acc = torch.where((on_disk & ~hit_disk)[..., None], radiance, acc)
    return st2, acc, hit_disk | on_disk


def trace_disk(o_world, d_world, bh: kerr.KerrParams, disk: DiskParams,
               n_steps: int = 600, r_escape: float = 45.0, march=None):
    """March world rays through the Kerr metric against the disk. Returns
    (final march state, disk radiance (..., 3), hit-disk mask). `march`
    (a `DiskMarch` of these parameters) runs the steps in captured
    blocks; without it they run one by one."""
    st = kerr.make_state(o_world, d_world, bh)
    acc = torch.zeros(st.pt.shape + (3,), dtype=o_world.dtype,
                      device=o_world.device)
    hit_disk = torch.zeros(st.pt.shape, dtype=torch.bool,
                           device=o_world.device)
    if march is not None:
        if not (march.bh is bh and march.disk is disk
                and march.r_escape == r_escape):
            raise ValueError("the DiskMarch was made for another hole, "
                             "disk or escape radius")
        return march(st, acc, hit_disk, n_steps)
    for _ in range(n_steps):
        st, acc, hit_disk = _disk_step(st, acc, hit_disk, bh, disk, r_escape)
    return st, acc, hit_disk


class DiskMarch:
    """`trace_disk`'s steps in blocks of `MARCH_BLOCK`, each block a CUDA graph
    captured once per (batch shape, steps) and replayed: the counterpart of
    the JAX package's jitted Kerr batch (rrt_tpu/render/kerr_scene.py:186).
    The march state (x, p, pt, captured, escaped), the disk radiance and
    the hit mask are the graphs' static buffers, one set per batch shape,
    updated in place; every block reads them and writes them back. The
    first run of a block runs eagerly, the second is captured and
    replayed, later runs replay; a block run once (the remainder of a
    single march) is never captured. The graphs share one memory pool and
    go away with the march."""

    def __init__(self, bh: kerr.KerrParams, disk: DiskParams,
                 r_escape: float = 45.0):
        self.bh, self.disk, self.r_escape = bh, disk, r_escape
        self._pool = None
        self._buffers = {}   # batch shape -> static buffers
        self.calls = {}      # (batch shape, steps) -> CapturedCall

    def _run(self, bufs, steps: int):
        x, p, pt, cap, esc, acc, hit = bufs
        st = kerr.MarchState(x, p, pt, cap, esc)
        for _ in range(steps):
            st, acc, hit = _disk_step(st, acc, hit, self.bh, self.disk,
                                      self.r_escape)
        for buf, v in zip(bufs, (*st, acc, hit)):
            if v is not buf:
                buf.copy_(v)

    def __call__(self, st, acc, hit_disk, n_steps: int):
        shape = tuple(st.pt.shape)
        bufs = self._buffers.get(shape)
        if bufs is None:
            bufs = self._buffers[shape] = [torch.empty_like(v) for v in
                                           (*st, acc, hit_disk)]
        for buf, v in zip(bufs, (*st, acc, hit_disk)):
            buf.copy_(v)
        dev = acc.device
        blocks = [MARCH_BLOCK] * (n_steps // MARCH_BLOCK)
        if n_steps % MARCH_BLOCK:
            blocks.append(n_steps % MARCH_BLOCK)
        for steps in blocks:
            call = self.calls.get((shape, steps))
            if call is None:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                call = self.calls[(shape, steps)] = CapturedCall(
                    DiskMarch._run, dev, self._pool,
                    name=f"a Kerr march block of {steps} steps on {shape}")
            call(self, bufs, steps)
        out = [b.clone() for b in bufs]
        return kerr.MarchState(*out[:5]), out[5], out[6]


def render_rays(o_world, d_world, bh: kerr.KerrParams, disk: DiskParams,
                env: Optional[EnvMap] = None, n_steps: int = 600,
                r_escape: float = 45.0, march=None):
    """Radiance (..., 3) of world rays through the Kerr metric: the disk
    where it is hit first, the environment (or the soft gradient) where
    the ray escapes, black where it is captured. `march`: as
    `trace_disk`'s."""
    with torch.no_grad():
        st, acc, hit_disk = trace_disk(o_world, d_world, bh, disk, n_steps,
                                       r_escape, march)
        p_world = torch.stack([st.p[..., 0], st.p[..., 2], -st.p[..., 1]],
                              dim=-1)
        p_world = p_world / torch.linalg.vector_norm(p_world + 1e-20, dim=-1,
                                                     keepdim=True)
        if env is not None:
            bg = envlib.sample_dir(env, p_world)
        else:
            # a soft gradient, so that the lensing shows without an env
            t = 0.5 * (p_world[..., 1] + 1.0)
            bg = torch.stack([0.03 + 0.05 * t, 0.04 + 0.06 * t,
                              0.08 + 0.12 * t], dim=-1)
        out = torch.where(hit_disk[..., None], acc, 0.0)
        return torch.where((st.escaped & ~hit_disk)[..., None], bg, out)


def look_at_rays(eye, target, up, fov_deg, width, height, jitter=None,
                 device="cuda"):
    """A look-at pinhole camera (the Kerr scene has no COLLADA camera):
    flat (n, 3) origins and directions, rows from the top; `jitter` (n, 2)
    in pixels, the pixel centres without it."""
    f32 = torch.float32
    eye = torch.as_tensor(eye, dtype=f32, device=device)
    fwd = torch.as_tensor(target, dtype=f32, device=device) - eye
    fwd = fwd / torch.linalg.vector_norm(fwd)
    right = torch.linalg.cross(fwd, torch.as_tensor(up, dtype=f32,
                                                    device=device))
    right = right / torch.linalg.vector_norm(right)
    upv = torch.linalg.cross(right, fwd)
    ys, xs = torch.meshgrid(torch.arange(height, dtype=f32, device=device),
                            torch.arange(width, dtype=f32, device=device),
                            indexing="ij")
    px = torch.stack([xs, ys], -1).reshape(-1, 2)
    px = px + (jitter if jitter is not None else 0.5)
    tan_f = math.tan(math.radians(fov_deg) / 2.0)
    ar = width / height
    sx = (2.0 * px[:, 0] / width - 1.0) * tan_f * ar
    sy = (1.0 - 2.0 * px[:, 1] / height) * tan_f
    d = fwd[None, :] + sx[:, None] * right[None, :] + sy[:, None] * upv[None, :]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return eye.expand(d.shape), d


def render_image(width, height, bh: kerr.KerrParams, disk: DiskParams,
                 eye=(0.0, 3.0, 22.0), target=(0.0, 0.0, 0.0),
                 fov_deg=30.0, env: Optional[EnvMap] = None,
                 spp: int = 1, seed: int = 0, n_steps: int = 600,
                 batch: int = 1 << 18, device="cuda",
                 sharding=None, graphs: Optional[bool] = None) -> np.ndarray:
    """Render the Kerr-disk scene on `device` to an (H, W, 3) HDR image
    (rows from the top), `batch` lanes at a time. With spp > 1 each sample
    jitters the pixels by uniforms from a `torch.Generator` seeded with
    `seed` (the JAX package draws threefry uniforms, so its spp > 1 images
    agree with these only statistically).

    `sharding` (a `parallel.sharding.LaneSharding`) splits every batch
    over the ranks of its mesh, as the JAX package does
    (rrt_tpu/render/kerr_scene.py:178-221): the batch is padded to a
    multiple of the world (o with 0, d with 1.0), each rank marches its
    block, and the blocks are gathered; every rank returns the image.

    `graphs`: march in captured blocks (`DiskMarch`), sharded or not; the
    default on a card. A sharded batch's gather runs eagerly after its
    block's march."""
    mesh = sharding.mesh if sharding is not None else None
    device = torch.device(device)
    can = device.type == "cuda"
    if graphs and not can:
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    bh, disk = bh.to(device), disk.to(device)
    march = DiskMarch(bh, disk) if (can if graphs is None else graphs) \
        else None
    env = env.to(device) if env is not None else None
    n = width * height
    acc = torch.zeros((n, 3), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for _ in range(spp):
        jitter = (None if spp == 1 else
                  torch.rand((n, 2), generator=gen, device=device))
        o, d = look_at_rays(eye, target, (0.0, 1.0, 0.0), fov_deg, width,
                            height, jitter, device)
        for i in range(0, n, batch):
            ob, db = o[i:i + batch], d[i:i + batch]
            if mesh is None:
                acc[i:i + batch] += render_rays(ob, db, bh, disk, env,
                                                n_steps, march=march)
                continue
            m = ob.shape[0]
            pad = pad_to_multiple(m, mesh.world) - m
            ob = torch.cat([ob, ob.new_zeros((pad, 3))])
            db = torch.cat([db, db.new_ones((pad, 3))])
            part = render_rays(shard_batch(ob, mesh), shard_batch(db, mesh),
                               bh, disk, env, n_steps, march=march)
            acc[i:i + batch] += all_gather_lanes(part, mesh, m)
    return (acc / spp).reshape(height, width, 3).cpu().numpy()
