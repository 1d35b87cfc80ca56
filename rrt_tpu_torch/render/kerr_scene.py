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
batch (rrt_tpu/render/kerr_scene.py:186). Here the step-by-step march is
a Python loop of PyTorch ops over the steps, with a per-lane adaptive
step (`trace_disk` without a march, `render_image(graphs=False)`, the
CPU). On a card (`render_image`, sharded or not, unless `graphs=False`)
a batch renders through a `DiskMarch`: its initial state, its march and
its shading, captured once per (batch shape, steps) as a CUDA graph and
replayed, as the JAX package jits a batch; the march is one launch of
the Kerr march kernel (`ops/kerr_march`, which marches each lane in
registers to the step where it settles), the initial state and the
shading the ops here; the rays, the march state and the radiance are the
graph's static buffers. The step loop here is the kernel's plain version
op for op, so the two agree bit for bit. Unsharded, `render_image` makes
each batch's camera rays through the march too, by a graph of their own
that reads the batch's offset and the sample's jitter from the card
(`DiskMarch.camera_rays`). A sharded batch renders this rank's block
(its rays eager), and its one collective, the gather of the blocks, runs
eagerly after the graph.

Spans and counters (`utils/stats`): a `render_image` call is the host
span "kerr.frame"; the device spans "kerr.rays" (the camera rays and
their jitter, inside the rays' graph through a march; step by step, the
march's initial state too), "kerr.march"
(the steps: the march kernel's launch, or the step-by-step loop) and
"kerr.shade" (step by step, the background and the disk's radiance of
the lanes). Inside a `DiskMarch`'s graph the initial state and the
shading, a few dozen elementwise kernels, run outside any span, so that
the graph's span events bracket the march kernel alone. Every march
counts, lane by lane on the device, the steps at whose start a lane was
already settled (captured, escaped or on the disk), and the lane-slots
that warps of 32 consecutive lanes step (`ops/kerr_march.warp_issued`:
the kernel stops a lane when it settles, but a warp runs until its last
lane does); `render_image` sums them into the counters "kerr.lanes_live"
(the lanes still marching when each step starts), "kerr.lanes_run" (the
lanes each step runs: lanes × steps) and "kerr.lanes_issued", read at
the end of a call while collecting.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from rrt_tpu_torch.ops import kerr_march
from rrt_tpu_torch.parallel.distributed import all_gather_lanes
from rrt_tpu_torch.parallel.sharding import pad_to_multiple, shard_bounds
from rrt_tpu_torch.physics import kerr
from rrt_tpu_torch.scene import envmap as envlib
from rrt_tpu_torch.types import EnvMap, _Tensors
from rrt_tpu_torch.utils import prng, stats
from rrt_tpu_torch.utils.graphs import CapturedCall


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
    module). r^{3/2} is r·√r, which the kernel rounds alike."""
    r = torch.sqrt(_safe(x * x + y * y))
    sq_m = torch.sqrt(mass)
    r15 = r * torch.sqrt(r)
    omega = sq_m / (r15 + a * sq_m)
    ut_inner = 1.0 - 3.0 * mass / r + 2.0 * a * sq_m / r15
    ut = 1.0 / torch.sqrt(torch.clamp(ut_inner, min=1e-3))
    lz = x * p[..., 1] - y * p[..., 0]
    denom = ut * (1.0 - omega * lz)
    return 1.0 / torch.clamp(denom, min=1e-3)


def _disk_step(st, acc, hit_disk, bh: kerr.KerrParams, disk: DiskParams,
               r_escape: float, settled=None):
    """One march step against the disk: returns (state, acc, hit_disk).
    `settled` (int32, a lane's count of steps begun settled) gains one
    where the lane was settled at the step's start."""
    rh = bh.horizon_radius
    # adaptive step: fine near the hole, coarse far away
    r = torch.sqrt(kerr._kerr_r2(st.x[..., 0], st.x[..., 1], st.x[..., 2],
                                 bh.spin))
    dlam = torch.clamp(0.18 * (r - 0.5 * rh), 0.02, 2.0)
    frozen = st.captured | st.escaped | hit_disk
    if settled is not None:
        settled += frozen
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
        g = _doppler_g(cx, cy, st2.p, bh.mass, bh.spin)
        g2 = g * g
        boost = g2 * g2
    else:
        boost = torch.ones_like(cr)
    radiance = disk.emission * (profile * boost)[..., None]
    acc = torch.where((on_disk & ~hit_disk)[..., None], radiance, acc)
    return st2, acc, hit_disk | on_disk


def march_steps(lanes: kerr_march.Lanes, n_steps: int,
                bh: kerr.KerrParams, disk: DiskParams, r_escape: float):
    """The step-by-step march of `lanes` (`ops/kerr_march.Lanes`, updated
    in place), `n_steps` steps of `_disk_step`: the Kerr march kernel's
    plain version. A settled lane's later steps are zero steps, which
    change nothing; each lane counts them in `settled`, and `issued`
    gains `kerr_march.warp_issued` of the lanes' live steps."""
    st = kerr.MarchState(lanes.x, lanes.p, lanes.pt, lanes.captured,
                         lanes.escaped)
    acc, hit = lanes.acc, lanes.hit
    settled = torch.zeros_like(lanes.settled)
    for _ in range(n_steps):
        st, acc, hit = _disk_step(st, acc, hit, bh, disk, r_escape, settled)
    for buf, v in zip(lanes, (*st, acc, hit, settled)):
        if v is not buf:
            buf.copy_(v)
    lanes.issued.add_(kerr_march.warp_issued(n_steps - settled))


def _tally(counts, lanes: kerr_march.Lanes, n_steps: int):
    """Add a march's live lane-steps, lane-steps and issued lane-slots
    into `counts` (int64 (3,) on the device) from its lanes' counts of
    settled steps and its warps' issued slots."""
    lane_steps = lanes.settled.numel() * n_steps
    counts[0] += lane_steps - lanes.settled.sum()
    counts[1] += lane_steps
    counts[2] += lanes.issued[0]


def _new_lanes(n: int, dev) -> kerr_march.Lanes:
    """March buffers of n flat lanes, `settled` and `issued` at 0."""
    f32, b8 = (dict(dtype=t, device=dev) for t in (torch.float32,
                                                    torch.bool))
    return kerr_march.Lanes(
        torch.empty(n, 3, **f32), torch.empty(n, 3, **f32),
        torch.empty(n, **f32), torch.empty(n, **b8), torch.empty(n, **b8),
        torch.empty(n, 3, **f32), torch.empty(n, **b8),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.zeros(1, dtype=torch.int64, device=dev))


def _start(lanes: kerr_march.Lanes, st, acc, hit_disk):
    """Copy a batch's initial state into `lanes`, flat."""
    for buf, v in zip(lanes, (*st, acc, hit_disk)):
        buf.copy_(v.reshape(buf.shape))


def _lanes(st, acc, hit_disk) -> kerr_march.Lanes:
    """Fresh march buffers holding a batch's initial state (flat lanes)."""
    lanes = _new_lanes(st.pt.numel(), acc.device)
    _start(lanes, st, acc, hit_disk)
    return lanes


def _unflat(lanes: kerr_march.Lanes, shape):
    """(state, acc, hit) of `lanes` in the batch's shape."""
    st = kerr.MarchState(lanes.x.reshape(shape + (3,)),
                         lanes.p.reshape(shape + (3,)),
                         lanes.pt.reshape(shape),
                         lanes.captured.reshape(shape),
                         lanes.escaped.reshape(shape))
    return st, lanes.acc.reshape(shape + (3,)), lanes.hit.reshape(shape)


def _initial(o_world, d_world, bh: kerr.KerrParams):
    """A batch's march state, zero radiance and no hits."""
    st = kerr.make_state(o_world, d_world, bh)
    acc = torch.zeros(st.pt.shape + (3,), dtype=o_world.dtype,
                      device=o_world.device)
    return st, acc, torch.zeros(st.pt.shape, dtype=torch.bool,
                                device=o_world.device)


def _shade(st, acc, hit_disk, env: Optional[EnvMap]):
    """Radiance (..., 3) of marched lanes: the disk where it was hit
    first, the environment (or the soft gradient) where the ray escaped,
    black where it was captured."""
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


def trace_disk(o_world, d_world, bh: kerr.KerrParams, disk: DiskParams,
               n_steps: int = 600, r_escape: float = 45.0, march=None,
               counts=None):
    """March world rays through the Kerr metric against the disk. Returns
    (final march state, disk radiance (..., 3), hit-disk mask). `march`
    (a `DiskMarch` of these parameters) runs the batch as its captured
    graph (the steps one kernel launch); without it the steps run one by
    one (`march_steps`). `counts` (int64 (3,) on the device): the march's
    live lane-steps, lane-steps and issued lane-slots are added into
    it."""
    if march is not None:
        march.check(bh, disk, r_escape, march.env)
        lanes, _ = march(o_world, d_world, n_steps, counts)
        out = kerr_march.Lanes(*(b.clone() for b in lanes))
        return _unflat(out, tuple(o_world.shape[:-1]))
    dev = o_world.device
    with stats.span("kerr.rays", dev):
        st, acc, hit_disk = _initial(o_world, d_world, bh)
    lanes = _lanes(st, acc, hit_disk)
    with stats.span("kerr.march", dev):
        march_steps(lanes, n_steps, bh, disk, r_escape)
    if counts is not None:
        _tally(counts, lanes, n_steps)
    return _unflat(lanes, tuple(st.pt.shape))


class DiskMarch:
    """A batch of world rays rendered as one CUDA graph, captured once per
    (batch shape, steps) and replayed, as the JAX package jits
    `render_rays` per batch (rrt_tpu/render/kerr_scene.py:186): the
    initial state (`_initial`'s ops), the march (one launch of
    `ops/kerr_march.march`, in the span "kerr.march") and the shading
    (`_shade`'s ops); and, apart, a batch's camera rays (`camera_rays`).
    The rays, the march's buffers (`ops/kerr_march.Lanes`:
    the state, the disk radiance, the hit mask, the lanes' counts of
    settled steps and the warps' issued lane-slots) and the radiance are
    the graph's static buffers, one set per batch shape, updated in place.
    The first run of a (shape, steps) runs eagerly, the second is
    captured and replayed, later runs replay. The graphs share one memory
    pool and go away with the march. `env` (or None, the soft gradient)
    is the one every batch is shaded with.

    The hole's and the disk's values are read to the host once, here, and
    are the kernel's parameters in every graph: a march is frozen at
    construction. Changed in place, `bh` or `disk` needs a new march
    (`check` compares the objects, not their values)."""

    def __init__(self, bh: kerr.KerrParams, disk: DiskParams,
                 r_escape: float = 45.0, env: Optional[EnvMap] = None):
        self.bh, self.disk, self.r_escape, self.env = bh, disk, r_escape, env
        self.hole = kerr_march.hole_constants(bh, disk, r_escape)
        self._pool = None
        self._buffers = {}   # batch shape -> (o, d, Lanes, radiance)
        self.calls = {}      # (batch shape, steps) -> CapturedCall
        # (lanes, width, height, fov, jittered) -> (frame, offset,
        # jitter, CapturedCall) of `camera_rays`
        self.cameras = {}

    def check(self, bh, disk, r_escape: float, env):
        """Raise unless the march was made for these parameters."""
        if not (self.bh is bh and self.disk is disk
                and self.r_escape == r_escape and self.env is env):
            raise ValueError("the DiskMarch was made for another hole, "
                             "disk, escape radius or environment")

    def _run(self, o, d, lanes: kerr_march.Lanes, radiance, steps: int):
        _start(lanes, *_initial(o, d, self.bh))
        lanes.issued.zero_()
        with stats.span("kerr.march", o.device):
            kerr_march.march(lanes, steps, self.bh, self.disk,
                             self.r_escape, self.hole)
        radiance.copy_(_shade(kerr.MarchState(*lanes[:5]), lanes.acc,
                              lanes.hit, self.env))

    def _graph(self, fn, dev, name: str) -> CapturedCall:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return CapturedCall(fn, dev, self._pool, name=name)

    def _batch(self, shape, dev):
        """The static buffers of a batch shape: (o, d, Lanes, radiance)."""
        bufs = self._buffers.get(shape)
        if bufs is None:
            n = math.prod(shape)
            bufs = self._buffers[shape] = (
                torch.empty(n, 3, device=dev), torch.empty(n, 3, device=dev),
                _new_lanes(n, dev), torch.empty(n, 3, device=dev))
        return bufs

    def camera_rays(self, frame, fov_deg, width: int, height: int, jitter,
                    lo: int, m: int):
        """The world rays of pixels [lo, lo + m) of a look-at camera
        (`look_at_rays`), written by a CUDA graph, captured once per (m,
        width, height, fov, jittered), into this march's static rays of
        batch shape (m,), which it returns: `self(o, d, …)` marches them
        without a copy. `frame`: float32 (3, 3) on the card, its rows the
        eye, the target and the up vector; `jitter`: the sample's whole
        (width · height, 2) draw, or None for the pixel centres."""
        dev = frame.device
        o, d = self._batch((m,), dev)[:2]
        key = (m, width, height, fov_deg, jitter is not None)
        cam = self.cameras.get(key)
        if cam is None:
            cam = self.cameras[key] = (
                torch.empty(3, 3, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev),
                None if jitter is None else torch.empty(width * height, 2,
                                                        device=dev),
                self._graph(_camera_rays, dev,
                            f"Kerr camera rays of {m} pixels"))
        frame_buf, offset, jit, call = cam
        frame_buf.copy_(frame)
        offset.fill_(lo)
        if jit is not None:
            jit.copy_(jitter)
        call(o, d, frame_buf, offset, jit, fov_deg, width, height)
        return o, d

    def __call__(self, o_world, d_world, n_steps: int, counts=None):
        """Render a batch of world rays (..., 3): returns its march
        buffers and radiance (flat, the graph's own: the next call of the
        shape overwrites them). `counts`: as `trace_disk`'s."""
        shape = tuple(o_world.shape[:-1])
        dev = o_world.device
        o, d, lanes, radiance = self._batch(shape, dev)
        if o_world is not o:
            o.copy_(o_world.reshape(o.shape))
        if d_world is not d:
            d.copy_(d_world.reshape(d.shape))
        call = self.calls.get((shape, n_steps))
        if call is None:
            call = self.calls[(shape, n_steps)] = self._graph(
                DiskMarch._run, dev,
                f"a Kerr batch of {n_steps} steps on {shape}")
        call(self, o, d, lanes, radiance, n_steps)
        if counts is not None:
            _tally(counts, lanes, n_steps)
        return lanes, radiance


def _camera_rays(o, d, frame, offset, jitter, fov_deg, width, height):
    """`look_at_rays` of the pixels offset + [0, len(o)) into o and d; the
    batch's rows of the sample's `jitter` (or None)."""
    with stats.span("kerr.rays", o.device):
        pix = offset + torch.arange(o.shape[0], device=o.device)
        ro, rd = _pixel_rays(frame[0], frame[1], frame[2], fov_deg, width,
                             height, pix, None if jitter is None
                             else jitter[pix])
        o.copy_(ro)
        d.copy_(rd)


def render_rays(o_world, d_world, bh: kerr.KerrParams, disk: DiskParams,
                env: Optional[EnvMap] = None, n_steps: int = 600,
                r_escape: float = 45.0, march=None, counts=None):
    """Radiance (..., 3) of world rays through the Kerr metric: the disk
    where it is hit first, the environment (or the soft gradient) where
    the ray escapes, black where it is captured. `march` (a `DiskMarch`
    of these parameters, `env` included) renders the batch as its
    captured graph; `counts`: as `trace_disk`'s."""
    with torch.no_grad():
        if march is not None:
            march.check(bh, disk, r_escape, env)
            _, radiance = march(o_world, d_world, n_steps, counts)
            return radiance.reshape(o_world.shape).clone()
        st, acc, hit_disk = trace_disk(o_world, d_world, bh, disk, n_steps,
                                       r_escape, counts=counts)
        with stats.span("kerr.shade", acc.device):
            return _shade(st, acc, hit_disk, env)


def look_at_rays(eye, target, up, fov_deg, width, height, jitter=None,
                 device="cuda", lanes=None):
    """A look-at pinhole camera (the Kerr scene has no COLLADA camera):
    flat (n, 3) origins and directions, rows from the top; `jitter` (n, 2)
    in pixels, the pixel centres without it. `lanes` = (lo, hi): the rays
    of those pixels only (jitter then (hi − lo, 2)). `eye`, `target` and
    `up`: three numbers each, or float32 (3,) tensors on `device`, which
    spare the copies from the host."""
    f32 = torch.float32
    lo, hi = lanes or (0, width * height)
    return _pixel_rays(*(torch.as_tensor(v, dtype=f32, device=device)
                         for v in (eye, target, up)), fov_deg, width,
                       height, torch.arange(lo, hi, device=device), jitter)


def _pixel_rays(eye, target, up, fov_deg, width, height, pix, jitter):
    """`look_at_rays` of the flat pixel indices `pix` (int64), eye, target
    and up float32 (3,) tensors on pix's device."""
    fwd = target - eye
    fwd = fwd / torch.linalg.vector_norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.vector_norm(right)
    upv = torch.linalg.cross(right, fwd)
    px = torch.stack([pix % width, pix // width], -1).to(torch.float32)
    px = px + (jitter if jitter is not None else 0.5)
    tan_f = math.tan(math.radians(fov_deg) / 2.0)
    ar = width / height
    sx = (2.0 * px[:, 0] / width - 1.0) * tan_f * ar
    sy = (1.0 - 2.0 * px[:, 1] / height) * tan_f
    d = fwd[None, :] + sx[:, None] * right[None, :] + sy[:, None] * upv[None, :]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return eye.expand(d.shape), d


@stats.span("kerr.frame")
def render_image(width, height, bh: kerr.KerrParams, disk: DiskParams,
                 eye=(0.0, 3.0, 22.0), target=(0.0, 0.0, 0.0),
                 fov_deg=30.0, env: Optional[EnvMap] = None,
                 spp: int = 1, seed: int = 0, n_steps: int = 600,
                 batch: int = 1 << 18, device="cuda",
                 sharding=None, graphs: Optional[bool] = None,
                 march: Optional[DiskMarch] = None) -> np.ndarray:
    """Render the Kerr-disk scene on `device` to an (H, W, 3) HDR image
    (rows from the top), `batch` lanes at a time. With spp > 1 each sample
    jitters the pixels by the JAX package's uniforms: key(seed), split
    once a sample, an (n, 2) draw from the sample's key
    (rrt_tpu/render/kerr_scene.py:189-195), so its images equal the JAX
    package's up to the march's arithmetic.

    `sharding` (a `parallel.sharding.LaneSharding`) splits every batch
    over the ranks of its mesh, as the JAX package does
    (rrt_tpu/render/kerr_scene.py:178-221): the batch is padded to a
    multiple of the world (o with 0, d with 1.0), each rank makes and
    marches its block's rays, drawing only its block's jitter, and the
    blocks are gathered; every rank returns the image.

    `graphs`: render each batch through a `DiskMarch` (one captured graph
    a batch, its march one launch of the Kerr march kernel), sharded or
    not; the default on a card. Unsharded, each batch's camera rays are
    then a graph too (`DiskMarch.camera_rays`), the sample's jitter drawn
    whole, once a sample. `graphs=False` marches step by step
    (`march_steps`) with eager rays and shading. A sharded batch's rays
    are eager, and its gather runs eagerly after its block's graph.

    `march`: a caller's `DiskMarch` of these `bh`, `disk` and `env` (on
    `device`), kept across calls so that its batch graph, captured once,
    is replayed by every later call; without it each call makes its own
    (with graphs). A march of another hole, disk, escape radius or
    environment raises."""
    mesh = sharding.mesh if sharding is not None else None
    device = torch.device(device)
    can = device.type == "cuda"
    if (graphs or march is not None) and not can:
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    if march is None:
        bh, disk = bh.to(device), disk.to(device)
        env = env.to(device) if env is not None else None
        if can and graphs is not False:
            march = DiskMarch(bh, disk, env=env)
    elif graphs is False:
        raise ValueError("a DiskMarch marches in CUDA graphs; graphs=False "
                         "takes none")
    n = width * height
    acc = torch.zeros((n, 3), dtype=torch.float32, device=device)
    counts = torch.zeros(3, dtype=torch.int64, device=device)
    key = prng.key(seed, device)
    # the camera on the device once a call: a copy from the host waits for
    # the card, so that each batch's rays would wait for the batch before
    frame = torch.tensor([eye, target, (0.0, 1.0, 0.0)], dtype=torch.float32,
                         device=device)
    # through a march, each batch's rays are a graph of their own
    graph_rays = march is not None and mesh is None

    def rays(k, jitter, lo, hi):
        """The rays of pixels [lo, hi), jittered by their block of the
        sample's draw (`jitter`, the whole draw, through a march)."""
        if graph_rays:
            return march.camera_rays(frame, fov_deg, width, height, jitter,
                                     lo, hi - lo)
        with stats.span("kerr.rays", device):
            jitter = (None if k is None else
                      prng.uniform(k, (n, 2), window=(0, lo, hi)))
            return look_at_rays(*frame, fov_deg, width, height, jitter,
                                device, (lo, hi))

    for _ in range(spp):
        k = jitter = None
        if spp > 1:
            key, k = prng.split(key)
            if graph_rays:
                with stats.span("kerr.rays", device):
                    jitter = prng.uniform(k, (n, 2))
        for i in range(0, n, batch):
            m = min(batch, n - i)
            if mesh is None:
                acc[i:i + m] += render_rays(*rays(k, jitter, i, i + m), bh,
                                            disk, env, n_steps, march=march,
                                            counts=counts)
                continue
            lo, hi = shard_bounds(pad_to_multiple(m, mesh.world), mesh.rank,
                                  mesh.world)
            ob, db = rays(k, None, i + min(lo, m), i + min(hi, m))
            pad = hi - lo - ob.shape[0]
            ob = torch.cat([ob, ob.new_zeros((pad, 3))])
            db = torch.cat([db, db.new_ones((pad, 3))])
            part = render_rays(ob, db, bh, disk, env, n_steps, march=march,
                               counts=counts)
            acc[i:i + m] += all_gather_lanes(part, mesh, m)
    img = (acc / spp).reshape(height, width, 3).cpu().numpy()
    if stats.collecting():    # this rank's lanes, the padding included
        live, run, issued = counts.tolist()
        stats.count("kerr.lanes_live", live)
        stats.count("kerr.lanes_run", run)
        stats.count("kerr.lanes_issued", issued)
    return img
