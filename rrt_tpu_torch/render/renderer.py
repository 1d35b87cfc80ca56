"""Render loop (the port of `rrt_tpu/render/renderer.py`).

A render is a host loop over sample passes. Each pass traces k jittered
samples for every pixel as one batch of k·W·H lanes,
k = min(ns_aa, max_pass_lanes // (W·H)), and accumulates the radiance sum,
the luminance sums s1, s2 and the per-pixel sample count. The tail pass
runs the same k with its surplus samples masked. Adaptive sampling
(part1_code.cpp:147-159) freezes a pixel once 1.96·σ/√n ≤ tol·mean at a
batch boundary; a frozen pixel's lanes end at once.

Every pass draws its random numbers from the JAX package's key of the
pass, fold_in(fold_in(key(cfg.seed), first sample index of the pass),
band index) (`pass_key`; rrt_tpu/render/renderer.py:398,412-413), split
into the jitter's, the lens's and the integrator's keys as the JAX
package splits it (`prng`, threefry on the device), so one seed renders
the JAX package's image on the CPU or on a card. The port renders each
region as one band (index 0).

One pass runner serves every pass of a shape (k, rw, rh)
(`Renderer._pass_fn`, named after the JAX package's): the accumulators
are its static buffers, updated in place, and what changes from pass to
pass (the first sample index, the number of live samples, the region
origin, the render's key) is written into the runner's device tensors
before the pass, and the pass derives its key from them on the device.
On CUDA the shape's first pass runs eagerly, its second is captured once
as a CUDA graph and replayed, and every later pass of the shape replays
it (`utils/graphs.CapturedCall`);
`graphs=False` runs it eagerly, as the CPU always does. A sharded pass is
two graphs around its one collective (`PassRunner`).

The render lifecycle (the reference's `stop()`/`continueRaytracing`,
pathtracer.cpp:180-202):
  * `region=` renders a cell (`-p x y dx dy`, pathtracer.cpp:583-609):
    camera rays are made for the cell only, so the wall scales with its
    area;
  * `checkpoint_path=` saves the accumulators and the pass index; a
    render resumed from it equals the uninterrupted render bit for bit,
    since a pass's key depends only on (seed, pass index);
  * `preview_path=` writes a progressive PNG between passes (the viewer's
    `update_screen` blit, pathtracer.cpp:156-178);
  * `stop()`, `stop_after=`, a `control` mapping (`--serve`'s POST
    /control) and Ctrl-C end the render between passes, saving the
    checkpoint.

`sharding=` (a `parallel.sharding.LaneSharding`) splits every pass's k·n
lanes over the ranks of its mesh, one process per device: each rank
makes the camera rays of its block (`shard_bounds`), estimates them with
its block of the pass's draws (`prng.uniform(window=)`: it computes only
its lanes' uniforms), and the blocks' radiance is gathered, so that
every rank accumulates the same radiance as a single-process render, bit
for bit. Decisions that end the pass loop
are agreed by one all-reduce at each pass boundary, between passes and
outside any graph; rank 0 alone writes checkpoints, previews and the
image.
"""
from __future__ import annotations

import math
import os
import signal
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from rrt_tpu_torch.convert import black_hole_from_arrays
from rrt_tpu_torch.ops.trace_kernel import build_tables
from rrt_tpu_torch.parallel import distributed as pdist
from rrt_tpu_torch.parallel.sharding import shard_bounds
from rrt_tpu_torch.render import film
from rrt_tpu_torch.render.integrator import (_mask_rays, est_radiance,
                                             lane_uniform)
from rrt_tpu_torch.render.lights import is_delta_light
from rrt_tpu_torch.scene.camera import Camera
from rrt_tpu_torch.types import BlackHoleParams, SceneData
from rrt_tpu_torch.utils import prng
from rrt_tpu_torch.utils.config import Illum, RenderConfig
from rrt_tpu_torch.utils.graphs import CapturedCall, run_call
from rrt_tpu_torch.utils import stats
from rrt_tpu_torch.utils.stats import RenderStats


def make_black_hole(cfg: RenderConfig, device) -> Optional[BlackHoleParams]:
    b = cfg.black_hole
    if not b.enabled:
        return None
    return black_hole_from_arrays(b.position, b.radius, b.delta_theta, device)


def pass_key(base: torch.Tensor, sample_idx, band: int = 0
             ) -> torch.Tensor:
    """The key of one (pass, band): fold_in(fold_in(base, sample_idx),
    band), `base` the render's key(cfg.seed) and `sample_idx` the pass's
    first sample, an int or a 0-d integer tensor on base's device."""
    return prng.fold_in(prng.fold_in(base, sample_idx), band)


class PassRunner:
    """The pass of one shape (k samples of an rw×rh window), the
    counterpart of the JAX package's jitted `_sample_pass`
    (rrt_tpu/render/renderer.py:85-123).

    Static buffers: the accumulators `acc` = (radiance sum (n,3), s1, s2,
    count, done) and the counters `tests` (4,) f64 (the trace kernel's
    primitive and bbox tests, then the live lanes entering the
    integrator's vertices and the lanes those vertices ran), which every
    pass updates in place (the JAX package donates them,
    `donate_argnums=(0,)`); a render, checkpoint or resume copies into and
    out of them. Dynamic
    inputs, device tensors the pass reads: `sample_idx` (the pass's first
    sample), `n_valid` (its live samples; the tail pass has fewer than k)
    and the region origin `x0`, `y0`, so that the tail pass, the cells of
    one size and the adaptive batch boundaries all share one pass. `base`
    holds the render's key(seed); the pass derives its key from it and
    `sample_idx` on the device (`pass_key`), so a replay draws the
    uniforms of the pass it replays.

    With a `mesh` the pass is split at its one collective, the gather of
    the ranks' radiance (`parallel.distributed`): the rank half
    (`Renderer._rank_half`: the windowed draws, camera rays and
    `est_radiance` of this rank's block, its radiance written into the
    static buffer `sent`, and the trace counters), the seam
    (`gather_packed` from `sent` into the static buffer `whole`, eagerly)
    and the accumulate half (`Renderer._accumulate_half`: the
    accumulation of `whole`). Without one the pass is one function
    (`Renderer._sample_pass`).

    With `graphs` the pass, or each half, is a `CapturedCall` sharing the
    renderer's graph pool: the first pass of the shape runs eagerly, the
    second is captured and replayed, and every later pass replays the
    graphs, the seam running between them; a shape that runs one pass is
    never captured."""

    def __init__(self, device, k: int, rw: int, rh: int, graphs: bool,
                 pool=None, mesh=None):
        n = rw * rh
        self.k, self.rw, self.rh, self.mesh = k, rw, rh, mesh
        z = lambda dtype=torch.float32, shape=(n,): torch.zeros(
            shape, dtype=dtype, device=device)
        self.acc = (z(shape=(n, 3)), z(), z(), z(torch.int32),
                    z(torch.bool))
        self.tests = z(torch.float64, (4,))
        self.sample_idx = z(torch.int32, ())
        self.n_valid = z(torch.int32, ())
        self.x0, self.y0 = z(torch.int64, ()), z(torch.int64, ())
        self.base = z(torch.int64, (2,))
        self.passes = 0
        name = f"(k, rw, rh) = {(k, rw, rh)}"
        capture = lambda fn, what: CapturedCall(
            fn, device, pool, name=f"{what} {name}") if graphs else None
        self.accumulate = None
        if mesh is None:
            self.call = capture(Renderer._sample_pass, "the pass")
            return
        # this rank's block of the radiance, zero past its live lanes, and
        # every rank's radiance gathered
        lo, hi = shard_bounds(k * n, mesh.rank, mesh.world)
        self.sent = z(shape=(hi - lo, 3))
        self.whole = z(shape=(k * n, 3))
        self.call = capture(Renderer._rank_half, "the rank half of the pass")
        self.accumulate = capture(Renderer._accumulate_half,
                                  "the accumulate half of the pass")

    @property
    def warm(self) -> bool:
        """Has the shape's first pass (and, with graphs, its capture)
        run, so that its next pass is a steady one?"""
        return self.passes > 0 if self.call is None \
            else self.call.graph is not None

    def reset(self, acc=None):
        """Start a render: the accumulators from `acc` (zeros without it),
        the counters at zero."""
        for buf, a in zip(self.acc, acc or (None,) * 5):
            buf.zero_() if a is None else buf.copy_(a)
        self.tests.zero_()

    def run(self, renderer, seed: int, s: int, ks: int, x0: int, y0: int
            ) -> int:
        """One pass from sample s with ks live samples at origin (x0, y0);
        returns its trace calls (this rank's, when sharded)."""
        self.sample_idx.fill_(s)
        self.n_valid.fill_(ks)
        self.x0.fill_(x0)
        self.y0.fill_(y0)
        self.base.copy_(prng.key(seed))
        self.passes += 1
        if self.mesh is None:
            return run_call(self.call, Renderer._sample_pass, renderer,
                            self)
        calls = run_call(self.call, Renderer._rank_half, renderer, self)
        pdist.gather_packed(self.sent, self.mesh, self.k * self.rw * self.rh,
                            out=self.whole)
        run_call(self.accumulate, Renderer._accumulate_half, renderer, self)
        return calls


class Renderer:
    """Progressive renderer of a frame or a cell, with adaptive sampling,
    checkpoints, previews and cancellation, on the scene's device."""

    def __init__(self, scene: SceneData, camera: Camera, cfg: RenderConfig,
                 device, sharding=None, graphs: Optional[bool] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if scene.device != self.device:
            raise ValueError(f"scene is on {scene.device}, renderer on "
                             f"{self.device}")
        self.mesh = sharding.mesh if sharding is not None else None
        if self.mesh is not None and self.mesh.device != self.device:
            raise ValueError(f"this rank's device is {self.mesh.device}, "
                             f"the renderer's {self.device}")
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.bh = make_black_hole(cfg, self.device)
        # the traversal's tables, built once for every trace of the render
        self.tables = build_tables(scene, self.bh)
        # passes are captured as CUDA graphs on a card, sharded or not,
        # unless the caller asks for eager passes: a sharded pass's gather
        # runs eagerly between its two graphs, and the pass loop's stop
        # agreement between passes
        can = self.device.type == "cuda"
        if graphs and not can:
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{self.device}")
        self.graphs = can if graphs is None else bool(graphs)
        self._pool = None
        self._pass_fns = {}   # (k, rw, rh) -> PassRunner
        # the frame size that camera rays divide by, made once on the
        # device (a host copy inside a pass would break its capture)
        self._frame_size = torch.tensor([cfg.width, cfg.height],
                                        dtype=torch.float32,
                                        device=self.device)
        self.last_accumulators = None
        self.last_sample_count = None
        self.last_trace_tests = None
        self.last_trace_calls = 0
        self.last_warm_samples = 0
        self.samples_done = 0
        self.cancelled = False
        self._stop = False

    @property
    def writes(self) -> bool:
        """Does this process write files (rank 0 of a sharded render)?"""
        return self.mesh is None or self.mesh.rank == 0

    def samples_per_pass(self, n: int) -> int:
        cfg = self.cfg
        k = max(1, min(cfg.ns_aa, cfg.max_pass_lanes // max(n, 1)))
        if cfg.adaptive:
            while cfg.samples_per_batch % k != 0:
                k -= 1
        return k

    def stop(self):
        """Ask the render to end cleanly at the next pass boundary (the
        reference's `stop()`, pathtracer.cpp:180-202)."""
        self._stop = True

    def _pass_fn(self, k: int, rw: int, rh: int) -> PassRunner:
        """The runner of every pass of shape (k, rw, rh), made on first
        use: one captured graph serves the tail pass, every cell of the
        size and both sides of an adaptive batch boundary. A renderer's
        graphs share one memory pool and go away with it."""
        runner = self._pass_fns.get((k, rw, rh))
        if runner is None:
            if self.graphs and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            runner = PassRunner(self.device, k, rw, rh, self.graphs,
                                self._pool, self.mesh)
            self._pass_fns[(k, rw, rh)] = runner
        return runner

    def camera_rays(self, jitter, key, k: int, region=None, lanes=None):
        """The k·rw·rh camera rays of one pass over the window region =
        (x0, y0, rw, rh), the whole frame by default: pixel (x + jitter) /
        size, sample-major; a jitter of one row is shared by every lane.
        The origin (x0, y0) may be ints or 0-d integer device tensors (a
        pass runner's). A thin lens draws from `key`, split in two (the
        JAX package's `_rays_for`, rrt_tpu/render/renderer.py:141-143).
        `lanes` = (lo, hi) makes only those lanes of the pass (a rank's
        block), with their block of the draws."""
        cfg, dev = self.cfg, self.device
        x0, y0, rw, rh = region or (0, 0, cfg.width, cfg.height)
        lo, hi = lanes or (0, k * rw * rh)
        pix = torch.arange(lo, hi, device=dev) % (rw * rh)
        px = torch.stack([x0 + pix % rw, y0 + pix // rw],
                         dim=-1).to(torch.float32)
        m = px.shape[0]
        if jitter.shape[0] != m:                 # centred single sample
            jitter = jitter[:1].expand(m, 2)
        xy = (px + jitter) / self._frame_size
        if cfg.thin_lens:
            k1, k2 = prng.split(key)
            window = (lo, hi, k * rw * rh)
            rnd_r = lane_uniform(k1, (m,), window)
            rnd_th = lane_uniform(k2, (m,), window) * 2.0 * math.pi
            return self.camera.generate_rays_thin_lens(xy, rnd_r, rnd_th)
        return self.camera.generate_rays(xy)

    def _masks(self, p: PassRunner):
        """The pass's live pixels (not frozen) and live samples (the
        first p.n_valid of k)."""
        return ~p.acc[4], torch.arange(p.k, device=self.device) < p.n_valid

    def _radiance(self, p: PassRunner):
        """The radiance of the pass's lanes [lo, hi) (this rank's block,
        all k·n lanes unsharded), the integrator's `TraceWork` and the
        pass's masks, under the pass's key, derived on the device and
        split as the JAX package's `_sample_pass` splits it
        (rrt_tpu/render/renderer.py:163-168)."""
        cfg, dev, k = self.cfg, self.device, p.k
        n = p.rw * p.rh
        with stats.span("pass.camera", dev):
            masks = active, valid_k = self._masks(p)
            k_jit, k_lens, k_rad = prng.split(
                pass_key(p.base, p.sample_idx), 3)
            lo, hi = 0, k * n
            if self.mesh is not None:   # this rank's block of the k·n lanes
                lo, hi = shard_bounds(k * n, self.mesh.rank, self.mesh.world)
                lo, hi = min(lo, k * n), min(hi, k * n)
            lanes = (lo, hi, k * n)
            if cfg.ns_aa == 1:
                jitter = torch.full((n, 2), 0.5, device=dev)
            else:
                jitter = lane_uniform(k_jit, (hi - lo, 2), lanes)
            rays = self.camera_rays(jitter, k_lens, k,
                                    (p.x0, p.y0, p.rw, p.rh), (lo, hi))
            lane_live = active.repeat(k) & valid_k.repeat_interleave(n)
            rays = _mask_rays(rays, lane_live[lo:hi], self.bh)
        L, work = est_radiance(self.scene, self.bh, rays, self.cfg, k_rad,
                               self.tables, lanes=lanes)
        return L, work, masks

    @staticmethod
    def _count(p: PassRunner, work):
        """Add the estimate's counters into p.tests."""
        p.tests[:2] += work.tests
        if work.live:
            p.tests[2] += torch.stack(work.live).sum()
        p.tests[3] += work.run

    def _accumulate(self, p: PassRunner, L: torch.Tensor, masks):
        """Add the first p.n_valid samples of the pass's radiance L (k·n, 3)
        into p's accumulators, in place, and freeze converged pixels at a
        batch boundary."""
        cfg, k = self.cfg, p.k
        rad_sum, s1, s2, count, done = p.acc
        n = p.rw * p.rh
        active, valid_k = masks
        L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        L = torch.where(valid_k[:, None, None], L.reshape(k, n, 3), 0.0)

        rad_sum += torch.where(active[:, None], L.sum(0), 0.0)
        illum = 0.2126 * L[..., 0] + 0.7152 * L[..., 1] + 0.0722 * L[..., 2]
        s1 += torch.where(active, illum.sum(0), 0.0)
        s2 += torch.where(active, (illum * illum).sum(0), 0.0)
        count += p.n_valid * active.to(torch.int32)
        if cfg.adaptive:
            # the freeze applies at a batch boundary only; the predicate is
            # read on the device, so both sides share the pass
            boundary = (p.sample_idx + p.n_valid) % cfg.samples_per_batch == 0
            i1 = count.to(torch.float32)
            avg = s1 / torch.clamp(i1, min=1.0)
            var = (s2 - avg * s1) / torch.clamp(i1 - 1.0, min=1.0)
            sd = torch.sqrt(torch.clamp(var, min=0.0))
            conv = (1.96 * sd / torch.sqrt(torch.clamp(i1, min=1.0))
                    <= cfg.max_tolerance * avg)
            done |= boundary & active & conv

    def _sample_pass(self, p: PassRunner) -> int:
        """Trace p.k samples of every pixel of p's window in one batch of
        k·n lanes (n = rw·rh) and add the first p.n_valid of them into p's
        accumulators, in place: the unsharded pass. Reads only p's tensors,
        so that one capture serves every pass of the shape.
        Returns the number of trace calls."""
        L, work, masks = self._radiance(p)
        with stats.span("pass.accumulate", self.device):
            self._accumulate(p, L, masks)
            self._count(p, work)
        return work.calls

    def _rank_half(self, p: PassRunner) -> int:
        """The sharded pass up to its gather: this rank's block of the k·n
        lanes estimated, its radiance written into p.sent, its trace
        counters added into p.tests. Returns this rank's trace calls."""
        L, work, _ = self._radiance(p)
        with stats.span("pass.accumulate", self.device):
            p.sent[:L.shape[0]].copy_(L)
            self._count(p, work)
        return work.calls

    def _accumulate_half(self, p: PassRunner):
        """The sharded pass after its gather: every rank's radiance, in
        p.whole, accumulated as `_sample_pass` does."""
        with stats.span("pass.accumulate", self.device):
            self._accumulate(p, p.whole, self._masks(p))

    # ------------------------------------------------------------ checkpoints

    def _fingerprint(self, region) -> np.ndarray:
        cfg = self.cfg
        return np.array([cfg.width, cfg.height, cfg.ns_aa, cfg.seed, *region],
                        np.int64)

    def save_checkpoint(self, path: str, acc, s: int, region):
        """Write the accumulators and the samples done to `path` (the JAX
        package's npz keys), through a temporary file and `os.replace`. In
        a sharded render rank 0 writes (every rank holds the same
        accumulators) and the ranks wait for it."""
        if self.writes:
            rad_sum, s1, s2, count, done = (a.cpu().numpy() for a in acc)
            tmp = path + ".tmp.npz"
            np.savez(tmp, rad_sum=rad_sum, s1=s1, s2=s2, count=count,
                     done=done, s=np.int64(s),
                     fingerprint=self._fingerprint(region))
            os.replace(tmp, path)
        if self.mesh is not None:
            pdist.all_processes_done("checkpoint")

    def load_checkpoint(self, path: str, region):
        """The accumulators (on the renderer's device) and the samples done
        of a checkpoint of this render; ValueError if it was written by a
        render of another size, sample count, seed or region."""
        with np.load(path) as z:
            if not np.array_equal(z["fingerprint"],
                                  self._fingerprint(region)):
                raise ValueError(
                    f"checkpoint {path} does not match this render config")
            acc = tuple(torch.as_tensor(z[key], device=self.device)
                        for key in ("rad_sum", "s1", "s2", "count", "done"))
            return acc, int(z["s"])

    # ------------------------------------------------------------ render loop

    @stats.span("render.frame")
    def render(self, progress=None, region=None, checkpoint_path=None,
               checkpoint_every: Optional[int] = None, preview_path=None,
               preview_every: Optional[int] = None, resume: bool = False,
               stop_after: Optional[int] = None, control=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Render `region` = (x0, y0, rw, rh), the whole frame by default.
        Returns (hdr (rh,rw,3), sample count (rh,rw)) as numpy arrays; the
        accumulators stay on the device between passes.

        checkpoint_path / checkpoint_every: save the accumulators every N
        samples and when the render is cancelled; `resume=True` continues
        from the checkpoint when it exists. preview_path / preview_every:
        write a progressive PNG every N samples. stop_after: cancel after
        that many samples. control: a mapping polled between passes, as
        `--serve`'s POST /control fills it: {"stop": True} cancels,
        {"spp_cap": N} ends at N samples per pixel, {"preview_every": N}
        changes the preview cadence. Checkpoints, previews and stops land
        on pass boundaries; `cancelled` and `samples_done` say how the
        render ended."""
        cfg, dev = self.cfg, self.device
        if region is None:
            region = (0, 0, cfg.width, cfg.height)
        region = tuple(int(v) for v in region)
        _, _, rw, rh = region
        n = rw * rh
        # the pass size depends only on the config and the region, so a
        # resumed render splits its samples into the same passes
        k = self.samples_per_pass(n)
        s = 0
        loaded = None
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            loaded, s = self.load_checkpoint(checkpoint_path, region)
        runner = self._pass_fn(k, rw, rh)
        runner.reset(loaded)
        self.camera.frame(torch.float32, dev)   # a moved camera is seen
        acc = runner.acc
        calls = 0
        warm_samples = 0
        self._stop = False
        cancelled = False
        # Ctrl-C becomes a stop at the next pass boundary: the accumulators
        # are updated in place, so a pass is never left half added, and a
        # sharded render's ranks then agree on the stop (an interrupt
        # inside a collective would leave the other ranks waiting in it)
        sigint = None
        if threading.current_thread() is threading.main_thread():
            sigint = signal.signal(signal.SIGINT, lambda *_: self.stop())
        try:
            while s < cfg.ns_aa:
                ks = min(k, cfg.ns_aa - s)
                # the shape's first pass and its capture, waited for so
                # that they are timed apart from the steady passes
                first = not runner.warm
                with stats.span("render.launch"):
                    calls += runner.run(self, cfg.seed, s, ks, region[0],
                                        region[1])
                    s += ks
                    if first and dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                warm_samples += ks if first else 0
                all_done = cfg.adaptive and s % cfg.samples_per_batch == 0 \
                    and bool(torch.all(acc[4]))
                stop = False
                if not all_done:
                    if progress is not None:
                        progress(s, cfg.ns_aa)
                    if checkpoint_path and checkpoint_every and \
                            s // checkpoint_every > (s - ks) // checkpoint_every:
                        self.save_checkpoint(checkpoint_path, acc, s, region)
                    pv_every, spp_cap = preview_every, None
                    if control is not None:
                        if control.get("stop"):
                            self._stop = True
                        pv_every = control.get("preview_every", preview_every)
                        spp_cap = control.get("spp_cap")
                    if preview_path and pv_every and s < cfg.ns_aa \
                            and s // pv_every > (s - ks) // pv_every \
                            and self.writes:
                        self._write_preview(preview_path, acc, region)
                    stop = (stop_after is not None and s >= stop_after) \
                        or (spp_cap is not None and s >= int(spp_cap)) \
                        or self._stop
                if self.mesh is not None:
                    with stats.span("render.agree"):
                        all_done, stop = self._agree(all_done, stop)
                if all_done:
                    break
                if stop:
                    cancelled = True
                    break
        except KeyboardInterrupt:
            # raised between passes (by `progress`): acc holds s samples
            cancelled = True
        finally:
            if sigint is not None:
                signal.signal(signal.SIGINT, sigint)
        if cancelled and checkpoint_path:
            self.save_checkpoint(checkpoint_path, acc, s, region)
        tests = runner.tests.clone()
        if self.mesh is not None:
            tests = pdist.all_reduce_sum(tests, self.mesh)
        with stats.span("render.readback"):     # waits for the device
            self.last_accumulators = tuple(a.cpu().numpy() for a in acc)
        rad_sum, count = self.last_accumulators[0], self.last_accumulators[3]
        count = count.reshape(rh, rw)
        self.last_sample_count = count
        self.last_trace_tests = tests.cpu().numpy()
        stats.count("lanes.live", self.last_trace_tests[2])
        stats.count("lanes.run", self.last_trace_tests[3])
        self.last_trace_calls = calls
        self.last_warm_samples = warm_samples
        self.samples_done = s
        self.cancelled = cancelled
        with stats.span("render.resolve"):
            hdr = rad_sum.reshape(rh, rw, 3) / np.maximum(count[..., None], 1)
        return hdr, count

    def _agree(self, all_done: bool, stop: bool):
        """The pass loop's two ways out, agreed by every rank: one
        all-reduce (MAX) of the flags, so that a stop that one rank alone
        saw ends every rank at the same pass."""
        flags = torch.tensor([int(all_done), int(stop)], dtype=torch.int32,
                             device=self.device)
        all_done, stop = pdist.all_reduce_max(flags, self.mesh).tolist()
        return bool(all_done), bool(stop)

    def _write_preview(self, path: str, acc, region):
        """The partial frame as a PNG, written whole (through a temporary
        file and `os.replace`) so that a reader never sees half of it."""
        _, _, rw, rh = region
        count = acc[3].cpu().numpy().reshape(rh, rw)
        hdr = (acc[0].cpu().numpy().reshape(rh, rw, 3)
               / np.maximum(count[..., None], 1))
        tmp = path + ".tmp.png"
        film.save_image(tmp, hdr)
        os.replace(tmp, path)

    def stats(self, wall_seconds: float = 0.0) -> RenderStats:
        """Trace counts of the last render (the reference's total_rays;
        every lane is traced in lockstep, so the counts are exact), with
        the kernel-measured primitive and bbox tests."""
        cfg = self.cfg
        nls = sum(1 if is_delta_light(self.scene.lights, i)
                  else cfg.ns_area_light
                  for i in range(len(self.scene.lights.kind_host)))
        lanes = (int(self.last_sample_count.sum())
                 if self.last_sample_count is not None
                 else cfg.ns_aa * cfg.width * cfg.height)
        st = RenderStats(camera_rays=lanes, wall_seconds=wall_seconds)
        md = cfg.max_ray_depth
        if cfg.illum == Illum.DIRECT:
            st.shadow_rays = lanes * nls
        elif cfg.illum != Illum.NORMAL:
            # an INDIRECT render skips the first vertex's shadow queries
            n_vertices = max(md - 1, 0) if cfg.illum == Illum.INDIRECT \
                else max(md, 0)
            st.shadow_rays = lanes * nls * n_vertices
            st.bounce_rays = lanes * max(md - 1, 0)
        if self.tables.curved:
            st.geodesic_segments_max = self.tables.n_seg
        if self.last_trace_tests is not None:
            st.measured_isect_tests = float(self.last_trace_tests[0])
            st.measured_bbox_tests = float(self.last_trace_tests[1])
        return st

    def render_cell(self, x, y, dx, dy, **kw) -> np.ndarray:
        """Render the cell (x, y, dx, dy) alone (`-p x y dx dy`,
        pathtracer.cpp:583-609): rays only for the cell, so the wall scales
        with its area. Returns its (dy, dx, 3) HDR."""
        hdr, _ = self.render(region=(x, y, dx, dy), **kw)
        return hdr

    def render_to_file(self, path: str, cell=None, progress=None,
                       **kw) -> np.ndarray:
        """Headless render → PNG, plus the reference's sampling-rate
        heatmap `<name>_rate.png` (pathtracer.cpp:684). With `cell` =
        (x, y, dx, dy) only the cell is rendered and pasted into a black
        frame. Other keywords go to `render`."""
        cfg = self.cfg
        if cell is not None:
            x, y, dx, dy = cell
            hdr_cell, count_cell = self.render(
                region=(x, y, dx, dy), progress=progress, **kw)
            hdr = np.zeros((cfg.height, cfg.width, 3), np.float32)
            hdr[y:y + dy, x:x + dx] = hdr_cell
            count = np.zeros((cfg.height, cfg.width), np.int32)
            count[y:y + dy, x:x + dx] = count_cell
        else:
            hdr, count = self.render(progress=progress, **kw)
        if self.writes:
            film.save_image(path, hdr)
            base = path[:-4] if path.endswith(".png") else path
            film.save_sampling_rate_image(base + "_rate.png", count,
                                          cfg.ns_aa)
        if self.mesh is not None:
            pdist.all_processes_done("image")
        return hdr
