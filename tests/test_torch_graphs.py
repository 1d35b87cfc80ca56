"""Captured passes and Kerr batches on the CPU: `Renderer._pass_fn` (the
port of the JAX package's jitted pass, rrt_tpu/render/renderer.py:85-123),
`utils/graphs.CapturedCall` and `render/kerr_scene.DiskMarch` (the jitted
Kerr batch, rrt_tpu/render/kerr_scene.py:186: one captured march a
batch, on the CPU the kernel's plain version).

The CPU has no CUDA graphs, so a stand-in takes the graph's place: the
warm-up runs the function, the "capture" runs it as a capture records it
(its Python runs, launches nothing) and puts every buffer back, since a
capture changes none, and a replay runs it again on the same arguments
without the Python launcher's count or the collectives' count. The plain traversal stands in for the
kernel: an eager call adds one to `LAUNCHES`, and every run outside the
capture, replays included, one to the stand-in's `kernel_runs`. What the stand-in
checks is what a replay depends on: that a pass reads everything that
changes between passes from its runner's tensors, its key included. The
`cuda`-marked twins in tests/test_torch_kernel_cuda.py hold the real
graphs to the eager path bit for bit on a card.
"""
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from rrt_tpu.render.renderer import Renderer as JaxRenderer
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu_torch import bench
from rrt_tpu_torch.convert import disk_from_arrays, kerr_params_from_arrays
from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.parallel.distributed import COLLECTIVES
from rrt_tpu_torch.parallel.sharding import batch_sharding, make_mesh
from rrt_tpu_torch.render import kerr_scene as K
from rrt_tpu_torch.render import renderer as renderer_mod
from rrt_tpu_torch.render.renderer import PassRunner, Renderer
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.utils import prng, profile
from rrt_tpu_torch.utils.config import BlackHoleConfig, Illum, RenderConfig
from rrt_tpu_torch.utils.graphs import CapturedCall
from test_torch_hostmods import jax_config

W, H = 24, 16


class StandInGraph:
    def __init__(self, fn, args, mode):
        self.fn, self.args, self.mode = fn, args, mode

    def replay(self):
        """fn run again, as the graph would run it: without the Python
        launcher's count, and without moving the collectives' Python count
        (`CapturedCall` adds a graph's collectives at every replay)."""
        self.mode.update(replaying=True)
        counted = dict(COLLECTIVES)
        try:
            self.fn(*self.args)
        finally:
            self.mode.update(replaying=False)
            COLLECTIVES.update(counted)


def _buffers(args):
    """The tensors a capture must leave as they were."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out += _buffers(a)
        elif isinstance(a, PassRunner):
            out += [*a.acc, a.tests] + ([a.sent] if a.mesh else [])
    return out


@pytest.fixture
def stand_in(monkeypatch):
    mode = dict(capturing=False, replaying=False, runs=0)

    def capture(self, *args):
        bufs = _buffers(args)
        saved = [b.clone() for b in bufs]
        mode.update(capturing=True)
        try:
            self.result = self.fn(*args)
        finally:
            mode.update(capturing=False)
        for b, v in zip(bufs, saved):
            b.copy_(v)
        return StandInGraph(self.fn, args, mode)

    monkeypatch.setattr(CapturedCall, "_warm_up",
                        lambda self, *args: self.fn(*args))
    monkeypatch.setattr(CapturedCall, "_capture", capture)
    plain = tk.trace_rays

    def counted(*a, **kw):
        if not mode["capturing"]:
            mode["runs"] += 1
            tk.LAUNCHES += not mode["replaying"]
        return plain(*a, **kw)
    monkeypatch.setattr(tk, "trace_rays", counted)
    monkeypatch.setattr(tk, "kernel_runs", lambda: mode["runs"])

    def reset():
        tk.LAUNCHES = 0
        mode["runs"] = 0
    monkeypatch.setattr(tk, "reset_counts", reset)


def _cfg(spp=4, **kw):
    kw.setdefault("max_pass_lanes", W * H)
    kw.setdefault("black_hole", BlackHoleConfig(enabled=False))
    kw.setdefault("max_ray_depth", 2)
    return RenderConfig(width=W, height=H, ns_aa=spp, ns_area_light=2,
                        seed=5, **kw)


def _renderer(cfg, graphs=False):
    scene, cam = load_scene(CBOX_SPHERES, "cpu", W, H, fov_mode="native")
    r = Renderer(scene, cam, cfg, "cpu")
    if graphs:          # the stand-in's graphs (a CPU renderer refuses)
        r.graphs, r._pool = True, "stand-in pool"
    return r


def _state(r):
    return [*r.last_accumulators, r.last_trace_tests,
            np.array([r.last_trace_calls, r.samples_done])]


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def test_device_pass_key_is_the_jax_pass_key(stand_in, monkeypatch):
    """The key every pass derives from its runner's tensors (the render's
    key in `base`, the pass's first sample in `sample_idx`), in the eager
    pass, the capture and the replays alike, is the JAX package's pass
    key fold_in(fold_in(key(seed), s), 0) (rrt_tpu/render/renderer.py:
    398, 412-413), for every pass of a render and of a second render of
    another seed through the same runner."""
    derived = []
    real = renderer_mod.pass_key

    def recorded(base, sample_idx, band=0):
        k = real(base, sample_idx, band)
        derived.append(k.clone())
        return k
    monkeypatch.setattr(renderer_mod, "pass_key", recorded)
    r = _renderer(_cfg(spp=4), graphs=True)       # 4 passes of 1 sample
    r.render()
    r.cfg = r.cfg.replace(seed=2**31 - 1)
    r.render()
    passes = [(seed, s) for seed in (5, 2**31 - 1) for s in range(4)]
    # the eager pass, the capture and its replay, then replays
    runs = [passes[0], passes[1], passes[1]] + passes[2:]
    assert len(derived) == len(runs)
    for got, (seed, s) in zip(derived, runs):
        want = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                                     s), 0)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.key_data(want)))


def _tail(r):
    r.render()
    return _state(r)


def _cells(r):
    out = []
    for x, y in ((3, 2), (10, 5), (0, 0)):
        r.render(region=(x, y, 12, 8))
        out += _state(r)
    return out


def _resume(r, tmp_path):
    ckpt = str(tmp_path / "state.npz")
    r.render(checkpoint_path=ckpt, checkpoint_every=2, stop_after=2)
    first = _state(r)
    r.render(checkpoint_path=ckpt, resume=True)
    return first + _state(r)


# (config, what the render does): a tail pass (5 samples at k = 2: 2, 2,
# 1), three cells of one size, an adaptive render across its batch
# boundaries (k = 1, batches of 2), a stop at 2 samples and its resume
SCENARIOS = {
    "tail pass": (dict(spp=5, max_pass_lanes=2 * W * H), _tail),
    "cells of one size": (dict(spp=2, max_pass_lanes=4 * 12 * 8), _cells),
    "adaptive boundary": (dict(spp=8, adaptive=True, samples_per_batch=2,
                               max_tolerance=0.5), _tail),
    "checkpoint and resume": (dict(spp=4), _resume),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_one_runner_serves_every_pass(stand_in, scenario, tmp_path):
    """One pass runner of (k, rw, rh), driven through a tail pass, several
    cells of one size, an adaptive batch boundary or a stop and resume,
    replays to the same accumulators, counters and trace calls as the
    eager passes."""
    kw, run = SCENARIOS[scenario]
    args = (tmp_path,) if run is _resume else ()
    eager = run(_renderer(_cfg(**kw)), *args)
    r = _renderer(_cfg(**kw), graphs=True)
    got = run(r, *args)
    assert _equal(got, eager)
    (runner,) = r._pass_fns.values()
    assert runner.call.replays >= 2
    if scenario == "adaptive boundary":
        done = r.last_accumulators[4]
        assert done.any() and not done.all()


def test_kernel_runs_count_replays(stand_in):
    """Over a render of one eager pass, a captured and replayed pass and a
    replay, and again over a render of replays only: the kernel's runs
    equal the trace calls (`last_trace_calls`), while `LAUNCHES` counts
    the eager pass's launches alone, since a capture launches nothing and
    a replay calls no Python launcher."""
    r = _renderer(_cfg(spp=3), graphs=True)
    for replays, eager_passes in ((2, 1), (5, 0)):
        tk.reset_counts()
        r.render()
        (runner,) = r._pass_fns.values()
        per_pass = runner.call.result
        assert runner.call.replays == replays and per_pass > 0
        assert tk.kernel_runs() == r.last_trace_calls == 3 * per_pass
        assert tk.LAUNCHES == eager_passes * per_pass
        assert r.last_warm_samples == (2 if eager_passes else 0)


def test_one_pass_is_never_captured(stand_in):
    """A shape's first pass runs eagerly and its capture waits for its
    second pass, so a render of one pass captures nothing; the next render
    of the shape captures and replays."""
    r = _renderer(_cfg(spp=2, max_pass_lanes=2 * W * H), graphs=True)
    r.render()
    (runner,) = r._pass_fns.values()
    assert runner.call.graph is None and runner.passes == 1
    assert r.last_warm_samples == 2
    r.render()
    assert runner.call.graph is not None and runner.call.replays == 1
    r.render()
    assert runner.call.replays == 2 and r.last_warm_samples == 0


def test_graph_cells_match_jax_render_cell(stand_in):
    """Two NORMAL cells of one size through one captured pass (the second
    replays the first's graph with another origin) against the JAX
    package's render_cell, at test_torch_lifecycle.py's tolerances:
    triangle pixels to rtol 1e-5, sphere pixels to atol 1e-4."""
    cfg = _cfg(1, illum=Illum.NORMAL, max_ray_depth=1)
    js, jcam = jax_load_scene(CBOX_SPHERES, W, H, fov_mode="native")
    jr = JaxRenderer(js, jcam, jax_config(cfg.replace(
        max_dispatch_seconds=0)))
    r = _renderer(cfg, graphs=True)
    for cell in ((2, 3, 12, 8), (11, 6, 12, 8)):
        got, want = r.render_cell(*cell), jr.render_cell(*cell)
        x, y, dx, dy = cell
        xy = torch.stack(torch.meshgrid(
            (torch.arange(x, x + dx) + 0.5) / W,
            (torch.arange(y, y + dy) + 0.5) / H, indexing="xy"), -1)
        prim = tk.kernel_trace(r.scene, r.tables, r.camera.generate_rays(
            xy.to(torch.float32))).prim_id.numpy()
        tri = prim < r.scene.n_tris
        np.testing.assert_allclose(got[tri], want[tri], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(got[~tri], want[~tri], rtol=0, atol=1e-4)
    assert r._pass_fns[(1, 12, 8)].call.replays == 1


def test_kerr_blocks_equal_the_step_by_step_march(stand_in):
    """`DiskMarch` marches a batch as one call of the Kerr march (on the
    CPU its plain version) through one `CapturedCall` per (batch shape,
    steps): three marches of one batch (the first eager, the second
    captured and replayed, the third replayed) each equal the
    step-by-step march bit for bit: state, disk radiance, hit mask and
    the three counters (live lane-steps, lane-steps, issued lane-slots).
    Another step count is a call of its own."""
    steps = 50
    bh = kerr_params_from_arrays((0.0, 0.0, 0.0), 1.0, 0.9, "cpu")
    disk = disk_from_arrays(3.0, 12.0, (1.0, 0.85, 0.6), 2.0, True, "cpu")
    o, d = K.look_at_rays((0.0, 3.0, 22.0), (0.0, 0.0, 0.0),
                          (0.0, 1.0, 0.0), 30.0, 12, 12, device="cpu")
    want_counts = torch.zeros(3, dtype=torch.int64)
    want = K.trace_disk(o, d, bh, disk, steps, counts=want_counts)
    march = K.DiskMarch(bh, disk)
    march._pool = "stand-in pool"
    for _ in range(3):
        counts = torch.zeros(3, dtype=torch.int64)
        got = K.trace_disk(o, d, bh, disk, steps, march=march,
                           counts=counts)
        for a, b in zip((*got[0], got[1], got[2]),
                        (*want[0], want[1], want[2])):
            assert torch.equal(a, b)
        assert torch.equal(counts, want_counts)
    assert [(s, c.calls, c.replays) for (_, s), c in march.calls.items()] \
        == [(steps, 3, 2)]
    live, run, issued = want_counts.tolist()
    # 144 lanes are 5 warps: the ragged warp's slots count too
    assert 0 < live < issued <= 160 * steps and run == 144 * steps
    assert bool(want[2].any())     # some lanes reach the disk
    K.trace_disk(o, d, bh, disk, 10, march=march)
    assert [s for _, s in march.calls] == [steps, 10]
    with pytest.raises(ValueError, match="another hole"):
        K.trace_disk(o, d, bh, disk, steps, r_escape=30.0, march=march)


@pytest.mark.parametrize("jittered", [False, True])
def test_kerr_camera_rays_equal_look_at_rays(stand_in, jittered):
    """`DiskMarch.camera_rays` writes a batch's camera rays through one
    `CapturedCall` per (lanes, width, height, fov, jittered), reading the
    batch's offset, the camera and the sample's whole jitter from static
    buffers: at three offsets (eager, captured and replayed, replayed)
    they equal `look_at_rays` of the batch's pixels, jittered by the
    batch's window of the draw, bit for bit, in the march's static rays,
    which the march then takes without a copy."""
    bh = kerr_params_from_arrays((0.0, 0.0, 0.0), 1.0, 0.9, "cpu")
    disk = disk_from_arrays(3.0, 12.0, (1.0, 0.85, 0.6), 2.0, True, "cpu")
    march = K.DiskMarch(bh, disk)
    march._pool = "stand-in pool"
    w, h, m = 12, 10, 40
    frame = torch.tensor([(0.0, 3.0, 22.0), (0.0, 0.0, 0.0),
                          (0.0, 1.0, 0.0)])
    key = prng.key(3, "cpu")
    draw = prng.uniform(key, (w * h, 2)) if jittered else None
    for lo in (40, 0, 80):
        o, d = march.camera_rays(frame, 30.0, w, h, draw, lo, m)
        window = (prng.uniform(key, (w * h, 2), window=(0, lo, lo + m))
                  if jittered else None)
        want = K.look_at_rays((0.0, 3.0, 22.0), (0.0, 0.0, 0.0),
                              (0.0, 1.0, 0.0), 30.0, w, h, window, "cpu",
                              (lo, lo + m))
        assert torch.equal(o, want[0]) and torch.equal(d, want[1])
        bufs = march._buffers[(m,)]
        assert bufs[0] is o and bufs[1] is d
        lanes, _ = march(o, d, 5)
        assert lanes is bufs[2]
    ((key_, (_, _, jit, call)),) = march.cameras.items()
    assert key_ == (m, w, h, 30.0, jittered) and (jit is None) != jittered
    assert (call.calls, call.replays) == (3, 2)


def test_a_failed_capture_raises_where_it_broke(monkeypatch):
    """A capture (at the second call) that fails raises with the package
    line it broke at, and nothing falls back to eager: the next call tries
    to capture again."""
    monkeypatch.setattr(CapturedCall, "_warm_up", lambda self, *a: None)
    monkeypatch.setattr(CapturedCall, "_capture",
                        lambda self, *a: self.fn(*a))
    bad = torch.zeros(2)
    call = CapturedCall(lambda: tk._check("o", bad, bad.device, (3,)),
                        "cpu", name="a broken pass")
    call()                 # the warm-up
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"a broken pass .* failed at "
                           r"rrt_tpu_torch/ops/trace_kernel\.py:\d+"):
            call()
        assert call.graph is None


def test_graphs_only_on_a_card():
    """Passes are captured only on CUDA: a CPU renderer runs eagerly, and
    asking for graphs on the CPU (renderer or Kerr) raises for the device,
    with a lane mesh (a world of 1 without a group) or without; the mesh
    alone refuses nothing."""
    cfg = _cfg(1)
    scene, cam = load_scene(CBOX_SPHERES, "cpu", W, H, fov_mode="native")
    bh = kerr_params_from_arrays((0.0, 0.0, 0.0), 1.0, 0.9, "cpu")
    disk = disk_from_arrays(3.0, 12.0, (1.0, 0.85, 0.6), 2.0, True, "cpu")
    sharding = batch_sharding(make_mesh("cpu"))
    for kw in (dict(), dict(sharding=sharding)):
        assert not Renderer(scene, cam, cfg, "cpu", **kw).graphs
        with pytest.raises(ValueError, match="CUDA graphs need a CUDA "
                           "device, not cpu"):
            Renderer(scene, cam, cfg, "cpu", graphs=True, **kw)
        with pytest.raises(ValueError, match="CUDA graphs need a CUDA "
                           "device, not cpu"):
            K.render_image(4, 4, bh, disk, n_steps=2, device="cpu",
                           graphs=True, **kw)


def test_camera_frame_is_kept_and_refreshed_in_place():
    """The camera's device frame is made once and refreshed in place when
    the camera moves, so that a captured pass reading it sees the move."""
    _, cam = load_scene(CBOX_SPHERES, "cpu", W, H)
    c2w, pos = cam.frame(torch.float32, "cpu")
    assert cam.frame(torch.float32, "cpu")[0] is c2w
    cam.pos = cam.pos + np.array([0.5, 0.0, 0.0])
    c2w2, pos2 = cam.frame(torch.float32, "cpu")
    assert c2w2 is c2w and pos2 is pos
    assert torch.equal(pos, torch.as_tensor(cam.pos, dtype=torch.float32))


def test_host_launch_count():
    """Host launches from a trace's runtime events: kernel launches, memsets,
    copies and graph launches, on the CPU side only."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = lambda name, dev=cpu: SimpleNamespace(name=name, device_type=dev)
    events = [ev("cudaGraphLaunch"), ev("cudaLaunchKernel"),
              ev("cudaLaunchKernel"), ev("cudaMemsetAsync"),
              ev("aten::add"), ev("cudaLaunchKernel", cuda),
              ev("cudaStreamSynchronize")]
    assert profile.host_launches(events) == (4, 1)
    assert profile.launch_line(4, 1, 2) == \
        "host launches: 4, 2.0 a pass over 2 (1 graph replays)"
    assert "not measured" in profile.launch_line(0, 0, 2)


def test_bench_headline_is_the_median_of_its_renders(monkeypatch):
    """The bench times TIMED_RENDERS warm renders after two warm-ups (the
    pass's eager run and its capture) and reports their median wall."""
    monkeypatch.setattr(bench.torch.cuda, "synchronize", lambda d=None: None)
    ticks = iter([0.0, 1.0, 1.0, 1.5, 1.5, 4.5, 4.5, 5.0, 5.0, 7.0])
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(ticks))
    calls = []
    fake = SimpleNamespace(
        render=lambda: calls.append(1) or (np.zeros((2, 2, 3)), None),
        stats=lambda wall: SimpleNamespace(wall_seconds=wall),
        last_trace_calls=3)
    _, st, walls, traces = bench._timed_render(fake, "cpu")
    assert len(calls) == bench.TIMED_RENDERS + 2
    assert traces == 3 * len(calls)
    assert walls == [1.0, 0.5, 3.0, 0.5, 2.0]
    assert math.isclose(st.wall_seconds, 1.0)
