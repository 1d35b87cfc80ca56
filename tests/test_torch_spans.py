"""The program's spans and counters (`rrt_tpu_torch/utils/stats.py`) on
the CPU: nesting and self time, collection only while a profiler is
active or inside `collect()`, the spans among the profiler's events, the
integrator's live-lane counts, and the benchmark's readers of them
(`cardbench/metrics`). The card's side (event pairs inside replayed
graphs) is in tests/test_torch_kernel_cuda.py.
"""
import math
import time

import numpy as np
import pytest
import torch

from cardbench import harness
from rrt_tpu_torch.geometry import trace as ttrace
from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.render import diff
from rrt_tpu_torch.render.integrator import est_radiance
from rrt_tpu_torch.render.renderer import Renderer, make_black_hole
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.utils import prng, stats
from rrt_tpu_torch.utils.config import BlackHoleConfig, RenderConfig

SIZE = 8
FRAME_READERS = ("camera_ms.frame", "nee_ms.frame", "bounce_ms.frame",
                 "accumulate_ms.frame", "live_lanes_pct.frame")
STEP_READERS = ("forward_ms.step", "backward_ms.step", "update_ms.step")
SETUP_READERS = ("scene_s.setup", "eager_s.setup", "capture_s.setup")


@pytest.fixture(autouse=True)
def clean():
    """Every test starts and leaves with an empty store."""
    stats.reset()
    yield
    stats.reset()


@pytest.fixture(scope="module")
def box():
    """The spheres box with its default hole, -l 2 -m 4, 8×8, 2 spp: the
    benchmark's `spheres-hole` scene at a CPU's size."""
    cfg = RenderConfig(width=SIZE, height=SIZE, ns_aa=2, ns_area_light=2,
                       max_ray_depth=4, seed=11)
    scene, cam = load_scene(CBOX_SPHERES, "cpu", SIZE, SIZE)
    return cfg, scene, cam


def _read(name):
    return harness.load_module("metrics", name).read({})


def test_spans_nest_and_self_time_is_the_rest():
    with stats.collect():
        with stats.span("outer"):
            time.sleep(0.01)
            with stats.span("inner.a", "cpu"):
                time.sleep(0.01)
                with stats.span("host.inside"):
                    with stats.span("inner.deep", "cpu"):
                        time.sleep(0.005)
            with stats.span("inner.b"):
                time.sleep(0.005)
    host = stats.HOST
    outer, a, b = (host[p] for p in (("outer",), ("outer", "inner.a"),
                                     ("outer", "inner.b")))
    assert outer[1] == pytest.approx(a[0] + b[0], abs=1e-12)
    assert outer[0] - outer[1] == pytest.approx(0.01, abs=0.01)
    assert outer[0] >= a[0] + b[0] > 0.02
    assert [r[2] for r in (outer, a, b)] == [1, 1, 1]
    # device spans nest among device spans, the host span between left out
    dev = stats.COLLECTED.device
    assert set(dev) == {("inner.a",), ("inner.a", "inner.deep")}
    assert dev[("inner.a",)][1] == dev[("inner.a", "inner.deep")][0]
    assert dev.self_seconds() == pytest.approx(dev[("inner.a",)][0])
    assert dev.self_seconds(["inner.a"]) == pytest.approx(
        dev[("inner.a",)][0] - dev[("inner.a", "inner.deep")][0])
    # the collected host spans, and one row a name however deep
    assert stats.COLLECTED.host.count("outer") == 1
    with stats.span("outer"):
        with stats.span("outer"):
            pass
    assert host.count("outer") == 2 and host.seconds("outer") > 0.025
    assert stats.report().startswith("outer: ")


def test_an_uncollected_render_reads_no_device_spans_or_counters(box):
    cfg, scene, cam = box
    r = Renderer(scene, cam, cfg, "cpu")
    r.render()
    assert not stats.COLLECTED
    assert stats.HOST.count("render.frame") == 1
    assert stats.HOST.count("vertex.nee") == cfg.max_ray_depth
    # the counters still ride the pass; only their reading waits
    assert r.last_trace_tests.shape == (4,)
    assert r.last_trace_tests[3] == SIZE * SIZE * cfg.ns_aa \
        * cfg.max_ray_depth


def test_the_profiler_sees_the_spans_and_the_store_collects(box):
    # flat: the plain traversal of curved chords is thousands of small ops,
    # each of which the profiler records
    cfg, scene, cam = box
    cfg = cfg.replace(black_hole=BlackHoleConfig(enabled=False))
    r = Renderer(scene, cam, cfg, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.render()
    names = {ev.name for ev in prof.events()}
    assert {"render.frame", "render.launch", "render.readback",
            "render.resolve", "pass.camera", "pass.camera_hit",
            "vertex.nee", "vertex.bounce", "pass.accumulate",
            "trace.closest", "trace.anyhit"} <= names
    got = stats.COLLECTED
    assert got.host.count("render.frame") == 1
    assert got.device.count("vertex.nee") == cfg.max_ray_depth
    assert got.device.count("vertex.bounce") == cfg.max_ray_depth - 1
    # a kernel span sits inside the phase that launched it
    assert ("vertex.nee", "trace.anyhit") in got.device
    assert ("vertex.bounce", "trace.closest") in got.device
    assert ("pass.camera_hit", "trace.closest") in got.device
    assert got.counters["lanes.run"] == r.last_trace_tests[3]
    assert got.counters["lanes.live"] == r.last_trace_tests[2]
    before = len(stats.COLLECTED.device)
    r.render()       # no profiler, no collect(): nothing more is read
    assert len(stats.COLLECTED.device) == before
    assert stats.COLLECTED.host.count("render.frame") == 1


def test_live_lanes_follow_the_paths(box):
    cfg, scene, cam = box
    bh = make_black_hole(cfg, "cpu")
    tab = tk.build_tables(scene, bh)
    xy = np.random.default_rng(4).uniform(0.0, 1.0, (50, 2))
    rays = cam.generate_rays(torch.tensor(xy, dtype=torch.float32))
    _, work = est_radiance(scene, bh, rays, cfg, prng.key(9), tab)
    live = [float(x) for x in work.live]
    assert len(live) == cfg.max_ray_depth
    hits = ttrace.trace(scene, bh, rays, tables=tab).hit
    assert live[0] == float(hits.sum()) > 0
    assert all(b <= a for a, b in zip(live, live[1:]))
    assert live[-1] < live[0]           # misses and roulette end paths
    assert work.run == 50 * cfg.max_ray_depth
    # the renderer sums them into its counters, pass by pass
    r = Renderer(scene, cam, cfg, "cpu")
    r.render()
    lanes = SIZE * SIZE * cfg.ns_aa
    assert r.last_trace_tests[3] == lanes * cfg.max_ray_depth
    assert 0 < r.last_trace_tests[2] < r.last_trace_tests[3]
    assert r.stats().measured_isect_tests == r.last_trace_tests[0]


@pytest.mark.parametrize("name", FRAME_READERS + STEP_READERS
                         + SETUP_READERS)
def test_readers_none_on_an_empty_store(name):
    assert _read(name) is None


def test_frame_and_setup_readers_after_a_collected_render(box):
    cfg, scene, cam = box
    r = Renderer(scene, cam, cfg, "cpu")
    with stats.collect():
        r.render()
    for name in FRAME_READERS + SETUP_READERS:
        v = _read(name)
        assert v is not None and math.isfinite(v), name
    assert 0 < _read("live_lanes_pct.frame") < 100
    assert _read("nee_ms.frame") > 0
    for name in STEP_READERS:        # no step was collected
        assert _read(name) is None


def test_step_readers_after_a_collected_step(box):
    _, scene, cam = box
    cfg = RenderConfig(width=4, height=4, ns_aa=1, ns_area_light=1,
                       max_ray_depth=2, seed=3)
    bh = make_black_hole(cfg, "cpu")
    xy = torch.rand(16, 2, generator=torch.Generator().manual_seed(2))
    target = torch.full((16, 3), 0.25)
    step = diff.LossAndGrad(scene, bh, cfg, cam.generate_rays(xy), target)
    params = diff.params_from_scene(scene, bh)
    with stats.collect():
        step.train_step(params, None, prng.key(5), 0.01)
    for name in STEP_READERS:
        v = _read(name)
        assert v is not None and math.isfinite(v) and v > 0, name
    got = stats.COLLECTED
    assert got.host.count("step") == 1
    assert got.device.count("trace.closest") >= 1
    assert ("step.forward", "pass.camera_hit", "trace.closest") in \
        got.device
