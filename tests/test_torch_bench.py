"""The port's bench and its BVH-scale scene against the JAX package.

`scenes.cbox_dense()` built by both packages gives the same tables, and
the port's plain traversal of it agrees with the JAX package's XLA trace.
The bench itself runs on a card only; here it must refuse, and its JSON
assembly and flop model are fed the stats of a small CPU render, whose
trace counts equal the JAX renderer's.
"""
import json
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rrt_tpu.geometry import trace as jtrace
from rrt_tpu.ops.trace_kernel import _cs_k as jax_cs_k
from rrt_tpu.render.renderer import Renderer as JaxRenderer
from rrt_tpu.scene.build import build_scene as jax_build_scene
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu.types import BlackHoleParams, Rays as JRays
from rrt_tpu_torch import bench
from rrt_tpu_torch.convert import (black_hole_from_arrays, scene_from_arrays,
                                   to_arrays)
from rrt_tpu_torch.geometry import trace as ttrace
from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.render.renderer import Renderer
from rrt_tpu_torch.scene.build import build_scene, load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES, cbox_dense
from rrt_tpu_torch.types import Rays
from rrt_tpu_torch.utils import card as tcard
from rrt_tpu_torch.utils.config import RenderConfig
from test_torch_hostmods import jax_config, jax_scene_info

N_SEG = 63


@pytest.fixture(scope="module")
def dense():
    info = cbox_dense()
    js, _ = jax_build_scene(jax_scene_info(info), 128, 128)
    ts, _ = build_scene(info, "cpu", 128, 128)
    return js, ts


def test_dense_scene_tables_match_jax(dense, monkeypatch):
    monkeypatch.delenv("RRT_CSK", raising=False)
    js, ts = dense
    ja, ta = to_arrays(js), to_arrays(ts)
    assert ja["env"] is ta["env"] is None
    assert ja.keys() == ta.keys()
    for k, v in ta.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, ja[k], err_msg=k)
    assert ts.n_tris == js.n_tris > 8192
    assert ts.n_live_spheres == 0
    tab = tk.build_tables(ts, None)
    assert tab.cs_k == jax_cs_k(js.n_tris) == 8
    assert tab.n_parts >= 14
    # the default hole lies inside the box and outside the mesh
    tri = np.stack([ta["tri_v0"], ta["tri_v1"], ta["tri_v2"]], 1)
    dist = np.linalg.norm(tri - np.array([0.0, 1.0, 0.0]), axis=-1)
    assert dist.min() > 0.2


@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
def test_dense_trace_matches_jax(dense, curved):
    """The plain traversal of 14 parts against the JAX package's XLA
    trace, under the rules of tests/test_torch_trace_kernel.py."""
    js, ts = dense
    rng = np.random.default_rng(11)
    n = 256
    o = rng.uniform((-0.8, 0.35, -0.8), (0.8, 1.15, 0.8),
                    (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    mn, mx = np.zeros(n, np.float32), np.full(n, 1e9, np.float32)
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d), min_t=jnp.asarray(mn),
               max_t=jnp.asarray(mx))
    tr = Rays(o=torch.tensor(o), d=torch.tensor(d), min_t=torch.tensor(mn),
              max_t=torch.tensor(mx))
    jbh = tbh = None
    if curved:
        jbh = BlackHoleParams(position=jnp.asarray((0.0, 1.0, 0.0),
                                                   jnp.float32),
                              radius=jnp.float32(0.1),
                              delta_theta=jnp.float32(0.1))
        tbh = black_hole_from_arrays((0, 1, 0), 0.1, 0.1, "cpu")
    jh = jtrace.trace(js, jbh, jr, n_seg=N_SEG if curved else None,
                      backend="xla")
    th, st = ttrace.trace(ts, tbh, tr, return_stats=True)
    hit_j, hit_t = np.asarray(jh.hit), th.hit.numpy()
    prim_j, prim_t = np.asarray(jh.prim_id), th.prim_id.numpy()
    assert hit_t.mean() > 0.5 and st[0] > 0
    if not curved:
        np.testing.assert_array_equal(hit_t, hit_j)
        np.testing.assert_array_equal(prim_t[hit_t], prim_j[hit_j])
        np.testing.assert_allclose(th.p.numpy()[hit_t],
                                   np.asarray(jh.p)[hit_j], atol=2e-3)
        return
    from rrt_tpu_torch.physics.schwarzschild import chaotic_lanes
    calm = ~chaotic_lanes(tr.o, tr.d, tbh, N_SEG).numpy()
    assert calm.mean() > 0.3
    np.testing.assert_array_equal(hit_t[calm], hit_j[calm])
    np.testing.assert_array_equal(prim_t[calm], prim_j[calm])
    assert (hit_t == hit_j).mean() >= 0.99
    assert (prim_t == prim_j).mean() >= 0.99


def test_bench_refuses_without_cuda(monkeypatch, capsys):
    """No card, no bench: no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(ValueError, match="CUDA card"):
        bench.run("cpu")


SMALL = dict(width=16, height=16, ns_aa=2, ns_area_light=2, max_ray_depth=2,
             seed=0, max_dispatch_seconds=0)


def test_bench_result_from_a_cpu_render():
    """The JSON object and the flop model, fed the stats of a 16×16
    curved-GI render on the CPU; its trace counts equal the JAX
    renderer's on the same config."""
    cfg = RenderConfig(**SMALL)
    ts, tcam = load_scene(CBOX_SPHERES, "cpu", 256, 256)
    r = Renderer(ts, tcam, cfg, "cpu")
    hdr, _ = r.render()
    st = r.stats(0.5)
    js, jcam = jax_load_scene(CBOX_SPHERES, 256, 256)
    jr = JaxRenderer(js, jcam, jax_config(cfg))
    jr.render()
    jst = jr.stats()
    for f in ("camera_rays", "shadow_rays", "bounce_rays",
              "geodesic_segments_max", "total_rays"):
        assert getattr(st, f) == getattr(jst, f), f
    assert st.camera_rays == 16 * 16 * 2 and st.geodesic_segments_max == N_SEG

    bvh = r.stats(0.25)
    peak = 66.9e12
    out = bench.bench_result(st, bvh, float(np.mean(hdr)), 3.5, False, peak,
                             "NVIDIA H100 80GB HBM3, 700.00 W")
    assert json.loads(json.dumps(out)) == out
    total = st.total_rays
    flops = total * N_SEG * 58 + total * 40 + st.camera_rays * 200
    assert bench.useful_flops(st) == flops
    assert out["value"] == st.camera_rays / 0.5
    assert out["marched_rays_per_sec"] == total / 0.5
    assert out["geodesic_steps_per_sec"] == total * N_SEG / 0.5
    assert out["mfu_lower_bound_pct"] == pytest.approx(
        100.0 * flops / 0.5 / peak, rel=1e-12)
    assert out["bvh_camera_rays_per_sec"] == st.camera_rays / 0.25
    assert out["prim_tests_per_ray"] == st.measured_isect_tests / total > 0
    assert out["bbox_tests_per_ray"] > 0
    assert out["mean_radiance"] > 0 and out["trace_backend"] == "cuda"
    assert out["unit"] == "rays/s/gpu" and "vs_baseline" not in out
    assert (out["device"], out["power_limit"]) == \
        ("NVIDIA H100 80GB HBM3", "700.00 W")
    assert out["build_seconds"] == 3.5 and out["build_cached"] is False


def test_fp32_peak_of_an_h100(monkeypatch):
    """SMs × 128 float32 lanes × 2 flops × max SM clock: 66.9 TFLOP/s on
    an H100 SXM (132 SMs at 1980 MHz)."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    assert tcard.fp32_peak_flops("cuda", 1980.0) == pytest.approx(66.9e12,
                                                                  rel=1e-3)
