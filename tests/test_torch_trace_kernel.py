"""The port's traversal against the JAX package's fused Pallas kernel,
under the rules of tests/test_pallas.py.

On the CPU `trace_rays` runs the plain PyTorch version; the Pallas kernel
runs in interpret mode on one tile of ≤ 1024 rays, and the multi-part scene
goes through the JAX package's XLA trace. The CUDA kernel itself is held
against the plain version on a card by tests/test_torch_kernel_cuda.py and
by chip_smoke.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rrt_tpu.geometry import trace as jtrace
from rrt_tpu.ops.trace_kernel import pallas_trace
from rrt_tpu.scene.build import build_scene as jax_build_scene
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu.types import BlackHoleParams, Rays as JRays
from rrt_tpu_torch.convert import (black_hole_from_arrays, scene_from_arrays,
                                   to_arrays)
from rrt_tpu_torch.geometry import trace as ttrace
from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.physics.schwarzschild import chaotic_lanes
from rrt_tpu_torch.scenes import CBOX_SPHERES, uv_sphere_box
from test_torch_hostmods import jax_scene_info
from rrt_tpu_torch.types import Rays

N_SEG = 63


def _rays(n, seed, lo=(-0.8, 0.35, -0.8), hi=(0.8, 1.15, 0.8)):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    mn, mx = np.zeros(n, np.float32), np.full(n, 1e9, np.float32)
    return (JRays(o=jnp.asarray(o), d=jnp.asarray(d), min_t=jnp.asarray(mn),
                  max_t=jnp.asarray(mx)),
            Rays(o=torch.tensor(o), d=torch.tensor(d), min_t=torch.tensor(mn),
                 max_t=torch.tensor(mx)))


def _holes(pos=(0.0, 1.0, 0.0), r=0.1, dt=0.1):
    return (BlackHoleParams(position=jnp.asarray(pos, jnp.float32),
                            radius=jnp.float32(r),
                            delta_theta=jnp.float32(dt)),
            black_hole_from_arrays(pos, r, dt, "cpu"))


@pytest.fixture(scope="module")
def cbox():
    """Both packages on identical data, 1000 seeded rays (one Pallas
    tile) and the JAX kernel's flat and curved results."""
    js, _ = jax_load_scene(CBOX_SPHERES, 256, 256)
    ts = scene_from_arrays(to_arrays(js), "cpu")
    jr, tr = _rays(1000, 2)
    jbh, tbh = _holes()
    jax_hits = {
        False: pallas_trace(js, None, jr, n_seg=1, interpret=True,
                            return_seg=True),
        True: pallas_trace(js, jbh, jr, n_seg=N_SEG, interpret=True,
                           return_seg=True),
    }
    return dict(js=js, ts=ts, jr=jr, tr=tr, jbh=jbh, tbh=tbh, jax=jax_hits)


@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
def test_plain_matches_pallas(cbox, curved):
    jh, jseg = cbox["jax"][curved]
    tab = tk.build_tables(cbox["ts"], cbox["tbh"] if curved else None)
    th, tseg = tk.kernel_trace(cbox["ts"], tab, cbox["tr"], return_seg=True)
    hit_j, hit_t = np.asarray(jh.hit), th.hit.numpy()
    prim_j, prim_t = np.asarray(jh.prim_id), th.prim_id.numpy()
    if not curved:
        np.testing.assert_array_equal(hit_t, hit_j)
        np.testing.assert_array_equal(prim_t[hit_t], prim_j[hit_j])
        np.testing.assert_allclose(th.p.numpy()[hit_t],
                                   np.asarray(jh.p)[hit_j], atol=2e-4)
        np.testing.assert_array_equal(th.bsdf_id.numpy(),
                                      np.asarray(jh.bsdf_id))
        return
    calm = ~chaotic_lanes(cbox["tr"].o, cbox["tr"].d, cbox["tbh"],
                          N_SEG).numpy()
    assert calm.mean() > 0.3
    np.testing.assert_array_equal(hit_t[calm], hit_j[calm])
    np.testing.assert_array_equal(prim_t[calm], prim_j[calm])
    np.testing.assert_array_equal(tseg.numpy()[calm], np.asarray(jseg)[calm])
    assert (hit_t == hit_j).mean() >= 0.995
    assert (prim_t == prim_j).mean() >= 0.995
    m = calm & hit_t
    # XLA's FMA contraction drifts the chords by ulps (see
    # test_torch_physics.DIR_ATOL); tests/test_pallas.py allows 5e-3
    np.testing.assert_allclose(th.p.numpy()[m], np.asarray(jh.p)[m],
                               atol=5e-3)


def test_any_hit_equals_closest_hit(cbox):
    """Any-hit's hit bool is closest-hit's, absorption included; on calm
    lanes it is also the JAX kernel's closest-hit bool."""
    ts, tbh, tr = cbox["ts"], cbox["tbh"], cbox["tr"]
    any_hit, st_any = ttrace.occluded(ts, tbh, tr, return_stats=True)
    closest, st = ttrace.trace(ts, tbh, tr, return_stats=True)
    np.testing.assert_array_equal(any_hit.numpy(), closest.hit.numpy())
    assert st_any[0] <= st[0]
    calm = ~chaotic_lanes(tr.o, tr.d, tbh, N_SEG).numpy()
    jh, _ = cbox["jax"][True]
    np.testing.assert_array_equal(any_hit.numpy()[calm],
                                  np.asarray(jh.hit)[calm])
    assert (any_hit.numpy() == np.asarray(jh.hit)).mean() >= 0.995


def test_work_counters_bounded(cbox):
    """Counters are per ray here, per tile gate in the JAX kernel, so they
    are bounded, not compared: above zero, below brute force."""
    ts, tbh, tr = cbox["ts"], cbox["tbh"], cbox["tr"]
    for bh, n_seg in ((None, 1), (tbh, N_SEG)):
        h, st = ttrace.trace(ts, bh, tr, return_stats=True)
        n = tr.o.shape[0]
        brute = n * (ts.n_tris + ts.n_live_spheres) * n_seg
        assert 0 < st[0] < brute, (st, brute)
        assert st[1] > 0
        assert h.hit.any()


def test_flat_honours_max_t(cbox):
    o = torch.tensor([[0.6, 0.2, 0.6]])          # under the closed ceiling
    d = torch.tensor([[0.0, 1.0, 0.0]])
    ray = lambda mt: Rays(o=o, d=d, min_t=torch.zeros(1),
                          max_t=torch.tensor([mt]))
    assert ttrace.trace(cbox["ts"], None, ray(10.0)).hit.item()
    assert not ttrace.trace(cbox["ts"], None, ray(0.5)).hit.item()
    assert not ttrace.trace(cbox["ts"], None, Rays(
        o=o, d=d, min_t=torch.tensor([1.5]),
        max_t=torch.tensor([10.0]))).hit.item()


def test_tables_carry_the_mode(cbox):
    """The tables decide flat or curved and the chord count once, from
    the hole: no hole or a disabled one is flat, one segment."""
    ts, tbh = cbox["ts"], cbox["tbh"]
    curved = tk.build_tables(ts, tbh)
    assert curved.curved and curved.n_seg == N_SEG
    for hole in (None, tbh.replace(enabled=False)):
        flat = tk.build_tables(ts, hole)
        assert not flat.curved and flat.n_seg == 1
    fine = tk.build_tables(ts, black_hole_from_arrays((0, 1, 0), 0.1, 0.05,
                                                      "cpu"))
    assert fine.n_seg == 126


def test_lane_into_the_hole_is_absorbed(cbox):
    _, tbh = _holes(pos=(0.0, 0.75, 0.0), r=0.3)
    d = torch.tensor([[-1.0, 0.02, 0.0]])
    rays = Rays(o=torch.tensor([[0.9, 0.75, 0.0]]), d=d / d.norm(),
                min_t=torch.zeros(1), max_t=torch.full((1,), 1e9))
    tab = tk.build_tables(cbox["ts"], tbh)
    out = tk.trace_rays(tab, rays.o, rays.d, rays.min_t, rays.max_t)
    assert out.absd.item() and not out.hit.item()
    assert out.prim.item() == -1 and out.seg.item() < N_SEG


def test_masked_lanes_resolve_dead(cbox):
    """The integrator's masked lanes (origin at the hole's centre) die on
    segment 0 with no hit and no absorption, and cost no tests."""
    n = 64
    tbh = cbox["tbh"]
    o = tbh.position.expand(n, 3).contiguous()
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=
                                                  torch.Generator().manual_seed(0)),
                                      dim=-1)
    tab = tk.build_tables(cbox["ts"], tbh)
    before = tk.LAUNCHES
    out = tk.trace_rays(tab, o, d, torch.zeros(n), torch.full((n,), 1e9))
    assert tk.LAUNCHES == before          # CPU tensors: the plain version
    assert not out.hit.any() and not out.absd.any()
    assert (out.seg == 0).all()
    assert (out.nisect == 0).all() and (out.ncull == 0).all()


def test_no_fallback_for_other_devices(cbox):
    """A tensor that is neither on the CPU nor on a card is refused, not
    traced some other way."""
    tab = tk.build_tables(cbox["ts"], cbox["tbh"])
    meta = lambda *shape: torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="no trace kernel"):
        tk.trace_rays(tab, meta(4, 3), meta(4, 3), meta(4), meta(4))


@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
def test_multipart_matches_jax(curved):
    """A procedural scene of three triangle parts (4544 rows) against the
    JAX package's XLA trace."""
    info = uv_sphere_box()
    js, _ = jax_build_scene(jax_scene_info(info))
    ts = scene_from_arrays(to_arrays(js), "cpu")
    assert tk.build_tables(ts, None).n_parts == 3
    jr, tr = _rays(300, 7, (-0.9,) * 3, (0.9,) * 3)
    jbh, tbh = _holes(pos=(-0.45, -0.35, 0.4), r=0.08) if curved \
        else (None, None)
    jh = jtrace.trace(js, jbh, jr, n_seg=N_SEG if curved else None,
                      backend="xla")
    th = ttrace.trace(ts, tbh, tr)
    hit_j, hit_t = np.asarray(jh.hit), th.hit.numpy()
    m = hit_j & hit_t
    prim_agree = (np.asarray(jh.prim_id)[m] == th.prim_id.numpy()[m]).mean()
    if curved:
        assert (hit_j == hit_t).mean() >= 0.99
        assert prim_agree >= 0.99
    else:
        np.testing.assert_array_equal(hit_t, hit_j)
        assert prim_agree == 1.0
        np.testing.assert_allclose(th.p.numpy()[m], np.asarray(jh.p)[m],
                                   atol=2e-3)
