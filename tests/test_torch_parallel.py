"""The port's lane sharding (`rrt_tpu_torch/parallel/`) against the JAX
package's and against the port's own unsharded paths, in one process.

The block split and the padding are held to JAX's `P("batch")` blocks on
conftest's 8 virtual devices; the sharded trace, run rank by rank, to the
unsharded trace bit for bit and to JAX's `trace(mesh=)` under the parity
rules (ROADMAP.md: flat hit and prim exact, p to atol 2e-4; curved calm
lanes exact, ≥ 99.5% of all); windowed draws to JAX's whole draw; and, in a
gloo world of 1, `trace`/`occluded(mesh=)`, `est_radiance(mesh=)` and
`Renderer(sharding=)` to their unsharded results bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rrt_tpu.geometry import trace as jtrace
from rrt_tpu.parallel import sharding as jsh
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu.types import BlackHoleParams as JBlackHole, Rays as JRays
from rrt_tpu_torch.convert import (black_hole_from_arrays, scene_from_arrays,
                                   to_arrays)
from rrt_tpu_torch.geometry import trace as ttrace
from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.parallel import distributed as pdist
from rrt_tpu_torch.parallel import sharding as sh
from rrt_tpu_torch.physics.schwarzschild import chaotic_lanes
from rrt_tpu_torch.render.integrator import est_radiance, lane_uniform
from rrt_tpu_torch.render.renderer import Renderer, make_black_hole
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.types import Hit, Rays
from rrt_tpu_torch.utils import prng
from rrt_tpu_torch.utils.config import RenderConfig

N_SEG = 63
HIT_FIELDS = [f for f in Hit.__dataclass_fields__]


@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("n", [509, 512, 1])
def test_blocks_match_jax(n, world):
    """pad_to_multiple is JAX's, and shard_bounds gives each rank the
    block that P("batch") puts on the mesh's device of that index."""
    npad = sh.pad_to_multiple(n, world)
    assert npad == jsh.pad_to_multiple(n, world)
    mesh = Mesh(np.array(jax.devices()[:world]), ("batch",))
    arr = jax.device_put(jnp.arange(npad), NamedSharding(mesh, P("batch")))
    where = {s.device: s.index[0] for s in arr.addressable_shards}
    blocks = []
    for rank, d in enumerate(mesh.devices.flat):
        lo, hi = sh.shard_bounds(n, rank, world)
        assert (lo, hi) == (where[d].start or 0, where[d].stop or npad)
        blocks.append((lo, hi))
    assert blocks[0][0] == 0 and blocks[-1][1] == npad
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))


@pytest.fixture(scope="module")
def cbox():
    """The in-repo box in both packages (the port's scene from the JAX
    package's arrays) and 512 seeded rays from inside the box (most of a
    camera's rays pass within 5 radii of the hole, where parity is only
    statistical)."""
    js, _ = jax_load_scene(CBOX_SPHERES, 64, 64, fov_mode="native")
    ts = scene_from_arrays(to_arrays(js), "cpu")
    rng = np.random.default_rng(0)
    o = rng.uniform((-0.8, 0.35, -0.8), (0.8, 1.15, 0.8), (512, 3))
    d = rng.normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(o=torch.tensor(o, dtype=torch.float32),
                d=torch.tensor(d, dtype=torch.float32),
                min_t=torch.zeros(512), max_t=torch.full((512,), 1e9))
    jbh = JBlackHole(position=jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
                     radius=jnp.float32(0.1), delta_theta=jnp.float32(0.1))
    tbh = black_hole_from_arrays((0.0, 1.0, 0.0), 0.1, 0.1, "cpu")
    return dict(js=js, ts=ts, rays=rays, jbh=jbh, tbh=tbh)


def _cut(rays, n):
    return Rays(o=rays.o[:n], d=rays.d[:n], min_t=rays.min_t[:n],
                max_t=rays.max_t[:n])


@pytest.mark.parametrize("n", [512, 509])
@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
def test_blocks_of_padded_lanes_equal_the_whole_trace(cbox, curved, n):
    """World 8, rank by rank: `pad_dead_lanes` to a multiple of 8, each
    rank's block traced, the blocks put together and cut: equal to the
    unsharded trace bit for bit, and to JAX's trace(mesh=) on 8 devices
    under the parity rules."""
    world = 8
    tbh = cbox["tbh"] if curved else None
    tab = tk.build_tables(cbox["ts"], tbh)
    rays = _cut(cbox["rays"], n)
    whole = tk.kernel_trace(cbox["ts"], tab, rays)
    padded = sh.pad_dead_lanes(rays, sh.pad_to_multiple(n, world), tbh)
    parts = []
    for rank in range(world):
        mesh = sh.LaneMesh(None, rank, world, torch.device("cpu"), None)
        parts.append(tk.kernel_trace(cbox["ts"], tab,
                                     sh.shard_batch(padded, mesh)))
    for f in HIT_FIELDS:
        joined = torch.cat([getattr(p, f) for p in parts])[:n]
        assert torch.equal(joined, getattr(whole, f)), f

    jr = JRays(o=jnp.asarray(rays.o.numpy()), d=jnp.asarray(rays.d.numpy()),
               min_t=jnp.asarray(rays.min_t.numpy()),
               max_t=jnp.asarray(rays.max_t.numpy()))
    jh = jtrace.trace(cbox["js"], cbox["jbh"] if curved else None, jr,
                      mesh=jsh.make_mesh())
    hit_j, hit_t = np.asarray(jh.hit), whole.hit.numpy()
    prim_j, prim_t = np.asarray(jh.prim_id), whole.prim_id.numpy()
    if not curved:
        np.testing.assert_array_equal(hit_t, hit_j)
        np.testing.assert_array_equal(prim_t[hit_t], prim_j[hit_j])
        np.testing.assert_allclose(whole.p.numpy()[hit_t],
                                   np.asarray(jh.p)[hit_j], atol=2e-4)
        return
    calm = ~chaotic_lanes(rays.o, rays.d, tbh, N_SEG).numpy()
    assert calm.mean() > 0.3
    np.testing.assert_array_equal(hit_t[calm], hit_j[calm])
    np.testing.assert_array_equal(prim_t[calm], prim_j[calm])
    assert (hit_t == hit_j).mean() >= 0.995
    assert (prim_t == prim_j).mean() >= 0.995


def test_dead_lanes_end_at_once(cbox):
    """The padding's rays: at the hole's centre with d = (1, 0, 0) in
    curved mode, an empty range in flat mode; no hit either way, and no
    test at all in curved mode."""
    rays = _cut(cbox["rays"], 5)
    for tbh in (cbox["tbh"], None):
        padded = sh.pad_dead_lanes(rays, 8, tbh)
        assert padded.o.shape == (8, 3) and padded.max_t.shape == (8,)
        assert torch.equal(padded.o[:5], rays.o)
        pad = Rays(o=padded.o[5:], d=padded.d[5:], min_t=padded.min_t[5:],
                   max_t=padded.max_t[5:])
        assert torch.equal(pad.d, torch.tensor([[1.0, 0.0, 0.0]] * 3))
        assert (pad.min_t == 0).all() and (pad.max_t == -1).all()
        if tbh is not None:
            assert torch.equal(pad.o, tbh.position.expand(3, 3))
        h, st = tk.kernel_trace(cbox["ts"], tk.build_tables(cbox["ts"], tbh),
                                pad, return_stats=True)
        assert not h.hit.any()
        if tbh is not None:
            assert st.sum() == 0
    assert sh.pad_dead_lanes(rays, 5, None) is rays


def test_shard_batch_pads_with_zeros():
    x = torch.arange(10.0)
    blocks = [sh.shard_batch(x, sh.LaneMesh(None, r, 4, torch.device("cpu"),
                                            None)) for r in range(4)]
    assert [b.shape[0] for b in blocks] == [3, 3, 3, 3]
    assert torch.equal(torch.cat(blocks), torch.cat([x, torch.zeros(2)]))


SHAPES = [((509, 2), 0), ((509,), 0), ((4, 509, 2), 1), ((1, 509, 2), 1)]


@pytest.mark.parametrize("shape,axis", SHAPES)
def test_window_draws_tile_the_whole_draw(shape, axis):
    """Every shape the integrator and the camera draw (jitter, lens,
    light samples, roulette, BSDF; the hemisphere draw's lanes on axis
    1): the blocks of 3 ranks' windows (`prng.uniform(window=)`, as
    `integrator.lane_uniform` asks for them) put together equal the whole
    draw of `jax.random.uniform` bit for bit, and so does the draw
    without a window; a lane axis of another width than the lanes'
    raises."""
    n = shape[axis]
    key = prng.key(5)
    whole = np.asarray(jax.random.uniform(jax.random.key(5), shape))
    assert np.array_equal(prng.uniform(key, shape).numpy(), whole)
    parts = []
    for rank in range(3):
        lo, hi = sh.shard_bounds(n, rank, 3)
        lo, hi = min(lo, n), min(hi, n)
        local = list(shape)
        local[axis] = hi - lo
        parts.append(lane_uniform(key, tuple(local), (lo, hi, n), axis))
    assert np.array_equal(torch.cat(parts, dim=axis).numpy(), whole)
    with pytest.raises(ValueError):
        lane_uniform(key, shape, (0, 3, n), axis)


def test_mesh_without_a_group():
    m = sh.make_mesh("cpu")
    assert (m.group, m.rank, m.world, m.device) == (None, 0, 1,
                                                    torch.device("cpu"))
    assert sh.batch_sharding(m).mesh is m
    with pytest.raises(ValueError, match="RRT_COORDINATOR"):
        sh.make_mesh(["cpu", "cpu"])
    x = torch.arange(4.0)
    assert pdist.all_gather_lanes(x, m, 4) is not None
    assert torch.equal(pdist.all_reduce_sum(x, m), x)
    assert pdist.make_global_batch(x, m)[1] == (0, 4, 4)


def test_initialize_from_env_without_variables(monkeypatch):
    for name in ("RRT_COORDINATOR", "RRT_NUM_PROCESSES", "RRT_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert pdist.initialize_from_env(device="cpu") is False
    assert pdist.process_count() == 1 and pdist.process_index() == 0


@pytest.fixture
def world1(tmp_path):
    """A gloo process group of one rank in this process (a file store in
    the test's directory, so that parallel test workers cannot meet on a
    port), destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield sh.make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_gloo_world_of_one_collectives(world1):
    mesh = world1
    assert (mesh.world, mesh.backend) == (1, "gloo")
    pdist.COLLECTIVES.update(calls=0, bytes=0)
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    b = torch.tensor([True, False, True])
    i = torch.tensor([7, -1, 3], dtype=torch.int32)
    gx, gb, gi = pdist.all_gather_lanes([x, b, i], mesh, 3)
    assert torch.equal(gx, x) and torch.equal(gb, b) and torch.equal(gi, i)
    assert torch.equal(pdist.all_reduce_max(x, mesh), x)
    assert pdist.make_global_batch(x, mesh)[1] == (0, 3, 3)
    assert torch.equal(pdist.replicate_global(x, mesh), x)
    assert pdist.COLLECTIVES["calls"] == 4
    assert pdist.COLLECTIVES["bytes"] == 3 * (8 + 1 + 4) + 24 + 8 + 24
    rays = sh.replicate(Rays(o=x.repeat(1, 2)[:, :3], d=x.repeat(1, 2)[:, :3],
                             min_t=x[:, 0], max_t=x[:, 1]), mesh)
    assert torch.equal(rays.max_t, x[:, 1])
    assert pdist.COLLECTIVES["calls"] == 8
    with pytest.raises(ValueError):
        pdist.all_gather_lanes([x, b[:2]], mesh, 3)


@pytest.fixture(scope="module")
def small():
    """A 12×10 curved GI config on the in-repo box."""
    cfg = RenderConfig(width=12, height=10, ns_aa=2, ns_area_light=2,
                       max_ray_depth=3, seed=3, max_pass_lanes=120)
    scene, cam = load_scene(CBOX_SPHERES, "cpu", 12, 10, fov_mode="native")
    return cfg, scene, cam


def test_trace_and_occluded_with_mesh(world1, cbox):
    """trace/occluded(mesh=) equal the unsharded queries bit for bit, the
    counters too (curved: the padding costs no test), on an odd batch."""
    rays = _cut(cbox["rays"], 509)
    tab = tk.build_tables(cbox["ts"], cbox["tbh"])
    h, st = ttrace.trace(cbox["ts"], cbox["tbh"], rays, return_stats=True,
                         tables=tab)
    hm, stm = ttrace.trace(cbox["ts"], cbox["tbh"], rays, return_stats=True,
                           tables=tab, mesh=world1)
    for f in HIT_FIELDS:
        assert torch.equal(getattr(hm, f), getattr(h, f)), f
    assert torch.equal(stm, st)
    o = ttrace.occluded(cbox["ts"], cbox["tbh"], rays, tables=tab)
    om = ttrace.occluded(cbox["ts"], cbox["tbh"], rays, tables=tab,
                         mesh=world1)
    assert torch.equal(om, o)
    stacked = Rays(o=rays.o.reshape(1, 509, 3), d=rays.d.reshape(1, 509, 3),
                   min_t=rays.min_t[None], max_t=rays.max_t[None])
    hs = ttrace.trace(cbox["ts"], cbox["tbh"], stacked, tables=tab,
                      mesh=world1)
    assert hs.p.shape == (1, 509, 3) and torch.equal(hs.p[0], h.p)


def test_est_radiance_with_mesh(world1, small):
    cfg, scene, cam = small
    bh = make_black_hole(cfg, "cpu")
    tab = tk.build_tables(scene, bh)
    xy = np.random.default_rng(1).uniform(0.1, 0.9, (101, 2))
    rays = cam.generate_rays(torch.tensor(xy, dtype=torch.float32))
    L, w = est_radiance(scene, bh, rays, cfg, prng.key(3), tab)
    Lm, wm = est_radiance(scene, bh, rays, cfg, prng.key(3), tab,
                          mesh=world1)
    assert torch.equal(Lm, L) and L.abs().sum() > 0
    assert torch.equal(wm.tests, w.tests) and wm.calls == w.calls


def test_renderer_with_sharding(world1, small):
    """Renderer(sharding=) over a world of 1: its accumulators equal the
    unsharded render's bit for bit, over two passes; the first pass is
    timed as "compile+first-pass", as the JAX renderer times it."""
    cfg, scene, cam = small
    plain = Renderer(scene, cam, cfg, "cpu")
    plain.render()
    r = Renderer(scene, cam, cfg, "cpu",
                 sharding=sh.batch_sharding(world1))
    r.render()
    for a, b in zip(r.last_accumulators, plain.last_accumulators):
        np.testing.assert_array_equal(a, b)
    assert r.last_trace_calls == plain.last_trace_calls
    np.testing.assert_array_equal(r.last_trace_tests, plain.last_trace_tests)
    assert set(r.timer.phases) == {"compile+first-pass", "passes"}
    assert r.timer.phases["compile+first-pass"] > 0
    with pytest.raises(ValueError):
        Renderer(scene, cam, cfg, "cpu", sharding=sh.batch_sharding(
            sh.LaneMesh(None, 0, 1, torch.device("meta"), None)))


def test_sharded_render_resumes_bit_for_bit(world1, small, tmp_path):
    """A sharded render stopped after its first pass with a checkpoint
    (written by rank 0, the ranks waiting for it) and resumed equals the
    uninterrupted sharded render bit for bit."""
    cfg, scene, cam = small
    sharding = sh.batch_sharding(world1)
    whole = Renderer(scene, cam, cfg, "cpu", sharding=sharding)
    whole.render()
    ckpt = str(tmp_path / "state.npz")
    r = Renderer(scene, cam, cfg, "cpu", sharding=sharding)
    r.render(checkpoint_path=ckpt, stop_after=1)
    assert r.cancelled and r.samples_done == 1
    r2 = Renderer(scene, cam, cfg, "cpu", sharding=sharding)
    r2.render(checkpoint_path=ckpt, resume=True)
    assert not r2.cancelled and r2.samples_done == 2
    for a, b in zip(r2.last_accumulators, whole.last_accumulators):
        np.testing.assert_array_equal(a, b)
