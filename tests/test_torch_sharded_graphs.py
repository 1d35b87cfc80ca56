"""The compiled sharded programs on the CPU: the renderer's sharded pass
(`render/renderer.PassRunner` with a mesh: the rank half, the gather,
the accumulate half), the sharded gradient step (`render/diff.LossAndGrad`
with a mesh: half A, the all-reduce, half B) and the pieces of
`parallel/distributed.py` that the halves run on either side of their
collective (`pack_lanes`, `gather_packed`, `unpack_lanes`; `pack_flat`,
`unpack_flat`). The counterparts of the JAX package's jitted sharded pass
(rrt_tpu/render/renderer.py:75,98,179-182) and of the jitted sharded
train step of `__graft_entry__.dryrun_multichip`.

The CPU has no CUDA graphs, so the halves run under the stand-in for the
graph of tests/test_torch_graphs.py (the `stand_in` fixture), in a gloo
process group of one rank in this process; the collectives between them
run eagerly, as they do on a card. The sharded step is also held to the
JAX package's `jax.jit(jax.value_and_grad(image_loss))` on a 2-device
virtual CPU mesh, through two gloo ranks in two processes. The
`cuda`-marked twins in tests/test_torch_kernel_cuda.py hold the real
graphs to the eager sharded paths on a card.
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rrt_tpu.render import diff as jdiff
from rrt_tpu.render.renderer import make_black_hole as jax_black_hole
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu_torch import convert
from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.parallel import distributed as pdist
from rrt_tpu_torch.parallel import sharding as sh
from rrt_tpu_torch.render import diff
from rrt_tpu_torch.render.renderer import Renderer
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.types import Rays
from rrt_tpu_torch.utils import prng
from rrt_tpu_torch.utils.config import BlackHoleConfig, Illum, RenderConfig
from test_torch_diff import MATERIAL_RTOL
from test_torch_diff_graphs import _moved, _problem, _same
from test_torch_graphs import H, W, _cfg, _equal, _renderer, _state
from test_torch_graphs import stand_in  # noqa: F401  (the graph stand-in)
from test_torch_hostmods import jax_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def world1(tmp_path):
    """A gloo process group of one rank in this process (a file store in
    the test's directory), destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield sh.make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def _sharded(cfg, mesh, graphs):
    """A renderer of `cfg` sharded over `mesh`, its passes through the
    stand-in's graphs when `graphs` (a CPU renderer builds none)."""
    scene, cam = load_scene(CBOX_SPHERES, "cpu", W, H, fov_mode="native")
    r = Renderer(scene, cam, cfg, "cpu", sharding=sh.batch_sharding(mesh))
    if graphs:
        r.graphs, r._pool = True, "stand-in pool"
    return r


def _render(r):
    r.render()
    return _state(r)


def _cells(r):
    out = []
    for x, y in ((3, 2), (10, 5), (0, 0)):
        r.render(region=(x, y, 12, 8))
        out += _state(r)
    return out


# (config keywords, what the render does): four one-sample passes, a tail
# pass (5 samples at k = 2), an adaptive render across its batch
# boundaries and three cells of one size
SCENARIOS = {
    "passes": (dict(spp=4), _render),
    "tail pass": (dict(spp=5, max_pass_lanes=2 * 24 * 16), _render),
    "adaptive boundary": (dict(spp=8, adaptive=True, samples_per_batch=2,
                               max_tolerance=0.5), _render),
    "region cells": (dict(spp=2, max_pass_lanes=4 * 12 * 8), _cells),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_split_pass_equals_the_fused_pass(stand_in, world1, scenario):
    """The sharded pass split at its gather, its halves through the
    stand-in's graphs (eager, then captured and replayed, then replayed)
    and the gather run eagerly between them at every pass, equals the
    unsharded fused `_sample_pass` and the eager sharded pass bit for bit:
    accumulators, counters, trace calls and samples done. The kernel's
    runs equal the trace calls, and every pass makes its two collectives
    (the gather and the stop agreement), plus the counters' sum."""
    kw, run = SCENARIOS[scenario]
    fused = run(_renderer(_cfg(**kw)))
    eager = run(_sharded(_cfg(**kw), world1, False))
    r = _sharded(_cfg(**kw), world1, True)
    tk.reset_counts()
    pdist.COLLECTIVES.update(calls=0, bytes=0)
    got = run(r)
    assert _equal(got, fused) and _equal(eager, fused)
    passes = sum(p.passes for p in r._pass_fns.values())
    renders = 3 if run is _cells else 1
    assert pdist.COLLECTIVES["calls"] == 2 * passes + renders
    # each render's state ends with (trace calls, samples done)
    assert tk.kernel_runs() == sum(int(s[0]) for s in got[6::7]) > 0
    for p in r._pass_fns.values():
        assert p.call.replays == p.accumulate.replays
        assert p.call.replays == max(p.passes - 1, 0)
    if scenario == "adaptive boundary":
        done = r.last_accumulators[4]
        assert done.any() and not done.all()


@pytest.mark.parametrize("case", ["curved GI", "flat direct"])
def test_split_step_equals_the_eager_sharded_step(stand_in, world1, case):
    """`LossAndGrad(mesh=)` split at its all-reduce, half A and half B
    through the stand-in's graphs and the all-reduce eagerly between them,
    over three calls with moved params and a new key each: the loss and
    the eleven gradients equal `loss_and_grad(mesh=)` bit for bit, one
    all-reduce a call; then its `train_step` equals `train_step(mesh=)`."""
    params, scene, bh, rays, cfg = _problem(case)
    target = torch.full((rays.o.shape[0], 3), 0.2)
    step = diff.LossAndGrad(scene, bh, cfg, rays, target, mesh=world1)
    step.graphs = True
    gen = prng.key
    for i in range(3):
        p = _moved(params, i)
        want = diff.loss_and_grad(p, scene, bh, rays, target, cfg, gen(i),
                                  mesh=world1)
        tk.reset_counts()
        pdist.COLLECTIVES.update(calls=0, bytes=0)
        got = step(p, gen(i))
        assert pdist.COLLECTIVES["calls"] == 1
        assert pdist.COLLECTIVES["bytes"] == 4 * step.flat.numel()
        assert torch.equal(got[0], want[0]) and _same(got[1], want[1])
        assert tk.kernel_runs() == step.trace_calls > 0
    assert step.call.replays == step.update.replays == 2
    assert any(g.abs().max() > 0 for g in want[1].leaves())
    pe, _, le = diff.train_step(params, None, scene, bh, rays, target, cfg,
                                gen(7), lr=0.5, mesh=world1)
    pc, _, lc = diff.train_step(params, None, scene, bh, rays, target, cfg,
                                gen(7), lr=0.5, mesh=world1, step=step)
    assert torch.equal(lc, le) and _same(pc, pe)


# the dtypes the sharded paths gather: radiance, Kerr's radiance and the
# per-trace route's Hit (f32, bool hit, int32 ids), its f64 counters
DTYPES = [torch.float32, torch.float64, torch.int32, torch.int64,
          torch.bool, torch.uint8]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_gather_pieces_round_trip(world1, dtype):
    """pack → collective → unpack of one tensor of `dtype` beside a (m, 3)
    float32 one gives back both bit for bit, through `all_gather_lanes`
    and through the pieces with static buffers; a block of a two-rank
    world is padded to the block size with zeros; `pack_flat` and
    `unpack_flat` round-trip a loss and gradients of several shapes."""
    gen = torch.Generator().manual_seed(1)
    m = 7
    if dtype == torch.bool:
        x = torch.rand((m, 2), generator=gen) < 0.5
    elif dtype.is_floating_point:
        x = torch.randn((m, 2), generator=gen, dtype=dtype)
        x[0, 0] = float("nan")
    else:
        x = torch.randint(0, 120, (m, 2), generator=gen).to(dtype)
    f = torch.randn((m, 3), generator=gen)
    packed = pdist.pack_lanes([x, f], world1, m)
    whole = torch.empty_like(packed)            # a static buffer
    assert pdist.gather_packed(packed, world1, m, out=whole) is whole
    bits = lambda t: t if t.dtype == torch.bool else t.view(torch.uint8)
    for got in (pdist.all_gather_lanes([x, f], world1, m),
                pdist.unpack_lanes(whole, [x[:0], f[:0]], m)):
        assert got[0].dtype == dtype and torch.equal(bits(got[0]), bits(x))
        assert torch.equal(got[1], f)
    half = sh.LaneMesh(None, 1, 2, torch.device("cpu"), None)
    packed = pdist.pack_lanes([x[:3], f[:3]], half, m)
    assert packed.shape[0] == 4 and not packed[3:].any()
    back = pdist.unpack_lanes(packed, [x, f], 3)
    assert torch.equal(back[1], f[:3])
    parts = [torch.tensor(0.25), torch.randn(5, 3, generator=gen),
             torch.randn(4, generator=gen)]
    flat = pdist.pack_flat(parts)
    assert flat.shape == (1 + 15 + 4,)
    assert all(torch.equal(a, b) and a.shape == b.shape
               for a, b in zip(pdist.unpack_flat(flat, parts), parts))


def test_capture_mode_follows_the_process_group(tmp_path):
    """Captures run in the default "global" mode without a process group
    and in "thread_local" mode while one is alive (a group's watchdog
    thread may query events during a capture), and in "global" again
    once it is gone."""
    from rrt_tpu_torch.utils.graphs import capture_mode
    assert capture_mode() == "global"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        assert capture_mode() == "thread_local"
    finally:
        dist.destroy_process_group()
    assert capture_mode() == "global"


def test_graphs_with_a_mesh_only_on_a_card(world1):
    """A sharded renderer, step and Kerr image on the CPU run eagerly and
    refuse graphs=True for the device, not for the mesh."""
    cfg = _cfg(1)
    r = _renderer(cfg)
    sharding = sh.batch_sharding(world1)
    assert not Renderer(r.scene, r.camera, cfg, "cpu",
                        sharding=sharding).graphs
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        Renderer(r.scene, r.camera, cfg, "cpu", sharding=sharding,
                 graphs=True)
    params, scene, bh, rays, dcfg = _problem("flat direct")
    step = diff.LossAndGrad(scene, bh, dcfg, rays, torch.zeros_like(rays.o),
                            mesh=world1)
    step(params, prng.key(0))
    assert not step.graphs and step.call is None and step.update is None
    from rrt_tpu_torch.render import kerr_scene as K
    kbh = convert.kerr_params_from_arrays((0.0, 0.0, 0.0), 1.0, 0.9, "cpu")
    disk = convert.disk_from_arrays(3.0, 12.0, (1.0, 0.85, 0.6), 2.0, True,
                                    "cpu")
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        K.render_image(4, 4, kbh, disk, n_steps=2, device="cpu",
                       sharding=sharding, graphs=True)


# ---------------------------------------------------------------- JAX parity

# the leaves the direct-lit loss reaches in both packages
LEAVES = ("reflectance", "light_radiance")

def _parity_problem():
    """The flat direct-lit box at W×H, deterministic given its key:
    (JAX scene, hole, rays, config, key; the port's scene, rays, params;
    the target)."""
    cfg = RenderConfig(width=W, height=H, ns_aa=1, ns_area_light=1,
                       max_ray_depth=1, seed=0, illum=Illum.DIRECT,
                       black_hole=BlackHoleConfig(enabled=False))
    js, jcam = jax_load_scene(CBOX_SPHERES, W, H, fov_mode="native")
    jbh = jax_black_hole(jax_config(cfg))
    xy = np.random.default_rng(4).uniform(0.15, 0.85, (W * H, 2))
    jrays = jcam.generate_rays(jnp.asarray(xy, jnp.float32))
    ts = convert.scene_from_arrays(convert.to_arrays(js), "cpu")
    trays = Rays(**{k: torch.tensor(np.asarray(getattr(jrays, k)))
                    for k in ("o", "d", "min_t", "max_t")})
    tp = diff.params_from_arrays(convert.to_arrays(
        jdiff.params_from_scene(js, jbh)), "cpu")
    target = np.random.default_rng(3).uniform(0, 0.5, (W * H, 3)).astype(
        np.float32)
    return (js, jbh, jrays, cfg, jax.random.key(5)), (ts, trays, tp), target


def _rank(rank: int, store: str, out: str, world: int = 2):
    """One gloo rank of the parity test (of `world` ranks):
    `LossAndGrad(mesh=)` called twice and `loss_and_grad(mesh=)` once
    under key 5 (each rank drawing its block of the batch's uniforms);
    writes the step's loss and gradients and whether each call equalled
    the eager step."""
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        mesh = sh.make_mesh("cpu")
        (_, _, _, cfg, _), (ts, trays, tp), target = _parity_problem()
        target = torch.tensor(target)
        step = diff.LossAndGrad(ts, None, cfg, trays, target, mesh=mesh)
        key = prng.key(5)
        got = [step(tp, key) for _ in range(2)]
        want = diff.loss_and_grad(tp, ts, None, trays, target, cfg, key,
                                  mesh=mesh)
        equal = [bool(torch.equal(g[0], want[0]) and _same(g[1], want[1]))
                 for g in got]
        loss, g = got[-1]
        np.savez(out, equal=equal, loss=loss.numpy(),
                 **{k: getattr(g, k).numpy() for k in LEAVES})
    finally:
        dist.destroy_process_group()


def jax_parity(tmp_path, world: int, threads: int):
    """The sharded step on `world` gloo ranks (processes running this
    file, each `LossAndGrad(mesh=)` over its block, `threads` intra-op
    threads each) against the JAX package's
    `jax.jit(jax.value_and_grad(image_loss))` over rays and target sharded
    on a `world`-device virtual CPU mesh (tests/test_sharding.py's
    `P("batch")`), on the flat direct-lit box under one key: every rank
    holds the same loss and gradients, each
    call equal to the eager `loss_and_grad(mesh=)` bit for bit, and the
    loss and the reflectance and light gradients within MATERIAL_RTOL
    (rtol 1e-4, the material leaves' tolerance of
    tests/test_torch_distributed.py and tests/test_sharding.py) of
    JAX's."""
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{i}.npz") for i in range(world)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(threads),
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(i), store, outs[i],
         str(world)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(world)]
    try:
        (js, jbh, jrays, cfg, key), _, target = _parity_problem()
        mesh = Mesh(np.array(jax.devices()[:world]), ("batch",))
        lanes, whole = NamedSharding(mesh, P("batch")), NamedSharding(
            mesh, P())
        jrays = jax.tree_util.tree_map(lambda a: jax.device_put(a, lanes),
                                       jrays)
        jt = jax.device_put(jnp.asarray(target), lanes)
        jp = jax.tree_util.tree_map(lambda a: jax.device_put(a, whole),
                                    jdiff.params_from_scene(js, jbh))
        loss_fn = lambda p, r, t: jdiff.image_loss(p, js, jbh, r, t,
                                                   jax_config(cfg), key)
        jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(jp, jrays, jt)
        logs = [p.communicate(timeout=600)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = [dict(np.load(o)) for o in outs]
    for r in res:
        assert r["equal"].all()
        for k in ("loss",) + LEAVES:
            np.testing.assert_array_equal(r[k], res[0][k])
    np.testing.assert_allclose(res[0]["loss"], float(jloss),
                               rtol=MATERIAL_RTOL)
    for name in LEAVES:
        b = np.asarray(getattr(jg, name))
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(res[0][name], b, rtol=MATERIAL_RTOL,
                                   atol=MATERIAL_RTOL * np.abs(b).max(),
                                   err_msg=name)


def test_sharded_step_matches_jax_sharded_value_and_grad(tmp_path):
    """`jax_parity` on two ranks and a 2-device mesh."""
    jax_parity(tmp_path, 2, 2)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4]))
