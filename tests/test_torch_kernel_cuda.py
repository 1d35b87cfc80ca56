"""The CUDA kernels against their plain PyTorch versions, on a card: the
trace kernel (Cornell box, a 3-part scene and the 14-part BVH-scale
scene; ragged lane counts from spread origins and from one point, masked
lanes, a scene whose box tables do not fit in shared memory, launches
back to back, each in the default build and in the builds that fix its
traversal lane by lane and cooperative), the differentiable trace on the
kernel's primal against the CPU's, the toolchain probe, the eight cost
micro-probes and the threefry kernel (uniforms and keys, in a graph too);
the passes, Kerr's march blocks and the gradient step
captured as CUDA graphs against their eager runs, unsharded and sharded
over an NCCL group of one rank (two graphs around each collective).

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so that the machine with the card, which has none, can run it:
`python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py`.
"""
import numpy as np
import pytest
import torch

from rrt_tpu_torch.convert import black_hole_from_arrays
from rrt_tpu_torch.geometry.trace import trace_diff
from rrt_tpu_torch.ops import probe as tprobe
from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.physics.schwarzschild import chaotic_lanes
from rrt_tpu_torch.scene.build import build_scene, load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES, cbox_dense, uv_sphere_box
from rrt_tpu_torch.tools import r5prim, trace_modes
from rrt_tpu_torch.types import BlackHoleParams, Rays
from rrt_tpu_torch.utils import prng

N_SEG = 63
# the default build of the trace kernel, and the builds that fix its
# traversal (`trace_modes.VARIANTS`)
BUILDS = ("default", "per-lane", "cooperative")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def trace_builds():
    """{build: its launch functions}, the variants built once, together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    started = trace_modes.start_variants(BUILDS[1:])
    fns = {"default": tk._trace_fn()}
    fns.update({name: trace_modes.load_variant(proc)[0]
                for name, proc in started.items()})
    return fns


@pytest.fixture(params=BUILDS)
def build(request, device, trace_builds):
    """Trace through one build of the kernel for the test."""
    with trace_modes.using(trace_builds[request.param]):
        yield request.param


def _rays(n, seed, device, lo, hi):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = lambda a: torch.tensor(a, device=device)
    return Rays(o=t(o), d=t(d), min_t=t(np.zeros(n, np.float32)),
                max_t=t(np.full(n, 1e9, np.float32)))


def _scene(name, device):
    if name == "cbox":
        scene, _ = load_scene(CBOX_SPHERES, device, 256, 256)
        return (scene, black_hole_from_arrays((0, 1, 0), 0.1, 0.1, device),
                (-0.8, 0.35, -0.8), (0.8, 1.15, 0.8))
    if name == "dense":
        scene, _ = build_scene(cbox_dense(), device, 128, 128)
        return (scene, black_hole_from_arrays((0, 1, 0), 0.1, 0.1, device),
                (-0.8, 0.35, -0.8), (0.8, 1.15, 0.8))
    scene, _ = build_scene(uv_sphere_box(), device)
    return (scene, black_hole_from_arrays((-0.45, -0.35, 0.4), 0.08, 0.1,
                                          device), (-0.9,) * 3, (0.9,) * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cbox", "parts", "dense"])
@pytest.mark.parametrize("curved,occlusion", [(False, False), (True, False),
                                              (True, True)],
                         ids=["flat", "curved", "any-hit"])
def test_kernel_matches_plain(device, name, curved, occlusion):
    scene, bh, lo, hi = _scene(name, device)
    rays = _rays(16384, 3, device, lo, hi)
    tab = tk.build_tables(scene, bh if curved else None)
    args = (tab, rays.o, rays.d, rays.min_t, rays.max_t)
    kw = dict(occlusion=occlusion)
    before = tk.LAUNCHES
    k = tk.trace_rays(*args, **kw)
    assert tk.LAUNCHES == before + 1
    r = tk.trace_rays_reference(*args, **kw)
    assert tk.LAUNCHES == before + 1
    calm = (~chaotic_lanes(rays.o, rays.d, bh, N_SEG) if curved
            else torch.ones_like(k.hit))
    for f in ("hit", "absd", "prim", "seg", "nisect", "ncull"):
        assert torch.equal(getattr(k, f)[calm], getattr(r, f)[calm]), f
    assert (k.hit == r.hit).float().mean() >= 0.999
    m = calm & k.hit
    torch.testing.assert_close(k.t[m], r.t[m], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(k.seg_o[m], r.seg_o[m], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(k.seg_d[m], r.seg_d[m], rtol=1e-5, atol=1e-6)


MODES = pytest.mark.parametrize(
    "curved,occlusion", [(False, False), (True, False), (True, True)],
    ids=["flat", "curved", "any-hit"])


def _agree(k, r, rays, bh, curved):
    """The kernel's output k equals the plain version's r on calm lanes
    (hit, absd, prim, seg and both counters; t and the segment to rtol
    1e-5), and all lanes agree on >= 99.9% of hits."""
    calm = (~chaotic_lanes(rays.o, rays.d, bh, N_SEG) if curved
            else torch.ones_like(k.hit))
    for f in ("hit", "absd", "prim", "seg", "nisect", "ncull"):
        assert torch.equal(getattr(k, f)[calm], getattr(r, f)[calm]), f
    assert (k.hit == r.hit).float().mean() >= 0.999
    m = calm & k.hit
    torch.testing.assert_close(k.t[m], r.t[m], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(k.seg_o[m], r.seg_o[m], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(k.seg_d[m], r.seg_d[m], rtol=1e-5, atol=1e-6)


def _both(tab, rays, occlusion):
    args = (tab, rays.o, rays.d, rays.min_t, rays.max_t)
    return (tk.trace_rays(*args, occlusion=occlusion),
            tk.trace_rays_reference(*args, occlusion=occlusion))


@pytest.mark.cuda
@MODES
@pytest.mark.parametrize("origins", ["spread", "one point"])
def test_ragged_lane_counts(device, build, curved, occlusion, origins):
    """1, 31 and 33 lanes, and one more lane than the launch has resident
    threads: the queue hands out every ray once. From one point, every
    warp waits for all its lanes before it takes new rays."""
    scene, bh, lo, hi = _scene("cbox", device)
    tab = tk.build_tables(scene, bh if curved else None)
    warm = _rays(64, 1, device, lo, hi)
    tk.trace_rays(tab, warm.o, warm.d, warm.min_t, warm.max_t)
    resident = tk.LAST_LAUNCH["grid"] * tk.LAST_LAUNCH["threads"]
    assert tk.LAST_LAUNCH["blocks_per_sm"] >= 1
    assert tk.LAST_LAUNCH["tables_in"] == "shared"
    if build != "default":
        assert tk.LAST_LAUNCH["traversal"] == build
    for n in (1, 31, 33, resident + 1):
        rays = _rays(n, n, device, lo, hi)
        if origins == "one point":
            rays = rays.replace(o=torch.broadcast_to(
                rays.o[:1], rays.o.shape).contiguous())
        k, r = _both(tab, rays, occlusion)
        _agree(k, r, rays, bh, curved)


@pytest.mark.cuda
@MODES
def test_half_the_lanes_masked(device, build, curved, occlusion):
    """A seeded random half of the lanes sits at the hole's centre, as the
    integrator parks masked lanes: they die on segment 0 (curved) and the
    other half is traced as if alone."""
    scene, bh, lo, hi = _scene("cbox", device)
    rays = _rays(65536, 11, device, lo, hi)
    masked = torch.tensor(np.random.default_rng(12).random(65536) < 0.5,
                          device=device)
    rays.o[masked] = bh.position.to(torch.float32)
    tab = tk.build_tables(scene, bh if curved else None)
    k, r = _both(tab, rays, occlusion)
    _agree(k, r, rays, bh, curved)
    if curved:
        assert (k.seg[masked] == 0).all() and not k.hit[masked].any()
        assert (k.nisect[masked] == 0).all() and (k.ncull[masked] == 0).all()


@pytest.mark.cuda
@MODES
def test_box_tables_in_device_memory(device, build, curved, occlusion):
    """A 79,616-triangle scene whose box tables outgrow a block's shared
    memory: the launcher reads them from device memory, with the same
    results."""
    scene, _ = build_scene(cbox_dense(200, 200), device, 128, 128)
    bh = black_hole_from_arrays((0, 1, 0), 0.1, 0.1, device)
    tab = tk.build_tables(scene, bh if curved else None)
    rays = _rays(16384, 13, device, (-0.8, 0.35, -0.8), (0.8, 1.15, 0.8))
    k, r = _both(tab, rays, occlusion)
    assert tk.LAST_LAUNCH["tables_in"] == "device"
    assert tk.LAST_LAUNCH["triangles_in"] == "device"
    _agree(k, r, rays, bh, curved)


@pytest.mark.cuda
@MODES
def test_launches_back_to_back(device, build, curved, occlusion):
    """Two launches in a row on one stream, with no sync between: each
    has its own ray queue."""
    scene, bh, lo, hi = _scene("parts", device)
    tab = tk.build_tables(scene, bh if curved else None)
    a, b = _rays(20000, 21, device, lo, hi), _rays(30000, 22, device, lo, hi)
    args = lambda x: (tab, x.o, x.d, x.min_t, x.max_t)
    ka = tk.trace_rays(*args(a), occlusion=occlusion)
    kb = tk.trace_rays(*args(b), occlusion=occlusion)
    _agree(ka, tk.trace_rays_reference(*args(a), occlusion=occlusion), a,
           bh, curved)
    _agree(kb, tk.trace_rays_reference(*args(b), occlusion=occlusion), b,
           bh, curved)


@pytest.mark.cuda
def test_escaped_and_dead_lanes(device):
    """A lane at the hole's centre dies on segment 0 at no cost; an
    escaped lane (no event in 2π) keeps its origin and padded direction."""
    scene, bh, lo, hi = _scene("cbox", device)
    rays = _rays(4096, 5, device, lo, hi)
    rays.o[0] = bh.position
    tab = tk.build_tables(scene, bh)
    out = tk.trace_rays(tab, rays.o, rays.d, rays.min_t, rays.max_t)
    assert out.seg[0] == 0 and not out.hit[0] and not out.absd[0]
    assert out.nisect[0] == 0 and out.ncull[0] == 0
    esc = (out.seg == N_SEG) & ~out.hit
    assert esc.any() and not out.absd[esc].any()
    assert torch.equal(out.seg_o[esc], rays.o[esc])
    assert torch.equal(out.seg_d[esc], tk.pad_dirs(rays.d[esc]))
    assert (out.prim[~out.hit] == -1).all()


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(device):
    scene, bh, lo, hi = _scene("cbox", device)
    rays = _rays(256, 4, device, lo, hi)
    tab = tk.build_tables(scene, bh)
    kw = {}
    with pytest.raises(ValueError, match="d:"):
        tk.trace_rays(tab, rays.o, rays.d.double(), rays.min_t, rays.max_t,
                      **kw)
    with pytest.raises(ValueError, match="o:"):
        tk.trace_rays(tab, rays.o.t().contiguous().t(), rays.d, rays.min_t,
                      rays.max_t, **kw)
    cpu_tab = tk.build_tables(scene.to("cpu"), bh.to("cpu"))
    with pytest.raises(ValueError, match="params"):
        tk.trace_rays(cpu_tab, rays.o, rays.d, rays.min_t, rays.max_t, **kw)


@pytest.mark.cuda
def test_trace_diff_and_grads_match_cpu(device):
    """trace_diff of 4,096 seeded camera rays on the card (the kernel's
    primal, the replay on CUDA tensors) against the CPU (the plain
    primal): on calm lanes the same hits and prims, >= 99.5% of hit points
    within 1e-4 (the rule of tests/test_diff.py: CUDA's cos and sin of Δθ
    may differ from the CPU's by an ulp), and the gradients of a weighted sum of the hit points
    with respect to the hole to rtol 5e-3 (the float32 conditioning of 63
    chords' Jacobians)."""
    scene, cam = load_scene(CBOX_SPHERES, device, 64, 64, fov_mode="native")
    bh = black_hole_from_arrays((0, 1, 0), 0.1, 0.1, device)
    xy = np.random.default_rng(17).uniform(0.2, 0.8, (4096, 2))
    rays = cam.generate_rays(torch.tensor(xy, dtype=torch.float32,
                                          device=device))
    calm = ~chaotic_lanes(rays.o, rays.d, bh, N_SEG)
    w = torch.tensor(np.random.default_rng(18).normal(size=(4096, 3)),
                     dtype=torch.float32, device=device) * calm[:, None]
    out = []
    for dev in (device, torch.device("cpu")):
        leaves = [x.detach().to(dev).clone().requires_grad_(True)
                  for x in (bh.position, bh.radius, bh.delta_theta)]
        hole = BlackHoleParams(*leaves)
        sc = scene.to(dev)
        before = tk.LAUNCHES
        h, st = trace_diff(sc, hole, rays.to(dev),
                           tables=tk.build_tables(sc, hole),
                           return_stats=True)
        assert tk.LAUNCHES == before + (dev.type == "cuda")
        loss = torch.sum(torch.where(h.hit[:, None], h.p, 0.0) * w.to(dev))
        out.append((h, st, torch.autograd.grad(loss, leaves)))
    (hk, stk, gk), (hr, str_, gr) = out
    c = calm.cpu()
    assert torch.equal(hk.hit.cpu()[c], hr.hit[c])
    assert torch.equal(hk.prim_id.cpu()[c], hr.prim_id[c])
    m = c & hr.hit
    assert m.sum() > 50
    err = (hk.p.detach().cpu()[m] - hr.p.detach()[m]).abs().amax(-1)
    assert (err < 1e-4).float().mean() >= 0.995, err.max()
    assert (stk > 0).all() and (str_ > 0).all()
    for a, b in zip(gk, gr):
        torch.testing.assert_close(a.cpu(), b, rtol=5e-3,
                                   atol=5e-3 * b.abs().max().item())


THREEFRY_DRAWS = [((1 << 20, 2), None, 1), ((1 << 20, 2), None, 4),
                  ((1 << 20,), None, 1),
                  ((1 << 20, 2), (0, 1 << 18, 1 << 19), 4),
                  ((4, 509, 2), (1, 100, 300), 1), ((7,), None, 3),
                  ((2 ** 31 + 5,), (0, 2 ** 31 - 995, 2 ** 31 + 5), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window,n_keys", THREEFRY_DRAWS,
                         ids=lambda v: str(v))
def test_threefry_uniform_kernel_matches_plain(device, shape, window,
                                               n_keys):
    """The uniform entry against the plain version on the CPU, bit for
    bit: the main path's jitter, four light samples in one launch, a coin,
    a rank's quarter of the lanes, a window on a middle axis, an odd draw
    and a window past 2^31 (64-bit indexing); one launch each."""
    from rrt_tpu_torch.ops import threefry
    from rrt_tpu_torch.utils import prng
    keys = prng.split(prng.key(7, device), n_keys)
    if n_keys == 1:
        keys = keys[0]
    axis, lo, hi = window or (0, 0, shape[0])
    threefry.reset_counts()
    got = threefry.uniform(keys, shape, axis, lo, hi)
    assert threefry.LAUNCHES == 1 and threefry.kernel_runs("uniform") == 1
    want = threefry.uniform_reference(keys.cpu(), shape, axis, lo, hi)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_threefry_keys_kernel_matches_plain_and_replays(device):
    """The key entry against the plain version (split, fold_in of an int
    and of a device tensor, a batch of keys), and a pass's key derived in
    a CUDA graph from a device tensor: each replay derives and draws from
    the key of the index the tensor holds, counted by the kernel's runs."""
    from rrt_tpu_torch.ops import threefry
    from rrt_tpu_torch.utils import prng
    from rrt_tpu_torch.utils.graphs import CapturedCall
    base = prng.key(3, device)
    idx = torch.zeros((), dtype=torch.int32, device=device)
    for s in (0, 5, 2 ** 31 - 1):
        idx.fill_(s)
        assert torch.equal(prng.fold_in(base, idx).cpu(),
                           prng.fold_in(base.cpu(), s))
    assert torch.equal(prng.split(base, 5).cpu(),
                       prng.split(base.cpu(), 5))
    batch = prng.split(base, 4)
    assert torch.equal(prng.split(batch, 3).cpu(),
                       prng.split(batch.cpu(), 3))
    out = torch.empty(4096, device=device)

    def draw():
        k = prng.fold_in(prng.fold_in(base, idx), 0)
        out.copy_(prng.uniform(prng.split(k, 3)[0], (4096,)))
    call = CapturedCall(draw, device, name="a pass's draw")
    threefry.reset_counts()
    for s in (0, 1, 2, 3):          # eager, captured and replayed, replayed
        idx.fill_(s)
        call()
        want = prng.uniform(prng.split(prng.fold_in(prng.fold_in(
            base.cpu(), s), 0), 3)[0], (4096,))
        assert torch.equal(out.cpu(), want), s
    assert call.replays == 3
    # 4 runs a call (two fold_in, a split, a uniform), eager launches of
    # the first call only
    assert threefry.kernel_runs() == 16
    assert threefry.LAUNCHES + threefry.KEY_LAUNCHES == 4


@pytest.mark.cuda
def test_probe_kernel_matches_plain(device):
    x = torch.tensor(np.random.default_rng(1).normal(size=tprobe.SHAPE),
                     dtype=torch.float32, device=device)
    before = tprobe.LAUNCHES
    k = tprobe.probe_kernel(x)
    assert tprobe.LAUNCHES == before + 1
    assert torch.equal(k, tprobe.probe_reference(x))
    assert tprobe.probe(device) == 2048.0
    with pytest.raises(ValueError, match="x:"):
        tprobe.probe_kernel(x.double())


@pytest.mark.cuda
@pytest.mark.parametrize("prim", r5prim.PROBES)
@pytest.mark.parametrize("n_iter", [1, 64])
def test_r5prim_kernel_matches_plain(device, prim, n_iter):
    """Exact for the integer-driven probes, rtol 1e-6 for the others (the
    kernel is built without FMA contraction, so most agree exactly)."""
    x = torch.tensor(np.random.default_rng(n_iter).uniform(
        0.5, 2.0, r5prim.SHAPE), dtype=torch.float32, device=device)
    before = r5prim.LAUNCHES[prim]
    k, place = r5prim.probe_kernel(prim, x, n_iter, return_place=True)
    assert r5prim.LAUNCHES[prim] == before + 1
    r = r5prim.probe_reference(prim, x, n_iter)
    if prim in ("fori_chain", "when_rt"):
        assert torch.equal(k, r)
    else:
        torch.testing.assert_close(k, r, rtol=1e-6, atol=0)
    if prim == "dynread7":
        assert place in ("shared", "device")


@pytest.mark.cuda
@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest-hit", "any-hit"])
def test_sharded_trace_over_nccl_world_of_one(device, tmp_path, occlusion):
    """trace(mesh=) over an NCCL group of one rank: one kernel launch for
    the rank's block, the Hit fields and counters equal to the unsharded
    trace bit for bit on an odd batch."""
    import torch.distributed as dist
    from rrt_tpu_torch.geometry import trace as ttrace
    from rrt_tpu_torch.parallel import sharding as sh
    scene, bh, lo, hi = _scene("cbox", device)
    rays = _rays(16383, 5, device, lo, hi)
    tab = tk.build_tables(scene, bh)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = sh.make_mesh(device)
        assert (mesh.world, mesh.backend) == (1, "nccl")
        h, st = ttrace.trace(scene, bh, rays, return_stats=True,
                             occlusion=occlusion, tables=tab)
        before = tk.LAUNCHES
        hm, stm = ttrace.trace(scene, bh, rays, return_stats=True,
                               occlusion=occlusion, tables=tab, mesh=mesh)
        assert tk.LAUNCHES == before + 1
    finally:
        dist.destroy_process_group()
    for f in ("hit", "t", "p", "n", "w_out", "prim_id", "bsdf_id"):
        assert torch.equal(getattr(hm, f), getattr(h, f)), f
    assert torch.equal(stm, st)


# renders whose passes a graph replays, each against the eager passes
# (`graphs=False`): (scene, size, config keywords, what the render does)
GRAPH_CASES = {
    "curved GI, one pass": ("cbox", 64, dict(ns_aa=16), None),
    "tail pass": ("cbox", 64, dict(ns_aa=10, max_pass_lanes=4 * 64 * 64),
                  None),
    "cells of one size": ("cbox", 64, dict(ns_aa=4), "cells"),
    "adaptive": ("cbox", 64, dict(ns_aa=16, adaptive=True,
                                  samples_per_batch=4,
                                  max_pass_lanes=2 * 64 * 64), None),
    "one sample a pass": ("cbox", 64, dict(max_pass_lanes=64 * 64), None),
    "cbox_dense": ("dense", 64, dict(ns_aa=1, ns_area_light=1,
                                     max_ray_depth=2), None),
    "flat": ("cbox", 64, dict(flat=True), None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_passes_equal_eager(device, case):
    """Passes captured as CUDA graphs and replayed equal the eager passes
    bit for bit (accumulators, counters, trace calls), over three renders
    of one renderer. The kernel's own count of its runs equals the trace
    calls in every render; from the second render on, every pass replays
    (or is captured), so the Python launcher launches nothing."""
    from rrt_tpu_torch.render.renderer import Renderer
    from rrt_tpu_torch.utils.config import BlackHoleConfig, RenderConfig
    name, size, kw, how = GRAPH_CASES[case]
    kw = dict(kw)
    if kw.pop("flat", False):
        kw["black_hole"] = BlackHoleConfig(enabled=False)
    cfg = RenderConfig(width=size, height=size, **{
        "ns_area_light": 4, "max_ray_depth": 5, **kw})
    scene, cam = (build_scene(cbox_dense(), device, size, size)
                  if name == "dense" else
                  load_scene(CBOX_SPHERES, device, size, size))

    def run(r):
        out, calls = [], 0
        for region in ([(0, 0, 24, 16), (30, 40, 24, 16)] if how == "cells"
                       else [None]):
            r.render(region=region)
            out += [*r.last_accumulators, r.last_trace_tests]
            calls += r.last_trace_calls
        return out, calls
    eager = Renderer(scene, cam, cfg, device, graphs=False)
    graph = Renderer(scene, cam, cfg, device)
    assert graph.graphs and not eager.graphs
    want, _ = run(eager)
    for i in range(3):
        tk.reset_counts()
        got, calls = run(graph)
        assert tk.kernel_runs() == calls > 0
        assert tk.LAUNCHES == 0 or i == 0
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert sum(p.call.replays for p in graph._pass_fns.values()) >= 2


@pytest.mark.cuda
def test_kerr_march_blocks_equal_eager(device):
    """The Kerr march in captured blocks (`DiskMarch`, blocks of 20 and a
    remainder of 10) equals the step-by-step march bit for bit, on first
    use and on replay; render_image's default on a card is the blocks."""
    from rrt_tpu_torch.convert import (disk_from_arrays,
                                       kerr_params_from_arrays)
    from rrt_tpu_torch.render import kerr_scene as K
    bh = kerr_params_from_arrays((0.0, 0.0, 0.0), 1.0, 0.9, device)
    disk = disk_from_arrays(3.0, 12.0, (1.0, 0.85, 0.6), 2.0, True, device)
    o, d = K.look_at_rays((0.0, 3.0, 22.0), (0.0, 0.0, 0.0),
                          (0.0, 1.0, 0.0), 30.0, 32, 32, device=device)
    want = K.render_rays(o, d, bh, disk, n_steps=130)
    march = K.DiskMarch(bh, disk)
    for _ in range(2):
        got = K.render_rays(o, d, bh, disk, n_steps=130, march=march)
        assert torch.equal(got, want)
    assert [c.replays for c in march.calls.values()] == [11, 1]
    img = K.render_image(32, 32, bh, disk, n_steps=130, device=device)
    np.testing.assert_array_equal(img, K.render_image(
        32, 32, bh, disk, n_steps=130, device=device, graphs=False))


@pytest.mark.cuda
def test_compiled_gradient_step_equals_eager(device):
    """The gradient step captured as a CUDA graph (`diff.LossAndGrad`) at
    64×64 curved global illumination (-l 1, -m 2), over three steps (the
    eager warm-up, the capture and its replay, a replay) with the radius
    and the reflectance moved and a new key at each: loss and all eleven
    gradients equal the eager `loss_and_grad` bit for bit. The kernel's
    own count of its runs equals the step's trace calls at every
    step, and a replayed step launches nothing through Python."""
    from rrt_tpu_torch.render import diff
    from rrt_tpu_torch.render.renderer import make_black_hole
    from rrt_tpu_torch.tools.inverse import RADIUS_FRAME, pixel_rays
    from rrt_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig(width=64, height=64, ns_aa=1, ns_area_light=1,
                       max_ray_depth=2, seed=0)
    scene, cam = load_scene(CBOX_SPHERES, device, 64, 64, fov_mode="native")
    bh = make_black_hole(cfg, device)
    rays = pixel_rays(cam, 64, 64, device, RADIUS_FRAME)
    params = diff.params_from_scene(scene, bh)
    gen = lambda seed: prng.key(seed, device)
    with torch.no_grad():
        target = diff.render_radiance(params, scene, bh, rays, cfg, gen(9))
    step = diff.LossAndGrad(scene, bh, cfg, rays, target)
    assert step.graphs
    for i in range(3):
        p = params.replace(bh_radius=params.bh_radius + 0.004 * i,
                           reflectance=params.reflectance * (1 - 0.05 * i))
        want = diff.loss_and_grad(p, scene, bh, rays, target, cfg, gen(i))
        tk.reset_counts()
        got = step(p, gen(i))
        assert tk.kernel_runs() == step.trace_calls > 0
        assert tk.LAUNCHES == (step.trace_calls if i == 0 else 0)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1].leaves(), want[1].leaves()):
            assert torch.equal(a, b)
    assert step.call.replays == 2
    assert want[1].bh_radius.abs() > 0


@pytest.fixture
def nccl1(device, tmp_path):
    """An NCCL process group of one rank in this process (a file store in
    the test's directory) and its lane mesh, destroyed after the test."""
    import torch.distributed as dist
    from rrt_tpu_torch.parallel import sharding as sh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = sh.make_mesh(device)
        assert (mesh.world, mesh.backend) == (1, "nccl")
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_capture_right_after_collectives_over_nccl(device, nccl1):
    """Thirty captures, each made as the halves of a sharded program make
    theirs: the call already warmed up, then an all-reduce, an all-gather
    and the seam's gather into a static buffer issued on the NCCL group,
    then at once the capturing call, while the group's watchdog still
    polls the collectives' events. Each capture runs in "thread_local"
    mode, succeeds, and its replay equals the eager call bit for bit. On
    a world of one the collectives end quickly; the multi-rank case is
    phase 4k of chip_smoke.py over gloo, which has no watchdog."""
    from rrt_tpu_torch.parallel import distributed as pdist
    from rrt_tpu_torch.utils.graphs import CapturedCall, capture_mode
    assert capture_mode() == "thread_local"
    x = torch.rand(4096, device=device)
    y = torch.empty_like(x)
    big = torch.rand(1 << 22, 3, device=device)      # 48 MiB a gather
    whole = torch.empty_like(big)

    def chain(x, y):          # a few hundred small kernels to capture
        z = x
        for _ in range(200):
            z = torch.sin(z) * 0.5 + z
        y.copy_(z)
    want = torch.empty_like(x)
    chain(x, want)
    for _ in range(30):
        call = CapturedCall(chain, device, name="a chain")
        y.zero_()
        call(x, y)                # eager
        assert torch.equal(y, want)
        pdist.all_reduce_sum(x, nccl1)
        pdist.all_gather_lanes(x, nccl1, x.shape[0])
        pdist.gather_packed(big, nccl1, big.shape[0], out=whole)
        y.zero_()
        call(x, y)                # captured right away, then replayed
        assert torch.equal(y, want)
        assert call.graph is not None and call.replays == 1
    assert torch.equal(whole, big)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_sharded_graph_passes_equal_eager(device, nccl1, case):
    """Sharded passes over an NCCL group of one rank, each the rank half
    and the accumulate half captured as CUDA graphs with the gather
    between them, equal the eager sharded passes and the unsharded graph
    passes bit for bit (accumulators, counters, trace calls) over three
    renders; the kernel's own count of its runs equals the trace calls in
    every render, and from the second render on the Python launcher
    launches nothing. "cbox_dense" covers the multi-part traversal."""
    from rrt_tpu_torch.parallel import sharding as sh
    from rrt_tpu_torch.render.renderer import Renderer
    from rrt_tpu_torch.utils.config import BlackHoleConfig, RenderConfig
    name, size, kw, how = GRAPH_CASES[case]
    kw = dict(kw)
    if kw.pop("flat", False):
        kw["black_hole"] = BlackHoleConfig(enabled=False)
    cfg = RenderConfig(width=size, height=size, **{
        "ns_area_light": 4, "max_ray_depth": 5, **kw})
    scene, cam = (build_scene(cbox_dense(), device, size, size)
                  if name == "dense" else
                  load_scene(CBOX_SPHERES, device, size, size))
    sharding = sh.batch_sharding(nccl1)

    def run(r):
        out, calls = [], 0
        for region in ([(0, 0, 24, 16), (30, 40, 24, 16)] if how == "cells"
                       else [None]):
            r.render(region=region)
            out += [*r.last_accumulators, r.last_trace_tests]
            calls += r.last_trace_calls
        return out, calls
    want, want_calls = run(Renderer(scene, cam, cfg, device))
    eager = Renderer(scene, cam, cfg, device, sharding=sharding,
                     graphs=False)
    graph = Renderer(scene, cam, cfg, device, sharding=sharding)
    assert graph.graphs and not eager.graphs
    got, calls = run(eager)
    assert calls == want_calls
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for i in range(3):
        tk.reset_counts()
        got, calls = run(graph)
        assert tk.kernel_runs() == calls == want_calls > 0
        assert tk.LAUNCHES == 0 or i == 0
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    runners = graph._pass_fns.values()
    assert all(p.call.replays == p.accumulate.replays for p in runners)
    assert sum(p.call.replays for p in runners) >= 2


@pytest.mark.cuda
def test_sharded_gradient_step_equals_eager(device, nccl1):
    """`LossAndGrad(mesh=)` over an NCCL group of one rank, half A and
    half B captured as CUDA graphs with the all-reduce between them, at
    64×64 curved global illumination (-l 1, -m 2) over three calls with
    moved params and a new key each: the loss and all eleven gradients
    equal the eager `loss_and_grad(mesh=)` bit for bit, the kernel's runs
    equal the trace calls and a replayed step launches nothing through
    Python."""
    from rrt_tpu_torch.render import diff
    from rrt_tpu_torch.render.renderer import make_black_hole
    from rrt_tpu_torch.tools.inverse import RADIUS_FRAME, pixel_rays
    from rrt_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig(width=64, height=64, ns_aa=1, ns_area_light=1,
                       max_ray_depth=2, seed=0)
    scene, cam = load_scene(CBOX_SPHERES, device, 64, 64, fov_mode="native")
    bh = make_black_hole(cfg, device)
    rays = pixel_rays(cam, 64, 64, device, RADIUS_FRAME)
    params = diff.params_from_scene(scene, bh)
    gen = lambda seed: prng.key(seed, device)
    target = torch.full_like(rays.o, 0.2)
    step = diff.LossAndGrad(scene, bh, cfg, rays, target, mesh=nccl1)
    assert step.graphs
    for i in range(3):
        p = params.replace(bh_radius=params.bh_radius + 0.004 * i,
                           reflectance=params.reflectance * (1 - 0.05 * i))
        want = diff.loss_and_grad(p, scene, bh, rays, target, cfg, gen(i),
                                  mesh=nccl1)
        tk.reset_counts()
        got = step(p, gen(i))
        assert tk.kernel_runs() == step.trace_calls > 0
        assert tk.LAUNCHES == (step.trace_calls if i == 0 else 0)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1].leaves(), want[1].leaves()):
            assert torch.equal(a, b)
    assert step.call.replays == step.update.replays == 2
    assert want[1].bh_radius.abs() > 0


@pytest.mark.cuda
def test_sharded_kerr_blocks_equal_step_by_step(device, nccl1):
    """`render_image(sharding=)` over an NCCL group of one rank, its
    block's march in captured blocks (the default on a card) and the
    gather after it, equals the step-by-step sharded image and the
    unsharded image bit for bit, over two batches of one shape."""
    from rrt_tpu_torch.convert import (disk_from_arrays,
                                       kerr_params_from_arrays)
    from rrt_tpu_torch.parallel import sharding as sh
    from rrt_tpu_torch.render import kerr_scene as K
    bh = kerr_params_from_arrays((0.0, 0.0, 0.0), 1.0, 0.9, device)
    disk = disk_from_arrays(3.0, 12.0, (1.0, 0.85, 0.6), 2.0, True, device)
    kw = dict(width=32, height=32, bh=bh, disk=disk, n_steps=130,
              batch=512, device=device)
    sharding = sh.batch_sharding(nccl1)
    want = K.render_image(graphs=False, **kw)
    np.testing.assert_array_equal(K.render_image(
        sharding=sharding, graphs=False, **kw), want)
    np.testing.assert_array_equal(K.render_image(sharding=sharding, **kw),
                                  want)


@pytest.mark.cuda
def test_run_config_plain_backend_on_the_card(device):
    """`run_config --backend plain` on a card: the plain traversal reads the
    host inside a pass, so its renderer runs its three passes eagerly; the
    render ends with a finite, lit image and no kernel run."""
    from rrt_tpu_torch.tools import run_config
    res, hdr, _ = run_config.run([
        CBOX_SPHERES, "--size", "16", "16", "--spp", "3", "-l", "1", "-m",
        "1", "--max-pass-lanes", "256", "--backend", "plain", "--device",
        str(device)])
    assert res["launches"] == 0 and res["trace_calls"] == 6
    assert np.isfinite(hdr).all() and hdr.mean() > 0
