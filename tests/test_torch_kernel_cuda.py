"""The CUDA kernels against their plain PyTorch versions, on a card: the
trace kernel (Cornell box, a 3-part scene and the 14-part BVH-scale
scene; ragged lane counts from spread origins and from one point, masked
lanes, a scene whose box tables do not fit in shared memory, launches
back to back, each in the default build and in the builds that fix its
traversal lane by lane and cooperative), the differentiable trace on the
kernel's primal against the CPU's, the toolchain probe and the eight cost
micro-probes.

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
