"""The port's Kerr geodesics and accretion-disk renderer against the JAX
package (rrt_tpu/physics/kerr.py, rrt_tpu/render/kerr_scene.py) on seeded
inputs, the physics invariants of tests/test_kerr.py at small sizes, the
Kerr CLI, the hand-derived ∂ℋ against autograd of ℋ, and the march's
plain version (`render/kerr_scene.march_steps`, the Kerr march kernel's
reference): its settled lanes' zero steps, its issued lane-slots and the
wrapper's checks (`ops/kerr_march`)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrt_tpu.physics import kerr as jkerr
from rrt_tpu.render import kerr_scene as JK
from rrt_tpu_torch import convert, kerr_cli
from rrt_tpu_torch.io.png import read_png
from rrt_tpu_torch.ops import kerr_march as km
from rrt_tpu_torch.physics import kerr
from rrt_tpu_torch.render import kerr_scene as K

RTOL = 1e-5


def _holes(mass=1.0, spin=0.9):
    """The JAX package's KerrParams and the port's, carried across as
    numpy arrays."""
    jbh = jkerr.KerrParams(position=jnp.zeros(3),
                           mass=jnp.asarray(mass, jnp.float32),
                           spin=jnp.asarray(spin, jnp.float32))
    return jbh, convert.kerr_params_from_arrays(
        np.asarray(jbh.position), np.asarray(jbh.mass), np.asarray(jbh.spin),
        "cpu")


def _disk(jdisk):
    """The port's DiskParams from the JAX package's."""
    return convert.disk_from_arrays(
        np.asarray(jdisk.r_in), np.asarray(jdisk.r_out),
        np.asarray(jdisk.emission), np.asarray(jdisk.q), jdisk.beaming, "cpu")


def _phase_space(n=256, seed=0):
    """Seeded hole-frame positions 4–20 from the centre and momenta."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    x *= (rng.uniform(4.0, 20.0, n) / np.linalg.norm(x, axis=1))[:, None]
    p = rng.normal(size=(n, 3))
    return x.astype(np.float32), p.astype(np.float32)


def _close(t, j, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def test_hamiltonian_and_momentum_match_jax():
    jbh, bh = _holes()
    x, p = _phase_space()
    d = p / np.linalg.norm(p, axis=1, keepdims=True)
    _close(kerr.hamiltonian(torch.tensor(x), torch.tensor(p),
                            torch.tensor(-1.0), bh.mass, bh.spin),
           jkerr.hamiltonian(jnp.asarray(x), jnp.asarray(p), -1.0,
                             jbh.mass, jbh.spin))
    tpt, tp = kerr.init_momentum(torch.tensor(x), torch.tensor(d),
                                 bh.mass, bh.spin)
    jpt, jp = jkerr.init_momentum(jnp.asarray(x), jnp.asarray(d),
                                  jbh.mass, jbh.spin)
    _close(tpt, jpt)
    _close(tp, jp)
    assert float(bh.horizon_radius) == pytest.approx(
        float(jbh.horizon_radius), rel=1e-7)


def test_rhs_and_rk4_match_jax():
    """Hamilton's equations, written out by hand, against jax.grad, under
    no_grad too, and RK4 steps with a scalar and a per-lane step."""
    jbh, bh = _holes()
    x, p = _phase_space(seed=1)
    tx, tp = torch.tensor(x), torch.tensor(p)
    jx, jp = jnp.asarray(x), jnp.asarray(p)
    with torch.no_grad():
        tr = kerr._rhs(tx, tp, torch.tensor(-1.0), bh.mass, bh.spin)
    jr = jkerr._rhs(jx, jp, -1.0, jbh.mass, jbh.spin)
    for a, b in zip(tr, jr):
        assert not a.requires_grad
        _close(a, b, atol=1e-5)
    dlam = np.random.default_rng(2).uniform(0.02, 0.5, x.shape[0])
    for step in (0.1, dlam.astype(np.float32)):
        tn = kerr.rk4_step(tx, tp, torch.tensor(-1.0), bh.mass, bh.spin,
                           torch.as_tensor(step))
        jn = jkerr.rk4_step(jx, jp, -1.0, jbh.mass, jbh.spin,
                            jnp.asarray(step))
        for a, b in zip(tn, jn):
            _close(a, b, atol=1e-5)


def test_march_step_matches_jax():
    """World rays into the hole frame (`make_state`, `to_world`), then one
    march step from seeded states near the horizon and near the escape
    radius, some frozen already: states to rtol 1e-5, the captured and
    escaped flags exactly."""
    jbh, bh = _holes()
    rng = np.random.default_rng(3)
    o = rng.uniform(-20.0, 20.0, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    st = kerr.make_state(torch.tensor(o), torch.tensor(d), bh)
    jst = jkerr.make_state(jnp.asarray(o), jnp.asarray(d), jbh)
    for a, b in ((st.x, jst.x), (st.p, jst.p), (st.pt, jst.pt)):
        _close(a, b, atol=1e-5)
    _close(kerr.to_world(st.x, bh), o, atol=1e-5)
    x, p = _phase_space(512, seed=4)
    x *= (rng.uniform(1.5, 10.5, 512) / np.linalg.norm(x, axis=1))[:, None]
    x, p = x.astype(np.float32), p.astype(np.float32)
    flags = rng.random((2, 512)) < 0.1
    dlam = rng.uniform(0.05, 0.6, 512).astype(np.float32)
    st, (ta, tb) = kerr.march_step(
        kerr.MarchState(torch.tensor(x), torch.tensor(p),
                        torch.full((512,), -1.0), torch.tensor(flags[0]),
                        torch.tensor(flags[1])), bh, torch.tensor(dlam),
        r_escape=10.0)
    jst, (ja, jb) = jkerr.march_step(
        jkerr.MarchState(jnp.asarray(x), jnp.asarray(p),
                         jnp.full((512,), -1.0), jnp.asarray(flags[0]),
                         jnp.asarray(flags[1])), jbh, jnp.asarray(dlam),
        r_escape=10.0)
    for a, b in ((st.x, jst.x), (st.p, jst.p), (ta, ja), (tb, jb)):
        _close(a, b, atol=1e-5)
    for a, b, before in ((st.captured, jst.captured, flags[0]),
                         (st.escaped, jst.escaped, flags[1])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert (a.numpy() & ~before).any()         # new ones this step
        assert a.numpy()[before].all()


def _classes(img):
    """0 captured (black), 1 disk (red over blue, the disk's colour), 2
    escaped (the blue background gradient)."""
    black = (img == 0).all(-1)
    return np.where(black, 0, np.where(img[..., 0] > img[..., 2], 1, 2))


def test_spp2_render_matches_jax_per_pixel():
    """A 24×24, 300-step frame at 2 spp: both packages jitter the pixels
    by the same uniforms (key(0), split once a sample; the port's
    `prng`), so the two images agree pixel by pixel: every pixel within
    rtol 1e-3 (found: all within it, the means 1.2e-7 apart; at 1 spp
    the lanes' classes may differ on 1%)."""
    jbh, bh = _holes()
    jdisk = JK.default_disk(1.0)
    jimg = JK.render_image(24, 24, jbh, jdisk, n_steps=300, spp=2)
    img = K.render_image(24, 24, bh, _disk(jdisk), n_steps=300,
                         device="cpu", spp=2)
    assert np.isfinite(img).all() and img.mean() > 0
    assert np.isclose(img, jimg, rtol=1e-3, atol=1e-6).all(-1).mean() == 1.0
    assert abs(img.mean() / jimg.mean() - 1) <= 1e-3


def test_render_rays_matches_jax():
    """A 24×24, 300-step frame of both packages: disk, escape and capture
    agree on ≥ 99% of lanes, radiance to rtol 1e-3 on those."""
    jbh, bh = _holes()
    jdisk = JK.default_disk(1.0)
    disk = _disk(jdisk)
    for field in ("r_in", "r_out", "emission", "q"):
        np.testing.assert_array_equal(getattr(disk, field).numpy(), getattr(
            K.default_disk(1.0, device="cpu"), field).numpy())
    jimg = JK.render_image(24, 24, jbh, jdisk, n_steps=300)
    img = K.render_image(24, 24, bh, disk, n_steps=300, device="cpu")
    jc, tc = _classes(jimg), _classes(img)
    assert (np.bincount(tc.ravel(), minlength=3) > 0).all()
    agree = jc == tc
    assert agree.mean() >= 0.99, agree.mean()
    np.testing.assert_allclose(img[agree], jimg[agree], rtol=1e-3, atol=1e-6)
    # the classes read from the radiance are trace_disk's masks
    o, d = K.look_at_rays((0.0, 3.0, 22.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                          30.0, 24, 24, device="cpu")
    st, _, hit_disk = K.trace_disk(o, d, bh, disk, 300)
    np.testing.assert_array_equal(hit_disk.numpy().reshape(24, 24), tc == 1)
    np.testing.assert_array_equal(
        (st.escaped & ~hit_disk).numpy().reshape(24, 24), tc == 2)


def test_geodesic_invariants():
    """tests/test_kerr.py's physics on one batch of rays (mass and spin per
    lane, the renderer's adaptive step): zero mass goes straight, weak
    field bends by 4M/b, capture below the critical impact parameter
    (3√3·M), escape above it, and the null constraint holds."""
    mass = torch.tensor([1e-9, 0.5, 0.5, 0.5, 1.0])
    spin = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.7])
    o = torch.tensor([[-40.0, 0.0, 5.0], [-40.0, 0.0, 20.0],
                      [-40.0, 0.0, 1.2], [-40.0, 0.0, 3.0],
                      [-30.0, 2.0, 4.0]])
    d = torch.tensor([[1.0, 0.0, 0.0]] * 4 + [[1.0, 0.05, -0.1]])
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    bh = kerr.KerrParams(position=torch.zeros(3), mass=mass, spin=spin)
    st = kerr.make_state(o, d, bh)
    h0 = kerr.hamiltonian(st.x, st.p, st.pt, mass, spin)
    assert h0.abs().max() < 1e-5
    for _ in range(800):
        r = torch.sqrt(kerr._kerr_r2(st.x[:, 0], st.x[:, 1], st.x[:, 2],
                                     spin))
        dlam = torch.clamp(0.05 * (r - 0.5 * bh.horizon_radius), 0.01, 1.0)
        st, _ = kerr.march_step(st, bh, dlam, r_escape=100.0)
    p = st.p / torch.linalg.vector_norm(st.p, dim=1, keepdim=True)
    ang = torch.arccos(torch.clamp(p[:, 0], -1.0, 1.0)).numpy()
    assert st.escaped[:2].all() and st.escaped[3]
    assert ang[0] < 1e-4
    assert ang[1] == pytest.approx(4 * 0.5 / 20.0, rel=0.08)
    assert st.captured[2] and not st.captured[3]
    h1 = kerr.hamiltonian(st.x, st.p, st.pt, mass, spin)
    assert h1.abs().max() < 1e-2


def test_kerr_cli_writes_a_png(tmp_path):
    out = str(tmp_path / "kerr.png")
    img = kerr_cli.main(["-f", out, "-r", "16", "12", "--steps", "120",
                         "--spin", "0.8", "--device", "cpu"])
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    png = read_png(out)
    assert png.shape == (12, 16, 4) and png[..., :3].max() > 10


def test_kerr_cli_refuses_sharded_and_missing_cuda(tmp_path, monkeypatch,
                                                   capsys):
    """--sharded is no longer refused: without the RRT_* variables it
    shards over a world of 1 and gives the unsharded image. A missing
    card is still refused."""
    out = str(tmp_path / "kerr.png")
    for name in ("RRT_COORDINATOR", "RRT_NUM_PROCESSES", "RRT_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    args = ["-r", "9", "7", "--steps", "60", "--device", "cpu"]
    img = kerr_cli.main(["-f", out, "--sharded"] + args)
    assert "lane-sharded over 1 device(s)" in capsys.readouterr().out
    np.testing.assert_array_equal(
        img, kerr_cli.main(["-f", str(tmp_path / "plain.png")] + args))
    assert os.path.exists(out)
    os.remove(out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        kerr_cli.main(["-f", out, "-r", "8", "8"])
    assert e.value.code == 2 and "--device cpu" in capsys.readouterr().err
    assert not os.path.exists(out)


@pytest.mark.parametrize("fn", [K.default_disk, K.look_at_rays],
                         ids=["default_disk", "look_at_rays"])
def test_scene_constructors_default_to_the_card(fn):
    """The Kerr scene's public constructors put their tensors on the card
    unless the caller asks for the CPU, as the port's entry points do."""
    import inspect
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def _region_points(spin, region, n=256, seed=0):
    """Seeded hole-frame points of one region and momenta: far out (4–40),
    just outside capture (1.02 r_h to 1.2 r_h + 0.3), on the spin axis
    and in the equatorial plane outside the ring (1.1 r_h to 20)."""
    rng = np.random.default_rng(seed)
    rh = 1.0 + np.sqrt(1.0 - spin * spin)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lo, hi = dict(far=(4.0, 40.0), near=(1.02 * rh, 1.2 * rh + 0.3)).get(
        region, (1.1 * rh, 20.0))
    rad = rng.uniform(lo, hi, n)
    x = d * rad[:, None]
    if region == "axis":
        x = np.zeros((n, 3))
        x[:, 2] = rad * np.where(rng.random(n) < 0.5, -1.0, 1.0)
    elif region == "plane":
        x[:, 2] = 0.0
        x[:, :2] *= (rad / np.linalg.norm(x[:, :2], axis=1))[:, None]
    return x, rng.normal(size=(n, 3))


def _autograd_rhs(x, p, pt, mass, a):
    """(∂ℋ/∂p, −∂ℋ/∂x) by autograd of `hamiltonian`."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        pg = p.detach().requires_grad_(True)
        dx, dp = torch.autograd.grad(
            kerr.hamiltonian(xg, pg, pt, mass, a).sum(), (xg, pg))
    return dp, -dx


@pytest.mark.parametrize("region", ["far", "near", "axis", "plane"])
@pytest.mark.parametrize("spin", [0.0, 0.5, 0.9])
def test_hand_derived_rhs_equals_autograd(spin, region):
    """`kerr._rhs` (∂ℋ written out by hand) against autograd of ℋ: in
    float64 to 1e-12 of the largest component (found: 1e-15); in float32
    to 4e-6 of it. Both float32 evaluations round the same derivative
    along different op orders, each found within 1e-6 of the float64
    value at these points (autograd's own up to 9.8e-7), so they part by
    at most about twice that."""
    x, p = _region_points(spin, region)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 4e-6)):
        args = [torch.tensor(v, dtype=dtype) for v in (x, p, -1.0, 1.0,
                                                         spin)]
        with torch.no_grad():
            got = kerr._rhs(*args)
        for g, w in zip(got, _autograd_rhs(*args)):
            assert g.dtype == dtype and not g.requires_grad
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= tol * scale


def _lanes(size=12, steps=60, spin=0.9):
    bh = convert.kerr_params_from_arrays((0.0, 0.0, 0.0), 1.0, spin, "cpu")
    disk = K.default_disk(1.0, device="cpu")
    o, d = K.look_at_rays((0.0, 3.0, 22.0), (0.0, 0.0, 0.0),
                          (0.0, 1.0, 0.0), 30.0, size, size, device="cpu")
    st = kerr.make_state(o, d, bh)
    lanes = K._lanes(st, torch.zeros(o.shape), torch.zeros(
        o.shape[0], dtype=torch.bool))
    return bh, disk, lanes


def test_settled_lanes_zero_steps_change_nothing():
    """The kernel stops a lane at the step where it settles (captured,
    escaped or on the disk); the plain march keeps stepping it with a
    zero step. Stopping changes no answer: after the step where each lane
    settles, its state, radiance and flags already equal the whole
    march's, bit for bit, and its count of settled steps is the steps
    left."""
    steps = 150
    bh, disk, lanes = _lanes(steps=steps)
    final = km.Lanes(*(t.clone() for t in lanes))
    K.march_steps(final, steps, bh, disk, 45.0)
    live = steps - final.settled
    assert 0 < int(live.min()) < int(live.max()) < steps   # all settled
    st = kerr.MarchState(*lanes[:5])
    acc, hit = lanes.acc, lanes.hit
    for k in range(steps + 1):
        stop = live == k
        for got, want in zip((*st, acc, hit), final[:7]):
            assert torch.equal(got[stop], want[stop])
        if k < steps:
            st, acc, hit = K._disk_step(st, acc, hit, bh, disk, 45.0)


def test_issued_lane_slots_are_the_warps_most_steps():
    """`kerr.lanes_issued`: 32 × the most live steps of each group of 32
    consecutive lanes, a ragged last group counting 32 slots; the plain
    march adds that of its lanes' live steps to `issued`."""
    live = torch.tensor([3] * 31 + [7] + [0] * 32 + [2, 5])
    assert int(km.warp_issued(live)) == 32 * (7 + 0 + 5)
    assert int(km.warp_issued(torch.zeros(0, dtype=torch.int32))) == 0
    bh, disk, lanes = _lanes(size=10)
    lanes.issued.fill_(11)
    K.march_steps(lanes, 60, bh, disk, 45.0)
    left = torch.nn.functional.pad(60 - lanes.settled, (0, 28))
    assert int(lanes.issued) == 11 + 32 * int(
        left.reshape(-1, 32).amax(1).sum())


@pytest.mark.parametrize("fault", ["device", "dtype", "shape", "strided",
                                   "issued"])
def test_march_wrapper_checks_its_buffers(fault):
    """`ops/kerr_march.march` raises on a buffer on another device, of
    another dtype or shape, strided, or a wrong `issued` counter, and on a
    device it has no march for."""
    bh, disk, lanes = _lanes(size=4)
    bad = {"device": dict(p=lanes.p.to("meta")),
           "dtype": dict(settled=lanes.settled.long()),
           "shape": dict(acc=lanes.acc[:-1]),
           "strided": dict(x=lanes.x.t().contiguous().t()),
           "issued": dict(issued=torch.zeros(2, dtype=torch.int64))}[fault]
    with pytest.raises(ValueError, match=f"^{next(iter(bad))}: expected"):
        km.march(lanes._replace(**bad), 10, bh, disk, 45.0)
    with pytest.raises(ValueError, match="no Kerr march for device meta"):
        km.march(km.Lanes(*(t.to("meta") for t in lanes)), 10, bh, disk,
                 45.0)
