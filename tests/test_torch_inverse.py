"""Closed-loop inverse rendering through the port (the analogs of
tests/test_inverse.py, BASELINE config 4, on the in-repo box; see
`rrt_tpu_torch.tools.inverse` for how they differ), and the JAX package's
radius loop on the same framed rays as a second witness. Marked slow, as
the originals are; `python3 chip_smoke.py` runs the port's loops on the
card.

`PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_inverse.py [KEY
...] [--frame F]` runs the JAX package's radius loop for each PRNG key
(default 0-7) and prints where it ends: on this box some keys recover the
radius and others do not, as the port's seeds do.
"""
import numpy as np
import pytest

from rrt_tpu_torch.tools import inverse


def jax_radius_loop(key: int, frame: float = inverse.RADIUS_FRAME) -> float:
    """The JAX package's config 4 radius loop (tests/test_inverse.py) on
    the in-repo box, its rays through the central `frame` of the native
    frame (the port's `RADIUS_FRAME`): returns the radius after the
    loop's steps."""
    import jax
    import jax.numpy as jnp
    from rrt_tpu.render import diff
    from rrt_tpu.render.renderer import make_black_hole
    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.utils.config import RenderConfig
    from rrt_tpu_torch.scenes import CBOX_SPHERES

    w = h = 32
    cfg = RenderConfig(width=w, height=h, ns_aa=1, ns_area_light=1,
                       max_ray_depth=2, seed=0)
    scene, cam = load_scene(CBOX_SPHERES, w, h, fov_mode="native")
    bh = make_black_hole(cfg)
    ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                         indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    rays = cam.generate_rays(
        jnp.asarray(0.5 + (xy - 0.5) * frame))
    k = jax.random.key(key)
    p_true = diff.params_from_scene(scene, bh)
    target = jax.jit(
        lambda p: diff.render_radiance(p, scene, bh, rays, cfg, k))(p_true)
    loss_fn = jax.jit(jax.value_and_grad(
        lambda p: diff.image_loss(p, scene, bh, rays, target, cfg, k)))
    p = p_true.replace(bh_radius=jnp.asarray(inverse.RADIUS_START,
                                             jnp.float32))
    for _ in range(inverse.RADIUS_STEPS):
        _, g = loss_fn(p)
        p = p.replace(bh_radius=jnp.clip(
            p.bh_radius - inverse.RADIUS_LR * g.bh_radius,
            *inverse.RADIUS_CLIP))
    return float(p.bh_radius)


@pytest.mark.slow
def test_inverse_radius_loop():
    """From 0.14 the port's radius loop ends within 0.015 of the true 0.1
    (config 4's rule), at the CPU's `RADIUS_SEED`."""
    r, true, ms = inverse.recover_radius("cpu")
    assert abs(r - true) < 0.015, f"recovered radius {r}, true {true}"
    assert ms > 0


@pytest.mark.slow
def test_jax_radius_loop_recovers_on_the_framed_box():
    """The JAX package's own loop recovers the radius on the same framed
    rays at key 7 (and 5 and 6; keys 0-4 do not: the loss moves mostly
    through discrete events there too)."""
    r = jax_radius_loop(7)
    assert abs(r - 0.1) < 0.015, f"recovered radius {r}, true 0.1"


@pytest.mark.slow
def test_inverse_recovers_albedo():
    got, true, _ = inverse.recover_albedo("cpu")
    assert np.abs(got - true).max() < 0.08, (got, true)


def test_radius_sweep_rows():
    """The sweep's rows: the loss is 0 with a zero gradient at the true
    radius (the target's own render), positive and finite away from it."""
    rows = inverse.radius_sweep("cpu", [0.1, 0.12])
    assert rows[0][0] == pytest.approx(0.1)
    assert rows[0][1] == 0.0 and rows[0][2] == 0.0
    assert rows[1][1] > 0 and np.isfinite(rows[1][2])


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="the JAX package's radius loop "
                                 "per PRNG key")
    ap.add_argument("keys", type=int, nargs="*", default=list(range(8)))
    ap.add_argument("--frame", type=float, default=inverse.RADIUS_FRAME)
    args = ap.parse_args()
    for key in args.keys:
        r = jax_radius_loop(key, args.frame)
        print(f"JAX radius loop, frame {args.frame}, key {key}: "
              f"{inverse.RADIUS_START} -> {r:.5f} ("
              f"{'within' if abs(r - 0.1) < 0.015 else 'not within'} 0.015 "
              "of 0.1)", flush=True)
