"""Schwarzschild stepping of the PyTorch port against the JAX package.

Chord lengths, end points and directions are held to the float64 oracle
(`tests/oracle.py`): the port's worst error against it may be at most
ORACLE_FACTOR times the JAX package's worst error on the same lanes, plus
a few float32 ulps. XLA on the CPU may or may not contract multiply-adds
into FMAs, depending on the host, and the port does not, so a direct
comparison of the two float32 results would hold the port to one host's
rounding.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rrt_tpu.physics import schwarzschild as jss
from rrt_tpu.types import BlackHoleParams
from rrt_tpu_torch.convert import black_hole_from_arrays
from rrt_tpu_torch.physics import schwarzschild as tss
from tests import oracle

RTOL = 1e-6
# XLA on the CPU contracts multiply-adds into FMAs and the port does not, so
# the two round differently by an ulp. A chord direction is (next - pos)/len
# with |pos|/len up to ~20: one ulp of the next point moves it by ~1e-6.
DIR_ATOL = 5e-6
ORACLE_FACTOR = 4.0
ULPS = 4 * float(np.finfo(np.float32).eps)
BH_POS, BH_R, BH_DT = (0.0, 1.0, 0.0), 0.1, 0.1


def _bh(pos=BH_POS, r=BH_R, dt=BH_DT):
    return (BlackHoleParams(position=jnp.asarray(pos, jnp.float32),
                            radius=jnp.float32(r),
                            delta_theta=jnp.float32(dt)),
            black_hole_from_arrays(pos, r, dt, "cpu"))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.5, 0.9], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _oracle_steps(o, d, n_steps):
    """End point and direction after `n_steps` float64 oracle steps from
    each float32 lane, with the hole's float32 radius and Δθ."""
    f32 = lambda v: float(np.float32(v))
    bo = np.asarray(BH_POS, np.float64)
    p_end, d_end = [], []
    for p, u in zip(o.astype(np.float64), d.astype(np.float64)):
        for _ in range(n_steps):
            nd, ln = oracle.micro_step(p, u, bo, f32(BH_R), f32(BH_DT))
            p, u = p + nd * ln, nd
        p_end.append(p)
        d_end.append(u)
    return np.asarray(p_end), np.asarray(d_end)


def _rel(x, ref):
    """Per-lane relative error of vectors (n, 3) or scalars (n,)."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    if ref.ndim == 1:
        return np.abs(x - ref) / np.abs(ref)
    return np.linalg.norm(x - ref, axis=1) / np.linalg.norm(ref, axis=1)


def _no_worse_than_jax(name, port_err, jax_err):
    """The port's worst error against float64 within ORACLE_FACTOR of the
    JAX package's worst on the same lanes, plus a few float32 ulps."""
    bound = ORACLE_FACTOR * jax_err.max() + ULPS
    assert port_err.max() <= bound, (
        f"{name}: port {port_err.max():.3g} vs float64, JAX "
        f"{jax_err.max():.3g}, bound {bound:.3g}")


def test_micro_step_matches_jax():
    jbh, tbh = _bh()
    o, d = _rays(4000, 1)
    jd, jl, jdead = jss.micro_step(jnp.asarray(o), jnp.asarray(d), jbh)
    td, tl, tdead = tss.micro_step(torch.tensor(o), torch.tensor(d), tbh)
    np.testing.assert_array_equal(tdead.numpy(), np.asarray(jdead))
    live = ~tdead.numpy()
    assert live.mean() > 0.99
    o, d = o[live], d[live]
    jd, jl = np.asarray(jd)[live], np.asarray(jl)[live]
    td, tl = td.numpy()[live], tl.numpy()[live]
    p64, d64 = _oracle_steps(o, d, 1)
    l64 = np.linalg.norm(p64 - o.astype(np.float64), axis=1)
    _no_worse_than_jax("chord length", _rel(tl, l64), _rel(jl, l64))
    # the chord's end point, then its direction
    _no_worse_than_jax("end point", _rel(o + td * tl[:, None], p64),
                       _rel(o + jd * jl[:, None], p64))
    _no_worse_than_jax("direction", np.abs(td - d64).max(axis=1),
                       np.abs(jd - d64).max(axis=1))


def test_micro_step_edge_lanes():
    """Degenerate lanes: at the centre, radial (dead); aimed at the hole
    from close by (wrapped, |d| clamped at 1e9)."""
    jbh, tbh = _bh()
    o = np.array([[0, 1, 0], [0, 0.5, 0], [0.2, 1.0, 0.0], [0.5, 1, 0]],
                 np.float32)
    d = np.array([[1, 0, 0], [0, 1, 0], [-1.0, 0.02, 0.0], [0, 0, 1]],
                 np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jd, jl, jdead = jss.micro_step(jnp.asarray(o), jnp.asarray(d), jbh)
    td, tl, tdead = tss.micro_step(torch.tensor(o), torch.tensor(d), tbh)
    np.testing.assert_array_equal(tdead.numpy(), np.asarray(jdead))
    assert tdead[:2].all() and not tdead[2:].any()
    live = ~tdead.numpy()
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=RTOL)
    np.testing.assert_allclose(td.numpy()[live], np.asarray(jd)[live],
                               rtol=0, atol=DIR_ATOL)


def test_march_sequence_matches_jax():
    """Twenty chained steps stay as close to float64 as the JAX package's
    on calm lanes."""
    jbh, tbh = _bh()
    o, d = _rays(500, 2)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.tensor(o), torch.tensor(d)
    for _ in range(20):
        jn, jl, _ = jss.micro_step(jo, jd, jbh)
        tn, tl, _ = tss.micro_step(to, td, tbh)
        jo, jd = jo + jn * jl[:, None], jn
        to, td = to + tn * tl[:, None], tn
    calm = (~tss.chaotic_lanes(torch.tensor(o), torch.tensor(d), tbh,
                               20)).numpy()
    assert calm.mean() > 0.3
    p64, d64 = _oracle_steps(o[calm], d[calm], 20)
    _no_worse_than_jax("end point after 20 steps",
                       _rel(to.numpy()[calm], p64),
                       _rel(np.asarray(jo)[calm], p64))
    _no_worse_than_jax("direction after 20 steps",
                       np.abs(td.numpy()[calm] - d64).max(axis=1),
                       np.abs(np.asarray(jd)[calm] - d64).max(axis=1))


def test_absorbed_by_hole_matches_jax():
    jbh, tbh = _bh(r=0.3)
    o, d = _rays(4000, 3)
    mt = np.random.default_rng(4).uniform(0, 2, 4000).astype(np.float32)
    ja = jss.absorbed_by_hole(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(mt), jbh)
    ta = tss.absorbed_by_hole(torch.tensor(o), torch.tensor(d),
                              torch.tensor(mt), tbh)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert 0.05 < ta.float().mean() < 0.95


@pytest.mark.parametrize("dt", [0.1, 0.05, 0.3, 2 * np.pi / 20])
def test_n_segments_matches_jax(dt):
    assert tss.n_segments(dt) == jss.n_segments(dt)
