"""BSDFs and light sampling of the PyTorch port against the JAX package.

The uniforms are drawn with the JAX functions' own key splits
(rrt_tpu/render/bsdf.py:184-201, rrt_tpu/render/lights.py:66) and handed
to the port, so both compute on the same numbers.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rrt_tpu import types as jt
from rrt_tpu.render import bsdf as jbsdf
from rrt_tpu.render import lights as jlights
from rrt_tpu_torch import types as tt
from rrt_tpu_torch.render import bsdf as tbsdf
from rrt_tpu_torch.render import lights as tlights

RTOL = 1e-5
# absolute floor for values that pass through transcendental functions
# (erf, exp, tan, acos) whose float32 results differ by an ulp between
# XLA and PyTorch
ATOL = 1e-6
# the microfacet NDF is exp(-tan²θ/α²): at α = 0.05 the exponent reaches
# ~10³, so the last-ulp difference of tan θ between XLA and PyTorch moves
# the sampled value by up to ~1e-4 relative
MF_RTOL = 2e-4

_BSDF_ROWS = dict(
    kind=[0, 1, 2, 3, 4, 5, 2],
    reflectance=[[0.7, 0.5, 0.3], [0.9, 0.9, 0.9], [0, 0, 0], [0, 0, 0],
                 [1, 1, 1], [0, 0, 0], [0, 0, 0]],
    transmittance=[[0, 0, 0]] * 4 + [[1, 1, 1]] + [[0, 0, 0]] * 2,
    emission=[[0, 0, 0]] * 5 + [[5, 4, 3]] + [[0, 0, 0]],
    eta=[[0, 0, 0], [0, 0, 0], [0.2, 0.9, 1.1], [0, 0, 0], [0, 0, 0],
         [0, 0, 0], [1.6, 0.9, 0.5]],
    k=[[0, 0, 0], [0, 0, 0], [3.9, 2.4, 2.2], [0, 0, 0], [0, 0, 0],
       [0, 0, 0], [8.0, 6.2, 5.1]],
    alpha=[0, 0, 0.3, 0, 0, 0, 0.05],
    ior=[1, 1, 1, 1.45, 1.5, 1, 1],
)


def _tables():
    f = lambda k, a: np.asarray(a, np.int32 if k == "kind" else np.float32)
    arrays = {k: f(k, v) for k, v in _BSDF_ROWS.items()}
    return (jt.BSDFTable(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tt.BSDFTable(**{k: torch.tensor(v) for k, v in arrays.items()}))


def _dirs(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _ids(n, seed):
    return np.random.default_rng(seed).integers(-1, 7, n).astype(np.int32)


def test_evaluate_matches_jax():
    jtab, ttab = _tables()
    n = 4000
    wo, wi, ids = _dirs(n, 1), _dirs(n, 2), _ids(n, 3)
    jf = jbsdf.evaluate(jtab, jnp.asarray(ids), jnp.asarray(wo),
                        jnp.asarray(wi))
    tf = tbsdf.evaluate(ttab, torch.tensor(ids), torch.tensor(wo),
                        torch.tensor(wi))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL,
                               atol=ATOL)
    assert (tf.numpy() > 0).any()
    for fn in ("emission", "is_delta"):
        np.testing.assert_array_equal(
            getattr(tbsdf, fn)(ttab, torch.tensor(ids)).numpy(),
            np.asarray(getattr(jbsdf, fn)(jtab, jnp.asarray(ids))))


@pytest.mark.parametrize("hemi", [False, True], ids=["importance", "hemi"])
def test_sample_matches_jax(hemi):
    jtab, ttab = _tables()
    n = 4000
    wo, ids = _dirs(n, 4), _ids(n, 5)
    key = jax.random.key(11)
    js = jbsdf.sample(jtab, jnp.asarray(ids), jnp.asarray(wo), key,
                      microfacet_hemi=hemi)
    k1, k2, k3 = jax.random.split(key, 3)
    xi = np.asarray(jax.random.uniform(k1, (n, 2), jnp.float32))
    xim = np.asarray(jax.random.uniform(k2, (n, 2), jnp.float32))
    xic = np.asarray(jax.random.uniform(k3, (n,), jnp.float32))
    ts = tbsdf.sample(ttab, torch.tensor(ids), torch.tensor(wo),
                      torch.tensor(xi), torch.tensor(xim), torch.tensor(xic),
                      microfacet_hemi=hemi)
    mf = np.asarray(_BSDF_ROWS["kind"])[np.clip(ids, 0, None)] == 2
    for f in ("wi", "pdf", "value"):
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        np.testing.assert_allclose(a[~mf], b[~mf], rtol=RTOL, atol=ATOL,
                                   err_msg=f)
        np.testing.assert_allclose(a[mf], b[mf], rtol=MF_RTOL, atol=ATOL,
                                   err_msg=f)


def _light_tables():
    rows = dict(
        kind=np.array([4, 2, 0, 1, 3], np.int32),
        radiance=np.array([[8, 8, 8], [2, 1, 1], [1, 1, 2], [0.5, 0.5, 0.5],
                           [1, 1, 1]], np.float32),
        position=np.array([[0, 1.58, 0], [0.3, 1.2, 0.1], [0, 0, 0],
                           [0, 0, 0], [0, 1, 0]], np.float32),
        direction=np.array([[0, -1, 0], [0, 0, 0], [0.6, 0.8, 0], [0, 0, 0],
                            [0, -1, 0]], np.float32),
        dim_x=np.array([[-0.5, 0, 0]] + [[0, 0, 0]] * 4, np.float32),
        dim_y=np.array([[0, 0, -0.5]] + [[0, 0, 0]] * 4, np.float32),
        area=np.array([0.25, 0, 0, 0, 0], np.float32),
    )
    kh = tuple(int(k) for k in rows["kind"])
    return (jt.LightTable(**{k: jnp.asarray(v) for k, v in rows.items()},
                          kind_host=kh),
            tt.LightTable(**{k: torch.tensor(v) for k, v in rows.items()},
                          kind_host=kh))


@pytest.mark.parametrize("idx", range(5),
                         ids=["area", "point", "directional", "hemisphere",
                              "spot"])
def test_sample_light_matches_jax(idx):
    jl, tl = _light_tables()
    n = 3000
    p = np.random.default_rng(6).uniform(
        [-0.9, 0.05, -0.9], [0.9, 1.5, 0.9], (n, 3)).astype(np.float32)
    key = jax.random.key(idx)
    js = jlights.sample_light(jl, idx, jnp.asarray(p), key)
    xi = np.asarray(jax.random.uniform(key, (n, 2), jnp.float32))
    ts = tlights.sample_light(tl, idx, torch.tensor(p), torch.tensor(xi))
    for f in ("radiance", "wi", "dist", "pdf"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    assert tlights.is_delta_light(tl, idx) == jlights.is_delta_light(jl, idx)

