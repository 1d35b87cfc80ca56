"""The port's toolchain probe and cost micro-probes against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

`bench.PROBE` and `tools/r5prim.py` are loaded from their files as they
are; only the loaded code's `pallas_call` gains `interpret=True`, and, for
the cost probes, `pl.reciprocal` is the IEEE reciprocal, as in the port
(its approximate form has no exact counterpart on a card). On the CPU the
port's wrappers run their plain PyTorch versions; the CUDA kernels are
held against those on a card by tests/test_torch_kernel_cuda.py and by
chip_smoke.py.
"""
import functools
import importlib.util
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from rrt_tpu_torch.ops import probe as tprobe
from rrt_tpu_torch.tools import r5prim as t5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# XLA on the CPU contracts multiply-adds into FMAs, the port does not
RTOL = 1e-5
# sweep16's t is the quotient of a cancelling sum of O(1) products; the
# contraction moves it by up to ~12 ulps of those products (1.4e-6)
SWEEP_ATOL = 1e-5


def _load(name, rel_path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel_path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_r5prim():
    """tools/r5prim.py with an interpreting `pl` of IEEE reciprocals."""
    mod = _load("r5prim_reference", "tools/r5prim.py")
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, when=pl.when,
        reciprocal=lambda x, approx=False: 1.0 / x)
    return mod


def _tile(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 2.0, t5.SHAPE).astype(np.float32)


def _numpy_dynread7(x, n_iter):
    """dynread7 in numpy float32 from its documented table."""
    f32 = np.float32
    wc = np.stack([np.stack([x[0] * f32(1e-4 * (7 * w + c + 1))
                             for c in range(7)]) for w in range(8)])
    acc = x.copy()
    for i in range(n_iter):
        for c in range(7):
            acc = acc * f32(0.9999) + wc[i % 8, c]
    return acc


CASES = [("PROBE", 0)] + [(p, n) for p in t5.PROBES for n in (1, 7, 64)]


@pytest.mark.parametrize("name,n_iter", CASES,
                         ids=[f"{p}-{n}" if n else p for p, n in CASES])
def test_matches_pallas_interpret(name, n_iter, monkeypatch, capsys,
                                  jax_r5prim):
    x = _tile(n_iter)
    if name == "PROBE":
        bench = _load("bench_reference", "bench.py")
        monkeypatch.setattr(pl, "pallas_call", functools.partial(
            pl.pallas_call, interpret=True))
        ns = {}
        exec(bench.PROBE, ns)
        assert capsys.readouterr().out.strip() == "2048.0"
        want = np.asarray(ns["f"](jnp.asarray(x[0])))
        got = tprobe.probe_kernel(torch.tensor(x[0]))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tprobe.probe_reference(torch.tensor(x[0])).numpy(), want)
        return
    before = dict(t5.LAUNCHES)
    got = t5.probe_kernel(name, torch.tensor(x), n_iter).numpy()
    assert t5.LAUNCHES == before            # CPU tensors: the plain version
    assert got.shape == t5.SHAPE and got.dtype == np.float32
    if name == "dynread7":
        # the reference reads a table it never writes (NaN in interpret
        # mode): the port is held to its own documented table
        np.testing.assert_array_equal(got, _numpy_dynread7(x, n_iter))
        return
    want = np.asarray(jax_r5prim.build(name, n_iter)(jnp.asarray(x)))
    if name == "fori_chain":
        np.testing.assert_array_equal(got, want)
    else:
        atol = SWEEP_ATOL if name == "sweep16" else 0.0
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    assert np.isfinite(got).all()


def test_wrappers_refuse_what_has_no_kernel():
    """A tensor that is neither on the CPU nor on a card is refused, and
    the probe itself runs only on a card."""
    meta = torch.empty(t5.SHAPE, device="meta")
    with pytest.raises(ValueError, match="no probe kernel"):
        t5.probe_kernel("sweep16", meta, 3)
    with pytest.raises(ValueError, match="no probe kernel"):
        tprobe.probe_kernel(meta[0])
    with pytest.raises(ValueError, match="unknown probe"):
        t5.probe_kernel("gate_half", torch.ones(t5.SHAPE), 3)
    with pytest.raises(ValueError, match="CUDA device"):
        tprobe.probe("cpu")


def test_r5prim_tool_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t5.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
