"""The row adjoints of the BSDF gathers on the CPU (`ops/row_adjoint.py`,
`render/bsdf._gather`): the plain version against autograd of plain
indexing, the gather's dispatch (plain indexing under `no_grad` and
where no field requires grad, the Function on the CPU too, its adjoint
there the plain version), the gather's Function against plain indexing
in values and gradients, the step's
"adjoint.lanes" counter and "step.gather_adjoint" spans with their
reader, and spans opened by another thread inside `stats.lend()`. The
kernel's side is in tests/test_torch_kernel_cuda.py.
"""
import math
import threading

import numpy as np
import pytest
import torch

from cardbench import harness
from rrt_tpu_torch.ops import row_adjoint as ra
from rrt_tpu_torch.render import bsdf, diff
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES
from rrt_tpu_torch.types import BSDFTable
from rrt_tpu_torch.utils import prng, stats
from rrt_tpu_torch.utils.config import RenderConfig


@pytest.fixture(autouse=True)
def clean():
    stats.reset()
    ra.reset_counts()
    yield
    stats.reset()


def _table(rows, seed, dtype=torch.float64, grad=bsdf.FIELDS):
    """A random BSDF table of `rows` rows whose fields named in `grad`
    require grad; kinds cycle through diffuse, mirror, glass, microfacet
    and emission."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.rand(*s, generator=gen, dtype=dtype) + 0.5
    t = BSDFTable(kind=torch.arange(rows, dtype=torch.int32) % 5,
                  reflectance=rnd(rows, 3), transmittance=rnd(rows, 3),
                  emission=rnd(rows, 3), eta=rnd(rows, 3), k=rnd(rows, 3),
                  alpha=rnd(rows), ior=rnd(rows))
    for f in grad:
        getattr(t, f).requires_grad_(True)
    return t


def _ids(rows, shape, seed):
    """Lane ids in [−3, rows + 3): below 0 and past the last row too."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-3, rows + 3, shape, generator=gen)


@pytest.mark.parametrize("rows,shape", [(1, (5,)), (7, (300,)),
                                        (7, (4, 129)), (64, (1000,))])
def test_reference_equals_autograd_of_indexing(rows, shape):
    """`row_adjoint_reference` of random cotangents equals autograd's
    adjoint of plain indexing by the clamped ids, field by field (float64,
    so that the two orders of summation agree to rounding)."""
    t = _table(rows, 1)
    ids = _ids(rows, shape, 2)
    i = torch.clamp(ids, 0, rows - 1)
    fields = [getattr(t, f) for f in bsdf.FIELDS]
    gen = torch.Generator().manual_seed(3)
    cot = [torch.randn(i.shape + f.shape[1:], generator=gen,
                       dtype=torch.float64) for f in fields]
    cot[2] = None                 # a field the loss does not reach
    loss = sum((f[i] * c).sum() for f, c in zip(fields, cot)
               if c is not None)
    want = torch.autograd.grad(loss, fields, allow_unused=True)
    got = ra.row_adjoint_reference(ids, cot, rows)
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if g is not None:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_wrapper_counts_lanes_and_keeps_none():
    ids = _ids(7, (3, 50), 4)
    g = torch.randn(3, 50, 3, dtype=torch.float64)
    out = ra.row_adjoint(ids, [None, g, None], 7)
    assert out[0] is None and out[2] is None and out[1].shape == (7, 3)
    assert ra.kernel_runs() == 1 and ra.lanes() == 150
    assert ra.row_adjoint(ids, [None], 7) == [None]
    assert ra.kernel_runs() == 1
    with pytest.raises(ValueError):
        ra.row_adjoint(ids, [torch.zeros(3, 49)], 7)
    with pytest.raises(ValueError):
        ra.row_adjoint(ids, [torch.zeros(3, 50, 3, 2)], 7)


def _plain_gather(table, bsdf_id):
    """`bsdf._gather` as plain indexing, whose adjoint is autograd's
    `index_put_` a field."""
    i = torch.clamp(bsdf_id, 0, table.kind.shape[0] - 1).long()
    return BSDFTable(kind=table.kind[i],
                     **{f: getattr(table, f)[i] for f in bsdf.FIELDS})


@pytest.mark.parametrize("case", ["no_grad", "cpu", "no field requires grad"])
def test_gather_takes_plain_indexing(case):
    """`_gather` gives plain indexing's values, under `torch.no_grad`, for
    a table on the CPU and where no float field requires grad. Under
    `no_grad` and with no field requiring grad it is plain indexing (no
    output requires grad, no adjoint runs); on the CPU with grad it is
    the Function, whose adjoint is the plain version, one call a gather,
    equal to autograd's adjoint of plain indexing."""
    t = _table(7, 5, torch.float32,
               grad=() if case == "no field requires grad" else bsdf.FIELDS)
    ids = _ids(7, (64,), 6)
    if case == "no_grad":
        with torch.no_grad():
            m = bsdf._gather(t, ids)
    else:
        m = bsdf._gather(t, ids)
    want = _plain_gather(t, ids)
    for f in bsdf.FIELDS:
        out = getattr(m, f)
        assert torch.equal(out, getattr(want, f))
        assert out.requires_grad == (case == "cpu")
        assert (out.grad_fn is not None and "_RowGather" in
                type(out.grad_fn).__name__) == (case == "cpu")
    assert torch.equal(m.kind, want.kind)
    if case == "cpu":
        fields = [getattr(t, f) for f in bsdf.FIELDS]
        got = torch.autograd.grad(sum(getattr(m, f).sum()
                                      for f in bsdf.FIELDS), fields)
        assert ra.kernel_runs() == 1 and ra.lanes() == 64
        plain = torch.autograd.grad(sum(getattr(want, f).sum()
                                        for f in bsdf.FIELDS), fields)
        for g, w in zip(got, plain):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    else:
        assert ra.kernel_runs() == 0


def _shading_loss(t, ids, seed):
    """A loss through every BSDF entry that gathers: emission, evaluate,
    is_delta and sample, at random local directions."""
    gen = torch.Generator().manual_seed(seed)
    n = ids.shape[0]
    rnd = lambda *s: torch.rand(*s, generator=gen, dtype=torch.float64)
    wo = torch.nn.functional.normalize(rnd(n, 3) - 0.5, dim=-1)
    wo[:, 2] = wo[:, 2].abs() + 0.1
    wi = torch.nn.functional.normalize(rnd(n, 3) - 0.5, dim=-1)
    s = bsdf.sample(t, ids, wo, rnd(n, 2), rnd(n, 2), rnd(n))
    f = bsdf.evaluate(t, ids, wo, wi)
    e = bsdf.emission(t, ids)
    keep = ~bsdf.is_delta(t, ids)
    return ((s.value * s.pdf[:, None]).sum() + (f * keep[:, None]).sum()
            + (e * e).sum())


@pytest.mark.parametrize("grad", [bsdf.FIELDS, ("reflectance", "alpha"),
                                  ("ior",)], ids=["all", "two", "one"])
def test_row_gather_equals_plain_indexing(grad):
    """Through `_gather`'s Function the shading gives plain indexing's
    values, the same fields require grad downstream, and the gradients of
    the table equal plain indexing's to rounding (float64)."""
    ids = _ids(7, (257,), 8)
    t = _table(7, 9, grad=grad)
    m = bsdf._gather(t, ids)
    plain = _table(7, 9, grad=grad)
    i = torch.clamp(ids, 0, 6).long()
    for f in bsdf.FIELDS:
        assert torch.equal(getattr(m, f), getattr(plain, f)[i].detach())
        assert getattr(m, f).requires_grad == (f in grad)
    leaves = [getattr(t, f) for f in grad]
    got = torch.autograd.grad(_shading_loss(t, ids, 10), leaves,
                              allow_unused=True)
    assert ra.kernel_runs() > 0
    runs = ra.kernel_runs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bsdf, "_gather", _plain_gather)
        want = torch.autograd.grad(
            _shading_loss(plain, ids, 10),
            [getattr(plain, f) for f in grad], allow_unused=True)
    assert ra.kernel_runs() == runs
    for f, g, w in zip(grad, got, want):
        assert (g is None) == (w is None), f
        if g is not None:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def step_case():
    """A 4×4 flat step of the spheres box, -l 1 -m 2, 1 spp."""
    cfg = RenderConfig(width=4, height=4, ns_aa=1, ns_area_light=1,
                       max_ray_depth=2, seed=3)
    scene, cam = load_scene(CBOX_SPHERES, "cpu", 4, 4)
    xy = torch.rand(16, 2, generator=torch.Generator().manual_seed(2))
    return cfg, scene, cam.generate_rays(xy)


def _collected_step(step_case):
    cfg, scene, rays = step_case
    step = diff.LossAndGrad(scene, None, cfg, rays, torch.full((16, 3), 0.3))
    with stats.collect():
        out = step.train_step(diff.params_from_scene(scene, None), None,
                              prng.key(5), 0.01)
    return out


def _read(name):
    return harness.load_module("metrics", name).read({})


def test_step_counts_no_adjoint_lanes_with_plain_indexing(step_case,
                                                          monkeypatch):
    """With plain indexing swapped in for `_gather`, no adjoint runs: the
    step counts no lanes and reads no adjoint span."""
    monkeypatch.setattr(bsdf, "_gather", _plain_gather)
    _collected_step(step_case)
    got = stats.COLLECTED
    assert got.host.count("step") == 1
    assert "adjoint.lanes" not in got.counters
    assert "adjoint.lanes" not in stats.report()
    assert got.device.count("step.gather_adjoint") == 0
    assert _read("gather_adjoint_ms.step") is None
    assert _read("backward_ms.step") > 0


def test_step_counts_adjoint_lanes_where_the_function_engages(step_case):
    """Through the gather's Function, the step counts the lanes its
    adjoints reduced (read once, from `lanes_at`) and its adjoint spans
    sit inside "step.backward", where the reader finds them; the loss and
    the update equal the step's with plain indexing."""
    want = _collected_step(step_case)
    got = stats.COLLECTED
    lanes = ra.lanes()
    assert got.counters["adjoint.lanes"] == lanes > 0
    assert lanes % 16 == 0                 # whole batches of the 16 lanes
    assert f"adjoint.lanes: {lanes}" in stats.report()
    n = got.device.count("step.gather_adjoint")
    assert n == ra.kernel_runs() > 0
    assert got.device.count("step.backward") == 1
    assert ("step.backward", "step.gather_adjoint") in got.device
    v = _read("gather_adjoint_ms.step")
    assert v is not None and math.isfinite(v) and v > 0
    assert v <= _read("backward_ms.step")
    stats.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bsdf, "_gather", _plain_gather)
        plain = _collected_step(step_case)
    torch.testing.assert_close(want[2], plain[2], rtol=1e-6, atol=0)
    for a, b in zip(want[0].leaves(), plain[0].leaves()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_lend_nests_another_threads_spans():
    """A span that another thread opens inside `lend()` nests in the
    lender's innermost span; outside `lend()` it stands alone."""
    def in_thread():
        t = threading.Thread(target=lambda: stats.span("worker").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join()

    with stats.collect():
        with stats.span("main"), stats.span("inner", "cpu"), stats.lend():
            in_thread()
            with stats.span("own"):         # this thread: as ever
                pass
        in_thread()
    host = stats.HOST
    assert host.count("worker") == 2
    assert ("main", "inner", "worker") in host
    assert ("worker",) in host
    assert ("main", "inner", "own") in host


def test_gather_adjoint_reader_none_on_an_empty_store():
    assert _read("gather_adjoint_ms.step") is None


def test_row_adjoint_grid():
    """The kernel's grid: 2 lanes a thread, at most 2 blocks an SM."""
    assert ra.grid(0, 132) == ra.grid(1, 132) == 1
    assert ra.grid(65536, 132) == 128
    assert ra.grid(1 << 20, 132) == 264
    assert ra.grid(np.int64(513), 132) == 2
