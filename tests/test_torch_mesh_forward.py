"""The compiled per-trace sharded forward on the CPU:
`render/integrator.Forward` with a mesh, the port's counterpart of the
JAX package's jitted `est_radiance(mesh=)` (rrt_tpu/render/renderer.py:
177-182, tools/scaling_bench.py:203-210), one call with a gather and an
all-reduce at every trace inside it.

The CPU has no CUDA graphs, so the call runs under the stand-in for the
graph of tests/test_torch_graphs.py (the `stand_in` fixture), in the gloo
process group of one rank of tests/test_torch_sharded_graphs.py (the
`world1` fixture); the collectives run inside the stand-in's capture and
replays as they run inside a graph on a card over NCCL. A gloo
collective inside a real capture raises, which the tests show through the
capture flag that `parallel.distributed` reads. The per-trace hits are
held to JAX's `trace(mesh=)` on the CPU's virtual devices under the parity
rules of tests/test_torch_parallel.py; `scaling_bench --breakdown` and
`forward_case` run on the CPU. The `cuda`-marked twin in
tests/test_torch_multicard.py holds the real graph to the eager and the
unsharded forwards on two cards over NCCL.
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rrt_tpu.geometry import trace as jtrace
from rrt_tpu.parallel import sharding as jsh
from rrt_tpu.types import Rays as JRays
from rrt_tpu_torch.geometry import trace as ttrace
from rrt_tpu_torch.ops import trace_kernel as tk
from rrt_tpu_torch.parallel import distributed as pdist
from rrt_tpu_torch.parallel.worker import forward_setup
from rrt_tpu_torch.physics.schwarzschild import chaotic_lanes
from rrt_tpu_torch.render.integrator import Forward, est_radiance
from rrt_tpu_torch.render.renderer import make_black_hole
from rrt_tpu_torch.tools import scaling_bench
from rrt_tpu_torch.utils import prng
from rrt_tpu_torch.utils.config import BlackHoleConfig
from rrt_tpu_torch.utils.graphs import CapturedCall
from test_torch_graphs import stand_in  # noqa: F401  (the graph stand-in)
from test_torch_parallel import HIT_FIELDS, N_SEG, cbox  # noqa: F401
from test_torch_sharded_graphs import world1  # noqa: F401

SIZE = 16
KEY = prng.key(0)      # the JAX scaling tool's key


def _problem(curved: bool):
    """The scaling tool's forward (1 spp, -l 1, -m 2) of a SIZE² frame."""
    scene, _, _, cfg, rays = forward_setup(SIZE, SIZE, "cpu")
    cfg = cfg.replace(black_hole=BlackHoleConfig(enabled=curved))
    bh = make_black_hole(cfg, "cpu")
    return scene, bh, rays, cfg, tk.build_tables(scene, bh)


def _compiled(problem, mesh):
    """The per-trace forward over `mesh` through the stand-in's graph (a
    CPU forward builds none)."""
    f = Forward(*problem, mesh=mesh)
    assert not f.graphs
    f.graphs = True
    return f


@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
def test_compiled_per_trace_forward_equals_eager_and_unsharded(
        stand_in, world1, curved):
    """Four calls (eager, captured and replayed, replayed, replayed), each
    equal bit for bit to the eager per-trace forward and to the unsharded
    one, radiance, counters and trace calls; the trace's runs equal the
    trace calls at every call and no Python launch in a replay; the
    collectives of every call, replays included, equal the eager call's
    (the capture's are taken back out of the count and added at every
    replay)."""
    problem = _problem(curved)
    scene, bh, rays, cfg, tab = problem
    pdist.COLLECTIVES.update(calls=0, bytes=0)
    want = est_radiance(scene, bh, rays, cfg, KEY, tab, mesh=world1)
    eager = dict(pdist.COLLECTIVES)
    plain = est_radiance(scene, bh, rays, cfg, KEY, tab)
    assert torch.equal(want[0], plain[0]) and want[0].abs().sum() > 0
    assert torch.equal(want[1].tests, plain[1].tests)
    assert eager["calls"] == 2 * want[1].calls and eager["bytes"] > 0
    f = _compiled(problem, world1)
    for i in range(4):
        tk.reset_counts()
        pdist.COLLECTIVES.update(calls=0, bytes=0)
        L, work = f(KEY)
        assert torch.equal(L, want[0]) and torch.equal(work.tests,
                                                       want[1].tests), i
        assert work.calls == want[1].calls
        assert tk.kernel_runs() == work.calls
        assert tk.LAUNCHES == (work.calls if i == 0 else 0)
        assert pdist.COLLECTIVES == eager, i
    assert f.call.replays == 3 and f.call.collectives == eager


def test_a_dropped_forward_is_freed_at_once(stand_in, world1):
    """A forward and its call hold no reference cycle, so dropping the
    last reference frees them (a graph's NCCL work included) before the
    process group goes, without waiting for the cycle collector."""
    import gc
    import weakref
    f = _compiled(_problem(False), world1)
    for _ in range(2):                    # eager, then captured
        f(KEY)
    refs = [weakref.ref(f), weakref.ref(f.fn), weakref.ref(f.call)]
    gc.disable()
    try:
        del f
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_a_gloo_collective_in_a_capture_raises(stand_in, world1,
                                               monkeypatch):
    """A gloo collective made while the stream captures raises, named; the
    compiled forward over a gloo mesh runs eagerly by default, and one
    asked for graphs raises at its capture with the collective's line,
    leaving the collectives' count as it was."""
    x = torch.ones(3)
    monkeypatch.setattr(pdist, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="gloo collective cannot be "
                                           "captured in a CUDA graph"):
        pdist.all_reduce_sum(x, world1)
    capturing = []
    capture = CapturedCall._capture          # the stand-in's

    def flagged(self, *args):
        capturing.append(True)
        try:
            return capture(self, *args)
        finally:
            capturing.pop()
    monkeypatch.setattr(CapturedCall, "_capture", flagged)
    monkeypatch.setattr(pdist, "capturing", lambda: bool(capturing))
    assert torch.equal(pdist.all_reduce_sum(x, world1), x)
    problem = _problem(False)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        Forward(*problem, mesh=world1, graphs=True)
    f = _compiled(problem, world1)
    f(KEY)                                  # eager
    pdist.COLLECTIVES.update(calls=0, bytes=0)
    with pytest.raises(RuntimeError) as err:
        f(KEY)
    msg = str(err.value)
    assert msg.startswith("capturing the per-trace sharded forward as a "
                          "CUDA graph failed at rrt_tpu_torch/parallel/"
                          "distributed.py:")
    assert "gloo runs its collectives on the host" in msg
    assert pdist.COLLECTIVES == {"calls": 0, "bytes": 0}


@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
def test_compiled_per_trace_hits_match_jax_trace_mesh(stand_in, world1, cbox,
                                                      curved):
    """`trace(mesh=)` through the stand-in's graph, three calls: its hits
    and counters equal the unsharded trace's bit for bit at every call,
    and its hits match JAX's `trace(mesh=)` on the 8 virtual devices
    under the parity rules (flat hit and prim exact, p to atol 2e-4;
    curved calm lanes exact, >= 99.5% of all)."""
    bh = cbox["tbh"] if curved else None
    tab = tk.build_tables(cbox["ts"], bh)
    rays = cbox["rays"]
    h, st = ttrace.trace(cbox["ts"], bh, rays, return_stats=True, tables=tab)
    call = CapturedCall(lambda: ttrace.trace(
        cbox["ts"], bh, rays, return_stats=True, tables=tab, mesh=world1),
        "cpu", name="trace(mesh=)")
    for _ in range(3):
        hm, stm = call()
        for fld in HIT_FIELDS:
            assert torch.equal(getattr(hm, fld), getattr(h, fld)), fld
        assert torch.equal(stm, st)
    jr = JRays(o=jnp.asarray(rays.o.numpy()), d=jnp.asarray(rays.d.numpy()),
               min_t=jnp.asarray(rays.min_t.numpy()),
               max_t=jnp.asarray(rays.max_t.numpy()))
    jh = jtrace.trace(cbox["js"], cbox["jbh"] if curved else None, jr,
                      mesh=jsh.make_mesh())
    hit_j, hit_t = np.asarray(jh.hit), hm.hit.numpy()
    prim_j, prim_t = np.asarray(jh.prim_id), hm.prim_id.numpy()
    if not curved:
        np.testing.assert_array_equal(hit_t, hit_j)
        np.testing.assert_array_equal(prim_t[hit_t], prim_j[hit_j])
        np.testing.assert_allclose(hm.p.numpy()[hit_t],
                                   np.asarray(jh.p)[hit_j], atol=2e-4)
        return
    calm = ~chaotic_lanes(rays.o, rays.d, bh, N_SEG).numpy()
    assert calm.mean() > 0.3
    np.testing.assert_array_equal(hit_t[calm], hit_j[calm])
    np.testing.assert_array_equal(prim_t[calm], prim_j[calm])
    assert (hit_t == hit_j).mean() >= 0.995


def test_forward_case_on_the_cpu(world1):
    """`scaling_bench.forward_case`, the per-trace case of the card's
    phases 4j and 4n, on the CPU: eager throughout (no graphs here), equal
    to eager and unsharded, its walls, counts and collectives recorded,
    no host launches or pool measured."""
    row = scaling_bench.forward_case(world1, 8, False, reps=1)
    assert row["equal_eager"] and row["equal_unsharded"] and not row["faults"]
    assert not row["compiled"] and row["capture_s"] is None
    assert row["calls"] == 8 and row["lanes"] == 64
    assert {k: len(v) for k, v in row["walls"].items()} == dict(
        graph=1, eager=1, unsharded=1)
    assert row["collectives"]["calls"] == 8
    assert set(row["host_launches"].values()) == {None}
    assert "pool_mib" not in row
    json.dumps(row)


def test_scaling_bench_breakdown_prints_the_jax_keys(capsys):
    """`--breakdown --device cpu`: one JSON line with the JAX tool's keys
    for the flat and curved forwards, the port's block route under its own
    key, null for the lane sort and the transfer with their reasons, and
    every forward marked eager (the CPU has no graphs)."""
    assert scaling_bench.main(["--breakdown", "--device", "cpu", "--size",
                               "8"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (row["world"], row["backend"], row["lanes"]) == (1, "gloo", 64)
    for key in ("flat_sharded_ms", "flat_device0_ms", "flat_block_sharded_ms",
                "curved_nosort_ms"):
        assert row[key] > 0, key
    # a gather and an all-reduce at each of the forward's four traces
    assert row["flat_collectives"]["calls"] == 8
    assert row["curved_collectives"]["calls"] == 8
    assert row["flat_block_sharded_collectives"]["calls"] == 1
    for key in ("curved_sorted", "transfer_extra"):
        assert row[f"{key}_ms"] is None and row[f"{key}_reason"]
    assert row["compiled"] == dict.fromkeys(
        ("flat_sharded", "flat_device0", "flat_block_sharded",
         "curved_nosort"), False)
    assert set(row["host_launches"].values()) == {None}
    assert "sharded_ms" not in row and "card" not in row
