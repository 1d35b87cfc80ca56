"""The compiled sharded paths over NCCL between two cards: two processes,
one a card, in one NCCL group (a file store in the test's directory),
each running this file as a script.

  * captures made at once after a two-rank all-reduce, all-gather and
    the seam's gather into a static buffer (the multi-rank form of
    tests/test_torch_kernel_cuda.py's
    `test_capture_right_after_collectives_over_nccl`): each succeeds in
    "thread_local" mode while NCCL's watchdog polls the collectives'
    events, and replays equal to the eager call; the collectives' results
    hold both ranks' values, and `replicate_global` gives rank 0's on
    both cards;
  * a two-rank sharded render with CUDA graphs (the rank half and the
    accumulate half of each pass captured, the gather between them) on a
    61×61 frame (3,721 lanes a pass: blocks of 1,861 and 1,860): equal to
    the eager sharded render and to the unsharded graph render on the
    rank's own card, bit for bit, in every one of three renders, with the
    kernel's runs equal to the trace calls and no Python launch once the
    passes replay;
  * the per-trace sharded forward `est_radiance(mesh=)` of a 64×64 frame,
    flat and curved, compiled as one graph with the two ranks' gathers and
    all-reduces inside (`tools/scaling_bench.forward_case`): equal bit for
    bit to itself eager and to the unsharded forward on the rank's own
    card at every call, radiance and counters, with a replay's
    collectives equal to the eager forward's.

Every test needs two CUDA cards and skips inside the test without them.
The file imports no JAX, so that a machine with the cards and without
JAX runs it: `python -m pytest --noconftest -q tests/test_torch_multicard.py`.
"""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


@pytest.fixture
def two_cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < WORLD:
        pytest.skip(f"needs {WORLD} CUDA cards for an NCCL group, "
                    f"{n} here")


def _spawn(case: str, tmp_path):
    """Run `case` on WORLD ranks of this file; returns each rank's npz."""
    from rrt_tpu_torch.tools.scaling_bench import run_ranks
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"{case}{i}.npz") for i in range(WORLD)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    run_ranks([[sys.executable, os.path.abspath(__file__), case, str(i),
                store, outs[i]] for i in range(WORLD)],
              [o + ".log" for o in outs], [env] * WORLD, timeout=600)
    return [dict(np.load(o)) for o in outs]


def _captures(mesh, out):
    """Thirty captures, each right after a two-rank all-reduce, all-gather
    and seam gather (the call already warm), against the eager call."""
    from rrt_tpu_torch.parallel import distributed as pdist
    from rrt_tpu_torch.utils.graphs import CapturedCall, capture_mode
    dev = mesh.device
    xs = [torch.rand(4096, device=dev,
                     generator=torch.Generator(dev).manual_seed(r))
          for r in range(mesh.world)]
    x = xs[mesh.rank]
    y = torch.empty_like(x)
    rows = 1 << 21                                  # 24 MiB a block
    big = torch.full((rows, 3), float(mesh.rank + 1), device=dev)
    whole = torch.empty((rows * mesh.world, 3), device=dev)

    def chain(x, y):          # a few hundred small kernels to capture
        z = x
        for _ in range(200):
            z = torch.sin(z) * 0.5 + z
        y.copy_(z)
    want = torch.empty_like(x)
    chain(x, want)
    equal, replays = [], []
    for _ in range(30):
        call = CapturedCall(chain, dev, name="a chain")
        y.zero_()
        call(x, y)                # eager
        equal.append(torch.equal(y, want))
        summed = pdist.all_reduce_sum(x, mesh)
        gathered = pdist.all_gather_lanes(x, mesh, x.shape[0] * mesh.world)
        pdist.gather_packed(big, mesh, whole.shape[0], out=whole)
        y.zero_()
        call(x, y)                # captured right away, then replayed
        equal.append(torch.equal(y, want))
        replays.append(call.replays)
    blocks = torch.arange(mesh.world, device=dev).repeat_interleave(rows) + 1
    np.savez(out, mode=capture_mode(), equal=equal, replays=replays,
             summed=torch.equal(summed, sum(xs[1:], xs[0])),
             gathered=torch.equal(gathered, torch.cat(xs)),
             replicated=torch.equal(pdist.replicate_global(x, mesh), xs[0]),
             whole=torch.equal(whole, blocks[:, None].float().expand(-1, 3)))


def _render(mesh, out):
    """Three renders each of the sharded graph, eager sharded and
    unsharded graph renderers (61×61, 2 spp a pass at one sample each,
    -l 4, -m 5)."""
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.parallel import sharding as sh
    from rrt_tpu_torch.render.renderer import Renderer
    from rrt_tpu_torch.scene.build import load_scene
    from rrt_tpu_torch.scenes import CBOX_SPHERES
    from rrt_tpu_torch.utils.config import RenderConfig
    dev, n = mesh.device, 61
    cfg = RenderConfig(width=n, height=n, ns_aa=2, ns_area_light=4,
                       max_ray_depth=5, max_pass_lanes=n * n)
    scene, cam = load_scene(CBOX_SPHERES, dev, n, n)
    sharding = sh.batch_sharding(mesh)
    rs = {"graph": Renderer(scene, cam, cfg, dev, sharding=sharding),
          "eager": Renderer(scene, cam, cfg, dev, sharding=sharding,
                            graphs=False),
          "unsharded": Renderer(scene, cam, cfg, dev)}
    res = {}
    for name, r in rs.items():
        for i in range(3):
            tk.reset_counts()
            r.render()
            res[f"{name}{i}"] = [*r.last_accumulators, r.last_trace_tests]
            res[f"{name}{i}_counts"] = (r.last_trace_calls, tk.kernel_runs(),
                                        tk.LAUNCHES)
    want = res["unsharded0"]
    equal = {k: all(np.array_equal(a, b) for a, b in zip(v, want))
             for k, v in res.items() if not k.endswith("_counts")}
    np.savez(out, graphs=rs["graph"].graphs, equal=list(equal.values()),
             counts=np.array([res[f"graph{i}_counts"] for i in range(3)]),
             replays=[p.call.replays for p in rs["graph"]._pass_fns.values()],
             lit=float(want[0].sum()))


def _forward(mesh, out):
    """The per-trace forward case, flat and curved, as JSON rows."""
    import json
    from rrt_tpu_torch.tools.scaling_bench import forward_case
    rows = [json.dumps(forward_case(mesh, 64, curved, reps=2))
            for curved in (False, True)]
    np.savez(out, rows=rows)


@pytest.mark.cuda
def test_two_rank_per_trace_forward_equals_eager_and_unsharded(two_cards,
                                                               tmp_path):
    import json
    for r in _spawn("forward", tmp_path):
        for row in map(json.loads, r["rows"]):
            assert row["compiled"] and row["world"] == WORLD
            assert row["equal_eager"] and row["equal_unsharded"]
            # the capture's replay, two timed and one profiled
            assert not row["faults"] and row["replays"] == 4
            assert row["graph_collectives"] == row["collectives"]
            assert row["host_launches"]["graph"] < 10


@pytest.mark.cuda
def test_capture_right_after_two_rank_collectives_over_nccl(two_cards,
                                                            tmp_path):
    for r in _spawn("captures", tmp_path):
        assert str(r["mode"]) == "thread_local"
        assert r["equal"].all() and (r["replays"] == 1).all()
        assert bool(r["summed"]) and bool(r["gathered"]) and bool(r["whole"])
        assert bool(r["replicated"])


@pytest.mark.cuda
def test_two_rank_sharded_graph_render_equals_eager(two_cards, tmp_path):
    for r in _spawn("render", tmp_path):
        assert bool(r["graphs"]) and r["equal"].all()
        calls, runs, launches = r["counts"].T
        assert (runs == calls).all() and (calls > 0).all()
        assert launches[1:].tolist() == [0, 0]
        assert sum(r["replays"]) >= 4 and float(r["lit"]) > 0


if __name__ == "__main__":
    case, rank, store, out = sys.argv[1:5]
    import torch.distributed as dist
    from rrt_tpu_torch.parallel import sharding as sh
    torch.cuda.set_device(int(rank))
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=WORLD, rank=int(rank))
    try:
        cases = {"captures": _captures, "render": _render,
                 "forward": _forward}
        cases[case](sh.make_mesh("cuda"), out)
    finally:
        dist.destroy_process_group()
