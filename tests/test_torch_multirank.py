"""The lane-sharded paths on three and four ranks: real processes of
`rrt_tpu_torch.parallel.worker` in a gloo group on the CPU (one intra-op
thread each), on a 5×11 frame (55 lanes: blocks of 19, 19 and 17 lanes on
three ranks, 14, 14, 14 and 13 on four), held to this process's own
single-process runs (`worker.reference`):

  * the blocks tile the frame, and each rank's forward block equals its
    rows of the whole frame's forward;
  * a curved GI render (-m 3, 2 passes) with `Renderer(sharding=)`: its
    accumulators equal the single-process render's bit for bit on every
    rank (the gather only moves values);
  * `LossAndGrad(mesh=)` over three calls: every call equal to the rank's
    own `loss_and_grad(mesh=)` bit for bit, every rank holding the same
    result, and the last call within the order-free bound of a float32
    sum of the ranks' shares computed in this process (`worker.off_bound`:
    the all-reduce sums three or four shares in an order it does not
    state);
  * the per-trace sharded forward (`est_radiance(mesh=)`) of a 5×5
    frame (25 lanes: blocks of 9, 9 and 7, or 7, 7, 7 and 4), flat and
    curved, equal in every rank to itself eager and to the unsharded
    forward bit for bit, radiance and counters (the counters are
    integers, exact in any order of the sum), with a gather and an
    all-reduce at each of its four traces;
  * the four-rank step against the JAX package's sharded
    `value_and_grad` on a 4-device CPU mesh (`jax_parity` of
    tests/test_torch_sharded_graphs.py).

tests/test_torch_distributed.py holds two ranks, whose step is bit for
bit, and shows that the bound rejects a sum outside it.
"""
import os
import threading

import numpy as np
import pytest

from rrt_tpu_torch.parallel import worker
from rrt_tpu_torch.tools.scaling_bench import spawn_workers
from test_torch_sharded_graphs import jax_parity

W, H = 5, 11
CHECKS = ("render", "step", "mesh")
LEAVES = ("loss",) + worker._LEAVES
WORLDS = (3, 4)


@pytest.fixture(scope="module")
def all_ranks(tmp_path_factory):
    """{world: (the ranks' npz dicts, their logs, the single-process
    reference for that world)}: both worlds' ranks run at once, while
    this process computes the references."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    done = {}

    def run(world):
        try:
            done[world] = spawn_workers(world, f"{W}x{H}", tmp,
                                        device="cpu",
                                        checks=",".join(CHECKS),
                                        timeout=300, threads=1)
        except Exception as e:          # reported below
            done[world] = e
    threads = [threading.Thread(target=run, args=(world,))
               for world in WORLDS]
    for t in threads:
        t.start()
    ref = {world: worker.reference(CHECKS, W, H, "cpu",
                                   os.path.join(tmp, f"r{world}.png"),
                                   world=world)
           for world in WORLDS}
    for t in threads:
        t.join(timeout=400)
        assert not t.is_alive(), "the ranks did not finish"
    out = {}
    for world in WORLDS:
        if isinstance(done[world], Exception):
            raise done[world]
        out[world] = (*done[world], ref[world])
    return out


@pytest.fixture(params=WORLDS, ids=[f"world{w}" for w in WORLDS])
def ranks(request, all_ranks):
    """(world, the ranks' npz dicts, their logs, the reference)."""
    return (request.param, *all_ranks[request.param])


def test_blocks_tile_the_frame(ranks):
    world, res, logs, _ = ranks
    bounds = [(int(r["lo"]), int(r["hi"])) for r in res]
    assert bounds[0][0] == 0 and bounds[-1][1] == W * H
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    for r, log in zip(res, logs):
        assert int(r["nproc"]) == world and int(r["ndev"]) == world
        assert float(r["max_err"]) == 0.0, log
        assert "OK" in log and "gloo" in log


def test_sharded_render_equals_single_process(ranks):
    world, res, _, ref = ranks
    for r in res:
        for key in ("rad_sum", "s1", "s2", "count", "done"):
            np.testing.assert_array_equal(r[f"render_{key}"],
                                          ref[f"render_{key}"], err_msg=key)
        # a rank's calls: 2 passes of a camera trace, 3 shadow queries and
        # 2 bounces (-m 3, one light sample)
        assert int(r["render_calls"]) == 12
    assert ref["render_rad_sum"].sum() > 0
    assert int(ref["render_count"].min()) == 2


def test_sharded_step_within_the_order_free_bound(ranks):
    world, res, _, ref = ranks
    for rank, r in enumerate(res):
        assert r["step_equal"].tolist() == [True] * worker.STEP_CALLS, rank
        for leaf in LEAVES:
            np.testing.assert_array_equal(r[f"step_{leaf}"],
                                          res[0][f"step_{leaf}"])
            shares = ref[f"step_shares_{leaf}"]
            assert shares.shape[0] == world
            assert worker.off_bound(r[f"step_{leaf}"], shares) <= 1.0, leaf
    assert np.abs(ref["step_bh_radius"]).max() > 0
    assert np.abs(ref["step_reflectance"]).max() > 0


def test_per_trace_forward_equals_eager_and_unsharded(ranks):
    import json
    world, res, _, _ = ranks
    for rank, r in enumerate(res):
        for kind in ("flat", "curved"):
            row = json.loads(str(r[f"mesh_{kind}"]))
            assert row["world"] == world and row["lanes"] == W * W
            assert row["equal_eager"] and row["equal_unsharded"], (rank, kind)
            assert not row["faults"] and not row["compiled"]
            assert row["collectives"]["calls"] == 8


def test_four_rank_step_matches_jax_sharded_value_and_grad(tmp_path):
    """`jax_parity` on four ranks and a 4-device mesh (96 lanes a rank)."""
    jax_parity(tmp_path, 4, 1)
