"""The lane-sharded paths in REAL processes: two ranks of
`rrt_tpu_torch.parallel.worker` in a gloo group over localhost on the CPU
(the counterpart of tests/test_distributed.py and tests/mp_worker.py),
on a ragged 15×17 frame (255 lanes, odd), held to this process's own
single-process runs of the same work (`worker.reference`):

  * each rank's forward block equals its rows of the whole frame's
    forward (checked inside the worker) and the blocks tile the frame;
  * a curved GI render (-m 3, 2 passes) with `Renderer(sharding=)`: its
    accumulators equal the single-process render's bit for bit on both
    ranks;
  * `loss_and_grad(mesh=)`: rtol 1e-4 on the material leaves, 5e-3 on the
    hole's (test_sharding.py's test_sharded_grads_allreduce,
    test_torch_diff.py);
  * `LossAndGrad(mesh=)` over three calls (all eager on the CPU, its two
    halves around the all-reduce): every call equal to the rank's
    `loss_and_grad(mesh=)` bit for bit, and the last call equal bit for
    bit to the two ranks' shares computed and summed in this process, at
    distance 0 inside the order-free bound that three and four ranks are
    held to (which rejects a sum two bounds away);
  * a 32×32, 80-step Kerr `render_image(sharding=)` and `kerr_cli
    --sharded` equal the single-process image (rtol 1e-6, atol 1e-7, as
    tests/test_kerr.py holds it);
  * a stop after the first pass on the last rank alone ends both ranks
    there, with no hang (the workers' own timeout).
"""
import os
import threading

import numpy as np
import pytest

from rrt_tpu_torch.parallel import worker
from rrt_tpu_torch.tools.scaling_bench import spawn_workers

W, H = 15, 17
MATERIAL = ("reflectance", "transmittance", "emission", "eta", "k", "alpha",
            "ior", "light_radiance")
HOLE = ("bh_position", "bh_radius", "bh_delta_theta")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' npz dicts, their logs, the single-process
    reference), the reference computed here while the ranks run."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    done = {}

    def ranks():
        try:
            done["out"] = spawn_workers(2, f"{W}x{H}", tmp, device="cpu",
                                        checks=",".join(worker.CHECKS),
                                        timeout=300, threads=2)
        except Exception as e:          # reported by the test below
            done["error"] = e
    t = threading.Thread(target=ranks)
    t.start()
    ref = worker.reference(worker.CHECKS, W, H, "cpu",
                           os.path.join(tmp, "ref.png"))
    t.join(timeout=400)
    assert not t.is_alive(), "the ranks did not finish"
    if "error" in done:
        raise done["error"]
    res, logs = done["out"]
    return res, logs, ref


def test_blocks_tile_the_frame(runs):
    res, logs, _ = runs
    assert [int(r["lo"]) for r in res] == [0, W * H // 2]
    assert int(res[0]["hi"]) == int(res[1]["lo"])
    assert int(res[1]["hi"]) == W * H
    assert sum(r["local"].shape[0] for r in res) == W * H
    for r, log in zip(res, logs):
        assert int(r["nproc"]) == 2 and int(r["ndev"]) == 2
        assert float(r["max_err"]) == 0.0, log
        assert np.isfinite(r["local"]).all()
        assert "OK" in log and "gloo" in log


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_render_equals_single_process(runs, rank):
    res, _, ref = runs
    r = res[rank]
    for key in ("rad_sum", "s1", "s2", "count", "done"):
        np.testing.assert_array_equal(r[f"render_{key}"], ref[f"render_{key}"])
    assert r["render_rad_sum"].sum() > 0
    assert int(r["render_count"].min()) == 2
    # one rank's calls: 2 passes of a camera trace, 3 shadow queries and 2
    # bounces (-m 3, one light sample)
    assert int(r["render_calls"]) == 12


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_grads_match_single_process(runs, rank):
    res, _, ref = runs
    r = res[rank]
    np.testing.assert_allclose(r["grad_loss"], ref["grad_loss"], rtol=1e-5)
    for leaf in MATERIAL:
        np.testing.assert_allclose(r[f"grad_{leaf}"], ref[f"grad_{leaf}"],
                                   rtol=1e-4, atol=1e-9, err_msg=leaf)
    for leaf in HOLE:
        np.testing.assert_allclose(r[f"grad_{leaf}"], ref[f"grad_{leaf}"],
                                   rtol=5e-3, atol=1e-7, err_msg=leaf)
    assert np.abs(r["grad_bh_radius"]).max() > 0
    assert np.abs(r["grad_reflectance"]).max() > 0


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_step_equals_eager_and_single_process(runs, rank):
    res, _, ref = runs
    r = res[rank]
    assert r["step_equal"].tolist() == [True] * worker.STEP_CALLS
    assert not bool(r["step_graphs"])        # the CPU has no graphs
    assert all(int(c) == int(r["step_calls"][0]) > 0 for c in r["step_calls"])
    np.testing.assert_array_equal(r["step_loss"], ref["step_loss"])
    for leaf in MATERIAL + HOLE:
        np.testing.assert_array_equal(r[f"step_{leaf}"], ref[f"step_{leaf}"],
                                      err_msg=leaf)
    assert np.abs(r["step_bh_radius"]).max() > 0


def test_two_rank_step_is_exact_inside_the_order_free_bound(runs):
    """The bound that three and four ranks are held to
    (tests/test_torch_multirank.py, `worker.off_bound`) is not vacuous:
    the two ranks' step sits at distance 0 from their shares' sum, and a
    value two bounds away from it is rejected."""
    res, _, ref = runs
    for leaf in ("loss",) + MATERIAL + HOLE:
        shares = ref[f"step_shares_{leaf}"]
        assert shares.shape[0] == 2
        b, bound = worker.sum_bound(shares)
        assert (bound > 0).all() and (bound < 1e-6 * np.abs(b).max()
                                      + 1e-30).all(), leaf
        for r in res:
            assert worker.off_bound(r[f"step_{leaf}"], shares) == 0.0, leaf
        assert worker.off_bound(b + 2 * bound, shares) > 1.0, leaf


@pytest.mark.parametrize("key", ["kerr", "cli"])
def test_sharded_kerr_equals_single_process(runs, key):
    res, _, ref = runs
    for r in res:
        assert r[key].shape == (32, 32, 3)
        np.testing.assert_allclose(r[key], ref["kerr"], rtol=1e-6,
                                   atol=1e-7)
    assert ref["kerr"].max() > 0.1


def test_a_stop_on_one_rank_stops_both(runs):
    res, _, _ = runs
    assert [int(r["stop_samples"]) for r in res] == [1, 1]
    assert all(bool(r["stop_cancelled"]) for r in res)
