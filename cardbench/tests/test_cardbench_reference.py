"""The reference against the program, and `correct` against broken timed
paths, at a tiny size on the CPU.

Each case drives a whole run of a cell (`run.execute`) past the look
for a card: set-up, the window, the trace, the reference and the
comparison. Sound runs must read the program equal to the reference.
The control, the reference with its state stored in bfloat16, must fail
the cell's limits, and so must a run whose timed path is broken
underneath: half of the batch left out (the mean over the rest), the
answer altered where it is produced, a gradient step that returns its
state unchanged, and the exchange between ranks left out.

    python -m pytest cardbench/tests -q
"""
from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from cardbench import compare, harness, inputs, run

SEED = 4294967311


def _tiny(name: str, world: int = 1) -> dict:
    cell = copy.deepcopy(harness.cell(name))
    cell["config"].update(width=16, height=16, spp=2, area_light_samples=1,
                          max_ray_depth=3)
    mesh = cell["config"]["scene"].get("mesh")
    if mesh:
        mesh.update(stacks=12, slices=12)
    cell["traffic"].update(check_lanes=128, trace_seconds=0.05,
                           trace_max_frames=1, trace_steps=1)
    cell["chips"] = world
    if "ranks" in cell["traffic"]:
        cell["traffic"]["ranks"] = world
    return cell


def _limits(name: str) -> dict:
    return json.loads((harness.HERE / "limits" / f"{name}.json").read_text())


def _execute(name, capsys, trace=0, world=1, monkeypatch=None):
    torch.set_num_threads(2)
    cell, limits = _tiny(name, world), _limits(name)
    if world > 1:
        monkeypatch.setenv(run.TEST_CELL, json.dumps(dict(cell=cell,
                                                          limits=limits)))
        monkeypatch.setenv("OMP_NUM_THREADS", "2")
    args = run.parse(["--workload", name, "--seed", str(SEED), "--seconds",
                      "0.5", "--trace", str(trace)])
    assert run.execute(args, torch.device("cpu"), cell, limits) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["spheres-hole.frames", "bunny-gi.frames"])
def test_frames_equal_the_reference(name, capsys):
    out = _execute(name, capsys)
    assert out["correct"] and out["attempted"] >= 1
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    assert set(out["metrics"]) == {"samples_per_s", "setup_s"} | (
        {"frame_p95_s"} if name == "spheres-hole.frames" else set())


def test_steps_equal_the_reference(capsys):
    out = _execute("spheres-hole.grad", capsys, trace=1)
    assert out["correct"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    assert out["device"]["window_s"] > 0


def test_the_control_fails_the_frame_limits():
    from cardbench.ref.precision import lowered
    cell = _tiny("spheres-hole.frames")
    conf, mix = cell["config"], cell["traffic"]
    frames = harness.load_module("drivers", "frames")
    fr = frames.frame_reference(conf, "cpu")
    pix = torch.from_numpy(frames.checked_pixels(conf, mix, SEED))
    ref = fr.pixels(inputs.frame_seed(SEED, 2), pix).double().numpy()
    with lowered():
        low = fr.pixels(inputs.frame_seed(SEED, 2), pix).double().numpy()
    ok, _ = compare.judge(compare.frame_numbers(low, ref),
                          _limits("spheres-hole.frames"))
    assert not ok


def test_the_control_fails_the_step_limits():
    from cardbench.ref.precision import lowered
    cell = _tiny("spheres-hole.grad")
    conf, mix = cell["config"], cell["traffic"]
    grad = harness.load_module("drivers", "grad")
    ref = grad.reference_steps(conf, mix, SEED, "cpu")
    with lowered():
        low = grad.reference_steps(conf, mix, SEED, "cpu")
    ok, _ = compare.judge(grad.step_numbers(low[:2], ref, mix["lr"]),
                          _limits("spheres-hole.grad"))
    assert not ok


def _half_samples(monkeypatch):
    """The pass's second half of samples replaced by its first: half of
    the batch left out, the mean taken over the rest."""
    from rrt_tpu_torch.render.renderer import Renderer
    real = Renderer._accumulate

    def broken(self, p, L, masks):
        L = L.reshape(p.k, -1, 3).clone()
        L[p.k // 2:] = L[:p.k - p.k // 2]
        return real(self, p, L.reshape(-1, 3), masks)
    monkeypatch.setattr(Renderer, "_accumulate", broken)


def _altered(monkeypatch):
    """The radiance altered where the pass produces it."""
    from rrt_tpu_torch.render.renderer import Renderer
    real = Renderer._accumulate
    monkeypatch.setattr(Renderer, "_accumulate",
                        lambda self, p, L, masks: real(self, p, L * 1.001,
                                                       masks))


@pytest.mark.parametrize("fault", [_half_samples, _altered])
def test_broken_frames_are_not_correct(fault, monkeypatch, capsys):
    fault(monkeypatch)
    out = _execute("spheres-hole.frames", capsys)
    assert not out["correct"]


def _unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from rrt_tpu_torch.render.diff import LossAndGrad
    real = LossAndGrad.train_step

    def broken(self, params, opt_state, key, lr=1e-2, rays=None,
               target=None):
        _, opt_state, loss = real(self, params, opt_state, key, lr, rays,
                                  target)
        return params, opt_state, loss
    monkeypatch.setattr(LossAndGrad, "train_step", broken)


def _half_batch(monkeypatch):
    """The step's loss over half of the batch."""
    from rrt_tpu_torch.render import diff
    real = diff.render_radiance

    def broken(*a, **k):
        out = real(*a, **k)
        img = out[0] if isinstance(out, tuple) else out
        m = img.shape[0] // 2
        img = torch.cat([img[:m], img[:m]])
        return (img,) + tuple(out[1:]) if isinstance(out, tuple) else img
    monkeypatch.setattr(diff, "render_radiance", broken)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_broken_steps_are_not_correct(fault, monkeypatch, capsys):
    fault(monkeypatch)
    out = _execute("spheres-hole.grad", capsys)
    assert not out["correct"]


def test_sharded_frames_equal_the_reference(monkeypatch, capsys):
    """Two gloo ranks on the CPU, started by the run as on the cards."""
    out = _execute("bunny-gi.frames-4card", capsys, world=2,
                   monkeypatch=monkeypatch)
    assert out["correct"] and out["device"]["count"] == 2


def test_sharded_frames_without_the_exchange_are_not_correct(monkeypatch,
                                                             capsys):
    """Rank 0's gather delivers its own block only: the other ranks'
    radiance never arrives."""
    from rrt_tpu_torch.parallel import distributed as pdist
    from rrt_tpu_torch.parallel.sharding import shard_bounds
    real = pdist.gather_packed

    def broken(sent, mesh, n, out=None):
        whole = real(sent, mesh, n, out=out)
        lo, hi = shard_bounds(n, mesh.rank, mesh.world)
        keep = whole[lo:min(hi, n)].clone()
        whole.zero_()
        whole[lo:min(hi, n)] = keep
        return whole
    monkeypatch.setattr(pdist, "gather_packed", broken)
    out = _execute("bunny-gi.frames-4card", capsys, world=2,
                   monkeypatch=monkeypatch)
    assert not out["correct"]
    assert np.isfinite(out["checks"]["mean_gap"]["value"])
