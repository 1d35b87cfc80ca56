"""The harness's checks on the process: the whole-name check on JAX and
the JAX package, the refusal without a card, the set-up clock, the
statistics, and the per-layer readers on a made-up trace summary.

    python -m pytest cardbench/tests -q
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from cardbench import harness, roofline


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("rrt_tpu", True), ("rrt_tpu.render.renderer", True),
    ("rrt_tpu_torch", False), ("rrt_tpu_torch.render", False),
    ("jaxtyping", False), ("numpy", False)])
def test_whole_top_level_names(name, bad):
    assert (harness.forbidden_modules([name]) == [name]) is bad


def test_check_modules_raises_on_a_forbidden_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    with pytest.raises(harness.BenchError, match="jax.numpy"):
        harness.check_modules("test")


def _run(cwd, env=None):
    cmd = [sys.executable, "-m", "cardbench.run", "--workload",
           "spheres-hole.frames", "--seed", "4294967311", "--seconds", "1",
           "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    """Without a CUDA card the run fails and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(harness.CHECKOUT, env)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "no CUDA card" in out.stderr


def test_cpu_device_only_for_ranks():
    from cardbench import run
    assert run.main(["--workload", "spheres-hole.frames", "--seed", "1",
                     "--seconds", "1", "--device", "cpu"]) == 2


def test_alone_without_the_program(tmp_path):
    """In a directory with only the manifest and the benchmark's files the
    run fails and prints no result."""
    shutil.copy(harness.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_process_seconds_and_statistics():
    assert 0.0 <= harness.process_seconds() < 1e6
    assert harness.percentile([1, 2, 3, 4, 5], 50) == 3
    assert harness.percentile(list(range(101)), 95) == 95


def _summary(**kw):
    s = dict(units=2, window_s=1.0, busy_s=0.8, busy_compute_s=0.7,
             device_s=0.9, trace_s=0.3, nccl_s=0.1, host_launches=40,
             device_ops=[], idle_gaps=[])
    s.update(kw)
    return s


def test_readers_on_a_summary():
    view = dict(summaries=[_summary(), _summary(trace_s=0.4, nccl_s=0.0,
                                                busy_compute_s=0.75)],
                work=dict(ops=66.9e12 * 0.01, bytes=1.0, lanes=1.0),
                card=dict(peak_flops=66.9e12))
    read = lambda n: harness.load_module("metrics", n).read(view)
    assert read("host_launches.frame") == 20
    assert read("trace_ms.frame") == pytest.approx(200.0)
    assert read("integrator_ms.frame") == pytest.approx(250.0)
    # the slowest rank outside NCCL is the second, which waited on none
    assert read("nccl_ms.frame") == pytest.approx(0.0)
    assert read("device_idle_pct.frame") == pytest.approx(25.0)
    # 10 ms of bound over the slowest rank's 200 ms a frame
    assert read("trace_roofline_pct.frame") == pytest.approx(5.0)
    assert read("diff_ms.step") == pytest.approx(300.0)


def test_readers_find_nothing_on_the_cpu():
    view = dict(summaries=[_summary(device_s=0.0, trace_s=0.0, nccl_s=0.0,
                                    busy_s=0.0, busy_compute_s=0.0,
                                    host_launches=0)],
                work=None, card=dict(peak_flops=None))
    for m in harness.load_manifest()["per_layer"]:
        assert harness.load_module("metrics", m["name"]).read(view) is None


def test_trace_work_scales_the_sample():
    rows = [[(100, 1000, 50)], [(100, 3000, 50)]]
    w = roofline.trace_work(rows, 10.0)
    assert w["ops"] == pytest.approx(10 * (150 * 2000 + 47 * 50))
    assert w["bytes"] == pytest.approx(10 * 78 * 100)
    assert roofline.trace_work([], 1.0) is None


def test_result_line_has_checks_last():
    line = harness.result_line(True, 3, 0, {"setup_s": {"value": 1.0,
                                                      "unit": "s"}},
                               {"platform": "gpu"}, [("a", 0.0, 1.0)])
    d = json.loads(line)
    assert list(d)[-1] == "checks"
    assert d["checks"]["a"] == {"value": 0.0, "limit": 1.0}
