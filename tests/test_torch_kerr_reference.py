"""The port's Kerr-disk render against the benchmark's plain reference
(`cardbench/ref/kerr.py`), on the CPU at a small size: 16×16, 2 spp, 150
steps, by which every lane has settled (captured, escaped or on the
disk) at config 5's camera.

The tolerance is the `kerr-disk.passes` cell's limits
(`cardbench/limits/kerr-disk.passes.json`, read by
`cardbench.compare.judge`): the reference builds ℋ from the whole
inverse metric and takes its own op order, so its float32 rounding
differs from the program's, and a lane near the photon ring or the
disk's edge could part from the program's. The same limits must fail
the reference stored in bfloat16 (the cell's control) and the planted
faults: the hole without spin, Euler steps in place of RK4, the disk
without Doppler beaming. The program's spans and live-lane counters
are held to the reference's own count of live steps. No JAX.
"""
import dataclasses
import json

import pytest
import torch

from cardbench import compare, harness
from cardbench.ref import kerr as rkerr
from cardbench.ref.precision import lowered
from rrt_tpu_torch.convert import disk_from_arrays, kerr_params_from_arrays
from rrt_tpu_torch.render import kerr_scene as K
from rrt_tpu_torch.utils import stats

CELL = "kerr-disk.passes"
SIZE, SPP, STEPS, SEED = 16, 2, 150, 4294967311


@pytest.fixture(scope="module")
def limits():
    return json.loads((harness.HERE / "limits" / f"{CELL}.json").read_text())


@pytest.fixture(scope="module")
def settings():
    conf = json.loads((harness.CHECKOUT / "cardbench" / "configs"
                       / "kerr-disk.json").read_text())
    return rkerr.settings(dict(conf, width=SIZE, height=SIZE, spp=SPP,
                               steps=STEPS))


@pytest.fixture(scope="module")
def reference(settings):
    """The reference's (HDR (m, 3), live steps (spp, m)) of every pixel,
    memoised by its settings and step."""
    memo = {}
    pix = torch.arange(SIZE * SIZE)

    def get(spin=None, step=rkerr.rk4, **kw):
        k = dataclasses.replace(settings, **kw, spin=(
            settings.spin if spin is None else spin))
        if (k, step) not in memo:
            hdr, live = rkerr.pixels(k, [SEED], pix, "cpu", step)
            memo[k, step] = hdr[0], live[0]
        return memo[k, step]
    return get


def _port(k: rkerr.KerrDisk):
    """The program's image (m, 3) and what `stats.collect()` held after
    its one call."""
    bh = kerr_params_from_arrays((0.0, 0.0, 0.0), k.mass, k.spin, "cpu")
    disk = disk_from_arrays(k.r_in, k.r_out, k.emission, k.q, k.beaming,
                            "cpu")
    stats.reset()
    try:
        with stats.collect() as got:
            img = K.render_image(SIZE, SIZE, bh, disk, eye=k.eye,
                                 target=k.target, fov_deg=k.fov_deg,
                                 spp=SPP, seed=SEED, n_steps=STEPS,
                                 device="cpu", graphs=False)
        return img.reshape(-1, 3), dict(
            counters=dict(got.counters),
            march=got.device.count("kerr.march"),
            frames=got.host.count("kerr.frame"),
            march_ms=got.per_unit("kerr.frame", names=["kerr.march"]))
    finally:
        stats.reset()


@pytest.mark.parametrize("spin", [0.9, 0.0])
def test_port_equals_the_reference(settings, reference, limits, spin):
    k = dataclasses.replace(settings, spin=spin)
    img, _ = _port(k)
    ref, live = reference(spin)
    assert int(live.max()) < STEPS           # every lane settled
    numbers = compare.frame_numbers(img, ref.double().numpy())
    ok, checks = compare.judge(numbers, limits)
    assert ok, checks


@pytest.mark.parametrize("reading", ["control", "spin_0", "euler",
                                     "no_beaming"])
def test_control_and_faults_exceed_the_limits(settings, reference, limits,
                                              reading):
    """Each reading fails at least one of the cell's limits."""
    ref, _ = reference()
    if reading == "control":
        with lowered():
            got = rkerr.pixels(settings, [SEED], torch.arange(SIZE * SIZE),
                               "cpu")[0][0]
    elif reading == "spin_0":
        got = reference(0.0)[0]
    elif reading == "euler":
        got = reference(step=rkerr.euler)[0]
    else:
        got = reference(beaming=False)[0]
    numbers = compare.frame_numbers(got.double().numpy(),
                                    ref.double().numpy())
    ok, checks = compare.judge(numbers, limits)
    assert not ok, checks


def test_spans_and_live_lane_counters(settings, reference):
    """Under `stats.collect()` a call records its span "kerr.frame", one
    "kerr.march" a batch, and counts as live the lane-steps that the
    reference's march begins still marching, of every lane-step run, and
    as issued 32 × the most of them in each group of 32 consecutive lanes
    (a sample's 256 pixels are one batch)."""
    _, got = _port(settings)
    _, live = reference()
    assert got["frames"] == 1 and got["march"] == SPP
    assert got["march_ms"] > 0
    assert got["counters"] == {
        "kerr.lanes_live": float(live.sum()),
        "kerr.lanes_run": float(live.numel() * STEPS),
        "kerr.lanes_issued": float(32 * live.reshape(-1, 32).amax(1).sum())}
    for name in ("march_live_pct.kerr", "march_warp_live_pct.kerr"):
        reader = harness.load_module("metrics", name)
        assert reader.read(None) is None     # nothing collected now
