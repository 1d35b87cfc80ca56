"""The control's and the planted faults' readings that the limits of
`correct` are set from:

    python3 -m cardbench.calibrate --workload <cell> --seeds 1 2 3

The sound readings are the runs' own: every `python3 -m cardbench.run`
prints the numbers it compared on standard error. This adds, for each
seed, in one process on the card and at the cell's size, the control
against the reference: the reference itself with its state stored in
bfloat16 (`ref.precision.lowered`), the nearest precision below the
float32 that the configuration states, on the frames and pixels that the
run's check draws (the warm frames' successors) or on the run's
compared steps. For the gradient step also the planted fault that leaves
half of the batch out (the reference's loss over the first half). Both
go through the drivers' own reference code (`drivers/frames.py`
`frame_reference` and `checked_pixels`, `drivers/grad.py`
`reference_steps` and `step_numbers`). One JSON line per seed and
reading on stdout, and the smallest reading of each number last.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from cardbench import compare, harness, inputs


def _frames(cell, seeds, dev):
    from cardbench.ref.precision import lowered
    conf, mix = cell["config"], cell["traffic"]
    frames = harness.load_module("drivers", "frames")
    fr = frames.frame_reference(conf, dev)
    idx = range(mix["warm_frames"], mix["warm_frames"] + mix["check_frames"])
    for seed in seeds:
        pix = torch.from_numpy(frames.checked_pixels(conf, mix, seed))
        t0 = time.perf_counter()
        ref = [fr.pixels(inputs.frame_seed(seed, i), pix).double().cpu()
               .numpy() for i in idx]
        t_ref = time.perf_counter() - t0
        with lowered():
            low = [fr.pixels(inputs.frame_seed(seed, i), pix).double().cpu()
                   .numpy() for i in idx]
        yield seed, "control", compare.frame_numbers(low, ref), t_ref


def _steps(cell, seeds, dev):
    from cardbench.ref.precision import lowered
    conf, mix = cell["config"], cell["traffic"]
    grad = harness.load_module("drivers", "grad")
    for seed in seeds:
        t0 = time.perf_counter()
        ref = grad.reference_steps(conf, mix, seed, dev)
        t_ref = time.perf_counter() - t0
        print(json.dumps(dict(seed=seed, kept=compare.moving_leaves(ref[2]))),
              flush=True)
        with lowered():
            low = grad.reference_steps(conf, mix, seed, dev)
        half = grad.reference_steps(conf, mix, seed, dev, half=True)
        for what, run in (("control", low), ("fault_half_batch", half)):
            yield seed, what, grad.step_numbers(run[:2], ref, mix["lr"]), \
                t_ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cardbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.set_caches()
    harness.require_cards(1)
    dev = torch.device("cuda", 0)
    cell = harness.cell(args.workload)
    gen = (_frames if cell["traffic"]["driver"] == "frames" else _steps)(
        cell, args.seeds, dev)
    least = {}
    for seed, what, numbers, t_ref in gen:
        print(json.dumps(dict(seed=seed, reading=what, numbers=numbers,
                              reference_s=t_ref)), flush=True)
        for k, v in numbers.items():
            least[what, k] = min(least.get((what, k), v), v)
    print(json.dumps({f"{w}:{k}": v for (w, k), v in sorted(least.items())}))
    harness.check_modules("at the end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
