"""The numbers that decide `correct`: what the timed path produced against
the plain reference, each held to a limit of its own (`limits/<cell>.json`,
with the readings each limit was set from in PERF.md).

Frames. The answers are pixels: a sample of each checked frame's pixels,
drawn from the run's seed, against the reference's HDR of the same
pixels. A pixel's gap is its largest channel difference over the larger
of its reference's largest channel and a floor of 1% of the sample's
mean, so that near-black pixels do not swamp it.
  * `pixels_off`: the share of sampled pixels whose gap exceeds
    PIXEL_TOL. A curved path's outcome can turn on float32 rounding (the
    trace of one lane near the photon sphere, at a triangle's edge), so a
    sound frame has a few pixels whose paths parted;
  * `mean_gap`: the relative gap of the sample's mean radiance, which a
    lost or doubled share of the samples moves.

Gradient steps. Each step's loss, the first step's gradient as the
optimizer got it (the leaves' change over the learning rate), and the
leaves' change after the compared steps, leaf by leaf: the gap between
the program's norm and the reference's, over the larger of the
reference's norm of that leaf and the median leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the gradient and change numbers.
The median is over the leaves whose reference gradient is not zero: in
a scene of diffuse surfaces the BSDF table's transmittance, eta, k,
alpha and ior enter no path, and their gradients are exactly zero.
"""
from __future__ import annotations

import numpy as np

PIXEL_TOL = 1e-4
FLOOR = 1e-2
# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of the leaf numbers
ROUNDOFF_LEAF = 1e-3


def pixel_gaps(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """(m,) gaps of the pixels of `prog` and `ref`, (m, 3) each."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    floor = FLOOR * max(float(np.mean(np.abs(ref))), 1e-30)
    den = np.maximum(np.abs(ref).max(axis=1), floor)
    return np.abs(prog - ref).max(axis=1) / den


def frame_numbers(prog, ref) -> dict:
    """The frame numbers over the checked frames' sampled pixels."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    gaps = pixel_gaps(prog.reshape(-1, 3), ref.reshape(-1, 3))
    mean_ref = float(ref.mean())
    return dict(pixels_off=float(np.mean(gaps > PIXEL_TOL)),
                mean_gap=abs(float(prog.mean()) - mean_ref)
                / max(abs(mean_ref), 1e-30),
                median_pixel_gap=float(np.median(gaps)))


def _norm(x) -> float:
    return float(np.linalg.norm(np.asarray(x, np.float64).ravel()))


def _median(norms) -> float:
    """The median of the norms that are not zero (0 when all are)."""
    moving = [n for n in norms if n > 0.0]
    return float(np.median(moving)) if moving else 0.0


def leaf_gap(prog_leaves, ref_leaves, keep) -> float:
    """The worst leaf's |‖prog‖ − ‖ref‖| / max(‖ref leaf‖, ‖median leaf‖)
    over the leaves `keep` marks."""
    pn = [_norm(x) for x in prog_leaves]
    rn = [_norm(x) for x in ref_leaves]
    med = _median(rn)
    gaps = [abs(p - r) / max(r, med, 1e-30)
            for p, r, k in zip(pn, rn, keep) if k]
    return max(gaps) if gaps else 0.0


def moving_leaves(ref_grads) -> list:
    """Which leaves the reference's first gradient moves by more than
    round-off (`ROUNDOFF_LEAF` of the median leaf's norm)."""
    rn = [_norm(g) for g in ref_grads]
    med = _median(rn)
    return [r > 0.0 and r >= ROUNDOFF_LEAF * med for r in rn]


def step_numbers(prog_losses, ref_losses, prog_grad, ref_grad,
                 prog_change, ref_change, ref_exact_grad) -> dict:
    """The step numbers: the worst step's relative loss gap, and the
    first gradient's and the change's worst leaf gaps over the leaves
    that the reference's exact first gradient moves."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog_losses, ref_losses))
    keep = moving_leaves(ref_exact_grad)
    return dict(loss_gap=float(loss_gap),
                grad_gap=leaf_gap(prog_grad, ref_grad, keep),
                change_gap=leaf_gap(prog_change, ref_change, keep))


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) of the numbers against the cell's
    limits: a number is within its limit when it is at most the limit."""
    checks = [(name, numbers[name], limits[name]) for name in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in checks)
    return bool(ok), checks
