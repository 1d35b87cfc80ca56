"""The least work of the trace kernel in a frame, and its bound on the card.

The work is what each lane's answer needs, whatever the traversal: a
lane marches its chords up to the one that holds its answer (its closest
hit, its first occluder, the hole, or a radial death), or every chord of
the 2π march when it meets nothing; each chord costs CHORD_OPS, a hit one
primitive test more. Each lane reads and writes LANE_BYTES. The chords
come from the reference's own answers (`ref.traverse.recording`) for the
sampled pixels' lanes of the checked frames, scaled to the frame's lanes:
every trace of a frame holds the same number of lanes for each pixel, so
the scale is the frame's pixels over the sample's.

The bound is the larger of the operations at the card's float32 peak and
the bytes at its memory bandwidth. The count is a lower bound on the
work, so the share stays far under 100%.
"""
from __future__ import annotations

from cardbench.harness import PEAK_BYTES_PER_S

# the march of one chord: the geodesic step, the absorption test and the
# chord's slab against the scene box, in float32 operations (PERF.md)
CHORD_OPS = 150
# one Möller–Trumbore triangle test
HIT_OPS = 47
# a lane's ray (origin, direction, range) in and its answer out
LANE_BYTES = 78


def trace_work(frames_rows, scale: float):
    """The mean per frame of {ops, bytes, lanes} over the checked frames'
    recorded traces (`frames_rows`: per frame, its (lanes, chords, hits)
    rows), scaled by `scale`; None when nothing was recorded."""
    if not frames_rows or not any(frames_rows):
        return None
    k = len(frames_rows)
    ops = sum(CHORD_OPS * c + HIT_OPS * h
              for rows in frames_rows for _, c, h in rows)
    lanes = sum(n for rows in frames_rows for n, _, _ in rows)
    return dict(ops=ops * scale / k, bytes=LANE_BYTES * lanes * scale / k,
                lanes=lanes * scale / k)


def bound_seconds(work: dict, peak_flops: float) -> float:
    return max(work["ops"] / peak_flops, work["bytes"] / PEAK_BYTES_PER_S)
