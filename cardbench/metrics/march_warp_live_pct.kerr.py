"""The share of the Kerr march's issued lane-slots that move a lane still
marching: the program's counters "kerr.lanes_live" (lane-steps begun
before the lane was captured, escaped or on the disk) over
"kerr.lanes_issued" (the lane-slots the march's warps stepped: 32 × the
most steps a lane of each warp of 32 lanes ran), of one collected
untraced call (`rrt_tpu_torch.utils.stats`). Low, the march's time goes
to warps waiting on their slowest lane. A program that counts no issued
slots reads nothing."""


def read(view):
    try:
        from rrt_tpu_torch.utils.stats import COLLECTED
    except ImportError:        # a program without counters
        return None
    issued = COLLECTED.counters.get("kerr.lanes_issued")
    if not issued:
        return None
    return 100.0 * COLLECTED.counters.get("kerr.lanes_live", 0.0) / issued
