"""Seconds of set-up in the first, eager, call of every compiled pass or
step: the program's host spans "setup.eager", each ending in a device
sync, read in a run whose traced stretch was collected
(`rrt_tpu_torch.utils.stats`)."""


def read(view):
    try:
        from rrt_tpu_torch.utils.stats import COLLECTED, HOST
    except ImportError:        # a program without spans
        return None
    return HOST.seconds("setup.eager") if COLLECTED else None
