"""Seconds of set-up in the scene: the program's host spans "setup.scene"
(the scene file's parse, the scene's build on the device, the
traversal's tables), read in a run whose traced stretch was collected
(`rrt_tpu_torch.utils.stats`)."""


def read(view):
    try:
        from rrt_tpu_torch.utils.stats import COLLECTED, HOST
    except ImportError:        # a program without spans
        return None
    return HOST.seconds("setup.scene") if COLLECTED else None
