"""Device milliseconds a frame in the pass's camera rays: the self time of
the program's span "pass.camera" (the pass key, the jitter draws, the
camera rays, the lane masks), over the frames of the traced stretch
(`rrt_tpu_torch.utils.stats`)."""


def read(view):
    try:
        from rrt_tpu_torch.utils.stats import COLLECTED
    except ImportError:        # a program without spans
        return None
    s = COLLECTED.per_unit("render.frame", names=["pass.camera"])
    return None if s is None else 1e3 * s
