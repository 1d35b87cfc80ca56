"""Device milliseconds a frame in the passes' accumulation: the self time
of the program's span "pass.accumulate" (the sums into the image and the
counter adds), over the frames of the traced stretch
(`rrt_tpu_torch.utils.stats`)."""


def read(view):
    try:
        from rrt_tpu_torch.utils.stats import COLLECTED
    except ImportError:        # a program without spans
        return None
    s = COLLECTED.per_unit("render.frame", names=["pass.accumulate"])
    return None if s is None else 1e3 * s
