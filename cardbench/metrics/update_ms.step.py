"""Device milliseconds a gradient step in the SGD update and the writes
of its outputs: the program's span "step.update", over the steps of the
traced stretch (`rrt_tpu_torch.utils.stats`)."""


def read(view):
    try:
        from rrt_tpu_torch.utils.stats import COLLECTED
    except ImportError:        # a program without spans
        return None
    s = COLLECTED.per_unit("step", under="step.update")
    return None if s is None else 1e3 * s
