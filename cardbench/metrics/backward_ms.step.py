"""Device milliseconds a gradient step in `torch.autograd.grad`: the
program's span "step.backward", over the steps of the traced stretch
(`rrt_tpu_torch.utils.stats`)."""


def read(view):
    try:
        from rrt_tpu_torch.utils.stats import COLLECTED
    except ImportError:        # a program without spans
        return None
    s = COLLECTED.per_unit("step", under="step.backward")
    return None if s is None else 1e3 * s
