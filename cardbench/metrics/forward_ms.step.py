"""Device milliseconds a gradient step in the differentiable forward and
the loss: the program's span "step.forward" and the spans inside it, the
trace kernel's left out, over the steps of the traced stretch
(`rrt_tpu_torch.utils.stats`)."""


def read(view):
    try:
        from rrt_tpu_torch.utils.stats import COLLECTED
    except ImportError:        # a program without spans
        return None
    s = COLLECTED.per_unit("step", under="step.forward",
                           skip=["trace.closest", "trace.anyhit"])
    return None if s is None else 1e3 * s
