"""Device milliseconds a gradient step in the adjoints of the BSDF
gathers: the program's span "step.gather_adjoint" (one a gather, inside
"step.backward"), over the steps of the traced stretch
(`rrt_tpu_torch.utils.stats`). None where no such span was collected: a
program whose gathers take autograd's own adjoint."""


def read(view):
    try:
        from rrt_tpu_torch.utils.stats import COLLECTED
    except ImportError:        # a program without spans
        return None
    if not COLLECTED.device.count("step.gather_adjoint"):
        return None
    s = COLLECTED.per_unit("step", under="step.gather_adjoint")
    return None if s is None else 1e3 * s
