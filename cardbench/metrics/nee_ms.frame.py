"""Device milliseconds a frame in next-event estimation: the self time of
the program's span "vertex.nee" at every vertex (light samples, shadow
rays, BSDF evaluations, the radiance update; the any-hit kernel left
out), over the frames of the traced stretch
(`rrt_tpu_torch.utils.stats`)."""


def read(view):
    try:
        from rrt_tpu_torch.utils.stats import COLLECTED
    except ImportError:        # a program without spans
        return None
    s = COLLECTED.per_unit("render.frame", names=["vertex.nee"])
    return None if s is None else 1e3 * s
