"""Device milliseconds a frame in the paths' hits and bounces: the self
time of the program's spans "vertex.bounce" (roulette, BSDF sampling,
throughput, picked-up emission) and "pass.camera_hit" (the camera
vertex), the closest-hit kernel left out, over the frames of the traced
stretch (`rrt_tpu_torch.utils.stats`)."""


def read(view):
    try:
        from rrt_tpu_torch.utils.stats import COLLECTED
    except ImportError:        # a program without spans
        return None
    s = COLLECTED.per_unit("render.frame",
                           names=["vertex.bounce", "pass.camera_hit"])
    return None if s is None else 1e3 * s
