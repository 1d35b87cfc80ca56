"""The share of the integrator's lanes that carry a live path: the live
lanes entering every vertex of every pass over the lanes those vertices
ran, from the program's counters "lanes.live" and "lanes.run" of the
frames of the traced stretch (`rrt_tpu_torch.utils.stats`)."""


def read(view):
    try:
        from rrt_tpu_torch.utils.stats import COLLECTED
    except ImportError:        # a program without counters
        return None
    run = COLLECTED.counters.get("lanes.run")
    if not run:
        return None
    return 100.0 * COLLECTED.counters.get("lanes.live", 0.0) / run
