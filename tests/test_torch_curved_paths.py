"""The curved render at the main path's settings (-l 4, -m 5) against
the JAX package's, path by path, where float32 decides each path's
trace outcomes: the rule and the helpers of
tests/test_torch_curved_parity.py, in a file of its own so that the two
long CPU renders run on separate test workers."""
from rrt_tpu_torch.utils.config import Illum, RenderConfig
from test_torch_curved_parity import hold_decided, recorded_paths


def test_curved_main_path_settings_match_jax_where_float32_decides(
        monkeypatch):
    """The main path's -l 4 -m 5 at 1 spp (a path a pixel), where only
    98.1% of the whole image's pixels hold rtol 1e-2 and the means are
    5e-4 apart (the curved rule's pixel share, not met). Found: 16 of
    576 paths part (shadow rays at the first, second, fourth and fifth
    vertices, the second, third and fourth bounces), all undecided; the other 97.6% of the
    pixels hold the flat rule at 99.82%, their means 2e-5 apart."""
    cfg = RenderConfig(width=24, height=24, ns_aa=1, ns_area_light=4,
                       max_ray_depth=5, illum=Illum.FULL, seed=3,
                       max_dispatch_seconds=0)
    jL, L, lanes, und, base = recorded_paths(cfg, monkeypatch)
    kept, close = hold_decided(jL, L, lanes, und, base, 1, 24 * 24)
    assert kept >= 0.9, kept
