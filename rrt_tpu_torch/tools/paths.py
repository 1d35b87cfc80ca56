"""Path records: the discrete outcome of every tracer query of an estimate,
to find the lanes where two runs of it part (the port on two devices, or
the port and the JAX package on the same uniforms).

A curved estimate's discrete outcomes (a shadow ray occluded or not, the
material a ray hits) can differ between two runs whose arithmetic rounds
differently: a ray that orbits the hole near its photon sphere, or
grazes an edge, ends on one side in one run and on the other in the
other, and its lane's radiance moves by up to a light's radiance.

* `Recorder` stands in for an integrator module's `tracer` (the port's
  `render.integrator` or the JAX package's) and keeps every query's
  function, arguments and discrete result in call order.
* `parted_lanes` compares two records query by query and returns, for
  each query, the lanes whose outcome differs there and at no earlier
  query.
* `undecided` traces each such query's rays again with each run's
  tracer, in a batch of those lanes alone: the run's own rays, the
  other run's, and its own moved by up to 1e-5 (the scale at which the
  two packages' first hit points differ). A lane is undecided when
  either run's answer changes there: its outcome is then not decided at
  float32 (it turns on the rounding of the ray, or on the batch it is
  traced in), and is no fault of either run.

`python3 chip_smoke.py` holds the card's radius step to the CPU's with
this rule; the CPU tests hold the port to the JAX package with it.
"""
from __future__ import annotations

import numpy as np

QUERIES = ("trace", "trace_diff", "occluded")
RAY_FIELDS = ("o", "d", "min_t", "max_t")


def to_numpy(x) -> np.ndarray:
    """A torch tensor (any device, autograd or not) or an array, as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _discrete(name, out):
    """(occluded,) of a shadow query, (hit, material id) of a closest hit."""
    r = out[0] if isinstance(out, tuple) else out
    if name == "occluded":
        return (to_numpy(r),)
    return (to_numpy(r.hit), to_numpy(r.bsdf_id))


class Recorder:
    """`with Recorder(module, make_rays) as rec:` runs estimates of
    `module` (whose `tracer` it stands in for) and keeps, in `rec.calls`,
    a (name, scene, hole, rays, keyword arguments, discrete result) row
    for each trace query. `make_rays(**arrays)` makes the module's `Rays`
    from numpy arrays (for `undecided`)."""

    def __init__(self, module, make_rays):
        self.module, self.make_rays = module, make_rays
        self.tracer = module.tracer
        self.calls = []

    def __enter__(self):
        self.module.tracer = self
        return self

    def __exit__(self, *exc):
        self.module.tracer = self.tracer

    def __getattr__(self, name):
        fn = getattr(self.tracer, name)
        if name not in QUERIES:
            return fn

        def query(scene, bh, rays, **kw):
            out = fn(scene, bh, rays, **kw)
            self.calls.append((name, scene, bh, rays, kw,
                               _discrete(name, out)))
            return out
        return query

    def rays(self, q: int, flat: np.ndarray) -> dict:
        """The rays of query q at the flat positions of its (..., n)
        lanes, as numpy arrays."""
        rays = self.calls[q][3]
        out = {}
        for k in RAY_FIELDS:
            v = to_numpy(getattr(rays, k))
            out[k] = v.reshape((-1, 3) if k in ("o", "d") else (-1,))[flat]
        return out

    def answer(self, q: int, rays: dict, pad: int = 64) -> np.ndarray:
        """Query q's function on `rays` (outside autograd), their batch
        padded with copies of its first ray to a multiple of `pad` lanes
        (so that a compiled query is reused): its discrete result
        stacked, (fields, lanes)."""
        name, scene, bh, _, kw, _ = self.calls[q]
        m = len(rays["min_t"])
        fill = -m % pad
        rays = {k: np.concatenate([v, np.repeat(v[:1], fill, 0)])
                for k, v in rays.items()}
        fn = getattr(self.tracer, name)
        try:
            import torch
            guard = torch.no_grad()
        except ImportError:             # pragma: no cover
            import contextlib
            guard = contextlib.nullcontext()
        with guard:
            out = fn(scene, bh, self.make_rays(**rays), **kw)
        return np.stack(_discrete(name, out))[:, :m]


def parted_lanes(a: Recorder, b: Recorder):
    """[(query index, flat positions, lanes)] of the queries at which
    lanes' discrete outcomes first differ between the two records."""
    names = ([c[0] for c in a.calls], [c[0] for c in b.calls])
    if names[0] != names[1]:
        raise ValueError(f"the records' queries differ: {names}")
    seen, rows = None, []
    for q, (ca, cb) in enumerate(zip(a.calls, b.calls)):
        d = np.zeros(ca[5][0].shape, bool)
        for x, y in zip(ca[5], cb[5]):
            d |= x != y
        n = d.shape[-1]
        if seen is None:
            seen = np.zeros(n, bool)
        flat = np.nonzero(d.reshape(-1))[0]
        lanes = flat % n
        new = ~seen[lanes]
        if new.any():
            rows.append((q, flat[new], lanes[new]))
        seen[lanes] = True
    return rows


def _moved(rays: dict, n_moves: int, eps: float, seed: int) -> dict:
    """`n_moves` copies of each ray, origin and direction moved by up to
    `eps` in each coordinate (the direction renormalised), after the rays
    themselves: (1 + n_moves) × lanes."""
    rng = np.random.default_rng(seed)
    m = len(rays["min_t"])
    o = rays["o"][None] + rng.uniform(-eps, eps, (n_moves, m, 3))
    d = rays["d"][None] + rng.uniform(-eps, eps, (n_moves, m, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    moved = {"o": o, "d": d}
    for k in ("min_t", "max_t"):
        moved[k] = np.broadcast_to(rays[k], (n_moves, m))
    return {k: np.concatenate([rays[k], moved[k].reshape(
        (-1,) + rays[k].shape[1:]).astype(rays[k].dtype)])
        for k in RAY_FIELDS}


def undecided(a: Recorder, b: Recorder, q: int, flat: np.ndarray,
              eps: float = 1e-5, n_moves: int = 8, seed: int = 0):
    """(undecided, ray difference) of query q at the flat positions: a
    bool per position, True where either run's answer in the estimate
    changes when its tracer takes the lanes alone, the other run's rays,
    or its own moved by up to `eps` (`n_moves` seeded moves: the scale at
    which the two packages' first hit points differ); and the largest
    absolute difference between the two runs' rays there."""
    ra, rb = a.rays(q, flat), b.rays(q, flat)
    with np.errstate(invalid="ignore"):       # inf − inf where both agree
        diff = max(float(np.where(ra[k] == rb[k], 0.0,
                                  np.abs(ra[k] - rb[k])).max())
                   for k in RAY_FIELDS)
    m = len(flat)
    out = np.zeros(m, bool)
    for rec, own, other in ((a, ra, rb), (b, rb, ra)):
        kept = np.stack([x.reshape(-1)[flat] for x in rec.calls[q][5]])
        batch = _moved(own, n_moves, eps, seed)
        batch = {k: np.concatenate([batch[k], other[k]]) for k in RAY_FIELDS}
        got = rec.answer(q, batch).reshape(len(kept), -1, m)
        out |= (got != kept[:, None]).any((0, 1))
    return out, diff
