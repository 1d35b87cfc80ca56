"""Curved closest-hit traces of coherent and incoherent rays (the port of
tools/kbench.py):

    python -m rrt_tpu_torch.tools.kbench [n_rays_log2] [backend] [accel]
        [--scene cbox_dense|PATH.dae] [--device cuda|cpu]

backend: auto (the device's traversal: the trace kernel on a card, its
plain PyTorch version on the CPU; default), kernel or plain. accel is
accepted and echoed: the JAX package's XLA traversal has three
strategies (shortlist, cluster, brute) that compute the same hits, and
the port has one traversal. The scene is `cbox_dense()`, the BVH-scale
box standing in for CBbunny (tools/kbench.py:22), or a .dae.

Three ray sets go through the trace, all under the default hole:
- coherent: the camera's rays, one through the centre of each pixel of a
  square frame of about 2^n_rays_log2 pixels;
- incoherent: the same origins with their directions shuffled by a
  seeded `torch.randperm` (neighbouring lanes no longer alike);
- bounce: one diffuse bounce from each coherent ray's hit, the traffic
  the renderer's bounce launches carry (scattered origins, directions
  uniform over the normal's hemisphere, seeded).
For each it prints the rate of curved rays a second (on a card five timed
traces after 0.1 s of untimed ones, so that its clocks are up; on the
CPU three after the first; host clock ending in a device sync), the hits, the
first trace's seconds and the primitive and box tests a ray that the
kernel's counters measured. It then times the set in the order of the
JAX package's lane sort (`_should_sort`'s key, rrt_tpu/ops/
trace_kernel.py:1922-1957: the direction's sign octant over a 21-bit
Morton code of the origin): the sorted trace, and the sort's own cost
(the key, `torch.argsort`, the gathers of the rays and the gathers that
put the Hit back in lane order). The port has no lane sort; these
numbers say whether one would pay.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

SEED = 0


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rrt_tpu_torch.tools.kbench")
    ap.add_argument("n_rays_log2", type=int, nargs="?", default=18)
    ap.add_argument("backend", nargs="?", default="auto",
                    choices=("auto", "kernel", "plain"))
    ap.add_argument("accel", nargs="?", default="shortlist")
    ap.add_argument("--scene", default="cbox_dense")
    ap.add_argument("--device", default="cuda")
    return ap


def _morton7(v):
    """The low 7 bits of v spread three apart (a 21-bit Morton code)."""
    v = v & 0x7F
    v = (v | (v << 8)) & 0x0700F
    v = (v | (v << 4)) & 0x430C3
    return (v | (v << 2)) & 0x49249


def sort_key(sc, rays):
    """The JAX package's default lane-sort key (db=1): the direction's
    sign octant, then the origin's Morton code in the triangles' box."""
    v = torch.cat([sc.tri_v0, sc.tri_v1, sc.tri_v2])
    lo, hi = v.min(0).values, v.max(0).values
    ext = torch.where(hi > lo, hi - lo, 1.0)
    q = torch.clamp((rays.o - lo) / ext * 127.0, 0.0, 127.0).to(torch.int32)
    m = (_morton7(q[:, 0]) << 2) | (_morton7(q[:, 1]) << 1) \
        | _morton7(q[:, 2])
    qd = torch.clamp(rays.d + 1.0, 0.0, 1.0).to(torch.int32)
    return (((qd[:, 0] << 2) | (qd[:, 1] << 1) | qd[:, 2]) << 21) | m


def bounce_rays(sc, bh, tab, cam_rays, eps: float):
    """One diffuse bounce from every hit of `cam_rays`: the origin just
    off the surface, the direction uniform over the hemisphere of the
    normal that faces the incoming path (seeded)."""
    from rrt_tpu_torch.geometry.trace import trace
    from rrt_tpu_torch.types import Rays
    h = trace(sc, bh, cam_rays, tables=tab)
    p, nrm, w_out = h.p[h.hit], h.n[h.hit], h.w_out[h.hit]
    nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
    nrm = torch.where((nrm * w_out).sum(-1, keepdim=True) < 0, -nrm, nrm)
    u = torch.randn(p.shape, generator=torch.Generator().manual_seed(SEED))
    u = u.to(p.device) / torch.linalg.norm(u, dim=-1, keepdim=True).to(
        p.device)
    u = torch.where((u * nrm).sum(-1, keepdim=True) < 0, -u, u)
    n = p.shape[0]
    return Rays(o=p + eps * nrm, d=u, min_t=torch.zeros(n, device=p.device),
                max_t=torch.full((n,), math.inf, device=p.device))


def run(n_log2: int, backend: str = "auto", accel: str = "shortlist",
        scene: str = "cbox_dense", device="cuda"):
    """Every ray set traced; returns (the scene line, a dict per set)."""
    from rrt_tpu_torch.convert import black_hole_from_arrays
    from rrt_tpu_torch.geometry.trace import trace
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.tools import trace_modes
    from rrt_tpu_torch.tools.run_config import load
    from rrt_tpu_torch.types import Hit, Rays
    from rrt_tpu_torch.utils.config import RenderConfig
    device = torch.device(device)
    sc, cam = load(scene, device, 512, 512)
    bh = black_hole_from_arrays((0.0, 1.0, 0.0), 0.1, 0.1, device)
    tab = tk.build_tables(sc, bh)
    head = (f"scene={scene.rsplit('/', 1)[-1]} tris={sc.n_tris} "
            f"clusters={sc.cluster_lo.shape[0]} backend={backend} "
            f"accel={accel} device={device}")
    w = int(math.isqrt(1 << n_log2))
    n = w * w
    i = torch.arange(n, device=device)
    xy = torch.stack([(i % w + 0.5) / w, (i // w + 0.5) / w], -1)
    rays = cam.generate_rays(xy.to(torch.float32))
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(SEED))
    shuffled = Rays(o=rays.o, d=rays.d[perm.to(device)], min_t=rays.min_t,
                    max_t=rays.max_t)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    reps, warm_s = (5, 0.1) if device.type == "cuda" else (3, 0.0)

    def timed(fn):
        """(the first call's seconds, ms a call over reps calls after
        warm_s of untimed ones, the last result, the number of calls)."""
        t0 = time.perf_counter()
        out = fn()
        sync()
        first = time.perf_counter() - t0
        calls = 1
        while time.perf_counter() - t0 < first + warm_s:
            out = fn()
            sync()
            calls += 1
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        sync()
        return (first, (time.perf_counter() - t0) / reps * 1e3, out,
                calls + reps)

    def sort(r):
        order = torch.argsort(sort_key(sc, r))
        return order, Rays(o=r.o[order], d=r.d[order],
                           min_t=r.min_t[order], max_t=r.max_t[order])

    def unsort(order, h):
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        return Hit(**{k: v[inv] for k, v in vars(h).items()})

    rows = []
    with trace_modes.backend(backend, device):
        bounce = bounce_rays(sc, bh, tab, rays, RenderConfig().ray_eps)
        for name, r in (("coherent", rays), ("incoherent", shuffled),
                        ("bounce", bounce)):
            m = r.min_t.shape[0]
            tk.LAUNCHES = 0
            first, ms, (h, st), calls = timed(lambda: trace(
                sc, bh, r, return_stats=True, tables=tab))
            launches = tk.LAUNCHES
            rs = sort(r)[1]
            _, sorted_ms, (hs, sts), _ = timed(lambda: trace(
                sc, bh, rs, return_stats=True, tables=tab))
            _, sort_ms, back, _ = timed(lambda: unsort(sort(r)[0], hs))
            ni, nc = (float(v) for v in st)
            rows.append(dict(rays=name, n=m, ms=ms,
                             m_rays_per_s=m / ms / 1e3,
                             hits=int(h.hit.sum()), first_call_s=first,
                             prim_tests_per_ray=ni / m,
                             bbox_tests_per_ray=nc / m,
                             launches=launches, trace_calls=calls,
                             sorted_ms=sorted_ms, sort_ms=sort_ms,
                             sorted_prim_tests_per_ray=float(sts[0]) / m,
                             sorted_equal=bool(
                                 torch.equal(back.hit, h.hit)
                                 and torch.equal(back.prim_id, h.prim_id)
                                 and torch.equal(back.t, h.t))))
    return head, rows


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("kbench: CUDA is not available; pass --device cpu to trace "
              "on the CPU", file=sys.stderr)
        return 2
    head, rows = run(args.n_rays_log2, args.backend, args.accel, args.scene,
                     args.device)
    print(head)
    for r in rows:
        print(f"{r['rays']}: {r['n']} rays in {r['ms']:.3f} ms -> "
              f"{r['m_rays_per_s']:.4g} M curved rays/s  (hits={r['hits']}, "
              f"first-call {r['first_call_s']:.3f}s)")
        print(f"  measured: {r['prim_tests_per_ray']:.1f} prim tests/ray, "
              f"{r['bbox_tests_per_ray']:.1f} bbox tests/ray (reference: "
              f"112 tests/ray)")
        print(f"  sorted: {r['sorted_ms']:.3f} ms a trace + {r['sort_ms']:.3f}"
              f" ms to sort and unsort ({r['sorted_prim_tests_per_ray']:.1f}"
              f" prim tests/ray; "
              f"{'equal' if r['sorted_equal'] else 'NOT equal'} after "
              f"unsorting)")
    print(json.dumps({"kbench": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
