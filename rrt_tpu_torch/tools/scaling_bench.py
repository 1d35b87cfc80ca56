"""Lane-sharded forward throughput against the number of processes (the
port of tools/scaling_bench.py). Three modes:

  default: for each PxD of --configs (D, the devices a process drives,
    is 1: the port runs one process per device), spawn P real processes
    in one group over a localhost address, each running
    `rrt_tpu_torch.parallel.worker` on a share of one --size² frame's
    forward estimate (flat, 1 spp, -l 1, -m 2) on --device. On the CPU
    the group is gloo. On cards it is NCCL while every process has a
    card of its own, and gloo when P processes share fewer cards (NCCL
    refuses two ranks on one card). Prints each config's lanes/s (the
    frame's lanes over the slowest rank's median warm forward) and its
    ratio to 1x1. Each process gets cores / P intra-op threads. On cards
    the kernels are built once before the ranks start.

  --card (alias --tpu): the sharding layer's own cost on one card. A world
    of 1 over NCCL; the same forward (curved, 1 spp, -l 1, -m 2, --size²
    lanes) unsharded, and sharded as the renderer shards a pass: the
    rank's block of the lanes, draws windowed to it, the radiance
    gathered. Both are compiled, as the JAX tool jits both: CUDA graphs,
    the block route's gather eager after its graph. Sharded and
    unsharded should cost the same; a gap is the padding, the windowed
    draws and the gather.

  --breakdown: one JSON line of the current world (the RRT_* group, else
    a world of 1) on --device, under the JAX tool's keys
    (tools/scaling_bench.py:222-226): flat_sharded_ms (the flat forward
    with every trace sharded, `est_radiance(mesh=)`), flat_device0_ms
    (unsharded), curved_nosort_ms (the curved per-trace forward) and the
    collectives each per-trace forward makes (calls and bytes handed to
    them, flat_collectives and curved_collectives), which stand for the
    JAX tool's census of collectives in the compiled program. The port's
    block route (`sharded` above) is flat_block_sharded_ms, a key of its
    own. curved_sorted_ms and transfer_extra_ms are null, each with its
    reason. `compiled` says which forwards ran as CUDA graphs (all on a
    card over NCCL; none on the CPU, and the per-trace ones run eagerly
    under gloo, whose collectives a graph cannot hold), `host_launches`
    the host's launches in one call of each (on a card).

Each timed forward runs twice before it is timed, so that a compiled one
is timed on its replays.

Every mode runs on the card unless --device cpu is given, and refuses
without one.

Usage:
  python -m rrt_tpu_torch.tools.scaling_bench [--size 64]
      [--configs 1x1,2x1,4x1] [--device cpu]
  python -m rrt_tpu_torch.tools.scaling_bench --card [--size 256]
  python -m rrt_tpu_torch.tools.scaling_bench --breakdown [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rrt_tpu_torch.utils import prng

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(cmds, logs, envs, timeout=1200):
    """Run the processes `cmds` (argv lists, one a rank) at once, each
    writing its output into its file of `logs`, in its environment of
    `envs`, and wait for all of them; returns their outputs. If one fails
    or the time runs out, every rank still running is killed (a rank left
    waiting in a collective would wait for its peer until NCCL's own
    timeout) and this raises with the output's tail."""
    files = [open(log, "w") for log in logs]
    procs = []
    try:
        procs = [subprocess.Popen(cmd, env=e, stdout=f,
                                  stderr=subprocess.STDOUT)
                 for cmd, e, f in zip(cmds, envs, files)]
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if failed or time.monotonic() > deadline:
                i = failed[0] if failed else codes.index(None)
                what = (f"failed (rc {codes[i]})" if failed
                        else f"did not end within {timeout} s")
                with open(logs[i], errors="replace") as f:
                    tail = f.read()[-3000:]
                raise RuntimeError(f"worker {i} of {len(procs)} {what}:\n"
                                   f"{tail}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    out = []
    for log in logs:
        with open(log, errors="replace") as f:
            out.append(f.read())
    return out


def spawn_workers(nproc: int, size: str, tmpdir: str, device="cpu",
                  backend=None, checks="", timeout=1200, threads=None,
                  env=None):
    """Run `parallel.worker` as nproc processes of one group (`run_ranks`);
    returns each rank's npz and output. On cards the kernels are built
    here first (`ops.build.build_all`), so that no rank runs nvcc and no
    rank's time holds a compile (each rank's npz says `build_cached`).
    `env` adds variables to the ranks' environment."""
    if torch.device(device).type == "cuda":
        from rrt_tpu_torch.ops.build import build_all
        build_all()
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    outs = [os.path.join(tmpdir, f"w{nproc}_{i}.npz") for i in range(nproc)]
    cmd = [sys.executable, "-m", "rrt_tpu_torch.parallel.worker"]
    extra = ["--device", device] + (["--backend", backend] if backend
                                    else []) + (["--checks", checks]
                                                if checks else [])
    logs = run_ranks([cmd + [str(i), str(nproc), str(port), outs[i], size]
                      + extra for i in range(nproc)],
                     [o[:-4] + ".log" for o in outs], [env] * nproc, timeout)
    return [dict(np.load(o)) for o in outs], logs


def main_spawn(args):
    configs = []
    for c in args.configs.split(","):
        p, d = c.strip().split("x")
        if int(d) != 1:
            raise SystemExit(f"config {c}: the port drives one device per "
                             f"process, so D must be 1")
        configs.append(int(p))
    rows = []
    cores = os.cpu_count() or 1
    cards = (torch.cuda.device_count()
             if torch.device(args.device).type == "cuda" else 0)
    with tempfile.TemporaryDirectory() as td:
        for nproc in configs:
            backend = "nccl" if 0 < nproc <= cards else "gloo"
            res, _ = spawn_workers(nproc, str(args.size), td,
                                   device=args.device, backend=backend,
                                   threads=max(1, cores // nproc))
            lanes = args.size * args.size
            dt = max(float(r["dt"]) for r in res)
            rows.append((nproc, lanes, dt, lanes / dt))
            cached = [bool(r["build_cached"]) for r in res]
            print(f"{nproc} proc x 1 dev: {lanes} lanes in {dt:.4f}s "
                  f"-> {lanes / dt:,.0f} lanes/s ({backend} on "
                  f"{args.device}), the slowest rank's median of "
                  f"{len(res[0]['dts'])} forwards; kernels built before "
                  f"the ranks: {cached}")
    base = rows[0][3]
    print("\n| procs | devices | lanes/s | vs 1x1 |")
    print("|---|---|---|---|")
    for nproc, lanes, dt, thr in rows:
        print(f"| {nproc} | {nproc} | {thr:,.0f} | {thr / base:.2f}x |")
    shared = ("its cores" if not cards else
              f"its cores and {cards} card(s)")
    print(f"\n({cores}-core host: the processes share {shared}, so this "
          f"measures the federation's overhead, not hardware scaling)")


def _join(device):
    """The RRT_* group if the variables are set, else a world of 1 on a
    free localhost port; returns this rank's lane mesh."""
    from rrt_tpu_torch.parallel import distributed as pdist
    from rrt_tpu_torch.parallel import sharding as sh
    dev = torch.device(device)
    if not pdist.initialize_from_env(device=dev.type):
        pdist.initialize(f"127.0.0.1:{free_port()}", 1, 0, device=dev.type)
    return sh.make_mesh(device)


def forwards(size: int, mesh, curved: bool = True, graphs=None):
    """The forward estimate of a size² frame (1 spp, -l 1, -m 2, flat or
    curved) three ways, each an `integrator.Forward` (compiled on a card
    unless `graphs` is False): `device0`, unsharded; `sharded`, every
    trace sharded over `mesh` (`est_radiance(mesh=)`, its gathers and
    all-reduces inside the graph under NCCL; eager under gloo); and
    `block_sharded`, the block route a sharded pass takes (this rank's
    block with windowed draws, compiled, then the blocks' radiance
    gathered eagerly). Returns {name: (fn, forward)}: fn() runs the
    forward and returns the frame's (size², 3) radiance."""
    from rrt_tpu_torch.parallel import distributed as pdist
    from rrt_tpu_torch.parallel.sharding import shard_bounds
    from rrt_tpu_torch.parallel.worker import forward_setup
    from rrt_tpu_torch.render.integrator import Forward
    from rrt_tpu_torch.render.renderer import make_black_hole
    from rrt_tpu_torch.ops.trace_kernel import build_tables
    from rrt_tpu_torch.types import Rays
    from rrt_tpu_torch.utils.config import BlackHoleConfig
    scene, _, _, cfg, rays = forward_setup(size, size, mesh.device)
    cfg = cfg.replace(black_hole=BlackHoleConfig(enabled=curved))
    bh = make_black_hole(cfg, mesh.device)
    tab = build_tables(scene, bh)
    n = size * size
    lo, hi = shard_bounds(n, mesh.rank, mesh.world)
    lo, hi = min(lo, n), min(hi, n)
    key = prng.key(0, mesh.device)     # the JAX tool's key(0)
    block = Rays(o=rays.o[lo:hi], d=rays.d[lo:hi], min_t=rays.min_t[lo:hi],
                 max_t=rays.max_t[lo:hi])
    fw = dict(
        device0=Forward(scene, bh, rays, cfg, tab, graphs=graphs),
        sharded=Forward(scene, bh, rays, cfg, tab, mesh=mesh,
                        graphs=graphs),
        block_sharded=Forward(scene, bh, block, cfg, tab,
                              window=(lo, hi, n), graphs=graphs))
    out = {name: (lambda f=f: f(key)[0], f) for name, f in fw.items()}
    out["block_sharded"] = (
        lambda: pdist.all_gather_lanes(fw["block_sharded"](key)[0], mesh,
                                       n), fw["block_sharded"])
    return out


def _sync(device):
    return (lambda: torch.cuda.synchronize(device)) \
        if torch.device(device).type == "cuda" else (lambda: None)


def timeit(fn, device, reps: int = 5):
    """(ms per call over reps calls after two warm ones, host clock ending
    in a device sync; the last result). A compiled forward runs eagerly at
    its first call and is captured at its second, so the timed calls are
    replays."""
    sync = _sync(device)
    for _ in range(2):
        out = fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3, out


def host_launches(fn, device):
    """The host's launches (kernels, copies, graph replays) in one call
    of fn on a card, from `torch.profiler`; None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    from rrt_tpu_torch.utils.profile import profile_call
    return profile_call(fn, device=device).host_launches


def card_gap(size: int) -> dict:
    """The --card measurement: unsharded, sharded, sharded, unsharded
    forwards of size² lanes on a world of 1 over NCCL (each 5 calls after
    two warm ones), both compiled (`forwards`: the block route's graph,
    then its gather); returns their ms and whether the results are
    equal. Leaves the group it joined."""
    from rrt_tpu_torch.parallel import distributed as pdist
    from rrt_tpu_torch.utils.card import card_line
    mesh = _join("cuda")
    try:
        fns = forwards(size, mesh)
        pick = dict(unsharded="device0", sharded="block_sharded")
        res = {}
        for name in ("unsharded", "sharded", "sharded", "unsharded"):
            ms, out = timeit(fns[pick[name]][0], mesh.device)
            res.setdefault(name, []).append((ms, out.clone()))
        equal = torch.equal(res["sharded"][-1][1], res["unsharded"][-1][1])
        compiled = {name: fns[k][1].graphs for name, k in pick.items()}
    finally:
        pdist.shutdown()
    return {"lanes": size * size, "world": mesh.world,
            "backend": mesh.backend,
            "unsharded_ms": [r[0] for r in res["unsharded"]],
            "sharded_ms": [r[0] for r in res["sharded"]], "equal": equal,
            "compiled": compiled, "card": card_line()}


def main_card(args):
    gap = card_gap(args.size)
    n = gap["lanes"]
    for name in ("unsharded", "sharded"):
        ms = gap[f"{name}_ms"]
        print(f"{name}: {n} lanes in {min(ms):.3f} ms ({n / min(ms) * 1e3:,.0f}"
              f" lanes/s; runs {', '.join(f'{m:.3f}' for m in ms)} ms) on "
              f"{gap['world']} device(s) over {gap['backend']}, compiled "
              f"{gap['compiled'][name]}")
    print(json.dumps({"card_gap": gap}))
    if not gap["equal"]:
        raise SystemExit("the sharded forward differs from the unsharded")


# --breakdown's keys: the JAX tool's (tools/scaling_bench.py:222-226),
# with the port's block route under a key of its own
BREAKDOWN = (("flat", "sharded", "flat_sharded"),
             ("flat", "device0", "flat_device0"),
             ("flat", "block_sharded", "flat_block_sharded"),
             ("curved", "sharded", "curved_nosort"))


def breakdown(size: int, mesh) -> dict:
    """--breakdown's row for this rank: each forward of `BREAKDOWN` timed
    (`timeit`), the collectives one call makes (calls and bytes handed to
    them, which stand for the JAX tool's census of collectives in the
    compiled program), whether it is compiled and the host's launches in
    one call."""
    from rrt_tpu_torch.parallel import distributed as pdist
    out = {"world": mesh.world, "backend": mesh.backend,
           "device": str(mesh.device), "lanes": size * size, "compiled": {},
           "host_launches": {}}
    for kind in ("flat", "curved"):
        fns = forwards(size, mesh, curved=kind == "curved")
        for k, name, key in BREAKDOWN:
            if k != kind:
                continue
            fn, fwd = fns[name]
            out[f"{key}_ms"], _ = timeit(fn, mesh.device)
            pdist.COLLECTIVES.update(calls=0, bytes=0)
            fn()
            collectives = dict(pdist.COLLECTIVES)
            if name == "sharded":
                out[f"{kind}_collectives"] = collectives
            elif name == "block_sharded":
                out[f"{key}_collectives"] = collectives
            out["compiled"][key] = fwd.graphs
            out["host_launches"][key] = host_launches(fn, mesh.device)
        del fns
    out["curved_sorted_ms"] = None
    out["curved_sorted_reason"] = ("the port has no lane sort: the kernel "
                                   "traces the lanes in their order")
    out["transfer_extra_ms"] = None
    out["transfer_extra_reason"] = ("the trace tables are built once per "
                                    "render and stay on the device; no "
                                    "call re-ships them")
    return out


def forward_case(mesh, size: int, curved: bool, reps: int = 5) -> dict:
    """The per-trace sharded forward (`est_radiance(mesh=)`, 1 spp, -l 1,
    -m 2) of a size² frame, compiled (one graph with its collectives
    inside on a card over NCCL), against the same forward run eagerly and
    against the compiled unsharded forward: equal bit for bit in radiance
    and trace counters at every call, the first (eager) and second
    (captured) calls included; the kernel's own count of its runs equal
    to the trace calls at every call, and no Python launch in a replay;
    the collectives of a replay equal to the eager call's (the kernel's
    count on a card only: the CPU's plain traversal keeps none). Then walls in
    turns (`reps` each, host clock ending in a device sync), the host's
    launches in one call of each, the capture's seconds and, on a card,
    the compiled forward's graph pool. Returns a row of plain values."""
    import gc
    from rrt_tpu_torch.ops import trace_kernel as tk
    from rrt_tpu_torch.parallel import distributed as pdist
    dev = mesh.device
    cuda = dev.type == "cuda"
    sync = _sync(dev)
    fs = dict(graph=forwards(size, mesh, curved)["sharded"][1],
              eager=forwards(size, mesh, curved, graphs=False)["sharded"][1],
              unsharded=forwards(size, mesh, curved)["device0"][1])
    key = prng.key(0, dev)
    bad = []

    def run(label):
        tk.reset_counts()
        pdist.COLLECTIVES.update(calls=0, bytes=0)
        replay = fs[label].call is not None and fs[label].call.calls > 0
        sync()
        t0 = time.perf_counter()
        L, work = fs[label](key)
        sync()
        wall = time.perf_counter() - t0
        if work.calls == 0 or cuda and (
                tk.kernel_runs() != work.calls or replay and tk.LAUNCHES):
            bad.append(f"{label}: {tk.kernel_runs()} kernel runs and "
                       f"{tk.LAUNCHES} eager launches for {work.calls} trace "
                       f"calls")
        return wall, L.clone(), work.tests.clone(), dict(pdist.COLLECTIVES)

    _, L0, t0_, coll = run("eager")
    equal = {"eager": [], "unsharded": []}

    def check(label, got):
        same = torch.equal(got[1], L0) and torch.equal(got[2], t0_)
        equal["unsharded" if label == "unsharded" else "eager"].append(same)
        if label == "graph" and got[3] != coll:
            bad.append(f"a compiled call made {got[3]} collectives, the "
                       f"eager one {coll}")
    first = {}
    for label in ("graph", "unsharded"):
        for i in range(2):            # the eager warm-up, then the capture
            got = run(label)
            first[f"{label}_{i}"] = got[0]
            check(label, got)
    walls = {k: [] for k in fs}
    order = ("graph", "eager", "unsharded")
    for label in (order + order[::-1]) * ((reps + 1) // 2):
        if len(walls[label]) < reps:
            got = run(label)
            walls[label].append(got[0])
            check(label, got)
    launches = {k: host_launches(lambda f=f: f(key), dev)
                for k, f in fs.items()}
    call = fs["graph"].call
    row = dict(size=size, lanes=size * size, curved=curved,
               world=mesh.world, backend=mesh.backend,
               compiled=fs["graph"].graphs,
               equal_eager=all(equal["eager"]),
               equal_unsharded=all(equal["unsharded"]),
               calls=len(equal["eager"]) + len(equal["unsharded"]) + 1,
               walls=walls, first_calls=first, host_launches=launches,
               collectives=coll,
               graph_collectives=dict(call.collectives) if call else None,
               capture_s=call.capture_seconds if call else None,
               replays=call.replays if call else 0, faults=bad)
    if cuda:
        mib = 2 ** 20
        del fs["eager"], fs["unsharded"], call
        gc.collect()
        torch.cuda.empty_cache()
        pool = torch.cuda.memory_reserved(dev) / mib
        del fs
        gc.collect()
        torch.cuda.empty_cache()
        row["pool_mib"] = pool - torch.cuda.memory_reserved(dev) / mib
    return row


def main_breakdown(args):
    from rrt_tpu_torch.parallel import distributed as pdist
    from rrt_tpu_torch.utils.card import card_line
    mesh = _join(args.device)
    out = breakdown(args.size, mesh)
    if mesh.device.type == "cuda":
        out["card"] = card_line()
    print(json.dumps(out))
    pdist.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rrt_tpu_torch.tools.scaling_bench")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--configs", default="1x1,2x1,4x1")
    ap.add_argument("--card", "--tpu", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the default mode's and --breakdown's device "
                         "(default: cuda; --card always runs on the card)")
    args = ap.parse_args(argv)
    if (args.card or torch.device(args.device).type == "cuda") \
            and not torch.cuda.is_available():
        print("scaling_bench: CUDA is not available; pass --device cpu to "
              "run on the CPU" + (" (--card needs a card)" if args.card
                                  else ""), file=sys.stderr)
        return 2
    if args.card:
        main_card(args)
    elif args.breakdown:
        main_breakdown(args)
    else:
        main_spawn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
