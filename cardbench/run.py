"""Run one cell of the benchmark once:

    python3 -m cardbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It prints one JSON line last on standard
output (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`, and last the numbers compared with their
limits, `checks`), and the same numbers last on standard error. With
`--trace 0` the metrics are the cell's end-to-end metrics, with `--trace
1` its per-layer metrics, read by `metrics/<metric>.py` from a profiled
stretch of frames or steps after the window.

A run fails (no result, a non-zero exit) when there is no CUDA card or
fewer than the cell asks for, when a file it needs is missing, or when a
module of JAX or of the JAX package (`jax`, `jaxlib`, `flax`,
`rrt_tpu`, whole top-level names) is loaded after set-up or at the end.

A cell on several cards runs one rank a card: this process is rank 0
and starts the others (`--rank`, `--world`, `--port`: a free port on
127.0.0.1), each logging to a file under TMPDIR; it watches them, and
ends them all as soon as one fails.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

if __package__ in (None, ""):      # run as a script: python3 cardbench/run.py
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cardbench import harness, tracing  # noqa: E402


# the cell and limits of a test's CPU ranks, as JSON (see `--device`)
TEST_CELL = "CARDBENCH_TEST_CELL"


class Context:
    """What a driver gets: the cell, the run's arguments, this rank's
    device, and the few collective helpers a driver needs."""

    def __init__(self, args, cell, limits, device, rank=0, world=1, port=0,
                 backend=None):
        self.cell, self.limits, self.device = cell, limits, device
        self.seed, self.seconds, self.trace = args.seed, args.seconds, \
            bool(args.trace)
        self.rank, self.world, self.port, self.backend = rank, world, port, \
            backend

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def gather(self, obj):
        """Each rank's `obj` (a tuple) at rank 0, unzipped into lists; None
        elsewhere."""
        if self.world == 1:
            return tuple([x] for x in obj)
        import torch.distributed as dist
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0)
        return tuple(zip(*out)) if self.rank == 0 else (None,) * len(obj)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """Ranks 1..world-1 as child processes, watched from a thread: when
    one exits with an error, its log's end goes to stderr and every rank,
    this process too, ends."""

    def __init__(self, args, world: int, port: int, device):
        logs = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
        self.procs = []
        for rank in range(1, world):
            log = logs / f"cardbench-rank{rank}.log"
            cmd = [sys.executable, "-m", "cardbench.run",
                   "--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace),
                   "--rank", str(rank), "--world", str(world),
                   "--port", str(port)]
            if device.type != "cuda":
                cmd += ["--device", device.type]
            f = open(log, "w")
            self.procs.append((rank, log, f, subprocess.Popen(
                cmd, cwd=harness.CHECKOUT, stdout=f,
                stderr=subprocess.STDOUT)))
        self.done = False
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        while not self.done:
            for rank, log, _, p in self.procs:
                rc = p.poll()
                if rc not in (None, 0):
                    tail = log.read_text()[-4000:]
                    print(f"rank {rank} exited with {rc}:\n{tail}",
                          file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(1)
            time.sleep(0.5)

    def kill(self):
        for _, _, f, p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            f.close()

    def wait(self, timeout: float = 120.0):
        t0 = time.time()
        for rank, log, f, p in self.procs:
            rc = p.wait(timeout=max(1.0, timeout - (time.time() - t0)))
            f.close()
            if rc != 0:
                raise harness.BenchError(
                    f"rank {rank} exited with {rc}: "
                    f"{log.read_text()[-4000:]}")
        self.done = True


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m cardbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    # a rank started by a test on the CPU (rank 0 runs in the test)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def metrics_of(cell, out, card, trace: bool) -> dict:
    """The result's metrics: the cell's end-to-end metrics, or with
    `trace` its per-layer metrics as their readers give them (a reader
    that finds nothing to read gives None, and the metric is left out)."""
    metrics = {}
    if not trace:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
        return metrics
    view = dict(summaries=out["summaries"], work=out.get("work"), card=card)
    for m in cell["per_layer"]:
        value = harness.load_module("metrics", m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def execute(args, device=None, cell=None, limits=None) -> int:
    """One run of the cell; with `device` given (a test on the CPU) the
    look for a card is skipped, and `cell` and `limits` may stand in for
    the manifest's."""
    harness.set_caches()
    cell = harness.cell(args.workload) if cell is None else cell
    import torch
    if device is None:
        harness.require_cards(cell["chips"])
        index = args.rank or 0
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    if limits is None:
        limits = json.loads((harness.HERE / "limits"
                             / f"{args.workload}.json").read_text())
    world = cell["chips"] if args.rank is None else args.world
    rank = args.rank or 0
    driver = harness.load_module("drivers", cell["traffic"]["driver"])
    ranks = None
    port = args.port
    if world > 1 and args.rank is None:
        port = _free_port()
        ranks = Ranks(args, world, port, device)
    backend = None if device.type == "cuda" else "gloo"
    try:
        out = driver.run(Context(args, cell, limits, device, rank, world,
                                 port, backend))
        if ranks is not None:
            ranks.wait()
    finally:
        if ranks is not None:
            ranks.done = True
            ranks.kill()
    if rank != 0:
        return 0
    harness.check_modules("at the end")
    card = harness.card_info(device) if device.type == "cuda" else dict(
        name=str(device), peak_flops=None, power_limit_w=None)
    metrics = metrics_of(cell, out, card, bool(args.trace))
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=card["name"], count=world,
               memory_peak_bytes=out["peak"])
    breakdown = None
    if args.trace:
        s = out["summaries"]
        dev["busy_s"] = sum(x["busy_s"] for x in s) / len(s)
        dev["window_s"] = sum(x["window_s"] for x in s) / len(s)
        breakdown = tracing.breakdown(s)
    info = (f"# cell {args.workload} seed {args.seed} on {card['name']} "
            f"({card['power_limit_w']} W) x{world}: {out['attempted']} "
            f"attempted in {out['window_s']:.3f} s (walls: least "
            f"{min(out['walls']):.6f}, median "
            f"{harness.percentile(out['walls'], 50):.6f}, most "
            f"{max(out['walls']):.6f} s); set-up phases ended at "
            f"{json.dumps(out['phases'])} s; numbers "
            f"{json.dumps(out['numbers'])}")
    print(info, file=sys.stderr)
    for line in harness.checks_text(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(out["correct"], out["attempted"],
                              out["failed"], metrics, dev, out["checks"],
                              breakdown), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    try:
        if args.device == "cpu":
            if args.rank is None:
                raise harness.BenchError("--device cpu is for the ranks a "
                                         "test starts, not for a run")
            import torch
            test = json.loads(os.environ[TEST_CELL])
            return execute(args, torch.device("cpu"), test["cell"],
                           test["limits"])
        return execute(args)
    except harness.BenchError as e:
        print(f"cardbench: {e}", file=sys.stderr, flush=True)
        return 2


if __name__ == "__main__":
    sys.exit(main())
