"""What every cell of the benchmark shares: the manifest, the files found
by name, the set-up clock, the checks on the process, and the result.

`BENCHMARK.json` at the root of the checkout names the cells. A cell
names a configuration (`configs/<config>.json`: the scene, its size and
samples, the hole, its source) and a traffic mix (`traffic/<mix>.json`:
which driver runs it, `drivers/<driver>.py`, and the driver's
parameters); each per-layer metric is read by `metrics/<metric>.py`.
So a later change adds a configuration, a mix or a metric as files, and
edits none.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
MANIFEST = CHECKOUT / "BENCHMARK.json"
# top-level module names that may not be loaded in a run: JAX, its
# libraries, and the JAX package the port was made from (whole names:
# `rrt_tpu_torch` is the port and passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "rrt_tpu")
# where the program's and the libraries' build and kernel caches live:
# fixed directories inside the checkout, so that only a cell's first run
# in a checkout builds
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton",
          "CUDA_CACHE_PATH": "build/cuda_cache"}
# the published memory bandwidth of one H100 SXM (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12


class BenchError(RuntimeError):
    """A run that cannot give a result: no card, a missing file, a
    forbidden module."""


def process_seconds() -> float:
    """Seconds since this process started (from /proc: the kernel's start
    time of the process against the uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def set_caches():
    """Point the build and kernel caches into the checkout."""
    for var, rel in CACHES.items():
        path = CHECKOUT / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def load_manifest(path: Path = MANIFEST) -> dict:
    if not path.exists():
        raise BenchError(f"no {path.name} at {path.parent}")
    return json.loads(path.read_text())


def _json(path: Path) -> dict:
    if not path.exists():
        raise BenchError(f"missing {path.relative_to(CHECKOUT)}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """The module `<kind>/<name>.py` under the benchmark, by file."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise BenchError(f"missing {path.relative_to(CHECKOUT)}")
    spec = importlib.util.spec_from_file_location(
        f"cardbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, manifest: Optional[dict] = None) -> dict:
    """Everything a run of the cell `name` needs, found by name: its
    entry, its configuration's and traffic's files, and the end-to-end
    and per-layer metrics it reports."""
    man = load_manifest() if manifest is None else manifest
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise BenchError(f"no cell {name!r} in {MANIFEST.name}")
    w = cells[name]
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layers = [m for m in man["per_layer"]
              if (name in m["workloads"] if "workloads" in m
                  else m["moves"] in reported)]
    return dict(workload=w, config=_json(CHECKOUT / conf["file"]),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=layers, chips=int(w["chips"]))


def forbidden_modules(names=None) -> list:
    """The loaded modules whose whole top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check_modules(when: str):
    bad = forbidden_modules()
    if bad:
        raise BenchError(f"{when}: forbidden modules loaded: "
                         f"{', '.join(bad[:20])}")


def require_cards(chips: int):
    """Raise unless this process sees a CUDA card, and `chips` of them."""
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA card: the benchmark measures the port on "
                         "a card and has no fallback")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, this machine has "
                         f"{torch.cuda.device_count()}")


def percentile(values, p: float) -> float:
    """The p-th percentile of `values` (linear between order statistics)."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    at = (len(xs) - 1) * p / 100.0
    lo = math.floor(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def card_info(device) -> dict:
    """The card's name, its SM count and its float32 peak (SMs × 128
    lanes × 2 flops × the maximum SM clock from nvidia-smi)."""
    import subprocess

    import torch
    props = torch.cuda.get_device_properties(device)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
         "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True)
    clock, power = (x.strip() for x in out.stdout.splitlines()[0].split(","))
    return dict(name=torch.cuda.get_device_name(device),
                sms=props.multi_processor_count, power_limit_w=float(power),
                peak_flops=props.multi_processor_count * 128 * 2.0
                * float(clock) * 1e6)


def checks_text(checks) -> list:
    """One line per compared number: name, value, limit."""
    return [f"check {name}: {value!r} (limit {limit!r})"
            for name, value, limit in checks]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks, breakdown=None) -> str:
    """The run's last line: the contract's keys, then the numbers
    compared with their limits, last."""
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in checks}
    return json.dumps(out)
