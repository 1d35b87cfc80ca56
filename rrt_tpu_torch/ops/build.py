"""Build and bind the port's CUDA kernels.

Each kernel family is one source under `ops/csrc/`, compiled by nvcc for
Hopper into its own shared library with a plain C interface, named after
the hash of its source and flags (`build/rrt_tpu_torch/lib<family>_<sha>.so`
under the checkout), on first use, and loaded with ctypes. `build_all`
starts one nvcc per family at once and waits for all of them. Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG.parent / "build" / "rrt_tpu_torch"
# no FMA contraction, IEEE division and square root: every kernel rounds
# like its plain PyTorch version, operation by operation
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_vp, _i = ctypes.c_void_p, ctypes.c_int


def _declare_trace(lib):
    lib.rrt_trace.argtypes = ([_vp] * 4 + [_i] + [_vp] * 6 + [_i] * 9
                              + [_vp] * 12 + [_i, _vp])
    lib.rrt_trace.restype = _i
    lib.rrt_error_string.argtypes = [_i]
    lib.rrt_error_string.restype = ctypes.c_char_p


def _declare_probe(lib):
    lib.rrt_probe.argtypes = [_vp, _vp, _i, _vp]
    lib.rrt_probe.restype = _i
    lib.rrt_probe_error_string.argtypes = [_i]
    lib.rrt_probe_error_string.restype = ctypes.c_char_p


def _declare_r5prim(lib):
    lib.rrt_r5prim.argtypes = [_i, _vp, _vp, _vp, _i, _i,
                               ctypes.POINTER(_i), _vp]
    lib.rrt_r5prim.restype = _i
    lib.rrt_r5prim_error_string.argtypes = [_i]
    lib.rrt_r5prim_error_string.restype = ctypes.c_char_p


def _declare_threefry(lib):
    ll = ctypes.c_longlong
    lib.rrt_threefry_uniform.argtypes = [_vp] + [ll] * 6 + [_i, _vp, _vp,
                                                             _i, _vp]
    lib.rrt_threefry_uniform.restype = _i
    lib.rrt_threefry_keys.argtypes = [_vp, _i, _i, _vp, ctypes.c_uint, _vp,
                                      _vp, _i, _vp]
    lib.rrt_threefry_keys.restype = _i
    lib.rrt_threefry_error_string.argtypes = [_i]
    lib.rrt_threefry_error_string.restype = ctypes.c_char_p


@dataclasses.dataclass(frozen=True)
class Family:
    """One library: its sources, and the C signatures it exports."""

    name: str
    sources: Tuple[Path, ...]
    declare: Callable[[ctypes.CDLL], None]


FAMILIES: Dict[str, Family] = {
    "trace": Family("trace", (_CSRC / "trace_kernel.cu",), _declare_trace),
    "probe": Family("probe", (_CSRC / "probe.cu",), _declare_probe),
    "r5prim": Family("r5prim", (_CSRC / "r5prim.cu",), _declare_r5prim),
    "threefry": Family("threefry", (_CSRC / "threefry.cu",),
                       _declare_threefry),
}

# per family, what its last build in this process printed, how long it
# took, and whether the library was already there (cached, no nvcc run)
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(family: str = "trace") -> Path:
    fam = FAMILIES[family]
    sha = hashlib.sha256()
    for src in fam.sources:
        sha.update(src.read_bytes())
    sha.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{fam.name}_{sha.hexdigest()[:16]}.so"


def build_all(families: Iterable[str] = tuple(FAMILIES)) -> Dict[str, Path]:
    """Compile every named family whose library of the same hash does not
    exist yet, one nvcc process each, all started together; raise if any
    fails. Returns {family: library path}."""
    paths = {f: library_path(f) for f in families}
    procs = {}
    t0 = time.perf_counter()
    for f, out in paths.items():
        if out.exists():
            BUILD_LOG.setdefault(f, dict(seconds=0.0, output="",
                                         path=str(out), cached=True))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, FAMILIES[f].sources)]
        procs[f] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for f, (tmp, proc) in procs.items():
        output = proc.communicate()[0]
        BUILD_LOG[f] = dict(seconds=time.perf_counter() - t0, output=output,
                            path=str(paths[f]), cached=False)
        if proc.returncode != 0:
            failed.append(f"{f}: nvcc failed ({proc.returncode}):\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[f])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(family: str = "trace") -> Path:
    """Compile one family unless a library of the same hash exists."""
    return build_all([family])[family]


@functools.lru_cache(maxsize=None)
def load_library(family: str = "trace") -> ctypes.CDLL:
    """The family's built library with every entry point's signature
    declared."""
    lib = ctypes.CDLL(str(build(family)))
    FAMILIES[family].declare(lib)
    return lib
