"""The toolchain probe: does a hand-written kernel build and launch here?

The port of the JAX bench's `PROBE` Pallas kernel (`bench.py`, run by
`probe_pallas`): `x * 2` on one (8, 128) float32 tile
(`ops/csrc/probe.cu`). `probe(device)` builds the library, launches the
kernel on ones and checks that the sum is 2048; it raises otherwise. The
JAX bench ran its probe in a subprocess, slept and fell back to an XLA
backend when it failed; the port has no fallback: a card whose toolchain
does not work stops the bench.
"""
from __future__ import annotations

import torch

SHAPE = (8, 128)

# kernel launches made by `probe_kernel`; read by tests and chip_smoke.py
LAUNCHES = 0


def probe_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: x * 2."""
    return x * 2.0


_FN = None


def _probe_fn():
    """The library's `rrt_probe`, resolved once per process (the build
    and the library load happen on the first call)."""
    global _FN
    if _FN is None:
        from rrt_tpu_torch.ops import build
        lib = build.load_library("probe")
        _FN = (lib.rrt_probe, lib.rrt_probe_error_string)
    return _FN


def probe_kernel(x: torch.Tensor) -> torch.Tensor:
    """x * 2 for one float32 (8, 128) contiguous tile. A CPU tensor goes
    to `probe_reference`; a CUDA tensor to the kernel, built on first use;
    anything else raises. Each launch adds one to `LAUNCHES`."""
    global LAUNCHES
    if not x.is_cuda:
        if x.device.type == "cpu":
            return probe_reference(x)
        raise ValueError(f"no probe kernel for device {x.device}")
    if x.dtype != torch.float32 or x.shape != SHAPE \
            or not x.is_contiguous():
        raise ValueError(f"x: expected contiguous float32 {SHAPE}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    fn, err = _FN or _probe_fn()
    out = torch.empty_like(x)
    index = x.get_device()
    rc = fn(x.data_ptr(), out.data_ptr(), index,
            torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError("probe kernel launch failed: "
                           + err(rc).decode())
    LAUNCHES += 1
    return out


def probe(device) -> float:
    """Build the probe library, launch the kernel on ones((8, 128)) on
    `device` (a CUDA device) and return the sum, 2048.0; raise if the
    device is not a card, the build or launch fails, or the sum is
    wrong."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the probe runs on a CUDA device, not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    out = probe_kernel(torch.ones(SHAPE, device=device))
    total = float(out.sum())               # waits for the kernel
    if total != 2.0 * SHAPE[0] * SHAPE[1]:
        raise RuntimeError(f"probe kernel summed to {total}, not 2048.0")
    return total
