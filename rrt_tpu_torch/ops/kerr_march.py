"""The Kerr march of a batch of lanes to its end: the CUDA kernel's
wrapper and the entry to its plain PyTorch version.

`march(lanes, n_steps, bh, disk, r_escape, hole)` marches every lane of
`lanes` (a `Lanes` of buffers, updated in place) up to `n_steps` RK4 steps
against the disk, each lane until it is captured, escapes or meets the
disk: on a card one launch of `ops/csrc/kerr_march.cu` (one thread a lane,
the lane's steps in registers, ∂ℋ written out by hand), on the CPU the
step-by-step march (`render/kerr_scene.march_steps`), which is the
kernel's plain version op for op. Every lane's `settled` gets the steps
it began already settled, and `issued` gains the lane-slots that warps of
32 consecutive lanes step: 32 × the most steps a lane of the group ran,
summed over the groups (`warp_issued`). A tensor on another device
raises.

`LAUNCHES` counts eager launches; `kernel_runs()` reads the kernel's runs
as it counted them on the devices, CUDA graph replays included.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

WARP = 32
# eager launches (a launch recorded into a CUDA graph is not one)
LAUNCHES = 0
# device -> (1,) int64 run counter in device memory, added to by the
# kernel at each run, launched or replayed
_RUNS: dict = {}


class Lanes(NamedTuple):
    """A batch's march state and results, each (n, ...) and contiguous."""

    x: torch.Tensor          # (n, 3) float32 position (hole frame)
    p: torch.Tensor          # (n, 3) float32 covariant spatial momentum
    pt: torch.Tensor         # (n,) float32
    captured: torch.Tensor   # (n,) bool
    escaped: torch.Tensor    # (n,) bool
    acc: torch.Tensor        # (n, 3) float32 disk radiance
    hit: torch.Tensor        # (n,) bool, on the disk
    settled: torch.Tensor    # (n,) int32 steps begun settled (written)
    issued: torch.Tensor     # (1,) int64 lane-slots stepped (added to)


def hole_constants(bh, disk, r_escape: float) -> tuple:
    """The kernel's 11 floats (mass, spin, r_h, the capture and escape
    radii squared, r_in, r_out, q, the emission's channels), computed by
    the plain version's own ops and read back once: call outside a
    capture."""
    rh = bh.horizon_radius
    vals = torch.stack([
        bh.mass, bh.spin, rh, (rh * 1.02) ** 2,
        torch.full_like(rh, float(r_escape * r_escape)),
        disk.r_in, disk.r_out, disk.q, *disk.emission.unbind()])
    return tuple(vals.tolist())


def warp_issued(live: torch.Tensor) -> torch.Tensor:
    """32 × the most live steps of each group of 32 consecutive lanes of
    `live` (flat, padded with lanes of 0 steps), summed: int64 ()."""
    live = live.reshape(-1).to(torch.int64)
    pad = (-live.numel()) % WARP
    groups = torch.cat([live, live.new_zeros(pad)]).reshape(-1, WARP)
    return WARP * groups.amax(dim=1).sum() if groups.numel() else \
        live.new_zeros(())


# ---------------------------------------------------------------- kernel

_FN = None


def _kerr_fns():
    """The library's march entry and its error strings, resolved once per
    process."""
    global _FN
    if _FN is None:
        from rrt_tpu_torch.ops import build
        lib = build.load_library("kerr_march")
        _FN = (lib.rrt_kerr_march, lib.rrt_kerr_march_error_string)
    return _FN


def _runs(dev) -> torch.Tensor:
    """The device's run counter, made at its first eager launch (made in a
    capture, it would be a graph's buffer that a replay resets)."""
    c = _RUNS.get(dev)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the Kerr march kernel's first launch on a "
                               "device cannot be inside a CUDA graph capture")
        c = _RUNS[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return c


def kernel_runs() -> int:
    """Runs since the last `reset_counts`, replays included. Waits for the
    devices."""
    return sum(int(c.item()) for c in _RUNS.values())


def reset_counts():
    """The launch counts and the devices' run counters set to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for c in _RUNS.values():
        c.zero_()


_KINDS = dict(x=(torch.float32, 3), p=(torch.float32, 3),
              pt=(torch.float32, None), captured=(torch.bool, None),
              escaped=(torch.bool, None), acc=(torch.float32, 3),
              hit=(torch.bool, None), settled=(torch.int32, None))


def _check_one(name: str, t: torch.Tensor, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}{'' if t.is_contiguous() else ', strided'}")


def _check(lanes: Lanes, dev):
    """Raise unless every buffer lies on `dev`, with its dtype and shape,
    contiguous."""
    n = lanes.pt.shape[0] if lanes.pt.dim() == 1 else -1
    for name, (dtype, width) in _KINDS.items():
        _check_one(name, getattr(lanes, name), dtype,
                   (n,) if width is None else (n, width), dev)
    _check_one("issued", lanes.issued, torch.int64, (1,), dev)


def _device(lanes: Lanes):
    """The lanes' device: "cpu" for the plain version, a CUDA device with
    its index for the kernel; another device raises."""
    dev = lanes.x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no Kerr march for device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _stream(dev) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index)


def march(lanes: Lanes, n_steps: int, bh, disk, r_escape: float,
          hole=None):
    """March `lanes` in place (see the module's docstring): one kernel
    launch on a card, the step-by-step plain version on the CPU. `hole`:
    `hole_constants(bh, disk, r_escape)`, read here when not given (never
    inside a capture)."""
    global LAUNCHES
    dev = _device(lanes)
    _check(lanes, dev)
    if dev.type == "cpu":
        from rrt_tpu_torch.render import kerr_scene
        return kerr_scene.march_steps(lanes, n_steps, bh, disk, r_escape)
    if n_steps < 0:
        raise ValueError(f"n_steps {n_steps} < 0")
    if hole is None:
        hole = hole_constants(bh, disk, r_escape)
    fn, error = _kerr_fns()
    rc = fn(*(t.data_ptr() for t in lanes), _runs(dev).data_ptr(),
            lanes.pt.shape[0], n_steps, (ctypes.c_float * 11)(*hole),
            int(bool(disk.beaming)), dev.index, _stream(dev))
    if rc != 0:
        raise RuntimeError("Kerr march kernel launch failed: "
                           + error(rc).decode())
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1

