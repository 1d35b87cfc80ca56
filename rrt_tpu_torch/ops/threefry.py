"""Threefry-2x32 random streams: the CUDA kernel's wrapper and its plain
PyTorch version.

This replaces XLA's threefry2x32 under `jax.random` (the JAX package's
every draw, e.g. `rrt_tpu/render/integrator.py:194`), which is no Pallas
kernel: the same hash with the same counters, so that the port draws the
JAX package's bits on any device. Two entries:

  * `derive(keys, count, data, offset)`: out[..., i] = threefry2x32(key,
    (0, data + offset + i)), the keys of `split` (offset 0) and of
    `fold_in` (count 1), where `offset` is an int and `data` none or a 0-d
    integer tensor that the kernel reads from device memory, so that a
    replayed CUDA graph derives the key of the pass it replays;
  * `uniform(keys, shape, axis, lo, hi)`: the block [lo, hi) along
    `axis` of `jax.random.uniform(key, shape)` for every key: element g
    of the whole draw (its flat index) hashes the counter (g >> 32, g &
    0xFFFFFFFF), its 32 bits are bits1 ^ bits2, and the float in [0, 1)
    is (bits >> 9 | 0x3F800000) − 1.

Keys are int64 tensors of shape (..., 2) holding uint32 values (the JAX
key's two words); all arithmetic is exact 32-bit integer work, masked in
the plain version, so the kernel equals it bit for bit.

A CPU tensor goes to the plain version; a CUDA tensor to the kernel
(`ops/csrc/threefry.cu`, built on first use); anything else raises.
`LAUNCHES` and `KEY_LAUNCHES` count the uniform and key entries' eager
launches; `kernel_runs()` reads the kernel's own counts on the devices,
CUDA graph replays included.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
# the arithmetic of one uniform as ops/csrc/threefry.cu writes it: the
# hash's 79 32-bit integer operations (2 for the third key word, 2 for
# the first injection, 3 in each of 20 rounds, 3 in each of the 5 later
# injections), 3 more for the bits and the float's − 1; a derived key is
# the hash alone. The least time
# of a launch counts these at the card's float32 peak (SMs × 128 lanes ×
# 2 a clock): the SM issues 32-bit integer and float work from one issue
# budget, and a three-input add or logic op does two operations in one
# instruction, as a fused multiply-add does two flops (chip_smoke.py)
UNIFORM_OPS = 83
KEY_OPS = 79

# eager launches of the uniform and the key entries (a launch recorded
# into a CUDA graph is not one); read by tests and chip_smoke.py
LAUNCHES = 0
KEY_LAUNCHES = 0
# device index -> (2,) int64 counters in device memory that the kernels
# add one to at each of their runs, launched or replayed: [uniform, keys]
_RUNS: dict = {}


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of the counters (x0, x1) under the key (k0,
    k1) (jax/_src/prng.py `_threefry2x32_lowering`): 20 rounds with the
    key injected every 4. Integer tensors (or ints) holding uint32
    values, broadcast together; returns the two output words as int64."""
    k2 = k0 ^ k1 ^ PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _words(keys: torch.Tensor):
    """The (B,) key words of (..., 2) keys."""
    flat = keys.reshape(-1, 2)
    return flat[:, 0], flat[:, 1]


def derive_reference(keys: torch.Tensor, count: int, data=None,
                     offset: int = 0) -> torch.Tensor:
    """The plain version of `derive`: (..., count, 2) keys."""
    k0, k1 = _words(keys)
    c = torch.arange(count, dtype=torch.int64, device=keys.device) + offset
    if data is not None:
        c = c + data.to(torch.int64).reshape(())
    c = c & M32
    x0, x1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(c), c)
    return torch.stack([x0, x1], dim=-1).reshape(
        keys.shape[:-1] + (count, 2))


def _window_index(shape, axis: int, lo: int, hi: int, device):
    """The flat indices in the whole `shape` of its block [lo, hi) along
    `axis`, in the block's shape."""
    outer = math.prod(shape[:axis])
    inner = math.prod(shape[axis + 1:])
    a = torch.arange(lo, hi, dtype=torch.int64, device=device)
    g = ((torch.arange(outer, dtype=torch.int64, device=device)[:, None, None]
          * shape[axis] + a[None, :, None]) * inner
         + torch.arange(inner, dtype=torch.int64, device=device)[None, None])
    return g.reshape(tuple(shape[:axis]) + (hi - lo,)
                     + tuple(shape[axis + 1:]))


def uniform_reference(keys: torch.Tensor, shape: Sequence[int], axis: int,
                      lo: int, hi: int) -> torch.Tensor:
    """The plain version of `uniform`: keys.shape[:-1] + the block's
    shape, float32."""
    shape = tuple(shape)
    k0, k1 = _words(keys)
    g = _window_index(shape, axis, lo, hi, keys.device)
    bcast = (-1,) + (1,) * g.dim()
    x0, x1 = threefry2x32(k0.reshape(bcast), k1.reshape(bcast), g >> 32,
                          g & M32)
    bits = (((x0 ^ x1) >> 9) | 0x3F800000).to(torch.int32)
    f = bits.view(torch.float32) - 1.0
    return f.reshape(keys.shape[:-1] + g.shape)


# ---------------------------------------------------------------- kernel

_FN = None


def _threefry_fn():
    """The library's entry points, resolved once per process."""
    global _FN
    if _FN is None:
        from rrt_tpu_torch.ops import build
        lib = build.load_library("threefry")
        _FN = (lib.rrt_threefry_uniform, lib.rrt_threefry_keys,
               lib.rrt_threefry_error_string)
    return _FN


def kernel_runs(which: Optional[str] = None) -> int:
    """The kernels' runs since the last `reset_counts`, as they counted
    them on the device, replays included: of the uniform entry
    ("uniform"), the key entry ("keys"), or both. Waits for the devices."""
    col = {"uniform": slice(0, 1), "keys": slice(1, 2), None: slice(0, 2)}
    return sum(int(c[col[which]].sum().item()) for c in _RUNS.values())


def reset_counts():
    """`LAUNCHES`, `KEY_LAUNCHES` and the devices' run counters set to 0."""
    global LAUNCHES, KEY_LAUNCHES
    LAUNCHES = KEY_LAUNCHES = 0
    for c in _RUNS.values():
        c.zero_()


def _runs_counter(dev) -> torch.Tensor:
    """The device's run counters, made at its first eager launch (made in
    a capture, they would be a graph's buffer that a replay resets)."""
    c = _RUNS.get(dev.index)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the threefry kernel's first launch on a "
                               "device cannot be inside a CUDA graph capture")
        c = _RUNS[dev.index] = torch.zeros(2, dtype=torch.int64, device=dev)
    return c


def _check_keys(keys: torch.Tensor):
    if keys.dtype != torch.int64 or keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"keys: expected int64 (..., 2), got {keys.dtype} "
                         f"{tuple(keys.shape)}")


def _stream(dev):
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _raise(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"threefry {what} kernel launch failed: "
                           + _threefry_fn()[2](rc).decode())


def derive(keys: torch.Tensor, count: int, data=None,
           offset: int = 0) -> torch.Tensor:
    """(..., count, 2) keys: threefry2x32(key, (0, (data + offset + i) mod
    2³²)) for i < count and every key of `keys` (..., 2). `data` is None
    or a 0-d integer tensor on the keys' device; `offset` an int. CPU
    keys go to `derive_reference`; CUDA keys to the kernel's key entry
    (one launch), which adds one to `KEY_LAUNCHES`."""
    global KEY_LAUNCHES
    _check_keys(keys)
    if data is not None and (data.dim() != 0 or data.device != keys.device
                             or data.is_floating_point()):
        raise ValueError(f"data: expected a 0-d integer tensor on "
                         f"{keys.device}, got {data.dtype} "
                         f"{tuple(data.shape)} on {data.device}")
    if not 0 <= count or count * max(keys.numel() // 2, 1) >= 2 ** 31:
        raise ValueError(f"{count} keys from each of {keys.numel() // 2}")
    if keys.device.type == "cpu":
        return derive_reference(keys, count, data, offset)
    if keys.device.type != "cuda":
        raise ValueError(f"no threefry kernel for device {keys.device}")
    dev = keys.device
    keys = keys.contiguous()
    n_keys = keys.numel() // 2
    out = torch.empty(keys.shape[:-1] + (count, 2), dtype=torch.int64,
                      device=dev)
    if out.numel() == 0:
        return out
    d = None if data is None else data.to(torch.int64).reshape(1)
    fn = _threefry_fn()[1]
    rc = fn(keys.data_ptr(), n_keys, count,
            None if d is None else d.data_ptr(), offset & M32,
            out.data_ptr(), _runs_counter(dev).data_ptr(), dev.index,
            _stream(dev))
    _raise(rc, "key")
    if not torch.cuda.is_current_stream_capturing():
        KEY_LAUNCHES += 1
    return out


def uniform(keys: torch.Tensor, shape: Sequence[int], axis: int, lo: int,
            hi: int) -> torch.Tensor:
    """For every key of `keys` (..., 2), the block [lo, hi) along `axis`
    of `jax.random.uniform(key, shape)`:
    keys.shape[:-1] + the block's shape, float32, on the keys' device.
    CPU keys go to `uniform_reference`; CUDA keys to the kernel's
    uniform entry (one launch for every key), which adds one to
    `LAUNCHES`."""
    global LAUNCHES
    _check_keys(keys)
    shape = tuple(int(s) for s in shape)
    if not 0 <= axis < len(shape) or not 0 <= lo <= hi <= shape[axis]:
        raise ValueError(f"window [{lo}, {hi}) on axis {axis} of {shape}")
    if math.prod(shape) >= 2 ** 62:
        raise ValueError(f"a draw of {math.prod(shape)} elements")
    if keys.device.type == "cpu":
        return uniform_reference(keys, shape, axis, lo, hi)
    if keys.device.type != "cuda":
        raise ValueError(f"no threefry kernel for device {keys.device}")
    dev = keys.device
    keys = keys.contiguous()
    n_keys = keys.numel() // 2
    block = shape[:axis] + (hi - lo,) + shape[axis + 1:]
    out = torch.empty(keys.shape[:-1] + block, dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    fn = _threefry_fn()[0]
    rc = fn(keys.data_ptr(), n_keys, math.prod(block),
            math.prod(shape[axis + 1:]), hi - lo, shape[axis], lo,
            int(max(math.prod(shape), out.numel()) >= 2 ** 31), out.data_ptr(),
            _runs_counter(dev).data_ptr(), dev.index, _stream(dev))
    _raise(rc, "uniform")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    return out
