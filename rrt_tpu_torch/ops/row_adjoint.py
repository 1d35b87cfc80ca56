"""Row adjoints of a gather: the CUDA kernel's wrapper and its plain
PyTorch version.

A gather `table.<field>[ids]` of a lane batch from a table of a few rows
(the BSDF table, `render/bsdf._gather`) has for adjoint the sum of the
lanes' gradients onto the rows they read. Autograd's adjoint of advanced
indexing is `index_put_(accumulate=True)`, which sorts every lane id and
sums each run of equal ids serially, one launch a field; this replaces it
with one launch a gather for all its fields (`ops/csrc/row_adjoint.cu`),
summed in an order fixed by the grid and with no float atomics, so that
it gives the same bits at every run.

`row_adjoint(ids, grads, rows)`: for every gradient of `grads` (each of
shape ids.shape + (width,) or ids.shape, or None), the (rows, width) or
(rows,) sum of its lanes onto the rows of their ids clamped into [0,
rows − 1]; None stays None. Float32 gradients on a card go to the
kernel; on the CPU, or in another dtype, to the plain version; a tensor
on another device raises.
`LAUNCHES` counts eager launches; `kernel_runs()` and `lanes()` read the
runs and the lanes reduced, as the kernel counted them on the device
(replays included), or as the plain version counted them; `counter(dev)`
is the device's counter tensor itself.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

# the kernel's block width and its warps (ops/csrc/row_adjoint.cu)
THREADS = 256
WARPS = THREADS // 32
MAX_FIELDS = 8
MAX_COLUMNS = 32
# lanes a thread takes at the least before the grid grows past it, and the
# blocks a streaming multiprocessor is given at most
LANES_PER_THREAD = 2
BLOCKS_PER_SM = 2
# shared memory a block may use without asking for more
SHARED_BYTES = 48 * 1024

# eager launches (a launch recorded into a CUDA graph is not one)
LAUNCHES = 0
# device -> (2,) int64 counters: [runs, lanes reduced]; on a card in device
# memory, added to by the kernel at each run, launched or replayed
_COUNTS: dict = {}


def _flat(ids: torch.Tensor, g: torch.Tensor, rows: int):
    """(n, width) view of a gradient of the lanes of `ids`, and the shape
    of its adjoint."""
    tail = tuple(g.shape[ids.dim():])
    if tuple(g.shape[:ids.dim()]) != tuple(ids.shape) or len(tail) > 1:
        raise ValueError(f"gradient of shape {tuple(g.shape)} for ids of "
                         f"shape {tuple(ids.shape)}")
    return g.reshape(ids.numel(), math.prod(tail)), (rows,) + tail


def row_adjoint_reference(ids: torch.Tensor,
                          grads: Sequence[Optional[torch.Tensor]],
                          rows: int) -> list:
    """The plain version of `row_adjoint`: `index_add_` in the gradient's
    dtype, on the gradient's device."""
    i = torch.clamp(ids.reshape(-1), 0, rows - 1).long()
    outs = []
    for g in grads:
        if g is None:
            outs.append(None)
            continue
        flat, shape = _flat(ids, g, rows)
        out = torch.zeros((rows, flat.shape[1]), dtype=g.dtype,
                          device=g.device).index_add_(0, i, flat)
        outs.append(out.reshape(shape))
    return outs


# ---------------------------------------------------------------- kernel

_FN = None


def _row_adjoint_fn():
    """The library's entry points, resolved once per process."""
    global _FN
    if _FN is None:
        from rrt_tpu_torch.ops import build
        lib = build.load_library("row_adjoint")
        _FN = (lib.rrt_row_adjoint, lib.rrt_row_adjoint_error_string)
    return _FN


def _counts(dev) -> torch.Tensor:
    """The device's counters, made at its first eager call (made in a
    capture, they would be a graph's buffer that a replay resets)."""
    c = _COUNTS.get(dev)
    if c is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the row-adjoint kernel's first launch on a "
                               "device cannot be inside a CUDA graph capture")
        c = _COUNTS[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    return c


def counter(dev) -> torch.Tensor:
    """The (2,) int64 counter [runs, lanes reduced] that the calls on
    `dev` add to, made here at its first use (outside a capture)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _counts(dev)


def kernel_runs() -> int:
    """Runs since the last `reset_counts`, replays included. Waits for the
    devices."""
    return sum(int(c[0].item()) for c in _COUNTS.values())


def lanes() -> int:
    """Lanes reduced since the last `reset_counts`, replays included.
    Waits for the devices."""
    return sum(int(c[1].item()) for c in _COUNTS.values())


def reset_counts():
    """`LAUNCHES` and the counters set to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for c in _COUNTS.values():
        c.zero_()


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def grid(n: int, sms: int) -> int:
    """The kernel's blocks for n lanes on a card of `sms` SMs: enough for
    `LANES_PER_THREAD` lanes a thread, at most `BLOCKS_PER_SM` a SM."""
    need = -(-n // (THREADS * LANES_PER_THREAD))
    return max(1, min(need, BLOCKS_PER_SM * sms))


def row_adjoint(ids: torch.Tensor, grads: Sequence[Optional[torch.Tensor]],
                rows: int) -> list:
    """The row adjoints of the gradients `grads` of a gather by `ids` from
    a table of `rows` rows (see the module's docstring): one launch of the
    kernel for all of them on a card, `row_adjoint_reference` on the CPU
    or for gradients other than float32."""
    global LAUNCHES
    grads = list(grads)
    live = [k for k, g in enumerate(grads) if g is not None]
    if rows < 1 or len(live) > MAX_FIELDS:
        raise ValueError(f"{len(live)} gradients onto {rows} rows")
    dev = ids.device
    if any(grads[k].device != dev for k in live):
        raise ValueError("the ids and the gradients lie on other devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no row adjoint for device {dev}")
    if dev.type == "cpu" or any(grads[k].dtype != torch.float32
                                for k in live):
        if live:
            c = _counts(dev)
            c[0] += 1
            c[1] += ids.numel()
        return row_adjoint_reference(ids, grads, rows)
    if ids.dtype != torch.int64:
        raise ValueError(f"ids: expected int64, got {ids.dtype}")
    outs = [None] * len(grads)
    if not live:
        return outs
    flats, widths = [], []
    for k in live:
        g = grads[k]
        flat, shape = _flat(ids, g, rows)
        if flat.shape[1] < 1:
            raise ValueError(f"gradient {k} of shape {tuple(g.shape)}")
        flats.append(flat.contiguous())
        widths.append(flat.shape[1])
        outs[k] = torch.empty(shape, dtype=torch.float32, device=dev)
    ids = ids.contiguous()
    n, cols = ids.numel(), sum(widths)
    if cols > MAX_COLUMNS:
        raise ValueError(f"{cols} gradient columns, at most {MAX_COLUMNS}")
    blocks = grid(n, _sms(dev.index))
    block_sums = torch.empty(blocks * rows * cols, dtype=torch.float32,
                             device=dev)
    warp_partials = None
    if WARPS * (32 + rows) * cols * 4 > SHARED_BYTES:
        warp_partials = torch.empty(blocks * WARPS * rows * cols,
                                    dtype=torch.float32, device=dev)
    m = len(live)
    fn, err = _row_adjoint_fn()
    rc = fn(ids.data_ptr(), n, rows, m,
            (ctypes.c_void_p * m)(*[f.data_ptr() for f in flats]),
            (ctypes.c_void_p * m)(*[outs[k].data_ptr() for k in live]),
            (ctypes.c_int * m)(*widths), blocks, block_sums.data_ptr(),
            None if warp_partials is None else warp_partials.data_ptr(),
            _counts(dev).data_ptr(), dev.index,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError("row-adjoint kernel launch failed: "
                           + err(rc).decode())
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1
    return outs
