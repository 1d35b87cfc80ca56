"""Compiled calls: a function of static tensors captured once as a CUDA
graph and replayed (the port's counterpart of `jax.jit` for a pass, a
gradient step or a block of march steps; see
`render/renderer.Renderer._pass_fn`, `render/diff.LossAndGrad` and
`render/kerr_scene.DiskMarch`).

A sharded program takes one of two forms. Most are two calls around
their one collective, which runs eagerly between their replays on the
static buffers they share: the renderer's sharded pass (`PassRunner`:
the rank half, the gather, the accumulate half), the sharded gradient
step (`LossAndGrad(mesh=)`: half A, the all-reduce, half B) and the
sharded Kerr batch (its block rendered as a `DiskMarch` graph, then the
gather). No collective is captured there, so any backend serves them,
gloo's host copies included. The per-trace forward
(`render/integrator.Forward` with a mesh, the counterpart of the JAX
package's jitted `est_radiance(mesh=)`) is one call with a gather and
an all-reduce at every trace inside it: under NCCL a capture records
them as kernels, and every rank captures and replays the same calls in
the same order. Its first call, eager, makes the group's first
collective, so that NCCL's communicator exists before the capture. gloo
runs its collectives on the host, and a capture that reaches one raises
(`parallel.distributed._collective`).

While a process group is alive a capture runs in
`capture_error_mode="thread_local"` (`capture_mode`), else in the
default `"global"`. NCCL's watchdog thread queries the events of the
group's collectives on its own clock, and the halves of a sharded
program are captured right after their collective (the accumulate half
of a pass at its second pass, half B of a step at its second call).
Under `"global"` CUDA forbids such a query from any thread while the
main thread captures, and the forbidden call breaks the capture;
`"thread_local"` forbids it in the capturing thread only, which is all a
capture here needs. Synchronising the collective's stream first would
not do: the watchdog may query an event that has already completed at
any time. The kernels a capture records, autograd's included, are the
same in either mode (tests/test_torch_kernel_cuda.py,
`test_capture_right_after_collectives_over_nccl`).

`CapturedCall(fn, device)` holds a function that reads and writes only
tensors made before its first call (its static buffers, updated in place:
the counterpart of `donate_argnums`), reached through the arguments it is
called with. The first call runs `fn` eagerly on a side stream, as
`torch.cuda.graphs` asks of a warm-up, and that run is the call's real
result. The second call captures `fn` into a `torch.cuda.CUDAGraph`
(capture runs nothing and changes no buffer) and replays it; every later
call replays. So a call made once costs no capture. Values that change
from call to call must be device tensors that `fn` reads; host→device
copies and host reads inside `fn` break the capture. A capture that fails
raises, naming the innermost line of this package it was in; nothing
falls back to eager. Autograd inside `fn` (the gradient step's backward)
is captured in either mode.

Random numbers need nothing of a graph: `fn` derives its threefry keys
on the device from its static buffers (`utils.prng`), so a replay draws
what the eager call on the same buffers draws, bit for bit.

A replay runs the trace kernel without its Python wrapper, so
`ops.trace_kernel.LAUNCHES` counts only eager launches (a capture records
and launches nothing); the kernel's own count on the device,
`ops.trace_kernel.kernel_runs()`, sees every run, replays included.
`fn`'s return value (the renderer's trace calls) is the one of the
capture, which every replay repeats. In the same way the collectives'
Python count `parallel.distributed.COLLECTIVES` moves only while `fn`'s
Python runs: a call records the calls and bytes its capture handed to
collectives (`collectives`), takes them back out of the count (a capture
runs none), and adds them at every replay, so that the count is that of
the collectives the device ran.

Set-up and spans (`utils.stats`): the first call runs in the host span
"setup.eager" and the capture in "setup.capture" (`capture_seconds` is
its wall), each ending in a sync of the device, so that set-up is timed
whole. The device spans that `fn` opens while it is captured become
event pairs of the graph (`spans`); every replay records them again, and
while the program's spans are collected each replay reads them
(`stats.replayed`).
"""
from __future__ import annotations

import os
import traceback
from typing import Callable

import torch

from rrt_tpu_torch.parallel.distributed import COLLECTIVES
from rrt_tpu_torch.utils import stats

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def capture_mode() -> str:
    """The `capture_error_mode` of a capture made now: `"thread_local"`
    while a `torch.distributed` process group is alive (its watchdog
    thread queries events during our captures), else `"global"`."""
    dist = torch.distributed
    return "thread_local" if dist.is_available() and dist.is_initialized() \
        else "global"


def _where(exc: BaseException) -> str:
    """file:line and source of the innermost frame of this package in
    exc's traceback (the op that broke a capture)."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if f.filename.startswith(_PKG)
              and not f.filename.endswith(os.path.join("utils", "graphs.py"))]
    if not frames:
        return "outside rrt_tpu_torch"
    f = frames[-1]
    return (f"{os.path.relpath(f.filename, os.path.dirname(_PKG))}:"
            f"{f.lineno} ({f.line})")


class CapturedCall:
    """`fn(*args)` run eagerly once, then captured and replayed. `args`
    must be the same objects at every call (they hold the static buffers;
    a replay does not read them, and the call keeps no reference to them).
    `fn` returns a value that does not change between calls. `pool` is a
    `torch.cuda.graph_pool_handle()` shared with the owner's other
    graphs."""

    def __init__(self, fn: Callable, device, pool=None, name: str = "call"):
        self.fn, self.device, self.pool = fn, torch.device(device), pool
        self.name = name
        self.graph = None
        self.result = None        # fn's return value, kept from the capture
        self.calls = 0
        self.capture_seconds = 0.0
        self.replays = 0
        # the (path, start, end) event pairs of the device spans captured
        self.spans = []
        # calls and bytes of the collectives inside the graph
        self.collectives = {"calls": 0, "bytes": 0}

    def _warm_up(self, *args):
        with stats.span("setup.eager"):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                out = self.fn(*args)
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
        return out

    def _capture(self, *args):
        """fn captured into a new graph, its device spans' events with it;
        returns the graph."""
        graph = torch.cuda.CUDAGraph()
        with stats.recording(self.spans), torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode=capture_mode()):
            self.result = self.fn(*args)
        torch.cuda.synchronize(self.device)
        return graph

    def __call__(self, *args):
        self.calls += 1
        if self.calls == 1:
            return self._warm_up(*args)
        if self.graph is None:
            before = dict(COLLECTIVES)
            try:
                with stats.span("setup.capture") as sp:
                    self.graph = self._capture(*args)
            except Exception as exc:   # noqa: BLE001 — re-raised with context
                raise RuntimeError(
                    f"capturing {self.name} as a CUDA graph failed at "
                    f"{_where(exc)}: {type(exc).__name__}: {exc}") from exc
            finally:
                for k, v in before.items():
                    self.collectives[k] = COLLECTIVES[k] - v
                    COLLECTIVES[k] = v
            self.capture_seconds = sp.seconds
        self.graph.replay()
        stats.replayed(self.spans)
        self.replays += 1
        for k, v in self.collectives.items():
            COLLECTIVES[k] += v
        return self.result


def run_call(call, fn: Callable, *args):
    """`call(*args)` through a `CapturedCall`, or `fn(*args)` eagerly when
    there is none (`call` is None: no graphs)."""
    return fn(*args) if call is None else call(*args)
