"""The traced window: a `torch.profiler` trace of a few frames or steps,
reduced to what the per-layer readers take.

The arithmetic is a copy of the port's `utils/profile.py`: a device
event is a kernel, copy or fill on the card (a `record_function` range
shown on the device is not one); the host's launches are its runtime
launch calls; the trace kernel's events hold `trace_kernel` in their
name and NCCL's hold `nccl`. Kernels inside a replayed CUDA graph are
traced too. The busy seconds are the union of the device events'
intervals (`busy_compute_s`: NCCL's left out); the window runs from the
trace's start to its last sync.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

# the host's launch calls as the profiler's runtime events name them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemsetAsync", "cudaMemcpyAsync",
                "cudaGraphLaunch")
TRACE_KERNEL = "trace_kernel"
NCCL = "nccl"
TOP = 10


def _on_device(ev) -> bool:
    return (ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False))


def _union_us(spans) -> float:
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(events, window_s: float, units: int) -> dict:
    """The per-layer readers' view of one rank's trace of `units` frames
    or steps over `window_s` seconds."""
    dev = [ev for ev in events if _on_device(ev)]
    host = [ev for ev in events
            if ev.device_type == torch.autograd.DeviceType.CPU]
    by_name = collections.defaultdict(float)
    for ev in dev:
        by_name[ev.name] += ev.time_range.elapsed_us() / 1e6
    spans = [(ev.time_range.start, ev.time_range.end) for ev in dev]
    busy_us = _union_us(spans)
    compute_us = _union_us([(ev.time_range.start, ev.time_range.end)
                            for ev in dev if NCCL not in ev.name.lower()])
    device_s = sum(by_name.values())
    trace_s = sum(s for n, s in by_name.items() if TRACE_KERNEL in n)
    nccl_s = sum(s for n, s in by_name.items() if NCCL in n.lower())
    launches = sum(1 for ev in host if ev.name in LAUNCH_CALLS)
    return dict(units=units, window_s=window_s, busy_s=busy_us / 1e6,
                busy_compute_s=compute_us / 1e6,
                device_s=device_s, trace_s=trace_s, nccl_s=nccl_s,
                host_launches=launches,
                device_ops=sorted(by_name.items(), key=lambda r: -r[1])[:TOP],
                idle_gaps=_idle_gaps(spans, host))


def _idle_gaps(spans, host) -> list:
    """The longest gaps between device events, summed by the innermost
    host op running at each gap's middle: [(name, seconds)]."""
    spans = sorted(spans)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:200]
    starts = np.array([ev.time_range.start for ev in host], np.float64)
    ends = np.array([ev.time_range.end for ev in host], np.float64)
    by_op = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (host[inside[np.argmin(ends[inside] - starts[inside])]].name
                if inside.size else "host: outside any traced op")
        by_op[name] += (b - a) / 1e6
    return sorted(by_op.items(), key=lambda r: -r[1])[:TOP]


def trace_units(fn, units: int, device) -> dict:
    """Profile `units` calls of `fn` (each a frame or a step that ends in
    a device sync) and summarise them."""
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(units):
            fn(i)
        if cuda:
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    return summarize(prof.events(), window, units)


def breakdown(summaries) -> dict:
    """The ledger's breakdown from the ranks' summaries: the device ops
    and the idle gaps of the slowest rank (the one with most device
    time)."""
    slow = max(summaries, key=lambda s: s["device_s"])
    return {"device_ops": [[n, s] for n, s in slow["device_ops"]],
            "idle_gaps": [[n, s] for n, s in slow["idle_gaps"]]}
