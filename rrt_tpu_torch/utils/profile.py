"""Where a render's time goes on a CUDA card.

`profile_render(renderer)` times a few warm renders on the host clock (each
ends in the device read-back of `Renderer.render`), reads the peak device
memory over them, and takes one `torch.profiler` trace of a further render:
its wall time, the summed time of the device events (kernels, copies,
fills; one stream, so they do not overlap), the kernels that took most
of it, and the host's launches per pass: the launch calls the host made
(`host_launches`: kernel launches, memsets, copies and graph launches,
from the trace's runtime events), of which a captured pass is one graph
launch plus the few eager ops around it. Device time by kernel name
counts the kernels inside a replayed graph too. `python3 chip_smoke.py`
prints its report for the main path.

`profile_call(fn, ranges)` traces one call and splits its device time:
the trace kernel's launches, each named range's ops (the program's
spans, `utils.stats`, open a `record_function` range of their name:
`geometry.trace.trace_diff`'s "trace_diff.replay", `scene.envmap`'s
"envmap.sample_L" and "envmap.sample_dir") with the backward nodes of
those ops, and the rest.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import torch


@dataclasses.dataclass
class RenderProfile:
    walls: list            # seconds of each warm render
    peak_mib: float        # peak allocated device memory over them
    profiled_wall: float   # seconds of the profiled render
    device_ms: float       # summed device-event time of that render
    top: list              # (name, launches, device ms), largest first
    passes: int = 0        # passes in the profiled render
    host_launches: int = 0   # launch calls of the host in it
    graph_launches: int = 0  # of them, graph replays

    def report(self) -> str:
        lines = [
            "warm render walls (s): "
            + ", ".join(f"{w:.4f}" for w in self.walls),
            f"peak device memory: {self.peak_mib:.1f} MiB",
            launch_line(self.host_launches, self.graph_launches,
                        self.passes)]
        if self.device_ms <= 0.0:
            lines.append("device time: not measured (the profiler saw no "
                         "device events)")
            return "\n".join(lines)
        wall_ms = 1e3 * self.profiled_wall
        lines.append(f"profiled render: wall {wall_ms:.1f} ms, device "
                     f"{self.device_ms:.1f} ms ({self.device_ms / wall_ms:.1%}"
                     " busy)")
        for name, n, ms in self.top:
            lines.append(f"  {ms:9.3f} ms {ms / self.device_ms:6.1%} "
                         f"{n:6d}x {name}")
        return "\n".join(lines)


def _on_device(ev) -> bool:
    """A device event that is a kernel, copy or fill: a `record_function`
    range shows on the device too, spanning its kernels and the gaps
    between them, and is not counted."""
    return (ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False))


# the host's launch calls as the profiler's runtime events name them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemsetAsync", "cudaMemcpyAsync",
                "cudaGraphLaunch")


def host_launches(events):
    """(launch calls, graph launches) of the host in a trace's events."""
    names = [ev.name for ev in events
             if ev.device_type == torch.autograd.DeviceType.CPU
             and ev.name in LAUNCH_CALLS]
    return len(names), names.count("cudaGraphLaunch")


def launch_line(n: int, graphs: int, passes: int) -> str:
    if n == 0:
        return "host launches: not measured (the profiler saw no runtime " \
               "launch calls)"
    per = f", {n / passes:.1f} a pass over {passes}" if passes else ""
    return f"host launches: {n}{per} ({graphs} graph replays)"


def passes_run(renderer) -> int:
    """Passes `renderer` has run so far, over all its pass shapes."""
    return sum(r.passes for r in renderer._pass_fns.values())


def _by_name(events, skip=()):
    """(name, launches, device ms) of the device events by kernel name,
    largest first; names in `skip` are left out."""
    per_name = collections.defaultdict(lambda: [0, 0.0])
    for ev in events:
        if _on_device(ev) and ev.name not in skip:
            acc = per_name[ev.name[:100]]
            acc[0] += 1
            acc[1] += ev.time_range.elapsed_us() / 1e3
    return sorted(((k, n, ms) for k, (n, ms) in per_name.items()),
                  key=lambda r: -r[2])


def profile_render(renderer, reps: int = 5, top: int = 8) -> RenderProfile:
    """Profile `renderer` (a `Renderer` on a CUDA device): one untimed
    render, `reps` timed ones, one traced one."""
    dev = renderer.device
    if dev.type != "cuda":
        raise ValueError(f"profile_render needs a CUDA renderer, not {dev}")
    renderer.render()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        renderer.render()
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    passes = passes_run(renderer)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        renderer.render()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    events = prof.events()
    rows = _by_name(events)
    n, graphs = host_launches(events)
    return RenderProfile(walls=walls, peak_mib=peak, profiled_wall=wall,
                         device_ms=sum(r[2] for r in rows), top=rows[:top],
                         passes=passes_run(renderer) - passes,
                         host_launches=n, graph_launches=graphs)


TRACE_KERNEL = "trace_kernel"   # the trace kernel's launches hold this name
CALL_TOP = 6                    # the heaviest kernels a CallProfile lists


@dataclasses.dataclass
class CallProfile:
    wall: float        # seconds of the profiled call
    device_ms: float   # summed device-event time
    kernel_ms: float   # of it, the trace kernel's launches
    ranges: dict       # range name -> (forward ms, backward ms) of device
    top: list = dataclasses.field(default_factory=list)  # as RenderProfile's
    launches: int = 0  # device events (kernels, copies, fills) in the call
    host_launches: int = 0   # launch calls of the host (`host_launches`)
    graph_launches: int = 0  # of them, graph replays
    # of device_ms, NCCL's kernels: a collective's kernel runs from its
    # launch until every peer has joined, so it counts their lateness too
    nccl_ms: float = 0.0

    def report(self) -> str:
        parts = [f"wall {1e3 * self.wall:.1f} ms, device "
                 f"{self.device_ms:.1f} ms, trace kernel "
                 f"{self.kernel_ms:.1f} ms"]
        rest = self.device_ms - self.kernel_ms
        for name, (f, b) in self.ranges.items():
            parts.append(f"{name} {f:.1f} ms forward + {b:.1f} ms backward")
            rest -= f + b
        parts.append(f"everything else {rest:.1f} ms")
        return ", ".join(parts) + "".join(
            f"\n  {ms:9.3f} ms {n:6d}x {name[:90]}" for name, n, ms in self.top)


def range_ops(events, name):
    """The host ops inside the spans of the `record_function` range `name`
    (same thread), and the autograd nodes that run their backward (matched
    by sequence number): returns (ops, backward nodes)."""
    host = [ev for ev in events
            if ev.device_type == torch.autograd.DeviceType.CPU]
    spans = [ev for ev in host if ev.name == name]
    inside = [ev for ev in host if any(
        sp.thread == ev.thread
        and sp.time_range.start <= ev.time_range.start
        and ev.time_range.end <= sp.time_range.end for sp in spans)]
    seqs = {ev.sequence_nr for ev in inside if ev.sequence_nr >= 0}
    bwd = [ev for ev in host
           if ev.name.startswith("autograd::engine::evaluate_function")
           and ev.sequence_nr in seqs]
    return inside, bwd


def split_device_time(events, ranges=()):
    """Split the device time of a trace's events: returns (device ms,
    trace kernel ms, {range: (forward ms, backward ms)}, rows of
    `_by_name`). A range's forward time is that of the kernels its ops
    launched themselves; its backward time the device time of the
    autograd nodes of those ops. A range's own span on the device is
    linked to the range like a kernel, and left out."""
    rows = _by_name(events, skip=ranges)
    out = {}
    for name in ranges:
        inside, bwd = range_ops(events, name)
        fwd_us = sum(k.duration for ev in inside for k in ev.kernels
                     if k.name not in ranges)
        out[name] = (fwd_us / 1e3,
                     sum(ev.device_time_total for ev in bwd) / 1e3)
    return (sum(ms for _, _, ms in rows),
            sum(ms for name, _, ms in rows if TRACE_KERNEL in name),
            out, rows)


def profile_call(fn, ranges=(), device=None) -> CallProfile:
    """Trace one call of fn (which ends in a device sync) on `device`, a
    CUDA device, and split its device time (`split_device_time`)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = prof.events()
    device_ms, kernel_ms, out, rows = split_device_time(events, ranges)
    n, graphs = host_launches(events)
    return CallProfile(wall=wall, device_ms=device_ms, kernel_ms=kernel_ms,
                       ranges=out, top=rows[:CALL_TOP],
                       launches=sum(n for _, n, _ in rows),
                       host_launches=n, graph_launches=graphs,
                       nccl_ms=sum(ms for name, _, ms in rows
                                   if "nccl" in name.lower()))
