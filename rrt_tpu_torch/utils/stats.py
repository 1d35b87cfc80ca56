"""Render statistics, and the program's spans and counters.

`RenderStats` and `expected_stats` are the port's copy of
`rrt_tpu/utils/stats.py`. The reference's only perf telemetry is
CGL::Timer wall-clocks and the BVH counters `total_rays`/`total_isects`
printed at completion (`pathtracer.cpp:636-638`, `bvh.h:140`). Here the
trace counts are computed from the render configuration and the measured
sample counts, and the traversal work comes from the trace kernel's
counters.

**Spans.** `span(name)` names a stretch of the program. Every span opens
a `torch.profiler.record_function(name)`, so that a profiler shows it on
its own clock beside the device's kernels, and adds its host seconds to
`HOST`, keyed by its path: the names of the spans open around it,
outermost first, and its own. A host span (`span(name)`) is measured
there alone. A device span (`span(name, device)`) measures the device
work its ops enqueue: on a CUDA device by a pair of timing events
recorded on the current stream, on the CPU, where ops run as they are
called, by the host clock. Inside a CUDA graph capture the events become
event-record nodes of the graph, not kernels: the pairs belong to the
call being captured (`recording`, which `utils/graphs.CapturedCall`
opens), and every replay of the graph records them again. Spans nest: a
device span's path holds the device spans around it, and a span's self
time is its seconds less those of the spans directly inside it. Open
spans are a thread's own; inside `lend()` a thread's innermost span also
holds the spans that other threads open outside any of theirs (autograd's
thread of a CUDA backward).

**Collection.** Device times and counters are read only while
collecting: while a `torch.profiler` is active, or inside `collect()`.
Then each replay that holds device spans waits for its last event and
adds its pairs' elapsed times (`replayed`; the next replay overwrites the
events), and an eager call's pairs are read when the outermost open span
closes. Otherwise a replay and an eager call sync and read nothing, and
eager device spans record no events. `COLLECTED` holds what was
collected: the device spans by their path among device spans, the host
spans closed meanwhile, and the counters (`count`) by name.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import torch

from rrt_tpu_torch.physics.schwarzschild import n_segments
from rrt_tpu_torch.utils.config import Illum, RenderConfig


@dataclasses.dataclass
class RenderStats:
    """Trace-call accounting for one render (reference counters analog)."""

    camera_rays: int = 0
    shadow_rays: int = 0
    bounce_rays: int = 0
    geodesic_segments_max: int = 0
    wall_seconds: float = 0.0
    # MEASURED traversal work from the trace kernel's counters: primitive
    # tests and bbox slab tests actually paid, summed over every traced
    # lane. The reference's analog: total_isects, avg ~112 tests/ray on
    # CBbunny (bvh.h:140, pathtracer.cpp:637-638).
    measured_isect_tests: float = 0.0
    measured_bbox_tests: float = 0.0

    @property
    def total_rays(self):
        """= the reference's BVHAccel::total_rays (every bvh->intersect)."""
        return self.camera_rays + self.shadow_rays + self.bounce_rays

    @property
    def isect_tests_per_ray(self) -> float:
        """Measured primitive tests per trace (reference prints ~112 on
        CBbunny config 2)."""
        return self.measured_isect_tests / max(self.total_rays, 1)

    def report(self) -> str:
        lines = [
            f"[PathTracer] Traced {self.total_rays} rays "
            f"({self.camera_rays} camera, {self.shadow_rays} shadow, "
            f"{self.bounce_rays} bounce).",
        ]
        if self.measured_isect_tests:
            lines.append(
                f"[PathTracer] Averaged {self.isect_tests_per_ray:.1f} "
                f"primitive tests and "
                f"{self.measured_bbox_tests / max(self.total_rays, 1):.1f} "
                f"bbox tests per ray (kernel-measured).")
        if self.geodesic_segments_max:
            lines.append(
                f"[PathTracer] Geodesic marching: up to "
                f"{self.geodesic_segments_max} segments per ray.")
        if self.wall_seconds:
            lines.append(
                f"[PathTracer] {self.total_rays / self.wall_seconds:.3g} "
                f"rays/sec over {self.wall_seconds:.2f} sec.")
        return "\n".join(lines)


def expected_stats(cfg: RenderConfig, n_lights_total_samples: int,
                   total_lane_samples: int) -> RenderStats:
    """Exact trace counts for a render.

    n_lights_total_samples = Σ over lights of (1 if delta else
    ns_area_light) — the per-vertex NEE batch height.
    total_lane_samples = Σ over pixels of the measured per-pixel sample
    count (exact under adaptive sampling, not a mean).
    """
    lanes = total_lane_samples
    st = RenderStats(camera_rays=lanes)
    md = cfg.max_ray_depth
    if cfg.illum == Illum.NORMAL:
        pass
    elif cfg.illum == Illum.DIRECT:
        st.shadow_rays = lanes * n_lights_total_samples
    else:
        n_vertices = md if md >= 1 else 0
        if cfg.illum == Illum.INDIRECT:
            # the first vertex skips its whole NEE call (occlusion trace
            # included) — integrator.est_radiance vertex(first=True)
            n_vertices = max(md - 1, 0)
        st.shadow_rays = lanes * n_lights_total_samples * n_vertices
        st.bounce_rays = lanes * max(md - 1, 0)
    if cfg.black_hole.enabled:
        st.geodesic_segments_max = n_segments(cfg.black_hole.delta_theta)
    return st


# ------------------------------------------------------------ spans


class Tally(dict):
    """Seconds by span path: path -> [seconds, seconds of the spans
    directly inside, spans closed]."""

    def add(self, path: Tuple[str, ...], seconds: float):
        row = self.setdefault(path, [0.0, 0.0, 0])
        row[0] += seconds
        row[2] += 1
        if len(path) > 1:
            self.setdefault(path[:-1], [0.0, 0.0, 0])[1] += seconds

    def _outermost(self, name: str):
        return [r for p, r in self.items()
                if p[-1] == name and name not in p[:-1]]

    def seconds(self, name: str) -> float:
        """Seconds of the spans `name`, a span inside one of the same name
        left out."""
        return sum(r[0] for r in self._outermost(name))

    def count(self, name: str) -> int:
        """Spans `name` closed, a span inside one of the same name left
        out."""
        return sum(r[2] for r in self._outermost(name))

    def self_seconds(self, names: Optional[Iterable[str]] = None,
                     under: Optional[str] = None,
                     skip: Iterable[str] = ()) -> float:
        """Self seconds summed over the spans named in `names` (every span
        without), of them those inside a span `under` or named so when
        given, the spans named in `skip` left out."""
        names = None if names is None else set(names)
        skip = set(skip)
        return sum(s - c for p, (s, c, _) in self.items()
                   if (names is None or p[-1] in names)
                   and (under is None or under in p) and p[-1] not in skip)


@dataclasses.dataclass
class Collection:
    """What was collected: device spans by their path among device spans,
    host spans by their host path, counters by name."""

    device: Tally = dataclasses.field(default_factory=Tally)
    host: Tally = dataclasses.field(default_factory=Tally)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __bool__(self) -> bool:
        return bool(self.device or self.host or self.counters)

    def clear(self):
        self.device.clear()
        self.host.clear()
        self.counters.clear()

    def per_unit(self, unit: str, **select) -> Optional[float]:
        """Self seconds of the device spans that `Tally.self_seconds(
        **select)` sums, a host span `unit` collected (a frame's
        "render.frame", a step's "step"); None when none was."""
        n = self.host.count(unit)
        return self.device.self_seconds(**select) / n if n else None


HOST = Tally()              # every span's host seconds, always
COLLECTED = Collection()    # read while collecting
_HOST_SPANS: Dict[str, None] = {}   # names of host spans, in first-seen order
_FORCED = 0                 # open `collect()` blocks
_LOCAL = threading.local()  # this thread's open spans, eager pairs, sink
_LENT = None                # the open `lend()` block's `_Lent`


class _Lent(NamedTuple):
    """What `lend()` lends: the lending thread, its innermost open span,
    its capture's sink and its eager pairs."""

    thread: int
    span: Optional["span"]
    sink: Optional[list]
    pending: list


def _local(attr: str, make):
    v = getattr(_LOCAL, attr, None)
    if v is None:
        v = make()
        setattr(_LOCAL, attr, v)
    return v


def collecting() -> bool:
    """Are device spans and counters read now (a profiler is active, or a
    `collect()` block is open)?"""
    return _FORCED > 0 or torch.autograd._profiler_enabled()


@contextlib.contextmanager
def collect():
    """Collect inside the block, as under a profiler; yields
    `COLLECTED`."""
    global _FORCED
    _FORCED += 1
    try:
        yield COLLECTED
    finally:
        _FORCED -= 1


def reset():
    """Forget every span and counter measured so far."""
    HOST.clear()
    COLLECTED.clear()
    _HOST_SPANS.clear()
    _local("pending", list).clear()


def count(name: str, value):
    """Add `value` to the counter `name` while collecting."""
    if collecting():
        COLLECTED.counters[name] = COLLECTED.counters.get(name, 0.0) \
            + float(value)


@contextlib.contextmanager
def lend():
    """Inside the block, a span that another thread opens outside any span
    of its own nests in this thread's innermost open span, and its device
    events go where this thread's would: into the pairs of the call being
    captured, or the eager pairs that this thread reads when its outermost
    span closes. Autograd runs a CUDA backward on a thread of its own while
    the thread that called it waits (`render/diff`'s "step.backward")."""
    global _LENT
    stack = _local("stack", list)
    prev = _LENT
    _LENT = _Lent(threading.get_ident(), stack[-1] if stack else None,
                  getattr(_LOCAL, "sink", None), _local("pending", list))
    try:
        yield
    finally:
        _LENT = prev


@contextlib.contextmanager
def recording(pairs: list):
    """The device spans opened in the block while a CUDA graph is being
    captured append their (path, start, end) event pairs to `pairs`."""
    prev = getattr(_LOCAL, "sink", None)
    _LOCAL.sink = pairs
    try:
        yield pairs
    finally:
        _LOCAL.sink = prev


def _read(pairs, last_only=False):
    """Wait for the event `pairs` (for the last one alone with `last_only`:
    pairs recorded on one stream, in order) and add their times."""
    for *_, end in pairs[-1:] if last_only else pairs:
        end.synchronize()
    for path, start, end in pairs:
        COLLECTED.device.add(path, start.elapsed_time(end) / 1e3)


def replayed(pairs: list):
    """After a replay of a graph that holds the event `pairs`, captured on
    one stream: while collecting, wait for its last event and add their
    times."""
    if pairs and collecting():
        _read(pairs, last_only=True)


class span:
    """`with span(name):` a host span; `with span(name, device):` a device
    span on `device` (see the module's docstring). `@span(name)` makes a
    function's every call a host span."""

    __slots__ = ("name", "device", "path", "dpath", "rf", "t0", "pair",
                 "seconds")

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = None if device is None else torch.device(device)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned

    def __enter__(self):
        stack = _local("stack", list)
        lent = _LENT if not stack and _LENT is not None \
            and _LENT.thread != threading.get_ident() else None
        outer = stack[-1] if stack else lent.span if lent else None
        self.path = (outer.path if outer else ()) + (self.name,)
        self.dpath = outer.dpath if outer else ()
        self.pair = None
        dev = self.device
        if dev is not None:
            self.dpath += (self.name,)
            if dev.type == "cuda":
                capturing = torch.cuda.is_current_stream_capturing()
                if capturing:
                    sink = lent.sink if lent else getattr(_LOCAL, "sink",
                                                          None)
                elif collecting():
                    sink = lent.pending if lent else _local("pending", list)
                else:
                    sink = None
                if sink is not None:
                    start = torch.cuda.Event(enable_timing=True,
                                             external=capturing)
                    start.record(torch.cuda.current_stream(dev))
                    self.pair = (sink, start, capturing)
        else:
            _HOST_SPANS.setdefault(self.name)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = self.seconds = time.perf_counter() - self.t0
        stack = _local("stack", list)
        stack.pop()
        if self.pair is not None:
            sink, start, capturing = self.pair
            end = torch.cuda.Event(enable_timing=True, external=capturing)
            end.record(torch.cuda.current_stream(self.device))
            sink.append((self.dpath, start, end))
        self.rf.__exit__(*exc)
        HOST.add(self.path, seconds)
        if collecting():
            if self.device is None:
                COLLECTED.host.add(self.path, seconds)
            elif self.device.type != "cuda":
                COLLECTED.device.add(self.dpath, seconds)
        pending = getattr(_LOCAL, "pending", None)
        if not stack and pending:
            _read(pending)
            pending.clear()
        return False


def report() -> str:
    """The host spans' seconds, one entry a name: `name: seconds`, then
    the counters collected: `name: value`."""
    return " | ".join([f"{name}: {HOST.seconds(name):.2f}s"
                       for name in _HOST_SPANS]
                      + [f"{name}: {value:.0f}" for name, value
                         in COLLECTED.counters.items()])
