"""Lanes over processes: the port of `rrt_tpu/parallel/sharding.py`.

The JAX package shards the flat ray-lane axis of every batch over a 1-D
device mesh ("batch" axis) and lets GSPMD run the wavefront per device.
The port runs one process per card (the torch idiom): a `LaneMesh` is a
`torch.distributed` process group with this rank's device, and a rank
takes a contiguous block of each batch's lanes, the block that JAX's
`P("batch")` gives device `rank`. Scene tables are replicated; only
results, counters and gradients cross ranks (`parallel/distributed.py`).

A sharded render's random numbers equal the single-process render's: a
rank computes its block of each draw of the whole batch, whose threefry
counters are the elements' flat indices in the whole draw
(`utils.prng.uniform(window=)`), as JAX's partitionable threefry does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rrt_tpu_torch.types import Rays

BATCH_AXIS = "batch"

_ENV_NAMES = "RRT_COORDINATOR, RRT_NUM_PROCESSES and RRT_PROCESS_ID"


@dataclasses.dataclass(frozen=True)
class LaneMesh:
    """The ranks that share a batch's lanes. `group` is the process group,
    or None for a world of 1 without one (collectives are then the
    identity)."""

    group: Optional[object]
    rank: int
    world: int
    device: torch.device
    backend: Optional[str]


@dataclasses.dataclass(frozen=True)
class LaneSharding:
    """The leading lane axis split over `mesh` in contiguous blocks, one
    per rank in rank order (JAX's `NamedSharding(mesh, P("batch"))`)."""

    mesh: LaneMesh


def _one_device(d) -> torch.device:
    """A device; `cuda` without an index is the process's current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices='cpu' "
                               "to shard lanes on the CPU")
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None) -> LaneMesh:
    """The lane mesh of this process. Under an initialised default process
    group, its world, with this rank on `devices[rank]` (a single device
    stands for every rank) or, without `devices`, on its current card.
    Without a group, a world of 1 on the one device given (default: the
    current card). One process drives one device: more than one device
    without a group is an error."""
    import torch.distributed as dist
    single = devices is None or isinstance(devices, (str, torch.device))
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        dev = devices if single else list(devices)[rank]
        return LaneMesh(dist.group.WORLD, rank, world,
                        _one_device("cuda" if dev is None else dev),
                        dist.get_backend())
    if not single:
        devices = list(devices)
        if len(devices) != 1:
            raise ValueError(
                f"{len(devices)} devices without a process group: the port "
                f"drives one device per process; start one process per "
                f"device with {_ENV_NAMES} set (parallel.distributed."
                f"initialize_from_env)")
        devices = devices[0]
    return LaneMesh(None, 0, 1,
                    _one_device("cuda" if devices is None else devices), None)


def batch_sharding(mesh: LaneMesh) -> LaneSharding:
    """Shard the leading (lane) axis; trailing axes whole."""
    return LaneSharding(mesh)


def replicate(tree, mesh: LaneMesh):
    """Every tensor leaf of `tree` on the mesh's device, with rank 0's
    values on every rank."""
    from rrt_tpu_torch.parallel.distributed import replicate_global
    return replicate_global(tree, mesh)


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k


def shard_bounds(n: int, rank: int, world: int):
    """This rank's lanes [lo, hi) of the padded count
    `pad_to_multiple(n, world)`: equal contiguous blocks in rank order.
    `hi` may pass n on the last ranks; the lanes past n are padding."""
    b = pad_to_multiple(n, world) // world
    return rank * b, (rank + 1) * b


def map_tensors(fn, tree):
    """`fn` applied to every tensor leaf of a dataclass, tuple, list or dict
    of tensors; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


def shard_batch(tree, mesh: LaneMesh):
    """This rank's block (`shard_bounds`) of the leading axis of every
    tensor leaf, on the mesh's device; lanes past the end are zeros."""
    def block(a):
        n = a.shape[0]
        lo, hi = shard_bounds(n, mesh.rank, mesh.world)
        out = a[lo:min(hi, n)].to(mesh.device)
        if out.shape[0] < hi - lo:
            out = torch.cat([out, out.new_zeros(
                (hi - lo - out.shape[0],) + tuple(a.shape[1:]))])
        return out
    return map_tensors(block, tree)


def pad_dead_lanes(rays: Rays, n_pad: int, bh) -> Rays:
    """`rays` (lane axis leading) padded to n_pad lanes with rays that end
    at once, as `_trace_sharded` pads (rrt_tpu/geometry/trace.py:530-545):
    origin at the hole's centre (dead on segment 0) in curved mode, d =
    (1, 0, 0), min_t 0 and max_t -1 (an empty range in flat mode)."""
    n = rays.min_t.shape[0]
    pad = n_pad - n
    if pad <= 0:
        return rays
    o = rays.o
    curved = bh is not None and bh.enabled
    po = bh.position.to(o) if curved else o.new_zeros(3)
    # the fills are made on the device by fill kernels: a host copy (a
    # tensor from Python values, or an item assignment) breaks a capture
    x_axis = rays.d.new_zeros(3)
    x_axis[:1].fill_(1.0)

    def cat(a, fill):
        return torch.cat([a, fill.expand((pad,) + tuple(a.shape[1:]))])
    return Rays(o=cat(o, po), d=cat(rays.d, x_axis),
                min_t=cat(rays.min_t, rays.min_t.new_zeros(())),
                max_t=cat(rays.max_t, rays.max_t.new_full((), -1.0)))
