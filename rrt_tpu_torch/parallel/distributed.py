"""Several processes: `torch.distributed` set-up and the collectives the
lane-sharded paths use. The port of `rrt_tpu/parallel/distributed.py`.

The JAX package runs one SPMD program per host under
`jax.distributed.initialize` and lets GSPMD insert the collectives. The
port runs one process per device in a `torch.distributed` process group:
NCCL between cards, gloo on the CPU. Every rank holds the scene, traces
its block of each batch's lanes, and the collectives below put the
results together:

  initialize(...)        — explicit coordinator / world size / rank
  initialize_from_env()  — RRT_COORDINATOR / RRT_NUM_PROCESSES /
                           RRT_PROCESS_ID
  global_mesh()          — the LaneMesh of the whole world
  make_global_batch(...) — this rank's lanes and their global window
  all_gather_lanes(...)  — the ranks' blocks put together in rank order
                           (pack_lanes → gather_packed → unpack_lanes)
  all_reduce_sum/_max    — counters, gradients, agreed stop flags
                           (pack_flat / unpack_flat around one flat buffer)
  all_processes_done()   — barrier (around checkpoint and image writes)

Every collective goes through `_collective`, which counts its calls and
the bytes this rank hands it in `COLLECTIVES`. The transport follows the
backend: NCCL takes device tensors, gloo host copies.

A compiled sharded program takes one of two forms. The renderer's pass
and the gradient step are two CUDA graphs around their one collective:
the first graph writes the collective's input into a static buffer (the
pass its block of radiance, the step its loss and gradients packed
flat), the collective runs eagerly between the replays, and the second
graph reads its static output, so every backend serves them, gloo's host
copies included. The per-trace forward (`render/integrator.Forward`
with a mesh) is one graph with a gather and an all-reduce at every trace
inside it: NCCL's collectives are kernels on the device, and a capture
records them like any other (its first call, eager, makes the group's
communicator). gloo runs its collectives on the host, from host copies,
which a capture cannot record: a gloo collective made while the current
stream captures raises (`_collective`). A capture records the Python
count `COLLECTIVES` once; `utils/graphs.CapturedCall` adds a graph's
collectives to it at every replay instead.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from rrt_tpu_torch.parallel.sharding import (LaneMesh, make_mesh,
                                             map_tensors, pad_to_multiple)

_ENV_COORD = "RRT_COORDINATOR"
_ENV_NPROC = "RRT_NUM_PROCESSES"
_ENV_PID = "RRT_PROCESS_ID"

# calls and bytes handed to collectives by this process
COLLECTIVES = {"calls": 0, "bytes": 0}


def _dist():
    import torch.distributed as dist
    return dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None, device=None) -> None:
    """Join the process group (idempotent). `coordinator_address` is
    host:port (or a torch init URL), reached by every rank. `device` is
    this rank's device type, "cuda" by default: the card
    `local_device_ids[0]`, else the rank modulo the local card count,
    becomes the current device before the group starts. The backend is
    NCCL on cards and gloo on the CPU, unless `backend` says otherwise
    (two ranks on one card need gloo: NCCL refuses them)."""
    dist = _dist()
    if is_initialized():
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id")
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the ranks on the CPU")
        ids = list(local_device_ids or [])
        if len(ids) > 1:
            raise ValueError("one process drives one card: give one local "
                             "device id")
        idx = ids[0] if ids else (dev.index if dev.index is not None else
                                  int(process_id) % torch.cuda.device_count())
        torch.cuda.set_device(idx)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))


def initialize_from_env(backend: Optional[str] = None, device=None) -> bool:
    """Initialise from the RRT_* variables; True if the process joined a
    group, False when they are absent (a single-process run)."""
    coord = os.environ.get(_ENV_COORD)
    if not coord:
        return False
    initialize(coordinator_address=coord,
               num_processes=int(os.environ[_ENV_NPROC]),
               process_id=int(os.environ[_ENV_PID]),
               backend=backend, device=device)
    return True


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if is_initialized():
        _dist().destroy_process_group()


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def global_mesh(devices=None) -> LaneMesh:
    """The lane mesh over every process's device (`sharding.make_mesh`)."""
    return make_mesh(devices)


def capturing() -> bool:
    """Is the current CUDA stream capturing a graph?"""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _collective(mesh: LaneMesh, x: torch.Tensor, run):
    """Count one collective on `x` and run it as run(dist, x), with `x`
    on the host for gloo and on the device for NCCL; the result comes
    back on the mesh's device. A gloo collective inside a capture
    raises."""
    if mesh.backend == "gloo" and capturing():
        raise RuntimeError(
            "a gloo collective cannot be captured in a CUDA graph: gloo "
            "runs its collectives on the host, from host copies; capture "
            "under an NCCL group, or run the collective eagerly between "
            "graphs")
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += x.numel() * x.element_size()
    if mesh.backend == "gloo":
        x = x.cpu()
    out = run(_dist(), x.contiguous())
    return out.to(mesh.device)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """(m, bytes of a lane) uint8 view of `t` (bools as one byte each)."""
    t = t.contiguous()
    w = 1
    for s in t.shape[1:]:
        w *= s
    if t.dtype == torch.bool:
        return t.to(torch.uint8).reshape(t.shape[0], w)
    return t.view(torch.uint8).reshape(t.shape[0], w * t.element_size())


def pack_lanes(tensors, mesh: LaneMesh, n: int) -> torch.Tensor:
    """The first piece of `all_gather_lanes`: this rank's block of every
    tensor packed as bytes, (b, bytes of a lane) uint8 with b =
    `shard_bounds`' block size, the lanes past the block zero. Makes no
    collective, so a captured graph may run it."""
    b = pad_to_multiple(n, mesh.world) // mesh.world
    m = tensors[0].shape[0]
    if m > b or any(t.shape[0] != m for t in tensors):
        raise ValueError(f"blocks of {[t.shape[0] for t in tensors]} lanes: "
                         f"a rank holds at most {b} of {n}, the same for "
                         f"every tensor")
    packed = torch.cat([_as_bytes(t) for t in tensors], dim=1)
    if m < b:
        packed = torch.cat([packed, packed.new_zeros(
            (b - m, packed.shape[1]))])
    return packed


def gather_packed(packed: torch.Tensor, mesh: LaneMesh, n: int,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The collective of `all_gather_lanes` alone: every rank's block
    `packed` (`shard_bounds`' block size of lanes, any dtype and trailing
    shape) in rank order, cut to the first n lanes, written into `out`
    when given. It runs eagerly, between the replays of the graphs that
    write `packed` and read `out` (the sharded pass gathers its float
    radiance so); without a process group it copies the block."""
    if mesh.group is None:
        whole = packed[:n]
    else:
        def gather(dist, x):
            whole = x.new_empty((mesh.world * x.shape[0],) + x.shape[1:])
            dist.all_gather(list(whole.chunk(mesh.world)), x,
                            group=mesh.group)
            return whole[:n]
        whole = _collective(mesh, packed, gather)
    if out is None:
        return whole
    out.copy_(whole)
    return out


def unpack_lanes(whole: torch.Tensor, like, n: int):
    """The last piece of `all_gather_lanes`: the n lanes of each tensor
    from the gathered bytes, `like` giving each tensor's dtype and
    trailing shape (tensors of any lane count). Makes no collective, so a
    captured graph may run it."""
    out, c = [], 0
    for t in like:
        shape = (n,) + tuple(t.shape[1:])
        w = 1 if t.dtype == torch.bool else t.element_size()
        for s in shape[1:]:
            w *= s
        part = whole[:n, c:c + w].contiguous()
        c += w
        out.append(part.to(torch.bool).reshape(shape) if t.dtype
                   == torch.bool else part.view(t.dtype).reshape(shape))
    return out


def all_gather_lanes(tensors, mesh: LaneMesh, n: int):
    """Put the ranks' blocks together: each rank holds the lanes
    [lo, min(hi, n)) of `shard_bounds(n, rank, world)` at the head of
    every tensor's leading axis; returns each tensor's n lanes in rank
    order. The tensors travel packed as bytes in one collective, so any
    mix of dtypes comes back bit for bit: `pack_lanes`, then
    `gather_packed`, then `unpack_lanes`, pieces that a compiled program
    may run on either side of its collective (the sharded pass gathers
    its one float tensor with `gather_packed` alone). Takes a tensor or
    a sequence."""
    single = isinstance(tensors, torch.Tensor)
    ts = [tensors] if single else list(tensors)
    if mesh.group is None:
        out = [t[:n] for t in ts]
        return out[0] if single else out
    whole = gather_packed(pack_lanes(ts, mesh, n), mesh, n)
    out = unpack_lanes(whole, ts, n)
    return out[0] if single else out


def _all_reduce(x: torch.Tensor, mesh: LaneMesh, op: str) -> torch.Tensor:
    if mesh.group is None:
        return x

    def reduce(dist, y):
        y = y.clone()
        dist.all_reduce(y, op=getattr(dist.ReduceOp, op), group=mesh.group)
        return y
    return _collective(mesh, x, reduce)


def pack_flat(tensors) -> torch.Tensor:
    """Float tensors as one flat buffer, in order: what one all-reduce of
    several tensors (a loss and its gradients) reduces. Makes no
    collective, so a captured graph may run it."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unpack_flat(flat: torch.Tensor, like) -> list:
    """`pack_flat` undone: the pieces of `flat` in the shapes of `like`."""
    parts = flat.split([t.numel() for t in like])
    return [p.reshape(t.shape) for p, t in zip(parts, like)]


def all_reduce_sum(x: torch.Tensor, mesh: LaneMesh) -> torch.Tensor:
    """The sum of `x` over the ranks (counters, losses, gradients)."""
    return _all_reduce(x, mesh, "SUM")


def all_reduce_max(x: torch.Tensor, mesh: LaneMesh) -> torch.Tensor:
    """The maximum of `x` over the ranks (flags every rank must agree
    on)."""
    return _all_reduce(x, mesh, "MAX")


def make_global_batch(local, mesh: LaneMesh):
    """This rank's lanes (leading axis of every tensor leaf of `local`) on
    the mesh's device, and their window (lo, hi, n_global) of the global
    batch, ranks in order: the port's stand-in for a globally sharded
    jax.Array. One all-gather of the ranks' lane counts."""
    first = []
    map_tensors(lambda a: first.append(a.shape[0]), local)
    m = first[0]
    local = map_tensors(lambda a: a.to(mesh.device), local)
    if mesh.group is None:
        return local, (0, m, m)
    counts = torch.tensor([m], dtype=torch.int64, device=mesh.device)

    def gather(dist, x):
        parts = [torch.empty_like(x) for _ in range(mesh.world)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts)
    counts = _collective(mesh, counts, gather).tolist()
    lo = sum(counts[:mesh.rank])
    return local, (lo, lo + m, sum(counts))


def replicate_global(tree, mesh: LaneMesh):
    """Every tensor leaf of `tree` on the mesh's device with rank 0's
    values: one broadcast per leaf."""
    def bcast(a):
        a = a.to(mesh.device)
        if mesh.group is None:
            return a

        def run(dist, x):
            x = x.clone()
            dist.broadcast(x, src=0, group=mesh.group)
            return x
        return _collective(mesh, a, run)
    return map_tensors(bcast, tree)


def all_processes_done(name: str = "rrt_barrier") -> None:
    """Barrier over the world (no-op in a single process). `name` is kept
    for the JAX signature."""
    if process_count() > 1:
        _dist().barrier()
