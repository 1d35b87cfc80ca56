"""Cost micro-probes of the trace kernel's ingredients on a CUDA card:
`python -m rrt_tpu_torch.tools.r5prim`.

The port of the JAX package's `tools/r5prim.py`, whose eight Pallas
kernels timed on a TPU what one iteration of each traversal ingredient
costs. Here each probe is the CUDA kernel `ops/csrc/r5prim.cu` (one block
of 1024 threads, the (8, 128) tile with one lane per thread) and a plain
PyTorch version (a Python loop over a (1, 8, 128) tensor) that computes
the same value for the same (x, n_iter):

  gate_full    slab(6 shared scalars) + OR over the block + uniform branch
  gate_nowhen  slab + OR over the block, no branch
  gate_nored   slab only
  reduce_rt    max over all lanes, fed back
  when_rt      branch on a scalar integer predicate
  sweep16      16 Moller-Trumbore-shaped tests
  fori_chain   scalar integer loop (the loop floor)
  dynread7     7 dynamically indexed reads of an (8, 7, 8, 128) table

Two differences from the TPU version, shared by kernel and plain version:
`pl.reciprocal(approx=True)` is the IEEE reciprocal, and dynread7's table,
which the TPU version never writes, is initialised from x:
wc[w, c] = x * float32(1e-4 * (7 w + c + 1)).

The tool times each kernel with CUDA events at two iteration counts and
prints the slope in ns per iteration, in SM cycles at the card's maximum
SM clock, and the plain version's ns per iteration at a small count, each
line with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import sys

import torch

PROBES = ("gate_full", "gate_nowhen", "gate_nored", "reduce_rt", "when_rt",
          "sweep16", "fori_chain", "dynread7")
SHAPE = (1, 8, 128)
# iteration counts of the slope (the TPU tool's) and of the plain timing
N1, N2, N_PLAIN = 20000, 100000, 64

# float32 operations per lane and iteration as ops/csrc/r5prim.cu writes
# them (a slab: 3 divisions, 12 subtractions and products, 12 min/max, 2
# compares; a sweep16 test: ~27; shuffles and integer steps count one
# each); the least time of a launch is these over the card's float32 peak
OPS_PER_ITER = dict(gate_full=35, gate_nowhen=35, gate_nored=33,
                    reduce_rt=22, when_rt=5, sweep16=434, fori_chain=4,
                    dynread7=21)

# kernel launches made by `probe_kernel`, per probe; read by chip_smoke.py
LAUNCHES = dict.fromkeys(PROBES, 0)


# ---------------------------------------------------------------- plain


def _box_table(x):
    """The (32, 6) box scalars [lo xyz, hi xyz] from x[0, 0, 0]: row k is
    x0·0.1 - 1 - 0.01k and x0·0.1 + 1 + 0.01k on every axis."""
    off = torch.tensor([0.01 * k for k in range(32)], dtype=torch.float32,
                       device=x.device)
    base = x[0, 0, 0] * 0.1
    lo, hi = (base - 1.0) - off, (base + 1.0) + off
    return torch.stack([lo, lo, lo, hi, hi, hi], dim=1)


def _slab(box, px, py, pz):
    ix, iy, iz = 1.0 / px, 1.0 / py, 1.0 / pz
    tx0, tx1 = (box[0] - px) * ix, (box[3] - px) * ix
    ty0, ty1 = (box[1] - py) * iy, (box[4] - py) * iy
    tz0, tz1 = (box[2] - pz) * iz, (box[5] - pz) * iz
    mn, mx = torch.minimum, torch.maximum
    tmn = mx(mx(mn(tx0, tx1), mn(ty0, ty1)), mn(tz0, tz1))
    tmx = mn(mn(mx(tx0, tx1), mx(ty0, ty1)), mx(tz0, tz1))
    return (tmn <= tmx) & (tmx >= 0.0)


def _dynread7_table(x):
    """dynread7's (8, 7, 8, 128) table: wc[w, c] = x[0] · float32(1e-4 ·
    (7w + c + 1))."""
    scale = torch.tensor([[1e-4 * (7 * w + c + 1) for c in range(7)]
                          for w in range(8)], dtype=torch.float32,
                         device=x.device)
    return x[0] * scale[:, :, None, None]


def probe_reference(prim: str, x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """The plain PyTorch version of probe `prim` on x (1, 8, 128) float32:
    a Python loop of n_iter iterations over the whole tile."""
    f32 = torch.float32
    wsm = _box_table(x)
    acc, buf = x.clone(), x.clone()
    if prim in ("gate_full", "gate_nowhen", "gate_nored"):
        for i in range(n_iter):
            r = _slab(wsm[i % 32], acc, acc + 0.5, acc + 1.0)
            if prim == "gate_nored":
                acc = acc * 0.9999 + r.to(f32)
                continue
            pred = r.any()
            if prim == "gate_nowhen":
                acc = acc * 0.9999 + torch.where(pred, 0.001, 0.002)
            else:
                buf = torch.where(pred, buf * 0.9999 + 0.001, buf)
                acc = acc * 0.9999 + 0.0001
        return acc + buf
    if prim == "reduce_rt":
        for _ in range(n_iter):
            acc = acc * 0.9999 + acc.max() * 1e-6
        return acc
    if prim == "when_rt":
        a = 3
        for _ in range(n_iter):
            if a % 3 == 0:
                buf = buf * 0.9999 + 0.001
            a = a * 7 % 1001
        return buf
    if prim == "sweep16":
        for _ in range(n_iter):
            bt = acc
            for t in range(16):
                f = wsm[t, 0]
                sx, sy, sz = acc - f, (acc - f) - 1.0, (acc - f) - 2.0
                s1x, s1y, s1z = sy * 2.0 - sz, sz * 2.0 - sx, sx * 2.0 - sy
                den = s1x + s1y * 2.0 + s1z
                nz = den != 0.0
                tt = (s1x * sx + s1y * sy + s1z * sz) \
                    * (1.0 / torch.where(nz, den, 1.0))
                ok = (tt >= 0.0) & (tt <= 10.0) & nz
                bt = torch.minimum(bt, torch.where(ok, tt, 3e37))
            acc = bt * 0.999 + 0.01
        return acc
    if prim == "fori_chain":
        a = 3
        for i in range(n_iter):
            a = a * 7 % 1001 + i % 3
        return torch.full_like(x, float(a))
    if prim == "dynread7":
        wc = _dynread7_table(x)
        for i in range(n_iter):
            for c in range(7):
                acc = acc * 0.9999 + wc[i % 8, c]
        return acc
    raise ValueError(f"unknown probe {prim!r}")


# ---------------------------------------------------------------- kernel


def probe_kernel(prim: str, x: torch.Tensor, n_iter: int,
                 return_place: bool = False):
    """Probe `prim` on x, a contiguous float32 (1, 8, 128) tile. A CPU
    tensor goes to `probe_reference`; a CUDA tensor to the kernel, built
    on first use; anything else raises. Each launch adds one to
    `LAUNCHES[prim]`. With `return_place`, also returns where dynread7's
    table lived: "shared", "device" or "plain"."""
    if prim not in PROBES:
        raise ValueError(f"unknown probe {prim!r}")
    if x.device.type == "cpu":
        out = probe_reference(prim, x, n_iter)
        return (out, "plain") if return_place else out
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {x.device}")
    if x.dtype != torch.float32 or tuple(x.shape) != SHAPE \
            or not x.is_contiguous():
        raise ValueError(f"x: expected contiguous float32 {SHAPE}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not 0 <= n_iter < 2 ** 31:
        raise ValueError(f"n_iter {n_iter} out of range")
    from rrt_tpu_torch.ops import build
    lib = build.load_library("r5prim")
    out = torch.empty_like(x)
    # device memory for the dynread7 table, used when shared memory is
    # too small for it
    wc = torch.empty((8, 7, 8, 128), dtype=torch.float32, device=x.device) \
        if prim == "dynread7" else None
    where = ctypes.c_int(0)
    rc = lib.rrt_r5prim(
        PROBES.index(prim), ctypes.c_void_p(x.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(wc.data_ptr() if wc is not None else 0),
        n_iter, x.device.index, ctypes.byref(where),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"r5prim kernel {prim} launch failed: "
                           + lib.rrt_r5prim_error_string(rc).decode())
    LAUNCHES[prim] += 1
    if return_place:
        return out, ("shared" if where.value else "device")
    return out


# ---------------------------------------------------------------- timing


def _event_ms(fn, reps: int) -> float:
    """Milliseconds per call of fn over `reps` calls after one warm-up
    call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(device, sm_clock_mhz: float, n1: int = N1, n2: int = N2,
            n_plain: int = N_PLAIN, reps: int = 5) -> list:
    """Per probe: the kernel's ms at n1 and n2 iterations, the slope in
    ns and SM cycles per iteration, and the plain version's ms and ns per
    iteration at n_plain iterations, on the CUDA `device`."""
    x = torch.full(SHAPE, 1.5, dtype=torch.float32, device=device)
    rows = []
    for prim in PROBES:
        t1 = _event_ms(lambda: probe_kernel(prim, x, n1), reps)
        t2 = _event_ms(lambda: probe_kernel(prim, x, n2), reps)
        ns = (t2 - t1) * 1e6 / (n2 - n1)
        plain = _event_ms(lambda: probe_reference(prim, x, n_plain), 1)
        _, place = probe_kernel(prim, x, 1, return_place=True)
        rows.append(dict(
            probe=prim, ms_n1=t1, ms_n2=t2, n1=n1, n2=n2, ns_per_iter=ns,
            cycles_per_iter=ns * sm_clock_mhz * 1e-3,
            kernel_ms=_event_ms(lambda: probe_kernel(prim, x, n_plain),
                                reps),
            plain_ms=plain, plain_ns_per_iter=plain * 1e6 / n_plain,
            n_plain=n_plain,
            table=place if prim == "dynread7" else None))
    return rows


def format_row(r: dict, card: str, sm_clock_mhz: float) -> str:
    table = f" table in {r['table']} memory" if r["table"] else ""
    return (f"{r['probe']:12s}: {r['ns_per_iter']:8.2f} ns/iter "
            f"(~{r['cycles_per_iter']:7.1f} cy at {sm_clock_mhz:.0f} MHz)"
            f"  [t{r['n1']}={r['ms_n1']:.3f}ms t{r['n2']}={r['ms_n2']:.3f}ms]"
            f"  plain {r['plain_ns_per_iter']:.0f} ns/iter at "
            f"n_iter={r['n_plain']}{table}  ({card})")


def main() -> int:
    from rrt_tpu_torch.utils.card import card_line, max_sm_clock_mhz
    if not torch.cuda.is_available():
        print("r5prim: no CUDA device; the probes time a card's kernels",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    card, clock = card_line(), max_sm_clock_mhz()
    rows = measure(dev, clock)
    for r in rows:
        print(format_row(r, card, clock), flush=True)
    print(json.dumps({"card": card, "sm_clock_mhz": clock, "probes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
