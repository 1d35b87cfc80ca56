"""The port's counterpart of the part of `jax.random` that the JAX package
uses: threefry keys, `split`, `fold_in` and `uniform`, bit for bit those
of the installed JAX (0.9, `jax_threefry_partitionable` on), on the CPU
and on a card alike.

A key is an int64 tensor of shape (..., 2) holding the two uint32 words
of a JAX threefry key (`jax.random.key_data`); a batch of keys has
leading axes. Keys live on the device of the draws they make, and every
function returns its result there: on a card the hashes run in the
hand-written kernel `ops/csrc/threefry.cu` (`ops.threefry`), on the CPU
in its plain PyTorch version.

  * `key(seed)`: (seed >> 32, seed & 0xFFFFFFFF), JAX's `threefry_seed`
    of a 64-bit seed (jax/_src/prng.py:817-829). The JAX package runs
    with 32-bit integers, where a seed of 2³² or more loses its high
    word; seeds below 2³² agree either way.
  * `split(key, num)`: (..., num, 2), the key hashing the counters (0, i)
    (`_threefry_split_foldlike`, prng.py:1156-1161).
  * `fold_in(key, data)`: the key hashing (0, data mod 2³²)
    (prng.py:1168-1170); `data` is an int or a 0-d integer tensor on the
    key's device, read there (a captured pass derives its key from its
    sample index on the device).
  * `uniform(key, shape, window)`: float32 uniforms in [0, 1)
    (random.py:435-475), one draw of `shape`
    for each key of a batch. Element g of a draw (its flat index) hashes
    the counters (g >> 32, g & 0xFFFFFFFF) (prng.py:1184-1198), so with
    `window` = (axis, lo, hi) a call computes only the block [lo, hi)
    along `axis` of the whole draw, and the blocks of all ranks put
    together equal the whole draw bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from rrt_tpu_torch.ops import threefry

M32 = threefry.M32


def key(seed: int, device="cpu") -> torch.Tensor:
    """The (2,) key of an integer seed, on `device`."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`num` new keys from each key: (..., num, 2)."""
    return threefry.derive(key, num)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]
            ) -> torch.Tensor:
    """The key of `key` with `data` folded in: (..., 2)."""
    if isinstance(data, torch.Tensor):
        out = threefry.derive(key, 1, data=data)
    else:
        out = threefry.derive(key, 1, offset=int(data) & M32)
    return out.squeeze(-2)


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            window: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` (float32 in [0, 1)) for every
    key of `key` (..., 2): key.shape[:-1] + shape. With `window` = (axis,
    lo, hi), only the block [lo, hi) along `axis` of each draw (that axis
    of the result holds hi − lo elements)."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        if window is not None:
            raise ValueError("a window of a scalar draw")
        return threefry.uniform(key, (1,), 0, 0, 1).squeeze(-1)
    axis, lo, hi = (0, 0, shape[0]) if window is None else window
    if axis < 0:
        axis += len(shape)
    return threefry.uniform(key, shape, axis, lo, hi)
