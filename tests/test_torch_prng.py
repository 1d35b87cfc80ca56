"""The port's threefry keys and uniforms (`rrt_tpu_torch/utils/prng.py`
over `ops/threefry.py`'s plain version) against the installed
`jax.random`, bit for bit, on the CPU.

The CUDA kernel (`ops/csrc/threefry.cu`) is held to the same plain
version on a card by tests/test_torch_kernel_cuda.py and `chip_smoke.py`.
"""
import jax
import numpy as np
import pytest
import torch

from rrt_tpu_torch.ops import threefry
from rrt_tpu_torch.utils import prng

SEEDS = [0, 1, 7, 2**31 - 1]
# odd sizes, one to three axes (the integrator's (n, 2), (n,), (S, n, 2))
SHAPES = [(7,), (1,), (3, 5), (509, 2), (2, 3, 5), (3, 17, 2)]


def _data(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_threefry_is_partitionable_in_the_installed_jax():
    """The port implements the partitionable threefry (the draw's counters
    are its elements' flat indices, split keys hash (0, i)); a JAX that
    turns it off draws other bits, which these tests would then show."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    assert np.array_equal(prng.key(seed).numpy(),
                          _data(jax.random.key(seed)))


def test_64_bit_seed_matches_jax_with_x64():
    """A seed of 2³² or more keeps its high word, as `threefry_seed` does
    with 64-bit integers on."""
    seed = 2**40 + 3
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want = _data(jax.random.key(seed))
    finally:
        jax.config.update("jax_enable_x64", old)
    assert np.array_equal(prng.key(seed).numpy(), want)
    assert want.tolist() == [256, 3]


@pytest.mark.parametrize("num", [2, 3, 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed, num):
    got = prng.split(prng.key(seed), num)
    assert got.shape == (num, 2)
    assert np.array_equal(got.numpy(),
                          _data(jax.random.split(jax.random.key(seed), num)))


@pytest.mark.parametrize("data", [0, 1, 5, 2**31 - 1, 2**32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed, data):
    want = _data(jax.random.fold_in(jax.random.key(seed), data))
    assert np.array_equal(prng.fold_in(prng.key(seed), data).numpy(), want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_key_from_a_tensor_equals_the_key_from_the_int(dtype):
    """`fold_in` of a 0-d integer tensor (a pass runner's sample index,
    read on the device) equals `fold_in` of the int, the pass key of the
    renderer included."""
    k = prng.key(7)
    for s in (0, 3, 16, 2**31 - 1):
        t = torch.tensor(s, dtype=dtype)
        assert torch.equal(prng.fold_in(k, t), prng.fold_in(k, s))
        assert torch.equal(prng.fold_in(prng.fold_in(k, t), 0),
                           prng.fold_in(prng.fold_in(k, s), 0))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape))
    got = prng.uniform(prng.key(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(_bits(got), _bits(want))


def test_scalar_uniform_matches_jax():
    for seed in SEEDS:
        want = np.asarray(jax.random.uniform(jax.random.key(seed), ()))
        got = prng.uniform(prng.key(seed))
        assert got.shape == () and np.array_equal(_bits(got), _bits(want))


def test_batch_of_keys_draws_each_keys_draw():
    """Keys with leading axes draw one draw each, as each key alone."""
    keys = prng.split(prng.key(11), 6).reshape(2, 3, 2)
    got = prng.uniform(keys, (5, 2))
    assert got.shape == (2, 3, 5, 2)
    jkeys = jax.random.split(jax.random.key(11), 6)
    for i in range(6):
        want = np.asarray(jax.random.uniform(jkeys[i], (5, 2)))
        assert np.array_equal(_bits(got.reshape(6, 5, 2)[i]), _bits(want))


@pytest.mark.parametrize("axis,lo,hi", [(0, 0, 4), (0, 1, 3), (1, 2, 7),
                                        (2, 1, 2), (-2, 0, 10)])
def test_window_is_a_block_of_the_whole_draw(axis, lo, hi):
    whole = np.asarray(jax.random.uniform(jax.random.key(9), (4, 10, 3)))
    got = prng.uniform(prng.key(9), (4, 10, 3), window=(axis, lo, hi))
    assert np.array_equal(_bits(got),
                          _bits(np.take(whole, range(lo, hi), axis=axis)))


def test_threefry_hash_known_answer():
    """The Threefry-2x32 known answer of Salmon et al. (Random123's
    kat_vectors, 20 rounds): key (0x13198a2e, 0x03707344), counter
    (0x243f6a88, 0x85a308d3)."""
    x0, x1 = threefry.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88,
                                   0x85A308D3)
    assert (x0, x1) == (0xC4923A9C, 0x483DF7A0)


def test_no_kernel_for_other_devices():
    """A key that lies neither on the CPU nor on a card is refused: the
    plain version serves CPU tensors only, and nothing falls back."""
    keys = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no threefry kernel"):
        threefry.uniform(keys, (4,), 0, 0, 4)
    with pytest.raises(ValueError, match="no threefry kernel"):
        threefry.derive(keys, 2)


def test_bad_keys_and_windows_are_refused():
    with pytest.raises(ValueError, match="int64"):
        prng.uniform(torch.zeros(2, dtype=torch.int32), (3,))
    with pytest.raises(ValueError, match="window"):
        prng.uniform(prng.key(0), (3, 4), window=(1, 2, 6))
