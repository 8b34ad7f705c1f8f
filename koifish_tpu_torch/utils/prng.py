"""The JAX package's threefry keys and draws, in numpy.

The model zoo's Guppy and Salmon draw their FFN row samples and masks from
``jax.random`` keys: the evaluation sample of a trained Guppy is
``randint`` under ``split(PRNGKey(0), L)``, and a training step's draws
come from ``fold_in(rng, step)``. A trained model computes a different
function under any other sample, so the port draws the same integers and
floats, bit for bit, here: threefry2x32 with JAX's partitionable counters (the default), ``split`` and ``fold_in`` as
JAX's threefry implementation makes them, and ``random_bits``,
``uniform`` and ``randint`` as ``jax._src.random`` maps the bits. A key is
a uint32 array [2]. This module imports no JAX; it is the port's one copy
of JAX's PRNG mapping (the QJL projection draws through it too).
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds, JAX's ``threefry2x32_p``) of the counter
    words ``x0``, ``x1`` (uint32 arrays) under the key (k0, k1)."""
    ks = (_U32(k0), _U32(k1), _U32(k0 ^ k1 ^ 0x1BD11BDA))
    rots = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in rots[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s key data with JAX's 64-bit types off
    (its default): the seed as a 32-bit integer, so (0, its low word)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=_U32)


def _hash(key: np.ndarray, n: int):
    """threefry of the 64-bit counters 0..n-1 (hi, lo words) under key."""
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(_U32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(_U32)
    return threefry2x32(int(key[0]), int(key[1]), hi, lo)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [num, 2] keys."""
    y0, y1 = _hash(key, num)
    return np.stack([y0, y1], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: threefry of the words (0, data)."""
    y0, y1 = threefry2x32(int(key[0]), int(key[1]), np.zeros(1, _U32),
                          np.array([int(data) & 0xFFFFFFFF], dtype=_U32))
    return np.array([y0[0], y1[0]], dtype=_U32)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``: the xor of the two words."""
    shape = tuple(shape)
    y0, y1 = _hash(key, int(np.prod(shape, dtype=np.int64)))
    return (y0 ^ y1).reshape(shape)


def uniform(key: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23
    mantissa bits into [1, 2), minus one, then scaled and shifted. JAX's
    ``_uniform`` is jitted, eager calls too, and XLA fuses the scale and
    shift into one FMA: one rounding, emulated in f64 (the product is
    exact there; the sum rounds twice, f64 then f32, which moves no draw
    the tests compare)."""
    bits = random_bits(key, shape)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32)
    f = f - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    y = (f.astype(np.float64) * np.float64(hi - lo)
         + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, y)


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, int32)``: two
    words of bits per value (from the two halves of ``split(key)``) folded
    into the span with uint32 arithmetic that wraps, as JAX's does."""
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(max(int(maxval) - int(minval), 1))
    with np.errstate(over="ignore"):
        mult = np.array([(1 << 16) % int(span)], dtype=_U32)
        mult = (mult * mult) % span
        off = (higher % span) * mult[0] + lower % span
        off = off % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
