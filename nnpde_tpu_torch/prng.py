"""Integer keys and per-use ``torch.Generator``s.

The JAX package threads ``jax.random`` keys and derives per-epoch keys with
``fold_in(key, epoch)``, which makes a trajectory independent of how the
epochs are chunked.  The port keeps that discipline with plain integer
keys: :func:`fold_in` mixes a key with an integer (splitmix64), and
:func:`generator` seeds a fresh ``torch.Generator`` on the device from a
key.  The numbers differ from ``jax.random``'s; parity tests feed both
packages the same numpy inputs instead.

The exception is the JAX package's own generator for initial weights:
:func:`threefry_key`, :func:`threefry_split` and :func:`threefry_uniform`
are ``jax.random.PRNGKey``, ``split`` and ``uniform`` (threefry-2x32, the
partitionable counter layout) in numpy, so that an entry point can start
from the weights the JAX package draws for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and ``data`` (63-bit, a valid torch seed)."""
    return _splitmix64((_splitmix64(key & _MASK) ^ (data & _MASK)) & _MASK) >> 1


def split(key: int, n: int):
    """``n`` independent keys derived from ``key``."""
    return [fold_in(key, 0x5151 + i) for i in range(n)]


def generator(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key)
    return gen


# ------------------------------------------------- the JAX package's generator
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash (20 rounds) of uint32 counter arrays."""
    u = np.uint32
    ks = (u(k1), u(k2), u(k1) ^ u(k2) ^ u(0x1BD11BDA))
    x1, x2 = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = ((x2 << u(r)) | (x2 >> u(32 - r))) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + u(i + 1)
    return x1, x2


def _bits(key, n: int):
    """``(hi, lo)`` hashes of the counters 0..n-1 under ``key``."""
    return _threefry2x32(key[0], key[1], np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))


def threefry_key(seed: int):
    """``jax.random.PRNGKey(seed)`` as the JAX package makes it, in JAX's
    default 32-bit mode: ``(0, the seed's low 32 bits)``."""
    return (np.uint32(0), np.uint32(seed & 0xFFFFFFFF))


def threefry_split(key, n: int):
    """``jax.random.split(key, n)``."""
    hi, lo = _bits(key, n)
    return [(hi[i], lo[i]) for i in range(n)]


def threefry_uniform(key, shape, minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23 random
    mantissa bits under exponent 0, shifted, then scaled by one fused
    multiply-add (exact in float64, rounded once), as XLA computes it."""
    hi, lo = _bits(key, int(np.prod(shape)))
    mant = ((hi ^ lo) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = mant.view(np.float32) - np.float32(1.0)
    lo_f, hi_f = np.float32(minval), np.float32(maxval)
    scaled = (floats.astype(np.float64) * np.float64(hi_f - lo_f) + np.float64(lo_f))
    return np.maximum(lo_f, scaled.astype(np.float32)).reshape(shape)
