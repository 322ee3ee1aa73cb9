"""Integer keys and per-use ``torch.Generator``s.

The JAX package threads ``jax.random`` keys and derives per-epoch keys with
``fold_in(key, epoch)``, which makes a trajectory independent of how the
epochs are chunked.  The port keeps that discipline with plain integer
keys: :func:`fold_in` mixes a key with an integer (splitmix64), and
:func:`generator` seeds a fresh ``torch.Generator`` on the device from a
key.  The numbers differ from ``jax.random``'s; parity tests feed both
packages the same numpy inputs instead.
"""

from __future__ import annotations

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
