"""Axis-aligned box domains (counterpart of ``nnpde_tpu/pde/domain.py``)."""

from __future__ import annotations

from typing import NamedTuple, Tuple


class Box(NamedTuple):
    lo: Tuple[float, ...]
    hi: Tuple[float, ...]

    @property
    def dim(self) -> int:
        return len(self.lo)

    @property
    def volume(self) -> float:
        v = 1.0
        for a, b in zip(self.lo, self.hi):
            v *= (b - a)
        return v

    @staticmethod
    def cube(dim: int, lo: float, hi: float) -> "Box":
        return Box(lo=(lo,) * dim, hi=(hi,) * dim)
