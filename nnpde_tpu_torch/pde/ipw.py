"""Infinite potential well physics (1D, 2D and 3D separable eigenstates).

Counterpart of ``nnpde_tpu/pde/ipw.py``: ``psi_n``, the energies, the 2D
product states with coefficient 2/L, and the analytic node positions
``k L / n`` used by the FN technique.  Units: hbar = m = 1.
"""

from __future__ import annotations

import math
from typing import List

import torch


def psi_1d(n: int, x, L: float):
    """sqrt(2/L) sin(n pi x / L) on [0, L]."""
    return math.sqrt(2.0 / L) * torch.sin(n * math.pi * x / L)


def energy_1d(n: int, L: float) -> float:
    return (n * math.pi) ** 2 / (2.0 * L**2)


def psi_2d(nx: int, ny: int, x, y, L: float):
    """(2/L) sin(nx pi x/L) sin(ny pi y/L)."""
    return (2.0 / L) * torch.sin(nx * math.pi * x / L) * torch.sin(ny * math.pi * y / L)


def energy_2d(nx: int, ny: int, L: float) -> float:
    return energy_1d(nx, L) + energy_1d(ny, L)


def nodes(n: int, L: float) -> List[float]:
    """Interior node positions of psi_n: k L / n, k = 1..n-1."""
    return [k * L / n for k in range(1, n)]


def psi_3d(nx: int, ny: int, nz: int, x, y, z, L: float):
    """Normalised 3D box eigenstate: product of 1D states."""
    return psi_1d(nx, x, L) * psi_1d(ny, y, L) * psi_1d(nz, z, L)


def energy_3d(nx: int, ny: int, nz: int, L: float) -> float:
    return energy_1d(nx, L) + energy_1d(ny, L) + energy_1d(nz, L)
