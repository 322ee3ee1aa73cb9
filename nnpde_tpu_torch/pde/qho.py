"""Quantum harmonic oscillator physics (omega = sqrt(2), hbar = m = 1).

Counterpart of ``nnpde_tpu/pde/qho.py``: the physicists' Hermite
recurrence, the normalised eigenstates, the potential and energies, and the
node tables of the FN technique (numpy Hermite roots scaled by
``1/sqrt(omega)``, identical to the reference's tables for n <= 5).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

OMEGA = math.sqrt(2.0)


def phys_hermite(n: int, z):
    """Physicists' Hermite polynomial H_n(z) by the standard recurrence."""
    if n == 0:
        return torch.ones_like(z)
    if n == 1:
        return 2.0 * z
    h_nm2 = torch.ones_like(z)
    h_nm1 = 2.0 * z
    for k in range(2, n + 1):
        h_n = 2.0 * z * h_nm1 - 2.0 * (k - 1) * h_nm2
        h_nm2, h_nm1 = h_nm1, h_n
    return h_nm1


def psi_1d(n: int, x, omega: float = OMEGA):
    """Normalised QHO eigenstate psi_n(x)."""
    hn = phys_hermite(n, math.sqrt(omega) * x)
    norm = (omega / math.pi) ** 0.25 / math.sqrt(2.0**n * math.factorial(n))
    return norm * hn * torch.exp(-omega * x * x / 2.0)


def psi_2d(nx: int, ny: int, x, y, omega: float = OMEGA):
    return psi_1d(nx, x, omega) * psi_1d(ny, y, omega)


def potential_1d(x, omega: float = OMEGA):
    return 0.5 * omega**2 * x * x


def potential_2d(x, y, omega: float = OMEGA):
    return 0.5 * omega**2 * (x * x + y * y)


def energy_1d(n: int, omega: float = OMEGA) -> float:
    return (n + 0.5) * omega


def energy_2d(nx: int, ny: int, omega: float = OMEGA) -> float:
    return (nx + ny + 1.0) * omega


def nodes(n: int, omega: float = OMEGA) -> List[float]:
    """Zeros of psi_n: the Hermite roots of H_n scaled by 1/sqrt(omega)."""
    if n == 0:
        return []
    coeffs = np.zeros(n + 1)
    coeffs[n] = 1.0
    roots = np.polynomial.hermite.hermroots(coeffs)
    return sorted(float(r) / math.sqrt(omega) for r in roots)
