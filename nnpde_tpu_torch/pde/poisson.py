"""N-D Poisson physics: manufactured prod-sin / prod-cos solutions and RHS.

Counterpart of ``nnpde_tpu/pde/poisson.py``:
``u*(x) = prod_i sin(k_i pi x_i / L)`` on ``[0, L]^d`` with
``-lap u* = f = sum_i (k_i pi / L)^2 u*`` (and the same for cos, the
zero-Neumann family).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def exact_u_prod_sin(X, L: float, ks: Sequence[int]):
    """X (N, d) -> u* (N,)."""
    vals = torch.stack(
        [torch.sin(k * math.pi * X[..., i] / L) for i, k in enumerate(ks)], dim=-1
    )
    return torch.prod(vals, dim=-1)


def rhs_f_for_u_sin(X, L: float, ks: Sequence[int]):
    """Manufactured RHS for ``-lap u = f``."""
    s = sum((k * math.pi / L) ** 2 for k in ks)
    return s * exact_u_prod_sin(X, L, ks)


def exact_u_prod_cos(X, L: float, ks: Sequence[int]):
    """``u*(x) = prod_i cos(k_i pi x_i / L)`` (zero normal derivative)."""
    vals = torch.stack(
        [torch.cos(k * math.pi * X[..., i] / L) for i, k in enumerate(ks)], dim=-1
    )
    return torch.prod(vals, dim=-1)


def rhs_f_for_u_cos(X, L: float, ks: Sequence[int]):
    s = sum((k * math.pi / L) ** 2 for k in ks)
    return s * exact_u_prod_cos(X, L, ks)
