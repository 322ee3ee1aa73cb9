"""Grid-average quadrature helpers (counterpart of
``nnpde_tpu/ops/quadrature.py``): the reference's ``volume * mean(f)``
integrals and the sign-ambiguous eigenfunction metric."""

from __future__ import annotations

import torch


def integral_mean(f, volume):
    """``volume * mean(f)``: grid-average approximation of the integral."""
    return volume * torch.mean(f)


def inner_product(u, v, volume):
    """Approximate L2 inner product ``<u, v>`` over a domain of given volume."""
    return integral_mean(u * v, volume)


def normalize_l2(u, volume, eps=1e-12):
    """Normalise ``u`` to unit L2 norm under the grid-average quadrature."""
    return u / torch.sqrt(integral_mean(u * u, volume) + eps)


def sign_aware_mse(u, v):
    """``min(mean((u-v)^2), mean((u+v)^2))``: eigenfunction gauge-free MSE."""
    return torch.minimum(torch.mean((u - v) ** 2), torch.mean((u + v) ** 2))


def trapezoid_weights(n, dtype=torch.float32, device=None):
    """Composite trapezoid weights on a uniform grid of ``n`` points (unit dx)."""
    w = torch.ones((n,), dtype=dtype, device=device)
    w[0] = 0.5
    w[-1] = 0.5
    return w
