"""Closed-form compactly-supported bump test function for WAN.

Counterpart of ``nnpde_tpu/ops/bump.py``: ``w(x) = prod_i exp(1/(t_i^2-1))
/ I1`` with an analytic derivative

    d/dt exp(1/(t^2-1)) = exp(1/(t^2-1)) * (-2t / (t^2-1)^2)

evaluated on a clamped |t| so the exponent never overflows, and masked to
zero outside the support.  ``bump_grid`` and ``bump_w_multi`` give the
localised bumps of the multi-test-function WAN.
"""

from __future__ import annotations

import itertools

import torch

from .fwdlap import exclusive_products

# Reference normalisation constant for the 1D bump integral.
BUMP_I1 = 0.210987

# Keep |t| strictly inside the support so 1/(t^2-1) stays finite in f32.
_T_CLAMP = 1.0 - 1e-6


def bump_w_1d_jet(t):
    """(w, dw/dt, d2w/dt2) of the unit bump on t in (-1, 1), zero outside."""
    mask = torch.abs(t) < 1.0
    tc = torch.clamp(t, -_T_CLAMP, _T_CLAMP)
    q = tc * tc - 1.0                       # in [-1, -1e-6)
    w = torch.exp(1.0 / q) / BUMP_I1
    # d/dt [1/q] = -2t/q^2 ;  w' = w * (-2t/q^2)
    a = -2.0 * tc / (q * q)
    dw = w * a
    # w'' = w * (a^2 + a') with a' = (-2q + 8t^2)/q^3
    a1 = (-2.0 * q + 8.0 * tc * tc) / (q * q * q)
    d2w = w * (a * a + a1)
    zero = torch.zeros_like(t)
    return (torch.where(mask, w, zero), torch.where(mask, dw, zero),
            torch.where(mask, d2w, zero))


def bump_w(X, lo, hi):
    """N-D product bump on the box ``[lo, hi]^d`` and its gradient:
    ``(w (N,), dw (N, d))``."""
    X = torch.atleast_2d(X)
    h = (hi - lo) / 2.0
    center = (hi + lo) / 2.0
    t = (X - center) / h
    w1, dw1, _ = bump_w_1d_jet(t)           # (N, d) each; dw1 is d/dt
    dw1 = dw1 / h                            # chain rule to d/dx
    w = torch.prod(w1, dim=1)
    # exclusive products for the gradient (safe at interior zeros)
    return w, dw1 * exclusive_products(w1)


def bump_grid(lo: float, hi: float, d: int, k: int, overlap: float = 0.5):
    """Centres and half-width of a ``k^d`` grid of localised bumps on the
    box ``[lo, hi]^d`` with fractional overlap between neighbours:
    ``(centers (k^d, d) float32 on the CPU, half_width)``."""
    cell = (hi - lo) / k
    h = cell * (1.0 + overlap) / 2.0
    marks = [lo + cell * (i + 0.5) for i in range(k)]
    centers = torch.tensor(list(itertools.product(marks, repeat=d)), dtype=torch.float32)
    return centers, float(h)


def bump_w_multi(X, centers, half_width: float):
    """Localised bumps: ``w (K, N)``, ``dw (K, N, d)`` for K centres, each
    the product 1D bump on ``|x - c| < half_width`` per dimension (the
    profile of :func:`bump_w`, translated and scaled).  The centres are
    broadcast over a leading K axis."""
    X = torch.atleast_2d(X)
    centers = centers.to(dtype=X.dtype, device=X.device)
    t = (X[None, :, :] - centers[:, None, :]) / half_width          # (K, N, d)
    w1, dw1, _ = bump_w_1d_jet(t)
    dw1 = dw1 / half_width
    K, N, d = t.shape
    excl = exclusive_products(w1.reshape(K * N, d)).reshape(K, N, d)
    return torch.prod(w1, dim=2), dw1 * excl
