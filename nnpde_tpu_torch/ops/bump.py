"""Closed-form compactly-supported bump test function for WAN.

Counterpart of ``nnpde_tpu/ops/bump.py``: ``w(x) = prod_i exp(1/(t_i^2-1))
/ I1`` with an analytic derivative

    d/dt exp(1/(t^2-1)) = exp(1/(t^2-1)) * (-2t / (t^2-1)^2)

evaluated on a clamped |t| so the exponent never overflows, and masked to
zero outside the support.  ``bump_grid`` and ``bump_w_multi`` (the
multi-bump WAN) arrive with ROADMAP B8.
"""

from __future__ import annotations

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
