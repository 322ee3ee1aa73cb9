"""Per-point differential operators by automatic differentiation.

Counterpart of ``nnpde_tpu/ops/calculus.py`` on ``torch.func``: the
gradient by reverse mode (``grad``), the Laplacian as the trace of the
forward-over-reverse Hessian (``hessian``), both vmapped over the batch.
The fully general path (any scalar field) and the oracle that the
forward-Laplacian recurrence (:mod:`.fwdlap`) is tested against.
"""

from __future__ import annotations

import torch
from torch.func import grad, grad_and_value, hessian, vmap


def value_and_grad_x(u_fn):
    """``u_fn: (d,) -> scalar``  ->  ``x -> (u, grad (d,))``."""
    gv = grad_and_value(u_fn)

    def f(x):
        g, u = gv(x)
        return u, g

    return f


def batched_value_and_grad_x(u_fn):
    """Batched: ``(N, d) -> (u (N,), grad (N, d))``."""
    return vmap(value_and_grad_x(u_fn))


def value_grad_lap(u_fn):
    """``u_fn: (d,) -> scalar``  ->  ``x -> (u, grad (d,), laplacian)``."""
    g_fn = grad(u_fn)
    h_fn = hessian(u_fn)

    def f(x):
        return u_fn(x), g_fn(x), torch.diagonal(h_fn(x)).sum()

    return f


def batched_value_grad_lap(u_fn):
    """Batched: ``(N, d) -> (u (N,), grad (N, d), lap (N,))``."""
    return vmap(value_grad_lap(u_fn))
