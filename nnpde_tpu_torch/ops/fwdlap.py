"""Forward-Laplacian propagation for MLPs (plain PyTorch).

Counterpart of ``nnpde_tpu/ops/fwdlap.py``: the exact first-order Jacobian
and the Laplacian are carried *forward* through the network with the value
(the "Forward Laplacian" scheme, arXiv:2307.08214):

  linear  z = a W + b:   v' = v W          J' = J W          l' = l W
  pointwise sigma:       v' = s(v)         J' = s'(v) * J    l' = s'(v) l + s''(v) sum_d J^2

This recurrence is the oracle every CUDA kernel of the port is held to,
and differentiating it with ``torch.autograd`` is the plain version of the
fused loss+grad kernels (:mod:`nnpde_tpu_torch.kernels.fused_step`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Jet(NamedTuple):
    """Batched second-order jet of a scalar field: value, gradient, Laplacian."""

    value: torch.Tensor  # (N,)
    grad: torch.Tensor   # (N, d)
    lap: torch.Tensor    # (N,)


_INV_SQRT2PI = 0.3989422804014327


def activation_jet(name: str):
    """Return ``(s, s', s'')`` for a named pointwise activation."""
    if name == "sin":
        return torch.sin, torch.cos, lambda v: -torch.sin(v)
    if name == "tanh":
        def d1(v):
            t = torch.tanh(v)
            return 1.0 - t * t

        def d2(v):
            t = torch.tanh(v)
            return -2.0 * t * (1.0 - t * t)

        return torch.tanh, d1, d2
    if name == "gelu":
        # exact gelu: 0.5 v (1 + erf(v/sqrt(2)))
        def pdf(v):
            return _INV_SQRT2PI * torch.exp(-0.5 * v * v)

        def cdf(v):
            return 0.5 * (1.0 + torch.erf(v / math.sqrt(2.0)))

        def s(v):
            return v * cdf(v)

        def d1(v):
            return cdf(v) + v * pdf(v)

        def d2(v):
            return 2.0 * pdf(v) - v * v * pdf(v)

        return s, d1, d2
    raise ValueError(f"Unknown activation {name!r}")


def mlp_fwdlap(params, X, activation: str, input_jet=None) -> Jet:
    """Exact (u, grad u, lap u) of a scalar MLP over a collocation batch.

    ``params``: sequence of ``(W (in,out), b (out,))``, activation between
    layers (not after the last).  ``X``: (N, d).  ``input_jet``: optional
    ``(z, z', z'')`` seed, each (N, d), for a net applied to elementwise
    features ``z(x)`` (diagonal Jacobian): the first layer then seeds
    ``J[n,i,:] = z_i'(x_n) W0[i,:]`` and ``l = z'' @ W0``.
    """
    s, s1, s2 = activation_jet(activation)
    N, d = X.shape

    W0, b0 = params[0]
    if input_jet is None:
        v = X @ W0 + b0                                    # (N, w)
        J = W0.unsqueeze(0).expand(N, d, W0.shape[1])      # (N, d, w)
        l = torch.zeros_like(v)
    else:
        z, z1, z2 = input_jet
        v = z @ W0 + b0
        J = z1[:, :, None] * W0[None, :, :]
        l = z2 @ W0

    for (W, b) in params[1:]:
        s1v = s1(v)
        l = s1v * l + s2(v) * torch.sum(J * J, dim=1)
        J = s1v[:, None, :] * J
        v = s(v)
        J = (J.reshape(N * d, -1) @ W).reshape(N, d, W.shape[1])
        v = v @ W + b
        l = l @ W

    return Jet(value=v[..., 0], grad=J[..., 0], lap=l[..., 0])


def compose_product_jet(a: Jet, b: Jet) -> Jet:
    """Jet of the product ``a * b``:  (ab, a∇b + b∇a, aΔb + 2∇a·∇b + bΔa)."""
    value = a.value * b.value
    grad = a.value[:, None] * b.grad + b.value[:, None] * a.grad
    lap = (a.value * b.lap + 2.0 * torch.sum(a.grad * b.grad, dim=1)
           + b.value * a.lap)
    return Jet(value=value, grad=grad, lap=lap)


def exclusive_products(F: torch.Tensor) -> torch.Tensor:
    """``out[:, j] = prod_{i != j} F[:, i]`` by prefix/suffix cumprods —
    division-free, so exact when factors vanish.  F: (N, d)."""
    N, d = F.shape
    ones = torch.ones((N, 1), dtype=F.dtype, device=F.device)
    pre = torch.cat([ones, torch.cumprod(F[:, :-1], dim=1)], dim=1)
    if d > 1:
        suf = torch.cat(
            [torch.flip(torch.cumprod(torch.flip(F[:, 1:], [1]), dim=1), [1]),
             ones], dim=1)
    else:
        suf = ones
    return pre * suf


def constant_jet(value: torch.Tensor, d: int) -> Jet:
    """Jet of a constant field (zero derivatives)."""
    N = value.shape[0]
    return Jet(value=value,
               grad=torch.zeros((N, d), dtype=value.dtype, device=value.device),
               lap=torch.zeros_like(value))
