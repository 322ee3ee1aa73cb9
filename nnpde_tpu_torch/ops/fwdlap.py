"""Forward-Laplacian propagation for MLPs (plain PyTorch).

Counterpart of ``nnpde_tpu/ops/fwdlap.py``: the exact first-order Jacobian
and the Laplacian are carried *forward* through the network with the value
(the "Forward Laplacian" scheme, arXiv:2307.08214):

  linear  z = a W + b:   v' = v W          J' = J W          l' = l W
  pointwise sigma:       v' = s(v)         J' = s'(v) * J    l' = s'(v) l + s''(v) sum_d J^2

This recurrence is the oracle every CUDA kernel of the port is held to,
and differentiating it with ``torch.autograd`` is the plain version of the
fused loss+grad kernels (:mod:`nnpde_tpu_torch.kernels.fused_step`).

The same recurrence written out as the TPU kernels compute it per tile
(:func:`recompute_plain`, :func:`project_plain`, :func:`reverse_plain`),
with every product operand passed through a cast, is the plain version of
the kernels' bf16-dot mode (``cast=round_bf16``).
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


def mlp_fwdlap(params, X, activation: str, input_jet=None, through=None) -> Jet:
    """Exact (u, grad u, lap u) of a scalar MLP over a collocation batch.

    ``params``: sequence of ``(W (in,out), b (out,))``, activation between
    layers (not after the last).  ``X``: (N, d).  ``input_jet``: optional
    ``(z, z', z'')`` seed, each (N, d), for a net applied to elementwise
    features ``z(x)`` (diagonal Jacobian): the first layer then seeds
    ``J[n,i,:] = z_i'(x_n) W0[i,:]`` and ``l = z'' @ W0``.  ``through``:
    optional ``(k, before, v, J, l) -> (v, J, l)``, applied to the three
    streams at layer ``k`` before its product (``before=True``, k >= 1) and
    after it, ahead of its bias (``before=False``); the collectives of
    tensor parallelism (``parallel/mesh.py::tp_mlp_fwdlap``).
    """
    s, s1, s2 = activation_jet(activation)
    N, d = X.shape
    if through is None:
        def through(k, before, v, J, l):
            return v, J, l

    W0, b0 = params[0]
    if input_jet is None:
        v = X @ W0                                         # (N, w)
        J = W0.unsqueeze(0).expand(N, d, W0.shape[1])      # (N, d, w)
        l = torch.zeros_like(v)
    else:
        z, z1, z2 = input_jet
        v = z @ W0
        J = z1[:, :, None] * W0[None, :, :]
        l = z2 @ W0
    v, J, l = through(0, False, v, J, l)
    v = v + b0

    for k, (W, b) in enumerate(params[1:], start=1):
        s1v = s1(v)
        l = s1v * l + s2(v) * torch.sum(J * J, dim=1)
        J = s1v[:, None, :] * J
        v = s(v)
        v, J, l = through(k, True, v, J, l)
        J = (J.reshape(N * d, -1) @ W).reshape(N, d, W.shape[1])
        v = v @ W
        l = l @ W
        v, J, l = through(k, False, v, J, l)
        v = v + b

    return Jet(value=v[..., 0], grad=J[..., 0], lap=l[..., 0])


# ------------------------------------- the TPU kernels' per-tile arithmetic
def round_bf16(x):
    """``x`` rounded to the nearest bfloat16 value (ties to even), in the
    dtype of ``x``: one product operand of the bf16-dot mode."""
    return x.to(torch.bfloat16).to(x.dtype)


def activation_pack(activation: str, v):
    """``(s, s', s'', s''')`` at ``v`` with the fewest transcendentals: the
    kernels' ``act_pack``, :func:`activation_jet` with the third derivative
    that the reverse sweep needs."""
    if activation == "sin":
        sv, cv = torch.sin(v), torch.cos(v)
        return sv, cv, -sv, -cv
    if activation == "tanh":
        t = torch.tanh(v)
        u = 1.0 - t * t
        return t, u, -2.0 * t * u, u * (6.0 * t * t - 2.0)
    if activation == "gelu":
        pdf = _INV_SQRT2PI * torch.exp(-0.5 * v * v)
        cdf = 0.5 * (1.0 + torch.erf(v * 0.7071067811865476))
        return v * cdf, cdf + v * pdf, (2.0 - v * v) * pdf, (v * v * v - 4.0 * v) * pdf
    raise ValueError(f"Unknown activation {activation!r}")


def _stage(activation, v, J, l):
    """One hidden stage's nonlinearity: ``(pack, q, (A, Jmid, lmid))`` for
    pre-activation streams ``v`` (N, w), ``J`` (d, N, w), ``l`` (N, w)."""
    pack = activation_pack(activation, v)
    q = torch.sum(J * J, dim=0)
    return pack, q, (pack[0], pack[1] * J, pack[1] * l + pack[2] * q)


def _fma(a, b, c):
    """``a * b + c`` with one rounding to ``a``'s float32 (the float64
    product of two float32 values is exact; the sum is rounded in float64
    first, which differs from a fused multiply-add only at a float32 tie)."""
    return (a.double() * b.double() + c).to(a.dtype)


def contracted_stage(activation, v, J, l):
    """:func:`_stage` with its multiply-adds fused, one rounding each, as
    nvcc compiles the kernels' ``act_pack`` and Laplacian mid stream
    (``1 - t*t``, ``6*t*t - 2``, ``s1*l + s2*q``): another sound rounding
    order of the same stage, for measuring what the order alone moves.
    sin and tanh."""
    if activation == "tanh":
        t = torch.tanh(v)
        u = _fma(-t, t, 1.0)
        pack = (t, u, -2.0 * t * u, u * _fma(6.0 * t, t, -2.0))
    elif activation == "sin":
        pack = activation_pack(activation, v)
    else:
        raise ValueError(f"contracted_stage: sin and tanh only, got {activation!r}")
    q = torch.sum(J * J, dim=0)
    return pack, q, (pack[0], pack[1] * J, _fma(pack[1], l, pack[2] * q))


SUM_ORDERS = ("k", "reversed", "pairwise")


def ordered_matmul(order: str):
    """``A @ W`` with each output's sum over k taken in a stated order, one
    rounding per addition: ``"k"`` the chain k = 0, 1, ... (an FMA chain
    where the products are exact, as they are for bf16 operands in float32),
    ``"reversed"`` the chain from the last k, ``"pairwise"`` a balanced tree
    (halves summed, then added).  Sound orders other than a library
    product's own, for measuring what the order alone moves."""
    if order not in SUM_ORDERS:
        raise ValueError(f"Unknown sum order {order!r}; one of {SUM_ORDERS}")

    def term(A, W, i):
        return A[..., i:i + 1] * W[i]

    def tree(A, W, lo, hi):
        if hi - lo == 1:
            return term(A, W, lo)
        mid = (lo + hi) // 2
        return tree(A, W, lo, mid) + tree(A, W, mid, hi)

    def mm(A, W):
        k = W.shape[0]
        if order == "pairwise":
            return tree(A, W, 0, k)
        idx = range(k) if order == "k" else range(k - 1, -1, -1)
        out = None
        for i in idx:
            out = term(A, W, i) if out is None else out + term(A, W, i)
        return out

    return mm


def recompute_plain(params, X, activation: str, cast, matmul=torch.matmul, stage=None):
    """The TPU kernels' forward recompute (``_fwd_recompute``: all streams
    of a stage in one product) with every product operand passed through
    ``cast``: X, the stacked mid streams and the weights.  The layer-0
    Jacobian seed rows are not cast.  ``matmul`` and ``stage``: the product
    and the stage's nonlinearity in other rounding orders
    (:func:`ordered_matmul`, :func:`contracted_stage`).  Returns
    ``(saved, final)``:
    ``saved[k-1] = (J, l, q, pack, Jmid, lmid)`` of hidden stage k, and
    ``final = (J, l, q, pack, (A, Jmid, lmid))`` of the last one."""
    stage = _stage if stage is None else stage
    (W0, b0), (N, d) = params[0], X.shape
    v = matmul(cast(X), cast(W0)) + b0
    J = W0[:, None, :].expand(d, N, W0.shape[1])
    l = torch.zeros_like(v)
    saved = []
    for W, b in params[1:-1]:
        pack, q, (A, Jm, lm) = stage(activation, v, J, l)
        saved.append((J, l, q, pack, Jm, lm))
        O = matmul(cast(torch.cat([A[None], Jm, lm[None]], dim=0)), cast(W))
        v, J, l = O[0] + b, O[1:1 + d], O[d + 1]
    pack, q, mid = stage(activation, v, J, l)
    return saved, (J, l, q, pack, mid)


def project_plain(params, final):
    """``(value, grad (N, d), lap)`` of the net from the last stage's mid
    streams: the projection on the last layer's row, never cast."""
    (A, Jm, lm), (wl, bl) = final[-1], params[-1]
    w = wl[:, 0]
    return A @ w + bl[0], (Jm @ w).T, lm @ w


# The reverse nonlinearity's sum dv = s1 dA + (s2 l + s3 q) dlm + sum_i s2
# J_i dJ_i in other sound rounding orders than the plain version's (which
# sums the Jacobian shares with torch.sum, then adds them): "streams" sums
# them one stream after another, then adds them (the CUDA kernels' order,
# fwdlap_mma.cuh BwdSt); "chain" adds each to dv in stream order (the JAX
# kernels' _nl_bwd_pack).  In the bf16-dot mode an fp32 ulp there can round
# a cotangent to the other bf16 neighbour, so these orders are part of the
# plain version's own spread (ROADMAP.md C).
DV_ORDERS = ("streams", "chain")


def _nl_bwd(pack, J, l, q, dA, dJm, dlm, order=None):
    """Backward through a stage's nonlinearity (``_nl_bwd_pack``);
    ``order``: the sum of dv in one of ``DV_ORDERS``."""
    _, s1, s2, s3 = pack
    dq = s2 * dlm
    dv = s1 * dA + (s2 * l + s3 * q) * dlm
    if order is None:
        dv = dv + torch.sum(s2 * J * dJm, dim=0)
    elif order == "streams":
        dvj = s2 * J[0] * dJm[0]
        for i in range(1, J.shape[0]):
            dvj = dvj + s2 * J[i] * dJm[i]
        dv = dv + dvj
    elif order == "chain":
        for i in range(J.shape[0]):
            dv = dv + s2 * J[i] * dJm[i]
    else:
        raise ValueError(f"Unknown dv order {order!r}; one of {DV_ORDERS}")
    return dv, s1 * dJm + 2.0 * J * dq, s1 * dlm


def reverse_plain(params, X, cast, saved, final, ct, order=None):
    """The TPU kernels' reverse sweep (``_reverse_sweep``) from per-point
    cotangents ``ct`` (N, d+2) of ``[value, grad, lap]`` to ``(dWs, dbs)``,
    every operand of the ``dW`` and pullback products passed through
    ``cast``; ``dWlast``, the ``db`` sums and the Jacobian-row sums added to
    ``dW0`` take the values as they are.  ``dbs[-1] = sum ct_v``.
    ``order``: the reverse nonlinearity's sum in one of ``DV_ORDERS``."""
    d, K = X.shape[1], len(params)
    J, l, q, pack, (A, Jm, lm) = final
    ct_v, ct_g, ct_l = ct[:, 0], ct[:, 1:1 + d].T, ct[:, d + 1]
    w = params[-1][0][:, 0]
    dWs, dbs = [None] * K, [None] * K
    dWs[-1] = (A.T @ ct_v + torch.sum(Jm * ct_g[:, :, None], dim=(0, 1))
               + lm.T @ ct_l)[:, None]
    dbs[-1] = torch.sum(ct_v).reshape(1)
    dv, dJ, dl = _nl_bwd(pack, J, l, q, ct_v[:, None] * w, ct_g[:, :, None] * w,
                         ct_l[:, None] * w, order)
    for k in range(K - 2, 0, -1):
        J_e, l_e, q_e, pack_e, Jm_e, lm_e = saved[k - 1]
        W = params[k][0]
        M = cast(torch.cat([pack_e[0][None], Jm_e, lm_e[None]], dim=0))
        D = cast(torch.cat([dv[None], dJ, dl[None]], dim=0))
        dWs[k] = M.reshape(-1, W.shape[0]).T @ D.reshape(-1, W.shape[1])
        dbs[k] = torch.sum(dv, dim=0)
        P = D @ cast(W).T
        dv, dJ, dl = _nl_bwd(pack_e, J_e, l_e, q_e, P[0], P[1:1 + d], P[d + 1], order)
    dWs[0] = cast(X).T @ cast(dv) + torch.sum(dJ, dim=1)
    dbs[0] = torch.sum(dv, dim=0)
    return dWs, dbs


class ChannelJet(NamedTuple):
    """Batched second-order jet of a C-channel vector field."""

    value: torch.Tensor  # (N, C)
    grad: torch.Tensor   # (N, d, C)
    lap: torch.Tensor    # (N, C)


def mlp_fwdlap_channels(params, X, activation: str) -> ChannelJet:
    """Exact per-channel (u, grad u, lap u) of a C-output MLP.

    The recurrence of :func:`mlp_fwdlap`, stage by stage through
    :func:`_stage`: the output layer is one more linear map, so all C
    channels ride the same hidden streams and the last product fans them
    out (the coupled harmonics of ``problems/kh_floquet.py``, the k
    eigenstates of ``problems/subspace.py``)."""
    (W0, b0), (N, d) = params[0], X.shape
    v = X @ W0 + b0
    J = W0[:, None, :].expand(d, N, W0.shape[1])      # (d, N, w)
    l = torch.zeros_like(v)
    for W, b in params[1:]:
        _, _, (A, Jm, lm) = _stage(activation, v, J, l)
        v, J, l = A @ W + b, Jm @ W, lm @ W
    return ChannelJet(value=v, grad=J.permute(1, 0, 2), lap=l)


def compose_product_jet_channels(a: ChannelJet, f: Jet) -> ChannelJet:
    """Jet of ``a * f`` where the scalar trial factor f multiplies every
    channel:  (af, a∇f + f∇a, aΔf + 2∇a·∇f + fΔa)  per channel."""
    value = a.value * f.value[:, None]
    grad = (a.value[:, None, :] * f.grad[:, :, None]
            + f.value[:, None, None] * a.grad)
    lap = (a.value * f.lap[:, None]
           + 2.0 * torch.einsum("ndc,nd->nc", a.grad, f.grad)
           + f.value[:, None] * a.lap)
    return ChannelJet(value=value, grad=grad, lap=lap)


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
