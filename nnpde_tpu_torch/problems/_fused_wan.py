"""Shared wiring for the two-pass fused WAN objectives.

Counterpart of ``nnpde_tpu/problems/_fused_wan.py``.  Every WAN trainer has
the same shape (primal weak form ``wr^2/(mean(phi^2)+eps)`` against a
bump-windowed critic ``phi = w * v``), so the fused u/v objectives
(:mod:`nnpde_tpu_torch.kernels.fused_quotient`) are built here once:

* the primal coefficients are the weak functional of the u-jet with the
  critic's ``(phi, grad phi)`` as per-point data;
* the critic coefficients are the weak functional of the v-jet with the
  u-jet as data and ``bump x critic trial factor`` as the effective factor;
* a trainable eigenvalue stays exact: E is an explicit argument whose
  gradient comes from the in-kernel ``sum u*phi`` lane.

The frozen net's ``(value, grad)`` comes from ``value_and_grad(impl=...)``:
``'kernel'`` (the default, the jet-forward kernel; JAX's ``'pallas'``) or
``'torch'``.  :func:`make_fused_wan_multi_pair` is the multi-test-function
variant on the K-bump kernels (:mod:`nnpde_tpu_torch.kernels.fused_multibump`).
Both take the kernels' ``dot_dtype`` (JAX's ``**call_kw``, whose only key
with a meaning on the card) and pass it to the objectives they build.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..kernels import (
    linear_functional_coefficients,
    make_fused_wan_multi_u,
    make_fused_wan_multi_v,
    make_fused_wan_u,
    make_fused_wan_v,
    pack_multibump_coefficients,
)
from ..ops.fwdlap import Jet


class FusedWanPair(NamedTuple):
    """The fused WAN objective set: ``(u_pde_fn, v_loss_fn)`` plus the
    split ``v_coef_fn`` + ``v_loss_from_coef`` for trainers that build the
    critic's coefficients once per epoch (``fit_wan``'s ``v_context_fn``)."""

    u_pde_fn: Callable
    v_loss_fn: Callable
    v_coef_fn: Callable
    v_loss_from_coef: Callable


def factor_jet_or_one(model, X):
    """The model's trial-factor jet, or the identity jet (B = 1) for raw
    nets (technique 'BC'/'RAW')."""
    if model.factor is None:
        one = torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)
        return Jet(one, torch.zeros_like(X), torch.zeros_like(one))
    return model.factor.jet(X)


def make_fused_wan_pair(u_model, v_model, *, w_pde: float = 1.0,
                        prefactor: float = 0.5,
                        convention: str = "wr2_over_norm",
                        eps: float = 1e-8, objective: str = "neg_log",
                        log_eps: float = 1e-8, impl: str = "kernel",
                        w_norm: float = 0.0, vol: float = 1.0,
                        dot_dtype: str = "float32"):
    """Build the fused objectives (``dot_dtype``: the quotient kernels'
    dot mode, :func:`~nnpde_tpu_torch.kernels.make_fused_wan_u`).

    * ``u_pde_fn(u_net_params, E, v_params, X, wv, dwv, V=None, f=None)``
      returns ``(w_pde * pde_loss [+ w_norm * (vol*mean(u^2)-1)^2], aux)``,
      differentiable in the net params and E;
    * ``v_loss_fn(v_params, u_net_params, E, X, wv, dwv, V=None, f=None)``
      returns ``(loss_v, aux)``, differentiable in ``v_params``.

    ``wv``/``dwv`` are the bump window and its gradient on ``X``
    (:func:`nnpde_tpu_torch.ops.bump_w`), ``V`` the per-point potential,
    ``f`` the source term.
    """
    fused_u = make_fused_wan_u(
        u_model.spec.activation, convention=convention, eps=eps,
        w_pde=w_pde, w_norm=w_norm, vol=vol, dot_dtype=dot_dtype)
    fused_v = make_fused_wan_v(
        v_model.spec.activation, convention=convention, eps=eps,
        objective=objective, log_eps=log_eps, dot_dtype=dot_dtype)

    def u_pde_fn(u_net_params, E, v_params, X, wv, dwv, V=None, f=None):
        v, gv = v_model.value_and_grad(v_params, X, impl=impl)
        phi = wv * v
        gphi = dwv * v[:, None] + wv[:, None] * gv
        phi_norm = torch.mean(phi ** 2)
        Bu = factor_jet_or_one(u_model, X)
        c0 = None if V is None else V * phi
        rhs = None if f is None else -f * phi
        base = linear_functional_coefficients(
            Bu, c0=c0, b0=prefactor * gphi, rhs=rhs, e1=Bu.value,
            e2=Bu.value * phi)
        return fused_u(u_net_params, E, X, base, phi_norm)

    def v_coef_fn(u_net_params, E, X, wv, dwv, V=None, f=None):
        """The critic's coefficient stream, a function of the frozen primal
        only."""
        u, gu = u_model.value_and_grad(u_net_params, X, impl=impl)
        Bv = factor_jet_or_one(v_model, X)
        Wm = wv * Bv.value
        gWm = dwv * Bv.value[:, None] + wv[:, None] * Bv.grad
        wjet = Jet(Wm, gWm, torch.zeros_like(Wm))
        c0 = (V - E) * u if V is not None else -E * u
        if f is not None:
            c0 = c0 - f
        return linear_functional_coefficients(
            wjet, c0=c0, b0=prefactor * gu, e1=Wm)

    def v_loss_from_coef(v_params, X, coef):
        return fused_v(v_params, X, coef)

    def v_loss_fn(v_params, u_net_params, E, X, wv, dwv, V=None, f=None):
        coef = v_coef_fn(u_net_params, E, X, wv, dwv, V=V, f=f)
        return fused_v(v_params, X, coef)

    return FusedWanPair(u_pde_fn, v_loss_fn, v_coef_fn, v_loss_from_coef)


def make_fused_wan_multi_pair(u_model, v_model, n_bumps: int, *,
                              w_pde: float = 1.0, prefactor: float = 0.5,
                              convention: str = "wr2_over_norm",
                              eps: float = 1e-8, objective: str = "neg_log",
                              log_eps: float = 1e-8, impl: str = "kernel",
                              w_norm: float = 0.0, vol: float = 1.0,
                              dot_dtype: str = "float32"):
    """The multi-test-function variant of :func:`make_fused_wan_pair`: one
    weak residual per localised bump ``phi_k = w_k * v``.  ``wv``/``dwv``
    are the stacked bump windows ``(K, N)`` / ``(K, N, d)`` from
    :func:`nnpde_tpu_torch.ops.bump_w_multi`; the objectives are ``mean_k``
    of the per-bump quotients, matching the autograd multibump path.
    ``dot_dtype``: the K-bump kernels' (``'float32'``, ``'bf16x3'`` or
    ``'bfloat16'``, :func:`~nnpde_tpu_torch.kernels.fused_multi_sums`)."""
    fused_u = make_fused_wan_multi_u(
        u_model.spec.activation, n_bumps, convention=convention, eps=eps,
        w_pde=w_pde, w_norm=w_norm, vol=vol, dot_dtype=dot_dtype)
    fused_v = make_fused_wan_multi_v(
        v_model.spec.activation, n_bumps, convention=convention, eps=eps,
        objective=objective, log_eps=log_eps, dot_dtype=dot_dtype)

    def u_pde_fn(u_net_params, E, v_params, X, wv, dwv, V=None, f=None):
        v, gv = v_model.value_and_grad(v_params, X, impl=impl)
        phi = wv * v[None, :]                                  # (K, N)
        gphi = dwv * v[None, :, None] + wv[:, :, None] * gv[None, :, :]   # (K, N, d)
        phi_norms = torch.mean(phi ** 2, dim=1)                # (K,)
        Bu = factor_jet_or_one(u_model, X)
        zero = torch.zeros_like(Bu.value)
        cores = []
        for k in range(n_bumps):
            c0 = V * phi[k] if V is not None else None
            rhs = None if f is None else -f * phi[k]
            cores.append(linear_functional_coefficients(
                Bu, c0=c0, b0=prefactor * gphi[k], rhs=rhs,
                e1=Bu.value if k == 0 else zero,    # mass lane 0 = u mass
                e2=Bu.value * phi[k]))
        base = pack_multibump_coefficients(cores)
        return fused_u(u_net_params, E, X, base, phi_norms)

    def v_coef_fn(u_net_params, E, X, wv, dwv, V=None, f=None):
        """The critic's coefficient stream, a function of the frozen primal
        only: trainers with fixed quadrature build it once per epoch."""
        u, gu = u_model.value_and_grad(u_net_params, X, impl=impl)
        Bv = factor_jet_or_one(v_model, X)
        c0 = (V - E) * u if V is not None else -E * u
        if f is not None:
            c0 = c0 - f
        cores = []
        for k in range(n_bumps):
            Wm = wv[k] * Bv.value
            gWm = dwv[k] * Bv.value[:, None] + wv[k][:, None] * Bv.grad
            wjet = Jet(Wm, gWm, torch.zeros_like(Wm))
            cores.append(linear_functional_coefficients(
                wjet, c0=c0, b0=prefactor * gu, e1=Wm))
        return pack_multibump_coefficients(cores)

    def v_loss_from_coef(v_params, X, coef):
        return fused_v(v_params, X, coef)

    def v_loss_fn(v_params, u_net_params, E, X, wv, dwv, V=None, f=None):
        coef = v_coef_fn(u_net_params, E, X, wv, dwv, V=V, f=f)
        return fused_v(v_params, X, coef)

    return FusedWanPair(u_pde_fn, v_loss_fn, v_coef_fn, v_loss_from_coef)
