"""Solution model = functional MLP composed with an optional trial factor.

Counterpart of ``nnpde_tpu/models/solution.py``: ``u = B * u_raw`` with the
jet of the product formed analytically from the MLP's forward-Laplacian
jet and the factor's closed-form jet, and optionally the raw net applied
to elementwise input features, ``u = B(x) * g(z(x))`` (the hard-Neumann
cosine map, :mod:`.inputmap`).  :class:`ChannelSolutionModel` is the same
composition for a C-output net, every channel times the one factor.
"""

from __future__ import annotations

from typing import Optional

import torch

from torch.func import hessian, jacfwd, vmap

from ..ops import calculus
from ..ops.fwdlap import (ChannelJet, Jet, compose_product_jet, compose_product_jet_channels,
                          mlp_fwdlap, mlp_fwdlap_channels)
from .mlp import (NetSpec, _resolve_activation, init_mlp, mlp_apply_batch,
                  mlp_apply_batch_channels, mlp_apply_point)
from .trial import SeparableFactor


def _check_impl(impl: str) -> None:
    if impl not in ("torch", "kernel"):
        raise NotImplementedError(
            f"impl={impl!r}: this port has impl='torch' (the recurrence "
            "under autograd) and impl='kernel' (the jet kernels, forward "
            "and recompute backward)")


class SolutionModel:
    """Static model description; parameters live in a separate list."""

    def __init__(self, spec: NetSpec, factor: Optional[SeparableFactor] = None,
                 input_map=None):
        self.spec = spec
        self.factor = factor
        # optional elementwise input map with analytic jets (models/inputmap.py):
        # hard-enforces zero-Neumann as the factor hard-enforces Dirichlet
        self.input_map = input_map
        self.dim = spec.layers[0]
        if factor is not None and factor.dim != self.dim:
            raise ValueError(
                f"factor dim {factor.dim} != net input dim {self.dim}"
            )
        if input_map is not None and input_map.dim != self.dim:
            raise ValueError(
                f"input_map dim {input_map.dim} != net input dim {self.dim}"
            )

    def init(self, key, dtype=torch.float32, device=None):
        """The JAX package's ``init(key)`` for a seed or a threefry key pair
        (:func:`~nnpde_tpu_torch.models.mlp.init_mlp`)."""
        return init_mlp(key, self.spec, dtype, device)

    def apply_point(self, params, x):
        z = self.input_map.value(x) if self.input_map is not None else x
        u = mlp_apply_point(params, z, self.spec.activation)
        if self.factor is not None:
            u = u * self.factor.value_point(x)
        return u

    def apply_batch(self, params, X):
        Z = self.input_map.value(X) if self.input_map is not None else X
        u = mlp_apply_batch(params, Z, self.spec.activation)
        if self.factor is not None:
            u = u * self.factor.value(X)
        return u

    def fields(self, params, X, impl: str = "torch", **kernel_kw) -> Jet:
        """(u, grad u, lap u) over the collocation batch by the
        forward-Laplacian recurrence, differentiable in ``params``:
        ``impl='torch'`` through autograd, ``impl='kernel'`` through the
        jet kernels (:func:`~nnpde_tpu_torch.kernels.mlp_fwdlap_kernel`;
        ``kernel_kw`` are its options, e.g. ``fwd_impl='streams'``).  The
        kernels do not take an input map: with one, ``impl='kernel'``
        raises, as the JAX package's ``impl='pallas'`` does."""
        _check_impl(impl)
        if impl == "kernel":
            if self.input_map is not None:
                raise ValueError(
                    "input_map (hard-Neumann features) is supported on the "
                    "torch jet path only: use impl='torch'")
            from ..kernels import mlp_fwdlap_kernel

            jet = mlp_fwdlap_kernel(params, X, self.spec.activation, **kernel_kw)
        else:
            if kernel_kw:
                raise TypeError(f"impl='torch' takes no kernel options, got {kernel_kw}")
            seed = self.input_map.jet(X) if self.input_map is not None else None
            jet = mlp_fwdlap(params, X, self.spec.activation, input_jet=seed)
        if self.factor is not None:
            jet = compose_product_jet(jet, self.factor.jet(X))
        return jet

    def fields_generic(self, params, X) -> Jet:
        """Oracle for :meth:`fields` by ``torch.func`` autodiff."""
        u, g, l = calculus.batched_value_grad_lap(
            lambda x: self.apply_point(params, x)
        )(X)
        return Jet(value=u, grad=g, lap=l)

    def value_and_grad(self, params, X, impl: str = "torch", **kernel_kw):
        """(u, grad u) without the Laplacian (DRM / WAN paths): by
        reverse-mode autodiff vmapped over the batch, or with
        ``impl='kernel'`` from the jet kernels, dropping the Laplacian."""
        _check_impl(impl)
        if impl == "kernel":
            jet = self.fields(params, X, impl="kernel", **kernel_kw)
            return jet.value, jet.grad
        return calculus.batched_value_and_grad_x(
            lambda x: self.apply_point(params, x)
        )(X)


class ChannelSolutionModel:
    """Coupled-system solution model: one MLP parameterises C component
    fields that share the hidden streams (the output layer fans them out).

    The composition contract of :class:`SolutionModel`: an optional scalar
    trial factor multiplies every channel and propagates analytically
    through the jet, and value / grad / lap come back with a trailing
    channel axis.  The Floquet KH atom (2(2M+1) channels, the real and
    imaginary parts of the harmonics) and the subspace eigen-solver (k
    channels) train on it.  The jet is the recurrence only: no kernel."""

    def __init__(self, spec: NetSpec, factor: Optional[SeparableFactor] = None):
        self.spec = spec
        self.factor = factor
        self.dim = spec.layers[0]
        self.channels = spec.layers[-1]
        if factor is not None and factor.dim != self.dim:
            raise ValueError(
                f"factor dim {factor.dim} != net input dim {self.dim}"
            )

    def init(self, key, dtype=torch.float32, device=None):
        """The JAX package's ``init(key)`` for a seed or a threefry key pair
        (:func:`~nnpde_tpu_torch.models.mlp.init_mlp`)."""
        return init_mlp(key, self.spec, dtype, device)

    def apply_batch(self, params, X):
        u = mlp_apply_batch_channels(params, X, self.spec.activation)
        if self.factor is not None:
            u = u * self.factor.value(X)[:, None]
        return u

    def fields(self, params, X) -> ChannelJet:
        """Per-channel (u, grad u, lap u) over the batch, differentiable in
        ``params``."""
        jet = mlp_fwdlap_channels(params, X, self.spec.activation)
        if self.factor is not None:
            jet = compose_product_jet_channels(jet, self.factor.jet(X))
        return jet

    def fields_generic(self, params, X) -> ChannelJet:
        """Oracle for :meth:`fields` by ``torch.func`` autodiff."""
        def f(x):
            u = calculus_point_channels(params, x, self.spec.activation)
            if self.factor is not None:
                u = u * self.factor.value_point(x)
            return u

        val = vmap(f)(X)
        grad = vmap(jacfwd(f))(X).transpose(1, 2)
        lap = torch.diagonal(vmap(hessian(f))(X), dim1=2, dim2=3).sum(-1)
        return ChannelJet(value=val, grad=grad, lap=lap)


def calculus_point_channels(params, x, activation: str):
    """Per-point multi-output forward: x (d,) -> (C,)."""
    act = _resolve_activation(activation)
    h = x
    for (W, b) in params[:-1]:
        h = act(h @ W + b)
    W, b = params[-1]
    return h @ W + b
