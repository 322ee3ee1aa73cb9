"""The loss zoo as functions on tensors (counterpart of
``nnpde_tpu/losses/zoo.py``; every reduction is a mean over the batch)."""

from __future__ import annotations

import torch


def pinn_poisson(lap, f):
    """``mean((-lap u - f)^2)``."""
    return torch.mean((-lap - f) ** 2)


def drm_poisson_energy(u, grad, f):
    """``mean(1/2 |grad u|^2 - f u)``."""
    return torch.mean(0.5 * torch.sum(grad * grad, dim=-1) - f * u)


def wan_weak_residual(gu, phi, gphi, u=None, *, V=None, E=None, f=None,
                      prefactor: float = 0.5):
    """Mean weak-form integrand ``mean(pref gu.gphi + (V u - E u) phi - f phi)``."""
    integrand = prefactor * torch.sum(gu * gphi, dim=-1)
    if V is not None:
        integrand = integrand + V * u * phi
    if E is not None:
        integrand = integrand - E * u * phi
    if f is not None:
        integrand = integrand - f * phi
    return torch.mean(integrand)


def wan_pde_loss(weak_residual, phi_norm, *, eps: float = 1e-8,
                 convention: str = "wr2_over_norm"):
    """``wr^2 / (|phi|^2 + eps)`` or ``(wr / (|phi|^2 + eps))^2``."""
    if convention == "wr2_over_norm":
        return weak_residual ** 2 / (phi_norm + eps)
    if convention == "ratio_sq":
        return (weak_residual / (phi_norm + eps)) ** 2
    raise ValueError(f"Unknown WAN convention {convention!r}")


def norm_nontrivial(u, eps: float = 1e-8):
    """``1 / (mean(u^2) + eps)`` — anti-trivial-solution term."""
    return 1.0 / (torch.mean(u * u) + eps)


def data_mse(u_pred, u_data):
    return torch.mean((u_pred - u_data) ** 2)
