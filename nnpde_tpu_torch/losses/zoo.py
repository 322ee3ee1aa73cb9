"""The loss zoo as functions on tensors (counterpart of
``nnpde_tpu/losses/zoo.py``; every reduction is a mean over the batch).

The reduced-precision phases hand these functions float32 casts of their
bf16 jets and values, so every reduction runs in float32, as the JAX
callers cast before reducing."""

from __future__ import annotations

import torch


def pinn_poisson(lap, f):
    """``mean((-lap u - f)^2)``."""
    return torch.mean((-lap - f) ** 2)


def pinn_helmholtz(u, lap, k_squared):
    """``mean((lap u + k^2 u)^2)``."""
    return torch.mean((lap + k_squared * u) ** 2)


def pinn_schrodinger(u, lap, V, E):
    """``mean((-1/2 lap u + V u - E u)^2)`` (E may be a trainable scalar)."""
    return torch.mean((-0.5 * lap + V * u - E * u) ** 2)


def drm_poisson_energy(u, grad, f):
    """``mean(1/2 |grad u|^2 - f u)``."""
    return torch.mean(0.5 * torch.sum(grad * grad, dim=-1) - f * u)


def drm_rayleigh(u, grad, V=None, *, den_eps: float = 0.0):
    """Rayleigh quotient ``mean(1/2|grad u|^2 [+ V u^2]) / (mean(u^2) +
    den_eps)``."""
    num = 0.5 * torch.sum(grad * grad, dim=-1)
    if V is not None:
        num = num + V * u * u
    return torch.mean(num) / (torch.mean(u * u) + den_eps)


def drm_rayleigh_unscaled(u, grad, *, den_eps: float = 0.0):
    """``mean(|grad u|^2) / (mean(u^2) + den_eps)``: the infinite-well
    convention (no 1/2 factor)."""
    return torch.mean(torch.sum(grad * grad, dim=-1)) / (torch.mean(u * u) + den_eps)


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


def norm_pointwise(u):
    """``mean((u^2 - 1)^2)`` pointwise (the 1D well's norm loss, not an
    integral)."""
    return torch.mean((u * u - 1.0) ** 2)


def norm_integral(u, volume):
    """``(volume * mean(u^2) - 1)^2``."""
    return (volume * torch.mean(u * u) - 1.0) ** 2


def norm_trapezoid(u, dx):
    """``(sqrt(sum(u^2) dx) - 1)^2``."""
    return (torch.sqrt(torch.sum(u * u) * dx) - 1.0) ** 2


def norm_nontrivial(u, eps: float = 1e-8):
    """``1 / (mean(u^2) + eps)`` — anti-trivial-solution term."""
    return 1.0 / (torch.mean(u * u) + eps)


def data_mse(u_pred, u_data):
    return torch.mean((u_pred - u_data) ** 2)


def orthogonal_projection(u, lower_states, volume, *, eps: float = 1e-8):
    """``sum_k <u, psi_k>^2 / (<psi_k, psi_k> + eps)`` with grid-average
    inner products.  ``lower_states``: (N, k) matrix of lower eigenstates on
    the same collocation points (k may be 0)."""
    if lower_states.shape[1] == 0:
        return torch.zeros((), dtype=u.dtype, device=u.device)
    inner = volume * torch.mean(u[:, None] * lower_states, dim=0)       # (k,)
    norm_sq = volume * torch.mean(lower_states ** 2, dim=0)             # (k,)
    return torch.sum(inner ** 2 / (norm_sq + eps))


def reflection_mse(u, u_reflected, sign: float = 1.0):
    """``mean((u - sign * u_reflected)^2)``: the parity and symmetry
    (x <-> y swap) losses."""
    return torch.mean((u - sign * u_reflected) ** 2)
