from .zoo import (
    data_mse,
    drm_poisson_energy,
    norm_nontrivial,
    pinn_poisson,
    wan_pde_loss,
    wan_weak_residual,
)

__all__ = [
    "data_mse",
    "drm_poisson_energy",
    "norm_nontrivial",
    "pinn_poisson",
    "wan_pde_loss",
    "wan_weak_residual",
]
