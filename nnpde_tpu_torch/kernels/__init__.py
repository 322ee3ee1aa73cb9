from .fused_step import (
    LAUNCHES,
    PoissonSinCoef,
    drm_coefficients,
    fused_drm_energy,
    fused_linear_residual,
    fused_poisson_analytic,
    fused_residual_analytic,
    reset_launches,
    residual_coefficients,
)

__all__ = [
    "LAUNCHES",
    "PoissonSinCoef",
    "drm_coefficients",
    "fused_drm_energy",
    "fused_linear_residual",
    "fused_poisson_analytic",
    "fused_residual_analytic",
    "reset_launches",
    "residual_coefficients",
]
