from ._cuda import LAUNCHES, reset_launches
from .fused_quotient import (
    fused_linear_sums,
    fused_quad_seeded_grads,
    fused_quad_sums,
    fused_seeded_grads,
    linear_functional_coefficients,
    make_fused_quad_mean,
    make_fused_rayleigh,
    make_fused_wan_u,
    make_fused_wan_v,
    quotient_coefficients,
)
from .fused_step import (
    PoissonSinCoef,
    drm_coefficients,
    fused_drm_energy,
    fused_linear_residual,
    fused_poisson_analytic,
    fused_residual_analytic,
    residual_coefficients,
)
from .fwdlap_cuda import mlp_fwdlap_kernel

__all__ = [
    "LAUNCHES",
    "PoissonSinCoef",
    "drm_coefficients",
    "fused_drm_energy",
    "fused_linear_residual",
    "fused_linear_sums",
    "fused_poisson_analytic",
    "fused_quad_seeded_grads",
    "fused_quad_sums",
    "fused_residual_analytic",
    "fused_seeded_grads",
    "linear_functional_coefficients",
    "make_fused_quad_mean",
    "make_fused_rayleigh",
    "make_fused_wan_u",
    "make_fused_wan_v",
    "mlp_fwdlap_kernel",
    "quotient_coefficients",
    "reset_launches",
    "residual_coefficients",
]
