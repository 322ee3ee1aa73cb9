from . import calculus, quadrature
from .bump import BUMP_I1, bump_grid, bump_w, bump_w_1d_jet, bump_w_multi
from .fwdlap import (
    Jet,
    activation_jet,
    activation_pack,
    compose_product_jet,
    constant_jet,
    exclusive_products,
    mlp_fwdlap,
)

__all__ = [
    "BUMP_I1",
    "bump_grid",
    "bump_w",
    "bump_w_1d_jet",
    "bump_w_multi",
    "calculus",
    "quadrature",
    "Jet",
    "activation_jet",
    "activation_pack",
    "compose_product_jet",
    "constant_jet",
    "exclusive_products",
    "mlp_fwdlap",
]
