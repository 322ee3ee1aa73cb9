from . import calculus
from .bump import BUMP_I1, bump_w, bump_w_1d_jet
from .fwdlap import (
    Jet,
    activation_jet,
    compose_product_jet,
    constant_jet,
    exclusive_products,
    mlp_fwdlap,
)

__all__ = [
    "BUMP_I1",
    "bump_w",
    "bump_w_1d_jet",
    "calculus",
    "Jet",
    "activation_jet",
    "compose_product_jet",
    "constant_jet",
    "exclusive_products",
    "mlp_fwdlap",
]
