from . import calculus
from .fwdlap import (
    Jet,
    activation_jet,
    compose_product_jet,
    constant_jet,
    exclusive_products,
    mlp_fwdlap,
)

__all__ = [
    "calculus",
    "Jet",
    "activation_jet",
    "compose_product_jet",
    "constant_jet",
    "exclusive_products",
    "mlp_fwdlap",
]
