from . import calculus, quadrature
from .bump import BUMP_I1, bump_grid, bump_w, bump_w_1d_jet, bump_w_multi
from .fwdlap import (
    ChannelJet,
    Jet,
    activation_jet,
    activation_pack,
    compose_product_jet,
    compose_product_jet_channels,
    constant_jet,
    exclusive_products,
    mlp_fwdlap,
    mlp_fwdlap_channels,
)

__all__ = [
    "BUMP_I1",
    "bump_grid",
    "bump_w",
    "bump_w_1d_jet",
    "bump_w_multi",
    "calculus",
    "quadrature",
    "ChannelJet",
    "Jet",
    "activation_jet",
    "activation_pack",
    "compose_product_jet",
    "compose_product_jet_channels",
    "constant_jet",
    "exclusive_products",
    "mlp_fwdlap",
    "mlp_fwdlap_channels",
]
