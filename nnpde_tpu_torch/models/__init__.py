from .inputmap import CosineInputMap
from .mlp import NetSpec, init_mlp, mlp_apply_batch, mlp_apply_batch_channels, mlp_apply_point
from .solution import ChannelSolutionModel, SolutionModel
from .trial import SeparableFactor, factor_for_technique, unit_factor

__all__ = [
    "ChannelSolutionModel",
    "CosineInputMap",
    "NetSpec",
    "init_mlp",
    "mlp_apply_batch",
    "mlp_apply_batch_channels",
    "mlp_apply_point",
    "SolutionModel",
    "SeparableFactor",
    "factor_for_technique",
    "unit_factor",
]
