from .ipw2d import IPW2DConfig, train_ipw_2d, unit_normalize
from .poisson import PoissonConfig, train_poisson_nd

__all__ = ["IPW2DConfig", "PoissonConfig", "train_ipw_2d", "train_poisson_nd",
           "unit_normalize"]
