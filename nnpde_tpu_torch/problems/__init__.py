from .ipw2d import IPW2DConfig, train_ipw_2d, unit_normalize
from .ipw3d import IPW3DConfig, train_ipw_3d
from .poisson import PoissonConfig, train_poisson_nd

__all__ = ["IPW2DConfig", "IPW3DConfig", "PoissonConfig", "train_ipw_2d", "train_ipw_3d",
           "train_poisson_nd", "unit_normalize"]
