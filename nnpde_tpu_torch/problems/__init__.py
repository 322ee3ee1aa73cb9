from .ipw import IPW1DConfig, IPW1DWanConfig, train_ipw_1d, train_ipw_1d_wan
from .ipw2d import IPW2DConfig, train_ipw_2d, unit_normalize
from .ipw3d import IPW3DConfig, train_ipw_3d
from .kh import KHCompareConfig, KHConfig, run_compare, train_kh
from .kh_floquet import KHFloquetConfig, train_kh_floquet
from .poisson import PoissonConfig, train_poisson_nd
from .qho import QHO1DConfig, QHO1DWanConfig, train_qho_1d, train_qho_1d_wan
from .qho2d import QHO2DConfig, train_qho_2d

__all__ = ["IPW1DConfig", "IPW1DWanConfig", "IPW2DConfig", "IPW3DConfig", "KHCompareConfig",
           "KHConfig", "KHFloquetConfig", "PoissonConfig", "QHO1DConfig", "QHO1DWanConfig",
           "QHO2DConfig", "run_compare", "train_ipw_1d", "train_ipw_1d_wan", "train_ipw_2d",
           "train_ipw_3d", "train_kh", "train_kh_floquet", "train_poisson_nd", "train_qho_1d",
           "train_qho_1d_wan", "train_qho_2d", "unit_normalize"]
