"""nnpde_tpu_torch — the PyTorch/CUDA port of ``nnpde_tpu``.

Mirrors the JAX package's module paths (``ops/fwdlap.py``,
``models/solution.py``, ``train/trainer.py``, ``kernels/fused_step.py``,
``problems/poisson.py`` ...) so each counterpart is found at the same
place.  Parameters keep the JAX layout ``[(W (in, out), b (out,)), ...]``;
weights carried over from the JAX package go through
:func:`nnpde_tpu_torch.interop.params_from_jax`.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the hand-written CUDA kernels (``csrc/``) are built on
first use.  This package imports neither ``jax`` nor ``nnpde_tpu``.
"""

from .runtime import resolve_device

# -- the JAX package's convenience top-level API ------------------------------
from .pde.kh import KHGroundTruth  # noqa: E402
from .problems.ipw import IPW1DConfig, IPW1DWanConfig, train_ipw_1d, train_ipw_1d_wan  # noqa: E402
from .problems.ipw2d import IPW2DConfig, train_ipw_2d  # noqa: E402
from .problems.kh import KHCompareConfig, KHConfig, run_compare, train_kh  # noqa: E402
from .problems.poisson import PoissonConfig, train_poisson_nd  # noqa: E402
from .problems.qho import QHO1DConfig, QHO1DWanConfig, train_qho_1d, train_qho_1d_wan  # noqa: E402
from .problems.qho2d import QHO2DConfig, train_qho_2d  # noqa: E402

__all__ = ["IPW1DConfig", "IPW1DWanConfig", "IPW2DConfig", "KHCompareConfig", "KHConfig",
           "KHGroundTruth", "PoissonConfig", "QHO1DConfig", "QHO1DWanConfig", "QHO2DConfig",
           "resolve_device", "run_compare", "train_ipw_1d", "train_ipw_1d_wan", "train_ipw_2d",
           "train_kh", "train_poisson_nd", "train_qho_1d", "train_qho_1d_wan", "train_qho_2d"]
