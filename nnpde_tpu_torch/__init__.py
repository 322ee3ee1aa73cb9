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

__all__ = ["resolve_device"]
