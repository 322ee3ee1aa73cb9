"""Runtime helpers: device resolution, precision pinning, dispatch caps.

The JAX package's compilation-cache code has no counterpart: PyTorch runs
eagerly and the CUDA kernels are built once per process
(:mod:`nnpde_tpu_torch.kernels._build`).
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"`` -> the CUDA device, raising when there is none
    (never a silent CPU fallback); ``"cpu"`` only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nnpde_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def pin_fp32_precision() -> None:
    """Full-fp32 matmuls and convolutions: second derivatives are
    precision-sensitive (the JAX trainer pins
    ``default_matmul_precision('highest')``), and TF32 keeps ~3 digits.
    bf16 matmuls (the ``compute_dtype='bfloat16'`` phases) accumulate in
    fp32, as JAX's bf16 dots do: cuBLAS may otherwise reduce bf16 products
    in reduced precision (PyTorch's default allows it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def pallas_chunk_cap() -> int:
    """Epoch-chunk cap on the kernel path (``NNPDE_PALLAS_CHUNK_CAP``,
    0 = uncapped); the same knob as the JAX package's, default 1000."""
    cap = int(os.environ.get("NNPDE_PALLAS_CHUNK_CAP", 1000))
    return cap if cap > 0 else 1 << 30


def scan_chunk_cap() -> int:
    """Epochs per history flush in :func:`~nnpde_tpu_torch.train.fit`
    (``NNPDE_SCAN_CHUNK_CAP``, 0 = uncapped)."""
    cap = int(os.environ.get("NNPDE_SCAN_CHUNK_CAP", "0"))
    return cap if cap > 0 else 1 << 30
