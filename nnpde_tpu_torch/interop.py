"""Carry parameters across frameworks as numpy arrays.

JAX draws the MLP weights from ``jax.random``, which torch cannot
reproduce, so every parity check transfers them: both packages use the
``[(W (in, out), b (out,)), ...]`` layout, so no transpose is involved.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def params_from_jax(params_np: Sequence[Tuple], device="cpu",
                    dtype=torch.float32) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``[(W_np, b_np), ...]`` (numpy or any array with ``__array__``) ->
    ``[(W, b), ...]`` torch tensors on ``device`` in ``dtype``."""
    return [
        (torch.as_tensor(np.asarray(W), dtype=dtype, device=device).clone(),
         torch.as_tensor(np.asarray(b), dtype=dtype, device=device).clone())
        for W, b in params_np
    ]


def params_to_numpy(params) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The reverse of :func:`params_from_jax`."""
    return [(W.detach().cpu().numpy(), b.detach().cpu().numpy())
            for W, b in params]
