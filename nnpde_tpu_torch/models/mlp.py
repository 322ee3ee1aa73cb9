"""Functional MLP as a list of ``(W (in, out), b (out,))`` tensors.

Counterpart of ``nnpde_tpu/models/mlp.py``.  The ``(in, out)`` layout is
kept (no ``nn.Linear``, whose weight is ``(out, in)``), so parameters move
between the packages without a transpose and feed the fused kernels as
they are.  :func:`init_mlp` draws the JAX package's weights for a seed or
a threefry key, bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..prng import threefry_key, threefry_split, threefry_uniform


class NetSpec(NamedTuple):
    layers: Tuple[int, ...]          # e.g. (1, 50, 50, 50, 1)
    activation: str = "tanh"         # 'tanh' | 'sin' | 'gelu'
    init: str = "auto"               # 'auto' | 'torch_default' | 'xavier_tanh'

    def resolved_init(self) -> str:
        if self.init != "auto":
            return self.init
        return "xavier_tanh" if self.activation == "tanh" else "torch_default"


def init_mlp(key, spec: NetSpec, dtype=torch.float32, device=None):
    """The JAX package's ``init_mlp(key, spec)``, bit for bit: the layer keys
    split from ``key``, each split again for W and b, drawn by
    :func:`~nnpde_tpu_torch.prng.threefry_uniform` on the host.  ``key`` is
    a seed (``jax.random.PRNGKey(seed)``) or a threefry key pair (e.g. from
    :func:`~nnpde_tpu_torch.prng.threefry_split` or ``threefry_fold_in``)."""
    scheme = spec.resolved_init()
    key = tuple(key) if isinstance(key, (tuple, list, np.ndarray)) else threefry_key(int(key))
    keys = threefry_split(key, len(spec.layers) - 1)
    params = []
    for k, fan_in, fan_out in zip(keys, spec.layers[:-1], spec.layers[1:]):
        kw, kb = threefry_split(k, 2)
        if scheme == "xavier_tanh":
            bound = (5.0 / 3.0) * math.sqrt(6.0 / (fan_in + fan_out))
            W = threefry_uniform(kw, (fan_in, fan_out), -bound, bound)
            b = np.zeros((fan_out,), np.float32)
        elif scheme == "torch_default":
            bound = 1.0 / math.sqrt(fan_in)
            W = threefry_uniform(kw, (fan_in, fan_out), -bound, bound)
            b = threefry_uniform(kb, (fan_out,), -bound, bound)
        else:
            raise ValueError(f"Unknown init scheme {scheme!r}")
        params.append(tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (W, b)))
    return params


def _gelu(v):
    return torch.nn.functional.gelu(v, approximate="none")


_ACTIVATIONS = {"sin": torch.sin, "tanh": torch.tanh, "gelu": _gelu}


def _resolve_activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation {name!r}") from None


def mlp_apply_point(params, x, activation: str):
    """Per-point forward: x (d,) -> scalar."""
    act = _resolve_activation(activation)
    h = x
    for (W, b) in params[:-1]:
        h = act(h @ W + b)
    W, b = params[-1]
    return (h @ W + b)[0]


def mlp_apply_batch(params, X, activation: str):
    """Batched forward: X (N, d) -> (N,)."""
    act = _resolve_activation(activation)
    h = X
    for (W, b) in params[:-1]:
        h = act(h @ W + b)
    W, b = params[-1]
    return (h @ W + b)[..., 0]


def mlp_apply_batch_channels(params, X, activation: str):
    """Batched multi-output forward: X (N, d) -> (N, C)."""
    act = _resolve_activation(activation)
    h = X
    for (W, b) in params[:-1]:
        h = act(h @ W + b)
    W, b = params[-1]
    return h @ W + b


def num_params(params) -> int:
    """Entries of every ``(W, b)`` leaf of ``params``."""
    return sum(W.numel() + b.numel() for W, b in params)
