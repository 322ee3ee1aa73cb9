"""The jet forward of a raw MLP as one CUDA kernel.

Counterpart of ``nnpde_tpu/kernels/fwdlap_pallas.py::mlp_fwdlap_pallas``
with its forward kernel ``_forward_kernel2``: ``(u, grad u, lap u)`` of the
net at every point, the forward-Laplacian recurrence kept on chip.  A CUDA
tensor goes to ``csrc/fwdlap_forward.cu`` (float32; anything else raises),
a CPU tensor to the plain version, :func:`fwdlap_forward_plain`, which is
:func:`~nnpde_tpu_torch.ops.fwdlap.mlp_fwdlap`.

The backward of the JAX kernel pair (``_backward_kernel``) is not ported
yet (ROADMAP B5): differentiating through :func:`mlp_fwdlap_kernel` raises
instead of returning a zero gradient.  The TPU-only knobs of the JAX
function (``tile``, ``bwd_tile``, ``lane_pack``, ``fwd_impl``,
``concat_streams``) have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.fwdlap import Jet, mlp_fwdlap
from . import _cuda

fwdlap_forward_plain = mlp_fwdlap


def _plan(layers, T: int):
    """Shared-memory floats per block for a tile of T points (the layout of
    fwdlap_forward.cu)."""
    d = layers[0]
    S, wmax = d + 2, max(layers[1:-1])
    return 2 * S * T * wmax + wmax * wmax + T * d + S * T


def fwdlap_forward(params, X, activation: str) -> torch.Tensor:
    """Launch the jet-forward kernel: ``(N, d+2)`` float32 rows ``[u,
    grad_0 .. grad_{d-1}, lap]``."""
    from . import _build

    name = "fwdlap_forward"
    lib = _build.load()
    layers = _cuda.net_layers(name, params, X, activation)
    N, d = X.shape
    X = X.contiguous()
    flat = _cuda.flat_params(params)
    T, smem = _cuda.plan_tile(lambda t: _plan(layers, t))
    dev = X.device
    G = _cuda.grid(name, lib.fwdlap_forward_blocks_per_sm, smem, dev, (N + T - 1) // T)
    out = torch.empty((N, d + 2), dtype=torch.float32, device=dev)
    lay = _cuda.layers_arg(layers)
    _cuda.launch(name, lib.fwdlap_forward_f32, X.data_ptr(), flat.data_ptr(),
                 ctypes.addressof(lay), len(layers), _cuda.ACTS[activation], N, T,
                 G, out.data_ptr(), smem, _cuda.stream(dev), dev=dev)
    return out


class _JetForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, activation, X, *leaves):
        params = [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
        if X.device.type == "cuda":
            return fwdlap_forward(params, X, activation)
        if X.device.type != "cpu":
            raise ValueError(f"no jet-forward path for device {X.device}")
        jet = fwdlap_forward_plain(params, X, activation)
        return torch.cat([jet.value[:, None], jet.grad, jet.lap[:, None]], dim=1)

    @staticmethod
    def backward(ctx, ct):
        raise NotImplementedError(
            "mlp_fwdlap_kernel has no backward yet: the recompute backward "
            "(_backward_kernel) arrives with ROADMAP B5; differentiate "
            "through impl='torch' instead")


def mlp_fwdlap_kernel(params, X, activation: str) -> Jet:
    """Exact ``(u, grad u, lap u)`` of a scalar MLP over a collocation batch
    through the jet-forward kernel (plain version on the CPU)."""
    leaves = [t for pair in params for t in pair]
    out = _JetForward.apply(activation, X, *leaves)
    d = X.shape[1]
    return Jet(value=out[:, 0], grad=out[:, 1:1 + d], lap=out[:, 1 + d])
