"""The CUDA fused kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and skip where ``torch.cuda.is_available()``
is false.  They import neither jax nor the JAX package, so they also run on
a machine without JAX (``--noconftest`` skips the suite's JAX set-up):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: the float32 kernel against the float64 plain version, loss and
grad-tree rel <= 1e-5; two launches on the same inputs bitwise equal.
"""

import math

import numpy as np
import pytest
import torch

from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import LAUNCHES
from nnpde_tpu_torch.kernels import fused_step as tfs

L = 2.0


def _np_params(rng, layers):
    out = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = 1.0 / math.sqrt(n_in)
        out.append((rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                    rng.uniform(-bound, bound, (n_out,)).astype(np.float32)))
    return out


def _tree_rel(a, b):
    num = sum(float(torch.sum((x.double() - y.double()) ** 2))
              for pa, pb in zip(a, b) for x, y in zip(pa, pb))
    den = sum(float(torch.sum(y.double() ** 2)) for pb in b for y in pb)
    return math.sqrt(num / max(den, 1e-300))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "analytic", "drm"])
@pytest.mark.parametrize("d,layers,act", [
    (2, (2, 64, 64, 64, 64, 1), "sin"),
    (5, (5, 32, 32, 1), "tanh"),
    (3, (3, 128, 96, 1), "gelu"),
])
def test_cuda_kernel_matches_plain(dev, kind, d, layers, act):
    rng = np.random.default_rng(3)
    N = 1000 + 7
    pn = _np_params(rng, layers)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    nc = {"linear": d + 4, "analytic": 0, "drm": d + 2}[kind]
    coef = torch.as_tensor(rng.normal(size=(N, nc)).astype(np.float32), device=dev)
    ks = (1,) * d

    def run(p):
        if kind == "linear":
            return tfs.fused_linear_residual(p, X, coef, act)
        if kind == "drm":
            return tfs.fused_drm_energy(p, X, coef, act)
        return tfs.fused_poisson_analytic(p, X, act, L=L, ks=ks)

    name = {"linear": "fused_linear_residual", "analytic": "fused_poisson_analytic",
            "drm": "fused_drm_energy"}[kind]
    before = LAUNCHES[name]
    tp = params_from_jax(pn, device=dev)
    loss, _, grads = run(tp)
    loss2, _, grads2 = run(tp)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 2
    assert torch.equal(loss, loss2)
    assert all(torch.equal(x, y) for pa, pb in zip(grads, grads2) for x, y in zip(pa, pb))
    tp64 = params_from_jax(pn, device=dev, dtype=torch.float64)
    if kind == "analytic":
        dWs, dbs, sums = tfs.poisson_analytic_plain(
            tp64, X.double(), act, tfs.PoissonSinCoef(L, ks))
        scale = 2.0 / N
    else:
        plain = (tfs.linear_residual_plain if kind == "linear"
                 else tfs.drm_energy_plain)
        dWs, dbs, sums = plain(tp64, X.double(), coef.double(), act)
        scale = (2.0 if kind == "linear" else 1.0) / N
    ref = tfs._scaled_grads(tp64, dWs, dbs, sums, scale)
    want = float(sums[0]) / N
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    assert _tree_rel(grads, ref) <= 1e-5


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(0)
    X = torch.rand(64, 2, device=dev)
    coef = torch.zeros(64, 6, device=dev)
    odd = params_from_jax(_np_params(rng, (2, 30, 1)), device=dev)
    with pytest.raises(ValueError):
        tfs.fused_linear_residual(odd, X, coef, "sin")
    p64 = params_from_jax(_np_params(rng, (2, 32, 1)), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        tfs.fused_linear_residual(p64, X.double(), coef.double(), "sin")
