"""The CUDA kernels against their plain versions, on a card.

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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwdlap_forward", "linear_sums", "linear_seeded",
                                  "quad_sums", "quad_seeded"])
@pytest.mark.parametrize("layers,act,lap", [
    ((2, 64, 64, 64, 64, 1), "sin", 0),
    ((2, 64, 64, 1), "sin", 0),
    ((5, 32, 32, 1), "tanh", 1),
])
def test_cuda_wan_kernel_matches_plain(dev, kind, layers, act, lap):
    """The WAN path's kernels: the jet per column, every sum within 1e-5 of
    the sum of its terms' magnitudes, the seeded grad row rel <= 1e-5; two
    launches bitwise equal."""
    from nnpde_tpu_torch.kernels import fused_quotient as tfq
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    if kind.startswith("quad"):
        lap = 0
    rng = np.random.default_rng(5)
    N, d = 1000 + 7, layers[0]
    pn = _np_params(rng, layers)
    tp = params_from_jax(pn, device=dev)
    tp64 = params_from_jax(pn, device=dev, dtype=torch.float64)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    nc = d + 5 if kind.startswith("linear") else d + 3
    coef = torch.as_tensor(rng.normal(size=(N, nc)).astype(np.float32), device=dev)
    scal = torch.tensor([0.3, -0.2, 0.7][:3 if kind.startswith("linear") else 2], device=dev)
    before = LAUNCHES[kind]
    if kind == "fwdlap_forward":
        out, out2 = tfc.fwdlap_forward(tp, X, act), tfc.fwdlap_forward(tp, X, act)
    else:
        out = tfq._launch(kind, tp, X, coef, scal, act, lap)
        out2 = tfq._launch(kind, tp, X, coef, scal, act, lap)
    torch.cuda.synchronize()
    assert LAUNCHES[kind] == before + 2
    assert torch.equal(out, out2)
    X64, c64, s64 = X.double(), coef.double(), scal.double()
    if kind == "fwdlap_forward":
        jet = tfc.fwdlap_forward_plain(tp64, X64, act)
        ref = torch.cat([jet.value[:, None], jet.grad, jet.lap[:, None]], dim=1)
        for c in range(d + 2):
            assert (torch.linalg.norm(out[:, c].double() - ref[:, c])
                    <= 1e-5 * torch.linalg.norm(ref[:, c]))
        return
    jet = tfc.fwdlap_forward_plain(tp64, X64, act)
    if kind.startswith("linear"):
        r = (c64[:, 0] * jet.value + torch.sum(c64[:, 1:1 + d] * jet.grad, dim=1)
             + c64[:, d + 2] + lap * c64[:, d + 1] * jet.lap)
        scale = torch.stack([r.abs().sum(), (r * r).sum(),
                             ((c64[:, d + 3] * jet.value) ** 2).sum(),
                             (c64[:, d + 4] * jet.value).abs().sum()])
    else:
        u = c64[:, 0] * jet.value
        G = c64[:, 0:1] * jet.grad + c64[:, 1:1 + d] * jet.value[:, None]
        e = 0.5 * torch.sum(G * G, dim=1) - c64[:, d + 1] * u + c64[:, d + 2] * u * u
        scale = torch.stack([e.abs().sum(), (u * u).sum()])
    if kind == "linear_sums":
        ref = tfq.linear_sums_plain(tp64, X64, c64, act, no_lap=lap == 0)
    elif kind == "quad_sums":
        ref = tfq.quad_sums_plain(tp64, X64, c64, act)
    if kind.endswith("sums"):
        assert torch.all(torch.abs(out.double() - ref) <= 1e-5 * scale)
        return
    if kind == "linear_seeded":
        dWs, dbs, sums = tfq.linear_seeded_plain(tp64, X64, c64, s64, act, no_lap=lap == 0)
    else:
        dWs, dbs, sums = tfq.quad_seeded_plain(tp64, X64, c64, s64, act)
    got = tfs._unflatten(tp, out)
    assert _tree_rel([got[0], got[1][:-1]], [dWs, dbs[:-1]]) <= 1e-5
    assert abs(float(got[2][0]) - float(sums[0])) <= 1e-5 * abs(float(sums[0]))
