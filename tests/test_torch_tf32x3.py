"""The precision argument for tensor-core products in the fused kernels.

A TF32 tensor-core product keeps 10 explicit mantissa bits of each operand.
The 3xTF32 split writes each fp32 operand as ``hi + lo`` (both TF32) and
adds three products, small terms first, in fp32:

    a @ b  ~  (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi

dropping ``a_lo @ b_lo`` (~2^-22 relative).  This file emulates both the
split and the single-pass product in torch on the CPU, runs them through the
plain forward-Laplacian recurrence (``ops/fwdlap.py``) wherever the CUDA
kernels run a shared-memory product (the hidden-to-hidden layers, forward
and reverse), and holds the results to the float64 route: the split must
stay within the kernels' 1e-5 bar on value, gradient columns and the seeded
dW of the multibump pass B, and the single pass must miss it (so the test
would catch a dropped term).  Inputs are numpy-seeded; no accelerator and no
JAX are needed.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from nnpde_tpu_torch.kernels.fused_multibump import fused_multi_seeded_grads_plain
from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap

U50 = (2, 50, 50, 50, 50, 1)
C20 = (2, 20, 20, 20, 1)
U64 = (2, 64, 64, 64, 64, 1)
NETS = {"u50": U50, "c20": C20, "u64": U64}
N, KB, TOL = 2000, 16, 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 as ``cvt.rna.tf32.f32`` does: nearest, ties away
    from zero, 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32x3(a, b):
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (torch.mm(a_lo, b_hi) + torch.mm(a_hi, b_lo)) + torch.mm(a_hi, b_hi)


def mm_tf32x1(a, b):
    return torch.mm(tf32(a), tf32(b))


def emulated_matmul(mm):
    """A replacement for ``Tensor.__matmul__`` that sends the products the
    kernels run from shared memory (2D, inner and outer width above 4:
    hidden to hidden) through ``mm`` in the forward and in both products of
    the backward; every other product stays exact fp32."""
    plain = torch.Tensor.__matmul__

    class Product(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, w):
            ctx.save_for_backward(a, w)
            return mm(a, w)

        @staticmethod
        def backward(ctx, g):
            a, w = ctx.saved_tensors
            g = g.contiguous()
            return mm(g, w.t().contiguous()), mm(a.t().contiguous(), g)

    def matmul(a, w):
        if (a.dtype == torch.float32 and a.ndim == 2 and w.ndim == 2
                and min(w.shape) > 4):
            return Product.apply(a, w)
        return plain(a, w)

    return matmul


def _case(layers, seed):
    rng = np.random.default_rng(seed)
    d = layers[0]
    params = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = 1.0 / np.sqrt(n_in)
        params.append((rng.uniform(-bound, bound, (n_in, n_out)),
                       rng.uniform(-bound, bound, (n_out,))))
    X = rng.uniform(0.0, 2.0, (N, d))
    coef = rng.normal(size=(N, KB * (d + 4)))
    scal = rng.normal(size=(3 * KB,))
    return params, X, coef, scal


def _route(case, dtype, mm=None):
    """(jet columns (N, d+2), flat seeded gradients) on one route."""
    params, X, coef, scal = case
    p = [(torch.as_tensor(W, dtype=dtype), torch.as_tensor(b, dtype=dtype))
         for W, b in params]
    X, coef, scal = (torch.as_tensor(t, dtype=dtype) for t in (X, coef, scal))

    def run():
        jet = mlp_fwdlap(p, X, "sin")
        cols = torch.cat([jet.value[:, None], jet.grad, jet.lap[:, None]], dim=1)
        dWs, dbs, _ = fused_multi_seeded_grads_plain(p, X, coef, scal, "sin", KB)
        flat = torch.cat([t.reshape(-1) for pair in zip(dWs, dbs) for t in pair])
        return cols.double(), flat.double()

    if mm is None:
        return run()
    with mock.patch.object(torch.Tensor, "__matmul__", emulated_matmul(mm)):
        return run()


def _errors(got, ref):
    cols, flat = got
    rcols, rflat = ref
    col = max(float(torch.linalg.norm(cols[:, c] - rcols[:, c]) / torch.linalg.norm(rcols[:, c]))
              for c in range(rcols.shape[1]))
    return col, float(torch.linalg.norm(flat - rflat) / torch.linalg.norm(rflat))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=4096).astype(np.float32) * 37.0)
    hi = tf32(x)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert float(torch.max(torch.abs(hi - x) / torch.abs(x))) <= 2.0 ** -11
    lo = tf32(x - hi)
    # hi + lo carries 22 bits: what the split drops is ~2^-22 of the operand
    assert float(torch.max(torch.abs((hi + lo) - x) / torch.abs(x))) <= 2.0 ** -21


def test_split_product_is_fp32_grade_and_single_pass_is_not():
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.normal(size=(256, 52)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(52, 52)).astype(np.float32))
    ref = a.double() @ b.double()
    scale = float(torch.linalg.norm(ref))
    err3 = float(torch.linalg.norm(mm_tf32x3(a, b).double() - ref)) / scale
    err1 = float(torch.linalg.norm(mm_tf32x1(a, b).double() - ref)) / scale
    err32 = float(torch.linalg.norm(torch.mm(a, b).double() - ref)) / scale
    assert err3 <= 4.0 * max(err32, 1e-7)
    assert err1 >= 1e-4


@pytest.mark.parametrize("net", sorted(NETS))
def test_tf32x3_recurrence_within_kernel_bar(net):
    case = _case(NETS[net], seed=10 + len(net))
    ref = _route(case, torch.float64)
    col, grad = _errors(_route(case, torch.float32, mm_tf32x3), ref)
    col32, grad32 = _errors(_route(case, torch.float32), ref)
    assert col <= TOL and grad <= TOL, (col, grad)
    # and no worse than a small multiple of the exact fp32 route
    assert col <= 4.0 * max(col32, 1e-7) and grad <= 4.0 * max(grad32, 1e-7)


@pytest.mark.parametrize("net", sorted(NETS))
def test_single_pass_tf32_misses_kernel_bar(net):
    case = _case(NETS[net], seed=10 + len(net))
    ref = _route(case, torch.float64)
    col, grad = _errors(_route(case, torch.float32, mm_tf32x1), ref)
    assert col > TOL and grad > TOL, (col, grad)
