"""The plain bf16-dot jet forward in other sound rounding orders, the basis
of row 4 bf16's bar (``ROADMAP.md`` C4; ``kernels/fwdlap_cuda.py::
c4_columns``), on the CPU.

Each order computes the same function: in float64 every order agrees with
the plain version to rounding (1e-12), and in float32 the products' orders
differ only by float32 roundings.  ``"k"`` is the k-ordered chain the
kernel's products on the CUDA cores take; ``"contracted"`` fuses the
stage's multiply-adds as nvcc compiles the kernels.  Cost: about 2 s.
"""

import math

import numpy as np
import pytest
import torch

from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc
from nnpde_tpu_torch.ops.fwdlap import (SUM_ORDERS, _stage, activation_pack,
                                        contracted_stage, ordered_matmul)

LAYERS = (1, 24, 20, 16, 1)


def _params(rng, layers, dtype):
    out = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = 1.0 / math.sqrt(n_in)
        out.append((torch.as_tensor(rng.uniform(-bound, bound, (n_in, n_out)), dtype=dtype),
                    torch.as_tensor(rng.uniform(-bound, bound, (n_out,)), dtype=dtype)))
    return out


@pytest.mark.parametrize("order", SUM_ORDERS)
def test_ordered_matmul_is_the_product(order):
    """Each sum order is ``A @ W``: to rounding in float64, and within
    float32 sum noise in float32; an unknown order raises."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(3, 50, 37))
    W = rng.normal(size=(37, 11))
    got = ordered_matmul(order)(torch.as_tensor(A), torch.as_tensor(W)).numpy()
    assert np.max(np.abs(got - A @ W)) <= 1e-12 * np.max(np.abs(A @ W))
    got32 = ordered_matmul(order)(torch.as_tensor(A, dtype=torch.float32),
                                  torch.as_tensor(W, dtype=torch.float32)).numpy()
    assert np.max(np.abs(got32 - A @ W)) <= 1e-5 * np.max(np.abs(A @ W))
    with pytest.raises(ValueError, match="sum order"):
        ordered_matmul("random")


@pytest.mark.parametrize("act", ["sin", "tanh"])
def test_contracted_stage_is_the_stage(act):
    """The stage with its multiply-adds fused is the stage: equal to
    rounding in float64; the contracted tanh pack's ``1 - t^2`` is the
    float32 rounding of the exact value.  gelu raises."""
    rng = np.random.default_rng(2)
    v = torch.as_tensor(rng.normal(size=(40, 9)))
    J = torch.as_tensor(rng.normal(size=(2, 40, 9)))
    l = torch.as_tensor(rng.normal(size=(40, 9)))
    want, got = _stage(act, v, J, l), contracted_stage(act, v, J, l)
    for a, b in zip(want[0] + (want[1],) + want[2], got[0] + (got[1],) + got[2]):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)
    if act == "tanh":
        v32 = v.float()
        t = torch.tanh(v32)
        exact = (1.0 - t.double() ** 2).float()
        assert torch.equal(contracted_stage(act, v32, J.float(), l.float())[0][1], exact)
        assert torch.equal(activation_pack(act, v32)[0], t)
    with pytest.raises(ValueError, match="sin and tanh"):
        contracted_stage("gelu", v, J, l)


@pytest.mark.parametrize("act", ["sin", "tanh"])
def test_plain_forward_orders_compute_the_same_jet(act):
    """``fwdlap_forward_default_plain(order=...)``: in float64 every order
    of ``ROUNDING_ORDERS`` is the plain version to rounding (the same bf16
    roundings of the same values); in float32 each stays within the bf16
    roundings' reach of it.  An unknown order raises."""
    rng = np.random.default_rng(3)
    p64 = _params(rng, LAYERS, torch.float64)
    X = torch.as_tensor(rng.uniform(0.0, 2.0, (64, 1)))
    want = tfc.fwdlap_forward_default_plain(p64, X, act)
    for order in tfc.ROUNDING_ORDERS:
        got = tfc.fwdlap_forward_default_plain(p64, X, act, order)
        assert torch.allclose(got, want, rtol=1e-9, atol=1e-12), order
    p32 = [(W.float(), b.float()) for W, b in p64]
    plain = tfc.fwdlap_forward_default_plain(p32, X.float(), act)
    for order in tfc.ROUNDING_ORDERS:
        got = tfc.fwdlap_forward_default_plain(p32, X.float(), act, order)
        assert torch.allclose(got, plain, rtol=1e-2, atol=1e-3 * float(plain.abs().max()))
    with pytest.raises(ValueError, match="Unknown order"):
        tfc.fwdlap_forward_default_plain(p32, X.float(), act, "halves")


def test_c4_columns_of_the_plain_version():
    """``c4_columns`` given the plain version itself: its distance is the
    plain version's, the spread the largest of the orders' distances from
    it, and the bar the larger of 2x the plain distance + 2e-6 and the plain
    distance + ``C4_SPREAD_MULTIPLE`` x the spread."""
    rng = np.random.default_rng(4)
    p32 = _params(rng, LAYERS, torch.float32)
    X = torch.as_tensor(rng.uniform(0.0, 2.0, (256, 1)), dtype=torch.float32)
    plain = tfc.fwdlap_forward_default_plain(p32, X, "tanh")
    cols = tfc.c4_columns(p32, X, "tanh", plain)
    assert [c["column"] for c in cols] == [0, 1, 2]
    for c in cols:
        assert c["kernel"] == c["plain"] and c["spread"] >= 0.0
        assert c["bar"] == max(2.0 * c["plain"] + 2e-6,
                               c["plain"] + tfc.C4_SPREAD_MULTIPLE * c["spread"])
