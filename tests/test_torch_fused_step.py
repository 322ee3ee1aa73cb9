"""The port's fused loss+grad steps against the JAX Pallas kernels.

On the CPU the port's wrappers run the plain versions (forward-Laplacian
recurrence + ``torch.autograd``); the JAX side runs the Pallas kernels in
interpret mode, as ``tests/test_fused_step.py`` does.  Same numpy inputs
and parameters for both; N is not a multiple of the tile, so the JAX side
pads.  Tolerance: loss and grad-tree rel <= 1e-5 (the bar of the JAX
kernel's own tests), for the plain versions in float32 and float64.
The CUDA kernels themselves are held to the plain versions on a card by
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.kernels import fused_step as jfs
from nnpde_tpu.models import factor_for_technique as j_factor
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import fused_step as tfs
from nnpde_tpu_torch.models import factor_for_technique

L = 2.0


def _np_params(rng, layers):
    out = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = 1.0 / np.sqrt(n_in)
        out.append((rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                    rng.uniform(-bound, bound, (n_out,)).astype(np.float32)))
    return out


def _tree_rel(a, b):
    num = sum(float(np.sum((np.asarray(x, np.float64) - np.asarray(y, np.float64)) ** 2))
              for (xw, xb), (yw, yb) in zip(a, b) for x, y in ((xw, yw), (xb, yb)))
    den = sum(float(np.sum(np.asarray(y, np.float64) ** 2))
              for yw, yb in b for y in (yw, yb))
    return (num / max(den, 1e-30)) ** 0.5


def _np_grads(grads):
    return [(np.asarray(gW.detach().cpu()), np.asarray(gb.detach().cpu()))
            for gW, gb in grads]


def _case(d, act, seed, N=300, width=16):
    rng = np.random.default_rng(seed)
    pn = _np_params(rng, (d, width, width, width, 1))
    X = rng.uniform(0.0, L, (N, d)).astype(np.float32)
    return rng, pn, X


def _check(jax_out, torch_fn, pn, tensors):
    loss_j, _, grads_j = jax_out
    gj = [(np.asarray(W), np.asarray(b)) for W, b in grads_j]
    for dtype in (torch.float32, torch.float64):
        tp = params_from_jax(pn, dtype=dtype)
        loss_t, aux, grads_t = torch_fn(tp, *[torch.as_tensor(t, dtype=dtype)
                                            for t in tensors])
        assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * max(abs(float(loss_j)), 1e-8)
        assert _tree_rel(_np_grads(grads_t), gj) <= 1e-5
        assert aux["n"] == tensors[0].shape[0]


CASES = [(1, "sin"), (2, "sin"), (2, "tanh"), (5, "sin"), (2, "gelu")]


@pytest.mark.parametrize("d,act", CASES)
def test_linear_residual_plain_matches_jax_kernel(d, act):
    rng, pn, X = _case(d, act, seed=10 + d)
    coef = rng.normal(size=(X.shape[0], d + 4)).astype(np.float32)
    jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in pn]
    out = jfs.fused_linear_residual(jp, jnp.asarray(X), jnp.asarray(coef), act,
                                    weight=3.0, bwd_tile=128, interpret=True)
    _check(out, lambda p, x, c: tfs.fused_linear_residual(p, x, c, act, weight=3.0),
           pn, (X, coef))
    # the trainable-E lane: sum r e net
    _, aux, _ = tfs.fused_linear_residual(params_from_jax(pn, dtype=torch.float64),
                                          torch.as_tensor(X, dtype=torch.float64),
                                          torch.as_tensor(coef, dtype=torch.float64), act)
    want = float(out[1]["sum_r_ufull"])
    assert abs(float(aux["sum_r_ufull"]) - want) <= 1e-4 * max(abs(want), 1e-6)


@pytest.mark.parametrize("d,act", [(1, "sin"), (2, "sin"), (5, "sin"), (2, "tanh")])
def test_poisson_analytic_plain_matches_jax_kernel(d, act):
    _, pn, X = _case(d, act, seed=20 + d)
    ks = tuple(range(1, d + 1))
    jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in pn]
    out = jfs.fused_poisson_analytic(jp, jnp.asarray(X), act, L=L, ks=ks,
                                     weight=1.0, bwd_tile=128, interpret=True)
    _check(out, lambda p, x: tfs.fused_poisson_analytic(p, x, act, L=L, ks=ks),
           pn, (X,))


@pytest.mark.parametrize("d,act", [(1, "sin"), (2, "sin"), (5, "sin"), (2, "tanh")])
def test_drm_energy_plain_matches_jax_kernel(d, act):
    rng, pn, X = _case(d, act, seed=30 + d)
    f = rng.normal(size=(X.shape[0],)).astype(np.float32)
    fj = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(X))
    coef = np.asarray(jfs.drm_coefficients(fj, jnp.asarray(f)))
    jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in pn]
    out = jfs.fused_drm_energy(jp, jnp.asarray(X), jnp.asarray(coef), act,
                               weight=0.5, bwd_tile=128, interpret=True)
    _check(out, lambda p, x, c: tfs.fused_drm_energy(p, x, c, act, weight=0.5),
           pn, (X, coef))


@pytest.mark.parametrize("op", ["poisson", "helmholtz", "schrodinger"])
def test_coefficient_builders_match_jax(op):
    rng = np.random.default_rng(4)
    d, N = 3, 50
    X = rng.uniform(0.0, L, (N, d))
    V = 0.5 * np.sum(X ** 2, axis=1)
    kw = {"poisson": dict(a0=-1.0, rhs=np.sin(X[:, 0])),
          "helmholtz": dict(a0=1.0, c0=4.0),
          "schrodinger": dict(a0=-0.5, c0=V - 1.5, e_lane=True)}[op]
    with jax.enable_x64(True):
        fj = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(X))
        want = np.asarray(jfs.residual_coefficients(fj, **kw))
        want_drm = np.asarray(jfs.drm_coefficients(fj, jnp.asarray(V)))
    tj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(torch.as_tensor(X))
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = tfs.residual_coefficients(tj, **tkw).numpy()
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12)
    got_drm = tfs.drm_coefficients(tj, torch.as_tensor(V)).numpy()
    assert np.allclose(got_drm, want_drm, rtol=1e-12, atol=1e-12)


def test_analytic_coefficients_match_streamed_ones():
    """PoissonSinCoef == residual_coefficients(box-FBC jet, a0=-1, rhs=-f)."""
    from nnpde_tpu_torch.pde.poisson import rhs_f_for_u_sin

    rng = np.random.default_rng(8)
    X = torch.as_tensor(rng.uniform(0.0, L, (64, 3)))
    ks = (1, 2, 1)
    fj = factor_for_technique("FBC", dim=3, kind="box", L=L).jet(X)
    want = tfs.residual_coefficients(fj, a0=-1.0, rhs=-rhs_f_for_u_sin(X, L, ks))
    c, bs, a, rhs = tfs.PoissonSinCoef(L, ks)(X)
    got = torch.stack([c, *bs, a, rhs, torch.zeros_like(c)], dim=1)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_wrappers_reject_bad_input():
    _, pn, X = _case(2, "sin", seed=1, N=10)
    tp = params_from_jax(pn)
    Xt = torch.as_tensor(X)
    with pytest.raises(ValueError):
        tfs.fused_linear_residual(tp, Xt, torch.zeros(10, 5), "sin")
    with pytest.raises(NotImplementedError):
        tfs.fused_linear_residual(tp, Xt, torch.zeros(10, 6), "sin",
                                  dot_dtype="bf16x3")
