"""Parity of the PyTorch port's recurrence, oracle, factors and samplers
with the JAX package.

Inputs and parameters are made with numpy from a seed and handed to both
packages (JAX through numpy, torch through ``params_from_jax``).
Tolerances: float64 (JAX under ``enable_x64``) rel <= 1e-10 — the two
evaluate the same formulas, differing only in summation order; float32
rel <= 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.models import NetSpec as JNetSpec
from nnpde_tpu.models import SolutionModel as JSolutionModel
from nnpde_tpu.models import factor_for_technique as j_factor
from nnpde_tpu.ops import calculus as j_calculus
from nnpde_tpu.ops import fwdlap as j_fwdlap
from nnpde_tpu.sampling import sobol_unit as j_sobol_unit
from nnpde_tpu_torch.interop import params_from_jax, params_to_numpy
from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
from nnpde_tpu_torch.ops import fwdlap
from nnpde_tpu_torch.sampling import sobol_unit


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _np_params(rng, layers, dtype):
    out = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = 1.0 / np.sqrt(n_in)
        out.append((rng.uniform(-bound, bound, (n_in, n_out)).astype(dtype),
                    rng.uniform(-bound, bound, (n_out,)).astype(dtype)))
    return out


def _input_jet(rng, N, d, dtype):
    return tuple(rng.normal(size=(N, d)).astype(dtype) for _ in range(3))


@pytest.mark.parametrize("act", ["sin", "tanh", "gelu"])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_mlp_fwdlap_matches_jax(act, seeded, precision):
    rng = np.random.default_rng(7)
    d, N = 3, 40
    dt = np.float64 if precision == "f64" else np.float32
    tdt = torch.float64 if precision == "f64" else torch.float32
    tol = 1e-10 if precision == "f64" else 1e-5
    pn = _np_params(rng, (d, 12, 12, 1), dt)
    X = rng.uniform(0.0, 2.0, (N, d)).astype(dt)
    seed = _input_jet(rng, N, d, dt) if seeded else None
    with jax.enable_x64(precision == "f64"):
        jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in pn]
        js = tuple(jnp.asarray(s) for s in seed) if seeded else None
        with jax.default_matmul_precision("highest"):
            jj = j_fwdlap.mlp_fwdlap(jp, jnp.asarray(X), act, input_jet=js)
        want = [np.asarray(jj.value), np.asarray(jj.grad), np.asarray(jj.lap)]
    tp = params_from_jax(pn, dtype=tdt)
    ts = tuple(torch.as_tensor(s) for s in seed) if seeded else None
    tj = fwdlap.mlp_fwdlap(tp, torch.as_tensor(X), act, input_jet=ts)
    for got, ref in zip(tj, want):
        assert _rel(got.numpy(), ref) <= tol


@pytest.mark.parametrize("act", ["sin", "tanh", "gelu"])
def test_calculus_oracle_matches_jax_and_recurrence(act):
    rng = np.random.default_rng(11)
    d, N = 2, 16
    pn = _np_params(rng, (d, 8, 8, 1), np.float64)
    X = rng.uniform(0.0, 2.0, (N, d))
    with jax.enable_x64(True):
        jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in pn]
        spec = JNetSpec((d, 8, 8, 1), activation=act)
        jm = JSolutionModel(spec)
        u, g, l = j_calculus.batched_value_grad_lap(
            lambda x: jm.apply_point(jp, x))(jnp.asarray(X))
        want = [np.asarray(u), np.asarray(g), np.asarray(l)]
    tp = params_from_jax(pn, dtype=torch.float64)
    tm = SolutionModel(NetSpec((d, 8, 8, 1), activation=act))
    got = tm.fields_generic(tp, torch.as_tensor(X))
    rec = tm.fields(tp, torch.as_tensor(X))
    for a, b, c in zip(got, want, rec):
        assert _rel(a.numpy(), b) <= 1e-10
        assert _rel(c.numpy(), b) <= 1e-10
    uv, gv = tm.value_and_grad(tp, torch.as_tensor(X))
    assert _rel(uv.numpy(), want[0]) <= 1e-10
    assert _rel(gv.numpy(), want[1]) <= 1e-10


@pytest.mark.parametrize("technique,kind,nodes", [
    ("FBC", "box", None),
    ("OG", "window", None),
    ("FN", "box", [[0.5], [0.7, 1.3], []]),
])
def test_trial_factor_and_fields_match_jax(technique, kind, nodes):
    rng = np.random.default_rng(5)
    d, N, L = 3, 30, 2.0
    pn = _np_params(rng, (d, 10, 10, 1), np.float64)
    X = rng.uniform(0.0, L, (N, d))
    X[0, 1] = 0.5   # exactly on a forced node / inside the box
    kw = dict(dim=d, kind=kind, L=L, nodes_per_dim=nodes)
    with jax.enable_x64(True):
        jf = j_factor(technique, **kw)
        jm = JSolutionModel(JNetSpec((d, 10, 10, 1), activation="sin"), jf)
        jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in pn]
        with jax.default_matmul_precision("highest"):
            fj = jf.jet(jnp.asarray(X))
            jet = jm.fields(jp, jnp.asarray(X))
            ub = jm.apply_batch(jp, jnp.asarray(X))
        want_f = [np.asarray(t) for t in fj]
        want_u = [np.asarray(t) for t in jet]
        want_b = np.asarray(ub)
    tf = factor_for_technique(technique, **kw)
    tm = SolutionModel(NetSpec((d, 10, 10, 1), activation="sin"), tf)
    tp = params_from_jax(pn, dtype=torch.float64)
    Xt = torch.as_tensor(X)
    for got, ref in zip(tf.jet(Xt), want_f):
        assert _rel(got.numpy(), ref) <= 1e-10
    for got, ref in zip(tm.fields(tp, Xt), want_u):
        assert _rel(got.numpy(), ref) <= 1e-10
    assert _rel(tm.apply_batch(tp, Xt).numpy(), want_b) <= 1e-10
    assert _rel(tf.value(Xt).numpy(), want_f[0]) <= 1e-10


def test_exclusive_products_and_compose_match_jax():
    rng = np.random.default_rng(3)
    F = rng.normal(size=(20, 4))
    F[3, 2] = 0.0
    with jax.enable_x64(True):
        want = np.asarray(j_fwdlap.exclusive_products(jnp.asarray(F)))
        a = j_fwdlap.Jet(*(jnp.asarray(rng.normal(size=s)) for s in [(20,), (20, 4), (20,)]))
        b = j_fwdlap.Jet(*(jnp.asarray(rng.normal(size=s)) for s in [(20,), (20, 4), (20,)]))
        want_c = [np.asarray(t) for t in j_fwdlap.compose_product_jet(a, b)]
    got = fwdlap.exclusive_products(torch.as_tensor(F)).numpy()
    assert _rel(got, want) <= 1e-12
    ta = fwdlap.Jet(*(torch.as_tensor(np.asarray(t)) for t in a))
    tb = fwdlap.Jet(*(torch.as_tensor(np.asarray(t)) for t in b))
    for g, w in zip(fwdlap.compose_product_jet(ta, tb), want_c):
        assert _rel(g.numpy(), w) <= 1e-12


def test_sobol_base_set_is_bitwise_equal():
    got = sobol_unit(3, 256, 2, dtype=torch.float32).numpy()
    want = np.asarray(j_sobol_unit(3, 256, 2))
    assert np.array_equal(got, want)


def test_params_roundtrip():
    rng = np.random.default_rng(0)
    pn = _np_params(rng, (2, 4, 1), np.float32)
    back = params_to_numpy(params_from_jax(pn))
    for (W, b), (W2, b2) in zip(pn, back):
        assert np.array_equal(W, W2) and np.array_equal(b, b2)
