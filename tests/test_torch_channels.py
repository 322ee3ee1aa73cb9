"""The channel models of the port (``ops/fwdlap.py::ChannelJet``,
``mlp_fwdlap_channels``, ``compose_product_jet_channels``,
``models/mlp.py::mlp_apply_batch_channels``,
``models/solution.py::ChannelSolutionModel``, ``calculus_point_channels``)
against the JAX package, on the CPU at a small size: nets (d, 12, 12, C),
sin and tanh, d = 1 and 2, C = 5 and 6, with and without the window
factor, 9 points drawn with numpy from a seed.

* float64 (JAX under ``jax.enable_x64``): value, gradient and Laplacian
  within rel 1e-10, per field over the batch.
* float32: the JAX package's own tolerances for the channel jet
  (``tests/test_kh_floquet.py``: value rtol/atol 1e-5, gradient 1e-4, the
  Laplacian scaled by its largest entry within 5e-4).
* The port's ``fields`` against its own ``fields_generic`` (``torch.func``
  autodiff): rel 1e-10 in float64.
* The factor/net dim mismatch raises ``ValueError``.
* ``models/mlp.py::init_mlp`` (threefry-2x32 in numpy, the entry
  points' initial weights) draws the JAX package's ``init_mlp`` weights for
  the same seed bit for bit, and ``prng``'s key, split and uniform equal
  ``jax.random``'s.

Cost: about 34 s alone on one CPU worker, most of it the JAX package's
first eager compiles (shared with the files a worker ran before: the three
channel-slice files take about 83 s together).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnpde_tpu.models as jmodels
import nnpde_tpu.models.mlp as jmlp
import nnpde_tpu.models.solution as jsol
import nnpde_tpu.ops.fwdlap as jfwd
import nnpde_tpu_torch.models as tmodels
import nnpde_tpu_torch.models.mlp as tmlp
import nnpde_tpu_torch.models.solution as tsol
import nnpde_tpu_torch.ops.fwdlap as tfwd
from nnpde_tpu_torch import prng
from nnpde_tpu_torch.interop import params_from_jax

CASES = [(act, d, C, fac) for act in ("sin", "tanh") for d in (1, 2) for C in (5, 6)
         for fac in (False, True)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _case(act, d, C, fac, seed=0):
    rng = np.random.default_rng(seed + 7 * d + C)
    layers = (d, 12, 12, C)
    params = [(rng.uniform(-0.6, 0.6, (i, o)), rng.uniform(-0.6, 0.6, (o,)))
              for i, o in zip(layers[:-1], layers[1:])]
    X = rng.uniform(-1.5, 1.5, (9, d))
    kw = dict(dim=d, kind="window", L=2.0)
    jm = jmodels.ChannelSolutionModel(jmodels.NetSpec(layers, act),
                                      jmodels.factor_for_technique("FBC", **kw) if fac else None)
    tm = tmodels.ChannelSolutionModel(tmodels.NetSpec(layers, act),
                                      tmodels.factor_for_technique("FBC", **kw) if fac else None)
    return jm, tm, params, X


def _jax(params, X, dtype):
    return [(jnp.asarray(W, dtype), jnp.asarray(b, dtype)) for W, b in params], jnp.asarray(X, dtype)


def _port(params, X, dtype):
    return params_from_jax(params, dtype=dtype), torch.as_tensor(X, dtype=dtype)


@pytest.mark.parametrize("act,d,C,fac", CASES)
def test_channel_jet_matches_jax_float64(act, d, C, fac):
    jm, tm, params, X = _case(act, d, C, fac)
    with jax.enable_x64(True):
        jp, jX = _jax(params, X, jnp.float64)
        want = jm.fields(jp, jX)
        want_u = jm.apply_batch(jp, jX)
        want_pt = jsol.calculus_point_channels(jp, jX[3], act)
    tp, tX = _port(params, X, torch.float64)
    got = tm.fields(tp, tX)
    assert isinstance(got, tfwd.ChannelJet)
    for name, g, w in zip(got._fields, got, want):
        assert tuple(g.shape) == w.shape, name
        assert _rel(g.numpy(), w) <= 1e-10, (name, _rel(g.numpy(), w))
    assert _rel(tm.apply_batch(tp, tX).numpy(), want_u) <= 1e-10
    assert _rel(tsol.calculus_point_channels(tp, tX[3], act).numpy(), want_pt) <= 1e-10


@pytest.mark.parametrize("act,d,C,fac", CASES)
def test_channel_jet_matches_jax_float32(act, d, C, fac):
    jm, tm, params, X = _case(act, d, C, fac)
    jp, jX = _jax(params, X, jnp.float32)
    want = jm.fields(jp, jX)
    tp, tX = _port(params, X, torch.float32)
    got = tm.fields(tp, tX)
    np.testing.assert_allclose(got.value.numpy(), want.value, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.grad.numpy(), want.grad, rtol=1e-4, atol=1e-4)
    scale = float(jnp.abs(want.lap).max()) + 1e-6
    np.testing.assert_allclose(got.lap.numpy() / scale, np.asarray(want.lap) / scale, atol=5e-4)
    np.testing.assert_allclose(tmlp.mlp_apply_batch_channels(tp, tX, act).numpy(),
                               jmlp.mlp_apply_batch_channels(jp, jX, act), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act,d,C,fac", CASES)
def test_channel_jet_matches_fields_generic(act, d, C, fac):
    _, tm, params, X = _case(act, d, C, fac, seed=1)
    tp, tX = _port(params, X, torch.float64)
    got, oracle = tm.fields(tp, tX), tm.fields_generic(tp, tX)
    for name, g, w in zip(got._fields, got, oracle):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w.numpy()) <= 1e-10, (name, _rel(g.numpy(), w.numpy()))


def test_compose_product_jet_channels_matches_jax():
    rng = np.random.default_rng(5)
    N, d, C = 11, 2, 4
    a = [rng.normal(size=s) for s in ((N, C), (N, d, C), (N, C))]
    f = [rng.normal(size=s) for s in ((N,), (N, d), (N,))]
    with jax.enable_x64(True):
        want = jfwd.compose_product_jet_channels(
            jfwd.ChannelJet(*map(jnp.asarray, a)), jfwd.Jet(*map(jnp.asarray, f)))
    got = tfwd.compose_product_jet_channels(
        tfwd.ChannelJet(*map(torch.as_tensor, a)), tfwd.Jet(*map(torch.as_tensor, f)))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-12


def test_channel_model_dim_mismatch_raises():
    with pytest.raises(ValueError, match="factor dim 1 != net input dim 2"):
        tmodels.ChannelSolutionModel(
            tmodels.NetSpec((2, 8, 4), activation="sin"),
            tmodels.factor_for_technique("FBC", dim=1, kind="window", L=1.0))
    model = tmodels.ChannelSolutionModel(tmodels.NetSpec((2, 8, 4), activation="sin"))
    assert (model.dim, model.channels, model.factor) == (2, 4, None)


@pytest.mark.parametrize("act,layers", [("tanh", (1, 48, 48, 48, 3)), ("sin", (1, 64, 64, 64, 10)),
                                        ("tanh", (2, 32, 32, 32, 3)), ("sin", (2, 7, 1))])
@pytest.mark.parametrize("seed", [0, 1, 5, 123456])
def test_init_mlp_threefry_matches_jax_bit_for_bit(act, layers, seed):
    want = jmlp.init_mlp(jax.random.PRNGKey(seed), jmodels.NetSpec(layers, act))
    got = tmlp.init_mlp(seed, tmodels.NetSpec(layers, act))
    for (jW, jb), (tW, tb) in zip(want, got):
        np.testing.assert_array_equal(tW.numpy(), np.asarray(jW))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1, 2**32 + 9])
def test_threefry_key_split_uniform_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(key), np.array(prng.threefry_key(seed), np.uint32))
    np.testing.assert_array_equal(np.array(prng.threefry_split(prng.threefry_key(seed), 7)),
                                  np.asarray(jax.random.split(key, 7)))
    for shape, lo, hi in (((5, 11), -0.4, 0.4), ((300,), -2.5, 1.5)):
        np.testing.assert_array_equal(prng.threefry_uniform(prng.threefry_key(seed), shape, lo, hi),
                                      np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi)))
