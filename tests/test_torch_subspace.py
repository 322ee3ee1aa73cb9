"""The subspace eigen-solver of the port (``problems/subspace.py``) against
the JAX package, on the CPU at a small size: nets (d, 16, 16, k), 64
quadrature points in 1D and 12 x 12 in 2D, 150 (1D) and 20 x 20 (2D) dense
points for the report, the KH FD truth at 600 points; inputs made with
numpy from a seed and JAX's weights carried across by
``interop.params_from_jax``.

* Assembly: ``subspace_matrices`` and ``subspace_trace`` (value, and the
  gradient of every input leaf) within rel 1e-5 in float32 and 1e-10 in
  float64; ``subspace_eigenpairs``' eigenvalues at the same bars and its
  vectors up to each column's sign.  A Gram that is not positive definite
  gives a NaN trace in both packages (``torch.linalg.cholesky_ex``'s own
  factor of it is finite: the port turns it into NaN).
* The two init transforms from JAX's raw ``model.init`` on JAX's grid:
  each leaf within rel 1e-5.
* The objective the JAX package hands ``fit`` against the port's, on each
  problem (qho, ipw, kh in 1D; ipw, qho in 2D), both on JAX's grids (the
  port's own are up to one float32 ulp away): in float64 the total and
  eval metric within rel 1e-12 and the gradient within 1e-11 (each leaf
  1e-8); in float32 (qho1d, ipw2d), from the port's default init (the JAX
  package's weights for the seed), the parameters handed to ``fit``, the
  total and eval metric within rel 1e-5 and the gradient within 1e-3, the
  float32 rounding of the JAX package's own gradient.
* 3 epochs from the same parameters in float64, the port's ``fit`` and
  optimizer against JAX's optimizer on its objective, within rtol 1e-4
  (qho1d, kh1d); ``train_subspace`` end to end in float32 from its default
  init (ipw2d): the first history row within rtol 1e-4, the rest within
  1e-1, the ``progress`` calls the same (the reason is in the test).
* ``evaluate_subspace`` on the same weights: eigenvalues within rel 1e-5,
  ``state_rel_l2`` or ``sin_max`` within 1e-5, the same keys, and the
  exact spectra, states and 2D clusters.
* The float32 spread the float32 bars rest on, measured.
* Raises: KH at ``dim=2``, an unknown problem, ``dim=3``, no card.

Cost: about 58 s alone on one CPU worker, most of it the JAX package's
compiles of its jets, objectives and 3-epoch trainings.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nnpde_tpu.problems.subspace as jsub
import nnpde_tpu.sampling as jsampling
import nnpde_tpu_torch.problems.subspace as tsub
from nnpde_tpu_torch.interop import params_from_jax

SMALL = dict(width=16, depth=2, grid_n=64, eval_grid_n=150, epochs=3, chunk=2)
CONFIGS = {
    "qho1d": dict(problem="qho", k=3, x_max=6.0),
    "ipw1d": dict(problem="ipw", k=3, x_max=1.0),
    "kh1d": dict(problem="kh", k=3, x_max=10.0, alpha=10.0, fd_grid_n=600),
    "ipw2d": dict(problem="ipw", dim=2, k=3, x_max=1.0, grid_n=12, eval_grid_n=20),
    "qho2d": dict(problem="qho", dim=2, k=4, x_max=6.0, grid_n=12, eval_grid_n=20),
}


def _cfgs(name):
    kw = dict(SMALL, **CONFIGS[name])
    return jsub.SubspaceConfig(**kw), tsub.SubspaceConfig(**kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _leaves(p):
    if isinstance(p, dict):
        return _leaves(p["net"])
    return [np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)
            for pair in p for t in pair]


# ------------------------------------------------------------- assembly
def _fields(seed, N=50, d=2, k=4):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, k)), rng.normal(size=(N, d, k)), rng.uniform(0.0, 3.0, N)


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5), ("float64", 1e-10)])
@pytest.mark.parametrize("with_V", [False, True])
@pytest.mark.parametrize("d", [1, 2])
def test_matrices_and_trace_match_jax(dtype, bar, with_V, d):
    value, grad, V = _fields(3 + d, d=d)
    n_in = 3 if with_V else 2

    def jf(*xs):
        A, G = jsub.subspace_matrices(*xs[:2], xs[2] if with_V else None)
        return jsub.subspace_trace(A, G, ridge=1e-6), (A, G)

    with jax.enable_x64(dtype == "float64"):
        xs = [jnp.asarray(t, dtype) for t in (value, grad, V)[:n_in]]
        (jv, (jA, jG)), jg = jax.value_and_grad(jf, argnums=tuple(range(n_in)),
                                                has_aux=True)(*xs)
    ts = [torch.as_tensor(t, dtype=getattr(torch, dtype)).requires_grad_(True)
          for t in (value, grad, V)[:n_in]]
    tA, tG = tsub.subspace_matrices(*ts[:2], ts[2] if with_V else None)
    tv = tsub.subspace_trace(tA, tG, ridge=1e-6)
    tg = torch.autograd.grad(tv, ts)
    assert tv.dtype == getattr(torch, dtype)
    assert abs(float(tv) - float(jv)) <= bar * abs(float(jv))
    for got, want in ((tA, jA), (tG, jG)) + tuple(zip(tg, jg)):
        assert _rel(got.detach().numpy(), want) <= bar, _rel(got.detach().numpy(), want)


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5), ("float64", 1e-10)])
def test_eigenpairs_match_jax_up_to_sign(dtype, bar):
    value, grad, V = _fields(11, N=80, d=1, k=4)
    with jax.enable_x64(dtype == "float64"):
        A, G = jsub.subspace_matrices(*(jnp.asarray(t, dtype) for t in (value, grad, V)))
        jlam, jY = jsub.subspace_eigenpairs(A, G)
    tlam, tY = tsub.subspace_eigenpairs(torch.as_tensor(np.asarray(A)),
                                        torch.as_tensor(np.asarray(G)))
    assert _rel(tlam.numpy(), jlam) <= bar
    jY = np.asarray(jY, np.float64)
    tY = tY.numpy().astype(np.float64)
    signs = np.sign(np.sum(tY * jY, axis=0))
    assert _rel(tY * signs, jY) <= 10 * bar


def test_non_positive_definite_gram_gives_nan_in_both():
    G = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    A = np.eye(2, dtype=np.float32)
    L, info = torch.linalg.cholesky_ex(torch.as_tensor(G))
    assert int(info) == 2 and bool(torch.all(torch.isfinite(L)))   # finite: the hazard
    assert np.isnan(float(jsub.subspace_trace(jnp.asarray(A), jnp.asarray(G))))
    for dtype in (torch.float32, torch.float64):
        assert torch.isnan(tsub.subspace_trace(torch.as_tensor(A, dtype=dtype),
                                               torch.as_tensor(G, dtype=dtype)))
    # a positive-definite Gram still gives a finite trace
    assert torch.isfinite(tsub.subspace_trace(torch.as_tensor(A), torch.eye(2)))


# ------------------------------------------------------- init transforms
@functools.lru_cache(maxsize=None)
def _jax_init(name):
    jcfg, _ = _cfgs(name)
    model, X, _, (lo, hi) = jsub._setup(jcfg)
    raw = model.init(jax.random.PRNGKey(jcfg.seed))
    norm = jsub.normalize_input_layer(raw, lo, hi)
    white = jsub.whiten_output_layer(model, norm, X, floor=jcfg.whiten_floor)
    return [params_to_numpy_jax(p) for p in (raw, norm, white)], np.asarray(X), (lo, hi)


def params_to_numpy_jax(p):
    return [(np.asarray(W), np.asarray(b)) for W, b in p]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_transforms_match_jax(name):
    (raw, norm, white), X, (lo, hi) = _jax_init(name)
    _, tcfg = _cfgs(name)
    model, tX, _, (tlo, thi) = tsub._setup(tcfg)
    assert (tlo, thi) == (lo, hi) and tX.shape == X.shape
    assert np.max(np.abs(tX.numpy() - X)) <= 4e-6 * max(abs(lo), abs(hi))   # one ulp apart
    got = tsub.normalize_input_layer(params_from_jax(raw), lo, hi)
    for a, b in zip(_leaves(got), _leaves(norm)):
        assert _rel(a, b) <= 1e-6
    got = tsub.whiten_output_layer(model, got, torch.as_tensor(X), floor=tcfg.whiten_floor)
    for a, b in zip(_leaves(got), _leaves(white)):
        assert _rel(a, b) <= 1e-5, _rel(a, b)


# --------------------------------------------------------- the objective
class _Recorded(Exception):
    pass


def _record(monkeypatch, module, call):
    """The arguments ``call`` hands ``module.fit`` (which is not run)."""
    box = {}

    def recorder(*args, **kwargs):
        box.update(args=args, kwargs=kwargs)
        raise _Recorded

    with monkeypatch.context() as m:
        m.setattr(module, "fit", recorder)
        with pytest.raises(_Recorded):
            call()
    return box


def _hand_jax_grids(monkeypatch, dtype):
    """Both packages' ``_setup`` take the JAX package's grids in ``dtype``
    (the port's own ``torch.linspace`` is up to one float32 ulp away)."""
    jdt = {"float32": jnp.float32, "float64": jnp.float64}[dtype]
    tdt = getattr(torch, dtype)

    def grid(fn):
        def make(n, lo, hi, device=None):
            return torch.as_tensor(np.asarray(fn(n, lo, hi, dtype=jdt)), dtype=tdt, device=device)
        return make

    monkeypatch.setattr(jsub, "linspace_grid",
                        lambda n, lo, hi: jsampling.linspace_grid(n, lo, hi, dtype=jdt))
    monkeypatch.setattr(jsub, "meshgrid_2d",
                        lambda n, lo, hi: jsampling.meshgrid_2d(n, lo, hi, dtype=jdt))
    monkeypatch.setattr(tsub, "linspace_grid", grid(jsampling.linspace_grid))
    monkeypatch.setattr(tsub, "meshgrid_2d", grid(jsampling.meshgrid_2d))


@functools.lru_cache(maxsize=None)
def _jax_objective(name, dtype):
    """The arguments the JAX package hands ``fit``, on its grids in
    ``dtype`` (shared by the tests that read them)."""
    jcfg, _ = _cfgs(name)
    with pytest.MonkeyPatch.context() as m:
        _hand_jax_grids(m, dtype)
        with jax.enable_x64(dtype == "float64"):
            return _record(m, jsub, lambda: jsub.train_subspace(jcfg))


def _objectives(monkeypatch, name, dtype):
    """(JAX's fit arguments, the port's), both on JAX's grids in ``dtype``;
    the port from JAX's raw init carried across in float64, from its own
    default (the JAX package's weights for the seed, drawn in numpy) in
    float32."""
    _, tcfg = _cfgs(name)
    (raw, _, _), _, _ = _jax_init(name)
    init = ({"init_params": params_from_jax(raw, dtype=torch.float64)}
            if dtype == "float64" else {})
    jrec = _jax_objective(name, dtype)
    with monkeypatch.context() as m, jax.enable_x64(dtype == "float64"):
        _hand_jax_grids(m, dtype)
        trec = _record(m, tsub, lambda: tsub.train_subspace(tcfg, device="cpu", **init))
    return jrec, trec


def _port_value_and_grads(loss, params):
    p = [(W.detach().clone().requires_grad_(True), b.detach().clone().requires_grad_(True))
         for W, b in params]
    v, aux = loss(p, 0)
    g = torch.autograd.grad(v, [t for pair in p for t in pair])
    return float(v), {k: float(x) for k, x in aux.items()}, [x.numpy() for x in g]


def _jax_value_and_grads(loss, params):
    (v, aux), g = jax.jit(jax.value_and_grad(lambda p: loss(p, jax.random.PRNGKey(0)),
                                             has_aux=True))(params)
    return float(v), {k: float(x) for k, x in aux.items()}, [
        np.asarray(x) for x in jax.tree_util.tree_leaves(g)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_objective_matches_jax_float64(monkeypatch, name):
    """The objective JAX hands ``fit`` and the port's, both in float64 on the
    same grid at the same parameters (JAX's, which JAX's float32 init
    transforms leave within rel 1e-6 of the port's float64 ones): the total
    and the eval metric within rel 1e-12, the whole gradient within rel
    1e-11 and every leaf within rel 1e-8.  On these grids, symmetric about
    the domain's middle, the biases' gradients vanish: in both packages
    they are rounding, below 1e-9 of the gradient's norm (on float32 grids,
    one ulp from symmetric, they are ~1e-6 of it)."""
    jrec, trec = _objectives(monkeypatch, name, "float64")
    (jloss, jeval, jparams), (tloss, teval, tparams) = jrec["args"], trec["args"]
    for a, b in zip(_leaves(tparams), _leaves(jparams)):
        assert _rel(a, b) <= 1e-6, _rel(a, b)
    assert trec["kwargs"]["epochs"] == jrec["kwargs"]["epochs"] == 3
    P = [(np.asarray(W, np.float64), np.asarray(b, np.float64)) for W, b in jparams]
    with jax.enable_x64(True):
        jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in P]
        jv, jaux, jg = _jax_value_and_grads(jloss, jp)
        je = float(jax.jit(jeval)(jp, jax.random.PRNGKey(0)))
    tp = params_from_jax(P, dtype=torch.float64)
    tv, taux, tg = _port_value_and_grads(tloss, tp)
    with torch.no_grad():
        te = float(teval(tp, 0))
    assert abs(tv - jv) <= 1e-12 * abs(jv) and abs(te - je) <= 1e-12 * abs(je), (tv, jv, te, je)
    assert sorted(taux) == sorted(jaux) == ["ortho", "trace"]
    for k in taux:
        assert abs(taux[k] - jaux[k]) <= 1e-12 * abs(jaux[k]), k
    scale = np.linalg.norm(np.concatenate([b.ravel() for b in jg]))
    for i, (a, b) in enumerate(zip(tg, jg)):
        if np.linalg.norm(b) > 1e-9 * scale:
            assert _rel(a, b) <= 1e-8, (i, _rel(a, b))
        else:       # zero but for rounding in both (the grids are symmetric)
            assert np.linalg.norm(a) <= 1e-9 * scale, i
    assert _rel(np.concatenate([a.ravel() for a in tg]),
                np.concatenate([b.ravel() for b in jg])) <= 1e-11


@pytest.mark.parametrize("name", ["qho1d", "ipw2d"])
def test_objective_matches_jax_float32(monkeypatch, name):
    """The same in float32, each package's own pipeline: the parameters
    handed to ``fit``, the total, the terms and the eval metric within rel
    1e-5; the whole gradient within rel 1e-3, because float32 leaves it no
    closer to itself (the JAX package's own float32 gradient of the ipw1d
    objective is 1.24e-4 from its float64 one,
    ``test_float32_spread_that_the_bars_rest_on``; its bias leaves are pure
    rounding)."""
    jrec, trec = _objectives(monkeypatch, name, "float32")
    (jloss, jeval, jparams), (tloss, teval, tparams) = jrec["args"], trec["args"]
    for a, b in zip(_leaves(tparams), _leaves(jparams)):
        assert _rel(a, b) <= 1e-5, _rel(a, b)
    jv, jaux, jg = _jax_value_and_grads(jloss, jparams)
    tv, taux, tg = _port_value_and_grads(tloss, tparams)
    assert abs(tv - jv) <= 1e-5 * abs(jv), (tv, jv)
    for k in taux:
        assert abs(taux[k] - jaux[k]) <= 1e-5 * abs(jaux[k]), k
    with torch.no_grad():
        te = float(teval(tparams, 0))
    je = float(jax.jit(jeval)(jparams, jax.random.PRNGKey(0)))
    assert abs(te - je) <= 1e-5 * abs(je)
    assert _rel(np.concatenate([a.ravel() for a in tg]),
                np.concatenate([b.ravel() for b in jg])) <= 1e-3


@pytest.mark.parametrize("name", ["qho1d", "kh1d"])
def test_three_epochs_match_jax_float64(monkeypatch, name):
    """3 epochs in float64 from the same parameters: the port's ``fit`` with
    the optimizer its entry point builds against the JAX package's optimizer
    stepped on its objective (its ``fit`` scans a float32 carry), every
    history row within rtol 1e-4 (Adam steps the vanishing bias gradients
    by their rounding's sign; measured up to 4.1e-5, kh1d's trace)."""
    jrec, trec = _objectives(monkeypatch, name, "float64")
    (jloss, jeval, jparams), (tloss, teval, _) = jrec["args"], trec["args"]
    P = [(np.asarray(W, np.float64), np.asarray(b, np.float64)) for W, b in jparams]
    want = {"total": [], "trace": [], "ortho": [], "l2": []}
    with jax.enable_x64(True):
        opt = jrec["kwargs"]["optimizer"]
        p = [(jnp.asarray(W), jnp.asarray(b)) for W, b in P]
        state = opt.init(p)
        @jax.jit
        def step(p, state):
            (v, aux), g = jax.value_and_grad(lambda q: jloss(q, None), has_aux=True)(p)
            upd, state = opt.update(g, state, p)
            p = optax.apply_updates(p, upd)
            return p, state, v, aux, jeval(p, None)

        for _ in range(3):
            p, state, v, aux, m = step(p, state)
            for k, x in (("total", v), ("trace", aux["trace"]), ("ortho", aux["ortho"]),
                         ("l2", m)):
                want[k].append(float(x))
    got = tsub.fit(tloss, teval, params_from_jax(P, dtype=torch.float64), epochs=3,
                   optimizer=trec["kwargs"]["optimizer"], key=0, chunk=3)
    for k, v in want.items():
        np.testing.assert_allclose(got.history[k], v, rtol=1e-4, err_msg=k)


# ------------------------------------------------------------ the report
@pytest.mark.parametrize("name", list(CONFIGS))
def test_evaluate_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    (_, _, white), _, _ = _jax_init(name)
    jmodel = jsub._setup(jcfg)[0]
    want = jsub.evaluate_subspace(jcfg, jmodel, [(jnp.asarray(W), jnp.asarray(b))
                                                 for W, b in white])
    got = tsub.evaluate_subspace(tcfg, tsub._setup(tcfg)[0], params_from_jax(white))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["exact"], want["exact"], rtol=1e-12)
    assert _rel(got["eigenvalues"], want["eigenvalues"]) <= 1e-5
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"], rtol=1e-5)
    for key in ("state_rel_l2", "max_state_rel_l2", "max_subspace_sin"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)
    if "_states" in want:
        (tx, tU, tV, tpsi), (jx, jU, jV, jpsi) = got["_states"], want["_states"]
        assert tU.shape == jU.shape and tpsi.shape == jpsi.shape
        assert (tV is None) == (jV is None)
        np.testing.assert_allclose(tx, jx, atol=4e-6 * jcfg.x_max)
        # the exact states on JAX's grid
        np.testing.assert_allclose(tsub._exact_states(tcfg, jx[:, None]), jpsi,
                                   rtol=1e-5, atol=1e-6)
    else:
        groups = [g["levels"] + [g["degeneracy"], g["n_learned"]]
                  for g in got["subspace_groups"]]
        assert groups == [g["levels"] + [g["degeneracy"], g["n_learned"]]
                          for g in want["subspace_groups"]]


def test_exact_state_groups_and_scores_match_jax():
    cfg = tsub.SubspaceConfig(problem="qho", dim=2, k=6, x_max=6.0)
    jcfg = jsub.SubspaceConfig(problem="qho", dim=2, k=6, x_max=6.0)
    X = np.asarray(np.random.default_rng(2).uniform(-4, 4, (300, 2)), np.float32)
    tg, jg = tsub._exact_state_groups_2d(cfg, X), jsub._exact_state_groups_2d(jcfg, X)
    assert [g[:3] for g in tg] == [g[:3] for g in jg] == [
        (0, 1, jg[0][2]), (1, 3, jg[1][2]), (3, 6, jg[2][2])]
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a[3], b[3], rtol=1e-5, atol=1e-7)
    U = np.random.default_rng(4).normal(size=(300, 6))
    assert tsub.subspace_group_scores(U, tg, 6) == jsub.subspace_group_scores(U, tg, 6)
    np.testing.assert_allclose(tsub._exact_spectrum(cfg), jsub._exact_spectrum(jcfg),
                               rtol=1e-15)


# ---------------------------------------------------------- the training
@pytest.mark.parametrize("name", ["ipw2d"])
def test_training_starts_as_jax(name):
    """``train_subspace`` end to end in float32 from its default init (JAX's
    weights for the seed): the same keys, history rows and ``progress``
    calls; the first row (the
    objective at the shared initial parameters) within rtol 1e-4, the rest
    within 1e-1.  No closer is possible in float32: the bias gradients are
    the residue of grids one ulp from symmetric (above), which Adam turns
    into steps of the learning rate in either direction, so 3 epochs of the
    port from its own init perturbed by one ulp already differ by 5.3e-3
    (``test_float32_spread_that_the_bars_rest_on``), and two packages'
    roundings by more.  The float64 test above holds the 3 epochs at
    1e-4."""
    jcfg, tcfg = _cfgs(name)
    jcalls, tcalls = [], []
    want = jsub.train_subspace(jcfg, progress=lambda e, m: jcalls.append((e, m)))
    got = tsub.train_subspace(tcfg, device="cpu", progress=lambda e, m: tcalls.append((e, m)))
    assert sorted(got) == sorted(want)
    assert sorted(got["history"]) == sorted(want["history"])
    for k, v in want["history"].items():
        assert got["history"][k].shape == (3,), k
        if k != "l2":
            np.testing.assert_allclose(got["history"][k][0], v[0], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got["history"][k], v, rtol=1e-1, err_msg=k)
    assert [e for e, _ in tcalls] == [e for e, _ in jcalls] == [2, 3]
    for (_, tm), (_, jm) in zip(tcalls, jcalls):
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-1, err_msg=k)
    np.testing.assert_allclose(got["best_sum_lambda"], want["best_sum_lambda"], rtol=1e-1)
    assert got["best_sum_lambda"] == float(np.min(got["history"]["l2"]))
    assert np.all(np.diff(got["eigenvalues"]) > 0) and np.all(np.isfinite(got["eigenvalues"]))


def test_float32_spread_that_the_bars_rest_on():
    """What the float32 bars above rest on, measured here: the JAX
    package's own float32 gradient of the ipw1d objective is more than
    5e-5 from its float64 one (1.24e-4 when written), and 3 epochs of the
    port from its init perturbed by one ulp move the qho1d history by more
    than 1e-3 (5.3e-3 when written)."""
    jloss, _, jparams = _jax_objective("ipw1d", "float32")["args"]
    jloss64 = _jax_objective("ipw1d", "float64")["args"][0]
    g32 = _jax_value_and_grads(jloss, jparams)[2]
    with jax.enable_x64(True):
        p64 = [(jnp.asarray(W, jnp.float64), jnp.asarray(b, jnp.float64)) for W, b in jparams]
        g64 = _jax_value_and_grads(jloss64, p64)[2]
    assert _rel(np.concatenate([a.ravel() for a in g32]),
                np.concatenate([b.ravel() for b in g64])) > 5e-5
    _, tcfg = _cfgs("qho1d")
    base = tsub.train_subspace(tcfg, device="cpu")["history"]["total"]
    nudged = tsub.train_subspace(tcfg, device="cpu", init_params=[
        (W * (1 + 2.0 ** -23), b) for W, b in tmlp_init(tcfg)])["history"]["total"]
    assert nudged[0] == pytest.approx(base[0], rel=1e-6)
    assert np.max(np.abs(nudged / base - 1)) > 1e-3


def tmlp_init(cfg):
    from nnpde_tpu_torch.models.mlp import init_mlp

    return init_mlp(cfg.seed, tsub._setup(cfg)[0].spec)


# ------------------------------------------------------------------ raises
def test_bad_configs_and_missing_card_raise(monkeypatch):
    with pytest.raises(ValueError, match="1D"):
        tsub._setup(tsub.SubspaceConfig(problem="kh", dim=2))
    with pytest.raises(ValueError, match="unknown subspace problem"):
        tsub._setup(tsub.SubspaceConfig(problem="hydrogen"))
    with pytest.raises(ValueError, match="dim 1 or 2"):
        tsub._setup(tsub.SubspaceConfig(problem="ipw", dim=3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsub.train_subspace(tsub.SubspaceConfig(epochs=1))
    assert dataclasses.asdict(tsub.SubspaceConfig()) == dataclasses.asdict(jsub.SubspaceConfig())
