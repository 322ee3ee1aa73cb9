"""The 1D eigenproblem slice of the port (``problems/ipw.py``,
``problems/qho.py``, their helpers, and the L-BFGS of ``train_ipw_2d``)
against the JAX package, on the CPU at a small size.

* Helpers: ``pde/qho`` (Hermite, states, potentials, energies, nodes) at
  float64 within 1e-12; the four samplers' indices and Sobol points equal;
  ``unit_factor`` and ``num_params``.
* Objectives: each entry point x method x route x technique builds its
  objective from JAX parameters carried across; the objective that the
  JAX package hands its trainer (captured by replacing ``fit`` /
  ``fit_wan`` / ``lbfgs_fit`` in the JAX module with a recorder, on
  ``jet_impl='xla'``) and the port's (the same, in the port's module) at
  the same parameters: the total within rel 1e-5 and every gradient leaf
  (and the trainable E) within rel 1e-5, float32 (the fused kernels' bar,
  ``ROADMAP.md``).  Kernel routes take their plain versions here.
* Trainings: 3 epochs of each entry point and method on every route from
  the JAX run's initial weights: the first total within rtol 1e-4 of the
  JAX run on ``'xla'``, and of the JAX package's own kernel routes
  (``'pallas'`` / ``'pallas-fused'``, interpret mode on the CPU) on one
  case each.
* L-BFGS wiring: with the polish and the from-scratch fit cut to 5
  iterations in both packages (a recorder around each module's
  ``lbfgs_polish`` / ``lbfgs_fit``), the start point and the iterates
  within 1e-4 of the JAX package's; ``train_ipw_2d(LBFGS=True)`` likewise,
  and at full length (500 iterations) the polished eval metric within rtol
  1e-2 of JAX's (the float32 parameters themselves drift apart along the
  flat directions of an overparameterised net over hundreds of iterations:
  0.08 of 0.6 measured, with the same eval to 3e-7).
* Raises: the JAX route names, a bad technique or method, and hidden
  widths above each kernel's limit.

Cost: about 60 s on the CPU (the JAX package's scan and while-loop
compiles dominate).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnpde_tpu.problems.ipw as jipw
import nnpde_tpu.problems.ipw2d as jipw2d
import nnpde_tpu.problems.qho as jqho
import nnpde_tpu_torch.problems.ipw as tipw
import nnpde_tpu_torch.problems.ipw2d as tipw2d
import nnpde_tpu_torch.problems.qho as tqho
from nnpde_tpu.models import mlp as j_mlp
from nnpde_tpu.models import trial as j_trial
from nnpde_tpu.pde import qho as jqho_phys
from nnpde_tpu.pde.domain import Box as JBox
from nnpde_tpu.sampling import samplers as jsam
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import _cuda
from nnpde_tpu_torch.models import mlp as t_mlp
from nnpde_tpu_torch.models import unit_factor
from nnpde_tpu_torch.pde import qho as tqho_phys
from nnpde_tpu_torch.pde.domain import Box
from nnpde_tpu_torch.sampling import samplers as tsam

ROUTES = ("torch", "kernel", "fused")
JAX_ROUTE = {"torch": "xla", "kernel": "pallas", "fused": "pallas-fused"}

SMALL = dict(layers=(1, 8, 8, 1), grid_n=67, epochs=3, chunk=3)
SMALL_WAN = dict(SMALL, v_layers=(1, 6, 6, 1), v_steps=2)
ENTRIES = {
    "ipw": (jipw, tipw, "IPW1DConfig", "train_ipw_1d", "fit"),
    "ipw_wan": (jipw, tipw, "IPW1DWanConfig", "train_ipw_1d_wan", "fit_wan"),
    "qho": (jqho, tqho, "QHO1DConfig", "train_qho_1d", "fit"),
    "qho_wan": (jqho, tqho, "QHO1DWanConfig", "train_qho_1d_wan", "fit_wan"),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ----------------------------------------------------------------- helpers
def test_qho_physics_matches_jax():
    x = np.linspace(-6.0, 6.0, 41)
    y = np.linspace(-3.0, 5.0, 41)
    with jax.enable_x64(True):
        jx, jy = jnp.asarray(x), jnp.asarray(y)
        want = [*np.concatenate([np.asarray(jqho_phys.phys_hermite(n, jx)) for n in range(7)]),
                *np.concatenate([np.asarray(jqho_phys.psi_1d(n, jx)) for n in range(6)]),
                *np.asarray(jqho_phys.psi_1d(2, jx, omega=1.3)),
                *np.asarray(jqho_phys.psi_2d(2, 3, jx, jy)),
                *np.asarray(jqho_phys.potential_1d(jx)), *np.asarray(jqho_phys.potential_2d(jx, jy)),
                jqho_phys.energy_1d(3), jqho_phys.energy_2d(1, 2),
                *[v for n in range(7) for v in jqho_phys.nodes(n)]]
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    got = [*torch.cat([tqho_phys.phys_hermite(n, tx) for n in range(7)]).numpy(),
           *torch.cat([tqho_phys.psi_1d(n, tx) for n in range(6)]).numpy(),
           *tqho_phys.psi_1d(2, tx, omega=1.3).numpy(),
           *tqho_phys.psi_2d(2, 3, tx, ty).numpy(),
           *tqho_phys.potential_1d(tx).numpy(), *tqho_phys.potential_2d(tx, ty).numpy(),
           tqho_phys.energy_1d(3), tqho_phys.energy_2d(1, 2),
           *[v for n in range(7) for v in tqho_phys.nodes(n)]]
    assert len(got) == len(want)
    np.testing.assert_allclose([float(a) for a in got], [float(a) for a in want],
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_total,fraction,k", [(1000, 0.25, 10), (67, 0.25, 10), (333, 0.4, 7)])
def test_samplers_match_jax(n_total, fraction, k):
    for jf, tf in ((jsam.first_fraction_every_kth, tsam.first_fraction_every_kth),
                   (jsam.mid_fraction_every_kth, tsam.mid_fraction_every_kth)):
        np.testing.assert_array_equal(tf(n_total, fraction, k).numpy(),
                                      np.asarray(jf(n_total, fraction, k)))
    for cap in (None, 5):
        np.testing.assert_array_equal(tsam.first_fraction_indices(n_total, fraction, cap).numpy(),
                                      np.asarray(jsam.first_fraction_indices(n_total, fraction,
                                                                             cap)))
    lo, hi = (-1.0, 0.5, 2.0), (3.0, 1.5, 2.5)
    np.testing.assert_array_equal(
        tsam.sobol_box(k, 64, Box(lo, hi)).numpy(),
        np.asarray(jsam.sobol_box(k, 64, JBox(lo, hi))))


def test_unit_factor_and_num_params_match_jax():
    rng = np.random.default_rng(2)
    X = rng.uniform(-1.0, 1.0, (20, 3))
    with jax.enable_x64(True):
        jj = j_trial.unit_factor(3).jet(jnp.asarray(X))
    tj = unit_factor(3).jet(torch.as_tensor(X))
    for a, b in zip(tj, jj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jp = j_mlp.init_mlp(jax.random.PRNGKey(0), j_mlp.NetSpec((1, 200, 200, 200, 1), "sin"))
    assert t_mlp.num_params(params_from_jax(jp)) == j_mlp.num_params(jp) == 81001


# ---------------------------------------------------------- the objectives
class _Recorded(Exception):
    pass


def _record(monkeypatch, module, name, train, cfg, **kw):
    """The arguments ``train(cfg, **kw)`` hands ``module.<name>`` (the
    trainer), stopping the run there."""
    box = {}

    def recorder(*args, **kwargs):
        box.update(args=args, kwargs=kwargs)
        raise _Recorded

    monkeypatch.setattr(module, name, recorder)
    with pytest.raises(_Recorded):
        train(cfg, **kw)
    monkeypatch.undo()
    return box


def _jax_leaves(params):
    """The leaves in the port's order: a net's, then the WAN's E."""
    if isinstance(params, dict):
        return jax.tree_util.tree_leaves(params["net"]) + [params["E"]]
    return jax.tree_util.tree_leaves(params)


def _trainable(params):
    if isinstance(params, dict):
        out = {"net": _trainable(params["net"])[0],
               "E": params["E"].clone().requires_grad_(True)}
        return out, _trainable_leaves(out)
    out = [(W.clone().requires_grad_(True), b.clone().requires_grad_(True)) for W, b in params]
    return out, _trainable_leaves(out)


def _trainable_leaves(params):
    if isinstance(params, dict):
        return _trainable_leaves(params["net"]) + [params["E"]]
    return [t for pair in params for t in pair]


def _jax_value_and_grads(fn, params):
    (v, _), g = jax.value_and_grad(fn, has_aux=True)(params)
    return float(v), [np.asarray(x) for x in _jax_leaves(g)]


def _port_value_and_grads(fn, params):
    p, leaves = _trainable(params)
    v, _ = fn(p)
    g = torch.autograd.grad(v, leaves)
    return float(v), [x.numpy() for x in g]


def _check(got, want, what, per_leaf=True):
    """The total, and every gradient leaf within rel 1e-5; ``per_leaf=False``
    holds the leaves together (the WAN critic: ``-log`` of a squared
    quotient of grid means amplifies their float32 rounding, as in
    ``tests/test_torch_wan.py``)."""
    (tv, tg), (jv, jg) = got, want
    assert abs(tv - jv) <= 1e-5 * abs(jv), (what, tv, jv)
    assert len(tg) == len(jg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape, (what, i)
        if per_leaf:
            assert _rel(a, b) <= 1e-5, (what, i, _rel(a, b))
    flat = [np.concatenate([np.ravel(a) for a in g]) for g in (tg, jg)]
    assert _rel(*flat) <= 1e-5, (what, _rel(*flat))


OBJECTIVE_CASES = [
    (entry, method, route, technique, n)
    for entry, techs in (("ipw", (("FN", 2), ("OG", 2), ("BC", 1))),
                         ("qho", (("FN", 1), ("OG", 2), ("BC", 0))))
    for method in ("PINN", "DRM") for route in ROUTES for technique, n in techs
] + [
    (entry, "WAN", route, technique, n)
    for entry, techs in (("ipw_wan", (("FBC", 1), ("OG", 2), ("FN", 2))),
                         ("qho_wan", (("BC", 0), ("OG", 1))))
    for route in ("torch", "fused") for technique, n in techs
]


@pytest.mark.parametrize("entry,method,route,technique,n", OBJECTIVE_CASES)
def test_objective_matches_jax(monkeypatch, entry, method, route, technique, n):
    jmod, tmod, cfg_name, train_name, fit_name = ENTRIES[entry]
    kw = dict(SMALL_WAN if method == "WAN" else dict(SMALL, method=method),
              n=n, technique=technique)
    jrec = _record(monkeypatch, jmod, fit_name, getattr(jmod, train_name),
                   getattr(jmod, cfg_name)(jet_impl="xla", **kw))
    key = jax.random.PRNGKey(5)
    if method != "WAN":
        jloss, _, jparams = jrec["args"]
        want = _jax_value_and_grads(lambda p: jloss(p, key), jparams)
        trec = _record(monkeypatch, tmod, fit_name, getattr(tmod, train_name),
                       getattr(tmod, cfg_name)(jet_impl=route, **kw),
                       init_params=params_from_jax(jparams), device="cpu")
        tloss, _, tparams = trec["args"]
        lag = trec["kwargs"].get("loss_and_grad_fn")
        assert (lag is not None) == (route == "fused" and method == "PINN")
        if lag is not None:
            p, _ = _trainable(tparams)
            (tv, _), g = lag(p, 0)
            got = (float(tv), [x.numpy() for pair in g for x in pair])
        else:
            got = _port_value_and_grads(lambda p: tloss(p, 0), tparams)
        _check(got, want, "loss")
        return
    ju_loss, jv_loss, _, ju, jv = jrec["args"]
    jctx = jrec["kwargs"]["v_context_fn"](ju, key)
    init = dict(init_params=params_from_jax(ju["net"] if isinstance(ju, dict) else ju),
                init_v_params=params_from_jax(jv), device="cpu")
    trec = _record(monkeypatch, tmod, fit_name, getattr(tmod, train_name),
                   getattr(tmod, cfg_name)(jet_impl=route, **kw), **init)
    tu_loss, tv_loss, _, tu, tv = trec["args"]
    assert _rel(_trainable_leaves(tu)[0].numpy(), np.asarray(_jax_leaves(ju)[0])) == 0.0
    tctx = trec["kwargs"]["v_context_fn"](tu, 0)
    _check(_port_value_and_grads(lambda p: tu_loss(p, tv, 0), tu),
           _jax_value_and_grads(lambda p: ju_loss(p, jv, key), ju), "u loss")
    _check(_port_value_and_grads(lambda p: (tv_loss(p, tctx, 0), None), tv),
           _jax_value_and_grads(lambda p: (jv_loss(p, jctx, key), None), jv), "v loss",
           per_leaf=False)


@pytest.mark.parametrize("method,route", [(m, r) for m in ("PINN", "DRM") for r in ROUTES])
def test_lbfgs_replace_objective_matches_jax(monkeypatch, method, route):
    """``lbfgs_mode='replace'`` hands ``lbfgs_fit`` ``loss_terms`` on every
    route (the jet kernel pair on ``kernel`` PINN, the fused Rayleigh
    quotient on ``fused`` DRM, the torch jet on ``fused`` PINN)."""
    kw = dict(SMALL, method=method, n=1, technique="FN", epochs=0, LBFGS=True,
              lbfgs_mode="replace", lbfgs_iters=5)
    jrec = _record(monkeypatch, jqho, "lbfgs_fit", jqho.train_qho_1d,
                   jqho.QHO1DConfig(jet_impl="xla", **kw))
    jloss, _, jparams = jrec["args"]
    want = _jax_value_and_grads(lambda p: (jloss(p), None), jparams)
    trec = _record(monkeypatch, tqho, "lbfgs_fit", tqho.train_qho_1d,
                   tqho.QHO1DConfig(jet_impl=route, **kw),
                   init_params=params_from_jax(jparams), device="cpu")
    tloss, _, tparams = trec["args"]
    assert trec["kwargs"]["max_iter"] == jrec["kwargs"]["max_iter"] == 5
    _check(_port_value_and_grads(lambda p: (tloss(p), None), tparams), want, "lbfgs loss")


# ---------------------------------------------------------- the trainings
@functools.lru_cache(maxsize=None)
def _jax_first_totals(entry, method, j_route="xla"):
    """The JAX package's run of one small case: (history totals, initial
    u params, initial v params)."""
    jmod, _, cfg_name, train_name, fit_name = ENTRIES[entry]
    kw = _train_kw(entry, method)
    box = {}
    real = getattr(jmod, fit_name)

    def spy(*args, **kwargs):
        box["args"] = args
        return real(*args, **kwargs)

    setattr(jmod, fit_name, spy)
    try:
        out = getattr(jmod, train_name)(getattr(jmod, cfg_name)(jet_impl=j_route, **kw))
    finally:
        setattr(jmod, fit_name, real)
    if method == "WAN":
        u0, v0 = box["args"][3], box["args"][4]
        u0 = u0["net"] if isinstance(u0, dict) else u0
    else:
        u0, v0 = box["args"][2], None
    return np.asarray(out["history"]["total"]), u0, v0


def _train_kw(entry, method):
    if method == "WAN":
        return dict(SMALL_WAN, n=1 if entry == "ipw_wan" else 0,
                    technique="FN" if entry == "ipw_wan" else "OG")
    return dict(SMALL, method=method, n=2 if entry == "ipw" else 1, technique="FN")


TRAIN_CASES = ([(e, m, r) for e in ("ipw", "qho") for m in ("PINN", "DRM") for r in ROUTES]
               + [(e, "WAN", r) for e in ("ipw_wan", "qho_wan") for r in ("torch", "fused")])


@pytest.mark.parametrize("entry,method,route", TRAIN_CASES)
def test_training_starts_as_jax(entry, method, route):
    _, tmod, cfg_name, train_name, _ = ENTRIES[entry]
    totals, u0, v0 = _jax_first_totals(entry, method)
    init = dict(init_params=params_from_jax(u0), device="cpu")
    if v0 is not None:
        init["init_v_params"] = params_from_jax(v0)
    out = getattr(tmod, train_name)(getattr(tmod, cfg_name)(jet_impl=route,
                                                            **_train_kw(entry, method)), **init)
    hist = out["history"]["total"]
    assert hist.shape == totals.shape and np.all(np.isfinite(hist))
    np.testing.assert_allclose(hist[0], totals[0], rtol=1e-4)
    np.testing.assert_allclose(hist, totals, rtol=5e-2)
    if entry == "qho_wan":
        assert np.isfinite(out["E_est"]) and np.isfinite(out["E_rayleigh"])


@pytest.mark.parametrize("entry,method,route", [("ipw", "PINN", "kernel"),
                                                ("qho", "PINN", "fused"),
                                                ("qho", "DRM", "fused"),
                                                ("ipw_wan", "WAN", "fused")])
def test_training_starts_as_jax_kernel_routes(entry, method, route):
    """The port's kernel routes against the JAX package's own Pallas routes
    (interpret mode on the CPU)."""
    _, tmod, cfg_name, train_name, _ = ENTRIES[entry]
    totals, u0, v0 = _jax_first_totals(entry, method, JAX_ROUTE[route])
    init = dict(init_params=params_from_jax(u0), device="cpu")
    if v0 is not None:
        init["init_v_params"] = params_from_jax(v0)
    out = getattr(tmod, train_name)(getattr(tmod, cfg_name)(jet_impl=route,
                                                            **_train_kw(entry, method)), **init)
    np.testing.assert_allclose(out["history"]["total"][0], totals[0], rtol=1e-4)


# ----------------------------------------------------------- L-BFGS wiring
def _spy(monkeypatch, module, name, box, iters=None):
    """Record the arguments and result of ``module.<name>``; with ``iters``
    its run is cut to that many iterations (``max_iter``)."""
    real = getattr(module, name)

    def spy(*args, **kw):
        if iters is not None:
            kw["max_iter"] = iters
        box["args"] = args
        box["out"] = real(*args, **kw)
        return box["out"]

    monkeypatch.setattr(module, name, spy)


def _flat(params):
    return np.concatenate([np.asarray(t.detach() if isinstance(t, torch.Tensor) else t,
                                      np.float64).reshape(-1)
                           for pair in params for t in pair])


LBFGS_BAR = 1e-4     # five float32 iterations from starts 3 Adam steps apart


@pytest.mark.parametrize("entry,mode,route", [("ipw", "polish", "kernel"),
                                              ("qho", "polish", "fused"),
                                              ("qho", "replace", "kernel"),
                                              ("qho", "replace", "fused")])
def test_lbfgs_paths_match_jax(monkeypatch, entry, mode, route):
    """The polish (from the last Adam iterate on the well, the best on the
    oscillator) and the from-scratch fit, cut to 5 iterations in both
    packages: the same start point and iterates within 1e-4."""
    jmod, tmod, cfg_name, train_name, _ = ENTRIES[entry]
    name = "lbfgs_fit" if mode == "replace" else "lbfgs_polish"
    kw = dict(SMALL, method="PINN", n=1, technique="FN", LBFGS=True)
    if entry == "qho":
        kw.update(lbfgs_mode=mode, lbfgs_iters=5, epochs=0 if mode == "replace" else 3)
    jfit, jbox, tbox = {}, {}, {}
    if mode == "polish":
        _spy(monkeypatch, jmod, "fit", jfit)
    _spy(monkeypatch, jmod, name, jbox, iters=5)
    # the port's entry points polish through problems/ipw.py::polish
    _spy(monkeypatch, tipw if mode == "polish" else tmod, name, tbox, iters=5)
    jout = getattr(jmod, train_name)(getattr(jmod, cfg_name)(jet_impl="xla", **kw))
    j_init = jfit["args"][2] if mode == "polish" else jbox["args"][2]
    tout = getattr(tmod, train_name)(getattr(tmod, cfg_name)(jet_impl=route, **kw),
                                     init_params=params_from_jax(j_init), device="cpu")
    j_start = jbox["args"][2] if mode == "replace" else jbox["args"][1]
    t_start = tbox["args"][2] if mode == "replace" else tbox["args"][1]
    assert _rel(_flat(t_start), _flat(j_start)) <= (0.0 if mode == "replace" else 1e-5)
    if mode == "replace":
        for k in ("total", "l2"):
            np.testing.assert_allclose(tout["history"][k], np.asarray(jout["history"][k]),
                                       rtol=LBFGS_BAR)
        assert tout["history"]["total"].shape == (5,)
    else:
        assert _rel(_flat(tbox["out"][0]), _flat(jbox["out"][0])) <= LBFGS_BAR
        np.testing.assert_allclose(float(tbox["out"][1]), float(jbox["out"][1]),
                                   rtol=LBFGS_BAR)
    assert _rel(_flat(tout["result"].params), _flat(jout["result"].params)) <= LBFGS_BAR
    # the eval is a mean of squared differences from the exact state, ten
    # times as sensitive as the params here
    np.testing.assert_allclose(tout["L2_error"], jout["L2_error"], rtol=10 * LBFGS_BAR)
    assert tout["min_epoch"] == jout["min_epoch"]


IPW2D_SMALL = dict(layers=(2, 8, 8, 1), grid_n=8, data_grid_n=4, epochs=3, LBFGS=True,
                   method="PINN", technique="FBC")


@pytest.mark.parametrize("iters", [5, None])
def test_ipw2d_lbfgs_polish_matches_jax(monkeypatch, iters):
    """``train_ipw_2d(LBFGS=True)`` on ``fused`` (the polish on the torch
    jet, as JAX's ``pallas-fused`` polishes on its XLA jet) against the JAX
    package on ``xla``: cut to 5 iterations, the polished params within
    1e-4; at the full 500, the polished eval within rtol 1e-2 and the same
    best epoch (module note)."""
    jfit, jbox, tbox = {}, {}, {}
    _spy(monkeypatch, jipw2d, "fit", jfit)
    _spy(monkeypatch, jipw2d, "lbfgs_polish", jbox, iters=iters)
    _spy(monkeypatch, tipw, "lbfgs_polish", tbox, iters=iters)    # ipw2d's polish
    jout = jipw2d.train_ipw_2d(jipw2d.IPW2DConfig(jet_impl="xla", **IPW2D_SMALL))
    tout = tipw2d.train_ipw_2d(tipw2d.IPW2DConfig(jet_impl="fused", **IPW2D_SMALL),
                               init_params=params_from_jax(jfit["args"][2]), device="cpu")
    assert _rel(_flat(tbox["args"][1]), _flat(jbox["args"][1])) <= 1e-5
    if iters is not None:
        assert _rel(_flat(tbox["out"][0]), _flat(jbox["out"][0])) <= LBFGS_BAR
        np.testing.assert_allclose(tout["L2_error"], jout["L2_error"], rtol=10 * LBFGS_BAR)
    else:
        np.testing.assert_allclose(tout["L2_error"], jout["L2_error"], rtol=1e-2)
    assert tout["min_epoch"] == jout["min_epoch"]


# ------------------------------------------------------------------ raises
@pytest.mark.parametrize("entry", ["ipw", "ipw_wan", "qho", "qho_wan"])
@pytest.mark.parametrize("jet_impl,port", [("xla", "torch"), ("pallas", "kernel"),
                                           ("pallas-fused", "fused")])
def test_jax_route_names_raise(entry, jet_impl, port):
    _, tmod, cfg_name, train_name, _ = ENTRIES[entry]
    with pytest.raises(ValueError, match=f"jet_impl={port!r}"):
        getattr(tmod, train_name)(getattr(tmod, cfg_name)(jet_impl=jet_impl), device="cpu")


@pytest.mark.parametrize("entry,kw,match", [
    ("ipw", dict(technique="RB"), "technique"),
    ("ipw", dict(method="WAN"), "method"),
    ("ipw", dict(jet_impl="cuda"), "jet_impl"),
    ("qho", dict(technique="FBC"), "technique"),
    ("qho", dict(method="FEM"), "method"),
    ("ipw_wan", dict(technique="XYZ"), "technique"),
    ("qho_wan", dict(minimax="sgd"), "minimax"),
])
def test_bad_options_raise(entry, kw, match):
    _, tmod, cfg_name, train_name, _ = ENTRIES[entry]
    small = dict(SMALL_WAN if "wan" in entry else SMALL)
    small.update(kw)
    with pytest.raises(ValueError, match=match):
        getattr(tmod, train_name)(getattr(tmod, cfg_name)(**small), device="cpu")


def test_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in ENTRIES.values():
        _, tmod, cfg_name, train_name, _ = entry
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(tmod, train_name)(getattr(tmod, cfg_name)())


@pytest.mark.parametrize("name", sorted(_cuda.LAUNCHES))
def test_widths_above_each_kernels_limit_raise(name):
    """Every kernel's wrapper check takes hidden widths up to its limit
    (``_cuda.LIMITS``: 256 for the bf16-dot modes of rows 7-12, 4096 for
    every fp32 kernel and the bf16-dot modes of rows 1-5, their plans
    refusing what no tile fits) and raises
    above it, naming the kernel, its limit and the roadmap item of the wider
    nets.  The nets are views of one row: no 4096 x 4096 matrix is made."""
    limit = _cuda.LIMITS[name].width
    assert limit == (4096 if name in _cuda.BEYOND_KERNELS + _cuda.BEYOND_BF16 else 256)
    X = torch.zeros(4, 1)

    def net(w):
        def mat(a, b):
            return torch.zeros(1, b).expand(a, b)
        return [(mat(1, w), torch.zeros(w)), (mat(w, w), torch.zeros(w)),
                (mat(w, 1), torch.zeros(1))]

    assert _cuda.net_layers(name, net(limit), X, "tanh") == [1, limit, limit, 1]
    with pytest.raises(ValueError, match=f"{name}: the kernel takes hidden widths from 1 "
                                         f"to {limit}") as err:
        _cuda.net_layers(name, net(limit + 1), X, "tanh")
    assert "ROADMAP.md B7" in str(err.value)
