"""The 2D oscillator (``problems/qho2d.py``) of the port against the JAX
package, on the CPU at a small size (a 12 x 12 grid, ``(2, 16, 16, 1)``
nets).

* Objectives: each method x route x technique builds its objective from
  JAX parameters carried across; the objective the JAX package hands
  ``fit`` / ``fit_wan`` (captured by replacing the trainer with a recorder,
  on ``jet_impl='xla'``) and the port's at the same parameters: the total,
  every gradient leaf and the trainable E's gradient within rel 1e-5.  On
  ``fused`` PINN with ``trainable_energy`` E's gradient comes from the
  kernel's e lane (its plain version here).
* Trainings: 3 epochs of each method on every route from the JAX run's
  initial weights, the first total within rtol 1e-4 of the JAX run on
  ``xla`` and the rest within 5e-2, and against the JAX package's own
  ``pallas-fused`` route (interpret mode on the CPU) once per method.
* ``energy_lr``: E moves by the E group's rate only, as in JAX; the
  L-BFGS polish runs over the net and E (cut to 5 iterations in both
  packages, the iterates within 1e-4).
* Raises: the JAX route names, ``trainable_energy`` with DRM or WAN, a bad
  method or technique, no card.

Cost: about 77 s on one CPU worker alone; about 20 s of it the JAX
package's first compiles of its ops, which a worker shares with the files
it ran before.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import nnpde_tpu.problems.qho2d as jq
import nnpde_tpu_torch.problems.ipw as tipw
import nnpde_tpu_torch.problems.qho2d as tq
from nnpde_tpu_torch.interop import params_from_jax

ROUTES = ("torch", "kernel", "fused")
JAX_ROUTE = {"torch": "xla", "kernel": "pallas", "fused": "pallas-fused"}
SMALL = dict(layers=(2, 16, 16, 1), v_layers=(2, 8, 8, 1), grid_n=12, data_grid_n=6,
             n_boundary=8, v_steps=2, epochs=3, chunk=3)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class _Recorded(Exception):
    pass


def _record(monkeypatch, module, name, train, cfg, **kw):
    """The arguments ``train(cfg, **kw)`` hands ``module.<name>``, stopping
    the run there."""
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
    """A net's leaves, then the dict's other leaves by name (the port's
    order)."""
    if isinstance(params, dict):
        return (jax.tree_util.tree_leaves(params["net"])
                + [params[k] for k in sorted(params) if k != "net"])
    return jax.tree_util.tree_leaves(params)


def _port_leaves(params):
    if isinstance(params, dict):
        return _port_leaves(params["net"]) + [params[k] for k in sorted(params) if k != "net"]
    return [t for pair in params for t in pair]


def _trainable(params):
    if isinstance(params, dict):
        out = {k: (_trainable(v)[0] if k == "net" else v.clone().requires_grad_(True))
               for k, v in params.items()}
    else:
        out = [(W.clone().requires_grad_(True), b.clone().requires_grad_(True))
               for W, b in params]
    return out, _port_leaves(out)


def _jax_value_and_grads(fn, params):
    (v, _), g = jax.value_and_grad(fn, has_aux=True)(params)
    return float(v), [np.asarray(x) for x in _jax_leaves(g)]


def _port_value_and_grads(fn, params):
    p, leaves = _trainable(params)
    v, _ = fn(p)
    g = torch.autograd.grad(v, leaves, allow_unused=True)
    return float(v), [np.zeros(t.shape) if x is None else x.numpy()
                      for t, x in zip(leaves, g)]


def _check(got, want, what, per_leaf=True):
    """The total and every gradient leaf within rel 1e-5 (``per_leaf=False``:
    the WAN critic's leaves held together, as in ``test_torch_eigen1d``)."""
    (tv, tg), (jv, jg) = got, want
    assert abs(tv - jv) <= 1e-5 * abs(jv), (what, tv, jv)
    assert len(tg) == len(jg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape, (what, i)
        if per_leaf:
            assert _rel(a, b) <= 1e-5, (what, i, _rel(a, b))
    flat = [np.concatenate([np.ravel(a) for a in g]) for g in (tg, jg)]
    assert _rel(*flat) <= 1e-5, (what, _rel(*flat))


OBJECTIVE_CASES = (
    [("PINN", r, t, (1, 1), dict(trainable_energy=True)) for r in ROUTES
     for t in ("FBC", "FN", "OG")]
    + [("PINN", "fused", "FN", (1, 2), {}), ("PINN", "kernel", "OG", (0, 1),
                                           dict(energy_variant=True))]
    + [("DRM", r, t, nxy, {}) for r in ("torch", "fused")
       for t, nxy in (("FBC", (1, 1)), ("FN", (1, 2)), ("OG", (2, 0)))]
    + [("WAN", r, t, nxy, kw) for r in ("torch", "fused")
       for t, nxy, kw in (("FBC", (0, 0), {}), ("FN", (1, 1), {}),
                          ("OG", (1, 0), dict(energy_variant=True)))]
)


@pytest.mark.parametrize("method,route,technique,nxy,extra", OBJECTIVE_CASES)
def test_objective_matches_jax(monkeypatch, method, route, technique, nxy, extra):
    kw = dict(SMALL, method=method, technique=technique, nx=nxy[0], ny=nxy[1], **extra)
    name = "fit_wan" if method == "WAN" else "fit"
    jrec = _record(monkeypatch, jq, name, jq.train_qho_2d, jq.QHO2DConfig(jet_impl="xla", **kw))
    key = jax.random.PRNGKey(5)
    if method != "WAN":
        jloss, _, jparams = jrec["args"]
        want = _jax_value_and_grads(lambda p: jloss(p, key), jparams)
        trec = _record(monkeypatch, tq, name, tq.train_qho_2d,
                       tq.QHO2DConfig(jet_impl=route, **kw),
                       init_params=params_from_jax(jparams["net"]), device="cpu")
        tloss, _, tparams = trec["args"]
        assert sorted(tparams) == sorted(jparams)
        lag = trec["kwargs"].get("loss_and_grad_fn")
        assert (lag is not None) == (route == "fused" and method == "PINN")
        if lag is not None:
            p, _ = _trainable(tparams)
            (tv, _), g = lag(p, 0)
            got = (float(tv), [x.numpy() for x in _port_leaves(g)])
        else:
            got = _port_value_and_grads(lambda p: tloss(p, 0), tparams)
        _check(got, want, "loss")
        if "E" in jparams:
            assert float(tparams["E"]) == float(jparams["E"])
        return
    ju_loss, jv_loss, _, ju, jv = jrec["args"]
    jctx = jrec["kwargs"]["v_context_fn"](ju, key)
    trec = _record(monkeypatch, tq, name, tq.train_qho_2d, tq.QHO2DConfig(jet_impl=route, **kw),
                   init_params=params_from_jax(ju["net"]), init_v_params=params_from_jax(jv),
                   device="cpu")
    tu_loss, tv_loss, _, tu, tv = trec["args"]
    tctx = trec["kwargs"]["v_context_fn"](tu, 0)
    _check(_port_value_and_grads(lambda p: tu_loss(p, tv, 0), tu),
           _jax_value_and_grads(lambda p: ju_loss(p, jv, key), ju), "u loss")
    _check(_port_value_and_grads(lambda p: (tv_loss(p, tctx, 0), None), tv),
           _jax_value_and_grads(lambda p: (jv_loss(p, jctx, key), None), jv), "v loss",
           per_leaf=False)


# ---------------------------------------------------------- the trainings
TRAIN_KW = {"PINN": dict(nx=1, ny=1, technique="FN", trainable_energy=True, energy_lr=1e-4,
                         energy_variant=True),
            "DRM": dict(nx=1, ny=2, technique="FN"),
            "WAN": dict(nx=1, ny=1, technique="FN")}


@functools.lru_cache(maxsize=None)
def _jax_run(method, j_route="xla"):
    """The JAX package's run of one small case: (history totals, final E or
    None, initial net, initial critic)."""
    box = {}
    name = "fit_wan" if method == "WAN" else "fit"
    real = getattr(jq, name)

    def spy(*args, **kwargs):
        box["args"] = args
        return real(*args, **kwargs)

    setattr(jq, name, spy)
    try:
        out = jq.train_qho_2d(jq.QHO2DConfig(jet_impl=j_route, method=method, **SMALL,
                                             **TRAIN_KW[method]))
    finally:
        setattr(jq, name, real)
    params = out["result"].params
    E = float(params["E"]) if "E" in params else None
    if method == "WAN":
        return np.asarray(out["history"]["total"]), E, box["args"][3]["net"], box["args"][4]
    return np.asarray(out["history"]["total"]), E, box["args"][2]["net"], None


def _port_run(method, route, u0, v0, **kw):
    init = dict(init_params=params_from_jax(u0), device="cpu")
    if v0 is not None:
        init["init_v_params"] = params_from_jax(v0)
    cfg = dict(SMALL, method=method, **TRAIN_KW[method])
    cfg.update(kw)
    return tq.train_qho_2d(tq.QHO2DConfig(jet_impl=route, **cfg), **init)


@pytest.mark.parametrize("method,route", [(m, r) for m in ("PINN", "DRM", "WAN")
                                          for r in (ROUTES if m == "PINN"
                                                    else ("torch", "fused"))])
def test_training_starts_as_jax(method, route):
    totals, E, u0, v0 = _jax_run(method)
    out = _port_run(method, route, u0, v0)
    hist = out["history"]["total"]
    assert hist.shape == totals.shape and np.all(np.isfinite(hist))
    np.testing.assert_allclose(hist[0], totals[0], rtol=1e-4)
    np.testing.assert_allclose(hist, totals, rtol=5e-2)
    if E is not None:
        # three Adam steps of 1e-4 on E: the same E to well below a step
        assert abs(float(out["result"].params["E"]) - E) <= 1e-6
        assert out["learned_energy"] == float(out["result"].best_params["E"])


@pytest.mark.parametrize("method", ["PINN", "DRM", "WAN"])
def test_training_starts_as_jax_pallas_fused(method):
    """The port's ``fused`` route against the JAX package's ``pallas-fused``
    (interpret mode on the CPU): the e lane on PINN, the Rayleigh pair with
    V on DRM, the weak-form pair with V on WAN."""
    totals, E, u0, v0 = _jax_run(method, "pallas-fused")
    out = _port_run(method, "fused", u0, v0)
    np.testing.assert_allclose(out["history"]["total"][0], totals[0], rtol=1e-4)
    if E is not None:
        assert abs(float(out["result"].params["E"]) - E) <= 1e-6


def test_energy_lr_moves_E_by_its_own_rate():
    """One Adam step moves each leaf by about its group's rate (the first
    step is lr * g / |g|): E by ``energy_lr``, the net's leaves by ``lr``,
    with one shared update count; without ``energy_lr`` E takes ``lr``."""
    _, _, u0, _ = _jax_run("PINN")
    for energy_lr, want in ((1e-4, 1e-4), (None, 1e-3)):
        out = _port_run("PINN", "fused", u0, None, epochs=1, chunk=1, energy_lr=energy_lr)
        dE = abs(float(out["result"].params["E"]) - out["E_exact"])
        assert abs(dE - want) <= 1e-3 * want, (energy_lr, dE)
        dW = max(float(torch.max(torch.abs(W - W0)))
                 for (W, _), W0 in zip(out["result"].params["net"],
                                       [torch.as_tensor(np.asarray(W)) for W, _ in u0]))
        assert abs(dW - 1e-3) <= 1e-5


def test_lbfgs_polish_runs_over_net_and_E(monkeypatch):
    """``LBFGS=True`` with a trainable E: the polish starts from the last
    Adam iterate with E in it and moves E with the net; cut to 5 iterations
    in both packages, the polished leaves within 1e-4 of JAX's."""
    jfit, jbox, tbox = {}, {}, {}

    def spy(module, name, box, iters=None):
        real = getattr(module, name)

        def f(*args, **kw):
            if iters is not None:
                kw["max_iter"] = iters
            box["args"] = args
            box["out"] = real(*args, **kw)
            return box["out"]

        monkeypatch.setattr(module, name, f)

    spy(jq, "fit", jfit)
    spy(jq, "lbfgs_polish", jbox, iters=5)
    spy(tipw, "lbfgs_polish", tbox, iters=5)
    kw = dict(SMALL, method="PINN", **TRAIN_KW["PINN"], LBFGS=True)
    jout = jq.train_qho_2d(jq.QHO2DConfig(jet_impl="xla", **kw))
    tout = tq.train_qho_2d(tq.QHO2DConfig(jet_impl="fused", **kw),
                           init_params=params_from_jax(jfit["args"][2]["net"]), device="cpu")

    def flat(p):
        return np.concatenate([np.asarray(t.detach() if isinstance(t, torch.Tensor) else t,
                                          np.float64).reshape(-1) for t in
                               (_port_leaves(p) if isinstance(p["net"][0][0], torch.Tensor)
                                else _jax_leaves(p))])

    assert sorted(tbox["args"][1]) == ["E", "net"]
    assert _rel(flat(tbox["args"][1]), flat(jbox["args"][1])) <= 1e-5
    assert _rel(flat(tbox["out"][0]), flat(jbox["out"][0])) <= 1e-4
    assert float(tbox["out"][0]["E"]) != float(tbox["args"][1]["E"])
    np.testing.assert_allclose(tout["L2_error"], jout["L2_error"], rtol=1e-3)
    assert tout["min_epoch"] == jout["min_epoch"]
    np.testing.assert_allclose(tout["learned_energy"], jout["learned_energy"], rtol=1e-5)


# ------------------------------------------------------------------ raises
@pytest.mark.parametrize("jet_impl,port", [("xla", "torch"), ("pallas", "kernel"),
                                           ("pallas-fused", "fused")])
def test_jax_route_names_raise(jet_impl, port):
    with pytest.raises(ValueError, match=f"jet_impl={port!r}"):
        tq.train_qho_2d(tq.QHO2DConfig(jet_impl=jet_impl), device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(method="DRM", trainable_energy=True), "trainable_energy"),
    (dict(method="WAN", trainable_energy=True), "trainable_energy"),
    (dict(method="FEM"), "method"),
    (dict(technique="BC"), "technique"),
])
def test_bad_options_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        tq.train_qho_2d(tq.QHO2DConfig(**dict(SMALL, **kw)), device="cpu")


def test_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tq.train_qho_2d(tq.QHO2DConfig())
