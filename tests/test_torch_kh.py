"""The Kramers-Henneberger slice of the port (``pde/kh.py``, ``native.py``,
``exp/ledger.py``, ``exp/checkpoint.py``, ``problems/kh.py``) against the
JAX package, on the CPU at a small size (a ground truth of N = 400 points
with 50 theta samples, 48 training points, ``(1, 16, 16, 1)`` nets).

* ``pde/kh``: the potentials, the Fourier components and the FD
  eigensystem (on the native route and on scipy's) equal to JAX's in
  float64 within 1e-12; the device interpolation at, between and beyond
  the nodes; the Floquet eigensystem and its ground truth's tables.
* ``native``: the library is built into the port's build directory and
  nowhere under ``nnpde_tpu/``.
* Records: parameter files written by either package load in the other
  (dict keys in sorted order); the same rows and curves give the same
  ledger and ``.npy`` files; the train state round-trips.
* Objectives: each method x route x technique (RAW, FBC) of ``train_kh``
  builds its objective from JAX weights carried across; the total, every
  gradient leaf and E's gradient within rel 1e-5 of the objective the JAX
  package hands ``fit`` / ``fit_wan`` (on ``fused`` PINN, E's gradient
  from the kernel's e lane; on ``fused`` WAN the ratio-squared pair with
  the critic's direct ascent).
* Trainings: 3 epochs of each method and route from the JAX run's initial
  weights start within rtol 1e-4 of JAX's ``xla`` run, and of its
  ``pallas-fused`` route (interpret mode) once per method; ``run_compare``
  gives JAX's row schema and saves what JAX saves.
* Raises: the JAX route names, a bad method, no card.

Cost: about 61 s on one CPU worker alone; about 15 s of it the JAX
package's first compiles of its ops, which a worker shares with the files
it ran before.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnpde_tpu.exp.checkpoint as jckpt
import nnpde_tpu.exp.ledger as jledger
import nnpde_tpu.native as jnative
import nnpde_tpu.pde.kh as jkh
import nnpde_tpu.problems.kh as jprob
import nnpde_tpu_torch
import nnpde_tpu_torch.exp.checkpoint as tckpt
import nnpde_tpu_torch.exp.ledger as tledger
import nnpde_tpu_torch.native as tnative
import nnpde_tpu_torch.pde.kh as tkh
import nnpde_tpu_torch.problems.kh as tprob
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.train import fit, make_optimizer

GT = dict(alpha=10.0, L=60.0, N=400, n_levels=4, n_theta=50)
SMALL = dict(layers=(1, 16, 16, 1), v_layers=(1, 8, 8, 1), train_n=48, epochs=3, chunk=3)
ROUTES = ("torch", "kernel", "fused")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _gts():
    return jkh.KHGroundTruth(**GT), tkh.KHGroundTruth(**GT, device="cpu")


# ------------------------------------------------------------------ pde/kh
def test_potentials_and_fourier_components_match_jax():
    x = np.linspace(-70.0, 70.0, 301)
    with jax.enable_x64(True):
        jx = jnp.asarray(x)
        for jf, tf, kw in ((jkh.v_base, tkh.v_base, {}),
                           (jkh.v_kh_shift, tkh.v_kh_shift, dict(alpha=3.5)),
                           (jkh.v_kh_avg, tkh.v_kh_avg, dict(alpha0=10.0, n_theta=77)),
                           (jkh.v_kh_avg, tkh.v_kh_avg, dict(alpha0=0.0)),
                           (jkh.v_kh, tkh.v_kh, dict(alpha=4.0, use_avg=False)),
                           (jkh.v_kh, tkh.v_kh, dict(alpha=4.0, v0=-10.0))):
            want = np.asarray(jf(jx, **kw))
            np.testing.assert_allclose(tf(torch.as_tensor(x), **kw).numpy(), want,
                                       rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(tf(x, **kw), np.asarray(jf(x, **kw)), rtol=0, atol=0)
    for kw in (dict(alpha0=10.0), dict(alpha0=2.0, j_max=3, n_theta=64)):
        for a, b in zip(tkh.v_fourier_components(x, **kw), jkh.v_fourier_components(x, **kw)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", ["native", "scipy"])
def test_reference_eigensystem_matches_jax(monkeypatch, route):
    if route == "scipy":
        monkeypatch.setattr(tnative, "tridiag_eigh", lambda *a: None)
        monkeypatch.setattr(jnative, "tridiag_eigh", lambda *a: None)
    else:
        assert tnative.load() is not None
    kw = dict(L=60.0, N=500, alpha=10.0, k_max=5, n_theta=60)
    for got, want in zip(tkh.reference_eigensystem(**kw), jkh.reference_eigensystem(**kw)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if route == "native":
        # the native and scipy routes agree on the same problem
        monkeypatch.setattr(tnative, "tridiag_eigh", lambda *a: None)
        _, E_s, psi_s = tkh.reference_eigensystem(**kw)
        _, E_n, psi_n = jkh.reference_eigensystem(**kw)
        np.testing.assert_allclose(E_s, E_n, rtol=1e-10)
        np.testing.assert_allclose(np.abs(psi_s), np.abs(psi_n), atol=1e-8)


def test_interp_matches_jax_at_between_and_beyond_nodes():
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(-5.0, 5.0, 40))
    xp[7] = xp[6]                                    # a segment of zero width
    fp = rng.normal(size=40)
    x = np.concatenate([xp, (xp[1:] + xp[:-1]) / 2, [-9.0, xp[0] - 1e-9, xp[-1] + 1e-9, 9.0],
                        rng.uniform(-6.0, 6.0, 50)])
    with jax.enable_x64(True):
        want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    got = tkh.interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # float32, as the ground truth resamples
    want32 = np.asarray(jnp.interp(jnp.asarray(x, jnp.float32), jnp.asarray(xp, jnp.float32),
                                   jnp.asarray(fp, jnp.float32)))
    got32 = tkh.interp(torch.as_tensor(x, dtype=torch.float32),
                       torch.as_tensor(xp, dtype=torch.float32),
                       torch.as_tensor(fp, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got32, want32, rtol=1e-6, atol=1e-7)


def test_ground_truth_and_resample_match_jax():
    jgt, tgt = _gts()
    for name in ("x", "V", "E", "psi"):
        np.testing.assert_array_equal(getattr(tgt, name).numpy(), np.asarray(getattr(jgt, name)))
    assert tgt.energy(2) == jgt.energy(2)
    x = np.concatenate([np.linspace(-65.0, 65.0, 97), np.asarray(jgt.x)[::37]]).astype(np.float32)
    for got, want in zip(tgt.resample(torch.as_tensor(x)), jgt.resample(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-7)


def test_floquet_ground_truth_matches_jax():
    """The quasi-energies, and the states up to their global phase: on this
    symmetric potential ``|phi(x)| = |phi(-x)|``, so the gauge's largest
    sample is a tie that ARPACK's random start breaks either way (in the
    JAX package too); each level is aligned by its overlap first."""
    kw = dict(alpha=2.0, omega=0.3, L=30.0, N=200, M=1, n_levels=2, n_theta=64)
    jgt, tgt = jkh.FloquetGroundTruth(**kw), tkh.FloquetGroundTruth(**kw, device="cpu")
    np.testing.assert_allclose(tgt.eps.numpy(), np.asarray(jgt.eps), rtol=1e-6)
    tP = tgt.Phi_re.numpy() + 1j * tgt.Phi_im.numpy()
    jP = np.asarray(jgt.Phi_re) + 1j * np.asarray(jgt.Phi_im)
    ov = np.einsum("xmk,xmk->k", np.conj(tP), jP)
    phase = ov / np.abs(ov)
    np.testing.assert_allclose(tP * phase, jP, atol=1e-5)
    x = np.linspace(-31.0, 31.0, 29).astype(np.float32)
    for a, b in zip(tgt.coupling_matrices(torch.as_tensor(x)), jgt.coupling_matrices(x)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    (tre, tim), (jre, jim) = tgt.resample(torch.as_tensor(x)), jgt.resample(jnp.asarray(x))
    np.testing.assert_allclose((tre.numpy() + 1j * tim.numpy()) * phase,
                               np.asarray(jre) + 1j * np.asarray(jim), atol=1e-5)


# ------------------------------------------------------------------ native
def test_native_library_lands_in_the_ports_build_directory(monkeypatch, tmp_path):
    port = os.path.dirname(os.path.abspath(nnpde_tpu_torch.__file__))
    assert str(tnative.SO).startswith(os.path.join(port, "_build") + os.sep)
    jax_native = os.path.join(os.path.dirname(port), "nnpde_tpu", "_native")

    def listing():
        if not os.path.isdir(jax_native):
            return None
        return sorted((f, os.stat(os.path.join(jax_native, f)).st_mtime_ns)
                      for f in os.listdir(jax_native))

    before = listing()
    so = tmp_path / "_build" / "libnnpde_native.so"
    monkeypatch.setattr(tnative, "BUILD_DIR", so.parent)
    monkeypatch.setattr(tnative, "SO", so)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    assert tnative.load() is not None and so.exists()
    assert sorted(os.listdir(so.parent)) == ["libnnpde_native.so"]
    w, z = tnative.tridiag_eigh(np.full(50, 2.0), np.full(49, -1.0), 3)
    np.testing.assert_allclose(w, 2.0 - 2.0 * np.cos(np.pi * np.arange(1, 4) / 51), rtol=1e-10)
    assert listing() == before


# ----------------------------------------------------------------- records
def test_params_files_cross_load_with_sorted_keys(tmp_path):
    rng = np.random.default_rng(4)
    net = [(rng.normal(size=(1, 5)).astype(np.float32), rng.normal(size=5).astype(np.float32)),
           (rng.normal(size=(5, 1)).astype(np.float32), rng.normal(size=1).astype(np.float32))]
    # keys inserted out of order: both packages flatten them sorted
    tree = {"net": net, "E": np.float32(-0.125), "a": (np.arange(3.0), None)}
    meta = {"problem": "kh_1d", "layers": [1, 5, 1], "n": 2}
    jpath = jckpt.save_params(str(tmp_path / "jax"), {k: (jnp.asarray(v) if k == "E" else v)
                                                      for k, v in tree.items()}, meta=meta)
    tparams = {"net": params_from_jax(net), "E": torch.tensor(-0.125),
               "a": (torch.arange(3.0, dtype=torch.float64), None)}
    tpath = tckpt.save_params(str(tmp_path / "port"), tparams, meta=meta)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            np.testing.assert_array_equal(zj[f], zt[f])
    for loaded, m in (tckpt.load_params(jpath), tckpt.load_params(str(tmp_path / "jax"))):
        assert m == meta and list(loaded) == ["E", "a", "net"]
        assert float(loaded["E"]) == -0.125 and loaded["a"][1] is None
        for (W, b), (W0, b0) in zip(loaded["net"], net):
            np.testing.assert_array_equal(W.numpy(), W0)
            np.testing.assert_array_equal(b.numpy(), b0)
    jl, jm = jckpt.load_params(tpath)
    assert jm == meta and isinstance(jl["net"], list) and isinstance(jl["a"], tuple)
    np.testing.assert_array_equal(np.asarray(jl["net"][1][0]), net[1][0])
    assert float(jl["E"]) == -0.125


def test_ledger_rows_and_curves_match_jax(tmp_path):
    row = {"method": "PINN", "n": 1, "E_est": np.float32(-0.0027), "best_epoch": np.int64(7),
           "v_steps": None, "arr": np.arange(3.0), "max_data_points": 128}
    for pkg, led in (("jax", jledger), ("port", tledger)):
        f = str(tmp_path / pkg / "results.json")
        led.append_result(f, row)
        led.append_result(f, dict(row, n=2))
        led.save_curves(str(tmp_path / pkg), "tag", {"losses": np.linspace(0, 1, 5),
                                                      "E": [0.5, 0.25]})
    jfile, tfile = (tmp_path / p / "results.json" for p in ("jax", "port"))
    assert jfile.read_bytes() == tfile.read_bytes()
    assert tledger.load_results(str(jfile)) == jledger.load_results(str(tfile))
    assert tledger.load_results(str(tmp_path / "none.json")) == []
    for name in ("tag_losses.npy", "tag_E.npy"):
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes())
    # a torch curve saves as its numpy copy
    tledger.save_curves(str(tmp_path / "t"), "c", {"x": torch.arange(4.0)})
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "c_x.npy"), np.arange(4.0))


def test_train_state_round_trips(tmp_path):
    torch.manual_seed(0)
    params = {"net": [(torch.randn(1, 4), torch.randn(4)), (torch.randn(4, 1), torch.randn(1))],
              "E": torch.tensor(0.5)}

    def loss_fn(p, key):
        u = torch.sin(torch.linspace(-1, 1, 9)[:, None] @ p["net"][0][0] + p["net"][0][1])
        v = (u @ p["net"][1][0] + p["net"][1][1])[:, 0]
        return torch.mean((v - p["E"]) ** 2), {}

    def eval_fn(p, key):
        return loss_fn(p, key)[0]

    opt = make_optimizer(1e-2)
    whole = fit(loss_fn, eval_fn, params, epochs=8, optimizer=opt, key=1, chunk=4)
    half = fit(loss_fn, eval_fn, params, epochs=4, optimizer=opt, key=1, chunk=4)
    path = tckpt.save_train_state(str(tmp_path / "state.pt"), half.carry)
    carry = tckpt.load_train_state(path, fit(loss_fn, eval_fn, params, epochs=0,
                                             optimizer=opt, key=1).carry)
    rest = fit(loss_fn, eval_fn, params, epochs=4, optimizer=opt, key=1, chunk=4,
               init_carry=carry, start_epoch=4)
    assert rest.carry.count == 8
    for a, b in zip(tckpt._leaves(rest.params), tckpt._leaves(whole.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------- the objectives
class _Recorded(Exception):
    pass


def _record(monkeypatch, module, name, call):
    box = {}

    def recorder(*args, **kwargs):
        box.update(args=args, kwargs=kwargs)
        raise _Recorded

    monkeypatch.setattr(module, name, recorder)
    with pytest.raises(_Recorded):
        call()
    monkeypatch.undo()
    return box


def _jax_leaves(params):
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
    return float(v), [np.zeros(t.shape) if x is None else x.detach().numpy()
                      for t, x in zip(leaves, g)]


def _check(got, want, what, per_leaf=True):
    (tv, tg), (jv, jg) = got, want
    assert abs(tv - jv) <= 1e-5 * abs(jv), (what, tv, jv)
    assert len(tg) == len(jg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape, (what, i)
        if per_leaf and np.linalg.norm(b) > 0:
            assert _rel(a, b) <= 1e-5, (what, i, _rel(a, b))
        elif per_leaf:
            assert np.all(a == 0), (what, i)
    flat = [np.concatenate([np.ravel(a) for a in g]) for g in (tg, jg)]
    assert _rel(*flat) <= 1e-5, (what, _rel(*flat))


X_TRAIN = np.linspace(-60.0, 60.0, 48, dtype=np.float32)
OBJECTIVE_CASES = (
    [("PINN", r, t, 1, {}) for r in ROUTES for t in ("RAW", "FBC")]
    + [("PINN", "fused", "FBC", 2, dict(lambda_parity=1e2, max_data_points=5))]
    + [("DRM", r, t, n, {}) for r in ("torch", "fused") for t, n in (("RAW", 0), ("FBC", 1))]
    + [("WAN", r, "RAW", n, kw) for r in ("torch", "fused")
       for n, kw in ((0, {}), (2, dict(lambda_parity=1e2)))]
)


@pytest.mark.parametrize("method,route,technique,n,extra", OBJECTIVE_CASES)
def test_objective_matches_jax(monkeypatch, method, route, technique, n, extra):
    jgt, tgt = _gts()
    kw = dict(SMALL, method=method, technique=technique, n=n, **extra)
    name = "fit_wan" if method == "WAN" else "fit"
    jrec = _record(monkeypatch, jprob, name, lambda: jprob.train_kh(
        jprob.KHConfig(jet_impl="xla", **kw), jgt, x_train=X_TRAIN))
    key = jax.random.PRNGKey(5)
    if method != "WAN":
        jloss, _, jparams = jrec["args"]
        want = _jax_value_and_grads(lambda p: jloss(p, key), jparams)
        trec = _record(monkeypatch, tprob, name, lambda: tprob.train_kh(
            tprob.KHConfig(jet_impl=route, **kw), tgt, x_train=X_TRAIN,
            init_params=params_from_jax(jparams["net"]), device="cpu"))
        tloss, _, tparams = trec["args"]
        assert sorted(tparams) == ["E", "net"] and float(tparams["E"]) == float(jparams["E"])
        lag = trec["kwargs"].get("loss_and_grad_fn")
        assert (lag is not None) == (route == "fused" and method == "PINN")
        if lag is not None:
            p, _ = _trainable(tparams)
            (tv, _), g = lag(p, 0)
            got = (float(tv), [x.detach().numpy() for x in _port_leaves(g)])
        else:
            got = _port_value_and_grads(lambda p: tloss(p, 0), tparams)
        _check(got, want, "loss")
        return
    ju_loss, jv_loss, _, ju, jv = jrec["args"]
    jctx = jrec["kwargs"]["v_context_fn"](ju, key)
    trec = _record(monkeypatch, tprob, name, lambda: tprob.train_kh(
        tprob.KHConfig(jet_impl=route, **kw), tgt, x_train=X_TRAIN,
        init_params=params_from_jax(ju["net"]), init_v_params=params_from_jax(jv),
        device="cpu"))
    tu_loss, tv_loss, _, tu, tv = trec["args"]
    tctx = trec["kwargs"]["v_context_fn"](tu, 0)
    _check(_port_value_and_grads(lambda p: tu_loss(p, tv, 0), tu),
           _jax_value_and_grads(lambda p: ju_loss(p, jv, key), ju), "u loss")
    _check(_port_value_and_grads(lambda p: (tv_loss(p, tctx, 0), None), tv),
           _jax_value_and_grads(lambda p: (jv_loss(p, jctx, key), None), jv), "v loss",
           per_leaf=False)


# ---------------------------------------------------------- the trainings
TRAIN_KW = {"PINN": dict(n=1, technique="FBC"), "DRM": dict(n=1, technique="FBC"),
            "WAN": dict(n=0, technique="RAW")}


@functools.lru_cache(maxsize=None)
def _jax_run(method, j_route="xla"):
    jgt, _ = _gts()
    box = {}
    name = "fit_wan" if method == "WAN" else "fit"
    real = getattr(jprob, name)

    def spy(*args, **kwargs):
        box["args"] = args
        return real(*args, **kwargs)

    setattr(jprob, name, spy)
    try:
        out = jprob.train_kh(jprob.KHConfig(jet_impl=j_route, method=method, **SMALL,
                                            **TRAIN_KW[method]), jgt, x_train=X_TRAIN)
    finally:
        setattr(jprob, name, real)
    u0 = box["args"][3 if method == "WAN" else 2]["net"]
    v0 = box["args"][4] if method == "WAN" else None
    return np.asarray(out["history"]["total"]), out["E_est"], u0, v0


@pytest.mark.parametrize("method,route", [(m, r) for m in ("PINN", "DRM", "WAN")
                                          for r in (ROUTES if m == "PINN"
                                                    else ("torch", "fused"))])
def test_training_starts_as_jax(method, route):
    totals, E_est, u0, v0 = _jax_run(method)
    _, tgt = _gts()
    init = dict(init_params=params_from_jax(u0), device="cpu")
    if v0 is not None:
        init["init_v_params"] = params_from_jax(v0)
    out = tprob.train_kh(tprob.KHConfig(jet_impl=route, method=method, **SMALL,
                                        **TRAIN_KW[method]), tgt, x_train=X_TRAIN, **init)
    hist = out["history"]["total"]
    assert hist.shape == totals.shape and np.all(np.isfinite(hist))
    np.testing.assert_allclose(hist[0], totals[0], rtol=1e-4)
    np.testing.assert_allclose(hist, totals, rtol=5e-2)
    np.testing.assert_allclose(out["E_est"], E_est, rtol=1e-3, atol=1e-6)
    assert out["E_track"].shape == (3,) and out["E_ref"] == tgt.energy(TRAIN_KW[method]["n"])


@pytest.mark.parametrize("method", ["PINN", "DRM", "WAN"])
def test_training_starts_as_jax_pallas_fused(method):
    totals, _, u0, v0 = _jax_run(method, "pallas-fused")
    _, tgt = _gts()
    init = dict(init_params=params_from_jax(u0), device="cpu")
    if v0 is not None:
        init["init_v_params"] = params_from_jax(v0)
    out = tprob.train_kh(tprob.KHConfig(jet_impl="fused", method=method, **SMALL,
                                        **TRAIN_KW[method]), tgt, x_train=X_TRAIN, **init)
    np.testing.assert_allclose(out["history"]["total"][0], totals[0], rtol=1e-4)


def test_run_compare_rows_and_files_match_jax(tmp_path):
    kw = dict(n_ref=400, n_max=1, n_theta=50, train_n=48, layers=(1, 16, 16, 1),
              v_layers=(1, 8, 8, 1), epochs=2, chunk=2)
    jrows = jprob.run_compare(jprob.KHCompareConfig(save_dir=str(tmp_path / "jax"), **kw))
    trows = tprob.run_compare(tprob.KHCompareConfig(save_dir=str(tmp_path / "port"),
                                                    jet_impl="fused", **kw), device="cpu")
    assert [list(r) for r in trows] == [list(r) for r in jrows]
    for t, j in zip(trows, jrows):
        for k in ("method", "n", "alpha", "V0", "L", "technique", "epochs", "v_steps",
                  "max_data_points", "train_N"):
            assert t[k] == j[k], k
        np.testing.assert_allclose(t["E_ref"], j["E_ref"], rtol=1e-6)
        assert np.isfinite(t["L2_error_dense"]) and np.isfinite(t["E_est"])
        params, meta = jckpt.load_params(t["model_path"])
        assert meta["problem"] == "kh_1d" and sorted(params) == ["E", "net"]
        assert np.load(t["Etrack_npy"]).shape == (2,) and os.path.exists(t["plot_path"])
    ledger = json.loads((tmp_path / "port" / "results_KH_1D_unified.json").read_text())
    assert [r["method"] for r in ledger] == ["PINN", "DRM", "WAN"]


# ------------------------------------------------------------------ raises
@pytest.mark.parametrize("jet_impl,port", [("xla", "torch"), ("pallas", "kernel"),
                                           ("pallas-fused", "fused")])
def test_jax_route_names_raise(jet_impl, port):
    _, tgt = _gts()
    with pytest.raises(ValueError, match=f"jet_impl={port!r}"):
        tprob.train_kh(tprob.KHConfig(jet_impl=jet_impl), tgt, device="cpu")
    with pytest.raises(ValueError, match=f"jet_impl={port!r}"):
        tprob.run_compare(tprob.KHCompareConfig(n_ref=60, n_theta=8, n_max=1,
                                                jet_impl=jet_impl), device="cpu")


def test_bad_method_and_missing_card_raise(monkeypatch):
    _, tgt = _gts()
    with pytest.raises(ValueError, match="method"):
        tprob.train_kh(tprob.KHConfig(method="FEM"), tgt, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tprob.train_kh(tprob.KHConfig(), tgt),
                 lambda: tprob.run_compare(tprob.KHCompareConfig()),
                 lambda: tkh.KHGroundTruth(N=60, n_theta=8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
