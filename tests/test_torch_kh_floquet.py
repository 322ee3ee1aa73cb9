"""The Floquet KH atom of the port (``problems/kh_floquet.py``) against the
JAX package, on the CPU at a small size: a ground truth of N = 300 points,
M = 1 (C = 3 harmonics, 6 output channels), 64 training points, nets (1,
16, 16, 6).  Both packages train on the same ground truth: the port's
takes JAX's states (ARPACK's random start leaves each state's global phase
free, ``tests/test_torch_kh.py``); JAX's weights are carried across by
``interop.params_from_jax``.

* ``phase_aware_mse`` within rel 1e-6 in float32 and 1e-12 in float64,
  and unchanged by a global phase.
* The objective the JAX package hands ``fit`` against the port's, for n =
  0 and 1 (the orthogonality term), FBC and RAW: the total, every term,
  every gradient leaf of the net and E's gradient within rel 1e-5, and
  the eval metric.
* The data indices (float32 ``linspace`` truncated) equal JAX's at the
  sizes the tests, the card's groups and the acceptance rows use.
* 3 epochs of ``train_kh_floquet`` from its default init (the JAX
  package's weights for the seed, bit for bit) within rtol 1e-4 of JAX's
  history; the result's keys, the harmonic weights summing to 1.
* ``fit`` and ``fit_wan`` record a tracked trainable leaf (E) before the
  step updates it in place.
* Raises: a ground truth of another M, no card.

Cost: about 30 s alone on one CPU worker (the JAX package's compiles of
its objectives and 3-epoch trainings, the two FD ground truths).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnpde_tpu.pde.kh as jkh
import nnpde_tpu.problems.kh_floquet as jfloq
import nnpde_tpu_torch.pde.kh as tkh
import nnpde_tpu_torch.problems as tproblems
import nnpde_tpu_torch.problems.kh_floquet as tfloq
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.models.mlp import init_mlp_threefry

GT = dict(alpha=2.0, omega=0.3, L=30.0, N=300, M=1, n_levels=2, n_theta=64)
SMALL = dict(width=16, depth=2, train_n=64, n_ref=300, M=1, epochs=3, chunk=3)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@functools.lru_cache(maxsize=None)
def _gts():
    jgt = jkh.FloquetGroundTruth(**GT)
    tgt = tkh.FloquetGroundTruth(**GT, device="cpu")
    for name in ("x", "eps", "Phi_re", "Phi_im"):
        setattr(tgt, name, torch.as_tensor(np.asarray(getattr(jgt, name))))
    return jgt, tgt


def _cfgs(**kw):
    kw = dict(SMALL, **kw)
    return jfloq.KHFloquetConfig(**kw), tfloq.KHFloquetConfig(**kw)


# ------------------------------------------------------ phase-aware MSE
@pytest.mark.parametrize("dtype,bar", [("float32", 1e-6), ("float64", 1e-12)])
def test_phase_aware_mse_matches_jax(dtype, bar):
    rng = np.random.default_rng(4)
    a, b, gr, gi = (rng.normal(size=(40, 5)) for _ in range(4))
    with jax.enable_x64(dtype == "float64"):
        want = float(jfloq.phase_aware_mse(*(jnp.asarray(t, dtype) for t in (a, b, gr, gi))))
    t = [torch.as_tensor(x, dtype=getattr(torch, dtype)) for x in (a, b, gr, gi)]
    got = tfloq.phase_aware_mse(*t)
    assert abs(float(got) - want) <= bar * abs(want)
    # a global phase of the field changes nothing
    c, s = np.cos(0.9), np.sin(0.9)
    rot = tfloq.phase_aware_mse(c * t[0] - s * t[1], s * t[0] + c * t[1], t[2], t[3])
    assert abs(float(rot) - float(got)) <= 10 * bar * abs(float(got))


# --------------------------------------------------------- the objective
class _Recorded(Exception):
    pass


def _record(monkeypatch, module, call):
    box = {}

    def recorder(*args, **kwargs):
        box.update(args=args, kwargs=kwargs)
        raise _Recorded

    with monkeypatch.context() as m:
        m.setattr(module, "fit", recorder)
        with pytest.raises(_Recorded):
            call()
    return box


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("technique", ["FBC", "RAW"])
def test_objective_matches_jax(monkeypatch, n, technique):
    jgt, tgt = _gts()
    jcfg, tcfg = _cfgs(n=n, technique=technique)
    jrec = _record(monkeypatch, jfloq, lambda: jfloq.train_kh_floquet(jcfg, jgt))
    jloss, jeval, jparams = jrec["args"]
    trec = _record(monkeypatch, tfloq, lambda: tfloq.train_kh_floquet(
        tcfg, tgt, init_params=params_from_jax(jparams["net"]), device="cpu"))
    tloss, teval, tparams = trec["args"]
    assert sorted(tparams) == ["E", "net"] and float(tparams["E"]) == float(jparams["E"])
    assert trec["kwargs"]["epochs"] == jrec["kwargs"]["epochs"]

    key = jax.random.PRNGKey(0)
    (jv, jaux), jg = jax.jit(jax.value_and_grad(lambda p: jloss(p, key), has_aux=True))(jparams)
    p = {"net": [(W.clone().requires_grad_(True), b.clone().requires_grad_(True))
                 for W, b in tparams["net"]],
         "E": tparams["E"].clone().requires_grad_(True)}
    leaves = [t for pair in p["net"] for t in pair] + [p["E"]]
    tv, taux = tloss(p, 0)
    tg = torch.autograd.grad(tv, leaves)
    assert abs(float(tv) - float(jv)) <= 1e-5 * abs(float(jv)), (float(tv), float(jv))
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        assert abs(float(taux[k]) - float(jaux[k])) <= 1e-5 * abs(float(jaux[k])) + 1e-12, k
    if n == 0:
        assert float(taux["orth"]) == 0.0
    want = jax.tree_util.tree_leaves(jg["net"]) + [jg["E"]]
    for i, (a, b) in enumerate(zip(tg, want)):
        assert a.shape == b.shape, i
        assert _rel(a.numpy(), b) <= 1e-5, (i, _rel(a.numpy(), b))
    with torch.no_grad():
        te = float(teval(tparams, 0))
    je = float(jax.jit(jeval)(jparams, key))
    assert abs(te - je) <= 1e-5 * abs(je)


@pytest.mark.parametrize("train_n", [48, 64, 384, 1024])
def test_data_indices_match_jax(train_n):
    """The strided data subset, for the parity tests' sizes, the card's
    ``floquet`` group (384) and the acceptance rows (1024)."""
    for frac, cap in ((0.25, 256), (0.5, None)):
        k = max(1, int(train_n * frac))
        k = min(k, cap) if cap else k
        want = np.asarray(jnp.linspace(0, train_n - 1, k).astype(jnp.int32))
        got = torch.linspace(0, train_n - 1, k, dtype=torch.float32).to(torch.int64).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- the training
@functools.lru_cache(maxsize=None)
def _jax_run(n):
    jgt, _ = _gts()
    box = {}
    real = jfloq.fit

    def spy(*args, **kwargs):
        box["net"] = [(np.asarray(W), np.asarray(b)) for W, b in args[2]["net"]]
        return real(*args, **kwargs)

    jfloq.fit = spy
    try:
        out = jfloq.train_kh_floquet(_cfgs(n=n)[0], jgt)
    finally:
        jfloq.fit = real
    return out, box["net"]


@pytest.mark.parametrize("n", [0, 1])
def test_training_starts_as_jax(n):
    """From the port's default init, the JAX package's weights for the seed
    (equal to those JAX's run started from)."""
    want, net0 = _jax_run(n)
    _, tgt = _gts()
    cfg = _cfgs(n=n)[1]
    for (W, b), (tW, tb) in zip(net0, init_mlp_threefry(cfg.seed, tfloq.ChannelSolutionModel(
            tfloq.NetSpec((1, 16, 16, 6), activation="sin")).spec)):
        np.testing.assert_array_equal(tW.numpy(), W)
        np.testing.assert_array_equal(tb.numpy(), b)
    got = tfloq.train_kh_floquet(cfg, tgt, device="cpu")
    assert sorted(got) == sorted(want)
    assert sorted(got["history"]) == sorted(want["history"])
    for k, v in want["history"].items():
        assert got["history"][k].shape == (3,), k
        np.testing.assert_allclose(got["history"][k], v, rtol=1e-4, atol=1e-12, err_msg=k)
    for k in ("mse", "rel_l2", "eps_est", "eps_ref", "eps_avg"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["best_epoch"] == want["best_epoch"]
    np.testing.assert_allclose(got["harmonic_weights"], want["harmonic_weights"], rtol=1e-4)
    np.testing.assert_allclose(sum(got["harmonic_weights"]), 1.0, atol=1e-12)
    assert got["phi_re"].shape == got["phi_im"].shape == (SMALL["train_n"], 3)
    np.testing.assert_allclose(got["x"], want["x"], atol=4e-6 * SMALL["train_n"])
    assert got["config"] == want["config"] and got["gt"] is tgt


@pytest.mark.parametrize("trainer", ["fit", "fit_wan"])
def test_tracked_leaf_is_recorded_before_its_update(trainer):
    """A metric that is a trainable leaf (E here, as the Floquet, KH and 2D
    oscillator objectives report it) enters the history with the value the
    step started from, as the JAX package's scan records it, not as the
    optimizer leaves it in place afterwards."""
    from nnpde_tpu_torch.train import fit, fit_wan, make_optimizer

    net = [(torch.ones(1, 1), torch.zeros(1))]
    params = {"net": net, "E": torch.tensor(0.5)}

    def loss(p):
        return (p["E"] - 2.0) ** 2 + (p["net"][0][0] ** 2).sum(), {"E": p["E"]}

    def after(p, k):                   # the eval: E after the step
        return 1.0 * p["E"]

    if trainer == "fit":
        res = fit(lambda p, k: loss(p), after, params, epochs=4,
                  optimizer=make_optimizer(0.1), key=0, chunk=4)
    else:
        res = fit_wan(lambda p, v, k: loss(p), lambda v, ctx, k: sum((t ** 2).sum() for t in v[0]),
                      after, params, net, epochs=4, v_steps=1,
                      u_optimizer=make_optimizer(0.1), v_optimizer=make_optimizer(0.1),
                      key=0, chunk=4)
    E = res.history["E"]
    assert E[0] == np.float32(0.5) and np.all(np.diff(E) > 0)
    np.testing.assert_allclose(E[1:], res.history["l2"][:-1], rtol=1e-6)


# ------------------------------------------------------------------ raises
def test_bad_ground_truth_and_missing_card_raise(monkeypatch):
    _, tgt = _gts()
    with pytest.raises(ValueError, match="M=1 != config M=2"):
        tfloq.train_kh_floquet(tfloq.KHFloquetConfig(M=2), tgt, device="cpu")
    assert tproblems.train_kh_floquet is tfloq.train_kh_floquet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tproblems.train_kh_floquet(tproblems.KHFloquetConfig(epochs=1))
