"""The port's L-BFGS (``nnpde_tpu_torch/train/lbfgs.py``) against the JAX
package's (``nnpde_tpu/train/lbfgs.py``: ``optax.lbfgs(memory_size=100)``
with the zoom line search), in float64 under ``jax.enable_x64``.

* A 20-D quadratic of condition 100: every iterate within 1e-10 of the
  optax loop that the JAX ``lbfgs_polish`` runs (``value_and_grad_from_state``
  then ``update``), and ``lbfgs_polish`` itself at 25 iterations within
  1e-10 of the JAX function (params and the loss it returns).
* 10-D Rosenbrock from (-1.2, 1, ...): the first 20 iterates within 1e-8
  (line searches that zoom, not only unit steps).
* A (1, 8, 8, 1) sin QHO PINN loss on 64 points (both packages' own nets,
  factors and loss functions): the first 10 iterates and losses within 1e-7.
* ``lbfgs_fit`` in float32 (the JAX function's carry is float32 whatever the
  x64 flag): histories of exactly ``max_iter`` entries within rtol 1e-4 of
  the JAX function's, the same best epoch, and the converged no-op (after
  the gradient norm falls under ``tol`` the loss and eval repeat).
* ``torch.optim.LBFGS`` is used nowhere in the port.

Cost: about 15 s on the CPU (the JAX loops' compiles).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnpde_tpu.train import lbfgs as jlbfgs
from nnpde_tpu_torch.train import lbfgs as tlbfgs

N_QUAD = 20


def _quadratic():
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((N_QUAD, N_QUAD)))
    A = Q @ np.diag(np.logspace(0, 2, N_QUAD)) @ Q.T          # condition 100
    b = rng.standard_normal(N_QUAD)
    x0 = rng.standard_normal(N_QUAD)
    return A, b, x0


def _quad_fns(A, b):
    At, bt = torch.tensor(A), torch.tensor(b)

    def jf(p):
        x = jnp.concatenate([p[0][0].reshape(-1), p[0][1]])
        return 0.5 * x @ jnp.asarray(A) @ x - jnp.asarray(b) @ x

    def tf(p):
        x = torch.cat([p[0][0].reshape(-1), p[0][1]])
        return 0.5 * x @ At @ x - bt @ x

    return jf, tf


def _rosenbrock_fns():
    def jf(p):
        x = jnp.concatenate([p[0][0].reshape(-1), p[0][1]])
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    def tf(p):
        x = torch.cat([p[0][0].reshape(-1), p[0][1]])
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    return jf, tf


def _optax_iterates(jf, p0, n):
    """The iterates of the loop ``nnpde_tpu.train.lbfgs.lbfgs_polish`` runs
    (its step function, unrolled on the host so every iterate is seen)."""
    opt = optax.lbfgs(memory_size=100)
    vg = optax.value_and_grad_from_state(jf)

    @jax.jit
    def step(params, state):
        value, grad = vg(params, state=state)
        updates, state = opt.update(grad, state, params, value=value, grad=grad, value_fn=jf)
        return optax.apply_updates(params, updates), state, value

    p, st, out = p0, opt.init(p0), []
    for _ in range(n):
        p, st, v = step(p, st)
        out.append((np.concatenate([np.asarray(t).reshape(-1) for pair in p for t in pair]),
                    float(v)))
    return out


def _port_iterates(tf, p0, n):
    opt = tlbfgs._LBFGS(tf, p0, 100)
    out = []
    for _ in range(n):
        assert opt.step(1e-30)
        out.append((opt.x.numpy().copy(), float(opt.last_value)))
    return out


def _both(x0, W_shape=(3, 5)):
    """A flat start as one (W, b) leaf pair for each package (both
    optimisers work on [(W, b)] parameter lists)."""
    nW = int(np.prod(W_shape))
    W, b = x0[:nW].reshape(W_shape), x0[nW:]
    return [(jnp.asarray(W), jnp.asarray(b))], [(torch.tensor(W), torch.tensor(b))]


def test_quadratic_every_iterate_matches_optax():
    A, b, x0 = _quadratic()
    jf, tf = _quad_fns(A, b)
    with jax.enable_x64(True):
        pj, pt = _both(x0)
        ref = _optax_iterates(jf, pj, 25)
        got = _port_iterates(tf, pt, 25)
        for k, ((xr, vr), (xg, vg)) in enumerate(zip(ref, got)):
            assert np.max(np.abs(xg - xr)) <= 1e-10, k
            assert abs(vg - vr) <= 1e-10 * max(1.0, abs(vr)), k
        jp, jv = jlbfgs.lbfgs_polish(jf, pj, max_iter=25)
        tp, tv = tlbfgs.lbfgs_polish(tf, pt, max_iter=25)
        np.testing.assert_allclose(tp[0][0].numpy(), np.asarray(jp[0][0]), rtol=0, atol=1e-10)
        np.testing.assert_allclose(tp[0][1].numpy(), np.asarray(jp[0][1]), rtol=0, atol=1e-10)
        assert abs(float(tv) - float(jv)) <= 1e-10 * max(1.0, abs(float(jv)))


def test_rosenbrock_first_iterates_match_optax():
    x0 = np.tile([-1.2, 1.0], 5)
    jf, tf = _rosenbrock_fns()
    with jax.enable_x64(True):
        pj, pt = _both(x0, (2, 4))
        ref = _optax_iterates(jf, pj, 20)
        opt = tlbfgs._LBFGS(tf, pt, 100)
        for k, (xr, vr) in enumerate(ref):
            assert opt.step(1e-30)
            assert np.max(np.abs(opt.x.numpy() - xr)) <= 1e-8, k
            assert abs(float(opt.last_value) - vr) <= 1e-8 * max(1.0, abs(vr)), k
        # the path zooms: more evaluations than iterations
        assert opt.evals > opt.count


def _qho_pinn_losses():
    """The QHO PINN objective of both packages on a (1, 8, 8, 1) sin net with
    the FN window factor at n = 1 and 64 grid points, in float64."""
    from nnpde_tpu.losses import zoo as jzoo
    from nnpde_tpu.models import NetSpec as JNetSpec
    from nnpde_tpu.models import SolutionModel as JModel
    from nnpde_tpu.models import factor_for_technique as jfac
    from nnpde_tpu.pde import qho as jqho
    from nnpde_tpu_torch.losses import data_mse, norm_trapezoid, pinn_schrodinger
    from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
    from nnpde_tpu_torch.pde import qho

    layers, n, xm = (1, 8, 8, 1), 1, 6.0
    x = np.linspace(-xm, xm, 64)
    jm = JModel(JNetSpec(layers, activation="sin"),
                jfac("FN", dim=1, kind="window", L=xm, nodes_per_dim=[jqho.nodes(n)]))
    tm = SolutionModel(NetSpec(layers, activation="sin"),
                       factor_for_technique("FN", dim=1, kind="window", L=xm,
                                            nodes_per_dim=[qho.nodes(n)]))
    Xj, Xt = jnp.asarray(x[:, None]), torch.tensor(x[:, None])
    Vj, Vt = jqho.potential_1d(Xj[:, 0]), qho.potential_1d(Xt[:, 0])
    E = qho.energy_1d(n)
    ij = slice(16, 32, 4)
    dx = x[1] - x[0]

    def jf(p):
        jet = jm.fields(p, Xj)
        return (10.0 * jzoo.pinn_schrodinger(jet.value, jet.lap, Vj, E)
                + 1000.0 * jzoo.data_mse(jet.value[ij], jqho.psi_1d(n, Xj[ij, 0]))
                + 10.0 * jzoo.norm_trapezoid(jet.value, dx))

    def tf(p):
        jet = tm.fields(p, Xt)
        return (10.0 * pinn_schrodinger(jet.value, jet.lap, Vt, E)
                + 1000.0 * data_mse(jet.value[ij], qho.psi_1d(n, Xt[ij, 0]))
                + 10.0 * norm_trapezoid(jet.value, dx))

    return jm, jf, tf


def test_qho_pinn_loss_first_iterates_match():
    with jax.enable_x64(True):
        jm, jf, tf = _qho_pinn_losses()
        pj = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                    jm.init(jax.random.PRNGKey(0)))
        pt = [(torch.tensor(np.asarray(W)), torch.tensor(np.asarray(b))) for W, b in pj]
        ref = _optax_iterates(jf, pj, 10)
        opt = tlbfgs._LBFGS(tf, pt, 100)
        for k, (xr, vr) in enumerate(ref):
            assert opt.step(1e-30)
            scale = max(1.0, float(np.max(np.abs(xr))))
            assert np.max(np.abs(opt.x.numpy() - xr)) <= 1e-7 * scale, k
            assert abs(float(opt.last_value) - vr) <= 1e-7 * max(1.0, abs(vr)), k


@pytest.mark.parametrize("max_iter", [8, 40])
def test_lbfgs_fit_histories_best_and_converged_noop(max_iter):
    """In float32 (the JAX ``lbfgs_fit`` carries float32 and int32 scalars,
    so it runs without x64) with ``tol=1e-3``: 8 iterations stop short of
    convergence, 40 run past it, and the remaining iterations repeat the
    loss and eval at the final iterate.  Bar: rtol 1e-4 on the histories (a
    few float32 line searches apart)."""
    A, b, x0 = _quadratic()
    A, b, x0 = (A.astype(np.float32), b.astype(np.float32), x0.astype(np.float32))
    jf, tf = _quad_fns(A, b)
    x_star = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)).astype(np.float32)
    pj, pt = _both(x0)

    def j_eval(p):
        return jnp.sum((jnp.concatenate([p[0][0].reshape(-1), p[0][1]]) - x_star) ** 2)

    def t_eval(p):
        x = torch.cat([p[0][0].reshape(-1), p[0][1]])
        return torch.sum((x - torch.tensor(x_star)) ** 2)

    jr = jlbfgs.lbfgs_fit(jf, j_eval, pj, max_iter=max_iter, tol=1e-3)
    tr = tlbfgs.lbfgs_fit(tf, t_eval, pt, max_iter=max_iter, tol=1e-3)
    for name in ("total", "l2"):
        assert tr.history[name].shape == (max_iter,)
        np.testing.assert_allclose(tr.history[name], np.asarray(jr.history[name]),
                                   rtol=1e-4, atol=1e-6)
    assert tr.best_epoch == jr.best_epoch
    np.testing.assert_allclose(tr.best_metric, jr.best_metric, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tr.best_params[0][0].numpy(), np.asarray(jr.best_params[0][0]),
                               rtol=1e-4, atol=1e-5)
    it = tr.timing["iterations"]
    if max_iter == 8:
        assert it == max_iter
    else:
        assert it < max_iter
        tail_t, tail_m = tr.history["total"][it:], tr.history["l2"][it:]
        assert np.all(tail_t == tail_t[0]) and np.all(tail_m == tail_m[0])
        assert tr.best_epoch <= it


def test_port_does_not_use_torch_optim_lbfgs():
    root = pathlib.Path(__file__).resolve().parents[1]
    hits = [str(p) for p in (root / "nnpde_tpu_torch").rglob("*.py")
            if "optim.LBFGS" in p.read_text() and p.name != "lbfgs.py"]
    assert hits == []
    src = (root / "nnpde_tpu_torch" / "train" / "lbfgs.py").read_text()
    assert "torch.optim.LBFGS(" not in src
