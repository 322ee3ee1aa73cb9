"""The WAN slice of the port as a whole: the minimax trainer, its optimizer
pair, the WAN losses, and short CPU trainings of the 2D Poisson WAN.

* ``fit_wan`` against the JAX ``fit_wan``: 5 epochs x 2 critic steps in
  each minimax mode, from the same transferred u and critic params, with
  the loss closures built on one fixed point set on both sides (the two
  packages' random streams differ).  Tolerance: the ``total``, ``l2`` and
  ``wan_loss_v`` histories rel <= 1e-4 (float32 on both sides).
* ``make_wan_optimizers`` against optax: the critic's horizon and five
  Adam updates of each net, rel <= 1e-6 (float64).
* ``wan_weak_residual``, ``wan_pde_loss`` and ``norm_nontrivial`` against
  the JAX zoo, rel <= 1e-12 (float64).
* ``make_fused_wan_pair`` against the JAX pair (its exact XLA jets; the
  port's kernel route, plain on the CPU): each objective, its parameter
  gradients and dE, rel <= 1e-5.
* ``train_poisson_nd(method="WAN")`` on the CPU: the fused path (plain
  versions here) against the autograd path from the same seed, the first
  total within 1e-4 and the first 12 within 5e-2 (the band of the JAX
  package's own fused-vs-XLA test), all finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnpde_tpu.losses import norm_nontrivial as j_norm_nontrivial
from nnpde_tpu.losses import wan_pde_loss as j_wan_pde_loss
from nnpde_tpu.losses import wan_weak_residual as j_wan_weak_residual
from nnpde_tpu.models import NetSpec as JNetSpec
from nnpde_tpu.models import SolutionModel as JSolutionModel
from nnpde_tpu.models import factor_for_technique as j_factor
from nnpde_tpu.ops import bump_w as j_bump_w
from nnpde_tpu.pde import poisson as jphys
from nnpde_tpu.train import fit_wan as j_fit_wan
from nnpde_tpu.train import make_optimizer as j_make_optimizer
from nnpde_tpu.train.optim import make_wan_optimizers as j_make_wan_optimizers
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.losses import norm_nontrivial, wan_pde_loss, wan_weak_residual
from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
from nnpde_tpu_torch.ops import bump_w
from nnpde_tpu_torch.pde import poisson as phys
from nnpde_tpu_torch.problems import PoissonConfig, train_poisson_nd
from nnpde_tpu_torch.train import fit_wan, make_optimizer, make_wan_optimizers

L = 2.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _wan_closures(api, u_model, v_model, X, X_ev):
    """The Poisson WAN objectives on fixed points, for either package:
    ``api`` holds its (bump_w, weak residual, pde loss, rhs, exact, mean,
    sum, log, sqrt)."""
    bump, weak_fn, pde_fn, rhs, exact, mean, sum_, log, sqrt = api
    f = rhs(X, L, (1, 1))
    wv, dwv = bump(X, 0.0, L)

    def core(u_params, v_params):
        _, gu = u_model.value_and_grad(u_params, X)
        v, gv = v_model.value_and_grad(v_params, X)
        phi = wv * v
        gphi = dwv * v[:, None] + wv[:, None] * gv
        weak = weak_fn(gu, phi, gphi, f=f, prefactor=1.0)
        return pde_fn(weak, mean(phi ** 2)), v, gv

    def u_loss(u_params, v_params, key):
        loss, _, _ = core(u_params, v_params)
        return loss, {"pde": loss}

    def v_loss(v_params, u_params, key):
        loss, v, gv = core(u_params, v_params)
        return -log(loss + 1e-8) + mean(sum_(gv * gv, -1) + v * v)

    def eval_fn(u_params, key):
        return sqrt(mean((u_model.apply_batch(u_params, X_ev) - exact(X_ev, L, (1, 1))) ** 2))

    return u_loss, v_loss, eval_fn


@pytest.mark.parametrize("minimax,u_ema", [("alternating", 0.0),
                                           ("extragradient", 0.9),
                                           ("optimistic", 0.0)])
def test_fit_wan_matches_jax(minimax, u_ema):
    d, epochs = 2, 5
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, L, (128, d)).astype(np.float32)
    X_ev = rng.uniform(0.0, L, (64, d)).astype(np.float32)
    ju = JSolutionModel(JNetSpec((d, 16, 16, 1), activation="sin"),
                        j_factor("FBC", dim=d, kind="box", L=L))
    jv = JSolutionModel(JNetSpec((d, 12, 12, 1), activation="sin"))
    jup, jvp = ju.init(jax.random.PRNGKey(1)), jv.init(jax.random.PRNGKey(2))
    j_api = (j_bump_w, j_wan_weak_residual, j_wan_pde_loss, jphys.rhs_f_for_u_sin,
             jphys.exact_u_prod_sin, jnp.mean, lambda a, ax: jnp.sum(a, axis=ax),
             jnp.log, jnp.sqrt)
    jl = _wan_closures(j_api, ju, jv, jnp.asarray(X), jnp.asarray(X_ev))
    jr = j_fit_wan(*jl, jup, jvp, epochs=epochs, v_steps=2,
                   u_optimizer=j_make_optimizer(1e-3), v_optimizer=j_make_optimizer(1e-3),
                   key=jax.random.PRNGKey(3), chunk=epochs, minimax=minimax, u_ema=u_ema)

    tu = SolutionModel(NetSpec((d, 16, 16, 1), activation="sin"),
                       factor_for_technique("FBC", dim=d, kind="box", L=L))
    tv = SolutionModel(NetSpec((d, 12, 12, 1), activation="sin"))
    t_api = (bump_w, wan_weak_residual, wan_pde_loss, phys.rhs_f_for_u_sin,
             phys.exact_u_prod_sin, torch.mean, lambda a, ax: torch.sum(a, dim=ax),
             torch.log, torch.sqrt)
    tl = _wan_closures(t_api, tu, tv, torch.as_tensor(X), torch.as_tensor(X_ev))
    to_np = lambda p: [(np.array(W), np.array(b)) for W, b in p]
    tr = fit_wan(*tl, params_from_jax(to_np(jup)), params_from_jax(to_np(jvp)),
                 epochs=epochs, v_steps=2, u_optimizer=make_optimizer(1e-3),
                 v_optimizer=make_optimizer(1e-3), key=3, chunk=2, minimax=minimax,
                 u_ema=u_ema)
    for name in ("total", "l2", "wan_loss_v"):
        assert tr.history[name].shape == (epochs,)
        assert _rel(tr.history[name], jr.history[name]) <= 1e-4, name
    if u_ema > 0:
        assert _rel(tr.history["l2_ema"], jr.history["l2_ema"]) <= 1e-4
    assert tr.best_epoch == jr.best_epoch
    got = np.concatenate([np.ravel(t.numpy()) for pair in tr.v_params for t in pair])
    want = np.concatenate([np.ravel(np.asarray(t)) for pair in jr.v_params for t in pair])
    assert _rel(got, want) <= 1e-4


def test_fit_wan_resume_matches_one_run():
    """init_carry/start_epoch continue a WAN run exactly."""
    torch.manual_seed(0)
    u0 = [(torch.randn(1, 4), torch.zeros(4)), (torch.randn(4, 1), torch.zeros(1))]
    v0 = [(torch.randn(1, 4), torch.zeros(4)), (torch.randn(4, 1), torch.zeros(1))]
    X = torch.linspace(-1, 1, 32)[:, None]

    def net(p, X):
        return (torch.tanh(X @ p[0][0] + p[0][1]) @ p[1][0] + p[1][1])[:, 0]

    def u_loss(u, v, key):
        loss = torch.mean(net(u, X) * net(v, X)) + torch.mean(net(u, X) ** 2)
        return loss, {}

    def v_loss(v, u, key):
        return -torch.mean(net(u, X) * net(v, X)) + 0.1 * torch.mean(net(v, X) ** 2)

    def eval_fn(u, key):
        return torch.mean(net(u, X) ** 2)

    kw = dict(v_steps=2, u_optimizer=make_optimizer(1e-2), v_optimizer=make_optimizer(1e-2),
              key=5, minimax="optimistic")
    full = fit_wan(u_loss, v_loss, eval_fn, u0, v0, epochs=8, **kw)
    a = fit_wan(u_loss, v_loss, eval_fn, u0, v0, epochs=5, **kw)
    b = fit_wan(u_loss, v_loss, eval_fn, u0, v0, epochs=3, init_carry=a.carry,
                start_epoch=5, **kw)
    assert np.array_equal(np.concatenate([a.history["total"], b.history["total"]]),
                          full.history["total"])
    for (W1, b1), (W2, b2) in zip(full.v_params, b.v_params):
        assert torch.equal(W1, W2) and torch.equal(b1, b2)


def test_make_wan_optimizers_match_optax():
    kw = dict(v_lr=3e-2, schedule="cosine", epochs=6, v_steps=5, decay_steps=4,
              final_scale=0.05)
    rng = np.random.default_rng(1)
    p0 = [rng.normal(size=(3, 4)), rng.normal(size=(4,))]
    gs = [[rng.normal(size=(3, 4)), rng.normal(size=(4,))] for _ in range(5)]
    with jax.enable_x64(True):
        opts_j = j_make_wan_optimizers(1e-2, **kw)
        want = []
        for opt_j in opts_j:
            params_j = [jnp.asarray(p) for p in p0]
            state = opt_j.init(params_j)
            for g in gs:
                upd, state = opt_j.update([jnp.asarray(x) for x in g], state, params_j)
                params_j = optax.apply_updates(params_j, upd)
            want.append([np.asarray(p) for p in params_j])
    for opt_t, ref in zip(make_wan_optimizers(1e-2, **kw), want):
        params_t = [torch.tensor(p, dtype=torch.float64) for p in p0]
        adam = opt_t.init(params_t)
        for count, g in enumerate(gs):
            for t, gi in zip(params_t, g):
                t.grad = torch.tensor(gi)
            opt_t.set_lr(adam, count)
            adam.step()
        for got, r, start in zip(params_t, ref, p0):
            assert _rel(got.numpy() - start, r - start) <= 1e-6
    u_opt, v_opt = make_wan_optimizers(1e-2, **kw)
    assert u_opt.schedule(4) == u_opt.schedule(100)          # u horizon: decay_steps
    assert v_opt.schedule(19) > v_opt.schedule(20) == v_opt.schedule(100)


def test_wan_losses_match_jax():
    rng = np.random.default_rng(2)
    N, d = 64, 3
    gu, gphi = rng.normal(size=(N, d)), rng.normal(size=(N, d))
    u, phi, V = rng.normal(size=N), rng.normal(size=N), rng.normal(size=N)
    f = rng.normal(size=N)
    with jax.enable_x64(True):
        wj = j_wan_weak_residual(jnp.asarray(gu), jnp.asarray(phi), jnp.asarray(gphi),
                                 jnp.asarray(u), V=jnp.asarray(V), E=1.3, f=jnp.asarray(f))
        want = [float(wj)] + [float(j_wan_pde_loss(wj, 0.7, convention=c))
                              for c in ("wr2_over_norm", "ratio_sq")]
        want.append(float(j_norm_nontrivial(jnp.asarray(u))))
    t = torch.as_tensor
    wt = wan_weak_residual(t(gu), t(phi), t(gphi), t(u), V=t(V), E=1.3, f=t(f))
    got = [float(wt)] + [float(wan_pde_loss(wt, 0.7, convention=c))
                         for c in ("wr2_over_norm", "ratio_sq")]
    got.append(float(norm_nontrivial(t(u))))
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("side", ["u", "v"])
def test_fused_wan_pair_matches_jax(side):
    """``make_fused_wan_pair`` (the frozen net's jet through the port's
    kernel route, the JAX side's exact XLA jet) on one point set: the
    objective, its parameter gradients and, for u, dE; rel <= 1e-5."""
    from nnpde_tpu.problems._fused_wan import make_fused_wan_pair as j_pair
    from nnpde_tpu_torch.problems._fused_wan import make_fused_wan_pair

    d = 2
    rng = np.random.default_rng(7)
    X = rng.uniform(0.0, L, (300, d)).astype(np.float32)
    ju = JSolutionModel(JNetSpec((d, 16, 16, 16, 1), activation="sin"),
                        j_factor("FBC", dim=d, kind="box", L=L))
    jv = JSolutionModel(JNetSpec((d, 12, 12, 1), activation="sin"))
    jup, jvp = ju.init(jax.random.PRNGKey(4)), jv.init(jax.random.PRNGKey(5))
    Xj = jnp.asarray(X)
    wv, dwv = j_bump_w(Xj, 0.0, L)
    f = jphys.rhs_f_for_u_sin(Xj, L, (1, 1))
    jp = j_pair(ju, jv, prefactor=1.0, impl="xla", bwd_tile=128, interpret=True,
                dot_dtype="float32")
    if side == "u":
        (vj, _), (gj, dEj) = jax.value_and_grad(
            lambda p, E: jp.u_pde_fn(p, E, jvp, Xj, wv, dwv, f=f),
            argnums=(0, 1), has_aux=True)(jup, jnp.asarray(0.3))
    else:
        (vj, _), gj = jax.value_and_grad(
            lambda p: jp.v_loss_fn(p, jup, jnp.asarray(0.3), Xj, wv, dwv, f=f),
            has_aux=True)(jvp)

    tu = SolutionModel(NetSpec((d, 16, 16, 16, 1), activation="sin"),
                       factor_for_technique("FBC", dim=d, kind="box", L=L))
    tv = SolutionModel(NetSpec((d, 12, 12, 1), activation="sin"))
    to_np = lambda p: [(np.array(W), np.array(b)) for W, b in p]
    tup, tvp = params_from_jax(to_np(jup)), params_from_jax(to_np(jvp))
    Xt = torch.as_tensor(X)
    twv, tdwv = bump_w(Xt, 0.0, L)
    tf = phys.rhs_f_for_u_sin(Xt, L, (1, 1))
    tp = make_fused_wan_pair(tu, tv, prefactor=1.0)
    E = torch.tensor(0.3, requires_grad=True)
    train = tup if side == "u" else tvp
    for W, b in train:
        W.requires_grad_(True), b.requires_grad_(True)
    if side == "u":
        total, _ = tp.u_pde_fn(tup, E, tvp, Xt, twv, tdwv, f=tf)
    else:
        total, _ = tp.v_loss_fn(tvp, tup, E.detach(), Xt, twv, tdwv, f=tf)
    leaves = [t for pair in train for t in pair]
    g = torch.autograd.grad(total, leaves + ([E] if side == "u" else []))
    assert abs(float(total.detach()) - float(vj)) <= 1e-5 * abs(float(vj))
    got = np.concatenate([np.ravel(t.numpy()) for t in g[:len(leaves)]])
    want = np.concatenate([np.ravel(np.asarray(t)) for pair in gj for t in pair])
    assert _rel(got, want) <= 1e-5
    if side == "u":
        assert abs(float(g[-1]) - float(dEj)) <= 1e-5 * abs(float(dEj))


def test_poisson_wan_fused_matches_torch_on_cpu():
    kw = dict(method="WAN", width=16, depth=3, critic_width=12, critic_steps=2,
              epochs=12, n_interior=256, n_eval=256)
    a = train_poisson_nd(PoissonConfig(jet_impl="torch", **kw), device="cpu")
    b = train_poisson_nd(PoissonConfig(jet_impl="fused", **kw), device="cpu")
    ha, hb = a["history"]["total"], b["history"]["total"]
    assert ha.shape == hb.shape == (12,)
    assert np.all(np.isfinite(ha)) and np.all(np.isfinite(hb))
    assert abs(hb[0] - ha[0]) <= 1e-4 * abs(ha[0])
    assert np.all(np.abs(hb - ha) <= 5e-2 * np.abs(ha))
    assert np.isfinite(b["rel_l2"]) and b["result"].v_params is not None


def test_poisson_wan_minimax_modes_run_on_cpu():
    kw = dict(method="WAN", width=16, depth=3, critic_width=12, critic_steps=2,
              epochs=6, n_interior=128, n_eval=128, jet_impl="fused")
    for minimax in ("extragradient", "optimistic"):
        r = train_poisson_nd(PoissonConfig(minimax=minimax, u_ema=0.9, **kw), device="cpu")
        h = r["history"]
        assert np.all(np.isfinite(h["total"])) and np.all(np.isfinite(h["l2_ema"]))
        assert np.all(np.isfinite(h["wan_loss_v"]))
