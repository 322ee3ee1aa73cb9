"""The port's reduced-precision modes against the JAX package, on the CPU.

* The bf16-dot kernels (``dot_dtype='bfloat16'``; the port's wrappers take
  their plain versions on CPU tensors) against the JAX Pallas kernels in
  interpret mode with ``dot_dtype='bfloat16'``, which honours the cast on the
  CPU: ``fused_linear_residual``, ``fused_poisson_analytic`` and the jet
  backward (``jax.vjp`` of ``mlp_fwdlap_pallas``).  Loss and every gradient
  leaf within 1e-4 norm-relative: the two differ in the order of the float32
  sums and in the rare operand that rounds to the other bf16 neighbour.
* The default-mode jet forward (``fwd_impl='rows:default'``) against
  ``nnpde_tpu.kernels.fwdlap_pallas._fwd_recompute`` with the bf16 cast over
  the whole batch, projected on the last layer's row: every column within
  1e-4.  Not against JAX's ``fwd_impl='pallas2:default'``, whose single-pass
  dots are exact float32 on the CPU.
* The cast is delivered: each bf16-dot result differs from the port's
  float32 result by more than 10x its tolerance (the largest gradient leaf;
  the Laplacian column of the jet).
* The torch route in bf16: the first total of a ``compute_dtype='bfloat16'``
  run against the JAX package's bf16 phase on the same parameters and
  points, for the Poisson PINN, DRM and WAN and the infinite-well PINN, DRM
  and WAN.  XLA and torch round bf16 elementwise results at different
  places, so each case has its own tolerance, set between the measured gap
  to JAX's bf16 total and the distance of the port's float32 total from
  it: a port whose bf16 phase ran in float32 fails the comparison itself.
  Measured (gap / float32 distance): Poisson PINN 1.11e-3 / 2.98e-3, DRM
  2.41e-4 / 1.27e-3, WAN 4.48e-5 / 3.13e-4; infinite well PINN 7.57e-4 /
  3.33e-3, DRM 6.38e-4 / 3.07e-3, WAN 5.17e-3 / 1.19e-2 (the WAN total
  without its data and norm terms, so that the bf16 weak form carries it).
  The Poisson PINN net starts at twice the default weights: at the default
  the float32 right-hand side carries its residual, and JAX's bf16 total
  moved only 6.8e-5 from float32, less than the 2.6e-4 gap.
* The hybrid tail resumes from the full carry (``fit`` and ``fit_wan``), short
  CPU trainings of every ``compute_dtype`` and method, and the options that
  raise as in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnpde_tpu.problems.poisson as j_poisson_mod
from nnpde_tpu.kernels import fused_step as jfs
from nnpde_tpu.kernels import fwdlap_pallas as jfp
from nnpde_tpu.models import factor_for_technique as j_factor
from nnpde_tpu.models.solution import SolutionModel as JSolutionModel
from nnpde_tpu.pde import poisson as jphys
from nnpde_tpu.problems.ipw2d import IPW2DConfig as JIPWConfig
from nnpde_tpu.problems.ipw2d import train_ipw_2d as j_train_ipw
from nnpde_tpu.problems.poisson import PoissonConfig as JPoissonConfig
from nnpde_tpu.problems.poisson import train_poisson_nd as j_train_poisson
import nnpde_tpu_torch.problems.poisson as t_poisson_mod
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import LAUNCHES
from nnpde_tpu_torch.kernels import fused_multibump as tfm
from nnpde_tpu_torch.kernels import fused_quotient as tfq
from nnpde_tpu_torch.kernels import fused_step as tfs
from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc
from nnpde_tpu_torch.models import SolutionModel, factor_for_technique
from nnpde_tpu_torch.ops import fwdlap as tops
from nnpde_tpu_torch.problems import (IPW2DConfig, PoissonConfig, train_ipw_2d,
                                      train_poisson_nd)
from nnpde_tpu_torch.train import fit, fit_wan, make_optimizer, make_wan_optimizers

L = 2.0
TOL = 1e-4
CASES = [(2, "sin"), (3, "sin"), (2, "tanh"), (3, "tanh")]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np_params(rng, layers):
    out = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = 1.0 / np.sqrt(n_in)
        out.append((rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                    rng.uniform(-bound, bound, (n_out,)).astype(np.float32)))
    return out


def _case(d, seed, N=300, width=32):
    """Params, points and the Poisson residual coefficients of the box-FBC
    trial (the coefficients the bf16-dot bulk feeds the kernels)."""
    rng = np.random.default_rng(seed)
    pn = _np_params(rng, (d, width, width, width, 1))
    X = rng.uniform(0.0, L, (N, d)).astype(np.float32)
    fj = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(X))
    f = jphys.rhs_f_for_u_sin(jnp.asarray(X), L, (1,) * d)
    coef = np.asarray(jfs.residual_coefficients(fj, a0=-1.0, rhs=-f))
    return rng, pn, X, coef


def _leaves(loss, grads):
    return [np.asarray(loss, np.float64).reshape(1)] + [
        np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)
        for pair in grads for t in pair]


def _max_rel(a, b):
    return max(_rel(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("d,act", CASES)
def test_bf16_residual_kernels_match_jax_interpret(d, act):
    """Rows 1 and 2: the fused residual, stream and analytic coefficients."""
    _, pn, X, coef = _case(d, seed=40 + d)
    jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in pn]
    tp = params_from_jax(pn)
    Xt, Ct = torch.as_tensor(X), torch.as_tensor(coef)
    ks = (1,) * d
    kw = dict(bwd_tile=128, interpret=True, dot_dtype="bfloat16")
    runs = {
        "linear": (jfs.fused_linear_residual(jp, jnp.asarray(X), jnp.asarray(coef), act, **kw),
                   lambda dot: tfs.fused_linear_residual(tp, Xt, Ct, act, dot_dtype=dot)),
        "analytic": (jfs.fused_poisson_analytic(jp, jnp.asarray(X), act, L=L, ks=ks, **kw),
                     lambda dot: tfs.fused_poisson_analytic(tp, Xt, act, L=L, ks=ks,
                                                            dot_dtype=dot)),
    }
    for name, (jout, port) in runs.items():
        want = _leaves(jout[0], jout[2])
        loss, _, g = port("bfloat16")
        got = _leaves(loss, g)
        assert _max_rel(got, want) <= TOL, name
        loss32, _, g32 = port("float32")
        assert _max_rel(got[1:], _leaves(loss32, g32)[1:]) > 10 * TOL, name


@pytest.mark.parametrize("d,act", CASES)
def test_bf16_jet_backward_matches_jax_interpret(d, act):
    """Row 5: the jet backward from the cotangent a Poisson residual gives
    the raw net's jet, against ``jax.vjp`` of the Pallas jet in bf16-dot
    mode."""
    _, pn, X, coef = _case(d, seed=50 + d)
    jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in pn]
    tp = params_from_jax(pn)
    Xt = torch.as_tensor(X)
    jet = tfc.fwdlap_forward_plain(tp, Xt, act)
    c = torch.as_tensor(coef)
    r = (c[:, 0] * jet.value + torch.sum(c[:, 1:1 + d] * jet.grad, dim=1)
         + c[:, d + 1] * jet.lap + c[:, d + 2])
    ct = (r[:, None] * c[:, :d + 2]).numpy()

    def rows(p):
        j = jfp.mlp_fwdlap_pallas(p, jnp.asarray(X), act, interpret=True,
                                  dot_dtype="bfloat16", tile=128, bwd_tile=128)
        return jnp.concatenate([j.value[:, None], j.grad, j.lap[:, None]], 1)

    _, vjp = jax.vjp(rows, jp)
    (gj,) = vjp(jnp.asarray(ct))
    want = [np.asarray(t) for pair in gj for t in pair]
    dWs, dbs = tfc.fwdlap_backward_plain(tp, Xt, torch.as_tensor(ct), act, "bfloat16")
    got = [t.numpy() for pair in zip(dWs, dbs) for t in pair]
    assert _max_rel(got, want) <= TOL
    dW32, db32 = tfc.fwdlap_backward_plain(tp, Xt, torch.as_tensor(ct), act)
    assert _max_rel(got, [t.numpy() for pair in zip(dW32, db32) for t in pair]) > 10 * TOL


@pytest.mark.parametrize("d,act", CASES)
def test_default_mode_forward_matches_bf16_recompute(d, act):
    """Row 4: the default-mode jet against ``_fwd_recompute`` with the bf16
    cast over the whole batch (T = N), projected on the last layer's row."""
    _, pn, X, _ = _case(d, seed=60 + d)
    N = X.shape[0]
    Ws = [jnp.asarray(W) for W, _ in pn]
    bs = [jnp.asarray(b).reshape(1, -1) for _, b in pn]
    _, _, final = jfp._fwd_recompute(
        d, len(Ws), N, act, True, lambda x: x.astype(jnp.bfloat16),
        jax.lax.Precision.DEFAULT, jnp.asarray(X), Ws[:-1], bs[:-1], False)
    A, Jm, lm = final[4], final[5], final[6]
    row = Ws[-1].reshape(1, -1)
    want = np.concatenate(
        [np.asarray(jnp.sum(A * row, 1) + bs[-1][0, 0])[:, None]]
        + [np.asarray(jnp.sum(j * row, 1))[:, None] for j in Jm]
        + [np.asarray(jnp.sum(lm * row, 1))[:, None]], 1)
    tp = params_from_jax(pn)
    got = tfc.fwdlap_forward_default_plain(tp, torch.as_tensor(X), act).numpy()
    for col in range(d + 2):
        assert _rel(got[:, col], want[:, col]) <= TOL, col
    # the differentiable jet function takes the same forward
    jet = tfc.mlp_fwdlap_kernel(tp, torch.as_tensor(X), act, fwd_impl="rows:default")
    assert np.array_equal(jet.lap.numpy(), got[:, d + 1])
    exact = tfc.fwdlap_forward_plain(tp, torch.as_tensor(X), act)
    assert _rel(got[:, d + 1], exact.lap.numpy()) > 10 * TOL


@pytest.mark.parametrize("fwd_impl", ["rows", "rows:default"])
@pytest.mark.parametrize("dot_dtype", ["float32", "bfloat16"])
def test_jet_switches_are_independent(fwd_impl, dot_dtype):
    """``mlp_fwdlap_kernel``'s two switches, as JAX's ``fwd_impl`` and
    ``dot_dtype``: the forward takes the mode ``fwd_impl`` names whatever
    ``dot_dtype`` is, and the gradient the backward ``dot_dtype`` names
    whatever the forward was (every combination, bitwise on the CPU)."""
    _, pn, X, coef = _case(2, seed=70)
    tp = [(W.requires_grad_(True), b.requires_grad_(True)) for W, b in params_from_jax(pn)]
    Xt = torch.as_tensor(X)
    jet = tfc.mlp_fwdlap_kernel(tp, Xt, "tanh", fwd_impl=fwd_impl, dot_dtype=dot_dtype)
    rows = torch.cat([jet.value[:, None], jet.grad, jet.lap[:, None]], 1)
    if fwd_impl == "rows":
        want = tfc._jet_rows(tfc.fwdlap_forward_plain(tp, Xt, "tanh"))
    else:
        want = tfc.fwdlap_forward_default_plain(tp, Xt, "tanh")
    assert torch.equal(rows.detach(), want.detach())
    ct = torch.as_tensor(coef[:, :4])
    got = torch.autograd.grad(torch.sum(rows * ct), [t for pair in tp for t in pair])
    dWs, dbs = tfc.fwdlap_backward_plain(tp, Xt, ct, "tanh", dot_dtype)
    for a, b in zip(got, [t for pair in zip(dWs, dbs) for t in pair]):
        assert torch.equal(a, b)


def test_plain_sweep_is_autograd_in_the_exact_mode():
    """With the identity cast the written-out recompute and reverse sweep
    are the recurrence and its autograd (float64, 1e-12)."""
    rng = np.random.default_rng(1)
    for layers, act in (((2, 8, 8, 1), "sin"), ((3, 12, 8, 6, 1), "gelu"), ((1, 5, 1), "tanh")):
        tp = params_from_jax(_np_params(rng, layers), dtype=torch.float64)
        d = layers[0]
        X = torch.as_tensor(rng.uniform(0.0, L, (33, d)))
        ct = torch.as_tensor(rng.normal(size=(33, d + 2)))
        want = tfc.fwdlap_backward_plain(tp, X, ct, act)
        saved, final = tops.recompute_plain(tp, X, act, lambda x: x)
        got = tops.reverse_plain(tp, X, lambda x: x, saved, final, ct)
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)
        jet = tfc.fwdlap_forward_plain(tp, X, act)
        value, grad, lap = tops.project_plain(tp, final)
        assert torch.allclose(value, jet.value) and torch.allclose(grad, jet.grad)
        assert torch.allclose(lap, jet.lap)


# ------------------------------------------------------ torch route in bf16
def _patch_inits(monkeypatch, params_by_layers, X):
    """Both packages' entry points start from the same nets and points:
    ``SolutionModel.init`` returns the given params for its layer sizes and
    the uniform sampler returns the first n of the given points."""

    def j_init(self, key, *a, **k):
        return [(jnp.asarray(W), jnp.asarray(b))
                for W, b in params_by_layers[tuple(self.spec.layers)]]

    def t_init(self, key, dtype=torch.float32, device=None):
        return params_from_jax(params_by_layers[tuple(self.spec.layers)])

    monkeypatch.setattr(JSolutionModel, "init", j_init)
    monkeypatch.setattr(SolutionModel, "init", t_init)
    monkeypatch.setattr(j_poisson_mod, "uniform_box", lambda key, n, box: jnp.asarray(X[:n]))
    monkeypatch.setattr(t_poisson_mod, "uniform_box",
                        lambda gen, n, box: torch.as_tensor(X[:n]).to(gen.device))


def _assert_bf16_total(got, want, got32, tol):
    """The port's bf16 first total within ``tol`` of JAX's, and its float32
    first total further than ``tol`` from it."""
    assert abs(got - want) <= tol * abs(want)
    assert abs(got32 - want) > tol * abs(want)


# method: (scale of the initial weights, tolerance)
POISSON_TOTALS = {"PINN": (2.0, 2e-3), "DRM": (1.0, 5e-4), "WAN": (1.0, 1.2e-4)}


@pytest.mark.parametrize("method", ["PINN", "DRM", "WAN"])
def test_poisson_bf16_first_total_matches_jax(monkeypatch, method):
    scale, tol = POISSON_TOTALS[method]
    rng = np.random.default_rng(5)
    kw = dict(dim=2, method=method, width=16, depth=3, critic_width=12, critic_steps=1,
              epochs=1, chunk=1, n_interior=256, n_eval=256, compute_dtype="bfloat16")
    nets = {(2, 16, 16, 1): [(scale * W, b) for W, b in _np_params(rng, (2, 16, 16, 1))],
            (2, 12, 12, 1): _np_params(rng, (2, 12, 12, 1))}
    X = rng.uniform(0.0, L, (256, 2)).astype(np.float32)
    _patch_inits(monkeypatch, nets, X)
    j = j_train_poisson(JPoissonConfig(**kw))
    t = train_poisson_nd(PoissonConfig(**kw), device="cpu")
    t32 = train_poisson_nd(PoissonConfig(**dict(kw, compute_dtype="float32")), device="cpu")
    _assert_bf16_total(float(t["history"]["total"][0]), float(np.asarray(j["history"]["total"])[0]),
                       float(t32["history"]["total"][0]), tol)


IPW = dict(nx=2, ny=2, technique="FN", layers=(2, 16, 16, 1), v_layers=(2, 12, 12, 1),
           v_steps=1, grid_n=12, data_grid_n=8, n_boundary=12, epochs=1, chunk=1, seed=0,
           compute_dtype="bfloat16")


IPW_TOTALS = {"PINN": 1.5e-3, "DRM": 1.5e-3, "WAN": 8e-3}   # method: tolerance


@pytest.mark.parametrize("extra", [
    dict(method="PINN"), dict(method="DRM"),
    dict(method="WAN", n_test_grid=1, weights={"data": 0.0, "norm": 0.0})])
def test_ipw2d_bf16_first_total_matches_jax(extra):
    tol = IPW_TOTALS[extra["method"]]
    rng = np.random.default_rng(6)
    u0, v0 = _np_params(rng, IPW["layers"]), _np_params(rng, IPW["v_layers"])
    kw = dict(IPW, **extra)
    j = j_train_ipw(JIPWConfig(**kw), init_params=[(jnp.asarray(W), jnp.asarray(b)) for W, b in u0],
                    init_v_params=[(jnp.asarray(W), jnp.asarray(b)) for W, b in v0])
    t = train_ipw_2d(IPW2DConfig(**kw), init_params=params_from_jax(u0),
                     init_v_params=params_from_jax(v0), device="cpu")
    t32 = train_ipw_2d(IPW2DConfig(**dict(kw, compute_dtype="float32")),
                       init_params=params_from_jax(u0), init_v_params=params_from_jax(v0),
                       device="cpu")
    _assert_bf16_total(float(t["history"]["total"][0]), float(np.asarray(j["history"]["total"])[0]),
                       float(t32["history"]["total"][0]), tol)


# ------------------------------------------------- the phase switch's carry
def test_hybrid_carries_optimizer_state():
    """Port of the JAX package's test: a tail resumed from the first
    phase's carry continues the cosine schedule and the Adam moments, so it
    equals the second half of one continuous run."""
    params = [(torch.tensor([[1.0, -2.0]]), torch.tensor([0.5, 0.25]))]

    def loss_fn(p, k):
        return sum(torch.sum(t ** 2) for pair in p for t in pair), {}

    def eval_fn(p, k):
        return sum(torch.sum(t ** 2) for pair in p for t in pair)

    opt = make_optimizer(1e-1, schedule="cosine", total_steps=40)
    r1 = fit(loss_fn, eval_fn, params, epochs=20, optimizer=opt, key=0, chunk=10)
    r2 = fit(loss_fn, eval_fn, params, epochs=20, optimizer=opt, key=0, chunk=10,
             init_carry=r1.carry, start_epoch=20)
    full = fit(loss_fn, eval_fn, params, epochs=40, optimizer=opt, key=0, chunk=10)
    for (W1, b1), (W2, b2) in zip(r2.params, full.params):
        np.testing.assert_allclose(W1.numpy(), W2.numpy(), rtol=1e-6)
        np.testing.assert_allclose(b1.numpy(), b2.numpy(), rtol=1e-6)
    assert r2.best_epoch == full.best_epoch


@pytest.mark.parametrize("minimax,u_ema", [("alternating", 0.9), ("optimistic", 0.5),
                                           ("extragradient", 0.0)])
def test_hybrid_wan_carries_full_state(minimax, u_ema):
    """``fit_wan`` resumed from a carry (both optimizers, the best iterate,
    the EMA, the OGDA gradients) equals one continuous run."""
    u0 = [(torch.tensor([[1.0, -2.0], [0.3, 0.7]]), torch.tensor([0.5, -0.25]))]
    v0 = [(torch.tensor([[0.2, 0.1], [-0.4, 0.6]]), torch.tensor([0.1, 0.3]))]

    def flat(p):
        return torch.cat([t.reshape(-1) for pair in p for t in pair])

    def u_loss_fn(u, v, k):
        g = torch.Generator().manual_seed(int(k) % (2 ** 31))
        shift = torch.rand((), generator=g)
        du = flat(u) - shift
        return torch.sum(du * du) + torch.sum(du * flat(v)), {}

    def v_loss_fn(v, u, k):
        return -torch.sum((flat(u) - 0.3) * flat(v)) + 0.5 * torch.sum(flat(v) ** 2)

    def eval_fn(u, k):
        return torch.sum(flat(u) ** 2)

    def opts():
        return make_wan_optimizers(5e-2, v_lr=3e-2, schedule="cosine", epochs=30, v_steps=3)

    kw = dict(v_steps=3, key=4, chunk=7, minimax=minimax, u_ema=u_ema)
    uo, vo = opts()
    r1 = fit_wan(u_loss_fn, v_loss_fn, eval_fn, u0, v0, epochs=18, u_optimizer=uo,
                 v_optimizer=vo, **kw)
    r2 = fit_wan(u_loss_fn, v_loss_fn, eval_fn, u0, v0, epochs=12, u_optimizer=uo,
                 v_optimizer=vo, init_carry=r1.carry, start_epoch=18, **kw)
    uo, vo = opts()
    full = fit_wan(u_loss_fn, v_loss_fn, eval_fn, u0, v0, epochs=30, u_optimizer=uo,
                   v_optimizer=vo, **kw)
    for a, b in ((r2.params, full.params), (r2.v_params, full.v_params),
                 (r2.best_params, full.best_params)):
        np.testing.assert_allclose(flat(a).numpy(), flat(b).numpy(), rtol=1e-6)
    for key in full.history:
        np.testing.assert_allclose(np.concatenate([r1.history[key], r2.history[key]]),
                                   full.history[key], rtol=1e-6)
    assert r2.best_epoch == full.best_epoch


def test_hybrid_tail_equals_float32_run_resumed_from_the_bulk_carry(monkeypatch):
    """``train_poisson_nd(compute_dtype='hybrid')``: its float32 tail equals
    a pure float32 ``fit`` resumed from a copy of the bf16 bulk's carry
    (Adam moments, the cosine schedule's step and the running best carry
    over; nothing is reset at the switch)."""
    import copy

    import nnpde_tpu_torch.train.trainer as trainer_mod

    calls = []
    real_fit = trainer_mod.fit

    def spy(*a, **k):
        snap = copy.deepcopy(k["init_carry"]) if k.get("init_carry") is not None else None
        out = real_fit(*a, **k)
        calls.append((a, k, snap, out))
        return out

    monkeypatch.setattr(t_poisson_mod, "fit", spy)
    cfg = PoissonConfig(dim=1, width=16, depth=3, epochs=40, chunk=10, n_interior=128,
                        n_eval=128, compute_dtype="hybrid", hybrid_bf16_fraction=0.5,
                        lr_schedule="cosine")
    out = train_poisson_nd(cfg, device="cpu")
    (_, kb, _, bulk), (a, kt, snap, tail) = calls
    assert kb["epochs"] == 20 and kt["start_epoch"] == 20 and kt["init_carry"] is bulk.carry
    assert snap.count == 20 and tail.carry.count == 40
    again = real_fit(*a, **dict(kt, init_carry=snap))
    assert np.array_equal(again.history["total"], tail.history["total"])
    for (W1, b1), (W2, b2) in zip(again.params, tail.params):
        assert torch.equal(W1, W2) and torch.equal(b1, b2)
    assert out["history"]["total"].shape == (40,)
    assert np.array_equal(out["history"]["total"][:20], bulk.history["total"])
    assert np.array_equal(out["history"]["total"][20:], tail.history["total"])


# ------------------------------------------------------ short CPU trainings
POISSON = dict(dim=1, width=16, depth=3, epochs=120, chunk=60, n_interior=256, n_eval=256,
               lr=2e-3, hybrid_bf16_fraction=0.5)


@pytest.mark.parametrize("method,dtype,jet_impl", [
    ("PINN", "bfloat16", "torch"), ("PINN", "hybrid", "torch"), ("PINN", "hybrid", "fused"),
    ("PINN", "hybrid-kernel", "kernel"), ("PINN", "hybrid-kernel", "fused"),
    ("DRM", "bfloat16", "torch"), ("DRM", "hybrid", "fused"),
    ("WAN", "bfloat16", "torch"), ("WAN", "hybrid", "fused"),
])
def test_poisson_precision_modes_train_on_cpu(method, dtype, jet_impl):
    kw = dict(POISSON, method=method, compute_dtype=dtype, jet_impl=jet_impl,
              resample=method == "DRM")
    if method == "WAN":
        kw.update(epochs=24, chunk=12, critic_width=12, critic_steps=2)
    before = dict(LAUNCHES)
    out = train_poisson_nd(PoissonConfig(**kw), device="cpu")
    h = out["history"]
    assert h["total"].shape == (kw["epochs"],) and h["l2"].shape == (kw["epochs"],)
    assert np.all(np.isfinite(h["total"])) and np.all(np.isfinite(h["l2"]))
    k = kw["epochs"] // 6
    assert h["total"][-k:].mean() < h["total"][:k].mean()
    assert dict(LAUNCHES) == before        # CPU tensors launch nothing


@pytest.mark.parametrize("method,dtype,jet_impl", [
    ("PINN", "bfloat16", "torch"), ("PINN", "hybrid", "fused"), ("PINN", "hybrid", "kernel"),
    ("DRM", "bfloat16", "fused"), ("DRM", "hybrid", "fused"),
    ("WAN", "bfloat16", "torch"), ("WAN", "hybrid", "fused"),
])
def test_ipw2d_precision_modes_train_on_cpu(method, dtype, jet_impl):
    kw = dict(IPW, method=method, compute_dtype=dtype, jet_impl=jet_impl, epochs=16,
              chunk=8, hybrid_bf16_fraction=0.5, v_steps=2, n_test_grid=2)
    if method == "PINN":
        kw["weights"] = {"data": 1e4}
    out = train_ipw_2d(IPW2DConfig(**kw), device="cpu")
    h = out["history"]
    assert h["total"].shape == (16,) and np.all(np.isfinite(h["total"]))
    assert np.all(np.isfinite(h["l2"]))
    assert h["total"][-3:].mean() < h["total"][:3].mean()


def test_hybrid_kernel_routes_agree_on_cpu():
    """``hybrid-kernel`` on the jet pair and on the fused kernel compute the
    same bf16-dot objective (plain versions here): histories within 1e-4;
    the bulk's first total differs from the float32 run's."""
    kw = dict(dim=2, width=16, depth=3, epochs=30, chunk=30, n_interior=256, n_eval=256)
    a = train_poisson_nd(PoissonConfig(jet_impl="kernel", compute_dtype="hybrid-kernel",
                                       **kw), device="cpu")
    b = train_poisson_nd(PoissonConfig(jet_impl="fused", compute_dtype="hybrid-kernel",
                                       **kw), device="cpu")
    c = train_poisson_nd(PoissonConfig(jet_impl="fused", **kw), device="cpu")
    assert _rel(b["history"]["total"], a["history"]["total"]) <= 1e-4
    t0, t32 = b["history"]["total"][0], c["history"]["total"][0]
    assert 1e-6 < abs(t0 - t32) / abs(t32) <= 1e-2


# --------------------------------------------------------- what still raises
@pytest.mark.parametrize("kw", [
    dict(method="DRM", jet_impl="fused"), dict(method="WAN", jet_impl="fused"),
    dict(method="PINN", jet_impl="torch"),
])
def test_hybrid_kernel_validates_as_jax(kw):
    with pytest.raises(ValueError, match="hybrid-kernel"):
        train_poisson_nd(PoissonConfig(epochs=1, compute_dtype="hybrid-kernel", **kw),
                         device="cpu")
    with pytest.raises(ValueError, match="hybrid-kernel"):
        j_train_poisson(JPoissonConfig(epochs=1, compute_dtype="hybrid-kernel",
                                       **dict(kw, jet_impl={"fused": "pallas-fused",
                                                            "torch": "xla"}[kw["jet_impl"]])))


def test_ipw2d_segmented_hybrid_raises_as_jax():
    kw = dict(IPW, compute_dtype="hybrid", epochs=4)
    for run in (lambda c: train_ipw_2d(IPW2DConfig(**c), start_epoch=2, device="cpu"),
                lambda c: j_train_ipw(JIPWConfig(**c), start_epoch=2)):
        with pytest.raises(ValueError, match="segmented"):
            run(kw)


def test_unported_dot_modes_raise_naming_the_roadmap():
    rng = np.random.default_rng(2)
    tp = params_from_jax(_np_params(rng, (2, 8, 8, 1)))
    X = torch.rand(16, 2)
    with pytest.raises(ValueError, match="streams:default"):
        tfc.mlp_fwdlap_kernel(tp, X, "sin", fwd_impl="streams:default")
    with pytest.raises(NotImplementedError, match="B1"):
        tfs.fused_drm_energy(tp, X, torch.zeros(16, 4), "sin", dot_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="B1"):
        tfs.fused_linear_residual(tp, X, torch.zeros(16, 6), "sin", dot_dtype="bf16x3")
    with pytest.raises(NotImplementedError, match="B1"):
        tfq.fused_quad_sums(tp, X, torch.zeros(16, 5), "sin", dot_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="B1"):
        tfm.fused_multi_sums(tp, X, torch.zeros(16, 6), "sin", 1, dot_dtype="bfloat16")
    with pytest.raises(ValueError, match="dot_dtype"):
        tfs.fused_linear_residual(tp, X, torch.zeros(16, 6), "sin", dot_dtype="fp8")
