"""Hidden widths above 128 on the CPU: the bf16-dot rows (1, 2, 4, 5) and
the K-bump pair (rows 11, 12) of the port against the JAX package at width
136, the entry points that reach them there, and the wrappers' width limit.

On the card these widths run the tensor-core design's device tiers and the
K-bump pair's ``DEV_WEIGHTS`` tier (``chip_smoke.py wide``,
``tests/test_torch_cuda.py``); here the wrappers take their plain versions
(CPU tensors), and the JAX side runs its Pallas kernels in interpret mode as
``tests/test_torch_precision.py`` and ``tests/test_torch_fused_multibump.py``
run them at widths 32 and 16.  Nets (d, 136, 136, 1), numpy inputs from a
seed, N <= 128.  Tolerances:

* rows 1, 2 and 5 bf16 against the JAX kernels with
  ``dot_dtype='bfloat16'``: loss and every gradient leaf within 1e-4
  norm-relative (the two differ in the order of the float32 sums and in the
  rare operand that rounds to the other bf16 neighbour); row 4 bf16 (the
  default-mode forward) against ``_fwd_recompute`` with the bf16 cast over
  the batch, projected on the last row (JAX's ``pallas2:default`` dots are
  exact float32 on the CPU): every column within 1e-4; each bf16-dot result
  more than 10x its tolerance from the port's float32 one;
* rows 11 and 12 (4 bumps): the sums rel <= 1e-5 with the atol floor of
  1e-6 of the terms' magnitudes, the gradient leaves rel <= 1e-5;
* ``train_poisson_nd(compute_dtype='hybrid-kernel')`` on 'fused' and
  'kernel' (5 epochs: 4 bf16-dot, 1 float32) against JAX's 'pallas-fused'
  run from the same nets and points (JAX's 'pallas' bulk forward is exact
  float32 on the CPU, so both port routes are held to its fused one): the
  first total within 2e-3 (``test_poisson_bf16_first_total_matches_jax``'s
  PINN tolerance), the history within 5e-2, the first total 1e-6 to 1e-2
  from the port's float32 run's;
* ``train_ipw_2d`` WAN with 4 bumps on 'fused' at width 136 (u and critic)
  against JAX's 'xla' run: ``test_train_ipw_2d_matches_jax``'s bars.

Cost on the CPU: about 30 s in all, one worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnpde_tpu.problems.poisson as j_poisson_mod
from nnpde_tpu.kernels import fused_multibump as jmb
from nnpde_tpu.kernels import fused_step as jfs
from nnpde_tpu.kernels import fwdlap_pallas as jfp
from nnpde_tpu.models import NetSpec as JNetSpec
from nnpde_tpu.models import SolutionModel as JSolutionModel
from nnpde_tpu.models import factor_for_technique as j_factor
from nnpde_tpu.pde import poisson as jphys
from nnpde_tpu.problems.ipw2d import IPW2DConfig as JIPWConfig
from nnpde_tpu.problems.ipw2d import train_ipw_2d as j_train_ipw
from nnpde_tpu.problems.poisson import PoissonConfig as JPoissonConfig
from nnpde_tpu.problems.poisson import train_poisson_nd as j_train_poisson
import nnpde_tpu_torch.problems.poisson as t_poisson_mod
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import _cuda
from nnpde_tpu_torch.kernels import fused_multibump as tfm
from nnpde_tpu_torch.kernels import fused_step as tfs
from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc
from nnpde_tpu_torch.kernels.fused_multibump import _multi_terms
from nnpde_tpu_torch.models import SolutionModel
from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap
from nnpde_tpu_torch.problems import (IPW2DConfig, PoissonConfig, train_ipw_2d,
                                      train_poisson_nd)

L = 2.0
W = 136
TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _max_rel(a, b):
    return max(_rel(x, y) for x, y in zip(a, b))


def _np_params(rng, layers):
    out = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = 1.0 / np.sqrt(n_in)
        out.append((rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                    rng.uniform(-bound, bound, (n_out,)).astype(np.float32)))
    return out


def _case(d, seed, N=96):
    """Params of (d, 136, 136, 1), points and the Poisson residual
    coefficients of the box-FBC trial."""
    rng = np.random.default_rng(seed)
    pn = _np_params(rng, (d, W, W, 1))
    X = rng.uniform(0.0, L, (N, d)).astype(np.float32)
    fj = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(X))
    f = jphys.rhs_f_for_u_sin(jnp.asarray(X), L, (1,) * d)
    coef = np.asarray(jfs.residual_coefficients(fj, a0=-1.0, rhs=-f))
    return rng, pn, X, coef


def _leaves(loss, grads):
    return [np.asarray(loss, np.float64).reshape(1)] + [
        np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)
        for pair in grads for t in pair]


# ------------------------------------------------------ the wrapper's limit
@pytest.mark.parametrize("name", sorted(_cuda.LAUNCHES))
def test_widths_to_256_pass_every_kernels_check(name):
    """Every kernel's wrapper check (``_cuda.check_net``) takes hidden
    widths 129-256, ragged or not, in any layer, and follows the kernel's
    ``_cuda.LIMITS`` entry beyond: every fp32 kernel
    (``_cuda.BEYOND_KERNELS``: the fused kernels, the jet pair in both
    layouts, the quotient pair and the K-bump pair) and the bf16-dot modes
    of rows 1-5 (``_cuda.BEYOND_BF16``) take widths 257 and 1001, 24 weight
    matrices and d = 20 (what no tile fits raises in their plans), but the
    jet forward's bf16-dot mode, which raises on d = 20 naming the JAX
    kernel's own limit; the bf16-dot modes of rows 7-12 raise on each,
    naming the kernel and the roadmap item of such nets."""
    for w in (129, 136, 200, 255, 256):
        _cuda.check_net(name, (2, w, 1))
        _cuda.check_net(name, (3, 64, w, w, 1))
    beyond = ((2, 257, 1), (1, 256, 257, 1), (1, 1001, 300, 1), (2,) + (32,) * 23 + (1,),
              (20, 16, 16, 1))
    lim = _cuda.LIMITS[name]
    if name in _cuda.BEYOND_KERNELS + _cuda.BEYOND_BF16:
        fwd = name == "fwdlap_forward.bf16"
        assert lim == ((4096, 64, 16) if fwd else (4096, 64, 64))
        for layers in beyond[:4] + (() if fwd else beyond[4:]):
            _cuda.check_net(name, layers)
        if fwd:
            with pytest.raises(ValueError, match=f"{name}: the kernel takes d from 1 to 16 "
                                                 r"\(the JAX package's _forward_kernel2, .* "
                                                 r"takes d <= 6\)"):
                _cuda.check_net(name, beyond[4])
        return
    assert lim == (256, 16, 16)
    for layers in beyond[:3]:
        with pytest.raises(ValueError, match=f"{name}: the kernel takes hidden widths from 1 "
                                             r"to 256 \(wider nets: ROADMAP.md B7\)"):
            _cuda.check_net(name, layers)
    with pytest.raises(ValueError, match=f"{name}: the kernel takes 2 to 16 weight matrices "
                                         r"and one output \(deeper nets: ROADMAP.md B7\)"):
        _cuda.check_net(name, beyond[3])
    with pytest.raises(ValueError, match=f"{name}: the kernel takes d from 1 to 16 "
                                         r"\(larger d: ROADMAP.md B7\)"):
        _cuda.check_net(name, beyond[4])


# ------------------------------------------- rows 1, 2, 4, 5 in bf16-dot mode
@pytest.mark.parametrize("act", ["sin", "tanh"])
def test_bf16_residual_kernels_match_jax_at_width_136(act):
    """Rows 1 and 2 bf16 (stream and analytic coefficients)."""
    d = 2
    _, pn, X, coef = _case(d, seed=140)
    jp = [(jnp.asarray(Wk), jnp.asarray(b)) for Wk, b in pn]
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


def test_bf16_jet_pair_matches_jax_at_width_136():
    """Row 5 bf16 from the cotangent a Poisson residual gives the raw net's
    jet, against ``jax.vjp`` of the Pallas jet in bf16-dot mode; row 4 bf16
    against the bf16 recompute over the batch, projected on the last row."""
    d, act = 2, "sin"
    _, pn, X, coef = _case(d, seed=141)
    jp = [(jnp.asarray(Wk), jnp.asarray(b)) for Wk, b in pn]
    tp = params_from_jax(pn)
    Xt = torch.as_tensor(X)
    jet = tfc.fwdlap_forward_plain(tp, Xt, act)
    c = torch.as_tensor(coef)
    r = (c[:, 0] * jet.value + torch.sum(c[:, 1:1 + d] * jet.grad, dim=1)
         + c[:, d + 1] * jet.lap + c[:, d + 2])
    ct = (r[:, None] * c[:, :d + 2]).numpy()

    def rows(p):
        j = jfp.mlp_fwdlap_pallas(p, jnp.asarray(X), act, interpret=True,
                                  fwd_impl="pallas2:default", dot_dtype="bfloat16", tile=128,
                                  bwd_tile=128)
        return jnp.concatenate([j.value[:, None], j.grad, j.lap[:, None]], 1)

    _, vjp = jax.vjp(rows, jp)
    (gj,) = vjp(jnp.asarray(ct))
    want = [np.asarray(t) for pair in gj for t in pair]
    dWs, dbs = tfc.fwdlap_backward_plain(tp, Xt, torch.as_tensor(ct), act, "bfloat16")
    got = [t.numpy() for pair in zip(dWs, dbs) for t in pair]
    assert _max_rel(got, want) <= TOL
    dW32, db32 = tfc.fwdlap_backward_plain(tp, Xt, torch.as_tensor(ct), act)
    assert _max_rel(got, [t.numpy() for pair in zip(dW32, db32) for t in pair]) > 10 * TOL

    N = X.shape[0]
    Ws = [jnp.asarray(Wk) for Wk, _ in pn]
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
    got = tfc.fwdlap_forward_default_plain(tp, Xt, act).numpy()
    for col in range(d + 2):
        assert _rel(got[:, col], want[:, col]) <= TOL, col
    assert _rel(got[:, d + 1], jet.lap.numpy()) > 10 * TOL


# ------------------------------------------------------- rows 11 and 12
KW_MB = dict(bwd_tile=128, interpret=True, dot_dtype="float32")


def test_multibump_pair_matches_jax_at_width_136():
    """Pass A's 3 Kb sums and pass B's seeded gradients, 4 bumps, on (2,
    136, 136, 1) (tanh) over random coefficients and seeds."""
    d, Kb, act = 2, 4, "tanh"
    rng = np.random.default_rng(142)
    pn = _np_params(rng, (d, W, W, 1))
    jp = [(jnp.asarray(Wk), jnp.asarray(b)) for Wk, b in pn]
    tp = params_from_jax(pn)
    N = 96
    X = rng.uniform(0.05, L - 0.05, (N, d)).astype(np.float32)
    coef = rng.normal(size=(N, Kb * (d + 4))).astype(np.float32)
    scal = [rng.normal(size=(Kb,)).astype(np.float32) for _ in range(3)]
    Xt, ct = torch.as_tensor(X), torch.as_tensor(coef)

    sj = jmb.fused_multi_sums(jp, jnp.asarray(X), jnp.asarray(coef), act, Kb, lane_pack=2,
                              **KW_MB)
    st = tfm.fused_multi_sums(tp, Xt, ct, act, Kb)
    r, mass, lin = _multi_terms(mlp_fwdlap(tp, Xt, act), ct, Kb, d)
    floors = {"sum_r": r.abs().sum(0), "sum_mass": mass.sum(0), "sum_e2": lin.abs().sum(0)}
    for name in ("sum_r", "sum_mass", "sum_e2"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(sj[name]), rtol=1e-5,
                                   atol=1e-6 * float(floors[name].max()))

    gj = jmb.fused_multi_seeded_grads(jp, jnp.asarray(X), jnp.asarray(coef),
                                      tuple(jnp.asarray(s) for s in scal), act, Kb,
                                      lane_pack=2, **KW_MB)
    gt = tfm.fused_multi_seeded_grads(tp, Xt, ct, tuple(torch.as_tensor(s) for s in scal),
                                      act, Kb)
    for (jW, jb), (tW, tb) in zip(gj, gt):
        assert _rel(tW.numpy(), np.asarray(jW)) <= 1e-5
        assert _rel(tb.numpy(), np.asarray(jb)) <= 1e-5


# --------------------------------------------------------- the entry points
def _patch_inits(monkeypatch, params_by_layers, X):
    """Both packages' entry points start from the same nets and points:
    ``SolutionModel.init`` returns the given params for its layer sizes and
    the uniform sampler returns the first n of the given points."""

    def j_init(self, key, *a, **k):
        return [(jnp.asarray(Wk), jnp.asarray(b))
                for Wk, b in params_by_layers[tuple(self.spec.layers)]]

    def t_init(self, key, dtype=torch.float32, device=None):
        return params_from_jax(params_by_layers[tuple(self.spec.layers)])

    monkeypatch.setattr(JSolutionModel, "init", j_init)
    monkeypatch.setattr(SolutionModel, "init", t_init)
    monkeypatch.setattr(j_poisson_mod, "uniform_box", lambda key, n, box: jnp.asarray(X[:n]))
    monkeypatch.setattr(t_poisson_mod, "uniform_box",
                        lambda gen, n, box: torch.as_tensor(X[:n]).to(gen.device))


HK = dict(dim=2, method="PINN", width=W, depth=3, epochs=5, chunk=5, n_interior=96,
          n_eval=96, compute_dtype="hybrid-kernel")


def test_hybrid_kernel_poisson_matches_jax_at_width_136(monkeypatch):
    """The port's 'fused' and 'kernel' hybrid-kernel runs against JAX's
    'pallas-fused' one from the same nets (at twice the default weights,
    as the bf16 Poisson PINN case of test_torch_precision) and points."""
    rng = np.random.default_rng(143)
    nets = {(2, W, W, 1): [(2.0 * Wk, b) for Wk, b in _np_params(rng, (2, W, W, 1))]}
    X = rng.uniform(0.0, L, (96, 2)).astype(np.float32)
    _patch_inits(monkeypatch, nets, X)
    j = np.asarray(j_train_poisson(JPoissonConfig(jet_impl="pallas-fused", **HK))
                   ["history"]["total"])
    t32 = train_poisson_nd(PoissonConfig(**dict(HK, jet_impl="fused", compute_dtype="float32")),
                           device="cpu")["history"]["total"]
    for route in ("fused", "kernel"):
        h = train_poisson_nd(PoissonConfig(jet_impl=route, **HK), device="cpu")["history"]
        t = h["total"]
        assert t.shape == (5,) and np.all(np.isfinite(t)), route
        assert abs(t[0] - j[0]) <= 2e-3 * abs(j[0]), route
        np.testing.assert_allclose(t, j, rtol=5e-2)
        assert 1e-6 < abs(t[0] - t32[0]) / abs(t32[0]) <= 1e-2, route


def test_multibump_wan_matches_jax_at_width_136():
    """The 2D well's WAN with 4 bumps on 'fused' (the K-bump pair's plain
    versions) at width 136 for the solution net and the critic, against the
    JAX run on 'xla' from the same initial weights."""
    kw = dict(nx=2, ny=2, technique="FN", layers=(2, W, W, 1), v_layers=(2, W, W, 1),
              v_steps=2, grid_n=12, data_grid_n=8, n_boundary=12, epochs=4, chunk=2, seed=0,
              method="WAN", n_test_grid=2)
    key = jax.random.PRNGKey(7)
    ju = JSolutionModel(JNetSpec(kw["layers"], activation="sin"), None).init(key)
    jv = JSolutionModel(JNetSpec(kw["v_layers"], activation="sin"), None).init(
        jax.random.fold_in(key, 9))
    jout = j_train_ipw(JIPWConfig(jet_impl="xla", **kw), init_params=ju, init_v_params=jv)
    to_np = lambda p: [(np.array(Wk), np.array(b)) for Wk, b in p]
    tout = train_ipw_2d(IPW2DConfig(jet_impl="fused", **kw),
                        init_params=params_from_jax(to_np(ju)),
                        init_v_params=params_from_jax(to_np(jv)), device="cpu")
    hj, ht = jout["history"], tout["history"]
    assert set(ht) == set(hj)
    tj, tt = np.asarray(hj["total"]), ht["total"]
    assert tt.shape == (4,) and np.all(np.isfinite(tt))
    np.testing.assert_allclose(tt[0], tj[0], rtol=1e-4)
    np.testing.assert_allclose(tt, tj, rtol=5e-2)
    np.testing.assert_allclose(ht["pde"][0], np.asarray(hj["pde"])[0], rtol=1e-3)
    np.testing.assert_allclose(ht["l2"][0], np.asarray(hj["l2"])[0], rtol=1e-3)
