"""The port's K-bump WAN pair against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both packages.  The JAX side
runs its Pallas kernels in interpret mode as its own tests do
(``bwd_tile=128, interpret=True, dot_dtype="float32"``, ``lane_pack`` 1 and
2); the port's wrappers take their plain versions here (CPU tensors).

Tolerances (float32 on both sides):

* pass-A sums rel <= 1e-5, with the atol floor of the JAX package's own
  test: 1e-6 of the sum of the terms' magnitudes (random-sign integrands
  nearly cancel);
* objectives rel <= 1e-5, parameter gradient trees rel <= 1e-5, dE rel <=
  1e-5, d ``phi_norms`` rtol 1e-5 with atol 1e-10 (its smallest entries sit
  where float32 summation order exceeds the rtol);
* K = 1 against the single-bump pair: value rel <= 1e-6, grads <= 1e-6;
* ``MAX_BUMPS`` and its ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.kernels import fused_multibump as jmb
from nnpde_tpu.kernels.fused_quotient import linear_functional_coefficients as j_lfc
from nnpde_tpu.models import NetSpec as JNetSpec
from nnpde_tpu.models import SolutionModel as JSolutionModel
from nnpde_tpu.models import factor_for_technique as j_factor
from nnpde_tpu.ops import bump_grid as j_bump_grid
from nnpde_tpu.ops import bump_w_multi as j_bump_w_multi
from nnpde_tpu.ops.fwdlap import Jet as JJet
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import (
    MAX_BUMPS,
    fused_multi_seeded_grads,
    fused_multi_sums,
    linear_functional_coefficients,
    make_fused_wan_multi_u,
    make_fused_wan_multi_v,
    make_fused_wan_u,
    pack_multibump_coefficients,
)
from nnpde_tpu_torch.models import factor_for_technique
from nnpde_tpu_torch.ops import bump_grid, bump_w_multi
from nnpde_tpu_torch.ops.fwdlap import Jet

KW = dict(bwd_tile=128, interpret=True, dot_dtype="float32")
L = 1.5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat_j(grads):
    return np.concatenate([np.ravel(np.asarray(t)) for pair in grads for t in pair])


def _flat_t(grads):
    return np.concatenate([np.ravel(t.detach().numpy()) for t in grads])


def _setup(d, width, act, seed, N=200):
    """A JAX-initialised net carried to torch, numpy points and bump data."""
    rng = np.random.default_rng(seed)
    jm = JSolutionModel(JNetSpec((d, width, width, 1), activation=act),
                        j_factor("FBC", dim=d, kind="box", L=L))
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_jax([(np.array(W), np.array(b)) for W, b in jp])
    X = rng.uniform(0.05, L - 0.05, (N, d)).astype(np.float32)
    return rng, jm, jp, tp, X


def _u_cores(api, factor_jet, phi, gphi, pref=0.5, V=None):
    """Per-bump u-step streams, for either package (``api`` = its
    linear_functional_coefficients, packer and zeros_like)."""
    lfc, pack, zeros_like = api
    zero = zeros_like(factor_jet.value)
    cores = []
    for k in range(phi.shape[0]):
        c0 = V * phi[k] if V is not None else None
        cores.append(lfc(factor_jet, c0=c0, b0=pref * gphi[k],
                         e1=factor_jet.value if k == 0 else zero,
                         e2=factor_jet.value * phi[k]))
    return pack(cores)


J_API = (j_lfc, jmb.pack_multibump_coefficients, jnp.zeros_like)
T_API = (linear_functional_coefficients, pack_multibump_coefficients, torch.zeros_like)


@pytest.mark.parametrize("d,Kb,lane_pack", [(1, 3, 1), (2, 4, 2)])
def test_multi_sums_match_jax(d, Kb, lane_pack):
    act = "sin"
    rng, jm, jp, tp, X = _setup(d, 16, act, seed=1)
    N = X.shape[0]
    phi = rng.normal(size=(Kb, N)).astype(np.float32)
    gphi = rng.normal(size=(Kb, N, d)).astype(np.float32)
    V = (0.4 * np.sum(X ** 2, axis=1)).astype(np.float32)
    Xj = jnp.asarray(X)
    cj = _u_cores(J_API, jm.factor.jet(Xj), jnp.asarray(phi), jnp.asarray(gphi),
                  V=jnp.asarray(V))
    sj = jmb.fused_multi_sums(jp, Xj, cj, act, Kb, lane_pack=lane_pack, **KW)

    Xt = torch.as_tensor(X)
    tf = factor_for_technique("FBC", dim=d, kind="box", L=L)
    ct = _u_cores(T_API, tf.jet(Xt), torch.as_tensor(phi), torch.as_tensor(gphi),
                  V=torch.as_tensor(V))
    assert ct.shape == (N, Kb * (d + 4))
    assert _rel(ct.numpy(), np.asarray(cj)) <= 1e-6
    st = fused_multi_sums(tp, Xt, ct, act, Kb)
    assert st["n"] == N

    # the atol floor: 1e-6 of the sum of the terms' magnitudes
    from nnpde_tpu_torch.kernels.fused_multibump import _multi_terms
    from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap

    r, mass, lin = _multi_terms(mlp_fwdlap(tp, Xt, act), ct, Kb, d)
    floors = {"sum_r": r.abs().sum(0), "sum_mass": mass.sum(0), "sum_e2": lin.abs().sum(0)}
    for name in ("sum_r", "sum_mass", "sum_e2"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(sj[name]), rtol=1e-5,
                                   atol=1e-6 * float(floors[name].max()))
    np.testing.assert_allclose(st["sum_mass"][1:].numpy(), np.zeros(Kb - 1), atol=1e-12)


def test_multi_seeded_grads_match_jax():
    d, Kb, act = 2, 4, "sin"
    rng, jm, jp, tp, X = _setup(d, 16, act, seed=2)
    N = X.shape[0]
    coef = rng.normal(size=(N, Kb * (d + 4))).astype(np.float32)
    scal = [rng.normal(size=(Kb,)).astype(np.float32) for _ in range(3)]
    gj = jmb.fused_multi_seeded_grads(jp, jnp.asarray(X), jnp.asarray(coef),
                                      tuple(jnp.asarray(s) for s in scal), act, Kb,
                                      lane_pack=2, **KW)
    gt = fused_multi_seeded_grads(tp, torch.as_tensor(X), torch.as_tensor(coef),
                                  tuple(torch.as_tensor(s) for s in scal), act, Kb)
    for (jW, jb), (tW, tb) in zip(gj, gt):
        assert _rel(tW.numpy(), np.asarray(jW)) <= 1e-5
        assert _rel(tb.numpy(), np.asarray(jb)) <= 1e-5


@pytest.mark.parametrize("convention,lane_pack", [("wr2_over_norm", 2), ("ratio_sq", 1)])
def test_multi_wan_u_matches_jax(convention, lane_pack):
    d, act, Kb = 2, "sin", 4
    rng, jm, jp, tp, X = _setup(d, 16, act, seed=11)
    N = X.shape[0]
    phi = rng.normal(size=(Kb, N)).astype(np.float32)
    gphi = rng.normal(size=(Kb, N, d)).astype(np.float32)
    V = (0.3 * np.sum(X ** 2, axis=1)).astype(np.float32)
    pn = np.mean(phi ** 2, axis=1).astype(np.float32)
    kw = dict(convention=convention, eps=1e-8, vol=float(L ** d), w_pde=10.0, w_norm=100.0)

    Xj = jnp.asarray(X)
    base_j = _u_cores(J_API, jm.factor.jet(Xj), jnp.asarray(phi), jnp.asarray(gphi),
                      V=jnp.asarray(V))
    loss_j = jmb.make_fused_wan_multi_u(act, Kb, lane_pack=lane_pack, **kw, **KW)
    (vj, auxj), (gj, dEj, dpnj) = jax.value_and_grad(
        lambda p, E, q: loss_j(p, E, Xj, base_j, q), argnums=(0, 1, 2), has_aux=True)(
            jp, jnp.asarray(2.7), jnp.asarray(pn))

    Xt = torch.as_tensor(X)
    tf = factor_for_technique("FBC", dim=d, kind="box", L=L)
    base_t = _u_cores(T_API, tf.jet(Xt), torch.as_tensor(phi), torch.as_tensor(gphi),
                      V=torch.as_tensor(V))
    loss_t = make_fused_wan_multi_u(act, Kb, **kw)
    leaves = [t.requires_grad_(True) for pair in tp for t in pair]
    E = torch.tensor(2.7, requires_grad=True)
    pnt = torch.tensor(pn, requires_grad=True)
    total, aux = loss_t(tp, E, Xt, base_t, pnt)
    g = torch.autograd.grad(total, leaves + [E, pnt])
    assert abs(float(total.detach()) - float(vj)) <= 1e-5 * abs(float(vj))
    assert _rel(_flat_t(g[:len(leaves)]), _flat_j(gj)) <= 1e-5
    np.testing.assert_allclose(float(g[-2]), float(dEj), rtol=1e-5)
    np.testing.assert_allclose(g[-1].numpy(), np.asarray(dpnj), rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(aux["weak_residual"].numpy(), np.asarray(auxj["weak_residual"]),
                               rtol=1e-4, atol=1e-6)
    assert base_t.grad is None and not base_t.requires_grad   # base is data


@pytest.mark.parametrize("objective,lane_pack", [("neg_log", 2), ("neg", 1)])
def test_multi_wan_v_matches_jax(objective, lane_pack):
    """The critic with per-bump effective factors W_k = w_k * Bv from the
    real bump grid; the per-bump masses are in the objective."""
    d, act, grid = 2, "tanh", 2
    rng, jm, jp, tp, X = _setup(d, 16, act, seed=31)
    N = X.shape[0]
    u = rng.normal(size=(N,)).astype(np.float32)
    gu = rng.normal(size=(N, d)).astype(np.float32)
    E, pref = 1.9, 0.5

    Xj = jnp.asarray(X)
    cj_, hwj = j_bump_grid(0.0, L, d, grid)
    wvj, dwvj = j_bump_w_multi(Xj, cj_, hwj)
    Kb = int(cj_.shape[0])
    Bj = jm.factor.jet(Xj)
    cores = []
    for k in range(Kb):
        Wm = wvj[k] * Bj.value
        gWm = dwvj[k] * Bj.value[:, None] + wvj[k][:, None] * Bj.grad
        cores.append(j_lfc(JJet(Wm, gWm, jnp.zeros_like(Wm)), c0=-E * jnp.asarray(u),
                           b0=pref * jnp.asarray(gu), e1=Wm))
    coef_j = jmb.pack_multibump_coefficients(cores)
    loss_j = jmb.make_fused_wan_multi_v(act, Kb, objective=objective, lane_pack=lane_pack,
                                        **KW)
    (vj, _), gj = jax.value_and_grad(lambda p: loss_j(p, Xj, coef_j), has_aux=True)(jp)

    Xt = torch.as_tensor(X)
    ct_, hwt = bump_grid(0.0, L, d, grid)
    assert hwt == hwj and _rel(ct_.numpy(), np.asarray(cj_)) <= 1e-7
    wvt, dwvt = bump_w_multi(Xt, ct_, hwt)
    assert wvt.shape == (Kb, N) and dwvt.shape == (Kb, N, d)
    assert _rel(wvt.numpy(), np.asarray(wvj)) <= 1e-5
    assert _rel(dwvt.numpy(), np.asarray(dwvj)) <= 1e-5
    Bt = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(Xt)
    cores = []
    for k in range(Kb):
        Wm = wvt[k] * Bt.value
        gWm = dwvt[k] * Bt.value[:, None] + wvt[k][:, None] * Bt.grad
        cores.append(linear_functional_coefficients(
            Jet(Wm, gWm, torch.zeros_like(Wm)), c0=-E * torch.as_tensor(u),
            b0=pref * torch.as_tensor(gu), e1=Wm))
    coef_t = pack_multibump_coefficients(cores)
    loss_t = make_fused_wan_multi_v(act, Kb, objective=objective)
    leaves = [t.requires_grad_(True) for pair in tp for t in pair]
    val, aux = loss_t(tp, Xt, coef_t)
    g = torch.autograd.grad(val, leaves)
    assert abs(float(val.detach()) - float(vj)) <= 1e-5 * max(abs(float(vj)), 1e-8)
    assert _rel(_flat_t(g), _flat_j(gj)) <= 1e-5
    assert aux["phi_norm"].shape == (Kb,)


def test_multibump_k1_matches_single_bump():
    """K = 1 reduces to the single-bump fused objective."""
    d, act = 1, "sin"
    rng, jm, jp, tp, X = _setup(d, 16, act, seed=5)
    N = X.shape[0]
    Xt = torch.as_tensor(X)
    phi = torch.as_tensor(rng.normal(size=(1, N)).astype(np.float32))
    gphi = torch.as_tensor(rng.normal(size=(1, N, d)).astype(np.float32))
    pn = torch.mean(phi[0] ** 2)
    B = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(Xt)
    base_m = _u_cores(T_API, B, phi, gphi)
    base_s = linear_functional_coefficients(B, b0=0.5 * gphi[0], a0=0.0, e1=B.value,
                                            e2=B.value * phi[0])
    loss_m = make_fused_wan_multi_u(act, 1, vol=float(L), w_pde=2.0, w_norm=5.0)
    loss_s = make_fused_wan_u(act, vol=float(L), w_pde=2.0, w_norm=5.0)
    leaves = [t.requires_grad_(True) for pair in tp for t in pair]
    E = torch.tensor(1.2, requires_grad=True)
    vm, _ = loss_m(tp, E, Xt, base_m, pn[None])
    vs, _ = loss_s(tp, E, Xt, base_s, pn)
    gm = torch.autograd.grad(vm, leaves + [E])
    gs = torch.autograd.grad(vs, leaves + [E])
    np.testing.assert_allclose(float(vm.detach()), float(vs.detach()), rtol=1e-6)
    assert _rel(_flat_t(gm), _flat_t(gs)) <= 1e-6


def test_n_bumps_cap():
    assert MAX_BUMPS == jmb.MAX_BUMPS == 42
    with pytest.raises(ValueError, match="n_bumps"):
        make_fused_wan_multi_u("sin", MAX_BUMPS + 1)
    with pytest.raises(ValueError, match="n_bumps"):
        make_fused_wan_multi_v("sin", 0)
    with pytest.raises(ValueError, match="n_bumps"):
        pack_multibump_coefficients([torch.zeros(4, 7)] * (MAX_BUMPS + 1))
    make_fused_wan_multi_u("sin", MAX_BUMPS)          # the cap itself is taken


def test_multibump_options_that_raise():
    X, coef = torch.zeros(8, 2), torch.zeros(8, 12)
    p = [(torch.zeros(2, 4), torch.zeros(4)), (torch.zeros(4, 1), torch.zeros(1))]
    with pytest.raises(NotImplementedError, match="dot_dtype"):
        fused_multi_sums(p, X, coef, "sin", 2, dot_dtype="bf16x3")
    with pytest.raises(NotImplementedError, match="A13"):
        make_fused_wan_multi_u("sin", 2, axis="batch")
    with pytest.raises(ValueError, match="coef"):
        fused_multi_sums(p, X, coef, "sin", 3)
    with pytest.raises(ValueError, match="objective"):
        make_fused_wan_multi_v("sin", 2, objective="max")
