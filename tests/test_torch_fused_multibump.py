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
from nnpde_tpu_torch.kernels import _cuda as tcuda
from nnpde_tpu_torch.kernels import _plan as tplan
from nnpde_tpu_torch.kernels import fused_multibump as tmb
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


@pytest.mark.parametrize("d,Kb", [(1, 3), (2, 16)])
def test_weak_form_stream_is_the_jax_packing(d, Kb):
    """``weak_form_stream`` (the stream the card checks of rows 11-12 hold
    the kernels on) is the critic's functional of each bump packed in the
    multi-bump layout, as the JAX package's own bumps, coefficients and
    packing build it from the same centres; its 3K seeds are the next
    normals of the same generator over K N."""
    N, L = 37, 2.0
    X = np.random.default_rng(3).uniform(0.0, L, (N, d)).astype(np.float32)
    coef, scal = tmb.weak_form_stream(torch.as_tensor(X), Kb, np.random.default_rng(5), L)
    rng = np.random.default_rng(5)
    centers = rng.uniform(0.3 * L, 0.7 * L, (Kb, d)).astype(np.float32)
    w, dw = j_bump_w_multi(jnp.asarray(X), jnp.asarray(centers), 0.9 * L)
    s = X.sum(axis=1)
    u, gu = np.sin(s) + 0.5, np.repeat(np.cos(s)[:, None], d, axis=1)
    V, f = 0.5 * np.sum(X * X, axis=1), np.sin(X[:, 0]) + 0.5
    want = jmb.pack_multibump_coefficients([j_lfc(
        JJet(w[k], dw[k], jnp.zeros_like(w[k])), c0=(V - 1.0) * u, b0=0.5 * gu,
        rhs=-f * w[k], e1=w[k], e2=w[k] * u) for k in range(Kb)])
    assert coef.shape == (N, Kb * (d + 4))
    np.testing.assert_allclose(coef.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        scal.numpy(), (rng.normal(size=3 * Kb) / (Kb * N)).astype(np.float32))


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
    with pytest.raises(ValueError, match="dot_dtype"):
        fused_multi_sums(p, X, coef, "sin", 2, dot_dtype="float16")
    with pytest.raises(TypeError, match="process group"):
        make_fused_wan_multi_u("sin", 2, axis="batch")
    with pytest.raises(ValueError, match="coef"):
        fused_multi_sums(p, X, coef, "sin", 3)
    with pytest.raises(ValueError, match="objective"):
        make_fused_wan_multi_v("sin", 2, objective="max")


# ----------------------------------------------------------------- the plan
CHIP_NETS = {"u50": (2, 50, 50, 50, 50, 1), "c20": (2, 20, 20, 20, 1)}
EXTREMES = {
    "d16_w128_16layers": (16,) + (128,) * 15 + (1,),
    "width1": (2, 1, 1, 1),
    "widths_1_and_50": (2, 50, 1, 50, 1),
    "w128_shallow": (2, 128, 128, 1),
    "one_hidden": (2, 12, 1),
    "u64": (2, 64, 64, 64, 64, 1),
    "d5_w50": (5, 50, 50, 1),
}


def _launchable(pl, seeded, layers, Kb):
    """What the C entry point checks before it launches (fused_multibump.cu)."""
    return (4 <= pl.T <= tcuda.NT // 2 and pl.T % 4 == 0 and 0 <= pl.flags <= 7
            and pl.smem >= 4 * tmb.smem_floats(seeded, layers, pl.T, Kb, pl.flags)
            and pl.smem <= tcuda.SMEM_MAX)


def _tier_names(seeded):
    return [name for name, _ in tplan.tiers(seeded)]


# the plans the four chip shapes of the K-bump pair ran at before the plan
# was shared (16 bumps): tile, bytes, flags, tier
CHIP_PLANS = {
    ("c20", False): tplan.Plan(48, 53952, tplan.RES_WEIGHTS, "resident"),
    ("c20", True): tplan.Plan(48, 68272, tplan.RES_WEIGHTS | tplan.RES_GRAD | tplan.NARROW,
                              "resident"),
    ("u50", False): tplan.Plan(20, 73248, tplan.RES_WEIGHTS, "resident"),
    ("u50", True): tplan.Plan(24, 69184, 0, "staged"),
}


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("net", sorted(CHIP_NETS))
def test_plan_chip_shapes(net, seeded):
    layers = CHIP_NETS[net]
    pl = tmb.plan(seeded, layers, 16)
    assert pl == CHIP_PLANS[(net, seeded)]          # the shared plan chose as before
    assert _launchable(pl, seeded, layers, 16)
    assert pl.T >= 16 and pl.tier in _tier_names(seeded)
    # the widest forward product is one wave of the block at the asked tile
    S, cg = layers[0] + 1, tcuda.padded_wmax(layers) // 4
    assert (S * tplan.tile_for(layers, S) // 4) * cg <= tcuda.NT
    # three blocks of this shape fit one SM's shared memory
    assert 3 * (pl.smem + 1024) <= tcuda.SMEM_MAX
    # pass A keeps no gradient row and no lane groups
    if not seeded:
        assert pl.flags & ~tplan.RES_WEIGHTS == 0
    elif net == "c20":
        assert pl.flags & tplan.NARROW and pl.tier == "resident"
    else:
        assert not pl.flags & tplan.NARROW and pl.tier == "staged" and pl.T == 24


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("Kb", [1, 16, 42])
@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_plan_takes_every_shape_the_wrapper_takes(net, Kb, seeded):
    layers = EXTREMES[net]
    d = layers[0]
    params = [(torch.zeros(a, b), torch.zeros(b)) for a, b in zip(layers[:-1], layers[1:])]
    X = torch.zeros(8, d)
    assert tcuda.net_layers("multi_sums", params, X, "sin") == list(layers)
    pl = tmb.plan(seeded, layers, Kb)
    assert _launchable(pl, seeded, layers, Kb)
    for tier in _tier_names(seeded):    # a pinned choice fits or raises, never lies
        try:
            pinned = tmb.plan(seeded, layers, Kb, T=16, tier=tier)
        except ValueError:
            continue
        assert pinned.T == 16 and pinned.tier == tier
        assert _launchable(pinned, seeded, layers, Kb)


@pytest.mark.parametrize("net", ["c20", "u50"])
def test_plan_steps_down_in_order(net):
    """Under a shrinking budget: the tile shrinks by one step with the
    weights and the gradient row resident, then with the row alone, then
    nothing stays; only the last tier goes below 16."""
    layers = CHIP_NETS[net]
    order = _tier_names(True)
    seen, last = [], None
    for budget in range(tcuda.SMEM_MAX, 8 * 1024, -2048):
        pl = tplan.fit(lambda t, f: tmb.smem_floats(True, layers, t, 16, f), layers,
                       layers[0] + 1, True, budget, 4)
        if pl is None:
            break
        assert pl.smem <= budget and pl.T % 4 == 0
        key = (order.index(pl.tier), -pl.T)
        assert last is None or key >= last, (budget, pl, last)
        assert pl.T >= 16 or pl.tier == "staged"
        assert pl.T <= tplan.tile_for(layers, layers[0] + 1)
        last = key
        if pl.tier not in seen:
            seen.append(pl.tier)
    assert seen == order
    assert last[1] == -4                 # the last step is the smallest tile


def test_plan_flags_per_tier():
    u50 = CHIP_NETS["u50"]
    res = tmb.plan(True, u50, 16, T=16, tier="resident")
    grd = tmb.plan(True, u50, 16, T=16, tier="gradient")
    sta = tmb.plan(True, u50, 16, T=16, tier="staged")
    assert res.flags == tplan.RES_WEIGHTS | tplan.RES_GRAD and sta.flags == 0
    assert grd.flags == tplan.RES_GRAD
    assert tmb.plan(False, u50, 16, T=16, tier="resident").flags == tplan.RES_WEIGHTS
    with pytest.raises(ValueError, match="do not fit"):
        tmb.plan(False, u50, 16, T=16, tier="gradient")     # pass A has no gradient row
    # what each step down gives back: the resident matrices twice (W and W^T)
    # less the one staging matrix taken instead, then the gradient row
    wp, P = tcuda.padded_wmax(u50), tcuda.n_params(u50)
    hid = 3 * wp * wp
    row = (P + 1 + 3) // 4 * 4
    assert res.smem - grd.smem == 4 * (2 * hid - wp * wp)
    assert grd.smem - sta.smem == 4 * row
    assert tplan.resident(res, True) == ["hidden weights", "their transposes", "gradient row"]
    assert tplan.resident(grd, True) == ["gradient row"]
    assert tplan.resident(res, False) == ["hidden weights"] and tplan.resident(sta, True) == []
    with pytest.raises(ValueError, match="do not fit"):
        tmb.plan(True, EXTREMES["d16_w128_16layers"], 42, T=16, tier="resident")


def test_workspace_is_bounded_and_grows_in_place():
    """One (partial, scratch) pair per pass, device and stream, replaced by a
    larger one when needed; the cache keeps at most ``_WORKSPACE_MAX``."""
    cpu = torch.device("cpu")
    tmb._WORKSPACE.clear()
    try:
        p1, s1 = tmb._workspace(True, cpu, 0, 100, 50)
        p2, s2 = tmb._workspace(True, cpu, 0, 80, 50)
        assert p2 is p1 and s2 is s1 and len(tmb._WORKSPACE) == 1
        p3, s3 = tmb._workspace(True, cpu, 0, 200, 0)
        assert p3.numel() == 200 and s3 is None and len(tmb._WORKSPACE) == 1
        assert tmb._workspace(True, cpu, 0, 10, 10)[1] is s1     # kept for the next need
        assert tmb._workspace(False, cpu, 0, 48, 0)[1] is None
        for stream in range(1, 3 * tmb._WORKSPACE_MAX):
            tmb._workspace(True, cpu, stream, 8, 8)
        assert len(tmb._WORKSPACE) == tmb._WORKSPACE_MAX
        assert (True, cpu, 0) not in tmb._WORKSPACE                # the oldest went first
    finally:
        tmb._WORKSPACE.clear()


def test_flat_vector_handoff_matches_params_route():
    """The flat parameter vector built once in ``forward`` and reused in
    ``backward`` gives the sums and gradients of the params route."""
    d, Kb = 2, 4
    rng, _, _, tp, X = _setup(d, 12, "tanh", seed=31)
    Xt = torch.as_tensor(X)
    coef = torch.as_tensor(rng.normal(size=(X.shape[0], Kb * (d + 4))).astype(np.float32))
    flat = tcuda.flat_params(tp)
    a = fused_multi_sums(tp, Xt, coef, "tanh", Kb)
    b = fused_multi_sums(tp, Xt, coef, "tanh", Kb, flat=flat)
    for k in ("sum_r", "sum_mass", "sum_e2"):
        assert torch.equal(a[k], b[k])
    scal = tuple(torch.as_tensor(rng.normal(size=Kb).astype(np.float32)) for _ in range(3))
    ga = fused_multi_seeded_grads(tp, Xt, coef, scal, "tanh", Kb)
    gb = fused_multi_seeded_grads(tp, Xt, coef, scal, "tanh", Kb, flat=flat)
    assert np.array_equal(_flat_t([t for pair in ga for t in pair]),
                          _flat_t([t for pair in gb for t in pair]))
    # the values come from the flat vector, the shapes from params
    zeros = [(torch.zeros_like(W), torch.zeros_like(bb)) for W, bb in tp]
    c = fused_multi_sums(zeros, Xt, coef, "tanh", Kb, flat=flat)
    assert torch.equal(a["sum_r"], c["sum_r"])
