"""The port's WAN modules against the JAX package: the bump, the jet
forward, the two-pass quotient kernels and their objectives.

On the CPU the port's wrappers run their plain versions (the
forward-Laplacian recurrence, under ``torch.autograd`` for the seeded
passes); the JAX side runs its Pallas kernels in interpret mode with
float32 dots, as ``tests/test_fused_quotient.py`` does.  The same numpy
inputs and parameters go to both, at N = 300 (not a multiple of the JAX
tile, so the JAX side pads), width 16.  Tolerances: rel <= 1e-5 on every
value, gradient tree, ``dE`` and ``d_pn``, and on each jet column (plus,
against the JAX jet kernel, that kernel's own bf16x3 error); a sum that can
cancel is held to 1e-5 of the sum of its terms' magnitudes; the bump to
1e-6.  The port runs in float32 and float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.kernels import fused_quotient as jfq
from nnpde_tpu.kernels import mlp_fwdlap_pallas
from nnpde_tpu.models import factor_for_technique as j_factor
from nnpde_tpu.ops import bump_w as j_bump_w
from nnpde_tpu.ops.fwdlap import mlp_fwdlap as j_mlp_fwdlap
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import fused_quotient as tfq
from nnpde_tpu_torch.kernels import mlp_fwdlap_kernel
from nnpde_tpu_torch.models import factor_for_technique
from nnpde_tpu_torch.ops import bump_w
from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap

KW = dict(bwd_tile=128, interpret=True, dot_dtype="float32")
L = 1.5
DTYPES = (torch.float32, torch.float64)


def _np_params(rng, layers):
    out = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = 1.0 / np.sqrt(n_in)
        out.append((rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                    rng.uniform(-bound, bound, (n_out,)).astype(np.float32)))
    return out


def _case(d, seed, N=300, width=16):
    rng = np.random.default_rng(seed)
    pn = _np_params(rng, (d, width, width, width, 1))
    X = rng.uniform(0.05, L - 0.05, (N, d)).astype(np.float32)
    return rng, pn, X


def _jp(pn):
    return [(jnp.asarray(W), jnp.asarray(b)) for W, b in pn]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tree_rel(a, b):
    flat = lambda t: np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in t])
    return _rel(flat([x.detach().numpy() if torch.is_tensor(x) else x
                      for pair in a for x in pair]),
                flat([x for pair in b for x in pair]))


def _t(a, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _abs_terms(pn, X, coef, act, kind):
    """Sum of the magnitudes of each lane's per-point terms (float64)."""
    d = X.shape[1]
    jet = mlp_fwdlap(params_from_jax(pn, dtype=torch.float64), _t(X, torch.float64), act)
    v, g, lap = (t.numpy() for t in jet)
    c = np.asarray(coef, np.float64)
    if kind == "linear":
        r = c[:, 0] * v + np.sum(c[:, 1:1 + d] * g, axis=1) + c[:, d + 1] * lap + c[:, d + 2]
        return [np.sum(np.abs(r)), np.sum(r * r), np.sum((c[:, d + 3] * v) ** 2),
                np.sum(np.abs(c[:, d + 4] * v))]
    u = c[:, 0] * v
    G = c[:, 0:1] * g + c[:, 1:1 + d] * v[:, None]
    e = 0.5 * np.sum(G * G, axis=1) - c[:, d + 1] * u + c[:, d + 2] * u * u
    return [np.sum(np.abs(e)), np.sum(u * u)]


# ------------------------------------------------------------------- bump
def test_bump_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.uniform(-0.2, 2.2, (400, 3))          # inside and outside the box
    X[:5] = [0.0, 1.0, 2.0]                       # on the faces and centre
    with jax.enable_x64(True):
        wj, dwj = (np.asarray(a) for a in j_bump_w(jnp.asarray(X), 0.0, 2.0))
    w, dw = bump_w(torch.as_tensor(X), 0.0, 2.0)
    assert _rel(w.numpy(), wj) <= 1e-6 and _rel(dw.numpy(), dwj) <= 1e-6
    assert np.all(w.numpy()[np.any((X <= 0) | (X >= 2), axis=1)] == 0.0)


# ------------------------------------------------------------ jet forward
def _columns(jet):
    v, g, lap = (np.asarray(t.detach().numpy() if torch.is_tensor(t) else t) for t in jet)
    return [v] + [g[:, i] for i in range(g.shape[1])] + [lap]


@pytest.mark.parametrize("d,act", [(1, "tanh"), (2, "sin"), (3, "sin")])
def test_jet_forward_matches_jax_kernel(d, act):
    """Per column (u, each grad_i, lap): the port within 1e-5 of the JAX
    recurrence at full f32 precision, and within 1e-5 plus the JAX
    kernel's own deviation from it of ``_forward_kernel2`` (whose dots are
    bf16x3 splits with the lo*lo term dropped, up to ~2e-5 here)."""
    _, pn, X = _case(d, seed=d)
    kernel_j = _columns(mlp_fwdlap_pallas(_jp(pn), jnp.asarray(X), act,
                                          fwd_impl="pallas2", tile=128, interpret=True))
    with jax.default_matmul_precision("highest"):
        exact_j = _columns(j_mlp_fwdlap(_jp(pn), jnp.asarray(X), act))
    own = [_rel(k, e) for k, e in zip(kernel_j, exact_j)]
    for dtype in DTYPES:
        got = _columns(mlp_fwdlap_kernel(params_from_jax(pn, dtype=dtype), _t(X, dtype), act))
        for c in range(d + 2):
            assert _rel(got[c], exact_j[c]) <= 1e-5
            assert _rel(got[c], kernel_j[c]) <= 1e-5 + own[c]
    # differentiating through the kernel route gives the gradient of the
    # recurrence under autograd (rel <= 1e-5)
    tp = [(W.requires_grad_(True), b.requires_grad_(True)) for W, b in params_from_jax(pn)]
    jet = mlp_fwdlap_kernel(tp, _t(X, torch.float32), act)
    (got,) = torch.autograd.grad(torch.sum(jet.lap), [tp[0][0]])
    (want,) = torch.autograd.grad(torch.sum(mlp_fwdlap(tp, _t(X, torch.float32), act).lap),
                                  [tp[0][0]])
    assert _rel(got.numpy(), want.numpy()) <= 1e-5


# --------------------------------------------------------------- raw API
@pytest.mark.parametrize("d,act,no_lap", [(1, "sin", False), (2, "tanh", True),
                                          (3, "sin", True)])
def test_linear_pair_matches_jax_kernels(d, act, no_lap):
    rng, pn, X = _case(d, seed=10 + d)
    N = X.shape[0]
    coef = rng.normal(size=(N, d + 5)).astype(np.float32)
    if no_lap:
        coef[:, d + 1] = 0.0
    scal = (0.3, -0.2, 0.7)
    sj = jfq.fused_linear_sums(_jp(pn), jnp.asarray(X), jnp.asarray(coef), act,
                               no_lap=no_lap, **KW)
    gj = jfq.fused_seeded_grads(_jp(pn), jnp.asarray(X), jnp.asarray(coef), scal, act,
                                no_lap=no_lap, **KW)
    scale = _abs_terms(pn, X, coef, act, "linear")
    for dtype in DTYPES:
        tp, Xt, Ct = params_from_jax(pn, dtype=dtype), _t(X, dtype), _t(coef, dtype)
        st = tfq.fused_linear_sums(tp, Xt, Ct, act, no_lap=no_lap)
        for i, k in enumerate(("sum_r", "sum_r2", "sum_mass", "sum_e2")):
            assert abs(float(st[k]) - float(sj[k])) <= 1e-5 * scale[i]
        assert st["n"] == N
        gt = tfq.fused_seeded_grads(tp, Xt, Ct, scal, act, no_lap=no_lap)
        assert _tree_rel(gt, gj) <= 1e-5


@pytest.mark.parametrize("d,act", [(1, "tanh"), (2, "sin"), (3, "tanh")])
def test_quad_pair_matches_jax_kernels(d, act):
    rng, pn, X = _case(d, seed=20 + d)
    N = X.shape[0]
    fj = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(X))
    coef = np.asarray(jfq.quotient_coefficients(
        fj, f=jnp.asarray(rng.normal(size=N).astype(np.float32)),
        V=jnp.asarray(rng.normal(size=N).astype(np.float32))))
    scal = (0.4, -0.3)
    sj = jfq.fused_quad_sums(_jp(pn), jnp.asarray(X), jnp.asarray(coef), act, **KW)
    gj = jfq.fused_quad_seeded_grads(_jp(pn), jnp.asarray(X), jnp.asarray(coef), scal,
                                     act, **KW)
    scale = _abs_terms(pn, X, coef, act, "quad")
    for dtype in DTYPES:
        tp, Xt, Ct = params_from_jax(pn, dtype=dtype), _t(X, dtype), _t(coef, dtype)
        st = tfq.fused_quad_sums(tp, Xt, Ct, act)
        assert abs(float(st["sum_e"]) - float(sj["sum_e"])) <= 1e-5 * scale[0]
        assert abs(float(st["sum_u2"]) - float(sj["sum_u2"])) <= 1e-5 * scale[1]
        gt = tfq.fused_quad_seeded_grads(tp, Xt, Ct, scal, act)
        assert _tree_rel(gt, gj) <= 1e-5


@pytest.mark.parametrize("kind", ["linear", "quad"])
def test_coefficient_builders_match_jax(kind):
    rng = np.random.default_rng(4)
    d, N = 3, 50
    X = rng.uniform(0.0, L, (N, d))
    a, b = rng.normal(size=N), rng.normal(size=(N, d))
    with jax.enable_x64(True):
        fj = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(X))
        if kind == "linear":
            want = jfq.linear_functional_coefficients(
                fj, c0=jnp.asarray(a), b0=jnp.asarray(b), a0=0.3, rhs=jnp.asarray(a ** 2),
                e1=fj.value, e2=fj.value * jnp.asarray(a))
        else:
            want = jfq.quotient_coefficients(fj, f=jnp.asarray(a), V=0.5)
        want = np.asarray(want)
    tj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(torch.as_tensor(X))
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    if kind == "linear":
        got = tfq.linear_functional_coefficients(tj, c0=at, b0=bt, a0=0.3, rhs=at ** 2,
                                                 e1=tj.value, e2=tj.value * at)
    else:
        got = tfq.quotient_coefficients(tj, f=at, V=0.5)
    assert np.allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------ objectives
def _both(pn, dtype):
    return [(W.requires_grad_(True), b.requires_grad_(True))
            for W, b in params_from_jax(pn, dtype=dtype)]


def _leaf_grads(total, tp, extra=()):
    leaves = [t for pair in tp for t in pair] + list(extra)
    g = torch.autograd.grad(total, leaves)
    n = len(g) - len(extra)
    return [(g[i], g[i + 1]) for i in range(0, n, 2)], g[n:]


@pytest.mark.parametrize("which", ["rayleigh", "quad_mean"])
def test_quadratic_objectives_match_jax(which):
    d, act = 2, "sin"
    rng, pn, X = _case(d, seed=31)
    N = X.shape[0]
    fj = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(X))
    V = 0.5 * np.sum((X - L / 2) ** 2, axis=1).astype(np.float32)
    f = rng.normal(size=N).astype(np.float32)
    coef = np.asarray(jfq.quotient_coefficients(fj, f=jnp.asarray(f), V=jnp.asarray(V)))
    if which == "rayleigh":
        lj = jfq.make_fused_rayleigh(act, weight=3.0, den_eps=1e-3, **KW)
        lt = tfq.make_fused_rayleigh(act, weight=3.0, den_eps=1e-3)
    else:
        lj = jfq.make_fused_quad_mean(act, weight=2.0, **KW)
        lt = tfq.make_fused_quad_mean(act, weight=2.0)
    (vj, _), gj = jax.value_and_grad(lambda p: lj(p, jnp.asarray(X), jnp.asarray(coef)),
                                     has_aux=True)(_jp(pn))
    for dtype in DTYPES:
        tp = _both(pn, dtype)
        total, aux = lt(tp, _t(X, dtype), _t(coef, dtype))
        gt, _ = _leaf_grads(total, tp)
        assert abs(float(total.detach()) - float(vj)) <= 1e-5 * abs(float(vj))
        assert _tree_rel(gt, gj) <= 1e-5
        assert not aux["mean_e"].requires_grad


@pytest.mark.parametrize("convention", ["wr2_over_norm", "ratio_sq"])
def test_wan_u_matches_jax(convention):
    """Primal objective with trainable E and the norm penalty: value,
    params grads, dE and d_pn."""
    d, act = 2, "sin"
    rng, pn, X = _case(d, seed=41)
    N = X.shape[0]
    phi = rng.normal(size=N).astype(np.float32)
    gphi = rng.normal(size=(N, d)).astype(np.float32)
    V = (0.3 * np.sum(X ** 2, axis=1)).astype(np.float32)
    fj = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(X))
    base = np.asarray(jfq.linear_functional_coefficients(
        fj, c0=jnp.asarray(V * phi), b0=0.5 * jnp.asarray(gphi), a0=0.0,
        e1=fj.value, e2=fj.value * jnp.asarray(phi)))
    pn0 = float(np.mean(phi.astype(np.float64) ** 2))
    opts = dict(convention=convention, eps=1e-8, vol=float(L ** d), w_pde=10.0,
                w_norm=100.0)
    lj = jfq.make_fused_wan_u(act, **opts, **KW)
    (vj, _), (gj, dEj, dpnj) = jax.value_and_grad(
        lambda p, E, pnrm: lj(p, E, jnp.asarray(X), jnp.asarray(base), pnrm),
        argnums=(0, 1, 2), has_aux=True)(_jp(pn), jnp.asarray(2.7), jnp.asarray(pn0))
    lt = tfq.make_fused_wan_u(act, **opts)
    for dtype in DTYPES:
        tp = _both(pn, dtype)
        E = torch.tensor(2.7, dtype=dtype, requires_grad=True)
        pnt = torch.tensor(pn0, dtype=dtype, requires_grad=True)
        total, aux = lt(tp, E, _t(X, dtype), _t(base, dtype), pnt)
        gt, (dE, dpn) = _leaf_grads(total, tp, (E, pnt))
        assert abs(float(total.detach()) - float(vj)) <= 1e-5 * abs(float(vj))
        assert _tree_rel(gt, gj) <= 1e-5
        assert abs(float(dE) - float(dEj)) <= 1e-5 * abs(float(dEj))
        assert abs(float(dpn) - float(dpnj)) <= 1e-5 * abs(float(dpnj))
        assert set(aux) == {"weak_residual", "pde_loss", "norm", "mean_u2", "phi_norm"}


@pytest.mark.parametrize("objective,convention", [("neg_log", "wr2_over_norm"),
                                                  ("neg", "ratio_sq")])
def test_wan_v_matches_jax(objective, convention):
    d, act = 2, "tanh"
    rng, pn, X = _case(d, seed=51)
    N = X.shape[0]
    u = rng.normal(size=N).astype(np.float32)
    gu = rng.normal(size=(N, d)).astype(np.float32)
    with jax.enable_x64(False):
        wv, dwv = j_bump_w(jnp.asarray(X), 0.0, L)
    wjet = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(X))._replace(
        value=wv, grad=dwv)
    coef = np.asarray(jfq.linear_functional_coefficients(
        wjet, c0=jnp.asarray(-1.9 * u), b0=0.5 * jnp.asarray(gu), a0=0.0, e1=wv))
    opts = dict(convention=convention, eps=1e-8, objective=objective, log_eps=1e-8)
    lj = jfq.make_fused_wan_v(act, **opts, **KW)
    (vj, _), gj = jax.value_and_grad(lambda p: lj(p, jnp.asarray(X), jnp.asarray(coef)),
                                     has_aux=True)(_jp(pn))
    lt = tfq.make_fused_wan_v(act, **opts)
    for dtype in DTYPES:
        tp = _both(pn, dtype)
        total, _ = lt(tp, _t(X, dtype), _t(coef, dtype))
        gt, _ = _leaf_grads(total, tp)
        assert abs(float(total.detach()) - float(vj)) <= 1e-5 * max(abs(float(vj)), 1e-8)
        assert _tree_rel(gt, gj) <= 1e-5


def test_factories_reject_what_is_not_ported():
    with pytest.raises(TypeError, match="process group"):
        tfq.make_fused_wan_u("sin", axis="data")
    with pytest.raises(NotImplementedError):
        tfq.make_fused_rayleigh("sin", dot_dtype="bf16x3")
    with pytest.raises(ValueError):
        tfq.make_fused_wan_v("sin", objective="max")
    with pytest.raises(ValueError):
        tfq.make_fused_wan_u("sin", convention="wr_over_norm")


# ------------------------------------------------------------------ the plan
QNETS = {"c64": (2, 64, 64, 1), "u64": (2, 64, 64, 64, 64, 1), "u50": (2, 50, 50, 50, 50, 1)}
QEXTREMES = {
    "d16_w128_16layers": (16,) + (128,) * 15 + (1,),
    "width1": (2, 1, 1, 1),
    "widths_1_and_50": (2, 50, 1, 50, 1),
    "w128_shallow": (2, 128, 128, 1),
    "one_hidden": (2, 12, 1),
    **QNETS,
}


def _q_launchable(pl, kind, layers, lap):
    """What fused_quotient.cu's entry point checks before it launches."""
    from nnpde_tpu_torch.kernels import _cuda

    seeded = kind.endswith("seeded")
    return (4 <= pl.T <= _cuda.NT // 2 and pl.T % 4 == 0 and 0 <= pl.flags <= 7
            and (seeded or pl.flags == 0)
            and pl.smem >= 4 * tfq.smem_floats(kind, layers, pl.T, lap, pl.flags)
            and pl.smem <= _cuda.SMEM_MAX)


def _budget(share):
    from nnpde_tpu_torch.kernels import _cuda

    return _cuda.SMEM_MAX // share - (0 if share == 1 else 1024)


@pytest.mark.parametrize("kind,net,want", [
    ("linear_seeded", "c64", (16, 73120, "gradient")),
    ("linear_seeded", "u64", (20, 64944, "staged")),
    ("quad_seeded", "c64", (16, 72992, "gradient")),
    ("quad_seeded", "u50", (24, 58320, "staged")),
])
def test_quotient_plan_path_shapes(kind, net, want):
    """The nets the Poisson WAN and the infinite-well DRM run the seeded
    kernels on: three blocks per SM; the gradient row on chip where it fits
    one step below the one-wave tile (the critic: 16 against 20), staged at
    that tile where it does not (u64 at 20, u50 at 24)."""
    from nnpde_tpu_torch.kernels import _plan

    layers = QNETS[net]
    pl = tfq.plan(kind, layers, 0)
    assert (pl.T, pl.smem, pl.tier) == want
    assert pl.flags == dict(_plan.tiers(True))[pl.tier]
    assert 3 * (pl.smem + 1024) <= _plan._cuda.SMEM_MAX
    assert _q_launchable(pl, kind, layers, 0)
    # weights and row together do not leave room for three blocks
    assert 4 * tfq.smem_floats(kind, layers, 16, 0, _plan.RES_WEIGHTS | _plan.RES_GRAD) > _budget(3)


@pytest.mark.parametrize("kind,lap", [("linear_seeded", 0), ("linear_seeded", 1),
                                      ("quad_seeded", 0)])
@pytest.mark.parametrize("net", sorted(QEXTREMES))
def test_quotient_plan_takes_every_shape_the_wrapper_takes(net, kind, lap):
    """Every net the wrapper's check takes gets a plan the kernel takes, in
    the largest share of blocks per SM that any tier fits; a pinned tier
    fits or raises.  (The quadratic kinds carry no Laplacian stream.)"""
    from nnpde_tpu_torch.kernels import _cuda, _plan

    layers = QEXTREMES[net]
    params = [(torch.zeros(a, b), torch.zeros(b)) for a, b in zip(layers[:-1], layers[1:])]
    assert _cuda.net_layers(kind, params, torch.zeros(8, layers[0]), "sin") == list(layers)
    pl = tfq.plan(kind, layers, lap)
    assert _q_launchable(pl, kind, layers, lap) and pl.T % 4 == 0
    share = max(s for s in (3, 2, 1) if pl.smem <= _budget(s))
    S = layers[0] + 1 + lap
    for larger in (3, 2):
        if larger > share:
            assert _plan.fit(lambda t, f: tfq.smem_floats(kind, layers, t, lap, f), layers, S,
                             True, _budget(larger), 16) is None
    for tier, _ in _plan.tiers(True):
        try:
            pinned = tfq.plan(kind, layers, lap, T=16, tier=tier)
        except ValueError:
            continue
        assert pinned.T == 16 and pinned.tier == tier
        assert _q_launchable(pinned, kind, layers, lap)


@pytest.mark.parametrize("kind,net", [("linear_seeded", "c64"), ("quad_seeded", "u50"),
                                      ("linear_seeded", "u64")])
def test_quotient_plan_steps_down_in_order(kind, net):
    """Under a shrinking budget: weights and row resident, then the row
    alone (each one step below the one-wave tile at most), then nothing
    resident, down to 4 points."""
    from nnpde_tpu_torch.kernels import _plan

    layers = QNETS[net]
    order = [name for name, _ in _plan.tiers(True)]
    seen, last = [], None
    for budget in range(_plan._cuda.SMEM_MAX, 8 * 1024, -2048):
        pl = _plan.fit(lambda t, f: tfq.smem_floats(kind, layers, t, 0, f), layers,
                       layers[0] + 1, True, budget, 4)
        if pl is None:
            break
        assert pl.smem <= budget and pl.T % 4 == 0
        key = (order.index(pl.tier), -pl.T)
        assert last is None or key >= last, (budget, pl, last)
        assert pl.T >= 16 or pl.tier == "staged"
        last = key
        if pl.tier not in seen:
            seen.append(pl.tier)
    assert seen == order and last[1] == -4


@pytest.mark.parametrize("kind,lap", [("linear_seeded", 0), ("linear_seeded", 1),
                                      ("quad_seeded", 0)])
@pytest.mark.parametrize("net", sorted(QEXTREMES))
def test_quotient_plan_keeps_the_tile_before_residency(net, kind, lap):
    """A resident tier is taken only within one step (4 points) of the
    one-wave tile; where the plan stages, no resident tier fits there at the
    same share."""
    from nnpde_tpu_torch.kernels import _plan

    layers = QEXTREMES[net]
    S = layers[0] + 1 + lap
    t0 = _plan.tile_for(layers, S)
    pl = tfq.plan(kind, layers, lap)
    share = max(s for s in (3, 2, 1) if pl.smem <= _budget(s))
    if pl.tier != "staged":
        assert max(16, t0 - 4) <= pl.T <= t0
    elif share > 1:
        for _, flags in _plan.tiers(True)[:2]:
            assert all(4 * tfq.smem_floats(kind, layers, t, lap, flags) > _budget(share)
                       for t in range(max(16, t0 - 4), t0 + 1, 4))


@pytest.mark.parametrize("kind", ["linear_sums", "quad_sums"])
def test_quotient_sums_keep_the_constant_tile(kind):
    """The sums kinds (pass A) used to keep a constant 16-point tile; they
    now plan as the jet forward does, by net and
    N (``_plan.forward_only``): a planned design, the hidden weights
    resident or staged (never their transposes, nor a gradient row), and
    the layout's bytes, no longer the constant 16-point tile on u64."""
    from nnpde_tpu_torch.kernels import _cuda, _plan

    for layers in QNETS.values():
        for N in (20000, 40000, 262144):
            pl = tfq.plan(kind, layers, 0, N=N, sms=132)
            assert pl == _plan.forward_only(
                lambda t, f: tfq.smem_floats(kind, layers, t, 0, f), layers, layers[0] + 1,
                f"{kind} plan", N, 132)
            assert pl.design in _cuda.PLANNED_DESIGNS and pl.flags in (0, _plan.RES_WEIGHTS)
            assert pl.smem == 4 * tfq.smem_floats(kind, layers, pl.T, 0, pl.flags)
    assert tfq.plan(kind, QNETS["u64"], 0, N=262144, sms=132).T != 16   # the old tile


def test_quotient_flat_vector_handoff_matches_params_route():
    """The four raw entry points with the parameters already flattened give
    the params route's sums and gradients; the values come from the flat
    vector, the shapes from params."""
    from nnpde_tpu_torch.kernels import _cuda

    d = 2
    rng, pn, X = _case(d, seed=61, N=120)
    tp, Xt = params_from_jax(pn), torch.as_tensor(X)
    lin = torch.as_tensor(rng.normal(size=(X.shape[0], d + 5)).astype(np.float32))
    quad = torch.as_tensor(rng.normal(size=(X.shape[0], d + 3)).astype(np.float32))
    flat = _cuda.flat_params(tp)
    zeros = [(torch.zeros_like(W), torch.zeros_like(b)) for W, b in tp]
    for fn, coef, extra in ((tfq.fused_linear_sums, lin, {"no_lap": True}),
                            (tfq.fused_quad_sums, quad, {})):
        a = fn(tp, Xt, coef, "sin", **extra)
        b = fn(zeros, Xt, coef, "sin", flat=flat, **extra)
        assert all(torch.equal(a[k], b[k]) for k in a if k != "n")
    for fn, coef, scal in ((tfq.fused_seeded_grads, lin, (0.3, -0.2, 0.7)),
                           (tfq.fused_quad_seeded_grads, quad, (0.4, -0.3))):
        ga = fn(tp, Xt, coef, scal, "sin")
        gb = fn(zeros, Xt, coef, scal, "sin", flat=flat)
        assert all(torch.equal(x, y) for pa, pb in zip(ga, gb) for x, y in zip(pa, pb))


@pytest.mark.parametrize("layers,S,T,want", [
    ((2, 64, 64, 1), 3, 16, True),               # the Poisson WAN critic, pass B
    ((2, 64, 64, 64, 64, 1), 4, 16, True),       # the Poisson PINN's fused step
    ((2, 64, 64, 64, 64, 1), 3, 20, False),      # 320 items: two waves
    ((2, 50, 50, 50, 50, 1), 3, 24, False),      # 312 items
    ((2, 50, 50, 50, 50, 1), 4, 16, True),       # 208 items
    ((2, 20, 20, 20, 1), 3, 48, True),           # 240 items
    ((3, 32, 32, 1), 5, 16, False),              # five streams
])
def test_fold_variant_rule(layers, S, T, want):
    """The kernels' FOLD variant (activation in the products' epilogues)
    runs where a point's streams fit its register tile (S <= 4) and the
    (point, 4 units) items are one wave of the block."""
    from nnpde_tpu_torch.kernels import _cuda

    assert _cuda.folds(layers, S, T) is want
