"""Rows 3 and 7-10 in the bf16-dot mode, and ``dot_dtype='bf16x3'`` on
every kernel, against the JAX package on the CPU.

* The bf16-dot mode (``dot_dtype='bfloat16'``) of the Deep-Ritz energy
  (row 3) and the quotients' two passes (rows 7-10; the port's wrappers take
  their plain bf16-dot versions on CPU tensors) against the JAX Pallas
  kernels in interpret mode with ``dot_dtype='bfloat16'``, which honours the
  cast on the CPU: (d, 16, 16, 1) sin nets at twice the default weights, d
  in {1, 2, 3}, N = 256, the linear passes with and without the Laplacian
  stream.  The loss, every sum and every gradient leaf within 1e-4
  norm-relative (measured: 0 to 1.2e-5, the largest on pass B at d = 3,
  where an operand rounds to the other bf16 neighbour under another fp32
  sum order), and the row more than 10x that from the port's float32
  result (measured 1.1e-3 to 8.8e-3: the largest sum or leaf
  difference).  The pass-A sums are compared one by
  one, and pass B from given seeds: a quotient amplifies the error of its
  sums, so whole quotients alone would hide it.
* The four ``make_fused_*`` constructors in bf16, value and gradients,
  against JAX's with ``dot_dtype='bfloat16'``: within OBJ_TOL = 1e-4
  (measured gap 5.5e-7 to 4.9e-5, the WAN critic's log the largest), which
  the port's float32 objective misses by more than 10x (measured 3.9e-3 to
  9.2e-3).
* ``'bf16x3'`` on every kernel (rows 1-12 and the jet pair): the port runs
  the float32 kernels, so its result is bitwise the port's ``'float32'``;
  and it is within 1e-4 of JAX's interpret-mode ``'bf16x3'`` (the
  three-pass split with its lo*lo term dropped; measured 7.7e-7 to
  2.5e-5, the largest on pass A's sum of r, whose terms cancel).
* Rows 11-12 take ``'bfloat16'`` on their raw API, their objectives and
  the multi-bump WAN pair (held to JAX in
  ``tests/test_torch_bf16_multibump.py``); the WAN pair constructors pass
  ``dot_dtype`` to the objectives they build.

Cost: about 55 s on one worker, most of it the JAX kernels in interpret
mode compiling for each shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.kernels import fused_multibump as jmb
from nnpde_tpu.kernels import fused_quotient as jfq
from nnpde_tpu.kernels import fused_step as jfs
from nnpde_tpu.kernels import mlp_fwdlap_pallas
from nnpde_tpu.models import factor_for_technique as j_factor
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import fused_multibump as tfm
from nnpde_tpu_torch.kernels import fused_quotient as tfq
from nnpde_tpu_torch.kernels import fused_step as tfs
from nnpde_tpu_torch.kernels import mlp_fwdlap_kernel
from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
from nnpde_tpu_torch.ops import bump_w
from nnpde_tpu_torch.problems._fused_wan import make_fused_wan_multi_pair, make_fused_wan_pair

KW = dict(bwd_tile=128, interpret=True)
TOL = 1e-4
OBJ_TOL = 1e-4
L = 1.5
ACT = "sin"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _max_rel(a, b):
    return max(_rel(x, y) for x, y in zip(a, b))


def _np(t):
    return np.asarray(t.detach() if torch.is_tensor(t) else t)


def _leaves(grads, *head):
    """``head`` (loss or sums) then every gradient leaf, as numpy arrays."""
    return [np.asarray(_np(h), np.float64).reshape(-1) for h in head] + [
        _np(t) for pair in grads for t in pair]


class Case:
    """One seed's inputs, the same numpy arrays for both packages: a (d, 16,
    16, 1) net at twice the default weights (so that the bf16 cast shows in
    every sum), N points, the DRM, linear-functional (``a`` nonzero) and
    quadratic coefficient streams and pass-B seeds."""

    def __init__(self, d, seed, N=256, width=16):
        rng = np.random.default_rng(seed)
        self.d, self.N = d, N
        pn = []
        for n_in, n_out in zip((d, width, width), (width, width, 1)):
            bound = 2.0 / np.sqrt(n_in)
            pn.append((rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                       rng.uniform(-bound, bound, (n_out,)).astype(np.float32)))
        self.pn = pn
        self.X = rng.uniform(0.05, L - 0.05, (N, d)).astype(np.float32)
        fj = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(self.X))
        f = rng.normal(size=N).astype(np.float32)
        V = (0.5 * np.sum(self.X ** 2, axis=1)).astype(np.float32)
        b0 = 0.5 * rng.normal(size=(N, d)).astype(np.float32)
        phi = rng.normal(size=N).astype(np.float32)
        self.coef = {
            "drm": np.asarray(jfs.drm_coefficients(fj, jnp.asarray(f))),
            "quad": np.asarray(jfq.quotient_coefficients(fj, f=jnp.asarray(f),
                                                         V=jnp.asarray(V))),
            "lin": np.asarray(jfq.linear_functional_coefficients(
                fj, c0=jnp.asarray(V), b0=jnp.asarray(b0), a0=-1.0, rhs=jnp.asarray(f),
                e1=fj.value, e2=fj.value * jnp.asarray(phi))),
        }
        lin0 = self.coef["lin"].copy()
        lin0[:, d + 1] = 0.0                       # a == 0: the no_lap contract
        self.coef["lin0"] = lin0

    def jp(self):
        return [(jnp.asarray(W), jnp.asarray(b)) for W, b in self.pn]

    def tp(self):
        return params_from_jax(self.pn)

    def j(self, name):
        return jnp.asarray(self.coef[name])

    def t(self, name):
        return torch.as_tensor(self.coef[name].copy())


# ------------------------------------------- rows 3 and 7-10 in bf16-dot mode
SUM_KEYS = {"linear_sums": ("sum_r", "sum_r2", "sum_mass", "sum_e2"),
            "quad_sums": ("sum_e", "sum_u2")}
ROWS = ([("drm", d, False) for d in (1, 2, 3)]
        + [(k, d, nl) for k in ("linear_sums", "linear_seeded") for d in (1, 2, 3)
           for nl in (False, True)]
        + [(k, d, False) for k in ("quad_sums", "quad_seeded") for d in (1, 2, 3)])


def _row(case, kind, no_lap):
    """(JAX result, port(dot) -> result) of one row, each a list of arrays:
    [loss, leaves...], the sums one by one, or the seeded leaves."""
    X, Xt = jnp.asarray(case.X), torch.as_tensor(case.X)
    jp, tp = case.jp(), case.tp()
    lin = "lin0" if no_lap else "lin"
    if kind == "drm":
        jl, _, jg = jfs.fused_drm_energy(jp, X, case.j("drm"), ACT, dot_dtype="bfloat16", **KW)

        def port(dot):
            loss, _, g = tfs.fused_drm_energy(tp, Xt, case.t("drm"), ACT, dot_dtype=dot)
            return _leaves(g, loss)
        return _leaves(jg, jl), port
    if kind in SUM_KEYS:
        name = lin if kind == "linear_sums" else "quad"
        jfn, tfn = ((jfq.fused_linear_sums, tfq.fused_linear_sums) if kind == "linear_sums"
                    else (jfq.fused_quad_sums, tfq.fused_quad_sums))
        opt = {"no_lap": no_lap} if kind == "linear_sums" else {}
        sj = jfn(jp, X, case.j(name), ACT, dot_dtype="bfloat16", **opt, **KW)

        def port(dot):
            s = tfn(tp, Xt, case.t(name), ACT, dot_dtype=dot, **opt)
            return [_np(s[k]) for k in SUM_KEYS[kind]]
        return [np.asarray(sj[k]) for k in SUM_KEYS[kind]], port
    if kind == "linear_seeded":
        sc = (0.7, -0.3, 0.2)
        gj = jfq.fused_seeded_grads(jp, X, case.j(lin), sc, ACT, no_lap=no_lap,
                                    dot_dtype="bfloat16", **KW)
        return _leaves(gj), lambda dot: _leaves(tfq.fused_seeded_grads(
            tp, Xt, case.t(lin), sc, ACT, no_lap=no_lap, dot_dtype=dot))
    sc = (0.7, -0.3)
    gj = jfq.fused_quad_seeded_grads(jp, X, case.j("quad"), sc, ACT, dot_dtype="bfloat16", **KW)
    return _leaves(gj), lambda dot: _leaves(tfq.fused_quad_seeded_grads(
        tp, Xt, case.t("quad"), sc, ACT, dot_dtype=dot))


@pytest.mark.parametrize("kind,d,no_lap", ROWS)
def test_bf16_row_matches_jax_interpret(kind, d, no_lap):
    """Each of rows 3 and 7-10 in bf16 within 1e-4 of JAX's interpret mode,
    leaf by leaf and sum by sum, and more than 10x that from the port's
    float32 result."""
    case = Case(d, seed=60 + d)
    want, port = _row(case, kind, no_lap)
    got = port("bfloat16")
    assert len(got) == len(want)
    assert _max_rel(got, want) <= TOL
    assert _max_rel(got, port("float32")) > 10 * TOL


# ------------------------------------------------ the four constructors
def _objective(which, case, dot, jax_side):
    """(value, grads) of one constructor's objective on the case (the port's
    grads as numpy leaves)."""
    d, N = case.d, case.N
    rng = np.random.default_rng(7)
    X = case.X
    if which in ("rayleigh", "quad_mean"):
        coef = case.coef["quad"]
        args = (X, coef)
    elif which == "wan_u":
        base = case.coef["lin0"]
        args = (np.float32(0.3), X, base, np.float32(0.8))
    else:
        args = (X, case.coef["lin0"])
    kw = {"rayleigh": dict(weight=2.0, den_eps=1e-8), "quad_mean": dict(weight=2.0),
          "wan_u": dict(w_pde=1.0, w_norm=10.0, vol=float(L ** d)),
          "wan_v": dict(objective="neg_log")}[which]
    ctor = {"rayleigh": "make_fused_rayleigh", "quad_mean": "make_fused_quad_mean",
            "wan_u": "make_fused_wan_u", "wan_v": "make_fused_wan_v"}[which]
    del rng, N
    if jax_side:
        fn = getattr(jfq, ctor)(ACT, dot_dtype=dot, **kw, **KW)
        ja = [jnp.asarray(a) for a in args]
        (val, _), g = jax.value_and_grad(lambda p: fn(p, *ja), has_aux=True)(case.jp())
        return float(val), _leaves(g)
    fn = getattr(tfq, ctor)(ACT, dot_dtype=dot, **kw)
    tp = [(W.requires_grad_(True), b.requires_grad_(True)) for W, b in case.tp()]
    ta = [torch.as_tensor(np.array(a)) for a in args]
    val, _ = fn(tp, *ta)
    leaves = [t for pair in tp for t in pair]
    g = torch.autograd.grad(val, leaves)
    return float(val.detach()), [_np(t) for t in g]


@pytest.mark.parametrize("which", ["rayleigh", "quad_mean", "wan_u", "wan_v"])
def test_bf16_objectives_match_jax(which):
    """The constructors in bf16 (pass A's sums form the quotient, pass B its
    gradient), value and every leaf within OBJ_TOL of JAX's, and the port's
    float32 objective more than 10x OBJ_TOL away."""
    case = Case(2, seed=71)
    vj, gj = _objective(which, case, "bfloat16", True)
    vt, gt = _objective(which, case, "bfloat16", False)
    v32, g32 = _objective(which, case, "float32", False)
    assert abs(vt - vj) <= OBJ_TOL * abs(vj)
    assert _max_rel(gt, gj) <= OBJ_TOL
    assert max(abs(v32 - vj) / abs(vj), _max_rel(g32, gj)) > 10 * OBJ_TOL


# ------------------------------------------------- bf16x3 on every kernel
def _jet_loss(jet):
    return jet.value.mean() + (jet.lap ** 2).mean() + (jet.grad[:, 0] ** 2).mean()


def _x3_row(row, case):
    """(JAX 'bf16x3' result, port(dot) -> result) of one kernel."""
    X, Xt = jnp.asarray(case.X), torch.as_tensor(case.X)
    jp, tp, d = case.jp(), case.tp(), case.d
    j = dict(dot_dtype="bf16x3", **KW)
    if row == "fused_linear_residual":
        coef = np.concatenate([case.coef["lin"][:, :d + 3], case.coef["lin"][:, d + 3:d + 4]], 1)
        jl, _, jg = jfs.fused_linear_residual(jp, X, jnp.asarray(coef), ACT, **j)
        return _leaves(jg, jl), lambda dot: (lambda o: _leaves(o[2], o[0]))(
            tfs.fused_linear_residual(tp, Xt, torch.as_tensor(coef), ACT, dot_dtype=dot))
    if row == "fused_poisson_analytic":
        jl, _, jg = jfs.fused_poisson_analytic(jp, X, ACT, L=L, ks=(1,) * d, **j)
        return _leaves(jg, jl), lambda dot: (lambda o: _leaves(o[2], o[0]))(
            tfs.fused_poisson_analytic(tp, Xt, ACT, L=L, ks=(1,) * d, dot_dtype=dot))
    if row in ("jet_rows", "jet_streams"):
        (vj, gj) = jax.value_and_grad(lambda p: _jet_loss(mlp_fwdlap_pallas(
            p, X, ACT, fwd_impl="pallas2", tile=128, **j)))(jp)

        def port(dot):
            leaves = [(W.requires_grad_(True), b.requires_grad_(True)) for W, b in case.tp()]
            val = _jet_loss(mlp_fwdlap_kernel(leaves, Xt, ACT,
                                              fwd_impl=row.split("_")[1], dot_dtype=dot))
            g = torch.autograd.grad(val, [t for pair in leaves for t in pair])
            return [np.asarray(float(val.detach())).reshape(1)] + [_np(t) for t in g]
        return [np.asarray(float(vj)).reshape(1)] + [_np(t) for pair in gj for t in pair], port
    if row in ("multi_sums", "multi_seeded"):
        Kb = 3
        rng = np.random.default_rng(3)
        coef = rng.normal(size=(case.N, Kb * (d + 4))).astype(np.float32)
        if row == "multi_sums":
            sj = jmb.fused_multi_sums(jp, X, jnp.asarray(coef), ACT, Kb, **j)
            keys = ("sum_r", "sum_mass", "sum_e2")
            return [np.asarray(sj[k]) for k in keys], lambda dot: [
                _np(tfm.fused_multi_sums(tp, Xt, torch.as_tensor(coef), ACT, Kb,
                                         dot_dtype=dot)[k]) for k in keys]
        sc = tuple(rng.normal(size=Kb).astype(np.float32) for _ in range(3))
        gj = jmb.fused_multi_seeded_grads(jp, X, jnp.asarray(coef), tuple(jnp.asarray(s)
                                                                          for s in sc),
                                          ACT, Kb, **j)
        return _leaves(gj), lambda dot: _leaves(tfm.fused_multi_seeded_grads(
            tp, Xt, torch.as_tensor(coef), tuple(torch.as_tensor(s) for s in sc), ACT, Kb,
            dot_dtype=dot))
    kind = {"fused_drm_energy": "drm"}.get(row, row)
    # rows 3 and 7-10 in bf16x3: as _row, with JAX's three-pass split
    if kind == "drm":
        jl, _, jg = jfs.fused_drm_energy(jp, X, case.j("drm"), ACT, **j)
        return _leaves(jg, jl), lambda dot: (lambda o: _leaves(o[2], o[0]))(
            tfs.fused_drm_energy(tp, Xt, case.t("drm"), ACT, dot_dtype=dot))
    if kind in SUM_KEYS:
        name = "lin" if kind == "linear_sums" else "quad"
        jfn, tfn = ((jfq.fused_linear_sums, tfq.fused_linear_sums) if kind == "linear_sums"
                    else (jfq.fused_quad_sums, tfq.fused_quad_sums))
        sj = jfn(jp, X, case.j(name), ACT, **j)
        return [np.asarray(sj[k]) for k in SUM_KEYS[kind]], lambda dot: [
            _np(tfn(tp, Xt, case.t(name), ACT, dot_dtype=dot)[k]) for k in SUM_KEYS[kind]]
    if kind == "linear_seeded":
        sc = (0.7, -0.3, 0.2)
        gj = jfq.fused_seeded_grads(jp, X, case.j("lin"), sc, ACT, **j)
        return _leaves(gj), lambda dot: _leaves(tfq.fused_seeded_grads(
            tp, Xt, case.t("lin"), sc, ACT, dot_dtype=dot))
    sc = (0.7, -0.3)
    gj = jfq.fused_quad_seeded_grads(jp, X, case.j("quad"), sc, ACT, **j)
    return _leaves(gj), lambda dot: _leaves(tfq.fused_quad_seeded_grads(
        tp, Xt, case.t("quad"), sc, ACT, dot_dtype=dot))


# rows 1-3, the jet pair (4 and 5 through the row forward, 6 and 5 through
# the stream-major one), 7-10, 11-12
X3_ROWS = ("fused_linear_residual", "fused_poisson_analytic", "fused_drm_energy", "jet_rows",
           "jet_streams", "linear_sums", "linear_seeded", "quad_sums", "quad_seeded",
           "multi_sums", "multi_seeded")


@pytest.mark.parametrize("row", X3_ROWS)
def test_bf16x3_runs_float32_and_meets_jax(row):
    """``'bf16x3'`` gives bitwise the port's ``'float32'`` result on every
    kernel, within 1e-4 of JAX's interpret-mode ``'bf16x3'``."""
    case = Case(2, seed=81)
    want, port = _x3_row(row, case)
    got = port("bf16x3")
    assert all(np.array_equal(a, b) for a, b in zip(got, port("float32")))
    assert len(got) == len(want) and _max_rel(got, want) <= TOL


# ------------------------------------------------ rows 11-12 take bfloat16
def test_k_bump_bf16_still_raises_naming_b1():
    """Rows 11-12's bf16-dot mode is ported (the name is the test's from
    before): their raw API, their objectives and the multi-bump WAN pair
    take ``'bfloat16'`` and give the plain bf16-dot versions' results on
    the CPU, apart from the float32 ones; no mode raises naming B1."""
    case = Case(2, seed=1, N=16)
    tp, X = case.tp(), torch.as_tensor(case.X)
    coef = torch.as_tensor(np.random.default_rng(2).normal(size=(16, 12)).astype(np.float32))
    scal = (torch.tensor([0.3, -0.2]), torch.tensor([0.1, 0.2]), torch.tensor([-0.4, 0.5]))
    s = tfm.fused_multi_sums(tp, X, coef, ACT, 2, dot_dtype="bfloat16")
    want = tfm.fused_multi_sums_plain(tp, X, coef, ACT, 2, "bfloat16")
    assert torch.equal(torch.cat([s["sum_r"], s["sum_mass"], s["sum_e2"]]), want)
    assert not torch.equal(want, tfm.fused_multi_sums_plain(tp, X, coef, ACT, 2))
    g = tfm.fused_multi_seeded_grads(tp, X, coef, scal, ACT, 2, dot_dtype="bfloat16")
    dWs, _, sums = tfm.fused_multi_seeded_grads_plain(tp, X, coef, torch.cat(scal), ACT, 2,
                                                      "bfloat16")
    assert torch.equal(g[0][0], dWs[0]) and torch.equal(g[-1][1], sums[0].reshape(1))
    for ctor in (tfm.make_fused_wan_multi_u, tfm.make_fused_wan_multi_v):
        ctor(ACT, 2, dot_dtype="bfloat16")
    model = SolutionModel(NetSpec((2, 8, 1), activation=ACT),
                          factor_for_technique("FBC", dim=2, kind="box", L=L))
    for dot in ("bfloat16", "bf16x3"):
        make_fused_wan_multi_pair(model, model, 2, dot_dtype=dot)


def test_wan_pair_passes_dot_dtype_to_its_objectives():
    """``make_fused_wan_pair(dot_dtype=...)`` builds its objectives in that
    mode: its primal and critic values are those of the objectives built
    by hand in the mode, and the bf16 pair's differ from the float32
    pair's."""
    d = 2
    case = Case(d, seed=91)
    u = SolutionModel(NetSpec((d, 16, 16, 1), activation=ACT),
                      factor_for_technique("FBC", dim=d, kind="box", L=L))
    v = SolutionModel(NetSpec((d, 16, 16, 1), activation=ACT),
                      factor_for_technique("FBC", dim=d, kind="box", L=L))
    up, vp = case.tp(), params_from_jax([(W[::-1].copy(), b) for W, b in case.pn])
    X = torch.as_tensor(case.X)
    wv, dwv = bump_w(X, 0.0, L)
    f = torch.sin(X[:, 0])
    E = torch.tensor(0.0)
    out = {}
    for dot in ("bfloat16", "float32"):
        pair = make_fused_wan_pair(u, v, prefactor=1.0, impl="torch", dot_dtype=dot)
        lu, _ = pair.u_pde_fn(up, E, vp, X, wv, dwv, f=f)
        lv, _ = pair.v_loss_fn(vp, up, E, X, wv, dwv, f=f)
        coef = pair.v_coef_fn(up, E, X, wv, dwv, f=f)
        by_hand = tfq.make_fused_wan_v(ACT, dot_dtype=dot)(vp, X, coef)[0]
        assert torch.equal(lv, by_hand)
        out[dot] = (float(lu), float(lv))
    assert out["bfloat16"][0] != out["float32"][0] and out["bfloat16"][1] != out["float32"][1]
