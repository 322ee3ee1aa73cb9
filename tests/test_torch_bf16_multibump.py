"""Rows 11-12 (the K-bump WAN pair) in the bf16-dot mode against the JAX
package on the CPU.

* The two passes with ``dot_dtype='bfloat16'`` (the port's wrappers take
  their plain bf16-dot versions on CPU tensors) against the JAX Pallas
  kernels in interpret mode with ``dot_dtype='bfloat16'``, which honours the
  cast on the CPU: (d, 16, 16, 1) sin nets at twice the default weights, d
  in {1, 2, 3}, K in {1, 4} bumps, N = 256, seed-made coefficient streams
  and seeds.  Each of the 3K pass-A sums, every gradient leaf and sum ct_v
  within 1e-4 norm-relative of JAX (measured: 2.1e-7 to 1.6e-5, the
  largest on pass A's sum r at d = 2, K = 1, whose terms cancel), and the
  result more than 10x that from the port's float32 one (measured: 2.9e-3
  to 0.21).  The sums are compared one by one and pass B from given
  seeds: a quotient amplifies the error of its sums, and the weak sums
  cancel.
* ``make_fused_wan_multi_u`` (value, dE, d phi_norms, every gradient leaf)
  and ``make_fused_wan_multi_v`` in bf16 against JAX's with
  ``dot_dtype='bfloat16'``: within OBJ_TOL = 1e-4 (measured: 4.1e-7 the primal,
  1.6e-6 the critic), which the port's float32 objectives miss by more
  than 10x (measured: 6.7e-3 and 6.5e-3).
* ``make_fused_wan_multi_pair(dot_dtype='bfloat16')`` builds its
  objectives in that mode.

Cost: about 35 s on one worker, most of it the JAX kernels in interpret mode
compiling for each shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.kernels import fused_multibump as jmb
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import fused_multibump as tfm
from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
from nnpde_tpu_torch.ops import bump_grid, bump_w_multi
from nnpde_tpu_torch.problems._fused_wan import make_fused_wan_multi_pair

KW = dict(bwd_tile=128, interpret=True)
TOL = 1e-4
OBJ_TOL = 1e-4
L = 1.5
ACT = "sin"
SUM_KEYS = ("sum_r", "sum_mass", "sum_e2")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _max_rel(a, b):
    return max(_rel(x, y) for x, y in zip(a, b))


def _np(t):
    return np.asarray(t.detach() if torch.is_tensor(t) else t)


def _leaves(grads, *head):
    """``head`` (values) then every gradient leaf, as numpy arrays."""
    return [np.asarray(_np(h), np.float64).reshape(-1) for h in head] + [
        _np(t) for pair in grads for t in pair]


class Case:
    """One seed's inputs, the same numpy arrays for both packages: a (d, 16,
    16, 1) net at twice the default weights (so that the bf16 cast shows in
    every sum), N points in the box, a K-bump coefficient stream (the
    (N, K (d+4)) layout, normal entries) and 3K pass-B seeds."""

    def __init__(self, d, K, seed, N=256, width=16):
        rng = np.random.default_rng(seed)
        self.d, self.K, self.N = d, K, N
        pn = []
        for n_in, n_out in zip((d, width, width), (width, width, 1)):
            bound = 2.0 / np.sqrt(n_in)
            pn.append((rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                       rng.uniform(-bound, bound, (n_out,)).astype(np.float32)))
        self.pn = pn
        self.X = rng.uniform(0.05, L - 0.05, (N, d)).astype(np.float32)
        self.coef = rng.normal(size=(N, K * (d + 4))).astype(np.float32)
        self.scal = [rng.normal(size=K).astype(np.float32) for _ in range(3)]

    def jp(self):
        return [(jnp.asarray(W), jnp.asarray(b)) for W, b in self.pn]

    def tp(self):
        return params_from_jax(self.pn)


def _row(case, kind):
    """(JAX result, port(dot) -> result) of one pass, each a list of arrays:
    the 3K sums one by one, or every gradient leaf (the last bias leaf is
    sum ct_v)."""
    X, Xt = jnp.asarray(case.X), torch.as_tensor(case.X)
    jp, tp, K = case.jp(), case.tp(), case.K
    coef, ct = jnp.asarray(case.coef), torch.as_tensor(case.coef)
    if kind == "multi_sums":
        sj = jmb.fused_multi_sums(jp, X, coef, ACT, K, dot_dtype="bfloat16", **KW)

        def port(dot):
            s = tfm.fused_multi_sums(tp, Xt, ct, ACT, K, dot_dtype=dot)
            return [x for k in SUM_KEYS for x in _np(s[k])]
        return [x for k in SUM_KEYS for x in np.asarray(sj[k])], port
    gj = jmb.fused_multi_seeded_grads(jp, X, coef, tuple(jnp.asarray(s) for s in case.scal), ACT,
                                      K, dot_dtype="bfloat16", **KW)
    sc = tuple(torch.as_tensor(s) for s in case.scal)
    return _leaves(gj), lambda dot: _leaves(tfm.fused_multi_seeded_grads(
        tp, Xt, ct, sc, ACT, K, dot_dtype=dot))


ROWS = [(kind, d, K) for kind in ("multi_sums", "multi_seeded") for d in (1, 2, 3)
        for K in (1, 4)]


@pytest.mark.parametrize("kind,d,K", ROWS)
def test_bf16_k_bump_row_matches_jax_interpret(kind, d, K):
    """Each of rows 11-12 in bf16 within 1e-4 of JAX's interpret mode, sum
    by sum and leaf by leaf, and more than 10x that from the port's float32
    result."""
    case = Case(d, K, seed=120 + 10 * d + K)
    want, port = _row(case, kind)
    got = port("bfloat16")
    assert len(got) == len(want) == (3 * K if kind == "multi_sums" else 6)
    assert _max_rel(got, want) <= TOL
    assert _max_rel(got, port("float32")) > 10 * TOL


# ----------------------------------------------------- the two objectives
def _objective(which, case, dot, jax_side):
    """(values, grads) of one K-bump constructor's objective on the case:
    the primal's value, dE and d phi_norms then its leaves; the critic's
    value then its leaves."""
    K, d = case.K, case.d
    rng = np.random.default_rng(9)
    E = np.float32(0.3)
    pn = (0.5 + rng.uniform(size=K)).astype(np.float32)
    kw = (dict(w_pde=1.0, w_norm=10.0, vol=float(L ** d)) if which == "u"
          else dict(objective="neg_log"))
    if jax_side:
        fn = getattr(jmb, f"make_fused_wan_multi_{which}")(ACT, K, dot_dtype=dot, **kw, **KW)
        X, coef = jnp.asarray(case.X), jnp.asarray(case.coef)
        if which == "u":
            (val, _), (g, gE, gpn) = jax.value_and_grad(
                lambda p, e, q: fn(p, e, X, coef, q), argnums=(0, 1, 2), has_aux=True)(
                    case.jp(), jnp.asarray(E), jnp.asarray(pn))
            return _leaves(g, val, gE, gpn)
        (val, _), g = jax.value_and_grad(lambda p: fn(p, X, coef), has_aux=True)(case.jp())
        return _leaves(g, val)
    fn = getattr(tfm, f"make_fused_wan_multi_{which}")(ACT, K, dot_dtype=dot, **kw)
    tp = [(W.requires_grad_(True), b.requires_grad_(True)) for W, b in case.tp()]
    leaves = [t for pair in tp for t in pair]
    X, coef = torch.as_tensor(case.X), torch.as_tensor(case.coef)
    if which == "u":
        Et = torch.tensor(E, requires_grad=True)
        pnt = torch.as_tensor(pn).requires_grad_(True)
        val, _ = fn(tp, Et, X, coef, pnt)
        g = torch.autograd.grad(val, leaves + [Et, pnt])
        return ([np.asarray(float(val.detach())).reshape(1), _np(g[-2]).reshape(1),
                 _np(g[-1]).astype(np.float64)] + [_np(t) for t in g[:-2]])
    val, _ = fn(tp, X, coef)
    g = torch.autograd.grad(val, leaves)
    return [np.asarray(float(val.detach())).reshape(1)] + [_np(t) for t in g]


@pytest.mark.parametrize("which", ["u", "v"])
def test_bf16_k_bump_objectives_match_jax(which):
    """The K-bump primal and critic in bf16 (pass A's sums form the
    quotients, pass B their gradient), value, dE, d phi_norms and every leaf
    within OBJ_TOL of JAX's, and the port's float32 objective more than 10x
    OBJ_TOL away."""
    case = Case(2, 4, seed=131)
    want = _objective(which, case, "bfloat16", True)
    got = _objective(which, case, "bfloat16", False)
    f32 = _objective(which, case, "float32", False)
    assert len(got) == len(want)
    assert _max_rel(got, want) <= OBJ_TOL
    assert _max_rel(f32, want) > 10 * OBJ_TOL


def test_multi_pair_passes_dot_dtype_to_its_objectives():
    """``make_fused_wan_multi_pair(dot_dtype=...)`` builds its objectives in
    that mode: its primal and critic values are those of the objectives
    built by hand in the mode, and the bf16 pair's differ from the float32
    pair's."""
    d = 2
    case = Case(d, 4, seed=141)
    u = SolutionModel(NetSpec((d, 16, 16, 1), activation=ACT),
                      factor_for_technique("FBC", dim=d, kind="box", L=L))
    v = SolutionModel(NetSpec((d, 16, 16, 1), activation=ACT),
                      factor_for_technique("FBC", dim=d, kind="box", L=L))
    up, vp = case.tp(), params_from_jax([(W[::-1].copy(), b) for W, b in case.pn])
    X = torch.as_tensor(case.X)
    centers, hw = bump_grid(0.0, L, d, 2)
    wv, dwv = bump_w_multi(X, centers, hw)
    K = centers.shape[0]
    E = torch.tensor(0.7)
    out = {}
    for dot in ("bfloat16", "float32"):
        pair = make_fused_wan_multi_pair(u, v, K, w_norm=10.0, vol=L * L, impl="torch",
                                         dot_dtype=dot)
        lu, _ = pair.u_pde_fn(up, E, vp, X, wv, dwv)
        lv, _ = pair.v_loss_fn(vp, up, E, X, wv, dwv)
        coef = pair.v_coef_fn(up, E, X, wv, dwv)
        by_hand = tfm.make_fused_wan_multi_v(ACT, K, dot_dtype=dot)(vp, X, coef)[0]
        assert torch.equal(lv, by_hand)
        out[dot] = (float(lu), float(lv))
    assert out["bfloat16"][0] != out["float32"][0] and out["bfloat16"][1] != out["float32"][1]
