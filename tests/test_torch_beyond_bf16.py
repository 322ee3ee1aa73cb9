"""The bf16-dot modes of rows 1-5 on nets beyond the other kernels' limits
(``ROADMAP.md`` B7 item 4a) on the CPU: hidden widths above 256, more than
16 weight matrices and d > 16, which the fused residual kernels (rows 1, 2),
the Deep-Ritz energy (row 3) and the jet pair (rows 4, 5; row 4 at d <= 16)
take in ``dot_dtype='bfloat16'``, the bulk of ``compute_dtype=
'hybrid-kernel'``.

Here the port's wrappers take their plain bf16-dot versions (CPU tensors),
and the JAX side runs its Pallas kernels in interpret mode with
``dot_dtype='bfloat16'``, which honours the cast on the CPU, as
``tests/test_torch_wide.py`` and ``tests/test_torch_bf16_quotient.py`` run
them.  Same inputs from a seed for both (the JAX package's initial weights,
numpy points); nets (2, 300, 300, 1), (20, 16, 16, 1) and (2, 8 x 20, 1)
(21 weight matrices), 64 points.

Every result is held three ways:

* to JAX's interpret-mode kernel: every loss, leaf and jet column within
  max(1e-4, 4.2 x the port's own spread on that net; ``ROADMAP.md`` C2's
  bar, 4.2 its measured multiple), the spread being the largest distance
  of the plain version from itself in another sound fp32 rounding order:
  on the net with its hidden units permuted (every product's sum in
  another order), and with the reverse nonlinearity's sum taken in the
  orders of ``ops.fwdlap.DV_ORDERS`` (rows 1-3, 5: the CUDA kernels' and
  the JAX kernels' own, which the permutation does not reach; on (2, 8 x
  20, 1) the Ritz energy's JAX kernel is the plain version in JAX's order
  to 1.3e-7 and 3.1e-4 from it in the port's, one cotangent rounded to the
  other bf16 neighbour at a deep stage: ``ROADMAP.md`` C), and for
  row 2 with its coefficients rounded once from float64
  (``fused_step.ANALYTIC_ORDERS``);
* to JAX's float64 evaluation of the same function without the cast (the
  XLA recurrence ``ops/fwdlap.py::mlp_fwdlap`` and ``jax.grad`` /
  ``jax.vjp`` under ``jax.enable_x64``): no further from it than 2x JAX's
  kernel + 2e-6 (the largest over the leaves or columns);
* to the port's float32 result: more than 10x the first bar from it, which
  shows the cast is honoured.

Rows: 1 and 2 against JAX's ``fused_linear_residual`` /
``fused_poisson_analytic``, 3 against ``fused_drm_energy``, 5 from the
cotangent a linear residual gives the jet against ``jax.vjp`` through
``mlp_fwdlap_pallas(fwd_impl='xla', dot_dtype='bfloat16')``, and 4 on the
two d = 2 nets as
``tests/test_torch_wide.py`` holds it (JAX's ``pallas2:default`` dots are
exact float32 on the CPU and take d <= 6, so row 4 is held to
``_fwd_recompute`` with the bf16 cast over the batch, projected on the last
row).  Then ``train_poisson_nd(compute_dtype='hybrid-kernel')`` for 3
epochs against JAX's ``'pallas-fused'`` run (the Sobol base set, the JAX
package's initial weights for the seed): the first total within 1e-4 at
``dim=17, width=8, depth=3`` on ``'fused'`` and at ``depth=18, width=8`` on
``'fused'`` and ``'kernel'``; at ``dim=17`` on ``'kernel'`` (JAX
``'pallas'``) both packages raise.  Last the plans: ``DES_BEYOND`` on rows
1-3 exactly where ``_cuda.beyond``, none on rows 4, 5, and ``_plan.NoFit``
naming ``ROADMAP.md B7`` where no tile of 8 points fits; and rows 1-3's
launches on a stand-in library, with the plan's design.

The CUDA kernels themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py beyond``).  Cost on the
CPU: about 90 s on one worker, most of it JAX's interpret-mode kernels and
its entry point's compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.kernels import fused_step as jfs
from nnpde_tpu.kernels import fwdlap_pallas as jfp
from nnpde_tpu.models import NetSpec as JNetSpec
from nnpde_tpu.models import factor_for_technique as j_factor
from nnpde_tpu.models.mlp import init_mlp as j_init_mlp
from nnpde_tpu.ops.fwdlap import mlp_fwdlap as j_mlp_fwdlap
from nnpde_tpu.problems.poisson import PoissonConfig as JPoissonConfig
from nnpde_tpu.problems.poisson import train_poisson_nd as j_train_poisson
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import _cuda, _plan
from nnpde_tpu_torch.kernels import fused_step as tfs
from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc
from nnpde_tpu_torch.ops.fwdlap import DV_ORDERS
from nnpde_tpu_torch.problems import PoissonConfig, train_poisson_nd

L = 2.0
TOL = 1e-4
SPREAD_MULTIPLE = 4.2         # ROADMAP.md C2 (tests/test_torch_cuda.py C2_SPREAD_MULTIPLE)
NETS = {"u300": ((2, 300, 300, 1), "sin"), "d20": ((20, 16, 16, 1), "tanh"),
        "k21": ((2,) + (8,) * 20 + (1,), "sin")}
KW = dict(interpret=True, dot_dtype="bfloat16", bwd_tile=128)
FUSED = {"linear": "fused_linear_residual", "analytic": "fused_poisson_analytic",
         "drm": "fused_drm_energy"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _max_rel(a, b):
    return max(_rel(x, y) for x, y in zip(a, b))


def _np(t):
    return np.asarray(t.detach() if torch.is_tensor(t) else t, np.float64)


def _leaves(grads, *head):
    """``head`` (the loss) then every gradient leaf, as float64 arrays."""
    return [_np(h).reshape(-1) for h in head] + [_np(t) for pair in grads for t in pair]


def _cols(rows):
    return [rows[:, c] for c in range(rows.shape[1])]


def _case(net, seed, N=64):
    """The JAX package's initial weights for the net (as its entry points
    draw them), points and a numpy generator from the seed."""
    layers, act = NETS[net]
    rng = np.random.default_rng(seed)
    jp = j_init_mlp(jax.random.PRNGKey(seed), JNetSpec(layers, act))
    pn = [(np.asarray(W), np.asarray(b)) for W, b in jp]
    X = rng.uniform(0.0, L, (N, layers[0])).astype(np.float32)
    return rng, layers, act, pn, jp, X


def _x64(pn, X):
    return ([(jnp.asarray(W, jnp.float64), jnp.asarray(b, jnp.float64)) for W, b in pn],
            jnp.asarray(X, jnp.float64))


def _permuted(tp, layers, seed=23):
    """``tp`` with its hidden units permuted, and the map of a gradient-leaf
    list of the permuted net back to the original's."""
    g = torch.Generator().manual_seed(seed)
    perm = ([torch.arange(layers[0])] + [torch.randperm(w, generator=g) for w in layers[1:-1]]
            + [torch.arange(1)])
    inv = [torch.argsort(p) for p in perm]
    moved = [(W[perm[k]][:, perm[k + 1]].contiguous(), b[perm[k + 1]].contiguous())
             for k, (W, b) in enumerate(tp)]

    def back(leaves):
        out = []
        for k in range(len(tp)):
            out += [leaves[2 * k][inv[k]][:, inv[k + 1]], leaves[2 * k + 1][inv[k + 1]]]
        return out

    return moved, back


def _hold(got, kernel, witness, f32, spread):
    """The three bars of the module docstring on lists of arrays."""
    bar = max(TOL, SPREAD_MULTIPLE * spread)
    assert _max_rel(got, kernel) <= bar
    assert _max_rel(got, witness) <= 2.0 * _max_rel(kernel, witness) + 2e-6
    assert _max_rel(got, f32) > 10 * bar


# ------------------------------------------------------------ rows 1, 2, 3
def _fused_port(kind, tp, Xt, coef, act, ks):
    """The port's fused wrapper of ``kind`` on these params: ``dot`` ->
    [loss, leaves...] as torch tensors; with ``order`` its plain bf16-dot
    version with the reverse nonlinearity's sum in that order."""
    N = Xt.shape[0]

    def run(dot, params=tp, order=None):
        if order is not None:
            if kind == "linear":
                out = tfs.linear_residual_plain(params, Xt, coef, act, dot, order)
            elif kind == "analytic":
                out = tfs.poisson_analytic_plain(params, Xt, act,
                                                 tfs.PoissonSinCoef(L, ks, a0=-1.0), dot, order)
            else:
                out = tfs.drm_energy_plain(params, Xt, coef, act, dot, order)
            dWs, dbs, sums = out
            g = tfs._scaled_grads(params, dWs, dbs, sums, (1.0 if kind == "drm" else 2.0) / N)
            return [(sums[0] / N).reshape(1)] + [t for pair in g for t in pair]
        if kind == "linear":
            loss, _, g = tfs.fused_linear_residual(params, Xt, coef, act, dot_dtype=dot)
        elif kind == "analytic":
            loss, _, g = tfs.fused_poisson_analytic(params, Xt, act, L=L, ks=ks, dot_dtype=dot)
        else:
            loss, _, g = tfs.fused_drm_energy(params, Xt, coef, act, dot_dtype=dot)
        return [loss.reshape(1)] + [t for pair in g for t in pair]
    return run


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("kind", sorted(FUSED))
def test_fused_rows_bf16_match_jax(kind, net):
    """Rows 1, 2 and 3 bf16: the loss and every gradient leaf."""
    rng, layers, act, pn, jp, X = _case(net, seed=51)
    d = layers[0]
    tp, Xt = params_from_jax(pn), torch.as_tensor(X)
    ks = tuple(1 + i % 3 for i in range(d))
    fj = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(X))
    f = rng.normal(size=X.shape[0]).astype(np.float32)
    if kind == "linear":
        coef = rng.normal(size=(X.shape[0], d + 4)).astype(np.float32)
        lj, _, gj = jax.jit(lambda p, x, cf: jfs.fused_linear_residual(p, x, cf, act, **KW))(
            jp, jnp.asarray(X), jnp.asarray(coef))
    elif kind == "analytic":
        coef = None
        lj, _, gj = jax.jit(lambda p, x: jfs.fused_poisson_analytic(p, x, act, L=L, ks=ks,
                                                                    **KW))(jp, jnp.asarray(X))
    else:
        coef = np.asarray(jfs.drm_coefficients(fj, jnp.asarray(f)))
        lj, _, gj = jax.jit(lambda p, x, cf: jfs.fused_drm_energy(p, x, cf, act, **KW))(
            jp, jnp.asarray(X), jnp.asarray(coef))
    with jax.enable_x64(True):
        p64, X64 = _x64(pn, X)
        if kind == "drm":
            c64 = jnp.asarray(coef, jnp.float64)
            B, dB, fv = c64[:, 0], c64[:, 1:1 + d], c64[:, d + 1]

            def loss(p):
                jet = j_mlp_fwdlap(p, X64, act)
                G = B[:, None] * jet.grad + dB * jet.value[:, None]
                return jnp.mean(0.5 * jnp.sum(G * G, 1) - fv * B * jet.value)
        else:
            if kind == "linear":
                c64 = jnp.asarray(coef, jnp.float64)
                c, b, a, rhs = c64[:, 0], c64[:, 1:1 + d], c64[:, d + 1], c64[:, d + 2]
            else:
                c, bs, a, rhs = jfs._poisson_sin_coef_builder(L, ks)(X64)
                c, b, a, rhs = c[:, 0], jnp.concatenate(bs, 1), a[:, 0], rhs[:, 0]

            def loss(p):
                jet = j_mlp_fwdlap(p, X64, act)
                r = c * jet.value + jnp.sum(b * jet.grad, 1) + a * jet.lap + rhs
                return jnp.mean(r * r)

        lw, gw = jax.jit(jax.value_and_grad(loss))(p64)
        witness = _leaves(gw, lw)
    port = _fused_port(kind, tp, Xt, None if coef is None else torch.as_tensor(coef), act, ks)
    got = [_np(t) for t in port("bfloat16")]
    moved, back = _permuted(tp, layers)
    other = port("bfloat16", moved)
    variants = [[_np(other[0])] + [_np(t) for t in back(other[1:])]]
    orders = tfs.ANALYTIC_ORDERS if kind == "analytic" else DV_ORDERS
    variants += [[_np(t) for t in port("bfloat16", order=o)] for o in orders]
    spread = max(_max_rel(v, got) for v in variants)
    _hold(got, _leaves(gj, lj), witness, [_np(t) for t in port("float32")], spread)


# ------------------------------------------------------------------- row 5
@pytest.mark.parametrize("net", sorted(NETS))
def test_jet_backward_bf16_matches_jax_vjp(net):
    """Row 5 bf16: every gradient leaf from the cotangent the hybrid-kernel
    bulk gives the jet, ``r (c, b, a)`` of a linear residual ``r`` with
    random coefficients on the float32 jet."""
    rng, layers, act, pn, jp, X = _case(net, seed=53)
    d = layers[0]
    coef = torch.as_tensor(rng.normal(size=(X.shape[0], d + 4)).astype(np.float32))
    jet = tfc.fwdlap_forward_plain(params_from_jax(pn), torch.as_tensor(X), act)
    r = (coef[:, 0] * jet.value + torch.sum(coef[:, 1:1 + d] * jet.grad, dim=1)
         + coef[:, d + 1] * jet.lap + coef[:, d + 2])
    ct = (r[:, None] * coef[:, :d + 2]).numpy()

    def pullback(jet_fn, p, x, c):
        rows = lambda q: (lambda j: jnp.concatenate([j.value[:, None], j.grad,
                                                     j.lap[:, None]], 1))(jet_fn(q, x))
        return jax.vjp(rows, p)[1](c)[0]

    gj = jax.jit(lambda p, x, c: pullback(
        lambda q, y: jfp.mlp_fwdlap_pallas(q, y, act, fwd_impl="xla", tile=128, **KW),
        p, x, c))(jp, jnp.asarray(X), jnp.asarray(ct))
    with jax.enable_x64(True):
        p64, X64 = _x64(pn, X)
        gw = jax.jit(lambda p, x, c: pullback(lambda q, y: j_mlp_fwdlap(q, y, act), p, x, c))(
            p64, X64, jnp.asarray(ct, jnp.float64))
        witness = _leaves(gw)
    tp, Xt, Ct = params_from_jax(pn), torch.as_tensor(X), torch.as_tensor(ct)

    def port(dot, params=tp, order=None):
        dWs, dbs = tfc.fwdlap_backward_plain(params, Xt, Ct, act, dot, order)
        return [_np(t) for pair in zip(dWs, dbs) for t in pair]

    got = port("bfloat16")
    moved, back = _permuted(tp, layers)
    dWs, dbs = tfc.fwdlap_backward_plain(moved, Xt, Ct, act, "bfloat16")
    variants = [[_np(t) for t in back([t for pair in zip(dWs, dbs) for t in pair])]]
    variants += [port("bfloat16", order=o) for o in DV_ORDERS]
    spread = max(_max_rel(v, got) for v in variants)
    _hold(got, _leaves(gj), witness, port("float32"), spread)


# ------------------------------------------------------------------- row 4
@pytest.mark.parametrize("net", ["u300", "k21"])
def test_jet_forward_bf16_matches_jax_recompute(net):
    """Row 4 bf16 (``fwd_impl='rows:default'``) on the d = 2 nets: every
    jet column against JAX's bf16 recompute over the batch, projected on
    the last row in float32 (what ``pallas2:default`` computes on a TPU).
    Through ``mlp_fwdlap_kernel``, as the ``kernel`` route's bulk runs it."""
    _, layers, act, pn, jp, X = _case(net, seed=54)
    d, N = layers[0], X.shape[0]
    Ws = [jnp.asarray(W) for W, _ in pn]
    bs = [jnp.asarray(b).reshape(1, -1) for _, b in pn]
    _, _, final = jfp._fwd_recompute(
        d, len(Ws), N, act, True, lambda x: x.astype(jnp.bfloat16),
        jax.lax.Precision.DEFAULT, jnp.asarray(X), Ws[:-1], bs[:-1], False)
    A, Jm, lm = final[4], final[5], final[6]
    row = Ws[-1].reshape(1, -1)
    kernel = np.concatenate(
        [np.asarray(jnp.sum(A * row, 1) + bs[-1][0, 0])[:, None]]
        + [np.asarray(jnp.sum(j * row, 1))[:, None] for j in Jm]
        + [np.asarray(jnp.sum(lm * row, 1))[:, None]], 1)
    with jax.enable_x64(True):
        jet = jax.jit(lambda p, x: j_mlp_fwdlap(p, x, act))(*_x64(pn, X))
        witness = np.concatenate([np.asarray(jet.value)[:, None], np.asarray(jet.grad),
                                  np.asarray(jet.lap)[:, None]], 1)
    tp, Xt = params_from_jax(pn), torch.as_tensor(X)

    def port(impl, params=tp):
        j = tfc.mlp_fwdlap_kernel(params, Xt, act, impl)
        return torch.cat([j.value[:, None], j.grad, j.lap[:, None]], 1).numpy()

    got = port("rows:default")
    spread = _max_rel(_cols(port("rows:default", _permuted(tp, layers)[0])), _cols(got))
    _hold(_cols(got), _cols(kernel), _cols(witness), _cols(port("rows")), spread)


# ------------------------------------------------------------ entry points
@pytest.mark.parametrize("shape,route", [(dict(dim=17, width=8, depth=3), "fused"),
                                         (dict(depth=18, width=8), "fused"),
                                         (dict(depth=18, width=8), "kernel")])
def test_hybrid_kernel_entry_point_matches_jax(shape, route):
    """``train_poisson_nd(compute_dtype='hybrid-kernel')`` on a net with d
    = 17 or with 18 weight matrices, 3 epochs (2 in the bf16-dot bulk) on
    the Sobol base set: the first total within 1e-4 of JAX's
    ``'pallas-fused'`` run's (JAX's ``'pallas'`` bulk forward is exact
    float32 on the CPU, so both port routes are held to its fused one), the
    history finite."""
    base = dict(shape, epochs=3, chunk=3, n_interior=64, n_eval=64, sampler="sobol", seed=3,
                compute_dtype="hybrid-kernel")
    want = np.asarray(j_train_poisson(JPoissonConfig(**base, jet_impl="pallas-fused"))
                      ["history"]["total"], np.float64)
    got = np.asarray(train_poisson_nd(PoissonConfig(**base, jet_impl=route), device="cpu")
                     ["history"]["total"], np.float64)
    assert got.shape == want.shape == (3,) and np.all(np.isfinite(got))
    assert abs(got[0] - want[0]) <= TOL * abs(want[0])


def test_hybrid_kernel_jet_route_raises_above_d16():
    """At d = 17 the bf16-dot jet forward raises in both packages: JAX's
    ``pallas2:default`` takes d <= 6, the port's d <= 16, naming JAX's
    limit."""
    base = dict(dim=17, width=8, depth=3, epochs=3, chunk=3, n_interior=64, n_eval=64,
                sampler="sobol", seed=3, compute_dtype="hybrid-kernel")
    with pytest.raises(ValueError, match="input dim <= 6"):
        j_train_poisson(JPoissonConfig(**base, jet_impl="pallas"))
    with pytest.raises(ValueError, match=r"fwdlap_forward\.bf16: the kernel takes d from 1 to "
                                         r"16 \(the JAX package's _forward_kernel2"):
        train_poisson_nd(PoissonConfig(**base, jet_impl="kernel"), device="cpu")


# ------------------------------------------------------------------ plans
# (T, tier) of the five bf16-dot rows' plans on the B7 nets of chip_smoke.py
# (rows 1, 2 / row 3 / row 5 / row 4); row 4 takes no net with d > 16
BEYOND_PLANS = {
    (2, 512, 512, 512, 512, 1): ((16, "device"), (16, "device"), (16, "device"),
                                 (16, "device")),
    (20, 64, 64, 64, 64, 1): ((16, "weights"), (16, "gradient"), (16, "gradient"), None),
    (2,) + (64,) * 23 + (1,): ((16, "staged"), (16, "staged"), (16, "staged"),
                               (16, "staged")),
    (1, 1001, 300, 1): ((8, "device"), (16, "device"), (8, "device"), (16, "device")),
    (18, 128, 128, 1): ((8, "weights"), (8, "weights"), (8, "weights"), None),
}


@pytest.mark.parametrize("layers", sorted(BEYOND_PLANS))
def test_beyond_bf16_plans(layers):
    """The bf16-dot rows' plans on the B7 nets: rows 1-3 in the
    ``DES_BEYOND`` variant exactly where ``_cuda.beyond``, rows 4 and 5 in
    the design as it is; each plan's bytes its kernel's layout, within the
    card's shared memory; a launch's design the plan's with ``DES_WIDE``
    above width 128 or with the weights in device memory.  Row 4 above d =
    16 raises naming JAX's limit."""
    beyond = _cuda.beyond(layers)
    fused, drm, bwd, fwd = BEYOND_PLANS[layers]
    for kind, want in (("fused_linear_residual", fused), ("fused_poisson_analytic", fused),
                       ("fused_drm_energy", drm), ("fwdlap_backward", bwd),
                       ("fwdlap_forward", fwd)):
        if want is None:
            with pytest.raises(ValueError, match="_forward_kernel2"):
                tfs.mma_plan(kind, layers)
            continue
        pl = tfs.mma_plan(kind, layers)
        assert (pl.T, pl.tier) == want, kind
        assert pl.design == _cuda.DES_MMA | (
            _cuda.DES_BEYOND if beyond and kind.startswith("fused") else 0), kind
        assert pl.smem == tfs.mma_smem_bytes(layers, pl.T, pl.flags, kind) <= _cuda.SMEM_MAX
        des = tfs.mma_des(layers, pl.flags, pl.design)
        assert bool(des & _cuda.DES_WIDE) == (max(layers[1:-1]) > 128
                                              or bool(pl.flags & _plan.DEV_WEIGHTS))
        if kind.startswith("fused"):
            assert tfs.plan(kind, layers, _cuda.DES_MMA) == pl


@pytest.mark.parametrize("kind", ["fused_linear_residual", "fused_poisson_analytic",
                                  "fused_drm_energy", "fwdlap_backward", "fwdlap_forward"])
def test_nets_whose_stages_fit_no_bf16_tile_raise_nofit(kind):
    """(20, 512 x 4, 1): no tile of 8 points of the tensor-core design fits
    its stages, so the plan raises ``NoFit`` naming the roadmap item of the
    stages in device memory; row 4, which takes d <= 16, on (16, 512 x 4,
    1), and on (20, 512 x 4, 1) raises naming JAX's limit."""
    layers = (20, 512, 512, 512, 512, 1)
    if kind == "fwdlap_forward":
        with pytest.raises(ValueError, match="_forward_kernel2"):
            tfs.mma_plan(kind, layers)
        layers = (16,) + layers[1:]
    with pytest.raises(_plan.NoFit, match=r"no tile of 8 points fits \(stages in device "
                                          r"memory: ROADMAP.md B7\)"):
        tfs.mma_plan(kind, layers)


@pytest.mark.parametrize("layers", [(2, 300, 300, 1), (20, 16, 16, 1), (2,) + (8,) * 20 + (1,)])
@pytest.mark.parametrize("kind", ["fused_linear_residual", "fused_poisson_analytic",
                                  "fused_drm_energy"])
def test_bf16_fused_launch_takes_the_beyond_variant(monkeypatch, kind, layers):
    """Rows 1-3 bf16 launch with the plan's design and the wide bit where
    the net needs it (``DES_BEYOND`` exactly where ``_cuda.beyond``), their
    tile and flags passed through, counted under ``<kernel>.bf16``; a
    pinned plan of the other variant raises before any launch.  The
    library and the card are stood in for (the arguments are recorded)."""
    from nnpde_tpu_torch.kernels import _build

    calls = []

    class Lib:
        def __getattr__(self, name):
            return name

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(_cuda, "grid", lambda name, query, smem, dev, n, key=0: 1)
    monkeypatch.setattr(_cuda, "stream", lambda dev: 0)
    monkeypatch.setattr(_cuda, "launch", lambda name, fn, *args, dev, keep=(): calls.append(
        (name, fn, args)))
    d = layers[0]
    params = [(torch.zeros(a, b), torch.zeros(b)) for a, b in zip(layers[:-1], layers[1:])]
    X = torch.rand(40, d)
    coef = torch.zeros(40, d + (2 if kind == "fused_drm_energy" else 4))
    analytic = tfs._analytic_args(tfs.PoissonSinCoef(L, (1,) * d), d)
    arg_coef = None if kind == "fused_poisson_analytic" else coef
    tfs._launch(kind, params, X, arg_coef, "sin", analytic, bf16=True)
    (name, fn, args), = calls
    assert (name, fn) == (kind + ".bf16", kind + "_f32")
    at = 9 if kind == "fused_poisson_analytic" else 10      # fold, bf16, des, flags
    pl = tfs.mma_plan(kind, layers)
    assert args[at:at + 4] == (0, 1, tfs.mma_des(layers, pl.flags, pl.design), pl.flags)
    assert bool(args[at + 2] & _cuda.DES_BEYOND) == _cuda.beyond(layers)
    assert args[at - 2] == pl.T
    with pytest.raises(ValueError, match="DES_BEYOND"):
        tfs._launch(kind, params, X, arg_coef, "sin", analytic, bf16=True,
                    pl=pl._replace(design=pl.design ^ _cuda.DES_BEYOND))
    assert len(calls) == 1
