"""Nets beyond the bf16-dot modes' limits on the CPU for the K-bump WAN pair
(rows 11, 12) and the stream-major jet forward (row 6): hidden widths above
256, more than 16 weight matrices and d > 16 (``ROADMAP.md`` B7), as
``tests/test_torch_beyond.py`` and ``tests/test_torch_beyond_quotient.py``
hold the other fp32 rows.

Here the port's wrappers take their plain versions (CPU tensors), and the
JAX side runs its Pallas kernels in interpret mode, as
``tests/test_torch_fused_multibump.py`` runs them.  Same inputs from a seed
for both (the JAX package's initial weights, numpy points, coefficients and
seeds); nets (2, 300, 300, 1), (20, 16, 16, 1) and (2, 8 x 20, 1) (21
weight matrices), 64 points.

Every result is held twice, by the rule of ``tests/test_torch_beyond.py``:
to JAX's Pallas kernel and to JAX's float64 evaluation of the same function
(the XLA recurrence ``ops/fwdlap.py::mlp_fwdlap`` and ``jax.grad`` under
``jax.enable_x64``).  The port's float32 result within rel 1e-5 of the
float64 one, and within 1e-5 of the kernel's beyond the kernel's own
distance from it, on every gradient leaf and jet column; each pass-A sum by
the same rule over the float64 sum of its terms' magnitudes (a sum of terms
of either sign may cancel far below its terms).

* Rows 11 and 12: ``fused_multi_sums``' 3 K sums and
  ``fused_multi_seeded_grads``' every leaf (the last bias's is ``sum
  ct_v``) at K = 4 and 16 bumps (~3-11 s a net and K: JAX's interpret-mode
  kernels).
* Row 6: every jet column of the stream-major forward against JAX's
  ``fwd_impl='pallas'`` (``_forward_kernel``) on the three nets, and
  against the float64 recurrence on them and on the ragged (1, 1001, 300,
  1), which JAX's ``_forward_kernel`` does not take (its reshape needs equal
  hidden widths: ``ROADMAP.md`` C, "JAX-side findings").
* ``train_ipw_2d`` on (2, 8 x 20, 1) (the critic (2, 8, 8, 1)), 12 x 12 grid
  points, 3 epochs, from the JAX package's initial weights: the port's
  ``fused`` 4-bump WAN (rows 11, 12) against JAX's ``'pallas-fused'`` run
  and its ``kernel:streams`` PINN (rows 6, 5) against JAX's ``'pallas'``:
  the first total within 1e-5 (relative) (~5-20 s a case, most of it JAX's
  compiles).
* The plans of the B7 nets for both passes (pass B in its ``DES_BEYOND``
  design exactly where the net needs it, pass A as it is, the weights in
  device memory where the staging matrix does not fit), row 6's plan, and
  ``_plan.NoFit`` naming ``ROADMAP.md B7`` for (20, 512 x 4, 1) (~0.1 s).

The CUDA kernels themselves are held to their float64 plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py beyond``).  Cost on the
CPU: about 75 s on one worker, two thirds of it JAX's interpret-mode
kernels and compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.kernels import fused_multibump as jmb
from nnpde_tpu.kernels.fwdlap_pallas import mlp_fwdlap_pallas
from nnpde_tpu.models import NetSpec as JNetSpec
from nnpde_tpu.models import SolutionModel as JSolutionModel
from nnpde_tpu.models.mlp import init_mlp as j_init_mlp
from nnpde_tpu.ops.fwdlap import mlp_fwdlap as j_mlp_fwdlap
from nnpde_tpu.problems.ipw2d import IPW2DConfig as JConfig
from nnpde_tpu.problems.ipw2d import train_ipw_2d as j_train
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import _cuda, _plan
from nnpde_tpu_torch.kernels import fused_multibump as tmb
from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc
from nnpde_tpu_torch.kernels import mlp_fwdlap_kernel
from nnpde_tpu_torch.problems import IPW2DConfig, train_ipw_2d

L = 2.0
TOL = 1e-5
NETS = {"u300": ((2, 300, 300, 1), "sin"), "d20": ((20, 16, 16, 1), "tanh"),
        "k21": ((2,) + (8,) * 20 + (1,), "sin")}
RAGGED = ((1, 1001, 300, 1), "tanh")
KW = dict(interpret=True, dot_dtype="float32", bwd_tile=128)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _case(net, seed, nc=0, N=64):
    """The JAX package's initial weights for the net (as its entry points
    draw them), points inside the box and ``nc`` coefficient columns from
    the seed."""
    layers, act = NETS[net] if isinstance(net, str) else net
    rng = np.random.default_rng(seed)
    jp = j_init_mlp(jax.random.PRNGKey(seed), JNetSpec(layers, act))
    pn = [(np.asarray(W), np.asarray(b)) for W, b in jp]
    X = rng.uniform(0.05, L - 0.05, (N, layers[0])).astype(np.float32)
    coef = rng.normal(size=(N, nc)).astype(np.float32)
    return rng, layers, act, pn, jp, X, coef


def _close(got, kernel, witness):
    """The port's float32 ``got`` within TOL of JAX's float64 ``witness``,
    and within TOL of JAX's float32 ``kernel`` beyond the kernel's own
    distance from the witness (no kernel: the witness alone)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    assert _rel(got, witness) <= TOL
    if kernel is not None:
        assert _rel(got, kernel) <= TOL + _rel(kernel, witness)


def _x64(pn, *arrays):
    return ([(jnp.asarray(W, jnp.float64), jnp.asarray(b, jnp.float64)) for W, b in pn],
            *[jnp.asarray(a, jnp.float64) for a in arrays])


def _multi_terms64(jet, c64, K, d):
    """Per point and bump, in float64: ``r_k``, ``(e1_k v)^2``, ``e2_k v``
    (the layout of ``pack_multibump_coefficients``)."""
    blk = d + 2
    body = c64[:, :K * blk].reshape(-1, K, blk)
    e1, e2 = c64[:, K * blk:K * blk + K], c64[:, K * blk + K:K * blk + 2 * K]
    v = jet.value[:, None]
    r = body[:, :, 0] * v + jnp.sum(body[:, :, 1:1 + d] * jet.grad[:, None, :], 2) \
        + body[:, :, d + 1]
    return r, (e1 * v) ** 2, e2 * v


# ------------------------------------------------------ rows 11 and 12
@pytest.mark.parametrize("Kb", [4, 16])
@pytest.mark.parametrize("net", sorted(NETS))
def test_multi_pair_matches_jax(net, Kb):
    """Rows 11 and 12: pass A's 3 K sums (each over the sum of its terms'
    magnitudes) and pass B's every gradient leaf, the last bias's being
    ``sum ct_v``."""
    d = NETS[net][0][0]
    rng, layers, act, pn, jp, X, coef = _case(net, 61 + Kb, Kb * (d + 4))
    scal = tuple(rng.normal(size=Kb).astype(np.float32) / (Kb * X.shape[0]) for _ in range(3))
    Xj, cj = jnp.asarray(X), jnp.asarray(coef)
    sj = jax.jit(lambda p, x, c: jmb.fused_multi_sums(p, x, c, act, Kb, **KW))(jp, Xj, cj)
    gj = jax.jit(lambda p, x, c: jmb.fused_multi_seeded_grads(
        p, x, c, tuple(jnp.asarray(s) for s in scal), act, Kb, **KW))(jp, Xj, cj)
    tp, Xt, Ct = params_from_jax(pn), torch.as_tensor(X), torch.as_tensor(coef)
    st = tmb.fused_multi_sums(tp, Xt, Ct, act, Kb)
    gt = tmb.fused_multi_seeded_grads(tp, Xt, Ct, tuple(torch.as_tensor(s) for s in scal), act,
                                      Kb)
    with jax.enable_x64(True):
        p64, X64, c64 = _x64(pn, X, coef)

        def terms(p):
            return _multi_terms64(j_mlp_fwdlap(p, X64, act), c64, Kb, d)

        def seeded(p):
            r, mass, lin = terms(p)
            s_r, s_q, s_l = (jnp.asarray(s, jnp.float64) for s in scal)
            return jnp.sum(r @ s_r + mass @ s_q + lin @ s_l)

        tw = [np.asarray(t) for t in jax.jit(terms)(p64)]
        gw = [(np.asarray(W), np.asarray(b)) for W, b in jax.jit(jax.grad(seeded))(p64)]
    for key, t in zip(("sum_r", "sum_mass", "sum_e2"), tw):
        w, scale = np.sum(t, 0), np.sum(np.abs(t), 0)
        g, k = st[key].numpy().astype(np.float64), np.asarray(sj[key], np.float64)
        assert np.all(np.abs(g - w) <= TOL * scale), key
        assert np.all(np.abs(g - k) <= TOL * scale + np.abs(k - w)), key
    for g, k, w in zip(gt, gj, gw):
        for a, b, c in zip(g, k, w):
            _close(a, np.asarray(b), c)


# ------------------------------------------------------------------ row 6
@pytest.mark.parametrize("net", sorted(NETS) + ["ragged"])
def test_stream_major_forward_matches_jax(net):
    """Row 6: every column of the stream-major jet forward, against JAX's
    ``_forward_kernel`` (``fwd_impl='pallas'``) where it takes the net and
    against the float64 recurrence everywhere."""
    _, layers, act, pn, jp, X, _ = _case(RAGGED if net == "ragged" else net, 71)
    jet = mlp_fwdlap_kernel(params_from_jax(pn), torch.as_tensor(X), act, fwd_impl="streams")
    got = torch.cat([jet.value[:, None], jet.grad, jet.lap[:, None]], 1).numpy()

    def rows(j):
        return jnp.concatenate([j.value[:, None], j.grad, j.lap[:, None]], 1)

    kernel = None
    if net != "ragged":
        kernel = np.asarray(jax.jit(lambda p, x: rows(mlp_fwdlap_pallas(
            p, x, act, fwd_impl="pallas", tile=128, **KW)))(jp, jnp.asarray(X)))
    with jax.enable_x64(True):
        witness = np.asarray(jax.jit(lambda p, x: rows(j_mlp_fwdlap(p, x, act)))(
            *_x64(pn, X)))
    for c in range(layers[0] + 2):
        _close(got[:, c], None if kernel is None else kernel[:, c], witness[:, c])


# ---------------------------------------------------------- entry points
DEEP = (2,) + (8,) * 20 + (1,)
CRITIC = (2, 8, 8, 1)
ENTRY = dict(nx=2, ny=2, technique="FN", layers=DEEP, v_layers=CRITIC, v_steps=2, grid_n=12,
             data_grid_n=8, n_boundary=12, epochs=3, chunk=3, seed=0)


@pytest.mark.parametrize("case,j_impl,t_impl", [
    (dict(method="WAN", n_test_grid=2), "pallas-fused", "fused"),
    (dict(method="PINN", weights={"data": 1e4}), "pallas", "kernel:streams")])
def test_entry_point_first_total_matches_jax(case, j_impl, t_impl):
    """``train_ipw_2d`` on nets of 21 weight matrices: the port's fused
    4-bump WAN (rows 11, 12 on the plain route) and its ``kernel:streams``
    PINN (rows 6, 5) against JAX's own Pallas routes, from the same initial
    weights: the first total within 1e-5."""
    kw = dict(ENTRY, **case)
    key = jax.random.PRNGKey(7)
    ju = JSolutionModel(JNetSpec(DEEP, activation="sin"), None).init(key)
    jv = JSolutionModel(JNetSpec(CRITIC, activation="sin"), None).init(
        jax.random.fold_in(key, 9))
    want = np.asarray(j_train(JConfig(jet_impl=j_impl, **kw), init_params=ju,
                              init_v_params=jv)["history"]["total"], np.float64)
    assert want.shape == (3,) and np.all(np.isfinite(want))
    to_np = lambda p: [(np.array(W), np.array(b)) for W, b in p]
    got = np.asarray(train_ipw_2d(IPW2DConfig(jet_impl=t_impl, **kw),
                                  init_params=params_from_jax(to_np(ju)),
                                  init_v_params=params_from_jax(to_np(jv)),
                                  device="cpu")["history"]["total"], np.float64)
    assert np.all(np.isfinite(got))
    assert abs(got[0] - want[0]) <= TOL * abs(want[0])


# ------------------------------------------------------------------ plans
# (T, tier) of pass A and pass B at 16 bumps, and of the stream-major
# forward at the 2D well's 20000 points: chip_smoke.py's beyond nets and
# the nets above
BEYOND_PLANS = {
    (2, 512, 512, 512, 512, 1): ((16, "device"), (12, "device"), (12, "device")),
    (1, 1001, 300, 1): ((12, "device"), (8, "device"), (8, "device")),
    (18, 128, 128, 1): ((4, "staged"), (4, "staged"), (8, "resident")),
    (20, 64, 64, 64, 64, 1): ((16, "staged"), (8, "staged"), (16, "resident")),
    (2,) + (32,) * 23 + (1,): ((40, "staged"), (40, "staged"), (32, "staged")),
    (2, 300, 300, 1): ((16, "device"), (16, "device"), (16, "device")),
    (20, 16, 16, 1): ((16, "resident"), (16, "resident"), (20, "resident")),
    DEEP: ((48, "resident"), (48, "resident"), (48, "resident")),
}


@pytest.mark.parametrize("layers", sorted(BEYOND_PLANS))
def test_beyond_plans(layers):
    """The B7 nets' plans: pass B in its ``DES_BEYOND`` design exactly where
    the net needs one (a width above 256 or d > 16; the deep narrow nets keep
    the other designs), pass A and row 6 as they are; the weights in device
    memory where no staging matrix fits beside a tile (every hidden-to-hidden
    width above 256); each plan's bytes its kernel's layout, within a block's
    shared memory; at the cap of 42 bumps too."""
    beyond = _cuda.beyond(layers)
    devw = max(layers[1:-1]) > 256
    for seeded, want in zip((False, True), BEYOND_PLANS[layers]):
        for Kb in (16, tmb.MAX_BUMPS):
            pl = tmb.plan(seeded, layers, Kb)
            assert pl.smem == 4 * tmb.smem_floats(seeded, layers, pl.T, Kb, pl.flags)
            assert pl.smem <= _cuda.SMEM_MAX
            assert bool(pl.design & _cuda.DES_BEYOND) == (seeded and beyond)
            assert bool(pl.design & _cuda.DES_DEVW) == bool(pl.flags & _plan.DEV_WEIGHTS) == devw
            if Kb == 16:
                assert (pl.T, pl.tier) == want, seeded
    pl = tfc.forward_plan(layers, N=20000, sms=132)
    assert (pl.T, pl.tier) == BEYOND_PLANS[layers][2]
    assert not pl.design & _cuda.DES_BEYOND and bool(pl.design & _cuda.DES_DEVW) == devw
    for name in ("fwdlap_forward_streams", "multi_sums", "multi_seeded"):
        _cuda.check_net(name, layers)
    for name in ("multi_sums.bf16", "multi_seeded.bf16"):     # (row 6 has no bf16-dot mode)
        with pytest.raises(ValueError, match="ROADMAP.md B7"):
            _cuda.check_net(name, layers)


@pytest.mark.parametrize("kind", ["multi_sums", "multi_seeded", "fwdlap_forward_streams"])
def test_net_whose_stages_fit_no_tile_raises_nofit(kind):
    """(20, 512 x 4, 1): no tile of 4 points fits its stages, so each pass
    of the K-bump pair and the stream-major forward raise ``NoFit`` in their
    plans, naming the roadmap item of the stages in device memory."""
    layers = (20, 512, 512, 512, 512, 1)
    with pytest.raises(_plan.NoFit, match="no tile of 4 points fits .*ROADMAP.md B7"):
        if kind == "fwdlap_forward_streams":
            tfc.forward_plan(layers, N=20000, sms=132)
        else:
            tmb.plan(kind == "multi_seeded", layers, 16)
