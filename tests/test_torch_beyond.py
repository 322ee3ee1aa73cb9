"""Nets beyond the other kernels' limits on the CPU: hidden widths above 256,
more than 16 weight matrices and d > 16, which the fused residual kernels
(rows 1, 2) and the jet pair (rows 4, 5) take (``ROADMAP.md`` B7).

Here the port's wrappers take their plain versions (CPU tensors), and the
JAX side runs its Pallas kernels in interpret mode, as
``tests/test_torch_fused_step.py`` and ``tests/test_torch_fwdlap_backward.py``
run them.  Same inputs from a seed for both (the JAX package's initial
weights, numpy points); nets (2, 300, 300, 1), (20, 16, 16, 1) and (2, 8 x
20, 1) (21 weight matrices), 64 points.

Every result is held twice: to JAX's Pallas kernel and to JAX's float64
evaluation of the same function (the XLA recurrence ``ops/fwdlap.py::
mlp_fwdlap`` and ``jax.grad`` / ``jax.vjp`` under ``jax.enable_x64``).  The
port's float32 result within rel 1e-5 of the float64 one, and within 1e-5
of the kernel's beyond the kernel's own distance from it: on these nets
the float32 kernels themselves are up to ~1e-4 from float64 in the jet's
small columns (the deep net's Jacobian and Laplacian columns are ~1e-7
after 20 sin layers; the width-300 Laplacian sums 300 terms), while the
port's plain versions stay within a few 1e-6.

* Rows 1 and 2: the loss and every gradient leaf against JAX's
  ``fused_linear_residual`` / ``fused_poisson_analytic``.
* Row 4: every jet column against JAX's ``fwd_impl='pallas2'`` at d <= 6;
  at d = 20, which ``pallas2`` refuses, against ``fwd_impl='pallas'``
  (``_forward_kernel``) and the XLA recurrence.
* Row 5: every gradient leaf of ``fwdlap_backward_plain`` from a random
  cotangent against ``jax.vjp`` through ``mlp_fwdlap_pallas``.
* ``train_poisson_nd`` at ``dim=17, width=8, depth=3`` and ``depth=18,
  width=8`` (``sampler='sobol'``: the same scrambled Sobol base set, and the
  JAX package's initial weights for the seed) for 3 epochs on the port's
  three jet routes against JAX's ``'pallas-fused'`` run: the first total
  within 1e-5 (relative), the histories within 1e-4.
* The plans of the B7 nets (the ``DES_BEYOND`` designs, the weights in
  device memory above width 256) and ``_plan.NoFit`` naming ``ROADMAP.md
  B7`` for a net whose stages fit no tile of 4 points, (20, 512 x 4, 1).

The CUDA kernels themselves are held to their float64 plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py beyond``).  Cost on the
CPU: about 35 s on one worker, most of it JAX's interpret-mode kernels and
its entry point's compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.kernels import fused_step as jfs
from nnpde_tpu.kernels.fwdlap_pallas import mlp_fwdlap_pallas
from nnpde_tpu.models import NetSpec as JNetSpec
from nnpde_tpu.models.mlp import init_mlp as j_init_mlp
from nnpde_tpu.ops.fwdlap import mlp_fwdlap as j_mlp_fwdlap
from nnpde_tpu.problems.poisson import PoissonConfig as JPoissonConfig
from nnpde_tpu.problems.poisson import train_poisson_nd as j_train_poisson
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import _cuda, _plan
from nnpde_tpu_torch.kernels import fused_step as tfs
from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc
from nnpde_tpu_torch.kernels import mlp_fwdlap_kernel
from nnpde_tpu_torch.problems import PoissonConfig, train_poisson_nd

L = 2.0
TOL = 1e-5
NETS = {"u300": ((2, 300, 300, 1), "sin"), "d20": ((20, 16, 16, 1), "tanh"),
        "k21": ((2,) + (8,) * 20 + (1,), "sin")}
KW = dict(interpret=True, dot_dtype="float32", tile=128, bwd_tile=128)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _case(net, seed, N=64):
    """The JAX package's initial weights for the net (as its entry points
    draw them), points and a numpy generator from the seed."""
    layers, act = NETS[net]
    rng = np.random.default_rng(seed)
    jp = j_init_mlp(jax.random.PRNGKey(seed), JNetSpec(layers, act))
    pn = [(np.asarray(W), np.asarray(b)) for W, b in jp]
    X = rng.uniform(0.0, L, (N, layers[0])).astype(np.float32)
    return rng, layers, act, pn, jp, X


def _close(got, kernel, witness):
    """The port's float32 ``got`` within TOL of JAX's float64 ``witness``,
    and within TOL of JAX's float32 ``kernel`` beyond the kernel's own
    distance from the witness."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    assert _rel(got, witness) <= TOL
    assert _rel(got, kernel) <= TOL + _rel(kernel, witness)


def _close_leaves(got, kernel, witness):
    for g, k, w in zip(got, kernel, witness):
        for a, b, c in zip(g, k, w):
            _close(a, np.asarray(b), np.asarray(c))


def _rows(jet, lib):
    return lib.concatenate([jet.value[:, None], jet.grad, jet.lap[:, None]], 1)


def _x64(pn, X):
    return ([(jnp.asarray(W, jnp.float64), jnp.asarray(b, jnp.float64)) for W, b in pn],
            jnp.asarray(X, jnp.float64))


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("kind", ["linear", "analytic"])
def test_fused_rows_match_jax(kind, net):
    """Rows 1 and 2: loss and every gradient leaf."""
    rng, layers, act, pn, jp, X = _case(net, seed=41)
    d = layers[0]
    tp, Xt = params_from_jax(pn), torch.as_tensor(X)
    ks = tuple(1 + i % 3 for i in range(d))
    coef = rng.normal(size=(X.shape[0], d + 4)).astype(np.float32)
    if kind == "linear":
        lj, _, gj = jax.jit(lambda p, x, cf: jfs.fused_linear_residual(
            p, x, cf, act, weight=3.0, bwd_tile=128, interpret=True))(
                jp, jnp.asarray(X), jnp.asarray(coef))
        lt, _, gt = tfs.fused_linear_residual(tp, Xt, torch.as_tensor(coef), act, weight=3.0)
    else:
        lj, _, gj = jax.jit(lambda p, x: jfs.fused_poisson_analytic(
            p, x, act, L=L, ks=ks, bwd_tile=128, interpret=True))(jp, jnp.asarray(X))
        lt, _, gt = tfs.fused_poisson_analytic(tp, Xt, act, L=L, ks=ks)
    with jax.enable_x64(True):
        p64, X64 = _x64(pn, X)
        if kind == "linear":
            c64 = jnp.asarray(coef, jnp.float64)
            c, b, a, rhs, w = c64[:, 0], c64[:, 1:1 + d], c64[:, d + 1], c64[:, d + 2], 3.0
        else:
            c, bs, a, rhs = jfs._poisson_sin_coef_builder(L, ks)(X64)
            c, b, a, rhs, w = c[:, 0], jnp.concatenate(bs, 1), a[:, 0], rhs[:, 0], 1.0

        def loss(p):
            jet = j_mlp_fwdlap(p, X64, act)
            r = c * jet.value + jnp.sum(b * jet.grad, 1) + a * jet.lap + rhs
            return w * jnp.mean(r * r)

        lw, gw = jax.jit(jax.value_and_grad(loss))(p64)
        lw, gw = float(lw), [(np.asarray(W), np.asarray(bb)) for W, bb in gw]
    _close(np.asarray([float(lt)]), np.asarray([float(lj)]), np.asarray([lw]))
    _close_leaves(gt, gj, gw)


@pytest.mark.parametrize("net", sorted(NETS))
def test_jet_forward_matches_jax(net):
    """Row 4: every column, against ``pallas2`` where it takes d, else
    against ``pallas``, and against the XLA recurrence in float32."""
    _, layers, act, pn, jp, X = _case(net, seed=42)
    got = _rows(mlp_fwdlap_kernel(params_from_jax(pn), torch.as_tensor(X), act), torch).numpy()
    fwd = "pallas2" if layers[0] <= 6 else "pallas"
    kernels = [jax.jit(lambda p, x: _rows(j_mlp_fwdlap(p, x, act), jnp))(jp, jnp.asarray(X)),
               jax.jit(lambda p, x: _rows(mlp_fwdlap_pallas(p, x, act, fwd_impl=fwd, **KW),
                                          jnp))(jp, jnp.asarray(X))]
    with jax.enable_x64(True):
        witness = np.asarray(jax.jit(lambda p, x: _rows(j_mlp_fwdlap(p, x, act), jnp))(
            *_x64(pn, X)))
    for kernel in kernels:
        for c in range(layers[0] + 2):
            _close(got[:, c], np.asarray(kernel)[:, c], witness[:, c])


@pytest.mark.parametrize("net", sorted(NETS))
def test_jet_backward_matches_jax_vjp(net):
    """Row 5: every gradient leaf from a random cotangent."""
    rng, layers, act, pn, jp, X = _case(net, seed=43)
    ct = rng.normal(size=(X.shape[0], layers[0] + 2)).astype(np.float32)
    def pullback(jet_fn, p, x, c):
        return jax.vjp(lambda q: _rows(jet_fn(q, x), jnp), p)[1](c)[0]

    gj = jax.jit(lambda p, x, c: pullback(
        lambda q, y: mlp_fwdlap_pallas(q, y, act, **KW), p, x, c))(
            jp, jnp.asarray(X), jnp.asarray(ct))
    with jax.enable_x64(True):
        p64, X64 = _x64(pn, X)
        gw = jax.jit(lambda p, x, c: pullback(lambda q, y: j_mlp_fwdlap(q, y, act), p, x, c))(
            p64, X64, jnp.asarray(ct, jnp.float64))
        gw = [(np.asarray(W), np.asarray(b)) for W, b in gw]
    dWs, dbs = tfc.fwdlap_backward_plain(params_from_jax(pn), torch.as_tensor(X),
                                         torch.as_tensor(ct), act)
    _close_leaves(list(zip(dWs, dbs)), gj, gw)


@pytest.mark.parametrize("shape", [dict(dim=17, width=8, depth=3), dict(depth=18, width=8)])
def test_entry_point_first_total_matches_jax(shape):
    """``train_poisson_nd`` on a net with d = 17 or with 18 weight matrices,
    3 epochs on the Sobol base set: the port's torch, kernel and fused routes
    against JAX's pallas-fused run."""
    base = dict(shape, epochs=3, chunk=3, n_interior=64, n_eval=64, sampler="sobol", seed=3)
    want = np.asarray(j_train_poisson(JPoissonConfig(**base, jet_impl="pallas-fused"))
                      ["history"]["total"], np.float64)
    assert want.shape == (3,) and np.all(np.isfinite(want))
    for impl in ("torch", "kernel", "fused"):
        got = np.asarray(train_poisson_nd(PoissonConfig(**base, jet_impl=impl), device="cpu")
                         ["history"]["total"], np.float64)
        assert abs(got[0] - want[0]) <= TOL * abs(want[0]), impl
        assert _rel(got, want) <= 1e-4, impl


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("layers,want", [
    ((2, 512, 512, 512, 512, 1), {"fused": (8, "device"), "bwd": (8, "device"),
                                  "fwd": (12, "device")}),
    ((1, 1001, 300, 1), {"fused": (4, "device"), "bwd": (4, "device"), "fwd": (8, "device")}),
    ((18, 128, 128, 1), {"fused": (4, "staged"), "bwd": (4, "staged"),
                         "fwd": (8, "resident")}),
    ((20, 64, 64, 64, 64, 1), {"fused": (12, "staged"), "bwd": (12, "staged"),
                               "fwd": (16, "resident")}),
    ((2,) + (32,) * 23 + (1,), {"fused": (48, "staged"), "bwd": (48, "staged"),
                                "fwd": (32, "staged")}),
])
def test_beyond_plans(layers, want):
    """The B7 nets' plans (one block per SM above width 256 and at d > 16):
    rows 1, 2 and 5 in a ``DES_BEYOND`` design where the net needs it (a
    width above 256 or d > 16; the deep narrow net keeps the planned
    designs), with the weights in device memory above width 256; row 4 on
    its forward-only plan, which needs no variant of its own; each plan's
    bytes its kernel's layout."""
    beyond = _cuda.beyond(layers)
    assert beyond == (max(layers[1:-1]) > 256 or layers[0] > 16)
    devw = max(layers[1:-1]) > 256
    for kind in ("fused_linear_residual", "fused_poisson_analytic"):
        pl = tfs.plan(kind, layers)
        assert (pl.T, pl.tier) == want["fused"]
        assert bool(pl.design & _cuda.DES_BEYOND) == beyond
        assert bool(pl.design & _cuda.DES_DEVW) == devw
        assert pl.design in _cuda.FP32_DESIGNS
        assert pl.smem == 4 * tfs.smem_floats(kind, layers, pl.T, pl.flags) <= _cuda.SMEM_MAX
    pl = tfc.backward_plan(layers)
    assert (pl.T, pl.tier) == want["bwd"] and bool(pl.design & _cuda.DES_BEYOND) == beyond
    assert pl.smem == 4 * tfc.backward_smem_floats(layers, pl.T, pl.flags) <= _cuda.SMEM_MAX
    pl = tfc.forward_plan(layers, N=20000)
    assert (pl.T, pl.tier) == want["fwd"] and not pl.design & _cuda.DES_BEYOND
    assert bool(pl.design & _cuda.DES_DEVW) == devw
    assert pl.smem == 4 * tfc.forward_smem_floats(layers, pl.T, pl.flags) <= _cuda.SMEM_MAX
    if beyond:
        # the DES_BEYOND designs are the only ones such a net takes, and
        # only such a net takes them
        with pytest.raises(ValueError, match="DES_BEYOND"):
            tfc.backward_plan(layers, design=_cuda.DES_PLANNED | _cuda.DES_DEVW)
    else:
        with pytest.raises(ValueError, match="DES_BEYOND"):
            tfc.backward_plan(layers, design=_cuda.DES_PLANNED | _cuda.DES_BEYOND)


@pytest.mark.parametrize("layers", [(20, 512, 512, 512, 512, 1), (2, 2000, 1),
                                    (64, 256, 256, 1)])
def test_nets_whose_stages_fit_no_tile_raise_nofit(layers):
    """No tile of 4 points fits: each of the four kernels' plans raises
    ``NoFit``, naming the roadmap item of the stages in device memory."""
    for call in (lambda: tfs.plan("fused_linear_residual", layers),
                 lambda: tfs.plan("fused_poisson_analytic", layers),
                 lambda: tfc.backward_plan(layers),
                 lambda: tfc.forward_plan(layers, N=20000)):
        with pytest.raises(_plan.NoFit, match="no tile of 4 points fits .*ROADMAP.md B7"):
            call()
