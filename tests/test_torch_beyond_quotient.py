"""Nets beyond the other kernels' limits on the CPU for the Deep-Ritz energy
(row 3) and the quotient pair (rows 7-10): hidden widths above 256, more
than 16 weight matrices and d > 16 (``ROADMAP.md`` B7), as
``tests/test_torch_beyond.py`` holds rows 1, 2, 4, 5.

Here the port's wrappers take their plain versions (CPU tensors), and the
JAX side runs its Pallas kernels in interpret mode, as
``tests/test_torch_fused_step.py`` and ``tests/test_torch_fused_quotient.py``
run them.  Same inputs from a seed for both (the JAX package's initial
weights, numpy points and coefficients); nets (2, 300, 300, 1), (20, 16,
16, 1) and (2, 8 x 20, 1) (21 weight matrices), 64 points.

Every result is held twice, by the rule of ``tests/test_torch_beyond.py``:
to JAX's Pallas kernel and to JAX's float64 evaluation of the same function
(the XLA recurrence ``ops/fwdlap.py::mlp_fwdlap`` and ``jax.grad`` under
``jax.enable_x64``).  The port's float32 result within rel 1e-5 of the
float64 one, and within 1e-5 of the kernel's beyond the kernel's own
distance from it, on the loss and on every gradient leaf; each pass-A sum
by the same rule over the float64 sum of its terms' magnitudes (the bar of
``tests/test_torch_fused_quotient.py``: a sum may cancel far below its
terms).

* Row 3: ``fused_drm_energy``'s loss and every gradient leaf (~1-5 s a net:
  JAX's interpret-mode kernel).
* Rows 7 and 8: ``fused_linear_sums``' four sums and ``fused_seeded_grads``'
  every leaf, with and without the Laplacian stream (``no_lap``; ~2-4 s a
  net and mode).
* Rows 9 and 10: ``fused_quad_sums``' two sums and
  ``fused_quad_seeded_grads``' every leaf (~2-4 s a net).
* ``train_poisson_nd`` with ``method='DRM'`` and ``method='WAN'`` at
  ``dim=17, width=8, depth=3`` and ``depth=18, width=8`` (WAN:
  ``critic_width=8``; ``sampler='sobol'``: the same scrambled Sobol base
  set, and the JAX package's initial weights for the seed) for 3 epochs on
  the port's ``fused`` route against JAX's ``'pallas-fused'`` run: the first
  total within 1e-5 (relative) (~3-8 s a case, most of it JAX's compiles).
* The plans of the B7 nets for the five kernels (pass B in its
  ``DES_BEYOND`` designs exactly where the net needs them, pass A on the
  forward-only plan as it is, the weights in device memory above width 256)
  and ``_plan.NoFit`` naming ``ROADMAP.md B7`` for (20, 512 x 4, 1) (~0.1 s).

The CUDA kernels themselves are held to their float64 plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py beyond``).  Cost on the
CPU: about 50 s on one worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.kernels import fused_quotient as jfq
from nnpde_tpu.kernels import fused_step as jfs
from nnpde_tpu.models import NetSpec as JNetSpec
from nnpde_tpu.models.mlp import init_mlp as j_init_mlp
from nnpde_tpu.ops.fwdlap import mlp_fwdlap as j_mlp_fwdlap
from nnpde_tpu.problems.poisson import PoissonConfig as JPoissonConfig
from nnpde_tpu.problems.poisson import train_poisson_nd as j_train_poisson
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import _cuda, _plan
from nnpde_tpu_torch.kernels import fused_quotient as tfq
from nnpde_tpu_torch.kernels import fused_step as tfs
from nnpde_tpu_torch.problems import PoissonConfig, train_poisson_nd

L = 2.0
TOL = 1e-5
NETS = {"u300": ((2, 300, 300, 1), "sin"), "d20": ((20, 16, 16, 1), "tanh"),
        "k21": ((2,) + (8,) * 20 + (1,), "sin")}
KW = dict(interpret=True, dot_dtype="float32", bwd_tile=128)
SCAL_LINEAR, SCAL_QUAD = (0.3, -0.2, 0.7), (0.4, -0.3)


def layers_d(net):
    return NETS[net][0][0]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _case(net, seed, nc, N=64):
    """The JAX package's initial weights for the net (as its entry points
    draw them), points inside the box and ``nc`` coefficient columns from
    the seed."""
    layers, act = NETS[net]
    rng = np.random.default_rng(seed)
    jp = j_init_mlp(jax.random.PRNGKey(seed), JNetSpec(layers, act))
    pn = [(np.asarray(W), np.asarray(b)) for W, b in jp]
    X = rng.uniform(0.05, L - 0.05, (N, layers[0])).astype(np.float32)
    coef = rng.normal(size=(N, nc)).astype(np.float32)
    return layers, act, pn, jp, X, coef


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


def _close_sums(got, kernel, witness, scale):
    """Each pass-A sum by the rule of ``_close``, its distances taken over
    the float64 sum of its terms' magnitudes (``scale``), the port's bar
    for sums (``tests/test_torch_fused_quotient.py``): a sum of terms of
    either sign may cancel far below its terms."""
    for k, m in scale.items():
        g, kk, w = float(got[k]), float(kernel[k]), witness[k]
        assert abs(g - w) <= TOL * m, k
        assert abs(g - kk) <= TOL * m + abs(kk - w), k


def _x64(pn, X, coef):
    return ([(jnp.asarray(W, jnp.float64), jnp.asarray(b, jnp.float64)) for W, b in pn],
            jnp.asarray(X, jnp.float64), jnp.asarray(coef, jnp.float64))


def _leaves64(g):
    return [(np.asarray(W), np.asarray(b)) for W, b in g]


@pytest.mark.parametrize("net", sorted(NETS))
def test_drm_energy_matches_jax(net):
    """Row 3: the Ritz energy's loss and every gradient leaf."""
    layers, act, pn, jp, X, coef = _case(net, 51, layers_d(net) + 2)
    lj, _, gj = jax.jit(lambda p, x, c: jfs.fused_drm_energy(
        p, x, c, act, weight=0.5, bwd_tile=128, interpret=True))(
            jp, jnp.asarray(X), jnp.asarray(coef))
    lt, _, gt = tfs.fused_drm_energy(params_from_jax(pn), torch.as_tensor(X),
                                     torch.as_tensor(coef), act, weight=0.5)
    d = layers[0]
    with jax.enable_x64(True):
        p64, X64, c64 = _x64(pn, X, coef)
        B, dB, f = c64[:, 0], c64[:, 1:1 + d], c64[:, d + 1]

        def loss(p):
            jet = j_mlp_fwdlap(p, X64, act)
            G = B[:, None] * jet.grad + dB * jet.value[:, None]
            return 0.5 * jnp.mean(0.5 * jnp.sum(G * G, 1) - f * B * jet.value)

        lw, gw = jax.jit(jax.value_and_grad(loss))(p64)
        lw, gw = float(lw), _leaves64(gw)
    _close(np.asarray([float(lt)]), np.asarray([float(lj)]), np.asarray([lw]))
    _close_leaves(gt, gj, gw)


@pytest.mark.parametrize("no_lap", [False, True])
@pytest.mark.parametrize("net", sorted(NETS))
def test_linear_pair_matches_jax(net, no_lap):
    """Rows 7 and 8: pass A's four sums and pass B's every gradient leaf
    (the last bias's is ``sum ct_v``), with and without the Laplacian
    stream (``no_lap`` drops it, so the ``a`` column is zero there)."""
    d = layers_d(net)
    layers, act, pn, jp, X, coef = _case(net, 52 + no_lap, d + 5)
    if no_lap:
        coef[:, d + 1] = 0.0
    Xj, cj = jnp.asarray(X), jnp.asarray(coef)
    sj = jax.jit(lambda p, x, c: jfq.fused_linear_sums(p, x, c, act, no_lap=no_lap, **KW))(
        jp, Xj, cj)
    gj = jax.jit(lambda p, x, c: jfq.fused_seeded_grads(p, x, c, SCAL_LINEAR, act,
                                                        no_lap=no_lap, **KW))(jp, Xj, cj)
    tp, Xt, Ct = params_from_jax(pn), torch.as_tensor(X), torch.as_tensor(coef)
    st = tfq.fused_linear_sums(tp, Xt, Ct, act, no_lap=no_lap)
    gt = tfq.fused_seeded_grads(tp, Xt, Ct, SCAL_LINEAR, act, no_lap=no_lap)
    with jax.enable_x64(True):
        p64, X64, c64 = _x64(pn, X, coef)
        c, b, a, rhs, e1, e2 = (c64[:, 0], c64[:, 1:1 + d], c64[:, d + 1], c64[:, d + 2],
                                c64[:, d + 3], c64[:, d + 4])

        def terms(p):
            jet = j_mlp_fwdlap(p, X64, act)
            r = c * jet.value + jnp.sum(b * jet.grad, 1) + a * jet.lap + rhs
            return {"sum_r": r, "sum_r2": r * r, "sum_mass": (e1 * jet.value) ** 2,
                    "sum_e2": e2 * jet.value}

        def seeded(p):
            t = terms(p)
            s_r, s_q, s_l = SCAL_LINEAR
            return jnp.sum(s_r * t["sum_r"] + s_q * t["sum_mass"] + s_l * t["sum_e2"])

        tw = {k: np.asarray(v) for k, v in jax.jit(terms)(p64).items()}
        gw = _leaves64(jax.jit(jax.grad(seeded))(p64))
    _close_sums(st, sj, {k: float(np.sum(v)) for k, v in tw.items()},
                {k: float(np.sum(np.abs(v))) for k, v in tw.items()})
    _close_leaves(gt, gj, gw)


@pytest.mark.parametrize("net", sorted(NETS))
def test_quad_pair_matches_jax(net):
    """Rows 9 and 10: pass A's two sums and pass B's every gradient leaf."""
    d = layers_d(net)
    layers, act, pn, jp, X, coef = _case(net, 54, d + 3)
    Xj, cj = jnp.asarray(X), jnp.asarray(coef)
    sj = jax.jit(lambda p, x, c: jfq.fused_quad_sums(p, x, c, act, **KW))(jp, Xj, cj)
    gj = jax.jit(lambda p, x, c: jfq.fused_quad_seeded_grads(p, x, c, SCAL_QUAD, act, **KW))(
        jp, Xj, cj)
    tp, Xt, Ct = params_from_jax(pn), torch.as_tensor(X), torch.as_tensor(coef)
    st = tfq.fused_quad_sums(tp, Xt, Ct, act)
    gt = tfq.fused_quad_seeded_grads(tp, Xt, Ct, SCAL_QUAD, act)
    with jax.enable_x64(True):
        p64, X64, c64 = _x64(pn, X, coef)
        B, dB, f, V = c64[:, 0], c64[:, 1:1 + d], c64[:, d + 1], c64[:, d + 2]

        def terms(p):
            jet = j_mlp_fwdlap(p, X64, act)
            u = B * jet.value
            G = B[:, None] * jet.grad + dB * jet.value[:, None]
            return {"sum_e": 0.5 * jnp.sum(G * G, 1) - f * u + V * u * u, "sum_u2": u * u}

        def seeded(p):
            t = terms(p)
            return jnp.sum(SCAL_QUAD[0] * t["sum_e"] + SCAL_QUAD[1] * t["sum_u2"])

        tw = {k: np.asarray(v) for k, v in jax.jit(terms)(p64).items()}
        gw = _leaves64(jax.jit(jax.grad(seeded))(p64))
    _close_sums(st, sj, {k: float(np.sum(v)) for k, v in tw.items()},
                {k: float(np.sum(np.abs(v))) for k, v in tw.items()})
    _close_leaves(gt, gj, gw)


@pytest.mark.parametrize("method", ["DRM", "WAN"])
@pytest.mark.parametrize("shape", [dict(dim=17, width=8, depth=3), dict(depth=18, width=8)])
def test_entry_point_first_total_matches_jax(shape, method, monkeypatch):
    """``train_poisson_nd`` with the Deep-Ritz energy or the WAN minimax on
    a net with d = 17 or with 18 weight matrices, 3 epochs on the Sobol base
    set: the port's fused route (row 3; rows 4, 7-10) against JAX's
    pallas-fused run.  The WAN draws fresh points for every critic and
    primal step, each a random shift of the base set that the port takes
    from torch's generators and JAX from its keys; here both sides draw the
    base set itself (the shift set to zero), so both train on the same
    points."""
    import nnpde_tpu.sampling as jsampling
    from nnpde_tpu_torch.problems import poisson as tpoisson
    from nnpde_tpu_torch.sampling.samplers import _to_box

    monkeypatch.setattr(jsampling, "shifted_qmc", lambda u, key, box: jnp.asarray(
        box.lo, u.dtype) + u * (jnp.asarray(box.hi, u.dtype) - jnp.asarray(box.lo, u.dtype)))
    monkeypatch.setattr(tpoisson, "shifted_qmc", lambda u, gen, box: _to_box(u, box))
    base = dict(shape, method=method, epochs=3, chunk=3, n_interior=64, n_eval=64,
                sampler="sobol", seed=5)
    if method == "WAN":
        base.update(critic_width=8, critic_steps=1)
    want = np.asarray(j_train_poisson(JPoissonConfig(**base, jet_impl="pallas-fused"))
                      ["history"]["total"], np.float64)
    assert want.shape == (3,) and np.all(np.isfinite(want))
    got = np.asarray(train_poisson_nd(PoissonConfig(**base, jet_impl="fused"), device="cpu")
                     ["history"]["total"], np.float64)
    assert np.all(np.isfinite(got))
    assert abs(got[0] - want[0]) <= TOL * abs(want[0])


# ------------------------------------------------------------------ plans
# (T, tier) of rows 3 (the DRM energy), 7 without / with the Laplacian, 8
# without / with it, 9 and 10: chip_smoke.py's beyond nets
BEYOND_PLANS = {
    (2, 512, 512, 512, 512, 1): ((12, "device"), (16, "device"), (12, "device"),
                                 (12, "device"), (8, "device"), (16, "device"),
                                 (12, "device")),
    (1, 1001, 300, 1): ((8, "device"), (12, "device"), (8, "device"), (8, "device"),
                        (4, "device"), (12, "device"), (8, "device")),
    (18, 128, 128, 1): ((4, "staged"), (8, "resident"), (4, "resident"), (4, "staged"),
                        (4, "staged"), (8, "resident"), (4, "staged")),
    (20, 64, 64, 64, 64, 1): ((12, "staged"), (16, "resident"), (16, "staged"),
                              (12, "staged"), (12, "staged"), (16, "resident"),
                              (12, "staged")),
    (2,) + (32,) * 23 + (1,): ((48, "staged"), (32, "staged"), (32, "staged"),
                               (40, "staged"), (32, "staged"), (32, "staged"),
                               (40, "staged")),
}
KINDS = (("fused_drm_energy", None), ("linear_sums", 0), ("linear_sums", 1),
         ("linear_seeded", 0), ("linear_seeded", 1), ("quad_sums", 0), ("quad_seeded", 0))


@pytest.mark.parametrize("layers", sorted(BEYOND_PLANS))
def test_beyond_plans(layers):
    """The B7 nets' plans (20000 points for pass A): row 3 and pass B in a
    ``DES_BEYOND`` design exactly where the net needs one (a width above 256
    or d > 16; the deep narrow net keeps the other designs), pass A on the
    forward-only plan as it is; the weights in device memory above width
    256; each plan's bytes its kernel's layout, within a block's shared
    memory.  The DES_BEYOND designs are refused on the nets that do not
    need them, and the others on the nets that do."""
    beyond = _cuda.beyond(layers)
    devw = max(layers[1:-1]) > 256
    for (kind, lap), want in zip(KINDS, BEYOND_PLANS[layers]):
        if kind == "fused_drm_energy":
            pl = tfs.plan(kind, layers)
            assert pl.smem == 4 * tfs.smem_floats(kind, layers, pl.T, pl.flags)
            assert pl.design in _cuda.FP32_DESIGNS
        else:
            pl = tfq.plan(kind, layers, lap, N=20000 if kind.endswith("sums") else None)
            assert pl.smem == 4 * tfq.smem_floats(kind, layers, pl.T, lap, pl.flags)
        assert (pl.T, pl.tier) == want, kind
        assert pl.smem <= _cuda.SMEM_MAX
        assert bool(pl.design & _cuda.DES_BEYOND) == (beyond and not kind.endswith("sums"))
        assert bool(pl.design & _cuda.DES_DEVW) == devw
    other = 0 if beyond else _cuda.DES_BEYOND
    for kind in ("linear_seeded", "quad_seeded"):
        with pytest.raises(ValueError, match="DES_BEYOND") as err:
            tfq.plan(kind, layers, 0, design=other)
        assert not isinstance(err.value, _plan.NoFit)


@pytest.mark.parametrize("kind,lap", KINDS)
def test_net_whose_stages_fit_no_tile_raises_nofit(kind, lap):
    """(20, 512 x 4, 1): no tile of 4 points fits its stages, so each of the
    five kernels' plans raises ``NoFit``, naming the roadmap item of the
    stages in device memory."""
    layers = (20, 512, 512, 512, 512, 1)
    with pytest.raises(_plan.NoFit, match="no tile of 4 points fits .*ROADMAP.md B7"):
        if kind == "fused_drm_energy":
            tfs.plan(kind, layers)
        else:
            tfq.plan(kind, layers, lap, N=20000 if kind.endswith("sums") else None)
