"""The port's differentiable jet function against the JAX package's, on
the CPU.

``mlp_fwdlap_kernel`` is the counterpart of ``mlp_fwdlap_pallas``: the jet
forward (one kernel in two output layouts: ``fwd_impl='rows'`` /
``'streams'``, JAX ``'pallas2'`` / ``'pallas'``) and the recompute
backward.  Inputs come from a numpy seed and go through both packages; the JAX side runs its Pallas kernels in
interpret mode (``interpret=True, dot_dtype="float32", bwd_tile=128``,
``lane_pack`` 1 and 2), the port's wrappers take their plain versions here
(CPU tensors).

Tolerances (float32 on both sides):

* the gradient of a loss through ``mlp_fwdlap_pallas`` against the gradient
  through ``mlp_fwdlap_kernel``: every leaf rel <= 1e-5;
* the ``fwd_impl='pallas'`` jet against ``fwd_impl="streams"``: every column
  rel <= 1e-5;
* ``fwdlap_backward_plain`` from a random cotangent against ``jax.vjp`` of
  the Pallas function: every leaf rel <= 1e-5;
* ``SolutionModel.fields(impl="kernel")`` and ``value_and_grad`` against
  ``impl="torch"``: value and every gradient leaf rel <= 1e-5;
* ``train_poisson_nd(jet_impl="kernel")`` against ``"torch"``: histories rel
  <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.kernels.fwdlap_pallas import mlp_fwdlap_pallas
from nnpde_tpu.models import NetSpec as JNetSpec
from nnpde_tpu.models.mlp import init_mlp as j_init_mlp
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc
from nnpde_tpu_torch.kernels import mlp_fwdlap_kernel
from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
from nnpde_tpu_torch.problems import PoissonConfig, train_poisson_nd

KW = dict(interpret=True, dot_dtype="float32", tile=128, bwd_tile=128)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _setup(layers, act, seed, N=150):
    rng = np.random.default_rng(seed)
    jp = j_init_mlp(jax.random.PRNGKey(seed), JNetSpec(layers, act))
    tp = params_from_jax([(np.array(W), np.array(b)) for W, b in jp])
    X = rng.uniform(0.0, 2.0, (N, layers[0])).astype(np.float32)
    return rng, jp, tp, X


def _rows(jet, lib):
    return lib.concatenate([jet.value[:, None], jet.grad, jet.lap[:, None]], 1)


@pytest.mark.parametrize("layers,act,lane_pack", [
    ((2, 16, 16, 1), "sin", 2),
    ((2, 10, 10, 10, 1), "tanh", 1),
    ((3, 13, 10, 1), "gelu", 1),
])
def test_loss_gradient_matches_pallas(layers, act, lane_pack):
    rng, jp, tp, X = _setup(layers, act, seed=3)
    d = layers[0]
    wv = rng.normal(size=(X.shape[0],)).astype(np.float32)

    def loss_j(p):
        jet = mlp_fwdlap_pallas(p, jnp.asarray(X), act, lane_pack=lane_pack, **KW)
        return (jnp.mean((jet.lap + 2.0 * jet.value) ** 2)
                + jnp.mean(jnp.asarray(wv) * jet.value * jet.grad.sum(-1)))

    vj, gj = jax.value_and_grad(loss_j)(jp)
    leaves = [t.requires_grad_(True) for pair in tp for t in pair]
    jet = mlp_fwdlap_kernel(tp, torch.as_tensor(X), act)
    assert jet.grad.shape == (X.shape[0], d)
    val = (torch.mean((jet.lap + 2.0 * jet.value) ** 2)
           + torch.mean(torch.as_tensor(wv) * jet.value * jet.grad.sum(-1)))
    g = torch.autograd.grad(val, leaves)
    assert abs(float(val.detach()) - float(vj)) <= 1e-5 * abs(float(vj))
    want = [t for pair in gj for t in pair]
    for got, ref in zip(g, want):
        assert _rel(got.numpy(), np.asarray(ref)) <= 1e-5


@pytest.mark.parametrize("layers,act", [((2, 16, 16, 1), "sin"), ((5, 12, 12, 1), "tanh")])
def test_streams_forward_matches_pallas_forward(layers, act):
    _, jp, tp, X = _setup(layers, act, seed=4)
    jj = mlp_fwdlap_pallas(jp, jnp.asarray(X), act, fwd_impl="pallas", **KW)
    want = np.asarray(_rows(jj, jnp))
    for fwd_impl in ("streams", "rows"):
        jt = mlp_fwdlap_kernel(tp, torch.as_tensor(X), act, fwd_impl=fwd_impl)
        got = _rows(jt, torch).numpy()
        for c in range(layers[0] + 2):
            assert _rel(got[:, c], want[:, c]) <= 1e-5, (fwd_impl, c)
    with pytest.raises(ValueError, match="fwd_impl"):
        mlp_fwdlap_kernel(tp, torch.as_tensor(X), act, fwd_impl="pallas2")


def test_backward_plain_matches_pallas_vjp():
    layers, act = (2, 12, 10, 1), "sin"
    rng, jp, tp, X = _setup(layers, act, seed=5)
    ct = rng.normal(size=(X.shape[0], layers[0] + 2)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: _rows(mlp_fwdlap_pallas(p, jnp.asarray(X), act, **KW), jnp), jp)
    (gj,) = vjp(jnp.asarray(ct))
    dWs, dbs = tfc.fwdlap_backward_plain(tp, torch.as_tensor(X), torch.as_tensor(ct), act)
    for (jW, jb), tW, tb in zip(gj, dWs, dbs):
        assert _rel(tW.numpy(), np.asarray(jW)) <= 1e-5
        assert _rel(tb.numpy(), np.asarray(jb)) <= 1e-5
    # the last bias only shifts the value stream: its gradient is sum ct_v
    assert _rel(dbs[-1].numpy(), ct[:, 0].sum()) <= 1e-5


@pytest.mark.parametrize("which", ["fields", "value_and_grad"])
def test_solution_model_kernel_route_is_differentiable(which):
    """``impl='kernel'`` (plain versions on the CPU) gives the gradients of
    ``impl='torch'``; the points get no gradient."""
    layers = (2, 10, 10, 1)
    _, _, tp, X = _setup(layers, "sin", seed=6)
    model = SolutionModel(NetSpec(layers, activation="sin"),
                          factor_for_technique("FBC", dim=2, kind="box", L=2.0))
    Xt = torch.as_tensor(X)

    def run(impl, **kw):
        p = [(W.detach().clone().requires_grad_(True), b.detach().clone().requires_grad_(True))
             for W, b in tp]
        if which == "fields":
            jet = model.fields(p, Xt, impl=impl, **kw)
            val = torch.mean((jet.lap + jet.value) ** 2) + torch.mean(jet.grad ** 2)
        else:
            u, g = model.value_and_grad(p, Xt, impl=impl, **kw)
            val = torch.mean(g ** 2) / torch.mean(u ** 2)
        return val.detach(), torch.autograd.grad(val, [t for pair in p for t in pair])

    v0, g0 = run("torch")
    for kw in ({}, {"fwd_impl": "streams"}):
        v1, g1 = run("kernel", **kw)
        assert abs(float(v1) - float(v0)) <= 1e-5 * abs(float(v0))
        for a, b in zip(g1, g0):
            assert _rel(a.numpy(), b.numpy()) <= 1e-5
    with pytest.raises(TypeError):
        model.fields(tp, Xt, impl="torch", fwd_impl="streams")
    Xg = Xt.clone().requires_grad_(True)
    jet = mlp_fwdlap_kernel([(W.detach().requires_grad_(True), b.detach())
                             for W, b in tp], Xg, "sin")
    assert torch.autograd.grad(jet.value.sum(), Xg, allow_unused=True)[0] is None


def test_poisson_pinn_kernel_path_matches_torch_on_cpu():
    kw = dict(dim=2, width=16, depth=3, epochs=20, n_interior=256, n_eval=256, chunk=20)
    a = train_poisson_nd(PoissonConfig(method="PINN", jet_impl="torch", **kw), device="cpu")
    b = train_poisson_nd(PoissonConfig(method="PINN", jet_impl="kernel", **kw), device="cpu")
    assert _rel(b["history"]["total"], a["history"]["total"]) <= 1e-4
    assert _rel(b["history"]["l2"], a["history"]["l2"]) <= 1e-4
    c = train_poisson_nd(PoissonConfig(method="DRM", jet_impl="kernel", **dict(kw, epochs=3)),
                         device="cpu")
    assert np.all(np.isfinite(c["history"]["total"]))


def test_wrapper_checks_and_tile_planning_take_any_width():
    """The CPU-side half of the width repair: the wrappers' net check takes
    hidden widths 1..256 on the fp32 kernels and on the K-bump pair (not
    only multiples of 4; ``_cuda.LIMITS``), and wider ones on the jet pair
    and the fp32 K-bump pair (to 4096, ``ROADMAP.md`` B7) but not on the
    pair's bf16-dot mode, the shared-memory
    plans use the width rounded up to a multiple of 4, and the multibump
    plan counts the K*(d+4)*T coefficient tile (rows padded to an odd
    stride)."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fused_multibump as tfm

    X = torch.zeros(8, 2)

    def net(*layers):
        return [(torch.zeros(a, b), torch.zeros(b)) for a, b in zip(layers[:-1], layers[1:])]

    for layers in ((2, 50, 50, 50, 50, 1), (2, 10, 10, 1), (2, 1, 7, 1), (2, 128, 1)):
        for k in ("fwdlap_backward", "multi_seeded"):
            assert _cuda.net_layers(k, net(*layers), X, "sin") == list(layers)
    for layers in ((2, 200, 200, 1), (2, 130, 256, 1)):
        for k in ("fwdlap_backward", "multi_seeded"):
            assert _cuda.net_layers(k, net(*layers), X, "sin") == list(layers)
    with pytest.raises(ValueError, match="hidden widths from 1 to 256"):
        _cuda.net_layers("multi_seeded.bf16", net(2, 257, 1), X, "sin")
    for k in ("fwdlap_backward", "multi_seeded"):
        assert _cuda.net_layers(k, net(2, 257, 1), X, "sin") == [2, 257, 1]
    with pytest.raises(ValueError, match="hidden widths from 1 to 4096"):
        _cuda.net_layers("fwdlap_backward", net(2, 4097, 1), X, "sin")
    with pytest.raises(ValueError, match="one output"):
        _cuda.net_layers("fwdlap_backward", net(2, 8, 2), X, "sin")
    with pytest.raises(TypeError):
        _cuda.net_layers("fwdlap_backward", net(2, 8, 1), X.double(), "sin")
    assert _cuda.padded_wmax([2, 50, 50, 1]) == 52
    assert _cuda.padded_wmax([2, 64, 20, 1]) == 64
    assert _cuda.padded_wmax([2, 1, 1]) == 4
    # jet forward / backward plans: 2 or 3 stream buffers of (d+2)*T*wmax floats
    assert (tfc.forward_smem_floats([2, 50, 50, 1], 16)
            == 2 * 4 * 16 * 52 + 52 * 52 + 16 * 2 + 4 * 16)
    assert (tfc.backward_smem_floats([2, 50, 50, 1], 16)
            == 3 * 4 * 16 * 52 + 52 * 52 + 16 * 2 + 4 * 16 + _cuda.NT)
    # the coefficient tile is counted, per bump and per point
    lay = [2, 20, 20, 20, 1]
    assert (tfm.smem_floats(False, lay, 16, 42, 0) - tfm.smem_floats(False, lay, 16, 16, 0)
            == 26 * (6 * 16 + 3))
    wide = [2, 128, 128, 1]
    pl = tfm.plan(True, wide, 42)
    assert pl.T >= 16 and pl.T % 4 == 0
    assert pl.smem == 4 * tfm.smem_floats(True, wide, pl.T, 42, pl.flags) <= _cuda.SMEM_MAX
    pl = tfm.plan(True, [16] + [128] * 15 + [1], 42)
    assert pl.T < 16 and pl.tier == "staged"   # d = 16, 16 layers: the tile shrinks until it fits


# ------------------------------------------------------------- launch plan
# The jet backward's launch shape (CPU-side: the kernel is held to its plain
# version at every tier on a card, tests/test_torch_cuda.py).
BNETS = {"u64": (2, 64, 64, 64, 64, 1), "u50": (2, 50, 50, 50, 50, 1),
         "u64_d5": (5, 64, 64, 64, 64, 1)}
BEXTREMES = {
    "d16_w128_16layers": (16,) + (128,) * 15 + (1,),
    "width1": (2, 1, 1, 1),
    "widths_1_and_50": (2, 50, 1, 50, 1),
    "w128_shallow": (2, 128, 128, 1),
    "one_hidden": (2, 12, 1),
    **BNETS,
}


def _bwd_launchable(pl, layers):
    """What fwdlap_backward.cu's entry point checks before it launches: a
    planned design's tile and layout, or the tensor-core design's (T = 8 or
    a multiple of 16, its own layout)."""
    from nnpde_tpu_torch.kernels import _cuda, _plan
    from nnpde_tpu_torch.kernels import fused_step as tfs

    if pl.design == _cuda.DES_MMA:
        # (mma::flags_ok: the residencies, the device tiers, not the weights
        # both resident and in device memory)
        mma_flags = _plan.RES_WEIGHTS | _plan.RES_GRAD | _plan.DEV_WEIGHTS | _plan.DEV_SUMS
        return ((pl.T == 8 or (16 <= pl.T <= _cuda.NT // 2 and pl.T % 16 == 0))
                and not pl.flags & ~mma_flags
                and not (pl.flags & _plan.RES_WEIGHTS and pl.flags & _plan.DEV_WEIGHTS)
                and pl.smem <= _cuda.SMEM_MAX
                and pl.smem >= tfs.mma_smem_bytes(layers, pl.T, pl.flags, "fwdlap_backward"))
    return (4 <= pl.T <= _cuda.NT // 2 and pl.T % 4 == 0 and 0 <= pl.flags <= 7
            and pl.design in _cuda.PLANNED_DESIGNS
            and pl.smem >= 4 * tfc.backward_smem_floats(layers, pl.T, pl.flags)
            and pl.smem <= _cuda.SMEM_MAX)


@pytest.mark.parametrize("net,want", [
    ("u64", (16, 66944, "staged", 2)),      # planned 4 x 4 items (two-point: 28)
    ("u50", (36, 102560, "staged", 3)),     # two-point items, one wave of 234
    ("u64_d5", (16, 104192, "staged", 3)),  # eight stream-rows
])
def test_backward_plan_path_shapes(net, want):
    """Row 5 on the nets of the infinite-well kernel route (u50) and of the
    Poisson kernel route (u64, d = 2 and 5): two blocks per SM, staged, in
    the design the wrappers choose."""
    from nnpde_tpu_torch.kernels import _cuda, _plan

    layers = BNETS[net]
    pl = tfc.backward_plan(layers)
    assert (pl.T, pl.smem, pl.tier, pl.design) == want
    assert pl.flags == 0 and _bwd_launchable(pl, layers)
    assert pl.smem <= _cuda.SMEM_MAX // 2 - 1024
    # the gradient row on chip leaves no room for two blocks at this tile
    assert 4 * tfc.backward_smem_floats(layers, pl.T, _plan.RES_GRAD) > _cuda.SMEM_MAX // 2 - 1024


@pytest.mark.parametrize("design", ["wrapper", 4, 2, 3])
@pytest.mark.parametrize("net", sorted(BEXTREMES))
def test_backward_plan_takes_every_shape_the_wrapper_takes(net, design):
    """Every net the wrapper's check takes gets a plan the kernel takes, in
    every design (the planned ones, and the bf16-dot mode's tensor-core
    design, 4 = DES_MMA); a pinned tier at 16 points fits or raises; a
    pinned tile that does not fit raises."""
    from nnpde_tpu_torch.kernels import _cuda, _plan
    from nnpde_tpu_torch.kernels import fused_step as tfs

    design = None if design == "wrapper" else design
    layers = BEXTREMES[net]
    params = [(torch.zeros(a, b), torch.zeros(b)) for a, b in zip(layers[:-1], layers[1:])]
    ct = torch.zeros(8, layers[0] + 2)
    assert _cuda.net_layers("fwdlap_backward", params, torch.zeros(8, layers[0]), "sin",
                            (ct,)) == list(layers)
    pl = tfc.backward_plan(layers, design)
    assert _bwd_launchable(pl, layers)
    mma = design == _cuda.DES_MMA
    assert (pl.design == _cuda.DES_MMA) == mma
    # (the tensor-core design's smallest tier at 128 points: since its device
    # tiers, neither the weights nor the sums on chip)
    big = (min(tfs.mma_smem_bytes(layers, 128, flags, "fwdlap_backward")
               for _, flags in tfs.MMA_TIERS) if mma
           else 4 * tfc.backward_smem_floats(layers, 128))
    if big > _cuda.SMEM_MAX:
        with pytest.raises(ValueError, match="fit"):
            tfc.backward_plan(layers, design, T=128)
    for tier, _ in tfs.MMA_TIERS if mma else _plan.tiers(True):
        try:
            pinned = tfc.backward_plan(layers, pl.design, T=16, tier=tier)
        except ValueError:
            continue
        assert (pinned.T, pinned.tier) == (16, tier) and _bwd_launchable(pinned, layers)


def test_hidden_transposes_are_the_planned_kernels_wt():
    """The planned kernels read W_1^T .. W_{K-2}^T back to back (row-major,
    true sizes): one torch.cat of transposed views for equal widths, the
    same values for unequal ones; none for one hidden layer."""
    from nnpde_tpu_torch.kernels import _cuda

    rng = np.random.default_rng(3)
    for layers in ((2, 5, 5, 5, 1), (2, 5, 7, 3, 1), (3, 50, 50, 50, 50, 1)):
        params = [(torch.as_tensor(rng.normal(size=(a, b))), torch.zeros(b))
                  for a, b in zip(layers[:-1], layers[1:])]
        wt = _cuda.hidden_transposes(params)
        ref = torch.cat([W.t().reshape(-1) for W, _ in params[1:-1]])
        assert wt.is_contiguous() and torch.equal(wt, ref)
    assert _cuda.hidden_transposes([(torch.zeros(2, 4), torch.zeros(4)),
                                    (torch.zeros(4, 1), torch.zeros(1))]) is None
