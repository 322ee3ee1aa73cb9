"""The CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and skip where ``torch.cuda.is_available()``
is false.  They import neither jax nor the JAX package, so they also run on
a machine without JAX (``--noconftest`` skips the suite's JAX set-up):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: the float32 kernel against the float64 plain version, loss and
grad-tree rel <= 1e-5; two launches on the same inputs bitwise equal.  Every
wrapper is also run at hidden widths that are not multiples of 4 (50, the
default infinite-well net, and 10): the kernels pad such layers on chip.
"""

import math

import numpy as np
import pytest
import torch

from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import LAUNCHES
from nnpde_tpu_torch.kernels import fused_step as tfs
from nnpde_tpu_torch.tools.fwd_bf16_columns import SEEDS as C4_SEEDS

L = 2.0


def _np_params(rng, layers):
    out = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = 1.0 / math.sqrt(n_in)
        out.append((rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                    rng.uniform(-bound, bound, (n_out,)).astype(np.float32)))
    return out


def _tree_rel(a, b):
    num = sum(float(torch.sum((x.double() - y.double()) ** 2))
              for pa, pb in zip(a, b) for x, y in zip(pa, pb))
    den = sum(float(torch.sum(y.double() ** 2)) for pb in b for y in pb)
    return math.sqrt(num / max(den, 1e-300))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "analytic", "drm"])
@pytest.mark.parametrize("d,layers,act", [
    (2, (2, 64, 64, 64, 64, 1), "sin"),
    (5, (5, 32, 32, 1), "tanh"),
    (3, (3, 128, 96, 1), "gelu"),
    (2, (2, 50, 50, 50, 50, 1), "sin"),
    (2, (2, 10, 10, 1), "gelu"),
    (3, (3, 7, 1, 33, 1), "tanh"),
])
def test_cuda_kernel_matches_plain(dev, kind, d, layers, act):
    rng = np.random.default_rng(3)
    N = 1000 + 7
    pn = _np_params(rng, layers)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    nc = {"linear": d + 4, "analytic": 0, "drm": d + 2}[kind]
    coef = torch.as_tensor(rng.normal(size=(N, nc)).astype(np.float32), device=dev)
    ks = (1,) * d

    def run(p):
        if kind == "linear":
            return tfs.fused_linear_residual(p, X, coef, act)
        if kind == "drm":
            return tfs.fused_drm_energy(p, X, coef, act)
        return tfs.fused_poisson_analytic(p, X, act, L=L, ks=ks)

    name = {"linear": "fused_linear_residual", "analytic": "fused_poisson_analytic",
            "drm": "fused_drm_energy"}[kind]
    before = LAUNCHES[name]
    tp = params_from_jax(pn, device=dev)
    loss, _, grads = run(tp)
    loss2, _, grads2 = run(tp)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 2
    assert torch.equal(loss, loss2)
    assert all(torch.equal(x, y) for pa, pb in zip(grads, grads2) for x, y in zip(pa, pb))
    tp64 = params_from_jax(pn, device=dev, dtype=torch.float64)
    if kind == "analytic":
        dWs, dbs, sums = tfs.poisson_analytic_plain(
            tp64, X.double(), act, tfs.PoissonSinCoef(L, ks))
        scale = 2.0 / N
    else:
        plain = (tfs.linear_residual_plain if kind == "linear"
                 else tfs.drm_energy_plain)
        dWs, dbs, sums = plain(tp64, X.double(), coef.double(), act)
        scale = (2.0 if kind == "linear" else 1.0) / N
    ref = tfs._scaled_grads(tp64, dWs, dbs, sums, scale)
    want = float(sums[0]) / N
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    assert _tree_rel(grads, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(dev, name):
    """The wrapper's check of each kernel (``_cuda.net_layers``, a launch
    name) on card tensors, by its ``_cuda.LIMITS`` entry: the kernels of
    ``_cuda.BEYOND_KERNELS`` (every fp32 kernel, rows 1-12: ROADMAP.md B7's
    first three items) and ``_cuda.BEYOND_BF16`` (the bf16-dot modes of rows
    1-5, item 4a) take widths 257 and 1001, 24 weight matrices and d = 20
    (the jet forward's bf16-dot mode d to 16), and raise above width 4096;
    the bf16-dot modes of rows 7-12 raise on each, naming the roadmap item.  The DRM energy, which kept width 256 until
    then, launches on (2, 257, 1) (the launch counted, the loss finite);
    float64 tensors raise before any launch."""
    from nnpde_tpu_torch.kernels import _cuda

    rng = np.random.default_rng(0)
    beyond = ((2, 257, 1), (1, 1001, 300, 1), (2,) + (32,) * 23 + (1,), (20, 16, 16, 1))
    lim = _cuda.LIMITS[name]
    for layers in beyond + ((2, 4097, 1),):
        tp = params_from_jax(_np_params(rng, layers), device=dev)
        X = torch.rand(64, layers[0], device=dev)
        if (max(layers[1:-1]) <= lim.width and len(layers) - 1 <= lim.matrices
                and layers[0] <= lim.dim):
            assert _cuda.net_layers(name, tp, X, "sin") == list(layers)
        else:
            # the jet forward's bf16-dot mode above d = 16 names the JAX
            # kernel's own limit instead
            with pytest.raises(ValueError, match="_forward_kernel2" if layers[0] > lim.dim
                               and name == "fwdlap_forward.bf16" else "ROADMAP.md B7"):
                _cuda.net_layers(name, tp, X, "sin")
    if name == "fused_drm_energy":
        wide = params_from_jax(_np_params(rng, (2, 257, 1)), device=dev)
        before = LAUNCHES[name]
        loss, _, _ = tfs.fused_drm_energy(wide, torch.rand(64, 2, device=dev),
                                          torch.rand(64, 4, device=dev), "sin")
        torch.cuda.synchronize()
        assert LAUNCHES[name] == before + 1 and math.isfinite(float(loss))
    p64 = params_from_jax(_np_params(rng, (2, 32, 1)), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        _cuda.net_layers(name, p64, torch.rand(64, 2, device=dev, dtype=torch.float64), "sin")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwdlap_forward", "linear_sums", "linear_seeded",
                                  "quad_sums", "quad_seeded"])
@pytest.mark.parametrize("layers,act,lap", [
    ((2, 64, 64, 64, 64, 1), "sin", 0),
    ((2, 64, 64, 1), "sin", 0),
    ((5, 32, 32, 1), "tanh", 1),
    ((2, 50, 50, 50, 50, 1), "sin", 1),
    ((2, 10, 10, 1), "sin", 0),
])
def test_cuda_wan_kernel_matches_plain(dev, kind, layers, act, lap):
    """The WAN path's kernels: the jet per column, every sum within 1e-5 of
    the sum of its terms' magnitudes, the seeded grad row rel <= 1e-5; two
    launches bitwise equal."""
    from nnpde_tpu_torch.kernels import fused_quotient as tfq
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    if kind.startswith("quad"):
        lap = 0
    rng = np.random.default_rng(5)
    N, d = 1000 + 7, layers[0]
    pn = _np_params(rng, layers)
    tp = params_from_jax(pn, device=dev)
    tp64 = params_from_jax(pn, device=dev, dtype=torch.float64)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    nc = d + 5 if kind.startswith("linear") else d + 3
    coef = torch.as_tensor(rng.normal(size=(N, nc)).astype(np.float32), device=dev)
    scal = torch.tensor([0.3, -0.2, 0.7][:3 if kind.startswith("linear") else 2], device=dev)
    before = LAUNCHES[kind]
    if kind == "fwdlap_forward":
        out, out2 = tfc.fwdlap_forward(tp, X, act), tfc.fwdlap_forward(tp, X, act)
    else:
        out = tfq._launch(kind, tp, X, coef, scal, act, lap)
        out2 = tfq._launch(kind, tp, X, coef, scal, act, lap)
    torch.cuda.synchronize()
    assert LAUNCHES[kind] == before + 2
    assert torch.equal(out, out2)
    X64, c64, s64 = X.double(), coef.double(), scal.double()
    if kind == "fwdlap_forward":
        jet = tfc.fwdlap_forward_plain(tp64, X64, act)
        ref = torch.cat([jet.value[:, None], jet.grad, jet.lap[:, None]], dim=1)
        for c in range(d + 2):
            assert (torch.linalg.norm(out[:, c].double() - ref[:, c])
                    <= 1e-5 * torch.linalg.norm(ref[:, c]))
        return
    jet = tfc.fwdlap_forward_plain(tp64, X64, act)
    if kind.startswith("linear"):
        r = (c64[:, 0] * jet.value + torch.sum(c64[:, 1:1 + d] * jet.grad, dim=1)
             + c64[:, d + 2] + lap * c64[:, d + 1] * jet.lap)
        scale = torch.stack([r.abs().sum(), (r * r).sum(),
                             ((c64[:, d + 3] * jet.value) ** 2).sum(),
                             (c64[:, d + 4] * jet.value).abs().sum()])
    else:
        u = c64[:, 0] * jet.value
        G = c64[:, 0:1] * jet.grad + c64[:, 1:1 + d] * jet.value[:, None]
        e = 0.5 * torch.sum(G * G, dim=1) - c64[:, d + 1] * u + c64[:, d + 2] * u * u
        scale = torch.stack([e.abs().sum(), (u * u).sum()])
    if kind == "linear_sums":
        ref = tfq.linear_sums_plain(tp64, X64, c64, act, no_lap=lap == 0)
    elif kind == "quad_sums":
        ref = tfq.quad_sums_plain(tp64, X64, c64, act)
    if kind.endswith("sums"):
        assert torch.all(torch.abs(out.double() - ref) <= 1e-5 * scale)
        return
    if kind == "linear_seeded":
        dWs, dbs, sums = tfq.linear_seeded_plain(tp64, X64, c64, s64, act, no_lap=lap == 0)
    else:
        dWs, dbs, sums = tfq.quad_seeded_plain(tp64, X64, c64, s64, act)
    got = tfs._unflatten(tp, out)
    assert _tree_rel([got[0], got[1][:-1]], [dWs, dbs[:-1]]) <= 1e-5
    assert abs(float(got[2][0]) - float(sums[0])) <= 1e-5 * abs(float(sums[0]))


_JET_NETS = [
    ((2, 50, 50, 50, 50, 1), "sin"),
    ((2, 20, 20, 20, 1), "sin"),
    ((2, 64, 64, 1), "gelu"),
    ((5, 32, 32, 1), "tanh"),
    ((3, 10, 10, 1), "sin"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("layers,act", _JET_NETS)
def test_cuda_fwdlap_forward_streams_matches_plain(dev, layers, act):
    """The stream-major jet forward (row 6, the planned kernel's
    stream-major layout on the row forward's plan): each jet column rel <=
    1e-5 against the float64 recurrence, two launches bitwise equal, the
    returned (N, d+2) tensor a view of the kernel's (d+2, N) output, and
    equal to the row layout's output."""
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    rng = np.random.default_rng(11)
    N, d = 1000 + 7, layers[0]
    pn = _np_params(rng, layers)
    tp = params_from_jax(pn, device=dev)
    tp64 = params_from_jax(pn, device=dev, dtype=torch.float64)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    before = LAUNCHES["fwdlap_forward_streams"]
    out = tfc.fwdlap_forward(tp, X, act, "streams")
    out2 = tfc.fwdlap_forward(tp, X, act, "streams")
    torch.cuda.synchronize()
    assert LAUNCHES["fwdlap_forward_streams"] == before + 2
    assert out.shape == (N, d + 2) and out.t().is_contiguous()
    assert torch.equal(out, out2)
    assert torch.equal(out, tfc.fwdlap_forward(tp, X, act))
    jet = tfc.fwdlap_forward_plain(tp64, X.double(), act)
    ref = torch.cat([jet.value[:, None], jet.grad, jet.lap[:, None]], dim=1)
    for c in range(d + 2):
        assert (torch.linalg.norm(out[:, c].double() - ref[:, c])
                <= 1e-5 * torch.linalg.norm(ref[:, c]))


@pytest.mark.cuda
@pytest.mark.parametrize("layers,act", _JET_NETS)
def test_cuda_fwdlap_backward_matches_plain(dev, layers, act):
    """The recompute backward from a random (N, d+2) cotangent: the grad
    tree rel <= 1e-5 against autograd through the float64 recurrence, two
    launches bitwise equal."""
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    rng = np.random.default_rng(12)
    N, d = 1000 + 7, layers[0]
    pn = _np_params(rng, layers)
    tp = params_from_jax(pn, device=dev)
    tp64 = params_from_jax(pn, device=dev, dtype=torch.float64)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    ct = torch.as_tensor(rng.normal(size=(N, d + 2)).astype(np.float32), device=dev)
    before = LAUNCHES["fwdlap_backward"]
    dWs, dbs = tfc.fwdlap_backward(tp, X, ct, act)
    dWs2, dbs2 = tfc.fwdlap_backward(tp, X, ct, act)
    torch.cuda.synchronize()
    assert LAUNCHES["fwdlap_backward"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(dWs + dbs, dWs2 + dbs2))
    rW, rb = tfc.fwdlap_backward_plain(tp64, X.double(), ct.double(), act)
    assert _tree_rel([dWs, dbs], [rW, rb]) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("fwd_impl", ["rows", "streams"])
def test_cuda_jet_kernel_is_differentiable(dev, fwd_impl):
    """A loss through ``SolutionModel.fields(impl='kernel')`` on the card:
    value and every gradient leaf rel <= 1e-5 of the float64 ``impl='torch'``
    route; exactly one forward and one backward launch."""
    from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique

    layers = (2, 50, 50, 1)
    rng = np.random.default_rng(13)
    pn = _np_params(rng, layers)
    X = torch.as_tensor(rng.uniform(0.0, L, (777, 2)).astype(np.float32), device=dev)
    model = SolutionModel(NetSpec(layers, activation="sin"),
                          factor_for_technique("FBC", dim=2, kind="box", L=L))

    def loss_of(p, Xa, **kw):
        jet = model.fields(p, Xa, **kw)
        return torch.mean((jet.lap + 3.0 * jet.value) ** 2) + torch.mean(jet.grad ** 2)

    tp = [(W.requires_grad_(True), b.requires_grad_(True))
          for W, b in params_from_jax(pn, device=dev)]
    fwd = "fwdlap_forward_streams" if fwd_impl == "streams" else "fwdlap_forward"
    before = (LAUNCHES[fwd], LAUNCHES["fwdlap_backward"])
    val = loss_of(tp, X, impl="kernel", fwd_impl=fwd_impl)
    g = torch.autograd.grad(val, [t for pair in tp for t in pair])
    torch.cuda.synchronize()
    assert (LAUNCHES[fwd], LAUNCHES["fwdlap_backward"]) == (before[0] + 1, before[1] + 1)
    tp64 = [(W.requires_grad_(True), b.requires_grad_(True))
            for W, b in params_from_jax(pn, device=dev, dtype=torch.float64)]
    ref = loss_of(tp64, X.double())
    gr = torch.autograd.grad(ref, [t for pair in tp64 for t in pair])
    assert abs(float(val.detach()) - float(ref.detach())) <= 1e-5 * abs(float(ref.detach()))
    for a, b in zip(g, gr):
        assert torch.linalg.norm(a.double() - b) <= 1e-5 * torch.linalg.norm(b)


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("Kb", [1, 4, 16, 42])
@pytest.mark.parametrize("layers,act", [
    ((2, 50, 50, 50, 50, 1), "sin"),
    ((2, 20, 20, 20, 1), "sin"),
    ((3, 10, 10, 1), "tanh"),
])
def test_cuda_multibump_kernel_matches_plain(dev, seeded, Kb, layers, act):
    """The K-bump pair: every sum within 1e-5 of the sum of its terms'
    magnitudes, the seeded grad row and sum ct_v rel <= 1e-5; two launches
    bitwise equal."""
    _check_multibump(dev, seeded, Kb, layers, act)


def _check_multibump(dev, seeded, Kb, layers, act, N=1000 + 7, **pin):
    from nnpde_tpu_torch.kernels import fused_multibump as tfm
    from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap

    rng = np.random.default_rng(14)
    d = layers[0]
    pn = _np_params(rng, layers)
    tp = params_from_jax(pn, device=dev)
    tp64 = params_from_jax(pn, device=dev, dtype=torch.float64)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    coef = torch.as_tensor(rng.normal(size=(N, Kb * (d + 4))).astype(np.float32), device=dev)
    scal = torch.as_tensor(rng.normal(size=(3 * Kb,)).astype(np.float32), device=dev)
    name = "multi_seeded" if seeded else "multi_sums"
    pl = tfm.plan(seeded, layers, Kb, **pin) if pin else None
    before = LAUNCHES[name]
    out = tfm._launch(seeded, tp, X, coef, scal, act, Kb, pl=pl)
    out2 = tfm._launch(seeded, tp, X, coef, scal, act, Kb, pl=pl)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 2
    assert torch.equal(out, out2)
    X64, c64, s64 = X.double(), coef.double(), scal.double()
    if not seeded:
        ref = tfm.fused_multi_sums_plain(tp64, X64, c64, act, Kb)
        r, mass, lin = tfm._multi_terms(mlp_fwdlap(tp64, X64, act), c64, Kb, d)
        scale = torch.cat([r.abs().sum(0), mass.sum(0), lin.abs().sum(0)])
        assert torch.all(torch.abs(out.double() - ref) <= 1e-5 * scale)
        return
    dWs, dbs, sums = tfm.fused_multi_seeded_grads_plain(tp64, X64, c64, s64, act, Kb)
    got = tfs._unflatten(tp, out)
    assert _tree_rel([got[0], got[1][:-1]], [dWs, dbs[:-1]]) <= 1e-5
    # sum ct_v nearly cancels on random coefficients: hold it to the sum of
    # its terms' magnitudes
    blk, v = d + 2, mlp_fwdlap(tp64, X64, act).value
    e1, e2 = c64[:, Kb * blk:Kb * blk + Kb], c64[:, Kb * blk + Kb:Kb * blk + 2 * Kb]
    ctv = torch.sum(s64[:Kb] * c64[:, 0:Kb * blk:blk] + s64[Kb:2 * Kb] * 2.0 * e1 * e1
                    * v[:, None] + s64[2 * Kb:] * e2, dim=1)
    assert abs(float(got[2][0]) - float(sums[0])) <= 1e-5 * float(ctv.abs().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("tier", ["resident", "staged"])
@pytest.mark.parametrize("layers,T", [((2, 50, 50, 50, 50, 1), 16), ((2, 50, 50, 50, 50, 1), 28),
                                      ((2, 20, 20, 20, 1), 72), ((2, 20, 20, 1), 128)])
def test_cuda_multibump_plan_tiers(dev, seeded, tier, layers, T):
    """Each tier of the plan, pinned, at tiles below, at and above the
    plan's own: the same bars as the plan's choice."""
    _check_multibump(dev, seeded, 16, layers, "sin", T=T, tier=tier)


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("layers,Kb,act", [
    ((16,) + (128,) * 15 + (1,), 42, "tanh"),      # d, width, depth, bumps at their caps
    ((2, 1, 1, 1), 3, "sin"),
    ((2, 50, 1, 50, 1), 16, "sin"),
    ((2, 128, 128, 1), 42, "gelu"),
    ((2, 12, 1), 16, "sin"),                       # one hidden layer: nothing saved
])
def test_cuda_multibump_extreme_shapes(dev, seeded, layers, Kb, act):
    _check_multibump(dev, seeded, Kb, layers, act, N=300 + 1)


@pytest.mark.cuda
def test_cuda_multibump_smem_layout_mirror(dev):
    """The plan's shared-memory bytes are the kernel's own count, on the
    nets beyond the bf16-dot modes' limits too."""
    import ctypes

    from nnpde_tpu_torch.kernels import _build
    from nnpde_tpu_torch.kernels import fused_multibump as tfm

    lib = _build.load()
    for layers in [(2, 50, 50, 50, 50, 1), (2, 20, 20, 20, 1), (5, 7, 9, 1), (2, 12, 1),
                   (2, 300, 300, 1), (20, 16, 16, 1), (2,) + (8,) * 20 + (1,)]:
        lay = (ctypes.c_int * len(layers))(*layers)
        for seeded in (False, True):
            for Kb in (1, 16, 42):
                for flags in range(8):
                    for T in (4, 16, 72):
                        assert lib.fused_multibump_smem_bytes(
                            int(seeded), Kb, ctypes.addressof(lay), len(layers), T,
                            flags) == 4 * tfm.smem_floats(seeded, layers, T, Kb, flags)


def _check_quotient(dev, kind, layers, act, lap, N=1000 + 7, **pin):
    """One seeded quotient launch (plan pinned by ``pin``, else the plan's
    own) against the float64 plain version: grad row rel <= 1e-5, sum ct_v
    rel <= 1e-5; two launches bitwise equal."""
    from nnpde_tpu_torch.kernels import fused_quotient as tfq

    rng = np.random.default_rng(15)
    d = layers[0]
    pn = _np_params(rng, layers)
    tp = params_from_jax(pn, device=dev)
    tp64 = params_from_jax(pn, device=dev, dtype=torch.float64)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    linear = kind == "linear_seeded"
    coef = torch.as_tensor(rng.normal(size=(N, d + (5 if linear else 3))).astype(np.float32),
                           device=dev)
    scal = torch.tensor([0.3, -0.2, 0.7] if linear else [0.4, -0.3], device=dev)
    pl = tfq.plan(kind, layers, lap, **pin) if pin else None
    before = LAUNCHES[kind]
    out = tfq._launch(kind, tp, X, coef, scal, act, lap, pl=pl)
    out2 = tfq._launch(kind, tp, X, coef, scal, act, lap, pl=pl)
    torch.cuda.synchronize()
    assert LAUNCHES[kind] == before + 2
    assert torch.equal(out, out2)
    X64, c64, s64 = X.double(), coef.double(), scal.double()
    if linear:
        dWs, dbs, sums = tfq.linear_seeded_plain(tp64, X64, c64, s64, act, no_lap=lap == 0)
    else:
        dWs, dbs, sums = tfq.quad_seeded_plain(tp64, X64, c64, s64, act)
    got = tfs._unflatten(tp, out)
    assert _tree_rel([got[0], got[1][:-1]], [dWs, dbs[:-1]]) <= 1e-5
    assert abs(float(got[2][0]) - float(sums[0])) <= 1e-5 * abs(float(sums[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear_seeded", "quad_seeded"])
@pytest.mark.parametrize("tier", ["resident", "gradient", "staged"])
@pytest.mark.parametrize("layers,T", [((2, 64, 64, 1), 16), ((2, 64, 64, 1), 20),
                                      ((2, 50, 50, 50, 50, 1), 16), ((2, 20, 20, 1), 48)])
def test_cuda_quotient_plan_tiers(dev, kind, tier, layers, T):
    """Each tier of the seeded quotient kernels' plan, pinned, at the plan's
    tile and above it; N = 1007 is a multiple of none of these tiles."""
    _check_quotient(dev, kind, layers, "sin", 0, T=T, tier=tier)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["resident", "gradient", "staged"])
@pytest.mark.parametrize("layers,act", [((2, 64, 64, 1), "sin"), ((5, 32, 32, 1), "tanh"),
                                        ((3, 50, 50, 50, 1), "gelu")])
def test_cuda_linear_seeded_with_laplacian(dev, tier, layers, act):
    """The linear seeded kernel carrying the Laplacian stream (S = d + 2),
    at every tier, on a ragged last tile (N = 1001)."""
    _check_quotient(dev, "linear_seeded", layers, act, 1, N=1001, T=16, tier=tier)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear_seeded", "quad_seeded"])
@pytest.mark.parametrize("layers", [(16,) + (128,) * 15 + (1,), (2, 1, 1, 1), (2, 50, 1, 50, 1),
                                    (2, 128, 128, 1), (2, 12, 1)])
def test_cuda_quotient_extreme_shapes(dev, kind, layers):
    """The plan's own choice at the extremes the wrapper takes."""
    _check_quotient(dev, kind, layers, "tanh", 0, N=300 + 1)


@pytest.mark.cuda
def test_cuda_quotient_smem_layout_mirror(dev):
    """The quotient plan's shared-memory bytes are the kernel's own count."""
    import ctypes

    from nnpde_tpu_torch.kernels import _build
    from nnpde_tpu_torch.kernels import fused_quotient as tfq

    lib = _build.load()
    codes = {"linear_sums": 0, "linear_seeded": 1, "quad_sums": 2, "quad_seeded": 3}
    for layers in [(2, 64, 64, 1), (2, 64, 64, 64, 64, 1), (2, 50, 50, 50, 50, 1), (5, 7, 9, 1),
                   (2, 12, 1)]:
        lay = (ctypes.c_int * len(layers))(*layers)
        for kind, code in codes.items():
            for lap in ((0, 1) if kind.startswith("linear") else (0,)):
                for flags in (range(8) if kind.endswith("seeded") else (0, 1)):
                    for T in (4, 16, 20, 48):
                        assert lib.fused_quotient_smem_bytes(
                            code, lap, ctypes.addressof(lay), len(layers), T,
                            flags) == 4 * tfq.smem_floats(kind, layers, T, lap, flags)


# ------------------------------------------- rows 1-3 and 5: the planned design
_FUSED = {"linear": "fused_linear_residual", "analytic": "fused_poisson_analytic",
          "drm": "fused_drm_energy"}
_EXTREMES = [(16,) + (128,) * 15 + (1,), (2, 1, 1, 1), (2, 50, 1, 50, 1), (2, 128, 128, 1),
             (2, 12, 1)]


def _fused_plan(kind, layers, **pin):
    """The plan pinned by ``pin`` (T, tier, design), or None where it does
    not fit SMEM_MAX (then the layout indeed exceeds it)."""
    from nnpde_tpu_torch.kernels import _cuda

    design = pin.pop("design", None)
    try:
        return tfs.plan(_FUSED[kind], layers, design, **pin)
    except ValueError:
        T = pin.get("T", 16)
        flags = {"resident": 5, "gradient": 4, "staged": 0, None: 0}[pin.get("tier")]
        assert 4 * tfs.smem_floats(_FUSED[kind], layers, T, flags) > _cuda.SMEM_MAX - 4096
        return None


def _check_fused(dev, kind, layers, act, N=1000 + 7, pl=None):
    """One fused launch (at ``pl``, else the wrapper's plan) against the
    float64 plain version: loss and grad-tree rel <= 1e-5; two launches
    bitwise equal."""
    rng = np.random.default_rng(17)
    d = layers[0]
    name = _FUSED[kind]
    pn = _np_params(rng, layers)
    tp = params_from_jax(pn, device=dev)
    tp64 = params_from_jax(pn, device=dev, dtype=torch.float64)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    nc = {"linear": d + 4, "analytic": 0, "drm": d + 2}[kind]
    coef = (torch.as_tensor(rng.normal(size=(N, nc)).astype(np.float32), device=dev)
            if nc else None)
    coef_fn = tfs.PoissonSinCoef(L, (1,) * d)
    analytic = tfs._analytic_args(coef_fn, d) if kind == "analytic" else None
    before = LAUNCHES[name]
    out = tfs._launch(name, tp, X, coef, act, analytic, pl=pl)
    out2 = tfs._launch(name, tp, X, coef, act, analytic, pl=pl)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 2
    assert torch.equal(out, out2)
    if kind == "analytic":
        dWs, dbs, sums = tfs.poisson_analytic_plain(tp64, X.double(), act, coef_fn)
    elif kind == "linear":
        dWs, dbs, sums = tfs.linear_residual_plain(tp64, X.double(), coef.double(), act)
    else:
        dWs, dbs, sums = tfs.drm_energy_plain(tp64, X.double(), coef.double(), act)
    scale = (1.0 if kind == "drm" else 2.0) / N
    got = tfs._unflatten(tp, out)
    grads = tfs._scaled_grads(tp, got[0], got[1], got[2], scale)
    ref = tfs._scaled_grads(tp64, dWs, dbs, sums, scale)
    assert abs(float(got[2][0]) - float(sums[0])) <= 1e-5 * abs(float(sums[0]))
    assert _tree_rel(grads, ref) <= 1e-5


def _check_backward(dev, layers, act, N=1000 + 7, pl=None):
    """One jet-backward launch (at ``pl``, else the wrapper's plan) from a
    random cotangent against autograd through the float64 recurrence: grad
    tree rel <= 1e-5; two launches bitwise equal."""
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    rng = np.random.default_rng(18)
    d = layers[0]
    pn = _np_params(rng, layers)
    tp = params_from_jax(pn, device=dev)
    tp64 = params_from_jax(pn, device=dev, dtype=torch.float64)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    ct = torch.as_tensor(rng.normal(size=(N, d + 2)).astype(np.float32), device=dev)
    before = LAUNCHES["fwdlap_backward"]
    dWs, dbs = tfc.fwdlap_backward(tp, X, ct, act, pl=pl)
    dWs2, dbs2 = tfc.fwdlap_backward(tp, X, ct, act, pl=pl)
    torch.cuda.synchronize()
    assert LAUNCHES["fwdlap_backward"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(dWs + dbs, dWs2 + dbs2))
    rW, rb = tfc.fwdlap_backward_plain(tp64, X.double(), ct.double(), act)
    assert _tree_rel([dWs, dbs], [rW, rb]) <= 1e-5


_TIER_SHAPES = [((2, 64, 64, 64, 64, 1), 16, "sin"), ((2, 64, 64, 64, 64, 1), 28, "sin"),
                ((2, 50, 50, 50, 50, 1), 20, "gelu"), ((2, 50, 50, 50, 50, 1), 36, "sin"),
                ((5, 32, 32, 1), 24, "tanh"), ((2, 20, 20, 1), 48, "tanh")]


@pytest.mark.cuda
@pytest.mark.parametrize("design", [2, 3])
@pytest.mark.parametrize("tier", ["resident", "gradient", "staged"])
@pytest.mark.parametrize("layers,T,act", _TIER_SHAPES)
@pytest.mark.parametrize("kind", ["linear", "analytic", "drm"])
def test_cuda_fused_plan_tiers(dev, kind, layers, T, act, tier, design):
    """Rows 1-3 in each planned design (2: 4 x 4 items, 3: two-point items)
    at each tier, pinned, at a range of tiles; N = 1007 is a multiple of
    none of them.  A pin that does not fit raises (and its layout exceeds
    SMEM_MAX)."""
    pl = _fused_plan(kind, layers, T=T, tier=tier, design=design)
    if pl is not None:
        assert (pl.T, pl.tier, pl.design) == (T, tier, design)
        _check_fused(dev, kind, layers, act, pl=pl)


@pytest.mark.cuda
@pytest.mark.parametrize("design", [2, 3])
@pytest.mark.parametrize("tier", ["resident", "gradient", "staged"])
@pytest.mark.parametrize("layers,T,act", _TIER_SHAPES)
def test_cuda_backward_plan_tiers(dev, layers, T, act, tier, design):
    """Row 5 the same way."""
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    try:
        pl = tfc.backward_plan(layers, design, T=T, tier=tier)
    except ValueError:
        return
    assert (pl.T, pl.tier, pl.design) == (T, tier, design)
    _check_backward(dev, layers, act, pl=pl)


@pytest.mark.cuda
@pytest.mark.parametrize("design", [None, 2, 3])
@pytest.mark.parametrize("layers", _EXTREMES)
@pytest.mark.parametrize("kind", ["linear", "analytic", "drm", "backward"])
def test_cuda_fused_extreme_shapes(dev, kind, layers, design):
    """Rows 1-3 and 5 at the extremes the wrappers take (d = 16 with 16
    layers of width 128, width 1, widths 1 and 50, one hidden layer), in
    the wrappers' choice and each planned design at its own plan."""
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    if kind == "backward":
        _check_backward(dev, layers, "tanh", N=300 + 1, pl=tfc.backward_plan(layers, design))
    else:
        _check_fused(dev, kind, layers, "tanh", N=300 + 1,
                     pl=tfs.plan(_FUSED[kind], layers, design))


@pytest.mark.cuda
def test_cuda_fused_smem_layout_mirror(dev):
    """The layouts of rows 1-3 and 5 in Python (every residency) are the
    kernels' own count."""
    import ctypes

    from nnpde_tpu_torch.kernels import _build
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    lib = _build.load()
    for layers in [(2, 64, 64, 64, 64, 1), (2, 50, 50, 50, 50, 1), (5, 7, 9, 1), (2, 12, 1),
                   (16,) + (128,) * 15 + (1,)]:
        lay = (ctypes.c_int * len(layers))(*layers)
        for flags in range(8):
            for T in (4, 16, 28, 36, 48):
                for mode, kind in enumerate(_FUSED.values()):
                    assert lib.fused_smem_bytes(
                        mode, ctypes.addressof(lay), len(layers), T,
                        flags) == 4 * tfs.smem_floats(kind, layers, T, flags)
                assert lib.fwdlap_backward_smem_bytes(
                    ctypes.addressof(lay), len(layers), T,
                    flags) == 4 * tfc.backward_smem_floats(layers, T, flags)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "backward"])
def test_cuda_planned_designs_agree_at_one_plan(dev, kind):
    """At one tile and tier the two planned designs sum every entry of a
    tile in the same order (4 x 4 and two-point items, the same dW items):
    on u64 at 16 points, staged, they agree bitwise where they launch the
    same grid, and within 1e-6 in any case; design 0 gets no plan (no
    kernel runs it)."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    layers = (2, 64, 64, 64, 64, 1)
    rng = np.random.default_rng(19)
    tp = params_from_jax(_np_params(rng, layers), device=dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (2000, 2)).astype(np.float32), device=dev)
    other = torch.as_tensor(np.random.default_rng(20).normal(size=(2000, 6)).astype(
        np.float32), device=dev)
    name = "fwdlap_backward" if kind == "backward" else "fused_linear_residual"

    def plan(des, **pin):
        return (tfc.backward_plan(layers, des, **pin) if kind == "backward"
                else tfs.plan(name, layers, des, **pin))

    def run(pl):
        if kind == "backward":
            dWs, dbs = tfc.fwdlap_backward(tp, X, other[:, :4].contiguous(), "sin", pl=pl)
            return torch.cat([t.reshape(-1) for pr in zip(dWs, dbs) for t in pr])
        return tfs._launch(name, tp, X, other, "sin", pl=pl)

    plans = [plan(des, T=16, tier="staged") for des in _cuda.PLANNED_DESIGNS]
    outs = [run(pl) for pl in plans]
    torch.cuda.synchronize()
    grids = {_cuda.grid(name, None, pl.smem, X.device, 2000 // 16 + 1,
                        tfs.variant(layers, 4, pl)[1]) for pl in plans}
    if len(grids) == 1:
        assert torch.equal(outs[0], outs[1])
    assert float(torch.linalg.norm(outs[0] - outs[1]) / torch.linalg.norm(outs[0])) <= 1e-6
    with pytest.raises(ValueError, match="design 0"):
        run(plan(0))


# ------------------------------- rows 4, 7 and 9: the planned forward-only design
def _check_pass_a(dev, kind, layers, act, lap=0, N=1000 + 7, pl=None):
    """One launch of the jet forward or a sums kind at ``pl`` (else the
    wrapper's plan) against its float64 plain version: each jet column rel
    <= 1e-5, every sum within 1e-5 of the sum of its terms' magnitudes; two
    launches bitwise equal and counted."""
    from nnpde_tpu_torch.kernels import fused_quotient as tfq
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    rng = np.random.default_rng(33)
    d = layers[0]
    pn = _np_params(rng, layers)
    tp = params_from_jax(pn, device=dev)
    tp64 = params_from_jax(pn, device=dev, dtype=torch.float64)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    nc = d + 5 if kind == "linear_sums" else d + 3
    coef = torch.as_tensor(rng.normal(size=(N, nc)).astype(np.float32), device=dev)
    before = LAUNCHES[kind]
    fwd = kind.startswith("fwdlap_forward")
    if fwd:
        impl = "streams" if kind == "fwdlap_forward_streams" else "rows"
        out = tfc.fwdlap_forward(tp, X, act, impl, pl=pl)
        out2 = tfc.fwdlap_forward(tp, X, act, impl, pl=pl)
        assert (out.t() if impl == "streams" else out).is_contiguous()
    else:
        out = tfq._launch(kind, tp, X, coef, None, act, lap, pl=pl)
        out2 = tfq._launch(kind, tp, X, coef, None, act, lap, pl=pl)
    torch.cuda.synchronize()
    assert LAUNCHES[kind] == before + 2
    assert torch.equal(out, out2)
    jet = tfc.fwdlap_forward_plain(tp64, X.double(), act)
    if fwd:
        ref = torch.cat([jet.value[:, None], jet.grad, jet.lap[:, None]], dim=1)
        for c in range(d + 2):
            assert (torch.linalg.norm(out[:, c].double() - ref[:, c])
                    <= 1e-5 * torch.linalg.norm(ref[:, c]))
        return
    c64 = coef.double()
    if kind == "linear_sums":
        r = (c64[:, 0] * jet.value + torch.sum(c64[:, 1:1 + d] * jet.grad, dim=1)
             + c64[:, d + 2] + lap * c64[:, d + 1] * jet.lap)
        scale = torch.stack([r.abs().sum(), (r * r).sum(),
                             ((c64[:, d + 3] * jet.value) ** 2).sum(),
                             (c64[:, d + 4] * jet.value).abs().sum()])
        ref = tfq.linear_sums_plain(tp64, X.double(), c64, act, no_lap=lap == 0)
    else:
        u = c64[:, 0] * jet.value
        G = c64[:, 0:1] * jet.grad + c64[:, 1:1 + d] * jet.value[:, None]
        e = 0.5 * torch.sum(G * G, dim=1) - c64[:, d + 1] * u + c64[:, d + 2] * u * u
        scale = torch.stack([e.abs().sum(), (u * u).sum()])
        ref = tfq.quad_sums_plain(tp64, X.double(), c64, act)
    assert torch.all(torch.abs(out.double() - ref) <= 1e-5 * scale)


def _pass_a_plan(kind, layers, lap, **pin):
    from nnpde_tpu_torch.kernels import fused_quotient as tfq
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    if kind.startswith("fwdlap_forward"):
        return tfc.forward_plan(layers, **pin)
    return tfq.plan(kind, layers, lap, **pin)


# (layers, T, act): the fold variant on u64 (S = 4 with the Laplacian, 3
# without), ragged widths at 36 points, the variant without the fold at
# d = 5, a narrow net at 48 points
_PASS_A_SHAPES = [((2, 64, 64, 64, 64, 1), 16, "sin"), ((2, 64, 64, 64, 64, 1), 32, "sin"),
                  ((2, 50, 50, 50, 50, 1), 36, "gelu"), ((5, 32, 32, 32, 1), 16, "tanh"),
                  ((2, 20, 20, 20, 1), 48, "tanh")]


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [2, 3])
@pytest.mark.parametrize("design", [2, 3])
@pytest.mark.parametrize("tier", ["resident", "staged"])
@pytest.mark.parametrize("layers,T,act", _PASS_A_SHAPES)
@pytest.mark.parametrize("kind,lap", [("fwdlap_forward", 1), ("fwdlap_forward_streams", 1),
                                      ("linear_sums", 0), ("linear_sums", 1), ("quad_sums", 0)])
def test_cuda_pass_a_plan_tiers(dev, kind, lap, layers, T, act, tier, design, blocks):
    """Rows 4, 6 (the jet forward's stream-major layout), 7 and 9 in each
    planned design (2: 4 x 4 items, 3: two-point items) at each tier,
    pinned, with and without the fold, at each register budget their shared
    memory allows: the plans ``chip_smoke.py sweep`` can pin; N = 1007 is a
    multiple of none of these tiles."""
    pl = _pass_a_plan(kind, layers, lap, design=design, T=T, tier=tier, blocks=blocks)
    assert (pl.T, pl.tier, pl.design) == (T, tier, design) and pl.blocks <= blocks
    _check_pass_a(dev, kind, layers, act, lap, pl=pl)


@pytest.mark.cuda
@pytest.mark.parametrize("design", [None, 2, 3])
@pytest.mark.parametrize("layers", _EXTREMES)
@pytest.mark.parametrize("kind,lap", [("fwdlap_forward", 1), ("fwdlap_forward_streams", 1),
                                      ("linear_sums", 1), ("quad_sums", 0)])
def test_cuda_pass_a_extreme_shapes(dev, kind, lap, layers, design):
    """Rows 4, 6, 7 and 9 at the extremes the wrappers take, in the
    wrappers' choice and in each planned design at its own plan."""
    _check_pass_a(dev, kind, layers, "tanh", lap, N=300 + 1,
                  pl=_pass_a_plan(kind, layers, lap, design=design))


@pytest.mark.cuda
def test_cuda_forward_smem_layout_mirror(dev):
    """The jet forward's layouts in Python (the planned kernel's, both
    output layouts, each residency) are the kernel's own count."""
    import ctypes

    from nnpde_tpu_torch.kernels import _build, _plan
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    lib = _build.load()
    for layers in [(2, 64, 64, 64, 64, 1), (2, 50, 50, 50, 50, 1), (5, 7, 9, 1), (2, 12, 1),
                   (16,) + (128,) * 15 + (1,)]:
        lay = (ctypes.c_int * len(layers))(*layers)
        for flags in (0, _plan.RES_WEIGHTS):
            for T in (4, 16, 28, 36, 48):
                assert lib.fwdlap_forward_smem_bytes(
                    ctypes.addressof(lay), len(layers), T,
                    flags) == 4 * tfc.forward_smem_floats(layers, T, flags)


@pytest.mark.cuda
def test_cuda_forward_refuses_a_plan_outside_its_design(dev):
    """fp32 rows, in either output layout, take a planned design and the
    bf16-dot rows the tensor-core design, each only its own (a crossed pin,
    or design 0, raises)."""
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    layers = (2, 16, 16, 1)
    tp = params_from_jax(_np_params(np.random.default_rng(34), layers), device=dev)
    X = torch.zeros((64, 2), device=dev)
    with pytest.raises(ValueError, match="design 0"):
        tfc.fwdlap_forward(tp, X, "sin", pl=tfc.forward_plan(layers, 0))
    with pytest.raises(ValueError, match="tensor-core design and only it"):
        tfc.fwdlap_forward(tp, X, "sin", pl=tfs.mma_plan("fwdlap_forward", layers))
    with pytest.raises(ValueError, match="tensor-core design and only it"):
        tfc.fwdlap_forward(tp, X, "sin", "rows:default", pl=tfc.forward_plan(layers))
    with pytest.raises(ValueError, match="tensor-core design and only it"):
        tfc.fwdlap_forward(tp, X, "sin", "streams", pl=tfs.mma_plan("fwdlap_forward", layers))


# --------------------------------------------------------- bf16-dot variants
_BF16_NETS = [
    ((2, 64, 64, 64, 64, 1), "sin"),
    ((5, 32, 32, 1), "tanh"),
    ((3, 50, 50, 1), "gelu"),
    ((2, 10, 10, 1), "sin"),
    # the tensor-core design of rows 1 and 2 at the paths' nets (u50; u64 at
    # d = 5) and its padding shapes: width 1, width 50 between widths 1, width
    # 128, d = 16 (18 streams: 8-point tiles)
    ((2, 50, 50, 50, 50, 1), "sin"),
    ((5, 64, 64, 64, 64, 1), "sin"),
    ((2, 1, 1, 1), "tanh"),
    ((2, 50, 1, 50, 1), "sin"),
    ((2, 128, 128, 1), "gelu"),
    ((16, 32, 32, 1), "sin"),
]


def _leaf_rel(a, b):
    return max(float(torch.linalg.norm(x.double() - y.double()))
               / max(float(torch.linalg.norm(y.double())), 1e-30) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "analytic", "forward", "backward"])
@pytest.mark.parametrize("layers,act", _BF16_NETS)
def test_cuda_bf16_kernel_matches_plain(dev, kind, layers, act):
    """The bf16-dot variants (``dot_dtype='bfloat16'``, ``fwd_impl=
    'rows:default'``) against their plain bf16-dot versions, float32 on the
    card: loss and every gradient leaf norm-rel <= 1e-4, every jet column
    <= 5e-4 (a per-point output keeps the rare operand that rounds to the
    other bf16 neighbour under the two sum orders); two launches bitwise
    equal, each counted under ``<kernel>.bf16``.  The backward takes the
    cotangent a Poisson residual gives it.  All four run the tensor-core
    design (``DES_MMA``) on every net."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc
    from nnpde_tpu_torch.models import factor_for_technique

    rng = np.random.default_rng(17)
    N, d = 1000 + 7, layers[0]
    tp = params_from_jax(_np_params(rng, layers), device=dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    fj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(X)
    coef = tfs.residual_coefficients(fj, a0=-1.0, rhs=torch.sin(X[:, 0]))
    ks = (1,) * d

    if kind == "linear":
        name = "fused_linear_residual.bf16"

        def run():
            loss, _, g = tfs.fused_linear_residual(tp, X, coef, act, dot_dtype="bfloat16")
            return [loss.reshape(1)] + [t for pair in g for t in pair]

        dWs, dbs, sums = tfs.linear_residual_plain(tp, X, coef, act, "bfloat16")
    elif kind == "analytic":
        name = "fused_poisson_analytic.bf16"

        def run():
            loss, _, g = tfs.fused_poisson_analytic(tp, X, act, L=L, ks=ks,
                                                    dot_dtype="bfloat16")
            return [loss.reshape(1)] + [t for pair in g for t in pair]

        dWs, dbs, sums = tfs.poisson_analytic_plain(tp, X, act, tfs.PoissonSinCoef(L, ks),
                                                    "bfloat16")
    elif kind == "forward":
        name = "fwdlap_forward.bf16"

        def run():
            return [tfc.fwdlap_forward(tp, X, act, "rows:default")]

        ref = tfc.fwdlap_forward_default_plain(tp, X, act)
    else:
        name = "fwdlap_backward.bf16"
        jet = tfc.fwdlap_forward_plain(tp, X, act)
        r = (coef[:, 0] * jet.value + torch.sum(coef[:, 1:1 + d] * jet.grad, dim=1)
             + coef[:, d + 1] * jet.lap + coef[:, d + 2])
        ct = ((2.0 / N) * r[:, None] * coef[:, :d + 2]).contiguous()

        def run():
            dW, db = tfc.fwdlap_backward(tp, X, ct, act, "bfloat16")
            return [t for pair in zip(dW, db) for t in pair]

        rW, rb = tfc.fwdlap_backward_plain(tp, X, ct, act, "bfloat16")
        want = [t for pair in zip(rW, rb) for t in pair]
    if kind in ("linear", "analytic"):
        g = tfs._scaled_grads(tp, dWs, dbs, sums, 2.0 / N)
        want = [(sums[0] / N).reshape(1)] + [t for pair in g for t in pair]
    assert tfs.mma_plan(name[:-5], list(layers)).design == _cuda.DES_MMA
    before = LAUNCHES[name]
    out, out2 = run(), run()
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    if kind == "forward":
        for c in range(d + 2):
            assert (torch.linalg.norm(out[0][:, c].double() - ref[:, c].double())
                    <= 5e-4 * torch.linalg.norm(ref[:, c].double()))
    else:
        assert _leaf_rel(out, want) <= 1e-4


@pytest.mark.cuda
def test_cuda_bf16_jet_pair_is_differentiable(dev):
    """``SolutionModel.fields(impl='kernel', fwd_impl='rows:default',
    dot_dtype='bfloat16')`` on the card: one bf16-dot forward and one
    bf16-dot backward launch, gradient leaves within 1e-4 of the plain
    bf16-dot route on the same card."""
    from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique

    layers = (2, 64, 64, 64, 1)
    rng = np.random.default_rng(19)
    pn = _np_params(rng, layers)
    X = torch.as_tensor(rng.uniform(0.0, L, (2001, 2)).astype(np.float32), device=dev)
    model = SolutionModel(NetSpec(layers, activation="sin"),
                          factor_for_technique("FBC", dim=2, kind="box", L=L))
    kw = dict(impl="kernel", fwd_impl="rows:default", dot_dtype="bfloat16")

    def grads(Xa):
        tp = [(W.requires_grad_(True), b.requires_grad_(True))
              for W, b in params_from_jax(pn, device=Xa.device)]
        jet = model.fields(tp, Xa, **kw)
        val = torch.mean((jet.lap + torch.sin(Xa[:, 0])) ** 2)
        return [val.detach().reshape(1)] + list(
            torch.autograd.grad(val, [t for pair in tp for t in pair]))

    before = (LAUNCHES["fwdlap_forward.bf16"], LAUNCHES["fwdlap_backward.bf16"])
    got = grads(X)
    torch.cuda.synchronize()
    assert (LAUNCHES["fwdlap_forward.bf16"], LAUNCHES["fwdlap_backward.bf16"]) == (
        before[0] + 1, before[1] + 1)
    ref = [t.to(dev) for t in grads(X.cpu())]
    assert _leaf_rel(got, ref) <= 1e-4


# ----------------------------------- rows 1 and 2 bf16: the tensor-core design
@pytest.mark.cuda
def test_cuda_mma_layout_mirror(dev):
    """The tensor-core design's layout and saved-stage size in Python are
    the kernel's own count, for every tile and residency; tiles it does not
    take are refused."""
    import ctypes

    from nnpde_tpu_torch.kernels import _build, _plan

    lib = _build.load()
    for layers in [(2, 64, 64, 64, 64, 1), (2, 50, 50, 50, 50, 1), (5, 7, 9, 1), (2, 12, 1),
                   (3, 1, 1, 1), (16,) + (128,) * 15 + (1,)]:
        lay = (ctypes.c_int * len(layers))(*layers)
        for T in (8, 16, 32, 48):
            for mode in (0, 1):
                assert lib.fused_mma_scratch_floats(mode, ctypes.addressof(lay), len(layers),
                                                    T) == tfs.mma_scratch_floats(layers, T)
                for flags in (0, _plan.RES_WEIGHTS, _plan.RES_GRAD,
                              _plan.RES_WEIGHTS | _plan.RES_GRAD):
                    assert lib.fused_mma_smem_bytes(mode, ctypes.addressof(lay), len(layers),
                                                    T, flags) == tfs.mma_smem_bytes(
                                                        layers, T, flags)
        for T in (4, 12, 24):
            assert lib.fused_mma_smem_bytes(0, ctypes.addressof(lay), len(layers), T, 0) == -1
        # the DRM energy's (mode 2) without the Laplacian stream; no mode 3
        assert lib.fused_mma_smem_bytes(2, ctypes.addressof(lay), len(layers), 16,
                                        0) == tfs.mma_smem_bytes(layers, 16, 0,
                                                                 "fused_drm_energy")
        assert lib.fused_mma_smem_bytes(3, ctypes.addressof(lay), len(layers), 16, 0) == -1


def _mma_pins(layers):
    """Every tensor-core plan of this net at tiles 8, 16 and 32: each tier
    that fits two blocks per SM or one."""
    out = []
    for T in (8, 16, 32):
        for tier, _ in tfs.MMA_TIERS:
            for blocks in (1, 2):
                try:
                    pl = tfs.mma_plan("fused_linear_residual", layers, T=T, tier=tier,
                                      blocks=blocks)
                except ValueError:
                    continue
                if pl not in out:
                    out.append(pl)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("coef_kind", ["residual", "random"])
@pytest.mark.parametrize("layers", [(2, 64, 64, 64, 64, 1), (3, 50, 50, 1), (2, 50, 1, 50, 1)])
def test_cuda_mma_plans_match_plain(dev, layers, coef_kind):
    """Every tier and tile (8, 16, 32; 8 pads an odd stream count) of the
    tensor-core design, two launches bitwise equal (the gradient row on
    chip in fragment order on u64, flat on the ragged nets).  With the
    coefficients a Poisson residual gives: loss and every gradient leaf
    within 1e-4 of the plain bf16-dot version.  With random coefficients,
    whose random-sign sums keep the bf16 rounding's flips (on u64 the plain
    version alone is 5.4e-5 and 1.5e-4 from its float64 witness at two
    seeds, the kernel 1.4e-4 and 1.3e-4): within 8e-4 of the plain version,
    the bar chip_smoke.py holds the bf16-dot mode's random cotangents to
    (PREC_TOL_BWD_RANDOM), and, where the plain version is within 1e-5 of
    the witness, no further from it than 2x the plain version is, + 2e-6
    (on the bottleneck net dv summed in another order than the reference's
    put dW0 1.2e-5 from the witness)."""
    from nnpde_tpu_torch.models import factor_for_technique

    rng = np.random.default_rng(23)
    N, d = 1000 + 7, layers[0]
    tp = params_from_jax(_np_params(rng, layers), device=dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    if coef_kind == "residual":
        fj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(X)
        coef = tfs.residual_coefficients(fj, a0=-1.0, rhs=torch.sin(X[:, 0]))
    else:
        coef = torch.as_tensor(rng.normal(size=(N, d + 4)).astype(np.float32), device=dev)

    def plain(dtype):
        P = [(W.to(dtype), b.to(dtype)) for W, b in tp]
        dWs, dbs, sums = tfs.linear_residual_plain(P, X.to(dtype), coef.to(dtype), "sin",
                                                   "bfloat16")
        g = tfs._scaled_grads(P, dWs, dbs, sums, 2.0 / N)
        return [(sums[0] / N).reshape(1)] + [t for pair in g for t in pair]

    want, witness = plain(torch.float32), plain(torch.float64)
    w_plain = _leaf_rel(want, witness)
    for pl in _mma_pins(layers):
        def run():
            out = tfs._launch("fused_linear_residual", tp, X, coef, "sin", bf16=True, pl=pl)
            dW, db, sm = tfs._unflatten(tp, out)
            gr = tfs._scaled_grads(tp, dW, db, sm, 2.0 / N)
            return [(sm[0] / N).reshape(1)] + [t for pair in gr for t in pair]

        out, out2 = run(), run()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, out2)), pl
        if coef_kind == "residual":
            assert _leaf_rel(out, want) <= 1e-4, pl
        else:
            assert _leaf_rel(out, want) <= 8e-4, pl
            if w_plain <= 1e-5:
                assert _leaf_rel(out, witness) <= 2.0 * w_plain + 2e-6, pl


# ---------------------- the deep, wide net (ROADMAP C2) and rows 4/5 bf16 on DES_MMA
C2_NET = (16,) + (128,) * 15 + (1,)
# The bar's multiple of the plain version's own sum-order spread: the largest
# ratio of row 1 bf16's distance from the plain bf16-dot version to that
# spread (both the largest over the leaves) that ``chip_smoke.py mma_depth``
# measured on C2_NET over seeds 23, 24, 25 x sin, tanh on an NVIDIA H100
# 80GB HBM3 at 700 W: 1.115, 0.308, 4.139, 0.238, 1.201, 0.808, rounded up.
C2_SPREAD_MULTIPLE = 4.2


def _permuted_spread(tp, layers, plain, seed):
    """The plain version's spread of two fp32 sum orders: its leaf distance
    (the largest over the leaves) from itself run on the same net with its
    hidden units permuted (the same function and bf16 roundings, every sum in
    another order), the permutation folded back into the gradient leaves
    (``chip_smoke.py``'s ``mma_leaf_rels``)."""
    g = torch.Generator().manual_seed(seed)
    perm = ([torch.arange(layers[0])] + [torch.randperm(w, generator=g) for w in layers[1:-1]]
            + [torch.arange(1)])
    perm = [p.to(tp[0][0].device) for p in perm]
    inv = [torch.argsort(p) for p in perm]
    moved = [(W[perm[k]][:, perm[k + 1]].contiguous(), b[perm[k + 1]].contiguous())
             for k, (W, b) in enumerate(tp)]
    leaves = plain(moved)
    back = [leaves[0]]
    for k in range(len(tp)):
        back += [leaves[1 + 2 * k][inv[k]][:, inv[k + 1]], leaves[2 + 2 * k][inv[k + 1]]]
    return _leaf_rel(back, plain(tp))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["sin", "tanh"])
def test_cuda_mma_deep_wide_net(dev, act):
    """Row 1 bf16 on the deepest, widest net the wrapper takes, (16, 128 x
    15, 1) (18 streams: 8-point tiles), at 1007 points with the
    coefficients a Poisson residual gives.  Every leaf within the bar of the
    plain bf16-dot version: 1e-4 (the bar of test_cuda_mma_plans_match_plain)
    or, where the plain version's own sum-order spread on this net
    (:func:`_permuted_spread`, measured here) is larger, C2_SPREAD_MULTIPLE
    times that spread (the rule of ROADMAP C: no sound implementation with
    another sum order meets a bar below the spread); no further from the
    float64 witness than 2x the plain version + 2e-6; two launches bitwise
    equal."""
    from nnpde_tpu_torch.models import factor_for_technique

    rng = np.random.default_rng(23)
    N, d = 1000 + 7, C2_NET[0]
    tp = params_from_jax(_np_params(rng, C2_NET), device=dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    fj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(X)
    coef = tfs.residual_coefficients(fj, a0=-1.0, rhs=torch.sin(X[:, 0]))

    def plain(params, dtype=torch.float32):
        P = [(W.to(dtype), b.to(dtype)) for W, b in params]
        dWs, dbs, sums = tfs.linear_residual_plain(P, X.to(dtype), coef.to(dtype), act,
                                                   "bfloat16")
        g = tfs._scaled_grads(P, dWs, dbs, sums, 2.0 / N)
        return [(sums[0] / N).reshape(1)] + [t for pair in g for t in pair]

    def run():
        loss, _, g = tfs.fused_linear_residual(tp, X, coef, act, dot_dtype="bfloat16")
        return [loss.reshape(1)] + [t for pair in g for t in pair]

    want, witness = plain(tp), plain(tp, torch.float64)
    bar = max(1e-4, C2_SPREAD_MULTIPLE * _permuted_spread(tp, C2_NET, plain, 23))
    out, out2 = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    assert _leaf_rel(out, want) <= bar
    assert _leaf_rel(out, witness) <= 2.0 * _leaf_rel(want, witness) + 2e-6


@pytest.mark.cuda
def test_cuda_jet_mma_layout_mirror(dev):
    """The jet pair's tensor-core layouts and saved-stage sizes in Python
    are the kernels' own count (fwdlap_backward_mma_*, fwdlap_forward_mma_*)
    for every tile and residency; tiles the design does not take are
    refused."""
    import ctypes

    from nnpde_tpu_torch.kernels import _build, _plan

    lib = _build.load()
    for layers in [(2, 64, 64, 64, 64, 1), (2, 50, 50, 50, 50, 1), (5, 7, 9, 1), (2, 12, 1),
                   (3, 1, 1, 1), C2_NET]:
        lay = (ctypes.c_int * len(layers))(*layers)
        args = (ctypes.addressof(lay), len(layers))
        for T in (8, 16, 32, 48):
            assert lib.fwdlap_backward_mma_scratch_floats(*args, T) == tfs.mma_scratch_floats(
                layers, T, "fwdlap_backward")
            assert lib.fwdlap_forward_mma_scratch_floats(*args, T) == 0
            for flags in (0, _plan.RES_WEIGHTS, _plan.RES_GRAD,
                          _plan.RES_WEIGHTS | _plan.RES_GRAD):
                assert lib.fwdlap_backward_mma_smem_bytes(*args, T, flags) == tfs.mma_smem_bytes(
                    layers, T, flags, "fwdlap_backward")
                assert lib.fwdlap_forward_mma_smem_bytes(*args, T, flags) == tfs.mma_smem_bytes(
                    layers, T, flags, "fwdlap_forward")
        for T in (4, 12, 24):
            assert lib.fwdlap_backward_mma_smem_bytes(*args, T, 0) == -1
            assert lib.fwdlap_forward_mma_smem_bytes(*args, T, 0) == -1


def _jet_mma_pins(kind, layers):
    """Every tensor-core plan of a jet kernel on this net at tiles 8, 16 and
    32: each tier at each blocks per SM (the forward also three) that fits."""
    out = []
    tiers = tfs.MMA_FWD_TIERS if kind == "fwdlap_forward" else tfs.MMA_TIERS
    for T in (8, 16, 32):
        for tier, _ in tiers:
            for blocks in tfs.MMA_SHARES.get(kind, (2, 1)):
                try:
                    pl = tfs.mma_plan(kind, layers, T=T, tier=tier, blocks=blocks)
                except ValueError:
                    continue
                if pl not in out:
                    out.append(pl)
    return out


_JET_NETS = [(2, 64, 64, 64, 64, 1), (3, 50, 50, 1), (2, 50, 1, 50, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("ct_kind", ["residual", "random"])
@pytest.mark.parametrize("layers", _JET_NETS)
def test_cuda_jet_backward_mma_plans_match_plain(dev, layers, ct_kind):
    """Row 5 bf16 at every tile, tier and blocks per SM of the tensor-core
    design, two launches bitwise equal and counted under
    ``fwdlap_backward.bf16``.  With the cotangent a Poisson residual gives:
    every leaf within 1e-4 of the plain bf16-dot version.  With a random
    one: within PREC_TOL_BWD_RANDOM (8e-4, chip_smoke.py), and where the
    plain version is within 1e-5 of the float64 witness, no further from it
    than 2x the plain version + 2e-6."""
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc
    from nnpde_tpu_torch.models import factor_for_technique

    rng = np.random.default_rng(29)
    N, d = 1000 + 7, layers[0]
    tp = params_from_jax(_np_params(rng, layers), device=dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    if ct_kind == "residual":
        fj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(X)
        coef = tfs.residual_coefficients(fj, a0=-1.0, rhs=torch.sin(X[:, 0]))
        jet = tfc.fwdlap_forward_plain(tp, X, "sin")
        r = (coef[:, 0] * jet.value + torch.sum(coef[:, 1:1 + d] * jet.grad, dim=1)
             + coef[:, d + 1] * jet.lap + coef[:, d + 2])
        ct = ((2.0 / N) * r[:, None] * coef[:, :d + 2]).contiguous()
    else:
        ct = torch.as_tensor((rng.standard_normal((N, d + 2)) / N).astype(np.float32),
                             device=dev)

    def plain(dtype):
        P = [(W.to(dtype), b.to(dtype)) for W, b in tp]
        dW, db = tfc.fwdlap_backward_plain(P, X.to(dtype), ct.to(dtype), "sin", "bfloat16")
        return [t for pair in zip(dW, db) for t in pair]

    want, witness = plain(torch.float32), plain(torch.float64)
    w_plain = _leaf_rel(want, witness)
    pins = _jet_mma_pins("fwdlap_backward", layers)
    assert tfs.mma_plan("fwdlap_backward", layers) in pins
    for pl in pins:
        def run():
            dW, db = tfc.fwdlap_backward(tp, X, ct, "sin", "bfloat16", pl=pl)
            return [t for pair in zip(dW, db) for t in pair]

        before = LAUNCHES["fwdlap_backward.bf16"]
        out, out2 = run(), run()
        torch.cuda.synchronize()
        assert LAUNCHES["fwdlap_backward.bf16"] == before + 2
        assert all(torch.equal(a, b) for a, b in zip(out, out2)), pl
        if ct_kind == "residual":
            assert _leaf_rel(out, want) <= 1e-4, pl
        else:
            assert _leaf_rel(out, want) <= 8e-4, pl
            if w_plain <= 1e-5:
                assert _leaf_rel(out, witness) <= 2.0 * w_plain + 2e-6, pl


@pytest.mark.cuda
@pytest.mark.parametrize("layers", _JET_NETS)
def test_cuda_jet_forward_mma_plans_match_plain(dev, layers):
    """Row 4 bf16 at every tile, tier and blocks per SM (two and three
    register budgets) of the tensor-core design: every jet column within
    5e-4 of the plain bf16-dot version (the bar of
    test_cuda_bf16_kernel_matches_plain for a per-point output) and no
    further from the float64 witness than 2x the plain version + 2e-6; two
    launches bitwise equal and counted."""
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    rng = np.random.default_rng(31)
    N, d = 1000 + 7, layers[0]
    tp = params_from_jax(_np_params(rng, layers), device=dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    want = tfc.fwdlap_forward_default_plain(tp, X, "sin").double()
    witness = tfc.fwdlap_forward_default_plain(
        [(W.double(), b.double()) for W, b in tp], X.double(), "sin")

    def col_rel(a, b):
        return max(float(torch.linalg.norm(a[:, c] - b[:, c]) / torch.linalg.norm(b[:, c]))
                   for c in range(d + 2))

    w_plain = col_rel(want, witness)
    pins = _jet_mma_pins("fwdlap_forward", layers)
    assert tfs.mma_plan("fwdlap_forward", layers) in pins
    assert {pl.blocks for pl in pins} == {2, 3}
    for pl in pins:
        before = LAUNCHES["fwdlap_forward.bf16"]
        out = tfc.fwdlap_forward(tp, X, "sin", "rows:default", pl=pl)
        out2 = tfc.fwdlap_forward(tp, X, "sin", "rows:default", pl=pl)
        torch.cuda.synchronize()
        assert LAUNCHES["fwdlap_forward.bf16"] == before + 2
        assert torch.equal(out, out2), pl
        assert col_rel(out.double(), want) <= 5e-4, pl
        assert col_rel(out.double(), witness) <= 2.0 * w_plain + 2e-6, pl


# The hidden widths 129-256 of the fp32 kernels (the 1D oscillator's u200 and
# critic v100, a 256-wide net, a ragged one), at d = 1 and 2: (layers, act).
_WIDE_NETS = [((1, 200, 200, 200, 1), "sin"), ((1, 100, 100, 100, 1), "tanh"),
              ((2, 200, 200, 1), "tanh"), ((1, 256, 256, 1), "tanh"),
              ((1, 130, 130, 1), "sin"), ((1, 130, 256, 1), "tanh")]


@pytest.mark.cuda
@pytest.mark.parametrize("layers,act", _WIDE_NETS)
@pytest.mark.parametrize("kind", ["linear", "analytic", "drm", "backward", "fwdlap_forward",
                                  "fwdlap_forward_streams", "linear_sums", "quad_sums",
                                  "linear_seeded", "quad_seeded"])
def test_cuda_wide_nets_match_float64(dev, kind, layers, act):
    """Rows 1-10 at hidden widths 100-256 (the wrapper's own plan) against
    their float64 plain versions by the bars above, two launches bitwise
    equal; N = 1007 is a multiple of no tile."""
    if kind == "backward":
        _check_backward(dev, layers, act)
    elif kind in _FUSED:
        _check_fused(dev, kind, layers, act)
    elif kind.endswith("seeded"):
        _check_quotient(dev, kind, layers, act, 0)
    else:
        _check_pass_a(dev, kind, layers, act, 1 if kind.startswith("fwdlap") else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [(1, 200, 200, 1), (2, 130, 1), (1, 129, 129, 1)])
def test_cuda_wide_nets_refused_where_the_limit_is_128(dev, layers):
    """The limit of the bf16-dot variants of rows 1-5 (the tensor-core
    design) is 4096 since ROADMAP.md B7 item 4a (256 since their device
    tiers before), and the fp32 K-bump pair's 4096 (B7): these nets above
    128 launch (each launch counted); at a width of 257 they launch too,
    and a kernel whose limit is still 256 would raise, naming the roadmap
    item of the wider nets."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fused_multibump as tfm
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    rng = np.random.default_rng(4)
    d, N = layers[0], 64

    def calls(tp):
        X = torch.rand(N, d, device=dev)
        coef = torch.zeros(N, d + 4, device=dev)
        return [("fused_linear_residual.bf16",
                 lambda: tfs.fused_linear_residual(tp, X, coef, "sin", dot_dtype="bfloat16")),
                ("fwdlap_forward.bf16", lambda: tfc.fwdlap_forward(tp, X, "sin", "rows:default")),
                ("multi_sums", lambda: tfm._launch(False, tp, X,
                                                   torch.zeros(N, 4 * (d + 4), device=dev),
                                                   None, "sin", 4))]

    def launches(name, call):
        before = LAUNCHES[name]
        out = call()
        torch.cuda.synchronize()
        assert LAUNCHES[name] == before + 1
        assert torch.isfinite(out[0] if isinstance(out, tuple) else out).all()

    for name, call in calls(params_from_jax(_np_params(rng, layers), device=dev)):
        launches(name, call)
    wider = (d, 257) + layers[2:]
    for name, call in calls(params_from_jax(_np_params(rng, wider), device=dev)):
        if _cuda.LIMITS[name].width > 256:
            launches(name, call)
        else:
            with pytest.raises(ValueError, match="ROADMAP.md B7"):
                call()


@pytest.mark.cuda
@pytest.mark.parametrize("layers,act", [((1, 50, 50, 50, 1), "tanh"), ((2, 64, 64, 1), "sin"),
                                        ((2, 50, 1, 50, 1), "gelu"), ((1, 256, 1), "tanh")])
@pytest.mark.parametrize("kind", ["linear", "drm", "backward", "fwdlap_forward",
                                  "fwdlap_forward_streams", "linear_sums", "quad_sums",
                                  "linear_seeded", "quad_seeded"])
def test_cuda_device_weights_design_matches_plain(dev, kind, layers, act):
    """The design that reads the weights from device memory (``DES_DEVW``),
    pinned on nets whose weights would fit on chip (ragged ones, and one
    hidden layer, which has no hidden-to-hidden weights): the same bars,
    two launches bitwise equal."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fused_quotient as tfq
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    devw = _cuda.DES_PLANNED | _cuda.DES_DEVW
    if kind == "backward":
        _check_backward(dev, layers, act, pl=tfc.backward_plan(layers, devw))
    elif kind in _FUSED:
        _check_fused(dev, kind, layers, act, pl=tfs.plan(_FUSED[kind], layers, devw))
    elif kind.endswith("seeded"):
        _check_quotient(dev, kind, layers, act, 0, design=_cuda.DES_DEVW)
    else:
        lap = 1 if kind.startswith("fwdlap") else 0
        _check_pass_a(dev, kind, layers, act, lap,
                      pl=_pass_a_plan(kind, layers, lap, design=devw, N=1007))


@pytest.mark.cuda
def test_cuda_device_weights_smem_layout_mirror(dev):
    """With ``DEV_WEIGHTS`` (no weights on chip) the Python layouts of rows
    1-5, 7-10 are the kernels' own counts."""
    import ctypes

    from nnpde_tpu_torch.kernels import _build, _plan
    from nnpde_tpu_torch.kernels import fused_quotient as tfq
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    lib = _build.load()
    flags = (_plan.DEV_WEIGHTS, _plan.DEV_WEIGHTS | _plan.RES_GRAD)
    for layers in [(1, 256, 256, 1), (1, 130, 256, 1), (2, 64, 64, 1), (3, 50, 1, 50, 1)]:
        lay = (ctypes.c_int * len(layers))(*layers)
        ptr, n = ctypes.addressof(lay), len(layers)
        for T in (4, 16, 24):
            for f in flags:
                assert lib.fwdlap_backward_smem_bytes(ptr, n, T, f) == 4 * \
                    tfc.backward_smem_floats(layers, T, f)
                for kind, mode in (("fused_linear_residual", 0), ("fused_drm_energy", 2)):
                    assert lib.fused_smem_bytes(mode, ptr, n, T, f) == 4 * \
                        tfs.smem_floats(kind, layers, T, f)
                for kind, code in (("linear_seeded", 1), ("quad_seeded", 3)):
                    assert lib.fused_quotient_smem_bytes(code, 0, ptr, n, T, f) == 4 * \
                        tfq.smem_floats(kind, layers, T, 0, f)
            f = _plan.DEV_WEIGHTS
            assert lib.fwdlap_forward_smem_bytes(ptr, n, T, f) == 4 * \
                tfc.forward_smem_floats(layers, T, f)
            for kind, code in (("linear_sums", 0), ("quad_sums", 2)):
                assert lib.fused_quotient_smem_bytes(code, 0, ptr, n, T, f) == 4 * \
                    tfq.smem_floats(kind, layers, T, 0, f)


# ----------------------------------------- the trainable-energy eigenproblems
def _elane_inputs(rng, layers, factor, N, device):
    """Row 1's inputs as the trainable-E paths build them: ``r = -1/2 lap u
    + (V - E) u`` with the e column B.  d = 1: x on [-60, 60], the
    cycle-averaged KH potential, the KH window (``'window'``) or B = 1
    (``'raw'``); d = 2: the 2D oscillator's FN window of state (1, 1) on
    [-6, 6]^2."""
    from nnpde_tpu_torch.models import factor_for_technique
    from nnpde_tpu_torch.ops.fwdlap import Jet
    from nnpde_tpu_torch.pde import kh, qho

    d = layers[0]
    if d == 1:
        X = torch.as_tensor(np.sort(rng.uniform(-60.0, 60.0, (N, 1)), axis=0).astype(np.float32),
                            device=device)
        V, E = kh.v_kh_avg(X[:, 0], alpha0=10.0), -0.0112
        fac = (None if factor == "raw"
               else factor_for_technique("FBC", dim=1, kind="window", L=60.0))
    else:
        X = torch.as_tensor(rng.uniform(-6.0, 6.0, (N, 2)).astype(np.float32), device=device)
        V, E = qho.potential_2d(X[:, 0], X[:, 1]), qho.energy_2d(1, 1) + 0.05
        fac = factor_for_technique("FN", dim=2, kind="window", L=6.0,
                                   nodes_per_dim=[qho.nodes(1), qho.nodes(1)])
    if fac is None:
        one = torch.ones((N,), device=device)
        fj = Jet(one, torch.zeros_like(X), torch.zeros_like(one))
    else:
        fj = fac.jet(X)
    return X, tfs.residual_coefficients(fj, a0=-0.5, c0=V - E, e_lane=True).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("layers,factor", [((1, 100, 100, 100, 1), "window"),
                                           ((1, 100, 100, 100, 1), "raw"),
                                           ((1, 64, 64, 64, 1), "window"),
                                           ((2, 50, 50, 50, 50, 1), "qho2d")])
def test_cuda_elane_residual_matches_float64(dev, layers, factor):
    """Row 1 with a non-zero e lane (the KH nets and the 2D oscillator's
    u50) against its float64 plain version: loss and grad tree rel <= 1e-5,
    ``sum_r_ufull`` within 1e-5 of the sum of its terms' magnitudes, two
    launches bitwise equal, the e-lane sum included."""
    from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap

    rng = np.random.default_rng(61)
    N = 1031 if layers[0] == 1 else 4007
    params = params_from_jax(_np_params(rng, layers), device=dev)
    X, coef = _elane_inputs(rng, layers, factor, N, dev)
    (l1, a1, g1), (l2, a2, g2) = (tfs.fused_linear_residual(params, X, coef, "sin")
                                  for _ in range(2))
    assert torch.equal(l1, l2) and torch.equal(a1["sum_r_ufull"], a2["sum_r_ufull"])
    assert all(torch.equal(x, y) for pa, pb in zip(g1, g2) for x, y in zip(pa, pb))
    p64 = [(W.double(), b.double()) for W, b in params]
    X64, c64 = X.double(), coef.double()
    dWs, dbs, sums = tfs.linear_residual_plain(p64, X64, c64, "sin")
    assert abs(float(l1) - float(sums[0]) / N) <= 1e-5 * abs(float(sums[0]) / N)
    assert _tree_rel(g1, tfs._scaled_grads(p64, dWs, dbs, sums, 2.0 / N)) <= 1e-5
    d = layers[0]
    jet = mlp_fwdlap(p64, X64, "sin")
    r = (c64[:, 0] * jet.value + torch.sum(c64[:, 1:1 + d] * jet.grad, dim=1)
         + c64[:, d + 1] * jet.lap + c64[:, d + 2])
    terms = float(torch.sum(torch.abs(r * c64[:, d + 3] * jet.value)))
    assert terms > 0.0
    assert abs(float(a1["sum_r_ufull"]) - float(sums[2])) <= 1e-5 * terms


@pytest.mark.cuda
def test_cuda_ratio_sq_neg_pair_on_raw_critic(dev):
    """KH's fused WAN pair (``convention='ratio_sq'``, ``eps=1e-12/(2L)``,
    ``objective='neg'``; a raw primal and a critic with no trial factor) on
    the card against the same objectives on the plain route in float64
    (CPU): values, parameter gradients and dE, each within the larger of
    1e-5 and twice the plain route's own float32 error."""
    from nnpde_tpu_torch.models import NetSpec, SolutionModel
    from nnpde_tpu_torch.ops import bump_w
    from nnpde_tpu_torch.pde import kh
    from nnpde_tpu_torch.problems._fused_wan import make_fused_wan_pair

    Lk, N = 60.0, 1031
    u_model = SolutionModel(NetSpec((1, 100, 100, 100, 1), activation="sin"))
    v_model = SolutionModel(NetSpec((1, 50, 50, 50, 1), activation="sin"))
    pair = make_fused_wan_pair(u_model, v_model, w_pde=10.0, convention="ratio_sq",
                               eps=1e-12 / (2.0 * Lk), objective="neg")
    rng = np.random.default_rng(62)
    up, vp = _np_params(rng, (1, 100, 100, 100, 1)), _np_params(rng, (1, 50, 50, 50, 1))
    x = np.linspace(-Lk, Lk, N, dtype=np.float32)[:, None]
    got = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        X = torch.as_tensor(x, device=device, dtype=dtype)
        V = kh.v_kh_avg(X[:, 0], alpha0=10.0)
        wv, dwv = bump_w(X, -Lk, Lk)
        u = [(W.requires_grad_(True), b.requires_grad_(True))
             for W, b in params_from_jax(up, device=device, dtype=dtype)]
        v = [(W.requires_grad_(True), b.requires_grad_(True))
             for W, b in params_from_jax(vp, device=device, dtype=dtype)]
        E = torch.tensor(-0.0112, device=device, dtype=dtype, requires_grad=True)
        total, _ = pair.u_pde_fn(u, E, [(W.detach(), b.detach()) for W, b in v], X, wv, dwv,
                                 V=V)
        gu = torch.autograd.grad(total, [t for pr in u for t in pr] + [E])
        coef = pair.v_coef_fn([(W.detach(), b.detach()) for W, b in u], E.detach(), X, wv,
                              dwv, V=V)
        lv, _ = pair.v_loss_from_coef(v, X, coef)
        gv = torch.autograd.grad(lv, [t for pr in v for t in pr])
        got.append([float(total), torch.cat([g.reshape(-1).double().cpu() for g in gu[:-1]]),
                    float(gu[-1]), float(lv),
                    torch.cat([g.reshape(-1).double().cpu() for g in gv])])
    ref = got[2]

    def errs(side):
        return [abs(side[0] - ref[0]) / abs(ref[0]),
                float(torch.linalg.norm(side[1] - ref[1]) / torch.linalg.norm(ref[1])),
                abs(side[2] - ref[2]) / abs(ref[2]),
                abs(side[3] - ref[3]) / abs(ref[3]),
                float(torch.linalg.norm(side[4] - ref[4]) / torch.linalg.norm(ref[4]))]

    for kern, plain32 in zip(errs(got[0]), errs(got[1])):
        assert kern <= max(1e-5, 2.0 * plain32), (kern, plain32)


@pytest.mark.cuda
def test_cuda_interp_and_ground_truth_match_cpu(dev):
    """The device interpolation (``pde/kh.py::interp``) on the card against
    the CPU, at, between and beyond the nodes, and the KH ground truth's
    ``resample`` on the card against the CPU's."""
    from nnpde_tpu_torch.pde import kh

    rng = np.random.default_rng(63)
    xp = np.sort(rng.uniform(-5.0, 5.0, 40))
    fp = rng.normal(size=40)
    x = np.concatenate([xp, (xp[1:] + xp[:-1]) / 2, [-9.0, 9.0], rng.uniform(-6.0, 6.0, 50)])
    for dtype in (torch.float64, torch.float32):
        args = [torch.as_tensor(a, dtype=dtype) for a in (x, xp, fp)]
        want = kh.interp(*args)
        got = kh.interp(*[a.to(dev) for a in args]).cpu()
        torch.testing.assert_close(got, want, rtol=1e-6 if dtype == torch.float32 else 1e-12,
                                   atol=0.0)
    kw = dict(alpha=10.0, L=60.0, N=600, n_levels=3, n_theta=64)
    g_dev, g_cpu = kh.KHGroundTruth(**kw, device=dev), kh.KHGroundTruth(**kw, device="cpu")
    xs = torch.linspace(-61.0, 61.0, 257)
    for a, b in zip(g_dev.resample(xs.to(dev)), g_cpu.resample(xs)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("act,d,C,factor", [("sin", 1, 6, True), ("tanh", 2, 5, False),
                                            ("sin", 1, 10, True), ("sin", 2, 3, True)])
def test_cuda_channel_jet_matches_float64(dev, act, d, C, factor):
    """The channel jet (``ChannelSolutionModel.fields``, the recurrence on
    the card, no kernel) in float32 against the float64 plain version on
    the CPU: value and gradient norm-relative within 1e-5, the Laplacian
    within 1e-4; the model's forward equal to the jet's value."""
    from nnpde_tpu_torch.kernels import LAUNCHES
    from nnpde_tpu_torch.models import ChannelSolutionModel, NetSpec, factor_for_technique
    from nnpde_tpu_torch.runtime import pin_fp32_precision

    pin_fp32_precision()
    rng = np.random.default_rng(71 + d + C)
    layers = (d, 64, 64, 64, C)
    pn = _np_params(rng, layers)
    X = rng.uniform(-2.5, 2.5, (1000 + 7, d))
    model = ChannelSolutionModel(
        NetSpec(layers, act),
        factor_for_technique("FBC", dim=d, kind="window", L=3.0) if factor else None)
    before = dict(LAUNCHES)
    got = model.fields(params_from_jax(pn, device=dev), torch.as_tensor(X, dtype=torch.float32,
                                                                       device=dev))
    want = model.fields(params_from_jax(pn, dtype=torch.float64), torch.as_tensor(X))
    assert dict(LAUNCHES) == before
    for name, g, w, bar in zip(got._fields, got, want, (1e-5, 1e-5, 1e-4)):
        assert g.device.type == "cuda" and g.shape == w.shape, name
        rel = float(torch.linalg.norm(g.double().cpu() - w) / torch.linalg.norm(w))
        assert rel <= bar, (name, rel)
    u = model.apply_batch(params_from_jax(pn, device=dev),
                          torch.as_tensor(X, dtype=torch.float32, device=dev))
    torch.testing.assert_close(u, got.value, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_subspace_trace_nan_on_failed_cholesky_without_sync(dev):
    """``subspace_trace`` on the card: NaN on a Gram that is not positive
    definite (as ``jnp.linalg.cholesky``; ``cholesky_ex``'s own factor is
    finite), the value and gradient of a positive-definite one equal to
    the CPU's, and its forward and backward raise nothing under
    ``torch.cuda.set_sync_debug_mode("error")``: the failure check costs
    no host sync."""
    from nnpde_tpu_torch.problems.subspace import subspace_matrices, subspace_trace

    rng = np.random.default_rng(5)
    value = torch.as_tensor(rng.normal(size=(500, 4)), dtype=torch.float32, device=dev)
    grad = torch.as_tensor(rng.normal(size=(500, 1, 4)), dtype=torch.float32, device=dev)
    V = torch.as_tensor(rng.uniform(0.0, 2.0, 500), dtype=torch.float32, device=dev)
    G_bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], device=dev)
    A_bad = torch.eye(2, device=dev)
    value.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bad = subspace_trace(A_bad, G_bad)
        tr = subspace_trace(*subspace_matrices(value, grad, V))
        (g,) = torch.autograd.grad(tr, value)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isnan(bad).item()
    v_cpu = value.detach().cpu().double().requires_grad_(True)
    tr_cpu = subspace_trace(*subspace_matrices(v_cpu, grad.cpu().double(), V.cpu().double()))
    (g_cpu,) = torch.autograd.grad(tr_cpu, v_cpu)
    assert abs(float(tr) - float(tr_cpu)) <= 1e-5 * abs(float(tr_cpu))
    assert float(torch.linalg.norm(g.double().cpu() - g_cpu) / torch.linalg.norm(g_cpu)) <= 1e-4


# ------------- widths 129-256: rows 1, 2, 4, 5 bf16 (device tiers) and rows 11, 12
_WIDE_NETS = [(2, 136, 136, 136, 136, 1), (2, 200, 200, 200, 200, 1), (2, 256, 256, 256, 1),
              (5, 200, 200, 200, 1)]


def _bf16_case(dev, kind, layers, act, seed, N):
    """A bf16-dot row's launch on a plan (``run(pl)``, None: the wrapper's),
    and its plain bf16-dot version (``plain(params)``), on the inputs
    test_cuda_bf16_kernel_matches_plain gives; both lists of tensors."""
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc
    from nnpde_tpu_torch.models import factor_for_technique

    rng = np.random.default_rng(seed)
    d = layers[0]
    tp = params_from_jax(_np_params(rng, layers), device=dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    fj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(X)
    coef = tfs.residual_coefficients(fj, a0=-1.0, rhs=torch.sin(X[:, 0]))
    ks = (1,) * d
    jet = tfc.fwdlap_forward_plain(tp, X, act)
    r = (coef[:, 0] * jet.value + torch.sum(coef[:, 1:1 + d] * jet.grad, dim=1)
         + coef[:, d + 1] * jet.lap + coef[:, d + 2])
    ct = ((2.0 / N) * r[:, None] * coef[:, :d + 2]).contiguous()

    def run(pl=None):
        if kind == "forward":
            return [tfc.fwdlap_forward(tp, X, act, "rows:default", pl=pl)]
        if kind == "backward":
            dW, db = tfc.fwdlap_backward(tp, X, ct, act, "bfloat16", pl=pl)
            return [t for pair in zip(dW, db) for t in pair]
        base = "fused_linear_residual" if kind == "linear" else "fused_poisson_analytic"
        an = tfs._analytic_args(tfs.PoissonSinCoef(L, ks), d)
        out = tfs._launch(base, tp, X, coef if kind == "linear" else None, act, an,
                          bf16=True, pl=pl)
        dW, db, sm = tfs._unflatten(tp, out)
        g = tfs._scaled_grads(tp, dW, db, sm, 2.0 / N)
        return [(sm[0] / N).reshape(1)] + [t for pair in g for t in pair]

    def plain(params):
        if kind == "forward":
            return [tfc.fwdlap_forward_default_plain(params, X, act)]
        if kind == "backward":
            rW, rb = tfc.fwdlap_backward_plain(params, X, ct, act, "bfloat16")
            return [t for pair in zip(rW, rb) for t in pair]
        if kind == "linear":
            dWs, dbs, sums = tfs.linear_residual_plain(params, X, coef, act, "bfloat16")
        else:
            dWs, dbs, sums = tfs.poisson_analytic_plain(params, X, act,
                                                        tfs.PoissonSinCoef(L, ks), "bfloat16")
        g = tfs._scaled_grads(params, dWs, dbs, sums, 2.0 / N)
        return [(sums[0] / N).reshape(1)] + [t for pair in g for t in pair]

    return tp, run, plain


def _col_rel(a, b):
    return max(float(torch.linalg.norm(a[:, c].double() - b[:, c].double())
                     / torch.linalg.norm(b[:, c].double())) for c in range(b.shape[1]))


def _wide_spread(kind, tp, layers, plain, seed=23):
    """C2's spread for any bf16-dot row (:func:`_permuted_spread`): the
    plain version against itself on the net with its hidden units
    permuted, the gradient leaves folded back (the jet rows do not move)."""
    g = torch.Generator().manual_seed(seed)
    perm = ([torch.arange(layers[0])] + [torch.randperm(w, generator=g) for w in layers[1:-1]]
            + [torch.arange(1)])
    perm = [p.to(tp[0][0].device) for p in perm]
    inv = [torch.argsort(p) for p in perm]
    moved = [(W[perm[k]][:, perm[k + 1]].contiguous(), b[perm[k + 1]].contiguous())
             for k, (W, b) in enumerate(tp)]
    got, want = plain(moved), plain(tp)
    if kind == "forward":
        return _col_rel(got[0], want[0])
    lo = 0 if kind == "backward" else 1
    back = got[:lo]
    for k in range(len(tp)):
        back += [got[lo + 2 * k][inv[k]][:, inv[k + 1]], got[lo + 2 * k + 1][inv[k + 1]]]
    return _leaf_rel(back, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "analytic", "forward", "backward"])
@pytest.mark.parametrize("layers", _WIDE_NETS)
def test_cuda_wide_bf16_rows_match_plain(dev, kind, layers):
    """Rows 1, 2, 4, 5 bf16 at hidden widths 136, 200 and 256 (the device
    tiers where the weights do not fit beside the stages): within C2's bar,
    max(1e-4, C2_SPREAD_MULTIPLE x the plain version's own permutation
    spread), of the plain bf16-dot version (the jet forward per column);
    two launches bitwise equal; every other tier that fits the plan's tile
    bitwise equal to the plan's (the device tiers build the same bf16
    operands and sum in the same order)."""
    act = "sin"
    tp, run, plain = _bf16_case(dev, kind, layers, act, 31, 1000 + 7)
    base = {"linear": "fused_linear_residual", "analytic": "fused_poisson_analytic",
            "forward": "fwdlap_forward", "backward": "fwdlap_backward"}[kind]
    pl = tfs.mma_plan(base, list(layers))
    out, out2 = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    want = plain(tp)
    bar = max(1e-4, C2_SPREAD_MULTIPLE * _wide_spread(kind, tp, layers, plain))
    if kind == "forward":
        assert _col_rel(out[0], want[0]) <= bar
    else:
        assert _leaf_rel(out, want) <= bar
    tiers = tfs.MMA_FWD_TIERS if kind == "forward" else tfs.MMA_TIERS
    for tier, _ in tiers:
        if tier == pl.tier:
            continue
        try:
            other = tfs.mma_plan(base, list(layers), T=pl.T, tier=tier, blocks=1)
        except ValueError:
            continue
        if kind == "forward":
            other = other._replace(blocks=pl.blocks)
        assert all(torch.equal(a, b) for a, b in zip(run(other), out)), tier


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "backward"])
def test_cuda_mma_widest_deepest_net(dev, kind):
    """Row 1 and row 5 bf16 on (16, 256 x 15, 1): the device-sums tier (the
    weights and the sums in device memory beside three stages of 18 streams
    at 8 points) within C2's bar of the plain version, repeats bitwise."""
    layers = (16,) + (256,) * 15 + (1,)
    base = "fused_linear_residual" if kind == "linear" else "fwdlap_backward"
    assert tfs.mma_plan(base, list(layers)).tier == "device-sums"
    tp, run, plain = _bf16_case(dev, kind, layers, "tanh", 32, 300 + 7)
    out, out2 = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    bar = max(1e-4, C2_SPREAD_MULTIPLE * _wide_spread(kind, tp, layers, plain))
    assert _leaf_rel(out, plain(tp)) <= bar


@pytest.mark.cuda
def test_cuda_wide_mma_layout_mirror(dev):
    """The device tiers' layouts in Python are the kernels' own count, for
    the three kinds with a C count, at the wide nets."""
    import ctypes

    from nnpde_tpu_torch.kernels import _build, _plan

    lib = _build.load()
    flags_all = (0, _plan.RES_WEIGHTS, _plan.DEV_WEIGHTS, _plan.DEV_WEIGHTS | _plan.DEV_SUMS)
    for layers in _WIDE_NETS + [(16,) + (256,) * 15 + (1,)]:
        lay = (ctypes.c_int * len(layers))(*layers)
        args = (ctypes.addressof(lay), len(layers))
        for T in (8, 16):
            for flags in flags_all:
                for mode in (0, 1):
                    assert lib.fused_mma_smem_bytes(mode, *args, T, flags) == tfs.mma_smem_bytes(
                        layers, T, flags)
                assert lib.fwdlap_backward_mma_smem_bytes(*args, T, flags) == tfs.mma_smem_bytes(
                    layers, T, flags, "fwdlap_backward")
                assert lib.fwdlap_forward_mma_smem_bytes(*args, T, flags) == tfs.mma_smem_bytes(
                    layers, T, flags, "fwdlap_forward")


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("layers,Kb,act", [
    ((2, 200, 200, 200, 200, 1), 16, "sin"),       # tiers on chip
    ((2, 256, 256, 256, 256, 1), 16, "sin"),       # DEV_WEIGHTS
    ((2, 136, 256, 1), 4, "tanh"),
    ((16, 256, 256, 1), 42, "gelu"),
])
def test_cuda_multibump_wide_nets(dev, seeded, layers, Kb, act):
    """The K-bump pair at hidden widths 136-256: the bars of
    test_cuda_multibump_kernel_matches_plain, repeats bitwise; at width 256
    the tier that reads the weights from device memory."""
    from nnpde_tpu_torch.kernels import _plan
    from nnpde_tpu_torch.kernels import fused_multibump as tfm

    pl = tfm.plan(seeded, layers, Kb)
    # one 256-wide staging matrix (256 KB) fits no block
    assert bool(pl.flags & _plan.DEV_WEIGHTS) == (max(layers[1:-1]) == 256)
    _check_multibump(dev, seeded, Kb, layers, act, N=600 + 7)



# ------------------------------- rows 3 and 7-10 bf16 on the tensor-core body
# (kind, lap): the Deep-Ritz energy and the quadratic quotients without the
# Laplacian stream, the linear quotients with it and without (no_lap)
_NEW_BF16 = [("drm", 0), ("linear_sums", 1), ("linear_sums", 0), ("linear_seeded", 1),
             ("linear_seeded", 0), ("quad_sums", 0), ("quad_seeded", 0)]
_NEW_BF16_NETS = [
    ((2, 64, 64, 64, 64, 1), "sin"),       # u64: the Poisson DRM and WAN primal
    ((2, 64, 64, 1), "sin"),               # c64: the Poisson WAN critic
    ((2, 50, 50, 50, 50, 1), "sin"),       # u50: the 2D well's Rayleigh DRM
    ((1, 200, 200, 200, 1), "tanh"),       # the oscillator's width: the wide variant
    ((5, 64, 64, 64, 64, 1), "gelu"),      # S = 6 or 7
    ((4, 32, 32, 1), "sin"),               # S = 5 at d = 4: the zero stream at T = 8
    ((2, 50, 1, 50, 1), "tanh"),           # width 1 between widths 50
    ((16, 32, 32, 1), "sin"),              # d = 16: 17 or 18 streams
]


def _new_bf16_case(dev, kind, lap, layers, act, N=1000 + 7, seed=19):
    """A launch of row 3 or one of rows 7-10 through its public wrapper
    (``run(dot)``, a list of tensors: the loss or the sums, then the
    gradient leaves), its plain version on the card (``plain(dot,
    dtype)``) and a measure ``rel(a, b)`` of the distance between two
    results: the largest norm-relative difference of the loss and the
    leaves, and for pass A the largest difference of a sum over the sum of
    its terms' magnitudes (float64), the rule of the fp32 sums (a sum whose
    terms cancel amplifies a relative bar).  Inputs of a Poisson-like
    problem: the box-FBC factor, a source, a potential and a mass lane."""
    from nnpde_tpu_torch.kernels import fused_quotient as tfq
    from nnpde_tpu_torch.models import factor_for_technique

    rng = np.random.default_rng(seed)
    d = layers[0]
    pn = _np_params(rng, layers)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    fj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(X)
    f = torch.sin(X[:, 0]) + 0.5
    V = 0.5 * torch.sum(X * X, dim=1)
    if kind == "drm":
        coef = tfs.drm_coefficients(fj, f)
    elif kind.startswith("quad"):
        coef = tfq.quotient_coefficients(fj, f=f, V=V)
    else:
        coef = tfq.linear_functional_coefficients(
            fj, c0=V, b0=0.5 * torch.cos(X), a0=-1.0 if lap else 0.0, rhs=-f, e1=fj.value,
            e2=fj.value * f)
    scal = torch.tensor([0.7, -0.3, 0.2] if kind == "linear_seeded" else [0.7, -0.3],
                        device=dev)

    def call(params, Xa, c, s, dot):
        if kind == "drm":
            loss, _, g = tfs.fused_drm_energy(params, Xa, c, act, dot_dtype=dot)
            return [loss.reshape(1)] + [t for pair in g for t in pair]
        if kind == "linear_sums":
            o = tfq.fused_linear_sums(params, Xa, c, act, no_lap=not lap, dot_dtype=dot)
            return [o[k].reshape(1) for k in ("sum_r", "sum_r2", "sum_mass", "sum_e2")]
        if kind == "quad_sums":
            o = tfq.fused_quad_sums(params, Xa, c, act, dot_dtype=dot)
            return [o[k].reshape(1) for k in ("sum_e", "sum_u2")]
        if kind == "linear_seeded":
            g = tfq.fused_seeded_grads(params, Xa, c, s, act, no_lap=not lap, dot_dtype=dot)
        else:
            g = tfq.fused_quad_seeded_grads(params, Xa, c, s, act, dot_dtype=dot)
        return [t for pair in g for t in pair]

    tp = params_from_jax(pn, device=dev)

    def run(dot):
        return call(tp, X, coef, scal, dot)

    def rel(a, b):
        if not kind.endswith("_sums"):
            return _leaf_rel(a, b)
        from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap

        P = params_from_jax(pn, device=dev, dtype=torch.float64)
        c = coef.double()
        jet = mlp_fwdlap(P, X.double(), act)
        v = jet.value
        if kind == "linear_sums":
            r = c[:, 0] * v + torch.sum(c[:, 1:1 + d] * jet.grad, dim=1) + c[:, d + 2]
            if lap:
                r = r + c[:, d + 1] * jet.lap
            scale = [r.abs().sum(), (r * r).sum(), ((c[:, d + 3] * v) ** 2).sum(),
                     (c[:, d + 4] * v).abs().sum()]
        else:
            u = c[:, 0] * v
            G = c[:, 0:1] * jet.grad + c[:, 1:1 + d] * v[:, None]
            e = 0.5 * torch.sum(G * G, dim=1) - c[:, d + 1] * u + c[:, d + 2] * u * u
            scale = [e.abs().sum(), (u * u).sum()]
        return max(float(torch.abs(x.double() - y.double()).max() / m)
                   for x, y, m in zip(a, b, scale))

    def plain(dot, dtype=torch.float32):
        P = params_from_jax(pn, device=dev, dtype=dtype)
        Xc, cc, sc = X.to(dtype), coef.to(dtype), scal.to(dtype)
        if kind == "drm":
            dWs, dbs, sums = tfs.drm_energy_plain(P, Xc, cc, act, dot)
            g = tfs._scaled_grads(P, dWs, dbs, sums, 1.0 / N)
            return [(sums[0] / N).reshape(1)] + [t for pair in g for t in pair]
        if kind == "linear_sums":
            return list(tfq.linear_sums_plain(P, Xc, cc, act, not lap, dot).reshape(-1, 1))
        if kind == "quad_sums":
            return list(tfq.quad_sums_plain(P, Xc, cc, act, dot).reshape(-1, 1))
        if kind == "linear_seeded":
            dWs, dbs, sums = tfq.linear_seeded_plain(P, Xc, cc, sc, act, not lap, dot)
        else:
            dWs, dbs, sums = tfq.quad_seeded_plain(P, Xc, cc, sc, act, dot)
        g = tfq._seeded_grads(P, dWs, dbs, sums)
        return [t for pair in g for t in pair]

    return run, plain, rel


@pytest.mark.cuda
@pytest.mark.parametrize("layers,act", _NEW_BF16_NETS)
@pytest.mark.parametrize("kind,lap", _NEW_BF16)
def test_cuda_bf16_row3_and_quotients_match_plain(dev, kind, lap, layers, act):
    """The bf16-dot variants of rows 3 and 7-10 against their plain
    bf16-dot versions, float32 on the card: the loss and every gradient leaf
    norm-rel <= 1e-4, every pass-A sum within 1e-5 of the sum of its terms'
    magnitudes; more than 10x that bar from the fp32 kernel (the cast is
    delivered); two launches bitwise equal, each counted under
    ``<kernel>.bf16`` and launched in the tensor-core design."""
    from nnpde_tpu_torch.kernels import _cuda

    name = ("fused_drm_energy" if kind == "drm" else kind) + ".bf16"
    run, plain, rel = _new_bf16_case(dev, kind, lap, layers, act)
    bar = 1e-5 if kind.endswith("_sums") else 1e-4
    before = LAUNCHES[name]
    with _cuda.capture() as cap:
        out = run("bfloat16")
    out2 = run("bfloat16")
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 2
    assert [c[0] for c in cap.calls] == [name]
    # the design argument: DES_MMA, with DES_WIDE above width 128
    des = cap.calls[0][2][12 if kind == "drm" else 13]
    assert des & ~_cuda.DES_WIDE == _cuda.DES_MMA
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    assert rel(out, plain("bfloat16")) <= bar
    assert rel(out, run("float32")) > 10 * bar


@pytest.mark.cuda
@pytest.mark.parametrize("kind,lap", _NEW_BF16)
def test_cuda_bf16x3_runs_the_float32_kernels(dev, kind, lap):
    """``dot_dtype='bf16x3'`` launches the float32 kernel (counted under its
    plain name) and is bitwise the ``'float32'`` result."""
    name = "fused_drm_energy" if kind == "drm" else kind
    run, _, _ = _new_bf16_case(dev, kind, lap, (2, 64, 64, 64, 64, 1), "sin")
    before = (LAUNCHES[name], LAUNCHES[name + ".bf16"])
    x3, f32 = run("bf16x3"), run("float32")
    torch.cuda.synchronize()
    assert (LAUNCHES[name], LAUNCHES[name + ".bf16"]) == (before[0] + 2, before[1])
    assert all(torch.equal(a, b) for a, b in zip(x3, f32))


@pytest.mark.cuda
def test_cuda_bf16x3_every_other_kernel_is_float32(dev):
    """``'bf16x3'`` on rows 1, 2, the jet pair and rows 11-12 is bitwise
    their ``'float32'``."""
    from nnpde_tpu_torch.kernels import fused_multibump as tfm
    from nnpde_tpu_torch.kernels import mlp_fwdlap_kernel

    rng = np.random.default_rng(3)
    layers, N = (2, 64, 64, 64, 64, 1), 1000 + 7
    tp = params_from_jax(_np_params(rng, layers), device=dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, 2)).astype(np.float32), device=dev)
    coef = torch.as_tensor(rng.normal(size=(N, 6)).astype(np.float32), device=dev)
    mcoef = torch.as_tensor(rng.normal(size=(N, 3 * 6)).astype(np.float32), device=dev)
    scal = tuple(torch.as_tensor(rng.normal(size=3).astype(np.float32), device=dev)
                 for _ in range(3))

    def jet_grads(dot, fwd_impl):
        leaves = [(W.clone().requires_grad_(True), b.clone().requires_grad_(True))
                  for W, b in tp]
        jet = mlp_fwdlap_kernel(leaves, X, "sin", fwd_impl=fwd_impl, dot_dtype=dot)
        val = jet.value.mean() + (jet.lap ** 2).mean()
        return [val.detach()] + list(torch.autograd.grad(val, [t for p in leaves for t in p]))

    calls = [
        lambda dot: tfs.fused_linear_residual(tp, X, coef, "sin", dot_dtype=dot)[2],
        lambda dot: tfs.fused_poisson_analytic(tp, X, "sin", L=L, ks=(1, 1), dot_dtype=dot)[2],
        lambda dot: jet_grads(dot, "rows"),
        lambda dot: jet_grads(dot, "streams"),
        lambda dot: [tfm.fused_multi_sums(tp, X, mcoef, "sin", 3, dot_dtype=dot)["sum_r"]],
        lambda dot: tfm.fused_multi_seeded_grads(tp, X, mcoef, scal, "sin", 3, dot_dtype=dot),
    ]
    for call in calls:
        flat = lambda o: [t for x in o for t in (x if isinstance(x, tuple) else (x,))]
        assert all(torch.equal(a, b) for a, b in zip(flat(call("bf16x3")),
                                                     flat(call("float32"))))


@pytest.mark.cuda
def test_cuda_quotient_mma_layout_mirror(dev):
    """Rows 7-10's tensor-core layouts and scratch in Python are the
    kernels' own count, with and without the Laplacian stream, for every
    tile and tier; a quadratic kind with the Laplacian is refused."""
    import ctypes

    from nnpde_tpu_torch.kernels import _build, _plan
    from nnpde_tpu_torch.kernels import fused_quotient as tfq

    lib = _build.load()
    flags_all = (0, _plan.RES_WEIGHTS, _plan.RES_GRAD, _plan.RES_WEIGHTS | _plan.RES_GRAD,
                 _plan.DEV_WEIGHTS, _plan.DEV_WEIGHTS | _plan.DEV_SUMS)
    for layers in [(2, 64, 64, 64, 64, 1), (2, 64, 64, 1), (2, 50, 50, 50, 50, 1), (5, 7, 9, 1),
                   (2, 12, 1), (1, 200, 200, 200, 1), (16,) + (256,) * 15 + (1,)]:
        lay = (ctypes.c_int * len(layers))(*layers)
        args = (ctypes.addressof(lay), len(layers))
        for kind, code in tfq._KINDS.items():
            for lap in ((0, 1) if kind.startswith("linear") else (0,)):
                for T in (8, 16, 32):
                    for flags in flags_all:
                        assert lib.fused_quotient_mma_smem_bytes(
                            code, lap, *args, T, flags) == tfs.mma_smem_bytes(
                                layers, T, flags, kind, lap)
                        assert lib.fused_quotient_mma_scratch_floats(
                            code, lap, *args, T, flags) == tfs.mma_scratch_floats(
                                layers, T, kind, flags, lap)
        assert lib.fused_quotient_mma_smem_bytes(2, 1, *args, 16, 0) == -1
        assert lib.fused_quotient_mma_smem_bytes(0, 0, *args, 24, 0) == -1


# ------------------------------- rows 11-12 (the K-bump pair) in bf16-dot mode
_MB_BF16_NETS = [
    ((2, 20, 20, 20, 1), "sin"),           # c20: the 2D well's critic
    ((2, 50, 50, 50, 50, 1), "sin"),       # u50: the 2D well's primal
    ((2, 200, 200, 200, 1), "sin"),        # the width-200 critic: the wide variant
    ((1, 200, 200, 200, 1), "tanh"),       # u200 of the 1D oscillator: the wide variant, d = 1
    ((16, 32, 32, 1), "sin"),              # d = 16: 17 streams, 18 at T = 8
]


def _mb_bf16_case(dev, seeded, layers, act, Kb, N=4000 + 7, seed=23):
    """A launch of row 11 or 12 through its public wrapper (``run(dot)``, a
    list of tensors: pass A's 3K sums, or pass B's gradient leaves with sum
    ct_v last), its plain version on the card (``plain(dot, dtype)``; in
    float64 the witness) and the distance ``rel(a, b)``: pass B's largest
    norm-relative leaf difference, pass A's largest sum difference over the
    float64 sum of its terms' magnitudes (the weak sums cancel)."""
    from nnpde_tpu_torch.kernels import fused_multibump as tfm
    from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap

    rng = np.random.default_rng(seed)
    d = layers[0]
    pn = _np_params(rng, layers)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    coef, scal = tfm.weak_form_stream(X, Kb, rng, L)
    seeds = (scal[:Kb], scal[Kb:2 * Kb], scal[2 * Kb:])
    tp = params_from_jax(pn, device=dev)

    def run(dot):
        if not seeded:
            s = tfm.fused_multi_sums(tp, X, coef, act, Kb, dot_dtype=dot)
            return list(torch.cat([s["sum_r"], s["sum_mass"], s["sum_e2"]]).reshape(-1, 1))
        g = tfm.fused_multi_seeded_grads(tp, X, coef, seeds, act, Kb, dot_dtype=dot)
        return [t for pair in g for t in pair]

    def plain(dot, dtype=torch.float32):
        from nnpde_tpu_torch.kernels import fused_quotient as tfq

        P = params_from_jax(pn, device=dev, dtype=dtype)
        Xc, cc, sc = X.to(dtype), coef.to(dtype), scal.to(dtype)
        if not seeded:
            return list(tfm.fused_multi_sums_plain(P, Xc, cc, act, Kb, dot).reshape(-1, 1))
        dWs, dbs, sums = tfm.fused_multi_seeded_grads_plain(P, Xc, cc, sc, act, Kb, dot)
        return [t for pair in tfq._seeded_grads(P, dWs, dbs, sums) for t in pair]

    def rel(a, b):
        if seeded:
            return _leaf_rel(a, b)
        P = params_from_jax(pn, device=dev, dtype=torch.float64)
        r, mass, lin = tfm._multi_terms(mlp_fwdlap(P, X.double(), act), coef.double(), Kb, d)
        scale = torch.cat([r.abs().sum(0), mass.sum(0), lin.abs().sum(0)])
        return max(float(torch.abs(x.double() - y.double()).max() / m)
                   for x, y, m in zip(a, b, scale))

    return run, plain, rel


@pytest.mark.cuda
@pytest.mark.parametrize("Kb", [1, 16, 42])
@pytest.mark.parametrize("layers,act", _MB_BF16_NETS)
@pytest.mark.parametrize("seeded", [False, True])
def test_cuda_bf16_k_bump_matches_plain(dev, seeded, layers, act, Kb):
    """The bf16-dot variants of rows 11-12 against their plain bf16-dot
    versions, float32 on the card: pass B's gradient leaves and sum ct_v
    norm-rel <= 1e-4, every pass-A sum within 1e-5 of the sum of its terms'
    magnitudes; no further from the float64 witness than 2x the plain
    version (+2e-6); more than 10x the bar from the fp32 kernel (the cast is
    delivered); two launches bitwise equal, each counted under
    ``multi_*.bf16`` and launched in the tensor-core design."""
    from nnpde_tpu_torch.kernels import _cuda

    name = ("multi_seeded" if seeded else "multi_sums") + ".bf16"
    run, plain, rel = _mb_bf16_case(dev, seeded, layers, act, Kb)
    bar = 1e-4 if seeded else 1e-5
    before = LAUNCHES[name]
    with _cuda.capture() as cap:
        out = run("bfloat16")
    out2 = run("bfloat16")
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 2
    assert [c[0] for c in cap.calls] == [name]
    # the design argument: DES_MMA, with DES_WIDE above width 128
    des = cap.calls[0][2][13]
    assert des & ~_cuda.DES_WIDE == _cuda.DES_MMA
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    assert rel(out, plain("bfloat16")) <= bar
    wit = plain("bfloat16", torch.float64)
    assert rel(out, wit) <= 2.0 * rel(plain("bfloat16"), wit) + 2e-6
    assert rel(out, run("float32")) > 10 * bar


@pytest.mark.cuda
@pytest.mark.parametrize("Kb", [1, 16, 42])
@pytest.mark.parametrize("seeded", [False, True])
def test_cuda_k_bump_bf16x3_runs_the_float32_kernels(dev, seeded, Kb):
    """Rows 11-12 with ``dot_dtype='bf16x3'`` launch the float32 kernel
    (counted under its plain name) and are bitwise the ``'float32'``
    result, at 1, 16 and 42 bumps."""
    name = "multi_seeded" if seeded else "multi_sums"
    run, _, _ = _mb_bf16_case(dev, seeded, (2, 50, 50, 50, 50, 1), "sin", Kb)
    before = (LAUNCHES[name], LAUNCHES[name + ".bf16"])
    x3, f32 = run("bf16x3"), run("float32")
    torch.cuda.synchronize()
    assert (LAUNCHES[name], LAUNCHES[name + ".bf16"]) == (before[0] + 2, before[1])
    assert all(torch.equal(a, b) for a, b in zip(x3, f32))


@pytest.mark.cuda
def test_cuda_multibump_mma_layout_mirror(dev):
    """Rows 11-12's tensor-core layouts and scratch in Python are the
    kernels' own count for every tile, tier and bump count (pass A's 3K
    double lanes); a bump count outside 1-42 is refused."""
    import ctypes

    from nnpde_tpu_torch.kernels import _build, _plan

    lib = _build.load()
    flags_all = {False: (0, _plan.RES_WEIGHTS, _plan.DEV_WEIGHTS),
                 True: (0, _plan.RES_WEIGHTS, _plan.RES_GRAD, _plan.RES_WEIGHTS | _plan.RES_GRAD,
                        _plan.DEV_WEIGHTS, _plan.DEV_WEIGHTS | _plan.DEV_SUMS)}
    for layers in [(2, 20, 20, 20, 1), (2, 50, 50, 50, 50, 1), (5, 7, 9, 1), (2, 12, 1),
                   (1, 200, 200, 200, 1), (16,) + (256,) * 15 + (1,)]:
        lay = (ctypes.c_int * len(layers))(*layers)
        args = (ctypes.addressof(lay), len(layers))
        for seeded in (False, True):
            kind = "multi_seeded" if seeded else "multi_sums"
            for Kb in (1, 2, 16, 42):
                for T in (8, 16, 32):
                    for flags in flags_all[seeded]:
                        assert lib.fused_multibump_mma_smem_bytes(
                            int(seeded), Kb, *args, T, flags) == tfs.mma_smem_bytes(
                                layers, T, flags, kind, n_bumps=Kb)
                        assert lib.fused_multibump_mma_scratch_floats(
                            int(seeded), *args, T, flags) == tfs.mma_scratch_floats(
                                layers, T, kind, flags)
        assert lib.fused_multibump_mma_smem_bytes(0, 43, *args, 16, 0) == -1
        assert lib.fused_multibump_mma_smem_bytes(0, 0, *args, 16, 0) == -1
        assert lib.fused_multibump_mma_smem_bytes(1, 4, *args, 24, 0) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("layers,act", _MB_BF16_NETS)
def test_cuda_k_bump_pass_a_at_one_bump_is_the_linear_pass_a(dev, layers, act):
    """At one bump the K-bump pass A and the linear quotient's pass A
    without the Laplacian (rows 11 and 7) are the same function on the same
    body and plan: their sums r, mass and e2 bit for bit, in the bf16-dot
    mode and in float32."""
    from nnpde_tpu_torch.kernels import fused_multibump as tfm
    from nnpde_tpu_torch.kernels import fused_quotient as tfq

    rng = np.random.default_rng(5)
    d = layers[0]
    tp = params_from_jax(_np_params(rng, layers), device=dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (4000 + 7, d)).astype(np.float32), device=dev)
    coef, _ = tfm.weak_form_stream(X, 1, rng, L)
    lin = torch.cat([coef[:, :d + 1], torch.zeros_like(coef[:, :1]), coef[:, d + 1:]], dim=1)
    for dot in ("bfloat16", "float32"):
        m = tfm.fused_multi_sums(tp, X, coef, act, 1, dot_dtype=dot)
        q = tfq.fused_linear_sums(tp, X, lin, act, no_lap=True, dot_dtype=dot)
        for k in ("sum_r", "sum_mass", "sum_e2"):
            assert torch.equal(m[k].reshape(()), q[k].reshape(())), (dot, k)


# ------------------------------------------- nets beyond the other kernels' limits (B7)
# The fp32 kernels on hidden widths above 256 (the weights in device
# memory), more than 16 weight matrices and d > 16: the CPU nets of
# tests/test_torch_beyond*.py and chip_smoke.py's beyond nets (the 512-wide
# one at 1007 points).
_BEYOND_NETS = [
    ((2, 300, 300, 1), "sin"),
    ((20, 16, 16, 1), "tanh"),
    ((2,) + (8,) * 20 + (1,), "sin"),
    ((2, 512, 512, 512, 512, 1), "sin"),
    ((1, 1001, 300, 1), "tanh"),
    ((18, 128, 128, 1), "gelu"),
    ((20, 64, 64, 64, 64, 1), "sin"),
    ((2,) + (32,) * 23 + (1,), "tanh"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "analytic", "forward", "backward"])
@pytest.mark.parametrize("layers,act", _BEYOND_NETS)
def test_cuda_beyond_nets_match_plain(dev, kind, layers, act):
    """Each of the four kernels on a B7 net against its float64 plain
    version, by the bars of the other shapes (``_check_fused``,
    ``_check_pass_a``, ``_check_backward``: repeats bitwise, each launch
    counted), on the plan the wrapper takes: a ``DES_BEYOND`` design for
    rows 1, 2 and 5 exactly where the net is beyond the other kernels'
    limits, with the weights in device memory above width 256."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    if kind == "forward":
        pl = tfc.forward_plan(list(layers), N=1007)
        assert not pl.design & _cuda.DES_BEYOND
        _check_pass_a(dev, "fwdlap_forward", layers, act, 1)
    elif kind == "backward":
        pl = tfc.backward_plan(list(layers))
        _check_backward(dev, layers, act)
    else:
        pl = tfs.plan(_FUSED[kind], list(layers))
        _check_fused(dev, kind, layers, act)
    if kind != "forward":
        assert bool(pl.design & _cuda.DES_BEYOND) == _cuda.beyond(layers)
    assert bool(pl.design & _cuda.DES_DEVW) == (max(layers[1:-1]) > 256)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,lap", [("drm", None), ("linear_sums", 0), ("linear_sums", 1),
                                      ("linear_seeded", 0), ("linear_seeded", 1),
                                      ("quad_sums", 0), ("quad_seeded", 0)])
@pytest.mark.parametrize("layers,act", _BEYOND_NETS)
def test_cuda_beyond_quotient_nets_match_plain(dev, kind, lap, layers, act):
    """Rows 3 and 7-10 on each B7 net (rows 7 and 8 with and without the
    Laplacian stream) against their float64 plain versions, by the bars of
    the other shapes (``_check_fused``, ``_check_pass_a``,
    ``_check_quotient``: repeats bitwise, each launch counted), on the plan
    the wrapper takes: a ``DES_BEYOND`` design for rows 3, 8 and 10 exactly
    where the net is beyond the other kernels' limits, none for pass A (7,
    9); the weights in device memory above width 256."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fused_quotient as tfq

    if kind == "drm":
        pl = tfs.plan(_FUSED[kind], list(layers))
        _check_fused(dev, kind, layers, act)
    elif kind.endswith("sums"):
        pl = tfq.plan(kind, list(layers), lap, N=1007, sms=_cuda.sm_count(dev))
        _check_pass_a(dev, kind, layers, act, lap)
    else:
        pl = tfq.plan(kind, list(layers), lap)
        _check_quotient(dev, kind, layers, act, lap)
    assert bool(pl.design & _cuda.DES_BEYOND) == (_cuda.beyond(layers)
                                                  and not kind.endswith("sums"))
    assert bool(pl.design & _cuda.DES_DEVW) == (max(layers[1:-1]) > 256)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["streams", "multi_sums", "multi_seeded"])
@pytest.mark.parametrize("layers,act", _BEYOND_NETS)
def test_cuda_beyond_eigen_nets_match_plain(dev, kind, layers, act):
    """Rows 6, 11 and 12 (16 bumps) on each B7 net against their float64
    plain versions, by the bars of the other shapes (``_check_pass_a``,
    ``_check_multibump``: repeats bitwise, each launch counted), on the plan
    the wrapper takes: a ``DES_BEYOND`` design for row 12 exactly where the
    net is beyond the other kernels' limits, none for rows 6 and 11; the
    weights in device memory where no staging matrix fits (every
    hidden-to-hidden width above 256)."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fused_multibump as tfm
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    if kind == "streams":
        pl = tfc.forward_plan(list(layers), N=1007, sms=_cuda.sm_count(dev))
        _check_pass_a(dev, "fwdlap_forward_streams", layers, act, 1)
    else:
        seeded = kind == "multi_seeded"
        pl = tfm.plan(seeded, list(layers), 16)
        _check_multibump(dev, seeded, 16, layers, act)
    assert bool(pl.design & _cuda.DES_BEYOND) == (kind == "multi_seeded"
                                                  and _cuda.beyond(layers))
    assert bool(pl.design & _cuda.DES_DEVW) == (max(layers[1:-1]) > 256)


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("layers,act", [((20, 64, 64, 64, 64, 1), "sin"),
                                        ((2, 512, 512, 512, 512, 1), "sin")])
def test_cuda_beyond_multibump_at_the_bump_cap(dev, seeded, layers, act):
    """The K-bump pair at its cap of 42 bumps on the d = 20 and the 512-wide
    B7 nets (the coefficient tile 42 (d + 4) floats a point, 1008 at d =
    20): the bars of ``_check_multibump``."""
    _check_multibump(dev, seeded, 42, layers, act)


# rows 1-5 bf16 on the same nets; the jet forward's bf16-dot mode takes d
# <= 16 only (JAX's _forward_kernel2 takes d <= 6)
_BEYOND_BF16_CASES = [(kind, layers, act) for layers, act in _BEYOND_NETS
                      for kind in ("linear", "analytic", "drm", "forward", "backward")
                      if not (kind == "forward" and layers[0] > 16)]


def _beyond_bf16_case(dev, kind, layers, act, seed, N):
    """A bf16-dot row of rows 1-5 on a B7 net: ``run()`` the wrapper's
    launch and ``plain(params, dtype)`` its plain bf16-dot version (float64:
    the witness), as lists of tensors (the loss and every gradient leaf, or
    the jet rows), on the inputs :func:`_bf16_case` gives (the Ritz energy:
    the box-FBC factor's coefficients with f = sin x_0)."""
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc
    from nnpde_tpu_torch.models import factor_for_technique

    tp, run, plain = _bf16_case(dev, "linear" if kind == "drm" else kind, layers, act, seed, N)
    rng = np.random.default_rng(seed)
    _np_params(rng, layers)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, layers[0])).astype(np.float32), device=dev)
    fj = factor_for_technique("FBC", dim=layers[0], kind="box", L=L).jet(X)
    coef = tfs.residual_coefficients(fj, a0=-1.0, rhs=torch.sin(X[:, 0]))
    dcoef = tfs.drm_coefficients(fj, torch.sin(X[:, 0]))
    jet = tfc.fwdlap_forward_plain(tp, X, act)
    r = (coef[:, 0] * jet.value + torch.sum(coef[:, 1:1 + layers[0]] * jet.grad, dim=1)
         + coef[:, layers[0] + 1] * jet.lap + coef[:, layers[0] + 2])
    ct = ((2.0 / N) * r[:, None] * coef[:, :layers[0] + 2]).contiguous()
    ks = (1,) * layers[0]

    def run_drm():
        loss, _, g = tfs.fused_drm_energy(tp, X, dcoef, act, dot_dtype="bfloat16")
        return [loss.reshape(1)] + [t for pair in g for t in pair]

    def plain_of(params, dtype=torch.float32, order=None):
        P = [(W.to(dtype), b.to(dtype)) for W, b in params]
        Xd = X.to(dtype)
        if kind == "forward":
            return [tfc.fwdlap_forward_default_plain(P, Xd, act)]
        if kind == "backward":
            rW, rb = tfc.fwdlap_backward_plain(P, Xd, ct.to(dtype), act, "bfloat16", order)
            return [t for pair in zip(rW, rb) for t in pair]
        if kind == "drm":
            dWs, dbs, sums = tfs.drm_energy_plain(P, Xd, dcoef.to(dtype), act, "bfloat16",
                                                  order)
            scale = 1.0 / N
        elif kind == "linear":
            dWs, dbs, sums = tfs.linear_residual_plain(P, Xd, coef.to(dtype), act, "bfloat16",
                                                       order)
            scale = 2.0 / N
        else:
            dWs, dbs, sums = tfs.poisson_analytic_plain(P, Xd, act, tfs.PoissonSinCoef(L, ks),
                                                        "bfloat16", order)
            scale = 2.0 / N
        g = tfs._scaled_grads(P, dWs, dbs, sums, scale)
        return [(sums[0] / N).reshape(1)] + [t for pair in g for t in pair]

    return tp, X, (run_drm if kind == "drm" else run), plain_of


@pytest.mark.cuda
@pytest.mark.parametrize("kind,layers,act", _BEYOND_BF16_CASES)
def test_cuda_beyond_bf16_nets_match_plain(dev, kind, layers, act):
    """Rows 1-5 bf16 on each B7 net (row 4 where d <= 16) at 1007 points:
    every loss and leaf (row 4: every jet column) within C2's bar, max(1e-4,
    C2_SPREAD_MULTIPLE x the plain version's own spread on that net,
    measured here), of the plain bf16-dot version, the spread being the
    plain version's largest distance from itself in another sound rounding
    order: its hidden units permuted, and (rows 1-3, 5) the reverse
    nonlinearity's sum in the orders of ``ops.fwdlap.DV_ORDERS`` (row 2
    also its coefficients rounded once from float64,
    ``fused_step.ANALYTIC_ORDERS``); no
    further from the float64 witness than the larger of 2x the plain
    version + 2e-6 and the plain version + C4_SPREAD_MULTIPLE x that spread
    (ROADMAP.md C4's form; row 4: each column by C4's bar,
    ``fwdlap_cuda.c4_columns``); two launches bitwise equal, each counted
    under its ``.bf16`` name; the plan the wrapper takes, with
    ``DES_BEYOND`` for rows 1-3 exactly on the nets of ``_cuda.beyond``."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc
    from nnpde_tpu_torch.ops.fwdlap import DV_ORDERS

    base = {"linear": "fused_linear_residual", "analytic": "fused_poisson_analytic",
            "drm": "fused_drm_energy", "forward": "fwdlap_forward",
            "backward": "fwdlap_backward"}[kind]
    N = 1000 + 7
    tp, X, run, plain = _beyond_bf16_case(dev, kind, layers, act, 37, N)
    pl = tfs.mma_plan(base, list(layers))
    assert bool(pl.design & _cuda.DES_BEYOND) == (base.startswith("fused")
                                                  and _cuda.beyond(layers))
    name = base + ".bf16"
    before = LAUNCHES[name]
    out, out2 = run(), run()
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    want = plain(tp)
    spread = _wide_spread(kind, tp, layers, plain)
    if kind != "forward":
        orders = tfs.ANALYTIC_ORDERS if kind == "analytic" else DV_ORDERS
        spread = max([spread] + [_leaf_rel(plain(tp, order=o), want) for o in orders])
    bar = max(1e-4, C2_SPREAD_MULTIPLE * spread)
    if kind == "forward":
        assert _col_rel(out[0], want[0]) <= bar
        for col in tfc.c4_columns(tp, X, act, out[0]):
            assert col["kernel"] <= col["bar"], col
    else:
        witness = plain(tp, torch.float64)
        w_plain = _leaf_rel(want, witness)
        assert _leaf_rel(out, want) <= bar
        assert _leaf_rel(out, witness) <= max(2.0 * w_plain + 2e-6,
                                              w_plain + tfc.C4_SPREAD_MULTIPLE * spread)


@pytest.mark.cuda
def test_cuda_beyond_nofit_raises(dev):
    """(20, 512 x 4, 1): no tile of 4 points fits its stages, so each of the
    twelve fp32 wrappers (rows 7 and 8 with and without the Laplacian
    stream) raises NoFit naming ROADMAP.md B7, and nothing launches."""
    from nnpde_tpu_torch.kernels import _cuda, _plan
    from nnpde_tpu_torch.kernels import fused_multibump as tfm
    from nnpde_tpu_torch.kernels import fused_quotient as tfq
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    layers, N = (20, 512, 512, 512, 512, 1), 64
    tp = params_from_jax(_np_params(np.random.default_rng(5), layers), device=dev)
    X = torch.rand(N, 20, device=dev)
    lin, quad = torch.zeros(N, 25, device=dev), torch.zeros(N, 23, device=dev)
    calls = [lambda: tfs.fused_linear_residual(tp, X, torch.zeros(N, 24, device=dev), "sin"),
             lambda: tfs.fused_poisson_analytic(tp, X, "sin", L=L, ks=(1,) * 20),
             lambda: tfs.fused_drm_energy(tp, X, torch.zeros(N, 22, device=dev), "sin"),
             lambda: tfc.fwdlap_forward(tp, X, "sin"),
             lambda: tfc.fwdlap_backward(tp, X, torch.zeros(N, 22, device=dev), "sin"),
             lambda: tfq.fused_quad_sums(tp, X, quad, "sin"),
             lambda: tfq.fused_quad_seeded_grads(tp, X, quad, (0.4, -0.3), "sin"),
             lambda: tfc.fwdlap_forward(tp, X, "sin", "streams"),
             lambda: tfm.fused_multi_sums(tp, X, torch.zeros(N, 96, device=dev), "sin", 4),
             lambda: tfm.fused_multi_seeded_grads(tp, X, torch.zeros(N, 96, device=dev),
                                                  (torch.zeros(4, device=dev),) * 3, "sin", 4)]
    for no_lap in (False, True):
        calls += [lambda no_lap=no_lap: tfq.fused_linear_sums(tp, X, lin, "sin", no_lap=no_lap),
                  lambda no_lap=no_lap: tfq.fused_seeded_grads(tp, X, lin, (0.3, -0.2, 0.7),
                                                               "sin", no_lap=no_lap)]
    before = dict(_cuda.LAUNCHES)
    for call in calls:
        with pytest.raises(_plan.NoFit, match="ROADMAP.md B7"):
            call()
    assert _cuda.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("seed", C4_SEEDS)
def test_cuda_bf16_forward_tanh_within_c4_bar(dev, seed):
    """Row 4 bf16 (``fwd_impl='rows:default'``) on (1, 100 x 3, 1) tanh at
    40000 points, at every seed of the study of ``ROADMAP.md`` C4 (the draws
    of ``tools/fwd_bf16_columns.py``): each jet column no further from the
    float64 witness than C4's bar (``fwdlap_cuda.c4_columns``: the larger of
    2x the plain version's distance + 2e-6 and the plain version's distance
    + ``C4_SPREAD_MULTIPLE`` times its spread over sound rounding orders).
    A column's distance counts the entries that round to the other bf16
    neighbour; the plain version's own rounding orders move it by up to
    10x either way, and the kernel's multiply-adds, fused where the plain
    version rounds twice, are one such order (PERF.md, C4)."""
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    rng = np.random.default_rng(seed)
    layers, N = (1, 100, 100, 100, 1), 40000
    tp = params_from_jax(_np_params(rng, layers), device=dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, 1)).astype(np.float32), device=dev)
    out = tfc.fwdlap_forward(tp, X, "tanh", "rows:default")
    for col in tfc.c4_columns(tp, X, "tanh", out):
        assert col["kernel"] <= col["bar"], col


@pytest.mark.cuda
@pytest.mark.parametrize("layers,act", [((1, 100, 100, 100, 1), "tanh"),
                                        ((1, 100, 100, 100, 1), "sin"),
                                        ((2, 64, 64, 64, 64, 1), "sin")])
def test_cuda_bf16_forward_within_twice_plain_of_float64(dev, layers, act):
    """Row 4 bf16 (``fwd_impl='rows:default'``) at 40000 points, seed 31
    (the draws of ``tools/fwd_bf16_columns.py``): each jet column no further
    from the float64 witness (the plain bf16-dot version in float64) than
    2x the plain version in fp32 is, + 2e-6 (the port's bar for the bf16
    rows).  On (1, 100 x 3, 1) tanh the value column was 7.7x its plain
    version's distance while the products feeding a bf16 rounding ran on
    the tensor cores, which cut their sums toward zero (fwdlap_mma.cuh,
    f32_products).  (That net's grad and Laplacian columns are held at all
    17 seeds of its study by C4's bar:
    ``test_cuda_bf16_forward_tanh_within_c4_bar``.)"""
    from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

    rng = np.random.default_rng(31)
    N, d = 40000, layers[0]
    tp = params_from_jax(_np_params(rng, layers), device=dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    out = tfc.fwdlap_forward(tp, X, act, "rows:default").double()
    plain = tfc.fwdlap_forward_default_plain(tp, X, act).double()
    wit = tfc.fwdlap_forward_default_plain([(W.double(), b.double()) for W, b in tp],
                                           X.double(), act)
    for c in range(d + 2):
        scale = torch.linalg.norm(wit[:, c])
        w_kernel = float(torch.linalg.norm(out[:, c] - wit[:, c]) / scale)
        w_plain = float(torch.linalg.norm(plain[:, c] - wit[:, c]) / scale)
        assert w_kernel <= 2.0 * w_plain + 2e-6, (c, w_kernel, w_plain)
