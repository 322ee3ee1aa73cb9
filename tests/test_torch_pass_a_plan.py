"""The launch plans of the forward-only kernels on the CPU: the jet forward
(row 4) and the quotient sums (rows 7 and 9) in the planned design.

What runs here is the Python half of the kernels: their shared-memory
layout mirrors (held to a formula written out below, and on a card to the
kernels' own count, ``tests/test_torch_cuda.py``), the plans every shape
the wrappers take gets, and the wrappers' CPU routing to the plain
versions.  The kernels themselves are held to their float64 plain versions
at 1e-5 on a card.
"""

import numpy as np
import pytest
import torch

from nnpde_tpu_torch.kernels import _cuda, _plan
from nnpde_tpu_torch.kernels import fused_quotient as tfq
from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

NETS = {"u64": (2, 64, 64, 64, 64, 1), "c64": (2, 64, 64, 1), "u50": (2, 50, 50, 50, 50, 1),
        "c20": (2, 20, 20, 20, 1), "u64_d5": (5, 64, 64, 64, 64, 1)}
EXTREMES = {
    "d16_w128_16layers": (16,) + (128,) * 15 + (1,),
    "width1": (2, 1, 1, 1),
    "widths_1_and_50": (2, 50, 1, 50, 1),
    "w128_shallow": (2, 128, 128, 1),
    "one_hidden": (2, 12, 1),
    **NETS,
}
SUMS = [("linear_sums", 0), ("linear_sums", 1), ("quad_sums", 0)]


def _padded(w):
    return -(-w // 4) * 4


def _hidden(layers):
    """Floats of the hidden-to-hidden matrices, each side rounded up to 4."""
    hid = [_padded(w) for w in layers[1:-1]]
    return sum(a * b for a, b in zip(hid[:-1], hid[1:]))


# ------------------------------------------------------------ layout mirrors
@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_forward_layout_mirror_is_the_written_out_layout(net):
    """The jet forward's planned layout (rows 4 and 6: both output layouts):
    two stream buffers of (d+2) x T x wmax, one staged layer (wmax^2) or
    the resident hidden weights, the tile's points and its projected
    streams."""
    layers = EXTREMES[net]
    d, wmax = layers[0], _padded(max(layers[1:-1]))
    for T in (4, 16, 36, 48):
        common = 2 * (d + 2) * T * wmax + T * d + (d + 2) * T
        assert tfc.forward_smem_floats(layers, T, 0) == common + wmax * wmax
        assert tfc.forward_smem_floats(layers, T, _plan.RES_WEIGHTS) == common + _hidden(layers)


@pytest.mark.parametrize("kind,lap", SUMS)
@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_sums_layout_mirror_is_the_written_out_layout(net, kind, lap):
    """Rows 7 and 9: the per-point double sums (2 floats each), two stream
    buffers of S x T x wmax, one staged layer or the resident hidden weights
    (no transposes in pass A), the coefficient tile at an odd row stride,
    the points, the projected streams, NT floats of reduction scratch and 4
    more."""
    layers = EXTREMES[net]
    d, wmax = layers[0], _padded(max(layers[1:-1]))
    linear = kind == "linear_sums"
    S, nsums, nc = d + 1 + lap, 4 if linear else 2, d + (5 if linear else 3)
    for T in (4, 16, 32, 48):
        common = (2 * nsums * T + 2 * S * T * wmax + T * (nc | 1) + T * d + S * T
                  + _cuda.NT + 4)
        assert tfq.smem_floats(kind, layers, T, lap, 0) == common + wmax * wmax
        assert (tfq.smem_floats(kind, layers, T, lap, _plan.RES_WEIGHTS)
                == common + _hidden(layers))


# ---------------------------------------------------------------- the plans
def _room(smem, blocks):
    """Whether ``blocks`` blocks of ``smem`` bytes fit one SM's 228 KB (1 KB
    of it reserved per block)."""
    return blocks * (smem + 1024) <= _plan.SM_SMEM


def _launchable(pl, smem_of):
    """What the entry points of fwdlap_forward.cu and fused_quotient.cu
    check before a planned launch, and a register budget (blocks per SM) of
    a compiled variant that its shared memory leaves room for."""
    return (4 <= pl.T <= _cuda.NT // 2 and pl.T % 4 == 0
            and pl.flags in (0, _plan.RES_WEIGHTS) and pl.design in _cuda.PLANNED_DESIGNS
            and pl.smem == 4 * smem_of(pl.T, pl.flags) <= _cuda.SMEM_MAX
            and 2 <= pl.blocks <= _plan.FWD_BLOCKS
            and (_room(pl.smem, pl.blocks) or pl.blocks == 2))


def _plan_or_named_error(plan, layers):
    try:
        return plan()
    except ValueError as err:
        assert str(list(layers)) in str(err)
        return None


@pytest.mark.parametrize("design", ["wrapper", 2, 3])
@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_forward_plan_takes_every_shape_the_wrapper_takes(net, design):
    """Every net the wrapper's check takes (d <= 16, widths 1-128, 2-16
    weight matrices) gets a plan the kernel takes within SMEM_MAX in every
    planned design, or a ValueError that names the net; a pinned tier at 16
    points fits or raises."""
    design = None if design == "wrapper" else design
    layers = EXTREMES[net]
    params = [(torch.zeros(a, b), torch.zeros(b)) for a, b in zip(layers[:-1], layers[1:])]
    assert _cuda.net_layers("fwdlap_forward", params, torch.zeros(8, layers[0]),
                            "sin") == list(layers)
    pl = _plan_or_named_error(lambda: tfc.forward_plan(layers, design), layers)
    assert pl is not None
    assert _launchable(pl, lambda t, f: tfc.forward_smem_floats(layers, t, f))
    for tier, _ in _plan.tiers(False):
        pinned = _plan_or_named_error(
            lambda: tfc.forward_plan(layers, pl.design, T=16, tier=tier), layers)
        if pinned is not None:
            assert (pinned.T, pinned.tier) == (16, tier)
            assert _launchable(pinned, lambda t, f: tfc.forward_smem_floats(layers, t, f))


@pytest.mark.parametrize("design", ["wrapper", 2, 3])
@pytest.mark.parametrize("kind,lap", SUMS)
@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_sums_plan_takes_every_shape_the_wrapper_takes(net, kind, lap, design):
    """The same for pass A of the linear weak form (with and without the
    Laplacian stream) and of the quadratic energy."""
    design = None if design == "wrapper" else design
    layers = EXTREMES[net]
    pl = _plan_or_named_error(lambda: tfq.plan(kind, layers, lap, design=design), layers)
    assert pl is not None
    assert _launchable(pl, lambda t, f: tfq.smem_floats(kind, layers, t, lap, f))
    for tier, _ in _plan.tiers(False):
        pinned = _plan_or_named_error(
            lambda: tfq.plan(kind, layers, lap, T=16, tier=tier, design=pl.design), layers)
        if pinned is not None:
            assert (pinned.T, pinned.tier) == (16, tier)
            assert _launchable(pinned, lambda t, f: tfq.smem_floats(kind, layers, t, lap, f))


def test_pinned_tile_that_does_not_fit_names_the_shape():
    layers = EXTREMES["d16_w128_16layers"]
    with pytest.raises(ValueError, match=r"fwdlap_forward plan: layers \[16, 128"):
        tfc.forward_plan(layers, T=128)
    with pytest.raises(ValueError, match=r"linear_sums plan: layers \[16, 128"):
        tfq.plan("linear_sums", layers, 1, T=128)


def test_forward_only_budget_follows_the_share():
    """A forward-only plan's register budget (``Plan.blocks``, the variant
    of __launch_bounds__ it launches) is the most blocks per SM, 3 or 2, that
    its shared memory leaves room for (``blocks`` caps it); a tile that fits
    only one block a SM takes the 2-block variant."""
    layers = NETS["u64"]
    assert tfc.forward_plan(layers, 2, T=16, tier="staged").blocks == 3
    assert tfc.forward_plan(layers, 2, T=16, tier="staged", blocks=2).blocks == 2
    assert tfc.forward_plan(layers, 2, T=16, tier="resident").blocks == 2
    assert tfc.forward_plan(layers, 3, T=32, tier="staged").blocks == 2
    assert tfc.forward_plan(layers, 3, T=28, tier="staged").blocks == 3
    pl = tfc.forward_plan(EXTREMES["d16_w128_16layers"], 2, T=8, tier="staged")
    assert pl.blocks == 2 and not _room(pl.smem, 2)


def _record_launches(monkeypatch):
    """Stand in for the kernel library and the card: the launches made are
    recorded as ``(name, entry point, args)``; every occupancy query answers
    one block, the card has 132 SMs."""
    from nnpde_tpu_torch.kernels import _build

    calls = []

    class Lib:
        def __getattr__(self, name):
            return name

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(_cuda, "grid", lambda name, query, smem, dev, n, key=0: 1)
    monkeypatch.setattr(_cuda, "stream", lambda dev: 0)
    monkeypatch.setattr(_cuda, "sm_count", lambda dev: 132)
    monkeypatch.setattr(_cuda, "launch", lambda name, fn, *args, dev, keep=(): calls.append(
        (name, fn, args)))
    return calls


@pytest.mark.parametrize("fwd_impl", ["rows", "streams"])
@pytest.mark.parametrize("net,N,want", [
    ("u64", 20000, (16, "staged", 2, 3)),      # 4 x 4: the two-point plan fills 2.4 rounds
    ("u64", 262144, (32, "resident", 3, 2)),
    ("c64", 20000, (16, "resident", 2, 3)),
    ("c64", 262144, (32, "resident", 3, 2)),
    ("u50", 40000, (36, "resident", 3, 2)),    # ragged: residency before a block per SM
    ("c20", 40000, (48, "resident", 2, 3)),    # the two tiles are one: 4 x 4 items
    ("u64_d5", 20000, (16, "staged", 2, 3)),   # S = 7: the same 16 points
])
def test_forward_plan_path_shapes(monkeypatch, net, N, want, fwd_impl):
    """Rows 4 and 6 on the nets of their paths at their N (and 262144
    points) on a card of 132 SMs: (T, tier, design, blocks per SM).  The
    wrapper launches each output layout (``fwd_impl='rows'``: row 4,
    ``'streams'``: row 6) on exactly that plan, the stream-major one
    returning the ``(N, d+2)`` view of its ``(d+2, N)`` output."""
    layers = NETS[net]
    pl = tfc.forward_plan(layers, N=N, sms=132)
    assert (pl.T, pl.tier, pl.design, pl.blocks) == want
    assert _room(pl.smem, pl.blocks)
    calls = _record_launches(monkeypatch)
    params = [(torch.zeros(a, b), torch.zeros(b)) for a, b in zip(layers[:-1], layers[1:])]
    out = tfc.fwdlap_forward(params, torch.zeros(N, layers[0]), "sin", fwd_impl)
    streams = fwd_impl == "streams"
    [(name, entry, args)] = calls
    assert (name, entry) == ("fwdlap_forward_streams" if streams else "fwdlap_forward",
                             "fwdlap_forward_f32")
    # (streams, X, params, layers, n_layers, act, N, T, G, fold, bf16, des, minb, flags,
    #  out, smem, stream)
    assert args[0] == int(streams) and args[10] == 0
    assert (args[7], args[11], args[12], args[13], args[15]) == (pl.T, pl.design, pl.blocks,
                                                                 pl.flags, pl.smem)
    assert out.shape == (N, layers[0] + 2)
    assert (out.t() if streams else out).is_contiguous()


@pytest.mark.parametrize("kind,net,N,want", [
    ("linear_sums", "c64", 20000, (16, "resident", 2, 3)),
    ("linear_sums", "c64", 262144, (32, "resident", 3, 3)),
    ("linear_sums", "u64", 20000, (16, "resident", 2, 3)),
    ("linear_sums", "u64", 262144, (32, "staged", 3, 3)),
    ("quad_sums", "c64", 20000, (16, "resident", 2, 3)),
    ("quad_sums", "u50", 40000, (36, "resident", 3, 2)),
    ("linear_sums", "u64_d5", 20000, (20, "resident", 3, 2)),
])
def test_sums_plan_path_shapes(kind, net, N, want):
    """Rows 7 and 9 on the nets of the Poisson WAN and the infinite-well DRM
    (no Laplacian stream: S = d + 1): (T, tier, design, blocks per SM)."""
    pl = tfq.plan(kind, NETS[net], 0, N=N, sms=132)
    assert (pl.T, pl.tier, pl.design, pl.blocks) == want
    assert _room(pl.smem, pl.blocks)


def test_two_point_plan_needs_rounds_of_the_card():
    """The two-point plan is taken where its tiles fill ROUNDS_MIN rounds of
    the card's slots (blocks per SM x SMs), the 4 x 4 plan below that; with
    no N, the two-point plan."""
    layers = NETS["u64"]
    big = tfc.forward_plan(layers)
    assert big.design == 3 and big.T == 32
    slots = big.blocks * 132
    edge = int(_plan.ROUNDS_MIN * slots) * big.T
    assert tfc.forward_plan(layers, N=edge, sms=132).design == 3
    assert tfc.forward_plan(layers, N=edge - big.T, sms=132).design == 2
    assert tfc.forward_plan(layers, N=edge, sms=264).design == 2


# ------------------------------------------------------------ CPU routing
def _np_params(rng, layers):
    return [(torch.as_tensor(rng.uniform(-0.5, 0.5, (a, b)).astype(np.float32)),
             torch.as_tensor(rng.uniform(-0.5, 0.5, (b,)).astype(np.float32)))
            for a, b in zip(layers[:-1], layers[1:])]


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU the jet forward and both sums kinds route to their plain
    versions without building or loading the kernels, and give exactly
    what those return."""
    from nnpde_tpu_torch.kernels import _build
    from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap

    def no_build():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_build, "load", no_build)
    rng = np.random.default_rng(31)
    layers = (2, 12, 12, 1)
    params = _np_params(rng, layers)
    X = torch.as_tensor(rng.uniform(0.0, 2.0, (33, 2)).astype(np.float32))
    jet = tfc.mlp_fwdlap_kernel(params, X, "sin")
    ref = mlp_fwdlap(params, X, "sin")
    assert torch.equal(jet.value, ref.value) and torch.equal(jet.grad, ref.grad)
    assert torch.equal(jet.lap, ref.lap)
    coef = torch.as_tensor(rng.normal(size=(33, 7)).astype(np.float32))
    s = tfq.fused_linear_sums(params, X, coef, "sin", no_lap=True)
    want = tfq.linear_sums_plain(params, X, coef, "sin", True)
    assert all(torch.equal(s[k], want[i])
               for i, k in enumerate(("sum_r", "sum_r2", "sum_mass", "sum_e2")))
    qcoef = torch.as_tensor(rng.normal(size=(33, 5)).astype(np.float32))
    q = tfq.fused_quad_sums(params, X, qcoef, "sin")
    want = tfq.quad_sums_plain(params, X, qcoef, "sin")
    assert torch.equal(q["sum_e"], want[0]) and torch.equal(q["sum_u2"], want[1])


# ------------------------------------------------------------- the wide nets
# Hidden widths 129-256 (the fp32 kernels' limit since the 1D oscillator's
# u200): every fp32 row's plan at u200 with d = 1 and 2, on the critic v100,
# on (1, 256, 256, 1) and on a ragged (1, 130, 256, 1).
WIDE = {"u200": (1, 200, 200, 200, 1), "u200_d2": (2, 200, 200, 200, 1),
        "v100": (1, 100, 100, 100, 1), "w256": (1, 256, 256, 1), "r130": (1, 130, 256, 1)}


def _wide_plan(row, layers, N=1000):
    """Row ``row``'s plan on ``layers`` (the wrapper's own), with its stream
    count and layout."""
    from nnpde_tpu_torch.kernels import fused_step as tfs

    if row in (1, 2, 3):
        kind = {1: "fused_linear_residual", 2: "fused_poisson_analytic",
                3: "fused_drm_energy"}[row]
        return tfs.plan(kind, layers), lambda T, f: tfs.smem_floats(kind, layers, T, f)
    if row in (4, 6):
        return (tfc.forward_plan(layers, N=N), lambda T, f: tfc.forward_smem_floats(layers, T, f))
    if row == 5:
        return tfc.backward_plan(layers), lambda T, f: tfc.backward_smem_floats(layers, T, f)
    kind, lap = {7: ("linear_sums", 0), 8: ("linear_seeded", 0), 9: ("quad_sums", 0),
                 10: ("quad_seeded", 0)}[row]
    return (tfq.plan(kind, layers, lap, N=N),
            lambda T, f: tfq.smem_floats(kind, layers, T, lap, f))


# (T, tier, design) of rows 1, 4, 5, 7, 8, 9, 10 on the 1D paths' wide nets
# at their 1000 points: one block per SM, every weight matrix staged per tile
WIDE_PATH = {
    ("u200", 1): (8, "staged", 2), ("u200", 4): (12, "staged", 2),
    ("u200", 5): (8, "staged", 2), ("u200", 7): (16, "staged", 2),
    ("u200", 8): (12, "staged", 0), ("u200", 9): (16, "staged", 2),
    ("u200", 10): (12, "staged", 0),
    ("v100", 4): (16, "staged", 2), ("v100", 7): (16, "staged", 2),
    ("v100", 8): (20, "staged", 0),
}


@pytest.mark.parametrize("row", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10])
@pytest.mark.parametrize("net", sorted(WIDE))
def test_wide_net_plans(net, row):
    """Every fp32 row gets a plan on the wide nets, within SMEM_MAX and its
    own layout; the weights are read from device memory (``DES_DEVW``,
    ``DEV_WEIGHTS``, no weights in shared memory) exactly where no plan with
    the weights on chip fits, and the 1D paths' shapes take the plans of WIDE_PATH."""
    layers = WIDE[net]
    pl, layout = _wide_plan(row, layers)
    assert pl.T >= 4 and pl.T % 4 == 0
    assert pl.smem == 4 * layout(pl.T, pl.flags) <= _cuda.SMEM_MAX
    devw = bool(pl.design & _cuda.DES_DEVW)
    assert devw == bool(pl.flags & _plan.DEV_WEIGHTS)
    # no tier with the weights on chip (staged or resident) fits
    assert devw == all(4 * layout(4, f) > _cuda.SMEM_MAX for f in (0, _plan.RES_WEIGHTS))
    if devw:
        assert pl.tier.endswith("device") and not pl.flags & _plan.RES_WEIGHTS
        assert pl.design in (_cuda.DES_DEVW, _cuda.DES_PLANNED | _cuda.DES_DEVW)
    if (net, row) in WIDE_PATH:
        assert (pl.T, pl.tier, pl.design) == WIDE_PATH[(net, row)]


@pytest.mark.parametrize("net", ["u50", "c20"])
def test_device_weights_design_pins_and_layouts(net):
    """The device-weights design pinned on a net that fits shared memory
    (the card tests hold its kernels there too): its layout is the staged
    one without the weight region, and a pinned other tier refuses it."""
    layers = {"u50": (1, 50, 50, 50, 1), "c20": (1, 20, 20, 20, 1)}[net]
    d, wmax = layers[0], _padded(max(layers[1:-1]))
    devw = _cuda.DES_PLANNED | _cuda.DES_DEVW
    for T in (8, 16):
        assert (tfc.forward_smem_floats(layers, T, _plan.DEV_WEIGHTS)
                == tfc.forward_smem_floats(layers, T, 0) - wmax * wmax)
        assert (tfq.smem_floats("quad_seeded", layers, T, 0, _plan.DEV_WEIGHTS)
                == tfq.smem_floats("quad_seeded", layers, T, 0, 0) - wmax * wmax)
    pl = tfc.forward_plan(layers, design=devw, N=1000)
    assert (pl.design, pl.flags, pl.tier, pl.blocks) == (devw, _plan.DEV_WEIGHTS, "device", 2)
    pl = tfq.plan("linear_seeded", layers, 0, design=_cuda.DES_DEVW)
    assert pl.design == _cuda.DES_DEVW and pl.flags & _plan.DEV_WEIGHTS
    pl = tfc.backward_plan(layers, devw)
    assert pl.design == devw and pl.flags & _plan.DEV_WEIGHTS
    with pytest.raises(_plan.NoFit):
        tfc.forward_plan(layers, design=devw, tier="staged", N=1000)
    with pytest.raises(ValueError) as bad:
        tfq.plan("quad_seeded", layers, 0, design=2)
    assert not isinstance(bad.value, _plan.NoFit)     # a bad pin is not a missing fit
    assert d == 1


def test_device_weights_buffer_is_the_resident_layout():
    """``_cuda.device_weights``: the hidden weights rounded up to multiples
    of 4 with zeros, back to back, then (pass B) their transposes."""
    rng = np.random.default_rng(0)
    layers = (1, 6, 5, 9, 1)
    params = [(torch.as_tensor(rng.normal(size=(a, b))), torch.as_tensor(rng.normal(size=b)))
              for a, b in zip(layers[:-1], layers[1:])]
    W1, W2 = params[1][0], params[2][0]
    fw = _cuda.device_weights(params, False)
    both = _cuda.device_weights(params, True)
    assert fw.numel() == _hidden(layers) == 8 * 8 + 8 * 12
    assert both.numel() == 2 * _hidden(layers)
    P1 = fw[:64].reshape(8, 8)
    assert torch.equal(P1[:6, :5], W1) and not P1[6:].any() and not P1[:, 5:].any()
    P2 = fw[64:].reshape(8, 12)
    assert torch.equal(P2[:5, :9], W2)
    T1 = both[160:224].reshape(8, 8)
    assert torch.equal(T1[:5, :6], W1.t()) and not T1[5:].any()
    assert _cuda.device_weights(params[:1] + params[-1:], True) is None
