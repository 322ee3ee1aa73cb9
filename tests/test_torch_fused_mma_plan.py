"""The tensor-core design (``DES_MMA``) of the bf16-dot kernels on the CPU:
the fused residual kernels (rows 1 and 2 with ``dot_dtype='bfloat16'``),
the jet pair (row 4 with ``fwd_impl='rows:default'``, row 5 with
``dot_dtype='bfloat16'``), the Deep-Ritz energy (row 3), the quotients'
two passes (rows 7-10), the last without the Laplacian stream where their
objectives drop it, and the K-bump WAN pair (rows 11-12), whose pass A
keeps 3K double lanes a point.

What runs here is the Python half of the design: its shared-memory layout
mirror (held to a formula written out below, and on a card to the kernel's
own count, ``tests/test_torch_cuda.py``), the plans every shape the wrapper
takes gets, which design each wrapper routes to (the launches recorded
through a stand-in for the library), and the CPU route of the bf16-dot mode
to its plain version.  The kernels themselves are held to their plain
bf16-dot versions on a card.
"""

import numpy as np
import pytest
import torch

from nnpde_tpu_torch.kernels import _build, _cuda, _plan
from nnpde_tpu_torch.kernels import fused_multibump as tfm
from nnpde_tpu_torch.kernels import fused_step as tfs
from nnpde_tpu_torch.kernels import fwdlap_cuda as tfc

NETS = {"u64": (2, 64, 64, 64, 64, 1), "c64": (2, 64, 64, 1), "u50": (2, 50, 50, 50, 50, 1),
        "c20": (2, 20, 20, 20, 1), "u64_d5": (5, 64, 64, 64, 64, 1)}
EXTREMES = {
    "d16_w128_16layers": (16,) + (128,) * 15 + (1,),
    # widths 129-256: the device tiers (DEV_WEIGHTS; DEV_SUMS at d = 16)
    "w200_d2": (2,) + (200,) * 4 + (1,),
    "w256_d2": (2,) + (256,) * 4 + (1,),
    "w256_d5": (5,) + (256,) * 3 + (1,),
    "d16_w256_16layers": (16,) + (256,) * 15 + (1,),
    "width1": (2, 1, 1, 1),
    "widths_1_and_50": (2, 50, 1, 50, 1),
    "w128_shallow": (2, 128, 128, 1),
    "one_hidden": (2, 12, 1),
    **NETS,
}
KINDS = ("fused_linear_residual", "fused_poisson_analytic")
JET_KINDS = ("fwdlap_backward", "fwdlap_forward")
FLAGS = (0, _plan.RES_WEIGHTS, _plan.RES_GRAD, _plan.RES_WEIGHTS | _plan.RES_GRAD,
         _plan.DEV_WEIGHTS, _plan.DEV_WEIGHTS | _plan.DEV_SUMS)


def _up(n, m):
    return -(-n // m) * m


def _written_out_bytes(layers, T, flags, kind="fused_linear_residual", lap=1, n_bumps=None):
    """The kernel's layout, written out: three bf16 stages of Sp*T rows at
    a row stride of the widest layer rounded up to 16 plus 8 (the jet
    forward and pass A two); the hidden weights in bf16, each kp16(in) rows
    of kp16(out) + 8 (all of them resident, none read from device memory,
    else the largest); the gradient row (the fused and seeded kinds with the
    three loss sums, the jet backward without, the jet forward and pass A
    none); then float regions, each rounded up to 4 floats: projection
    partials (n-blocks of 8 x rows; not in the jet backward), column sums
    (16-point blocks x (d + 2) x widest rounded to 8; not in the jet forward
    or pass A), both in device scratch with DEV_SUMS, the points, the
    cotangents (d + 2 rows; not in the jet forward or pass A), the sum terms
    (the fused and seeded kinds: 3 floats a point; pass A: 4 doubles, the
    K-bump pass A 3K of them if that is more) and the projected rows (not in
    the jet backward).  ``lap``: S = d + 1 + lap streams."""
    d, hidden = layers[0], layers[1:-1]
    fwd = kind in ("fwdlap_forward", "linear_sums", "quad_sums", "multi_sums")
    lanes = max(3 * n_bumps, 4) if kind == "multi_sums" else 4
    bwd = kind == "fwdlap_backward"
    S = d + 1 + lap
    Sp = S + S % 2 if T == 8 else S
    rows = Sp * T
    k16, n8 = _up(max(hidden), 16), _up(max(hidden), 8)
    n = (2 if fwd else 3) * rows * (k16 + 8) * 2
    weights = [_up(a, 16) * (_up(b, 16) + 8) * 2 for a, b in zip(hidden[:-1], hidden[1:])]
    if not flags & _plan.DEV_WEIGHTS:
        n += sum(weights) if flags & _plan.RES_WEIGHTS else max(weights, default=0)
    if flags & _plan.RES_GRAD and not fwd:
        P = sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
        n += 4 * _up(P + (0 if bwd else 3), 4)
    blocks16 = 1 if T == 8 else T // 16
    regions = {"partials": n8 // 8 * rows, "colsums": blocks16 * (d + 2) * n8, "points": T * d,
               "cotangents": (d + 2) * T, "sums": 3 * T, "doubles": 2 * lanes * T,
               "projected": rows}
    drop = {"fwdlap_forward": ("colsums", "cotangents", "sums", "doubles"),
            "linear_sums": ("colsums", "cotangents", "sums"),
            "quad_sums": ("colsums", "cotangents", "sums"),
            "multi_sums": ("colsums", "cotangents", "sums"),
            "fwdlap_backward": ("partials", "sums", "doubles", "projected")}.get(
                kind, ("doubles",))
    if flags & _plan.DEV_SUMS:
        drop += ("partials", "colsums")
    for name, floats in regions.items():
        if name not in drop:
            n += 4 * _up(floats, 4)
    return n


# ------------------------------------------------------------ layout mirror
@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_mma_layout_mirror_is_the_written_out_layout(net):
    layers = EXTREMES[net]
    for T in (8, 16, 32, 48):
        for flags in FLAGS:
            assert tfs.mma_smem_bytes(layers, T, flags) == _written_out_bytes(layers, T, flags)


@pytest.mark.parametrize("layers,T,flags,want", [
    # u64: stages 64 rows x 72 bf16; three 64 x 72 hidden matrices resident
    ((2, 64, 64, 64, 64, 1), 16, _plan.RES_WEIGHTS,
     3 * 64 * 72 * 2 + 3 * 64 * 72 * 2 + 4 * (8 * 64 + 4 * 64 + 32 + 64 + 48 + 64)),
    # width 50: k padded to 64 (rows of 72), n to 56 (7 n-blocks)
    ((2, 50, 50, 1), 16, _plan.RES_WEIGHTS,
     3 * 64 * 72 * 2 + 64 * 72 * 2 + 4 * (7 * 64 + 4 * 56 + 32 + 64 + 48 + 64)),
    # width 1: k padded to 16 (rows of 24), n to 8; d = 3 at T = 8 pads the
    # five streams to six
    ((3, 1, 1, 1), 8, 0, 3 * 48 * 24 * 2 + 16 * 24 * 2 + 4 * (48 + 5 * 8 + 24 + 40 + 24 + 48)),
])
def test_mma_layout_pads_to_k16_and_n8(layers, T, flags, want):
    """Worked values: the bf16 stages and weights padded to multiples of 16
    along k (and 8 more per row), the n-blocks to multiples of 8."""
    assert tfs.mma_smem_bytes(layers, T, flags) == want


@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_mma_scratch_floats(net):
    """The saved stages: K-1 stages x warp blocks x (stream tiles + the q
    tile) x 32 float4s; with DEV_SUMS the projection partials and the column
    sums after them."""
    layers = EXTREMES[net]
    d, hidden = layers[0], layers[1:-1]
    for T in (8, 16, 32):
        S = d + 2
        tiles = (S + S % 2) // 2 if T == 8 else S
        blocks = (1 if T == 8 else T // 16) * _up(max(hidden), 8) // 8
        saved = len(hidden) * blocks * (tiles + 1) * 128
        assert tfs.mma_scratch_floats(layers, T) == saved
        rows, n8 = (S + S % 2 if T == 8 else S) * T, _up(max(hidden), 8)
        sums = _up(n8 // 8 * rows, 4) + _up((1 if T == 8 else T // 16) * S * n8, 4)
        assert tfs.mma_scratch_floats(layers, T, flags=_plan.DEV_SUMS) == saved + sums
        assert tfs.mma_scratch_floats(layers, T, flags=_plan.DEV_WEIGHTS) == saved


# ---------------------------------------------------------------- the plans
def _fits(pl):
    """What fused_step.cu checks before a tensor-core launch."""
    return (pl.design == _cuda.DES_MMA and pl.smem <= _cuda.SMEM_MAX
            and (pl.T == 8 or pl.T % 16 == 0))


def _two_blocks(pl):
    """Whether two blocks of the plan fit one SM (1 KB of it per block)."""
    return 2 * (pl.smem + 1024) <= _plan.SM_SMEM


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_mma_plan_takes_every_shape_the_wrapper_takes(net, kind):
    """Every net the wrapper's check takes (d <= 16, widths 1-256, 2-16
    weight matrices) gets a tensor-core plan that fits the card's shared
    memory, with stage rows Sp*T a multiple of 16 (T = 8 pads an odd stream
    count by one); a pinned tier at 16 points fits or raises naming the
    net."""
    layers = EXTREMES[net]
    params = [(torch.zeros(a, b), torch.zeros(b)) for a, b in zip(layers[:-1], layers[1:])]
    assert _cuda.net_layers(kind, params, torch.zeros(8, layers[0]), "sin") == list(layers)
    pl = tfs.mma_plan(kind, layers)
    assert _fits(pl) and pl.design == _cuda.DES_MMA
    g = tfs.mma_geometry(layers, pl.T)
    assert g.ST % 16 == 0 and g.ST == g.Sp * pl.T and g.Sp - g.S in (0, 1)
    assert pl.smem == tfs.mma_smem_bytes(layers, pl.T, pl.flags)
    assert pl == tfs.plan(kind, layers, _cuda.DES_MMA)
    for tier, flags in tfs.MMA_TIERS:
        try:
            pinned = tfs.mma_plan(kind, layers, T=16, tier=tier)
        except ValueError as err:
            assert str(list(layers)) in str(err)
            continue
        assert (pinned.T, pinned.tier, pinned.flags) == (16, tier, flags) and _fits(pinned)


@pytest.mark.parametrize("net,want", [
    ("u64", (16, "resident", True)),          # the hybrid-kernel bulk's net
    ("u50", (16, "resident", True)),
    ("u64_d5", (16, "weights", True)),        # the gradient row does not fit beside 7 streams
    ("w128_shallow", (16, "weights", True)),
    ("d16_w128_16layers", (8, "staged", False)),
    # widths 129-256: the weights from device memory at two blocks per SM
    # where a staged matrix does not fit beside two 16-point tiles
    ("w200_d2", (16, "device", True)),
    ("w256_d2", (16, "device", True)),
    ("w256_d5", (16, "device", False)),
    ("d16_w256_16layers", (8, "device-sums", False)),
])
def test_mma_plan_path_shapes(net, want):
    """The plan's choices on the order measured on u64 (chip_smoke.py
    mma_sweep): the gradient row on chip first, then the resident weights,
    at 16-point tiles and two blocks per SM; 8-point tiles only where
    nothing else fits; the device tiers last."""
    pl = tfs.mma_plan("fused_linear_residual", EXTREMES[net])
    assert (pl.T, pl.tier, _two_blocks(pl)) == want
    assert pl.flags == dict(tfs.MMA_TIERS)[pl.tier]


@pytest.mark.parametrize("kind", KINDS)
def test_mma_plan_pins_and_refusals(kind):
    """Pinned tile, tier and blocks per SM are taken as given or raise: a
    tile that is neither 8 nor a multiple of 16, one that does not fit, more
    blocks than the kernels' register budget; a kernel without a bf16-dot
    mode (row 6, the stream-major jet forward) has no plan, and the K-bump
    pass A none without its bump count."""
    u64 = NETS["u64"]
    pl = tfs.mma_plan(kind, u64, T=32, tier="staged", blocks=2)
    assert (pl.T, pl.tier, pl.flags) == (32, "staged", 0) and _two_blocks(pl)
    one = tfs.mma_plan(kind, u64, T=32, tier="resident", blocks=1)
    assert one.tier == "resident" and not _two_blocks(one) and _fits(one)
    with pytest.raises(ValueError, match="multiple of 16"):
        tfs.mma_plan(kind, u64, T=24)
    with pytest.raises(ValueError, match="do not fit"):
        tfs.mma_plan(kind, u64, T=128, tier="resident")
    with pytest.raises(ValueError, match="do not fit"):
        tfs.mma_plan(kind, u64, T=32, tier="resident", blocks=2)
    with pytest.raises(ValueError, match="register budget"):
        tfs.mma_plan(kind, u64, blocks=3)
    with pytest.raises(ValueError, match="no bf16-dot mode"):
        tfs.mma_plan("fwdlap_forward_streams", u64)
    with pytest.raises(ValueError, match="bump count"):
        tfs.mma_plan("multi_sums", u64)


# ------------------------------------------------------------ the routing
class _Recorder:
    """Stands in for the kernel library and the card: records each launch's
    entry point and arguments; every occupancy query answers one block."""

    def __init__(self, monkeypatch):
        self.calls = []

        class Lib:
            def __getattr__(lib, name):
                return name

        monkeypatch.setattr(_build, "load", lambda: Lib())
        monkeypatch.setattr(_cuda, "grid", lambda name, query, smem, dev, n, key=0: 1)
        monkeypatch.setattr(_cuda, "stream", lambda dev: 0)
        monkeypatch.setattr(_cuda, "sm_count", lambda dev: 132)
        monkeypatch.setattr(_cuda, "launch",
                            lambda name, fn, *args, dev, keep=(): self.calls.append(
                                (name, fn, args)))


def _inputs(layers, N=40):
    rng = np.random.default_rng(41)
    params = [(torch.as_tensor(rng.uniform(-0.5, 0.5, (a, b)).astype(np.float32)),
               torch.as_tensor(rng.uniform(-0.5, 0.5, (b,)).astype(np.float32)))
              for a, b in zip(layers[:-1], layers[1:])]
    X = torch.as_tensor(rng.uniform(0.0, 2.0, (N, layers[0])).astype(np.float32))
    coef = torch.as_tensor(rng.normal(size=(N, layers[0] + 4)).astype(np.float32))
    return params, X, coef


@pytest.mark.parametrize("net", ["u64", "u50", "u64_d5", "width1", "d16_w128_16layers",
                                 "w200_d2", "d16_w256_16layers"])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_fused_kinds_route_to_the_tensor_core_design(monkeypatch, kind, net):
    """The bf16-dot mode of rows 1 and 2 launches DES_MMA on the wrapper's
    mma plan (its tile and flags passed through, no transposes),
    counted under ``<kernel>.bf16``; fp32 launches a planned design as
    before."""
    layers = EXTREMES[net]
    rec = _Recorder(monkeypatch)
    params, X, coef = _inputs(layers)
    analytic = tfs._analytic_args(tfs.PoissonSinCoef(2.0, (1,) * layers[0]), layers[0])
    for bf16 in (True, False):
        tfs._launch(kind, params, X, coef if kind == "fused_linear_residual" else None, "sin",
                    analytic, bf16=bf16)
    (name_b, fn_b, args_b), (name_f, fn_f, args_f) = rec.calls
    entry = kind + "_f32"
    assert (name_b, fn_b, name_f, fn_f) == (kind + ".bf16", entry, kind, entry)
    # (..., fold, bf16, des, flags, ...) after the layers and N, T, G
    at = 10 if kind == "fused_linear_residual" else 9
    fold, bf, des, flags = args_b[at:at + 4]
    pl = tfs.mma_plan(kind, layers)
    # (the wide variant above width 128 or with the weights in device memory)
    assert (fold, bf, des, flags) == (0, 1, tfs.mma_des(layers, pl.flags), pl.flags)
    assert des == _cuda.DES_MMA | (_cuda.DES_WIDE if max(layers[1:-1]) > 128 else 0)
    assert args_b[3 if kind == "fused_linear_residual" else 2] is None    # no transposes
    assert args_b[at - 2] == pl.T
    _, bf, des, _ = args_f[at:at + 4]
    # (fp32 nets wider than 128 may read their weights from device memory)
    fp32 = _cuda.PLANNED_DESIGNS if max(layers[1:-1]) <= 128 else _cuda.FP32_DESIGNS
    assert bf == 0 and des in fp32 and des == tfs.plan(kind, layers).design


@pytest.mark.parametrize("net", ["u64", "u50", "u64_d5"])
def test_jet_pair_bf16_routes_to_the_tensor_core_design(monkeypatch, net):
    """Rows 4 bf16 and 5 bf16 (the jet forward's 'rows:default', the jet
    backward's bf16-dot mode) launch the tensor-core design on their mma
    plans (tile, flags and, for the forward, the register budget passed
    through; no transposes, no fold); their fp32 modes a planned design."""
    layers = NETS[net]
    rec = _Recorder(monkeypatch)
    params, X, _ = _inputs(layers)
    ct = torch.zeros((X.shape[0], layers[0] + 2))
    tfc.fwdlap_forward(params, X, "sin", "rows:default")
    tfc.fwdlap_forward(params, X, "sin", "rows")
    tfc.fwdlap_backward(params, X, ct, "sin", "bfloat16")
    tfc.fwdlap_backward(params, X, ct, "sin")
    names = [c[0] for c in rec.calls]
    assert names == ["fwdlap_forward.bf16", "fwdlap_forward", "fwdlap_backward.bf16",
                     "fwdlap_backward"]
    fpl = tfs.mma_plan("fwdlap_forward", layers)
    bpl = tfs.mma_plan("fwdlap_backward", layers)
    # fwdlap_forward_f32(streams, X, params, layers, n, act, N, T, G, fold, bf16, des,
    # minb, flags, ...)
    assert rec.calls[0][2][9:14] == (0, 1, _cuda.DES_MMA, fpl.blocks, fpl.flags)
    assert rec.calls[0][2][7] == fpl.T and fpl.blocks in (2, 3)
    assert rec.calls[1][2][10] == 0 and rec.calls[1][2][11] in _cuda.PLANNED_DESIGNS
    # fwdlap_backward_f32(X, ct, params, wt, layers, n, act, N, T, G, fold, bf16, des,
    # flags, ...)
    assert rec.calls[2][2][10:14] == (0, 1, _cuda.DES_MMA, bpl.flags)
    assert rec.calls[2][2][8] == bpl.T and rec.calls[2][2][3] is None
    assert rec.calls[3][2][11] == 0 and rec.calls[3][2][12] in _cuda.PLANNED_DESIGNS


@pytest.mark.parametrize("kind", KINDS)
def test_fused_launch_refuses_design_0_and_crossed_designs(monkeypatch, kind):
    """Design 0 has no fused kernels any more (its plan is refused, and a
    plan made by hand with design 0 is not launched); the bf16-dot mode
    takes only the tensor-core design and fp32 only a planned one."""
    layers = NETS["u64"]
    _Recorder(monkeypatch)
    params, X, coef = _inputs(layers)
    c = coef if kind == "fused_linear_residual" else None
    an = tfs._analytic_args(tfs.PoissonSinCoef(2.0, (1, 1)), 2)
    with pytest.raises(ValueError, match="design 0 is not a planned design"):
        tfs.plan(kind, layers, 0)
    design0 = tfs.plan(kind, layers)._replace(design=0)
    for bf16, pl in ((True, design0), (False, design0),
                     (True, tfs.plan(kind, layers)), (False, tfs.mma_plan(kind, layers))):
        with pytest.raises(ValueError, match="tensor-core design and only it"):
            tfs._launch(kind, params, X, c, "sin", an, bf16=bf16, pl=pl)


def test_jet_pair_refuses_crossed_designs(monkeypatch):
    """The jet pair's bf16-dot modes take only the tensor-core design and
    their fp32 modes, the stream-major forward's included, only a planned
    one; design 0 (the retired constant tile) gets no plan in either
    direction, and a plan made by hand with it is not launched."""
    layers = NETS["u64"]
    rec = _Recorder(monkeypatch)
    params, X, _ = _inputs(layers)
    ct = torch.zeros((X.shape[0], layers[0] + 2))
    with pytest.raises(ValueError, match="design 0 is not a planned design"):
        tfc.forward_plan(layers, 0)
    design0 = tfc.forward_plan(layers)._replace(design=0)
    crossed = ((True, tfc.forward_plan(layers)), (False, tfs.mma_plan("fwdlap_forward", layers)),
               (True, design0), (False, design0))
    for bf16, pl in crossed:
        with pytest.raises(ValueError, match="tensor-core design and only it"):
            tfc.fwdlap_forward(params, X, "sin", "rows:default" if bf16 else "rows", pl=pl)
    for pl in (tfs.mma_plan("fwdlap_forward", layers), design0):
        with pytest.raises(ValueError, match="tensor-core design and only it"):
            tfc.fwdlap_forward(params, X, "sin", "streams", pl=pl)
    for dot, pl in (("bfloat16", tfc.backward_plan(layers)),
                    ("float32", tfs.mma_plan("fwdlap_backward", layers))):
        with pytest.raises(ValueError, match="tensor-core design and only it"):
            tfc.fwdlap_backward(params, X, ct, "sin", dot, pl=pl)
    with pytest.raises(ValueError, match="design 0 is not a planned design"):
        tfc.backward_plan(layers, 0)
    assert rec.calls == []


# ------------------------------------------ the jet pair's layouts and plans
@pytest.mark.parametrize("kind", JET_KINDS)
@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_jet_mma_layout_mirror_is_the_written_out_layout(net, kind):
    """The jet pair's layouts (``mma::layout`` of KIND_BWD and KIND_FWD) in
    Python are the written-out ones: the backward without the projection
    and the loss sums, the forward with two stages and no reverse regions;
    the forward keeps no gradient row whatever its flags say."""
    layers = EXTREMES[net]
    for T in (8, 16, 32, 48):
        for flags in FLAGS:
            assert tfs.mma_smem_bytes(layers, T, flags, kind) == _written_out_bytes(
                layers, T, flags, kind)
    fwd = tfs.mma_smem_bytes(layers, 16, _plan.RES_GRAD, "fwdlap_forward")
    assert fwd == tfs.mma_smem_bytes(layers, 16, 0, "fwdlap_forward")


@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_jet_mma_scratch_floats(net):
    """The jet backward saves what the fused kernels save; the jet forward
    saves nothing."""
    layers = EXTREMES[net]
    for T in (8, 16, 32):
        assert tfs.mma_scratch_floats(layers, T, "fwdlap_backward") == tfs.mma_scratch_floats(
            layers, T)
        assert tfs.mma_scratch_floats(layers, T, "fwdlap_forward") == 0


def _fits_jet(pl, layers, kind):
    """What fwdlap_backward.cu / fwdlap_forward.cu check before a
    tensor-core launch; the forward's register budget is 2 or 3 blocks."""
    return (_fits(pl) and pl.smem >= tfs.mma_smem_bytes(layers, pl.T, pl.flags, kind)
            and (pl.blocks in (2, 3) if kind == "fwdlap_forward" else pl.blocks == 0))


@pytest.mark.parametrize("kind", JET_KINDS)
@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_jet_mma_plan_takes_every_shape_the_wrapper_takes(net, kind):
    """Every net the jet pair's wrappers take gets a tensor-core plan the
    kernel takes (the deep d = 16 net included; the backward's equal to
    backward_plan's in DES_MMA); a pinned tier at 16 points fits or raises
    naming the net."""
    layers = EXTREMES[net]
    params = [(torch.zeros(a, b), torch.zeros(b)) for a, b in zip(layers[:-1], layers[1:])]
    assert _cuda.net_layers(kind, params, torch.zeros(8, layers[0]), "sin") == list(layers)
    pl = tfs.mma_plan(kind, layers)
    assert _fits_jet(pl, layers, kind)
    if kind == "fwdlap_backward":
        assert tfc.backward_plan(layers, _cuda.DES_MMA) == pl
    tiers = tfs.MMA_FWD_TIERS if kind == "fwdlap_forward" else tfs.MMA_TIERS
    for tier, flags in tiers:
        try:
            pinned = tfs.mma_plan(kind, layers, T=16, tier=tier)
        except ValueError as err:
            assert str(list(layers)) in str(err)
            continue
        assert (pinned.T, pinned.tier, pinned.flags) == (16, tier, flags)
        assert _fits_jet(pinned, layers, kind)


@pytest.mark.parametrize("kind,net,want", [
    # (T, tier, blocks per SM by shared memory, the forward's register budget)
    ("fwdlap_backward", "u64", (16, "resident", 2, 0)),
    ("fwdlap_backward", "u50", (16, "resident", 2, 0)),
    # without the loss regions the gradient row fits beside 7 streams
    ("fwdlap_backward", "u64_d5", (16, "gradient", 2, 0)),
    ("fwdlap_backward", "d16_w128_16layers", (8, "staged", 1, 0)),
    ("fwdlap_forward", "u64", (16, "weights", 3, 3)),
    ("fwdlap_forward", "u50", (16, "weights", 3, 3)),
    ("fwdlap_forward", "u64_d5", (16, "weights", 3, 3)),
    ("fwdlap_forward", "d16_w128_16layers", (16, "staged", 1, 2)),
    ("fwdlap_backward", "w200_d2", (16, "device", 2, 0)),
    ("fwdlap_backward", "d16_w256_16layers", (8, "device-sums", 1, 0)),
    ("fwdlap_forward", "w200_d2", (16, "device", 3, 3)),
    ("fwdlap_forward", "w256_d5", (16, "device", 1, 2)),
    ("fwdlap_forward", "d16_w256_16layers", (8, "device", 1, 2)),
])
def test_jet_mma_plan_path_shapes(kind, net, want):
    """The jet pair's plans on the hybrid-kernel route's nets (u64 at d = 2
    and 5; u50) and on the deep net: the backward as the fused kernels
    plan, the forward at three blocks per SM where its two stages and the
    resident weights fit a third of an SM."""
    pl = tfs.mma_plan(kind, EXTREMES[net])
    share = 3 if 3 * (pl.smem + 1024) <= _plan.SM_SMEM else 2 if _two_blocks(pl) else 1
    assert (pl.T, pl.tier, share, pl.blocks) == want


@pytest.mark.parametrize("kind", JET_KINDS)
def test_jet_mma_plan_pins_and_refusals(kind):
    """Pins on the jet pair's plans: tile, tier, blocks per SM (the forward
    also three); the forward has no gradient tier; more blocks than a
    kind's register budget raise."""
    u64 = NETS["u64"]
    pl = tfs.mma_plan(kind, u64, T=32, tier="staged", blocks=2)
    assert (pl.T, pl.tier, pl.flags) == (32, "staged", 0) and _two_blocks(pl)
    one = tfs.mma_plan(kind, u64, T=8, tier="staged", blocks=1)
    assert one.T == 8 and _fits(one)
    with pytest.raises(ValueError, match="multiple of 16"):
        tfs.mma_plan(kind, u64, T=24)
    if kind == "fwdlap_forward":
        three = tfs.mma_plan(kind, u64, T=16, tier="weights", blocks=3)
        assert three.blocks == 3 and 3 * (three.smem + 1024) <= _plan.SM_SMEM
        assert tfs.mma_plan(kind, u64, blocks=2).blocks == 2
        with pytest.raises(ValueError, match="do not fit"):
            tfs.mma_plan(kind, u64, tier="resident")
        with pytest.raises(ValueError, match="register budget"):
            tfs.mma_plan(kind, u64, blocks=4)
    else:
        with pytest.raises(ValueError, match="register budget"):
            tfs.mma_plan(kind, u64, blocks=3)


# ------------------------------------------------------------ CPU route
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_bf16_route_runs_the_plain_bf16_version(monkeypatch, kind):
    """On the CPU the bf16-dot mode of rows 1 and 2 routes to the plain
    bf16-dot version without building or loading the kernels, and gives
    exactly its loss and scaled gradients."""
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_build, "load", no_build)
    layers = (2, 12, 12, 1)
    params, X, coef = _inputs(layers, N=33)
    N = X.shape[0]
    if kind == "fused_linear_residual":
        loss, _, grads = tfs.fused_linear_residual(params, X, coef, "sin", dot_dtype="bfloat16")
        dWs, dbs, sums = tfs.linear_residual_plain(params, X, coef, "sin", "bfloat16")
    else:
        loss, _, grads = tfs.fused_poisson_analytic(params, X, "sin", L=2.0, ks=(1, 1),
                                                    dot_dtype="bfloat16")
        dWs, dbs, sums = tfs.poisson_analytic_plain(params, X, "sin",
                                                    tfs.PoissonSinCoef(2.0, (1, 1)),
                                                    "bfloat16")
    want = tfs._scaled_grads(params, dWs, dbs, sums, 2.0 / N)
    assert torch.equal(loss, sums[0] / N)
    for (gw, gb), (ww, wb) in zip(grads, want):
        assert torch.equal(gw, ww) and torch.equal(gb, wb)
    # and the bf16-dot mode is not the fp32 one
    loss32, _, _ = tfs.fused_linear_residual(params, X, coef, "sin") \
        if kind == "fused_linear_residual" else tfs.fused_poisson_analytic(
            params, X, "sin", L=2.0, ks=(1, 1))
    assert not torch.equal(loss, loss32)


@pytest.mark.parametrize("layers", [(1, 129, 1), (2, 200, 200, 1), (1, 64, 256, 1)])
@pytest.mark.parametrize("kind", tfs.MMA_KINDS)
def test_mma_plans_refuse_widths_above_128(kind, layers):
    """The tensor-core design takes hidden widths above 128 since the
    device tiers: these nets get its plan.  Rows 1-5 (``_cuda.BEYOND_BF16``)
    go on at width 257, 17 weight matrices and d = 17 where a tile of 8
    points fits (the fused kinds in their ``DES_BEYOND`` variant where the
    net needs it; elsewhere ``NoFit`` naming B7; the jet forward refuses d
    = 17, naming the JAX kernel's own limit) and raise at width
    4097, naming the kernel, its limit and the roadmap item of the wider
    nets; rows 7-12 keep ``_cuda.CORE_LIMITS`` and raise so at width 257,
    17 weight matrices and d = 17."""
    kw = {"n_bumps": 42} if kind.startswith("multi") else {}    # the K-bump pair's cap
    pl = tfs.mma_plan(kind, layers, **kw)
    assert pl.design == _cuda.DES_MMA and pl.smem <= _cuda.SMEM_MAX
    wider = tuple(257 if w == max(layers[1:-1]) else w for w in layers[:-1]) + (1,)
    deeper = (layers[0],) + (32,) * 16 + (1,)
    higher = (17,) + layers[1:]
    if kind + ".bf16" in _cuda.BEYOND_BF16:
        fwd = kind == "fwdlap_forward"
        for net in (wider, deeper) + (() if fwd else (higher,)):
            smallest = min(tfs.mma_smem_bytes(net, 8, flags, kind) for _, flags in tfs.MMA_TIERS)
            if smallest > _cuda.SMEM_MAX:
                # (17, 64, 256, 1): three stages of 20 streams at 8 points
                # and width 256 are 247 KB
                with pytest.raises(_plan.NoFit, match=r"no tile of 8 points fits \(stages in "
                                                      r"device memory: ROADMAP.md B7\)"):
                    tfs.mma_plan(kind, net)
                continue
            pl = tfs.mma_plan(kind, net)
            assert pl.design & _cuda.DES_MMA and pl.smem <= _cuda.SMEM_MAX, net
            assert bool(pl.design & _cuda.DES_BEYOND) == (
                kind.startswith("fused") and _cuda.beyond(net)), net
        if fwd:
            with pytest.raises(ValueError, match=r"\.bf16: the kernel takes d from 1 to 16 "
                                                 r"\(the JAX package's _forward_kernel2, .* "
                                                 r"takes d <= 6\)"):
                tfs.mma_plan(kind, higher)
        widest = tuple(4097 if w == max(layers[1:-1]) else w for w in layers[:-1]) + (1,)
        with pytest.raises(ValueError, match=r"\.bf16: the kernel takes hidden widths from 1 "
                                             r"to 4096 \(wider nets: ROADMAP.md B7\)"):
            tfs.mma_plan(kind, widest)
    else:
        with pytest.raises(ValueError, match=r"\.bf16: the kernel takes hidden widths from 1 "
                                             r"to 256 \(wider nets: ROADMAP.md B7\)"):
            tfs.mma_plan(kind, wider, **kw)
        with pytest.raises(ValueError, match=r"\.bf16: the kernel takes 2 to 16 weight "
                                             r"matrices and one output \(deeper nets: "
                                             r"ROADMAP.md B7\)"):
            tfs.mma_plan(kind, deeper, **kw)
        with pytest.raises(ValueError, match=r"\.bf16: the kernel takes d from 1 to 16 "
                                             r"\(larger d: ROADMAP.md B7\)"):
            tfs.mma_plan(kind, higher, **kw)
    assert tfs.mma_plan(kind, (1, 128, 128, 1), **kw).design == _cuda.DES_MMA


# ------------------------------------------------ the K-bump pair's plans
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("d,hidden,Kb", [(2, 4, 16), (1, 1, 1), (16, 2, 42)])
def test_multibump_plan_takes_every_width(seeded, d, hidden, Kb):
    """Every hidden width 1-256 (``hidden`` layers of it; the 2D well's four
    at its 16 bumps, one layer, and d = 16 at the most bumps) gets a plan of
    the K-bump pair that fits the card's shared memory, its bytes the
    kernel's layout; the tiers that read the weights from device memory
    (``DES_DEVW``) only where no tier with the weights on chip fits even at
    4 points at one block per SM, and at width 256 wherever the net has
    hidden-to-hidden weights (one 256 x 256 staging matrix is 256 KB).  A
    width of 257 goes on (the fp32 pair takes widths to 4096, pass B in its
    ``DES_BEYOND`` design there); 4097 raises, naming the roadmap item of
    the wider nets."""
    devw_from = None
    for w in range(1, 257):
        layers = (d,) + (w,) * hidden + (1,)
        pl = tfm.plan(seeded, layers, Kb)
        assert pl.smem <= _cuda.SMEM_MAX, layers
        assert pl.smem == 4 * tfm.smem_floats(seeded, layers, pl.T, Kb, pl.flags), layers
        assert 4 <= pl.T <= _plan.T_MAX and pl.T % 4 == 0, layers
        devw = bool(pl.flags & _plan.DEV_WEIGHTS)
        assert devw == (pl.design == _cuda.DES_DEVW), layers
        assert not (devw and pl.flags & _plan.RES_WEIGHTS), layers
        on_chip = min(4 * tfm.smem_floats(seeded, layers, 4, Kb, flags)
                      for _, flags in _plan.tiers(seeded)) <= _cuda.SMEM_MAX
        assert devw == (not on_chip), layers
        if devw and devw_from is None:
            devw_from = w
    # one hidden layer has no hidden-to-hidden weights: its resident tier
    # holds none
    assert devw_from is None if hidden == 1 else devw_from <= 256
    pl = tfm.plan(seeded, (d, 257) + (1,), Kb)
    assert pl.smem <= _cuda.SMEM_MAX and pl.design & _cuda.DES_BEYOND == (
        _cuda.DES_BEYOND if seeded else 0)
    with pytest.raises(ValueError, match=r"hidden widths from 1 to 4096 \(wider nets: "
                                         r"ROADMAP.md B7\)"):
        tfm.plan(seeded, (d, 4097) + (1,), Kb)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("net,devw", [("w200_d2", False), ("w256_d2", True)])
def test_multibump_device_tier_routes(monkeypatch, seeded, net, devw):
    """The K-bump pair's launches on the wide nets: u256 takes the
    device-weights tier (flags DEV_WEIGHTS, no fold, the hidden weights
    padded to multiples of 4 in the resident layout, pass B with their
    transposes after them, as ``wd``), u200 a tier on chip (no ``wd``)."""
    layers = EXTREMES[net]
    rec = _Recorder(monkeypatch)
    params, X, _ = _inputs(layers)
    Kb = 4
    coef = torch.zeros((X.shape[0], Kb * (layers[0] + 4)))
    scal = torch.zeros(3 * Kb)
    tfm._launch(seeded, params, X, coef, scal if seeded else None, "sin", Kb)
    ((name, fn, args),) = rec.calls
    assert (name, fn) == ("multi_seeded" if seeded else "multi_sums", "fused_multibump_f32")
    pl = tfm.plan(seeded, layers, Kb)
    # (seeded, n_bumps, X, coef, params, scal, layers, n_layers, act, N, T, G,
    # flags, fold, partial, scratch, out, smem_bytes, stream, wd)
    assert args[10] == pl.T and args[12] == pl.flags and args[17] == pl.smem
    assert bool(pl.flags & _plan.DEV_WEIGHTS) == devw
    if devw:
        assert args[13] == 0 and args[19] is not None
        want = _cuda.device_weights(params, seeded)
        assert want.numel() == _plan.hidden_floats(layers) * (2 if seeded else 1)
    else:
        assert args[19] is None


# ------------------------------------- row 3 and rows 7-10 in bf16-dot mode
# (kind, lap): the Deep-Ritz energy and the quadratic quotients never carry
# the Laplacian stream (S = d + 1), the linear quotients with it (rows 7-8
# on a residual functional) and without it (the WAN weak forms, no_lap)
NEW_KINDS = (("fused_drm_energy", 0), ("linear_sums", 1), ("linear_sums", 0),
             ("linear_seeded", 1), ("linear_seeded", 0), ("quad_sums", 0), ("quad_seeded", 0))
PASS_A = ("linear_sums", "quad_sums")


@pytest.mark.parametrize("kind,lap", NEW_KINDS)
@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_new_kind_layout_mirror_is_the_written_out_layout(net, kind, lap):
    """The layouts of the Deep-Ritz energy (KIND_FUSED without the
    Laplacian stream), the seeded pass B (KIND_FUSED) and pass A
    (KIND_SUMS: two stages, four doubles a point, no reverse regions) are
    the written-out ones; pass A keeps no gradient row whatever its flags
    say."""
    layers = EXTREMES[net]
    for T in (8, 16, 32, 48):
        for flags in FLAGS:
            assert tfs.mma_smem_bytes(layers, T, flags, kind, lap) == _written_out_bytes(
                layers, T, flags, kind, lap)
    if kind in PASS_A:
        assert tfs.mma_smem_bytes(layers, 16, _plan.RES_GRAD, kind, lap) == tfs.mma_smem_bytes(
            layers, 16, 0, kind, lap)


@pytest.mark.parametrize("kind,lap", NEW_KINDS)
@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_new_kind_scratch_floats(net, kind, lap):
    """The Deep-Ritz energy and pass B save what the fused kernels save,
    over their own stream count; pass A saves nothing."""
    layers = EXTREMES[net]
    d, hidden = layers[0], layers[1:-1]
    for T in (8, 16, 32):
        S = d + 1 + lap
        tiles = (S + S % 2) // 2 if T == 8 else S
        blocks = (1 if T == 8 else T // 16) * _up(max(hidden), 8) // 8
        saved = 0 if kind in PASS_A else len(hidden) * blocks * (tiles + 1) * 128
        assert tfs.mma_scratch_floats(layers, T, kind, 0, lap) == saved


@pytest.mark.parametrize("kind,lap", NEW_KINDS)
def test_new_kind_plans_take_every_width_and_dimension(kind, lap):
    """Every hidden width 1-256 at every d 1-16 (four hidden layers, and
    one) gets a tensor-core plan that fits the card's shared memory, its
    bytes the layout's, stage rows a multiple of 16 (T = 8 pads an odd
    stream count: S = d + 1 is odd at d = 2 and 4); pass A takes the
    forward tiers only."""
    tiers = dict(tfs.MMA_FWD_TIERS if kind in PASS_A else tfs.MMA_TIERS)
    for d in range(1, 17):
        for w in range(1, 257):
            for layers in ((d, w, w, w, w, 1), (d, w, 1)):
                pl = tfs.mma_plan(kind, layers, lap=lap)
                assert _fits(pl) and pl.blocks == 0, layers
                assert pl.smem == tfs.mma_smem_bytes(layers, pl.T, pl.flags, kind, lap), layers
                assert tiers[pl.tier] == pl.flags, layers
                g = tfs.mma_geometry(layers, pl.T, lap)
                assert g.S == d + 1 + lap and g.ST % 16 == 0 and g.Sp - g.S in (0, 1), layers


@pytest.mark.parametrize("kind,lap,net,want", [
    # (T, tier, blocks per SM by shared memory)
    ("fused_drm_energy", 0, "u64", (16, "resident", 2)),
    ("linear_sums", 0, "c64", (16, "weights", 2)),
    ("linear_sums", 1, "u64", (16, "weights", 2)),
    ("linear_seeded", 0, "c64", (16, "resident", 2)),
    ("linear_seeded", 0, "u64", (16, "resident", 2)),
    ("quad_sums", 0, "u50", (16, "weights", 2)),
    ("quad_seeded", 0, "u50", (16, "resident", 2)),
    ("quad_seeded", 0, "c64", (16, "resident", 2)),
    ("fused_drm_energy", 0, "w200_d2", (16, "device", 2)),
    ("linear_seeded", 1, "d16_w256_16layers", (8, "device-sums", 1)),
    ("quad_sums", 0, "d16_w256_16layers", (8, "device", 1)),
])
def test_new_kind_plan_path_shapes(kind, lap, net, want):
    """The plans on the paths' nets (u64 the Poisson DRM, c64 / u64 the
    Poisson WAN, u50 the 2D well's Rayleigh DRM) and on the widest: 16-point
    tiles at two blocks per SM, the device tiers where nothing else fits."""
    pl = tfs.mma_plan(kind, EXTREMES[net], lap=lap)
    assert (pl.T, pl.tier, 2 if _two_blocks(pl) else 1) == want


def test_mma_lap_of_each_kind():
    """The stream count is the kind's: fixed for all but the linear
    quotients, which take ``lap``; a lap a kind cannot take raises."""
    assert [tfs.mma_lap(k) for k in tfs.MMA_KINDS] == [1, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0]
    assert tfs.mma_lap("linear_sums", 0) == 0 and tfs.mma_lap("linear_seeded", False) == 0
    with pytest.raises(ValueError, match="never carried"):
        tfs.mma_plan("quad_sums", NETS["u64"], lap=1)
    with pytest.raises(ValueError, match="always carried"):
        tfs.mma_smem_bytes(NETS["u64"], 16, 0, "fwdlap_backward", 0)


@pytest.mark.parametrize("net", ["u64", "u50", "width1", "w200_d2", "d16_w256_16layers"])
def test_bf16_drm_routes_to_the_tensor_core_design(monkeypatch, net):
    """Row 3's bf16-dot mode launches DES_MMA on its mma plan (no
    transposes), counted as ``fused_drm_energy.bf16``; fp32 and ``bf16x3``
    launch the planned design under the plain name."""
    layers = EXTREMES[net]
    rec = _Recorder(monkeypatch)
    params, X, _ = _inputs(layers)
    coef = torch.zeros((X.shape[0], layers[0] + 2))
    tfs._launch("fused_drm_energy", params, X, coef, "sin", None, bf16=True)
    tfs._launch("fused_drm_energy", params, X, coef, "sin", None)
    (name_b, fn_b, args_b), (name_f, fn_f, args_f) = rec.calls
    assert (name_b, fn_b) == ("fused_drm_energy.bf16", "fused_drm_energy_f32")
    assert (name_f, fn_f) == ("fused_drm_energy", "fused_drm_energy_f32")
    pl = tfs.mma_plan("fused_drm_energy", layers)
    # (X, coef, params, wt, layers, n, act, N, T, G, fold, bf16, des, flags, ...)
    assert args_b[10:14] == (0, 1, tfs.mma_des(layers, pl.flags), pl.flags)
    assert args_b[8] == pl.T and args_b[3] is None
    assert args_f[11] == 0 and args_f[12] == tfs.plan("fused_drm_energy", layers).design


@pytest.mark.parametrize("net", ["c64", "u64", "u50", "width1", "w200_d2",
                                 "d16_w256_16layers"])
@pytest.mark.parametrize("kind,lap", NEW_KINDS[1:])
def test_bf16_quotients_route_to_the_tensor_core_design(monkeypatch, kind, lap, net):
    """Rows 7-10's bf16-dot modes launch ``fused_quotient_mma_f32`` on the
    kind's mma plan, counted as ``<kernel>.bf16``, with the Laplacian flag,
    tile, flags and narrow or wide variant passed through and scratch for
    pass B alone; fp32 launches ``fused_quotient_f32`` under the plain
    name."""
    from nnpde_tpu_torch.kernels import fused_quotient as tfq

    layers = EXTREMES[net]
    rec = _Recorder(monkeypatch)
    params, X, _ = _inputs(layers)
    d = layers[0]
    coef = torch.zeros((X.shape[0], d + (5 if kind.startswith("linear") else 3)))
    scal = torch.zeros(3)
    seeded = kind.endswith("seeded")
    tfq._launch(kind, params, X, coef, scal if seeded else None, "sin", lap, bf16=True)
    tfq._launch(kind, params, X, coef, scal if seeded else None, "sin", lap)
    (name_b, fn_b, args_b), (name_f, fn_f, args_f) = rec.calls
    assert (name_b, fn_b, name_f, fn_f) == (kind + ".bf16", "fused_quotient_mma_f32", kind,
                                            "fused_quotient_f32")
    pl = tfs.mma_plan(kind, layers, lap=lap)
    # (kind, lap, X, coef, params, scal, layers, n, act, N, T, G, flags, des,
    # partial, scratch, out, smem_bytes, stream)
    assert args_b[:2] == (tfq._KINDS[kind], lap)
    assert (args_b[10], args_b[12], args_b[13], args_b[17]) == (
        pl.T, pl.flags, tfs.mma_des(layers, pl.flags), pl.smem)
    assert (args_b[15] is not None) == seeded and (args_b[5] is not None) == seeded
    assert args_f[1] == lap and args_f[14] in (0, _cuda.DES_DEVW) + _cuda.PLANNED_DESIGNS + (
        _cuda.DES_PLANNED | _cuda.DES_DEVW,)


def test_bf16_quotient_launch_refuses_other_designs(monkeypatch):
    """The bf16-dot mode of the quotients takes only the tensor-core
    design: a planned plan handed to it is not launched."""
    from nnpde_tpu_torch.kernels import fused_quotient as tfq

    layers = NETS["c64"]
    rec = _Recorder(monkeypatch)
    params, X, _ = _inputs(layers)
    coef = torch.zeros((X.shape[0], 7))
    pl = tfq.plan("linear_sums", layers, 0, N=X.shape[0])
    with pytest.raises(ValueError, match="tensor-core design and only it"):
        tfq._launch("linear_sums", params, X, coef, None, "sin", 0, pl=pl, bf16=True)
    assert rec.calls == []


def test_cpu_bf16_row3_and_quotients_run_their_plain_versions(monkeypatch):
    """On the CPU the bf16-dot modes of rows 3 and 7-10 route to their plain
    bf16-dot versions without building or loading the kernels, and give
    exactly their results; ``bf16x3`` gives the float32 results."""
    from nnpde_tpu_torch.kernels import fused_quotient as tfq

    def no_build():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_build, "load", no_build)
    layers = (2, 12, 12, 1)
    params, X, _ = _inputs(layers, N=33)
    rng = np.random.default_rng(5)
    c4 = torch.as_tensor(rng.normal(size=(33, 4)).astype(np.float32))
    c7 = torch.as_tensor(rng.normal(size=(33, 7)).astype(np.float32))
    c5 = torch.as_tensor(rng.normal(size=(33, 5)).astype(np.float32))
    scal = torch.tensor([0.3, -0.2, 0.1])
    loss, _, grads = tfs.fused_drm_energy(params, X, c4, "sin", dot_dtype="bfloat16")
    dWs, dbs, sums = tfs.drm_energy_plain(params, X, c4, "sin", "bfloat16")
    assert torch.equal(loss, sums[0] / 33)
    want = tfs._scaled_grads(params, dWs, dbs, sums, 1.0 / 33)
    assert all(torch.equal(a, b) for g, w in zip(grads, want) for a, b in zip(g, w))
    s = tfq.fused_linear_sums(params, X, c7, "sin", no_lap=True, dot_dtype="bfloat16")
    assert torch.equal(s["sum_r2"], tfq.linear_sums_plain(params, X, c7, "sin", True,
                                                          "bfloat16")[1])
    g = tfq.fused_quad_seeded_grads(params, X, c5, scal[:2], "sin", dot_dtype="bfloat16")
    dWs, _, sums = tfq.quad_seeded_plain(params, X, c5, scal[:2], "sin", "bfloat16")
    assert torch.equal(g[0][0], dWs[0]) and torch.equal(g[-1][1], sums[0].reshape(1))
    for dot in ("bf16x3", "float32"):
        l3, _, g3 = tfs.fused_drm_energy(params, X, c4, "sin", dot_dtype=dot)
        if dot == "bf16x3":
            first = (l3, g3)
        else:
            assert torch.equal(first[0], l3) and torch.equal(first[1][0][0], g3[0][0])
    assert not torch.equal(loss, l3)


# --------------------------------- rows 11-12 (the K-bump pair) in bf16-dot mode
MB_KINDS = ("multi_sums", "multi_seeded")
BUMPS = (1, 16, 42)


@pytest.mark.parametrize("Kb", BUMPS)
@pytest.mark.parametrize("kind", MB_KINDS)
@pytest.mark.parametrize("net", sorted(EXTREMES))
def test_k_bump_layout_mirror_is_the_written_out_layout(net, kind, Kb):
    """The K-bump pass A's layout is pass A's with 3K double lanes a point
    (four at K = 1, the quotients' room); pass B's is the seeded quotient's
    without the Laplacian stream, whatever the bump count."""
    layers = EXTREMES[net]
    for T in (8, 16, 32):
        for flags in FLAGS:
            if kind == "multi_sums" and flags & (_plan.RES_GRAD | _plan.DEV_SUMS):
                continue
            assert tfs.mma_smem_bytes(layers, T, flags, kind, n_bumps=Kb) == _written_out_bytes(
                layers, T, flags, kind, 0, Kb)
    if kind == "multi_seeded":
        assert tfs.mma_smem_bytes(layers, 16, 0, kind, n_bumps=Kb) == tfs.mma_smem_bytes(
            layers, 16, 0, "linear_seeded", 0)


@pytest.mark.parametrize("layers", [EXTREMES["u50"], EXTREMES["c20"], EXTREMES["w256_d5"]])
def test_mma_smem_bytes_counts_each_kinds_lanes(layers):
    """Pass A's doubles: 3K lanes a point in the K-bump pass A (so its bytes
    grow by 2 (3K - 4) T floats over the linear quotient's pass A at K > 1),
    four in the linear and quadratic quotients' whatever ``n_bumps`` says;
    the K-bump pass A without a bump count raises."""
    T = 16
    base = tfs.mma_smem_bytes(layers, T, 0, "linear_sums", 0)
    assert tfs.mma_smem_bytes(layers, T, 0, "linear_sums", 0, n_bumps=42) == base
    assert tfs.mma_smem_bytes(layers, T, 0, "quad_sums", n_bumps=42) == tfs.mma_smem_bytes(
        layers, T, 0, "quad_sums")
    for Kb in BUMPS:
        grow = 4 * 2 * (max(3 * Kb, 4) - 4) * T
        assert tfs.mma_smem_bytes(layers, T, 0, "multi_sums", n_bumps=Kb) == base + grow
    assert [tfs.mma_sum_lanes("multi_sums", k) for k in BUMPS] == [4, 48, 126]
    with pytest.raises(ValueError, match="bump count"):
        tfs.mma_smem_bytes(layers, T, 0, "multi_sums")


@pytest.mark.parametrize("Kb", BUMPS)
@pytest.mark.parametrize("kind", MB_KINDS)
def test_k_bump_plans_take_every_width_and_dimension(kind, Kb):
    """Every hidden width 1-256 at every d 1-16 (four hidden layers, and
    one) at 1, 16 and 42 bumps gets a tensor-core plan of the K-bump pair
    that fits the card's shared memory (the lanes alone are 16 KB at K = 42
    and T = 16), its bytes the layout's; pass A takes the forward tiers
    only; no stream for the Laplacian (S = d + 1)."""
    tiers = dict(tfs.MMA_FWD_TIERS if kind == "multi_sums" else tfs.MMA_TIERS)
    for d in range(1, 17):
        for w in range(1, 257):
            for layers in ((d, w, w, w, w, 1), (d, w, 1)):
                pl = tfs.mma_plan(kind, layers, n_bumps=Kb)
                assert _fits(pl) and pl.blocks == 0, layers
                assert pl.smem == tfs.mma_smem_bytes(layers, pl.T, pl.flags, kind,
                                                     n_bumps=Kb), layers
                assert tiers[pl.tier] == pl.flags, layers
                assert tfs.mma_geometry(layers, pl.T, 0).S == d + 1, layers


@pytest.mark.parametrize("kind,Kb,net,want", [
    # (T, tier, blocks per SM by shared memory): the 2D well's critic and
    # primal at its 16 bumps and at the cap, the wide primal, d = 16
    ("multi_sums", 16, "c20", (16, "weights", 2)),
    ("multi_sums", 42, "u50", (16, "weights", 2)),
    ("multi_seeded", 16, "c20", (16, "resident", 2)),
    ("multi_seeded", 16, "u50", (16, "resident", 2)),
    ("multi_sums", 16, "w200_d2", (16, "device", 2)),
    ("multi_seeded", 16, "w200_d2", (16, "device", 2)),
    ("multi_sums", 42, "d16_w256_16layers", (8, "device", 1)),
    ("multi_seeded", 42, "d16_w256_16layers", (8, "device-sums", 1)),
])
def test_k_bump_plan_path_shapes(kind, Kb, net, want):
    """The K-bump pair's plans on the 2D well's nets (c20 the critic, u50
    the primal) and on the widest: 16-point tiles at two blocks per SM, the
    device tiers where nothing else fits."""
    pl = tfs.mma_plan(kind, EXTREMES[net], n_bumps=Kb)
    assert (pl.T, pl.tier, 2 if _two_blocks(pl) else 1) == want


@pytest.mark.parametrize("net", ["c20", "u50", "width1", "w200_d2", "d16_w256_16layers"])
@pytest.mark.parametrize("seeded", [False, True])
def test_bf16_k_bump_routes_to_the_tensor_core_design(monkeypatch, seeded, net):
    """Rows 11-12's bf16-dot modes launch ``fused_multibump_mma_f32`` on the
    pass's mma plan (pass A's by its bump count), counted as
    ``multi_sums.bf16`` / ``multi_seeded.bf16``, with the tile, flags, narrow
    or wide variant and shared memory passed through and scratch for pass B
    alone; fp32 and ``bf16x3`` launch ``fused_multibump_f32`` under the
    plain name; a planned plan handed to the bf16-dot mode is refused."""
    layers = EXTREMES[net]
    rec = _Recorder(monkeypatch)
    params, X, _ = _inputs(layers)
    Kb = 42
    coef = torch.zeros((X.shape[0], Kb * (layers[0] + 4)))
    scal = torch.zeros(3 * Kb)
    s = scal if seeded else None
    tfm._launch_mma(seeded, params, X, coef, s, "sin", Kb)
    tfm._launch(seeded, params, X, coef, s, "sin", Kb)
    (name_b, fn_b, args_b), (name_f, fn_f, _) = rec.calls
    kind = "multi_seeded" if seeded else "multi_sums"
    assert (name_b, fn_b, name_f, fn_f) == (kind + ".bf16", "fused_multibump_mma_f32", kind,
                                            "fused_multibump_f32")
    pl = tfs.mma_plan(kind, layers, n_bumps=Kb)
    # (seeded, n_bumps, X, coef, params, scal, layers, n, act, N, T, G, flags,
    # des, partial, scratch, out, smem_bytes, stream)
    assert args_b[:2] == (int(seeded), Kb)
    assert (args_b[10], args_b[12], args_b[13], args_b[17]) == (
        pl.T, pl.flags, tfs.mma_des(layers, pl.flags), pl.smem)
    assert (args_b[15] is not None) == seeded and (args_b[5] is not None) == seeded
    with pytest.raises(ValueError, match="tensor-core design and only it"):
        tfm._launch_mma(seeded, params, X, coef, s, "sin", Kb, pl=tfm.plan(seeded, layers, Kb))
    assert len(rec.calls) == 2


def test_cpu_bf16_k_bump_runs_its_plain_versions(monkeypatch):
    """On the CPU the bf16-dot modes of rows 11-12 route to their plain
    bf16-dot versions without building or loading the kernels, and give
    exactly their results; ``bf16x3`` gives the float32 results."""
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_build, "load", no_build)
    layers, Kb = (2, 12, 12, 1), 3
    params, X, _ = _inputs(layers, N=33)
    rng = np.random.default_rng(6)
    coef = torch.as_tensor(rng.normal(size=(33, Kb * 6)).astype(np.float32))
    scal = torch.as_tensor(rng.normal(size=3 * Kb).astype(np.float32))
    seeds = (scal[:Kb], scal[Kb:2 * Kb], scal[2 * Kb:])
    out = {}
    for dot in ("bfloat16", "bf16x3", "float32"):
        s = tfm.fused_multi_sums(params, X, coef, "sin", Kb, dot_dtype=dot)
        g = tfm.fused_multi_seeded_grads(params, X, coef, seeds, "sin", Kb, dot_dtype=dot)
        out[dot] = (torch.cat([s["sum_r"], s["sum_mass"], s["sum_e2"]]), g)
    assert torch.equal(out["bfloat16"][0],
                       tfm.fused_multi_sums_plain(params, X, coef, "sin", Kb, "bfloat16"))
    dWs, _, sums = tfm.fused_multi_seeded_grads_plain(params, X, coef, scal, "sin", Kb,
                                                      "bfloat16")
    g = out["bfloat16"][1]
    assert torch.equal(g[0][0], dWs[0]) and torch.equal(g[-1][1], sums[0].reshape(1))
    assert torch.equal(out["bf16x3"][0], out["float32"][0])
    assert torch.equal(out["bf16x3"][1][0][0], out["float32"][1][0][0])
    assert not torch.equal(out["bfloat16"][0], out["float32"][0])
