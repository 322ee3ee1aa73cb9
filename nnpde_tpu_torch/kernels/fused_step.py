"""Fused PINN / Deep-Ritz loss + parameter gradients in one pass.

Counterpart of ``nnpde_tpu/kernels/fused_step.py``.  Every strong-form
residual loss is ``w * mean(r^2)`` with ``r`` linear in the jet of the raw
network; with ``u = B * net`` the trial factor and the physics enter as
per-point coefficients:

    r_i = c_i * net_i + sum_j b_ij * dnet_ij + a_i * lap(net)_i + rhs_i

Coefficient layout per point (``nc = d + 4``): ``[c, b_0..b_{d-1}, a, rhs,
e]``; the kernel also sums ``r * e * net`` (the trainable-eigenvalue seed).
The Deep-Ritz energy ``1/2 |grad u|^2 - f u`` takes ``[B, dB_0.., f]``.

Each entry point returns ``(loss, aux, grads)`` with ``grads`` in the
params layout ``[(dW, db), ...]``; the last-bias gradient is
``scale * sum(ct_v)``.

Where it runs: a CUDA tensor goes to the hand-written kernels of
``csrc/fused_step.cu`` (the bf16-dot mode's in ``csrc/fused_step_mma.cu``;
float32 tensors, anything else raises), a CPU tensor to the
plain version beside it, which differentiates the forward-Laplacian
recurrence (:func:`~nnpde_tpu_torch.ops.fwdlap.mlp_fwdlap`) with
``torch.autograd`` in any dtype.  The plain versions take any device when
called directly; ``chip_smoke.py`` holds the kernels to them on the card.
The launch shape and kernel design come from :func:`plan` (the fp32
kernels' planned design on the shared plan of :mod:`._plan`; the bf16-dot
mode's tensor-core design on :func:`mma_plan`).

``dot_dtype='bfloat16'`` (the TPU kernels' one-pass bf16 dot mode, run by
the bulk of ``compute_dtype='hybrid-kernel'`` on the residual kernels):
every product operand of the recompute and the reverse sweep is rounded to
bf16 and the products accumulate in float32 (counted as ``<kernel>.bf16``),
on the card's bf16 tensor cores (``csrc/fwdlap_mma.cuh``, ``DES_MMA``).  Its
plain version is the TPU kernels' per-tile arithmetic written out
(:func:`~nnpde_tpu_torch.ops.fwdlap.recompute_plain`,
:func:`~nnpde_tpu_torch.ops.fwdlap.reverse_plain`) with the operands rounded
by ``.to(torch.bfloat16)``: autograd would leave the cotangents unrounded.
``dot_dtype='bf16x3'`` (the TPU kernels' three-pass split, float32-class)
runs the float32 kernels (:func:`_check_dot`).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence

import torch

from ..ops.fwdlap import (DV_ORDERS, mlp_fwdlap, project_plain, recompute_plain,
                          reverse_plain, round_bf16)
from . import _cuda, _plan
from ._cuda import variant_name

_MODES = {"fused_linear_residual": 0, "fused_poisson_analytic": 1,
          "fused_drm_energy": 2}


# ---------------------------------------------------------------- coefficients
def _full(x, shape, ref):
    """``x`` broadcast to ``shape`` in ``ref``'s dtype and device.  A Python
    number is filled in on the device: a host-to-device copy would wait for
    the device."""
    if isinstance(x, (int, float)):
        return torch.full(shape, float(x), dtype=ref.dtype, device=ref.device)
    return torch.broadcast_to(torch.as_tensor(x, dtype=ref.dtype, device=ref.device), shape)


def residual_coefficients(factor_jet, *, c0=None, b0=None, a0=1.0, rhs=None,
                          e_lane=False):
    """The (N, d+4) coefficient stream for ``r = a0 lap(u) + b0.grad(u) +
    c0 u + rhs`` acting on ``u = B * net``: ``a = a0 B``, ``b_j = 2 a0 dB_j
    + b0_j B``, ``c = a0 lapB + b0.gradB + c0 B``; ``e_lane`` puts B in e."""
    B, gB, lB = factor_jet.value, factor_jet.grad, factor_jet.lap
    N, d = gB.shape

    zero = torch.zeros((N,), dtype=B.dtype, device=B.device)
    c0v = zero if c0 is None else _full(c0, (N,), B)
    a0v = _full(a0, (N,), B)
    rhsv = zero if rhs is None else _full(rhs, (N,), B)
    b0v = (torch.zeros((N, d), dtype=B.dtype, device=B.device) if b0 is None
           else _full(b0, (N, d), B))
    a = a0v * B
    b = a0v[:, None] * 2.0 * gB + b0v * B[:, None]
    c = a0v * lB + torch.sum(b0v * gB, dim=1) + c0v * B
    e = B if e_lane else zero
    return torch.cat([c[:, None], b, a[:, None], rhsv[:, None], e[:, None]], dim=1)


def drm_coefficients(factor_jet, f=None):
    """(N, d+2) coefficients of the fused DRM energy: ``[B, dB_0.., f]``."""
    B, gB = factor_jet.value, factor_jet.grad
    N = B.shape[0]
    fv = torch.zeros((N,), dtype=B.dtype, device=B.device) if f is None else _full(f, (N,), B)
    return torch.cat([B[:, None], gB, fv[:, None]], dim=1)


class PoissonSinCoef:
    """In-kernel coefficients of the box-FBC prod-sin Poisson family
    (``_poisson_sin_coef_builder``): ``r = a0 lap(u) + rhs`` with ``u = B
    net``, ``B = prod x_i (L - x_i)`` and ``rhs = -f``, ``f = sum_i (k_i
    pi/L)^2 prod_i sin(k_i pi x_i / L)``.  Calling it on an (N, d) tile
    gives ``(c, [b_0..b_{d-1}], a, rhs)`` (the plain version); the CUDA
    kernel evaluates the same closed form from ``L``, ``ks`` and ``a0``."""

    def __init__(self, L: float, ks: Sequence[int], a0: float = -1.0):
        self.L = float(L)
        self.ks = tuple(float(k) for k in ks)
        self.a0 = float(a0)

    def __call__(self, X):
        L, a0, d = self.L, self.a0, X.shape[1]
        cols = [X[:, i] for i in range(d)]
        gi = [x * (L - x) for x in cols]

        def prod_except(i):
            p = torch.ones_like(cols[0])
            for j in range(d):
                if j != i:
                    p = p * gi[j]
            return p

        B = gi[0]
        for j in range(1, d):
            B = B * gi[j]
        dB = [(L - 2.0 * cols[i]) * prod_except(i) for i in range(d)]
        lapB = sum(-2.0 * prod_except(i) for i in range(d))
        s = None
        for i in range(d):
            si = torch.sin((self.ks[i] * math.pi / L) * cols[i])
            s = si if s is None else s * si
        f = sum((k * math.pi / L) ** 2 for k in self.ks) * s
        return a0 * lapB, [2.0 * a0 * dBi for dBi in dB], a0 * B, -f


def _residual_swept(params, X, coef, activation, cast, order=None):
    """The linear-residual kernel's arithmetic in a dot mode: ``(dWs, dbs,
    sums)`` as :func:`linear_residual_plain` returns them; ``order``: the
    reverse nonlinearity's sum (``ops.fwdlap.DV_ORDERS``)."""
    d = X.shape[1]
    params = [(W.detach(), b.detach()) for W, b in params]
    saved, final = recompute_plain(params, X, activation, cast)
    value, grad, lap = project_plain(params, final)
    c, b, a = coef[:, 0], coef[:, 1:1 + d], coef[:, d + 1]
    # the kernels' order (JAX's _fused_kernel, fused_step.cu point_terms):
    # the Jacobian terms added one by one after the others; at d = 20 a
    # sum of them in another order rounded a cotangent to the other bf16
    # neighbour (ROADMAP.md C)
    r = c * value + a * lap + coef[:, d + 2]
    for j in range(d):
        r = r + b[:, j] * grad[:, j]
    ct = torch.cat([(r * c)[:, None], r[:, None] * b, (r * a)[:, None]], dim=1)
    dWs, dbs = reverse_plain(params, X, cast, saved, final, ct, order)
    sums = torch.stack([torch.sum(r * r), torch.sum(r * c),
                        torch.sum(r * coef[:, d + 3] * value)])
    return dWs, dbs, sums


# ---------------------------------------------------------- plain versions
def _leaves(params):
    return [(W.detach().requires_grad_(True), b.detach().requires_grad_(True))
            for W, b in params]


def _grads_of(total, leaves):
    flat = torch.autograd.grad(total, [t for pair in leaves for t in pair])
    return list(flat[0::2]), list(flat[1::2])


def linear_residual_plain(params, X, coef, activation: str,
                          dot_dtype: str = "float32", order=None):
    """Plain version of the linear-residual kernel: ``(dWs, dbs, sums)``
    with ``dW = sum_i r_i dr_i/dW`` (unscaled) and ``sums = [sum r^2,
    sum r c, sum r e net]``.  ``dot_dtype='bfloat16'``: the kernel's
    bf16-dot variant (every product operand rounded to bf16), its reverse
    nonlinearity's sum in ``order`` (``ops.fwdlap.DV_ORDERS``; the float32
    mode takes none)."""
    if dot_dtype == "bfloat16":
        return _residual_swept(params, X, coef, activation, round_bf16, order)
    if order is not None:
        raise ValueError("order: the bf16-dot plain versions only")
    d = X.shape[1]
    with torch.enable_grad():
        leaves = _leaves(params)
        jet = mlp_fwdlap(leaves, X, activation)
        r = (coef[:, 0] * jet.value
             + torch.sum(coef[:, 1:1 + d] * jet.grad, dim=1)
             + coef[:, d + 1] * jet.lap + coef[:, d + 2])
        dWs, dbs = _grads_of(0.5 * torch.sum(r * r), leaves)
    r, value = r.detach(), jet.value.detach()
    sums = torch.stack([torch.sum(r * r), torch.sum(r * coef[:, 0]),
                        torch.sum(r * coef[:, d + 3] * value)])
    return dWs, dbs, sums


# The analytic kernel's plain bf16-dot version in other sound rounding orders
# (``order``): the reverse nonlinearity's (ops.fwdlap.DV_ORDERS), or
# "coef64", the coefficients computed in float64 and rounded once, as a
# correctly rounded in-kernel builder would give them: at d = 20 the
# products of 19-20 factors carry a float32 error that moves the gradient
# leaves by up to 6e-6 (ROADMAP.md C).
ANALYTIC_ORDERS = DV_ORDERS + ("coef64",)


def poisson_analytic_plain(params, X, activation: str, coef_fn,
                           dot_dtype: str = "float32", order=None):
    """Plain version of the analytic kernel: the linear residual with the
    coefficients ``coef_fn(X)`` (no extra e lane); ``order``: one of
    ``ANALYTIC_ORDERS`` (the bf16-dot mode)."""
    coef64 = order == "coef64"
    if coef64 and dot_dtype != "bfloat16":
        raise ValueError("order: the bf16-dot plain versions only")
    c, bs, a, rhs = coef_fn(X.double() if coef64 else X)
    coef = torch.stack([c, *bs, a, rhs, torch.zeros_like(c)], dim=1).to(X.dtype)
    return linear_residual_plain(params, X, coef, activation, dot_dtype,
                                 None if coef64 else order)


def _drm_swept(params, X, coef, activation, cast, order=None):
    """The DRM kernel's arithmetic in a dot mode: ``(dWs, dbs, sums)`` as
    :func:`drm_energy_plain` returns them (no Laplacian cotangent);
    ``order``: the reverse nonlinearity's sum (``ops.fwdlap.DV_ORDERS``)."""
    d = X.shape[1]
    params = [(W.detach(), b.detach()) for W, b in params]
    B, dB, f = coef[:, 0], coef[:, 1:1 + d], coef[:, d + 1]
    saved, final = recompute_plain(params, X, activation, cast)
    value, grad, _ = project_plain(params, final)
    G = B[:, None] * grad + dB * value[:, None]
    # the kernels' order: the terms of each stream one by one
    e, ctv = 0.5 * G[:, 0] * G[:, 0], G[:, 0] * dB[:, 0]
    for j in range(1, d):
        e, ctv = e + 0.5 * G[:, j] * G[:, j], ctv + G[:, j] * dB[:, j]
    e, ctv = e - f * B * value, ctv - f * B
    ct = torch.cat([ctv[:, None], G * B[:, None], torch.zeros_like(ctv)[:, None]], dim=1)
    dWs, dbs = reverse_plain(params, X, cast, saved, final, ct, order)
    sums = torch.stack([torch.sum(e), torch.sum(ctv), torch.zeros_like(ctv[0])])
    return dWs, dbs, sums


def drm_energy_plain(params, X, coef, activation: str, dot_dtype: str = "float32",
                     order=None):
    """Plain version of the DRM kernel: ``dW = d(sum_i e_i)/dW`` and
    ``sums = [sum e, sum ct_v, 0]`` with ``ct_v = de/dnet``.
    ``dot_dtype='bfloat16'``: the kernel's bf16-dot variant, its reverse
    nonlinearity's sum in ``order`` (``ops.fwdlap.DV_ORDERS``)."""
    if dot_dtype == "bfloat16":
        return _drm_swept(params, X, coef, activation, round_bf16, order)
    if order is not None:
        raise ValueError("order: the bf16-dot plain versions only")
    d = X.shape[1]
    B, dB, f = coef[:, 0], coef[:, 1:1 + d], coef[:, d + 1]
    with torch.enable_grad():
        leaves = _leaves(params)
        jet = mlp_fwdlap(leaves, X, activation)
        G = B[:, None] * jet.grad + dB * jet.value[:, None]
        e = 0.5 * torch.sum(G * G, dim=1) - f * B * jet.value
        dWs, dbs = _grads_of(torch.sum(e), leaves)
    G = G.detach()
    ctv = torch.sum(G * dB, dim=1) - f * B
    sums = torch.stack([torch.sum(e.detach()), torch.sum(ctv),
                        torch.zeros((), dtype=X.dtype, device=X.device)])
    return dWs, dbs, sums


# ------------------------------------------------------------ CUDA launcher
PLANNED_BLOCKS = 2        # the planned kernels' __launch_bounds__(NT, 2)


def _streams(kind: str, d: int) -> int:
    return d + (1 if kind == "fused_drm_energy" else 2)


def smem_floats(kind: str, layers, T: int, flags: int = 0) -> int:
    """Shared-memory floats per block for a tile of T points (the layout of
    fused_step.cu's fused_body_p, mirrored from its fused_smem_floats):
    residency ``flags`` of :mod:`._plan`."""
    d = layers[0]
    S, wmax = _streams(kind, d), _cuda.padded_wmax(layers)
    n = 3 * S * T * wmax
    if not flags & _plan.DEV_WEIGHTS:
        n += 2 * _plan.hidden_floats(layers) if flags & _plan.RES_WEIGHTS else wmax * wmax
    if flags & _plan.RES_GRAD:
        n += (_cuda.n_params(layers) + 3 + 3) // 4 * 4
    return n + T * d + (d + 2) * T + 3 * T + S * T + _cuda.NT


def planned(smem_floats_of, layers, S: int, what: str, design: int | None = None, *,
            T: int | None = None, tier: str | None = None) -> _plan.Plan:
    """The launch shape of a kernel of fused_step.cu or fwdlap_backward.cu
    in a planned ``design`` (``smem_floats_of(T, flags)`` its layout, ``S``
    its streams): the shared plan of :mod:`._plan` (seeded tiers; with
    ``DES_ITEM2`` the tile rule of 8-row items) at most ``PLANNED_BLOCKS``
    blocks per SM; any other design raises.  ``design=None`` is the fp32
    wrappers' choice: two-point items where their one-wave tile fits two
    blocks per SM as it is; where it only fits a step below (u64: 28 points,
    224 of 256 items), the planned 4 x 4 items (``chip_smoke.py sweep``);
    where no tile with the weights on chip fits, the 4 x 4 items reading the
    weights from device memory (``DES_DEVW``).  The nets of
    :func:`._cuda.beyond` (a hidden width above 256, d above 16) take the
    ``DES_BEYOND`` designs, and only they: 4 x 4 items, the weights on chip
    where they fit, else from device memory; a net whose stages do not fit
    at 4 points raises :class:`._plan.NoFit`.  ``T`` and ``tier`` pin a
    choice and raise if it does not fit."""
    _plan.check_planned(design, what)

    def ladder(des, device=False):
        pl = _plan.plan(smem_floats_of, layers, S, True, T=T, tier=tier, what=what,
                        rows=8 if des & _cuda.DES_ITEM2 else 4, blocks=PLANNED_BLOCKS,
                        device=True if des & _cuda.DES_DEVW else device)
        return pl._replace(design=des | (pl.design & _cuda.DES_DEVW))

    if design is not None and _cuda.beyond(layers) != (design in _cuda.BEYOND_DESIGNS):
        raise ValueError(f"{what}: the DES_BEYOND designs {_cuda.BEYOND_DESIGNS} are for the "
                         f"nets beyond the other kernels' limits, and only they take them "
                         f"(layers {list(layers)}, design {design})")
    if _cuda.beyond(layers):
        return ladder(_cuda.DES_PLANNED | _cuda.DES_BEYOND,
                      None if design is None else bool(design & _cuda.DES_DEVW))
    if design is not None:
        return ladder(design)
    try:
        two = ladder(_cuda.DES_PLANNED | _cuda.DES_ITEM2)
    except _plan.NoFit:
        two = None
    if two is not None and (T is not None or two.T == _plan.tile_for(layers, S, rows=8)):
        return two
    # the 4 x 4 items, and where nothing fits the weights from device memory
    return ladder(_cuda.DES_PLANNED, device=None)


def plan(kind: str, layers, design: int | None = None, *, T: int | None = None,
         tier: str | None = None) -> _plan.Plan:
    """The launch shape of one fused kernel (:func:`planned`; a tensor-core
    design, ``MMA_DESIGNS``: :func:`mma_plan`, which adds ``DES_BEYOND``
    where the net needs it)."""
    if design in MMA_DESIGNS:
        return mma_plan(kind, layers, T=T, tier=tier)
    return planned(lambda t, f: smem_floats(kind, layers, t, f), layers,
                   _streams(kind, layers[0]), f"{kind} plan", design, T=T, tier=tier)


# ------------------------------------------- the tensor-core design (DES_MMA)
# The bf16-dot mode of the fused kernels, the jet pair, the quotients' and
# the K-bump pair's two passes (fwdlap_mma.cuh, one body for the four
# kinds): bf16 stages of Sp*T rows (T = 8 or a multiple of 16), hidden
# weights bf16 padded to multiples of 16, the saved stages in fragment order
# in device memory (none in the kinds without a reverse sweep).  Measured on an H100 (chip_smoke.py
# mma_sweep; PERF.md): the block's gradient row on chip comes first (its
# hidden dW accumulates there in fragment order), then the resident
# weights; 16-point tiles at two blocks per SM (the kernels' register
# budget) beat larger tiles.  Widths 129-256 add two tiers for the shapes
# whose weights or sums do not fit beside the stages: ``device`` reads W_k
# from device memory (each B fragment rounded to bf16 at its load),
# ``device-sums`` also keeps the projection partials and column sums in
# device scratch (d near 16 at width 256); both give the bits of the tiers
# on chip.
MMA_T = 16                # the tile the plan asks for first
MMA_TIERS = (("resident", _plan.RES_WEIGHTS | _plan.RES_GRAD), ("gradient", _plan.RES_GRAD),
             ("weights", _plan.RES_WEIGHTS), ("staged", 0), ("device", _plan.DEV_WEIGHTS),
             ("device-sums", _plan.DEV_WEIGHTS | _plan.DEV_SUMS))
# the kinds without a reverse sweep keep no gradient row, and their sums fit
# beside two stages
MMA_FWD_TIERS = (("weights", _plan.RES_WEIGHTS), ("staged", 0), ("device", _plan.DEV_WEIGHTS))
MMA_KINDS = ("fused_linear_residual", "fused_poisson_analytic", "fused_drm_energy",
             "fwdlap_backward", "fwdlap_forward", "linear_sums", "linear_seeded",
             "quad_sums", "quad_seeded", "multi_sums", "multi_seeded")
# the kinds without a reverse sweep (mma::has_rev): nothing saved, no
# gradient row, no column sums; the quotients' and the K-bump pair's pass A
# sums its terms
MMA_FORWARD = ("fwdlap_forward", "linear_sums", "quad_sums", "multi_sums")
# the kinds that never carry the Laplacian stream (S = d + 1); the linear
# quotients carry it or not (``lap``), the others always
MMA_NO_LAP = ("fused_drm_energy", "quad_sums", "quad_seeded", "multi_sums", "multi_seeded")
# pass A's double lanes a point, at least (mma::SUM_LANES): the quotients'
# four (the quadratic one's two sums in the same room)
MMA_SUM_LANES = 4
# blocks per SM a plan may count on: the kernels with a reverse sweep have a
# two-block register budget (a third block's spills, PERF.md), as the pass-A
# kernels do; the jet forward comes at three and at two (its launch bounds,
# the plan's ``blocks``)
MMA_SHARES = {"fwdlap_forward": (3, 2, 1)}


def _kp16(w: int) -> int:
    return -(-w // 16) * 16


def _np8(w: int) -> int:
    return -(-w // 8) * 8


def _rnd4(n: int) -> int:
    return -(-n // 4) * 4


class MmaGeo(NamedTuple):
    """A tile's geometry in the tensor-core design (``mma::Geo``)."""
    S: int        # streams, d + 1 + lap
    Sp: int       # streams padded so that Sp * T is a multiple of 16
    NU: int       # m16 tiles of a warp block
    NPB: int      # 16-point blocks of the tile (T = 8: one of 8 points)
    ST: int       # stage rows, Sp * T
    ldb: int      # bf16 stage row stride: kp16(widest) + 8
    wq: int       # widest hidden layer rounded up to 8
    nblk: int     # warp blocks of the widest stage
    R: int        # column-sum slots and cotangent rows, d + 2


def mma_geometry(layers, T: int, lap: int = 1) -> MmaGeo:
    """The geometry of a tile of T points (8, or a multiple of 16 up to
    ``NT / 2``) on this net, with the Laplacian stream (``lap``) or
    without; other tiles raise."""
    if not (T == 8 or (16 <= T <= _cuda.NT // 2 and T % 16 == 0)):
        raise ValueError(f"the tensor-core design takes T = 8 or a multiple of 16, got {T}")
    S = layers[0] + 1 + lap
    t8 = T == 8
    Sp = S + (S & 1) if t8 else S
    wt = max(layers[1:-1])
    return MmaGeo(S, Sp, Sp // 2 if t8 else S, 1 if t8 else T // 16, Sp * T,
                  _kp16(wt) + 8, _np8(wt), (1 if t8 else T // 16) * _np8(wt) // 8,
                  layers[0] + 2)


def _check_mma_kind(kind: str) -> None:
    if kind not in MMA_KINDS:
        raise ValueError(f"{kind}: no bf16-dot mode, so no tensor-core design")


def mma_lap(kind: str, lap=None) -> int:
    """Whether ``kind`` carries the Laplacian stream in the tensor-core
    design: fixed by the kind, or ``lap`` for the linear quotients (default:
    carried).  A ``lap`` the kind cannot take raises."""
    _check_mma_kind(kind)
    if kind.startswith("linear"):
        return 1 if lap is None else int(bool(lap))
    fixed = 0 if kind in MMA_NO_LAP else 1
    if lap is not None and int(bool(lap)) != fixed:
        raise ValueError(f"{kind}: the Laplacian stream is {'always' if fixed else 'never'} "
                         f"carried (lap={lap})")
    return fixed


def mma_sum_lanes(kind: str, n_bumps: int | None = None) -> int:
    """Pass A's double lanes a point (``mma::sum_lanes`` of its row of
    sums): the K-bump pass A's ``3 n_bumps`` sums (at least
    ``MMA_SUM_LANES``), the quotients' ``MMA_SUM_LANES``.  The K-bump pass A
    without ``n_bumps`` raises: its shared memory grows with the bumps."""
    if kind != "multi_sums":
        return MMA_SUM_LANES
    if n_bumps is None:
        raise ValueError("multi_sums: the tensor-core layout needs the bump count (n_bumps)")
    return max(3 * n_bumps, MMA_SUM_LANES)


def _mma_sums_floats(g: MmaGeo, kind: str) -> int:
    """Floats of the projection partials (not in the jet backward) and the
    column sums (the kinds with a reverse sweep): on chip, or with
    ``DEV_SUMS`` in device scratch."""
    return ((_rnd4(g.wq // 8 * g.ST) if kind != "fwdlap_backward" else 0)
            + (_rnd4(g.NPB * g.R * g.wq) if kind not in MMA_FORWARD else 0))


def mma_smem_bytes(layers, T: int, flags: int = 0,
                   kind: str = "fused_linear_residual", lap=None,
                   n_bumps: int | None = None) -> int:
    """Shared-memory bytes of one block of ``kind`` (``mma::layout``): the
    bf16 stages (three; two without a reverse sweep), the hidden weights in
    bf16 (all with ``RES_WEIGHTS``, none with ``DEV_WEIGHTS``, else the
    largest one), the gradient row (``RES_GRAD``; the loss sums too in the
    fused and seeded kinds), the projection partials (not in the jet
    backward) and the column sums (the kinds with a reverse sweep) unless
    ``DEV_SUMS``, the tile's points, cotangents (d + 2 rows, the kinds with
    a reverse sweep), sum terms (the fused and seeded kinds: three floats a
    point; pass A: :func:`mma_sum_lanes` doubles a point, 3 ``n_bumps`` in
    the K-bump pass A) and projected streams (not in the jet backward).
    ``lap``: :func:`mma_lap`."""
    g = mma_geometry(layers, T, mma_lap(kind, lap))
    d = layers[0]
    rev, proj = kind not in MMA_FORWARD, kind != "fwdlap_backward"
    fused = kind.startswith("fused") or kind.endswith("seeded")
    n = (3 if rev else 2) * g.ST * g.ldb * 2
    hid = [_kp16(a) * (_kp16(b) + 8) * 2 for a, b in zip(layers[1:-2], layers[2:-1])]
    if not flags & _plan.DEV_WEIGHTS:
        n += sum(hid) if flags & _plan.RES_WEIGHTS else max(hid, default=0)
    if rev and flags & _plan.RES_GRAD:
        n += 4 * _rnd4(_cuda.n_params(layers) + (3 if fused else 0))
    floats = ((0 if flags & _plan.DEV_SUMS else _mma_sums_floats(g, kind)) + _rnd4(T * d)
              + (_rnd4(g.R * T) if rev else 0) + (_rnd4(3 * T) if fused else 0)
              + (2 * mma_sum_lanes(kind, n_bumps) * T if kind.endswith("_sums") else 0)
              + (_rnd4(g.ST) if proj else 0))
    return n + 4 * floats


def mma_scratch_floats(layers, T: int, kind: str = "fused_linear_residual",
                       flags: int = 0, lap=None) -> int:
    """Floats of one block's slice of device scratch (``mma::scratch_floats``):
    the saved stages, the K-1 hidden stages of each warp block's stream
    tiles and its q tile, a float4 per lane (none without a reverse sweep,
    which saves nothing); then with ``DEV_SUMS`` the projection partials and
    the column sums."""
    g = mma_geometry(layers, T, mma_lap(kind, lap))
    saved = 0 if kind in MMA_FORWARD else (len(layers) - 2) * g.nblk * (g.NU + 1) * 128
    return saved + (_mma_sums_floats(g, kind) if flags & _plan.DEV_SUMS else 0)


# What an unpinned tensor-core plan that fits nothing adds to its NoFit: the
# design's smallest tile is 8 points, and the stages in device memory are the
# rest of ROADMAP.md B7.
MMA_NO_TILE = (f": no tile of 8 points fits (stages in device memory: "
               f"{_cuda.BEYOND_ITEM})")


def mma_plan(kind: str, layers, *, T: int | None = None, tier: str | None = None,
             blocks: int | None = None, lap=None, n_bumps: int | None = None) -> _plan.Plan:
    """The launch shape of the bf16-dot mode of ``kind`` (``MMA_KINDS``) in
    the tensor-core design.  The most blocks per SM first (two, the register
    budget of the kinds with a reverse sweep and of pass A; the jet forward
    three, then two), then one; within them the tile (``MMA_T``, then
    multiples of 16 down to 16, and with a whole SM to itself 8), then the
    tiers (``MMA_TIERS``; the kinds without a reverse sweep
    ``MMA_FWD_TIERS``) in order.  The jet forward's plan carries its
    register budget in ``blocks`` (3 at three blocks per SM, else 2).
    ``T``, ``tier`` and ``blocks`` pin a choice; ``lap``: :func:`mma_lap`;
    ``n_bumps``: the K-bump pass A's bump count (:func:`mma_sum_lanes`).
    The design is ``DES_MMA``, with ``DES_BEYOND`` for the fused kinds
    (rows 1-3) on the nets of :func:`._cuda.beyond` and only there (their
    loss terms without per-point arrays; :func:`mma_des` adds the wide
    variant's bit at launch).  Rows 1-5 take the nets beyond the other
    kernels' limits (``_cuda.LIMITS``; widths to 4096, 64 weight matrices,
    d to 64, the jet forward's to 16) wherever a tile fits, rows 7-12 width
    256, 16 matrices and d 16; a net past its kind's limits raises naming
    ROADMAP.md B7 (the jet forward past d = 16: JAX's own limit), and what
    fits nothing raises :class:`._plan.NoFit` naming the shape (and, unpinned,
    B7: the smallest tile is 8 points)."""
    lap = mma_lap(kind, lap)
    _cuda.check_net(kind + ".bf16", layers)
    jet_fwd = kind == "fwdlap_forward"
    design = _cuda.DES_MMA | (_cuda.DES_BEYOND if kind.startswith("fused")
                              and _cuda.beyond(layers) else 0)
    shares = MMA_SHARES.get(kind, (2, 1))
    if blocks is not None and blocks not in shares:
        raise ValueError(f"{kind}: the register budget is {max(shares)} blocks per SM, "
                         f"not {blocks}")
    tiers = MMA_FWD_TIERS if kind in MMA_FORWARD else MMA_TIERS
    names = [tier] if tier is not None else [name for name, _ in tiers]
    for share in shares if blocks is None else (blocks,):
        budget = _cuda.SMEM_MAX if share == 1 else _plan.SM_SMEM // share - 1024
        if T is not None:
            tiles = (T,)
        else:
            tiles = tuple(range(MMA_T, 15, -16)) + ((8,) if share == 1 else ())
        for t in tiles:
            for name, flags in tiers:
                if name not in names:
                    continue
                smem = mma_smem_bytes(layers, t, flags, kind, lap, n_bumps)
                if smem <= budget:
                    return _plan.Plan(t, smem, flags, name, design,
                                      (3 if share == 3 else 2) if jet_fwd else 0)
    pinned = T is not None or tier is not None or blocks is not None
    raise _plan.NoFit(f"{kind} mma plan: layers {list(layers)} do not fit {_cuda.SMEM_MAX} B "
                      f"of shared memory (T={T}, tier={tier}, blocks={blocks}, lap={lap}, "
                      f"n_bumps={n_bumps}){'' if pinned else MMA_NO_TILE}")


MMA_REG_WIDTH = 128      # widest layer the narrow variant holds in registers (KS_REG)
# the tensor-core designs of the fused kernels' launches (before DES_WIDE)
MMA_DESIGNS = (_cuda.DES_MMA, _cuda.DES_MMA | _cuda.DES_BEYOND)


def mma_des(layers, flags: int, design: int = _cuda.DES_MMA) -> int:
    """The design argument of a tensor-core launch: its plan's ``design``
    (``DES_MMA``, for rows 1-3 on the nets beyond with ``DES_BEYOND``),
    with ``DES_WIDE`` for the wide variant (``mma::needs_wide``): a hidden
    width above 128, whose k-steps the narrow variant cannot hold in
    registers, or the weights or the sums in device memory."""
    wide = (max(layers[1:-1]) > MMA_REG_WIDTH
            or flags & (_plan.DEV_WEIGHTS | _plan.DEV_SUMS))
    return design | (_cuda.DES_WIDE if wide else 0)


def variant(layers, S: int, pl: _plan.Plan) -> tuple[int, int]:
    """``(fold, occupancy key)`` of a launch: whether it takes the FOLD
    variant (a planned design), and the key of its variant in
    :func:`._cuda.grid`'s cache (the tensor-core design's: its narrow or
    wide variant)."""
    if pl.design & _cuda.DES_MMA:
        return 0, mma_des(layers, pl.flags, pl.design) << 1
    fold = int(_cuda.folds(layers, S, pl.T, 2 if pl.design & _cuda.DES_ITEM2 else 1)
               and not pl.design & _cuda.DES_DEVW)     # compiled without the fold
    return fold, fold | pl.design << 1


def _launch(kind: str, params, X, coef, activation: str, analytic=None,
            bf16: bool = False, *, pl: _plan.Plan | None = None):
    """Launch one fused kernel plus its reduction; returns the flat
    ``[grads (P) | sums (3)]`` float32 vector.  ``bf16``: the bf16-dot
    mode, which runs the tensor-core design (``DES_MMA``) and only it.
    ``pl``: a launch shape (and design) other than the wrapper's own
    (timing sweeps, tests)."""
    from . import _build

    lib = _build.load()
    name = variant_name(kind, bf16)
    layers = _cuda.net_layers(name, params, X, activation,
                              () if coef is None else (coef,))
    N, d = X.shape
    K = len(params)
    X = X.contiguous()
    flat = _cuda.flat_params(params)
    P = flat.numel()
    if pl is None:
        pl = _plan.cached(("fused", kind, tuple(layers), bf16),
                          lambda: mma_plan(kind, layers) if bf16 else plan(kind, layers))
    mma = bool(pl.design & _cuda.DES_MMA)
    if bool(bf16) != mma or not (pl.design in _cuda.FP32_DESIGNS + MMA_DESIGNS):
        raise ValueError(f"{kind}: the bf16-dot mode runs the tensor-core design and only it; "
                         f"fp32 a planned design (bf16={bf16}, design={pl.design})")
    if mma and bool(pl.design & _cuda.DES_BEYOND) != _cuda.beyond(layers):
        raise ValueError(f"{kind}: the bf16-dot mode's DES_BEYOND variant is for the nets "
                         f"beyond the other kernels' limits, and only they take it (layers "
                         f"{list(layers)}, design {pl.design})")
    T = pl.T
    design = mma_des(layers, pl.flags, pl.design) if mma else pl.design
    mode = _MODES[kind]
    dev = X.device
    S = _streams(kind, d)
    fold, key = variant(layers, S, pl)
    G = _cuda.grid(name,
                   lambda sm, ptr: lib.fused_blocks_per_sm(mode, fold, int(bf16), design, sm,
                                                           ptr),
                   pl.smem, dev, (N + T - 1) // T, key)
    partial = torch.empty((G, P + 3), dtype=torch.float32, device=dev)
    if mma:
        per_block = mma_scratch_floats(layers, T, kind, pl.flags)
    else:
        per_block = max(K - 2, 1) * S * T * _cuda.padded_wmax(layers)
    scratch = torch.empty((G, per_block), dtype=torch.float32, device=dev)
    out = torch.empty((P + 3,), dtype=torch.float32, device=dev)
    lay = _cuda.layers_arg(layers)
    common = (ctypes.addressof(lay), len(layers), _cuda.ACTS[activation], N, T, G, fold)
    tail = (partial.data_ptr(), scratch.data_ptr(), out.data_ptr(), pl.smem,
            _cuda.stream(dev))
    wt = (None if mma else _cuda.device_weights(params, True) if pl.design & _cuda.DES_DEVW
          else _cuda.hidden_transposes(params))
    wt_ptr = None if wt is None else wt.data_ptr()
    keep = (X, flat, wt, lay, partial, scratch, out)
    if kind == "fused_linear_residual":
        coef = coef.contiguous()
        _cuda.launch(name, lib.fused_linear_residual_f32, X.data_ptr(),
                     coef.data_ptr(), flat.data_ptr(), wt_ptr, *common, int(bf16), design,
                     pl.flags, *tail, dev=dev, keep=keep + (coef,))
    elif kind == "fused_drm_energy":
        coef = coef.contiguous()
        _cuda.launch(name, lib.fused_drm_energy_f32, X.data_ptr(),
                     coef.data_ptr(), flat.data_ptr(), wt_ptr, *common, int(bf16), design,
                     pl.flags, *tail, dev=dev, keep=keep + (coef,))
    else:
        an = (ctypes.c_float * (3 + d))(*analytic)
        _cuda.launch(name, lib.fused_poisson_analytic_f32, X.data_ptr(),
                     flat.data_ptr(), wt_ptr, *common, int(bf16), design, pl.flags,
                     ctypes.addressof(an), *tail, dev=dev, keep=keep + (an,))
    return out


def _unflatten(params, out):
    dWs, dbs, o = [], [], 0
    for W, b in params:
        dWs.append(out[o:o + W.numel()].view(W.shape))
        o += W.numel()
        dbs.append(out[o:o + b.numel()].view(b.shape))
        o += b.numel()
    return dWs, dbs, out[o:o + 3]


def _analytic_args(coef_fn, d: int):
    """The analytic kernel's ``[L, a0, sum_i (k_i pi / L)^2, k_0 pi / L,
    ...]`` for ``coef_fn``; other builders than :class:`PoissonSinCoef`
    raise."""
    if not isinstance(coef_fn, PoissonSinCoef):
        raise NotImplementedError(
            "in-kernel coefficients exist for the box-FBC prod-sin "
            "Poisson family (PoissonSinCoef) only; other builders are "
            "ROADMAP B2")
    if len(coef_fn.ks) != d:
        raise ValueError(f"ks has {len(coef_fn.ks)} entries for d={d}")
    L = coef_fn.L
    return ([L, coef_fn.a0, sum((k * math.pi / L) ** 2 for k in coef_fn.ks)]
            + [k * math.pi / L for k in coef_fn.ks])


def _fused_call(kind, activation, params, X, coef=None, coef_fn=None,
                dot_dtype: str = "float32"):
    """Route one fused step: CUDA tensors to the kernel, CPU tensors to the
    plain version.  Returns ``(dWs, dbs, sums, N)`` (unscaled sums)."""
    N = X.shape[0]
    if X.device.type == "cuda":
        analytic = None
        if kind == "fused_poisson_analytic":
            analytic = _analytic_args(coef_fn, X.shape[1])
        params = [(W.detach(), b.detach()) for W, b in params]
        out = _launch(kind, params, X, coef, activation, analytic,
                      bf16=dot_dtype == "bfloat16")
        dWs, dbs, sums = _unflatten(params, out)
        return dWs, dbs, sums, N
    if X.device.type != "cpu":
        raise ValueError(f"no fused path for device {X.device}")
    if kind == "fused_linear_residual":
        dWs, dbs, sums = linear_residual_plain(params, X, coef, activation, dot_dtype)
    elif kind == "fused_drm_energy":
        dWs, dbs, sums = drm_energy_plain(params, X, coef, activation, dot_dtype)
    else:
        dWs, dbs, sums = poisson_analytic_plain(params, X, activation, coef_fn, dot_dtype)
    return dWs, dbs, sums, N


def _check_coef(X, coef, nc):
    if coef.shape != (X.shape[0], nc):
        raise ValueError(f"coef must be (N, {nc}) = ({X.shape[0]}, {nc}), "
                         f"got {tuple(coef.shape)}")


def _scaled_grads(params, dWs, dbs, sums, scale):
    """Per-point-sum outputs x ``scale``; the last bias gradient is
    ``scale * sums[1]`` (= scale * sum ct_v)."""
    db_last = (scale * sums[1]).reshape(params[-1][1].shape)
    grads = [(scale * dW, scale * db) for dW, db in zip(dWs[:-1], dbs[:-1])]
    grads.append((scale * dWs[-1], db_last))
    return grads


def fused_linear_residual(params, X, coef, activation: str, *,
                          weight: float = 1.0, dot_dtype: str = "float32"):
    """``loss = weight * mean(r^2)`` and its parameter gradients in one pass.
    ``aux['sum_r_ufull'] = sum r e net`` (the trainable-E seed).
    ``dot_dtype``: ``'float32'``, ``'bf16x3'`` or ``'bfloat16'`` (the
    bf16-dot mode)."""
    _check_dot(dot_dtype)
    _check_coef(X, coef, X.shape[1] + 4)
    dWs, dbs, sums, N = _fused_call("fused_linear_residual", activation,
                                    params, X, coef=coef, dot_dtype=dot_dtype)
    loss = weight * sums[0] / N
    grads = _scaled_grads(params, dWs, dbs, sums, 2.0 * weight / N)
    return loss, {"sum_r2": sums[0], "sum_r_ufull": sums[2], "n": N}, grads


def fused_drm_energy(params, X, coef, activation: str, *,
                     weight: float = 1.0, dot_dtype: str = "float32"):
    """``loss = weight * mean(1/2 |grad u|^2 - f u)`` and its gradients in
    one pass; ``coef`` from :func:`drm_coefficients`.  ``dot_dtype``:
    ``'float32'``, ``'bf16x3'`` or ``'bfloat16'`` (the bf16-dot mode)."""
    _check_dot(dot_dtype)
    _check_coef(X, coef, X.shape[1] + 2)
    dWs, dbs, sums, N = _fused_call("fused_drm_energy", activation, params,
                                    X, coef=coef, dot_dtype=dot_dtype)
    loss = weight * sums[0] / N
    grads = _scaled_grads(params, dWs, dbs, sums, weight / N)
    return loss, {"sum_e": sums[0], "n": N}, grads


def fused_residual_analytic(params, X, activation: str, coef_fn, *,
                            weight: float = 1.0, dot_dtype: str = "float32"):
    """Fused residual step with coefficients computed from X.  On the CPU
    ``coef_fn`` is any ``(N, d) -> (c, [b..], a, rhs)``; the CUDA kernel
    takes :class:`PoissonSinCoef`.  ``dot_dtype``: ``'float32'``,
    ``'bf16x3'`` or ``'bfloat16'``."""
    _check_dot(dot_dtype)
    dWs, dbs, sums, N = _fused_call("fused_poisson_analytic", activation,
                                    params, X, coef_fn=coef_fn, dot_dtype=dot_dtype)
    loss = weight * sums[0] / N
    grads = _scaled_grads(params, dWs, dbs, sums, 2.0 * weight / N)
    return loss, {"sum_r2": sums[0], "n": N}, grads


def fused_poisson_analytic(params, X, activation: str, *, L: float,
                           ks: Sequence[int], weight: float = 1.0,
                           dot_dtype: str = "float32"):
    """Fused Poisson PINN step ``weight * mean((-lap u - f)^2)`` for the
    box-FBC trial and the prod-sin RHS, coefficients built in-kernel."""
    return fused_residual_analytic(params, X, activation,
                                   PoissonSinCoef(L, ks, a0=-1.0),
                                   weight=weight, dot_dtype=dot_dtype)


def _check_dot(dot_dtype: str) -> None:
    """Whether a kernel takes ``dot_dtype``: ``'float32'``, ``'bf16x3'`` or
    ``'bfloat16'``, every kernel.  ``'bf16x3'`` is the TPU kernels'
    three-pass split, float32-class, so it runs the float32 kernels and
    counts under their launch names (the H100's fp32 products meet its bar:
    ROADMAP.md's decision on the fp32 class; tests/test_torch_bf16_quotient.py
    measures the gap to JAX's ``'bf16x3'``); ``'bfloat16'`` the kernel's
    bf16-dot variant on the tensor-core design."""
    if dot_dtype not in ("float32", "bf16x3", "bfloat16"):
        raise ValueError(f"Unknown dot_dtype {dot_dtype!r}")
