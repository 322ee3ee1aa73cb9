"""Two-pass fused kernels for the quotient losses (WAN weak form, Rayleigh).

Counterpart of ``nnpde_tpu/kernels/fused_quotient.py``.  The one-pass fused
kernels (:mod:`.fused_step`) cover losses whose per-point cotangent is a
per-point function; the WAN weak form ``wr^2 / (mean(phi^2) + eps)``, the
critic objectives ``-log(p + eps)`` / ``-p``, the Rayleigh quotient
``mean(e) / mean(u^2)`` and quadratic means need global sums first:

* **pass A** (:func:`fused_linear_sums` / :func:`fused_quad_sums`) runs the
  jet recompute only and returns the global sums;
* the scalar factors of the quotient are formed from them with torch ops
  on the device (no host sync);
* **pass B** (:func:`fused_seeded_grads` / :func:`fused_quad_seeded_grads`)
  re-runs the recompute, seeds per-point cotangents from those scalars and
  runs the reverse sweep down to the parameter gradients.

The factories :func:`make_fused_rayleigh`, :func:`make_fused_quad_mean`,
:func:`make_fused_wan_u` and :func:`make_fused_wan_v` wrap the pair in a
``torch.autograd.Function``: pass A in ``forward``, pass B in ``backward``.
With ``axis=`` a process group, each rank holds a shard of the points:
pass A's sums are all-reduced (in float64) before the quotient is formed
and pass B's gradients are summed, so every rank gets the global
objective and its gradient (:mod:`nnpde_tpu_torch.parallel`).
Gradients flow to the network params (and to ``E`` and ``phi_norm`` for
the WAN primal), never to the points or the coefficient streams; the aux
values are metrics and carry no gradient.

Linear coefficient layout per point (``nc = d + 5``): ``[c, b_0..b_{d-1},
a, rhs, e1, e2]`` with ``r = c*net + b.grad(net) + a*lap(net) + rhs``, the
mass lane ``sum (e1*net)^2`` and the linear lane ``sum e2*net``.  Quadratic
layout (``nc = d + 3``): ``[B, dB_0..dB_{d-1}, f, V]`` with ``u = B*net``,
``G = B*grad(net) + dB*net`` and ``e = 1/2 |G|^2 - f*u + V*u^2``.

Where it runs: a CUDA tensor goes to ``csrc/fused_quotient.cu`` (float32;
anything else raises), a CPU tensor to the plain version beside it
(``*_plain``: the forward-Laplacian recurrence under ``torch.autograd``, in
any dtype).  ``dot_dtype='bfloat16'`` (every kernel here; the TPU kernels'
one-pass bf16 dot mode) rounds every product operand of the recompute and
the reverse sweep to bf16 and accumulates in float32, on the tensor-core
design (``csrc/fused_quotient_mma.cu`` on ``csrc/fwdlap_mma.cuh``, counted
as ``<kernel>.bf16``); its plain versions are the per-tile arithmetic
written out (:func:`~nnpde_tpu_torch.ops.fwdlap.recompute_plain`,
:func:`~nnpde_tpu_torch.ops.fwdlap.reverse_plain` with ``round_bf16``).
``'bf16x3'`` runs the float32 kernels (:func:`.fused_step._check_dot`).

Both passes choose their launch shape by :func:`plan`: the seeded kinds the
shared plan of :mod:`._plan` (tile, what stays on chip, blocks per SM), the
sums kinds the plan of the forward-only kernels, by net and N
(:func:`._plan.forward_only`: design, tile, resident weights, register
budget).  The objectives flatten
the parameters once per evaluation and hand the vector from ``forward`` to
``backward`` (``flat=``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..ops.fwdlap import mlp_fwdlap, project_plain, recompute_plain, reverse_plain, round_bf16
from . import _cuda, _plan
from ._cuda import on_cuda as _on_cuda
from .fused_step import (
    _check_coef,
    _check_dot,
    _full,
    _grads_of,
    _leaves,
    _unflatten,
    drm_coefficients,
    mma_des,
    mma_plan,
    mma_scratch_floats,
    residual_coefficients,
    variant,
)

_KINDS = {"linear_sums": 0, "linear_seeded": 1, "quad_sums": 2, "quad_seeded": 3}
_NSUMS = {"linear_sums": 4, "linear_seeded": 1, "quad_sums": 2, "quad_seeded": 1}


# --------------------------------------------------------- coefficient builders
def linear_functional_coefficients(factor_jet, *, c0=None, b0=None, a0=0.0,
                                   rhs=None, e1=None, e2=None):
    """(N, d+5) stream for a linear functional ``r = a0 lap(u) + b0.grad(u)
    + c0 u + rhs`` of ``u = B*net``: the product rule of
    :func:`.fused_step.residual_coefficients`, then the mass lane ``e1`` and
    the linear lane ``e2`` (per-point; default 0)."""
    B = factor_jet.value
    N, d = factor_jet.grad.shape

    def lane(x):
        return torch.zeros((N,), dtype=B.dtype, device=B.device) if x is None else _full(x, (N,), B)

    core = residual_coefficients(factor_jet, c0=c0, b0=b0, a0=a0, rhs=rhs)
    return torch.cat([core[:, :d + 3], lane(e1)[:, None], lane(e2)[:, None]], dim=1)


def quotient_coefficients(factor_jet, *, f=None, V=None):
    """(N, d+3) stream ``[B, dB_0.., f, V]`` of the quadratic energy
    ``1/2 |grad u|^2 - f u + V u^2``."""
    B = factor_jet.value
    N = B.shape[0]
    Vv = torch.zeros((N,), dtype=B.dtype, device=B.device) if V is None else _full(V, (N,), B)
    return torch.cat([drm_coefficients(factor_jet, f=f), Vv[:, None]], dim=1)


# ---------------------------------------------------------- plain versions
def _linear_r(jet, coef, d, no_lap):
    r = (coef[:, 0] * jet.value + torch.sum(coef[:, 1:1 + d] * jet.grad, dim=1)
         + coef[:, d + 2])
    if not no_lap:
        r = r + coef[:, d + 1] * jet.lap
    return r


class _SweptJet(NamedTuple):
    """The bf16-dot recompute's projected jet, with what its reverse sweep
    needs."""
    value: torch.Tensor
    grad: torch.Tensor
    lap: torch.Tensor
    saved: list
    final: tuple


def _swept_jet(params, X, activation) -> _SweptJet:
    """The kernels' bf16-dot recompute (every product operand rounded to
    bf16) projected on the last layer's row."""
    params = [(W.detach(), b.detach()) for W, b in params]
    saved, final = recompute_plain(params, X, activation, round_bf16)
    value, grad, lap = project_plain(params, final)
    return _SweptJet(value, grad, lap, saved, final)


def _swept_grads(params, X, jet: _SweptJet, ct):
    """The bf16-dot reverse sweep from per-point cotangents ``ct`` (N, d+2)
    of ``[value, grad, lap]``: ``(dWs, dbs)`` with ``dbs[-1] = sum ct_v``."""
    params = [(W.detach(), b.detach()) for W, b in params]
    return reverse_plain(params, X, round_bf16, jet.saved, jet.final, ct)


def linear_sums_plain(params, X, coef, activation: str, no_lap: bool = False,
                      dot_dtype: str = "float32"):
    """Plain version of the linear sums kernel: ``[sum r, sum r^2, sum
    (e1 net)^2, sum e2 net]``; ``no_lap`` drops the ``a`` column.
    ``dot_dtype='bfloat16'``: the kernel's bf16-dot variant."""
    d = X.shape[1]
    with torch.no_grad():
        jet = (_swept_jet(params, X, activation) if dot_dtype == "bfloat16"
               else mlp_fwdlap(params, X, activation))
        r = _linear_r(jet, coef, d, no_lap)
        v, e1, e2 = jet.value, coef[:, d + 3], coef[:, d + 4]
        return torch.stack([torch.sum(r), torch.sum(r * r),
                            torch.sum((e1 * v) ** 2), torch.sum(e2 * v)])


def linear_seeded_plain(params, X, coef, scal, activation: str,
                        no_lap: bool = False, dot_dtype: str = "float32"):
    """Plain version of the linear seeded kernel: ``(dWs, dbs, sums)`` with
    the gradients of ``s_r sum r + s_q sum (e1 net)^2 + s_l sum e2 net``
    and ``sums = [sum ct_v]``, ``ct_v = s_r c + 2 s_q e1^2 net + s_l e2``.
    ``dot_dtype='bfloat16'``: the kernel's bf16-dot variant."""
    d = X.shape[1]
    s_r, s_q, s_l = scal[0], scal[1], scal[2]
    e1, e2 = coef[:, d + 3], coef[:, d + 4]
    if dot_dtype == "bfloat16":
        jet = _swept_jet(params, X, activation)
        ctv = s_r * coef[:, 0] + s_q * 2.0 * e1 * e1 * jet.value + s_l * e2
        ctl = torch.zeros_like(ctv) if no_lap else s_r * coef[:, d + 1]
        ct = torch.cat([ctv[:, None], s_r * coef[:, 1:1 + d], ctl[:, None]], dim=1)
        dWs, dbs = _swept_grads(params, X, jet, ct)
        return dWs, dbs, torch.sum(ctv).reshape(1)
    with torch.enable_grad():
        leaves = _leaves(params)
        jet = mlp_fwdlap(leaves, X, activation)
        v = jet.value
        obj = (s_r * torch.sum(_linear_r(jet, coef, d, no_lap))
               + s_q * torch.sum((e1 * v) ** 2) + s_l * torch.sum(e2 * v))
        dWs, dbs = _grads_of(obj, leaves)
    ctv = s_r * coef[:, 0] + s_q * 2.0 * e1 * e1 * v.detach() + s_l * e2
    return dWs, dbs, torch.sum(ctv).reshape(1)


def _quad_terms(jet, coef, d):
    B, dB, f, V = coef[:, 0], coef[:, 1:1 + d], coef[:, d + 1], coef[:, d + 2]
    u = B * jet.value
    G = B[:, None] * jet.grad + dB * jet.value[:, None]
    return 0.5 * torch.sum(G * G, dim=1) - f * u + V * u * u, u


def quad_sums_plain(params, X, coef, activation: str, dot_dtype: str = "float32"):
    """Plain version of the quadratic sums kernel: ``[sum e, sum u^2]``.
    ``dot_dtype='bfloat16'``: the kernel's bf16-dot variant."""
    d = X.shape[1]
    with torch.no_grad():
        jet = (_swept_jet(params, X, activation) if dot_dtype == "bfloat16"
               else mlp_fwdlap(params, X, activation))
        e, u = _quad_terms(jet, coef, d)
        return torch.stack([torch.sum(e), torch.sum(u * u)])


def _quad_ct(coef, scal, value, grad, d):
    """The quadratic seeded kernel's per-point cotangents ``(ct_v, ct_g)``."""
    s_e, s_q = scal[0], scal[1]
    B, dB, f, V = coef[:, 0], coef[:, 1:1 + d], coef[:, d + 1], coef[:, d + 2]
    G = B[:, None] * grad + dB * value[:, None]
    ctv = (s_e * (torch.sum(G * dB, dim=1) - f * B + 2.0 * V * B * value * B)
           + s_q * 2.0 * B * B * value)
    return ctv, s_e * G * B[:, None]


def quad_seeded_plain(params, X, coef, scal, activation: str, dot_dtype: str = "float32"):
    """Plain version of the quadratic seeded kernel: gradients of ``s_e sum
    e + s_q sum u^2`` and ``sums = [sum ct_v]`` (``ct_v`` = its derivative
    in the net's value).  ``dot_dtype='bfloat16'``: the kernel's bf16-dot
    variant."""
    d = X.shape[1]
    s_e, s_q = scal[0], scal[1]
    if dot_dtype == "bfloat16":
        jet = _swept_jet(params, X, activation)
        ctv, ctg = _quad_ct(coef, scal, jet.value, jet.grad, d)
        ct = torch.cat([ctv[:, None], ctg, torch.zeros_like(ctv)[:, None]], dim=1)
        dWs, dbs = _swept_grads(params, X, jet, ct)
        return dWs, dbs, torch.sum(ctv).reshape(1)
    with torch.enable_grad():
        leaves = _leaves(params)
        jet = mlp_fwdlap(leaves, X, activation)
        e, u = _quad_terms(jet, coef, d)
        dWs, dbs = _grads_of(s_e * torch.sum(e) + s_q * torch.sum(u * u), leaves)
    ctv, _ = _quad_ct(coef, scal, jet.value.detach(), jet.grad.detach(), d)
    return dWs, dbs, torch.sum(ctv).reshape(1)


# ------------------------------------------------------------ CUDA launcher
def smem_floats(kind: str, layers, T: int, lap: int, flags: int = 0) -> int:
    """Shared-memory floats per block for a tile of T points (the layout of
    fused_quotient.cu's quotient_body, mirrored from its smem_floats)."""
    seeded = kind.endswith("seeded")
    d = layers[0]
    S, wmax = d + 1 + lap, _cuda.padded_wmax(layers)
    stage, hid = S * T * wmax, _plan.hidden_floats(layers)
    n = 2 * _NSUMS[kind] * T + (3 if seeded else 2) * stage
    if not flags & _plan.DEV_WEIGHTS:
        n += hid if flags & _plan.RES_WEIGHTS else wmax * wmax
    if seeded and flags & _plan.RES_WEIGHTS:
        n += hid
    if seeded and flags & _plan.RES_GRAD:
        n += _plan.row_floats(layers)
    nc = d + 5 if kind.startswith("linear") else d + 3
    return (n + T * (nc | 1) + T * d + ((d + 2) * T if seeded else 0) + S * T
            + _cuda.NT + 4)


def plan(kind: str, layers, lap: int = 0, *, T: int | None = None,
         tier: str | None = None, design: int | None = None,
         blocks: int = _plan.FWD_BLOCKS, N: int | None = None, sms: int = 132) -> _plan.Plan:
    """The launch shape of one kernel over its layout (``d + 1 + lap``
    streams).  The seeded kinds (pass B) take the shared plan of
    :mod:`._plan` on the core's routines (``design`` 0, or ``DES_DEVW`` for
    the weights from device memory), with ``DES_BEYOND`` added for the nets
    of :func:`._cuda.beyond` and only for them; the sums kinds (pass A) the
    planned design of the forward-only kernels (:func:`._plan.forward_only`,
    for N points on a card of ``sms`` SMs: ``design`` pins its design,
    ``blocks`` caps its blocks per SM), which takes such nets as it is.
    ``T`` and ``tier`` pin a choice and raise if it does not fit; a net
    whose stages fit no tile of 4 points raises :class:`._plan.NoFit`."""
    S = layers[0] + 1 + lap
    if kind.endswith("sums"):
        return _plan.forward_only(lambda t, flags: smem_floats(kind, layers, t, lap, flags),
                                  layers, S, f"{kind} plan", N, sms, design=design, T=T,
                                  tier=tier, blocks=blocks)
    beyond = _cuda.DES_BEYOND if _cuda.beyond(layers) else 0
    if design not in (None, beyond, _cuda.DES_DEVW | beyond):
        raise ValueError(f"{kind} plan: design {design} is not the core's ({beyond}) or "
                         f"{_cuda.DES_DEVW | beyond} (the weights from device memory); "
                         f"DES_BEYOND ({_cuda.DES_BEYOND}) is for the nets beyond the other "
                         f"kernels' limits, and only they take it (layers {list(layers)})")
    pl = _plan.plan(lambda t, flags: smem_floats(kind, layers, t, lap, flags), layers,
                    S, True, T=T, tier=tier, what=f"{kind} plan",
                    device=None if design is None else bool(design & _cuda.DES_DEVW))
    return pl._replace(design=pl.design | beyond)


def _launch(kind: str, params, X, coef, scal, activation: str, lap: int, *,
            flat=None, pl: _plan.Plan | None = None, bf16: bool = False):
    """Launch one quotient kernel plus its reduction; returns the flat
    float32 row: the sums, or ``[grads (P) | sum ct_v, ...]``.  ``flat``:
    the parameters already flattened by :func:`._cuda.flat_params`; ``pl``:
    a launch shape other than the plan's own (timing sweeps, tests).
    ``bf16``: the bf16-dot mode, which runs the tensor-core design
    (``DES_MMA``, :func:`.fused_step.mma_plan`) and only it."""
    if bf16:
        return _launch_mma(kind, params, X, coef, scal, activation, lap, flat=flat, pl=pl)
    from . import _build

    lib = _build.load()
    seeded = kind.endswith("seeded")
    layers = _cuda.net_layers(kind, params, X, activation,
                              (coef, scal) if seeded else (coef,))
    N, d = X.shape
    K = len(params)
    X, coef = X.contiguous(), coef.contiguous()
    if flat is None:
        flat = _cuda.flat_params(params)
    dev = X.device
    if pl is None:
        sms = _cuda.sm_count(dev)
        n = N if not seeded else None       # pass B's plan is by net alone
        pl = _plan.cached(("quotient", kind, tuple(layers), lap, n, sms),
                          lambda: plan(kind, layers, lap, N=n, sms=sms))
    T = pl.T
    code = _KINDS[kind]
    fold, key = variant(layers, d + 1 + lap, pl)
    G = _cuda.grid(kind,
                   lambda sm, ptr: lib.fused_quotient_blocks_per_sm(code, fold, pl.design,
                                                                    pl.blocks, sm, ptr),
                   pl.smem, dev, (N + T - 1) // T, (key, pl.blocks) if pl.blocks else key)
    row = flat.numel() + 1 if seeded else _NSUMS[kind]
    partial = torch.empty((G, row), dtype=torch.float32, device=dev)
    out = torch.empty((row,), dtype=torch.float32, device=dev)
    scratch = None
    if seeded:
        scal = scal.contiguous()
        S, wmax = d + 1 + lap, _cuda.padded_wmax(layers)
        scratch = torch.empty((G, max(K - 2, 1) * S * T * wmax), dtype=torch.float32,
                              device=dev)
    lay = _cuda.layers_arg(layers)
    wd = (_cuda.device_weights(params, seeded) if pl.design & _cuda.DES_DEVW else None)
    _cuda.launch(kind, lib.fused_quotient_f32, code, lap, X.data_ptr(),
                 coef.data_ptr(), flat.data_ptr(),
                 scal.data_ptr() if seeded else None, ctypes.addressof(lay),
                 len(layers), _cuda.ACTS[activation], N, T, G, pl.flags, fold, pl.design,
                 pl.blocks, partial.data_ptr(),
                 scratch.data_ptr() if seeded else None, out.data_ptr(), pl.smem,
                 _cuda.stream(dev), None if wd is None else wd.data_ptr(), dev=dev,
                 keep=(X, coef, flat, wd, scal, lay, partial, scratch, out))
    return out


def _launch_mma(kind: str, params, X, coef, scal, activation: str, lap: int, *,
                flat=None, pl: _plan.Plan | None = None):
    """The bf16-dot mode of one quotient kernel (``csrc/fused_quotient_mma.cu``)
    plus its reduction: the sums, or ``[grads (P) | sum ct_v, 0, 0]``."""
    from . import _build

    lib = _build.load()
    name = kind + ".bf16"
    seeded = kind.endswith("seeded")
    layers = _cuda.net_layers(name, params, X, activation,
                              (coef, scal) if seeded else (coef,))
    N = X.shape[0]
    X, coef = X.contiguous(), coef.contiguous()
    if flat is None:
        flat = _cuda.flat_params(params)
    dev = X.device
    if pl is None:
        pl = _plan.cached(("quotient", kind, tuple(layers), lap, True),
                          lambda: mma_plan(kind, layers, lap=lap))
    if pl.design != _cuda.DES_MMA:
        raise ValueError(f"{kind}: the bf16-dot mode runs the tensor-core design and only it "
                         f"(design={pl.design})")
    T, code = pl.T, _KINDS[kind]
    design = mma_des(layers, pl.flags)
    G = _cuda.grid(name,
                   lambda sm, ptr: lib.fused_quotient_mma_blocks_per_sm(code, lap, design, sm,
                                                                        ptr),
                   pl.smem, dev, (N + T - 1) // T, (design << 1) | lap)
    row = flat.numel() + 3 if seeded else _NSUMS[kind]
    partial = torch.empty((G, row), dtype=torch.float32, device=dev)
    out = torch.empty((row,), dtype=torch.float32, device=dev)
    per_block = mma_scratch_floats(layers, T, kind, pl.flags, lap)
    scratch = (torch.empty((G, per_block), dtype=torch.float32, device=dev) if per_block
               else None)
    if seeded:
        scal = scal.contiguous()
    lay = _cuda.layers_arg(layers)
    _cuda.launch(name, lib.fused_quotient_mma_f32, code, lap, X.data_ptr(), coef.data_ptr(),
                 flat.data_ptr(), scal.data_ptr() if seeded else None, ctypes.addressof(lay),
                 len(layers), _cuda.ACTS[activation], N, T, G, pl.flags, design,
                 partial.data_ptr(), None if scratch is None else scratch.data_ptr(),
                 out.data_ptr(), pl.smem, _cuda.stream(dev), dev=dev,
                 keep=(X, coef, flat, scal, lay, partial, scratch, out))
    return out


def _views(flat, params):
    """``params``' ``(W, b)`` pairs as views of the flat vector."""
    out, o = [], 0
    for W, b in params:
        Wv = flat[o:o + W.numel()].view(W.shape)
        o += W.numel()
        out.append((Wv, flat[o:o + b.numel()].view(b.shape)))
        o += b.numel()
    return out


def _scalars(values, X):
    """The pass-B seeds as one vector on X's device: tensors stay on the
    device (no host sync); numbers are filled in there."""
    return torch.stack([
        v.to(dtype=X.dtype, device=X.device).reshape(()) if torch.is_tensor(v)
        else torch.full((), float(v), dtype=X.dtype, device=X.device)
        for v in values])


def _seeded_grads(params, dWs, dbs, sums):
    """The JAX raw API's layout: the last bias gradient is sum ct_v."""
    grads = [(dW, db) for dW, db in zip(dWs[:-1], dbs[:-1])]
    grads.append((dWs[-1], sums[0].reshape(params[-1][1].shape)))
    return grads


# ------------------------------------------------------------------- raw API
def fused_linear_sums(params, X, coef, activation: str, *, no_lap: bool = False,
                      dot_dtype: str = "float32", flat=None):
    """Pass A: ``{'sum_r', 'sum_r2', 'sum_mass', 'sum_e2', 'n'}``.
    ``no_lap=True`` drops the Laplacian stream: only valid when the ``a``
    column is identically zero (the WAN weak forms).  ``flat``: ``params``
    already flattened (``[W0, b0, W1, b1, ...]``); the values are then read
    from it and ``params`` gives the shapes.  ``dot_dtype``: ``'float32'``,
    ``'bf16x3'`` or ``'bfloat16'`` (the bf16-dot mode)."""
    _check_dot(dot_dtype)
    _check_coef(X, coef, X.shape[1] + 5)
    if _on_cuda(X):
        s = _launch("linear_sums", params, X, coef, None, activation, 0 if no_lap else 1,
                    flat=flat, bf16=dot_dtype == "bfloat16")
    else:
        if flat is not None:
            params = _views(flat, params)
        s = linear_sums_plain(params, X, coef, activation, no_lap, dot_dtype)
    return {"sum_r": s[0], "sum_r2": s[1], "sum_mass": s[2], "sum_e2": s[3],
            "n": X.shape[0]}


def fused_seeded_grads(params, X, coef, scalars, activation: str, *,
                       no_lap: bool = False, dot_dtype: str = "float32", flat=None):
    """Pass B: grads of ``s_r*sum r + s_q*sum (e1 v)^2 + s_l*sum e2 v`` for
    ``scalars = (s_r, s_q, s_l)`` (already holding every 1/N and chain
    factor), in the params layout.  ``flat`` and ``dot_dtype`` as in
    :func:`fused_linear_sums`."""
    _check_dot(dot_dtype)
    _check_coef(X, coef, X.shape[1] + 5)
    scal = _scalars(scalars, X)
    if _on_cuda(X):
        params = [(W.detach(), b.detach()) for W, b in params]
        out = _launch("linear_seeded", params, X, coef, scal, activation,
                      0 if no_lap else 1, flat=flat, bf16=dot_dtype == "bfloat16")
        dWs, dbs, sums = _unflatten(params, out)
    else:
        if flat is not None:
            params = _views(flat, params)
        dWs, dbs, sums = linear_seeded_plain(params, X, coef, scal, activation, no_lap,
                                             dot_dtype)
    return _seeded_grads(params, dWs, dbs, sums)


def fused_quad_sums(params, X, coef, activation: str, *, dot_dtype: str = "float32",
                    flat=None):
    """Pass A (quadratic): ``{'sum_e', 'sum_u2', 'n'}``.  ``flat`` and
    ``dot_dtype`` as in :func:`fused_linear_sums`."""
    _check_dot(dot_dtype)
    _check_coef(X, coef, X.shape[1] + 3)
    if _on_cuda(X):
        s = _launch("quad_sums", params, X, coef, None, activation, 0, flat=flat,
                    bf16=dot_dtype == "bfloat16")
    else:
        if flat is not None:
            params = _views(flat, params)
        s = quad_sums_plain(params, X, coef, activation, dot_dtype)
    return {"sum_e": s[0], "sum_u2": s[1], "n": X.shape[0]}


def fused_quad_seeded_grads(params, X, coef, scalars, activation: str, *,
                            dot_dtype: str = "float32", flat=None):
    """Pass B (quadratic): grads of ``s_e*sum e + s_q*sum u^2`` for
    ``scalars = (s_e, s_q)``.  ``flat`` and ``dot_dtype`` as in
    :func:`fused_linear_sums`."""
    _check_dot(dot_dtype)
    _check_coef(X, coef, X.shape[1] + 3)
    scal = _scalars(scalars, X)
    if _on_cuda(X):
        params = [(W.detach(), b.detach()) for W, b in params]
        out = _launch("quad_seeded", params, X, coef, scal, activation, 0, flat=flat,
                      bf16=dot_dtype == "bfloat16")
        dWs, dbs, sums = _unflatten(params, out)
    else:
        if flat is not None:
            params = _views(flat, params)
        dWs, dbs, sums = quad_seeded_plain(params, X, coef, scal, activation, dot_dtype)
    return _seeded_grads(params, dWs, dbs, sums)


# ----------------------------------------------------- autograd objectives
def _pairs(leaves):
    return [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]


def _flat_grads(grads):
    return tuple(g for pair in grads for g in pair)


def _check_axis(axis) -> None:
    """``axis`` names the ranks a quotient is summed over: ``None`` (this
    process) or a ``torch.distributed`` process group, such as
    ``parallel.Mesh.group("data")``.  A mesh axis *name* has no meaning
    outside a mesh and raises."""
    if axis is not None and not isinstance(axis, dist.ProcessGroup):
        raise TypeError(f"axis={axis!r}: pass a torch.distributed process group "
                        "(parallel.Mesh.group(name)) or None, not a mesh axis name")


def _global_sums(s, axis):
    """The pass-A sums over every rank of the process group ``axis`` (None:
    this process alone): all-reduced in float64 in one collective before
    the quotient is formed, returned in their own dtype, with ``n`` scaled
    by the group's size (equal shards, as
    :func:`nnpde_tpu_torch.parallel.shard_batch` makes them).  Sums only:
    the caller differentiates nothing through the collective, so nothing
    is counted twice."""
    if axis is None:
        return s
    keys = [k for k in s if k != "n"]
    flat = torch.cat([s[k].reshape(-1).to(torch.float64) for k in keys])
    dist.all_reduce(flat, group=axis)
    out, o = {}, 0
    for k in keys:
        v = s[k]
        out[k] = flat[o:o + v.numel()].view(v.shape).to(v.dtype)
        o += v.numel()
    out["n"] = s["n"] * dist.get_world_size(axis)
    return out


def _global_grads(grads, axis):
    """The pass-B gradients summed over the ranks of ``axis`` in one
    collective: the seeds already carry the global 1/n, so the plain sum
    of the shards' gradient sums is the gradient of the global objective."""
    if axis is None:
        return grads
    flat = torch.cat([t.reshape(-1) for pair in grads for t in pair])
    dist.all_reduce(flat, group=axis)
    out, o = [], 0
    for W, b in grads:
        Wr = flat[o:o + W.numel()].view(W.shape)
        o += W.numel()
        out.append((Wr, flat[o:o + b.numel()].view(b.shape)))
        o += b.numel()
    return out


def _wan_dp(convention, wr, pn, eps):
    """(p, dp/dwr, dp/dpn) for the two reference conventions."""
    if convention == "wr2_over_norm":
        den = pn + eps
        return wr * wr / den, 2.0 * wr / den, -(wr * wr) / (den * den)
    if convention == "ratio_sq":
        den = pn + eps
        return ((wr / den) ** 2, 2.0 * wr / (den * den),
                -2.0 * wr * wr / (den ** 3))
    raise ValueError(f"Unknown WAN convention {convention!r}")


class _Rayleigh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, X, coef, *leaves):
        activation, weight, den_eps, dot, axis = cfg
        flat = _cuda.flat_params(_pairs(leaves))     # built once, reused by backward
        s = _global_sums(fused_quad_sums(_pairs(leaves), X, coef, activation, dot_dtype=dot,
                                         flat=flat), axis)
        n = s["n"]
        num, den = s["sum_e"] / n, s["sum_u2"] / n
        q = num / (den + den_eps)
        ctx.cfg, ctx.n = cfg, n
        ctx.save_for_backward(X, coef, num, den, flat, *leaves)
        ctx.mark_non_differentiable(q, num, den)
        return weight * q, q, num, den

    @staticmethod
    def backward(ctx, g, *_):
        activation, weight, den_eps, dot, axis = ctx.cfg
        X, coef, num, den, flat, *leaves = ctx.saved_tensors
        g = g * weight
        s_e = g / ((den + den_eps) * ctx.n)
        s_q = -g * num / ((den + den_eps) ** 2 * ctx.n)
        grads = _global_grads(fused_quad_seeded_grads(_pairs(leaves), X, coef, (s_e, s_q),
                                                      activation, dot_dtype=dot, flat=flat),
                              axis)
        return (None, None, None) + _flat_grads(grads)


def make_fused_rayleigh(activation: str, *, weight: float = 1.0,
                        den_eps: float = 0.0, axis=None,
                        dot_dtype: str = "float32"):
    """Fused eigen-DRM Rayleigh quotient: ``loss(params, X, coef) -> (loss,
    aux)`` with ``loss = weight * mean(e) / (mean(u^2) + den_eps)``, ``e``
    from :func:`quotient_coefficients`; ``aux`` holds ``rayleigh`` (the
    unweighted quotient), ``mean_e`` and ``mean_u2``."""
    _check_axis(axis)
    _check_dot(dot_dtype)
    cfg = (activation, weight, den_eps, dot_dtype, axis)

    def loss(params, X, coef):
        total, q, num, den = _Rayleigh.apply(cfg, X, coef,
                                             *[t for pair in params for t in pair])
        return total, {"rayleigh": q, "mean_e": num, "mean_u2": den}

    return loss


class _QuadMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, X, coef, *leaves):
        activation, weight, dot, axis = cfg
        flat = _cuda.flat_params(_pairs(leaves))     # built once, reused by backward
        s = _global_sums(fused_quad_sums(_pairs(leaves), X, coef, activation, dot_dtype=dot,
                                         flat=flat), axis)
        n = s["n"]
        mean_e, mean_u2 = s["sum_e"] / n, s["sum_u2"] / n
        ctx.cfg, ctx.n = cfg, n
        ctx.save_for_backward(X, coef, flat, *leaves)
        ctx.mark_non_differentiable(mean_e, mean_u2)
        return weight * mean_e, mean_e, mean_u2

    @staticmethod
    def backward(ctx, g, *_):
        activation, weight, dot, axis = ctx.cfg
        X, coef, flat, *leaves = ctx.saved_tensors
        s_e = g * weight / ctx.n
        grads = _global_grads(fused_quad_seeded_grads(_pairs(leaves), X, coef,
                                                      (s_e, torch.zeros_like(s_e)), activation,
                                                      dot_dtype=dot, flat=flat), axis)
        return (None, None, None) + _flat_grads(grads)


def make_fused_quad_mean(activation: str, *, weight: float = 1.0, axis=None,
                         dot_dtype: str = "float32"):
    """Fused quadratic-energy mean: ``loss(params, X, coef) = weight *
    mean(1/2|grad u|^2 - f u + V u^2)``, e.g. the Poisson WAN critic's
    ``mean(|grad v|^2 + v^2)`` with ``V = 1/2`` and ``weight = 2*reg``;
    ``aux`` holds ``mean_e`` and ``mean_u2``."""
    _check_axis(axis)
    _check_dot(dot_dtype)
    cfg = (activation, weight, dot_dtype, axis)

    def loss(params, X, coef):
        total, mean_e, mean_u2 = _QuadMean.apply(cfg, X, coef,
                                                 *[t for pair in params for t in pair])
        return total, {"mean_e": mean_e, "mean_u2": mean_u2}

    return loss


class _WanU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, E, X, base, phi_norm, *leaves):
        activation, convention, eps, vol, w_pde, w_norm, dot, axis = cfg
        d = X.shape[1]
        # the trainable eigenvalue enters as c -= E * e2 (e2 = B*phi)
        coef = torch.cat([(base[:, 0] - E * base[:, d + 4])[:, None], base[:, 1:]], dim=1)
        # the weak form has no Laplacian term (a == 0 by the contract)
        flat = _cuda.flat_params(_pairs(leaves))     # built once, reused by backward
        s = _global_sums(fused_linear_sums(_pairs(leaves), X, coef, activation, no_lap=True,
                                           dot_dtype=dot, flat=flat), axis)
        n = s["n"]
        wr, mu2 = s["sum_r"] / n, s["sum_mass"] / n
        p, _, _ = _wan_dp(convention, wr, phi_norm, eps)
        norm_term = (vol * mu2 - 1.0) ** 2
        total = w_pde * p + w_norm * norm_term
        ctx.cfg, ctx.n = cfg, n
        ctx.save_for_backward(X, coef, wr, mu2, phi_norm, s["sum_e2"], flat, *leaves)
        ctx.mark_non_differentiable(wr, p, norm_term, mu2)
        return total, wr, p, norm_term, mu2

    @staticmethod
    def backward(ctx, g, *_):
        activation, convention, eps, vol, w_pde, w_norm, dot, axis = ctx.cfg
        X, coef, wr, mu2, phi_norm, sum_uphi, flat, *leaves = ctx.saved_tensors
        n = ctx.n
        _, dp_dwr, dp_dpn = _wan_dp(convention, wr, phi_norm, eps)
        s_r = g * w_pde * dp_dwr / n
        s_q = g * w_norm * 2.0 * (vol * mu2 - 1.0) * vol / n
        grads = (None,) * len(leaves)
        if any(ctx.needs_input_grad[5:]):
            grads = _flat_grads(_global_grads(fused_seeded_grads(
                _pairs(leaves), X, coef, (s_r, s_q, torch.zeros_like(s_r)),
                activation, no_lap=True, dot_dtype=dot, flat=flat), axis))
        # dwr/dE = -(1/n) sum u*phi (the e2 lane)
        dE = g * w_pde * dp_dwr * (-sum_uphi / n)
        d_pn = g * w_pde * dp_dpn
        return (None, dE, None, None, d_pn) + grads


def make_fused_wan_u(activation: str, *, convention: str = "wr2_over_norm",
                     eps: float = 1e-8, vol: float = 1.0, w_pde: float = 1.0,
                     w_norm: float = 0.0, axis=None, dot_dtype: str = "float32"):
    """Fused WAN primal objective: ``loss(params, E, X, base, phi_norm) ->
    (loss, aux)`` with ``loss = w_pde * p + w_norm * (vol*mean(u^2) - 1)^2``
    and ``p`` the convention's ``wan_pde_loss`` of the weak residual.

    ``base`` is :func:`linear_functional_coefficients` built with E = 0
    (``e1 = B``, ``e2 = B*phi``); ``E`` (a 0-d tensor) is folded in as
    ``c -= E*e2`` so it stays differentiable; ``phi_norm = mean(phi^2)`` is
    computed outside.  Gradients flow to ``params``, ``E`` and
    ``phi_norm``."""
    _check_axis(axis)
    _check_dot(dot_dtype)
    _wan_dp(convention, 0.0, 1.0, eps)
    cfg = (activation, convention, eps, vol, w_pde, w_norm, dot_dtype, axis)

    def loss(params, E, X, base, phi_norm):
        E = torch.as_tensor(E, dtype=X.dtype, device=X.device)
        total, wr, p, norm_term, mu2 = _WanU.apply(
            cfg, E, X, base, phi_norm, *[t for pair in params for t in pair])
        return total, {"weak_residual": wr, "pde_loss": p, "norm": norm_term,
                       "mean_u2": mu2, "phi_norm": phi_norm}

    return loss


class _WanV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, X, coef, *leaves):
        activation, convention, eps, objective, log_eps, dot, axis = cfg
        flat = _cuda.flat_params(_pairs(leaves))     # built once, reused by backward
        s = _global_sums(fused_linear_sums(_pairs(leaves), X, coef, activation, no_lap=True,
                                           dot_dtype=dot, flat=flat), axis)
        n = s["n"]
        wr, pn = s["sum_r"] / n, s["sum_mass"] / n
        p, _, _ = _wan_dp(convention, wr, pn, eps)
        val = -torch.log(p + log_eps) if objective == "neg_log" else -p
        ctx.cfg, ctx.n = cfg, n
        ctx.save_for_backward(X, coef, wr, pn, p, flat, *leaves)
        ctx.mark_non_differentiable(wr, p, pn)
        return val, wr, p, pn

    @staticmethod
    def backward(ctx, g, *_):
        activation, convention, eps, objective, log_eps, dot, axis = ctx.cfg
        X, coef, wr, pn, p, flat, *leaves = ctx.saved_tensors
        _, dp_dwr, dp_dpn = _wan_dp(convention, wr, pn, eps)
        outer = -g / (p + log_eps) if objective == "neg_log" else -g
        s_r = outer * dp_dwr / ctx.n
        s_q = outer * dp_dpn / ctx.n
        grads = _global_grads(fused_seeded_grads(_pairs(leaves), X, coef,
                                                 (s_r, s_q, torch.zeros_like(s_r)), activation,
                                                 no_lap=True, dot_dtype=dot, flat=flat), axis)
        return (None, None, None) + _flat_grads(grads)


def make_fused_wan_v(activation: str, *, convention: str = "wr2_over_norm",
                     eps: float = 1e-8, objective: str = "neg_log",
                     log_eps: float = 1e-8, axis=None, dot_dtype: str = "float32"):
    """Fused WAN critic objective: ``loss_v(params, X, coef) -> (loss_v,
    aux)``; ``coef`` is :func:`linear_functional_coefficients` over the
    critic net with the bump as its factor and ``e1 = w`` (the mass lane is
    ``sum phi^2``).  ``objective='neg_log'``: ``-log(p + log_eps)``;
    ``'neg'``: ``-p``.  Gradients flow to ``params``."""
    if objective not in ("neg_log", "neg"):
        raise ValueError(f"Unknown critic objective {objective!r}")
    _check_axis(axis)
    _check_dot(dot_dtype)
    _wan_dp(convention, 0.0, 1.0, eps)
    cfg = (activation, convention, eps, objective, log_eps, dot_dtype, axis)

    def loss_v(params, X, coef):
        val, wr, p, pn = _WanV.apply(cfg, X, coef,
                                     *[t for pair in params for t in pair])
        return val, {"weak_residual": wr, "pde_loss": p, "phi_norm": pn}

    return loss_v
