"""The jet of a raw MLP as CUDA kernels, forward and backward.

Counterpart of ``nnpde_tpu/kernels/fwdlap_pallas.py::mlp_fwdlap_pallas``:
``(u, grad u, lap u)`` of the net at every point, the forward-Laplacian
recurrence kept on chip, differentiable in the parameters.

* forward, ``fwd_impl='rows'`` (the default; JAX ``'pallas2'``,
  ``_forward_kernel2``): ``csrc/fwdlap_forward.cu`` writes the ``(N, d+2)``
  jet rows, in fp32 in the planned design of ``csrc/fwdlap_planned.cuh``
  on the plan of :func:`forward_plan` (by net and N);
* forward, ``fwd_impl='streams'`` (JAX ``'pallas'``, ``_forward_kernel``):
  the same planned kernel on the same plan, with its stream-major write:
  ``(d+2, N)`` with each stream contiguous; the wrapper returns the
  ``(N, d+2)`` view;
* backward (``_backward_kernel``): ``csrc/fwdlap_backward.cu`` recomputes
  the recurrence per tile and reverse-sweeps from the ``(N, d+2)`` cotangent
  stream to dW/db, launched as :func:`backward_plan` says (the planned
  design of ``csrc/fwdlap_planned.cuh`` in fp32).  The last bias's gradient
  is ``sum ct[:, 0]``, formed here; the points get no gradient.

Two reduced-precision modes, independent of each other as in JAX (the
arguments of ``mlp_fwdlap_pallas`` and ``SolutionModel.fields``, which
take either alone; the ``hybrid-kernel`` bulk of ``train_poisson_nd``
sets both):

* ``fwd_impl='rows:default'`` (JAX ``'pallas2:default'``, whose single-pass
  dots round every operand to bf16 on the TPU): the row forward's bf16-dot
  variant, every product operand rounded to bf16, fp32 accumulation; the
  Jacobian seed rows and the projection on the last layer's row stay fp32.
  ``'streams'`` has no such mode (JAX ``_forward_kernel`` runs HIGHEST), so
  ``'streams:default'`` raises;
* ``dot_dtype='bfloat16'``: the backward's bf16-dot variant (recompute and
  reverse sweep); ``'bf16x3'`` (JAX's three-pass split, float32-class) the
  float32 backward.

Both bf16-dot variants run on the card's bf16 tensor cores, in the design
of ``csrc/fwdlap_mma.cuh`` (``DES_MMA``) on the plan of
:func:`.fused_step.mma_plan` (kinds ``'fwdlap_forward'`` and
``'fwdlap_backward'``), and only there; the fp32 modes run a planned design,
and a plan of the other mode's design raises.

A CUDA tensor goes to the kernels (float32; anything else raises), a CPU
tensor to the plain versions: :func:`fwdlap_forward_plain`, which is
:func:`~nnpde_tpu_torch.ops.fwdlap.mlp_fwdlap`, and
:func:`fwdlap_backward_plain`, autograd through it; in the bf16-dot modes
:func:`fwdlap_forward_default_plain` and ``fwdlap_backward_plain(...,
dot_dtype='bfloat16')``, the kernels' per-tile arithmetic written out
(:func:`~nnpde_tpu_torch.ops.fwdlap.recompute_plain`).  The
TPU-only knobs of the JAX function (``tile``, ``bwd_tile``,
``lane_pack``, ``concat_streams``) have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.fwdlap import (SUM_ORDERS, Jet, contracted_stage, mlp_fwdlap, ordered_matmul,
                          project_plain, recompute_plain, reverse_plain, round_bf16)
from . import _cuda, _plan
from ._cuda import on_cuda as _on_cuda
from ._cuda import variant_name
from .fused_step import (_check_dot, _unflatten, mma_des, mma_plan, mma_scratch_floats,
                         planned, variant)

fwdlap_forward_plain = mlp_fwdlap

_FWD_IMPLS = ("rows", "rows:default", "streams")


def _jet_rows(jet: Jet) -> torch.Tensor:
    return torch.cat([jet.value[:, None], jet.grad, jet.lap[:, None]], dim=1)


# The plain version's other sound rounding orders (ROADMAP.md C4): each
# product's sums over k in SUM_ORDERS ("k": the k-ordered FMA chain of the
# kernel's products on the CUDA cores), and the stage's multiply-adds fused
# as the kernels compile them ("contracted").
ROUNDING_ORDERS = SUM_ORDERS + ("contracted",)


def fwdlap_forward_default_plain(params, X, activation: str, order: str | None = None):
    """Plain version of the row forward's bf16-dot variant
    (``fwd_impl='rows:default'``): the ``(N, d+2)`` rows of the recompute
    with every product operand rounded to bf16, projected in fp32.
    ``order``: one of ``ROUNDING_ORDERS``, the same function rounded in
    another sound order (:func:`~nnpde_tpu_torch.ops.fwdlap.ordered_matmul`,
    :func:`~nnpde_tpu_torch.ops.fwdlap.contracted_stage`); their spread is
    the plain version's own rounding noise, the basis of row 4 bf16's bar
    (:func:`c4_columns`)."""
    if order is not None and order not in ROUNDING_ORDERS:
        raise ValueError(f"Unknown order {order!r}; one of {ROUNDING_ORDERS}")
    mm = ordered_matmul(order) if order in SUM_ORDERS else torch.matmul
    stage = contracted_stage if order == "contracted" else None
    _, final = recompute_plain(params, X, activation, round_bf16, mm, stage)
    value, grad, lap = project_plain(params, final)
    return torch.cat([value[:, None], grad, lap[:, None]], dim=1)


# The bar of row 4 bf16's jet columns (ROADMAP.md C4): the bf16 rounding of
# every stage makes a column's distance from the float64 witness a count of
# entries that round to the other bf16 neighbour, which any change of fp32
# rounding order moves by up to 10x either way.  The kernel may lie as far
# from the witness as the plain version does, and C4_SPREAD_MULTIPLE times
# the plain version's spread over ROUNDING_ORDERS beyond that.  Measured on
# an H100 at the 17 seeds of tools/fwd_bf16_columns.py --seeds on (1, 100 x
# 3, 1) tanh: (kernel - plain) / spread at most 0.66 (7.5 over the sum
# orders alone: the kernel is the plain version with its stage's
# multiply-adds fused, the "contracted" order, to within 0.2% at every
# seed); the multiple is 3x that, rounded.
C4_SPREAD_MULTIPLE = 2.0


def c4_columns(params, X, activation: str, out):
    """Per jet column of a bf16-dot forward result ``out`` (N, d+2) on
    ``(params, X)``, each as an rms over the column's mean magnitude: its
    distance from the float64 witness (``kernel``), the plain version's
    (``plain``), the plain version's spread (``spread``: the largest
    distance of a ``ROUNDING_ORDERS`` variant from it) and the bar in force:
    the larger of 2x ``plain`` + 2e-6 and ``plain`` + ``C4_SPREAD_MULTIPLE``
    x ``spread``."""
    p = fwdlap_forward_default_plain(params, X, activation).double()
    variants = [fwdlap_forward_default_plain(params, X, activation, o).double()
                for o in ROUNDING_ORDERS]
    w = fwdlap_forward_default_plain([(W.double(), b.double()) for W, b in params],
                                     X.double(), activation)
    k = out.double()
    rows = []
    for c in range(w.shape[1]):
        sc = float(w[:, c].abs().mean())

        def rms(a, b):
            return float((a[:, c] - b[:, c]).pow(2).mean().sqrt()) / sc

        row = {"column": c, "kernel": rms(k, w), "plain": rms(p, w),
               "spread": max(rms(v, p) for v in variants)}
        row["bar"] = max(2.0 * row["plain"] + 2e-6,
                         row["plain"] + C4_SPREAD_MULTIPLE * row["spread"])
        rows.append(row)
    return rows


def fwdlap_backward_plain(params, X, ct, activation: str, dot_dtype: str = "float32",
                          order=None):
    """Plain version of the backward kernel: ``(dWs, dbs)`` of ``sum(jet *
    ct)`` with ``jet`` the ``(N, d+2)`` rows ``[u, grad u, lap u]`` of
    :func:`~nnpde_tpu_torch.ops.fwdlap.mlp_fwdlap`, by autograd;
    ``dot_dtype='bfloat16'``: the bf16-dot variant's recompute and reverse
    sweep, every product operand rounded to bf16, the reverse
    nonlinearity's sum in ``order`` (``ops.fwdlap.DV_ORDERS``)."""
    if dot_dtype == "bfloat16":
        params = [(W.detach(), b.detach()) for W, b in params]
        saved, final = recompute_plain(params, X, activation, round_bf16)
        return reverse_plain(params, X, round_bf16, saved, final, ct, order)
    if order is not None:
        raise ValueError("order: the bf16-dot plain versions only")
    with torch.enable_grad():
        leaves = [(W.detach().requires_grad_(True), b.detach().requires_grad_(True))
                  for W, b in params]
        rows = _jet_rows(mlp_fwdlap(leaves, X, activation))
        flat = torch.autograd.grad(torch.sum(rows * ct), [t for pair in leaves for t in pair])
    return list(flat[0::2]), list(flat[1::2])


def forward_smem_floats(layers, T: int, flags: int = 0) -> int:
    """Shared-memory floats per block for a tile of T points: the planned
    jet forward's layout in either output layout (mirrored from
    fwdlap_forward.cu's fwd_smem_floats), residency ``flags`` of
    :mod:`._plan`."""
    d = layers[0]
    S, wmax = d + 2, _cuda.padded_wmax(layers)
    n = 2 * S * T * wmax
    if not flags & _plan.DEV_WEIGHTS:
        n += _plan.hidden_floats(layers) if flags & _plan.RES_WEIGHTS else wmax * wmax
    return n + T * d + S * T


def forward_plan(layers, design: int | None = None, *, N: int | None = None,
                 sms: int = 132, T: int | None = None, tier: str | None = None,
                 blocks: int = _plan.FWD_BLOCKS) -> _plan.Plan:
    """The fp32 jet forward's launch shape (both output layouts) for N
    points on a card of ``sms`` SMs: the planned design on
    :func:`._plan.forward_only`, ``d + 2`` streams.  (The bf16-dot
    variant's is :func:`.fused_step.mma_plan`.)"""
    return _plan.forward_only(lambda t, f: forward_smem_floats(layers, t, f), layers,
                              layers[0] + 2, "fwdlap_forward plan", N, sms, design=design,
                              T=T, tier=tier, blocks=blocks)


def backward_smem_floats(layers, T: int, flags: int = 0) -> int:
    """The same for fwdlap_backward.cu (mirrored from its bwd_smem_floats):
    residency ``flags`` of :mod:`._plan`."""
    d = layers[0]
    S, wmax = d + 2, _cuda.padded_wmax(layers)
    n = 3 * S * T * wmax
    if not flags & _plan.DEV_WEIGHTS:
        n += 2 * _plan.hidden_floats(layers) if flags & _plan.RES_WEIGHTS else wmax * wmax
    if flags & _plan.RES_GRAD:
        n += (_cuda.n_params(layers) + 3) // 4 * 4
    return n + T * d + S * T + _cuda.NT


def backward_plan(layers, design: int | None = None, *, T: int | None = None,
                  tier: str | None = None) -> _plan.Plan:
    """The backward's launch shape: fp32 a planned design
    (:func:`.fused_step.planned`, ``d + 2`` streams; any other design
    raises); ``DES_MMA`` the bf16-dot variant's tensor-core design
    (:func:`.fused_step.mma_plan`)."""
    if design == _cuda.DES_MMA:
        return mma_plan("fwdlap_backward", layers, T=T, tier=tier)
    return planned(lambda t, f: backward_smem_floats(layers, t, f), layers, layers[0] + 2,
                   "fwdlap_backward plan", design, T=T, tier=tier)


def fwdlap_forward(params, X, activation: str, fwd_impl: str = "rows", *,
                   pl: _plan.Plan | None = None) -> torch.Tensor:
    """Launch a jet-forward kernel: ``(N, d+2)`` float32 rows ``[u, grad_0 ..
    grad_{d-1}, lap]`` (with ``fwd_impl='streams'`` a view of the kernel's
    stream-major ``(d+2, N)`` output; ``'rows:default'``: the row kernel's
    bf16-dot variant).  ``'rows'`` and ``'streams'`` launch the planned
    design on the plan of :func:`forward_plan`, cached per shape,
    ``'rows:default'`` the tensor-core design on its
    :func:`.fused_step.mma_plan`, cached per net.  ``pl``: a launch shape
    (and design) other than the wrapper's own (timing sweeps, tests); a
    design of the other mode raises."""
    from . import _build

    streams = int(fwd_impl == "streams")
    bf16 = int(fwd_impl == "rows:default")
    name = variant_name("fwdlap_forward_streams" if streams else "fwdlap_forward", bf16)
    lib = _build.load()
    layers = _cuda.net_layers(name, params, X, activation)
    N, d = X.shape
    X = X.contiguous()
    flat = _cuda.flat_params(params)
    if pl is None and bf16:
        pl = _plan.cached(("fwdlap_forward", tuple(layers), bf16),
                          lambda: mma_plan("fwdlap_forward", layers))
    elif pl is None:
        sms = _cuda.sm_count(X.device)
        pl = _plan.cached(("fwdlap_forward", tuple(layers), N, sms),
                          lambda: forward_plan(layers, N=N, sms=sms))
    if bool(bf16) != (pl.design == _cuda.DES_MMA) or not (bf16 or
                                                         pl.design in _cuda.FP32_DESIGNS):
        raise ValueError(f"{name}: the bf16-dot variant runs the tensor-core design and only "
                         f"it; fp32 a planned design (bf16={bf16}, design={pl.design})")
    T = pl.T
    des = mma_des(layers, pl.flags) if bf16 else pl.design
    dev = X.device
    fold, key = variant(layers, d + 2, pl)
    G = _cuda.grid(name,
                   lambda sm, ptr: lib.fwdlap_forward_blocks_per_sm(streams, fold, bf16, des,
                                                                    pl.blocks, sm, ptr),
                   pl.smem, dev, (N + T - 1) // T, (key, pl.blocks) if pl.blocks else key)
    shape = (d + 2, N) if streams else (N, d + 2)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    lay = _cuda.layers_arg(layers)
    wd = (_cuda.device_weights(params, False) if pl.design & _cuda.DES_DEVW else None)
    _cuda.launch(name, lib.fwdlap_forward_f32, streams, X.data_ptr(), flat.data_ptr(),
                 ctypes.addressof(lay), len(layers), _cuda.ACTS[activation], N, T,
                 G, fold, bf16, des, pl.blocks, pl.flags, out.data_ptr(), pl.smem,
                 _cuda.stream(dev), None if wd is None else wd.data_ptr(), dev=dev,
                 keep=(X, flat, wd, lay, out))
    return out.t() if streams else out


def fwdlap_backward(params, X, ct, activation: str, dot_dtype: str = "float32", *,
                    pl: _plan.Plan | None = None):
    """Launch the recompute-backward kernel: ``(dWs, dbs)`` of ``sum(jet *
    ct)`` for the ``(N, d+2)`` cotangent ``ct``; the last bias's gradient,
    ``sum ct[:, 0]``, is formed here.  ``dot_dtype='bfloat16'``: the
    bf16-dot variant, on the tensor-core design (``DES_MMA``) and only it;
    fp32 a planned design.  ``pl``: a launch shape (and design) other than
    the wrapper's own (timing sweeps, tests); a design of the other mode
    raises."""
    from . import _build

    bf16 = int(dot_dtype == "bfloat16")
    name = variant_name("fwdlap_backward", bf16)
    lib = _build.load()
    layers = _cuda.net_layers(name, params, X, activation, (ct,))
    N, d = X.shape
    if ct.shape != (N, d + 2):
        raise ValueError(f"ct must be (N, d+2) = ({N}, {d + 2}), got {tuple(ct.shape)}")
    K = len(params)
    X, ct = X.contiguous(), ct.contiguous()
    flat = _cuda.flat_params(params)
    P = flat.numel()
    if pl is None:
        pl = _plan.cached(("fwdlap_backward", tuple(layers), bf16),
                          lambda: mma_plan("fwdlap_backward", layers) if bf16
                          else backward_plan(layers))
    mma = pl.design == _cuda.DES_MMA
    if bool(bf16) != mma or not (mma or pl.design in _cuda.FP32_DESIGNS):
        raise ValueError("fwdlap_backward: the bf16-dot variant runs the tensor-core design "
                         f"and only it; fp32 a planned design (bf16={bf16}, "
                         f"design={pl.design})")
    T = pl.T
    design = mma_des(layers, pl.flags) if mma else pl.design
    dev = X.device
    fold, key = variant(layers, d + 2, pl)
    G = _cuda.grid(name,
                   lambda sm, ptr: lib.fwdlap_backward_blocks_per_sm(fold, bf16, design, sm,
                                                                     ptr),
                   pl.smem, dev, (N + T - 1) // T, key)
    if mma:
        per_block = mma_scratch_floats(layers, T, "fwdlap_backward", pl.flags)
    else:
        per_block = max(K - 2, 1) * (d + 2) * T * _cuda.padded_wmax(layers)
    partial = torch.empty((G, P), dtype=torch.float32, device=dev)
    scratch = torch.empty((G, per_block), dtype=torch.float32, device=dev)
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    lay = _cuda.layers_arg(layers)
    wt = (None if mma else _cuda.device_weights(params, True) if design & _cuda.DES_DEVW
          else _cuda.hidden_transposes(params))
    _cuda.launch(name, lib.fwdlap_backward_f32, X.data_ptr(), ct.data_ptr(),
                 flat.data_ptr(), None if wt is None else wt.data_ptr(),
                 ctypes.addressof(lay), len(layers), _cuda.ACTS[activation], N, T, G, fold,
                 bf16, design, pl.flags, partial.data_ptr(), scratch.data_ptr(),
                 out.data_ptr(), pl.smem, _cuda.stream(dev), dev=dev,
                 keep=(X, ct, flat, wt, lay, partial, scratch, out))
    dWs, dbs, _ = _unflatten(params, out)
    dbs[-1] = torch.sum(ct[:, 0]).reshape(params[-1][1].shape)
    return dWs, dbs


class _JetForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, X, *leaves):
        activation, fwd_impl, dot_dtype = cfg
        params = [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
        ctx.activation, ctx.dot_dtype = activation, dot_dtype
        ctx.save_for_backward(X, *leaves)
        if _on_cuda(X):
            return fwdlap_forward(params, X, activation, fwd_impl)
        if fwd_impl == "rows:default":
            return fwdlap_forward_default_plain(params, X, activation)
        return _jet_rows(fwdlap_forward_plain(params, X, activation))

    @staticmethod
    def backward(ctx, ct):
        X, *leaves = ctx.saved_tensors
        params = [(leaves[i].detach(), leaves[i + 1].detach())
                  for i in range(0, len(leaves), 2)]
        if _on_cuda(X):
            dWs, dbs = fwdlap_backward(params, X, ct, ctx.activation, ctx.dot_dtype)
        else:
            dWs, dbs = fwdlap_backward_plain(params, X, ct, ctx.activation, ctx.dot_dtype)
        return (None, None) + tuple(g for pair in zip(dWs, dbs) for g in pair)


def mlp_fwdlap_kernel(params, X, activation: str, fwd_impl: str = "rows",
                      dot_dtype: str = "float32") -> Jet:
    """``(u, grad u, lap u)`` of a scalar MLP over a collocation batch
    through the jet kernels (plain versions on the CPU), differentiable in
    ``params``.  ``fwd_impl``: ``'rows'`` or ``'streams'`` (which output
    layout the forward kernel writes; the jet is the same, exact fp32), or ``'rows:default'`` (the
    row kernel's bf16-dot variant).  ``dot_dtype``: the backward's dots,
    ``'float32'``, ``'bf16x3'`` (as float32) or ``'bfloat16'``."""
    if fwd_impl == "streams:default":
        raise ValueError(
            "fwd_impl='streams:default': the stream-major forward has no "
            "single-pass mode (JAX _forward_kernel runs HIGHEST); use "
            "'rows:default'")
    if fwd_impl not in _FWD_IMPLS:
        raise ValueError(f"fwd_impl must be one of {_FWD_IMPLS}, got {fwd_impl!r}")
    _check_dot(dot_dtype)
    if fwd_impl == "rows:default":
        # the bf16-dot forward's limits on every device, its kernel's (d to
        # 16; JAX's _forward_kernel2 raises above d = 6)
        _cuda.check_net("fwdlap_forward.bf16", [X.shape[1]] + [W.shape[1] for W, _ in params])
    leaves = [t for pair in params for t in pair]
    out = _JetForward.apply((activation, fwd_impl, dot_dtype), X, *leaves)
    d = X.shape[1]
    return Jet(value=out[:, 0], grad=out[:, 1:1 + d], lap=out[:, 1 + d])
