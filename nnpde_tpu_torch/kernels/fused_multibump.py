"""Two-pass fused kernels for the multi-test-function WAN weak form.

Counterpart of ``nnpde_tpu/kernels/fused_multibump.py``.  The multi-bump WAN
(``IPW2DConfig.n_test_grid > 1``) keeps one weak residual per localised test
function ``phi_k = w_k * v``:

    loss_pde = mean_k( wr_k^2 / (mean(phi_k^2) + eps) ),
    wr_k     = mean_i( pref * grad u . grad phi_k + (V - E) * u * phi_k ).

Pass A (:func:`fused_multi_sums`) returns, per bump, the weak sum, the mass
``sum (e1_k net)^2`` and the trainable-E seed ``sum e2_k net``; the scalar
quotient algebra runs in torch ops on the ``(K,)`` vectors on the device;
pass B (:func:`fused_multi_seeded_grads`) seeds one reverse sweep with the
per-point cotangent summed over the bumps.  ``MAX_BUMPS`` keeps the JAX
package's cap of 42 (``n_test_grid <= 6`` in 2D).

Coefficient layout per point (``nc = K*(d + 4)``): K blocks ``[c_k, b_k0 ..
b_k{d-1}, rhs_k]`` giving ``r_k = c_k*net + sum_j b_kj*dnet_j + rhs_k``,
then K mass columns ``e1_k`` and K linear columns ``e2_k``.  The weak forms
touch value and gradient only, so no Laplacian stream is carried.

Where it runs: a CUDA tensor goes to ``csrc/fused_multibump.cu`` (float32;
anything else raises), a CPU tensor to the plain versions beside it
(``fused_multi_sums_plain``, ``fused_multi_seeded_grads_plain``: the
forward-Laplacian recurrence under ``torch.autograd``, in any dtype).
``dot_dtype='bfloat16'`` (the TPU kernels' one-pass bf16 dot mode) rounds
every product operand of the recompute and the reverse sweep to bf16 and
accumulates in float32, on the tensor-core design
(``csrc/fused_multibump_mma.cu`` on ``csrc/fwdlap_mma.cuh``, counted as
``multi_sums.bf16`` / ``multi_seeded.bf16``, planned by
:func:`.fused_step.mma_plan`); its plain versions are the per-tile
arithmetic written out, as the quotients' are.  ``'bf16x3'`` runs the
float32 kernels (:func:`.fused_step._check_dot`).

The float32 launch shape is chosen per net by :func:`plan`, the shared plan
of :mod:`._plan`: points per tile, what stays in shared memory for a
block's whole life, and how many blocks an SM can hold.  The objectives
flatten the parameters once per evaluation and hand the vector from
``forward`` to ``backward`` (``flat=``).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.fwdlap import mlp_fwdlap
from . import _cuda, _plan
from .fused_quotient import (
    _check_axis,
    _flat_grads,
    _global_grads,
    _global_sums,
    _on_cuda,
    _pairs,
    _seeded_grads,
    _swept_grads,
    _swept_jet,
    _views,
    _wan_dp,
)
from .fused_step import (
    _check_coef,
    _check_dot,
    _grads_of,
    _leaves,
    _unflatten,
    mma_des,
    mma_plan,
    mma_scratch_floats,
)

MAX_BUMPS = 42   # the JAX package's cap: 3K accumulator lanes in one 128-lane row


def _check_K(Kb) -> None:
    if not (1 <= Kb <= MAX_BUMPS):
        raise ValueError(
            f"n_bumps must be in [1, {MAX_BUMPS}] (3K lanes <= 128), got {Kb}")


def pack_multibump_coefficients(cores):
    """Pack K single-bump ``(N, d+5)`` streams from
    :func:`.fused_quotient.linear_functional_coefficients` into the
    ``(N, K*(d+4))`` multibump layout.  The ``a`` (Laplacian) column is
    dropped: the functional must be first order (``a0 = 0``)."""
    K = len(cores)
    _check_K(K)
    d = cores[0].shape[1] - 5
    blocks = [torch.cat([c[:, :d + 1], c[:, d + 2:d + 3]], dim=1) for c in cores]
    e1s = [c[:, d + 3:d + 4] for c in cores]
    e2s = [c[:, d + 4:d + 5] for c in cores]
    return torch.cat(blocks + e1s + e2s, dim=1)


def weak_form_stream(X, n_bumps: int, rng, L: float = 2.0):
    """A K-bump coefficient stream with the weak form's structure, and
    seeds for pass B: the stream that checks of rows 11-12 hold the kernels
    on.  Per bump k the critic's functional of ``W_k v`` (the stream
    ``make_fused_wan_multi_pair`` builds, with an e2 lane), ``W_k`` a bump
    (centres in [0.3 L, 0.7 L]^d, half-width 0.9 L, so every point of
    [0, L]^d sees every bump at any d), ``c0 = (V - 1) u``, ``b0 = grad u /
    2``, ``rhs = -f W_k``, ``e1 = W_k``, ``e2 = W_k u`` for the smooth
    fields ``u = sin(sum x) + 1/2``, ``V = |x|^2 / 2``, ``f = sin x_0 +
    1/2``; the 3K seeds normal, of either sign, over K N.  ``rng``: a numpy
    Generator (centres, then seeds).  Returns ``(coef (N, K (d+4)), scal
    (3K,))`` on X's device.  (A stream of independent normal entries makes
    pass B's leaves sums that cancel: there the plain bf16-dot version is
    itself 1.4e-4 to 2.2e-4 from its float64 witness.)"""
    import numpy as np

    from ..ops import bump_w_multi
    from ..ops.fwdlap import Jet
    from .fused_quotient import linear_functional_coefficients

    N, d = X.shape
    centers = torch.as_tensor(rng.uniform(0.3 * L, 0.7 * L, (n_bumps, d)).astype(np.float32),
                              device=X.device)
    w, dw = bump_w_multi(X, centers, 0.9 * L)
    s = torch.sum(X, dim=1)
    u, gu = torch.sin(s) + 0.5, torch.cos(s)[:, None].expand(N, d)
    V, f = 0.5 * torch.sum(X * X, dim=1), torch.sin(X[:, 0]) + 0.5
    coef = pack_multibump_coefficients([linear_functional_coefficients(
        Jet(w[k], dw[k], torch.zeros_like(w[k])), c0=(V - 1.0) * u, b0=0.5 * gu,
        rhs=-f * w[k], e1=w[k], e2=w[k] * u) for k in range(n_bumps)])
    scal = torch.as_tensor((rng.normal(size=3 * n_bumps) / (n_bumps * N)).astype(np.float32),
                           device=X.device)
    return coef.contiguous(), scal


# ---------------------------------------------------------- plain versions
def _multi_terms(jet, coef, K, d):
    """Per point and bump: ``(r (N, K), (e1 net)^2 (N, K), e2 net (N, K))``."""
    blk = d + 2
    body = coef[:, :K * blk].reshape(-1, K, blk)
    e1 = coef[:, K * blk:K * blk + K]
    e2 = coef[:, K * blk + K:K * blk + 2 * K]
    v = jet.value[:, None]
    r = (body[:, :, 0] * v + torch.sum(body[:, :, 1:1 + d] * jet.grad[:, None, :], dim=2)
         + body[:, :, d + 1])
    return r, (e1 * v) ** 2, e2 * v


def _multi_ct(coef, scal, value, K, d):
    """Pass B's per-point cotangents ``(ct_v (N,), ct_g (N, d))``, each
    summed over the bumps in bump order (the TPU kernel's order):
    ``ct_v = sum_k (s_r_k c_k + 2 s_q_k e1_k^2 v + s_l_k e2_k)``, ``ct_g_j
    = sum_k s_r_k b_kj``."""
    blk = d + 2
    ctv = torch.zeros_like(value)
    ctg = torch.zeros_like(coef[:, 1:1 + d])
    for k in range(K):
        e1, e2 = coef[:, K * blk + k], coef[:, K * blk + K + k]
        ctv = ctv + scal[k] * coef[:, k * blk] + scal[K + k] * 2.0 * e1 * e1 * value \
            + scal[2 * K + k] * e2
        ctg = ctg + scal[k] * coef[:, k * blk + 1:k * blk + 1 + d]
    return ctv, ctg


def fused_multi_sums_plain(params, X, coef, activation: str, n_bumps: int,
                           dot_dtype: str = "float32"):
    """Plain version of the multibump sums kernel: ``(3K,)`` = ``[sum r_k |
    sum (e1_k net)^2 | sum e2_k net]``.  ``dot_dtype='bfloat16'``: the
    kernel's bf16-dot variant."""
    with torch.no_grad():
        jet = (_swept_jet(params, X, activation) if dot_dtype == "bfloat16"
               else mlp_fwdlap(params, X, activation))
        r, mass, lin = _multi_terms(jet, coef, n_bumps, X.shape[1])
        return torch.cat([torch.sum(r, dim=0), torch.sum(mass, dim=0), torch.sum(lin, dim=0)])


def fused_multi_seeded_grads_plain(params, X, coef, scal, activation: str, n_bumps: int,
                                   dot_dtype: str = "float32"):
    """Plain version of the multibump seeded kernel: ``(dWs, dbs, sums)``
    with the gradients of ``sum_k (s_r_k sum r_k + s_q_k sum (e1_k net)^2 +
    s_l_k sum e2_k net)`` for ``scal = [s_r | s_q | s_l]`` and ``sums =
    [sum ct_v]``.  ``dot_dtype='bfloat16'``: the kernel's bf16-dot variant
    (the cotangents of :func:`_multi_ct` through the bf16-dot reverse
    sweep)."""
    K, d = n_bumps, X.shape[1]
    if dot_dtype == "bfloat16":
        jet = _swept_jet(params, X, activation)
        ctv, ctg = _multi_ct(coef, scal, jet.value, K, d)
        ct = torch.cat([ctv[:, None], ctg, torch.zeros_like(ctv)[:, None]], dim=1)
        dWs, dbs = _swept_grads(params, X, jet, ct)
        return dWs, dbs, torch.sum(ctv).reshape(1)
    s_r, s_q, s_l = scal[:K], scal[K:2 * K], scal[2 * K:3 * K]
    with torch.enable_grad():
        leaves = _leaves(params)
        jet = mlp_fwdlap(leaves, X, activation)
        r, mass, lin = _multi_terms(jet, coef, K, d)
        obj = (torch.sum(torch.sum(r, dim=0) * s_r) + torch.sum(torch.sum(mass, dim=0) * s_q)
               + torch.sum(torch.sum(lin, dim=0) * s_l))
        dWs, dbs = _grads_of(obj, leaves)
    blk = d + 2
    c = coef[:, 0:K * blk:blk]
    e1 = coef[:, K * blk:K * blk + K]
    e2 = coef[:, K * blk + K:K * blk + 2 * K]
    ctv = torch.sum(s_r * c + s_q * 2.0 * e1 * e1 * jet.value.detach()[:, None] + s_l * e2,
                    dim=1)
    return dWs, dbs, torch.sum(ctv).reshape(1)


# ------------------------------------------------------------ CUDA launcher
def smem_floats(seeded: bool, layers, T: int, Kb: int, flags: int) -> int:
    """Shared-memory floats per block for a tile of T points (the layout of
    fused_multibump.cu's multibump_body, mirrored from its smem_floats)."""
    d = layers[0]
    S, wmax = d + 1, _cuda.padded_wmax(layers)
    stage, hid = S * T * wmax, _plan.hidden_floats(layers)
    n = (2 if seeded else 6) * _cuda.NT + (3 if seeded else 2) * stage
    if not flags & _plan.DEV_WEIGHTS:
        n += hid if flags & _plan.RES_WEIGHTS else wmax * wmax
    if seeded and flags & _plan.RES_WEIGHTS:
        n += hid
    if seeded and flags & _plan.RES_GRAD:
        n += _plan.row_floats(layers)
    return (n + T * (Kb * (d + 4) | 1) + T * d + (d + 2) * T + S * T + _cuda.NT + 3 * Kb)


def plan(seeded: bool, layers, Kb: int, *, T: int | None = None,
         tier: str | None = None) -> _plan.Plan:
    """The launch shape of one pass for this net and bump count: the shared
    plan of :mod:`._plan` over this kernel's layout (``d + 1`` streams, no
    Laplacian); where no tier with the weights on chip fits (one 256 x 256
    staging matrix is 256 KB), the tiers that read them from device memory
    (``DEV_WEIGHTS``, design ``DES_DEVW``).  Pass B adds ``DES_BEYOND`` for
    the nets of :func:`._cuda.beyond` and only for them; pass A takes such
    nets as it is.  ``T`` and ``tier`` pin a choice and raise if it does not
    fit; a net whose stages fit no tile of 4 points raises
    :class:`._plan.NoFit`, and one beyond the pair's limits
    (``_cuda.LIMITS``) raises naming ``ROADMAP.md B7``."""
    _cuda.check_net("multi_seeded" if seeded else "multi_sums", layers)
    beyond = seeded and _cuda.beyond(layers)       # its kernels' budget: two blocks per SM
    pl = _plan.plan(lambda t, flags: smem_floats(seeded, layers, t, Kb, flags), layers,
                    layers[0] + 1, seeded, T=T, tier=tier,
                    what=f"multibump plan ({Kb} bumps)", blocks=2 if beyond else 3,
                    device=None)
    return pl._replace(design=pl.design | _cuda.DES_BEYOND) if beyond else pl


_WORKSPACE = {}        # (pass, device, stream) -> (partial, scratch), flat buffers
_WORKSPACE_MAX = 8     # entries kept; the least recently used goes first


def _workspace(seeded: bool, dev, stream: int, partial_floats: int, scratch_floats: int):
    """The per-block partial rows and (pass B) the saved-stage scratch as flat
    buffers, one pair per pass, device and stream: reused by every launch
    there (launches on one stream are ordered, and no result tensor aliases
    them) and replaced when a launch needs a larger one."""
    key = (seeded, dev, stream)
    partial, scratch = _WORKSPACE.pop(key, (None, None))
    if partial is None or partial.numel() < partial_floats:
        partial = torch.empty((partial_floats,), dtype=torch.float32, device=dev)
    if scratch_floats and (scratch is None or scratch.numel() < scratch_floats):
        scratch = torch.empty((scratch_floats,), dtype=torch.float32, device=dev)
    _WORKSPACE[key] = (partial, scratch)
    while len(_WORKSPACE) > _WORKSPACE_MAX:
        del _WORKSPACE[next(iter(_WORKSPACE))]
    return partial, scratch if scratch_floats else None


def _launch(seeded: bool, params, X, coef, scal, activation: str, Kb: int, *,
            flat=None, pl: _plan.Plan | None = None):
    """Launch one float32 multibump kernel plus its reduction; returns the
    flat float32 row: the ``3 Kb`` sums, or ``[grads (P) | sum ct_v]``.
    ``flat``: the parameters already flattened by
    :func:`._cuda.flat_params`."""
    from . import _build

    name = "multi_seeded" if seeded else "multi_sums"
    lib = _build.load()
    layers = _cuda.net_layers(name, params, X, activation,
                              (coef, scal) if seeded else (coef,))
    N, d = X.shape
    K = len(params)
    X, coef = X.contiguous(), coef.contiguous()
    if flat is None:
        flat = _cuda.flat_params(params)
    if pl is None:
        pl = _plan.cached(("multibump", seeded, tuple(layers), Kb),
                          lambda: plan(seeded, layers, Kb))
    T = pl.T
    dev = X.device
    devw = pl.flags & _plan.DEV_WEIGHTS
    fold = int(_cuda.folds(layers, d + 1, T) and not devw)    # DEV_WEIGHTS has no fold
    G = _cuda.grid(name,
                   lambda sm, ptr: lib.fused_multibump_blocks_per_sm(int(seeded), fold,
                                                                     pl.flags, pl.design, sm,
                                                                     ptr),
                   pl.smem, dev, (N + T - 1) // T, fold | pl.design)
    row = flat.numel() + 1 if seeded else 3 * Kb
    stream = _cuda.stream(dev)
    partial, scratch = _workspace(
        seeded, dev, stream, G * row,
        G * (K - 2) * (d + 1) * T * _cuda.padded_wmax(layers) if seeded else 0)
    out = torch.empty((row,), dtype=torch.float32, device=dev)
    if seeded:
        scal = scal.contiguous()
    lay = _cuda.layers_arg(layers)
    wd = _cuda.device_weights(params, seeded) if devw else None
    _cuda.launch(name, lib.fused_multibump_f32, int(seeded), Kb, X.data_ptr(),
                 coef.data_ptr(), flat.data_ptr(), scal.data_ptr() if seeded else None,
                 ctypes.addressof(lay), len(layers), _cuda.ACTS[activation], N, T, G,
                 pl.flags, fold, partial.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None,
                 out.data_ptr(), pl.smem, stream, None if wd is None else wd.data_ptr(),
                 pl.design, dev=dev, keep=(X, coef, flat, wd, scal, lay, partial, scratch, out))
    return out


def _launch_mma(seeded: bool, params, X, coef, scal, activation: str, Kb: int, *,
                flat=None, pl: _plan.Plan | None = None):
    """The bf16-dot mode of one multibump kernel
    (``csrc/fused_multibump_mma.cu``) plus its reduction: the ``3 Kb``
    sums, or ``[grads (P) | sum ct_v, 0, 0]``.  It runs the tensor-core
    design (``DES_MMA``, :func:`.fused_step.mma_plan`) and only it."""
    from . import _build

    lib = _build.load()
    kind = "multi_seeded" if seeded else "multi_sums"
    name = kind + ".bf16"
    layers = _cuda.net_layers(name, params, X, activation,
                              (coef, scal) if seeded else (coef,))
    N = X.shape[0]
    X, coef = X.contiguous(), coef.contiguous()
    if flat is None:
        flat = _cuda.flat_params(params)
    dev = X.device
    if pl is None:
        pl = _plan.cached(("multibump", seeded, tuple(layers), Kb, True),
                          lambda: mma_plan(kind, layers, n_bumps=Kb))
    if pl.design != _cuda.DES_MMA:
        raise ValueError(f"{kind}: the bf16-dot mode runs the tensor-core design and only it "
                         f"(design={pl.design})")
    T = pl.T
    design = mma_des(layers, pl.flags)
    G = _cuda.grid(name,
                   lambda sm, ptr: lib.fused_multibump_mma_blocks_per_sm(int(seeded), design,
                                                                         sm, ptr),
                   pl.smem, dev, (N + T - 1) // T, design << 1)
    row = flat.numel() + 3 if seeded else 3 * Kb
    partial = torch.empty((G, row), dtype=torch.float32, device=dev)
    out = torch.empty((row,), dtype=torch.float32, device=dev)
    per_block = mma_scratch_floats(layers, T, kind, pl.flags)
    scratch = (torch.empty((G, per_block), dtype=torch.float32, device=dev) if per_block
               else None)
    if seeded:
        scal = scal.contiguous()
    lay = _cuda.layers_arg(layers)
    _cuda.launch(name, lib.fused_multibump_mma_f32, int(seeded), Kb, X.data_ptr(),
                 coef.data_ptr(), flat.data_ptr(), scal.data_ptr() if seeded else None,
                 ctypes.addressof(lay), len(layers), _cuda.ACTS[activation], N, T, G,
                 pl.flags, design, partial.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), out.data_ptr(), pl.smem,
                 _cuda.stream(dev), dev=dev,
                 keep=(X, coef, flat, scal, lay, partial, scratch, out))
    return out


# ------------------------------------------------------------------- raw API
def fused_multi_sums(params, X, coef, activation: str, n_bumps: int, *,
                     dot_dtype: str = "float32", flat=None):
    """Pass A: ``{'sum_r' (K,), 'sum_mass' (K,), 'sum_e2' (K,), 'n'}``.
    ``flat``: ``params`` already flattened (``[W0, b0, W1, b1, ...]``); the
    values are then read from it and ``params`` gives the shapes.
    ``dot_dtype``: ``'float32'``, ``'bf16x3'`` or ``'bfloat16'`` (the
    bf16-dot mode)."""
    _check_K(n_bumps)
    _check_dot(dot_dtype)
    _check_coef(X, coef, n_bumps * (X.shape[1] + 4))
    if _on_cuda(X):
        launch = _launch_mma if dot_dtype == "bfloat16" else _launch
        s = launch(False, params, X, coef, None, activation, n_bumps, flat=flat)
    else:
        if flat is not None:
            params = _views(flat, params)
        s = fused_multi_sums_plain(params, X, coef, activation, n_bumps, dot_dtype)
    K = n_bumps
    return {"sum_r": s[0:K], "sum_mass": s[K:2 * K], "sum_e2": s[2 * K:3 * K],
            "n": X.shape[0]}


def fused_multi_seeded_grads(params, X, coef, scalars, activation: str, n_bumps: int, *,
                             dot_dtype: str = "float32", flat=None):
    """Pass B: grads of ``sum_k s_r_k*sum r_k + s_q_k*sum (e1_k v)^2 +
    s_l_k*sum e2_k v`` for ``scalars = (s_r (K,), s_q (K,), s_l (K,))``
    (already holding every 1/N and chain factor), in the params layout.
    ``flat`` and ``dot_dtype`` as in :func:`fused_multi_sums`."""
    _check_K(n_bumps)
    _check_dot(dot_dtype)
    _check_coef(X, coef, n_bumps * (X.shape[1] + 4))
    scal = torch.cat([torch.as_tensor(s, dtype=X.dtype, device=X.device).reshape(n_bumps)
                      for s in scalars])
    if _on_cuda(X):
        params = [(W.detach(), b.detach()) for W, b in params]
        launch = _launch_mma if dot_dtype == "bfloat16" else _launch
        out = launch(True, params, X, coef, scal, activation, n_bumps, flat=flat)
        dWs, dbs, sums = _unflatten(params, out)
    else:
        if flat is not None:
            params = _views(flat, params)
        dWs, dbs, sums = fused_multi_seeded_grads_plain(params, X, coef, scal, activation,
                                                        n_bumps, dot_dtype)
    return _seeded_grads(params, dWs, dbs, sums)


# ----------------------------------------------------- autograd objectives
def _fold_E(base, E, K):
    """``c_k -= E * e2_k`` on the K ``c`` columns: the eigenvalue enters the
    coefficients by a torch op, so its gradient stays exact."""
    blk = base.shape[1] // K - 2
    e2 = base[:, K * blk + K:K * blk + 2 * K]
    coef = base.clone()
    coef[:, 0:K * blk:blk] -= E * e2
    return coef


class _WanMultiU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, E, X, base, phi_norms, *leaves):
        activation, K, convention, eps, vol, w_pde, w_norm, dot, axis = cfg
        coef = _fold_E(base, E, K)
        flat = _cuda.flat_params(_pairs(leaves))     # built once, reused by backward
        s = _global_sums(fused_multi_sums(_pairs(leaves), X, coef, activation, K, dot_dtype=dot,
                                          flat=flat), axis)
        n = s["n"]
        wr = s["sum_r"] / n                            # (K,)
        mu2 = s["sum_mass"][0] / n                     # u mass (e1_0 = Bu)
        p_k, _, _ = _wan_dp(convention, wr, phi_norms, eps)
        p = torch.mean(p_k)
        norm_term = (vol * mu2 - 1.0) ** 2
        total = w_pde * p + w_norm * norm_term
        ctx.cfg, ctx.n = cfg, n
        ctx.save_for_backward(X, coef, wr, mu2, phi_norms, s["sum_e2"], flat, *leaves)
        ctx.mark_non_differentiable(wr, p, norm_term, mu2)
        return total, wr, p, norm_term, mu2

    @staticmethod
    def backward(ctx, g, *_):
        activation, K, convention, eps, vol, w_pde, w_norm, dot, axis = ctx.cfg
        X, coef, wr, mu2, phi_norms, sum_uphi, flat, *leaves = ctx.saved_tensors
        n = ctx.n
        _, dp_dwr, dp_dpn = _wan_dp(convention, wr, phi_norms, eps)   # (K,)
        s_r = g * w_pde * dp_dwr / (K * n)
        s_q = torch.zeros_like(s_r)
        s_q[0] = g * w_norm * 2.0 * (vol * mu2 - 1.0) * vol / n
        grads = (None,) * len(leaves)
        if any(ctx.needs_input_grad[5:]):
            grads = _flat_grads(_global_grads(fused_multi_seeded_grads(
                _pairs(leaves), X, coef, (s_r, s_q, torch.zeros_like(s_r)), activation, K,
                dot_dtype=dot, flat=flat), axis))
        # dwr_k/dE = -(1/n) sum u*phi_k (the e2 lanes)
        dE = g * w_pde * torch.sum(dp_dwr * (-sum_uphi / n)) / K
        d_pn = g * w_pde * dp_dpn / K                  # (K,)
        return (None, dE, None, None, d_pn) + grads


def make_fused_wan_multi_u(activation: str, n_bumps: int, *,
                           convention: str = "wr2_over_norm", eps: float = 1e-8,
                           vol: float = 1.0, w_pde: float = 1.0, w_norm: float = 0.0,
                           axis=None, dot_dtype: str = "float32"):
    """Fused multibump WAN primal objective: ``loss(params, E, X, base,
    phi_norms) -> (loss, aux)``.

    * ``base``: ``(N, K*(d+4))`` from :func:`pack_multibump_coefficients`
      over per-bump ``linear_functional_coefficients(Bu, c0=V*phi_k,
      b0=pref*gphi_k, e2=Bu*phi_k)`` built with E = 0; the eigenvalue is
      folded in here as ``c_k -= E*e2_k`` so that its gradient stays exact;
      ``e1_0 = Bu`` carries the u mass for the norm penalty (the other e1
      columns zero).
    * ``phi_norms``: ``(K,)`` critic masses ``mean(phi_k^2)``.
    * ``loss = w_pde * mean_k p_k + w_norm*(vol*mean(u^2) - 1)^2``.

    Gradients flow to ``params``, ``E`` and ``phi_norms``.  ``dot_dtype``:
    the kernels' (:func:`fused_multi_sums`)."""
    _check_K(n_bumps)
    _check_axis(axis)
    _check_dot(dot_dtype)
    _wan_dp(convention, 0.0, 1.0, eps)
    cfg = (activation, n_bumps, convention, eps, vol, w_pde, w_norm, dot_dtype, axis)

    def loss(params, E, X, base, phi_norms):
        E = torch.as_tensor(E, dtype=X.dtype, device=X.device)
        total, wr, p, norm_term, mu2 = _WanMultiU.apply(
            cfg, E, X, base, phi_norms, *[t for pair in params for t in pair])
        return total, {"weak_residual": wr, "pde_loss": p, "norm": norm_term,
                       "mean_u2": mu2, "phi_norm": phi_norms}

    return loss


class _WanMultiV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, X, coef, *leaves):
        activation, K, convention, eps, objective, log_eps, dot, axis = cfg
        flat = _cuda.flat_params(_pairs(leaves))     # built once, reused by backward
        s = _global_sums(fused_multi_sums(_pairs(leaves), X, coef, activation, K, dot_dtype=dot,
                                          flat=flat), axis)
        n = s["n"]
        wr, pn = s["sum_r"] / n, s["sum_mass"] / n     # (K,), (K,)
        p_k, _, _ = _wan_dp(convention, wr, pn, eps)
        p = torch.mean(p_k)
        val = -torch.log(p + log_eps) if objective == "neg_log" else -p
        ctx.cfg, ctx.n = cfg, n
        ctx.save_for_backward(X, coef, wr, pn, p, flat, *leaves)
        ctx.mark_non_differentiable(wr, p, pn)
        return val, wr, p, pn

    @staticmethod
    def backward(ctx, g, *_):
        activation, K, convention, eps, objective, log_eps, dot, axis = ctx.cfg
        X, coef, wr, pn, p, flat, *leaves = ctx.saved_tensors
        _, dp_dwr, dp_dpn = _wan_dp(convention, wr, pn, eps)          # (K,)
        outer = -g / (p + log_eps) if objective == "neg_log" else -g
        s_r = outer * dp_dwr / (K * ctx.n)
        s_q = outer * dp_dpn / (K * ctx.n)
        grads = _global_grads(fused_multi_seeded_grads(_pairs(leaves), X, coef,
                                                       (s_r, s_q, torch.zeros_like(s_r)),
                                                       activation, K, dot_dtype=dot, flat=flat),
                              axis)
        return (None, None, None) + _flat_grads(grads)


def make_fused_wan_multi_v(activation: str, n_bumps: int, *,
                           convention: str = "wr2_over_norm", eps: float = 1e-8,
                           objective: str = "neg_log", log_eps: float = 1e-8,
                           axis=None, dot_dtype: str = "float32"):
    """Fused multibump WAN critic objective: ``loss_v(params, X, coef) ->
    (loss_v, aux)``; ``coef`` from :func:`pack_multibump_coefficients` over
    the critic net with per-bump effective factors ``W_k = w_k * Bv`` (``c0
    = (V-E)*u``, ``b0 = pref*grad u``, ``e1_k = W_k``, so mass lane k is
    ``sum phi_k^2``).  The per-bump masses are in the objective: their
    gradients seed the K quadratic lanes.  Gradients flow to ``params``.
    ``dot_dtype``: the kernels' (:func:`fused_multi_sums`)."""
    if objective not in ("neg_log", "neg"):
        raise ValueError(f"Unknown critic objective {objective!r}")
    _check_K(n_bumps)
    _check_axis(axis)
    _check_dot(dot_dtype)
    _wan_dp(convention, 0.0, 1.0, eps)
    cfg = (activation, n_bumps, convention, eps, objective, log_eps, dot_dtype, axis)

    def loss_v(params, X, coef):
        val, wr, p, pn = _WanMultiV.apply(cfg, X, coef,
                                          *[t for pair in params for t in pair])
        return val, {"weak_residual": wr, "pde_loss": p, "phi_norm": pn}

    return loss_v
