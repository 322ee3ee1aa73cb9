"""The trainer: one eager loop for the gradient-descent methods.

Counterpart of ``nnpde_tpu/train/trainer.py::fit``.  The JAX ``lax.scan``
over a chunk of epochs becomes a Python loop; what the scan bought is kept:

* the per-epoch key is ``fold_in(key, epoch)``, so a trajectory does not
  depend on chunking or on resuming;
* the best metric, parameters and epoch live on the device and are
  updated with ``torch.where`` — no ``.item()`` and no host sync per step;
* the history is collected as device scalars and moved to the host once
  per chunk.

:func:`fit_wan` is the WAN minimax on the same discipline.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import runtime
from ..prng import fold_in
from .optim import ScheduledAdam


class FitResult(NamedTuple):
    params: Any                      # final params [(W, b), ...]
    best_params: Any                 # device-tracked argmin-eval params
    best_metric: float
    best_epoch: int
    history: Dict[str, np.ndarray]   # per-epoch metric curves (host)
    v_params: Any = None             # WAN critic final params
    best_v_params: Any = None        # WAN critic at the best epoch
    carry: Any = None                # full train state (resume support)
    timing: Optional[Dict[str, float]] = None


class Carry(NamedTuple):
    leaves: list                     # flat [W0, b0, W1, b1, ...] leaf tensors
    opt: torch.optim.Optimizer
    count: int                       # updates made (the schedule's step)
    best_m: torch.Tensor
    best_leaves: list
    best_e: torch.Tensor


def _pairs(leaves):
    return [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]


def _leaves_of(params):
    """The leaves of ``[(W, b), ...]``, or of ``{"net": [(W, b), ...],
    <name>: tensor, ...}`` (a net with extra trainable leaves, such as a
    WAN's eigenvalue E): the net's first, then the others by name."""
    if isinstance(params, dict):
        return (_leaves_of(params["net"])
                + [params[k] for k in sorted(params) if k != "net"])
    return [t for W, b in params for t in (W, b)]


def _rebuild(like, leaves):
    """The inverse of :func:`_leaves_of` for the structure of ``like``."""
    if isinstance(like, dict):
        n = 2 * len(like["net"])
        out = {"net": _pairs(leaves[:n])}
        out.update(zip([k for k in sorted(like) if k != "net"], leaves[n:]))
        return out
    return _pairs(leaves)


def leaf_labels(params, labels: Dict[str, str]):
    """The label of each leaf of ``params`` in the trainer's leaf order
    (:func:`_leaves_of`), from ``labels``, one label per top-level key of a
    ``{"net": ..., <name>: ...}`` dict: every leaf under a key takes its
    label (``optax.multi_transform``'s labels, for
    :class:`~nnpde_tpu_torch.train.optim.MultiTransformAdam`)."""
    return ([labels["net"]] * len(_leaves_of(params["net"]))
            + [labels[k] for k in sorted(params) if k != "net"])


def _grad(loss, leaves):
    """d loss / d leaves, zeros for a leaf the loss does not read (a DRM's
    tracked E), as JAX's gradient of an unused leaf."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]


def _trainable(params):
    return [t.detach().clone().requires_grad_(True) for t in _leaves_of(params)]


def _own(metrics, live):
    """``metrics`` with each one that shares storage with a ``live`` leaf (a
    tracked trainable E, which the optimizer then updates in place) copied."""
    return {k: v.detach().clone() if v.data_ptr() in live else v for k, v in metrics.items()}


class _History:
    """Per-epoch metrics buffered as device scalars and moved to the host
    once every ``chunk`` epochs (the loop's only host sync)."""

    def __init__(self, chunk: int, progress=None, start_epoch: int = 0):
        self.chunk = min(chunk, runtime.scan_chunk_cap())
        self.parts: Dict[str, list] = {}
        self.buf: Dict[str, list] = {}
        self.progress, self.start_epoch = progress, start_epoch

    def add(self, i: int, epochs: int, row: Dict[str, torch.Tensor]) -> None:
        for name, v in row.items():
            self.buf.setdefault(name, []).append(v.detach().reshape(()).to(torch.float32))
        if (i + 1) % self.chunk == 0 or i + 1 == epochs:
            for name, vals in self.buf.items():
                self.parts.setdefault(name, []).append(torch.stack(vals).cpu().numpy())
            self.buf.clear()
            if self.progress is not None:
                self.progress(self.start_epoch + i + 1,
                              {k: float(v[-1][-1]) for k, v in self.parts.items()})

    def result(self) -> Dict[str, np.ndarray]:
        return {n: np.concatenate(v) for n, v in self.parts.items()}


def _adam_step(optimizer: ScheduledAdam, opt, leaves, grads, count: int) -> None:
    for t, g in zip(leaves, grads):
        t.grad = g.detach()
    optimizer.set_lr(opt, count)
    opt.step()


def _init_carry(params, optimizer: ScheduledAdam) -> Carry:
    leaves = _trainable(params)
    dev = leaves[0].device
    return Carry(
        leaves=leaves,
        opt=optimizer.init(leaves),
        count=0,
        best_m=torch.tensor(float("inf"), dtype=torch.float32, device=dev),
        best_leaves=[t.detach().clone() for t in leaves],
        best_e=torch.tensor(-1, dtype=torch.int64, device=dev),
    )


def fit(
    loss_fn: Optional[Callable],     # (params, key) -> (scalar, metrics dict)
    eval_fn: Callable,               # (params, key) -> scalar (lower = better)
    params,
    *,
    epochs: int,
    optimizer: ScheduledAdam,
    key: int,
    chunk: int = 1000,
    init_carry: Optional[Carry] = None,
    start_epoch: int = 0,
    loss_and_grad_fn: Optional[Callable] = None,
    progress: Optional[Callable[[int, Dict[str, float]], None]] = None,
) -> FitResult:
    """Train ``params`` (``[(W, b), ...]``, or a ``{"net": [...], <name>:
    tensor}`` dict with extra trainable leaves) for ``epochs`` steps of
    Adam.

    ``loss_and_grad_fn``: optional ``(params, key) -> ((loss, metrics),
    grads)`` replacing autograd of ``loss_fn`` — the hook for the fused
    loss+gradient kernels (:mod:`nnpde_tpu_torch.kernels.fused_step`).
    ``init_carry``/``start_epoch`` resume from a previous
    ``FitResult.carry``.  ``chunk``: epochs between moves of the history
    from the device to the host (the only host sync in the loop);
    ``progress(epoch, {metric: last value})`` is called after each move.
    """
    if epochs > 0 and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    carry = init_carry if init_carry is not None else _init_carry(params, optimizer)
    leaves, opt, count = carry.leaves, carry.opt, carry.count
    best_m, best_leaves, best_e = carry.best_m, carry.best_leaves, carry.best_e
    dev = leaves[0].device
    hist = _History(chunk, progress, start_epoch)
    live = {t.data_ptr() for t in leaves}

    t0 = time.time()
    for i in range(epochs):
        epoch = start_epoch + i
        k = fold_in(key, epoch)
        p = _rebuild(params, leaves)
        if loss_and_grad_fn is not None:
            (loss, metrics), grads = loss_and_grad_fn(p, k)
            grads = _leaves_of(grads)
        else:
            loss, metrics = loss_fn(p, k)
            grads = _grad(loss, leaves)
        metrics = _own(metrics, live)
        _adam_step(optimizer, opt, leaves, grads, count)
        count += 1
        with torch.no_grad():
            m = eval_fn(_rebuild(params, leaves), fold_in(k, 0x5EED)).to(torch.float32)
            improved = m < best_m
            best_leaves = [torch.where(improved, t, bt)
                           for t, bt in zip(leaves, best_leaves)]
            best_m = torch.where(improved, m, best_m)
            best_e = torch.where(improved, torch.full((), epoch, device=dev), best_e)
        hist.add(i, epochs, {**metrics, "total": loss, "l2": m})
    for t in leaves:
        t.grad = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.time() - t0
    history = hist.result()
    carry = Carry(leaves, opt, count, best_m, best_leaves, best_e)
    return FitResult(
        params=_detached(leaves, params),
        best_params=_rebuild(params, best_leaves),
        best_metric=float(best_m),
        best_epoch=int(best_e),
        history=history,
        carry=carry,
        timing={"elapsed_s": elapsed,
                "steps_per_s": epochs / elapsed if elapsed > 0 else float("nan")},
    )


class WanCarry(NamedTuple):
    u_leaves: list
    v_leaves: list
    u_opt: torch.optim.Optimizer
    v_opt: torch.optim.Optimizer
    u_count: int
    v_count: int
    best_m: torch.Tensor
    best_u: list
    best_v: list
    best_e: torch.Tensor
    ema: list                        # EMA of the primal leaves
    prev_g: Any                      # previous (u, v) gradients (OGDA)


def _detached(leaves, like=None):
    return _rebuild(like, [t.detach() for t in leaves])


def fit_wan(
    u_loss_fn: Callable,             # (u_params, v_params, key) -> (scalar, metrics)
    v_loss_fn: Callable,             # (v_params, u_params or context, key) -> scalar
    eval_fn: Callable,               # (u_params, key) -> scalar
    u_params,
    v_params,
    *,
    epochs: int,
    v_steps: int,
    u_optimizer: ScheduledAdam,
    v_optimizer: ScheduledAdam,
    key: int,
    chunk: int = 500,
    init_carry: Optional[WanCarry] = None,
    start_epoch: int = 0,
    minimax: str = "alternating",    # alternating | extragradient | optimistic
    u_ema: float = 0.0,              # > 0: track an EMA of u and eval it too
    v_context_fn: Optional[Callable] = None,
) -> FitResult:
    """The WAN minimax: per epoch ``v_steps`` critic updates then one primal
    update (counterpart of ``nnpde_tpu/train/trainer.py::fit_wan``).

    ``minimax``: ``alternating`` (critic steps, then the primal step);
    ``extragradient`` (after ``v_steps - 1`` critic steps, gradients at
    (u, v) give a lookahead (u', v') with the optimizer states untouched,
    and the real update applies the gradients at (u', v')); ``optimistic``
    (OGDA: the optimizer consumes ``2 g_t - g_{t-1}``).  ``u_ema > 0`` also
    tracks ``ema = d*ema + (1-d)*u`` and lets the best snapshot take the
    averaged iterate.  ``v_context_fn(u_params, key)``: what the critic
    objective needs from the frozen primal, computed once per epoch (and at
    the extragradient lookahead); ``v_loss_fn`` then receives it in place of
    ``u_params``.  Each objective is differentiated in its own net only:
    the other net's params come detached.
    """
    if minimax not in ("alternating", "extragradient", "optimistic"):
        raise ValueError(f"Unknown minimax mode {minimax!r}")
    if epochs > 0 and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if v_context_fn is None:
        def v_context_fn(u_params, key):
            return u_params
    if init_carry is None:
        u_leaves, v_leaves = _trainable(u_params), _trainable(v_params)
        dev = u_leaves[0].device
        carry = WanCarry(
            u_leaves, v_leaves, u_optimizer.init(u_leaves), v_optimizer.init(v_leaves),
            0, 0, torch.tensor(float("inf"), dtype=torch.float32, device=dev),
            [t.detach().clone() for t in u_leaves], [t.detach().clone() for t in v_leaves],
            torch.tensor(-1, dtype=torch.int64, device=dev),
            [t.detach().clone() for t in u_leaves],
            ([torch.zeros_like(t) for t in u_leaves], [torch.zeros_like(t) for t in v_leaves]))
    else:
        carry = init_carry
    (u_leaves, v_leaves, u_opt, v_opt, u_count, v_count, best_m, best_u, best_v,
     best_e, ema, prev_g) = carry
    dev = u_leaves[0].device
    n_plain = v_steps if minimax == "alternating" else v_steps - 1
    hist = _History(chunk)
    live = {t.data_ptr() for t in u_leaves}

    def u_grad(u_lv, v_p, k):
        (loss, metrics) = u_loss_fn(_rebuild(u_params, u_lv), v_p, k)
        return loss, _own(metrics, live), _grad(loss, u_lv)

    def v_grad(v_lv, ctx, k):
        loss = v_loss_fn(_pairs(v_lv), ctx, k)
        return loss.detach(), torch.autograd.grad(loss, v_lv)

    t0 = time.time()
    for i in range(epochs):
        epoch = start_epoch + i
        k = fold_in(key, epoch)
        v_ctx = v_context_fn(_detached(u_leaves, u_params), k)
        last_v_loss = torch.zeros((), device=dev)
        for j in range(max(n_plain, 0)):
            last_v_loss, gv = v_grad(v_leaves, v_ctx, fold_in(k, j))
            _adam_step(v_optimizer, v_opt, v_leaves, gv, v_count)
            v_count += 1
        uk, vk = fold_in(k, 0x0A11CE), fold_in(k, 0x0C8171C)
        if minimax == "alternating":
            loss, metrics, gu = u_grad(u_leaves, _detached(v_leaves), uk)
            _adam_step(u_optimizer, u_opt, u_leaves, gu, u_count)
            u_count += 1
        elif minimax == "extragradient":
            _, _, gu1 = u_grad(u_leaves, _detached(v_leaves), uk)
            last_v_loss, gv1 = v_grad(v_leaves, v_ctx, vk)
            u_bar = [t.requires_grad_(True) for t in
                     u_optimizer.lookahead(u_opt, u_count, u_leaves, gu1)]
            v_bar = [t.requires_grad_(True) for t in
                     v_optimizer.lookahead(v_opt, v_count, v_leaves, gv1)]
            loss, metrics, gu2 = u_grad(u_bar, _detached(v_bar), uk)
            _, gv2 = v_grad(v_bar, v_context_fn(_detached(u_bar, u_params), vk), vk)
            _adam_step(u_optimizer, u_opt, u_leaves, gu2, u_count)
            _adam_step(v_optimizer, v_opt, v_leaves, gv2, v_count)
            u_count += 1
            v_count += 1
        else:  # optimistic (OGDA)
            loss, metrics, gu = u_grad(u_leaves, _detached(v_leaves), uk)
            last_v_loss, gv = v_grad(v_leaves, v_ctx, vk)
            pgu, pgv = prev_g
            _adam_step(u_optimizer, u_opt, u_leaves,
                       [2.0 * g - p for g, p in zip(gu, pgu)], u_count)
            _adam_step(v_optimizer, v_opt, v_leaves,
                       [2.0 * g - p for g, p in zip(gv, pgv)], v_count)
            u_count += 1
            v_count += 1
            prev_g = (list(gu), list(gv))
        with torch.no_grad():
            m = eval_fn(_rebuild(u_params, u_leaves), fold_in(k, 0x5EED)).to(torch.float32)
            row = {**metrics, "total": loss, "l2": m}
            cand = u_leaves
            if u_ema > 0.0:
                # warmup-corrected decay so early epochs average properly
                dcy = min(u_ema, (epoch + 1.0) / (epoch + 10.0))
                ema = [dcy * e + (1.0 - dcy) * t for e, t in zip(ema, u_leaves)]
                m_ema = eval_fn(_rebuild(u_params, ema), fold_in(k, 0x3333)).to(torch.float32)
                use_ema = m_ema < m
                m_eff = torch.where(use_ema, m_ema, m)
                cand = [torch.where(use_ema, e, t) for e, t in zip(ema, u_leaves)]
                row["l2_ema"] = m_ema
            else:
                m_eff = m
            improved = m_eff < best_m
            best_u = [torch.where(improved, t, b) for t, b in zip(cand, best_u)]
            best_v = [torch.where(improved, t, b) for t, b in zip(v_leaves, best_v)]
            best_m = torch.where(improved, m_eff, best_m)
            best_e = torch.where(improved, torch.full((), epoch, device=dev), best_e)
        row["wan_loss_v"] = last_v_loss
        hist.add(i, epochs, row)
    for t in u_leaves + v_leaves:
        t.grad = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.time() - t0
    carry = WanCarry(u_leaves, v_leaves, u_opt, v_opt, u_count, v_count, best_m,
                     best_u, best_v, best_e, ema, prev_g)
    return FitResult(
        params=_detached(u_leaves, u_params),
        best_params=_rebuild(u_params, best_u),
        best_metric=float(best_m),
        best_epoch=int(best_e),
        history=hist.result(),
        v_params=_detached(v_leaves),
        best_v_params=_pairs(best_v),
        carry=carry,
        timing={"elapsed_s": elapsed,
                "steps_per_s": epochs / elapsed if elapsed > 0 else float("nan")},
    )
