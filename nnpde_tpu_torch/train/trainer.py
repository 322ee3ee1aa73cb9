"""The trainer: one eager loop for the gradient-descent methods.

Counterpart of ``nnpde_tpu/train/trainer.py::fit``.  The JAX ``lax.scan``
over a chunk of epochs becomes a Python loop; what the scan bought is kept:

* the per-epoch key is ``fold_in(key, epoch)``, so a trajectory does not
  depend on chunking or on resuming;
* the best metric, parameters and epoch live on the device and are
  updated with ``torch.where`` — no ``.item()`` and no host sync per step;
* the history is collected as device scalars and moved to the host once
  per chunk.

``fit_wan`` (the WAN minimax) arrives with ROADMAP item A7.
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


def _init_carry(params, optimizer: ScheduledAdam) -> Carry:
    leaves = [t.detach().clone().requires_grad_(True)
              for W, b in params for t in (W, b)]
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
) -> FitResult:
    """Train ``params`` for ``epochs`` steps of Adam.

    ``loss_and_grad_fn``: optional ``(params, key) -> ((loss, metrics),
    grads)`` replacing autograd of ``loss_fn`` — the hook for the fused
    loss+gradient kernels (:mod:`nnpde_tpu_torch.kernels.fused_step`).
    ``init_carry``/``start_epoch`` resume from a previous
    ``FitResult.carry``.  ``chunk``: epochs between moves of the history
    from the device to the host (the only host sync in the loop).
    """
    if epochs > 0 and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    chunk = min(chunk, runtime.scan_chunk_cap())
    carry = init_carry if init_carry is not None else _init_carry(params, optimizer)
    leaves, opt, count = carry.leaves, carry.opt, carry.count
    best_m, best_leaves, best_e = carry.best_m, carry.best_leaves, carry.best_e
    dev = leaves[0].device
    parts: Dict[str, list] = {}
    buf: Dict[str, list] = {}

    def flush():
        for name, vals in buf.items():
            parts.setdefault(name, []).append(
                torch.stack(vals).detach().cpu().numpy())
        buf.clear()

    t0 = time.time()
    for i in range(epochs):
        epoch = start_epoch + i
        k = fold_in(key, epoch)
        p = _pairs(leaves)
        if loss_and_grad_fn is not None:
            (loss, metrics), grads = loss_and_grad_fn(p, k)
            grads = [g for gW, gb in grads for g in (gW, gb)]
        else:
            loss, metrics = loss_fn(p, k)
            grads = torch.autograd.grad(loss, leaves)
        for t, g in zip(leaves, grads):
            t.grad = g.detach()
        optimizer.set_lr(opt, count)
        opt.step()
        count += 1
        with torch.no_grad():
            m = eval_fn(_pairs(leaves), fold_in(k, 0x5EED)).to(torch.float32)
            improved = m < best_m
            best_leaves = [torch.where(improved, t, bt)
                           for t, bt in zip(leaves, best_leaves)]
            best_m = torch.where(improved, m, best_m)
            best_e = torch.where(improved, torch.tensor(epoch, device=dev), best_e)
        row = {name: v.detach() for name, v in metrics.items()}
        row["total"] = loss.detach()
        row["l2"] = m
        for name, v in row.items():
            buf.setdefault(name, []).append(v.reshape(()).to(torch.float32))
        if (i + 1) % chunk == 0 or i + 1 == epochs:
            flush()
    for t in leaves:
        t.grad = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.time() - t0
    history = {n: np.concatenate(v) for n, v in parts.items()}
    carry = Carry(leaves, opt, count, best_m, best_leaves, best_e)
    return FitResult(
        params=[(W.detach(), b.detach()) for W, b in _pairs(leaves)],
        best_params=_pairs(best_leaves),
        best_metric=float(best_m),
        best_epoch=int(best_e),
        history=history,
        carry=carry,
        timing={"elapsed_s": elapsed,
                "steps_per_s": epochs / elapsed if elapsed > 0 else float("nan")},
    )
