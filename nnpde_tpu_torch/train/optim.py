"""Adam with optax's learning-rate schedules, on ``torch.optim.Adam``.

Counterpart of ``nnpde_tpu/train/optim.py``.  ``torch.optim.Adam`` applies
the same update as ``optax.adam``
(``lr * m_hat / (sqrt(v_hat) + eps)``, bias-corrected moments); what needs
care is the schedule, which optax evaluates at the count of updates made
so far (0 for the first update):

* cosine with ``alpha = final_scale`` holds at ``final_scale * lr`` past
  the horizon (``count`` is clipped to ``decay_steps``);
* exponential decays as ``lr * rate**(count / steps)`` and is clipped
  from below at ``end_value``;
* warmup is ``join_schedules``: a linear ramp 0 -> lr over ``warmup``
  updates, then the named schedule evaluated at ``count - warmup``.

torch's ``lr_scheduler`` classes follow other conventions, so the
schedule is a plain function and :func:`set_lr` writes its value into the
parameter groups before every step.

:class:`MultiTransformAdam` is ``optax.multi_transform`` over such Adams:
a learning rate (and schedule) per labelled group of leaves, as the 2D
oscillator gives its trainable eigenvalue ``E`` its own.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch


def constant_schedule(value: float) -> Callable[[int], float]:
    return lambda count: value


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = min(float(count), float(decay_steps))
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, end_value: float | None = None):
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)

    def schedule(count):
        value = (init_value if count <= 0
                 else init_value * decay_rate ** (count / transition_steps))
        if end_value is not None:
            value = (max if decay_rate < 1.0 else min)(value, end_value)
        return value

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        c = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1.0 - c / transition_steps) + end_value

    return schedule


def join_schedules(schedules, boundaries):
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


class ScheduledAdam:
    """Adam whose learning rate follows ``schedule(count)``.

    ``init(tensors)`` builds the ``torch.optim.Adam`` that holds the
    moments; call :meth:`set_lr` with the number of updates made so far
    before each ``step()``."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.betas = (b1, b2)
        self.eps = eps

    def init(self, tensors) -> torch.optim.Adam:
        return torch.optim.Adam(list(tensors), lr=self.schedule(0),
                                betas=self.betas, eps=self.eps)

    def set_lr(self, opt: torch.optim.Optimizer, count: int) -> None:
        lr = float(self.schedule(count))
        for group in opt.param_groups:
            group["lr"] = lr

    def lookahead(self, opt: torch.optim.Optimizer, count: int, tensors, grads):
        """``tensors`` one update along ``grads`` further, without touching
        ``opt``: optax's ``update`` on a copy of the state (the
        extragradient lookahead).  ``count``: updates made so far."""
        b1, b2 = self.betas
        lr = float(self.schedule(count))
        step = count + 1
        out = []
        for t, g in zip(tensors, grads):
            state = opt.state.get(t, {})
            m = (1.0 - b1) * g
            v = (1.0 - b2) * g * g
            if "exp_avg" in state:
                m = m + b1 * state["exp_avg"]
                v = v + b2 * state["exp_avg_sq"]
            m_hat = m / (1.0 - b1 ** step)
            v_hat = v / (1.0 - b2 ** step)
            out.append(t.detach() - lr * m_hat / (torch.sqrt(v_hat) + self.eps))
        return out


class MultiTransformAdam:
    """``optax.multi_transform({label: adam, ...}, labels)``: one
    ``torch.optim.Adam`` with a parameter group per label, each on its own
    :class:`ScheduledAdam`'s schedule, betas and eps.

    ``labels``: the label of each leaf, in the order the trainer hands
    :meth:`init` its leaves (:func:`~nnpde_tpu_torch.train.leaf_labels`).
    The update count is shared, as in optax, where every inner transform
    sees every step: :meth:`set_lr` evaluates each group's schedule at the
    same ``count``."""

    def __init__(self, transforms: Dict[str, ScheduledAdam], labels: Sequence[str]):
        unknown = sorted(set(labels) - set(transforms))
        if unknown:
            raise ValueError(f"leaves labelled {unknown} have no transform")
        self.transforms = dict(transforms)
        self.labels = list(labels)

    def _lrs(self, count: int):
        return {name: float(tr.schedule(count)) for name, tr in self.transforms.items()}

    def init(self, tensors) -> torch.optim.Adam:
        tensors = list(tensors)
        if len(tensors) != len(self.labels):
            raise ValueError(f"{len(tensors)} leaves for {len(self.labels)} labels")
        lrs = self._lrs(0)
        groups = [{"params": [t for t, lab in zip(tensors, self.labels) if lab == name],
                   "lr": lrs[name], "betas": tr.betas, "eps": tr.eps, "label": name}
                  for name, tr in self.transforms.items() if name in self.labels]
        return torch.optim.Adam(groups)

    def set_lr(self, opt: torch.optim.Optimizer, count: int) -> None:
        lrs = self._lrs(count)
        for group in opt.param_groups:
            group["lr"] = lrs[group["label"]]

    def lookahead(self, opt: torch.optim.Optimizer, count: int, tensors, grads):
        """:meth:`ScheduledAdam.lookahead` with each leaf's own transform."""
        out = []
        for t, g, lab in zip(tensors, grads, self.labels):
            out += self.transforms[lab].lookahead(opt, count, [t], [g])
        return out


def make_optimizer(
    lr: float,
    *,
    schedule: str = "constant",
    total_steps: int = 0,
    final_scale: float = 0.01,
    warmup: int = 0,
    decay_steps: int = 0,
) -> ScheduledAdam:
    """schedule in {constant, cosine, exponential}; warmup (if any) is a
    linear ramp before the named schedule.  ``decay_steps``: decay horizon
    when shorter than ``total_steps`` (past it the lr holds)."""
    horizon = decay_steps if decay_steps > 0 else total_steps
    if schedule == "constant":
        sched = constant_schedule(lr)
    elif schedule == "cosine":
        sched = cosine_decay_schedule(lr, max(horizon - warmup, 1),
                                      alpha=final_scale)
    elif schedule == "exponential":
        sched = exponential_decay(lr, max(horizon - warmup, 1), final_scale,
                                  end_value=final_scale * lr)
    else:
        raise ValueError(f"Unknown lr schedule {schedule!r}")
    if warmup > 0:
        sched = join_schedules([linear_schedule(0.0, lr, warmup), sched],
                               [warmup])
    return ScheduledAdam(sched)


def make_wan_optimizers(lr: float, *, v_lr: float | None = None,
                        schedule: str = "constant", epochs: int, v_steps: int,
                        decay_steps: int = 0, **kw):
    """Consistent (primal, critic) optimizer pair for ``fit_wan``: the
    critic takes ``v_steps`` updates per epoch, so its schedule horizon is
    ``epochs * v_steps`` (and its ``decay_steps`` hold ``decay_steps *
    v_steps``).  ``v_lr``: a faster critic (two-timescale GDA)."""
    u_opt = make_optimizer(lr, schedule=schedule, total_steps=epochs,
                           decay_steps=decay_steps, **kw)
    v_opt = make_optimizer(v_lr if v_lr is not None else lr, schedule=schedule,
                           total_steps=epochs * v_steps,
                           decay_steps=decay_steps * v_steps, **kw)
    return u_opt, v_opt
