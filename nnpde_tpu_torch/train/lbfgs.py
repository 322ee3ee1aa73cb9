"""L-BFGS: the post-Adam polish and the from-scratch mode.

Counterpart of ``nnpde_tpu/train/lbfgs.py``, whose maths is
``optax.lbfgs(memory_size=100)`` at optax's defaults, written out here in
torch (this is not ``torch.optim.LBFGS``, whose line search and stop rules
differ):

* the direction is ``-P g`` by the two-loop recursion over the last
  ``memory_size`` pairs ``(dw, du) = (w_{k+1} - w_k, g_{k+1} - g_k)`` with
  weights ``1 / <du, dw>`` (0 where that is 0) and the initial scaling
  ``<du, dw> / <du, du>`` of the newest pair (``scale_init_precond``); the
  first step's scaling is ``min(1, 1 / |g|)``;
* the step size comes from optax's zoom line search
  (``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')``, otherwise at its defaults: ``slope_rtol``
  1e-4, ``curv_rtol`` 0.9, ``approx_dec_rtol`` 1e-6, ``increase_factor`` 2,
  ``stepsize_precision`` 1e-5): interval search from step 1, then cubic /
  quadratic / bisection zoom, the approximate-Wolfe decrease test, the
  safe step kept for a search that fails;
* the value and gradient of the line search's last evaluation are reused
  by the next iteration (``optax.value_and_grad_from_state``);
* the loop runs while ``count < max_iter and (count == 0 or |g| > tol)``.

Everything works on a flat view of the parameter leaves, on their device.
The line search's decisions are scalar, so they are taken on the host: one
host sync per evaluation of the objective (its value and its slope along
the direction come back together) and one per iteration (the gradient norm
of the stop rule with the new direction's initial slope).  The scalar
arithmetic runs in the parameters' float type, as optax's does.  On a card
each evaluation is one CUDA-graph replay (:func:`_value_and_grad`).
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from .trainer import FitResult, _History, _leaves_of, _rebuild

# optax's defaults of scale_by_zoom_linesearch, and the lbfgs alias's
# max_linesearch_steps
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5


class _Flat:
    """The leaves of ``[(W, b), ...]`` (or of a ``{"net": [...], <name>:
    tensor}`` dict, such as a net with its trainable eigenvalue ``E``) as one
    flat vector, and back."""

    def __init__(self, params):
        self.like = params
        self.shapes = [t.shape for t in _leaves_of(params)]
        self.sizes = [t.numel() for t in _leaves_of(params)]

    def flatten(self, params) -> torch.Tensor:
        return torch.cat([t.detach().reshape(-1) for t in _leaves_of(params)]).clone()

    def unflatten(self, x):
        return _rebuild(self.like, [v.view(s) for v, s in
                                    zip(torch.split(x, self.sizes), self.shapes)])

    def copy(self, x):
        """Parameters from the flat vector ``x``, each leaf with its own
        storage."""
        return _rebuild(self.like, [t.clone() for t in _leaves_of(self.unflatten(x.detach()))])


def _nanmax(a, b):
    return a if math.isnan(a) else b if math.isnan(b) else max(a, b)


def _nanmin(a, b):
    return a if math.isnan(a) else b if math.isnan(b) else min(a, b)


class _Scalars:
    """The line search's scalar arithmetic in one numpy float type (the
    parameters'): divisions by zero give inf or nan as in JAX."""

    def __init__(self, dtype: torch.dtype):
        self.F = np.float64 if dtype == torch.float64 else np.float32

    def __call__(self, v):
        return self.F(v)

    def cubicmin(self, a, fa, fpa, b, fb, c, fc):
        """optax's _cubicmin: a critical point of the cubic through (a, fa)
        with slope fpa at a, (b, fb) and (c, fc); nan where there is none."""
        F = self.F
        with np.errstate(all="ignore"):
            C = fpa
            db = b - a
            dc = c - a
            denom = (db * dc) ** 2 * (db - dc)
            r0 = fb - fa - C * db
            r1 = fc - fa - C * dc
            A = (dc ** 2 * r0 + (-(db ** 2)) * r1) / denom
            B = ((-(dc ** 3)) * r0 + db ** 3 * r1) / denom
            radical = B * B - F(3.0) * A * C
            return a + (-B + np.sqrt(radical)) / (F(3.0) * A)

    def quadmin(self, a, fa, fpa, b, fb):
        """optax's _quadmin: the critical point of the quadratic through
        (a, fa) with slope fpa at a, and (b, fb)."""
        F = self.F
        with np.errstate(all="ignore"):
            db = b - a
            B = (fb - fa - fpa * db) / (db ** 2)
            return a - fpa / (F(2.0) * B)

    def decrease_error(self, stepsize, value, slope, value_init, slope_init):
        F = self.F
        with np.errstate(all="ignore"):
            dec = value - value_init - F(SLOPE_RTOL) * stepsize * slope_init
            approx = slope - (F(2.0) * F(SLOPE_RTOL) - F(1.0)) * slope_init
            delta = value - value_init - F(APPROX_DEC_RTOL) * abs(value_init)
            dec = F(_nanmax(_nanmin(F(_nanmax(approx, delta)), dec), F(0.0)))
        return F(np.inf) if np.isnan(dec) else dec

    def curvature_error(self, slope, slope_init):
        F = self.F
        with np.errstate(all="ignore"):
            curv = F(_nanmax(abs(slope) - F(CURV_RTOL) * abs(slope_init), F(0.0)))
        return F(np.inf) if np.isnan(curv) else curv


def _value_and_grad(loss_fn, flat: _Flat, device: torch.device):
    """``x -> (value, grad)`` of ``loss_fn`` at the flat parameters ``x``.
    On a CUDA device the evaluation is one CUDA-graph replay
    (:class:`~nnpde_tpu_torch.kernels._cuda.graph`): the first call runs
    eagerly on a side stream (a real evaluation, which also warms up the
    kernels' plans and workspaces), then the same evaluation is captured
    once at a static input, and every later call copies ``x`` there and
    replays it.  An evaluation is a few hundred small launches of the
    objective and its autograd backward, whose host work would otherwise
    set the pace (the line search evaluates at every trial step)."""

    def vg(x):
        with torch.enable_grad():
            xv = x.detach().requires_grad_(True)
            value = loss_fn(flat.unflatten(xv))
            (grad,) = torch.autograd.grad(value, xv)
        return value.detach(), grad

    if device.type != "cuda":
        return vg
    from ..kernels import _cuda

    state = {}

    def graphed(x):
        if "graph" in state:
            state["x"].copy_(x)
            value, grad = state["graph"].replay()
            return value.clone(), grad.clone()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            state["x"] = x.detach().clone()
            first = vg(state["x"])
        torch.cuda.current_stream(device).wait_stream(side)
        state["graph"] = _cuda.graph(vg, state["x"])
        return first

    return graphed


def _zoom_linesearch(vg, sc: _Scalars, x, u, value, value_t, grad, slope_init):
    """optax's zoom line search along ``u`` from ``x`` (value ``value`` on
    the host, ``value_t`` on the device, gradient ``grad``, slope
    ``slope_init = <u, grad>``): returns the step size, the value there
    (host and device) and the gradient, and the evaluations made."""
    F = sc
    value_init = value
    st = dict(count=0, stepsize=F(0.0), value=value, value_t=value_t, grad=grad,
              slope=slope_init,
              dec=F(np.inf), interval_found=False, done=False, failed=False,
              low=F(0.0), value_low=value, slope_low=slope_init,
              high=F(0.0), value_high=value, slope_high=slope_init,
              cubic_ref=F(0.0), value_cubic_ref=value,
              safe_stepsize=F(0.0), safe_value=value, safe_value_t=value_t, safe_grad=grad)
    evals = 0

    def on_line(stepsize):
        nonlocal evals
        evals += 1
        v, g = vg(x + u * float(stepsize))
        host = torch.stack([v.to(g.dtype), torch.dot(g, u)]).tolist()
        return F(host[0]), v, g, F(host[1])

    while not (st["done"] or st["failed"]):
        it = st["count"]
        if not st["interval_found"]:
            # interval search, Algorithm 3.5 of Nocedal and Wright
            prev = (st["stepsize"], st["value"], st["slope"])
            new = F(1.0) if it == 0 else F(INCREASE_FACTOR) * prev[0]
            v, vt, g, s = on_line(new)
            dec = sc.decrease_error(new, v, s, value_init, slope_init)
            curv = sc.curvature_error(s, slope_init)
            err = F(_nanmax(dec, curv))
            if dec <= 0.0:
                st.update(safe_stepsize=new, safe_value=v, safe_value_t=vt, safe_grad=g)
            high_new = (dec > 0.0) or (v >= prev[1] and it > 0)
            low_new = (s >= 0.0) and not high_new
            if low_new:
                lo, hi = (new, v, s), prev
            else:
                lo, hi = prev, (new, v, s)
            st.update(low=lo[0], value_low=lo[1], slope_low=lo[2],
                      high=hi[0], value_high=hi[1], slope_high=hi[2],
                      cubic_ref=lo[0], value_cubic_ref=lo[1])
            done = err <= 0.0
            st.update(count=it + 1, stepsize=new, value=v, value_t=vt, grad=g, slope=s, dec=dec,
                      interval_found=high_new or low_new or done, done=done,
                      failed=(it + 1 >= MAX_LINESEARCH_STEPS) and not done)
        else:
            # zoom, Algorithm 3.6 of Nocedal and Wright
            low, high = st["low"], st["high"]
            delta = F(abs(high - low))
            left, right = F(min(high, low)), F(max(high, low))
            cubic_chk, quad_chk = F(0.2) * delta, F(0.1) * delta
            too_small = delta <= F(STEPSIZE_PRECISION)
            mc = sc.cubicmin(low, st["value_low"], st["slope_low"], high, st["value_high"],
                             st["cubic_ref"], st["value_cubic_ref"])
            mq = sc.quadmin(low, st["value_low"], st["slope_low"], high, st["value_high"])
            if left + cubic_chk < mc < right - cubic_chk:
                mid = mc
            elif left + quad_chk < mq < right - quad_chk:
                mid = mq
            else:
                mid = (low + high) / F(2.0)
            v, vt, g, s = on_line(mid)
            dec = sc.decrease_error(mid, v, s, value_init, slope_init)
            curv = sc.curvature_error(s, slope_init)
            err = F(_nanmax(dec, curv))
            if dec <= 0.0 and v < st["safe_value"]:
                st.update(safe_stepsize=mid, safe_value=v, safe_value_t=vt, safe_grad=g)
            done = err <= 0.0
            high_to_mid = (dec > 0.0) or (v >= st["value_low"])
            high_to_low = (s * (high - low) >= 0.0) and not high_to_mid
            old_hi = (high, st["value_high"], st["slope_high"])
            old_lo = (low, st["value_low"], st["slope_low"])
            new_hi = (mid, v, s) if high_to_mid else old_hi
            new_hi = old_lo if high_to_low else new_hi
            new_lo = old_lo if high_to_mid else (mid, v, s)
            ref = old_hi if (high_to_mid or high_to_low) else old_lo
            failed = ((it + 1 >= MAX_LINESEARCH_STEPS)
                      or (too_small and st["safe_stepsize"] > 0.0)) and not done
            st.update(count=it + 1, stepsize=mid, value=v, value_t=vt, grad=g, slope=s, dec=dec,
                      done=done, failed=failed,
                      low=new_lo[0], value_low=new_lo[1], slope_low=new_lo[2],
                      high=new_hi[0], value_high=new_hi[1], slope_high=new_hi[2],
                      cubic_ref=ref[0], value_cubic_ref=ref[1])
        if st["failed"] and (st["safe_stepsize"] > 0.0 or np.isinf(st["dec"])):
            # the step that ensures at least a sufficient decrease
            st.update(stepsize=st["safe_stepsize"], value=st["safe_value"],
                      value_t=st["safe_value_t"], grad=st["safe_grad"])
    return st["stepsize"], st["value"], st["value_t"], st["grad"], evals


class _LBFGS:
    """optax.lbfgs's state and one iteration of it (module note)."""

    def __init__(self, loss_fn, params, memory_size: int):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.flat = _Flat(params)
        self.x = self.flat.flatten(params)
        self.sc = _Scalars(self.x.dtype)
        self.vg = _value_and_grad(loss_fn, self.flat, self.x.device)
        self.memory = deque(maxlen=memory_size)   # (dw, du, rho), oldest first
        self.count = 0
        self.prev_x = None
        self.prev_g = None
        # the line search's last value and gradient (value_and_grad_from_state)
        self.value = self.sc(np.inf)
        self.value_t = None
        self.grad = torch.zeros_like(self.x)
        self.evals = 0
        self.syncs = 0

    def direction(self, g):
        """``-P g`` (scale_by_lbfgs, then scale(-1)), after adding the pair
        of the last step to the memory."""
        if self.count > 0:
            dw = self.x - self.prev_x
            du = g - self.prev_g
            vdot = torch.dot(du, dw)
            rho = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
            self.memory.append((dw, du, rho))
            den = torch.dot(du, du)
            gamma = torch.where(den > 0.0, vdot / den, torch.ones_like(den))
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        q = g.clone()
        alphas = []
        for dw, du, rho in reversed(self.memory):
            a = rho * torch.dot(dw, q)
            q.addcmul_(du, a, value=-1.0)
            alphas.append(a)
        q = q * gamma
        for (dw, du, rho), a in zip(self.memory, reversed(alphas)):
            b = rho * torch.dot(du, q)
            q.addcmul_(dw, a - b)
        return -q

    def step(self, tol: float) -> bool:
        """One iteration, after the stop rule: returns False, changing
        nothing but the memory, where ``count > 0`` and the state's gradient
        norm is ``<= tol``; else makes the step and returns True, with
        ``self.last_value`` (a device scalar) the value at the iterate the
        step started from."""
        if np.isfinite(self.value):
            value, value_t, g = self.value, self.value_t, self.grad
        else:
            value_t, g = self.vg(self.x)
            value = None
        u = self.direction(g)
        fetch = [torch.linalg.vector_norm(g), torch.dot(u, g)]
        if value is None:
            fetch.append(value_t.to(g.dtype))
        host = torch.stack(fetch).tolist()
        self.syncs += 1
        if value is None:
            value = self.sc(host[2])
        if self.count > 0 and self.sc(host[0]) <= tol:
            return False
        stepsize, self.value, self.value_t, g_new, evals = _zoom_linesearch(
            self.vg, self.sc, self.x, u, value, value_t, g, self.sc(host[1]))
        self.evals += evals
        self.syncs += evals
        self.prev_x, self.prev_g = self.x, g
        self.x = self.x + u * float(stepsize)
        self.grad = g_new
        self.count += 1
        self.last_value = value_t
        return True


def lbfgs_polish(
    loss_fn: Callable,          # (params,) -> scalar tensor
    params,
    *,
    max_iter: int = 200,
    tol: float = 1e-10,
    memory_size: int = 100,
):
    """Run L-BFGS to (local) convergence from ``params``; returns
    ``(params, loss at the returned params)``."""
    opt = _LBFGS(loss_fn, params, memory_size)
    while opt.count < max_iter:
        if not opt.step(tol):
            break
    out = opt.flat.copy(opt.x)
    with torch.no_grad():
        value = loss_fn(out)
    return out, value


def lbfgs_fit(
    loss_fn: Callable,          # (params,) -> scalar tensor
    eval_fn: Callable,          # (params,) -> scalar tensor (lower = better)
    params,
    *,
    max_iter: int,
    tol: float = 1e-10,
    memory_size: int = 100,
    chunk: int = 200,
) -> FitResult:
    """L-BFGS instead of Adam, with :func:`~nnpde_tpu_torch.train.fit`'s
    contract: per-iteration ``total`` (the value at the iterate the
    iteration starts from) and ``l2`` (``eval_fn`` after it) histories of
    exactly ``max_iter`` entries, and the best iterate tracked on the
    device.  Once the gradient norm is ``<= tol`` the remaining iterations
    repeat the loss and eval at the final iterate (the JAX ``lax.cond``
    no-op).  ``chunk``: iterations between moves of the history to the
    host."""
    opt = _LBFGS(loss_fn, params, memory_size)
    dev = opt.x.device
    best_m = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    best_x = opt.x.clone()
    best_e = torch.tensor(-1, dtype=torch.int64, device=dev)
    hist = _History(chunk)
    done = False
    repeat = None
    t0 = time.time()
    for it in range(max_iter):
        if not done and not opt.step(tol):
            done = True
        with torch.no_grad():
            if done:
                if repeat is None:   # the loss and eval at the final iterate
                    p = opt.flat.unflatten(opt.x)
                    repeat = (loss_fn(p).detach(), eval_fn(p).to(torch.float32))
                value, m = repeat
            else:
                value = opt.last_value
                m = eval_fn(opt.flat.unflatten(opt.x)).to(torch.float32)
            improved = m < best_m
            best_x = torch.where(improved, opt.x, best_x)
            best_m = torch.where(improved, m, best_m)
            best_e = torch.where(improved, torch.full((), it, device=dev), best_e)
        hist.add(it, max_iter, {"total": value, "l2": m})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.time() - t0
    return FitResult(
        params=opt.flat.copy(opt.x),
        best_params=opt.flat.copy(best_x),
        best_metric=float(best_m),
        best_epoch=int(best_e),
        history=hist.result(),
        timing={"elapsed_s": elapsed,
                "steps_per_s": max_iter / elapsed if elapsed > 0 else float("nan"),
                "evaluations": opt.evals, "host_syncs": opt.syncs,
                "iterations": opt.count},
    )

