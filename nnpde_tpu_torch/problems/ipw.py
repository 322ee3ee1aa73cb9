"""1D infinite potential well presets (PINN / DRM, WAN, and the WAN-FN
weight table).

Counterpart of ``nnpde_tpu/problems/ipw.py``, with the same config fields
and defaults: a ``grid_n``-point linspace on ``[0, L]``, supervised data on
the first quarter of the grid (every ``data_stride``-th point), the
pointwise norm loss, the OG projection onto the exact lower states, the
polish by L-BFGS after Adam (``LBFGS=True``, 200 iterations from the last
Adam iterate), and the WAN branch against a bump-windowed critic with the
known eigenvalue.

``jet_impl`` takes the port's names (the JAX package's ``'xla'``,
``'pallas'`` and ``'pallas-fused'`` raise and name the port's):

* ``'torch'``: the forward-Laplacian recurrence (PINN) or per-point autodiff
  (DRM, WAN) under ``torch.autograd``;
* ``'kernel'``: the PINN residual's jet through the jet kernel pair
  (:func:`~nnpde_tpu_torch.kernels.mlp_fwdlap_kernel`); DRM and WAN run the
  ``'torch'`` path, as the JAX package's ``'pallas'`` does;
* ``'fused'``: PINN through the one-pass fused Helmholtz residual (the
  other terms on autograd), DRM through the two-pass fused Rayleigh
  quotient, WAN through the two-pass weak-form kernels
  (:func:`~nnpde_tpu_torch.problems._fused_wan.make_fused_wan_pair`).

The polish differentiates the objective of ``loss_terms``, as the JAX
package does: on ``'fused'`` PINN that is the torch jet (only the Adam
step takes the fused residual).  On CPU tensors every kernel wrapper takes
its plain version.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from .. import runtime
from ..kernels import (
    fused_linear_residual,
    make_fused_rayleigh,
    quotient_coefficients,
    residual_coefficients,
)
from ..losses import (
    data_mse,
    drm_rayleigh_unscaled,
    norm_integral,
    norm_pointwise,
    orthogonal_projection,
    pinn_helmholtz,
    wan_pde_loss,
    wan_weak_residual,
)
from ..models import NetSpec, SolutionModel, factor_for_technique
from ..ops import bump_w
from ..ops.quadrature import sign_aware_mse
from ..pde import ipw as phys
from ..prng import fold_in, threefry_fold_in, threefry_key
from ..sampling import first_fraction_every_kth, linspace_grid
from ..train import fit, fit_wan, lbfgs_polish, make_optimizer, make_wan_optimizers
from ..train.trainer import _grad
from ._fused_wan import factor_jet_or_one, make_fused_wan_pair

JET_IMPLS = ("torch", "kernel", "fused")
JAX_NAMES = {"xla": "torch", "pallas": "kernel", "pallas-fused": "fused"}


def check_jet_impl(jet_impl: str) -> None:
    """Raise for the JAX package's route names (naming the port's) and for
    any name the port does not have."""
    if jet_impl in JAX_NAMES:
        raise ValueError(f"jet_impl={jet_impl!r} is the JAX package's name; this port "
                         f"calls it jet_impl={JAX_NAMES[jet_impl]!r}")
    if jet_impl not in JET_IMPLS:
        raise ValueError(f"jet_impl must be one of {JET_IMPLS}")


def on_device(params, dev):
    return [(W.to(dev), b.to(dev)) for W, b in params]


def fused_residual_step(model, X, coef, w_pde: float, aux_terms, zero):
    """``lag_fn(params, key)`` of :func:`~nnpde_tpu_torch.train.fit` for a
    residual linear in the net's jet: ``w_pde * mean(r^2)`` through one
    fused launch, plus ``aux_terms(params, u) -> (weighted total, terms)``
    on autograd (``params`` as ``lag_fn`` gets them).

    ``params``: the net ``[(W, b), ...]``, or ``{"net": [...]}`` (the
    gradients then come back in the same structure), or ``{"net": [...],
    "E": E}`` for a trainable eigenvalue; ``coef`` is the coefficient stream,
    or with an E leaf a function of E (called on E detached) that puts the
    factor in the e lane (``residual_coefficients(..., c0=V - E,
    e_lane=True)``).  ``dr/dE = -u``, so E's gradient is ``-(2 w_pde / N)
    sum r*u`` (the kernel's ``sum_r_ufull``) plus what ``aux_terms`` gives
    E.  ``zero``: the ``drm`` metric (None: no such metric)."""
    act = model.spec.activation

    def lag_fn(params, key):
        net = params["net"] if isinstance(params, dict) else params
        E = params.get("E") if isinstance(params, dict) else None
        c = coef(E.detach()) if callable(coef) else coef
        pde, kaux, g_pde = fused_linear_residual(net, X, c, act)
        leaves = ([t for pair in net for t in pair] + ([] if E is None else [E]))
        with torch.enable_grad():
            aux_tot, terms = aux_terms(params, model.apply_batch(net, X))
            g_aux = _grad(aux_tot, leaves)
        total = w_pde * pde + aux_tot.detach()
        grads = [(w_pde * gW + g_aux[2 * i], w_pde * gb + g_aux[2 * i + 1])
                 for i, (gW, gb) in enumerate(g_pde)]
        metrics = {"pde": pde} if zero is None else {"pde": pde, "drm": zero}
        metrics.update({k: v.detach() for k, v in terms.items()})
        if not isinstance(params, dict):
            return (total, metrics), grads
        out = {"net": grads}
        if E is not None:
            out["E"] = (-2.0 * w_pde / kaux["n"]) * kaux["sum_r_ufull"] + g_aux[-1]
            metrics["E"] = E.detach()
        return (total, metrics), out

    return lag_fn


def polish(result, loss, eval_fn, start, max_iter: int, epochs: int):
    """L-BFGS polish from ``start``: the polished iterate becomes the result's
    params, and its best where it scores better (at ``epochs``, the polish
    running after the last epoch)."""
    polished, _ = lbfgs_polish(loss, start, max_iter=max_iter)
    with torch.no_grad():
        final_m = float(eval_fn(polished, None))
    if final_m < result.best_metric:
        return result._replace(params=polished, best_params=polished,
                               best_metric=final_m, best_epoch=epochs)
    return result._replace(params=polished)


@dataclasses.dataclass
class IPW1DConfig:
    n: int = 1
    L: float = 2.0
    epochs: int = 3000
    lr: float = 1e-3
    layers: Tuple[int, ...] = (1, 50, 50, 50, 1)
    LBFGS: bool = False
    method: str = "DRM"               # PINN | DRM  (WAN has its own config)
    technique: str = "FN"             # BC | FBC | FN | OG
    grid_n: int = 1000
    data_fraction: float = 0.25
    data_stride: int = 10
    seed: int = 0
    chunk: int = 1000
    jet_impl: str = "torch"           # torch | kernel | fused (module docstring)


def _make_model(layers, technique, n, L) -> SolutionModel:
    factor = factor_for_technique(
        technique, dim=1, kind="box", L=L,
        nodes_per_dim=[phys.nodes(n, L)] if technique == "FN" else None)
    return SolutionModel(NetSpec(tuple(layers), activation="tanh"), factor)


def _lower_states(n: int, x, L: float):
    """(N, n-1) matrix of the exact lower eigenstates (the OG penalty)."""
    if n <= 1:
        return torch.zeros((x.shape[0], 0), dtype=x.dtype, device=x.device)
    return torch.stack([phys.psi_1d(k, x, L) for k in range(1, n)], dim=1)


def train_ipw_1d(cfg: IPW1DConfig, init_params=None, device="cuda") -> Dict:
    """PINN / DRM on the 1D well; returns the JAX entry point's keys
    (``config``, ``model``, ``result``, ``history``, ``L2_error``,
    ``min_epoch``, ``weights``).  ``init_params`` warm-starts the net (e.g.
    weights carried over by :func:`nnpde_tpu_torch.interop.params_from_jax`).

    ``cfg.seed`` gives the JAX package's initial weights (same seed, the
    same weights bit for bit); the points and the epochs' keys draw from
    torch's generators, so they differ from JAX's.
    """
    if cfg.method not in ("PINN", "DRM"):
        raise ValueError("method must be 'PINN' or 'DRM'")
    check_jet_impl(cfg.jet_impl)
    if cfg.technique not in ("BC", "FBC", "FN", "OG"):
        raise ValueError(
            f"Unknown technique: {cfg.technique}. Choose 'BC', 'FBC', 'FN', or 'OG'.")
    dev = runtime.resolve_device(device)
    runtime.pin_fp32_precision()
    n, L = cfg.n, cfg.L
    model = _make_model(cfg.layers, cfg.technique, n, L)
    key = cfg.seed
    params = on_device(init_params if init_params is not None
                       else model.init(key), dev)

    x_grid = linspace_grid(cfg.grid_n, 0.0, L, device=dev)
    x_flat = x_grid[:, 0]
    u_exact = phys.psi_1d(n, x_flat, L)
    idx = first_fraction_every_kth(cfg.grid_n, cfg.data_fraction, cfg.data_stride, device=dev)
    x_data, u_data = x_grid[idx], u_exact[idx]
    x_bc = torch.tensor([[0.0], [L]], device=dev)
    lower = _lower_states(n, x_flat, L)
    k_squared = (n * math.pi / L) ** 2      # 2 m E / hbar^2
    zero = torch.zeros((), device=dev)

    hard_bc = cfg.technique in ("FBC", "FN", "OG")
    w = {
        "data": 10000.0,
        "bc": 0.0 if hard_bc else 1000.0,
        "orth": 1000.0 if cfg.technique == "OG" else 0.0,
        "pde": 1.0 if cfg.method == "PINN" else 0.0,
        "drm": 10.0 if cfg.method == "DRM" else 0.0,
        "norm": 1.0 if cfg.method == "PINN" else 0.0,
    }

    def aux_terms(p, u):
        terms = {
            "data": data_mse(model.apply_batch(p, x_data), u_data),
            "norm": norm_pointwise(u),
            "bc": torch.mean(model.apply_batch(p, x_bc) ** 2),
            "orth": orthogonal_projection(u, lower, L),
        }
        return sum(w[k] * terms[k] for k in terms), terms

    # the two-pass fused Rayleigh quotient; weight 2x turns the kernel's
    # 1/2|grad|^2 numerator into the well's unscaled convention
    fused_drm = cfg.method == "DRM" and cfg.jet_impl == "fused"
    if fused_drm:
        ray_loss = make_fused_rayleigh(model.spec.activation, weight=2.0 * w["drm"])
        coef_ray = quotient_coefficients(factor_jet_or_one(model, x_grid))

    def loss_terms(params):
        if fused_drm:
            total_ray, aux_ray = ray_loss(params, x_grid, coef_ray)
            u = model.apply_batch(params, x_grid)
            terms = {"pde": zero, "drm": 2.0 * aux_ray["rayleigh"]}
            terms.update(aux_terms(params, u)[1])
            total = total_ray + sum(w[k] * terms[k] for k in w if k not in ("drm", "pde"))
            return total, terms
        # only the active method's operator: the jet for PINN, value and
        # grad for DRM
        if w["pde"] > 0:
            jet = model.fields(params, x_grid,
                               impl="kernel" if cfg.jet_impl == "kernel" else "torch")
            u = jet.value
            pde, drm = pinn_helmholtz(u, jet.lap, k_squared), zero
        else:
            u, g = model.value_and_grad(params, x_grid)
            pde, drm = zero, drm_rayleigh_unscaled(u, g)
        terms = {"pde": pde, "drm": drm}
        terms.update(aux_terms(params, u)[1])
        return sum(w[k] * terms[k] for k in w), terms

    def loss_fn(params, key):
        return loss_terms(params)

    def eval_fn(params, key):
        """Full-grid plain MSE (not sign-aware, as the reference)."""
        return torch.mean((model.apply_batch(params, x_grid) - u_exact) ** 2)

    fit_kw = {}
    if cfg.jet_impl == "fused" and cfg.method == "PINN":
        # one fused launch on r = lap u + k^2 u (u = B * net, or the raw net
        # for 'BC'); DRM rides the fused Rayleigh objective in loss_terms
        coef = residual_coefficients(factor_jet_or_one(model, x_grid), a0=1.0, c0=k_squared)
        fit_kw["loss_and_grad_fn"] = fused_residual_step(model, x_grid, coef, w["pde"],
                                                         aux_terms, zero)

    result = fit(loss_fn, eval_fn, params, epochs=cfg.epochs,
                 optimizer=make_optimizer(cfg.lr), key=fold_in(key, 1), chunk=cfg.chunk,
                 **fit_kw)
    if cfg.LBFGS:
        result = polish(result, lambda p: loss_terms(p)[0], eval_fn, result.params, 200,
                        cfg.epochs)

    return {
        "config": dataclasses.asdict(cfg),
        "model": model,
        "result": result,
        "history": result.history,
        "L2_error": float(result.best_metric),
        "min_epoch": result.best_epoch,
        "weights": w,
    }


# ---------------------------------------------------------------------- WAN
@dataclasses.dataclass
class IPW1DWanConfig:
    n: int = 1
    L: float = 2.0
    epochs: int = 3000
    lr: float = 1e-3
    layers: Tuple[int, ...] = (1, 50, 50, 50, 1)
    v_layers: Tuple[int, ...] = (1, 20, 20, 20, 1)
    technique: str = "FBC"            # BC | FBC | OG | FN (FN = the WAN-FN table)
    v_steps: int = 5
    grid_n: int = 1000
    data_fraction: float = 0.25
    data_stride: int = 10
    # WAN saddle-point knobs (train/trainer.py fit_wan)
    minimax: str = "alternating"
    v_lr: Optional[float] = None
    u_ema: float = 0.0
    lr_schedule: str = "constant"   # constant | cosine | exponential
    lr_decay_steps: int = 0
    seed: int = 0
    chunk: int = 500
    fn_variant: bool = False          # True -> the WAN-FN weight table
    jet_impl: str = "torch"           # torch | kernel (the torch path) | fused


def train_ipw_1d_wan(cfg: IPW1DWanConfig, init_params=None, init_v_params=None,
                     device="cuda") -> Dict:
    """WAN on the 1D well; returns the JAX entry point's keys (``config``,
    ``model``, ``v_model``, ``result``, ``history``, ``L2_error``,
    ``min_epoch``, ``weights``).

    ``cfg.seed`` gives the JAX package's initial weights (same seed, the
    same weights bit for bit); the points and the epochs' keys draw from
    torch's generators, so they differ from JAX's.
    """
    check_jet_impl(cfg.jet_impl)
    dev = runtime.resolve_device(device)
    runtime.pin_fp32_precision()
    n, L = cfg.n, cfg.L
    fn_mode = cfg.fn_variant or cfg.technique == "FN"
    u_model = _make_model(cfg.layers, "FN" if fn_mode else cfg.technique, n, L)
    v_model = SolutionModel(NetSpec(tuple(cfg.v_layers), activation="tanh"))

    key = cfg.seed
    u_params = on_device(init_params if init_params is not None
                         else u_model.init(key), dev)
    v_params = on_device(init_v_params if init_v_params is not None
                         else v_model.init(threefry_fold_in(threefry_key(key), 1)),
                         dev)

    x_grid = linspace_grid(cfg.grid_n, 0.0, L, device=dev)
    x_flat = x_grid[:, 0]
    u_exact = phys.psi_1d(n, x_flat, L)
    idx = first_fraction_every_kth(cfg.grid_n, cfg.data_fraction, cfg.data_stride, device=dev)
    x_data, u_data = x_grid[idx], u_exact[idx]
    x_bc = torch.tensor([[0.0], [L]], device=dev)
    lower = _lower_states(n, x_flat, L)
    E = phys.energy_1d(n, L)
    zero = torch.zeros((), device=dev)

    if fn_mode:
        w = {"data": 0.0, "pde": 10.0, "norm": 1000.0, "bc": 0.0, "orth": 0.0}
    else:
        w = {"data": 10000.0, "pde": 1.0, "norm": 1.0, "bc": 1000.0,
             "orth": 10000.0 if cfg.technique == "OG" else 0.0}

    # the bump and its derivative on the fixed grid, made once
    wv, dwv = bump_w(x_grid, 0.0, L)

    fused = cfg.jet_impl == "fused"
    if fused:
        # the norm rides the in-kernel mass lane; the full-grid u forward
        # remains for orth only (n > 1)
        pair = make_fused_wan_pair(u_model, v_model, w_pde=w["pde"], w_norm=w["norm"], vol=L)
        E_fix = torch.tensor(E, dtype=torch.float32, device=dev)

        # the critic's coefficient stream is frozen across the inner critic
        # steps on the fixed grid: built once per epoch
        def v_context_fn(u_params, key):
            return pair.v_coef_fn(u_params, E_fix, x_grid, wv, dwv)
    else:
        # u's (value, grad) at the fixed grid, once per epoch
        def v_context_fn(u_params, key):
            return u_model.value_and_grad(u_params, x_grid)

    def wan_pde(u_params, v_params, ugu=None):
        u, gu = ugu if ugu is not None else u_model.value_and_grad(u_params, x_grid)
        v, gv = v_model.value_and_grad(v_params, x_grid)
        phi = wv * v
        gphi = dwv * v[:, None] + wv[:, None] * gv
        weak = wan_weak_residual(gu, phi, gphi, u=u, E=E, prefactor=0.5)
        return wan_pde_loss(weak, torch.mean(phi ** 2)), u

    def v_loss_fn(v_params, ctx, key):
        if fused:
            return pair.v_loss_from_coef(v_params, x_grid, ctx)[0]
        return -torch.log(wan_pde(None, v_params, ugu=ctx)[0] + 1e-8)

    def u_loss_fn(u_params, v_params, key):
        data = data_mse(u_model.apply_batch(u_params, x_data), u_data)
        bc = torch.mean(u_model.apply_batch(u_params, x_bc) ** 2)
        if fused:
            core, aux = pair.u_pde_fn(u_params, E_fix, v_params, x_grid, wv, dwv)
            loss_pde, norm = aux["pde_loss"], aux["norm"]
            if n > 1 and w["orth"] > 0:
                orth = orthogonal_projection(u_model.apply_batch(u_params, x_grid), lower, L,
                                             eps=0.0)
            else:
                orth = zero
            total = core + w["orth"] * orth + w["data"] * data + w["bc"] * bc
        else:
            loss_pde, u = wan_pde(u_params, v_params)
            norm = norm_integral(u, L)
            orth = orthogonal_projection(u, lower, L, eps=0.0) if n > 1 else zero
            total = (w["pde"] * loss_pde + w["norm"] * norm + w["orth"] * orth
                     + w["data"] * data + w["bc"] * bc)
        return total, {"pde": loss_pde, "norm": norm, "data": data, "bc": bc, "orth": orth}

    def eval_fn(u_params, key):
        return sign_aware_mse(u_model.apply_batch(u_params, x_grid), u_exact)

    u_opt, v_opt = make_wan_optimizers(cfg.lr, v_lr=cfg.v_lr, epochs=cfg.epochs,
                                       v_steps=cfg.v_steps, schedule=cfg.lr_schedule,
                                       decay_steps=cfg.lr_decay_steps)
    result = fit_wan(u_loss_fn, v_loss_fn, eval_fn, u_params, v_params, epochs=cfg.epochs,
                     v_steps=cfg.v_steps, u_optimizer=u_opt, v_optimizer=v_opt,
                     key=fold_in(key, 2), chunk=cfg.chunk, minimax=cfg.minimax,
                     u_ema=cfg.u_ema, v_context_fn=v_context_fn)
    return {
        "config": dataclasses.asdict(cfg),
        "model": u_model,
        "v_model": v_model,
        "result": result,
        "history": result.history,
        "L2_error": float(result.best_metric),
        "min_epoch": result.best_epoch,
        "weights": w,
    }
