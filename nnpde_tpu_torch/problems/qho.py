"""1D quantum harmonic oscillator presets (PINN / DRM, and WAN with a
trainable energy).

Counterpart of ``nnpde_tpu/problems/qho.py``, with the same config fields
and defaults: a ``grid_n``-point linspace on ``[-x_max, x_max]``, the exp
window factor (``BC`` soft, ``OG`` window and orthogonality, ``FN`` window
times the Hermite nodes), supervised data on the second quarter of the
grid, the trapezoid norm, the fixed exact energy in the residual, and
L-BFGS either after Adam (``lbfgs_mode='polish'``, from the best Adam
iterate) or in its place (``'replace'``, :func:`~nnpde_tpu_torch.train.
lbfgs_fit`).  The WAN branch trains the energy: ``E`` is a leaf of the
primal parameters (``{"net": [...], "E": tensor}``) that the primal's Adam
updates with the net, its exact gradient coming from the fused kernels'
``sum u*phi`` lane on ``'fused'``.

``jet_impl`` as in :mod:`.ipw`: ``'torch'``, ``'kernel'`` (the PINN
residual's jet through the jet kernel pair; DRM and WAN on the torch path)
and ``'fused'`` (PINN's Adam step through the fused residual, DRM through
the fused Rayleigh quotient with the potential, WAN through the two-pass
weak-form kernels); the JAX names raise.  L-BFGS differentiates
``loss_terms`` on every route, as the JAX package does: the jet kernel pair
on ``'kernel'`` PINN, the fused Rayleigh quotient on ``'fused'`` DRM, the
torch jet on ``'fused'`` PINN.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .. import runtime
from ..kernels import make_fused_rayleigh, quotient_coefficients, residual_coefficients
from ..losses import (
    data_mse,
    drm_rayleigh,
    norm_integral,
    norm_trapezoid,
    orthogonal_projection,
    pinn_schrodinger,
    wan_pde_loss,
    wan_weak_residual,
)
from ..models import NetSpec, SolutionModel, factor_for_technique
from ..ops import bump_w
from ..ops.quadrature import sign_aware_mse
from ..pde import qho as phys
from ..prng import fold_in, generator
from ..sampling import linspace_grid, mid_fraction_every_kth
from ..train import fit, fit_wan, lbfgs_fit, make_optimizer, make_wan_optimizers
from ._fused_wan import factor_jet_or_one, make_fused_wan_pair
from .ipw import check_jet_impl, fused_residual_step, on_device, polish


def _qho_factor(technique: str, n: int, x_max: float):
    return factor_for_technique(
        technique, dim=1, kind="window", L=x_max,
        nodes_per_dim=[phys.nodes(n)] if technique == "FN" else None)


def _lower_states(n: int, x):
    if n <= 0:
        return torch.zeros((x.shape[0], 0), dtype=x.dtype, device=x.device)
    return torch.stack([phys.psi_1d(k, x) for k in range(n)], dim=1)


@dataclasses.dataclass
class QHO1DConfig:
    n: int = 0
    x_max: float = 6.0
    epochs: int = 3000
    lr: float = 1e-3
    layers: Tuple[int, ...] = (1, 200, 200, 200, 1)
    LBFGS: bool = False
    # 'replace': L-BFGS instead of Adam; 'polish': Adam for `epochs`, then
    # L-BFGS from the best Adam iterate
    lbfgs_mode: str = "polish"         # polish | replace
    lbfgs_iters: int = 500
    method: str = "DRM"               # PINN | DRM
    technique: str = "BC"             # BC | OG | FN
    grid_n: int = 1000
    data_fraction: float = 0.25
    data_stride: int = 10
    seed: int = 0
    chunk: int = 1000
    jet_impl: str = "torch"           # torch | kernel | fused (module docstring)


def train_qho_1d(cfg: QHO1DConfig, init_params=None, device="cuda") -> Dict:
    """PINN / DRM on the 1D oscillator; returns the JAX entry point's keys
    (``config``, ``model``, ``result``, ``history``, ``L2_error``,
    ``min_epoch``, ``weights``)."""
    if cfg.method not in ("PINN", "DRM"):
        raise ValueError("method must be 'PINN' or 'DRM'")
    check_jet_impl(cfg.jet_impl)
    if cfg.technique not in ("BC", "OG", "FN"):
        raise ValueError(
            f"Unknown technique: {cfg.technique}. Choose 'BC', 'OG', or 'FN'.")
    dev = runtime.resolve_device(device)
    runtime.pin_fp32_precision()
    n, x_max = cfg.n, cfg.x_max
    model = SolutionModel(NetSpec(tuple(cfg.layers), activation="sin"),
                          _qho_factor(cfg.technique, n, x_max))
    key = cfg.seed
    params = on_device(init_params if init_params is not None
                       else model.init(generator(key, dev)), dev)

    x_grid = linspace_grid(cfg.grid_n, -x_max, x_max, device=dev)
    x_flat = x_grid[:, 0]
    dx = x_flat[1] - x_flat[0]
    u_exact = phys.psi_1d(n, x_flat)
    idx = mid_fraction_every_kth(cfg.grid_n, cfg.data_fraction, cfg.data_stride, device=dev)
    x_data, u_data = x_grid[idx], u_exact[idx]
    x_bc = torch.tensor([[-x_max], [x_max]], device=dev)
    bc_zero = torch.zeros((2,), device=dev)
    lower = _lower_states(n, x_flat)
    V = phys.potential_1d(x_flat)
    E = phys.energy_1d(n)
    zero = torch.zeros((), device=dev)
    hard_bc = cfg.technique in ("OG", "FN")

    w = {
        "orth": 100.0 if cfg.technique == "OG" else 0.0,
        "data": 1000.0,
        "bc": 0.0 if hard_bc else 10.0,
        "pde": 10.0 if cfg.method == "PINN" else 0.0,
        "drm": 10.0 if cfg.method == "DRM" else 0.0,
        "norm": 10.0,
    }
    # the orthogonality volume of the reference: 2 * domain length
    orth_volume = 4.0 * x_max

    def aux_terms(p, u):
        terms = {
            "data": data_mse(model.apply_batch(p, x_data), u_data),
            "bc": data_mse(model.apply_batch(p, x_bc), bc_zero),
            "norm": norm_trapezoid(u, dx),
            "orth": (orthogonal_projection(u, lower, orth_volume, eps=0.0)
                     if n > 0 else zero),
        }
        return sum(w[k] * terms[k] for k in terms), terms

    # the two-pass fused Rayleigh quotient with the potential
    fused_drm = cfg.method == "DRM" and cfg.jet_impl == "fused"
    if fused_drm:
        ray_loss = make_fused_rayleigh(model.spec.activation, weight=w["drm"])
        coef_ray = quotient_coefficients(factor_jet_or_one(model, x_grid), V=V)

    def loss_terms(params):
        if fused_drm:
            total_ray, aux_ray = ray_loss(params, x_grid, coef_ray)
            u = model.apply_batch(params, x_grid)
            terms = {"pde": zero, "drm": aux_ray["rayleigh"]}
            terms.update(aux_terms(params, u)[1])
            total = total_ray + sum(w[k] * terms[k] for k in w if k not in ("drm", "pde"))
            return total, terms
        if w["pde"] > 0:
            jet = model.fields(params, x_grid,
                               impl="kernel" if cfg.jet_impl == "kernel" else "torch")
            u = jet.value
            pde, drm = pinn_schrodinger(u, jet.lap, V, E), zero
        else:
            u, g = model.value_and_grad(params, x_grid)
            pde, drm = zero, drm_rayleigh(u, g, V)
        terms = {"pde": pde, "drm": drm}
        terms.update(aux_terms(params, u)[1])
        return sum(w[k] * terms[k] for k in w), terms

    def loss_fn(params, key):
        return loss_terms(params)

    def eval_fn(params, key):
        return torch.mean((model.apply_batch(params, x_grid) - u_exact) ** 2)

    if cfg.LBFGS and cfg.lbfgs_mode == "replace":
        # L-BFGS from scratch, no Adam (the reference's QHO-1D mode)
        result = lbfgs_fit(lambda p: loss_terms(p)[0], lambda p: eval_fn(p, None), params,
                           max_iter=cfg.lbfgs_iters)
    else:
        fit_kw = {}
        if cfg.jet_impl == "fused" and cfg.method == "PINN":
            # one fused launch on r = -1/2 lap u + (V - E) u (the fixed exact
            # E); the other terms on autograd
            coef = residual_coefficients(factor_jet_or_one(model, x_grid), a0=-0.5, c0=V - E)
            fit_kw["loss_and_grad_fn"] = fused_residual_step(model, x_grid, coef, w["pde"],
                                                             aux_terms, zero)
        result = fit(loss_fn, eval_fn, params, epochs=cfg.epochs,
                     optimizer=make_optimizer(cfg.lr), key=fold_in(key, 1),
                     chunk=cfg.chunk, **fit_kw)
    if cfg.LBFGS and cfg.lbfgs_mode == "polish":
        result = polish(result, lambda p: loss_terms(p)[0], eval_fn, result.best_params,
                        cfg.lbfgs_iters, cfg.epochs)

    return {
        "config": dataclasses.asdict(cfg),
        "model": model,
        "result": result,
        "history": result.history,
        "L2_error": float(result.best_metric),
        "min_epoch": result.best_epoch,
        "weights": w,
    }


# ------------------------------------------------------------------------ WAN
@dataclasses.dataclass
class QHO1DWanConfig:
    n: int = 0
    x_max: float = 6.0
    epochs: int = 3000
    lr: float = 1e-3
    layers: Tuple[int, ...] = (1, 200, 200, 200, 1)
    v_layers: Tuple[int, ...] = (1, 100, 100, 100, 1)
    technique: str = "BC"             # BC | FBC | OG
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
    jet_impl: str = "torch"           # torch | kernel (the torch path) | fused


def train_qho_1d_wan(cfg: QHO1DWanConfig, init_params=None, init_v_params=None,
                     device="cuda") -> Dict:
    """WAN with a trainable energy; returns the JAX entry point's keys (also
    ``E_est``, the trained E of the best iterate, ``E_rayleigh``, its
    Rayleigh quotient, and ``E_exact``).  ``init_params`` warm-starts the
    primal net (E starts at the exact energy, as in JAX)."""
    check_jet_impl(cfg.jet_impl)
    dev = runtime.resolve_device(device)
    runtime.pin_fp32_precision()
    n, x_max = cfg.n, cfg.x_max
    hard = cfg.technique != "BC"
    # both nets get the exp window when the technique is not BC
    u_factor = _qho_factor("OG" if hard else "BC", n, x_max)
    u_model = SolutionModel(NetSpec(tuple(cfg.layers), activation="tanh"), u_factor)
    v_model = SolutionModel(NetSpec(tuple(cfg.v_layers), activation="tanh"), u_factor)

    key = cfg.seed
    net = on_device(init_params if init_params is not None
                    else u_model.init(generator(key, dev)), dev)
    u_params = {"net": net,
                "E": torch.tensor(phys.energy_1d(n), dtype=torch.float32, device=dev)}
    v_params = on_device(init_v_params if init_v_params is not None
                         else v_model.init(generator(fold_in(key, 1), dev)), dev)

    x_grid = linspace_grid(cfg.grid_n, -x_max, x_max, device=dev)
    x_flat = x_grid[:, 0]
    u_exact = phys.psi_1d(n, x_flat)
    idx = mid_fraction_every_kth(cfg.grid_n, cfg.data_fraction, cfg.data_stride, device=dev)
    x_data, u_data = x_grid[idx], u_exact[idx]
    x_bc = torch.tensor([[-x_max], [x_max]], device=dev)
    lower = _lower_states(n, x_flat)
    V = phys.potential_1d(x_flat)
    zero = torch.zeros((), device=dev)

    w = {
        "orth": 1000.0 if cfg.technique == "OG" else 0.0,
        "data": 1000.0,
        "pde": 10.0,
        "norm": 10.0,
        "bc": 0.0 if hard else 1000.0,
    }
    volume = 2.0 * x_max
    wv, dwv = bump_w(x_grid, -x_max, x_max)

    fused = cfg.jet_impl == "fused"
    if fused:
        # the norm rides the in-kernel mass lane (vol = 2 x_max)
        pair = make_fused_wan_pair(u_model, v_model, w_pde=w["pde"], w_norm=w["norm"],
                                   vol=volume)

        # the critic's coefficient stream (with the current trainable E),
        # once per epoch
        def v_context_fn(u_params, key):
            return pair.v_coef_fn(u_params["net"], u_params["E"], x_grid, wv, dwv, V=V)
    else:
        # u's (value, grad) and the current E, once per epoch
        def v_context_fn(u_params, key):
            u, gu = u_model.value_and_grad(u_params["net"], x_grid)
            return u, gu, u_params["E"]

    def wan_pde(u_params, v_params, ctx=None):
        if ctx is None:
            u, gu = u_model.value_and_grad(u_params["net"], x_grid)
            E_cur = u_params["E"]
        else:
            u, gu, E_cur = ctx
        v, gv = v_model.value_and_grad(v_params, x_grid)
        phi = wv * v
        gphi = dwv * v[:, None] + wv[:, None] * gv
        weak = wan_weak_residual(gu, phi, gphi, u=u, V=V, E=E_cur, prefactor=0.5)
        return wan_pde_loss(weak, torch.mean(phi ** 2)), u

    def v_loss_fn(v_params, ctx, key):
        if fused:
            return pair.v_loss_from_coef(v_params, x_grid, ctx)[0]
        return -torch.log(wan_pde(None, v_params, ctx=ctx)[0] + 1e-8)

    def u_loss_fn(u_params, v_params, key):
        net = u_params["net"]
        data = data_mse(u_model.apply_batch(net, x_data), u_data)
        bc = torch.mean(u_model.apply_batch(net, x_bc) ** 2)
        if fused:
            # E's exact gradient rides the fused objective's u*phi lane
            core, aux = pair.u_pde_fn(net, u_params["E"], v_params, x_grid, wv, dwv, V=V)
            loss_pde, norm = aux["pde_loss"], aux["norm"]
            if n > 0 and w["orth"] > 0:
                orth = orthogonal_projection(u_model.apply_batch(net, x_grid), lower, volume,
                                             eps=0.0)
            else:
                orth = zero
            total = core + w["orth"] * orth + w["data"] * data + w["bc"] * bc
        else:
            loss_pde, u = wan_pde(u_params, v_params)
            norm = norm_integral(u, volume)
            orth = orthogonal_projection(u, lower, volume, eps=0.0) if n > 0 else zero
            total = (w["pde"] * loss_pde + w["norm"] * norm + w["orth"] * orth
                     + w["data"] * data + w["bc"] * bc)
        return total, {"pde": loss_pde, "norm": norm, "data": data, "bc": bc, "orth": orth,
                       "E": u_params["E"]}

    def eval_fn(u_params, key):
        return sign_aware_mse(u_model.apply_batch(u_params["net"], x_grid), u_exact)

    u_opt, v_opt = make_wan_optimizers(cfg.lr, v_lr=cfg.v_lr, epochs=cfg.epochs,
                                       v_steps=cfg.v_steps, schedule=cfg.lr_schedule,
                                       decay_steps=cfg.lr_decay_steps)
    result = fit_wan(u_loss_fn, v_loss_fn, eval_fn, u_params, v_params, epochs=cfg.epochs,
                     v_steps=cfg.v_steps, u_optimizer=u_opt, v_optimizer=v_opt,
                     key=fold_in(key, 2), chunk=cfg.chunk, minimax=cfg.minimax,
                     u_ema=cfg.u_ema, v_context_fn=v_context_fn)
    # the Rayleigh quotient of the best iterate: second-order accurate in
    # the u-error where the weak form's E is first-order
    u_b, gu_b = u_model.value_and_grad(result.best_params["net"], x_grid)
    E_rayleigh = float(torch.mean(0.5 * torch.sum(gu_b ** 2, -1) + V * u_b ** 2)
                       / (torch.mean(u_b ** 2) + 1e-12))
    return {
        "config": dataclasses.asdict(cfg),
        "model": u_model,
        "v_model": v_model,
        "result": result,
        "history": result.history,
        "L2_error": float(result.best_metric),
        "min_epoch": result.best_epoch,
        "E_est": float(result.best_params["E"]),
        "E_rayleigh": E_rayleigh,
        "E_exact": phys.energy_1d(n),
        "weights": w,
    }
