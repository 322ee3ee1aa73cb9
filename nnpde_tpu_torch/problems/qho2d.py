"""2D quantum harmonic oscillator preset (PINN / DRM / WAN in one trainer).

Counterpart of ``nnpde_tpu/problems/qho2d.py``, with the same
:class:`QHO2DConfig` fields and defaults: a ``grid_n x grid_n`` meshgrid on
``[-L, L]^2``, lower-left-quadrant supervised data, the techniques FBC / OG
(the 2D exp window) and FN (the window times the Hermite nodal lines), the
WAN branch against an FBC critic with the 2D bump test function, the
parity (``x -> -x``, sign ``(-1)^n``) and symmetry (``x <-> y`` when ``nx
== ny``) losses, the weight tables of the reference and of its Energy
variant (``energy_variant``), and sign-aware L2 tracking.

``trainable_energy`` (PINN only) makes E a leaf of the parameters
(``{"net": [...], "E": tensor}``), reported as ``learned_energy``;
``energy_lr`` gives the E leaf its own Adam learning rate
(:class:`~nnpde_tpu_torch.train.MultiTransformAdam`, the JAX package's
``optax.multi_transform``).

``jet_impl`` takes the port's names (the JAX names raise):

* ``'torch'``: the forward-Laplacian recurrence (PINN) or per-point
  autodiff (DRM, WAN) under ``torch.autograd``;
* ``'kernel'``: the PINN residual's jet through the jet kernel pair
  (rows 4 and 5); DRM and WAN run the ``'torch'`` path, as the JAX
  package's ``'pallas'`` does;
* ``'fused'``: PINN through the one-pass fused residual (row 1) on ``-1/2
  lap u + (V - E) u``, with E's gradient from the kernel's e lane when E
  is trained; DRM through the two-pass fused Rayleigh quotient with the
  potential (rows 9 and 10); WAN through the two-pass weak-form kernels
  with the fixed exact E and the potential (rows 4, 7 and 8).

``LBFGS=True`` (PINN, DRM): 500 iterations of L-BFGS from the last Adam
iterate over every leaf, E included, on the objective ``loss_fn`` hands
``fit`` (the torch jet on ``'fused'`` PINN); the polished iterate becomes
the best where it scores better.  On CPU tensors every kernel wrapper
takes its plain version.
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
    orthogonal_projection,
    pinn_schrodinger,
    reflection_mse,
    wan_pde_loss,
    wan_weak_residual,
)
from ..models import NetSpec, SolutionModel, factor_for_technique
from ..ops import bump_w
from ..ops.quadrature import sign_aware_mse
from ..pde import qho as phys
from ..prng import fold_in, generator
from ..sampling import meshgrid_2d
from ..train import (MultiTransformAdam, fit, fit_wan, leaf_labels, make_optimizer,
                     make_wan_optimizers)
from ._fused_wan import make_fused_wan_pair
from .ipw import check_jet_impl, fused_residual_step, on_device, polish


@dataclasses.dataclass
class QHO2DConfig:
    nx: int = 0
    ny: int = 0
    L: float = 6.0
    epochs: int = 10000
    lr: float = 1e-3
    LBFGS: bool = False
    method: str = "PINN"               # PINN | DRM | WAN
    technique: str = "FBC"             # FBC | FN | OG
    layers: Tuple[int, ...] = (2, 50, 50, 50, 50, 1)
    v_layers: Tuple[int, ...] = (2, 20, 20, 20, 1)
    v_steps: int = 5
    grid_n: int = 200
    data_grid_n: int = 50
    n_boundary: int = 200
    trainable_energy: bool = False     # the reference's Energy variant
    # the E leaf's own Adam lr (None: the net's); a 10-100x smaller one
    # keeps E from drifting over long runs
    energy_lr: Optional[float] = None
    energy_variant: bool = False       # the Energy variant's weight table
    # WAN saddle-point knobs (train/trainer.py fit_wan)
    minimax: str = "alternating"       # alternating | extragradient | optimistic
    v_lr: Optional[float] = None       # two-timescale critic lr
    u_ema: float = 0.0                 # EMA-averaged primal iterate
    seed: int = 0
    lr_schedule: str = "constant"   # constant | cosine | exponential
    chunk: int = 500
    weights: Optional[Dict[str, float]] = None   # override the weight table
    jet_impl: str = "torch"           # torch | kernel | fused (module docstring)


def _factor(technique: str, nx: int, ny: int, L: float):
    return factor_for_technique(
        technique, dim=2, kind="window", L=L,
        nodes_per_dim=[phys.nodes(nx), phys.nodes(ny)] if technique == "FN" else None)


def _lower_states_2d(nx: int, ny: int, X):
    """(i, j) with i + j + 1 < nx + ny + 1, i and j up to max(nx, ny) (the
    reference's loop bound: a lower state with one index above it, such as
    (3, 0) below (2, 2), is not penalised, as in the reference)."""
    cols = []
    for i in range(max(nx, ny) + 1):
        for j in range(max(nx, ny) + 1):
            if i + j + 1 < nx + ny + 1:
                cols.append(phys.psi_2d(i, j, X[:, 0], X[:, 1]))
    if not cols:
        return torch.zeros((X.shape[0], 0), dtype=X.dtype, device=X.device)
    return torch.stack(cols, dim=1)


def train_qho_2d(cfg: QHO2DConfig, init_params=None, init_v_params=None,
                 device="cuda") -> Dict:
    """Train the configured 2D-oscillator solver; returns the JAX entry
    point's keys (``config``, ``model``, ``result``, ``history``,
    ``L2_error``, ``min_epoch``, ``learned_energy``, ``E_exact``,
    ``weights``).  ``init_params`` / ``init_v_params`` warm-start the nets
    (e.g. weights carried over by
    :func:`nnpde_tpu_torch.interop.params_from_jax`)."""
    if cfg.method not in ("PINN", "DRM", "WAN"):
        raise ValueError("method must be 'PINN', 'DRM' or 'WAN'")
    if cfg.technique not in ("FBC", "FN", "OG"):
        raise ValueError(f"Unknown technique: {cfg.technique}")
    if cfg.trainable_energy and cfg.method != "PINN":
        raise ValueError(
            "trainable_energy requires method='PINN' (E is trained through the "
            "strong residual): a DRM/WAN run would silently train with the fixed exact E")
    check_jet_impl(cfg.jet_impl)
    dev = runtime.resolve_device(device)
    runtime.pin_fp32_precision()
    nx, ny, L = cfg.nx, cfg.ny, cfg.L

    u_model = SolutionModel(NetSpec(tuple(cfg.layers), activation="sin"),
                            _factor(cfg.technique, nx, ny, L))
    key = cfg.seed
    net_params = on_device(init_params if init_params is not None
                           else u_model.init(generator(key, dev)), dev)
    zero = torch.zeros((), device=dev)

    X = meshgrid_2d(cfg.grid_n, -L, L, device=dev)
    u_exact = phys.psi_2d(nx, ny, X[:, 0], X[:, 1])
    V = phys.potential_2d(X[:, 0], X[:, 1])
    E_exact = phys.energy_2d(nx, ny)

    # supervised quadrant: the first half x half block of the data grid
    Xd_full = meshgrid_2d(cfg.data_grid_n, -L, L, device=dev)
    ii = torch.arange(cfg.data_grid_n // 2, device=dev)
    X_data = Xd_full[(ii[:, None] * cfg.data_grid_n + ii[None, :]).reshape(-1)]
    u_data = phys.psi_2d(nx, ny, X_data[:, 0], X_data[:, 1])

    tb = torch.linspace(-L, L, cfg.n_boundary, device=dev)
    X_bc = torch.cat([
        torch.stack([tb, torch.full_like(tb, -L)], 1),
        torch.stack([tb, torch.full_like(tb, L)], 1),
        torch.stack([torch.full_like(tb, -L), tb], 1),
        torch.stack([torch.full_like(tb, L), tb], 1),
    ])

    lower = _lower_states_2d(nx, ny, X)

    # the weight tables of the reference and of its Energy variant
    if cfg.method == "WAN":
        w = {
            "data": 10000.0, "pde": 10.0, "drm": 0.0, "norm": 1000.0,
            "orth": (10000.0 if (cfg.energy_variant and cfg.technique == "OG") else 0.0),
            "bc": (0.0 if cfg.energy_variant
                   else (10000.0 if cfg.technique == "OG" else 0.0)),
        }
    else:
        w = {
            "data": 10000.0,
            "pde": 100.0 if cfg.method == "PINN" else 0.0,
            "drm": 0.0 if cfg.method == "PINN" else 100.0,
            "orth": 0.0 if cfg.method == "PINN" else 10000.0,
            "norm": 0.0,
            "bc": (0.0 if cfg.energy_variant
                   else (10000.0 if cfg.technique == "OG" else 0.0)),
        }
    w["parity"] = 1000.0 if cfg.energy_variant else 1.0
    w["symmetry"] = 1000.0 if cfg.energy_variant else 1.0
    if cfg.weights:
        w.update(cfg.weights)

    sign_x = float((-1) ** nx)
    sign_y = float((-1) ** ny)
    X_swap = X.flip(1)
    X_px = torch.stack([-X[:, 0], X[:, 1]], 1)
    X_py = torch.stack([X[:, 0], -X[:, 1]], 1)

    def shared_terms(net_p, u):
        # one batched forward over the reflected point sets
        refl = torch.cat(([X_swap] if nx == ny else []) + [X_px, X_py], dim=0)
        parts = torch.chunk(u_model.apply_batch(net_p, refl), 3 if nx == ny else 2)
        return {
            "data": data_mse(u_model.apply_batch(net_p, X_data), u_data),
            "symmetry": reflection_mse(u, parts[0]) if nx == ny else zero,
            "parity": (reflection_mse(u, parts[-2], sign_x)
                       + reflection_mse(u, parts[-1], sign_y)),
            "orth": (orthogonal_projection(u, lower, 4.0 * L * L) if w["orth"] > 0
                     else zero),
            "bc": (torch.mean(u_model.apply_batch(net_p, X_bc) ** 2) * 4.0 if w["bc"] > 0
                   else zero),
        }

    def eval_fn_net(net_p):
        return sign_aware_mse(u_model.apply_batch(net_p, X), u_exact)

    use_E_param = cfg.trainable_energy and cfg.method == "PINN"

    if cfg.method in ("PINN", "DRM"):
        params = {"net": net_params}
        if use_E_param:
            params["E"] = torch.tensor(E_exact, dtype=torch.float32, device=dev)

        # the two-pass fused Rayleigh quotient with the 2D potential
        fused_drm = cfg.method == "DRM" and cfg.jet_impl == "fused"
        if fused_drm:
            ray_loss = make_fused_rayleigh(u_model.spec.activation, weight=1.0, den_eps=1e-8)
            coef_ray = quotient_coefficients(u_model.factor.jet(X), V=V)

        def loss_fn(params, key):
            net_p = params["net"]
            if fused_drm:
                drm, aux_ray = ray_loss(net_p, X, coef_ray)
                u = u_model.apply_batch(net_p, X)
                terms = {"pde": zero, "drm": aux_ray["rayleigh"], "norm": zero}
                terms.update(shared_terms(net_p, u))
                total = w["drm"] * drm + sum(w[k] * terms[k] for k in w
                                             if k not in ("drm", "pde"))
                return total, terms
            if cfg.method == "PINN":
                # 'fused' trains on lag_fn; its loss_fn (the polish's
                # objective) takes the torch jet
                jet = u_model.fields(net_p, X,
                                     impl="kernel" if cfg.jet_impl == "kernel" else "torch")
                u = jet.value
                E_use = params["E"] if use_E_param else E_exact
                pde, drm = pinn_schrodinger(u, jet.lap, V, E_use), zero
            else:
                u, g = u_model.value_and_grad(net_p, X)
                pde, drm = zero, drm_rayleigh(u, g, V, den_eps=1e-8)
            terms = {"pde": pde, "drm": drm, "norm": zero}
            terms.update(shared_terms(net_p, u))
            total = sum(w[k] * terms[k] for k in w)
            if use_E_param:
                terms["E"] = params["E"]
            return total, terms

        def eval_fn(params, key):
            return eval_fn_net(params["net"])

        fit_kw = {}
        if cfg.jet_impl == "fused" and cfg.method == "PINN":
            # one fused launch on r = -1/2 lap u + (V - E) u, u = B*net; the
            # coefficients from the fixed window-factor jet, rebuilt per step
            # only through the trainable E (e lane: B, for dL/dE)
            fj = u_model.factor.jet(X)
            if use_E_param:
                def coef(E):
                    return residual_coefficients(fj, a0=-0.5, c0=V - E, e_lane=True)
            else:
                coef = residual_coefficients(fj, a0=-0.5, c0=V - E_exact)

            def aux_terms(p, u):
                terms = shared_terms(p["net"], u)
                total = sum(w[k] * terms[k] for k in terms)
                return total, {"norm": zero, **terms}

            fit_kw["loss_and_grad_fn"] = fused_residual_step(u_model, X, coef, w["pde"],
                                                             aux_terms, zero)

        optimizer = make_optimizer(cfg.lr, schedule=cfg.lr_schedule, total_steps=cfg.epochs)
        if use_E_param and cfg.energy_lr is not None:
            # per-leaf lr: the net keeps the scheduled Adam, E gets its own
            optimizer = MultiTransformAdam(
                {"net": optimizer,
                 "E": make_optimizer(cfg.energy_lr, schedule=cfg.lr_schedule,
                                     total_steps=cfg.epochs)},
                leaf_labels(params, {"net": "net", "E": "E"}))
        result = fit(loss_fn, eval_fn, params, epochs=cfg.epochs, optimizer=optimizer,
                     key=fold_in(key, 1), chunk=cfg.chunk, **fit_kw)
        if cfg.LBFGS:
            result = polish(result, lambda p: loss_fn(p, None)[0], eval_fn, result.params,
                            500, cfg.epochs)
        learned_E = float(result.best_params["E"]) if use_E_param else E_exact
    else:  # WAN
        v_model = SolutionModel(NetSpec(tuple(cfg.v_layers), activation="sin"),
                                _factor("FBC", nx, ny, L))
        u_params = {"net": net_params}
        v_params = on_device(init_v_params if init_v_params is not None
                             else v_model.init(generator(fold_in(key, 9), dev)), dev)
        wv, dwv = bump_w(X, -L, L)

        # the two-pass fused WAN objectives with the fixed exact E
        fused_wan = cfg.jet_impl == "fused"
        if fused_wan:
            pair = make_fused_wan_pair(u_model, v_model, w_pde=w["pde"])
            E_fix = torch.tensor(E_exact, dtype=torch.float32, device=dev)

            # fixed grid: the critic's coefficient stream once per epoch
            def v_context_fn(u_params, key):
                return pair.v_coef_fn(u_params["net"], E_fix, X, wv, dwv, V=V)
        else:
            # u's (value, grad) at the fixed grid, once per epoch
            def v_context_fn(u_params, key):
                return u_model.value_and_grad(u_params["net"], X)

        def wan_pde(u_params, v_params, ugu=None):
            u, gu = ugu if ugu is not None else u_model.value_and_grad(u_params["net"], X)
            v, gv = v_model.value_and_grad(v_params, X)
            phi = wv * v
            gphi = dwv * v[:, None] + wv[:, None] * gv
            weak = wan_weak_residual(gu, phi, gphi, u=u, V=V, E=E_exact, prefactor=0.5)
            return wan_pde_loss(weak, torch.mean(phi ** 2)), u

        def v_loss_fn(v_params, ctx, key):
            if fused_wan:
                return pair.v_loss_from_coef(v_params, X, ctx)[0]
            return -torch.log(wan_pde(None, v_params, ugu=ctx)[0] + 1e-8)

        def u_loss_fn(u_params, v_params, key):
            if fused_wan:
                pde_w, aux = pair.u_pde_fn(u_params["net"], E_fix, v_params, X, wv, dwv, V=V)
                loss_pde = aux["pde_loss"]
                u = u_model.apply_batch(u_params["net"], X)
            else:
                loss_pde, u = wan_pde(u_params, v_params)
                pde_w = w["pde"] * loss_pde
            terms = {"pde": loss_pde, "drm": zero, "norm": norm_integral(u, 4.0 * L * L)}
            terms.update(shared_terms(u_params["net"], u))
            return pde_w + sum(w[k] * terms[k] for k in w if k != "pde"), terms

        def eval_fn(u_params, key):
            return eval_fn_net(u_params["net"])

        u_opt, v_opt = make_wan_optimizers(cfg.lr, v_lr=cfg.v_lr, schedule=cfg.lr_schedule,
                                           epochs=cfg.epochs, v_steps=cfg.v_steps)
        result = fit_wan(u_loss_fn, v_loss_fn, eval_fn, u_params, v_params,
                         epochs=cfg.epochs, v_steps=cfg.v_steps, u_optimizer=u_opt,
                         v_optimizer=v_opt, key=fold_in(key, 1), chunk=cfg.chunk,
                         minimax=cfg.minimax, u_ema=cfg.u_ema, v_context_fn=v_context_fn)
        learned_E = E_exact

    return {
        "config": dataclasses.asdict(cfg),
        "model": u_model,
        "result": result,
        "history": result.history,
        "L2_error": float(result.best_metric),
        "min_epoch": result.best_epoch,
        "learned_energy": learned_E,
        "E_exact": E_exact,
        "weights": w,
    }
