"""Kramers-Henneberger 1D preset: PINN / DRM / WAN with a trainable energy
against the finite-difference ground truth.

Counterpart of ``nnpde_tpu/problems/kh.py``, with the same config fields
and defaults:

* the eigenvalue E is a leaf of the primal parameters (``{"net": [...],
  "E": tensor}``), used by the PINN residual and the WAN weak form; DRM
  tracks the Rayleigh quotient as its energy estimate instead;
* the cycle-averaged potential is evaluated once per grid (the ground
  truth's ``resample``);
* WAN: the critic ascends ``pde_loss`` directly (no ``-log``) at twice the
  primal's learning rate, with the ratio-squared normalisation; the primal
  net is raw (RAW), the critic has no trial factor;
* data on the first ``data_fraction`` of the grid points capped at
  ``max_data_points``, orthogonality against the FD lower states, the
  boundary penalty ``u[0]^2 + u[-1]^2``, an optional parity loss;
* sign-aware best tracking on the train grid; :func:`run_compare` adds the
  dense-grid L2 and the JSON row schema, and with ``save_dir`` the
  parameters, curves, plots and ledger rows (:mod:`nnpde_tpu_torch.exp`).

``jet_impl`` takes the port's names (the JAX names raise): ``'torch'``;
``'kernel'`` (the PINN residual's jet through the jet kernel pair, rows 4
and 5; DRM and WAN on the torch path, as the JAX package's ``'pallas'``);
``'fused'`` (PINN through the one-pass fused residual, row 1, on ``-1/2 lap
u + (V - E) u`` with E's gradient from the kernel's e lane, the factor jet
of RAW the constant 1; DRM through the two-pass fused Rayleigh quotient
with V, rows 9 and 10; WAN through the two-pass weak-form kernels in the
ratio-squared convention with ``eps = 1e-12 / (2L)`` and the critic's
direct ascent, rows 4, 7 and 8).  On CPU tensors every kernel wrapper takes
its plain version.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from .. import runtime
from ..exp import append_result, save_curves, save_params
from ..kernels import make_fused_rayleigh, quotient_coefficients, residual_coefficients
from ..losses import data_mse, norm_integral, orthogonal_projection
from ..models import NetSpec, SolutionModel, factor_for_technique
from ..ops import bump_w
from ..ops.quadrature import integral_mean, sign_aware_mse
from ..pde import kh as phys
from ..prng import fold_in, threefry_fold_in, threefry_key
from ..train import fit, fit_wan, make_optimizer
from ._fused_wan import factor_jet_or_one, make_fused_wan_pair
from .ipw import check_jet_impl, fused_residual_step, on_device


@dataclasses.dataclass
class KHConfig:
    method: str = "PINN"               # PINN | DRM | WAN
    n: int = 0                         # eigenstate index
    technique: str = "RAW"             # RAW | FBC (WAN forces RAW)
    layers: Tuple[int, ...] = (1, 64, 64, 64, 1)
    epochs: int = 10000
    lr: float = 1e-3
    # loss weights (the reference's train_state_v2 defaults)
    lambda_pde: float = 1.0
    lambda_data: float = 1.0
    lambda_orth: float = 1e4
    lambda_norm: float = 1e3
    lambda_bc: float = 1e4
    lambda_parity: float = 0.0
    data_fraction: float = 0.25
    max_data_points: Optional[int] = None
    v_layers: Tuple[int, ...] = (1, 50, 50, 50, 1)
    v_steps: int = 3
    train_n: int = 1024
    seed: int = 0
    chunk: int = 1000
    jet_impl: str = "torch"           # torch | kernel | fused (module docstring)


def _u_model(cfg: KHConfig, L: float) -> SolutionModel:
    technique = "RAW" if cfg.method == "WAN" else cfg.technique
    factor = factor_for_technique(technique, dim=1, kind="window", L=L)
    return SolutionModel(NetSpec(tuple(cfg.layers), activation="sin"), factor)


def train_kh(cfg: KHConfig, gt: phys.KHGroundTruth, x_train=None, init_params=None,
             init_v_params=None, device="cuda") -> Dict:
    """Train one KH level against ``gt``; returns the JAX entry point's keys
    (``config``, ``model``, ``result``, ``history``, ``L2``, ``best_epoch``,
    ``E_est``, ``E_ref``, ``E_track``, ``idx_data``).  ``x_train``: the
    training grid (default ``train_n`` points on ``[-L, L]``);
    ``init_params`` / ``init_v_params`` warm-start the nets (E starts at
    the reference energy, as in JAX).

    ``cfg.seed`` gives the JAX package's initial weights (same seed, the
    same weights bit for bit); the points and the epochs' keys draw from
    torch's generators, so they differ from JAX's.
    """
    if cfg.method not in ("PINN", "DRM", "WAN"):
        raise ValueError("method must be 'PINN' | 'DRM' | 'WAN'")
    check_jet_impl(cfg.jet_impl)
    dev = runtime.resolve_device(device)
    runtime.pin_fp32_precision()
    L = gt.L
    n = cfg.n
    model = _u_model(cfg, L)
    key = cfg.seed

    if x_train is None:
        x = torch.linspace(-L, L, cfg.train_n, dtype=torch.float32, device=dev)
    else:
        x = torch.as_tensor(x_train, dtype=torch.float32, device=dev)
    X = x.reshape(-1, 1)

    # the ground truth on the train grid (V once per grid)
    _, V_train, psi_train = gt.resample(x)
    psi_n = psi_train[:, n]
    lower = psi_train[:, :n]

    m = x.shape[0]
    k_data = max(1, int(m * cfg.data_fraction))
    if cfg.max_data_points is not None:
        k_data = min(k_data, int(cfg.max_data_points))
    idx_data = torch.arange(k_data, device=dev)
    psi_data = psi_n[idx_data]

    E_init = gt.energy(n)
    net = on_device(init_params if init_params is not None
                    else model.init(key), dev)
    u_params = {"net": net, "E": torch.tensor(E_init, dtype=torch.float32, device=dev)}
    zero = torch.zeros((), device=dev)

    parity_sign = 1.0 if n % 2 == 0 else -1.0
    X_neg = -X

    def orth_term(u):
        # eps 1e-12 in the projection denominators, as the reference's KH
        return orthogonal_projection(u, lower, 2.0 * L, eps=1e-12) if n > 0 else zero

    def common_terms(net_p, u):
        data = data_mse(u[idx_data], psi_data) if cfg.lambda_data != 0 else zero
        bc = u[0] ** 2 + u[-1] ** 2
        if cfg.lambda_parity != 0.0:
            parity = torch.mean((u - parity_sign * model.apply_batch(net_p, X_neg)) ** 2)
        else:
            parity = zero
        return data, orth_term(u), bc, parity

    def weighted(data, orth, norm_pen, bc, parity):
        return (cfg.lambda_data * data + cfg.lambda_orth * orth + cfg.lambda_norm * norm_pen
                + cfg.lambda_bc * bc + cfg.lambda_parity * parity)

    def eval_fn(params, key):
        return sign_aware_mse(model.apply_batch(params["net"], X), psi_n)

    if cfg.method in ("PINN", "DRM"):
        # the fused eigen-DRM: KH's integral-mean +1e-12 denominator is a
        # plain-mean den_eps of 1e-12/(2L)
        fused_drm = cfg.method == "DRM" and cfg.jet_impl == "fused"
        if fused_drm:
            ray_loss = make_fused_rayleigh(model.spec.activation, weight=1.0,
                                           den_eps=1e-12 / (2.0 * L))
            coef_ray = quotient_coefficients(factor_jet_or_one(model, X), V=V_train)

        def loss_fn(params, key):
            net_p = params["net"]
            if fused_drm:
                core, aux_ray = ray_loss(net_p, X, coef_ray)
                u = model.apply_batch(net_p, X)
                E_tracked = aux_ray["rayleigh"]      # no gradient flows through it
            elif cfg.method == "PINN":
                jet = model.fields(net_p, X,
                                   impl="kernel" if cfg.jet_impl == "kernel" else "torch")
                u = jet.value
                r = -0.5 * jet.lap + V_train * u - params["E"] * u
                core = torch.mean(r ** 2)
                E_tracked = params["E"]
            else:
                u, g = model.value_and_grad(net_p, X)
                num = integral_mean(0.5 * g[:, 0] ** 2 + V_train * u ** 2, 2.0 * L)
                den = integral_mean(u ** 2, 2.0 * L) + 1e-12
                core = num / den
                E_tracked = core.detach()
            data, orth, bc, parity = common_terms(net_p, u)
            norm_pen = norm_integral(u, 2.0 * L)
            total = cfg.lambda_pde * core + weighted(data, orth, norm_pen, bc, parity)
            return total, {"pde": core, "data": data, "orth": orth, "norm": norm_pen,
                           "bc": bc, "parity": parity, "E": E_tracked}

        fit_kw = {}
        if cfg.jet_impl == "fused" and cfg.method == "PINN":
            # one fused launch on r = -1/2 lap u + (V - E) u, u = B*net (B = 1
            # for RAW); the e lane (B) gives dL/dE
            fj = factor_jet_or_one(model, X)

            def coef(E):
                return residual_coefficients(fj, a0=-0.5, c0=V_train - E, e_lane=True)

            def aux_terms(p, u):
                data, orth, bc, parity = common_terms(p["net"], u)
                norm_pen = norm_integral(u, 2.0 * L)
                return (weighted(data, orth, norm_pen, bc, parity),
                        {"data": data, "orth": orth, "norm": norm_pen, "bc": bc,
                         "parity": parity})

            fit_kw["loss_and_grad_fn"] = fused_residual_step(model, X, coef, cfg.lambda_pde,
                                                             aux_terms, None)

        result = fit(loss_fn, eval_fn, u_params, epochs=cfg.epochs,
                     optimizer=make_optimizer(cfg.lr), key=fold_in(key, 1), chunk=cfg.chunk,
                     **fit_kw)
    else:  # WAN
        v_model = SolutionModel(NetSpec(tuple(cfg.v_layers), activation="sin"))
        v_params = on_device(init_v_params if init_v_params is not None
                             else v_model.init(threefry_fold_in(threefry_key(key), 9)),
                             dev)
        wv, dwv = bump_w(X, -L, L)

        # the fused pair: KH's ratio-squared convention with integral means
        # is plain means with eps = 1e-12/(2L); the critic ascends directly
        fused_wan = cfg.jet_impl == "fused"
        if fused_wan:
            pair = make_fused_wan_pair(model, v_model, w_pde=cfg.lambda_pde,
                                       convention="ratio_sq", eps=1e-12 / (2.0 * L),
                                       objective="neg")

            # fixed grid: the critic's coefficient stream once per epoch
            def v_context_fn(u_params, key):
                return pair.v_coef_fn(u_params["net"], u_params["E"], X, wv, dwv, V=V_train)
        else:
            # u's (value, grad) and the current E, once per epoch
            def v_context_fn(u_params, key):
                u, gu = model.value_and_grad(u_params["net"], X)
                return u, gu, u_params["E"]

        def wan_pde(params, v_params, ctx=None):
            if ctx is None:
                u, gu = model.value_and_grad(params["net"], X)
                E_cur = params["E"]
            else:
                u, gu, E_cur = ctx
            v, gv = v_model.value_and_grad(v_params, X)
            phi = wv * v
            gphi = dwv[:, 0] * v + wv * gv[:, 0]
            I_kin_pot = integral_mean(0.5 * gu[:, 0] * gphi + V_train * u * phi, 2.0 * L)
            I_full = I_kin_pot - E_cur * integral_mean(u * phi, 2.0 * L)
            norm_phi = integral_mean(phi ** 2, 2.0 * L) + 1e-12
            return (I_full / norm_phi) ** 2, u

        def v_loss_fn(v_params, ctx, key):
            if fused_wan:
                return pair.v_loss_from_coef(v_params, X, ctx)[0]
            return -wan_pde(None, v_params, ctx=ctx)[0]

        def u_loss_fn(u_params, v_params, key):
            if fused_wan:
                pde_w, aux = pair.u_pde_fn(u_params["net"], u_params["E"], v_params, X, wv,
                                           dwv, V=V_train)
                pde = aux["pde_loss"]
                u = model.apply_batch(u_params["net"], X)
            else:
                pde, u = wan_pde(u_params, v_params)
                pde_w = cfg.lambda_pde * pde
            norm_u = norm_integral(u, 2.0 * L)
            data, orth, bc, parity = common_terms(u_params["net"], u)
            total = pde_w + weighted(data, orth, norm_u, bc, parity)
            return total, {"pde": pde, "data": data, "orth": orth, "norm": norm_u, "bc": bc,
                           "parity": parity, "E": u_params["E"]}

        result = fit_wan(u_loss_fn, v_loss_fn, eval_fn, u_params, v_params, epochs=cfg.epochs,
                         v_steps=cfg.v_steps, u_optimizer=make_optimizer(cfg.lr),
                         v_optimizer=make_optimizer(cfg.lr * 2.0), key=fold_in(key, 1),
                         chunk=cfg.chunk, v_context_fn=v_context_fn)

    history = result.history
    return {
        "config": dataclasses.asdict(cfg),
        "model": model,
        "result": result,
        "history": history,
        "L2": float(result.best_metric),
        "best_epoch": result.best_epoch,
        "E_est": (float(result.best_params["E"]) if cfg.method != "DRM"
                  else float(history["E"][result.best_epoch])),
        "E_ref": E_init,
        "E_track": history["E"],
        "idx_data": idx_data.cpu().numpy(),
    }


# ------------------------------------------------------------- run_compare
@dataclasses.dataclass
class KHCompareConfig:
    alpha: float = 10.0
    v0: float = phys.V0_DEFAULT
    L: float = 60.0
    n_ref: int = 5000
    n_max: int = 4
    use_avg: bool = True
    n_theta: int = 500
    train_n: int = 1024
    layers: Tuple[int, ...] = (1, 100, 100, 100, 1)
    technique: str = "FBC"
    v_layers: Tuple[int, ...] = (1, 50, 50, 50, 1)
    v_steps: int = 3
    epochs: int = 10000
    lr: float = 1e-3
    lambda_pde: float = 10.0
    lambda_data: float = 1e4
    lambda_orth: float = 1e4
    lambda_norm: float = 10.0
    lambda_bc: float = 1e4
    lambda_parity: float = 1e4
    data_fraction: float = 0.25
    max_data_points: Optional[int] = 128
    methods: Tuple[str, ...] = ("PINN", "DRM", "WAN")
    jet_impl: str = "torch"
    save_dir: Optional[str] = None
    results_filename: str = "results_KH_1D_unified.json"
    seed: int = 0
    chunk: int = 1000


def run_compare(cfg: KHCompareConfig, device="cuda") -> List[dict]:
    """Build the ground truth once, train methods x levels; with
    ``save_dir``, save each run's best parameters, curves, plot and ledger
    row.  Returns the rows."""
    dev = runtime.resolve_device(device)
    gt = phys.KHGroundTruth(alpha=cfg.alpha, v0=cfg.v0, L=cfg.L, N=cfg.n_ref,
                            n_levels=max(cfg.n_max + 2, 10), use_avg=cfg.use_avg,
                            n_theta=cfg.n_theta, device=dev)
    x_train = torch.linspace(-cfg.L, cfg.L, cfg.train_n, dtype=torch.float32, device=dev)
    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    rows = []
    for n in range(cfg.n_max):
        for method in cfg.methods:
            t0 = time.time()
            run_cfg = KHConfig(
                method=method, n=n, technique=("RAW" if method == "WAN" else cfg.technique),
                layers=cfg.layers, epochs=cfg.epochs, lr=cfg.lr, lambda_pde=cfg.lambda_pde,
                lambda_data=cfg.lambda_data, lambda_orth=cfg.lambda_orth,
                lambda_norm=cfg.lambda_norm, lambda_bc=cfg.lambda_bc,
                lambda_parity=cfg.lambda_parity, data_fraction=cfg.data_fraction,
                max_data_points=cfg.max_data_points, v_layers=cfg.v_layers,
                v_steps=cfg.v_steps, train_n=cfg.train_n, seed=cfg.seed, chunk=cfg.chunk,
                jet_impl=cfg.jet_impl)
            res = train_kh(run_cfg, gt, x_train=x_train, device=dev)
            elapsed = time.time() - t0

            # the dense-grid final L2
            with torch.no_grad():
                u_dense = res["model"].apply_batch(res["result"].best_params["net"],
                                                   gt.x.reshape(-1, 1))
                l2_dense = float(sign_aware_mse(u_dense, gt.psi[:, n]))
            row = {
                "method": method,
                "n": int(n),
                "alpha": float(cfg.alpha),
                "V0": float(cfg.v0),
                "L": float(cfg.L),
                "use_avg": bool(cfg.use_avg),
                "n_theta": int(cfg.n_theta),
                "train_N": int(cfg.train_n),
                "epochs": int(cfg.epochs),
                "lr": float(cfg.lr),
                "technique": run_cfg.technique,
                "E_ref": float(gt.energy(n)),
                "E_est": res["E_est"],
                "L2_error_train_best": res["L2"],
                "L2_error_dense": l2_dense,
                "elapsed_time_sec": float(elapsed),
                "best_epoch": int(res["best_epoch"]),
                "time_of_best_epoch_est": (elapsed * res["best_epoch"] / cfg.epochs
                                           if res["best_epoch"] >= 0 else None),
                "timestamp": timestamp,
                "data_fraction": float(cfg.data_fraction),
                "max_data_points": cfg.max_data_points,
                "v_steps": (cfg.v_steps if method == "WAN" else None),
            }
            if cfg.save_dir:
                tag = f"KH1D_{method}_n{n}_alpha{cfg.alpha:+.3f}_{timestamp}"
                from ..exp.plotting import plot_solution_gt

                row["plot_path"] = plot_solution_gt(
                    gt.x, gt.psi[:, n], u_dense, gt.V, res["E_est"], method, n,
                    os.path.join(cfg.save_dir, tag + ".png"))
                row["model_path"] = save_params(
                    os.path.join(cfg.save_dir, tag + "_best"), res["result"].best_params,
                    meta={"problem": "kh_1d", "layers": list(cfg.layers), "activation": "sin",
                          "technique": run_cfg.technique, "n": n, "L": float(cfg.L),
                          "alpha": float(cfg.alpha)})
                curve_paths = save_curves(cfg.save_dir, tag,
                                          {"losses": res["history"]["total"],
                                           "L2": res["history"]["l2"],
                                           "Etrack": res["E_track"]})
                row["losses_npy"] = curve_paths["losses"]
                row["l2s_npy"] = curve_paths["L2"]
                row["Etrack_npy"] = curve_paths["Etrack"]
                append_result(os.path.join(cfg.save_dir, cfg.results_filename), row)
            rows.append(row)
    return rows
