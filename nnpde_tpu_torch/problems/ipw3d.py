"""3D infinite potential well preset (PINN / DRM, techniques FBC / FN).

Counterpart of ``nnpde_tpu/problems/ipw3d.py``, with the same
:class:`IPW3DConfig` fields and defaults: psi_{nx,ny,nz} on ``[0, L]^3`` by
sampled collocation (uniform, or scrambled Sobol with a fresh
Cranley-Patterson rotation every epoch), the separable trial factors one
dimension up (FBC box polynomial, FN nodal planes per axis), supervised data
on a coarse first-octant lattice pinning sign and amplitude, and the
analytic ground truth ``pde/ipw.py::psi_3d`` scored as plain MSE on a fixed
uniform eval set.

``jet_impl`` takes the port's names (the JAX package's ``'xla'``,
``'pallas'`` and ``'pallas-fused'`` raise and name the port's):

* ``'torch'``: the forward-Laplacian recurrence (PINN) or per-point autodiff
  (DRM) under ``torch.autograd``;
* ``'kernel'``: the PINN residual's jet through the jet kernel pair
  (:func:`~nnpde_tpu_torch.kernels.mlp_fwdlap_kernel`, forward and recompute
  backward); DRM runs its ``'torch'`` path, as in the JAX package;
* ``'fused'``: PINN through the one-pass fused Helmholtz residual
  (:func:`~nnpde_tpu_torch.kernels.fused_linear_residual`, coefficients
  ``residual_coefficients(a0=1, c0=k^2)`` from the factor jet), DRM through
  the two-pass fused Rayleigh quotient
  (:func:`~nnpde_tpu_torch.kernels.make_fused_rayleigh`); with resampling
  the coefficients are rebuilt every step.

On CPU tensors every kernel wrapper takes its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .. import runtime
from ..kernels import (
    fused_linear_residual,
    make_fused_rayleigh,
    quotient_coefficients,
    residual_coefficients,
)
from ..losses import data_mse, drm_rayleigh_unscaled, pinn_helmholtz
from ..models import NetSpec, SolutionModel, factor_for_technique
from ..pde import ipw as phys
from ..pde.domain import Box
from ..prng import fold_in, generator
from ..sampling import shifted_qmc, sobol_unit, uniform_box
from ..train import fit, make_optimizer
from .ipw import check_jet_impl


@dataclasses.dataclass
class IPW3DConfig:
    nx: int = 1
    ny: int = 1
    nz: int = 1
    L: float = 2.0
    method: str = "PINN"               # PINN | DRM
    technique: str = "FN"              # FBC | FN
    layers: Tuple[int, ...] = (3, 64, 64, 64, 64, 1)
    n_interior: int = 131072
    data_grid_n: int = 16              # coarse first-octant supervision
    epochs: int = 5000
    lr: float = 1e-3
    lr_schedule: str = "cosine"
    resample: bool = True
    sampler: str = "sobol"             # uniform | sobol
    jet_impl: str = "torch"            # torch | kernel | fused (module docstring)
    weights: Optional[Dict[str, float]] = None
    n_eval: int = 65536
    seed: int = 0
    chunk: int = 500


def _validate(cfg: IPW3DConfig) -> None:
    if cfg.method not in ("PINN", "DRM"):
        raise ValueError("method must be 'PINN' or 'DRM'")
    if cfg.technique not in ("FBC", "FN"):
        raise ValueError(f"Unknown technique: {cfg.technique}")
    check_jet_impl(cfg.jet_impl)
    if cfg.sampler not in ("uniform", "sobol"):
        raise ValueError("sampler must be 'uniform' or 'sobol'")


def _objective(cfg: IPW3DConfig, model: SolutionModel, w, k_squared, X_data, u_data):
    """The training objective at given points: ``(loss_at, lag_at)`` with
    ``loss_at(params, X) -> (total, metrics)`` on ``cfg.jet_impl``'s route
    (autograd through it gives the gradients) and, for the fused PINN,
    ``lag_at(params, X) -> ((total, metrics), grads)`` (else None)."""
    act = model.spec.activation
    zero = torch.zeros((), device=X_data.device)
    fused = cfg.jet_impl == "fused"
    if fused and cfg.method == "DRM":
        # two-pass Rayleigh quotient; weight 2x turns the kernel's 1/2|grad|^2
        # numerator into the unscaled well convention
        ray_loss = make_fused_rayleigh(act, weight=2.0 * w["drm"], den_eps=1e-8)

    def data_term(params):
        return data_mse(model.apply_batch(params, X_data), u_data)

    def loss_at(params, X):
        if fused and cfg.method == "DRM":
            total_drm, aux = ray_loss(params, X, quotient_coefficients(model.factor.jet(X)))
            data = data_term(params)
            return total_drm + w["data"] * data, {"pde": zero, "drm": 2.0 * aux["rayleigh"],
                                                  "data": data}
        if cfg.method == "PINN":
            jet = model.fields(params, X, impl="kernel" if cfg.jet_impl == "kernel" else "torch")
            pde, drm = pinn_helmholtz(jet.value, jet.lap, k_squared), zero
        else:
            u, grad = model.value_and_grad(params, X)
            pde, drm = zero, drm_rayleigh_unscaled(u, grad, den_eps=1e-8)
        data = data_term(params)
        total = w["pde"] * pde + w["drm"] * drm + w["data"] * data
        return total, {"pde": pde, "drm": drm, "data": data}

    if not (fused and cfg.method == "PINN"):
        return loss_at, None

    def lag_at(params, X):
        """The Helmholtz residual ``lap u + k^2 u`` (u = B * net) through one
        fused launch, the data term on autograd."""
        coef = residual_coefficients(model.factor.jet(X), a0=1.0, c0=k_squared)
        pde, _, g_pde = fused_linear_residual(params, X, coef, act)
        with torch.enable_grad():
            data_tot = w["data"] * data_term(params)
            g_aux = torch.autograd.grad(data_tot, [t for pair in params for t in pair])
        grads = [(w["pde"] * gW + g_aux[2 * i], w["pde"] * gb + g_aux[2 * i + 1])
                 for i, (gW, gb) in enumerate(g_pde)]
        total = w["pde"] * pde + data_tot.detach()
        return (total, {"pde": pde, "drm": zero, "data": data_tot.detach() / w["data"]}), grads

    return loss_at, lag_at


def train_ipw_3d(cfg: IPW3DConfig, device="cuda") -> Dict:
    """Train the configured 3D-well eigen-solver; returns the JAX entry
    point's keys (``config``, ``model``, ``result``, ``history``,
    ``L2_error``, ``rel_l2``, ``min_epoch``, ``E_exact``, ``weights``)."""
    _validate(cfg)
    dev = runtime.resolve_device(device)
    runtime.pin_fp32_precision()
    chunk = (min(cfg.chunk, runtime.pallas_chunk_cap()) if cfg.jet_impl != "torch"
             else cfg.chunk)
    nq, L = (cfg.nx, cfg.ny, cfg.nz), cfg.L
    factor = factor_for_technique(
        cfg.technique, dim=3, kind="box", L=L,
        nodes_per_dim=[phys.nodes(n, L) for n in nq] if cfg.technique == "FN" else None)
    model = SolutionModel(NetSpec(tuple(cfg.layers), activation="sin"), factor)
    key = cfg.seed
    params = model.init(generator(key, dev))
    box = Box.cube(3, 0.0, L)

    def psi(X):
        return phys.psi_3d(*nq, X[:, 0], X[:, 1], X[:, 2], L)

    E = phys.energy_3d(*nq, L)
    k_squared = 2.0 * E

    if cfg.sampler == "sobol":
        U_base = sobol_unit(cfg.seed, cfg.n_interior, 3, device=dev)

    def draw(k):
        if cfg.sampler == "sobol":
            # per-epoch randomised QMC (Cranley-Patterson rotation)
            return shifted_qmc(U_base, generator(k, dev), box)
        return uniform_box(generator(k, dev), cfg.n_interior, box)

    X_fix = draw(fold_in(key, 7))

    # first-octant coarse lattice supervision
    g = torch.linspace(0.0, L, cfg.data_grid_n, device=dev)
    half = cfg.data_grid_n // 2
    gx, gy, gz = torch.meshgrid(g[:half], g[:half], g[:half], indexing="ij")
    X_data = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    u_data = psi(X_data)

    w = {"pde": 10.0 if cfg.method == "PINN" else 0.0,
         "drm": 100.0 if cfg.method == "DRM" else 0.0,
         "data": 1e4}
    if cfg.weights:
        w.update(cfg.weights)
    loss_at, lag_at = _objective(cfg, model, w, k_squared, X_data, u_data)

    def interior(k):
        return draw(fold_in(k, 3)) if cfg.resample else X_fix

    def loss_fn(params, k):
        return loss_at(params, interior(k))

    fit_kw = {}
    if lag_at is not None:
        fit_kw["loss_and_grad_fn"] = lambda p, k: lag_at(p, interior(k))

    # fixed eval set, plain MSE (sign pinned by the data term)
    X_ev = uniform_box(generator(fold_in(key, 11), dev), cfg.n_eval, box)
    u_ev = psi(X_ev)

    def eval_fn(params, k):
        return torch.mean((model.apply_batch(params, X_ev) - u_ev) ** 2)

    optimizer = make_optimizer(cfg.lr, schedule=cfg.lr_schedule, total_steps=cfg.epochs)
    result = fit(loss_fn, eval_fn, params, epochs=cfg.epochs, optimizer=optimizer,
                 key=fold_in(key, 1), chunk=chunk, **fit_kw)

    rms_exact = float(torch.sqrt(torch.mean(u_ev ** 2)))
    return {
        "config": dataclasses.asdict(cfg),
        "model": model,
        "result": result,
        "history": result.history,
        "L2_error": float(result.best_metric),
        "rel_l2": float(result.best_metric) ** 0.5 / rms_exact,
        "min_epoch": result.best_epoch,
        "E_exact": E,
        "weights": w,
    }
