"""Time-periodic Kramers-Henneberger atom via Floquet theory.

Counterpart of ``nnpde_tpu/problems/kh_floquet.py``, with the same
:class:`KHFloquetConfig` fields and defaults.  The full time-periodic
Schrodinger problem ``i dpsi/dt = (-1/2 d_xx + V(x + alpha sin wt)) psi``
under the Floquet ansatz ``psi = e^{-i eps t} sum_{|m| <= M} phi_m(x) e^{i m
w t}`` becomes 2M+1 coupled stationary equations

    ``-1/2 phi_m'' + sum_k c_{m-k}(x) phi_k + (m w - eps) phi_m = 0``

with ``c_j`` the Fourier components of the oscillating potential
(:func:`nnpde_tpu_torch.pde.kh.v_fourier_components`).

* One network with 2(2M+1) output channels (the real and imaginary part of
  every harmonic) on the channel jet
  (:class:`~nnpde_tpu_torch.models.ChannelSolutionModel`; the recurrence
  only, no kernel).
* The coupling is the setup-time (N, C, C) tables ``P + iQ = c_{a-b}(x)``
  contracted with the channel values by one batched einsum per step, in
  float32 with TF32 off; no complex dtype.
* The quasi-energy eps is a trainable leaf beside the net (``{"net",
  "E"}``), starting at the FD value of level n and sharing the net's
  learning rate.
* The gauge is fixed by a data term against the FD Floquet ground truth on
  a strided subset of the grid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import runtime
from ..models import ChannelSolutionModel, NetSpec, factor_for_technique
from ..models.mlp import init_mlp_threefry
from ..ops.quadrature import integral_mean
from ..pde import kh as phys
from ..prng import fold_in
from ..train import fit, make_optimizer
from .ipw import on_device


@dataclasses.dataclass
class KHFloquetConfig:
    alpha: float = 2.0
    omega: float = 0.3
    v0: float = phys.V0_DEFAULT
    L: float = 30.0
    M: int = 2                          # harmonic truncation |m| <= M
    n: int = 0                          # Floquet level (0 = quasi-ground)
    n_ref: int = 2000                   # FD ground-truth grid
    width: int = 64
    depth: int = 3
    technique: str = "FBC"              # FBC window | RAW
    epochs: int = 10000
    lr: float = 1e-3
    lr_schedule: str = "constant"       # constant | cosine | exponential
    # the KH compare weighting, transferred to the Floquet system
    lambda_pde: float = 10.0
    lambda_data: float = 1e4
    lambda_norm: float = 10.0
    lambda_bc: float = 1e4
    lambda_orth: float = 1e4
    data_fraction: float = 0.25
    max_data_points: Optional[int] = 256
    train_n: int = 1024
    seed: int = 0
    chunk: int = 1000


def phase_aware_mse(a, b, gt_re, gt_im):
    """Global-U(1)-free MSE between the complex field (a + i b) and the
    ground truth: ``min_theta mean |(a+ib) e^{i theta} - gt|^2``, in closed
    form through the complex overlap ``z = sum conj(gt) phi``."""
    zr = torch.sum(gt_re * a + gt_im * b)
    zi = torch.sum(gt_re * b - gt_im * a)
    cross = torch.sqrt(zr * zr + zi * zi + 1e-30)
    total = torch.sum(a * a + b * b) + torch.sum(gt_re**2 + gt_im**2)
    return (total - 2.0 * cross) / a.numel()


def _avg_energy(cfg: KHFloquetConfig, n: int) -> float:
    """Level-n energy of the cycle-averaged solver: the infinite-frequency
    approximation the Floquet solve corrects."""
    _, E, _ = phys.reference_eigensystem(L=cfg.L, N=cfg.n_ref, alpha=cfg.alpha, v0=cfg.v0,
                                         k_max=n + 1, use_avg=True, n_theta=512)
    return float(E[n])


def train_kh_floquet(cfg: KHFloquetConfig, gt: Optional[phys.FloquetGroundTruth] = None,
                     init_params=None, device="cuda") -> Dict:
    """Train the Floquet solver for level ``cfg.n``; returns the JAX entry
    point's keys (``mse``, ``rel_l2``, ``best_epoch``, ``eps_est``,
    ``eps_ref``, ``eps_avg``, ``harmonic_weights``, ``x``, ``phi_re``,
    ``phi_im``, ``history``, ``result``, ``model``, ``gt``, ``config``).
    ``gt``: a :class:`~nnpde_tpu_torch.pde.kh.FloquetGroundTruth` on the
    device (built from the config when None).  The net starts from the JAX
    package's initial weights for ``cfg.seed``
    (:func:`~nnpde_tpu_torch.models.mlp.init_mlp_threefry`), or from
    ``init_params``."""
    dev = runtime.resolve_device(device)
    runtime.pin_fp32_precision()
    if gt is None:
        gt = phys.FloquetGroundTruth(alpha=cfg.alpha, omega=cfg.omega, v0=cfg.v0, L=cfg.L,
                                     N=cfg.n_ref, M=cfg.M, n_levels=max(cfg.n + 1, 1),
                                     device=dev)
    if gt.M != cfg.M:
        raise ValueError(f"ground truth M={gt.M} != config M={cfg.M}")
    C, n, L = gt.C, cfg.n, cfg.L

    layers = (1,) + (cfg.width,) * cfg.depth + (2 * C,)
    factor = (factor_for_technique("FBC", dim=1, kind="window", L=L)
              if cfg.technique == "FBC" else None)
    model = ChannelSolutionModel(NetSpec(layers, activation="sin"), factor)

    x = torch.linspace(-L, L, cfg.train_n, dtype=torch.float32, device=dev)
    X = x.reshape(-1, 1)
    P, Q = gt.coupling_matrices(x)                        # (N, C, C)
    momega = (torch.arange(C, dtype=torch.float32, device=dev) - cfg.M) * cfg.omega

    gt_re, gt_im = gt.resample(x)                         # (N, C, k)
    tgt_re, tgt_im = gt_re[:, :, n], gt_im[:, :, n]       # (N, C)
    low_re, low_im = gt_re[:, :, :n], gt_im[:, :, :n]     # (N, C, n)

    m_pts = x.shape[0]
    k_data = max(1, int(m_pts * cfg.data_fraction))
    if cfg.max_data_points is not None:
        k_data = min(k_data, int(cfg.max_data_points))
    # a strided subset spanning the whole domain (float32 indices truncated,
    # as the JAX package forms them)
    idx_data = torch.linspace(0, m_pts - 1, k_data, dtype=torch.float32,
                              device=dev).to(torch.int64)

    u_params = {
        "net": on_device(init_params if init_params is not None
                         else init_mlp_threefry(cfg.seed, model.spec), dev),
        "E": torch.tensor(gt.energy(n), dtype=torch.float32, device=dev),
    }
    zero = torch.zeros((), device=dev)

    def residual(params):
        jet = model.fields(params["net"], X)
        a, b = jet.value[:, :C], jet.value[:, C:]
        la, lb = jet.lap[:, :C], jet.lap[:, C:]
        # (P + iQ)(a + ib) = (Pa - Qb) + i(Pb + Qa)
        ca = torch.einsum("nab,nb->na", P, a) - torch.einsum("nab,nb->na", Q, b)
        cb = torch.einsum("nab,nb->na", P, b) + torch.einsum("nab,nb->na", Q, a)
        shift = momega[None, :] - params["E"]
        return -0.5 * la + ca + shift * a, -0.5 * lb + cb + shift * b, a, b

    def loss_fn(params, key):
        r_re, r_im, a, b = residual(params)
        pde = torch.mean(r_re**2 + r_im**2)
        data = torch.mean((a[idx_data] - tgt_re[idx_data]) ** 2
                          + (b[idx_data] - tgt_im[idx_data]) ** 2)
        dens = torch.sum(a * a + b * b, dim=1)            # sum_m |phi_m|^2
        norm_pen = (integral_mean(dens, 2.0 * L) - 1.0) ** 2
        bc = torch.sum(a[0] ** 2 + a[-1] ** 2 + b[0] ** 2 + b[-1] ** 2)
        if n > 0:
            # complex <phi_low, phi> per lower level (grid-average inner products)
            scale = 2.0 * L / m_pts
            ir = scale * (torch.einsum("ncl,nc->l", low_re, a)
                          + torch.einsum("ncl,nc->l", low_im, b))
            ii = scale * (torch.einsum("ncl,nc->l", low_re, b)
                          - torch.einsum("ncl,nc->l", low_im, a))
            low_nrm = scale * torch.einsum("ncl->l", low_re**2 + low_im**2)
            orth = torch.sum((ir**2 + ii**2) / (low_nrm + 1e-12))
        else:
            orth = zero
        total = (cfg.lambda_pde * pde + cfg.lambda_data * data + cfg.lambda_norm * norm_pen
                 + cfg.lambda_bc * bc + cfg.lambda_orth * orth)
        return total, {"pde": pde, "data": data, "norm": norm_pen, "bc": bc, "orth": orth,
                       "E": params["E"]}

    def eval_fn(params, key):
        val = model.apply_batch(params["net"], X)
        return phase_aware_mse(val[:, :C], val[:, C:], tgt_re, tgt_im)

    result = fit(loss_fn, eval_fn, u_params, epochs=cfg.epochs,
                 optimizer=make_optimizer(cfg.lr, schedule=cfg.lr_schedule,
                                          total_steps=cfg.epochs),
                 key=fold_in(cfg.seed, 1), chunk=cfg.chunk)

    best = result.best_params
    with torch.no_grad():
        val = model.apply_batch(best["net"], X)
        a, b = val[:, :C], val[:, C:]
        dens = (a**2 + b**2).cpu().numpy().astype(np.float64)
        gt_nrm = float(torch.mean(tgt_re**2 + tgt_im**2))
        rel_l2 = float(np.sqrt(float(eval_fn(best, None)) / max(gt_nrm, 1e-30)))
    dx = float(x[1] - x[0])
    weights = np.ones(m_pts)
    weights[0] = weights[-1] = 0.5
    harm_w = dx * np.einsum("n,nc->c", weights, dens)
    harm_w = harm_w / max(harm_w.sum(), 1e-30)

    return {
        "config": dataclasses.asdict(cfg),
        "model": model,
        "gt": gt,
        "result": result,
        "history": result.history,
        "mse": float(result.best_metric),
        "rel_l2": rel_l2,
        "best_epoch": result.best_epoch,
        "eps_est": float(best["E"]),
        "eps_ref": gt.energy(n),
        # the gap the cycle-averaged solver cannot see
        "eps_avg": _avg_energy(cfg, n),
        "harmonic_weights": harm_w.tolist(),
        "x": x.cpu().numpy(),
        "phi_re": a.cpu().numpy(),
        "phi_im": b.cpu().numpy(),
    }
