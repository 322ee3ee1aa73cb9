"""Run wrappers: train a problem preset and persist the artifact contract
(best checkpoint, loss / L2 ``.npy`` curves, a row in the per-family JSON
results ledger).

Counterpart of ``nnpde_tpu/exp/run.py``: the same tags, file names, row
keys, checkpoint meta and critic snapshot, so the post-processing tools
(:mod:`.results_process`, :mod:`.plotting`) read either package's outputs.
Every wrapper takes ``device`` as its entry point does (the card unless
``device="cpu"``); ``plot=True`` draws with matplotlib, which nothing else
here needs.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..problems.ipw import IPW1DConfig, IPW1DWanConfig, train_ipw_1d, train_ipw_1d_wan
from ..problems.ipw2d import IPW2DConfig, train_ipw_2d
from ..problems.poisson import PoissonConfig, train_poisson_nd
from ..problems.qho import QHO1DConfig, QHO1DWanConfig, train_qho_1d, train_qho_1d_wan
from ..problems.qho2d import QHO2DConfig, train_qho_2d
from .checkpoint import save_params
from .ledger import _host, append_result, save_curves


def _stamp() -> str:
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


def _time_of_best(min_epoch: int, elapsed: float, epochs: int):
    """Wall-clock estimate of when the best model appeared; ``None`` when no
    epoch ever improved (``min_epoch == -1``)."""
    if min_epoch < 0:
        return None
    return min_epoch * elapsed / max(epochs, 1)


def _persist(out: Dict, *, save_dir: str, results_file: str, tag: str,
             meta: Dict, extra_row: Optional[Dict] = None,
             v_meta: Optional[Dict] = None) -> Dict:
    os.makedirs(save_dir, exist_ok=True)
    result = out["result"]
    hist = out["history"]
    ckpt = save_params(os.path.join(save_dir, f"{tag}_best"), result.best_params, meta=meta)
    # the two headline curves under the reference's names, then every
    # other tracked term
    curve_dict = {"losses": hist["total"], "L2_errors": hist["l2"]}
    curve_dict.update({k: v for k, v in hist.items() if k not in ("total", "l2")})
    curves = save_curves(save_dir, tag, curve_dict)
    if result.best_v_params is not None:
        # the WAN critic at the best epoch; its own architecture goes in v_meta
        save_params(os.path.join(save_dir, f"{tag}_best_v"), result.best_v_params,
                    meta={**meta, **(v_meta or {}), "role": "critic"})
    row = {
        "tag": tag,
        # best_* are polish-aware: they match the saved checkpoint
        "L2_error": float(result.best_metric),
        "min_epoch": int(result.best_epoch),
        "best_model_path": ckpt,
        "losses": curves["losses"],
        "L2_errors": curves["L2_errors"],
        "timestamp": meta.get("timestamp"),
    }
    if extra_row:
        row.update(extra_row)
    append_result(os.path.join(save_dir, results_file), row)
    out["row"] = row
    out["checkpoint"] = ckpt
    return out


def _timed(train, cfg, device):
    t0 = time.time()
    out = train(cfg, device=device)
    return out, time.time() - t0


def _weights_row(w, keys):
    return {f"weight_{k}": w[k] for k in keys}


# ------------------------------------------------------------------- Poisson
def run_poisson_nd(cfg: PoissonConfig, save_dir: str = "results/ND_Poisson",
                   device="cuda") -> Dict:
    out, elapsed = _timed(train_poisson_nd, cfg, device)
    ts = _stamp()
    ks = cfg.resolved_ks()
    tag = f"{cfg.method}_{cfg.bc_mode}_d{cfg.dim}_ks{'-'.join(map(str, ks))}_{ts}"
    meta = {
        "problem": "poisson_nd", "timestamp": ts,
        "layers": [cfg.dim] + [cfg.width] * (cfg.depth - 1) + [1],
        "activation": "sin", "bc_mode": cfg.bc_mode, "bc_type": cfg.bc_type,
        "L": cfg.L, "ks": list(ks),
    }
    extra = {
        "method": cfg.method, "bc_mode": cfg.bc_mode, "dim": cfg.dim,
        "L": cfg.L, "ks": list(ks), "width": cfg.width, "depth": cfg.depth,
        "n_interior": cfg.n_interior, "n_boundary": cfg.n_boundary,
        "n_data": cfg.n_data, "epochs": cfg.epochs, "lr": cfg.lr,
        "final_l2": out["final_l2"], "best_l2": float(out["best_l2"]),
        "time": elapsed,
    }
    return _persist(
        out, save_dir=save_dir, results_file="results_poisson_nd.json",
        tag=tag, meta=meta, extra_row=extra,
        v_meta={"layers": [cfg.dim] + [cfg.critic_width] * (cfg.critic_depth - 1) + [1]},
    )


# --------------------------------------------------------------------- IPW 1D
def run_ipw_1d(cfg: IPW1DConfig, save_dir: str = "results/Infinite_Potential_Well_1D",
               plot: bool = False, device="cuda") -> Dict:
    out, elapsed = _timed(train_ipw_1d, cfg, device)
    ts = _stamp()
    tag = f"{cfg.method}_n{cfg.n}_{cfg.technique}_{ts}"
    meta = {
        "problem": "ipw_1d", "timestamp": ts, "layers": list(cfg.layers),
        "activation": "tanh", "technique": cfg.technique, "n": cfg.n,
        "L": cfg.L,
    }
    extra = {
        "method": cfg.method, "n": cfg.n, "epochs": cfg.epochs,
        "LBFGS": cfg.LBFGS, "technique": cfg.technique,
        "time": elapsed,
        "time_of_best_model": _time_of_best(out["min_epoch"], elapsed, cfg.epochs),
        **_weights_row(out["weights"], ("pde", "drm", "data", "norm", "bc", "orth")),
        "layers": list(cfg.layers),
    }
    out = _persist(out, save_dir=save_dir, results_file="results_IPW_1D.json",
                   tag=tag, meta=meta, extra_row=extra)
    if plot:
        from ..pde import ipw as _ipw

        out["plot_paths"] = _plot_1d(out, save_dir, tag, lo=0.0, hi=cfg.L,
                                     exact=lambda x: _ipw.psi_1d(cfg.n, x, cfg.L))
    return out


def run_ipw_1d_wan(cfg: IPW1DWanConfig, save_dir: str = "results/Infinite_Potential_Well_1D",
                   plot: bool = False, device="cuda") -> Dict:
    out, elapsed = _timed(train_ipw_1d_wan, cfg, device)
    ts = _stamp()
    # fn_variant forces the FN trial whatever cfg.technique says: the meta
    # records the factor trained, or the registry rebuilds another model
    eff_technique = "FN" if (cfg.fn_variant or cfg.technique == "FN") else cfg.technique
    tag = f"WAN_n{cfg.n}_{eff_technique}_{ts}"
    meta = {
        "problem": "ipw_1d_wan", "timestamp": ts, "layers": list(cfg.layers),
        "activation": "tanh", "technique": eff_technique, "n": cfg.n,
        "L": cfg.L,
    }
    extra = {
        "method": "WAN", "n": cfg.n, "epochs": cfg.epochs,
        "technique": cfg.technique, "time": elapsed,
        "time_of_best_model": _time_of_best(out["min_epoch"], elapsed, cfg.epochs),
        **_weights_row(out["weights"], ("pde", "data", "norm", "bc", "orth")),
        "layers": list(cfg.layers), "v_layers": list(cfg.v_layers),
    }
    out = _persist(out, save_dir=save_dir, results_file="results_IPW_1D.json",
                   tag=tag, meta=meta, extra_row=extra,
                   v_meta={"layers": list(cfg.v_layers)})
    if plot:
        from ..pde import ipw as _ipw

        out["plot_paths"] = _plot_1d(out, save_dir, tag, lo=0.0, hi=cfg.L,
                                     exact=lambda x: _ipw.psi_1d(cfg.n, x, cfg.L))
    return out


# --------------------------------------------------------------------- QHO 1D
def run_qho_1d(cfg: QHO1DConfig, save_dir: str = "results/Quantum_Harmonic_Oscillator_1D",
               plot: bool = False, device="cuda") -> Dict:
    out, elapsed = _timed(train_qho_1d, cfg, device)
    ts = _stamp()
    tag = f"{cfg.method}_n{cfg.n}_{cfg.technique}_{ts}"
    meta = {
        "problem": "qho_1d", "timestamp": ts, "layers": list(cfg.layers),
        "activation": "sin", "technique": cfg.technique, "n": cfg.n,
        "x_max": cfg.x_max,
    }
    extra = {
        "method": cfg.method, "n": cfg.n, "epochs": cfg.epochs,
        "LBFGS": cfg.LBFGS, "technique": cfg.technique, "time": elapsed,
        "time_of_best_model": _time_of_best(out["min_epoch"], elapsed, cfg.epochs),
        **_weights_row(out["weights"], ("pde", "drm", "data", "norm", "bc", "orth")),
    }
    out = _persist(out, save_dir=save_dir, results_file="results_QHO_1D.json",
                   tag=tag, meta=meta, extra_row=extra)
    if plot:
        from ..pde import qho as _qho

        out["plot_paths"] = _plot_1d(out, save_dir, tag, lo=-cfg.x_max, hi=cfg.x_max,
                                     exact=lambda x: _qho.psi_1d(cfg.n, x))
    return out


def run_qho_1d_wan(cfg: QHO1DWanConfig,
                   save_dir: str = "results/Quantum_Harmonic_Oscillator_1D",
                   device="cuda") -> Dict:
    out, elapsed = _timed(train_qho_1d_wan, cfg, device)
    ts = _stamp()
    tag = f"WAN_n{cfg.n}_{cfg.technique}_{ts}"
    meta = {
        "problem": "qho_1d_wan", "timestamp": ts, "layers": list(cfg.layers),
        "activation": "tanh", "technique": cfg.technique, "n": cfg.n,
        "x_max": cfg.x_max,
    }
    extra = {
        "method": "WAN", "n": cfg.n, "epochs": cfg.epochs,
        "technique": cfg.technique, "time": elapsed,
        "E_est": out["E_est"], "E_exact": out["E_exact"],
    }
    return _persist(out, save_dir=save_dir, results_file="results_QHO_1D.json",
                    tag=tag, meta=meta, extra_row=extra,
                    v_meta={"layers": list(cfg.v_layers)})


# --------------------------------------------------------------------- 2D IPW
def run_ipw_2d(cfg: IPW2DConfig, save_dir: str = "results/Infinite_Potential_Well_2D",
               plot: bool = False, device="cuda") -> Dict:
    out, elapsed = _timed(train_ipw_2d, cfg, device)
    ts = _stamp()
    tag = f"{cfg.method}_{cfg.technique}_n{cfg.nx}_{cfg.ny}_{ts}"
    meta = {
        "problem": "ipw_2d", "timestamp": ts, "layers": list(cfg.layers),
        "activation": "sin", "technique": cfg.technique,
        "nx": cfg.nx, "ny": cfg.ny, "L": cfg.L,
    }
    extra = {
        "method": cfg.method, "n": [cfg.nx, cfg.ny], "epochs": cfg.epochs,
        "LBFGS": cfg.LBFGS, "technique": cfg.technique, "time": elapsed,
        "time_of_best_model": _time_of_best(out["min_epoch"], elapsed, cfg.epochs),
        **_weights_row(out["weights"], ("pde", "drm", "data", "bc", "orth")),
    }
    out = _persist(out, save_dir=save_dir, results_file="results_IPW_2D.json",
                   tag=tag, meta=meta, extra_row=extra,
                   v_meta={"layers": list(cfg.v_layers)})
    if plot:
        from ..pde import ipw as _ipw

        out["plot_path"] = _plot_2d(out, save_dir, tag, lo=0.0, hi=cfg.L,
                                    exact=lambda x, y: _ipw.psi_2d(cfg.nx, cfg.ny, x, y, cfg.L))
    return out


# --------------------------------------------------------------------- 3D IPW
def run_ipw_3d(cfg, save_dir: str = "results/Infinite_Potential_Well_3D",
               plot: bool = False, device="cuda") -> Dict:
    from ..problems.ipw3d import train_ipw_3d

    out, elapsed = _timed(train_ipw_3d, cfg, device)
    ts = _stamp()
    tag = f"{cfg.method}_{cfg.technique}_n{cfg.nx}_{cfg.ny}_{cfg.nz}_{ts}"
    meta = {
        "problem": "ipw_3d", "timestamp": ts, "layers": list(cfg.layers),
        "activation": "sin", "technique": cfg.technique,
        "nx": cfg.nx, "ny": cfg.ny, "nz": cfg.nz, "L": cfg.L,
    }
    extra = {
        "method": cfg.method, "n": [cfg.nx, cfg.ny, cfg.nz],
        "epochs": cfg.epochs, "technique": cfg.technique, "time": elapsed,
        "rel_l2": out["rel_l2"], "jet_impl": cfg.jet_impl,
        "n_interior": cfg.n_interior, "sampler": cfg.sampler,
        **_weights_row(out["weights"], ("pde", "drm", "data")),
    }
    out = _persist(out, save_dir=save_dir, results_file="results_IPW_3D.json",
                   tag=tag, meta=meta, extra_row=extra)
    if plot:
        out["plot_path"] = plot_ipw_3d_slice(out, save_dir, tag)
    return out


def run_subspace(cfg, save_dir: str = "results/Subspace", device="cuda") -> Dict:
    """Persist a simultaneous multi-eigenstate run: checkpoint, curves and a
    ledger row carrying the whole recovered spectrum.  The states' figure
    is drawn where the run reports its states (1D)."""
    from ..problems.subspace import train_subspace

    out, elapsed = _timed(train_subspace, cfg, device)
    ts = _stamp()
    tag = f"subspace_{cfg.problem}{cfg.dim}d_k{cfg.k}_{ts}"
    meta = {
        "problem": f"subspace_{cfg.problem}", "timestamp": ts,
        "dim": cfg.dim, "k": cfg.k, "x_max": cfg.x_max,
        "layers": [cfg.dim] + [cfg.width] * cfg.depth + [cfg.k],
        "activation": "sin",
    }
    extra = {
        "method": "SUBSPACE", "k": cfg.k, "epochs": cfg.epochs,
        "time": elapsed, "eigenvalues": out["eigenvalues"],
        "exact": out["exact"], "max_eig_rel_err": out["max_eig_rel_err"],
        **({"max_state_rel_l2": out["max_state_rel_l2"]}
           if "max_state_rel_l2" in out else {}),
    }
    persisted = _persist(out, save_dir=save_dir, results_file="results_Subspace.json",
                         tag=tag, meta=meta, extra_row=extra)
    if "_states" in out:
        from .plotting import plot_subspace_states

        x, U, V, psi = out["_states"]
        persisted["row"]["states_plot"] = plot_subspace_states(
            x, U, out["eigenvalues"], os.path.join(save_dir, f"{tag}_states.png"),
            psi=psi, V=V)
    return persisted


def _grid_2d(lo, hi, n, device):
    g = torch.linspace(lo, hi, n, device=device)
    return torch.meshgrid(g, g, indexing="ij")


def _sign_aligned(u, ue):
    return -u if np.mean((u - ue) ** 2) > np.mean((u + ue) ** 2) else u


def plot_ipw_3d_slice(out: Dict, save_dir: str, tag: str, z_frac: float = 0.5,
                      n: int = 200):
    """Mid-plane slice ``u(x, y, z0)`` against the exact state (the 2D
    heatmap and surface comparison)."""
    from ..pde import ipw as _ipw
    from .plotting import plot_2d_comparison

    cfg = out["config"]
    L, z0 = cfg["L"], cfg["L"] * z_frac
    params = out["result"].best_params
    GX, GY = _grid_2d(0.0, L, n, params[0][0].device)
    Z = torch.full_like(GX, z0)
    pts = torch.stack([GX.reshape(-1), GY.reshape(-1), Z.reshape(-1)], 1)
    with torch.no_grad():
        u = _host(out["model"].apply_batch(params, pts)).reshape(n, n)
    ue = _host(_ipw.psi_3d(cfg["nx"], cfg["ny"], cfg["nz"], GX, GY, Z, L))
    return plot_2d_comparison(_host(GX), _host(GY), _sign_aligned(u, ue), ue,
                              os.path.join(save_dir, f"slice_z{z_frac:g}_{tag}.png"),
                              title=f"{tag} (z = {z0:g})")


# --------------------------------------------------------------------- 2D QHO
def run_qho_2d(cfg: QHO2DConfig, save_dir: str = "results/Quantum_Harmonic_Oscillator_2D",
               plot: bool = False, device="cuda") -> Dict:
    out, elapsed = _timed(train_qho_2d, cfg, device)
    ts = _stamp()
    tag = f"{cfg.method}_{cfg.technique}_n{cfg.nx}_{cfg.ny}_{ts}"
    meta = {
        "problem": "qho_2d", "timestamp": ts, "layers": list(cfg.layers),
        "activation": "sin", "technique": cfg.technique,
        "nx": cfg.nx, "ny": cfg.ny, "L": cfg.L,
    }
    extra = {
        "method": cfg.method, "n": [cfg.nx, cfg.ny], "epochs": cfg.epochs,
        "LBFGS": cfg.LBFGS, "technique": cfg.technique, "time": elapsed,
        "time_of_best_model": _time_of_best(out["min_epoch"], elapsed, cfg.epochs),
        **_weights_row(out["weights"], ("pde", "drm", "data", "norm", "bc", "orth")),
        "learned_energy": out["learned_energy"],
    }
    out = _persist(out, save_dir=save_dir, results_file="results_QHO_2D.json",
                   tag=tag, meta=meta, extra_row=extra,
                   v_meta={"layers": list(cfg.v_layers)})
    if plot:
        from ..pde import qho as _qho

        out["plot_path"] = _plot_2d(out, save_dir, tag, lo=-cfg.L, hi=cfg.L,
                                    exact=lambda x, y: _qho.psi_2d(cfg.nx, cfg.ny, x, y))
    return out


def _plot_1d(out, save_dir, tag, *, lo, hi, exact, n: int = 500):
    """The run's overlay on the exact state and its loss / L2 curves."""
    from .plotting import plot_curves, plot_wavefunction_overlay

    x = torch.linspace(lo, hi, n, dtype=torch.float64)
    overlay = plot_wavefunction_overlay(
        out["checkpoint"], _host(x), _host(exact(x)),
        os.path.join(save_dir, f"{tag}_solution.png"), title=tag)
    return [overlay] + plot_curves([out["row"]], os.path.join(save_dir, tag))


def _plot_2d(out, save_dir, tag, *, lo, hi, exact, n: int = 100):
    """100 x 100 comparison plot, sign-aligned."""
    from .plotting import _net_params, plot_2d_comparison

    net_p = _net_params(out["result"].best_params)
    GX, GY = _grid_2d(lo, hi, n, net_p[0][0].device)
    pts = torch.stack([GX.reshape(-1), GY.reshape(-1)], 1)
    with torch.no_grad():
        u = _host(out["model"].apply_batch(net_p, pts)).reshape(n, n)
    ue = _host(exact(GX, GY))
    return plot_2d_comparison(_host(GX), _host(GY), _sign_aligned(u, ue), ue,
                              os.path.join(save_dir, f"pinn_vs_exact_{tag}.png"), title=tag)
