"""Figures from a run's outputs and from checkpoints.

Counterpart of ``nnpde_tpu/exp/plotting.py``:

* :func:`plot_curves` — semilog loss / L2-error evolution for ledger rows;
* :func:`load_checkpoint_model` — (model, params, meta) from a parameter
  file of either package, through :mod:`..models.registry`;
* :func:`plot_wavefunction_overlay` — prediction vs exact with boundary and
  peak zoom insets;
* :func:`plot_2d_comparison` — 2D heatmaps and 3D surfaces quad plot;
* :func:`plot_floquet_harmonics`, :func:`plot_subspace_states` — the two
  channel solvers' figures;
* :func:`plot_solution_gt` — the KH overlay ``run_compare`` draws.

matplotlib is imported inside each drawing function: a machine without it
imports this module and runs everything that draws nothing
(:func:`load_checkpoint_model` included).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .ledger import _host

# the JAX package's academic plot style
STYLE = {
    "font.family": "serif",
    "font.size": 14,
    "axes.labelsize": 16,
    "axes.titlesize": 18,
    "legend.fontsize": 12,
    "xtick.labelsize": 14,
    "ytick.labelsize": 14,
    "figure.figsize": (8, 6),
    "savefig.dpi": 150,
    "lines.linewidth": 2,
    "axes.grid": True,
    "grid.linestyle": "--",
    "grid.alpha": 0.5,
}

# colorblind-friendly palette
COLORS = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]


def _pyplot():
    """matplotlib's pyplot on the Agg backend, with :data:`STYLE` set."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update(STYLE)
    return plt


def _save(fig, plt, out_png: str, **kw) -> str:
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, **kw)
    plt.close(fig)
    return out_png


def plot_curves(
    entries: Sequence[Dict],
    out_prefix: str,
    *,
    metric_keys=("losses", "L2_errors"),
    label_fn: Optional[Callable[[Dict], str]] = None,
) -> List[str]:
    """Semilog evolution curves for a list of ledger rows (their ``.npy``
    paths), one PNG per metric: ``{out_prefix}_{metric}.png``."""
    plt = _pyplot()
    label_fn = label_fn or (
        lambda e: f"{e.get('method', '?')} (n={e.get('n', '?')}, "
                  f"{e.get('technique', '?')})"
    )
    titles = {"losses": "Loss Evolution During Training",
              "L2_errors": "L2 Error Evolution During Training"}
    ylabels = {"losses": "Loss", "L2_errors": "L2 Error"}
    paths = []
    for key in metric_keys:
        fig, ax = plt.subplots()
        any_negative = False
        for idx, e in enumerate(entries):
            curve = np.load(e[key])
            any_negative |= bool((curve <= 0).any())
            ax.plot(np.arange(len(curve)), curve, label=label_fn(e),
                    color=COLORS[idx % len(COLORS)])
        # symlog where a metric crosses zero (the Deep-Ritz energy)
        ax.set_yscale("symlog" if any_negative else "log")
        ax.set_xlabel("Epochs")
        ax.set_ylabel(ylabels.get(key, key))
        ax.set_title(titles.get(key, key))
        ax.legend(loc="upper right", frameon=True, shadow=True)
        paths.append(_save(fig, plt, f"{out_prefix}_{key}.png", bbox_inches="tight"))
    return paths


def load_checkpoint_model(ckpt_path: str, device="cpu"):
    """(model, params, meta) from a self-describing parameter file of either
    package; the parameters as tensors on ``device``."""
    from ..models.registry import build_solution_model
    from .checkpoint import load_params

    params, meta = load_params(ckpt_path, device=device)
    return build_solution_model(meta), params, meta


def _net_params(params):
    return params["net"] if isinstance(params, dict) and "net" in params else params


def plot_wavefunction_overlay(
    ckpt_path: str,
    x,
    u_exact,
    out_png: str,
    *,
    title: Optional[str] = None,
    insets: bool = True,
) -> str:
    """Prediction vs exact with boundary and peak zoom insets; ``x``: (N,)
    plot grid, ``u_exact``: (N,) analytic truth.  The prediction's sign is
    matched to the truth (the eigenfunction gauge)."""
    plt = _pyplot()
    from mpl_toolkits.axes_grid1.inset_locator import inset_axes, mark_inset

    model, params, _ = load_checkpoint_model(ckpt_path)
    x = _host(x)
    with torch.no_grad():
        u = _host(model.apply_batch(_net_params(params),
                                    torch.as_tensor(x, dtype=torch.float32).reshape(-1, 1)))
    ue = _host(u_exact)
    if np.mean((u - ue) ** 2) > np.mean((u + ue) ** 2):
        u = -u

    fig, ax = plt.subplots()
    ax.plot(x, ue, label="Exact", color=COLORS[3], linestyle="--")
    ax.plot(x, u, label="Predicted", color=COLORS[0], linewidth=1.2)
    ax.set_xlabel("x")
    ax.set_ylabel(r"$\psi(x)$")
    if title:
        ax.set_title(title)
    ax.legend(loc="best")
    if insets and len(x) > 16:
        # boundary inset (left edge) and peak inset (argmax of |exact|)
        n = len(x)
        bw = max(n // 20, 4)
        peak = int(np.argmax(np.abs(ue)))
        for (lo, hi), loc in (((0, bw), "lower left"),
                              ((max(peak - bw // 2, 0), min(peak + bw // 2, n - 1)),
                               "upper right")):
            if hi <= lo:
                continue
            axi = inset_axes(ax, width="30%", height="30%", loc=loc)
            axi.plot(x[lo:hi], ue[lo:hi], color=COLORS[3], linestyle="--", linewidth=1)
            axi.plot(x[lo:hi], u[lo:hi], color=COLORS[0], linewidth=1)
            axi.set_xticks([])
            axi.set_yticks([])
            mark_inset(ax, axi, loc1=2, loc2=4, fc="none", ec="0.6")
    return _save(fig, plt, out_png, bbox_inches="tight")


def plot_2d_comparison(x, y, u_pred, u_exact, out_png: str,
                       title: str = "PINN vs Exact Solution") -> str:
    """2 x 2 heatmap and 3D surface comparison."""
    plt = _pyplot()
    X, Y, Zp, Ze = _host(x), _host(y), _host(u_pred), _host(u_exact)
    fig = plt.figure(figsize=(12, 10))
    ax1 = fig.add_subplot(2, 2, 1)
    fig.colorbar(ax1.pcolormesh(X, Y, Zp, shading="auto"), ax=ax1, label="u_pred")
    ax1.set_title("2D predicted heatmap")
    ax2 = fig.add_subplot(2, 2, 2)
    fig.colorbar(ax2.pcolormesh(X, Y, Ze, shading="auto"), ax=ax2, label="u_exact")
    ax2.set_title("2D exact heatmap")
    ax3 = fig.add_subplot(2, 2, 3, projection="3d")
    ax3.plot_surface(X, Y, Zp, rcount=100, ccount=100, cmap="viridis", edgecolor="none")
    ax3.set_title("3D predicted surface")
    ax4 = fig.add_subplot(2, 2, 4, projection="3d")
    ax4.plot_surface(X, Y, Ze, rcount=100, ccount=100, cmap="plasma", edgecolor="none")
    ax4.set_title("3D exact surface")
    for ax in (ax1, ax2):
        ax.set_xlabel("x")
        ax.set_ylabel("y")
    fig.suptitle(title)
    return _save(fig, plt, out_png, bbox_inches="tight")


def plot_floquet_harmonics(x, phi_re, phi_im, gt_re, gt_im, M: int,
                           eps_est: float, out_png: str,
                           keep: float = 1e-4) -> str:
    """Floquet-state overlay: neural ``|phi_m(x)|`` (lines) against the FD
    ground truth (markers) per harmonic m, on a log scale; harmonics with
    both weights below ``keep`` are skipped."""
    plt = _pyplot()
    x = _host(x)
    amp = np.sqrt(_host(phi_re) ** 2 + _host(phi_im) ** 2)
    amp_gt = np.sqrt(_host(gt_re) ** 2 + _host(gt_im) ** 2)
    fig, ax = plt.subplots(figsize=(10, 6))
    colors = plt.cm.viridis(np.linspace(0.0, 0.85, amp.shape[1]))
    stride = max(1, len(x) // 64)
    for c in range(amp.shape[1]):
        if amp[:, c].max() < keep and amp_gt[:, c].max() < keep:
            continue
        m = c - M
        ax.semilogy(x, amp[:, c] + 1e-12, color=colors[c], label=f"$|\\phi_{{{m}}}|$ neural")
        ax.semilogy(x[::stride], amp_gt[::stride, c] + 1e-12, color=colors[c], marker="o",
                    linestyle="none", markersize=3, alpha=0.6)
    ax.set_ylim(bottom=max(keep * 1e-2, 1e-7))
    ax.set_xlabel("x (a.u.)")
    ax.set_ylabel("$|\\phi_m(x)|$")
    ax.set_title(f"Floquet harmonics: neural (lines) vs FD (dots) | "
                 f"$\\varepsilon$~{eps_est:.6f}")
    ax.legend()
    return _save(fig, plt, out_png, dpi=150)


def plot_subspace_states(x, U, lam, out_png: str, psi=None, V=None,
                         scale: float = 0.35) -> str:
    """Spectrum waterfall: each recovered eigenstate ``u_m``, unit-normalised
    and offset by its eigenvalue, over the potential; exact states (where
    given) as dots, their signs matched."""
    plt = _pyplot()
    x, U, lam = _host(x), _host(U), _host(lam)
    k = U.shape[1]
    span = float(lam[-1] - lam[0]) if k > 1 else 1.0
    amp = scale * (span / max(k - 1, 1)) if k > 1 else scale
    fig, ax = plt.subplots(figsize=(10, 6))
    if V is not None:
        ax.plot(x, _host(V), color="0.55", alpha=0.8, label="$V(x)$")
    colors = plt.cm.viridis(np.linspace(0.0, 0.85, k))
    stride = max(1, len(x) // 64)
    for m in range(k):
        u = U[:, m] / (np.abs(U[:, m]).max() + 1e-30)
        if psi is not None:
            p = _host(psi)[:, m]
            p = p / (np.abs(p).max() + 1e-30)
            if np.mean((u - p) ** 2) > np.mean((u + p) ** 2):
                u = -u
            ax.plot(x[::stride], lam[m] + amp * p[::stride], linestyle="none", marker="o",
                    markersize=2.5, alpha=0.55, color=colors[m])
        ax.axhline(lam[m], color=colors[m], linewidth=0.6, alpha=0.5)
        ax.plot(x, lam[m] + amp * u, color=colors[m],
                label=f"$u_{{{m}}}$, $\\lambda$={lam[m]:.5g}")
    ax.set_xlabel("x")
    ax.set_ylabel("energy offset + scaled state")
    ax.set_title(f"subspace solver: {k} lowest eigenpairs from one run")
    ax.legend(fontsize=8, ncol=2)
    return _save(fig, plt, out_png, dpi=150)


def plot_solution_gt(x, psi_ref, u_pred, v_x, e_est, method: str, n: int,
                     out_png: str) -> str:
    """KH overlay: the FD reference, the prediction (its sign matched to the
    reference) and the dressed potential; returns ``out_png``."""
    plt = _pyplot()
    x, ref, up = _host(x), _host(psi_ref), _host(u_pred)
    if np.mean((up - ref) ** 2) > np.mean((-up - ref) ** 2):
        up = -up
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.plot(x, ref, label=f"ref $\\psi_n$ (n={n})", linewidth=2)
    ax.plot(x, up, label=f"{method} $\\psi_{{pred}}$", linestyle="--")
    ax.plot(x, _host(v_x), label="$V_{KH}(x)$", alpha=0.7)
    if e_est is not None:
        ax.set_title(f"{method} vs Reference | n={n} | E~{e_est:.6f}")
    ax.set_xlabel("x (a.u.)")
    ax.legend()
    return _save(fig, plt, out_png, dpi=150)
