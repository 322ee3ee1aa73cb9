"""Figures from a run's outputs.

Counterpart of ``nnpde_tpu/exp/plotting.py``; so far its KH overlay alone,
:func:`plot_solution_gt` (``run_compare`` draws it).  matplotlib is
imported inside the function: a machine without it can import this module
and run everything that draws nothing.
"""

from __future__ import annotations

import os

import numpy as np

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


def plot_solution_gt(x, psi_ref, u_pred, v_x, e_est, method: str, n: int,
                     out_png: str) -> str:
    """KH overlay: the FD reference, the prediction (its sign matched to the
    reference) and the dressed potential; returns ``out_png``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import rcParams

    rcParams.update(STYLE)
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
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png
