"""Experiment sweeps: the reference's experiment grids as reusable
functions.  Counterpart of ``nnpde_tpu/exp/sweeps.py``, with the same grids,
configurations and ledgers; every sweep takes ``device`` as the run
wrappers do (the card unless ``device="cpu"``).

Citations:
* :func:`sweep_poisson` — methods x dims loop, Poisson_ND.py:369-403.
* :func:`sweep_ipw_1d` — 8 runs per n ({PINN,DRM} x {BC,FBC,FN,OG}),
  IPW_1D_PINN_DRM.py:250-261, plus WAN x {BC,FBC,OG}, IPW_1D_WAN.py:335-341.
* :func:`sweep_ipw_wan_fn_ablation` — the paper's 12 u-arch x 12 v-arch
  depth/width grid at n=5, IPW_1D_WAN_FN.py:330-337.
* :func:`sweep_qho_1d` — {PINN,DRM} x FN per n, QHO_1D_PINN_DRM.py:576-583.
* :func:`sweep_qho_2d_energy` — the paper sweep: 6 quantum-number pairs x
  {PINN:[FBC,FN], DRM,WAN:[FN,OG]} with trainable energy,
  QHO_2D_Energy.py:557-581.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..problems.ipw import IPW1DConfig, IPW1DWanConfig
from ..problems.poisson import PoissonConfig
from ..problems.qho import QHO1DConfig
from ..problems.qho2d import QHO2DConfig
from .run import (
    run_ipw_1d,
    run_ipw_1d_wan,
    run_poisson_nd,
    run_qho_1d,
    run_qho_2d,
)

# the reference ablation grids (IPW_1D_WAN_FN.py:331-333)
WAN_FN_U_LAYERS = [
    (1, 10, 1), (1, 10, 10, 1), (1, 10, 10, 10, 1), (1, 10, 10, 10, 10, 1),
    (1, 50, 1), (1, 50, 50, 1), (1, 50, 50, 50, 1), (1, 50, 50, 50, 50, 1),
    (1, 100, 1), (1, 100, 100, 1), (1, 100, 100, 100, 1),
    (1, 100, 100, 100, 100, 1),
]
WAN_FN_V_LAYERS = [
    (1, 5, 1), (1, 5, 5, 1), (1, 5, 5, 5, 1), (1, 5, 5, 5, 5, 1),
    (1, 20, 1), (1, 20, 20, 1), (1, 20, 20, 20, 1), (1, 20, 20, 20, 20, 1),
    (1, 50, 1), (1, 50, 50, 1), (1, 50, 50, 50, 1), (1, 50, 50, 50, 50, 1),
]


def sweep_poisson(
    dims: Sequence[int] = (2,),
    methods: Sequence[str] = ("DRM", "PINN", "WAN"),
    bc_mode: str = "FBC",
    epochs: int = 10000,
    save_dir: str = "results/ND_Poisson",
    device="cuda",
    **overrides,
) -> List[Dict]:
    rows = []
    for method in methods:
        for dim in dims:
            cfg = PoissonConfig(dim=dim, method=method, bc_mode=bc_mode,
                                epochs=epochs, **overrides)
            rows.append(run_poisson_nd(cfg, save_dir=save_dir, device=device)["row"])
    return rows


def sweep_ipw_1d(
    n_values: Sequence[int],
    epochs: int = 3000,
    LBFGS: bool = False,
    include_wan: bool = False,
    save_dir: str = "results/Infinite_Potential_Well_1D",
    device="cuda",
    **overrides,
) -> List[Dict]:
    rows = []
    for n in n_values:
        for method in ("PINN", "DRM"):
            for technique in ("BC", "FBC", "FN", "OG"):
                cfg = IPW1DConfig(n=n, method=method, technique=technique,
                                  epochs=epochs, LBFGS=LBFGS, **overrides)
                rows.append(run_ipw_1d(cfg, save_dir=save_dir, device=device)["row"])
        if include_wan:
            for technique in ("BC", "FBC", "OG"):
                cfg = IPW1DWanConfig(n=n, technique=technique, epochs=epochs,
                                     **overrides)
                rows.append(run_ipw_1d_wan(cfg, save_dir=save_dir, device=device)["row"])
    return rows


def sweep_ipw_wan_fn_ablation(
    n: int = 5,
    epochs: int = 10000,
    pairs: Optional[Sequence[int]] = None,
    save_dir: str = "results/Infinite_Potential_Well_1D_Compare_For_Paper",
    device="cuda",
    **overrides,
) -> List[Dict]:
    """Depth/width ablation: paired u/v architectures (zip, as in the
    reference's loop).  ``pairs`` selects grid indices (default: all 12)."""
    idx = range(len(WAN_FN_U_LAYERS)) if pairs is None else pairs
    rows = []
    for i in idx:
        cfg = IPW1DWanConfig(
            n=n, technique="FN", epochs=epochs,
            layers=WAN_FN_U_LAYERS[i], v_layers=WAN_FN_V_LAYERS[i],
            fn_variant=True, **overrides,
        )
        out = run_ipw_1d_wan(cfg, save_dir=save_dir, device=device)
        out["row"]["layers"] = list(WAN_FN_U_LAYERS[i])
        out["row"]["v_layers"] = list(WAN_FN_V_LAYERS[i])
        rows.append(out["row"])
    return rows


def sweep_qho_1d(
    n_values: Sequence[int],
    epochs: int = 3000,
    LBFGS: bool = False,
    save_dir: str = "results/Quantum_Harmonic_Oscillator_1D",
    device="cuda",
    **overrides,
) -> List[Dict]:
    rows = []
    for n in n_values:
        for method in ("PINN", "DRM"):
            cfg = QHO1DConfig(n=n, method=method, technique="FN",
                              epochs=epochs, LBFGS=LBFGS, **overrides)
            rows.append(run_qho_1d(cfg, save_dir=save_dir, device=device)["row"])
    return rows


def sweep_kh_alpha(
    alphas: Sequence[float] = (0, 5, 10, 15, 20),
    *,
    n_max: int = 1,
    epochs: int = 10000,
    save_dir: str = "results/KH_1D",
    device="cuda",
    **overrides,
) -> List[Dict]:
    """Laser-intensity sweep over the quiver amplitude alpha — the
    commented-out study in the reference's __main__ (KH_1D.py:639-653):
    one run_compare per alpha, each with its own results file."""
    from ..problems.kh import KHCompareConfig, run_compare

    rows = []
    for alpha in alphas:
        rows.extend(run_compare(KHCompareConfig(
            alpha=float(alpha), n_max=n_max, epochs=epochs,
            data_fraction=0.5, max_data_points=500,
            save_dir=save_dir,
            results_filename=f"results_KH_1D_alpha{alpha}.json",
            **overrides,
        ), device=device))
    return rows


def sweep_qho_2d_energy(
    n_values: Sequence[Sequence[int]] = ((0, 0), (1, 0), (1, 1), (2, 0),
                                         (2, 1), (2, 2)),
    epochs: int = 50000,
    save_dir: str = "results/Quantum_Harmonic_Oscillator_2D_Compare_For_Paper",
    device="cuda",
    **overrides,
) -> List[Dict]:
    """The paper sweep (QHO_2D_Energy.py:557-581): trainable energy,
    energy-variant weight table; PINN runs FBC/FN, DRM and WAN run FN/OG."""
    rows = []
    for nx, ny in n_values:
        for method, techniques in (
            ("PINN", ("FBC", "FN")),
            ("DRM", ("FN", "OG")),
            ("WAN", ("FN", "OG")),
        ):
            for technique in techniques:
                # the reference passes trainable_energy=True for every
                # method but only PINN consumes it (QHO_2D_Energy.py:287,
                # 382); we make that explicit — DRM/WAN train with fixed E
                ov = dict(overrides)
                cfg = QHO2DConfig(
                    nx=nx, ny=ny, method=method, technique=technique,
                    epochs=epochs, trainable_energy=(method == "PINN"),
                    energy_variant=True,
                    **ov,
                )
                rows.append(run_qho_2d(cfg, save_dir=save_dir, device=device)["row"])
    return rows
