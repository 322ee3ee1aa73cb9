"""The port's experiment sweeps (``nnpde_tpu_torch/exp/sweeps.py``) and
top-level API against the JAX package's.

* Every sweep builds the same list of configurations, save directories and
  (for the KH laser sweep) results files as JAX's: both packages' run
  functions are replaced by recorders, so nothing trains.
* The reference ablation grids are equal.
* One tiny sweep (``sweep_ipw_1d`` at n = 1, 5 epochs, a (1, 8, 1) net)
  runs end to end on the CPU and writes its 8 rows to one ledger.
* ``nnpde_tpu_torch`` exports the JAX package's convenience names.

Cost: about 7 s alone on one worker.
"""

import dataclasses
import importlib

import pytest

import nnpde_tpu.exp.sweeps as jsw
import nnpde_tpu_torch.exp.sweeps as tsw

JET = {"xla": "torch", "pallas": "kernel", "pallas-fused": "fused"}
SWEEPS = {
    "sweep_poisson": dict(dims=[1, 3], methods=("PINN", "WAN"), epochs=5, width=8),
    "sweep_ipw_1d": dict(n_values=[1, 2], include_wan=True, LBFGS=True, epochs=5),
    "sweep_ipw_wan_fn_ablation": dict(n=3, pairs=[0, 5, 11], epochs=5),
    "sweep_qho_1d": dict(n_values=[0, 2], epochs=5, grid_n=64),
    "sweep_kh_alpha": dict(alphas=(0, 10), n_max=2, epochs=5, methods=("PINN",)),
    "sweep_qho_2d_energy": dict(n_values=((0, 0), (2, 1)), epochs=5),
}


def _record(monkeypatch, pkg, calls):
    """Replace the run functions a sweep calls by recorders of (name,
    config, keyword arguments)."""
    def recorder(name):
        def run(cfg, **kw):
            kw.pop("device", None)
            rec = dataclasses.asdict(cfg)
            if "jet_impl" in rec:
                rec["jet_impl"] = JET.get(rec["jet_impl"], rec["jet_impl"])
            calls.append((name, type(cfg).__name__, rec, kw))
            row = {"layers": None, "v_layers": None}
            return [row] if name == "run_compare" else {"row": row}
        return run

    sweeps = importlib.import_module(f"{pkg}.exp.sweeps")
    for name in dir(sweeps):
        if name.startswith("run_"):
            monkeypatch.setattr(sweeps, name, recorder(name))
    monkeypatch.setattr(importlib.import_module(f"{pkg}.problems.kh"), "run_compare",
                        recorder("run_compare"))


@pytest.mark.parametrize("name", sorted(SWEEPS))
@pytest.mark.parametrize("given", [False, True])
def test_sweep_builds_the_same_configurations(name, given, monkeypatch):
    """The same arguments (none but the required, or the table's) give the
    same runs in the same order."""
    kw = dict(SWEEPS[name]) if given else {k: v for k, v in SWEEPS[name].items()
                                           if k == "n_values" and name != "sweep_qho_2d_energy"}
    jcalls, tcalls = [], []
    _record(monkeypatch, "nnpde_tpu", jcalls)
    _record(monkeypatch, "nnpde_tpu_torch", tcalls)
    getattr(jsw, name)(**kw)
    getattr(tsw, name)(**kw, device="cpu")
    assert jcalls and jcalls == tcalls


def test_ablation_grids_equal():
    assert tsw.WAN_FN_U_LAYERS == jsw.WAN_FN_U_LAYERS
    assert tsw.WAN_FN_V_LAYERS == jsw.WAN_FN_V_LAYERS
    assert len(tsw.WAN_FN_U_LAYERS) == 12


def test_tiny_sweep_end_to_end(tmp_path):
    """sweep_ipw_1d at n = 1: {PINN, DRM} x {BC, FBC, FN, OG}, 8 rows in the
    ledger, every checkpoint on disk."""
    import os

    from nnpde_tpu_torch.exp.ledger import load_results

    rows = tsw.sweep_ipw_1d([1], epochs=5, chunk=5, layers=(1, 8, 1), grid_n=64,
                            save_dir=str(tmp_path), device="cpu")
    assert len(rows) == 8
    assert {(r["method"], r["technique"]) for r in rows} == {
        (m, t) for m in ("PINN", "DRM") for t in ("BC", "FBC", "FN", "OG")}
    assert len(load_results(str(tmp_path / "results_IPW_1D.json"))) == 8
    assert all(os.path.exists(r["best_model_path"]) for r in rows)


def test_top_level_api():
    import nnpde_tpu
    import nnpde_tpu_torch

    for name in ("PoissonConfig", "train_poisson_nd", "IPW1DConfig", "IPW1DWanConfig",
                 "train_ipw_1d", "train_ipw_1d_wan", "IPW2DConfig", "train_ipw_2d",
                 "QHO1DConfig", "QHO1DWanConfig", "train_qho_1d", "train_qho_1d_wan",
                 "QHO2DConfig", "train_qho_2d", "KHConfig", "KHCompareConfig", "run_compare",
                 "train_kh", "KHGroundTruth"):
        assert hasattr(nnpde_tpu, name), name
        assert hasattr(nnpde_tpu_torch, name), name
