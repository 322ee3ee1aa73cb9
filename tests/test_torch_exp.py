"""The port's model registry, figures, ledger tables and runtime helpers
(``models/registry.py``, ``exp/plotting.py``, ``exp/results_process.py``,
``runtime.py``) against the JAX package's.

* ``build_solution_model`` for every meta schema (each problem and
  technique, hard Neumann, every critic rule): the same parameters carried
  across give u and the jet (value, gradient, Laplacian) within 1e-12 of
  JAX's in float64; unknown problems raise in both.
* ``results_to_csv`` (and its ``main``) write byte-identical CSV from one
  ledger, with every option.
* Each figure writes a PNG: the six drawing functions, ``load_checkpoint_model``
  through the overlay, and the run wrappers' ``plot=True`` (1D overlay and
  curves, the 2D quad, the 3D slice).
* ``profile_trace`` writes a trace; ``enable_debug_nans`` switches anomaly
  mode; ``force_cpu`` hides the cards from a fresh process;
  ``enable_compilation_cache`` does nothing.

Cost: about 29 s alone on one worker.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnpde_tpu.exp.results_process as jrp
from nnpde_tpu.models.registry import build_solution_model as j_build

import nnpde_tpu_torch.exp.plotting as tplot
import nnpde_tpu_torch.exp.results_process as trp
from nnpde_tpu_torch import runtime
from nnpde_tpu_torch.exp.checkpoint import save_params
from nnpde_tpu_torch.exp.ledger import append_result, save_curves
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.models.registry import build_solution_model as t_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (meta, domain (lo, hi) of the sample points)
METAS = [
    (dict(problem="poisson_nd", layers=[2, 8, 8, 1], activation="sin", L=2.0), (0, 2)),
    (dict(problem="poisson_nd", layers=[3, 8, 1], activation="sin", bc_mode="RB", L=2.0),
     (0, 2)),
    (dict(problem="poisson_nd", layers=[2, 8, 1], activation="sin", bc_type="neumann",
          bc_mode="FBC", L=2.0), (0, 2)),
    *[(dict(problem="ipw_1d", layers=[1, 8, 8, 1], activation="tanh", technique=t, n=3,
            L=2.0), (0, 2)) for t in ("BC", "FBC", "FN", "OG")],
    (dict(problem="ipw_1d_wan", layers=[1, 8, 1], activation="tanh", technique="FN", n=2,
          L=2.0), (0, 2)),
    *[(dict(problem="ipw_2d", layers=[2, 8, 1], activation="sin", technique=t, nx=2, ny=3,
            L=2.0), (0, 2)) for t in ("FBC", "FN", "OG")],
    *[(dict(problem="qho_1d", layers=[1, 8, 1], activation="sin", technique=t, n=2,
            x_max=6.0), (-6, 6)) for t in ("BC", "OG", "FN", "FBC")],
    (dict(problem="qho_1d_wan", layers=[1, 8, 1], activation="tanh", technique="BC", n=1,
          x_max=6.0), (-6, 6)),
    *[(dict(problem="qho_2d", layers=[2, 8, 1], activation="sin", technique=t, nx=1, ny=2,
            L=6.0), (-6, 6)) for t in ("FBC", "FN", "OG")],
    *[(dict(problem="kh_1d", layers=[1, 8, 1], activation="sin", technique=t, L=60.0),
       (-60, 60)) for t in ("RAW", "FBC")],
    *[(dict(problem=p, layers=[d, 6, 1], activation="tanh", role="critic", technique="FN",
            n=1, nx=1, ny=1, L=2.0, x_max=6.0), (0, 2))
      for p, d in (("poisson_nd", 2), ("ipw_1d", 1), ("ipw_1d_wan", 1), ("kh_1d", 1),
                   ("ipw_2d", 2), ("qho_2d", 2))],
    *[(dict(problem=p, layers=[1, 6, 1], activation="tanh", role="critic", technique=t,
            x_max=6.0), (-6, 6)) for p, t in (("qho_1d", "OG"), ("qho_1d", "BC"),
                                                ("qho_1d_wan", "FBC"))],
]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("meta,domain", METAS,
                         ids=[f"{m['problem']}-{m.get('technique', m.get('bc_type', 'FBC'))}"
                              f"{'-critic' if m.get('role') else ''}-{i}"
                              for i, (m, _) in enumerate(METAS)])
def test_registry_matches_jax(meta, domain):
    """u and the jet of the rebuilt model within 1e-12 of JAX's in float64."""
    jm, tm = j_build(meta), t_build(meta)
    d = meta["layers"][0]
    rng = np.random.default_rng(len(meta["layers"]) + d)
    X = rng.uniform(domain[0] * 0.98, domain[1] * 0.98, (33, d))
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    jm.init(jax.random.PRNGKey(4)))
        ju = np.asarray(jm.apply_batch(jp, jnp.asarray(X)))
        jj = jm.fields(jp, jnp.asarray(X))
        jjet = [np.asarray(t) for t in (jj.value, jj.grad, jj.lap)]
    tp = params_from_jax([(np.asarray(W), np.asarray(b)) for W, b in jp], dtype=torch.float64)
    Xt = torch.as_tensor(X)
    assert _rel(tm.apply_batch(tp, Xt).detach().numpy(), ju) <= 1e-12
    tj = tm.fields(tp, Xt)
    for a, b in zip((tj.value, tj.grad, tj.lap), jjet):
        assert _rel(a.detach().numpy(), b) <= 1e-12
    assert (tm.factor is None) == (jm.factor is None)
    assert (tm.input_map is None) == (jm.input_map is None)


def test_registry_unknown_problems_raise():
    for meta in (dict(problem="nope", layers=[1, 4, 1]),
                 dict(problem="ipw_3d", layers=[3, 4, 1]),
                 dict(problem="nope", layers=[1, 4, 1], role="critic")):
        with pytest.raises(ValueError):
            j_build(meta)
        with pytest.raises(ValueError):
            t_build(meta)


@pytest.fixture
def ledger(tmp_path):
    rows = [
        {"method": "PINN", "L2_error": 0.5, "time": 1.25, "time_of_best_model": None, "n": 1,
         "technique": "FN", "layers": [1, 8, 1]},
        {"method": "PINN", "L2_error": 0.125, "time": 2.0, "n": [1, 2], "technique": "BC"},
        {"method": "DRM", "L2_error": 3e-7, "time": 0.1, "n": 2, "technique": "OG",
         "layers": [1, 50, 50, 1], "extra": {"a": 1}},
        {"method": "WAN", "time": 9.0, "n": 0, "technique": "FBC"},
    ]
    path = str(tmp_path / "results_X.json")
    for r in rows:
        append_result(path, r)
    return path


@pytest.mark.parametrize("kw", [
    {},
    {"best_per_method": True},
    {"require_keys": ["layers"], "fields": ["method", "layers", "L2_error"]},
    {"fields": ["technique", "n", "time_of_best_model", "missing"], "best_per_method": True},
])
def test_results_to_csv_byte_identical(ledger, tmp_path, kw):
    a = jrp.results_to_csv(ledger, str(tmp_path / "j.csv"), **kw)
    b = trp.results_to_csv(ledger, str(tmp_path / "t.csv"), **kw)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_results_process_main_byte_identical(ledger, tmp_path, capsys):
    argv = ["--fields", "method", "L2_error", "n", "--best-per-method"]
    assert jrp.main([ledger, "-o", str(tmp_path / "j.csv")] + argv) == 0
    assert trp.main([ledger, "-o", str(tmp_path / "t.csv")] + argv) == 0
    assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()
    assert trp.main([ledger]) == 0
    assert capsys.readouterr().out.strip().endswith("results_X.csv")


def _png(path):
    assert os.path.exists(path) and open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n", path
    return path


def test_each_figure_writes_a_png(tmp_path):
    rng = np.random.default_rng(0)
    d = str(tmp_path)
    curves = save_curves(d, "run", {"losses": np.exp(-np.arange(20.0)),
                                    "L2_errors": np.linspace(1, -1, 20)})
    rows = [{"method": "PINN", "n": 1, "technique": "FN", **curves}]
    for p in tplot.plot_curves(rows, os.path.join(d, "c")):
        _png(p)
    meta = dict(problem="ipw_1d", layers=[1, 8, 1], activation="tanh", technique="FN", n=2,
                L=2.0)
    P = [(torch.randn(1, 8), torch.randn(8)), (torch.randn(8, 1), torch.randn(1))]
    ckpt = save_params(os.path.join(d, "ck"), P, meta=meta)
    model, params, meta2 = tplot.load_checkpoint_model(ckpt)
    assert meta2 == meta and torch.equal(params[0][0], P[0][0])
    x = np.linspace(0, 2, 100)
    _png(tplot.plot_wavefunction_overlay(ckpt, x, np.sin(np.pi * x), os.path.join(d, "o.png"),
                                         title="t"))
    g = np.linspace(0, 1, 12)
    GX, GY = np.meshgrid(g, g, indexing="ij")
    _png(tplot.plot_2d_comparison(GX, GY, GX * GY, GX + GY, os.path.join(d, "q.png")))
    M, C = 1, 3
    _png(tplot.plot_floquet_harmonics(x, rng.normal(size=(100, C)), rng.normal(size=(100, C)),
                                      rng.normal(size=(100, C)), rng.normal(size=(100, C)), M,
                                      0.5, os.path.join(d, "f.png")))
    U = rng.normal(size=(100, 3))
    _png(tplot.plot_subspace_states(x, torch.as_tensor(U), [0.5, 1.5, 2.5],
                                    os.path.join(d, "s.png"), psi=U[:, ::-1], V=x ** 2))
    _png(tplot.plot_solution_gt(x, np.sin(x), -np.sin(x), x ** 2, 0.3, "PINN", 0,
                                os.path.join(d, "k.png")))


def test_run_wrappers_draw_when_asked(tmp_path):
    """plot=True: the 1D overlay and curves and the 2D quad plot; the 3D
    slice at a 40 x 40 grid (``run_ipw_3d(plot=True)`` draws it at 200)."""
    from nnpde_tpu_torch.exp import run
    from nnpde_tpu_torch.problems import IPW1DConfig, IPW2DConfig, IPW3DConfig

    d = str(tmp_path)
    out = run.run_ipw_1d(IPW1DConfig(n=2, layers=(1, 8, 1), epochs=3, chunk=3, grid_n=64),
                         save_dir=d, plot=True, device="cpu")
    assert len(out["plot_paths"]) == 3 and all(_png(p) for p in out["plot_paths"])
    out = run.run_ipw_2d(IPW2DConfig(method="DRM", layers=(2, 8, 1), epochs=3, chunk=3,
                                     grid_n=12, data_grid_n=8), save_dir=d, plot=True,
                         device="cpu")
    assert os.path.basename(_png(out["plot_path"])).startswith("pinn_vs_exact_DRM_FBC_n1_1_")
    out = run.run_ipw_3d(IPW3DConfig(epochs=3, chunk=3, n_interior=256, layers=(3, 8, 1),
                                     data_grid_n=6, n_eval=256), save_dir=d, device="cpu")
    png = run.plot_ipw_3d_slice(out, d, out["row"]["tag"], n=40)
    assert os.path.basename(_png(png)).startswith("slice_z0.5_PINN_FN_n1_1_1_")


def test_profile_trace_writes_a_trace(tmp_path):
    with runtime.profile_trace(str(tmp_path / "prof")):
        torch.sin(torch.ones(64)).sum()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    trace = json.load(open(tmp_path / "prof" / files[0]))
    assert any("sin" in e.get("name", "") for e in trace["traceEvents"])


def test_runtime_switches():
    assert runtime.enable_compilation_cache() is None
    was = torch.is_anomaly_enabled()
    try:
        runtime.enable_debug_nans()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
        runtime.enable_debug_nans(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)
    with pytest.raises(ValueError):
        runtime.force_cpu(0)
    probe = ("import torch\nfrom nnpde_tpu_torch import runtime\n"
             "print(runtime.force_cpu(4), torch.cuda.is_available())\n"
             "try:\n    runtime.resolve_device()\nexcept RuntimeError:\n    print('raises')\n")
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert r.stdout.split() == ["4", "False", "raises"], r.stderr
