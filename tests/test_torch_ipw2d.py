"""The 2D infinite-well slice of the port against the JAX package, on the
CPU at a small size (widths 12-16, ``grid_n`` 12).

* ``ops/quadrature.py``, ``pde/ipw.py``, the grid samplers and the rest of
  the loss zoo against their JAX counterparts on numpy inputs: float64,
  rel <= 1e-12; the FN trial factor's jet (``nodes_per_dim``) rel <= 1e-12.
* ``train_ipw_2d`` from the same transferred ``init_params`` /
  ``init_v_params`` on the fixed grid, for PINN, DRM and WAN
  (``n_test_grid`` 1 and 2): every ``jet_impl`` of the port (``torch``,
  ``kernel``, ``fused``; the kernel wrappers take their plain versions on
  CPU tensors) against the JAX run on ``jet_impl="xla"``: the first total
  within rtol 1e-4 and the first epochs within 5e-2 (the band of the JAX
  package's own fused-vs-XLA tests), the first PDE/DRM term within 1e-3,
  the ``weights`` table and history keys equal.
* Resume in two segments equals one run, exactly.
* ``compile_only=True`` (the memory probe, measured on the card) returns
  the JAX package's keys for the WAN and PINN configurations of
  ``tests/test_minimax.py::test_fit_compile_only_memory_probe`` (the key
  set equal to the JAX probe's), and the hybrid config probes its bf16
  bulk phase; nothing trains.
* Each option that raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.losses import zoo as jzoo
from nnpde_tpu.models import factor_for_technique as j_factor
from nnpde_tpu.ops import quadrature as jquad
from nnpde_tpu.pde import ipw as jphys
from nnpde_tpu.problems.ipw2d import IPW2DConfig as JConfig
from nnpde_tpu.problems.ipw2d import train_ipw_2d as j_train
from nnpde_tpu.sampling.samplers import linspace_grid as j_linspace_grid
from nnpde_tpu.sampling.samplers import meshgrid_2d as j_meshgrid_2d
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import LAUNCHES
from nnpde_tpu_torch.losses import zoo
from nnpde_tpu_torch.models import factor_for_technique
from nnpde_tpu_torch.ops import quadrature as quad
from nnpde_tpu_torch.pde import ipw as phys
from nnpde_tpu_torch.problems import IPW2DConfig, train_ipw_2d, unit_normalize
from nnpde_tpu_torch.problems.ipw2d import _lower_states_2d
from nnpde_tpu_torch.sampling import linspace_grid, meshgrid_2d

EPOCHS = 6
BASE = dict(nx=2, ny=2, technique="FN", layers=(2, 16, 16, 1), v_layers=(2, 12, 12, 1),
            v_steps=2, grid_n=12, data_grid_n=8, n_boundary=12, epochs=EPOCHS, chunk=3,
            seed=0)
CASES = {
    "PINN": dict(method="PINN", weights={"data": 1e4}),
    "DRM": dict(method="DRM"),
    "WAN1": dict(method="WAN", n_test_grid=1),
    "WAN2": dict(method="WAN", n_test_grid=2),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_quadrature_physics_samplers_and_zoo_match_jax():
    rng = np.random.default_rng(0)
    N = 50
    u, v, lap, V = (rng.normal(size=N) for _ in range(4))
    g = rng.normal(size=(N, 2))
    low = rng.normal(size=(N, 3))
    x, y, z = (rng.uniform(0.0, 2.0, N) for _ in range(3))
    with jax.enable_x64(True):
        ju, jv, jl, jV, jg, jlow = map(jnp.asarray, (u, v, lap, V, g, low))
        want = [
            jquad.integral_mean(ju, 4.0), jquad.inner_product(ju, jv, 4.0),
            *np.asarray(jquad.normalize_l2(ju, 4.0)), jquad.sign_aware_mse(ju, -jv),
            *np.asarray(jquad.trapezoid_weights(5, jnp.float64)),
            jzoo.pinn_helmholtz(ju, jl, 3.3), jzoo.pinn_schrodinger(ju, jl, jV, 1.7),
            jzoo.drm_rayleigh(ju, jg, jV, den_eps=1e-8), jzoo.drm_rayleigh_unscaled(ju, jg),
            jzoo.norm_pointwise(ju), jzoo.norm_integral(ju, 4.0), jzoo.norm_trapezoid(ju, 0.1),
            jzoo.orthogonal_projection(ju, jlow, 4.0),
            jzoo.orthogonal_projection(ju, jlow[:, :0], 4.0),
            jzoo.reflection_mse(ju, jv, -1.0),
            *np.asarray(jphys.psi_1d(3, jnp.asarray(x), 2.0)),
            *np.asarray(jphys.psi_2d(3, 2, jnp.asarray(x), jnp.asarray(y), 2.0)),
            *np.asarray(jphys.psi_3d(1, 2, 3, *map(jnp.asarray, (x, y, z)), 2.0)),
            jphys.energy_1d(3, 2.0), jphys.energy_2d(3, 2, 2.0), jphys.energy_3d(1, 2, 3, 2.0),
            *jphys.nodes(4, 2.0),
            *np.ravel(np.asarray(j_linspace_grid(7, 0.0, 2.0, jnp.float64))),
            *np.ravel(np.asarray(j_meshgrid_2d(4, 0.0, 2.0, jnp.float64))),
        ]
    tu, tv, tl, tV, tg, tlow = map(torch.as_tensor, (u, v, lap, V, g, low))
    got = [
        quad.integral_mean(tu, 4.0), quad.inner_product(tu, tv, 4.0),
        *quad.normalize_l2(tu, 4.0).numpy(), quad.sign_aware_mse(tu, -tv),
        *quad.trapezoid_weights(5, torch.float64).numpy(),
        zoo.pinn_helmholtz(tu, tl, 3.3), zoo.pinn_schrodinger(tu, tl, tV, 1.7),
        zoo.drm_rayleigh(tu, tg, tV, den_eps=1e-8), zoo.drm_rayleigh_unscaled(tu, tg),
        zoo.norm_pointwise(tu), zoo.norm_integral(tu, 4.0), zoo.norm_trapezoid(tu, 0.1),
        zoo.orthogonal_projection(tu, tlow, 4.0),
        zoo.orthogonal_projection(tu, tlow[:, :0], 4.0),
        zoo.reflection_mse(tu, tv, -1.0),
        *phys.psi_1d(3, torch.as_tensor(x), 2.0).numpy(),
        *phys.psi_2d(3, 2, torch.as_tensor(x), torch.as_tensor(y), 2.0).numpy(),
        *phys.psi_3d(1, 2, 3, *map(torch.as_tensor, (x, y, z)), 2.0).numpy(),
        phys.energy_1d(3, 2.0), phys.energy_2d(3, 2, 2.0), phys.energy_3d(1, 2, 3, 2.0),
        *phys.nodes(4, 2.0),
        *np.ravel(linspace_grid(7, 0.0, 2.0, torch.float64).numpy()),
        *np.ravel(meshgrid_2d(4, 0.0, 2.0, torch.float64).numpy()),
    ]
    got, want = [float(a) for a in got], [float(a) for a in want]
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_fn_factor_and_lower_states_match_jax():
    """Technique FN as ``train_ipw_2d`` calls it (``nodes_per_dim`` from the
    state's nodes), and the degeneracy-aware lower states."""
    from nnpde_tpu.problems.ipw2d import _lower_states_2d as j_lower

    rng = np.random.default_rng(1)
    X = rng.uniform(0.0, 2.0, (40, 2))
    nodes = [phys.nodes(3, 2.0), phys.nodes(2, 2.0)]
    with jax.enable_x64(True):
        fj = j_factor("FN", dim=2, kind="box", L=2.0, nodes_per_dim=nodes).jet(jnp.asarray(X))
        lj = j_lower(3, 3, jnp.asarray(X), 2.0)
    ft = factor_for_technique("FN", dim=2, kind="box", L=2.0,
                              nodes_per_dim=nodes).jet(torch.as_tensor(X))
    for a, b in zip(ft, fj):
        assert _rel(a.numpy(), np.asarray(b)) <= 1e-12
    lt = _lower_states_2d(3, 3, torch.as_tensor(X), 2.0)
    assert lt.shape == lj.shape == (40, 8)
    assert _rel(lt.numpy(), np.asarray(lj)) <= 1e-12
    assert _lower_states_2d(1, 1, torch.as_tensor(X), 2.0).shape == (40, 0)
    u = torch.as_tensor(rng.normal(size=40))
    un = unit_normalize(u, 0.5)
    assert abs(float(torch.sqrt(torch.mean(un * un))) - 0.5) <= 1e-12


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX package's run of one case on ``jet_impl='xla'``, with the
    initial weights it drew (numpy)."""
    from nnpde_tpu.models import NetSpec as JNetSpec
    from nnpde_tpu.models import SolutionModel as JSolutionModel

    kw = dict(BASE, **CASES[case])
    key = jax.random.PRNGKey(7)
    ju = JSolutionModel(JNetSpec(kw["layers"], activation="sin"), None).init(key)
    jv = JSolutionModel(JNetSpec(kw["v_layers"], activation="sin"), None).init(
        jax.random.fold_in(key, 9))
    out = j_train(JConfig(jet_impl="xla", **kw), init_params=ju, init_v_params=jv)
    to_np = lambda p: [(np.array(W), np.array(b)) for W, b in p]
    return out, to_np(ju), to_np(jv)


@pytest.mark.parametrize("jet_impl", ["torch", "kernel", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_ipw_2d_matches_jax(case, jet_impl):
    jout, u0, v0 = _jax_run(case)
    kw = dict(BASE, **CASES[case])
    tout = train_ipw_2d(IPW2DConfig(jet_impl=jet_impl, **kw),
                        init_params=params_from_jax(u0), init_v_params=params_from_jax(v0),
                        device="cpu")
    assert set(tout) == set(jout)
    assert tout["weights"] == jout["weights"]
    hj, ht = jout["history"], tout["history"]
    assert set(ht) == set(hj)
    tj, tt = np.asarray(hj["total"]), ht["total"]
    assert tt.shape == (EPOCHS,) and np.all(np.isfinite(tt))
    np.testing.assert_allclose(tt[0], tj[0], rtol=1e-4)
    np.testing.assert_allclose(tt, tj, rtol=5e-2)
    term = "drm" if case == "DRM" else "pde"
    np.testing.assert_allclose(ht[term][0], np.asarray(hj[term])[0], rtol=1e-3)
    np.testing.assert_allclose(ht["l2"][0], np.asarray(hj["l2"])[0], rtol=1e-3)
    assert np.isfinite(tout["rel_l2"]) and tout["L2_error"] == tout["result"].best_metric
    assert tout["config"]["jet_impl"] == jet_impl


@pytest.mark.parametrize("case,jet_impl", [("PINN", "kernel"), ("DRM", "fused"),
                                           ("WAN2", "fused"), ("WAN1", "torch")])
def test_resume_in_two_segments_equals_one_run(case, jet_impl):
    kw = dict(BASE, **CASES[case], jet_impl=jet_impl, lr_schedule="cosine",
              lr_decay_steps=4, minimax="optimistic" if case == "WAN2" else "alternating")
    _, u0, v0 = _jax_run(case)
    init = lambda: dict(init_params=params_from_jax(u0), init_v_params=params_from_jax(v0))
    full = train_ipw_2d(IPW2DConfig(**kw), device="cpu", **init())
    a = train_ipw_2d(IPW2DConfig(**kw), run_epochs=4, device="cpu", **init())
    b = train_ipw_2d(IPW2DConfig(**kw), init_carry=a["result"].carry, start_epoch=4,
                     device="cpu", **init())
    for name in ("total", "l2"):
        assert np.array_equal(np.concatenate([a["history"][name], b["history"][name]]),
                              full["history"][name])
    for (W1, b1), (W2, b2) in zip(full["result"].params, b["result"].params):
        assert torch.equal(W1, W2) and torch.equal(b1, b2)
    assert b["min_epoch"] == full["min_epoch"]


@pytest.mark.parametrize("extra", [
    dict(n_test_grid=2, grid_jitter=True),
    dict(n_test_grid=2, grid_jitter=True, jitter_anchors_fixed=True, eval_selfnorm=True),
    dict(n_test_grid=1, wan_resample=True, minimax="extragradient", u_ema=0.9, v_lr=2e-3),
    dict(n_test_grid=2, minimax="optimistic", lr_schedule="exponential", technique="OG"),
    dict(n_test_grid=1, technique="FBC", nx=1, ny=2),
])
def test_wan_options_run_on_both_paths(extra):
    """The fused WAN path (plain versions here) tracks the autograd path
    under every WAN option: first total within 1e-4, all within 5e-2."""
    kw = dict(BASE, method="WAN", **extra)
    a = train_ipw_2d(IPW2DConfig(jet_impl="torch", **kw), device="cpu")
    b = train_ipw_2d(IPW2DConfig(jet_impl="fused", **kw), device="cpu")
    ha, hb = a["history"], b["history"]
    assert np.all(np.isfinite(ha["total"])) and np.all(np.isfinite(hb["total"]))
    assert np.all(np.isfinite(hb["wan_loss_v"]))
    np.testing.assert_allclose(hb["total"][0], ha["total"][0], rtol=1e-4)
    np.testing.assert_allclose(hb["total"], ha["total"], rtol=5e-2)
    np.testing.assert_allclose(hb["pde"][0], ha["pde"][0], rtol=1e-3)
    if extra.get("u_ema"):
        assert np.all(np.isfinite(hb["l2_ema"]))


def test_streams_option_and_launch_counts_stay_zero_on_cpu():
    """``jet_impl='kernel:streams'`` takes the same steps as ``'kernel'``;
    no wrapper counts a launch for a CPU tensor."""
    before = dict(LAUNCHES)
    kw = dict(BASE, **CASES["PINN"])
    a = train_ipw_2d(IPW2DConfig(jet_impl="kernel", **kw), device="cpu")
    b = train_ipw_2d(IPW2DConfig(jet_impl="kernel:streams", **kw), device="cpu")
    assert np.array_equal(a["history"]["total"], b["history"]["total"])
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("kw,exc,match", [
    (dict(compute_dtype="bfloat16", LBFGS=True, jet_impl="xla"), ValueError, "jet_impl"),
    (dict(compute_dtype="hybrid", LBFGS=True, method="FEM"), ValueError, "method"),
    (dict(compute_dtype="float16"), ValueError, "compute_dtype"),
    (dict(LBFGS=True, technique="RB"), ValueError, "technique"),
    (dict(jet_impl="pallas-fused"), ValueError, "jet_impl"),
    (dict(method="FEM"), ValueError, "method"),
    (dict(technique="RB"), ValueError, "technique"),
    (dict(minimax="sgd", method="WAN"), ValueError, "minimax"),
])
def test_options_that_raise(kw, exc, match):
    with pytest.raises(exc, match=match):
        train_ipw_2d(IPW2DConfig(**dict(BASE, **kw)), device="cpu")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "hybrid"])
def test_lbfgs_polish_runs_in_every_precision(monkeypatch, compute_dtype):
    """``LBFGS=True`` polishes after the last epoch in every precision (the
    polish differentiates the run's own objective: float32 in the
    ``hybrid`` tail); the polished iterate is the result's params.  The
    polish is cut to 20 of its 500 iterations (its full length is held to
    JAX in ``tests/test_torch_eigen1d.py``)."""
    import nnpde_tpu_torch.problems.ipw as tipw

    real = tipw.lbfgs_polish
    monkeypatch.setattr(tipw, "lbfgs_polish",
                        lambda loss, p, max_iter: real(loss, p, max_iter=20))
    kw = dict(BASE, **CASES["PINN"], compute_dtype=compute_dtype, jet_impl="kernel")
    a = train_ipw_2d(IPW2DConfig(**kw), device="cpu")
    b = train_ipw_2d(IPW2DConfig(LBFGS=True, **kw), device="cpu")
    assert np.array_equal(a["history"]["total"], b["history"]["total"])
    assert np.isfinite(b["L2_error"]) and b["L2_error"] <= a["L2_error"]
    moved = max(float(torch.max(torch.abs(x - y)))
                for pa, pb in zip(a["result"].params, b["result"].params)
                for x, y in zip(pa, pb))
    assert moved > 0.0


def test_segment_past_the_horizon_and_missing_card_raise(monkeypatch):
    with pytest.raises(ValueError, match="exceeds"):
        train_ipw_2d(IPW2DConfig(**BASE), start_epoch=4, run_epochs=4, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_ipw_2d(IPW2DConfig(**BASE))


@pytest.mark.parametrize("case,j_impl,t_impl", [("PINN", "pallas", "kernel"),
                                                ("WAN2", "pallas-fused", "fused")])
def test_train_ipw_2d_kernel_paths_match_jax_pallas(case, j_impl, t_impl):
    """The port's kernel routes against the JAX package's own Pallas routes
    (interpret mode off the TPU, as its tests run them): the same bands."""
    _, u0, v0 = _jax_run(case)
    kw = dict(BASE, **CASES[case])
    jout = j_train(JConfig(jet_impl=j_impl, **kw),
                   init_params=[(jnp.asarray(W), jnp.asarray(b)) for W, b in u0],
                   init_v_params=[(jnp.asarray(W), jnp.asarray(b)) for W, b in v0])
    tout = train_ipw_2d(IPW2DConfig(jet_impl=t_impl, **kw),
                        init_params=params_from_jax(u0), init_v_params=params_from_jax(v0),
                        device="cpu")
    tj, tt = np.asarray(jout["history"]["total"]), tout["history"]["total"]
    np.testing.assert_allclose(tt[0], tj[0], rtol=1e-4)
    np.testing.assert_allclose(tt, tj, rtol=5e-2)
    np.testing.assert_allclose(tout["history"]["pde"][0],
                               np.asarray(jout["history"]["pde"])[0], rtol=1e-3)


PROBE_WAN = dict(nx=1, ny=1, method="WAN", technique="FN", epochs=10, chunk=5, grid_n=12,
                 data_grid_n=8, n_boundary=8, layers=(2, 8, 8, 1), v_layers=(2, 8, 1),
                 v_steps=1)
PROBE_PINN = dict(nx=1, ny=1, method="PINN", technique="FBC", epochs=10, chunk=5, grid_n=12,
                  data_grid_n=8, n_boundary=8, layers=(2, 8, 8, 1))


@pytest.mark.parametrize("cfg", [PROBE_WAN, PROBE_PINN, dict(PROBE_PINN, compute_dtype="hybrid"),
                                 dict(PROBE_PINN, jet_impl="fused")],
                         ids=["wan", "pinn", "pinn_hybrid", "pinn_fused"])
def test_compile_only_returns_the_jax_probe_keys(cfg):
    stats = train_ipw_2d(IPW2DConfig(**cfg), compile_only=True, device="cpu")
    assert isinstance(stats, dict)
    for k in ("argument_size_in_bytes", "temp_size_in_bytes", "total_nonalias_bytes"):
        assert k in stats
    assert set(stats) == set(_jax_probe_keys())
    assert stats["argument_size_in_bytes"] > 0 and stats["total_nonalias_bytes"] == -1


@functools.lru_cache(maxsize=None)
def _jax_probe_keys():
    return tuple(j_train(JConfig(**PROBE_PINN), compile_only=True))
