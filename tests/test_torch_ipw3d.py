"""The 3D infinite-well slice of the port against the JAX package, on the CPU
at a small size (the port's versions of ``tests/test_ipw3d.py``).

* psi_3 solves the Helmholtz equation ``-lap psi = 2E psi`` (the JAX test's
  bar, rtol 2e-4, atol 2e-4).
* The PINN and DRM objectives of ``train_ipw_3d`` on every ``jet_impl``
  (the kernel wrappers take their plain versions on CPU tensors) at JAX
  parameters carried across and the same points: the total and every
  gradient leaf in float32 within rel 1e-5 of the JAX objective on
  ``jet_impl='xla'`` (the fused kernels' bar, ``ROADMAP.md``).
* ``train_ipw_3d`` on ``kernel`` and ``fused`` starts as ``torch`` does:
  the first total within rtol 1e-4, every epoch within 5e-2 (the band of
  the JAX package's own fused-vs-XLA test); the FN nodal-plane factor is
  zero on the faces (<= 1e-6).
* Each option that raises.

Cost: about 10 s on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.losses import zoo as jzoo
from nnpde_tpu.models import NetSpec as JNetSpec
from nnpde_tpu.models import SolutionModel as JModel
from nnpde_tpu.models import factor_for_technique as j_factor
from nnpde_tpu.pde import ipw as jphys
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
from nnpde_tpu_torch.ops import calculus
from nnpde_tpu_torch.pde import ipw as phys
from nnpde_tpu_torch.problems import IPW3DConfig, train_ipw_3d
from nnpde_tpu_torch.problems.ipw3d import _objective

L = 2.0
BASE = dict(nx=2, ny=1, nz=1, epochs=6, n_interior=512, chunk=3, layers=(3, 16, 16, 1),
            data_grid_n=8, n_eval=512, seed=0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_psi3d_solves_helmholtz():
    """-lap psi = 2E psi for the analytic 3D product state."""
    X = torch.rand((64, 3), generator=torch.Generator().manual_seed(0)) * L
    u, _, lap = calculus.batched_value_grad_lap(
        lambda x: phys.psi_3d(2, 1, 1, x[0], x[1], x[2], L))(X)
    k2 = 2.0 * phys.energy_3d(2, 1, 1, L)
    np.testing.assert_allclose((-lap).numpy(), (k2 * u).numpy(), rtol=2e-4, atol=2e-4)


def _fn_nodes(nq):
    return [phys.nodes(n, L) for n in nq]


@pytest.mark.parametrize("jet_impl", ["torch", "kernel", "fused"])
@pytest.mark.parametrize("method", ["PINN", "DRM"])
def test_objective_matches_jax(method, jet_impl):
    """The objective ``train_ipw_3d`` trains, at carried-across parameters
    and the same points and data lattice, against the JAX package's own
    (its ``loss_fn`` on ``jet_impl='xla'``, written out from its parts)."""
    nq = (BASE["nx"], BASE["ny"], BASE["nz"])
    layers = BASE["layers"]
    rng = np.random.default_rng(3)
    X = rng.uniform(0.0, L, (300, 3)).astype(np.float32)
    Xd = rng.uniform(0.0, L / 2, (64, 3)).astype(np.float32)
    k2 = 2.0 * phys.energy_3d(*nq, L)
    w = {"pde": 10.0 if method == "PINN" else 0.0, "drm": 100.0 if method == "DRM" else 0.0,
         "data": 1e4}

    jmodel = JModel(JNetSpec(layers, activation="sin"),
                    j_factor("FN", dim=3, kind="box", L=L, nodes_per_dim=_fn_nodes(nq)))
    jp = jmodel.init(jax.random.PRNGKey(4))
    ju_d = jphys.psi_3d(*nq, *(jnp.asarray(Xd[:, i]) for i in range(3)), L)

    def j_loss(p):
        Xj = jnp.asarray(X)
        data = jzoo.data_mse(jmodel.apply_batch(p, jnp.asarray(Xd)), ju_d)
        if method == "PINN":
            jet = jmodel.fields(p, Xj)
            return w["pde"] * jzoo.pinn_helmholtz(jet.value, jet.lap, k2) + w["data"] * data
        u, g = jmodel.value_and_grad(p, Xj)
        return (w["drm"] * jzoo.drm_rayleigh_unscaled(u, g, den_eps=1e-8)
                + w["data"] * data)

    jl, jg = jax.value_and_grad(j_loss)(jp)
    pn = [(np.array(W), np.array(b)) for W, b in jp]

    cfg = IPW3DConfig(**dict(BASE, method=method, jet_impl=jet_impl))
    model = SolutionModel(NetSpec(layers, activation="sin"),
                          factor_for_technique("FN", dim=3, kind="box", L=L,
                                               nodes_per_dim=_fn_nodes(nq)))
    Xd_t = torch.as_tensor(Xd)
    u_d = phys.psi_3d(*nq, Xd_t[:, 0], Xd_t[:, 1], Xd_t[:, 2], L)
    loss_at, lag_at = _objective(cfg, model, w, k2, Xd_t, u_d)
    tp = [(W.requires_grad_(True), b.requires_grad_(True)) for W, b in params_from_jax(pn)]
    if lag_at is not None:
        (tl, metrics), grads = lag_at(tp, torch.as_tensor(X))
        tg = [t for pair in grads for t in pair]
    else:
        tl, metrics = loss_at(tp, torch.as_tensor(X))
        tg = torch.autograd.grad(tl, [t for pair in tp for t in pair])
    assert set(metrics) == {"pde", "drm", "data"}
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for a, b in zip(tg, [t for pair in jg for t in pair]):
        assert _rel(a.detach().numpy(), np.asarray(b)) <= 1e-5


@pytest.mark.parametrize("method", ["PINN", "DRM"])
def test_routes_start_as_torch_does(method):
    runs = {impl: train_ipw_3d(IPW3DConfig(**dict(BASE, method=method, jet_impl=impl)),
                               device="cpu")
            for impl in ("torch", "kernel", "fused")}
    ref = runs["torch"]["history"]["total"]
    for impl, out in runs.items():
        h = out["history"]["total"]
        assert h.shape == (BASE["epochs"],) and np.all(np.isfinite(h))
        np.testing.assert_allclose(h[0], ref[0], rtol=1e-4)
        np.testing.assert_allclose(h, ref, rtol=5e-2)
        assert np.isfinite(out["rel_l2"]) and out["L2_error"] == out["result"].best_metric
        assert set(out) == {"config", "model", "result", "history", "L2_error", "rel_l2",
                            "min_epoch", "E_exact", "weights"}
        assert out["E_exact"] == phys.energy_3d(2, 1, 1, L)
    # the FN nodal-plane factor hard-enforces the boundary: zero at faces
    m = runs["fused"]["model"]
    Xb = torch.tensor([[0.0, 1.0, 1.0], [2.0, 0.5, 0.3], [1.0, 2.0, 0.7], [0.4, 0.9, 0.0]])
    u_b = m.apply_batch(runs["fused"]["result"].best_params, Xb)
    assert float(u_b.abs().max()) <= 1e-6


@pytest.mark.parametrize("kw,match", [
    (dict(jet_impl="xla"), "'torch'"),
    (dict(jet_impl="pallas"), "'kernel'"),
    (dict(jet_impl="pallas-fused"), "'fused'"),
    (dict(jet_impl="kernel:streams"), "jet_impl"),
    (dict(method="WAN"), "method"),
    (dict(technique="OG"), "technique"),
    (dict(sampler="halton"), "sampler"),
])
def test_options_that_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        train_ipw_3d(IPW3DConfig(**dict(BASE, **kw)), device="cpu")


def test_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_ipw_3d(IPW3DConfig(**BASE))
