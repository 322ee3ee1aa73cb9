"""The cosine input map and hard Neumann on the port against the JAX package,
on the CPU at a small size.

* ``CosineInputMap``'s value and analytic jet on numpy points, float64,
  rel <= 1e-10 (the same closed forms).
* The hard-Neumann model (the raw net on cosine features, no output factor,
  as ``train_poisson_nd`` builds it for ``bc_mode='FBC', bc_type='neumann'``)
  with JAX parameters carried across: its jet, and the PINN and DRM
  objectives with the pinned mean that the pure-Neumann problem adds, loss
  and every gradient leaf in float32, rel <= 1e-5 (the fused kernels' bar,
  ``ROADMAP.md``).
* The normal derivative vanishes on every face for any parameters.
* The kernel routes refuse the map as JAX's ``impl='pallas'`` does, and
  ``train_poisson_nd`` refuses hard Neumann on ``kernel`` (PINN) and
  ``fused``.

Cost: about 15 s on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.losses import zoo as jzoo
from nnpde_tpu.models import CosineInputMap as JMap
from nnpde_tpu.models import NetSpec as JNetSpec
from nnpde_tpu.models import SolutionModel as JModel
from nnpde_tpu.pde import poisson as jphys
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.losses import zoo
from nnpde_tpu_torch.models import CosineInputMap, NetSpec, SolutionModel
from nnpde_tpu_torch.pde import poisson as phys
from nnpde_tpu_torch.problems import PoissonConfig, train_poisson_nd

L = 2.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("lo,hi", [(0.0, 2.0), (-1.0, 0.5)])
def test_cosine_map_value_and_jet_match_jax(lo, hi):
    rng = np.random.default_rng(0)
    X = rng.uniform(lo, hi, (64, 3))
    with jax.enable_x64(True):
        jm = JMap(3, lo, hi)
        want = [jm.value(jnp.asarray(X)), *jm.jet(jnp.asarray(X))]
        want = [np.asarray(t) for t in want]
    tm = CosineInputMap(3, lo, hi)
    got = [tm.value(torch.as_tensor(X)), *tm.jet(torch.as_tensor(X))]
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == X.shape
        assert _rel(g.numpy(), w) <= 1e-10
    with pytest.raises(ValueError, match="hi > lo"):
        CosineInputMap(2, 1.0, 1.0)


def _models(layers):
    d = layers[0]
    jmodel = JModel(JNetSpec(layers, activation="sin"), input_map=JMap(d, 0.0, L))
    tmodel = SolutionModel(NetSpec(layers, activation="sin"),
                           input_map=CosineInputMap(d, 0.0, L))
    jp = jmodel.init(jax.random.PRNGKey(5))
    pn = [(np.array(W), np.array(b)) for W, b in jp]
    return jmodel, tmodel, pn


@pytest.mark.parametrize("method", ["PINN", "DRM"])
def test_hard_neumann_objective_matches_jax(method):
    """The objective ``train_poisson_nd`` builds for hard Neumann (pde term
    plus the pinned mean, weight 1; no boundary term) at carried-across
    parameters and points: loss and every gradient leaf rel <= 1e-5."""
    layers = (3, 24, 24, 1)
    jmodel, tmodel, pn = _models(layers)
    X = np.random.default_rng(1).uniform(0.0, L, (256, 3)).astype(np.float32)
    ks = (1, 1, 1)

    def j_loss(p):
        Xj = jnp.asarray(X)
        f = jphys.rhs_f_for_u_cos(Xj, L, ks)
        if method == "PINN":
            jet = jmodel.fields(p, Xj)
            pde, u = jzoo.pinn_poisson(jet.lap, f), jet.value
        else:
            u, g = jmodel.value_and_grad(p, Xj)
            pde = jzoo.drm_poisson_energy(u, g, f)
        return pde + jnp.mean(u) ** 2

    jl, jg = jax.value_and_grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, pn))
    tp = [(W.requires_grad_(True), b.requires_grad_(True)) for W, b in params_from_jax(pn)]
    Xt = torch.as_tensor(X)
    f = phys.rhs_f_for_u_cos(Xt, L, ks)
    if method == "PINN":
        jet = tmodel.fields(tp, Xt)
        pde, u = zoo.pinn_poisson(jet.lap, f), jet.value
    else:
        u, g = tmodel.value_and_grad(tp, Xt)
        pde = zoo.drm_poisson_energy(u, g, f)
    tl = pde + torch.mean(u) ** 2
    tg = torch.autograd.grad(tl, [t for pair in tp for t in pair])
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for a, b in zip(tg, [t for pair in jg for t in pair]):
        assert _rel(a.numpy(), np.asarray(b)) <= 1e-5


def test_hard_neumann_jet_matches_jax_and_is_exact_on_faces():
    """The model's jet through the map against JAX's (float32, rel <= 1e-5
    per field) and against the autodiff oracle; du/dn is zero on every face
    for any parameters."""
    layers = (3, 24, 24, 1)
    jmodel, tmodel, pn = _models(layers)
    X = np.random.default_rng(2).uniform(0.0, L, (128, 3)).astype(np.float32)
    jj = jmodel.fields(jax.tree_util.tree_map(jnp.asarray, pn), jnp.asarray(X))
    tp = params_from_jax(pn)
    tj = tmodel.fields(tp, torch.as_tensor(X))
    for a, b in zip(tj, jj):
        assert _rel(a.numpy(), np.asarray(b)) <= 1e-5
    oracle = tmodel.fields_generic(tp, torch.as_tensor(X))
    for a, b in zip(tj, oracle):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5
    for axis, face in ((0, 0.0), (1, L), (2, 0.0), (2, L)):
        Xf = torch.as_tensor(X).clone()
        Xf[:, axis] = face
        g = tmodel.fields(tp, Xf).grad
        assert float(g[:, axis].abs().max()) <= 1e-6 * float(g.abs().max())


def test_kernel_routes_refuse_the_map():
    """``impl='kernel'`` raises on an input map (JAX: ``impl='pallas'``), and
    the entry point refuses hard Neumann on the routes whose kernels would
    drop the map; the torch route runs it with the pinned mean."""
    tmodel = SolutionModel(NetSpec((2, 8, 1), activation="sin"),
                           input_map=CosineInputMap(2, 0.0, L))
    tp = tmodel.init(0)
    with pytest.raises(ValueError, match="input_map"):
        tmodel.fields(tp, torch.rand(8, 2), impl="kernel")
    with pytest.raises(ValueError, match="input_map"):
        tmodel.value_and_grad(tp, torch.rand(8, 2), impl="kernel")
    with pytest.raises(ValueError, match="input_map dim"):
        SolutionModel(NetSpec((2, 8, 1)), input_map=CosineInputMap(3))
    base = dict(dim=2, bc_mode="FBC", bc_type="neumann", solution="cos", width=8, depth=3,
                n_interior=64, n_eval=64, epochs=20, chunk=10)
    for kw in (dict(jet_impl="kernel"), dict(jet_impl="fused"),
               dict(jet_impl="fused", method="DRM"), dict(jet_impl="fused", method="WAN")):
        with pytest.raises(ValueError, match="input_map"):
            train_poisson_nd(PoissonConfig(**base, **kw), device="cpu")
    with pytest.raises(ValueError, match="cos"):
        train_poisson_nd(PoissonConfig(**dict(base, solution="sin")), device="cpu")
    out = train_poisson_nd(PoissonConfig(**base, jet_impl="torch", sampler="sobol",
                                         resample=True, lr_schedule="cosine"), device="cpu")
    assert out["model"].input_map is not None and out["model"].factor is None
    assert np.all(np.isfinite(out["history"]["total"]))
    # the DRM and WAN methods run their torch path under 'kernel', map included
    drm = train_poisson_nd(PoissonConfig(**base, jet_impl="kernel", method="DRM"), device="cpu")
    assert np.all(np.isfinite(drm["history"]["total"]))


@pytest.mark.parametrize("kw", [dict(compute_dtype="bfloat16"), dict(compute_dtype="hybrid"),
                                dict(method="WAN", compute_dtype="hybrid", critic_width=8,
                                     critic_steps=2)])
def test_hard_neumann_runs_in_reduced_precision(kw):
    """Hard Neumann on the torch route in the reduced-precision modes (the
    map's features in bf16 in the bulk): finite, with the pinned mean."""
    cfg = dict(dim=2, bc_mode="FBC", bc_type="neumann", solution="cos", width=8, depth=3,
               n_interior=64, n_eval=64, epochs=10, chunk=10, jet_impl="torch")
    out = train_poisson_nd(PoissonConfig(**dict(cfg, **kw)), device="cpu")
    assert out["model"].input_map is not None
    assert out["history"]["total"].shape == (10,)
    assert np.all(np.isfinite(out["history"]["total"]))
