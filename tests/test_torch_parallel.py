"""Data parallelism of the port (``nnpde_tpu_torch/parallel/mesh.py``) on 2
and 4 gloo ranks on the CPU, against the JAX package's ``shard_map`` steps
on ``make_mesh(2)`` / ``make_mesh(4)`` of the virtual CPU mesh, with the
same transferred parameters and points (a (2, 16, 16, 1) sin net with the
box-FBC factor, 256 points; one shard of 128 or 64 points per rank).

The ranks are separate processes (``tests/torch_dist_workers.py``, which
imports no JAX), meeting through a file in ``tmp_path``; every process
group has a 60 s timeout and every rank a 120 s limit, so a hung collective
fails the test.  The ranks run while the JAX references compile.

Tolerances, and why:

* every step against JAX's ``shard_map`` step: rel 1e-5 on the value, every
  gradient leaf and the reduced sums, for the port in float32 and in
  float64 (JAX runs float32, the interpret-mode kernels' bar of
  ``tests/test_torch_fused_*.py``); ``psum_mean_step`` (no kernel) also in
  float64 on both sides at 1e-12;
* the ranks in float64 against the port's one-process call on the whole
  batch at 1e-12 (only the summation order differs), in float32 at 1e-5;
* every rank's results bitwise equal to rank 0's (one all-reduce, the same
  bits everywhere), and the parameters after 20 Adam steps of the fused
  step and 100 of ``psum_mean_step`` bitwise equal across ranks;
* 100 sharded Adam steps end within rtol 1e-3 of JAX's single-device run
  (the bar of ``tests/test_parallel.py``), below 0.6 x 3;
* a world of one (no process group) equals the plain call bitwise;
* on 4 ranks: DP x TP on a 2 x 2 mesh, the two-level mean of
  ``dp_dcn_step`` and the fused step over the product axis against the
  port's one-process float64 autograd at 1e-12;
* on 4 ranks, DP x TP through the jet (``tp_mean_step`` over
  ``tp_fields``, the forward-Laplacian jet through the column / row
  pairs): the configuration of the JAX package's dp x tp test
  (``tests/test_parallel.py``: box-FBC, (2, 32, 32, 1) sin, its own
  initial weights and 1024 points, the batch over "data" and the layers
  over "model") against JAX's single-device numbers at that test's
  tolerances: the loss rtol 1e-5, each rank's gradient parts and its
  parts after one Adam step (lr 1e-3) against the matching slices at rtol
  5e-5, atol 1e-6 (the port in float32, as JAX); in float64 against the
  port's one process at 1e-12;
* on 4 ranks, a net of two column / row pairs ((2, 16 x 4, 1) sin, float64):
  the PINN loss through the TP jet and a data fit through
  ``tp_mlp_apply``, each rank's gradient parts against the one process's
  slices at 1e-12 (the cotangent of a column layer's whole input is
  all-reduced in its backward);
* on a world of one (tp = 1) the TP jet is ``mlp_fwdlap`` and
  ``tp_fields`` is ``SolutionModel.fields`` bit for bit (with the factor,
  and with the hard-Neumann input map), and ``tp_mean_step`` is
  ``psum_mean_step``.

Cost: about 25 s alone on one worker (the ranks overlap the JAX compiles).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnpde_tpu.kernels import (drm_coefficients, linear_functional_coefficients,
                               quotient_coefficients, residual_coefficients)
from nnpde_tpu.losses import pinn_poisson
from nnpde_tpu.models import NetSpec, SolutionModel, factor_for_technique
from nnpde_tpu.parallel import (fused_rayleigh_step, fused_residual_step, fused_wan_u_step,
                                fused_wan_v_step, make_mesh, psum_mean_step, replicate,
                                shard_batch)
from nnpde_tpu.pde import poisson as jphys

import nnpde_tpu_torch.kernels as tk
import nnpde_tpu_torch.parallel as tpar
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.models import NetSpec as TNetSpec
from nnpde_tpu_torch.models import SolutionModel as TSolutionModel
from nnpde_tpu_torch.models import factor_for_technique as t_factor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LAYERS = (2, 16, 16, 1)
N, L = 256, 2.0
TRAIN_STEPS = 100
QKW = dict(bwd_tile=128, interpret=True, dot_dtype="float32")
FKW = dict(bwd_tile=128, interpret=True)
RANK_LIMIT_S = 120


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs():
    """Parameters and full batches, made by JAX as its own tests make them."""
    model = SolutionModel(NetSpec(LAYERS, "sin"),
                          factor_for_technique("FBC", dim=2, kind="box", L=L))
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    X = jnp.asarray(rng.uniform(0.0, L, (N, 2)), jnp.float32)
    f = jphys.rhs_f_for_u_sin(X, L, [1, 1])
    B = model.factor.jet(X)
    phi = jnp.asarray(rng.normal(size=N), jnp.float32)
    gphi = jnp.asarray(rng.normal(size=(N, 2)), jnp.float32)
    u_dat = jnp.asarray(rng.normal(size=N), jnp.float32)
    gu = jnp.asarray(rng.normal(size=(N, 2)), jnp.float32)
    V = 0.3 * jnp.sum(X ** 2, axis=1)
    z = {
        "layers": np.asarray(LAYERS), "X": np.asarray(X), "E0": np.asarray(2.1),
        "train_steps": np.asarray(TRAIN_STEPS),
        "y": np.asarray(jnp.sin(X[:, 0]) * jnp.cos(X[:, 1])),
        "phi": np.asarray(phi),
        "coef_pinn": np.asarray(residual_coefficients(B, a0=-1.0, rhs=-f)),
        "coef_drm": np.asarray(drm_coefficients(B, f)),
        "coef_ray": np.asarray(quotient_coefficients(B, V=0.5 * jnp.sum(X ** 2, axis=1))),
        "base": np.asarray(linear_functional_coefficients(
            B, c0=V * phi, b0=0.5 * gphi, e1=B.value, e2=B.value * phi)),
        "coef_v": np.asarray(linear_functional_coefficients(
            B, c0=(V - 2.1) * u_dat, b0=0.5 * gu, e1=B.value)),
    }
    for i, (W, b) in enumerate(params):
        z[f"pW{i}"], z[f"pb{i}"] = np.asarray(W), np.asarray(b)
    z["dp_layers"] = np.asarray(DEEP_LAYERS)
    for i, (W, b) in enumerate(_np_net(rng, DEEP_LAYERS)):
        z[f"dpW{i}"], z[f"dpb{i}"] = W, b
    tp_model, tp_params, tp_X = _tp_inputs()
    z["tp_layers"], z["tpX"] = np.asarray(TP_LAYERS), np.asarray(tp_X)
    for i, (W, b) in enumerate(tp_params):
        z[f"tpW{i}"], z[f"tpb{i}"] = np.asarray(W), np.asarray(b)
    return model, params, z


TP_LAYERS = (2, 32, 32, 1)
DEEP_LAYERS = (2, 16, 16, 16, 16, 1)          # two column / row pairs, then the output


def _np_net(rng, layers):
    return [(rng.uniform(-0.5, 0.5, (i, o)), rng.uniform(-0.3, 0.3, (o,)))
            for i, o in zip(layers[:-1], layers[1:])]


def _tp_inputs():
    """The JAX package's dp x tp test setup (``tests/test_parallel.py``)."""
    model = SolutionModel(NetSpec(TP_LAYERS, "sin"),
                          factor_for_technique("FBC", dim=2, kind="box", L=L))
    params = model.init(jax.random.PRNGKey(0))
    X = jax.random.uniform(jax.random.PRNGKey(1), (1024, 2), maxval=L)
    return model, params, X


def _jax_tp_reference():
    """JAX's single-device loss, gradients and parameters after one Adam
    step (lr 1e-3) of the PINN loss of its dp x tp test."""
    model, params, X = _tp_inputs()
    f = jphys.rhs_f_for_u_sin(X, L, [1, 1])

    def loss_fn(p):
        return pinn_poisson(model.fields(p, X).lap, f)

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    opt = optax.adam(1e-3)
    up, _ = opt.update(g, opt.init(params), params)
    p1 = optax.apply_updates(params, up)
    to_np = lambda t: [(np.asarray(W), np.asarray(b)) for W, b in t]
    return float(loss), to_np(g), to_np(p1)


def _launch(world, workdir):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dist_workers.py"),
                              str(r), str(world), str(workdir), "60"], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _join(procs):
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_LIMIT_S)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(log[-3000:] for log in logs)


def _jax_refs(model, params, z, world):
    """JAX's shard_map steps on make_mesh(world), float32 (and psum_mean_step
    in float64 too)."""
    mesh = make_mesh(world)
    X = jnp.asarray(z["X"])

    def sh(k):
        return shard_batch(jnp.asarray(z[k]), mesh)

    ps = replicate(params, mesh)

    def loss_x(p, X_in):
        return pinn_poisson(model.fields(p, X_in).lap, jphys.rhs_f_for_u_sin(X_in, L, [1, 1]))

    refs = {"psum": jax.jit(psum_mean_step(loss_x, mesh))(ps, shard_batch(X, mesh))}
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        X64 = jnp.asarray(z["X"], jnp.float64)
        refs["psum64"] = jax.tree_util.tree_map(
            np.asarray, jax.jit(psum_mean_step(loss_x, mesh))(replicate(p64, mesh),
                                                              shard_batch(X64, mesh)))
    for kind in ("pinn", "drm"):
        refs[f"fused_{kind}"] = jax.jit(fused_residual_step(mesh, "sin", kind=kind, **FKW))(
            ps, sh("X"), sh(f"coef_{kind}"))
    refs["rayleigh"] = jax.jit(fused_rayleigh_step(mesh, "sin", weight=3.0, den_eps=1e-8,
                                                   **QKW))(ps, sh("X"), sh("coef_ray"))
    refs["wan_u"] = jax.jit(fused_wan_u_step(mesh, "sin", vol=4.0, w_pde=10.0, w_norm=100.0,
                                             **QKW))(ps, jnp.asarray(2.1), sh("X"), sh("base"),
                                                     sh("phi"))
    refs["wan_v"] = jax.jit(fused_wan_v_step(mesh, "sin", **QKW))(ps, sh("X"), sh("coef_v"))
    return refs


def _jax_training(model, params, X):
    """JAX's single-device Adam run of tests/test_parallel.py: final loss."""
    opt = optax.adam(2e-3)
    f = jphys.rhs_f_for_u_sin(X, L, [1, 1])

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(lambda q: pinn_poisson(model.fields(q, X).lap, f))(p)
        up, s = opt.update(g, s, p)
        return optax.apply_updates(p, up), s, loss

    state = opt.init(params)
    for _ in range(TRAIN_STEPS):
        params, state, loss = step(params, state)
    return float(loss)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    model, params, z = _inputs()
    procs, dirs = {}, {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"world{world}")
        np.savez(d / "inputs.npz", **z)
        dirs[world] = d
        procs[world] = _launch(world, d)
    try:
        refs = {w: _jax_refs(model, params, z, w) for w in (2, 4)}
        train_loss = _jax_training(model, params, jnp.asarray(z["X"]))
        tp_ref = _jax_tp_reference()
    finally:
        for world in (2, 4):
            _join(procs[world])
    ranks = {w: [dict(np.load(dirs[w] / f"rank{r}.npz")) for r in range(w)] for w in (2, 4)}
    return {"model": model, "params": params, "z": z, "refs": refs, "ranks": ranks,
            "train_loss": train_loss, "tp_ref": tp_ref}


def _tree(out, name):
    n = len(LAYERS) - 1
    return [(out[f"{name}/gW{i}"], out[f"{name}/gb{i}"]) for i in range(n)]


def _grads_rel(a, b):
    return max(_rel(x, y) for pa, pb in zip(a, b) for x, y in zip(pa, pb))


def _ref_parts(name, ref):
    """(value, grads, aux) of a JAX step's output."""
    if name in ("psum", "psum64"):
        return ref[0], ref[1], {}
    if name == "wan_u":
        val, aux, grads, dE = ref
        return val, grads, dict(aux, dE=dE)
    val, aux, grads = ref
    return val, grads, aux


def _one_process(z, dtype):
    """The port's one-process calls on the whole batch."""
    t = {k: torch.as_tensor(z[k], dtype=dtype) for k in
         ("X", "coef_pinn", "coef_drm", "coef_ray", "base", "phi", "coef_v")}
    P = params_from_jax([(z[f"pW{i}"], z[f"pb{i}"]) for i in range(len(LAYERS) - 1)],
                        dtype=dtype)
    mesh = tpar.make_mesh(device="cpu")                    # a world of one
    out = {}
    model = TSolutionModel(TNetSpec(LAYERS, "sin"), t_factor("FBC", dim=2, kind="box", L=L))
    from nnpde_tpu_torch.losses import pinn_poisson as tpinn
    from nnpde_tpu_torch.pde import poisson as tphys

    def loss_fn(p, X):
        return tpinn(model.fields(p, X).lap, tphys.rhs_f_for_u_sin(X, L, [1, 1]))

    out["psum"] = tpar.psum_mean_step(loss_fn, mesh)(P, t["X"])
    for kind in ("pinn", "drm"):
        loss, sums, g = tpar.fused_residual_step(mesh, "sin", kind=kind)(P, t["X"],
                                                                         t[f"coef_{kind}"])
        out[f"fused_{kind}"] = (loss, g, sums)
    loss, aux, g = tpar.fused_rayleigh_step(mesh, "sin", weight=3.0, den_eps=1e-8)(
        P, t["X"], t["coef_ray"])
    out["rayleigh"] = (loss, g, aux)
    loss, aux, g, dE = tpar.fused_wan_u_step(mesh, "sin", vol=4.0, w_pde=10.0, w_norm=100.0)(
        P, torch.tensor(2.1, dtype=dtype), t["X"], t["base"], t["phi"])
    out["wan_u"] = (loss, g, dict(aux, dE=dE))
    loss, aux, g = tpar.fused_wan_v_step(mesh, "sin")(P, t["X"], t["coef_v"])
    out["wan_v"] = (loss, g, aux)
    return out


STEPS = ("psum", "fused_pinn", "fused_drm", "rayleigh", "wan_u", "wan_v")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", STEPS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_step_matches_jax_shard_map(runs, world, name, dtype):
    """Each rank's value, gradients and reduced sums within rel 1e-5 of
    JAX's shard_map step on the same number of devices."""
    val, grads, aux = _ref_parts(name, runs["refs"][world][name])
    for out in runs["ranks"][world]:
        assert _rel(out[f"{dtype}/{name}/value"], val) <= 1e-5
        assert _grads_rel(_tree(out, f"{dtype}/{name}"), grads) <= 1e-5
        for k, v in aux.items():
            assert _rel(out[f"{dtype}/{name}/aux/{k}"], v) <= 1e-5, k


@pytest.mark.parametrize("world", [2, 4])
def test_psum_step_float64_matches_jax(runs, world):
    """psum_mean_step (the recurrence under autograd, no kernel) in float64
    on both sides: within 1e-12."""
    loss, grads = runs["refs"][world]["psum64"]
    for out in runs["ranks"][world]:
        assert _rel(out["float64/psum/value"], loss) <= 1e-12
        assert _grads_rel(_tree(out, "float64/psum"), grads) <= 1e-12


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
def test_ranks_match_one_process(runs, world, dtype, tol):
    """The ranks' global results against the port's one-process call on the
    whole batch: 1e-12 in float64 (only the order of the sums differs),
    1e-5 in float32."""
    one = _one_process(runs["z"], getattr(torch, dtype))
    for name in STEPS:
        val, grads, aux = one[name] if name != "psum" else (*one[name], {})
        grads = [(W.numpy(), b.numpy()) for W, b in grads]
        for out in runs["ranks"][world]:
            assert _rel(out[f"{dtype}/{name}/value"], val.numpy()) <= tol, name
            assert _grads_rel(_tree(out, f"{dtype}/{name}"), grads) <= tol, name
            for k, v in aux.items():
                assert _rel(out[f"{dtype}/{name}/aux/{k}"], torch.as_tensor(v).numpy()) <= tol


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_agree_bitwise(runs, world):
    """One all-reduce gives every rank the same bits: every result and the
    parameters after 20 fused and 100 psum Adam steps equal rank 0's."""
    first = runs["ranks"][world][0]
    for out in runs["ranks"][world][1:]:
        keys = [k for k in first if not k.startswith(("rank", "tp/", "dcn"))]
        assert keys and all(k in out for k in keys)
        for k in keys:
            np.testing.assert_array_equal(out[k], first[k], err_msg=k)
    assert any(k.startswith("train_fused/leaf") for k in first)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_training_converges_as_jax(runs, world):
    """100 sharded Adam steps (lr 2e-3) end where JAX's single-device run
    ends (rtol 1e-3) and below 0.6 x 3, the bar of tests/test_parallel.py."""
    losses = runs["ranks"][world][0]["train_psum/losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < 0.6 * 3.0
    np.testing.assert_allclose(losses[-1], runs["train_loss"], rtol=1e-3)


def test_make_fused_rayleigh_axis_group_equals_one_process(runs):
    """make_fused_rayleigh(..., axis=<the world's group>) on 2 gloo ranks:
    the objective and its gradient equal the one-process objective on the
    whole batch (1e-12 in float64, 1e-5 in float32)."""
    z = runs["z"]
    for dtype, tol in (("float32", 1e-5), ("float64", 1e-12)):
        dt = getattr(torch, dtype)
        P = params_from_jax([(z[f"pW{i}"], z[f"pb{i}"]) for i in range(len(LAYERS) - 1)],
                            dtype=dt)
        leaves = [t.requires_grad_(True) for pair in P for t in pair]
        ray = tk.make_fused_rayleigh("sin", weight=3.0, den_eps=1e-8)
        val, aux = ray(P, torch.as_tensor(z["X"], dtype=dt), torch.as_tensor(z["coef_ray"],
                                                                               dtype=dt))
        g = torch.autograd.grad(val, leaves)
        for out in runs["ranks"][2]:
            assert _rel(out[f"{dtype}/rayleigh_axis/value"], val.detach().numpy()) <= tol
            assert _grads_rel(_tree(out, f"{dtype}/rayleigh_axis"),
                              [(g[i].numpy(), g[i + 1].numpy())
                               for i in range(0, len(g), 2)]) <= tol
            assert _rel(out[f"{dtype}/rayleigh_axis/aux/rayleigh"],
                        aux["rayleigh"].numpy()) <= tol


def test_four_rank_meshes_match_one_process(runs):
    """On 4 ranks: DP x TP on a 2 x 2 (data, model) mesh (a data-fit loss on
    the value: each rank's parts' gradients are the matching slices of the
    one-process gradients), dp_dcn_step's two-level mean and the fused
    step over the (dcn, data) product axis, all within 1e-12 of the
    one-process float64 autograd."""
    z = runs["z"]
    P = params_from_jax([(z[f"pW{i}"], z[f"pb{i}"]) for i in range(len(LAYERS) - 1)],
                        dtype=torch.float64)
    leaves = [t.requires_grad_(True) for pair in P for t in pair]
    X = torch.as_tensor(z["X"], dtype=torch.float64)
    from nnpde_tpu_torch.models import mlp_apply_batch

    u = mlp_apply_batch(P, X, "sin")
    loss = torch.mean((u - torch.as_tensor(z["y"], dtype=torch.float64)) ** 2)
    g = torch.autograd.grad(loss, leaves)
    for out in runs["ranks"][4]:
        assert _rel(out["tp/value"], loss.detach().numpy()) <= 1e-12
        j = int(out["tp/coords"][1])                      # this rank's model index
        for i in range(len(LAYERS) - 1):
            gW, gb = g[2 * i].numpy(), g[2 * i + 1].numpy()
            kind = str(out[f"tp/kind{i}"])
            if kind == "col":
                m = gW.shape[1] // 2
                gW, gb = gW[:, j * m:(j + 1) * m], gb[j * m:(j + 1) * m]
            elif kind == "row":
                m = gW.shape[0] // 2
                gW = gW[j * m:(j + 1) * m]
            assert _rel(out[f"tp/gW{i}"], gW) <= 1e-12 and _rel(out[f"tp/gb{i}"], gb) <= 1e-12
    one = _one_process(z, torch.float64)
    for name, ref in (("dcn", "psum"), ("dcn_fused", "fused_pinn")):
        val, grads = one[ref][0], one[ref][1]
        grads = [(W.numpy(), b.numpy()) for W, b in grads]
        for out in runs["ranks"][4]:
            assert _rel(out[f"{name}/value"], val.numpy()) <= 1e-12
            assert _grads_rel(_tree(out, name), grads) <= 1e-12


def _tp_slice(a, kind, j, n=2):
    """Rank ``j``'s part of a whole (W or b) leaf under ``kind``."""
    if kind == "col":
        m = a.shape[-1] // n
        return a[..., j * m:(j + 1) * m]
    if kind == "row" and a.ndim == 2:
        m = a.shape[0] // n
        return a[j * m:(j + 1) * m]
    return a


def _tp_one_process_float64(z):
    """The port's one process on the whole batch in float64: the loss, its
    gradients and the parameters after one Adam step (lr 1e-3)."""
    from nnpde_tpu_torch.losses import pinn_poisson as tpinn
    from nnpde_tpu_torch.pde import poisson as tphys

    model = TSolutionModel(TNetSpec(TP_LAYERS, "sin"), t_factor("FBC", dim=2, kind="box", L=L))
    P = params_from_jax([(z[f"tpW{i}"], z[f"tpb{i}"]) for i in range(len(TP_LAYERS) - 1)],
                        dtype=torch.float64)
    X = torch.as_tensor(z["tpX"], dtype=torch.float64)
    loss, g = tpar.psum_mean_step(
        lambda p, X_: tpinn(model.fields(p, X_).lap, tphys.rhs_f_for_u_sin(X_, L, [1, 1])),
        tpar.make_mesh(device="cpu"))(P, X)
    leaves = [t.clone() for pair in P for t in pair]
    opt = torch.optim.Adam(leaves, lr=1e-3)
    for t, gr in zip(leaves, [t for pair in g for t in pair]):
        t.grad = gr
    opt.step()
    p1 = [(leaves[2 * i].detach().numpy(), leaves[2 * i + 1].detach().numpy())
          for i in range(len(P))]
    return float(loss), [(W.numpy(), b.numpy()) for W, b in g], p1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dp_tp_jet_matches_jax_single_device(runs, dtype):
    """DP x TP through the jet on the 2 x 2 (data, model) mesh: the PINN
    loss, each rank's gradient parts and its parts after one Adam step
    against JAX's single-device run at its dp x tp test's tolerances
    (float32), or against the port's one process at 1e-12 (float64)."""
    if dtype == "float32":
        loss, grads, p1 = runs["tp_ref"]
        rtol, atol = dict(loss=1e-5, tree=5e-5), 1e-6
    else:
        loss, grads, p1 = _tp_one_process_float64(runs["z"])
        rtol, atol = dict(loss=1e-12, tree=1e-12), 0.0
    tag = f"tp/jet_{dtype}"
    for out in runs["ranks"][4]:
        j = int(out["tp/coords"][1])                      # this rank's model index
        np.testing.assert_allclose(float(out[f"{tag}/value"]), loss, rtol=rtol["loss"])
        for i in range(len(TP_LAYERS) - 1):
            kind = str(out[f"{tag}/kind{i}"])
            for got, want in ((out[f"{tag}/gW{i}"], grads[i][0]),
                              (out[f"{tag}/gb{i}"], grads[i][1]),
                              (out[f"{tag}/W{i}"], p1[i][0]), (out[f"{tag}/b{i}"], p1[i][1])):
                want = _tp_slice(np.asarray(want), kind, j)
                assert got.shape == want.shape
                np.testing.assert_allclose(got, want, rtol=rtol["tree"], atol=atol)


@pytest.mark.parametrize("name", ["jet", "value"])
def test_dp_tp_two_pairs_match_one_process(runs, name):
    """Two column / row pairs on the 2 x 2 mesh: the second column layer
    reads the first pair's sum, so its input's cotangent is all-reduced in
    the backward; each rank's gradient parts equal the one process's slices
    (float64, 1e-12), for the PINN loss on the jet and a fit on the value."""
    from nnpde_tpu_torch.losses import pinn_poisson as tpinn
    from nnpde_tpu_torch.models import mlp_apply_batch
    from nnpde_tpu_torch.pde import poisson as tphys

    z = runs["z"]
    model = TSolutionModel(TNetSpec(DEEP_LAYERS, "sin"), t_factor("FBC", dim=2, kind="box", L=L))
    P = params_from_jax([(z[f"dpW{i}"], z[f"dpb{i}"]) for i in range(len(DEEP_LAYERS) - 1)],
                        dtype=torch.float64)
    leaves = [t.requires_grad_(True) for pair in P for t in pair]
    X, y = (torch.as_tensor(z[k], dtype=torch.float64) for k in ("X", "y"))
    if name == "jet":
        loss = tpinn(model.fields(P, X).lap, tphys.rhs_f_for_u_sin(X, L, [1, 1]))
    else:
        loss = torch.mean((mlp_apply_batch(P, X, "sin") - y) ** 2)
    g = torch.autograd.grad(loss, leaves)
    tag = f"tp/deep_{name}"
    for out in runs["ranks"][4]:
        j = int(out["tp/coords"][1])
        assert _rel(out[f"{tag}/value"], loss.detach().numpy()) <= 1e-12
        kinds = [str(out[f"{tag}/kind{i}"]) for i in range(len(DEEP_LAYERS) - 1)]
        assert kinds == ["col", "row", "col", "row", "rep"]
        for i, kind in enumerate(kinds):
            assert _rel(out[f"{tag}/gW{i}"], _tp_slice(g[2 * i].numpy(), kind, j)) <= 1e-12
            assert _rel(out[f"{tag}/gb{i}"], _tp_slice(g[2 * i + 1].numpy(), kind, j)) <= 1e-12


def test_tp_jet_on_a_world_of_one_is_the_plain_jet_bitwise():
    """tp = 1 (no process group): the TP jet, ``tp_fields`` and
    ``tp_mean_step`` take ``mlp_fwdlap``'s, ``fields``' and
    ``psum_mean_step``'s operations, bit for bit."""
    from nnpde_tpu_torch.losses import pinn_poisson as tpinn
    from nnpde_tpu_torch.models.inputmap import CosineInputMap
    from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap

    mesh = tpar.make_mesh_2d(1, 1, device="cpu")
    rng = np.random.default_rng(11)
    X = torch.as_tensor(rng.uniform(0.0, L, (96, 2)), dtype=torch.float32)
    for layers, act in (((2, 16, 16, 16, 16, 1), "sin"), ((2, 12, 12, 1), "tanh"),
                        ((2, 8, 1), "gelu")):
        model = TSolutionModel(TNetSpec(layers, act), t_factor("FBC", dim=2, kind="box", L=L))
        P = model.init(5)
        parts = tpar.tp_shard_mlp(P, mesh)
        for a, b in zip(tpar.tp_mlp_fwdlap(parts, X, act, mesh), mlp_fwdlap(P, X, act)):
            assert torch.equal(a, b)
        for m in (model, TSolutionModel(TNetSpec(layers, act), model.factor,
                                        input_map=CosineInputMap(2, 0.0, L))):
            for a, b in zip(tpar.tp_fields(m, parts, X, mesh), m.fields(P, X)):
                assert torch.equal(a, b)

        def loss_of(jet_of):
            return lambda p, X_: tpinn(jet_of(p, X_).lap, torch.sin(X_[:, 0]))

        l1, g1 = tpar.tp_mean_step(loss_of(lambda p, X_: tpar.tp_fields(model, p, X_, mesh)),
                                   mesh)(parts, X)
        l0, g0 = tpar.psum_mean_step(loss_of(model.fields), mesh)(P, X)
        assert torch.equal(l1, l0)
        assert all(torch.equal(a, b) for pa, pb in zip(g1, g0) for a, b in zip(pa, pb))


def test_world_of_one_equals_plain_call_bitwise():
    """Without a process group a mesh is a world of one on the caller's
    device: every step returns the direct call's bits, shard_batch is the
    whole batch and replicate copies."""
    rng = np.random.default_rng(3)
    P = [(torch.as_tensor(rng.normal(size=(2, 8))), torch.as_tensor(rng.normal(size=8))),
         (torch.as_tensor(rng.normal(size=(8, 1))), torch.as_tensor(rng.normal(size=1)))]
    X = torch.as_tensor(rng.uniform(0, L, (40, 2)))
    B = t_factor("FBC", dim=2, kind="box", L=L).jet(X)
    coef = tk.residual_coefficients(B, a0=-1.0, rhs=torch.as_tensor(rng.normal(size=40)))
    mesh = tpar.make_mesh(device="cpu")
    assert mesh.size == 1 and mesh.group("data") is None
    assert torch.equal(tpar.shard_batch(X, mesh), X)
    R = tpar.replicate(P, mesh)
    assert all(torch.equal(a, b) and a is not b for pa, pb in zip(R, P) for a, b in zip(pa, pb))
    l1, s1, g1 = tpar.fused_residual_step(mesh, "sin")(P, X, coef)
    l0, a0, g0 = tk.fused_linear_residual(P, X, coef, "sin")
    assert torch.equal(l1, l0) and torch.equal(s1["sum_r2"], a0["sum_r2"])
    assert all(torch.equal(a, b) for pa, pb in zip(g1, g0) for a, b in zip(pa, pb))
    qc = tk.quotient_coefficients(B, V=0.5 * torch.sum(X ** 2, dim=1))
    v1, _, h1 = tpar.fused_rayleigh_step(mesh, "sin", weight=3.0)(P, X, qc)
    leaves = [t.clone().requires_grad_(True) for pair in P for t in pair]
    v0, _ = tk.make_fused_rayleigh("sin", weight=3.0)(
        [(leaves[0], leaves[1]), (leaves[2], leaves[3])], X, qc)
    h0 = torch.autograd.grad(v0, leaves)
    assert torch.equal(v1, v0.detach())
    assert all(torch.equal(a, b) for a, b in zip([t for pair in h1 for t in pair], h0))


def test_mesh_shapes_and_errors():
    """Mesh layout without a group: a world of one; shapes that need more
    ranks, a batch that does not split and a mesh-axis name as a kernel's
    axis all raise."""
    with pytest.raises(ValueError, match="devices"):
        tpar.make_mesh_dcn(2, 2, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        tpar.make_mesh(4, device="cpu")
    m = tpar.make_mesh_2d(1, 1, device="cpu")
    assert m.axis_names == ("data", "model") and m.shape == (1, 1)
    assert m.axis_size(("data", "model")) == 1 and m.axis_index("model") == 0
    with pytest.raises(ValueError, match="unknown mesh axes"):
        m.group("dcn")
    with pytest.raises(TypeError, match="process group"):
        tk.make_fused_wan_v("sin", axis="data")
    from nnpde_tpu_torch.parallel.mesh import _axis_rank_sets

    # JAX's row-major device grid: rank = i * tp + j
    assert _axis_rank_sets((2, 2), 0) == [[0, 2], [1, 3]]
    assert _axis_rank_sets((2, 2), 1) == [[0, 1], [2, 3]]
    assert _axis_rank_sets((2, 3), 1) == [[0, 1, 2], [3, 4, 5]]
