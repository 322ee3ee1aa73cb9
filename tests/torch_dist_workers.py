"""Rank processes for ``tests/test_torch_parallel.py``: the data-parallel
steps of ``nnpde_tpu_torch.parallel`` on gloo ranks on the CPU.

Run as ``python tests/torch_dist_workers.py RANK WORLD WORKDIR TIMEOUT``
(with the repository root on ``PYTHONPATH``), once per rank.  Each rank
reads ``WORKDIR/inputs.npz`` (parameters and full batches made by the
test), meets the others through the file ``WORKDIR/rendezvous``, runs every
step on its shard in float32 and float64, and writes what it got to
``WORKDIR/rank{RANK}.npz``.  This module imports neither JAX nor the test
package's ``conftest.py``: a spawned rank must not start JAX.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

L = 2.0
ACT = "sin"


def _pairs(z, dtype, prefix="p"):
    n = sum(1 for k in z.files if k.startswith(prefix + "W"))
    return [(torch.as_tensor(z[f"{prefix}W{i}"], dtype=dtype),
             torch.as_tensor(z[f"{prefix}b{i}"], dtype=dtype)) for i in range(n)]


def _put(out, name, value, grads=None, aux=None):
    out[f"{name}/value"] = value.detach().numpy()
    for i, (W, b) in enumerate(grads or []):
        out[f"{name}/gW{i}"] = W.detach().numpy()
        out[f"{name}/gb{i}"] = b.detach().numpy()
    for k, v in (aux or {}).items():
        out[f"{name}/aux/{k}"] = torch.as_tensor(v).detach().numpy()


def pinn_loss(model):
    """The Poisson PINN loss on the torch route, the right-hand side made
    from the points as JAX's test makes it."""
    from nnpde_tpu_torch.losses import pinn_poisson
    from nnpde_tpu_torch.pde import poisson

    def loss(params, X):
        return pinn_poisson(model.fields(params, X).lap, poisson.rhs_f_for_u_sin(X, L, [1, 1]))

    return loss


def run(rank: int, world: int, z) -> dict:
    from nnpde_tpu_torch.kernels import make_fused_rayleigh
    from nnpde_tpu_torch.losses import pinn_poisson
    from nnpde_tpu_torch.pde import poisson
    from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
    from nnpde_tpu_torch.parallel import (
        dp_dcn_step, fused_rayleigh_step, fused_residual_step, fused_wan_u_step,
        fused_wan_v_step, make_mesh, make_mesh_2d, make_mesh_dcn, psum_mean_step, replicate,
        shard_batch, tp_fields, tp_mean_step, tp_mlp_apply, tp_shard_mlp)

    layers = tuple(int(w) for w in z["layers"])
    model = SolutionModel(NetSpec(layers, ACT), factor_for_technique("FBC", dim=2, kind="box",
                                                                     L=L))
    loss_fn = pinn_loss(model)
    mesh = make_mesh(device="cpu")
    out = {"rank": np.asarray(rank), "mesh_shape": np.asarray(mesh.shape)}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split(".")[1]
        ps = replicate(_pairs(z, dtype), mesh)

        def sh(key):
            return shard_batch(torch.as_tensor(z[key], dtype=dtype), mesh)

        X = sh("X")
        loss, g = psum_mean_step(loss_fn, mesh)(ps, X)
        _put(out, f"{tag}/psum", loss, g)
        for kind in ("pinn", "drm"):
            loss, sums, g = fused_residual_step(mesh, ACT, kind=kind)(ps, X, sh(f"coef_{kind}"))
            _put(out, f"{tag}/fused_{kind}", loss, g, sums)
        loss, aux, g = fused_rayleigh_step(mesh, ACT, weight=3.0, den_eps=1e-8)(
            ps, X, sh("coef_ray"))
        _put(out, f"{tag}/rayleigh", loss, g, aux)
        # the objective itself with axis= the world's group
        ray = make_fused_rayleigh(ACT, weight=3.0, den_eps=1e-8, axis=dist.group.WORLD)
        leaves = [t.clone().requires_grad_(True) for pair in ps for t in pair]
        val, aux = ray([(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)], X,
                       sh("coef_ray"))
        gl = torch.autograd.grad(val, leaves)
        _put(out, f"{tag}/rayleigh_axis", val, [(gl[i], gl[i + 1]) for i in range(0, len(gl), 2)],
             aux)
        E0 = torch.tensor(float(z["E0"]), dtype=dtype)
        loss, aux, g, dE = fused_wan_u_step(mesh, ACT, vol=4.0, w_pde=10.0, w_norm=100.0)(
            ps, E0, X, sh("base"), sh("phi"))
        _put(out, f"{tag}/wan_u", loss, g, dict(aux, dE=dE))
        loss, aux, g = fused_wan_v_step(mesh, ACT)(ps, X, sh("coef_v"))
        _put(out, f"{tag}/wan_v", loss, g, aux)

    # training in float32: Adam over the all-reduced mean gradients
    X = shard_batch(torch.as_tensor(z["X"]), mesh)
    coef = shard_batch(torch.as_tensor(z["coef_pinn"]), mesh)
    psum_step, fused_step = psum_mean_step(loss_fn, mesh), fused_residual_step(mesh, ACT)

    def psum_grads(p):
        return psum_step(p, X)

    def fused_grads(p):
        loss, _, g = fused_step(p, X, coef)
        return loss, g

    for name, steps, lr, fn in (("train_psum", int(z["train_steps"]), 2e-3, psum_grads),
                                ("train_fused", 20, 1e-3, fused_grads)):
        ps = replicate(_pairs(z, torch.float32), mesh)
        leaves = [t for pair in ps for t in pair]
        opt = torch.optim.Adam(leaves, lr=lr)
        losses = []
        for _ in range(steps):
            loss, grads = fn(ps)
            for t, gr in zip(leaves, [t for pair in grads for t in pair]):
                t.grad = gr
            opt.step()
            losses.append(float(loss))
        out[f"{name}/losses"] = np.asarray(losses)
        for i, t in enumerate(leaves):
            out[f"{name}/leaf{i}"] = t.numpy()

    if world == 4:
        # DP x TP on a 2 x 2 mesh: a data-fit loss on the value, the batch
        # split over "data", the layers over "model"
        m2 = make_mesh_2d(2, 2, device="cpu")
        P = _pairs(z, torch.float64)
        parts = tp_shard_mlp(P, m2)
        live = [t.clone().requires_grad_(True) for part in parts for t in part[:2]]
        lay = [type(parts[i])(live[2 * i], live[2 * i + 1], parts[i].kind)
               for i in range(len(parts))]
        Xd = shard_batch(torch.as_tensor(z["X"], dtype=torch.float64), m2, "data")
        yd = shard_batch(torch.as_tensor(z["y"], dtype=torch.float64), m2, "data")
        u = tp_mlp_apply(lay, Xd, ACT, m2)
        loss = torch.mean((u - yd) ** 2)
        gl = torch.autograd.grad(loss, live)
        vals = [loss.detach()] + list(gl)
        from nnpde_tpu_torch.parallel.mesh import _reduce

        vals = _reduce(vals, m2.group("data"), len(vals))
        out["tp/value"] = vals[0].numpy()
        out["tp/coords"] = np.asarray(m2.coords)
        for i, (part, gW, gb) in enumerate(zip(parts, vals[1::2], vals[2::2])):
            out[f"tp/gW{i}"] = gW.numpy()
            out[f"tp/gb{i}"] = gb.numpy()
            out[f"tp/kind{i}"] = np.asarray(part.kind)
        # DP x TP through the jet: the PINN residual of JAX's dp x tp test
        # (its own net and points, tp* in inputs.npz), loss and gradients,
        # then one Adam step on this rank's parts
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype).split(".")[1]
            tp_model = SolutionModel(NetSpec(tuple(int(w) for w in z["tp_layers"]), ACT),
                                     factor_for_technique("FBC", dim=2, kind="box", L=L))
            parts = tp_shard_mlp(_pairs(z, dtype, "tp"), m2)
            Xt = shard_batch(torch.as_tensor(z["tpX"], dtype=dtype), m2, "data")

            def tp_pinn(lay, X_):
                return pinn_poisson(tp_fields(tp_model, lay, X_, m2).lap,
                                    poisson.rhs_f_for_u_sin(X_, L, [1, 1]))

            loss, grads = tp_mean_step(tp_pinn, m2)(parts, Xt)
            leaves = [t.clone() for part in parts for t in part[:2]]
            opt = torch.optim.Adam(leaves, lr=1e-3)
            for t, gr in zip(leaves, [t for pair in grads for t in pair]):
                t.grad = gr
            opt.step()
            out[f"tp/jet_{tag}/value"] = loss.numpy()
            for i, (part, (gW, gb)) in enumerate(zip(parts, grads)):
                out[f"tp/jet_{tag}/gW{i}"], out[f"tp/jet_{tag}/gb{i}"] = gW.numpy(), gb.numpy()
                out[f"tp/jet_{tag}/W{i}"] = leaves[2 * i].detach().numpy()
                out[f"tp/jet_{tag}/b{i}"] = leaves[2 * i + 1].detach().numpy()
                out[f"tp/jet_{tag}/kind{i}"] = np.asarray(part.kind)
        # two column / row pairs (the backward all-reduce before the second
        # column layer): the PINN loss through the TP jet and a data fit on
        # the value, float64
        deep = SolutionModel(NetSpec(tuple(int(w) for w in z["dp_layers"]), ACT),
                             factor_for_technique("FBC", dim=2, kind="box", L=L))
        dparts = tp_shard_mlp(_pairs(z, torch.float64, "dp"), m2)
        Xd = shard_batch(torch.as_tensor(z["X"], dtype=torch.float64), m2, "data")
        yd = shard_batch(torch.as_tensor(z["y"], dtype=torch.float64), m2, "data")
        deep_losses = {
            "jet": lambda lay, X_: pinn_poisson(tp_fields(deep, lay, X_, m2).lap,
                                                poisson.rhs_f_for_u_sin(X_, L, [1, 1])),
            "value": lambda lay, X_: torch.mean((tp_mlp_apply(lay, X_, ACT, m2) - yd) ** 2)}
        for name, fn in deep_losses.items():
            loss, grads = tp_mean_step(fn, m2)(dparts, Xd)
            out[f"tp/deep_{name}/value"] = loss.numpy()
            for i, (part, (gW, gb)) in enumerate(zip(dparts, grads)):
                out[f"tp/deep_{name}/gW{i}"], out[f"tp/deep_{name}/gb{i}"] = gW.numpy(), gb.numpy()
                out[f"tp/deep_{name}/kind{i}"] = np.asarray(part.kind)
        # the two-level mean over a (dcn, data) mesh
        m3 = make_mesh_dcn(2, 2, device="cpu")
        ps = replicate(_pairs(z, torch.float64), m3)
        Xs = shard_batch(torch.as_tensor(z["X"], dtype=torch.float64), m3, ("dcn", "data"))
        loss, g = dp_dcn_step(loss_fn, m3)(ps, Xs)
        _put(out, "dcn", loss, g)
        loss, _, g = fused_residual_step(m3, ACT, axis=("dcn", "data"))(
            ps, Xs, shard_batch(torch.as_tensor(z["coef_pinn"], dtype=torch.float64), m3,
                                ("dcn", "data")))
        _put(out, "dcn_fused", loss, g)
    return out


def main(rank: int, world: int, workdir: str, timeout_s: float) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        with np.load(os.path.join(workdir, "inputs.npz")) as z:
            out = run(rank, world, z)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], float(sys.argv[4]))
