"""N-D Poisson preset: PINN / DRM / WAN on ``[0, L]^d``.

Counterpart of ``nnpde_tpu/problems/poisson.py``, with the same
:class:`PoissonConfig` fields and defaults:

* methods PINN (strong residual), DRM (energy) and WAN (minimax against a
  bump-windowed critic, fresh points for every critic and primal step);
  bc modes FBC (hard ``prod x_i (L - x_i)`` trial; with ``bc_type='neumann'``
  hard Neumann, the raw net on cosine input features,
  :class:`~nnpde_tpu_torch.models.CosineInputMap`, on the torch jet route
  only) and RB (soft penalty on fresh per-face samples each epoch);
* default weights ``{pde: 1, bc: 1e4 if RB, data: 1e3 if n_data, norm: 0}``;
* per-epoch eval on fresh uniform points, RMSE vs the manufactured
  solution, best-state tracking.

``jet_impl``: ``'torch'`` (the forward-Laplacian recurrence under autograd,
the counterpart of ``'xla'``), ``'kernel'`` (the counterpart of
``'pallas'``: the PINN residual's jet through the jet-forward kernel and its
recompute backward, :mod:`nnpde_tpu_torch.kernels.fwdlap_cuda`; as in the
JAX package DRM and WAN run their ``'torch'`` path under it) or ``'fused'`` (the counterpart of
``'pallas-fused'``: the one-pass CUDA loss+grad kernels of
:mod:`nnpde_tpu_torch.kernels.fused_step` for PINN and DRM; for WAN the
jet-forward kernel and the two-pass kernels of
:mod:`nnpde_tpu_torch.kernels.fused_quotient`; on CPU tensors their plain
versions).

``compute_dtype`` (as in the JAX package):

* ``'bfloat16'``: the nets' parameters and points are cast to bf16, the
  jets (PINN) or value-and-grad (DRM, WAN) run in bf16 on the torch route
  whatever ``jet_impl`` says, and every loss reduction takes their float32
  casts; Adam keeps float32 master parameters;
* ``'hybrid'``: a bf16 bulk of ``int(epochs * hybrid_bf16_fraction)``
  epochs, then a float32 tail on the route ``jet_impl`` names, resumed from
  the bulk's full carry (Adam moments, schedule step, running best; for WAN
  both optimizers, the EMA and the OGDA gradients); the histories are
  concatenated;
* ``'hybrid-kernel'`` (PINN on ``'kernel'`` or ``'fused'``): the bulk keeps
  float32 parameters and streams and runs the kernels in their bf16-dot
  mode (``'kernel'``: the jet forward ``fwd_impl='rows:default'`` and the
  backward ``dot_dtype='bfloat16'``; ``'fused'``: the residual kernel with
  ``dot_dtype='bfloat16'``), the tail the exact float32 kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import runtime
from ..kernels import (
    drm_coefficients,
    fused_drm_energy,
    fused_linear_residual,
    fused_poisson_analytic,
    make_fused_quad_mean,
    quotient_coefficients,
    residual_coefficients,
)
from ..losses import (
    data_mse,
    drm_poisson_energy,
    norm_nontrivial,
    pinn_poisson,
    wan_pde_loss,
    wan_weak_residual,
)
from ..models import CosineInputMap, NetSpec, SolutionModel, factor_for_technique
from ..ops import bump_w
from ..ops.fwdlap import constant_jet
from ..pde import poisson as phys
from ..pde.domain import Box
from ..prng import fold_in, generator, split, threefry_fold_in, threefry_key, threefry_split
from ..sampling import face_points, shifted_qmc, sobol_unit, uniform_box
from ..train import fit, fit_wan, make_optimizer, make_wan_optimizers
from ._fused_wan import factor_jet_or_one, make_fused_wan_pair

_BF16 = torch.bfloat16


def to_bf16(params):
    """The nets' parameters cast to bf16 (differentiable: the gradient
    reaches the float32 master copy in float32)."""
    return [(W.to(_BF16), b.to(_BF16)) for W, b in params]


def join_phases(bulk, tail):
    """One result from a bulk and a tail that resumed from its carry: the
    tail's state, the histories concatenated, the timing of both phases."""
    hist = {k: np.concatenate([bulk.history[k], tail.history[k]]) for k in tail.history}
    tb, tt = bulk.timing, tail.timing
    elapsed = tb["elapsed_s"] + tt["elapsed_s"]
    timing = {"elapsed_s": elapsed,
              "steps_per_s": len(hist["l2"]) / elapsed if elapsed > 0 else float("nan"),
              "bulk_steps_per_s": tb["steps_per_s"], "tail_steps_per_s": tt["steps_per_s"]}
    return tail._replace(history=hist, timing=timing)


@dataclasses.dataclass
class PoissonConfig:
    dim: int = 2
    L: float = 2.0
    ks: Optional[Sequence[int]] = None       # default [1]*dim
    method: str = "PINN"                     # PINN | DRM | WAN
    bc_mode: str = "FBC"                     # FBC | RB
    bc_type: str = "dirichlet"               # dirichlet | neumann (RB only)
    solution: str = "sin"                    # manufactured family: sin | cos
    n_interior: int = 20000
    n_boundary: int = 4000
    n_data: int = 0
    epochs: int = 10000
    lr: float = 1e-3
    width: int = 64
    depth: int = 5
    critic_width: int = 64
    critic_depth: int = 3
    critic_steps: int = 5
    wan_reg: float = 1.0
    minimax: str = "alternating"
    v_lr: Optional[float] = None
    u_ema: float = 0.0
    norm_mode: str = "nontrivial"
    weights: Optional[Dict[str, float]] = None
    seed: int = 0
    lr_schedule: str = "constant"   # constant | cosine | exponential
    compute_dtype: str = "float32"
    hybrid_bf16_fraction: float = 0.8
    # 'torch' (recurrence + autograd) | 'kernel' (jet kernel pair, PINN) |
    # 'fused' (one-pass CUDA kernels)
    jet_impl: str = "torch"
    # 'stream' (precomputed (N, d+4) coefficients) | 'analytic' (built
    # in-kernel from X: PINN + FBC + solution='sin' + jet_impl='fused')
    coef_mode: str = "stream"
    resample: bool = False
    sampler: str = "uniform"
    n_eval: int = 10000
    chunk: int = 1000

    def resolved_ks(self) -> Tuple[int, ...]:
        return tuple(self.ks) if self.ks is not None else (1,) * self.dim

    def resolved_weights(self) -> Dict[str, float]:
        bc_default = 1e4 if self.bc_mode == "RB" else 0.0
        if self.bc_mode == "RB" and self.bc_type == "neumann":
            bc_default = 0.0 if self.method == "DRM" else 100.0
        w = {
            "pde": 1.0,
            "bc": bc_default,
            "data": 1e3 if self.n_data > 0 else 0.0,
            "norm": 0.0,
        }
        if self.weights:
            w.update(self.weights)
        return w


def _solution_model(cfg: PoissonConfig) -> SolutionModel:
    layers = (cfg.dim,) + (cfg.width,) * (cfg.depth - 1) + (1,)
    if cfg.bc_mode not in ("FBC", "RB"):
        raise ValueError("bc_mode must be 'FBC' or 'RB'")
    if cfg.bc_type not in ("dirichlet", "neumann"):
        raise ValueError("bc_type must be 'dirichlet' or 'neumann'")
    if cfg.bc_type == "neumann" and cfg.solution != "cos":
        raise ValueError(
            "Neumann BCs require the zero-Neumann manufactured family: "
            "pass solution='cos'"
        )
    if cfg.bc_type == "neumann" and cfg.bc_mode == "FBC":
        # hard Neumann: the raw net on cosine features (du/dn = 0 exactly on
        # every face, models/inputmap.py), no output factor
        return SolutionModel(NetSpec(layers, activation="sin"),
                             input_map=CosineInputMap(cfg.dim, 0.0, cfg.L))
    factor = (factor_for_technique("FBC", dim=cfg.dim, kind="box", L=cfg.L)
              if cfg.bc_mode == "FBC" else None)
    return SolutionModel(NetSpec(layers, activation="sin"), factor)


def _exact_fns(cfg: PoissonConfig):
    if cfg.solution == "sin":
        return phys.exact_u_prod_sin, phys.rhs_f_for_u_sin
    if cfg.solution == "cos":
        return phys.exact_u_prod_cos, phys.rhs_f_for_u_cos
    raise ValueError("solution must be 'sin' or 'cos'")


def _critic_model(cfg: PoissonConfig) -> SolutionModel:
    layers = (cfg.dim,) + (cfg.critic_width,) * (cfg.critic_depth - 1) + (1,)
    return SolutionModel(NetSpec(layers, activation="sin"))


def _validate(cfg: PoissonConfig) -> None:
    if cfg.method not in ("PINN", "DRM", "WAN"):
        raise ValueError("method must be one of {'PINN','DRM','WAN'}")
    if cfg.compute_dtype not in ("float32", "bfloat16", "hybrid",
                                 "hybrid-kernel"):
        raise ValueError("compute_dtype must be 'float32', 'bfloat16', "
                         "'hybrid' or 'hybrid-kernel'")
    if cfg.compute_dtype == "hybrid-kernel" and not (
        cfg.method == "PINN" and cfg.jet_impl in ("kernel", "fused")
    ):
        raise ValueError(
            "compute_dtype='hybrid-kernel' is the kernels' bf16-dot bulk mode "
            "— requires method='PINN' and jet_impl='kernel' or 'fused'")
    if cfg.jet_impl == "pallas":
        raise NotImplementedError(
            "jet_impl='pallas' is the JAX package's name for the jet kernel "
            "pair; this port calls it jet_impl='kernel'")
    if cfg.jet_impl not in ("torch", "kernel", "fused"):
        raise ValueError("jet_impl must be 'torch', 'kernel' or 'fused'")
    if cfg.coef_mode not in ("stream", "analytic"):
        raise ValueError("coef_mode must be 'stream' or 'analytic'")
    if cfg.coef_mode == "analytic" and not (
        cfg.method == "PINN" and cfg.jet_impl == "fused"
        and cfg.bc_mode == "FBC" and cfg.solution == "sin"
    ):
        raise ValueError(
            "coef_mode='analytic' = in-kernel coefficients for the box-FBC "
            "prod-sin Poisson PINN — requires method='PINN', "
            "jet_impl='fused', bc_mode='FBC', solution='sin'"
        )
    # hard Neumann puts the raw net on cosine input features, which no kernel
    # takes: the jet kernels (PINN on 'kernel') and every fused objective
    # would drop the map
    hard_neumann = cfg.bc_mode == "FBC" and cfg.bc_type == "neumann"
    if hard_neumann and (cfg.jet_impl == "fused"
                         or (cfg.jet_impl == "kernel" and cfg.method == "PINN")):
        raise ValueError(
            "input_map (hard Neumann: bc_mode='FBC', bc_type='neumann') is "
            f"supported on the torch jet route only, not jet_impl={cfg.jet_impl!r}")


def train_poisson_nd(cfg: PoissonConfig, device="cuda") -> Dict:
    """Train the configured Poisson solver; returns the same keys as the
    JAX entry point (``rel_l2``, ``best_l2``, ``history``, ``result`` ...).

    ``cfg.seed`` gives the JAX package's initial weights (same seed, the
    same weights bit for bit); the points and the epochs' keys draw from
    torch's generators, so they differ from JAX's.
    """
    _validate(cfg)
    dev = runtime.resolve_device(device)
    runtime.pin_fp32_precision()
    chunk = (min(cfg.chunk, runtime.pallas_chunk_cap())
             if cfg.jet_impl == "fused" else cfg.chunk)
    ks = cfg.resolved_ks()
    w = cfg.resolved_weights()
    w.setdefault("mean", 1.0 if cfg.bc_type == "neumann" else 0.0)
    box = Box.cube(cfg.dim, 0.0, cfg.L)
    model = _solution_model(cfg)
    exact_u, rhs_f = _exact_fns(cfg)

    # the JAX package's initial weights (split(PRNGKey(seed), 4)[0]); the
    # points and the epochs draw from torch's generators
    k_init = threefry_split(threefry_key(cfg.seed), 4)[0]
    _, k_x, k_data, k_train = split(cfg.seed, 4)
    params = model.init(k_init, device=dev)

    if cfg.sampler == "sobol":
        U_base = sobol_unit(cfg.seed, cfg.n_interior, cfg.dim, device=dev)
        lo = torch.tensor(box.lo, device=dev)
        hi = torch.tensor(box.hi, device=dev)
        X_in = lo + U_base * (hi - lo)

        def draw_interior(key):
            return shifted_qmc(U_base, generator(key, dev), box)

    elif cfg.sampler == "uniform":
        X_in = uniform_box(generator(k_x, dev), cfg.n_interior, box)

        def draw_interior(key):
            return uniform_box(generator(key, dev), cfg.n_interior, box)

    else:
        raise ValueError("sampler must be 'uniform' or 'sobol'")
    f_in = rhs_f(X_in, cfg.L, ks)

    if cfg.n_data > 0:
        X_data = uniform_box(generator(k_data, dev), cfg.n_data, box)
        u_data = exact_u(X_data, cfg.L, ks)
    else:
        X_data = u_data = None

    per_face = max(1, cfg.n_boundary // (2 * cfg.dim))
    zero = torch.zeros((), device=dev)

    def aux_terms(params, key, u_interior):
        """bc / data / norm / mean losses shared by every method."""
        if cfg.bc_mode == "RB":
            Xb = face_points(generator(key, dev), per_face, box)
            if cfg.bc_type == "neumann":
                _, gb = model.value_and_grad(params, Xb)
                comp = torch.arange(cfg.dim, device=dev).repeat_interleave(2 * per_face)
                gn = torch.gather(gb, 1, comp[:, None])[:, 0]
                bc = torch.mean(gn ** 2)
            else:
                bc = torch.mean(model.apply_batch(params, Xb) ** 2)
        else:
            bc = zero
        data = (data_mse(model.apply_batch(params, X_data), u_data)
                if X_data is not None else zero)
        if w["norm"] > 0:
            if cfg.norm_mode == "nontrivial":
                norm = norm_nontrivial(u_interior)
            elif cfg.norm_mode == "l2":
                norm = torch.mean(u_interior ** 2)
            else:
                raise ValueError("norm mode should be 'nontrivial' or 'l2'")
        else:
            norm = zero
        mean_pen = torch.mean(u_interior) ** 2 if w["mean"] > 0 else zero
        return bc, data, norm, mean_pen

    def eval_fn(params, key):
        """RMSE vs exact on fresh uniform points."""
        X_te = uniform_box(generator(key, dev), cfg.n_eval, box)
        u = model.apply_batch(params, X_te)
        return torch.sqrt(torch.mean((u - exact_u(X_te, cfg.L, ks)) ** 2))

    def interior(key):
        if cfg.resample:
            X_cur = draw_interior(fold_in(key, 3))
            return X_cur, rhs_f(X_cur, cfg.L, ks)
        return X_in, f_in

    def make_loss_fn(dtype):
        """The autograd objective of one precision phase: ``'float32'``,
        ``'bfloat16'`` (bf16 nets on the torch route, float32 reductions)
        or ``'kernel-bf16'`` (the jet kernels' bf16-dot mode)."""
        def loss_fn(params, key):
            X_cur, f_cur = interior(key)
            if dtype == "bfloat16":
                p_c, X_c = to_bf16(params), X_cur.to(_BF16)
            else:
                p_c, X_c = params, X_cur
            if cfg.method == "PINN":
                if dtype == "kernel-bf16":
                    jet = model.fields(p_c, X_c, impl="kernel", fwd_impl="rows:default",
                                       dot_dtype="bfloat16")
                else:
                    impl = "torch" if dtype == "bfloat16" else cfg.jet_impl
                    jet = model.fields(p_c, X_c, impl=impl)
                pde = pinn_poisson(jet.lap.float(), f_cur)
                u_int = jet.value.float()
            else:
                u_int, g = model.value_and_grad(p_c, X_c)
                u_int = u_int.float()
                pde = drm_poisson_energy(u_int, g.float(), f_cur)
            bc, data, norm, mean_pen = aux_terms(params, key, u_int)
            total = (w["pde"] * pde + w["bc"] * bc + w["data"] * data
                     + w["norm"] * norm + w["mean"] * mean_pen)
            return total, {"pde": pde, "bc": bc, "data": data, "norm": norm}

        return loss_fn

    if cfg.method == "WAN":
        result = _fit_wan(cfg, model, params, dev, w, ks, rhs_f, draw_interior,
                          aux_terms, eval_fn, k_init, k_train, chunk)
        return _report(cfg, model, result)

    def factor_jet_at(X_cur):
        if model.factor is not None:
            return model.factor.jet(X_cur)
        return constant_jet(torch.ones(X_cur.shape[0], device=dev), cfg.dim)

    def coef_at(X_cur, f_cur):
        fj = factor_jet_at(X_cur)
        if cfg.method == "DRM":
            return drm_coefficients(fj, f_cur)
        return residual_coefficients(fj, a0=-1.0, rhs=-f_cur)

    coef_fixed = (None if cfg.resample or cfg.jet_impl != "fused"
                  else coef_at(X_in, f_in))
    need_aux = (w["bc"] > 0 or w["data"] > 0 or w["norm"] > 0 or w["mean"] > 0)

    def lag_fn(params, key, dot_dtype="float32"):
        """Fused loss+grad: the residual / energy through one kernel launch,
        the aux terms (bc, data, norm, mean) on autograd.  ``dot_dtype``:
        the residual kernel's dot mode."""
        if cfg.resample:
            X_cur, f_cur = interior(key)
            coef = coef_at(X_cur, f_cur)
        else:
            X_cur, coef = X_in, coef_fixed
        act = model.spec.activation
        if cfg.coef_mode == "analytic":
            pde, _, g_pde = fused_poisson_analytic(params, X_cur, act, L=cfg.L, ks=ks,
                                                   dot_dtype=dot_dtype)
        elif cfg.method == "DRM":
            pde, _, g_pde = fused_drm_energy(params, X_cur, coef, act)
        else:
            pde, _, g_pde = fused_linear_residual(params, X_cur, coef, act,
                                                  dot_dtype=dot_dtype)
        total = w["pde"] * pde
        grads = [(w["pde"] * gW, w["pde"] * gb) for gW, gb in g_pde]
        metrics = {"pde": pde, "bc": zero, "data": zero, "norm": zero}
        if need_aux:
            with torch.enable_grad():
                u_int = (model.apply_batch(params, X_cur)
                         if (w["norm"] > 0 or w["mean"] > 0)
                         else torch.zeros((1,), device=dev))
                bc, data, norm, mean_pen = aux_terms(params, key, u_int)
                aux_tot = (w["bc"] * bc + w["data"] * data + w["norm"] * norm
                           + w["mean"] * mean_pen)
                leaves = [t for pair in params for t in pair]
                g_aux = torch.autograd.grad(aux_tot, leaves, allow_unused=True)
            g_aux = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(leaves, g_aux)]
            grads = [(gW + g_aux[2 * i], gb + g_aux[2 * i + 1])
                     for i, (gW, gb) in enumerate(grads)]
            total = total + aux_tot.detach()
            metrics = {"pde": pde, "bc": bc.detach(), "data": data.detach(),
                       "norm": norm.detach()}
        return (total, metrics), grads

    def phase_args(dtype):
        """(loss_fn, extra fit kwargs) of one precision phase: the fused
        kernel carries the float32 and kernel-bf16 phases, bf16 phases ride
        the torch route."""
        if cfg.jet_impl == "fused" and dtype in ("float32", "kernel-bf16"):
            dot = "bfloat16" if dtype == "kernel-bf16" else "float32"
            return None, {"loss_and_grad_fn": lambda p, k: lag_fn(p, k, dot)}
        return make_loss_fn(dtype), {}

    optimizer = make_optimizer(cfg.lr, schedule=cfg.lr_schedule,
                               total_steps=cfg.epochs)
    if cfg.compute_dtype in ("hybrid", "hybrid-kernel"):
        # the tail resumes from the bulk's full carry: Adam moments, the
        # schedule's step and the running best continue across the switch
        bulk = int(cfg.epochs * cfg.hybrid_bf16_fraction)
        lf_b, kw_b = phase_args("kernel-bf16" if cfg.compute_dtype == "hybrid-kernel"
                                else "bfloat16")
        r1 = fit(lf_b, eval_fn, params, epochs=bulk, optimizer=optimizer,
                 key=k_train, chunk=chunk, **kw_b)
        lf_t, kw_t = phase_args("float32")
        r2 = fit(lf_t, eval_fn, params, epochs=cfg.epochs - bulk, optimizer=optimizer,
                 key=k_train, chunk=chunk, start_epoch=bulk, init_carry=r1.carry, **kw_t)
        result = join_phases(r1, r2)
    else:
        lf, kw = phase_args(cfg.compute_dtype)
        result = fit(lf, eval_fn, params, epochs=cfg.epochs, optimizer=optimizer,
                     key=k_train, chunk=chunk, **kw)
    return _report(cfg, model, result)


def _fit_wan(cfg, model, params, dev, w, ks, rhs_f, draw_interior, aux_terms,
             eval_fn, k_init, k_train, chunk):
    """The WAN minimax: the critic maximises the weak residual quotient
    against the bump-windowed test function ``phi = w * v`` (objective
    ``-log(loss_pde) + reg * mean(|grad v|^2 + v^2)``), the primal
    minimises it; every critic and primal step draws fresh points."""
    critic = _critic_model(cfg)
    v_params = critic.init(threefry_fold_in(k_init, 1), device=dev)
    fused = cfg.jet_impl == "fused"
    if fused:
        # two-pass fused WAN: the Poisson weak form rides the rhs lane
        # (-f*phi), the critic regulariser mean(|grad v|^2 + v^2) the fused
        # quadratic mean (V = 1/2, weight = 2*reg)
        pair = make_fused_wan_pair(model, critic, w_pde=w["pde"], prefactor=1.0)
        quad_reg = (make_fused_quad_mean(critic.spec.activation,
                                         weight=2.0 * cfg.wan_reg)
                    if cfg.wan_reg else None)
        E_zero = torch.zeros((), device=dev)
    need_u = w["norm"] > 0 or w["mean"] > 0

    def wan_core(u_params, v_params, X, f, dtype):
        if dtype == "bfloat16":
            # net streams in bf16; every reduction takes float32 casts
            X16 = X.to(_BF16)
            u, gu = model.value_and_grad(to_bf16(u_params), X16)
            v, gv = critic.value_and_grad(to_bf16(v_params), X16)
            u, gu, v, gv = u.float(), gu.float(), v.float(), gv.float()
        else:
            u, gu = model.value_and_grad(u_params, X)
            v, gv = critic.value_and_grad(v_params, X)
        wv, dwv = bump_w(X, 0.0, cfg.L)
        phi = wv * v
        gphi = dwv * v[:, None] + wv[:, None] * gv
        weak = wan_weak_residual(gu, phi, gphi, f=f, prefactor=1.0)
        phi_norm = torch.mean(phi ** 2)
        return wan_pde_loss(weak, phi_norm), weak, phi_norm, u, v, gv

    def make_losses(dtype):
        """(u_loss_fn, v_loss_fn) of one precision phase; the fused kernels
        carry float32 phases only."""
        on_kernels = fused and dtype == "float32"

        def v_loss_fn(v_params, u_params, key):
            Xc = draw_interior(key)
            fc = rhs_f(Xc, cfg.L, ks)
            if on_kernels:
                wv, dwv = bump_w(Xc, 0.0, cfg.L)
                lv, _ = pair.v_loss_fn(v_params, u_params, E_zero, Xc, wv, dwv, f=fc)
                if quad_reg is not None:
                    coef_r = quotient_coefficients(factor_jet_or_one(critic, Xc), V=0.5)
                    reg2, _ = quad_reg(v_params, Xc, coef_r)
                    lv = lv + reg2
                return lv
            loss_pde, _, _, _, v, gv = wan_core(u_params, v_params, Xc, fc, dtype)
            v_reg = torch.mean(torch.sum(gv * gv, dim=-1) + v * v)
            return -torch.log(loss_pde + 1e-8) + cfg.wan_reg * v_reg

        def u_loss_fn(u_params, v_params, key):
            Xu = draw_interior(key)
            fu = rhs_f(Xu, cfg.L, ks)
            if on_kernels:
                wv, dwv = bump_w(Xu, 0.0, cfg.L)
                pde_w, aux = pair.u_pde_fn(u_params, E_zero, v_params, Xu, wv, dwv, f=fu)
                loss_pde, weak = aux["pde_loss"], aux["weak_residual"]
                phi_norm = aux["phi_norm"]
                u_int = model.apply_batch(u_params, Xu) if need_u else None
            else:
                loss_pde, weak, phi_norm, u_int, _, _ = wan_core(u_params, v_params, Xu,
                                                                 fu, dtype)
                pde_w = w["pde"] * loss_pde
            bc, data, norm, mean_pen = aux_terms(u_params, fold_in(key, 7), u_int)
            total = (pde_w + w["bc"] * bc + w["data"] * data + w["norm"] * norm
                     + w["mean"] * mean_pen)
            return total, {"pde": loss_pde, "bc": bc, "data": data, "norm": norm,
                           "wan_weak": weak, "wan_phi_norm": phi_norm}

        return u_loss_fn, v_loss_fn

    u_opt, v_opt = make_wan_optimizers(
        cfg.lr, v_lr=cfg.v_lr, schedule=cfg.lr_schedule, epochs=cfg.epochs,
        v_steps=cfg.critic_steps)
    wan_kw = dict(v_steps=cfg.critic_steps, u_optimizer=u_opt, v_optimizer=v_opt,
                  key=k_train, chunk=min(chunk, runtime.pallas_chunk_cap()),
                  minimax=cfg.minimax, u_ema=cfg.u_ema)
    if cfg.compute_dtype == "hybrid":
        # the tail resumes from the bulk's full carry: both optimizers, the
        # best iterate, the EMA and the OGDA gradients
        bulk = int(cfg.epochs * cfg.hybrid_bf16_fraction)
        r1 = fit_wan(*make_losses("bfloat16"), eval_fn, params, v_params, epochs=bulk,
                     **wan_kw)
        r2 = fit_wan(*make_losses("float32"), eval_fn, params, v_params,
                     epochs=cfg.epochs - bulk, start_epoch=bulk, init_carry=r1.carry,
                     **wan_kw)
        return join_phases(r1, r2)
    return fit_wan(*make_losses(cfg.compute_dtype), eval_fn, params, v_params,
                   epochs=cfg.epochs, **wan_kw)


def _report(cfg, model, result) -> Dict:
    # rms of the manufactured solution: mean(sin^2) = 1/2 per dimension
    rms_exact = 0.5 ** (cfg.dim / 2.0)
    return {
        "config": dataclasses.asdict(cfg),
        "model": model,
        "result": result,
        "history": result.history,
        "final_l2": (float(result.history["l2"][-1])
                     if "l2" in result.history else None),
        "best_l2": result.best_metric,
        "rel_l2": result.best_metric / rms_exact,
        "best_epoch": result.best_epoch,
    }
