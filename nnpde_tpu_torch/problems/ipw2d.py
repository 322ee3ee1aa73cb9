"""2D infinite potential well preset (PINN / DRM / WAN, techniques FBC/FN/OG).

Counterpart of ``nnpde_tpu/problems/ipw2d.py``, with the same
:class:`IPW2DConfig` fields and defaults: a ``grid_n x grid_n`` meshgrid on
``[0, L]^2``, lower-left-quadrant supervised data, unweighted symmetry
(``nx == ny``) and parity (``x -> L - x`` with sign ``(-1)^(n+1)``) losses,
degeneracy-aware orthogonality for DRM, the OG boundary penalty on
``n_boundary``-point edges, and the WAN branch: weak form ``int 1/2 grad u .
grad phi - E u phi`` with the known eigenvalue against a 2D bump test
function (or an ``n_test_grid^2`` grid of localised bumps), the finite-norm
term ``(L^2 mean(u^2) - 1)^2`` and ``v_steps`` critic steps per epoch.

``jet_impl``:

* ``'torch'`` (JAX ``'xla'``): the forward-Laplacian recurrence and
  per-point autodiff under ``torch.autograd``;
* ``'kernel'`` (JAX ``'pallas'``): every jet through the jet kernel pair
  (:func:`~nnpde_tpu_torch.kernels.mlp_fwdlap_kernel`, forward and recompute
  backward); ``'kernel:streams'`` selects its stream-major forward kernel
  (JAX ``fwd_impl='pallas'``), the jet being the same;
* ``'fused'`` (JAX ``'pallas-fused'``): PINN through the one-pass fused
  Helmholtz residual, DRM through the two-pass fused Rayleigh quotient, WAN
  through the two-pass weak-form kernels (the K-bump pair when
  ``n_test_grid > 1``).

On CPU tensors every kernel wrapper takes its plain version.

``LBFGS=True`` (PINN, DRM): after the run's last epoch, 500 iterations of
L-BFGS (:func:`~nnpde_tpu_torch.train.lbfgs_polish`) from the final iterate
on the objective of ``loss_terms`` (on ``'fused'`` PINN the torch jet, as the
JAX package's ``'pallas-fused'`` polishes on its XLA jet); the polished
iterate becomes the best where it scores better.

``compute_dtype``: ``'bfloat16'`` runs the nets' jets and value-and-grad
(and, for WAN, the reflected forwards) in bf16 on the torch route, every
reduction on float32 casts; ``'hybrid'`` a bf16 bulk then a float32 tail on
the ``jet_impl`` route, resumed from the bulk's full carry (as
:mod:`.poisson`).  Segmented resume does not combine with ``'hybrid'``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .. import runtime
from ..kernels import (
    fused_linear_residual,
    make_fused_rayleigh,
    quotient_coefficients,
    residual_coefficients,
)
from ..losses import (
    data_mse,
    drm_rayleigh_unscaled,
    norm_integral,
    orthogonal_projection,
    pinn_helmholtz,
    reflection_mse,
    wan_pde_loss,
    wan_weak_residual,
)
from ..models import NetSpec, SolutionModel, factor_for_technique
from ..ops import bump_grid, bump_w, bump_w_multi
from ..ops.quadrature import sign_aware_mse
from ..pde import ipw as phys
from ..prng import fold_in, generator, threefry_fold_in, threefry_key
from ..sampling import meshgrid_2d
from ..train import fit, fit_wan, make_optimizer, make_wan_optimizers
from ._fused_wan import make_fused_wan_multi_pair, make_fused_wan_pair
from .ipw import polish
from .poisson import join_phases, to_bf16

_JET_IMPLS = ("torch", "kernel", "kernel:streams", "fused")


@dataclasses.dataclass
class IPW2DConfig:
    nx: int = 1
    ny: int = 1
    L: float = 2.0
    epochs: int = 10000
    lr: float = 1e-3
    LBFGS: bool = False
    method: str = "PINN"              # PINN | DRM | WAN
    technique: str = "FBC"            # FBC | FN | OG
    layers: Tuple[int, ...] = (2, 50, 50, 50, 50, 1)
    v_layers: Tuple[int, ...] = (2, 20, 20, 20, 1)
    v_steps: int = 5
    # >1 enables the multi-test-function WAN: an n x n grid of localised
    # bumps, one weak residual per bump
    n_test_grid: int = 1
    # WAN only: a fresh uniform collocation sample per critic/primal step
    # instead of the fixed meshgrid
    wan_resample: bool = False
    # WAN only: per-evaluation whole-grid jitter (Cranley-Patterson shift of
    # a cell-centred lattice: X = (idx + s) * L/n, s ~ U[0,1)^2)
    grid_jitter: bool = False
    # WAN + grid_jitter only: keep the anchor terms (norm/parity/symmetry/
    # orth/data) on the fixed grid while the weak form rides the jittered
    # lattice
    jitter_anchors_fixed: bool = False
    # WAN only: saddle-point update rule (train/trainer.py fit_wan)
    minimax: str = "alternating"
    # WAN only: critic lr (None = cfg.lr)
    v_lr: Optional[float] = None
    # WAN only: EMA decay for the averaged primal iterate (0 disables)
    u_ema: float = 0.0
    # score the unit-normalised iterate (u * rms(psi)/rms(u)) instead of
    # the raw net output
    eval_selfnorm: bool = False
    grid_n: int = 200
    data_grid_n: int = 50
    n_boundary: int = 200
    seed: int = 0
    lr_schedule: str = "constant"   # constant | cosine | exponential
    # decay horizon when shorter than epochs: past it the lr holds at the
    # schedule floor
    lr_decay_steps: int = 0
    # schedule floor as a fraction of lr
    lr_final_scale: float = 0.01
    compute_dtype: str = "float32"
    hybrid_bf16_fraction: float = 0.8
    # 'torch' | 'kernel' | 'kernel:streams' | 'fused' (module docstring)
    jet_impl: str = "torch"
    chunk: int = 1000
    # Optional overrides of the reference weight table.  The reference
    # table has lambda_data = 0 and no norm loss, so its PINN branch admits
    # the trivial u = 0 minimiser: pass e.g. {'data': 1e4} or {'norm': 10.0}
    # to pin a nontrivial solution.
    weights: Optional[Dict[str, float]] = None


def unit_normalize(u, target_rms, *, eps: float = 1e-30):
    """Rescale a sampled field to a fixed rms convention: ``u * c / rms(u)``
    (scale-invariant: u and c*u map to the same function).  ``target_rms``
    must be the rms of the comparison target on the same eval grid."""
    return u * (target_rms / torch.sqrt(torch.mean(u * u) + eps))


def _lower_states_2d(nx: int, ny: int, X, L: float):
    """Degeneracy-aware lower states: (i, j) with i^2+j^2 < nx^2+ny^2, i and
    j up to max(nx, ny) (the reference's loop bound) -- (N, k)."""
    cols = []
    for i in range(1, max(nx, ny) + 1):
        for j in range(1, max(nx, ny) + 1):
            if i**2 + j**2 < nx**2 + ny**2:
                cols.append(phys.psi_2d(i, j, X[:, 0], X[:, 1], L))
    if not cols:
        return torch.zeros((X.shape[0], 0), dtype=X.dtype, device=X.device)
    return torch.stack(cols, dim=1)


def _validate(cfg: IPW2DConfig, init_carry, start_epoch, run_epochs) -> int:
    if cfg.method not in ("PINN", "DRM", "WAN"):
        raise ValueError("method must be 'PINN', 'DRM' or 'WAN'")
    if ((init_carry is not None or start_epoch or run_epochs is not None)
            and cfg.compute_dtype == "hybrid"):
        raise ValueError("segmented resume is not supported with "
                         "compute_dtype='hybrid'")
    seg_epochs = (cfg.epochs - start_epoch) if run_epochs is None else run_epochs
    if start_epoch + seg_epochs > cfg.epochs:
        raise ValueError("start_epoch + run_epochs exceeds cfg.epochs")
    if cfg.compute_dtype not in ("float32", "bfloat16", "hybrid"):
        raise ValueError("compute_dtype must be 'float32', 'bfloat16' or 'hybrid'")
    if cfg.jet_impl not in _JET_IMPLS:
        raise ValueError(f"jet_impl must be one of {_JET_IMPLS}")
    if cfg.technique not in ("FBC", "FN", "OG"):
        raise ValueError(f"Unknown technique: {cfg.technique}")
    return seg_epochs


def train_ipw_2d(cfg: IPW2DConfig, init_params=None, init_v_params=None,
                 init_carry=None, start_epoch: int = 0, run_epochs=None,
                 compile_only: bool = False, device="cuda") -> Dict:
    """Train the configured 2D-well eigen-solver; returns the JAX entry
    point's keys (``config``, ``model``, ``result``, ``history``,
    ``L2_error``, ``rel_l2``, ``min_epoch``, ``weights``).

    ``init_params`` / ``init_v_params`` warm-start the nets (e.g. weights
    carried over by :func:`nnpde_tpu_torch.interop.params_from_jax`).
    ``init_carry`` / ``start_epoch`` / ``run_epochs``: segmented training:
    run ``run_epochs`` epochs (default: the rest of the horizon) of the full
    ``cfg.epochs`` schedule from global epoch ``start_epoch`` and a prior
    ``result.carry``; the segments equal one continuous run (per-epoch keys
    fold in the absolute epoch index, the schedule rides the update count).
    ``compile_only``: return the trainer's memory probe of one training
    epoch instead of training (measured on the card, not analysed: see
    :func:`nnpde_tpu_torch.train.fit`); a hybrid config probes its bf16
    bulk phase, as the JAX package's does.

    ``cfg.seed`` gives the JAX package's initial weights (same seed, the
    same weights bit for bit); the points and the epochs' keys draw from
    torch's generators, so they differ from JAX's.
    """
    seg_epochs = _validate(cfg, init_carry, start_epoch, run_epochs)
    dev = runtime.resolve_device(device)
    runtime.pin_fp32_precision()
    cap = runtime.pallas_chunk_cap()
    chunk = min(cfg.chunk, cap) if cfg.jet_impl != "torch" else cfg.chunk
    nx, ny, L = cfg.nx, cfg.ny, cfg.L
    # the jet route of the non-fused losses, and the stream-major option
    jet_route = "torch" if cfg.jet_impl == "torch" else "kernel"
    jet_kw = {"fwd_impl": "streams"} if cfg.jet_impl == "kernel:streams" else {}

    factor = factor_for_technique(
        cfg.technique, dim=2, kind="box", L=L,
        nodes_per_dim=[phys.nodes(nx, L), phys.nodes(ny, L)]
        if cfg.technique == "FN" else None)
    model = SolutionModel(NetSpec(tuple(cfg.layers), activation="sin"), factor)
    act = model.spec.activation
    key = cfg.seed
    params = (init_params if init_params is not None
              else model.init(key))
    params = [(W.to(dev), b.to(dev)) for W, b in params]

    # every fixed tensor is made once, on the device
    zero = torch.zeros((), device=dev)
    X = meshgrid_2d(cfg.grid_n, 0.0, L, device=dev)               # (n^2, 2)
    u_exact = phys.psi_2d(nx, ny, X[:, 0], X[:, 1], L)

    # supervised quadrant: the first half x half block of the data grid
    Xd_full = meshgrid_2d(cfg.data_grid_n, 0.0, L, device=dev)
    half = cfg.data_grid_n // 2
    ii = torch.arange(half, device=dev)
    idx = (ii[:, None] * cfg.data_grid_n + ii[None, :]).reshape(-1)
    X_data = Xd_full[idx]
    u_data = phys.psi_2d(nx, ny, X_data[:, 0], X_data[:, 1], L)

    # OG boundary points: n_boundary per edge
    tb = torch.linspace(0.0, L, cfg.n_boundary, device=dev)
    X_bc = torch.cat([
        torch.stack([tb, torch.zeros_like(tb)], 1),
        torch.stack([tb, torch.full_like(tb, L)], 1),
        torch.stack([torch.zeros_like(tb), tb], 1),
        torch.stack([torch.full_like(tb, L), tb], 1),
    ])

    lower = _lower_states_2d(nx, ny, X, L)
    E = phys.energy_2d(nx, ny, L)
    k_squared = 2.0 * E

    if cfg.method == "WAN":
        w = {
            "data": 10000.0, "pde": 10.0, "drm": 0.0, "orth": 0.0,
            "bc": 10000.0 if cfg.technique == "OG" else 0.0,
            "parity": 1.0, "symmetry": 1.0, "norm": 1000.0,
        }
    else:
        w = {
            "data": 0.0,
            "pde": 10.0 if cfg.method == "PINN" else 0.0,
            "drm": 0.0 if cfg.method == "PINN" else 100.0,
            "orth": 0.0 if cfg.method == "PINN" else 10000.0,
            "bc": 10000.0 if cfg.technique == "OG" else 0.0,
            "parity": 1.0,
            "symmetry": 1.0,
            "norm": 0.0,
        }
    if cfg.weights:
        w.update(cfg.weights)
    sign_x = 1.0 if nx % 2 == 1 else -1.0
    sign_y = 1.0 if ny % 2 == 1 else -1.0

    def reflections(Xa):
        return (Xa.flip(1), torch.stack([L - Xa[:, 0], Xa[:, 1]], 1),
                torch.stack([Xa[:, 0], L - Xa[:, 1]], 1))

    X_swap, X_px, X_py = reflections(X)

    def shared_terms(params, u, Xq=None, dtype="float32"):
        """``Xq``: the quadrature set ``u`` was evaluated at (None = the
        fixed grid).  Under ``grid_jitter`` the jittered lattice is passed,
        so every integral term rides the same forward.  ``dtype='bfloat16'``
        runs the reflected forwards in bf16 (the WAN phases, as in JAX);
        the data and bc terms stay float32."""
        if Xq is None:
            Xs, Xpx, Xpy, low = X_swap, X_px, X_py, lower
        else:
            Xs, Xpx, Xpy = reflections(Xq)
            low = _lower_states_2d(nx, ny, Xq, L) if w["orth"] > 0 else lower
        # one batched forward over the (up to 3) reflected point sets
        refl = torch.cat(([Xs] if nx == ny else []) + [Xpx, Xpy], dim=0)
        u_refl = (model.apply_batch(to_bf16(params), refl.to(torch.bfloat16)).float()
                  if dtype == "bfloat16" else model.apply_batch(params, refl))
        parts = torch.chunk(u_refl, 3 if nx == ny else 2)
        u_sym = parts[0] if nx == ny else None
        u_px, u_py = parts[-2], parts[-1]
        return {
            "data": data_mse(model.apply_batch(params, X_data), u_data),
            "symmetry": reflection_mse(u, u_sym) if nx == ny else zero,
            "parity": (reflection_mse(u, u_px, sign_x)
                       + reflection_mse(u, u_py, sign_y)),
            "orth": orthogonal_projection(u, low, L * L) if w["orth"] > 0 else zero,
            "bc": (torch.mean(model.apply_batch(params, X_bc) ** 2) * 4.0
                   if w["bc"] > 0 else zero),
            "norm": norm_integral(u, L * L) if w["norm"] > 0 else zero,
        }

    # two-pass fused Rayleigh quotient for the DRM branch; weight 2x turns
    # the kernel's 1/2|grad|^2 numerator into the unscaled well convention
    fused_drm = cfg.method == "DRM" and cfg.jet_impl == "fused"
    if fused_drm:
        ray_loss = make_fused_rayleigh(act, weight=2.0 * w["drm"], den_eps=1e-8)
        coef_ray = quotient_coefficients(factor.jet(X))

    def make_loss_terms(dtype):
        """The PINN / DRM objective of one precision phase; ``'bfloat16'``
        rides the torch route (the kernels take float32)."""
        def loss_terms(params):
            if fused_drm and dtype == "float32":
                total_drm, aux = ray_loss(params, X, coef_ray)
                u = model.apply_batch(params, X)
                terms = {"pde": zero, "drm": 2.0 * aux["rayleigh"]}
                terms.update(shared_terms(params, u))
                total = total_drm + sum(w[k] * terms[k] for k in w if k not in ("drm", "pde"))
                return total, terms
            if dtype == "bfloat16":
                p_c, X_c, route, kw = to_bf16(params), X.to(torch.bfloat16), "torch", {}
            else:
                # 'fused' PINN trains on lag_fn; its loss_terms (the polish's
                # objective) takes the torch jet, as JAX's 'pallas-fused' takes
                # its XLA jet
                p_c, X_c, kw = params, X, jet_kw
                route = "torch" if cfg.jet_impl == "fused" else jet_route
            if cfg.method == "PINN":
                jet = model.fields(p_c, X_c, impl=route, **kw)
                u = jet.value.float()
                pde, drm = pinn_helmholtz(u, jet.lap.float(), k_squared), zero
            else:
                u, g = model.value_and_grad(p_c, X_c, impl=route, **kw)
                u = u.float()
                pde, drm = zero, drm_rayleigh_unscaled(u, g.float(), den_eps=1e-8)
            terms = {"pde": pde, "drm": drm}
            terms.update(shared_terms(params, u))
            return sum(w[k] * terms[k] for k in w), terms

        return loss_terms

    loss_terms = make_loss_terms("float32" if cfg.compute_dtype == "hybrid"
                                 else cfg.compute_dtype)

    def loss_fn(params, key):
        return loss_terms(params)

    rms_exact_t = torch.sqrt(torch.mean(u_exact * u_exact))

    def eval_fn(params, key):
        """Plain MSE on the training grid; WAN uses the sign-aware variant.
        ``eval_selfnorm`` scores the unit-normalised iterate (both sides in
        the same discrete grid-norm convention)."""
        u = model.apply_batch(params, X)
        if cfg.eval_selfnorm:
            u = unit_normalize(u, rms_exact_t)
        if cfg.method == "WAN":
            return sign_aware_mse(u, u_exact)
        return torch.mean((u - u_exact) ** 2)

    if cfg.method == "WAN":
        v_model = SolutionModel(NetSpec(tuple(cfg.v_layers), activation="sin"),
                                factor_for_technique("FBC", dim=2, kind="box", L=L))
        v_params = (init_v_params if init_v_params is not None
                    else v_model.init(threefry_fold_in(threefry_key(key), 9)))
        v_params = [(W.to(dev), b.to(dev)) for W, b in v_params]
        multibump = cfg.n_test_grid > 1
        if multibump:
            centers, hw = bump_grid(0.0, L, 2, cfg.n_test_grid)
            centers = centers.to(dev)

            def windows(Xw):
                return bump_w_multi(Xw, centers, hw)       # (K, N), (K, N, 2)
        else:
            def windows(Xw):
                return bump_w(Xw, 0.0, L)
        wv_fix, dwv_fix = windows(X)
        if cfg.grid_jitter:
            # cell-centred lattice base (points strictly inside (0, L)):
            # X_lat + s*h with s ~ U[0,1)^2 is the Cranley-Patterson shifted
            # lattice rule
            h_cell = L / cfg.grid_n
            g_lat = torch.arange(cfg.grid_n, dtype=X.dtype, device=dev) * h_cell
            Xl, Yl = torch.meshgrid(g_lat, g_lat, indexing="ij")
            X_lat = torch.stack([Xl.reshape(-1), Yl.reshape(-1)], -1)

        def net_vg(m, p, Xw, dtype):
            """Value and grad at the phase's dtype (bf16 on the torch route,
            returned as float32)."""
            if dtype == "bfloat16":
                u, g = m.value_and_grad(to_bf16(p), Xw.to(torch.bfloat16))
                return u.float(), g.float()
            return m.value_and_grad(p, Xw, impl=jet_route, **jet_kw)

        def pick(key):
            """Quadrature set and bump windows for this step (the jitter /
            resample / fixed-grid rules)."""
            if cfg.grid_jitter and key is not None:
                s = torch.rand((2,), generator=generator(key, dev), dtype=X.dtype, device=dev)
                Xw = X_lat + s[None, :] * h_cell
                return (Xw, *windows(Xw))
            if cfg.wan_resample and key is not None:
                Xw = torch.rand(X.shape, generator=generator(key, dev), dtype=X.dtype,
                                device=dev) * L
                return (Xw, *windows(Xw))
            return X, wv_fix, dwv_fix

        def wan_pde(u_params, v_params, key=None, ugu=None, dtype="float32"):
            # ``ugu``: optional precomputed (u, grad u) at the fixed grid --
            # the per-epoch critic context (u is frozen across the inner
            # critic steps)
            Xw, wv, dwv = pick(key)
            u, gu = ugu if ugu is not None else net_vg(model, u_params, Xw, dtype)
            v, gv = net_vg(v_model, v_params, Xw, dtype)
            if multibump:
                # one weak residual per localised test function phi_k = w_k v
                phi = wv * v[None, :]                                    # (K, N)
                gphi = dwv * v[None, :, None] + wv[:, :, None] * gv[None, :, :]
                integrand = 0.5 * torch.sum(gu[None] * gphi, dim=-1) - E * u[None, :] * phi
                weak_k = torch.mean(integrand, dim=1)                    # (K,)
                norm_k = torch.mean(phi ** 2, dim=1)                     # (K,)
                return torch.mean(weak_k ** 2 / (norm_k + 1e-8)), u, Xw
            phi = wv * v
            gphi = dwv * v[:, None] + wv[:, None] * gv
            weak = wan_weak_residual(gu, phi, gphi, u=u, E=E, prefactor=0.5)
            return wan_pde_loss(weak, torch.mean(phi ** 2)), u, Xw

        # two-pass fused WAN step: the weak residual and the phi/u masses
        # accumulate in-kernel (pass A), the quotient scalars combine in
        # torch ops on the device, and pass B seeds the reverse sweep.  The
        # parity/symmetry/data/norm terms keep their quadrature rules on the
        # autograd path (they need u forwards at reflected points anyway).
        fused_wan = cfg.jet_impl == "fused"
        fixed_grid = not (cfg.grid_jitter or cfg.wan_resample)
        if fused_wan:
            if multibump:
                pair = make_fused_wan_multi_pair(model, v_model, int(centers.shape[0]),
                                                 w_pde=w["pde"])
            else:
                pair = make_fused_wan_pair(model, v_model, w_pde=w["pde"])
            E_fix = torch.tensor(E, dtype=torch.float32, device=dev)

            # with a fixed quadrature grid the critic's coefficient stream is
            # frozen across the inner critic steps: build it once per epoch
            def fused_context_fn(u_params, key):
                return pair.v_coef_fn(u_params, E_fix, X, wv_fix, dwv_fix)

            def fused_v_loss_fn(v_params, ctx, key):
                # ctx = the per-epoch coefficient stream (fixed grid) or the
                # primal params (jitter/resample: the points, and therefore
                # the u-jet, change per inner step)
                if fixed_grid:
                    lv, _ = pair.v_loss_from_coef(v_params, X, ctx)
                    return lv
                Xw, wv_c, dwv_c = pick(key)
                lv, _ = pair.v_loss_fn(v_params, ctx, E_fix, Xw, wv_c, dwv_c)
                return lv

            def fused_u_loss_fn(u_params, v_params, key):
                Xw, wv_c, dwv_c = pick(key)
                pde_w, aux = pair.u_pde_fn(u_params, E_fix, v_params, Xw, wv_c, dwv_c)
                # u forward for the quadrature terms (jitter rides the
                # lattice, resample keeps the fixed grid)
                if cfg.grid_jitter and not cfg.jitter_anchors_fixed:
                    u, Xq = model.apply_batch(u_params, Xw), Xw
                else:
                    u, Xq = model.apply_batch(u_params, X), None
                terms = {"pde": aux["pde_loss"], "drm": zero}
                terms.update(shared_terms(u_params, u, Xq=Xq))
                total = pde_w + sum(w[k] * terms[k] for k in w if k != "pde")
                return total, terms

        def make_wan_losses(dtype):
            """``(u_loss_fn, v_loss_fn, v_context_fn)`` of one precision
            phase; the fused kernels carry float32 phases only."""
            if fused_wan and dtype == "float32":
                return (fused_u_loss_fn, fused_v_loss_fn,
                        fused_context_fn if fixed_grid else None)
            # the autograd path gets a per-epoch critic context too whenever
            # the grid is fixed: (u, grad u) at X, once per epoch (and at
            # the extragradient lookahead)
            if fixed_grid:
                def v_context_fn(u_params, key):
                    return net_vg(model, u_params, X, dtype)

                def v_loss_fn(v_params, ugu, key):
                    loss_pde, _, _ = wan_pde(None, v_params, None, ugu=ugu, dtype=dtype)
                    return -torch.log(loss_pde + 1e-8)
            else:
                v_context_fn = None

                def v_loss_fn(v_params, u_params, key):
                    loss_pde, _, _ = wan_pde(u_params, v_params, key, dtype=dtype)
                    return -torch.log(loss_pde + 1e-8)

            def u_loss_fn(u_params, v_params, key):
                loss_pde, u_w, Xw = wan_pde(u_params, v_params, key, dtype=dtype)
                if cfg.grid_jitter and cfg.jitter_anchors_fixed:
                    # jittered weak form + fixed-grid anchors
                    u, Xq = model.apply_batch(u_params, X), None
                elif cfg.grid_jitter:
                    # every integral term rides the jittered lattice
                    u, Xq = u_w, Xw
                elif cfg.wan_resample:
                    # iid-uniform points make reflection/norm estimates
                    # noisy: those terms stay on the fixed grid
                    u = (model.apply_batch(to_bf16(u_params), X.to(torch.bfloat16)).float()
                         if dtype == "bfloat16" else model.apply_batch(u_params, X))
                    Xq = None
                else:
                    u, Xq = u_w, None
                terms = {"pde": loss_pde, "drm": zero}
                terms.update(shared_terms(u_params, u, Xq=Xq, dtype=dtype))
                return sum(w[k] * terms[k] for k in w), terms

            return u_loss_fn, v_loss_fn, v_context_fn

        u_opt, v_opt = make_wan_optimizers(
            cfg.lr, v_lr=cfg.v_lr, schedule=cfg.lr_schedule, epochs=cfg.epochs,
            v_steps=cfg.v_steps, decay_steps=cfg.lr_decay_steps,
            final_scale=cfg.lr_final_scale)
        wan_kw = dict(key=fold_in(key, 1), v_steps=cfg.v_steps, u_optimizer=u_opt,
                      v_optimizer=v_opt, chunk=min(chunk, cap), minimax=cfg.minimax,
                      u_ema=cfg.u_ema)
        if cfg.compute_dtype == "hybrid":
            # bf16 bulk, float32 tail from the full carry (both optimizer
            # states, the best iterate, the EMA and the OGDA gradients)
            bulk = int(cfg.epochs * cfg.hybrid_bf16_fraction)
            u16, v16, ctx16 = make_wan_losses("bfloat16")
            r1 = fit_wan(u16, v16, eval_fn, params, v_params, epochs=bulk,
                         v_context_fn=ctx16, compile_only=compile_only, **wan_kw)
            if compile_only:
                return r1
            u32, v32, ctx32 = make_wan_losses("float32")
            r2 = fit_wan(u32, v32, eval_fn, params, v_params, epochs=cfg.epochs - bulk,
                         start_epoch=bulk, init_carry=r1.carry, v_context_fn=ctx32,
                         **wan_kw)
            result = join_phases(r1, r2)
        else:
            u_loss_fn, v_loss_fn, v_context_fn = make_wan_losses(cfg.compute_dtype)
            result = fit_wan(
                u_loss_fn, v_loss_fn, eval_fn, params, v_params, epochs=seg_epochs,
                start_epoch=start_epoch, init_carry=init_carry,
                v_context_fn=v_context_fn, compile_only=compile_only, **wan_kw)
            if compile_only:
                return result
    else:
        optimizer = make_optimizer(
            cfg.lr, schedule=cfg.lr_schedule, total_steps=cfg.epochs,
            decay_steps=cfg.lr_decay_steps, final_scale=cfg.lr_final_scale)
        fused_kw = {}
        if cfg.jet_impl == "fused" and cfg.method == "PINN":
            # one-pass fused loss+grad kernel on the Helmholtz residual
            # r = lap u + k^2 u (u = B*net; coefficients from the factor jet,
            # fixed grid).  (DRM rides the fused Rayleigh objective through
            # loss_terms instead.)
            coef_fused = residual_coefficients(factor.jet(X), a0=1.0, c0=k_squared)

            def lag_fn(p_all, key):
                pde, _, g_pde = fused_linear_residual(p_all, X, coef_fused, act)
                with torch.enable_grad():
                    terms = shared_terms(p_all, model.apply_batch(p_all, X))
                    aux_tot = sum(w[k] * terms[k] for k in terms)
                    leaves = [t for pair in p_all for t in pair]
                    g_aux = torch.autograd.grad(aux_tot, leaves)
                total = w["pde"] * pde + aux_tot.detach()
                grads = [(w["pde"] * gW + g_aux[2 * i], w["pde"] * gb + g_aux[2 * i + 1])
                         for i, (gW, gb) in enumerate(g_pde)]
                metrics = {"pde": pde, "drm": zero}
                metrics.update({k: v.detach() for k, v in terms.items()})
                return (total, metrics), grads

            # the fused kernel carries the float32 phases only: a pure bf16
            # run keeps the bf16 torch route it asked for
            if cfg.compute_dtype != "bfloat16":
                fused_kw = {"loss_and_grad_fn": lag_fn}
        if cfg.compute_dtype == "hybrid":
            # bf16 bulk, float32 tail from the full carry (Adam moments, the
            # schedule's step and the running best continue)
            bulk = int(cfg.epochs * cfg.hybrid_bf16_fraction)
            lt16 = make_loss_terms("bfloat16")
            r1 = fit(lambda p, k: lt16(p), eval_fn, params, epochs=bulk, optimizer=optimizer,
                     key=fold_in(key, 1), chunk=chunk, compile_only=compile_only)
            if compile_only:
                return r1
            r2 = fit(loss_fn, eval_fn, params, epochs=cfg.epochs - bulk, optimizer=optimizer,
                     key=fold_in(key, 1), chunk=chunk, start_epoch=bulk, init_carry=r1.carry,
                     **fused_kw)
            result = join_phases(r1, r2)
        else:
            result = fit(loss_fn, eval_fn, params, epochs=seg_epochs, optimizer=optimizer,
                         start_epoch=start_epoch, init_carry=init_carry,
                         key=fold_in(key, 1), chunk=chunk, compile_only=compile_only,
                         **fused_kw)
            if compile_only:
                return result
        # the polish runs once, after the last segment (per segment it would
        # overwrite the best tracking with a polish the carry does not hold)
        if cfg.LBFGS and start_epoch + seg_epochs == cfg.epochs:
            result = polish(result, lambda p: loss_terms(p)[0], eval_fn, result.params,
                            500, cfg.epochs)

    # relative L2: sqrt(MSE) / rms(psi_exact)
    rms_exact = float(rms_exact_t)
    return {
        "config": dataclasses.asdict(cfg),
        "model": model,
        "result": result,
        "history": result.history,
        "L2_error": float(result.best_metric),
        "rel_l2": float(result.best_metric) ** 0.5 / rms_exact,
        "min_epoch": result.best_epoch,
        "weights": w,
    }
