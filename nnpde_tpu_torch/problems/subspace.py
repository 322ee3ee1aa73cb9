"""Simultaneous multi-eigenstate (subspace) solver.

Counterpart of ``nnpde_tpu/problems/subspace.py``, with the same
:class:`SubspaceConfig` fields and defaults: one k-channel network
(:class:`~nnpde_tpu_torch.models.ChannelSolutionModel`) learns the k lowest
eigenpairs of ``H = -1/2 Δ + V`` in a single run by minimising the
Gram-metric trace over the subspace it spans,

    A_ij = mean[ 1/2 grad(u_i).grad(u_j) + V u_i u_j ]      (stiffness)
    G_ij = mean[ u_i u_j ]                                  (Gram)
    loss = tr(G^{-1} A) + ortho_weight * mean((G - I)^2)

(Ky Fan: the minimum of ``tr(G^{-1}A)`` over k-dimensional subspaces is the
sum of the k lowest eigenvalues).  The trace is rotation-invariant; the
individual eigenpairs come from the k x k generalized problem ``A Y = G Y
diag(lam)`` afterwards (:func:`subspace_eigenpairs`).

The jets run on the device in float32 (the forward-Laplacian recurrence
for all k channels at once; no kernel), the k x k Cholesky on the device
too.  A Cholesky that fails gives NaN, as JAX's does: the factor of
``torch.linalg.cholesky_ex`` is replaced by NaN where its ``info`` is
non-zero, on the device, so the check costs no host sync and a
non-positive-definite Gram can never report a finite trace.  The report of
:func:`evaluate_subspace` is float64 on the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import runtime
from ..models import NetSpec, factor_for_technique
from ..models.mlp import init_mlp
from ..models.solution import ChannelSolutionModel
from ..pde import ipw as ipw_phys
from ..pde import kh as kh_phys
from ..pde import qho as qho_phys
from ..sampling import linspace_grid, meshgrid_2d
from ..train import fit
from ..train.optim import ScheduledAdam, constant_schedule, cosine_decay_schedule
from .ipw import on_device


# --------------------------------------------------------------- assembly
def subspace_matrices(value, grad, V=None, *, prefactor: float = 0.5):
    """(A, G) from per-channel fields on a quadrature batch.

    ``value``: (N, k); ``grad``: (N, d, k); ``V``: (N,) or None.  Means
    over the batch approximate (1/Vol) * integrals; the common 1/Vol
    cancels in every generalized-eigen quantity downstream."""
    N = value.shape[0]
    G = value.T @ value / N
    A = prefactor * torch.einsum("ndi,ndj->ij", grad, grad) / N
    if V is not None:
        A = A + (value * V[:, None]).T @ value / N
    return 0.5 * (A + A.T), 0.5 * (G + G.T)


def _cholesky(M):
    """Lower Cholesky factor of ``M``, all NaN where the factorization
    fails (``jnp.linalg.cholesky``'s contract), with no host sync."""
    L, info = torch.linalg.cholesky_ex(M, check_errors=False)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def subspace_trace(A, G, *, ridge: float = 1e-6):
    """``tr(G^{-1} A)`` via Cholesky, with the RELATIVE ridge ``ridge *
    tr(G)/k`` (an absolute one means nothing when the channel scale
    drifts).  No eigendecomposition on the gradient path: eigh's
    derivatives blow up at degeneracies.  A and G are PSD, so the ridged
    trace cannot go negative; a failed factor gives NaN."""
    k = G.shape[0]
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    L = _cholesky(G + (ridge * _trace(G) / k) * eye)
    return _trace(torch.cholesky_solve(A, L, upper=False))


def _trace(M):
    """``tr(M)`` as the diagonal's sum: ``torch.trace``'s backward fills
    through ``index_fill_``, which reads the gradient on the host."""
    return torch.diagonal(M).sum()


def subspace_eigenpairs(A, G, *, ridge: float = 1e-9):
    """Solve the k x k generalized problem A Y = G Y diag(lam).

    Returns (lam ascending, Y) with Y G-orthonormal: ``u @ Y`` are the
    individual eigenfunctions."""
    k = G.shape[0]
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    L = _cholesky(G + ridge * eye)
    Li = torch.linalg.solve_triangular(L, eye, upper=False)
    M = Li @ A @ Li.T
    lam, Q = torch.linalg.eigh(0.5 * (M + M.T))
    return lam, Li.T @ Q


# ------------------------------------------------------------------ config
@dataclasses.dataclass
class SubspaceConfig:
    problem: str = "qho"        # 'qho' (window, V=x^2/2) | 'ipw' (box, V=0)
                                # | 'kh' (window, cycle-averaged KH well;
                                #   spectrum/states from the FD eigensolver)
    k: int = 4                  # number of simultaneous eigenstates
    dim: int = 1                # 1 | 2 (tensor-product quadrature grid)
    x_max: float = 6.0          # QHO window half-width; IPW box length L
    epochs: int = 8000
    lr: float = 1e-3
    lr_schedule: str = "cosine"
    width: int = 64
    depth: int = 3
    grid_n: int = 600           # quadrature points per dimension
    eval_grid_n: int = 2000     # dense grid for the final host-side report
    ortho_weight: float = 100.0
    whiten_floor: float = 0.1
    ridge: float = 1e-6
    seed: int = 0
    chunk: int = 1000
    alpha: float = 10.0         # KH only: laser quiver amplitude alpha_0
    fd_grid_n: int = 5000       # KH only: FD ground-truth resolution


def _setup(cfg: SubspaceConfig, device="cpu"):
    """(model, X on ``device``, V(X) or None, (lo, hi))."""
    if cfg.problem == "qho":
        factor = factor_for_technique("OG", dim=cfg.dim, kind="window", L=cfg.x_max)
        lo, hi = -cfg.x_max, cfg.x_max
        if cfg.dim == 1:
            def V(X):
                return qho_phys.potential_1d(X[:, 0])
        else:
            def V(X):
                return qho_phys.potential_2d(X[:, 0], X[:, 1])
    elif cfg.problem == "ipw":
        factor = factor_for_technique("FBC", dim=cfg.dim, kind="box", L=cfg.x_max)
        lo, hi = 0.0, cfg.x_max
        V = None
    elif cfg.problem == "kh":
        # the cycle-averaged KH well on [-L, L], the Dirichlet box of the FD
        # ground truth; 1D only (non-degenerate levels, 1D scoring path)
        if cfg.dim != 1:
            raise ValueError("KH subspace solver is 1D")
        factor = factor_for_technique("OG", dim=1, kind="window", L=cfg.x_max)
        lo, hi = -cfg.x_max, cfg.x_max

        def V(X):
            return kh_phys.v_kh_avg(X[:, 0], alpha0=cfg.alpha)
    else:
        raise ValueError(f"unknown subspace problem {cfg.problem!r}")
    if cfg.dim == 1:
        X = linspace_grid(cfg.grid_n + 2, lo, hi, device=device)[1:-1]
    elif cfg.dim == 2:
        X = meshgrid_2d(cfg.grid_n, lo, hi, device=device)
    else:
        raise ValueError("subspace solver supports dim 1 or 2")
    layers = (cfg.dim,) + (cfg.width,) * cfg.depth + (cfg.k,)
    model = ChannelSolutionModel(NetSpec(layers), factor=factor)
    return model, X, V, (lo, hi)


def _kh_fd_truth(x_max: float, fd_grid_n: int, alpha: float, k: int):
    """FD ground truth for the KH subspace run (cached per config key): the
    same operator, Dirichlet box and cycle-averaged potential as the loss."""
    key = (float(x_max), int(fd_grid_n), float(alpha), int(k))
    hit = _KH_FD_CACHE.get(key)
    if hit is None:
        hit = kh_phys.reference_eigensystem(L=x_max, N=fd_grid_n, alpha=alpha, k_max=k)
        _KH_FD_CACHE[key] = hit
    return hit


_KH_FD_CACHE: Dict[tuple, tuple] = {}


def _exact_spectrum(cfg: SubspaceConfig) -> np.ndarray:
    """The k lowest exact levels (with multiplicity, for the 2D spectra)."""
    if cfg.dim == 1:
        if cfg.problem == "qho":
            return np.array([qho_phys.energy_1d(n) for n in range(cfg.k)])
        if cfg.problem == "kh":
            return np.asarray(_kh_fd_truth(cfg.x_max, cfg.fd_grid_n, cfg.alpha, cfg.k)[1],
                              np.float64)
        return np.array([ipw_phys.energy_1d(n + 1, cfg.x_max) for n in range(cfg.k)])
    pairs = []
    for nx in range(cfg.k + 2):
        for ny in range(cfg.k + 2):
            if cfg.problem == "qho":
                pairs.append(qho_phys.energy_2d(nx, ny))
            else:
                pairs.append(ipw_phys.energy_2d(nx + 1, ny + 1, cfg.x_max))
    return np.sort(np.array(pairs))[: cfg.k]


def _exact_states(cfg: SubspaceConfig, X: np.ndarray) -> Optional[np.ndarray]:
    """(N, k) exact eigenfunctions on the host where the level ordering is
    unambiguous (1D); None in 2D (degenerate spectra: see
    :func:`_exact_state_groups_2d`).  The analytic states are evaluated at
    the grid's own precision; the KH states are the FD eigenvectors
    interpolated onto the grid (``state_rel_l2`` renormalises both)."""
    if cfg.dim != 1:
        return None
    x = X[:, 0]
    if cfg.problem == "kh":
        xg, _, psi = _kh_fd_truth(cfg.x_max, cfg.fd_grid_n, cfg.alpha, cfg.k)
        cols = [np.interp(np.asarray(x, np.float64), xg, psi[:, n]) for n in range(cfg.k)]
    else:
        xt = torch.as_tensor(x)
        if cfg.problem == "qho":
            cols = [qho_phys.psi_1d(n, xt).numpy() for n in range(cfg.k)]
        else:
            cols = [ipw_phys.psi_1d(n + 1, xt, cfg.x_max).numpy() for n in range(cfg.k)]
    return np.stack(cols, axis=1)


def _exact_state_groups_2d(cfg: SubspaceConfig, X: np.ndarray):
    """Degenerate clusters of the 2D spectrum with their exact bases: a list
    of ``(i0, i1, energy, P)``, levels [i0, i1) of the sorted spectrum
    sharing ``energy``, ``P`` the (N, i1-i0) float64 stack of the cluster's
    product eigenfunctions on ``X``.  A cluster that the ``k`` cut would
    slice is returned whole (the learned columns must still lie inside the
    full degenerate subspace)."""
    xt, yt = torch.as_tensor(X[:, 0]), torch.as_tensor(X[:, 1])
    pairs = []
    for nx in range(cfg.k + 2):
        for ny in range(cfg.k + 2):
            if cfg.problem == "qho":
                E = qho_phys.energy_2d(nx, ny)
                psi = qho_phys.psi_2d(nx, ny, xt, yt)
            else:
                E = ipw_phys.energy_2d(nx + 1, ny + 1, cfg.x_max)
                psi = ipw_phys.psi_2d(nx + 1, ny + 1, xt, yt, cfg.x_max)
            pairs.append((float(E), psi.numpy().astype(np.float64)))
    pairs.sort(key=lambda t: t[0])
    groups, i = [], 0
    while i < min(cfg.k, len(pairs)):
        j = i
        while j < len(pairs) and np.isclose(pairs[j][0], pairs[i][0], rtol=1e-9, atol=1e-9):
            j += 1
        groups.append((i, j, pairs[i][0], np.stack([p for _, p in pairs[i:j]], axis=1)))
        i = j
    return groups


def subspace_group_scores(U: np.ndarray, groups, k: int):
    """Principal-angle validation of learned states against degenerate
    exact subspaces: for each cluster, QR of the learned columns
    ``U[:, i0:min(i1, k)]`` and of the exact basis, the SVD of their
    cross-Gram; ``sin_max = sqrt(1 - cos_min^2)`` is the largest angle
    between the learned span and the exact subspace (0 iff inside it,
    gauge-free under rotations within the cluster)."""
    out = []
    for i0, i1, E, P in groups:
        Ug = U[:, i0:min(i1, k)]
        Qu, _ = np.linalg.qr(Ug)
        Qp, _ = np.linalg.qr(P)
        s = np.linalg.svd(Qu.T @ Qp, compute_uv=False)
        cos_min = float(np.clip(s[: Ug.shape[1]].min(), 0.0, 1.0))
        out.append({
            "levels": [int(i0), int(min(i1, k))],
            "energy": float(E),
            "degeneracy": int(i1 - i0),
            "n_learned": int(Ug.shape[1]),
            "sin_max": float(np.sqrt(max(0.0, 1.0 - cos_min**2))),
        })
    return out


# ------------------------------------------------------- init transforms
def normalize_input_layer(params, lo: float, hi: float, *, half_width: float = 4.0):
    """Rescale the FIRST layer at init so the domain maps to [-half_width,
    half_width] as seen by the sin units (on a small box such as IPW's [0,
    1] Xavier-init sin units are nearly linear and the hidden basis nearly
    rank 2): ``W0' = s W0``, ``b0' = b0 - mid s sum(W0)`` realises
    ``net((x - mid) s)`` in the same parameter class."""
    s = 2.0 * half_width / (hi - lo)
    mid = 0.5 * (lo + hi)
    W0, b0 = params[0]
    return [(W0 * s, b0 - mid * s * W0.sum(0))] + list(params[1:])


@torch.no_grad()
def whiten_output_layer(model, params, X, *, floor: float = 1e-2):
    """SOFT-whiten the output layer so the channel Gram starts
    well-conditioned: with ``L L^T = G + floor tr(G)/k I`` the output layer
    becomes ``(W L^{-T}, b L^{-T})``.  The floor caps the amplification of
    the Gram's noise directions at ~sqrt(1/floor).  One k x k Cholesky on
    the device, at init."""
    val = model.apply_batch(params, X)
    G = val.T @ val / val.shape[0]
    k = G.shape[0]
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    L = _cholesky(G + floor * (_trace(G) / k) * eye)
    Lit = torch.linalg.solve_triangular(L, eye, upper=False).T
    W_last, b_last = params[-1]
    return list(params[:-1]) + [(W_last @ Lit, b_last @ Lit)]


# ---------------------------------------------------------------- training
def train_subspace(cfg: SubspaceConfig, *, progress=None, init_params=None,
                   device="cuda") -> Dict:
    """One training run -> the k lowest eigenpairs.

    Returns :func:`evaluate_subspace`'s report on the best parameters with
    ``best_epoch``, ``best_sum_lambda`` (the best ridged trace), ``timing``,
    ``history``, ``best_params`` and ``result``, the JAX entry point's
    keys.  The raw net before the two init transforms is the JAX package's
    for ``cfg.seed`` (:func:`~nnpde_tpu_torch.models.mlp.init_mlp`:
    which basin a run settles in is set by its initial weights, and the
    JAX package's bars were set on its own), or ``init_params``;
    ``progress(epoch, metrics)`` is called once per ``chunk``."""
    dev = runtime.resolve_device(device)
    runtime.pin_fp32_precision()
    model, X, V, (lo, hi) = _setup(cfg, dev)
    Vx = V(X) if V is not None else None
    eye = torch.eye(cfg.k, dtype=X.dtype, device=dev)

    def matrices(params):
        jet = model.fields(params, X)
        return subspace_matrices(jet.value, jet.grad, Vx, prefactor=0.5)

    def loss_fn(params, key):
        A, G = matrices(params)
        trace = subspace_trace(A, G, ridge=cfg.ridge)
        ortho = torch.mean((G - eye) ** 2)
        return trace + cfg.ortho_weight * ortho, {"trace": trace, "ortho": ortho}

    def eval_fn(params, key):
        # the variational objective itself: lower is better, needs no
        # ground truth, and cannot go negative
        A, G = matrices(params)
        return subspace_trace(A, G, ridge=cfg.ridge)

    sched = (cosine_decay_schedule(cfg.lr, cfg.epochs) if cfg.lr_schedule == "cosine"
             else constant_schedule(cfg.lr))
    params = on_device(init_params if init_params is not None
                       else init_mlp(cfg.seed, model.spec), dev)
    params = normalize_input_layer(params, lo, hi)
    params = whiten_output_layer(model, params, X, floor=cfg.whiten_floor)
    res = fit(loss_fn, eval_fn, params, epochs=cfg.epochs, optimizer=ScheduledAdam(sched),
              key=cfg.seed + 1, chunk=cfg.chunk, progress=progress)

    report = evaluate_subspace(cfg, model, res.best_params)
    report["best_epoch"] = res.best_epoch
    report["best_sum_lambda"] = res.best_metric
    report["timing"] = res.timing
    report["history"] = res.history
    report["best_params"] = res.best_params
    report["result"] = res
    return report


@torch.no_grad()
def evaluate_subspace(cfg: SubspaceConfig, model, params) -> Dict:
    """Rotate the trained channels into individual eigenfunctions and score
    them against the exact spectrum and states on the dense grid.  The jets
    run on the parameters' device in float32; the k x k algebra is float64
    on the host (the f32 accumulation floor, ~5e-4 relative on the
    integrals, would quantise a converged net's eigenvalues)."""
    dev = params[0][0].device
    _, Xd, Vd_fn, _ = _setup(dataclasses.replace(cfg, grid_n=cfg.eval_grid_n), dev)
    Vd = Vd_fn(Xd).cpu().numpy().astype(np.float64) if Vd_fn is not None else None
    jet = model.fields(params, Xd)
    val = jet.value.cpu().numpy().astype(np.float64)
    grad = jet.grad.cpu().numpy().astype(np.float64)
    Xh = Xd.cpu().numpy()
    N = val.shape[0]
    G = val.T @ val / N
    A = 0.5 * np.einsum("ndi,ndj->ij", grad, grad) / N
    if Vd is not None:
        A = A + (val * Vd[:, None]).T @ val / N
    A, G = 0.5 * (A + A.T), 0.5 * (G + G.T)
    L = np.linalg.cholesky(G + 1e-12 * np.eye(cfg.k))
    Li = np.linalg.inv(L)
    M = Li @ A @ Li.T
    lam, Q = np.linalg.eigh(0.5 * (M + M.T))
    U = val @ (Li.T @ Q)                               # (N, k) eigenfunctions

    exact = _exact_spectrum(cfg)
    abs_err = np.abs(lam - exact)
    rel_err = abs_err / np.maximum(np.abs(exact), 1e-12)
    out: Dict = {
        "eigenvalues": lam.tolist(),
        "exact": exact.tolist(),
        "eig_abs_err": abs_err.tolist(),
        "eig_rel_err": rel_err.tolist(),
        "max_eig_rel_err": float(np.max(rel_err)),
    }
    psi = _exact_states(cfg, Xh)
    if cfg.dim == 1:
        # dense-grid states for post-processing; private key, never serialised
        out["_states"] = (Xh[:, 0], U, Vd, psi)
    if psi is not None:
        rels = []
        for m in range(cfg.k):
            u = U[:, m] / (np.linalg.norm(U[:, m]) + 1e-30)
            p = psi[:, m] / (np.linalg.norm(psi[:, m]) + 1e-30)
            rels.append(float(min(np.linalg.norm(u - p), np.linalg.norm(u + p))))
        out["state_rel_l2"] = rels
        out["max_state_rel_l2"] = float(np.max(rels))
    elif cfg.dim == 2:
        scores = subspace_group_scores(U, _exact_state_groups_2d(cfg, Xh), cfg.k)
        out["subspace_groups"] = scores
        out["max_subspace_sin"] = float(max(s["sin_max"] for s in scores))
    return out
