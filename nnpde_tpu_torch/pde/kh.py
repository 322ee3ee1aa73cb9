"""Kramers-Henneberger (laser-dressed soft-core atom) physics and its
finite-difference ground truth.

Counterpart of ``nnpde_tpu/pde/kh.py``, with the same functions and
defaults:

* the soft-core potential ``V(x) = V0 exp(-sqrt(x^2+16)) / sqrt(x^2 +
  6.27^2)`` and its shifted and cycle-averaged KH forms (the average by an
  endpoint-inclusive ``n_theta``-point theta quadrature), on torch tensors
  or numpy arrays;
* the float64 host eigensolver of ``H = -1/2 d2/dx2 + V`` on ``[-L, L]``
  with Dirichlet ends (tridiagonal stencil; the native bisection of
  ``native/tridiag_eigh.cpp`` through :mod:`nnpde_tpu_torch.native`, then
  ``scipy.linalg.eigh_tridiagonal``, then dense numpy);
* the Fourier components of the oscillating potential and the Floquet
  quasi-energy eigensystem of the time-dependent atom (scipy, host);
* the ground-truth containers, whose arrays live on the device as float32
  tensors: ``resample`` interpolates onto a new grid on the device
  (:func:`interp`, the counterpart of ``jnp.interp``) and re-evaluates V.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import native, runtime

V0_DEFAULT = -24.856
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


# ------------------------------------------------------------------ potentials
def v_base(x, v0: float = V0_DEFAULT):
    """Short-range bare soft-core potential (torch tensors or numpy arrays)."""
    xp = _xp(x)
    return v0 * xp.exp(-xp.sqrt(x * x + 16.0)) / xp.sqrt(x * x + 6.27**2)


def v_kh_shift(x, alpha: float = 0.0, v0: float = V0_DEFAULT):
    return v_base(x + alpha, v0)


def v_kh_avg(x, alpha0: float = 0.0, v0: float = V0_DEFAULT, n_theta: int = 500):
    """Cycle-averaged potential on the endpoint-inclusive uniform theta grid
    of the reference (value parity with it)."""
    if alpha0 == 0.0:
        return v_base(x, v0)
    if isinstance(x, torch.Tensor):
        theta = torch.linspace(0.0, 2.0 * math.pi, n_theta, dtype=x.dtype, device=x.device)
        shifts = alpha0 * torch.sin(theta)
    else:
        shifts = alpha0 * np.sin(np.linspace(0.0, 2.0 * math.pi, n_theta))
    vmat = v_base(x[..., None] + shifts[None, ...], v0)
    return vmat.mean(axis=-1)


def v_kh(x, alpha: float = 0.0, v0: float = V0_DEFAULT, use_avg: bool = True,
         n_theta: int = 500):
    return (v_kh_avg(x, alpha0=alpha, v0=v0, n_theta=n_theta) if use_avg
            else v_kh_shift(x, alpha=alpha, v0=v0))


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` on torch tensors: piecewise-linear
    interpolation of ``(xp, fp)`` (``xp`` increasing) at ``x``, held at
    ``fp[0]`` below ``xp[0]`` and at ``fp[-1]`` above ``xp[-1]``; the
    segment found by ``torch.searchsorted`` (right side), the same
    arithmetic as JAX's."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # JAX's np.spacing(finfo(dtype).eps), a segment of zero width
    tiny = float(np.spacing(np.finfo(_NP_DTYPE[xp.dtype]).eps))
    flat = torch.abs(dx) <= tiny
    f = torch.where(flat, fp[i - 1], fp[i - 1] + (delta / torch.where(flat, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


# ------------------------------------------------- finite-difference eigensolve
def reference_eigensystem(L: float = 10.0, N: int = 2000, alpha: float = 0.0,
                          v0: float = V0_DEFAULT, k_max: int = 10, use_avg: bool = True,
                          n_theta: int = 500):
    """First ``k_max`` eigenpairs of ``H = -1/2 d2/dx2 + V`` on ``[-L, L]``,
    Dirichlet: the [1, -2, 1]/dx^2 stencil on the N-2 interior points, the
    boundary zeros re-embedded, trapezoid-normalised.  Float64 on the host;
    returns numpy ``(x (N,), E (k_max,), psi (N, k_max))``."""
    x = np.linspace(-L, L, N, dtype=np.float64)
    dx = (2.0 * L) / (N - 1)
    x_int = x[1:-1]
    v_int = np.asarray(v_kh(x_int, alpha=alpha, v0=v0, use_avg=use_avg, n_theta=n_theta),
                       dtype=np.float64)
    diag = 1.0 / dx**2 + v_int
    offd = np.full(N - 3, -0.5 / dx**2, dtype=np.float64)

    out = native.tridiag_eigh(diag, offd, k_max)
    if out is not None:
        evals, evecs = out
    else:
        try:
            from scipy.linalg import eigh_tridiagonal

            evals, evecs = eigh_tridiagonal(diag, offd, select="i",
                                            select_range=(0, k_max - 1))
        except ImportError:  # pragma: no cover - scipy is present where this runs
            H = np.diag(diag) + np.diag(offd, 1) + np.diag(offd, -1)
            evals_all, evecs_all = np.linalg.eigh(H)
            evals, evecs = evals_all[:k_max], evecs_all[:, :k_max]

    psi = np.zeros((N, k_max), dtype=np.float64)
    psi[1:-1, :] = evecs
    w = np.ones(N, dtype=np.float64)
    w[0] = w[-1] = 0.5
    norms = np.sqrt(dx * np.sum(w[:, None] * psi**2, axis=0))
    return x, evals[:k_max], psi / norms[None, :]


def v_fourier_components(x, alpha0: float, v0: float = V0_DEFAULT, j_max: int = 4,
                         n_theta: int = 512):
    """``c_j(x) = (1/2pi) int_0^{2pi} V(x + alpha0 sin th) e^{-i j th} dth``
    for ``j = 0..j_max`` on a uniform periodic theta grid (spectrally
    accurate); even j real, odd j imaginary, ``c_0`` the cycle average.
    Returns ``(cr, ci)`` float64 numpy arrays of shape ``(j_max + 1,
    len(x))``."""
    x = np.asarray(x, np.float64)
    theta = 2.0 * math.pi * np.arange(n_theta) / n_theta
    f = np.asarray(v_base(x[:, None] + alpha0 * np.sin(theta)[None, :], v0), np.float64)
    j = np.arange(j_max + 1)
    ph = np.exp(-1j * j[:, None] * theta[None, :])
    c = (ph @ f.T) / n_theta
    return np.real(c), np.imag(c)


def floquet_eigensystem(L: float = 60.0, N: int = 2000, alpha: float = 10.0,
                        omega: float = 5.0, M: int = 2, k_max: int = 4,
                        v0: float = V0_DEFAULT, n_theta: int = 512,
                        sigma: float | None = None):
    """FD Floquet quasi-energy eigensystem of the time-dependent KH atom,
    harmonics ``|m| <= M``: the complex-Hermitian block system solved by
    shift-invert ``scipy.sparse.linalg.eigsh`` near the cycle-averaged
    ground energy, the physical branch picked by the overlap of each
    candidate's m = 0 harmonic with the averaged levels.  Returns ``(x (N,),
    eps (k,), Phi (N, 2M+1, k) complex128)``, ``sum_m int |phi_m|^2 = 1``
    (trapezoid), each state's largest sample real-positive."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    x = np.linspace(-L, L, N, dtype=np.float64)
    dx = (2.0 * L) / (N - 1)
    x_int = x[1:-1]
    Ni = N - 2
    C = 2 * M + 1
    cr, ci = v_fourier_components(x_int, alpha0=alpha, v0=v0, j_max=max(1, 2 * M),
                                  n_theta=n_theta)

    def c_j(j: int) -> np.ndarray:
        """Complex component c_j for any signed j (c_{-j} = conj(c_j))."""
        if abs(j) > cr.shape[0] - 1:
            return np.zeros(Ni, np.complex128)
        v = cr[abs(j)] + 1j * ci[abs(j)]
        return v if j >= 0 else np.conj(v)

    kin = sp.diags([np.full(Ni, 1.0 / dx**2), np.full(Ni - 1, -0.5 / dx**2),
                    np.full(Ni - 1, -0.5 / dx**2)], [0, 1, -1], format="csr",
                   dtype=np.complex128)
    blocks = []
    for a in range(C):
        row = []
        for b in range(C):
            blk = sp.diags(c_j(a - b), 0, shape=(Ni, Ni), dtype=np.complex128)
            if a == b:
                blk = blk + kin + sp.identity(Ni, np.complex128) * ((a - M) * omega)
            row.append(blk)
        blocks.append(row)
    H = sp.bmat(blocks, format="csc")

    _, E_avg, psi_avg = reference_eigensystem(L=L, N=N, alpha=alpha, v0=v0, k_max=k_max,
                                              use_avg=True, n_theta=n_theta)
    if sigma is None:
        sigma = float(E_avg[0]) - 0.05
    n_search = min(H.shape[0] - 2, max(8 * k_max, 24))
    evals, evecs = spla.eigsh(H, k=n_search, sigma=sigma, which="LM")

    Phi_all = np.zeros((N, C, n_search), np.complex128)
    Phi_all[1:-1, :, :] = evecs.reshape(C, Ni, n_search).transpose(1, 0, 2)
    w = np.ones(N, np.float64)
    w[0] = w[-1] = 0.5
    nrm = np.sqrt(dx * np.einsum("x,xmk->k", w, np.abs(Phi_all) ** 2))
    Phi_all = Phi_all / nrm[None, None, :]
    ov = np.abs(dx * np.einsum("x,xn,xk->nk", w, psi_avg[:, :k_max], Phi_all[:, M, :]))
    sel, used = [], set()
    for nlev in range(k_max):
        for cand in np.argsort(-ov[nlev]):
            if cand not in used:
                sel.append(cand)
                used.add(cand)
                break
    sel = np.asarray(sel)
    evals, Phi = evals[sel], Phi_all[:, :, sel]
    norms = np.sqrt(dx * np.einsum("x,xmk->k", w, np.abs(Phi) ** 2))
    Phi = Phi / norms[None, None, :]
    flat = Phi.reshape(N * C, k_max)
    peak = flat[np.argmax(np.abs(flat), axis=0), np.arange(k_max)]
    return x, evals, Phi * np.conj(peak / np.abs(peak))[None, None, :]


class FloquetGroundTruth:
    """Dense-grid Floquet ground truth: ``x``, quasi-energies ``eps``, the
    harmonic eigenfunctions ``Phi_re``, ``Phi_im`` (N, 2M+1, k) as float32
    device tensors, and the per-grid harmonic coupling tables."""

    def __init__(self, *, alpha: float = 2.0, omega: float = 0.3, v0: float = V0_DEFAULT,
                 L: float = 30.0, N: int = 2000, M: int = 2, n_levels: int = 2,
                 n_theta: int = 512, device="cuda"):
        dev = runtime.resolve_device(device)
        x, eps, Phi = floquet_eigensystem(L=L, N=N, alpha=alpha, omega=omega, M=M,
                                          k_max=max(n_levels, 1), v0=v0, n_theta=n_theta)
        f32 = dict(dtype=torch.float32, device=dev)
        self.device = dev
        self.x = torch.as_tensor(x, **f32)
        self.eps = torch.as_tensor(eps[:n_levels], **f32)
        self.Phi_re = torch.as_tensor(np.real(Phi[:, :, :n_levels]), **f32)
        self.Phi_im = torch.as_tensor(np.imag(Phi[:, :, :n_levels]), **f32)
        self.alpha, self.omega, self.v0 = float(alpha), float(omega), float(v0)
        self.L, self.N, self.M = float(L), int(N), int(M)
        self.C = 2 * M + 1
        self.n_levels, self.n_theta = int(n_levels), int(n_theta)

    def energy(self, n: int) -> float:
        return float(self.eps[n])

    def coupling_matrices(self, x_new):
        """(P, Q) float32 (len(x), C, C) with ``P + iQ = c_{a-b}(x)``."""
        x_np = (x_new.detach().cpu().numpy() if isinstance(x_new, torch.Tensor)
                else np.asarray(x_new)).astype(np.float64)
        cr, ci = v_fourier_components(x_np, alpha0=self.alpha, v0=self.v0, j_max=2 * self.M,
                                      n_theta=self.n_theta)
        C = self.C
        P = np.zeros((len(x_np), C, C))
        Q = np.zeros((len(x_np), C, C))
        for a in range(C):
            for b in range(C):
                j = a - b
                P[:, a, b] = cr[abs(j)]
                Q[:, a, b] = ci[abs(j)] if j >= 0 else -ci[abs(j)]
        f32 = dict(dtype=torch.float32, device=self.device)
        return torch.as_tensor(P, **f32), torch.as_tensor(Q, **f32)

    def resample(self, x_new):
        """(Phi_re, Phi_im) (M_pts, C, n_levels) interpolated onto x_new."""
        def part(Phi):
            return torch.stack([torch.stack([interp(x_new, self.x, Phi[:, m, k])
                                             for m in range(self.C)], dim=1)
                                for k in range(self.n_levels)], dim=2)

        return part(self.Phi_re), part(self.Phi_im)


class KHGroundTruth:
    """Dense-grid ground truth: ``x``, ``V(x)``, eigenvalues ``E`` and
    eigenfunctions ``psi``, float32 tensors on the device; ``resample``
    interpolates psi onto a new grid on the device (:func:`interp`) and
    re-evaluates V exactly."""

    def __init__(self, *, alpha: float = 0.0, v0: float = V0_DEFAULT, L: float = 10.0,
                 N: int = 4000, n_levels: int = 5, use_avg: bool = True, n_theta: int = 500,
                 device="cuda"):
        dev = runtime.resolve_device(device)
        x, E, psi = reference_eigensystem(L=L, N=N, alpha=alpha, v0=v0,
                                          k_max=max(n_levels, 1), use_avg=use_avg,
                                          n_theta=n_theta)
        vx = v_kh(x, alpha=alpha, v0=v0, use_avg=use_avg, n_theta=n_theta)
        f32 = dict(dtype=torch.float32, device=dev)
        self.device = dev
        self.x = torch.as_tensor(x, **f32)
        self.V = torch.as_tensor(vx, **f32)
        self.E = torch.as_tensor(E[:n_levels], **f32)
        self.psi = torch.as_tensor(psi[:, :n_levels], **f32)
        self.alpha, self.v0, self.L = float(alpha), float(v0), float(L)
        self.N, self.n_levels = int(N), int(n_levels)
        self.use_avg, self.n_theta = bool(use_avg), int(n_theta)

    def energy(self, n: int) -> float:
        return float(self.E[n])

    def wavefunction(self, n: int):
        return self.psi[:, n]

    def level(self, n: int):
        return {"x": self.x, "V": self.V, "E": self.energy(n), "psi": self.psi[:, n]}

    def resample(self, x_new):
        """(x_new, V(x_new), psi resampled (M, n_levels)), on the device."""
        v_new = v_kh(x_new, alpha=self.alpha, v0=self.v0, use_avg=self.use_avg,
                     n_theta=self.n_theta)
        psi_new = torch.stack([interp(x_new, self.x, self.psi[:, k])
                               for k in range(self.n_levels)], dim=1)
        return x_new, v_new, psi_new
