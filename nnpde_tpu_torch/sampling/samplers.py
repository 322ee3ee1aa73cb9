"""Collocation samplers on an explicit ``torch.Generator``.

Counterpart of ``nnpde_tpu/sampling/samplers.py``.  Uniform draws come from
the generator's device; the scrambled Sobol base set comes from the same
host-side ``scipy.stats.qmc.Sobol(scramble=True, seed=seed)`` call as the
JAX package, so QMC base sets agree bit for bit.
"""

from __future__ import annotations

import torch

from ..pde.domain import Box


def _to_box(u, box: Box):
    """``lo + u * (hi - lo)`` per column, with the bounds as Python numbers:
    no host-to-device copy (a copy from the host waits for the device)."""
    return torch.stack([lo + u[:, i] * (hi - lo)
                        for i, (lo, hi) in enumerate(zip(box.lo, box.hi))], dim=1)


def uniform_box(gen: torch.Generator, n: int, box: Box, dtype=torch.float32):
    """n uniform points in the box — (n, d), on the generator's device."""
    u = torch.rand((n, box.dim), generator=gen, dtype=dtype, device=gen.device)
    return _to_box(u, box)


def sobol_unit(seed: int, n: int, d: int, dtype=torch.float32, device="cpu"):
    """n scrambled-Sobol points in the unit cube [0,1)^d — (n, d)."""
    from scipy.stats import qmc

    eng = qmc.Sobol(d=d, scramble=True, seed=seed)
    return torch.as_tensor(eng.random(n), dtype=dtype, device=device)


def sobol_box(seed: int, n: int, box: Box, dtype=torch.float32, device="cpu"):
    """n scrambled-Sobol quasi-Monte-Carlo points in the box — (n, d)."""
    return _to_box(sobol_unit(seed, n, box.dim, dtype, device), box)


def shifted_qmc(u_base, gen: torch.Generator, box: Box):
    """Cranley-Patterson rotation ``(u_base + shift) mod 1`` of a fixed
    Sobol base set with a fresh uniform shift per call."""
    shift = torch.rand((u_base.shape[-1],), generator=gen,
                       dtype=u_base.dtype, device=u_base.device)
    return _to_box(torch.remainder(u_base + shift, 1.0), box)


def linspace_grid(n: int, lo: float, hi: float, dtype=torch.float32, device=None):
    """Fixed 1D grid, (n, 1)."""
    return torch.linspace(lo, hi, n, dtype=dtype, device=device).reshape(-1, 1)


def meshgrid_2d(n: int, lo: float, hi: float, dtype=torch.float32, device=None):
    """n x n tensor-product grid, flattened to (n*n, 2) with 'ij' indexing."""
    g = torch.linspace(lo, hi, n, dtype=dtype, device=device)
    X, Y = torch.meshgrid(g, g, indexing="ij")
    return torch.stack([X.reshape(-1), Y.reshape(-1)], dim=-1)


def face_points(gen: torch.Generator, n_per_face: int, box: Box,
                dtype=torch.float32):
    """Fresh uniform samples on all 2d faces — (2*d*n_per_face, d), one
    batch per face with coordinate i pinned to the lo/hi face value."""
    outs = []
    for i in range(box.dim):
        for val in (box.lo[i], box.hi[i]):
            pts = uniform_box(gen, n_per_face, box, dtype)
            pts[:, i] = val
            outs.append(pts)
    return torch.cat(outs, dim=0)


def first_fraction_every_kth(n_total: int, fraction: float = 0.25, k: int = 10,
                             device=None):
    """Index rule of the 1D well's data: the first ``fraction`` of the grid,
    every ``k``-th point."""
    return torch.arange(0, int(fraction * n_total), k, device=device)


def mid_fraction_every_kth(n_total: int, fraction: float = 0.25, k: int = 10,
                           device=None):
    """The QHO variant: points in ``[fraction, 2*fraction)`` of the grid,
    every ``k``-th."""
    n_data = int(fraction * n_total)
    return torch.arange(n_data, 2 * n_data, k, device=device)


def first_fraction_indices(m: int, fraction: float = 0.25, max_points=None, device=None):
    """The first ``max(1, m*fraction)`` indices, optionally capped."""
    k = max(1, int(m * fraction))
    if max_points is not None:
        k = min(k, int(max_points))
    return torch.arange(k, device=device)
