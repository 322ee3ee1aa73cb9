"""Hard-boundary-condition trial factors, with analytic jets.

Counterpart of ``nnpde_tpu/models/trial.py``: every factor is a separable
product ``B(x) = prod_i f_i(x_i)`` of 1D functions with closed-form first
and second derivatives, so the value, gradient and Laplacian of ``B`` are
assembled analytically and compose exactly with the forward-Laplacian jet.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from ..ops.fwdlap import Jet, exclusive_products

# A 1D factor: elementwise x -> (f(x), f'(x), f''(x)).
Factor1D = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def one() -> Factor1D:
    def jet(x):
        o = torch.ones_like(x)
        z = torch.zeros_like(x)
        return o, z, z

    return jet


def poly_box(L: float, lo: float = 0.0) -> Factor1D:
    """``(x - lo)(L - x)`` — vanishes at the box faces."""

    def jet(x):
        f = (x - lo) * (L - x)
        df = (L + lo) - 2.0 * x
        d2f = torch.full_like(x, -2.0)
        return f, df, d2f

    return jet


def exp_window(L: float) -> Factor1D:
    """``(1 - e^{-(x+L)})(1 - e^{x-L})`` — smooth window on [-L, L]."""

    def jet(x):
        ea = torch.exp(-(x + L))
        eb = torch.exp(x - L)
        a, b = 1.0 - ea, 1.0 - eb
        da, db = ea, -eb
        d2a, d2b = -ea, -eb
        return a * b, da * b + a * db, d2a * b + 2.0 * da * db + a * d2b

    return jet


def nodes_poly(nodes: Sequence[float]) -> Factor1D:
    """``prod_j (x - node_j)`` — forced zeros at the nodes; derivatives by
    the product recurrence (no division)."""
    nodes = tuple(float(n) for n in nodes)

    def jet(x):
        f = torch.ones_like(x)
        d1 = torch.zeros_like(x)
        d2 = torch.zeros_like(x)
        for n in nodes:
            g = x - n
            d2 = d2 * g + 2.0 * d1
            d1 = d1 * g + f
            f = f * g
        return f, d1, d2

    return jet


def product1d(a: Factor1D, b: Factor1D) -> Factor1D:
    """Product of two 1D factors with jet composition."""

    def jet(x):
        fa, da, d2a = a(x)
        fb, db, d2b = b(x)
        return fa * fb, da * fb + fa * db, d2a * fb + 2.0 * da * db + fa * d2b

    return jet


class SeparableFactor:
    """``B(x) = prod_i f_i(x_i)`` with analytic value / gradient / Laplacian."""

    def __init__(self, factors: Sequence[Factor1D]):
        self.factors = tuple(factors)

    @property
    def dim(self) -> int:
        return len(self.factors)

    def value_point(self, x):
        """x (d,) -> scalar."""
        out = 1.0
        for i, f in enumerate(self.factors):
            out = out * f(x[i])[0]
        return out

    def value(self, X):
        """X (N, d) -> (N,)."""
        out = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
        for i, f in enumerate(self.factors):
            out = out * f(X[..., i])[0]
        return out

    def jet(self, X) -> Jet:
        """X (N, d) -> Jet of the product factor (exclusive products, so
        vanishing factors are exact)."""
        parts = [f(X[..., i]) for i, f in enumerate(self.factors)]
        F = torch.stack([p[0] for p in parts], dim=-1)
        F1 = torch.stack([p[1] for p in parts], dim=-1)
        F2 = torch.stack([p[2] for p in parts], dim=-1)
        excl = exclusive_products(F)
        return Jet(value=excl[:, 0] * F[:, 0], grad=F1 * excl,
                   lap=torch.sum(F2 * excl, dim=1))


def unit_factor(dim: int) -> SeparableFactor:
    """``B = 1`` in ``dim`` dimensions (a factor whose jet is the identity)."""
    return SeparableFactor([one()] * dim)


def factor_for_technique(
    technique: str,
    *,
    dim: int,
    kind: str,
    L: float,
    lo: float = 0.0,
    nodes_per_dim: Sequence[Sequence[float]] | None = None,
) -> SeparableFactor | None:
    """BC / RB / RAW -> ``None``; FBC / OG -> box polynomial (``kind='box'``)
    or exp window (``kind='window'``); FN -> that times a forced-node
    polynomial per dimension."""
    technique = technique.upper()
    if technique in ("BC", "RB", "RAW"):
        return None
    base = poly_box(L, lo) if kind == "box" else exp_window(L)
    if technique in ("FBC", "OG"):
        return SeparableFactor([base] * dim)
    if technique == "FN":
        if nodes_per_dim is None:
            raise ValueError("FN technique requires nodes_per_dim")
        facs = []
        for i in range(dim):
            nodes = nodes_per_dim[i]
            facs.append(product1d(base, nodes_poly(nodes)) if len(nodes) else base)
        return SeparableFactor(facs)
    raise ValueError(f"Unknown technique {technique!r}")
