"""Elementwise input feature maps with analytic jets: hard Neumann BCs.

Counterpart of ``nnpde_tpu/models/inputmap.py``.  An output factor cannot
hard-enforce a derivative condition, but an input map can: compose
``u(x) = g(z(x))`` with elementwise features ``z_i(x_i)`` whose derivative
vanishes on the boundary.  By the chain rule

    du/dx_i = (dg/dz_i) * z_i'(x_i) = 0   wherever z_i' = 0,

for every network g: zero normal derivative on all faces, exactly, with no
penalty term.

:class:`CosineInputMap` uses ``z_i = cos(pi (x_i - lo)/(hi - lo))``: ``z_i'``
vanishes at both faces, and the map is a diffeomorphism of the open box onto
(-1, 1)^d.

Jets: the forward-Laplacian recurrence needs only the seed ``(z, z', z'')``
per coordinate (:func:`nnpde_tpu_torch.ops.fwdlap.mlp_fwdlap`,
``input_jet=``), because an elementwise map has a diagonal Jacobian.
"""

from __future__ import annotations

import math


class CosineInputMap:
    """``z_i = cos(pi (x_i - lo) / (hi - lo))`` per coordinate.

    ``z' = -w sin(w (x - lo))`` with ``w = pi/(hi - lo)`` vanishes at
    ``x = lo`` and ``x = hi``: hard zero-Neumann on the box faces.
    """

    def __init__(self, dim: int, lo: float = 0.0, hi: float = 1.0):
        if hi <= lo:
            raise ValueError(f"need hi > lo, got [{lo}, {hi}]")
        self.dim = int(dim)
        self.lo = float(lo)
        self.w = math.pi / (float(hi) - float(lo))

    def value(self, X):
        """Features for (..., d) inputs (elementwise, shape-preserving)."""
        return (self.w * (X - self.lo)).cos()

    def jet(self, X):
        """(z, z', z'') each shaped like ``X``: the recurrence's input seed."""
        t = self.w * (X - self.lo)
        z = t.cos()
        z1 = -self.w * t.sin()
        z2 = -(self.w ** 2) * z
        return z, z1, z2
