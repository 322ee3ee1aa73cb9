"""The launch plan shared by the kernels that choose their shape by net.

A plan is one launch shape: points per tile ``T``, the dynamic shared
memory of a block, and what the block keeps in shared memory for its whole
life (``flags``).  The K-bump pair (:mod:`.fused_multibump`), the seeded
quotient kernels (:mod:`.fused_quotient`), and the planned design of the
fused residual kernels and the jet backward (:mod:`.fused_step`,
:mod:`.fwdlap_cuda`; rows = 8 for their two-point items, at most two blocks
per SM) plan by the same rule; each brings its own shared-memory layout,
``smem_floats(T, flags) -> floats`` (the Python mirror of the kernel's C
layout, checked against it on the card), and its stream count ``S``
(``d + 1``, or ``d + 2`` with the Laplacian).

The rule.  The kernels are bound by instruction issue and by latency
between barriers, so resident blocks per SM come first: the plan looks for a
shape that leaves room for 3 blocks per SM (a third of ``SMEM_MAX``, less
1 KB of the SM's own reserve per block), then 2, then 1.  Within each share
it tries the tiers in order:

* pass B (``seeded``): ``resident`` -- the hidden weights, their transposes
  and the block's gradient row; ``gradient`` -- the gradient row alone,
  weights staged per layer per tile; ``staged`` -- nothing (the gradient row
  in device memory);
* pass A: ``resident`` -- the hidden weights; ``staged``.

A gradient row on chip turns the per-tile read-modify-write of ``P`` floats
of device memory into shared-memory adds, and the row goes out once per
block.  Within a tier the tile starts at :func:`tile_for`; a resident tier
gives up at most one step of 4 points (and never goes below 16) before the
plan moves to the next tier, because a larger tile was measured to buy more
than residency (``chip_smoke.py sweep`` on an H100: u50 pass B of the
quadratic kernel staged at T = 24 against the gradient row on chip at
T = 16, 0.43 against 0.48 ms at 40000 points); the staged tier steps down to
16, and with a whole SM to itself to 4.  Pass B on a net whose gradient
products have few entries deals their rows to groups of lanes (``NARROW``).  Every shape that the wrappers
accept gets a plan; ``T`` and ``tier`` pin a choice (tests, timing sweeps)
and raise if it does not fit ``SMEM_MAX``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import _cuda

# What a plan keeps in shared memory for the block's whole life (the Flags
# of fwdlap_core.cuh).
RES_WEIGHTS = 1   # hidden weights; in pass B their transposes too
NARROW = 2        # pass B: gradient products with few entries dealt by rows to
                  # groups of lanes
RES_GRAD = 4      # pass B: the block's gradient row
T_MAX = 48        # points per tile the plan asks for at most (a multiple of 4;
                  # the kernels take up to NT / 2 = 128): above 48 no measured
                  # shape gained, and smaller tiles balance the SMs better


class Plan(NamedTuple):
    """One launch shape: points per tile, dynamic shared memory in bytes,
    the residency flags, the tier's name, and the kernel design (the fused
    residual kernels and the jet backward: ``_cuda.DES_*``; 0 elsewhere)."""
    T: int
    smem: int
    flags: int
    tier: str
    design: int = 0


def tiers(seeded: bool):
    """``(name, flags)`` in the order a plan steps down through them."""
    if seeded:
        return (("resident", RES_WEIGHTS | RES_GRAD), ("gradient", RES_GRAD), ("staged", 0))
    return (("resident", RES_WEIGHTS), ("staged", 0))


def hidden_floats(layers) -> int:
    """Floats of the resident hidden-to-hidden matrices, each rounded to
    multiples of 4 (``hidden_floats`` of fwdlap_core.cuh)."""
    wp = [(w + 3) // 4 * 4 for w in layers[1:-1]]
    return sum(a * b for a, b in zip(wp[:-1], wp[1:]))


def row_floats(layers) -> int:
    """Shared floats of pass B's gradient row ``[grads (P) | sum ct_v]``,
    rounded up to a multiple of 4."""
    return (_cuda.n_params(layers) + 1 + 3) // 4 * 4


def narrow_items(layers) -> int:
    """Work items (4 x 4 register tiles) of the net's narrowest gradient
    product: the hidden-to-hidden dW tiles, or the first layer's entries."""
    wp = [(w + 3) // 4 * 4 for w in layers[1:-1]]
    return min([(a // 4) * (b // 4) for a, b in zip(wp[:-1], wp[1:])]
               + [(layers[0] + 1) * layers[1]])


def tile_for(layers, S: int, rows: int = 4) -> int:
    """Points per tile the net asks for: the largest multiple of 4 (from 16
    to ``T_MAX``) at which the widest forward product, ``S*T/4`` row groups
    times ``width/4`` column groups of 4 x 4 register tiles, is still one
    wave of the block's ``NT`` threads (a second, part-filled wave costs a
    full one: measured with ``chip_smoke.py sweep``).  ``rows=8``: the same
    for items of 8 rows x 4 units (the two-point design, ``DES_ITEM2``):
    two points and their streams at ``S <= 4``, eight stream-rows above."""
    cg = _cuda.padded_wmax(layers) // 4

    def items(T):
        if rows == 4:
            return (S * T // 4) * cg
        return (T // 2 if S <= 4 else (S * T + 7) // 8) * cg

    T = 16
    while T + 4 <= T_MAX and items(T + 4) <= _cuda.NT:
        T += 4
    return T


def plan(smem_floats: Callable[[int, int], int], layers, S: int, seeded: bool, *,
         T: int | None = None, tier: str | None = None, what: str = "plan",
         rows: int = 4, blocks: int = 3) -> Plan:
    """The first shape of the ladder above that fits: ``smem_floats(T,
    flags)`` is the kernel's layout, ``S`` its stream count; ``what`` names
    the kernel in the error raised when nothing fits.  ``rows=8`` (the
    two-point design): the tile of :func:`tile_for` with 8-row items, and
    in a share of 3 or 2 blocks per SM the staged tier too gives up at most
    one step of 4 points before the plan takes fewer blocks: the design
    pays for its larger items with the larger tile.  ``blocks``: the most
    blocks per SM the kernel's register budget allows (its launch bounds);
    the ladder starts there."""
    pinned = T is not None or tier is not None
    t0 = tile_for(layers, S, rows)
    for share in ((1,) if pinned else tuple(b for b in (3, 2, 1) if b <= blocks)):
        budget = _cuda.SMEM_MAX // share - (0 if share == 1 else 1024)
        floor = 4 if share == 1 else max(16, t0 - 4) if rows == 8 else 16
        pl = fit(smem_floats, layers, S, seeded, budget, floor, T, tier, rows)
        if pl is not None:
            return pl
    raise ValueError(f"{what}: layers {list(layers)} do not fit {_cuda.SMEM_MAX} B of "
                     f"shared memory (T={T}, tier={tier})")


def fit(smem_floats, layers, S, seeded, budget, staged_floor, T=None, tier=None, rows=4):
    """The first shape within ``budget`` bytes in the step-down order of
    :func:`plan` (a resident tier's tile one step below :func:`tile_for`
    at most; the staged tier's down to ``staged_floor``), or None."""
    narrow = NARROW if seeded and 2 * narrow_items(layers) <= _cuda.NT else 0
    for name, flags in tiers(seeded):
        if tier is not None and name != tier:
            continue
        flags |= narrow
        t = tile_for(layers, S, rows) if T is None else T
        floor = (t if T is not None else staged_floor if name == "staged"
                 else max(16, t - 4))
        while t > floor and 4 * smem_floats(t, flags) > budget:
            t -= 4
        smem = 4 * smem_floats(t, flags)
        if smem <= budget:
            return Plan(t, smem, flags, name)
    return None


def resident(pl: Plan, seeded: bool):
    """What a plan keeps in shared memory for the block's whole life."""
    out = []
    if pl.flags & RES_WEIGHTS:
        out.append("hidden weights")
        if seeded:
            out.append("their transposes")
    if seeded and pl.flags & RES_GRAD:
        out.append("gradient row")
    return out


_PLANS = {}            # shape key -> Plan


def cached(key, build: Callable[[], Plan]) -> Plan:
    """``build()`` once per shape ``key``: the wrappers ask on every launch."""
    pl = _PLANS.get(key)
    if pl is None:
        pl = _PLANS[key] = build()
    return pl
