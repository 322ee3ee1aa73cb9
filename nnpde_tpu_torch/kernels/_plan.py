"""The launch plan shared by the kernels that choose their shape by net.

A plan is one launch shape: points per tile ``T``, the dynamic shared
memory of a block, and what the block keeps in shared memory for its whole
life (``flags``).  The K-bump pair (:mod:`.fused_multibump`), the seeded
quotient kernels (:mod:`.fused_quotient`), and the planned design of the
fused residual kernels and the jet backward (:mod:`.fused_step`,
:mod:`.fwdlap_cuda`; rows = 8 for their two-point items, at most two blocks
per SM) plan by the same rule; the forward-only kernels (the jet forward,
the quotient sums) by their own, :func:`forward_only`, at the end.  Each
brings its own shared-memory layout, ``smem_floats(T, flags) -> floats``
(the Python mirror of the kernel's C layout, checked against it on the
card), and its stream count ``S`` (``d + 1``, or ``d + 2`` with the
Laplacian).

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
products have few entries deals their rows to groups of lanes (``NARROW``).
Where no tier fits even at 4 points (one layer's weights do not fit beside
a tile: a 256 x 256 matrix is 256 KB), the kernels that have it take the
design that reads the weights from device memory (``DEV_WEIGHTS``,
``_cuda.DES_DEVW``; pass B may still keep its gradient row on chip), at two
blocks per SM, then one.  Every net within the limits of all
the kernels (``_cuda.CORE_LIMITS``) gets a plan; a wider, deeper or
higher-dimensional net, which every fp32 kernel takes
(``_cuda.BEYOND_KERNELS``) and no bf16-dot mode, may fit no tile of 4
points and then raises :class:`NoFit` naming ``ROADMAP.md B7``.  ``T`` and ``tier`` pin a choice (tests, timing
sweeps) and raise if it does not fit ``SMEM_MAX``.
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
DEV_WEIGHTS = 8   # none of the weights: the products read them from device
                  # memory (design _cuda.DES_DEVW; a tier of the tensor-core
                  # design), where one layer's weights do not fit beside a
                  # tile (a 256 x 256 layer is 256 KB)
DEV_SUMS = 16     # the tensor-core design: the projection partials and the
                  # column sums in device scratch (large d at width 256)
T_MAX = 48        # points per tile the plan asks for at most (a multiple of 4;
                  # the kernels take up to NT / 2 = 128): above 48 no measured
                  # shape gained, and smaller tiles balance the SMs better


class NoFit(ValueError):
    """No launch shape of a ladder fits ``SMEM_MAX`` (a pinned one
    included)."""


# What an unpinned plan that fits nothing adds to its NoFit: no tile of 4
# points fits at one block per SM, with the weights in device memory where
# the kernel has that design; the stages in device memory are the rest of B7.
NO_TILE = (f": no tile of 4 points fits (stages in device memory: "
           f"{_cuda.BEYOND_ITEM})")


class Plan(NamedTuple):
    """One launch shape: points per tile, dynamic shared memory in bytes,
    the residency flags, the tier's name, the kernel design (the fused
    residual kernels, the jet backward and the forward-only kernels:
    ``_cuda.DES_*``; 0 elsewhere), and for the forward-only kernels the
    blocks per SM their register budget counts on (0 elsewhere)."""
    T: int
    smem: int
    flags: int
    tier: str
    design: int = 0
    blocks: int = 0     # the forward-only kernels: the register budget launched


def tiers(seeded: bool, device: bool = False):
    """``(name, flags)`` in the order a plan steps down through them;
    ``device``: the tiers of the design that reads the weights from device
    memory (``DEV_WEIGHTS``), which a plan takes where no other fits."""
    if device:
        if seeded:
            return (("gradient-device", RES_GRAD | DEV_WEIGHTS), ("device", DEV_WEIGHTS))
        return (("device", DEV_WEIGHTS),)
    if seeded:
        return (("resident", RES_WEIGHTS | RES_GRAD), ("gradient", RES_GRAD), ("staged", 0))
    return (("resident", RES_WEIGHTS), ("staged", 0))


def device_tier(tier) -> bool:
    """Whether a pinned tier name is one of the device-weights design's."""
    return tier is not None and tier.endswith("device")


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
         rows: int = 4, blocks: int = 3, device: bool | None = False) -> Plan:
    """The first shape of the ladder above that fits: ``smem_floats(T,
    flags)`` is the kernel's layout, ``S`` its stream count; ``what`` names
    the kernel in the error raised when nothing fits.  ``rows=8`` (the
    two-point design): the tile of :func:`tile_for` with 8-row items, and
    in a share of 3 or 2 blocks per SM the staged tier too gives up at most
    one step of 4 points before the plan takes fewer blocks: the design
    pays for its larger items with the larger tile.  ``blocks``: the most
    blocks per SM the kernel's register budget allows (its launch bounds);
    the ladder starts there.  ``device``: the tiers that read the weights
    from device memory (``DEV_WEIGHTS``; the plan's design ``DES_DEVW``, 4 x
    4 items, at most two blocks per SM) never (False, the kernels without
    that design), where nothing else fits (None), or only (True)."""
    pinned = T is not None or tier is not None
    t0 = tile_for(layers, S, rows)
    if device_tier(tier):
        device = True
    if not device:
        for share in ((1,) if pinned else tuple(b for b in (3, 2, 1) if b <= blocks)):
            budget = _cuda.SMEM_MAX // share - (0 if share == 1 else 1024)
            floor = 4 if share == 1 else max(16, t0 - 4) if rows == 8 else 16
            pl = fit(smem_floats, layers, S, seeded, budget, floor, T, tier, rows)
            if pl is not None:
                return pl
    if rows == 4 and device is not False and (device or tier is None):
        # nothing else fits: the weights from device memory, at two blocks
        # per SM (its kernels' budget), then one; 4 x 4 items only
        for share in ((1,) if pinned else (2, 1)):
            budget = _cuda.SMEM_MAX // share - (0 if share == 1 else 1024)
            pl = fit(smem_floats, layers, S, seeded, budget, 4 if share == 1 else 16, T,
                     tier, rows, device=True)
            if pl is not None:
                return pl._replace(design=_cuda.DES_DEVW)
    raise NoFit(f"{what}: layers {list(layers)} do not fit {_cuda.SMEM_MAX} B of "
                f"shared memory (T={T}, tier={tier}){'' if pinned else NO_TILE}")


def fit(smem_floats, layers, S, seeded, budget, staged_floor, T=None, tier=None, rows=4,
        device=False):
    """The first shape within ``budget`` bytes in the step-down order of
    :func:`plan` (a resident tier's tile one step below :func:`tile_for`
    at most; the staged tier's, and the device tiers', down to
    ``staged_floor``), or None."""
    narrow = NARROW if seeded and 2 * narrow_items(layers) <= _cuda.NT else 0
    for name, flags in tiers(seeded, device):
        if tier is not None and name != tier:
            continue
        flags |= narrow
        t = tile_for(layers, S, rows) if T is None else T
        floor = (t if T is not None else staged_floor if name in ("staged", "device")
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
    if pl.flags & DEV_WEIGHTS:
        out.append("no weights (read from device memory)")
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


# ------------------------------------------------------ forward-only kernels
# The jet forward (row 4) and pass A of the quotients (rows 7, 9) in the
# planned design: a forward recompute per tile and a short epilogue, nothing
# saved.  Measured on an H100 (chip_smoke.py sweep, PERF.md):
#   * blocks per SM come first, and the register budget has to say so: left
#     to the compiler the 4 x 4 kernel takes 94 registers and two blocks;
#     hence kernels compiled at __launch_bounds__(NT, 3) and (NT, 2), and a
#     plan launches the one its shared memory leaves room for;
#   * two-point items (8 rows x 4 units, FMA-bound where 4 x 4 items wait on
#     shared memory) win per point where their one-wave tile fits as it is,
#     but their larger tile has fewer tiles: at the paths' 20000 points a
#     32-point tile is 625 tiles, 2.4 rounds of 264 slots, and the
#     part-filled last round costs a whole one, so there the 4 x 4 plan is
#     faster; the two-point plan is taken only where its tiles fill at least
#     ROUNDS_MIN rounds of the card;
#   * a two-point tile a step below its one-wave tile leaves items idle and
#     loses (as it did for the fused residual kernels, and on u64 here);
#   * the resident tier first within a share, and on a ragged net (a hidden
#     width not a multiple of 4) before the share: its weights are staged 4
#     bytes at a time, a sixth of a parent tile on u50 against a fourteenth
#     on u64 (clock64 breakdown), so there the hidden weights staged once
#     per block at two blocks per SM beat staging per tile at three.
FWD_BLOCKS = 3          # the most blocks per SM of the kernels' register budgets
SM_SMEM = 228 * 1024    # shared memory of one SM, of which a block may use SMEM_MAX
ROUNDS_MIN = 2.5        # rounds of the card's slots the two-point plan must fill


def fold_tile(layers, S: int, points: int) -> int:
    """The forward-only kernels' one-wave tile for items of ``points``
    points: with the fold (S <= 4) an item holds every stream of its points
    at 4 units, ``T/points * wmax/4`` items; without it :func:`tile_for`
    (4 or 8 stream-rows).  At least 16 points, at most ``T_MAX``."""
    if S > 4:
        return tile_for(layers, S, 4 * points)
    cg = _cuda.padded_wmax(layers) // 4
    T = 16
    while T + 4 <= T_MAX and (T + 4) // points * cg <= _cuda.NT:
        T += 4
    return T


def check_planned(design, what: str) -> None:
    """Raise unless ``design`` is None (the plan's own choice) or an fp32
    design (``_cuda.FP32_DESIGNS``: the planned designs and the one that
    reads the weights from device memory): what the fp32 jet pair, the
    fused residual kernels and the quotient sums take."""
    if design is not None and design not in _cuda.FP32_DESIGNS:
        raise ValueError(f"{what}: design {design} is not a planned design "
                         f"({_cuda.FP32_DESIGNS})")


def _fit_at(smem_floats, T, share, design, tier=None):
    """The first pass-A tier at tile T that leaves room for ``share`` blocks
    per SM (1: a block's SMEM_MAX), or None; ``design`` with ``DES_DEVW``:
    its tier, the weights in device memory."""
    budget = _cuda.SMEM_MAX if share == 1 else SM_SMEM // share - 1024
    for name, flags in tiers(False, bool(design & _cuda.DES_DEVW)):
        if tier is not None and name != tier:
            continue
        smem = 4 * smem_floats(T, flags)
        if smem <= budget:
            return Plan(T, smem, flags, name, design, max(2, share))
    return None


def forward_only(smem_floats: Callable[[int, int], int], layers, S: int, what: str,
                 N: int | None = None, sms: int = 132, *, design: int | None = None,
                 T: int | None = None, tier: str | None = None,
                 blocks: int = FWD_BLOCKS) -> Plan:
    """The launch shape of a forward-only kernel over its layout
    ``smem_floats(T, flags)`` and ``S`` streams, for N points on a card of
    ``sms`` SMs (N None: many points).  The 4 x 4 plan: its fold tile at 3,
    then 2 blocks per SM (resident, then staged), then staged at smaller
    tiles down to 4 points in a block's whole budget.  The two-point plan:
    its fold tile as it is (pinned, it steps down as the 4 x 4 one does),
    at 3 or 2 blocks per SM, where that tile is
    larger than the 4 x 4 one; taken where its tiles fill ``ROUNDS_MIN``
    rounds of the card's slots (module note).  ``design``, ``T``, ``tier``
    and ``blocks`` (the most blocks per SM) pin a choice; what fits nothing
    raises, naming the shape.  On a ragged net the resident tier is tried
    at 3 and 2 blocks per SM before the staged one (module note)."""
    check_planned(design, what)
    two = _cuda.DES_PLANNED | _cuda.DES_ITEM2

    def ladder(des):
        devw = bool(des & _cuda.DES_DEVW)     # its kernels: the two-block budget
        shares = [b for b in ((2,) if devw else (3, 2)) if b <= blocks]
        names = [tier] if tier is not None else [name for name, _ in tiers(False, devw)]
        if all(w % 4 == 0 for w in layers[1:-1]):    # the share first, then the tier
            order = [(share, name) for share in shares for name in names]
        else:                                        # a ragged net: the tier first
            order = [(share, name) for name in names for share in shares]
        t0 = T if T is not None else fold_tile(layers, S, 2 if des & _cuda.DES_ITEM2 else 1)
        for share, name in order:
            pl = _fit_at(smem_floats, t0, share, des, name)
            if pl is not None:
                return pl
        if T is None and (design is not None or not des & _cuda.DES_ITEM2):
            for t in range(t0, 3, -4):
                pl = _fit_at(smem_floats, t, 1, des, tier)
                if pl is not None:
                    return pl
        return _fit_at(smem_floats, t0, 1, des, tier) if T is not None else None

    devw = _cuda.DES_PLANNED | _cuda.DES_DEVW
    if design is not None:
        pl = ladder(design) if (design == devw) == device_tier(tier) or tier is None else None
    elif device_tier(tier):
        pl = ladder(devw)
    else:
        pl = ladder(_cuda.DES_PLANNED)
        if T is None and fold_tile(layers, S, 2) > fold_tile(layers, S, 1):
            big = ladder(two)
            if big is not None and (N is None or -(-N // big.T)
                                    >= ROUNDS_MIN * big.blocks * sms):
                pl = big
        if pl is None and tier is None:
            # nothing else fits: the weights from device memory (4 x 4 items,
            # the two-block budget)
            pl = ladder(devw)
    if pl is None:
        pinned = T is not None or tier is not None or design is not None
        raise NoFit(f"{what}: layers {list(layers)} do not fit {_cuda.SMEM_MAX} B of "
                    f"shared memory (T={T}, tier={tier}, design={design})"
                    f"{'' if pinned else NO_TILE}")
    return pl
