"""What the wrappers of the CUDA kernels share.

Launch counters, the checks on what a kernel takes, the flat parameter
layout, the choice of tile and grid, and the call into the library built by
:mod:`._build`.  Nothing here runs on a CPU tensor: the wrappers route
those to their plain versions before they get here.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

# Launches of each kernel: incremented where a wrapper launches it, and
# nowhere else.  Reset with reset_launches().  A kernel's bf16-dot variant
# counts under its own name, "<kernel>.bf16" (variant_name).
LAUNCHES = {
    "fused_linear_residual": 0,
    "fused_poisson_analytic": 0,
    "fused_drm_energy": 0,
    "fwdlap_forward": 0,
    "linear_sums": 0,
    "linear_seeded": 0,
    "quad_sums": 0,
    "quad_seeded": 0,
    "fwdlap_backward": 0,
    "fwdlap_forward_streams": 0,
    "multi_sums": 0,
    "multi_seeded": 0,
    "fused_linear_residual.bf16": 0,
    "fused_poisson_analytic.bf16": 0,
    "fwdlap_forward.bf16": 0,
    "fwdlap_backward.bf16": 0,
    "fused_drm_energy.bf16": 0,
    "linear_sums.bf16": 0,
    "linear_seeded.bf16": 0,
    "quad_sums.bf16": 0,
    "quad_seeded.bf16": 0,
    "multi_sums.bf16": 0,
    "multi_seeded.bf16": 0,
}

ACTS = {"sin": 0, "tanh": 1, "gelu": 2}
NT = 256                      # threads per block (fwdlap_core.cuh)
BEYOND_ITEM = "ROADMAP.md B7"   # wider, deeper or higher-dimensional nets than these


class Limits(NamedTuple):
    """What one kernel takes: the widest hidden layer, the most weight
    matrices and the largest input dimension (``make_net`` of
    fwdlap_core.cuh, with or without ``beyond``)."""
    width: int
    matrices: int
    dim: int


# the bf16-dot modes of the quotients and the K-bump pair (rows 7-12, the
# ".bf16" launch names but those of BEYOND_BF16): fwdlap_core.cuh's
# CORE_LAYERS, CORE_DIM, widths to NT (make_net without `beyond`)
CORE_LIMITS = Limits(NT, 16, 16)
# every fp32 kernel: the fused kernels (rows 1-3), the jet pair in both
# layouts (rows 4-6), the quotients (rows 7-10) and the K-bump pair (rows
# 11, 12): fwdlap_core.cuh's MAX_WIDTH, MAX_LAYERS, MAX_DIM; a net whose
# stages do not fit shared memory at 4 points still raises in its plan
# (_plan.NoFit)
BEYOND_LIMITS = Limits(4096, 64, 64)
BEYOND_KERNELS = tuple(name for name in LAUNCHES if not name.endswith(".bf16"))
# the bf16-dot modes of rows 1-5 (the fused kernels and the jet pair on the
# tensor-core design, fwdlap_mma.cuh) take the same nets where a tile of 8
# points fits (fused_step.mma_plan raises _plan.NoFit elsewhere), the jet
# forward's d to 16 (BF16_FORWARD_LIMITS)
BEYOND_BF16 = ("fused_linear_residual.bf16", "fused_poisson_analytic.bf16",
               "fused_drm_energy.bf16", "fwdlap_forward.bf16", "fwdlap_backward.bf16")
# the jet forward's bf16-dot mode: JAX's _forward_kernel2 (fwd_impl=
# 'pallas2:default'), whose single-pass mode it is, takes d <= 6 in every
# dot mode; the port's takes d to CORE_DIM (fwdlap_forward.cu)
BF16_FORWARD_LIMITS = Limits(BEYOND_LIMITS.width, BEYOND_LIMITS.matrices, 16)
# What each kernel takes, by launch name.
LIMITS = {name: (BF16_FORWARD_LIMITS if name == "fwdlap_forward.bf16"
                 else BEYOND_LIMITS if name in BEYOND_KERNELS + BEYOND_BF16 else CORE_LIMITS)
          for name in LAUNCHES}
SMEM_MAX = 227 * 1024         # dynamic shared memory one block can get on an H100

_OCCUPANCY = {}
_CAPTURED = None              # the open capture's list of launches, if any


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def variant_name(name: str, bf16: bool) -> str:
    """The name a launch counts under: ``name``, or ``name + '.bf16'`` for
    the kernel's bf16-dot variant (fwdlap_mma.cuh)."""
    return name + ".bf16" if bf16 else name


def on_cuda(X) -> bool:
    """True for a CUDA tensor (the kernel route), False for a CPU tensor
    (the plain version); any other device raises."""
    if X.device.type == "cuda":
        return True
    if X.device.type != "cpu":
        raise ValueError(f"no kernel path for device {X.device}")
    return False


def check_net(name: str, layers) -> None:
    """Raise unless kernel ``name`` (a launch name) takes a net of these
    layer sizes (``LIMITS``): one output, 2 to ``matrices`` weight
    matrices, ``1 <= d <= dim``, every hidden width from 1 to ``width``."""
    lim = LIMITS[name]
    if layers[-1] != 1 or not 3 <= len(layers) <= lim.matrices + 1:
        raise ValueError(f"{name}: the kernel takes 2 to {lim.matrices} weight matrices and "
                         f"one output (deeper nets: {BEYOND_ITEM}); got layers {list(layers)}")
    if not 1 <= layers[0] <= lim.dim:
        note = ("the JAX package's _forward_kernel2, whose single-pass mode this is, takes "
                "d <= 6" if name == "fwdlap_forward.bf16" else f"larger d: {BEYOND_ITEM}")
        raise ValueError(f"{name}: the kernel takes d from 1 to {lim.dim} ({note}); "
                         f"got layers {list(layers)}")
    if not all(1 <= w <= lim.width for w in layers[1:-1]):
        raise ValueError(f"{name}: the kernel takes hidden widths from 1 to {lim.width} "
                         f"(wider nets: {BEYOND_ITEM}); got layers {list(layers)}")


def beyond(layers) -> bool:
    """Whether a net needs the DES_BEYOND variant of the planned fused
    kernels, the jet backward, the seeded quotients, the K-bump pass B and
    the fused kernels' bf16-dot mode (``beyond_net`` of fwdlap_core.cuh): a
    hidden width above ``NT`` or d above ``CORE_LIMITS.dim``."""
    return padded_wmax(layers) > NT or layers[0] > CORE_LIMITS.dim


def net_layers(name: str, params, X, activation: str, others=()):
    """The layer sizes ``[d, w1, ..., 1]`` of ``params`` after checking
    that kernel ``name`` (a launch name) takes this net (:func:`check_net`),
    these tensors and this activation."""
    if activation not in ACTS:
        raise ValueError(f"Unknown activation {activation!r}")
    layers = [params[0][0].shape[0]] + [W.shape[1] for W, _ in params]
    N, d = X.shape
    check_net(name, layers)
    for t in [X, *others, *[t for pair in params for t in pair]]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, got {t.dtype}")
        if t.device != X.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    if N < 1:
        raise ValueError(f"{name}: empty batch")
    return layers


def padded_wmax(layers) -> int:
    """The widest hidden layer rounded up to a multiple of 4: the row
    length of the kernels' shared-memory streams and saved stages
    (``Net::wmax`` of fwdlap_core.cuh).  The kernels pad narrower or ragged
    layers with zero units on chip; device memory keeps the true sizes."""
    return (max(layers[1:-1]) + 3) // 4 * 4


def n_params(layers) -> int:
    """Entries of the flat parameter vector of a net with these sizes."""
    return sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))


def flat_params(params) -> torch.Tensor:
    """``[W0, b0, W1, b1, ...]`` flattened into one contiguous vector."""
    return torch.cat([t.detach().reshape(-1) for pair in params for t in pair])


def hidden_transposes(params):
    """``W_1^T, ..., W_{K-2}^T`` back to back (row-major, true sizes), the
    hidden weights' transposes that a planned design of the fused residual
    kernels and the jet backward reads; one ``torch.cat`` of transposed views
    where the hidden widths are equal.  None for a net with one hidden
    layer."""
    hidden = [W.detach() for W, _ in params[1:-1]]
    if not hidden:
        return None
    if all(W.shape[0] == hidden[0].shape[0] for W in hidden):
        return torch.cat([W.t() for W in hidden]).reshape(-1)
    return torch.cat([W.t().reshape(-1) for W in hidden])


def device_weights(params, transposes: bool):
    """The hidden-to-hidden weights ``W_1 .. W_{K-2}``, each rounded up to
    multiples of 4 with zero rows and columns (``wp[k] x wp[k+1]``), back to
    back, and with ``transposes`` their transposes after them in the same
    way: the resident layout of the kernels' shared memory, in device
    memory, for the plans that read the weights from there
    (``DES_DEVW``).  None for a net with one hidden layer."""
    hidden = [W.detach() for W, _ in params[1:-1]]
    if not hidden:
        return None

    def padded(M):
        r, c = M.shape
        return torch.nn.functional.pad(M, (0, (-c) % 4, 0, (-r) % 4)).reshape(-1)

    parts = [padded(W) for W in hidden]
    if transposes:
        parts += [padded(W.t()) for W in hidden]
    return torch.cat(parts)


def folds(layers, S: int, T: int, points: int = 1) -> bool:
    """Whether a tile of T points runs the kernels' FOLD variant, which
    applies each stage's activation in the epilogue of the product that
    makes the stage (fwdlap_core.cuh: mm_act, mm_act_bwd): at most 4 streams
    (the variant's register tile holds every stream of a point), and the
    ``T/points * wmax/4`` (``points`` points, 4 units) items of the widest
    product one wave of the block's ``NT`` threads (a second, part-filled
    wave was measured to cost more than the separate elementwise pass
    saves).  ``points``: 2 in the two-point design (``DES_ITEM2``)."""
    return S <= 4 and (T // points) * (padded_wmax(layers) // 4) <= NT


# The designs of the fused residual kernels, the jet pair and the quotient
# sums (fwdlap_planned.cuh, Design; fwdlap_mma.cuh, MmaDesign): bits of the
# ``des`` argument.  DES_PLANNED the planned kernels, DES_ITEM2 their lever;
# DES_MMA the tensor-core design of every bf16-dot mode (the fused kernels,
# the jet pair, the quotients' and the K-bump pair's two passes).  None of these kernels takes 0: the kernels on
# the shared core's routines (fwdlap_core.cuh: the seeded quotient kernels
# and the K-bump pair) have no design argument, or take 0 for it.
DES_ITEM2 = 1     # two-point items, register tiles of 8 rows x 4 units
DES_PLANNED = 2   # the planned kernels (shared plan, transposes from device
                  # memory, dW items dealt 4 x 8 to a warp, two blocks per SM)
DES_MMA = 4       # bf16 mma.sync m16n8k16 products, stream-major fragments
DES_WIDE = 16     # the tensor-core design's wide variant (beside DES_MMA in a
                  # launch's design argument, fused_step.mma_des): each B
                  # fragment fetched at its k-step, for widths above 128 or
                  # the weights in device memory
DES_DEVW = 8      # the hidden weights read from device memory by the products
                  # (_plan.DEV_WEIGHTS): nets whose weights do not fit shared
                  # memory beside a tile; 4 x 4 items, no fold (the
                  # tensor-core design has its own such tier, a flag of its
                  # plan: fused_step.MMA_TIERS)
DES_BEYOND = 32   # the variant of the planned fused kernels (rows 1-3) and the
                  # jet backward (row 5) for the nets of :func:`beyond` (a hidden
                  # width above NT, d above 16), with DES_PLANNED, alone or with
                  # DES_DEVW; 4 x 4 items, no fold (fwdlap_planned.cuh); of
                  # the seeded quotients (rows 8, 10) and the K-bump pass B (row
                  # 12) for the same nets, alone or with DES_DEVW
                  # (fused_quotient.cu, fused_multibump.cu: the core's reverse
                  # sweep summing the last dW one thread per column above NT);
                  # and of the fused kernels' bf16-dot mode (rows 1-3 bf16) for
                  # the same nets, with DES_MMA, alone or with DES_WIDE
                  # (fused_step_mma.cu's fused_mma_beyond: the loss terms without
                  # per-point arrays).  The forward-only kernels (rows 4, 6, 7,
                  # 9, 11) and the jet backward's bf16-dot mode need none
PLANNED_DESIGNS = (DES_PLANNED, DES_PLANNED | DES_ITEM2)
BEYOND_DESIGNS = (DES_PLANNED | DES_BEYOND, DES_PLANNED | DES_DEVW | DES_BEYOND)
# what the fp32 kernels take
FP32_DESIGNS = PLANNED_DESIGNS + (DES_PLANNED | DES_DEVW,) + BEYOND_DESIGNS


def grid(name: str, query, smem: int, dev: torch.device, n_tiles: int,
         variant: int = 0) -> int:
    """Blocks to launch: every resident slot of the card, at most one per
    tile.  ``query(smem, int*)`` is the occupancy entry point of the
    kernel's ``variant``."""
    key = (name, variant, smem, dev.index)
    if key not in _OCCUPANCY:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = query(smem, ctypes.addressof(blocks))
        if err != 0:
            raise RuntimeError(f"{name}: occupancy query failed (cuda error {err})")
        if blocks.value < 1:
            raise RuntimeError(f"{name}: {smem} B of shared memory per block does not fit")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _OCCUPANCY[key] = blocks.value * sms
    return min(n_tiles, _OCCUPANCY[key])


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of ``dev`` (cached): the forward-only plans
    count the rounds of the card's slots that their tiles fill."""
    key = ("sms", dev.index)
    if key not in _OCCUPANCY:
        _OCCUPANCY[key] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _OCCUPANCY[key]


def layers_arg(layers):
    return (ctypes.c_int * len(layers))(*layers)


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch(name: str, fn, *args, dev: torch.device, keep=()) -> None:
    """Call one C entry point on ``dev`` and count the launch; raise on the
    CUDA error it returns.  ``keep``: the tensors whose pointers are among
    ``args`` (held by an open :class:`capture`)."""
    with torch.cuda.device(dev):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cuda error {err})")
    LAUNCHES[name] += 1
    if _CAPTURED is not None:
        _CAPTURED.append((name, fn, args, dev, keep))


class graph:
    """``fn(*static_args)`` captured once into a CUDA graph on the current
    stream, and replayed: the wrappers' host work (checks, plans,
    allocation, ``torch.cat``) and every other operation of ``fn`` run once,
    at the capture, so a replay costs one launch of the host's time.  The
    capture runs nothing, so its launches are taken off ``LAUNCHES``; every
    replay counts them again, as :meth:`capture.replay` does.  ``fn`` must
    make no host sync; its outputs (``self.out``) are overwritten by each
    replay."""

    def __init__(self, fn, *static_args):
        before = dict(LAUNCHES)
        self.g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.g):
            self.out = fn(*static_args)
        self.counts = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
        LAUNCHES.update(before)

    def replay(self):
        self.g.replay()
        for name, n in self.counts.items():
            LAUNCHES[name] += n
        return self.out


class capture:
    """Record the launches made inside the ``with`` block, with their
    arguments and the tensors behind the pointers, so that :meth:`replay`
    can issue the same launches again back to back: the kernels' device time
    without the wrapper's host work (checks, ``torch.cat``, allocation).  A
    replayed launch counts in ``LAUNCHES`` like any other."""

    def __enter__(self):
        global _CAPTURED
        self.calls = _CAPTURED = []
        return self

    def __exit__(self, *exc):
        global _CAPTURED
        _CAPTURED = None

    def replay(self, n: int = 1) -> None:
        for name, fn, args, dev, _ in self.calls:
            with torch.cuda.device(dev):
                for _ in range(n):
                    err = fn(*args)
                    if err != 0:
                        raise RuntimeError(
                            f"{name}: kernel launch failed (cuda error {err})")
            LAUNCHES[name] += n
