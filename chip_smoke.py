"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. device: require CUDA, print the card's name and power limit, build the
   CUDA kernels of ``nnpde_tpu_torch/csrc`` with nvcc (one process per
   source, in parallel).
2. kernels: each fused kernel (float32) against its plain PyTorch version
   in float64 on the same inputs, at the main path's shapes (N = 20000 + 7,
   N = 262144, d = 2, layers 2-64-64-64-64-1, sin) and a d = 5 tanh case:
   loss and grad-tree rel <= 1e-5, and two launches bitwise equal.
3. wan_kernels: the WAN path's kernels (jet forward, linear and quadratic
   sums / seeded pairs) the same way, on the u net 2-64-64-64-64-1 and the
   critic 2-64-64-1 (sin) and a d = 5 tanh case: every sum within 1e-5 of
   the sum of its terms' magnitudes, grad trees and each jet column rel <=
   1e-5, two launches bitwise equal; then each of the four fused objectives
   (value, parameter gradients, dE and d_pn) against the same objective on
   the plain route (float64, CPU).
4. main path: ``train_poisson_nd`` (2D Poisson PINN, box-FBC trial, width
   64 x depth 5, 3000 epochs, 20000 points) on jet_impl 'torch' and
   'fused': both rel_l2 <= 1e-3, fused <= max(2 x torch, 1e-3), and exactly
   one fused_linear_residual launch per epoch; then coef_mode='analytic'
   and method='DRM' for a few hundred epochs (kernel launched, loss finite
   and falling).
5. wan_path: ``train_poisson_nd(method='WAN')`` (the default 2D Poisson WAN,
   critic 2-64-64-1, 5 critic steps, 1000 epochs) on jet_impl 'torch' and
   'fused' from one seed: first total within rtol 1e-3 and the first 10
   within 5e-2, both best rel_l2 <= 5e-2, all finite, and exactly 6 jet
   forward, 6 linear sums, 6 linear seeded, 5 quad sums and 5 quad seeded
   launches per epoch; then 100 fused epochs of minimax='extragradient'.
6. eigen_kernels: the jet backward, the stream-major jet forward and the
   K-bump pair (float32) against their plain versions in float64 on the
   card, on the infinite-well nets 2-50-50-50-50-1 and 2-20-20-20-1 (sin), a
   d = 5 tanh net and a width-10 net, N = 40000 and 40007, K in 1, 4, 16, 36:
   the same bars; then the two multibump objectives (value, parameter
   gradients, dE, d phi_norms) against the plain route in float64, and the
   fused residual kernel once more at width 50.
7. eigen_path: ``train_ipw_2d`` at the default nets and grid (40000 points),
   state nx = ny = 3, technique FN.  PINN with weights {'data': 1e4} on
   jet_impl 'torch', 'kernel' and 'fused' (500 epochs, cut from the 20000
   of the acceptance row): first total within rtol 1e-4, first 10 within
   5e-2, kernel and fused rel_l2 <= max(2 x torch, 1e-3), exact launch
   counts; DRM on 'fused' (300 epochs; the same band against 100 'torch'
   epochs, loss falling below its first value); WAN with n_test_grid = 4 (16
   bumps) on 'torch' and 'fused' (250 epochs): the same band, the first
   weak-form term within 1e-3, all finite, rel_l2 falling, exact launch
   counts; then 100 epochs each of grid_jitter and
   minimax='extragradient', and 100 PINN epochs on 'kernel:streams'.
   (The stream-major jet forward is the row forward's kernel and plan with
   a stream-major write: eigen_kernels also holds it equal to the row
   layout's output.)
8. ipw3d (group ``ipw3d``): ipw3d_kernels holds rows 1, 4, 5, 9 and 10 at
   the 3D infinite well's shape (u64 at d = 3, 131072 and 131079 points) to
   their float64 plain versions by the bars above; ipw3d_path runs
   ``train_ipw_3d`` at its default config (131072 Sobol points redrawn
   every epoch, FN ground state), PINN for 500 of its 5000 epochs on
   'torch', 'kernel' and 'fused' and DRM for 300 on 'torch' and 'fused':
   the kernel routes start as 'torch' does (rtol 1e-4, first 10 within
   5e-2), PINN rel_l2 <= max(2 x torch, 1e-3), DRM falling, all finite,
   exact launch counts.  neumann (group ``neumann``): neumann_path runs
   ``train_poisson_nd`` at ACCEPTANCE.json's poisson_5d_pinn_neumann config
   (5D PINN, hard Neumann through the cosine input map, 32768 Sobol points
   redrawn, cosine schedule) for 2000 of its 60000 epochs on 'torch': best
   rel_l2 at most a tenth of the first eval's, finite, no kernel launched,
   |du/dn| <= 1e-5 max |grad u| at 1000 face points; 'kernel' and 'fused'
   must raise on it.
9. eigen1d (group ``eigen1d``): eigen1d_kernels holds rows 1, 4, 5 and 7-10
   at d = 1 on the 1D paths' nets (the well's u50 and critic c20, tanh; the
   oscillator's u200, sin for PINN and DRM, tanh for WAN, and its critic
   v100) at 1000 and 1007 points, and on a ragged wide net (1, 130, 256, 1),
   to their float64 plain versions by the bars above; eigen1d_path runs
   ``train_ipw_1d(n=3, technique='FN')`` (200 of 3000 epochs: PINN on three
   routes, DRM on two), ``train_ipw_1d_wan(technique='FN')`` (120 epochs,
   'torch' and 'fused'), ``train_qho_1d(n=1, technique='FN')`` at u200
   (200 of 10000 epochs, PINN on three routes, DRM on two), the
   full-length L-BFGS rows qho1d_n0_drm_fn_lbfgs ('fused') and
   qho1d_n2_pinn_fn_lbfgs ('kernel') of ACCEPTANCE.json (3000 iterations,
   best MSE <= 1e-5), ``train_qho_1d_wan(n=0, technique='OG',
   minimax='extragradient', v_lr=2e-3)`` (120 of 30000 epochs) and
   ``train_ipw_2d(LBFGS=True)`` (100 fused epochs and the 500-iteration
   polish): kernel routes start as 'torch' does (rtol 1e-4, first 10 within
   5e-2), PINN best MSE <= max(2 x torch, 1e-3), DRM and WAN falling, all
   finite, exact launch counts (the L-BFGS rows' from their evaluations);
   eigen1d_timing times the rows at 1000 and 262144 points with their plans;
   graph_trace replays rows 9 and 10 on u200 in one CUDA graph, as the
   L-BFGS evaluations run, under torch.profiler (the kernels the device ran
   beside the counts; reported, not gated).
10. qho2d, kh (groups ``qho2d`` and ``kh``): trainE_kernels holds row 1
   with the e lane (``r = -1/2 lap u + (V - E) u``, the e column B) on the
   KH nets u100 (window and raw) and u64 at 1024 and 1031 points and on u50
   at d = 2 (40000, 40007), its ``sum r e net`` and repeats included, and
   rows 4, 5, 9, 10 on u100 and rows 7, 8 on the KH critic c50 (sin), to
   their float64 plain versions; qho2d_path runs ``train_qho_2d(nx=1,
   ny=1, technique='FN')`` at its published nets and 40000 points (PINN
   with the trainable E and ``energy_lr`` on three routes, DRM and WAN on
   two, the L-BFGS polish over the net and E) and kh_path ``train_kh`` on
   ``KHGroundTruth(alpha=10, L=60, N=5000)`` with the acceptance config
   (u100, 1024 points; PINN on three routes, DRM and WAN on two), epochs
   cut: the kernel routes start as 'torch' does, PINN best <= max(2 x
   torch, 1e-3), DRM and WAN falling, exact launch counts, each trainable
   E's final error <= max(2 x torch's, 1e-4); kh_timing times the KH
   shapes at 1024 and 262144 points.
11. subspace, floquet (groups ``subspace`` and ``floquet``): subspace_path
   runs ``train_subspace`` at the JAX package's end-to-end test
   configurations (ipw and qho k = 3, width 48, 300 points, 2500 / 3000
   epochs; the KH well k = 4 against its 4000-point FD truth, 3000 epochs;
   the 2D well k = 3 on 48 x 48, 2500 epochs), from the JAX package's
   initial weights for seed 0 as its tests start, one worker process each,
   with those tests' bars, ascending distinct eigenvalues and the
   variational bound;
   floquet_path runs ``train_kh_floquet`` (M = 2, 384 points, 1200
   epochs) with the gates of the JAX package's short-training test.  Both
   assert their tensors on the card and that no kernel was launched (the
   channel jet is the forward-Laplacian recurrence; the k x k Cholesky and
   the Floquet coupling are plain PyTorch).
12. cli, parallel (groups ``cli`` and ``parallel``): the command line as
   a user starts the system, each run in a worker process (with the
   subspace group's pool where both run): ``cli.main`` on the main path's
   fused configuration (exactly 3000 fused_linear_residual launches, its
   persisted rel_l2 equal to main_path's fused one, its checkpoint
   reloaded through the registry onto the card reproducing it within
   1e-6), ``ipw1d --method DRM --jet-impl fused`` (300 launches of rows 9
   and 10 each), ``sweep ipw1d`` (8 rows) and one ``python -m
   nnpde_tpu_torch.exp.cli poisson --epochs 200`` process with
   ``results_process`` on its ledger; no plot.  parallel: the
   data-parallel steps at the main path's shapes on an NCCL world of one
   (bitwise equal to the direct kernel calls, exact launches) and on two
   spawned gloo ranks sharing cuda:0 (within 1e-5 of one process on the
   whole batch, parameters bitwise equal on both ranks after 100 Adam
   steps), with the two-rank and one-process Adam rates (reported); then
   tensor parallelism through the jet at the same width and points
   (``tp_fields``, ``tp_mean_step``): on an NCCL world of one bitwise the
   plain jet, ``fields`` and ``psum_mean_step``; on two gloo ranks sharing
   cuda:0 at tp = 2 the PINN loss, each rank's gradient parts and its
   parts after 100 Adam steps within 1e-5 of one process, with both rates
   (reported).  probe (group ``probe``): ``train_ipw_2d(compile_only=True)``
   at ``scripts/wan_mem_probe.py``'s four cells (the 2D well's WAN
   winner, grid 300 and 400, jitter off and on), each probe's total within
   0.98-1.02 of ``max_memory_allocated`` over 50 epochs of the same
   configuration and below the card's memory.
13. timing, wan_timing, eigen_timing, ipw3d_timing: CUDA events, median over repeats, for
   each kernel and its plain version at the path's N and at 262144 on the
   net it runs on, with the bound (bytes or operations) and the plan of
   every kernel that plans its launch (tile, tier, blocks per SM; for rows
   1-5, 7 and 9 the design and item shape; for rows 4, 7 and 9 by N as
   well as by net); rows 1 and 4 also on u50 at 40000 and 262144, rows 4
   and 7 also at d = 5, rows 1, 4, 5, 9 and 10 at d = 3 (u64 at 131072 and
   262144); training steps per second.
   ``python3 chip_smoke.py timing --rows=KERNEL[,KERNEL...]`` times only
   the rows of those kernels: one fresh process per row, so that what ran
   earlier in a process does not move its times
   (``nnpde_tpu_torch/tools/compare_timing.py`` reads such runs).
14. precision (group ``precision``): precision_kernels holds the bf16-dot
   variants of the fused residual (stream and analytic coefficients), the
   jet forward and the jet backward, all four in the tensor-core design
   (``csrc/fwdlap_mma.cuh``, asserted from their launches), to their plain
   bf16-dot versions
   (float32 on the card) on u64 at 20000 points and u50 at 40000, d = 2
   and 5: loss, gradient leaves and jet columns within 1e-4 norm-relative,
   more than 1e-3 from the fp32 kernel, repeats bitwise; precision_path
   trains ``compute_dtype='hybrid-kernel'`` on the main path's shape (3000
   epochs on 'fused' with stream and analytic coefficients, 300 on
   'kernel'; exact bf16 and fp32 launch counts; rel_l2 <= max(2 x the fp32
   fused run, 1e-3), the 'kernel' run against its own fp32 run), the 5D Poisson PINN 'hybrid' on 'torch' and 'fused'
   (1000 epochs; rel_l2 <= max(2 x the route's fp32 run, 1e-3); the two
   tails from one bulk agree at 1e-3), the Poisson WAN 'hybrid' (300 fused
   epochs), the infinite well (3, 3) PINN 'hybrid' (500 epochs, 'torch' and
   'fused') and one 100-epoch 'bfloat16' run of each entry point;
   precision_timing times the four kernels in both dot modes at the path's
   N and at 262144 (d = 2), and rows 1, 4, 5 in fp32 at d = 5
   (``timing --rows=fused_linear_residual.bf16`` times one such row alone).

``python3 chip_smoke.py eigen`` (or any other phase-group name: kernels,
wan, main, eigen, ipw3d, neumann, eigen1d, qho2d, kh, subspace, floquet,
cli, parallel, probe, timing, precision) runs only those groups,
for work on one slice; without arguments every phase runs.  ``python3
chip_smoke.py sweep`` is a further group that runs only when named: the jet
forward in both layouts (rows 4 and 6) and the
quotient sums (rows 7 and 9) in both planned designs at each tier and
register budget, the seeded quotient kernels, rows 1 and 5 in both planned
designs (4 x 4 and two-point items), the K-bump pair at every plan tier
and a range of tile sizes, and rows 1 and 2 bf16 in the tensor-core design
and the jet pair's bf16-dot rows 5 and 4 in the tensor-core design at
each of its levers (tile, tier, blocks per SM; with the SASS count of
HMMA, LDL and STL in each variant), each checked against float64 (repeats
bitwise) and timed; ``python3 chip_smoke.py mma_sweep`` runs the last
alone.  ``python3 chip_smoke.py mma_depth`` (only when named) holds row 1
bf16 on the wide nets by depth, per gradient leaf, against the plain
version, its float64 witness and the plain version on a permutation of the
net's hidden units (the spread of two fp32 orders).  ``python3
chip_smoke.py devw_sweep`` (only when named) times rows 1, 4, 5 and 7-10 on
the 1D paths' u200 and v100 and on (1, 130, 256, 1) in the design that reads
the hidden weights from device memory against the plans' own choice, each
shape held to float64.  ``python3 chip_smoke.py full`` (only when named)
runs the full-length acceptance rows ``ipw2d_n33_pinn_fn``,
``kh1d_alpha10_pinn`` and ``kh1d_alpha10_{pinn,drm,wan}_dense`` on 'fused'
(``full --route=torch`` on 'torch') against their ACCEPTANCE.json targets.
``python3 chip_smoke.py subspace_full`` and ``floquet_full`` (only when
named) run the four subspace rows (``subspace_{qho1d_k6,ipw1d_k4,qho2d_k6,
kh_k4}``) and the four Floquet rows (``kh_floquet_{n0,n1,a4_w03_n0,
a4_w03_n1}_pinn``, 20000 epochs each) at full length against their
ACCEPTANCE.json targets, beside the JAX package's recorded numbers;
``--rows=NAME[,NAME...]`` runs only those rows.  ``python3 chip_smoke.py
subspace_seeds`` (only when named) reports the subspace group's
configurations over seeds 0-9.

The last two lines before the final one are the ``kernels`` summary and the
card's ``name, power limit``; the final line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FP32_PEAK = 67e12        # H100 SXM, fp32 outside the tensor cores (FLOP/s)
HBM_RATE = 3.35e12       # H100 SXM device memory (B/s)
LAYERS = (2, 64, 64, 64, 64, 1)
L = 2.0
CRITIC = (2, 64, 64, 1)
REPLACES = {
    "fused_linear_residual": "nnpde_tpu/kernels/fused_step.py:64",
    "fused_poisson_analytic": "nnpde_tpu/kernels/fused_step.py:596",
    "fused_drm_energy": "nnpde_tpu/kernels/fused_step.py:170",
}
WAN_REPLACES = {
    "fwdlap_forward": "nnpde_tpu/kernels/fwdlap_pallas.py:157",
    "linear_sums": "nnpde_tpu/kernels/fused_quotient.py:111",
    "linear_seeded": "nnpde_tpu/kernels/fused_quotient.py:189",
    "quad_sums": "nnpde_tpu/kernels/fused_quotient.py:268",
    "quad_seeded": "nnpde_tpu/kernels/fused_quotient.py:333",
}
WAN_SOURCES = {"fwdlap_forward": "nnpde_tpu_torch/csrc/fwdlap_forward.cu"}
# launches of each WAN kernel per epoch at 5 critic steps: the frozen net's
# jet in each critic step and in the u step; pass A and pass B of the weak
# form in each critic step and the u step; the critic regulariser's pair in
# each critic step
WAN_PER_EPOCH = {"fwdlap_forward": 6, "linear_sums": 6, "linear_seeded": 6,
                 "quad_sums": 5, "quad_seeded": 5}
# the net each WAN kernel runs on most often in an epoch (its summary row)
WAN_MAIN_NET = {"fwdlap_forward": "u", "linear_sums": "critic",
                "linear_seeded": "critic", "quad_sums": "critic", "quad_seeded": "critic"}
# the infinite-well slice: IPW2DConfig's default nets and grid
EIGEN_U = (2, 50, 50, 50, 50, 1)
EIGEN_V = (2, 20, 20, 20, 1)
EIGEN_N = 40000
EIGEN_REPLACES = {
    "fwdlap_backward": "nnpde_tpu/kernels/fwdlap_pallas.py:522",
    "fwdlap_forward_streams": "nnpde_tpu/kernels/fwdlap_pallas.py:285",
    "multi_sums": "nnpde_tpu/kernels/fused_multibump.py:62",
    "multi_seeded": "nnpde_tpu/kernels/fused_multibump.py:131",
}
EIGEN_SOURCES = {
    "fwdlap_backward": "nnpde_tpu_torch/csrc/fwdlap_backward.cu",
    "fwdlap_forward_streams": "nnpde_tpu_torch/csrc/fwdlap_forward.cu",
    "multi_sums": "nnpde_tpu_torch/csrc/fused_multibump.cu",
    "multi_seeded": "nnpde_tpu_torch/csrc/fused_multibump.cu",
}
# the net each of them runs on most often in an epoch (its summary row)
EIGEN_MAIN_NET = {"fwdlap_backward": "u", "fwdlap_forward_streams": "u",
                  "multi_sums": "critic", "multi_seeded": "critic"}
EIGEN_BUMPS = 16
# Launches per epoch of the multi-bump WAN on the fixed grid at v_steps = 5.
# alternating: the critic's coefficient stream is built once per epoch from
# the frozen u's jet (1 jet forward), each of the 5 critic steps is pass A +
# pass B on the critic, and the u step takes the critic's jet (1 jet
# forward) and pass A + pass B on u.
EIGEN_WAN_PER_EPOCH = {"fwdlap_forward": 2, "multi_sums": 6, "multi_seeded": 6}
# grid_jitter: the points move with every step, so each critic step rebuilds
# its stream from a fresh u jet (5 + the u step's critic jet).
EIGEN_JITTER_PER_EPOCH = {"fwdlap_forward": 6, "multi_sums": 6, "multi_seeded": 6}
# extragradient: 4 plain critic steps, then gradients of both objectives at
# (u, v) and again at the lookahead (u', v'): 4 + 2 + 2 pass pairs; the u
# jet for the epoch's stream and once more at the lookahead, the critic's
# jet in each of the two u gradients.
EIGEN_EG_PER_EPOCH = {"fwdlap_forward": 4, "multi_sums": 8, "multi_seeded": 8}


def emit(obj):
    print(json.dumps(obj, default=float), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rand_params(rng, layers, device, dtype=torch.float32):
    out = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = 1.0 / math.sqrt(n_in)
        W = rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32)
        b = rng.uniform(-bound, bound, (n_out,)).astype(np.float32)
        out.append((torch.as_tensor(W, device=device, dtype=dtype),
                    torch.as_tensor(b, device=device, dtype=dtype)))
    return out


def tree_rel(a, b):
    num = sum(float(torch.sum((x.double() - y.double()) ** 2))
              for pa, pb in zip(a, b) for x, y in zip(pa, pb))
    den = sum(float(torch.sum(y.double() ** 2)) for pb in b for y in pb)
    return math.sqrt(num / max(den, 1e-300))


def tree_max_abs(a, b):
    return max(float(torch.max(torch.abs(x.double() - y.double())))
               for pa, pb in zip(a, b) for x, y in zip(pa, pb))


class Case:
    """One kernel's inputs: X, coefficients, and the wrapper / plain calls."""

    def __init__(self, kind, N, d, layers, act, seed, dev):
        from nnpde_tpu_torch.kernels import fused_step as fs
        from nnpde_tpu_torch.models import factor_for_technique
        from nnpde_tpu_torch.pde.poisson import rhs_f_for_u_sin

        rng = np.random.default_rng(seed)
        self.kind, self.N, self.d, self.act, self.fs = kind, N, d, act, fs
        self.params = rand_params(rng, layers, dev)
        self.X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
        self.ks = (1,) * d
        fj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(self.X)
        f = rhs_f_for_u_sin(self.X, L, self.ks)
        if kind == "fused_linear_residual":
            self.coef = fs.residual_coefficients(fj, a0=-1.0, rhs=-f).contiguous()
        elif kind == "fused_drm_energy":
            self.coef = fs.drm_coefficients(fj, f).contiguous()
        else:
            self.coef = None
        self.streams = d + (1 if kind == "fused_drm_energy" else 2)
        self.layers = layers

    def kernel(self, params=None, X=None, coef=None):
        fs = self.fs
        p = self.params if params is None else params
        X = self.X if X is None else X
        coef = self.coef if coef is None else coef
        if self.kind == "fused_linear_residual":
            return fs.fused_linear_residual(p, X, coef, self.act)
        if self.kind == "fused_drm_energy":
            return fs.fused_drm_energy(p, X, coef, self.act)
        return fs.fused_poisson_analytic(p, X, self.act, L=L, ks=self.ks)

    def plain(self, dtype):
        """The plain version on the card, same contract as the wrapper."""
        fs = self.fs
        p = [(W.to(dtype), b.to(dtype)) for W, b in self.params]
        X = self.X.to(dtype)
        if self.kind == "fused_poisson_analytic":
            dWs, dbs, sums = fs.poisson_analytic_plain(p, X, self.act, fs.PoissonSinCoef(L, self.ks))
            scale = 2.0 / self.N
        else:
            fn = (fs.linear_residual_plain if self.kind == "fused_linear_residual"
                  else fs.drm_energy_plain)
            dWs, dbs, sums = fn(p, X, self.coef.to(dtype), self.act)
            scale = (2.0 if self.kind == "fused_linear_residual" else 1.0) / self.N
        loss = sums[0] / self.N
        return loss, fs._scaled_grads(p, dWs, dbs, sums, scale)

    def flops(self):
        macs = sum(a * b for a, b in zip(self.layers[:-1], self.layers[1:]))
        return 3.0 * self.streams * macs * 2.0 * self.N

    def bytes(self):
        P = sum(a * b + b for a, b in zip(self.layers[:-1], self.layers[1:]))
        nc = 0 if self.coef is None else self.coef.shape[1]
        return 4.0 * (self.N * (self.d + nc) + 2 * P + 3)

    def bound_ms(self):
        return 1e3 * max(self.flops() / FP32_PEAK, self.bytes() / HBM_RATE)


def hold(case):
    """A case's kernel launched twice (the repeat bitwise equal) against its
    float64 plain version, by its kind's bar in the kernels phases: rows
    1-3 the loss and the grad tree rel <= 1e-5; the jet forward each column;
    a sums kind each sum within 1e-5 of the sum of its terms' magnitudes;
    the jet backward and the seeded kinds the gradient row (and sum ct_v)
    rel <= 1e-5.  Returns the phase's row."""
    kind = case.kind
    row = {"kernel": kind, "N": case.N, "layers": list(case.layers)}
    if isinstance(case, Case):
        (loss, _, grads), (loss2, _, grads2) = case.kernel(), case.kernel()
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(loss, loss2)) and all(
            torch.equal(x, y) for pa, pb in zip(grads, grads2) for x, y in zip(pa, pb))
        ref_loss, ref_grads = case.plain(torch.float64)
        row["loss_rel"] = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        row["grad_rel"] = tree_rel(grads, ref_grads)
        row["max_abs_err"] = max(abs(float(loss) - float(ref_loss)),
                                 tree_max_abs(grads, ref_grads))
        ok = row["loss_rel"] <= 1e-5 and row["grad_rel"] <= 1e-5
    else:
        out, out2 = case.kernel(), case.kernel()
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(out, out2))
        ref = case.plain(torch.float64)
        row["max_abs_err"] = float(torch.max(torch.abs(out.double() - ref)))
        if kind == "fwdlap_forward":
            row["col_rel"] = col_rel(out, ref)
            ok = row["col_rel"] <= 1e-5
        elif kind.endswith("sums"):
            row["sum_err_over_abs_terms"] = float(torch.max(
                torch.abs(out.double() - ref) / case.abs_terms()))
            ok = row["sum_err_over_abs_terms"] <= 1e-5
        else:
            P = out.numel() - (0 if kind == "fwdlap_backward" else 1)
            row["grad_rel"] = float(torch.linalg.norm(out[:P].double() - ref[:P])
                                    / torch.linalg.norm(ref[:P]))
            ok = row["grad_rel"] <= 1e-5
            if P < out.numel():
                row["ctv_rel"] = abs(float(out[P]) - float(ref[P])) / abs(float(ref[P]))
                ok = ok and row["ctv_rel"] <= 1e-5
    row["bitwise_repeat"] = bitwise
    row["ok"] = bool(ok and bitwise)
    return row


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nnpde_tpu_torch.kernels import _build

    card = card_line()
    t0 = time.time()
    _build.load()
    # each kernel's entry line, then its stack and spills and its registers
    # (nnpde_tpu_torch/tools/compare_ptxas.py compares two builds' lines)
    regs = [ln.strip() for ln in _build.BUILD_LOG.get("ptxas", "").splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry function" in ln]
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.time() - t0, "ptxas": regs})
    return card


def phase_kernels(dev):
    """Kernel (fp32) vs plain (fp64) on the card; repeat launches bitwise."""
    rows, max_err = [], {}
    shapes = [(20007, 2, LAYERS, "sin"), (262144, 2, LAYERS, "sin"),
              (20007, 5, (5, 64, 64, 64, 64, 1), "tanh")]
    for kind in REPLACES:
        for i, (N, d, layers, act) in enumerate(shapes):
            case = Case(kind, N, d, layers, act, seed=100 + i, dev=dev)
            row = dict(hold(case), d=d, act=act)
            max_err[kind] = max(max_err.get(kind, 0.0), row["max_abs_err"])
            rows.append(row)
            del case
            torch.cuda.empty_cache()
    emit({"phase": "kernels", "tol": 1e-5, "rows": rows})
    if not all(r["ok"] for r in rows):
        raise SystemExit("kernel vs plain comparison failed")
    return max_err


def macs(layers):
    return sum(a * b for a, b in zip(layers[:-1], layers[1:]))


class WanCase:
    """One WAN kernel's inputs at one shape: points, params, a coefficient
    stream built as the WAN path builds it, and the pass-B seeds."""

    def __init__(self, kind, N, layers, act, seed, dev, lap=0):
        from nnpde_tpu_torch.kernels import fused_quotient as fq
        from nnpde_tpu_torch.models import factor_for_technique
        from nnpde_tpu_torch.ops import bump_w

        rng = np.random.default_rng(seed)
        self.kind, self.N, self.layers, self.act, self.lap = kind, N, layers, act, lap
        self.d = d = layers[0]
        self.params = rand_params(rng, layers, dev)
        self.X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
        self.coef = self.scal = None
        fj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(self.X)
        data = torch.as_tensor(rng.normal(size=(N, d + 1)).astype(np.float32), device=dev)
        if kind.startswith("linear"):
            # the weak form of the u step: b0 = grad phi, rhs = -f phi, e1 =
            # B, e2 = B phi (phi, grad phi, f from the data columns)
            wv, _ = bump_w(self.X, 0.0, L)
            phi = wv * data[:, 0]
            self.coef = fq.linear_functional_coefficients(
                fj, b0=data[:, 1:], rhs=-data[:, 0] * phi, a0=0.0 if lap == 0 else -0.5,
                e1=fj.value, e2=fj.value * phi).contiguous()
            self.scal = torch.tensor([0.3, -0.2, 0.7], device=dev)
        elif kind.startswith("quad"):
            # the critic regulariser (V = 1/2) with a source term
            self.coef = fq.quotient_coefficients(fj, f=data[:, 0], V=0.5).contiguous()
            self.scal = torch.tensor([0.4, -0.3], device=dev)

    def kernel(self):
        from nnpde_tpu_torch.kernels import fused_quotient as fq
        from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

        if self.kind == "fwdlap_forward":
            return fc.fwdlap_forward(self.params, self.X, self.act)
        return fq._launch(self.kind, self.params, self.X, self.coef, self.scal, self.act,
                          self.lap)

    def plain(self, dtype):
        """The plain version on the card, in the kernel's output layout."""
        from nnpde_tpu_torch.kernels import fused_quotient as fq
        from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

        p = [(W.to(dtype), b.to(dtype)) for W, b in self.params]
        X = self.X.to(dtype)
        if self.kind == "fwdlap_forward":
            jet = fc.fwdlap_forward_plain(p, X, self.act)
            return torch.cat([jet.value[:, None], jet.grad, jet.lap[:, None]], dim=1)
        coef, scal = self.coef.to(dtype), self.scal.to(dtype)
        no_lap = self.lap == 0
        if self.kind == "linear_sums":
            return fq.linear_sums_plain(p, X, coef, self.act, no_lap)
        if self.kind == "quad_sums":
            return fq.quad_sums_plain(p, X, coef, self.act)
        if self.kind == "linear_seeded":
            dWs, dbs, sums = fq.linear_seeded_plain(p, X, coef, scal, self.act, no_lap)
        else:
            dWs, dbs, sums = fq.quad_seeded_plain(p, X, coef, scal, self.act)
        # the kernel's row: [dW0, db0, ..., dW_last, (unwritten) b_last | sum ct_v]
        flat = [t.reshape(-1) for dW, db in zip(dWs, dbs) for t in (dW, db)]
        flat[-1] = torch.zeros_like(flat[-1])
        return torch.cat(flat + [sums])

    def abs_terms(self):
        """Float64 sum of the magnitudes of each sum's per-point terms."""
        from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap

        p = [(W.double(), b.double()) for W, b in self.params]
        d, c = self.d, self.coef.double()
        jet = mlp_fwdlap(p, self.X.double(), self.act)
        if self.kind == "linear_sums":
            r = c[:, 0] * jet.value + torch.sum(c[:, 1:1 + d] * jet.grad, dim=1) + c[:, d + 2]
            if self.lap:
                r = r + c[:, d + 1] * jet.lap
            return torch.stack([r.abs().sum(), (r * r).sum(),
                                ((c[:, d + 3] * jet.value) ** 2).sum(),
                                (c[:, d + 4] * jet.value).abs().sum()])
        u = c[:, 0] * jet.value
        G = c[:, 0:1] * jet.grad + c[:, 1:1 + d] * jet.value[:, None]
        e = 0.5 * torch.sum(G * G, dim=1) - c[:, d + 1] * u + c[:, d + 2] * u * u
        return torch.stack([e.abs().sum(), (u * u).sum()])

    def streams(self):
        return self.d + (2 if self.kind == "fwdlap_forward" else 1 + self.lap)

    def flops(self):
        per = {"fwdlap_forward": 2.0, "linear_sums": 2.0, "quad_sums": 2.0,
               "linear_seeded": 6.0, "quad_seeded": 6.0}[self.kind]
        return per * self.streams() * macs(self.layers) * self.N

    def bytes(self):
        P = sum(a * b + b for a, b in zip(self.layers[:-1], self.layers[1:]))
        nc = 0 if self.coef is None else self.coef.shape[1]
        out = {"fwdlap_forward": self.N * (self.d + 2), "linear_sums": 4, "quad_sums": 2,
               "linear_seeded": P + 1, "quad_seeded": P + 1}[self.kind]
        return 4.0 * (self.N * (self.d + nc) + P + out)

    def bound_ms(self):
        return 1e3 * max(self.flops() / FP32_PEAK, self.bytes() / HBM_RATE)

    def bound_by(self):
        return "operations" if self.flops() / FP32_PEAK >= self.bytes() / HBM_RATE else "bytes"


def col_rel(a, b):
    return max(float(torch.linalg.norm(a[:, c].double() - b[:, c]) / torch.linalg.norm(b[:, c]))
               for c in range(b.shape[1]))


def phase_wan_kernels(dev):
    """WAN kernels (fp32) vs plain (fp64) on the card; repeats bitwise."""
    shapes = {
        "fwdlap_forward": [(20007, LAYERS, "sin", 0), (262144, LAYERS, "sin", 0),
                           (20007, CRITIC, "sin", 0), (20007, U5, "tanh", 0)],
        "linear_sums": [(20007, LAYERS, "sin", 0), (262144, LAYERS, "sin", 0),
                        (20007, CRITIC, "sin", 0), (262144, CRITIC, "sin", 0),
                        (20007, U5, "tanh", 1)],
        "quad_sums": [(20007, CRITIC, "sin", 0), (262144, CRITIC, "sin", 0),
                      (20007, U5, "tanh", 0)],
    }
    shapes["linear_seeded"] = shapes["linear_sums"]
    shapes["quad_seeded"] = shapes["quad_sums"]
    rows, max_err = [], {}
    for kind in WAN_REPLACES:
        for i, (N, layers, act, lap) in enumerate(shapes[kind]):
            case = WanCase(kind, N, layers, act, seed=200 + i, dev=dev, lap=lap)
            row = dict(hold(case), act=act, lap=lap)
            max_err[kind] = max(max_err.get(kind, 0.0), row["max_abs_err"])
            rows.append(row)
            del case
            torch.cuda.empty_cache()
    emit({"phase": "wan_kernels", "tol": 1e-5, "rows": rows})
    obj = wan_objectives(dev)
    emit({"phase": "wan_objectives", "tol": 1e-5, "rows": obj})
    if not all(r["ok"] for r in rows + obj):
        raise SystemExit("WAN kernel vs plain comparison failed")
    return max_err


def wan_objectives(dev, N=20007):
    """Each fused objective on the card (kernels) against the same objective
    on the plain route (CPU, float64), on the coefficient streams the WAN
    path builds: value, parameter gradients, and dE / d_pn of the primal.
    A quotient's gradient is a difference of seeded parts that can cancel,
    so each number is held to the larger of 1e-5 and twice the error of the
    plain route itself in float32 (on the CPU) against float64."""
    from nnpde_tpu_torch.kernels import (linear_functional_coefficients, make_fused_quad_mean,
                                         make_fused_rayleigh, make_fused_wan_u,
                                         make_fused_wan_v, quotient_coefficients)
    from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
    from nnpde_tpu_torch.ops import bump_w
    from nnpde_tpu_torch.ops.fwdlap import Jet
    from nnpde_tpu_torch.pde.poisson import rhs_f_for_u_sin

    rng = np.random.default_rng(300)
    up, vp = rand_params(rng, LAYERS, dev), rand_params(rng, CRITIC, dev)
    u_model = SolutionModel(NetSpec(LAYERS, activation="sin"),
                            factor_for_technique("FBC", dim=2, kind="box", L=L))
    v_model = SolutionModel(NetSpec(CRITIC, activation="sin"))
    X = torch.as_tensor(rng.uniform(0.0, L, (N, 2)).astype(np.float32), device=dev)
    f = rhs_f_for_u_sin(X, L, (1, 1))
    wv, dwv = bump_w(X, 0.0, L)
    Bu = u_model.factor.jet(X)
    v, gv = v_model.value_and_grad(vp, X, impl="kernel")
    phi, gphi = wv * v, dwv * v[:, None] + wv[:, None] * gv
    base = linear_functional_coefficients(Bu, b0=gphi, rhs=-f * phi, e1=Bu.value,
                                          e2=Bu.value * phi)
    u, gu = u_model.value_and_grad(up, X, impl="kernel")
    wjet = Jet(wv, dwv, torch.zeros_like(wv))
    vcoef = linear_functional_coefficients(wjet, c0=-f, b0=gu, e1=wv)
    qcoef = quotient_coefficients(Jet(torch.ones_like(wv), torch.zeros_like(X),
                                      torch.zeros_like(wv)), V=0.5)
    rcoef = quotient_coefficients(Bu, V=0.5 * torch.sum(X * X, dim=1))
    pn = torch.mean(phi ** 2)
    cases = [
        ("wan_u", make_fused_wan_u("sin", vol=4.0, w_pde=1.0, w_norm=10.0), up, (X, base)),
        ("wan_u_ratio_sq", make_fused_wan_u("sin", convention="ratio_sq", vol=4.0),
         up, (X, base)),
        ("wan_v", make_fused_wan_v("sin"), vp, (X, vcoef)),
        ("quad_mean", make_fused_quad_mean("sin", weight=2.0), vp, (X, qcoef)),
        ("rayleigh", make_fused_rayleigh("sin", weight=3.0), up, (X, rcoef)),
    ]
    rows = []
    for name, fn, params, (Xc, coef) in cases:
        got = []
        cpu = torch.device("cpu")
        for device, dtype in ((dev, torch.float32), (cpu, torch.float32), (cpu, torch.float64)):
            p = [(W.detach().to(device, dtype).requires_grad_(True),
                  b.detach().to(device, dtype).requires_grad_(True)) for W, b in params]
            args = (Xc.to(device, dtype), coef.detach().to(device, dtype))
            extra = []
            if name.startswith("wan_u"):
                E = torch.tensor(0.7, device=device, dtype=dtype, requires_grad=True)
                pnt = pn.detach().to(device, dtype).requires_grad_(True)
                total, _ = fn(p, E, args[0], args[1], pnt)
                extra = [E, pnt]
            else:
                total, _ = fn(p, *args)
            leaves = [t for pair in p for t in pair]
            g = torch.autograd.grad(total, leaves + extra)
            got.append((total.detach().double().cpu(),
                        torch.cat([t.reshape(-1).double().cpu() for t in g[:len(leaves)]]),
                        [t.double().cpu() for t in g[len(leaves):]]))
        ref = got[2]

        def rels(side):
            v, g, e = side
            out = {"value_rel": abs(float(v - ref[0])) / abs(float(ref[0])),
                   "grad_rel": float(torch.linalg.norm(g - ref[1]) / torch.linalg.norm(ref[1]))}
            if e:
                out["dE_rel"] = abs(float(e[0] - ref[2][0])) / abs(float(ref[2][0]))
                out["d_pn_rel"] = abs(float(e[1] - ref[2][1])) / abs(float(ref[2][1]))
            return out

        kern, plain32 = rels(got[0]), rels(got[1])
        row = {"objective": name, **kern,
               "plain_f32": plain32,
               "ok": all(v <= max(1e-5, 2.0 * plain32[k]) for k, v in kern.items())}
        rows.append(row)
    return rows


def phase_main_path():
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.problems import PoissonConfig, train_poisson_nd

    epochs = 3000
    base = dict(dim=2, method="PINN", bc_mode="FBC", epochs=epochs,
                n_interior=20000, chunk=1000)
    t0 = time.time()
    torch_run = train_poisson_nd(PoissonConfig(jet_impl="torch", **base))
    t_torch = time.time() - t0
    reset_launches()
    t0 = time.time()
    fused_run = train_poisson_nd(PoissonConfig(jet_impl="fused", **base))
    t_fused = time.time() - t0
    launches = {"fused_linear_residual": LAUNCHES["fused_linear_residual"]}
    MAIN_FUSED.update(rel_l2=fused_run["rel_l2"],
                      total0=float(fused_run["history"]["total"][0]),
                      steps_per_s=fused_run["result"].timing["steps_per_s"])
    side = {}
    for name, kw in (("fused_poisson_analytic", dict(coef_mode="analytic")),
                     ("fused_drm_energy", dict(method="DRM"))):
        cfg = dict(base, epochs=300, jet_impl="fused")
        cfg.update(kw)
        reset_launches()
        r = train_poisson_nd(PoissonConfig(**cfg))
        launches[name] = LAUNCHES[name]
        h = r["history"]["total"]
        side[name] = {"epochs": 300, "launches": LAUNCHES[name],
                      "loss_first": float(h[:20].mean()), "loss_last": float(h[-20:].mean()),
                      "rel_l2": r["rel_l2"],
                      "ok": bool(np.all(np.isfinite(h)) and h[-20:].mean() < h[:20].mean()
                                 and LAUNCHES[name] > 0)}
    rel_t, rel_f = torch_run["rel_l2"], fused_run["rel_l2"]
    ok = (rel_t <= 1e-3 and rel_f <= 1e-3 and rel_f <= max(2.0 * rel_t, 1e-3)
          and launches["fused_linear_residual"] == epochs
          and all(s["ok"] for s in side.values()))
    emit({"phase": "main_path", "epochs": epochs, "n_interior": 20000,
          "layers": list(LAYERS), "rel_l2_torch": rel_t, "rel_l2_fused": rel_f,
          "best_epoch_torch": torch_run["best_epoch"], "best_epoch_fused": fused_run["best_epoch"],
          "wall_s_torch": t_torch, "wall_s_fused": t_fused,
          "steps_per_s_torch": torch_run["result"].timing["steps_per_s"],
          "steps_per_s_fused": fused_run["result"].timing["steps_per_s"],
          "launches": launches, "side": side, "ok": ok})
    if not ok:
        raise SystemExit("main path check failed")
    return launches, fused_run["result"].timing["steps_per_s"]


def phase_wan_path():
    """The default 2D Poisson WAN on both jet paths, then extragradient."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.problems import PoissonConfig, train_poisson_nd

    epochs = 1000
    base = dict(dim=2, method="WAN", epochs=epochs, chunk=1000)
    t0 = time.time()
    torch_run = train_poisson_nd(PoissonConfig(jet_impl="torch", **base))
    t_torch = time.time() - t0
    reset_launches()
    t0 = time.time()
    fused_run = train_poisson_nd(PoissonConfig(jet_impl="fused", **base))
    t_fused = time.time() - t0
    launches = dict(LAUNCHES)
    reset_launches()
    eg = train_poisson_nd(PoissonConfig(jet_impl="fused", **dict(base, epochs=100),
                                        minimax="extragradient"))
    eg_launches = dict(LAUNCHES)
    ht, hf = torch_run["history"], fused_run["history"]
    first_rel = float(abs(hf["total"][0] - ht["total"][0]) / abs(ht["total"][0]))
    first10 = float(np.max(np.abs(hf["total"][:10] - ht["total"][:10])
                           / np.abs(ht["total"][:10])))
    # minimax trajectories are chaotic: where the two paths part, and how
    # the rel-L2 of each wanders after its early best
    apart = np.nonzero(np.abs(hf["total"] - ht["total"]) > 5e-2 * np.abs(ht["total"]))[0]
    rms_exact = 0.5  # ||u*||_rms in 2D
    l2_median = {name: float(np.median(h["l2"][epochs // 2:])) / rms_exact
                 for name, h in (("torch", ht), ("fused", hf))}
    finite = all(np.all(np.isfinite(h[k])) for h in (ht, hf, eg["history"])
                 for k in ("total", "l2", "wan_loss_v"))
    counts_ok = (all(launches[k] == n * epochs for k, n in WAN_PER_EPOCH.items())
                 and all(launches[k] == 0 for k in REPLACES))
    ok = (first_rel <= 1e-3 and first10 <= 5e-2 and torch_run["rel_l2"] <= 5e-2
          and fused_run["rel_l2"] <= 5e-2 and finite and counts_ok
          and all(eg_launches[k] > 0 for k in WAN_PER_EPOCH))
    emit({"phase": "wan_path", "epochs": epochs, "n_interior": 20000,
          "layers": list(LAYERS), "critic": list(CRITIC), "critic_steps": 5,
          "total0_rel": first_rel, "first10_max_rel": first10,
          "rel_l2_torch": torch_run["rel_l2"], "rel_l2_fused": fused_run["rel_l2"],
          "best_epoch_torch": torch_run["best_epoch"],
          "best_epoch_fused": fused_run["best_epoch"],
          "first_epoch_apart_5e-2": int(apart[0]) if apart.size else None,
          "median_rel_l2_second_half": l2_median,
          "wall_s_torch": t_torch, "wall_s_fused": t_fused,
          "epochs_per_s_torch": torch_run["result"].timing["steps_per_s"],
          "epochs_per_s_fused": fused_run["result"].timing["steps_per_s"],
          "launches": launches, "per_epoch": WAN_PER_EPOCH,
          "extragradient": {"epochs": 100, "rel_l2": eg["rel_l2"],
                            "launches": eg_launches,
                            "total_last": float(eg["history"]["total"][-1])},
          "finite": finite, "ok": ok})
    if not ok:
        raise SystemExit("WAN path check failed")
    return launches, fused_run["result"].timing["steps_per_s"]


def time_ms(fn, warmup=3, reps=15):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, launches=30, reps=5):
    """Device time of the launches ``fn`` makes, per call of ``fn``: the
    launches are captured once (pointers and workspace prepared by the
    wrapper, outside the timed window) and issued again ``launches`` times
    back to back inside one event pair, so the queue never runs dry and the
    wrapper's host work (checks, torch.cat, allocation) is not timed.  The
    floor is the host's time for one ctypes call, a few microseconds."""
    from nnpde_tpu_torch.kernels import _cuda

    with _cuda.capture() as cap:
        fn()
    cap.replay(3)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        cap.replay(launches)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def timed(kind, only):
    """Whether a timing row of ``kind`` runs: every row without a filter
    (``only`` None), else the kernels named in it (``--rows=``)."""
    return only is None or kind in only


def phase_timing(dev, only=None):
    rows = []
    for kind in REPLACES:
        if not timed(kind, only):
            continue
        for N in (20000, 262144):
            case = Case(kind, N, 2, LAYERS, "sin", seed=7, dev=dev)
            ms = time_ms(case.kernel)
            plain_ms = time_ms(lambda: case.plain(torch.float32), warmup=2, reps=7)
            rows.append({"kernel": kind, "N": N, "plan": fused_plan(kind, LAYERS, N, dev),
                         "ms": ms, "device_ms": device_ms(case.kernel), "plain_ms": plain_ms,
                         "bound_ms": case.bound_ms(), "flop": case.flops(),
                         "bound_by": ("operations" if case.flops() / FP32_PEAK
                                      >= case.bytes() / HBM_RATE else "bytes"),
                         "bytes": case.bytes(),
                         "gflops": case.flops() / (ms * 1e-3) / 1e9})
            del case
            torch.cuda.empty_cache()
    emit({"phase": "timing", "rows": rows})
    return rows


def launch_blocks(kind, layers, S, pl, dev, N):
    """Blocks the wrapper launched for this plan (read from its occupancy
    cache after a launch)."""
    from nnpde_tpu_torch.kernels import _cuda

    n_tiles = (N + pl.T - 1) // pl.T
    if hasattr(_cuda, "folds"):
        return _cuda.grid(kind, None, pl.smem, dev, n_tiles, int(_cuda.folds(layers, S, pl.T)))
    return _cuda.grid(kind, None, pl.smem, dev, n_tiles)


def pass_a_plan(kind, layers, lap, N, dev):
    """The launch shape the wrapper of row 4, 6, 7 or 9 takes on this net
    (as :func:`plan_row` prints it); row 6 on a tree whose stream-major
    forward still takes the constant 16-point tile: that tile."""
    from nnpde_tpu_torch.kernels import _cuda, _plan
    from nnpde_tpu_torch.kernels import fused_quotient as fq
    from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

    if kind.startswith("fwdlap_forward"):
        if kind == "fwdlap_forward_streams" and not hasattr(_plan, "check_planned"):
            return {"T": 16, "tier": "constant tile"}
        pl = fc.forward_plan(layers, N=N, sms=_cuda.sm_count(dev))
        return plan_row(kind, layers, layers[0] + 2, pl, N, dev)
    pl = fq.plan(kind, layers, lap, N=N, sms=_cuda.sm_count(dev))
    return plan_row(kind, layers, layers[0] + 1 + lap, pl, N, dev)


def bf16_forward_plan(layers, N, dev):
    """The launch shape of the row forward's bf16-dot variant, as
    :func:`plan_row` prints it: its tensor-core plan."""
    from nnpde_tpu_torch.kernels import fused_step as fs

    pl = fs.mma_plan("fwdlap_forward", layers)
    return plan_row("fwdlap_forward", layers, layers[0] + 2, pl, N, dev, bf16=True)


def quotient_plan(case):
    """The launch shape the quotient wrapper chose for this seeded case
    (after a launch): tile, shared memory, blocks, and what stays on chip."""
    from nnpde_tpu_torch.kernels import _plan
    from nnpde_tpu_torch.kernels import fused_quotient as fq

    pl = fq.plan(case.kind, case.layers, case.lap)
    blocks = launch_blocks(case.kind, case.layers, case.d + 1 + case.lap, pl, case.X.device,
                           case.N)
    return {"T": pl.T, "smem_bytes": pl.smem, "blocks": blocks, "tier": pl.tier,
            "resident": _plan.resident(pl, True)}


def phase_wan_timing(dev, only=None):
    """The WAN path's kernels on its nets at 20000 and 262144 points, and
    rows 4 and 7 on u64 at d = 5 (S = 7 and 6: the variants without the
    fold; ``"d": 5``)."""
    rows = []
    nets = {"u": LAYERS, "critic": CRITIC, "u_d5": U5}
    for kind in WAN_REPLACES:
        if not timed(kind, only):
            continue
        for net in (("u", "critic", "u_d5") if kind in ("fwdlap_forward", "linear_sums")
                    else ("u", "critic") if kind.startswith("linear") else ("critic",)):
            for N in (20000, 262144):
                case = WanCase(kind, N, nets[net], "sin", seed=9, dev=dev)
                ms = time_ms(case.kernel)
                plain_ms = time_ms(lambda: case.plain(torch.float32), warmup=2, reps=7)
                rows.append({"kernel": kind, "net": net.split("_")[0], "d": case.d, "N": N,
                             "plan": quotient_plan(case) if kind.endswith("seeded") else
                             pass_a_plan(kind, case.layers, 0, N, dev),
                             "ms": ms,
                             "device_ms": device_ms(case.kernel),
                             "plain_ms": plain_ms, "bound_ms": case.bound_ms(),
                             "bound_by": case.bound_by(), "flop": case.flops(),
                             "bytes": case.bytes(),
                             "gflops": case.flops() / (ms * 1e-3) / 1e9})
                del case
                torch.cuda.empty_cache()
    emit({"phase": "wan_timing", "rows": rows})
    return rows


class EigenCase:
    """One kernel of the infinite-well slice at one shape: points, params
    and (for the K-bump pair) a random coefficient stream and seeds."""

    def __init__(self, kind, N, layers, act, seed, dev, Kb=EIGEN_BUMPS):
        rng = np.random.default_rng(seed)
        self.kind, self.N, self.layers, self.act, self.Kb = kind, N, layers, act, Kb
        self.d = d = layers[0]
        self.params = rand_params(rng, layers, dev)
        self.X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
        self.ct = self.coef = self.scal = None
        if kind == "fwdlap_backward":
            self.ct = torch.as_tensor(rng.normal(size=(N, d + 2)).astype(np.float32),
                                      device=dev)
        elif kind.startswith("multi"):
            self.coef = torch.as_tensor(
                rng.normal(size=(N, Kb * (d + 4))).astype(np.float32), device=dev)
            self.scal = torch.as_tensor(rng.normal(size=(3 * Kb,)).astype(np.float32),
                                        device=dev)

    def kernel(self):
        """The wrapper's launch, as one flat tensor."""
        from nnpde_tpu_torch.kernels import fused_multibump as fm
        from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

        if self.kind == "fwdlap_forward_streams":
            return fc.fwdlap_forward(self.params, self.X, self.act, "streams")
        if self.kind == "fwdlap_backward":
            dWs, dbs = fc.fwdlap_backward(self.params, self.X, self.ct, self.act)
            return torch.cat([t.reshape(-1) for pair in zip(dWs, dbs) for t in pair])
        return fm._launch(self.kind == "multi_seeded", self.params, self.X, self.coef,
                          self.scal, self.act, self.Kb)

    def plain(self, dtype):
        """The plain version on the card, in the kernel's output layout."""
        from nnpde_tpu_torch.kernels import fused_multibump as fm
        from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

        p = [(W.to(dtype), b.to(dtype)) for W, b in self.params]
        X = self.X.to(dtype)
        if self.kind == "fwdlap_forward_streams":
            jet = fc.fwdlap_forward_plain(p, X, self.act)
            return torch.cat([jet.value[:, None], jet.grad, jet.lap[:, None]], dim=1)
        if self.kind == "fwdlap_backward":
            dWs, dbs = fc.fwdlap_backward_plain(p, X, self.ct.to(dtype), self.act)
            return torch.cat([t.reshape(-1) for pair in zip(dWs, dbs) for t in pair])
        coef, scal = self.coef.to(dtype), self.scal.to(dtype)
        if self.kind == "multi_sums":
            return fm.fused_multi_sums_plain(p, X, coef, self.act, self.Kb)
        dWs, dbs, sums = fm.fused_multi_seeded_grads_plain(p, X, coef, scal, self.act, self.Kb)
        # the kernel's row: [dW0, db0, ..., dW_last, (unwritten) b_last | sum ct_v]
        flat = [t.reshape(-1) for dW, db in zip(dWs, dbs) for t in (dW, db)]
        flat[-1] = torch.zeros_like(flat[-1])
        return torch.cat(flat + [sums])

    def abs_terms(self):
        """Float64 sum of the magnitudes of each multibump sum's terms:
        the 3 Kb sums of pass A, or pass B's sum ct_v (random coefficients
        make the signed sums nearly cancel)."""
        from nnpde_tpu_torch.kernels.fused_multibump import _multi_terms
        from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap

        p = [(W.double(), b.double()) for W, b in self.params]
        jet = mlp_fwdlap(p, self.X.double(), self.act)
        c, K, blk = self.coef.double(), self.Kb, self.d + 2
        if self.kind == "multi_sums":
            r, mass, lin = _multi_terms(jet, c, K, self.d)
            return torch.cat([r.abs().sum(0), mass.sum(0), lin.abs().sum(0)])
        s = self.scal.double()
        e1, e2 = c[:, K * blk:K * blk + K], c[:, K * blk + K:K * blk + 2 * K]
        ctv = torch.sum(s[:K] * c[:, 0:K * blk:blk] + s[K:2 * K] * 2.0 * e1 * e1
                        * jet.value[:, None] + s[2 * K:] * e2, dim=1)
        return ctv.abs().sum()

    def flops(self):
        """Backward 6 (d+2) MACs, streams forward 2 (d+2) MACs, multi sums
        2 (d+1) MACs, multi seeded 6 (d+1) MACs per point, plus the K-bump
        epilogue: per bump 2d + 5 (sums) or 2d + 7 (seeded) operations."""
        d, K, m = self.d, self.Kb, macs(self.layers)
        per = {"fwdlap_backward": 6.0 * (d + 2) * m,
               "fwdlap_forward_streams": 2.0 * (d + 2) * m,
               "multi_sums": 2.0 * (d + 1) * m + K * (2 * d + 5),
               "multi_seeded": 6.0 * (d + 1) * m + K * (2 * d + 7)}[self.kind]
        return per * self.N

    def bytes(self):
        """X + cotangents or coefficients + parameters + outputs."""
        d, K = self.d, self.Kb
        P = sum(a * b + b for a, b in zip(self.layers[:-1], self.layers[1:]))
        per_point = {"fwdlap_backward": d + (d + 2), "fwdlap_forward_streams": d + (d + 2),
                     "multi_sums": d + K * (d + 4), "multi_seeded": d + K * (d + 4)}[self.kind]
        fixed = {"fwdlap_backward": 2 * P, "fwdlap_forward_streams": P,
                 "multi_sums": P + 3 * K, "multi_seeded": 2 * P + 1 + 3 * K}[self.kind]
        return 4.0 * (self.N * per_point + fixed)

    def bound_ms(self):
        return 1e3 * max(self.flops() / FP32_PEAK, self.bytes() / HBM_RATE)

    def bound_by(self):
        return "operations" if self.flops() / FP32_PEAK >= self.bytes() / HBM_RATE else "bytes"


def phase_eigen_kernels(dev):
    """The four kernels of the infinite-well slice (fp32) against their plain
    versions (fp64) on the card; repeats bitwise; the multibump objectives;
    one earlier kernel at width 50."""
    U5, W10 = (5, 50, 50, 1), (2, 10, 10, 1)
    jet_shapes = [(EIGEN_N, EIGEN_U, "sin"), (EIGEN_N + 7, EIGEN_U, "sin"),
                  (EIGEN_N, EIGEN_V, "sin"), (EIGEN_N + 7, EIGEN_V, "sin"),
                  (EIGEN_N + 7, U5, "tanh"), (EIGEN_N + 7, W10, "sin")]
    multi_shapes = ([(N, net, "sin", K) for net in (EIGEN_U, EIGEN_V)
                     for K in (1, 4, 16, 36) for N in (EIGEN_N, EIGEN_N + 7)]
                    + [(EIGEN_N + 7, U5, "tanh", 4), (EIGEN_N + 7, W10, "sin", 4)])
    shapes = {"fwdlap_backward": [s + (0,) for s in jet_shapes],
              "fwdlap_forward_streams": [s + (0,) for s in jet_shapes],
              "multi_sums": multi_shapes, "multi_seeded": multi_shapes}
    rows, max_err = [], {}
    for kind in EIGEN_REPLACES:
        for i, (N, layers, act, Kb) in enumerate(shapes[kind]):
            case = EigenCase(kind, N, layers, act, seed=400 + i, dev=dev, Kb=max(Kb, 1))
            out, out2 = case.kernel(), case.kernel()
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(out, out2))
            ref = case.plain(torch.float64)
            err = float(torch.max(torch.abs(out.double() - ref)))
            row = {"kernel": kind, "N": N, "layers": list(layers), "act": act,
                   "max_abs_err": err, "bitwise_repeat": bitwise}
            if kind == "fwdlap_forward_streams":
                # row 6 is row 4's kernel on row 4's plan with its stream-major
                # write: the same floats
                from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

                row["col_rel"] = col_rel(out, ref)
                row["equals_rows"] = bool(torch.equal(
                    out, fc.fwdlap_forward(case.params, case.X, case.act)))
                ok = row["col_rel"] <= 1e-5 and row["equals_rows"]
            elif kind == "fwdlap_backward":
                row["grad_rel"] = float(torch.linalg.norm(out.double() - ref)
                                        / torch.linalg.norm(ref))
                ok = row["grad_rel"] <= 1e-5
            elif kind == "multi_sums":
                row["n_bumps"] = Kb
                row["sum_err_over_abs_terms"] = float(torch.max(
                    torch.abs(out.double() - ref) / case.abs_terms()))
                ok = row["sum_err_over_abs_terms"] <= 1e-5
            else:
                P = out.numel() - 1
                row["n_bumps"] = Kb
                row["grad_rel"] = float(torch.linalg.norm(out[:P].double() - ref[:P])
                                        / torch.linalg.norm(ref[:P]))
                row["ctv_err_over_abs_terms"] = (abs(float(out[P]) - float(ref[P]))
                                                 / float(case.abs_terms()))
                ok = row["grad_rel"] <= 1e-5 and row["ctv_err_over_abs_terms"] <= 1e-5
            row["ok"] = ok and bitwise
            max_err[kind] = max(max_err.get(kind, 0.0), err)
            rows.append(row)
            del case, out, out2, ref
            torch.cuda.empty_cache()
    # an earlier kernel at a width that is not a multiple of 4
    case = Case("fused_linear_residual", EIGEN_N + 7, 2, EIGEN_U, "sin", seed=499, dev=dev)
    loss, _, grads = case.kernel()
    loss2, _, grads2 = case.kernel()
    torch.cuda.synchronize()
    ref_loss, ref_grads = case.plain(torch.float64)
    w50 = {"kernel": "fused_linear_residual", "N": EIGEN_N + 7, "layers": list(EIGEN_U),
           "loss_rel": abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
           "grad_rel": tree_rel(grads, ref_grads),
           "bitwise_repeat": bool(torch.equal(loss, loss2)) and all(
               torch.equal(x, y) for pa, pb in zip(grads, grads2) for x, y in zip(pa, pb))}
    w50["ok"] = w50["loss_rel"] <= 1e-5 and w50["grad_rel"] <= 1e-5 and w50["bitwise_repeat"]
    del case
    emit({"phase": "eigen_kernels", "tol": 1e-5, "rows": rows, "width50": w50})
    obj = eigen_objectives(dev)
    emit({"phase": "eigen_objectives", "tol": 1e-5, "rows": obj})
    if not all(r["ok"] for r in rows + obj + [w50]):
        raise SystemExit("eigen kernel vs plain comparison failed")
    return max_err


def eigen_objectives(dev, N=EIGEN_N + 7, grid=4):
    """The two multibump objectives on the card (kernels) against the same
    objectives on the plain route (CPU, float64), on the coefficient streams
    the WAN path builds for 16 bumps: value, parameter gradients, and dE /
    d phi_norms of the primal.  Each number is held to the larger of 1e-5
    and twice the error of the plain route itself in float32 (on the CPU)
    against float64, as for the single-bump objectives."""
    from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
    from nnpde_tpu_torch.ops import bump_grid, bump_w_multi
    from nnpde_tpu_torch.pde import ipw
    from nnpde_tpu_torch.problems._fused_wan import make_fused_wan_multi_pair

    rng = np.random.default_rng(500)
    up, vp = rand_params(rng, EIGEN_U, dev), rand_params(rng, EIGEN_V, dev)
    nodes = [ipw.nodes(3, L), ipw.nodes(3, L)]
    u_model = SolutionModel(NetSpec(EIGEN_U, activation="sin"),
                            factor_for_technique("FN", dim=2, kind="box", L=L,
                                                 nodes_per_dim=nodes))
    v_model = SolutionModel(NetSpec(EIGEN_V, activation="sin"),
                            factor_for_technique("FBC", dim=2, kind="box", L=L))
    Xc = torch.as_tensor(rng.uniform(0.0, L, (N, 2)).astype(np.float32), device=dev)
    centers, hw = bump_grid(0.0, L, 2, grid)
    Kb = centers.shape[0]
    E0 = ipw.energy_2d(3, 3, L)
    rows = []
    cpu = torch.device("cpu")
    for name in ("wan_multi_u", "wan_multi_v"):
        got = []
        for device, dtype in ((dev, torch.float32), (cpu, torch.float32), (cpu, torch.float64)):
            cast = lambda ps, grad: [(W.detach().to(device, dtype).requires_grad_(grad),
                                      b.detach().to(device, dtype).requires_grad_(grad))
                                     for W, b in ps]
            X = Xc.to(device, dtype)
            wv, dwv = bump_w_multi(X, centers, hw)
            # on the card the frozen net's jet comes from the jet kernel
            pair = make_fused_wan_multi_pair(u_model, v_model, Kb, w_pde=10.0, w_norm=1000.0,
                                             vol=L * L)
            E = torch.tensor(E0, device=device, dtype=dtype, requires_grad=name == "wan_multi_u")
            if name == "wan_multi_u":
                p = cast(up, True)
                total, aux = pair.u_pde_fn(p, E, cast(vp, False), X, wv, dwv)
                extra = [E]
            else:
                p = cast(vp, True)
                total, aux = pair.v_loss_fn(p, cast(up, False), E, X, wv, dwv)
                extra = []
            leaves = [t for pr in p for t in pr]
            g = torch.autograd.grad(total, leaves + extra)
            got.append((total.detach().double().cpu(),
                        torch.cat([t.reshape(-1).double().cpu() for t in g[:len(leaves)]]),
                        [t.double().cpu() for t in g[len(leaves):]]))
        ref = got[2]

        def rels(side):
            v, g, e = side
            out = {"value_rel": abs(float(v - ref[0])) / abs(float(ref[0])),
                   "grad_rel": float(torch.linalg.norm(g - ref[1]) / torch.linalg.norm(ref[1]))}
            if e:
                out["dE_rel"] = abs(float(e[0] - ref[2][0])) / abs(float(ref[2][0]))
            return out

        kern, plain32 = rels(got[0]), rels(got[1])
        rows.append({"objective": name, "n_bumps": int(Kb), **kern, "plain_f32": plain32,
                     "ok": all(v <= max(1e-5, 2.0 * plain32[k]) for k, v in kern.items())})
    rows.append(eigen_phi_norm_grad(dev, u_model, up, Xc, Kb))
    return rows


def eigen_phi_norm_grad(dev, u_model, up, Xc, Kb):
    """d loss / d phi_norms of the multibump primal on the card against the
    plain route in float64 (random first-order streams, 16 bumps)."""
    from nnpde_tpu_torch.kernels import (linear_functional_coefficients,
                                         make_fused_wan_multi_u,
                                         pack_multibump_coefficients)

    rng = np.random.default_rng(501)
    N = Xc.shape[0]
    phi = rng.normal(size=(Kb, N)).astype(np.float32)
    gphi = rng.normal(size=(Kb, N, 2)).astype(np.float32)
    loss = make_fused_wan_multi_u("sin", Kb, vol=L * L, w_pde=10.0, w_norm=1000.0)
    got = []
    for device, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float64)):
        X = Xc.to(device, dtype)
        ph = torch.as_tensor(phi).to(device, dtype)
        gp = torch.as_tensor(gphi).to(device, dtype)
        Bu = u_model.factor.jet(X)
        zero = torch.zeros_like(Bu.value)
        base = pack_multibump_coefficients([
            linear_functional_coefficients(Bu, b0=0.5 * gp[k], e1=Bu.value if k == 0 else zero,
                                           e2=Bu.value * ph[k]) for k in range(Kb)])
        pn = torch.mean(ph ** 2, dim=1).requires_grad_(True)
        p = [(W.detach().to(device, dtype), b.detach().to(device, dtype)) for W, b in up]
        total, _ = loss(p, torch.tensor(2.0, device=device, dtype=dtype), X, base, pn)
        got.append(torch.autograd.grad(total, [pn])[0].double().cpu())
    rel = float(torch.linalg.norm(got[0] - got[1]) / torch.linalg.norm(got[1]))
    return {"objective": "wan_multi_u_d_phi_norms", "n_bumps": int(Kb), "d_pn_rel": rel,
            "ok": rel <= 1e-5}


def _first_band(a, b):
    """(rel of the first total, max rel over the first 10) of two runs."""
    ha, hb = a["history"]["total"], b["history"]["total"]
    return (float(abs(hb[0] - ha[0]) / abs(ha[0])),
            float(np.max(np.abs(hb[:10] - ha[:10]) / np.abs(ha[:10]))))


def _rel_l2_first(out):
    """The rel_l2 of a ``train_ipw_2d`` run at its first evaluation."""
    return float(np.sqrt(out["history"]["l2"][0] / out["L2_error"]) * out["rel_l2"])


def phase_eigen_path():
    """``train_ipw_2d`` at the default nets and grid, state (3, 3), FN."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.problems import IPW2DConfig, train_ipw_2d

    base = dict(nx=3, ny=3, technique="FN", chunk=1000)
    default = IPW2DConfig()
    if (default.layers, default.v_layers, default.grid_n ** 2) != (EIGEN_U, EIGEN_V, EIGEN_N):
        raise SystemExit("IPW2DConfig's defaults are not the full-width nets and grid")

    def run(**kw):
        reset_launches()
        t0 = time.time()
        out = train_ipw_2d(IPW2DConfig(**dict(base, **kw)))
        return out, {k: v for k, v in LAUNCHES.items() if v}, time.time() - t0

    def only(counts, want):
        return counts == {k: v for k, v in want.items() if v}

    report, launches = {"phase": "eigen_path", "layers": list(EIGEN_U),
                        "v_layers": list(EIGEN_V), "grid_points": EIGEN_N, "state": [3, 3],
                        "technique": "FN"}, {}
    # ---- PINN, weights {'data': 1e4}, the three jet routes from one seed
    epochs = 500
    pinn = dict(method="PINN", weights={"data": 1e4}, epochs=epochs)
    runs = {impl: run(jet_impl=impl, **pinn) for impl in ("torch", "kernel", "fused")}
    rel_t = runs["torch"][0]["rel_l2"]
    pinn_rows, ok = {}, True
    want_counts = {"torch": {}, "kernel": {"fwdlap_forward": epochs, "fwdlap_backward": epochs},
                   "fused": {"fused_linear_residual": epochs}}
    for impl, (out, counts, wall) in runs.items():
        first, first10 = _first_band(runs["torch"][0], out)
        h = out["history"]["total"]
        row = {"rel_l2": out["rel_l2"], "min_epoch": out["min_epoch"], "wall_s": wall,
               "steps_per_s": out["result"].timing["steps_per_s"], "launches": counts,
               "total0_rel": first, "first10_max_rel": first10,
               "total_first": float(h[0]), "total_last": float(h[-1]),
               "rel_l2_first": _rel_l2_first(out)}
        row["ok"] = bool(np.all(np.isfinite(h)) and first <= 1e-4 and first10 <= 5e-2
                         and out["rel_l2"] <= 1.2 * rel_t
                         and out["L2_error"] < out["history"]["l2"][0]
                         and only(counts, want_counts[impl]))
        ok = ok and row["ok"]
        pinn_rows[impl] = row
    launches["fwdlap_backward"] = runs["kernel"][1].get("fwdlap_backward", 0)
    report["pinn"] = {"epochs": epochs, "cut_from": 20000, "runs": pinn_rows}
    # ---- DRM on the fused Rayleigh quotient.  On this excited state the
    # Rayleigh quotient slides towards lower states until the orthogonality
    # and parity penalties throw it back (a sawtooth, on both routes), so
    # the loss is held to track the autograd route's first epochs and to
    # fall below its first value, not to end below it
    ref, _, _ = run(method="DRM", jet_impl="torch", epochs=100)
    out, counts, wall = run(method="DRM", jet_impl="fused", epochs=300)
    h = out["history"]["total"]
    first, first10 = _first_band(ref, out)
    windows = h.reshape(-1, 20).mean(axis=1)
    drm_ok = bool(np.all(np.isfinite(h)) and windows.min() < h[0]
                  and first <= 1e-4 and first10 <= 5e-2
                  and only(counts, {"quad_sums": 300, "quad_seeded": 300}))
    report["drm_fused"] = {"epochs": 300, "launches": counts, "wall_s": wall,
                           "total0_rel": first, "first10_max_rel": first10,
                           "loss_first": float(h[0]),
                           "loss_first20": float(h[:20].mean()),
                           "loss_min_of_20_epoch_means": float(windows.min()),
                           "loss_last20": float(h[-20:].mean()),
                           "rayleigh_first": float(out["history"]["drm"][0]),
                           "rayleigh_min": float(out["history"]["drm"].min()),
                           "rel_l2": out["rel_l2"], "ok": drm_ok}
    # ---- WAN, 16 localised bumps, both jet routes from one seed
    epochs = 250
    wan = dict(method="WAN", n_test_grid=4, epochs=epochs)
    wt, ct, wall_t = run(jet_impl="torch", **wan)
    wf, cf, wall_f = run(jet_impl="fused", **wan)
    launches.update({k: cf.get(k, 0) for k in ("multi_sums", "multi_seeded")})
    first, first10 = _first_band(wt, wf)
    # the total is dominated by the data term: hold the weak-form term too
    pde0 = float(abs(wf["history"]["pde"][0] - wt["history"]["pde"][0])
                 / abs(wt["history"]["pde"][0]))
    finite = all(np.all(np.isfinite(r["history"][k])) for r in (wt, wf)
                 for k in ("total", "l2", "wan_loss_v", "pde"))
    falling = all(r["L2_error"] < r["history"]["l2"][0] for r in (wt, wf))
    wan_ok = bool(first <= 1e-4 and first10 <= 5e-2 and pde0 <= 1e-3 and finite and falling
                  and wf["rel_l2"] <= 1.2 * wt["rel_l2"] and only(ct, {})
                  and only(cf, {k: n * epochs for k, n in EIGEN_WAN_PER_EPOCH.items()}))
    report["wan"] = {
        "epochs": epochs, "n_bumps": EIGEN_BUMPS, "v_steps": 5, "total0_rel": first,
        "first10_max_rel": first10, "pde0_rel": pde0, "finite": finite,
        "rel_l2_torch": wt["rel_l2"], "rel_l2_fused": wf["rel_l2"],
        "rel_l2_first_torch": _rel_l2_first(wt), "rel_l2_first_fused": _rel_l2_first(wf),
        "min_epoch_torch": wt["min_epoch"], "min_epoch_fused": wf["min_epoch"],
        "wall_s_torch": wall_t, "wall_s_fused": wall_f,
        "epochs_per_s_torch": wt["result"].timing["steps_per_s"],
        "epochs_per_s_fused": wf["result"].timing["steps_per_s"],
        "launches": cf, "per_epoch": EIGEN_WAN_PER_EPOCH, "ok": wan_ok}
    side_ok = True
    for name, kw, per in (("grid_jitter", dict(grid_jitter=True), EIGEN_JITTER_PER_EPOCH),
                          ("extragradient", dict(minimax="extragradient"), EIGEN_EG_PER_EPOCH)):
        out, counts, wall = run(jet_impl="fused", **dict(wan, epochs=100), **kw)
        h = out["history"]
        s_ok = bool(all(np.all(np.isfinite(h[k])) for k in ("total", "l2", "wan_loss_v"))
                    and only(counts, {k: n * 100 for k, n in per.items()}))
        report["wan_" + name] = {"epochs": 100, "launches": counts, "per_epoch": per,
                                 "wall_s": wall, "rel_l2": out["rel_l2"],
                                 "total_last": float(h["total"][-1]), "ok": s_ok}
        side_ok = side_ok and s_ok
    # ---- the stream-major jet forward on a path
    out, counts, wall = run(jet_impl="kernel:streams", **dict(pinn, epochs=100))
    ref = runs["kernel"][0]["history"]["total"][:100]
    h = out["history"]["total"]
    st_ok = bool(np.all(np.isfinite(h)) and abs(h[0] - ref[0]) <= 1e-4 * abs(ref[0])
                 and only(counts, {"fwdlap_forward_streams": 100, "fwdlap_backward": 100}))
    launches["fwdlap_forward_streams"] = counts.get("fwdlap_forward_streams", 0)
    report["pinn_streams"] = {"epochs": 100, "launches": counts, "wall_s": wall,
                              "total0_rel_vs_kernel": float(abs(h[0] - ref[0]) / abs(ref[0])),
                              "ok": st_ok}
    report["ok"] = bool(ok and drm_ok and wan_ok and side_ok and st_ok)
    emit(report)
    if not report["ok"]:
        raise SystemExit("eigen path check failed")
    return launches, {"pinn_steps_per_s": {k: r["steps_per_s"] for k, r in pinn_rows.items()},
                      "wan_epochs_per_s_fused": report["wan"]["epochs_per_s_fused"]}


def multibump_plan(case):
    """The launch shape the K-bump wrapper chose for this case (after a
    launch): tile, shared memory, blocks, and what stays on chip."""
    from nnpde_tpu_torch.kernels import fused_multibump as fm

    try:
        from nnpde_tpu_torch.kernels._plan import resident
    except ImportError:        # a tree whose plan lives in fused_multibump.py
        resident = fm.resident
    seeded = case.kind == "multi_seeded"
    pl = fm.plan(seeded, case.layers, case.Kb)
    blocks = launch_blocks(case.kind, case.layers, case.d + 1, pl, case.X.device, case.N)
    return {"T": pl.T, "smem_bytes": pl.smem, "blocks": blocks, "tier": pl.tier,
            "resident": resident(pl, seeded)}


def phase_eigen_timing(dev, only=None):
    rows = []
    nets = {"u": EIGEN_U, "critic": EIGEN_V}
    for kind in EIGEN_REPLACES:
        if not timed(kind, only):
            continue
        for net in (("u", "critic") if kind.startswith("multi") else ("u",)):
            for N in (EIGEN_N, 262144):
                case = EigenCase(kind, N, nets[net], "sin", seed=11, dev=dev)
                ms = time_ms(case.kernel)
                plain_ms = time_ms(lambda: case.plain(torch.float32), warmup=2, reps=7)
                rows.append({"kernel": kind, "net": net, "N": N, "n_bumps": case.Kb
                             if kind.startswith("multi") else None,
                             "plan": multibump_plan(case) if kind.startswith("multi")
                             else fused_plan(kind, case.layers, N, dev)
                             if kind == "fwdlap_backward"
                             else pass_a_plan(kind, case.layers, 0, N, dev), "ms": ms,
                             "device_ms": device_ms(case.kernel),
                             "plain_ms": plain_ms, "bound_ms": case.bound_ms(),
                             "bound_by": case.bound_by(), "flop": case.flops(),
                             "bytes": case.bytes(),
                             "gflops": case.flops() / (ms * 1e-3) / 1e9,
                             "gbytes_per_s": case.bytes() / (ms * 1e-3) / 1e9})
                del case
                torch.cuda.empty_cache()
    # the earlier kernels that the infinite-well paths launch, at the shapes
    # those paths give them (width 50 and 20, 40000 points)
    others = []
    for N in ((EIGEN_N, 262144) if timed("fused_linear_residual", only) else ()):
        case = Case("fused_linear_residual", N, 2, EIGEN_U, "sin", seed=12, dev=dev)
        others.append({"kernel": "fused_linear_residual", "net": "u", "N": N,
                       "ms": time_ms(case.kernel), "device_ms": device_ms(case.kernel),
                       "bound_ms": case.bound_ms(),
                       "plan": fused_plan("fused_linear_residual", EIGEN_U, N, dev)})
        del case
    # (the DRM path's Rayleigh pair, and the jet forward, at 262144 as well)
    for kind, net, N in (("fwdlap_forward", "u", EIGEN_N), ("fwdlap_forward", "critic", EIGEN_N),
                         ("fwdlap_forward", "u", 262144), ("fwdlap_forward", "critic", 262144),
                         ("quad_sums", "u", EIGEN_N), ("quad_seeded", "u", EIGEN_N),
                         ("quad_sums", "u", 262144), ("quad_seeded", "u", 262144)):
        if not timed(kind, only):
            continue
        case = WanCase(kind, N, nets[net], "sin", seed=13, dev=dev)
        ms = time_ms(case.kernel)
        others.append({"kernel": kind, "net": net, "N": N, "ms": ms,
                       "device_ms": device_ms(case.kernel), "bound_ms": case.bound_ms(),
                       "plain_ms": time_ms(lambda: case.plain(torch.float32), warmup=2, reps=7),
                       "plan": quotient_plan(case) if kind.endswith("seeded") else
                       pass_a_plan(kind, case.layers, 0, N, dev)})
        del case
        torch.cuda.empty_cache()
    emit({"phase": "eigen_timing", "rows": rows, "earlier_kernels": others})
    return rows


SWEEP_TILES = (16, 24, 32, 48, 64, 96)
SWEEP_TIERS = ("resident", "gradient", "staged")   # a tier a pass lacks raises


def phase_multibump_sweep(dev):
    """The K-bump pair on the two infinite-well nets at N = 40000 and 262144,
    at every (tier, T) of SWEEP_TILES that fits: each launch held to its
    float64 plain version (pass A: every sum within 1e-5 of the sum of its
    terms' magnitudes; pass B: gradient row rel <= 1e-5), launched twice for
    a bitwise-equal repeat, and timed as device time.  One JSON line per
    case; the plan's own choice carries ``"chosen": true``."""
    from nnpde_tpu_torch.kernels import _build
    from nnpde_tpu_torch.kernels import fused_multibump as fm

    emit({"phase": "sweep", "ptxas": [
        ln.strip() for ln in _build.BUILD_LOG.get("ptxas", "").splitlines()
        if "Compiling entry" in ln or "registers" in ln or "spill" in ln]})
    ok = True
    for net_name, layers in (("critic", EIGEN_V), ("u", EIGEN_U)):
        for kind in ("multi_sums", "multi_seeded"):
            seeded = kind == "multi_seeded"
            chosen = fm.plan(seeded, layers, EIGEN_BUMPS)
            plans = [chosen]
            for tier in SWEEP_TIERS:
                for T in SWEEP_TILES:
                    try:
                        pl = fm.plan(seeded, layers, EIGEN_BUMPS, T=T, tier=tier)
                    except ValueError:
                        continue
                    if pl not in plans:
                        plans.append(pl)
            for N in (EIGEN_N, 262144):
                case = EigenCase(kind, N, layers, "sin", seed=21, dev=dev)
                ref = case.plain(torch.float64)
                scale = case.abs_terms()
                for pl in plans:
                    def run(pl=pl):
                        return fm._launch(seeded, case.params, case.X, case.coef, case.scal,
                                          case.act, case.Kb, pl=pl)
                    out, out2 = run(), run()
                    torch.cuda.synchronize()
                    if seeded:
                        P = out.numel() - 1
                        err = float(torch.linalg.norm(out[:P].double() - ref[:P])
                                    / torch.linalg.norm(ref[:P]))
                        err = max(err, abs(float(out[P]) - float(ref[P])) / float(scale))
                    else:
                        err = float(torch.max(torch.abs(out.double() - ref) / scale))
                    good = err <= 1e-5 and bool(torch.equal(out, out2))
                    ok = ok and good
                    emit({"kernel": kind, "net": net_name, "N": N, "tier": pl.tier, "T": pl.T,
                          "flags": pl.flags, "smem": pl.smem,
                          "blocks": launch_blocks(kind, layers, layers[0] + 1, pl,
                                                  case.X.device, N),
                          "err": err, "ok": good, "chosen": pl == chosen,
                          "device_ms": device_ms(run), "bound_ms": case.bound_ms()})
                del case
                torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("multibump sweep: a case missed its bar")


# the seeded quotient kernels on the nets of their paths, at the path's N
QSWEEP = (("linear_seeded", "critic", CRITIC, 20000), ("linear_seeded", "u", LAYERS, 20000),
          ("quad_seeded", "critic", CRITIC, 20000), ("quad_seeded", "u50", EIGEN_U, EIGEN_N))
QSWEEP_TILES = (8, 16, 20, 24, 32, 48)


def phase_quotient_sweep(dev):
    """The two seeded quotient kernels at every (tier, T) of QSWEEP_TILES
    that fits, at each net's path N and at 262144: each launch held to its
    float64 plain version (gradient row and sum ct_v rel <= 1e-5), launched
    twice for a bitwise-equal repeat, and timed as device time.  One JSON
    line per case; ``chosen`` marks the plan's own choice."""
    from nnpde_tpu_torch.kernels import fused_quotient as fq

    ok = phase_pass_a_sweep(dev, SUMS_SWEEP, "sums")
    for kind, net_name, layers, n_path in QSWEEP:
        for N in (n_path, 262144):
            case = WanCase(kind, N, layers, "sin", seed=23, dev=dev)
            ref = case.plain(torch.float64)
            P = ref.numel() - 1
            chosen = fq.plan(kind, layers, 0)
            plans = [chosen]
            for tier in SWEEP_TIERS:
                for T in QSWEEP_TILES:
                    try:
                        pl = fq.plan(kind, layers, 0, T=T, tier=tier)
                    except ValueError:
                        continue
                    if pl not in plans:
                        plans.append(pl)
            for pl in plans:
                def run(pl=pl):
                    return fq._launch(kind, case.params, case.X, case.coef, case.scal,
                                      case.act, 0, pl=pl)
                out, out2 = run(), run()
                torch.cuda.synchronize()
                err = max(float(torch.linalg.norm(out[:P].double() - ref[:P])
                                / torch.linalg.norm(ref[:P])),
                          abs(float(out[P]) - float(ref[P])) / abs(float(ref[P])))
                good = err <= 1e-5 and bool(torch.equal(out, out2))
                ok = ok and good
                emit({"kernel": kind, "net": net_name, "N": N, "err": err, "ok": good,
                      "device_ms": device_ms(run), "bound_ms": case.bound_ms(),
                      "tier": pl.tier, "T": pl.T, "flags": pl.flags, "smem": pl.smem,
                      "blocks": launch_blocks(kind, layers, layers[0] + 1, pl, case.X.device,
                                              N),
                      "chosen": pl == chosen})
            del case, ref
            torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("quotient sweep: a case missed its bar")


# Rows 4, 6, 7 and 9 (the forward-only kernels) on the nets of their paths,
# at the path's N (and 262144): the jet forward on the Poisson WAN's u and
# critic, the infinite-well u50 and c20 and u64 at d = 5, and in its
# stream-major layout (row 6) on the infinite-well u50; pass A of the
# linear weak form (Poisson WAN critic and u, u64 at d = 5) and of the
# quadratic energy (the critic regulariser, the infinite-well DRM's u50).
U5 = (5, 64, 64, 64, 64, 1)
FWD_SWEEP = (("fwdlap_forward", "u", LAYERS, 20000), ("fwdlap_forward", "critic", CRITIC, 20000),
             ("fwdlap_forward", "u50", EIGEN_U, EIGEN_N),
             ("fwdlap_forward", "c20", EIGEN_V, EIGEN_N), ("fwdlap_forward", "u_d5", U5, 20000),
             ("fwdlap_forward_streams", "u50", EIGEN_U, EIGEN_N))
SUMS_SWEEP = (("linear_sums", "critic", CRITIC, 20000), ("linear_sums", "u", LAYERS, 20000),
              ("quad_sums", "critic", CRITIC, 20000), ("quad_sums", "u50", EIGEN_U, EIGEN_N),
              ("linear_sums", "u_d5", U5, 20000))
PASS_A_TIERS = ("resident", "staged")


def ptxas_of(*files):
    """nvcc's -Xptxas -v lines (entries, registers, spills) of these sources."""
    from nnpde_tpu_torch.kernels import _build

    sec, lines = "", []
    for ln in _build.BUILD_LOG.get("ptxas", "").splitlines():
        sec = ln if ln.startswith("==") else sec
        if any(f in sec for f in files) and (
                "Compiling entry" in ln or "registers" in ln or "spill" in ln):
            lines.append(ln.strip())
    return lines


def sass_count(pattern, opcode=" STG"):
    """Instructions whose SASS line holds ``opcode`` (global stores, STG, by
    default; ``" HMMA"`` the tensor-core products) in every kernel of the
    built library whose name contains ``pattern``: ``{kernel: count}``
    (cuobjdump), or None where the toolkit has no cuobjdump."""
    from nnpde_tpu_torch.kernels import _build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                         text=True).stdout
    counts, name = {}, None
    for ln in out.splitlines():
        if "Function : " in ln:
            name = ln.split("Function : ", 1)[1].strip()
            if pattern in name:
                counts[name] = 0
        elif name in counts and opcode in ln:
            counts[name] += 1
    return counts


def sass_global_stores(pattern):
    """Global stores (STG) in the SASS of every kernel whose name contains
    ``pattern`` (:func:`sass_count`)."""
    return sass_count(pattern)


def phase_pass_a_sweep(dev, cases, label):
    """Rows 4, 6, 7 and 9 (``cases``: kernel, net, layers, path N) at the
    wrapper's plan and at every lever pinned on its own: each planned
    design at its one-wave tile (the two-point design also a step below it
    and at 16 points) in each tier, at each register budget (blocks per SM)
    up to the design's most.  Each
    launch held to its float64 plain version (the jet per column rel <=
    1e-5; every sum within 1e-5 of the sum of its terms' magnitudes),
    launched twice for a bitwise-equal repeat, and timed as device time at
    the path's N and at 262144.  One JSON line per case; the wrapper's own
    choice carries ``"chosen": true``."""
    from nnpde_tpu_torch.kernels import _cuda, _plan
    from nnpde_tpu_torch.kernels import fused_quotient as fq
    from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

    ok = True
    for kind, net_name, layers, n_path in cases:
        fwd = kind.startswith("fwdlap_forward")
        impl = "streams" if kind == "fwdlap_forward_streams" else "rows"
        S = layers[0] + (2 if fwd else 1)

        def plan(**pin):
            return (fc.forward_plan(layers, **pin) if fwd
                    else fq.plan(kind, layers, 0, **pin))

        for N in (n_path, 262144):
            main = plan(N=N, sms=_cuda.sm_count(dev))
            plans = [main]

            def add(**pin):
                try:
                    pl = plan(**pin)
                except ValueError:
                    return
                if pl not in plans:
                    plans.append(pl)

            for des in _cuda.PLANNED_DESIGNS:
                two = des & _cuda.DES_ITEM2
                t = _plan.fold_tile(layers, S, 2 if two else 1)
                for T in ((t, t - 4, 16) if two else (t,)):
                    for tier in PASS_A_TIERS:
                        for blocks in range(_plan.FWD_BLOCKS, 1, -1):
                            add(design=des, T=T, tier=tier, blocks=blocks)
            # (row 6: row 4's inputs, plain version and bound)
            case = WanCase("fwdlap_forward" if fwd else kind, N, layers, "sin", seed=29,
                           dev=dev)
            ref = case.plain(torch.float64)
            scale = None if fwd else case.abs_terms()
            for pl in plans:
                def run(pl=pl):
                    if fwd:
                        return fc.fwdlap_forward(case.params, case.X, "sin", impl, pl=pl)
                    return fq._launch(kind, case.params, case.X, case.coef, None, "sin", 0,
                                      pl=pl)
                out, out2 = run(), run()
                torch.cuda.synchronize()
                if fwd:
                    err = col_rel(out, ref)
                else:
                    err = float(torch.max(torch.abs(out.double() - ref) / scale))
                good = err <= 1e-5 and bool(torch.equal(out, out2))
                ok = ok and good
                row = {"sweep": label, "kernel": kind, "net": net_name, "N": N, "err": err,
                       "ok": good, "chosen": pl == main, "device_ms": device_ms(run),
                       "bound_ms": case.bound_ms()}
                row.update(plan_row(kind, layers, S, pl, N, dev))
                emit(row)
            del case, ref
            torch.cuda.empty_cache()
    return ok


def phase_forward_sweep(dev):
    """Rows 4 and 6's levers (:func:`phase_pass_a_sweep`), with the ptxas
    report of fwdlap_forward.cu and the global stores in the planned
    kernel's SASS (its forward-only mode saves no stage: the jet rows or
    streams are its only global stores)."""
    emit({"phase": "forward_sweep", "ptxas": ptxas_of("fwdlap_forward", "fused_quotient"),
          "sass_global_stores": {"fwdlap_forward_planned":
                                 sass_global_stores("fwdlap_forward_planned"),
                                 "sums_planned": sass_global_stores("sums_planned"),
                                 "fwdlap_backward_planned":
                                 sass_global_stores("fwdlap_backward_planned")}})
    if not phase_pass_a_sweep(dev, FWD_SWEEP, "forward"):
        raise SystemExit("forward sweep: a case missed its bar")


# rows 1 and 5 on the nets of their paths, at the path's N (and 262144)
FSWEEP = (("fused_linear_residual", "u", LAYERS, 20000),
          ("fused_linear_residual", "u50", EIGEN_U, EIGEN_N),
          ("fwdlap_backward", "u50", EIGEN_U, EIGEN_N),
          ("fwdlap_backward", "u", LAYERS, 20000))
FSWEEP_TILES = (16, 20, 24, 28, 32, 36)


def fused_plan(kind, layers, N, dev, bf16=False):
    """The launch shape the fused residual or jet backward wrapper chose
    (after a launch): tile, tier, design, blocks per SM, item shape; the
    bf16-dot mode's: the tensor-core design's plan."""
    from nnpde_tpu_torch.kernels import fused_step as fs
    from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

    if bf16:
        pl, S = fs.mma_plan(kind, layers), layers[0] + 2
    elif kind == "fwdlap_backward":
        pl, S = fc.backward_plan(layers), layers[0] + 2
    else:
        pl, S = fs.plan(kind, layers), fs._streams(kind, layers[0])
    return plan_row(kind, layers, S, pl, N, dev, bf16)


def plan_row(kind, layers, S, pl, N, dev, bf16=False):
    """A launch shape as the timing and sweep lines print it (after a launch
    of it): tile, tier, design, fold, item shape, blocks, blocks per SM."""
    from nnpde_tpu_torch.kernels import _cuda, _plan
    from nnpde_tpu_torch.kernels import fused_step as fs

    dev = torch.device("cuda", torch.cuda.current_device()) if dev.index is None else dev
    fold, key = fs.variant(layers, S, pl)
    mma = pl.design & getattr(_cuda, "DES_MMA", 0)
    if getattr(pl, "blocks", 0):                # a forward-only kernel's register budget
        key = (key, pl.blocks)
    name = kind + (".bf16" if bf16 else "")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if mma:
        item = "16 points x 8 units x every stream, mma.sync m16n8k16 bf16"
    elif not pl.design & _cuda.DES_ITEM2:
        item = "4 rows x 4 units"
    elif S <= 4:
        item = f"2 points x {S} streams x 4 units"
    else:
        item = "8 rows x 4 units"
    return {"T": pl.T, "smem_bytes": pl.smem, "tier": pl.tier, "design": pl.design,
            "fold": bool(fold), "item": item,
            "blocks": _cuda.grid(name, None, pl.smem, dev, (N + pl.T - 1) // pl.T, key),
            "blocks_per_sm": _cuda.grid(name, None, pl.smem, dev, 1 << 30, key) // sms,
            "launch_bounds_blocks": getattr(pl, "blocks", None),
            "resident": _plan.resident(pl, kind not in ("fwdlap_forward",
                                                        "fwdlap_forward_streams",
                                                        "linear_sums", "quad_sums"))}


def phase_fused_sweep(dev):
    """Rows 1 and 5 in both planned designs (``_cuda.PLANNED_DESIGNS``: 4 x 4
    and two-point items), each at its own plan and at the wrapper's tile and
    tier, and the wrapper's design at every (tier, T) of FSWEEP_TILES that
    fits.  Each launch held to its float64 plain version (loss and grad
    rel <= 1e-5; row 5 gradient row rel <= 1e-5), launched twice for a
    bitwise-equal repeat, and timed as device time.  One JSON line per
    case; the wrapper's own choice carries ``"chosen": true``."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fused_step as fs
    from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

    emit({"phase": "fused_sweep", "ptxas": ptxas_of("fused_step", "fwdlap_backward")})
    ok = True
    for kind, net_name, layers, n_path in FSWEEP:
        bwd = kind == "fwdlap_backward"
        S = layers[0] + 2

        def plan(des, **pin):
            return (fc.backward_plan(layers, des, **pin) if bwd
                    else fs.plan(kind, layers, des, **pin))

        main = plan(None)
        plans = [main]

        def add(des, **pin):
            try:
                pl = plan(des, **pin)
            except ValueError:
                return
            if pl not in plans:
                plans.append(pl)

        for des in _cuda.PLANNED_DESIGNS:
            add(des)
            add(des, T=main.T, tier=main.tier)
        for tier in SWEEP_TIERS:
            for T in FSWEEP_TILES:
                add(main.design, T=T, tier=tier)
        for N in (n_path, 262144):
            if bwd:
                case = EigenCase(kind, N, layers, "sin", seed=27, dev=dev)
                ref = case.plain(torch.float64)
            else:
                case = Case(kind, N, 2, layers, "sin", seed=27, dev=dev)
                ref_loss, ref_grads = case.plain(torch.float64)
            for pl in plans:
                if bwd:
                    def run(pl=pl):
                        dWs, dbs = fc.fwdlap_backward(case.params, case.X, case.ct, "sin", pl=pl)
                        return torch.cat([t.reshape(-1) for pr in zip(dWs, dbs) for t in pr])
                else:
                    def run(pl=pl):
                        return fs._launch(kind, case.params, case.X, case.coef, "sin", pl=pl)
                out, out2 = run(), run()
                torch.cuda.synchronize()
                if bwd:
                    err = float(torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref))
                else:
                    dWs, dbs, sums = fs._unflatten(case.params, out)
                    grads = fs._scaled_grads(case.params, dWs, dbs, sums, 2.0 / N)
                    err = max(abs(float(sums[0] / N) - float(ref_loss)) / abs(float(ref_loss)),
                              tree_rel(grads, ref_grads))
                good = err <= 1e-5 and bool(torch.equal(out, out2))
                ok = ok and good
                row = {"kernel": kind, "net": net_name, "N": N, "err": err, "ok": good,
                       "chosen": pl == main, "device_ms": device_ms(run),
                       "bound_ms": case.bound_ms()}
                row.update(plan_row(kind, layers, S, pl, N, dev))
                emit(row)
            del case
            torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("fused sweep: a case missed its bar")


MSWEEP_TILES = (16, 32, 48, 64)
JSWEEP_TILES = (8, 16, 32)
# the kernels of the tensor-core design: rows 1/2 bf16 (two), row 5 bf16,
# row 4 bf16 at its two register budgets
MMA_KERNELS = 5


def phase_mma_sweep(dev):
    """Rows 1 and 2 bf16 in the tensor-core design (``DES_MMA``) at the
    wrapper's plan and at each lever pinned on its own, on u64 at 20000 and
    262144 points: the tile (MSWEEP_TILES), the tier (``fused_step.
    MMA_TIERS``: the hidden weights and the gradient row on chip or not) and
    the blocks per SM (two, the kernels' register budget, or one, by shared
    memory); then rows 5 bf16 and 4 bf16 (the jet pair) the same way at
    tiles JSWEEP_TILES (row 4: its tiers ``MMA_FWD_TIERS`` and also three
    blocks per SM, a register budget of its own).  Each case held to the
    plain bf16-dot version (PREC_TOL; row 4's columns PREC_TOL_JET) and to
    its float64 witness (no further than 2x the plain version is, + 2e-6),
    launched twice for a bitwise-equal repeat, and timed as device time.
    First the ptxas report of the kernels' sources and the SASS count of
    tensor-core products (HMMA) in each kernel of the design, and of
    local-memory traffic (LDL, STL)."""
    from nnpde_tpu_torch.kernels import fused_step as fs
    from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

    hmma = sass_count("_mma", " HMMA")
    emit({"phase": "mma_sweep", "ptxas": ptxas_of("fused_step", "fwdlap_backward",
                                                  "fwdlap_forward"),
          "hmma": hmma, "local_loads": sass_count("_mma", " LDL"),
          "local_stores": sass_count("_mma", " STL")})
    ok = hmma is None or (len(hmma) == MMA_KERNELS and all(v > 0 for v in hmma.values()))
    for kind in ("fused_linear_residual", "fused_poisson_analytic"):
        main = fs.mma_plan(kind, LAYERS)
        plans = [main]

        for T in MSWEEP_TILES:
            for tier, _ in fs.MMA_TIERS:
                for blocks in (1, 2):
                    try:
                        pl = fs.mma_plan(kind, LAYERS, T=T, tier=tier, blocks=blocks)
                    except ValueError:
                        continue
                    if pl not in plans:
                        plans.append(pl)
        for N in (20000, 262144):
            case = PrecCase(kind, N, LAYERS, "sin", seed=27, dev=dev)
            ref = case.plain("bfloat16")
            wit = case.plain("bfloat16", torch.float64)
            w_plain = case.rel(ref, wit)
            c = case.case
            an = None if kind == "fused_linear_residual" else \
                fs._analytic_args(fs.PoissonSinCoef(L, c.ks), case.d)
            for pl in plans:
                def run(pl=pl):
                    out = fs._launch(kind, c.params, c.X, c.coef if an is None else None,
                                     "sin", an, bf16=True, pl=pl)
                    dWs, dbs, sums = fs._unflatten(c.params, out)
                    g = fs._scaled_grads(c.params, dWs, dbs, sums, 2.0 / N)
                    return [(sums[0] / N).reshape(1)] + [t for pair in g for t in pair]

                out, out2 = run(), run()
                torch.cuda.synchronize()
                rel, w_kernel = case.rel(out, ref), case.rel(out, wit)
                good = bool(rel <= PREC_TOL and w_kernel <= 2.0 * w_plain + 2e-6
                            and all(torch.equal(a, b) for a, b in zip(out, out2)))
                ok = ok and good
                row = {"kernel": kind + ".bf16", "net": "u", "N": N, "rel": rel,
                       "witness_rel_kernel": w_kernel, "witness_rel_plain": w_plain,
                       "ok": good, "chosen": pl == main, "device_ms": device_ms(run),
                       "bound_ms": case.bound(BF16_PEAK)[0]}
                row.update(plan_row(kind, LAYERS, case.d + 2, pl, N, dev, True))
                emit(row)
            del case, ref, wit
            torch.cuda.empty_cache()
    for kind in ("fwdlap_backward", "fwdlap_forward"):
        main = fs.mma_plan(kind, LAYERS)
        plans = [main]
        tiers = fs.MMA_FWD_TIERS if kind == "fwdlap_forward" else fs.MMA_TIERS
        for T in JSWEEP_TILES:
            for tier, _ in tiers:
                for blocks in fs.MMA_SHARES.get(kind, (2, 1)):
                    try:
                        pl = fs.mma_plan(kind, LAYERS, T=T, tier=tier, blocks=blocks)
                    except ValueError:
                        continue
                    if pl not in plans:
                        plans.append(pl)
        for N in (20000, 262144):
            case = PrecCase(kind, N, LAYERS, "sin", seed=27, dev=dev)
            ref = case.plain("bfloat16")
            wit = case.plain("bfloat16", torch.float64)
            w_plain = case.rel(ref, wit)
            tol = PREC_TOL_JET[(2, 64)] if kind == "fwdlap_forward" else PREC_TOL
            for pl in plans:
                def run(pl=pl):
                    if kind == "fwdlap_forward":
                        return [fc.fwdlap_forward(case.params, case.X, "sin", "rows:default",
                                                  pl=pl)]
                    dWs, dbs = fc.fwdlap_backward(case.params, case.X, case.ct, "sin",
                                                  "bfloat16", pl=pl)
                    return [t for pair in zip(dWs, dbs) for t in pair]

                out, out2 = run(), run()
                torch.cuda.synchronize()
                rel, w_kernel = case.rel(out, ref), case.rel(out, wit)
                good = bool(rel <= tol and w_kernel <= 2.0 * w_plain + 2e-6
                            and all(torch.equal(a, b) for a, b in zip(out, out2)))
                ok = ok and good
                row = {"kernel": kind + ".bf16", "net": "u", "N": N, "rel": rel, "tol": tol,
                       "witness_rel_kernel": w_kernel, "witness_rel_plain": w_plain,
                       "ok": good, "chosen": pl == main, "device_ms": device_ms(run),
                       "bound_ms": case.bound(BF16_PEAK)[0]}
                row.update(plan_row(kind, LAYERS, case.d + 2, pl, N, dev, True))
                emit(row)
            del case, ref, wit
            torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("mma sweep: a case missed its bar, or a variant has no HMMA")


DEPTH_HIDDEN = (3, 5, 9, 15)


def mma_leaf_rels(layers, act, pl=None, N=1000 + 7, seed=23, dev=None):
    """Row 1 bf16 at one net and plan on the card's test case (the
    coefficients a Poisson residual gives, ``tests/test_torch_cuda.py``'s
    seed): per leaf (loss, dW0, db0, dW1, ...) the norm-relative distance
    of the kernel from the plain bf16-dot version and from its float64
    witness, and of the plain version from the witness; two launches
    bitwise equal."""
    from nnpde_tpu_torch.kernels import fused_step as fs
    from nnpde_tpu_torch.models import factor_for_technique

    rng = np.random.default_rng(seed)
    d = layers[0]
    tp = rand_params(rng, layers, dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    fj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(X)
    coef = fs.residual_coefficients(fj, a0=-1.0, rhs=torch.sin(X[:, 0]))

    def plain(dtype):
        P = [(W.to(dtype), b.to(dtype)) for W, b in tp]
        dWs, dbs, sums = fs.linear_residual_plain(P, X.to(dtype), coef.to(dtype), act,
                                                  "bfloat16")
        g = fs._scaled_grads(P, dWs, dbs, sums, 2.0 / N)
        return [(sums[0] / N).reshape(1)] + [t for pair in g for t in pair]

    def run():
        out = fs._launch("fused_linear_residual", tp, X, coef, act, bf16=True, pl=pl)
        dW, db, sm = fs._unflatten(tp, out)
        gr = fs._scaled_grads(tp, dW, db, sm, 2.0 / N)
        return [(sm[0] / N).reshape(1)] + [t for pair in gr for t in pair]

    def rels(a, b):
        return [float(torch.linalg.norm(x.double() - y.double())
                      / max(float(torch.linalg.norm(y.double())), 1e-30))
                for x, y in zip(a, b)]

    want, wit = plain(torch.float32), plain(torch.float64)
    out, out2 = run(), run()
    torch.cuda.synchronize()
    # the same net with its hidden units permuted, results mapped back: the
    # same function and the same bf16 roundings, every product's sum taken
    # in another order (the spread of two fp32 orders of one computation)
    g = torch.Generator().manual_seed(seed)
    perm = [torch.arange(layers[0])] + [torch.randperm(w, generator=g).to(dev)
                                        for w in layers[1:-1]] + [torch.arange(1)]
    perm = [p.to(dev) for p in perm]
    keep = tp
    tp = [(W[perm[k]][:, perm[k + 1]].contiguous(), b[perm[k + 1]].contiguous())
          for k, (W, b) in enumerate(keep)]

    def back(leaves):
        inv = [torch.argsort(p) for p in perm]
        out = [leaves[0]]
        for k in range(len(keep)):
            dW, db = leaves[1 + 2 * k], leaves[2 + 2 * k]
            out += [dW[inv[k]][:, inv[k + 1]], db[inv[k + 1]]]
        return out

    want_p, out_p = back(plain(torch.float32)), back(run())
    tp = keep
    used = pl or fs.mma_plan("fused_linear_residual", layers)
    return {"layers": [layers[0], layers[1], len(layers) - 2], "act": act, "T": used.T,
            "tier": used.tier, "smem": used.smem,
            "bitwise": all(torch.equal(a, b) for a, b in zip(out, out2)),
            "kernel_plain": rels(out, want), "kernel_witness": rels(out, wit),
            "plain_witness": rels(want, wit), "plain_permuted": rels(want_p, want),
            "kernel_permuted": rels(out_p, out)}


def phase_mma_depth(dev):
    """Row 1 bf16 on the wide nets the wrapper takes, by depth (3, 5, 9, 15
    hidden layers of 128 units) at d = 16 (18 streams: 8-point tiles only)
    and at d = 2 with the tile pinned to 8 and to 16 points, in sin and
    tanh; at d = 2 and 3 hidden layers every tier (the gradient row on chip
    in fragment order, or flat in device memory).  Per leaf: the kernel's
    distance from the plain bf16-dot version and from the float64 witness,
    beside the plain version's own, and the spread of two fp32 orders (the
    plain version, and the kernel, on the net with its hidden units
    permuted).  Each case passes at mma_sweep's bars (every
    leaf within PREC_TOL of the plain version, no further from the witness
    than 2x the plain version + 2e-6) and repeats bitwise."""
    from nnpde_tpu_torch.kernels import fused_step as fs

    ok, rows = True, []
    cases = []
    for n in DEPTH_HIDDEN:
        for act in ("sin", "tanh"):
            cases.append(((16,) + (128,) * n + (1,), act, None, 23))
            for T in (8, 16):
                lay = (2,) + (128,) * n + (1,)
                cases.append((lay, act, fs.mma_plan("fused_linear_residual", lay, T=T), 23))
    lay = (2, 128, 128, 128, 1)
    for tier, _ in fs.MMA_TIERS:
        try:
            pl = fs.mma_plan("fused_linear_residual", lay, T=16, tier=tier)
        except ValueError:
            continue
        cases.append((lay, "sin", pl, 23))
    cases += [((16,) + (128,) * 15 + (1,), act, None, seed)
              for seed in (24, 25) for act in ("sin", "tanh")]
    for lay, act, pl, seed in cases:
        row = mma_leaf_rels(lay, act, pl, seed=seed, dev=dev)
        row["seed"] = seed
        row["ok"] = bool(row["bitwise"] and max(row["kernel_plain"]) <= PREC_TOL
                         and max(row["kernel_witness"]) <= 2.0 * max(row["plain_witness"])
                         + 2e-6)
        ok = ok and row["ok"]
        rows.append(row)
        emit({"phase": "mma_depth", **row})
        torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("mma depth: a case missed its bar")


# --------------------------------------------------------------- precision
# The bf16-dot variants of the four kernels that compute_dtype='hybrid-kernel'
# launches, and the reduced-precision training of both entry points.
PRECISION_REPLACES = {
    "fused_linear_residual.bf16": "nnpde_tpu/kernels/fused_step.py:64",
    "fused_poisson_analytic.bf16": "nnpde_tpu/kernels/fused_step.py:596",
    "fwdlap_forward.bf16": "nnpde_tpu/kernels/fwdlap_pallas.py:157",
    "fwdlap_backward.bf16": "nnpde_tpu/kernels/fwdlap_pallas.py:522",
}
PRECISION_SOURCES = {
    "fused_linear_residual.bf16": "nnpde_tpu_torch/csrc/fused_step.cu",
    "fused_poisson_analytic.bf16": "nnpde_tpu_torch/csrc/fused_step.cu",
    "fwdlap_forward.bf16": "nnpde_tpu_torch/csrc/fwdlap_forward.cu",
    "fwdlap_backward.bf16": "nnpde_tpu_torch/csrc/fwdlap_backward.cu",
}
# the tensor-core design's body, beside each bf16-dot row's entry point
MMA_SOURCE = "nnpde_tpu_torch/csrc/fwdlap_mma.cuh"
# where each entry point takes its design among its arguments
DES_ARG = {"fused_linear_residual_f32": 12, "fused_poisson_analytic_f32": 11,
           "fwdlap_forward_f32": 11, "fwdlap_backward_f32": 12}
BF16_PEAK = 989e12       # H100 SXM bf16 tensor cores, dense (FLOP/s)
PREC_TOL = 1e-4
# The jet forward's columns are per-point outputs: an operand that rounds to
# the other bf16 neighbour under another fp32 sum order moves its point by
# a bf16 ulp's share and is not averaged away as in a sum over points.  Two
# sound fp32 orders of the bf16-dot recurrence differ by 3e-5 to 2.5e-4
# per column at these shapes (the plain version against its float64
# witness and against a float64-accumulated copy, on the CPU), more at
# d = 5.  So each shape (d, hidden width) has its bar, set above that spread
# and below a tenth of its distance from the fp32 kernel (the "apart" gate
# is 10x the bar in force): the kernel vs its plain version measured 3.8e-6
# / 1.4e-4 / 4.8e-5 / 4.1e-5, the fp32 distance 2.1e-3 / 9.9e-3 / 4.2e-3 /
# 6.8e-3.  Every case also holds the kernel to the float64 witness: no
# further from it than 2x the plain fp32 version is (+2e-6, the fp32 sum
# noise of the loss and leaves).
PREC_TOL_JET = {(2, 64): 1e-4, (5, 64): 5e-4, (2, 50): 2e-4, (5, 50): 3e-4}
# row 5 from a random cotangent (u50, d = 2): the leaves sum terms whose
# signs cancel, so their sum-order noise shows (the plain version is 2.8e-4
# from its float64 witness at this seed, on the CPU; 1.3e-2 from the fp32
# plain version)
PREC_TOL_BWD_RANDOM = 8e-4
U50 = EIGEN_U
# what the main path's fused run left for the precision path (same call)
MAIN_FUSED = {}


class PrecCase:
    """One of the four kernels with a bf16-dot variant at one shape: the
    wrapper in either dot mode and the plain version of either mode, as a
    list of tensors ([loss, leaves...], the jet rows, or the leaves).  The
    jet backward takes the cotangent the Poisson PINN loss gives the raw
    net's jet, or with ``ct='random'`` a random one."""

    def __init__(self, base, N, layers, act, seed, dev, ct="residual"):
        rng = np.random.default_rng(seed)
        self.base, self.N, self.layers, self.act = base, N, layers, act
        self.d = d = layers[0]
        if base.startswith("fused"):
            self.case = Case(base, N, d, layers, act, seed, dev)
            self.params, self.X = self.case.params, self.case.X
        else:
            from nnpde_tpu_torch.kernels import fused_step as fs
            from nnpde_tpu_torch.kernels import fwdlap_cuda as fc
            from nnpde_tpu_torch.models import factor_for_technique
            from nnpde_tpu_torch.pde.poisson import rhs_f_for_u_sin

            self.params = rand_params(rng, layers, dev)
            self.X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32),
                                     device=dev)
            if ct == "random":
                self.ct = torch.as_tensor(
                    (rng.standard_normal((N, d + 2)) / N).astype(np.float32), device=dev)
            else:
                # (2/N) r (c, b, a) with r the residual of the box-FBC trial
                fj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(self.X)
                coef = fs.residual_coefficients(fj, a0=-1.0, rhs=-rhs_f_for_u_sin(
                    self.X, L, (1,) * d))
                jet = fc.fwdlap_forward_plain(self.params, self.X, act)
                r = (coef[:, 0] * jet.value + torch.sum(coef[:, 1:1 + d] * jet.grad, dim=1)
                     + coef[:, d + 1] * jet.lap + coef[:, d + 2])
                self.ct = ((2.0 / N) * r[:, None] * coef[:, :d + 2]).contiguous()

    def folds(self):
        """Whether the wrapper's bf16-dot variant takes the FOLD variant at
        this shape: never (the tensor-core design of every bf16-dot row has
        no fold variant)."""
        return False

    def kernel(self, dot):
        from nnpde_tpu_torch.kernels import fused_step as fs
        from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

        if self.base == "fwdlap_forward":
            return [fc.fwdlap_forward(self.params, self.X, self.act,
                                      "rows:default" if dot == "bfloat16" else "rows")]
        if self.base == "fwdlap_backward":
            dWs, dbs = fc.fwdlap_backward(self.params, self.X, self.ct, self.act, dot)
            return [t for pair in zip(dWs, dbs) for t in pair]
        c = self.case
        if self.base == "fused_linear_residual":
            loss, _, g = fs.fused_linear_residual(c.params, c.X, c.coef, self.act, dot_dtype=dot)
        else:
            loss, _, g = fs.fused_poisson_analytic(c.params, c.X, self.act, L=L, ks=c.ks,
                                                   dot_dtype=dot)
        return [loss.reshape(1)] + [t for pair in g for t in pair]

    def plain(self, dot, dtype=torch.float32):
        """The plain version of the ``dot`` mode on the card, float32 (the
        oracle) or float64 (``dtype``; in the bf16-dot mode the witness: its
        operands rounded to bf16 from float64 values)."""
        from nnpde_tpu_torch.kernels import fused_step as fs
        from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

        P = [(W.to(dtype), b.to(dtype)) for W, b in self.params]
        X = self.X.to(dtype)
        if self.base == "fwdlap_forward":
            if dot == "bfloat16":
                return [fc.fwdlap_forward_default_plain(P, X, self.act)]
            jet = fc.fwdlap_forward_plain(P, X, self.act)
            return [torch.cat([jet.value[:, None], jet.grad, jet.lap[:, None]], dim=1)]
        if self.base == "fwdlap_backward":
            dWs, dbs = fc.fwdlap_backward_plain(P, X, self.ct.to(dtype), self.act, dot)
            return [t for pair in zip(dWs, dbs) for t in pair]
        c = self.case
        if self.base == "fused_linear_residual":
            dWs, dbs, sums = fs.linear_residual_plain(P, X, c.coef.to(dtype), self.act, dot)
        else:
            dWs, dbs, sums = fs.poisson_analytic_plain(P, X, self.act,
                                                       fs.PoissonSinCoef(L, c.ks), dot)
        g = fs._scaled_grads(P, dWs, dbs, sums, 2.0 / self.N)
        return [(sums[0] / self.N).reshape(1)] + [t for pair in g for t in pair]

    def rel(self, a, b):
        """The largest norm-relative difference: over the loss and every
        gradient leaf, or over the jet's columns."""
        if self.base == "fwdlap_forward":
            return col_rel(a[0], b[0])
        return max(float(torch.linalg.norm(x.double() - y.double())
                         / max(float(torch.linalg.norm(y.double())), 1e-30))
                   for x, y in zip(a, b))

    def points_off(self, a, b):
        """Share of points whose jet row differs from the plain version's by
        more than 1e-5 of the column's rms (the jet forward)."""
        out, ref = a[0].double(), b[0].double()
        rms = torch.sqrt(torch.mean(ref * ref, dim=0))
        return float(torch.mean((torch.max(torch.abs(out - ref) / rms, dim=1).values
                                 > 1e-5).double()))

    def distinct(self, bf, f32):
        """How far the bf16-dot result is from the fp32 one: the Laplacian
        column of the jet, else the largest gradient leaf difference."""
        if self.base == "fwdlap_forward":
            a, b = bf[0][:, -1].double(), f32[0][:, -1].double()
            return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        lo = 0 if self.base == "fwdlap_backward" else 1
        return self.rel(bf[lo:], f32[lo:])

    def flops(self):
        per = 2.0 if self.base == "fwdlap_forward" else 6.0
        return per * (self.d + 2) * macs(self.layers) * self.N

    def bytes(self):
        P = sum(a * b + b for a, b in zip(self.layers[:-1], self.layers[1:]))
        if self.base.startswith("fused"):
            return self.case.bytes()
        if self.base == "fwdlap_forward":
            return 4.0 * (self.N * (2 * self.d + 2) + P)
        return 4.0 * (self.N * (2 * self.d + 2) + 2 * P)

    def bound(self, peak):
        """(bound ms, bound_by) with the products at ``peak`` FLOP/s."""
        ops, mem = self.flops() / peak, self.bytes() / HBM_RATE
        return 1e3 * max(ops, mem), "operations" if ops >= mem else "bytes"


class unfolded:
    """Within the block every wrapper takes the variant without the fold,
    whatever the shape (to hold both variants at one shape)."""

    def __enter__(self):
        from nnpde_tpu_torch.kernels import _cuda

        self.keep = _cuda.folds
        _cuda.folds = lambda *args: False

    def __exit__(self, *exc):
        from nnpde_tpu_torch.kernels import _cuda

        _cuda.folds = self.keep


def phase_precision_kernels(dev):
    """Each bf16-dot variant against its plain bf16-dot version (float32 on
    the card): the loss and every gradient leaf within 1e-4 norm-relative,
    the jet's columns within their shape's bar (PREC_TOL_JET), row 5 from a
    random cotangent within PREC_TOL_BWD_RANDOM; apart from the fp32 kernel
    by more than 10x the bar in force; no further from the float64 witness
    than 2x the plain version is (+2e-6); two launches bitwise equal; every
    bf16-dot launch in the tensor-core design (``DES_MMA``, read from the
    launch's own arguments).  Rows 4 and 5 also at u64, d = 2 with the fold
    taken away (which the tensor-core design does not have: the same
    launch)."""
    from nnpde_tpu_torch.kernels import _cuda

    def launched(dot):
        """The bf16-dot result and the designs its launches passed."""
        with _cuda.capture() as cap:
            out = case.kernel(dot)
        return out, sorted({args[DES_ARG[fn.__name__]] for _, fn, args, _, _ in cap.calls})

    rows, max_err = [], {}
    U5, U50_5 = (5, 64, 64, 64, 64, 1), (5, 50, 50, 50, 50, 1)
    # (kernel, N, layers, seed, options): the unfolded case takes the inputs
    # of the folded one, the random cotangent the net and points of u50
    cases = [(b, 20000, lay, 300 + i, {})
             for b in ("fused_linear_residual", "fused_poisson_analytic")
             for i, lay in enumerate((LAYERS, U5))]
    for b in ("fwdlap_forward", "fwdlap_backward"):
        cases += [(b, 20000, LAYERS, 300, {}), (b, 20000, U5, 301, {}),
                  (b, EIGEN_N, U50, 302, {}), (b, EIGEN_N, U50_5, 303, {}),
                  (b, 20000, LAYERS, 300, {"unfolded": True})]
    cases.append(("fwdlap_backward", EIGEN_N, U50, 302, {"ct": "random"}))
    for base, N, layers, seed, opt in cases:
        case = PrecCase(base, N, layers, "sin", seed=seed, dev=dev,
                        ct=opt.get("ct", "residual"))
        same = None
        if opt.get("unfolded"):
            folded = case.kernel("bfloat16")
            with unfolded():
                fold = case.folds()
                out, designs = launched("bfloat16")
                out2, f32 = case.kernel("bfloat16"), case.kernel("float32")
            same = all(torch.equal(a, b) for a, b in zip(out, folded))
            del folded
        else:
            fold = case.folds()
            out, designs = launched("bfloat16")
            out2, f32 = case.kernel("bfloat16"), case.kernel("float32")
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(out, out2))
        ref = case.plain("bfloat16")
        wit = case.plain("bfloat16", torch.float64)
        rel = case.rel(out, ref)
        w_kernel, w_plain = case.rel(out, wit), case.rel(ref, wit)
        apart = case.distinct(out, f32)
        err = max(float(torch.max(torch.abs(a.double() - b.double())))
                  for a, b in zip(out, ref))
        name = base + ".bf16"
        max_err[name] = max(max_err.get(name, 0.0), err)
        if base == "fwdlap_forward":
            tol = PREC_TOL_JET[(layers[0], layers[1])]
        elif opt.get("ct") == "random":
            tol = PREC_TOL_BWD_RANDOM
        else:
            tol = PREC_TOL
        row = {"kernel": name, "N": N, "layers": list(layers), "fold": bool(fold),
               "cotangent": opt.get("ct", "residual") if base == "fwdlap_backward" else None,
               "rel": rel, "tol": tol, "rel_to_fp32_kernel": apart,
               "witness_rel_kernel": w_kernel, "witness_rel_plain": w_plain,
               "max_abs_err": err, "bitwise_repeat": bitwise, "equal_to_folded": same,
               "designs": designs,
               "ok": bool(rel <= tol and apart > 10 * tol and bitwise
                          and w_kernel <= 2.0 * w_plain + 2e-6
                          and designs == [_cuda.DES_MMA])}
        if base == "fwdlap_forward":
            row["points_off"] = case.points_off(out, ref)
        rows.append(row)
        del case, out, out2, f32, ref, wit
        torch.cuda.empty_cache()
    emit({"phase": "precision_kernels", "tol": PREC_TOL, "rows": rows})
    if not all(r["ok"] for r in rows):
        raise SystemExit("bf16-dot kernel vs plain comparison failed")
    return max_err


def phase_precision_timing(dev, only=None):
    """Wrapper and device ms of the four kernels in both dot modes at the
    path's N and at 262144 (d = 2, u64), and of rows 1, 4, 5 in fp32 at
    d = 5 (S = 7: the variant without the fold), each with its plain
    version's ms and its bound: the bf16-dot rows at the bf16 tensor cores'
    peak, with their CUDA-core bound beside it.  ``only``: the rows of
    these names (``timing --rows=KERNEL.bf16``) and no others."""
    rows = []
    plan = [(b, LAYERS, dot) for b in ("fused_linear_residual", "fused_poisson_analytic",
                                       "fwdlap_forward", "fwdlap_backward")
            for dot in ("bfloat16", "float32")]
    plan += [(b, U5, "float32") for b in ("fused_linear_residual", "fwdlap_forward",
                                          "fwdlap_backward")]
    for base, layers, dot in plan:
        if only is not None and base + (".bf16" if dot == "bfloat16" else "") not in only:
            continue
        for N in (20000, 262144):
            case = PrecCase(base, N, layers, "sin", seed=7, dev=dev)
            ms = time_ms(lambda: case.kernel(dot))
            dev_ms = device_ms(lambda: case.kernel(dot))
            plain_ms = time_ms(lambda: case.plain(dot), warmup=2, reps=7)
            # bf16 operands with fp32 accumulation run at the bf16 tensor
            # cores' peak on this card: that is the bound of a bf16-dot row;
            # its CUDA-core figure beside it
            bound, by = case.bound(BF16_PEAK if dot == "bfloat16" else FP32_PEAK)
            row = {"kernel": base + (".bf16" if dot == "bfloat16" else ""),
                   "net": "u", "d": layers[0], "N": N,
                   "plan": fused_plan(base, layers, N, dev, dot == "bfloat16")
                   if base != "fwdlap_forward" else pass_a_plan(base, layers, 0, N, dev)
                   if dot == "float32" else bf16_forward_plan(layers, N, dev),
                   "ms": ms, "device_ms": dev_ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "flop": case.flops(), "bytes": case.bytes(),
                   "gflops": case.flops() / (dev_ms * 1e-3) / 1e9}
            if dot == "bfloat16":
                row["bound_cuda_core_ms"] = case.bound(FP32_PEAK)[0]
            rows.append(row)
            del case
            torch.cuda.empty_cache()
    emit({"phase": "precision_timing", "rows": rows})
    return rows


def _rate(r):
    return r["result"].timing["steps_per_s"]


def phase_precision_path():
    """The reduced-precision training runs, each gated and with its launch
    counts read right after it; steps/s beside the fp32 run of the same
    route in this call."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.problems import (IPW2DConfig, PoissonConfig, train_ipw_2d,
                                          train_poisson_nd)

    out, counts, ok = {}, {}, True

    def run(fn, cfg):
        reset_launches()
        t0 = time.time()
        r = fn(cfg)
        return r, {k: v for k, v in LAUNCHES.items() if v}, time.time() - t0

    # poisson2d-pinn-hybrid-kernel: the main path's shape, the bf16-dot
    # bulk on the fused kernels (stream and analytic coefficients) and on
    # the jet pair
    base = dict(dim=2, method="PINN", bc_mode="FBC", epochs=3000, n_interior=20000,
                chunk=1000)
    if not MAIN_FUSED:
        r, _, _ = run(train_poisson_nd, PoissonConfig(jet_impl="fused", **base))
        MAIN_FUSED.update(rel_l2=r["rel_l2"], total0=float(r["history"]["total"][0]),
                          steps_per_s=_rate(r))
    gate = max(2.0 * MAIN_FUSED["rel_l2"], 1e-3)
    hk = {}
    for name, kw, kern in (("fused", dict(jet_impl="fused"), "fused_linear_residual"),
                           ("fused_analytic", dict(jet_impl="fused", coef_mode="analytic"),
                            "fused_poisson_analytic")):
        r, launches, wall = run(train_poisson_nd,
                                PoissonConfig(compute_dtype="hybrid-kernel", **kw, **base))
        t0 = float(r["history"]["total"][0])
        apart = abs(t0 - MAIN_FUSED["total0"]) / abs(MAIN_FUSED["total0"])
        want = {kern + ".bf16": 2400, kern: 600}
        row = {"rel_l2": r["rel_l2"], "rel_l2_fp32_fused": MAIN_FUSED["rel_l2"], "gate": gate,
               "total0_rel_to_fp32": apart,
               "launches": launches, "steps_per_s": _rate(r),
               "bulk_steps_per_s": r["result"].timing["bulk_steps_per_s"],
               "tail_steps_per_s": r["result"].timing["tail_steps_per_s"],
               "fp32_fused_steps_per_s": MAIN_FUSED["steps_per_s"], "wall_s": wall}
        row["ok"] = bool(r["rel_l2"] <= gate and 1e-6 < apart <= 1e-2 and launches == want)
        hk[name] = row
        counts[kern + ".bf16"] = launches.get(kern + ".bf16", 0)
    kcfg = dict(base, epochs=300, jet_impl="kernel")
    r32, l32, _ = run(train_poisson_nd, PoissonConfig(**kcfg))
    r, launches, wall = run(train_poisson_nd, PoissonConfig(compute_dtype="hybrid-kernel",
                                                            **kcfg))
    want = {"fwdlap_forward.bf16": 240, "fwdlap_backward.bf16": 240, "fwdlap_forward": 60,
            "fwdlap_backward": 60}
    # the route's own fp32 run sets the gate (PERF.md section 2)
    kgate = max(2.0 * r32["rel_l2"], 1e-3)
    hk["kernel"] = {"epochs": 300, "rel_l2": r["rel_l2"], "rel_l2_fp32": r32["rel_l2"],
                    "gate": kgate, "launches": launches, "launches_fp32": l32,
                    "steps_per_s": _rate(r), "fp32_steps_per_s": _rate(r32),
                    "ok": bool(np.all(np.isfinite(r["history"]["total"]))
                               and r["rel_l2"] <= kgate and launches == want)}
    counts["fwdlap_forward.bf16"] = launches.get("fwdlap_forward.bf16", 0)
    counts["fwdlap_backward.bf16"] = launches.get("fwdlap_backward.bf16", 0)
    out["poisson2d_pinn_hybrid_kernel"] = hk

    # poisson5d-pinn-hybrid: u64 at d = 5, 1000 epochs (cut from 10000), on
    # torch and on fused (torch bulk, fused tail), beside fp32 runs
    b5 = dict(dim=5, method="PINN", bc_mode="FBC", epochs=1000, n_interior=20000, chunk=1000)
    p5, runs5 = {}, {}
    for route in ("torch", "fused"):
        r32, l32, _ = run(train_poisson_nd, PoissonConfig(jet_impl=route, **b5))
        rh, lh, _ = run(train_poisson_nd, PoissonConfig(jet_impl=route,
                                                        compute_dtype="hybrid", **b5))
        runs5[route] = rh
        g = max(2.0 * r32["rel_l2"], 1e-3)
        want = {} if route == "torch" else {"fused_linear_residual": 200}
        want32 = {} if route == "torch" else {"fused_linear_residual": 1000}
        p5[route] = {"rel_l2_hybrid": rh["rel_l2"], "rel_l2_fp32": r32["rel_l2"], "gate": g,
                     "launches": lh, "launches_fp32": l32, "steps_per_s": _rate(rh),
                     "bulk_steps_per_s": rh["result"].timing["bulk_steps_per_s"],
                     "tail_steps_per_s": rh["result"].timing["tail_steps_per_s"],
                     "fp32_steps_per_s": _rate(r32),
                     "ok": bool(rh["rel_l2"] <= g and lh == want and l32 == want32)}
    ht, hf = runs5["torch"]["history"]["total"], runs5["fused"]["history"]["total"]
    bulk = int(len(ht) * PoissonConfig().hybrid_bf16_fraction)
    p5["bulk_max_rel"] = float(np.max(np.abs(hf[:bulk] - ht[:bulk]) / np.abs(ht[:bulk])))
    p5["tail_total0_rel"] = float(abs(hf[bulk] - ht[bulk]) / abs(ht[bulk]))
    p5["ok"] = bool(p5["torch"]["ok"] and p5["fused"]["ok"] and p5["bulk_max_rel"] <= 1e-6
                    and p5["tail_total0_rel"] <= 1e-3)
    out["poisson5d_pinn_hybrid"] = p5

    # poisson2d-wan-hybrid: the WAN path's config, 300 epochs on fused
    r, launches, wall = run(train_poisson_nd, PoissonConfig(dim=2, method="WAN", epochs=300,
                                                            chunk=1000, jet_impl="fused",
                                                            compute_dtype="hybrid"))
    h = r["history"]
    l2_first = float(h["l2"][0]) / 0.5
    want = {k: n * 60 for k, n in WAN_PER_EPOCH.items()}
    out["poisson2d_wan_hybrid"] = {
        "epochs": 300, "rel_l2": r["rel_l2"], "rel_l2_first": l2_first, "launches": launches,
        "steps_per_s": _rate(r), "bulk_steps_per_s": r["result"].timing["bulk_steps_per_s"],
        "tail_steps_per_s": r["result"].timing["tail_steps_per_s"],
        "ok": bool(all(np.all(np.isfinite(h[k])) for k in ("total", "l2", "wan_loss_v"))
                   and r["rel_l2"] < l2_first and launches == want)}

    # ipw2d-n33-pinn-hybrid: 500 epochs (cut from 20000), torch and fused
    ib = dict(nx=3, ny=3, technique="FN", method="PINN", epochs=500, chunk=1000,
              weights={"data": 1e4})
    i32, _, _ = run(train_ipw_2d, IPW2DConfig(jet_impl="torch", **ib))
    g = max(2.0 * i32["rel_l2"], 1e-3)
    ip = {"rel_l2_fp32_torch": i32["rel_l2"], "fp32_torch_steps_per_s": _rate(i32), "gate": g}
    for route in ("torch", "fused"):
        r, launches, _ = run(train_ipw_2d, IPW2DConfig(jet_impl=route, compute_dtype="hybrid",
                                                       **ib))
        want = {} if route == "torch" else {"fused_linear_residual": 100}
        ip[route] = {"rel_l2": r["rel_l2"], "launches": launches, "steps_per_s": _rate(r),
                     "bulk_steps_per_s": r["result"].timing["bulk_steps_per_s"],
                     "tail_steps_per_s": r["result"].timing["tail_steps_per_s"],
                     "ok": bool(r["rel_l2"] <= g and launches == want)}
    ip["ok"] = ip["torch"]["ok"] and ip["fused"]["ok"]
    out["ipw2d_n33_pinn_hybrid"] = ip

    # one 100-epoch bfloat16 run of each entry point
    rp, _, _ = run(train_poisson_nd, PoissonConfig(dim=2, epochs=100, chunk=1000,
                                                   compute_dtype="bfloat16"))
    ri, _, _ = run(train_ipw_2d, IPW2DConfig(**dict(ib, epochs=100), compute_dtype="bfloat16"))
    out["bfloat16"] = {
        "poisson_rel_l2": rp["rel_l2"], "poisson_steps_per_s": _rate(rp),
        "ipw2d_rel_l2": ri["rel_l2"], "ipw2d_steps_per_s": _rate(ri),
        "ok": bool(np.all(np.isfinite(rp["history"]["total"]))
                   and np.all(np.isfinite(ri["history"]["total"])))}

    ok = (all(v["ok"] for v in hk.values()) and p5["ok"]
          and all(out[k]["ok"] for k in ("poisson2d_wan_hybrid", "ipw2d_n33_pinn_hybrid",
                                         "bfloat16")))
    emit({"phase": "precision_path", **out, "ok": ok})
    if not ok:
        raise SystemExit("precision path check failed")
    return counts


# ------------------------------------------------------- the 3D well, hard Neumann
# The 3D infinite well (``train_ipw_3d`` at its default config: u64 at
# d = 3, 131072 Sobol points redrawn every epoch, the FN ground state) and
# the 5D hard-Neumann Poisson PINN (ACCEPTANCE.json poisson_5d_pinn_neumann).
IPW3D_U = (3, 64, 64, 64, 64, 1)
IPW3D_N = 131072
# the kernels the 3D well's routes launch: rows 1 (PINN 'fused'), 4 and 5
# (PINN 'kernel'), 9 and 10 (DRM 'fused')
IPW3D_KERNELS = ("fused_linear_residual", "fwdlap_forward", "fwdlap_backward",
                 "quad_sums", "quad_seeded")


def ipw3d_case(kind, N, seed, dev):
    """One of IPW3D_KERNELS at d = 3 on u64 over N random points."""
    if kind == "fused_linear_residual":
        return Case(kind, N, 3, IPW3D_U, "sin", seed=seed, dev=dev)
    if kind == "fwdlap_backward":
        return EigenCase(kind, N, IPW3D_U, "sin", seed=seed, dev=dev)
    return WanCase(kind, N, IPW3D_U, "sin", seed=seed, dev=dev)


def phase_ipw3d_kernels(dev):
    """Rows 1, 4, 5, 9 and 10 at the 3D well's shape (u64 at d = 3, 131072
    points, and 7 more: a multiple of no tile) against their float64 plain
    versions (:func:`hold`)."""
    rows, max_err = [], {}
    for kind in IPW3D_KERNELS:
        for i, N in enumerate((IPW3D_N, IPW3D_N + 7)):
            case = ipw3d_case(kind, N, seed=600 + i, dev=dev)
            row = hold(case)
            rows.append(row)
            max_err[kind] = max(max_err.get(kind, 0.0), row["max_abs_err"])
            del case
            torch.cuda.empty_cache()
    emit({"phase": "ipw3d_kernels", "tol": 1e-5, "rows": rows})
    if not all(r["ok"] for r in rows):
        raise SystemExit("3D well kernel vs plain comparison failed")
    return max_err


def phase_ipw3d_path():
    """``train_ipw_3d`` at its default config, cut: PINN for 500 of its 5000
    epochs on 'torch', 'kernel' and 'fused', DRM for 300 on 'torch' and
    'fused', each from one seed.  The kernel routes start as 'torch' does
    (first total within rtol 1e-4, the first 10 within 5e-2), PINN rel_l2
    <= max(2 x torch, 1e-3), DRM falling (the last 20 epochs' mean total
    below the first 20's, the best eval below the first), every value
    finite, launches per step exact."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.problems import IPW3DConfig, train_ipw_3d

    default = IPW3DConfig()
    if (tuple(default.layers), default.n_interior) != (IPW3D_U, IPW3D_N):
        raise SystemExit("IPW3DConfig's defaults are not the full-width net and batch")

    def run(**kw):
        reset_launches()
        t0 = time.time()
        out = train_ipw_3d(IPW3DConfig(**kw))
        return out, {k: v for k, v in LAUNCHES.items() if v}, time.time() - t0

    report = {"phase": "ipw3d_path", "layers": list(IPW3D_U), "n_interior": IPW3D_N,
              "state": [1, 1, 1], "technique": "FN", "sampler": "sobol", "resample": True,
              "cut_from": default.epochs}
    ok = True
    for method, epochs, per_step in (
            ("PINN", 500, {"torch": {}, "fused": {"fused_linear_residual": 1},
                           "kernel": {"fwdlap_forward": 1, "fwdlap_backward": 1}}),
            ("DRM", 300, {"torch": {}, "fused": {"quad_sums": 1, "quad_seeded": 1}})):
        runs = {impl: run(method=method, jet_impl=impl, epochs=epochs) for impl in per_step}
        ref = runs["torch"][0]
        rows = {}
        for impl, (out, counts, wall) in runs.items():
            first, first10 = _first_band(ref, out)
            h = out["history"]
            want = {k: n * epochs for k, n in per_step[impl].items()}
            windows = h["total"].reshape(-1, 20).mean(axis=1)
            row = {"epochs": epochs, "rel_l2": out["rel_l2"], "min_epoch": out["min_epoch"],
                   "wall_s": wall, "steps_per_s": out["result"].timing["steps_per_s"],
                   "launches": counts, "per_step": per_step[impl], "total0_rel": first,
                   "first10_max_rel": first10, "total_first20": float(windows[0]),
                   "total_last20": float(windows[-1]), "l2_first": float(h["l2"][0])}
            good = bool(all(np.all(np.isfinite(h[k])) for k in ("total", "l2"))
                        and first <= 1e-4 and first10 <= 5e-2 and counts == want)
            if method == "PINN":
                good = good and out["rel_l2"] <= max(2.0 * ref["rel_l2"], 1e-3)
            else:
                good = good and windows[-1] < windows[0] and out["L2_error"] < h["l2"][0]
            row["ok"] = bool(good)
            ok = ok and row["ok"]
            rows[impl] = row
        report[method.lower()] = rows
    report["ok"] = bool(ok)
    emit(report)
    if not ok:
        raise SystemExit("3D well path check failed")
    return {m: {impl: r["steps_per_s"] for impl, r in report[m].items()}
            for m in ("pinn", "drm")}


def phase_neumann_path():
    """``train_poisson_nd`` at the config of ACCEPTANCE.json's
    poisson_5d_pinn_neumann (5D PINN, hard Neumann: bc_mode 'FBC' with
    bc_type 'neumann', the raw net on cosine input features; solution 'cos',
    32768 Sobol points redrawn every epoch, cosine schedule), cut to 2000 of
    its 60000 epochs, on the 'torch' route (the only one that takes the
    map: 'kernel' and 'fused' must raise).  Gates: finite; best rel_l2 at
    most a tenth of the first eval's; no kernel launched; the hard boundary
    condition on the card, |du/dn| <= 1e-5 max |grad u| at 1000 points on
    the faces."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.problems import PoissonConfig, train_poisson_nd

    dim, epochs = 5, 2000
    cfg = dict(dim=dim, method="PINN", bc_mode="FBC", bc_type="neumann", solution="cos",
               n_interior=32768, sampler="sobol", resample=True, lr_schedule="cosine",
               epochs=epochs, chunk=1000)
    refused = {}
    for impl in ("kernel", "fused"):
        try:
            train_poisson_nd(PoissonConfig(jet_impl=impl, **cfg))
            refused[impl] = False
        except ValueError as err:
            refused[impl] = "input_map" in str(err)
    reset_launches()
    t0 = time.time()
    out = train_poisson_nd(PoissonConfig(jet_impl="torch", **cfg))
    wall = time.time() - t0
    counts = {k: v for k, v in LAUNCHES.items() if v}
    h = out["history"]
    rel_first = float(h["l2"][0]) / 0.5 ** (dim / 2.0)
    # du/dn on the faces: point p on face (axis p % d, side (p // d) % 2)
    model, params = out["model"], out["result"].best_params
    dev = params[0][0].device
    X = torch.rand((1000, dim), generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev) * L
    idx = torch.arange(1000, device=dev)
    axis = idx % dim
    X[idx, axis] = ((idx // dim) % 2).to(X.dtype) * L
    g = model.fields(params, X).grad
    dn, gmax = float(g[idx, axis].abs().max()), float(g.abs().max())
    finite = all(np.all(np.isfinite(h[k])) for k in ("total", "l2", "pde"))
    ok = bool(finite and out["rel_l2"] <= 0.1 * rel_first and dn <= 1e-5 * gmax
              and counts == {} and all(refused.values()))
    report = {"phase": "neumann_path", "dim": dim, "epochs": epochs, "cut_from": 60000,
              "n_interior": 32768, "layers": [dim] + [64] * 4 + [1],
              "rel_l2": out["rel_l2"], "rel_l2_first": rel_first,
              "best_epoch": out["best_epoch"], "wall_s": wall,
              "steps_per_s": out["result"].timing["steps_per_s"],
              "face_points": 1000, "max_abs_dudn": dn, "max_abs_grad": gmax,
              "refused": refused, "launches": counts, "finite": finite, "ok": ok}
    emit(report)
    if not ok:
        raise SystemExit("hard-Neumann path check failed")
    return report["steps_per_s"]


def phase_ipw3d_timing(dev, only=None):
    """Rows 1, 4, 5, 9 and 10 at d = 3 on u64 (the 3D well's routes; rows 1,
    4 and 5 at S = 5 streams run their variants without the fold, rows 9
    and 10 at S = 4 with it) at its 131072 points and at 262144, each with
    its plan."""
    rows = []
    for kind in IPW3D_KERNELS:
        if not timed(kind, only):
            continue
        for N in (IPW3D_N, 262144):
            case = ipw3d_case(kind, N, seed=17, dev=dev)
            ms = time_ms(case.kernel)
            if kind in ("fwdlap_forward", "quad_sums"):
                plan = pass_a_plan(kind, IPW3D_U, 0, N, dev)
            elif kind == "quad_seeded":
                plan = quotient_plan(case)
            else:
                plan = fused_plan(kind, IPW3D_U, N, dev)
            flop, nbytes = case.flops(), case.bytes()
            rows.append({"kernel": kind, "net": "u", "d": 3, "N": N, "plan": plan, "ms": ms,
                         "device_ms": device_ms(case.kernel),
                         "plain_ms": time_ms(lambda: case.plain(torch.float32), warmup=2,
                                             reps=7),
                         "bound_ms": case.bound_ms(),
                         "bound_by": ("operations" if flop / FP32_PEAK >= nbytes / HBM_RATE
                                      else "bytes"),
                         "flop": flop, "bytes": nbytes, "gflops": flop / (ms * 1e-3) / 1e9})
            del case
            torch.cuda.empty_cache()
    emit({"phase": "ipw3d_timing", "rows": rows})
    return rows


# ------------------------------------------------------- the 1D eigenproblems
# The 1D infinite well (``train_ipw_1d`` / ``train_ipw_1d_wan``: u50 and
# critic c20, tanh) and the 1D oscillator (``train_qho_1d``: u200 sin;
# ``train_qho_1d_wan``: u200 and critic v100, tanh), 1000 grid points, d = 1
# (S = 3 with the Laplacian, 2 without).
E1_N = 1000
E1_NETS = {"u50": (1, 50, 50, 50, 1), "c20": (1, 20, 20, 20, 1),
           "u200": (1, 200, 200, 200, 1), "v100": (1, 100, 100, 100, 1)}
# (kernel, net, activation): the shapes the 1D paths give rows 1, 4, 5, 7-10
E1_CASES = (
    ("fused_linear_residual", "u50", "tanh"), ("fused_linear_residual", "u200", "sin"),
    ("fwdlap_forward", "u50", "tanh"), ("fwdlap_forward", "u200", "sin"),
    ("fwdlap_forward", "c20", "tanh"), ("fwdlap_forward", "u200", "tanh"),
    ("fwdlap_forward", "v100", "tanh"),
    ("fwdlap_backward", "u50", "tanh"), ("fwdlap_backward", "u200", "sin"),
    ("linear_sums", "u50", "tanh"), ("linear_sums", "c20", "tanh"),
    ("linear_sums", "u200", "tanh"), ("linear_sums", "v100", "tanh"),
    ("linear_seeded", "u50", "tanh"), ("linear_seeded", "c20", "tanh"),
    ("linear_seeded", "u200", "tanh"), ("linear_seeded", "v100", "tanh"),
    ("quad_sums", "u50", "tanh"), ("quad_sums", "u200", "sin"),
    ("quad_seeded", "u50", "tanh"), ("quad_seeded", "u200", "sin"),
)
E1_KERNELS = ("fused_linear_residual", "fwdlap_forward", "fwdlap_backward", "linear_sums",
              "linear_seeded", "quad_sums", "quad_seeded")
E1_WIDE = (1, 130, 256, 1)     # a ragged wide net: a layer of 130 (padded to 132) and 256
# the Adam paths' epochs, cut (PERF.md section 4) so that the group's training
# stays near 150 s beside the two full-length L-BFGS rows
E1_EPOCHS = 200                # of 3000 (ipw1d) and 10000 (qho1d)
E1_WAN_EPOCHS = 120            # of 3000 (ipw1d WAN) and 30000 (qho1d WAN)


def e1_case(kind, layers, act, N, seed, dev):
    """One of E1_KERNELS at d = 1 over N random points (the WAN rows without
    the Laplacian stream, as the weak form runs them)."""
    if kind == "fused_linear_residual":
        return Case(kind, N, 1, layers, act, seed=seed, dev=dev)
    if kind == "fwdlap_backward":
        return EigenCase(kind, N, layers, act, seed=seed, dev=dev)
    return WanCase(kind, N, layers, act, seed=seed, dev=dev)


def phase_eigen1d_kernels(dev):
    """Rows 1, 4, 5 and 7-10 at d = 1 on the 1D paths' nets (E1_CASES), at
    1000 points and 1007 (a multiple of no tile), and on the ragged wide net
    E1_WIDE, against their float64 plain versions (:func:`hold`: the bars of
    the earlier kernel phases, two launches bitwise equal)."""
    rows, max_err = [], {}
    cases = [(kind, E1_NETS[net], net, act) for kind, net, act in E1_CASES]
    cases += [(kind, E1_WIDE, "wide", "tanh") for kind in E1_KERNELS]
    for i, (kind, layers, net, act) in enumerate(cases):
        for N in ((E1_N, E1_N + 7) if net != "wide" else (E1_N + 7,)):
            case = e1_case(kind, layers, act, N, seed=700 + i, dev=dev)
            row = dict(hold(case), net=net, act=act)
            rows.append(row)
            max_err[kind] = max(max_err.get(kind, 0.0), row["max_abs_err"])
            del case
    torch.cuda.empty_cache()
    emit({"phase": "eigen1d_kernels", "tol": 1e-5, "rows": rows})
    if not all(r["ok"] for r in rows):
        raise SystemExit("1D eigenproblem kernel vs plain comparison failed")
    return max_err


def phase_eigen1d_path():
    """The 1D entry points at their default nets and 1000-point grids (cuts
    in PERF.md section 4), each route from one seed:

    * ``train_ipw_1d(n=3, technique='FN')``, E1_EPOCHS of its 3000 epochs:
      PINN on 'torch', 'kernel' and 'fused', DRM on 'torch' and 'fused';
    * ``train_ipw_1d_wan(technique='FN')``, E1_WAN_EPOCHS of its 3000,
      'torch' and 'fused';
    * ``train_qho_1d(n=1, technique='FN')`` on u200, E1_EPOCHS of its 10000
      epochs: PINN on three routes, DRM on two;
    * the L-BFGS rows of ACCEPTANCE.json at full length (3000 iterations,
      ``lbfgs_mode='replace'``): qho1d_n0_drm_fn_lbfgs on 'fused',
      qho1d_n2_pinn_fn_lbfgs on 'kernel';
    * ``train_qho_1d_wan(n=0, technique='OG', minimax='extragradient',
      v_lr=2e-3)`` (the qho1d_n0_wan_og_trainE schedule) for E1_WAN_EPOCHS of
      its 30000 epochs on 'torch' and 'fused';
    * ``train_ipw_2d(LBFGS=True)`` (state (3, 3), FN, weights {'data': 1e4},
      the default nets and 40000 grid points): 100 epochs on 'fused' and the
      500-iteration polish.

    Gates: the kernel routes start as 'torch' does (first total within rtol
    1e-4, the first 10 within 5e-2; for the WAN rows on 10 epochs of the
    same configuration with the critic frozen, ``v_lr=0``);
    PINN best MSE <= max(2 x torch, 1e-3); every best eval below the
    first, every value finite; the L-BFGS
    rows' best MSE <= 1e-5 (ACCEPTANCE.json's bar); exact launch counts per
    step, epoch or evaluation."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.problems import (IPW1DConfig, IPW1DWanConfig, IPW2DConfig,
                                          QHO1DConfig, QHO1DWanConfig, train_ipw_1d,
                                          train_ipw_1d_wan, train_ipw_2d, train_qho_1d,
                                          train_qho_1d_wan)

    for cfg, net in ((IPW1DConfig(), "u50"), (IPW1DWanConfig(), "u50"),
                     (QHO1DConfig(), "u200"), (QHO1DWanConfig(), "u200")):
        if tuple(cfg.layers) != E1_NETS[net] or cfg.grid_n != E1_N:
            raise SystemExit(f"{type(cfg).__name__}'s defaults are not the full-width net")

    def run(fn, cfg):
        reset_launches()
        t0 = time.time()
        out = fn(cfg)
        return out, {k: v for k, v in LAUNCHES.items() if v}, time.time() - t0

    def finite(out):
        return all(np.all(np.isfinite(v)) for v in out["history"].values())

    report, launches, ok = {"phase": "eigen1d_path", "grid_points": E1_N}, {}, True
    t_group = time.time()
    # ---- PINN and DRM, Adam, the routes from one seed
    per_step = {"PINN": {"torch": {}, "kernel": {"fwdlap_forward": 1, "fwdlap_backward": 1},
                         "fused": {"fused_linear_residual": 1}},
                "DRM": {"torch": {}, "fused": {"quad_sums": 1, "quad_seeded": 1}}}
    for entry, fn, cfg_cls, kw, epochs, cut_from in (
            ("ipw1d_n3_fn", train_ipw_1d, IPW1DConfig, dict(n=3, technique="FN"), E1_EPOCHS,
             3000),
            ("qho1d_n1_fn", train_qho_1d, QHO1DConfig, dict(n=1, technique="FN"), E1_EPOCHS,
             10000)):
        for method in ("PINN", "DRM"):
            runs = {impl: run(fn, cfg_cls(method=method, jet_impl=impl, epochs=epochs, **kw))
                    for impl in per_step[method]}
            ref = runs["torch"][0]
            rows = {}
            for impl, (out, counts, wall) in runs.items():
                first, first10 = _first_band(ref, out)
                want = {k: n * epochs for k, n in per_step[method][impl].items()}
                row = {"epochs": epochs, "cut_from": cut_from, "best_mse": out["L2_error"],
                       "min_epoch": out["min_epoch"], "mse_first": float(out["history"]["l2"][0]),
                       "wall_s": wall, "steps_per_s": out["result"].timing["steps_per_s"],
                       "launches": counts, "total0_rel": first, "first10_max_rel": first10}
                good = (finite(out) and first <= 1e-4 and first10 <= 5e-2 and counts == want)
                good = good and out["L2_error"] < out["history"]["l2"][0]
                if method == "PINN":
                    good = good and out["L2_error"] <= max(2.0 * ref["L2_error"], 1e-3)
                row["ok"] = bool(good)
                ok = ok and row["ok"]
                rows[impl] = row
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
            report[f"{entry}_{method.lower()}"] = rows
    # ---- WAN: the well's FN table, the oscillator's trainable E
    for entry, fn, cfg, per_epoch in (
            ("ipw1d_wan_fn", train_ipw_1d_wan, dict(technique="FN", epochs=E1_WAN_EPOCHS),
             {"fwdlap_forward": 2, "linear_sums": 6, "linear_seeded": 6}),
            ("qho1d_n0_wan_og_trainE", train_qho_1d_wan,
             dict(n=0, technique="OG", epochs=E1_WAN_EPOCHS, minimax="extragradient", v_lr=2e-3,
                  lr_schedule="cosine", lr_decay_steps=15000),
             {"fwdlap_forward": 4, "linear_sums": 8, "linear_seeded": 8})):
        cls = IPW1DWanConfig if entry.startswith("ipw") else QHO1DWanConfig
        (wt, ct, wall_t), (wf, cf, wall_f) = (run(fn, cls(jet_impl=impl, **cfg))
                                              for impl in ("torch", "fused"))
        # the routes' first totals with the critic frozen: Adam's first
        # steps move each critic weight by about its rate times the sign of
        # its gradient, so a component at the rounding level can flip a
        # step and part the trained runs' first totals by more than any
        # kernel error (the oscillator's torch route moves its own by
        # 1.6e-3 under one-ulp moves of its critic's weights)
        ft, ff = (fn(cls(jet_impl=impl, **dict(cfg, epochs=10, v_lr=0.0)))
                  for impl in ("torch", "fused"))
        first, first10 = _first_band(ft, ff)
        trained = _first_band(wt, wf)
        want = {k: n * cfg["epochs"] for k, n in per_epoch.items()}
        row = {"epochs": cfg["epochs"], "cut_from": 30000 if "trainE" in entry else 3000,
               "critic_frozen": {"epochs": 10, "v_lr": 0.0, "total0_rel": first,
                                 "first10_max_rel": first10},
               "trained_total0_rel": trained[0], "trained_first10_max_rel": trained[1],
               "best_mse_torch": wt["L2_error"], "best_mse_fused": wf["L2_error"],
               "mse_first": float(wt["history"]["l2"][0]),
               "epochs_per_s_torch": wt["result"].timing["steps_per_s"],
               "epochs_per_s_fused": wf["result"].timing["steps_per_s"],
               "wall_s_torch": wall_t, "wall_s_fused": wall_f, "launches": cf,
               "per_epoch": per_epoch}
        if "E_est" in wf:
            row.update(E_est_fused=wf["E_est"], E_rayleigh_fused=wf["E_rayleigh"],
                       E_est_torch=wt["E_est"], E_exact=wf["E_exact"])
        row["ok"] = bool(finite(wt) and finite(wf) and finite(ft) and finite(ff)
                         and first <= 1e-4 and first10 <= 5e-2
                         and all(r["L2_error"] < r["history"]["l2"][0] for r in (wt, wf))
                         and ct == {} and cf == want)
        ok = ok and row["ok"]
        report[entry] = row
        for k, v in cf.items():
            launches[k] = launches.get(k, 0) + v
    # ---- the L-BFGS rows at full length (L-BFGS in place of Adam)
    for entry, impl, method, n, kern in (
            ("qho1d_n0_drm_fn_lbfgs", "fused", "DRM", 0, ("quad_sums", "quad_seeded")),
            ("qho1d_n2_pinn_fn_lbfgs", "kernel", "PINN", 2,
             ("fwdlap_forward", "fwdlap_backward"))):
        out, counts, wall = run(train_qho_1d, QHO1DConfig(
            n=n, method=method, technique="FN", epochs=0, LBFGS=True, lbfgs_mode="replace",
            lbfgs_iters=3000, jet_impl=impl))
        t = out["result"].timing
        # one value and gradient per line-search evaluation and at the start,
        # and the loss alone once more where the fit converged before 3000
        done = int(t["iterations"] < 3000)
        want = {kern[0]: 1 + t["evaluations"] + done, kern[1]: 1 + t["evaluations"]}
        row = {"iterations": t["iterations"], "evaluations": t["evaluations"],
               "host_syncs": t["host_syncs"],
               "host_syncs_per_iteration": t["host_syncs"] / max(t["iterations"], 1),
               "best_mse": out["L2_error"], "best_iteration": out["min_epoch"],
               "acceptance_best_mse": {"qho1d_n0_drm_fn_lbfgs": 2.868810050626891e-11,
                                       "qho1d_n2_pinn_fn_lbfgs": 1.454312403836866e-08}[entry],
               "wall_s": wall, "iterations_per_s": t["steps_per_s"], "launches": counts}
        row["ok"] = bool(finite(out) and out["L2_error"] <= 1e-5 and counts == want
                         and out["history"]["total"].shape == (3000,))
        ok = ok and row["ok"]
        report[entry] = row
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    # ---- train_ipw_2d's polish after Adam
    out, counts, wall = run(train_ipw_2d, IPW2DConfig(
        nx=3, ny=3, technique="FN", method="PINN", weights={"data": 1e4}, epochs=100,
        chunk=1000, LBFGS=True, jet_impl="fused"))
    adam_best = float(np.min(out["history"]["l2"]))
    row = {"epochs": 100, "polish_iterations": 500, "adam_best_mse": adam_best,
           "best_mse": out["L2_error"], "rel_l2": out["rel_l2"], "best_epoch": out["min_epoch"],
           "wall_s": wall, "launches": counts}
    # the polish (on the torch jet, as JAX's 'pallas-fused' polishes on its
    # XLA jet) must improve on Adam's best: it becomes the best at epoch 100
    row["ok"] = bool(finite(out) and out["min_epoch"] == 100 and out["L2_error"] < adam_best
                     and counts == {"fused_linear_residual": 100})
    ok = ok and row["ok"]
    report["ipw2d_n33_pinn_fn_lbfgs_polish"] = row
    report["training_s"] = time.time() - t_group
    report["ok"] = bool(ok)
    emit(report)
    if not ok:
        raise SystemExit("1D eigenproblem path check failed")
    rates = {k: {impl: r["steps_per_s"] for impl, r in v.items()}
             for k, v in report.items() if k.endswith(("_pinn", "_drm"))}
    rates.update({k: {"torch": report[k]["epochs_per_s_torch"],
                      "fused": report[k]["epochs_per_s_fused"]}
                  for k in ("ipw1d_wan_fn", "qho1d_n0_wan_og_trainE")})
    rates.update({k: report[k]["iterations_per_s"]
                  for k in ("qho1d_n0_drm_fn_lbfgs", "qho1d_n2_pinn_fn_lbfgs")})
    return launches, rates


def e1_plan(case, N, dev):
    """The launch shape the wrapper of this case's kernel takes at N."""
    if case.kind in ("fwdlap_forward", "linear_sums", "quad_sums"):
        return pass_a_plan(case.kind, case.layers, 0, N, dev)
    if case.kind.endswith("seeded"):
        return quotient_plan(case)
    return fused_plan(case.kind, case.layers, N, dev)


def phase_eigen1d_timing(dev, only=None):
    """Rows 1, 4, 5 and 7-10 on the 1D paths' nets (E1_CASES) at the paths'
    1000 points and at 262144: wrapper ms, device ms, plan, bound, and the
    plain version's ms."""
    rows = []
    for kind, net, act in E1_CASES:
        if not timed(kind, only):
            continue
        for N in (E1_N, 262144):
            case = e1_case(kind, E1_NETS[net], act, N, seed=19, dev=dev)
            ms = time_ms(case.kernel)
            flop, nbytes = case.flops(), case.bytes()
            rows.append({"kernel": kind, "net": net, "act": act, "d": 1, "N": N,
                         "plan": e1_plan(case, N, dev), "ms": ms,
                         "device_ms": device_ms(case.kernel),
                         "plain_ms": time_ms(lambda: case.plain(torch.float32), warmup=2,
                                             reps=7),
                         "bound_ms": case.bound_ms(),
                         "bound_by": ("operations" if flop / FP32_PEAK >= nbytes / HBM_RATE
                                      else "bytes"),
                         "flop": flop, "bytes": nbytes, "gflops": flop / (ms * 1e-3) / 1e9})
            del case
            torch.cuda.empty_cache()
    emit({"phase": "eigen1d_timing", "rows": rows})
    return rows


def phase_graph_trace(dev):
    """Rows 9 and 10 on u200 captured into one CUDA graph as the L-BFGS rows
    capture their evaluations (``_cuda.graph``) and replayed once under
    ``torch.profiler``: the kernels the device ran, by name, beside the
    launches the replay adds to the counts (which the L-BFGS rows' gate
    reads).  Reported, not gated: the profiler's device trace is a second
    witness where the card's tracing works."""
    from nnpde_tpu_torch.kernels import _cuda

    cases = [e1_case(kind, E1_NETS["u200"], "sin", E1_N, seed=41, dev=dev)
             for kind in ("quad_sums", "quad_seeded")]

    def evaluation():
        return [case.kernel() for case in cases]

    evaluation()                       # plans, builds and workspaces outside the capture
    torch.cuda.synchronize()
    g = _cuda.graph(evaluation)
    before = dict(_cuda.LAUNCHES)
    row = {"phase": "graph_trace", "graph_counts": dict(g.counts)}
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            g.replay()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        row["traced_kernels"] = {k: sum(k in n for n in names) for k in g.counts}
        row["traced_device_events"] = len(names)
    except Exception as exc:            # the card's tracing, not the kernels, failed
        g.replay()
        torch.cuda.synchronize()
        row["traced_kernels"], row["trace_error"] = None, repr(exc)[:300]
    row["counted"] = {k: _cuda.LAUNCHES[k] - before.get(k, 0) for k in g.counts}
    emit(row)
    return row


# The design that reads the hidden weights from device memory (DES_DEVW)
# against the plans' own choice on the 1D paths' widest nets, u200 and v100,
# and on E1_WIDE (where it is the only fit): the design's own plan and each
# of its tiers at DEVW_TILES
DEVW_CASES = tuple(c for i, c in enumerate(E1_CASES) if c[1] in ("u200", "v100")
                   and all(e[:2] != c[:2] for e in E1_CASES[:i]))
DEVW_TILES = (8, 12, 16, 24)


def devw_plans(case, N, dev):
    """The wrapper's plan for this case at N, then the DES_DEVW plans that
    fit (the design's own, each device tier at DEVW_TILES), without
    repeats."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fused_quotient as fq
    from nnpde_tpu_torch.kernels import fused_step as fs
    from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

    kind, layers, sms = case.kind, case.layers, _cuda.sm_count(dev)
    seeded = kind.endswith("seeded")
    devw = _cuda.DES_DEVW if seeded else _cuda.DES_PLANNED | _cuda.DES_DEVW

    def plan(**pin):
        if kind == "fused_linear_residual":
            return fs.plan(kind, layers, **pin)
        if kind == "fwdlap_backward":
            return fc.backward_plan(layers, **pin)
        if kind == "fwdlap_forward":
            return fc.forward_plan(layers, N=N, sms=sms, **pin)
        return fq.plan(kind, layers, case.lap, **pin,
                       **({} if seeded else {"N": N, "sms": sms}))

    plans = [plan()]
    tiers = ("gradient-device", "device") if seeded else ("device",)
    for pin in [{}] + [{"T": T, "tier": t} for t in tiers for T in DEVW_TILES]:
        try:
            pl = plan(design=devw, **pin)
        except ValueError:
            continue
        if pl not in plans:
            plans.append(pl)
    return plans


def pinned_case(case, pl):
    """``case`` with its kernel launched on the plan ``pl`` (the form
    :func:`hold` reads)."""
    from nnpde_tpu_torch.kernels import fused_quotient as fq
    from nnpde_tpu_torch.kernels import fused_step as fs
    from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

    kind, p, X, act = case.kind, case.params, case.X, case.act
    if kind == "fused_linear_residual":
        def run():
            dWs, dbs, sums = fs._unflatten(p, fs._launch(kind, p, X, case.coef, act, pl=pl))
            return sums[0] / case.N, None, fs._scaled_grads(p, dWs, dbs, sums, 2.0 / case.N)
    elif kind == "fwdlap_backward":
        def run():
            dWs, dbs = fc.fwdlap_backward(p, X, case.ct, act, pl=pl)
            return torch.cat([t.reshape(-1) for pair in zip(dWs, dbs) for t in pair])
    elif kind == "fwdlap_forward":
        def run():
            return fc.fwdlap_forward(p, X, act, pl=pl)
    else:
        def run():
            return fq._launch(kind, p, X, case.coef, case.scal, act, case.lap, pl=pl)
    case.kernel = run
    return case


def phase_devw_sweep(dev):
    """DEVW_CASES at the paths' 1000 points and at 262144, and rows 1, 4, 5
    and 7-10 on E1_WIDE at 262144: the wrapper's plan and the DES_DEVW plans
    (:func:`devw_plans`), each held to its float64 plain version by
    :func:`hold` and timed as device time.  One JSON line per launch shape;
    the wrapper's own choice carries ``"chosen": true``."""
    cases = [(kind, E1_NETS[net], net, act, N) for kind, net, act in DEVW_CASES
             for N in (E1_N, 262144)]
    cases += [(kind, E1_WIDE, "wide", "tanh", 262144) for kind in E1_KERNELS]
    ok = True
    for kind, layers, net, act, N in cases:
        case = e1_case(kind, layers, act, N, seed=31, dev=dev)
        plans = devw_plans(case, N, dev)
        for pl in plans:
            pinned_case(case, pl)
            row = dict(hold(case), net=net, act=act, chosen=pl == plans[0],
                       device_ms=device_ms(case.kernel), bound_ms=case.bound_ms())
            row.update(plan_row(kind, layers, case.d + (2 if kind.startswith("fwdlap") or
                                                        kind == "fused_linear_residual"
                                                        else 1 + case.lap),
                                pl, N, dev))
            ok = ok and row["ok"]
            emit(dict(row, sweep="devw"))
        del case
        torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("devw sweep: a launch shape missed its bar")


# ------------------------------------------ the trainable-energy eigenproblems
# The 2D oscillator (``train_qho_2d``: u50 at d = 2 on [-6, 6]^2, 40000 grid
# points, the critic c20) and Kramers-Henneberger (``train_kh``: the
# acceptance net (1, 100 x 3, 1) sin and the default (1, 64 x 3, 1) sin at
# 1024 points; the WAN critic (1, 50 x 3, 1) sin with no trial factor).
KH_N = 1024
KH_NETS = {"u100": (1, 100, 100, 100, 1), "u64": (1, 64, 64, 64, 1),
           "c50": (1, 50, 50, 50, 1)}
# (kernel, net): the shapes the KH paths first give rows 1, 4, 5, 7-10
KH_CASES = (("fused_linear_residual", "u100"), ("fwdlap_forward", "u100"),
            ("fwdlap_backward", "u100"), ("quad_sums", "u100"), ("quad_seeded", "u100"),
            ("linear_sums", "c50"), ("linear_seeded", "c50"))
# the KH acceptance rows' config (scripts/acceptance.py run_kh, run_kh_methods)
KH_GT = dict(alpha=10.0, L=60.0, N=5000, n_levels=6)
KH_ACC = dict(layers=KH_NETS["u100"], train_n=KH_N, lambda_pde=10.0, lambda_data=1e4,
              lambda_norm=10.0, data_fraction=0.5, max_data_points=500, lambda_parity=1e4)
# the paths' epochs, cut (never the widths) so that both groups add about
# 150 s to the whole run
Q2_EPOCHS = 300               # of 10000 (QHO2DConfig) and 50000 (the paper sweep)
Q2_DRM_EPOCHS = 300
Q2_WAN_EPOCHS = 150
KH_EPOCHS = 500               # of 10000 (kh1d_alpha10_pinn)
KH_DRM_EPOCHS = 500           # of 5000 (kh1d_alpha10_*_dense)
KH_WAN_EPOCHS = 200


def elane_case(net, N, seed, dev):
    """Row 1 with the e lane as the trainable-E paths build it: ``r = -1/2
    lap u + (V - E) u`` on ``u = B net``, the e column B.  ``net``: u100 /
    u64 with the KH window (FBC) or u100 raw (``"u100 raw"``, B = 1), x on
    [-60, 60] with the cycle-averaged KH potential; or u50 at d = 2 with
    the 2D oscillator's FN window of state (1, 1) on [-6, 6]^2."""
    from nnpde_tpu_torch.kernels import fused_step as fs
    from nnpde_tpu_torch.models import factor_for_technique
    from nnpde_tpu_torch.ops.fwdlap import Jet
    from nnpde_tpu_torch.pde import kh, qho

    name, raw = net.split()[0], net.endswith("raw")
    layers = EIGEN_U if name == "u50" else KH_NETS[name]
    d = layers[0]
    case = Case("fused_linear_residual", N, d, layers, "sin", seed=seed, dev=dev)
    rng = np.random.default_rng(seed + 1)
    if d == 1:
        X = np.sort(rng.uniform(-60.0, 60.0, (N, 1)), axis=0)
        factor = None if raw else factor_for_technique("FBC", dim=1, kind="window", L=60.0)
    else:
        X = rng.uniform(-6.0, 6.0, (N, 2))
        factor = factor_for_technique("FN", dim=2, kind="window", L=6.0,
                                      nodes_per_dim=[qho.nodes(1), qho.nodes(1)])
    case.X = X = torch.as_tensor(X.astype(np.float32), device=dev)
    if d == 1:
        V, E = kh.v_kh_avg(X[:, 0], alpha0=10.0), -0.0112
    else:
        V, E = qho.potential_2d(X[:, 0], X[:, 1]), qho.energy_2d(1, 1) + 0.05
    if factor is None:
        one = torch.ones((N,), device=dev)
        fj = Jet(one, torch.zeros_like(X), torch.zeros_like(one))
    else:
        fj = factor.jet(X)
    case.coef = fs.residual_coefficients(fj, a0=-0.5, c0=V - E, e_lane=True).contiguous()
    return case


def hold_elane(case):
    """:func:`hold` (loss and gradients within 1e-5 of float64, repeats
    bitwise) and the e lane's sum ``sum r e net``: within 1e-5 of the sum of
    its terms' magnitudes, the same bits on a repeat."""
    from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap

    row = hold(case)
    s1, s2 = (case.kernel()[1]["sum_r_ufull"] for _ in range(2))
    torch.cuda.synchronize()
    p = [(W.double(), b.double()) for W, b in case.params]
    X, c, d = case.X.double(), case.coef.double(), case.d
    _, _, sums = case.fs.linear_residual_plain(p, X, c, case.act)
    jet = mlp_fwdlap(p, X, case.act)
    r = (c[:, 0] * jet.value + torch.sum(c[:, 1:1 + d] * jet.grad, dim=1)
         + c[:, d + 1] * jet.lap + c[:, d + 2])
    terms = float(torch.sum(torch.abs(r * c[:, d + 3] * jet.value)))
    err = abs(float(s1) - float(sums[2]))
    row.update(sum_r_ufull=float(s1), sum_r_ufull_ref=float(sums[2]),
               sum_err_over_abs_terms=err / terms, e_lane_bitwise=bool(torch.equal(s1, s2)))
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["ok"] = bool(row["ok"] and err <= 1e-5 * terms and row["e_lane_bitwise"])
    return row


def phase_trainE_kernels(dev):
    """Before any training of the ``kh`` group: row 1 with the e lane on
    u100 (the KH window and raw), u64 and u50 at d = 2 (:func:`elane_case`,
    :func:`hold_elane`), and rows 4, 5, 9, 10 on u100 and rows 7, 8 on the
    critic c50 (sin), at 1024 and 1031 points (u50: 40000 and 40007),
    against their float64 plain versions by :func:`hold`."""
    rows, max_err = [], {}
    for i, (net, N) in enumerate([(net, N) for net in ("u100", "u100 raw", "u64")
                                  for N in (KH_N, KH_N + 7)]
                                 + [("u50", EIGEN_N), ("u50", EIGEN_N + 7)]):
        row = dict(hold_elane(elane_case(net, N, seed=900 + i, dev=dev)), net=net, e_lane=True)
        rows.append(row)
        max_err["fused_linear_residual"] = max(max_err.get("fused_linear_residual", 0.0),
                                               row["max_abs_err"])
    for i, (kind, net) in enumerate(KH_CASES[1:]):
        for N in (KH_N, KH_N + 7):
            row = dict(hold(e1_case(kind, KH_NETS[net], "sin", N, seed=950 + i, dev=dev)),
                       net=net, act="sin")
            rows.append(row)
            max_err[kind] = max(max_err.get(kind, 0.0), row["max_abs_err"])
    torch.cuda.empty_cache()
    emit({"phase": "trainE_kernels", "tol": 1e-5, "rows": rows})
    if not all(r["ok"] for r in rows):
        raise SystemExit("trainable-energy kernel vs plain comparison failed")
    return max_err


def _run_counted(fn, *args, **kw):
    """``fn(*args, **kw)`` with the launch counts set to 0 just before and
    read just after: (output, non-zero counts, wall seconds)."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    t0 = time.time()
    out = fn(*args, **kw)
    return out, {k: v for k, v in LAUNCHES.items() if v}, time.time() - t0


def _finite(out):
    return all(np.all(np.isfinite(v)) for v in out["history"].values())


def _gate_routes(runs, per_step, epochs, method, E_of=None, E_ref=None):
    """The cut paths' gates over ``runs`` ({route: (out, counts, wall)},
    'torch' first): the kernel routes start as 'torch' does (first total
    within rtol 1e-4, the first 10 within 5e-2), PINN best eval <= max(2 x
    torch, 1e-3), every route's best below its first, all finite, exact
    launch counts; with ``E_of``, each route's final |E - E_ref| <= max(2 x
    torch's, 1e-4)."""
    ref = runs["torch"][0]
    e_torch = abs(E_of(ref) - E_ref) if E_of else None
    rows, ok = {}, True
    for impl, (out, counts, wall) in runs.items():
        first, first10 = _first_band(ref, out)
        best = out.get("L2_error", out.get("L2"))
        want = {k: n * epochs for k, n in per_step[impl].items()}
        row = {"epochs": epochs, "best_eval": best, "eval_first": float(out["history"]["l2"][0]),
               "wall_s": wall, "steps_per_s": out["result"].timing["steps_per_s"],
               "launches": counts, "total0_rel": first, "first10_max_rel": first10}
        good = _finite(out) and first <= 1e-4 and first10 <= 5e-2 and counts == want
        good = good and best < out["history"]["l2"][0]
        if method == "PINN":
            good = good and best <= max(2.0 * (ref.get("L2_error", ref.get("L2"))), 1e-3)
        if E_of:
            row["E_final"], row["E_err"] = E_of(out), abs(E_of(out) - E_ref)
            good = good and row["E_err"] <= max(2.0 * e_torch, 1e-4)
        row["ok"] = bool(good)
        ok = ok and row["ok"]
        rows[impl] = row
    return rows, ok


PINN_STEP = {"torch": {}, "kernel": {"fwdlap_forward": 1, "fwdlap_backward": 1},
             "fused": {"fused_linear_residual": 1}}
DRM_STEP = {"torch": {}, "fused": {"quad_sums": 1, "quad_seeded": 1}}


def phase_qho2d_path():
    """``train_qho_2d(nx=1, ny=1, technique='FN')`` at its published nets
    (u50, critic c20) and 40000 grid points, each route from one seed:

    * PINN with the paper sweep's trainable E (``trainable_energy``,
      ``energy_variant``, ``energy_lr=1e-4``) on 'torch', 'kernel' and
      'fused' (row 1 reads the e lane), Q2_EPOCHS of 10000;
    * DRM on 'torch' and 'fused' (rows 9, 10 with V), Q2_DRM_EPOCHS;
    * WAN on 'torch' and 'fused' (rows 4, 7, 8 with V, the exact E),
      Q2_WAN_EPOCHS;
    * the PINN config on 'fused' for 100 epochs, then the 500-iteration
      L-BFGS polish over the net and E.

    Gates: :func:`_gate_routes`, E against the exact 2 sqrt(2); the polish
    moves E and improves on Adam's best."""
    from nnpde_tpu_torch.problems import QHO2DConfig, train_qho_2d

    default = QHO2DConfig()
    if (default.layers, default.v_layers, default.grid_n ** 2) != (EIGEN_U, EIGEN_V, EIGEN_N):
        raise SystemExit("QHO2DConfig's defaults are not the published nets and grid")
    base = dict(nx=1, ny=1, technique="FN", chunk=1000)
    pinn = dict(base, method="PINN", trainable_energy=True, energy_variant=True,
                energy_lr=1e-4)
    report, ok = {"phase": "qho2d_path", "layers": list(EIGEN_U), "v_layers": list(EIGEN_V),
                  "grid_points": EIGEN_N, "state": [1, 1], "technique": "FN"}, True
    t_group = time.time()
    runs = {impl: _run_counted(train_qho_2d, QHO2DConfig(jet_impl=impl, epochs=Q2_EPOCHS,
                                                         **pinn))
            for impl in PINN_STEP}
    E_exact = runs["torch"][0]["E_exact"]
    report["pinn_trainE"], good = _gate_routes(
        runs, PINN_STEP, Q2_EPOCHS, "PINN",
        E_of=lambda out: float(out["result"].params["E"]), E_ref=E_exact)
    for impl, (out, _, _) in runs.items():
        report["pinn_trainE"][impl]["learned_energy"] = out["learned_energy"]
    report["E_exact"] = E_exact
    ok = ok and good
    runs = {impl: _run_counted(train_qho_2d, QHO2DConfig(method="DRM", jet_impl=impl,
                                                         epochs=Q2_DRM_EPOCHS, **base))
            for impl in DRM_STEP}
    report["drm"], good = _gate_routes(runs, DRM_STEP, Q2_DRM_EPOCHS, "DRM")
    ok = ok and good
    wan_epoch = {"torch": {}, "fused": {"fwdlap_forward": 2, "linear_sums": 6,
                                        "linear_seeded": 6}}
    runs = {impl: _run_counted(train_qho_2d, QHO2DConfig(method="WAN", jet_impl=impl,
                                                         epochs=Q2_WAN_EPOCHS, **base))
            for impl in wan_epoch}
    report["wan"], good = _gate_routes(runs, wan_epoch, Q2_WAN_EPOCHS, "WAN")
    ok = ok and good
    # ---- the polish over {net, E}
    out, counts, wall = _run_counted(train_qho_2d, QHO2DConfig(
        jet_impl="fused", epochs=100, LBFGS=True, **pinn))
    adam_best = float(np.min(out["history"]["l2"]))
    E_adam = float(out["history"]["E"][-1])
    row = {"epochs": 100, "polish_iterations": 500, "adam_best_mse": adam_best,
           "best_mse": out["L2_error"], "best_epoch": out["min_epoch"],
           "E_at_adam_epoch_99": E_adam, "E_polished": float(out["result"].params["E"]),
           "learned_energy": out["learned_energy"], "wall_s": wall, "launches": counts}
    row["ok"] = bool(_finite(out) and out["min_epoch"] == 100 and out["L2_error"] < adam_best
                     and row["E_polished"] != E_adam
                     and counts == {"fused_linear_residual": 100})
    ok = ok and row["ok"]
    report["pinn_trainE_lbfgs_polish"] = row
    report["training_s"] = time.time() - t_group
    report["ok"] = bool(ok)
    emit(report)
    if not ok:
        raise SystemExit("2D oscillator path check failed")
    return {k: {impl: r["steps_per_s"] for impl, r in report[k].items()}
            for k in ("pinn_trainE", "drm", "wan")}


def kh_ground_truth():
    from nnpde_tpu_torch.pde.kh import KHGroundTruth

    t0 = time.time()
    gt = KHGroundTruth(**KH_GT)
    return gt, time.time() - t0


def phase_kh_path():
    """``train_kh`` against ``KHGroundTruth(alpha=10, L=60, N=5000,
    n_levels=6)`` with the acceptance rows' config (KH_ACC: the net u100 at
    1024 points, ground state), each route from one seed:

    * PINN (FBC, trainable E, row 1 with the e lane) on 'torch', 'kernel'
      and 'fused', KH_EPOCHS of 10000;
    * DRM (FBC, E the Rayleigh quotient; rows 9, 10 with V) on 'torch' and
      'fused', KH_DRM_EPOCHS of 5000;
    * WAN (RAW, trainable E; the ratio-squared pair with the critic's
      direct ascent, rows 4, 7, 8 on u100 and the critic c50) on 'torch' and
      'fused', KH_WAN_EPOCHS of 5000.

    Gates: :func:`_gate_routes`, E (PINN, WAN) against the FD eigenvalue."""
    from nnpde_tpu_torch.problems import KHConfig, train_kh

    gt, gt_s = kh_ground_truth()
    E_ref = gt.energy(0)
    report, ok = {"phase": "kh_path", "layers": list(KH_NETS["u100"]),
                  "v_layers": list(KH_NETS["c50"]), "train_points": KH_N, "n": 0,
                  "ground_truth_s": gt_s, "E_ref": E_ref}, True
    t_group = time.time()

    def final_E(out):
        return float(out["result"].params["E"])

    for method, tech, epochs, per_step, E_of in (
            ("PINN", "FBC", KH_EPOCHS, PINN_STEP, final_E),
            ("DRM", "FBC", KH_DRM_EPOCHS, DRM_STEP, None),
            ("WAN", "RAW", KH_WAN_EPOCHS,
             {"torch": {}, "fused": {"fwdlap_forward": 2, "linear_sums": 4,
                                     "linear_seeded": 4}}, final_E)):
        runs = {impl: _run_counted(train_kh, KHConfig(method=method, technique=tech,
                                                      epochs=epochs, jet_impl=impl, **KH_ACC),
                                   gt)
                for impl in per_step}
        rows, good = _gate_routes(runs, per_step, epochs, method, E_of=E_of, E_ref=E_ref)
        for impl, (out, _, _) in runs.items():
            rows[impl]["E_est"] = out["E_est"]
        report[method.lower()] = rows
        ok = ok and good
    report["training_s"] = time.time() - t_group
    report["ok"] = bool(ok)
    emit(report)
    if not ok:
        raise SystemExit("Kramers-Henneberger path check failed")
    return {k: {impl: r["steps_per_s"] for impl, r in report[k].items()}
            for k in ("pinn", "drm", "wan")}


def phase_kh_timing(dev, only=None):
    """KH_CASES at the path's 1024 points and at 262144 (row 1 with the e
    lane, u100 and the KH window): wrapper ms, device ms, plan, bound, and
    the plain version's ms.  The e lane is a column the stream always
    carries, so it adds no bytes."""
    rows = []
    for kind, net in KH_CASES:
        if not timed(kind, only):
            continue
        for N in (KH_N, 262144):
            case = (elane_case(net, N, seed=23, dev=dev) if kind == "fused_linear_residual"
                    else e1_case(kind, KH_NETS[net], "sin", N, seed=23, dev=dev))
            ms = time_ms(case.kernel)
            flop, nbytes = case.flops(), case.bytes()
            rows.append({"kernel": kind, "net": net, "act": "sin", "d": 1, "N": N,
                         "e_lane": kind == "fused_linear_residual",
                         "plan": e1_plan(case, N, dev), "ms": ms,
                         "device_ms": device_ms(case.kernel),
                         "plain_ms": time_ms(lambda: case.plain(torch.float32), warmup=2,
                                             reps=7),
                         "bound_ms": case.bound_ms(),
                         "bound_by": ("operations" if flop / FP32_PEAK >= nbytes / HBM_RATE
                                      else "bytes"),
                         "flop": flop, "bytes": nbytes, "gflops": flop / (ms * 1e-3) / 1e9})
            del case
            torch.cuda.empty_cache()
    emit({"phase": "kh_timing", "rows": rows})
    return rows


def phase_full(route):
    """The full-length acceptance rows (``python3 chip_smoke.py full``, not
    in the default run), on ``route`` ('fused' unless ``--route=`` names
    another), each against its ACCEPTANCE.json target:

    * ``ipw2d_n33_pinn_fn``: ``train_ipw_2d`` (3, 3) FN PINN, 20000 epochs,
      weights {'data': 1e4}: rel_l2 <= 1e-3;
    * ``kh1d_alpha10_pinn``: ``train_kh`` KH_ACC FBC, 10000 epochs: best
      MSE <= 1e-6 and |E - E_ref| <= 1e-4;
    * ``kh1d_alpha10_{pinn,drm,wan}_dense``: ``run_compare(n_max=1,
      epochs=5000, data_fraction=0.5, max_data_points=500)``: dense L2 <=
      1e-6 and |E - E_ref| <= 1e-4 (WAN 1e-3).

    A miss is reported (``pass`` false) and the group exits non-zero after
    every row has run."""
    from nnpde_tpu_torch.problems import (IPW2DConfig, KHCompareConfig, KHConfig, run_compare,
                                          train_ipw_2d, train_kh)

    rows = []

    def record(name, row):
        row = dict(name=name, route=route, **row)
        rows.append(row)
        emit(dict(phase="full", **row))

    out, counts, wall = _run_counted(train_ipw_2d, IPW2DConfig(
        nx=3, ny=3, method="PINN", technique="FN", epochs=20000, chunk=2000,
        weights={"data": 1e4}, jet_impl=route))
    record("ipw2d_n33_pinn_fn", {
        "rel_l2": out["rel_l2"], "best_mse": out["L2_error"], "best_epoch": out["min_epoch"],
        "epochs": 20000, "wall_s": wall, "steps_per_s": out["result"].timing["steps_per_s"],
        "launches": counts, "acceptance_rel_l2": 6.138212943059301e-05,
        "target": "rel_l2 <= 1e-3", "pass": bool(out["rel_l2"] <= 1e-3 and _finite(out))})
    gt, _ = kh_ground_truth()
    out, counts, wall = _run_counted(train_kh, KHConfig(
        method="PINN", n=0, technique="FBC", epochs=10000, chunk=2000, jet_impl=route,
        **KH_ACC), gt)
    e_err = abs(out["E_est"] - out["E_ref"])
    record("kh1d_alpha10_pinn", {
        "best_mse": out["L2"], "E_est": out["E_est"], "E_ref": out["E_ref"],
        "E_abs_err": e_err, "best_epoch": out["best_epoch"], "epochs": 10000, "wall_s": wall,
        "steps_per_s": out["result"].timing["steps_per_s"], "launches": counts,
        "acceptance_best_mse": 3.731924991257074e-09, "acceptance_E_abs_err": 1.56e-06,
        "target": "best_mse <= 1e-6; E_abs_err <= 1e-4",
        "pass": bool(out["L2"] <= 1e-6 and e_err <= 1e-4)})
    targets = {"PINN": (1e-6, 1e-4), "DRM": (1e-6, 1e-4), "WAN": (1e-6, 1e-3)}
    acceptance = {"PINN": (5.757583920740217e-08, 8.391216397285461e-06),
                  "DRM": (5.70526346166389e-08, 5.1567330956459045e-06),
                  "WAN": (7.600196028079154e-08, 0.000269436277449131)}
    dense, counts, wall = _run_counted(run_compare, KHCompareConfig(
        n_max=1, epochs=5000, data_fraction=0.5, max_data_points=500, jet_impl=route))
    for row in dense:
        m = row["method"]
        l2_t, e_t = targets[m]
        e_err = abs(row["E_est"] - row["E_ref"])
        record(f"kh1d_alpha10_{m.lower()}_dense", {
            "dense_L2": row["L2_error_dense"], "E_est": row["E_est"], "E_ref": row["E_ref"],
            "E_abs_err": e_err, "best_epoch": row["best_epoch"], "epochs": 5000,
            "wall_s": row["elapsed_time_sec"], "acceptance_dense_L2": acceptance[m][0],
            "acceptance_E_abs_err": acceptance[m][1],
            "target": f"dense_L2 <= {l2_t}; E_abs_err <= {e_t}",
            "pass": bool(row["L2_error_dense"] <= l2_t and e_err <= e_t)})
    emit({"phase": "full_summary", "route": route, "launches_dense": counts,
          "pass": {r["name"]: r["pass"] for r in rows}})
    if not all(r["pass"] for r in rows):
        raise SystemExit("full: a row missed its ACCEPTANCE.json target (reported above)")


def _on_card(*tensors):
    return all(t.device.type == "cuda" for t in tensors)


# the JAX package's own end-to-end configurations and bars
# (tests/test_subspace.py): name -> (config, bars)
SUBSPACE_RUNS = {
    "ipw1d_k3": (dict(problem="ipw", k=3, x_max=1.0, epochs=2500, width=48, depth=3,
                      grid_n=300, eval_grid_n=1000, chunk=500),
                 {"max_eig_rel_err": 2e-2, "max_state_rel_l2": 0.15}),
    "qho1d_k3": (dict(problem="qho", k=3, x_max=6.0, epochs=3000, width=48, depth=3,
                      grid_n=300, eval_grid_n=1000, chunk=500),
                 {"max_eig_rel_err": 2e-2, "max_state_rel_l2": 0.15}),
    "kh_k4": (dict(problem="kh", k=4, x_max=10.0, alpha=10.0, epochs=3000, width=48, depth=3,
                   grid_n=400, eval_grid_n=1200, fd_grid_n=4000, chunk=500),
              {"max_eig_abs_err": 2e-2, "max_state_rel_l2": 0.2}),
    "ipw2d_k3": (dict(problem="ipw", dim=2, k=3, x_max=1.0, epochs=2500, grid_n=48,
                      eval_grid_n=96, width=32, depth=3),
                 {"max_eig_rel_err": 5e-2, "max_subspace_sin": 0.2}),
}


def _subspace_row(out):
    """The report's numbers, with the largest absolute eigenvalue error."""
    row = {k: out[k] for k in ("eigenvalues", "exact", "max_eig_rel_err", "best_epoch",
                               "best_sum_lambda") if k in out}
    row["max_eig_abs_err"] = float(max(out["eig_abs_err"]))
    for k in ("max_state_rel_l2", "max_subspace_sin", "subspace_groups"):
        if k in out:
            row[k] = out[k]
    row["steps_per_s"] = out["timing"]["steps_per_s"]
    return row


def _subspace_task(name, seed):
    """One seed of a SUBSPACE_RUNS configuration, in a worker process: the
    report's numbers, wall seconds, launch counts, and whether the result
    is finite and its tensors lived on the card."""
    from nnpde_tpu_torch.problems.subspace import SubspaceConfig, train_subspace

    kw = SUBSPACE_RUNS[name][0]
    out, counts, wall = _run_counted(train_subspace, SubspaceConfig(**kw, seed=seed))
    row = _subspace_row(out)
    row.update(seed=seed, wall_s=wall, launches=counts, finite=_finite(out),
               on_card=_on_card(*(t for pair in out["best_params"] for t in pair)))
    return row


def _pool_map(jobs, workers=6):
    """``{key: fn(*args)}`` for ``jobs = {key: (fn, args)}`` over worker
    processes (spawned, each reaching the card itself; the paths they run
    are host-bound, so they overlap on one card), every worker joined on
    return."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from nnpde_tpu_torch import native

    native.load()                      # build the FD eigensolver once, before the workers
    with ProcessPoolExecutor(max_workers=min(len(jobs), workers),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {key: pool.submit(fn, *args) for key, (fn, args) in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


def phase_subspace_path(with_floquet=False, extra=None):
    """``train_subspace`` at the JAX package's end-to-end test
    configurations (SUBSPACE_RUNS: ipw and qho k = 3 at width 48 on 300
    points, the KH well k = 4 against its 4000-point FD truth, the 2D well k
    = 3 on 48 x 48), from the JAX package's initial weights for seed 0 as
    its tests start, one worker process each (``_pool_map``).  Gates: the
    tests' bars; the eigenvalues ascending and distinct; the variational
    bound (the sum of the reported eigenvalues >= (1 - 5e-3) x the exact
    sum; KH: each level above its FD one less 1e-4); finite; the tensors on
    the card; no kernel launched (the channel jet is the recurrence only).
    The bound is read on the dense report grid: the trace on the training
    grid (``best_sum_lambda``) carries that grid's quadrature bias, -2/(n+1)
    on the box's n interior points (-0.66% for ipw at 300, beyond the
    bound's slack once converged).  With ``with_floquet`` the Floquet
    group's run (``_floquet_task``) joins the pool; its row is returned for
    :func:`phase_floquet_path` to gate.  ``extra``: other groups' jobs
    (``cli_jobs``) that join the pool; their results are returned too."""
    report, ok = {"phase": "subspace_path", "runs": {}}, True
    t_group = time.time()
    jobs = {name: (_subspace_task, (name, 0)) for name in SUBSPACE_RUNS}
    if with_floquet:
        jobs["floquet"] = (_floquet_task, ())
    jobs.update(extra or {})
    results = _pool_map(jobs, workers=8)
    for name, (kw, bars) in SUBSPACE_RUNS.items():
        row = results[name]
        lam, exact = row["eigenvalues"], row["exact"]
        row["ok"] = bool(
            all(row[k] < bar for k, bar in bars.items())
            and all(lam[i] < lam[i + 1] for i in range(len(lam) - 1))
            and sum(lam) >= sum(exact) * (1 - 5e-3)
            and (kw["problem"] != "kh" or all(lv > e - 1e-4 for lv, e in zip(lam, exact)))
            and row["finite"] and row["on_card"] and row["launches"] == {})
        report["runs"][name] = dict(row, epochs=kw["epochs"], bars=bars)
        ok = ok and row["ok"]
    report["training_s"] = time.time() - t_group
    report["ok"] = bool(ok)
    emit(report)
    if not ok:
        raise SystemExit("subspace path check failed")
    return ({name: run["steps_per_s"] for name, run in report["runs"].items()},
            results.get("floquet"), {k: results[k] for k in extra or {}})


def phase_subspace_seeds(only=None):
    """The seed-to-seed spread of SUBSPACE_RUNS on the card (``python3
    chip_smoke.py subspace_seeds [--rows=NAME,...]``, only when named):
    each configuration from the JAX package's initial weights for seeds 0-9
    in the worker pool, with each seed's bar metrics and how many seeds meet
    every bar.  Reported, not gated."""
    names = [n for n in SUBSPACE_RUNS if only is None or n in only]
    results = _pool_map({(n, seed): (_subspace_task, (n, seed))
                         for n in names for seed in range(10)})
    for name in names:
        bars = SUBSPACE_RUNS[name][1]
        rows = [{k: results[(name, seed)][k] for k in ("seed", *bars, "steps_per_s")}
                for seed in range(10)]
        emit({"phase": "subspace_seeds", "name": name, "bars": bars, "by_seed": rows,
              "seeds_within_bars": sum(all(r[k] < b for k, b in bars.items()) for r in rows)})


FLOQUET_SHORT = dict(epochs=1200, chunk=400, train_n=384, n_ref=800, M=2, seed=0)


def _floquet_task():
    """The Floquet group's run (FLOQUET_SHORT) and its gate, as a row."""
    from nnpde_tpu_torch.problems import KHFloquetConfig, train_kh_floquet

    cfg = KHFloquetConfig(**FLOQUET_SHORT)
    out, counts, wall = _run_counted(train_kh_floquet, cfg)
    h, w = out["history"], np.asarray(out["harmonic_weights"])
    eps_err = abs(out["eps_est"] - out["eps_ref"])
    best = out["result"].best_params
    row = {"phase": "floquet_path", **FLOQUET_SHORT, "l2_first": float(h["l2"][0]),
           "l2_last": float(h["l2"][-1]), "rel_l2": out["rel_l2"], "mse": out["mse"],
           "eps_est": out["eps_est"], "eps_ref": out["eps_ref"], "eps_avg": out["eps_avg"],
           "eps_abs_err": eps_err, "harmonic_weights": w.tolist(),
           "best_epoch": out["best_epoch"], "wall_s": wall,
           "steps_per_s": out["result"].timing["steps_per_s"], "launches": counts}
    row["ok"] = bool(_finite(out) and h["l2"][-1] < 0.05 * h["l2"][0] and out["rel_l2"] < 0.2
                     and eps_err < 5e-3 and w[cfg.M] > 0.5 and abs(w.sum() - 1.0) <= 1e-6
                     and counts == {} and _on_card(best["E"], out["gt"].x,
                                                   *(t for pr in best["net"] for t in pr)))
    return row


def phase_floquet_path(row=None):
    """``train_kh_floquet`` at the JAX package's short-training
    configuration (FLOQUET_SHORT: M = 2, 384 points, 1200 epochs) with that
    test's gates (tests/test_kh_floquet.py): the last eval below 0.05 x the
    first, rel_l2 < 0.2, |eps - eps_ref| < 5e-3, the m = 0 harmonic's weight
    above 0.5, the weights summing to 1 within 1e-6; its tensors on the card
    and no kernel launched.  ``row``: the run made in the subspace group's
    pool, else it runs here."""
    row = row if row is not None else _floquet_task()
    emit(row)
    if not row["ok"]:
        raise SystemExit("Floquet path check failed")
    return row["steps_per_s"]


# the acceptance rows (scripts/acceptance.py): name -> (config, JAX's recorded
# numbers in ACCEPTANCE.json, the target)
SUBSPACE_FULL = {
    "subspace_qho1d_k6": (
        dict(problem="qho", k=6, x_max=7.0, epochs=8000, width=64, depth=3, grid_n=600,
             eval_grid_n=3000, chunk=1000),
        {"max_eig_rel_err": 0.003768414288050805, "max_state_rel_l2": 0.032072015869627386},
        {"max_eig_rel_err": 5e-3, "max_state_rel_l2": 5e-2}),
    "subspace_ipw1d_k4": (
        dict(problem="ipw", k=4, x_max=1.0, epochs=8000, width=64, depth=3, grid_n=600,
             eval_grid_n=3000, chunk=1000),
        {"max_eig_rel_err": 0.0011160642768562672, "max_state_rel_l2": 0.017632187376052936},
        {"max_eig_rel_err": 5e-3, "max_state_rel_l2": 5e-2}),
    "subspace_qho2d_k6": (
        dict(problem="qho", dim=2, k=6, x_max=6.0, epochs=12000, width=96, depth=3,
             grid_n=120, eval_grid_n=300, chunk=500),
        {"max_eig_rel_err": 0.0013761655119161748, "max_subspace_sin": 0.017442746619425385},
        {"max_eig_rel_err": 1e-2, "max_subspace_sin": 5e-2}),
    "subspace_kh_k4": (
        dict(problem="kh", k=4, x_max=10.0, alpha=10.0, epochs=20000, width=64, depth=3,
             grid_n=800, eval_grid_n=4000, fd_grid_n=20000, chunk=1000),
        {"max_eig_abs_err": 0.0002329905185491643, "max_state_rel_l2": 0.01240099683284145},
        {"max_eig_abs_err": 2e-3, "max_state_rel_l2": 5e-2}),
}
FLOQUET_FULL = {
    "kh_floquet_n0_pinn": (dict(n=0), {"rel_l2": 0.005393134468997009,
                                       "eps_abs_err": 4.3585896492004395e-07,
                                       "cycle_avg_gap": 0.0010312093375734119}),
    "kh_floquet_n1_pinn": (dict(n=1), {"rel_l2": 0.006001827621587691,
                                       "eps_abs_err": 9.609851986169815e-06,
                                       "cycle_avg_gap": 0.00030020097105172474}),
    "kh_floquet_a4_w03_n0_pinn": (dict(n=0, alpha=4.0, omega=0.3, M=3),
                                  {"rel_l2": 0.006433605693995072,
                                   "eps_abs_err": 3.1832605600357056e-06,
                                   "cycle_avg_gap": 0.0007385670423235846}),
    "kh_floquet_a4_w03_n1_pinn": (dict(n=1, alpha=4.0, omega=0.3, M=3),
                                  {"rel_l2": 0.0077146422248619345,
                                   "eps_abs_err": 1.8461141735315323e-05,
                                   "cycle_avg_gap": 0.0011742313603280421}),
}


def phase_subspace_full(only=None):
    """The four subspace acceptance rows at full length (``python3
    chip_smoke.py subspace_full [--rows=NAME,...]``, not in the default
    run), each against its ACCEPTANCE.json target beside the JAX package's
    recorded numbers.  A miss is reported (``pass`` false); returns whether
    every row passed (the run exits non-zero after both full groups)."""
    from nnpde_tpu_torch.problems.subspace import SubspaceConfig, train_subspace

    passed = {}
    for name, (kw, jax_rec, target) in SUBSPACE_FULL.items():
        if only is not None and name not in only:
            continue
        out, counts, wall = _run_counted(train_subspace, SubspaceConfig(**kw))
        row = _subspace_row(out)
        row.update(name=name, epochs=kw["epochs"], wall_s=wall, launches=counts,
                   acceptance=jax_rec, target=" AND ".join(f"{k} <= {v}"
                                                          for k, v in target.items()))
        row["pass"] = bool(_finite(out) and all(row[k] <= v for k, v in target.items()))
        passed[name] = row["pass"]
        emit(dict(phase="subspace_full", **row))
    emit({"phase": "subspace_full_summary", "pass": passed})
    return all(passed.values())


def phase_floquet_full(only=None):
    """The four Floquet acceptance rows at full length (``python3
    chip_smoke.py floquet_full [--rows=NAME,...]``, not in the default run;
    20000 epochs each), each against its ACCEPTANCE.json target (rel_l2 <=
    1e-2 and |eps - eps_ref| <= 0.1 x the cycle-average gap) beside the JAX
    package's recorded numbers.  A miss is reported; returns whether every
    row passed."""
    from nnpde_tpu_torch.problems import KHFloquetConfig, train_kh_floquet

    passed = {}
    for name, (kw, jax_rec) in FLOQUET_FULL.items():
        if only is not None and name not in only:
            continue
        out, counts, wall = _run_counted(train_kh_floquet,
                                         KHFloquetConfig(epochs=20000, chunk=1000, **kw))
        e_err = abs(out["eps_est"] - out["eps_ref"])
        gap = abs(out["eps_avg"] - out["eps_ref"])
        row = {"name": name, **kw, "rel_l2": out["rel_l2"], "best_epoch": out["best_epoch"],
               "eps_est": out["eps_est"], "eps_ref": out["eps_ref"], "eps_avg": out["eps_avg"],
               "eps_abs_err": e_err, "cycle_avg_gap": gap,
               "harmonic_weights": out["harmonic_weights"], "epochs": 20000, "wall_s": wall,
               "steps_per_s": out["result"].timing["steps_per_s"], "launches": counts,
               "acceptance": jax_rec,
               "target": "rel_l2 <= 1e-2; eps_abs_err <= 0.1 * cycle_avg_gap",
               "pass": bool(_finite(out) and out["rel_l2"] <= 1e-2 and e_err <= 0.1 * gap)}
        passed[name] = row["pass"]
        emit(dict(phase="floquet_full", **row))
    emit({"phase": "floquet_full_summary", "pass": passed})
    return all(passed.values())


# ------------------------------------------------------------------ cli
# the main path's fused configuration (phase_main_path) through the command
# line; the CLI's defaults are PoissonConfig's (width 64, depth 5, 20000
# points, 4000 boundary points, lr 1e-3, seed 0)
CLI_MAIN = ["poisson", "--dim", "2", "--method", "PINN", "--bc-mode", "FBC", "--jet-impl",
            "fused", "--epochs", "3000", "--chunk", "1000", "--n-interior", "20000"]
CLI_IPW1D = ["ipw1d", "--method", "DRM", "--jet-impl", "fused", "--epochs", "300"]
CLI_SWEEP = ["sweep", "ipw1d", "--n-values", "1", "--epochs", "50", "--chunk", "50"]
CLI_SUBPROCESS = ["poisson", "--epochs", "200"]
CLI_EPOCHS = {"main": 3000, "ipw1d": 300}


def _poisson_checkpoint_rel_l2(ckpt, min_epoch, seed=0, n_eval=10000, dim=2, L=2.0):
    """The 2D Poisson run's rel_l2 again from its checkpoint, reloaded
    through the registry onto the card: the eval of ``train_poisson_nd`` at
    the best epoch (its n_eval uniform points from that epoch's key) over
    the manufactured solution's rms."""
    from nnpde_tpu_torch.exp.plotting import load_checkpoint_model
    from nnpde_tpu_torch.pde import poisson
    from nnpde_tpu_torch.pde.domain import Box
    from nnpde_tpu_torch.prng import fold_in, generator, split
    from nnpde_tpu_torch.sampling import uniform_box

    dev = torch.device("cuda")
    model, params, meta = load_checkpoint_model(ckpt, device=dev)
    k_train = split(seed, 4)[3]
    X = uniform_box(generator(fold_in(fold_in(k_train, min_epoch), 0x5EED), dev), n_eval,
                    Box.cube(dim, 0.0, L))
    with torch.no_grad():
        u = model.apply_batch(params, X)
        rmse = torch.sqrt(torch.mean((u - poisson.exact_u_prod_sin(X, L, [1] * dim)) ** 2))
    return float(rmse) / 0.5 ** (dim / 2.0), meta


def _cli_task(name, argv):
    """``cli.main(argv)`` in a worker process with a fresh save directory
    and the counts set to 0 just before: (printed rows, ledger rows, counts,
    wall seconds, and what the group checks of the files before they go)."""
    import contextlib
    import glob
    import io
    import tempfile

    from nnpde_tpu_torch.exp import cli
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches

    with tempfile.TemporaryDirectory() as d:
        buf = io.StringIO()
        reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + ["--save-dir", d])
        wall = time.time() - t0
        counts = {k: v for k, v in LAUNCHES.items() if v}
        printed = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
        ledger = [r for f in sorted(glob.glob(os.path.join(d, "results_*.json")))
                  for r in json.load(open(f))]
        row = {"argv": argv, "rc": rc, "wall_s": wall, "launches": counts,
               "printed": printed, "ledger_rows": len(ledger),
               "files": len(os.listdir(d)), "plots": len(glob.glob(os.path.join(d, "*.png")))}
        if name == "main":
            r = ledger[0]
            row["rel_l2"] = r["L2_error"] / 0.5
            row["reload_rel_l2"], meta = _poisson_checkpoint_rel_l2(r["best_model_path"],
                                                                     r["min_epoch"])
            row["meta_problem"] = meta["problem"]
            row["best_epoch"] = r["min_epoch"]
        if name == "ipw1d":
            l2 = np.load(ledger[0]["L2_errors"])
            row.update(best=ledger[0]["L2_error"], first=float(l2[0]),
                       finite=bool(np.all(np.isfinite(l2))))
        if name == "sweep":
            row["finite"] = all(math.isfinite(r["L2_error"]) for r in ledger)
    return row


def _cli_subprocess_task():
    """``python -m nnpde_tpu_torch.exp.cli poisson --epochs 200`` in a
    process of its own, then ``results_process`` on the ledger it wrote."""
    import tempfile

    from nnpde_tpu_torch.exp.results_process import results_to_csv

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        r = subprocess.run([sys.executable, "-m", "nnpde_tpu_torch.exp.cli", *CLI_SUBPROCESS,
                            "--save-dir", d], cwd=root, capture_output=True, text=True,
                           timeout=600)
        wall = time.time() - t0
        ledger = os.path.join(d, "results_poisson_nd.json")
        csv = open(results_to_csv(ledger)).read().splitlines() if os.path.exists(ledger) else []
    last = r.stdout.strip().splitlines()[-1:] or [""]
    return {"argv": CLI_SUBPROCESS, "rc": r.returncode, "wall_s": wall,
            "printed": last[0][:300], "csv_lines": len(csv), "csv_header": csv[:1],
            "stderr_tail": r.stderr[-2000:] if r.returncode else ""}


def _main_fused_task():
    """The main path's fused run, for a ``cli`` group run without ``main``."""
    from nnpde_tpu_torch.problems import PoissonConfig, train_poisson_nd

    out = train_poisson_nd(PoissonConfig(dim=2, method="PINN", bc_mode="FBC", epochs=3000,
                                         n_interior=20000, chunk=1000, jet_impl="fused"))
    return {"rel_l2": out["rel_l2"]}


def cli_jobs():
    """The cli group's runs, for the worker pool (``_pool_map``)."""
    jobs = {("cli", "main"): (_cli_task, ("main", CLI_MAIN)),
            ("cli", "ipw1d"): (_cli_task, ("ipw1d", CLI_IPW1D)),
            ("cli", "sweep"): (_cli_task, ("sweep", CLI_SWEEP)),
            ("cli", "subprocess"): (_cli_subprocess_task, ())}
    if "rel_l2" not in MAIN_FUSED:
        jobs[("cli", "reference")] = (_main_fused_task, ())
    return jobs


def phase_cli(results):
    """The command line, ``python -m nnpde_tpu_torch.exp.cli``, as a user
    starts the system (README), each run in a worker process of the pool:

    * the main path's fused configuration (CLI_MAIN: 2D Poisson PINN, FBC,
      20000 points, 3000 epochs, chunk 1000, seed 0): exactly 3000
      fused_linear_residual launches; the persisted rel_l2 (``L2_error``
      over the solution's rms) equal to the main path phase's fused
      rel_l2 (the kernels repeat bitwise, so the gate is equality, with
      1e-6 relative as the stated fallback); the best checkpoint reloaded
      through the registry onto the card reproduces it within 1e-6;
    * ``ipw1d --method DRM --jet-impl fused`` (300 of 3000 epochs, u50):
      exactly 300 quad_sums and 300 quad_seeded launches (rows 9 and 10 at
      d = 1), the best eval below the first, finite;
    * ``sweep ipw1d --n-values 1 --epochs 50 --chunk 50``: 8 rows printed
      and in the ledger, finite, no kernel (the torch route);
    * ``python -m nnpde_tpu_torch.exp.cli poisson --epochs 200`` as a
      process of its own: exit 0, and ``results_process`` writes a CSV of
      its one ledger row.
    No run draws a plot."""
    ref = MAIN_FUSED.get("rel_l2", results.get(("cli", "reference"), {}).get("rel_l2"))
    main, ipw, sweep, sub = (results[("cli", k)] for k in
                             ("main", "ipw1d", "sweep", "subprocess"))
    main["main_path_rel_l2"] = ref
    main["bitwise"] = main["rel_l2"] == ref
    main["rel_diff"] = abs(main["rel_l2"] - ref) / ref
    main["reload_rel_diff"] = abs(main["reload_rel_l2"] - main["rel_l2"]) / main["rel_l2"]
    main["ok"] = bool(main["rc"] == 0
                      and main["launches"] == {"fused_linear_residual": CLI_EPOCHS["main"]}
                      and main["rel_diff"] <= 1e-6 and main["reload_rel_diff"] <= 1e-6
                      and main["meta_problem"] == "poisson_nd" and main["plots"] == 0)
    ipw["ok"] = bool(ipw["rc"] == 0 and ipw["finite"] and ipw["best"] < ipw["first"]
                     and ipw["launches"] == {"quad_sums": CLI_EPOCHS["ipw1d"],
                                             "quad_seeded": CLI_EPOCHS["ipw1d"]}
                     and ipw["plots"] == 0)
    sweep["ok"] = bool(sweep["rc"] == 0 and len(sweep["printed"]) == 8
                       and sweep["ledger_rows"] == 8 and sweep["finite"]
                       and sweep["launches"] == {} and sweep["plots"] == 0)
    sub["ok"] = bool(sub["rc"] == 0 and sub["csv_lines"] == 2)
    report = {"phase": "cli", "runs": {"main": main, "ipw1d": ipw, "sweep": sweep,
                                       "subprocess": sub}}
    report["ok"] = all(r["ok"] for r in report["runs"].values())
    emit(report)
    if not report["ok"]:
        raise SystemExit("cli check failed")
    return {"main": main["launches"], "ipw1d": ipw["launches"]}


# ------------------------------------------------------------- parallel
PAR_N = 20000
PAR_ADAM = 100
PAR_STEP_LAUNCHES = {"fused_linear_residual": 1, "fused_drm_energy": 1, "quad_sums": 1,
                     "quad_seeded": 1, "linear_sums": 2, "linear_seeded": 2}


def _par_inputs(dev):
    """The main path's shapes (u64 and the critic c64, 20000 points), from
    one seed in every process: the parameters, the points and each step's
    coefficient streams."""
    from nnpde_tpu_torch.kernels import (drm_coefficients, linear_functional_coefficients,
                                         quotient_coefficients, residual_coefficients)
    from nnpde_tpu_torch.models import factor_for_technique
    from nnpde_tpu_torch.pde import poisson

    rng = np.random.default_rng(29)
    u, c = rand_params(rng, LAYERS, dev), rand_params(rng, CRITIC, dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    X = t(rng.uniform(0.0, L, (PAR_N, 2)))
    phi, u_dat = t(rng.normal(size=PAR_N)), t(rng.normal(size=PAR_N))
    gphi, gu = t(rng.normal(size=(PAR_N, 2))), t(rng.normal(size=(PAR_N, 2)))
    B = factor_for_technique("FBC", dim=2, kind="box", L=L).jet(X)
    f = poisson.rhs_f_for_u_sin(X, L, [1, 1])
    V = 0.3 * torch.sum(X ** 2, dim=1)
    return {"u": u, "c": c, "X": X, "phi": phi,
            "coef_pinn": residual_coefficients(B, a0=-1.0, rhs=-f),
            "coef_drm": drm_coefficients(B, f),
            "coef_ray": quotient_coefficients(B, V=0.5 * torch.sum(X ** 2, dim=1)),
            "base": linear_functional_coefficients(B, c0=V * phi, b0=0.5 * gphi, e1=B.value,
                                                   e2=B.value * phi),
            "coef_v": linear_functional_coefficients(B, c0=(V - 2.1) * u_dat, b0=0.5 * gu,
                                                     e1=B.value)}


def _par_steps(mesh, inp):
    """Every data-parallel step of ``nnpde_tpu_torch.parallel`` on this
    process's shards: name -> (value, gradient pairs, sums)."""
    from nnpde_tpu_torch.parallel import (fused_rayleigh_step, fused_residual_step,
                                          fused_wan_u_step, fused_wan_v_step, shard_batch)

    def sh(k):
        return shard_batch(inp[k], mesh)

    X, out = sh("X"), {}
    for kind in ("pinn", "drm"):
        loss, sums, g = fused_residual_step(mesh, "sin", kind=kind)(inp["u"], X,
                                                                   sh(f"coef_{kind}"))
        out[f"fused_{kind}"] = (loss, g, sums)
    loss, aux, g = fused_rayleigh_step(mesh, "sin", weight=3.0, den_eps=1e-8)(
        inp["u"], X, sh("coef_ray"))
    out["rayleigh"] = (loss, g, aux)
    loss, aux, g, dE = fused_wan_u_step(mesh, "sin", vol=4.0, w_pde=10.0, w_norm=100.0)(
        inp["u"], 2.1, X, sh("base"), sh("phi"))
    out["wan_u"] = (loss, g, dict(aux, dE=dE))
    loss, aux, g = fused_wan_v_step(mesh, "sin")(inp["c"], X, sh("coef_v"))
    out["wan_v"] = (loss, g, aux)
    return out


def _par_direct(inp):
    """The same objectives by direct kernel calls on the whole batch."""
    from nnpde_tpu_torch.kernels import (fused_drm_energy, fused_linear_residual,
                                         make_fused_rayleigh, make_fused_wan_u,
                                         make_fused_wan_v)

    def grad_of(obj, params, *args, extra=()):
        leaves = [t.clone().requires_grad_(True) for pair in params for t in pair]
        xs = [torch.as_tensor(e, dtype=torch.float32, device=inp["X"].device)
              .requires_grad_(True) for e in extra]
        val, aux = obj([(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)],
                       *xs, *args)
        g = torch.autograd.grad(val, leaves + xs)
        pairs = [(g[i], g[i + 1]) for i in range(0, len(leaves), 2)]
        return val.detach(), pairs, aux, g[len(leaves):]

    X, out = inp["X"], {}
    loss, aux, g = fused_linear_residual(inp["u"], X, inp["coef_pinn"], "sin")
    out["fused_pinn"] = (loss, g, {k: v for k, v in aux.items() if k != "n"})
    loss, aux, g = fused_drm_energy(inp["u"], X, inp["coef_drm"], "sin")
    out["fused_drm"] = (loss, g, {k: v for k, v in aux.items() if k != "n"})
    val, g, aux, _ = grad_of(make_fused_rayleigh("sin", weight=3.0, den_eps=1e-8), inp["u"], X,
                             inp["coef_ray"])
    out["rayleigh"] = (val, g, aux)
    pn = torch.mean(inp["phi"] ** 2)
    wan_u = make_fused_wan_u("sin", vol=4.0, w_pde=10.0, w_norm=100.0)
    val, g, aux, (dE,) = grad_of(lambda p, E, X_, b: wan_u(p, E, X_, b, pn), inp["u"], X,
                                 inp["base"], extra=(2.1,))
    out["wan_u"] = (val, g, dict(aux, dE=dE))
    val, g, aux, _ = grad_of(make_fused_wan_v("sin"), inp["c"], X, inp["coef_v"])
    out["wan_v"] = (val, g, aux)
    return out


def _par_adam(mesh, inp, steps=PAR_ADAM, untimed=10):
    """``steps`` Adam steps (lr 1e-3) of the fused PINN step on this
    process's shard: (final parameters, steps per second over the steps
    after the first ``untimed``, which take the first calls' set-up)."""
    from nnpde_tpu_torch.parallel import fused_residual_step, replicate, shard_batch

    step = fused_residual_step(mesh, "sin")
    ps = replicate(inp["u"], mesh)
    X, coef = shard_batch(inp["X"], mesh), shard_batch(inp["coef_pinn"], mesh)
    leaves = [t for pair in ps for t in pair]
    opt = torch.optim.Adam(leaves, lr=1e-3)
    for i in range(steps):
        if i == untimed:
            torch.cuda.synchronize()
            t0 = time.time()
        _, _, grads = step(ps, X, coef)
        for t, g in zip(leaves, [g for pair in grads for g in pair]):
            t.grad = g
        opt.step()
    torch.cuda.synchronize()
    return ps, (steps - untimed) / (time.time() - t0)


def _host_tree(res):
    """name -> (value, grads, sums) of tensors as numpy arrays."""
    return {name: (v.detach().cpu().numpy(), [(a.cpu().numpy(), b.cpu().numpy()) for a, b in g],
                   {k: torch.as_tensor(x).detach().cpu().numpy() for k, x in s.items()})
            for name, (v, g, s) in res.items()}


def _parallel_rank(rank, world, workdir):
    """One gloo rank on cuda:0 (every rank shares the card): the steps on
    its share of the batch, then PAR_ADAM Adam steps of the fused PINN step;
    writes ``rank{rank}.json`` and ``rank{rank}.npz`` into ``workdir``."""
    import datetime

    import torch.distributed as dist

    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(device=dev)
        inp = _par_inputs(dev)
        reset_launches()
        res = _host_tree(_par_steps(mesh, inp))
        counts = {k: v for k, v in LAUNCHES.items() if v}
        params, rate = _par_adam(mesh, inp)
        arrays = {f"p{i}": t.cpu().numpy() for i, t in enumerate(t for pr in params for t in pr)}
        for name, (v, g, s) in res.items():
            arrays[f"{name}/value"] = v
            for i, (a, b) in enumerate(g):
                arrays[f"{name}/gW{i}"], arrays[f"{name}/gb{i}"] = a, b
            for k, x in s.items():
                arrays[f"{name}/sum/{k}"] = x
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
            json.dump({"launches": counts, "adam_steps_per_s": rate,
                       "launches_total": {k: v for k, v in LAUNCHES.items() if v}}, fh)
    finally:
        dist.destroy_process_group()


def _np_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tp_inputs(dev):
    """The main path's PINN at full width (u64 with the box-FBC factor, the
    JAX package's initial weights for seed 0) and PAR_N points."""
    from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique

    model = SolutionModel(NetSpec(LAYERS, "sin"),
                          factor_for_technique("FBC", dim=2, kind="box", L=L))
    X = np.random.default_rng(31).uniform(0.0, L, (PAR_N, 2)).astype(np.float32)
    return model, model.init(0, device=dev), torch.as_tensor(X, device=dev)


def _tp_pinn(jet_of):
    """The Poisson PINN loss on the jet ``jet_of(params, X)``."""
    from nnpde_tpu_torch.losses import pinn_poisson
    from nnpde_tpu_torch.pde import poisson

    def loss(p, X):
        return pinn_poisson(jet_of(p, X).lap, poisson.rhs_f_for_u_sin(X, L, [1, 1]))

    return loss


def _tp_adam(step, leaves, rebuild, X, steps=PAR_ADAM, untimed=10):
    """``steps`` Adam steps (lr 1e-3) of ``step(params, X) -> (loss,
    grads)`` on ``leaves``: (the first loss and gradient leaves, the final
    leaves, steps per second past the first ``untimed``)."""
    opt = torch.optim.Adam(leaves, lr=1e-3)
    first = None
    for i in range(steps):
        if i == untimed:
            torch.cuda.synchronize()
            t0 = time.time()
        loss, grads = step(rebuild(leaves), X)
        g = [t for pair in grads for t in pair]
        if first is None:
            first = (loss.detach().clone(), [t.clone() for t in g])
        for t, gr in zip(leaves, g):
            t.grad = gr
        opt.step()
    torch.cuda.synchronize()
    return first, leaves, (steps - untimed) / (time.time() - t0)


def _tp_rank(rank, world, workdir):
    """One gloo rank on cuda:0 of a (data 1, model 2) mesh: the PINN loss
    through the TP jet, its gradients, PAR_ADAM Adam steps on this rank's
    parts; writes ``tp{rank}.json`` and ``tp{rank}.npz`` into ``workdir``."""
    import datetime

    import torch.distributed as dist

    from nnpde_tpu_torch.parallel import make_mesh_2d, tp_fields, tp_mean_step, tp_shard_mlp
    from nnpde_tpu_torch.parallel.mesh import TPLayer

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh_2d(1, world, device=dev)
        model, P, X = _tp_inputs(dev)
        parts = tp_shard_mlp(P, mesh)
        kinds = [p.kind for p in parts]
        step = tp_mean_step(_tp_pinn(lambda lay, X_: tp_fields(model, lay, X_, mesh)), mesh)
        (loss, grads), leaves, rate = _tp_adam(
            step, [t.clone() for p in parts for t in (p.W, p.b)],
            lambda lv: [TPLayer(lv[2 * i], lv[2 * i + 1], k) for i, k in enumerate(kinds)], X)
        arrays = {"loss": loss.cpu().numpy()}
        for i, (g, t) in enumerate(zip(grads, leaves)):
            arrays[f"g{i}"], arrays[f"p{i}"] = g.cpu().numpy(), t.cpu().numpy()
        np.savez(os.path.join(workdir, f"tp{rank}.npz"), **arrays)
        with open(os.path.join(workdir, f"tp{rank}.json"), "w") as fh:
            json.dump({"kinds": kinds, "model_index": mesh.axis_index("model"),
                       "adam_steps_per_s": rate}, fh)
    finally:
        dist.destroy_process_group()


def _tp_part(a, kind, j, n=2):
    """Rank ``j``'s part of a whole leaf under a TP layer ``kind``."""
    if kind == "col":
        m = a.shape[-1] // n
        return a[..., j * m:(j + 1) * m]
    if kind == "row" and a.ndim == 2:
        return a[j * (a.shape[0] // n):(j + 1) * (a.shape[0] // n)]
    return a


def phase_parallel_tp():
    """Tensor parallelism through the jet at the main path's full width
    (u64, box-FBC, PAR_N points): on an NCCL world of one the TP jet, the
    model's jet through it and the dp x tp step bitwise equal to the plain
    jet, ``SolutionModel.fields`` and ``psum_mean_step``; on two gloo ranks
    sharing cuda:0 (tp = 2) the PINN loss, each rank's gradient parts and
    its parts after PAR_ADAM Adam steps within 1e-5 (relative) of one
    process's whole net; Adam steps/s per rank beside one process's
    (reported).  No kernel lies on this path (the jet is the plain
    recurrence, as XLA's is in the JAX package)."""
    import datetime
    import multiprocessing
    import socket
    import tempfile

    import torch.distributed as dist

    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.ops.fwdlap import mlp_fwdlap
    from nnpde_tpu_torch.parallel import (make_mesh, make_mesh_2d, psum_mean_step, tp_fields,
                                          tp_mean_step, tp_mlp_fwdlap, tp_shard_mlp)

    dev = torch.device("cuda")
    model, P, X = _tp_inputs(dev)
    report, ok = {"phase": "parallel_tp", "N": PAR_N, "layers": list(LAYERS)}, True
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.time()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh_2d(1, 1, device="cuda")
        parts = tp_shard_mlp(P, mesh)
        reset_launches()
        jet_tp, jet = tp_mlp_fwdlap(parts, X, "sin", mesh), mlp_fwdlap(P, X, "sin")
        fields_tp, fields = tp_fields(model, parts, X, mesh), model.fields(P, X)
        l1, g1 = tp_mean_step(_tp_pinn(lambda lay, X_: tp_fields(model, lay, X_, mesh)),
                              mesh)(parts, X)
        l0, g0 = psum_mean_step(_tp_pinn(model.fields), make_mesh(device="cuda"))(P, X)
        torch.cuda.synchronize()
        bitwise = {
            "jet": all(torch.equal(a, b) for a, b in zip(jet_tp, jet)),
            "fields": all(torch.equal(a, b) for a, b in zip(fields_tp, fields)),
            "step": bool(torch.equal(l1, l0)) and all(
                torch.equal(a, b) for pa, pb in zip(g1, g0) for a, b in zip(pa, pb))}
        counts = {k: v for k, v in LAUNCHES.items() if v}
    finally:
        dist.destroy_process_group()
    report["nccl_world_of_one"] = {"bitwise": bitwise, "launches": counts,
                                   "wall_s": time.time() - t0}
    ok = ok and all(bitwise.values()) and not counts
    # one process on the whole net: the reference and its rate
    (loss1, grads1), leaves1, rate_one = _tp_adam(
        psum_mean_step(_tp_pinn(model.fields), make_mesh(device="cuda")),
        [t.clone() for pair in P for t in pair],
        lambda lv: [(lv[2 * i], lv[2 * i + 1]) for i in range(len(lv) // 2)], X)
    ctx = multiprocessing.get_context("spawn")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_tp_rank, args=(r, 2, d)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        ranks = ([(json.load(open(os.path.join(d, f"tp{r}.json"))),
                   dict(np.load(os.path.join(d, f"tp{r}.npz")))) for r in range(2)]
                 if codes == [0, 0] else [])
    two = {"exit_codes": codes, "wall_s": time.time() - t0}
    if ranks:
        ref_g = [t.cpu().numpy() for t in grads1]
        ref_p = [t.detach().cpu().numpy() for t in leaves1]
        worst = {"loss": 0.0, "grads": 0.0, "params_after_adam": 0.0}
        for meta, arr in ranks:
            j, kinds = meta["model_index"], meta["kinds"]
            worst["loss"] = max(worst["loss"], _np_rel(arr["loss"], loss1.cpu().numpy()))
            for i in range(len(ref_g)):
                kind = kinds[i // 2]
                worst["grads"] = max(worst["grads"],
                                     _np_rel(arr[f"g{i}"], _tp_part(ref_g[i], kind, j)))
                worst["params_after_adam"] = max(worst["params_after_adam"], _np_rel(
                    arr[f"p{i}"], _tp_part(ref_p[i], kind, j)))
        two.update(kinds=ranks[0][0]["kinds"], max_rel_vs_one_process=worst,
                   adam_steps=PAR_ADAM,
                   adam_steps_per_s_two_ranks=[m["adam_steps_per_s"] for m, _ in ranks],
                   adam_steps_per_s_one_process=rate_one)
        ok = ok and all(e <= 1e-5 for e in worst.values())
    else:
        ok = False
    report["two_gloo_ranks_tp"] = two
    report["ok"] = bool(ok)
    emit(report)
    if not report["ok"]:
        raise SystemExit("parallel tensor-parallel check failed")
    return {"one_process": rate_one, "two_ranks": two.get("adam_steps_per_s_two_ranks")}


def phase_parallel():
    """Data parallelism (``nnpde_tpu_torch.parallel``) on the card, at the
    main path's shapes (u64, the critic c64, 20000 points):

    * a world of one on NCCL (a process group of one rank): the fused
      residual step (pinn, drm), the Rayleigh step and the WAN u / v steps
      bitwise equal to the direct kernel calls, each step's kernels launched
      exactly (PAR_STEP_LAUNCHES);
    * two spawned gloo ranks sharing cuda:0, each running the kernels on
      half the batch: every value, gradient leaf and sum within 1e-5
      (relative) of the one process on the whole batch, and after PAR_ADAM
      Adam steps of the fused PINN step the two ranks' parameters bitwise
      equal;
    * the two-rank Adam steps/s beside the one-process rate (reported, not
      gated)."""
    import datetime
    import multiprocessing
    import socket
    import tempfile

    import torch.distributed as dist

    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda")
    inp = _par_inputs(dev)
    report, ok = {"phase": "parallel", "N": PAR_N, "layers": list(LAYERS),
                  "critic": list(CRITIC)}, True
    # a world of one on NCCL
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.time()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(device="cuda")
        reset_launches()
        res = _par_steps(mesh, inp)
        counts = {k: v for k, v in LAUNCHES.items() if v}
    finally:
        dist.destroy_process_group()
    direct = _par_direct(inp)
    bitwise = {}
    for name, (v, g, s) in res.items():
        dv, dg, ds = direct[name]
        bitwise[name] = bool(torch.equal(v, dv)
                             and all(torch.equal(a, b) for pa, pb in zip(g, dg)
                                     for a, b in zip(pa, pb))
                             and all(torch.equal(torch.as_tensor(s[k]), torch.as_tensor(ds[k]))
                                     for k in ds))
    report["nccl_world_of_one"] = {"bitwise": bitwise, "launches": counts,
                                   "wall_s": time.time() - t0}
    ok = ok and all(bitwise.values()) and counts == PAR_STEP_LAUNCHES
    # the one process on the whole batch: reference and rate
    ref = _host_tree(direct)
    _, rate_one = _par_adam(make_mesh(device="cuda"), inp)
    # two gloo ranks on cuda:0
    ctx = multiprocessing.get_context("spawn")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_parallel_rank, args=(r, 2, d)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        ranks = ([(json.load(open(os.path.join(d, f"rank{r}.json"))),
                   dict(np.load(os.path.join(d, f"rank{r}.npz")))) for r in range(2)]
                 if codes == [0, 0] else [])
    two = {"exit_codes": codes, "wall_s": time.time() - t0}
    if ranks:
        worst = {}
        for name, (v, g, s) in ref.items():
            errs = []
            for _, arr in ranks:
                errs.append(_np_rel(arr[f"{name}/value"], v))
                errs += [_np_rel(arr[f"{name}/gW{i}"], a) for i, (a, _) in enumerate(g)]
                errs += [_np_rel(arr[f"{name}/gb{i}"], b) for i, (_, b) in enumerate(g)]
                errs += [_np_rel(arr[f"{name}/sum/{k}"], x) for k, x in s.items()]
            worst[name] = max(errs)
        p0, p1 = ranks[0][1], ranks[1][1]
        same = all(np.array_equal(p0[k], p1[k]) for k in p0 if k.startswith("p"))
        want = dict(PAR_STEP_LAUNCHES, fused_linear_residual=1 + PAR_ADAM)
        two.update(max_rel_vs_one_process=worst, params_bitwise_after_adam=same,
                   adam_steps=PAR_ADAM, launches=[m["launches"] for m, _ in ranks],
                   launches_total=[m["launches_total"] for m, _ in ranks],
                   adam_steps_per_s_two_ranks=[m["adam_steps_per_s"] for m, _ in ranks],
                   adam_steps_per_s_one_process=rate_one)
        ok = ok and all(e <= 1e-5 for e in worst.values()) and same and all(
            m["launches"] == PAR_STEP_LAUNCHES and m["launches_total"] == want
            for m, _ in ranks)
    else:
        ok = False
    report["two_gloo_ranks"] = two
    report["ok"] = bool(ok)
    emit(report)
    if not report["ok"]:
        raise SystemExit("parallel check failed")
    return {"one_process": rate_one, "two_ranks": two.get("adam_steps_per_s_two_ranks"),
            "tp": phase_parallel_tp()}


# ------------------------------------------------------------- probe
PROBE_CELLS = ((300, False), (300, True), (400, False), (400, True))
PROBE_RUN_EPOCHS = 50


def _winner_cfg(grid_n, jitter):
    """``scripts/wan_mem_probe.py``'s ``winner_cfg`` (the acceptance winner
    of the 2D well's WAN: extragradient, critic (2, 100 x 3, 1), cosine
    schedule over 45000 epochs) at one quadrature grid and jitter."""
    from nnpde_tpu_torch.problems import IPW2DConfig

    return IPW2DConfig(nx=3, ny=3, method="WAN", technique="FN", epochs=45000, chunk=1000,
                       lr_schedule="cosine", minimax="extragradient", v_lr=4e-3,
                       v_layers=(2, 100, 100, 100, 1), grid_n=grid_n, grid_jitter=jitter,
                       weights={"parity": 1000.0, "symmetry": 1000.0, "norm": 1e4})


def phase_probe():
    """``train_ipw_2d(compile_only=True)``, the memory probe, at
    ``scripts/wan_mem_probe.py``'s four cells (grid 300 and 400, jitter off
    and on; 160000 points at grid 400), each beside
    ``torch.cuda.max_memory_allocated`` over PROBE_RUN_EPOCHS epochs of the
    same configuration (``run_epochs``: the same schedule): the probe's
    total within 0.98-1.02 of the run's peak and below the card's memory,
    the run's history finite.  The probe measures one epoch of the run's
    own step, so this checks that one epoch's peak is the run's (a probe
    that counted something else would show), not an analysed figure as
    JAX's probe reports."""
    import gc

    from nnpde_tpu_torch.problems import train_ipw_2d

    rows, ok = [], True
    for grid_n, jitter in PROBE_CELLS:
        cfg = _winner_cfg(grid_n, jitter)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        stats = train_ipw_2d(cfg, compile_only=True)
        probe_s = time.time() - t0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = train_ipw_2d(cfg, run_epochs=PROBE_RUN_EPOCHS)
        torch.cuda.synchronize()
        run_s, peak = time.time() - t0, int(torch.cuda.max_memory_allocated())
        del out["result"], out["model"]
        ratio = stats["total_nonalias_bytes"] / peak
        row = {"grid_n": grid_n, "grid_jitter": jitter, "points": grid_n ** 2, **stats,
               "run_epochs": PROBE_RUN_EPOCHS, "run_peak_bytes": peak, "probe_over_run": ratio,
               "fraction_of_memory": stats["total_nonalias_bytes"] / stats["device_bytes_limit"],
               "probe_s": probe_s, "run_s": run_s,
               "run_history_finite": bool(np.all(np.isfinite(out["history"]["l2"])))}
        row["ok"] = bool(0.98 <= ratio <= 1.02 and row["run_history_finite"]
                         and 0 < stats["total_nonalias_bytes"] < stats["device_bytes_limit"])
        ok = ok and row["ok"]
        rows.append(row)
    emit({"phase": "probe", "cells": rows, "ok": ok})
    if not ok:
        raise SystemExit("probe check failed")


GROUPS = ("kernels", "wan", "main", "eigen", "ipw3d", "neumann", "eigen1d", "qho2d", "kh",
          "subspace", "floquet", "cli", "parallel", "probe", "timing", "precision")
# groups that run only when named
NAMED = ("sweep", "mma_sweep", "mma_depth", "devw_sweep", "full", "subspace_full",
         "floquet_full", "subspace_seeds")
# the named groups whose rows --rows= selects by name
ROW_GROUPS = {"subspace_full": SUBSPACE_FULL, "floquet_full": FLOQUET_FULL,
              "subspace_seeds": SUBSPACE_RUNS}


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:] if a.startswith("--rows=")]
    only = set(only[-1]) if only else None
    route = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--route=")]
    route = route[-1] if route else "fused"
    want = set(args) or set(GROUPS)
    if only is not None and want != {"timing"} and not want <= set(ROW_GROUPS):
        raise SystemExit("--rows= filters the timing group (chip_smoke.py timing "
                         "--rows=KERNEL[,KERNEL...]) or the rows of subspace_full, "
                         "floquet_full and subspace_seeds (--rows=NAME[,NAME...])")
    if only is not None and want <= set(ROW_GROUPS):
        names = {n for g in want for n in ROW_GROUPS[g]}
        if not only <= names:
            raise SystemExit(f"unknown rows {sorted(only - names)}; choose from {sorted(names)}")
    if route != "fused" and want != {"full"}:
        raise SystemExit("--route= applies to the full group only: chip_smoke.py full "
                         "--route=torch")
    if not want <= set(GROUPS) | set(NAMED):
        raise SystemExit(f"unknown phase group in {sorted(want)}; choose from "
                         f"{GROUPS + NAMED}")
    full = want == set(GROUPS)
    card = phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "sweep" in want:
        phase_forward_sweep(dev)
        phase_quotient_sweep(dev)
        phase_fused_sweep(dev)
        phase_multibump_sweep(dev)
    if want & {"sweep", "mma_sweep"}:
        phase_mma_sweep(dev)
    if "mma_depth" in want:
        phase_mma_depth(dev)
    if "devw_sweep" in want:
        phase_devw_sweep(dev)
    max_err, launches, speed = {}, {}, {}
    if "kernels" in want:
        max_err.update(phase_kernels(dev))
    if "wan" in want:
        max_err.update(phase_wan_kernels(dev))
    if "eigen" in want:
        max_err.update(phase_eigen_kernels(dev))
    if "precision" in want:
        max_err.update(phase_precision_kernels(dev))
    if "ipw3d" in want:
        for kind, err in phase_ipw3d_kernels(dev).items():
            max_err[kind] = max(max_err.get(kind, 0.0), err)
    if "eigen1d" in want:
        for kind, err in phase_eigen1d_kernels(dev).items():
            max_err[kind] = max(max_err.get(kind, 0.0), err)
    if "kh" in want:
        for kind, err in phase_trainE_kernels(dev).items():
            max_err[kind] = max(max_err.get(kind, 0.0), err)
    if "main" in want:
        counts, speed["steps_per_s_fused"] = phase_main_path()
        launches.update(counts)
    if "wan" in want:
        counts, speed["wan_epochs_per_s_fused"] = phase_wan_path()
        launches.update({k: counts[k] for k in WAN_REPLACES})
    if "eigen" in want:
        counts, eigen_speed = phase_eigen_path()
        launches.update(counts)
        speed["eigen"] = eigen_speed
    if "ipw3d" in want:
        speed["ipw3d_steps_per_s"] = phase_ipw3d_path()
    if "neumann" in want:
        speed["neumann_steps_per_s"] = phase_neumann_path()
    if "eigen1d" in want:
        _, speed["eigen1d"] = phase_eigen1d_path()
    if "qho2d" in want:
        speed["qho2d"] = phase_qho2d_path()
    if "kh" in want:
        speed["kh"] = phase_kh_path()
    floquet_row, pooled = None, {}
    if "subspace" in want:
        speed["subspace"], floquet_row, pooled = phase_subspace_path(
            with_floquet="floquet" in want, extra=cli_jobs() if "cli" in want else None)
    elif "cli" in want:
        pooled = _pool_map(cli_jobs())
    if "floquet" in want:
        speed["floquet"] = phase_floquet_path(floquet_row)
    if "cli" in want:
        phase_cli(pooled)
    if "parallel" in want:
        speed["parallel_adam_steps_per_s"] = phase_parallel()
    if "probe" in want:
        phase_probe()
    if "full" in want:
        phase_full(route)
    missed = []
    if "subspace_full" in want and not phase_subspace_full(only):
        missed.append("subspace_full")
    if "subspace_seeds" in want:
        phase_subspace_seeds(only)
    if "floquet_full" in want and not phase_floquet_full(only):
        missed.append("floquet_full")
    if missed:
        raise SystemExit(f"{', '.join(missed)}: a row missed its ACCEPTANCE.json target (above)")
    if "precision" in want:
        launches.update(phase_precision_path())
    rows = wan_rows = eigen_rows = prec_rows = []
    if "timing" in want:
        rows = phase_timing(dev, only)
        wan_rows = phase_wan_timing(dev, only)
        eigen_rows = phase_eigen_timing(dev, only)
        phase_ipw3d_timing(dev, only)
    if want & {"timing", "eigen1d"}:
        phase_eigen1d_timing(dev, only)
    if want & {"timing", "kh"}:
        phase_kh_timing(dev, only)
    if "eigen1d" in want:
        phase_graph_trace(dev)
    if "precision" in want:
        prec_rows = phase_precision_timing(dev)
    elif only is not None and any(name.endswith(".bf16") for name in only):
        phase_precision_timing(dev, only)
    emit({"phase": "train_step", **speed,
          "points_per_s_fused": speed.get("steps_per_s_fused", 0.0) * 20000})
    if not full:
        print(card, flush=True)
        print("chip_smoke: partial run (phase groups: %s); no kernels line, not ok"
              % ", ".join(sorted(want)), flush=True)
        sys.exit(4)
    kernels = []
    for kind in REPLACES:
        main_row = next(r for r in rows if r["kernel"] == kind and r["N"] == 20000)
        kernels.append({
            "name": kind, "route": "cuda", "source": "nnpde_tpu_torch/csrc/fused_step.cu",
            "replaces": REPLACES[kind], "launches": launches[kind],
            "max_abs_err": max_err[kind], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
        })
    for kind in WAN_REPLACES:
        row = next(r for r in wan_rows if r["kernel"] == kind and r["N"] == 20000
                   and r["net"] == WAN_MAIN_NET[kind] and r["d"] == 2)
        kernels.append({
            "name": kind, "route": "cuda",
            "source": WAN_SOURCES.get(kind, "nnpde_tpu_torch/csrc/fused_quotient.cu"),
            "replaces": WAN_REPLACES[kind], "launches": launches[kind],
            "max_abs_err": max_err[kind], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        })
    for kind in EIGEN_REPLACES:
        row = next(r for r in eigen_rows if r["kernel"] == kind and r["N"] == EIGEN_N
                   and r["net"] == EIGEN_MAIN_NET[kind])
        kernels.append({
            "name": kind, "route": "cuda", "source": EIGEN_SOURCES[kind],
            "replaces": EIGEN_REPLACES[kind], "launches": launches[kind],
            "max_abs_err": max_err[kind], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        })
    for kind in PRECISION_REPLACES:
        row = next(r for r in prec_rows if r["kernel"] == kind and r["N"] == 20000)
        kernels.append({
            "name": kind, "route": "cuda", "source": PRECISION_SOURCES[kind],
            "design_source": MMA_SOURCE,
            "replaces": PRECISION_REPLACES[kind], "launches": launches[kind],
            "max_abs_err": max_err[kind], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        })
    if len(kernels) != 16 or not all(k["launches"] > 0 for k in kernels):
        raise SystemExit("a kernel of the paths was launched no time on its path")
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
