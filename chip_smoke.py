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
   critic 2-64-64-1, 5 critic steps, 300 epochs) on jet_impl 'torch' and
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
   jet_impl 'torch', 'kernel' and 'fused' (200 epochs, cut from the 20000
   of the acceptance row): first total within rtol 1e-4, first 10 within
   5e-2, kernel and fused rel_l2 <= max(2 x torch, 1e-3), exact launch
   counts; DRM on 'fused' (300 epochs; the same band against 100 'torch'
   epochs, loss falling below its first value); WAN with n_test_grid = 4 (16
   bumps) on 'torch' and 'fused' (150 epochs): the same band, the first
   weak-form term within 1e-3, all finite, rel_l2 falling, exact launch
   counts; then 50 epochs each of grid_jitter and
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
   ``train_ipw_1d(n=3, technique='FN')`` (100 of 3000 epochs: PINN on three
   routes, DRM on two), ``train_ipw_1d_wan(technique='FN')`` (80 epochs,
   'torch' and 'fused'), ``train_qho_1d(n=1, technique='FN')`` at u200
   (100 of 10000 epochs, PINN on three routes, DRM on two), the
   L-BFGS rows qho1d_n0_drm_fn_lbfgs ('fused') and qho1d_n2_pinn_fn_lbfgs
   ('kernel') of ACCEPTANCE.json (E1_LBFGS_ITERS = 1000 of their 3000
   iterations, best MSE <= 1e-5, ACCEPTANCE.json's bar), ``train_qho_1d_wan(n=0, technique='OG',
   minimax='extragradient', v_lr=2e-3)`` (80 of 30000 epochs) and
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
   0.98-1.02 of ``max_memory_allocated`` over 20 epochs of the same
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
   (500 epochs; rel_l2 <= max(2 x the route's fp32 run, 1e-3); the two
   tails from one bulk agree at 1e-3), the Poisson WAN 'hybrid' (150 fused
   epochs), the infinite well (3, 3) PINN 'hybrid' (250 epochs, 'torch' and
   'fused') and one 100-epoch 'bfloat16' run of each entry point;
   precision_timing times the four kernels in both dot modes at the path's
   N and at 262144 (d = 2), and rows 1, 4, 5 in fp32 at d = 5
   (``timing --rows=fused_linear_residual.bf16`` times one such row alone).
   Rows 3 and 7-10 in the bf16-dot mode (the Deep-Ritz energy and the
   quotients' two passes on the same tensor-core body): precision_b1_kernels
   holds each to its plain bf16-dot version on u64 / c64 at 20000 points,
   u50 at 40000, (1, 200 x 3, 1) tanh (the wide variant), (5, 64 x 4, 1) and
   (16, 256, 256, 1) (device-sums), rows 7-8 with and without the
   Laplacian stream, by the rules above (pass A's sums within 5e-6 of the
   sum of their terms' magnitudes), and ``dot_dtype='bf16x3'`` to the fp32
   kernel bitwise; rows 11-12 (the K-bump WAN pair on the same body, a
   weak-form coefficient stream) likewise on c20 and u50 at 40000 points
   and 16 bumps, (2, 200 x 4, 1), u50 at 1, 36 and 42 bumps and (16, 256,
   256, 1) at 42 (the plans' largest tiers); precision_b1_path trains the
   Poisson 2D DRM (``fused_drm_energy``, 300 epochs), the 2D well's
   Rayleigh DRM (``make_fused_rayleigh``, (3, 3) FN, u50, 300 epochs), the
   Poisson 2D WAN (``make_fused_wan_pair``, 150 epochs) and the 2D well's
   16-bump WAN (``make_fused_wan_multi_pair``, (3, 3) FN, u50 / c20, 150
   epochs), each built with ``dot_dtype='bfloat16'`` and once in float32:
   exact launches by name, the bf16 metric <= max(2 x the float32 run's,
   1e-3) and falling; precision_b1_timing times the seven rows at their
   path cells' N and at 262144 (rows 11-12 on c20, u50 and u200 beside
   their fp32 kernel).
15. wide (group ``wide``): hidden widths 129-256.  wide_kernels holds rows
   1, 2, 4, 5 bf16 (the tensor-core design's device tiers where the
   weights do not fit beside the stages) on (2, w x 4, 1) at w = 136, 200,
   256 and on (5, 200 x 3, 1) to their plain bf16-dot versions at C2's bar
   (max(1e-4, 4.2 x the plain version's permutation spread)), every other
   tier at the plan's tile bitwise equal to the plan's, and rows 11, 12
   (16 bumps; the tier reading the weights from device memory at 256) to
   float64 at 1e-5, repeats bitwise, each shape's plan printed with ptxas'
   registers and spills; wide_path trains ``train_poisson_nd`` with
   ``compute_dtype='hybrid-kernel'`` at width 200 (``fused``, ``fused``
   analytic, ``kernel``; 200 epochs, bulk 160) and the 2D well's 16-bump
   WAN at width 200 (40 epochs, 'torch' and 'fused'), with exact launch
   counts, and ``cli.main`` on the first, bitwise its rel_l2; wide_timing
   times the six kernels at width 200, d = 2, at the paths' N and 262144.
16. beyond (group ``beyond``): nets beyond the other kernels' limits
   (``ROADMAP.md`` B7), which every fp32 kernel takes (rows 1-12).
   beyond_kernels holds the twelve (rows 7 and 8 with and without the
   Laplacian stream; rows 11 and 12 at 16 bumps, and at the cap of 42 on
   the d = 20 net) on (2, 512 x 4, 1) sin, (1, 1001, 300, 1) tanh, (18,
   128, 128, 1) gelu, (20, 64 x 4, 1) sin and (2, 32 x 23, 1) tanh at 1007
   points and at the paths' 20000 (rows 11, 12: 40000) to their float64
   plain versions (the loss and every gradient leaf, every jet column, rel
   <= 1e-5, each pass-A sum within 1e-5 of its terms' magnitudes; rows 3,
   6-12 also within 1e-5 beyond twice the float32 plain version's own
   distance; repeats bitwise; row 6 bitwise row 4; the DES_BEYOND design
   where the net needs it, the weights in device memory on the 512-wide
   net); (20, 512 x 4, 1) raises NoFit naming B7 in each, and every
   bf16-dot mode raises naming B7 on (2, 300, 300, 1); beyond_path trains
   ``train_poisson_nd`` at width 512 (P1 PINN: 'fused', 'fused' analytic,
   'kernel'; P4 DRM; 200 epochs; P7 WAN with a 512-wide critic, 20), d = 20
   (P2 PINN: 'fused', 'kernel'; P5 DRM; 100; P8 WAN, 30) and 24 weight
   matrices (P3 PINN, P6 DRM: 'fused'; 100) against the 'torch' route's
   run: first total within 1e-5, PINN and DRM rel_l2 <= max(2 x torch's,
   1e-3), the WAN the cut WAN paths' gate, each kernel's launches exact;
   beyond_eigen_path trains ``train_ipw_2d`` (state (3, 3), FN, 40000 grid
   points) at width 512 (Q1 the 16-bump WAN with a (2, 512, 512, 1) critic,
   'fused', 20 epochs; Q2 the PINN on 'kernel:streams' and 'kernel', 50)
   and at 24 weight matrices (Q3: 'kernel:streams', 50; the 16-bump WAN,
   30) against 'torch', by the same gates; beyond_timing times the twelve
   on the P1, P2 and P3 nets at the paths' points (rows 11, 12 also on
   the Q1 critic) and at 262144.

``python3 chip_smoke.py eigen`` (or any other phase-group name: kernels,
wan, main, eigen, ipw3d, neumann, eigen1d, qho2d, kh, subspace, floquet,
cli, parallel, probe, timing, precision, wide, beyond) runs only those groups,
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


_T0 = time.time()


def emit(obj):
    """One JSON line; a phase's line carries the seconds since the start
    (``at_s``: where the run's clock goes)."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.time() - _T0)
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
    """The default 2D Poisson WAN on both jet paths (300 epochs, cut from
    1000 for the run's clock: at 300 the fused route is at 1.4e-2 against
    the 5e-2 gate), then extragradient."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.problems import PoissonConfig, train_poisson_nd

    epochs = 300
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


def device_ms(fn, launches=30, reps=5, window_ms=150.0, warm=3):
    """Device time of the launches ``fn`` makes, per call of ``fn``: the
    launches are captured once (pointers and workspace prepared by the
    wrapper, outside the timed window) and issued again ``launches`` times
    back to back inside one event pair, so the queue never runs dry and the
    wrapper's host work (checks, torch.cat, allocation) is not timed.  The
    floor is the host's time for one ctypes call, a few microseconds.  A
    call of more than 5 ms takes fewer launches a window (at least 3, about
    ``window_ms`` of them): the window stays long, the run's clock short;
    ``window_ms=None`` keeps ``launches`` for every call.  ``warm``: the
    replays before the first timed one."""
    from nnpde_tpu_torch.kernels import _cuda

    with _cuda.capture() as cap:
        fn()
    cap.replay(warm)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    cap.replay(1)
    b.record()
    b.synchronize()
    one = a.elapsed_time(b)
    if window_ms is not None and one > 5.0:
        launches = min(launches, max(3, int(window_ms / one)))
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
    # (300 epochs to PR 19, cut for the run's clock)
    epochs = 200
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
    epochs = 150
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
    side = 50          # (100 before, cut for the run's clock)
    for name, kw, per in (("grid_jitter", dict(grid_jitter=True), EIGEN_JITTER_PER_EPOCH),
                          ("extragradient", dict(minimax="extragradient"), EIGEN_EG_PER_EPOCH)):
        out, counts, wall = run(jet_impl="fused", **dict(wan, epochs=side), **kw)
        h = out["history"]
        s_ok = bool(all(np.all(np.isfinite(h[k])) for k in ("total", "l2", "wan_loss_v"))
                    and only(counts, {k: n * side for k, n in per.items()}))
        report["wan_" + name] = {"epochs": side, "launches": counts, "per_epoch": per,
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
    return _multibump_plan(case.kind, case.layers, case.Kb, case.N, case.X.device)


def _multibump_plan(kind, layers, Kb, N, dev):
    """The same for a net, bump count and point count: with the design (0,
    DES_DEVW for the weights from device memory, DES_BEYOND added on pass B
    for the nets beyond the other kernels' limits)."""
    from nnpde_tpu_torch.kernels import fused_multibump as fm

    try:
        from nnpde_tpu_torch.kernels._plan import resident
    except ImportError:        # a tree whose plan lives in fused_multibump.py
        resident = fm.resident
    from nnpde_tpu_torch.kernels import _cuda, _plan

    dev = torch.device("cuda", torch.cuda.current_device()) if dev.index is None else dev
    seeded = kind == "multi_seeded"
    pl = fm.plan(seeded, layers, Kb)
    devw = pl.flags & getattr(_plan, "DEV_WEIGHTS", 0)
    if devw or pl.design:   # the variants without the fold, keyed by their design
        blocks = _cuda.grid(kind, None, pl.smem, dev, (N + pl.T - 1) // pl.T,
                            pl.design or devw)
    else:
        blocks = launch_blocks(kind, layers, layers[0] + 1, pl, dev, N)
    return {"T": pl.T, "smem_bytes": pl.smem, "blocks": blocks, "tier": pl.tier,
            "design": pl.design, "resident": resident(pl, seeded)}


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
    "fused_linear_residual.bf16": "nnpde_tpu_torch/csrc/fused_step_mma.cu",
    "fused_poisson_analytic.bf16": "nnpde_tpu_torch/csrc/fused_step_mma.cu",
    "fwdlap_forward.bf16": "nnpde_tpu_torch/csrc/fwdlap_forward.cu",
    "fwdlap_backward.bf16": "nnpde_tpu_torch/csrc/fwdlap_backward.cu",
}
# the tensor-core design's body, beside each bf16-dot row's entry point
MMA_SOURCE = "nnpde_tpu_torch/csrc/fwdlap_mma.cuh"
# where each entry point takes its design among its arguments
DES_ARG = {"fused_linear_residual_f32": 12, "fused_poisson_analytic_f32": 11,
           "fwdlap_forward_f32": 11, "fwdlap_backward_f32": 12, "fused_drm_energy_f32": 12,
           "fused_quotient_mma_f32": 13, "fused_multibump_mma_f32": 13,
           "fused_quotient_f32": 14, "fused_multibump_f32": 20}
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
PREC_TOL_JET = {(2, 64): 1e-4, (5, 64): 5e-4, (2, 50): 2e-4, (5, 50): 3e-4, (1, 100): 2e-4}
# the 1D oscillator's critic v100, tanh, at 40000 points: the case of
# tools/fwd_bf16_columns.py (the same draws) on which row 4 bf16's value
# column was 7.7x its plain version's distance from float64 before the
# products feeding a bf16 rounding left the tensor cores (fwdlap_mma.cuh,
# f32_products).  Run at every seed of its study (SEEDS) and held to
# float64 by ROADMAP.md C4's bar (fwdlap_cuda.c4_columns): a column's
# distance from the witness counts the entries that round to the other bf16
# neighbour, which the plain version's own sound rounding orders move by up
# to 10x either way (PERF.md, C4)
V100 = (1, 100, 100, 100, 1)
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

    def plain(self, dot, dtype=torch.float32, order=None):
        """The plain version of the ``dot`` mode on the card, float32 (the
        oracle) or float64 (``dtype``; in the bf16-dot mode the witness: its
        operands rounded to bf16 from float64 values); ``order``: the
        bf16-dot reverse nonlinearity's sum in another sound order
        (``ops.fwdlap.DV_ORDERS``; rows 1, 2, 5)."""
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
            dWs, dbs = fc.fwdlap_backward_plain(P, X, self.ct.to(dtype), self.act, dot, order)
            return [t for pair in zip(dWs, dbs) for t in pair]
        c = self.case
        if self.base == "fused_linear_residual":
            dWs, dbs, sums = fs.linear_residual_plain(P, X, c.coef.to(dtype), self.act, dot,
                                                      order)
        else:
            dWs, dbs, sums = fs.poisson_analytic_plain(P, X, self.act,
                                                       fs.PoissonSinCoef(L, c.ks), dot, order)
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
    launch); row 4 also on V100 (tanh) at 40000 points."""
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
    # V100 tanh at every seed of the C4 study, under C4's bar (c4_columns)
    from nnpde_tpu_torch.tools.fwd_bf16_columns import SEEDS

    cases += [("fwdlap_forward", EIGEN_N, V100, seed, {"act": "tanh", "c4": True})
              for seed in SEEDS]
    for base, N, layers, seed, opt in cases:
        case = PrecCase(base, N, layers, opt.get("act", "sin"), seed=seed, dev=dev,
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
        witness_ok = w_kernel <= 2.0 * w_plain + 2e-6
        apart = case.distinct(out, f32)
        c4 = None
        if opt.get("c4"):
            from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

            c4 = fc.c4_columns(case.params, case.X, case.act, out[0])
            witness_ok = all(c["kernel"] <= c["bar"] for c in c4)
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
        # apart from the fp32 kernel by more than 10x the bar in force; the
        # V100 seeds other than 31 (the rest of C4's study) by more than
        # 10x their own distance from the plain bf16-dot version, since at
        # some seeds the bf16 rounding moves the jet by less than 10x its bar
        # (seed 305: 1.84e-3 against 2e-3), and their tensor-core design is
        # asserted from the launch all the same
        apart_ok = apart > 10 * (rel if opt.get("c4") and seed != 31 else tol)
        row = {"kernel": name, "N": N, "layers": list(layers), "act": case.act,
               "fold": bool(fold),
               "cotangent": opt.get("ct", "residual") if base == "fwdlap_backward" else None,
               "rel": rel, "tol": tol, "rel_to_fp32_kernel": apart,
               "witness_rel_kernel": w_kernel, "witness_rel_plain": w_plain,
               "max_abs_err": err, "bitwise_repeat": bitwise, "equal_to_folded": same,
               "designs": designs, "seed": seed, "c4_columns": c4,
               "ok": bool(rel <= tol and apart_ok and bitwise and witness_ok
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

    # poisson5d-pinn-hybrid: u64 at d = 5, 500 epochs (cut from 10000), on
    # torch and on fused (torch bulk, fused tail), beside fp32 runs
    e5 = 500
    b5 = dict(dim=5, method="PINN", bc_mode="FBC", epochs=e5, n_interior=20000, chunk=1000)
    p5, runs5 = {}, {}
    for route in ("torch", "fused"):
        r32, l32, _ = run(train_poisson_nd, PoissonConfig(jet_impl=route, **b5))
        rh, lh, _ = run(train_poisson_nd, PoissonConfig(jet_impl=route,
                                                        compute_dtype="hybrid", **b5))
        runs5[route] = rh
        g = max(2.0 * r32["rel_l2"], 1e-3)
        want = {} if route == "torch" else {"fused_linear_residual": e5 // 5}
        want32 = {} if route == "torch" else {"fused_linear_residual": e5}
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

    # poisson2d-wan-hybrid: the WAN path's config, 150 epochs on fused
    ew = 150
    r, launches, wall = run(train_poisson_nd, PoissonConfig(dim=2, method="WAN", epochs=ew,
                                                            chunk=1000, jet_impl="fused",
                                                            compute_dtype="hybrid"))
    h = r["history"]
    l2_first = float(h["l2"][0]) / 0.5
    want = {k: n * ew // 5 for k, n in WAN_PER_EPOCH.items()}
    out["poisson2d_wan_hybrid"] = {
        "epochs": ew, "rel_l2": r["rel_l2"], "rel_l2_first": l2_first, "launches": launches,
        "steps_per_s": _rate(r), "bulk_steps_per_s": r["result"].timing["bulk_steps_per_s"],
        "tail_steps_per_s": r["result"].timing["tail_steps_per_s"],
        "ok": bool(all(np.all(np.isfinite(h[k])) for k in ("total", "l2", "wan_loss_v"))
                   and r["rel_l2"] < l2_first and launches == want)}

    # ipw2d-n33-pinn-hybrid: 250 epochs (cut from 20000), torch and fused
    ib = dict(nx=3, ny=3, technique="FN", method="PINN", epochs=250, chunk=1000,
              weights={"data": 1e4})
    i32, _, _ = run(train_ipw_2d, IPW2DConfig(jet_impl="torch", **ib))
    g = max(2.0 * i32["rel_l2"], 1e-3)
    ip = {"rel_l2_fp32_torch": i32["rel_l2"], "fp32_torch_steps_per_s": _rate(i32), "gate": g}
    for route in ("torch", "fused"):
        r, launches, _ = run(train_ipw_2d, IPW2DConfig(jet_impl=route, compute_dtype="hybrid",
                                                       **ib))
        want = {} if route == "torch" else {"fused_linear_residual": ib["epochs"] // 5}
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


# ------------------------ rows 3, 7-10 and 11-12 in the bf16-dot mode (B1)
# The Deep-Ritz energy, the quotients' and the K-bump pair's two passes on
# the tensor-core body (fwdlap_mma.cuh: row 3 KIND_FUSED without the
# Laplacian stream, pass B KIND_FUSED with the seeded cotangents, pass A
# KIND_SUMS): the kernels against their plain bf16-dot versions, four short
# trainings built through the public constructors, and their times.
B1_REPLACES = {
    "fused_drm_energy.bf16": "nnpde_tpu/kernels/fused_step.py:170",
    "linear_sums.bf16": "nnpde_tpu/kernels/fused_quotient.py:111",
    "linear_seeded.bf16": "nnpde_tpu/kernels/fused_quotient.py:189",
    "quad_sums.bf16": "nnpde_tpu/kernels/fused_quotient.py:268",
    "quad_seeded.bf16": "nnpde_tpu/kernels/fused_quotient.py:333",
    "multi_sums.bf16": "nnpde_tpu/kernels/fused_multibump.py:62",
    "multi_seeded.bf16": "nnpde_tpu/kernels/fused_multibump.py:131",
}
B1_SOURCES = {name: ("nnpde_tpu_torch/csrc/fused_step_mma.cu" if name.startswith("fused")
                     else "nnpde_tpu_torch/csrc/fused_multibump_mma.cu"
                     if name.startswith("multi")
                     else "nnpde_tpu_torch/csrc/fused_quotient_mma.cu") for name in B1_REPLACES}
U200_1D = (1, 200, 200, 200, 1)
U5 = (5, 64, 64, 64, 64, 1)
D16 = (16, 256, 256, 1)       # the device-sums tier of the kinds with a reverse sweep
# (kind, lap): lap 0 drops the Laplacian stream (row 3, the quadratic
# quotients, the WAN weak forms' no_lap), lap 1 carries it (rows 7-8)
B1_KINDS = (("fused_drm_energy", 0), ("linear_sums", 0), ("linear_sums", 1),
            ("linear_seeded", 0), ("linear_seeded", 1), ("quad_sums", 0), ("quad_seeded", 0))
# the shapes each kind is held at: (layers, N, act)
B1_SHAPES = {
    "fused_drm_energy": ((LAYERS, 20000, "sin"), (U50, 40000, "sin")),
    "linear_sums": ((CRITIC, 20000, "sin"), (LAYERS, 20000, "sin")),
    "linear_seeded": ((CRITIC, 20000, "sin"), (LAYERS, 20000, "sin")),
    "quad_sums": ((CRITIC, 20000, "sin"), (U50, 40000, "sin")),
    "quad_seeded": ((CRITIC, 20000, "sin"), (U50, 40000, "sin")),
}
B1_COMMON = ((U200_1D, 20000, "tanh"), (U5, 20000, "sin"), (D16, 8000, "sin"))
# each row's cell on its path, timed at its n and at 262144 (the kernels
# line takes the first): row 3 the Poisson DRM's u64; rows 7-8 the Poisson
# WAN's critic (5 of its 6 launches an epoch) and u; rows 9-10 the WAN
# critic's regulariser and the 2D well's Rayleigh DRM
B1_CELLS = {
    "fused_drm_energy": ((LAYERS, 20000),),
    "linear_sums": ((CRITIC, 20000), (LAYERS, 20000)),
    "linear_seeded": ((CRITIC, 20000), (LAYERS, 20000)),
    "quad_sums": ((CRITIC, 20000), (U50, 40000)),
    "quad_seeded": ((CRITIC, 20000), (U50, 40000)),
}
B1_EPOCHS = {"drm": 300, "rayleigh": 300, "wan": 150, "ipw_wan": 150}
# rows 11-12: (layers, N, act, bumps) each pass is held at: the 2D well's
# critic and primal at its 16 bumps and 40000 grid points, the wide variant
# on (2, 200 x 4, 1) and on the 1D oscillator's (1, 200 x 3, 1) tanh, one
# bump, 36 (n_test_grid = 6) and the cap of 42 on u50, and d = 16 at width
# 256 at the cap (the plans' largest tiers: device for pass A, device-sums
# for pass B)
U200 = (2, 200, 200, 200, 200, 1)
B1_MULTI_SHAPES = ((EIGEN_V, EIGEN_N, "sin", 16), (EIGEN_U, EIGEN_N, "sin", 16),
                   (U200, 20000, "sin", 16), (U200_1D, 20000, "tanh", 16),
                   (EIGEN_U, EIGEN_N, "sin", 1),
                   (EIGEN_U, EIGEN_N, "sin", 36), (EIGEN_U, EIGEN_N, "sin", 42),
                   (D16, 8000, "sin", 42))
B1_MULTI_LARGEST = {"multi_sums": "device", "multi_seeded": "device-sums"}
# rows 11-12's timing cells at 16 bumps (the kernels line takes the first:
# the critic, 5 of the 6 launches of each pass an epoch)
B1_MULTI_CELLS = (EIGEN_V, EIGEN_U, U200)
# pass A's sums are held as the kernels phase holds the fp32 sums: each
# sum's difference over the sum of its terms' magnitudes (a sum whose terms
# cancel, such as the weak residual, amplifies any relative bar: on the
# critic the plain float32 version's sum r is 1.1e-2 from its float64
# witness, and the bf16 kernel 3.4e-4 from its plain version).  By that
# measure the kernel is 2.1e-9 to 3.6e-6 from its plain version at these
# shapes and the fp32 kernel 9.5e-5 to 1.9e-2 from it, so, as the jet
# forward's bars are set (PREC_TOL_JET), the bar lies above the one and
# below a tenth of the other.
PREC_TOL_SUMS = 5e-6


class B1Case:
    """Row 3 or one of rows 7-10 at one shape, through its public wrapper in
    any dot mode, and its plain version of either mode: lists of tensors
    (the loss or the sums one by one, then the gradient leaves; pass B's
    last bias leaf is sum ct_v).  Inputs as the paths build them: row 3 the
    Poisson energy's [B, dB, f], the linear quotients the WAN weak form (a
    nonzero ``a`` column where the Laplacian is carried), the quadratic ones
    the critic regulariser with a source."""

    def __init__(self, kind, N, layers, act, seed, dev, lap=0):
        self.kind, self.N, self.layers, self.act, self.lap = kind, N, layers, act, lap
        self.d = layers[0]
        if kind == "fused_drm_energy":
            self.src = Case(kind, N, self.d, layers, act, seed, dev)
            self.scal = None
        else:
            self.src = WanCase(kind, N, layers, act, seed, dev, lap)
            self.scal = self.src.scal
        self.params, self.X, self.coef = self.src.params, self.src.X, self.src.coef

    def kernel(self, dot):
        from nnpde_tpu_torch.kernels import fused_quotient as fq
        from nnpde_tpu_torch.kernels import fused_step as fs

        p, X, c, k = self.params, self.X, self.coef, self.kind
        if k == "fused_drm_energy":
            loss, _, g = fs.fused_drm_energy(p, X, c, self.act, dot_dtype=dot)
            return [loss.reshape(1)] + [t for pair in g for t in pair]
        if k == "linear_sums":
            s = fq.fused_linear_sums(p, X, c, self.act, no_lap=not self.lap, dot_dtype=dot)
            return [s[n].reshape(1) for n in ("sum_r", "sum_r2", "sum_mass", "sum_e2")]
        if k == "quad_sums":
            s = fq.fused_quad_sums(p, X, c, self.act, dot_dtype=dot)
            return [s[n].reshape(1) for n in ("sum_e", "sum_u2")]
        if k == "linear_seeded":
            g = fq.fused_seeded_grads(p, X, c, self.scal, self.act, no_lap=not self.lap,
                                      dot_dtype=dot)
        else:
            g = fq.fused_quad_seeded_grads(p, X, c, self.scal, self.act, dot_dtype=dot)
        return [t for pair in g for t in pair]

    def plain(self, dot, dtype=torch.float32, order=None):
        """The plain version of the ``dot`` mode on the card (float64: in the
        bf16-dot mode the witness, its operands rounded from float64);
        ``order``: row 3's bf16-dot reverse nonlinearity's sum in another
        sound order (``ops.fwdlap.DV_ORDERS``)."""
        from nnpde_tpu_torch.kernels import fused_quotient as fq
        from nnpde_tpu_torch.kernels import fused_step as fs

        P = [(W.to(dtype), b.to(dtype)) for W, b in self.params]
        X, c, k = self.X.to(dtype), self.coef.to(dtype), self.kind
        if k == "fused_drm_energy":
            dWs, dbs, sums = fs.drm_energy_plain(P, X, c, self.act, dot, order)
            g = fs._scaled_grads(P, dWs, dbs, sums, 1.0 / self.N)
            return [(sums[0] / self.N).reshape(1)] + [t for pair in g for t in pair]
        if k == "linear_sums":
            return list(fq.linear_sums_plain(P, X, c, self.act, not self.lap, dot).reshape(-1, 1))
        if k == "quad_sums":
            return list(fq.quad_sums_plain(P, X, c, self.act, dot).reshape(-1, 1))
        s = self.scal.to(dtype)
        if k == "linear_seeded":
            dWs, dbs, sums = fq.linear_seeded_plain(P, X, c, s, self.act, not self.lap, dot)
        else:
            dWs, dbs, sums = fq.quad_seeded_plain(P, X, c, s, self.act, dot)
        return [t for pair in fq._seeded_grads(P, dWs, dbs, sums) for t in pair]

    def tol(self):
        return PREC_TOL_SUMS if self.kind.endswith("_sums") else PREC_TOL

    def rel(self, a, b):
        """The largest difference over the loss and every leaf, each
        norm-relative; pass A's over its sums, each over the float64 sum of
        its terms' magnitudes."""
        if self.kind.endswith("_sums"):
            if not hasattr(self, "scale"):
                self.scale = self.src.abs_terms()
            return max(float(torch.abs(x.double() - y.double()).max()) / float(m)
                       for x, y, m in zip(a, b, self.scale))
        return max(float(torch.linalg.norm(x.double() - y.double())
                         / max(float(torch.linalg.norm(y.double())), 1e-30))
                   for x, y in zip(a, b))

    def distinct(self, bf, f32):
        """How far the bf16-dot result is from the fp32 one: the largest
        gradient leaf difference (row 3 past its loss), or sum difference."""
        lo = 1 if self.kind == "fused_drm_energy" else 0
        return self.rel(bf[lo:], f32[lo:])

    def streams(self):
        return self.d + 1 + self.lap

    def flops(self):
        per = 2.0 if self.kind.endswith("_sums") else 6.0
        return per * self.streams() * macs(self.layers) * self.N

    def bytes(self):
        P = sum(a * b + b for a, b in zip(self.layers[:-1], self.layers[1:]))
        out = {"fused_drm_energy": P + 3, "linear_sums": 4, "quad_sums": 2}.get(self.kind, P + 1)
        return 4.0 * (self.N * (self.d + self.coef.shape[1]) + P + out)

    def bound(self, peak):
        ops, mem = self.flops() / peak, self.bytes() / HBM_RATE
        return 1e3 * max(ops, mem), "operations" if ops >= mem else "bytes"

    def plan(self):
        from nnpde_tpu_torch.kernels import fused_step as fs

        return fs.mma_plan(self.kind, list(self.layers), lap=self.lap)


class B1MultiCase:
    """Row 11 or 12 at one shape and bump count (:class:`EigenCase`'s net
    and points, :func:`weak_form_stream`'s coefficients and seeds), through
    its public wrapper in any dot mode, and its plain version of either
    mode: lists of tensors (pass A's 3K sums one by one; pass B's gradient
    leaves, the last bias leaf sum ct_v)."""

    def __init__(self, kind, N, layers, act, seed, dev, Kb):
        from nnpde_tpu_torch.kernels.fused_multibump import weak_form_stream

        self.kind, self.N, self.layers, self.act, self.Kb = kind, N, layers, act, Kb
        self.src = EigenCase(kind, N, layers, act, seed, dev, Kb)
        self.src.coef, self.src.scal = weak_form_stream(self.src.X, Kb,
                                                        np.random.default_rng(seed + 1), L)
        self.params, self.X, self.coef = self.src.params, self.src.X, self.src.coef
        K = Kb
        self.seeds = (self.src.scal[:K], self.src.scal[K:2 * K], self.src.scal[2 * K:])

    def kernel(self, dot):
        from nnpde_tpu_torch.kernels import fused_multibump as fm

        p, X, c, K = self.params, self.X, self.coef, self.Kb
        if self.kind == "multi_sums":
            s = fm.fused_multi_sums(p, X, c, self.act, K, dot_dtype=dot)
            return list(torch.cat([s["sum_r"], s["sum_mass"], s["sum_e2"]]).reshape(-1, 1))
        g = fm.fused_multi_seeded_grads(p, X, c, self.seeds, self.act, K, dot_dtype=dot)
        return [t for pair in g for t in pair]

    def plain(self, dot, dtype=torch.float32):
        """The plain version of the ``dot`` mode on the card (float64: in the
        bf16-dot mode the witness, its operands rounded from float64)."""
        from nnpde_tpu_torch.kernels import fused_multibump as fm
        from nnpde_tpu_torch.kernels import fused_quotient as fq

        P = [(W.to(dtype), b.to(dtype)) for W, b in self.params]
        X, c = self.X.to(dtype), self.coef.to(dtype)
        if self.kind == "multi_sums":
            return list(fm.fused_multi_sums_plain(P, X, c, self.act, self.Kb, dot).reshape(-1, 1))
        dWs, dbs, sums = fm.fused_multi_seeded_grads_plain(P, X, c, self.src.scal.to(dtype),
                                                           self.act, self.Kb, dot)
        return [t for pair in fq._seeded_grads(P, dWs, dbs, sums) for t in pair]

    def tol(self):
        return PREC_TOL_SUMS if self.kind == "multi_sums" else PREC_TOL

    def rel(self, a, b):
        """Pass A: the largest difference of a sum over the float64 sum of its
        terms' magnitudes; pass B: the largest norm-relative difference over
        the leaves and sum ct_v."""
        if self.kind == "multi_sums":
            if not hasattr(self, "scale"):
                self.scale = self.src.abs_terms()
            return max(float(torch.abs(x.double() - y.double()).max()) / float(m)
                       for x, y, m in zip(a, b, self.scale))
        return max(float(torch.linalg.norm(x.double() - y.double())
                         / max(float(torch.linalg.norm(y.double())), 1e-30))
                   for x, y in zip(a, b))

    def distinct(self, bf, f32):
        return self.rel(bf, f32)

    def flops(self):
        return self.src.flops()

    def bytes(self):
        return self.src.bytes()

    def bound(self, peak):
        ops, mem = self.flops() / peak, self.bytes() / HBM_RATE
        return 1e3 * max(ops, mem), "operations" if ops >= mem else "bytes"

    def plan(self):
        from nnpde_tpu_torch.kernels import fused_step as fs

        return fs.mma_plan(self.kind, list(self.layers), n_bumps=self.Kb)


def b1_check(case, name, tier=None):
    """One bf16-dot case held by the precision phase's rules: the kernel
    within ``case.tol()`` of its plain bf16-dot version (float32 on the
    card) or of the float64 witness, more than 10x that from the fp32
    kernel, no further from the witness than 2x the plain version (+2e-6),
    two launches bitwise equal, each launch the tensor-core design of its
    plan (read from the launch's own arguments) under ``name``; ``tier``:
    the plan's tier it must take.  (The witness counts where the plain
    version is itself further from it than the bar: on (1, 200 x 3, 1) tanh
    row 7's plain float32 sums are 8.7e-6 of their terms' magnitudes from
    float64 and the kernel 1.9e-6.)  Returns ``(row, max_abs_err, fp32
    result)``."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fused_step as fs

    pl = case.plan()
    with _cuda.capture() as cap:
        out = case.kernel("bfloat16")
    designs = sorted({args[DES_ARG[fn.__name__]] for _, fn, args, _, _ in cap.calls})
    names = [c[0] for c in cap.calls]
    del cap
    out2, f32 = case.kernel("bfloat16"), case.kernel("float32")
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(out, out2))
    ref = case.plain("bfloat16")
    wit = case.plain("bfloat16", torch.float64)
    rel = case.rel(out, ref)
    w_kernel, w_plain = case.rel(out, wit), case.rel(ref, wit)
    apart = case.distinct(out, f32)
    err = max(float(torch.max(torch.abs(a.double() - b.double()))) for a, b in zip(out, ref))
    tol = case.tol()
    row = {"kernel": name, "N": case.N, "layers": list(case.layers), "act": case.act,
           "plan": {"T": pl.T, "tier": pl.tier, "smem": pl.smem}, "rel": rel, "tol": tol,
           "rel_to_fp32_kernel": apart, "witness_rel_kernel": w_kernel,
           "witness_rel_plain": w_plain, "max_abs_err": err, "bitwise_repeat": bitwise,
           "designs": designs, "launch_names": names}
    row["ok"] = bool(min(rel, w_kernel) <= tol and apart > 10 * tol and bitwise
                     and w_kernel <= 2.0 * w_plain + 2e-6
                     and designs == [fs.mma_des(list(case.layers), pl.flags)]
                     and names == [name] and (tier is None or pl.tier == tier))
    return row, err, f32


def phase_precision_b1_kernels(dev):
    """Rows 3, 7-10 and 11-12 bf16 against their plain bf16-dot versions
    (float32 on the card) by the precision phase's rules: the loss and every
    gradient leaf within 1e-4 norm-relative (pass A: every sum within 5e-6
    of the sum of its terms' magnitudes, PREC_TOL_SUMS); more than 10x that
    bar from the fp32 kernel; no further from the float64 witness than 2x
    the plain version (+2e-6); two launches bitwise equal; every launch the
    tensor-core design of its plan (narrow or wide, read from the launch's
    own arguments).  Shapes: each kind at its paths' nets (u64 / c64 at d =
    2, 20000 points; u50 at 40000), the oscillator's width (1, 200 x 3, 1)
    tanh (the wide variant), (5, 64 x 4, 1) and (16, 256, 256, 1) (the
    device tiers: device-sums for the kinds with a reverse sweep); rows 7-8
    with and without the Laplacian stream.  ``bf16x3`` launches the fp32
    kernel (its plain name) bitwise equal to ``float32`` at every kind's
    first shape.  Rows 11-12 (``B1_MULTI_SHAPES``) by the same rules, pass
    A's 3K sums each over the sum of its terms' magnitudes, pass B's leaves
    and sum ct_v norm-relative; at d = 16 each pass takes its plan's largest
    tier.  ``bf16x3`` on rows 11-12: :func:`bf16x3_other_rows`."""
    from nnpde_tpu_torch.kernels import LAUNCHES

    rows, x3_rows, max_err = [], [], {}
    seed = 400
    for kind, lap in B1_KINDS:
        name = kind + ".bf16"
        for i, (layers, N, act) in enumerate(B1_SHAPES[kind] + B1_COMMON):
            seed += 1
            case = B1Case(kind, N, layers, act, seed, dev, lap)
            row, err, f32 = b1_check(case, name, "device-sums" if layers == D16
                                     and not kind.endswith("_sums") else None)
            row["lap"] = lap
            max_err[name] = max(max_err.get(name, 0.0), err)
            if i == 0:
                before = LAUNCHES[kind]
                same = all(torch.equal(a, b) for a, b in zip(case.kernel("bf16x3"), f32))
                torch.cuda.synchronize()
                x3_rows.append({"kernel": kind, "lap": lap, "layers": list(layers),
                                "bitwise_float32": same,
                                "fp32_launches": LAUNCHES[kind] - before,
                                "ok": bool(same and LAUNCHES[kind] - before == 1)})
            rows.append(row)
            del case, f32
            torch.cuda.empty_cache()
    for kind in ("multi_sums", "multi_seeded"):
        name = kind + ".bf16"
        for layers, N, act, Kb in B1_MULTI_SHAPES:
            seed += 1
            case = B1MultiCase(kind, N, layers, act, seed, dev, Kb)
            row, err, _ = b1_check(case, name, B1_MULTI_LARGEST[kind] if layers == D16
                                   else None)
            row["n_bumps"] = Kb
            max_err[name] = max(max_err.get(name, 0.0), err)
            rows.append(row)
            del case
            torch.cuda.empty_cache()
    x3_rows += bf16x3_other_rows(dev)
    emit({"phase": "precision_b1_kernels", "tol": PREC_TOL, "tol_sums": PREC_TOL_SUMS,
          "rows": rows, "bf16x3": x3_rows})
    if not all(r["ok"] for r in rows + x3_rows):
        raise SystemExit("rows 3, 7-10 and 11-12 bf16-dot kernel vs plain comparison failed")
    return max_err


def bf16x3_other_rows(dev):
    """``dot_dtype='bf16x3'`` on the kernels that B1Case does not hold: rows
    1 and 2, the jet pair through ``mlp_fwdlap_kernel`` (rows 4 and 5 by the
    row forward, 6 and 5 by the stream-major one) and the K-bump pair (rows
    11-12), at the main path's u64 and 20000 points: the same launches by
    name as ``'float32'`` and bitwise its result."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.kernels import fused_multibump as fm
    from nnpde_tpu_torch.kernels import fused_step as fs
    from nnpde_tpu_torch.kernels import mlp_fwdlap_kernel

    rng = np.random.default_rng(450)
    N, Kb = 20000, 4
    params = rand_params(rng, LAYERS, dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, 2)).astype(np.float32), device=dev)
    coef = torch.as_tensor(rng.normal(size=(N, 6)).astype(np.float32), device=dev)
    mcoef = torch.as_tensor(rng.normal(size=(N, Kb * 6)).astype(np.float32), device=dev)
    scal = tuple(torch.as_tensor(rng.normal(size=Kb).astype(np.float32), device=dev)
                 for _ in range(3))

    def jet(dot, fwd_impl):
        leaves = [(W.clone().requires_grad_(True), b.clone().requires_grad_(True))
                  for W, b in params]
        j = mlp_fwdlap_kernel(leaves, X, "sin", fwd_impl=fwd_impl, dot_dtype=dot)
        val = j.value.mean() + (j.lap ** 2).mean()
        return [val.detach()] + list(torch.autograd.grad(val, [t for p in leaves for t in p]))

    def flat(out):
        return [t for x in out for t in (x if isinstance(x, (tuple, list)) else (x,))]

    calls = {
        "fused_linear_residual": lambda dot: fs.fused_linear_residual(
            params, X, coef, "sin", dot_dtype=dot)[2],
        "fused_poisson_analytic": lambda dot: fs.fused_poisson_analytic(
            params, X, "sin", L=L, ks=(1, 1), dot_dtype=dot)[2],
        "jet rows": lambda dot: jet(dot, "rows"),
        "jet streams": lambda dot: jet(dot, "streams"),
        "multi_sums": lambda dot: list(fm.fused_multi_sums(
            params, X, mcoef, "sin", Kb, dot_dtype=dot).values())[:3],
        "multi_seeded": lambda dot: fm.fused_multi_seeded_grads(
            params, X, mcoef, scal, "sin", Kb, dot_dtype=dot),
    }
    rows = []
    for name, call in calls.items():
        launched = {}
        outs = {}
        for dot in ("bf16x3", "float32"):
            reset_launches()
            outs[dot] = flat(call(dot))
            torch.cuda.synchronize()
            launched[dot] = {k: v for k, v in LAUNCHES.items() if v}
        same = all(torch.equal(a, b) for a, b in zip(outs["bf16x3"], outs["float32"]))
        rows.append({"kernel": name, "bitwise_float32": same, "launches": launched["bf16x3"],
                     "ok": bool(same and launched["bf16x3"] == launched["float32"]
                                and not any(k.endswith(".bf16") for k in launched["bf16x3"]))})
    reset_launches()
    return rows


def phase_precision_b1_timing(dev, only=None):
    """Wrapper and device ms of rows 3, 7-10 and 11-12 bf16 at their path
    cells' N and at 262144, each with its plain bf16-dot version's ms, its
    bound at the bf16 tensor cores' peak and its CUDA-core bound beside it,
    and its plan; rows 11-12 (c20, u50, u200 at 16 bumps) also with the fp32
    kernel's ms and device ms, and row 12 on u200 at 262144 also with the
    device ms of 30 launches a window (``device_ms_30``, beside the capped
    window).  ``only``: the rows of these names (``timing
    --rows=KERNEL.bf16``)."""
    rows = []
    for kind in ("multi_sums", "multi_seeded"):
        name = kind + ".bf16"
        if only is not None and name not in only:
            continue
        for layers in B1_MULTI_CELLS:
            for N in (EIGEN_N, 262144):
                case = B1MultiCase(kind, N, layers, "sin", 9, dev, EIGEN_BUMPS)
                ms = time_ms(lambda: case.kernel("bfloat16"))
                dev_ms = device_ms(lambda: case.kernel("bfloat16"))
                fp32_ms = time_ms(lambda: case.kernel("float32"))
                fp32_dev = device_ms(lambda: case.kernel("float32"))
                plain_ms = time_ms(lambda: case.plain("bfloat16"), warmup=2, reps=7)
                bound, by = case.bound(BF16_PEAK)
                pl = case.plan()
                rows.append({"kernel": name, "layers": list(layers), "d": layers[0], "N": N,
                             "n_bumps": EIGEN_BUMPS, "path_n": EIGEN_N,
                             "plan": {"T": pl.T, "tier": pl.tier, "smem": pl.smem},
                             "ms": ms, "device_ms": dev_ms, "fp32_ms": fp32_ms,
                             "fp32_device_ms": fp32_dev, "plain_ms": plain_ms,
                             "bound_ms": bound, "bound_by": by,
                             "bound_cuda_core_ms": case.bound(FP32_PEAK)[0],
                             "flop": case.flops(), "bytes": case.bytes(),
                             "gflops": case.flops() / (dev_ms * 1e-3) / 1e9,
                             "gbytes_per_s": case.bytes() / (dev_ms * 1e-3) / 1e9})
                if kind == "multi_seeded" and layers == U200 and N == 262144:
                    # the same launches timed with 30 a window, as every
                    # call was timed before the window was capped
                    rows[-1].update(
                        device_ms_30=device_ms(lambda: case.kernel("bfloat16"),
                                               window_ms=None),
                        fp32_device_ms_30=device_ms(lambda: case.kernel("float32"),
                                                    window_ms=None))
                del case
                torch.cuda.empty_cache()
    for kind, cells in B1_CELLS.items():
        name = kind + ".bf16"
        if only is not None and name not in only:
            continue
        for layers, n in cells:
            for N in (n, 262144):
                case = B1Case(kind, N, layers, "sin", seed=9, dev=dev)
                ms = time_ms(lambda: case.kernel("bfloat16"))
                dev_ms = device_ms(lambda: case.kernel("bfloat16"))
                plain_ms = time_ms(lambda: case.plain("bfloat16"), warmup=2, reps=7)
                bound, by = case.bound(BF16_PEAK)
                pl = case.plan()
                rows.append({"kernel": name, "layers": list(layers), "d": layers[0], "N": N,
                             "path_n": n, "plan": {"T": pl.T, "tier": pl.tier,
                                                   "smem": pl.smem},
                             "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                             "bound_ms": bound, "bound_by": by,
                             "bound_cuda_core_ms": case.bound(FP32_PEAK)[0],
                             "flop": case.flops(), "bytes": case.bytes(),
                             "gflops": case.flops() / (dev_ms * 1e-3) / 1e9})
                del case
                torch.cuda.empty_cache()
    emit({"phase": "precision_b1_timing", "rows": rows})
    return rows


def _b1_poisson_drm(dev, dot, layers=LAYERS, epochs=None):
    """The 2D Poisson Deep-Ritz energy on ``fused_drm_energy`` as
    ``fit(loss_and_grad_fn=...)``: the box-FBC net (u64, or ``layers``),
    20000 fixed points, Adam 1e-3, B1_EPOCHS['drm'] epochs (or
    ``epochs``); eval the MSE against the product-sine solution on 10000
    points (rel_l2 = sqrt(best) / rms)."""
    from nnpde_tpu_torch.kernels import drm_coefficients, fused_drm_energy
    from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
    from nnpde_tpu_torch.pde.poisson import exact_u_prod_sin, rhs_f_for_u_sin
    from nnpde_tpu_torch.train import fit, make_optimizer

    model = SolutionModel(NetSpec(layers, activation="sin"),
                          factor_for_technique("FBC", dim=2, kind="box", L=L))
    params = [(W.to(dev), b.to(dev)) for W, b in model.init(0)]
    g = torch.Generator(device=dev).manual_seed(11)
    X = torch.rand((20000, 2), generator=g, device=dev) * L
    Xe = torch.rand((10000, 2), generator=g, device=dev) * L
    ue = exact_u_prod_sin(Xe, L, (1, 1))
    coef = drm_coefficients(model.factor.jet(X), rhs_f_for_u_sin(X, L, (1, 1)))

    def lag(p, key):
        loss, _, grads = fused_drm_energy(p, X, coef, "sin", dot_dtype=dot)
        return (loss, {"pde": loss}), grads

    def eval_fn(p, key):
        return torch.mean((model.apply_batch(p, Xe) - ue) ** 2)

    n = epochs or B1_EPOCHS["drm"]
    r = fit(None, eval_fn, params, epochs=n, optimizer=make_optimizer(1e-3, total_steps=n),
            key=0, chunk=n, loss_and_grad_fn=lag)
    return {"metric": math.sqrt(r.best_metric) / 0.5,
            "first": math.sqrt(float(r.history["l2"][0])) / 0.5, "result": r}


def _b1_rayleigh(dev, dot):
    """The 2D infinite well's Rayleigh DRM, ``make_fused_rayleigh`` under
    ``fit``: state (3, 3) with the FN factor (its nodal lines), u50, the
    200 x 200 grid (40000 points), weight 2 (the unscaled convention), Adam
    1e-3; eval the relative error of the quotient 1/2 mean|grad u|^2 /
    mean u^2 (torch route, fp32) against E_33 on every fourth point."""
    from nnpde_tpu_torch.kernels import make_fused_rayleigh, quotient_coefficients
    from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
    from nnpde_tpu_torch.pde import ipw as phys
    from nnpde_tpu_torch.sampling import meshgrid_2d
    from nnpde_tpu_torch.train import fit, make_optimizer

    factor = factor_for_technique("FN", dim=2, kind="box", L=L,
                                  nodes_per_dim=[phys.nodes(3, L), phys.nodes(3, L)])
    model = SolutionModel(NetSpec(U50, activation="sin"), factor)
    params = [(W.to(dev), b.to(dev)) for W, b in model.init(0)]
    X = meshgrid_2d(200, 0.0, L, device=dev)
    Xe = X[::4]
    E = phys.energy_2d(3, 3, L)
    coef = quotient_coefficients(factor.jet(X))
    ray = make_fused_rayleigh("sin", weight=2.0, den_eps=1e-8, dot_dtype=dot)

    def loss_fn(p, key):
        total, aux = ray(p, X, coef)
        return total, {"rayleigh": aux["rayleigh"]}

    def eval_fn(p, key):
        u, gu = model.value_and_grad(p, Xe)
        q = 0.5 * torch.mean(torch.sum(gu * gu, dim=1)) / torch.mean(u * u)
        return torch.abs(q - E) / E

    n = B1_EPOCHS["rayleigh"]
    r = fit(loss_fn, eval_fn, params, epochs=n, optimizer=make_optimizer(1e-3, total_steps=n),
            key=0, chunk=n)
    return {"metric": r.best_metric, "first": float(r.history["l2"][0]), "result": r}


def _b1_poisson_wan(dev, dot):
    """The 2D Poisson WAN on ``make_fused_wan_pair(..., dot_dtype=dot)``
    and ``make_fused_quad_mean`` (the critic regulariser mean(|grad v|^2 +
    v^2), weight 2) under ``fit_wan``: the box-FBC u64 primal, the raw c64
    critic, the bump window, 20000 fixed points, 5 critic steps an epoch,
    Adam 1e-3; eval as the Poisson DRM run's."""
    from nnpde_tpu_torch.kernels import make_fused_quad_mean, quotient_coefficients
    from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
    from nnpde_tpu_torch.ops import bump_w
    from nnpde_tpu_torch.pde.poisson import exact_u_prod_sin, rhs_f_for_u_sin
    from nnpde_tpu_torch.problems._fused_wan import factor_jet_or_one, make_fused_wan_pair
    from nnpde_tpu_torch.train import fit_wan, make_wan_optimizers

    model = SolutionModel(NetSpec(LAYERS, activation="sin"),
                          factor_for_technique("FBC", dim=2, kind="box", L=L))
    critic = SolutionModel(NetSpec(CRITIC, activation="sin"))
    up = [(W.to(dev), b.to(dev)) for W, b in model.init(0)]
    vp = [(W.to(dev), b.to(dev)) for W, b in critic.init(1)]
    g = torch.Generator(device=dev).manual_seed(12)
    X = torch.rand((20000, 2), generator=g, device=dev) * L
    Xe = torch.rand((10000, 2), generator=g, device=dev) * L
    ue = exact_u_prod_sin(Xe, L, (1, 1))
    f = rhs_f_for_u_sin(X, L, (1, 1))
    wv, dwv = bump_w(X, 0.0, L)
    E0 = torch.zeros((), device=dev)
    pair = make_fused_wan_pair(model, critic, w_pde=1.0, prefactor=1.0, dot_dtype=dot)
    reg = make_fused_quad_mean("sin", weight=2.0, dot_dtype=dot)
    coef_r = quotient_coefficients(factor_jet_or_one(critic, X), V=0.5)

    def v_loss_fn(v_params, u_params, key):
        lv, _ = pair.v_loss_fn(v_params, u_params, E0, X, wv, dwv, f=f)
        r2, _ = reg(v_params, X, coef_r)
        return lv + r2

    def u_loss_fn(u_params, v_params, key):
        pde, aux = pair.u_pde_fn(u_params, E0, v_params, X, wv, dwv, f=f)
        return pde, {"pde": aux["pde_loss"]}

    def eval_fn(p, key):
        return torch.mean((model.apply_batch(p, Xe) - ue) ** 2)

    n = B1_EPOCHS["wan"]
    u_opt, v_opt = make_wan_optimizers(1e-3, epochs=n, v_steps=5)
    r = fit_wan(u_loss_fn, v_loss_fn, eval_fn, up, vp, epochs=n, v_steps=5, u_optimizer=u_opt,
                v_optimizer=v_opt, key=0, chunk=n)
    return {"metric": math.sqrt(r.best_metric) / 0.5,
            "first": math.sqrt(float(r.history["l2"][0])) / 0.5, "result": r}


def _b1_ipw_wan(dev, dot):
    """The 2D infinite well's 16-bump WAN on
    ``make_fused_wan_multi_pair(..., dot_dtype=dot)`` under ``fit_wan``, as
    ``train_ipw_2d`` builds it for ``n_test_grid = 4``: state (3, 3) with
    the FN factor, the u50 primal and the c20 critic (FBC) from the entry
    point's seed 0 keys, the 200 x 200 grid (40000 points) and its 4 x 4
    bump grid, the fixed E, 5 critic steps an epoch with the critic's
    stream built once an epoch, Adam 1e-3; the weights of ``train_ipw_2d``'s
    WAN (data 1e4, pde 10, parity 1, symmetry 1, norm 1000), the norm
    penalty riding e1_0 in the kernels (``w_norm``, ``vol = L^2``) and the
    data, parity and symmetry terms on the autograd path.  Eval: the
    sign-aware MSE on the grid; rel_l2 = sqrt(best) / rms(psi)."""
    from nnpde_tpu_torch.losses.zoo import data_mse, reflection_mse
    from nnpde_tpu_torch.models import NetSpec, SolutionModel, factor_for_technique
    from nnpde_tpu_torch.ops import bump_grid, bump_w_multi
    from nnpde_tpu_torch.ops.quadrature import sign_aware_mse
    from nnpde_tpu_torch.pde import ipw as phys
    from nnpde_tpu_torch.problems import IPW2DConfig
    from nnpde_tpu_torch.problems._fused_wan import make_fused_wan_multi_pair
    from nnpde_tpu_torch.prng import fold_in, threefry_fold_in, threefry_key
    from nnpde_tpu_torch.sampling import meshgrid_2d
    from nnpde_tpu_torch.train import fit_wan, make_wan_optimizers

    cfg = IPW2DConfig(nx=3, ny=3, technique="FN", method="WAN", n_test_grid=4)
    Lw = cfg.L
    factor = factor_for_technique("FN", dim=2, kind="box", L=Lw,
                                  nodes_per_dim=[phys.nodes(3, Lw), phys.nodes(3, Lw)])
    model = SolutionModel(NetSpec(cfg.layers, activation="sin"), factor)
    critic = SolutionModel(NetSpec(cfg.v_layers, activation="sin"),
                           factor_for_technique("FBC", dim=2, kind="box", L=Lw))
    up = [(W.to(dev), b.to(dev)) for W, b in model.init(cfg.seed)]
    vp = [(W.to(dev), b.to(dev))
          for W, b in critic.init(threefry_fold_in(threefry_key(cfg.seed), 9))]
    X = meshgrid_2d(cfg.grid_n, 0.0, Lw, device=dev)
    u_exact = phys.psi_2d(3, 3, X[:, 0], X[:, 1], Lw)
    Xd = meshgrid_2d(cfg.data_grid_n, 0.0, Lw, device=dev)
    half = cfg.data_grid_n // 2
    ii = torch.arange(half, device=dev)
    X_data = Xd[(ii[:, None] * cfg.data_grid_n + ii[None, :]).reshape(-1)]
    u_data = phys.psi_2d(3, 3, X_data[:, 0], X_data[:, 1], Lw)
    centers, hw = bump_grid(0.0, Lw, 2, cfg.n_test_grid)
    wv, dwv = bump_w_multi(X, centers.to(dev), hw)
    E = torch.tensor(phys.energy_2d(3, 3, Lw), dtype=torch.float32, device=dev)
    w = {"data": 10000.0, "pde": 10.0, "parity": 1.0, "symmetry": 1.0, "norm": 1000.0}
    pair = make_fused_wan_multi_pair(model, critic, int(centers.shape[0]), w_pde=w["pde"],
                                     w_norm=w["norm"], vol=Lw * Lw, dot_dtype=dot)
    X_swap, X_px = X.flip(1), torch.stack([Lw - X[:, 0], X[:, 1]], 1)
    X_py = torch.stack([X[:, 0], Lw - X[:, 1]], 1)
    refl = torch.cat([X_swap, X_px, X_py])

    def context(u_params, key):
        return pair.v_coef_fn(u_params, E, X, wv, dwv)

    def v_loss_fn(v_params, coef, key):
        return pair.v_loss_from_coef(v_params, X, coef)[0]

    def u_loss_fn(u_params, v_params, key):
        total, aux = pair.u_pde_fn(u_params, E, v_params, X, wv, dwv)
        u = model.apply_batch(u_params, X)
        u_sym, u_px, u_py = torch.chunk(model.apply_batch(u_params, refl), 3)
        # n = 3 is odd in both directions: even reflections
        terms = {"data": data_mse(model.apply_batch(u_params, X_data), u_data),
                 "symmetry": reflection_mse(u, u_sym),
                 "parity": reflection_mse(u, u_px) + reflection_mse(u, u_py)}
        total = total + sum(w[k] * t for k, t in terms.items())
        return total, dict(terms, pde=aux["pde_loss"], norm=aux["norm"])

    def eval_fn(p, key):
        return sign_aware_mse(model.apply_batch(p, X), u_exact)

    n = B1_EPOCHS["ipw_wan"]
    u_opt, v_opt = make_wan_optimizers(cfg.lr, epochs=n, v_steps=cfg.v_steps)
    r = fit_wan(u_loss_fn, v_loss_fn, eval_fn, up, vp, epochs=n, v_steps=cfg.v_steps,
                u_optimizer=u_opt, v_optimizer=v_opt, key=fold_in(cfg.seed, 1), chunk=n,
                v_context_fn=context)
    rms = float(torch.sqrt(torch.mean(u_exact * u_exact)))
    return {"metric": math.sqrt(r.best_metric) / rms,
            "first": math.sqrt(float(r.history["l2"][0])) / rms, "result": r}


# the 16-bump WAN's bf16 run held to its float32 run from the same seed over
# its first epochs: after 150 epochs both sit near rel_l2 0.69, where the
# rel_l2 gate tells a wrong kernel from a right one only if training
# diverges.  The cast alone moves the first weak-form term by 8.8e-3, the
# first critic loss by 1.1e-4 and the eval over 10 epochs by 1.2e-7; pass
# B without its mass seeds moves the eval by 9.5e-5, with the bumps'
# weights off by 10% the first weak-form term by 1.29 and the critic loss
# by 4.2e-2 (PERF.md section 6)
B1_TRACK = {"ipw_wan": {"pde0": 5e-2, "v0": 1e-3, "l2_10": 1e-5}}


def _b1_tracking(hb, hf):
    """The bf16 run's history against the float32 run's: the first
    weak-form term (``pde0``), the first critic loss (``v0``) and the
    largest relative difference of the eval over the first 10 epochs
    (``l2_10``)."""
    def rel(k, n):
        a, b = np.asarray(hb[k][:n], np.float64), np.asarray(hf[k][:n], np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))

    keys = {"pde0": ("pde", 1), "v0": ("wan_loss_v", 1), "l2_10": ("l2", 10)}
    return {name: rel(k, n) for name, (k, n) in keys.items() if k in hb and k in hf}


def phase_precision_b1_path(dev):
    """Four short trainings at the main path's widths, each built with
    ``dot_dtype='bfloat16'`` through the public constructors and once more
    in float32 (the same seed, points and steps): the Poisson 2D DRM on row
    3, the 2D well's Rayleigh DRM on rows 9-10, the Poisson 2D WAN on rows
    7-10 (and the frozen nets' jets on row 4, fp32), the 2D well's 16-bump
    WAN on rows 11-12 (the jets on row 4, fp32).  Each bf16 run's launches
    are asserted exactly by name, and its metric (rel_l2; the Rayleigh run's
    relative energy error) is held to PERF.md section 2's reduced-precision
    bar, <= max(2 x the float32 run's, 1e-3), and must fall below its first
    value.  Returns the bf16 runs' launches."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches

    n = B1_EPOCHS
    want = {
        "drm": {"fused_drm_energy.bf16": n["drm"]},
        "rayleigh": {"quad_sums.bf16": n["rayleigh"], "quad_seeded.bf16": n["rayleigh"]},
        "wan": {"fwdlap_forward": 6 * n["wan"], "linear_sums.bf16": 6 * n["wan"],
                "linear_seeded.bf16": 6 * n["wan"], "quad_sums.bf16": 5 * n["wan"],
                "quad_seeded.bf16": 5 * n["wan"]},
        "ipw_wan": {k if k == "fwdlap_forward" else k + ".bf16": m * n["ipw_wan"]
                    for k, m in EIGEN_WAN_PER_EPOCH.items()},
    }
    fns = {"drm": _b1_poisson_drm, "rayleigh": _b1_rayleigh, "wan": _b1_poisson_wan,
           "ipw_wan": _b1_ipw_wan}
    out, counts = {}, {}
    for name, fn in fns.items():
        runs = {}
        for dot in ("float32", "bfloat16"):
            reset_launches()
            t0 = time.time()
            r = fn(dev, dot)
            torch.cuda.synchronize()
            runs[dot] = dict(r, wall_s=time.time() - t0,
                             launches={k: v for k, v in LAUNCHES.items() if v})
        b, f = runs["bfloat16"], runs["float32"]
        gate = max(2.0 * f["metric"], 1e-3)
        want32 = {k[:-5] if k.endswith(".bf16") else k: v for k, v in want[name].items()}
        track = _b1_tracking(b["result"].history, f["result"].history)
        out[name] = {
            "epochs": n[name], "metric_bf16": b["metric"], "metric_fp32": f["metric"],
            "first_bf16": b["first"], "gate": gate, "launches": b["launches"],
            "launches_fp32": f["launches"],
            "steps_per_s": b["result"].timing["steps_per_s"],
            "fp32_steps_per_s": f["result"].timing["steps_per_s"],
            "wall_s": b["wall_s"] + f["wall_s"],
            "tracking": track,
            "ok": bool(math.isfinite(b["metric"]) and b["metric"] <= gate
                       and b["metric"] < b["first"] and b["launches"] == want[name]
                       and f["launches"] == want32
                       and all(track.get(k, math.inf) <= bar
                               for k, bar in B1_TRACK.get(name, {}).items()))}
        for k, v in b["launches"].items():
            if k.endswith(".bf16"):
                counts[k] = counts.get(k, 0) + v
    ok = all(v["ok"] for v in out.values())
    emit({"phase": "precision_b1_path", **out, "ok": ok})
    if not ok:
        raise SystemExit("bf16 DRM / Rayleigh / WAN / 16-bump WAN path check failed")
    return counts


# ------------------------------------------------------------- wide nets
# Hidden widths 129-256 on the tensor-core rows (1, 2, 4, 5 in the bf16-dot
# mode, fwdlap_mma.cuh) and on the K-bump pair (rows 11, 12,
# fused_multibump.cu): the nets, the kernels against their plain versions,
# the two entry points that reach them at width 200, the CLI, and timing.
WIDE_NETS = {"u136": (2,) + (136,) * 4 + (1,), "u200": (2,) + (200,) * 4 + (1,),
             "u256": (2,) + (256,) * 4 + (1,), "u200_d5": (5, 200, 200, 200, 1)}
WIDE_N = 20000 + 7
# C2's bar (ROADMAP.md C, tests/test_torch_cuda.py C2_SPREAD_MULTIPLE): a
# bf16-dot row within max(PREC_TOL, 4.2 x the plain version's own spread of
# two fp32 sum orders) of its plain version
WIDE_SPREAD_MULTIPLE = 4.2
WIDE_EPOCHS = 200             # each hybrid-kernel run: a bulk of 160, a tail of 40
WIDE_WAN_EPOCHS = 40          # each multi-bump WAN run (16 bumps)
WIDE_IPW_LAYERS = (2, 200, 200, 200, 200, 1)
WIDE_IPW_V_LAYERS = (2, 200, 200, 200, 1)
WIDE_CLI = ["poisson", "--dim", "2", "--method", "PINN", "--bc-mode", "FBC", "--jet-impl",
            "fused", "--width", "200", "--depth", "5", "--compute-dtype", "hybrid-kernel",
            "--epochs", str(WIDE_EPOCHS), "--chunk", "1000", "--n-interior", "20000"]


def permuted(params, layers, seed):
    """``params`` with their hidden units permuted (seeded), and the map of
    a gradient-leaf list of the permuted net back to the original's
    (``mma_leaf_rels``' permutation)."""
    dev = params[0][0].device
    g = torch.Generator().manual_seed(seed)
    perm = ([torch.arange(layers[0])] + [torch.randperm(w, generator=g) for w in layers[1:-1]]
            + [torch.arange(1)])
    perm = [p.to(dev) for p in perm]
    inv = [torch.argsort(p) for p in perm]
    moved = [(W[perm[k]][:, perm[k + 1]].contiguous(), b[perm[k + 1]].contiguous())
             for k, (W, b) in enumerate(params)]

    def back(leaves):
        out = []
        for k in range(len(params)):
            out += [leaves[2 * k][inv[k]][:, inv[k + 1]], leaves[2 * k + 1][inv[k + 1]]]
        return out

    return moved, back


def prec_spread(case, seed=23):
    """A bf16-dot case's plain version against itself on the net with its
    hidden units permuted (the same function and bf16 roundings, every sum
    in another fp32 order), folded back: C2's spread."""
    want = case.plain("bfloat16")
    keep = case.params
    moved, back = permuted(keep, case.layers, seed)
    case.params = moved
    try:
        got = case.plain("bfloat16")
    finally:
        case.params = keep
    if case.base == "fwdlap_forward":
        return case.rel(got, want)              # the jet rows do not move
    lo = 0 if case.base == "fwdlap_backward" else 1
    return case.rel(got[:lo] + back(got[lo:]), want)


def wide_launch(case, pl=None):
    """A bf16-dot case's kernel on plan ``pl`` (None: the wrapper's own) as
    one flat tensor."""
    from nnpde_tpu_torch.kernels import fused_step as fs
    from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

    if case.base == "fwdlap_forward":
        return fc.fwdlap_forward(case.params, case.X, case.act, "rows:default", pl=pl).reshape(-1)
    if case.base == "fwdlap_backward":
        dWs, dbs = fc.fwdlap_backward(case.params, case.X, case.ct, case.act, "bfloat16", pl=pl)
        return torch.cat([t.reshape(-1) for pair in zip(dWs, dbs) for t in pair])
    c = case.case
    an = fs._analytic_args(fs.PoissonSinCoef(L, c.ks), case.d)
    return fs._launch(case.base, case.params, case.X,
                      c.coef if case.base == "fused_linear_residual" else None, case.act, an,
                      bf16=True, pl=pl)


def wide_tiers(case, pl, dev):
    """The plan's output against every other tier of the tensor-core
    design that fits at the plan's tile, bitwise equal (the device tiers
    build the same bf16 operands and sum in the same order), on this
    case's net over T x 100 + 7 points: fewer tiles than the card has SMs,
    so that every tier launches one block per tile (a tier with another
    occupancy would otherwise deal the tiles to another number of blocks
    and sum the blocks' rows in another order)."""
    from nnpde_tpu_torch.kernels import fused_step as fs

    case = PrecCase(case.base, pl.T * 100 + 7, case.layers, case.act, seed=690, dev=dev)
    tiers = fs.MMA_FWD_TIERS if case.base == "fwdlap_forward" else fs.MMA_TIERS
    ref = wide_launch(case, pl)
    out = {}
    for tier, _ in tiers:
        if tier == pl.tier:
            continue
        try:
            other = fs.mma_plan(case.base, case.layers, T=pl.T, tier=tier, blocks=1)
        except ValueError:
            continue
        if case.base == "fwdlap_forward":
            other = other._replace(blocks=pl.blocks)
        out[tier] = bool(torch.equal(wide_launch(case, other), ref))
    return out


def phase_wide_kernels(dev):
    """Rows 1, 2, 4, 5 bf16 on (2, w x 4, 1) at w = 136, 200, 256 and on (5,
    200 x 3, 1), and rows 11, 12 on the three (2, w x 4, 1) nets (16 bumps),
    at 20007 points: the bf16-dot rows within C2's bar (max(1e-4, 4.2 x the
    plain version's permutation spread)) of their plain bf16-dot versions
    and no further from the float64 witness than 2x the plain version
    (+2e-6), every launch in the tensor-core design; the K-bump pair within
    1e-5 of float64 (eigen_kernels' bars); repeats bitwise; each shape's
    plan (tile, tier, blocks per SM); on u200 (and u136 and u256 for rows 1
    and 5) every other tier that fits the plan's tile bitwise equal to the
    plan's; ptxas' registers and spills of every variant."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fused_step as fs

    t0 = time.time()
    rows, max_err = [], {}
    for net, layers in WIDE_NETS.items():
        for i, name in enumerate(PRECISION_REPLACES):
            base = name[:-len(".bf16")]
            case = PrecCase(base, WIDE_N, layers, "sin", seed=600 + i, dev=dev)
            with _cuda.capture() as cap:
                out = case.kernel("bfloat16")
            designs = sorted({args[DES_ARG[fn.__name__]] for _, fn, args, _, _ in cap.calls})
            out2 = case.kernel("bfloat16")
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(out, out2))
            ref = case.plain("bfloat16")
            wit = case.plain("bfloat16", torch.float64)
            spread = prec_spread(case)
            bar = max(PREC_TOL, WIDE_SPREAD_MULTIPLE * spread)
            rel = case.rel(out, ref)
            w_kernel, w_plain = case.rel(out, wit), case.rel(ref, wit)
            err = max(float(torch.max(torch.abs(a.double() - b.double())))
                      for a, b in zip(out, ref))
            max_err[name] = max(max_err.get(name, 0.0), err)
            pl = fs.mma_plan(base, layers)
            des = fs.mma_des(layers, pl.flags)
            row = {"kernel": name, "net": net, "N": WIDE_N, "layers": list(layers),
                   "plan": (bf16_forward_plan(layers, WIDE_N, dev) if base == "fwdlap_forward"
                            else fused_plan(base, layers, WIDE_N, dev, True)),
                   "rel": rel, "spread": spread, "bar": bar,
                   "witness_rel_kernel": w_kernel, "witness_rel_plain": w_plain,
                   "max_abs_err": err, "bitwise_repeat": bitwise, "designs": designs,
                   "wide_variant": bool(des & _cuda.DES_WIDE)}
            if net == "u200" or (net in ("u136", "u256") and base in (
                    "fused_linear_residual", "fwdlap_backward")):
                row["tiers_bitwise"] = wide_tiers(case, pl, dev)
            row["ok"] = bool(rel <= bar and bitwise and w_kernel <= 2.0 * w_plain + 2e-6
                             and designs == [des] and des & _cuda.DES_MMA
                             and all(row.get("tiers_bitwise", {}).values()))
            rows.append(row)
            del case, out, out2, ref, wit
            torch.cuda.empty_cache()
    for net, layers in WIDE_NETS.items():
        if layers[0] != 2:
            continue
        for kind in ("multi_sums", "multi_seeded"):
            case = EigenCase(kind, WIDE_N, layers, "sin", seed=650, dev=dev)
            row = dict(hold(case), net=net, n_bumps=case.Kb, plan=multibump_plan(case))
            max_err[kind] = max(max_err.get(kind, 0.0), row["max_abs_err"])
            rows.append(row)
            del case
            torch.cuda.empty_cache()
    # each tensor-core and K-bump variant's entry, with its spills and registers
    ptx, keep = [], False
    for ln in ptxas_of("fused_step_mma.cu", "fwdlap_forward.cu", "fwdlap_backward.cu",
                       "fused_multibump.cu"):
        if "Compiling entry" in ln:
            keep = "_mma" in ln or "multi_" in ln
        if keep:
            ptx.append(ln)
    emit({"phase": "wide_kernels", "phase_s": time.time() - t0, "rows": rows, "ptxas": ptx})
    if not all(r["ok"] for r in rows):
        raise SystemExit("wide kernel vs plain comparison failed")
    return max_err


def phase_wide_path():
    """The entry points at width 200: ``train_poisson_nd`` in
    ``compute_dtype='hybrid-kernel'`` (2D PINN, box-FBC, 20000 points,
    (2, 200 x 4, 1); WIDE_EPOCHS of them, the 80/20 bulk/tail split) on
    'fused', on 'fused' with coef_mode='analytic' and on 'kernel': the
    bf16 kernels launched once per bulk epoch and the fp32 ones once per
    tail epoch, exactly; every rel_l2 below its first eval's; 'fused' and
    'kernel' within 2x of each other (the hybrid-kernel gate's band, 1e-3
    floor); ``train_ipw_2d`` WAN with 16 bumps at (2, 200 x 4, 1) and a
    critic (2, 200 x 3, 1), 40000 grid points, WIDE_WAN_EPOCHS on 'torch'
    and 'fused' from one seed: the wan16 gate (first total within 1e-4,
    first 10 within 5e-2, the weak-form term within 1e-3, finite, falling,
    fused rel_l2 <= 1.2 x torch) with the K-bump pair launched 6 times per
    epoch each; then ``cli.main`` on the fused hybrid-kernel configuration
    (WIDE_CLI): the same launches, its persisted rel_l2 bitwise the entry
    point's."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.problems import (IPW2DConfig, PoissonConfig, train_ipw_2d,
                                          train_poisson_nd)

    def run(fn, cfg):
        reset_launches()
        t0 = time.time()
        r = fn(cfg)
        return r, {k: v for k, v in LAUNCHES.items() if v}, time.time() - t0

    t0 = time.time()
    report, launches = {"phase": "wide_path"}, {}
    base = dict(dim=2, method="PINN", bc_mode="FBC", width=200, depth=5,
                epochs=WIDE_EPOCHS, n_interior=20000, chunk=1000,
                compute_dtype="hybrid-kernel")
    bulk = int(WIDE_EPOCHS * PoissonConfig().hybrid_bf16_fraction)
    hk = {}
    for name, kw, kerns in (
            ("fused", dict(jet_impl="fused"), ("fused_linear_residual",)),
            ("fused_analytic", dict(jet_impl="fused", coef_mode="analytic"),
             ("fused_poisson_analytic",)),
            ("kernel", dict(jet_impl="kernel"), ("fwdlap_forward", "fwdlap_backward"))):
        r, counts, wall = run(train_poisson_nd, PoissonConfig(**kw, **base))
        want = {k + sfx: n for k in kerns
                for sfx, n in ((".bf16", bulk), ("", WIDE_EPOCHS - bulk))}
        first = float(r["history"]["l2"][0]) / 0.5
        hk[name] = {"rel_l2": r["rel_l2"], "rel_l2_first": first, "launches": counts,
                    "want": want, "wall_s": wall, "steps_per_s": _rate(r),
                    "bulk_steps_per_s": r["result"].timing["bulk_steps_per_s"],
                    "tail_steps_per_s": r["result"].timing["tail_steps_per_s"],
                    "finite": bool(np.all(np.isfinite(r["history"]["total"]))),
                    "ok": bool(np.all(np.isfinite(r["history"]["total"]))
                               and r["rel_l2"] < first and counts == want)}
        launches.update({k: v for k, v in counts.items() if k.endswith(".bf16")})
        hk[name]["r"] = r
    f, k = hk["fused"]["rel_l2"], hk["kernel"]["rel_l2"]
    hk["routes_agree"] = bool(k <= max(2.0 * f, 1e-3) and f <= max(2.0 * k, 1e-3))
    fused_rel = hk["fused"]["rel_l2"]
    for name in ("fused", "fused_analytic", "kernel"):
        hk[name].pop("r")
    report["poisson2d_pinn_hybrid_kernel_u200"] = hk
    ok = all(hk[n]["ok"] for n in ("fused", "fused_analytic", "kernel")) and hk["routes_agree"]

    # the 2D well's multi-bump WAN at width 200, both routes from one seed
    wb = dict(nx=3, ny=3, technique="FN", chunk=1000, method="WAN", n_test_grid=4,
              layers=WIDE_IPW_LAYERS, v_layers=WIDE_IPW_V_LAYERS, epochs=WIDE_WAN_EPOCHS)
    wt, ct, wall_t = run(train_ipw_2d, IPW2DConfig(jet_impl="torch", **wb))
    wf, cf, wall_f = run(train_ipw_2d, IPW2DConfig(jet_impl="fused", **wb))
    first, first10 = _first_band(wt, wf)
    pde0 = float(abs(wf["history"]["pde"][0] - wt["history"]["pde"][0])
                 / abs(wt["history"]["pde"][0]))
    finite = all(np.all(np.isfinite(r["history"][k])) for r in (wt, wf)
                 for k in ("total", "l2", "wan_loss_v", "pde"))
    falling = all(r["L2_error"] < r["history"]["l2"][0] for r in (wt, wf))
    want = {k: n * WIDE_WAN_EPOCHS for k, n in EIGEN_WAN_PER_EPOCH.items()}
    wan = {"epochs": WIDE_WAN_EPOCHS, "n_bumps": EIGEN_BUMPS, "layers": list(WIDE_IPW_LAYERS),
           "v_layers": list(WIDE_IPW_V_LAYERS), "total0_rel": first, "first10_max_rel": first10,
           "pde0_rel": pde0, "finite": finite, "falling": falling,
           "rel_l2_torch": wt["rel_l2"], "rel_l2_fused": wf["rel_l2"],
           "rel_l2_first_torch": _rel_l2_first(wt), "rel_l2_first_fused": _rel_l2_first(wf),
           "wall_s_torch": wall_t, "wall_s_fused": wall_f,
           "epochs_per_s_torch": wt["result"].timing["steps_per_s"],
           "epochs_per_s_fused": wf["result"].timing["steps_per_s"],
           "launches_torch": ct, "launches": cf, "want": want}
    wan["ok"] = bool(first <= 1e-4 and first10 <= 5e-2 and pde0 <= 1e-3 and finite and falling
                     and wf["rel_l2"] <= 1.2 * wt["rel_l2"] and ct == {} and cf == want)
    launches.update({k: cf.get(k, 0) for k in ("multi_sums", "multi_seeded")})
    report["ipw2d_wan16_u200"] = wan
    ok = ok and wan["ok"]

    # the command line on the fused hybrid-kernel configuration
    cli = _cli_task("wide", WIDE_CLI)
    cli["entry_point_rel_l2"] = fused_rel
    cli["bitwise"] = cli["rel_l2"] == fused_rel
    cli["ok"] = bool(cli["rc"] == 0 and cli["bitwise"] and cli["plots"] == 0
                     and cli["launches"] == hk["fused"]["want"])
    report["cli"] = cli
    report["ok"] = bool(ok and cli["ok"])
    report["phase_s"] = time.time() - t0
    emit(report)
    if not report["ok"]:
        raise SystemExit("wide path check failed")
    return launches


def phase_wide_timing(dev):
    """The six kernels at width 200, d = 2 ((2, 200 x 4, 1), 16 bumps for
    the K-bump pair): wrapper and device ms at the path's N (20000; 40000,
    the 2D well's grid, for the pair) and at 262144, the plain version's
    ms, the bound (the bf16-dot rows at the tensor cores' peak with their
    CUDA-core bound beside it; the pair as eigen_timing bounds it) and the
    plan, and at 262144 the bf16-dot rows' device ms in every tier that
    fits the plan's tile; at 262144 fewer repeats (a launch there takes
    tens of ms)."""
    from nnpde_tpu_torch.kernels import fused_step as fs

    t0 = time.time()
    layers = WIDE_NETS["u200"]
    rows = []
    for name in PRECISION_REPLACES:
        base = name[:-len(".bf16")]
        for N in (20000, 262144):
            big = N > 100000
            case = PrecCase(base, N, layers, "sin", seed=7, dev=dev)
            ms = time_ms(lambda: case.kernel("bfloat16"), warmup=2, reps=5 if big else 15)
            dev_ms = device_ms(lambda: case.kernel("bfloat16"), launches=5 if big else 30,
                               reps=3 if big else 5)
            plain_ms = time_ms(lambda: case.plain("bfloat16"), warmup=1, reps=3 if big else 7)
            bound, by = case.bound(BF16_PEAK)
            row = {"kernel": name, "net": "u200", "d": 2, "N": N,
                   "plan": (bf16_forward_plan(layers, N, dev) if base == "fwdlap_forward"
                            else fused_plan(base, layers, N, dev, True)),
                   "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": by,
                   "bound_cuda_core_ms": case.bound(FP32_PEAK)[0],
                   "flop": case.flops(), "bytes": case.bytes(),
                   "tflops": case.flops() / (dev_ms * 1e-3) / 1e12}
            if big:
                # the tiers and tiles the plan passed over, pinned (which
                # tier u200 takes: the weights on chip at fewer blocks per
                # SM; larger tiles at one block per SM, which share each
                # dW product's read-modify-write of the gradient row in
                # device memory among more points)
                pl = fs.mma_plan(base, layers)
                row["tiers_device_ms"] = {}
                tiers = fs.MMA_FWD_TIERS if base == "fwdlap_forward" else fs.MMA_TIERS
                # the plan's tile (tiles of 32-64 points, measured once in
                # PR 17, are cut for the run's clock: PERF.md section 4)
                for T in (pl.T,):
                    for tier, _ in tiers:
                        try:
                            other = fs.mma_plan(base, layers, T=T, tier=tier, blocks=1)
                        except ValueError:
                            continue
                        if base == "fwdlap_forward":
                            other = other._replace(blocks=pl.blocks)
                        key = tier if T == pl.T else f"{tier}@T{T}"
                        row["tiers_device_ms"][key] = device_ms(
                            lambda: wide_launch(case, other), launches=5, reps=3)
            rows.append(row)
            del case
            torch.cuda.empty_cache()
    for kind in ("multi_sums", "multi_seeded"):
        for N in (EIGEN_N, 262144):
            big = N > 100000
            case = EigenCase(kind, N, layers, "sin", seed=11, dev=dev)
            ms = time_ms(case.kernel, warmup=2, reps=5 if big else 15)
            row = {"kernel": kind, "net": "u200", "d": 2, "N": N, "n_bumps": case.Kb,
                   "plan": multibump_plan(case), "ms": ms,
                   "device_ms": device_ms(case.kernel, launches=5 if big else 30,
                                          reps=3 if big else 5),
                   "plain_ms": time_ms(lambda: case.plain(torch.float32), warmup=1,
                                       reps=3 if big else 7),
                   "bound_ms": case.bound_ms(), "bound_by": case.bound_by(),
                   "flop": case.flops(), "bytes": case.bytes()}
            if big:
                # the weights from device memory at tiles of 16 to 32 points
                # (two blocks per SM), against the plan's tier on chip
                from nnpde_tpu_torch.kernels import fused_multibump as fm

                seeded = kind == "multi_seeded"
                row["tiers_device_ms"] = {}
                for T in (16,):         # 24 and 32 cut, as above
                    try:
                        other = fm.plan(seeded, layers, case.Kb, T=T, tier="device")
                    except ValueError:
                        continue
                    row["tiers_device_ms"][f"device@T{T}"] = device_ms(
                        lambda: fm._launch(seeded, case.params, case.X, case.coef, case.scal,
                                           case.act, case.Kb, pl=other), launches=5, reps=3)
            rows.append(row)
            del case
            torch.cuda.empty_cache()
    emit({"phase": "wide_timing", "phase_s": time.time() - t0, "rows": rows})
    return rows


# ------------------------------------------- nets beyond the other kernels' limits (B7)
# Every fp32 kernel takes hidden widths above 256, more than 16 weight
# matrices and d > 16 (the DES_BEYOND variants of the kernels with a
# reverse sweep where the net needs it; the weights in device memory above
# width 256; the forward-only rows' routines as they are), and so do the
# bf16-dot modes of rows 1-5 on the tensor-core design (rows 1-3 in their
# DES_BEYOND variant where the net needs it; row 4 to d = 16), which the
# hybrid-kernel runs P1h-P3h and a bf16 Deep-Ritz fit drive; rows 7-12
# bf16 keep width 256, 16 matrices, d = 16.  The nets: (2, 512 x 4, 1),
# the Poisson path's 512-wide net; a ragged wide one; d = 18 at width 128;
# (20, 64 x 4, 1), the 20-dimensional path's; 24 weight matrices.
BEYOND_NETS = {"u512": ((2,) + (512,) * 4 + (1,), "sin"),
               "w1001": ((1, 1001, 300, 1), "tanh"),
               "d18": ((18, 128, 128, 1), "gelu"),
               "d20": ((20,) + (64,) * 4 + (1,), "sin"),
               "k24": ((2,) + (32,) * 23 + (1,), "tanh")}
BEYOND_KERNELS = ("fused_linear_residual", "fused_poisson_analytic", "fwdlap_forward",
                  "fwdlap_backward")
# rows 3 and 7-10 in fp32 on the same nets: (kernel, lap),
# rows 7 and 8 with and without the Laplacian stream
BEYOND_Q_KINDS = (("fused_drm_energy", 0), ("linear_sums", 0), ("linear_sums", 1),
                  ("linear_seeded", 0), ("linear_seeded", 1), ("quad_sums", 0),
                  ("quad_seeded", 0))
# the kernels of the Poisson paths (BEYOND_PATHS)
BEYOND_P_KINDS = BEYOND_KERNELS + tuple(dict.fromkeys(k for k, _ in BEYOND_Q_KINDS))
# rows 6, 11 and 12 (the 2D well's kernels) on the same nets
BEYOND_E_KINDS = ("fwdlap_forward_streams", "multi_sums", "multi_seeded")
BEYOND_ALL = BEYOND_P_KINDS + BEYOND_E_KINDS
BEYOND_N = 20000             # the Poisson paths' points
# no tile of 4 points fits its stages: the rest of ROADMAP.md B7
BEYOND_NOFIT = (20, 512, 512, 512, 512, 1)
# the paths through train_poisson_nd (PoissonConfig fields), cut to these
# epochs, with each kernel's launches per step (the WAN's per epoch) on
# each route: P1 the PINN at full width, P2 d = 20, P3 24 weight matrices;
# P4-P6 the Deep-Ritz energy on the same three shapes; P7 the WAN at width
# 512 with a critic as wide (else rows 9 and 10 stay on the other kernels'
# shapes), P8 the WAN at d = 20
BEYOND_PATHS = {
    "P1": (dict(dim=2, width=512, depth=5), 200,
           {"fused": {"fused_linear_residual": 1},
            "fused_analytic": {"fused_poisson_analytic": 1},
            "kernel": {"fwdlap_forward": 1, "fwdlap_backward": 1}}),
    "P2": (dict(dim=20, width=64, depth=5), 100,
           {"fused": {"fused_linear_residual": 1},
            "kernel": {"fwdlap_forward": 1, "fwdlap_backward": 1}}),
    "P3": (dict(dim=2, width=64, depth=24), 100,
           {"fused": {"fused_linear_residual": 1},
            "kernel": {"fwdlap_forward": 1, "fwdlap_backward": 1}}),
    "P4": (dict(dim=2, width=512, depth=5, method="DRM"), 200,
           {"fused": {"fused_drm_energy": 1}}),
    "P5": (dict(dim=20, width=64, depth=5, method="DRM"), 100,
           {"fused": {"fused_drm_energy": 1}}),
    "P6": (dict(dim=2, width=64, depth=24, method="DRM"), 100,
           {"fused": {"fused_drm_energy": 1}}),
    "P7": (dict(dim=2, width=512, depth=5, critic_width=512, method="WAN"), 20,
           {"fused": WAN_PER_EPOCH}),
    "P8": (dict(dim=20, width=64, depth=5, critic_width=64, method="WAN"), 30,
           {"fused": WAN_PER_EPOCH}),
}
# the hybrid-kernel runs of P1-P3 (compute_dtype='hybrid-kernel': the
# bf16-dot bulk, 80% of the epochs, on rows 1, 2, 4, 5 bf16, the float32
# tail on the fp32 rows), each beside the float32 run of the same route and
# net above; P2h on 'fused' only (JAX has no 'pallas' hybrid at d > 6)
BEYOND_HYBRID = {"P1h": ("P1", ("fused", "fused_analytic", "kernel")),
                 "P2h": ("P2", ("fused",)),
                 "P3h": ("P3", ("fused", "kernel"))}
HYBRID_ROUTE_KERNELS = {"fused": ("fused_linear_residual",),
                        "fused_analytic": ("fused_poisson_analytic",),
                        "kernel": ("fwdlap_forward", "fwdlap_backward")}
# row 3 bf16 on P4's net: a fit of fused_drm_energy(dot_dtype='bfloat16')
# beside the same run in float32 (_b1_poisson_drm at width 512)
BEYOND_DRM_BF16 = ((2,) + (512,) * 4 + (1,), 200)
# the paths through train_ipw_2d (IPW2DConfig fields; state (3, 3), FN, the
# default 200^2 grid, chunk 1000), cut to these epochs, with each kernel's
# launches per epoch (the PINN's per step) on each route: Q1 the 16-bump
# WAN at width 512 with a critic as wide (else the critic's pair stays on
# the other kernels' shapes), Q2 the PINN at width 512 on both jet layouts,
# Q3 24 weight matrices (the PINN on the stream-major layout, the 16-bump
# WAN with the default critic)
BEYOND_U512 = (2,) + (512,) * 4 + (1,)
BEYOND_K24 = (2,) + (64,) * 23 + (1,)
BEYOND_EIGEN_PATHS = {
    "Q1": ("ipw2d-wan16-u512", dict(method="WAN", n_test_grid=4, layers=BEYOND_U512,
                                    v_layers=(2, 512, 512, 1)), 20,
           {"fused": EIGEN_WAN_PER_EPOCH}),
    "Q2": ("ipw2d-pinn-streams-u512", dict(method="PINN", weights={"data": 1e4},
                                           layers=BEYOND_U512), 50,
           {"kernel:streams": {"fwdlap_forward_streams": 1, "fwdlap_backward": 1},
            "kernel": {"fwdlap_forward": 1, "fwdlap_backward": 1}}),
    "Q3_pinn": ("ipw2d-k24", dict(method="PINN", weights={"data": 1e4}, layers=BEYOND_K24), 50,
                {"kernel:streams": {"fwdlap_forward_streams": 1, "fwdlap_backward": 1}}),
    "Q3_wan": ("ipw2d-k24", dict(method="WAN", n_test_grid=4, layers=BEYOND_K24,
                                 v_layers=EIGEN_V), 30,
               {"fused": EIGEN_WAN_PER_EPOCH}),
}
# what the bf16-dot modes of rows 7-12 are refused on a B7 net (each raises
# naming ROADMAP.md B7)
BEYOND_REFUSED = (2, 300, 300, 1)
# rows 1-5 in the bf16-dot mode (B7 item 4a: the tensor-core design on the
# same nets; row 4 takes d <= 16, JAX's _forward_kernel2 d <= 6)
BEYOND_BF16 = ("fused_linear_residual", "fused_poisson_analytic", "fused_drm_energy",
               "fwdlap_forward", "fwdlap_backward")
BEYOND_BF16_NAMES = tuple(k + ".bf16" for k in BEYOND_BF16)
# no tile of 8 points of the tensor-core design fits row 4 bf16's stages at
# d = 16 (row 4 bf16 refuses BEYOND_NOFIT's d = 20 naming JAX's limit)
BEYOND_NOFIT_FWD = (16, 512, 512, 512, 512, 1)


# timed: the P1 and P2 nets and P3's (2, 64 x 23, 1)
BEYOND_TIMED = {"u512": BEYOND_NETS["u512"], "d20": BEYOND_NETS["d20"],
                "k24": ((2,) + (64,) * 23 + (1,), "sin")}


def _beyond_case(kind, net, N, dev, seed, lap=0, Kb=EIGEN_BUMPS):
    layers, act = net
    if kind.startswith("fused"):
        return Case(kind, N, layers[0], layers, act, seed=seed, dev=dev)
    if kind == "fwdlap_forward" or kind.startswith(("linear", "quad")):
        return WanCase(kind, N, layers, act, seed=seed, dev=dev, lap=lap)
    return EigenCase(kind, N, layers, act, seed=seed, dev=dev, Kb=Kb)


def _beyond_plan(kind, layers, lap, N, dev, Kb=EIGEN_BUMPS):
    """The plan the wrapper of any beyond kernel took (after a launch)."""
    from nnpde_tpu_torch.kernels import fused_quotient as fq

    if kind.startswith("multi"):
        return _multibump_plan(kind, layers, Kb, N, dev)
    if kind.startswith("fwdlap_forward") or kind.endswith("sums"):
        return pass_a_plan(kind, layers, lap, N, dev)
    if kind.endswith("seeded"):
        return plan_row(kind, layers, layers[0] + 1 + lap, fq.plan(kind, layers, lap), N, dev)
    return fused_plan(kind, layers, N, dev)


def _beyond_leaves(case, kind, layers, out):
    """A beyond kernel's result (or its plain version's, same layout) as
    the list the bars compare: [loss, leaves...] (rows 1-3), [jet rows]
    (rows 4, 6), [sums] (rows 7, 9, 11), the gradient leaves (row 5; rows 8,
    10, 12 with sum ct_v last)."""
    if kind.startswith("fused"):
        loss, g = (out[0], out[2]) if len(out) == 3 else out
        return [loss.reshape(1)] + [t for p in g for t in p]
    if kind.startswith("fwdlap_forward") or kind.endswith("sums"):
        return [out]
    if kind.endswith("seeded"):
        P = out.numel() - 1
        return _leaf_split(out[:P], layers) + [out[P:]]
    return _leaf_split(out, layers)


def _hold_beyond(case, kind, layers, fp32_noise=False):
    """One beyond case launched twice against its float64 plain version:
    (got, again, ref, rel, excess) with ``rel`` the bar's measure: the loss
    and every gradient leaf (rows 1-3, 5, 8, 10; with sum ct_v for the
    seeded kinds) and every jet column (rows 4, 6) norm-relative, each
    pass-A sum over the sum of its terms' magnitudes (rows 7, 9, 11).
    ``fp32_noise`` (rows 3, 6-12): ``excess``, the largest distance of a
    loss, leaf, sum or jet column beyond twice the plain version's own
    float32 distance in the same measure (None without it)."""
    out = case.kernel()
    out2 = case.kernel()
    torch.cuda.synchronize()
    got, again = _beyond_leaves(case, kind, layers, out), _beyond_leaves(case, kind, layers, out2)
    ref = _beyond_leaves(case, kind, layers, case.plain(torch.float64))
    p32 = (_beyond_leaves(case, kind, layers, case.plain(torch.float32)) if fp32_noise
           else None)
    if kind.startswith("fwdlap_forward"):
        def cols(x):
            return [col_rel(x[0][:, c:c + 1], ref[0][:, c:c + 1]) for c in range(x[0].shape[1])]

        excess = (max(k - 2.0 * p for k, p in zip(cols(got), cols(p32))) if fp32_noise
                  else None)
        return got, again, ref, col_rel(out, ref[0]), excess
    if kind.endswith("sums"):
        terms = case.abs_terms()

        def dist(x):
            return torch.abs(x[0].double() - ref[0]) / terms

        excess = float(torch.max(dist(got) - 2.0 * dist(p32))) if fp32_noise else None
        return got, again, ref, float(torch.max(dist(got))), excess

    def rels(x):
        return [float(torch.linalg.norm(a.double() - b.double())
                      / max(float(torch.linalg.norm(b.double())), 1e-300))
                for a, b in zip(x, ref)]

    excess = (max(k - 2.0 * p for k, p in zip(rels(got), rels(p32))) if fp32_noise
              else None)
    return got, again, ref, max(rels(got)), excess


def _leaf_split(flat, layers):
    """A flat gradient row [dW0, db0, ...] as its leaves."""
    out, o = [], 0
    for a, b in zip(layers[:-1], layers[1:]):
        out += [flat[o:o + a * b], flat[o + a * b:o + a * b + b]]
        o += a * b + b
    return out


def phase_beyond_kernels(dev):
    """Every fp32 kernel (rows 7 and 8 with and without the Laplacian
    stream) on each BEYOND_NETS net at 1007 points and at the paths' 20000
    (rows 11 and 12: the 2D well's 40000, at 16 bumps, and at the cap of 42
    on the d = 20 net), against their float64 plain versions: the loss and
    every gradient leaf (with sum ct_v for rows 8, 10, 12) and every jet
    column rel <= 1e-5, each pass-A sum within 1e-5 of the sum of its
    terms' magnitudes (rows 3, 6-12: or within 1e-5 beyond twice the float32
    plain version's own distance in the same measure); two launches bitwise
    equal; row 6 bitwise row 4; each launch's design (DES_BEYOND on the nets
    that need it, for rows 1-3, 5, 8, 10, 12; rows 6, 11, 12 read the
    weights from device memory on the 512-wide net) and its plan.  Then
    BEYOND_NOFIT raises NoFit naming ROADMAP.md B7 in each of the twelve
    wrappers and the bf16-dot modes of rows 1-3, 5 (row 4 bf16 on
    BEYOND_NOFIT_FWD; on BEYOND_NOFIT it raises naming JAX's own limit of
    d), and on BEYOND_REFUSED the bf16-dot modes of rows 7-12 raise naming
    it (rows 1-5 bf16: phase_beyond_bf16_kernels)."""
    from nnpde_tpu_torch.kernels import _cuda, _plan
    from nnpde_tpu_torch.kernels import fused_multibump as fm
    from nnpde_tpu_torch.kernels import fused_quotient as fq
    from nnpde_tpu_torch.kernels import fused_step as fs
    from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

    t0 = time.time()
    rows, max_err = [], {}
    # (kernel, lap, seed, point counts)
    kinds = [(k, 0, 700 + i, (1007, BEYOND_N)) for i, k in enumerate(BEYOND_KERNELS)]
    kinds += [(k, lap, 740 + i, (1007, BEYOND_N)) for i, (k, lap) in enumerate(BEYOND_Q_KINDS)]
    kinds += [(k, 0, 780 + i, (1007, BEYOND_N if k.startswith("fwd") else EIGEN_N))
              for i, k in enumerate(BEYOND_E_KINDS)]
    cases = [(net, kind, lap, seed, EIGEN_BUMPS, N) for net in BEYOND_NETS
             for kind, lap, seed, Ns in kinds for N in Ns]
    # the K-bump pair at the cap of 42 bumps on the d = 20 net
    cases += [("d20", kind, 0, 790 + i, fm.MAX_BUMPS, EIGEN_N)
              for i, kind in enumerate(BEYOND_E_KINDS[1:])]
    for net, kind, lap, seed, Kb, N in cases:
        layers, act = BEYOND_NETS[net]
        case = _beyond_case(kind, (layers, act), N, dev, seed=seed, lap=lap, Kb=Kb)
        with _cuda.capture() as cap:
            case.kernel()
        designs = sorted({args[DES_ARG[fn.__name__]] for _, fn, args, _, _ in cap.calls})
        new = kind not in BEYOND_KERNELS
        got, again, ref, rel, excess = _hold_beyond(case, kind, layers, fp32_noise=new)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        err = max(float(torch.max(torch.abs(a.double() - b.double())))
                  for a, b in zip(got, ref))
        max_err[kind] = max(max_err.get(kind, 0.0), err)
        beyond = (not kind.startswith("fwdlap_forward") and not kind.endswith("sums")
                  and _cuda.beyond(layers))
        plan = _beyond_plan(kind, layers, lap, N, dev, Kb)
        # rows 3, 6-12: within 1e-5, or within 1e-5 beyond twice the plain
        # version's own float32 distance from float64 in the same leaf, sum
        # or column (the port's rule against a witness where the float32
        # result itself is off: a deep net's leaves sum terms that cancel;
        # on K24 at 1007 points the float32 plain version of row 8 is 1.1e-5
        # from float64 in one leaf on an H100, 2.1e-5 on the CPU, the kernel
        # 2.4e-5)
        close = rel <= 1e-5 or (excess is not None and excess <= 1e-5)
        row = {"kernel": kind, "lap": lap, "net": net, "N": N, "layers": list(layers),
               "act": act, "plan": plan, "designs": designs, "rel": rel,
               "rel_beyond_plain_fp32": excess, "max_abs_err": err,
               "bitwise_repeat": bitwise}
        ok = (close and bitwise and len(designs) == 1
              and bool(designs[0] & _cuda.DES_BEYOND) == beyond)
        if kind in BEYOND_E_KINDS:
            row["n_bumps"] = Kb if kind.startswith("multi") else None
            # the weights from device memory where no staging matrix fits
            row["device_weights"] = bool(designs and designs[0] & _cuda.DES_DEVW)
            ok = ok and row["device_weights"] == (max(layers[1:-1]) > 256)
        if kind == "fwdlap_forward_streams":
            # row 6 is row 4's kernel on row 4's plan with its stream-major
            # write: the same floats
            row["equals_rows"] = bool(torch.equal(
                got[0], fc.fwdlap_forward(case.params, case.X, case.act)))
            ok = ok and row["equals_rows"]
        row["ok"] = bool(ok)
        rows.append(row)
        del case, got, again, ref
        torch.cuda.empty_cache()
    # what still raises
    raised = {}
    rng = np.random.default_rng(710)
    for name, layers in (("nofit", BEYOND_NOFIT), ("nofit_fwd", BEYOND_NOFIT_FWD),
                         ("refused", BEYOND_REFUSED)):
        d, N = layers[0], 64
        p = rand_params(rng, layers, dev)
        X = torch.rand(N, d, device=dev)
        coef = torch.zeros(N, d + 4, device=dev)
        lin, quad = torch.zeros(N, d + 5, device=dev), torch.zeros(N, d + 3, device=dev)
        drm, ct = torch.zeros(N, d + 2, device=dev), torch.zeros(N, d + 2, device=dev)
        multi, seeds = torch.zeros(N, 4 * (d + 4), device=dev), (torch.zeros(4, device=dev),) * 3
        scal_l, scal_q = (0.3, -0.2, 0.7), (0.4, -0.3)
        bf = dict(dot_dtype="bfloat16")
        if name == "nofit_fwd":
            # (row 4 bf16 on BEYOND_NOFIT raises naming JAX's limit, below)
            calls = {"fwdlap_forward.bf16": lambda: fc.fwdlap_forward(p, X, "sin",
                                                                      "rows:default")}
        elif name == "nofit":
            calls = {
                "fused_linear_residual": lambda: fs.fused_linear_residual(p, X, coef, "sin"),
                "fused_poisson_analytic": lambda: fs.fused_poisson_analytic(
                    p, X, "sin", L=L, ks=(1,) * d),
                "fused_drm_energy": lambda: fs.fused_drm_energy(p, X, drm, "sin"),
                "fwdlap_forward": lambda: fc.fwdlap_forward(p, X, "sin"),
                "fwdlap_backward": lambda: fc.fwdlap_backward(p, X, ct, "sin"),
                "quad_sums": lambda: fq.fused_quad_sums(p, X, quad, "sin"),
                "quad_seeded": lambda: fq.fused_quad_seeded_grads(p, X, quad, scal_q, "sin"),
                "fwdlap_forward_streams": lambda: fc.fwdlap_forward(p, X, "sin", "streams"),
                "multi_sums": lambda: fm.fused_multi_sums(p, X, multi, "sin", 4),
                "multi_seeded": lambda: fm.fused_multi_seeded_grads(p, X, multi, seeds, "sin",
                                                                    4),
                # rows 1-3 and 5 bf16 (no tile of 8 points fits)
                "fused_linear_residual.bf16": lambda: fs.fused_linear_residual(
                    p, X, coef, "sin", **bf),
                "fused_poisson_analytic.bf16": lambda: fs.fused_poisson_analytic(
                    p, X, "sin", L=L, ks=(1,) * d, **bf),
                "fused_drm_energy.bf16": lambda: fs.fused_drm_energy(p, X, drm, "sin", **bf),
                "fwdlap_backward.bf16": lambda: fc.fwdlap_backward(p, X, ct, "sin", "bfloat16"),
                # row 4 bf16 takes d <= 16: JAX's _forward_kernel2 limit, not B7
                "jaxlimit:fwdlap_forward.bf16": lambda: fc.fwdlap_forward(p, X, "sin",
                                                                          "rows:default")}
            for no_lap in (False, True):
                tag = ":no_lap" if no_lap else ""
                calls["linear_sums" + tag] = lambda no_lap=no_lap: fq.fused_linear_sums(
                    p, X, lin, "sin", no_lap=no_lap)
                calls["linear_seeded" + tag] = lambda no_lap=no_lap: fq.fused_seeded_grads(
                    p, X, lin, scal_l, "sin", no_lap=no_lap)
        else:
            calls = {
                "linear_sums.bf16": lambda: fq.fused_linear_sums(p, X, lin, "sin", no_lap=True,
                                                                 **bf),
                "linear_seeded.bf16": lambda: fq.fused_seeded_grads(p, X, lin, scal_l, "sin",
                                                                    no_lap=True, **bf),
                "quad_sums.bf16": lambda: fq.fused_quad_sums(p, X, quad, "sin", **bf),
                "quad_seeded.bf16": lambda: fq.fused_quad_seeded_grads(p, X, quad, scal_q,
                                                                       "sin", **bf),
                "multi_sums.bf16": lambda: fm.fused_multi_sums(p, X, multi, "sin", 4, **bf),
                "multi_seeded.bf16": lambda: fm.fused_multi_seeded_grads(p, X, multi, seeds,
                                                                         "sin", 4, **bf)}
        for kind, call in calls.items():
            before = dict(_cuda.LAUNCHES)
            try:
                call()
                msg, typ = None, None
            except ValueError as e:
                msg, typ = str(e), type(e).__name__
            raised[f"{name}:{kind}"] = {
                "raised": typ, "names_b7": bool(msg and _cuda.BEYOND_ITEM in msg),
                "names_jax_limit": bool(msg and "_forward_kernel2" in msg),
                "nofit": typ == _plan.NoFit.__name__, "launched": _cuda.LAUNCHES != before}
    raised_ok = all(not v["launched"] and (
        v["names_jax_limit"] and not v["names_b7"] if "jaxlimit" in k
        else v["names_b7"] and (v["nofit"] or k.startswith("ref"))) for k, v in raised.items())
    ok = all(r["ok"] for r in rows) and raised_ok
    emit({"phase": "beyond_kernels", "phase_s": time.time() - t0, "tol": 1e-5, "rows": rows,
          "raised": raised, "raised_ok": raised_ok, "ok": ok})
    if not ok:
        raise SystemExit("beyond kernel vs plain comparison failed")
    return max_err


def _bf16_beyond_case(base, layers, act, N, dev, seed):
    """A bf16-dot case of rows 1-5 on a beyond net (row 3 through
    :class:`B1Case`, the others :class:`PrecCase`)."""
    if base == "fused_drm_energy":
        return B1Case(base, N, layers, act, seed, dev)
    return PrecCase(base, N, layers, act, seed=seed, dev=dev)


def bf16_order_variants(case, base):
    """The plain bf16-dot version of ``case`` in other sound fp32 rounding
    orders, each in the original net's layout: on the net with its hidden
    units permuted (C2's spread: every product's sum in another order), and
    for rows 1-3 and 5 with the reverse nonlinearity's sum in each order of
    ``ops.fwdlap.DV_ORDERS`` (the CUDA kernels' own and the JAX kernels',
    which the permutation does not reach); row 2 also with its coefficients
    rounded once from float64 (``fused_step.ANALYTIC_ORDERS``' "coef64":
    the in-kernel builder's float32 products of d factors).  Their largest
    distance from the plain version is its spread, on which rows 1-5
    bf16's bars beyond rest (ROADMAP.md C)."""
    from nnpde_tpu_torch.kernels import fused_step as fs
    from nnpde_tpu_torch.ops.fwdlap import DV_ORDERS

    keep = case.params
    moved, back = permuted(keep, case.layers, 23)
    case.params = moved
    try:
        got = case.plain("bfloat16")
    finally:
        case.params = keep
    if base == "fwdlap_forward":
        return {"permuted": got}                 # the jet rows do not move
    lo = 0 if base == "fwdlap_backward" else 1
    out = {"permuted": got[:lo] + back(got[lo:])}
    orders = fs.ANALYTIC_ORDERS if base == "fused_poisson_analytic" else DV_ORDERS
    out.update({o: case.plain("bfloat16", order=o) for o in orders})
    return out


def phase_beyond_bf16_kernels(dev):
    """Rows 1-5 bf16 (ROADMAP.md B7 item 4a) on each BEYOND_NETS net (row 4
    where d <= 16) at 1007 and at the paths' 20000 points, against their
    plain bf16-dot versions: the loss and every gradient leaf (row 4: every
    jet column) within C2's bar, max(1e-4, 4.2 x the plain version's own
    spread over sound rounding orders, bf16_order_variants, measured here);
    no further from the float64 witness than the larger of 2x the plain
    version + 2e-6 and the plain version + C4_SPREAD_MULTIPLE x that spread
    (C4's form, row 4 by ``fwdlap_cuda.c4_columns`` itself), the variants'
    own distances from the witness reported beside; two launches bitwise
    equal, each counted under its ``.bf16`` name; the plan (``DES_BEYOND``
    on rows 1-3 exactly where ``_cuda.beyond``) and the launch's design."""
    from nnpde_tpu_torch.kernels import _cuda
    from nnpde_tpu_torch.kernels import fused_step as fs
    from nnpde_tpu_torch.kernels import fwdlap_cuda as fc

    t0 = time.time()
    rows, max_err = [], {}
    for net, (layers, act) in BEYOND_NETS.items():
        for i, base in enumerate(BEYOND_BF16):
            if base == "fwdlap_forward" and layers[0] > 16:
                continue
            name = base + ".bf16"
            for N in (1007, BEYOND_N):
                case = _bf16_beyond_case(base, layers, act, N, dev, 800 + i)
                with _cuda.capture() as cap:
                    out = case.kernel("bfloat16")
                designs = sorted({args[DES_ARG[fn.__name__]] for _, fn, args, _, _ in cap.calls})
                names = [c[0] for c in cap.calls]
                del cap
                out2 = case.kernel("bfloat16")
                torch.cuda.synchronize()
                bitwise = all(torch.equal(a, b) for a, b in zip(out, out2))
                ref = case.plain("bfloat16")
                wit = case.plain("bfloat16", torch.float64)
                variants = bf16_order_variants(case, base)
                spread = max(case.rel(v, ref) for v in variants.values())
                bar = max(PREC_TOL, WIDE_SPREAD_MULTIPLE * spread)
                rel = case.rel(out, ref)
                w_kernel, w_plain = case.rel(out, wit), case.rel(ref, wit)
                w_bar = max(2.0 * w_plain + 2e-6, w_plain + fc.C4_SPREAD_MULTIPLE * spread)
                err = max(float(torch.max(torch.abs(a.double() - b.double())))
                          for a, b in zip(out, ref))
                max_err[name] = max(max_err.get(name, 0.0), err)
                pl = fs.mma_plan(base, list(layers))
                des = fs.mma_des(list(layers), pl.flags, pl.design)
                beyond = base.startswith("fused") and _cuda.beyond(layers)
                row = {"kernel": name, "net": net, "N": N, "layers": list(layers), "act": act,
                       "plan": (bf16_forward_plan(layers, N, dev) if base == "fwdlap_forward"
                                else fused_plan(base, layers, N, dev, True)),
                       "designs": designs, "launch_names": names, "rel": rel,
                       "spread": spread, "bar": bar,
                       "spread_by": {k: case.rel(v, ref) for k, v in variants.items()},
                       "witness_rel_kernel": w_kernel, "witness_rel_plain": w_plain,
                       "witness_rel_variants": {k: case.rel(v, wit) for k, v in variants.items()},
                       "witness_bar": w_bar, "max_abs_err": err, "bitwise_repeat": bitwise}
                if base == "fwdlap_forward":
                    row["c4_columns"] = fc.c4_columns(case.params, case.X, act, out[0])
                    witness_ok = all(c["kernel"] <= c["bar"] for c in row["c4_columns"])
                else:
                    witness_ok = w_kernel <= w_bar
                    # the leaf furthest from the plain version ([loss, dW0, db0, ...]
                    # or [dW0, db0, ...])
                    leaf = [case.rel([a], [b]) for a, b in zip(out, ref)]
                    row["worst_leaf"] = int(np.argmax(leaf))
                row["ok"] = bool(rel <= bar and witness_ok and bitwise and designs == [des]
                                 and names == [name] and pl.design & _cuda.DES_MMA
                                 and bool(pl.design & _cuda.DES_BEYOND) == beyond)
                rows.append(row)
                del case, out, out2, ref, wit, variants
                torch.cuda.empty_cache()
    ok = all(r["ok"] for r in rows)
    emit({"phase": "beyond_bf16_kernels", "phase_s": time.time() - t0,
          "spread_multiple": WIDE_SPREAD_MULTIPLE, "rows": rows, "ok": ok})
    if not ok:
        raise SystemExit("beyond bf16-dot kernel vs plain comparison failed")
    return max_err


def phase_beyond_path():
    """BEYOND_PATHS through ``train_poisson_nd`` as users call it (box-FBC,
    prod-sin RHS, 20000 points, Adam 1e-3, seed 0), each route against the
    'torch' route's run of the same configuration in this call: the first
    total within 1e-5 (relative), finite, each kernel launched exactly its
    count per step (per epoch on the WAN); the PINN and DRM final rel_l2 <=
    max(2 x torch's, 1e-3); the WAN the cut WAN paths' gate (the first 10
    totals within 5e-2, the first pde loss within 1e-3, every run's best
    eval below its first).  Then BEYOND_HYBRID in
    ``compute_dtype='hybrid-kernel'``: each run finite, its rel_l2 below its
    first eval's and <= max(2 x the float32 run of the same route and net
    here, 1e-3), 'fused' and 'kernel' within 2x of each other (1e-3 floor),
    the bf16-dot kernels launched once per bulk epoch and the fp32 ones once
    per tail epoch, exactly; and row 3 bf16 on BEYOND_DRM_BF16's net
    (``fused_drm_energy(dot_dtype='bfloat16')`` under ``fit``, beside the
    same run in float32): launches exact, rel_l2 below its first and <=
    max(2 x float32's, 1e-3).  Returns the kernels' launches over the paths
    (``launches_beyond``)."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.problems import PoissonConfig, train_poisson_nd

    t0 = time.time()
    report, ok = {"phase": "beyond_path"}, True
    launches = dict.fromkeys(BEYOND_P_KINDS + BEYOND_BF16_NAMES, 0)
    fp32 = {}
    for name, (shape, epochs, routes) in BEYOND_PATHS.items():
        base = dict(method="PINN", bc_mode="FBC", epochs=epochs, n_interior=BEYOND_N,
                    chunk=1000)
        base.update(shape)
        wan = base["method"] == "WAN"
        runs = {}
        for route in ("torch",) + tuple(routes):
            kw = ({"jet_impl": "fused", "coef_mode": "analytic"} if route == "fused_analytic"
                  else {"jet_impl": route})
            reset_launches()
            t1 = time.time()
            r = train_poisson_nd(PoissonConfig(**kw, **base))
            wall = time.time() - t1
            counts = {k: v for k, v in LAUNCHES.items() if v}
            runs[route] = (r, counts, wall)
        ref = runs["torch"][0]
        rows = {}
        for route, (r, counts, wall) in runs.items():
            h, hr = r["history"], ref["history"]
            total0 = float(h["total"][0])
            want = {k: n * epochs for k, n in routes.get(route, {}).items()}
            first, first10 = _first_band(ref, r)
            finite = all(np.all(np.isfinite(h[k])) for k in h if k in ("total", "l2", "pde"))
            row = {"method": base["method"], "epochs": epochs, "rel_l2": r["rel_l2"],
                   "total0": total0, "total0_rel": first, "launches": counts, "want": want,
                   "wall_s": wall, "steps_per_s": _rate(r), "finite": finite}
            good = finite and first <= 1e-5 and counts == want
            if wan:
                pde0 = float(abs(h["pde"][0] - hr["pde"][0]) / abs(hr["pde"][0]))
                falling = bool(np.min(h["l2"]) < h["l2"][0])
                row.update(first10_max_rel=first10, pde0_rel=pde0, falling=falling,
                           l2_first=float(h["l2"][0]), l2_best=float(np.min(h["l2"])))
                good = good and first10 <= 5e-2 and pde0 <= 1e-3 and falling
            else:
                good = good and r["rel_l2"] <= max(2.0 * ref["rel_l2"], 1e-3)
            row["ok"] = bool(good)
            ok = ok and row["ok"]
            for k, n in counts.items():
                if k in launches:
                    launches[k] += n
            rows[route] = row
            fp32[name, route] = r["rel_l2"]
        report[name] = {"config": shape, "routes": rows}

    # the hybrid-kernel runs, beside the float32 ones above
    for name, (src, routes) in BEYOND_HYBRID.items():
        shape, epochs, _ = BEYOND_PATHS[src]
        bulk = int(epochs * PoissonConfig().hybrid_bf16_fraction)
        rows = {}
        for route in routes:
            kw = ({"jet_impl": "fused", "coef_mode": "analytic"} if route == "fused_analytic"
                  else {"jet_impl": route})
            reset_launches()
            t1 = time.time()
            r = train_poisson_nd(PoissonConfig(
                **kw, **shape, method="PINN", bc_mode="FBC", epochs=epochs,
                n_interior=BEYOND_N, chunk=1000, compute_dtype="hybrid-kernel"))
            wall = time.time() - t1
            counts = {k: v for k, v in LAUNCHES.items() if v}
            want = {k + sfx: n for k in HYBRID_ROUTE_KERNELS[route]
                    for sfx, n in ((".bf16", bulk), ("", epochs - bulk))}
            # (the rms of the manufactured solution, _report's: 2^(-d/2))
            first = float(r["history"]["l2"][0]) / 0.5 ** (shape["dim"] / 2.0)
            finite = bool(np.all(np.isfinite(r["history"]["total"])))
            gate = max(2.0 * fp32[src, route], 1e-3)
            row = {"epochs": epochs, "bulk": bulk, "rel_l2": r["rel_l2"], "rel_l2_first": first,
                   "rel_l2_fp32": fp32[src, route], "gate": gate, "launches": counts,
                   "want": want, "wall_s": wall, "steps_per_s": _rate(r),
                   "bulk_steps_per_s": r["result"].timing["bulk_steps_per_s"],
                   "tail_steps_per_s": r["result"].timing["tail_steps_per_s"],
                   "finite": finite}
            row["ok"] = bool(finite and r["rel_l2"] < first and r["rel_l2"] <= gate
                             and counts == want)
            for k, n in counts.items():
                if k in launches:
                    launches[k] += n
            rows[route] = row
        if "kernel" in rows:
            f, k = rows["fused"]["rel_l2"], rows["kernel"]["rel_l2"]
            rows["routes_agree"] = bool(k <= max(2.0 * f, 1e-3) and f <= max(2.0 * k, 1e-3))
        good = all(v["ok"] for v in rows.values() if isinstance(v, dict))
        report[name] = {"config": dict(shape, compute_dtype="hybrid-kernel"), "routes": rows,
                        "ok": bool(good and rows.get("routes_agree", True))}
        ok = ok and report[name]["ok"]

    # row 3 bf16 on P4's net under fit, beside float32
    layers, epochs = BEYOND_DRM_BF16
    dev = torch.device("cuda")
    runs = {}
    for dot in ("float32", "bfloat16"):
        reset_launches()
        t1 = time.time()
        r = _b1_poisson_drm(dev, dot, layers, epochs)
        torch.cuda.synchronize()
        runs[dot] = dict(r, wall_s=time.time() - t1,
                         launches={k: v for k, v in LAUNCHES.items() if v})
    b, f = runs["bfloat16"], runs["float32"]
    gate = max(2.0 * f["metric"], 1e-3)
    drm = {"layers": list(layers), "epochs": epochs, "metric_bf16": b["metric"],
           "metric_fp32": f["metric"], "first_bf16": b["first"], "gate": gate,
           "launches": b["launches"], "launches_fp32": f["launches"],
           "steps_per_s": b["result"].timing["steps_per_s"],
           "fp32_steps_per_s": f["result"].timing["steps_per_s"],
           "wall_s": b["wall_s"] + f["wall_s"]}
    drm["ok"] = bool(math.isfinite(b["metric"]) and b["metric"] <= gate
                     and b["metric"] < b["first"]
                     and b["launches"] == {"fused_drm_energy.bf16": epochs}
                     and f["launches"] == {"fused_drm_energy": epochs})
    launches["fused_drm_energy.bf16"] += b["launches"].get("fused_drm_energy.bf16", 0)
    report["drm_bf16_u512"] = drm
    ok = ok and drm["ok"]
    report["launches_beyond"] = launches
    report["ok"] = bool(ok and all(launches.values()))
    report["phase_s"] = time.time() - t0
    emit(report)
    if not report["ok"]:
        raise SystemExit("beyond path check failed")
    return launches


def phase_beyond_eigen_path():
    """BEYOND_EIGEN_PATHS through ``train_ipw_2d`` as users call it (state
    (3, 3), FN, the 200^2 grid, chunk 1000, the JAX package's initial
    weights for seed 0), each route against the 'torch' route's run of the
    same configuration in this call, each kernel launched exactly its count
    per epoch.  The WAN (Q1, Q3): the first total within 1e-5 (relative),
    the first 10 within 5e-2, the first weak-form term within 1e-3, every
    history finite, both runs' best L2 error below their first.  The PINN
    (Q2, Q3): the first total within 1e-5 of 'torch's (and of 'kernel's:
    rows 4 and 6 run the same arithmetic), finite, the final rel_l2 <=
    max(2 x torch's, 1e-3) or the best L2 error below the first.  Returns
    the beyond kernels' launches over the paths (``launches_beyond``; rows
    6, 11 and 12 must be among them)."""
    from nnpde_tpu_torch.kernels import LAUNCHES, reset_launches
    from nnpde_tpu_torch.problems import IPW2DConfig, train_ipw_2d

    t0 = time.time()
    report, launches, ok = {"phase": "beyond_eigen_path"}, dict.fromkeys(BEYOND_ALL, 0), True
    base = dict(nx=3, ny=3, technique="FN", chunk=1000)
    for name, (cell, shape, epochs, routes) in BEYOND_EIGEN_PATHS.items():
        wan = shape["method"] == "WAN"
        runs = {}
        for route in ("torch",) + tuple(routes):
            reset_launches()
            t1 = time.time()
            r = train_ipw_2d(IPW2DConfig(jet_impl=route, epochs=epochs, **base, **shape))
            runs[route] = (r, {k: v for k, v in LAUNCHES.items() if v}, time.time() - t1)
        ref = runs["torch"][0]
        rows = {}
        for route, (r, counts, wall) in runs.items():
            h, hr = r["history"], ref["history"]
            want = {k: n * epochs for k, n in routes.get(route, {}).items()}
            first, first10 = _first_band(ref, r)
            keys = ("total", "l2", "pde") + (("wan_loss_v",) if wan else ())
            finite = all(np.all(np.isfinite(h[k])) for k in keys)
            falling = bool(r["L2_error"] < h["l2"][0])
            row = {"rel_l2": r["rel_l2"], "rel_l2_first": _rel_l2_first(r),
                   "total0": float(h["total"][0]), "total0_rel": first,
                   "first10_max_rel": first10, "finite": finite, "falling": falling,
                   "launches": counts, "want": want, "wall_s": wall,
                   "epochs_per_s": r["result"].timing["steps_per_s"]}
            good = finite and first <= 1e-5 and counts == want
            if wan:
                pde0 = float(abs(h["pde"][0] - hr["pde"][0]) / abs(hr["pde"][0]))
                row["pde0_rel"] = pde0
                good = good and first10 <= 5e-2 and pde0 <= 1e-3 and falling
            else:
                if "kernel" in runs:
                    k0 = float(runs["kernel"][0]["history"]["total"][0])
                    row["total0_rel_vs_kernel"] = abs(float(h["total"][0]) - k0) / abs(k0)
                    good = good and row["total0_rel_vs_kernel"] <= 1e-5
                good = good and (r["rel_l2"] <= max(2.0 * ref["rel_l2"], 1e-3) or falling)
            row["ok"] = bool(good)
            ok = ok and row["ok"]
            for k, n in counts.items():
                if k in launches:
                    launches[k] += n
            rows[route] = row
        report[name] = {"cell": cell, "method": shape["method"], "epochs": epochs,
                        "layers": list(shape["layers"]),
                        "v_layers": list(shape.get("v_layers", ())) or None, "routes": rows}
    report["launches_beyond"] = launches
    report["ok"] = bool(ok and all(launches[k] for k in BEYOND_E_KINDS))
    report["phase_s"] = time.time() - t0
    emit(report)
    if not report["ok"]:
        raise SystemExit("beyond eigen path check failed")
    return launches


def phase_beyond_timing(dev):
    """Every fp32 kernel (rows 7 and 8 without the Laplacian stream, as the
    WAN runs them; rows 11 and 12 at 16 bumps) on the P1, P2 and P3 nets
    (BEYOND_TIMED) at the paths' points (20000; row 6 also at 40000, rows
    11 and 12 at the 2D well's 40000, and on Q1's (2, 512, 512, 1) critic
    there and at 262144) and at 262144 (not on the P1 net); then rows 1-5 bf16 on the
    same nets (row 4 not at d = 20) at 20000 and 262144: wrapper and device
    ms, the plan (tier, T, blocks per SM), the bound (max(FLOP / 67 TFLOP/s,
    bytes / 3.35 TB/s), the table's FLOP rules; the bf16 rows' FLOP at the
    tensor cores' 989 TFLOP/s, with the CUDA cores' bound beside it) and
    the plain version's ms (None where the plain version's autograd does
    not fit the card's memory)."""
    t0 = time.time()
    rows = []
    kinds = [(k, 720 + i, (BEYOND_N, 262144)) for i, k in enumerate(BEYOND_KERNELS)]
    kinds += [(k, 760 + i, (BEYOND_N, 262144) if k.startswith(("fused", "linear", "quad"))
               else (BEYOND_N, EIGEN_N, 262144) if k.startswith("fwd") else (EIGEN_N, 262144))
              for i, k in enumerate(BEYOND_ALL[len(BEYOND_KERNELS):])]
    # the fp32 rows on u512 at 262144 points (0.1-0.5 s a launch) were timed
    # in PRs 20-22 and are cut for the run's clock (PERF.md section 4)
    cells = [(net, net_act, kind, seed, N) for net, net_act in BEYOND_TIMED.items()
             for kind, seed, Ns in kinds for N in Ns if not (net == "u512" and N > EIGEN_N)]
    cells += [("c512", ((2, 512, 512, 1), "sin"), kind, 766 + i, N)
              for i, kind in enumerate(BEYOND_E_KINDS[1:]) for N in (EIGEN_N, 262144)]
    for net, (layers, act), kind, seed, N in cells:
        big = N > 100000
        case = _beyond_case(kind, (layers, act), N, dev, seed=seed)
        flops, nbytes = case.flops(), case.bytes()
        # a launch on u512 at 262144 takes ~0.1-1 s: few timed calls
        slow = big and macs(layers) > 200000
        ms = time_ms(case.kernel, warmup=1 if slow else 2,
                     reps=1 if slow else 5 if big else 15)
        dev_ms = device_ms(case.kernel, launches=2 if slow else 5 if big else 30,
                           reps=1 if slow else 3 if big else 5, warm=1 if slow else 3)
        try:
            plain_ms = time_ms(lambda: case.plain(torch.float32), warmup=1,
                               reps=1 if slow else 3 if big else 7)
        except torch.cuda.OutOfMemoryError:
            plain_ms = None
        torch.cuda.empty_cache()
        plan = _beyond_plan(kind, layers, 0, N, dev)
        row = {"kernel": kind, "net": net, "d": layers[0], "N": N, "plan": plan,
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "bound_ms": 1e3 * max(flops / FP32_PEAK, nbytes / HBM_RATE),
               "bound_by": ("operations" if flops / FP32_PEAK
                            >= nbytes / HBM_RATE else "bytes"),
               "flop": flops, "bytes": nbytes}
        if kind.startswith("multi"):
            row["n_bumps"] = case.Kb
        rows.append(row)
        del case
        torch.cuda.empty_cache()
    # rows 1-5 bf16 on the same nets (row 4 not at d = 20): both bounds,
    # the tensor cores' and the CUDA cores'
    for net, (layers, act) in BEYOND_TIMED.items():
        for i, base in enumerate(BEYOND_BF16):
            if base == "fwdlap_forward" and layers[0] > 16:
                continue
            for N in (BEYOND_N, 262144):
                big = N > 100000
                slow = big and macs(layers) > 200000
                case = _bf16_beyond_case(base, layers, act, N, dev, 830 + i)
                run = lambda: case.kernel("bfloat16")
                ms = time_ms(run, warmup=1 if slow else 2, reps=1 if slow else 5 if big else 15)
                dev_ms = device_ms(run, launches=2 if slow else 5 if big else 30,
                                   reps=1 if slow else 3 if big else 5, warm=1 if slow else 3)
                try:
                    plain_ms = time_ms(lambda: case.plain("bfloat16"), warmup=1,
                                       reps=1 if slow else 3 if big else 7)
                except torch.cuda.OutOfMemoryError:
                    plain_ms = None
                torch.cuda.empty_cache()
                bound, by = case.bound(BF16_PEAK)
                rows.append({
                    "kernel": base + ".bf16", "net": net, "d": layers[0], "N": N,
                    "plan": (bf16_forward_plan(layers, N, dev) if base == "fwdlap_forward"
                             else fused_plan(base, layers, N, dev, True)),
                    "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by, "bound_cuda_core_ms": case.bound(FP32_PEAK)[0],
                    "flop": case.flops(), "bytes": case.bytes()})
                del case
                torch.cuda.empty_cache()
    emit({"phase": "beyond_timing", "phase_s": time.time() - t0, "rows": rows})
    return rows


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
E1_EPOCHS = 100                # of 3000 (ipw1d) and 10000 (qho1d); 200 to PR 19
E1_WAN_EPOCHS = 80             # of 3000 (ipw1d WAN) and 30000 (qho1d WAN)
# of the L-BFGS rows' 3000 iterations: run to 3000 on an H100,
# qho1d_n2_pinn_fn_lbfgs had its best at iteration 831 and
# qho1d_n0_drm_fn_lbfgs reached 5.9e-11, against the 1e-5 bar (PERF.md)
E1_LBFGS_ITERS = 1000


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
    * the L-BFGS rows of ACCEPTANCE.json, E1_LBFGS_ITERS of their 3000
      iterations (``lbfgs_mode='replace'``): qho1d_n0_drm_fn_lbfgs on
      'fused', qho1d_n2_pinn_fn_lbfgs on 'kernel';
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
    # ---- the L-BFGS rows, cut (L-BFGS in place of Adam)
    for entry, impl, method, n, kern in (
            ("qho1d_n0_drm_fn_lbfgs", "fused", "DRM", 0, ("quad_sums", "quad_seeded")),
            ("qho1d_n2_pinn_fn_lbfgs", "kernel", "PINN", 2,
             ("fwdlap_forward", "fwdlap_backward"))):
        out, counts, wall = run(train_qho_1d, QHO1DConfig(
            n=n, method=method, technique="FN", epochs=0, LBFGS=True, lbfgs_mode="replace",
            lbfgs_iters=E1_LBFGS_ITERS, jet_impl=impl))
        t = out["result"].timing
        # one value and gradient per line-search evaluation and at the start,
        # and the loss alone once more where the fit converged before the end
        done = int(t["iterations"] < E1_LBFGS_ITERS)
        want = {kern[0]: 1 + t["evaluations"] + done, kern[1]: 1 + t["evaluations"]}
        row = {"iterations": t["iterations"], "cut_from": 3000,
               "evaluations": t["evaluations"],
               "host_syncs": t["host_syncs"],
               "host_syncs_per_iteration": t["host_syncs"] / max(t["iterations"], 1),
               "best_mse": out["L2_error"], "best_iteration": out["min_epoch"],
               "acceptance_best_mse": {"qho1d_n0_drm_fn_lbfgs": 2.868810050626891e-11,
                                       "qho1d_n2_pinn_fn_lbfgs": 1.454312403836866e-08}[entry],
               "wall_s": wall, "iterations_per_s": t["steps_per_s"], "launches": counts}
        row["ok"] = bool(finite(out) and out["L2_error"] <= 1e-5 and counts == want
                         and out["history"]["total"].shape == (E1_LBFGS_ITERS,))
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
# cut from 300 / 300 / 150 and 300 / 300 / 200 in PR 20 for the run's clock
Q2_EPOCHS = 150               # of 10000 (QHO2DConfig) and 50000 (the paper sweep)
Q2_DRM_EPOCHS = 150
Q2_WAN_EPOCHS = 100
KH_EPOCHS = 150               # of 10000 (kh1d_alpha10_pinn)
KH_DRM_EPOCHS = 150           # of 5000 (kh1d_alpha10_*_dense)
KH_WAN_EPOCHS = 100


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
    * ``qho1d_n0_drm_fn_lbfgs``: ``train_qho_1d`` (n = 0, DRM, FN) with
      L-BFGS in place of Adam for its full 3000 iterations: best MSE <= 1e-5;
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
    # the L-BFGS acceptance row at its full 3000 iterations (the default run's
    # eigen1d group takes E1_LBFGS_ITERS of them)
    from nnpde_tpu_torch.problems import QHO1DConfig, train_qho_1d

    out, counts, wall = _run_counted(train_qho_1d, QHO1DConfig(
        n=0, method="DRM", technique="FN", epochs=0, LBFGS=True, lbfgs_mode="replace",
        lbfgs_iters=3000, jet_impl=route))
    t = out["result"].timing
    record("qho1d_n0_drm_fn_lbfgs", {
        "best_mse": out["L2_error"], "best_iteration": out["min_epoch"],
        "iterations": t["iterations"], "evaluations": t["evaluations"], "wall_s": wall,
        "iterations_per_s": t["steps_per_s"], "launches": counts,
        "acceptance_best_mse": 2.868810050626891e-11, "target": "best_mse <= 1e-5",
        "pass": bool(out["L2_error"] <= 1e-5 and _finite(out))})
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
        if name in ("main", "wide"):
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
PROBE_RUN_EPOCHS = 20


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
          "subspace", "floquet", "cli", "parallel", "probe", "timing", "precision", "wide",
          "beyond")
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
        max_err.update(phase_precision_b1_kernels(dev))
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
        launches.update(phase_precision_b1_path(dev))
    wide_launches = {}
    if "wide" in want:
        for kind, err in phase_wide_kernels(dev).items():
            max_err[kind] = max(max_err.get(kind, 0.0), err)
        wide_launches = phase_wide_path()
        phase_wide_timing(dev)
    beyond_launches = {}
    if "beyond" in want:
        for kind, err in phase_beyond_kernels(dev).items():
            max_err[kind] = max(max_err.get(kind, 0.0), err)
        for kind, err in phase_beyond_bf16_kernels(dev).items():
            max_err[kind] = max(max_err.get(kind, 0.0), err)
        beyond_launches = phase_beyond_path()
        for kind, n in phase_beyond_eigen_path().items():
            beyond_launches[kind] = beyond_launches.get(kind, 0) + n
        phase_beyond_timing(dev)
    rows = wan_rows = eigen_rows = prec_rows = b1_rows = []
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
        b1_rows = phase_precision_b1_timing(dev)
    elif only is not None and any(name.endswith(".bf16") for name in only):
        phase_precision_timing(dev, only)
        phase_precision_b1_timing(dev, only)
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
    for kind in B1_REPLACES:
        row = next(r for r in b1_rows if r["kernel"] == kind and r["N"] == r["path_n"])
        kernels.append({
            "name": kind, "route": "cuda", "source": B1_SOURCES[kind],
            "design_source": MMA_SOURCE,
            "replaces": B1_REPLACES[kind], "launches": launches[kind],
            "max_abs_err": max_err[kind], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        })
    # the launches of the width-200 paths (phase wide_path), beside each
    # kernel's own path's
    for k in kernels:
        if k["name"] in wide_launches:
            k["launches_wide"] = wide_launches[k["name"]]
    # and of the paths beyond the other kernels' limits (phase beyond_path)
    for k in kernels:
        if k["name"] in beyond_launches:
            k["launches_beyond"] = beyond_launches[k["name"]]
    if len(kernels) != 23 or not all(k["launches"] > 0 for k in kernels):
        raise SystemExit("a kernel of the paths was launched no time on its path")
    if set(wide_launches) != set(PRECISION_REPLACES) | {"multi_sums", "multi_seeded"} or not all(
            wide_launches.values()):
        raise SystemExit("a kernel of the width-200 paths was launched no time there")
    if (set(beyond_launches) != set(BEYOND_ALL + BEYOND_BF16_NAMES)
            or not all(beyond_launches.values())):
        raise SystemExit("a kernel of the paths beyond the limits was launched no time there")
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
