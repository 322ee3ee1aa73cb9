"""Command-line front-end for every problem family.

Counterpart of ``nnpde_tpu/exp/cli.py``: the same subcommands, options,
defaults and choices, with two exceptions.  ``--jet-impl`` takes the
port's route names (``torch``: the recurrence under autograd; ``kernel``:
the jet kernel pair; ``fused``: the fused loss+grad kernels) where JAX has
``xla`` / ``pallas`` / ``pallas-fused``, default ``torch``; and every
subcommand takes ``--device`` (default ``cuda``; ``--device cpu`` runs the
kernels' plain versions on the CPU).

    python -m nnpde_tpu_torch.exp.cli poisson --dim 2 --method PINN --epochs 10000
    python -m nnpde_tpu_torch.exp.cli ipw1d   --n 3 --method DRM --technique FN
    python -m nnpde_tpu_torch.exp.cli ipw1d-wan --n 2 --technique FBC
    python -m nnpde_tpu_torch.exp.cli ipw2d   --nx 3 --ny 3 --method DRM
    python -m nnpde_tpu_torch.exp.cli qho1d   --n 2 --method PINN --technique FN
    python -m nnpde_tpu_torch.exp.cli qho1d-wan --n 1 --technique OG
    python -m nnpde_tpu_torch.exp.cli qho2d   --nx 1 --ny 1 --method WAN
    python -m nnpde_tpu_torch.exp.cli kh      --alpha 10 --n-max 4 --methods PINN DRM WAN
    python -m nnpde_tpu_torch.exp.cli poisson --epochs 200 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys


# the port's jet routes, in the order of JAX's xla / pallas / pallas-fused
JET_IMPLS = ["torch", "kernel", "fused"]


def _int_list(s):
    return [int(x) for x in s.split(",")]


def _add_common(p, *, epochs, lr=1e-3):
    p.add_argument("--epochs", type=int, default=epochs)
    p.add_argument("--lr", type=float, default=lr)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-dir", type=str, default=None)
    p.add_argument("--chunk", type=int, default=None,
                   help="epochs between the trainer's history flushes")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="record a torch.profiler trace of the run into DIR")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd anomaly detection (runtime.enable_debug_nans)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises where there is no card) or cpu")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="nnpde-torch", description="PINN/DRM/WAN PDE solver suite on PyTorch and CUDA"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("poisson", help="N-D Poisson on [0,L]^d")
    p.add_argument("--dim", type=int, default=2)
    p.add_argument("--L", type=float, default=2.0)
    p.add_argument("--ks", type=_int_list, default=None)
    p.add_argument("--method", choices=["PINN", "DRM", "WAN"], default="PINN")
    p.add_argument("--bc-mode", choices=["FBC", "RB"], default="FBC")
    p.add_argument("--n-interior", type=int, default=20000)
    p.add_argument("--n-boundary", type=int, default=4000)
    p.add_argument("--n-data", type=int, default=0)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--critic-steps", type=int, default=5)
    p.add_argument("--bc-type", choices=["dirichlet", "neumann"],
                   default="dirichlet")
    p.add_argument("--solution", choices=["sin", "cos"], default="sin")
    p.add_argument("--resample", action="store_true",
                   help="fresh interior sample every epoch")
    p.add_argument("--sampler", choices=["uniform", "sobol"],
                   default="uniform",
                   help="sobol = scrambled QMC; with --resample the base "
                        "set gets a fresh random shift per epoch")
    p.add_argument("--lr-schedule", choices=["constant", "cosine",
                                             "exponential"],
                   default="constant")
    p.add_argument("--compute-dtype",
                   choices=["float32", "bfloat16", "hybrid",
                            "hybrid-kernel"],
                   default="float32",
                   help="hybrid = bf16 bulk + f32 tail (bf16 speed, f32 "
                        "final accuracy; optimizer state carries across); "
                        "hybrid-kernel = f32 streams with the kernels' "
                        "bf16-dot mode as the bulk (PINN + --jet-impl "
                        "kernel or fused)")
    p.add_argument("--norm-mode", choices=["nontrivial", "l2"],
                   default="nontrivial")
    p.add_argument("--jet-impl",
                   choices=JET_IMPLS, default="torch",
                   help="jet route; kernel = the jet kernel pair (PINN); "
                        "fused = fused loss+grad kernels: one-pass for "
                        "PINN and DRM, two-pass quotient kernels for WAN")
    p.add_argument("--wan-reg", type=float, default=1.0,
                   help="WAN critic regularisation weight")
    _add_common(p, epochs=10000)

    p = sub.add_parser("ipw1d", help="1D infinite well eigenstates (PINN/DRM)")
    p.add_argument("--n", type=int, default=1)
    p.add_argument("--L", type=float, default=2.0)
    p.add_argument("--method", choices=["PINN", "DRM"], default="DRM")
    p.add_argument("--technique", choices=["BC", "FBC", "FN", "OG"], default="FN")
    p.add_argument("--layers", type=_int_list, default=[1, 50, 50, 50, 1])
    p.add_argument("--lbfgs", action="store_true")
    p.add_argument("--jet-impl",
                   choices=JET_IMPLS, default="torch")
    _add_common(p, epochs=3000)

    p = sub.add_parser("ipw1d-wan", help="1D infinite well via WAN")
    p.add_argument("--n", type=int, default=1)
    p.add_argument("--L", type=float, default=2.0)
    p.add_argument("--jet-impl",
                   choices=JET_IMPLS, default="torch",
                   help="fused = two-pass fused u/v objectives "
                        "(kernels/fused_quotient.py)")
    p.add_argument("--technique", choices=["BC", "FBC", "OG", "FN"], default="FBC")
    p.add_argument("--layers", type=_int_list, default=[1, 50, 50, 50, 1])
    p.add_argument("--v-layers", type=_int_list, default=[1, 20, 20, 20, 1])
    p.add_argument("--v-steps", type=int, default=5)
    p.add_argument("--minimax",
                   choices=["alternating", "extragradient", "optimistic"],
                   default="alternating",
                   help="WAN saddle-point update rule")
    p.add_argument("--v-lr", type=float, default=None,
                   help="two-timescale critic lr (default: same as --lr)")
    p.add_argument("--u-ema", type=float, default=0.0,
                   help="EMA decay for the averaged primal iterate")
    _add_common(p, epochs=3000)

    p = sub.add_parser("ipw2d", help="2D infinite well (PINN/DRM/WAN)")
    p.add_argument("--nx", type=int, default=1)
    p.add_argument("--ny", type=int, default=1)
    p.add_argument("--L", type=float, default=2.0)
    p.add_argument("--method", choices=["PINN", "DRM", "WAN"], default="PINN")
    p.add_argument("--technique", choices=["FBC", "FN", "OG"], default="FBC")
    p.add_argument("--grid-n", type=int, default=200)
    p.add_argument("--v-layers", type=_int_list, default=[2, 20, 20, 20, 1])
    p.add_argument("--v-steps", type=int, default=5)
    p.add_argument("--n-test-grid", type=int, default=1,
                   help="k>1: multi-test-function WAN with a k x k bump grid")
    p.add_argument("--grid-jitter", action="store_true",
                   help="WAN: per-eval Cranley-Patterson whole-grid shift "
                        "(unbiased weak-form quadrature, no per-point noise)")
    p.add_argument("--jitter-anchors-fixed", action="store_true",
                   help="with --grid-jitter: keep norm/parity/symmetry "
                        "anchors on the fixed grid (noise-free amplitude "
                        "target; weak form stays jittered)")
    p.add_argument("--lr-schedule", choices=["constant", "cosine",
                                             "exponential"],
                   default="constant")
    p.add_argument("--compute-dtype",
                   choices=["float32", "bfloat16", "hybrid"],
                   default="float32",
                   help="WAN too (bf16 minimax bulk + f32 "
                        "tail, full carry across the switch)")
    p.add_argument("--jet-impl",
                   choices=JET_IMPLS, default="torch",
                   help="kernel = the jet kernel pair; fused = the fused "
                        "loss+grad kernels (PINN, DRM; WAN on the K-bump "
                        "pair)")
    p.add_argument("--minimax",
                   choices=["alternating", "extragradient", "optimistic"],
                   default="alternating",
                   help="WAN saddle-point update rule")
    p.add_argument("--v-lr", type=float, default=None,
                   help="two-timescale critic lr (default: same as --lr)")
    p.add_argument("--u-ema", type=float, default=0.0,
                   help="EMA decay for the averaged primal iterate")
    p.add_argument("--lbfgs", action="store_true")
    p.add_argument("--weights", type=json.loads, default=None,
                   help='JSON weight overrides, e.g. \'{"data": 1e4}\'')
    _add_common(p, epochs=10000)

    p = sub.add_parser(
        "ipw3d",
        help="3D infinite well (sampled collocation — beyond the "
             "reference's 2D meshgrid ceiling)",
    )
    p.add_argument("--nx", type=int, default=1)
    p.add_argument("--ny", type=int, default=1)
    p.add_argument("--nz", type=int, default=1)
    p.add_argument("--L", type=float, default=2.0)
    p.add_argument("--method", choices=["PINN", "DRM"], default="PINN")
    p.add_argument("--technique", choices=["FBC", "FN"], default="FN")
    p.add_argument("--n-interior", type=int, default=131072)
    p.add_argument("--sampler", choices=["uniform", "sobol"],
                   default="sobol")
    p.add_argument("--no-resample", action="store_true")
    p.add_argument("--layers", type=_int_list,
                   default=[3, 64, 64, 64, 64, 1])
    p.add_argument("--jet-impl",
                   choices=JET_IMPLS, default="torch")
    _add_common(p, epochs=5000)

    p = sub.add_parser(
        "subspace",
        help="k lowest eigenstates in ONE training run (Gram-metric trace "
             "minimisation over a k-channel net — the reference retrains "
             "per level with orthogonality projections)",
    )
    p.add_argument("--problem", choices=["qho", "ipw", "kh"], default="qho")
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--dim", type=int, default=1, choices=[1, 2])
    p.add_argument("--x-max", type=float, default=6.0,
                   help="QHO/KH window half-width / IPW box length "
                        "(use ~10 for KH at alpha=10)")
    p.add_argument("--alpha", type=float, default=10.0,
                   help="KH only: laser quiver amplitude alpha_0")
    p.add_argument("--fd-grid-n", type=int, default=5000,
                   help="KH only: FD ground-truth grid resolution")
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--grid-n", type=int, default=600)
    p.add_argument("--eval-grid-n", type=int, default=2000,
                   help="dense per-dim grid for the final report (2D: "
                        "n^2 points — lower it on the CPU)")
    p.add_argument("--ortho-weight", type=float, default=10.0)
    _add_common(p, epochs=8000)

    p = sub.add_parser("qho1d", help="1D harmonic oscillator (PINN/DRM)")
    p.add_argument("--n", type=int, default=0)
    p.add_argument("--x-max", type=float, default=6.0)
    p.add_argument("--method", choices=["PINN", "DRM"], default="DRM")
    p.add_argument("--technique", choices=["BC", "OG", "FN"], default="FN")
    p.add_argument("--layers", type=_int_list, default=[1, 200, 200, 200, 1])
    p.add_argument("--lbfgs", action="store_true")
    p.add_argument("--lbfgs-mode", choices=["polish", "replace"],
                   default="polish",
                   help="replace = L-BFGS instead of Adam (the reference's "
                        "QHO-1D mode, QHO_1D_PINN_DRM.py:437-439)")
    p.add_argument("--lbfgs-iters", type=int, default=500)
    p.add_argument("--jet-impl",
                   choices=JET_IMPLS, default="torch")
    _add_common(p, epochs=3000)

    p = sub.add_parser("qho1d-wan", help="1D QHO via WAN (trainable energy)")
    p.add_argument("--n", type=int, default=0)
    p.add_argument("--x-max", type=float, default=6.0)
    p.add_argument("--jet-impl",
                   choices=JET_IMPLS, default="torch",
                   help="fused = two-pass fused u/v objectives with "
                        "the exact trainable-E gradient")
    p.add_argument("--technique", choices=["BC", "FBC", "OG"], default="BC")
    p.add_argument("--layers", type=_int_list, default=[1, 200, 200, 200, 1])
    p.add_argument("--v-layers", type=_int_list, default=[1, 100, 100, 100, 1])
    p.add_argument("--v-steps", type=int, default=5)
    p.add_argument("--minimax",
                   choices=["alternating", "extragradient", "optimistic"],
                   default="alternating",
                   help="WAN saddle-point update rule")
    p.add_argument("--v-lr", type=float, default=None,
                   help="two-timescale critic lr (default: same as --lr)")
    p.add_argument("--u-ema", type=float, default=0.0,
                   help="EMA decay for the averaged primal iterate")
    _add_common(p, epochs=3000)

    p = sub.add_parser("qho2d", help="2D harmonic oscillator (PINN/DRM/WAN)")
    p.add_argument("--nx", type=int, default=0)
    p.add_argument("--ny", type=int, default=0)
    p.add_argument("--L", type=float, default=6.0)
    p.add_argument("--method", choices=["PINN", "DRM", "WAN"], default="PINN")
    p.add_argument("--technique", choices=["FBC", "FN", "OG"], default="FBC")
    p.add_argument("--grid-n", type=int, default=200)
    p.add_argument("--trainable-energy", action="store_true")
    p.add_argument("--energy-lr", type=float, default=None,
                   help="separate Adam lr for the trainable-E leaf "
                        "(train/optim.py::MultiTransformAdam; fixes "
                        "long-run E drift)")
    p.add_argument("--energy-variant", action="store_true",
                   help="use the QHO_2D_Energy paper weight table")
    p.add_argument("--lr-schedule", choices=["constant", "cosine",
                                             "exponential"],
                   default="constant")
    p.add_argument("--minimax",
                   choices=["alternating", "extragradient", "optimistic"],
                   default="alternating",
                   help="WAN saddle-point update rule")
    p.add_argument("--v-lr", type=float, default=None,
                   help="two-timescale critic lr (default: same as --lr)")
    p.add_argument("--u-ema", type=float, default=0.0,
                   help="EMA decay for the averaged primal iterate")
    p.add_argument("--lbfgs", action="store_true")
    p.add_argument("--jet-impl",
                   choices=JET_IMPLS, default="torch",
                   help="fused = one-pass fused loss+grad kernel "
                        "(in-kernel dL/dE with --trainable-energy)")
    _add_common(p, epochs=10000)

    p = sub.add_parser("sweep", help="reference experiment sweeps")
    p.add_argument("which", choices=[
        "poisson", "ipw1d", "ipw-wan-fn-ablation", "qho1d", "qho2d-energy",
    ])
    p.add_argument("--n-values", type=_int_list, default=[1])
    p.add_argument("--dims", type=_int_list, default=[2])
    p.add_argument("--include-wan", action="store_true")
    _add_common(p, epochs=3000)

    p = sub.add_parser("kh", help="Kramers-Henneberger unified compare")
    p.add_argument("--alpha", type=float, default=10.0)
    p.add_argument("--L", type=float, default=60.0)
    p.add_argument("--n-ref", type=int, default=5000)
    p.add_argument("--n-max", type=int, default=4)
    p.add_argument("--train-n", type=int, default=1024)
    p.add_argument("--methods", nargs="+", default=["PINN", "DRM", "WAN"])
    p.add_argument("--technique", choices=["RAW", "FBC"], default="FBC")
    p.add_argument("--data-fraction", type=float, default=0.5)
    p.add_argument("--max-data-points", type=int, default=500)
    p.add_argument("--v-steps", type=int, default=3)
    p.add_argument("--jet-impl",
                   choices=JET_IMPLS, default="torch",
                   help="fused = the fused loss+grad kernels (PINN with "
                        "the in-kernel dL/dE; DRM and WAN on the quotient "
                        "kernels)")
    _add_common(p, epochs=10000)

    p = sub.add_parser(
        "kh-floquet",
        help="time-periodic KH atom (Floquet quasi-energy, beyond the "
             "reference's cycle-averaged solver)",
    )
    p.add_argument("--alpha", type=float, default=2.0)
    p.add_argument("--omega", type=float, default=0.3)
    p.add_argument("--L", type=float, default=30.0)
    p.add_argument("--M", type=int, default=2, help="harmonic truncation")
    p.add_argument("--n", type=int, default=0, help="Floquet level")
    p.add_argument("--n-ref", type=int, default=2000)
    p.add_argument("--train-n", type=int, default=1024)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--technique", choices=["RAW", "FBC"], default="FBC")
    p.add_argument("--lr-schedule", choices=["constant", "cosine",
                                             "exponential"],
                   default="constant")
    _add_common(p, epochs=10000)
    return ap


def main(argv=None) -> int:
    import contextlib

    import torch

    from ..runtime import enable_debug_nans, profile_trace

    args = build_parser().parse_args(argv)
    anomaly = torch.is_anomaly_enabled()
    if args.debug_nans:
        enable_debug_nans()
    ctx = profile_trace(args.profile) if args.profile else contextlib.nullcontext()
    try:
        with ctx:
            return _dispatch(args)
    finally:
        enable_debug_nans(anomaly)


def _dispatch(args) -> int:
    dev = args.device
    kw = dict(epochs=args.epochs, lr=args.lr, seed=args.seed)
    if args.chunk:
        kw["chunk"] = args.chunk

    if args.cmd == "poisson":
        from ..problems.poisson import PoissonConfig
        from .run import run_poisson_nd

        cfg = PoissonConfig(
            dim=args.dim, L=args.L, ks=args.ks, method=args.method,
            bc_mode=args.bc_mode, bc_type=args.bc_type,
            solution=args.solution, resample=args.resample,
            sampler=args.sampler, norm_mode=args.norm_mode,
            wan_reg=args.wan_reg,
            lr_schedule=args.lr_schedule, compute_dtype=args.compute_dtype,
            jet_impl=args.jet_impl,
            n_interior=args.n_interior,
            n_boundary=args.n_boundary, n_data=args.n_data,
            width=args.width, depth=args.depth, critic_steps=args.critic_steps,
            **kw,
        )
        out = run_poisson_nd(cfg, **_sd(args, "results/ND_Poisson"), device=dev)
    elif args.cmd == "ipw1d":
        from ..problems.ipw import IPW1DConfig
        from .run import run_ipw_1d

        cfg = IPW1DConfig(n=args.n, L=args.L, method=args.method,
                          technique=args.technique, layers=tuple(args.layers),
                          LBFGS=args.lbfgs, jet_impl=args.jet_impl, **kw)
        out = run_ipw_1d(cfg, **_sd(args, "results/Infinite_Potential_Well_1D"), device=dev)
    elif args.cmd == "ipw1d-wan":
        from ..problems.ipw import IPW1DWanConfig
        from .run import run_ipw_1d_wan

        cfg = IPW1DWanConfig(n=args.n, L=args.L, technique=args.technique,
                             layers=tuple(args.layers),
                             jet_impl=args.jet_impl,
                             v_layers=tuple(args.v_layers),
                             v_steps=args.v_steps, minimax=args.minimax,
                             v_lr=args.v_lr, u_ema=args.u_ema, **kw)
        out = run_ipw_1d_wan(cfg, **_sd(args, "results/Infinite_Potential_Well_1D"),
                             device=dev)
    elif args.cmd == "ipw2d":
        from ..problems.ipw2d import IPW2DConfig
        from .run import run_ipw_2d

        cfg = IPW2DConfig(nx=args.nx, ny=args.ny, L=args.L, method=args.method,
                          technique=args.technique, grid_n=args.grid_n,
                          v_layers=tuple(args.v_layers), v_steps=args.v_steps,
                          n_test_grid=args.n_test_grid,
                          grid_jitter=args.grid_jitter,
                          jitter_anchors_fixed=args.jitter_anchors_fixed,
                          lr_schedule=args.lr_schedule,
                          compute_dtype=args.compute_dtype,
                          jet_impl=args.jet_impl, minimax=args.minimax,
                          v_lr=args.v_lr, u_ema=args.u_ema,
                          LBFGS=args.lbfgs, weights=args.weights, **kw)
        out = run_ipw_2d(cfg, **_sd(args, "results/Infinite_Potential_Well_2D"), device=dev)
    elif args.cmd == "ipw3d":
        from ..problems.ipw3d import IPW3DConfig
        from .run import run_ipw_3d

        cfg = IPW3DConfig(nx=args.nx, ny=args.ny, nz=args.nz, L=args.L,
                          method=args.method, technique=args.technique,
                          n_interior=args.n_interior, sampler=args.sampler,
                          resample=not args.no_resample,
                          layers=tuple(args.layers),
                          jet_impl=args.jet_impl, **kw)
        out = run_ipw_3d(cfg, **({"save_dir": args.save_dir} if args.save_dir else {}),
                         device=dev)
        print(json.dumps({"rel_l2": out["rel_l2"],
                          "min_epoch": out["min_epoch"],
                          "E_exact": out["E_exact"],
                          "checkpoint": out.get("checkpoint")}))
        return 0
    elif args.cmd == "subspace":
        from ..problems.subspace import SubspaceConfig, train_subspace

        cfg = SubspaceConfig(problem=args.problem, k=args.k, dim=args.dim,
                             x_max=args.x_max, width=args.width,
                             depth=args.depth, grid_n=args.grid_n,
                             eval_grid_n=args.eval_grid_n,
                             ortho_weight=args.ortho_weight,
                             alpha=args.alpha, fd_grid_n=args.fd_grid_n,
                             **kw)
        if args.save_dir:
            from .run import run_subspace

            out = run_subspace(cfg, save_dir=args.save_dir, device=dev)
        else:
            out = train_subspace(cfg, device=dev)
        payload = {k_: out[k_] for k_ in
                   ("eigenvalues", "exact", "eig_rel_err", "eig_abs_err",
                    "max_eig_rel_err", "best_epoch") if k_ in out}
        if "max_state_rel_l2" in out:
            payload["state_rel_l2"] = out["state_rel_l2"]
            payload["max_state_rel_l2"] = out["max_state_rel_l2"]
        if "max_subspace_sin" in out:   # 2D degenerate-cluster validation
            payload["subspace_groups"] = out["subspace_groups"]
            payload["max_subspace_sin"] = out["max_subspace_sin"]
        print(json.dumps(payload))
        return 0
    elif args.cmd == "qho1d":
        from ..problems.qho import QHO1DConfig
        from .run import run_qho_1d

        cfg = QHO1DConfig(n=args.n, x_max=args.x_max, method=args.method,
                          technique=args.technique, layers=tuple(args.layers),
                          LBFGS=args.lbfgs, lbfgs_mode=args.lbfgs_mode,
                          lbfgs_iters=args.lbfgs_iters,
                          jet_impl=args.jet_impl, **kw)
        out = run_qho_1d(cfg, **_sd(args, "results/Quantum_Harmonic_Oscillator_1D"), device=dev)
    elif args.cmd == "qho1d-wan":
        from ..problems.qho import QHO1DWanConfig
        from .run import run_qho_1d_wan

        cfg = QHO1DWanConfig(n=args.n, x_max=args.x_max,
                             technique=args.technique,
                             layers=tuple(args.layers),
                             jet_impl=args.jet_impl,
                             v_layers=tuple(args.v_layers),
                             v_steps=args.v_steps, minimax=args.minimax,
                             v_lr=args.v_lr, u_ema=args.u_ema, **kw)
        out = run_qho_1d_wan(cfg, **_sd(args, "results/Quantum_Harmonic_Oscillator_1D"),
                             device=dev)
    elif args.cmd == "qho2d":
        from ..problems.qho2d import QHO2DConfig
        from .run import run_qho_2d

        cfg = QHO2DConfig(nx=args.nx, ny=args.ny, L=args.L, method=args.method,
                          technique=args.technique, grid_n=args.grid_n,
                          trainable_energy=args.trainable_energy,
                          energy_lr=args.energy_lr,
                          energy_variant=args.energy_variant,
                          lr_schedule=args.lr_schedule, minimax=args.minimax,
                          v_lr=args.v_lr, u_ema=args.u_ema,
                          jet_impl=args.jet_impl,
                          LBFGS=args.lbfgs, **kw)
        out = run_qho_2d(cfg, **_sd(args, "results/Quantum_Harmonic_Oscillator_2D"), device=dev)
    elif args.cmd == "sweep":
        from . import sweeps

        common = dict(epochs=args.epochs, lr=args.lr, seed=args.seed, device=dev)
        if args.chunk:
            common["chunk"] = args.chunk
        if args.save_dir:
            common["save_dir"] = args.save_dir
        if args.which == "poisson":
            rows = sweeps.sweep_poisson(dims=args.dims, **common)
        elif args.which == "ipw1d":
            rows = sweeps.sweep_ipw_1d(
                args.n_values, include_wan=args.include_wan, **common
            )
        elif args.which == "ipw-wan-fn-ablation":
            rows = sweeps.sweep_ipw_wan_fn_ablation(
                n=args.n_values[0], **common
            )
        elif args.which == "qho1d":
            rows = sweeps.sweep_qho_1d(args.n_values, **common)
        else:
            rows = sweeps.sweep_qho_2d_energy(**common)
        for r in rows:
            print(json.dumps({k: r.get(k) for k in
                              ("method", "technique", "n", "L2_error")}))
        return 0
    elif args.cmd == "kh":
        from ..problems.kh import KHCompareConfig, run_compare

        cfg = KHCompareConfig(
            alpha=args.alpha, L=args.L, n_ref=args.n_ref, n_max=args.n_max,
            train_n=args.train_n, methods=tuple(args.methods),
            technique=args.technique, data_fraction=args.data_fraction,
            max_data_points=args.max_data_points, v_steps=args.v_steps,
            jet_impl=args.jet_impl,
            save_dir=args.save_dir or "results/KH_1D_Unified",
            epochs=args.epochs, lr=args.lr, seed=args.seed,
            **({"chunk": args.chunk} if args.chunk else {}),
        )
        rows = run_compare(cfg, device=dev)
        for r in rows:
            print(json.dumps({k: r[k] for k in
                              ("method", "n", "E_ref", "E_est",
                               "L2_error_dense", "elapsed_time_sec")}))
        return 0
    elif args.cmd == "kh-floquet":
        from ..problems.kh_floquet import KHFloquetConfig, train_kh_floquet

        cfg = KHFloquetConfig(
            alpha=args.alpha, omega=args.omega, L=args.L, M=args.M,
            n=args.n, n_ref=args.n_ref, train_n=args.train_n,
            width=args.width, depth=args.depth, technique=args.technique,
            lr_schedule=args.lr_schedule,
            epochs=args.epochs, lr=args.lr, seed=args.seed,
            **({"chunk": args.chunk} if args.chunk else {}),
        )
        out = train_kh_floquet(cfg, device=dev)
        print(json.dumps({
            "rel_l2": out["rel_l2"], "best_epoch": out["best_epoch"],
            "eps_est": out["eps_est"], "eps_ref": out["eps_ref"],
            "eps_avg": out["eps_avg"],
            "harmonic_weights": out["harmonic_weights"],
        }))
        return 0
    else:  # pragma: no cover
        raise SystemExit(2)

    row = out["row"]
    print(json.dumps({k: row.get(k) for k in
                      ("tag", "L2_error", "min_epoch", "best_model_path")}))
    return 0


def _sd(args, default):
    return {"save_dir": args.save_dir} if args.save_dir else {"save_dir": default}


if __name__ == "__main__":
    sys.exit(main())
