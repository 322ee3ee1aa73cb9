"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. device: require CUDA, print the card's name and power limit, build the
   CUDA kernels of ``nnpde_tpu_torch/csrc`` with nvcc.
2. kernels: each fused kernel (float32) against its plain PyTorch version
   in float64 on the same inputs, at the main path's shapes (N = 20000 + 7,
   N = 262144, d = 2, layers 2-64-64-64-64-1, sin) and a d = 5 tanh case:
   loss and grad-tree rel <= 1e-5, and two launches bitwise equal.
3. main path: ``train_poisson_nd`` (2D Poisson PINN, box-FBC trial, width
   64 x depth 5, 3000 epochs, 20000 points) on jet_impl 'torch' and
   'fused': both rel_l2 <= 1e-3, fused <= max(2 x torch, 1e-3), and exactly
   one fused_linear_residual launch per epoch; then coef_mode='analytic'
   and method='DRM' for a few hundred epochs (kernel launched, loss finite
   and falling).
4. timing: CUDA events, median over repeats, for each kernel and its plain
   version at N = 20000 and 262144, with the fp32 bound; training steps
   per second.

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
REPLACES = {
    "fused_linear_residual": "nnpde_tpu/kernels/fused_step.py:64",
    "fused_poisson_analytic": "nnpde_tpu/kernels/fused_step.py:596",
    "fused_drm_energy": "nnpde_tpu/kernels/fused_step.py:170",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


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
    regs = [ln.strip() for ln in _build.BUILD_LOG.get("ptxas", "").splitlines()
            if "registers" in ln or "spill" in ln]
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
            loss, _, grads = case.kernel()
            loss2, _, grads2 = case.kernel()
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(loss, loss2)) and all(
                torch.equal(x, y) for pa, pb in zip(grads, grads2) for x, y in zip(pa, pb))
            ref_loss, ref_grads = case.plain(torch.float64)
            loss_rel = abs(float(loss) - float(ref_loss)) / max(abs(float(ref_loss)), 1e-300)
            grad_rel = tree_rel(grads, ref_grads)
            err = max(abs(float(loss) - float(ref_loss)), tree_max_abs(grads, ref_grads))
            max_err[kind] = max(max_err.get(kind, 0.0), err)
            ok = loss_rel <= 1e-5 and grad_rel <= 1e-5 and bitwise
            rows.append({"kernel": kind, "N": N, "d": d, "act": act, "loss_rel": loss_rel,
                         "grad_rel": grad_rel, "max_abs_err": err, "bitwise_repeat": bitwise,
                         "ok": ok})
            del case
            torch.cuda.empty_cache()
    emit({"phase": "kernels", "tol": 1e-5, "rows": rows})
    if not all(r["ok"] for r in rows):
        raise SystemExit("kernel vs plain comparison failed")
    return max_err


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


def phase_timing(dev):
    rows = []
    for kind in REPLACES:
        for N in (20000, 262144):
            case = Case(kind, N, 2, LAYERS, "sin", seed=7, dev=dev)
            ms = time_ms(case.kernel)
            plain_ms = time_ms(lambda: case.plain(torch.float32), warmup=2, reps=7)
            rows.append({"kernel": kind, "N": N, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": case.bound_ms(), "flop": case.flops(),
                         "bound_by": ("operations" if case.flops() / FP32_PEAK
                                      >= case.bytes() / HBM_RATE else "bytes"),
                         "bytes": case.bytes(),
                         "gflops": case.flops() / (ms * 1e-3) / 1e9})
            del case
            torch.cuda.empty_cache()
    emit({"phase": "timing", "rows": rows})
    return rows


def main():
    card = phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    max_err = phase_kernels(dev)
    launches, steps_per_s = phase_main_path()
    rows = phase_timing(dev)
    emit({"phase": "train_step", "steps_per_s_fused": steps_per_s,
          "points_per_s_fused": steps_per_s * 20000})
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
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
