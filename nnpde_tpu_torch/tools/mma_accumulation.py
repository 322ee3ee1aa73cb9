"""How the tensor-core body's fp32 accumulation moves the bf16-dot kernels
from their plain versions.

    python -m nnpde_tpu_torch.tools.mma_accumulation     # on a GPU machine

Builds the kernels twice, each build in a process of its own: as the tree
has them (``tree``: ``fwdlap_mma.cuh::mma_bf16`` adds each half k-step of 8
products, taken into a zero accumulator, to the running sum in fp32) and
with the earlier accumulation (``running``: each k-step of 16 products
taken into the running accumulator by the tensor cores), from a copy of
``csrc/`` under ``_build/``.  For each net it prints one JSON line
per pass of rows 11-12 in the bf16-dot mode at 16 bumps on the weak form's
stream (:func:`..kernels.fused_multibump.weak_form_stream`, 4007 points):
the kernel's distance from its plain bf16-dot version (``kp``), from the
float64 witness (``kw``) and the plain version's own (``pw``); pass A's
sums over the sum of their terms' magnitudes, pass B's largest
norm-relative gradient leaf.  Then, per net, the jet forward's (row 4
bf16) per-point columns at 40000 points: the rms distance of kernel and
plain version from the witness over the column's mean magnitude.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys

NETS = [((1, 200, 200, 200, 1), "tanh"), ((1, 100, 100, 100, 1), "tanh"),
        ((1, 200, 200, 200, 1), "sin"), ((2, 200, 200, 200, 1), "sin"),
        ((2, 50, 50, 50, 50, 1), "sin")]
JET_NETS = [((1, 200, 200, 200, 1), "tanh"), ((1, 100, 100, 100, 1), "tanh"),
            ((2, 200, 200, 200, 1), "sin")]
L = 2.0

# one k-step of 16 into the running accumulator: mma_bf16 before the halves
RUNNING = '''__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
'''


def _params(rng, layers):
    import numpy as np

    out = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = 1.0 / math.sqrt(n_in)
        out.append((rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                    rng.uniform(-bound, bound, (n_out,)).astype(np.float32)))
    return out


def _leaf_rel(a, b):
    import torch

    return max(float(torch.linalg.norm(x.double() - y.double()))
               / max(float(torch.linalg.norm(y.double())), 1e-30) for x, y in zip(a, b))


def _passes(variant, layers, act, dev, Kb=16, N=4007, seed=23):
    """kp, kw, pw of rows 11 (seeded False) and 12 (True) on one net."""
    import numpy as np
    import torch

    from ..interop import params_from_jax
    from ..kernels import fused_multibump as tfm
    from ..kernels import fused_quotient as tfq
    from ..ops.fwdlap import mlp_fwdlap

    rng = np.random.default_rng(seed)
    d = layers[0]
    pn = _params(rng, layers)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    coef, scal = tfm.weak_form_stream(X, Kb, rng, L)
    seeds = (scal[:Kb], scal[Kb:2 * Kb], scal[2 * Kb:])
    tp = params_from_jax(pn, device=dev)
    P64 = params_from_jax(pn, device=dev, dtype=torch.float64)
    r, mass, lin = tfm._multi_terms(mlp_fwdlap(P64, X.double(), act), coef.double(), Kb, d)
    scale = torch.cat([r.abs().sum(0), mass.sum(0), lin.abs().sum(0)])
    for seeded in (False, True):
        def plain(dtype):
            P = params_from_jax(pn, device=dev, dtype=dtype)
            Xc, cc, sc = X.to(dtype), coef.to(dtype), scal.to(dtype)
            if not seeded:
                return list(tfm.fused_multi_sums_plain(P, Xc, cc, act, Kb, "bfloat16"))
            dWs, dbs, sums = tfm.fused_multi_seeded_grads_plain(P, Xc, cc, sc, act, Kb,
                                                                "bfloat16")
            return [t for pair in tfq._seeded_grads(P, dWs, dbs, sums) for t in pair]

        if seeded:
            g = tfm.fused_multi_seeded_grads(tp, X, coef, seeds, act, Kb, dot_dtype="bfloat16")
            out = [t for pair in g for t in pair]
            rel = _leaf_rel
        else:
            s = tfm.fused_multi_sums(tp, X, coef, act, Kb, dot_dtype="bfloat16")
            out = list(torch.cat([s["sum_r"], s["sum_mass"], s["sum_e2"]]))

            def rel(a, b):
                return max(float(abs(float(x) - float(y)) / m) for x, y, m in zip(a, b, scale))
        want, wit = plain(torch.float32), plain(torch.float64)
        print(json.dumps({"variant": variant, "row": 12 if seeded else 11,
                          "layers": list(layers), "act": act, "n_bumps": Kb,
                          "kp": rel(out, want), "kw": rel(out, wit), "pw": rel(want, wit)}),
              flush=True)


def _jet(variant, layers, act, dev, N=40000, seed=31):
    import numpy as np
    import torch

    from ..interop import params_from_jax
    from ..kernels import fwdlap_cuda as tfc

    rng = np.random.default_rng(seed)
    d = layers[0]
    tp = params_from_jax(_params(rng, layers), device=dev)
    X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
    k = tfc.fwdlap_forward(tp, X, act, "rows:default").double()
    p = tfc.fwdlap_forward_default_plain(tp, X, act).double()
    w = tfc.fwdlap_forward_default_plain([(W.double(), b.double()) for W, b in tp],
                                         X.double(), act)
    for c in range(d + 2):
        sc = float(w[:, c].abs().mean())
        print(json.dumps({"variant": variant, "row": 4, "layers": list(layers), "act": act,
                          "column": c, "kernel_rms": float((k[:, c] - w[:, c]).pow(2).mean()
                                                           .sqrt()) / sc,
                          "plain_rms": float((p[:, c] - w[:, c]).pow(2).mean().sqrt()) / sc}),
              flush=True)


def run(variant):
    import torch

    from ..kernels import _build

    if variant == "running":
        src = _build.BUILD_DIR / "csrc_running"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        h = (src / "fwdlap_mma.cuh").read_text()
        cur = re.search(r"__device__ __forceinline__ void mma_bf16\(.*?\n}\n", h, re.S)
        (src / "fwdlap_mma.cuh").write_text(h.replace(cur.group(0), RUNNING))
        _build.CSRC = src
    dev = torch.device("cuda")
    for layers, act in NETS:
        _passes(variant, layers, act, dev)
    for layers, act in JET_NETS:
        _jet(variant, layers, act, dev)


def main():
    args = [a for a in sys.argv[1:] if a.startswith("--variant=")]
    if args:
        run(args[-1].split("=", 1)[1])
        return
    for variant in ("tree", "running"):
        rc = subprocess.call([sys.executable, "-m", "nnpde_tpu_torch.tools.mma_accumulation",
                              f"--variant={variant}"])
        if rc != 0:
            raise SystemExit(f"{variant}: exit {rc}")


if __name__ == "__main__":
    main()
