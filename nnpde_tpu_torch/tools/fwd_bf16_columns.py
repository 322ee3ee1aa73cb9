"""Where the jet forward's bf16-dot variant (row 4 bf16) leaves its plain
version, column by column, and what its products' accumulation costs.

    python -m nnpde_tpu_torch.tools.fwd_bf16_columns     # on a GPU machine

Builds the kernels from a copy of ``csrc/`` under ``_build/`` per variant,
each run in a process of its own:

* ``tree``: as the tree has them: the products before the last on the CUDA
  cores, an fp32 FMA chain in k order (``fwdlap_mma.cuh::f32_products``),
  the last on the tensor cores;
* ``halves``: every product on the tensor cores (``mma_bf16``: each half
  k-step of 8 products into a zero accumulator), as before;
* ``f32_all`` / ``f32_last``: every product, or the last alone, by
  ``f32_products``;
* ``split``: every product on the tensor cores with each weight pair split
  into its high part (sign, exponent, top 3 stored significand bits) and
  the rest, two exact bf16 values of at most 4 significant bits: products of
  at most 12 bits, which the tensor cores' alignment keeps whole.

For each net and variant it prints one JSON line per jet column at 40000
points, on the plan's launch shape: the rms distance of the kernel and of
the plain bf16-dot version (``fwdlap_cuda.fwdlap_forward_default_plain``)
from the float64 witness (the same plain version in float64), and of the
kernel from the plain version, each over the column's mean magnitude, and
whether a second launch repeated the first bitwise; then the kernel's
device time per launch (captured launches replayed back to back) at the
nets' path sizes and at 262144 points.  Without arguments it runs the
VARIANTS in turn, the parent's and the tree's accumulation first and last
(their times in turns); ``--variants=a,b,...`` runs those instead.

    python -m nnpde_tpu_torch.tools.fwd_bf16_columns --probe

builds one m16n8k8 product per block (``PROBE_SRC``) and prints how the
tensor cores' sum of 8 bf16 products into a zero accumulator compares with
the exact sum rounded to fp32 to nearest and toward zero.

    python -m nnpde_tpu_torch.tools.fwd_bf16_columns --seeds

repeats the column distances on (1, 100 x 3, 1) tanh over SEEDS in the
``halves``, ``tree`` and ``f32_all`` variants, each beside the plain
version's own spread over sound rounding orders
(``kernels/fwdlap_cuda.py::ROUNDING_ORDERS``: its sums in three orders, its
stage's multiply-adds fused); ``--seeds-of=tree`` runs one variant.

    python -m nnpde_tpu_torch.tools.fwd_bf16_columns --orders

runs the same seeds on the CPU, without the kernel: the plain version
(the CPU library's product) and its other rounding orders against the
witness.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys

NETS = [((1, 100, 100, 100, 1), "tanh"), ((1, 100, 100, 100, 1), "sin"),
        ((1, 64, 64, 64, 1), "tanh"), ((2, 100, 100, 100, 1), "tanh"),
        ((1, 200, 200, 200, 1), "tanh"), ((2, 64, 64, 64, 64, 1), "sin")]
# timed: (net, points on its path)
TIMED = [(((1, 100, 100, 100, 1), "tanh"), 1000), (((2, 64, 64, 64, 64, 1), "sin"), 20000),
         (((1, 200, 200, 200, 1), "tanh"), 1000)]
L = 2.0
VARIANTS = ("halves", "tree", "f32_all", "f32_last", "split", "tree", "halves")
INNER_ON = "constexpr bool INNER_F32 = KIND == KIND_FWD;"
PICK = "const bool f32 = INNER_F32 && !last;"

# mma_bf16 with each B pair split (the ``split`` variant)
SPLIT = '''__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t bh = b[h] & 0xFFF0FFF0u;
    const float l0 = __uint_as_float(b[h] << 16) - __uint_as_float(bh << 16);
    const float l1 = __uint_as_float(b[h] & 0xFFFF0000u) - __uint_as_float(bh & 0xFFFF0000u);
    __nv_bfloat162 v = __floats2bfloat162_rn(l0, l1);
    const uint32_t bl = *reinterpret_cast<uint32_t*>(&v);
    float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f, u0 = 0.f, u1 = 0.f, u2 = 0.f, u3 = 0.f;
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5}, {%6}, {%0, %1, %2, %3};\\n"
        : "+f"(t0), "+f"(t1), "+f"(t2), "+f"(t3)
        : "r"(a[2 * h]), "r"(a[2 * h + 1]), "r"(bh));
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5}, {%6}, {%0, %1, %2, %3};\\n"
        : "+f"(u0), "+f"(u1), "+f"(u2), "+f"(u3)
        : "r"(a[2 * h]), "r"(a[2 * h + 1]), "r"(bl));
    c[0] += t0 + u0;
    c[1] += t1 + u1;
    c[2] += t2 + u2;
    c[3] += t3 + u3;
  }
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


def _sources(variant):
    """Point the build at a copy of csrc/ patched for ``variant``."""
    from ..kernels import _build

    if variant == "tree":
        return
    src = _build.BUILD_DIR / f"csrc_{variant}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    h = (src / "fwdlap_mma.cuh").read_text()
    if INNER_ON not in h or PICK not in h:
        raise SystemExit("fwdlap_mma.cuh: no INNER_F32 switch to patch")
    if variant in ("halves", "split"):
        h = h.replace(INNER_ON, "constexpr bool INNER_F32 = false;")
    if variant == "split":
        cur = re.search(r"__device__ __forceinline__ void mma_bf16\(.*?\n}\n", h, re.S)
        h = h.replace(cur.group(0), SPLIT)
    if variant == "f32_all":
        h = h.replace(PICK, "const bool f32 = INNER_F32;")
    if variant == "f32_last":
        h = h.replace(PICK, "const bool f32 = INNER_F32 && last;")
    (src / "fwdlap_mma.cuh").write_text(h)
    _build.CSRC = src


def _device_ms(fn, launches=30, reps=5):
    import torch

    from ..kernels import _cuda

    with _cuda.capture() as cap:
        fn()
    cap.replay(3)
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


def run(variant, N=40000, seed=31):
    import numpy as np
    import torch

    from ..interop import params_from_jax
    from ..kernels import fwdlap_cuda as tfc

    _sources(variant)
    dev = torch.device("cuda")
    for layers, act in NETS:
        rng = np.random.default_rng(seed)
        d = layers[0]
        tp = params_from_jax(_params(rng, layers), device=dev)
        X = torch.as_tensor(rng.uniform(0.0, L, (N, d)).astype(np.float32), device=dev)
        p = tfc.fwdlap_forward_default_plain(tp, X, act).double()
        w = tfc.fwdlap_forward_default_plain([(W.double(), b.double()) for W, b in tp],
                                             X.double(), act)
        k1 = tfc.fwdlap_forward(tp, X, act, "rows:default")
        k2 = tfc.fwdlap_forward(tp, X, act, "rows:default")
        k = k1.double()
        for c in range(d + 2):
            sc = float(w[:, c].abs().mean())

            def rms(a, b):
                return float((a[:, c] - b[:, c]).pow(2).mean().sqrt()) / sc

            print(json.dumps({"variant": variant, "layers": list(layers), "act": act,
                              "column": c, "mean_abs": sc, "kernel_rms": rms(k, w),
                              "plain_rms": rms(p, w), "kernel_plain": rms(k, p),
                              "bitwise": bool(torch.equal(k1, k2))}), flush=True)
    for (layers, act), n in TIMED:
        rng = np.random.default_rng(seed)
        tp = params_from_jax(_params(rng, layers), device=dev)
        for npts in (n, 262144):
            X = torch.as_tensor(rng.uniform(0.0, L, (npts, layers[0])).astype(np.float32),
                                device=dev)
            ms = _device_ms(lambda: tfc.fwdlap_forward(tp, X, act, "rows:default"))
            print(json.dumps({"variant": variant, "layers": list(layers), "act": act,
                              "N": npts, "device_ms": ms}), flush=True)


# One m16n8k8 bf16 product per block into a zero accumulator (mma_bf16's
# half k-step): A (16 x 8) as 4 words a row (k = 2t, 2t + 1 in word t, low
# half first), B (8 x 8) as 4 words a column, C (16 x 8) row-major.
PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_probe_kernel(const uint32_t* A, const uint32_t* B, float* C) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const uint32_t* a = A + (size_t)blockIdx.x * 64;
  const uint32_t* b = B + (size_t)blockIdx.x * 32;
  const uint32_t a0 = a[g * 4 + t], a1 = a[(g + 8) * 4 + t], b0 = b[g * 4 + t];
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a0), "r"(a1), "r"(b0));
  float* c = C + (size_t)blockIdx.x * 128;
  c[g * 8 + 2 * t] = c0;
  c[g * 8 + 2 * t + 1] = c1;
  c[(g + 8) * 8 + 2 * t] = c2;
  c[(g + 8) * 8 + 2 * t + 1] = c3;
}
extern "C" int mma_probe(const uint32_t* A, const uint32_t* B, float* C, int n) {
  mma_probe_kernel<<<n, 32>>>(A, B, C);
  return (int)cudaDeviceSynchronize();
}
"""

# (name, A's values, B's values): A as the stages' activations, B as the
# weights of a 100-wide layer
PROBE_DISTS = (("tanh-like", (-1.0, 1.0), (-0.1, 0.1)), ("positive", (0.0, 1.0), (0.0, 0.1)),
               ("wide-spread", (-1.0, 1.0), (-0.1, 0.1)))


def probe(n=20000, seed=5):
    """The tensor cores' half k-step against the exact sum of its 8 products
    (float64), over ``n`` random products per distribution: the share equal
    to the fp32 value rounded to nearest and to the one rounded toward zero,
    and the mean error in units of the exact value's fp32 ulp, signed toward
    zero (positive: the result is nearer zero)."""
    import ctypes

    import numpy as np
    import torch

    from ..kernels import _build

    so = _build.BUILD_DIR / "mma_probe.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = _build.BUILD_DIR / "mma_probe.cu"
        src.write_text(PROBE_SRC)
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-shared", "-Xcompiler",
                        "-fPIC", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.mma_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    rng = np.random.default_rng(seed)
    for name, (alo, ahi), (blo, bhi) in PROBE_DISTS:
        a = rng.uniform(alo, ahi, (n, 16, 8))
        b = rng.uniform(blo, bhi, (n, 8, 8))
        if name == "wide-spread":      # magnitudes over 12 binades
            a = a * 2.0 ** rng.integers(-12, 1, a.shape)
        A = torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16)
        B = torch.as_tensor(b, dtype=torch.float32).to(torch.bfloat16)
        exact = torch.einsum("nik,nkj->nij", A.double(), B.double()).numpy()
        Aw = A.contiguous().view(torch.int16).view(n, 16, 4, 2)
        Bw = B.transpose(1, 2).contiguous().view(torch.int16).view(n, 8, 4, 2)

        def words(x):
            lo = x[..., 0].to(torch.int32) & 0xFFFF
            hi = x[..., 1].to(torch.int32) << 16
            return (lo | hi).contiguous().cuda()

        Ad, Bd = words(Aw), words(Bw)
        C = torch.empty((n, 16, 8), dtype=torch.float32, device="cuda")
        rc = lib.mma_probe(Ad.data_ptr(), Bd.data_ptr(), C.data_ptr(), n)
        if rc != 0:
            raise SystemExit(f"probe: cuda error {rc}")
        tc = C.cpu().numpy().astype(np.float64)
        rn = exact.astype(np.float32).astype(np.float64)
        rz = np.where(np.abs(rn) > np.abs(exact),
                      np.nextafter(rn.astype(np.float32), np.float32(0)).astype(np.float64), rn)
        ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
        live = exact != 0
        toward_zero = (np.abs(exact) - np.abs(tc))[live] / ulp[live]
        print(json.dumps({"probe": name, "sums": int(live.sum()),
                          "equal_rn": float(np.mean(tc[live] == rn[live])),
                          "equal_rz": float(np.mean(tc[live] == rz[live])),
                          "err_ulp_toward_zero_mean": float(np.mean(toward_zero)),
                          "err_ulp_abs_max": float(np.max(np.abs(toward_zero)))}), flush=True)


# the seed study: the net of the fault, every seed's parameters and points
SEED_NET, SEEDS = ((1, 100, 100, 100, 1), "tanh"), tuple(range(300, 316)) + (31,)


def seeds(variant, N=40000, device="cuda"):
    """Per seed of SEEDS on SEED_NET: each column's distance of the kernel
    (``device`` cuda; none on the CPU), of the plain version and of the plain
    version in each other rounding order of ``fwdlap_cuda.ROUNDING_ORDERS``
    from the witness, as the rms over the column's mean magnitude, and as
    chip_smoke.py's norm-relative ``col_rel`` for the first two; and the
    plain version's spread, the largest rms distance of an order from the
    plain version, over the sum orders alone (``spread_sums``) and over all
    (``spread``; ROADMAP.md C4)."""
    import numpy as np
    import torch

    from ..interop import params_from_jax
    from ..kernels import fwdlap_cuda as tfc

    on_card = device == "cuda"
    if on_card:
        _sources(variant)
    dev = torch.device(device)
    layers, act = SEED_NET
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        tp = params_from_jax(_params(rng, layers), device=dev)
        X = torch.as_tensor(rng.uniform(0.0, L, (N, layers[0])).astype(np.float32),
                            device=dev)
        k = tfc.fwdlap_forward(tp, X, act, "rows:default").double() if on_card else None
        p = tfc.fwdlap_forward_default_plain(tp, X, act).double()
        o = {name: tfc.fwdlap_forward_default_plain(tp, X, act, name).double()
             for name in tfc.ROUNDING_ORDERS}
        w = tfc.fwdlap_forward_default_plain([(W.double(), b.double()) for W, b in tp],
                                             X.double(), act)
        for c in range(layers[0] + 2):
            sc, nw = float(w[:, c].abs().mean()), float(torch.linalg.norm(w[:, c]))

            def rms(a, b):
                return float((a[:, c] - b[:, c]).pow(2).mean().sqrt()) / sc

            row = {"variant": variant if on_card else None, "device": device, "seed": seed,
                   "column": c, "plain_rms": rms(p, w),
                   "plain_rel": float(torch.linalg.norm(p[:, c] - w[:, c])) / nw}
            if on_card:
                row.update(kernel_rms=rms(k, w), kernel_plain=rms(k, p),
                           kernel_rel=float(torch.linalg.norm(k[:, c] - w[:, c])) / nw)
            for name, t in o.items():
                row[f"{name}_rms"] = rms(t, w)
            row["spread_sums"] = max(rms(t, p) for n, t in o.items() if n != "contracted")
            row["spread"] = max(rms(t, p) for t in o.values())
            print(json.dumps(row), flush=True)


def main():
    args = [a for a in sys.argv[1:] if a.startswith("--variant=")]
    if "--probe" in sys.argv[1:]:
        probe()
        return
    if "--seeds" in sys.argv[1:]:
        for variant in ("halves", "tree", "f32_all"):
            rc = subprocess.call([sys.executable, "-m", "nnpde_tpu_torch.tools.fwd_bf16_columns",
                                  f"--seeds-of={variant}"])
            if rc != 0:
                raise SystemExit(f"{variant}: exit {rc}")
        return
    of = [a for a in sys.argv[1:] if a.startswith("--seeds-of=")]
    if of:
        seeds(of[-1].split("=", 1)[1])
        return
    if "--orders" in sys.argv[1:]:
        seeds(None, device="cpu")
        return
    if args:
        run(args[-1].split("=", 1)[1])
        return
    pick = [a.split("=", 1)[1].split(",") for a in sys.argv[1:] if a.startswith("--variants=")]
    for variant in pick[-1] if pick else VARIANTS:
        rc = subprocess.call([sys.executable, "-m", "nnpde_tpu_torch.tools.fwd_bf16_columns",
                              f"--variant={variant}"])
        if rc != 0:
            raise SystemExit(f"{variant}: exit {rc}")


if __name__ == "__main__":
    main()
