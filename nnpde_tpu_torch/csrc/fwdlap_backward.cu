// Recompute backward of the jet: parameter gradients from a per-point
// cotangent of (value, grad, Laplacian).
//
// Replaces nnpde_tpu/kernels/fwdlap_pallas.py::_backward_kernel (the
// custom-VJP backward of mlp_fwdlap_pallas): per tile the forward-Laplacian
// recurrence is recomputed on chip (_fwd_recompute), then the reverse sweep
// (_reverse_sweep) runs from the tile's rows of the (N, d+2) cotangent
// stream [ct_v, ct_g_0.., ct_l] down to dW/db summed over all points.  It is
// the epilogue-free member of the fused family: where fused_step.cu forms
// the cotangents from a residual, this kernel loads them.  The last bias
// only shifts the value stream, so its gradient is sum ct_v and is formed
// by the caller; X gets no gradient.
//
// What bounds it on the H100: operations.  Recompute plus reverse sweep
// cost 3*(d+2)*sum(n_in*n_out) multiply-adds per point against
// 4*(2d+2) bytes read, so the fp32 CUDA-core rate is the ceiling.  What the
// design does about it: the shared per-tile core (fwdlap_core.cuh: one
// shared-memory product per layer over all d+2 streams, cp.async for
// weights and saved stages) in the planned design of fwdlap_planned.cuh
// (the launch plan at two blocks per SM, W^T from device memory, two-point
// items where their one-wave tile fits).  Its fp32 designs take nets beyond
// the other kernels' limits: more than CORE_LAYERS weight matrices and d
// above CORE_DIM as they are, a hidden width above NT in the DES_BEYOND
// variant (the last layer's dW split), the weights from device memory
// (ROADMAP.md B7).
//
// The bf16-dot mode (fwdlap_backward_mma) is the TPU kernel's
// dot_dtype='bfloat16' (the backward of the bulk of
// compute_dtype='hybrid-kernel' on the jet pair): every product operand of
// the recompute and of the reverse sweep rounded to bf16, fp32
// accumulation, on the bf16 tensor cores in the design of fwdlap_mma.cuh
// (DES_MMA; bound: the same FLOP at 989 TFLOP/s).  It is the fused
// kernels' tensor-core body with the cotangent rows loaded in place of the
// loss terms and without the projection (body<KIND_BWD>); it takes the nets
// beyond the other kernels' limits as it is (no variant).
//
// Determinism: per-block partial rows, fixed in-block orders, one ordered
// reduction in double, no atomics -- two launches are bitwise equal.
//
// Interface: plain C (ctypes), float32 only, weights flattened as
// [W0, b0, W1, b1, ...].  Launches on the given stream, never synchronises,
// and returns cudaGetLastError().
#include "fwdlap_mma.cuh"

using namespace fwdlap;

namespace {

struct BwdArgs {
  Net net;
  const float* X;
  const float* ct;            // (N, d+2) cotangent rows
  const float* params;
  float* partial;             // (G, P) per-block gradient rows
  float* scratch;             // (G, K-2, S, T, wmax) saved pre-activations
  int N, T, n_tiles;
};

// The planned kernel's arguments: BwdArgs and what its plan adds.
struct PBwdArgs : BwdArgs {
  const float* wt;            // the hidden weights' transposes (tpos)
  int flags;                  // the plan's Flags
};

// Shared-memory floats of one block for (T, flags): the planned kernel's
// layout.  Mirrored by
// kernels/fwdlap_cuda.py::backward_smem_floats.
__host__ __device__ inline int bwd_smem_floats(const Net& net, int T, int flags) {
  const int d = net.d, S = net.S, ld = net.wmax, stage = S * T * ld;
  int n = 3 * stage + ((flags & DEV_WEIGHTS)   ? 0
                       : (flags & RES_WEIGHTS) ? 2 * hidden_floats(net)
                                               : ld * ld);
  if (flags & RES_GRAD) n += (net.P + 3) & ~3;
  return n + T * d + S * T + NT;
}

}  // namespace

// The planned design (fwdlap_planned.cuh, DES != 0) at two blocks per SM
// (the plan counts on them, so the register budget is stated), with the
// plan's residency from A.flags: hidden weights and their transposes, the
// block's gradient row.
template <bool FOLD, int DES>
__global__ void __launch_bounds__(NT, 2) fwdlap_backward_planned(PBwdArgs A) {
  extern __shared__ __align__(16) float smem[];
  const Net& net = A.net;
  const int T = A.T, d = net.d, S = net.S, ld = net.wmax, stage = S * T * ld;
  // DES_DEVW: A.wt holds the padded W and W^T in the resident layout, read
  // from device memory; nothing of them in shared memory
  constexpr bool DEVW = (DES & DES_DEVW) != 0;
  const bool res_w = (A.flags & RES_WEIGHTS) != 0;
  const int hid = res_w || DEVW ? hidden_floats(net) : 0;
  float* bufA = smem;
  float* bufB = bufA + stage;
  float* bufC = bufB + stage;             // pre-activations of one stage
  float* Wsh = bufC + stage;              // one layer's W, or the resident W, W^T
  float* at = Wsh + (DEVW ? 0 : res_w ? 2 * hid : ld * ld);
  float* gacc = nullptr;                  // the block's gradient row (RES_GRAD)
  if (A.flags & RES_GRAD) {
    gacc = at;
    at += (net.P + 3) & ~3;
  }
  float* xs = at;
  float* ct = xs + T * d;                 // [ct_v | ct_g (d) | ct_l] x T
  float* red = ct + S * T;                // reduction scratch, NT
  float* grow_g = A.partial + (size_t)blockIdx.x * net.P;
  float* grow = gacc ? gacc : grow_g;     // where the tiles add their dW/db
  float* scratch = A.scratch + (size_t)blockIdx.x * (net.K - 2) * stage;
  Resident res;
  if constexpr (DEVW) {
    res.W = A.wt;
    res.Wt = A.wt + hid;
  } else if (res_w) {
    stage_resident_p(net, A.params, A.wt, Wsh, Wsh + hid);
    res.W = Wsh;
    res.Wt = Wsh + hid;
  }
  res.narrow = (A.flags & NARROW) != 0;

  for (int i = threadIdx.x; i < net.P; i += NT) grow[i] = 0.f;
  if (res_w) copy_wait();
  __syncthreads();

  for (int tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    load_tile(A.X, A.N, d, base, T, xs);
    // ct[s * T + p] = CT[base + p][s]; rows past N carry zero cotangents
    for (int i = threadIdx.x; i < T * S; i += NT) {
      const int p = i / S, s = i - p * S;
      ct[s * T + p] = base + p < A.N ? A.ct[(size_t)(base + p) * S + s] : 0.f;
    }
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    fwd_recompute_p<FOLD, DES>(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch, res);
    reverse_sweep_p<FOLD, DES>(net, T, xs, A.params, A.wt, cur, nxt, bufC, Wsh, scratch, ct,
                               red, grow, res);
  }
  // the row on chip goes out once (the last tile ended in a barrier)
  if (gacc)
    for (int i = threadIdx.x; i < net.P; i += NT) grow_g[i] = gacc[i];
}

// The tensor-core design (fwdlap_mma.cuh, DES_MMA) of the bf16-dot mode at
// two blocks per SM (its plan counts on them, so the register budget is
// stated).
template <bool WIDE>
__global__ void __launch_bounds__(NT, 2) fwdlap_backward_mma(mma::JetArgs a) {
  mma::body<mma::KIND_BWD, WIDE>(
      a, [](int, const float*, const float*, float*, float*, float*) {});
}

namespace {

typedef void (*PBwdKernelFn)(PBwdArgs);

template <bool FOLD>
PBwdKernelFn planned_by(int des) {
  switch (des) {
    case DES_PLANNED: return fwdlap_backward_planned<FOLD, DES_PLANNED>;
    case DES_PLANNED | DES_ITEM2: return fwdlap_backward_planned<FOLD, DES_PLANNED | DES_ITEM2>;
    case DES_PLANNED | DES_DEVW:
      if constexpr (FOLD) return nullptr;
      else return fwdlap_backward_planned<false, DES_PLANNED | DES_DEVW>;
    // the nets beyond the other kernels' limits (beyond_net), no fold
    case DES_PLANNED | DES_BEYOND:
      if constexpr (FOLD) return nullptr;
      else return fwdlap_backward_planned<false, DES_PLANNED | DES_BEYOND>;
    case DES_PLANNED | DES_DEVW | DES_BEYOND:
      if constexpr (FOLD) return nullptr;
      else return fwdlap_backward_planned<false, DES_PLANNED | DES_DEVW | DES_BEYOND>;
    default: return nullptr;
  }
}

// The kernel of a variant: the bf16-dot mode runs the tensor-core design
// (des DES_MMA, with DES_WIDE its wide variant; no fold) and only it; fp32
// a planned design.
const void* bwd_variant_fn(int fold, int bf16, int des) {
  if (bf16) {
    if (fold) return nullptr;
    if (des == DES_MMA) return (const void*)fwdlap_backward_mma<false>;
    return des == (DES_MMA | mma::DES_WIDE) ? (const void*)fwdlap_backward_mma<true> : nullptr;
  }
  return fold ? (const void*)planned_by<true>(des) : (const void*)planned_by<false>(des);
}

// The net and tile geometry of a tensor-core query (fwdlap_backward_mma_*).
bool mma_net(const int* layers, int n_layers, int T, Net* net, mma::Geo* g) {
  return make_net(1, layers, n_layers, 0, net, true) && mma::make_geo(*net, T, g);
}

}  // namespace

extern "C" {

// X (N, d), ct (N, d+2), params flat; partial (G, P); out (P): [dW0, db0,
// ..., dW_last, 0] (the last bias's slot is left zero).  T points per tile,
// G blocks; fold: the variant with the activation in the products'
// epilogues (nets with at most 4 streams; a planned design); bf16: the
// bf16-dot mode, which runs the tensor-core design (des DES_MMA, with
// DES_WIDE where mma::needs_wide) and only it; des: the design
// (fwdlap_planned.cuh's Design, or the tensor-core one; its flags may add
// DEV_WEIGHTS and DEV_SUMS, the latter with fwdlap_mma.cuh's sums in
// scratch, mma::scratch_floats with the flags);
// flags: the plan's Flags.  smem_bytes must hold the kernel's layout for
// (T, flags).  scratch: the saved stages, (G, K-2, d+2, T, wmax) floats in
// a planned design, (G, fwdlap_backward_mma_scratch_floats) in the
// tensor-core one.  wt: the hidden weights' transposes W_1^T, ...,
// W_{K-2}^T (true sizes, row-major, back to back), read by a planned design
// (null for the tensor-core design, which reads W_k both ways); with
// DES_DEVW the hidden weights and then their transposes, each rounded up to
// multiples of 4 with zeros, back to back (the resident layout).
int fwdlap_backward_f32(const float* X, const float* ct, const float* params,
                        const float* wt, const int* layers, int n_layers, int act, int N,
                        int T, int G, int fold, int bf16, int des, int flags, float* partial,
                        float* scratch, float* out, int smem_bytes, void* stream) {
  PBwdArgs a;
  const void* fn = bwd_variant_fn(fold, bf16, des);
  // both modes take the nets beyond the other kernels' limits: the fp32
  // designs in their DES_BEYOND variant (beyond_net), the tensor-core design
  // as it is
  bool ok = fn != nullptr && make_net(1, layers, n_layers, act, &a.net, true) && N >= 1 &&
            G >= 1;
  const bool mma_des = bf16 != 0;     // (bwd_variant_fn took it: DES_MMA, maybe DES_WIDE)
  if (ok && mma_des) {
    mma::Geo g;
    ok = mma::flags_ok(flags, mma::KIND_BWD) && mma::make_geo(a.net, T, &g) &&
         scratch != nullptr && mma::layout(a.net, g, flags, mma::KIND_BWD).total <= smem_bytes &&
         (!mma::needs_wide(a.net, flags) || (des & mma::DES_WIDE));
  } else if (ok) {
    ok = flags >= 0 && flags <= 15 && ((flags & DEV_WEIGHTS) != 0) == ((des & DES_DEVW) != 0) &&
         !((flags & DEV_WEIGHTS) && (flags & RES_WEIGHTS)) &&
         T >= 4 && T % 4 == 0 && T <= NT / 2 && !(fold && a.net.S > 4) &&
         !(a.net.K > 2 && (scratch == nullptr || wt == nullptr)) &&
         ((des & DES_BEYOND) != 0) == beyond_net(a.net) &&
         4 * bwd_smem_floats(a.net, T, flags) <= smem_bytes;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  a.X = X;
  a.ct = ct;
  a.params = params;
  a.partial = partial;
  a.scratch = scratch;
  a.N = N;
  a.T = T;
  a.n_tiles = (N + T - 1) / T;
  a.flags = flags;
  a.wt = wt;
  cudaError_t err = ensure_smem(fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (mma_des) {
    mma::JetArgs m;
    m.net = a.net;
    m.X = X;
    m.ct = ct;
    m.params = params;
    m.partial = partial;
    m.scratch = scratch;
    m.out = nullptr;
    m.N = N;
    m.T = T;
    m.n_tiles = a.n_tiles;
    m.row = a.net.P;
    m.flags = flags;
    ((void (*)(mma::JetArgs))fn)<<<G, NT, smem_bytes, s>>>(m);
  } else {
    ((PBwdKernelFn)fn)<<<G, NT, smem_bytes, s>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows(partial, G, a.net.P, out, s);
}

// Resident blocks per SM of a variant at a dynamic shared-memory size.
int fwdlap_backward_blocks_per_sm(int fold, int bf16, int des, int smem_bytes, int* blocks) {
  const void* fn = bwd_variant_fn(fold, bf16, des);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = ensure_smem(fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT, smem_bytes);
}

// The shared-memory bytes the kernel lays out for (T, flags), or -1 for a
// net it does not take.
int fwdlap_backward_smem_bytes(const int* layers, int n_layers, int T, int flags) {
  Net net;
  if (!make_net(1, layers, n_layers, 0, &net, true)) return -1;
  return 4 * bwd_smem_floats(net, T, flags);
}

// The tensor-core design's shared-memory bytes for (T, flags) and its
// saved-stage floats per block, or -1 for a net or tile it does not take.
int fwdlap_backward_mma_smem_bytes(const int* layers, int n_layers, int T, int flags) {
  Net net;
  mma::Geo g;
  if (!mma_net(layers, n_layers, T, &net, &g)) return -1;
  return mma::layout(net, g, flags, mma::KIND_BWD).total;
}

int fwdlap_backward_mma_scratch_floats(const int* layers, int n_layers, int T) {
  Net net;
  mma::Geo g;
  if (!mma_net(layers, n_layers, T, &net, &g)) return -1;
  return (int)mma::scratch_floats(net, g, mma::KIND_BWD);
}

}  // extern "C"
