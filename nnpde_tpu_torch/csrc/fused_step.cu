// Fused PINN / Deep-Ritz loss + parameter gradients in one pass per tile.
//
// Replaces the Pallas kernels of nnpde_tpu/kernels/fused_step.py:
//   fused_linear_residual_planned  <- _fused_kernel           (r linear in the
//                                     net jet, (N, d+4) coefficient stream)
//   fused_poisson_analytic_planned <- _fused_analytic_kernel  (coefficients of
//                                     the box-FBC prod-sin Poisson problem
//                                     built in-kernel from X; only X is read)
//   fused_drm_energy_planned       <- _fused_drm_kernel       (Deep-Ritz
//                                     energy, no Laplacian stream)
// (fp32; the bf16-dot mode of all three is fused_step_mma.cu's
// fused_mma_kernel, and on the nets beyond the other kernels' limits its
// fused_mma_beyond)
// plus reduce_rows, the deterministic cross-block sum that takes the
// place of the TPU's accumulation over its sequential grid.
//
// What bounds it on the H100: operations.  The jet recompute and the reverse
// sweep cost ~3*(d+2)*sum(n_in*n_out) multiply-adds per point (2.995e5 FLOP
// at d=2, layers 2-64-64-64-64-1) against 32 bytes read per point, so the
// fp32 CUDA-core rate is the ceiling (TF32 tensor cores are ruled out by
// the 1e-5 gradient bar).  What the design does about it: every layer of a
// tile is one shared-memory product over all d+2 streams at once
// (fwdlap_core.cuh); weights and saved stages move by cp.async; only the
// earlier stages' pre-activations leave the SM.  Two sets of kernels:
//   * the planned design (fused_body_p on fwdlap_planned.cuh) -- the fp32
//     kernels: the launch plan of kernels/_plan.py at two blocks per SM,
//     the hidden weights' transposes read from device memory, dW items dealt
//     4 x 8 to a warp, and two-point items where their one-wave tile fits
//     (fwdlap_planned.cuh has the design and what it is for); the three
//     also take nets beyond the other kernels' limits (a hidden width above
//     NT, d above CORE_DIM: DES_BEYOND, whose loss terms keep no per-point
//     arrays; more than CORE_LAYERS weight matrices in any design;
//     ROADMAP.md B7);
//   * the tensor-core design (body<KIND_FUSED> of fwdlap_mma.cuh, DES_MMA) --
//     the bf16-dot mode of the three kernels (the TPU kernels'
//     dot_dtype='bfloat16', which the bulk of compute_dtype='hybrid-kernel'
//     runs on the linear and analytic ones): every product operand rounded
//     to bf16 and fp32 accumulation, which is what mma.sync m16n8k16 bf16
//     computes; bound: the same FLOP at 989 TFLOP/s, so the elementwise
//     stages and barriers set its pace (fwdlap_mma.cuh has the design and
//     its levers).  The DRM kernel's policy is the Ritz energy's terms on
//     the body without the Laplacian stream (LAP = false, S = d + 1).  The
//     body takes the nets beyond the other kernels' limits as it is; the
//     loss terms there are the DES_BEYOND ones of the planned design, in
//     fused_mma_beyond (DES_MMA | DES_BEYOND; ROADMAP.md B7).  These kernels
//     live in fused_step_mma.cu, which nvcc compiles beside this file; the
//     two share fused_terms.cuh.
//
// Interface: plain C (ctypes), float32 only, row-major (in, out) weights
// flattened as [W0, b0, W1, b1, ...].  Every entry point launches on the
// given stream, never synchronises, and returns cudaGetLastError().
#include "fwdlap_mma.cuh"
#include "fused_terms.cuh"

using namespace fwdlap;

namespace {

// Shared-memory floats of one block for (T, flags): fused_body_p's layout.
// Mirrored by kernels/fused_step.py::smem_floats.
__host__ __device__ inline int fused_smem_floats(const Net& net, int T, int flags) {
  const int d = net.d, S = net.S, ld = net.wmax, stage = S * T * ld;
  int n = 3 * stage + ((flags & DEV_WEIGHTS)   ? 0
                       : (flags & RES_WEIGHTS) ? 2 * hidden_floats(net)
                                               : ld * ld);
  if (flags & RES_GRAD) n += (net.P + 3 + 3) & ~3;
  return n + T * d + (d + 2) * T + 3 * T + S * T + NT;
}

// The planned design (fwdlap_planned.cuh, DES_PLANNED): a tile's recompute
// (fwd_recompute_p), loss terms and reverse sweep (reverse_sweep_p), with
// the plan's residency from A.flags (hidden weights and their transposes,
// the block's gradient row).
template <int MODE, bool FOLD, int DES>
__device__ void fused_body_p(const PArgs& A) {
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
    at += (A.row + 3) & ~3;
  }
  float* xs = at;
  float* ct = xs + T * d;                 // [ct_v | ct_g (d) | ct_l] x T
  float* ps = ct + (d + 2) * T;           // per-point sum terms, 3 x T
  float* proj = ps + 3 * T;               // projected streams, S x T
  float* red = proj + S * T;              // reduction scratch, NT
  float* grow_g = A.partial + (size_t)blockIdx.x * A.row;
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

  for (int i = threadIdx.x; i < A.row; i += NT) grow[i] = 0.f;
  if (res_w) copy_wait();
  __syncthreads();

  const int K = net.K;
  const int wl = net.w[K - 1];
  const float* wlast = A.params + net.off[K - 1];
  const float blast = wlast[wl];

  for (int tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    load_tile(A.X, A.N, d, base, T, xs);
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    fwd_recompute_p<FOLD, DES>(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch, res);
    project_last(net, T, cur, wlast, blast, proj);
    __syncthreads();
    point_terms<MODE, (DES & DES_BEYOND) != 0>(A, T, base, proj, xs, ct, ps, grow);
    reverse_sweep_p<FOLD, DES>(net, T, xs, A.params, A.wt, cur, nxt, bufC, Wsh, scratch, ct,
                               red, grow, res);
  }
  // the row on chip goes out once (the last tile ended in a barrier)
  if (gacc)
    for (int i = threadIdx.x; i < A.row; i += NT) grow_g[i] = gacc[i];
}

}  // namespace

// The planned kernels come in two variants (FOLD, the activation in the
// products' epilogues, for nets with at most 4 streams); the wrapper
// chooses.
// the planned design (DES != 0) at two blocks per SM: the plan counts on
// them, so the register budget is stated
template <bool FOLD, int DES>
__global__ void __launch_bounds__(NT, 2) fused_linear_residual_planned(PArgs a) {
  fused_body_p<MODE_LINEAR, FOLD, DES>(a);
}
template <bool FOLD, int DES>
__global__ void __launch_bounds__(NT, 2) fused_poisson_analytic_planned(PArgs a) {
  fused_body_p<MODE_ANALYTIC, FOLD, DES>(a);
}
template <bool FOLD, int DES>
__global__ void __launch_bounds__(NT, 2) fused_drm_energy_planned(PArgs a) {
  fused_body_p<MODE_DRM, FOLD, DES>(a);
}
// out[j] = sum_g partial[g][j].  One loop over all G rows per output is a
// chain of G dependent load latencies whatever the row length (~8 us of
// every launch at G = 400..500, measured): 32 row groups per output make the
// chain 32 times shorter, the loads stay coalesced along j, and the order of
// the additions stays fixed.
__global__ void __launch_bounds__(1024) reduce_rows_kernel(const float* __restrict__ partial,
                                                           int G, int R,
                                                           float* __restrict__ out) {
  __shared__ double part[32][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  // accumulated in double and rounded once: a float running sum over G
  // (~500) rows loses ~sqrt(G) ulps, which a quotient's seeds amplify
  double s = 0.0;
  if (j < R)
    for (int g = threadIdx.y; g < G; g += 32) s += (double)partial[(size_t)g * R + j];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < R) {
    double t = 0.0;
    for (int y = 0; y < 32; ++y) t += part[y][threadIdx.x];
    out[j] = (float)t;
  }
}

cudaError_t reduce_rows(const float* partial, int G, int R, float* out, cudaStream_t stream) {
  reduce_rows_kernel<<<(R + 31) / 32, dim3(32, 32), 0, stream>>>(partial, G, R, out);
  return cudaGetLastError();
}

namespace {

typedef void (*PKernelFn)(PArgs);

template <int MODE, bool FOLD, int DES>
PKernelFn planned_of() {
  if constexpr (MODE == MODE_LINEAR) return fused_linear_residual_planned<FOLD, DES>;
  else if constexpr (MODE == MODE_ANALYTIC) return fused_poisson_analytic_planned<FOLD, DES>;
  else return fused_drm_energy_planned<FOLD, DES>;
}

template <int MODE, bool FOLD>
PKernelFn planned_by(int des) {
  switch (des) {
    case DES_PLANNED: return planned_of<MODE, FOLD, DES_PLANNED>();
    case DES_PLANNED | DES_ITEM2: return planned_of<MODE, FOLD, DES_PLANNED | DES_ITEM2>();
    case DES_PLANNED | DES_DEVW:
      if constexpr (FOLD) return nullptr;
      else return planned_of<MODE, false, DES_PLANNED | DES_DEVW>();
    // the nets beyond the other kernels' limits (beyond_net): no fold
    case DES_PLANNED | DES_BEYOND:
      if constexpr (FOLD) return nullptr;
      else return planned_of<MODE, false, DES_PLANNED | DES_BEYOND>();
    case DES_PLANNED | DES_DEVW | DES_BEYOND:
      if constexpr (FOLD) return nullptr;
      else return planned_of<MODE, false, DES_PLANNED | DES_DEVW | DES_BEYOND>();
    default: return nullptr;
  }
}

PKernelFn planned_for(int mode, int fold, int des) {
  switch (mode) {
    case MODE_LINEAR:
      return fold ? planned_by<MODE_LINEAR, true>(des) : planned_by<MODE_LINEAR, false>(des);
    case MODE_ANALYTIC:
      return fold ? planned_by<MODE_ANALYTIC, true>(des)
                  : planned_by<MODE_ANALYTIC, false>(des);
    case MODE_DRM:
      return fold ? planned_by<MODE_DRM, true>(des) : planned_by<MODE_DRM, false>(des);
    default: return nullptr;
  }
}

// The kernel of a variant, as the pointer the occupancy calls take: the
// bf16-dot mode runs the tensor-core design (des DES_MMA, with DES_WIDE its
// wide variant, with DES_BEYOND its variant for the nets of beyond_net),
// and only it; fp32 a planned design.
const void* variant_fn(int mode, int fold, int bf16, int des) {
  if (bf16) {
    if ((des & ~(mma::DES_WIDE | DES_BEYOND)) != DES_MMA || fold) return nullptr;
    const bool wide = (des & mma::DES_WIDE) != 0, beyond = (des & DES_BEYOND) != 0;
    return fused_mma_fn(mode, wide, beyond);
  }
  return (const void*)planned_for(mode, fold, des);
}

int launch(int mode, const float* X, const float* coef, const float* params,
           const float* wt, const int* layers, int n_layers, int act, int N, int T, int G,
           int fold, int bf16, int des, int flags, const float* analytic, float* partial,
           float* scratch, float* out, int smem_bytes, void* stream) {
  PArgs a;
  const void* fn = variant_fn(mode, fold, bf16, des);
  // both modes take the nets beyond the other kernels' limits, in their
  // DES_BEYOND variant (beyond_net) and only there
  bool ok = fn != nullptr &&
            make_net(mode == MODE_DRM ? 0 : 1, layers, n_layers, act, &a.net, true) &&
            N >= 1 && G >= 1;
  if (ok && (des & DES_MMA)) {
    mma::Geo g;
    const bool lap = a.net.lap != 0;
    ok = mma::flags_ok(flags, mma::KIND_FUSED) && mma::make_geo(a.net, T, &g, lap) &&
         scratch != nullptr &&
         mma::layout(a.net, g, flags, mma::KIND_FUSED, lap).total <= smem_bytes &&
         (!mma::needs_wide(a.net, flags) || (des & mma::DES_WIDE)) &&
         ((des & DES_BEYOND) != 0) == beyond_net(a.net);
  } else if (ok) {
    ok = flags >= 0 && flags <= 15 && ((flags & DEV_WEIGHTS) != 0) == ((des & DES_DEVW) != 0) &&
         !((flags & DEV_WEIGHTS) && (flags & RES_WEIGHTS)) &&
         T >= 4 && T % 4 == 0 && T <= NT / 2 && !(fold && a.net.S > 4) &&
         !(a.net.K > 2 && (scratch == nullptr || wt == nullptr)) &&
         ((des & DES_BEYOND) != 0) == beyond_net(a.net) &&
         4 * fused_smem_floats(a.net, T, flags) <= smem_bytes;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  a.X = X;
  a.coef = coef;
  a.params = params;
  a.partial = partial;
  a.scratch = scratch;
  a.N = N;
  a.T = T;
  a.n_tiles = (N + T - 1) / T;
  a.row = a.net.P + 3;
  a.an.L = a.an.a0 = a.an.fscale = 0.f;
  for (int i = 0; i < MAX_DIM; ++i) a.an.kpi[i] = 0.f;
  if (mode == MODE_ANALYTIC) {
    a.an.L = analytic[0];
    a.an.a0 = analytic[1];
    a.an.fscale = analytic[2];
    for (int i = 0; i < a.net.d; ++i) a.an.kpi[i] = analytic[3 + i];
  }
  a.wt = wt;
  a.flags = flags;
  cudaError_t err = ensure_smem(fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  ((PKernelFn)fn)<<<G, NT, smem_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows(partial, G, a.row, out, s);
}

// The net and tile geometry of a tensor-core query (fused_mma_*): the DRM
// energy's net without the Laplacian stream.
bool mma_net(int mode, const int* layers, int n_layers, int T, Net* net, mma::Geo* g) {
  return mode >= MODE_LINEAR && mode <= MODE_DRM &&
         make_net(mode == MODE_DRM ? 0 : 1, layers, n_layers, 0, net, true) &&
         mma::make_geo(*net, T, g, mode != MODE_DRM);
}

}  // namespace

extern "C" {

// fold: the variant with the activation in the products' epilogues (nets
// with at most 4 streams; a planned design); bf16: the bf16-dot mode, which
// runs the tensor-core design (des DES_MMA, with DES_WIDE where
// mma::needs_wide) and only it; des: the design (fwdlap_planned.cuh,
// Design; DES_MMA, fwdlap_mma.cuh; the tensor-core design's flags may add
// DEV_WEIGHTS and DEV_SUMS, the latter with the sums in scratch,
// mma::scratch_floats with the flags); flags: the plan's
// Flags.  smem_bytes must hold the layout for (T, flags).  params: the flat
// [W0, b0, W1, b1, ...]; wt: the hidden weights' transposes W_1^T, ...,
// W_{K-2}^T (true sizes, row-major, back to back), read by a planned design
// (null for the tensor-core design, which reads W_k both ways); with
// DES_DEVW the hidden weights and then their transposes, each rounded up to
// multiples of 4 with zeros, back to back (the resident layout).  scratch:
// the saved stages, (G, K-2, S, T, wmax) floats in a planned design, (G,
// fused_mma_scratch_floats) in the tensor-core one.  Tensors are float32 in
// every variant.
int fused_linear_residual_f32(const float* X, const float* coef,
                              const float* params, const float* wt, const int* layers,
                              int n_layers, int act, int N, int T, int G, int fold,
                              int bf16, int des, int flags, float* partial, float* scratch,
                              float* out, int smem_bytes, void* stream) {
  return launch(MODE_LINEAR, X, coef, params, wt, layers, n_layers, act, N, T, G, fold,
                bf16, des, flags, nullptr, partial, scratch, out, smem_bytes, stream);
}

int fused_poisson_analytic_f32(const float* X, const float* params, const float* wt,
                               const int* layers, int n_layers, int act, int N,
                               int T, int G, int fold, int bf16, int des, int flags,
                               const float* analytic, float* partial, float* scratch,
                               float* out, int smem_bytes, void* stream) {
  return launch(MODE_ANALYTIC, X, nullptr, params, wt, layers, n_layers, act, N, T,
                G, fold, bf16, des, flags, analytic, partial, scratch, out, smem_bytes,
                stream);
}

int fused_drm_energy_f32(const float* X, const float* coef, const float* params,
                         const float* wt, const int* layers, int n_layers, int act, int N, int T,
                         int G, int fold, int bf16, int des, int flags, float* partial,
                         float* scratch, float* out, int smem_bytes, void* stream) {
  return launch(MODE_DRM, X, coef, params, wt, layers, n_layers, act, N, T, G, fold, bf16, des,
                flags, nullptr, partial, scratch, out, smem_bytes, stream);
}

// Resident blocks per SM for a mode and variant at a dynamic shared-memory
// size.
int fused_blocks_per_sm(int mode, int fold, int bf16, int des, int smem_bytes, int* blocks) {
  const void* fn = variant_fn(mode, fold, bf16, des);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = ensure_smem(fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT, smem_bytes);
}

// The shared-memory bytes the kernels lay out for (T, flags), or -1 for a
// mode or net they do not take.
int fused_smem_bytes(int mode, const int* layers, int n_layers, int T, int flags) {
  Net net;
  if (mode < MODE_LINEAR || mode > MODE_DRM ||
      !make_net(mode == MODE_DRM ? 0 : 1, layers, n_layers, 0, &net, true))
    return -1;
  return 4 * fused_smem_floats(net, T, flags);
}

// The tensor-core design's shared-memory bytes for (T, flags) and its
// saved-stage floats per block, or -1 for a mode, net or tile it does not
// take.
int fused_mma_smem_bytes(int mode, const int* layers, int n_layers, int T, int flags) {
  Net net;
  mma::Geo g;
  if (!mma_net(mode, layers, n_layers, T, &net, &g)) return -1;
  return mma::layout(net, g, flags, mma::KIND_FUSED, mode != MODE_DRM).total;
}

int fused_mma_scratch_floats(int mode, const int* layers, int n_layers, int T) {
  Net net;
  mma::Geo g;
  if (!mma_net(mode, layers, n_layers, T, &net, &g)) return -1;
  return (int)mma::scratch_floats(net, g, mma::KIND_FUSED);
}

}  // extern "C"
