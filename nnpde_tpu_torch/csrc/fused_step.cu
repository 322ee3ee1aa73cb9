// Fused PINN / Deep-Ritz loss + parameter gradients in one pass per tile.
//
// Replaces the Pallas kernels of nnpde_tpu/kernels/fused_step.py:
//   fused_linear_residual_kernel   <- _fused_kernel           (r linear in the
//                                     net jet, (N, d+4) coefficient stream)
//   fused_poisson_analytic_kernel  <- _fused_analytic_kernel  (coefficients of
//                                     the box-FBC prod-sin Poisson problem
//                                     built in-kernel from X; only X is read)
//   fused_drm_energy_kernel        <- _fused_drm_kernel       (Deep-Ritz
//                                     energy, no Laplacian stream)
// plus reduce_rows, the deterministic cross-block sum that takes the
// place of the TPU's accumulation over its sequential grid.
//
// What bounds it on the H100: operations.  The jet recompute and the reverse
// sweep cost ~3*(d+2)*sum(n_in*n_out) multiply-adds per point (2.995e5 FLOP
// at d=2, layers 2-64-64-64-64-1) against 32 bytes read per point, so the
// fp32 CUDA-core rate is the ceiling (TF32 tensor cores are ruled out by
// the 1e-5 gradient bar).  What the design does about it: every layer of a
// tile is one shared-memory product over all d+2 streams at once with a
// 4 x 4 register tile per thread (fwdlap_core.cuh); tiles of 16 points keep
// three blocks resident per SM; weights and saved stages move by cp.async;
// only the earlier stages' pre-activations leave the SM (see
// fwdlap_core.cuh for that scratch traffic).
//
// The bf16-dot mode (BF16 variants of the linear and analytic kernels;
// the TPU kernels' dot_dtype='bfloat16', which the bulk of
// compute_dtype='hybrid-kernel' runs): every product operand rounded to
// bf16, fp32 accumulation, on the same CUDA-core FFMA products
// (fwdlap_core.cuh, "BF16").  Bound: the same FLOP at the fp32 CUDA-core
// rate; the rounding adds two instructions per operand read, so this
// variant is no faster than the fp32 one.  The H100's bf16 tensor cores
// (989 TFLOP/s dense) are where such a mode earns its speed, and moving
// the 4 x 4 register tiles onto mma/wgmma fragments is a redesign of its
// own.  The DRM kernel has no BF16 variant (no caller passes one).
//
// Interface: plain C (ctypes), float32 only, row-major (in, out) weights
// flattened as [W0, b0, W1, b1, ...].  Every entry point launches on the
// given stream, never synchronises, and returns cudaGetLastError().
#include "fwdlap_core.cuh"

using namespace fwdlap;

namespace {

enum Mode { MODE_LINEAR = 0, MODE_ANALYTIC = 1, MODE_DRM = 2 };

struct Analytic {
  float L, a0, fscale;        // box side, operator scale, sum_i (k_i pi / L)^2
  float kpi[MAX_DIM];         // k_i pi / L
};

struct Args {
  Net net;
  const float* X;
  const float* coef;
  const float* params;
  float* partial;             // (G, row): per-block [grads (P) | sums (3)]
  float* scratch;             // (G, K-2, S, T, wmax) saved pre-activations
  int N, T, n_tiles, row;
  Analytic an;
};

// In-kernel coefficients of r = a0*lap(B*net) - f for B = prod x_i (L - x_i)
// (_poisson_sin_coef_builder): a = a0*B, b_i = 2*a0*dB_i, c = a0*lapB.
__device__ __forceinline__ void poisson_sin_coef(const Analytic& an, int d,
                                                 const float* x, float& c,
                                                 float* b, float& a, float& rhs) {
  float gi[MAX_DIM];
  float B = 1.f, s = 1.f;
  for (int i = 0; i < d; ++i) {
    gi[i] = x[i] * (an.L - x[i]);
    B *= gi[i];
    s *= sinf(an.kpi[i] * x[i]);
  }
  float lapB = 0.f;
  for (int i = 0; i < d; ++i) {
    float pe = 1.f;                       // prod over j != i, division-free
    for (int j = 0; j < d; ++j)
      if (j != i) pe *= gi[j];
    b[i] = 2.f * an.a0 * ((an.L - 2.f * x[i]) * pe);
    lapB += -2.f * pe;
  }
  a = an.a0 * B;
  c = an.a0 * lapB;
  rhs = -(an.fscale * s);
}

template <int MODE, bool FOLD, bool BF16>
__device__ void fused_body(const Args& A) {
  extern __shared__ __align__(16) float smem[];
  const Net& net = A.net;
  const int T = A.T, d = net.d, S = net.S, ld = net.wmax;
  float* bufA = smem;
  float* bufB = bufA + S * T * ld;
  float* bufC = bufB + S * T * ld;        // pre-activations of one stage
  float* Wsh = bufC + S * T * ld;
  float* xs = Wsh + ld * ld;
  float* ct = xs + T * d;                 // [ct_v | ct_g (d) | ct_l] x T
  float* ps = ct + (d + 2) * T;           // per-point sum terms, 3 x T
  float* proj = ps + 3 * T;               // projected streams, S x T
  float* red = proj + S * T;              // reduction scratch, NT
  float* grow = A.partial + (size_t)blockIdx.x * A.row;
  float* scratch = A.scratch + (size_t)blockIdx.x * (net.K - 2) * S * T * ld;

  for (int i = threadIdx.x; i < A.row; i += NT) grow[i] = 0.f;
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
    fwd_recompute<false, FOLD, BF16>(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch);
    project_last(net, T, cur, wlast, blast, proj);
    __syncthreads();
    // per-point loss terms and cotangent seeds
    for (int p = threadIdx.x; p < T; p += NT) {
      const bool valid = base + p < A.N;
      float g[MAX_DIM];
      const float value = proj[p];
      for (int i = 0; i < d; ++i) g[i] = proj[(1 + i) * T + p];
      const float lapv = net.lap ? proj[(d + 1) * T + p] : 0.f;

      float s0 = 0.f, s1 = 0.f, s2 = 0.f, ctv = 0.f, ctl = 0.f;
      if (MODE == MODE_DRM) {
        const float* cf = A.coef + (size_t)(base + p) * (d + 2);
        const float B = valid ? cf[0] : 0.f;
        const float f = valid ? cf[d + 1] : 0.f;
        float e = 0.f;
        for (int i = 0; i < d; ++i) {
          const float dB = valid ? cf[1 + i] : 0.f;
          const float G = B * g[i] + dB * value;
          e += 0.5f * G * G;
          ctv += G * dB;
          ct[(1 + i) * T + p] = G * B;
        }
        e -= f * B * value;
        ctv -= f * B;
        s0 = e;
        s1 = ctv;
      } else {
        float c, a, rhs, e = 0.f, bb[MAX_DIM];
        if (MODE == MODE_LINEAR) {
          const float* cf = A.coef + (size_t)(base + p) * (d + 4);
          c = valid ? cf[0] : 0.f;
          for (int i = 0; i < d; ++i) bb[i] = valid ? cf[1 + i] : 0.f;
          a = valid ? cf[d + 1] : 0.f;
          rhs = valid ? cf[d + 2] : 0.f;
          e = valid ? cf[d + 3] : 0.f;
        } else {
          poisson_sin_coef(A.an, d, xs + p * d, c, bb, a, rhs);
        }
        float r = c * value + a * lapv + rhs;
        for (int i = 0; i < d; ++i) r += bb[i] * g[i];
        if (!valid) r = 0.f;
        s0 = r * r;
        s1 = r * c;
        s2 = r * e * value;
        ctv = r * c;
        ctl = r * a;
        for (int i = 0; i < d; ++i) ct[(1 + i) * T + p] = r * bb[i];
      }
      ct[p] = ctv;
      ct[(d + 1) * T + p] = ctl;
      ps[p] = s0;
      ps[T + p] = s1;
      ps[2 * T + p] = s2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int p = 0; p < T; ++p) {
        a0 += ps[p];
        a1 += ps[T + p];
        a2 += ps[2 * T + p];
      }
      grow[net.P] += a0;
      grow[net.P + 1] += a1;
      grow[net.P + 2] += a2;
    }
    reverse_sweep<false, FOLD, BF16>(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch, ct,
                                     red, grow);
  }
}

}  // namespace

// (each kernel in two variants: FOLD, the activation in the products'
// epilogues, for nets with at most 4 streams; and the linear and analytic
// kernels in BF16 variants, the bf16-dot mode; the wrapper chooses)
template <bool FOLD, bool BF16>
__global__ void __launch_bounds__(NT) fused_linear_residual_kernel(Args a) {
  fused_body<MODE_LINEAR, FOLD, BF16>(a);
}
template <bool FOLD, bool BF16>
__global__ void __launch_bounds__(NT) fused_poisson_analytic_kernel(Args a) {
  fused_body<MODE_ANALYTIC, FOLD, BF16>(a);
}
template <bool FOLD>
__global__ void __launch_bounds__(NT) fused_drm_energy_kernel(Args a) {
  fused_body<MODE_DRM, FOLD, false>(a);
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

typedef void (*KernelFn)(Args);

KernelFn kernel_for(int mode, int fold, int bf16) {
  switch (mode) {
    case MODE_LINEAR:
      if (bf16)
        return fold ? fused_linear_residual_kernel<true, true>
                    : fused_linear_residual_kernel<false, true>;
      return fold ? fused_linear_residual_kernel<true, false>
                  : fused_linear_residual_kernel<false, false>;
    case MODE_ANALYTIC:
      if (bf16)
        return fold ? fused_poisson_analytic_kernel<true, true>
                    : fused_poisson_analytic_kernel<false, true>;
      return fold ? fused_poisson_analytic_kernel<true, false>
                  : fused_poisson_analytic_kernel<false, false>;
    case MODE_DRM:
      if (bf16) return nullptr;
      return fold ? fused_drm_energy_kernel<true> : fused_drm_energy_kernel<false>;
    default: return nullptr;
  }
}

int launch(int mode, const float* X, const float* coef, const float* params,
           const int* layers, int n_layers, int act, int N, int T, int G, int fold,
           int bf16, const float* analytic, float* partial, float* scratch, float* out,
           int smem_bytes, void* stream) {
  Args a;
  if (!make_net(mode == MODE_DRM ? 0 : 1, layers, n_layers, act, &a.net) || N < 1 || T < 4 ||
      T % 4 != 0 || G < 1 || (fold && a.net.S > 4))
    return (int)cudaErrorInvalidValue;
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
  KernelFn fn = kernel_for(mode, fold, bf16);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fn<<<G, NT, smem_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows(partial, G, a.row, out, s);
}

}  // namespace

extern "C" {

// fold: the variant with the activation in the products' epilogues (nets
// with at most 4 streams); bf16: the bf16-dot variant.  Tensors are float32
// in every variant.
int fused_linear_residual_f32(const float* X, const float* coef,
                              const float* params, const int* layers,
                              int n_layers, int act, int N, int T, int G, int fold,
                              int bf16, float* partial, float* scratch, float* out,
                              int smem_bytes, void* stream) {
  return launch(MODE_LINEAR, X, coef, params, layers, n_layers, act, N, T, G, fold,
                bf16, nullptr, partial, scratch, out, smem_bytes, stream);
}

int fused_poisson_analytic_f32(const float* X, const float* params,
                               const int* layers, int n_layers, int act, int N,
                               int T, int G, int fold, int bf16, const float* analytic,
                               float* partial, float* scratch, float* out,
                               int smem_bytes, void* stream) {
  return launch(MODE_ANALYTIC, X, nullptr, params, layers, n_layers, act, N, T,
                G, fold, bf16, analytic, partial, scratch, out, smem_bytes, stream);
}

int fused_drm_energy_f32(const float* X, const float* coef, const float* params,
                         const int* layers, int n_layers, int act, int N, int T,
                         int G, int fold, float* partial, float* scratch, float* out,
                         int smem_bytes, void* stream) {
  return launch(MODE_DRM, X, coef, params, layers, n_layers, act, N, T, G, fold, 0,
                nullptr, partial, scratch, out, smem_bytes, stream);
}

// Resident blocks per SM for a mode and variant at a dynamic shared-memory
// size.
int fused_blocks_per_sm(int mode, int fold, int bf16, int smem_bytes, int* blocks) {
  KernelFn fn = kernel_for(mode, fold, bf16);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT, smem_bytes);
  return (int)err;
}

}  // extern "C"
