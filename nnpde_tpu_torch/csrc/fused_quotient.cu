// Two-pass fused kernels of the quotient losses (WAN weak form, Rayleigh,
// quadratic means): pass A sums, pass B seeded gradients.
//
// Replaces the Pallas kernels of nnpde_tpu/kernels/fused_quotient.py:
//   linear_sums_kernel   <- _linear_sums_kernel   sum r, sum r^2,
//                           sum (e1 v)^2, sum e2 v; coef [c, b.., a, rhs,
//                           e1, e2] (N, d+5), r = c v + b.g + a lap + rhs
//   linear_seeded_kernel <- _linear_seeded_kernel dW/db of s_r sum r +
//                           s_q sum (e1 v)^2 + s_l sum e2 v, and sum ct_v
//   quad_sums_kernel     <- _quad_sums_kernel     sum e, sum u^2 with u =
//                           B v, G = B g + v dB, e = |G|^2/2 - f u + V u^2;
//                           coef [B, dB.., f, V] (N, d+3)
//   quad_seeded_kernel   <- _quad_seeded_kernel   dW/db of s_e sum e +
//                           s_q sum u^2, and sum ct_v
// Here v, g, lap are the raw net's value (with the last bias), gradient
// and Laplacian.  The seeds s_* are global scalars that the caller forms
// on the device from pass A's sums; they are read from device memory
// (`scal`), never passed by value, so no objective waits on the host.
//
// What bounds them on the H100: operations.  Pass A is the forward
// recompute only, (d+1 or d+2)*sum(n_in*n_out) multiply-adds per point;
// pass B adds the reverse sweep, about three times that; both against
// 4*(d+1+nc) bytes per point.  What the design does about it: the shared
// per-tile core (fwdlap_core.cuh), the Laplacian stream dropped where the
// loss never reads it (the WAN weak forms, every quadratic energy), and
// pass A saves no stages, so the scratch traffic of the reverse sweep is
// paid by pass B alone.
//
// Determinism: the rule of fused_step.cu -- per-block partial rows, fixed
// in-block orders, one ordered reduction, no atomics.  The sums are carried
// in double from the tile up (a quotient's seeds amplify their error).
//
// Interface: plain C (ctypes), float32 only, weights flattened as
// [W0, b0, W1, b1, ...].  Every entry point launches on the given stream,
// never synchronises, and returns cudaGetLastError().
#include "fwdlap_core.cuh"

using namespace fwdlap;

namespace {

enum Kind { LIN_SUMS = 0, LIN_SEEDED = 1, QUAD_SUMS = 2, QUAD_SEEDED = 3 };

struct QArgs {
  Net net;
  const float* X;
  const float* coef;          // (N, nc)
  const float* params;
  const float* scal;          // pass B seeds (3 linear, 2 quadratic)
  float* partial;             // (G, row): sums, or [grads (P) | sum ct_v]
  float* scratch;             // (G, K-2, S, T, wmax), pass B only
  int N, T, n_tiles, row;
};

template <int KIND>
__device__ void quotient_body(const QArgs& A) {
  constexpr bool SEEDED = KIND == LIN_SEEDED || KIND == QUAD_SEEDED;
  constexpr bool LINEAR = KIND == LIN_SUMS || KIND == LIN_SEEDED;
  constexpr int NSUMS = SEEDED ? 1 : (LINEAR ? 4 : 2);
  extern __shared__ __align__(16) float smem[];
  const Net& net = A.net;
  const int T = A.T, d = net.d, S = net.S, ld = net.wmax;
  const int nc = LINEAR ? d + 5 : d + 3;
  float* bufA = smem;
  float* bufB = bufA + S * T * ld;
  float* bufC = SEEDED ? bufB + S * T * ld : nullptr;   // last stage's pre-acts
  float* Wsh = bufB + (SEEDED ? 2 : 1) * S * T * ld;
  float* xs = Wsh + ld * ld;
  float* ct = xs + T * d;                 // [ct_v | ct_g (d) | ct_l] x T
  float* ps = ct + (d + 2) * T;           // per-point sum terms, NSUMS x T
  float* proj = ps + NSUMS * T;           // projected streams, S x T
  float* red = proj + S * T;              // reduction scratch, NT
  float* grow = A.partial + (size_t)blockIdx.x * A.row;
  float* scratch =
      SEEDED ? A.scratch + (size_t)blockIdx.x * (net.K - 2) * S * T * ld : nullptr;
  const int sum_off = SEEDED ? net.P : 0;

  for (int i = threadIdx.x; i < A.row; i += NT) grow[i] = 0.f;
  __syncthreads();

  const float* wlast = A.params + net.off[net.K - 1];
  const float blast = wlast[net.w[net.K - 1]];
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  if (SEEDED) {
    s0 = A.scal[0];
    s1 = A.scal[1];
    s2 = LINEAR ? A.scal[2] : 0.f;
  }

  double blk_sum = 0.0;
  for (int tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    load_tile(A.X, A.N, d, base, T, xs);
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    fwd_recompute(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch);
    project_last(net, T, cur, wlast, blast, proj);
    __syncthreads();
    // per-point sum terms (and cotangents); padded rows read zero
    // coefficients, so every term and cotangent vanishes there
    for (int p = threadIdx.x; p < T; p += NT) {
      const bool valid = base + p < A.N;
      const float* cf = A.coef + (size_t)(base + p) * nc;
      const float v = proj[p];
      if (LINEAR) {
        const float c = valid ? cf[0] : 0.f;
        const float a = valid ? cf[d + 1] : 0.f;
        const float rhs = valid ? cf[d + 2] : 0.f;
        const float e1 = valid ? cf[d + 3] : 0.f;
        const float e2 = valid ? cf[d + 4] : 0.f;
        if (SEEDED) {
          const float ctv = s0 * c + s1 * 2.0f * e1 * e1 * v + s2 * e2;
          ct[p] = ctv;
          for (int i = 0; i < d; ++i) ct[(1 + i) * T + p] = s0 * (valid ? cf[1 + i] : 0.f);
          ct[(d + 1) * T + p] = s0 * a;
          ps[p] = ctv;
        } else {
          float r = c * v + rhs;
          if (net.lap) r += a * proj[(d + 1) * T + p];
          for (int i = 0; i < d; ++i) r += (valid ? cf[1 + i] : 0.f) * proj[(1 + i) * T + p];
          const float m = e1 * v;
          ps[p] = r;
          ps[T + p] = r * r;
          ps[2 * T + p] = m * m;
          ps[3 * T + p] = e2 * v;
        }
      } else {
        const float B = valid ? cf[0] : 0.f;
        const float f = valid ? cf[d + 1] : 0.f;
        const float V = valid ? cf[d + 2] : 0.f;
        const float u = B * v;
        if (SEEDED) {
          float ctv = -f * B + 2.0f * V * u * B;
          for (int i = 0; i < d; ++i) {
            const float dB = valid ? cf[1 + i] : 0.f;
            const float G = B * proj[(1 + i) * T + p] + dB * v;
            ctv += G * dB;
            ct[(1 + i) * T + p] = s0 * G * B;
          }
          ctv = s0 * ctv + s1 * 2.0f * B * B * v;
          ct[p] = ctv;
          ct[(d + 1) * T + p] = 0.f;
          ps[p] = ctv;
        } else {
          float e = -f * u + V * u * u;
          for (int i = 0; i < d; ++i) {
            const float G = B * proj[(1 + i) * T + p] + (valid ? cf[1 + i] : 0.f) * v;
            e += 0.5f * G * G;
          }
          ps[p] = e;
          ps[T + p] = u * u;
        }
      }
    }
    __syncthreads();
    // in-block sums in point order, one thread per sum, carried in double
    // across the block's tiles: the quotient's seeds amplify their error
    if (threadIdx.x < NSUMS)
      for (int p = 0; p < T; ++p) blk_sum += (double)ps[threadIdx.x * T + p];
    if (SEEDED)
      reverse_sweep(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch, ct, red, grow);
    else
      __syncthreads();
  }
  if (threadIdx.x < NSUMS) grow[sum_off + threadIdx.x] = (float)blk_sum;
}

}  // namespace

__global__ void __launch_bounds__(NT) linear_sums_kernel(QArgs a) {
  quotient_body<LIN_SUMS>(a);
}
__global__ void __launch_bounds__(NT) linear_seeded_kernel(QArgs a) {
  quotient_body<LIN_SEEDED>(a);
}
__global__ void __launch_bounds__(NT) quad_sums_kernel(QArgs a) {
  quotient_body<QUAD_SUMS>(a);
}
__global__ void __launch_bounds__(NT) quad_seeded_kernel(QArgs a) {
  quotient_body<QUAD_SEEDED>(a);
}

namespace {

typedef void (*QKernelFn)(QArgs);

QKernelFn qkernel_for(int kind) {
  switch (kind) {
    case LIN_SUMS: return linear_sums_kernel;
    case LIN_SEEDED: return linear_seeded_kernel;
    case QUAD_SUMS: return quad_sums_kernel;
    case QUAD_SEEDED: return quad_seeded_kernel;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// kind: 0 linear sums, 1 linear seeded, 2 quadratic sums, 3 quadratic
// seeded.  lap: carry the Laplacian stream (linear kinds only; 0 is
// no_lap).  scal: device seeds (seeded kinds; else may be null).  partial
// (G, row) and out (row) with row = 4 / P+1 / 2 / P+1; scratch (G, K-2, S,
// T, wmax) for the seeded kinds (else may be null).
int fused_quotient_f32(int kind, int lap, const float* X, const float* coef,
                       const float* params, const float* scal, const int* layers,
                       int n_layers, int act, int N, int T, int G, float* partial,
                       float* scratch, float* out, int smem_bytes, void* stream) {
  QKernelFn fn = qkernel_for(kind);
  const bool linear = kind == LIN_SUMS || kind == LIN_SEEDED;
  const bool seeded = kind == LIN_SEEDED || kind == QUAD_SEEDED;
  QArgs a;
  if (fn == nullptr || (lap != 0 && !linear) ||
      !make_net(lap != 0 ? 1 : 0, layers, n_layers, act, &a.net) || N < 1 || T < 4 ||
      T % 4 != 0 || G < 1)
    return (int)cudaErrorInvalidValue;
  a.X = X;
  a.coef = coef;
  a.params = params;
  a.scal = scal;
  a.partial = partial;
  a.scratch = scratch;
  a.N = N;
  a.T = T;
  a.n_tiles = (N + T - 1) / T;
  a.row = seeded ? a.net.P + 1 : (linear ? 4 : 2);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fn<<<G, NT, smem_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows(partial, G, a.row, out, s);
}

// Resident blocks per SM for a kind at a dynamic shared-memory size.
int fused_quotient_blocks_per_sm(int kind, int smem_bytes, int* blocks) {
  QKernelFn fn = qkernel_for(kind);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT, smem_bytes);
}

}  // extern "C"
