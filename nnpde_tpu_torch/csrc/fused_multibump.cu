// Two-pass fused kernels of the multi-test-function WAN weak form: one weak
// residual per localised bump phi_k = w_k * v, k < Kb.
//
// Replaces the Pallas kernels of nnpde_tpu/kernels/fused_multibump.py:
//   multi_sums_kernel   <- _multi_sums_kernel    per bump k: sum r_k,
//                          sum (e1_k v)^2, sum e2_k v, with
//                          r_k = c_k v + b_k . g + rhs_k; out (3 Kb):
//                          [sum r (Kb) | sum mass (Kb) | sum e2 (Kb)]
//   multi_seeded_kernel <- _multi_seeded_kernel  dW/db of sum_k (s_r_k sum
//                          r_k + s_q_k sum (e1_k v)^2 + s_l_k sum e2_k v)
//                          by ONE reverse sweep on the cotangent summed over
//                          the bumps, and sum ct_v
// Here v and g are the raw net's value (with the last bias) and gradient;
// the weak forms are first order, so no Laplacian stream is carried (d+1
// streams).  Coefficients per point, nc = Kb*(d+4) floats: Kb blocks
// [c_k, b_k0..b_k{d-1}, rhs_k], then e1_0..e1_{Kb-1}, then e2_0..e2_{Kb-1}
// (pack_multibump_coefficients).  The seeds [s_r (Kb) | s_q (Kb) | s_l (Kb)]
// are read from device memory, never passed by value, so no objective waits
// on the host.
//
// What bounds them on the H100: it depends on the net.  Per point pass A
// costs (d+1)*sum(n_in*n_out) multiply-adds plus ~Kb*(2d+5) for the bumps,
// pass B three times the former, against 4*(d + Kb*(d+4)) bytes read.  On a
// small critic with many bumps (2-20-20-20-1, Kb = 16: 392 B against ~5200
// FLOP) pass A is bound by bytes, the first such kernel of the family; on
// the solution net both are bound by operations.  What the design does
// about it: the tile's coefficient block is one contiguous run of device
// memory, fetched by 16-byte cp.async into shared memory at the start of
// the tile so that the copy overlaps the forward recompute and is read
// exactly once; the bumps' epilogue is spread over 3*Kb threads (pass A) or
// T*(d+1) threads (pass B); the rest is the shared per-tile core
// (fwdlap_core.cuh), with no saved stages in pass A.
//
// Determinism: the rule of fused_step.cu -- per-block partial rows, fixed
// in-block orders, one ordered reduction, no atomics.  The 3*Kb sums and
// sum ct_v are carried in double from the tile up (a quotient's seeds
// amplify their error).
//
// Interface: plain C (ctypes), float32 only, weights flattened as
// [W0, b0, W1, b1, ...].  Launches on the given stream, never synchronises,
// and returns cudaGetLastError().
#include "fwdlap_core.cuh"

using namespace fwdlap;

namespace {

constexpr int MAX_BUMPS = 42;   // the cap of the JAX package (3 Kb <= 128)

struct MArgs {
  Net net;
  const float* X;
  const float* coef;          // (N, Kb*(d+4)), 16-byte aligned
  const float* params;
  const float* scal;          // pass B seeds (3 Kb)
  float* partial;             // (G, row): sums (3 Kb), or [grads (P) | sum ct_v]
  float* scratch;             // (G, K-2, S, T, wmax), pass B only
  int N, T, n_tiles, row, Kb;
};

// cf[p][:] = coef[base + p][:] for the tile's T points; rows past N read 0.
// A full tile is one aligned run of T*nc floats (T % 4 == 0) and moves by
// 16-byte cp.async; the ragged last tile is copied element by element.
// Completes at copy_wait().
__device__ __forceinline__ void load_coef_tile(const float* __restrict__ coef, int N,
                                               int nc, int base, int T, float* cf) {
  const float* src = coef + (size_t)base * nc;
  if (base + T <= N) {
    copy_async(cf, src, T * nc);
    return;
  }
  const int n_valid = (N - base) * nc;
  for (int f = threadIdx.x; f < T * nc; f += NT) cf[f] = f < n_valid ? src[f] : 0.f;
}

template <bool SEEDED>
__device__ void multibump_body(const MArgs& A) {
  extern __shared__ __align__(16) float smem[];
  const Net& net = A.net;
  const int T = A.T, d = net.d, S = net.S, ld = net.wmax, Kb = A.Kb;
  const int blk = d + 2, nc = Kb * (d + 4);
  const int base_e1 = Kb * blk, base_e2 = base_e1 + Kb;
  float* bufA = smem;
  float* bufB = bufA + S * T * ld;
  float* bufC = SEEDED ? bufB + S * T * ld : nullptr;   // last stage's pre-acts
  float* Wsh = bufB + (SEEDED ? 2 : 1) * S * T * ld;
  float* cf = Wsh + ld * ld;              // coefficient tile, T x nc
  float* xs = cf + T * nc;
  float* ct = xs + T * d;                 // [ct_v | ct_g (d) | ct_l] x T
  float* proj = ct + (d + 2) * T;         // projected streams, S x T
  float* red = proj + S * T;              // reduction scratch, NT
  float* sc = red + NT;                   // the seeds, 3 Kb (pass B)
  float* grow = A.partial + (size_t)blockIdx.x * A.row;
  float* scratch =
      SEEDED ? A.scratch + (size_t)blockIdx.x * (net.K - 2) * S * T * ld : nullptr;

  for (int i = threadIdx.x; i < A.row; i += NT) grow[i] = 0.f;
  if (SEEDED)
    for (int i = threadIdx.x; i < 3 * Kb; i += NT) sc[i] = A.scal[i];
  __syncthreads();

  const float* wlast = A.params + net.off[net.K - 1];
  const float blast = wlast[net.w[net.K - 1]];

  double blk_sum = 0.0;
  for (int tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    load_coef_tile(A.coef, A.N, nc, base, T, cf);
    load_tile(A.X, A.N, d, base, T, xs);
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    // (the recompute's own copy_wait() also completes the coefficient copy)
    fwd_recompute(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch);
    project_last(net, T, cur, wlast, blast, proj);
    copy_wait();
    __syncthreads();
    if (SEEDED) {
      // per-point cotangents summed over the bumps, in bump order
      for (int it = threadIdx.x; it < T * (d + 1); it += NT) {
        const int comp = it / T, p = it - comp * T;
        const float* row = cf + p * nc;
        float acc = 0.f;
        if (comp == 0) {
          const float v = proj[p];
          for (int k = 0; k < Kb; ++k) {
            const float e1 = row[base_e1 + k];
            acc += sc[k] * row[k * blk] + sc[Kb + k] * 2.0f * e1 * e1 * v +
                   sc[2 * Kb + k] * row[base_e2 + k];
          }
          ct[(d + 1) * T + p] = 0.f;
        } else {
          for (int k = 0; k < Kb; ++k) acc += sc[k] * row[k * blk + comp];
        }
        ct[comp * T + p] = acc;
      }
      __syncthreads();
      if (threadIdx.x == 0)
        for (int p = 0; p < T; ++p) blk_sum += (double)ct[p];
      reverse_sweep(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch, ct, red, grow);
    } else {
      // one thread per sum, points in order, carried in double across the
      // block's tiles
      if (threadIdx.x < 3 * Kb) {
        const int lane = threadIdx.x / Kb, k = threadIdx.x - lane * Kb;
        for (int p = 0; p < T; ++p) {
          const float* row = cf + p * nc;
          const float v = proj[p];
          float term;
          if (lane == 0) {
            term = row[k * blk] * v + row[k * blk + d + 1];
            for (int i = 0; i < d; ++i) term += row[k * blk + 1 + i] * proj[(1 + i) * T + p];
          } else if (lane == 1) {
            const float m = row[base_e1 + k] * v;
            term = m * m;
          } else {
            term = row[base_e2 + k] * v;
          }
          blk_sum += (double)term;
        }
      }
      __syncthreads();
    }
  }
  if (SEEDED) {
    if (threadIdx.x == 0) grow[net.P] = (float)blk_sum;
  } else if (threadIdx.x < 3 * Kb) {
    grow[threadIdx.x] = (float)blk_sum;
  }
}

}  // namespace

__global__ void __launch_bounds__(NT) multi_sums_kernel(MArgs a) {
  multibump_body<false>(a);
}
__global__ void __launch_bounds__(NT) multi_seeded_kernel(MArgs a) {
  multibump_body<true>(a);
}

namespace {

typedef void (*MKernelFn)(MArgs);

MKernelFn mkernel_for(int seeded) { return seeded ? multi_seeded_kernel : multi_sums_kernel; }

}  // namespace

extern "C" {

// seeded: 0 pass A (sums), 1 pass B (seeded gradients).  coef (N,
// n_bumps*(d+4)), 16-byte aligned.  scal: device seeds (3 n_bumps; pass B,
// else may be null).  partial (G, row) and out (row) with row = 3 n_bumps
// or P+1; scratch (G, K-2, d+1, T, wmax) for pass B (else may be null).
int fused_multibump_f32(int seeded, int n_bumps, const float* X, const float* coef,
                        const float* params, const float* scal, const int* layers,
                        int n_layers, int act, int N, int T, int G, float* partial,
                        float* scratch, float* out, int smem_bytes, void* stream) {
  MArgs a;
  if (n_bumps < 1 || n_bumps > MAX_BUMPS || !make_net(0, layers, n_layers, act, &a.net) ||
      N < 1 || T < 4 || T % 4 != 0 || G < 1 || ((size_t)coef & 15) != 0)
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
  a.Kb = n_bumps;
  a.row = seeded ? a.net.P + 1 : 3 * n_bumps;
  MKernelFn fn = mkernel_for(seeded);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fn<<<G, NT, smem_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<(a.row + 255) / 256, 256, 0, s>>>(partial, G, a.row, out);
  return (int)cudaGetLastError();
}

// Resident blocks per SM for a pass at a dynamic shared-memory size.
int fused_multibump_blocks_per_sm(int seeded, int smem_bytes, int* blocks) {
  MKernelFn fn = mkernel_for(seeded);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT, smem_bytes);
}

}  // extern "C"
