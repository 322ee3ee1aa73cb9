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
// shared-memory product per layer over all d+2 streams, 4 x 4 register
// tiles, cp.async for weights and saved stages).
//
// The BF16 variant is the TPU kernel's dot_dtype='bfloat16' (the backward
// of the bulk of compute_dtype='hybrid-kernel' on the jet pair): every
// product operand of the recompute and of the reverse sweep rounded to
// bf16, fp32 accumulation on the same CUDA-core products (fwdlap_core.cuh,
// "BF16").  Same FLOP at the same rate plus the rounding: no faster than
// the fp32 variant; the bf16 tensor cores are a redesign of their own.
//
// Determinism: per-block partial rows, fixed in-block orders, one ordered
// reduction in double, no atomics -- two launches are bitwise equal.
//
// Interface: plain C (ctypes), float32 only, weights flattened as
// [W0, b0, W1, b1, ...].  Launches on the given stream, never synchronises,
// and returns cudaGetLastError().
#include "fwdlap_core.cuh"

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

}  // namespace

// (in variants: FOLD, the activation in the products' epilogues, for nets
// with at most 4 streams; BF16, the bf16-dot mode; the wrapper chooses)
template <bool FOLD, bool BF16>
__global__ void __launch_bounds__(NT) fwdlap_backward_kernel(BwdArgs A) {
  extern __shared__ __align__(16) float smem[];
  const Net& net = A.net;
  const int T = A.T, d = net.d, S = net.S, ld = net.wmax;
  float* bufA = smem;
  float* bufB = bufA + S * T * ld;
  float* bufC = bufB + S * T * ld;        // pre-activations of one stage
  float* Wsh = bufC + S * T * ld;
  float* xs = Wsh + ld * ld;
  float* ct = xs + T * d;                 // [ct_v | ct_g (d) | ct_l] x T
  float* red = ct + S * T;                // reduction scratch, NT
  float* grow = A.partial + (size_t)blockIdx.x * net.P;
  float* scratch = A.scratch + (size_t)blockIdx.x * (net.K - 2) * S * T * ld;

  for (int i = threadIdx.x; i < net.P; i += NT) grow[i] = 0.f;
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
    fwd_recompute<false, FOLD, BF16>(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch);
    reverse_sweep<false, FOLD, BF16>(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch, ct,
                                     red, grow);
  }
}

namespace {

typedef void (*BwdKernelFn)(BwdArgs);

BwdKernelFn bwd_kernel_for(int fold, int bf16) {
  if (bf16) return fold ? fwdlap_backward_kernel<true, true> : fwdlap_backward_kernel<false, true>;
  return fold ? fwdlap_backward_kernel<true, false> : fwdlap_backward_kernel<false, false>;
}

}  // namespace

extern "C" {

// X (N, d), ct (N, d+2), params flat; partial (G, P), scratch (G, K-2, d+2,
// T, wmax), out (P): [dW0, db0, ..., dW_last, 0] (the last bias's slot is
// left zero).  T points per tile, G blocks; fold: the variant with the
// activation in the products' epilogues (nets with at most 4 streams);
// bf16: the bf16-dot variant.
int fwdlap_backward_f32(const float* X, const float* ct, const float* params,
                        const int* layers, int n_layers, int act, int N, int T, int G,
                        int fold, int bf16, float* partial, float* scratch, float* out,
                        int smem_bytes, void* stream) {
  BwdArgs a;
  if (!make_net(1, layers, n_layers, act, &a.net) || N < 1 || T < 4 || T % 4 != 0 ||
      G < 1 || (fold && a.net.S > 4))
    return (int)cudaErrorInvalidValue;
  a.X = X;
  a.ct = ct;
  a.params = params;
  a.partial = partial;
  a.scratch = scratch;
  a.N = N;
  a.T = T;
  a.n_tiles = (N + T - 1) / T;
  BwdKernelFn fn = bwd_kernel_for(fold, bf16);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fn<<<G, NT, smem_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows(partial, G, a.net.P, out, s);
}

// Resident blocks per SM of a variant at a dynamic shared-memory size.
int fwdlap_backward_blocks_per_sm(int fold, int bf16, int smem_bytes, int* blocks) {
  BwdKernelFn fn = bwd_kernel_for(fold, bf16);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT, smem_bytes);
}

}  // extern "C"
