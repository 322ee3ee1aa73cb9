// Jet forward: (value, grad, Laplacian) of a raw MLP at every point.
//
// fwdlap_forward_kernel replaces
// nnpde_tpu/kernels/fwdlap_pallas.py::_forward_kernel2 (the VMEM-resident
// jet forward behind mlp_fwdlap_pallas, fwd_impl='pallas2'): the
// forward-Laplacian recurrence over a tile of points, kept on chip, with
// only the (N, d+2) jet written out.
//
// fwdlap_forward_streams_kernel replaces ::_forward_kernel (with
// ::_fwd_streams; fwd_impl='pallas'): the same jet written stream-major,
// (d+2, N) with each stream one contiguous run, and the output layer taken
// through the same shared-memory product as the hidden layers (the (w, 1)
// output weights staged as a (w, 4) matrix whose other columns are zero)
// where the row kernel reduces each row over a warp.  Both are exact fp32.
//
// What bounds it on the H100: operations.  Per point the recurrence costs
// (d+2)*sum(n_in*n_out) multiply-adds (2.50e4 at d = 2 on the
// 2-64-64-64-64-1 net) against 8 bytes in and 16 bytes out, so the fp32
// CUDA-core rate is the ceiling.  What the design does about it: the
// per-tile core of the fused kernels (fwdlap_core.cuh: every layer one
// shared-memory product over all d+2 streams, 4 x 4 register tiles,
// weights staged by cp.async), with no saved stages (there is no reverse
// sweep), so nothing but X and the jet touches device memory.
//
// The row kernel also comes in a BF16 variant: _forward_kernel2's
// fwd_dot='default' (fwd_impl='pallas2:default'), single-pass dots, which
// on the TPU round every dot operand to bf16 and accumulate in fp32; here
// every product operand is rounded to bf16 and the CUDA-core products
// accumulate in fp32 (fwdlap_core.cuh, "BF16"); the Jacobian seed rows and
// the projection on the last layer's row stay fp32.  Same FLOP at the same
// CUDA-core rate plus the rounding, so no faster than the fp32 variant:
// the bf16 tensor cores are a redesign of their own.  The stream-major
// kernel has no such mode (_forward_kernel runs HIGHEST).
//
// Interface: plain C (ctypes), float32 only, weights flattened as
// [W0, b0, W1, b1, ...] with row-major (in, out) W.  Launches on the given
// stream, never synchronises, and returns cudaGetLastError().
#include "fwdlap_core.cuh"

using namespace fwdlap;

namespace {

struct FwdArgs {
  Net net;
  const float* X;
  const float* params;
  float* out;                 // (N, S) rows [value, grad.., lap]; or (S, N)
  int N, T, n_tiles;
};

}  // namespace

// (each kernel in two variants: FOLD, the activation in the products'
// epilogues, for nets with at most 4 streams; the row kernel also in BF16
// variants, the bf16-dot mode; the wrapper chooses)
template <bool FOLD, bool BF16>
__global__ void __launch_bounds__(NT) fwdlap_forward_kernel(FwdArgs A) {
  extern __shared__ __align__(16) float smem[];
  const Net& net = A.net;
  const int T = A.T, d = net.d, S = net.S, ld = net.wmax;
  float* bufA = smem;
  float* bufB = bufA + S * T * ld;
  float* Wsh = bufB + S * T * ld;
  float* xs = Wsh + ld * ld;
  float* proj = xs + T * d;               // projected streams, S x T
  const float* wlast = A.params + net.off[net.K - 1];
  const float blast = wlast[net.w[net.K - 1]];

  for (int tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    load_tile(A.X, A.N, d, base, T, xs);
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    fwd_recompute<false, FOLD, BF16>(net, T, xs, A.params, cur, nxt, nullptr, Wsh, nullptr);
    project_last(net, T, cur, wlast, blast, proj);
    __syncthreads();
    // out[(base + p) * S + s] = proj[s * T + p]: consecutive threads write
    // consecutive floats of the tile's rows
    for (int i = threadIdx.x; i < T * S; i += NT) {
      const int p = i / S, s = i - p * S;
      if (base + p < A.N) A.out[(size_t)(base + p) * S + s] = proj[s * T + p];
    }
    __syncthreads();
  }
}

template <bool FOLD>
__global__ void __launch_bounds__(NT) fwdlap_forward_streams_kernel(FwdArgs A) {
  extern __shared__ __align__(16) float smem[];
  const Net& net = A.net;
  const int T = A.T, d = net.d, S = net.S, ld = net.wmax;
  float* bufA = smem;
  float* bufB = bufA + S * T * ld;
  float* Wsh = bufB + S * T * ld;
  float* xs = Wsh + ld * ld;
  const int wl = net.w[net.K - 1], wlp = net.wp[net.K - 1];
  const float* wlast = A.params + net.off[net.K - 1];

  for (int tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    load_tile(A.X, A.N, d, base, T, xs);
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    fwd_recompute<false, FOLD>(net, T, xs, A.params, cur, nxt, nullptr, Wsh, nullptr);
    // output layer: column 0 of a (wlp, 4) product, bias on the value rows
    for (int f = threadIdx.x; f < wlp * 4; f += NT)
      Wsh[f] = ((f & 3) == 0 && (f >> 2) < wl) ? wlast[f >> 2] : 0.f;
    __syncthreads();
    mm_rows(cur, ld, S * T, wlp, Wsh, 4, nxt, 4, wlast + wl, T, 1);
    __syncthreads();
    // out[s * N + base + p] = stream s of point p: consecutive threads write
    // consecutive floats of one stream
    for (int i = threadIdx.x; i < S * T; i += NT) {
      const int s = i / T, p = i - s * T;
      if (base + p < A.N) A.out[(size_t)s * A.N + base + p] = nxt[i * 4];
    }
    __syncthreads();
  }
}

namespace {

typedef void (*FwdKernelFn)(FwdArgs);

FwdKernelFn fwd_kernel_for(int streams, int fold, int bf16) {
  if (streams) {
    if (bf16) return nullptr;
    return fold ? fwdlap_forward_streams_kernel<true> : fwdlap_forward_streams_kernel<false>;
  }
  if (bf16) return fold ? fwdlap_forward_kernel<true, true> : fwdlap_forward_kernel<false, true>;
  return fold ? fwdlap_forward_kernel<true, false> : fwdlap_forward_kernel<false, false>;
}

}  // namespace

extern "C" {

// X (N, d), params flat; out (N, d+2), or (d+2, N) with streams != 0.  T
// points per tile, G blocks; fold: the variant with the activation in the
// products' epilogues (nets with at most 4 streams); bf16: the bf16-dot
// variant of the row kernel.
int fwdlap_forward_f32(int streams, const float* X, const float* params,
                       const int* layers, int n_layers, int act, int N, int T, int G,
                       int fold, int bf16, float* out, int smem_bytes, void* stream) {
  FwdArgs a;
  if (!make_net(1, layers, n_layers, act, &a.net) || N < 1 || T < 4 || T % 4 != 0 ||
      G < 1 || (fold && a.net.S > 4))
    return (int)cudaErrorInvalidValue;
  a.X = X;
  a.params = params;
  a.out = out;
  a.N = N;
  a.T = T;
  a.n_tiles = (N + T - 1) / T;
  FwdKernelFn fn = fwd_kernel_for(streams, fold, bf16);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  fn<<<G, NT, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of a variant at a dynamic shared-memory size.
int fwdlap_forward_blocks_per_sm(int streams, int fold, int bf16, int smem_bytes,
                                 int* blocks) {
  FwdKernelFn fn = fwd_kernel_for(streams, fold, bf16);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT, smem_bytes);
}

}  // extern "C"
