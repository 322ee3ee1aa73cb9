// Jet forward: (value, grad, Laplacian) of a raw MLP at every point.
//
// fwdlap_forward_planned (fp32) and fwdlap_forward_mma (its bf16-dot mode)
// replace nnpde_tpu/kernels/fwdlap_pallas.py::_forward_kernel2 (the
// VMEM-resident jet forward behind mlp_fwdlap_pallas, fwd_impl='pallas2'):
// the forward-Laplacian recurrence over a tile of points, kept on chip,
// with only the (N, d+2) jet written out.
//
// The same kernel with its stream-major write (STREAMS) replaces
// ::_forward_kernel (with ::_fwd_streams; fwd_impl='pallas'): the same jet
// written (d+2, N), each stream one contiguous run.  Both are exact fp32.
//
// What bounds it on the H100: operations.  Per point the recurrence costs
// (d+2)*sum(n_in*n_out) multiply-adds (2.50e4 at d = 2 on the
// 2-64-64-64-64-1 net) against 8 bytes in and 16 bytes out, so the fp32
// CUDA-core rate is the ceiling.  In practice a tile is a chain of short
// barrier-separated phases (input layer and stage 1's activation, one
// product per hidden layer with the next activation in its epilogue, the
// projection), so what the design buys first is resident blocks per SM.
// The fp32 row kernel, fwdlap_forward_planned, is the planned design of
// fwdlap_planned.cuh (fwd_recompute_p in its forward-only mode: no stage
// saved, so nothing but X, the weights and the jet touches device memory)
// on the launch plan of kernels/_plan.py::forward_only:
//   * its register budget is stated at the blocks per SM its plan counts on
//     (MINB = 3 or 2): left to the compiler the 4 x 4 kernel took 94
//     registers and two blocks per SM, at 80 it runs three;
//   * 4 x 4 items at the tile whose (point, 4 units) items are one wave, or
//     two-point items (8 rows x 4 units: a weight float4 feeds 32 FMAs) at
//     theirs where that tile fits as it is and its tiles fill 2.5 rounds of
//     the card's slots at this N;
//   * the hidden weights resident for the block's life where they fit the
//     plan's share, else staged per layer per tile by cp.async (W_1 while the
//     input layer runs).  A second staging buffer, each W_{k+1} copied while
//     product k ran, was built and measured no faster (PERF.md, section 6).
// The fp32 designs of both layouts take nets beyond the other kernels'
// limits (widths above NT with the weights from device memory, up to
// MAX_LAYERS weight matrices, d up to MAX_DIM: ROADMAP.md B7) with their
// routines as they are; the stream-major write is the same loop at any d.
// The bf16-dot mode takes their widths and depths too, and d to CORE_DIM
// (JAX's _forward_kernel2, whose mode it is, takes d <= 6).
// The two layouts differ only in the write: project_last leaves the jet
// stream-major in shared memory, proj[s * T + p], so the row layout writes
// each point's d+2 floats and the stream-major one each stream's run.
//
// The row kernel's bf16-dot mode, fwdlap_forward_mma: _forward_kernel2's
// fwd_dot='default' (fwd_impl='pallas2:default'), single-pass dots, which
// on the TPU round every dot operand to bf16 and accumulate in fp32; here
// the products run on the bf16 tensor cores in the design of
// fwdlap_mma.cuh (DES_MMA; body<KIND_FWD>: the fused kernels' forward half
// with nothing saved, the projection partials from the last stage's
// epilogue), the Jacobian seed rows and the projection on the last layer's
// row in fp32, and the products before the last on the CUDA cores in fp32
// (fwdlap_mma.cuh, f32_products: the tensor cores' sums cut toward zero,
// and their stages' bf16 roundings flipped); its register budget is stated
// at the blocks per SM its plan counts on (MINB = 3 or 2).  The stream-major layout has no such mode
// (_forward_kernel runs HIGHEST).
//
// Interface: plain C (ctypes), float32 only, weights flattened as
// [W0, b0, W1, b1, ...] with row-major (in, out) W.  Launches on the given
// stream, never synchronises, and returns cudaGetLastError().
#include "fwdlap_mma.cuh"

using namespace fwdlap;

namespace {

struct FwdArgs {
  Net net;
  const float* X;
  const float* params;
  float* out;                 // (N, S) rows [value, grad.., lap]; or (S, N)
  int N, T, n_tiles;
  int flags;                  // the plan's Flags
  const float* wd;            // DES_DEVW: the padded hidden weights (resident layout)
};

// Shared-memory floats of one block for (T, flags): the planned kernel's
// layout (both output layouts).  Mirrored by
// kernels/fwdlap_cuda.py::forward_smem_floats.
__host__ __device__ inline int fwd_smem_floats(const Net& net, int T, int flags) {
  const int ld = net.wmax;
  const int n = 2 * net.S * T * ld + ((flags & DEV_WEIGHTS)   ? 0
                                      : (flags & RES_WEIGHTS) ? hidden_floats(net)
                                                              : ld * ld);
  return n + T * net.d + net.S * T;
}

}  // namespace

// The planned design (fwdlap_planned.cuh: fwd_recompute_p in its
// forward-only mode) with the plan's residency from A.flags: the hidden
// weights staged once per block (RES_WEIGHTS), or per layer per tile.
// MINB: the blocks per SM its plan counts on, so the register budget is
// stated, not left to the compiler's choice.  STREAMS: the stream-major
// output (S, N) of row 6, else the rows (N, S) of row 4.
template <bool FOLD, int DES, int MINB, bool STREAMS>
__global__ void __launch_bounds__(NT, MINB) fwdlap_forward_planned(FwdArgs A) {
  extern __shared__ __align__(16) float smem[];
  const Net& net = A.net;
  const int T = A.T, d = net.d, S = net.S, ld = net.wmax;
  constexpr bool DEVW = (DES & DES_DEVW) != 0;   // the weights read from A.wd
  const bool res_w = (A.flags & RES_WEIGHTS) != 0;
  float* bufA = smem;
  float* bufB = bufA + S * T * ld;
  float* Wsh = bufB + S * T * ld;         // one layer's W, or the resident W
  float* xs = Wsh + (DEVW ? 0 : res_w ? hidden_floats(net) : ld * ld);
  float* proj = xs + T * d;               // projected streams, S x T
  const float* wlast = A.params + net.off[net.K - 1];
  const float blast = wlast[net.w[net.K - 1]];
  Resident res;
  if constexpr (DEVW) {
    res.W = A.wd;
  } else if (res_w) {
    stage_resident(net, A.params, Wsh, nullptr);
    res.W = Wsh;
    copy_wait();
    __syncthreads();
  }

  for (int tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    load_tile(A.X, A.N, d, base, T, xs);
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    fwd_recompute_p<FOLD, DES, false>(net, T, xs, A.params, cur, nxt, nullptr, Wsh, nullptr,
                                      res);
    project_last(net, T, cur, wlast, blast, proj);
    __syncthreads();
    if (STREAMS) {
      // out[s * N + base + p] = proj[s * T + p]: consecutive threads write
      // consecutive floats of one stream
      for (int i = threadIdx.x; i < S * T; i += NT) {
        const int s = i / T, p = i - s * T;
        if (base + p < A.N) A.out[(size_t)s * A.N + base + p] = proj[i];
      }
    } else {
      // out[(base + p) * S + s] = proj[s * T + p]: consecutive threads write
      // consecutive floats of the tile's rows
      for (int i = threadIdx.x; i < T * S; i += NT) {
        const int p = i / S, s = i - p * S;
        if (base + p < A.N) A.out[(size_t)(base + p) * S + s] = proj[s * T + p];
      }
    }
    __syncthreads();
  }
}

// The tensor-core design (fwdlap_mma.cuh, DES_MMA) of the bf16-dot mode:
// MINB, the blocks per SM its plan counts on (the register budget); WIDE,
// the variant for widths above 128 or the weights in device memory.
template <int MINB, bool WIDE>
__global__ void __launch_bounds__(NT, MINB) fwdlap_forward_mma(mma::JetArgs a) {
  mma::body<mma::KIND_FWD, WIDE>(
      a, [](int, const float*, const float*, float*, float*, float*) {});
}

namespace {

typedef void (*FwdKernelFn)(FwdArgs);

template <bool FOLD, int DES, bool STREAMS>
FwdKernelFn planned_budget(int minb) {
  switch (minb) {
    case 2: return fwdlap_forward_planned<FOLD, DES, 2, STREAMS>;
    case 3: return fwdlap_forward_planned<FOLD, DES, 3, STREAMS>;
    default: return nullptr;
  }
}

template <bool STREAMS>
const void* planned_fn(int fold, int des, int minb) {
  switch (des) {
    case DES_PLANNED:
      return fold ? (const void*)planned_budget<true, DES_PLANNED, STREAMS>(minb)
                  : (const void*)planned_budget<false, DES_PLANNED, STREAMS>(minb);
    case DES_PLANNED | DES_ITEM2:
      return fold ? (const void*)planned_budget<true, DES_PLANNED | DES_ITEM2, STREAMS>(minb)
                  : (const void*)planned_budget<false, DES_PLANNED | DES_ITEM2, STREAMS>(minb);
    case DES_PLANNED | DES_DEVW:   // no fold, the two-block budget
      return fold || minb != 2
                 ? nullptr
                 : (const void*)fwdlap_forward_planned<false, DES_PLANNED | DES_DEVW, 2, STREAMS>;
    default: return nullptr;
  }
}

// The kernel of a variant: the row kernel's bf16-dot mode the tensor-core
// design (des DES_MMA, with DES_WIDE its wide variant; no fold) and only
// it; fp32, in either layout, a planned design (fwdlap_planned.cuh's
// Design); both at the register budget
// of minb blocks per SM (2 or 3).  The stream-major layout has no bf16-dot
// mode.
const void* fwd_variant_fn(int streams, int fold, int bf16, int des, int minb) {
  if (bf16) {
    if (streams || (des & ~mma::DES_WIDE) != DES_MMA || fold) return nullptr;
    if (des & mma::DES_WIDE)
      return minb == 2 ? (const void*)fwdlap_forward_mma<2, true>
                       : minb == 3 ? (const void*)fwdlap_forward_mma<3, true> : nullptr;
    return minb == 2 ? (const void*)fwdlap_forward_mma<2, false>
                     : minb == 3 ? (const void*)fwdlap_forward_mma<3, false> : nullptr;
  }
  return streams ? planned_fn<true>(fold, des, minb) : planned_fn<false>(fold, des, minb);
}

// The net and tile geometry of a tensor-core query (fwdlap_forward_mma_*):
// widths and depth beyond the other kernels' limits, d to CORE_DIM (the JAX
// kernel of this mode, _forward_kernel2, takes d <= 6).
bool mma_fwd_net(const int* layers, int n_layers, int T, Net* net, mma::Geo* g) {
  return make_net(1, layers, n_layers, 0, net, true) && net->d <= CORE_DIM &&
         mma::make_geo(*net, T, g);
}

}  // namespace

extern "C" {

// X (N, d), params flat; out (N, d+2), or (d+2, N) with streams != 0.  T
// points per tile, G blocks; fold: the variant with the activation in the
// products' epilogues (nets with at most 4 streams); bf16: the row
// kernel's bf16-dot mode, which runs the tensor-core design (des DES_MMA,
// with DES_WIDE where mma::needs_wide) and only it; des: the design (a
// planned design in fp32, in either layout, or the tensor-core one); flags:
// the plan's Flags (RES_WEIGHTS, DEV_WEIGHTS with DES_DEVW or with the
// tensor-core design's DES_WIDE, or 0); minb: the register budget in blocks per
// SM, its plan's.  smem_bytes must hold the kernel's layout for (T, flags).
// wd: with DES_DEVW the hidden weights, each rounded up to multiples of 4
// with zeros, back to back (the resident layout), else ignored.
int fwdlap_forward_f32(int streams, const float* X, const float* params,
                       const int* layers, int n_layers, int act, int N, int T, int G,
                       int fold, int bf16, int des, int minb, int flags, float* out,
                       int smem_bytes, void* stream, const float* wd) {
  FwdArgs a;
  const void* fn = fwd_variant_fn(streams, fold, bf16, des, minb);
  const bool devw = (des & DES_DEVW) != 0;
  // both modes take the nets beyond the other kernels' limits (the
  // routines of either design take any width, depth and d as they are); the
  // bf16-dot mode keeps d <= CORE_DIM (mma_fwd_net)
  bool ok = fn != nullptr && make_net(1, layers, n_layers, act, &a.net, true) &&
            (!bf16 || a.net.d <= CORE_DIM) && N >= 1 && G >= 1;
  if (ok && bf16) {      // (fwd_variant_fn took des: DES_MMA, maybe DES_WIDE)
    mma::Geo g;
    ok = mma::flags_ok(flags, mma::KIND_FWD) && mma::make_geo(a.net, T, &g) &&
         mma::layout(a.net, g, flags, mma::KIND_FWD).total <= smem_bytes &&
         (!mma::needs_wide(a.net, flags) || (des & mma::DES_WIDE));
  } else if (ok) {
    ok = (flags == 0 || flags == (devw ? DEV_WEIGHTS : RES_WEIGHTS)) &&
         devw == ((flags & DEV_WEIGHTS) != 0) && !(devw && a.net.K > 2 && wd == nullptr) &&
         T >= 4 && T % 4 == 0 && T <= NT / 2 && !(fold && a.net.S > 4) &&
         4 * fwd_smem_floats(a.net, T, flags) <= smem_bytes;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  a.X = X;
  a.params = params;
  a.out = out;
  a.N = N;
  a.T = T;
  a.n_tiles = (N + T - 1) / T;
  a.flags = flags;
  a.wd = wd;
  cudaError_t err = ensure_smem(fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    mma::JetArgs m;
    m.net = a.net;
    m.X = X;
    m.ct = nullptr;
    m.params = params;
    m.partial = nullptr;
    m.scratch = nullptr;
    m.out = out;
    m.N = N;
    m.T = T;
    m.n_tiles = a.n_tiles;
    m.row = 0;
    m.flags = flags;
    ((void (*)(mma::JetArgs))fn)<<<G, NT, smem_bytes, s>>>(m);
  } else {
    ((FwdKernelFn)fn)<<<G, NT, smem_bytes, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of a variant at a dynamic shared-memory size.
int fwdlap_forward_blocks_per_sm(int streams, int fold, int bf16, int des, int minb,
                                 int smem_bytes, int* blocks) {
  const void* fn = fwd_variant_fn(streams, fold, bf16, des, minb);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = ensure_smem(fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT, smem_bytes);
}

// The shared-memory bytes the planned kernels (either layout) lay out for
// (T, flags), or -1 for a net they do not take.
int fwdlap_forward_smem_bytes(const int* layers, int n_layers, int T, int flags) {
  Net net;
  if (!make_net(1, layers, n_layers, 0, &net, true)) return -1;
  return 4 * fwd_smem_floats(net, T, flags);
}

// The tensor-core design's shared-memory bytes for (T, flags) and its
// saved-stage floats per block (none: it saves nothing), or -1 for a net or
// tile it does not take.
int fwdlap_forward_mma_smem_bytes(const int* layers, int n_layers, int T, int flags) {
  Net net;
  mma::Geo g;
  if (!mma_fwd_net(layers, n_layers, T, &net, &g)) return -1;
  return mma::layout(net, g, flags, mma::KIND_FWD).total;
}

int fwdlap_forward_mma_scratch_floats(const int* layers, int n_layers, int T) {
  Net net;
  mma::Geo g;
  if (!mma_fwd_net(layers, n_layers, T, &net, &g)) return -1;
  return (int)mma::scratch_floats(net, g, mma::KIND_FWD);
}

}  // extern "C"
