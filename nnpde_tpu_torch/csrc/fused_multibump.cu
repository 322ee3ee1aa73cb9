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
// What bounds them on the H100.  By the roofline it depends on the net: per
// point pass A costs (d+1)*sum(n_in*n_out) multiply-adds plus ~Kb*(2d+5) for
// the bumps, pass B three times the former, against 4*(d + Kb*(d+4)) bytes
// read; a small critic with many bumps (2-20-20-20-1, Kb = 16: 392 B against
// ~5200 FLOP) is bound by bytes in pass A, the solution net by operations.
// In practice both are bound by latency between barriers: a tile is a chain
// of ~15 (pass A) to ~40 (pass B) barrier-separated phases, each short, and
// an instrumented build's phase clocks on the card put the elementwise stages
// (sincos packs) and the products at about a third each, the per-tile
// traffic under a tenth.  So
// what the design buys first is resident blocks per SM (the plan keeps room
// for three), then fewer idle threads per phase:
//   * the plan (kernels/_plan.py, shared with the seeded quotient kernels)
//     picks the tile by net -- the
//     largest T (up to 48) whose widest product is still one wave of the
//     block's 4 x 4 register tiles -- and what stays in shared memory for
//     the block's life: hidden weights (pass B: their transposes too, staged
//     once by cp.async) and the block's gradient row, which every tile adds
//     to on chip and which is written to device memory once.  A shape that
//     does not fit steps down (smaller tile, then the row alone, then
//     nothing resident): a choice by shape, every shape still runs these
//     kernels.  Pass B's saved stages
//     go through a per-block slice of global scratch: holding them in shared
//     memory was measured slower at every shape of the infinite-well nets
//     (it costs tile size or a resident block), so no such path is kept;
//   * the tile's coefficient block is fetched by cp.async into rows of odd
//     stride at the start of the tile, overlapping the recompute, and read
//     exactly once without bank conflicts;
//   * pass A's epilogue runs on Kb * (NT / Kb) threads (thread (k, c): bump
//     k, every (NT/Kb)-th point), pass B's cotangents on T*(d+1) threads;
//     nobody waits for a single summing thread: each thread carries its own
//     double sums across the block's tiles and they are added once, in a
//     fixed order, when the block ends;
//   * on a narrow net the gradient products have few entries (25 tiles for
//     20 x 20), so their rows are dealt to groups of 8 lanes (NARROW).
// The products stay fp32 FFMA: 3xTF32 mma.sync products (m16n8k8, operands
// split at fragment load) were right to 6e-6 on the card but 16-26% slower
// at these tile sizes, and their registers cost a resident block.
//
// Widths.  Both passes take the nets beyond the other kernels' limits (hidden
// widths to MAX_WIDTH, MAX_LAYERS weight matrices, d to MAX_DIM: make_net's
// `beyond`, ROADMAP.md B7), as the fp32 quotients do: pass A as it is (the
// core's forward routines take any width, depth and d; its epilogue keeps
// no per-point arrays), pass B in its DES_BEYOND variants (reverse_sweep's
// BEYOND: the last layer's dW one thread per column above NT units), taken
// by exactly the nets of beyond_net, so every other net keeps its code.
// One wmax^2 staging matrix is 256 KB at width 256, more than a block
// gets: where no tier with the weights on chip fits even at 4 points, the
// plan takes the core's DEV_WEIGHTS tier (the kernels' _devw variants, no
// fold, two blocks per SM): the products read a padded copy of the hidden
// weights (pass B: and their transposes) in the resident layout from device
// memory, through the caches.  Above width 256 that is every net's tier,
// and pass B's gradient row (3.2 MB at (2, 512 x 4, 1)) fits no block, so
// each tile adds into the block's row in device memory.  The products stay
// fp32 FFMA and the sums stay double.
//
// Shared memory per block, floats (smem_floats): block-end sums 2-6 NT;
// 2 (pass A) or 3 (pass B) stream buffers of (d+1)*T*wmax; the resident
// weights sum wp[k]*wp[k+1] (twice in pass B), one wmax^2 staging matrix,
// or none (DEV_WEIGHTS); pass B's gradient row P+1; the coefficient tile T*(Kb*(d+4)|1);
// and ~(3d+6)*T + NT + 3 Kb of small vectors.  2-50-50-50-50-1 pass B at
// T = 24 staged: 69 KB, three blocks per SM; with weights, transposes and
// gradient row resident it would take 151 KB and one block.
//
// Determinism: the rule of fused_step.cu -- per-block partial rows, fixed
// in-block orders (shuffle trees, part-by-part sums), one ordered
// reduction, no atomics.  The 3*Kb sums and sum ct_v are carried in double
// from the tile up (a quotient's seeds amplify their error).
//
// Interface: plain C (ctypes), float32 only, weights flattened as
// [W0, b0, W1, b1, ...].  Launches on the given stream, never synchronises,
// and returns cudaGetLastError().
#include <mutex>

#include "fwdlap_planned.cuh"

using namespace fwdlap;

namespace {

constexpr int MAX_BUMPS = 42;   // the cap of the JAX package (3 Kb <= 128)

struct MArgs {
  Net net;
  const float* X;
  const float* coef;          // (N, Kb*(d+4))
  const float* params;
  const float* scal;          // pass B seeds (3 Kb)
  float* partial;             // (G, row): sums (3 Kb), or [grads (P) | sum ct_v]
  float* scratch;             // (G, K-2, S, T, wmax), pass B's saved stages
  const float* wd;            // DEV_WEIGHTS: the padded hidden weights (pass B:
                              // then their transposes), the resident layout
  int N, T, n_tiles, row, Kb, flags;
};

// Shared-memory floats of one block: the layout of multibump_body (mirrored
// by fused_multibump.py::smem_floats).
__host__ __device__ inline int smem_floats(const Net& net, int seeded, int T, int Kb,
                                           int flags) {
  const int d = net.d, S = net.S, ld = net.wmax, stage = S * T * ld;
  const int hid = hidden_floats(net), row = seeded ? net.P + 1 : 3 * Kb;
  int n = (seeded ? 2 : 6) * NT + (seeded ? 3 : 2) * stage;
  n += (flags & DEV_WEIGHTS) ? 0 : (flags & RES_WEIGHTS) ? hid : ld * ld;
  if (seeded && (flags & RES_WEIGHTS)) n += hid;
  if (seeded && (flags & RES_GRAD)) n += (row + 3) & ~3;
  n += T * coef_stride(Kb * (d + 4)) + T * d + (d + 2) * T + S * T + NT + 3 * Kb;
  return n;
}

// DEVW: the hidden weights read from A.wd (Flags::DEV_WEIGHTS).  BEYOND
// (pass B, the nets of beyond_net): the reverse sweep's variant for widths
// above NT.
template <bool SEEDED, bool FOLD, bool DEVW = false, bool BEYOND = false>
__device__ void multibump_body(const MArgs& A) {
  static_assert(SEEDED || !BEYOND, "pass A takes any net as it is");
  extern __shared__ __align__(16) float smem[];
  const Net& net = A.net;
  const int T = A.T, d = net.d, S = net.S, ld = net.wmax, Kb = A.Kb;
  const int blk = d + 2, nc = Kb * (d + 4), ncp = coef_stride(nc);
  const int base_e1 = Kb * blk, base_e2 = base_e1 + Kb;
  const int stage = S * T * ld, hid = hidden_floats(net);
  const bool res_w = (A.flags & RES_WEIGHTS) != 0;
  double* dsum = reinterpret_cast<double*>(smem);   // block-end sums
  float* bufA = smem + (SEEDED ? 2 : 6) * NT;
  float* bufB = bufA + stage;
  float* bufC = SEEDED ? bufB + stage : nullptr;    // last stage's pre-acts
  float* at = bufB + (SEEDED ? 2 : 1) * stage;
  Resident res;
  float* Wsh = at;                        // resident W_k, or one layer's
  at += DEVW ? 0 : res_w ? hid : ld * ld;
  float* Wt = nullptr;
  if (SEEDED && res_w) {
    Wt = at;
    at += hid;
  }
  float* gacc = nullptr;                  // the block's gradient row
  if (SEEDED && (A.flags & RES_GRAD)) {
    gacc = at;
    at += (A.row + 3) & ~3;
  }
  res.narrow = SEEDED && (A.flags & NARROW) != 0;
  float* cf = at;                         // coefficient tile, T x ncp
  float* xs = cf + T * ncp;
  float* ct = xs + T * d;                 // [ct_v | ct_g (d) | ct_l] x T
  float* proj = ct + (d + 2) * T;         // projected streams, S x T
  float* red = proj + S * T;              // reduction scratch, NT
  float* sc = red + NT;                   // the seeds, 3 Kb (pass B)
  float* grow_g = A.partial + (size_t)blockIdx.x * A.row;
  float* grow = gacc ? gacc : grow_g;     // where the tiles add their dW/db
  float* scratch =
      SEEDED ? A.scratch + (size_t)blockIdx.x * (net.K - 2) * stage : nullptr;

  if constexpr (DEVW) {
    res.W = A.wd;
    res.Wt = SEEDED ? A.wd + hid : nullptr;
  } else if (res_w) {
    stage_resident(net, A.params, Wsh, Wt);
    res.W = Wsh;
    res.Wt = Wt;
  }
  if (SEEDED) {
    for (int i = threadIdx.x; i < A.row; i += NT) grow[i] = 0.f;
    for (int i = threadIdx.x; i < 3 * Kb; i += NT) sc[i] = A.scal[i];
  }
  copy_wait();
  __syncthreads();

  const float* wlast = A.params + net.off[net.K - 1];
  const float blast = wlast[net.w[net.K - 1]];

  // pass A: thread (k, c) owns bump k on the points p = c, c + parts, ... of
  // every tile; pass B: thread p owns ct_v of point p of every tile.  Each
  // carries its sums in double across the block's tiles.
  const int parts = NT / Kb;
  const int my_k = threadIdx.x % Kb, my_c = threadIdx.x / Kb;
  double s0 = 0.0, s1 = 0.0, s2 = 0.0;
  for (int tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    load_coef_tile(A.coef, A.N, nc, ncp, base, T, cf);
    load_tile(A.X, A.N, d, base, T, xs);
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    fwd_recompute<true, FOLD>(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch, res);
    project_last(net, T, cur, wlast, blast, proj);
    copy_wait();                          // the coefficient tile has landed
    __syncthreads();
    if (SEEDED) {
      // per-point cotangents summed over the bumps, in bump order
      for (int it = threadIdx.x; it < T * (d + 1); it += NT) {
        const int comp = it / T, p = it - comp * T;
        const float* row = cf + p * ncp;
        float acc = 0.f;
        if (comp == 0) {
          const float v = proj[p];
          for (int k = 0; k < Kb; ++k) {
            const float e1 = row[base_e1 + k];
            acc += sc[k] * row[k * blk] + sc[Kb + k] * 2.0f * e1 * e1 * v +
                   sc[2 * Kb + k] * row[base_e2 + k];
          }
          ct[(d + 1) * T + p] = 0.f;
          s0 += (double)acc;              // it < T <= NT/2: thread p, point p
        } else {
          for (int k = 0; k < Kb; ++k) acc += sc[k] * row[k * blk + comp];
        }
        ct[comp * T + p] = acc;
      }
      __syncthreads();
      reverse_sweep<true, FOLD, BEYOND>(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch, ct,
                                        red, grow, res);
    } else {
      if (my_c < parts) {
        for (int p = my_c; p < T; p += parts) {
          const float* row = cf + p * ncp + my_k * blk;
          const float v = proj[p];
          float r = row[0] * v + row[d + 1];
          for (int i = 0; i < d; ++i) r += row[1 + i] * proj[(1 + i) * T + p];
          const float m = cf[p * ncp + base_e1 + my_k] * v;
          s0 += (double)r;
          s1 += (double)(m * m);
          s2 += (double)(cf[p * ncp + base_e2 + my_k] * v);
        }
      }
      __syncthreads();
    }
  }
  // block-end sums, parts added in a fixed order
  if (SEEDED) {
    dsum[threadIdx.x] = s0;
    __syncthreads();
    if (gacc)
      for (int i = threadIdx.x; i < net.P; i += NT) grow_g[i] = gacc[i];
    if (threadIdx.x == 0) {
      double s = 0.0;
      for (int p = 0; p < T; ++p) s += dsum[p];
      grow_g[net.P] = (float)s;
    }
  } else {
    if (my_c < parts) {
      dsum[my_k * parts + my_c] = s0;
      dsum[(Kb + my_k) * parts + my_c] = s1;
      dsum[(2 * Kb + my_k) * parts + my_c] = s2;
    }
    __syncthreads();
    if (threadIdx.x < 3 * Kb) {
      double s = 0.0;
      for (int c = 0; c < parts; ++c) s += dsum[threadIdx.x * parts + c];
      grow_g[threadIdx.x] = (float)s;
    }
  }
}

}  // namespace

// (each kernel in two variants: FOLD, the activation in the products'
// epilogues, for nets with at most 4 streams; the wrapper chooses)
template <bool FOLD>
__global__ void __launch_bounds__(NT) multi_sums_kernel(MArgs a) {
  multibump_body<false, FOLD>(a);
}
// (three blocks per SM: the plan counts on them, so the register budget is
// stated and not left to the compiler's choice)
template <bool FOLD>
__global__ void __launch_bounds__(NT, 3) multi_seeded_kernel(MArgs a) {
  multibump_body<true, FOLD>(a);
}
// The weights from device memory (DEV_WEIGHTS), without the fold, at two
// blocks per SM: the plan of a net whose weights do not fit shared memory
// beside a tile.
__global__ void __launch_bounds__(NT, 2) multi_sums_devw(MArgs a) {
  multibump_body<false, false, true>(a);
}
__global__ void __launch_bounds__(NT, 2) multi_seeded_devw(MArgs a) {
  multibump_body<true, false, true>(a);
}
// Pass B on the nets beyond the other kernels' limits (beyond_net: a hidden
// width above NT, d above CORE_DIM), without the fold (such nets never take
// it: more than 4 streams, or more items than threads at any tile): the
// reverse sweep's BEYOND variant at two blocks per SM, staged or with
// DEV_WEIGHTS.  Such a net's stages leave room for two blocks at most (d >
// 16: (d+1) streams; a width above NT: the weights from device memory), and
// at the three-block budget the staged variant spilled (80 registers).
__global__ void __launch_bounds__(NT, 2) multi_seeded_beyond(MArgs a) {
  multibump_body<true, false, false, true>(a);
}
__global__ void __launch_bounds__(NT, 2) multi_seeded_devw_beyond(MArgs a) {
  multibump_body<true, false, true, true>(a);
}

namespace {

typedef void (*MKernelFn)(MArgs);

// The kernel of a pass, variant and design: des DES_DEVW (with
// flags DEV_WEIGHTS) the weights from device memory, DES_BEYOND (pass B, no
// fold) the variant for the nets of beyond_net, alone or with DES_DEVW.
MKernelFn mkernel_for(int seeded, int fold, int flags, int des) {
  const bool devw = (flags & DEV_WEIGHTS) != 0;
  if (devw != ((des & DES_DEVW) != 0) || (des & ~(DES_DEVW | DES_BEYOND)) != 0) return nullptr;
  if (des & DES_BEYOND)
    return !seeded || fold ? nullptr : devw ? multi_seeded_devw_beyond : multi_seeded_beyond;
  if (devw) return fold ? nullptr : seeded ? multi_seeded_devw : multi_sums_devw;
  if (seeded) return fold ? multi_seeded_kernel<true> : multi_seeded_kernel<false>;
  return fold ? multi_sums_kernel<true> : multi_sums_kernel<false>;
}

}  // namespace

// (declared in fwdlap_core.cuh; every .cu file's kernels raise their limit
// through it)
cudaError_t ensure_smem(const void* kernel, int smem_bytes) {
  struct Raised { const void* kernel; int dev, bytes; };
  constexpr int MAX_ENTRIES = 256;        // (kernel, device) pairs tracked
  static std::mutex guard;
  static Raised raised[MAX_ENTRIES];
  static int n = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(guard);
  int i = 0;
  while (i < n && !(raised[i].kernel == kernel && raised[i].dev == dev)) ++i;
  if (i < n && smem_bytes <= raised[i].bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  if (i < n)
    raised[i].bytes = smem_bytes;
  else if (n < MAX_ENTRIES)
    raised[n++] = Raised{kernel, dev, smem_bytes};
  return cudaSuccess;
}

extern "C" {

// seeded: 0 pass A (sums), 1 pass B (seeded gradients).  coef (N,
// n_bumps*(d+4)).  scal: device seeds (3 n_bumps; pass B, else may be null).
// flags: the plan's Flags; fold: the variant with the activation in the
// products' epilogues.  partial (G, row) and out (row) with row = 3
// n_bumps or P+1; scratch (G, K-2, d+1, T, wmax) for pass B on a net with
// more than one hidden layer (else may be null).  smem_bytes must hold the
// layout of multibump_body for (T, flags).  wd: with DEV_WEIGHTS the hidden
// weights (pass B: then their transposes), each rounded up to multiples of
// 4 with zeros, back to back (the resident layout), else ignored.  des: the
// plan's design, DES_DEVW exactly with DEV_WEIGHTS, and for pass B
// DES_BEYOND added exactly for the nets of beyond_net.  Both passes take the
// nets beyond the other kernels' limits (make_net's `beyond`).
int fused_multibump_f32(int seeded, int n_bumps, const float* X, const float* coef,
                        const float* params, const float* scal, const int* layers,
                        int n_layers, int act, int N, int T, int G, int flags, int fold,
                        float* partial, float* scratch, float* out, int smem_bytes,
                        void* stream, const float* wd, int des) {
  MArgs a;
  MKernelFn fn = mkernel_for(seeded, fold, flags, des);
  if (fn == nullptr || n_bumps < 1 || n_bumps > MAX_BUMPS ||
      !make_net(0, layers, n_layers, act, &a.net, true) || N < 1 || T < 4 || T % 4 != 0 ||
      T > NT / 2 || G < 1 || flags < 0 || flags > 15 ||
      ((flags & DEV_WEIGHTS) && ((flags & RES_WEIGHTS) || (a.net.K > 2 && wd == nullptr))) ||
      (fold && a.net.S > 4) ||
      (seeded && a.net.K > 2 && scratch == nullptr) ||
      ((des & DES_BEYOND) != 0) != (seeded && beyond_net(a.net)) ||
      4 * smem_floats(a.net, seeded, T, n_bumps, flags) > smem_bytes)
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
  a.flags = flags;
  a.row = seeded ? a.net.P + 1 : 3 * n_bumps;
  a.wd = wd;
  cudaError_t err = ensure_smem((const void*)fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fn<<<G, NT, smem_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows(partial, G, a.row, out, s);
}

// Resident blocks per SM for a pass and variant (fold; flags: DEV_WEIGHTS
// or not; des: the plan's design, as fused_multibump_f32 takes it) at a
// dynamic shared-memory size.
int fused_multibump_blocks_per_sm(int seeded, int fold, int flags, int des, int smem_bytes,
                                  int* blocks) {
  MKernelFn fn = mkernel_for(seeded, fold, flags, des);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = ensure_smem((const void*)fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT, smem_bytes);
}

// The shared-memory bytes multibump_body lays out for (T, flags), or -1 for
// a net the kernels do not take.
int fused_multibump_smem_bytes(int seeded, int n_bumps, const int* layers, int n_layers,
                               int T, int flags) {
  Net net;
  if (!make_net(0, layers, n_layers, 0, &net, true)) return -1;
  return 4 * smem_floats(net, seeded, T, n_bumps, flags);
}

}  // extern "C"
