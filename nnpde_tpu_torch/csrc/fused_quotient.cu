// Two-pass fused kernels of the quotient losses (WAN weak form, Rayleigh,
// quadratic means): pass A sums, pass B seeded gradients.
//
// Replaces the Pallas kernels of nnpde_tpu/kernels/fused_quotient.py:
//   linear_sums_planned  <- _linear_sums_kernel   sum r, sum r^2,
//                           sum (e1 v)^2, sum e2 v; coef [c, b.., a, rhs,
//                           e1, e2] (N, d+5), r = c v + b.g + a lap + rhs
//   linear_seeded_kernel <- _linear_seeded_kernel dW/db of s_r sum r +
//                           s_q sum (e1 v)^2 + s_l sum e2 v, and sum ct_v
//   quad_sums_planned    <- _quad_sums_kernel     sum e, sum u^2 with u =
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
// 4*(d+1+nc) bytes per point.  In practice they are bound, like every
// kernel on the shared core, by instruction issue and by latency between
// the ~40 barrier-separated phases of a pass-B tile, so what the design buys
// first is resident blocks per SM.  What it does about it: the shared
// per-tile core (fwdlap_core.cuh), the Laplacian stream dropped where the
// loss never reads it (the WAN weak forms, every quadratic energy), pass A
// saves no stages, so the scratch traffic of the reverse sweep is paid by
// pass B alone, and:
//   * pass B (the seeded kinds) launches on the shared plan of
//     kernels/_plan.py, by net: room for three blocks per SM first, then
//     the largest one-wave tile, and what stays in shared memory for the
//     block's life -- hidden weights and their transposes with the gradient
//     row; the gradient row alone, which every tile adds to on chip instead
//     of a read-modify-write of P floats of device memory per tile and which
//     goes out once per block; or nothing -- where it fits within one tile
//     step.  Shared memory per block (smem_floats): 2-64-64-1, the Poisson
//     WAN critic, runs with the gradient row at T = 16 (73 KB; weights as
//     well would take 89 KB, the row at T = 20 82 KB); 2-64-64-64-64-1,
//     whose row alone is 51 KB, and 2-50-50-50-50-1 (the infinite-well DRM)
//     run staged at T = 20 and 24 (65 and 58 KB).  The register budget is
//     stated, __launch_bounds__(NT, 3): the plan counts on three blocks
//     (80 registers; the FOLD variants spill 128-204 bytes under it and are
//     still the faster ones, PERF.md);
//   * the tile's coefficients are fetched by cp.async into rows of odd
//     stride when the tile starts, overlapping the recompute, and read once
//     without bank conflicts;
//   * the per-point epilogue runs on T*S threads (pass B: one cotangent
//     each), and every sum is carried per point in double, in shared
//     memory, across the block's tiles and added once, in a fixed order,
//     when the block ends: no thread waits for a single summing thread.
// The sums kinds (pass A) run the forward of the planned design
// (fwdlap_planned.cuh: fwd_recompute_p in its forward-only mode) on the
// launch plan of kernels/_plan.py::forward_only, the plan of the jet forward
// (fwdlap_forward.cu): 4 x 4 or two-point items, the hidden weights (not
// their transposes) resident where they fit the plan's share, and the
// register budget stated at the blocks per SM the plan counts on (the
// *_sums_planned kernels, MINB = 3 or 2).  They share the epilogue.
// Both passes take the nets beyond the other kernels' limits (hidden widths
// to MAX_WIDTH, MAX_LAYERS weight matrices, d to MAX_DIM; ROADMAP.md B7):
// pass A as it is (the jet forward's routines, an epilogue with no
// per-point arrays), pass B in its DES_BEYOND variants (reverse_sweep's
// BEYOND: the last layer's dW one thread per column above NT units), taken
// by exactly the nets of beyond_net; above width 256 no layer's weights fit
// beside a tile, so both read them from device memory (DES_DEVW).

// Determinism: the rule of fused_step.cu -- per-block partial rows, fixed
// in-block orders, one ordered reduction, no atomics.  The sums are carried
// in double from the tile up (a quotient's seeds amplify their error).

// Interface: plain C (ctypes), float32 only, weights flattened as
// [W0, b0, W1, b1, ...].  Every entry point launches on the given stream,
// never synchronises, and returns cudaGetLastError().
#include "fwdlap_planned.cuh"

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
  int N, T, n_tiles, row, flags;
  const float* wd;            // DES_DEVW: the padded hidden weights (pass B: then
                              // their transposes) in the resident layout
};

__host__ __device__ inline bool is_seeded(int kind) {
  return kind == LIN_SEEDED || kind == QUAD_SEEDED;
}
__host__ __device__ inline bool is_linear(int kind) {
  return kind == LIN_SUMS || kind == LIN_SEEDED;
}

__host__ __device__ inline int n_sums(int kind) {
  return is_seeded(kind) ? 1 : (is_linear(kind) ? 4 : 2);
}

// Shared-memory floats of one block: the layout of quotient_body (mirrored
// by fused_quotient.py::smem_floats).
__host__ __device__ inline int smem_floats(const Net& net, int kind, int T, int flags) {
  const bool seeded = is_seeded(kind);
  const int d = net.d, S = net.S, ld = net.wmax, stage = S * T * ld;
  const int hid = hidden_floats(net);
  int n = 2 * n_sums(kind) * T + (seeded ? 3 : 2) * stage;
  n += (flags & DEV_WEIGHTS) ? 0 : (flags & RES_WEIGHTS) ? hid : ld * ld;
  if (seeded && (flags & RES_WEIGHTS)) n += hid;
  if (seeded && (flags & RES_GRAD)) n += (net.P + 1 + 3) & ~3;
  const int nc = d + (is_linear(kind) ? 5 : 3);
  return n + T * coef_stride(nc) + T * d + (seeded ? (d + 2) * T : 0) + S * T + NT + 4;
}

// DES: 0 for the seeded kinds, which run the core's routines
// (fwdlap_core.cuh) on the shared plan, or the sums kinds' planned design;
// with DES_DEVW the hidden weights are read from A.wd (Flags::DEV_WEIGHTS);
// with DES_BEYOND (seeded kinds, the nets of beyond_net) the reverse sweep's
// variant for widths above NT.
template <int KIND, bool FOLD, int DES = 0>
__device__ void quotient_body(const QArgs& A) {
  constexpr bool SEEDED = KIND == LIN_SEEDED || KIND == QUAD_SEEDED;
  static_assert(SEEDED == ((DES & DES_PLANNED) == 0),
                "pass B: the core's routines; pass A: a planned design");
  static_assert(SEEDED || (DES & DES_BEYOND) == 0, "pass A takes any net as it is");
  constexpr bool DEVW = (DES & DES_DEVW) != 0;
  constexpr bool LINEAR = KIND == LIN_SUMS || KIND == LIN_SEEDED;
  constexpr int NSUMS = SEEDED ? 1 : (LINEAR ? 4 : 2);
  extern __shared__ __align__(16) float smem[];
  const Net& net = A.net;
  const int T = A.T, d = net.d, S = net.S, ld = net.wmax;
  const int nc = LINEAR ? d + 5 : d + 3, ncp = coef_stride(nc);
  const int stage = S * T * ld, hid = hidden_floats(net);
  const bool res_w = (A.flags & RES_WEIGHTS) != 0;
  // the per-point sums, NSUMS x T doubles: thread p adds point p of every
  // tile (kept in shared memory, not in registers held across the tile)
  double* psum = reinterpret_cast<double*>(smem);
  float* bufA = smem + 2 * NSUMS * T;
  float* bufB = bufA + stage;
  float* bufC = SEEDED ? bufB + stage : nullptr;      // last stage's pre-acts
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
  float* ct = xs + T * d;                 // pass B: [ct_v | ct_g (d) | ct_l] x T
  float* proj = ct + (SEEDED ? (d + 2) * T : 0);   // projected streams, S x T
  float* red = proj + S * T;              // reduction scratch, NT
  float* sc = red + NT;                   // pass B seeds
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
  for (int i = threadIdx.x; i < NSUMS * T; i += NT) psum[i] = 0.0;
  if (SEEDED) {
    for (int i = threadIdx.x; i < A.row; i += NT) grow[i] = 0.f;
    if (threadIdx.x < (LINEAR ? 3 : 2)) sc[threadIdx.x] = A.scal[threadIdx.x];
  }
  copy_wait();
  __syncthreads();

  const float* wlast = A.params + net.off[net.K - 1];
  const float blast = wlast[net.w[net.K - 1]];

  for (int tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    load_coef_tile(A.coef, A.N, nc, ncp, base, T, cf);
    load_tile(A.X, A.N, d, base, T, xs);
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    if constexpr (SEEDED)
      fwd_recompute<SEEDED, FOLD>(net, T, xs, A.params, cur, nxt, bufC, Wsh, scratch, res);
    else
      fwd_recompute_p<FOLD, DES, false>(net, T, xs, A.params, cur, nxt, nullptr, Wsh, nullptr,
                                        res);
    project_last(net, T, cur, wlast, blast, proj);
    copy_wait();                          // the coefficient tile has landed
    __syncthreads();
    // padded rows read zero coefficients, so every term and cotangent
    // vanishes there
    if constexpr (SEEDED) {
      // the per-point cotangents of the projected (value, grad, lap),
      // component comp = it / T of point p on thread it
      for (int it = threadIdx.x; it < T * S; it += NT) {
        const int comp = it / T, p = it - comp * T;
        const float* row = cf + p * ncp;
        const float v = proj[p];
        float out;
        if constexpr (LINEAR) {
          if (comp == 0) {
            const float e1 = row[d + 3];
            out = sc[0] * row[0] + sc[1] * 2.0f * e1 * e1 * v + sc[2] * row[d + 4];
          } else {                        // b_i, or a for the Laplacian
            out = sc[0] * row[comp];
          }
        } else {
          const float B = row[0];
          if (comp == 0) {
            const float u = B * v;
            out = -row[d + 1] * B + 2.0f * row[d + 2] * u * B;
            for (int i = 0; i < d; ++i) {
              const float dB = row[1 + i];
              out += (B * proj[(1 + i) * T + p] + dB * v) * dB;
            }
            out = sc[0] * out + sc[1] * 2.0f * B * B * v;
          } else {
            out = sc[0] * (B * proj[comp * T + p] + row[comp] * v) * B;
          }
        }
        ct[it] = out;
        if (comp == 0) psum[p] += (double)out;
      }
      __syncthreads();
      reverse_sweep<true, FOLD, (DES & DES_BEYOND) != 0>(net, T, xs, A.params, cur, nxt, bufC,
                                                         Wsh, scratch, ct, red, grow, res);
    } else {
      for (int p = threadIdx.x; p < T; p += NT) {
        const float* row = cf + p * ncp;
        const float v = proj[p];
        if constexpr (LINEAR) {
          float r = row[0] * v + row[d + 2];
          if (net.lap) r += row[d + 1] * proj[(d + 1) * T + p];
          for (int i = 0; i < d; ++i) r += row[1 + i] * proj[(1 + i) * T + p];
          const float m = row[d + 3] * v;
          psum[p] += (double)r;
          psum[T + p] += (double)(r * r);
          psum[2 * T + p] += (double)(m * m);
          psum[3 * T + p] += (double)(row[d + 4] * v);
        } else {
          const float B = row[0];
          const float u = B * v;
          float e = -row[d + 1] * u + row[d + 2] * u * u;
          for (int i = 0; i < d; ++i) {
            const float G = B * proj[(1 + i) * T + p] + row[1 + i] * v;
            e += 0.5f * G * G;
          }
          psum[p] += (double)e;
          psum[T + p] += (double)(u * u);
        }
      }
      __syncthreads();
    }
  }
  // block-end sums over the points, in point order (the last tile ended in
  // a barrier)
  if (gacc)
    for (int i = threadIdx.x; i < net.P; i += NT) grow_g[i] = gacc[i];
  if (threadIdx.x < NSUMS) {
    double s = 0.0;
    for (int p = 0; p < T; ++p) s += psum[threadIdx.x * T + p];
    grow_g[(SEEDED ? net.P : 0) + threadIdx.x] = (float)s;
  }
}

}  // namespace

// (each kernel in two variants: FOLD, the activation in the products'
// epilogues, for nets with at most 4 streams; the wrapper chooses)
// (three blocks per SM: the plan counts on them, so the register budget is
// stated and not left to the compiler's choice)
template <bool FOLD>
__global__ void __launch_bounds__(NT, 3) linear_seeded_kernel(QArgs a) {
  quotient_body<LIN_SEEDED, FOLD>(a);
}
template <bool FOLD>
__global__ void __launch_bounds__(NT, 3) quad_seeded_kernel(QArgs a) {
  quotient_body<QUAD_SEEDED, FOLD>(a);
}
// Pass A in a planned design (fwdlap_planned.cuh: fwd_recompute_p in its
// forward-only mode), at the register budget of MINB blocks per SM.
template <bool FOLD, int DES, int MINB>
__global__ void __launch_bounds__(NT, MINB) linear_sums_planned(QArgs a) {
  quotient_body<LIN_SUMS, FOLD, DES>(a);
}
template <bool FOLD, int DES, int MINB>
__global__ void __launch_bounds__(NT, MINB) quad_sums_planned(QArgs a) {
  quotient_body<QUAD_SUMS, FOLD, DES>(a);
}
// Pass B with the weights read from device memory (DES_DEVW), without the
// fold, at two blocks per SM: the plan of a net whose weights do not fit
// shared memory beside a tile.
__global__ void __launch_bounds__(NT, 2) linear_seeded_devw(QArgs a) {
  quotient_body<LIN_SEEDED, false, DES_DEVW>(a);
}
__global__ void __launch_bounds__(NT, 2) quad_seeded_devw(QArgs a) {
  quotient_body<QUAD_SEEDED, false, DES_DEVW>(a);
}
// Pass B on the nets beyond the other kernels' limits (beyond_net: a hidden
// width above NT, d above CORE_DIM), without the fold (such nets never take
// it): the reverse sweep's BEYOND variant, at the budgets of the kernels
// above (DES_BEYOND alone three blocks per SM, with DES_DEVW two).
__global__ void __launch_bounds__(NT, 3) linear_seeded_beyond(QArgs a) {
  quotient_body<LIN_SEEDED, false, DES_BEYOND>(a);
}
__global__ void __launch_bounds__(NT, 3) quad_seeded_beyond(QArgs a) {
  quotient_body<QUAD_SEEDED, false, DES_BEYOND>(a);
}
__global__ void __launch_bounds__(NT, 2) linear_seeded_devw_beyond(QArgs a) {
  quotient_body<LIN_SEEDED, false, DES_DEVW | DES_BEYOND>(a);
}
__global__ void __launch_bounds__(NT, 2) quad_seeded_devw_beyond(QArgs a) {
  quotient_body<QUAD_SEEDED, false, DES_DEVW | DES_BEYOND>(a);
}

namespace {

typedef void (*QKernelFn)(QArgs);

template <bool LIN, bool FOLD, int DES>
QKernelFn sums_budget(int minb) {
  switch (minb) {
    case 2: return LIN ? linear_sums_planned<FOLD, DES, 2> : quad_sums_planned<FOLD, DES, 2>;
    case 3: return LIN ? linear_sums_planned<FOLD, DES, 3> : quad_sums_planned<FOLD, DES, 3>;
    default: return nullptr;
  }
}

template <bool LIN>
QKernelFn sums_planned(int fold, int des, int minb) {
  switch (des) {
    case DES_PLANNED:
      return fold ? sums_budget<LIN, true, DES_PLANNED>(minb)
                  : sums_budget<LIN, false, DES_PLANNED>(minb);
    case DES_PLANNED | DES_ITEM2:
      return fold ? sums_budget<LIN, true, DES_PLANNED | DES_ITEM2>(minb)
                  : sums_budget<LIN, false, DES_PLANNED | DES_ITEM2>(minb);
    case DES_PLANNED | DES_DEVW:   // no fold, the two-block budget
      if (fold || minb != 2) return nullptr;
      return LIN ? linear_sums_planned<false, DES_PLANNED | DES_DEVW, 2>
                 : quad_sums_planned<false, DES_PLANNED | DES_DEVW, 2>;
    default: return nullptr;
  }
}

// The seeded kinds' kernel of a variant and design: the core's routines
// (des 0), the weights from device memory (DES_DEVW), and either for the
// nets of beyond_net (| DES_BEYOND, no fold).
template <bool LIN>
QKernelFn seeded_kernel(int fold, int des) {
  switch (des) {
    case 0:
      return LIN ? (fold ? linear_seeded_kernel<true> : linear_seeded_kernel<false>)
                 : (fold ? quad_seeded_kernel<true> : quad_seeded_kernel<false>);
    case DES_DEVW: return fold ? nullptr : LIN ? linear_seeded_devw : quad_seeded_devw;
    case DES_BEYOND: return fold ? nullptr : LIN ? linear_seeded_beyond : quad_seeded_beyond;
    case DES_DEVW | DES_BEYOND:
      return fold ? nullptr : LIN ? linear_seeded_devw_beyond : quad_seeded_devw_beyond;
    default: return nullptr;
  }
}

// The kernel of a kind, variant and design: the seeded kinds on the core's
// routines (seeded_kernel); the sums kinds in a planned design at the
// register budget of minb blocks per SM.
QKernelFn qkernel_for(int kind, int fold, int des, int minb) {
  switch (kind) {
    case LIN_SUMS: return sums_planned<true>(fold, des, minb);
    case LIN_SEEDED: return seeded_kernel<true>(fold, des);
    case QUAD_SUMS: return sums_planned<false>(fold, des, minb);
    case QUAD_SEEDED: return seeded_kernel<false>(fold, des);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// kind: 0 linear sums, 1 linear seeded, 2 quadratic sums, 3 quadratic
// seeded.  lap: carry the Laplacian stream (linear kinds only; 0 is
// no_lap).  scal: device seeds (seeded kinds; else may be null).  flags:
// the plan's Flags (the sums kinds: RES_WEIGHTS or 0).  fold: the variant
// with the activation in the products' epilogues (at most 4 streams).  des,
// minb: the sums kinds' planned design (fwdlap_planned.cuh) and register
// budget in blocks per SM (2 or 3); the seeded kinds take 0, 0 (DES_DEVW,
// 0 for their variant reading the weights from device memory; DES_BEYOND
// added, and only, for the nets of beyond_net).  Every kind takes the nets
// beyond the other kernels' limits (make_net's `beyond`).  wd: with
// DES_DEVW the hidden weights (the seeded kinds: then their transposes),
// each rounded up to multiples of 4 with zeros, back to back (the resident
// layout), else ignored.
// partial (G, row)
// and out (row) with row = 4 / P+1 / 2 / P+1; scratch (G, K-2, S, T, wmax)
// for the seeded kinds on a net with more than one hidden layer (else may
// be null).  smem_bytes must hold the layout of quotient_body for (T,
// flags).
int fused_quotient_f32(int kind, int lap, const float* X, const float* coef,
                       const float* params, const float* scal, const int* layers,
                       int n_layers, int act, int N, int T, int G, int flags, int fold,
                       int des, int minb, float* partial, float* scratch, float* out,
                       int smem_bytes, void* stream, const float* wd) {
  QKernelFn fn = qkernel_for(kind, fold, des, minb);
  QArgs a;
  if (fn == nullptr || (lap != 0 && !is_linear(kind)) ||
      !make_net(lap != 0 ? 1 : 0, layers, n_layers, act, &a.net, true) || N < 1 || T < 4 ||
      T % 4 != 0 || T > NT / 2 || G < 1 || flags < 0 || flags > 15 ||
      (fold && a.net.S > 4) ||
      (!is_seeded(kind) && (flags & ~(RES_WEIGHTS | DEV_WEIGHTS)) != 0) ||
      ((flags & DEV_WEIGHTS) != 0) != ((des & DES_DEVW) != 0) ||
      ((flags & DEV_WEIGHTS) && ((flags & RES_WEIGHTS) || (a.net.K > 2 && wd == nullptr))) ||
      (is_seeded(kind) && (scal == nullptr || (a.net.K > 2 && scratch == nullptr) ||
                           ((des & DES_BEYOND) != 0) != beyond_net(a.net))) ||
      4 * smem_floats(a.net, kind, T, flags) > smem_bytes)
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
  a.row = is_seeded(kind) ? a.net.P + 1 : (is_linear(kind) ? 4 : 2);
  a.flags = flags;
  a.wd = wd;
  cudaError_t err = ensure_smem((const void*)fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fn<<<G, NT, smem_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows(partial, G, a.row, out, s);
}

// Resident blocks per SM for a kind and variant at a dynamic shared-memory
// size.
int fused_quotient_blocks_per_sm(int kind, int fold, int des, int minb, int smem_bytes,
                                 int* blocks) {
  QKernelFn fn = qkernel_for(kind, fold, des, minb);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = ensure_smem((const void*)fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT, smem_bytes);
}

// The shared-memory bytes quotient_body lays out for (T, flags), or -1 for
// a kind or net the kernels do not take.
int fused_quotient_smem_bytes(int kind, int lap, const int* layers, int n_layers, int T,
                              int flags) {
  Net net;
  if (kind < LIN_SUMS || kind > QUAD_SEEDED || (lap != 0 && !is_linear(kind)) ||
      !make_net(lap != 0 ? 1 : 0, layers, n_layers, 0, &net, true))
    return -1;
  return 4 * smem_floats(net, kind, T, flags);
}

}  // extern "C"
