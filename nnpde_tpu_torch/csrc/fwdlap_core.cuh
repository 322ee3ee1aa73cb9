// Shared per-tile device routines of the fused loss+grad kernels.
//
// Replaces nnpde_tpu/kernels/fwdlap_pallas.py::_fwd_recompute and
// ::_reverse_sweep (with _act_pack / _nl_bwd_pack): the forward-Laplacian
// recurrence of an MLP carried over a tile of T points, and the reverse
// sweep from per-point cotangents of the last hidden stage's streams down to
// the summed dW/db.
//
// Layout.  A block owns one tile at a time.  The streams of one stage sit in
// shared memory as buf[(s*T + p)*wmax + j]: stream s (0 = value, 1..d = the
// input-Jacobian rows, d+1 = Laplacian when carried), point p, neuron j.
// Every linear layer is then one (S*T, w_in) x (w_in, w_out) product over
// all streams at once (the TPU kernels' concat_streams form).
//
// Widths.  Every kernel takes hidden widths from 1 to NT; the fp32 fused
// kernels (fused_step.cu), the jet pair (fwdlap_forward.cu's rows,
// fwdlap_backward.cu) and the fp32 quotients (fused_quotient.cu) also take
// wider, deeper and higher-dimensional nets, to MAX_WIDTH, MAX_LAYERS
// weight matrices and d = MAX_DIM (make_net's `beyond`), and so do the
// bf16-dot modes of the fused kernels and the jet pair (fwdlap_mma.cuh; the
// jet forward's to d = CORE_DIM); the others keep CORE_*.  The elementwise walks (UnitWalk) step NT entries at a time and
// wrap once per step at any width (Net::ntq = NT / width is 0 above NT);
// the last layer's dW split (NT / width threads per column) is the one
// routine that needs NT / width >= 1, and the variants for such nets
// (fwdlap_planned.cuh's DES_BEYOND, reverse_sweep's BEYOND) sum columns j,
// j + NT, ... one thread each.  What a wide net costs is shared memory (the
// launch plans, kernels/_plan.py; above NT only the weights in device
// memory fit).  Device memory keeps the true sizes (net.w: the parameter
// vector, the gradient rows); shared memory holds every hidden layer
// rounded up to a multiple of 4
// (net.wp, and wmax is the widest rounded width), the extra rows and
// columns of a staged weight matrix zero.  A padded unit then carries zero
// in every stream (sin(0) = tanh(0) = gelu(0) = 0, and its Jacobian and
// Laplacian streams start at zero), feeds nothing into the next layer, and
// its gradient entries are never written, so the 4 x 4 register tiles and
// 128-bit shared loads run unchanged.  Widths that are multiples of 4 take
// the 16-byte copy paths as before; others stage weights element by
// element (their offsets in the flat vector are not 16-byte aligned).
//
// Bound.  By operations: per point the step does 3*(d+2)*sum(n_in*n_out)
// multiply-adds against 32 bytes of input (X and coefficients).  The
// products run fp32 FFMA on CUDA cores from shared memory: each thread owns
// a 4 x 4 register tile (mm_rows, accum_dW), reading 128-bit words.  What
// holds the kernels at 10-25% of that bound is not the products alone:
// an instrumented build (clock64 around every barrier, 2-50-50-50-50-1,
// 16-point tiles, two blocks per SM) gave the products about half of a
// pass-B tile, the elementwise stages (stage_mid, stage_bwd: a sincos pack
// per unit) about a third, saved-stage and weight traffic under a tenth;
// every phase is short and ends in a barrier, so resident blocks per SM
// matter more than bytes.  Hence FOLD (template parameter of fwd_recompute
// and reverse_sweep; every kernel comes in both variants and the wrapper
// picks one, _cuda.folds): where a point's streams fit one register tile
// (S <= 4) and the tile's (point, 4 units) items are one wave of the block,
// each hidden stage's activation is applied in the epilogue of the product
// that makes the stage (mm_act), and the reverse sweep's nonlinearity in
// the epilogue of the dmid product (mm_act_bwd), which also copies back its
// own saved entries while it multiplies: one elementwise pass, one
// shared-memory round trip and one barrier per stage fewer, with
// stage_mid's and stage_mid_bwd's arithmetic.  Compiled as a run-time
// branch of one kernel the folded path's registers slowed the other (a u50
// K-bump pass B by 6-9%), hence two variants.
//
// Residency.  A kernel may keep the hidden weights and their transposes in
// shared memory for the block's life (struct Resident, filled by
// stage_resident); with the default, all null, the weights of one layer are
// staged per tile (cp.async forward, a transposed copy for the backward).
// Where one layer's weights do not fit shared memory beside a tile (a
// 256 x 256 layer is 256 KB), Resident points at a padded copy of them in
// device memory in the resident layout, and the products read them from
// there through the caches (Flags::DEV_WEIGHTS, the kernels' DES_DEVW).
// Separately, `grow`, where the reverse sweep adds dW/db, may be the block's
// row of the partial buffer in device memory (a read-modify-write of P
// floats per tile) or a row of shared memory that the kernel writes out once
// per block (Flags::RES_GRAD): the launch plan (kernels/_plan.py) takes the
// two choices one at a time, weights and row, then the row alone, then
// neither.  The earlier stages' pre-activations go to a per-block slice of
// global scratch, (K-2)*S*T*wmax floats, written once in the forward and
// copied back with cp.async in the reverse sweep (mostly L2 resident;
// keeping them in shared memory cost more in tile size and resident blocks
// than the copies do).  The last stage's always stay in shared memory; the
// activation pack and the mid streams are recomputed from the saved
// pre-activations.

// Determinism.  Each element of dW/db and each loss sum is always updated by
// the same thread (or the same group of lanes through a fixed shuffle tree)
// in the same tile order, in-block reductions use fixed trees, and a second
// kernel sums the blocks' rows in a fixed order.  No atomics: two launches
// on the same inputs are bitwise equal.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace fwdlap {

constexpr int NT = 256;          // threads per block
constexpr int MAX_LAYERS = 64;   // weight matrices (the Net's table)
constexpr int MAX_DIM = 64;      // input dimension
// Hidden width: above ~1600 no tile of 4 points fits shared memory in any
// fp32 kernel, and the cap keeps the layouts' int arithmetic in range.
constexpr int MAX_WIDTH = 4096;
// What the kernels other than the fused ones, the jet pair and the fp32
// quotients take (make_net without `beyond`; header note), and the size
// of the per-thread arrays of the fused kernels' loss terms (fused_step.cu)
// below DES_BEYOND.
constexpr int CORE_LAYERS = 16;
constexpr int CORE_DIM = 16;

enum Act { ACT_SIN = 0, ACT_TANH = 1, ACT_GELU = 2 };

struct Net {
  int K;                      // number of weight matrices
  int w[MAX_LAYERS + 1];      // layer sizes: w[0] = d, w[K] = 1
  int wp[MAX_LAYERS + 1];     // hidden sizes rounded up to a multiple of 4
  int ntq[MAX_LAYERS + 1];    // NT / wp[k] for the hidden layers (unit_walk)
  int aligned;                // 1 when every hidden width is a multiple of 4
  int off[MAX_LAYERS];        // flat offset of W_k; b_k follows W_k
  int act;
  int d;
  int S;                      // streams: d + 2 with the Laplacian, else d + 1
  int lap;                    // 1 when the Laplacian stream is carried
  int wmax;                   // widest hidden layer, rounded up (wp)
  int P;                      // flat parameter count
};

struct Pack { float s0, s1, s2, s3; };

// What a launch plan keeps in shared memory for the block's life (the flags
// of kernels/_plan.py).
enum Flags {
  RES_WEIGHTS = 1,   // hidden weights (pass B: and their transposes)
  NARROW = 2,        // pass B: gradient products with few entries dealt by
                     // rows to groups of lanes (accum_dW)
  RES_GRAD = 4,      // pass B: the block's gradient row
  DEV_WEIGHTS = 8,   // no weights in shared memory: the products read the
                     // hidden weights (and transposes) from device memory,
                     // a padded copy in the resident layout (design DES_DEVW;
                     // the tensor-core design and the K-bump pair: the
                     // weights as they are, fwdlap_mma.cuh, fused_multibump.cu)
  DEV_SUMS = 16,     // the tensor-core design: the projection partials and the
                     // column sums in device scratch (fwdlap_mma.cuh)
};

// What a kernel keeps in shared memory for the block's whole life, where the
// core would otherwise fetch it per tile.  Every member null (the default):
// weights staged per layer per tile into Wsh, every gradient product owned
// by one thread.
struct Resident {
  const float* W = nullptr;    // hidden-to-hidden W_k, k = 1..K-2, rounded
                               // (wp[k], wp[k+1]) matrices back to back
  const float* Wt = nullptr;   // their transposes, same offsets
  bool narrow = false;         // gradient products with few entries are
                               // dealt by rows to groups of lanes
};

// (s, s', s'', s''') with the fewest transcendentals (_act_pack).
__device__ __forceinline__ Pack act_pack(int act, float v) {
  Pack r;
  if (act == ACT_SIN) {
    float s, c;
    sincosf(v, &s, &c);
    r.s0 = s; r.s1 = c; r.s2 = -s; r.s3 = -c;
  } else if (act == ACT_TANH) {
    float t = tanhf(v);
    float u = 1.0f - t * t;
    r.s0 = t; r.s1 = u; r.s2 = -2.0f * t * u; r.s3 = u * (6.0f * t * t - 2.0f);
  } else {
    const float inv_sqrt2pi = 0.3989422804014327f;
    float pdf = inv_sqrt2pi * expf(-0.5f * v * v);
    float cdf = 0.5f * (1.0f + erff(v * 0.7071067811865476f));
    r.s0 = v * cdf; r.s1 = cdf + v * pdf; r.s2 = (2.0f - v * v) * pdf;
    r.s3 = (v * v * v - 4.0f * v) * pdf;
  }
  return r;
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[q][c] += a[q].(kk) * w.(c) for a 4 x 4 register tile.
__device__ __forceinline__ void fma_tile(float (&acc)[4][4], const float4 (&a)[4],
                                         int kk, const float4& w) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float s = lane(a[q], kk);
    acc[q][0] = fmaf(s, w.x, acc[q][0]);
    acc[q][1] = fmaf(s, w.y, acc[q][1]);
    acc[q][2] = fmaf(s, w.z, acc[q][2]);
    acc[q][3] = fmaf(s, w.w, acc[q][3]);
  }
}

// out[r][j] = sum_k in[r][k] * W[k][j] (+ bias[j] for r < bias_rows and
// j < bias_cols).  rows, kdim, ncols, ld_in, ld_out all multiples of 4.
// Each item is a 4-row x 4-column register tile: per 4 k's it reads 4 + 4
// float4s from shared memory for 64 FMAs (the row reads are warp
// broadcasts).
__device__ __forceinline__ void mm_rows(const float* __restrict__ in, int ld_in,
                                        int rows, int kdim,
                                        const float* __restrict__ W, int ncols,
                                        float* __restrict__ out, int ld_out,
                                        const float* __restrict__ bias,
                                        int bias_rows, int bias_cols) {
  const int cg = ncols >> 2;
  const int items = (rows >> 2) * cg;
  for (int it = threadIdx.x; it < items; it += NT) {
    const int rg = it / cg;
    const int r0 = rg << 2;
    const int j0 = (it - rg * cg) << 2;
    float acc[4][4] = {};
    for (int k = 0; k < kdim; k += 4) {
      float4 a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a[q] = *reinterpret_cast<const float4*>(in + (r0 + q) * ld_in + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        fma_tile(acc, a, kk,
                 *reinterpret_cast<const float4*>(W + (k + kk) * ncols + j0));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 o = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
      if (bias != nullptr && r0 + q < bias_rows) {
        if (j0 + 3 < bias_cols) {
          o.x += bias[j0]; o.y += bias[j0 + 1]; o.z += bias[j0 + 2]; o.w += bias[j0 + 3];
        } else {
          if (j0 < bias_cols) o.x += bias[j0];
          if (j0 + 1 < bias_cols) o.y += bias[j0 + 1];
          if (j0 + 2 < bias_cols) o.z += bias[j0 + 2];
        }
      }
      *reinterpret_cast<float4*>(out + (r0 + q) * ld_out + j0) = o;
    }
  }
}

// The block's walk over the (point p, unit j) entries of hidden stage k, T x
// wp[k] of them: thread t takes entries t, t + NT, ... in row-major order.
// One division when the walk starts; each further entry is an add and a
// compare (a division per entry was a third of an elementwise stage's
// instructions).
struct UnitWalk {
  int p, j, width, dp, dj;
  __device__ __forceinline__ UnitWalk(const Net& net, int k)
      : width(net.wp[k]), dp(net.ntq[k]) {
    dj = NT - dp * width;
    p = (int)(threadIdx.x / (unsigned)width);
    j = (int)threadIdx.x - p * width;
  }
  __device__ __forceinline__ void next() {
    p += dp;
    j += dj;
    if (j >= width) {
      j -= width;
      ++p;
    }
  }
};

// Mid streams (A, Jmid, lmid) of hidden stage k from its pre-activation
// streams.  Reads pre from `src`, writes mid to `dst` (may alias),
// optionally copies the pre streams to `save` (same layout).
__device__ __forceinline__ void stage_mid(const Net& net, int T, int k,
                                          const float* src, float* dst,
                                          float* save) {
  const int d = net.d, ld = net.wmax, sT = T * ld;   // sT: one stream
  for (UnitWalk w(net, k); w.p < T; w.next()) {
    const int o0 = w.p * ld + w.j;
    const float v = src[o0];
    const Pack pk = act_pack(net.act, v);
    if (save) save[o0] = v;
    dst[o0] = pk.s0;
    float q = 0.f;
    int o = o0 + sT;
#pragma unroll 1
    for (int i = 0; i < d; ++i, o += sT) {
      const float Ji = src[o];
      if (save) save[o] = Ji;
      q = fmaf(Ji, Ji, q);
      dst[o] = pk.s1 * Ji;
    }
    if (net.lap) {
      const float l = src[o];
      if (save) save[o] = l;
      dst[o] = pk.s1 * l + pk.s2 * q;
    }
  }
}

// The point-major product of a hidden stage with the activation folded into
// its epilogue, for SS = S <= 4 streams (d <= 2 with the Laplacian, d <= 3
// without; wider inputs take mm_rows + stage_mid).  Item (p, j0): the SS x 4
// register tile of every stream of point p at units j0..j0+3 of the next
// stage, pre = in W (+ bias on the value stream, columns < bias_cols), so
// one thread holds all it needs for the activation: it saves pre to `save`
// (same layout; may be null) and writes the mid streams (stage_mid's
// arithmetic, in its order) to `out`.  kdim, ncols multiples of 4.
template <int SS>
__device__ __forceinline__ void mm_act(const Net& net, int T, const float* __restrict__ in,
                                       int kdim, const float* __restrict__ W, int ncols,
                                       const float* __restrict__ bias, int bias_cols,
                                       float* __restrict__ out, float* __restrict__ save) {
  const int ld = net.wmax, sT = T * ld;
  const int cg = ncols >> 2, items = T * cg;
  for (int it = threadIdx.x; it < items; it += NT) {
    const int p = it / cg;
    const int j0 = (it - p * cg) << 2;
    const int o0 = p * ld + j0;
    float acc[SS][4] = {};
    for (int k = 0; k < kdim; k += 4) {
      float4 a[SS];
#pragma unroll
      for (int s = 0; s < SS; ++s)
        a[s] = *reinterpret_cast<const float4*>(in + p * ld + s * sT + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w = *reinterpret_cast<const float4*>(W + (k + kk) * ncols + j0);
#pragma unroll
        for (int s = 0; s < SS; ++s) {
          const float x = lane(a[s], kk);
          acc[s][0] = fmaf(x, w.x, acc[s][0]);
          acc[s][1] = fmaf(x, w.y, acc[s][1]);
          acc[s][2] = fmaf(x, w.z, acc[s][2]);
          acc[s][3] = fmaf(x, w.w, acc[s][3]);
        }
      }
    }
    float mid[SS][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (j0 + c < bias_cols) acc[0][c] += bias[j0 + c];
      const Pack pk = act_pack(net.act, acc[0][c]);
      mid[0][c] = pk.s0;
      float q = 0.f;
#pragma unroll
      for (int s = 1; s < SS; ++s) {
        if (net.lap && s == SS - 1) {
          mid[s][c] = pk.s1 * acc[s][c] + pk.s2 * q;
        } else {
          q = fmaf(acc[s][c], acc[s][c], q);
          mid[s][c] = pk.s1 * acc[s][c];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < SS; ++s) {
      *reinterpret_cast<float4*>(out + o0 + s * sT) =
          make_float4(mid[s][0], mid[s][1], mid[s][2], mid[s][3]);
      if (save)
        *reinterpret_cast<float4*>(save + o0 + s * sT) =
            make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
    }
  }
}

// Copy n floats (n % 4 == 0, both sides 16-byte aligned) from global to
// shared memory with cp.async: every thread's copies are in flight at once.
// Completes at copy_wait().
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n) {
  for (int f = threadIdx.x * 4; f < n; f += NT * 4)
    __pipeline_memcpy_async(dst + f, src + f, 16);
  __pipeline_commit();
}

__device__ __forceinline__ void copy_wait() { __pipeline_wait_prior(0); }

// Stage the (wi, wo) row-major matrix W of device memory as the zero-padded
// (wip, wop) matrix Wsh of shared memory.  Completes at copy_wait().
__device__ __forceinline__ void stage_weights(const Net& net, float* Wsh, const float* W,
                                              int wi, int wo, int wip, int wop) {
  if (net.aligned) {
    copy_async(Wsh, W, wi * wo);
    return;
  }
  for (int f = threadIdx.x; f < wip * wop; f += NT) {
    const int i = f / wop, j = f - i * wop;
    if (i < wi && j < wo)
      __pipeline_memcpy_async(Wsh + f, W + i * wo + j, 4);
    else
      Wsh[f] = 0.f;
  }
  __pipeline_commit();
}

// Wt[j][i] = W[i][j] (j < wop, i < wip; zero past the (wi, wo) matrix of
// device memory).  Aligned nets: four float4 loads in flight per thread,
// scattered stores.
__device__ __forceinline__ void load_transposed(const Net& net, float* Wt, const float* W,
                                                int wi, int wo, int wip, int wop) {
  if (!net.aligned) {
    for (int f = threadIdx.x; f < wip * wop; f += NT) {
      const int i = f / wop, j = f - i * wop;
      Wt[j * wip + i] = (i < wi && j < wo) ? W[i * wo + j] : 0.f;
    }
    return;
  }
  const int n4 = (wi * wo) >> 2;
  const float4* W4 = reinterpret_cast<const float4*>(W);
  for (int f0 = threadIdx.x; f0 < n4; f0 += 4 * NT) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (f0 + u * NT < n4) v[u] = W4[f0 + u * NT];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int f = f0 + u * NT;
      if (f < n4) {
        const int i = (4 * f) / wo, j = 4 * f - i * wo;
        Wt[j * wi + i] = v[u].x;
        Wt[(j + 1) * wi + i] = v[u].y;
        Wt[(j + 2) * wi + i] = v[u].z;
        Wt[(j + 3) * wi + i] = v[u].w;
      }
    }
  }
}

// Floats of the resident hidden-to-hidden matrices: sum over k = 1..K-2 of
// wp[k] * wp[k+1].
__host__ __device__ inline int hidden_floats(const Net& net) {
  int n = 0;
  for (int k = 1; k < net.K - 1; ++k) n += net.wp[k] * net.wp[k + 1];
  return n;
}

// Stage every hidden-to-hidden W_k into W (and its transpose into Wt, when
// given) once, for Resident.  Completes at copy_wait().
__device__ inline void stage_resident(const Net& net, const float* __restrict__ params,
                                      float* W, float* Wt) {
  int woff = 0;
  for (int k = 1; k < net.K - 1; ++k) {
    const int wk = net.w[k], wn = net.w[k + 1], wkp = net.wp[k], wnp = net.wp[k + 1];
    stage_weights(net, W + woff, params + net.off[k], wk, wn, wkp, wnp);
    if (Wt) load_transposed(net, Wt + woff, params + net.off[k], wk, wn, wkp, wnp);
    woff += wkp * wnp;
  }
}

// Row stride of a coefficient tile in shared memory: odd, so that threads
// on neighbouring points read neighbouring banks.
__host__ __device__ inline int coef_stride(int nc) { return nc | 1; }

// cf[p][:] = coef[base + p][:] for the tile's T points at row stride ncp;
// rows past N read 0.  A warp copies whole rows (lane l the floats l, l +
// 32, ...: consecutive lanes, consecutive floats of device memory, and no
// division per float): full tiles by 4-byte cp.async, complete at
// copy_wait(); the ragged last tile by plain loads.
__device__ __forceinline__ void load_coef_tile(const float* __restrict__ coef, int N,
                                               int nc, int ncp, int base, int T,
                                               float* cf) {
  const int lane = threadIdx.x & 31;
  const bool full = base + T <= N;
  for (int p = threadIdx.x >> 5; p < T; p += NT >> 5) {
    const float* src = coef + (size_t)(base + p) * nc;
    float* dst = cf + p * ncp;
    if (full) {
      for (int f = lane; f < nc; f += 32) __pipeline_memcpy_async(dst + f, src + f, 4);
    } else {
      const bool valid = base + p < N;
      for (int f = lane; f < nc; f += 32) dst[f] = valid ? src[f] : 0.f;
    }
  }
  if (full) __pipeline_commit();
}

// Forward recompute over one tile.  xs: (T, d) points in shared memory.
// On return `cur` holds the mid streams of the last hidden stage, `last`
// (shared) its pre-activation streams, and the scratch slice the earlier
// stages' pre-activation streams.  A kernel with no reverse sweep passes
// null for `last` and `scratch`: nothing is saved.
template <bool RES = false, bool FOLD = false>
__device__ inline void fwd_recompute(const Net& net, int T, const float* __restrict__ xs,
                                     const float* __restrict__ params, float*& cur,
                                     float*& nxt, float* last, float* Wsh, float* scratch,
                                     const Resident& res = Resident{}) {
  const int d = net.d, ld = net.wmax, S = net.S;
  const int stage_sz = S * T * ld;
  // without RES the policy is the default whatever `res` holds, and the
  // compiler sees it: kernels that stage per tile compile to exactly that
  const float* resW = RES ? res.W : nullptr;
  // FOLD (S <= 4): the activation is applied in the epilogue of the product
  // that makes each stage (mm_act); otherwise a separate pass (stage_mid)
  // after mm_rows.  A compile-time choice: each kernel comes in both
  // variants, so the folded path's registers never burden the other
  constexpr bool fold = FOLD;
  int woff = 0;                 // offset of W_k in the resident matrices
  if (fold && !resW && net.K > 2)   // W_1 lands while the input layer runs
    stage_weights(net, Wsh, params + net.off[1], net.w[1], net.w[2], net.wp[1], net.wp[2]);
  {  // input layer: v = x W0 + b0; J_i = W0[i, :]; l = 0 (padded units 0)
    const int w1 = net.w[1];
    const float* W0 = params + net.off[0];
    const float* b0 = W0 + d * w1;
    float* save = net.K == 2 ? last : scratch;
    const int sT = T * ld;
    for (UnitWalk w(net, 1); w.p < T; w.next()) {
      const int p = w.p, j = w.j, o0 = p * ld + j;
      const bool real = j < w1;
      float v = 0.f;
#pragma unroll 1
      for (int i = 0; i < d; ++i) {
        const float wij = real ? W0[i * w1 + j] : 0.f;
        v = fmaf(xs[p * d + i], wij, v);
        cur[o0 + (1 + i) * sT] = wij;   // the Jacobian seed rows stay fp32
      }
      v = real ? v + b0[j] : 0.f;
      if (!fold) {
        cur[o0] = v;
        if (net.lap) cur[o0 + (d + 1) * sT] = 0.f;
        continue;
      }
      // stage 1's activation, stage_mid's arithmetic
      const Pack pk = act_pack(net.act, v);
      if (save) save[o0] = v;
      cur[o0] = pk.s0;
      float q = 0.f;
      int o = o0 + sT;
#pragma unroll 1
      for (int i = 0; i < d; ++i, o += sT) {
        const float Ji = cur[o];
        if (save) save[o] = Ji;
        q = fmaf(Ji, Ji, q);
        cur[o] = pk.s1 * Ji;
      }
      if (net.lap) {
        if (save) save[o] = 0.f;
        cur[o] = pk.s1 * 0.f + pk.s2 * q;
      }
    }
  }
  __syncthreads();
  if constexpr (FOLD) {
    for (int k = 1; k < net.K - 1; ++k) {
      const int wk = net.w[k], wkp = net.wp[k], wn = net.w[k + 1], wnp = net.wp[k + 1];
      const float* Wk = params + net.off[k];
      if (!resW) {
        if (k > 1) stage_weights(net, Wsh, Wk, wk, wn, wkp, wnp);
        copy_wait();
        __syncthreads();
      }
      float* save = k + 1 == net.K - 1 ? last : scratch ? scratch + k * stage_sz : nullptr;
      const float* Wm = resW ? resW + woff : Wsh;
      if (S == 2)
        mm_act<2>(net, T, cur, wkp, Wm, wnp, Wk + wk * wn, wn, nxt, save);
      else if (S == 3)
        mm_act<3>(net, T, cur, wkp, Wm, wnp, Wk + wk * wn, wn, nxt, save);
      else                                // S == 4 (the launch checks S <= 4)
        mm_act<4>(net, T, cur, wkp, Wm, wnp, Wk + wk * wn, wn, nxt, save);
      woff += wkp * wnp;
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    return;
  }
  for (int k = 1; k < net.K; ++k) {
    const int wk = net.w[k], wkp = net.wp[k];
    const bool final_stage = k == net.K - 1;
    if (!final_stage && !resW)
      stage_weights(net, Wsh, params + net.off[k], wk, net.w[k + 1], wkp, net.wp[k + 1]);
    stage_mid(net, T, k, cur, cur,
              final_stage ? last : scratch ? scratch + (k - 1) * stage_sz : nullptr);
    if (final_stage) break;
    const int wn = net.w[k + 1];
    const float* Wk = params + net.off[k];
    if (!resW) copy_wait();
    __syncthreads();
    mm_rows(cur, ld, S * T, wkp, resW ? resW + woff : Wsh, net.wp[k + 1], nxt, ld,
            Wk + wk * wn, T, wn);
    woff += wkp * net.wp[k + 1];
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }
  __syncthreads();
}

// xs[p][i] = X[base + p][i] for the tile's T points; rows past N read 0.
__device__ __forceinline__ void load_tile(const float* __restrict__ X, int N, int d,
                                          int base, int T, float* xs) {
  for (int i = threadIdx.x; i < T * d; i += NT) {
    const int p = i / d;
    xs[i] = base + p < N ? X[(size_t)(base + p) * d + (i - p * d)] : 0.f;
  }
}

// Project the last hidden stage's mid streams onto the output row:
// proj[r] = cur[r] . wlast (+ blast on the T value rows), r < S*T.  Eight
// neighbouring lanes per row (lane c takes columns c, c + 8, ...), NT/8 rows
// per pass, and a fixed shuffle tree, so the result does not depend on
// scheduling.
__device__ __forceinline__ void project_last(const Net& net, int T, const float* cur,
                                             const float* __restrict__ wlast,
                                             float blast, float* proj) {
  const int wl = net.w[net.K - 1], ld = net.wmax, rows = net.S * T;
  const int sub = threadIdx.x & 7;
  for (int r0 = 0; r0 < rows; r0 += NT >> 3) {
    const int r = r0 + (threadIdx.x >> 3);
    float acc = 0.f;
    if (r < rows)
      for (int j = sub; j < wl; j += 8) acc = fmaf(cur[r * ld + j], wlast[j], acc);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (r < rows && sub == 0) proj[r] = r < T ? acc + blast : acc;
  }
}

// Backward through hidden stage k's nonlinearity (_nl_bwd_pack).  pre: the
// stage's saved pre-activation streams; dmid: cotangents of its mid streams
// (or null: rank-1 final stage, dmid = ct[s][p] * wl[j], wl holding
// `wl_cols` entries of device memory); dpre: output.
__device__ __forceinline__ void stage_bwd(const Net& net, int T, int k,
                                          const float* pre, const float* dmid,
                                          const float* ct, const float* wl,
                                          int wl_cols, float* dpre) {
  const int d = net.d, ld = net.wmax, sT = T * ld;
  for (UnitWalk w(net, k); w.p < T; w.next()) {
    const int p = w.p, j = w.j, o0 = p * ld + j;
    const Pack pk = act_pack(net.act, pre[o0]);
    const float wj = (dmid || j >= wl_cols) ? 0.f : wl[j];
    const float dA = dmid ? dmid[o0] : ct[p] * wj;
    float dv = pk.s1 * dA;
    float dq = 0.f;
    if (net.lap) {
      const int ol = o0 + (d + 1) * sT;
      const float dlm = dmid ? dmid[ol] : ct[(d + 1) * T + p] * wj;
      float q = 0.f;
      int o = o0 + sT;
#pragma unroll 1
      for (int i = 0; i < d; ++i, o += sT) {
        const float Ji = pre[o];
        q = fmaf(Ji, Ji, q);
      }
      dpre[ol] = pk.s1 * dlm;
      dq = pk.s2 * dlm;
      dv += (pk.s2 * pre[ol] + pk.s3 * q) * dlm;
    }
    int o = o0 + sT;
#pragma unroll 1
    for (int i = 0; i < d; ++i, o += sT) {
      const float Ji = pre[o];
      const float dJm = dmid ? dmid[o] : ct[(1 + i) * T + p] * wj;
      dv += pk.s2 * Ji * dJm;
      dpre[o] = pk.s1 * dJm + 2.0f * Ji * dq;
    }
    dpre[o0] = dv;
  }
}

// One reverse stage's two elementwise passes in one: from hidden stage k's
// saved pre-activation streams (`pre`) and the cotangents of its mid streams
// (`x`), write the mid streams over `x` (the rows of the dW product) and the
// cotangents of the pre-activation streams over `pre`.  One activation pack
// per unit serves both; each thread reads an entry before it overwrites it.
__device__ __forceinline__ void stage_mid_bwd(const Net& net, int T, int k, float* pre,
                                              float* x) {
  const int d = net.d, ld = net.wmax, sT = T * ld;
  for (UnitWalk w(net, k); w.p < T; w.next()) {
    const int o0 = w.p * ld + w.j;
    const float v = pre[o0];
    const Pack pk = act_pack(net.act, v);
    float dv = pk.s1 * x[o0];
    float dq = 0.f;
    if (net.lap) {
      const int ol = o0 + (d + 1) * sT;
      const float l = pre[ol], dlm = x[ol];
      float q = 0.f;
      int o = o0 + sT;
#pragma unroll 1
      for (int i = 0; i < d; ++i, o += sT) {
        const float Ji = pre[o];
        q = fmaf(Ji, Ji, q);
      }
      x[ol] = pk.s1 * l + pk.s2 * q;
      pre[ol] = pk.s1 * dlm;
      dq = pk.s2 * dlm;
      dv += (pk.s2 * l + pk.s3 * q) * dlm;
    }
    int o = o0 + sT;
#pragma unroll 1
    for (int i = 0; i < d; ++i, o += sT) {
      const float Ji = pre[o], dJm = x[o];
      dv += pk.s2 * Ji * dJm;
      x[o] = pk.s1 * Ji;
      pre[o] = pk.s1 * dJm + 2.0f * Ji * dq;
    }
    x[o0] = pk.s0;
    pre[o0] = dv;
  }
}

// The reverse counterpart of mm_act: dmid = D W^T for every stream of point
// p at units j0..j0+3 of stage k (SS <= 4), and in the epilogue
// stage_mid_bwd's arithmetic on the thread's own entries: copies the saved
// pre-activations of those entries from `saved` (device memory) to `pre` by
// cp.async while the product runs, overwrites them with their cotangents,
// and writes the mid streams to `x`.  kdim, ncols multiples of 4.
template <int SS>
__device__ __forceinline__ void mm_act_bwd(const Net& net, int T, const float* __restrict__ D,
                                           int kdim, const float* __restrict__ Wt, int ncols,
                                           const float* __restrict__ saved,
                                           float* __restrict__ pre, float* __restrict__ x) {
  const int ld = net.wmax, sT = T * ld;
  const int cg = ncols >> 2, items = T * cg;
  for (int it = threadIdx.x; it < items; it += NT) {
    const int p = it / cg;
    const int j0 = (it - p * cg) << 2;
    const int o0 = p * ld + j0;
    // the thread's own saved entries come back while it multiplies
#pragma unroll
    for (int s = 0; s < SS; ++s)
      __pipeline_memcpy_async(pre + o0 + s * sT, saved + o0 + s * sT, 16);
    __pipeline_commit();
    float acc[SS][4] = {};
    for (int k = 0; k < kdim; k += 4) {
      float4 a[SS];
#pragma unroll
      for (int s = 0; s < SS; ++s)
        a[s] = *reinterpret_cast<const float4*>(D + p * ld + s * sT + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w = *reinterpret_cast<const float4*>(Wt + (k + kk) * ncols + j0);
#pragma unroll
        for (int s = 0; s < SS; ++s) {
          const float xv = lane(a[s], kk);
          acc[s][0] = fmaf(xv, w.x, acc[s][0]);
          acc[s][1] = fmaf(xv, w.y, acc[s][1]);
          acc[s][2] = fmaf(xv, w.z, acc[s][2]);
          acc[s][3] = fmaf(xv, w.w, acc[s][3]);
        }
      }
    }
    __pipeline_wait_prior(0);
    float pv[SS][4];
#pragma unroll
    for (int s = 0; s < SS; ++s) {
      const float4 t = *reinterpret_cast<const float4*>(pre + o0 + s * sT);
      pv[s][0] = t.x; pv[s][1] = t.y; pv[s][2] = t.z; pv[s][3] = t.w;
    }
    float mid[SS][4], dpre[SS][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const Pack pk = act_pack(net.act, pv[0][c]);
      float dv = pk.s1 * acc[0][c];
      float dq = 0.f;
      if (net.lap) {
        const float l = pv[SS - 1][c], dlm = acc[SS - 1][c];
        float q = 0.f;
#pragma unroll
        for (int s = 1; s < SS - 1; ++s) q = fmaf(pv[s][c], pv[s][c], q);
        mid[SS - 1][c] = pk.s1 * l + pk.s2 * q;
        dpre[SS - 1][c] = pk.s1 * dlm;
        dq = pk.s2 * dlm;
        dv += (pk.s2 * l + pk.s3 * q) * dlm;
      }
#pragma unroll
      for (int s = 1; s < SS; ++s) {
        if (net.lap && s == SS - 1) continue;
        const float Ji = pv[s][c], dJm = acc[s][c];
        dv += pk.s2 * Ji * dJm;
        mid[s][c] = pk.s1 * Ji;
        dpre[s][c] = pk.s1 * dJm + 2.0f * Ji * dq;
      }
      mid[0][c] = pk.s0;
      dpre[0][c] = dv;
    }
#pragma unroll
    for (int s = 0; s < SS; ++s) {
      *reinterpret_cast<float4*>(x + o0 + s * sT) =
          make_float4(mid[s][0], mid[s][1], mid[s][2], mid[s][3]);
      *reinterpret_cast<float4*>(pre + o0 + s * sT) =
          make_float4(dpre[s][0], dpre[s][1], dpre[s][2], dpre[s][3]);
    }
  }
}

// dW[i][j] += sum_r M[r][i] * D[r][j] over rows r < rows; db[j] += sum over
// the value rows (r < T) of D.  dW is the true (wi, wo) matrix of device
// memory; the products run over the rounded (wip, wop) tiles of shared
// memory and entries past (wi, wo) are dropped.  Each item is a 4 x 4
// register tile of dW: two float4 reads per row feed 16 FMAs.
//
// `narrow` with at most NT/2 items: a group of 8 neighbouring lanes shares
// one item, lane c of the group taking rows c, c + 8, ..., and the group's
// partial tiles are added by a shuffle tree (a fixed order); NT/8 items per
// pass; db likewise with a group per column.  All threads must call it.
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void accum_dW(int rows, int T, int ld, int wi, int wo,
                                         int wip, int wop, const float* M,
                                         const float* D, float* dW, float* db,
                                         bool narrow = false) {
  const int jgs = wop >> 2;
  const int items = (wip >> 2) * jgs;
  if (narrow && 2 * items <= NT) {
    const int c = threadIdx.x & 7;
    for (int itb = 0; itb < items; itb += NT >> 3) {
      const int it = itb + (threadIdx.x >> 3);
      const bool live = it < items;
      const int ig = live ? it / jgs : 0;
      const int i0 = ig << 2, j0 = live ? (it - ig * jgs) << 2 : 0;
      float acc[4][4] = {};
      if (live) {
        for (int r = c; r < rows; r += 8) {
          const float4 m = *reinterpret_cast<const float4*>(M + r * ld + i0);
          const float4 dv = *reinterpret_cast<const float4*>(D + r * ld + j0);
          const float4 a[4] = {make_float4(m.x, 0.f, 0.f, 0.f), make_float4(m.y, 0.f, 0.f, 0.f),
                               make_float4(m.z, 0.f, 0.f, 0.f), make_float4(m.w, 0.f, 0.f, 0.f)};
          fma_tile(acc, a, 0, dv);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[q][cc] = group_sum(acc[q][cc]);
      if (live && c == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (i0 + q >= wi) break;
          float* row = dW + (i0 + q) * wo + j0;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            if (j0 + cc < wo) row[cc] += acc[q][cc];
        }
      }
    }
    for (int jb = 0; jb < wo; jb += NT >> 3) {
      const int j = jb + (threadIdx.x >> 3);
      float sacc = 0.f;
      if (j < wo)
        for (int p = c; p < T; p += 8) sacc += D[p * ld + j];
      sacc = group_sum(sacc);
      if (j < wo && c == 0) db[j] += sacc;
    }
    return;
  }
  for (int it = threadIdx.x; it < items; it += NT) {
    const int ig = it / jgs;
    const int i0 = ig << 2, j0 = (it - ig * jgs) << 2;
    float acc[4][4] = {};
    for (int r = 0; r < rows; ++r) {
      const float4 m = *reinterpret_cast<const float4*>(M + r * ld + i0);
      const float4 dv = *reinterpret_cast<const float4*>(D + r * ld + j0);
      const float4 a[4] = {make_float4(m.x, 0.f, 0.f, 0.f), make_float4(m.y, 0.f, 0.f, 0.f),
                           make_float4(m.z, 0.f, 0.f, 0.f), make_float4(m.w, 0.f, 0.f, 0.f)};
      fma_tile(acc, a, 0, dv);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (i0 + q >= wi) break;
      float* row = dW + (i0 + q) * wo + j0;
      if (j0 + 3 < wo) {
        row[0] += acc[q][0]; row[1] += acc[q][1]; row[2] += acc[q][2]; row[3] += acc[q][3];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (j0 + c < wo) row[c] += acc[q][c];
      }
    }
  }
  for (int j = threadIdx.x; j < wo; j += NT) {
    float s = 0.f;
    for (int p = 0; p < T; ++p) s += D[p * ld + j];
    db[j] += s;
  }
}

// Reverse sweep over one tile.  On entry `cur` holds the last stage's mid
// streams, `pre` (shared) its pre-activation streams, and ct = [ct_v (T) |
// ct_g (d*T) | ct_l (T)] the per-point cotangents of the projected (value,
// grad, lap).  Each earlier stage's pre-activations are copied back from
// scratch and overwritten by their cotangents; `cur`, `nxt` and `pre` are
// all consumed.  Accumulates dW/db into the block's partial row `grow` (flat
// parameter layout).  BEYOND: the variant for the nets of beyond_net (the
// seeded quotient kernels' DES_BEYOND, fused_quotient.cu), whose last
// layer's dW split takes widths above NT; the other kernels compile without
// it, so their code stays as it was.
template <bool RES = false, bool FOLD = false, bool BEYOND = false>
__device__ inline void reverse_sweep(const Net& net, int T, const float* __restrict__ xs,
                                     const float* __restrict__ params, float* cur,
                                     float* nxt, float* pre, float* Wsh,
                                     const float* scratch, const float* ct, float* red,
                                     float* grow, const Resident& res = Resident{}) {
  const int d = net.d, ld = net.wmax, S = net.S, K = net.K;
  const int stage_sz = S * T * ld;
  const int wl = net.w[K - 1];
  const float* wlast = params + net.off[K - 1];
  // dWlast[j] += sum_r mid[r][j] * ct[r] over the S*T rows r = (s, p):
  // `parts` threads per column, each over every parts-th row, then the
  // partial sums are added in a fixed order.  BEYOND at a width above NT
  // (parts would be 0): one thread per column (j, j + NT, ...), every row
  // in order, as reverse_sweep_p's DES_BEYOND does
  if (BEYOND && wl > NT) {
    for (int j = threadIdx.x; j < wl; j += NT) {
      float acc = 0.f;
      for (int r = 0; r < S * T; ++r) acc = fmaf(cur[r * ld + j], ct[r], acc);
      grow[net.off[K - 1] + j] += acc;
    }
  } else {
    const int parts = NT / wl;
    if (threadIdx.x < parts * wl) {
      const int j = threadIdx.x % wl, c = threadIdx.x / wl;
      float acc = 0.f;
      for (int r = c; r < S * T; r += parts) acc = fmaf(cur[r * ld + j], ct[r], acc);
      red[threadIdx.x] = acc;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < wl; j += NT) {
      float acc = 0.f;
      for (int c = 0; c < parts; ++c) acc += red[c * wl + j];
      grow[net.off[K - 1] + j] += acc;
    }
  }
  // last stage: mid cotangent is rank one, ct * wlast
  stage_bwd(net, T, K - 1, pre, nullptr, ct, wlast, wl, nxt);
  __syncthreads();
  // Stage k, three buffers in rotation: D holds the cotangent of stage
  // k+1's pre-activation streams, X takes dmid = D W_k^T and then the mid
  // streams, P takes the saved pre-activations and then their cotangent,
  // which is the next stage's D.
  float* D = nxt;
  float* X = cur;
  float* P = pre;
  const float* resWt = RES ? res.Wt : nullptr;
  const bool narrow = RES && res.narrow;
  int woff = RES ? hidden_floats(net) : 0;   // offset of W_k^T in the resident matrices
  for (int k = K - 2; k >= 1; --k) {
    const int wk = net.w[k], wn = net.w[k + 1];
    const int wkp = net.wp[k], wnp = net.wp[k + 1];
    woff -= wkp * wnp;
    const float* Wm = resWt ? resWt + woff : Wsh;
    const float* saved = scratch + (k - 1) * stage_sz;
    if constexpr (FOLD) {
      // dmid = D W^T and the stage's nonlinearity in one pass (mm_act_bwd),
      // each thread copying back the saved entries it reads
      if (!resWt) {
        load_transposed(net, Wsh, params + net.off[k], wk, wn, wkp, wnp);
        __syncthreads();
      }
      if (S == 2)
        mm_act_bwd<2>(net, T, D, wnp, Wm, wkp, saved, P, X);
      else if (S == 3)
        mm_act_bwd<3>(net, T, D, wnp, Wm, wkp, saved, P, X);
      else                                // S == 4
        mm_act_bwd<4>(net, T, D, wnp, Wm, wkp, saved, P, X);
      __syncthreads();
    } else {
      copy_async(P, saved, stage_sz);
      if (!resWt) {
        load_transposed(net, Wsh, params + net.off[k], wk, wn, wkp, wnp);
        __syncthreads();
      }
      // dmid = D W^T
      mm_rows(D, ld, S * T, wnp, Wm, wkp, X, ld, nullptr, 0, 0);
      copy_wait();
      __syncthreads();
      stage_mid_bwd(net, T, k, P, X);
      __syncthreads();
    }
    float* dW = grow + net.off[k];
    accum_dW(S * T, T, ld, wk, wn, wkp, wnp, X, D, dW, dW + wk * wn, narrow);
    __syncthreads();
    float* freed = D;
    D = P;
    P = X;
    X = freed;
  }
  // input layer: v = x W0 + b0, J_i = W0[i, :]
  const int w1 = net.w[1];
  float* dW0 = grow + net.off[0];
  // dW0[i][j] += sum_p x[p][i] dv[p][j] + sum_p dJ_i[p][j]; db0 = row d
  const int items0 = (d + 1) * w1;
  if (narrow && 2 * items0 <= NT) {
    // a group of 8 lanes per entry, the points dealt to its lanes
    const int c = threadIdx.x & 7;
    for (int itb = 0; itb < items0; itb += NT >> 3) {
      const int it = itb + (threadIdx.x >> 3);
      const bool live = it < items0;
      const int i = live ? it / w1 : 0, j = live ? it - i * w1 : 0;
      float acc = 0.f;
      if (live) {
        for (int p = c; p < T; p += 8) {
          // selects, not a branch: the lane groups of a warp take
          // different entries (i), and a branch here diverges
          const float dv = D[p * ld + j];
          acc = fmaf(i < d ? xs[p * d + i] : 1.f, dv, acc);
          if (i < d) acc += D[((1 + i) * T + p) * ld + j];
        }
      }
      acc = group_sum(acc);
      if (live && c == 0) dW0[it] += acc;
    }
    __syncthreads();
    return;
  }
  for (int it = threadIdx.x; it < items0; it += NT) {
    const int i = it / w1, j = it - i * w1;
    float acc = 0.f;
    if (i < d) {
      float sj = 0.f;
      for (int p = 0; p < T; ++p) {
        acc = fmaf(xs[p * d + i], D[p * ld + j], acc);
        sj += D[((1 + i) * T + p) * ld + j];
      }
      acc += sj;
    } else {
      for (int p = 0; p < T; ++p) acc += D[p * ld + j];
    }
    dW0[it] += acc;
  }
  __syncthreads();
}

// The network description from its layer sizes (host side): false when
// the kernels do not take the shape.  `lap`: carry the Laplacian stream.
// `beyond`: the limits of the fused kernels and the jet pair (both modes)
// and of the fp32 quotients (MAX_*), else the other kernels' (CORE_*,
// widths to NT).
inline bool make_net(int lap, const int* layers, int n_layers, int act, Net* net,
                     bool beyond = false) {
  const int K = n_layers - 1;
  const int max_k = beyond ? MAX_LAYERS : CORE_LAYERS, max_d = beyond ? MAX_DIM : CORE_DIM;
  const int max_w = beyond ? MAX_WIDTH : NT;
  if (K < 2 || K > max_k || act < 0 || act > 2) return false;
  net->K = K;
  net->act = act;
  net->d = layers[0];
  if (net->d < 1 || net->d > max_d || layers[K] != 1) return false;
  net->lap = lap;
  net->S = net->d + 1 + net->lap;
  net->wmax = 0;
  net->aligned = 1;
  int off = 0;
  for (int k = 0; k <= K; ++k) {
    net->w[k] = layers[k];
    net->wp[k] = (k >= 1 && k < K) ? (layers[k] + 3) & ~3 : layers[k];
    net->ntq[k] = (k >= 1 && k < K && layers[k] >= 1) ? NT / net->wp[k] : 0;
  }
  for (int k = 0; k < K; ++k) {
    net->off[k] = off;
    off += layers[k] * layers[k + 1] + layers[k + 1];
  }
  for (int k = 1; k < K; ++k) {
    if (layers[k] < 1 || layers[k] > max_w) return false;
    if (layers[k] % 4 != 0) net->aligned = 0;
    if (net->wp[k] > net->wmax) net->wmax = net->wp[k];
  }
  net->P = off;
  return true;
}

// Whether a net needs the DES_BEYOND variant of the planned kernels, of the
// fused kernels' tensor-core design and of the seeded quotients: a hidden
// width above NT (the last layer's dW split) or d above CORE_DIM (the fused
// kernels' per-thread arrays).
__host__ __device__ inline bool beyond_net(const Net& net) {
  return net.wmax > NT || net.d > CORE_DIM;
}

}  // namespace fwdlap

// out[j] = sum_g partial[g][j] in double, in a fixed order: the G rows are
// dealt to 32 row groups (group y takes rows y, y + 32, ...), each summed in
// order, and the 32 group sums are added in order.  Launches
// reduce_rows_kernel (defined once, in fused_step.cu) on `stream`; every
// kernel with per-block partial rows ends with it.
cudaError_t reduce_rows(const float* partial, int G, int R, float* out, cudaStream_t stream);

// Raise `kernel`'s dynamic shared-memory limit to smem_bytes unless an
// earlier call already raised it that far on the current device: the
// attribute is set once per (kernel, size), not per launch.  Callers on
// several threads take turns.  Defined once, in fused_multibump.cu.
cudaError_t ensure_smem(const void* kernel, int smem_bytes);
