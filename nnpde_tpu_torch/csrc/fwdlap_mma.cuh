// The tensor-core design (DES_MMA) of the bf16-dot kernels: the fused
// residual kernels (fused_step.cu: fused_linear_residual and
// fused_poisson_analytic with dot_dtype='bfloat16', the bulk of
// compute_dtype='hybrid-kernel') and the jet pair of that bulk
// (fwdlap_backward.cu with dot_dtype='bfloat16', fwdlap_forward.cu with
// fwd_impl='rows:default'), the Deep-Ritz energy (fused_step.cu), the
// quotients' two passes (fused_quotient_mma.cu) and the K-bump WAN pair's
// (fused_multibump_mma.cu).  One body, `body<KIND>`, serves four kinds:
// the fused kernels (KIND_FUSED: the cotangents from the loss terms, a
// policy the kernel is instantiated with: the residual, the Ritz energy,
// the quotients' and the K-bump pair's seeded cotangents), the jet backward
// (KIND_BWD: the cotangents loaded, no projection, no loss terms), the jet
// forward (KIND_FWD: the forward half, nothing saved, the jet rows written
// out) and pass A (KIND_SUMS: the forward half, nothing saved, the policy's
// per-point terms summed in double; the quotients' and the K-bump pair's).
// LAP (a template parameter of the body): the Laplacian stream is carried,
// S = d + 2; the Ritz energy, the quadratic quotients and the WAN weak forms
// drop it, S = d + 1, with the same roundings in the streams they keep.
//
// What it computes is the TPU kernels' dot_dtype='bfloat16' (and
// _forward_kernel2's single-pass 'default' dots): every product operand
// rounded to bf16 (nearest even), fp32 accumulation.  The products run on
// the H100's bf16 tensor cores (mma.sync, fp32 accumulators), each half
// k-step of 8 into a zero accumulator and summed in fp32 (mma_bf16).  Not rounded (fp32, as the TPU
// kernels keep them): the layer-0 Jacobian seed rows, q = sum J^2, the
// activation packs and the reverse nonlinearity, the last-layer projection
// and dW_last, the db sums and the Jacobian-row sums added to dW0.  The
// products of the input layer (K = d) and its dW0 run on the CUDA cores
// with their operands rounded (rd_bf16).
//
// Bound on the H100: the same FLOP as the fp32 kernels at 989 TFLOP/s
// (bf16 dense), ~15x below the CUDA-core bound; with the products that
// cheap, a tile's pace is set by its elementwise stages (a sincos pack per
// unit and stream pass), its barriers and the saved stages' traffic.
//
// Layout.  A block owns a tile of T points (T = 8 or a multiple of 16).  A
// stage lives in shared memory as bf16 only: row r = s*T + p (stream s,
// point p), columns the units, row stride ldb = kp16(widest) + 8 (an odd
// number of 16-byte chunks: ldmatrix rows fall in distinct banks).  Streams
// are padded to Sp so that Sp*T is a multiple of 16 (T = 8 with S odd adds
// one zero stream).  The products:
//   * forward  Z = A W: A rows from the stage by ldmatrix, W (in, out) by
//     ldmatrix.trans for the .col B fragment;
//   * backward dA = D W^T: the same bf16 bytes of W by plain ldmatrix;
//   * dW = M^T D with K = the tile's stream rows: both operands by
//     ldmatrix.trans from the stages.
// One bf16 copy of each hidden W_k (rounded once where it is staged, zero
// padded to kp16 x kp16) serves both directions: no transposed copy.
//
// Stream-major fragments.  A warp owns blocks of (16 points x 8 units) (T =
// 8: 8 points) and loops over every stream's m16 tile: each thread then
// holds, in its own accumulators, the same (point, unit) entries of every
// stream (rows g and g+8, columns 2t and 2t+1), so the activation (forward)
// and the reverse nonlinearity run in the epilogue from registers, one
// stream at a time in stream order, with no shuffle and no S limit (d = 16
// has S = 18).  The pre-activations every stage saves for the reverse sweep
// go to device memory in that fragment order (a float4 per lane per stream
// tile, plus one for q = sum J^2): the thread that reads them back in the
// reverse sweep is the one that wrote them.  The projection, dW_last, the
// db sums and the Jacobian-row sums of dW0 are folded into the epilogues as
// column sums (shuffle sums over the thread's lanes, then a fixed-order sum
// over the warps).
//
// The plan (kernels/fused_step.py::mma_plan, by kind) chooses the tile, the
// blocks per SM and the residency at run time (RES_WEIGHTS: every hidden
// W_k bf16 for the block's life; RES_GRAD, the fused kernels and the jet
// backward: the block's gradient row, whose hidden dW then accumulates in
// fragment order, dw_product); chip_smoke.py mma_sweep measures each.
//
// Wide nets.  A 256-wide W_k is 135 KB in bf16, and three stages of 18
// streams at T = 8 are 228 KB: beside the stages of a wide net there may be
// no room for a weight matrix, and at large d none for the column sums.  So
// two tiers more: DEV_WEIGHTS builds each B fragment from the fp32 W_k in
// device memory (through the caches), rounded to bf16 as stage_w rounds,
// with no copy on chip; DEV_SUMS keeps the projection partials and the
// column sums in the block's slice of device scratch after its saved
// stages.  Both give the same bits as the tiers on chip (the same
// roundings, the same sums in the same order).  Two variants of every
// kernel (body's WIDE, design bit DES_WIDE): the narrow one holds a warp
// block's B fragments of every k-step (KS_REG, widths to 128) in registers
// across its stream tiles, read once from shared memory; the wide one
// (widths above 128, DEV_WEIGHTS or DEV_SUMS) runs the k-steps in a rolled
// loop and fetches each B fragment at its k-step, once for a chunk of
// UC_FWD stream tiles in the forward products (keeping the chunk's
// accumulators) and once per tile in the reverse sweep's, so that neither
// variant's registers grow with the width (holding 16 k-steps spilled
// 0.5-1 KB per thread, PERF.md).  Only the wide variant may keep its sums
// in device memory: the narrow one's stay shared-memory accesses.  The body
// sets no cap of its own on the width, the depth or d: its per-thread state
// holds no stream count and every loop over units steps by warp blocks or
// by NT.  What a kernel takes is its launcher's make_net: the fused kernels
// and the jet pair (rows 1-5) the nets beyond the other kernels' limits
// (fwdlap_core.cuh's MAX_*; the jet forward d to CORE_DIM), the quotients'
// and the K-bump pair's passes CORE_LAYERS, CORE_DIM and widths to NT.
// Above width 256 the gradient row fits no tier on chip: each tile adds its
// dW to the block's row of `partial` in device memory (a read-modify-write
// of the whole row per tile), which reduce_rows then sums in order.
// Built, measured and taken out (PERF.md): the A operands read as fp32 and
// converted in the fragment (cvt.rn.bf16x2.f32) instead of ldmatrix of the
// bf16 stages, dW fragments in registers across the block's tiles, two
// MMA chains interleaved per warp, a three-blocks-per-SM register budget
// for the kernels with a reverse sweep.
//
// Accuracy.  The bf16 rounding makes the result depend on the fp32 order of
// the sums before each rounding: an operand within an fp32 error of a bf16
// rounding boundary goes to the other neighbour.  On deep, wide nets these
// flips add up: on (16, 128 x 15, 1) the plain version and the same plain
// version on the net with its hidden units permuted (the same roundings,
// every sum in another order) are 4e-5 to 5e-4 apart in dW0, and the
// float64 witness is 1e-4 to 2e-4 from either, as far as this design is
// (chip_smoke.py mma_depth; PERF.md).  The tensor cores' sum of a half
// k-step is the exact sum cut toward zero, not rounded (mma_bf16,
// f32_products): a stage's entries lean toward zero and so do their flips.
// Where that showed beyond the plain version's own distance from float64
// (the jet forward's value column), the products before the last run on the
// CUDA cores in fp32 (f32_products).
//
// Determinism: every dW/db entry and column sum is owned by one thread (or a
// fixed shuffle tree) and summed in tile order; no atomics.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "fwdlap_planned.cuh"

namespace fwdlap {

// The tensor-core design (a bit beside Design).
enum MmaDesign { DES_MMA = 4 };

namespace mma {

// What a kernel of the design computes (body<KIND>).
enum Kind {
  KIND_FUSED = 0,   // loss + gradients: the cotangents from the loss terms
  KIND_BWD = 1,     // the jet backward: the cotangents loaded, gradients
  KIND_FWD = 2,     // the jet forward: the (N, d+2) jet rows, nothing saved
  KIND_SUMS = 3     // pass A: the policy's per-point terms summed, nothing saved
};

// The kinds with a reverse sweep (the stages saved, the gradient row).
__host__ __device__ inline bool has_rev(int kind) {
  return kind == KIND_FUSED || kind == KIND_BWD;
}

// Per-point double lanes of KIND_SUMS: a row of `row` sums keeps at least
// four (the quotients' layout: the linear quotient's four sums, the
// quadratic one's two in the same room); the K-bump pass A has 3K, to 126.
constexpr int SUM_LANES = 4;
__host__ __device__ inline int sum_lanes(int row) { return row > SUM_LANES ? row : SUM_LANES; }
// The lanes a kernel's args ask for: SUM_LANES, a constant, unless the args'
// own namespace declares lanes_of for their type (found by argument-
// dependent lookup where body is instantiated): the K-bump pass A's returns
// sum_lanes(A.row).  A constant keeps the quotients' pass-A code: lanes read
// from their A.row move five of their kernels' registers (PERF.md).
template <class Args>
__host__ __device__ constexpr int lanes_of(const Args&) {
  return SUM_LANES;
}

constexpr int NW = NT / 32;                  // warps per block
constexpr int KS_REG = 8;                    // k-steps whose B fragments the
                                             // narrow variant holds in registers

// The design bit of the wide variant (beside DES_MMA).
enum MmaVariant { DES_WIDE = 16 };

__host__ __device__ inline int kp16(int w) { return (w + 15) & ~15; }
__host__ __device__ inline int np8(int w) { return (w + 7) & ~7; }
__host__ __device__ inline int rnd4(int n) { return (n + 3) & ~3; }

// The tile's geometry.
struct Geo {
  int T, S, Sp;     // points, streams, streams padded (Sp*T % 16 == 0)
  int NU;           // m16 tiles of a warp block (one per stream; T = 8: two streams each)
  int NPB;          // 16-point blocks of the tile (T = 8: one of 8 points)
  int t8;           // T == 8
  int ST;           // stage rows, Sp*T
  int ldb;          // bf16 stage row stride (elements)
  int wq;           // widest hidden layer, rounded up to 8 (red2's row)
  int nbmax;        // n-blocks of the widest layer
  int nblk;         // warp blocks of the widest stage, NPB * nbmax
};

// The geometry of a tile of T points on a net with the Laplacian stream;
// false for a tile the design does not take (the nets it takes are
// make_net's, in each launcher).
__host__ __device__ inline bool make_geo(const Net& net, int T, Geo* g) {
  if (!net.lap || !(T == 8 || (T >= 16 && T % 16 == 0 && T <= NT / 2))) return false;
  int wt = 0;
  for (int k = 1; k < net.K; ++k) wt = net.w[k] > wt ? net.w[k] : wt;
  g->T = T;
  g->S = net.S;
  g->t8 = T == 8;
  g->Sp = g->t8 ? (net.S + 1) & ~1 : net.S;
  g->NU = g->t8 ? g->Sp / 2 : net.S;
  g->NPB = g->t8 ? 1 : T / 16;
  g->ST = g->Sp * T;
  g->ldb = kp16(wt) + 8;
  g->wq = np8(wt);
  g->nbmax = g->wq / 8;
  g->nblk = g->NPB * g->nbmax;
  return true;
}

// The geometry of a kind that carries the Laplacian stream or not (lap; the
// net's own must agree): make_geo past its check of the stream.  Here and in
// layout, red2_floats and scratch_floats, the kinds with the Laplacian
// stream and no pass A (the fused residual kernels and the jet pair) keep
// their own functions word for word, and the kinds without the stream or
// with pass A take the general overloads: folded into one, the former's
// kernels moved by 1-3 registers and the jet forward's wide variant spilled
// (tools/compare_ptxas.py; PERF.md).
//
// make_geo's body without its check of the Laplacian stream, written out
// rather than called on a copy of the Net with lap set: such a copy is a
// local array of the whole layer table in every kernel of these kinds.
__host__ __device__ inline bool make_geo(const Net& net, int T, Geo* g, bool lap) {
  if (lap != (net.lap != 0)) return false;
  if (!(T == 8 || (T >= 16 && T % 16 == 0 && T <= NT / 2))) return false;
  int wt = 0;
  for (int k = 1; k < net.K; ++k) wt = net.w[k] > wt ? net.w[k] : wt;
  g->T = T;
  g->S = net.S;
  g->t8 = T == 8;
  g->Sp = g->t8 ? (net.S + 1) & ~1 : net.S;
  g->NU = g->t8 ? g->Sp / 2 : net.S;
  g->NPB = g->t8 ? 1 : T / 16;
  g->ST = g->Sp * T;
  g->ldb = kp16(wt) + 8;
  g->wq = np8(wt);
  g->nbmax = g->wq / 8;
  g->nblk = g->NPB * g->nbmax;
  return true;
}

// W_k (k = 1..K-2) in shared memory: kp16(w_k) rows of ldw(k) bf16.
__host__ __device__ inline int ldw_of(const Net& net, int k) { return kp16(net.w[k + 1]) + 8; }
__host__ __device__ inline int wbytes(const Net& net, int k) {
  return kp16(net.w[k]) * ldw_of(net, k) * 2;
}
__host__ __device__ inline int woff_bytes(const Net& net, int k) {
  int o = 0;
  for (int m = 1; m < k; ++m) o += wbytes(net, m);
  return o;
}

// The floats of a block's gradient row: the parameters, and in the fused
// kernels the loss sums (3); none in the kinds without a reverse sweep.
__host__ __device__ inline int row_floats(const Net& net, int kind) {
  return kind == KIND_FUSED ? net.P + 3 : kind == KIND_BWD ? net.P : 0;
}

// Whether a launch needs the wide variant (DES_WIDE): a hidden width above
// the narrow variant's KS_REG k-steps, or the weights or the sums in device
// memory.
__host__ __device__ inline bool needs_wide(const Net& net, int flags) {
  int wt = 0;
  for (int k = 1; k < net.K; ++k) wt = net.w[k] > wt ? net.w[k] : wt;
  return wt > KS_REG * 16 || (flags & (DEV_WEIGHTS | DEV_SUMS)) != 0;
}

// The tiers' flags a kind takes: no weights both resident and in device
// memory; the kinds without a reverse sweep keep no gradient row and no
// sums off chip.
__host__ __device__ inline bool flags_ok(int flags, int kind) {
  const int any = !has_rev(kind) ? RES_WEIGHTS | DEV_WEIGHTS
                                 : RES_WEIGHTS | RES_GRAD | DEV_WEIGHTS | DEV_SUMS;
  return (flags & ~any) == 0 && !((flags & RES_WEIGHTS) && (flags & DEV_WEIGHTS));
}

// Floats of the projection partials (not in the jet backward) and of the
// column sums (the kinds with a reverse sweep).
__host__ __device__ inline int red_floats(const Geo& g, int kind) {
  return kind != KIND_BWD ? rnd4(g.nbmax * g.ST) : 0;
}
__host__ __device__ inline int red2_floats(const Geo& g, int kind) {
  return kind != KIND_FWD ? rnd4(g.NPB * g.S * g.wq) : 0;
}
// The column-sum slots and cotangent rows of a 16-point block, d + 2: S
// with the Laplacian stream (the last slot dW_last's), one more without, so
// that dW_last's slot never meets a Jacobian row's.
__host__ __device__ inline int slots_of(const Geo& g, bool lap) { return lap ? g.S : g.S + 1; }
// red2_floats of any kind (KIND_SUMS keeps no column sums), with or without
// the Laplacian stream.
__host__ __device__ inline int red2_floats(const Geo& g, int kind, bool lap) {
  return has_rev(kind) ? rnd4(g.NPB * slots_of(g, lap) * g.wq) : 0;
}

// Byte offsets of a block's shared memory (every region 16-byte aligned;
// a region the kind or the tier does not keep there is empty).  Mirrored by
// kernels/fused_step.py::mma_smem_bytes.
struct Layout {
  int bufs, w, gacc, red, red2, xs, ct, ps, proj, total;
};

__host__ __device__ inline Layout layout(const Net& net, const Geo& g, int flags,
                                         int kind = KIND_FUSED) {
  const bool rev = kind != KIND_FWD, proj = kind != KIND_BWD;
  const bool on_chip = !(flags & DEV_SUMS);
  Layout L;
  int o = 0;
  L.bufs = o;
  o += (rev ? 3 : 2) * g.ST * g.ldb * 2;               // bf16 stages
  L.w = o;
  int wb = 0;
  for (int k = 1; k < net.K - 1 && !(flags & DEV_WEIGHTS); ++k) {
    const int b = wbytes(net, k);
    wb = (flags & RES_WEIGHTS) ? wb + b : (b > wb ? b : wb);
  }
  o += wb;
  L.gacc = o;
  if (rev && (flags & RES_GRAD)) o += 4 * rnd4(row_floats(net, kind));
  L.red = o;                                           // projection partials
  if (on_chip) o += 4 * red_floats(g, kind);
  L.red2 = o;                                          // column sums
  if (on_chip) o += 4 * red2_floats(g, kind);
  L.xs = o;
  o += 4 * rnd4(g.T * net.d);
  L.ct = o;
  if (rev) o += 4 * rnd4(g.S * g.T);
  L.ps = o;
  if (kind == KIND_FUSED) o += 4 * rnd4(3 * g.T);
  L.proj = o;
  if (proj) o += 4 * rnd4(g.ST);
  L.total = o;
  return L;
}

// The layout of any kind, with or without the Laplacian stream (the kinds
// this design added use it; its regions as layout's, the cotangents and the
// column sums over slots_of rows, KIND_SUMS its `lanes` doubles a point in
// ps, sum_lanes of its row).  Mirrored by kernels/fused_step.py::mma_smem_bytes.
__host__ __device__ inline Layout layout(const Net& net, const Geo& g, int flags, int kind,
                                         bool lap, int lanes = SUM_LANES) {
  const bool rev = has_rev(kind), proj = kind != KIND_BWD;
  const bool on_chip = !(flags & DEV_SUMS);
  Layout L;
  int o = 0;
  L.bufs = o;
  o += (rev ? 3 : 2) * g.ST * g.ldb * 2;               // bf16 stages
  L.w = o;
  int wb = 0;
  for (int k = 1; k < net.K - 1 && !(flags & DEV_WEIGHTS); ++k) {
    const int b = wbytes(net, k);
    wb = (flags & RES_WEIGHTS) ? wb + b : (b > wb ? b : wb);
  }
  o += wb;
  L.gacc = o;
  if (rev && (flags & RES_GRAD)) o += 4 * rnd4(row_floats(net, kind));
  L.red = o;                                           // projection partials
  if (on_chip) o += 4 * red_floats(g, kind);
  L.red2 = o;                                          // column sums
  if (on_chip) o += 4 * red2_floats(g, kind, lap);
  L.xs = o;
  o += 4 * rnd4(g.T * net.d);
  L.ct = o;
  if (rev) o += 4 * rnd4(slots_of(g, lap) * g.T);
  L.ps = o;                                            // the tile's sum terms
  if (kind == KIND_FUSED) o += 4 * rnd4(3 * g.T);
  if (kind == KIND_SUMS) o += 8 * lanes * g.T;         // doubles, kept across tiles
  L.proj = o;
  if (proj) o += 4 * rnd4(g.ST);
  L.total = o;
  return L;
}

// Saved-stage floats of one block in device memory: K-1 stages of nblk warp
// blocks, each NU stream tiles and the q tile of 32 float4s (none in the
// jet forward, which saves nothing).
__host__ __device__ inline long saved_floats(const Net& net, const Geo& g, int kind) {
  return kind == KIND_FWD ? 0 : (long)(net.K - 1) * g.nblk * (g.NU + 1) * 128;
}

// Floats of one block's slice of device scratch: the saved stages, then
// (DEV_SUMS) the projection partials and the column sums.
__host__ __device__ inline long scratch_floats(const Net& net, const Geo& g,
                                               int kind = KIND_FUSED, int flags = 0) {
  return saved_floats(net, g, kind) +
         ((flags & DEV_SUMS) ? red_floats(g, kind) + red2_floats(g, kind) : 0);
}

// The same for any kind, with or without the Laplacian stream: nothing saved
// without a reverse sweep (without the Laplacian the q tile is not written).
__host__ __device__ inline long scratch_floats(const Net& net, const Geo& g, int kind, int flags,
                                               bool lap) {
  const long saved = has_rev(kind) ? (long)(net.K - 1) * g.nblk * (g.NU + 1) * 128 : 0;
  return saved + ((flags & DEV_SUMS) ? red_floats(g, kind) + red2_floats(g, kind, lap) : 0);
}

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
// c += a b over one k-step of 16, bf16 operands, fp32 accumulators: the
// k-step as its two m16n8k8 halves (a[0..1] b[0], a[2..3] b[1]), each into
// a zero accumulator, then added to c in fp32 (round to nearest).  The
// tensor cores add a product into a running accumulator with its low bits
// cut, not rounded (see Accuracy above).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(t0), "+f"(t1), "+f"(t2), "+f"(t3)
        : "r"(a[2 * h]), "r"(a[2 * h + 1]), "r"(b[h]));
    c[0] += t0;
    c[1] += t1;
    c[2] += t2;
    c[3] += t3;
  }
}
// x rounded to the nearest bf16 value (ties to even), kept as a float: an
// operand of the products on the CUDA cores (the input layer, dW0)
__device__ __forceinline__ float rd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// (lo, hi) rounded to bf16 (nearest even) in one 32-bit word, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The sum over the 8 lanes that share lane % 4 (rows g of a fragment), a
// fixed xor tree.
__device__ __forceinline__ float sum_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ int stream_of(const Geo& g, int u, int h) {
  return g.t8 ? 2 * u + h : u;
}
__device__ __forceinline__ int tile_row(const Geo& g, int pb, int u) {
  return g.t8 ? 16 * u : u * g.T + pb * 16;
}

// The A fragment of rows rb..rb+15, columns k0..k0+15 of the bf16 stage B.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* B, const Geo& g,
                                       int rb, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, B + (rb + (lane & 7) + ((lane >> 3) & 1) * 8) * g.ldb + k0 + (lane >> 4) * 8);
}

// Stage the (wi, wo) fp32 matrix W of device memory as bf16 (rounded to
// nearest even) in dst, kp16(wi) rows of ldw, zero past (wi, wo) up to
// kp16 x kp16.  No barrier of its own.
__device__ __forceinline__ void stage_w(const float* __restrict__ W, int wi, int wo,
                                        __nv_bfloat16* dst, int ldw) {
  const int half = kp16(wo) >> 1, pairs = kp16(wi) * half;
  for (int f = threadIdx.x; f < pairs; f += NT) {
    const int i = f / half, j = 2 * (f - i * half);
    const bool row = i < wi;
    const float a = row && j < wo ? W[i * wo + j] : 0.f;
    const float b = row && j + 1 < wo ? W[i * wo + j + 1] : 0.f;
    *reinterpret_cast<uint32_t*>(dst + i * ldw + j) = pack_bf16(a, b);
  }
}

// Where a product reads W_k (wi x wo): the bf16 copy in shared memory
// (sm, rows of ldw), or (dev, DEV_WEIGHTS) the fp32 W_k in device memory.
struct WSrc {
  const __nv_bfloat16* sm;
  int ldw;
  const float* dev;
  int wi, wo;
};

// W_k[i][j] of the device copy, zero past (wi, wo) as the staged copy is.
__device__ __forceinline__ float w_at(const WSrc& w, int i, int j) {
  return i < w.wi && j < w.wo ? __ldg(w.dev + i * w.wo + j) : 0.f;
}

// The .col B fragment of k-step ks and n-block n0 of the forward product
// A W_k: rows k (in) ks*16 + 2t, +1 and +8, +9, column n0 + g (out).
__device__ __forceinline__ void frag_fwd(uint32_t (&b)[2], const WSrc& w, int ks, int n0) {
  const int lane = threadIdx.x & 31;
  if (w.dev) {
    const int n = n0 + (lane >> 2), k = ks * 16 + 2 * (lane & 3);
    b[0] = pack_bf16(w_at(w, k, n), w_at(w, k + 1, n));
    b[1] = pack_bf16(w_at(w, k + 8, n), w_at(w, k + 9, n));
  } else {
    ldsm_x2_t(b, w.sm + (ks * 16 + (lane & 15)) * w.ldw + n0);
  }
}

// The same for the backward product D W_k^T: k over W_k's columns (out),
// n over its rows (in).
__device__ __forceinline__ void frag_bwd(uint32_t (&b)[2], const WSrc& w, int ks, int n0) {
  const int lane = threadIdx.x & 31;
  if (w.dev) {
    const int n = n0 + (lane >> 2), k = ks * 16 + 2 * (lane & 3);
    b[0] = pack_bf16(w_at(w, n, k), w_at(w, n, k + 1));
    b[1] = pack_bf16(w_at(w, n, k + 8), w_at(w, n, k + 9));
  } else {
    ldsm_x2(b, w.sm + (n0 + (lane & 7)) * w.ldw + ks * 16 + ((lane >> 3) & 1) * 8);
  }
}

// c += the rows rb.. of the bf16 stage B times W_k over nks k-steps, the
// narrow variant's B fragments from bf (held, every k-step).
__device__ __forceinline__ void product(float (&c)[4], const __nv_bfloat16* B, const Geo& g,
                                        int rb, const uint32_t (&bf)[KS_REG][2], int nks) {
#pragma unroll
  for (int ks = 0; ks < KS_REG; ++ks) {
    if (ks < nks) {
      uint32_t a[4];
      load_a(a, B, g, rb, ks * 16);
      mma_bf16(c, a, bf[ks]);
    }
  }
}

// The wide variant's products: the forward's stream tiles share each B
// fragment in chunks of UC_FWD (of a warp block's NU; d = 2 has 4), so a
// fragment fetched at its k-step serves a chunk of products (on u200 the
// jet forward in chunks of 2 took 1.27x the time of 4).  The reverse sweep
// takes one tile at a time: its state (BwdSt) leaves no room for a chunk's
// accumulators at the two-block budget (chunks of 4 spilled 0.1 KB per
// thread, of 2 64 B; PERF.md).
constexpr int UC_FWD = 4;

// c[i] = the rows of stream tile u0 + i (i < nu) of the bf16 stage B times
// W_k over nks k-steps, each B fragment fetched once for the chunk (FWD:
// the forward product, frag_fwd; else the backward one, frag_bwd).  Each
// c[i] sums its k-steps in order, as the narrow variant's c does.
template <bool FWD, int U>
__device__ __forceinline__ void wide_products(float (&c)[U][4], const __nv_bfloat16* B,
                                              const Geo& g, int pb, int u0, int nu, int nks,
                                              const WSrc& w, int n0) {
#pragma unroll
  for (int i = 0; i < U; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t b[2];
    if (FWD)
      frag_fwd(b, w, ks, n0);
    else
      frag_bwd(b, w, ks, n0);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (i < nu) {
        uint32_t a[4];
        load_a(a, B, g, tile_row(g, pb, u0 + i), ks * 16);
        mma_bf16(c[i], a, b);
      }
    }
  }
}

// out = c[i] for a rolled loop over the chunk (selects: c stays in registers).
template <int U>
__device__ __forceinline__ void pick(float (&out)[4], const float (&c)[U][4], int i) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    if (j == i) {
      out[0] = c[j][0];
      out[1] = c[j][1];
      out[2] = c[j][2];
      out[3] = c[j][3];
    }
  }
}

// The narrow variant's held B fragments of a warp block (n-block n0): every
// k-step, from the bf16 W_k in shared memory.
template <bool FWD>
__device__ __forceinline__ void hold_frags(uint32_t (&bf)[KS_REG][2], const WSrc& w, int nks,
                                           int n0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < KS_REG; ++ks) {
    if (ks < nks) {
      if (FWD)
        ldsm_x2_t(bf[ks], w.sm + (ks * 16 + (lane & 15)) * w.ldw + n0);
      else
        ldsm_x2(bf[ks], w.sm + (n0 + (lane & 7)) * w.ldw + ks * 16 + ((lane >> 3) & 1) * 8);
    }
  }
}

// ------------------------------------------------------------ forward
// A thread's state over the streams of its points: [h][e] = (point of row
// half h, unit 2t + e).  T = 8: both halves are the one point, the pack is
// copied to both slots and q is split by half.
struct FwdSt {
  float s1[2][2], s2[2][2], q[2][2];
};

// One stream tile u of a warp block (pb, nb): c holds the pre-activations
// (bias not yet added); applies the activation (stage_mid's arithmetic),
// writes the mid streams to the next stage `ob` and (SAVE) the
// pre-activations to the saved frags; at the last stage, instead of the mid
// streams, (PROJ) the projection partials (8 units) to red, or nothing.
// LAP: the last stream is the Laplacian's (q = sum J^2 accumulated for it).
template <bool SAVE, bool PROJ, bool LAP>
__device__ __forceinline__ void fwd_epi(const Net& net, const Geo& g, int pb, int nb, int u,
                                        float (&c)[4], const float (&bv)[2], FwdSt& st,
                                        __nv_bfloat16* ob, float4* save, bool last,
                                        const float (&wl)[2], float* red) {
  const int lane = threadIdx.x & 31, j0 = nb * 8 + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = stream_of(g, u, h);
    if (s >= g.S) continue;                 // the zero stream of T = 8
    float m[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = c[2 * h + e];
      if (s == 0) {
        v += bv[e];
        c[2 * h + e] = v;
        const Pack pk = act_pack(net.act, v);
        m[e] = pk.s0;
        st.s1[h][e] = pk.s1;
        st.s2[h][e] = pk.s2;
        st.q[h][e] = 0.f;
        if (g.t8) {
          st.s1[1][e] = pk.s1;
          st.s2[1][e] = pk.s2;
          st.q[1][e] = 0.f;
        }
      } else if (LAP && s == g.S - 1) {
        const float q = g.t8 ? st.q[0][e] + st.q[1][e] : st.q[h][e];
        m[e] = st.s1[h][e] * v + st.s2[h][e] * q;
      } else {
        if constexpr (LAP) st.q[h][e] = fmaf(v, v, st.q[h][e]);
        m[e] = st.s1[h][e] * v;
      }
    }
    const int r = tile_row(g, pb, u) + (lane >> 2) + 8 * h;
    if (!last) {
      *reinterpret_cast<uint32_t*>(ob + r * g.ldb + j0) = pack_bf16(m[0], m[1]);
    } else if (PROJ) {
      float part = fmaf(m[0], wl[0], m[1] * wl[1]);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if ((lane & 3) == 0) red[nb * g.ST + r] = part;
    }
  }
  if (SAVE) save[u * 32] = make_float4(c[0], c[1], c[2], c[3]);
}

__device__ __forceinline__ void save_q(const Geo& g, const FwdSt& st, float4* save) {
  float q[4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) q[2 * h + e] = g.t8 ? st.q[0][e] + st.q[1][e] : st.q[h][e];
  save[g.NU * 32] = make_float4(q[0], q[1], q[2], q[3]);
}

// The bias and, at the last stage, the last layer's row at the thread's two
// units (zero past the layer's width).
__device__ __forceinline__ void unit_consts(int n0, int w, const float* bias, bool last,
                                            const float* wlast, float (&bv)[2],
                                            float (&wl)[2]) {
  const int j = n0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    bv[e] = j + e < w ? bias[j + e] : 0.f;
    wl[e] = last && j + e < w ? wlast[j + e] : 0.f;
  }
}

// Stage 1 from the input layer on the CUDA cores (K = d): v = x W0 + b0 with
// x and W0 rounded, J_i = W0[i, :] in fp32, l = 0; then fwd_epi.  save_st:
// stage 1's saved frags (the thread's lane included; unused unless SAVE).
template <bool SAVE, bool PROJ, bool LAP>
__device__ void fwd_input(const Net& net, const Geo& g, const float* __restrict__ xs,
                          const float* __restrict__ W0, __nv_bfloat16* ob, float4* save_st,
                          bool last, const float* __restrict__ wlast, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = net.d, w1 = net.w[1], NB = np8(w1) / 8;
  const float* b0 = W0 + d * w1;
  for (int b = warp; b < g.NPB * NB; b += NW) {
    const int pb = b / NB, nb = b - pb * NB;
    float bv[2], wl[2];
    unit_consts(nb * 8, w1, b0, PROJ && last, wlast, bv, wl);
    FwdSt st = {};
    float4* save = SAVE ? save_st + (size_t)b * (g.NU + 1) * 32 : nullptr;
    for (int u = 0; u < g.NU; ++u) {
      float c[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = stream_of(g, u, h);
        const int p = g.t8 ? (lane >> 2) : pb * 16 + (lane >> 2) + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nb * 8 + 2 * (lane & 3) + e;
          const bool real = j < w1;
          float v = 0.f;
          if (s == 0) {
            for (int i = 0; i < d; ++i)
              v = fmaf(rd_bf16(xs[p * d + i]), rd_bf16(real ? W0[i * w1 + j] : 0.f), v);
          } else if (s <= d) {
            v = real ? W0[(s - 1) * w1 + j] : 0.f;   // the Jacobian seed rows stay fp32
          }
          c[2 * h + e] = v;
        }
      }
      fwd_epi<SAVE, PROJ, LAP>(net, g, pb, nb, u, c, bv, st, ob, save, last, wl, red);
    }
    if constexpr (LAP) {
      if (SAVE) save_q(g, st, save);
    }
  }
}

// The jet forward's products before its last, on the CUDA cores: c[i] =
// the rows of stream tile u0 + i (i < nu) of the bf16 stage B times W_k
// over nks k-steps, every entry an fp32 FMA chain in k order (each product
// of two bf16 values exact, each addition rounded to nearest), in the
// fragment layout of mma_bf16's accumulator (rows g, g + 8 of the tile at
// columns n0 + 2t, 2t + 1).  The tensor cores' sum of a half k-step is the
// exact sum cut toward zero (tools/fwd_bf16_columns.py --probe: 99.9% of
// such sums on activation-like operands, up to 2048 ulps of the result
// where the products cancel), so their stage entries sit a little nearer
// zero than the plain version's rounded sums; the bf16 rounding of the next
// stage turns that into flips toward zero, and the jet's value column
// carried them: 7.7x its plain version's distance from float64 on (1, 100
// x 3, 1) tanh, the plain version's with these products on the CUDA cores
// (the last product's accumulation, unrounded into the fp32 projection,
// moved nothing; PERF.md).  The weights of a k-step come as the tensor
// cores' B fragment (frag_fwd: shared or device memory, rounded as there)
// and go to the lanes that need them by shuffles, once for the chunk of
// stream tiles; the stage rows are read 8 bf16 at a time.
template <int U>
__device__ __forceinline__ void f32_products(float (&c)[U][4], const __nv_bfloat16* B,
                                             const Geo& g, int pb, int u0, int nu, int nks,
                                             const WSrc& w, int n0) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < U; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t bf[2];
    frag_fwd(bf, w, ks, n0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // W[k][n0 + 2t] and W[k][n0 + 2t + 1] for k = 16 ks + 8 h + 0..7: the
      // lanes 4 c + t' hold column n0 + c at k = 2t', 2t' + 1
      float w0[8], w1[8];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const uint32_t q0 = __shfl_sync(0xffffffffu, bf[h], 8 * t + tt);
        const uint32_t q1 = __shfl_sync(0xffffffffu, bf[h], 8 * t + 4 + tt);
        w0[2 * tt] = __uint_as_float(q0 << 16);
        w0[2 * tt + 1] = __uint_as_float(q0 & 0xFFFF0000u);
        w1[2 * tt] = __uint_as_float(q1 << 16);
        w1[2 * tt + 1] = __uint_as_float(q1 & 0xFFFF0000u);
      }
#pragma unroll
      for (int i = 0; i < U; ++i) {
        if (i < nu) {
          const __nv_bfloat16* r0 =
              B + (tile_row(g, pb, u0 + i) + gr) * g.ldb + ks * 16 + 8 * h;
          const uint4 x0 = *reinterpret_cast<const uint4*>(r0);
          const uint4 x1 = *reinterpret_cast<const uint4*>(r0 + 8 * g.ldb);
          const uint32_t a0[4] = {x0.x, x0.y, x0.z, x0.w}, a1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const uint32_t h0 = a0[kk >> 1], h1 = a1[kk >> 1];
            const float v0 = __uint_as_float(kk & 1 ? h0 & 0xFFFF0000u : h0 << 16);
            const float v1 = __uint_as_float(kk & 1 ? h1 & 0xFFFF0000u : h1 << 16);
            c[i][0] = fmaf(v0, w0[kk], c[i][0]);
            c[i][1] = fmaf(v0, w1[kk], c[i][1]);
            c[i][2] = fmaf(v1, w0[kk], c[i][2]);
            c[i][3] = fmaf(v1, w1[kk], c[i][3]);
          }
        }
      }
    }
  }
}

// Stage k+1 from stage k (k >= 1): Z = A W_k on the tensor cores, A the bf16
// stage `ib`, W_k from `w` (product), then fwd_epi.  The narrow variant's
// warp block loads its B fragments once; the wide one's products run in
// chunks of UC_FWD stream tiles.  INNER_F32 (the jet forward): every product
// but the last stage's on the CUDA cores (f32_products), in chunks of
// UC_FWD stream tiles in either variant.
template <bool SAVE, bool PROJ, bool WIDE, bool LAP, bool INNER_F32 = false>
__device__ void fwd_product(const Net& net, const Geo& g, int k, const __nv_bfloat16* ib,
                            const WSrc& w, const float* __restrict__ bias,
                            __nv_bfloat16* ob, float4* save_st, bool last,
                            const float* __restrict__ wlast, float* red) {
  const int warp = threadIdx.x >> 5;
  const int wn = net.w[k + 1], NB = np8(wn) / 8, nks = kp16(net.w[k]) / 16;
  for (int b = warp; b < g.NPB * NB; b += NW) {
    const int pb = b / NB, nb = b - pb * NB, n0 = nb * 8;
    const bool f32 = INNER_F32 && !last;
    uint32_t bf[KS_REG][2];
    if constexpr (!WIDE) {
      if (!f32) hold_frags<true>(bf, w, nks, n0);
    }
    float bv[2], wl[2];
    unit_consts(n0, wn, bias, PROJ && last, wlast, bv, wl);
    FwdSt st = {};
    float4* save = SAVE ? save_st + (size_t)b * (g.NU + 1) * 32 : nullptr;
    if (WIDE || f32) {
      for (int u0 = 0; u0 < g.NU; u0 += UC_FWD) {
        const int nu = g.NU - u0 < UC_FWD ? g.NU - u0 : UC_FWD;
        float cc[UC_FWD][4];
        if (f32)
          f32_products(cc, ib, g, pb, u0, nu, nks, w, n0);
        else if constexpr (WIDE)
          wide_products<true>(cc, ib, g, pb, u0, nu, nks, w, n0);
#pragma unroll 1
        for (int i = 0; i < nu; ++i) {
          float c[4];
          pick(c, cc, i);
          fwd_epi<SAVE, PROJ, LAP>(net, g, pb, nb, u0 + i, c, bv, st, ob, save, last, wl,
                                   red);
        }
      }
    } else {
      for (int u = 0; u < g.NU; ++u) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        product(c, ib, g, tile_row(g, pb, u), bf, nks);
        fwd_epi<SAVE, PROJ, LAP>(net, g, pb, nb, u, c, bv, st, ob, save, last, wl, red);
      }
    }
    if constexpr (LAP) {
      if (SAVE) save_q(g, st, save);
    }
  }
}

// ------------------------------------------------------------ reverse
// slots_of with the kind's LAP.
template <bool LAP>
__device__ __forceinline__ int slots(const Geo& g) {
  return LAP ? g.S : g.S + 1;
}

// Column sums of a warp block: (v0, v1) of the thread's units summed over
// its 8 row lanes, written by lanes 0..3 to red2[pb][slot][n0 + 2t + e].
template <bool LAP>
__device__ __forceinline__ void put_colsum(const Geo& g, float* red2, int pb, int slot, int n0,
                                           float v0, float v1) {
  v0 = sum_g(v0);
  v1 = sum_g(v1);
  const int lane = threadIdx.x & 31;
  if (lane < 4)
    *reinterpret_cast<float2*>(red2 + (pb * slots<LAP>(g) + slot) * g.wq + n0 + 2 * lane) =
        make_float2(v0, v1);
}

// A thread's state in the reverse nonlinearity of a stage, [h][e] as in
// FwdSt (T = 8: both slots the one point, dq copied to both, the shares of
// dv split by half); aw: the last stage's dW_last partials at its two
// units.  dv = s1 dA + (s2 l + s3 q) dlm + sum_i s2 J_i dJ_i, its three
// shares kept apart (dva, dvl, dvj) and added in that order, the
// reference's (_nl_bwd): where they cancel, as a bottleneck layer's do
// under mixed-sign cotangents, another order moved dW0 by 1e-5 (PERF.md).
struct BwdSt {
  float s0[2][2], s1[2][2], s2[2][2], s3[2][2], q[2][2], dq[2][2];
  float dva[2][2], dvl[2][2], dvj[2][2];
  float aw[2];
};

// The cotangents of the mid streams of stream tile u: rank one at the last
// stage (ct * wlast), else D_{k+1} W_k^T on the tensor cores (the narrow
// variant from its held bf, the wide one by wide_products).
template <bool WIDE>
__device__ __forceinline__ void dmid(const Geo& g, bool rank1, int pb, int u,
                                     const float (&wl)[2], const float* __restrict__ ct,
                                     const __nv_bfloat16* Din, const uint32_t (&bf)[KS_REG][2],
                                     int nks, const WSrc& w, int n0, float (&c)[4]) {
  const int gr = (threadIdx.x & 31) >> 2;
  if (rank1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = stream_of(g, u, h);
      const float a = s < g.S ? ct[s * g.T + (g.t8 ? gr : pb * 16 + gr + 8 * h)] : 0.f;
      c[2 * h] = a * wl[0];
      c[2 * h + 1] = a * wl[1];
    }
    return;
  }
  if constexpr (WIDE) {
    float cc[1][4];
    wide_products<false>(cc, Din, g, pb, u, 1, nks, w, n0);
    c[0] = cc[0][0];
    c[1] = cc[0][1];
    c[2] = cc[0][2];
    c[3] = cc[0][3];
  } else {
    c[0] = c[1] = c[2] = c[3] = 0.f;
    product(c, Din, g, tile_row(g, pb, u), bf, nks);
  }
}

// Write the mid streams (M_k, when given) and the pre-activation cotangents
// (D_k) of row r at the thread's two units.
__device__ __forceinline__ void bwd_put(const Geo& g, int r, int j0, __nv_bfloat16* Mo,
                                        __nv_bfloat16* Do, float m0, float m1, float o0,
                                        float o1) {
  if (Mo) *reinterpret_cast<uint32_t*>(Mo + r * g.ldb + j0) = pack_bf16(m0, m1);
  *reinterpret_cast<uint32_t*>(Do + r * g.ldb + j0) = pack_bf16(o0, o1);
}

// The Laplacian halves of tile u (the last tile): dq = s'' dlm for every
// Jacobian stream, the lap stream's mid and cotangent, its share of dv.
// Nothing without the Laplacian stream (dq and its share stay zero).
template <bool LAP>
__device__ __forceinline__ void bwd_lap(const Geo& g, BwdSt& st, int pb, int u,
                                        const float (&c)[4], const float (&pr)[4], bool rank1,
                                        const float* __restrict__ ct, int j0,
                                        __nv_bfloat16* Mo, __nv_bfloat16* Do) {
  if constexpr (!LAP) return;
  const int gr = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (stream_of(g, u, h) != g.S - 1) continue;
    float m[2], o[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float l = pr[2 * h + e], dlm = c[2 * h + e];
      m[e] = st.s1[h][e] * l + st.s2[h][e] * st.q[h][e];
      o[e] = st.s1[h][e] * dlm;
      const float dqv = st.s2[h][e] * dlm;
      st.dvl[h][e] = (st.s2[h][e] * l + st.s3[h][e] * st.q[h][e]) * dlm;
      if (g.t8) {
        st.dq[0][e] = dqv;
        st.dq[1][e] = dqv;
      } else {
        st.dq[h][e] = dqv;
      }
      if (rank1) {
        const int p = g.t8 ? gr : pb * 16 + gr + 8 * h;
        st.aw[e] = fmaf(m[e], ct[(g.S - 1) * g.T + p], st.aw[e]);
      }
    }
    bwd_put(g, tile_row(g, pb, u) + gr + 8 * h, j0, Mo, Do, m[0], m[1], o[0], o[1]);
  }
}

// The value and Jacobian halves of tile u: the value stream's share of dv
// (its cotangent is written once every stream has added to it) and mid
// (s); each Jacobian stream's mid and cotangent and share of dv; at k = 1
// the Jacobian streams' column sums (dW0).
template <bool LAP>
__device__ __forceinline__ void bwd_rest(const Geo& g, BwdSt& st, int pb, int n0, int u,
                                         const float (&c)[4], const float (&pr)[4],
                                         bool rank1, bool jsum, const float* __restrict__ ct,
                                         int j0, __nv_bfloat16* Mo, __nv_bfloat16* Do,
                                         float* red2) {
  const int gr = (threadIdx.x & 31) >> 2;
  float od[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  bool isj[2] = {false, false};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = stream_of(g, u, h);
    const int p = g.t8 ? gr : pb * 16 + gr + 8 * h;
    const int r = tile_row(g, pb, u) + gr + 8 * h;
    if (s == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        st.dva[h][e] = st.s1[h][e] * c[2 * h + e];
        if (rank1) st.aw[e] = fmaf(st.s0[h][e], ct[p], st.aw[e]);
      }
      if (Mo)
        *reinterpret_cast<uint32_t*>(Mo + r * g.ldb + j0) =
            pack_bf16(st.s0[h][0], st.s0[h][1]);
    } else if (s < g.S - (LAP ? 1 : 0)) {
      float m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float J = pr[2 * h + e], dJm = c[2 * h + e];
        st.dvj[h][e] += st.s2[h][e] * J * dJm;
        m[e] = st.s1[h][e] * J;
        od[h][e] = st.s1[h][e] * dJm + 2.0f * J * st.dq[h][e];
        if (rank1) st.aw[e] = fmaf(m[e], ct[s * g.T + p], st.aw[e]);
      }
      bwd_put(g, r, j0, Mo, Do, m[0], m[1], od[h][0], od[h][1]);
      isj[h] = true;
    }
  }
  if (jsum) {                 // both halves one stream (T >= 16), or each its own
    if (!g.t8) {
      if (isj[0])
        put_colsum<LAP>(g, red2, pb, u, n0, od[0][0] + od[1][0], od[0][1] + od[1][1]);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (isj[h]) put_colsum<LAP>(g, red2, pb, 2 * u + h, n0, od[h][0], od[h][1]);
    }
  }
}

// The reverse nonlinearity of hidden stage k for every warp block (pb, nb)
// of its units (mm_act_bwd's arithmetic, _nl_bwd_pack).  dmid, the
// cotangent of the stage's mid streams: rank one at the last stage (k =
// K-1: ct * wlast, `rank1`), else D_{k+1} W_k^T on the tensor cores (A the
// bf16 stage `Din`, W_k from `w`, frag_bwd).  From the saved frags of the
// stage (`saved_st`) it writes the stage's mid streams (M_k, bf16; not at
// the last stage) and the cotangents of its pre-activations (D_k, bf16),
// and the column sums to red2: slot 0 sum_p dv (the db below), at k = 1
// slots 1..d sum_p dJ_i (dW0), at the last stage the last slot dW_last (sum
// over the mid streams x ct).  The lap tile comes first (dq = s'' dlm is
// needed by every J stream; without the Laplacian the last tile comes first
// all the same); the value stream's cotangent is written last, from the sum
// of all streams.
template <bool WIDE, bool LAP>
__device__ void bwd_stage(const Net& net, const Geo& g, int k, bool rank1,
                                 const __nv_bfloat16* Din, const WSrc& w,
                                 const float* __restrict__ ct, const float* __restrict__ wlast,
                                 const float4* saved_st, __nv_bfloat16* Mo,
                                 __nv_bfloat16* Do, float* red2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2;
  const int wk = net.w[k], NB = np8(wk) / 8, NU = g.NU;
  const int nks = rank1 ? 0 : kp16(net.w[k + 1]) / 16;
  const bool jsum = k == 1;
  for (int b = warp; b < g.NPB * NB; b += NW) {
    const int pb = b / NB, nb = b - pb * NB, n0 = nb * 8, j0 = n0 + 2 * (lane & 3);
    uint32_t bf[KS_REG][2];
    if constexpr (!WIDE) hold_frags<false>(bf, w, nks, n0);
    float wl[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) wl[e] = rank1 && j0 + e < wk ? wlast[j0 + e] : 0.f;
    const float4* sv = saved_st + (size_t)b * (NU + 1) * 32;
    BwdSt st;
    const float4 f0 = sv[0], fl = sv[(NU - 1) * 32], fq = sv[NU * 32];
    const float p0[4] = {f0.x, f0.y, f0.z, f0.w}, pl[4] = {fl.x, fl.y, fl.z, fl.w};
    {
      const float q4[4] = {fq.x, fq.y, fq.z, fq.w};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const Pack pk = act_pack(net.act, g.t8 ? p0[e] : p0[2 * h + e]);
          st.s0[h][e] = pk.s0;
          st.s1[h][e] = pk.s1;
          st.s2[h][e] = pk.s2;
          st.s3[h][e] = pk.s3;
          st.q[h][e] = q4[2 * h + e];
          st.dq[h][e] = 0.f;
          st.dva[h][e] = st.dvl[h][e] = st.dvj[h][e] = 0.f;
        }
      st.aw[0] = st.aw[1] = 0.f;
    }
    {  // the lap tile first
      float c[4];
      dmid<WIDE>(g, rank1, pb, NU - 1, wl, ct, Din, bf, nks, w, n0, c);
      bwd_lap<LAP>(g, st, pb, NU - 1, c, pl, rank1, ct, j0, Mo, Do);
      bwd_rest<LAP>(g, st, pb, n0, NU - 1, c, pl, rank1, jsum, ct, j0, Mo, Do, red2);
    }
    for (int u = 0; u < NU - 1; ++u) {
      const float4 f = u ? sv[u * 32] : f0;
      const float pr[4] = {f.x, f.y, f.z, f.w};
      float c[4];
      dmid<WIDE>(g, rank1, pb, u, wl, ct, Din, bf, nks, w, n0, c);
      bwd_rest<LAP>(g, st, pb, n0, u, c, pr, rank1, jsum, ct, j0, Mo, Do, red2);
    }
    // the value stream's cotangent, from every stream's share
    float cs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (g.t8 && h == 1) continue;
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        o[e] = g.t8 ? st.dva[0][e] + (st.dvl[0][e] + st.dvl[1][e]) +
                          (st.dvj[0][e] + st.dvj[1][e])
                    : st.dva[h][e] + st.dvl[h][e] + st.dvj[h][e];
        cs[e] += o[e];
      }
      *reinterpret_cast<uint32_t*>(Do + (tile_row(g, pb, 0) + gr + 8 * h) * g.ldb + j0) =
          pack_bf16(o[0], o[1]);
    }
    put_colsum<LAP>(g, red2, pb, 0, n0, cs[0], cs[1]);
    if (rank1) put_colsum<LAP>(g, red2, pb, slots<LAP>(g) - 1, n0, st.aw[0], st.aw[1]);
  }
}

// One 16 x 8 block (ib, jb) of dW_k = M^T D over the tile's stream rows,
// added to c: both operands by ldmatrix.trans from the bf16 stages.
__device__ __forceinline__ void dw_block(const Geo& g, const __nv_bfloat16* M,
                                         const __nv_bfloat16* D, int i0, int j0, float (&c)[4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* pa = M + (((lane >> 4) & 1) * 8 + (lane & 7)) * g.ldb + i0 +
                            ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* pbb = D + (lane & 15) * g.ldb + j0;
  for (int r0 = 0; r0 < g.ST; r0 += 16) {
    uint32_t a[4], b[2];
    ldsm_x4_t(a, pa + r0 * g.ldb);
    ldsm_x2_t(b, pbb + r0 * g.ldb);
    mma_bf16(c, a, b);
  }
}

// Whether the block's gradient row on chip can hold the hidden dW in
// fragment order in place (dw_product, dw_unfrag): every hidden width a
// multiple of 16, so that layer k's 16 x 8 blocks fill exactly its w_k x
// w_{k+1} entries, 16-byte aligned.
__host__ __device__ inline bool frag_ok(const Net& net) {
  for (int k = 1; k < net.K; ++k)
    if (net.w[k] % 16) return false;
  return true;
}

// dW_k of this tile, each warp its blocks in turn, added to grow: to the
// flat dW_k (dropping the padding), or (frag) to the layer's fragment-order
// accumulator in place of it on chip (a float4 per lane and block: a
// conflict-free read-modify-write, where the flat rows, 64 floats apart on
// u64, put a warp's 8 row groups in one bank); dw_unfrag writes it out in
// flat order once per block.
__device__ __forceinline__ void dw_product(const Net& net, const Geo& g, int k,
                                           const __nv_bfloat16* M, const __nv_bfloat16* D,
                                           float* grow, bool frag) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wi = net.w[k], wo = net.w[k + 1], NJ = np8(wo) / 8;
  const int nblk = (kp16(wi) / 16) * NJ;
  float* dW = grow + net.off[k];
  const int i = lane >> 2, j = 2 * (lane & 3);
  for (int blk = warp; blk < nblk; blk += NW) {
    const int ib = blk / NJ, jb = blk - ib * NJ;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    dw_block(g, M, D, ib * 16, jb * 8, c);
    if (frag) {
      float4* f = reinterpret_cast<float4*>(dW) + blk * 32 + lane;
      float4 v = *f;
      v.x += c[0];
      v.y += c[1];
      v.z += c[2];
      v.w += c[3];
      *f = v;
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ii = ib * 16 + i + 8 * h, jj = jb * 8 + j + e;
        if (ii < wi && jj < wo) dW[ii * wo + jj] += c[2 * h + e];
      }
  }
}

// The hidden dW of the row on chip (fragment order, dw_product) written to
// the block's row in device memory in flat order, after the row was copied
// there as it is and a barrier.
__device__ __forceinline__ void dw_unfrag(const Net& net, const float* gacc, float* grow_g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = 1; k < net.K - 1; ++k) {
    const int wo = net.w[k + 1], NJ = wo / 8, nblk = (net.w[k] / 16) * NJ;
    const float4* f = reinterpret_cast<const float4*>(gacc + net.off[k]);
    float* dW = grow_g + net.off[k];
    for (int blk = warp; blk < nblk; blk += NW) {
      const int ib = blk / NJ, jb = blk - ib * NJ;
      const float4 v = f[blk * 32 + lane];
      const int i = ib * 16 + (lane >> 2), j = jb * 8 + 2 * (lane & 3);
      dW[i * wo + j] = v.x;          // scalar: a block's row may start at any float
      dW[i * wo + j + 1] = v.y;
      dW[(i + 8) * wo + j] = v.z;
      dW[(i + 8) * wo + j + 1] = v.w;
    }
  }
}

// dW0 (and db0) from stage 1's cotangents: dW0[i][j] = sum_p rd(x[p][i])
// dv[p][j] (the bf16 D_1, value rows) + sum_p dJ_i[p][j] (red2 slot 1 + i),
// db0[j] = sum_p dv[p][j] (slot 0), on the CUDA cores.
template <bool LAP>
__device__ __forceinline__ void dw0(const Net& net, const Geo& g, const float* xs,
                                    const __nv_bfloat16* D1, const float* red2, float* grow) {
  const int d = net.d, w1 = net.w[1], items = (d + 1) * w1;
  float* dW0 = grow + net.off[0];
  for (int it = threadIdx.x; it < items; it += NT) {
    const int i = it / w1, j = it - i * w1;
    float acc = 0.f;
    if (i < d)
      for (int p = 0; p < g.T; ++p)
        acc = fmaf(rd_bf16(xs[p * d + i]), __bfloat162float(D1[p * g.ldb + j]), acc);
    float sj = 0.f;
    const int slot = i < d ? 1 + i : 0;
    for (int pb = 0; pb < g.NPB; ++pb) sj += red2[(pb * slots<LAP>(g) + slot) * g.wq + j];
    dW0[it] += acc + sj;
  }
}

// The jet pair's kernel arguments (fwdlap_backward.cu, fwdlap_forward.cu).
struct JetArgs {
  Net net;
  const float* X;
  const float* ct;            // KIND_BWD: (N, d+2) cotangent rows
  const float* params;
  float* partial;             // KIND_BWD: (G, row) per-block gradient rows
  float* scratch;             // KIND_BWD: (G, scratch_floats) saved stages
  float* out;                 // KIND_FWD: (N, d+2) jet rows
  int N, T, n_tiles, row, flags;
};

// Where the products of layer k read W_k: the fp32 W_k in device memory
// (DEV_WEIGHTS), the resident copy, or staged into Wsm now (bf16, then a
// barrier).
template <class Args>
__device__ __forceinline__ WSrc weights_of(const Args& A, bool res_w, __nv_bfloat16* Wsm,
                                           int k) {
  const Net& net = A.net;
  WSrc w{Wsm, ldw_of(net, k), nullptr, net.w[k], net.w[k + 1]};
  if (A.flags & DEV_WEIGHTS) {
    w.dev = A.params + net.off[k];
  } else if (res_w) {
    w.sm = Wsm + woff_bytes(net, k) / 2;
  } else {
    stage_w(A.params + net.off[k], net.w[k], net.w[k + 1], Wsm, w.ldw);
    __syncthreads();
  }
  return w;
}

// The design's tile loop.  Per tile: X (KIND_BWD: and the cotangent rows,
// stream-major), the input layer and the hidden products with the
// activation in their epilogues (the stages saved in the kinds with a
// reverse sweep; the last stage's projection partials unless KIND_BWD);
// KIND_FWD: the jet rows written for the valid points; KIND_SUMS: the
// policy `terms(base, proj, xs, ct, ps, grow)` adds each point's terms to
// its lanes of the block's doubles (ps, lanes_of(A) x T; A.row <= NT), which
// go out once, summed in point order, as the block's row of A.row floats;
// KIND_FUSED:
// the projection, then the loss terms and the cotangents by the policy
// `terms(base, proj, xs, ct, ps, grow)`; then
// the reverse sweep: the last stage's reverse nonlinearity from the
// rank-one cotangent ct * wlast with dW_last, per hidden layer the dA
// product with the reverse nonlinearity in its epilogue and the dW
// product, and dW0.  WIDE: the wide variant.  The plan's residency from
// A.flags: the hidden weights
// (bf16, staged once; or read from device memory), the block's gradient
// row (A.row floats) and the sums (on chip, or in device scratch).  LAP:
// the Laplacian stream is carried (the net's lap, checked by the launcher).
template <int KIND, bool WIDE, bool LAP = true, class Args, class Terms>
__device__ void body(const Args& A, Terms terms) {
  constexpr bool REV = KIND == KIND_FUSED || KIND == KIND_BWD, PROJ = KIND != KIND_BWD;
  constexpr bool SUMS = KIND == KIND_SUMS;
  // the jet forward's products before the last on the CUDA cores
  // (f32_products)
  constexpr bool INNER_F32 = KIND == KIND_FWD;
  extern __shared__ __align__(16) float smem[];
  const Net& net = A.net;
  // the kinds this design added (pass A; no Laplacian stream) on the
  // general layout, the parent's kinds on their own
  constexpr bool GEN = SUMS || !LAP;
  Geo g;
  if constexpr (GEN)
    make_geo(net, A.T, &g, LAP);
  else
    make_geo(net, A.T, &g);
  // KIND_SUMS: the double lanes of its row of sums
  const int lanes = SUMS ? lanes_of(A) : SUM_LANES;
  const Layout ly =
      GEN ? layout(net, g, A.flags, KIND, LAP, lanes) : layout(net, g, A.flags, KIND);
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  const int T = A.T, d = net.d, K = net.K, S = g.S;
  __nv_bfloat16* const stages = reinterpret_cast<__nv_bfloat16*>(sm + ly.bufs);
  const int stage = g.ST * g.ldb;
  __nv_bfloat16* Wsm = reinterpret_cast<__nv_bfloat16*>(sm + ly.w);
  const bool res_w = (A.flags & RES_WEIGHTS) != 0;
  float* gacc = REV && (A.flags & RES_GRAD) ? reinterpret_cast<float*>(sm + ly.gacc) : nullptr;
  // the block's slice of device scratch: the saved stages, then (DEV_SUMS)
  // the projection partials and the column sums
  float* const bscr =
      A.scratch ? A.scratch + (size_t)blockIdx.x *
                                  (GEN ? scratch_floats(net, g, KIND, A.flags, LAP)
                                       : scratch_floats(net, g, KIND, A.flags))
                : nullptr;
  float* red = reinterpret_cast<float*>(sm + ly.red);
  float* red2 = reinterpret_cast<float*>(sm + ly.red2);
  if (WIDE && (A.flags & DEV_SUMS)) {
    red = bscr + saved_floats(net, g, KIND);
    red2 = red + red_floats(g, KIND);
  }
  float* xs = reinterpret_cast<float*>(sm + ly.xs);
  float* ct = reinterpret_cast<float*>(sm + ly.ct);
  float* ps = reinterpret_cast<float*>(sm + ly.ps);
  float* proj = reinterpret_cast<float*>(sm + ly.proj);
  float* grow_g = REV ? A.partial + (size_t)blockIdx.x * A.row : nullptr;
  float* grow = gacc ? gacc : grow_g;     // where the tiles add their dW/db
  // the hidden dW on chip in fragment order (frag_ok)
  const bool frag = gacc && frag_ok(net);
  // the saved stages: stage k at scr + (k-1) * sst, this thread's lane
  const size_t sst = (size_t)g.nblk * (g.NU + 1) * 32;
  float4* scr = REV ? reinterpret_cast<float4*>(bscr) + (threadIdx.x & 31) : nullptr;

  if (REV)
    for (int i = threadIdx.x; i < A.row; i += NT) grow[i] = 0.f;
  if constexpr (SUMS)
    for (int i = threadIdx.x; i < lanes * T; i += NT) reinterpret_cast<double*>(ps)[i] = 0.0;
  {  // the stages start at zero: padding rows and columns are never written
    uint4* z = reinterpret_cast<uint4*>(sm + ly.bufs);
    for (int i = threadIdx.x; i < (ly.w - ly.bufs) / 16; i += NT) z[i] = make_uint4(0, 0, 0, 0);
  }
  if (res_w)
    for (int k = 1; k < K - 1; ++k)
      stage_w(A.params + net.off[k], net.w[k], net.w[k + 1], Wsm + woff_bytes(net, k) / 2,
              ldw_of(net, k));
  __syncthreads();

  const int wl = net.w[K - 1];
  const float* wlast = A.params + net.off[K - 1];
  const float blast = wlast[wl];

  for (int tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    load_tile(A.X, A.N, d, base, T, xs);
    if constexpr (KIND == KIND_BWD) {
      // ct[s * T + p] = CT[base + p][s]; rows past N carry zero cotangents
      for (int i = threadIdx.x; i < T * S; i += NT) {
        const int p = i / S, s = i - p * S;
        ct[s * T + p] = base + p < A.N ? A.ct[(size_t)(base + p) * S + s] : 0.f;
      }
    }
    __syncthreads();
    // forward: stage 1 from the input layer, then the hidden products
    fwd_input<REV, PROJ, LAP>(net, g, xs, A.params + net.off[0], stages, scr, K == 2, wlast,
                              red);
    __syncthreads();
    __nv_bfloat16 *in = stages, *out = stages + stage;
    for (int k = 1; k < K - 1; ++k) {
      const WSrc w = weights_of(A, res_w, Wsm, k);
      fwd_product<REV, PROJ, WIDE, LAP, INNER_F32>(
          net, g, k, in, w, A.params + net.off[k] + net.w[k] * net.w[k + 1], out,
          scr + k * sst, k + 1 == K - 1, wlast, red);
      __syncthreads();
      __nv_bfloat16* t = in;
      in = out;
      out = t;
    }
    if constexpr (PROJ) {
      // the projection: the n-blocks' partials in order
      const int nbl = np8(wl) / 8;
      for (int r = threadIdx.x; r < S * T; r += NT) {
        float acc = 0.f;
        for (int nb = 0; nb < nbl; ++nb) acc += red[nb * g.ST + r];
        proj[r] = r < T ? acc + blast : acc;
      }
      __syncthreads();
    }
    if constexpr (KIND == KIND_FWD) {
      // out[(base + p) * S + s] = proj[s * T + p]: consecutive threads
      // write consecutive floats of the tile's rows
      for (int i = threadIdx.x; i < T * S; i += NT) {
        const int p = i / S, s = i - p * S;
        if (base + p < A.N) A.out[(size_t)(base + p) * S + s] = proj[s * T + p];
      }
      continue;
    }
    if constexpr (SUMS) {
      terms(base, proj, xs, ct, ps, nullptr);
      __syncthreads();
      continue;
    }
    if constexpr (KIND == KIND_FUSED) terms(base, proj, xs, ct, ps, grow);
    // reverse: the last stage from the rank-one cotangent ct * wlast
    bwd_stage<WIDE, LAP>(net, g, K - 1, true, nullptr, WSrc{}, ct, wlast, scr + (K - 2) * sst,
                         nullptr, stages, red2);
    __syncthreads();
    const int R = LAP ? S : S + 1;
    for (int j = threadIdx.x; j < wl; j += NT) {
      float a = 0.f, b = 0.f;
      for (int pb = 0; pb < g.NPB; ++pb) {
        a += red2[(pb * R + R - 1) * g.wq + j];
        b += red2[pb * R * g.wq + j];
      }
      grow[net.off[K - 1] + j] += a;
      if (K > 2) grow[net.off[K - 2] + net.w[K - 2] * wl + j] += b;
    }
    // stage k: D holds D_{k+1}; M_k and D_k go to the two free stages
    __nv_bfloat16 *D = stages, *F1 = stages + stage, *F2 = stages + 2 * stage;
    for (int k = K - 2; k >= 1; --k) {
      __syncthreads();
      const WSrc w = weights_of(A, res_w, Wsm, k);
      bwd_stage<WIDE, LAP>(net, g, k, false, D, w, ct, wlast, scr + (k - 1) * sst, F1, F2,
                           red2);
      __syncthreads();
      if (k >= 2)
        for (int j = threadIdx.x; j < net.w[k]; j += NT) {
          float b = 0.f;
          for (int pb = 0; pb < g.NPB; ++pb) b += red2[pb * R * g.wq + j];
          grow[net.off[k - 1] + net.w[k - 1] * net.w[k] + j] += b;
        }
      dw_product(net, g, k, F1, D, grow, frag);
      __nv_bfloat16* freed = D;
      D = F2;
      F2 = F1;
      F1 = freed;
    }
    __syncthreads();
    dw0<LAP>(net, g, xs, D, red2, grow);
    __syncthreads();
  }
  if constexpr (SUMS) {
    // the block's row of sums, each lane's points in order (the last tile
    // ended in a barrier)
    if (threadIdx.x < A.row) {
      const double* psum = reinterpret_cast<const double*>(ps);
      double s = 0.0;
      for (int p = 0; p < T; ++p) s += psum[threadIdx.x * T + p];
      A.partial[(size_t)blockIdx.x * A.row + threadIdx.x] = (float)s;
    }
  }
  // the row on chip goes out once (its hidden dW in flat order)
  if (gacc) {
    for (int i = threadIdx.x; i < A.row; i += NT) grow_g[i] = gacc[i];
    if (frag) {
      __syncthreads();
      dw_unfrag(net, gacc, grow_g);
    }
  }
}

// ------------------------------------------------- the policies' and launchers' helpers
// The tile's sum of ps[0..T) added to *dst by warp 0 (pass B's sum ct_v):
// lane l adds points l, l + 32, ... in order, then a fixed shuffle tree.
__device__ __forceinline__ void tile_sum(int T, const float* ps, float* dst) {
  if (threadIdx.x < 32) {
    float a = 0.f;
    for (int p = threadIdx.x; p < T; p += 32) a += ps[p];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (threadIdx.x == 0) *dst += a;
  }
}

// The kind of a two-pass kernel: pass B (seeded) KIND_FUSED, pass A KIND_SUMS.
__host__ __device__ inline int pass_kind(bool seeded) { return seeded ? KIND_FUSED : KIND_SUMS; }

// The kernel of a launch's design: DES_MMA the narrow variant, with DES_WIDE
// the wide one; anything else nullptr (refused).
template <class Fn>
Fn kernel_for(int des, Fn narrow, Fn wide) {
  if ((des & ~DES_WIDE) != DES_MMA) return nullptr;
  return (des & DES_WIDE) ? wide : narrow;
}

// The net and the tile geometry of the general layout (lap: the Laplacian
// stream), false for a net or tile the design does not take.
inline bool net_geo(int lap, const int* layers, int n_layers, int T, Net* net, Geo* g) {
  return make_net(lap != 0 ? 1 : 0, layers, n_layers, 0, net) && make_geo(*net, T, g, lap != 0);
}

// Launch a two-pass kernel on G blocks and reduce its per-block rows
// (a.partial, a.row floats each) into out in one ordered pass.
template <class Args>
int launch_rows(void (*fn)(Args), const Args& a, int G, int smem_bytes, float* out,
                void* stream) {
  cudaError_t err = ensure_smem((const void*)fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fn<<<G, NT, smem_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows(a.partial, G, a.row, out, s);
}

// Resident blocks per SM of a kernel at a dynamic shared-memory size.
template <class Args>
int blocks_per_sm(void (*fn)(Args), int smem_bytes, int* blocks) {
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = ensure_smem((const void*)fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT, smem_bytes);
}

}  // namespace mma
}  // namespace fwdlap
