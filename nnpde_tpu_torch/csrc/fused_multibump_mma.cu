// The bf16-dot mode of the K-bump WAN pair's two passes on the tensor-core
// design (fwdlap_mma.cuh, DES_MMA).
//
// Replaces the Pallas kernels of nnpde_tpu/kernels/fused_multibump.py with
// dot_dtype='bfloat16':
//   multi_sums_mma   <- _multi_sums_kernel   pass A: per bump k, sum r_k,
//                       sum (e1_k v)^2, sum e2_k v with r_k = c_k v + b_k.g
//                       + rhs_k; out (3 Kb): [sum r | sum mass | sum e2]
//                       (body<KIND_SUMS>)
//   multi_seeded_mma <- _multi_seeded_kernel pass B: dW/db of sum_k (s_r_k
//                       sum r_k + s_q_k sum (e1_k v)^2 + s_l_k sum e2_k v) by
//                       one reverse sweep on the cotangents summed over the
//                       bumps, and sum ct_v (body<KIND_FUSED>)
// with the coefficient layout and seeds of fused_multibump.cu: per point
// Kb blocks [c_k, b_k0..b_k{d-1}, rhs_k], then e1_0..e1_{Kb-1}, then
// e2_0..e2_{Kb-1}; the seeds [s_r (Kb) | s_q (Kb) | s_l (Kb)] in device
// memory.  The weak forms are first order: no Laplacian stream (S = d + 1).
// What the mode computes is the TPU kernels' cast: every product operand of
// the recompute and the reverse sweep rounded to bf16, fp32 accumulation,
// the projection, the per-point terms and the cotangents in fp32
// (fwdlap_mma.cuh has the design, its tiers and what stays fp32).  Each
// kernel is the body with a policy, as in fused_quotient_mma.cu:
//   * pass A's adds each valid point's 3 Kb terms to its double lanes, in
//     _multi_sums_kernel's lane order ([0, Kb) weak, [Kb, 2Kb) mass, [2Kb,
//     3Kb) e2), one thread per (bump, point); the lanes live for the
//     block's life and are summed in point order when the block ends;
//   * pass B's builds ct_v and ct_g over the bumps in bump order in fp32
//     (_multi_seeded_kernel's order), one thread per (stream, point); padded
//     points carry zero cotangents; the tile's sum ct_v goes to the block's
//     gradient row.
// The coefficient rows (Kb (d+4) floats a point) are read from device
// memory by the policies, each float once a pass.
//
// Bound on the H100: the fp32 kernels' FLOP at 989 TFLOP/s (bf16 dense):
// pass A 2(d+1) sum(n_in n_out) per point, pass B three times that, plus
// the bumps' epilogue; against 4 (d + Kb (d+4)) bytes a point read.
//
// Determinism: fused_step.cu's rule (per-block rows, fixed in-block orders,
// one ordered reduction in double, no atomics).
//
// Interface: plain C (ctypes), float32 only, weights flattened as [W0, b0,
// W1, b1, ...].  Every entry point launches on the given stream, never
// synchronises, and returns cudaGetLastError().
#include "fwdlap_mma.cuh"

using namespace fwdlap;

namespace {

constexpr int MAX_BUMPS = 42;   // the cap of the JAX package (3 Kb <= 128)

struct MArgs {
  Net net;
  const float* X;
  const float* coef;          // (N, Kb (d+4))
  const float* params;
  const float* scal;          // pass B seeds (3 Kb)
  float* partial;             // (G, row): sums (3 Kb), or [grads (P) | sum ct_v, 0, 0]
  float* scratch;             // (G, mma::scratch_floats), pass B only
  int N, T, n_tiles, row, flags, Kb;
};

// Pass A's double lanes a point (mma::body finds this by argument-dependent
// lookup): its 3 Kb sums.
__host__ __device__ inline int lanes_of(const MArgs& A) { return mma::sum_lanes(A.row); }

// Pass A: thread i takes bump k = i / T of point p = i % T of the tile; r_k
// = c_k v + b_k.g + rhs_k and the mass and e2 terms added to the point's
// lanes k, Kb + k and 2 Kb + k; padded points add nothing.
__device__ __forceinline__ void multi_sums_terms(const MArgs& A, int base, const float* proj,
                                                 double* psum) {
  const int T = A.T, d = A.net.d, Kb = A.Kb, nc = Kb * (d + 4);
  const int blk = d + 2, base_e1 = Kb * blk, base_e2 = base_e1 + Kb;
  for (int i = threadIdx.x; i < Kb * T; i += NT) {
    const int k = i / T, p = i - k * T;
    if (base + p >= A.N) continue;
    const float* row = A.coef + (size_t)(base + p) * nc;
    const float* b = row + k * blk;
    const float v = proj[p];
    float r = b[0] * v + b[d + 1];
    for (int j = 0; j < d; ++j) r += b[1 + j] * proj[(1 + j) * T + p];
    const float m = row[base_e1 + k] * v;
    psum[k * T + p] += (double)r;
    psum[(Kb + k) * T + p] += (double)(m * m);
    psum[(2 * Kb + k) * T + p] += (double)(row[base_e2 + k] * v);
  }
}

// Pass B: thread i takes stream c = i / T of point p = i % T: ct_v = sum_k
// (s_r_k c_k + 2 s_q_k e1_k^2 v + s_l_k e2_k), ct_g_j = sum_k s_r_k b_kj,
// each summed in bump order; padded points carry zero cotangents.
__device__ __forceinline__ void multi_seeded_terms(const MArgs& A, int base, const float* proj,
                                                   float* ct, float* ps, float* grow) {
  const int T = A.T, d = A.net.d, Kb = A.Kb, nc = Kb * (d + 4);
  const int blk = d + 2, base_e1 = Kb * blk, base_e2 = base_e1 + Kb;
  const float* s_r = A.scal;
  const float* s_q = A.scal + Kb;
  const float* s_l = A.scal + 2 * Kb;
  for (int i = threadIdx.x; i < (d + 1) * T; i += NT) {
    const int c = i / T, p = i - c * T;
    float acc = 0.f;
    if (base + p < A.N) {
      const float* row = A.coef + (size_t)(base + p) * nc;
      if (c == 0) {
        const float v = proj[p];
        for (int k = 0; k < Kb; ++k) {
          const float e1 = row[base_e1 + k];
          acc = acc + s_r[k] * row[k * blk] + s_q[k] * 2.0f * e1 * e1 * v +
                s_l[k] * row[base_e2 + k];
        }
      } else {
        for (int k = 0; k < Kb; ++k) acc = acc + s_r[k] * row[k * blk + c];
      }
    }
    ct[c * T + p] = acc;
    if (c == 0) ps[p] = acc;
  }
  __syncthreads();
  mma::tile_sum(T, ps, grow + A.net.P);
}

}  // namespace

// Two blocks per SM (the plans count on them; the register budget of the
// tensor-core kernels).  WIDE: the variant for widths above 128 or the
// weights in device memory.
template <bool WIDE>
__global__ void __launch_bounds__(NT, 2) multi_sums_mma(MArgs a) {
  mma::body<mma::KIND_SUMS, WIDE, false>(
      a, [&](int base, const float* proj, const float*, float*, float* ps, float*) {
    multi_sums_terms(a, base, proj, reinterpret_cast<double*>(ps));
  });
}
template <bool WIDE>
__global__ void __launch_bounds__(NT, 2) multi_seeded_mma(MArgs a) {
  mma::body<mma::KIND_FUSED, WIDE, false>(
      a, [&](int base, const float* proj, const float*, float* ct, float* ps, float* grow) {
    multi_seeded_terms(a, base, proj, ct, ps, grow);
  });
}

namespace {

typedef void (*MKernelFn)(MArgs);

// The kernel of a pass and a design (mma::kernel_for).
MKernelFn mma_kernel_for(int seeded, int des) {
  return seeded ? mma::kernel_for(des, multi_seeded_mma<false>, multi_seeded_mma<true>)
                : mma::kernel_for(des, multi_sums_mma<false>, multi_sums_mma<true>);
}

// The block's layout: pass A's lanes are its 3 Kb sums.
mma::Layout mma_layout(const Net& net, const mma::Geo& g, int seeded, int n_bumps, int flags) {
  return mma::layout(net, g, flags, mma::pass_kind(seeded), false,
                     seeded ? mma::SUM_LANES : mma::sum_lanes(3 * n_bumps));
}

}  // namespace

extern "C" {

// seeded: 0 pass A (sums), 1 pass B (seeded gradients).  coef (N,
// n_bumps*(d+4)); scal: the device seeds (3 n_bumps; pass B, else may be
// null); flags: the plan's Flags (mma::flags_ok of the pass); des: DES_MMA,
// with DES_WIDE where mma::needs_wide.  partial (G, row) and out (row) with
// row = 3 n_bumps / P+3 (pass B: [grads | sum ct_v, 0, 0]); scratch (G,
// fused_multibump_mma_scratch_floats) for pass B (else may be null).
// smem_bytes must hold the pass's layout for (T, flags, n_bumps).
int fused_multibump_mma_f32(int seeded, int n_bumps, const float* X, const float* coef,
                            const float* params, const float* scal, const int* layers,
                            int n_layers, int act, int N, int T, int G, int flags, int des,
                            float* partial, float* scratch, float* out, int smem_bytes,
                            void* stream) {
  MKernelFn fn = mma_kernel_for(seeded, des);
  MArgs a;
  mma::Geo g;
  if (fn == nullptr || n_bumps < 1 || n_bumps > MAX_BUMPS ||
      !mma::net_geo(0, layers, n_layers, T, &a.net, &g) || N < 1 || G < 1 ||
      !mma::flags_ok(flags, mma::pass_kind(seeded)) ||
      mma_layout(a.net, g, seeded, n_bumps, flags).total > smem_bytes ||
      (mma::needs_wide(a.net, flags) && !(des & mma::DES_WIDE)) ||
      (seeded && (scal == nullptr || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  a.net.act = act;
  a.X = X;
  a.coef = coef;
  a.params = params;
  a.scal = scal;
  a.partial = partial;
  a.scratch = scratch;
  a.N = N;
  a.T = T;
  a.n_tiles = (N + T - 1) / T;
  a.row = seeded ? a.net.P + 3 : 3 * n_bumps;
  a.flags = flags;
  a.Kb = n_bumps;
  return mma::launch_rows(fn, a, G, smem_bytes, out, stream);
}

// Resident blocks per SM for a pass and design at a dynamic shared-memory
// size.
int fused_multibump_mma_blocks_per_sm(int seeded, int des, int smem_bytes, int* blocks) {
  return mma::blocks_per_sm(mma_kernel_for(seeded, des), smem_bytes, blocks);
}

// The shared-memory bytes of a block for (T, flags, n_bumps), and the floats
// of its slice of device scratch, or -1 for a net or tile the kernels do not
// take.
int fused_multibump_mma_smem_bytes(int seeded, int n_bumps, const int* layers, int n_layers,
                                   int T, int flags) {
  Net net;
  mma::Geo g;
  if (n_bumps < 1 || n_bumps > MAX_BUMPS || !mma::net_geo(0, layers, n_layers, T, &net, &g))
    return -1;
  return mma_layout(net, g, seeded, n_bumps, flags).total;
}

int fused_multibump_mma_scratch_floats(int seeded, const int* layers, int n_layers, int T,
                                       int flags) {
  Net net;
  mma::Geo g;
  if (!mma::net_geo(0, layers, n_layers, T, &net, &g)) return -1;
  return (int)mma::scratch_floats(net, g, mma::pass_kind(seeded), flags, false);
}

}  // extern "C"
