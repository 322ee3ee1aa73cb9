// The bf16-dot mode of the quotient kernels' two passes on the tensor-core
// design (fwdlap_mma.cuh, DES_MMA).
//
// Replaces the Pallas kernels of nnpde_tpu/kernels/fused_quotient.py with
// dot_dtype='bfloat16':
//   linear_sums_mma   <- _linear_sums_kernel   pass A: sum r, sum r^2,
//                        sum (e1 v)^2, sum e2 v (body<KIND_SUMS>)
//   linear_seeded_mma <- _linear_seeded_kernel pass B: dW/db of s_r sum r +
//                        s_q sum (e1 v)^2 + s_l sum e2 v (body<KIND_FUSED>)
//   quad_sums_mma     <- _quad_sums_kernel     pass A: sum e, sum u^2
//   quad_seeded_mma   <- _quad_seeded_kernel   pass B: dW/db of s_e sum e +
//                        s_q sum u^2
// with the coefficient layouts and seeds of fused_quotient.cu.  What the
// mode computes is the TPU kernels' cast: every product operand of the
// recompute and the reverse sweep rounded to bf16, fp32 accumulation, the
// projection and the per-point terms in fp32 (fwdlap_mma.cuh has the design,
// its tiers and what stays fp32).  Each kernel is the body with a policy:
// pass A's the per-point terms of the sums, each added to the point's
// double lanes for the block's life and summed in point order when the
// block ends (a quotient amplifies the error of its sums); pass B's the
// seeded cotangents of the projected streams, the tile's sum ct_v (the last
// bias gradient) added to the block's gradient row.  The linear kinds carry
// the Laplacian stream or not (lap; the WAN weak forms drop it), the
// quadratic ones never.
//
// Bound on the H100: the fp32 kernels' FLOP at 989 TFLOP/s (bf16 dense):
// pass A 2(d+1+lap) sum(n_in n_out) per point, pass B three times that.
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

enum Kind { LIN_SUMS = 0, LIN_SEEDED = 1, QUAD_SUMS = 2, QUAD_SEEDED = 3 };

struct MArgs {
  Net net;
  const float* X;
  const float* coef;          // (N, nc): d + 5 linear, d + 3 quadratic
  const float* params;
  const float* scal;          // pass B seeds (3 linear, 2 quadratic)
  float* partial;             // (G, row): the sums, or [grads (P) | sum ct_v, 0, 0]
  float* scratch;             // (G, mma::scratch_floats), pass B only
  int N, T, n_tiles, row, flags;
};

__host__ __device__ inline bool is_seeded(int kind) {
  return kind == LIN_SEEDED || kind == QUAD_SEEDED;
}
__host__ __device__ inline bool is_linear(int kind) {
  return kind == LIN_SUMS || kind == LIN_SEEDED;
}
__host__ __device__ inline int mma_kind(int kind) { return mma::pass_kind(is_seeded(kind)); }

// Pass A (linear): r = c v + b.g + rhs (+ a lap), the four sums' terms
// added to the point's lanes; padded points add nothing.
template <bool LAP>
__device__ __forceinline__ void lin_sums_terms(const MArgs& A, int base, const float* proj,
                                               double* psum) {
  const int T = A.T, d = A.net.d;
  for (int p = threadIdx.x; p < T; p += NT) {
    if (base + p >= A.N) continue;
    const float* row = A.coef + (size_t)(base + p) * (d + 5);
    const float v = proj[p];
    float r = row[0] * v + row[d + 2];
    if (LAP) r += row[d + 1] * proj[(d + 1) * T + p];
    for (int i = 0; i < d; ++i) r += row[1 + i] * proj[(1 + i) * T + p];
    const float m = row[d + 3] * v;
    psum[p] += (double)r;
    psum[T + p] += (double)(r * r);
    psum[2 * T + p] += (double)(m * m);
    psum[3 * T + p] += (double)(row[d + 4] * v);
  }
}

// Pass A (quadratic): u = B v, G = B g + v dB, e = |G|^2/2 - f u + V u^2.
__device__ __forceinline__ void quad_sums_terms(const MArgs& A, int base, const float* proj,
                                                double* psum) {
  const int T = A.T, d = A.net.d;
  for (int p = threadIdx.x; p < T; p += NT) {
    if (base + p >= A.N) continue;
    const float* row = A.coef + (size_t)(base + p) * (d + 3);
    const float v = proj[p], B = row[0];
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

// Pass B (linear): ct_v = s_r c + 2 s_q e1^2 v + s_l e2, ct_g = s_r b, ct_l
// = s_r a (LAP); padded points carry zero cotangents.
template <bool LAP>
__device__ __forceinline__ void lin_seeded_terms(const MArgs& A, int base, const float* proj,
                                                 float* ct, float* ps, float* grow) {
  const int T = A.T, d = A.net.d;
  const float s_r = A.scal[0], s_q = A.scal[1], s_l = A.scal[2];
  for (int p = threadIdx.x; p < T; p += NT) {
    const bool valid = base + p < A.N;
    const float* row = A.coef + (size_t)(valid ? base + p : 0) * (d + 5);
    float ctv = 0.f;
    if (valid) {
      const float e1 = row[d + 3];
      ctv = s_r * row[0] + s_q * 2.0f * e1 * e1 * proj[p] + s_l * row[d + 4];
    }
    for (int i = 0; i < d; ++i) ct[(1 + i) * T + p] = valid ? s_r * row[1 + i] : 0.f;
    if (LAP) ct[(d + 1) * T + p] = valid ? s_r * row[d + 1] : 0.f;
    ct[p] = ctv;
    ps[p] = ctv;
  }
  __syncthreads();
  mma::tile_sum(T, ps, grow + A.net.P);
}

// Pass B (quadratic): ct_v = s_e (sum_i G_i dB_i - f B + 2 V u B) + 2 s_q
// B^2 v, ct_g_i = s_e G_i B.
__device__ __forceinline__ void quad_seeded_terms(const MArgs& A, int base, const float* proj,
                                                  float* ct, float* ps, float* grow) {
  const int T = A.T, d = A.net.d;
  const float s_e = A.scal[0], s_q = A.scal[1];
  for (int p = threadIdx.x; p < T; p += NT) {
    const bool valid = base + p < A.N;
    const float* row = A.coef + (size_t)(valid ? base + p : 0) * (d + 3);
    const float v = proj[p];
    const float B = valid ? row[0] : 0.f;
    float out = 0.f;
    if (valid) out = -row[d + 1] * B + 2.0f * row[d + 2] * (B * v) * B;
    for (int i = 0; i < d; ++i) {
      const float dB = valid ? row[1 + i] : 0.f;
      const float G = B * proj[(1 + i) * T + p] + dB * v;
      out += G * dB;
      ct[(1 + i) * T + p] = s_e * G * B;
    }
    out = s_e * out + s_q * 2.0f * B * B * v;
    ct[p] = out;
    ps[p] = out;
  }
  __syncthreads();
  mma::tile_sum(T, ps, grow + A.net.P);
}

}  // namespace

// Two blocks per SM (the plans count on them; the register budget of the
// reverse sweep, fused_step_mma.cu's fused_mma_kernel).  WIDE: the variant for
// widths above 128 or the weights in device memory; LAP: the Laplacian
// stream carried (linear kinds).
template <bool WIDE, bool LAP>
__global__ void __launch_bounds__(NT, 2) linear_sums_mma(MArgs a) {
  mma::body<mma::KIND_SUMS, WIDE, LAP>(
      a, [&](int base, const float* proj, const float*, float*, float* ps, float*) {
    lin_sums_terms<LAP>(a, base, proj, reinterpret_cast<double*>(ps));
  });
}
template <bool WIDE>
__global__ void __launch_bounds__(NT, 2) quad_sums_mma(MArgs a) {
  mma::body<mma::KIND_SUMS, WIDE, false>(
      a, [&](int base, const float* proj, const float*, float*, float* ps, float*) {
    quad_sums_terms(a, base, proj, reinterpret_cast<double*>(ps));
  });
}
template <bool WIDE, bool LAP>
__global__ void __launch_bounds__(NT, 2) linear_seeded_mma(MArgs a) {
  mma::body<mma::KIND_FUSED, WIDE, LAP>(
      a, [&](int base, const float* proj, const float*, float* ct, float* ps, float* grow) {
    lin_seeded_terms<LAP>(a, base, proj, ct, ps, grow);
  });
}
template <bool WIDE>
__global__ void __launch_bounds__(NT, 2) quad_seeded_mma(MArgs a) {
  mma::body<mma::KIND_FUSED, WIDE, false>(
      a, [&](int base, const float* proj, const float*, float* ct, float* ps, float* grow) {
    quad_seeded_terms(a, base, proj, ct, ps, grow);
  });
}

namespace {

typedef void (*MKernelFn)(MArgs);

template <bool WIDE>
MKernelFn mma_kernel_of(int kind, int lap) {
  switch (kind) {
    case LIN_SUMS: return lap ? linear_sums_mma<WIDE, true> : linear_sums_mma<WIDE, false>;
    case LIN_SEEDED: return lap ? linear_seeded_mma<WIDE, true> : linear_seeded_mma<WIDE, false>;
    case QUAD_SUMS: return lap ? nullptr : quad_sums_mma<WIDE>;
    case QUAD_SEEDED: return lap ? nullptr : quad_seeded_mma<WIDE>;
    default: return nullptr;
  }
}

// The kernel of a kind, its Laplacian stream and a design: DES_MMA, with
// DES_WIDE the wide variant; anything else is refused.
MKernelFn mma_kernel_for(int kind, int lap, int des) {
  return mma::kernel_for(des, mma_kernel_of<false>(kind, lap), mma_kernel_of<true>(kind, lap));
}

bool mma_qnet(int kind, int lap, const int* layers, int n_layers, int T, Net* net, mma::Geo* g) {
  return kind >= LIN_SUMS && kind <= QUAD_SEEDED && (lap == 0 || is_linear(kind)) &&
         mma::net_geo(lap, layers, n_layers, T, net, g);
}

}  // namespace

extern "C" {

// kind: 0 linear sums, 1 linear seeded, 2 quadratic sums, 3 quadratic
// seeded (fused_quotient.cu's); lap: carry the Laplacian stream (linear
// kinds only); scal: the device seeds (seeded kinds); flags: the plan's
// Flags (mma::flags_ok of the kind); des: DES_MMA, with DES_WIDE where
// mma::needs_wide.  partial (G, row) and out (row) with row = 4 / P+3 / 2 /
// P+3 (pass B: [grads | sum ct_v, 0, 0]); scratch (G,
// fused_quotient_mma_scratch_floats) for the seeded kinds (else may be
// null).  smem_bytes must hold mma::layout for (T, flags).
int fused_quotient_mma_f32(int kind, int lap, const float* X, const float* coef,
                           const float* params, const float* scal, const int* layers,
                           int n_layers, int act, int N, int T, int G, int flags, int des,
                           float* partial, float* scratch, float* out, int smem_bytes,
                           void* stream) {
  MKernelFn fn = mma_kernel_for(kind, lap, des);
  MArgs a;
  mma::Geo g;
  if (fn == nullptr || !mma_qnet(kind, lap, layers, n_layers, T, &a.net, &g) || N < 1 || G < 1 ||
      !mma::flags_ok(flags, mma_kind(kind)) ||
      mma::layout(a.net, g, flags, mma_kind(kind), lap != 0).total > smem_bytes ||
      (mma::needs_wide(a.net, flags) && !(des & mma::DES_WIDE)) ||
      (is_seeded(kind) && (scal == nullptr || scratch == nullptr)))
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
  a.row = is_seeded(kind) ? a.net.P + 3 : (is_linear(kind) ? 4 : 2);
  a.flags = flags;
  return mma::launch_rows(fn, a, G, smem_bytes, out, stream);
}

// Resident blocks per SM for a kind, Laplacian stream and design at a
// dynamic shared-memory size.
int fused_quotient_mma_blocks_per_sm(int kind, int lap, int des, int smem_bytes, int* blocks) {
  return mma::blocks_per_sm(mma_kernel_for(kind, lap, des), smem_bytes, blocks);
}

// The shared-memory bytes of a block for (T, flags), and the floats of its
// slice of device scratch, or -1 for a kind, net or tile the kernels do not
// take.
int fused_quotient_mma_smem_bytes(int kind, int lap, const int* layers, int n_layers, int T,
                                  int flags) {
  Net net;
  mma::Geo g;
  if (!mma_qnet(kind, lap, layers, n_layers, T, &net, &g)) return -1;
  return mma::layout(net, g, flags, mma_kind(kind), lap != 0).total;
}

int fused_quotient_mma_scratch_floats(int kind, int lap, const int* layers, int n_layers, int T,
                                      int flags) {
  Net net;
  mma::Geo g;
  if (!mma_qnet(kind, lap, layers, n_layers, T, &net, &g)) return -1;
  return (int)mma::scratch_floats(net, g, mma_kind(kind), flags, lap != 0);
}

}  // extern "C"
