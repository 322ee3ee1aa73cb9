// What the fused loss+grad kernels' two translation units share
// (fused_step.cu: the planned fp32 kernels, the launchers and reduce_rows;
// fused_step_mma.cu: the tensor-core kernels of the bf16-dot mode, compiled
// apart so that nvcc builds the two in parallel): the kernels' arguments,
// the in-kernel coefficients of the analytic kernel and the per-point loss
// terms.  Each includer gets its own copy (an anonymous namespace), so the
// kernels' names and code are what they were in one file.
#pragma once

#include "fwdlap_core.cuh"

namespace {

using namespace fwdlap;

enum Mode { MODE_LINEAR = 0, MODE_ANALYTIC = 1, MODE_DRM = 2 };

struct Analytic {
  float L, a0, fscale;        // box side, operator scale, sum_i (k_i pi / L)^2
  float kpi[MAX_DIM];         // k_i pi / L
};

struct Args {
  Net net;
  const float* X;
  const float* coef;
  const float* params;
  float* partial;             // (G, row): per-block [grads (P) | sums (3)]
  float* scratch;             // (G, K-2, S, T, wmax) saved pre-activations
  int N, T, n_tiles, row;
  Analytic an;
};

// The planned kernels' arguments: Args and what their plan adds.
struct PArgs : Args {
  const float* wt;            // the hidden weights' transposes (tpos)
  int flags;                  // the plan's Flags
};

// In-kernel coefficients of r = a0*lap(B*net) - f for B = prod x_i (L - x_i)
// (_poisson_sin_coef_builder): a = a0*B, b_i = 2*a0*dB_i, c = a0*lapB.
// d <= CORE_DIM (the per-thread arrays); DES_BEYOND takes sin_coef_scalars
// and sin_coef_b.
__device__ __forceinline__ void poisson_sin_coef(const Analytic& an, int d,
                                                 const float* x, float& c,
                                                 float* b, float& a, float& rhs) {
  float gi[CORE_DIM];
  float B = 1.f, s = 1.f;
  for (int i = 0; i < d; ++i) {
    gi[i] = x[i] * (an.L - x[i]);
    B *= gi[i];
    s *= sinf(an.kpi[i] * x[i]);
  }
  float lapB = 0.f;
  for (int i = 0; i < d; ++i) {
    float pe = 1.f;                       // prod over j != i, division-free
    for (int j = 0; j < d; ++j)
      if (j != i) pe *= gi[j];
    b[i] = 2.f * an.a0 * ((an.L - 2.f * x[i]) * pe);
    lapB += -2.f * pe;
  }
  a = an.a0 * B;
  c = an.a0 * lapB;
  rhs = -(an.fscale * s);
}

// poisson_sin_coef without per-thread arrays, for any d (DES_BEYOND): the
// factors x_j (L - x_j) recomputed from x where they are needed, each
// product over j != i in the order of poisson_sin_coef.  This one gives c,
// a and rhs; sin_coef_b gives b_i.
__device__ __forceinline__ float sin_coef_pe(const Analytic& an, int d, const float* x,
                                             int i) {
  float pe = 1.f;
  for (int j = 0; j < d; ++j)
    if (j != i) pe *= x[j] * (an.L - x[j]);
  return pe;
}
__device__ __forceinline__ void sin_coef_scalars(const Analytic& an, int d, const float* x,
                                                 float& c, float& a, float& rhs) {
  float B = 1.f, s = 1.f;
  for (int i = 0; i < d; ++i) {
    B *= x[i] * (an.L - x[i]);
    s *= sinf(an.kpi[i] * x[i]);
  }
  float lapB = 0.f;
  for (int i = 0; i < d; ++i) lapB += -2.f * sin_coef_pe(an, d, x, i);
  a = an.a0 * B;
  c = an.a0 * lapB;
  rhs = -(an.fscale * s);
}
__device__ __forceinline__ float sin_coef_b(const Analytic& an, int d, const float* x, int i) {
  return 2.f * an.a0 * ((an.L - 2.f * x[i]) * sin_coef_pe(an, d, x, i));
}

// The per-point loss terms and cotangent seeds of a tile from its projected
// streams (proj), and the tile's three sums added to the block's row.
// BEYOND (the DES_BEYOND variant, any d): no per-point arrays; the
// coefficients b_i and the gradient streams are read (or built) again where
// they are needed, with the same arithmetic in the same order.
template <int MODE, bool BEYOND = false>
__device__ __forceinline__ void point_terms(const Args& A, int T, int base, const float* proj,
                                            const float* xs, float* ct, float* ps,
                                            float* grow) {
  const Net& net = A.net;
  const int d = net.d;
  // per-point loss terms and cotangent seeds
  if constexpr (BEYOND && MODE == MODE_DRM) {
    // the Ritz energy's terms below, each gradient stream read from proj
    // where it is needed
    for (int p = threadIdx.x; p < T; p += NT) {
      const bool valid = base + p < A.N;
      const float value = proj[p];
      const float* cf = A.coef + (size_t)(base + p) * (d + 2);
      const float B = valid ? cf[0] : 0.f;
      const float f = valid ? cf[d + 1] : 0.f;
      float e = 0.f, ctv = 0.f;
      for (int i = 0; i < d; ++i) {
        const float dB = valid ? cf[1 + i] : 0.f;
        const float G = B * proj[(1 + i) * T + p] + dB * value;
        e += 0.5f * G * G;
        ctv += G * dB;
        ct[(1 + i) * T + p] = G * B;
      }
      e -= f * B * value;
      ctv -= f * B;
      ct[p] = ctv;
      ct[(d + 1) * T + p] = 0.f;
      ps[p] = e;
      ps[T + p] = ctv;
      ps[2 * T + p] = 0.f;
    }
  } else if constexpr (BEYOND) {
    for (int p = threadIdx.x; p < T; p += NT) {
      const bool valid = base + p < A.N;
      const float value = proj[p];
      const float lapv = proj[(d + 1) * T + p];
      const float* cf =
          MODE == MODE_LINEAR ? A.coef + (size_t)(base + p) * (d + 4) : nullptr;
      const float* x = xs + p * d;
      float c, a, rhs, e = 0.f;
      if (MODE == MODE_LINEAR) {
        c = valid ? cf[0] : 0.f;
        a = valid ? cf[d + 1] : 0.f;
        rhs = valid ? cf[d + 2] : 0.f;
        e = valid ? cf[d + 3] : 0.f;
      } else {
        sin_coef_scalars(A.an, d, x, c, a, rhs);
      }
      float r = c * value + a * lapv + rhs;
      for (int i = 0; i < d; ++i) {
        const float bi =
            MODE == MODE_LINEAR ? (valid ? cf[1 + i] : 0.f) : sin_coef_b(A.an, d, x, i);
        r += bi * proj[(1 + i) * T + p];
      }
      if (!valid) r = 0.f;
      for (int i = 0; i < d; ++i) {
        const float bi =
            MODE == MODE_LINEAR ? (valid ? cf[1 + i] : 0.f) : sin_coef_b(A.an, d, x, i);
        ct[(1 + i) * T + p] = r * bi;
      }
      ct[p] = r * c;
      ct[(d + 1) * T + p] = r * a;
      ps[p] = r * r;
      ps[T + p] = r * c;
      ps[2 * T + p] = r * e * value;
    }
  } else {
    for (int p = threadIdx.x; p < T; p += NT) {
      const bool valid = base + p < A.N;
      float g[CORE_DIM];
      const float value = proj[p];
      for (int i = 0; i < d; ++i) g[i] = proj[(1 + i) * T + p];
      const float lapv = net.lap ? proj[(d + 1) * T + p] : 0.f;

      float s0 = 0.f, s1 = 0.f, s2 = 0.f, ctv = 0.f, ctl = 0.f;
      if (MODE == MODE_DRM) {
        const float* cf = A.coef + (size_t)(base + p) * (d + 2);
        const float B = valid ? cf[0] : 0.f;
        const float f = valid ? cf[d + 1] : 0.f;
        float e = 0.f;
        for (int i = 0; i < d; ++i) {
          const float dB = valid ? cf[1 + i] : 0.f;
          const float G = B * g[i] + dB * value;
          e += 0.5f * G * G;
          ctv += G * dB;
          ct[(1 + i) * T + p] = G * B;
        }
        e -= f * B * value;
        ctv -= f * B;
        s0 = e;
        s1 = ctv;
      } else {
        float c, a, rhs, e = 0.f, bb[CORE_DIM];
        if (MODE == MODE_LINEAR) {
          const float* cf = A.coef + (size_t)(base + p) * (d + 4);
          c = valid ? cf[0] : 0.f;
          for (int i = 0; i < d; ++i) bb[i] = valid ? cf[1 + i] : 0.f;
          a = valid ? cf[d + 1] : 0.f;
          rhs = valid ? cf[d + 2] : 0.f;
          e = valid ? cf[d + 3] : 0.f;
        } else {
          poisson_sin_coef(A.an, d, xs + p * d, c, bb, a, rhs);
        }
        float r = c * value + a * lapv + rhs;
        for (int i = 0; i < d; ++i) r += bb[i] * g[i];
        if (!valid) r = 0.f;
        s0 = r * r;
        s1 = r * c;
        s2 = r * e * value;
        ctv = r * c;
        ctl = r * a;
        for (int i = 0; i < d; ++i) ct[(1 + i) * T + p] = r * bb[i];
      }
      ct[p] = ctv;
      ct[(d + 1) * T + p] = ctl;
      ps[p] = s0;
      ps[T + p] = s1;
      ps[2 * T + p] = s2;
    }
  }
  __syncthreads();
  // the tile's three sums by warp 0: lane l adds points l, l + 32, ... in
  // order, then a fixed shuffle tree (a single thread's loop would be a
  // chain of 3 T dependent shared loads)
  if (threadIdx.x < 32) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int p = threadIdx.x; p < T; p += 32) {
      a0 += ps[p];
      a1 += ps[T + p];
      a2 += ps[2 * T + p];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, o);
      a1 += __shfl_xor_sync(0xffffffffu, a1, o);
      a2 += __shfl_xor_sync(0xffffffffu, a2, o);
    }
    if (threadIdx.x == 0) {
      grow[net.P] += a0;
      grow[net.P + 1] += a1;
      grow[net.P + 2] += a2;
    }
  }
}

}  // namespace

// The tensor-core kernel of a mode (fused_step_mma.cu): the narrow variant
// or (wide) the wide one, and for the nets of beyond_net (beyond) its
// DES_BEYOND variant; as the pointer the launchers and occupancy calls take.
const void* fused_mma_fn(int mode, bool wide, bool beyond);
