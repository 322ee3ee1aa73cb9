// The planned design of the fused residual kernels (fused_step.cu) and of the
// jet backward (fwdlap_backward.cu): the same recompute and reverse sweep as
// fwdlap_core.cuh's fwd_recompute / reverse_sweep, with the work of a thread
// and the launch shape redesigned for the H100.  The other kernels keep the
// core's routines as they are.
//
// What held the core's per-tile routines back on these two kernels (a
// clock64 build of one block's phases, not kept; PERF.md): products at about
// half the FFMA rate behind 4 x 4 register tiles, the dW products
// (accum_dW) behind three shared-memory wavefronts per 16 FFMA of a warp, a
// transposed copy of every hidden weight matrix built per tile by scattered
// (bank-conflicting) stores, and a constant 16-point tile.  What this design
// does (template parameter DES, bits of Design: DES_PLANNED, and the lever
// below; the plan of kernels/fused_step.py chooses it by net, chip_smoke.py's
// sweep measures it on its own):
//   DES_ITEM2 -- two-point items: each product item is a register tile of 8
//     rows x 4 units (at S <= 4 two points x their streams, mm_actp and
//     mm_act_bwdp with NP = 2; at S > 4 eight stream-rows, mm_rows_p<8>),
//     so a weight float4 read from shared memory feeds 32 FMAs instead of
//     16, and a tile of up to 32 points (u64) is still one wave of the
//     block; every entry's sum over k runs in the same order as in the
//     4 x 4 items.  With it the plan (kernels/_plan.py, rows = 8) takes the
//     largest one-wave tile of such items, and the wrappers take it only
//     where that tile fits two blocks per SM as it is: a tile a step below
//     leaves threads idle in every product (u64: 28 points, 224 of 256
//     items), and there the planned 4 x 4 items at 16 points are faster.
// In every planned design:
//   * the hidden weights' transposes come from device memory (`wt`: the
//     wrapper's one torch.cat of W_1^T .. W_{K-2}^T per launch), so the
//     reverse sweep stages them with cp.async like the forward's weights,
//     each while the previous stage's dW products run;
//   * accum_dW_p deals the dW items to a warp as 4 (i) x 8 (j) groups, so a
//     row of M and of D each cost one wavefront: two per 16 FFMA, not three;
//   * the elementwise passes of the FOLD variant (stage 1's activation in the
//     input layer, the last stage's backward) take two (point, unit) entries
//     per pass, their loads first, so each thread has two independent chains
//     in flight (they are latency-bound at a few entries per thread);
//   * the residency of the plan (Flags) is taken at run time: the hidden
//     weights and their transposes, the gradient row;
//   * two blocks per SM (__launch_bounds__(NT, 2): 128 registers), which
//     the plan counts on.
#pragma once

#include "fwdlap_core.cuh"

namespace fwdlap {

// The designs (header note): DES_PLANNED marks a planned design, the
// kernels on this header's routines; DES_ITEM2 is its lever.  Design 0 is
// the core's kernels.  DES_DEVW (with either): the hidden weights read
// from device memory (Flags::DEV_WEIGHTS), for nets whose weights do not
// fit shared memory beside a tile; compiled without the fold only.
// DES_BEYOND (with DES_PLANNED, alone or with DES_DEVW; no fold, 4 x 4
// items): the variant of the fused kernels and the jet backward for
// the nets beyond the other kernels' limits (beyond_net: a hidden width above
// NT, d above CORE_DIM): the last layer's dW split takes widths above NT, the
// fused kernels' loss terms keep no per-point arrays.  Compiled only for
// those nets, so the other variants keep their code.
enum Design { DES_ITEM2 = 1, DES_PLANNED = 2, DES_DEVW = 8, DES_BEYOND = 32 };

// W_k^T's offset in `wt` (the hidden weights' transposes back to back, true
// sizes): the sum over m = 1..k-1 of w[m] * w[m+1].
__host__ __device__ inline int tpos(const Net& net, int k) {
  int n = 0;
  for (int m = 1; m < k; ++m) n += net.w[m] * net.w[m + 1];
  return n;
}

// One item of mm_rows_p<8>: the NQ-row x 4-column register tile at rows
// r0.., units j0.. (mm_rows's arithmetic, in its order).
template <int NQ>
__device__ __forceinline__ void mm_rows_item(const float* __restrict__ in, int ld, int r0,
                                             int kdim, const float* __restrict__ W,
                                             int ncols, int j0, float* __restrict__ out,
                                             const float* __restrict__ bias, int bias_rows,
                                             int bias_cols) {
  float acc[NQ][4] = {};
  for (int k = 0; k < kdim; k += 4) {
    float4 a[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) a[q] = *reinterpret_cast<const float4*>(in + (r0 + q) * ld + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(W + (k + kk) * ncols + j0);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float s = lane(a[q], kk);
        acc[q][0] = fmaf(s, w.x, acc[q][0]);
        acc[q][1] = fmaf(s, w.y, acc[q][1]);
        acc[q][2] = fmaf(s, w.z, acc[q][2]);
        acc[q][3] = fmaf(s, w.w, acc[q][3]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
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
    *reinterpret_cast<float4*>(out + (r0 + q) * ld + j0) = o;
  }
}

// mm_rows (rows x kdim by kdim x ncols, both ld apart; + bias on rows <
// bias_rows) with NQ-row items: the core's mm_rows for NQ = 4; under NQ =
// 8 (rows a multiple of 4) a last group of 4 rows takes a 4-row item.
template <int NQ>
__device__ __forceinline__ void mm_rows_p(const float* __restrict__ in, int ld, int rows,
                                          int kdim, const float* __restrict__ W, int ncols,
                                          float* __restrict__ out,
                                          const float* __restrict__ bias, int bias_rows,
                                          int bias_cols) {
  if constexpr (NQ == 4) {
    mm_rows(in, ld, rows, kdim, W, ncols, out, ld, bias, bias_rows, bias_cols);
  } else {
    const int cg = ncols >> 2;
    const int items8 = (rows >> 3) * cg;
    const int items = items8 + ((rows & 4) ? cg : 0);
    for (int it = threadIdx.x; it < items; it += NT) {
      if (it < items8) {
        const int rg = it / cg;
        mm_rows_item<8>(in, ld, rg << 3, kdim, W, ncols, (it - rg * cg) << 2, out, bias,
                        bias_rows, bias_cols);
      } else {
        mm_rows_item<4>(in, ld, rows & ~7, kdim, W, ncols, (it - items8) << 2, out, bias,
                        bias_rows, bias_cols);
      }
    }
  }
}

// mm_act with NP points per item (the 2*SS x 4 tile of points p0, p0 + 1
// under DES_ITEM2).  kdim, ncols multiples of 4.
template <int NP, int SS>
__device__ __forceinline__ void mm_actp(const Net& net, int T, const float* __restrict__ in,
                                        int kdim, const float* __restrict__ W, int ncols,
                                        const float* __restrict__ bias, int bias_cols,
                                        float* __restrict__ out, float* __restrict__ save) {
  if constexpr (NP == 1) {
    mm_act<SS>(net, T, in, kdim, W, ncols, bias, bias_cols, out, save);
    return;
  }
  const int ld = net.wmax, sT = T * ld;
  const int cg = ncols >> 2, items = (T / NP) * cg;
  for (int it = threadIdx.x; it < items; it += NT) {
    const int pg = it / cg;
    const int j0 = (it - pg * cg) << 2;
    const int p0 = pg * NP;
    float acc[NP][SS][4] = {};
    for (int k = 0; k < kdim; k += 4) {
      float4 a[NP][SS];
#pragma unroll
      for (int h = 0; h < NP; ++h)
#pragma unroll
        for (int s = 0; s < SS; ++s)
          a[h][s] = *reinterpret_cast<const float4*>(in + (p0 + h) * ld + s * sT + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w = *reinterpret_cast<const float4*>(W + (k + kk) * ncols + j0);
#pragma unroll
        for (int h = 0; h < NP; ++h)
#pragma unroll
          for (int s = 0; s < SS; ++s) {
            const float x = lane(a[h][s], kk);
            acc[h][s][0] = fmaf(x, w.x, acc[h][s][0]);
            acc[h][s][1] = fmaf(x, w.y, acc[h][s][1]);
            acc[h][s][2] = fmaf(x, w.z, acc[h][s][2]);
            acc[h][s][3] = fmaf(x, w.w, acc[h][s][3]);
          }
      }
    }
#pragma unroll
    for (int h = 0; h < NP; ++h) {
      const int o0 = (p0 + h) * ld + j0;
      float mid[SS][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j0 + c < bias_cols) acc[h][0][c] += bias[j0 + c];
        const Pack pk = act_pack(net.act, acc[h][0][c]);
        mid[0][c] = pk.s0;
        float q = 0.f;
#pragma unroll
        for (int s = 1; s < SS; ++s) {
          if (net.lap && s == SS - 1) {
            mid[s][c] = pk.s1 * acc[h][s][c] + pk.s2 * q;
          } else {
            q = fmaf(acc[h][s][c], acc[h][s][c], q);
            mid[s][c] = pk.s1 * acc[h][s][c];
          }
        }
      }
#pragma unroll
      for (int s = 0; s < SS; ++s) {
        *reinterpret_cast<float4*>(out + o0 + s * sT) =
            make_float4(mid[s][0], mid[s][1], mid[s][2], mid[s][3]);
        if (save)
          *reinterpret_cast<float4*>(save + o0 + s * sT) =
              make_float4(acc[h][s][0], acc[h][s][1], acc[h][s][2], acc[h][s][3]);
      }
    }
  }
}

// stage_bwd (backward through the last hidden stage's nonlinearity from the
// rank-one cotangent ct * wl), two entries per pass.
__device__ __forceinline__ void stage_bwd_p(const Net& net, int T, int k, const float* pre,
                                            const float* ct, const float* wl, int wl_cols,
                                            float* dpre) {
  const int d = net.d, ld = net.wmax, sT = T * ld;
  // two entries per pass, their reads first (header note)
  for (UnitWalk w(net, k); w.p < T;) {
    int pe[2], o0[2];
    bool on[2];
    float wj[2];
    pe[0] = w.p;
    o0[0] = w.p * ld + w.j;
    wj[0] = w.j >= wl_cols ? 0.f : wl[w.j];
    on[0] = true;
    w.next();
    on[1] = w.p < T;
    pe[1] = on[1] ? w.p : pe[0];
    o0[1] = on[1] ? w.p * ld + w.j : o0[0];
    wj[1] = on[1] ? (w.j >= wl_cols ? 0.f : wl[w.j]) : wj[0];
    if (on[1]) w.next();
    Pack pk[2];
    float dv[2], dq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pk[h] = act_pack(net.act, pre[o0[h]]);
      dv[h] = pk[h].s1 * (ct[pe[h]] * wj[h]);
      dq[h] = 0.f;
    }
    if (net.lap) {
      float q[2] = {0.f, 0.f};
#pragma unroll 1
      for (int i = 0; i < d; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float Ji = pre[o0[h] + (1 + i) * sT];
          q[h] = fmaf(Ji, Ji, q[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ol = o0[h] + (d + 1) * sT;
        const float dlm = ct[(d + 1) * T + pe[h]] * wj[h];
        if (on[h]) dpre[ol] = pk[h].s1 * dlm;
        dq[h] = pk[h].s2 * dlm;
        dv[h] += (pk[h].s2 * pre[ol] + pk[h].s3 * q[h]) * dlm;
      }
    }
#pragma unroll 1
    for (int i = 0; i < d; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0[h] + (1 + i) * sT;
        const float Ji = pre[o];
        const float dJm = ct[(1 + i) * T + pe[h]] * wj[h];
        dv[h] += pk[h].s2 * Ji * dJm;
        if (on[h]) dpre[o] = pk[h].s1 * dJm + 2.0f * Ji * dq[h];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (on[h]) dpre[o0[h]] = dv[h];
  }
}

// mm_act_bwd (dmid = D W^T for every stream of point p at units j0..j0+3,
// and stage_mid_bwd's arithmetic in the epilogue on the thread's own
// entries, whose saved values it copies back while it multiplies) with NP
// points per item.
template <int NP, int SS>
__device__ __forceinline__ void mm_act_bwdp(const Net& net, int T, const float* __restrict__ D,
                                            int kdim, const float* __restrict__ Wt, int ncols,
                                            const float* __restrict__ saved,
                                            float* __restrict__ pre, float* __restrict__ x) {
  if constexpr (NP == 1) {
    mm_act_bwd<SS>(net, T, D, kdim, Wt, ncols, saved, pre, x);
    return;
  }
  const int ld = net.wmax, sT = T * ld;
  const int cg = ncols >> 2, items = (T / NP) * cg;
  for (int it = threadIdx.x; it < items; it += NT) {
    const int pg = it / cg;
    const int j0 = (it - pg * cg) << 2;
    const int p0 = pg * NP;
#pragma unroll
    for (int h = 0; h < NP; ++h)
#pragma unroll
      for (int s = 0; s < SS; ++s) {
        const int o = (p0 + h) * ld + j0 + s * sT;
        __pipeline_memcpy_async(pre + o, saved + o, 16);
      }
    __pipeline_commit();
    float acc[NP][SS][4] = {};
    for (int k = 0; k < kdim; k += 4) {
      float4 a[NP][SS];
#pragma unroll
      for (int h = 0; h < NP; ++h)
#pragma unroll
        for (int s = 0; s < SS; ++s)
          a[h][s] = *reinterpret_cast<const float4*>(D + (p0 + h) * ld + s * sT + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w = *reinterpret_cast<const float4*>(Wt + (k + kk) * ncols + j0);
#pragma unroll
        for (int h = 0; h < NP; ++h)
#pragma unroll
          for (int s = 0; s < SS; ++s) {
            const float xv = lane(a[h][s], kk);
            acc[h][s][0] = fmaf(xv, w.x, acc[h][s][0]);
            acc[h][s][1] = fmaf(xv, w.y, acc[h][s][1]);
            acc[h][s][2] = fmaf(xv, w.z, acc[h][s][2]);
            acc[h][s][3] = fmaf(xv, w.w, acc[h][s][3]);
          }
      }
    }
    __pipeline_wait_prior(0);
#pragma unroll
    for (int h = 0; h < NP; ++h) {
      const int o0 = (p0 + h) * ld + j0;
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
        float dv = pk.s1 * acc[h][0][c];
        float dq = 0.f;
        if (net.lap) {
          const float l = pv[SS - 1][c], dlm = acc[h][SS - 1][c];
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
          const float Ji = pv[s][c], dJm = acc[h][s][c];
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
}

// accum_dW (dW[i][j] += sum_r M[r][i] D[r][j] over `rows` rows, db[j] +=
// the sum of D's value rows) with the 4 x 4 items dealt to each warp as 4
// row groups (i) x 8 column groups (j): a row of M is 4 float4s and one of D
// 8 float4s per warp, one shared-memory wavefront each.  Each item's sum
// runs over the rows in order, as accum_dW's.  `narrow` takes accum_dW's
// lane-group path.
__device__ __forceinline__ void accum_dW_p(int rows, int T, int ld, int wi, int wo, int wip,
                                           int wop, const float* M, const float* D,
                                           float* dW, float* db, bool narrow) {
  const int IG = wip >> 2, JG = wop >> 2;
  if (narrow && 2 * IG * JG <= NT) {
    accum_dW(rows, T, ld, wi, wo, wip, wop, M, D, dW, db, true);
    return;
  }
  const int TJ = (JG + 7) >> 3;
  const int items = ((IG + 3) >> 2) * TJ * 32;
  const int lane_id = threadIdx.x & 31;
  for (int it0 = threadIdx.x - lane_id; it0 < items; it0 += NT) {
    const int t = it0 >> 5;
    const int ti = t / TJ, tj = t - ti * TJ;
    const int ig = ti * 4 + (lane_id >> 3), jg = tj * 8 + (lane_id & 7);
    if (ig >= IG || jg >= JG) continue;
    const int i0 = ig << 2, j0 = jg << 2;
    float acc[4][4] = {};
    for (int r = 0; r < rows; ++r) {
      const float4 m = *reinterpret_cast<const float4*>(M + r * ld + i0);
      const float4 dv = *reinterpret_cast<const float4*>(D + r * ld + j0);
      const float mm[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q][0] = fmaf(mm[q], dv.x, acc[q][0]);
        acc[q][1] = fmaf(mm[q], dv.y, acc[q][1]);
        acc[q][2] = fmaf(mm[q], dv.z, acc[q][2]);
        acc[q][3] = fmaf(mm[q], dv.w, acc[q][3]);
      }
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

// Stage every hidden W_k into W and its transpose, from `wt`, into Wt once
// (the planned tiers' Resident).  Completes at copy_wait().
__device__ inline void stage_resident_p(const Net& net, const float* __restrict__ params,
                                        const float* __restrict__ wt, float* W, float* Wt) {
  int woff = 0;
  for (int k = 1; k < net.K - 1; ++k) {
    const int wk = net.w[k], wn = net.w[k + 1], wkp = net.wp[k], wnp = net.wp[k + 1];
    stage_weights(net, W + woff, params + net.off[k], wk, wn, wkp, wnp);
    stage_weights(net, Wt + woff, wt + tpos(net, k), wn, wk, wnp, wkp);
    woff += wkp * wnp;
  }
}

// fwd_recompute in design DES (header note), with the plan's residency
// (`res`) taken at run time.  SAVE = false, the forward-only mode of the
// jet forward and the quotient sums: no stage is saved, and `last` and
// `scratch` are not read; every `save` below is then a compile-time null,
// so its stores are compiled out, not branched over per entry.
template <bool FOLD, int DES, bool SAVE = true>
__device__ inline void fwd_recompute_p(const Net& net, int T, const float* __restrict__ xs,
                                       const float* __restrict__ params, float*& cur,
                                       float*& nxt, float* last, float* Wsh, float* scratch,
                                       const Resident& res) {
  constexpr int NP = (DES & DES_ITEM2) ? 2 : 1;
  const int d = net.d, ld = net.wmax, S = net.S;
  const int sT = T * ld, stage_sz = S * sT;
  const float* resW = res.W;
  int woff = 0;                 // offset of W_k in the resident matrices
  if (FOLD && !resW && net.K > 2)   // W_1 lands while the input layer runs
    stage_weights(net, Wsh, params + net.off[1], net.w[1], net.w[2], net.wp[1], net.wp[2]);
  {  // input layer: v = x W0 + b0; J_i = W0[i, :]; l = 0 (padded units 0)
    const int w1 = net.w[1];
    const float* W0 = params + net.off[0];
    const float* b0 = W0 + d * w1;
    float* save = SAVE ? (net.K == 2 ? last : scratch) : nullptr;
    if constexpr (FOLD) {
      // and stage 1's activation (stage_mid's arithmetic), two entries per
      // pass; FOLD means S <= 4, so d <= 3
      constexpr int DF = 3;
      for (UnitWalk w(net, 1); w.p < T;) {
        int pe[2], je[2];
        bool on[2];
        pe[0] = w.p;
        je[0] = w.j;
        on[0] = true;
        w.next();
        on[1] = w.p < T;
        pe[1] = on[1] ? w.p : pe[0];
        je[1] = on[1] ? w.j : je[0];
        if (on[1]) w.next();
        float v[2], J[2][DF];
        Pack pk[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool real = je[h] < w1;
          v[h] = 0.f;
#pragma unroll
          for (int i = 0; i < DF; ++i) {
            J[h][i] = (i < d && real) ? W0[i * w1 + je[h]] : 0.f;
            if (i < d) v[h] = fmaf(xs[pe[h] * d + i], J[h][i], v[h]);
          }
          v[h] = real ? v[h] + b0[je[h]] : 0.f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) pk[h] = act_pack(net.act, v[h]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!on[h]) continue;
          const int o0 = pe[h] * ld + je[h];
          if (save) save[o0] = v[h];
          cur[o0] = pk[h].s0;
          float q = 0.f;
#pragma unroll
          for (int i = 0; i < DF; ++i) {
            if (i >= d) break;
            const int o = o0 + (1 + i) * sT;
            if (save) save[o] = J[h][i];
            q = fmaf(J[h][i], J[h][i], q);
            cur[o] = pk[h].s1 * J[h][i];
          }
          if (net.lap) {
            const int o = o0 + (d + 1) * sT;
            if (save) save[o] = 0.f;
            cur[o] = pk[h].s1 * 0.f + pk[h].s2 * q;
          }
        }
      }
    } else {
      for (UnitWalk w(net, 1); w.p < T; w.next()) {
        const int p = w.p, j = w.j, o0 = p * ld + j;
        const bool real = j < w1;
        float v = 0.f;
#pragma unroll 1
        for (int i = 0; i < d; ++i) {
          const float wij = real ? W0[i * w1 + j] : 0.f;
          v = fmaf(xs[p * d + i], wij, v);
          cur[o0 + (1 + i) * sT] = wij;
        }
        cur[o0] = real ? v + b0[j] : 0.f;
        if (net.lap) cur[o0 + (d + 1) * sT] = 0.f;
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
      float* save = !SAVE ? nullptr
                    : k + 1 == net.K - 1 ? last : scratch ? scratch + k * stage_sz : nullptr;
      const float* Wm = resW ? resW + woff : Wsh;
      if (S == 2)
        mm_actp<NP, 2>(net, T, cur, wkp, Wm, wnp, Wk + wk * wn, wn, nxt, save);
      else if (S == 3)
        mm_actp<NP, 3>(net, T, cur, wkp, Wm, wnp, Wk + wk * wn, wn, nxt, save);
      else                                // S == 4 (the launch checks S <= 4)
        mm_actp<NP, 4>(net, T, cur, wkp, Wm, wnp, Wk + wk * wn, wn, nxt, save);
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
              !SAVE ? nullptr
              : final_stage ? last : scratch ? scratch + (k - 1) * stage_sz : nullptr);
    if (final_stage) break;
    const int wn = net.w[k + 1];
    const float* Wk = params + net.off[k];
    if (!resW) copy_wait();
    __syncthreads();
    mm_rows_p<NP == 2 ? 8 : 4>(cur, ld, S * T, wkp, resW ? resW + woff : Wsh, net.wp[k + 1],
                               nxt, Wk + wk * wn, T, wn);
    woff += wkp * net.wp[k + 1];
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }
  __syncthreads();
}

// reverse_sweep in design DES (header note).  `wt`: the hidden weights'
// transposes in device memory (tpos).  On entry Wsh is free (the forward is
// done); each stage's W^T is staged while the previous stage's dW products
// run.
template <bool FOLD, int DES>
__device__ inline void reverse_sweep_p(const Net& net, int T, const float* __restrict__ xs,
                                       const float* __restrict__ params,
                                       const float* __restrict__ wt, float* cur, float* nxt,
                                       float* pre, float* Wsh, const float* scratch,
                                       const float* ct, float* red, float* grow,
                                       const Resident& res) {
  constexpr int NP = (DES & DES_ITEM2) ? 2 : 1;
  const int d = net.d, ld = net.wmax, S = net.S, K = net.K;
  const int stage_sz = S * T * ld;
  const int wl = net.w[K - 1];
  const float* wlast = params + net.off[K - 1];
  const float* resWt = res.Wt;
  const bool narrow = res.narrow;
  // the last hidden layer's W^T lands while the last stage runs
  if (!resWt && K > 2)
    stage_weights(net, Wsh, wt + tpos(net, K - 2), net.w[K - 1], net.w[K - 2], net.wp[K - 1],
                  net.wp[K - 2]);
  // dWlast[j] += sum_r mid[r][j] * ct[r] over the S*T rows r = (s, p):
  // `parts` threads per column, each over every parts-th row, then the
  // partial sums are added in a fixed order.  DES_BEYOND at a width above
  // NT: one thread per column (j, j + NT, ...), every row in order
  if ((DES & DES_BEYOND) && wl > NT) {
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
  stage_bwd_p(net, T, K - 1, pre, ct, wlast, wl, nxt);
  if (!resWt) copy_wait();
  __syncthreads();
  // Stage k, three buffers in rotation: D holds the cotangent of stage
  // k+1's pre-activation streams, X takes dmid = D W_k^T and then the mid
  // streams, P takes the saved pre-activations and then their cotangent,
  // which is the next stage's D.
  float* D = nxt;
  float* X = cur;
  float* P = pre;
  int woff = resWt ? hidden_floats(net) : 0;   // offset of W_k^T in the resident matrices
  for (int k = K - 2; k >= 1; --k) {
    const int wk = net.w[k], wn = net.w[k + 1];
    const int wkp = net.wp[k], wnp = net.wp[k + 1];
    woff -= wkp * wnp;
    const float* Wm = resWt ? resWt + woff : Wsh;
    const float* saved = scratch + (k - 1) * stage_sz;
    if constexpr (FOLD) {
      // dmid = D W^T and the stage's nonlinearity in one pass, each thread
      // copying back the saved entries it reads
      if (S == 2)
        mm_act_bwdp<NP, 2>(net, T, D, wnp, Wm, wkp, saved, P, X);
      else if (S == 3)
        mm_act_bwdp<NP, 3>(net, T, D, wnp, Wm, wkp, saved, P, X);
      else                                // S == 4
        mm_act_bwdp<NP, 4>(net, T, D, wnp, Wm, wkp, saved, P, X);
      __syncthreads();
    } else {
      copy_async(P, saved, stage_sz);
      // dmid = D W^T
      mm_rows_p<NP == 2 ? 8 : 4>(D, ld, S * T, wnp, Wm, wkp, X, nullptr, 0, 0);
      copy_wait();
      __syncthreads();
      stage_mid_bwd(net, T, k, P, X);
      __syncthreads();
    }
    // W_{k-1}^T lands while this stage's dW products run
    if (!resWt && k > 1)
      stage_weights(net, Wsh, wt + tpos(net, k - 1), wk, net.w[k - 1], wkp, net.wp[k - 1]);
    float* dW = grow + net.off[k];
    accum_dW_p(S * T, T, ld, wk, wn, wkp, wnp, X, D, dW, dW + wk * wn, narrow);
    if (!resWt && k > 1) copy_wait();
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

}  // namespace fwdlap
