// The consumer side of the warp-specialised flash-attention backward, dQ
// and dK/dV (flash_attn_bwd.cu), on wgmma.  Written against ring stages and
// barriers only: the dense backward's producers, which stream every tile,
// and the sparse backward's, which walk the mask's lists, feed the same
// consumers.
//
// Function (the TPU kernels'): the forward's scores are recomputed and p
// taken from the saved LSE in base 2, with each row's statistics
//   lse2 = (lse - bias) * log2e (+inf for a row past lq or an empty row),
//   rest = g_lse - delta,
//   p  = exp2(s * scale * log2e - lse2),   ds = p * (dO . v^T + rest),
//   dq = scale * ds . K,   dk = scale * ds^T . Q,   dv = p^T . dO,
// p and ds rounded to bf16 before each product, f32 accumulators.
//
// A consumer warpgroup owns 64 rows of the CTA's resident side, in column
// blocks of 128 rows x 128 bytes (128-byte swizzle, as the forward's Q):
//   * dQ: 64 query rows of Q and dO.  Ring stage: BN keys of K and of V
//     (column blocks of BN rows).  S = Q K^T and dP = dO V^T are wgmma with
//     both operands K-major in shared memory; ds goes to bf16 A fragments
//     in registers and dQ += dS K reads K MN-major from the same stage.
//   * dK/dV: 64 keys of K and V.  Ring stage: BQ query rows of Q and dO and
//     their lse2 / rest.  S^T = K Q^T and dP^T = V dO^T, so the key is the
//     accumulator's row and dK, dV accumulate in registers untransposed;
//     dV += P^T dO and dK += dS^T Q read dO and Q MN-major from the stage.
// dQ's consumers derive their rows' lse2 / rest once from global memory;
// dK/dV's read them from each stage, where the producer warpgroup puts them
// (flash_attn_bwd.cu).  Each stage is released by one arrival a consumer
// warp on its empty barrier.
#pragma once

#include "flash_wgmma.cuh"

namespace bt {
namespace bwd {

// dQ tile, in place: dp becomes ds (f32, accumulator layout) of this
// thread's rows g (lse2 l0, rest rr0) and g + 8 (l1, rr1); key columns at
// or past `nvalid` get p = 0 (a zero-filled key scores 0, not -inf).
template <int BN>
__device__ __forceinline__ void dq_ds(const float (&s)[BN / 2], float (&dp)[BN / 2], float c,
                                      float l0, float l1, float rr0, float rr1, int nvalid) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = nvalid >= BN || j * 8 + 2 * t + e < nvalid;
      const float p0 = live ? exp2_approx(fmaf(s[4 * j + e], c, -l0)) : 0.f;
      const float p1 = live ? exp2_approx(fmaf(s[4 * j + 2 + e], c, -l1)) : 0.f;
      dp[4 * j + e] = p0 * (dp[4 * j + e] + rr0);
      dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] + rr1);
    }
}

// lse2 and rest of one row from its raw statistics: lse2 = +inf for a dead
// row (`live` false: past lq) or an empty one, so that p = 0.
__device__ __forceinline__ void row_stats(float lse, float delta, float glse, bool live,
                                          float bias, float& lse2, float& rest) {
  lse2 = live && lse > EMPTY_LSE ? (lse - bias) * LOG2E : INFINITY;
  rest = glse - delta;
}

// dK/dV tile, in place: s^T becomes p^T and dp^T becomes ds^T; the query
// column 8 j + 2 t + e takes lse2[col] and rest[col] from the stage, and a
// key row past lk (kv0 / kv1 false) gets p = 0.
template <int BQ>
__device__ __forceinline__ void dkv_p_ds(float (&s)[BQ / 2], float (&dp)[BQ / 2], float c,
                                         const float* lse2, const float* rest, bool kv0,
                                         bool kv1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + j * 8 + 2 * t);
    const float2 r = *reinterpret_cast<const float2*>(rest + j * 8 + 2 * t);
    const float p00 = kv0 ? exp2_approx(fmaf(s[4 * j], c, -l.x)) : 0.f;
    const float p01 = kv0 ? exp2_approx(fmaf(s[4 * j + 1], c, -l.y)) : 0.f;
    const float p10 = kv1 ? exp2_approx(fmaf(s[4 * j + 2], c, -l.x)) : 0.f;
    const float p11 = kv1 ? exp2_approx(fmaf(s[4 * j + 3], c, -l.y)) : 0.f;
    dp[4 * j] = p00 * (dp[4 * j] + r.x);
    dp[4 * j + 1] = p01 * (dp[4 * j + 1] + r.y);
    dp[4 * j + 2] = p10 * (dp[4 * j + 2] + r.x);
    dp[4 * j + 3] = p11 * (dp[4 * j + 3] + r.y);
    s[4 * j] = p00;
    s[4 * j + 1] = p01;
    s[4 * j + 2] = p10;
    s[4 * j + 3] = p11;
  }
}

// One dQ consumer warpgroup's walk over n_tiles >= 1 ring tiles (tile i in
// stage i % STAGES, phase (i / STAGES) & 1; K of stage s at k_r + s * BN D
// 2, V at v_r + s * BN D 2; full barrier full + 8 s).  q_wg / do_wg: the
// warpgroup's rows in column block 0 of the resident Q / dO.  nvalid(i,
// stage) gives tile i's count of live leading key columns.  The next tile's
// S and dP are issued before the current tile's dQ += dS K, and its ds
// computed while that runs.
template <int D, int BN, int STAGES, class Valid>
__device__ __forceinline__ void consume_dq(float (&dq)[D / 2], uint32_t q_wg, uint32_t do_wg,
                                           uint32_t k_r, uint32_t v_r, uint32_t full,
                                           uint32_t empty, int n_tiles, float c, float l0,
                                           float l1, float rr0, float rr1, Valid nvalid) {
  constexpr int KV = BN * D * 2;
  const int lane = threadIdx.x & 31;
  float s[BN / 2], dp[BN / 2];
  uint32_t ds[BN / 16][4];

  mbar_wait(full, 0);
  wgmma_fence();
  issue_scores<D, BN>(s, q_wg, k_r);
  issue_scores<D, BN>(dp, do_wg, v_r);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  dq_ds<BN>(s, dp, c, l0, l1, rr0, rr1, nvalid(0, 0));
  to_a_frags<BN>(dp, ds);
  int ps = 0, pph = 0;  // ring stage and phase of the tile whose ds is in ds
  for (int it = 1; it < n_tiles; ++it) {
    int stage = ps + 1, phase = pph;
    if (stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    mbar_wait(full + 8 * stage, phase);
    fence_regs(s);
    fence_regs(dp);
    fence_regs(dq);
    fence_regs(ds);
    wgmma_fence();
    issue_scores<D, BN>(s, q_wg, k_r + stage * KV);
    issue_scores<D, BN>(dp, do_wg, v_r + stage * KV);
    issue_pv<BN, D>(dq, ds, k_r + ps * KV);
    wgmma_wait<1>();  // S and dP are in; dQ += dS K may still run
    fence_regs(s);
    fence_regs(dp);
    dq_ds<BN>(s, dp, c, l0, l1, rr0, rr1, nvalid(it, stage));
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(ds);
    if (lane == 0) mbar_arrive(empty + 8 * ps);
    to_a_frags<BN>(dp, ds);
    ps = stage;
    pph = phase;
  }
  fence_regs(dq);
  fence_regs(ds);
  wgmma_fence();
  issue_pv<BN, D>(dq, ds, k_r + ps * KV);
  wgmma_wait<0>();
  fence_regs(dq);
  if (lane == 0) mbar_arrive(empty + 8 * ps);
}

// One dK/dV consumer warpgroup's walk over n_tiles >= 1 ring tiles, the
// first in stage 0 at phase 0: Q of stage s at q_r + s * BQ D 2, dO at do_r
// + s * BQ D 2, its rows' lse2 at stats + s * stat_floats and rest BQ
// further.  A stage is ready when both its loads (raw + 8 s) and its
// statistics (full + 8 s) are.  k_wg / v_wg: the warpgroup's 64 keys in
// column block 0 of the resident K / V; kv0 / kv1: whether this thread's
// rows g, g + 8 are keys below lk.  A tile's four products run back to back
// (the two consumer warpgroups interleave on the tensor cores): keeping a
// second tile's S^T and dP^T beside dK, dV and the bf16 fragments spills at
// d = 128.
template <int D, int BQ, int STAGES>
__device__ __forceinline__ void consume_dkv(float (&dk)[D / 2], float (&dv)[D / 2],
                                            uint32_t k_wg, uint32_t v_wg, uint32_t q_r,
                                            uint32_t do_r, const float* stats, int stat_floats,
                                            uint32_t raw, uint32_t full, uint32_t empty,
                                            int n_tiles, float c, bool kv0, bool kv1) {
  constexpr int QT = BQ * D * 2;
  const int lane = threadIdx.x & 31;
  float s[BQ / 2], dp[BQ / 2];
  uint32_t pf[BQ / 16][4], df[BQ / 16][4];
  int stage = 0, phase = 0;
  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(raw + 8 * stage, phase);
    mbar_wait(full + 8 * stage, phase);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_scores<D, BQ>(s, k_wg, q_r + stage * QT);
    issue_scores<D, BQ>(dp, v_wg, do_r + stage * QT);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const float* st = stats + stage * stat_floats;
    dkv_p_ds<BQ>(s, dp, c, st, st + BQ, kv0, kv1);
    to_a_frags<BQ>(s, pf);
    to_a_frags<BQ>(dp, df);
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pf);
    fence_regs(df);
    wgmma_fence();
    issue_pv<BQ, D>(dv, pf, do_r + stage * QT);
    issue_pv<BQ, D>(dk, df, q_r + stage * QT);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// This thread's part of rows r0 and r1 (< nrows) of a 64 x D accumulator,
// times `mul`, into bf16 rows of stride D at `out`.
template <int D>
__device__ __forceinline__ void store_acc_rows(const float (&a)[D / 2], bf16* out, int r0,
                                               int r1, int nrows, float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * D + col) =
          __floats2bfloat162_rn(a[4 * j] * mul, a[4 * j + 1] * mul);
    if (r1 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r1 * D + col) =
          __floats2bfloat162_rn(a[4 * j + 2] * mul, a[4 * j + 3] * mul);
  }
}

}  // namespace bwd
}  // namespace bt
