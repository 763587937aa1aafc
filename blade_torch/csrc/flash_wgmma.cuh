// The consumer side of the two warp-specialised flash-attention forwards,
// the dense kernel (flash_attn.cu) and the gather kernel (gather_attn.cu,
// which also serves the fused multi-level forward).
//
// A CTA of 384 threads: warpgroup 0 is the producer (TMA loads of Q once
// and of K/V tiles into a ring of STAGES stages with full mbarriers, K and V
// apart, and empty mbarriers); warpgroups 1 and 2 are consumers of 64 query
// rows each.  S = Q K^T is a wgmma with both operands in 128-byte-swizzled
// shared memory (K-major); the online softmax runs on the accumulator
// fragment in registers; P is rounded to bf16 in registers and is the
// register A operand of O += P V, whose B (V) is read from shared memory
// MN-major.  Within a warpgroup the next tile's Q K^T is issued before the
// current tile's P V and its softmax runs while P V is in flight.
//
// Ring stage s: K at k_s + s * BN * D * 2 and V at v_s + s * BN * DVC * 2,
// each as column blocks of BN rows x 128 bytes; barriers k_full + 8 s,
// v_full + 8 s and empty + 8 s (8 arrivals: one a consumer warp).
#pragma once

#include "hopper.cuh"

namespace bt {

// S (64 x BN) = Q (this warpgroup's 64 rows) K^T, issued and committed.
// q_wg: the warpgroup's rows in column block 0 of Q (column blocks of 128
// rows x 128 bytes); k: one ring stage (column blocks of BN rows).
template <int D, int BN>
__device__ __forceinline__ void issue_scores(float (&s)[BN / 2], uint32_t q_wg, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qa = q_wg + (kk / 4) * (128 * 128) + (kk % 4) * 32;
    const uint32_t kb = k + (kk / 4) * (BN * 128) + (kk % 4) * 32;
    wgmma_ss<BN>(s, desc_sw128(qa, 1, 64), desc_sw128(kb, 1, 64), kk > 0);
  }
  wgmma_commit();
}

// O (64 x DVC) += P (64 x BN, bf16 A fragments) V (BN x DVC), issued and
// committed.  v: one ring stage (column blocks of BN rows x 64 columns).
template <int BN, int DVC>
__device__ __forceinline__ void issue_pv(float (&o)[DVC / 2], const uint32_t (&p)[BN / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<DVC>(o, p[kk], desc_sw128(v + kk * 16 * 128, BN * 8, 64));
  wgmma_commit();
}

// Fold the raw scores of one tile into the carry: keys at or past `nvalid`
// score -inf, s becomes p = 2^(s c + b - m) in place (f32), m and l
// advance, and (a0, a1) is the factor by which rows g and g + 8 of O must
// shrink.  `b` is the tile's base-2 score bias, read only when BIAS.
template <int BN, bool BIAS = false>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2], float& m0, float& m1,
                                               float& l0, float& l1, float& a0, float& a1,
                                               float c, int nvalid, float b = 0.f) {
  const int t = threadIdx.x & 3;
  if (nvalid < BN) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j * 8 + 2 * t + e >= nvalid) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  float mn0, mn1;
  if constexpr (BIAS) {
    mn0 = fmaxf(m0, fmaf(mx0, c, b));
    mn1 = fmaxf(m1, fmaf(mx1, c, b));
  } else {
    mn0 = fmaxf(m0, mx0 * c);
    mn1 = fmaxf(m1, mx1 * c);
  }
  // A row with no live key so far keeps m = -inf; subtract 0 instead so
  // exp2 sees -inf (-> 0) and never -inf - -inf.
  const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
  const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
  a0 = exp2_approx(m0 - ms0);
  a1 = exp2_approx(m1 - ms1);
  float off0 = -ms0, off1 = -ms1;
  if constexpr (BIAS) {
    off0 = b - ms0;
    off1 = b - ms1;
  }
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    s[4 * j] = exp2_approx(fmaf(s[4 * j], c, off0));
    s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], c, off0));
    s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], c, off1));
    s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], c, off1));
    ps0 += s[4 * j] + s[4 * j + 1];
    ps1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
  m0 = mn0;
  m1 = mn1;
}

// p (f32, accumulator layout) -> bf16 A fragments of P @ V: the fragment of
// key columns 16kk .. 16kk + 15 is n8 blocks 2kk and 2kk + 1.
template <int BN>
__device__ __forceinline__ void to_a_frags(const float (&s)[BN / 2], uint32_t (&p)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// No score bias: the dense kernel and the one-list gather kernel.
struct NoScoreBias {
  static constexpr bool kOn = false;
  __device__ __forceinline__ float operator()(int) const { return 0.f; }
};

// One consumer warpgroup's walk over n_tiles >= 1 ring tiles (tile i in
// stage i % STAGES, phase (i / STAGES) & 1), after Q has arrived: O, m and
// l accumulate the base-2 online softmax.  `mask(i, stage, s)` sees tile
// i's raw scores first, may set dead columns to -inf, and returns the
// count of live leading columns (BN when it masked them itself).  When
// Bias::kOn, `bias(stage)` is the tile's base-2 score bias.
template <int D, int BN, int DVC, int STAGES, class Mask, class Bias = NoScoreBias>
__device__ __forceinline__ void consume_tiles(float (&o)[DVC / 2], float& m0, float& m1,
                                              float& l0, float& l1, uint32_t q_wg,
                                              uint32_t k_s, uint32_t v_s, uint32_t k_full,
                                              uint32_t v_full, uint32_t empty, int n_tiles,
                                              float c, Mask mask, Bias bias = Bias()) {
  constexpr int K_BYTES = BN * D * 2, V_BYTES = BN * DVC * 2;
  const int lane = threadIdx.x & 31;
  float s[BN / 2], a0, a1;
  uint32_t p[BN / 16][4];

  // Tile 0: scores, softmax, P.
  mbar_wait(k_full, 0);
  wgmma_fence();
  issue_scores<D, BN>(s, q_wg, k_s);
  wgmma_wait<0>();
  fence_regs(s);
  online_softmax<BN, Bias::kOn>(s, m0, m1, l0, l1, a0, a1, c, mask(0, 0, s), bias(0));
  to_a_frags<BN>(s, p);
  int ps = 0, pph = 0;  // ring stage and phase of the tile whose P is in p
  for (int it = 1; it < n_tiles; ++it) {
    int stage = ps + 1, phase = pph;
    if (stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    mbar_wait(k_full + 8 * stage, phase);
    fence_regs(s);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_scores<D, BN>(s, q_wg, k_s + stage * K_BYTES);
    mbar_wait(v_full + 8 * ps, pph);
    issue_pv<BN, DVC>(o, p, v_s + ps * V_BYTES);
    wgmma_wait<1>();  // the scores are in; P @ V may still run
    fence_regs(s);
    online_softmax<BN, Bias::kOn>(s, m0, m1, l0, l1, a0, a1, c, mask(it, stage, s),
                                  bias(stage));
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if (lane == 0) mbar_arrive(empty + 8 * ps);
#pragma unroll
    for (int j = 0; j < DVC / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    to_a_frags<BN>(s, p);
    ps = stage;
    pph = phase;
  }
  mbar_wait(v_full + 8 * ps, pph);
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
  issue_pv<BN, DVC>(o, p, v_s + ps * V_BYTES);
  wgmma_wait<0>();
  fence_regs(o);
  if (lane == 0) mbar_arrive(empty + 8 * ps);
}

// Normalise the carry and write this thread's part of rows r0 and r1:
// out columns [col0, col0 + DVC) (row stride dv, `out` the head's first
// row) and, when write_lse, the natural-log lse plus `bias` (-1e30 for a
// row with no live key, whose out is 0).
template <int DVC>
__device__ __forceinline__ void store_rows_wg(const float (&o)[DVC / 2], float m0, float m1,
                                              float l0, float l1, bf16* out, float* lse, int r0,
                                              int r1, int lq, int dv, int col0, bool write_lse,
                                              float bias) {
  const int t = threadIdx.x & 3;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int j = 0; j < DVC / 8; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (r0 < lq)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * dv + col) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < lq)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r1 * dv + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  if (write_lse && t == 0) {
    if (r0 < lq) lse[r0] = l0 > 0.f ? m0 * LN2 + bias + logf(l0) : NEG_INF_LSE;
    if (r1 < lq) lse[r1] = l1 > 0.f ? m1 * LN2 + bias + logf(l1) : NEG_INF_LSE;
  }
}

}  // namespace bt
