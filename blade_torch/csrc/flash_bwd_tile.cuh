// The flash-attention backward tiles of pooled_level_bwd.cu (the pooled
// segments' backward, still on mma.sync; the 128-row backward is on wgmma
// in flash_attn_bwd.cu).  The forward's scores and softmax are recomputed
// from the saved natural-log LSE in base 2,
//   p  = exp2(s * scale * log2e - (lse - bias) * log2e),
//   ds = p * (dO . v^T + g_lse - delta),   delta = rowsum(dO * O),
//   dq = scale * ds . k,  dk = scale * ds^T . q,  dv = p^T . dO,
// with p and ds rounded to bf16 before each product, as the TPU kernels feed
// the MXU; every product on mma.sync m16n8k16 bf16 tensor cores with f32
// accumulators in registers.  A row whose LSE is the empty-row marker
// (-1e30) is treated as empty (p = 0): exp2 never sees that LSE.
//
// dQ (dq_tile): a CTA of 4 warps owns 64 query rows (16 a warp), q and dO
// in registers as A fragments; 64-key K and V tiles stream through shared
// memory.  dK/dV (dkv_tile): a CTA owns 64 keys (16 a warp), computes the
// transposed scores s^T = K . Q^T so the key dimension is the MMA's row
// dimension and dK, dV accumulate in registers without a transpose; 64-row
// query tiles (q, dO and the row statistics) stream through shared memory.
#pragma once

#include "flash_tile.cuh"

namespace bt {
namespace bwd {

// rows [0, nvalid) of a 64 x W tile (row stride `ld` elements) into shared
// memory rows of stride W + 8; rows past nvalid are zero-filled.
template <int W>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t ld,
                                          int nvalid) {
  constexpr int VPR = W / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (W + 8) + c * 8) = val;
  }
}

// Base-2 LSE of a row, shifted by the bias; +inf marks a row that must
// contribute nothing (past lq, or empty), so exp2(x - inf) = 0.
__device__ __forceinline__ float row_lse2(const float* lse, int r, int lq, float bias) {
  if (r >= lq) return INFINITY;
  const float l = lse[r];
  return l <= EMPTY_LSE ? INFINITY : (l - bias) * LOG2E;
}

__device__ __forceinline__ float row_rest(const float* delta, const float* glse, int r,
                                          int lq) {
  return r < lq ? glse[r] - delta[r] : 0.f;
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
struct DqState {
  uint32_t qf[D / 16][4];
  uint32_t dof[D / 16][4];
  float dq[D / 8][4];
  float lse2[2];  // rows g, g + 8
  float rest[2];
};

// This warp's rows r0, r1 of q and dO (one head; rows past lq read as 0)
// into A fragments, their statistics, and a zero dq.
template <int D>
__device__ __forceinline__ void init_dq(DqState<D>& st, const bf16* qb, const bf16* db,
                                        const float* lse_b, const float* delta_b,
                                        const float* glse_b, int r0, int r1, int lq,
                                        float bias) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + 2 * t;
    st.qf[kk][0] = r0 < lq ? ld_u32(qb + (size_t)r0 * D + col) : 0u;
    st.qf[kk][1] = r1 < lq ? ld_u32(qb + (size_t)r1 * D + col) : 0u;
    st.qf[kk][2] = r0 < lq ? ld_u32(qb + (size_t)r0 * D + col + 8) : 0u;
    st.qf[kk][3] = r1 < lq ? ld_u32(qb + (size_t)r1 * D + col + 8) : 0u;
    st.dof[kk][0] = r0 < lq ? ld_u32(db + (size_t)r0 * D + col) : 0u;
    st.dof[kk][1] = r1 < lq ? ld_u32(db + (size_t)r1 * D + col) : 0u;
    st.dof[kk][2] = r0 < lq ? ld_u32(db + (size_t)r0 * D + col + 8) : 0u;
    st.dof[kk][3] = r1 < lq ? ld_u32(db + (size_t)r1 * D + col + 8) : 0u;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) st.dq[n][0] = st.dq[n][1] = st.dq[n][2] = st.dq[n][3] = 0.f;
  st.lse2[0] = row_lse2(lse_b, r0, lq, bias);
  st.lse2[1] = row_lse2(lse_b, r1, lq, bias);
  st.rest[0] = row_rest(delta_b, glse_b, r0, lq);
  st.rest[1] = row_rest(delta_b, glse_b, r1, lq);
}

// Fold one staged 64-key tile (K in ks, V in vs, row stride D + 8) into dq.
// `valid` bit j: column j is a live key (others get p = 0).
template <int D>
__device__ __forceinline__ void dq_tile(DqState<D>& st, const bf16* ks, const bf16* vs,
                                        unsigned long long valid, float c) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const bf16* kp = ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
      mma_16816(s[j], st.qf[kk], ld_u32(kp), ld_u32(kp + 8));
      const bf16* vp = vs + (j * 8 + g) * LD + kk * 16 + 2 * t;
      mma_16816(dp[j], st.dof[kk], ld_u32(vp), ld_u32(vp + 8));
    }
  }
  // p and ds in place of s (element (row, key j*8 + 2t + e%2)).  This
  // thread's columns are j * 8 + 2t (+1): one variable shift, then constant
  // bit positions.
  const unsigned long long vt = valid >> (2 * t);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool live = (vt >> (j * 8 + (e & 1))) & 1ull;
      const float p = live ? exp2_approx(s[j][e] * c - st.lse2[h]) : 0.f;
      s[j][e] = p * (dp[j][e] + st.rest[h]);
    }
  }
  // dq += ds (bf16) . K: the ds fragments of key tiles 2kk, 2kk+1 are the A
  // fragment of k-step kk; K's B fragment takes two key rows per register.
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const bf16* k0 = ks + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* kp = k0 + n * 8;
      mma_16816(st.dq[n], a, pack_bf16_raw(kp[0], kp[LD]),
                pack_bf16_raw(kp[8 * LD], kp[9 * LD]));
    }
  }
}

// scale * dq of rows r0, r1 (row stride D; rows past lq skipped).
template <int D>
__device__ __forceinline__ void store_dq(const DqState<D>& st, bf16* dqb, int r0, int r1,
                                         int lq, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < lq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)r0 * D + col) =
          __floats2bfloat162_rn(st.dq[n][0] * scale, st.dq[n][1] * scale);
    if (r1 < lq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)r1 * D + col) =
          __floats2bfloat162_rn(st.dq[n][2] * scale, st.dq[n][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int LD = D + 8;
  static constexpr int TILE = 64 * LD;  // elements of one 64-row tile
  static constexpr size_t BYTES = 4 * TILE * sizeof(bf16) + 2 * 64 * sizeof(float);
};

template <int D>
__device__ __forceinline__ void dkv_tile(float (*dk)[4], float (*dv)[4], const bf16* ks,
                                         const bf16* vs, const bf16* qs, const bf16* dos,
                                         const float* lse2s, const float* rests,
                                         bool kv0, bool kv1, float c) {
  constexpr int LD = D + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  // s^T = K . Q^T and dp^T = V . dO^T (rows: this warp's 16 keys).
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + 2 * t;
    uint32_t ka[4], va[4];
    ka[0] = ld_u32(ks + lr0 * LD + col);
    ka[1] = ld_u32(ks + lr1 * LD + col);
    ka[2] = ld_u32(ks + lr0 * LD + col + 8);
    ka[3] = ld_u32(ks + lr1 * LD + col + 8);
    va[0] = ld_u32(vs + lr0 * LD + col);
    va[1] = ld_u32(vs + lr1 * LD + col);
    va[2] = ld_u32(vs + lr0 * LD + col + 8);
    va[3] = ld_u32(vs + lr1 * LD + col + 8);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const bf16* qp = qs + (j * 8 + g) * LD + col;
      mma_16816(s[j], ka, ld_u32(qp), ld_u32(qp + 8));
      const bf16* dp_ = dos + (j * 8 + g) * LD + col;
      mma_16816(dp[j], va, ld_u32(dp_), ld_u32(dp_ + 8));
    }
  }
  // p^T in s, ds^T in dp (element (key, query row j*8 + 2t + e%2)).
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = j * 8 + 2 * t + (e & 1);
      const bool kv = (e >> 1) ? kv1 : kv0;
      const float p = kv ? exp2_approx(s[j][e] * c - lse2s[row]) : 0.f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] + rests[row]);
    }
  }
  // dv += p^T (bf16) . dO and dk += ds^T (bf16) . Q over the tile's 64 rows.
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t pa[4], da[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
    da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
    da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
    da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    const int r = (kk * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* op = dos + r + n * 8;
      mma_16816(dv[n], pa, pack_bf16_raw(op[0], op[LD]), pack_bf16_raw(op[8 * LD], op[9 * LD]));
      const bf16* qp = qs + r + n * 8;
      mma_16816(dk[n], da, pack_bf16_raw(qp[0], qp[LD]), pack_bf16_raw(qp[8 * LD], qp[9 * LD]));
    }
  }
}

// Loads query rows [row0, row0 + 64) of q, dO and their statistics into
// shared memory (rows past lq zero, with lse2 = +inf and rest = 0).
template <int D>
__device__ __forceinline__ void load_query_tile(bf16* qs, bf16* dos, float* lse2s,
                                                float* rests, const bf16* qb,
                                                const bf16* db, const float* lse_b,
                                                const float* delta_b,
                                                const float* glse_b, int row0, int lq,
                                                float bias) {
  const int nvalid = min(64, lq - row0);
  load_rows<D>(qs, qb + (size_t)row0 * D, D, nvalid);
  load_rows<D>(dos, db + (size_t)row0 * D, D, nvalid);
  for (int i = threadIdx.x; i < 64; i += NTHREADS) {
    lse2s[i] = row_lse2(lse_b, row0 + i, lq, bias);
    rests[i] = row_rest(delta_b, glse_b, row0 + i, lq);
  }
}

// The dK/dV store: rows k0 (kv0) and k1 (kv1) of dk (times scale) and dv,
// row stride D.
template <int D>
__device__ __forceinline__ void store_dkv(float (*dk)[4], float (*dv)[4],
                                          bf16* dkb, bf16* dvb, int k0, int k1, bool kv0,
                                          bool kv1, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (kv0) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)k0 * D + col) =
          __floats2bfloat162_rn(dk[n][0] * scale, dk[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)k0 * D + col) =
          __floats2bfloat162_rn(dv[n][0], dv[n][1]);
    }
    if (kv1) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)k1 * D + col) =
          __floats2bfloat162_rn(dk[n][2] * scale, dk[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)k1 * D + col) =
          __floats2bfloat162_rn(dv[n][2], dv[n][3]);
    }
  }
}

}  // namespace bwd
}  // namespace bt
