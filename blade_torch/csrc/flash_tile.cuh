// The forward flash-attention tile shared by sparse_union.cu and
// pooled_predictor.cu (and its pooled-segment gather by pooled_level_bwd.cu,
// through flash_bwd_tile.cuh): one CTA
// of 4 warps owns 64 query rows (16 a warp, FA2 register layout) and folds
// 64-key tiles staged in shared memory into a base-2 online-softmax carry,
// both products on mma.sync m16n8k16 bf16 tensor cores with f32
// accumulation.
#pragma once

#include "common.cuh"

namespace bt {

constexpr int BM = 64;  // query rows per CTA: 4 warps x 16
constexpr int BN = 64;  // keys per shared-memory tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

template <int D, int DVC>
struct WarpState {
  uint32_t qf[D / 16][4];  // this warp's 16 query rows as A fragments
  float o[DVC / 8][4];     // output accumulator, 16 rows x DVC columns
  float m[2];              // running max in base-2 units (rows g, g + 8)
  float l[2];              // this thread's share of the running sum
};

// Bit j set: tile column j is a live key.
__device__ __forceinline__ unsigned long long prefix_valid(int n) {
  return n >= 64 ? ~0ull : (n <= 0 ? 0ull : ((1ull << n) - 1ull));
}

// rows [0, nvalid) of a BN x W tile (row stride `ld` elements) into shared
// memory rows of stride W + 8; rows past nvalid are zero-filled.  NT is the
// CTA's thread count.
template <int W, int NT = NTHREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t ld,
                                          int nvalid) {
  constexpr int VPR = W / 8;
  for (int i = threadIdx.x; i < BN * VPR; i += NT) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (W + 8) + c * 8) = val;
  }
}

// This warp's 16 rows of q [rows, D] (rows past lq read as 0) into A
// fragments, and an empty carry.
template <int D, int DVC>
__device__ __forceinline__ void init_state(WarpState<D, DVC>& st, const bf16* qb, int r0,
                                           int r1, int lq) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + 2 * t;
    st.qf[kk][0] = r0 < lq ? ld_u32(qb + (size_t)r0 * D + col) : 0u;
    st.qf[kk][1] = r1 < lq ? ld_u32(qb + (size_t)r1 * D + col) : 0u;
    st.qf[kk][2] = r0 < lq ? ld_u32(qb + (size_t)r0 * D + col + 8) : 0u;
    st.qf[kk][3] = r1 < lq ? ld_u32(qb + (size_t)r1 * D + col + 8) : 0u;
  }
#pragma unroll
  for (int n = 0; n < DVC / 8; ++n) st.o[n][0] = st.o[n][1] = st.o[n][2] = st.o[n][3] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// Raw scores of this warp's 16 query rows against the staged BN-key tile
// `ks` (row stride D + 8): s[j] is the m16n8 fragment of keys 8j..8j+7.
template <int D>
__device__ __forceinline__ void score_tile(const uint32_t (&qf)[D / 16][4], const bf16* ks,
                                           float (&s)[BN / 8][4]) {
  constexpr int LDK = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const bf16* kp = ks + (j * 8 + g) * LDK + kk * 16 + 2 * t;
      mma_16816(s[j], qf[kk], ld_u32(kp), ld_u32(kp + 8));
    }
  }
}

// Fold one staged tile into the carry.  `valid` bit j: column j is a live
// key (others score -inf); `c` = scale * log2(e).
template <int D, int DVC>
__device__ __forceinline__ void attend_tile(WarpState<D, DVC>& st, const bf16* ks,
                                            const bf16* vs, unsigned long long valid,
                                            float c) {
  constexpr int LDV = DVC + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  float s[BN / 8][4];
  score_tile<D>(st.qf, ks, s);

  if (valid != ~0ull) {  // same for the whole CTA; full tiles skip the masking
    // This thread's columns are j * 8 + 2t (+1): one variable shift, then
    // constant bit positions.
    const unsigned long long vt = valid >> (2 * t);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (!((vt >> (j * 8)) & 1ull)) s[j][0] = s[j][2] = -INFINITY;
      if (!((vt >> (j * 8 + 1)) & 1ull)) s[j][1] = s[j][3] = -INFINITY;
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

  const float mn0 = fmaxf(st.m[0], mx0 * c), mn1 = fmaxf(st.m[1], mx1 * c);
  // A row with no live key so far keeps m = -inf; subtract 0 instead so
  // exp2 sees -inf (-> 0) and never -inf - -inf.
  const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
  const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
  const float a0 = exp2_approx(st.m[0] - ms0), a1 = exp2_approx(st.m[1] - ms1);
  const float o0 = -ms0, o1 = -ms1;

  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    s[j][0] = exp2_approx(s[j][0] * c + o0);
    s[j][1] = exp2_approx(s[j][1] * c + o0);
    s[j][2] = exp2_approx(s[j][2] * c + o1);
    s[j][3] = exp2_approx(s[j][3] * c + o1);
    ps0 += s[j][0] + s[j][1];
    ps1 += s[j][2] + s[j][3];
  }
  st.l[0] = st.l[0] * a0 + ps0;
  st.l[1] = st.l[1] * a1 + ps1;
  st.m[0] = mn0;
  st.m[1] = mn1;
#pragma unroll
  for (int n = 0; n < DVC / 8; ++n) {
    st.o[n][0] *= a0;
    st.o[n][1] *= a0;
    st.o[n][2] *= a1;
    st.o[n][3] *= a1;
  }

  // P (rounded to bf16, as the TPU kernel feeds the MXU) @ V.  The score
  // fragment of key tiles 2kk and 2kk+1 is exactly the A fragment of the
  // k-step kk; V's B fragment takes two rows per register.
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const bf16* v0 = vs + (kk * 16 + 2 * t) * LDV + g;
#pragma unroll
    for (int n = 0; n < DVC / 8; ++n) {
      const bf16* vp = v0 + n * 8;
      const uint32_t b0 = pack_bf16_raw(vp[0], vp[LDV]);
      const uint32_t b1 = pack_bf16_raw(vp[8 * LDV], vp[9 * LDV]);
      mma_16816(st.o[n], pa, b0, b1);
    }
  }
}

// Stage listed segments j0 .. j0 + 64/SEG - 1 of one pooled level into a
// 64-key tile: SEG = 128 / L pooled rows a block, `pyr` one head's level-L
// records ([n_kt, 2, SEG, D]: K rows, then V rows), `lst` its ascending list
// of `cnt` block indices.  Returns the live-column mask: pooled rows at or
// past `pooled_len` and slots past the count are dead columns (zero-filled,
// so no stale value reaches a product).  The caller synchronises before
// (the tile may still be read) and after (before reading it).
template <int D, int SEG>
__device__ __forceinline__ unsigned long long gather_pooled_tile(bf16* ks, bf16* vs,
                                                                 const bf16* pyr,
                                                                 const int* lst, int j0,
                                                                 int cnt, int pooled_len) {
  constexpr int SPT = BN / SEG;
  constexpr int VPR = D / 8;
  int blk[SPT];
  unsigned long long valid = 0ull;
#pragma unroll
  for (int u = 0; u < SPT; ++u) {
    blk[u] = j0 + u < cnt ? lst[j0 + u] : -1;
    if (blk[u] >= 0) valid |= prefix_valid(min(SEG, pooled_len - blk[u] * SEG)) << (u * SEG);
  }
  for (int i = threadIdx.x; i < BN * VPR; i += NTHREADS) {
    const int r = i / VPR, cc = i % VPR;
    const int u = r / SEG, row = r % SEG;
    int b = blk[0];
#pragma unroll
    for (int w = 1; w < SPT; ++w)
      if (u == w) b = blk[w];
    uint4 kq = make_uint4(0u, 0u, 0u, 0u), vq = kq;
    if (b >= 0) {
      const bf16* src = pyr + ((size_t)b * 2 * SEG + row) * D + cc * 8;
      kq = *reinterpret_cast<const uint4*>(src);
      vq = *reinterpret_cast<const uint4*>(src + SEG * D);
    }
    *reinterpret_cast<uint4*>(ks + r * (D + 8) + cc * 8) = kq;
    *reinterpret_cast<uint4*>(vs + r * (D + 8) + cc * 8) = vq;
  }
  return valid;
}

// Normalise the carry and write this warp's rows: out columns [col0,
// col0 + DVC) of rows r0, r1 (row stride dv) and, when write_lse, the
// natural-log LSE plus `bias` (NEG_INF_LSE for a row with no live key).
template <int D, int DVC>
__device__ __forceinline__ void store_rows(const WarpState<D, DVC>& st, bf16* out, float* lse,
                                           int r0, int r1, int lq, int dv, int col0,
                                           bool write_lse, float bias) {
  const int t = threadIdx.x & 3;
  float l0 = st.l[0], l1 = st.l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int n = 0; n < DVC / 8; ++n) {
    const int col = col0 + n * 8 + 2 * t;
    if (r0 < lq)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * dv + col) =
          __floats2bfloat162_rn(st.o[n][0] * inv0, st.o[n][1] * inv0);
    if (r1 < lq)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r1 * dv + col) =
          __floats2bfloat162_rn(st.o[n][2] * inv1, st.o[n][3] * inv1);
  }
  if (write_lse && t == 0) {
    if (r0 < lq) lse[r0] = l0 > 0.f ? st.m[0] * LN2 + bias + logf(l0) : NEG_INF_LSE;
    if (r1 < lq) lse[r1] = l1 > 0.f ? st.m[1] * LN2 + bias + logf(l1) : NEG_INF_LSE;
  }
}

}  // namespace bt
