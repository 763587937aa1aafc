// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the four backward kernels of blade/kernels/block_sparse_attn.py
// (reached through _attn_core_bwd -> _bwd_call):
//   * _dense_dq_kernel   -> bt_attn_dense_dq    (flash_attention backward)
//   * _dense_dkv_kernel  -> bt_attn_dense_dkv
//   * _sparse_dq_kernel  -> bt_attn_sparse_dq   (block_sparse_attention
//     backward, walking each mask row's ascending list of pack_kv records)
//   * _sparse_dkv_kernel -> bt_attn_sparse_dkv  (walking the TRANSPOSED lists:
//     for each 128-key block, the ascending 128-row query blocks that chose it)
//
// Semantics kept from the TPU kernels: the forward's scores and softmax are
// recomputed from the saved natural-log LSE in base 2,
//   p  = exp2(s * scale * log2e - (lse - bias) * log2e),
//   ds = p * (dO . v^T + g_lse - delta),   delta = rowsum(dO * O) (computed
//        outside, in torch, as JAX computes it in XLA),
//   dq = scale * ds . k,  dk = scale * ds^T . q,  dv = p^T . dO,
// with p and ds rounded to bf16 before each product, as the TPU kernels feed
// the MXU.  dQ and dK/dV are separate kernels, so no atomics: a dQ CTA owns
// 64 query rows and loops over keys, a dK/dV CTA owns 64 keys and loops over
// queries.  Keys at or past `lk` and query rows at or past `lq` contribute
// nothing.  A row whose LSE is the empty-row marker (-1e30) is treated as
// empty (p = 0): exp2 never sees that LSE.
//
// What bounds it on the H100: tensor-core math, as in the forward (five
// 64 x 64 x d products a tile pair against the forward's two, plus the
// recomputed exp2), with K/V or Q/dO tiles re-read from L2 by the CTAs of
// one head.  The design keeps every product on mma.sync m16n8k16 bf16
// tensor cores with f32 accumulators in registers (the score/ds fragments
// are reused in registers as the A operand of the next product, as the
// forward reuses P), and streams the other side's tiles through shared
// memory with 16-byte loads.  The dK/dV kernel computes the transposed
// scores s^T = K . Q^T directly, so the key dimension is the MMA's row
// dimension and dK, dV accumulate in registers without a transpose; its
// K, V, Q and dO tiles (70 KB at d = 128) live in dynamic shared memory.
// This first version is synchronous (no cp.async / TMA pipeline, no wgmma).
#include "common.cuh"

namespace bt {
namespace bwd {

constexpr int BM = 64;  // query rows (dQ) or keys (dK/dV) per CTA: 4 warps x 16
constexpr int BN = 64;  // keys (dQ) or query rows (dK/dV) per streamed tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
// Rows whose LSE is at or below this are empty (the forward writes -1e30).
constexpr float EMPTY_LSE = -1e29f;

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
// dQ: one CTA per (64 query rows, bh).  Each warp owns 16 rows; q and dO stay
// in registers as A fragments; K and V tiles of 64 keys stream through
// shared memory.
// ---------------------------------------------------------------------------

template <int D>
struct DqState {
  uint32_t qf[D / 16][4];
  uint32_t dof[D / 16][4];
  float dq[D / 8][4];
  float lse2[2];  // rows g, g + 8
  float rest[2];
};

template <int D>
__device__ __forceinline__ void dq_tile(DqState<D>& st, const bf16* ks, const bf16* vs,
                                        int nvalid, float c) {
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
  // p and ds in place of s (element (row, key j*8 + 2t + e%2)).
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      const int h = e >> 1;
      const float p = col < nvalid ? exp2_approx(s[j][e] * c - st.lse2[h]) : 0.f;
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

// Dense: k, v [BH, lk, D].  Sparse: k holds pack_kv records
// [BH, n_kt, 2, 128, D] (v unused) and lists/counts select the key blocks of
// each 128-row mask row.
template <int D, bool SPARSE>
__global__ void __launch_bounds__(NTHREADS)
attn_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ glse, const int* __restrict__ lists,
               const int* __restrict__ counts, bf16* __restrict__ dq, int lq, int lk,
               int n_qt, int max_k, float scale, float bias) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 ks[BN * LD];
  __shared__ __align__(16) bf16 vs[BN * LD];
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float c = scale * LOG2E;

  DqState<D> st;
  const bf16* qb = q + (size_t)bh * lq * D;
  const bf16* db = dout + (size_t)bh * lq * D;
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
  const float* lse_b = lse + (size_t)bh * lq;
  const float* delta_b = delta + (size_t)bh * lq;
  const float* glse_b = glse + (size_t)bh * lq;
  st.lse2[0] = row_lse2(lse_b, r0, lq, bias);
  st.lse2[1] = row_lse2(lse_b, r1, lq, bias);
  st.rest[0] = row_rest(delta_b, glse_b, r0, lq);
  st.rest[1] = row_rest(delta_b, glse_b, r1, lq);

  if (!SPARSE) {
    const bf16* kb = k + (size_t)bh * lk * D;
    const bf16* vb = v + (size_t)bh * lk * D;
    for (int key0 = 0; key0 < lk; key0 += BN) {
      const int nvalid = min(BN, lk - key0);
      __syncthreads();
      load_rows<D>(ks, kb + (size_t)key0 * D, D, nvalid);
      load_rows<D>(vs, vb + (size_t)key0 * D, D, nvalid);
      __syncthreads();
      dq_tile<D>(st, ks, vs, nvalid, c);
    }
  } else {
    const int n_kt = (lk + 127) / 128;
    const int row = q0 / 128;
    const int cnt = counts[bh * n_qt + row];
    const int* lst = lists + ((size_t)bh * n_qt + row) * max_k;
    const bf16* rec = k + (size_t)bh * n_kt * 256 * D;
    for (int j = 0; j < cnt; ++j) {
      const int blk = lst[j];
      for (int half = 0; half < 2; ++half) {
        const int nvalid = min(BN, lk - (blk * 128 + half * 64));
        if (nvalid <= 0) continue;  // same for every thread of the CTA
        __syncthreads();
        load_rows<D>(ks, rec + ((size_t)blk * 256 + half * 64) * D, D, nvalid);
        load_rows<D>(vs, rec + ((size_t)blk * 256 + 128 + half * 64) * D, D, nvalid);
        __syncthreads();
        dq_tile<D>(st, ks, vs, nvalid, c);
      }
    }
  }

  bf16* dqb = dq + (size_t)bh * lq * D;
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
// dK/dV: one CTA per (64 keys, bh).  Each warp owns 16 keys; K and V are
// read as A fragments from shared memory; query tiles of 64 rows (q, dO and
// the row statistics) stream through shared memory.
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

// Dense: every query tile.  Sparse: the query blocks of this key block's
// transposed list (t_lists [BH, n_kt, max_q], t_counts [BH, n_kt]); the CTA
// covers 64 keys, half of one 128-key block.
template <int D, bool SPARSE>
__global__ void __launch_bounds__(NTHREADS)
attn_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ glse, const int* __restrict__ t_lists,
                const int* __restrict__ t_counts, bf16* __restrict__ dk_out,
                bf16* __restrict__ dv_out, int lq, int lk, int n_kt, int max_q,
                float scale, float bias) {
  using S = DkvSmem<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + S::TILE;
  bf16* qs = vs + S::TILE;
  bf16* dos = qs + S::TILE;
  float* lse2s = reinterpret_cast<float*>(dos + S::TILE);
  float* rests = lse2s + 64;

  const int bh = blockIdx.y, key0 = blockIdx.x * BM;
  if (key0 >= lk) return;  // the ragged last block's empty half (sparse grid)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = key0 + warp * 16 + g, k1 = k0 + 8;
  const float c = scale * LOG2E;

  const int nkeys = min(BM, lk - key0);
  load_rows<D>(ks, k + ((size_t)bh * lk + key0) * D, D, nkeys);
  load_rows<D>(vs, v + ((size_t)bh * lk + key0) * D, D, nkeys);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const bf16* qb = q + (size_t)bh * lq * D;
  const bf16* db = dout + (size_t)bh * lq * D;
  const float* lse_b = lse + (size_t)bh * lq;
  const float* delta_b = delta + (size_t)bh * lq;
  const float* glse_b = glse + (size_t)bh * lq;
  const bool kv0 = k0 < lk, kv1 = k1 < lk;

  if (!SPARSE) {
    for (int row0 = 0; row0 < lq; row0 += BN) {
      __syncthreads();
      load_query_tile<D>(qs, dos, lse2s, rests, qb, db, lse_b, delta_b, glse_b, row0, lq,
                         bias);
      __syncthreads();
      dkv_tile<D>(dk, dv, ks, vs, qs, dos, lse2s, rests, kv0, kv1, c);
    }
  } else {
    const int blk = key0 / 128;
    const int cnt = t_counts[bh * n_kt + blk];
    const int* lst = t_lists + ((size_t)bh * n_kt + blk) * max_q;
    for (int j = 0; j < cnt; ++j) {
      const int qblk = lst[j];
      for (int half = 0; half < 2; ++half) {
        const int row0 = qblk * 128 + half * 64;
        if (row0 >= lq) continue;  // same for every thread of the CTA
        __syncthreads();
        load_query_tile<D>(qs, dos, lse2s, rests, qb, db, lse_b, delta_b, glse_b, row0,
                           lq, bias);
        __syncthreads();
        dkv_tile<D>(dk, dv, ks, vs, qs, dos, lse2s, rests, kv0, kv1, c);
      }
    }
  }

  bf16* dkb = dk_out + (size_t)bh * lk * D;
  bf16* dvb = dv_out + (size_t)bh * lk * D;
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

template <int D, bool SPARSE>
static int launch_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* glse,
                     const void* lists, const void* counts, void* dq, int bh, int lq,
                     int lk, int n_qt, int max_k, float scale, float bias,
                     cudaStream_t stream) {
  const dim3 grid((lq + BM - 1) / BM, bh);
  attn_dq_kernel<D, SPARSE><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(glse), static_cast<const int*>(lists),
      static_cast<const int*>(counts), static_cast<bf16*>(dq), lq, lk, n_qt, max_k, scale,
      bias);
  return (int)cudaGetLastError();
}

template <int D, bool SPARSE>
static int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* glse,
                      const void* t_lists, const void* t_counts, void* dk, void* dv, int bh,
                      int lq, int lk, int n_kt, int max_q, float scale, float bias,
                      cudaStream_t stream) {
  constexpr size_t smem = DkvSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(attn_dkv_kernel<D, SPARSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int key_ctas = SPARSE ? 2 * n_kt : (lk + BM - 1) / BM;
  const dim3 grid(key_ctas, bh);
  attn_dkv_kernel<D, SPARSE><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(glse), static_cast<const int*>(t_lists),
      static_cast<const int*>(t_counts), static_cast<bf16*>(dk), static_cast<bf16*>(dv), lq,
      lk, n_kt, max_q, scale, bias);
  return (int)cudaGetLastError();
}

static bool bad_dims(int bh, int lq, int lk) {
  return lq <= 0 || lk <= 0 || bh <= 0 || bh > 65535;
}

}  // namespace bwd
}  // namespace bt

// All tensors contiguous: q, dout [bh, lq, d]; k, v [bh, lk, d] bf16; lse,
// delta, glse [bh, lq] f32 -> dq [bh, lq, d] bf16.  d in {64, 128}.
BT_API int bt_attn_dense_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* glse, void* dq,
                            int bh, int lq, int lk, int d, float scale, float bias,
                            void* stream) {
  using namespace bt::bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_dims(bh, lq, lk)) return (int)cudaErrorInvalidValue;
  if (d == 128)
    return launch_dq<128, false>(q, k, v, dout, lse, delta, glse, nullptr, nullptr, dq, bh,
                                 lq, lk, 0, 0, scale, bias, st);
  if (d == 64)
    return launch_dq<64, false>(q, k, v, dout, lse, delta, glse, nullptr, nullptr, dq, bh,
                                lq, lk, 0, 0, scale, bias, st);
  return (int)cudaErrorInvalidValue;
}

// As bt_attn_dense_dq -> dk, dv [bh, lk, d] bf16.
BT_API int bt_attn_dense_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* glse, void* dk,
                             void* dv, int bh, int lq, int lk, int d, float scale,
                             float bias, void* stream) {
  using namespace bt::bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_dims(bh, lq, lk)) return (int)cudaErrorInvalidValue;
  if (d == 128)
    return launch_dkv<128, false>(q, k, v, dout, lse, delta, glse, nullptr, nullptr, dk, dv,
                                  bh, lq, lk, 0, 0, scale, bias, st);
  if (d == 64)
    return launch_dkv<64, false>(q, k, v, dout, lse, delta, glse, nullptr, nullptr, dk, dv,
                                 bh, lq, lk, 0, 0, scale, bias, st);
  return (int)cudaErrorInvalidValue;
}

// q, dout [bh, lq, d]; kv_packed [bh, ceil(lk/128), 2, 128, d] (bt_pack_kv);
// lse, delta, glse [bh, lq] f32; lists [bh, n_qt, max_k] ascending key
// blocks, counts [bh, n_qt] int32 (the forward's lists) -> dq [bh, lq, d].
BT_API int bt_attn_sparse_dq(const void* q, const void* kv_packed, const void* dout,
                             const void* lse, const void* delta, const void* glse,
                             const void* lists, const void* counts, void* dq, int bh, int lq,
                             int lk, int d, int n_qt, int max_k, float scale, float bias,
                             void* stream) {
  using namespace bt::bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_dims(bh, lq, lk) || n_qt != (lq + 127) / 128) return (int)cudaErrorInvalidValue;
  if (d == 128)
    return launch_dq<128, true>(q, kv_packed, nullptr, dout, lse, delta, glse, lists, counts,
                                dq, bh, lq, lk, n_qt, max_k, scale, bias, st);
  if (d == 64)
    return launch_dq<64, true>(q, kv_packed, nullptr, dout, lse, delta, glse, lists, counts,
                               dq, bh, lq, lk, n_qt, max_k, scale, bias, st);
  return (int)cudaErrorInvalidValue;
}

// q, dout [bh, lq, d]; k, v [bh, lk, d]; stats as above; t_lists
// [bh, n_kt, max_q] ascending query blocks per key block, t_counts
// [bh, n_kt] int32 (lists of the transposed mask) -> dk, dv [bh, lk, d].
BT_API int bt_attn_sparse_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* glse,
                              const void* t_lists, const void* t_counts, void* dk, void* dv,
                              int bh, int lq, int lk, int d, int n_kt, int max_q,
                              float scale, float bias, void* stream) {
  using namespace bt::bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_dims(bh, lq, lk) || n_kt != (lk + 127) / 128) return (int)cudaErrorInvalidValue;
  if (d == 128)
    return launch_dkv<128, true>(q, k, v, dout, lse, delta, glse, t_lists, t_counts, dk, dv,
                                 bh, lq, lk, n_kt, max_q, scale, bias, st);
  if (d == 64)
    return launch_dkv<64, true>(q, k, v, dout, lse, delta, glse, t_lists, t_counts, dk, dv,
                                bh, lq, lk, n_kt, max_q, scale, bias, st);
  return (int)cudaErrorInvalidValue;
}
