// One pooled level of multi-level attention, backward, for Hopper (sm_90a).
//
// Replaces the pooled form of two TPU kernels of
// blade/kernels/block_sparse_attn.py, as gather_backward launches them with
// seg_rows = 128/L for the pooled levels L in {2, 4, 8} (the backward of
// multilevel_attention, both lanes):
//   * _sparse_dq_kernel  (seg_rows 64/32/16) -> bt_pooled_level_dq
//   * _sparse_dkv_kernel (seg_rows 64/32/16) -> bt_pooled_level_dkv
// (their seg_rows 128 form is bt_attn_sparse_dq / _dkv, flash_attn_bwd.cu).
//
// Function: 128-row query tiles select 128-key blocks; block b at level L
// is the SEG = 128/L-row segment b of the L-times mean-pooled K/V, read from
// the level's bt_pack_kv_pyramid records ([BH, n_kt, 2, SEG, d]: K rows, then
// V rows).  Every score carries +log(L) (`bias`), pooled rows at or past
// `pooled_len` = ceil(Lk/L) are dead, and p is recomputed from the given
// natural-log lse: the level's own (per-level lane) or the merged one of all
// levels (fused lane; the passes of the four levels then sum to the whole
// gradient).  The math is flash_bwd_tile.cuh's (p and ds rounded to bf16
// before each product, the LSE cotangent in ds, empty rows give nothing).
//
// bt_pooled_level_dq: a CTA owns 64 query rows of one 128-row tile and walks
// the tile's ascending list, gathering 64/SEG listed segments into one
// 64-key tile with a live-column mask (flash_tile.cuh's gather_pooled_tile).
//
// bt_pooled_level_dkv: a CTA owns 64 pooled rows = 64/SEG segments (one at
// level 2, up to four at level 8), each with its own transposed list (the
// query tiles that selected its block).  The CTA walks the UNION of those
// lists, merged on the fly in ascending order, and stages each query tile
// once; the warps whose segment did not select that tile skip its products.
// A warp's 16 key rows always lie in one segment (SEG >= 16), so validity is
// warp-uniform: the transposed counterpart of the forward's live-column
// mask.  Chosen over one CTA per segment, which would leave 48 of 64 MMA
// rows idle at level 8 or, with narrower CTAs, cut a CTA to one warp with
// the same shared-memory tile: adjacent blocks' transposed lists overlap
// heavily (Gilbert order, rank bands), so a staged tile serves most warps.
//
// What bounds it on the H100: tensor-core math over the selected (query,
// pooled key) pairs (dQ three, dK/dV four d-deep products a pair), with Q/dO
// tiles (dK/dV) or pooled segments (dQ) re-read from L2.  Simple and
// synchronous, as the other backward kernels: no cp.async / TMA, no wgmma.
#include <climits>
#include <cmath>

#include "flash_bwd_tile.cuh"

namespace bt {
namespace bwd {

template <int D, int SEG>
__global__ void __launch_bounds__(NTHREADS)
pooled_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ rec,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const float* __restrict__ glse,
                 const int* __restrict__ lists, const int* __restrict__ counts,
                 bf16* __restrict__ dq, int lq, int n_kt, int n_qt, int max_k,
                 int pooled_len, float scale, float bias) {
  __shared__ __align__(16) bf16 ks[BN * (D + 8)];
  __shared__ __align__(16) bf16 vs[BN * (D + 8)];
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float c = scale * LOG2E;

  DqState<D> st;
  init_dq<D>(st, q + (size_t)bh * lq * D, dout + (size_t)bh * lq * D, lse + (size_t)bh * lq,
             delta + (size_t)bh * lq, glse + (size_t)bh * lq, r0, r1, lq, bias);
  const int row = q0 / 128;
  const int cnt = counts[bh * n_qt + row];
  const int* lst = lists + ((size_t)bh * n_qt + row) * max_k;
  const bf16* pyr = rec + (size_t)bh * n_kt * 2 * SEG * D;
  for (int j0 = 0; j0 < cnt; j0 += BN / SEG) {
    __syncthreads();
    const unsigned long long valid =
        gather_pooled_tile<D, SEG>(ks, vs, pyr, lst, j0, cnt, pooled_len);
    __syncthreads();
    dq_tile<D>(st, ks, vs, valid, c);
  }
  store_dq<D>(st, dq + (size_t)bh * lq * D, r0, r1, lq, scale);
}

template <int D, int SEG>
__global__ void __launch_bounds__(NTHREADS)
pooled_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ rec,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, const float* __restrict__ glse,
                  const int* __restrict__ t_lists, const int* __restrict__ t_counts,
                  bf16* __restrict__ dk_out, bf16* __restrict__ dv_out, int lq, int n_kt,
                  int max_q, int pooled_len, float scale, float bias) {
  constexpr int SPT = BM / SEG;  // segments a CTA
  constexpr int VPR = D / 8;
  using S = DkvSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + S::TILE;
  bf16* qs = vs + S::TILE;
  bf16* dos = qs + S::TILE;
  float* lse2s = reinterpret_cast<float*>(dos + S::TILE);
  float* rests = lse2s + 64;

  const int bh = blockIdx.y, key0 = blockIdx.x * BM, blk0 = key0 / SEG;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int k0 = key0 + warp * 16 + g, k1 = k0 + 8;
  const int useg = warp * 16 / SEG;  // this warp's segment
  const float c = scale * LOG2E;

  // The CTA's pooled K and V rows (segments past n_kt zero).
  const bf16* pyr = rec + (size_t)bh * n_kt * 2 * SEG * D;
  for (int i = threadIdx.x; i < BM * VPR; i += NTHREADS) {
    const int r = i / VPR, cc = i % VPR;
    const int b = blk0 + r / SEG, row = r % SEG;
    uint4 kq = make_uint4(0u, 0u, 0u, 0u), vq = kq;
    if (b < n_kt) {
      const bf16* src = pyr + ((size_t)b * 2 * SEG + row) * D + cc * 8;
      kq = *reinterpret_cast<const uint4*>(src);
      vq = *reinterpret_cast<const uint4*>(src + SEG * D);
    }
    *reinterpret_cast<uint4*>(ks + r * (D + 8) + cc * 8) = kq;
    *reinterpret_cast<uint4*>(vs + r * (D + 8) + cc * 8) = vq;
  }

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
  const bool kv0 = k0 < pooled_len, kv1 = k1 < pooled_len;

  // Merge the segments' ascending lists: each step takes the smallest head
  // and advances every list that holds it (the same for every thread).
  const int* lst[SPT];
  int cnt[SPT], pos[SPT];
#pragma unroll
  for (int u = 0; u < SPT; ++u) {
    const int b = blk0 + u;
    cnt[u] = b < n_kt ? t_counts[bh * n_kt + b] : 0;
    lst[u] = t_lists + ((size_t)bh * n_kt + (b < n_kt ? b : 0)) * max_q;
    pos[u] = 0;
  }
  while (true) {
    int next = INT_MAX;
#pragma unroll
    for (int u = 0; u < SPT; ++u)
      if (pos[u] < cnt[u]) next = min(next, lst[u][pos[u]]);
    if (next == INT_MAX) break;
    bool mine = false;
#pragma unroll
    for (int u = 0; u < SPT; ++u) {
      if (pos[u] < cnt[u] && lst[u][pos[u]] == next) {
        if (u == useg) mine = true;
        ++pos[u];
      }
    }
    for (int half = 0; half < 2; ++half) {
      const int row0 = next * 128 + half * 64;
      if (row0 >= lq) continue;  // same for every thread of the CTA
      __syncthreads();
      load_query_tile<D>(qs, dos, lse2s, rests, qb, db, lse_b, delta_b, glse_b, row0, lq,
                         bias);
      __syncthreads();
      if (mine) dkv_tile<D>(dk, dv, ks, vs, qs, dos, lse2s, rests, kv0, kv1, c);
    }
  }

  const int rows = n_kt * SEG;  // dK/dV rows; those past pooled_len are 0
  store_dkv<D>(dk, dv, dk_out + (size_t)bh * rows * D, dv_out + (size_t)bh * rows * D, k0, k1,
               k0 < rows, k1 < rows, scale);
}

template <int D, int SEG>
static int launch_pooled_dq(const void* q, const void* rec, const void* dout,
                            const void* lse, const void* delta, const void* glse,
                            const void* lists, const void* counts, void* dq, int bh,
                            int lq, int n_kt, int n_qt, int max_k, int pooled_len,
                            float scale, float bias, cudaStream_t stream) {
  const dim3 grid((lq + BM - 1) / BM, bh);
  pooled_dq_kernel<D, SEG><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(rec),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(glse),
      static_cast<const int*>(lists), static_cast<const int*>(counts),
      static_cast<bf16*>(dq), lq, n_kt, n_qt, max_k, pooled_len, scale, bias);
  return (int)cudaGetLastError();
}

template <int D, int SEG>
static int launch_pooled_dkv(const void* q, const void* rec, const void* dout,
                             const void* lse, const void* delta, const void* glse,
                             const void* t_lists, const void* t_counts, void* dk, void* dv,
                             int bh, int lq, int n_kt, int max_q, int pooled_len,
                             float scale, float bias, cudaStream_t stream) {
  constexpr size_t smem = DkvSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(pooled_dkv_kernel<D, SEG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_kt * SEG + BM - 1) / BM, bh);
  pooled_dkv_kernel<D, SEG><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(rec),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(glse),
      static_cast<const int*>(t_lists), static_cast<const int*>(t_counts),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), lq, n_kt, max_q, pooled_len, scale,
      bias);
  return (int)cudaGetLastError();
}

static bool bad_pooled(int bh, int lq, int n_kt, int level, int pooled_len) {
  return lq <= 0 || n_kt <= 0 || bh <= 0 || bh > 65535 ||
         (level != 2 && level != 4 && level != 8) || pooled_len <= 0 ||
         pooled_len > n_kt * (128 / level);
}

}  // namespace bwd
}  // namespace bt

#define BT_POOLED_DISPATCH(FN, ...)                                         \
  do {                                                                      \
    if (d == 128 && level == 2) return FN<128, 64>(__VA_ARGS__);            \
    if (d == 128 && level == 4) return FN<128, 32>(__VA_ARGS__);            \
    if (d == 128 && level == 8) return FN<128, 16>(__VA_ARGS__);            \
    if (d == 64 && level == 2) return FN<64, 64>(__VA_ARGS__);              \
    if (d == 64 && level == 4) return FN<64, 32>(__VA_ARGS__);              \
    if (d == 64 && level == 8) return FN<64, 16>(__VA_ARGS__);              \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

// q, dout [bh, lq, d] bf16; rec [bh, n_kt, 2, 128/level, d] bf16, the
// level's pooled records (bt_pack_kv_pyramid's level-L output); lse, delta,
// glse [bh, lq] f32 (lse natural log, the level's own or the merged one);
// lists [bh, n_qt, max_k] ascending block indices < n_kt, counts [bh, n_qt]
// int32 with n_qt = ceil(lq/128) -> dq [bh, lq, d] bf16.  d in {64, 128};
// level in {2, 4, 8}; 0 < pooled_len <= n_kt * 128 / level; every score
// gets + log(level).
BT_API int bt_pooled_level_dq(const void* q, const void* rec, const void* dout,
                              const void* lse, const void* delta, const void* glse,
                              const void* lists, const void* counts, void* dq, int bh,
                              int lq, int n_kt, int d, int level, int n_qt, int max_k,
                              int pooled_len, float scale, void* stream) {
  using namespace bt::bwd;
  if (bad_pooled(bh, lq, n_kt, level, pooled_len) || n_qt != (lq + 127) / 128 || max_k <= 0)
    return (int)cudaErrorInvalidValue;
  const float bias = std::log((float)level);
  BT_POOLED_DISPATCH(launch_pooled_dq, q, rec, dout, lse, delta, glse, lists, counts, dq, bh,
                     lq, n_kt, n_qt, max_k, pooled_len, scale, bias,
                     static_cast<cudaStream_t>(stream));
}

// As bt_pooled_level_dq, with t_lists [bh, n_kt, max_q] ascending 128-row
// query tiles per block and t_counts [bh, n_kt] int32 (the lists of the
// transposed mask) -> dk, dv [bh, n_kt * 128/level, d] bf16 (pooled rows at
// or past pooled_len get 0).
BT_API int bt_pooled_level_dkv(const void* q, const void* rec, const void* dout,
                               const void* lse, const void* delta, const void* glse,
                               const void* t_lists, const void* t_counts, void* dk, void* dv,
                               int bh, int lq, int n_kt, int d, int level, int max_q,
                               int pooled_len, float scale, void* stream) {
  using namespace bt::bwd;
  if (bad_pooled(bh, lq, n_kt, level, pooled_len) || max_q <= 0)
    return (int)cudaErrorInvalidValue;
  const float bias = std::log((float)level);
  BT_POOLED_DISPATCH(launch_pooled_dkv, q, rec, dout, lse, delta, glse, t_lists, t_counts, dk,
                     dv, bh, lq, n_kt, max_q, pooled_len, scale, bias,
                     static_cast<cudaStream_t>(stream));
}
