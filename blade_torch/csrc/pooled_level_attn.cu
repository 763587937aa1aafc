// One pooled level of multi-level attention, forward, for Hopper (sm_90a).
//
// Replaces two TPU kernels that compute the same function and differ only in
// where the TPU keeps the pooled pyramid:
//   * blade/kernels/block_sparse_attn.py::_sparse_fwd_kernel (seg_rows
//     128/L): segments DMA-gathered from HBM (levels whose pyramid is over
//     the 6 MB VMEM budget);
//   * blade/kernels/multilevel_attn.py::_vmem_level_kernel: the whole pooled
//     pyramid resident in VMEM.
// Both are the per-level lane of multilevel_attention (geometries the fused
// lane does not cover, such as Wan2.1-14B 720p with 591 key blocks).  The
// H100 has no multi-megabyte on-chip store to mirror the split, so one
// kernel serves both.
//
// Function: for each 128-row mask row, its ascending list of selected
// 128-key blocks; block b at level L is the 128/L-row segment b of the
// L-times mean-pooled K/V.  An online softmax over the gathered segments,
// pooled rows at or past `pooled_len` masked, gives out [BH, lq, d] bf16 and
// the natural-log lse [BH, lq] f32 with +log(L) folded in (the score bias of
// a pooled key; out does not depend on it).  A row with no block gets out 0
// and lse -1e30.
//
// What bounds it on the H100: tensor-core math over the selected pooled
// keys (at Wan2.1-14B 720p level 2 ~5.9 TFLOP a call against ~0.8 GB of
// pooled records read).  The design reuses the forward tile of
// flash_tile.cuh: one CTA per 64 query rows of one mask row (4 warps x 16,
// mma.sync m16n8k16, FA2 register layout, base-2 carry) walks its row's
// list with walk_pooled, which packs 64 / (128/L) listed segments into one
// 64-key shared-memory tile and marks the live columns in a 64-bit mask.
// The tiles get no score bias (b2 = 0); log(L) goes into the lse at the
// end.  Not carried over from the TPU kernels: the 8-sublane list
// replication, the NBUF DMA ring, the list padding to a multiple of the
// segments a tile, and the d < 128 zero padding.  Synchronous loads (no
// cp.async / TMA, no wgmma) in this first version.
#include <cmath>

#include "flash_tile.cuh"

namespace bt {

template <int D, int SEG>
__global__ void __launch_bounds__(NTHREADS)
pooled_level_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ rec,
                        const int* __restrict__ lists, const int* __restrict__ counts,
                        bf16* __restrict__ out, float* __restrict__ lse, int lq, int n_kt,
                        int n_qt, int max_k, int pooled_len, float c, float bias) {
  __shared__ __align__(16) bf16 ks[BN * (D + 8)];
  __shared__ __align__(16) bf16 vs[BN * (D + 8)];
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  WarpState<D, D> st;
  init_state(st, q + (size_t)bh * lq * D, r0, r1, lq);
  const int row = q0 / 128;
  walk_pooled<D, SEG>(st, ks, vs, rec + (size_t)bh * n_kt * 2 * SEG * D,
                      lists + ((size_t)bh * n_qt + row) * max_k, counts[bh * n_qt + row],
                      pooled_len, c, 0.f);
  store_rows(st, out + (size_t)bh * lq * D, lse + (size_t)bh * lq, r0, r1, lq, D, 0, true,
             bias);
}

template <int D, int SEG>
static void launch_pooled(const void* q, const void* rec, const void* lists,
                          const void* counts, void* out, void* lse, int bh, int lq,
                          int n_kt, int n_qt, int max_k, int pooled_len, float scale,
                          float bias, cudaStream_t stream) {
  const dim3 grid((lq + BM - 1) / BM, bh);
  pooled_level_fwd_kernel<D, SEG><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(rec),
      static_cast<const int*>(lists), static_cast<const int*>(counts),
      static_cast<bf16*>(out), static_cast<float*>(lse), lq, n_kt, n_qt, max_k, pooled_len,
      scale * LOG2E, bias);
}

template <int D>
static int dispatch_level(int level, const void* q, const void* rec, const void* lists,
                          const void* counts, void* out, void* lse, int bh, int lq,
                          int n_kt, int n_qt, int max_k, int pooled_len, float scale,
                          float bias, cudaStream_t stream) {
  if (level == 2)
    launch_pooled<D, 64>(q, rec, lists, counts, out, lse, bh, lq, n_kt, n_qt, max_k,
                         pooled_len, scale, bias, stream);
  else if (level == 4)
    launch_pooled<D, 32>(q, rec, lists, counts, out, lse, bh, lq, n_kt, n_qt, max_k,
                         pooled_len, scale, bias, stream);
  else if (level == 8)
    launch_pooled<D, 16>(q, rec, lists, counts, out, lse, bh, lq, n_kt, n_qt, max_k,
                         pooled_len, scale, bias, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace bt

// q [bh, lq, d] bf16; rec [bh, n_kt, 2, 128/level, d] bf16, the level's
// pooled records (bt_pack_kv_pyramid's level-L output); lists
// [bh, n_qt, max_k] ascending block indices < n_kt and counts [bh, n_qt]
// int32 with n_qt = ceil(lq/128) -> out [bh, lq, d] bf16, lse [bh, lq] f32
// (natural log, + log(level)).  d in {64, 128}; level in {2, 4, 8};
// 0 < pooled_len <= n_kt * 128 / level.
BT_API int bt_pooled_level_fwd(const void* q, const void* rec, const void* lists,
                               const void* counts, void* out, void* lse, int bh, int lq,
                               int n_kt, int d, int level, int n_qt, int max_k,
                               int pooled_len, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lq <= 0 || n_kt <= 0 || bh <= 0 || bh > 65535 || n_qt != (lq + 127) / 128 ||
      max_k <= 0 || level <= 0 || pooled_len <= 0 || pooled_len > n_kt * (128 / level))
    return (int)cudaErrorInvalidValue;
  const float bias = std::log((float)level);
  if (d == 128)
    return bt::dispatch_level<128>(level, q, rec, lists, counts, out, lse, bh, lq, n_kt,
                                   n_qt, max_k, pooled_len, scale, bias, st);
  if (d == 64)
    return bt::dispatch_level<64>(level, q, rec, lists, counts, out, lse, bh, lq, n_kt,
                                  n_qt, max_k, pooled_len, scale, bias, st);
  return (int)cudaErrorInvalidValue;
}
