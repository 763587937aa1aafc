// Multi-level pooled block-sparse attention forward for Hopper (sm_90a).
//
// Replaces blade/kernels/multilevel_attn.py::_fused_ml_kernel (the fused
// lane of multilevel_attention).  Each (mask row, key block) pair is
// attended at one level: 1 reads the block's 128 keys, L in {2, 4, 8} reads
// its 128/L L-times mean-pooled keys with a +log(L) score bias, and every
// level folds into ONE online-softmax carry, so the kernel writes the merged
// (out, lse) directly.  Inputs: q [BH, lq, d]; the records of
// bt_pack_kv_pyramid (level 1 [BH, n_kt, 2, 128, d], level L
// [BH, n_kt, 2, 128/L, d], K rows then V rows); per-level ascending lists
// idx [BH, n_q, 4, cap] and counts [BH, n_q, 4] (levels 1, 2, 4, 8), mask row
// i covering queries [i * q_rows, (i + 1) * q_rows).  Level-1 keys at or past
// lk and level-L pooled rows at or past ceil(lk / L) are masked (the records
// of the ragged last block hold edge-padded rows).  A row with no key gets
// out 0 and lse -1e30.
//
// What bounds it on the H100: tensor-core math over the selected keys (at
// CogVideoX 480p ~0.74 TFLOP a call against ~0.1 GB of K/V records read),
// plus the list walk.  The design reuses the mma.sync forward tile
// (flash_tile.cuh): one CTA per 64 query rows (4 warps x 16, mma.sync
// m16n8k16, FA2 register layout, base-2 carry) walks its mask row's four
// lists.  Level 1 streams each listed record as two 64-key halves; level L
// packs 64 / (128/L) listed segments into one 64-key shared-memory tile and
// adds log2(L) to its base-2 scores; a 64-bit column mask marks the live
// keys of each tile.  The TPU kernel's FUSED_ROWS grouping, single-shot
// merged tile, band-sized pooled tiles, level-2 DMA pipeline and 8-sublane
// list layout are TPU tilings of the same function and are not carried
// over.  Synchronous loads (no cp.async / TMA,
// no wgmma) in this first version.  The pooled-level walk (walk_pooled) is
// in flash_tile.cuh.
#include "flash_tile.cuh"

namespace bt {

template <int D>
__global__ void __launch_bounds__(NTHREADS)
multilevel_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv1,
                      const bf16* __restrict__ kv2, const bf16* __restrict__ kv4,
                      const bf16* __restrict__ kv8, const int* __restrict__ idx,
                      const int* __restrict__ counts, bf16* __restrict__ out,
                      float* __restrict__ lse, int lq, int lk, int n_q, int cap, int q_rows,
                      float c) {
  __shared__ __align__(16) bf16 ks[BN * (D + 8)];
  __shared__ __align__(16) bf16 vs[BN * (D + 8)];
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  WarpState<D, D> st;
  init_state(st, q + (size_t)bh * lq * D, r0, r1, lq);

  const int n_kt = (lk + 127) / 128;
  const int row = q0 / q_rows;  // q_rows % 64 == 0: one mask row a CTA
  if (row < n_q) {
    const int* rc = counts + ((size_t)bh * n_q + row) * 4;
    const int* rl = idx + ((size_t)bh * n_q + row) * 4 * cap;
    const bf16* rec = kv1 + (size_t)bh * n_kt * 256 * D;
    const int c1 = rc[0];
    for (int j = 0; j < c1; ++j) {
      const int blk = rl[j];
      for (int half = 0; half < 2; ++half) {
        const int nvalid = min(BN, lk - (blk * 128 + half * 64));
        if (nvalid <= 0) continue;  // same for every thread of the CTA
        __syncthreads();
        load_tile<D>(ks, rec + ((size_t)blk * 256 + half * 64) * D, D, nvalid);
        load_tile<D>(vs, rec + ((size_t)blk * 256 + 128 + half * 64) * D, D, nvalid);
        __syncthreads();
        attend_tile<D, D>(st, ks, vs, prefix_valid(nvalid), c, 0.f);
      }
    }
    walk_pooled<D, 64>(st, ks, vs, kv2 + (size_t)bh * n_kt * 128 * D, rl + cap, rc[1],
                       (lk + 1) / 2, c, 1.f);
    walk_pooled<D, 32>(st, ks, vs, kv4 + (size_t)bh * n_kt * 64 * D, rl + 2 * cap, rc[2],
                       (lk + 3) / 4, c, 2.f);
    walk_pooled<D, 16>(st, ks, vs, kv8 + (size_t)bh * n_kt * 32 * D, rl + 3 * cap, rc[3],
                       (lk + 7) / 8, c, 3.f);
  }
  store_rows(st, out + (size_t)bh * lq * D, lse + (size_t)bh * lq, r0, r1, lq, D, 0, true,
             0.f);
}

template <int D>
static void launch_ml(const void* q, const void* kv1, const void* kv2, const void* kv4,
                      const void* kv8, const void* idx, const void* counts, void* out,
                      void* lse, int bh, int lq, int lk, int n_q, int cap, int q_rows,
                      float scale, cudaStream_t stream) {
  const dim3 grid((lq + BM - 1) / BM, bh);
  multilevel_fwd_kernel<D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv1),
      static_cast<const bf16*>(kv2), static_cast<const bf16*>(kv4),
      static_cast<const bf16*>(kv8), static_cast<const int*>(idx),
      static_cast<const int*>(counts), static_cast<bf16*>(out), static_cast<float*>(lse),
      lq, lk, n_q, cap, q_rows, scale * LOG2E);
}

}  // namespace bt

// q [bh, lq, d] bf16; kv1/kv2/kv4/kv8 from bt_pack_kv_pyramid; idx
// [bh, n_q, 4, cap], counts [bh, n_q, 4] int32 -> out [bh, lq, d] bf16,
// lse [bh, lq] f32.  d in {64, 128}; q_rows a multiple of 64 with
// n_q * q_rows >= lq; every listed index < ceil(lk/128), counts <= cap.
BT_API int bt_multilevel_fwd(const void* q, const void* kv1, const void* kv2, const void* kv4,
                             const void* kv8, const void* idx, const void* counts, void* out,
                             void* lse, int bh, int lq, int lk, int d, int n_q, int cap,
                             int q_rows, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lq <= 0 || lk <= 0 || bh <= 0 || bh > 65535 || cap <= 0 || q_rows <= 0 ||
      q_rows % 64 || (long long)n_q * q_rows < lq)
    return (int)cudaErrorInvalidValue;
  if (d == 128)
    bt::launch_ml<128>(q, kv1, kv2, kv4, kv8, idx, counts, out, lse, bh, lq, lk, n_q, cap,
                       q_rows, scale, st);
  else if (d == 64)
    bt::launch_ml<64>(q, kv1, kv2, kv4, kv8, idx, counts, out, lse, bh, lq, lk, n_q, cap,
                      q_rows, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
