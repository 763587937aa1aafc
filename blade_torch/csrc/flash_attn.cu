// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces two TPU kernels of blade/kernels/block_sparse_attn.py:
//   * _dense_fwd_kernel       -> bt_attn_dense_fwd  (flash_attention,
//     flash_attention_wide_v, the dense branch of block_sparse_attention)
//   * _sparse_fwd_rows_kernel -> bt_attn_sparse_fwd (block_sparse_attention
//     over ascending per-row key-block lists and pack_kv records)
//
// Semantics kept from the TPU kernels: f32 online softmax in base 2 with the
// scalar `bias` folded into the LSE only; keys at or past `lk` are masked;
// V's width `dv` is independent of d; the LSE is natural-log; a row that
// attends to nothing gives out 0 and lse -1e30.
//
// What bounds it on the H100: tensor-core math.  Every 64x64 score tile costs
// 2*64*64*(d + dv) flops against 64*(d + dv)*2 bytes of K/V, i.e. 64 flops a
// byte per CTA, and the CTAs of one head re-read the same K/V tiles from L2,
// so device memory is not the limit; the matrix products are.  The design
// therefore puts both
// products on mma.sync m16n8k16 bf16 tensor cores, keeps the score tile,
// the softmax carry and the output accumulator in registers (FA2 layout:
// each warp owns 16 query rows, the score fragment is reused in registers
// as the A operand of P @ V), and streams K/V tiles through shared memory
// with 16-byte vector loads.  This first version is synchronous (no cp.async
// or TMA pipeline, no wgmma); several CTAs per SM hide part of the latency.
// A dv wider than 128 is split over blockIdx.z so the accumulator stays at
// 64 registers a thread; each split recomputes the scores.
//
// Sparse variant: one CTA covers 64 of the 128 query rows of one mask row,
// reads that row's count and ascending list, and walks the listed 128-key
// blocks as two 64-key halves of the packed [K rows | V rows] record that
// bt_pack_kv writes.  The TPU kernel's SPARSE_ROWS/GROUP/NBUF DMA machinery,
// list replication and d = 64 lane packing are not carried over.
// The tile (WarpState, load_tile, attend_tile, store_rows) lives in
// flash_tile.cuh, shared with the multi-level kernel.
#include "flash_tile.cuh"

namespace bt {

// Dense: k [BH, lk, D], v [BH, lk, dv].  Sparse: k holds pack_kv records
// [BH, n_kt, 2, 128, D] (v unused, dv == DVC == D) and lists/counts select
// the key blocks of each 128-row mask row.
template <int D, int DVC, bool SPARSE>
__global__ void __launch_bounds__(NTHREADS)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ lists,
                const int* __restrict__ counts, bf16* __restrict__ out,
                float* __restrict__ lse, int lq, int lk, int dv, int n_qt,
                int max_k, float c, float bias) {
  __shared__ __align__(16) bf16 ks[BN * (D + 8)];
  __shared__ __align__(16) bf16 vs[BN * (DVC + 8)];
  const int bh = blockIdx.y, zc = blockIdx.z, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  WarpState<D, DVC> st;
  init_state(st, q + (size_t)bh * lq * D, r0, r1, lq);

  if (!SPARSE) {
    const bf16* kb = k + (size_t)bh * lk * D;
    const bf16* vb = v + (size_t)bh * lk * dv + zc * DVC;
    const int n_tiles = (lk + BN - 1) / BN;
    for (int it = 0; it < n_tiles; ++it) {
      const int key0 = it * BN;
      const int nvalid = min(BN, lk - key0);
      __syncthreads();
      load_tile<D>(ks, kb + (size_t)key0 * D, D, nvalid);
      load_tile<DVC>(vs, vb + (size_t)key0 * dv, dv, nvalid);
      __syncthreads();
      attend_tile<D, DVC>(st, ks, vs, prefix_valid(nvalid), c, 0.f);
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
        load_tile<D>(ks, rec + ((size_t)blk * 256 + half * 64) * D, D, nvalid);
        load_tile<D>(vs, rec + ((size_t)blk * 256 + 128 + half * 64) * D, D, nvalid);
        __syncthreads();
        attend_tile<D, DVC>(st, ks, vs, prefix_valid(nvalid), c, 0.f);
      }
    }
  }

  store_rows(st, out + (size_t)bh * lq * dv, lse + (size_t)bh * lq, r0, r1, lq, dv,
             zc * DVC, zc == 0, bias);
}

template <int D, int DVC, bool SPARSE>
static void launch(const void* q, const void* k, const void* v, const int* lists,
                   const int* counts, void* out, void* lse, int bh, int lq, int lk,
                   int dv, int n_qt, int max_k, float scale, float bias,
                   cudaStream_t stream) {
  const dim3 grid((lq + BM - 1) / BM, bh, dv / DVC);
  attn_fwd_kernel<D, DVC, SPARSE><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lists, counts, static_cast<bf16*>(out),
      static_cast<float*>(lse), lq, lk, dv, n_qt, max_k, scale * LOG2E, bias);
}

}  // namespace bt

// q [bh, lq, d], k [bh, lk, d], v [bh, lk, dv] bf16 -> out [bh, lq, dv] bf16,
// lse [bh, lq] f32.  d in {64, 128}; dv a multiple of 64.
BT_API int bt_attn_dense_fwd(const void* q, const void* k, const void* v, void* out,
                             void* lse, int bh, int lq, int lk, int d, int dv,
                             float scale, float bias, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lq <= 0 || lk <= 0 || bh <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  if (d == 128 && dv % 128 == 0)
    bt::launch<128, 128, false>(q, k, v, nullptr, nullptr, out, lse, bh, lq, lk, dv, 0, 0, scale, bias, st);
  else if (d == 128 && dv % 64 == 0)
    bt::launch<128, 64, false>(q, k, v, nullptr, nullptr, out, lse, bh, lq, lk, dv, 0, 0, scale, bias, st);
  else if (d == 64 && dv % 128 == 0)
    bt::launch<64, 128, false>(q, k, v, nullptr, nullptr, out, lse, bh, lq, lk, dv, 0, 0, scale, bias, st);
  else if (d == 64 && dv % 64 == 0)
    bt::launch<64, 64, false>(q, k, v, nullptr, nullptr, out, lse, bh, lq, lk, dv, 0, 0, scale, bias, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q [bh, lq, d]; kv_packed [bh, ceil(lk/128), 2, 128, d] (bt_pack_kv);
// lists [bh, n_qt, max_k] ascending key-block indices, counts [bh, n_qt]
// int32 with n_qt = ceil(lq/128) -> out [bh, lq, d] bf16, lse [bh, lq] f32.
BT_API int bt_attn_sparse_fwd(const void* q, const void* kv_packed, const void* lists,
                              const void* counts, void* out, void* lse, int bh, int lq,
                              int lk, int d, int n_qt, int max_k, float scale,
                              float bias, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lq <= 0 || lk <= 0 || bh <= 0 || bh > 65535 || n_qt != (lq + 127) / 128)
    return (int)cudaErrorInvalidValue;
  const int* li = static_cast<const int*>(lists);
  const int* cn = static_cast<const int*>(counts);
  if (d == 128)
    bt::launch<128, 128, true>(q, kv_packed, nullptr, li, cn, out, lse, bh, lq, lk, d, n_qt, max_k, scale, bias, st);
  else if (d == 64)
    bt::launch<64, 64, true>(q, kv_packed, nullptr, li, cn, out, lse, bh, lq, lk, d, n_qt, max_k, scale, bias, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

BT_API const char* bt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
