// Union-gathered block-sparse flash-attention forward for Hopper (sm_90a),
// bf16 in, f32 accumulate.
//
// Replaces blade/kernels/block_sparse_attn.py::_sparse_fwd_union_kernel
// (block_sparse_attention with SPARSE_UNION set): the 128-row mask rows go
// in pairs, and each pair walks the ascending UNION of its two rows' key
// blocks (masks.union_block_lists), every entry carrying the block index in
// its low 16 bits and one validity bit per mask row above them.  The result
// is exactly the per-row block-masked attention: out bf16, lse f32 natural
// log; a mask row that selects nothing gives out 0 and lse -1e30.
//
// What bounds it on the H100: tensor-core math, as for the 128-row sparse
// kernel (flash_attn.cu): each listed 128-key block costs 4 * 128 * 128 * d
// flops a mask row against 2 * 128 * d * 2 bytes of K/V.  What the union
// buys is K/V traffic: a block two adjacent rows both selected is read once
// for both.  A CTA of 8 warps owns 128 query rows, 64 of each row of the
// pair (the pair's 256-row tile takes two CTAs, so the accumulators stay
// in registers at 256 threads a CTA), stages each union block once as two
// 64-key tiles of K and V in shared memory, read in place from K and V
// (their 128-row blocks are contiguous; no pack_kv records), and folds them
// into each warp's carry with the shared tile of flash_tile.cuh.  A warp's
// 16 query rows all belong to one mask row, so the validity bit is
// warp-uniform: a warp whose row did not select a block skips it, where the
// TPU kernel masks those rows element by element.  Warps whose rows all lie
// past lq (the empty row that pads an odd mask-row count) skip every block.
#include "flash_tile.cuh"

namespace bt {

constexpr int UNION_WARPS = 8;
constexpr int UNION_THREADS = UNION_WARPS * 32;

template <int D>
__global__ void __launch_bounds__(UNION_THREADS)
attn_sparse_union_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const int* __restrict__ lists,
                         const int* __restrict__ counts, bf16* __restrict__ out,
                         float* __restrict__ lse, int lq, int lk, int n_pairs, int max_u,
                         float c, float bias) {
  __shared__ __align__(16) bf16 ks[BN * (D + 8)];
  __shared__ __align__(16) bf16 vs[BN * (D + 8)];
  const int bh = blockIdx.y, pair = blockIdx.x >> 1, half = blockIdx.x & 1;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r = warp / 4;  // which mask row of the pair
  const int w0 = (2 * pair + r) * 128 + half * 64 + (warp & 3) * 16;  // warp's first row
  const int r0 = w0 + g, r1 = r0 + 8;

  WarpState<D, D> st;
  init_state(st, q + (size_t)bh * lq * D, r0, r1, lq);

  const int cnt = counts[bh * n_pairs + pair];
  const int* lst = lists + ((size_t)bh * n_pairs + pair) * max_u;
  const bf16* kb = k + (size_t)bh * lk * D;
  const bf16* vb = v + (size_t)bh * lk * D;
  const bool rows_live = w0 < lq;
  for (int j = 0; j < cnt; ++j) {
    const int e = lst[j];
    const int blk = e & 0xFFFF;
    const bool mine = rows_live && ((e >> (16 + r)) & 1);
    for (int h = 0; h < 2; ++h) {
      const int key0 = blk * 128 + h * 64;
      const int nvalid = min(BN, lk - key0);
      if (nvalid <= 0) continue;  // same for every thread of the CTA
      __syncthreads();
      load_tile<D, UNION_THREADS>(ks, kb + (size_t)key0 * D, D, nvalid);
      load_tile<D, UNION_THREADS>(vs, vb + (size_t)key0 * D, D, nvalid);
      __syncthreads();
      if (mine) attend_tile<D, D>(st, ks, vs, prefix_valid(nvalid), c);
    }
  }

  store_rows(st, out + (size_t)bh * lq * D, lse + (size_t)bh * lq, r0, r1, lq, D, 0, true,
             bias);
}

template <int D>
static void launch_union(const void* q, const void* k, const void* v, const int* lists,
                         const int* counts, void* out, void* lse, int bh, int lq, int lk,
                         int n_pairs, int max_u, float scale, float bias,
                         cudaStream_t stream) {
  const dim3 grid(2 * n_pairs, bh);
  attn_sparse_union_kernel<D><<<grid, UNION_THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      lists, counts, static_cast<bf16*>(out), static_cast<float*>(lse), lq, lk, n_pairs,
      max_u, scale * LOG2E, bias);
}

}  // namespace bt

// q [bh, lq, d], k, v [bh, lk, d] bf16; lists [bh, n_pairs, max_u] int32
// entries (block | valbits << 16), ascending union of mask rows 2i and 2i+1,
// counts [bh, n_pairs], n_pairs = ceil(ceil(lq / 128) / 2) -> out [bh, lq, d]
// bf16, lse [bh, lq] f32.  d in {64, 128}; ceil(lk / 128) < 65536.
BT_API int bt_attn_sparse_union_fwd(const void* q, const void* k, const void* v,
                                    const void* lists, const void* counts, void* out,
                                    void* lse, int bh, int lq, int lk, int d, int n_pairs,
                                    int max_u, float scale, float bias, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_qt = (lq + 127) / 128;
  if (lq <= 0 || lk <= 0 || bh <= 0 || bh > 65535 || n_pairs != (n_qt + 1) / 2 ||
      (lk + 127) / 128 > 65536)
    return (int)cudaErrorInvalidValue;
  const int* li = static_cast<const int*>(lists);
  const int* cn = static_cast<const int*>(counts);
  if (d == 128)
    bt::launch_union<128>(q, k, v, li, cn, out, lse, bh, lq, lk, n_pairs, max_u, scale, bias, st);
  else if (d == 64)
    bt::launch_union<64>(q, k, v, li, cn, out, lse, bh, lq, lk, n_pairs, max_u, scale, bias, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
