// The mma.sync tile constants and the pooled-segment gather of the pooled
// backward kernels (pooled_level_bwd.cu, through flash_bwd_tile.cuh): a CTA
// of 4 warps owns 64 rows (16 a warp, FA2 register layout) and stages
// 64-row tiles in shared memory, both products on mma.sync m16n8k16 bf16
// tensor cores with f32 accumulation.
#pragma once

#include "common.cuh"

namespace bt {

constexpr int BM = 64;  // query rows per CTA: 4 warps x 16
constexpr int BN = 64;  // keys per shared-memory tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

// Bit j set: tile column j is a live key.
__device__ __forceinline__ unsigned long long prefix_valid(int n) {
  return n >= 64 ? ~0ull : (n <= 0 ? 0ull : ((1ull << n) - 1ull));
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

}  // namespace bt
