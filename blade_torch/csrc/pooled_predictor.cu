// The "max" mask predictor's pooled score estimate for Hopper (sm_90a), bf16
// in, f32 scores, statistics and output.
//
// Replaces blade/kernels/pooled_predictor.py::_kernel (with the XLA epilogue
// of pooled_scores_kernel_call): over the sampled sequences q [bh, ls, d],
// k [bh, lks, d], every TPB rows one 128-token block,
//   Po[bh, i, j] = max over rows m of q-block i and keys n of k-block j of
//                  exp(s[m, n] - m_m) / max(l_m, 1e-30),
// s = q k^T * scale, m_m and l_m the row's max and sum of exp over every key
// (keys past lks masked), then each Po row renormalised to sum to 1.
//
// What bounds it on the H100: the scores, 2 * ls * lks * d tensor-core flops
// a head (Wan 480p, 32 tokens: 0.21 ms at 989 TFLOP/s), and beside them one
// exp2 a score for the row sums, which at 16 a clock an SM takes about as
// long at d = 128 and longer at d = 64.  The input is (ls + lks) * d * 2
// bytes and the output ls * lks / TPB^2 floats, so the design makes ONE pass
// over K and keeps no score: a CTA of 384 threads is the dense forward's
// (flash_attn.cu, flash_wgmma.cuh), one producer warp streaming 128-key
// tiles of k through a TMA ring (zero fill past lks) and two consumer
// warpgroups of 64 sampled rows, i.e. whole q-blocks (4 of 16 rows or 2 of
// 32), that compute S = Q K^T on wgmma, one warpgroup's fold running under
// the other's product.  Folding a tile, on the accumulator in registers:
//   * the row's base-2 running max m and sum l, the one exp2 a score;
//   * each (row, k-block) RAW max: a max over the thread's fragment columns
//     of the k-block, then across the row's four lanes by a reduce-scatter
//     (lane pairs 1 apart split the tile's k-blocks, then pairs 2 apart), so
//     each lane holds a quarter of them and writes those to `raw` [bh, ls,
//     n_kb] f32, the TPU kernel's raw-maxima buffer, in device memory (101
//     MB at Wan 480p with 32 tokens: the rows' values cannot be turned into
//     probabilities before m and l are final, and 128 rows x 591 k-blocks
//     of the 14B grid do not fit in shared memory beside the ring).
// Keys past lks are zero-filled by TMA and score -inf before both the
// statistics and the maxima.  After the last tile each warpgroup writes its
// rows' m and 1 / l to shared memory and, behind a barrier of its 128
// threads, reads its rows' raw maxima back (written moments before by the
// same SM, so mostly from L2): a thread a k-block j, for each q-block the
// max over its rows of exp2(raw c - m) / l, written to Po, summed per
// q-block across the warpgroup, then Po divided by that sum.  One launch,
// no second pass over K.  Not carried over from the TPU: the 512-column
// padding of K, the roll-max tree, the one-hot extraction and the
// 8-sublane m/l rows.
#include "flash_wgmma.cuh"

namespace bt {

template <int D>
struct PooledTile {
  static constexpr int BM = 128;       // sampled query rows a CTA
  static constexpr int BN = 128;       // sampled keys a ring stage
  static constexpr int THREADS = 384;  // producer + 2 consumer warpgroups
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int K_BYTES = BN * D * 2;
  static constexpr int BAR_BYTES = 128;
  // The rows' m and 1 / l [BM] each; partial Po row sums [2 warpgroups][4
  // warps][4 q-blocks].
  static constexpr int STAT_FLOATS = 2 * BM + 2 * 4 * 4;
  static constexpr int FIT =
      (232448 - 1024 - BAR_BYTES - STAT_FLOATS * 4 - Q_BYTES) / K_BYTES;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  // + 1024: the dynamic base is aligned up to the swizzle period.
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * K_BYTES + BAR_BYTES + STAT_FLOATS * 4;
  static_assert(STAGES >= 2, "two ring stages must fit");
  static_assert(8 * (1 + 2 * STAGES) <= BAR_BYTES, "barrier space");
};

// Named barrier `id` of `n` threads (0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// x[0, N) hold one row's maxima of N k-blocks on each lane of the row;
// lanes t and t ^ mask split them: the lane with that bit set keeps the
// upper half, its partner the lower, each the max of both lanes' values, in
// x[0, N / 2).
template <int N, int M>
__device__ __forceinline__ void keep_half(float (&x)[M], int mask) {
  const bool upper = threadIdx.x & mask;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? x[i] : x[i + N / 2];
    const float keep = upper ? x[i + N / 2] : x[i];
    x[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, mask));
  }
}

// Fold one tile's raw scores s (64 rows x 128 keys, accumulator layout;
// keys at or past `nvalid` dead) into rows g / g + 8's base-2 max m0 / m1
// and this thread's share of their sums l0 / l1, and write the rows' raw
// k-block maxima to row0 / row1 [n_kb] (null: a row past ls) from k-block
// kb0 on.
template <int TPB>
__device__ __forceinline__ void fold_tile(float (&s)[64], int nvalid, float c, float& m0,
                                          float& m1, float& l0, float& l1, float* row0,
                                          float* row1, int kb0, int n_kb) {
  constexpr int KPT = 128 / TPB, JPB = TPB / 8;  // k-blocks a tile, n8 blocks a k-block
  const int t = threadIdx.x & 3;
  if (nvalid < 128) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j * 8 + 2 * t + e >= nvalid) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
  }
  float x0[KPT], x1[KPT];
#pragma unroll
  for (int u = 0; u < KPT; ++u) {
    x0[u] = x1[u] = -INFINITY;
#pragma unroll
    for (int j = u * JPB; j < (u + 1) * JPB; ++j) {
      x0[u] = fmaxf(x0[u], fmaxf(s[4 * j], s[4 * j + 1]));
      x1[u] = fmaxf(x1[u], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  }
  keep_half<KPT>(x0, 1);
  keep_half<KPT>(x1, 1);
  keep_half<KPT / 2>(x0, 2);
  keep_half<KPT / 2>(x1, 2);
  // Lane t now holds the row maxima of k-blocks first + i, i < KPT / 4.
  const int first = (t & 1) * (KPT / 2) + ((t >> 1) & 1) * (KPT / 4);
  float mx0 = x0[0], mx1 = x1[0];
#pragma unroll
  for (int i = 0; i < KPT / 4; ++i) {
    mx0 = fmaxf(mx0, x0[i]);
    mx1 = fmaxf(mx1, x1[i]);
    const int kb = kb0 + first + i;
    if (kb < n_kb) {  // a k-block lies wholly inside or wholly past lks
      if (row0) row0[kb] = x0[i];
      if (row1) row1[kb] = x1[i];
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // Column 0 of every tile is a live key, so the new max is finite.
  const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    ps0 += exp2_approx(fmaf(s[4 * j], c, -mn0)) + exp2_approx(fmaf(s[4 * j + 1], c, -mn0));
    ps1 += exp2_approx(fmaf(s[4 * j + 2], c, -mn1)) + exp2_approx(fmaf(s[4 * j + 3], c, -mn1));
  }
  l0 = l0 * exp2_approx(m0 - mn0) + ps0;
  l1 = l1 * exp2_approx(m1 - mn1) + ps1;
  m0 = mn0;
  m1 = mn1;
}

// One CTA: sampled rows [q0, q0 + 128) of head blockIdx.y against every
// sampled key, q0 = blockIdx.x * 128.  Maps: q [bh, ls, D], k [bh, lks, D]
// (boxes 64 x 128), 128-byte swizzled.
template <int D, int TPB>
__global__ void __launch_bounds__(PooledTile<D>::THREADS, 1)
pooled_scores_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk, float* __restrict__ raw,
                     float* __restrict__ po, int ls, int lks, int n_kb, float c) {
  using T = PooledTile<D>;
  constexpr int BN = T::BN, STAGES = T::STAGES, KB = T::K_BYTES;
  constexpr int QB = 64 / TPB;  // q-blocks a warpgroup
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t q_s = (base + 1023u) & ~1023u;
  const uint32_t k_s = q_s + T::Q_BYTES;  // stage s at k_s + s * KB
  const uint32_t bar = k_s + STAGES * KB;
  // Barriers: Q, then full and empty of each stage.
  const uint32_t q_full = bar, full = bar + 8, empty = full + 8 * STAGES;
  float* stats = reinterpret_cast<float*>(smem_raw + (bar + T::BAR_BYTES - base));

  const int bh = blockIdx.y, q0 = blockIdx.x * T::BM;
  const int n_tiles = (lks + BN - 1) / BN;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        tma_load_3d(q_s + cb * 128 * 128, &tq, q_full, cb * 64, q0, bh);
      int stage = 0, phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full + 8 * stage, KB);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_3d(k_s + stage * KB + cb * BN * 128, &tk, full + 8 * stage, cb * 64, it * BN,
                      bh);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 sampled rows each ----
  setmaxnreg_inc<232>();
  const int cw = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int lr0 = cw * 64 + warp * 16 + lane / 4, lr1 = lr0 + 8;  // rows within the CTA
  const uint32_t q_wg = q_s + cw * 64 * 128;
  float* raw_h = raw + (size_t)bh * ls * n_kb;
  float* row0 = q0 + lr0 < ls ? raw_h + (size_t)(q0 + lr0) * n_kb : nullptr;
  float* row1 = q0 + lr1 < ls ? raw_h + (size_t)(q0 + lr1) * n_kb : nullptr;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[BN / 2];
  // One score buffer: a warpgroup waits for its scores before folding them,
  // so its fold overlaps only the other warpgroup's Q K^T.  A second buffer
  // issued before the fold stays in flight across the loop's back-edge, and
  // ptxas then serialises every wgmma (C7515), which measured slower on the
  // H100; ordering the two warpgroups' products by named barriers measured
  // no faster than this.
  mbar_wait(q_full, 0);
  int stage = 0, phase = 0;
  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(full + 8 * stage, phase);
    fence_regs(s);
    wgmma_fence();
    issue_scores<D, BN>(s, q_wg, k_s + stage * KB);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(empty + 8 * stage);  // the scores are in registers
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    fold_tile<TPB>(s, lks - it * BN, c, m0, m1, l0, l1, row0, row1, it * (BN / TPB), n_kb);
  }

  // ---- epilogue: the warpgroup's q-blocks ----
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* st_m = stats;
  float* st_inv = stats + T::BM;
  float* part = stats + 2 * T::BM + cw * 16;  // [warp][q-block]
  if ((lane & 3) == 0) {
    st_m[lr0] = m0;
    st_m[lr1] = m1;
    st_inv[lr0] = 1.f / fmaxf(l0, 1e-30f);
    st_inv[lr1] = 1.f / fmaxf(l1, 1e-30f);
  }
  __threadfence_block();  // the raw maxima and the statistics, to the warpgroup
  bar_sync(1 + cw, 128);
  const int tid = threadIdx.x & 127, n_qb = ls / TPB, qb0 = (q0 + cw * 64) / TPB;
  const int nq = min(QB, n_qb - qb0);  // live q-blocks (none past ls)
  const float* rw = raw_h + (size_t)(q0 + cw * 64) * n_kb;
  const float* wm = st_m + cw * 64;
  const float* wi = st_inv + cw * 64;
  float* pw = po + ((size_t)bh * n_qb + qb0) * n_kb;
  float sum[QB];
#pragma unroll
  for (int i = 0; i < QB; ++i) sum[i] = 0.f;
  for (int j = tid; j < n_kb; j += 128) {
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      if (i < nq) {
        float v = 0.f;
#pragma unroll 8
        for (int r = i * TPB; r < (i + 1) * TPB; ++r)
          v = fmaxf(v, exp2_approx(fmaf(rw[(size_t)r * n_kb + j], c, -wm[r])) * wi[r]);
        pw[(size_t)i * n_kb + j] = v;
        sum[i] += v;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < QB; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
    if (lane == 0) part[warp * 4 + i] = sum[i];
  }
  bar_sync(1 + cw, 128);
  float inv[QB];
#pragma unroll
  for (int i = 0; i < QB; ++i)
    inv[i] = 1.f / (part[i] + part[4 + i] + part[8 + i] + part[12 + i]);
  for (int j = tid; j < n_kb; j += 128) {
#pragma unroll
    for (int i = 0; i < QB; ++i)
      if (i < nq) pw[(size_t)i * n_kb + j] *= inv[i];
  }
}

template <int D, int TPB>
static int launch_pooled(const void* q, const void* k, void* raw, void* po, int bh, int ls,
                         int lks, float scale, cudaStream_t stream) {
  using T = PooledTile<D>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        pooled_scores_kernel<D, TPB>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  CUtensorMap tq, tk;
  if (!make_map(&tq, q, bh, ls, D, T::BM) || !make_map(&tk, k, bh, lks, D, T::BN))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((ls + T::BM - 1) / T::BM, bh);
  pooled_scores_kernel<D, TPB><<<grid, T::THREADS, T::SMEM, stream>>>(
      tq, tk, static_cast<float*>(raw), static_cast<float*>(po), ls, lks, lks / TPB,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace bt

// q [bh, ls, d], k [bh, lks, d] bf16 (every tpb rows one block's samples);
// raw [bh, ls, lks / tpb] f32 scratch -> po [bh, ls / tpb, lks / tpb] f32,
// rows summing to 1.  d in {64, 128}, tpb in {16, 32}, ls and lks positive
// multiples of tpb; q and k 16-byte aligned.
BT_API int bt_pooled_scores(const void* q, const void* k, void* raw, void* po, int bh, int ls,
                            int lks, int d, int tpb, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || bh > 65535 || ls <= 0 || lks <= 0 || tpb <= 0 || ls % tpb || lks % tpb)
    return (int)cudaErrorInvalidValue;
  if (d == 128 && tpb == 32) return bt::launch_pooled<128, 32>(q, k, raw, po, bh, ls, lks, scale, st);
  if (d == 128 && tpb == 16) return bt::launch_pooled<128, 16>(q, k, raw, po, bh, ls, lks, scale, st);
  if (d == 64 && tpb == 32) return bt::launch_pooled<64, 32>(q, k, raw, po, bh, ls, lks, scale, st);
  if (d == 64 && tpb == 16) return bt::launch_pooled<64, 16>(q, k, raw, po, bh, ls, lks, scale, st);
  return (int)cudaErrorInvalidValue;
}
