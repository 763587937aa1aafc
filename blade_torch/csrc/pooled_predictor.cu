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
// What bounds it on the H100: tensor-core math.  The scores take 2 * ls *
// lks * d flops a head against (ls + lks) * d * 2 bytes of input, and the
// output is only ls * lks / TPB^2 floats, so the design recomputes the
// scores instead of storing anything per score.  A CTA of 4 warps owns 64
// sampled query rows, i.e. whole q-blocks (4 of 16 rows or 2 of 32), and
// makes two passes over K in 64-key tiles on mma.sync (score_tile of
// flash_tile.cuh).  Pass 1 keeps each row's max m and sum l (base 2) in
// registers.  Pass 2 recomputes the scores, reduces each (row, k-block) max
// over the thread's columns and the row's 4 lanes by shuffles, turns it into
// exp(max - m) / l, and takes the max over the q-block's rows by shuffles
// (16 rows a warp) and across the two warps of a 32-row block with a
// shared-memory atomicMax on the non-negative floats' bit patterns.  The
// CTA's Po rows (n_kb floats each) stay in shared memory; at the end one
// warp a q-block renormalises its row and writes it.  Not carried over from
// the TPU: the raw [bh, ls, n_kb] f32 maxima buffer in device memory (100 MB
// at Wan 480p with 32 tokens a block), the 512-column padding of K, the
// roll-max tree, the one-hot extraction and the 8-sublane m/l rows.
#include "flash_tile.cuh"

namespace bt {

template <int D, int TPB>
__global__ void __launch_bounds__(NTHREADS)
pooled_scores_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     float* __restrict__ po, int ls, int lks, int n_qb, int n_kb, float c) {
  extern __shared__ float po_s[];  // [BM / TPB][n_kb]
  __shared__ __align__(16) bf16 ks[BN * (D + 8)];
  constexpr int KPT = BN / TPB;  // k-blocks a key tile
  constexpr int JPB = TPB / 8;   // score fragments a k-block
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const bf16* kb = k + (size_t)bh * lks * D;

  WarpState<D, 8> st;
  init_state(st, q + (size_t)bh * ls * D, r0, r1, ls);
  float s[BN / 8][4];

  // Pass 1: each row's running max (base 2) and this thread's share of its sum.
  const int n_tiles = (lks + BN - 1) / BN;
  for (int it = 0; it < n_tiles; ++it) {
    const int nvalid = min(BN, lks - it * BN);
    __syncthreads();
    load_tile<D>(ks, kb + (size_t)it * BN * D, D, nvalid);
    __syncthreads();
    score_tile<D>(st.qf, ks, s);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col >= nvalid) s[j][0] = s[j][2] = -INFINITY;
      if (col + 1 >= nvalid) s[j][1] = s[j][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // Every tile has a live key (column 0), so the new max is finite.
    const float mn0 = fmaxf(st.m[0], mx0 * c), mn1 = fmaxf(st.m[1], mx1 * c);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      ps0 += exp2_approx(s[j][0] * c - mn0) + exp2_approx(s[j][1] * c - mn0);
      ps1 += exp2_approx(s[j][2] * c - mn1) + exp2_approx(s[j][3] * c - mn1);
    }
    st.l[0] = st.l[0] * exp2_approx(st.m[0] - mn0) + ps0;
    st.l[1] = st.l[1] * exp2_approx(st.m[1] - mn1) + ps1;
    st.m[0] = mn0;
    st.m[1] = mn1;
  }
  float l0 = st.l[0], l1 = st.l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);

  // Pass 2: per (q-block, k-block) max of exp(s - m) / l into shared memory.
  for (int i = threadIdx.x; i < (BM / TPB) * n_kb; i += NTHREADS) po_s[i] = 0.f;
  float* po_row = po_s + (warp * 16 / TPB) * n_kb;
  const bool live = q0 + warp * 16 < n_qb * TPB;  // same for the whole warp
  const int n_tiles2 = (n_kb * TPB + BN - 1) / BN;  // tiles holding whole k-blocks
  for (int it = 0; it < n_tiles2; ++it) {
    const int nvalid = min(BN, lks - it * BN);
    __syncthreads();
    load_tile<D>(ks, kb + (size_t)it * BN * D, D, nvalid);
    __syncthreads();
    if (!live) continue;
    score_tile<D>(st.qf, ks, s);
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      const int blk = it * KPT + u;
      if (blk < n_kb) {  // same for the whole warp; such a block has no dead key
        float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
        for (int j = u * JPB; j < (u + 1) * JPB; ++j) {
          x0 = fmaxf(x0, fmaxf(s[j][0], s[j][1]));
          x1 = fmaxf(x1, fmaxf(s[j][2], s[j][3]));
        }
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
        float val = fmaxf(exp2_approx(x0 * c - st.m[0]) * inv0,
                          exp2_approx(x1 * c - st.m[1]) * inv1);
        val = fmaxf(val, __shfl_xor_sync(0xffffffffu, val, 4));
        val = fmaxf(val, __shfl_xor_sync(0xffffffffu, val, 8));
        val = fmaxf(val, __shfl_xor_sync(0xffffffffu, val, 16));
        // val >= 0: its bits order as an int's
        if (lane == 0) atomicMax(reinterpret_cast<int*>(po_row + blk), __float_as_int(val));
      }
    }
  }
  __syncthreads();

  // Renormalise: warp w owns the CTA's q-block w.
  const int qb = q0 / TPB + warp;
  if (warp < BM / TPB && qb < n_qb) {
    const float* row = po_s + warp * n_kb;
    float sum = 0.f;
    for (int i = lane; i < n_kb; i += 32) sum += row[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    float* out = po + ((size_t)bh * n_qb + qb) * n_kb;
    for (int i = lane; i < n_kb; i += 32) out[i] = row[i] / sum;
  }
}

template <int D, int TPB>
static int launch_pooled(const void* q, const void* k, void* po, int bh, int ls, int lks,
                         float scale, cudaStream_t stream) {
  const int n_qb = ls / TPB, n_kb = lks / TPB;
  const size_t smem = (size_t)(BM / TPB) * n_kb * sizeof(float);
  const size_t static_smem = (size_t)BN * (D + 8) * sizeof(bf16);
  if (smem + static_smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = pooled_scores_kernel<D, TPB>;
  if (smem + static_smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((ls + BM - 1) / BM, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(static_cast<const bf16*>(q),
                                         static_cast<const bf16*>(k),
                                         static_cast<float*>(po), ls, lks, n_qb, n_kb,
                                         scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace bt

// q [bh, ls, d], k [bh, lks, d] bf16 (every tpb rows one block's samples) ->
// po [bh, ls / tpb, lks / tpb] f32, rows summing to 1.  d in {64, 128}, tpb
// in {16, 32}, ls and lks positive multiples of tpb.
BT_API int bt_pooled_scores(const void* q, const void* k, void* po, int bh, int ls, int lks,
                            int d, int tpb, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || bh > 65535 || ls <= 0 || lks <= 0 || tpb <= 0 || ls % tpb || lks % tpb)
    return (int)cudaErrorInvalidValue;
  if (d == 128 && tpb == 32) return bt::launch_pooled<128, 32>(q, k, po, bh, ls, lks, scale, st);
  if (d == 128 && tpb == 16) return bt::launch_pooled<128, 16>(q, k, po, bh, ls, lks, scale, st);
  if (d == 64 && tpb == 32) return bt::launch_pooled<64, 32>(q, k, po, bh, ls, lks, scale, st);
  if (d == 64 && tpb == 16) return bt::launch_pooled<64, 16>(q, k, po, bh, ls, lks, scale, st);
  return (int)cudaErrorInvalidValue;
}
