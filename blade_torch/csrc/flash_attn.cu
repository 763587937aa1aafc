// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces two TPU kernels of blade/kernels/block_sparse_attn.py:
//   * _dense_fwd_kernel       -> bt_attn_dense_fwd  (flash_attention,
//     flash_attention_wide_v, the dense branch of block_sparse_attention)
//   * _sparse_fwd_rows_kernel -> bt_attn_sparse_fwd (block_sparse_attention
//     over ascending per-row key-block lists and pack_kv records)
//
// Semantics kept from the TPU kernels: f32 online softmax in base 2 with the
// scalar `bias` folded into the LSE only; P rounded to bf16 before P @ V;
// keys at or past `lk` are masked; V's width `dv` is independent of d; the
// LSE is natural-log; a row that attends to nothing gives out 0 and lse
// -1e30.
//
// Dense: what bounds it on the H100 is tensor-core math at every shape the
// models run: 2 * lq * lk * (d + dv) flops a head against (lq + lk) * (d +
// dv) * 2 bytes, hundreds of flops a byte (bound at 989 TFLOP/s: the Wan
// dense leg 32760^2 d 128, 6.667 ms; its pooled branch 32760 x 1092, 0.222
// ms; the Wan predictor 4096^2 d 128 dv 256, 0.156 ms; the Wan2.1-14B
// predictor 9456^2 d 128 dv 640, 5.55 ms; the CogVideoX dense leg 17776^2
// d 64, 3.926 ms; its predictor 2224^2 d 64 dv 256, 0.154 ms).  Only wgmma
// reaches that rate, and only if the tiles arrive while the tensor cores
// work.  So a CTA of 384 threads is warp-specialised:
//   * one producer warp issues TMA loads through 3-D tensor maps over
//     [bh, l, d] (a box past lk comes back zero-filled, never the next
//     head's keys): Q's 128 rows once, then K and V tiles into a ring of
//     2 to 4 stages with full (K, V apart) and empty mbarriers; its
//     warpgroup gives its registers to the consumers (setmaxnreg);
//   * two consumer warpgroups own 64 query rows each.  S = Q K^T is a
//     wgmma with both operands in 128-byte-swizzled shared memory
//     (K-major); the online softmax runs on the accumulator fragment in
//     registers; P is rounded to bf16 in registers and is the register A
//     operand of O += P V, whose B (V) is read from shared memory
//     MN-major, so no fragment is built by hand.  Within a warpgroup the
//     next tile's Q K^T is issued before the current tile's P V and its
//     softmax runs while P V is in flight; the two warpgroups interleave
//     on the tensor cores.
// The accumulator of a 64 x DVC chunk of O stays in registers, so a V wider
// than 256 columns is split into chunks of 256 (blockIdx.z) and a tail
// chunk of 64, 128 or 192 in a second launch: ceil(dv / 256) Q K^T passes.
// Key tiles are 128 wide for a V chunk up to 128 and 64 wide above it, to
// keep S, P and O within the consumers' registers.
//
// Sparse variant (mma.sync, flash_tile.cuh): one CTA covers 64 of the 128
// query rows of one mask row, reads that row's count and ascending list,
// and walks the listed 128-key blocks as two 64-key halves of the packed
// [K rows | V rows] record that bt_pack_kv writes.  The TPU kernel's
// SPARSE_ROWS/GROUP/NBUF DMA machinery, list replication and d = 64 lane
// packing are not carried over.
#include <cuda.h>

#include "flash_tile.cuh"
#include "hopper.cuh"

namespace bt {

// ---- dense: warp-specialised wgmma + TMA ------------------------------------

template <int D, int DVC>
struct DenseTile {
  static constexpr int BM = 128;                    // query rows a CTA
  static constexpr int BN = DVC > 128 ? 64 : 128;   // keys a ring stage
  static constexpr int THREADS = 384;               // producer + 2 consumer warpgroups
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int K_BYTES = BN * D * 2;
  static constexpr int V_BYTES = BN * DVC * 2;
  static constexpr int BAR_BYTES = 128;
  static constexpr int FIT = (232448 - 1024 - BAR_BYTES - Q_BYTES) / (K_BYTES + V_BYTES);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  // + 1024: the dynamic base is aligned up to the swizzle period.
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) + BAR_BYTES;
  static_assert(STAGES >= 2, "two ring stages must fit");
  static_assert(8 * (1 + 3 * STAGES) <= BAR_BYTES, "barrier space");
};

// S (64 x BN) = Q (this warpgroup's 64 rows) K^T, issued and committed.
// q_wg: the warpgroup's rows in column block 0 of Q (column blocks of 128
// rows x 128 bytes); k: one ring stage (column blocks of BN rows).
template <int D, int BN>
__device__ __forceinline__ void issue_scores(float (&s)[BN / 2], uint32_t q_wg, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qa = q_wg + (kk / 4) * (128 * 128) + (kk % 4) * 32;
    const uint32_t kb = k + (kk / 4) * (BN * 128) + (kk % 4) * 32;
    wgmma_ss<BN>(s, desc_sw128(qa, 1, 64), desc_sw128(kb, 1, 64), kk > 0);
  }
  wgmma_commit();
}

// O (64 x DVC) += P (64 x BN, bf16 A fragments) V (BN x DVC), issued and
// committed.  v: one ring stage (column blocks of BN rows x 64 columns).
template <int BN, int DVC>
__device__ __forceinline__ void issue_pv(float (&o)[DVC / 2], const uint32_t (&p)[BN / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<DVC>(o, p[kk], desc_sw128(v + kk * 16 * 128, BN * 8, 64));
  wgmma_commit();
}

// Fold the raw scores of one tile into the carry: keys at or past `nvalid`
// score -inf, s becomes p = 2^(s c - m) in place (f32), m and l advance,
// and (a0, a1) is the factor by which rows g and g + 8 of O must shrink.
template <int BN>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2], float& m0, float& m1,
                                               float& l0, float& l1, float& a0, float& a1,
                                               float c, int nvalid) {
  const int t = threadIdx.x & 3;
  if (nvalid < BN) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j * 8 + 2 * t + e >= nvalid) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
  // A row with no live key so far keeps m = -inf; subtract 0 instead so
  // exp2 sees -inf (-> 0) and never -inf - -inf.
  const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
  const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
  a0 = exp2_approx(m0 - ms0);
  a1 = exp2_approx(m1 - ms1);
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    s[4 * j] = exp2_approx(fmaf(s[4 * j], c, -ms0));
    s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], c, -ms0));
    s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], c, -ms1));
    s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], c, -ms1));
    ps0 += s[4 * j] + s[4 * j + 1];
    ps1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
  m0 = mn0;
  m1 = mn1;
}

// p (f32, accumulator layout) -> bf16 A fragments of P @ V: the fragment of
// key columns 16kk .. 16kk + 15 is n8 blocks 2kk and 2kk + 1.
template <int BN>
__device__ __forceinline__ void to_a_frags(const float (&s)[BN / 2], uint32_t (&p)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// One CTA: 128 query rows of head blockIdx.y against every key, output
// columns [col0, col0 + DVC) with col0 = col_base + blockIdx.z * DVC; the
// chunk at column 0 writes the LSE.  Maps: q [bh, lq, D] (box 64 x 128),
// k [bh, lk, D] and v [bh, lk, dv] (boxes 64 x BN), all 128-byte swizzled.
template <int D, int DVC>
__global__ void __launch_bounds__(DenseTile<D, DVC>::THREADS, 1)
dense_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                 float* __restrict__ lse, int lq, int lk, int dv, int col_base, float c,
                 float bias) {
  using T = DenseTile<D, DVC>;
  constexpr int BN = T::BN, STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + T::Q_BYTES;           // stage s at k_s + s * K_BYTES
  const uint32_t v_s = k_s + STAGES * T::K_BYTES;  // stage s at v_s + s * V_BYTES
  const uint32_t bar = v_s + STAGES * T::V_BYTES;
  // Barriers: Q, then K full, V full and empty of each stage.
  const uint32_t q_full = bar;
  const uint32_t k_full = bar + 8, v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * T::BM, col0 = col_base + blockIdx.z * DVC;
  const int n_tiles = (lk + BN - 1) / BN;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
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
      for (int cb = 0; cb < D / 64; ++cb) tma_load_3d(q_s + cb * 128 * 128, &tq, q_full, cb * 64, q0, bh);
      int stage = 0, phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t kf = k_full + 8 * stage, vf = v_full + 8 * stage;
        mbar_expect_tx(kf, T::K_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_3d(k_s + stage * T::K_BYTES + cb * BN * 128, &tk, kf, cb * 64, it * BN, bh);
        mbar_expect_tx(vf, T::V_BYTES);
#pragma unroll
        for (int cb = 0; cb < DVC / 64; ++cb)
          tma_load_3d(v_s + stage * T::V_BYTES + cb * BN * 128, &tv, vf, col0 + cb * 64,
                      it * BN, bh);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    setmaxnreg_inc<232>();
    const int cw = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + cw * 64 + warp * 16 + g, r1 = r0 + 8;
    const uint32_t q_wg = q_s + cw * 64 * 128;
    float o[DVC / 2], s[BN / 2];
    uint32_t p[BN / 16][4];
#pragma unroll
    for (int i = 0; i < DVC / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;

    mbar_wait(q_full, 0);
    // Tile 0: scores, softmax, P.
    mbar_wait(k_full, 0);
    wgmma_fence();
    issue_scores<D, BN>(s, q_wg, k_s);
    wgmma_wait<0>();
    fence_regs(s);
    online_softmax<BN>(s, m0, m1, l0, l1, a0, a1, c, min(BN, lk));
    to_a_frags<BN>(s, p);
    int ps = 0, pph = 0;  // ring stage and phase of the tile whose P is in p
    for (int it = 1; it < n_tiles; ++it) {
      int stage = ps + 1, phase = pph;
      if (stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      mbar_wait(k_full + 8 * stage, phase);
      fence_regs(s);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      issue_scores<D, BN>(s, q_wg, k_s + stage * T::K_BYTES);
      mbar_wait(v_full + 8 * ps, pph);
      issue_pv<BN, DVC>(o, p, v_s + ps * T::V_BYTES);
      wgmma_wait<1>();  // the scores are in; P @ V may still run
      fence_regs(s);
      online_softmax<BN>(s, m0, m1, l0, l1, a0, a1, c, min(BN, lk - it * BN));
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(empty + 8 * ps);
#pragma unroll
      for (int j = 0; j < DVC / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      to_a_frags<BN>(s, p);
      ps = stage;
      pph = phase;
    }
    mbar_wait(v_full + 8 * ps, pph);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_pv<BN, DVC>(o, p, v_s + ps * T::V_BYTES);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty + 8 * ps);

    // Epilogue: store_rows' semantics (flash_tile.cuh).
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    bf16* ob = out + (size_t)bh * lq * dv;
#pragma unroll
    for (int j = 0; j < DVC / 8; ++j) {
      const int col = col0 + j * 8 + 2 * t;
      if (r0 < lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * dv + col) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * dv + col) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (col0 == 0 && t == 0) {
      float* lb = lse + (size_t)bh * lq;
      if (r0 < lq) lb[r0] = l0 > 0.f ? m0 * LN2 + bias + logf(l0) : NEG_INF_LSE;
      if (r1 < lq) lb[r1] = l1 > 0.f ? m1 * LN2 + bias + logf(l1) : NEG_INF_LSE;
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (the
// library does not link libcuda).
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// 3-D bf16 map over [bh, rows, width] (row-major), box 64 columns x
// box_rows rows x 1 head, 128-byte swizzle, zero fill past the extent.
static bool make_map(CUtensorMap* map, const void* base, int bh, int rows, int width,
                     int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)width * 2 * rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Output columns [col_base, col_base + chunks * DVC) of every row.
template <int D, int DVC>
static int launch_dense(const void* q, const void* k, const void* v, void* out, void* lse,
                        int bh, int lq, int lk, int dv, int chunks, int col_base, float c,
                        float bias, cudaStream_t stream) {
  using T = DenseTile<D, DVC>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_fwd_kernel<D, DVC>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bh, lq, D, T::BM) || !make_map(&tk, k, bh, lk, D, T::BN) ||
      !make_map(&tv, v, bh, lk, dv, T::BN))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((lq + T::BM - 1) / T::BM, bh, chunks);
  dense_fwd_kernel<D, DVC><<<grid, T::THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), lq, lk, dv, col_base, c,
      bias);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_dense_chunks(const void* q, const void* k, const void* v, void* out,
                               void* lse, int bh, int lq, int lk, int dv, int dvc, int chunks,
                               int col_base, float c, float bias, cudaStream_t st) {
  switch (dvc) {
    case 64: return launch_dense<D, 64>(q, k, v, out, lse, bh, lq, lk, dv, chunks, col_base, c, bias, st);
    case 128: return launch_dense<D, 128>(q, k, v, out, lse, bh, lq, lk, dv, chunks, col_base, c, bias, st);
    case 192: return launch_dense<D, 192>(q, k, v, out, lse, bh, lq, lk, dv, chunks, col_base, c, bias, st);
    case 256: return launch_dense<D, 256>(q, k, v, out, lse, bh, lq, lk, dv, chunks, col_base, c, bias, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- sparse: mma.sync over pack_kv records ----------------------------------

// k holds pack_kv records [BH, n_kt, 2, 128, D]; lists/counts select the
// key blocks of each 128-row mask row.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
attn_sparse_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const int* __restrict__ lists, const int* __restrict__ counts,
                       bf16* __restrict__ out, float* __restrict__ lse, int lq, int lk,
                       int n_qt, int max_k, float c, float bias) {
  __shared__ __align__(16) bf16 ks[BN * (D + 8)];
  __shared__ __align__(16) bf16 vs[BN * (D + 8)];
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  WarpState<D, D> st;
  init_state(st, q + (size_t)bh * lq * D, r0, r1, lq);

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
      attend_tile<D, D>(st, ks, vs, prefix_valid(nvalid), c, 0.f);
    }
  }

  store_rows(st, out + (size_t)bh * lq * D, lse + (size_t)bh * lq, r0, r1, lq, D, 0, true,
             bias);
}

template <int D>
static void launch_sparse(const void* q, const void* k, const int* lists, const int* counts,
                          void* out, void* lse, int bh, int lq, int lk, int n_qt, int max_k,
                          float scale, float bias, cudaStream_t stream) {
  const dim3 grid((lq + BM - 1) / BM, bh);
  attn_sparse_fwd_kernel<D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), lists, counts,
      static_cast<bf16*>(out), static_cast<float*>(lse), lq, lk, n_qt, max_k, scale * LOG2E,
      bias);
}

}  // namespace bt

// q [bh, lq, d], k [bh, lk, d], v [bh, lk, dv] bf16 -> out [bh, lq, dv] bf16,
// lse [bh, lq] f32.  d in {64, 128}; dv a positive multiple of 64; all four
// tensors 16-byte aligned.  Chunks of 256 columns in one launch, then the
// tail chunk (64, 128 or 192) in a second.
BT_API int bt_attn_dense_fwd(const void* q, const void* k, const void* v, void* out,
                             void* lse, int bh, int lq, int lk, int d, int dv,
                             float scale, float bias, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lq <= 0 || lk <= 0 || bh <= 0 || bh > 65535 || dv <= 0 || dv % 64 ||
      (d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  const float c = scale * bt::LOG2E;
  const int full = dv / 256, tail = dv % 256;
  int err = 0;
  if (full)
    err = d == 128 ? bt::launch_dense_chunks<128>(q, k, v, out, lse, bh, lq, lk, dv, 256, full, 0, c, bias, st)
                   : bt::launch_dense_chunks<64>(q, k, v, out, lse, bh, lq, lk, dv, 256, full, 0, c, bias, st);
  if (err == 0 && tail)
    err = d == 128 ? bt::launch_dense_chunks<128>(q, k, v, out, lse, bh, lq, lk, dv, tail, 1, full * 256, c, bias, st)
                   : bt::launch_dense_chunks<64>(q, k, v, out, lse, bh, lq, lk, dv, tail, 1, full * 256, c, bias, st);
  return err;
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
    bt::launch_sparse<128>(q, kv_packed, li, cn, out, lse, bh, lq, lk, n_qt, max_k, scale, bias, st);
  else if (d == 64)
    bt::launch_sparse<64>(q, kv_packed, li, cn, out, lse, bh, lq, lk, n_qt, max_k, scale, bias, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

BT_API const char* bt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
