// Dense flash-attention forward for Hopper (sm_90a), bf16 in, f32
// accumulate.
//
// Replaces blade/kernels/block_sparse_attn.py::_dense_fwd_kernel ->
// bt_attn_dense_fwd (flash_attention, flash_attention_wide_v, the dense
// branch of block_sparse_attention).  The block-sparse forward over
// ascending per-row lists, _sparse_fwd_rows_kernel, is bt_attn_sparse_fwd
// in gather_attn.cu.
//
// Semantics kept from the TPU kernel: f32 online softmax in base 2 with the
// scalar `bias` folded into the LSE only; P rounded to bf16 before P @ V;
// keys at or past `lk` are masked; V's width `dv` is independent of d; the
// LSE is natural-log; a row that attends to nothing gives out 0 and lse
// -1e30.
//
// What bounds it on the H100: tensor-core math at every shape the models
// run: 2 * lq * lk * (d + dv) flops a head against (lq + lk) * (d + dv) * 2
// bytes, hundreds of flops a byte (bound at 989 TFLOP/s: the Wan dense leg
// 32760^2 d 128, 6.667 ms; its pooled branch 32760 x 1092, 0.222 ms; the
// Wan predictor 4096^2 d 128 dv 256, 0.156 ms; the Wan2.1-14B predictor
// 9456^2 d 128 dv 640, 5.55 ms; the CogVideoX dense leg 17776^2 d 64, 3.926
// ms; its predictor 2224^2 d 64 dv 256, 0.154 ms).  Only wgmma reaches that
// rate, and only if the tiles arrive while the tensor cores work.  So a CTA
// of 384 threads is warp-specialised (flash_wgmma.cuh): one producer warp
// issues TMA loads through 3-D tensor maps over [bh, l, d] (a box past lk
// comes back zero-filled, never the next head's keys): Q's 128 rows once,
// then K and V tiles into a ring of 2 to 4 stages; its warpgroup gives its
// registers to the two consumer warpgroups (setmaxnreg), which own 64 query
// rows each and interleave on the tensor cores.
// The accumulator of a 64 x DVC chunk of O stays in registers, so a V wider
// than 256 columns is split into chunks of 256 (blockIdx.z) and a tail
// chunk of 64, 128 or 192 in a second launch: ceil(dv / 256) Q K^T passes.
// Key tiles are 128 wide for a V chunk up to 128 and 64 wide above it, to
// keep S, P and O within the consumers' registers.
#include "flash_wgmma.cuh"

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
    const int cw = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) & 3;
    const int r0 = q0 + cw * 64 + warp * 16 + (threadIdx.x & 31) / 4, r1 = r0 + 8;
    const uint32_t q_wg = q_s + cw * 64 * 128;
    float o[DVC / 2];
#pragma unroll
    for (int i = 0; i < DVC / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(q_full, 0);
    consume_tiles<D, BN, DVC, STAGES>(
        o, m0, m1, l0, l1, q_wg, k_s, v_s, k_full, v_full, empty, n_tiles, c,
        [lk](int it, int, float(&)[BN / 2]) { return min(BN, lk - it * BN); });
    store_rows_wg<DVC>(o, m0, m1, l0, l1, out + (size_t)bh * lq * dv, lse + (size_t)bh * lq,
                       r0, r1, lq, dv, col0, col0 == 0, bias);
  }
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

BT_API const char* bt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
