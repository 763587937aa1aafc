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
#include "common.cuh"

namespace bt {

constexpr int BM = 64;  // query rows per CTA: 4 warps x 16 rows
constexpr int BN = 64;  // keys per shared-memory tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF_LSE = -1e30f;

template <int D, int DVC>
struct WarpState {
  uint32_t qf[D / 16][4];  // this warp's 16 query rows as A fragments
  float o[DVC / 8][4];     // output accumulator, 16 rows x DVC columns
  float m[2];              // running max in base-2 units (rows g, g + 8)
  float l[2];              // this thread's share of the running sum
};

// rows [0, nvalid) of a BN x W tile (row stride `ld` elements) into shared
// memory rows of stride W + 8; rows past nvalid are zero-filled.
template <int W>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t ld,
                                          int nvalid) {
  constexpr int VPR = W / 8;
  for (int i = threadIdx.x; i < BN * VPR; i += NTHREADS) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (W + 8) + c * 8) = val;
  }
}

template <int D, int DVC>
__device__ __forceinline__ void attend_tile(WarpState<D, DVC>& st, const bf16* ks,
                                            const bf16* vs, int nvalid, float c) {
  constexpr int LDK = D + 8, LDV = DVC + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  float s[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const bf16* kp = ks + (j * 8 + g) * LDK + kk * 16 + 2 * t;
      mma_16816(s[j], st.qf[kk], ld_u32(kp), ld_u32(kp + 8));
    }
  }

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

  const float mn0 = fmaxf(st.m[0], mx0 * c), mn1 = fmaxf(st.m[1], mx1 * c);
  // A row with no live key so far keeps m = -inf; subtract 0 instead so
  // exp2 sees -inf (-> 0) and never -inf - -inf.
  const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
  const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
  const float a0 = exp2_approx(st.m[0] - ms0), a1 = exp2_approx(st.m[1] - ms1);

  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    s[j][0] = exp2_approx(s[j][0] * c - ms0);
    s[j][1] = exp2_approx(s[j][1] * c - ms0);
    s[j][2] = exp2_approx(s[j][2] * c - ms1);
    s[j][3] = exp2_approx(s[j][3] * c - ms1);
    ps0 += s[j][0] + s[j][1];
    ps1 += s[j][2] + s[j][3];
  }
  st.l[0] = st.l[0] * a0 + ps0;
  st.l[1] = st.l[1] * a1 + ps1;
  st.m[0] = mn0;
  st.m[1] = mn1;
#pragma unroll
  for (int n = 0; n < DVC / 8; ++n) {
    st.o[n][0] *= a0;
    st.o[n][1] *= a0;
    st.o[n][2] *= a1;
    st.o[n][3] *= a1;
  }

  // P (rounded to bf16, as the TPU kernel feeds the MXU) @ V.  The score
  // fragment of key tiles 2kk and 2kk+1 is exactly the A fragment of the
  // k-step kk; V's B fragment takes two rows per register.
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const bf16* v0 = vs + (kk * 16 + 2 * t) * LDV + g;
#pragma unroll
    for (int n = 0; n < DVC / 8; ++n) {
      const bf16* vp = v0 + n * 8;
      const uint32_t b0 = pack_bf16_raw(vp[0], vp[LDV]);
      const uint32_t b1 = pack_bf16_raw(vp[8 * LDV], vp[9 * LDV]);
      mma_16816(st.o[n], pa, b0, b1);
    }
  }
}

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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  WarpState<D, DVC> st;
  const bf16* qb = q + (size_t)bh * lq * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + 2 * t;
    st.qf[kk][0] = r0 < lq ? ld_u32(qb + (size_t)r0 * D + col) : 0u;
    st.qf[kk][1] = r1 < lq ? ld_u32(qb + (size_t)r1 * D + col) : 0u;
    st.qf[kk][2] = r0 < lq ? ld_u32(qb + (size_t)r0 * D + col + 8) : 0u;
    st.qf[kk][3] = r1 < lq ? ld_u32(qb + (size_t)r1 * D + col + 8) : 0u;
  }
#pragma unroll
  for (int n = 0; n < DVC / 8; ++n) st.o[n][0] = st.o[n][1] = st.o[n][2] = st.o[n][3] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;

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
      attend_tile<D, DVC>(st, ks, vs, nvalid, c);
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
        attend_tile<D, DVC>(st, ks, vs, nvalid, c);
      }
    }
  }

  float l0 = st.l[0], l1 = st.l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int n = 0; n < DVC / 8; ++n) {
    const int col = zc * DVC + n * 8 + 2 * t;
    if (r0 < lq)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)bh * lq + r0) * dv + col) =
          __floats2bfloat162_rn(st.o[n][0] * inv0, st.o[n][1] * inv0);
    if (r1 < lq)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)bh * lq + r1) * dv + col) =
          __floats2bfloat162_rn(st.o[n][2] * inv1, st.o[n][3] * inv1);
  }
  if (zc == 0 && t == 0) {
    if (r0 < lq)
      lse[(size_t)bh * lq + r0] = l0 > 0.f ? st.m[0] * LN2 + bias + logf(l0) : NEG_INF_LSE;
    if (r1 < lq)
      lse[(size_t)bh * lq + r1] = l1 > 0.f ? st.m[1] * LN2 + bias + logf(l1) : NEG_INF_LSE;
  }
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
