// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the four backward kernels of blade/kernels/block_sparse_attn.py
// (reached through _attn_core_bwd -> _bwd_call):
//   * _dense_dq_kernel   -> bt_attn_dense_dq    (flash_attention backward)
//   * _dense_dkv_kernel  -> bt_attn_dense_dkv
//   * _sparse_dq_kernel  -> bt_attn_sparse_dq   (block_sparse_attention
//     backward, walking each mask row's ascending list of pack_kv records)
//   * _sparse_dkv_kernel -> bt_attn_sparse_dkv  (walking the TRANSPOSED lists:
//     for each 128-key block, the ascending 128-row query blocks that chose it)
//
// Semantics kept from the TPU kernels: the forward's scores and softmax are
// recomputed from the saved natural-log LSE in base 2,
//   p  = exp2(s * scale * log2e - (lse - bias) * log2e),
//   ds = p * (dO . v^T + g_lse - delta),   delta = rowsum(dO * O) (computed
//        outside, in torch, as JAX computes it in XLA),
//   dq = scale * ds . k,  dk = scale * ds^T . q,  dv = p^T . dO,
// with p and ds rounded to bf16 before each product, as the TPU kernels feed
// the MXU.  dQ and dK/dV are separate kernels, so no atomics: a dQ CTA owns
// 64 query rows and loops over keys, a dK/dV CTA owns 64 keys and loops over
// queries.  Keys at or past `lk` and query rows at or past `lq` contribute
// nothing.  A row whose LSE is the empty-row marker (-1e30) is treated as
// empty (p = 0): exp2 never sees that LSE.
//
// What bounds it on the H100: tensor-core math, as in the forward (five
// 64 x 64 x d products a tile pair against the forward's two, plus the
// recomputed exp2), with K/V or Q/dO tiles re-read from L2 by the CTAs of
// one head.  The design keeps every product on mma.sync m16n8k16 bf16
// tensor cores with f32 accumulators in registers (the score/ds fragments
// are reused in registers as the A operand of the next product, as the
// forward reuses P), and streams the other side's tiles through shared
// memory with 16-byte loads.  The dK/dV kernel computes the transposed
// scores s^T = K . Q^T directly, so the key dimension is the MMA's row
// dimension and dK, dV accumulate in registers without a transpose; its
// K, V, Q and dO tiles (70 KB at d = 128) live in dynamic shared memory.
// This first version is synchronous (no cp.async / TMA pipeline, no wgmma).
// The tiles (dq_tile, dkv_tile and their loads and stores) are in
// flash_bwd_tile.cuh, shared with pooled_level_bwd.cu.
#include "flash_bwd_tile.cuh"

namespace bt {
namespace bwd {

// Dense: k, v [BH, lk, D].  Sparse: k holds pack_kv records
// [BH, n_kt, 2, 128, D] (v unused) and lists/counts select the key blocks of
// each 128-row mask row.
template <int D, bool SPARSE>
__global__ void __launch_bounds__(NTHREADS)
attn_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ glse, const int* __restrict__ lists,
               const int* __restrict__ counts, bf16* __restrict__ dq, int lq, int lk,
               int n_qt, int max_k, float scale, float bias) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 ks[BN * LD];
  __shared__ __align__(16) bf16 vs[BN * LD];
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float c = scale * LOG2E;

  DqState<D> st;
  init_dq<D>(st, q + (size_t)bh * lq * D, dout + (size_t)bh * lq * D, lse + (size_t)bh * lq,
             delta + (size_t)bh * lq, glse + (size_t)bh * lq, r0, r1, lq, bias);

  if (!SPARSE) {
    const bf16* kb = k + (size_t)bh * lk * D;
    const bf16* vb = v + (size_t)bh * lk * D;
    for (int key0 = 0; key0 < lk; key0 += BN) {
      const int nvalid = min(BN, lk - key0);
      __syncthreads();
      load_rows<D>(ks, kb + (size_t)key0 * D, D, nvalid);
      load_rows<D>(vs, vb + (size_t)key0 * D, D, nvalid);
      __syncthreads();
      dq_tile<D>(st, ks, vs, prefix_valid(nvalid), c);
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
        load_rows<D>(ks, rec + ((size_t)blk * 256 + half * 64) * D, D, nvalid);
        load_rows<D>(vs, rec + ((size_t)blk * 256 + 128 + half * 64) * D, D, nvalid);
        __syncthreads();
        dq_tile<D>(st, ks, vs, prefix_valid(nvalid), c);
      }
    }
  }

  store_dq<D>(st, dq + (size_t)bh * lq * D, r0, r1, lq, scale);
}

// Dense: every query tile.  Sparse: the query blocks of this key block's
// transposed list (t_lists [BH, n_kt, max_q], t_counts [BH, n_kt]); the CTA
// covers 64 keys, half of one 128-key block.
template <int D, bool SPARSE>
__global__ void __launch_bounds__(NTHREADS)
attn_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ glse, const int* __restrict__ t_lists,
                const int* __restrict__ t_counts, bf16* __restrict__ dk_out,
                bf16* __restrict__ dv_out, int lq, int lk, int n_kt, int max_q,
                float scale, float bias) {
  using S = DkvSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + S::TILE;
  bf16* qs = vs + S::TILE;
  bf16* dos = qs + S::TILE;
  float* lse2s = reinterpret_cast<float*>(dos + S::TILE);
  float* rests = lse2s + 64;

  const int bh = blockIdx.y, key0 = blockIdx.x * BM;
  if (key0 >= lk) return;  // the ragged last block's empty half (sparse grid)
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int k0 = key0 + warp * 16 + g, k1 = k0 + 8;
  const float c = scale * LOG2E;

  const int nkeys = min(BM, lk - key0);
  load_rows<D>(ks, k + ((size_t)bh * lk + key0) * D, D, nkeys);
  load_rows<D>(vs, v + ((size_t)bh * lk + key0) * D, D, nkeys);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const bf16* qb = q + (size_t)bh * lq * D;
  const bf16* db = dout + (size_t)bh * lq * D;
  const float* lse_b = lse + (size_t)bh * lq;
  const float* delta_b = delta + (size_t)bh * lq;
  const float* glse_b = glse + (size_t)bh * lq;
  const bool kv0 = k0 < lk, kv1 = k1 < lk;

  if (!SPARSE) {
    for (int row0 = 0; row0 < lq; row0 += BN) {
      __syncthreads();
      load_query_tile<D>(qs, dos, lse2s, rests, qb, db, lse_b, delta_b, glse_b, row0, lq,
                         bias);
      __syncthreads();
      dkv_tile<D>(dk, dv, ks, vs, qs, dos, lse2s, rests, kv0, kv1, c);
    }
  } else {
    const int blk = key0 / 128;
    const int cnt = t_counts[bh * n_kt + blk];
    const int* lst = t_lists + ((size_t)bh * n_kt + blk) * max_q;
    for (int j = 0; j < cnt; ++j) {
      const int qblk = lst[j];
      for (int half = 0; half < 2; ++half) {
        const int row0 = qblk * 128 + half * 64;
        if (row0 >= lq) continue;  // same for every thread of the CTA
        __syncthreads();
        load_query_tile<D>(qs, dos, lse2s, rests, qb, db, lse_b, delta_b, glse_b, row0,
                           lq, bias);
        __syncthreads();
        dkv_tile<D>(dk, dv, ks, vs, qs, dos, lse2s, rests, kv0, kv1, c);
      }
    }
  }

  store_dkv<D>(dk, dv, dk_out + (size_t)bh * lk * D, dv_out + (size_t)bh * lk * D, k0, k1,
               kv0, kv1, scale);
}

template <int D, bool SPARSE>
static int launch_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* glse,
                     const void* lists, const void* counts, void* dq, int bh, int lq,
                     int lk, int n_qt, int max_k, float scale, float bias,
                     cudaStream_t stream) {
  const dim3 grid((lq + BM - 1) / BM, bh);
  attn_dq_kernel<D, SPARSE><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(glse), static_cast<const int*>(lists),
      static_cast<const int*>(counts), static_cast<bf16*>(dq), lq, lk, n_qt, max_k, scale,
      bias);
  return (int)cudaGetLastError();
}

template <int D, bool SPARSE>
static int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* glse,
                      const void* t_lists, const void* t_counts, void* dk, void* dv, int bh,
                      int lq, int lk, int n_kt, int max_q, float scale, float bias,
                      cudaStream_t stream) {
  constexpr size_t smem = DkvSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(attn_dkv_kernel<D, SPARSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int key_ctas = SPARSE ? 2 * n_kt : (lk + BM - 1) / BM;
  const dim3 grid(key_ctas, bh);
  attn_dkv_kernel<D, SPARSE><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(glse), static_cast<const int*>(t_lists),
      static_cast<const int*>(t_counts), static_cast<bf16*>(dk), static_cast<bf16*>(dv), lq,
      lk, n_kt, max_q, scale, bias);
  return (int)cudaGetLastError();
}

static bool bad_dims(int bh, int lq, int lk) {
  return lq <= 0 || lk <= 0 || bh <= 0 || bh > 65535;
}

}  // namespace bwd
}  // namespace bt

// All tensors contiguous: q, dout [bh, lq, d]; k, v [bh, lk, d] bf16; lse,
// delta, glse [bh, lq] f32 -> dq [bh, lq, d] bf16.  d in {64, 128}.
BT_API int bt_attn_dense_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* glse, void* dq,
                            int bh, int lq, int lk, int d, float scale, float bias,
                            void* stream) {
  using namespace bt::bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_dims(bh, lq, lk)) return (int)cudaErrorInvalidValue;
  if (d == 128)
    return launch_dq<128, false>(q, k, v, dout, lse, delta, glse, nullptr, nullptr, dq, bh,
                                 lq, lk, 0, 0, scale, bias, st);
  if (d == 64)
    return launch_dq<64, false>(q, k, v, dout, lse, delta, glse, nullptr, nullptr, dq, bh,
                                lq, lk, 0, 0, scale, bias, st);
  return (int)cudaErrorInvalidValue;
}

// As bt_attn_dense_dq -> dk, dv [bh, lk, d] bf16.
BT_API int bt_attn_dense_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* glse, void* dk,
                             void* dv, int bh, int lq, int lk, int d, float scale,
                             float bias, void* stream) {
  using namespace bt::bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_dims(bh, lq, lk)) return (int)cudaErrorInvalidValue;
  if (d == 128)
    return launch_dkv<128, false>(q, k, v, dout, lse, delta, glse, nullptr, nullptr, dk, dv,
                                  bh, lq, lk, 0, 0, scale, bias, st);
  if (d == 64)
    return launch_dkv<64, false>(q, k, v, dout, lse, delta, glse, nullptr, nullptr, dk, dv,
                                 bh, lq, lk, 0, 0, scale, bias, st);
  return (int)cudaErrorInvalidValue;
}

// q, dout [bh, lq, d]; kv_packed [bh, ceil(lk/128), 2, 128, d] (bt_pack_kv);
// lse, delta, glse [bh, lq] f32; lists [bh, n_qt, max_k] ascending key
// blocks, counts [bh, n_qt] int32 (the forward's lists) -> dq [bh, lq, d].
BT_API int bt_attn_sparse_dq(const void* q, const void* kv_packed, const void* dout,
                             const void* lse, const void* delta, const void* glse,
                             const void* lists, const void* counts, void* dq, int bh, int lq,
                             int lk, int d, int n_qt, int max_k, float scale, float bias,
                             void* stream) {
  using namespace bt::bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_dims(bh, lq, lk) || n_qt != (lq + 127) / 128) return (int)cudaErrorInvalidValue;
  if (d == 128)
    return launch_dq<128, true>(q, kv_packed, nullptr, dout, lse, delta, glse, lists, counts,
                                dq, bh, lq, lk, n_qt, max_k, scale, bias, st);
  if (d == 64)
    return launch_dq<64, true>(q, kv_packed, nullptr, dout, lse, delta, glse, lists, counts,
                               dq, bh, lq, lk, n_qt, max_k, scale, bias, st);
  return (int)cudaErrorInvalidValue;
}

// q, dout [bh, lq, d]; k, v [bh, lk, d]; stats as above; t_lists
// [bh, n_kt, max_q] ascending query blocks per key block, t_counts
// [bh, n_kt] int32 (lists of the transposed mask) -> dk, dv [bh, lk, d].
BT_API int bt_attn_sparse_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* glse,
                              const void* t_lists, const void* t_counts, void* dk, void* dv,
                              int bh, int lq, int lk, int d, int n_kt, int max_q,
                              float scale, float bias, void* stream) {
  using namespace bt::bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_dims(bh, lq, lk) || n_kt != (lk + 127) / 128) return (int)cudaErrorInvalidValue;
  if (d == 128)
    return launch_dkv<128, true>(q, k, v, dout, lse, delta, glse, t_lists, t_counts, dk, dv,
                                 bh, lq, lk, n_kt, max_q, scale, bias, st);
  if (d == 64)
    return launch_dkv<64, true>(q, k, v, dout, lse, delta, glse, t_lists, t_counts, dk, dv,
                                bh, lq, lk, n_kt, max_q, scale, bias, st);
  return (int)cudaErrorInvalidValue;
}
