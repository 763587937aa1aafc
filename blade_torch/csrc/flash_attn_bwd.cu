// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the four backward kernels of blade/kernels/block_sparse_attn.py
// (reached through _attn_core_bwd -> _bwd_call):
//   * _dense_dq_kernel   -> bt_attn_dense_dq    (flash_attention backward)
//   * _dense_dkv_kernel  -> bt_attn_dense_dkv
//   * _sparse_dq_kernel  -> bt_attn_sparse_dq   (block_sparse_attention
//     backward at seg_rows 128, walking each mask row's ascending list of
//     128-key blocks)
//   * _sparse_dkv_kernel -> bt_attn_sparse_dkv  (walking the TRANSPOSED lists:
//     for each 128-key block, the ascending 128-row query blocks that chose it)
//
// Semantics kept from the TPU kernels: the forward's scores and softmax are
// recomputed from the saved natural-log LSE in base 2,
//   p  = exp2(s * scale * log2e - (lse - bias) * log2e),
//   ds = p * (dO . v^T + g_lse - delta),   delta = rowsum(dO * O) (the
//        caller's: bt_attn_delta, attn_delta.cu, where JAX computes it in XLA),
//   dq = scale * ds . k,  dk = scale * ds^T . q,  dv = p^T . dO,
// with p and ds rounded to bf16 before each product, as the TPU kernels feed
// the MXU.  dQ and dK/dV are separate kernels, so no atomics and the result
// is deterministic: a dQ CTA owns query rows and loops over keys, a dK/dV
// CTA owns keys and loops over queries.  Keys at or past `lk` and query rows
// at or past `lq` contribute nothing.  A row whose LSE is the empty-row
// marker (-1e30) is treated as empty (p = 0): exp2 never sees that LSE.
//
// What bounds it on the H100: tensor-core math, five products of q.k pairs
// x d where the forward has two (dQ: S, dP, dQ; dK/dV: S, dP, dV, dK; the
// pair recomputes S and dP once each: seven in all), plus the recomputed
// exp2.  At the Wan 480p dense leg (32760^2, d 128, 12 heads) the pair's
// seven products take 23.3 ms at 989 TFLOP/s; at its pooled branch (1092
// keys) 0.778 ms; on the Wan 480p energy mask (density 0.21) 4.93 ms.
//
// One design for the dense and the sparse pair, the dense forward's
// (flash_attn.cu): a CTA of 384 threads whose producer warpgroup issues TMA
// loads through 3-D tensor maps over the natural [bh, l, d] tensors (a box
// past a head's rows comes back zero-filled) into a ring of stages with
// full and empty mbarriers, and two consumer warpgroups of 64 rows on
// wgmma, their registers raised with setmaxnreg; the consumers are in
// flash_bwd_wgmma.cuh.  The two pairs differ only in the tiles a CTA walks
// (a Walk: DenseWalk streams every tile, ListWalk the tiles of the 128-row
// blocks listed for the CTA's block, read in place, so the sparse backward
// needs no pack_kv records):
//   * dK/dV: a CTA owns 128 keys with K and V resident; a stage brings 64
//     query rows of Q and dO and, by 1-D TMA boxes over the flattened
//     [bh * lq] statistics (a box starts on a 16-byte boundary, so up to 3
//     rows early), the rows' raw lse, delta and g_lse; a second producer
//     warp, walking the same tiles, turns those into lse2 / rest in the
//     stage, so the consumers read two float2 a column pair.  A consumer
//     runs a tile's four products back to back: at 240 registers a thread,
//     a second tile's S^T and dP^T beside dK, dV and the bf16 fragments
//     spilled, and the two warpgroups already interleave on the tensor cores.
//   * dQ: a CTA owns 128 query rows with Q and dO resident; a stage brings
//     a tile of K and V (64 keys at d = 128, 128 at d = 64: S, dP and dQ
//     in registers); the next tile's S and dP are issued before the current
//     tile's dQ += dS K.
// A sparse CTA with an empty list runs no tile, waits on no barrier and
// writes zero gradients.  Sparse CTAs run their blocks last first: the
// energy lane forces the last two mask rows (and so the last two entries
// of every transposed list) to every block, and a long list launched in
// the last wave sets the kernel's tail (gather_attn.cu does the same).
#include "flash_bwd_wgmma.cuh"

namespace bt {
namespace bwd {

// ---- walks: the tiles a CTA streams ------------------------------------------
//
// walk.at(bh, blockIdx.x) gives the CTA's 128-row block of the resident
// side (`block`), the count of TILE-row tiles it streams from the other
// side (`tiles`) and where tile `it` starts there (`start(it)`); only the
// last tile may reach past `len`, the streamed side's rows.

template <int TILE>
struct DenseWalk {
  int len;
  struct Cta {
    int block, tiles;
    __device__ int start(int it) const { return it * TILE; }
  };
  __device__ Cta at(int, int x) const { return {x, (len + TILE - 1) / TILE}; }
};

// lists [bh, n_blocks, max_len]: each resident block's ascending list of
// streamed 128-row blocks; counts [bh, n_blocks].
template <int TILE>
struct ListWalk {
  static constexpr int TPB = 128 / TILE;  // tiles a listed block
  const int* lists;
  const int* counts;
  int n_blocks, max_len, len;
  struct Cta {
    int block, tiles;
    const int* lst;
    __device__ int start(int it) const { return __ldg(lst + it / TPB) * 128 + it % TPB * TILE; }
  };
  __device__ Cta at(int bh, int x) const {
    const int b = n_blocks - 1 - x;  // last first
    const size_t r = (size_t)bh * n_blocks + b;
    const int cnt = __ldg(counts + r);
    const int* lst = lists + r * max_len;
    // Only the last listed block can be the streamed side's ragged end.
    const int tail = cnt > 0 ? min(TPB, (len - __ldg(lst + cnt - 1) * 128 + TILE - 1) / TILE) : 0;
    return {b, cnt > 0 ? (cnt - 1) * TPB + tail : 0, lst};
  }
};

// ---- dK/dV ----------------------------------------------------------------------

template <int D>
struct DkvTile {
  static constexpr int KEYS = 128;                 // keys a CTA, 64 a consumer warpgroup
  static constexpr int BQ = 64;                    // query rows a ring stage
  static constexpr int THREADS = 384;              // producer + 2 consumer warpgroups
  static constexpr int KV_BYTES = KEYS * D * 2;    // resident K, or V
  static constexpr int QT_BYTES = BQ * D * 2;      // Q, or dO, of a stage
  // A stage's statistics: raw lse, delta, g_lse of BQ + 4 rows from the
  // 16-byte boundary at or below the tile's first row (a 1-D TMA box starts
  // on one), each in a slot of RAW floats; then lse2 and rest [BQ].
  static constexpr int RAW_BOX = BQ + 4, RAW = 96;
  static constexpr int STAT_FLOATS = 3 * RAW + 2 * BQ;
  static constexpr int STAT_BYTES = STAT_FLOATS * 4;
  static constexpr int BAR_BYTES = 128;
  static constexpr int FIT =
      (232448 - 1024 - BAR_BYTES - 2 * KV_BYTES) / (2 * QT_BYTES + STAT_BYTES);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  // + 1024: the dynamic base is aligned up to the swizzle period.
  static constexpr int SMEM =
      1024 + 2 * KV_BYTES + STAGES * (2 * QT_BYTES + STAT_BYTES) + BAR_BYTES;
  static_assert(STAGES >= 2, "two ring stages must fit");
  static_assert(8 * (1 + 3 * STAGES) <= BAR_BYTES, "barrier space");
  static_assert(RAW_BOX <= RAW && RAW * 4 % 128 == 0 && STAT_BYTES % 128 == 0,
                "TMA destinations on 128 bytes");
};

// One CTA: the 128 keys of block walk.at(...).block of head blockIdx.y
// against the query tiles of its walk.  Maps: q, dout [bh, lq, D] (box 64 x
// 64), k, v [bh, lk, D] (box 64 x 128), all 128-byte swizzled; lse, delta,
// glse over [bh lq] (box 68).  Producer warpgroup: thread 0 issues every
// load (a stage's tiles and raw statistics complete its `raw` barrier);
// warp 1 turns each stage's raw statistics into lse2 / rest and its lanes
// arrive on `full`.
template <int D, class Walk>
__global__ void __launch_bounds__(DkvTile<D>::THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tl, const __grid_constant__ CUtensorMap td,
           const __grid_constant__ CUtensorMap tg, bf16* __restrict__ dk_out,
           bf16* __restrict__ dv_out, int lq, int lk, float c, float scale, float bias,
           const Walk walk) {
  using T = DkvTile<D>;
  constexpr int BQ = T::BQ, STAGES = T::STAGES, RAW = T::RAW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t k_s = (base + 1023u) & ~1023u;
  const uint32_t v_s = k_s + T::KV_BYTES;
  const uint32_t q_r = v_s + T::KV_BYTES;             // stage s at q_r + s * QT_BYTES
  const uint32_t do_r = q_r + STAGES * T::QT_BYTES;   // stage s at do_r + s * QT_BYTES
  const uint32_t st_r = do_r + STAGES * T::QT_BYTES;  // stage s at st_r + s * STAT_BYTES
  const uint32_t bar = st_r + STAGES * T::STAT_BYTES;
  float* stats = reinterpret_cast<float*>(smem_raw + (st_r - base));
  // Barriers: K/V, then raw, full and empty of each stage.
  const uint32_t kv_full = bar, raw = bar + 8, full = raw + 8 * STAGES;
  const uint32_t empty = full + 8 * STAGES;

  const int bh = blockIdx.y;
  const auto cta = walk.at(bh, blockIdx.x);
  const int key0 = cta.block * T::KEYS, n_tiles = cta.tiles;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(raw + 8 * s, 1);
      mbar_init(full + 8 * s, 32);  // the lanes of the statistics warp
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    setmaxnreg_dec<24>();  // 128 x 24 + 256 x 240 = 384 x 168, the launch budget
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load_3d(k_s + cb * 128 * 128, &tk, kv_full, cb * 64, key0, bh);
        tma_load_3d(v_s + cb * 128 * 128, &tv, kv_full, cb * 64, key0, bh);
      }
      int stage = 0, phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int row0 = cta.start(it);  // read before the wait: its latency hides there
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t f = raw + 8 * stage, st = st_r + stage * T::STAT_BYTES;
        mbar_expect_tx(f, 2 * T::QT_BYTES + 3 * T::RAW_BOX * 4);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load_3d(q_r + stage * T::QT_BYTES + cb * BQ * 128, &tq, f, cb * 64, row0, bh);
          tma_load_3d(do_r + stage * T::QT_BYTES + cb * BQ * 128, &tdo, f, cb * 64, row0, bh);
        }
        const int e0 = (bh * lq + row0) & ~3;
        tma_load_1d(st, &tl, f, e0);
        tma_load_1d(st + RAW * 4, &td, f, e0);
        tma_load_1d(st + 2 * RAW * 4, &tg, f, e0);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      // Statistics warp: rows lane and lane + 32 of each tile, the tiles the
      // loads walk.  Rows past lq brought the next head's values (or zeros
      // past the last head).
      const int lane = threadIdx.x & 31;
      int stage = 0, phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int row0 = cta.start(it), off = (bh * lq + row0) & 3;
        mbar_wait(raw + 8 * stage, phase);
        float* st = stats + stage * T::STAT_FLOATS;
#pragma unroll
        for (int i = lane; i < BQ; i += 32)
          row_stats(st[off + i], st[RAW + off + i], st[2 * RAW + off + i], row0 + i < lq, bias,
                    st[3 * RAW + i], st[3 * RAW + BQ + i]);
        mbar_arrive(full + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) & 3;
    const int k0 = key0 + cw * 64 + warp * 16 + (threadIdx.x & 31) / 4, k1 = k0 + 8;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    if (n_tiles > 0) {
      mbar_wait(kv_full, 0);
      consume_dkv<D, BQ, STAGES>(dk, dv, k_s + cw * 64 * 128, v_s + cw * 64 * 128, q_r, do_r,
                                 stats + 3 * RAW, T::STAT_FLOATS, raw, full, empty, n_tiles,
                                 c, k0 < lk, k1 < lk);
    }
    store_acc_rows<D>(dk, dk_out + (size_t)bh * lk * D, k0, k1, lk, scale);
    store_acc_rows<D>(dv, dv_out + (size_t)bh * lk * D, k0, k1, lk, 1.f);
  }
}

// ---- dQ ---------------------------------------------------------------------------

template <int D>
struct DqTile {
  static constexpr int ROWS = 128;                  // query rows a CTA, 64 a consumer warpgroup
  static constexpr int BN = D == 128 ? 64 : 128;    // keys a ring stage (registers: dq, S, dP)
  static constexpr int THREADS = 384;
  static constexpr int Q_BYTES = ROWS * D * 2;      // resident Q, or dO
  static constexpr int KV_BYTES = BN * D * 2;       // K, or V, of a stage
  static constexpr int BAR_BYTES = 128;
  static constexpr int FIT = (232448 - 1024 - BAR_BYTES - 2 * Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * 2 * KV_BYTES + BAR_BYTES;
  static_assert(STAGES >= 2, "two ring stages must fit");
  static_assert(8 * (1 + 2 * STAGES) <= BAR_BYTES, "barrier space");
};

// One CTA: the 128 query rows of block walk.at(...).block of head
// blockIdx.y against the key tiles of its walk.  Maps: q, dout [bh, lq, D]
// (box 64 x 128), k, v [bh, lk, D] (box 64 x BN).
template <int D, class Walk>
__global__ void __launch_bounds__(DqTile<D>::THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ glse, bf16* __restrict__ dq_out, int lq, int lk, float c,
          float scale, float bias, const Walk walk) {
  using T = DqTile<D>;
  constexpr int BN = T::BN, STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + T::Q_BYTES;
  const uint32_t k_r = do_s + T::Q_BYTES;            // stage s at k_r + s * KV_BYTES
  const uint32_t v_r = k_r + STAGES * T::KV_BYTES;   // stage s at v_r + s * KV_BYTES
  const uint32_t bar = v_r + STAGES * T::KV_BYTES;
  // Barriers: Q/dO, then full and empty of each stage.
  const uint32_t q_full = bar, full = bar + 8, empty = full + 8 * STAGES;

  const int bh = blockIdx.y;
  const auto cta = walk.at(bh, blockIdx.x);
  const int q0 = cta.block * T::ROWS, n_tiles = cta.tiles;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    setmaxnreg_dec<40>();  // 128 x 40 + 256 x 232 = 384 x 168
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, 2 * T::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load_3d(q_s + cb * 128 * 128, &tq, q_full, cb * 64, q0, bh);
        tma_load_3d(do_s + cb * 128 * 128, &tdo, q_full, cb * 64, q0, bh);
      }
      int stage = 0, phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int kt = cta.start(it);  // read before the wait: its latency hides there
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t f = full + 8 * stage;
        mbar_expect_tx(f, 2 * T::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load_3d(k_r + stage * T::KV_BYTES + cb * BN * 128, &tk, f, cb * 64, kt, bh);
          tma_load_3d(v_r + stage * T::KV_BYTES + cb * BN * 128, &tv, f, cb * 64, kt, bh);
        }
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
    const size_t h0 = (size_t)bh * lq;
    float l0, l1, rr0, rr1;
    row_stats(r0 < lq ? lse[h0 + r0] : 0.f, r0 < lq ? delta[h0 + r0] : 0.f,
              r0 < lq ? glse[h0 + r0] : 0.f, r0 < lq, bias, l0, rr0);
    row_stats(r1 < lq ? lse[h0 + r1] : 0.f, r1 < lq ? delta[h0 + r1] : 0.f,
              r1 < lq ? glse[h0 + r1] : 0.f, r1 < lq, bias, l1, rr1);
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    if (n_tiles > 0) {
      const int last = lk - cta.start(n_tiles - 1);  // live keys of the last tile
      mbar_wait(q_full, 0);
      consume_dq<D, BN, STAGES>(dq, q_s + cw * 64 * 128, do_s + cw * 64 * 128, k_r, v_r, full,
                                empty, n_tiles, c, l0, l1, rr0, rr1,
                                [n_tiles, last](int it, int) {
                                  return it + 1 < n_tiles ? BN : last;
                                });
    }
    store_acc_rows<D>(dq, dq_out + h0 * D, r0, r1, lq, scale);
  }
}

// The statistics' maps: lse, delta, glse [bh * lq] f32, boxes of `box`.
static bool stat_maps(CUtensorMap* tl, CUtensorMap* td, CUtensorMap* tg, const void* lse,
                      const void* delta, const void* glse, int bh, int lq, int box) {
  const long long n = (long long)bh * lq;
  return make_map_f32(tl, lse, n, box) && make_map_f32(td, delta, n, box) &&
         make_map_f32(tg, glse, n, box);
}

template <int D, class Walk>
static int launch_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* glse, void* dq, int bh,
                     int lq, int lk, float scale, float bias, const Walk& walk,
                     cudaStream_t stream) {
  using T = DqTile<D>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dq_kernel<D, Walk>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  CUtensorMap tq, tdo, tk, tv;
  if (!make_map(&tq, q, bh, lq, D, T::ROWS) || !make_map(&tdo, dout, bh, lq, D, T::ROWS) ||
      !make_map(&tk, k, bh, lk, D, T::BN) || !make_map(&tv, v, bh, lk, D, T::BN))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((lq + T::ROWS - 1) / T::ROWS, bh);
  dq_kernel<D, Walk><<<grid, T::THREADS, T::SMEM, stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(glse), static_cast<bf16*>(dq), lq, lk, scale * LOG2E, scale,
      bias, walk);
  return (int)cudaGetLastError();
}

template <int D, class Walk>
static int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* glse, void* dk, void* dv,
                      int bh, int lq, int lk, float scale, float bias, const Walk& walk,
                      cudaStream_t stream) {
  using T = DkvTile<D>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dkv_kernel<D, Walk>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  CUtensorMap tq, tdo, tk, tv, tl, td, tg;
  if (!make_map(&tq, q, bh, lq, D, T::BQ) || !make_map(&tdo, dout, bh, lq, D, T::BQ) ||
      !make_map(&tk, k, bh, lk, D, T::KEYS) || !make_map(&tv, v, bh, lk, D, T::KEYS) ||
      !stat_maps(&tl, &td, &tg, lse, delta, glse, bh, lq, T::RAW_BOX))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((lk + T::KEYS - 1) / T::KEYS, bh);
  dkv_kernel<D, Walk><<<grid, T::THREADS, T::SMEM, stream>>>(
      tq, tdo, tk, tv, tl, td, tg, static_cast<bf16*>(dk), static_cast<bf16*>(dv), lq, lk,
      scale * LOG2E, scale, bias, walk);
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
    return launch_dq<128>(q, k, v, dout, lse, delta, glse, dq, bh, lq, lk, scale, bias,
                          DenseWalk<DqTile<128>::BN>{lk}, st);
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, glse, dq, bh, lq, lk, scale, bias,
                         DenseWalk<DqTile<64>::BN>{lk}, st);
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
  const DenseWalk<DkvTile<128>::BQ> walk{lq};
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, glse, dk, dv, bh, lq, lk, scale, bias,
                           walk, st);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, glse, dk, dv, bh, lq, lk, scale, bias,
                          walk, st);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, dout and the statistics as bt_attn_dense_dq (K/V read in place);
// lists [bh, n_qt, max_k] ascending key blocks, counts [bh, n_qt] int32 (the
// forward's lists, n_qt = ceil(lq/128)) -> dq [bh, lq, d].
BT_API int bt_attn_sparse_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* glse,
                             const void* lists, const void* counts, void* dq, int bh, int lq,
                             int lk, int d, int n_qt, int max_k, float scale, float bias,
                             void* stream) {
  using namespace bt::bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_dims(bh, lq, lk) || n_qt != (lq + 127) / 128 || max_k <= 0)
    return (int)cudaErrorInvalidValue;
  const int* li = static_cast<const int*>(lists);
  const int* co = static_cast<const int*>(counts);
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, glse, dq, bh, lq, lk, scale, bias,
                          ListWalk<DqTile<128>::BN>{li, co, n_qt, max_k, lk}, st);
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, glse, dq, bh, lq, lk, scale, bias,
                         ListWalk<DqTile<64>::BN>{li, co, n_qt, max_k, lk}, st);
  return (int)cudaErrorInvalidValue;
}

// As bt_attn_sparse_dq with t_lists [bh, n_kt, max_q] ascending query blocks
// per key block, t_counts [bh, n_kt] int32 (lists of the transposed mask,
// n_kt = ceil(lk/128)) -> dk, dv [bh, lk, d].
BT_API int bt_attn_sparse_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* glse,
                              const void* t_lists, const void* t_counts, void* dk, void* dv,
                              int bh, int lq, int lk, int d, int n_kt, int max_q,
                              float scale, float bias, void* stream) {
  using namespace bt::bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_dims(bh, lq, lk) || n_kt != (lk + 127) / 128 || max_q <= 0)
    return (int)cudaErrorInvalidValue;
  const ListWalk<DkvTile<128>::BQ> walk{static_cast<const int*>(t_lists),
                                        static_cast<const int*>(t_counts), n_kt, max_q, lq};
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, glse, dk, dv, bh, lq, lk, scale, bias,
                           walk, st);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, glse, dk, dv, bh, lq, lk, scale, bias,
                          walk, st);
  return (int)cudaErrorInvalidValue;
}
