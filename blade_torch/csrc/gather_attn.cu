// Block-sparse gather forward for Hopper (sm_90a), bf16 in, f32 accumulate:
// one kernel, gather_fwd_kernel<D, SEG>, for three TPU kernels that compute
// the same function over the same record layout.
//
// Replaces, with SEG the rows of a listed segment:
//   * blade/kernels/block_sparse_attn.py::_sparse_fwd_rows_kernel (SEG 128)
//     -> bt_attn_sparse_fwd: block_sparse_attention over ascending per-row
//     lists of 128-key blocks and bt_pack_kv's records [BH, n_kt, 2, 128, d];
//   * block_sparse_attn.py::_sparse_fwd_kernel at seg_rows 128/L (pooled
//     segments DMA-gathered from HBM) and
//     blade/kernels/multilevel_attn.py::_vmem_level_kernel (the pyramid
//     resident in VMEM) (SEG 64/32/16 for L = 2/4/8) -> bt_pooled_level_fwd:
//     one pooled level of the per-level multilevel lane over
//     bt_pack_kv_pyramid's level-L records [BH, n_kt, 2, 128/L, d].  The
//     H100 has no multi-megabyte on-chip store to mirror the TPU's split.
//
// Function: for each 128-row mask row, an online softmax over the SEG-row
// segments of its listed blocks (block b's K rows at record row 2 SEG b,
// its V rows SEG further), segment rows at or past `valid_len - b SEG`
// masked (valid_len: lk for the sparse forward; the pooled length
// ceil(lk / L) for a pooled level).  Scores get no bias; the LSE gets
// `bias` (the caller's for the sparse forward, log(L) for a pooled level:
// the score bias of a pooled key, on which out does not depend).  P is
// rounded to bf16 before P @ V; the LSE is natural-log; a row with no
// listed block gives out 0 and lse -1e30.
//
// What bounds it on the H100: tensor-core math over the listed keys, 4 d
// flops a query-key pair against each listed record read once (the Wan
// 480p mask at density 0.21: 1.41 ms of math against ~0.3 GB; Wan2.1-14B
// 720p pooled levels 2/4/8: 5.9/2.9/3.7 ms).  The design is the dense
// forward's (flash_wgmma.cuh) with gathered tiles:
//   * a CTA is one mask row: 128 query rows, 384 threads, one producer warp
//     and two consumer warpgroups of 64 rows that both read every ring
//     stage, so a row's records are read from HBM once;
//   * a ring stage is 128 keys: 128 / SEG listed segments, each landing in
//     the next SEG-row slice of the stage through one TMA box of SEG rows x
//     64 columns a column block of K and of V, from a 3-D map over the
//     records viewed as [BH, n_kt 2 SEG, d].  SEG * 128 bytes is a multiple
//     of the 1024-byte swizzle period, so every slice is laid out as if the
//     whole stage had come in one box and the dense kernel's wgmma
//     descriptors apply unchanged;
//   * the producer warp's lanes read the row's list (one lane a slot) and
//     issue the boxes in parallel; the last tile's empty slots are filled
//     with the tile's first segment (wgmma multiplies every row of the
//     stage, and a stage's first use would otherwise hold uninitialised
//     shared memory), and each stage carries the live rows of its slots in
//     shared memory beside the ring, so the consumers mask dead columns
//     to -inf before the row max.  Producer and consumers derive the tile
//     count ceil(cnt / (128 / SEG)) from the same count: an empty row runs
//     no tile and waits on no barrier.
// Not carried over from the TPU kernels: the SPARSE_ROWS / GROUP / NBUF DMA
// machinery, the 8-sublane list replication, the list padding to a multiple
// of the segments a tile, and the d = 64 lane packing.
#include <cmath>

#include "flash_wgmma.cuh"

namespace bt {

template <int D, int SEG>
struct GatherTile {
  static constexpr int BM = 128;        // query rows a CTA: one mask row
  static constexpr int BN = 128;        // keys a ring stage
  static constexpr int SPT = BN / SEG;  // listed segments a stage
  static constexpr int THREADS = 384;   // producer + 2 consumer warpgroups
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // K, or V, of one stage
  static constexpr int BAR_BYTES = 128;
  // A stage's metadata: live rows of each slot, and [15] = every slot whole.
  static constexpr int META_INTS = 16;
  static constexpr int META_BYTES = 4 * META_INTS * 4;
  static constexpr int FIT =
      (232448 - 1024 - BAR_BYTES - META_BYTES - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  // + 1024: the dynamic base is aligned up to the swizzle period.
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES + META_BYTES;
  static_assert(STAGES >= 2, "two ring stages must fit");
  static_assert(8 * (1 + 3 * STAGES) <= BAR_BYTES, "barrier space");
  static_assert(SPT <= 15 && (SEG * 128) % 1024 == 0, "a slot starts on the swizzle period");
};

// One CTA: mask row n_qt - 1 - blockIdx.x (128 query rows) of head
// blockIdx.y.  Maps: q [bh, lq, D] (box 64 x 128), rec [bh, n_kt 2 SEG, D]
// (box 64 x SEG), both 128-byte swizzled.
template <int D, int SEG>
__global__ void __launch_bounds__(GatherTile<D, SEG>::THREADS, 1)
gather_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tr,
                  const int* __restrict__ lists, const int* __restrict__ counts,
                  bf16* __restrict__ out, float* __restrict__ lse, int lq, int n_qt, int max_k,
                  int valid_len, float c, float bias) {
  using T = GatherTile<D, SEG>;
  constexpr int BN = T::BN, STAGES = T::STAGES, SPT = T::SPT, KV = T::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t q_s = (base + 1023u) & ~1023u;
  const uint32_t k_s = q_s + T::Q_BYTES;  // stage s at k_s + s * KV
  const uint32_t v_s = k_s + STAGES * KV;  // stage s at v_s + s * KV
  const uint32_t bar = v_s + STAGES * KV;
  // Barriers: Q, then K full, V full and empty of each stage.
  const uint32_t q_full = bar;
  const uint32_t k_full = bar + 8, v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;
  int* meta = reinterpret_cast<int*>(smem_raw + (bar + T::BAR_BYTES - base));

  // Rows run last first: the energy lane forces the last two mask rows of
  // every head to every block (5 to 18 times a typical row), and a long row
  // launched in the last wave sets the kernel's tail.
  const int bh = blockIdx.y, row = n_qt - 1 - blockIdx.x, q0 = row * T::BM;
  const int cnt = counts[bh * n_qt + row];
  const int n_tiles = (cnt + SPT - 1) / SPT;
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
    // ---- producer warpgroup: warp 0 reads the list and issues every load ----
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32 && n_tiles > 0) {
      const int lane = threadIdx.x;
      const int* lst = lists + ((size_t)bh * n_qt + row) * max_k;
      if (lane == 0) {
        mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_3d(q_s + cb * 128 * 128, &tq, q_full, cb * 64, q0, bh);
      }
      int stage = 0, phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        // Lane u < SPT owns slot u: listed segment it * SPT + u, or, past
        // the count, the tile's first one again with no live row.
        const int j0 = it * SPT;
        int blk = 0, live = 0;
        if (lane < SPT) {
          const bool listed = j0 + lane < cnt;
          blk = lst[listed ? j0 + lane : j0];
          live = listed ? max(0, min(SEG, valid_len - blk * SEG)) : 0;
        }
        const bool whole = __all_sync(0xffffffffu, lane >= SPT || live == SEG);
        mbar_wait(empty + 8 * stage, phase ^ 1);
        int* m = meta + T::META_INTS * stage;
#pragma unroll
        for (int u = 0; u < SPT; ++u) {
          const int lu = __shfl_sync(0xffffffffu, live, u);
          if (lane == 0) m[u] = lu;
        }
        const uint32_t kf = k_full + 8 * stage, vf = v_full + 8 * stage;
        if (lane == 0) {
          m[15] = whole;
          mbar_expect_tx(kf, KV);  // releases the metadata to the consumers
          mbar_expect_tx(vf, KV);
        }
        __syncwarp();
        if (lane < SPT) {
          const uint32_t slot = stage * KV + lane * SEG * 128;
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb) {
            tma_load_3d(k_s + slot + cb * BN * 128, &tr, kf, cb * 64, 2 * SEG * blk, bh);
            tma_load_3d(v_s + slot + cb * BN * 128, &tr, vf, cb * 64, 2 * SEG * blk + SEG, bh);
          }
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
    const int t = threadIdx.x & 3;
    const int r0 = q0 + cw * 64 + warp * 16 + (threadIdx.x & 31) / 4, r1 = r0 + 8;
    const uint32_t q_wg = q_s + cw * 64 * 128;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    if (n_tiles > 0) {
      mbar_wait(q_full, 0);
      // Columns of slot u are stage rows [u SEG, u SEG + SEG); the thread's
      // columns of n8 block j are 8 j + 2 t and 8 j + 2 t + 1.
      consume_tiles<D, BN, D, STAGES>(
          o, m0, m1, l0, l1, q_wg, k_s, v_s, k_full, v_full, empty, n_tiles, c,
          [meta, t](int, int stage, float(&s)[BN / 2]) {
            const int* m = meta + T::META_INTS * stage;
            if (!m[15]) {
#pragma unroll
              for (int j = 0; j < BN / 8; ++j) {
                const int live = m[j * 8 / SEG], r = j * 8 % SEG + 2 * t;
                if (r >= live) s[4 * j] = s[4 * j + 2] = -INFINITY;
                if (r + 1 >= live) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
              }
            }
            return BN;
          });
    }
    store_rows_wg<D>(o, m0, m1, l0, l1, out + (size_t)bh * lq * D, lse + (size_t)bh * lq, r0,
                     r1, lq, D, 0, true, bias);
  }
}

template <int D, int SEG>
static int launch_gather(const void* q, const void* rec, const void* lists, const void* counts,
                         void* out, void* lse, int bh, int lq, int n_kt, int n_qt, int max_k,
                         int valid_len, float scale, float bias, cudaStream_t stream) {
  using T = GatherTile<D, SEG>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_fwd_kernel<D, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  CUtensorMap tq, tr;
  if (!make_map(&tq, q, bh, lq, D, T::BM) || !make_map(&tr, rec, bh, n_kt * 2 * SEG, D, SEG))
    return (int)cudaErrorInvalidValue;
  gather_fwd_kernel<D, SEG><<<dim3(n_qt, bh), T::THREADS, T::SMEM, stream>>>(
      tq, tr, static_cast<const int*>(lists), static_cast<const int*>(counts),
      static_cast<bf16*>(out), static_cast<float*>(lse), lq, n_qt, max_k, valid_len,
      scale * LOG2E, bias);
  return (int)cudaGetLastError();
}

template <int D>
static int dispatch_seg(int seg, const void* q, const void* rec, const void* lists,
                        const void* counts, void* out, void* lse, int bh, int lq, int n_kt,
                        int n_qt, int max_k, int valid_len, float scale, float bias,
                        cudaStream_t st) {
  switch (seg) {
    case 128: return launch_gather<D, 128>(q, rec, lists, counts, out, lse, bh, lq, n_kt, n_qt, max_k, valid_len, scale, bias, st);
    case 64: return launch_gather<D, 64>(q, rec, lists, counts, out, lse, bh, lq, n_kt, n_qt, max_k, valid_len, scale, bias, st);
    case 32: return launch_gather<D, 32>(q, rec, lists, counts, out, lse, bh, lq, n_kt, n_qt, max_k, valid_len, scale, bias, st);
    case 16: return launch_gather<D, 16>(q, rec, lists, counts, out, lse, bh, lq, n_kt, n_qt, max_k, valid_len, scale, bias, st);
  }
  return (int)cudaErrorInvalidValue;
}

static int dispatch(int d, int seg, const void* q, const void* rec, const void* lists,
                    const void* counts, void* out, void* lse, int bh, int lq, int n_kt,
                    int n_qt, int max_k, int valid_len, float scale, float bias, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return dispatch_seg<128>(seg, q, rec, lists, counts, out, lse, bh, lq, n_kt, n_qt, max_k,
                             valid_len, scale, bias, st);
  if (d == 64)
    return dispatch_seg<64>(seg, q, rec, lists, counts, out, lse, bh, lq, n_kt, n_qt, max_k,
                            valid_len, scale, bias, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace bt

// q [bh, lq, d]; kv_packed [bh, ceil(lk/128), 2, 128, d] (bt_pack_kv);
// lists [bh, n_qt, max_k] ascending key-block indices, counts [bh, n_qt]
// int32 with n_qt = ceil(lq/128) -> out [bh, lq, d] bf16, lse [bh, lq] f32.
// d in {64, 128}; every pointer 16-byte aligned.
BT_API int bt_attn_sparse_fwd(const void* q, const void* kv_packed, const void* lists,
                              const void* counts, void* out, void* lse, int bh, int lq,
                              int lk, int d, int n_qt, int max_k, float scale,
                              float bias, void* stream) {
  if (lq <= 0 || lk <= 0 || bh <= 0 || bh > 65535 || n_qt != (lq + 127) / 128 || max_k <= 0)
    return (int)cudaErrorInvalidValue;
  return bt::dispatch(d, 128, q, kv_packed, lists, counts, out, lse, bh, lq, (lk + 127) / 128,
                      n_qt, max_k, lk, scale, bias, stream);
}

// q [bh, lq, d] bf16; rec [bh, n_kt, 2, 128/level, d] bf16, the level's
// pooled records (bt_pack_kv_pyramid's level-L output); lists
// [bh, n_qt, max_k] ascending block indices < n_kt and counts [bh, n_qt]
// int32 with n_qt = ceil(lq/128) -> out [bh, lq, d] bf16, lse [bh, lq] f32
// (natural log, + log(level)).  d in {64, 128}; level in {2, 4, 8};
// 0 < pooled_len <= n_kt * 128 / level.
BT_API int bt_pooled_level_fwd(const void* q, const void* rec, const void* lists,
                               const void* counts, void* out, void* lse, int bh, int lq,
                               int n_kt, int d, int level, int n_qt, int max_k,
                               int pooled_len, float scale, void* stream) {
  if (lq <= 0 || n_kt <= 0 || bh <= 0 || bh > 65535 || n_qt != (lq + 127) / 128 ||
      max_k <= 0 || (level != 2 && level != 4 && level != 8) || pooled_len <= 0 ||
      pooled_len > n_kt * (128 / level))
    return (int)cudaErrorInvalidValue;
  return bt::dispatch(d, 128 / level, q, rec, lists, counts, out, lse, bh, lq, n_kt, n_qt,
                      max_k, pooled_len, scale, std::log((float)level), stream);
}
