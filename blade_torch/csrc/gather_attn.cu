// Block-sparse gather forward for Hopper (sm_90a), bf16 in, f32 accumulate:
// one kernel, gather_fwd_kernel<D, Walk>, for five TPU kernels that compute
// the same function: per 128-row mask row, an online softmax over the key
// segments its lists select.  The Walk says which segments a CTA's row
// takes and where their K and V rows lie.
//
// Replaces, with SEG the rows of a listed segment:
//   * blade/kernels/block_sparse_attn.py::_sparse_fwd_rows_kernel (one
//     list, SEG 128) -> bt_attn_sparse_fwd: block_sparse_attention over
//     ascending per-row lists of 128-key blocks and bt_pack_kv's records
//     [BH, n_kt, 2, 128, d];
//   * block_sparse_attn.py::_sparse_fwd_kernel at seg_rows 128/L (pooled
//     segments DMA-gathered from HBM) and
//     blade/kernels/multilevel_attn.py::_vmem_level_kernel (the pyramid
//     resident in VMEM) (one list, SEG 64/32/16 for L = 2/4/8) ->
//     bt_pooled_level_fwd: one pooled level of the per-level multilevel
//     lane over bt_pack_kv_pyramid's level-L records [BH, n_kt, 2, 128/L,
//     d].  The H100 has no multi-megabyte on-chip store to mirror the
//     TPU's split;
//   * blade/kernels/multilevel_attn.py::_fused_ml_kernel (four lists, SEG
//     128/64/32/16) -> bt_multilevel_fwd: the fused multilevel lane, every
//     level of a mask row in one carry over bt_pack_kv_pyramid's four
//     record tensors;
//   * block_sparse_attn.py::_sparse_fwd_union_kernel (block_sparse_attention
//     with SPARSE_UNION set) -> bt_attn_sparse_union_fwd: the mask rows go
//     in pairs, each pair's list is the ascending union of its two rows'
//     128-key blocks (masks.union_block_lists), each entry the block in its
//     low 16 bits and one validity bit per mask row above them; K and V are
//     read in place from [BH, lk, d].
//
// Function: for each mask row, an online softmax over the segments of its
// listed blocks, segment rows at or past `valid - b SEG` masked (valid: lk
// for level 1, the sparse and the union forward; the pooled length
// ceil(lk / L) for a pooled level).  In the fused multilevel kernel a
// level-L score gets +log L (every level shares the carry) and the LSE no
// bias; in the one-list kernels scores get no bias and the LSE gets
// `lse_bias` (the caller's for the sparse and union forwards, log(L) for a
// pooled level: the score bias of a pooled key, on which out does not
// depend).  P is rounded to bf16 before P @ V; the LSE is natural-log; a
// row with no listed block gives out 0 and lse -1e30.
//
// What bounds it on the H100: tensor-core math over the listed keys, 4 d
// flops a query-key pair against each listed record read once (the Wan
// 480p mask at density 0.21: 1.41 ms of math against ~0.3 GB; Wan2.1-14B
// 720p pooled levels 2/4/8: 5.9/2.9/3.7 ms; the fused multilevel lane at
// CogVideoX-5B 480p, d = 64: 0.70 ms of math against ~0.1 GB of records).
// The design is the dense forward's (flash_wgmma.cuh) with gathered tiles:
//   * a CTA is 128 query rows, 384 threads, one producer warp and two
//     consumer warpgroups of 64 rows that both read every ring stage, so a
//     CTA reads its row's segments from HBM once.  A multilevel mask row of
//     256 queries is two CTAs over the same lists, and a union pair is two
//     CTAs over the same union list, adjacent in launch order: the second
//     reads the blocks both selected mostly from L2;
//   * a ring stage is 128 keys of one list: 128 / SEG listed segments,
//     each landing in the next SEG-row slice of the stage through one TMA
//     box of SEG rows x 64 columns a column block of K and of V, through a
//     3-D map over that list's records viewed as [BH, n_kt 2 SEG, d] or,
//     for the union, over K and V themselves (maps passed in parameter
//     space).  SEG * 128 bytes is a multiple of the 1024-byte swizzle
//     period, so every slice is laid out as if the whole stage had come in
//     one box and the dense kernel's wgmma descriptors apply unchanged;
//   * the producer warp walks the lists in order, level by level; its
//     lanes read a tile's list entries (one lane a slot) and issue the
//     boxes in parallel.  A list's last tile fills its empty slots with the
//     tile's first segment (wgmma multiplies every row of the stage, and a
//     stage's first use would otherwise hold uninitialised shared memory),
//     and each stage carries in shared memory beside the ring the live rows
//     of its slots, its SEG and its score bias, so the consumers mask dead
//     columns to -inf before the row max (at a SEG known only at run time
//     in the multilevel kernel) and add log2 L to a pooled tile's base-2
//     scores inside the online softmax.  A union CTA takes the entries
//     whose bit for its row is set, found 32 at a time by a ballot: that is
//     its row's own ascending list, so no tensor-core work goes to a block
//     the row did not select.  Producer and consumers derive the tile count
//     from the same counts (sum over lists of ceil(cnt / (128 / SEG)); for
//     the union, the popcount of the row's bit over the entries, which every
//     warp takes for itself): an empty row runs no tile and waits on no
//     barrier.
// Not carried over from the TPU kernels: the SPARSE_ROWS / GROUP / NBUF DMA
// machinery, the FUSED_ROWS grouping and band-sized pooled tiles, the
// 8-sublane list replication, the list padding to a multiple of the
// segments a tile, the d = 64 lane packing, and the union kernel's one
// 256-row tile a pair (on this card the pair's second read of a shared
// block comes from L2).
#include <cmath>

#include "flash_wgmma.cuh"

namespace bt {

template <int D>
struct GatherTile {
  static constexpr int BM = 128;        // query rows a CTA
  static constexpr int BN = 128;        // keys a ring stage
  static constexpr int THREADS = 384;   // producer + 2 consumer warpgroups
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // K, or V, of one stage
  static constexpr int BAR_BYTES = 128;
  // A stage's metadata: live rows of each slot [0, 8), log2 SEG [13], the
  // base-2 score bias as f32 bits [14], every slot whole [15].
  static constexpr int META_INTS = 16;
  static constexpr int META_BYTES = 4 * META_INTS * 4;
  static constexpr int FIT =
      (232448 - 1024 - BAR_BYTES - META_BYTES - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  // + 1024: the dynamic base is aligned up to the swizzle period.
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES + META_BYTES;
  static_assert(STAGES >= 2, "two ring stages must fit");
  static_assert(8 * (1 + 3 * STAGES) <= BAR_BYTES, "barrier space");
};

// The kernel's arguments, passed __grid_constant__: TMA reads its tensor
// maps in parameter space.
struct GatherArgs {
  CUtensorMap tq;     // q [bh, lq, D], box 64 x 128
  CUtensorMap tr[4];  // list l's records [bh, n_kt 2 SEG_l, D], box 64 x SEG_l;
                      // the union walk: k and v [bh, lk, D], box 64 x 128
  const int* lists;   // [bh, n_q, NL, cap] ascending block indices; the union
                      // walk: [bh, n_q, cap] entries block | valbits << 16
  const int* counts;  // [bh, n_q, NL]
  bf16* out;          // [bh, lq, D]
  float* lse;         // [bh, lq]
  int valid[4];       // list l's segment rows at or past valid[l] - b SEG_l are dead
  int lq, n_qt, n_q;
  int tiles_per_row;  // 128-row query tiles a mask row
  int cap;
  float c;            // scale * log2(e)
  float lse_bias;
};

__host__ __device__ constexpr int ilog2(int x) { return x > 1 ? 1 + ilog2(x / 2) : 0; }

// The ring as the producer warp fills it: stage s's K at k_s + s KV_BYTES,
// V at v_s + s KV_BYTES, barriers k_full / v_full / empty + 8 s, metadata
// at meta + s META_INTS; (stage, phase) of the next stage to fill.
struct Ring {
  uint32_t k_s, v_s, k_full, v_full, empty;
  int* meta;
  int bh, stage, phase;
};

// Where a listed segment's rows lie: K at row stride * blk of map k, V at
// row stride * blk + v_off of map v.
struct SegSource {
  const CUtensorMap* k;
  const CUtensorMap* v;
  int stride, v_off;
};

// The producer warp fills the next ring stage with 128 / SEG segments:
// lane u < 128 / SEG owns slot u, segment `blk` with `live` live rows (the
// other lanes' arguments are ignored).
template <int D, int SEG>
__device__ __forceinline__ void fill_stage(const SegSource& src, int blk, int live,
                                           float score_bias, Ring& r) {
  using T = GatherTile<D>;
  constexpr int BN = T::BN, SPT = BN / SEG, KV = T::KV_BYTES;
  static_assert(SPT <= 8 && (SEG * 128) % 1024 == 0, "a slot starts on the swizzle period");
  const int lane = threadIdx.x;
  // A ballot: __all_sync of the converse came back inverted inside the
  // union walk's loop on the card (sm_90a).
  const bool whole = __ballot_sync(0xffffffffu, lane < SPT && live != SEG) == 0u;
  mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1);
  int* m = r.meta + T::META_INTS * r.stage;
#pragma unroll
  for (int u = 0; u < SPT; ++u) {
    const int lu = __shfl_sync(0xffffffffu, live, u);
    if (lane == 0) m[u] = lu;
  }
  const uint32_t kf = r.k_full + 8 * r.stage, vf = r.v_full + 8 * r.stage;
  if (lane == 0) {
    m[13] = ilog2(SEG);
    m[14] = __float_as_int(score_bias);
    m[15] = whole;
    mbar_expect_tx(kf, KV);  // releases the metadata to the consumers
    mbar_expect_tx(vf, KV);
  }
  __syncwarp();
  if (lane < SPT) {
    const uint32_t slot = r.stage * KV + lane * SEG * 128;
    const int row = src.stride * blk;
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load_3d(r.k_s + slot + cb * BN * 128, src.k, kf, cb * 64, row, r.bh);
      tma_load_3d(r.v_s + slot + cb * BN * 128, src.v, vf, cb * 64, row + src.v_off, r.bh);
    }
  }
  if (++r.stage == T::STAGES) {
    r.stage = 0;
    r.phase ^= 1;
  }
}

// The producer warp's walk over one list of SEG-row segments from the
// records of map `map`: tile j0 / SPT fills the next ring stage with listed
// segments j0 .. j0 + SPT - 1.
template <int D, int SEG>
__device__ __forceinline__ void produce_list(const CUtensorMap* map, const int* lst, int cnt,
                                             int valid, float score_bias, Ring& r) {
  constexpr int SPT = GatherTile<D>::BN / SEG;
  const SegSource src{map, map, 2 * SEG, SEG};
  const int lane = threadIdx.x;
  for (int j0 = 0; j0 < cnt; j0 += SPT) {
    // Lane u < SPT owns slot u: listed segment j0 + u, or, past the count,
    // the tile's first one again with no live row.
    int blk = 0, live = 0;
    if (lane < SPT) {
      const bool listed = j0 + lane < cnt;
      blk = lst[listed ? j0 + lane : j0];
      live = listed ? max(0, min(SEG, valid - blk * SEG)) : 0;
    }
    fill_stage<D, SEG>(src, blk, live, score_bias, r);
  }
}

// ---- walks: what a CTA's mask row takes ---------------------------------------
//
// Each gives the CTA's first query row (q0), its ring tile count (tiles(),
// the same in every warp) and the producer warp's walk (produce()); kSeg is
// the consumers' SEG (0: the stage's), kBias whether a stage carries a
// score bias.

// NL ascending lists of one mask row, list l of SEG0 >> l rows a segment
// from bt_pack_kv(_pyramid)'s records.  Rows run last first: both ASA
// lanes force the last two mask rows of every head to every block (5 to 18
// times a typical energy-lane row), and a long row launched in the last
// wave sets the kernel's tail.
template <int D, int SEG0, int NL>
struct ListsWalk {
  static constexpr int kSeg = NL == 1 ? SEG0 : 0;
  static constexpr bool kBias = NL > 1;
  int q0, cnt[NL];
  const int* lst;
  __device__ explicit ListsWalk(const GatherArgs& a) {
    const int tile = a.n_qt - 1 - blockIdx.x;
    q0 = tile * 128;
    const size_t row = (size_t)blockIdx.y * a.n_q + tile / a.tiles_per_row;
#pragma unroll
    for (int l = 0; l < NL; ++l) cnt[l] = a.counts[row * NL + l];
    lst = a.lists + row * NL * a.cap;
  }
  // Ring tiles: list l takes ceil(cnt[l] / (128 / SEG_l)).
  __device__ int tiles() const {
    int n = 0;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int spt = GatherTile<D>::BN / (SEG0 >> l);
      n += (cnt[l] + spt - 1) / spt;
    }
    return n;
  }
  __device__ void produce(const GatherArgs& a, Ring& r) const {
    // List l is level 2^l of the multilevel lane: base-2 score bias l.
    produce_list<D, SEG0>(&a.tr[0], lst, cnt[0], a.valid[0], 0.f, r);
    if constexpr (NL > 1) {
      static_assert(NL == 4 && SEG0 == 128, "the multilevel walk: levels 1, 2, 4, 8");
      produce_list<D, 64>(&a.tr[1], lst + a.cap, cnt[1], a.valid[1], 1.f, r);
      produce_list<D, 32>(&a.tr[2], lst + 2 * a.cap, cnt[2], a.valid[2], 2.f, r);
      produce_list<D, 16>(&a.tr[3], lst + 3 * a.cap, cnt[3], a.valid[3], 3.f, r);
    }
  }
};

// Mask row 2 i + b of pair i walks the entries of the pair's union list
// whose bit b is set, one 128-key block a stage, K and V read in place
// (tr[0], tr[1]).  CTA x is row x & 1 of pair n_q - 1 - x / 2: pairs run
// last first (the forced long rows are the last two), and a pair's two
// CTAs run side by side, so the second reads the blocks both rows
// selected mostly from L2.
template <int D>
struct UnionWalk {
  static constexpr int kSeg = 128;
  static constexpr bool kBias = false;
  int q0, cnt, bit;
  const int* lst;
  __device__ explicit UnionWalk(const GatherArgs& a) {
    const int pair = a.n_q - 1 - (int)(blockIdx.x >> 1), b = blockIdx.x & 1;
    q0 = (2 * pair + b) * 128;
    bit = 16 + b;
    const size_t row = (size_t)blockIdx.y * a.n_q + pair;
    cnt = a.counts[row];
    lst = a.lists + row * a.cap;
  }
  // Entry j0 + lane of the list (0 past the count: no bit set).
  __device__ int entry(int j0) const {
    const int j = j0 + (threadIdx.x & 31);
    return j < cnt ? __ldg(lst + j) : 0;
  }
  __device__ int tiles() const {
    int n = 0;
#pragma unroll 4
    for (int j0 = 0; j0 < cnt; j0 += 32)
      n += __popc(__ballot_sync(0xffffffffu, (entry(j0) >> bit) & 1));
    return n;
  }
  __device__ void produce(const GatherArgs& a, Ring& r) const {
    const SegSource src{&a.tr[0], &a.tr[1], 128, 0};
    for (int j0 = 0; j0 < cnt; j0 += 32) {
      const int e = entry(j0);
      for (unsigned sel = __ballot_sync(0xffffffffu, (e >> bit) & 1); sel; sel &= sel - 1) {
        const int blk = __shfl_sync(0xffffffffu, e & 0xFFFF, __ffs(sel) - 1);
        fill_stage<D, 128>(src, blk, max(0, min(128, a.valid[0] - blk * 128)), 0.f, r);
      }
    }
  }
};

// A stage's base-2 score bias, from its metadata (the multilevel kernel).
template <int D>
struct StageBias {
  const int* meta;
  static constexpr bool kOn = true;
  __device__ __forceinline__ float operator()(int stage) const {
    return __int_as_float(meta[GatherTile<D>::META_INTS * stage + 14]);
  }
};

// One CTA: the 128 query rows from Walk(a).q0 of head blockIdx.y.
template <int D, class Walk>
__global__ void __launch_bounds__(GatherTile<D>::THREADS, 1)
gather_fwd_kernel(const __grid_constant__ GatherArgs a) {
  using T = GatherTile<D>;
  constexpr int BN = T::BN, STAGES = T::STAGES, KV = T::KV_BYTES;
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

  const Walk walk(a);
  const int bh = blockIdx.y, q0 = walk.q0;
  const int n_tiles = walk.tiles();
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
    // ---- producer warpgroup: warp 0 reads the lists and issues every load ----
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32 && n_tiles > 0) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_3d(q_s + cb * 128 * 128, &a.tq, q_full, cb * 64, q0, bh);
      }
      Ring ring{k_s, v_s, k_full, v_full, empty, meta, bh, 0, 0};
      walk.produce(a, ring);
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
      // columns of n8 block j are 8 j + 2 t and 8 j + 2 t + 1.  SEG is the
      // walk's, or the stage's.
      auto mask = [meta, t](int, int stage, float(&s)[BN / 2]) {
        const int* m = meta + T::META_INTS * stage;
        if (!m[15]) {
          const int sh = Walk::kSeg ? ilog2(Walk::kSeg) : m[13];
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int live = m[(j * 8) >> sh], r = ((j * 8) & ((1 << sh) - 1)) + 2 * t;
            if (r >= live) s[4 * j] = s[4 * j + 2] = -INFINITY;
            if (r + 1 >= live) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
          }
        }
        return BN;
      };
      if constexpr (Walk::kBias)
        consume_tiles<D, BN, D, STAGES>(o, m0, m1, l0, l1, q_wg, k_s, v_s, k_full, v_full,
                                        empty, n_tiles, a.c, mask, StageBias<D>{meta});
      else
        consume_tiles<D, BN, D, STAGES>(o, m0, m1, l0, l1, q_wg, k_s, v_s, k_full, v_full,
                                        empty, n_tiles, a.c, mask);
    }
    store_rows_wg<D>(o, m0, m1, l0, l1, a.out + (size_t)bh * a.lq * D,
                     a.lse + (size_t)bh * a.lq, r0, r1, a.lq, D, 0, true, a.lse_bias);
  }
}

// grid_x CTAs a head; the maps in `a` already encoded.
template <int D, class Walk>
static int launch_gather(const GatherArgs& a, int grid_x, int bh, cudaStream_t stream) {
  using T = GatherTile<D>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_fwd_kernel<D, Walk>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  gather_fwd_kernel<D, Walk><<<dim3(grid_x, bh), T::THREADS, T::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// `rec[l]`: list l's records, n_kt blocks of 2 (SEG0 >> l) rows a head; a
// CTA a 128-row query tile.
template <int D, int SEG0, int NL>
static int launch_lists(GatherArgs& a, const void* q, const void* const* rec, int bh, int n_kt,
                        cudaStream_t stream) {
  if (!make_map(&a.tq, q, bh, a.lq, D, GatherTile<D>::BM)) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < NL; ++l) {
    const int seg = SEG0 >> l;
    if (!make_map(&a.tr[l], rec[l], bh, n_kt * 2 * seg, D, seg))
      return (int)cudaErrorInvalidValue;
  }
  return launch_gather<D, ListsWalk<D, SEG0, NL>>(a, a.n_qt, bh, stream);
}

// One list at `seg` rows a segment.
template <int D>
static int dispatch_seg(int seg, GatherArgs& a, const void* q, const void* rec, int bh,
                        int n_kt, cudaStream_t st) {
  switch (seg) {
    case 128: return launch_lists<D, 128, 1>(a, q, &rec, bh, n_kt, st);
    case 64: return launch_lists<D, 64, 1>(a, q, &rec, bh, n_kt, st);
    case 32: return launch_lists<D, 32, 1>(a, q, &rec, bh, n_kt, st);
    case 16: return launch_lists<D, 16, 1>(a, q, &rec, bh, n_kt, st);
  }
  return (int)cudaErrorInvalidValue;
}

// One list of `seg`-row segments: lists [bh, n_qt, max_k], a mask row a
// query tile.
static int one_list(int d, int seg, const void* q, const void* rec, const void* lists,
                    const void* counts, void* out, void* lse, int bh, int lq, int n_kt,
                    int n_qt, int max_k, int valid_len, float scale, float bias, void* stream) {
  GatherArgs a{};
  a.lists = static_cast<const int*>(lists);
  a.counts = static_cast<const int*>(counts);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.valid[0] = valid_len;
  a.lq = lq;
  a.n_qt = a.n_q = n_qt;
  a.tiles_per_row = 1;
  a.cap = max_k;
  a.c = scale * LOG2E;
  a.lse_bias = bias;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return dispatch_seg<128>(seg, a, q, rec, bh, n_kt, st);
  if (d == 64) return dispatch_seg<64>(seg, a, q, rec, bh, n_kt, st);
  return (int)cudaErrorInvalidValue;
}

// The union walk: maps over q, k and v themselves, two CTAs a pair.
template <int D>
static int launch_union(GatherArgs& a, const void* q, const void* k, const void* v, int bh,
                        int lk, cudaStream_t stream) {
  if (!make_map(&a.tq, q, bh, a.lq, D, GatherTile<D>::BM) ||
      !make_map(&a.tr[0], k, bh, lk, D, GatherTile<D>::BN) ||
      !make_map(&a.tr[1], v, bh, lk, D, GatherTile<D>::BN))
    return (int)cudaErrorInvalidValue;
  return launch_gather<D, UnionWalk<D>>(a, 2 * a.n_q, bh, stream);
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
  return bt::one_list(d, 128, q, kv_packed, lists, counts, out, lse, bh, lq, (lk + 127) / 128,
                      n_qt, max_k, lk, scale, bias, stream);
}

// q [bh, lq, d], k, v [bh, lk, d] bf16; lists [bh, n_pairs, max_u] int32
// entries (block | valbits << 16), ascending union of mask rows 2i and 2i+1,
// counts [bh, n_pairs], n_pairs = ceil(ceil(lq / 128) / 2) -> out [bh, lq, d]
// bf16, lse [bh, lq] f32.  d in {64, 128}; ceil(lk / 128) <= 65536; every
// pointer 16-byte aligned.
BT_API int bt_attn_sparse_union_fwd(const void* q, const void* k, const void* v,
                                    const void* lists, const void* counts, void* out,
                                    void* lse, int bh, int lq, int lk, int d, int n_pairs,
                                    int max_u, float scale, float bias, void* stream) {
  const int n_qt = (lq + 127) / 128;
  if (lq <= 0 || lk <= 0 || bh <= 0 || bh > 65535 || n_pairs != (n_qt + 1) / 2 ||
      max_u <= 0 || (lk + 127) / 128 > 65536)
    return (int)cudaErrorInvalidValue;
  bt::GatherArgs a{};
  a.lists = static_cast<const int*>(lists);
  a.counts = static_cast<const int*>(counts);
  a.out = static_cast<bt::bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.valid[0] = lk;
  a.lq = lq;
  a.n_q = n_pairs;
  a.tiles_per_row = 1;
  a.cap = max_u;
  a.c = scale * bt::LOG2E;
  a.lse_bias = bias;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return bt::launch_union<128>(a, q, k, v, bh, lk, st);
  if (d == 64) return bt::launch_union<64>(a, q, k, v, bh, lk, st);
  return (int)cudaErrorInvalidValue;
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
  return bt::one_list(d, 128 / level, q, rec, lists, counts, out, lse, bh, lq, n_kt, n_qt,
                      max_k, pooled_len, scale, std::log((float)level), stream);
}

// The fused multilevel forward.  q [bh, lq, d] bf16; kv1/kv2/kv4/kv8 from
// bt_pack_kv_pyramid ([bh, n_kt, 2, 128/L, d], n_kt = ceil(lk/128)); idx
// [bh, n_q, 4, cap], counts [bh, n_q, 4] int32, ascending lists of levels
// 1, 2, 4, 8, mask row i covering queries [i q_rows, (i + 1) q_rows) ->
// out [bh, lq, d] bf16, lse [bh, lq] f32 (natural log).  d in {64, 128};
// q_rows a multiple of 128 with n_q * q_rows >= lq; every listed index <
// n_kt, counts <= cap; every pointer 16-byte aligned.
BT_API int bt_multilevel_fwd(const void* q, const void* kv1, const void* kv2, const void* kv4,
                             const void* kv8, const void* idx, const void* counts, void* out,
                             void* lse, int bh, int lq, int lk, int d, int n_q, int cap,
                             int q_rows, float scale, void* stream) {
  if (lq <= 0 || lk <= 0 || bh <= 0 || bh > 65535 || cap <= 0 || q_rows <= 0 ||
      q_rows % 128 || (long long)n_q * q_rows < lq)
    return (int)cudaErrorInvalidValue;
  bt::GatherArgs a{};
  a.lists = static_cast<const int*>(idx);
  a.counts = static_cast<const int*>(counts);
  a.out = static_cast<bt::bf16*>(out);
  a.lse = static_cast<float*>(lse);
  for (int l = 0; l < 4; ++l) a.valid[l] = (lk + (1 << l) - 1) >> l;  // ceil(lk / L)
  a.lq = lq;
  a.n_qt = (lq + 127) / 128;
  a.n_q = n_q;
  a.tiles_per_row = q_rows / 128;
  a.cap = cap;
  a.c = scale * bt::LOG2E;
  a.lse_bias = 0.f;
  const void* rec[4] = {kv1, kv2, kv4, kv8};
  const int n_kt = (lk + 127) / 128;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return bt::launch_lists<128, 128, 4>(a, q, rec, bh, n_kt, st);
  if (d == 64) return bt::launch_lists<64, 128, 4>(a, q, rec, bh, n_kt, st);
  return (int)cudaErrorInvalidValue;
}
