// K/V record packing for the block-sparse gathers.
//
// Replaces blade/kernels/pack.py::_pack_kernel in both modes.
//
// pyramid=False (bt_pack_kv): output [BH, n_kt, 2, 128, d]; record b of a
// head holds the 128 K rows of key block b followed by its 128 V rows, so
// bt_attn_sparse_fwd reads one contiguous 2*128*d record per listed block.
// Rows past the key length lk (the ragged last block) are written as zeros.
// What bounds it on the H100: device-memory bandwidth only, a pure copy
// (read 2 * lk * d, write 2 * n_kt * 128 * d bf16 a head).  One CTA copies
// one record half, a 128 x d slab that is contiguous on both sides (the
// ragged tail excepted): blockIdx.x over the 2 * n_kt halves, blockIdx.y
// over heads (looping past the grid's 65535).  Each thread issues all its
// 16-byte loads before its first store, so d / 8 independent loads are in
// flight a thread, consecutive threads on consecutive addresses; the index
// arithmetic is shifts of a compile-time row width, no division.  Loads and
// stores are marked evict-first (each byte is touched once).
//
// pyramid=True (bt_pack_kv_pyramid): the level-1 records of the EDGE-padded
// K/V (rows past lk repeat row lk-1, as JAX pools pad_to_block_multiple's
// output) plus the 2/4/8x mean-pooled records [BH, n_kt, 2, 128/L, d] for
// bt_multilevel_fwd.  One thread owns 8 consecutive source rows of one
// 8-channel slice of K or V: it reads them once, writes the 8 level-1 rows,
// and pools pairwise in f32, chained (pool4 = pool2(pool2), pool8 =
// pool2(pool4)), rounding to bf16 once a level -- one pass, read 2*L*d,
// write 3.75*L*d.  Bandwidth-bound as well; each thread moves 16 bytes with
// consecutive threads on consecutive addresses, in a grid-stride loop.
#include "common.cuh"

namespace bt {

constexpr int PACK_THREADS = 128;

// One record half: 128 rows x VPR 16-byte vectors, VPR vectors a thread.
// VPR == 0: any row width `dvec`, one vector at a time (32-bit indices).
template <int VPR>
__global__ void __launch_bounds__(PACK_THREADS)
pack_kv_kernel(const uint4* __restrict__ k, const uint4* __restrict__ v,
               uint4* __restrict__ out, int bh, int lk, int n_kt, int dvec) {
  const int w = VPR > 0 ? VPR : dvec;  // 16-byte vectors a row
  const int half = blockIdx.x, row0 = (half >> 1) * 128;
  const uint4* side = (half & 1) ? v : k;
  // Vectors of this half that hold source rows (< lk); the rest are zeros.
  const int live = max(0, min(128, lk - row0)) * w;
  for (int b = blockIdx.y; b < bh; b += gridDim.y) {
    const uint4* src = side + ((size_t)b * lk + row0) * w;
    uint4* dst = out + ((size_t)b * n_kt * 2 + half) * 128 * w;
    if constexpr (VPR > 0) {
      uint4 val[VPR];
#pragma unroll
      for (int i = 0; i < VPR; ++i) {
        const int e = threadIdx.x + i * PACK_THREADS;
        val[i] = e < live ? __ldcs(src + e) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < VPR; ++i) __stcs(dst + threadIdx.x + i * PACK_THREADS, val[i]);
    } else {
      for (int e = threadIdx.x; e < 128 * w; e += PACK_THREADS)
        __stcs(dst + e, e < live ? __ldcs(src + e) : make_uint4(0u, 0u, 0u, 0u));
    }
  }
}

__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
  return u;
}

// x[r] = (x[2r] + x[2r+1]) / 2 for r < N (f32), then row r of the level's
// record rows at `out` (row stride dvec vectors) gets x[r] rounded to bf16.
template <int N>
__device__ __forceinline__ void pool_store(float (&x)[8][8], uint4* out, int dvec) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[r][e] = (x[2 * r][e] + x[2 * r + 1][e]) * 0.5f;
    out[(long long)r * dvec] = pack8(x[r]);
  }
}

// Work item i -> (bh, block, side K|V, 8-row group g in [0, 16), vector c).
__global__ void pack_kv_pyramid_kernel(const uint4* __restrict__ k, const uint4* __restrict__ v,
                                       uint4* __restrict__ kv1, uint4* __restrict__ kv2,
                                       uint4* __restrict__ kv4, uint4* __restrict__ kv8,
                                       int lk, int n_kt, int dvec, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % dvec);
    long long rest = i / dvec;
    const int g = (int)(rest % 16);
    rest /= 16;
    const int side = (int)(rest % 2);
    rest /= 2;
    const int blk = (int)(rest % n_kt);
    const long long bh = rest / n_kt;
    const uint4* src = (side ? v : k) + bh * lk * dvec + c;
    const long long rec = bh * n_kt + blk;  // record index of this (bh, block)
    float x[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = min(blk * 128 + g * 8 + r, lk - 1);
      const uint4 u = src[(long long)row * dvec];
      kv1[((rec * 2 + side) * 128 + g * 8 + r) * dvec + c] = u;
      unpack8(u, x[r]);
    }
    // Level L keeps 8/L rows of this group: pool pairs in place, chained.
    const long long base = rec * 2 + side;
    pool_store<4>(x, kv2 + (base * 64 + g * 4) * dvec + c, dvec);
    pool_store<2>(x, kv4 + (base * 32 + g * 2) * dvec + c, dvec);
    pool_store<1>(x, kv8 + (base * 16 + g) * dvec + c, dvec);
  }
}

}  // namespace bt

// k, v [bh, lk, d] bf16 -> kv1 [bh, n_kt, 2, 128, d], kv2 [.., 64, d],
// kv4 [.., 32, d], kv8 [.., 16, d] bf16 with n_kt = ceil(lk/128).  d % 8 == 0.
BT_API int bt_pack_kv_pyramid(const void* k, const void* v, void* kv1, void* kv2, void* kv4,
                              void* kv8, int bh, int lk, int d, void* stream) {
  if (d % 8 || bh <= 0 || lk <= 0) return (int)cudaErrorInvalidValue;
  const int n_kt = (lk + 127) / 128;
  const int dvec = d / 8;
  const long long total = (long long)bh * n_kt * 2 * 16 * dvec;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  bt::pack_kv_pyramid_kernel<<<(unsigned)blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k), static_cast<const uint4*>(v), static_cast<uint4*>(kv1),
      static_cast<uint4*>(kv2), static_cast<uint4*>(kv4), static_cast<uint4*>(kv8), lk, n_kt,
      dvec, total);
  return (int)cudaGetLastError();
}

// k, v [bh, lk, d] bf16 -> out [bh, ceil(lk/128) * 256, d] bf16.  d % 8 == 0.
BT_API int bt_pack_kv(const void* k, const void* v, void* out, int bh, int lk, int d,
                      void* stream) {
  if (d % 8 || bh <= 0 || lk <= 0) return (int)cudaErrorInvalidValue;
  const int n_kt = (lk + 127) / 128;
  const int dvec = d / 8;
  const dim3 grid(2 * n_kt, bh < 65535 ? bh : 65535);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* ku = static_cast<const uint4*>(k);
  const uint4* vu = static_cast<const uint4*>(v);
  uint4* o = static_cast<uint4*>(out);
  if (dvec == 16)
    bt::pack_kv_kernel<16><<<grid, bt::PACK_THREADS, 0, st>>>(ku, vu, o, bh, lk, n_kt, dvec);
  else if (dvec == 8)
    bt::pack_kv_kernel<8><<<grid, bt::PACK_THREADS, 0, st>>>(ku, vu, o, bh, lk, n_kt, dvec);
  else
    bt::pack_kv_kernel<0><<<grid, bt::PACK_THREADS, 0, st>>>(ku, vu, o, bh, lk, n_kt, dvec);
  return (int)cudaGetLastError();
}
