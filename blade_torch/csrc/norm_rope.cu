// Fused q/k lane: RMSNorm over the full width D times `scale`, head split
// [B, S, D] -> [B, H, S, d], and rotate-half RoPE, in one pass.
//
// Replaces blade/kernels/norm_rope.py::_norm_rope_kernel (norm_rope_heads).
//
// What bounds it on the H100: memory bandwidth.  Per row it reads D bf16
// values (+ d f32 cos/sin values, shared by the heads) and writes D bf16
// values, doing ~10 flops per element, far below the ridge point (Wan
// 1.3B, x [1, 32760, 1536]: 218 MB, 0.065 ms at 3.35 TB/s; Wan2.1-14B,
// x [1, 75600, 5120]: 1.59 GB, 0.47 ms).  So the design reads and writes
// each element exactly once, with 16-byte vectors, keeps the row in
// registers, and keeps enough rows in flight to cover the memory latency:
//   * a row belongs to one warp (D <= 2048) or to four (D <= 8192: four at
//     D = 5120), 4 or 2 rows a CTA; lane u of the row's 32 WPR threads owns
//     chunks (of 8 channels) u, u + 32 WPR, ..., CPL of them, each one
//     16-byte load held in registers, so a warp's load is 512 contiguous
//     bytes.  CPL and WPR are compile-time, so the chunk loop unrolls into
//     independent loads; the cos/sin loads are issued with them;
//   * the sum of squares is a __shfl_xor butterfly within the warp, plus
//     one shared-memory step (one __syncthreads) across a row's warps;
//   * with d / 8 a power of two from 2 to 32 (d = 16 .. 256: every model's
//     head width), a head's chunks lie on consecutive lanes and chunk c's
//     rotate-half partner, chunk c +- d/16, is lane ^ d/16 of the same
//     step: one __shfl_xor of the normalised values.  A lane's chunks then
//     also share one offset inside their heads, so it reads its 8 cos and 8
//     sin values once a row as float4 pairs;
//   * each lane writes its 8 outputs as one 16-byte store into the
//     [B, H, S, d] layout.
// Any other d % 8 == 0 takes norm_rope_any_kernel: a warp a row, the row
// read twice (the second time from cache), the partner values and the
// tables element by element.  No model has such a head width.
#include "common.cuh"

namespace bt {

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(e[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 r;
  r.x = pack_bf16(v[0], v[1]);
  r.y = pack_bf16(v[2], v[3]);
  r.z = pack_bf16(v[4], v[5]);
  r.w = pack_bf16(v[6], v[7]);
  return r;
}

// The launch shape of norm_rope_kernel<CPL, WPR>: CTA threads, and CTAs an
// SM to fit (four-warp rows of up to 5 chunks a lane fit three, so that the
// register cap keeps 24 warps in flight without spilling; one-warp rows are
// many small CTAs).
template <int CPL, int WPR>
struct RopeShape {
  static constexpr int THREADS = WPR == 1 ? 128 : 256;
  static constexpr int ROWS = THREADS / (32 * WPR);  // rows a CTA
  static constexpr int MIN_CTAS = WPR == 1 ? 1 : (CPL <= 5 ? 3 : 2);
};

// Row ROWS * blockIdx.x + (its slot in the CTA), d / 8 a power of two from
// 2 to 32, D / 8 <= 32 WPR CPL.
template <int CPL, int WPR>
__global__ void __launch_bounds__(RopeShape<CPL, WPR>::THREADS, RopeShape<CPL, WPR>::MIN_CTAS)
norm_rope_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ cosb, const float* __restrict__ sinb,
                 bf16* __restrict__ out, int rows, int S, int D, int H, int d, float eps) {
  constexpr int TPR = 32 * WPR;  // threads a row
  __shared__ float part[RopeShape<CPL, WPR>::THREADS / 32];
  const int tid = threadIdx.x % TPR, warp = threadIdx.x / 32;
  const int row = blockIdx.x * RopeShape<CPL, WPR>::ROWS + threadIdx.x / TPR;
  const bool live = row < rows;  // the same for every thread of a warp
  const int nch = D / 8, half = d / 2, cph = d / 8;  // chunks: a row, a head
  // Every chunk of this lane is chunk j of its head: one table offset.
  const int j = tid % cph, jj = (8 * j) % half;
  const int s = live ? row % S : 0, b = live ? row / S : 0;
  const float* cr = cosb + (size_t)s * half + jj;
  const float* sr = sinb + (size_t)s * half + jj;
  float4 c0, c1, s0, s1;
  uint4 raw[CPL];
  if (live) {
    c0 = *reinterpret_cast<const float4*>(cr);
    c1 = *reinterpret_cast<const float4*>(cr + 4);
    s0 = *reinterpret_cast<const float4*>(sr);
    s1 = *reinterpret_cast<const float4*>(sr + 4);
  }
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = tid + k * TPR;
    raw[k] = make_uint4(0u, 0u, 0u, 0u);
    if (live && c < nch) raw[k] = *reinterpret_cast<const uint4*>(x + (size_t)row * D + 8 * c);
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    float v[8];
    unpack8(raw[k], v);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss = fmaf(v[i], v[i], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if constexpr (WPR > 1) {
    if ((threadIdx.x & 31) == 0) part[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) ss += part[warp / WPR * WPR + w];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / (float)D + eps);

  // Rotate-half: the first half's partner is + d/2 with sign -.
  const float sg = 8 * j < half ? -1.f : 1.f;
  const float cs[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float sn[8] = {sg * s0.x, sg * s0.y, sg * s0.z, sg * s0.w,
                       sg * s1.x, sg * s1.y, sg * s1.z, sg * s1.w};
  bf16* orow = out + ((size_t)b * H * S + s) * d + 8 * j;  // head h at + h S d
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = tid + k * TPR;
    const bool mine = c < nch;  // a chunk and its partner: both or neither
    float y[8];
    unpack8(raw[k], y);
    if (mine) {
      const float4 g0 = *reinterpret_cast<const float4*>(scale + 8 * c);
      const float4 g1 = *reinterpret_cast<const float4*>(scale + 8 * c + 4);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = y[i] * inv * g[i];
    }
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float partner = __shfl_xor_sync(0xffffffffu, y[i], cph / 2);
      o[i] = y[i] * cs[i] + partner * sn[i];
    }
    if (mine) *reinterpret_cast<uint4*>(orow + (size_t)(c / cph) * S * d) = pack8(o);
  }
}

// Any d % 8 == 0: a warp a row, 4 rows a CTA.
__global__ void __launch_bounds__(128)
norm_rope_any_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ cosb, const float* __restrict__ sinb,
                     bf16* __restrict__ out, int rows, int S, int D, int H, int d, float eps) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * 4 + threadIdx.x / 32;
  if (row >= rows) return;  // the same for every lane of a warp
  const bf16* xr = x + (size_t)row * D;
  float ss = 0.f;
  for (int c = lane; c < D / 8; c += 32) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + 8 * c), v);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss = fmaf(v[i], v[i], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / (float)D + eps);
  const int half = d / 2, b = row / S, s = row % S;
  const float* cr = cosb + (size_t)s * half;
  const float* sr = sinb + (size_t)s * half;
  for (int c = lane; c < D / 8; c += 32) {
    const int h = 8 * c / d;  // a chunk lies in one head: d % 8 == 0
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int jc = 8 * c + i - h * d;
      const int jp = jc < half ? jc + half : jc - half, jj = jc < half ? jc : jc - half;
      const float y = __bfloat162float(xr[8 * c + i]) * inv * scale[8 * c + i];
      const float yp = __bfloat162float(xr[h * d + jp]) * inv * scale[h * d + jp];
      o[i] = y * cr[jj] + yp * (jc < half ? -sr[jj] : sr[jj]);
    }
    *reinterpret_cast<uint4*>(out + (((size_t)b * H + h) * S + s) * d + 8 * c - h * d) =
        pack8(o);
  }
}

template <int CPL, int WPR>
static void launch_rope(const bf16* x, const float* scale, const float* cosb,
                        const float* sinb, bf16* out, int rows, int S, int D, int H, int d,
                        float eps, cudaStream_t st) {
  using R = RopeShape<CPL, WPR>;
  norm_rope_kernel<CPL, WPR><<<(rows + R::ROWS - 1) / R::ROWS, R::THREADS, 0, st>>>(
      x, scale, cosb, sinb, out, rows, S, D, H, d, eps);
}

// One warp a row up to 256 chunks (D <= 2048), four up to 1024 (D <= 8192).
static void dispatch_rope(const bf16* x, const float* scale, const float* cosb,
                          const float* sinb, bf16* out, int rows, int S, int D, int H, int d,
                          float eps, cudaStream_t st) {
  const int nch = D / 8;
#define BT_ROPE(CPL, WPR) \
  return launch_rope<CPL, WPR>(x, scale, cosb, sinb, out, rows, S, D, H, d, eps, st)
  if (nch <= 256) {
    switch ((nch + 31) / 32) {
      case 1: BT_ROPE(1, 1);
      case 2: BT_ROPE(2, 1);
      case 3: BT_ROPE(3, 1);
      case 4: BT_ROPE(4, 1);
      case 5: BT_ROPE(5, 1);
      case 6: BT_ROPE(6, 1);
      case 7: BT_ROPE(7, 1);
      default: BT_ROPE(8, 1);
    }
  }
  switch ((nch + 127) / 128) {
    case 3: BT_ROPE(3, 4);
    case 4: BT_ROPE(4, 4);
    case 5: BT_ROPE(5, 4);
    case 6: BT_ROPE(6, 4);
    case 7: BT_ROPE(7, 4);
    default: BT_ROPE(8, 4);
  }
#undef BT_ROPE
}

}  // namespace bt

// x [b, s, dim] bf16, scale [dim] f32, cos/sin [s, d/2] f32 with d = dim /
// heads -> out [b, heads, s, d] bf16.  Needs dim % 8 == 0, d % 8 == 0 and
// dim <= 8192; every pointer 16-byte aligned.
BT_API int bt_norm_rope(const void* x, const void* scale, const void* cos, const void* sin,
                        void* out, int b, int s, int dim, int heads, float eps,
                        void* stream) {
  if (heads <= 0 || dim % heads) return (int)cudaErrorInvalidValue;
  const int d = dim / heads, cph = d / 8;
  if (dim % 8 || d % 8 || dim > 8192 || b <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  const int rows = b * s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bt::bf16* xb = static_cast<const bt::bf16*>(x);
  const float *sc = static_cast<const float*>(scale), *cb = static_cast<const float*>(cos),
              *sb = static_cast<const float*>(sin);
  bt::bf16* ob = static_cast<bt::bf16*>(out);
  if (cph >= 2 && cph <= 32 && (cph & (cph - 1)) == 0)
    bt::dispatch_rope(xb, sc, cb, sb, ob, rows, s, dim, heads, d, eps, st);
  else
    bt::norm_rope_any_kernel<<<(rows + 3) / 4, 128, 0, st>>>(xb, sc, cb, sb, ob, rows, s, dim,
                                                              heads, d, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// heads_pack / heads_unpack: the [B, S, H*d] <-> [B, H, S, d] relayouts.
//
// Replaces blade/kernels/norm_rope.py::_pack_kernel and ::_unpack_kernel.
// What bounds them on the H100: memory bandwidth (a pure copy: every byte
// read once and written once).  The design copies one token row a CTA in
// chunks of the widest type (16 down to 1 byte) that divides a head's row of
// d elements and the tensors' alignment, so a head's row moves as whole
// 16-byte vectors where it can; the token side of the copy is contiguous and
// the head side is H contiguous runs of d elements.  Any element size and
// any shape (the TPU's row-tile fallback is a tiling detail).
namespace bt {

// One CTA a token (b, s): PACK moves x[b, s, :] to out[b, :, s, :];
// otherwise x[b, :, s, :] to out[b, s, :].  cpr = chunks a head row.
template <typename T, bool PACK>
__global__ void heads_relayout_kernel(const T* __restrict__ x, T* __restrict__ out, int S,
                                      int H, int cpr) {
  const int row = blockIdx.x;  // b * S + s
  const int b = row / S, s = row % S;
  const size_t tok = (size_t)row * H * cpr;
  for (int i = threadIdx.x; i < H * cpr; i += blockDim.x) {
    const int h = i / cpr, c = i % cpr;
    const size_t head = (((size_t)b * H + h) * S + s) * cpr + c;
    if (PACK)
      out[head] = x[tok + i];
    else
      out[tok + i] = x[head];
  }
}

template <bool PACK>
static int launch_relayout(const void* x, void* out, int b, int s, int h, int d, int esize,
                           cudaStream_t stream) {
  const size_t row_bytes = (size_t)d * esize;
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out;
  const int rows = b * s;
  const int threads = 128;
#define BT_RELAYOUT(T)                                                                     \
  if (row_bytes % sizeof(T) == 0 && align % sizeof(T) == 0) {                              \
    heads_relayout_kernel<T, PACK><<<rows, threads, 0, stream>>>(                          \
        static_cast<const T*>(x), static_cast<T*>(out), s, h, (int)(row_bytes / sizeof(T))); \
    return (int)cudaGetLastError();                                                        \
  }
  BT_RELAYOUT(uint4)
  BT_RELAYOUT(uint2)
  BT_RELAYOUT(uint32_t)
  BT_RELAYOUT(uint16_t)
  BT_RELAYOUT(uint8_t)
#undef BT_RELAYOUT
  return (int)cudaErrorInvalidValue;
}

static bool relayout_args_ok(int b, int s, int h, int d, int esize) {
  return b > 0 && s > 0 && h > 0 && d > 0 && esize > 0 && (long long)b * s <= 2147483647LL &&
         (long long)h * d * esize <= 2147483647LL;
}

}  // namespace bt

// x [b, s, h*d] -> out [b, h, s, d], elements of `esize` bytes.
BT_API int bt_heads_pack(const void* x, void* out, int b, int s, int h, int d, int esize,
                         void* stream) {
  if (!bt::relayout_args_ok(b, s, h, d, esize)) return (int)cudaErrorInvalidValue;
  return bt::launch_relayout<true>(x, out, b, s, h, d, esize, static_cast<cudaStream_t>(stream));
}

// x [b, h, s, d] -> out [b, s, h*d], elements of `esize` bytes.
BT_API int bt_heads_unpack(const void* x, void* out, int b, int h, int s, int d, int esize,
                           void* stream) {
  if (!bt::relayout_args_ok(b, s, h, d, esize)) return (int)cudaErrorInvalidValue;
  return bt::launch_relayout<false>(x, out, b, s, h, d, esize, static_cast<cudaStream_t>(stream));
}
