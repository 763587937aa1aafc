// Fused q/k lane: RMSNorm over the full width D times `scale`, head split
// [B, S, D] -> [B, H, S, d], and rotate-half RoPE, in one pass.
//
// Replaces blade/kernels/norm_rope.py::_norm_rope_kernel (norm_rope_heads).
//
// What bounds it on the H100: memory bandwidth.  Per row it reads D bf16
// values (+ d f32 cos/sin values, shared by the heads) and writes D bf16
// values, doing ~10 flops per element, far below the ridge point.  The
// design reads and writes each element exactly once with 16-byte vectors:
// one thread owns 8 consecutive channels of a row (so its 8 outputs land
// contiguously inside one head), the row's sum of squares is reduced in
// shared memory, the normalized row is staged there in f32 so each thread
// can read its rotate-half partner (channel j +- d/2), and the output is
// written straight into the head-major layout.  Several rows share a CTA.
#include "common.cuh"

namespace bt {

__global__ void norm_rope_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                                 const float* __restrict__ cosb,
                                 const float* __restrict__ sinb, bf16* __restrict__ out,
                                 int rows, int S, int D, int H, int d, float eps) {
  extern __shared__ float sm[];
  const int tpr = blockDim.x;  // threads per row = D / 8
  const int tx = threadIdx.x, ty = threadIdx.y;
  float* ybuf = sm + ty * D;
  float* part = sm + blockDim.y * D + ty * tpr;
  const int row = blockIdx.x * blockDim.y + ty;
  const bool live = row < rows;

  float xv[8];
  float ss = 0.f;
  if (live) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)row * D + tx * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xv[i] = __bfloat162float(e[i]);
      ss += xv[i] * xv[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) xv[i] = 0.f;
  }
  part[tx] = ss;
  __syncthreads();
  if (tx == 0) {
    float tot = 0.f;
    for (int i = 0; i < tpr; ++i) tot += part[i];
    part[0] = tot;
  }
  __syncthreads();
  const float inv = rsqrtf(part[0] / (float)D + eps);
#pragma unroll
  for (int i = 0; i < 8; ++i) ybuf[tx * 8 + i] = xv[i] * inv * scale[tx * 8 + i];
  __syncthreads();
  if (!live) return;

  const int col0 = tx * 8, h = col0 / d, j0 = col0 % d, half = d / 2;
  const int b = row / S, s = row % S;
  const float* yh = ybuf + h * d;
  const float* cr = cosb + (size_t)s * half;
  const float* sr = sinb + (size_t)s * half;
  __align__(16) bf16 o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = j0 + i;
    const int jj = j < half ? j : j - half;
    const float partner = yh[j < half ? j + half : j - half];
    const float sn = j < half ? -sr[jj] : sr[jj];
    o[i] = __float2bfloat16_rn(yh[j] * cr[jj] + partner * sn);
  }
  *reinterpret_cast<uint4*>(out + (((size_t)b * H + h) * S + s) * d + j0) =
      *reinterpret_cast<const uint4*>(o);
}

}  // namespace bt

// x [b, s, dim] bf16, scale [dim] f32, cos/sin [s, d/2] f32 with d = dim /
// heads -> out [b, heads, s, d] bf16.  Needs dim % 8 == 0, d % 8 == 0 and
// dim / 8 <= 1024.
BT_API int bt_norm_rope(const void* x, const void* scale, const void* cos, const void* sin,
                        void* out, int b, int s, int dim, int heads, float eps,
                        void* stream) {
  if (heads <= 0 || dim % heads) return (int)cudaErrorInvalidValue;
  const int d = dim / heads;
  const int tpr = dim / 8;
  if (dim % 8 || d % 8 || tpr > 1024 || b <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  int nrows = 1024 / tpr < 4 ? 1024 / tpr : 4;
  while (nrows > 1 && (size_t)nrows * (dim + tpr) * sizeof(float) > 48 * 1024) --nrows;
  const size_t smem = (size_t)nrows * (dim + tpr) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int rows = b * s;
  const dim3 block(tpr, nrows);
  const dim3 grid((rows + nrows - 1) / nrows);
  bt::norm_rope_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bt::bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<bt::bf16*>(out), rows, s, dim, heads, d, eps);
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
