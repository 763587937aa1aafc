// CogVideoX's q/k lane: per-head LayerNorm over d = 64 with an affine
// weight and bias, rounding to bf16, rotate-half RoPE on the video rows
// only, and the head split [B, L, H*64] -> [B, H, L, 64], for q and k in
// one launch (qk_norm_rope_kernel); and its input gradient, the same
// layout in reverse (qk_norm_rope_dx_kernel).
//
// Replaces the XLA composition of blade/models/cogvideox_dit.py:137-151
// (no Pallas kernel: LayerNorm, cast, RoPE by slices and concatenate).
// Rounding points are that composition's: the LayerNorm in f32, its output
// rounded to bf16, the rotation in f32 (products and sums rounded one by
// one, as the plain version's separate operations do) and rounded to bf16.
// Which rows are video is an argument (vid_start, n_vid), so one kernel
// serves the joint order [text, video] and ASA's [video, text].
//
// What bounds it on the H100: memory bandwidth.  The forward reads two
// projection outputs and writes two [B, H, L, 64] tensors, ~30 flops an
// element (CogVideoX-5B 480p, [1, 17776, 3072] each: 437 MB, 0.130 ms at
// 3.35 TB/s); the backward reads the two gradients and the two saved
// projection outputs and writes two input gradients (655 MB, 0.196 ms).  So
// each element is read and written once, as 16-byte vectors, with the row
// in registers:
//   * a warp a token row, four rows a CTA, blockIdx.y picks q or k; lane u
//     owns chunks (of 8 channels) u, u + 32, ..., CPL of them, each one
//     16-byte load, so a warp's load is 512 contiguous bytes.  A head is 8
//     chunks, so every chunk of a lane is chunk j = u % 8 of its head: the
//     lane's 8 weights, 8 biases and 8 cos / sin values are loaded once a
//     row, into registers;
//   * mean and variance (two passes over the registers) reduce by
//     __shfl_xor over the head's 8 lanes, in f32;
//   * channel i's rotate-half partner, i +- 32, is lane ^ 4;
//   * the 8 lanes of a head write its 128 contiguous bytes at out[b, h, l].
#include "common.cuh"

namespace bt {

constexpr int QK_D = 64;     // head width: 8 chunks of 8 channels
constexpr int QK_ROWS = 4;   // token rows a CTA: a warp a row
constexpr int QK_THREADS = 32 * QK_ROWS;

static __device__ __forceinline__ void qk_unpack(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(e[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

static __device__ __forceinline__ uint4 qk_pack(const float (&v)[8]) {
  uint4 r;
  r.x = pack_bf16(v[0], v[1]);
  r.y = pack_bf16(v[2], v[3]);
  r.z = pack_bf16(v[4], v[5]);
  r.w = pack_bf16(v[6], v[7]);
  return r;
}

static __device__ __forceinline__ void qk_load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

static __device__ __forceinline__ float qk_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Sum over the 8 lanes of a head.
static __device__ __forceinline__ float head_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// The head's mean and 1 / sqrt(var + eps), f32, two passes.
static __device__ __forceinline__ void head_stats(const float (&v)[8], float eps, float& mean,
                                                  float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += v[i];
  mean = head_sum(s) * (1.f / QK_D);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) q = fmaf(v[i] - mean, v[i] - mean, q);
  rstd = rsqrtf(head_sum(q) * (1.f / QK_D) + eps);
}

// The row's place: batch b, token l, and its table row t (video iff
// 0 <= t < n_vid; the same for every lane of the warp).
struct QkRow {
  int b, l, t;
  bool video;
  __device__ QkRow(int row, int L, int vid_start, int n_vid)
      : b(row / L), l(row % L), t(row % L - vid_start), video(t >= 0 && t < n_vid) {}
};

// x [B, L, H*64] (q or k by blockIdx.y) -> out [B, H, L, 64].  CPL = chunks
// a lane: H * 8 <= 32 CPL.
template <int CPL>
__global__ void __launch_bounds__(QK_THREADS)
qk_norm_rope_kernel(const bf16* __restrict__ xq, const bf16* __restrict__ xk,
                    const float* __restrict__ wq, const float* __restrict__ bq,
                    const float* __restrict__ wk, const float* __restrict__ bk,
                    const float* __restrict__ cosb, const float* __restrict__ sinb,
                    bf16* __restrict__ oq, bf16* __restrict__ ok, int rows, int L, int H,
                    int vid_start, int n_vid, float eps) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * QK_ROWS + threadIdx.x / 32;
  if (row >= rows) return;  // the same for every lane of a warp
  const bool is_k = blockIdx.y != 0;
  const bf16* x = is_k ? xk : xq;
  bf16* out = is_k ? ok : oq;
  const int j = lane & 7, nch = H * 8;
  const QkRow r(row, L, vid_start, n_vid);
  uint4 raw[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    raw[k] = make_uint4(0u, 0u, 0u, 0u);
    if (c < nch) raw[k] = *reinterpret_cast<const uint4*>(x + (size_t)row * nch * 8 + 8 * c);
  }
  float w[8], bias[8], cs[8], sn[8];
  qk_load8((is_k ? wk : wq) + 8 * j, w);
  qk_load8((is_k ? bk : bq) + 8 * j, bias);
  if (r.video) {
    qk_load8(cosb + (size_t)r.t * (QK_D / 2) + 8 * (j & 3), cs);
    qk_load8(sinb + (size_t)r.t * (QK_D / 2) + 8 * (j & 3), sn);
  }
  const bool first = j < 4;  // channels 0..31 of the head: re; 32..63: im
  bf16* orow = out + ((size_t)r.b * H * L + r.l) * QK_D + 8 * j;  // head h at + h L 64
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;  // a head's 8 lanes are all below nch or none
    float v[8], mean, rstd;
    qk_unpack(raw[k], v);
    head_stats(v, eps, mean, rstd);
    float y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = qk_round(fmaf((v[i] - mean) * rstd, w[i], bias[i]));
    if (r.video) {
      // re * cos - im * sin | re * sin + im * cos, each product rounded.
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = __shfl_xor_sync(0xffffffffu, y[i], 4);
        const float own = __fmul_rn(y[i], cs[i]), other = __fmul_rn(p, sn[i]);
        y[i] = first ? __fsub_rn(own, other) : __fadd_rn(other, own);
      }
    }
    if (c < nch) *reinterpret_cast<uint4*>(orow + (size_t)(c / 8) * L * QK_D) = qk_pack(y);
  }
}

// g [B, H, L, 64] and the saved x [B, L, H*64] (q or k by blockIdx.y) ->
// dx [B, L, H*64].  On video rows g turns by -theta and is rounded to bf16
// (the gradient of the bf16 LayerNorm output, as autograd holds it); both
// forward roundings pass it unchanged.  Then LayerNorm's input gradient in
// f32: dx = rstd (gw - mean(gw) - xhat mean(gw xhat)), gw = dy w.
template <int CPL>
__global__ void __launch_bounds__(QK_THREADS)
qk_norm_rope_dx_kernel(const bf16* __restrict__ gq, const bf16* __restrict__ gk,
                       const bf16* __restrict__ xq, const bf16* __restrict__ xk,
                       const float* __restrict__ wq, const float* __restrict__ wk,
                       const float* __restrict__ cosb, const float* __restrict__ sinb,
                       bf16* __restrict__ dq, bf16* __restrict__ dk, int rows, int L, int H,
                       int vid_start, int n_vid, float eps) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * QK_ROWS + threadIdx.x / 32;
  if (row >= rows) return;  // the same for every lane of a warp
  const bool is_k = blockIdx.y != 0;
  const bf16* x = is_k ? xk : xq;
  const bf16* g = is_k ? gk : gq;
  bf16* dx = is_k ? dk : dq;
  const int j = lane & 7, nch = H * 8;
  const QkRow r(row, L, vid_start, n_vid);
  const bf16* grow = g + ((size_t)r.b * H * L + r.l) * QK_D + 8 * j;
  uint4 xraw[CPL], graw[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    xraw[k] = graw[k] = make_uint4(0u, 0u, 0u, 0u);
    if (c < nch) {
      xraw[k] = *reinterpret_cast<const uint4*>(x + (size_t)row * nch * 8 + 8 * c);
      graw[k] = *reinterpret_cast<const uint4*>(grow + (size_t)(c / 8) * L * QK_D);
    }
  }
  float w[8], cs[8], sn[8];
  qk_load8((is_k ? wk : wq) + 8 * j, w);
  if (r.video) {
    qk_load8(cosb + (size_t)r.t * (QK_D / 2) + 8 * (j & 3), cs);
    qk_load8(sinb + (size_t)r.t * (QK_D / 2) + 8 * (j & 3), sn);
  }
  const bool first = j < 4;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    float v[8], dy[8], mean, rstd;
    qk_unpack(xraw[k], v);
    qk_unpack(graw[k], dy);
    head_stats(v, eps, mean, rstd);
    if (r.video) {
      // d re = g_re cos + g_im sin | d im = g_im cos - g_re sin.
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = __shfl_xor_sync(0xffffffffu, dy[i], 4);
        const float own = __fmul_rn(dy[i], cs[i]), other = __fmul_rn(p, sn[i]);
        dy[i] = qk_round(first ? __fadd_rn(own, other) : __fsub_rn(own, other));
      }
    }
    float xhat[8], gw[8], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xhat[i] = (v[i] - mean) * rstd;
      gw[i] = dy[i] * w[i];
      s1 += gw[i];
      s2 = fmaf(gw[i], xhat[i], s2);
    }
    s1 = head_sum(s1) * (1.f / QK_D);
    s2 = head_sum(s2) * (1.f / QK_D);
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = rstd * (gw[i] - s1 - xhat[i] * s2);
    if (c < nch) *reinterpret_cast<uint4*>(dx + (size_t)row * nch * 8 + 8 * c) = qk_pack(o);
  }
}

// Chunks a lane: one warp a row of H * 8 chunks, H <= 64.
#define BT_QK_DISPATCH(KERNEL, ...)                                             \
  switch ((H + 3) / 4) {                                                        \
    case 1: KERNEL<1><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;         \
    case 2: KERNEL<2><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;         \
    case 3: KERNEL<3><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;         \
    case 4: KERNEL<4><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;         \
    case 5: KERNEL<5><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;         \
    case 6: KERNEL<6><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;         \
    case 7: KERNEL<7><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;         \
    case 8: KERNEL<8><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;         \
    case 9: KERNEL<9><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;         \
    case 10: KERNEL<10><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;       \
    case 11: KERNEL<11><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;       \
    case 12: KERNEL<12><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;       \
    case 13: KERNEL<13><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;       \
    case 14: KERNEL<14><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;       \
    case 15: KERNEL<15><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;       \
    default: KERNEL<16><<<grid, QK_THREADS, 0, st>>>(__VA_ARGS__); break;       \
  }

static bool qk_args_ok(int b, int l, int h, int vid_start, int n_vid) {
  return b > 0 && l > 0 && h > 0 && h <= 64 && vid_start >= 0 && n_vid >= 0 &&
         (long long)vid_start + n_vid <= l && (long long)b * l <= 2147483647LL / QK_ROWS;
}

}  // namespace bt

// xq, xk [b, l, heads * 64] bf16; wq, bq, wk, bk [64] f32; cos, sin
// [n_vid, 32] f32 for rows vid_start .. vid_start + n_vid - 1 -> oq, ok
// [b, heads, l, 64] bf16.  heads <= 64; every pointer 16-byte aligned.
BT_API int bt_qk_norm_rope(const void* xq, const void* xk, const void* wq, const void* bq,
                           const void* wk, const void* bk, const void* cos, const void* sin,
                           void* oq, void* ok, int b, int l, int heads, int vid_start,
                           int n_vid, float eps, void* stream) {
  using namespace bt;
  if (!qk_args_ok(b, l, heads, vid_start, n_vid)) return (int)cudaErrorInvalidValue;
  const int rows = b * l, H = heads;
  const dim3 grid((rows + QK_ROWS - 1) / QK_ROWS, 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BT_QK_DISPATCH(qk_norm_rope_kernel, static_cast<const bf16*>(xq),
                 static_cast<const bf16*>(xk), static_cast<const float*>(wq),
                 static_cast<const float*>(bq), static_cast<const float*>(wk),
                 static_cast<const float*>(bk), static_cast<const float*>(cos),
                 static_cast<const float*>(sin), static_cast<bf16*>(oq), static_cast<bf16*>(ok),
                 rows, l, H, vid_start, n_vid, eps)
  return (int)cudaGetLastError();
}

// gq, gk [b, heads, l, 64] bf16 and the forward's xq, xk, wq, wk, cos, sin
// -> dq, dk [b, l, heads * 64] bf16.
BT_API int bt_qk_norm_rope_dx(const void* gq, const void* gk, const void* xq, const void* xk,
                              const void* wq, const void* wk, const void* cos, const void* sin,
                              void* dq, void* dk, int b, int l, int heads, int vid_start,
                              int n_vid, float eps, void* stream) {
  using namespace bt;
  if (!qk_args_ok(b, l, heads, vid_start, n_vid)) return (int)cudaErrorInvalidValue;
  const int rows = b * l, H = heads;
  const dim3 grid((rows + QK_ROWS - 1) / QK_ROWS, 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BT_QK_DISPATCH(qk_norm_rope_dx_kernel, static_cast<const bf16*>(gq),
                 static_cast<const bf16*>(gk), static_cast<const bf16*>(xq),
                 static_cast<const bf16*>(xk), static_cast<const float*>(wq),
                 static_cast<const float*>(wk), static_cast<const float*>(cos),
                 static_cast<const float*>(sin), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                 rows, l, H, vid_start, n_vid, eps)
  return (int)cudaGetLastError();
}
