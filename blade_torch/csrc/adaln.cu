// Wan's block glue as row kernels: the LayerNorm with a per-sample affine
// (AdaLN's modulation, the cross-attention's LayerNorm, the head's), the
// residual adds and gated residual adds before them, and the last gated
// residual alone.
//
//   norm_affine:      h  = bf16(LN(x) * w + b)
//   add_norm_affine:  x' = bf16(x + bf16(gate * y))  (or bf16(x + y)),
//                     h  = bf16(LN(x') * w + b)
//   gated_add:        x' = bf16(x + bf16(gate * y))
//
// x, y, x', h are bf16 [B, S, D] rows; gate, w and b are f32 tables, one row
// of D a sample (a sample stride of 0 shares one row: the cross-attention
// LayerNorm's weight and bias).  The LayerNorm has no affine of its own and
// runs in f32; it reads x' after its rounding to bf16.
//
// Replaces no TPU kernel: the JAX model leaves this glue to XLA
// (blade/models/wan_dit.py:220-239, the head at :357).  Added because the
// port wrote each step as its own f32 pass (x.float(), the LayerNorm,
// * (1 + scale), + shift, the casts, the gated residual's f32 copies):
// about 140 bytes an element of the residual stream a block, 6.4 s of a
// Wan2.1-14B 720p clip.  Rounding points are that expression's: the
// product gate * y rounded to bf16 before the add, the add in f32 rounded
// to bf16, LN(x') * w and + b each rounded in f32 (no contraction into an
// fma), the result rounded to bf16.
//
// What bounds them on the H100: memory bandwidth (~10 flops an element).
// norm_affine reads x and writes h (4 bytes an element); add_norm_affine
// reads x and y and writes x' and h (8); gated_add reads x and y and
// writes x' (6).  At Wan2.1-14B 720p ([1, 75600, 5120], 387 M elements)
// that is 0.46, 0.92 and 0.69 ms at 3.35 TB/s.  The tables (20 KB a row of
// D = 5120) are read from L1 / L2.  So each element is read and written
// once, as 16-byte vectors, with the row in registers, as #4
// (csrc/norm_rope.cu) does:
//   * a row belongs to one warp (D <= 2048) or to four (D <= 8192), 4 or 2
//     rows a CTA; lane u of the row's 32 WPR threads owns chunks (of 8
//     channels) u, u + 32 WPR, ..., CPL of them, each one 16-byte load held
//     in registers.  CPL and WPR are compile-time, so the loads of x (and
//     y) are issued together before any arithmetic;
//   * the mean, then the sum of squared deviations from the registers (two
//     reductions, the row read once), each a __shfl_xor butterfly within
//     the warp plus one shared-memory step across a row's warps;
//   * gated_add has no reduction: a thread a chunk.
#include "common.cuh"

namespace bt {

static __device__ __forceinline__ void ad_unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(e[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

static __device__ __forceinline__ uint4 ad_pack8(const float (&v)[8]) {
  uint4 r;
  r.x = pack_bf16(v[0], v[1]);
  r.y = pack_bf16(v[2], v[3]);
  r.z = pack_bf16(v[4], v[5]);
  r.w = pack_bf16(v[6], v[7]);
  return r;
}

static __device__ __forceinline__ void ad_load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// x + bf16(gate * y) (GATE) or x + y, in f32, for one chunk: the value
// the caller rounds to bf16.
template <bool GATE>
static __device__ __forceinline__ void ad_residual(const uint4& xr, const uint4& yr,
                                                   const float* g, float (&out)[8]) {
  float y[8];
  ad_unpack8(xr, out);
  ad_unpack8(yr, y);
  if constexpr (GATE) {
    float gv[8];
    ad_load8(g, gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv[i], y[i])));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __fadd_rn(out[i], y[i]);
}

// The launch shape of norm_affine_kernel<CPL, WPR, ...>, as #4's: CTA
// threads, rows a CTA, and CTAs an SM to fit under the register cap.
template <int CPL, int WPR>
struct RowShape {
  static constexpr int THREADS = WPR == 1 ? 128 : 256;
  static constexpr int ROWS = THREADS / (32 * WPR);
  static constexpr int MIN_CTAS = WPR == 1 ? 1 : (CPL <= 5 ? 3 : 2);
};

// The sum of v over the row's WPR warps (every thread of the row gets it).
// `part` holds a slot a warp; each call takes its own array.
template <int WPR>
static __device__ __forceinline__ float row_sum(float v, float* part) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  if constexpr (WPR > 1) {
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) part[warp] = v;
    __syncthreads();
    v = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) v += part[warp / WPR * WPR + w];
  }
  return v;
}

// Row ROWS * blockIdx.x + (its slot in the CTA) of rows = B * S; sample
// row / S picks the tables' rows.  ADD: x' = x + (GATE ? bf16(gate * y) :
// y) is written to xo and normalised; else x is.  D / 8 <= 32 WPR CPL.
template <int CPL, int WPR, bool ADD, bool GATE>
__global__ void __launch_bounds__(RowShape<CPL, WPR>::THREADS, RowShape<CPL, WPR>::MIN_CTAS)
norm_affine_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                   const float* __restrict__ gate, int gate_stride,
                   const float* __restrict__ w, int w_stride, const float* __restrict__ b,
                   int b_stride, bf16* __restrict__ xo, bf16* __restrict__ h, int rows, int S,
                   int D, float eps) {
  using R = RowShape<CPL, WPR>;
  constexpr int TPR = 32 * WPR;  // threads a row
  __shared__ float part[2][R::THREADS / 32];
  const int tid = threadIdx.x % TPR;
  const int row = blockIdx.x * R::ROWS + threadIdx.x / TPR;
  const bool live = row < rows;  // the same for every thread of a warp
  const int nch = D / 8, sample = live ? row / S : 0;
  const size_t base = (size_t)row * D;
  uint4 raw[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = tid + k * TPR;
    raw[k] = make_uint4(0u, 0u, 0u, 0u);
    if (live && c < nch) raw[k] = *reinterpret_cast<const uint4*>(x + base + 8 * c);
  }
  if constexpr (ADD) {
    uint4 yr[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = tid + k * TPR;
      yr[k] = make_uint4(0u, 0u, 0u, 0u);
      if (live && c < nch) yr[k] = *reinterpret_cast<const uint4*>(y + base + 8 * c);
    }
    const float* g = GATE ? gate + (size_t)sample * gate_stride : nullptr;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = tid + k * TPR;
      if (live && c < nch) {
        float v[8];
        ad_residual<GATE>(raw[k], yr[k], GATE ? g + 8 * c : nullptr, v);
        raw[k] = ad_pack8(v);
        *reinterpret_cast<uint4*>(xo + base + 8 * c) = raw[k];
      }
    }
  }
  // Mean, then the sum of squared deviations, from the registers.  Chunks
  // past the row (zeros) add nothing to the first sum and are left out of
  // the second.
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    float v[8];
    ad_unpack8(raw[k], v);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += v[i];
  }
  const float mean = row_sum<WPR>(s, part[0]) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    if (tid + k * TPR < nch) {
      float v[8];
      ad_unpack8(raw[k], v);
#pragma unroll
      for (int i = 0; i < 8; ++i) q = fmaf(v[i] - mean, v[i] - mean, q);
    }
  }
  q = row_sum<WPR>(q, part[1]);
  if (!live) return;
  const float rstd = rsqrtf(q / (float)D + eps);
  const float* wr = w + (size_t)sample * w_stride;
  const float* br = b + (size_t)sample * b_stride;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = tid + k * TPR;
    if (c < nch) {
      float v[8], wv[8], bv[8];
      ad_unpack8(raw[k], v);
      ad_load8(wr + 8 * c, wv);
      ad_load8(br + 8 * c, bv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[i] - mean, rstd), wv[i]), bv[i]);
      *reinterpret_cast<uint4*>(h + base + 8 * c) = ad_pack8(v);
    }
  }
}

// gated_add: a thread a chunk of 8 channels over the [B * S, D / 8] chunks.
__global__ void __launch_bounds__(256)
gated_add_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                 const float* __restrict__ gate, int gate_stride, bf16* __restrict__ out,
                 long long chunks, int nch, int S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const long long row = i / nch;
  const int c = (int)(i - row * nch), sample = (int)(row / S);
  const uint4 xr = *reinterpret_cast<const uint4*>(x + 8 * i);
  const uint4 yr = *reinterpret_cast<const uint4*>(y + 8 * i);
  float v[8];
  ad_residual<true>(xr, yr, gate + (size_t)sample * gate_stride + 8 * c, v);
  *reinterpret_cast<uint4*>(out + 8 * i) = ad_pack8(v);
}

struct RowArgs {
  const bf16* x;
  const bf16* y;
  const float* gate;
  int gate_stride;
  const float* w;
  int w_stride;
  const float* b;
  int b_stride;
  bf16* xo;
  bf16* h;
  int rows, S, D;
  float eps;
};

template <int CPL, int WPR, bool ADD, bool GATE>
static void launch_row(const RowArgs& a, cudaStream_t st) {
  using R = RowShape<CPL, WPR>;
  norm_affine_kernel<CPL, WPR, ADD, GATE><<<(a.rows + R::ROWS - 1) / R::ROWS, R::THREADS, 0, st>>>(
      a.x, a.y, a.gate, a.gate_stride, a.w, a.w_stride, a.b, a.b_stride, a.xo, a.h, a.rows, a.S,
      a.D, a.eps);
}

// One warp a row up to 256 chunks (D <= 2048), four up to 1024 (D <= 8192).
template <bool ADD, bool GATE>
static void dispatch_row(const RowArgs& a, cudaStream_t st) {
  const int nch = a.D / 8;
#define BT_ROW(CPL, WPR) return launch_row<CPL, WPR, ADD, GATE>(a, st)
  if (nch <= 256) {
    switch ((nch + 31) / 32) {
      case 1: BT_ROW(1, 1);
      case 2: BT_ROW(2, 1);
      case 3: BT_ROW(3, 1);
      case 4: BT_ROW(4, 1);
      case 5: BT_ROW(5, 1);
      case 6: BT_ROW(6, 1);
      case 7: BT_ROW(7, 1);
      default: BT_ROW(8, 1);
    }
  }
  switch ((nch + 127) / 128) {
    case 3: BT_ROW(3, 4);
    case 4: BT_ROW(4, 4);
    case 5: BT_ROW(5, 4);
    case 6: BT_ROW(6, 4);
    case 7: BT_ROW(7, 4);
    default: BT_ROW(8, 4);
  }
#undef BT_ROW
}

static bool row_args_ok(int bsz, int s, int dim, int strides) {
  return bsz > 0 && s > 0 && dim > 0 && dim % 8 == 0 && dim <= 8192 && strides % 4 == 0 &&
         (long long)bsz * s <= 2147483647LL;
}

}  // namespace bt

// x [bsz, s, dim] bf16, w / b f32 rows of dim, `*_stride` floats apart a
// sample (0: one shared row) -> h [bsz, s, dim] bf16.  dim % 8 == 0, dim <=
// 8192, strides % 4 == 0, every pointer 16-byte aligned.
BT_API int bt_norm_affine(const void* x, const void* w, int w_stride, const void* b,
                          int b_stride, void* h, int bsz, int s, int dim, float eps,
                          void* stream) {
  if (!bt::row_args_ok(bsz, s, dim, w_stride | b_stride)) return (int)cudaErrorInvalidValue;
  const bt::RowArgs a{static_cast<const bt::bf16*>(x), nullptr, nullptr, 0,
                      static_cast<const float*>(w), w_stride, static_cast<const float*>(b),
                      b_stride, nullptr, static_cast<bt::bf16*>(h), bsz * s, s, dim, eps};
  bt::dispatch_row<false, false>(a, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// As bt_norm_affine, of x' = x + bf16(gate * y) (gate null: x + y), which
// is written to xo [bsz, s, dim] bf16.
BT_API int bt_add_norm_affine(const void* x, const void* y, const void* gate, int gate_stride,
                              const void* w, int w_stride, const void* b, int b_stride,
                              void* xo, void* h, int bsz, int s, int dim, float eps,
                              void* stream) {
  if (!bt::row_args_ok(bsz, s, dim, gate_stride | w_stride | b_stride))
    return (int)cudaErrorInvalidValue;
  const bt::RowArgs a{static_cast<const bt::bf16*>(x), static_cast<const bt::bf16*>(y),
                      static_cast<const float*>(gate), gate_stride,
                      static_cast<const float*>(w), w_stride, static_cast<const float*>(b),
                      b_stride, static_cast<bt::bf16*>(xo), static_cast<bt::bf16*>(h),
                      bsz * s, s, dim, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gate)
    bt::dispatch_row<true, true>(a, st);
  else
    bt::dispatch_row<true, false>(a, st);
  return (int)cudaGetLastError();
}

// out = x + bf16(gate * y), x / y / out [bsz, s, dim] bf16, gate f32 rows of
// dim `gate_stride` floats apart a sample.
BT_API int bt_gated_add(const void* x, const void* y, const void* gate, int gate_stride,
                        void* out, int bsz, int s, int dim, void* stream) {
  if (!bt::row_args_ok(bsz, s, dim, gate_stride)) return (int)cudaErrorInvalidValue;
  const long long chunks = (long long)bsz * s * (dim / 8);
  const int threads = 256;
  bt::gated_add_kernel<<<(unsigned)((chunks + threads - 1) / threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bt::bf16*>(x), static_cast<const bt::bf16*>(y),
      static_cast<const float*>(gate), gate_stride, static_cast<bt::bf16*>(out), chunks,
      dim / 8, s);
  return (int)cudaGetLastError();
}
