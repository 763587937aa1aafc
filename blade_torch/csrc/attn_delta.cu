// delta = rowsum(dO * O), the row statistic of every flash-attention
// backward, for Hopper (sm_90a): bf16 out and g_out [rows, d] -> f32
// delta [rows].
//
// Not a TPU kernel: blade/kernels/block_sparse_attn.py computes it in XLA
// before the backward kernels (`_bwd_call`, `gather_backward`:
// jnp.sum(g_out.astype(f32) * out.astype(f32), -1)).  The port's backward
// kernels (flash_attn_bwd.cu, pooled_level_bwd.cu) take it as an input, and
// the plain torch expression costs four kernels and two f32 copies of both
// inputs.
//
// What bounds it on the H100: bytes, both inputs read once (2 x 100.6 MB at
// Wan 480p, 0.06 ms at 3.35 TB/s); 2 d flops a row are nothing.  Design: d/8
// threads a row, each one 16-byte load of each input and eight f32
// multiply-adds, then a shuffle reduction within the row's lanes; 256
// threads a block, enough blocks in flight to cover the memory latency.
#include "common.cuh"

namespace bt {

template <int D>
__global__ void __launch_bounds__(256) delta_kernel(const bf16* __restrict__ out,
                                                    const bf16* __restrict__ g,
                                                    float* __restrict__ delta, int rows) {
  constexpr int TPR = D / 8;  // threads a row, one 16-byte chunk each
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long row = i / TPR;
  const int chunk = (int)(i % TPR);
  float s = 0.f;
  if (row < rows) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(out + row * D) + chunk);
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(g + row * D) + chunk);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(pa[j]), y = __bfloat1622float2(pb[j]);
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
    }
  }
  // A row's TPR lanes are adjacent within one warp (32 % TPR == 0).
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (row < rows && chunk == 0) delta[row] = s;
}

template <int D>
static int launch_delta(const void* out, const void* g, void* delta, int rows,
                        cudaStream_t stream) {
  const long long threads = (long long)rows * (D / 8);
  delta_kernel<D><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(g), static_cast<float*>(delta),
      rows);
  return (int)cudaGetLastError();
}

}  // namespace bt

// out, g_out [rows, d] bf16, contiguous and 16-byte aligned -> delta [rows]
// f32.  d in {64, 128}.
BT_API int bt_attn_delta(const void* out, const void* g_out, void* delta, int rows, int d,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  if (d == 128) return bt::launch_delta<128>(out, g_out, delta, rows, st);
  if (d == 64) return bt::launch_delta<64>(out, g_out, delta, rows, st);
  return (int)cudaErrorInvalidValue;
}
