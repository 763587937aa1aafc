// Shared helpers for the blade_torch Hopper kernels.
//
// Every kernel is exported through a plain C function that launches on the
// stream it is given and returns cudaGetLastError(), so the Python wrapper
// (blade_torch/kernels/_build.py) can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BT_API extern "C" __attribute__((visibility("default")))

namespace bt {

typedef __nv_bfloat16 bf16;

constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF_LSE = -1e30f;  // lse of a row that attends to nothing
constexpr float EMPTY_LSE = -1e29f;    // a backward treats rows at or below it as empty

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values into one 32-bit register: `lo` in the low half, which is
// the element with the smaller index in every mma fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(bf16 lo, bf16 hi) {
  uint32_t l = *reinterpret_cast<const unsigned short*>(&lo);
  uint32_t h = *reinterpret_cast<const unsigned short*>(&hi);
  return l | (h << 16);
}

// 2^x with the hardware approximation; ex2.approx(-inf) == +0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulate.
// Fragment layout (g = lane / 4, t = lane % 4):
//   a0 (g, 2t..2t+1)   a1 (g+8, 2t..)   a2 (g, 2t+8..)   a3 (g+8, 2t+8..)
//   b0 (k 2t..2t+1, n g)                b1 (k 2t+8..2t+9, n g)
//   d0,d1 (g, 2t..2t+1)                 d2,d3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace bt
