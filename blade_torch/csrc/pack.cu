// K/V record packing for the block-sparse gather.
//
// Replaces blade/kernels/pack.py::_pack_kernel with pyramid=False (pack_kv).
// Output layout [BH, n_kt, 2, 128, d]: record b of a head holds the 128 K rows
// of key block b followed by its 128 V rows, so bt_attn_sparse_fwd reads one
// contiguous 2*128*d record per listed block.  Rows past the key length lk
// (the ragged last block) are written as zeros.
//
// What bounds it on the H100: memory bandwidth only (no arithmetic).  Each
// thread moves 16 bytes with consecutive threads on consecutive addresses on
// both the read and the write side; a grid-stride loop keeps the grid at a
// few waves of the 132 SMs.
#include "common.cuh"

namespace bt {

__global__ void pack_kv_kernel(const uint4* __restrict__ k, const uint4* __restrict__ v,
                               uint4* __restrict__ out, int lk, int n_kt, int dvec,
                               long long total) {
  const long long rec_rows = (long long)n_kt * 256;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % dvec);
    const long long r_all = i / dvec;
    const int r = (int)(r_all % rec_rows);
    const long long bh = r_all / rec_rows;
    const int w = r & 255;
    const int src = (r >> 8) * 128 + (w & 127);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src < lk) val = (w < 128 ? k : v)[(bh * lk + src) * dvec + c];
    out[i] = val;
  }
}

}  // namespace bt

// k, v [bh, lk, d] bf16 -> out [bh, ceil(lk/128) * 256, d] bf16.  d % 8 == 0.
BT_API int bt_pack_kv(const void* k, const void* v, void* out, int bh, int lk, int d,
                      void* stream) {
  if (d % 8 || bh <= 0 || lk <= 0) return (int)cudaErrorInvalidValue;
  const int n_kt = (lk + 127) / 128;
  const int dvec = d / 8;
  const long long total = (long long)bh * n_kt * 256 * dvec;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  bt::pack_kv_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k), static_cast<const uint4*>(v), static_cast<uint4*>(out),
      lk, n_kt, dvec, total);
  return (int)cudaGetLastError();
}
