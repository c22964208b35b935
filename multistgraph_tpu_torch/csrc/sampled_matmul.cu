// Sampled dense-dense matmul (the SDDMM core) for Hopper (sm_90a).
//
//   out[p, i, j] = sum_k a[row_of[p]*128 + i, k] * bt[col_of[p]*128 + j, k]
//
// i.e. (A B^T) evaluated only at the graph's nonzero 128x128 blocks. a
// (n_a,d) and bt (n_b,d) f32 row-major with n_a, n_b multiples of 128,
// row_of/col_of (nnz) int32, out (nnz,128,128) f32; all contiguous. Taking
// the second operand as rows of length d keeps every read contiguous: the
// backward's x and the forward's transposed node embeddings come that way.
//
// Replaces the Pallas kernel multistgraph_tpu/ops/spmm.py:_sampled_matmul_impl
// (_sampled_kernel), which takes b as (d, n) and computes A B.
//
// Bound on an H100: bytes at small d, operations at large d. At the
// 49,152-node graph (4,946 tiles) the forward (d=16) writes 324 MB, 0.10
// ms at 3.35 TB/s against 2.6 GFLOP; the backward at d=1536 is 249 GFLOP,
// 3.7 ms at the 67 TFLOP/s f32 peak. This first design is plain f32 FMAs:
// one thread block per nonzero tile; it loops over d in chunks of 32,
// staging the 128x32 slices of both operands in shared memory (rows padded
// to 33 floats, so neither the staging nor the reads conflict on banks),
// and each of the 256 threads keeps an 8x8 grid of the tile (rows ty+16j,
// columns tx+16l) in registers and writes it once. Tensor cores and
// pipelined loads come later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kChunk = 32;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPer = kBlock / 16;  // 8 rows and 8 columns per thread

__global__ void __launch_bounds__(kThreads)
sampled_matmul_kernel(const float* __restrict__ a, const float* __restrict__ bt,
                      const int* __restrict__ row_of, const int* __restrict__ col_of,
                      float* __restrict__ out, int d) {
  __shared__ float as[kBlock][kChunk + 1];
  __shared__ float bs[kBlock][kChunk + 1];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* ab = a + (size_t)row_of[p] * kBlock * d;
  const float* bb = bt + (size_t)col_of[p] * kBlock * d;

  float acc[kPer][kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int l = 0; l < kPer; ++l) acc[j][l] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    __syncthreads();  // the previous chunk is no longer read
    // a warp reads 32 neighbouring k of one row (zero past d)
    for (int q = tid; q < kBlock * kChunk; q += kThreads) {
      const int row = q / kChunk, k = q % kChunk;
      const bool in = k0 + k < d;
      as[row][k] = in ? ab[(size_t)row * d + k0 + k] : 0.f;
      bs[row][k] = in ? bb[(size_t)row * d + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      float x[kPer], y[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) x[j] = as[ty + 16 * j][k];
#pragma unroll
      for (int l = 0; l < kPer; ++l) y[l] = bs[tx + 16 * l][k];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
#pragma unroll
        for (int l = 0; l < kPer; ++l) acc[j][l] = fmaf(x[j], y[l], acc[j][l]);
    }
  }

  float* o = out + (size_t)p * kBlock * kBlock;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int l = 0; l < kPer; ++l) o[(ty + 16 * j) * kBlock + tx + 16 * l] = acc[j][l];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int sampled_matmul_fwd(const void* a, const void* bt, const void* row_of,
                                  const void* col_of, void* out, int nnz, int d, void* stream) {
  if (nnz == 0) return (int)cudaSuccess;
  sampled_matmul_kernel<<<(unsigned)nnz, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(bt), static_cast<const int*>(row_of),
      static_cast<const int*>(col_of), static_cast<float*>(out), d);
  return (int)cudaGetLastError();
}
