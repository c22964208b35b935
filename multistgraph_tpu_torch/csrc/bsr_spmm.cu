// Block-sparse (BSR) SpMM for Hopper (sm_90a): Y = A X.
//
//   out[r*128 + i, f] = sum_{p in row_ptr[r] .. row_ptr[r+1]) sum_k
//                       values[p, i, k] * x[col_of[p]*128 + k, f]
//
// values (nnz,128,128) f32 in row-major block order, row_ptr (out_blocks+1)
// int32 CSR-of-blocks offsets, col_of (nnz) int32, x (n_in,F) f32 with
// n_in a multiple of 128, out (out_blocks*128,F) f32; all contiguous. Any
// F >= 1. A row block with no nonzero tile gets zeros.
//
// Replaces two Pallas kernels that compute the same function:
// multistgraph_tpu/ops/spmm.py:_spmm_blockgrid (_spmm_kernel, one grid step
// per nonzero block) and multistgraph_tpu/ops/spmm_stream.py:spmm_stream
// (_stream_kernel, one grid step per output row block). The JAX package
// chooses between them by a TPU rule (128-lane DMA slices); here one kernel
// takes every width.
//
// Bound on an H100: operations from F of about 40 up. At the 49,152-node
// graph (4,946 tiles) and F=128 one call is 20.7 GFLOP, 0.31 ms at the
// 67 TFLOP/s f32 peak, against 0.10 ms for its ~350 MB at 3.35 TB/s; at
// F=16 or 24 the 324 MB of tiles bound it. This first design is plain f32
// FMAs, right before fast: one thread block per (output row block, feature
// tile of 16*TN columns, TN in {1,2,4,8} chosen by F). The block walks its
// row's tiles in order, staging each 128x128 tile in four 128x32 chunks
// together with the matching 32 rows of the gathered x tile in shared
// memory; each of the 256 threads keeps 8 rows x TN columns of the output
// in registers for the whole row and writes them once: no atomics. Feature
// tiles are the fastest grid index, so the blocks of one row run together
// and reread its tiles from L2. Tensor cores (TF32 would move the f32
// results past the parity bounds), cp.async/TMA pipelining and wgmma come
// later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;                 // BSR tile edge
constexpr int kChunk = 32;                  // k rows staged per pass
constexpr int kThreads = 256;               // 16 x 16 threads
constexpr int kRowsPerThread = kBlock / 16; // 8

template <int TN>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const float* __restrict__ values, const int* __restrict__ row_ptr,
                const int* __restrict__ col_of, const float* __restrict__ x,
                float* __restrict__ out, int F) {
  constexpr int FT = 16 * TN;                 // feature columns per block
  constexpr int W = TN < 4 ? TN : 4;          // contiguous columns per thread group
  __shared__ float vs[kBlock][kChunk + 1];    // tile chunk: 128 rows x 32 k (padded)
  __shared__ __align__(16) float xs[kChunk][FT];

  const int r = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[kRowsPerThread][TN];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
    for (int l = 0; l < TN; ++l) acc[j][l] = 0.f;

  const int start = row_ptr[r], end = row_ptr[r + 1];
  for (int p = start; p < end; ++p) {
    const float* v = values + (size_t)p * kBlock * kBlock;
    const float* xb = x + (size_t)col_of[p] * kBlock * F;
    for (int k0 = 0; k0 < kBlock; k0 += kChunk) {
      __syncthreads();  // the previous chunk is no longer read
      // the tile's columns k0..k0+31: 8 float4 per row, neighbouring
      // threads on neighbouring addresses
      for (int q = tid; q < kBlock * kChunk / 4; q += kThreads) {
        const int row = q / (kChunk / 4), c = 4 * (q % (kChunk / 4));
        const float4 w = *reinterpret_cast<const float4*>(v + (size_t)row * kBlock + k0 + c);
        vs[row][c] = w.x;
        vs[row][c + 1] = w.y;
        vs[row][c + 2] = w.z;
        vs[row][c + 3] = w.w;
      }
      // x rows k0..k0+31 of the column block, columns f0..f0+FT-1 (zero past F)
      for (int q = tid; q < kChunk * FT; q += kThreads) {
        const int k = q / FT, c = q % FT;
        const int f = f0 + c;
        xs[k][c] = f < F ? xb[(size_t)(k0 + k) * F + f] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kChunk; ++k) {
        float a[kRowsPerThread], b[TN];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) a[j] = vs[ty + 16 * j][k];
#pragma unroll
        for (int l = 0; l < TN; ++l) b[l] = xs[k][(l / W) * 16 * W + tx * W + l % W];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
          for (int l = 0; l < TN; ++l) acc[j][l] = fmaf(a[j], b[l], acc[j][l]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    float* o = out + ((size_t)r * kBlock + ty + 16 * j) * F;
#pragma unroll
    for (int l = 0; l < TN; ++l) {
      const int f = f0 + (l / W) * 16 * W + tx * W + l % W;
      if (f < F) o[f] = acc[j][l];
    }
  }
}

template <int TN>
cudaError_t launch(const float* values, const int* row_ptr, const int* col_of, const float* x,
                   float* out, int out_blocks, int F, cudaStream_t stream) {
  const dim3 grid((unsigned)((F + 16 * TN - 1) / (16 * TN)), (unsigned)out_blocks);
  bsr_spmm_kernel<TN><<<grid, kThreads, 0, stream>>>(values, row_ptr, col_of, x, out, F);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int bsr_spmm_fwd(const void* values, const void* row_ptr, const void* col_of,
                            const void* x, void* out, int out_blocks, int feat, void* stream) {
  if (out_blocks == 0 || feat == 0) return (int)cudaSuccess;
  const float* v = static_cast<const float*>(values);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* co = static_cast<const int*>(col_of);
  const float* xx = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (feat <= 16) err = launch<1>(v, rp, co, xx, o, out_blocks, feat, s);
  else if (feat <= 32) err = launch<2>(v, rp, co, xx, o, out_blocks, feat, s);
  else if (feat <= 64) err = launch<4>(v, rp, co, xx, o, out_blocks, feat, s);
  else err = launch<8>(v, rp, co, xx, o, out_blocks, feat, s);
  return (int)err;
}
