// Strided-to-contiguous copy of 4-byte elements for Hopper (sm_90a), up to rank 4.
//
//   y[i0,i1,i2,i3] = x[i0*s0 + i1*s1 + i2*s2 + i3*s3]    (strides in elements)
//
// y is a fresh contiguous buffer. Replaces the Pallas kernel
// multistgraph_tpu/ops/layout.py: _copy_kernel / force_default_layout. On the
// TPU that copy forces the default tiled layout on the encoder's per-step
// input stacks; here it turns the non-contiguous f32 slices xw[..., :2H] and
// xw[..., 2H:] into dense stacks once, so that each step of the scan reads
// one dense (B, N, C) slab.
//
// Bound on an H100: bytes, read once and written once: 93 MB for the
// flagship gate_x (24,16,237,128) f32, 28 us at 3.35 TB/s. Where the source
// rows are contiguous and 16-byte aligned (the main path's case), each thread
// moves 4 elements with one 16-byte load and one 16-byte store; otherwise
// each thread gathers one element. Elements are copied as raw bits. Index
// math is 32-bit; the wrapper admits fewer than 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int V>
struct alignas(4 * V) Pack {
  uint32_t e[V];
};

template <int V>
__global__ void __launch_bounds__(256)
strided_copy_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y, uint32_t d1,
                    uint32_t d2, uint32_t d3, int64_t s0, int64_t s1, int64_t s2, int64_t s3,
                    uint32_t num_packs) {
  const uint32_t step = gridDim.x * blockDim.x;
  for (uint32_t p = blockIdx.x * blockDim.x + threadIdx.x; p < num_packs; p += step) {
    uint32_t r = p * V;              // first output element of this pack
    const uint32_t i3 = r % d3; r /= d3;
    const uint32_t i2 = r % d2; r /= d2;
    const uint32_t i1 = r % d1;
    const uint32_t i0 = r / d1;
    const uint32_t* src = x + i0 * s0 + i1 * s1 + i2 * s2 + i3 * s3;
    // V == 4: the source row is contiguous and aligned (checked by the caller)
    reinterpret_cast<Pack<V>*>(y)[p] = *reinterpret_cast<const Pack<V>*>(src);
  }
}

template <int V>
cudaError_t launch(const void* x, void* y, int64_t d0, int64_t d1, int64_t d2, int64_t d3,
                   int64_t s0, int64_t s1, int64_t s2, int64_t s3, cudaStream_t stream) {
  const int64_t packs = d0 * d1 * d2 * d3 / V;
  const int64_t blocks = (packs + 255) / 256;
  const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
  strided_copy_kernel<V><<<grid, 256, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), (uint32_t)d1, (uint32_t)d2,
      (uint32_t)d3, s0, s1, s2, s3, (uint32_t)packs);
  return cudaGetLastError();
}

}  // namespace

// Copies x (4-byte elements, sizes d0..d3, element strides s0..s3, fewer than
// 2^31 elements) into contiguous y on `stream`; returns cudaGetLastError()
// after the launch.
extern "C" int layout_copy(const void* x, void* y, int64_t d0, int64_t d1, int64_t d2,
                           int64_t d3, int64_t s0, int64_t s1, int64_t s2, int64_t s3,
                           void* stream) {
  const int64_t total = d0 * d1 * d2 * d3;
  if (total == 0) return (int)cudaSuccess;
  if (total >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d3 % 4 == 0 && s3 == 1 && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return (int)(vec ? launch<4>(x, y, d0, d1, d2, d3, s0, s1, s2, s3, st)
                   : launch<1>(x, y, d0, d1, d2, d3, s0, s1, s2, s3, st));
}
