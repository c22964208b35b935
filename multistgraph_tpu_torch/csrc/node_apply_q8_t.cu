// Transposed int8 node-conditioned weight apply for Hopper (sm_90a).
//
//   dhh[n,b,ki] = bf16( sum_o bf16(dpre[n,b,o] * scale[n,0,o]) * wq[n,ki,o] )
//
// dpre (N,B,O) bf16, wq (Nw,KI,O) int8 with Nw >= N (rows past N are never
// read), scale (Nw,1,O) f32, dhh (N,B,KI) bf16; all contiguous.
//
// Replaces the Pallas kernel multistgraph_tpu/ops/node_apply.py:
// _apply_q8_t_kernel / node_apply_q8_t, the cotangent of node_apply_q8 in
// the int8 reverse scan, at its rounding points: the bf16 cotangent is
// widened to f32 and scaled (the per-(n,o) scale lies on the contraction
// dim here, so it folds into the cotangent before the dot), rounded to
// bf16, contracted over O against the exactly widened int8 weights in f32,
// and the sum is rounded to bf16.
//
// Bound on an H100: bytes. At the flagship gate (N=237, B=16, KI=320,
// O=128) the call reads 0.97 MB of cotangent and 9.7 MB of int8 weights
// and writes 2.4 MB, 13.2 MB in all: 3.9 us at 3.35 TB/s, against 0.3 us
// of bf16 tensor-core time (2.3 us at the update, O=64). The design
// mirrors the forward kernel (node_apply_q8.cu): one block per (node,
// 64-column KI tile); the block stages the tile's int8 weights in shared
// memory once, transposed to (O, 64) so that a warp reads 32 neighbouring
// bytes, then walks the batch in tiles of scaled, bf16-rounded cotangent
// rows (f32 in shared memory): the batch rounded up to 16 rows, at most 32
// (8 or 16 KB at O=128), so shared memory does not grow with B. Each
// thread keeps R=4 output rows of one column in registers across the O
// loop. The weights are read from device memory exactly once; the
// cotangent rows once per KI tile (5 times at KI=320, from L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileK = 64;                    // output (KI) columns per block
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kTileK;    // row groups per block
constexpr int kRows = 4;                      // rows per thread per pass
constexpr int kRowPad = kGroups * kRows;      // rows per pass
constexpr int kMaxTileB = 2 * kRowPad;        // cotangent rows staged at a time, at most

__global__ void __launch_bounds__(kThreads)
node_apply_q8_t_kernel(const __nv_bfloat16* __restrict__ dpre, const int8_t* __restrict__ wq,
                       const float* __restrict__ scale, __nv_bfloat16* __restrict__ dhh,
                       int B, int KI, int O, int tile_b) {
  extern __shared__ float smem[];
  float* ds = smem;                                                    // tile_b x O
  int8_t* ws = reinterpret_cast<int8_t*>(smem + (size_t)tile_b * O);  // O x kTileK

  const int n = blockIdx.x;
  const int k0 = blockIdx.y * kTileK;
  const int tid = threadIdx.x;

  // weights of KI rows k0..k0+63, read along O (contiguous), stored transposed
  const int8_t* wn = wq + (size_t)n * KI * O;
  for (int i = tid; i < kTileK * O; i += kThreads) {
    const int c = i / O, o = i - c * O;
    ws[o * kTileK + c] = (k0 + c < KI) ? wn[(size_t)(k0 + c) * O + o] : (int8_t)0;
  }

  const int c = tid % kTileK;
  const int g = tid / kTileK;
  const int k = k0 + c;
  const float* sn = scale + (size_t)n * O;
  const __nv_bfloat16* dn = dpre + (size_t)n * B * O;
  __nv_bfloat16* on = dhh + (size_t)n * B * KI;
  for (int bt = 0; bt < B; bt += tile_b) {
    const int rows = min(tile_b, B - bt);
    __syncthreads();  // the previous tile is no longer read (and ws is staged)
    const __nv_bfloat16* dt = dn + (size_t)bt * O;
    for (int i = tid; i < tile_b * O; i += kThreads) {
      float v = 0.f;
      if (i < rows * O) {
        const int o = i % O;
        v = __bfloat162float(__float2bfloat16(__bfloat162float(dt[i]) * sn[o]));
      }
      ds[i] = v;
    }
    __syncthreads();
    // rows r0, r0 + kGroups, ..., r0 + (kRows-1)*kGroups of the tile; rows
    // >= `rows` read the zero padding of ds and are not stored
    for (int r0 = g; r0 < rows; r0 += kRowPad) {
      float acc[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
      const float* d0 = ds + (size_t)r0 * O;
      for (int o = 0; o < O; ++o) {
        const float w = (float)ws[o * kTileK + c];
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc[j] = fmaf(d0[j * kGroups * O + o], w, acc[j]);
      }
      if (k < KI) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int r = r0 + j * kGroups;
          if (r < rows) on[(size_t)(bt + r) * KI + k] = __float2bfloat16(acc[j]);
        }
      }
    }
  }
}

}  // namespace

// Rows staged per tile: the batch rounded up to a pass of kRowPad rows, at
// most kMaxTileB, so a small batch stages no more rows than it computes.
static int tile_rows(int b) {
  const int padded = (b + kRowPad - 1) / kRowPad * kRowPad;
  return padded < kMaxTileB ? padded : kMaxTileB;
}

static size_t smem_bytes(int b, int o) {
  return (size_t)tile_rows(b) * o * sizeof(float) + (size_t)o * kTileK;
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int node_apply_q8_t_bwd(const void* dpre, const void* wq, const void* scale, void* dhh,
                                   int n, int b, int ki, int o, void* stream) {
  if (n == 0 || b == 0 || ki == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(b, o);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        node_apply_q8_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)n, (unsigned)((ki + kTileK - 1) / kTileK));
  node_apply_q8_t_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dpre), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(dhh), b, ki, o, tile_rows(b));
  return (int)cudaGetLastError();
}
