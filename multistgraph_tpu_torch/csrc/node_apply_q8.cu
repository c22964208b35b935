// int8 node-conditioned weight apply for Hopper (sm_90a).
//
//   out[n,b,o] = (sum_ki hh[n,b,ki] * wq[n,ki,o]) * scale[n,0,o]
//
// hh (N,B,KI) bf16, wq (Nw,KI,O) int8 with Nw >= N (rows past N are never
// read), scale (Nw,1,O) f32, out (N,B,O) f32; all contiguous.
//
// Replaces the Pallas kernel multistgraph_tpu/ops/node_apply.py:
// _apply_q8_kernel / node_apply_q8. The per-(n,o) scale commutes with the
// (k,i) contraction, so one multiply after the f32 dot gives exact
// dequantized math. int8 and bf16 are widened to f32 in registers.
//
// Bound on an H100: bytes. At the flagship gate (N=237, B=16, KI=320,
// O=128) the call moves 14.2 MB (the int8 weights are 9.7 MB of it) for
// 0.31 GFLOP, 4.2 us at 3.35 TB/s against 0.3 us of bf16 tensor-core time.
// This first design is plain and right: one block per (node, 64-column
// tile); the block stages the node's int8 weight tile (KI x 64, 20 KB at
// the gate) in shared memory once, then walks the batch in tiles of hh
// rows staged as f32: the batch rounded up to 16 rows, at most 32 (20 or
// 40 KB at KI=320), so shared memory does not grow with B and any batch
// runs, while a batch of up to 16 stages no more rows than one pass. Each
// thread keeps R=4 output rows of one column in registers across the KI
// loop, so each weight byte read from shared memory feeds 4 FMAs. The
// weights are read from device memory exactly once. Tensor cores and TMA
// come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileO = 64;                    // output columns per block
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kTileO;    // row groups per block
constexpr int kRows = 4;                      // rows per thread per pass
constexpr int kRowPad = kGroups * kRows;      // rows per pass
constexpr int kMaxTileB = 2 * kRowPad;        // hh rows staged at a time, at most

__global__ void __launch_bounds__(kThreads)
node_apply_q8_kernel(const __nv_bfloat16* __restrict__ hh, const int8_t* __restrict__ wq,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int B, int KI, int O, int tile_b) {
  extern __shared__ float smem[];
  float* hs = smem;                                                      // tile_b x KI
  int8_t* ws = reinterpret_cast<int8_t*>(smem + (size_t)tile_b * KI);   // KI x kTileO

  const int n = blockIdx.x;
  const int o0 = blockIdx.y * kTileO;
  const int tid = threadIdx.x;

  const int8_t* wn = wq + (size_t)n * KI * O;
  for (int i = tid; i < KI * kTileO; i += kThreads) {
    const int k = i / kTileO, c = i - k * kTileO;
    ws[i] = (o0 + c < O) ? wn[(size_t)k * O + o0 + c] : (int8_t)0;
  }

  const int c = tid % kTileO;
  const int g = tid / kTileO;
  const int o = o0 + c;
  const float s = o < O ? scale[(size_t)n * O + o] : 0.f;
  const __nv_bfloat16* hn = hh + (size_t)n * B * KI;
  float* on = out + (size_t)n * B * O;
  for (int bt = 0; bt < B; bt += tile_b) {
    const int rows = min(tile_b, B - bt);
    __syncthreads();  // the previous tile is no longer read (and ws is staged)
    const __nv_bfloat16* ht = hn + (size_t)bt * KI;
    for (int i = tid; i < tile_b * KI; i += kThreads)
      hs[i] = i < rows * KI ? __bfloat162float(ht[i]) : 0.f;
    __syncthreads();
    // rows r0, r0 + kGroups, ..., r0 + (kRows-1)*kGroups of the tile; rows
    // >= `rows` read the zero padding of hs and are not stored
    for (int r0 = g; r0 < rows; r0 += kRowPad) {
      float acc[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
      const float* h0 = hs + (size_t)r0 * KI;
      for (int k = 0; k < KI; ++k) {
        const float w = (float)ws[k * kTileO + c];
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc[j] = fmaf(h0[j * kGroups * KI + k], w, acc[j]);
      }
      if (o < O) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int r = r0 + j * kGroups;
          if (r < rows) on[(size_t)(bt + r) * O + o] = acc[j] * s;
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

static size_t smem_bytes(int b, int ki) {
  return (size_t)tile_rows(b) * ki * sizeof(float) + (size_t)ki * kTileO;
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int node_apply_q8_fwd(const void* hh, const void* wq, const void* scale, void* out,
                                 int n, int b, int ki, int o, void* stream) {
  if (n == 0 || b == 0 || o == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(b, ki);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        node_apply_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)n, (unsigned)((o + kTileO - 1) / kTileO));
  node_apply_q8_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(hh), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(out), b, ki, o, tile_rows(b));
  return (int)cudaGetLastError();
}
