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
// tile); the block stages the node's hh rows (as f32) and its int8 weight
// tile (KI x 64, 20 KB at the gate) in shared memory once, then each thread
// keeps R=4 output rows of one column in registers across the KI loop, so
// each weight byte read from shared memory feeds 4 FMAs. The weights are
// read from device memory exactly once. Tensor cores and TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileO = 64;                    // output columns per block
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kTileO;    // row groups per block
constexpr int kRows = 4;                      // rows per thread per pass
constexpr int kRowPad = kGroups * kRows;      // hh rows are padded to this

__global__ void __launch_bounds__(kThreads)
node_apply_q8_kernel(const __nv_bfloat16* __restrict__ hh, const int8_t* __restrict__ wq,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int B, int KI, int O, int B_pad) {
  extern __shared__ float smem[];
  float* hs = smem;                                                      // B_pad x KI
  int8_t* ws = reinterpret_cast<int8_t*>(smem + (size_t)B_pad * KI);    // KI x kTileO

  const int n = blockIdx.x;
  const int o0 = blockIdx.y * kTileO;
  const int tid = threadIdx.x;

  const __nv_bfloat16* hn = hh + (size_t)n * B * KI;
  for (int i = tid; i < B_pad * KI; i += kThreads)
    hs[i] = i < B * KI ? __bfloat162float(hn[i]) : 0.f;
  const int8_t* wn = wq + (size_t)n * KI * O;
  for (int i = tid; i < KI * kTileO; i += kThreads) {
    const int k = i / kTileO, c = i - k * kTileO;
    ws[i] = (o0 + c < O) ? wn[(size_t)k * O + o0 + c] : (int8_t)0;
  }
  __syncthreads();

  const int c = tid % kTileO;
  const int g = tid / kTileO;
  const int o = o0 + c;
  const float s = o < O ? scale[(size_t)n * O + o] : 0.f;
  // rows b0, b0 + kGroups, ..., b0 + (kRows-1)*kGroups; rows >= B read the
  // zero padding of hs and are not stored
  for (int b0 = g; b0 < B; b0 += kRowPad) {
    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
    const float* h0 = hs + (size_t)b0 * KI;
    for (int k = 0; k < KI; ++k) {
      const float w = (float)ws[k * kTileO + c];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = fmaf(h0[j * kGroups * KI + k], w, acc[j]);
    }
    if (o < O) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int b = b0 + j * kGroups;
        if (b < B) out[((size_t)n * B + b) * O + o] = acc[j] * s;
      }
    }
  }
}

}  // namespace

extern "C" size_t node_apply_q8_smem_bytes(int b, int ki) {
  const int b_pad = (b + kRowPad - 1) / kRowPad * kRowPad;
  return (size_t)b_pad * ki * sizeof(float) + (size_t)ki * kTileO;
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int node_apply_q8_fwd(const void* hh, const void* wq, const void* scale, void* out,
                                 int n, int b, int ki, int o, void* stream) {
  if (n == 0 || b == 0 || o == 0) return (int)cudaSuccess;
  const int b_pad = (b + kRowPad - 1) / kRowPad * kRowPad;
  const size_t smem = node_apply_q8_smem_bytes(b, ki);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        node_apply_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)n, (unsigned)((o + kTileO - 1) / kTileO));
  node_apply_q8_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(hh), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(out), b, ki, o, b_pad);
  return (int)cudaGetLastError();
}
