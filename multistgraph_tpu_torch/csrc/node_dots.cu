// Per-node dots over T steps for Hopper (sm_90a): kernel B11 A.
//
//   out[b, n*O + o] = bf16( sum_ki hh[t, b, n*KI + ki] * w[n, ki, o] + *s )   for t = 0 .. T-1
//
// hh (T,B,NP*KI) bf16, w (NP,KI,O) bf16, s one f32 on the device, out
// (B,NP*O) bf16; all contiguous. Every step overwrites out, so the last
// step's result stays, as in the TPU grid that revisits the output block
// at every t.
//
// Replaces the Pallas kernel tools/bench_node_dots.py: _a_kernel / make_a,
// variant A of the node-apply design harness: the expanded per-node weights
// streamed at every step of the recurrence, against B = 16 rows per node.
//
// Bound on an H100: bytes. At the harness shapes (T=24, B=16, NP=256,
// KI=320, O=192) the distinct inputs are 94.4 MB (62.9 MB of activations,
// 31.5 MB of weights), 28 us at 3.35 TB/s, against 12.1 GFLOP (12 us on
// bf16 tensor cores). The weights fit in the 50 MB L2, so after the first
// step every step rereads them from L2, not device memory. This first
// design is plain f32 FMAs: one block per (node, 64-column tile); at each
// step the block stages the node's weight tile (KI x 64, widened to f32)
// and its activation rows (the batch in tiles of at most 16 rows) in shared
// memory, 16 bytes a load where O and KI are multiples of 8, and each of
// 256 threads keeps 4 rows of one column in registers across the KI loop.
// Tensor cores and TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileO = 64;                    // output columns per block
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kTileO;    // row groups per block
constexpr int kRows = 4;                      // rows per thread per pass
constexpr int kTileB = kGroups * kRows;       // activation rows staged at a time

// 8 bf16 (16 aligned bytes) widened to f32
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const float2 f = __bfloat1622float2(p[l]);
    dst[2 * l] = f.x;
    dst[2 * l + 1] = f.y;
  }
}

__global__ void __launch_bounds__(kThreads)
node_dots_kernel(const __nv_bfloat16* __restrict__ hh, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                 int T, int B, int NP, int KI, int O) {
  extern __shared__ float smem[];
  float* ws = smem;                                  // KI x kTileO
  float* hs = smem + (size_t)KI * kTileO;            // kTileB x KI

  const int n = blockIdx.x;
  const int o0 = blockIdx.y * kTileO;
  const int tid = threadIdx.x;
  const int c = tid % kTileO;
  const int g = tid / kTileO;
  const int o = o0 + c;
  const float sv = *s;
  const __nv_bfloat16* wn = w + (size_t)n * KI * O;
  // 16-byte loads need rows that start on 16 bytes: O and KI multiples of 8
  const bool vec_w = O % 8 == 0, vec_h = KI % 8 == 0;

  for (int t = 0; t < T; ++t) {
    __syncthreads();  // the previous step no longer reads ws
    // the step's weight stream: the node's tile, rows of O contiguous, 8
    // columns (16 bytes) a load where the rows allow it
    if (vec_w) {
      for (int i = tid; i < KI * (kTileO / 8); i += kThreads) {
        const int k = i / (kTileO / 8), c8 = 8 * (i - k * (kTileO / 8));
        if (o0 + c8 < O) {
          load8(wn + (size_t)k * O + o0 + c8, ws + k * kTileO + c8);
        } else {
#pragma unroll
          for (int l = 0; l < 8; ++l) ws[k * kTileO + c8 + l] = 0.f;
        }
      }
    } else {
      for (int i = tid; i < KI * kTileO; i += kThreads) {
        const int k = i / kTileO, cc = i - k * kTileO;
        ws[i] = (o0 + cc < O) ? __bfloat162float(wn[(size_t)k * O + o0 + cc]) : 0.f;
      }
    }
    const __nv_bfloat16* ht = hh + (size_t)t * B * NP * KI + (size_t)n * KI;
    for (int bt = 0; bt < B; bt += kTileB) {
      const int rows = min(kTileB, B - bt);
      __syncthreads();  // the previous row tile is no longer read (and ws is staged)
      if (vec_h) {
        for (int i = tid; i < kTileB * (KI / 8); i += kThreads) {
          const int r = i / (KI / 8), k8 = 8 * (i - r * (KI / 8));
          if (r < rows) {
            load8(ht + (size_t)(bt + r) * NP * KI + k8, hs + r * KI + k8);
          } else {
#pragma unroll
            for (int l = 0; l < 8; ++l) hs[r * KI + k8 + l] = 0.f;
          }
        }
      } else {
        for (int i = tid; i < kTileB * KI; i += kThreads) {
          const int r = i / KI, k = i - r * KI;
          hs[i] = r < rows ? __bfloat162float(ht[(size_t)(bt + r) * NP * KI + k]) : 0.f;
        }
      }
      __syncthreads();
      float acc[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
      const float* h0 = hs + (size_t)g * KI;
      for (int k = 0; k < KI; ++k) {
        const float wv = ws[k * kTileO + c];
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc[j] = fmaf(h0[(size_t)j * kGroups * KI + k], wv, acc[j]);
      }
      if (o < O) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int r = g + j * kGroups;
          if (r < rows) out[(size_t)(bt + r) * NP * O + (size_t)n * O + o] = __float2bfloat16(acc[j] + sv);
        }
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int node_dots_fwd(const void* hh, const void* w, const void* s, void* out,
                             int t, int b, int np, int ki, int o, void* stream) {
  if (t == 0 || b == 0 || np == 0 || o == 0) return (int)cudaSuccess;
  const size_t smem = ((size_t)ki * kTileO + (size_t)kTileB * ki) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(node_dots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)np, (unsigned)((o + kTileO - 1) / kTileO));
  node_dots_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(hh), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out), t, b, np, ki, o);
  return (int)cudaGetLastError();
}
