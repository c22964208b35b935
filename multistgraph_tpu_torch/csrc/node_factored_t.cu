// Transposed factored node apply for Hopper (sm_90a): kernel B1t.
//
//   dhh[b,k,n,i] = out_type( sum_{d,o} q[(b,n),(d,o)] * pool_t[k, d*O+o, i] ),
//   q[(b,n),(d,o)] = T(e[n,d] * dpre[b,n,o])
//
// dpre (B,N,O), e (N,D) and pool_t (K,D*O,I) all of one type T (f32 or
// bf16), dhh (B,K,N,I) f32 or bf16; all contiguous. q is rounded to T, as
// the Pallas kernel forms it in dpre's dtype; the dot sums in f32.
//
// Replaces the Pallas kernel multistgraph_tpu/ops/node_apply.py:
// _apply_t_kernel / node_factored_apply_t, the input cotangent of B1
// (node_factored.cu). One GEMM with M = B*N rows, K*I columns and a D*O
// contraction: for each d the block forms its rows' q tile in shared memory
// (f32, transposed, never in device memory), then streams pool_t's rows of
// that d through shared memory in 32-row chunks against it.
//
// Bound on an H100: operations, the same 6.21 GFLOP as B1 at the flagship
// gate (92.7 us on the f32 CUDA cores against ~11 MB of operands, 3.4 us at
// 3.35 TB/s). This first design is plain f32 FMAs: one block per 64 rows x
// 64 columns of (k,i), 256 threads with 4x4 outputs each, two 16-byte
// shared-memory reads per 16 FMAs; pool_t's chunks load 4 columns at a
// time where I is a multiple of 4. The rows' cotangent is read once per d
// (from L1/L2). Tensor cores and TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;               // rows (b,n) per block
constexpr int kTileN = 64;               // output columns (k,i) per block
constexpr int kChunk = 32;               // contraction rows of pool_t staged at a time
constexpr int kThreads = 256;            // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kTileM + 4;          // row stride of the transposed q tile

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
// 4 consecutive elements (16 or 8 aligned bytes) widened to f32
__device__ __forceinline__ void load4(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float* dst) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
}
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, typename U>
__global__ void __launch_bounds__(kThreads)
node_factored_t_kernel(const T* __restrict__ dpre, const T* __restrict__ e, const T* __restrict__ pool_t,
                       U* __restrict__ dhh, int B, int K, int N, int I, int D, int O) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                  // O x kLd: qs[o][r] = q of row r for one d
  float* ps = qs + (size_t)O * kLd;                  // kChunk x kTileN chunk of pool_t
  const int M = B * N;
  const int KI = K * I;
  const int DO = D * O;

  const int m0 = blockIdx.x * kTileM;
  const int c0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[j][l] = 0.f;

  for (int d = 0; d < D; ++d) {
    __syncthreads();  // the previous d's q tile is no longer read
    for (int q = tid; q < kTileM * O; q += kThreads) {
      const int r = q / O, o = q - r * O;
      const int m = m0 + r;
      float v = 0.f;
      if (m < M) v = round_to(widen(e[(size_t)(m % N) * D + d]) * widen(dpre[(size_t)m * O + o]), T());
      qs[(size_t)o * kLd + r] = v;
    }
    for (int o0 = 0; o0 < O; o0 += kChunk) {
      __syncthreads();  // the previous chunk is no longer read (and qs is formed)
      if (I % 4 == 0) {  // 4 columns of one k a load, aligned
        for (int q = tid; q < kChunk * kTileN / 4; q += kThreads) {
          const int oo = q / (kTileN / 4), c = 4 * (q - oo * (kTileN / 4));
          const int col = c0 + c;
          float* dst = ps + oo * kTileN + c;
          if (o0 + oo < O && col < KI) {
            const int k = col / I, i = col - k * I;
            load4(pool_t + ((size_t)k * DO + (size_t)d * O + o0 + oo) * I + i, dst);
          } else {
            dst[0] = dst[1] = dst[2] = dst[3] = 0.f;
          }
        }
      } else {
        for (int q = tid; q < kChunk * kTileN; q += kThreads) {
          const int oo = q / kTileN, c = q - oo * kTileN;
          const int col = c0 + c;
          float v = 0.f;
          if (o0 + oo < O && col < KI) {
            const int k = col / I, i = col - k * I;
            v = widen(pool_t[((size_t)k * DO + (size_t)d * O + o0 + oo) * I + i]);
          }
          ps[q] = v;
        }
      }
      __syncthreads();
      const int on = min(kChunk, O - o0);
      for (int oo = 0; oo < on; ++oo) {
        const float4 a = *reinterpret_cast<const float4*>(qs + (size_t)(o0 + oo) * kLd + ty * 4);
        const float4 w = *reinterpret_cast<const float4*>(ps + oo * kTileN + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int l = 0; l < 4; ++l) acc[j][l] = fmaf(av[j], wv[l], acc[j][l]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + ty * 4 + j;
    if (m >= M) continue;
    const int b = m / N, n = m - b * N;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int col = c0 + tx * 4 + l;
      if (col >= KI) continue;
      const int k = col / I, i = col - k * I;
      put(dhh + (((size_t)b * K + k) * N + n) * I + i, acc[j][l]);
    }
  }
}

template <typename T, typename U>
cudaError_t launch(const void* dpre, const void* e, const void* pool_t, void* dhh, int b, int k, int n,
                   int i, int d, int o, cudaStream_t stream) {
  const size_t smem = ((size_t)o * kLd + kChunk * kTileN) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(node_factored_t_kernel<T, U>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((b * n + kTileM - 1) / kTileM), (unsigned)((k * i + kTileN - 1) / kTileN));
  node_factored_t_kernel<T, U><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(dpre), static_cast<const T*>(e), static_cast<const T*>(pool_t),
      static_cast<U*>(dhh), b, k, n, i, d, o);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
// bf16_in: dpre, e and pool_t are bf16 (else f32); bf16_out: dhh is bf16
// (else f32).
extern "C" int node_factored_t_bwd(const void* dpre, const void* e, const void* pool_t, void* dhh,
                                   int b, int k, int n, int i, int d, int o, int bf16_in, int bf16_out,
                                   void* stream) {
  if (b == 0 || n == 0 || k == 0 || i == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16_in) {
    err = bf16_out ? launch<__nv_bfloat16, __nv_bfloat16>(dpre, e, pool_t, dhh, b, k, n, i, d, o, st)
                   : launch<__nv_bfloat16, float>(dpre, e, pool_t, dhh, b, k, n, i, d, o, st);
  } else {
    err = bf16_out ? launch<float, __nv_bfloat16>(dpre, e, pool_t, dhh, b, k, n, i, d, o, st)
                   : launch<float, float>(dpre, e, pool_t, dhh, b, k, n, i, d, o, st);
  }
  return (int)err;
}
