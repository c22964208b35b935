// Factored node-conditioned weight apply for Hopper (sm_90a): kernel B1.
//
//   out[t][(b,n), o] = epi( sum_d e[n,d] * sum_{k,i} hh[t][b,k,n,i] * pool[k,i,d*O+o] )
//
// hh (steps,B,K,N,I), e (N,D) f32, pool (K,I,D*O) of hh's type (f32 or
// bf16), out (B,N,O) f32, or bf16 with bf16 operands; all contiguous. epi
// adds the scalar *s (0 without one) and stores in the output's type,
// rounding once. Each of `steps` steps overwrites out, so the last step's
// result stays.
//
// Replaces two Pallas kernels that compute one product:
// multistgraph_tpu/ops/node_apply.py: _apply_kernel / node_factored_apply
// (steps=1, no scalar, f32 out) and tools/bench_node_dots.py: _b_kernel /
// make_b (B=1, K=1, N = B*NP rows with a per-row embedding, steps=T, the
// chained scalar and a bf16 store). It is one GEMM with M = B*N rows,
// O columns and a D*K*I contraction whose A operand e (x) hh is never
// formed in device memory: the block keeps its rows' activations in shared
// memory (widened to f32, transposed so a thread reads 4 rows at once) and,
// for each d, sums r_d = hh @ pool[:, d*O:(d+1)*O] over the whole (k,i)
// contraction in registers before it adds e[n,d] * r_d, the order of the
// Pallas kernel (r never leaves VMEM there, registers here).
//
// Bound on an H100: operations. At the flagship gate (B=16, N=237, K=5,
// I=64, D=20, O=128) one call is 6.21 GFLOP: 92.7 us on the f32 CUDA cores
// (67 TFLOP/s), against ~10 MB of operands (3 us at 3.35 TB/s). This first
// design is plain f32 FMAs, right before fast: one block per 64 rows x 64
// columns, 256 threads with 4x4 outputs each; the pool streams through
// shared memory in 32-row chunks of one d's columns (from L2: the pool is
// 3.3 MB in f32), 4 columns a load where O is a multiple of 4. Each inner
// step reads two 16-byte words from shared memory for 16 FMAs. Tensor
// cores (bf16 operands would round e (x) hh) and TMA pipelining come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;               // rows per block
constexpr int kTileN = 64;               // output columns per block
constexpr int kChunk = 32;               // contraction rows of the pool staged at a time
constexpr int kThreads = 256;            // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kTileM + 4;          // row stride of the transposed activations

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

template <typename T, bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
node_factored_kernel(const T* __restrict__ hh, const float* __restrict__ e, const T* __restrict__ pool,
                     const float* __restrict__ s, void* __restrict__ out,
                     int steps, int B, int K, int N, int I, int D, int O) {
  extern __shared__ __align__(16) float smem[];
  const int KI = K * I;
  const int M = B * N;
  float* hs = smem;                                  // KI x kLd: hs[kk][r] = hh of row r
  float* ps = hs + (size_t)KI * kLd;                 // kChunk x kTileN pool chunk
  float* es = ps + kChunk * kTileN;                  // kTileM x D embeddings

  const int m0 = blockIdx.x * kTileM;
  const int o0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int q = tid; q < kTileM * D; q += kThreads) {
    const int r = q / D, d = q - r * D;
    const int m = m0 + r;
    es[q] = m < M ? e[(size_t)(m % N) * D + d] : 0.f;
  }
  const float sv = s != nullptr ? *s : 0.f;
  const size_t step_elems = (size_t)M * KI;

  for (int t = 0; t < steps; ++t) {
    const T* ht = hh + (size_t)t * step_elems;
    __syncthreads();  // the previous step no longer reads hs
    for (int q = tid; q < kTileM * KI; q += kThreads) {
      const int r = q / KI, kk = q - r * KI;
      const int m = m0 + r;
      float v = 0.f;
      if (m < M) {
        const int b = m / N, n = m - b * N;
        const int k = kk / I, i = kk - k * I;
        v = widen(ht[(((size_t)b * K + k) * N + n) * I + i]);
      }
      hs[(size_t)kk * kLd + r] = v;
    }

    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[j][l] = 0.f;

    for (int d = 0; d < D; ++d) {
      float r[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int l = 0; l < 4; ++l) r[j][l] = 0.f;
      for (int k0 = 0; k0 < KI; k0 += kChunk) {
        __syncthreads();  // the previous chunk is no longer read (hs, es staged)
        if (O % 4 == 0) {  // 4 columns a load: rows and column groups start aligned
          for (int q = tid; q < kChunk * kTileN / 4; q += kThreads) {
            const int kk = q / (kTileN / 4), c = 4 * (q - kk * (kTileN / 4));
            float* dst = ps + kk * kTileN + c;
            if (k0 + kk < KI && o0 + c < O) {
              load4(pool + (size_t)(k0 + kk) * D * O + (size_t)d * O + o0 + c, dst);
            } else {
              dst[0] = dst[1] = dst[2] = dst[3] = 0.f;
            }
          }
        } else {
          for (int q = tid; q < kChunk * kTileN; q += kThreads) {
            const int kk = q / kTileN, c = q - kk * kTileN;
            const int o = o0 + c;
            ps[q] = (k0 + kk < KI && o < O) ? widen(pool[(size_t)(k0 + kk) * D * O + (size_t)d * O + o]) : 0.f;
          }
        }
        __syncthreads();
        const int kn = min(kChunk, KI - k0);
        for (int kk = 0; kk < kn; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(hs + (size_t)(k0 + kk) * kLd + ty * 4);
          const float4 w = *reinterpret_cast<const float4*>(ps + kk * kTileN + tx * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int l = 0; l < 4; ++l) r[j][l] = fmaf(av[j], wv[l], r[j][l]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ev = es[(ty * 4 + j) * D + d];
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[j][l] = fmaf(ev, r[j][l], acc[j][l]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + j;
      if (m >= M) continue;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int o = o0 + tx * 4 + l;
        if (o >= O) continue;
        const float v = acc[j][l] + sv;
        if (kBf16Out) static_cast<__nv_bfloat16*>(out)[(size_t)m * O + o] = __float2bfloat16(v);
        else static_cast<float*>(out)[(size_t)m * O + o] = v;
      }
    }
  }
}

template <typename T, bool kBf16Out>
cudaError_t launch(const void* hh, const void* e, const void* pool, const void* s, void* out, int steps,
                   int b, int k, int n, int i, int d, int o, cudaStream_t stream) {
  const size_t smem = ((size_t)k * i * kLd + kChunk * kTileN + (size_t)kTileM * d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(node_factored_kernel<T, kBf16Out>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((b * n + kTileM - 1) / kTileM), (unsigned)((o + kTileN - 1) / kTileN));
  node_factored_kernel<T, kBf16Out><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(hh), static_cast<const float*>(e), static_cast<const T*>(pool),
      static_cast<const float*>(s), out, steps, b, k, n, i, d, o);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch. `s` may
// be null (no scalar). bf16_in: hh and pool are bf16 (else f32); bf16_out:
// out is bf16 (else f32), taken only with bf16_in (the harness's rows mode).
extern "C" int node_factored_fwd(const void* hh, const void* e, const void* pool, const void* s, void* out,
                                 int steps, int b, int k, int n, int i, int d, int o,
                                 int bf16_in, int bf16_out, void* stream) {
  if (steps == 0 || b == 0 || n == 0 || o == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16_in) {
    err = bf16_out ? launch<__nv_bfloat16, true>(hh, e, pool, s, out, steps, b, k, n, i, d, o, st)
                   : launch<__nv_bfloat16, false>(hh, e, pool, s, out, steps, b, k, n, i, d, o, st);
  } else {
    if (bf16_out) return (int)cudaErrorInvalidValue;
    err = launch<float, false>(hh, e, pool, s, out, steps, b, k, n, i, d, o, st);
  }
  return (int)err;
}
