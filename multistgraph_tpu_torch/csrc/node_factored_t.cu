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
// contraction whose A operand q is never in device memory.
//
// Bound on an H100: operations, the same 6.21 GFLOP as B1 at the flagship
// gate (B=16, N=237, K=5, I=64, D=20, O=128): 92.7 us on the f32 CUDA cores,
// 6.3 us on the bf16 tensor cores, against ~11 MB of operands (3.4 us at
// 3.35 TB/s).
//
// bf16 operands: tensor cores (wgmma m64nNk16 with A from registers). A
// block of 64 WG rows and N = 64 KG columns (KG values of k at one 64-wide
// block of i) has WG consumer warpgroups and one producer warp. Each
// consumer thread loads its two rows' dpre once, as A fragments for every
// k16 slice of O (register A's places), and for each d multiplies them by
// its rows' e[n,d] in bf16 (__hmul2: the exact product rounded once, the
// Pallas rounding of q), a chunk's four k16 slices before the fence that
// hands them to the tensor cores. The
// producer streams pool_t in K = 64 chunks (64 o of one d by KG k by 64 i)
// through a ring of four stages handed over by mbarriers: by TMA from a 4-d
// view (I, O, D, K) under the 128-byte swizzle, which lands the chunk as
// MN-major B and fills o past O with zeros, so each d's contraction is
// padded on its own and never meets the next d's rows; where I % 8 != 0 (no
// 16-byte rows) by element loads into the same layout. The k16 slices past
// O are issued on zeros. Each chunk's products go out while the previous
// chunk's finish, whose stage is then released. The epilogue rounds once to
// dhh's type and leaves through a per-warp staging area, one k at a time, as
// 16-byte stores along I where I allows them. The tile (rows x KG) is the
// one whose busiest SM has the least work, counting each block's forming
// of q. A view that the shape allows and
// cuTensorMapEncodeTiled refuses (an operand that is not 16-byte aligned) is
// a launch error. node_factored_t_bwd_tile plants a fault (d = 0 dropped,
// the contraction's last k16 slice dropped) for checks that must catch one.
// What holds it back on an H100 (PERF.md): 32 / 21 us at the flagship gate
// and update against 6.3 / 3.1 us of tensor-core time; 90 blocks of the
// 128x2 tile fill 90 of the 132 SMs, each walking its 40 (20) chunks in
// order with two in flight. Letting the first product reset the sums
// instead of zeroing them cleared ptxas's wgmma-serialization note (C7515)
// and ran no faster.
//
// f32 operands: plain f32 FMAs (tensor cores would take them in TF32): one
// block per 64 rows x 64 columns of (k,i), 256 threads with 4x4 outputs
// each; for each d the block forms its rows' q tile in shared memory (f32,
// transposed), then streams pool_t's rows of that d through shared memory
// in 32-row chunks, 4 columns a load where I is a multiple of 4, two
// 16-byte shared-memory reads per 16 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_sm90.cuh"

namespace {

constexpr int kTileM = 64;               // rows (b,n) per block
constexpr int kTileN = 64;               // output columns (k,i) per block
constexpr int kChunk = 32;               // contraction rows of pool_t staged at a time
constexpr int kThreads = 256;            // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kTileM + 4;          // row stride of the transposed q tile

// 4 consecutive elements (16 aligned bytes)
__device__ __forceinline__ void load4(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename U>
__global__ void __launch_bounds__(kThreads)
node_factored_t_kernel(const float* __restrict__ dpre, const float* __restrict__ e, const float* __restrict__ pool_t,
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
      if (m < M) v = e[(size_t)(m % N) * D + d] * dpre[(size_t)m * O + o];
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
            v = pool_t[((size_t)k * DO + (size_t)d * O + o0 + oo) * I + i];
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

template <typename U>
cudaError_t launch(const void* dpre, const void* e, const void* pool_t, void* dhh, int b, int k, int n,
                   int i, int d, int o, cudaStream_t stream) {
  const size_t smem = ((size_t)o * kLd + kChunk * kTileN) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(node_factored_t_kernel<U>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((b * n + kTileM - 1) / kTileM), (unsigned)((k * i + kTileN - 1) / kTileN));
  node_factored_t_kernel<U><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(dpre), static_cast<const float*>(e), static_cast<const float*>(pool_t),
      static_cast<U*>(dhh), b, k, n, i, d, o);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 operands: tensor cores

using namespace wgmma_sm90;
using bf16 = __nv_bfloat16;

constexpr size_t kMaxSmem = 227 * 1024;   // shared memory one block may use on an H100
constexpr int kOc = 64;                   // contraction rows (o of one d) of one ring stage
constexpr int kStages = 4;
constexpr int kStageLd = 64 + 8;          // staged output row stride: conflict-free pair writes
constexpr int kMaxO = 256;                // dpre fragments of 16 k16 slices in registers at most
constexpr int kFaultD = 1;                // the d = 0 term dropped
constexpr int kFaultK16 = 2;              // the last k16 slice of the contraction dropped

template <int WG, int KG, typename OutT>
constexpr size_t t_smem_bytes() {
  return 1024 + (size_t)kStages * kOc * 64 * KG * sizeof(bf16) + (size_t)WG * 4 * 16 * kStageLd * sizeof(OutT) +
         2 * kStages * sizeof(uint64_t);
}

__device__ __forceinline__ void put_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void put_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// dhh for rows m0 .. m0 + 64 WG (m0 = 64 WG blockIdx.x) and the columns
// (k, i) of k-group kg = blockIdx.y / IB, i-block ib = blockIdx.y % IB: k =
// KG kg + 0..KG-1, i = 64 ib + 0..63. OS: the k16 slices of O the dpre
// fragments hold (8 or 16). pool_map: the 4-d view (I, O, D, K) of pool_t
// whose box (64 i, 64 o, 1 d, KG k) lands a stage, where tma (I % 8 == 0).
template <int WG, int KG, int OS, typename OutT>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
node_factored_t_wgmma_kernel(const __grid_constant__ CUtensorMap pool_map, int tma, const bf16* __restrict__ dpre,
                             const bf16* __restrict__ e, const bf16* __restrict__ pool_t, OutT* __restrict__ dhh,
                             int B, int K, int N, int I, int D, int O, int fault) {
  constexpr int BN = 64 * KG;                   // the wgmma's N
  constexpr int kConsumers = WG * 128;
  constexpr int kChunkElems = kOc * BN;              // elements of one stage
  constexpr int kVec = 16 / sizeof(OutT);       // outputs of one 16-byte store
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* ps = reinterpret_cast<bf16*>(smem);                                     // kStages chunks
  OutT* staged = reinterpret_cast<OutT*>(ps + (size_t)kStages * kChunkElems);        // 16 x kStageLd a consumer warp
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + (size_t)kConsumers / 32 * 16 * kStageLd);
  uint64_t* empty = full + kStages;

  const int M = B * N, IB = (I + 63) / 64, OC = (O + kOc - 1) / kOc;
  const int m0 = blockIdx.x * 64 * WG;
  const int k0 = (blockIdx.y / IB) * KG, i0 = (blockIdx.y % IB) * 64;
  const int total = D * OC;                     // chunks: (d, 64 o) in order
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, WG);               // one arrival per consumer warpgroup
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: chunk g holds pool_t rows d O + 64 oc .. (d = g / OC, oc
    // = g % OC) of k0 .. k0 + KG at i0 .. i0 + 64; zero past O, K and I
    const int lane = tid - kConsumers;
    const bf16 zero = __float2bfloat16(0.f);
    for (int g = 0; g < total; ++g) {
      const int st = g % kStages, d = g / OC, oc = g % OC;
      if (g >= kStages) mbar_wait(empty + st, ((g / kStages) & 1) ^ 1);
      bf16* dst = ps + (size_t)st * kChunkElems;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_tx(full + st, kChunkElems * (unsigned)sizeof(bf16));
          tma_load_4d(dst, &pool_map, i0, oc * kOc, d, k0, full + st);
        }
      } else {
        // element (o, c) of the chunk at its swizzled place: column block
        // c / 64 (one k) 8 KB apart, rows of 64 i
        unsigned char* b = reinterpret_cast<unsigned char*>(dst);
        for (int q = lane; q < kChunkElems; q += 32) {
          const int o = q / BN, c = q - o * BN;
          const int k = k0 + c / 64, i = i0 + c % 64, oo = oc * kOc + o;
          *reinterpret_cast<bf16*>(b + (c / 64) * 8192 + sw128(o * 128 + (c % 64) * 2)) =
              oo < O && i < I && k < K ? pool_t[(((size_t)k * D + d) * O + oo) * I + i] : zero;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + st);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg ..; this thread rows r[0],
  // r[1] = 16 warp + lane / 4 (+ 8) of them
  // (broadcast from lane 0, so that the compiler knows them uniform in the warp)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), warp = __shfl_sync(0xffffffffu, tid % 128 / 32, 0);
  const int lane = tid % 32;
  int r[2], erow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r[h] = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
    erow[h] = r[h] < M ? (r[h] % N) * D : -1;
  }
  // dpre as A fragments: a[s][v] holds row r[v % 2], o = 16 s + 2 (lane % 4)
  // + 8 (v / 2) + 0..1 (zero past O and M)
  uint32_t a[OS][4];
#pragma unroll
  for (int s = 0; s < OS; ++s)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int row = r[v % 2], o = 16 * s + 2 * (lane % 4) + 8 * (v / 2);
      const bf16 zero = __float2bfloat16(0.f);
      const bf16 lo = row < M && o < O ? dpre[(size_t)row * O + o] : zero;
      const bf16 hi = row < M && o + 1 < O ? dpre[(size_t)row * O + o + 1] : zero;
      __nv_bfloat162 pair = __halves2bfloat162(lo, hi);
      a[s][v] = *reinterpret_cast<uint32_t*>(&pair);
    }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int g = 0;
  for (int d = 0; d < D; ++d) {
    // q = bf16(e[n,d] dpre) of this thread's rows, formed per k16 slice
    const bf16 zero = __float2bfloat16(0.f);
    const __nv_bfloat162 e0 = __bfloat162bfloat162(erow[0] >= 0 ? e[erow[0] + d] : zero);
    const __nv_bfloat162 e1 = __bfloat162bfloat162(erow[1] >= 0 ? e[erow[1] + d] : zero);
#pragma unroll
    for (int oc = 0; oc < OS / 4; ++oc) {
      if (oc >= OC) break;
      const int st = g % kStages;
      mbar_wait(full + st, (g / kStages) & 1);
      const unsigned char* b = reinterpret_cast<const unsigned char*>(ps + (size_t)st * kChunkElems);
      // the chunk's four k16 slices of q, formed before the fence that hands
      // them to the tensor cores (slices past O are zero on both sides); a
      // planted fault zeroes the slices it drops
      const int last = min(kOc, O - oc * kOc + 15) / 16 - 1;   // the last slice holding part of O
      uint32_t q[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const bool dropped = (fault == kFaultD && d == 0) || (fault == kFaultK16 && g == total - 1 && ks == last);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a[4 * oc + ks][v]), v % 2 ? e1 : e0);
          q[ks][v] = dropped ? 0u : *reinterpret_cast<uint32_t*>(&p);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) Wgmma<BN>::template mma_rs<1>(acc, q[ks], desc_sw128(b + 2048 * ks, 8192u), 1);
      wgmma_commit();
      if (g > 0) {
        wgmma_wait<1>();   // the previous chunk's products are done: free its stage
        if (tid % 128 == 0) mbar_arrive(empty + (g - 1) % kStages);
      }
      ++g;
    }
  }
  wgmma_wait<0>();
  if (g > 0 && tid % 128 == 0) mbar_arrive(empty + (g - 1) % kStages);

  // the warp's 16 rows through its staging, one k at a time (acc[4 (8 kk +
  // j) + v] is row lane / 4 + 8 (v / 2), i = 8 j + 2 (lane % 4) + v % 2 of
  // k0 + kk), stored along I in 16-byte units where I % kVec == 0
  OutT* stage = staged + (size_t)(tid / 32) * 16 * kStageLd;
  const int width = min(64, I - i0);
  const int row0 = m0 + 64 * wg + 16 * warp;
#pragma unroll
  for (int kk = 0; kk < KG; ++kk) {
    const int k = k0 + kk;
    if (k >= K) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4), x = 4 * (8 * kk + j);
      put_pair(stage + (lane / 4) * kStageLd + col, acc[x], acc[x + 1]);
      put_pair(stage + (lane / 4 + 8) * kStageLd + col, acc[x + 2], acc[x + 3]);
    }
    __syncwarp();
    for (int q = lane; q < 16 * (64 / kVec); q += 32) {
      const int i = q / (64 / kVec), c = (q % (64 / kVec)) * kVec, m = row0 + i;
      if (m >= M || c >= width) continue;
      const int bb = m / N, n = m - bb * N;
      OutT* dst = dhh + (((size_t)bb * K + k) * N + n) * I + i0 + c;
      const OutT* src = stage + i * kStageLd + c;
      if (I % kVec == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int u = 0; u < kVec && c + u < width; ++u) dst[u] = src[u];
      }
    }
    __syncwarp();   // the staging is read before the next k writes it
  }
}

template <int WG, int KG, int OS, typename OutT>
cudaError_t launch_wgmma(const void* dpre, const void* e, const void* pool_t, void* dhh, int b, int k, int n,
                         int i, int d, int o, int fault, cudaStream_t stream) {
  auto kernel = node_factored_t_wgmma_kernel<WG, KG, OS, OutT>;
  constexpr size_t smem = t_smem_bytes<WG, KG, OutT>();
  static_assert(smem <= kMaxSmem, "a B1t tile exceeds a block's shared memory");
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // pool_t by TMA where its rows of I are whole 16-byte units, else by the
  // producer's element loads; a view that the shape allows and
  // cuTensorMapEncodeTiled refuses is an error
  CUtensorMap map = {};
  const int tma = i % 8 == 0;
  if (tma) {
    const cuuint64_t dims[4] = {(cuuint64_t)i, (cuuint64_t)o, (cuuint64_t)d, (cuuint64_t)k};
    const cuuint64_t strides[3] = {(cuuint64_t)i * 2, (cuuint64_t)o * i * 2, (cuuint64_t)d * o * i * 2};
    const cuuint32_t box[4] = {64, kOc, 1, KG};
    err = encode_tiled<4>(&map, pool_t, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((b * n + 64 * WG - 1) / (64 * WG)), (unsigned)((k + KG - 1) / KG * ((i + 63) / 64)));
  kernel<<<grid, WG * 128 + 32, smem, stream>>>(map, tma, static_cast<const bf16*>(dpre),
                                                  static_cast<const bf16*>(e), static_cast<const bf16*>(pool_t),
                                                  static_cast<OutT*>(dhh), b, k, n, i, d, o, fault);
  return cudaGetLastError();
}

// tiles (rows x KG): 0: 128 x 2, 1: 128 x 1, 2: 64 x 2, 3: 64 x 1
constexpr int kTiles = 4;
constexpr int kTileRows[kTiles] = {128, 128, 64, 64}, kTileKG[kTiles] = {2, 1, 2, 1};

template <int OS, typename OutT>
cudaError_t launch_tile(int tile, const void* dpre, const void* e, const void* pool_t, void* dhh, int b, int k, int n,
                        int i, int d, int o, int fault, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_wgmma<2, 2, OS, OutT>(dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s);
    case 1: return launch_wgmma<2, 1, OS, OutT>(dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s);
    case 2: return launch_wgmma<1, 2, OS, OutT>(dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s);
    case 3: return launch_wgmma<1, 1, OS, OutT>(dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s);
    default: return cudaErrorInvalidValue;
  }
}

// The tile whose busiest SM has the least work: (blocks per SM, rounded
// up) x rows x (columns + 64), a block's forming of q counted as 64 columns
// of products (on an H100 at the flagship cells, 64x1 tiles ran 5% behind
// 64x2 and 128x2, which the count without it had put first); of equals,
// the earliest.
int choose_tile(int m, int k, int i) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                 cudaSuccess)
    sms = 132;
  int best = 0;
  long best_work = -1;
  for (int tile = 0; tile < kTiles; ++tile) {
    const long blocks = (long)((m + kTileRows[tile] - 1) / kTileRows[tile]) *
                        ((k + kTileKG[tile] - 1) / kTileKG[tile]) * ((i + 63) / 64);
    const long work = (blocks + sms - 1) / sms * kTileRows[tile] * (64 * kTileKG[tile] + 64);
    if (best_work < 0 || work < best_work) best = tile, best_work = work;
  }
  return best;
}

cudaError_t launch_bf16(const void* dpre, const void* e, const void* pool_t, void* dhh, int b, int k, int n, int i,
                        int d, int o, int bf16_out, int tile, int fault, cudaStream_t s) {
  if (o > kMaxO || tile >= kTiles) return cudaErrorInvalidValue;
  if (tile < 0) tile = choose_tile(b * n, k, i);
  if (o <= 128)
    return bf16_out ? launch_tile<8, bf16>(tile, dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s)
                    : launch_tile<8, float>(tile, dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s);
  return bf16_out ? launch_tile<16, bf16>(tile, dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s)
                  : launch_tile<16, float>(tile, dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s);
}

}  // namespace

// The bf16 kernel's tile for these dimensions (0: 128 x 2, 1: 128 x 1, 2:
// 64 x 2, 3: 64 x 1, rows x k a block).
extern "C" int node_factored_t_tile(int b, int k, int n, int i) { return choose_tile(b * n, k, i); }

// As node_factored_t_bwd, with the bf16 kernel's tile given (-1: chosen
// from the grid) and a fault planted in it (0: none, 1: the d = 0 term
// dropped, 2: the contraction's last k16 slice dropped); f32 operands take
// neither.
extern "C" int node_factored_t_bwd_tile(const void* dpre, const void* e, const void* pool_t, void* dhh, int b,
                                        int k, int n, int i, int d, int o, int bf16_in, int bf16_out, int tile,
                                        int fault, void* stream) {
  if (b == 0 || n == 0 || k == 0 || i == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_in) return (int)launch_bf16(dpre, e, pool_t, dhh, b, k, n, i, d, o, bf16_out, tile, fault, st);
  if (tile > 0 || fault) return (int)cudaErrorInvalidValue;
  return (int)(bf16_out ? launch<__nv_bfloat16>(dpre, e, pool_t, dhh, b, k, n, i, d, o, st)
                        : launch<float>(dpre, e, pool_t, dhh, b, k, n, i, d, o, st));
}

// Launches on `stream`; returns cudaGetLastError() after the launch, or the
// error of pool_t's TMA view where the bf16 kernel takes one (I % 8 == 0)
// and it cannot be encoded. bf16_in: dpre, e and pool_t are bf16 (else
// f32); bf16_out: dhh is bf16 (else f32). bf16 operands take O <= 256.
extern "C" int node_factored_t_bwd(const void* dpre, const void* e, const void* pool_t, void* dhh,
                                   int b, int k, int n, int i, int d, int o, int bf16_in, int bf16_out,
                                   void* stream) {
  return node_factored_t_bwd_tile(dpre, e, pool_t, dhh, b, k, n, i, d, o, bf16_in, bf16_out, -1, 0, stream);
}
