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
// formed: for each d, r_d = hh @ pool[:, d*O:(d+1)*O] is summed over the
// whole (k,i) contraction in f32 before e[n,d] * r_d is added, the order
// of the Pallas kernel (r never leaves VMEM there, registers here). Forming
// e (x) hh in bf16 would round products that the Pallas kernel keeps exact.
//
// Bound on an H100: operations. At the flagship gate (B=16, N=237, K=5,
// I=64, D=20, O=128) one call is 6.21 GFLOP: 92.7 us on the f32 CUDA cores
// (67 TFLOP/s) or 6.3 us on bf16 tensor cores (989 TFLOP/s), against ~10
// MB of operands; the harness's rows form (4096 rows, KI=320, D=20, O=192,
// 24 steps) is 241.6 GFLOP, 244 us on bf16 tensor cores.
//
// bf16 operands: tensor cores (wgmma). A block of 64 WG rows and OT output
// columns has WG consumer warpgroups (64 rows each) and one producer warp.
// The consumers stage their rows' activations once per step, in bf16,
// gathered from the (B,K,N,I) layout by 16-byte cp.async of I-contiguous
// runs into K-major core matrices (two threads a row, walking (k, i)
// without dividing: the divisions had cost 6% of the harness's time). The producer streams the pool through a
// ring of kStages chunks (64 contraction rows x DG*OT columns), handed over
// by mbarriers, by TMA: a 5-d view of the pool gathers the columns o0 ..
// o0 + OT of DG consecutive d into one wgmma's N = DG*OT, so one m64nNk16
// product advances r_d for DG values of d at once (N = 128 to 192, where
// one d's OT columns alone would give a small, inefficient N). Each chunk's
// products are issued while the previous chunk's finish. After a group's
// last chunk the consumers fold acc += e[row, d] * r_d in f32 for its DG d
// (two e values per thread, one for each of its two rows) into sums kept in
// shared memory, a column per thread, so that only r_d holds registers.
// Row tiles start at different d, so fewer blocks read one pool line at a
// time. The tile is chosen from the grid: the one whose busiest SM has the
// least work (192x32 with 5 d a product for the harness rows, 128x32 and
// 128x16 with 4 and 8 d at the flagship cells). What keeps this design
// above its tensor-core time is the step boundary: the consumers reload
// their rows with the tensor cores idle (no room for a second copy beside
// the ring), and each fold drains the products. TMA fills past the ragged
// M, O and K*I edges with zeros; where O or K*I is not a multiple of 8 the
// producer loads elements.
//
// f32 operands: plain f32 FMAs (tensor cores would take them in TF32, three
// decimal digits): one block per 64 rows x 64 columns, 256 threads with 4x4
// outputs each; the pool streams through shared memory in 32-row chunks of
// one d's columns (from L2: the pool is 3.3 MB in f32), 4 columns a load
// where O is a multiple of 4. Each inner step reads two 16-byte words from
// shared memory for 16 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_sm90.cuh"

namespace {

using namespace wgmma_sm90;

// ---------------------------------------------------------------- f32 operands: CUDA cores

constexpr int kTileM = 64;               // rows per block
constexpr int kTileN = 64;               // output columns per block
constexpr int kChunkF32 = 32;            // contraction rows of the pool staged at a time
constexpr int kThreads = 256;            // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kTileM + 4;          // row stride of the transposed activations

__global__ void __launch_bounds__(kThreads)
node_factored_f32_kernel(const float* __restrict__ hh, const float* __restrict__ e, const float* __restrict__ pool,
                         const float* __restrict__ s, float* __restrict__ out,
                         int steps, int B, int K, int N, int I, int D, int O) {
  extern __shared__ __align__(16) float smem[];
  const int KI = K * I;
  const int M = B * N;
  float* hs = smem;                                  // KI x kLd: hs[kk][r] = hh of row r
  float* ps = hs + (size_t)KI * kLd;                 // kChunkF32 x kTileN pool chunk
  float* es = ps + kChunkF32 * kTileN;               // kTileM x D embeddings

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
    const float* ht = hh + (size_t)t * step_elems;
    __syncthreads();  // the previous step no longer reads hs
    for (int q = tid; q < kTileM * KI; q += kThreads) {
      const int r = q / KI, kk = q - r * KI;
      const int m = m0 + r;
      float v = 0.f;
      if (m < M) {
        const int b = m / N, n = m - b * N;
        const int k = kk / I, i = kk - k * I;
        v = ht[(((size_t)b * K + k) * N + n) * I + i];
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
      for (int k0 = 0; k0 < KI; k0 += kChunkF32) {
        __syncthreads();  // the previous chunk is no longer read (hs, es staged)
        if (O % 4 == 0) {  // 4 columns a load: rows and column groups start aligned
          for (int q = tid; q < kChunkF32 * kTileN / 4; q += kThreads) {
            const int kk = q / (kTileN / 4), c = 4 * (q - kk * (kTileN / 4));
            float* dst = ps + kk * kTileN + c;
            if (k0 + kk < KI && o0 + c < O) {
              *reinterpret_cast<float4*>(dst) =
                  *reinterpret_cast<const float4*>(pool + (size_t)(k0 + kk) * D * O + (size_t)d * O + o0 + c);
            } else {
              dst[0] = dst[1] = dst[2] = dst[3] = 0.f;
            }
          }
        } else {
          for (int q = tid; q < kChunkF32 * kTileN; q += kThreads) {
            const int kk = q / kTileN, c = q - kk * kTileN;
            const int o = o0 + c;
            ps[q] = (k0 + kk < KI && o < O) ? pool[(size_t)(k0 + kk) * D * O + (size_t)d * O + o] : 0.f;
          }
        }
        __syncthreads();
        const int kn = min(kChunkF32, KI - k0);
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
        out[(size_t)m * O + o] = acc[j][l] + sv;
      }
    }
  }
}

cudaError_t launch_f32(const void* hh, const void* e, const void* pool, const void* s, void* out, int steps,
                       int b, int k, int n, int i, int d, int o, cudaStream_t stream) {
  const size_t smem = ((size_t)k * i * kLd + kChunkF32 * kTileN + (size_t)kTileM * d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(node_factored_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((b * n + kTileM - 1) / kTileM), (unsigned)((o + kTileN - 1) / kTileN));
  node_factored_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(hh), static_cast<const float*>(e), static_cast<const float*>(pool),
      static_cast<const float*>(s), static_cast<float*>(out), steps, b, k, n, i, d, o);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 operands: tensor cores

constexpr size_t kMaxSmem = 227 * 1024;   // shared memory one block may use on an H100
constexpr int kChunk = 64;    // contraction rows of one pool chunk; the contraction is padded to it
constexpr int kStages = 4;    // pool chunks in the ring

__host__ __device__ constexpr int pad_k(int x) { return (x + kChunk - 1) / kChunk * kChunk; }

template <int WG, int DG, int OT>
size_t wgmma_smem_bytes(int ki) {
  return ((size_t)64 * WG * pad_k(ki) + (size_t)kStages * kChunk * DG * OT) * sizeof(__nv_bfloat16) +
         (size_t)OT / 2 * WG * 128 * sizeof(float) + 2 * kStages * sizeof(uint64_t);
}

// WG consumer warpgroups of 64 rows each and one producer warp; OT output
// columns per block. One wgmma's N = DG * OT columns gathers the pool's
// columns o0 .. o0 + OT of DG consecutive d: r_d for DG values of d at once.
// The producer streams chunks (kChunk rows x those N columns) through the
// ring, by TMA where `tma` is set (a 5-d view of the pool that lands a chunk
// in MN-major cores: dims (8 columns, 8 rows, O/8 column groups, D, K*I/8
// row groups)), else by element loads.
template <int WG, int DG, int OT, typename OutT>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
node_factored_wgmma_kernel(const __grid_constant__ CUtensorMap pool_map, int tma,
                           const __nv_bfloat16* __restrict__ hh, const float* __restrict__ e,
                           const __nv_bfloat16* __restrict__ pool, const float* __restrict__ s,
                           OutT* __restrict__ out, int steps, int B, int K, int N, int I, int D, int O) {
  constexpr int BM = 64 * WG;
  constexpr int BN = DG * OT;                    // the wgmma's N
  constexpr int kConsumers = WG * 128;
  constexpr int kR = BN / 2, kAcc = OT / 2;      // f32 accumulators of one thread: r of DG d, their sum
  constexpr int kChunkElems = kChunk * BN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int KI = K * I, KIc = pad_k(KI), KG = KIc / 8;
  const int M = B * N;
  const int chunks_per_d = KIc / kChunk;         // chunks of one group of DG d
  const int d_groups = (D + DG - 1) / DG;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BM x KIc, K-major cores
  __nv_bfloat16* ps = as + (size_t)BM * KIc;     // kStages chunks, core (kg, ng) at (kg BN/8 + ng) 64
  float* acc_s = reinterpret_cast<float*>(ps + (size_t)kStages * kChunkElems);   // kAcc x kConsumers sums
  uint64_t* full = reinterpret_cast<uint64_t*>(acc_s + kAcc * kConsumers);
  uint64_t* empty = full + kStages;

  const int m0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * OT;
  const int rot = blockIdx.x % d_groups;         // row tiles start at different d: fewer readers per pool line
  const int tid = threadIdx.x;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, WG);                // one arrival per consumer warpgroup
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: chunk g = ((t d_groups + j) chunks_per_d + kc) holds pool
    // rows kChunk kc .. of d = DG ((j + rot) % d_groups) + 0 .. DG-1, columns
    // o0 .. o0 + OT of each; rows past K*I, d past D and columns past O are 0
    const int lane = tid - kConsumers;
    const int total = steps * d_groups * chunks_per_d;
    for (int g = 0; g < total; ++g) {
      const int slot = g % kStages;
      if (g >= kStages) mbar_wait(empty + slot, ((g / kStages) & 1) ^ 1);
      const int kc = g % chunks_per_d, d0 = DG * ((g / chunks_per_d % d_groups + rot) % d_groups);
      __nv_bfloat16* dst = ps + (size_t)slot * kChunkElems;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_tx(full + slot, kChunkElems * sizeof(__nv_bfloat16));
          tma_load_5d(dst, &pool_map, 0, 0, o0 / 8, d0, kChunk / 8 * kc, full + slot);
        }
      } else {
        const int k0 = kChunk * kc;
        for (int q = lane; q < kChunkElems; q += 32) {
          const int k = q / BN, c = q - k * BN, d = d0 + c / OT, o = o0 + c % OT;
          dst[(k / 8 * (BN / 8) + c / 8) * 64 + (k % 8) * 8 + c % 8] =
              (k0 + k < KI && d < D && o < O) ? pool[(size_t)(k0 + k) * D * O + (size_t)d * O + o] : zero;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + slot);
      }
    }
  } else {
    // consumers
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    // the block's rows of step t: row m = (b, n), column (k, i) at
    // hh[t][b][k][n][i]; rows past M and columns past K*I are 0. Two threads
    // a row, each taking every other 8-column group, walk (k, i) without
    // dividing.
    auto load_rows = [&](int t) {
      const int r = tid % BM, half = tid / BM;
      const int m = m0 + r;
      const int b = m / N, n = m - b * N;
      const __nv_bfloat16* row = hh + (size_t)t * M * KI + ((size_t)b * K * N + n) * I;
      int k = (8 * half) / I, i = 8 * half - k * I;
      for (int c = 8 * half; c < KIc; c += 16) {
        if (I % 8 == 0) {
          const bool ok = m < M && c < KI;
          cp_async16(as + core_offset(r, c, KG), ok ? row + (size_t)k * N * I + i : hh, ok);
        } else {
          int kl = k, il = i;
#pragma unroll
          for (int l = 0; l < 8; ++l) {
            as[core_offset(r, c + l, KG)] = m < M && c + l < KI ? row[(size_t)kl * N * I + il] : zero;
            if (++il == I) il = 0, ++kl;
          }
        }
        for (i += 16; i >= I && I > 0; i -= I) ++k;
      }
    };
    auto consumers_sync = [] { asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory"); };
    // the slot's products are done: its warpgroup frees it for the producer
    auto release = [&](int slot) {
      if (tid % 128 == 0) mbar_arrive(empty + slot);
    };

    // this thread's two rows (16 warp + lane/4, + 8) of its warpgroup's 64,
    // and e's row of each (-1 past M)
    int erow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
      erow[h] = m < M ? (m % N) * D : -1;
    }
    const float sv = s != nullptr ? *s : 0.f;
    const __nv_bfloat16* a_wg = as + (size_t)64 * wg * KIc;   // this warpgroup's rows: 8 row groups of KG cores

    int g = 0;
    for (int t = 0; t < steps; ++t) {
      consumers_sync();             // the previous step's products no longer read the rows
      load_rows(t);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      consumers_sync();

      // the sum over d lives in shared memory (a column per thread), so that
      // only r holds registers across the products
      float r[kR] = {};
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc_s[i * kConsumers + tid] = 0.f;
      for (int j = 0; j < d_groups; ++j) {
        const int d0 = DG * ((j + rot) % d_groups);
        // r_d = rows @ pool_d over the whole contraction, in f32, for d0 .. d0 + DG:
        // each chunk's products go out while the previous chunk's finish, whose
        // buffer is then released to the producers
        for (int kc = 0; kc < chunks_per_d; ++kc, ++g) {
          const int slot = g % kStages;
          mbar_wait(full + slot, (g / kStages) & 1);
          const __nv_bfloat16* p = ps + (size_t)slot * kChunkElems;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kChunk / 16; ++ks)
            Wgmma<BN>::mma(r, desc(a_wg + (size_t)(kChunk / 8 * kc + 2 * ks) * 64, KG),
                           desc(p + (size_t)2 * ks * (BN / 8) * 64, BN / 8 * 128u, 128u), kc > 0 || ks > 0);
          wgmma_commit();
          if (kc > 0) {
            wgmma_wait<1>();
            release((g - 1) % kStages);
          }
        }
        wgmma_wait<0>();
        release((g - 1) % kStages);
        // acc += e[., d] * r_d for the group's d: r[dl kAcc + 4 i + v] is column
        // 8 i + 2 (lane % 4) + v % 2 of d0 + dl, of the row of v / 2
#pragma unroll
        for (int dl = 0; dl < DG; ++dl) {
          if (d0 + dl >= D) break;
          const float e0 = erow[0] >= 0 ? __ldg(e + erow[0] + d0 + dl) : 0.f;
          const float e1 = erow[1] >= 0 ? __ldg(e + erow[1] + d0 + dl) : 0.f;
#pragma unroll
          for (int i = 0; i < kAcc; ++i)
            acc_s[i * kConsumers + tid] = fmaf(i % 4 < 2 ? e0 : e1, r[dl * kAcc + i], acc_s[i * kConsumers + tid]);
        }
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
        if (m >= M) continue;
        OutT* row = out + (size_t)m * O + o0;
#pragma unroll
        for (int i = 0; i < OT / 8; ++i)
          store_pair(row, 8 * i + 2 * (lane % 4), O - o0, acc_s[(4 * i + 2 * h) * kConsumers + tid] + sv,
                     acc_s[(4 * i + 2 * h + 1) * kConsumers + tid] + sv);
      }
    }
  }
}

template <int WG, int DG, int OT, typename OutT>
cudaError_t launch_wgmma(const void* hh, const void* e, const void* pool, const void* s, void* out, int steps,
                         int b, int k, int n, int i, int d, int o, cudaStream_t stream) {
  auto kernel = node_factored_wgmma_kernel<WG, DG, OT, OutT>;
  const size_t smem = wgmma_smem_bytes<WG, DG, OT>(k * i);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  // the pool's chunks by TMA where whole 16-byte column groups and row
  // groups allow the view, else by the producer warp's element loads; a
  // view that the shape allows and cuTensorMapEncodeTiled refuses is an error
  CUtensorMap map = {};
  const int tma = o % 8 == 0 && k * i % 8 == 0;
  if (tma) {
    const cuuint64_t dims[5] = {8, 8, (cuuint64_t)o / 8, (cuuint64_t)d, (cuuint64_t)k * i / 8};
    const cuuint64_t strides[4] = {(cuuint64_t)d * o * 2, 16, (cuuint64_t)o * 2, (cuuint64_t)d * o * 16};
    const cuuint32_t box[5] = {8, 8, OT / 8, DG, kChunk / 8};
    err = encode_tiled<5>(&map, pool, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((b * n + 64 * WG - 1) / (64 * WG)), (unsigned)((o + OT - 1) / OT));
  kernel<<<grid, WG * 128 + 32, smem, stream>>>(
      map, tma, static_cast<const __nv_bfloat16*>(hh), static_cast<const float*>(e),
      static_cast<const __nv_bfloat16*>(pool), static_cast<const float*>(s), static_cast<OutT*>(out), steps, b, k, n,
      i, d, o);
  return cudaGetLastError();
}

// tiles (rows x columns, d per wgmma): 0: 192x32 (5), 1: 128x48 (4), 2: 128x32 (4), 3: 128x16 (8)
constexpr int kTiles = 4;
constexpr int kTileRows[kTiles] = {192, 128, 128, 128}, kTileCols[kTiles] = {32, 48, 32, 16};

template <typename OutT>
cudaError_t launch_tile(int tile, const void* hh, const void* e, const void* pool, const void* s, void* out,
                        int steps, int b, int k, int n, int i, int d, int o, cudaStream_t stream) {
  switch (tile) {
    case 0: return launch_wgmma<3, 5, 32, OutT>(hh, e, pool, s, out, steps, b, k, n, i, d, o, stream);
    case 1: return launch_wgmma<2, 4, 48, OutT>(hh, e, pool, s, out, steps, b, k, n, i, d, o, stream);
    case 2: return launch_wgmma<2, 4, 32, OutT>(hh, e, pool, s, out, steps, b, k, n, i, d, o, stream);
    case 3: return launch_wgmma<2, 8, 16, OutT>(hh, e, pool, s, out, steps, b, k, n, i, d, o, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The tile whose busiest SM has the least work, (blocks per SM, rounded up)
// x rows x columns, of those whose activations fit beside their ring; of
// equals, the earliest (larger tiles read the pool fewer times).
int choose_tile(int m, int o, int ki) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                 cudaSuccess)
    sms = 132;
  const size_t smem[kTiles] = {wgmma_smem_bytes<3, 5, 32>(ki), wgmma_smem_bytes<2, 4, 48>(ki),
                               wgmma_smem_bytes<2, 4, 32>(ki), wgmma_smem_bytes<2, 8, 16>(ki)};
  int best = kTiles - 1;
  long best_work = -1;
  for (int tile = 0; tile < kTiles; ++tile) {
    if (smem[tile] > kMaxSmem) continue;
    const long blocks = (long)((m + kTileRows[tile] - 1) / kTileRows[tile]) *
                        ((o + kTileCols[tile] - 1) / kTileCols[tile]);
    const long work = (blocks + sms - 1) / sms * kTileRows[tile] * kTileCols[tile];
    if (best_work < 0 || work < best_work) best = tile, best_work = work;
  }
  return best;
}

}  // namespace

// As node_factored_fwd, with the bf16 kernel's tile given (0: 192x32, 1:
// 128x48, 2: 128x32, 3: 128x16; -1: chosen from the grid), for
// measuring the tile; the f32 kernel has one tile and takes no other.
extern "C" int node_factored_fwd_tile(const void* hh, const void* e, const void* pool, const void* s, void* out,
                                      int steps, int b, int k, int n, int i, int d, int o,
                                      int bf16_in, int bf16_out, int tile, void* stream) {
  if (steps == 0 || b == 0 || n == 0 || o == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16_in) {
    if (bf16_out || tile > 0) return (int)cudaErrorInvalidValue;
    return (int)launch_f32(hh, e, pool, s, out, steps, b, k, n, i, d, o, st);
  }
  if (tile < 0) tile = choose_tile(b * n, o, k * i);
  return (int)(bf16_out ? launch_tile<__nv_bfloat16>(tile, hh, e, pool, s, out, steps, b, k, n, i, d, o, st)
                        : launch_tile<float>(tile, hh, e, pool, s, out, steps, b, k, n, i, d, o, st));
}

// Launches on `stream`; returns cudaGetLastError() after the launch, or the
// error of the pool's TMA view where the shape takes TMA (bf16 operands, O
// and K*I multiples of 8) and the view cannot be encoded. `s` may
// be null (no scalar). bf16_in: hh and pool are bf16 (else f32); bf16_out:
// out is bf16 (else f32), taken only with bf16_in (the harness's rows mode).
extern "C" int node_factored_fwd(const void* hh, const void* e, const void* pool, const void* s, void* out,
                                 int steps, int b, int k, int n, int i, int d, int o,
                                 int bf16_in, int bf16_out, void* stream) {
  return node_factored_fwd_tile(hh, e, pool, s, out, steps, b, k, n, i, d, o, bf16_in, bf16_out, -1, stream);
}
