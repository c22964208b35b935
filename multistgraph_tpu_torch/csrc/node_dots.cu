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
// applied at every step of the recurrence, against B = 16 rows per node.
//
// Bound on an H100: bytes. At the harness shapes (T=24, B=16, NP=256,
// KI=320, O=192) the distinct inputs are 94.4 MB (62.9 MB of activations,
// 31.5 MB of weights), 28 us at 3.35 TB/s, against 12.1 GFLOP (12 us on
// bf16 tensor cores). The design reads every byte once and runs on wgmma:
// one block per (node, kTileO columns) keeps the node's weight tile (KI x
// kTileO bf16, 123 KB at KI=320 and kTileO=192) resident in shared memory
// for all T steps as the MN-major B operand. A producer warp streams the
// node's activations by TMA (a 5-d view of hh that lands 64 rows x 64
// columns in K-major core matrices) through a ring of buffers handed over
// by mbarriers. 64 rows are four 16-row units, the B = 16 rows of four steps
// at the harness shape, so one m64nNk16 product serves four steps with each
// weight byte it reads (a partial or second unit for other B, taken by
// element loads). The consumer warpgroup adds s in f32, rounds once to bf16
// and stages each 64-row tile in shared memory, so that it leaves in
// 16-byte stores: one thread stores the same (row, 8 columns) of the four
// units in step order, so every step is stored and the last one stays.
// Zero fill pads the contraction to a multiple of 64 and the column tile
// past O.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_sm90.cuh"

namespace {

using namespace wgmma_sm90;

constexpr int kUnitRows = 16;    // rows of one unit: one step's batch rows (or 16 of them)
constexpr int kGroupUnits = 4;   // units of one 64-row wgmma tile
constexpr int kChunk = 64;       // contraction columns of one activation chunk
constexpr int kStages = 4;       // activation chunks in the ring
constexpr int kTileO = 192;      // output columns of one block: the wgmma's N

__host__ __device__ constexpr int pad_chunk(int x) { return (x + kChunk - 1) / kChunk * kChunk; }

size_t smem_bytes(int ki) {
  return ((size_t)pad_chunk(ki) * kTileO + (size_t)kStages * 64 * kChunk + 64 * (kTileO + 8)) *
             sizeof(__nv_bfloat16) +
         2 * kStages * sizeof(uint64_t);
}

// One consumer warpgroup and one producer warp per (node, kTileO columns).
// The producer streams 64-row x kChunk activation chunks through the ring, by
// TMA where `tma` is set (a 5-d view of hh that lands a chunk in K-major
// cores: dims (8 columns, 8 rows, KI/8 column groups, NP nodes, T*B/8 row
// groups), which needs B a multiple of 16), else by element loads.
__global__ void __launch_bounds__(160)
node_dots_kernel(const __grid_constant__ CUtensorMap hh_map, int tma, const __nv_bfloat16* __restrict__ hh,
                 const __nv_bfloat16* __restrict__ w, const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                 int T, int B, int NP, int KI, int O) {
  constexpr int kAcc = kTileO / 2;               // f32 accumulators of one thread
  constexpr int kChunkElems = 64 * kChunk;
  constexpr int kLdO = kTileO + 8;               // odd multiple of 16 bytes: no bank conflicts
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int KIc = pad_chunk(KI), KG = KIc / 8;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // KIc x kTileO, MN-major cores
  __nv_bfloat16* as = ws + (size_t)KIc * kTileO;                     // kStages chunks, K-major cores
  __nv_bfloat16* os = as + (size_t)kStages * kChunkElems;            // 64 x kLdO: a tile's results
  uint64_t* full = reinterpret_cast<uint64_t*>(os + 64 * kLdO);
  uint64_t* empty = full + kStages;

  const int n = blockIdx.x;
  const int o0 = blockIdx.y * kTileO;
  const int tid = threadIdx.x;
  const int units_per_step = (B + kUnitRows - 1) / kUnitRows;
  const int units = T * units_per_step;
  const int groups = (units + kGroupUnits - 1) / kGroupUnits;
  const int chunks_per_group = KIc / kChunk;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // producer warp: chunk g holds columns kChunk (g % chunks_per_group) .. of
    // the 64 rows of group g / chunks_per_group, whose row r is row 16 (u %
    // units_per_step) + r % 16 of step u / units_per_step, u = 4 group + r / 16;
    // rows past B, units past the last and columns past KI are 0
    const int lane = tid - 128;
    for (int g = 0; g < groups * chunks_per_group; ++g) {
      const int slot = g % kStages;
      if (g >= kStages) mbar_wait(empty + slot, ((g / kStages) & 1) ^ 1);
      const int grp = g / chunks_per_group, k0 = kChunk * (g - grp * chunks_per_group);
      __nv_bfloat16* dst = as + (size_t)slot * kChunkElems;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_tx(full + slot, kChunkElems * sizeof(__nv_bfloat16));
          tma_load_5d(dst, &hh_map, 0, 0, k0 / 8, n, 8 * grp, full + slot);
        }
      } else {
        for (int q = lane; q < kChunkElems; q += 32) {
          const int r = q / kChunk, c = q - r * kChunk;
          const int u = kGroupUnits * grp + r / kUnitRows;
          const int t = u / units_per_step, b = kUnitRows * (u - t * units_per_step) + r % kUnitRows;
          dst[core_offset(r, c, kChunk / 8)] =
              (u < units && b < B && k0 + c < KI) ? hh[(((size_t)t * B + b) * NP + n) * KI + k0 + c] : zero;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + slot);
      }
    }
    return;
  }

  // consumer warpgroup: the node's weight tile, loaded once; rows past KI
  // and columns past O are 0
  const int warp = tid / 32, lane = tid % 32;
  auto consumers_sync = [] { asm volatile("bar.sync 1, 128;\n" ::: "memory"); };
  const __nv_bfloat16* wn = w + (size_t)n * KI * O + o0;
  if (O % 8 == 0) {
    for (int q = tid; q < KIc * (kTileO / 8); q += 128) {
      const int k = q / (kTileO / 8), c = 8 * (q - k * (kTileO / 8));
      const bool ok = k < KI && o0 + c < O;
      cp_async16(ws + core_offset_mn(k, c, KG), ok ? wn + (size_t)k * O + c : w, ok);
    }
  } else {
    for (int q = tid; q < KIc * kTileO; q += 128) {
      const int k = q / kTileO, c = q - k * kTileO;
      ws[core_offset_mn(k, c, KG)] = (k < KI && o0 + c < O) ? wn[(size_t)k * O + c] : zero;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  consumers_sync();

  const float sv = *s;
  float acc[kAcc] = {};
  int g = 0;
  for (int grp = 0; grp < groups; ++grp) {
    // the tile's products: each chunk's go out while the previous chunk's
    // finish, whose buffer is then released to the producer
    for (int kc = 0; kc < chunks_per_group; ++kc, ++g) {
      const int slot = g % kStages;
      mbar_wait(full + slot, (g / kStages) & 1);
      const __nv_bfloat16* a = as + (size_t)slot * kChunkElems;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks)
        Wgmma<kTileO>::mma(acc, desc(a + 2 * ks * 64, kChunk / 8),
                           desc(ws + (size_t)(kChunk / 8 * kc + 2 * ks) * 64, KG), kc > 0 || ks > 0);
      wgmma_commit();
      if (kc > 0) {
        wgmma_wait<1>();
        mbar_arrive(empty + (g - 1) % kStages);
      }
    }
    wgmma_wait<0>();
    mbar_arrive(empty + (g - 1) % kStages);

    // the tile's 4 units (warp w holds unit 4 grp + w) through shared memory,
    // then out in 16-byte rows: one thread stores one (row, 8 columns) of
    // every unit, in unit order, so the last step's store is the one that stays
    consumers_sync();               // the previous tile's results are out
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kTileO / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(os + (16 * warp + lane / 4 + 8 * h) * kLdO + 8 * j + 2 * (lane % 4)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] + sv, acc[4 * j + 2 * h + 1] + sv);
    consumers_sync();
    for (int q = tid; q < kUnitRows * (kTileO / 8); q += 128) {
      const int r = q / (kTileO / 8), c = 8 * (q - r * (kTileO / 8));
      if (o0 + c >= O) continue;
      for (int wu = 0; wu < kGroupUnits; ++wu) {
        const int u = kGroupUnits * grp + wu;
        const int t = u / units_per_step, b = kUnitRows * (u - t * units_per_step) + r;
        if (u >= units || b >= B) continue;
        const __nv_bfloat16* src = os + (16 * wu + r) * kLdO + c;
        __nv_bfloat16* dst = out + (size_t)b * NP * O + (size_t)n * O + o0 + c;
        if (O % 8 == 0) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int l = 0; l < 8 && o0 + c + l < O; ++l) dst[l] = src[l];
        }
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch, or
// the error of the TMA view where the shape takes TMA and the view cannot
// be encoded.
extern "C" int node_dots_fwd(const void* hh, const void* w, const void* s, void* out,
                             int t, int b, int np, int ki, int o, void* stream) {
  if (t == 0 || b == 0 || np == 0 || o == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(ki);
  cudaError_t err = cudaFuncSetAttribute(node_dots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(node_dots_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // the activations by TMA where whole 16-row units and 16-byte column
  // groups allow the view, else by the producer warp's element loads
  CUtensorMap map = {};
  const int tma = b % kUnitRows == 0 && ki % 8 == 0;
  if (tma) {
    const cuuint64_t row = (cuuint64_t)np * ki * 2;   // bytes from one (t, b) row to the next
    const cuuint64_t dims[5] = {8, 8, (cuuint64_t)ki / 8, (cuuint64_t)np, (cuuint64_t)t * b / 8};
    const cuuint64_t strides[4] = {row, 16, (cuuint64_t)ki * 2, 8 * row};
    const cuuint32_t box[5] = {8, 8, kChunk / 8, 1, 8};
    err = encode_tiled<5>(&map, hh, dims, strides, box);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)np, (unsigned)((o + kTileO - 1) / kTileO));
  node_dots_kernel<<<grid, 160, smem, static_cast<cudaStream_t>(stream)>>>(
      map, tma, static_cast<const __nv_bfloat16*>(hh), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out), t, b, np, ki, o);
  return (int)cudaGetLastError();
}
