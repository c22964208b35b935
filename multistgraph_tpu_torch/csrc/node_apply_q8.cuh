// The int8 node-conditioned weight apply B2 and its transpose B2t on Hopper's
// tensor cores (sm_90a): one kernel template, instantiated by
// node_apply_q8.cu (TRANS = false) and node_apply_q8_t.cu (TRANS = true).
//
//   B2:  out[n,b,o]  = (sum_ki x[n,b,ki] wq[n,ki,o]) * scale[n,0,o]            f32
//   B2t: out[n,b,ki] = bf16(sum_o bf16(x[n,b,o] * scale[n,0,o]) wq[n,ki,o])   bf16
//
// x (N,B,KI) or (N,B,O) bf16, wq (Nw,KI,O) int8 with Nw >= N (rows past N
// are never read), scale (Nw,1,O) f32; all contiguous.
//
// Both are bound by bytes at the batches the model runs (B <= 16): each node's
// int8 weights are read once and do the product's only weight-sized traffic.
// The design streams them once, widens them to bf16 on chip and contracts on
// the tensor cores (wgmma m64nNk16, f32 sums), with the batch on wgmma's N
// (8 to 128 columns, so a batch of 1-16 pads to 8 or 16, not to 64 rows) and
// a weight dimension on its 64 rows:
//   B2:  out[n]^T (O x B)  = wq[n]^T (O x KI) . x[n]^T (KI x B): A MN-major;
//   B2t: out[n]^T (KI x B) = wq[n] (KI x O) . q[n]^T (O x B), q = bf16(x s):
//        A K-major.
// A block is one warpgroup (64 rows M of one node: o for B2, ki for B2t) and
// one producer warp. Blocks are persistent, as many as the card holds at
// once, each walking work items (a 64-row tile, a batch tile of BN columns,
// a node; tiles fastest, so that the tiles of one node run side by side and
// share its x in L2), and each item's contraction (KI for B2, O for B2t) in
// chunks of 64. The producer keeps a ring of stages in flight, each one
// chunk of the node's int8 weights (64 ki rows of 64 o bytes: the same box
// of one (O, KI, N) view for both kernels) and of x (BN rows of 64 bf16
// under the 128-byte swizzle, the wgmma's K-major B), by TMA where the rows
// are whole 16-byte units (O % 16 == 0 for the weights, the contraction %
// 8 == 0 for x) and else by element loads into the same layout; it runs on
// into the next item while the warpgroup stores this one's outputs. The
// ring holds every chunk of the flagship's contraction, so at B <= 32 a
// block asks for all its bytes at once and several blocks (about 60 KB of
// shared memory each) put several nodes' weights in flight on each SM;
// where blocks walk several items, it holds the next item's chunks too
// (B2t at B = 16: 14.1 -> 13.1 us at the update on an H100). The
// warpgroup widens each int8 chunk into bf16 rows of 128 bytes under the
// 128-byte swizzle (8-byte shared loads, an exact widening by byte permutes
// and one f32 add, 16-byte stores; double-buffered), which is MN-major A for
// B2 and K-major A for B2t byte for byte; B2t also scales and rounds its x
// chunk in place (the Pallas rounding point). Then four k16 products go
// out while the next chunk is widened. The epilogue multiplies B2's sums by
// the scale; tiles of up to 32 columns store straight from the
// accumulators (each warp store fills whole 32-byte sectors of f32, or half
// of bf16 twice over), wider ones through shared memory as 16-byte stores.
// Faults planted on request (checks that must catch them): the
// contraction's last k16 slice dropped (its widened weights zeroed), and
// the batch columns past the first 8 of a tile written as zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

// Internal linkage (the unnamed namespace): the source that includes this
// keeps its own function-local caches (residency) and kernels, also where
// a process loads two builds of it side by side (tools/ab_node_apply.py).
namespace q8_sm90 {
namespace {

using namespace wgmma_sm90;
using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;                     // contraction per ring stage
constexpr int kConsumers = 128;                // one warpgroup: 64 rows of M
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kWeightBytes = kChunk * 64;      // int8 chunk: 64 ki rows of 64 o
constexpr int kABytes = kChunk * 64 * 2;       // widened: 64 rows of 128 bytes
constexpr int kFaultK16 = 1;                   // the contraction's last k16 slice dropped
constexpr int kFaultColumns = 2;               // batch columns past the first 8 of a tile zeroed
constexpr int kBatchTiles[] = {8, 16, 24, 32, 64, 128};

template <int BN>
struct Tile {
  static constexpr int kMaxStages = BN <= 32 ? 6 : 4;
  static constexpr int kMinBlocks = BN <= 32 ? 4 : BN == 64 ? 3 : 2;
  static constexpr int kXBytes = BN * 128;                     // BN rows of 64 bf16
  static constexpr int kStageBytes = kXBytes + kWeightBytes;   // 1024-byte multiples
};

struct Args {
  int B, KI, O;
  int stages, chunks, m_tiles, b_tiles, tma_w, tma_x, fault;
  long long items;   // (64-row tile, batch tile, node) work items, tiles fastest
};

constexpr int kStageLd = 68;     // staged output row stride (floats): conflict-free writes
constexpr int kStageCols = 32;   // batch columns staged at a time

__host__ __device__ inline size_t smem_bytes(int stage_bytes, int stages) {
  return 1024 + 2 * (size_t)kABytes + (size_t)stages * stage_bytes + kStageCols * kStageLd * sizeof(float) +
         2 * (size_t)stages * sizeof(uint64_t);
}

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory"); }

// The four int8 of w as two bf16 pairs (the lower byte in the low half),
// exactly: u = x + 128 goes into the low mantissa byte of 2^23, f32 takes
// off 2^23 + 128, and the top halves of the f32 are the bf16 (|x| <= 128
// needs 8 significant bits). Full-rate byte permutes and adds, where int
// -> float conversions run at a quarter of the rate.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// The int8 chunk (64 rows of 64 bytes) widened into bf16 rows of 128 bytes
// under the 128-byte swizzle. drop >= 0 zeroes the k16 slice `drop`: rows
// 16 drop .. (k on the rows, B2) or columns (k along the rows, B2t).
template <bool K_COLS>
__device__ __forceinline__ void widen_chunk(const unsigned char* ws, unsigned char* ad, int tid, int drop) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = tid + kConsumers * i, r = q / 8, u = q % 8;
    const uint2 v = *reinterpret_cast<const uint2*>(ws + r * 64 + u * 8);
    const uint2 lo = widen4(v.x), hi = widen4(v.y);
    uint4 w = make_uint4(lo.x, lo.y, hi.x, hi.y);
    if (K_COLS ? u / 2 == drop : r / 16 == drop) w = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(ad + r * 128 + ((u ^ (r % 8)) * 16)) = w;
  }
}

// B2t's x chunk scaled and rounded in place: q = bf16(x * scale), o = k0 ..
// k0 + 63 (units past O hold zeros; their scale is not read). Thread tid
// takes the 16-byte units p = tid + 128 i: row b = p / 8 and, under the
// swizzle, the same 8 columns o in each, so it reads its 8 scales once.
template <int BN>
__device__ __forceinline__ void scale_chunk(unsigned char* xs, const float* sn, int k0, int O, int tid) {
  if (tid >= BN * 8) return;
  const int o = k0 + 8 * ((tid % 8) ^ (tid / 8 % 8));
  float s[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = o + e < O ? sn[o + e] : 0.f;
  for (int p = tid; p < BN * 8; p += kConsumers) {
    uint4* unit = reinterpret_cast<uint4*>(xs + p * 16);
    uint4 v = *unit;
    uint32_t* words = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&words[e]));
      __nv_bfloat162 q = __floats2bfloat162_rn(f.x * s[2 * e], f.y * s[2 * e + 1]);
      words[e] = *reinterpret_cast<uint32_t*>(&q);
    }
    *unit = v;
  }
}

// The item's (64 rows M at m0) x (BN columns at b0) outputs from the
// accumulators, B2's scaled by s: BN <= 32 straight from the registers
// (each warp store fills whole 32-byte sectors of f32, or half of bf16
// twice over); wider tiles through shared memory 32 columns at a time, so
// that they leave as 16-byte stores along M.
template <int BN, bool TRANS>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], const float (&s)[2], float* stg, void* out,
                                           int n, int m0, int b0, int M, int B, int fault, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  if constexpr (BN <= 32) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = m0 + 16 * warp + lane / 4 + 8 * (v / 2), b = b0 + 8 * j + 2 * (lane % 4) + v % 2;
        if (m >= M || b >= B) continue;
        const float val = fault == kFaultColumns && j > 0 ? 0.f : acc[4 * j + v] * s[v / 2];
        const size_t at = ((size_t)n * B + b) * M + m;
        if (TRANS)
          static_cast<bf16*>(out)[at] = __float2bfloat16(val);
        else
          static_cast<float*>(out)[at] = val;
      }
  } else {
    constexpr int kVec = TRANS ? 8 : 4;   // outputs of one 16-byte store
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += kStageCols / 8) {
#pragma unroll
      for (int jj = 0; jj < kStageCols / 8; ++jj)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = 16 * warp + lane / 4 + 8 * (v / 2), col = 8 * jj + 2 * (lane % 4) + v % 2;
          stg[col * kStageLd + r] = fault == kFaultColumns && j0 + jj > 0 ? 0.f : acc[4 * (j0 + jj) + v] * s[v / 2];
        }
      consumer_sync();
      for (int q = tid; q < kStageCols * (64 / kVec); q += kConsumers) {
        const int col = q / (64 / kVec), r = (q % (64 / kVec)) * kVec, m = m0 + r, b = b0 + 8 * j0 + col;
        if (b >= B || m >= M) continue;
        const float* src = stg + col * kStageLd + r;
        const size_t at = ((size_t)n * B + b) * M + m;
        if (M % kVec == 0) {
          const float4 v0 = *reinterpret_cast<const float4*>(src);
          if (TRANS) {
            const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
            __nv_bfloat162 p[4] = {__floats2bfloat162_rn(v0.x, v0.y), __floats2bfloat162_rn(v0.z, v0.w),
                                   __floats2bfloat162_rn(v1.x, v1.y), __floats2bfloat162_rn(v1.z, v1.w)};
            *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + at) = *reinterpret_cast<const uint4*>(p);
          } else {
            *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = v0;
          }
        } else {
          for (int e = 0; e < kVec && m + e < M; ++e) {
            if (TRANS)
              static_cast<bf16*>(out)[at + e] = __float2bfloat16(src[e]);
            else
              static_cast<float*>(out)[at + e] = src[e];
          }
        }
      }
      consumer_sync();   // the staging is read before the next columns overwrite it
    }
  }
}

// Work item w: the 64-row tile (fastest, so that the tiles of one node and
// batch tile run side by side and share their x in L2), then the batch
// tile, then the node.
__device__ __forceinline__ void decode(long long w, const Args& a, int& n, int& m0, int& b0, int bn) {
  m0 = (int)(w % a.m_tiles) * 64;
  const long long rest = w / a.m_tiles;
  b0 = (int)(rest % a.b_tiles) * bn;
  n = (int)(rest / a.b_tiles);
}

// w_map: the (O, KI, N) int8 view, box (64 o, 64 ki, 1 n); x_map: the (K, B,
// N) bf16 view of x under the 128-byte swizzle, box (64, BN, 1), K the
// contraction (KI for B2, O for B2t).
template <int BN, bool TRANS>
__global__ void __launch_bounds__(kThreads, Tile<BN>::kMinBlocks)
q8_kernel(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap x_map,
          const int8_t* __restrict__ wq, const bf16* __restrict__ x, const float* __restrict__ scale,
          void* __restrict__ out, Args a) {
  using T = Tile<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* abuf = smem;                          // 2 widened weight chunks
  unsigned char* ring = abuf + 2 * kABytes;            // stages: x chunk, then the int8 chunk
  float* stg = reinterpret_cast<float*>(ring + (size_t)a.stages * T::kStageBytes);   // staged outputs
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + kStageCols * kStageLd);
  uint64_t* empty = full + a.stages;

  const int K = TRANS ? a.O : a.KI, M = TRANS ? a.KI : a.O;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: chunk c of an item holds the contraction k0 = 64 c ..
    // k0 + 63 of x rows b0 .. b0 + BN - 1 and of the weights' 64 rows M at
    // m0; zero past K, B and M. It runs on into the next item's chunks
    // while the consumers store this one's outputs.
    const int lane = tid - kConsumers;
    const bf16 zero = __float2bfloat16(0.f);
    int g = 0;
    for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
      int n, m0, b0;
      decode(item, a, n, m0, b0, BN);
      for (int c = 0; c < a.chunks; ++c, ++g) {
        const int st = g % a.stages, k0 = c * kChunk;
        if (g >= a.stages) mbar_wait(empty + st, ((g / a.stages) & 1) ^ 1);
        unsigned char* xs = ring + (size_t)st * T::kStageBytes;
        int8_t* ws = reinterpret_cast<int8_t*>(xs + T::kXBytes);
        if (!a.tma_x) {
#pragma unroll 4
          for (int q = lane; q < BN * kChunk; q += 32) {
            const int b = q / kChunk, k = q % kChunk;
            *reinterpret_cast<bf16*>(xs + sw128(b * 128 + k * 2)) =
                b0 + b < a.B && k0 + k < K ? x[((size_t)n * a.B + b0 + b) * K + k0 + k] : zero;
          }
        }
        if (!a.tma_w) {
#pragma unroll 4
          for (int q = lane; q < kWeightBytes; q += 32) {
            const int r = q / 64, col = q % 64;
            const int ki = TRANS ? m0 + r : k0 + r, o = TRANS ? k0 + col : m0 + col;
            ws[q] = ki < a.KI && o < a.O ? wq[((size_t)n * a.KI + ki) * a.O + o] : (int8_t)0;
          }
        }
        if (!a.tma_x || !a.tma_w) {
          fence_proxy_async();
          __syncwarp();
        }
        if (lane == 0) {
          const unsigned tx = (a.tma_x ? T::kXBytes : 0) + (a.tma_w ? kWeightBytes : 0);
          if (tx) {
            mbar_arrive_tx(full + st, tx);
            if (a.tma_x) tma_load_3d(xs, &x_map, k0, b0, n, full + st);
            if (a.tma_w) tma_load_3d(ws, &w_map, TRANS ? k0 : m0, TRANS ? m0 : k0, n, full + st);
          } else {
            mbar_arrive(full + st);
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroup: thread tid holds rows m0 + 16 warp + lane / 4 (+ 8)
  const int warp = tid / 32, lane = tid % 32;
  float acc[BN / 2];
  int g = 0;
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    int n, m0, b0;
    decode(item, a, n, m0, b0, BN);
    const float* sn = scale + (size_t)n * a.O;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < a.chunks; ++c, ++g) {
      const int st = g % a.stages;
      mbar_wait(full + st, (g / a.stages) & 1);
      unsigned char* xs = ring + (size_t)st * T::kStageBytes;
      unsigned char* ad = abuf + (g % 2) * kABytes;   // its products of two chunks ago are done
      const int drop = a.fault == kFaultK16 && c == a.chunks - 1 ? (K - 1) % kChunk / 16 : -1;
      widen_chunk<TRANS>(xs + T::kXBytes, ad, tid, drop);
      if (TRANS) scale_chunk<BN>(xs, sn, c * kChunk, a.O, tid);
      fence_proxy_async();
      consumer_sync();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks)
        Wgmma<BN>::template mma_t<TRANS ? 0 : 1, 0>(
            acc, TRANS ? desc_sw128(ad + 32 * ks, 16u) : desc_sw128(ad + 2048 * ks, 8192u),
            desc_sw128(xs + 32 * ks, 16u), 1);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();   // the previous chunk's products are done: free its stage
        if (tid == 0) mbar_arrive(empty + (g - 1) % a.stages);
      }
    }
    wgmma_wait<0>();
    if (a.chunks > 0 && tid == 0) mbar_arrive(empty + (g - 1) % a.stages);

    // acc[4 j + v]: row m0 + 16 warp + lane / 4 + 8 (v / 2), column b0 + 8 j
    // + 2 (lane % 4) + v % 2
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * warp + lane / 4 + 8 * h;
      s[h] = !TRANS && m < M ? sn[m] : 1.f;
    }
    store_tile<BN, TRANS>(acc, s, stg, out, n, m0, b0, M, a.B, a.fault, tid);
  }
}

// The batch tile: the narrowest of kBatchTiles that holds B, else 128 in
// as many tiles as B needs (on an H100 at B = 256, 128-column tiles ran
// 7-16% ahead of one 256-column tile: two blocks an SM, where 256 columns
// leave room for one).
inline int choose_bn(int b) {
  for (int bn : kBatchTiles)
    if (b <= bn) return bn;
  return 128;
}

// Blocks of the kernel one SM holds at `stages` ring stages, and the SMs;
// read once per (instantiation, stages) with the shared-memory limit set
// for the most stages (a process runs the port on one card type).
template <int BN, bool TRANS>
cudaError_t residency(int stages, int& blocks) {
  using T = Tile<BN>;
  static int per_sm[T::kMaxStages + 1] = {}, sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = allow_smem(q8_kernel<BN, TRANS>, smem_bytes(T::kStageBytes, T::kMaxStages));
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  if (per_sm[stages] == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[stages], q8_kernel<BN, TRANS>, kThreads,
                                                                    smem_bytes(T::kStageBytes, stages));
    if (err != cudaSuccess) return err;
    if (per_sm[stages] < 1) return cudaErrorInvalidConfiguration;
  }
  blocks = per_sm[stages] * sms;
  return cudaSuccess;
}

template <int BN, bool TRANS>
cudaError_t launch(const void* x, const void* wq, const void* scale, void* out, int n, int b, int ki, int o,
                   int fault, cudaStream_t stream) {
  using T = Tile<BN>;
  const int K = TRANS ? o : ki, M = TRANS ? ki : o;
  Args a;
  a.B = b, a.KI = ki, a.O = o;
  a.chunks = (K + kChunk - 1) / kChunk;
  a.stages = a.chunks < T::kMaxStages ? a.chunks : T::kMaxStages;
  a.m_tiles = (M + 63) / 64;
  a.b_tiles = (b + BN - 1) / BN;
  a.tma_w = o % 16 == 0;
  a.tma_x = K % 8 == 0;
  a.fault = fault;
  a.items = (long long)a.m_tiles * a.b_tiles * n;
  int resident = 0;
  cudaError_t err = residency<BN, TRANS>(a.stages, resident);
  if (err != cudaSuccess) return err;
  if (a.items > resident && a.stages < T::kMaxStages) {
    // blocks walk several items: room for the next item's chunks as well
    a.stages = 2 * a.chunks < T::kMaxStages ? 2 * a.chunks : T::kMaxStages;
    err = residency<BN, TRANS>(a.stages, resident);
    if (err != cudaSuccess) return err;
  }
  auto kernel = q8_kernel<BN, TRANS>;
  const size_t smem = smem_bytes(T::kStageBytes, a.stages);
  // a view that the shape allows and cuTensorMapEncodeTiled refuses (a base
  // that is not 16-byte aligned) is an error, not a switch to element loads
  CUtensorMap w_map = {}, x_map = {};
  if (a.tma_w) {
    const cuuint64_t dims[3] = {(cuuint64_t)o, (cuuint64_t)ki, (cuuint64_t)n};
    const cuuint64_t strides[2] = {(cuuint64_t)o, (cuuint64_t)ki * o};
    const cuuint32_t box[3] = {64, kChunk, 1};
    err = encode_tiled<3>(&w_map, wq, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_DATA_TYPE_UINT8);
    if (err != cudaSuccess) return err;
  }
  if (a.tma_x) {
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)b, (cuuint64_t)n};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)b * K * 2};
    const cuuint32_t box[3] = {kChunk, BN, 1};
    err = encode_tiled<3>(&x_map, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  // persistent blocks: as many as the card holds at once, each walking
  // items, its ring running on from one item into the next
  const unsigned grid = (unsigned)(a.items < resident ? a.items : resident);
  kernel<<<grid, kThreads, smem, stream>>>(w_map, x_map, static_cast<const int8_t*>(wq), static_cast<const bf16*>(x),
                                          static_cast<const float*>(scale), out, a);
  return cudaGetLastError();
}

// Launches B2 (TRANS = false) or B2t on `stream` at the batch tile bn (0:
// choose_bn(b); else one of kBatchTiles) with `fault` planted (0: none);
// returns cudaGetLastError() after the launch, or the error of a TMA view
// that cannot be encoded. An empty contraction writes zeros.
template <bool TRANS>
cudaError_t launch_q8(const void* x, const void* wq, const void* scale, void* out, int n, int b, int ki, int o,
                      int bn, int fault, cudaStream_t s) {
  if (n == 0 || b == 0 || (TRANS ? ki : o) == 0) return cudaSuccess;
  if ((TRANS ? o : ki) == 0)
    return cudaMemsetAsync(out, 0, (size_t)n * b * (TRANS ? (size_t)ki * 2 : (size_t)o * 4), s);
  if (bn == 0) bn = choose_bn(b);
  switch (bn) {
    case 8: return launch<8, TRANS>(x, wq, scale, out, n, b, ki, o, fault, s);
    case 16: return launch<16, TRANS>(x, wq, scale, out, n, b, ki, o, fault, s);
    case 24: return launch<24, TRANS>(x, wq, scale, out, n, b, ki, o, fault, s);
    case 32: return launch<32, TRANS>(x, wq, scale, out, n, b, ki, o, fault, s);
    case 64: return launch<64, TRANS>(x, wq, scale, out, n, b, ki, o, fault, s);
    case 128: return launch<128, TRANS>(x, wq, scale, out, n, b, ki, o, fault, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace q8_sm90
