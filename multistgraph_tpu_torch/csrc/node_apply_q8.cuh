// The int8 node-conditioned weight apply B2 and its transpose B2t on Hopper's
// tensor cores (sm_90a): one kernel template, instantiated by
// node_apply_q8.cu (TRANS = false) and node_apply_q8_t.cu (TRANS = true).
//
//   B2:  out[n,b,o]  = (sum_ki x[n,b,ki] wq[n,ki,o]) * scale[n,0,o]            f32
//   B2t: out[n,b,ki] = T(sum_o bf16(x[n,b,o] * scale[n,0,o]) wq[n,ki,o])      T: x's type
//
// x (N,B,KI) or (N,B,O) bf16, f32 or f16, wq (Nw,KI,O) int8 with Nw >= N
// (rows past N are never read), scale (Nw,1,O) f32; all contiguous. The
// sums are f32 and every product is exact: x f32 or f16 against the int8
// weights in full (not TF32), as the Pallas kernels contract any float
// activation against the weights widened to bf16 with f32 results.
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
// of one (O, KI, N) view for both kernels) and of x, by TMA where the rows
// are whole 16-byte units (O % 16 == 0 for the weights; for x the
// contraction % 8 == 0 in bf16 and f16, % 4 == 0 in f32) and else by
// element loads into the same layout; it runs on into the next item while
// the warpgroup stores this one's outputs. A bf16 x chunk lands as BN rows
// of 64 bf16 under the 128-byte swizzle, the wgmma's K-major B; an f32 or
// f16 one lands raw (BN rows of 64 elements) and the warpgroup writes it as
// bf16 B tiles beside the ring (double-buffered), then frees the stage
// before its products run:
//   B2:  x = hi + mid (+ lo), each piece the bf16 rounding of what the ones
//        before it leave: three pieces hold an f32 exactly (24 significant
//        bits in three of 8), two an f16 (11 bits). Every k16 slice issues
//        one product per piece against the same widened weights, each exact
//        in f32, so only the f32 sums round;
//   B2t: q = bf16(x * scale) in f32, the Pallas kernel's rounding point,
//        one piece.
// The pieces' buffers also stage the wide tiles' outputs, and the f32 and
// f16 forms take tiles of at most 64 columns and fewer ring stages where
// that puts another block on an SM (choose_bn, launch).
// The ring holds every chunk of the flagship's contraction, so at B <= 32 a
// block asks for all its bytes at once and several blocks put several
// nodes' weights in flight on each SM; where blocks walk several items, it
// holds the next item's chunks too (B2t at B = 16: 14.1 -> 13.1 us at the
// update on an H100). The warpgroup widens each int8 chunk into bf16 rows of
// 128 bytes under the 128-byte swizzle (8-byte shared loads, an exact
// widening by byte permutes and one f32 add, 16-byte stores;
// double-buffered), which is MN-major A for B2 and K-major A for B2t byte
// for byte; B2t in bf16 also scales and rounds its x chunk in place. Then
// four k16 slices of products go out while the next chunk is widened. The
// epilogue multiplies B2's sums by the scale and stores B2's in f32, B2t's
// in x's type (a type fixed by the instantiation: no branch); tiles of up
// to 32 columns store straight from the accumulators (each warp store fills
// whole 32-byte sectors of f32, or half of bf16 or f16 twice over), wider
// ones through shared memory as 16-byte stores.
// Faults planted on request (checks that must catch them): the
// contraction's last k16 slice dropped (its widened weights zeroed, so in
// B2 every piece of it), and the batch columns past the first 8 of a tile
// written as zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_sm90.cuh"

// Internal linkage (the unnamed namespace): the source that includes this
// keeps its own function-local caches (residency) and kernels, also where
// a process loads two builds of it side by side (tools/ab_node_apply.py).
namespace q8_sm90 {
namespace {

using namespace wgmma_sm90;
using bf16 = __nv_bfloat16;
using f16 = __half;

// element types of the activation, which B2t also writes (the C entries' codes)
constexpr int kTypeBf16 = 0, kTypeF32 = 1, kTypeF16 = 2;

constexpr int kChunk = 64;                     // contraction per ring stage
constexpr int kConsumers = 128;                // one warpgroup: 64 rows of M
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kWeightBytes = kChunk * 64;      // int8 chunk: 64 ki rows of 64 o
constexpr int kABytes = kChunk * 64 * 2;       // widened: 64 rows of 128 bytes
constexpr int kFaultK16 = 1;                   // the contraction's last k16 slice dropped
constexpr int kFaultColumns = 2;               // batch columns past the first 8 of a tile zeroed
constexpr int kBatchTiles[] = {8, 16, 24, 32, 64, 128};
constexpr size_t kSmemLimit = 227 * 1024;      // shared memory one block may use on an H100
constexpr size_t kSmemPerSm = 228 * 1024;      // shared memory of an H100 SM
constexpr size_t kSmemPerBlock = 1024;         // of it reserved for each resident block

constexpr int kStageLd = 68;     // staged output row stride (floats): conflict-free writes
constexpr int kStageCols = 32;   // batch columns staged at a time

// The block's shared memory: the widened weights, the pieces' buffers, the
// ring, the staged outputs of tiles wider than 32 columns (in the pieces'
// buffers where there are pieces: the item's products are done with them)
// and the mbarriers.
__host__ __device__ constexpr size_t smem_bytes(int stage_bytes, int stages, int split_bytes = 0) {
  return 1024 + 2 * (size_t)kABytes + (size_t)split_bytes + (size_t)stages * stage_bytes +
         (split_bytes > 0 ? 0 : kStageCols * kStageLd * sizeof(float)) + 2 * (size_t)stages * sizeof(uint64_t);
}

template <int BN, bool TRANS, typename XT>
struct Tile {
  // bf16 B tiles of BN rows the warpgroup writes an f32 or f16 x chunk
  // into: B2's pieces of x (three for f32, two for f16), B2t's q; none for
  // bf16, whose chunk is the B tile itself
  static constexpr int kPieces = std::is_same<XT, bf16>::value ? 0 : TRANS ? 1 : sizeof(XT) == 4 ? 3 : 2;
  static constexpr int kPieceBytes = BN * 128;
  static constexpr int kSplitBytes = 2 * kPieces * kPieceBytes;                  // double-buffered
  static constexpr int kXBytes = BN * kChunk * (int)sizeof(XT);                  // BN rows of 64 elements
  static constexpr int kStageBytes = kXBytes + kWeightBytes;                     // 1024-byte multiples
  // as many stages as the contraction asks (the launch decides) up to 6 at
  // B <= 32 and 4 beyond, and as shared memory holds beside the pieces
  static constexpr int kCap = BN <= 32 ? 6 : 4;
  static constexpr int kFit = (int)((kSmemLimit - smem_bytes(0, 0, kSplitBytes)) /
                                    (kStageBytes + 2 * sizeof(uint64_t)));
  static constexpr int kMaxStages = kCap < kFit ? kCap : kFit;
  // blocks an SM is to hold (__launch_bounds__, which caps the registers to
  // match): bf16 x 4 at BN <= 32, 3 at 64, 2 at 128; f32 and f16 x as many
  // as shared memory holds at their fewest stages (two, launch), at least 1
  static constexpr int kBf16Blocks = BN <= 32 ? 4 : BN == 64 ? 3 : 2;
  static constexpr int kSplitFit =
      (int)(kSmemPerSm / (smem_bytes(kStageBytes, kMaxStages < 2 ? kMaxStages : 2, kSplitBytes) + kSmemPerBlock));
  static constexpr int kMinBlocks =
      kPieces == 0 ? kBf16Blocks : kSplitFit < 1 ? 1 : kSplitFit < kBf16Blocks ? kSplitFit : kBf16Blocks;
  static_assert(BN <= 32 || kPieces == 0 || kSplitBytes >= kStageCols * kStageLd * (int)sizeof(float),
                "the staged outputs fit the pieces' buffers");
};

struct Args {
  int B, KI, O;
  int stages, chunks, m_tiles, b_tiles, tma_w, tma_x, fault;
  long long items;   // (64-row tile, batch tile, node) work items, tiles fastest
};

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

// B2t's bf16 x chunk scaled and rounded in place: q = bf16(x * scale), o =
// k0 .. k0 + 63 (units past O hold zeros; their scale is not read). Thread
// tid takes the 16-byte units p = tid + 128 i: row b = p / 8 and, under the
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

// 8 consecutive elements of a raw f32 or f16 chunk (16-byte aligned) as f32
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src), b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const f16* src, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(&a);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&words[e]));
    v[2 * e] = f.x, v[2 * e + 1] = f.y;
  }
}

// 8 f32 rounded to bf16 as one 16-byte unit; with REST, each value left
// less its rounding (exact in f32: the bits below the bf16's)
template <bool REST>
__device__ __forceinline__ uint4 round8(float (&v)[8]) {
  uint4 w;
  uint32_t* words = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    words[e] = *reinterpret_cast<const uint32_t*>(&h);
    if (REST) {
      const float2 f = __bfloat1622float2(h);
      v[2 * e] -= f.x, v[2 * e + 1] -= f.y;
    }
  }
  return w;
}

// An f32 or f16 x chunk that landed raw (BN rows of 64 elements) written as
// the wgmma's K-major B under the 128-byte swizzle, PIECES tiles of BN rows
// of 64 bf16 at dst: B2's pieces of x (hi, mid, lo), B2t's q = bf16(x *
// scale) for o = k0 .. k0 + 63 (columns past O hold zeros; their scale is
// not read). Thread tid takes the 16-byte units p = tid + 128 i of each
// tile: row b = p / 8, the 8 columns 8 (p % 8) .. of the chunk, so it reads
// its 8 scales once.
template <int BN, bool TRANS, int PIECES, typename XT>
__device__ __forceinline__ void split_chunk(const XT* raw, unsigned char* dst, const float* sn, int k0, int O,
                                            int tid) {
  if (tid >= BN * 8) return;
  const int u = tid % 8;
  float s[8];
  if constexpr (TRANS) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = k0 + 8 * u + e < O ? sn[k0 + 8 * u + e] : 0.f;
  }
  for (int p = tid; p < BN * 8; p += kConsumers) {
    const int b = p / 8, at = b * 128 + ((u ^ (b % 8)) * 16);
    float v[8];
    load8(raw + b * kChunk + 8 * u, v);
    if constexpr (TRANS) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= s[e];
    }
#pragma unroll
    for (int piece = 0; piece < PIECES; ++piece)
      *reinterpret_cast<uint4*>(dst + piece * BN * 128 + at) =
          piece + 1 < PIECES ? round8<true>(v) : round8<false>(v);
  }
}

template <typename OT>
__device__ __forceinline__ OT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 to_out<bf16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ f16 to_out<f16>(float v) { return __float2half_rn(v); }

// 16 bytes of outputs (4 f32, or 8 bf16 or f16) from the staged f32 at src
__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void store16(bf16* dst, const float* src) {
  const float4 v0 = *reinterpret_cast<const float4*>(src), v1 = *reinterpret_cast<const float4*>(src + 4);
  __nv_bfloat162 p[4] = {__floats2bfloat162_rn(v0.x, v0.y), __floats2bfloat162_rn(v0.z, v0.w),
                         __floats2bfloat162_rn(v1.x, v1.y), __floats2bfloat162_rn(v1.z, v1.w)};
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void store16(f16* dst, const float* src) {
  const float4 v0 = *reinterpret_cast<const float4*>(src), v1 = *reinterpret_cast<const float4*>(src + 4);
  __half2 p[4] = {__floats2half2_rn(v0.x, v0.y), __floats2half2_rn(v0.z, v0.w), __floats2half2_rn(v1.x, v1.y),
                  __floats2half2_rn(v1.z, v1.w)};
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
}

// The item's (64 rows M at m0) x (BN columns at b0) outputs from the
// accumulators, B2's scaled by s: BN <= 32 straight from the registers
// (each warp store fills whole 32-byte sectors of f32, or half of bf16 or
// f16 twice over); wider tiles through shared memory 32 columns at a time,
// so that they leave as 16-byte stores along M.
template <int BN, typename OT>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], const float (&s)[2], float* stg, OT* out,
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
        out[((size_t)n * B + b) * M + m] = to_out<OT>(val);
      }
  } else {
    constexpr int kVec = 16 / sizeof(OT);   // outputs of one 16-byte store
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
          store16(out + at, src);
        } else {
          for (int e = 0; e < kVec && m + e < M; ++e) out[at + e] = to_out<OT>(src[e]);
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

template <typename XT>
__device__ __forceinline__ XT zero_of() {
  if constexpr (std::is_same<XT, float>::value)
    return 0.f;
  else if constexpr (std::is_same<XT, f16>::value)
    return __float2half(0.f);
  else
    return __float2bfloat16(0.f);
}

// w_map: the (O, KI, N) int8 view, box (64 o, 64 ki, 1 n); x_map: the (K, B,
// N) view of x, box (64, BN, 1), K the contraction (KI for B2, O for B2t),
// in bf16 under the 128-byte swizzle, in f32 or f16 raw rows.
template <int BN, bool TRANS, typename XT>
__global__ void __launch_bounds__(kThreads, Tile<BN, TRANS, XT>::kMinBlocks)
q8_kernel(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap x_map,
          const int8_t* __restrict__ wq, const XT* __restrict__ x, const float* __restrict__ scale,
          void* __restrict__ out, Args a) {
  using T = Tile<BN, TRANS, XT>;
  constexpr bool kSplit = T::kPieces > 0;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* abuf = smem;                          // 2 widened weight chunks
  unsigned char* pbuf = abuf + 2 * kABytes;            // 2 sets of the x chunk's pieces (f32 and f16 x)
  unsigned char* ring = pbuf + T::kSplitBytes;         // stages: x chunk, then the int8 chunk
  unsigned char* past = ring + (size_t)a.stages * T::kStageBytes;
  float* stg = reinterpret_cast<float*>(kSplit ? pbuf : past);   // staged outputs
  uint64_t* full = reinterpret_cast<uint64_t*>(kSplit ? past : past + kStageCols * kStageLd * sizeof(float));
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
    const XT zero = zero_of<XT>();
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
            const XT v = b0 + b < a.B && k0 + k < K ? x[((size_t)n * a.B + b0 + b) * K + k0 + k] : zero;
            if constexpr (kSplit)
              reinterpret_cast<XT*>(xs)[q] = v;
            else
              *reinterpret_cast<XT*>(xs + sw128(b * 128 + k * 2)) = v;
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
      unsigned char* pd = pbuf + (g % 2) * (T::kSplitBytes / 2);   // likewise
      const int drop = a.fault == kFaultK16 && c == a.chunks - 1 ? (K - 1) % kChunk / 16 : -1;
      widen_chunk<TRANS>(xs + T::kXBytes, ad, tid, drop);
      if constexpr (kSplit)
        split_chunk<BN, TRANS, T::kPieces>(reinterpret_cast<const XT*>(xs), pd, sn, c * kChunk, a.O, tid);
      else if (TRANS)
        scale_chunk<BN>(xs, sn, c * kChunk, a.O, tid);
      fence_proxy_async();
      consumer_sync();
      // an f32 or f16 stage is read in full: free it before the products run
      if (kSplit && tid == 0) mbar_arrive(empty + st);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        const uint64_t da = TRANS ? desc_sw128(ad + 32 * ks, 16u) : desc_sw128(ad + 2048 * ks, 8192u);
        if constexpr (kSplit) {
#pragma unroll
          for (int piece = 0; piece < T::kPieces; ++piece)
            Wgmma<BN>::template mma_t<TRANS ? 0 : 1, 0>(
                acc, da, desc_sw128(pd + piece * T::kPieceBytes + 32 * ks, 16u), 1);
        } else {
          Wgmma<BN>::template mma_t<TRANS ? 0 : 1, 0>(acc, da, desc_sw128(xs + 32 * ks, 16u), 1);
        }
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();   // the previous chunk's products are done: free its stage
        if (!kSplit && tid == 0) mbar_arrive(empty + (g - 1) % a.stages);
      }
    }
    wgmma_wait<0>();
    if (!kSplit && a.chunks > 0 && tid == 0) mbar_arrive(empty + (g - 1) % a.stages);

    // acc[4 j + v]: row m0 + 16 warp + lane / 4 + 8 (v / 2), column b0 + 8 j
    // + 2 (lane % 4) + v % 2
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * warp + lane / 4 + 8 * h;
      s[h] = !TRANS && m < M ? sn[m] : 1.f;
    }
    if constexpr (kSplit && BN > 32) consumer_sync();   // the staging overwrites the pieces
    using OT = typename std::conditional<TRANS, XT, float>::type;   // B2 writes f32, B2t x's type
    store_tile<BN>(acc, s, stg, static_cast<OT*>(out), n, m0, b0, M, a.B, a.fault, tid);
  }
}

// The batch tile: the narrowest of kBatchTiles that holds B, else the
// widest in as many tiles as B needs: 128 for bf16 x (on an H100 at B =
// 256, 128-column tiles ran 7-16% ahead of one 256-column tile: two blocks
// an SM, where 256 columns leave room for one), 64 for f32 and f16 x
// (whose pieces leave one 128-column block an SM: at B = 256, 64 columns
// ran 8-15% ahead in B2, 28-30% in B2t, tools/ab_node_apply.py's tiles).
inline int choose_bn(int b, bool split) {
  const int widest = split ? 64 : 128;
  for (int bn : kBatchTiles)
    if (b <= bn && bn <= widest) return bn;
  return widest;
}

// Blocks of the kernel one SM holds at `stages` ring stages, and the SMs;
// read once per (instantiation, stages) with the shared-memory limit set
// for the most stages (a process runs the port on one card type).
template <int BN, bool TRANS, typename XT>
cudaError_t residency(int stages, int& blocks) {
  using T = Tile<BN, TRANS, XT>;
  static int per_sm[T::kMaxStages + 1] = {}, sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = allow_smem(q8_kernel<BN, TRANS, XT>, smem_bytes(T::kStageBytes, T::kMaxStages, T::kSplitBytes));
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  if (per_sm[stages] == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[stages], q8_kernel<BN, TRANS, XT>, kThreads, smem_bytes(T::kStageBytes, stages, T::kSplitBytes));
    if (err != cudaSuccess) return err;
    if (per_sm[stages] < 1) return cudaErrorInvalidConfiguration;
  }
  blocks = per_sm[stages] * sms;
  return cudaSuccess;
}

template <typename XT>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<XT, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<XT, f16>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <int BN, bool TRANS, typename XT>
cudaError_t launch(const void* x, const void* wq, const void* scale, void* out, int n, int b, int ki, int o,
                   int fault, cudaStream_t stream) {
  using T = Tile<BN, TRANS, XT>;
  const int K = TRANS ? o : ki, M = TRANS ? ki : o;
  Args a;
  a.B = b, a.KI = ki, a.O = o;
  a.chunks = (K + kChunk - 1) / kChunk;
  a.stages = a.chunks < T::kMaxStages ? a.chunks : T::kMaxStages;
  a.m_tiles = (M + 63) / 64;
  a.b_tiles = (b + BN - 1) / BN;
  a.tma_w = o % 16 == 0;
  a.tma_x = (size_t)K * sizeof(XT) % 16 == 0;
  a.fault = fault;
  a.items = (long long)a.m_tiles * a.b_tiles * n;
  int resident = 0;
  cudaError_t err = residency<BN, TRANS, XT>(a.stages, resident);
  if (err != cudaSuccess) return err;
  if (a.items > resident && a.stages < T::kMaxStages) {
    // blocks walk several items: room for the next item's chunks as well
    a.stages = 2 * a.chunks < T::kMaxStages ? 2 * a.chunks : T::kMaxStages;
    err = residency<BN, TRANS, XT>(a.stages, resident);
    if (err != cudaSuccess) return err;
  }
  // f32 and f16 x: fewer stages where that puts more blocks on each SM
  // (another warpgroup converts while one waits), down to two
  if (T::kPieces > 0 && a.items > resident) {
    for (int stages = a.stages - 1; stages >= 2; --stages) {
      int blocks = 0;
      err = residency<BN, TRANS, XT>(stages, blocks);
      if (err != cudaSuccess) return err;
      if (blocks > resident) a.stages = stages, resident = blocks;
    }
  }
  auto kernel = q8_kernel<BN, TRANS, XT>;
  const size_t smem = smem_bytes(T::kStageBytes, a.stages, T::kSplitBytes);
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
    const cuuint64_t strides[2] = {(cuuint64_t)K * sizeof(XT), (cuuint64_t)b * K * sizeof(XT)};
    const cuuint32_t box[3] = {kChunk, BN, 1};
    err = encode_tiled<3>(&x_map, x, dims, strides, box,
                          T::kPieces > 0 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B, tma_type<XT>());
    if (err != cudaSuccess) return err;
  }
  // persistent blocks: as many as the card holds at once, each walking
  // items, its ring running on from one item into the next
  const unsigned grid = (unsigned)(a.items < resident ? a.items : resident);
  kernel<<<grid, kThreads, smem, stream>>>(w_map, x_map, static_cast<const int8_t*>(wq), static_cast<const XT*>(x),
                                          static_cast<const float*>(scale), out, a);
  return cudaGetLastError();
}

template <bool TRANS, typename XT>
cudaError_t launch_bn(const void* x, const void* wq, const void* scale, void* out, int n, int b, int ki, int o,
                      int bn, int fault, cudaStream_t s) {
  switch (bn) {
    case 8: return launch<8, TRANS, XT>(x, wq, scale, out, n, b, ki, o, fault, s);
    case 16: return launch<16, TRANS, XT>(x, wq, scale, out, n, b, ki, o, fault, s);
    case 24: return launch<24, TRANS, XT>(x, wq, scale, out, n, b, ki, o, fault, s);
    case 32: return launch<32, TRANS, XT>(x, wq, scale, out, n, b, ki, o, fault, s);
    case 64: return launch<64, TRANS, XT>(x, wq, scale, out, n, b, ki, o, fault, s);
    case 128: return launch<128, TRANS, XT>(x, wq, scale, out, n, b, ki, o, fault, s);
    default: return cudaErrorInvalidValue;
  }
}

// Launches B2 (TRANS = false) or B2t on `stream` at the batch tile bn (0:
// choose_bn(b); else one of kBatchTiles) with `fault` planted (0: none) and
// x of element type x_type (kTypeBf16, kTypeF32 or kTypeF16; B2 writes f32,
// B2t x_type); returns cudaGetLastError() after the launch, or the error of
// a TMA view that cannot be encoded. An empty contraction writes zeros.
template <bool TRANS>
cudaError_t launch_q8(const void* x, const void* wq, const void* scale, void* out, int n, int b, int ki, int o,
                      int bn, int fault, int x_type, cudaStream_t s) {
  if (x_type < kTypeBf16 || x_type > kTypeF16) return cudaErrorInvalidValue;
  if (n == 0 || b == 0 || (TRANS ? ki : o) == 0) return cudaSuccess;
  if ((TRANS ? o : ki) == 0)
    return cudaMemsetAsync(out, 0, (size_t)n * b * (TRANS ? ki : o) * (!TRANS || x_type == kTypeF32 ? 4 : 2), s);
  if (bn == 0) bn = choose_bn(b, x_type != kTypeBf16);
  switch (x_type) {
    case kTypeBf16: return launch_bn<TRANS, bf16>(x, wq, scale, out, n, b, ki, o, bn, fault, s);
    case kTypeF32: return launch_bn<TRANS, float>(x, wq, scale, out, n, b, ki, o, bn, fault, s);
    default: return launch_bn<TRANS, f16>(x, wq, scale, out, n, b, ki, o, bn, fault, s);
  }
}

}  // namespace
}  // namespace q8_sm90
