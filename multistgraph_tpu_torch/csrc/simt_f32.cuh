// The f32 mainloop of the block-sparse products, shared by the f32 forms of
// band_spmm.cu (B7, B8, B9 dX) and bsr_spmm.cu (B4/B6), as wgmma_sm90.cuh
// serves their bf16 forms; and, with both operands K-major, the kernel of
// the sampled products (sampled_f32_kernel below: B5 in sampled_matmul.cu,
// B9 dV in band_spmm.cu).
//
// A thread block computes one output tile out[128, FT] = sum over a list of
// (tile, x block) pairs of A (128 x 128) times B (128 x FT), FT = 16 TN
// feature columns, TN in {1, 2, 4, 8}, in full f32 on the CUDA cores: no
// tensor cores, since TF32 keeps three decimal digits and would break the
// f32 bounds. One producer warp streams each pair in four K = 32 chunks
// (the tile's 128 x 32 chunk and x's 32 x FT rows) through a ring of
// kStages stages in shared memory, each stage with a "full" and an "empty"
// mbarrier, so every chunk's load overlaps the products of the chunks
// before it; 256 consumer threads (16 x 16) each keep 8 rows x TN columns
// of the output in registers for the whole list and store them once.
// Persistent blocks walking the tiles grid-stride ran up to 1.3x slower on
// an H100 than one block a tile, which the card's block scheduler balances
// across uneven lists and keeps in order for L2 reuse.
//
// Two copy paths fill a stage, with the same layout:
//   kTma      lane 0 of the producer issues two TMA boxes that complete on
//             the stage's full barrier (x's rows must be whole 16-byte
//             units: F % 4 == 0 and x 16-byte aligned);
//   kCpAsync  the producer's 32 lanes issue cp.async copies (16 bytes, or
//             4 bytes for x where its rows are not 16-byte units) and
//             arrive on the full barrier as their copies land.
//
// A is read as float4 in both orientations, so neither needs an
// element-wise transpose on the way in:
//   K-major A (the forward: the tile as it lies, k contiguous): a stage is
//     [128 rows][32 k] under the 128-byte swizzle (16-byte unit u of row i
//     at u ^ (i % 8), as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes it). The
//     thread owning rows ty + 16 j reads one float4 of 4 k per row; the
//     four ty of a warp read four distinct units: no bank conflict.
//   MN-major A (dX: the tile read as it lies is A transposed, i contiguous):
//     a stage is [32 k][128 rows]; the thread owning rows 4 ty .. 4 ty + 3
//     and 64 + 4 ty .. reads two float4 per k, a warp 64 contiguous bytes.
// B is [32 k][FT] as x's rows lie; a thread's columns are TN consecutive
// ones (TN = 8: two groups of 4, 64 apart), a warp's eight tx read 128
// contiguous bytes. Per k and thread at TN = 8 that is four 16-byte shared
// loads for 64 FMAs, against 16 four-byte loads in the design this replaces.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace simt_f32 {

using namespace wgmma_sm90;

constexpr int kBlock = 128;                  // tile edge
constexpr int kKc = 32;                      // contraction rows of one ring stage
constexpr int kChunks = kBlock / kKc;        // stages a tile takes
constexpr int kConsumers = 256;              // 16 x 16 threads
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kChunkA = kBlock * kKc;        // floats of a stage's tile chunk (16 KB)

enum Copy { kTma = 0, kCpAsync = 1 };

template <int TN>
struct Ring {
  static constexpr int kFt = 16 * TN;                   // feature columns of a block
  static constexpr int kChunkB = kKc * kFt;             // floats of a stage's x chunk
  static constexpr int kStages = 4;
  // blocks an SM: at TN = 8, 168 registers a thread and 129 KB (two blocks
  // of 3 stages spilled and ran 1.6-1.9x slower on an H100)
  static constexpr int kMinBlocks = TN == 8 ? 1 : 2;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * (kChunkA + kChunkB) * sizeof(float) + 2 * kStages * sizeof(uint64_t);
};

// The feature columns of one block for F columns (the f32 kernels' rule).
__host__ __device__ constexpr int feature_tile(int F) { return F <= 16 ? 16 : F <= 32 ? 32 : F <= 64 ? 64 : 128; }

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
// the barrier's pending count drops by one when this thread's earlier cp.async copies land
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

template <int TN>
struct Stages {
  float* a;            // kStages tile chunks
  float* b;            // kStages x chunks
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ explicit Stages(unsigned char* smem) {
    a = reinterpret_cast<float*>(smem);
    b = a + (size_t)Ring<TN>::kStages * kChunkA;
    full = reinterpret_cast<uint64_t*>(b + (size_t)Ring<TN>::kStages * Ring<TN>::kChunkB);
    empty = full + Ring<TN>::kStages;
  }
  __device__ __forceinline__ float* a_at(int st) const { return a + (size_t)st * kChunkA; }
  __device__ __forceinline__ float* b_at(int st) const { return b + (size_t)st * Ring<TN>::kChunkB; }
};

// Barriers initialised, then one __syncthreads for the whole block.
template <int TN, int COPY>
__device__ __forceinline__ void ring_init(const Stages<TN>& s, int tid) {
  if (tid == 0) {
    for (int i = 0; i < Ring<TN>::kStages; ++i) {
      mbar_init(s.full + i, COPY == kTma ? 1 : 32);   // lane 0's expect_tx, or each lane's copies
      mbar_init(s.empty + i, kConsumers / 32);         // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();
}

// The producer, before filling chunk g: its stage's previous chunk is read.
template <int TN>
__device__ __forceinline__ void producer_acquire(const Stages<TN>& s, int g) {
  constexpr int S = Ring<TN>::kStages;
  if (g >= S) mbar_wait(s.empty + g % S, ((g / S) & 1) ^ 1);
}

// kTma: stage st takes the tile's box at (a0, a1) of a_map and x's box at
// (f0, xr) of x_map; lane 0 issues both.
template <int TN>
__device__ __forceinline__ void fill_tma(const Stages<TN>& s, int st, const CUtensorMap* a_map, int a0, int a1,
                                         const CUtensorMap* x_map, int f0, int xr, int lane) {
  if (lane == 0) {
    mbar_arrive_tx(s.full + st, (unsigned)((kChunkA + Ring<TN>::kChunkB) * sizeof(float)));
    tma_load_2d(s.a_at(st), a_map, a0, a1, s.full + st);
    tma_load_2d(s.b_at(st), x_map, f0, xr, s.full + st);
  }
}

// kCpAsync: stage st takes the tile chunk at `a` (row stride lda: K-major,
// a = &tile[0][k0]; MN-major, a = &tile[k0][0]) and x's 32 rows from `xr`
// (x's row k0 of the pair's block), columns f0 .. f0 + FT, zero past F;
// 16-byte copies of x where x16 (F % 4 == 0, x 16-byte aligned). All 32
// lanes of the producer warp call it.
template <int TN, bool KMAJOR>
__device__ __forceinline__ void fill_cp(const Stages<TN>& s, int st, const float* a, int lda, const float* xr, int F,
                                        int f0, int x16, int lane) {
  constexpr int FT = Ring<TN>::kFt;
  float* ad = s.a_at(st);
  if constexpr (KMAJOR) {
#pragma unroll 4
    for (int q = lane; q < kBlock * 8; q += 32) {
      const int i = q >> 3, u = q & 7;
      cp_async16(ad + i * kKc + 4 * (u ^ (i & 7)), a + (size_t)i * lda + 4 * u, true);
    }
  } else {
#pragma unroll 4
    for (int q = lane; q < kKc * 32; q += 32) {
      const int k = q >> 5, u = q & 31;
      cp_async16(ad + k * kBlock + 4 * u, a + (size_t)k * lda + 4 * u, true);
    }
  }
  float* bd = s.b_at(st);
  if (x16) {
    for (int q = lane; q < kKc * FT / 4; q += 32) {
      const int k = q / (FT / 4), c = 4 * (q % (FT / 4)), f = f0 + c;
      cp_async16(bd + k * FT + c, f < F ? xr + (size_t)k * F + f : xr, f < F);
    }
  } else {
    for (int q = lane; q < kKc * FT; q += 32) {
      const int k = q / FT, c = q % FT, f = f0 + c;
      cp_async4(bd + k * FT + c, f < F ? xr + (size_t)k * F + f : xr, f < F);
    }
  }
  cp_async_mbar_arrive(s.full + st);
}

// The consumer thread's place: 16 x 16 threads, a warp 4 ty by 8 tx.
struct Place {
  int ty, tx;
  __device__ __forceinline__ explicit Place(int tid) {
    const int w = tid >> 5, lane = tid & 31;
    ty = 4 * (w & 3) + (lane >> 3);
    tx = 8 * (w >> 2) + (lane & 7);
  }
};

// Output row of the thread's j-th accumulator row, column of its l-th.
template <bool KMAJOR>
__device__ __forceinline__ int row_of(const Place& p, int j) {
  return KMAJOR ? p.ty + 16 * j : (j < 4 ? 4 * p.ty + j : 64 + 4 * p.ty + j - 4);
}
template <int TN>
__device__ __forceinline__ int col_of(const Place& p, int l) {
  return TN == 8 ? (l < 4 ? 4 * p.tx + l : 64 + 4 * p.tx + l - 4) : TN * p.tx + l;
}

template <int TN>
__device__ __forceinline__ void load_b(float (&b)[TN], const float* row, const Place& p) {
  if constexpr (TN == 8) {
    const float4 lo = *reinterpret_cast<const float4*>(row + 4 * p.tx);
    const float4 hi = *reinterpret_cast<const float4*>(row + 64 + 4 * p.tx);
    b[0] = lo.x, b[1] = lo.y, b[2] = lo.z, b[3] = lo.w, b[4] = hi.x, b[5] = hi.y, b[6] = hi.z, b[7] = hi.w;
  } else if constexpr (TN == 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * p.tx);
    b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
  } else if constexpr (TN == 2) {
    const float2 v = *reinterpret_cast<const float2*>(row + 2 * p.tx);
    b[0] = v.x, b[1] = v.y;
  } else {
    b[0] = row[p.tx];
  }
}

__device__ __forceinline__ float lane4(const float4& v, int i) { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }

// acc[j TN + l] += sum over the stage's first K k of A[row j][k] B[k][col l].
template <int TN, bool KMAJOR, int K = kKc>
__device__ __forceinline__ void mma_chunk(float (&acc)[8 * TN], const float* as, const float* bs, const Place& p) {
  constexpr int FT = Ring<TN>::kFt;
  if constexpr (KMAJOR) {
#pragma unroll
    for (int k4 = 0; k4 < K / 4; ++k4) {
      float4 a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        a[j] = *reinterpret_cast<const float4*>(as + (p.ty + 16 * j) * kKc + 4 * (k4 ^ (p.ty & 7)));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
        load_b<TN>(b, bs + (4 * k4 + kk) * FT, p);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int l = 0; l < TN; ++l) acc[j * TN + l] = fmaf(lane4(a[j], kk), b[l], acc[j * TN + l]);
      }
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kBlock + 4 * p.ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * kBlock + 64 + 4 * p.ty);
      float b[TN];
      load_b<TN>(b, bs + k * FT, p);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int l = 0; l < TN; ++l) {
          acc[u * TN + l] = fmaf(lane4(a0, u), b[l], acc[u * TN + l]);
          acc[(4 + u) * TN + l] = fmaf(lane4(a1, u), b[l], acc[(4 + u) * TN + l]);
        }
    }
  }
}

// The consumer, on chunk g: wait for its stage; after reading it, release it
// (one arrival per warp).
template <int TN>
__device__ __forceinline__ int consumer_acquire(const Stages<TN>& s, int g) {
  constexpr int S = Ring<TN>::kStages;
  mbar_wait(s.full + g % S, (g / S) & 1);
  return g % S;
}
template <int TN>
__device__ __forceinline__ void consumer_release(const Stages<TN>& s, int st, int tid) {
  __syncwarp();
  if ((tid & 31) == 0) mbar_arrive(s.empty + st);
}

// The thread's accumulators into out rows row0 + row_of(j), columns f0 +
// col_of(l) below F; 16-byte stores where four columns are whole.
template <int TN, bool KMAJOR>
__device__ __forceinline__ void store_rows(float* out, int row0, int F, int f0, const float (&acc)[8 * TN],
                                           const Place& p) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* o = out + (size_t)(row0 + row_of<KMAJOR>(p, j)) * F + f0;
    if constexpr (TN >= 4) {
#pragma unroll
      for (int g4 = 0; g4 < TN / 4; ++g4) {
        const int c = col_of<TN>(p, 4 * g4), i = j * TN + 4 * g4;
        if (F % 4 == 0 && f0 + c + 3 < F) {
          *reinterpret_cast<float4*>(o + c) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (f0 + c + u < F) o[c + u] = acc[i + u];
        }
      }
    } else {
#pragma unroll
      for (int l = 0; l < TN; ++l)
        if (f0 + col_of<TN>(p, l) < F) o[col_of<TN>(p, l)] = acc[j * TN + l];
    }
  }
}

// A 2-d view of a row-major (rows, cols) f32 array, cols % 4 == 0, whose box
// is box_cols x box_rows, under the 128-byte swizzle where `swizzle` (then
// box_cols = 32).
inline cudaError_t f32_view(CUtensorMap* map, const void* base, long long rows, int cols, int box_cols, int box_rows,
                            bool swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode_tiled<2>(map, base, dims, strides, box,
                         swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// ---------------------------------------------------------------- the sampled products
//
// out tile (128 x 128) = A B^T, A and B each 128 rows of d features: row
// blocks of row-major (rows, d) arrays, so both operands are K-major and the
// contraction runs along their rows. B5 takes A and B from a and bt at the
// pattern's (row, column) blocks, B9 dV from dy[r] and x[r + o_s]. A
// `Tiles` type names the n tiles and, for tile t, its operands' first rows
// (source(); false where the tile is zero: no mainloop, zeros written) and
// its place in a 2-d view of the output (store_at(): first column and row).
//
// Persistent blocks, one an SM, walk the tiles a grid apart: every tile is
// the same work, and on an H100 one block a tile ran slower at every width
// (PERF.md §6). The producer warp streams each tile's A and B in 32-k
// chunks through the ring, both as [128 rows][32 k] under the 128-byte
// swizzle: by TMA where d % 4 == 0 and both arrays are 16-byte aligned (a
// box past d lands as zeros), else by 4-byte cp.async with zeros past d; it
// runs on into the next tiles while the consumers finish one. Its
// warpgroup hands its registers to the consumers (setmaxnreg: 232 a
// consumer thread, where a 288-thread block gets 168 and spilled).
// Consumer thread (ty, tx) owns rows ty + 16 j and columns tx + 16 l (j, l
// < 8); per 4 k it reads one float4 from each of its 8 A rows, then one
// from each of its 8 B rows in turn, each feeding 32 FMAs: 16 16-byte
// shared loads for 256 FMAs (the design this replaces: 16 4-byte loads for
// 64), a warp's 4 ty and 8 tx hitting distinct 16-byte units under the
// swizzle (no bank conflict). The last chunk skips its groups of 4 k past
// d. The finished tile goes into a staging area of its own, laid out as
// the output view's boxes (32 f32 or 64 bf16 columns by 128 rows, 128-byte
// swizzle), and leaves by TMA stores issued by one thread, which drain
// while the consumers go on to the next tile; they wait only before
// writing the staging again. At d = 16 the tiles' 324 MB then leave at
// ~2.4 TB/s, faster than from the threads' own 16-byte stores.

constexpr int kSampledFaultK16 = 1;     // the 16-k slice holding the last feature dropped; 2, 3: the Tiles' faults
// the consumers and a producer warpgroup, whose first warp loads: 168
// registers a thread at launch; the producer warpgroup gives up all but 40,
// the consumers take 232
constexpr int kSampledThreads = kConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <typename OutT>
struct SampledSmem {
  static constexpr int kBox = 128 / sizeof(OutT);        // columns of an output box: 128-byte rows
  static constexpr int kUnit = 16 / sizeof(OutT);        // elements of a 16-byte unit
  // the ring and its barriers, then the staging from the next 1024-byte boundary
  static constexpr size_t kRing = (size_t)Ring<8>::kStages * (kChunkA + Ring<8>::kChunkB) * sizeof(float) + 1024;
  static constexpr size_t kBytes = 1024 + kRing + (size_t)kBlock * kBlock * sizeof(OutT);
  // element (i, c) of the staged tile: box c / kBox, its row i, 16-byte unit swizzled by i % 8
  static __device__ __forceinline__ int at(int i, int c) {
    return (c / kBox) * (kBlock * kBox) + i * kBox + kUnit * (((c % kBox) / kUnit) ^ (i & 7)) + c % kUnit;
  }
};

// the 256 consumer threads (warps 0-7) meet; the producer warp takes no part
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory"); }

// one bulk tensor store of a 2-d box from shared memory, in this thread's bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0, int c1, const void* src) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(map), "r"(c0),
               "r"(c1), "r"(smem_addr(src))
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// this thread's bulk stores have read their shared memory (READ) or are done
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// kCpAsync for the sampled products: stage st takes 128 rows of `a` and of
// `b` (row stride ld, each pointing at the chunk's first feature), the kn
// features of the chunk below d and zeros past them, each at its swizzled
// place; 4-byte copies, a warp a row. All 32 lanes of the producer warp call it.
__device__ __forceinline__ void fill_cp_kk(const Stages<8>& s, int st, const float* a, const float* b, int ld, int kn,
                                           int lane) {
  float* ad = s.a_at(st);
  float* bd = s.b_at(st);
  const bool in = lane < kn;
#pragma unroll 4
  for (int i = 0; i < kBlock; ++i) {
    const int o = i * kKc + 4 * ((lane >> 2) ^ (i & 7)) + (lane & 3);
    cp_async4(ad + o, in ? a + (size_t)i * ld + lane : a, in);
    cp_async4(bd + o, in ? b + (size_t)i * ld + lane : b, in);
  }
  cp_async_mbar_arrive(s.full + st);
}

// acc[8 j + l] += sum over the stage's k of A[ty + 16 j][k] B[tx + 16 l][k],
// both stages [128 rows][32 k] under the 128-byte swizzle; where MASKED only
// the groups of 4 k whose bit is set in `mask`.
template <bool MASKED>
__device__ __forceinline__ void mma_kk(float (&acc)[64], const float* as, const float* bs, const Place& p,
                                       unsigned mask) {
  const float* ar = as + p.ty * kKc;   // row ty + 16 j is 16 j kKc further, with the same swizzle (ty % 8)
  const float* br = bs + p.tx * kKc;
#pragma unroll
  for (int k4 = 0; k4 < kKc / 4; ++k4) {
    if (MASKED && !((mask >> k4) & 1u)) continue;
    float4 a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = *reinterpret_cast<const float4*>(ar + 16 * j * kKc + 4 * (k4 ^ (p.ty & 7)));
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const float4 b = *reinterpret_cast<const float4*>(br + 16 * l * kKc + 4 * (k4 ^ (p.tx & 7)));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j * 8 + l] = fmaf(lane4(a[j], kk), lane4(b, kk), acc[j * 8 + l]);
    }
  }
}

// Tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... of `tiles`. a_map and
// b_map view a (rows, d) and b (rows, d), their box 32 features by 128 rows
// under the 128-byte swizzle (unused under kCpAsync); o_map views the
// output, its box SampledSmem<Out>::kBox columns by 128 rows under the same
// swizzle. fault 1 drops the 16-k slice holding the last feature; the Tiles
// read their own codes.
template <class Tiles, int COPY>
__global__ void __launch_bounds__(kSampledThreads, 1)
sampled_f32_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
                   const __grid_constant__ CUtensorMap o_map, const float* __restrict__ a,
                   const float* __restrict__ b, const Tiles tiles, int d, int fault) {
  using OutT = typename Tiles::Out;
  using Sm = SampledSmem<OutT>;
  constexpr int S = Ring<8>::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const Stages<8> st(smem);
  OutT* staged = reinterpret_cast<OutT*>(smem + Sm::kRing);
  const int tid = threadIdx.x;
  const int n_chunks = (d + kKc - 1) / kKc;
  ring_init<8, COPY>(st, tid);

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (tid >= kConsumers + 32) return;
    // producer warp: chunk g is the (g % n_chunks)-th 32-k chunk of the (g / n_chunks)-th present tile
    const int lane = tid - kConsumers;
    int g = 0;
    for (int t = blockIdx.x; t < tiles.n; t += gridDim.x) {
      int ar, br;
      if (!tiles.source(t, ar, br)) continue;
      for (int kc = 0; kc < n_chunks; ++kc, ++g) {
        const int stage = g % S, k0 = kc * kKc;
        producer_acquire(st, g);
        if constexpr (COPY == kTma) {
          fill_tma(st, stage, &a_map, k0, ar, &b_map, k0, br, lane);
        } else {
          fill_cp_kk(st, stage, a + (size_t)ar * d + k0, b + (size_t)br * d + k0, d, min(kKc, d - k0), lane);
        }
      }
    }
    if constexpr (COPY == kCpAsync) cp_async_wait<0>();   // no copy outlives its thread
    return;
  }

  // consumers. The groups of 4 k of the last chunk below d, less the k16 fault's slice.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const Place p(tid);
  const int tail = d - (n_chunks - 1) * kKc;   // features of the last chunk, 1 .. 32
  unsigned last = tail >= kKc ? 0xFFu : (1u << ((tail + 3) / 4)) - 1u;
  if (fault == kSampledFaultK16) last &= ~(0xFu << (4 * ((tail - 1) / 16)));
  int g = 0;
  for (int t = blockIdx.x; t < tiles.n; t += gridDim.x) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int ar, br;
    if (tiles.source(t, ar, br)) {
      for (int kc = 0; kc < n_chunks; ++kc, ++g) {
        const int stage = consumer_acquire(st, g);
        const unsigned mask = kc == n_chunks - 1 ? last : 0xFFu;
        if (mask == 0xFFu)
          mma_kk<false>(acc, st.a_at(stage), st.b_at(stage), p, mask);
        else
          mma_kk<true>(acc, st.a_at(stage), st.b_at(stage), p, mask);
        consumer_release(st, stage, tid);
      }
    }
    if (tid == 0) bulk_wait_all<true>();   // the last tile's stores have read the staging
    consumers_sync();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int l = 0; l < 8; ++l) staged[Sm::at(p.ty + 16 * j, p.tx + 16 * l)] = to_out<OutT>(acc[j * 8 + l]);
    fence_proxy_async();   // the staging, written by this thread, is read by TMA
    consumers_sync();
    if (tid == 0) {
      int c0, c1;
      tiles.store_at(t, c0, c1);
#pragma unroll
      for (int q = 0; q < kBlock / Sm::kBox; ++q) tma_store_2d(&o_map, c0 + q * Sm::kBox, c1, staged + q * kBlock * Sm::kBox);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all<false>();
}

// The thread blocks for n tiles: one an SM (each tile is the same work), no
// more than the tiles.
inline int sampled_blocks(int n) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return n;
  return n < sms ? n : sms;
}

// Launches sampled_f32_kernel on `tiles` (none: nothing) of a (a_rows, d)
// and b (b_rows, d), both f32 and contiguous, into the output tiles.out,
// whose 2-d view is tiles.view_rows x tiles.view_cols (row-major,
// contiguous, 16-byte aligned); returns cudaGetLastError() after the launch,
// or the error of a TMA view that cannot be encoded.
template <class Tiles>
cudaError_t launch_sampled(const float* a, long long a_rows, const float* b, long long b_rows, const Tiles& tiles,
                           int d, int fault, cudaStream_t stream) {
  using OutT = typename Tiles::Out;
  if (tiles.n == 0) return cudaSuccess;
  const bool tma = d > 0 && d % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  CUtensorMap a_map = {}, b_map = {}, o_map = {};
  cudaError_t err = cudaSuccess;
  if (tma) {
    err = f32_view(&a_map, a, a_rows, d, kKc, kBlock, true);
    if (err == cudaSuccess) err = f32_view(&b_map, b, b_rows, d, kKc, kBlock, true);
  }
  if (err == cudaSuccess) {
    const cuuint64_t dims[2] = {(cuuint64_t)tiles.view_cols, (cuuint64_t)tiles.view_rows};
    const cuuint64_t strides[1] = {(cuuint64_t)tiles.view_cols * sizeof(OutT)};
    const cuuint32_t box[2] = {(cuuint32_t)SampledSmem<OutT>::kBox, (cuuint32_t)kBlock};
    err = encode_tiled<2>(&o_map, tiles.out, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                          sizeof(OutT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  }
  if (err != cudaSuccess) return err;
  auto kernel = tma ? sampled_f32_kernel<Tiles, kTma> : sampled_f32_kernel<Tiles, kCpAsync>;
  const size_t smem = SampledSmem<OutT>::kBytes;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // setmaxnreg.inc would wait for ever on registers the launch did not give the block
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kSampledThreads < 128 * kProducerRegs + kConsumers * kConsumerRegs)
    return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)sampled_blocks(tiles.n), kSampledThreads, smem, stream>>>(a_map, b_map, o_map, a, b, tiles, d,
                                                                                fault);
  return cudaGetLastError();
}

}  // namespace simt_f32
