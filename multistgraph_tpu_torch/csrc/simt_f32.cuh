// The f32 mainloop of the block-sparse products, shared by the f32 forms of
// band_spmm.cu (B7, B8, B9 dX) and bsr_spmm.cu (B4/B6), as wgmma_sm90.cuh
// serves their bf16 forms.
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

}  // namespace simt_f32
