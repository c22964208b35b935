// Block-sparse (BSR) SpMM for Hopper (sm_90a): Y = A X.
//
//   out[r*128 + i, f] = sum_{p in row_ptr[r] .. row_ptr[r+1]) sum_k
//                       values[p, i, k] * x[col_of[p]*128 + k, f]
//
// values (nnz,128,128) in row-major block order, row_ptr (out_blocks+1)
// int32 CSR-of-blocks offsets, col_of (nnz) int32, x (n_in,F) with n_in a
// multiple of 128, out (out_blocks*128,F) f32; all contiguous. values and x
// are both float32 (bsr_spmm_fwd) or both bfloat16 (bsr_spmm_bf16); the
// sums are f32 either way, as the Pallas kernels accumulate with
// preferred_element_type=f32 and return f32 for bf16 operands. Any F >= 1.
// A row block with no nonzero tile gets zeros.
//
// Replaces two Pallas kernels that compute the same function:
// multistgraph_tpu/ops/spmm.py:_spmm_blockgrid (_spmm_kernel, one grid step
// per nonzero block) and multistgraph_tpu/ops/spmm_stream.py:spmm_stream
// (_stream_kernel, one grid step per output row block). The JAX package
// chooses between them by a TPU rule (128-lane DMA slices); here one kernel
// takes every width.
//
// f32 operands. Bound on an H100: operations from F of about 40 up. At the
// 49,152-node graph (4,946 tiles) and F=128 one call is 20.7 GFLOP, 0.31 ms
// at the 67 TFLOP/s f32 peak, against 0.10 ms for its ~350 MB at 3.35 TB/s;
// at F=16 or 24 the 324 MB of tiles bound it. This first design is plain
// f32 FMAs, right before fast: one thread block per (output row block,
// feature tile of 16*TN columns, TN in {1,2,4,8} chosen by F). The block
// walks its row's tiles in order, staging each 128x128 tile in four 128x32
// chunks together with the matching 32 rows of the gathered x tile in
// shared memory; each of the 256 threads keeps 8 rows x TN columns of the
// output in registers for the whole row and writes them once: no atomics.
// Feature tiles are the fastest grid index, so the blocks of one row run
// together and reread its tiles from L2. Tensor cores (TF32 would move the
// f32 results past the parity bounds), cp.async/TMA pipelining and wgmma
// come later.
//
// bf16 operands: tensor cores, the design of band_spmm.cu's forward
// (band_spmm_tc_kernel) with the x block taken from col_of[p] and the
// row's tiles from row_ptr. Bound on an H100: at 49,152 nodes the 162 MB of
// bf16 tiles (plus x and the f32 output) bound it up to F of about 300, 0.060
// ms at F=128 against 0.021 ms for its 20.7 GFLOP at 989 TFLOP/s; at F=1536
// the 249 GFLOP (0.25 ms). One block per (output row block, N = 16-256
// feature columns: the narrowest of 16, 24, 32, 64, 128 and 256 that holds
// F, else 256) has two consumer warpgroups of 64 output rows and one
// producer warp. The producer walks row_ptr[r] .. row_ptr[r+1] and streams
// each tile's product in K = 64 chunks through an mbarrier ring (3-4
// stages): the tile's 128 x 64 chunk by TMA as K-major A, and x's 64 rows
// of block col_of[p] as MN-major B, by TMA where F % 8 == 0 (zero past F),
// else by element loads (a row of F = 12 is 24 bytes: no 16-byte copy fits
// it), every operand under the 128-byte swizzle. wgmma m64nNk16 keeps the
// f32 sums in registers for the whole row; they are stored once as f32: no
// atomics, and zeros for an empty row. A product of two bf16 values is exact
// in f32, so the kernel and the plain version differ only in the order of
// f32 sums. Each chunk's four k16 products go out while the previous
// chunk's finish, whose stage is then released. The backward's dX reaches
// the same kernel through the block-transposed tiles (bsr_transpose). Rows
// that hold many tiles (the transposed graph's hub columns) run on one block
// each: splitting them over blocks is later work. The fault argument plants
// a fault (a k16 slice dropped, a tile skipped, a row block zeroed) for
// checks that must catch one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

constexpr int kBlock = 128;                 // BSR tile edge
constexpr int kChunk = 32;                  // k rows staged per pass
constexpr int kThreads = 256;               // 16 x 16 threads
constexpr int kRowsPerThread = kBlock / 16; // 8

template <int TN>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const float* __restrict__ values, const int* __restrict__ row_ptr,
                const int* __restrict__ col_of, const float* __restrict__ x,
                float* __restrict__ out, int F) {
  constexpr int FT = 16 * TN;                 // feature columns per block
  constexpr int W = TN < 4 ? TN : 4;          // contiguous columns per thread group
  __shared__ float vs[kBlock][kChunk + 1];    // tile chunk: 128 rows x 32 k (padded)
  __shared__ __align__(16) float xs[kChunk][FT];

  const int r = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[kRowsPerThread][TN];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
    for (int l = 0; l < TN; ++l) acc[j][l] = 0.f;

  const int start = row_ptr[r], end = row_ptr[r + 1];
  for (int p = start; p < end; ++p) {
    const float* v = values + (size_t)p * kBlock * kBlock;
    const float* xb = x + (size_t)col_of[p] * kBlock * F;
    for (int k0 = 0; k0 < kBlock; k0 += kChunk) {
      __syncthreads();  // the previous chunk is no longer read
      // the tile's columns k0..k0+31: 8 float4 per row, neighbouring
      // threads on neighbouring addresses
      for (int q = tid; q < kBlock * kChunk / 4; q += kThreads) {
        const int row = q / (kChunk / 4), c = 4 * (q % (kChunk / 4));
        const float4 w = *reinterpret_cast<const float4*>(v + (size_t)row * kBlock + k0 + c);
        vs[row][c] = w.x;
        vs[row][c + 1] = w.y;
        vs[row][c + 2] = w.z;
        vs[row][c + 3] = w.w;
      }
      // x rows k0..k0+31 of the column block, columns f0..f0+FT-1 (zero past F)
      for (int q = tid; q < kChunk * FT; q += kThreads) {
        const int k = q / FT, c = q % FT;
        const int f = f0 + c;
        xs[k][c] = f < F ? xb[(size_t)(k0 + k) * F + f] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kChunk; ++k) {
        float a[kRowsPerThread], b[TN];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) a[j] = vs[ty + 16 * j][k];
#pragma unroll
        for (int l = 0; l < TN; ++l) b[l] = xs[k][(l / W) * 16 * W + tx * W + l % W];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
          for (int l = 0; l < TN; ++l) acc[j][l] = fmaf(a[j], b[l], acc[j][l]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    float* o = out + ((size_t)r * kBlock + ty + 16 * j) * F;
#pragma unroll
    for (int l = 0; l < TN; ++l) {
      const int f = f0 + (l / W) * 16 * W + tx * W + l % W;
      if (f < F) o[f] = acc[j][l];
    }
  }
}

template <int TN>
cudaError_t launch(const float* values, const int* row_ptr, const int* col_of, const float* x,
                   float* out, int out_blocks, int F, cudaStream_t stream) {
  const dim3 grid((unsigned)((F + 16 * TN - 1) / (16 * TN)), (unsigned)out_blocks);
  bsr_spmm_kernel<TN><<<grid, kThreads, 0, stream>>>(values, row_ptr, col_of, x, out, F);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 operands: tensor cores

using namespace wgmma_sm90;

// Faults the bf16 kernel plants on request, for checks that must fail it:
constexpr int kFaultK16 = 1;    // the k16 slice holding each tile's last contraction element dropped
constexpr int kFaultTile = 2;   // each row block's last tile skipped
constexpr int kFaultRow = 3;    // row block 0 written as zeros

constexpr int kKc = 64;                       // contraction rows of one ring stage
constexpr int kConsumers = 256;               // two warpgroups of 64 output rows
constexpr int kTcThreads = kConsumers + 32;   // and one producer warp
constexpr int kChunkA = kBlock * kKc;         // elements of a stage's tile chunk
constexpr int kZeroA = 64 * kKc;              // a zero A operand of one warpgroup (the k16 fault reads it)

template <int BN>
struct TcTile {
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kMinBlocks = BN == 256 ? 1 : 2;   // blocks an SM: shared memory and registers allow
  static constexpr int kWidthB = BN < 64 ? 64 : BN;      // columns of an x chunk: whole 128-byte rows
  static constexpr int kChunkB = kKc * kWidthB;
  static constexpr size_t kSmem = 1024 + (size_t)(kStages * (kChunkA + kChunkB) + kZeroA) * sizeof(__nv_bfloat16) +
                                  2 * kStages * sizeof(uint64_t);
};

// The tiles of row block r that the block multiplies: [start, end).
__device__ __forceinline__ int2 row_tiles(const int* row_ptr, int r, int fault) {
  int start = row_ptr[r], end = row_ptr[r + 1];
  if (fault == kFaultTile && end > start) --end;
  if (fault == kFaultRow && r == 0) end = start;
  return make_int2(start, end);
}

// out[r][:, f0 .. f0 + BN] for r = blockIdx.y, f0 = BN blockIdx.x. v_map is a
// 2-d view (nnz 128, 128) of the tiles under the 128-byte swizzle whose box
// is a 64-wide chunk of a tile's 128 rows (K-major A, rows of 64 k); x_map
// views x (n_in, F) likewise, a box 64 rows by 64 columns (MN-major B), one
// for each 64 of the chunk's columns, where tma_x (F % 8 == 0); else the
// producer loads elements into the same layout.
template <int BN>
__global__ void __launch_bounds__(kTcThreads, TcTile<BN>::kMinBlocks)
bsr_spmm_tc_kernel(const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap x_map, int tma_x,
                   const int* __restrict__ row_ptr, const int* __restrict__ col_of,
                   const __nv_bfloat16* __restrict__ x, float* __restrict__ out, int F, int fault) {
  using Tile = TcTile<BN>;
  constexpr int S = Tile::kStages;
  constexpr int kBlocksB = Tile::kWidthB / 64;   // 64-column blocks of an x chunk
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);          // S tile chunks: 128 x 64
  __nv_bfloat16* bs = as + (size_t)S * kChunkA;                         // S x chunks: 64 x kWidthB
  __nv_bfloat16* zeros = bs + (size_t)S * Tile::kChunkB;                // kZeroA zeros
  uint64_t* full = reinterpret_cast<uint64_t*>(zeros + kZeroA);
  uint64_t* empty = full + S;

  const int r = blockIdx.y, f0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int2 tiles = row_tiles(row_ptr, r, fault);
  if (fault == kFaultK16) {
    for (int q = tid; q < kZeroA / 8; q += kTcThreads) reinterpret_cast<uint4*>(zeros)[q] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2);   // one arrival per consumer warpgroup
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: chunk g is the kc-th half of the row's (g/2)-th tile
    const int lane = tid - kConsumers;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    int g = 0;
    for (int p = tiles.x; p < tiles.y; ++p) {
      const int src = col_of[p];
      for (int kc = 0; kc < kBlock / kKc; ++kc, ++g) {
        const int st = g % S;
        if (g >= S) mbar_wait(empty + st, ((g / S) & 1) ^ 1);
        __nv_bfloat16* ad = as + (size_t)st * kChunkA;
        __nv_bfloat16* bd = bs + (size_t)st * Tile::kChunkB;
        const int k0 = src * kBlock + kc * kKc;   // x's first row of the chunk
        if (!tma_x) {
          // element (k, c) of the chunk, zero past F, at its swizzled place
          unsigned char* bb = reinterpret_cast<unsigned char*>(bd);
#pragma unroll 4
          for (int q = lane; q < kKc * BN; q += 32) {
            const int k = q / BN, c = q - k * BN, f = f0 + c;
            *reinterpret_cast<__nv_bfloat16*>(bb + (c / 64) * 8192 + sw128(k * 128 + (c % 64) * 2)) =
                f < F ? x[(size_t)(k0 + k) * F + f] : zero;
          }
          fence_proxy_async();
          __syncwarp();
        }
        if (lane == 0) {
          mbar_arrive_tx(full + st, (kChunkA + (tma_x ? Tile::kChunkB : 0)) * (unsigned)sizeof(__nv_bfloat16));
          tma_load_2d(ad, &v_map, kc * kKc, p * kBlock, full + st);
          if (tma_x)
            for (int j = 0; j < kBlocksB; ++j) tma_load_2d(bd + j * 64 * kKc, &x_map, f0 + 64 * j, k0, full + st);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns output rows 64 wg .. 64 wg + 63
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int g = 0;
    for (int p = tiles.x; p < tiles.y; ++p) {
      for (int kc = 0; kc < kBlock / kKc; ++kc, ++g) {
        const int st = g % S;
        mbar_wait(full + st, (g / S) & 1);
        // the warpgroup's 64 rows of the tile chunk: 8 KB, K-major (64 rows of 64 k)
        const unsigned char* ad = reinterpret_cast<const unsigned char*>(as + (size_t)st * kChunkA) + wg * 8192;
        const unsigned char* bd = reinterpret_cast<const unsigned char*>(bs + (size_t)st * Tile::kChunkB);
        // the k16 fault reads zeros for the chunk's last slice: every wgmma still runs
        const unsigned char* a_last = fault == kFaultK16 && kc == kBlock / kKc - 1
                                          ? reinterpret_cast<const unsigned char*>(zeros) : ad;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kKc / 16; ++ks)
          Wgmma<BN>::template mma_t<0, 1>(acc, desc_sw128((ks == kKc / 16 - 1 ? a_last : ad) + 32 * ks, 16u),
                                          desc_sw128(bd + 2048 * ks, 8192u), 1);
        wgmma_commit();
        if (g > 0) {
          wgmma_wait<1>();   // the previous chunk's products are done: free its stage
          if (tid % 128 == 0) mbar_arrive(empty + (g - 1) % S);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = out + ((size_t)r * kBlock + 64 * wg + 16 * warp + lane / 4 + 8 * h) * F + f0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        store_pair(row, 8 * j + 2 * (lane % 4), F - f0, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int BN>
cudaError_t launch_tc(const void* values, const int* row_ptr, const int* col_of, const void* x, float* out,
                      int out_blocks, int F, int nnz, int n_in, int fault, cudaStream_t stream) {
  auto kernel = bsr_spmm_tc_kernel<BN>;
  const size_t smem = TcTile<BN>::kSmem;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap v_map = {}, x_map = {};
  err = rows_view(&v_map, values, nnz * kBlock, kBlock, kBlock);
  if (err != cudaSuccess) return err;
  const int tma_x = F % 8 == 0;
  if (tma_x) {
    err = rows_view(&x_map, x, n_in, F, kKc);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((F + BN - 1) / BN), (unsigned)out_blocks);
  kernel<<<grid, kTcThreads, smem, stream>>>(v_map, x_map, tma_x, row_ptr, col_of,
                                             static_cast<const __nv_bfloat16*>(x), out, F, fault);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int bsr_spmm_fwd(const void* values, const void* row_ptr, const void* col_of,
                            const void* x, void* out, int out_blocks, int feat, void* stream) {
  if (out_blocks == 0 || feat == 0) return (int)cudaSuccess;
  const float* v = static_cast<const float*>(values);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* co = static_cast<const int*>(col_of);
  const float* xx = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (feat <= 16) err = launch<1>(v, rp, co, xx, o, out_blocks, feat, s);
  else if (feat <= 32) err = launch<2>(v, rp, co, xx, o, out_blocks, feat, s);
  else if (feat <= 64) err = launch<4>(v, rp, co, xx, o, out_blocks, feat, s);
  else err = launch<8>(v, rp, co, xx, o, out_blocks, feat, s);
  return (int)err;
}

// The bf16 form: values and x bfloat16, out float32; nnz tiles, x of n_in
// rows. fault: 0 none, 1 the k16 slice holding each tile's last
// contraction element dropped, 2 each row block's last tile skipped, 3 row
// block 0 written as zeros. Launches on `stream`; returns
// cudaGetLastError() after the launch, or the error of a TMA view that
// cannot be encoded (the tiles always, x where F % 8 == 0; e.g. an operand
// that is not 16-byte aligned).
extern "C" int bsr_spmm_bf16(const void* values, const void* row_ptr, const void* col_of, const void* x,
                             void* out, int out_blocks, int feat, int nnz, int n_in, int fault, void* stream) {
  if (out_blocks == 0 || feat == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (nnz == 0)   // every row block is empty: no tile to view
    return (int)cudaMemsetAsync(o, 0, (size_t)out_blocks * kBlock * feat * sizeof(float), s);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* co = static_cast<const int*>(col_of);
  cudaError_t err;
  if (feat <= 16) err = launch_tc<16>(values, rp, co, x, o, out_blocks, feat, nnz, n_in, fault, s);
  else if (feat <= 24) err = launch_tc<24>(values, rp, co, x, o, out_blocks, feat, nnz, n_in, fault, s);
  else if (feat <= 32) err = launch_tc<32>(values, rp, co, x, o, out_blocks, feat, nnz, n_in, fault, s);
  else if (feat <= 64) err = launch_tc<64>(values, rp, co, x, o, out_blocks, feat, nnz, n_in, fault, s);
  else if (feat <= 128) err = launch_tc<128>(values, rp, co, x, o, out_blocks, feat, nnz, n_in, fault, s);
  else err = launch_tc<256>(values, rp, co, x, o, out_blocks, feat, nnz, n_in, fault, s);
  return (int)err;
}
