// Sampled dense-dense matmul (the SDDMM core) for Hopper (sm_90a).
//
//   out[p, i, j] = sum_k a[row_of[p]*128 + i, k] * bt[col_of[p]*128 + j, k]
//
// i.e. (A B^T) evaluated only at the graph's nonzero 128x128 blocks. a
// (n_a,d) and bt (n_b,d) row-major with n_a, n_b multiples of 128,
// row_of/col_of (nnz) int32, out (nnz,128,128); all contiguous. Taking the
// second operand as rows of length d keeps every read contiguous: the
// backward's x and the forward's transposed node embeddings come that way.
// f32 operands give f32 tiles (sampled_matmul_fwd); bf16 operands give bf16
// tiles (sampled_matmul_bf16), f32 sums rounded once, as the Pallas kernel
// emits the operands' dtype for bf16 (each tile is written once).
//
// Replaces the Pallas kernel multistgraph_tpu/ops/spmm.py:_sampled_matmul_impl
// (_sampled_kernel), which takes b as (d, n) and computes A B.
//
// f32 operands. Bound on an H100: bytes at small d, operations at large d.
// At the 49,152-node graph (4,946 tiles) the forward (d=16) writes 324 MB,
// 0.10 ms at 3.35 TB/s against 2.6 GFLOP; the backward at d=1536 is 249
// GFLOP, 3.7 ms at the 67 TFLOP/s f32 peak. This first design is plain f32
// FMAs: one thread block per nonzero tile; it loops over d in chunks of 32,
// staging the 128x32 slices of both operands in shared memory (rows padded
// to 33 floats, so neither the staging nor the reads conflict on banks),
// and each of the 256 threads keeps an 8x8 grid of the tile (rows ty+16j,
// columns tx+16l) in registers and writes it once. Tensor cores and
// pipelined loads come later.
//
// bf16 operands: tensor cores, the design of band_spmm.cu's dV
// (band_dv_tc_kernel) on one tile a block. Bound on an H100: the 162 MB of
// bf16 tiles it writes at 49,152 nodes, 0.049 ms, up to d of about 300; at
// d=1536 the 249 GFLOP, 0.25 ms at 989 TFLOP/s. One block per nonzero tile
// has two consumer warpgroups of 64 output rows and one producer warp,
// which streams a[row_of[p]] and bt[col_of[p]] (128 rows each) in K = 64
// chunks of d through a two-stage mbarrier ring, both K-major under the
// 128-byte swizzle: by TMA where d % 8 == 0 (features past d land as zeros,
// so a d of 24 is exact in its second k16 slice), else by element loads
// with zeros past d. wgmma m64n128k16 keeps the f32 sums in registers,
// over all four k16 slices of a chunk (past d they add zeros: a product
// skipped under a branch made ptxas serialize the wgmma); each warp's 16
// rows are rounded to bf16 and staged in shared memory, then leave in
// 16-byte stores along whole rows. The fault argument plants a fault (a k16
// slice dropped, a tile skipped, the tiles of row block 0 zeroed) for checks
// that must catch one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kChunk = 32;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPer = kBlock / 16;  // 8 rows and 8 columns per thread

__global__ void __launch_bounds__(kThreads)
sampled_matmul_kernel(const float* __restrict__ a, const float* __restrict__ bt,
                      const int* __restrict__ row_of, const int* __restrict__ col_of,
                      float* __restrict__ out, int d) {
  __shared__ float as[kBlock][kChunk + 1];
  __shared__ float bs[kBlock][kChunk + 1];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* ab = a + (size_t)row_of[p] * kBlock * d;
  const float* bb = bt + (size_t)col_of[p] * kBlock * d;

  float acc[kPer][kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int l = 0; l < kPer; ++l) acc[j][l] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    __syncthreads();  // the previous chunk is no longer read
    // a warp reads 32 neighbouring k of one row (zero past d)
    for (int q = tid; q < kBlock * kChunk; q += kThreads) {
      const int row = q / kChunk, k = q % kChunk;
      const bool in = k0 + k < d;
      as[row][k] = in ? ab[(size_t)row * d + k0 + k] : 0.f;
      bs[row][k] = in ? bb[(size_t)row * d + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      float x[kPer], y[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) x[j] = as[ty + 16 * j][k];
#pragma unroll
      for (int l = 0; l < kPer; ++l) y[l] = bs[tx + 16 * l][k];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
#pragma unroll
        for (int l = 0; l < kPer; ++l) acc[j][l] = fmaf(x[j], y[l], acc[j][l]);
    }
  }

  float* o = out + (size_t)p * kBlock * kBlock;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int l = 0; l < kPer; ++l) o[(ty + 16 * j) * kBlock + tx + 16 * l] = acc[j][l];
}

// ---------------------------------------------------------------- bf16 operands: tensor cores

using namespace wgmma_sm90;

// Faults the bf16 kernel plants on request, for checks that must fail it:
constexpr int kFaultK16 = 1;    // the k16 slice holding the last feature dropped
constexpr int kFaultTile = 2;   // tile 0 skipped (written as zeros)
constexpr int kFaultRow = 3;    // the tiles of row block 0 written as zeros

constexpr int kKc = 64;                       // features of one ring stage
constexpr int kStages = 2;
constexpr int kConsumers = 256;               // two warpgroups of 64 output rows
constexpr int kTcThreads = kConsumers + 32;   // and one producer warp
constexpr int kChunk64 = kBlock * kKc;        // elements of one operand's chunk: 128 rows x 64
constexpr int kStageLd = kBlock + 8;          // row stride of the per-warp output staging (conflict-free)
constexpr int kZeroA = 64 * kKc;              // a zero A operand of one warpgroup (the k16 fault reads it)
constexpr size_t kTcSmem = 1024 + ((size_t)kStages * 2 * kChunk64 + kZeroA) * sizeof(__nv_bfloat16) +
                           (size_t)kConsumers / 32 * 16 * kStageLd * sizeof(__nv_bfloat16) +
                           2 * kStages * sizeof(uint64_t);

// Tile p = a[row_of[p]] @ bt[col_of[p]]^T in bf16, p = blockIdx.x. a_map and
// b_map are 2-d views of a and bt under the 128-byte swizzle whose box, 128
// rows of 64 features, lands as K-major cores, where tma (d % 8 == 0); else
// the producer loads elements into the same layout.
__global__ void __launch_bounds__(kTcThreads, 2)
sampled_matmul_tc_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
                         int tma, const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ bt,
                         const int* __restrict__ row_of, const int* __restrict__ col_of,
                         __nv_bfloat16* __restrict__ out, int d, int fault) {
  constexpr int S = kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);   // S chunks of a's rows: 128 x 64
  __nv_bfloat16* bs = as + (size_t)S * kChunk64;                 // S chunks of bt's rows: 128 x 64
  __nv_bfloat16* zeros = bs + (size_t)S * kChunk64;              // kZeroA zeros
  __nv_bfloat16* staged = zeros + kZeroA;                         // 16 x kStageLd outputs a consumer warp
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + (size_t)kConsumers / 32 * 16 * kStageLd);
  uint64_t* empty = full + S;

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int ra = row_of[p], cb = col_of[p];
  const bool skipped = (fault == kFaultTile && p == 0) || (fault == kFaultRow && ra == 0);
  const int n_chunks = skipped ? 0 : (d + kKc - 1) / kKc;
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
    const int lane = tid - kConsumers;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int kc = 0; kc < n_chunks; ++kc) {
      const int st = kc % S;
      if (kc >= S) mbar_wait(empty + st, ((kc / S) & 1) ^ 1);
      __nv_bfloat16* ad = as + (size_t)st * kChunk64;
      __nv_bfloat16* bd = bs + (size_t)st * kChunk64;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_tx(full + st, 2 * kChunk64 * (unsigned)sizeof(__nv_bfloat16));
          tma_load_2d(ad, &a_map, kc * kKc, ra * kBlock, full + st);
          tma_load_2d(bd, &b_map, kc * kKc, cb * kBlock, full + st);
        }
      } else {
        const __nv_bfloat16* ar = a + (size_t)ra * kBlock * d;
        const __nv_bfloat16* br = bt + (size_t)cb * kBlock * d;
        unsigned char* ab = reinterpret_cast<unsigned char*>(ad);
        unsigned char* bb = reinterpret_cast<unsigned char*>(bd);
#pragma unroll 4
        for (int q = lane; q < kChunk64; q += 32) {
          const int i = q / kKc, k = q % kKc, f = kc * kKc + k;
          const int o = sw128(i * 128 + k * 2);
          *reinterpret_cast<__nv_bfloat16*>(ab + o) = f < d ? ar[(size_t)i * d + f] : zero;
          *reinterpret_cast<__nv_bfloat16*>(bb + o) = f < d ? br[(size_t)i * d + f] : zero;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + st);
      }
    }
  } else {
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    // the k16 slice that holds the last feature; past d both operands are
    // zero, so every slice is multiplied and adds nothing there
    const int last_ks = (d - 1) % kKc / 16;
    float acc[kBlock / 2];
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < n_chunks; ++kc) {
      const int st = kc % S;
      mbar_wait(full + st, (kc / S) & 1);
      const unsigned char* ad = reinterpret_cast<const unsigned char*>(as + (size_t)st * kChunk64) + wg * 8192;
      const unsigned char* bd = reinterpret_cast<const unsigned char*>(bs + (size_t)st * kChunk64);
      // the k16 fault reads zeros for that slice: every wgmma still runs
      const int skip = fault == kFaultK16 && kc == n_chunks - 1 ? last_ks : -1;
      const unsigned char* zero_a = reinterpret_cast<const unsigned char*>(zeros);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKc / 16; ++ks)
        Wgmma<kBlock>::mma_t<0, 0>(acc, desc_sw128((ks == skip ? zero_a : ad) + 32 * ks, 16u),
                                   desc_sw128(bd + 32 * ks, 16u), 1);
      wgmma_commit();
      if (kc > 0) {
        wgmma_wait<1>();   // the previous chunk's products are done: free its stage
        if (tid % 128 == 0) mbar_arrive(empty + (kc - 1) % S);
      }
    }
    wgmma_wait<0>();
    // the warp's 16 rows of the tile through shared memory, so that they
    // leave in 16-byte stores along whole rows
    __nv_bfloat16* stage = staged + (size_t)(tid / 32) * 16 * kStageLd;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kBlock / 8; ++j)
        store_pair(stage + (lane / 4 + 8 * h) * kStageLd, 8 * j + 2 * (lane % 4), kBlock, acc[4 * j + 2 * h],
                   acc[4 * j + 2 * h + 1]);
    __syncwarp();
    __nv_bfloat16* tile = out + (size_t)p * kBlock * kBlock + (size_t)(64 * wg + 16 * warp) * kBlock;
    constexpr int kVec = 8, kPerRow = kBlock / kVec;
#pragma unroll 2
    for (int q = lane; q < 16 * kPerRow; q += 32) {
      const int i = q / kPerRow, c = (q % kPerRow) * kVec;
      *reinterpret_cast<uint4*>(tile + (size_t)i * kBlock + c) =
          *reinterpret_cast<const uint4*>(stage + i * kStageLd + c);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int sampled_matmul_fwd(const void* a, const void* bt, const void* row_of,
                                  const void* col_of, void* out, int nnz, int d, void* stream) {
  if (nnz == 0) return (int)cudaSuccess;
  sampled_matmul_kernel<<<(unsigned)nnz, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(bt), static_cast<const int*>(row_of),
      static_cast<const int*>(col_of), static_cast<float*>(out), d);
  return (int)cudaGetLastError();
}

// The bf16 form: a (n_a, d) and bt (n_b, d) bfloat16, out (nnz, 128, 128)
// bfloat16. fault: 0 none, 1 the k16 slice holding the last feature
// dropped, 2 tile 0 skipped, 3 the tiles of row block 0 zeroed. Launches on
// `stream`; returns cudaGetLastError() after the launch, or the error of a
// TMA view that cannot be encoded where d % 8 == 0 (e.g. an operand that is
// not 16-byte aligned).
extern "C" int sampled_matmul_bf16(const void* a, const void* bt, const void* row_of, const void* col_of, void* out,
                                   int nnz, int d, int n_a, int n_b, int fault, void* stream) {
  if (nnz == 0) return (int)cudaSuccess;
  cudaError_t err = allow_smem(sampled_matmul_tc_kernel, kTcSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap a_map = {}, b_map = {};
  const int tma = d % 8 == 0;
  if (tma) {
    err = rows_view(&a_map, a, n_a, d, kBlock);
    if (err == cudaSuccess) err = rows_view(&b_map, bt, n_b, d, kBlock);
    if (err != cudaSuccess) return (int)err;
  }
  sampled_matmul_tc_kernel<<<(unsigned)nnz, kTcThreads, kTcSmem, static_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, tma, static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(bt),
      static_cast<const int*>(row_of), static_cast<const int*>(col_of), static_cast<__nv_bfloat16*>(out), d, fault);
  return (int)cudaGetLastError();
}
