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
// emits the operands' dtype for bf16 (each tile is written once); f16
// operands give f32 tiles (sampled_matmul_f16), as the Pallas kernel emits
// f32 for every dtype but bf16.
//
// Replaces the Pallas kernel multistgraph_tpu/ops/spmm.py:_sampled_matmul_impl
// (_sampled_kernel), which takes b as (d, n) and computes A B.
//
// f32 operands (sampled_matmul_fwd): the sampled kernel of simt_f32.cuh,
// whose design its comment gives, with this file's tiles (SampledTiles).
// Bound on an H100: bytes at small d, operations at large d. At the
// 49,152-node graph (4,946 tiles) the forward scores (d=16) write 324 MB,
// 0.10 ms at 3.35 TB/s against 2.6 GFLOP; the adaptive dV at d=128 is 20.7
// GFLOP (0.31 ms at the 67 TFLOP/s f32 peak) and at d=1536 249 GFLOP (3.7
// ms), full f32 FMAs on the CUDA cores (TF32 would keep three decimal
// digits). On an H100 80GB HBM3 at 700 W (PERF.md §6): d=16 0.135 ms,
// d=24 0.138, d=128 0.511, d=1536 5.74, against 0.257, 0.260, 0.79 and
// 8.8-8.9 for the design it replaces (one block a tile, 33-float padded
// rows loaded element by element between two barriers a chunk, no
// pipeline, 64 scattered 4-byte stores a thread).
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
// 16-byte stores along whole rows. f16 operands run the same kernel (T =
// __half: f16 TMA views and the f16 wgmma; a product of two f16 values is
// exact in f32) and write f32 tiles straight from the registers: the four
// lanes that hold 8 neighbouring columns of a row store 32 bytes, one whole
// sector, so no staging is needed, and the kernel's shared memory (75 KB
// against bf16's 110 KB) still lets two blocks share an SM. The fault
// argument plants a fault (a k16 slice dropped, a tile skipped, the tiles
// of row block 0 zeroed) for checks that must catch one.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <stdint.h>

#include "simt_f32.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int kBlock = 128;

// Faults the kernels plant on request, for checks that must fail them:
constexpr int kFaultK16 = 1;    // the k16 slice holding the last feature dropped
constexpr int kFaultTile = 2;   // tile 0 skipped (written as zeros)
constexpr int kFaultRow = 3;    // the tiles of row block 0 written as zeros

// f32 operands: tile p = a[row_of[p]] @ bt[col_of[p]]^T, on simt_f32.cuh's
// sampled kernel; a tile that a fault skips is written as zeros.
struct SampledTiles {
  using Out = float;
  const int* row_of;
  const int* col_of;
  float* out;              // (n, 128, 128), viewed as (n 128, 128)
  int n, fault;
  long long view_rows;
  int view_cols;
  __device__ __forceinline__ bool source(int t, int& ar, int& br) const {
    const int r = row_of[t];
    if ((fault == kFaultTile && t == 0) || (fault == kFaultRow && r == 0)) return false;
    ar = r * kBlock;
    br = col_of[t] * kBlock;
    return true;
  }
  __device__ __forceinline__ void store_at(int t, int& c0, int& c1) const {
    c0 = 0;
    c1 = t * kBlock;
  }
};

// ---------------------------------------------------------------- bf16 and f16 operands: tensor cores

using namespace wgmma_sm90;

constexpr int kKc = 64;                       // features of one ring stage
constexpr int kStages = 2;
constexpr int kConsumers = 256;               // two warpgroups of 64 output rows
constexpr int kTcThreads = kConsumers + 32;   // and one producer warp
constexpr int kChunk64 = kBlock * kKc;        // elements of one operand's chunk: 128 rows x 64
constexpr int kStageLd = kBlock + 8;          // row stride of the per-warp output staging (conflict-free)
constexpr int kZeroA = 64 * kKc;              // a zero A operand of one warpgroup (the k16 fault reads it)

// The tiles' type for operands of type T: bf16 for bf16, f32 for f16.
template <typename T>
using TileOut = typename std::conditional<is_f16<T>, float, __nv_bfloat16>::type;

// Shared memory of the kernel on T: the ring, the zero operand, the bf16
// tiles' per-warp staging (f32 tiles need none) and the barriers.
template <typename T>
constexpr size_t tc_smem() {
  return 1024 + ((size_t)kStages * 2 * kChunk64 + kZeroA) * sizeof(T) +
         (is_f16<T> ? 0 : (size_t)kConsumers / 32 * 16 * kStageLd * sizeof(__nv_bfloat16)) +
         2 * kStages * sizeof(uint64_t);
}

// Tile p = a[row_of[p]] @ bt[col_of[p]]^T in TileOut<T>, p = blockIdx.x, T
// the operands' 16-bit type. a_map and b_map are 2-d views of a and bt under
// the 128-byte swizzle whose box, 128 rows of 64 features, lands as K-major
// cores, where tma (d % 8 == 0); else the producer loads elements into the
// same layout.
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
sampled_matmul_tc_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
                         int tma, const T* __restrict__ a, const T* __restrict__ bt,
                         const int* __restrict__ row_of, const int* __restrict__ col_of,
                         TileOut<T>* __restrict__ out, int d, int fault) {
  constexpr int S = kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* as = reinterpret_cast<T*>(smem);                             // S chunks of a's rows: 128 x 64
  T* bs = as + (size_t)S * kChunk64;                              // S chunks of bt's rows: 128 x 64
  T* zeros = bs + (size_t)S * kChunk64;                           // kZeroA zeros
  // 16 x kStageLd bf16 outputs a consumer warp (bf16 tiles only)
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(zeros + kZeroA);
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + (is_f16<T> ? 0 : (size_t)kConsumers / 32 * 16 * kStageLd));
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
    const T zero = T(0.f);
    for (int kc = 0; kc < n_chunks; ++kc) {
      const int st = kc % S;
      if (kc >= S) mbar_wait(empty + st, ((kc / S) & 1) ^ 1);
      T* ad = as + (size_t)st * kChunk64;
      T* bd = bs + (size_t)st * kChunk64;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_tx(full + st, 2 * kChunk64 * (unsigned)sizeof(T));
          tma_load_2d(ad, &a_map, kc * kKc, ra * kBlock, full + st);
          tma_load_2d(bd, &b_map, kc * kKc, cb * kBlock, full + st);
        }
      } else {
        const T* ar = a + (size_t)ra * kBlock * d;
        const T* br = bt + (size_t)cb * kBlock * d;
        unsigned char* ab = reinterpret_cast<unsigned char*>(ad);
        unsigned char* bb = reinterpret_cast<unsigned char*>(bd);
#pragma unroll 4
        for (int q = lane; q < kChunk64; q += 32) {
          const int i = q / kKc, k = q % kKc, f = kc * kKc + k;
          const int o = sw128(i * 128 + k * 2);
          *reinterpret_cast<T*>(ab + o) = f < d ? ar[(size_t)i * d + f] : zero;
          *reinterpret_cast<T*>(bb + o) = f < d ? br[(size_t)i * d + f] : zero;
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
        Wgmma<kBlock, T>::template mma_t<0, 0>(acc, desc_sw128((ks == skip ? zero_a : ad) + 32 * ks, 16u),
                                               desc_sw128(bd + 32 * ks, 16u), 1);
      wgmma_commit();
      if (kc > 0) {
        wgmma_wait<1>();   // the previous chunk's products are done: free its stage
        if (tid % 128 == 0) mbar_arrive(empty + (kc - 1) % S);
      }
    }
    wgmma_wait<0>();
    if constexpr (is_f16<T>) {
      // f32 tiles from the registers: 32 bytes of a row (a sector) a quad of lanes
      float* rows = out + (size_t)p * kBlock * kBlock + (size_t)(64 * wg + 16 * warp + lane / 4) * kBlock;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j)
          store_pair(rows + 8 * h * kBlock, 8 * j + 2 * (lane % 4), kBlock, acc[4 * j + 2 * h],
                     acc[4 * j + 2 * h + 1]);
      return;
    }
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
    __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(out) + (size_t)p * kBlock * kBlock +
                          (size_t)(64 * wg + 16 * warp) * kBlock;
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

// The f32 form: a (n_a, d) and bt (n_b, d) float32, out (nnz, 128, 128)
// float32; fault as sampled_matmul_bf16's. Launches on `stream`; returns
// cudaGetLastError() after the launch, or the error of a TMA view that
// cannot be encoded where d % 4 == 0 and both operands are 16-byte aligned.
extern "C" int sampled_matmul_fwd(const void* a, const void* bt, const void* row_of, const void* col_of, void* out,
                                  int nnz, int d, int n_a, int n_b, int fault, void* stream) {
  const SampledTiles tiles = {static_cast<const int*>(row_of), static_cast<const int*>(col_of),
                              static_cast<float*>(out), nnz, fault, (long long)nnz * kBlock, kBlock};
  return (int)simt_f32::launch_sampled(static_cast<const float*>(a), n_a, static_cast<const float*>(bt), n_b, tiles,
                                       d, fault, static_cast<cudaStream_t>(stream));
}

// The thread blocks sampled_matmul_fwd launches for nnz tiles.
extern "C" int sampled_matmul_f32_blocks(int nnz) { return simt_f32::sampled_blocks(nnz); }

namespace {

template <typename T>
int launch_tc(const void* a, const void* bt, const void* row_of, const void* col_of, void* out, int nnz, int d,
              int n_a, int n_b, int fault, void* stream) {
  if (nnz == 0) return (int)cudaSuccess;
  auto kernel = sampled_matmul_tc_kernel<T>;
  constexpr size_t smem = tc_smem<T>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap a_map = {}, b_map = {};
  const int tma = d % 8 == 0;
  if (tma) {
    err = rows_view<T>(&a_map, a, n_a, d, kBlock);
    if (err == cudaSuccess) err = rows_view<T>(&b_map, bt, n_b, d, kBlock);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)nnz, kTcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, tma, static_cast<const T*>(a), static_cast<const T*>(bt), static_cast<const int*>(row_of),
      static_cast<const int*>(col_of), static_cast<TileOut<T>*>(out), d, fault);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 form: a (n_a, d) and bt (n_b, d) bfloat16, out (nnz, 128, 128)
// bfloat16. fault: 0 none, 1 the k16 slice holding the last feature
// dropped, 2 tile 0 skipped, 3 the tiles of row block 0 zeroed. Launches on
// `stream`; returns cudaGetLastError() after the launch, or the error of a
// TMA view that cannot be encoded where d % 8 == 0 (e.g. an operand that is
// not 16-byte aligned).
extern "C" int sampled_matmul_bf16(const void* a, const void* bt, const void* row_of, const void* col_of, void* out,
                                   int nnz, int d, int n_a, int n_b, int fault, void* stream) {
  return launch_tc<__nv_bfloat16>(a, bt, row_of, col_of, out, nnz, d, n_a, n_b, fault, stream);
}

// The f16 form: a and bt float16, out (nnz, 128, 128) float32; as the bf16
// form otherwise.
extern "C" int sampled_matmul_f16(const void* a, const void* bt, const void* row_of, const void* col_of, void* out,
                                  int nnz, int d, int n_a, int n_b, int fault, void* stream) {
  return launch_tc<__half>(a, bt, row_of, col_of, out, nnz, d, n_a, n_b, fault, stream);
}
