// Block-sparse (BSR) SpMM for Hopper (sm_90a): Y = A X.
//
//   out[r*128 + i, f] = sum_{p in row_ptr[r] .. row_ptr[r+1]) sum_k
//                       values[p, i, k] * x[col_of[p]*128 + k, f]
//
// values (nnz,128,128) in row-major block order, col_of (nnz) int32, x
// (n_in,F) with n_in a multiple of 128, out (out_blocks*128,F) f32; all
// contiguous. values and x are both float32 (bsr_spmm_fwd), both bfloat16
// (bsr_spmm_bf16) or both float16 (bsr_spmm_f16); the sums are f32 in
// every case, as the Pallas kernels accumulate with
// preferred_element_type=f32 and return f32 for 16-bit operands. Any F >=
// 1. A row block with no nonzero tile gets zeros.
//
// Replaces two Pallas kernels that compute the same function:
// multistgraph_tpu/ops/spmm.py:_spmm_blockgrid (_spmm_kernel, one grid step
// per nonzero block) and multistgraph_tpu/ops/spmm_stream.py:spmm_stream
// (_stream_kernel, one grid step per output row block). The JAX package
// chooses between them by a TPU rule (128-lane DMA slices); here one kernel
// takes every width.
//
// The segment schedule. A row block's tiles [row_ptr[r], row_ptr[r+1]) are
// cut into segments of at most S tiles (ops/spmm.py:bsr_schedule builds the
// schedule on the card from row_ptr; one row of 8 ints per segment: row,
// first tile, end tile, the segment's index k in its row, the row's
// segment count, the row's first workspace slot; the longest segments
// first), and one thread block runs each (segment, feature tile). The transposed graph of the backward's
// dX holds hub rows of 384 tiles among rows of ~5: one block per row left
// one block per hub row running long after the other ~130 SMs went idle.
// A row of one segment writes its output directly. A split row's segments
// each store their f32 partial tile in the workspace (in the consumers'
// register order: coalesced, no layout to agree on), then count themselves
// on the row's counter (zeroed by the caller); the block that counts last
// sums the row's partials in segment order and writes the output. No atomics
// touch the output, and the order of the sums is fixed: two calls give
// bit-identical results. Padding rows of the schedule (row -1) exit.
//
// f32 operands: full f32 FMAs on the CUDA cores (TF32 would keep three
// decimal digits), on simt_f32.cuh's mainloop, band_spmm.cu's f32 design:
// one block per (segment, feature tile of FT = 16, 32, 64 or 128 columns),
// the schedule's longest segments first; a producer warp streams each tile (K-major, under the 128-byte swizzle) in 32-k chunks,
// with x's 32 matching rows of block col_of[p], through a 4-stage mbarrier
// ring, by TMA where x's rows are whole 16-byte units, else by cp.async;
// 256 consumer threads each keep 8 rows x FT/16 columns in registers, read
// from shared memory as float4.
// Bound on an H100: operations from F of about 40 up. At the 49,152-node
// graph (4,946 tiles) and F=128 one call is 20.7 GFLOP, 0.31 ms at the 67
// TFLOP/s f32 peak, against 0.10 ms for its ~350 MB at 3.35 TB/s; at F=16 or
// 24 the 324 MB of tiles bound it.
//
// bf16 and f16 operands: tensor cores, the design of band_spmm.cu's forward
// (band_spmm_tc_kernel) with the x block taken from col_of[p] and the
// segment's tiles from the schedule. Bound on an H100: at 49,152 nodes the
// 162 MB of bf16 tiles (plus x and the f32 output) bound it up to F of about
// 300, 0.060 ms at F=128 against 0.021 ms for its 20.7 GFLOP at 989
// TFLOP/s; at F=1536 the 249 GFLOP (0.25 ms). One block per (segment, N =
// 16-256 feature columns: the narrowest of 16, 24, 32, 64, 128 and 256 that
// holds F, else 256) has two consumer warpgroups of 64 output rows and one
// producer warp. The producer walks the segment's tiles and streams each
// tile's product in K = 64 chunks through an mbarrier ring (3-4 stages):
// the tile's 128 x 64 chunk by TMA as K-major A, and x's 64 rows of block
// col_of[p] as MN-major B, by TMA where F % 8 == 0 (zero past F), every
// operand under the 128-byte swizzle. A row of F = 12 is 24 bytes, no whole
// 16-byte unit, but a chunk's 64 rows of one x block are one span of 128 F
// bytes, 16-byte aligned where x is: below F = 32 one bulk copy brings it
// into a raw staging of its stage, issued two chunks ahead on a barrier of
// its own, and four producer warps move its elements into the B layout
// (band_spmm.cu's narrow-x design, wgmma_sm90.cuh); else (F % 8 != 0 from 33
// up, or x not 16-byte aligned) the producer warp loads elements, each
// chunk's 64 x BN of them before it can arrive on the stage. The k16
// fault's zero operand is in shared memory only under that fault, so the
// spans' staging keeps two blocks an SM up to F = 31. On an H100 80GB HBM3
// at 700 W at the 49,152-node graph, in turns with the element loads
// (PERF.md §6): F=12 0.080 ms against 0.156 in bf16 and f16 (F=16 0.072),
// F=3 0.084 against 0.130, F=20 0.081 against 0.237, every output bit for
// bit the same. wgmma m64nNk16 keeps the f32 sums in registers for the
// whole segment. A product of two bf16 values, or
// of two f16 values (11-bit significands), is exact in f32, so the kernel
// and the plain version differ only in the order of f32 sums. One kernel
// template serves both types (T = __nv_bfloat16 or __half): the same
// layouts, TMA views of the type's own TMA data type, and the wgmma of its
// type suffix (wgmma_sm90.cuh). Each chunk's four k16 products go out while the
// previous chunk's finish, whose stage is then released. The backward's dX
// reaches the same kernel through the block-transposed tiles
// (bsr_transpose).
//
// The fault argument plants a fault, in either form, for checks that must
// catch one: a k16 slice dropped, a row block's last tile skipped, row
// block 0 zeroed, a split row's last segment left out of its sum.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "simt_f32.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int kBlock = 128;   // BSR tile edge

// Faults either kernel plants on request, for checks that must fail it:
constexpr int kFaultK16 = 1;       // the k16 slice holding each tile's last contraction element dropped
constexpr int kFaultTile = 2;      // each row block's last tile skipped
constexpr int kFaultRow = 3;       // row block 0 written as zeros
constexpr int kFaultSegment = 4;   // a split row's last segment left out of its sum

// One row of the schedule.
struct Segment {
  int row, p0, p1, k, nseg, ws_base;
};

__device__ __forceinline__ Segment load_segment(const int* sched, int j) {
  const int4 a = reinterpret_cast<const int4*>(sched)[2 * j];
  const int4 b = reinterpret_cast<const int4*>(sched)[2 * j + 1];
  return {a.x, a.y, a.z, a.w, b.x, b.y};
}

// The tiles the block multiplies: [x, y).
__device__ __forceinline__ int2 segment_tiles(const Segment& sg, int fault) {
  int start = sg.p0, end = sg.p1;
  if (fault == kFaultTile && sg.k == sg.nseg - 1 && end > start) --end;
  if (fault == kFaultRow && sg.row == 0) end = start;
  return make_int2(start, end);
}

// the 256 consumer threads of a block (the producer warp does not take part)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Consumer thread ctid's NACC sums of the segment, for feature tile fx of
// ftiles. Returns whether this block writes the row's output, acc then
// holding the row's sums: at once for a row of one segment; for a split
// row, after storing its partial and counting itself, only the block that
// counts last, which sums every partial of the row in segment order.
template <int NACC>
__device__ __forceinline__ bool combine_segments(float (&acc)[NACC], const Segment& sg, int fx, int ftiles,
                                                 float* __restrict__ ws, int* __restrict__ counters, int* last,
                                                 int ctid, int fault) {
  if (sg.nseg == 1) return true;
  constexpr int kSlot = NACC * 256;   // floats of one partial
  float* mine = ws + ((size_t)(sg.ws_base + sg.k) * ftiles + fx) * kSlot;
#pragma unroll
  for (int i = 0; i < NACC; ++i) mine[i * 256 + ctid] = acc[i];
  __threadfence();   // the partial is visible to the block that counts last
  consumers_sync();
  if (ctid == 0) *last = atomicAdd(counters + sg.row * ftiles + fx, 1) == sg.nseg - 1;
  consumers_sync();
  if (!*last) return false;
  __threadfence();
  const int n = fault == kFaultSegment ? sg.nseg - 1 : sg.nseg;
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  for (int s = 0; s < n; ++s) {
    const float* part = ws + ((size_t)(sg.ws_base + s) * ftiles + fx) * kSlot;
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += __ldcg(part + i * 256 + ctid);
  }
  return true;
}

// f32 operands, on simt_f32.cuh's mainloop: out[row][:, f0 .. f0 + FT] of
// segment blockIdx.x / ftiles, f0 = FT (blockIdx.x % ftiles): a 1-d grid,
// with no bound on the segments. v_map views the tiles (nnz 128, 128), its
// box 32 k by 128 rows under the 128-byte swizzle; x_map views x (n_in, F),
// its box FT columns by 32 rows; both unused under kCpAsync.
template <int TN, int COPY>
__global__ void __launch_bounds__(simt_f32::kThreads, simt_f32::Ring<TN>::kMinBlocks)
bsr_spmm_f32_kernel(const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap x_map,
                    const float* __restrict__ values, const int* __restrict__ col_of, const float* __restrict__ x,
                    float* __restrict__ out, int F, const int* __restrict__ sched, float* __restrict__ ws,
                    int* __restrict__ counters, int fault, int x16) {
  namespace sf = simt_f32;
  constexpr int FT = sf::Ring<TN>::kFt;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int last;
  const int ftiles = (F + FT - 1) / FT, fx = blockIdx.x % ftiles, f0 = fx * FT;
  const Segment sg = load_segment(sched, blockIdx.x / ftiles);
  if (sg.row < 0) return;   // padding past the schedule's segments
  const sf::Stages<TN> st(wgmma_sm90::aligned_smem(smem_raw));
  const int tid = threadIdx.x;
  const int2 tiles = segment_tiles(sg, fault);
  sf::ring_init<TN, COPY>(st, tid);

  if (tid >= sf::kConsumers) {
    // producer warp: chunk g is the (g % 4)-th 32-k chunk of the segment's (g / 4)-th tile
    const int lane = tid - sf::kConsumers;
    int g = 0;
    for (int p = tiles.x; p < tiles.y; ++p) {
      const int src = col_of[p];
      for (int kc = 0; kc < sf::kChunks; ++kc, ++g) {
        const int stage = g % sf::Ring<TN>::kStages, k0 = kc * sf::kKc;
        sf::producer_acquire(st, g);
        if constexpr (COPY == sf::kTma) {
          sf::fill_tma(st, stage, &v_map, k0, p * kBlock, &x_map, f0, src * kBlock + k0, lane);
        } else {
          sf::fill_cp<TN, true>(st, stage, values + (size_t)p * kBlock * kBlock + k0, kBlock,
                                x + (size_t)(src * kBlock + k0) * F, F, f0, x16, lane);
        }
      }
    }
    if constexpr (COPY == sf::kCpAsync) wgmma_sm90::cp_async_wait<0>();   // no copy outlives its thread
    return;
  }

  const sf::Place pl(tid);
  float acc[8 * TN];
#pragma unroll
  for (int i = 0; i < 8 * TN; ++i) acc[i] = 0.f;
  for (int g = 0; g < (tiles.y - tiles.x) * sf::kChunks; ++g) {
    const int stage = sf::consumer_acquire(st, g);
    if (fault == kFaultK16 && g % sf::kChunks == sf::kChunks - 1)
      sf::mma_chunk<TN, true, sf::kKc - 16>(acc, st.a_at(stage), st.b_at(stage), pl);
    else
      sf::mma_chunk<TN, true>(acc, st.a_at(stage), st.b_at(stage), pl);
    sf::consumer_release(st, stage, tid);
  }
  if (combine_segments(acc, sg, fx, ftiles, ws, counters, &last, tid, fault))
    sf::store_rows<TN, true>(out, sg.row * kBlock, F, f0, acc, pl);
}

template <int TN, int COPY>
cudaError_t launch_f32_tile(const CUtensorMap& v_map, const CUtensorMap& x_map, const float* v, const int* col_of,
                            const float* x, float* out, int F, const int* sched, int n_seg, float* ws, int* counters,
                            int fault, int x16, cudaStream_t stream) {
  auto kernel = bsr_spmm_f32_kernel<TN, COPY>;
  const size_t smem = simt_f32::Ring<TN>::kSmem;
  cudaError_t err = wgmma_sm90::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)n_seg * (unsigned)((F + 16 * TN - 1) / (16 * TN));
  kernel<<<blocks, simt_f32::kThreads, smem, stream>>>(v_map, x_map, v, col_of, x, out, F, sched, ws, counters, fault,
                                                       x16);
  return cudaGetLastError();
}

template <int TN>
cudaError_t launch_f32(const float* v, const int* col_of, const float* x, float* out, int F, int nnz, int n_in,
                       const int* sched, int n_seg, float* ws, int* counters, int fault, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(v) % 16) return cudaErrorMisalignedAddress;   // 16-byte copies of the tiles
  const int x16 = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  CUtensorMap v_map = {}, x_map = {};
  if (x16) {   // TMA: x's rows are whole 16-byte units
    cudaError_t err = simt_f32::f32_view(&v_map, v, (long long)nnz * kBlock, kBlock, simt_f32::kKc, kBlock, true);
    if (err == cudaSuccess) err = simt_f32::f32_view(&x_map, x, n_in, F, 16 * TN, simt_f32::kKc, false);
    if (err != cudaSuccess) return err;
    return launch_f32_tile<TN, simt_f32::kTma>(v_map, x_map, v, col_of, x, out, F, sched, n_seg, ws, counters, fault,
                                               x16, stream);
  }
  return launch_f32_tile<TN, simt_f32::kCpAsync>(v_map, x_map, v, col_of, x, out, F, sched, n_seg, ws, counters,
                                                 fault, x16, stream);
}

// ---------------------------------------------------------------- bf16 and f16 operands: tensor cores

using namespace wgmma_sm90;

constexpr int kKc = 64;                       // contraction rows of one ring stage
constexpr int kConsumers = 256;               // two warpgroups of 64 output rows
constexpr int kChunkA = kBlock * kKc;         // elements of a stage's tile chunk
constexpr int kZeroA = 64 * kKc;              // a zero A operand of one warpgroup (the k16 fault reads it)

template <bool SPAN>
constexpr int tc_threads() { return kConsumers + 32 * (SPAN ? kSpanWarps : 1); }

// the wgmma N a block takes for F columns: the narrowest of 16, 24, 32, 64
// and 128 that holds F, else 256
constexpr int bsr_spmm_tile(int feat) {
  return feat <= 16 ? 16 : feat <= 24 ? 24 : feat <= 32 ? 32 : feat <= 64 ? 64 : feat <= 128 ? 128 : 256;
}

template <int BN>
struct TcTile {
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kMinBlocks = BN == 256 ? 1 : 2;   // blocks an SM: shared memory and registers allow
  static constexpr int kWidthB = BN < 64 ? 64 : BN;      // columns of an x chunk: whole 128-byte rows
  static constexpr int kChunkB = kKc * kWidthB;
  // the ring and its barriers; a launch adds the spans' staging (SPAN) and,
  // under the k16 fault alone, a 1024-byte aligned zero operand
  static constexpr size_t kSmem = 1024 + (size_t)kStages * (kChunkA + kChunkB) * sizeof(__nv_bfloat16) +
                                  2 * kStages * sizeof(uint64_t);
  static constexpr size_t kZeroSmem = 1024 + (size_t)kZeroA * sizeof(__nv_bfloat16);
};

// out[row][:, f0 .. f0 + BN] of segment blockIdx.y, f0 = BN blockIdx.x. v_map is a
// 2-d view (nnz 128, 128) of the tiles under the 128-byte swizzle whose box
// is a 64-wide chunk of a tile's 128 rows (K-major A, rows of 64 k); x_map
// views x (n_in, F) likewise, a box 64 rows by 64 columns (MN-major B), one
// for each 64 of the chunk's columns, where tma_x (F % 8 == 0). Else, in
// the SPAN kernels (F < kSpanMaxF, x 16-byte aligned), the chunk's 64 rows
// of x, rows src 128 + 64 kc on of block col_of[p], one contiguous span of
// 128 F bytes, come by one bulk copy into a raw staging of the stage, on a
// barrier of its own, issued kSpanLag chunks before kSpanWarps producer
// warps move each element to its place in the B layout and arrive on the
// stage's full barrier (band_spmm.cu's design: the consumers' code is the
// TMA path's); else the producer warp loads elements into that layout. T is
// the operands' 16-bit type.
template <int BN, typename T, bool SPAN>
__global__ void __launch_bounds__(tc_threads<SPAN>(), TcTile<BN>::kMinBlocks)
bsr_spmm_tc_kernel(const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap x_map, int tma_x,
                   const int* __restrict__ col_of, const T* __restrict__ x, float* __restrict__ out, int F,
                   const int* __restrict__ sched, float* __restrict__ ws, int* __restrict__ counters, int fault) {
  using Tile = TcTile<BN>;
  constexpr int S = Tile::kStages;
  constexpr int kBlocksB = Tile::kWidthB / 64;   // 64-column blocks of an x chunk
  // a stage is freed once the consumers are past the chunk after its own,
  // whose x goes in kSpanLag chunks after its copy was issued
  static_assert(!SPAN || kSpanLag <= S - 2, "the producer would wait on a stage only it can free");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int last;
  const Segment sg = load_segment(sched, blockIdx.y);
  if (sg.row < 0) return;   // padding past the schedule's segments
  unsigned char* smem = aligned_smem(smem_raw);
  T* as = reinterpret_cast<T*>(smem);                                   // S tile chunks: 128 x 64
  T* bs = as + (size_t)S * kChunkA;                                     // S x chunks: 64 x kWidthB
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + (size_t)S * Tile::kChunkB);
  uint64_t* empty = full + S;
  // SPAN: stage st's bulk copy lands on raw[st], its raw chunk of x (128 F
  // bytes, 16-byte aligned) at spans + st 128 F
  uint64_t* raw = empty + S;
  unsigned char* spans = reinterpret_cast<unsigned char*>(raw + S);
  const unsigned span_bytes = 128u * (unsigned)F;
  // the k16 fault's kZeroA zeros, past everything else, 1024-byte aligned
  T* zeros = reinterpret_cast<T*>(aligned_smem(spans + (SPAN ? S * span_bytes : 0u)));

  const int r = sg.row, f0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int2 tiles = segment_tiles(sg, fault);
  if (fault == kFaultK16) {
    for (int q = tid; q < kZeroA / 8; q += blockDim.x) reinterpret_cast<uint4*>(zeros)[q] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, SPAN ? 1 + kSpanWarps : 1);   // SPAN: the tile's expect_tx, each mover warp's arrival
      mbar_init(empty + i, 2);   // one arrival per consumer warpgroup
      if (SPAN) mbar_init(raw + i, 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: chunk g is the kc-th half of the row's (g/2)-th tile
    const int lane = tid - kConsumers;   // SPAN: 0 .. 32 kSpanWarps, warp 0 the one that issues
    const T zero = T(0.f);
    // SPAN: this warp's part of chunk h's move into the B layout, then its arrival
    auto span_to_b = [&](int h) {
      wgmma_sm90::span_to_b<S>(h, spans, reinterpret_cast<unsigned char*>(bs), Tile::kChunkB * sizeof(T), raw, full,
                               F, lane);
    };
    if (SPAN && lane >= 32) {
      // the other mover warps: every chunk of the segment in turn (its raw
      // barrier completes once warp 0 found the chunk's stage free and issued it)
      for (int h = 0; h < (tiles.y - tiles.x) * (kBlock / kKc); ++h) span_to_b(h);
      return;
    }
    if constexpr (SPAN)   // x's columns F .. BN of every stage stay zero
      span_zero_tail<T, S, BN>(reinterpret_cast<unsigned char*>(bs), Tile::kChunkB * sizeof(T), F, lane);
    int g = 0;
    for (int p = tiles.x; p < tiles.y; ++p) {
      const int src = col_of[p];
      for (int kc = 0; kc < kBlock / kKc; ++kc, ++g) {
        const int st = g % S;
        if (g >= S) mbar_wait(empty + st, ((g / S) & 1) ^ 1);
        T* ad = as + (size_t)st * kChunkA;
        T* bd = bs + (size_t)st * Tile::kChunkB;
        const int k0 = src * kBlock + kc * kKc;   // x's first row of the chunk
        if (!tma_x && !SPAN) {
          // element (k, c) of the chunk, zero past F, at its swizzled place
          unsigned char* bb = reinterpret_cast<unsigned char*>(bd);
#pragma unroll 4
          for (int q = lane; q < kKc * BN; q += 32) {
            const int k = q / BN, c = q - k * BN, f = f0 + c;
            *reinterpret_cast<T*>(bb + (c / 64) * 8192 + sw128(k * 128 + (c % 64) * 2)) =
                f < F ? x[(size_t)(k0 + k) * F + f] : zero;
          }
          fence_proxy_async();
          __syncwarp();
        }
        if (lane == 0) {
          mbar_arrive_tx(full + st, (kChunkA + (tma_x ? Tile::kChunkB : 0)) * (unsigned)sizeof(T));
          tma_load_2d(ad, &v_map, kc * kKc, p * kBlock, full + st);
          if (tma_x)
            for (int j = 0; j < kBlocksB; ++j) tma_load_2d(bd + j * 64 * kKc, &x_map, f0 + 64 * j, k0, full + st);
          if (SPAN) {
            mbar_arrive_tx(raw + st, span_bytes);
            bulk_load(spans + (size_t)st * span_bytes, x + (size_t)k0 * F, span_bytes, raw + st);
          }
        }
        if (SPAN && g >= kSpanLag) span_to_b(g - kSpanLag);
      }
    }
    if constexpr (SPAN)
      for (int h = g > kSpanLag ? g - kSpanLag : 0; h < g; ++h) span_to_b(h);
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
          Wgmma<BN, T>::template mma_t<0, 1>(acc, desc_sw128((ks == kKc / 16 - 1 ? a_last : ad) + 32 * ks, 16u),
                                             desc_sw128(bd + 2048 * ks, 8192u), 1);
        wgmma_commit();
        if (g > 0) {
          wgmma_wait<1>();   // the previous chunk's products are done: free its stage
          if (tid % 128 == 0) mbar_arrive(empty + (g - 1) % S);
        }
      }
    }
    wgmma_wait<0>();
    if (!combine_segments(acc, sg, blockIdx.x, gridDim.x, ws, counters, &last, tid, fault)) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = out + ((size_t)r * kBlock + 64 * wg + 16 * warp + lane / 4 + 8 * h) * F + f0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        store_pair(row, 8 * j + 2 * (lane % 4), F - f0, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int BN, typename T>
cudaError_t launch_tc(const void* values, const int* col_of, const void* x, float* out, int F, int nnz, int n_in,
                      const int* sched, int n_seg, float* ws, int* counters, int fault, cudaStream_t stream) {
  const int tma_x = F % 8 == 0;
  // the spans' staging, S x 128 F bytes, keeps two blocks an SM below kSpanMaxF
  const bool span = !tma_x && F < kSpanMaxF && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = bsr_spmm_tc_kernel<BN, T, false>;
  size_t smem = TcTile<BN>::kSmem;
  if constexpr (BN <= kSpanMaxF) {
    if (span) {
      kernel = bsr_spmm_tc_kernel<BN, T, true>;
      smem += (size_t)TcTile<BN>::kStages * (sizeof(uint64_t) + 128 * F);   // the raw barriers and spans
    }
  }
  if (fault == kFaultK16) smem += TcTile<BN>::kZeroSmem;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap v_map = {}, x_map = {};
  err = rows_view<T>(&v_map, values, nnz * kBlock, kBlock, kBlock);
  if (err != cudaSuccess) return err;
  if (tma_x) {
    err = rows_view<T>(&x_map, x, n_in, F, kKc);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((F + BN - 1) / BN), (unsigned)n_seg);
  kernel<<<grid, span ? tc_threads<true>() : tc_threads<false>(), smem, stream>>>(
      v_map, x_map, tma_x, col_of, static_cast<const T*>(x), out, F, sched, ws, counters, fault);
  return cudaGetLastError();
}

// The tensor-core form on operands of type T.
template <typename T>
int launch_tc_type(const void* values, const void* col_of, const void* x, void* out, const void* sched, void* ws,
                   void* counters, int out_blocks, int feat, int nnz, int n_in, int n_seg, int fault, void* stream) {
  if (out_blocks == 0 || feat == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (nnz == 0)   // every row block is empty: no tile to view
    return (int)cudaMemsetAsync(o, 0, (size_t)out_blocks * kBlock * feat * sizeof(float), s);
  if (n_seg > 65535) return (int)cudaErrorInvalidConfiguration;
  const int* co = static_cast<const int*>(col_of);
  const int* sc = static_cast<const int*>(sched);
  float* w = static_cast<float*>(ws);
  int* cn = static_cast<int*>(counters);
  switch (bsr_spmm_tile(feat)) {
    case 16: return (int)launch_tc<16, T>(values, co, x, o, feat, nnz, n_in, sc, n_seg, w, cn, fault, s);
    case 24: return (int)launch_tc<24, T>(values, co, x, o, feat, nnz, n_in, sc, n_seg, w, cn, fault, s);
    case 32: return (int)launch_tc<32, T>(values, co, x, o, feat, nnz, n_in, sc, n_seg, w, cn, fault, s);
    case 64: return (int)launch_tc<64, T>(values, co, x, o, feat, nnz, n_in, sc, n_seg, w, cn, fault, s);
    case 128: return (int)launch_tc<128, T>(values, co, x, o, feat, nnz, n_in, sc, n_seg, w, cn, fault, s);
    default: return (int)launch_tc<256, T>(values, co, x, o, feat, nnz, n_in, sc, n_seg, w, cn, fault, s);
  }
}

}  // namespace

// The feature columns one block computes for F columns, in the tensor-core
// form (bf16 != 0: bf16 and f16 operands) or the f32 one: a split row's
// workspace slot holds 128 rows of ceil(F / tile) tiles of that many columns.
extern "C" int bsr_spmm_feature_tile(int feat, int bf16) {
  return bf16 ? bsr_spmm_tile(feat) : simt_f32::feature_tile(feat);
}

// Every form: values and x float32 (bsr_spmm_fwd), bfloat16 (bsr_spmm_bf16)
// or float16 (bsr_spmm_f16), out float32; nnz tiles, x of n_in rows. sched (n_seg, 8)
// int32 is the segment schedule (ops/spmm.py:bsr_schedule); ws holds the
// split rows' partials (its slots times 128 rows times ceil(F / tile) tiles
// of bsr_spmm_feature_tile(F) columns, f32) and counters (out_blocks
// ceil(F / tile) int32) must be zero; both may be null where the schedule
// splits no row. fault: 0 none, 1 the k16 slice holding each tile's last
// contraction element dropped, 2 each row block's last tile skipped, 3 row
// block 0 written as zeros, 4 a split row's last segment left out of its
// sum. Launches on `stream`; returns cudaGetLastError() after the launch,
// or the error of a TMA view that cannot be encoded, or
// cudaErrorMisalignedAddress for tiles that are not 16-byte aligned.
extern "C" int bsr_spmm_fwd(const void* values, const void* col_of, const void* x, void* out, const void* sched,
                            void* ws, void* counters, int out_blocks, int feat, int nnz, int n_in, int n_seg,
                            int fault, void* stream) {
  if (out_blocks == 0 || feat == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (nnz == 0)   // every row block is empty
    return (int)cudaMemsetAsync(o, 0, (size_t)out_blocks * kBlock * feat * sizeof(float), s);
  const float* v = static_cast<const float*>(values);
  const int* co = static_cast<const int*>(col_of);
  const float* xx = static_cast<const float*>(x);
  const int* sc = static_cast<const int*>(sched);
  float* w = static_cast<float*>(ws);
  int* cn = static_cast<int*>(counters);
  switch (simt_f32::feature_tile(feat)) {
    case 16: return (int)launch_f32<1>(v, co, xx, o, feat, nnz, n_in, sc, n_seg, w, cn, fault, s);
    case 32: return (int)launch_f32<2>(v, co, xx, o, feat, nnz, n_in, sc, n_seg, w, cn, fault, s);
    case 64: return (int)launch_f32<4>(v, co, xx, o, feat, nnz, n_in, sc, n_seg, w, cn, fault, s);
    default: return (int)launch_f32<8>(v, co, xx, o, feat, nnz, n_in, sc, n_seg, w, cn, fault, s);
  }
}

extern "C" int bsr_spmm_bf16(const void* values, const void* col_of, const void* x, void* out, const void* sched,
                             void* ws, void* counters, int out_blocks, int feat, int nnz, int n_in, int n_seg,
                             int fault, void* stream) {
  return launch_tc_type<__nv_bfloat16>(values, col_of, x, out, sched, ws, counters, out_blocks, feat, nnz, n_in,
                                       n_seg, fault, stream);
}

extern "C" int bsr_spmm_f16(const void* values, const void* col_of, const void* x, void* out, const void* sched,
                            void* ws, void* counters, int out_blocks, int feat, int nnz, int n_in, int n_seg,
                            int fault, void* stream) {
  return launch_tc_type<__half>(values, col_of, x, out, sched, ws, counters, out_blocks, feat, nnz, n_in, n_seg,
                                fault, stream);
}
