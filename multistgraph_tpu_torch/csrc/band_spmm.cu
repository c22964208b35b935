// Band SpMM for Hopper (sm_90a): Y = A X for a block-band matrix A, its
// transpose, and the sampled outer product of its values' gradient.
//
// A's nonzero 128x128 tiles lie on a few block diagonals: the tile of row
// block r at offset o multiplies x's row block r + o. Two layouts of the
// tiles, both contiguous:
//   planes  (O, R, 128, 128): plane s holds the diagonal at offset offs[s];
//   packed  (R, 128, (2 radius + 1) 128): slot s of row block r holds the
//           tile at offset s - radius (zero for an offset the graph lacks).
// x, dy, out are (R*128, F) row-major; any F >= 1. Rows r + o outside
// [0, R) contribute nothing: their slot is skipped, no padded copy is made.
// Operands are float32, bfloat16 or float16, the tiles and x of one type
// (the wrapper casts as JAX does). A product of two bf16 values, or of two
// f16 values, is exact in f32 and every sum is f32, the Pallas kernels' rounding
// (preferred_element_type=f32); the forward and dX round their f32 sums once
// to the operands' type, as JAX casts the result to x's dtype
// (multistgraph_tpu/ops/band.py:235,477,701), and dV rounds once to the
// values' type, which may differ from the operands' (band.py:642,736).
//
// band_spmm_launch, transposed = 0 (forward):
//   out[r] = sum_s T_s(r) @ x[r + o_s]
// replaces multistgraph_tpu/ops/band.py:band_fwd_pallas (B7, planes) and
// :band_fwd_slab_pallas (B8, packed rows against a contiguous x window).
// band_spmm_launch, transposed = 1 (the backward's dX):
//   out[r] = sum_s T_s(r - o_s)^T @ dy[r - o_s]
// replaces :band_dx_pallas (B9 dX), and reads the packed layout for the
// packed form's dX, which JAX computes with XLA einsums (band.py:609-642).
// band_dv_launch (the backward's dV, B9 dV, :band_dv_pallas):
//   out tile (s, r) = dy[r] @ x[r + o_s]^T, zero where r + o_s is outside
//   [0, R); written in the planes or the packed layout. The same function
//   as sampled_matmul.cu's (B5) at the band's tiles: its f32 form shares
//   B5's kernel.
//
// What bounds them on an H100: the forward and dX are one (128x128)(128xF)
// product per present tile, dV the same FLOPs contracting over F and
// writing the tiles. In bf16 at 1,000,000 nodes (7,813 row blocks, 39,059
// tiles, 1.28 GB of planes) the bytes bound them below F of about 300: at
// F=128 the planes, x and out take 0.535 ms at 3.35 TB/s and the 164 GFLOP
// 0.17 ms on the bf16 tensor cores (989 TFLOP/s), but 2.4 ms as f32 FMAs on
// the CUDA cores; at F=1536 the 1.97 TFLOP (2.0 ms) come near the bytes
// (2.2 ms). In f32 at the 49,152-node band (~1,914 tiles) and F=128 the 8.0
// GFLOP take 0.12 ms at the 67 TFLOP/s f32 peak against 0.05 ms of bytes:
// tensor cores would take f32 in TF32, three decimal digits.
//
// bf16 and f16 operands: tensor cores (wgmma m64nNk16, 16-bit operands from
// shared memory, f32 sums in registers; one kernel template on the operand
// type T, f16 taking its own TMA data type and wgmma type suffix, the
// layouts and the schedule alike). One block per (output row block, N = 16-256 feature
// columns: the narrowest of 16, 24, 32, 64, 128 and 256 that holds F, else
// 256) has two consumer warpgroups of 64 output rows and one producer warp.
// The producer walks the row's present slots and streams each product in
// K = 64 chunks through an mbarrier ring (3-4 stages, 72-192 KB): the
// tile's chunk by TMA, K-major for the forward, MN-major for dX (the
// transposed tile is read as it lies, wgmma's transpose-A bit), and x's
// matching 64 rows as MN-major B, by TMA where F % 8 == 0 (zero past F),
// else by element loads (a row of F=12 is 24 bytes: no 16-byte copy fits
// it). Every operand lies under the 128-byte swizzle, so TMA moves 128-byte
// rows: with 8x8 core matrices (16-byte rows) the same kernel streamed at
// ~1.9 TB/s, 1.36 ms at F=128 against 0.66 ms now. Each chunk's four k16
// products go out while the previous chunk's finish, whose stage is then
// released. Two blocks share an SM up to N=128; blocks run in (row block,
// feature tile) order, so a tile's feature blocks and the five row blocks
// that read one x block run together and L2 serves the repeats. At F=128
// the bytes bound it (the tile stream at the card's ~2.7 TB/s read rate);
// at F=1536 the L2: each output element costs ~15 bytes of L2 reads (x
// read by five row blocks, a tile by six feature blocks), ~22.5 GB.
// Persistent blocks walking tiles a grid apart ran 15-20% slower than this
// grid, N = 128 at F=1536 7% slower. dV: one block per row block walks its
// slots; each (s, r) tile is one 128x128 product over F in K = 64 chunks
// (dy[r] and x[r + o_s] both K-major, by TMA where F % 8 == 0), zero where
// r + o_s is outside the graph, staged per warp in shared memory and
// stored in 16-byte units along whole rows (scattered 4-byte stores of its
// 1.28 GB of tiles took 1.12 ms at F=128, 0.82-0.89 ms staged). At F=1536
// dV reads dy[r] once per slot and x once per row block that uses it, 48
// bytes of L2 reads an output element, which bounds it. A view that the
// shape allows and cuTensorMapEncodeTiled refuses (an operand that is not
// 16-byte aligned) is a launch error. The *_fault entries plant a fault
// (a k16 slice dropped, a slot skipped, the graph's edge a block short)
// for checks that must catch one.
//
// f32 operands: full f32 FMAs on the CUDA cores (TF32 would keep three
// decimal digits), on the mainloop of simt_f32.cuh that bsr_spmm.cu's f32
// form shares. One block per (output row block, feature tile of FT = 16,
// 32, 64 or 128 columns) walks the row's present slots; a producer warp
// streams each tile in 32-k chunks, with x's matching 32 rows, through a
// 4-stage mbarrier ring, by TMA where x's rows are whole 16-byte units,
// else by cp.async; 256 consumer threads each keep 8 rows x FT/16 columns in
// registers and write them once, so dX needs no atomics and no zero fill: a
// row with no tile writes zeros. The forward reads the tile K-major (under
// the 128-byte swizzle), dX reads it as it lies (MN-major): both as float4,
// with no element-wise transpose. At F=128 each thread does 64 FMAs for
// four 16-byte shared loads. dV runs simt_f32.cuh's sampled kernel, as
// sampled_matmul.cu's f32 form does (BandDvTiles): dy[r] and x[r + o_s]
// both K-major in 32-k chunks through the same ring, persistent blocks
// walking the tiles (s, r), the slots of a row block together, each tile
// staged in shared memory and stored by TMA; its faults are the bf16
// kernels'. At the 49,152-node band (1,920 tiles (s, r), 1,914 in the
// graph) on an H100 80GB HBM3 at 700 W: F=128 0.209 ms, F=1536 2.33,
// against 0.366 and 3.82 for the design it replaces (B5's first kernel on
// one tile a block; PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "simt_f32.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int kBlock = 128;                 // tile edge
constexpr int kMaxOffsets = 8;

struct Offsets {
  int v[kMaxOffsets];
};

// f32 operands: out[r][:, f0 .. f0 + FT] for r = blockIdx.y, f0 = FT
// blockIdx.x, on simt_f32.cuh's mainloop. The pairs are the row's present
// slots: the forward's tile (r, s) against x's block r + o_s, K-major; dX's
// tile (r - o_s, s) read as it lies, MN-major, against dy's block r - o_s.
// v_map views the tiles (planes (O R 128, 128) or packed rows (R 128, W)),
// its box the forward's 32 k by 128 rows under the 128-byte swizzle or dX's
// 128 columns by 32 k rows; x_map views x (R 128, F), its box FT columns by
// 32 rows. Both maps are unused under kCpAsync.
template <int TN, bool TRANS, bool PACKED, int COPY>
__global__ void __launch_bounds__(simt_f32::kThreads, simt_f32::Ring<TN>::kMinBlocks)
band_f32_kernel(const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap x_map,
                const float* __restrict__ values, const float* __restrict__ x, float* __restrict__ out, int R, int F,
                int n_slots, int radius, Offsets offs, int x16) {
  namespace sf = simt_f32;
  constexpr int FT = sf::Ring<TN>::kFt;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const sf::Stages<TN> st(wgmma_sm90::aligned_smem(smem_raw));
  const int r = blockIdx.y, f0 = blockIdx.x * FT, tid = threadIdx.x;
  const int ld = PACKED ? n_slots * kBlock : kBlock;
  sf::ring_init<TN, COPY>(st, tid);

  if (tid >= sf::kConsumers) {
    // producer warp: chunk g is the (g % 4)-th 32-k chunk of the (g / 4)-th present slot
    const int lane = tid - sf::kConsumers;
    int g = 0;
    for (int s = 0; s < n_slots; ++s) {
      const int o = PACKED ? s - radius : offs.v[s];
      const int src = TRANS ? r - o : r + o;   // the operand's row block (for dX also the tile's)
      if (src < 0 || src >= R) continue;
      const int trow = TRANS ? src : r;
      // the tile's first row in the tiles' 2-d view, and its first column there
      const int vrow = (PACKED ? trow : s * R + trow) * kBlock, vcol = PACKED ? s * kBlock : 0;
      for (int kc = 0; kc < sf::kChunks; ++kc, ++g) {
        const int stage = g % sf::Ring<TN>::kStages, k0 = kc * sf::kKc;
        sf::producer_acquire(st, g);
        if constexpr (COPY == sf::kTma) {
          sf::fill_tma(st, stage, &v_map, TRANS ? vcol : vcol + k0, TRANS ? vrow + k0 : vrow, &x_map, f0,
                       src * kBlock + k0, lane);
        } else {
          const float* tile = values + (size_t)vrow * ld + vcol;
          sf::fill_cp<TN, !TRANS>(st, stage, TRANS ? tile + (size_t)k0 * ld : tile + k0, ld,
                                  x + (size_t)(src * kBlock + k0) * F, F, f0, x16, lane);
        }
      }
    }
    if constexpr (COPY == sf::kCpAsync) wgmma_sm90::cp_async_wait<0>();   // no copy outlives its thread
    return;
  }

  // consumers
  int present = 0;
  for (int s = 0; s < n_slots; ++s) {
    const int o = PACKED ? s - radius : offs.v[s];
    const int src = TRANS ? r - o : r + o;
    present += src >= 0 && src < R;
  }
  const sf::Place p(tid);
  float acc[8 * TN];
#pragma unroll
  for (int i = 0; i < 8 * TN; ++i) acc[i] = 0.f;
  for (int g = 0; g < present * sf::kChunks; ++g) {
    const int stage = sf::consumer_acquire(st, g);
    sf::mma_chunk<TN, !TRANS>(acc, st.a_at(stage), st.b_at(stage), p);
    sf::consumer_release(st, stage, tid);
  }
  sf::store_rows<TN, !TRANS>(out, r * kBlock, F, f0, acc, p);
}

template <int TN, bool TRANS, bool PACKED, int COPY>
cudaError_t launch_f32_tile(const CUtensorMap& v_map, const CUtensorMap& x_map, const float* v, const float* x,
                            float* out, int R, int F, int n_slots, int radius, const Offsets& offs, int x16,
                            cudaStream_t stream) {
  auto kernel = band_f32_kernel<TN, TRANS, PACKED, COPY>;
  const size_t smem = simt_f32::Ring<TN>::kSmem;
  cudaError_t err = wgmma_sm90::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((F + 16 * TN - 1) / (16 * TN)), (unsigned)R);
  kernel<<<grid, simt_f32::kThreads, smem, stream>>>(v_map, x_map, v, x, out, R, F, n_slots, radius, offs, x16);
  return cudaGetLastError();
}

template <int TN, bool TRANS, bool PACKED>
cudaError_t launch_f32_width(const void* values, const void* x, void* out, int R, int F, int n_slots, int radius,
                             const Offsets& offs, cudaStream_t stream) {
  const float* v = static_cast<const float*>(values);
  const float* xx = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (reinterpret_cast<uintptr_t>(v) % 16) return cudaErrorMisalignedAddress;   // 16-byte copies of the tiles
  const int x16 = F % 4 == 0 && reinterpret_cast<uintptr_t>(xx) % 16 == 0;
  CUtensorMap v_map = {}, x_map = {};
  if (x16) {   // TMA: x's rows are whole 16-byte units
    const int ld = PACKED ? n_slots * kBlock : kBlock;
    const long long rows = (long long)(PACKED ? 1 : n_slots) * R * kBlock;
    cudaError_t err = TRANS ? simt_f32::f32_view(&v_map, v, rows, ld, kBlock, simt_f32::kKc, false)
                            : simt_f32::f32_view(&v_map, v, rows, ld, simt_f32::kKc, kBlock, true);
    if (err == cudaSuccess) err = simt_f32::f32_view(&x_map, xx, (long long)R * kBlock, F, 16 * TN, simt_f32::kKc, false);
    if (err != cudaSuccess) return err;
    return launch_f32_tile<TN, TRANS, PACKED, simt_f32::kTma>(v_map, x_map, v, xx, o, R, F, n_slots, radius, offs,
                                                               x16, stream);
  }
  return launch_f32_tile<TN, TRANS, PACKED, simt_f32::kCpAsync>(v_map, x_map, v, xx, o, R, F, n_slots, radius, offs,
                                                                 x16, stream);
}

template <bool TRANS, bool PACKED>
cudaError_t launch_spmm_f32(const void* values, const void* x, void* out, int R, int F, int n_slots, int radius,
                            const Offsets& offs, cudaStream_t stream) {
  switch (simt_f32::feature_tile(F)) {
    case 16: return launch_f32_width<1, TRANS, PACKED>(values, x, out, R, F, n_slots, radius, offs, stream);
    case 32: return launch_f32_width<2, TRANS, PACKED>(values, x, out, R, F, n_slots, radius, offs, stream);
    case 64: return launch_f32_width<4, TRANS, PACKED>(values, x, out, R, F, n_slots, radius, offs, stream);
    default: return launch_f32_width<8, TRANS, PACKED>(values, x, out, R, F, n_slots, radius, offs, stream);
  }
}

// ---------------------------------------------------------------- bf16 and f16 operands: tensor cores

using namespace wgmma_sm90;

// Faults the 16-bit kernels plant on request, for checks that must fail them:
constexpr int kFaultK16 = 1;    // the k16 slice holding a product's last contraction element dropped
constexpr int kFaultSlot = 2;   // the middle slot skipped (the main diagonal of offsets -r..r)
constexpr int kFaultEdge = 3;   // the last row block read as outside the graph

constexpr int kKc = 64;                       // contraction rows of one ring stage
constexpr int kConsumers = 256;               // two warpgroups of 64 output rows
constexpr int kTcThreads = kConsumers + 32;   // and one producer warp
constexpr int kChunkA = kBlock * kKc;         // elements of a stage's tile (or dy) chunk
constexpr int kDvStages = 2;
constexpr int kStageLd = kBlock + 8;          // row stride of dV's per-warp output staging (conflict-free)

struct Band {
  int R, F, n_slots, radius, packed, fault;
  Offsets offs;
};

// The operand's row block of slot s for output row block r (r + o, or r - o
// for the transpose), or -1 where it lies outside the graph: the slot adds
// nothing (dV writes its tile as zeros).
__device__ __forceinline__ int slot_source(const Band& a, int s, int r, bool trans) {
  if (a.fault == kFaultSlot && s == a.n_slots / 2) return -1;
  const int o = a.packed ? s - a.radius : a.offs.v[s];
  const int src = trans ? r - o : r + o;
  return src >= 0 && src < (a.fault == kFaultEdge ? a.R - 1 : a.R) ? src : -1;
}

// f32 dV on simt_f32.cuh's sampled kernel: tile t is (s, r) = (t % n_slots,
// t / n_slots), the slots of one row block together (they read the same dy
// block, and neighbouring rows the same x blocks), dy[r] @ x[r + o_s]^T,
// zero where slot_source finds no row block; written into the planes or the
// packed rows in the values' type.
template <typename OutT>
struct BandDvTiles {
  using Out = OutT;
  Band a;
  OutT* out;               // planes (O, R, 128, 128), viewed as (O R 128, 128), or packed rows (R 128, O 128)
  int n;
  long long view_rows;
  int view_cols;
  __device__ __forceinline__ bool source(int t, int& ar, int& br) const {
    const int r = t / a.n_slots, c = slot_source(a, t % a.n_slots, r, false);
    ar = r * kBlock;
    br = c * kBlock;
    return c >= 0;
  }
  __device__ __forceinline__ void store_at(int t, int& c0, int& c1) const {
    const int r = t / a.n_slots, s = t % a.n_slots;
    c0 = a.packed ? s * kBlock : 0;
    c1 = (a.packed ? r : s * a.R + r) * kBlock;
  }
};

template <typename OutT>
cudaError_t launch_dv_f32(const void* dy, const void* x, void* out, const Band& a, cudaStream_t stream) {
  const BandDvTiles<OutT> tiles = {a, static_cast<OutT*>(out), a.R * a.n_slots,
                                   (long long)(a.packed ? 1 : a.n_slots) * a.R * kBlock,
                                   a.packed ? a.n_slots * kBlock : kBlock};
  const long long rows = (long long)a.R * kBlock;
  return simt_f32::launch_sampled(static_cast<const float*>(dy), rows, static_cast<const float*>(x), rows, tiles, a.F,
                                  a.fault, stream);
}

template <int BN>
struct SpmmTile {
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kMinBlocks = BN == 256 ? 1 : 2;   // blocks an SM: shared memory and registers allow
  static constexpr int kWidthB = BN < 64 ? 64 : BN;      // columns of an operand chunk: whole 128-byte rows
  static constexpr int kChunkB = kKc * kWidthB;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * (kChunkA + kChunkB) * 2 +   // 16-bit elements
                                  2 * kStages * sizeof(uint64_t);
};

// out[r][:, f0 .. f0 + BN] for r = blockIdx.y, f0 = BN blockIdx.x. v_map is a
// 2-d view of the tiles (planes (O R 128, 128) or packed rows (R 128, W))
// under the 128-byte swizzle: for the forward one box is a 64-wide chunk of
// a tile's 128 rows (K-major A, rows of 64 k); for the transpose, two boxes
// of 64 of its rows by 64 columns (MN-major A, two 64-row blocks of M).
// x_map views x likewise: a box is 64 rows by 64 columns (MN-major B), one
// for each 64 of the chunk's columns, where tma_x (F % 8 == 0); else the
// producer loads elements into the same layout. T is the operands' and the
// output's 16-bit type.
template <int BN, bool TRANS, typename T>
__global__ void __launch_bounds__(kTcThreads, SpmmTile<BN>::kMinBlocks)
band_spmm_tc_kernel(const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap x_map,
                    int tma_x, const T* __restrict__ x, T* __restrict__ out, Band a) {
  using Tile = SpmmTile<BN>;
  constexpr int S = Tile::kStages;
  constexpr int kBlocksB = Tile::kWidthB / 64;   // 64-column blocks of an operand chunk
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* as = reinterpret_cast<T*>(smem);                                   // S tile chunks: 128 x 64
  T* bs = as + (size_t)S * kChunkA;                                     // S operand chunks: 64 x kWidthB
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + (size_t)S * Tile::kChunkB);
  uint64_t* empty = full + S;

  const int r = blockIdx.y, f0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2);   // one arrival per consumer warpgroup
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: chunk g is the kc-th half of the g/2-th present slot
    const int lane = tid - kConsumers;
    const T zero = T(0.f);
    int g = 0;
    for (int s = 0; s < a.n_slots; ++s) {
      const int src = slot_source(a, s, r, TRANS);
      if (src < 0) continue;
      // the tile's first row and column in the view
      const int trow = TRANS ? src : r;
      const int row0 = a.packed ? trow * kBlock : (s * a.R + trow) * kBlock;
      const int col0 = a.packed ? s * kBlock : 0;
      for (int kc = 0; kc < kBlock / kKc; ++kc, ++g) {
        const int st = g % S;
        if (g >= S) mbar_wait(empty + st, ((g / S) & 1) ^ 1);
        T* ad = as + (size_t)st * kChunkA;
        T* bd = bs + (size_t)st * Tile::kChunkB;
        const int k0 = src * kBlock + kc * kKc;   // the operand's first row of the chunk
        if (!tma_x) {
          // element (k, c) of the chunk, zero past F, at its swizzled place
          unsigned char* bb = reinterpret_cast<unsigned char*>(bd);
#pragma unroll 4
          for (int q = lane; q < kKc * BN; q += 32) {
            const int k = q / BN, c = q - k * BN, f = f0 + c;
            *reinterpret_cast<T*>(bb + (c / 64) * 8192 + sw128(k * 128 + (c % 64) * 2)) =
                f < a.F ? x[(size_t)(k0 + k) * a.F + f] : zero;
          }
          fence_proxy_async();
          __syncwarp();
        }
        if (lane == 0) {
          mbar_arrive_tx(full + st, (kChunkA + (tma_x ? Tile::kChunkB : 0)) * (unsigned)sizeof(T));
          if (TRANS) {
            tma_load_2d(ad, &v_map, col0, row0 + kc * kKc, full + st);
            tma_load_2d(ad + 64 * kKc, &v_map, col0 + 64, row0 + kc * kKc, full + st);
          } else {
            tma_load_2d(ad, &v_map, col0 + kc * kKc, row0, full + st);
          }
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
    for (int s = 0; s < a.n_slots; ++s) {
      if (slot_source(a, s, r, TRANS) < 0) continue;
      for (int kc = 0; kc < kBlock / kKc; ++kc, ++g) {
        const int st = g % S;
        mbar_wait(full + st, (g / S) & 1);
        // the warpgroup's 64 rows of the tile chunk: 8 KB in, K-major
        // (64 rows of 64 k) and MN-major (64 k of 64 rows) alike
        const unsigned char* ad = reinterpret_cast<const unsigned char*>(as + (size_t)st * kChunkA) + wg * 8192;
        const unsigned char* bd = reinterpret_cast<const unsigned char*>(bs + (size_t)st * Tile::kChunkB);
        const int skip = a.fault == kFaultK16 && kc == kBlock / kKc - 1 ? kKc / 16 - 1 : -1;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kKc / 16; ++ks)
          if (ks != skip)
            Wgmma<BN, T>::template mma_t<TRANS ? 1 : 0, 1>(
                acc, TRANS ? desc_sw128(ad + 2048 * ks, 8192u) : desc_sw128(ad + 32 * ks, 16u),
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
      T* row = out + ((size_t)r * kBlock + 64 * wg + 16 * warp + lane / 4 + 8 * h) * a.F + f0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        store_pair(row, 8 * j + 2 * (lane % 4), a.F - f0, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// Tile (s, r) = dy[r] @ x[r + o_s]^T for r = blockIdx.x and every slot s, in
// the values' type OutT, dy and x of the 16-bit type T. dy_map and x_map are
// 2-d views of dy and x under the 128-byte swizzle whose box, 128 rows of 64
// features, lands as K-major cores, where tma (F % 8 == 0); else the
// producer loads elements into the same layout. Features past F read as zero.
template <typename T, typename OutT>
__global__ void __launch_bounds__(kTcThreads, sizeof(OutT) == 2 ? 2 : 1)   // f32 staging leaves room for one
band_dv_tc_kernel(const __grid_constant__ CUtensorMap dy_map, const __grid_constant__ CUtensorMap x_map, int tma,
                  const T* __restrict__ dy, const T* __restrict__ x, OutT* __restrict__ out, Band a) {
  constexpr int S = kDvStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* as = reinterpret_cast<T*>(smem);                            // S chunks of dy[r]: 128 x 64
  T* bs = as + (size_t)S * kChunkA;                              // S chunks of x[r + o_s]: 128 x 64
  OutT* staged = reinterpret_cast<OutT*>(bs + (size_t)S * kChunkA);  // 16 x kStageLd outputs a consumer warp
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + (size_t)kConsumers / 32 * 16 * kStageLd);
  uint64_t* empty = full + S;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_chunks = (a.F + kKc - 1) / kKc;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    const int lane = tid - kConsumers;
    const T zero = T(0.f);
    int g = 0;
    for (int s = 0; s < a.n_slots; ++s) {
      const int c = slot_source(a, s, r, false);
      if (c < 0) continue;
      for (int kc = 0; kc < n_chunks; ++kc, ++g) {
        const int st = g % S;
        if (g >= S) mbar_wait(empty + st, ((g / S) & 1) ^ 1);
        T* ad = as + (size_t)st * kChunkA;
        T* bd = bs + (size_t)st * kChunkA;
        if (tma) {
          if (lane == 0) {
            mbar_arrive_tx(full + st, 2 * kChunkA * (unsigned)sizeof(T));
            tma_load_2d(ad, &dy_map, kc * kKc, r * kBlock, full + st);
            tma_load_2d(bd, &x_map, kc * kKc, c * kBlock, full + st);
          }
        } else {
          const T* dyr = dy + (size_t)r * kBlock * a.F;
          const T* xc = x + (size_t)c * kBlock * a.F;
          unsigned char* ab = reinterpret_cast<unsigned char*>(ad);
          unsigned char* bb = reinterpret_cast<unsigned char*>(bd);
#pragma unroll 4
          for (int q = lane; q < kChunkA; q += 32) {
            const int i = q / kKc, k = q % kKc, f = kc * kKc + k;
            const int o = sw128(i * 128 + k * 2);
            *reinterpret_cast<T*>(ab + o) = f < a.F ? dyr[(size_t)i * a.F + f] : zero;
            *reinterpret_cast<T*>(bb + o) = f < a.F ? xc[(size_t)i * a.F + f] : zero;
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(full + st);
        }
      }
    }
  } else {
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int ld = a.packed ? a.n_slots * kBlock : kBlock;
    // the k16 slices of the last chunk that hold part of the contraction
    const int last_ks = (a.F - 1) % kKc / 16;
    int g = 0;
    for (int s = 0; s < a.n_slots; ++s) {
      float acc[kBlock / 2];
#pragma unroll
      for (int i = 0; i < kBlock / 2; ++i) acc[i] = 0.f;
      if (slot_source(a, s, r, false) >= 0) {
        for (int kc = 0; kc < n_chunks; ++kc, ++g) {
          const int st = g % S;
          mbar_wait(full + st, (g / S) & 1);
          const unsigned char* ad = reinterpret_cast<const unsigned char*>(as + (size_t)st * kChunkA) + wg * 8192;
          const unsigned char* bd = reinterpret_cast<const unsigned char*>(bs + (size_t)st * kChunkA);
          const bool last = kc == n_chunks - 1;
          const int skip = a.fault == kFaultK16 && last ? last_ks : -1;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kKc / 16; ++ks)
            if ((!last || ks <= last_ks) && ks != skip)
              Wgmma<kBlock, T>::template mma_t<0, 0>(acc, desc_sw128(ad + 32 * ks, 16u),
                                                     desc_sw128(bd + 32 * ks, 16u), 1);
          wgmma_commit();
          if (kc > 0) {
            wgmma_wait<1>();
            if (tid % 128 == 0) mbar_arrive(empty + (g - 1) % S);
          }
        }
        wgmma_wait<0>();
        if (tid % 128 == 0) mbar_arrive(empty + (g - 1) % S);
      }
      // the warp's 16 rows of the tile through shared memory, so that they
      // leave in 16-byte stores along whole rows
      OutT* stage = staged + (size_t)(tid / 32) * 16 * kStageLd;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j)
          store_pair(stage + (lane / 4 + 8 * h) * kStageLd, 8 * j + 2 * (lane % 4), kBlock, acc[4 * j + 2 * h],
                     acc[4 * j + 2 * h + 1]);
      __syncwarp();
      OutT* tile = out + (a.packed ? (size_t)r * kBlock * ld + (size_t)s * kBlock
                                   : ((size_t)s * a.R + r) * kBlock * kBlock) +
                   (size_t)(64 * wg + 16 * warp) * ld;
      constexpr int kVec = 16 / sizeof(OutT), kPerRow = kBlock / kVec;
#pragma unroll 2
      for (int q = lane; q < 16 * kPerRow; q += 32) {
        const int i = q / kPerRow, c = (q % kPerRow) * kVec;
        *reinterpret_cast<uint4*>(tile + (size_t)i * ld + c) = *reinterpret_cast<const uint4*>(stage + i * kStageLd + c);
      }
      __syncwarp();   // the staging is read before the next slot writes it
    }
  }
}

template <int BN, bool TRANS, typename T>
cudaError_t launch_spmm_tc(const void* values, const void* x, void* out, const Band& a, cudaStream_t stream) {
  auto kernel = band_spmm_tc_kernel<BN, TRANS, T>;
  const size_t smem = SpmmTile<BN>::kSmem;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // the tiles: planes (O R 128, 128) or packed rows (R 128, W); a box is 128
  // rows (forward) or 64 rows (transpose) of 64 columns
  const int rows = a.packed ? a.R * kBlock : a.n_slots * a.R * kBlock;
  const int cols = a.packed ? a.n_slots * kBlock : kBlock;
  CUtensorMap v_map = {}, x_map = {};
  err = rows_view<T>(&v_map, values, rows, cols, TRANS ? kKc : kBlock);
  if (err != cudaSuccess) return err;
  const int tma_x = a.F % 8 == 0;
  if (tma_x) {
    err = rows_view<T>(&x_map, x, a.R * kBlock, a.F, kKc);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((a.F + BN - 1) / BN), (unsigned)a.R);
  kernel<<<grid, kTcThreads, smem, stream>>>(v_map, x_map, tma_x, static_cast<const T*>(x), static_cast<T*>(out), a);
  return cudaGetLastError();
}

// the narrowest wgmma N of 16, 24, 32, 64, 128 that holds F, else 256
template <bool TRANS, typename T>
cudaError_t launch_spmm_16(const void* values, const void* x, void* out, const Band& a, cudaStream_t stream) {
  if (a.F <= 16) return launch_spmm_tc<16, TRANS, T>(values, x, out, a, stream);
  if (a.F <= 24) return launch_spmm_tc<24, TRANS, T>(values, x, out, a, stream);
  if (a.F <= 32) return launch_spmm_tc<32, TRANS, T>(values, x, out, a, stream);
  if (a.F <= 64) return launch_spmm_tc<64, TRANS, T>(values, x, out, a, stream);
  if (a.F <= 128) return launch_spmm_tc<128, TRANS, T>(values, x, out, a, stream);
  return launch_spmm_tc<256, TRANS, T>(values, x, out, a, stream);
}

template <typename T>
cudaError_t launch_spmm_type(const void* values, const void* x, void* out, const Band& a, int transposed,
                             cudaStream_t stream) {
  return transposed ? launch_spmm_16<true, T>(values, x, out, a, stream)
                    : launch_spmm_16<false, T>(values, x, out, a, stream);
}

template <typename T, typename OutT>
cudaError_t launch_dv_tc(const void* dy, const void* x, void* out, const Band& a, cudaStream_t stream) {
  auto kernel = band_dv_tc_kernel<T, OutT>;
  const size_t smem = 1024 + (size_t)kDvStages * 2 * kChunkA * sizeof(T) +
                      (size_t)kConsumers / 32 * 16 * kStageLd * sizeof(OutT) + 2 * kDvStages * sizeof(uint64_t);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap dy_map = {}, x_map = {};
  const int tma = a.F % 8 == 0;
  if (tma) {
    err = rows_view<T>(&dy_map, dy, a.R * kBlock, a.F, kBlock);
    if (err == cudaSuccess) err = rows_view<T>(&x_map, x, a.R * kBlock, a.F, kBlock);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)a.R, kTcThreads, smem, stream>>>(dy_map, x_map, tma, static_cast<const T*>(dy),
                                                      static_cast<const T*>(x), static_cast<OutT*>(out), a);
  return cudaGetLastError();
}

// dV on operands of type T (float: simt_f32.cuh's sampled kernel; bf16 or
// f16: the tensor-core kernel), written in the type of code out_dtype
template <typename T>
cudaError_t launch_dv_type(const void* dy, const void* x, void* out, const Band& a, int out_dtype,
                           cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    switch (out_dtype) {
      case 0: return launch_dv_f32<float>(dy, x, out, a, stream);
      case 1: return launch_dv_f32<__nv_bfloat16>(dy, x, out, a, stream);
      case 2: return launch_dv_f32<__half>(dy, x, out, a, stream);
    }
  } else {
    switch (out_dtype) {
      case 0: return launch_dv_tc<T, float>(dy, x, out, a, stream);
      case 1: return launch_dv_tc<T, __nv_bfloat16>(dy, x, out, a, stream);
      case 2: return launch_dv_tc<T, __half>(dy, x, out, a, stream);
    }
  }
  return cudaErrorInvalidValue;
}

Offsets make_offsets(int o0, int o1, int o2, int o3, int o4, int o5, int o6, int o7) {
  Offsets offs = {{o0, o1, o2, o3, o4, o5, o6, o7}};
  return offs;
}

}  // namespace

// As band_spmm_launch, with a fault planted in the 16-bit kernels (0: none, 1:
// the k16 slice holding each product's last contraction element dropped, 2:
// the middle slot skipped, 3: the last row block read as outside the
// graph); the f32 forward and dX take no fault (the f32 dV does).
extern "C" int band_spmm_launch_fault(const void* values, const void* x, void* out, int n_blocks, int feat,
                                      int n_slots, int radius, int packed, int transposed, int dtype, int o0,
                                      int o1, int o2, int o3, int o4, int o5, int o6, int o7, int fault,
                                      void* stream) {
  if (n_blocks == 0 || feat == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Offsets offs = make_offsets(o0, o1, o2, o3, o4, o5, o6, o7);
  if (dtype) {
    const Band a = {n_blocks, feat, n_slots, radius, packed, fault, offs};
    if (dtype == 1) return (int)launch_spmm_type<__nv_bfloat16>(values, x, out, a, transposed, s);
    if (dtype == 2) return (int)launch_spmm_type<__half>(values, x, out, a, transposed, s);
    return (int)cudaErrorInvalidValue;
  }
  if (fault) return (int)cudaErrorInvalidValue;
  if (transposed) {
    return packed ? (int)launch_spmm_f32<true, true>(values, x, out, n_blocks, feat, n_slots, radius, offs, s)
                  : (int)launch_spmm_f32<true, false>(values, x, out, n_blocks, feat, n_slots, radius, offs, s);
  }
  return packed ? (int)launch_spmm_f32<false, true>(values, x, out, n_blocks, feat, n_slots, radius, offs, s)
                : (int)launch_spmm_f32<false, false>(values, x, out, n_blocks, feat, n_slots, radius, offs, s);
}

// Launches on `stream`; returns cudaGetLastError() after the launch, or the
// error of a TMA view where the 16-bit kernels take one (the tiles always, x
// where F % 8 == 0) and it cannot be encoded. For the planes, n_slots = O <=
// 8 and o0..o7 the offsets; for packed rows, n_slots = 2 radius + 1 and the
// offsets are implied. dtype (and in_dtype, out_dtype): 0 float32, 1
// bfloat16, 2 float16.
extern "C" int band_spmm_launch(const void* values, const void* x, void* out, int n_blocks, int feat,
                                int n_slots, int radius, int packed, int transposed, int dtype, int o0,
                                int o1, int o2, int o3, int o4, int o5, int o6, int o7, void* stream) {
  return band_spmm_launch_fault(values, x, out, n_blocks, feat, n_slots, radius, packed, transposed, dtype, o0, o1,
                                o2, o3, o4, o5, o6, o7, 0, stream);
}

// As band_dv_launch, with a fault planted in the kernel, 16-bit or f32 (as
// band_spmm_launch_fault's; 1 drops the k16 slice holding the last
// feature).
extern "C" int band_dv_launch_fault(const void* dy, const void* x, void* out, int n_blocks, int feat,
                                    int n_slots, int radius, int packed, int in_dtype, int out_dtype, int o0,
                                    int o1, int o2, int o3, int o4, int o5, int o6, int o7, int fault,
                                    void* stream) {
  if (n_blocks == 0 || n_slots == 0) return (int)cudaSuccess;
  const Offsets offs = make_offsets(o0, o1, o2, o3, o4, o5, o6, o7);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Band a = {n_blocks, feat, n_slots, radius, packed, fault, offs};
  switch (in_dtype) {
    case 0: return (int)launch_dv_type<float>(dy, x, out, a, out_dtype, s);
    case 1: return (int)launch_dv_type<__nv_bfloat16>(dy, x, out, a, out_dtype, s);
    case 2: return (int)launch_dv_type<__half>(dy, x, out, a, out_dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int band_dv_launch(const void* dy, const void* x, void* out, int n_blocks, int feat,
                              int n_slots, int radius, int packed, int in_dtype, int out_dtype, int o0,
                              int o1, int o2, int o3, int o4, int o5, int o6, int o7, void* stream) {
  return band_dv_launch_fault(dy, x, out, n_blocks, feat, n_slots, radius, packed, in_dtype, out_dtype, o0, o1, o2,
                              o3, o4, o5, o6, o7, 0, stream);
}
