// The band-stream probes for Hopper (sm_90a): a windowed batched product
// (P1, P3) and the slab band product in two variants (P2).
//
// window_dot_launch (P1 and P3):
//   out[c] = V[c] @ X[s_c : s_c + W]        V (C, b, W), X (rows, F), out (C, b, F), f32
// where the window is a contiguous run of W rows of the row-major X. It
// replaces tools/probe_band_stream.py:probe_batched_dot (P1, a batched dot
// (C,b,W) @ (C,W,F) in one kernel: windows s_c = c W of the (C W, F) stack)
// and :probe_slice_reshape (P3, v @ x[1:6].reshape(640, 128): one window
// starting at row 128 of x viewed as (1024, 128)). What the TPU kernels
// probe is whether Mosaic lowers a batched dot and a reshape of a ref
// slice; the product they compute is this one, in plain f32 FMAs.
//
// Bound on an H100: none that a launch reaches. P1 (C = 4, b = 128, W =
// 384, F = 128) is 50 MFLOP and 1.8 MB, P3 (C = 1, W = 640) 21 MFLOP and
// 0.8 MB: under a microsecond at the f32 FMA peak or the memory rate, below
// an empty kernel's launch. What costs is latency: with the L2 flushed,
// each wave of loads waits a device-memory round trip. The first design,
// one block per (64 x 64 output tile, c) walking the whole window 16 rows
// at a time, ran 16 blocks for P1 and 4 for P3 on the 132 SMs, each paying
// a round trip per 16 rows (24 and 40 in a row). Here the window is split
// into slices (at most 8, at least 16 rows each, a multiple of 4: P1 6 of
// 64, P3 6 of 108), one block each, and the blocks of one output tile form a
// thread block cluster: each block issues all its loads at once (cp.async,
// 16-byte copies where W % 4 == 0, F % 4 == 0 and the operands are 16-byte
// aligned, else 4-byte ones; two stages of 64 rows in flight, so a slice
// of up to 128 rows pays one round trip), multiplies its slice into a
// partial in registers (256 threads, float4 shared reads, R x 4 outputs a
// thread), leaves the partial in its shared memory, and after a cluster
// barrier each block sums its share of the tile's 16-byte units over the
// cluster's partials (distributed shared memory) in slice order: no
// atomics and no device-memory workspace, and the same sums at every call.
// The tile's rows (64, 32 or 16 by 64 columns) and the slices bring the
// grid near three quarters of the SMs (P1: 64 rows, P3: 16; 96 blocks
// each). window_dot_launch_plan pins the shape and plants a fault (the
// last slice's partial dropped) for checks that must catch one.
//
// band_slab_launch (P2, tools/probe_band_stream.py:probe_streams):
//   out[r] = V_pack[r] @ xp[r : r + 2 radius + 1].reshape((2 radius + 1) 128, F)
// V_pack (R, 128, W = (2 radius + 1) 128) and xp (R + 2 radius, 128, F)
// bf16, out (R, 128, F) f32; the window of row block r is the contiguous
// rows r*128 .. r*128 + W of xp. bf16 products are exact in f32 and every
// sum is f32, as the TPU kernel's preferred_element_type=f32 dots; the
// sums are stored unrounded. The TPU design covers chunk_rows row blocks
// per grid step and brings their packed rows and the shared x window in by
// double-buffered DMA (3.4 MB of VMEM at chunk_rows 8), so that the x
// window is read once for the slab's products.
//
// Bound on an H100 at the 1M point (R = 8192, radius 2, F = 128): 1.34 GB
// of packed rows + 0.27 GB of xp + 0.54 GB of f32 out is 0.64 ms at 3.35
// TB/s; the 172 GFLOP take 0.17 ms on the bf16 tensor cores but 2.6 ms as
// f32 FMAs on the CUDA cores, which held the first, SIMT design to 7.5-8.0
// ms. Here it runs on the tensor cores: B8's main loop (band_spmm.cu's
// band_spmm_tc_kernel on packed rows) over the slab. One block covers a
// slab of chunk_rows row blocks and N = BN feature columns (the narrowest
// of 16, 24, 32, 64, 128 and 256 that holds F, else 256; batched at most
// 128), has 256 consumer threads (two warpgroups) and one producer warp
// per ring. The producer's lane 0 streams each product in K = 64 chunks by
// TMA under the 128-byte swizzle: the packed row's 128 x 64 chunk as
// K-major A, the window's matching 64 rows of xp (contiguous, so no slot is
// skipped and no edge is masked: xp is padded) as MN-major B, zero past F.
// A 227 KB block holds no 3.4 MB window, so each row block reads its window
// again, from L2 (x read by five row blocks, as in B8). Each chunk's four
// k16 products go out while the previous chunk's finish, whose stage is
// then released. A row block's f32 sums leave through a per-warp staging
// area in 16-column groups, as 16-byte stores along the rows.
//   batched = 0 (the TPU kernel's per-row dots): one ring of four stages;
//     both warpgroups share each stage, warpgroup w owning rows 64 w ..
//     64 w + 63 of one row block, and the block walks the slab's row blocks
//     in turn, the ring running on across them;
//   batched = 1 (the TPU kernel's one batched dot per slab): two rings of
//     three stages, each with its own producer warp; warpgroup w takes row
//     blocks w, w + 2, ... of the slab, all 128 rows of each (two m64
//     products a k16 slice), both at once.
// chunk_rows and batched are launch shapes only: every row block's product
// is the same. Measured at the 1M point on an H100 (PERF.md): two per-row
// blocks an SM (three stages each) ran 12% slower than one; six stages, two
// sets of sums (a row block's stores after its successor's first products)
// and stores straight from the accumulators each came within 1% of this
// design. Batched runs ahead of per-row (0.90 against 0.98 ms).
// band_slab_launch_fault plants a fault (the k16 slice holding each row
// block's last contraction element dropped; each window read one row block
// late) for checks that must catch one. A view that the shape allows and
// cuTensorMapEncodeTiled refuses (an operand that is not 16-byte aligned)
// is a launch error.

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace wgmma_sm90;

// ------------------------------------------------------------ window_dot
constexpr int kWdThreads = 256;              // 16 x 16 threads
constexpr int kWdCols = 64;                  // output columns of a block
constexpr int kWdKc = 64;                    // window rows of one stage
constexpr int kWdLd = kWdKc + 4;             // row stride of a stage's V rows: float4 reads of two rows never collide
constexpr int kWdMinSlice = 16;              // window rows a slice takes at least
constexpr int kWdMaxSlices = 8;              // blocks of a cluster at most (the portable size)
constexpr int kWdFaultSlice = 1;             // the last slice's partial dropped

template <int TM>
struct WdTile {
  static constexpr int kRows = TM / 16;                  // output rows of a thread
  static constexpr int kA = TM * kWdLd;                  // floats of a stage's V rows
  static constexpr int kB = kWdKc * kWdCols;             // floats of a stage's X rows
  static constexpr size_t kSmem = 2 * (size_t)(kA + kB) * sizeof(float);
  static_assert(TM * kWdCols <= kA + kB, "a block's partial fits its first stage");
};

__device__ __forceinline__ float wd_lane(const float4& v, int i) { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// Stage `st` takes window rows k0 .. k0 + 64 (zero from k_end on) of V's
// rows i0 .. i0 + TM (zero from b on) and of X's columns f0 .. f0 + 64
// (zero from f on); 16-byte copies where a row's 16-byte units are whole
// (v16: W % 4 == 0; x16: F % 4 == 0; both operands 16-byte aligned), else
// 4-byte ones. One commit group.
template <int TM>
__device__ __forceinline__ void wd_fill(float* st, const float* vc, const float* xw, int i0, int f0, int k0,
                                        int k_end, int b, int w, int f, int v16, int x16, int tid) {
  float* as = st;
  float* bs = st + WdTile<TM>::kA;
  if (v16) {
    for (int q = tid; q < TM * (kWdKc / 4); q += kWdThreads) {
      const int r = q / (kWdKc / 4), k = k0 + 4 * (q % (kWdKc / 4));
      const bool ok = i0 + r < b && k < k_end;
      cp_async16(as + r * kWdLd + (k - k0), ok ? vc + (size_t)(i0 + r) * w + k : vc, ok);
    }
  } else {
    for (int q = tid; q < TM * kWdKc; q += kWdThreads) {
      const int r = q / kWdKc, k = k0 + q % kWdKc;
      const bool ok = i0 + r < b && k < k_end;
      cp_async4(as + r * kWdLd + (k - k0), ok ? vc + (size_t)(i0 + r) * w + k : vc, ok);
    }
  }
  if (x16) {
    for (int q = tid; q < kWdKc * (kWdCols / 4); q += kWdThreads) {
      const int kk = q / (kWdCols / 4), c = 4 * (q % (kWdCols / 4));
      const bool ok = k0 + kk < k_end && f0 + c < f;
      cp_async16(bs + kk * kWdCols + c, ok ? xw + (size_t)(k0 + kk) * f + f0 + c : xw, ok);
    }
  } else {
    for (int q = tid; q < kWdKc * kWdCols; q += kWdThreads) {
      const int kk = q / kWdCols, c = q % kWdCols;
      const bool ok = k0 + kk < k_end && f0 + c < f;
      cp_async4(bs + kk * kWdCols + c, ok ? xw + (size_t)(k0 + kk) * f + f0 + c : xw, ok);
    }
  }
  cp_async_commit();
}

// Block (slice s, tile t) of cluster t: s = the block's rank in its cluster
// of S = slices blocks along x. Output rows i0 .. i0 + TM and columns f0 ..
// f0 + 64 of tile t (mtiles row tiles a column tile), window rows s len ..
// (s + 1) len of every c = blockIdx.y, blockIdx.y + gridDim.y, ...
template <int TM>
__global__ void __launch_bounds__(kWdThreads)
window_dot_kernel(const float* __restrict__ v, const float* __restrict__ x, const int* __restrict__ starts,
                  float* __restrict__ out, int C, int b, int w, int f, int len, int mtiles, int v16, int x16,
                  int fault) {
  using Tile = WdTile<TM>;
  constexpr int R = Tile::kRows;
  extern __shared__ __align__(16) float wd_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), s = (int)cluster.block_rank();
  const int t = blockIdx.x / S;
  const int i0 = (t % mtiles) * TM, f0 = (t / mtiles) * kWdCols;
  const int k_begin = s * len, k_end = min(w, k_begin + len);
  const int chunks = (k_end - k_begin + kWdKc - 1) / kWdKc;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float* red = wd_smem;   // the block's partial, TM x 64, over the first stage once the products are done

  for (int c = blockIdx.y; c < C; c += gridDim.y) {
    const float* vc = v + (size_t)c * b * w;
    const float* xw = x + (size_t)starts[c] * f;   // the window's first row
    float acc[R][4];
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[j][l] = 0.f;
    // every stage's loads go out at once: two stages hold 128 of the slice's rows
    wd_fill<TM>(wd_smem, vc, xw, i0, f0, k_begin, k_end, b, w, f, v16, x16, tid);
    if (chunks > 1)
      wd_fill<TM>(wd_smem + Tile::kA + Tile::kB, vc, xw, i0, f0, k_begin + kWdKc, k_end, b, w, f, v16, x16, tid);
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch + 1 < chunks) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();
      const float* as = wd_smem + (size_t)(ch % 2) * (Tile::kA + Tile::kB);
      const float* bs = as + Tile::kA;
      const int k4n = (min(kWdKc, k_end - k_begin - ch * kWdKc) + 3) / 4;   // rows past k_end are zeros
#pragma unroll 4
      for (int k4 = 0; k4 < k4n; ++k4) {
        float4 a[R];
#pragma unroll
        for (int j = 0; j < R; ++j) a[j] = *reinterpret_cast<const float4*>(as + (ty + 16 * j) * kWdLd + 4 * k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 xv = *reinterpret_cast<const float4*>(bs + (4 * k4 + kk) * kWdCols + 4 * tx);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const float av = wd_lane(a[j], kk);
            acc[j][0] = fmaf(av, xv.x, acc[j][0]);
            acc[j][1] = fmaf(av, xv.y, acc[j][1]);
            acc[j][2] = fmaf(av, xv.z, acc[j][2]);
            acc[j][3] = fmaf(av, xv.w, acc[j][3]);
          }
        }
      }
      __syncthreads();   // the stage is read: the next chunk but one, or the partial, may take it
      if (ch + 2 < chunks)
        wd_fill<TM>(wd_smem + (size_t)(ch % 2) * (Tile::kA + Tile::kB), vc, xw, i0, f0, k_begin + (ch + 2) * kWdKc,
                    k_end, b, w, f, v16, x16, tid);
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
      *reinterpret_cast<float4*>(red + (ty + 16 * j) * kWdCols + 4 * tx) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    cluster.sync();   // every partial of the tile is in its block's shared memory
    // this block sums the tile's 16-byte units s, s + S, ... over the
    // cluster's partials in slice order (the same order at every call)
    const int last = fault == kWdFaultSlice ? S - 1 : S;
    for (int u = s + S * tid; u < TM * (kWdCols / 4); u += S * kWdThreads) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < last; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, r) + 4 * u);
        sum.x += p.x, sum.y += p.y, sum.z += p.z, sum.w += p.w;
      }
      const int i = i0 + u / (kWdCols / 4), col = f0 + 4 * (u % (kWdCols / 4));
      if (i >= b || col >= f) continue;
      float* o = out + ((size_t)c * b + i) * f + col;
      if (f % 4 == 0) {
        *reinterpret_cast<float4*>(o) = sum;
      } else {
        for (int l = 0; l < 4 && col + l < f; ++l) o[l] = wd_lane(sum, l);
      }
    }
    cluster.sync();   // the partials are read before any block writes its shared memory again or leaves
  }
}

template <int TM>
cudaError_t launch_window_dot(const float* v, const float* x, const int* starts, float* out, int c, int b, int w,
                              int f, int slices, int len, int fault, cudaStream_t stream) {
  auto kernel = window_dot_kernel<TM>;
  static unsigned long long ready = 0;   // the devices whose attributes are set (the first 64)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(ready >> dev & 1)) {
    err = allow_smem(kernel, WdTile<TM>::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready |= 1ull << dev;
  }
  const int mtiles = (b + TM - 1) / TM, tiles = mtiles * ((f + kWdCols - 1) / kWdCols);
  const int v16 = w % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int x16 = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(slices * tiles), (unsigned)std::min(c, 65535));
  cfg.blockDim = dim3(kWdThreads);
  cfg.dynamicSmemBytes = WdTile<TM>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, v, x, starts, out, c, b, w, f, len, mtiles, v16, x16, fault);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                 cudaSuccess)
    sms = 132;
  return sms;
}

// window_dot's launch shape for (C, b, W, F): the tile's rows and the
// slices (blocks of a cluster), each a multiple of 4 window rows, at least
// 16, at most 8 slices. The rows are the most of 64, 32 and 16 at which the
// slices that bring the grid nearest three quarters of the SMs (from
// below) cover at least half of them; else 16. On an H100 (PERF.md) P1 and
// P3 ran fastest at 96 blocks: 128 (clusters of 8) ran 27% slower at P1.
// slices_in / tm_in > 0 pin them.
void wd_plan(int c, int b, int w, int f, int slices_in, int tm_in, int* slices, int* len, int* tm) {
  const int most = std::min(std::min(8, std::max(1, (w + kWdMinSlice - 1) / kWdMinSlice)), std::max(1, (w + 3) / 4));
  const long cols = (f + kWdCols - 1) / kWdCols, sms = sm_count(), target = 3 * sms / 4;
  const int rows_of[3] = {64, 32, 16};
  int n = 1;
  for (int rows : rows_of) {
    const long tiles = (long)((b + rows - 1) / rows) * cols * c;
    *tm = rows;
    n = (int)std::max(1L, std::min((long)most, target / tiles));
    if (2 * n * tiles >= sms) break;
  }
  if (tm_in > 0) *tm = tm_in;
  if (slices_in > 0) n = std::min(slices_in, std::max(1, (w + 3) / 4));
  *len = ((w + n - 1) / n + 3) / 4 * 4;
  *slices = (w + *len - 1) / *len;
}

cudaError_t window_dot_run(const void* v, const void* x, const void* starts, void* out, int c, int b, int w, int f,
                           int slices_in, int tm_in, int fault, cudaStream_t stream) {
  if (c == 0 || b == 0 || f == 0) return cudaSuccess;
  if (w == 0) return cudaMemsetAsync(out, 0, (size_t)c * b * f * sizeof(float), stream);
  int slices, len, tm;
  wd_plan(c, b, w, f, slices_in, tm_in, &slices, &len, &tm);
  if (slices > kWdMaxSlices) return cudaErrorInvalidValue;
  const float* vf = static_cast<const float*>(v);
  const float* xf = static_cast<const float*>(x);
  const int* st = static_cast<const int*>(starts);
  float* of = static_cast<float*>(out);
  switch (tm) {
    case 64: return launch_window_dot<64>(vf, xf, st, of, c, b, w, f, slices, len, fault, stream);
    case 32: return launch_window_dot<32>(vf, xf, st, of, c, b, w, f, slices, len, fault, stream);
    case 16: return launch_window_dot<16>(vf, xf, st, of, c, b, w, f, slices, len, fault, stream);
    default: return cudaErrorInvalidValue;
  }
}

__global__ void empty_kernel() {}

// ------------------------------------------------------------ band_slab
using bf16 = __nv_bfloat16;

constexpr int kB = 128;                      // tile edge
constexpr int kKc = 64;                      // contraction rows of one ring stage
constexpr int kChunkA = kB * kKc;            // elements of a stage's packed-row chunk
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kStageCols = 16;               // output columns staged at a time
constexpr int kStageLd = kStageCols + 8;     // staged row stride: the float2 writes are conflict-free
constexpr int kFaultK16 = 1;                 // the k16 slice holding a row block's last contraction element dropped
constexpr int kFaultLate = 2;                // each window read one row block late
constexpr size_t kMaxSmem = 232448;          // 227 KB, the most a block may ask for on an H100

template <int BN, bool BATCHED>
struct SlabTile {
  static constexpr int kRings = BATCHED ? 2 : 1;         // a ring (and producer warp) per warpgroup when batched
  static constexpr int kStages = BATCHED ? 3 : 4;
  static constexpr int kWidthB = BN < 64 ? 64 : BN;       // columns of a window chunk: whole 128-byte rows
  static constexpr int kChunkB = kKc * kWidthB;
  static constexpr int kThreads = kConsumers + 32 * kRings;
  static constexpr size_t kSmem = 1024 + (size_t)kRings * kStages * (kChunkA + kChunkB) * sizeof(bf16) +
                                  (size_t)kConsumers / 32 * 16 * kStageLd * sizeof(float) +
                                  2 * kRings * kStages * sizeof(uint64_t);
  static_assert(kSmem <= kMaxSmem, "a band_slab tile exceeds a block's shared memory");
};

// out[r][:, f0 .. f0 + BN] for the row blocks r of slab blockIdx.y (chunk_rows
// cr of them, the last slab may be short), f0 = BN blockIdx.x. v_map views
// the packed rows as (R 128, W) and x_map xp as ((R + n_off - 1) 128, F),
// both under the 128-byte swizzle, boxes of 128 and 64 rows by 64 columns.
template <int BN, bool BATCHED>
__global__ void __launch_bounds__(SlabTile<BN, BATCHED>::kThreads, 1)
band_slab_tc_kernel(const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap x_map,
                    float* __restrict__ out, int R, int F, int n_off, int cr, int fault) {
  using Tile = SlabTile<BN, BATCHED>;
  constexpr int S = Tile::kStages, kRings = Tile::kRings, kHalves = BATCHED ? 2 : 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* as = reinterpret_cast<bf16*>(smem);                          // ring p's stage s: as + (p S + s) kChunkA
  bf16* bs = as + (size_t)kRings * S * kChunkA;                      // ... bs + (p S + s) kChunkB
  float* staged = reinterpret_cast<float*>(bs + (size_t)kRings * S * Tile::kChunkB);  // 16 x kStageLd a warp
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + (size_t)kConsumers / 32 * 16 * kStageLd);
  uint64_t* empty = full + kRings * S;

  const int slab0 = blockIdx.y * cr, rows = min(cr, R - slab0);
  const int f0 = blockIdx.x * BN;
  const int chunks = n_off * (kB / kKc);    // chunks of one row block's product
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kRings * S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, BATCHED ? 1 : 2);   // one arrival per warpgroup that reads the ring
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp p: row blocks p, p + kRings, ... of the slab, each
    // window's chunk c at xp row (r + late) 128 + 64 c
    const int p = (tid - kConsumers) / 32;
    if (tid % 32 != 0) return;
    const int late = fault == kFaultLate;
    int g = 0;
    for (int j = p; j < rows; j += kRings) {
      const int r = slab0 + j;
      for (int c = 0; c < chunks; ++c, ++g) {
        const int st = p * S + g % S;
        if (g >= S) mbar_wait(empty + st, ((g / S) & 1) ^ 1);
        bf16* ad = as + (size_t)st * kChunkA;
        bf16* bd = bs + (size_t)st * Tile::kChunkB;
        mbar_arrive_tx(full + st, (kChunkA + Tile::kChunkB) * (unsigned)sizeof(bf16));
        tma_load_2d(ad, &v_map, c * kKc, r * kB, full + st);
#pragma unroll
        for (int jb = 0; jb < Tile::kWidthB / 64; ++jb)
          tma_load_2d(bd + jb * 64 * kKc, &x_map, f0 + 64 * jb, (r + late) * kB + c * kKc, full + st);
      }
    }
    return;
  }

  // consumers: per-row, warpgroup wg owns rows 64 wg .. of each row block
  // from ring 0; batched, all 128 rows of row blocks wg, wg + 2, ... from
  // ring wg
  // (broadcast from lane 0, so that the compiler knows them uniform in the warp)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), warp = __shfl_sync(0xffffffffu, tid % 128 / 32, 0);
  const int lane = tid % 32;
  const int ring = BATCHED ? wg : 0;
  float* stage = staged + (size_t)(tid / 32) * 16 * kStageLd;
  float acc[kHalves][BN / 2];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.f;
  int g = 0;
  for (int j = BATCHED ? wg : 0; j < rows; j += kRings) {
    for (int c = 0; c < chunks; ++c, ++g) {
      const int st = ring * S + g % S;
      mbar_wait(full + st, (g / S) & 1);
      // the stage's packed-row chunk: 128 rows of 64 k (a warpgroup's 64
      // rows 8 KB apart); the window chunk: 64 k of kWidthB columns
      const unsigned char* ad = reinterpret_cast<const unsigned char*>(as + (size_t)st * kChunkA) +
                                (BATCHED ? 0 : wg * 8192);
      const unsigned char* bd = reinterpret_cast<const unsigned char*>(bs + (size_t)st * Tile::kChunkB);
      const int skip = fault == kFaultK16 && c == chunks - 1 ? kKc / 16 - 1 : -1;
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int ks = 0; ks < kKc / 16; ++ks)
          if (ks != skip)
            Wgmma<BN>::template mma_t<0, 1>(acc[h], desc_sw128(ad + 8192 * h + 32 * ks, 16u),
                                            desc_sw128(bd + 2048 * ks, 8192u), c > 0 || ks > 0);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();   // the previous chunk's products are done: free its stage
        if (tid % 128 == 0) mbar_arrive(empty + ring * S + (g - 1) % S);
      }
    }
    wgmma_wait<0>();
    if (tid % 128 == 0) mbar_arrive(empty + ring * S + (g - 1) % S);
    // the warp's 16 rows of each half through its staging, 16 columns at a
    // time, stored as 16-byte units along the rows (F % 8 == 0); every trip
    // count is known at compile time, so no lane leaves the warpgroup's path
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      float* o = out + ((size_t)(slab0 + j) * kB + 64 * (BATCHED ? h : wg) + 16 * warp) * F + f0;
#pragma unroll
      for (int cg = 0; cg < BN; cg += kStageCols) {
#pragma unroll
        for (int jj = 0; jj < kStageCols / 8; ++jj) {
          if (cg + 8 * jj < BN) {
            const int col = 8 * jj + 2 * (lane % 4), a = 4 * (cg / 8 + jj);
            *reinterpret_cast<float2*>(stage + (lane / 4) * kStageLd + col) = make_float2(acc[h][a], acc[h][a + 1]);
            *reinterpret_cast<float2*>(stage + (lane / 4 + 8) * kStageLd + col) =
                make_float2(acc[h][a + 2], acc[h][a + 3]);
          }
        }
        __syncwarp();
        const int units = (BN - cg < kStageCols ? BN - cg : kStageCols) / 4;   // 16-byte units of a row: 2 or 4
#pragma unroll
        for (int it = 0; it < kStageCols / 8; ++it) {
          if (it < units / 2) {   // 16 rows x units, 32 lanes at a time
            const int q = lane + 32 * it, i = q / units, c4 = 4 * (q % units);
            if (f0 + cg + c4 < F)
              *reinterpret_cast<float4*>(o + (size_t)i * F + cg + c4) =
                  *reinterpret_cast<const float4*>(stage + i * kStageLd + c4);
          }
        }
        __syncwarp();   // the staging is read before the next group writes it
      }
    }
  }
}

template <int BN, bool BATCHED>
cudaError_t launch_slab(const void* v_pack, const void* xp, float* out, int R, int F, int n_off, int cr, int fault,
                        cudaStream_t stream) {
  using Tile = SlabTile<BN, BATCHED>;
  auto kernel = band_slab_tc_kernel<BN, BATCHED>;
  cudaError_t err = allow_smem(kernel, Tile::kSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap v_map = {}, x_map = {};
  err = rows_view(&v_map, v_pack, R * kB, n_off * kB, kB);
  if (err == cudaSuccess) err = rows_view(&x_map, xp, (R + n_off - 1) * kB, F, kKc);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((F + BN - 1) / BN), (unsigned)((R + cr - 1) / cr));
  kernel<<<grid, Tile::kThreads, Tile::kSmem, stream>>>(v_map, x_map, out, R, F, n_off, cr, fault);
  return cudaGetLastError();
}

template <bool BATCHED>
cudaError_t launch_slab_tile(int bn, const void* v, const void* xp, float* out, int R, int F, int n_off, int cr,
                             int fault, cudaStream_t s) {
  switch (bn) {
    case 16: return launch_slab<16, BATCHED>(v, xp, out, R, F, n_off, cr, fault, s);
    case 24: return launch_slab<24, BATCHED>(v, xp, out, R, F, n_off, cr, fault, s);
    case 32: return launch_slab<32, BATCHED>(v, xp, out, R, F, n_off, cr, fault, s);
    case 64: return launch_slab<64, BATCHED>(v, xp, out, R, F, n_off, cr, fault, s);
    case 128: return launch_slab<128, BATCHED>(v, xp, out, R, F, n_off, cr, fault, s);
    default:
      if constexpr (BATCHED) return cudaErrorInvalidValue;   // two m64 sums of N = 256 do not fit the registers
      else return launch_slab<256, false>(v, xp, out, R, F, n_off, cr, fault, s);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
// starts: (C,) int32 on the device, each window inside X.
extern "C" int window_dot_launch(const void* v, const void* x, const void* starts, void* out, int c, int b,
                                 int w, int f, void* stream) {
  return (int)window_dot_run(v, x, starts, out, c, b, w, f, 0, 0, 0, static_cast<cudaStream_t>(stream));
}

// As window_dot_launch, with the slices (1 .. 8) and the tile's rows (16,
// 32 or 64) pinned where positive, and a fault planted (0: none, 1: the
// last slice's partial dropped).
extern "C" int window_dot_launch_plan(const void* v, const void* x, const void* starts, void* out, int c, int b,
                                      int w, int f, int slices, int rows, int fault, void* stream) {
  if (rows > 0 && rows != 16 && rows != 32 && rows != 64) return (int)cudaErrorInvalidValue;
  return (int)window_dot_run(v, x, starts, out, c, b, w, f, slices, rows, fault, static_cast<cudaStream_t>(stream));
}

// window_dot's launch shape for (C, b, W, F) on this card: 256 times the
// tile's rows plus the slices.
extern "C" int window_dot_plan(int c, int b, int w, int f) {
  int slices, len, tm;
  wd_plan(c, b, w, f, 0, 0, &slices, &len, &tm);
  return 256 * tm + slices;
}

// An empty kernel of one warp, the least a launch costs.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// The feature tile (wgmma N) a launch of band_slab takes: the narrowest of
// 16, 24, 32, 64, 128 and 256 (batched: 128) that holds F, else the widest;
// 0 where the kernel takes no such launch (F not a positive multiple of 8,
// no slot, no row block a slab).
extern "C" int band_slab_tile(int feat, int n_off, int chunk_rows, int batched) {
  if (feat < 1 || feat % 8 || n_off < 1 || chunk_rows < 1) return 0;
  const int widths[] = {16, 24, 32, 64, 128};
  for (int bn : widths)
    if (feat <= bn) return bn;
  return batched ? 128 : 256;
}

// As band_slab_launch, with a fault planted (0: none, 1: the k16 slice
// holding each row block's last contraction element dropped, 2: each
// window read one row block late).
extern "C" int band_slab_launch_fault(const void* v_pack, const void* xp, void* out, int n_blocks, int feat,
                                      int n_off, int chunk_rows, int batched, int fault, void* stream) {
  if (n_blocks == 0) return (int)cudaSuccess;
  const int bn = band_slab_tile(feat, n_off, chunk_rows, batched);
  if (bn == 0) return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return batched ? (int)launch_slab_tile<true>(bn, v_pack, xp, o, n_blocks, feat, n_off, chunk_rows, fault, s)
                 : (int)launch_slab_tile<false>(bn, v_pack, xp, o, n_blocks, feat, n_off, chunk_rows, fault, s);
}

// v_pack (R, 128, n_off 128) and xp (R + n_off - 1, 128, F) bf16, out (R,
// 128, F) f32; F a multiple of 8. Launches on `stream`; returns
// cudaGetLastError() after the launch, or the error of a TMA view that
// cannot be encoded (an operand that is not 16-byte aligned).
extern "C" int band_slab_launch(const void* v_pack, const void* xp, void* out, int n_blocks, int feat, int n_off,
                                int chunk_rows, int batched, void* stream) {
  return band_slab_launch_fault(v_pack, xp, out, n_blocks, feat, n_off, chunk_rows, batched, 0, stream);
}
