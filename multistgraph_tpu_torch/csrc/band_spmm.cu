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
// [0, R) contribute nothing: x is read with that bound, no padded copy.
// Operands are float32 or bfloat16, the tiles and x of one type (the
// wrapper casts as JAX does). Each element is widened to f32 as it is
// loaded, so a product of two bf16 values is exact and every sum is f32,
// the Pallas kernels' rounding (preferred_element_type=f32); the forward
// and dX round their f32 sums once to the operands' type, as JAX casts the
// result to x's dtype (multistgraph_tpu/ops/band.py:235,477,701), and dV
// rounds once to the values' type, which may differ from the operands'
// (band.py:642,736).
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
//   [0, R); written in the planes or the packed layout.
//
// Bound on an H100: the forward and dX are one (128x128)(128xF) product
// per present tile: at the 49,152-node band (5 diagonals, ~1,914 tiles)
// and F=128 that is 8.0 GFLOP, 0.12 ms at the 67 TFLOP/s f32 peak against
// 0.05 ms for the 126 MB of planes (bytes bound below F of about 55). dV
// contracts over F: the same FLOPs, writing the planes. This first design
// is bsr_spmm.cu's, plain f32 FMAs: one thread block per (output row
// block, feature tile of 16*TN columns); the block walks the row's
// diagonals, staging each tile in 128x32 chunks (transposed on the way in
// for dX: neighbouring threads read neighbouring columns of one tile row
// and store them down a padded shared-memory column, without bank
// conflicts) with the matching 32 rows of x; each of the 256 threads keeps
// 8 rows x TN columns in registers and writes them once, so dX needs no
// atomics and no zero fill: a row with no tile writes zeros. dV is
// sampled_matmul.cu's kernel on one tile per block. Tensor cores and
// pipelined loads come later. In bf16 at 1,000,000 nodes (7,813 row blocks,
// 1.28 GB of planes) and F=128 the bytes bound is ~0.53 ms and the 164
// GFLOP take ~0.17 ms on bf16 tensor cores, but ~2.4 ms as f32 FMAs on the
// CUDA cores, which is what bounds this design: the bf16 form halves the
// bytes and leaves the arithmetic as it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

constexpr int kBlock = 128;                 // tile edge
constexpr int kChunk = 32;                  // k rows staged per pass
constexpr int kThreads = 256;               // 16 x 16 threads
constexpr int kRowsPerThread = kBlock / 16; // 8
constexpr int kMaxOffsets = 8;

struct Offsets {
  int v[kMaxOffsets];
};

// Offset of the tile of slot s whose rows are row block `trow`; its row
// stride is ld (128 for planes, (2 radius + 1) 128 for packed rows).
template <bool PACKED>
__device__ __forceinline__ size_t tile_offset(int s, int trow, int R, int ld) {
  return PACKED ? (size_t)trow * kBlock * ld + (size_t)s * kBlock : ((size_t)s * R + trow) * kBlock * kBlock;
}

template <int TN, bool TRANS, bool PACKED, typename T>
__global__ void __launch_bounds__(kThreads)
band_spmm_kernel(const T* __restrict__ values, const T* __restrict__ x,
                 T* __restrict__ out, int R, int F, int n_slots, int radius, Offsets offs) {
  constexpr int FT = 16 * TN;                 // feature columns per block
  constexpr int W = TN < 4 ? TN : 4;          // contiguous columns per thread group
  constexpr int VEC = 16 / sizeof(T);         // elements per 16-byte load
  __shared__ float vs[kBlock][kChunk + 1];    // tile chunk: 128 rows x 32 k (padded)
  __shared__ __align__(16) float xs[kChunk][FT];

  const int r = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ld = PACKED ? n_slots * kBlock : kBlock;

  float acc[kRowsPerThread][TN];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
    for (int l = 0; l < TN; ++l) acc[j][l] = 0.f;

  for (int s = 0; s < n_slots; ++s) {
    const int o = PACKED ? s - radius : offs.v[s];
    const int src = TRANS ? r - o : r + o;  // the operand's row block (for dX also the tile's)
    if (src < 0 || src >= R) continue;      // the same for every thread of the block
    const T* v = values + tile_offset<PACKED>(s, TRANS ? src : r, R, ld);
    const T* xb = x + (size_t)src * kBlock * F;
    for (int k0 = 0; k0 < kBlock; k0 += kChunk) {
      __syncthreads();  // the previous chunk is no longer read
      if (TRANS) {
        // element (i, k) of the transposed tile is v[k][i]: a warp reads 32
        // neighbouring i of row k and stores them down column k
        for (int q = tid; q < kBlock * kChunk; q += kThreads) {
          const int k = q / kBlock, i = q % kBlock;
          vs[i][k] = widen(v[(size_t)(k0 + k) * ld + i]);
        }
      } else {
        // the tile's columns k0..k0+31: 16-byte loads, VEC elements each
        for (int q = tid; q < kBlock * kChunk / VEC; q += kThreads) {
          const int row = q / (kChunk / VEC), c = VEC * (q % (kChunk / VEC));
          const uint4 w = *reinterpret_cast<const uint4*>(v + (size_t)row * ld + k0 + c);
          const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
          for (int u = 0; u < VEC; ++u) vs[row][c + u] = widen(e[u]);
        }
      }
      // operand rows k0..k0+31 of block src, columns f0..f0+FT-1 (zero past F)
      for (int q = tid; q < kChunk * FT; q += kThreads) {
        const int k = q / FT, c = q % FT;
        const int f = f0 + c;
        xs[k][c] = f < F ? widen(xb[(size_t)(k0 + k) * F + f]) : 0.f;
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
    T* o = out + ((size_t)r * kBlock + ty + 16 * j) * F;
#pragma unroll
    for (int l = 0; l < TN; ++l) {
      const int f = f0 + (l / W) * 16 * W + tx * W + l % W;
      if (f < F) o[f] = narrow<T>(acc[j][l]);
    }
  }
}

template <bool PACKED, typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
band_dv_kernel(const T* __restrict__ dy, const T* __restrict__ x, OutT* __restrict__ out,
               int R, int d, int n_slots, int radius, Offsets offs) {
  __shared__ float as[kBlock][kChunk + 1];
  __shared__ float bs[kBlock][kChunk + 1];

  const int r = blockIdx.x, s = blockIdx.y;
  const int c = r + (PACKED ? s - radius : offs.v[s]);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ld = PACKED ? n_slots * kBlock : kBlock;

  float acc[kRowsPerThread][kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
    for (int l = 0; l < kRowsPerThread; ++l) acc[j][l] = 0.f;

  if (c >= 0 && c < R) {  // else the tile stays zero; the same for the whole block
    const T* ab = dy + (size_t)r * kBlock * d;
    const T* bb = x + (size_t)c * kBlock * d;
    for (int k0 = 0; k0 < d; k0 += kChunk) {
      __syncthreads();  // the previous chunk is no longer read
      // a warp reads 32 neighbouring k of one row (zero past d)
      for (int q = tid; q < kBlock * kChunk; q += kThreads) {
        const int row = q / kChunk, k = q % kChunk;
        const bool in = k0 + k < d;
        as[row][k] = in ? widen(ab[(size_t)row * d + k0 + k]) : 0.f;
        bs[row][k] = in ? widen(bb[(size_t)row * d + k0 + k]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kChunk; ++k) {
        float pa[kRowsPerThread], pb[kRowsPerThread];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) pa[j] = as[ty + 16 * j][k];
#pragma unroll
        for (int l = 0; l < kRowsPerThread; ++l) pb[l] = bs[tx + 16 * l][k];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
          for (int l = 0; l < kRowsPerThread; ++l) acc[j][l] = fmaf(pa[j], pb[l], acc[j][l]);
      }
    }
  }

  OutT* ot = out + tile_offset<PACKED>(s, r, R, ld);
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
    for (int l = 0; l < kRowsPerThread; ++l)
      ot[(size_t)(ty + 16 * j) * ld + tx + 16 * l] = narrow<OutT>(acc[j][l]);
}

template <bool TRANS, bool PACKED, typename T>
cudaError_t launch_spmm(const void* values, const void* x, void* out, int R, int F, int n_slots,
                        int radius, const Offsets& offs, cudaStream_t stream) {
  const T* v = static_cast<const T*>(values);
  const T* xx = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
#define BAND_LAUNCH(TN)                                                                       \
  band_spmm_kernel<TN, TRANS, PACKED, T>                                                       \
      <<<dim3((unsigned)((F + 16 * TN - 1) / (16 * TN)), (unsigned)R), kThreads, 0, stream>>>( \
          v, xx, o, R, F, n_slots, radius, offs)
  if (F <= 16) BAND_LAUNCH(1);
  else if (F <= 32) BAND_LAUNCH(2);
  else if (F <= 64) BAND_LAUNCH(4);
  else BAND_LAUNCH(8);
#undef BAND_LAUNCH
  return cudaGetLastError();
}

Offsets make_offsets(int o0, int o1, int o2, int o3, int o4, int o5, int o6, int o7) {
  Offsets offs = {{o0, o1, o2, o3, o4, o5, o6, o7}};
  return offs;
}

template <bool TRANS, bool PACKED>
cudaError_t launch_spmm_typed(int dtype, const void* v, const void* x, void* out, int R, int F, int n_slots,
                              int radius, const Offsets& offs, cudaStream_t stream) {
  return dtype ? launch_spmm<TRANS, PACKED, __nv_bfloat16>(v, x, out, R, F, n_slots, radius, offs, stream)
               : launch_spmm<TRANS, PACKED, float>(v, x, out, R, F, n_slots, radius, offs, stream);
}

template <bool PACKED, typename T, typename OutT>
cudaError_t launch_dv(const void* dy, const void* x, void* out, int R, int d, int n_slots, int radius,
                      const Offsets& offs, cudaStream_t stream) {
  const dim3 grid((unsigned)R, (unsigned)n_slots);
  band_dv_kernel<PACKED, T, OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<OutT*>(out), R, d, n_slots, radius, offs);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_dv_typed(int in_dtype, int out_dtype, const void* dy, const void* x, void* out, int R,
                            int d, int n_slots, int radius, const Offsets& offs, cudaStream_t stream) {
  if (in_dtype)
    return out_dtype ? launch_dv<PACKED, __nv_bfloat16, __nv_bfloat16>(dy, x, out, R, d, n_slots, radius, offs, stream)
                     : launch_dv<PACKED, __nv_bfloat16, float>(dy, x, out, R, d, n_slots, radius, offs, stream);
  return out_dtype ? launch_dv<PACKED, float, __nv_bfloat16>(dy, x, out, R, d, n_slots, radius, offs, stream)
                   : launch_dv<PACKED, float, float>(dy, x, out, R, d, n_slots, radius, offs, stream);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch. For the
// planes, n_slots = O <= 8 and o0..o7 the offsets; for packed rows, n_slots =
// 2 radius + 1 and the offsets are implied. dtype (and in_dtype, out_dtype):
// 0 float32, 1 bfloat16.
extern "C" int band_spmm_launch(const void* values, const void* x, void* out, int n_blocks, int feat,
                                int n_slots, int radius, int packed, int transposed, int dtype, int o0,
                                int o1, int o2, int o3, int o4, int o5, int o6, int o7, void* stream) {
  if (n_blocks == 0 || feat == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Offsets offs = make_offsets(o0, o1, o2, o3, o4, o5, o6, o7);
  if (transposed) {
    return packed ? (int)launch_spmm_typed<true, true>(dtype, values, x, out, n_blocks, feat, n_slots, radius, offs, s)
                  : (int)launch_spmm_typed<true, false>(dtype, values, x, out, n_blocks, feat, n_slots, radius, offs, s);
  }
  return packed ? (int)launch_spmm_typed<false, true>(dtype, values, x, out, n_blocks, feat, n_slots, radius, offs, s)
                : (int)launch_spmm_typed<false, false>(dtype, values, x, out, n_blocks, feat, n_slots, radius, offs, s);
}

extern "C" int band_dv_launch(const void* dy, const void* x, void* out, int n_blocks, int feat,
                              int n_slots, int radius, int packed, int in_dtype, int out_dtype, int o0,
                              int o1, int o2, int o3, int o4, int o5, int o6, int o7, void* stream) {
  if (n_blocks == 0 || n_slots == 0) return (int)cudaSuccess;
  const Offsets offs = make_offsets(o0, o1, o2, o3, o4, o5, o6, o7);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return packed ? (int)launch_dv_typed<true>(in_dtype, out_dtype, dy, x, out, n_blocks, feat, n_slots, radius, offs, s)
                : (int)launch_dv_typed<false>(in_dtype, out_dtype, dy, x, out, n_blocks, feat, n_slots, radius, offs, s);
}
