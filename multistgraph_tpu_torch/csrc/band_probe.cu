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
// slice; the product they compute is this one. Tiny shapes (under 0.1
// GFLOP): launch-bound. One block per (64 x 64 output tile, c), 4 x 4
// outputs a thread, k staged 16 at a time; plain f32 FMAs.
//
// band_slab_launch (P2, tools/probe_band_stream.py:probe_streams):
//   out[r] = V_pack[r] @ xp[r : r + 2 radius + 1].reshape((2 radius + 1) 128, F)
// V_pack (R, 128, W = (2 radius + 1) 128) and xp (R + 2 radius, 128, F)
// bf16, out (R, 128, F) f32; the window of row block r is the contiguous
// rows r*128 .. r*128 + W of xp. Each element is widened to f32 as it is
// loaded: bf16 products are exact and every sum is f32, as the TPU
// kernel's preferred_element_type=f32 dots. The TPU design covers
// chunk_rows row blocks per grid step and brings their packed rows and the
// shared x window in by double-buffered DMA, so that the chunk_rows + 2
// radius x blocks are read once for all chunk_rows products. Here one
// thread block covers a slab of chunk_rows row blocks and one tile of FT
// feature columns: it stages the slab's x window (chunk_rows + 2 radius
// blocks x FT columns) in shared memory once, with cp.async, and streams
// the packed rows through shared memory in 128 x 16 chunks, double
// buffered with cp.async, as the TPU kernel's DMA double buffer does. The
// TPU scratch, (2, cr, 128, 640) bf16 + (2, cr + 4, 128, 128), is 3.4 MB at
// cr = 8; a block has 227 KB, so the packed rows come in k-chunks and F in
// tiles (FT = 64 columns at cr = 8: 192 KB of window). The feature tile
// varies fastest over the grid, so the F / FT blocks of one slab run
// together and the second read of its packed rows comes from L2.
//   batched = 0 (the TPU kernel's per-row dots): all 8 warps work on one
//     row block's 128 x FT product at a time, sharing each staged chunk of
//     its packed row, and run the slab's row blocks in turn;
//   batched = 1 (the TPU kernel's one batched dot per slab): the warps
//     split over the slab's row blocks at once, each warp streaming its own
//     row block's packed row through its own double buffer (FT = 16).
// Bound on an H100 at the 1M point (R = 8192, radius 2, F = 128): 1.34 GB
// of packed rows + 0.27 GB of xp + 0.54 GB of f32 out is 0.64 ms at 3.35
// TB/s; the 172 GFLOP are 0.17 ms on bf16 tensor cores but 2.6 ms as f32
// FMAs on the CUDA cores, which bound this first design. Tensor cores
// (mma on the staged bf16 tiles) come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ window_dot
constexpr int kWdThreads = 256;
constexpr int kWdTile = 64;
constexpr int kWdK = 16;

__global__ void __launch_bounds__(kWdThreads)
window_dot_kernel(const float* __restrict__ v, const float* __restrict__ x, const int* __restrict__ starts,
                  float* __restrict__ out, int b, int w, int f) {
  __shared__ float vs[kWdTile][kWdK + 1];
  __shared__ float xs[kWdK][kWdTile];
  const int c = blockIdx.z;
  const int i0 = blockIdx.y * kWdTile, f0 = blockIdx.x * kWdTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* vc = v + (size_t)c * b * w;
  const float* xw = x + (size_t)starts[c] * f;  // the window's first row

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[j][l] = 0.f;

  for (int k0 = 0; k0 < w; k0 += kWdK) {
    for (int q = tid; q < kWdTile * kWdK; q += kWdThreads) {
      const int i = q / kWdK, k = q % kWdK;  // a warp reads 16 neighbouring k of two rows
      vs[i][k] = (i0 + i < b && k0 + k < w) ? vc[(size_t)(i0 + i) * w + k0 + k] : 0.f;
      const int kk = q / kWdTile, col = q % kWdTile;
      xs[kk][col] = (k0 + kk < w && f0 + col < f) ? xw[(size_t)(k0 + kk) * f + f0 + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWdK; ++k) {
      float a[4], bb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = vs[ty + 16 * j][k];
#pragma unroll
      for (int l = 0; l < 4; ++l) bb[l] = xs[k][tx + 16 * l];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[j][l] = fmaf(a[j], bb[l], acc[j][l]);
    }
    __syncthreads();  // the chunk is no longer read
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = i0 + ty + 16 * j;
    if (i >= b) continue;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int col = f0 + tx + 16 * l;
      if (col < f) out[((size_t)c * b + i) * f + col] = acc[j][l];
    }
  }
}

// ------------------------------------------------------------ band_slab
using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kB = 128;             // tile edge
constexpr int kKC = 16;             // k columns of a packed row staged per pass
constexpr int kVLd = kKC + 8;       // staged row stride (48 bytes: 16-byte rows, no bank conflicts)
constexpr int kVBuf = kB * kVLd;    // one staged chunk, elements

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The slab's x window, (rows + 2 radius) blocks of 128 rows x FT columns,
// into shared memory in 16-byte pieces (columns past F are not read).
template <int FT>
__device__ __forceinline__ void stage_window(bf16* xwin, const bf16* xp, int slab0, int win_blocks, int F,
                                             int f0, int tid) {
  constexpr int kPieces = FT / 8;
  const bf16* src = xp + (size_t)slab0 * kB * F + f0;
  for (int q = tid; q < win_blocks * kB * kPieces; q += kThreads) {
    const int row = q / kPieces, p = q % kPieces;
    if (f0 + p * 8 < F) cp_async16(xwin + (size_t)row * FT + p * 8, src + (size_t)row * F + p * 8);
  }
}

// Columns kc*16 .. kc*16+15 of the 128 rows of one packed row block, by
// `n` threads numbered `t`.
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* vrow, int W, int kc, int t, int n) {
  for (int q = t; q < kB * (kKC / 8); q += n) {
    const int row = q / (kKC / 8), p = q % (kKC / 8);
    cp_async16(dst + row * kVLd + p * 8, vrow + (size_t)row * W + kc * kKC + p * 8);
  }
}

template <int CPT>
__device__ __forceinline__ void store_cols(float* o, const float* acc) {
  if constexpr (CPT == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  }
}

// batched = 0: the block's 8 warps run one row block's product at a time.
template <int FT>
__global__ void __launch_bounds__(kThreads)
band_slab_rows_kernel(const bf16* __restrict__ v, const bf16* __restrict__ xp, float* __restrict__ out, int R,
                      int F, int n_off, int cr) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CPT = FT >= 16 ? 4 : 2;         // columns a thread holds
  constexpr int TX = FT / CPT, TY = kThreads / TX, RPT = kB / TY;
  const int W = n_off * kB, kpr = W / kKC;
  const int slab0 = blockIdx.y * cr, rows = min(cr, R - slab0);
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  bf16* xwin = reinterpret_cast<bf16*>(smem);
  bf16* vbuf = xwin + (size_t)(cr + n_off - 1) * kB * FT;

  stage_window<FT>(xwin, xp, slab0, rows + n_off - 1, F, f0, tid);
  cp_async_commit();
  stage_chunk(vbuf, v + (size_t)slab0 * kB * W, W, 0, tid, kThreads);
  cp_async_commit();

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int l = 0; l < CPT; ++l) acc[i][l] = 0.f;

  const int steps = rows * kpr;
  for (int t = 0; t < steps; ++t) {
    const int j = t / kpr, kc = t % kpr;
    if (t + 1 < steps) {
      const int jn = (t + 1) / kpr;
      stage_chunk(vbuf + ((t + 1) & 1) * kVBuf, v + (size_t)(slab0 + jn) * kB * W, W, (t + 1) % kpr, tid,
                  kThreads);
    }
    cp_async_commit();
    cp_async_wait<1>();  // the window and step t's chunk have landed
    __syncthreads();
    const bf16* vs = vbuf + (t & 1) * kVBuf;
    const bf16* xs = xwin + ((size_t)j * kB + kc * kKC) * FT;  // window row j*128 + k of the slab
#pragma unroll
    for (int k = 0; k < kKC; ++k) {
      float a[RPT], bb[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = __bfloat162float(vs[(ty + TY * i) * kVLd + k]);
#pragma unroll
      for (int l = 0; l < CPT; ++l) bb[l] = __bfloat162float(xs[k * FT + tx * CPT + l]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int l = 0; l < CPT; ++l) acc[i][l] = fmaf(a[i], bb[l], acc[i][l]);
    }
    __syncthreads();  // this chunk's buffer is free for step t + 2
    if (kc == kpr - 1) {
      const int f = f0 + tx * CPT;
      if (f < F) {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          store_cols<CPT>(out + ((size_t)(slab0 + j) * kB + ty + TY * i) * F + f, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int l = 0; l < CPT; ++l) acc[i][l] = 0.f;
    }
  }
}

// batched = 1: warp w runs row blocks w, w + 8, ... of the slab, each
// through its own double buffer, all warps at once.
template <int FT>
__global__ void __launch_bounds__(kThreads)
band_slab_warps_kernel(const bf16* __restrict__ v, const bf16* __restrict__ xp, float* __restrict__ out, int R,
                       int F, int n_off, int cr) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CPL = 4;                        // columns a lane holds
  constexpr int LX = FT / CPL, LY = 32 / LX, RPL = kB / LY;
  const int W = n_off * kB, kpr = W / kKC;
  const int slab0 = blockIdx.y * cr, rows = min(cr, R - slab0);
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lx = lane % LX, ly = lane / LX;
  bf16* xwin = reinterpret_cast<bf16*>(smem);
  bf16* vbuf = xwin + (size_t)(cr + n_off - 1) * kB * FT + (size_t)warp * 2 * kVBuf;

  stage_window<FT>(xwin, xp, slab0, rows + n_off - 1, F, f0, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int j = warp; j < rows; j += kWarps) {
    const bf16* vrow = v + (size_t)(slab0 + j) * kB * W;
    float acc[RPL][CPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i)
#pragma unroll
      for (int l = 0; l < CPL; ++l) acc[i][l] = 0.f;
    stage_chunk(vbuf, vrow, W, 0, lane, 32);
    cp_async_commit();
    for (int kc = 0; kc < kpr; ++kc) {
      if (kc + 1 < kpr) stage_chunk(vbuf + ((kc + 1) & 1) * kVBuf, vrow, W, kc + 1, lane, 32);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();
      const bf16* vs = vbuf + (kc & 1) * kVBuf;
      const bf16* xs = xwin + ((size_t)j * kB + kc * kKC) * FT;
#pragma unroll
      for (int k = 0; k < kKC; ++k) {
        float a[RPL], bb[CPL];
#pragma unroll
        for (int i = 0; i < RPL; ++i) a[i] = __bfloat162float(vs[(ly + LY * i) * kVLd + k]);
#pragma unroll
        for (int l = 0; l < CPL; ++l) bb[l] = __bfloat162float(xs[k * FT + lx * CPL + l]);
#pragma unroll
        for (int i = 0; i < RPL; ++i)
#pragma unroll
          for (int l = 0; l < CPL; ++l) acc[i][l] = fmaf(a[i], bb[l], acc[i][l]);
      }
      __syncwarp();  // this chunk's buffer is free for chunk kc + 2
    }
    const int f = f0 + lx * CPL;
    if (f < F) {
#pragma unroll
      for (int i = 0; i < RPL; ++i)
        store_cols<CPL>(out + ((size_t)(slab0 + j) * kB + ly + LY * i) * F + f, acc[i]);
    }
  }
}

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may ask for on an H100

size_t slab_smem(int ft, int cr, int n_off, bool batched) {
  const size_t window = (size_t)(cr + n_off - 1) * kB * ft * sizeof(bf16);
  return window + (size_t)(batched ? kWarps : 1) * 2 * kVBuf * sizeof(bf16);
}

template <typename Kernel>
cudaError_t launch_slab(Kernel kernel, int ft, size_t smem, const bf16* v, const bf16* xp, float* out, int R,
                        int F, int n_off, int cr, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((F + ft - 1) / ft), (unsigned)((R + cr - 1) / cr));
  kernel<<<grid, kThreads, smem, stream>>>(v, xp, out, R, F, n_off, cr);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
// starts: (C,) int32 on the device, each window inside X.
extern "C" int window_dot_launch(const void* v, const void* x, const void* starts, void* out, int c, int b,
                                 int w, int f, void* stream) {
  if (c == 0 || b == 0 || f == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((f + kWdTile - 1) / kWdTile), (unsigned)((b + kWdTile - 1) / kWdTile), (unsigned)c);
  window_dot_kernel<<<grid, kWdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(x), static_cast<const int*>(starts),
      static_cast<float*>(out), b, w, f);
  return (int)cudaGetLastError();
}

// The feature tile a launch of band_slab takes (0 if no tile fits the
// shared memory): per-row, the widest of 64, 32, 16, 8 columns that fits
// and that F needs; batched, 16 (8 where F is 8).
extern "C" int band_slab_tile(int feat, int n_off, int chunk_rows, int batched) {
  const int widest = batched ? 16 : 64;
  for (int ft = widest; ft >= 8; ft /= 2) {
    if (ft > 8 && ft / 2 >= feat) continue;  // a narrower tile covers F
    if (slab_smem(ft, chunk_rows, n_off, batched) <= kMaxSmem) return ft;
  }
  return 0;
}

// v_pack (R, 128, n_off 128) and xp (R + n_off - 1, 128, F) bf16, out (R,
// 128, F) f32; F a multiple of 8, every pointer 16-byte aligned.
extern "C" int band_slab_launch(const void* v_pack, const void* xp, void* out, int n_blocks, int feat, int n_off,
                                int chunk_rows, int batched, void* stream) {
  if (n_blocks == 0 || feat == 0) return (int)cudaSuccess;
  const int ft = band_slab_tile(feat, n_off, chunk_rows, batched);
  if (ft == 0) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = slab_smem(ft, chunk_rows, n_off, batched);
  const bf16* v = static_cast<const bf16*>(v_pack);
  const bf16* x = static_cast<const bf16*>(xp);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batched) {
    return ft == 16 ? (int)launch_slab(band_slab_warps_kernel<16>, ft, smem, v, x, o, n_blocks, feat, n_off, chunk_rows, s)
                    : (int)launch_slab(band_slab_warps_kernel<8>, ft, smem, v, x, o, n_blocks, feat, n_off, chunk_rows, s);
  }
  switch (ft) {
    case 64: return (int)launch_slab(band_slab_rows_kernel<64>, ft, smem, v, x, o, n_blocks, feat, n_off, chunk_rows, s);
    case 32: return (int)launch_slab(band_slab_rows_kernel<32>, ft, smem, v, x, o, n_blocks, feat, n_off, chunk_rows, s);
    case 16: return (int)launch_slab(band_slab_rows_kernel<16>, ft, smem, v, x, o, n_blocks, feat, n_off, chunk_rows, s);
    default: return (int)launch_slab(band_slab_rows_kernel<8>, ft, smem, v, x, o, n_blocks, feat, n_off, chunk_rows, s);
  }
}
