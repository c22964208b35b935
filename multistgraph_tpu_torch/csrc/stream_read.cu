// Stream read for Hopper (sm_90a): kernels B11 D, B10 and B12's stream rate.
//
// Reads every byte of up to 8 streams (bf16 arrays, 16 bytes a thread,
// neighbouring threads on neighbouring addresses) and writes the small
// value that each TPU kernel defines. Every loaded word is summed (32-bit,
// wrapping) into a per-block checksum, so no load can be dropped by the
// compiler, and the checksum shows that every byte was read: the sum over
// blocks equals the sum of all the streams' 32-bit words. Modes:
//
//   floor (B11 D, tools/bench_node_dots.py: _d_kernel / make_d): streams
//     hh and w; out (rows_out, cols_out) bf16 =
//     bf16( (f32(hh[off0 + r*ld0 + j]) + f32(w[off1 + j])) + *s ), the last
//     grid step's slice of the TPU kernel, rounded once.
//   column sum (B10, tools/bench_hbm_peak.py: pallas_read): one (rows,
//     width) stream; out (1, 128) f32 += count * *s + sum_r x[r, j] for
//     j < 128, the TPU kernel's grid of `count` steps each adding s and
//     its block's column sums. out must be zero on entry; blocks add their
//     partial sums with atomics, so the f32 order varies from run to run.
//   rate (B12, tools/bench_stream_rate.py: _kernel): n streams; out (1,
//     cols_out) f32 = ((*s + f32(a_0[off0 + j])) + f32(a_1[off1 + j])) + ...,
//     in the TPU kernel's order, the last grid step's row.
//
// Bound on an H100: bytes, each read once: 256 MB for B10 (80 us at 3.35
// TB/s), 94.4 MB for B11 D (28 us), 512 MB for the stream-rate sweep. The
// design is a grid-stride loop of 16-byte loads, four in flight a thread,
// in one wave of 256-thread blocks (as many as the kernel's registers let
// share each SM, so no block waits for a second wave); block 0 writes the
// defined slice of the floor and rate modes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStreams = 8;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kColumns = 128;               // columns the column-sum mode reduces

enum Mode { kFloor = 0, kColumnSum = 1, kRate = 2 };

struct Streams {
  const uint4* p[kMaxStreams];
  long long n16[kMaxStreams];               // 16-byte words of each stream
  long long off[kMaxStreams];               // element offset of the defining slice
  int count;
};

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t fold(const uint4& v) { return v.x + v.y + v.z + v.w; }

__device__ __forceinline__ void add_columns(float* col, const uint4& v) {
  col[0] += lo(v.x); col[1] += hi(v.x); col[2] += lo(v.y); col[3] += hi(v.y);
  col[4] += lo(v.z); col[5] += hi(v.z); col[6] += lo(v.w); col[7] += hi(v.w);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
stream_read_kernel(Streams st, const float* __restrict__ s, void* __restrict__ out,
                   uint32_t* __restrict__ checksum, int checksum_len, int rows_out, int cols_out,
                   long long ld0, int width, float count) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long gt = (long long)blockIdx.x * kThreads + threadIdx.x;
  uint32_t sum = 0;
  float col[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // column-sum mode: stride is a multiple of width/8 (checked by the
  // wrapper), so every word this thread loads holds the same 8 columns
  const int c8 = MODE == kColumnSum ? (int)(gt % (width / 8)) * 8 : 0;
  const bool sums = MODE == kColumnSum && c8 < kColumns;

  for (int r = 0; r < st.count; ++r) {
    const uint4* p = st.p[r];
    const long long n = st.n16[r];
    long long q = gt;
    for (; q + 3 * stride < n; q += 4 * stride) {
      const uint4 v0 = __ldg(p + q), v1 = __ldg(p + q + stride);
      const uint4 v2 = __ldg(p + q + 2 * stride), v3 = __ldg(p + q + 3 * stride);
      sum += fold(v0) + fold(v1) + fold(v2) + fold(v3);
      if (sums) {
        add_columns(col, v0); add_columns(col, v1); add_columns(col, v2); add_columns(col, v3);
      }
    }
    for (; q < n; q += stride) {
      const uint4 v = __ldg(p + q);
      sum += fold(v);
      if (sums) add_columns(col, v);
    }
  }

  __shared__ uint32_t warp_sums[kThreads / 32];
  __shared__ float colsum[kColumns];
  if (MODE == kColumnSum) {
    for (int j = threadIdx.x; j < kColumns; j += kThreads) colsum[j] = 0.f;
  }
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    checksum[blockIdx.x] = total;
  }
  if (blockIdx.x == 0) {
    for (int j = gridDim.x + threadIdx.x; j < checksum_len; j += kThreads) checksum[j] = 0u;
  }

  if (MODE == kColumnSum) {
    if (sums) {
#pragma unroll
      for (int l = 0; l < 8; ++l) atomicAdd(&colsum[c8 + l], col[l]);
    }
    __syncthreads();
    float* o = static_cast<float*>(out);
    for (int j = threadIdx.x; j < kColumns; j += kThreads) {
      float v = colsum[j];
      if (blockIdx.x == 0) v += count * *s;
      atomicAdd(&o[j], v);
    }
  } else if (blockIdx.x == 0) {
    const float sv = *s;
    if (MODE == kFloor) {
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(st.p[0]) + st.off[0];
      const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(st.p[1]) + st.off[1];
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
      for (int idx = threadIdx.x; idx < rows_out * cols_out; idx += kThreads) {
        const int r = idx / cols_out, j = idx - r * cols_out;
        const float v = (__bfloat162float(h[(size_t)r * ld0 + j]) + __bfloat162float(w[j])) + sv;
        o[idx] = __float2bfloat16(v);
      }
    } else {
      float* o = static_cast<float*>(out);
      for (int j = threadIdx.x; j < cols_out; j += kThreads) {
        float acc = sv + __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(st.p[0])[st.off[0] + j]);
        for (int r = 1; r < st.count; ++r)
          acc = acc + __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(st.p[r])[st.off[r] + j]);
        o[j] = acc;
      }
    }
  }
}

// One wave: as many blocks as fit on the card at once (the kernel's
// registers decide how many share an SM), at most `cap`, at least 1, and no
// more than one 16-byte word a thread of the longest stream.
template <int MODE>
cudaError_t launch(const Streams& st, long long most, const float* s, void* out, uint32_t* checksum, int cap,
                   int rows_out, int cols_out, long long ld0, int width, float grid_count, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_read_kernel<MODE>, kThreads, 0);
  if (err != cudaSuccess) return err;
  long long blocks = (most + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  stream_read_kernel<MODE><<<(unsigned)blocks, kThreads, 0, stream>>>(
      st, s, out, checksum, cap, rows_out, cols_out, ld0, width, grid_count);
  return cudaGetLastError();
}

}  // namespace

// The number of blocks a launch uses at most; the checksum output holds one
// word for each (the unused ones are written 0).
extern "C" int stream_read_max_blocks(void) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  return sms * kBlocksPerSM;
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
// ptrs/n16/offs: host arrays of `count` stream pointers (16-byte aligned),
// their sizes in 16-byte words and their slices' element offsets.
// checksum holds checksum_len >= stream_read_max_blocks() words.
extern "C" int stream_read(int mode, const void* const* ptrs, const long long* n16, const long long* offs,
                           int count, const void* s, void* out, void* checksum, int checksum_len,
                           int rows_out, int cols_out, long long ld0, int width, float grid_count,
                           void* stream) {
  if (count < 1 || count > kMaxStreams) return (int)cudaErrorInvalidValue;
  Streams st{};
  long long most = 0;
  for (int r = 0; r < count; ++r) {
    st.p[r] = static_cast<const uint4*>(ptrs[r]);
    st.n16[r] = n16[r];
    st.off[r] = offs[r];
    most = n16[r] > most ? n16[r] : most;
  }
  st.count = count;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  uint32_t* ck = static_cast<uint32_t*>(checksum);
  cudaError_t err;
  if (mode == kFloor)
    err = launch<kFloor>(st, most, sp, out, ck, checksum_len, rows_out, cols_out, ld0, width, grid_count, cs);
  else if (mode == kColumnSum)
    err = launch<kColumnSum>(st, most, sp, out, ck, checksum_len, rows_out, cols_out, ld0, width, grid_count, cs);
  else if (mode == kRate)
    err = launch<kRate>(st, most, sp, out, ck, checksum_len, rows_out, cols_out, ld0, width, grid_count, cs);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
