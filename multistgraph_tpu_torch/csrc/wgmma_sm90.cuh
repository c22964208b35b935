// Warpgroup tensor-core, TMA and mbarrier primitives for Hopper (sm_90a), shared by
// the kernels that run 16-bit products on wgmma: node_dots.cu (B11 A),
// node_factored.cu (B1 / B11 B, bf16 operands), node_factored_t.cu (B1t,
// bf16 operands), band_probe.cu (band_slab, P2), node_apply_q8.cuh (B2 and
// B2t, int8 weights widened to bf16 on chip), and on bf16 or f16 operands
// band_spmm.cu (B7, B8, B9 dX and B9 dV), bsr_spmm.cu (B4/B6) and
// sampled_matmul.cu (B5).
//
// Shared-memory operands are kept as 8x8 "core matrices" of bf16, each 128
// contiguous bytes (8 rows of 16 bytes), without swizzle. An operand of X
// rows (M or N) by K is stored with element (x, k) at
//
//   core_offset(x, k, KG) = ((x / 8) * KG + k / 8) * 64 + (x % 8) * 8 + k % 8     (K-major)
//   core_offset_mn(k, x, KG) = ((x / 8) * KG + k / 8) * 64 + (k % 8) * 8 + x % 8  (MN-major)
//
// elements, KG = K / 8: the cores of one 8-row group lie side by side along K
// (128 bytes apart, the descriptor's leading byte offset) and the groups
// KG * 128 bytes apart (its stride byte offset). In a K-major operand a
// row's 8 consecutive k are one 16-byte core row; in an MN-major one, 8
// consecutive rows (output rows of A, columns of B) of one k are, so a
// row-major (K, N) matrix in device memory lands as MN-major B by 16-byte
// copies, and a row-major (K, M) one as MN-major A (A transposed). Either
// way the descriptor takes the K-neighbour core offset as its leading and
// the M/N-neighbour one as its stride byte offset (pinned on an H100 for
// K-major and MN-major A and B). Wgmma<N>::mma_t<TA, TB>(d, desc_a, desc_b,
// scale_d) is one m64nNk16 product, f32 sums, d = A B + (scale_d ? d : 0),
// with A MN-major where TA = 1 and B MN-major where TB = 1 (mma: TA = 0, TB
// = 1); thread t of the warpgroup holds d[4j + v] of row 16 (t/32) +
// (t%32)/4 + 8 (v/2), column 8j + 2 (t%4) + v%2. Wgmma<N>::mma_rs<TB> (N =
// 64, 128) takes A from registers instead, in the same row and column
// places: a[v] of thread t holds the two bf16 of row 16 (t/32) + (t%32)/4
// + 8 (v%2), k 2 (t%4) + 8 (v/2) + 0..1, the lower k in the low half.
//
// cp_async16 copies 16 bytes from device memory to shared memory without
// registers, or writes 16 zero bytes when `valid` is false (the source is
// then not read, but must be a valid address). Shared memory written by
// cp.async or plain stores is made visible to wgmma by fence_proxy_async()
// in each writing thread before the barrier that precedes the wgmma.
// tma_load_2d and tma_load_5d copy a box of a tiled view (encode_tiled) into
// shared memory in one instruction and complete on an mbarrier; a view whose
// innermost dims are (8 elements, 8 rows) lands each 8x8 block as one core
// matrix, in the order of its outer dims. Box elements outside the view land
// as zeros. TMA copies a box row by row: rows of 16 bytes held the band
// kernels' streams to ~1.9 TB/s on an H100, so they take 128-byte rows
// under the 128-byte swizzle (sw128, desc_sw128 below).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace wgmma_sm90 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__host__ __device__ constexpr int core_offset(int x, int k, int kg) {
  return ((x / 8) * kg + k / 8) * 64 + (x % 8) * 8 + k % 8;
}
__host__ __device__ constexpr int core_offset_mn(int k, int x, int kg) {
  return ((x / 8) * kg + k / 8) * 64 + (k % 8) * 8 + x % 8;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// descriptor of an operand in core matrices at `p`, no swizzle: the 16-byte
// units of the address, of the offset between cores adjacent along K (lbo)
// and of the offset between cores adjacent along M or N (sbo)
__device__ __forceinline__ uint64_t desc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
// ... of the layouts core_offset and core_offset_mn above: cores 128 bytes
// apart along K, row groups kg * 128 bytes apart
__device__ __forceinline__ uint64_t desc(const void* p, int kg) { return desc(p, 128u, (unsigned)kg * 128u); }

// The 128-byte swizzle: rows of 128 bytes (64 bf16), eight to a 1024-byte
// atom (1024-byte aligned), the 16-byte unit u of row i stored at unit u ^
// (i % 8), as TMA writes a box whose inner dim is 128 bytes under
// CU_TENSOR_MAP_SWIZZLE_128B. sw128(o) is where byte o of the unswizzled
// layout lies. A K-major operand is its rows of 64 k, 8-row groups 1024
// bytes apart (the stride byte offset; the leading one is unused), a k16
// slice 32 bytes further along the row; an MN-major one is its k rows of
// 64 output rows (A) or columns (B), 8-k groups 1024 bytes apart (stride)
// and 64-wide blocks of M or N `lbo` bytes apart (leading), a k16 slice
// 2048 bytes further.
__device__ __forceinline__ int sw128(int o) { return o ^ (((o >> 7) & 7) << 4); }
__device__ __forceinline__ uint64_t desc_sw128(const void* p, unsigned lbo) {
  return desc(p, lbo, 1024u) | (1ull << 62);
}

// mbarriers: init (arrival count), arrive, arrive with an expected byte
// count for a bulk copy, and wait for the phase of the given parity
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
// Waits for the phase of the given parity; traps (the launch fails) if it
// never completes, rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one bulk tensor copy of a 2-dimensional box, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
// one bulk tensor copy of a 3-dimensional box, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::
          "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}
// one bulk tensor copy of a 4-dimensional box, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, "
      "%5}], [%6];\n" ::"r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}
// one bulk tensor copy of a 5-dimensional box, completing on `bar`
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3, int c4,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, "
      "%6}], [%7];\n" ::"r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(smem_addr(bar))
      : "memory");
}
// Encodes an R-dimensional tiled view of an array (bf16 unless `dtype` says
// otherwise; int8 weights are viewed as UINT8) for tma_load_2d..5d: dims and
// the byte strides of dims 1..R-1, innermost first, the box, the swizzle
// (none by default), zero fill out of bounds. Returns cudaErrorMisalignedAddress for
// a base that is not 16-byte aligned, cudaErrorNotSupported where
// cuTensorMapEncodeTiled cannot be found and cudaErrorInvalidValue where
// it refuses the view.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

template <int R>
cudaError_t encode_tiled(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[R],
                         const cuuint64_t (&strides)[R - 1], const cuuint32_t (&box)[R],
                         CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE,
                         CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  static EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<EncodeTiled>(fn);
  }();
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return cudaErrorMisalignedAddress;
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint32_t ones[R];
  for (int i = 0; i < R; ++i) ones[i] = 1;
  return encode(map, dtype, R, const_cast<void*>(base), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// whether a 16-bit operand type is f16 (else bf16)
template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;
static_assert(sizeof(__half) == sizeof(__nv_bfloat16), "the 16-bit types share every layout");

// A 2-d view of a row-major (rows, cols) array of T (bf16 by default, or
// f16), cols % 8 == 0, under the 128-byte swizzle, whose box is box_rows
// rows of 64 columns.
template <typename T = __nv_bfloat16>
inline cudaError_t rows_view(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode_tiled<2>(map, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                         is_f16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// The dynamic shared memory from its first 1024-byte boundary (the
// swizzle's atoms are aligned to it; a launch asks for 1024 bytes more).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory, with the SM's
// carveout set to the most shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

// Wgmma<N, T>::mma_t<TA, TB>(d, desc_a, desc_b, scale_d) is one m64nNk16 product
// of A and B elements of type T, __nv_bfloat16 (the default) or __half, with
// f32 sums: TA = 0 reads A K-major, 1 MN-major (16-bit types allow both from
// shared memory); TB likewise for B. mma(...) is mma_t<0, 1>. Both types
// share the fragment and core-matrix layouts above; only the instruction's
// type suffix differs, chosen at compile time (WGMMA_AB_TYPE), so no branch
// stands between a kernel and its wgmma.
template <int N, typename T = __nv_bfloat16>
struct Wgmma;

// the asm statement `stmt`, taking the type suffix AB ("bf16" or "f16"), for T
#define WGMMA_AB_TYPE(T, stmt) \
  do {                          \
    if constexpr (is_f16<T>)    \
      stmt("f16");              \
    else                        \
      stmt("bf16");             \
  } while (0)

template <typename T>
struct Wgmma<8, T> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma_t(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
#define WGMMA_ASM(AB) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n8k16.f32." AB "." AB " " \
        "{" \
        "%0, %1, %2, %3" \
        "}, %4, %5, p, 1, 1, %7, %8;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) \
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
    WGMMA_AB_TYPE(T, WGMMA_ASM);
#undef WGMMA_ASM
  }
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
    mma_t<0, 1>(d, da, db, scale_d);
  }
};

template <typename T>
struct Wgmma<16, T> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma_t(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
#define WGMMA_ASM(AB) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n16k16.f32." AB "." AB " " \
        "{" \
        "%0, %1, %2, %3, %4, %5, %6, %7" \
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
    WGMMA_AB_TYPE(T, WGMMA_ASM);
#undef WGMMA_ASM
  }
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
    mma_t<0, 1>(d, da, db, scale_d);
  }
};

template <typename T>
struct Wgmma<24, T> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma_t(float (&d)[12], uint64_t da, uint64_t db, int scale_d) {
#define WGMMA_ASM(AB) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n24k16.f32." AB "." AB " " \
        "{" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11" \
        "}, %12, %13, p, 1, 1, %15, %16;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]) \
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
    WGMMA_AB_TYPE(T, WGMMA_ASM);
#undef WGMMA_ASM
  }
  static __device__ __forceinline__ void mma(float (&d)[12], uint64_t da, uint64_t db, int scale_d) {
    mma_t<0, 1>(d, da, db, scale_d);
  }
};

template <typename T>
struct Wgmma<32, T> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma_t(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
#define WGMMA_ASM(AB) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " " \
        "{" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
    WGMMA_AB_TYPE(T, WGMMA_ASM);
#undef WGMMA_ASM
  }
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    mma_t<0, 1>(d, da, db, scale_d);
  }
};

template <typename T>
struct Wgmma<64, T> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma_t(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
#define WGMMA_ASM(AB) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " \
        "{" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
    WGMMA_AB_TYPE(T, WGMMA_ASM);
#undef WGMMA_ASM
  }
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    mma_t<0, 1>(d, da, db, scale_d);
  }
  // A from registers (mma_rs<TB>: B MN-major where TB = 1)
  template <int TB>
  static __device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
#define WGMMA_ASM(AB) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " \
        "{" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB))
    WGMMA_AB_TYPE(T, WGMMA_ASM);
#undef WGMMA_ASM
  }
};

template <typename T>
struct Wgmma<128, T> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma_t(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
#define WGMMA_ASM(AB) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " " \
        "{" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
    WGMMA_AB_TYPE(T, WGMMA_ASM);
#undef WGMMA_ASM
  }
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    mma_t<0, 1>(d, da, db, scale_d);
  }
  // A from registers (mma_rs<TB>: B MN-major where TB = 1)
  template <int TB>
  static __device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
#define WGMMA_ASM(AB) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " " \
        "{" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB))
    WGMMA_AB_TYPE(T, WGMMA_ASM);
#undef WGMMA_ASM
  }
};

template <typename T>
struct Wgmma<160, T> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma_t(float (&d)[80], uint64_t da, uint64_t db, int scale_d) {
#define WGMMA_ASM(AB) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n160k16.f32." AB "." AB " " \
        "{" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79" \
        "}, %80, %81, p, 1, 1, %83, %84;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]) \
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
    WGMMA_AB_TYPE(T, WGMMA_ASM);
#undef WGMMA_ASM
  }
  static __device__ __forceinline__ void mma(float (&d)[80], uint64_t da, uint64_t db, int scale_d) {
    mma_t<0, 1>(d, da, db, scale_d);
  }
};

template <typename T>
struct Wgmma<192, T> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma_t(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
#define WGMMA_ASM(AB) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n192k16.f32." AB "." AB " " \
        "{" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" \
        "}, %96, %97, p, 1, 1, %99, %100;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]) \
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
    WGMMA_AB_TYPE(T, WGMMA_ASM);
#undef WGMMA_ASM
  }
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
    mma_t<0, 1>(d, da, db, scale_d);
  }
};

template <typename T>
struct Wgmma<256, T> {
  template <int TA, int TB>
  static __device__ __forceinline__ void mma_t(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
#define WGMMA_ASM(AB) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n256k16.f32." AB "." AB " " \
        "{" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
    WGMMA_AB_TYPE(T, WGMMA_ASM);
#undef WGMMA_ASM
  }
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    mma_t<0, 1>(d, da, db, scale_d);
  }
};


// Stores two neighbouring outputs (v0 at column o, v1 at o + 1) of row `p`
// (pointing at column 0), as one 4-byte (bf16, f16) or 8-byte (f32) store where
// an even row width keeps the pair aligned, masked at the ragged edge O.
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int o, int O, float v0, float v1) {
  if (O % 2 == 0) {
    if (o < O) *reinterpret_cast<__nv_bfloat162*>(p + o) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (o < O) p[o] = __float2bfloat16(v0);
    if (o + 1 < O) p[o + 1] = __float2bfloat16(v1);
  }
}

__device__ __forceinline__ void store_pair(__half* p, int o, int O, float v0, float v1) {
  if (O % 2 == 0) {
    if (o < O) *reinterpret_cast<__half2*>(p + o) = __floats2half2_rn(v0, v1);
  } else {
    if (o < O) p[o] = __float2half_rn(v0);
    if (o + 1 < O) p[o + 1] = __float2half_rn(v1);
  }
}

__device__ __forceinline__ void store_pair(float* p, int o, int O, float v0, float v1) {
  if (O % 2 == 0) {
    if (o < O) *reinterpret_cast<float2*>(p + o) = make_float2(v0, v1);
  } else {
    if (o < O) p[o] = v0;
    if (o + 1 < O) p[o + 1] = v1;
  }
}

}  // namespace wgmma_sm90
