// Transposed factored node apply for Hopper (sm_90a): kernel B1t.
//
//   dhh[b,k,n,i] = out_type( sum_{d,o} q[(b,n),(d,o)] * pool_t[k, d*O+o, i] ),
//   q[(b,n),(d,o)] = T(e[n,d] * dpre[b,n,o])
//
// dpre (B,N,O), e (N,D) and pool_t (K,D*O,I) all of one type T (f32 or
// bf16), dhh (B,K,N,I) f32 or bf16; all contiguous. q is rounded to T, as
// the Pallas kernel forms it in dpre's dtype; the dot sums in f32.
//
// Replaces the Pallas kernel multistgraph_tpu/ops/node_apply.py:
// _apply_t_kernel / node_factored_apply_t, the input cotangent of B1
// (node_factored.cu). One GEMM with M = B*N rows, K*I columns and a D*O
// contraction whose A operand q is never in device memory.
//
// Bound on an H100: operations. In bf16 the Pallas kernel rounds q to bf16,
// so the factored order is part of the function: the same 6.21 GFLOP as B1
// at the flagship gate (B=16, N=237, K=5, I=64, D=20, O=128), 6.3 us on the
// bf16 tensor cores, against ~11 MB of operands (3.4 us at 3.35 TB/s). In
// f32 the order is free (the two differ by rounding only), and the
// expanded one, the per-node weight W[n,k,o,i] = sum_d e[n,d] pool_t[k,
// d O + o, i] and then dhh[b,k,n,i] = sum_o dpre[b,n,o] W[n,k,o,i], does
// 0.388 + 0.311 = 0.699 GFLOP at the gate (0.349 at the update, O = 64):
// 10.4 / 5.2 us on the f32 CUDA cores, above the bytes' 3.0 / 2.2 us.
//
// bf16 operands: tensor cores (wgmma m64nNk16 with A from registers). A
// block of 64 WG rows and N = 64 KG columns (KG values of k at one 64-wide
// block of i) has WG consumer warpgroups and one producer warp. Each
// consumer thread loads its two rows' dpre once, as A fragments for every
// k16 slice of O (register A's places), and for each d multiplies them by
// its rows' e[n,d] in bf16 (__hmul2: the exact product rounded once, the
// Pallas rounding of q), a chunk's four k16 slices before the fence that
// hands them to the tensor cores. The
// producer streams pool_t in K = 64 chunks (64 o of one d by KG k by 64 i)
// through a ring of four stages handed over by mbarriers: by TMA from a 4-d
// view (I, O, D, K) under the 128-byte swizzle, which lands the chunk as
// MN-major B and fills o past O with zeros, so each d's contraction is
// padded on its own and never meets the next d's rows; where I % 8 != 0 (no
// 16-byte rows) by element loads into the same layout. The k16 slices past
// O are issued on zeros. Each chunk's products go out while the previous
// chunk's finish, whose stage is then released. The epilogue rounds once to
// dhh's type and leaves through a per-warp staging area, one k at a time, as
// 16-byte stores along I where I allows them. The tile (rows x KG) is the
// one whose busiest SM has the least work, counting each block's forming
// of q. A view that the shape allows and
// cuTensorMapEncodeTiled refuses (an operand that is not 16-byte aligned) is
// a launch error. node_factored_t_bwd_tile plants a fault (d = 0 dropped,
// the contraction's last k16 slice dropped) for checks that must catch one.
// What holds it back on an H100 (PERF.md): 32 / 21 us at the flagship gate
// and update against 6.3 / 3.1 us of tensor-core time; 90 blocks of the
// 128x2 tile fill 90 of the 132 SMs, each walking its 40 (20) chunks in
// order with two in flight. Letting the first product reset the sums
// instead of zeroing them cleared ptxas's wgmma-serialization note (C7515)
// and ran no faster.
//
// f32 operands: plain f32 FMAs (tensor cores would take them in TF32), in
// the expanded order, W formed on chip and never written to device memory
// (38.8 MB at the gate, 23 us of bytes). A block of 256 threads takes 16
// nodes, 32 columns of the flattened (k, i) and 16 b, and walks O in
// chunks of 16 o: all its threads copy (by cp.async, 16 bytes where I % 4
// == 0, else 4; four stages, three in flight) the chunk's pool_t rows of
// the block's columns 8 d at a time, with e's columns of those d, and form
// W[n, o, c] for the 16 nodes in registers (8 nodes x 4 columns of one o a
// thread: three 16-byte shared reads per 32 FMAs, e's a broadcast); then
// the chunk's dpre for the 16 b (a stage of its own), W goes to shared
// memory, and each thread folds 16 o of dpre[b, n, o] W[n, o, c] into its
// 4 b x 8 columns of one node (three 16-byte reads per 32 FMAs, none in
// conflict: the nodes' rows are padded). pool_t is read from L2 once per
// node group (49 MB at the gate instead of the factored design's 777 MB),
// dpre once per column tile. The flagship cells have 15 x 10 such items:
// 150 blocks on 132 SMs left 18 SMs two blocks' work, so the blocks of a
// thread block cluster (2^s of them, the most that leave each two chunks or
// more: 4 at the gate, 2 at the update) split an item's chunks, and each
// adds its share of the item's sums over the cluster's partials in rank
// order through distributed shared memory (the same sums at every call).
// On an H100 (PERF.md): 64 / 43 us at the gate / update; copies issued by
// the block's own threads between barriers, their latency not hidden
// behind the compute (loads alone 36 us, compute alone 45 at the gate),
// hold it back. Forming W per thread in registers from its own node
// (no W in shared memory, one barrier per 4 o) ran 100-135 us: four
// 16-byte shared reads per 16 FMAs. Prefetching pool_t into L2 at the
// start, or starting the node groups at different chunks, did not help.
// The SIMT design this replaces, in the factored order, read 0.539 / 0.263
// ms. The planted faults: the d = 0 term left out of W; the 16 o holding
// the last left out of the sums.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace wgmma_sm90;

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ---------------------------------------------------------------- f32 operands: the expanded order

constexpr int kFaultD = 1;                // the d = 0 term dropped
constexpr int kFaultK16 = 2;              // the 16 o holding the contraction's last dropped
constexpr int kF32Nodes = 16;             // nodes of a block
constexpr int kF32Oc = 16;                // o of one chunk
constexpr int kF32Cols = 32;              // output columns (k, i) of a block
constexpr int kF32Rows = 16;              // b of a block
constexpr int kF32Dc = 8;                 // d of a pool_t piece
constexpr int kF32Threads = 256;          // 16 a node in the fold, 8 nodes x 4 columns each in forming W
constexpr int kF32Stages = 4;
constexpr int kF32DsNode = 4 * kF32Rows * 4 + 16;   // floats of a node's dpre chunk: 4 groups of 4 o x 16 b, padded
constexpr int kF32WsNode = kF32Oc * kF32Cols + 16;  // floats of a node's weight chunk: 16 o x 32 columns, padded
constexpr int kF32P = kF32Dc * kF32Oc * kF32Cols;   // floats of a piece's pool_t rows
constexpr int kF32Piece = kF32P + kF32Dc * kF32Nodes;                     // ... and its e columns
constexpr int kF32Ds = kF32Nodes * kF32DsNode;                            // floats of a dpre piece
constexpr int kF32Stage = kF32Piece > kF32Ds ? kF32Piece : kF32Ds;
constexpr size_t kF32Smem = ((size_t)kF32Stages * kF32Stage + kF32Nodes * kF32WsNode) * sizeof(float);
static_assert(kF32Threads * 32 <= kF32Stages * kF32Stage, "the cluster's partial sums fit the ring");

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float lane4(const float4& v, int i) { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }
__device__ __forceinline__ void put4(float* p, float v0, float v1, float v2, float v3) {
  *reinterpret_cast<float4*>(p) = make_float4(v0, v1, v2, v3);
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, float v0, float v1, float v2, float v3) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1), hi = __floats2bfloat162_rn(v2, v3);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// dhh for nodes n0 .. n0 + 16, columns c0 .. c0 + 32 of the flattened (k, i)
// and b0 .. b0 + 16 of item blockIdx.x / split = (b tile * column tiles +
// column tile) * node groups + node group, the item's 16-o chunks split
// over the cluster's blocks. Pieces in order, for each of the block's
// chunks: its pool_t rows at the block's columns for kF32Dc d at a time
// with e's columns of those d, then its dpre. p16: pool_t by 16-byte copies
// (I % 4 == 0, 16-byte aligned), else 4-byte ones; d16 likewise for dpre (O
// % 4 == 0).
template <typename U>
__global__ void __launch_bounds__(kF32Threads, 2)
node_factored_t_f32_kernel(const float* __restrict__ dpre, const float* __restrict__ e,
                           const float* __restrict__ pool_t, U* __restrict__ dhh, int B, int K, int N, int I, int D,
                           int O, int p16, int d16, int fault) {
  constexpr int G = kF32Nodes, T = kF32Threads, DC = kF32Dc, S = kF32Stages;
  extern __shared__ __align__(16) float fsm[];
  float* ws = fsm + (size_t)S * kF32Stage;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const unsigned item = blockIdx.x / split;
  const int KI = K * I, groups = (N + G - 1) / G, ctiles = (KI + kF32Cols - 1) / kF32Cols;
  const int n0 = (int)(item % groups) * G, c0 = (int)(item / groups % ctiles) * kF32Cols;
  const int b0 = (int)(item / groups / ctiles) * kF32Rows;
  // this block's chunks oc0 .. oc0 + ocn, each in ppc pieces
  const int noc = (O + kF32Oc - 1) / kF32Oc, per = (noc + split - 1) / split, oc0 = rank * per;
  const int ocn = max(0, min(noc, oc0 + per) - oc0);
  const int ndc = (D + DC - 1) / DC, ppc = ndc + 1, total = ocn * ppc;
  const int tid = threadIdx.x;

  // Each thread's copies keep their column and step their rows: pool_t's
  // column c0 + pc from psrc = &pool_t[k, 0, i]; dpre's b0 + db at the 4 o
  // of group dog (16-byte copies).
  const int pc = p16 ? 4 * (tid % (kF32Cols / 4)) : tid % kF32Cols, pcol = c0 + pc, pk = pcol / I;
  const bool pin = pcol < KI;
  const float* psrc = pool_t + (size_t)pk * D * O * I + (pcol - pk * I);
  const int db = tid / 4 % kF32Rows, dog = tid % 4;

  // piece g into its stage, one commit group (empty past the last piece)
  auto issue = [&](int g) {
    if (g < total) {
      float* st = fsm + (size_t)(g % S) * kF32Stage;
      const int r = g % ppc, o0 = (oc0 + g / ppc) * kF32Oc;
      if (r < ndc) {
        // the chunk's pool_t rows (d0 + dd) O + o0 + o at the block's columns, row rq = dd 16 + o
        const int d0 = r * DC;
        if (p16) {
          for (int rq = tid / (kF32Cols / 4); rq < DC * kF32Oc; rq += T / (kF32Cols / 4)) {
            const int d = d0 + rq / kF32Oc, oo = o0 + rq % kF32Oc;
            const bool ok = pin && d < D && oo < O;
            cp_async16(st + rq * kF32Cols + pc, ok ? psrc + ((size_t)d * O + oo) * I : pool_t, ok);
          }
        } else {
          for (int rq = tid / kF32Cols; rq < DC * kF32Oc; rq += T / kF32Cols) {
            const int d = d0 + rq / kF32Oc, oo = o0 + rq % kF32Oc;
            const bool ok = pin && d < D && oo < O;
            cp_async4(st + rq * kF32Cols + pc, ok ? psrc + ((size_t)d * O + oo) * I : pool_t, ok);
          }
        }
        // e's columns d0 .. d0 + kF32Dc of the nodes (d = 0 left out under the planted fault)
        for (int q = tid; q < DC * G; q += T) {
          const int d = d0 + q / G, n = n0 + q % G;
          const bool ok = d < D && n < N && !(fault == kFaultD && d == 0);
          cp_async4(st + kF32P + q, ok ? e + (size_t)n * D + d : e, ok);
        }
      } else {
        // node n's dpre rows b0 .. b0 + 16 at o0 .. o0 + 16: 4 groups of 4 o, each 16 b of 16 bytes
        if (d16) {
          for (int n = tid / (4 * kF32Rows); n < G; n += T / (4 * kF32Rows)) {
            const bool ok = n0 + n < N && b0 + db < B && o0 + 4 * dog < O;
            cp_async16(st + n * kF32DsNode + (dog * kF32Rows + db) * 4,
                       ok ? dpre + ((size_t)(b0 + db) * N + n0 + n) * O + o0 + 4 * dog : dpre, ok);
          }
        } else {
          for (int q = tid; q < G * kF32Rows * kF32Oc; q += T) {
            const int n = q / (kF32Rows * kF32Oc), b = q / kF32Oc % kF32Rows, o = q % kF32Oc;
            const bool ok = n0 + n < N && b0 + b < B && o0 + o < O;
            cp_async4(st + n * kF32DsNode + (o / 4 * kF32Rows + b) * 4 + o % 4,
                      ok ? dpre + ((size_t)(b0 + b) * N + n0 + n) * O + o0 + o : dpre, ok);
          }
        }
      }
    }
    cp_async_commit();
  };

  // forming the weights: nodes 8 wn .. 8 wn + 7, o wo of the chunk, columns wc .. wc + 3
  const int wn = tid / 128, wo = tid % 128 / 8, wc = 4 * (tid % 8);
  // the fold: node fn, b fb + 4 j, columns fc .. fc + 3 and fc + 16 .. fc + 19
  const int fn = tid / 16, fb = tid / 4 % 4, fc = 4 * (tid % 4);
  float wacc[8][4], acc[4][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int l = 0; l < 4; ++l) wacc[j][l] = 0.f, acc[l][j] = 0.f;

  for (int g = 0; g < S - 1; ++g) issue(g);
  for (int g = 0; g < total; ++g) {
    cp_async_wait<S - 2>();
    __syncthreads();   // piece g is in; every thread is done with piece g - 1's stage
    issue(g + S - 1);
    const float* st = fsm + (size_t)(g % S) * kF32Stage;
    const int oc = oc0 + g / ppc, r = g % ppc;
    if (r < ndc) {
      // W[n, o, c] += e[n, d] pool_t[k, d O + o, i] over the piece's d
      auto step = [&](int dd) {
        const float4 p = *reinterpret_cast<const float4*>(st + (dd * kF32Oc + wo) * kF32Cols + wc);
        const float4 e0 = *reinterpret_cast<const float4*>(st + kF32P + dd * G + 8 * wn);
        const float4 e1 = *reinterpret_cast<const float4*>(st + kF32P + dd * G + 8 * wn + 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float ev = lane4(j < 4 ? e0 : e1, j % 4);
          wacc[j][0] = fmaf(ev, p.x, wacc[j][0]);
          wacc[j][1] = fmaf(ev, p.y, wacc[j][1]);
          wacc[j][2] = fmaf(ev, p.z, wacc[j][2]);
          wacc[j][3] = fmaf(ev, p.w, wacc[j][3]);
        }
      };
      const int dn = D - r * DC;
      if (dn >= DC) {
#pragma unroll
        for (int dd = 0; dd < DC; ++dd) step(dd);
      } else {
        for (int dd = 0; dd < dn; ++dd) step(dd);
      }
      continue;
    }
    // the chunk's weights into shared memory, then dhh[b, n, c] += dpre[b, n, o] W[n, o, c]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float4*>(ws + (8 * wn + j) * kF32WsNode + wo * kF32Cols + wc) =
          make_float4(wacc[j][0], wacc[j][1], wacc[j][2], wacc[j][3]);
      wacc[j][0] = wacc[j][1] = wacc[j][2] = wacc[j][3] = 0.f;
    }
    __syncthreads();
    if (fault == kFaultK16 && oc == noc - 1) continue;
    const float* ds = st + fn * kF32DsNode;
    const float* wt = ws + fn * kF32WsNode;
#pragma unroll
    for (int og = 0; og < 4; ++og) {
      float4 dv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = *reinterpret_cast<const float4*>(ds + (og * kF32Rows + fb + 4 * j) * 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 w0 = *reinterpret_cast<const float4*>(wt + (4 * og + u) * kF32Cols + fc);
        const float4 w1 = *reinterpret_cast<const float4*>(wt + (4 * og + u) * kF32Cols + 16 + fc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = lane4(dv[j], u);
          acc[j][0] = fmaf(a, w0.x, acc[j][0]);
          acc[j][1] = fmaf(a, w0.y, acc[j][1]);
          acc[j][2] = fmaf(a, w0.z, acc[j][2]);
          acc[j][3] = fmaf(a, w0.w, acc[j][3]);
          acc[j][4] = fmaf(a, w1.x, acc[j][4]);
          acc[j][5] = fmaf(a, w1.y, acc[j][5]);
          acc[j][6] = fmaf(a, w1.z, acc[j][6]);
          acc[j][7] = fmaf(a, w1.w, acc[j][7]);
        }
      }
    }
  }
  cp_async_wait<0>();   // no copy outlives the block
  if (split > 1) {
    // each block leaves its sums in its shared memory; block r adds the
    // 16-byte groups q = 2 j + h of every thread with q % split == r over
    // the cluster's blocks in rank order (the same sums at every call)
    float* red = fsm;
    __syncthreads();   // the ring is read
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(red + ((2 * j + h) * T + tid) * 4) =
            make_float4(acc[j][4 * h], acc[j][4 * h + 1], acc[j][4 * h + 2], acc[j][4 * h + 3]);
    cluster.sync();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if ((2 * j + h) % split != rank) continue;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = 0; r < split; ++r) {
          const float4 p =
              *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, r) + ((2 * j + h) * T + tid) * 4);
          sum.x += p.x, sum.y += p.y, sum.z += p.z, sum.w += p.w;
        }
        acc[j][4 * h] = sum.x, acc[j][4 * h + 1] = sum.y, acc[j][4 * h + 2] = sum.z, acc[j][4 * h + 3] = sum.w;
      }
  }

  const int n = n0 + fn;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = b0 + fb + 4 * j;
    if (b >= B || n >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + fc + 16 * h;
      if (col >= KI || (2 * j + h) % split != rank) continue;
      if (I % 4 == 0) {   // four columns of one k
        const int k = col / I, i = col - k * I;
        put4(dhh + (((size_t)b * K + k) * N + n) * I + i, acc[j][4 * h], acc[j][4 * h + 1], acc[j][4 * h + 2],
             acc[j][4 * h + 3]);
      } else {
        for (int l = 0; l < 4 && col + l < KI; ++l) {
          const int k = (col + l) / I, i = col + l - k * I;
          put(dhh + (((size_t)b * K + k) * N + n) * I + i, acc[j][4 * h + l]);
        }
      }
    }
  }
  if (split > 1) cluster.sync();   // the partials are read before any block of the cluster leaves
}

template <typename U>
cudaError_t launch_f32(const void* dpre, const void* e, const void* pool_t, void* dhh, int b, int k, int n, int i,
                       int d, int o, int split, int fault, cudaStream_t stream) {
  auto kernel = node_factored_t_f32_kernel<U>;
  static unsigned long long ready = 0;   // the devices whose attributes are set (the first 64)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(ready >> dev & 1)) {
    err = allow_smem(kernel, kF32Smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready |= 1ull << dev;
  }
  const long blocks = (long)split * ((n + kF32Nodes - 1) / kF32Nodes) * ((k * (long)i + kF32Cols - 1) / kF32Cols) *
                      ((b + kF32Rows - 1) / kF32Rows);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  const int p16 = i % 4 == 0 && reinterpret_cast<uintptr_t>(pool_t) % 16 == 0;
  const int d16 = o % 4 == 0 && reinterpret_cast<uintptr_t>(dpre) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = kF32Smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(dpre), static_cast<const float*>(e),
                           static_cast<const float*>(pool_t), static_cast<U*>(dhh), b, k, n, i, d, o, p16, d16, fault);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

// f32 tiles: O split over 2^s blocks of a cluster, s = 0 .. 3
constexpr int kF32Tiles = 4;

// The f32 tile for these dimensions: O split over the most blocks (at most
// 8) that leave each two 16-o chunks or more.
int choose_f32_tile(int o) {
  const int chunks = (o + kF32Oc - 1) / kF32Oc;
  int s = 0;
  while (s < 3 && (4 << s) <= chunks) ++s;
  return s;
}

cudaError_t launch_f32_tile(const void* dpre, const void* e, const void* pool_t, void* dhh, int b, int k, int n,
                            int i, int d, int o, int bf16_out, int tile, int fault, cudaStream_t st) {
  if (tile >= kF32Tiles) return cudaErrorInvalidValue;
  if (tile < 0) tile = choose_f32_tile(o);
  return bf16_out ? launch_f32<__nv_bfloat16>(dpre, e, pool_t, dhh, b, k, n, i, d, o, 1 << tile, fault, st)
                  : launch_f32<float>(dpre, e, pool_t, dhh, b, k, n, i, d, o, 1 << tile, fault, st);
}

// ---------------------------------------------------------------- bf16 operands: tensor cores

using bf16 = __nv_bfloat16;

constexpr size_t kMaxSmem = 227 * 1024;   // shared memory one block may use on an H100
constexpr int kOc = 64;                   // contraction rows (o of one d) of one ring stage
constexpr int kStages = 4;
constexpr int kStageLd = 64 + 8;          // staged output row stride: conflict-free pair writes
constexpr int kMaxO = 256;                // dpre fragments of 16 k16 slices in registers at most

template <int WG, int KG, typename OutT>
constexpr size_t t_smem_bytes() {
  return 1024 + (size_t)kStages * kOc * 64 * KG * sizeof(bf16) + (size_t)WG * 4 * 16 * kStageLd * sizeof(OutT) +
         2 * kStages * sizeof(uint64_t);
}

__device__ __forceinline__ void put_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void put_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// dhh for rows m0 .. m0 + 64 WG (m0 = 64 WG blockIdx.x) and the columns
// (k, i) of k-group kg = blockIdx.y / IB, i-block ib = blockIdx.y % IB: k =
// KG kg + 0..KG-1, i = 64 ib + 0..63. OS: the k16 slices of O the dpre
// fragments hold (8 or 16). pool_map: the 4-d view (I, O, D, K) of pool_t
// whose box (64 i, 64 o, 1 d, KG k) lands a stage, where tma (I % 8 == 0).
template <int WG, int KG, int OS, typename OutT>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
node_factored_t_wgmma_kernel(const __grid_constant__ CUtensorMap pool_map, int tma, const bf16* __restrict__ dpre,
                             const bf16* __restrict__ e, const bf16* __restrict__ pool_t, OutT* __restrict__ dhh,
                             int B, int K, int N, int I, int D, int O, int fault) {
  constexpr int BN = 64 * KG;                   // the wgmma's N
  constexpr int kConsumers = WG * 128;
  constexpr int kChunkElems = kOc * BN;              // elements of one stage
  constexpr int kVec = 16 / sizeof(OutT);       // outputs of one 16-byte store
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* ps = reinterpret_cast<bf16*>(smem);                                     // kStages chunks
  OutT* staged = reinterpret_cast<OutT*>(ps + (size_t)kStages * kChunkElems);        // 16 x kStageLd a consumer warp
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + (size_t)kConsumers / 32 * 16 * kStageLd);
  uint64_t* empty = full + kStages;

  const int M = B * N, IB = (I + 63) / 64, OC = (O + kOc - 1) / kOc;
  const int m0 = blockIdx.x * 64 * WG;
  const int k0 = (blockIdx.y / IB) * KG, i0 = (blockIdx.y % IB) * 64;
  const int total = D * OC;                     // chunks: (d, 64 o) in order
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, WG);               // one arrival per consumer warpgroup
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: chunk g holds pool_t rows d O + 64 oc .. (d = g / OC, oc
    // = g % OC) of k0 .. k0 + KG at i0 .. i0 + 64; zero past O, K and I
    const int lane = tid - kConsumers;
    const bf16 zero = __float2bfloat16(0.f);
    for (int g = 0; g < total; ++g) {
      const int st = g % kStages, d = g / OC, oc = g % OC;
      if (g >= kStages) mbar_wait(empty + st, ((g / kStages) & 1) ^ 1);
      bf16* dst = ps + (size_t)st * kChunkElems;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_tx(full + st, kChunkElems * (unsigned)sizeof(bf16));
          tma_load_4d(dst, &pool_map, i0, oc * kOc, d, k0, full + st);
        }
      } else {
        // element (o, c) of the chunk at its swizzled place: column block
        // c / 64 (one k) 8 KB apart, rows of 64 i
        unsigned char* b = reinterpret_cast<unsigned char*>(dst);
        for (int q = lane; q < kChunkElems; q += 32) {
          const int o = q / BN, c = q - o * BN;
          const int k = k0 + c / 64, i = i0 + c % 64, oo = oc * kOc + o;
          *reinterpret_cast<bf16*>(b + (c / 64) * 8192 + sw128(o * 128 + (c % 64) * 2)) =
              oo < O && i < I && k < K ? pool_t[(((size_t)k * D + d) * O + oo) * I + i] : zero;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + st);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg ..; this thread rows r[0],
  // r[1] = 16 warp + lane / 4 (+ 8) of them
  // (broadcast from lane 0, so that the compiler knows them uniform in the warp)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), warp = __shfl_sync(0xffffffffu, tid % 128 / 32, 0);
  const int lane = tid % 32;
  int r[2], erow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r[h] = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
    erow[h] = r[h] < M ? (r[h] % N) * D : -1;
  }
  // dpre as A fragments: a[s][v] holds row r[v % 2], o = 16 s + 2 (lane % 4)
  // + 8 (v / 2) + 0..1 (zero past O and M)
  uint32_t a[OS][4];
#pragma unroll
  for (int s = 0; s < OS; ++s)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int row = r[v % 2], o = 16 * s + 2 * (lane % 4) + 8 * (v / 2);
      const bf16 zero = __float2bfloat16(0.f);
      const bf16 lo = row < M && o < O ? dpre[(size_t)row * O + o] : zero;
      const bf16 hi = row < M && o + 1 < O ? dpre[(size_t)row * O + o + 1] : zero;
      __nv_bfloat162 pair = __halves2bfloat162(lo, hi);
      a[s][v] = *reinterpret_cast<uint32_t*>(&pair);
    }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int g = 0;
  for (int d = 0; d < D; ++d) {
    // q = bf16(e[n,d] dpre) of this thread's rows, formed per k16 slice
    const bf16 zero = __float2bfloat16(0.f);
    const __nv_bfloat162 e0 = __bfloat162bfloat162(erow[0] >= 0 ? e[erow[0] + d] : zero);
    const __nv_bfloat162 e1 = __bfloat162bfloat162(erow[1] >= 0 ? e[erow[1] + d] : zero);
#pragma unroll
    for (int oc = 0; oc < OS / 4; ++oc) {
      if (oc >= OC) break;
      const int st = g % kStages;
      mbar_wait(full + st, (g / kStages) & 1);
      const unsigned char* b = reinterpret_cast<const unsigned char*>(ps + (size_t)st * kChunkElems);
      // the chunk's four k16 slices of q, formed before the fence that hands
      // them to the tensor cores (slices past O are zero on both sides); a
      // planted fault zeroes the slices it drops
      const int last = min(kOc, O - oc * kOc + 15) / 16 - 1;   // the last slice holding part of O
      uint32_t q[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const bool dropped = (fault == kFaultD && d == 0) || (fault == kFaultK16 && g == total - 1 && ks == last);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a[4 * oc + ks][v]), v % 2 ? e1 : e0);
          q[ks][v] = dropped ? 0u : *reinterpret_cast<uint32_t*>(&p);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) Wgmma<BN>::template mma_rs<1>(acc, q[ks], desc_sw128(b + 2048 * ks, 8192u), 1);
      wgmma_commit();
      if (g > 0) {
        wgmma_wait<1>();   // the previous chunk's products are done: free its stage
        if (tid % 128 == 0) mbar_arrive(empty + (g - 1) % kStages);
      }
      ++g;
    }
  }
  wgmma_wait<0>();
  if (g > 0 && tid % 128 == 0) mbar_arrive(empty + (g - 1) % kStages);

  // the warp's 16 rows through its staging, one k at a time (acc[4 (8 kk +
  // j) + v] is row lane / 4 + 8 (v / 2), i = 8 j + 2 (lane % 4) + v % 2 of
  // k0 + kk), stored along I in 16-byte units where I % kVec == 0
  OutT* stage = staged + (size_t)(tid / 32) * 16 * kStageLd;
  const int width = min(64, I - i0);
  const int row0 = m0 + 64 * wg + 16 * warp;
#pragma unroll
  for (int kk = 0; kk < KG; ++kk) {
    const int k = k0 + kk;
    if (k >= K) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4), x = 4 * (8 * kk + j);
      put_pair(stage + (lane / 4) * kStageLd + col, acc[x], acc[x + 1]);
      put_pair(stage + (lane / 4 + 8) * kStageLd + col, acc[x + 2], acc[x + 3]);
    }
    __syncwarp();
    for (int q = lane; q < 16 * (64 / kVec); q += 32) {
      const int i = q / (64 / kVec), c = (q % (64 / kVec)) * kVec, m = row0 + i;
      if (m >= M || c >= width) continue;
      const int bb = m / N, n = m - bb * N;
      OutT* dst = dhh + (((size_t)bb * K + k) * N + n) * I + i0 + c;
      const OutT* src = stage + i * kStageLd + c;
      if (I % kVec == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int u = 0; u < kVec && c + u < width; ++u) dst[u] = src[u];
      }
    }
    __syncwarp();   // the staging is read before the next k writes it
  }
}

template <int WG, int KG, int OS, typename OutT>
cudaError_t launch_wgmma(const void* dpre, const void* e, const void* pool_t, void* dhh, int b, int k, int n,
                         int i, int d, int o, int fault, cudaStream_t stream) {
  auto kernel = node_factored_t_wgmma_kernel<WG, KG, OS, OutT>;
  constexpr size_t smem = t_smem_bytes<WG, KG, OutT>();
  static_assert(smem <= kMaxSmem, "a B1t tile exceeds a block's shared memory");
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // pool_t by TMA where its rows of I are whole 16-byte units, else by the
  // producer's element loads; a view that the shape allows and
  // cuTensorMapEncodeTiled refuses is an error
  CUtensorMap map = {};
  const int tma = i % 8 == 0;
  if (tma) {
    const cuuint64_t dims[4] = {(cuuint64_t)i, (cuuint64_t)o, (cuuint64_t)d, (cuuint64_t)k};
    const cuuint64_t strides[3] = {(cuuint64_t)i * 2, (cuuint64_t)o * i * 2, (cuuint64_t)d * o * i * 2};
    const cuuint32_t box[4] = {64, kOc, 1, KG};
    err = encode_tiled<4>(&map, pool_t, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((b * n + 64 * WG - 1) / (64 * WG)), (unsigned)((k + KG - 1) / KG * ((i + 63) / 64)));
  kernel<<<grid, WG * 128 + 32, smem, stream>>>(map, tma, static_cast<const bf16*>(dpre),
                                                  static_cast<const bf16*>(e), static_cast<const bf16*>(pool_t),
                                                  static_cast<OutT*>(dhh), b, k, n, i, d, o, fault);
  return cudaGetLastError();
}

// tiles (rows x KG): 0: 128 x 2, 1: 128 x 1, 2: 64 x 2, 3: 64 x 1
constexpr int kTiles = 4;
constexpr int kTileRows[kTiles] = {128, 128, 64, 64}, kTileKG[kTiles] = {2, 1, 2, 1};

template <int OS, typename OutT>
cudaError_t launch_tile(int tile, const void* dpre, const void* e, const void* pool_t, void* dhh, int b, int k, int n,
                        int i, int d, int o, int fault, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_wgmma<2, 2, OS, OutT>(dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s);
    case 1: return launch_wgmma<2, 1, OS, OutT>(dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s);
    case 2: return launch_wgmma<1, 2, OS, OutT>(dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s);
    case 3: return launch_wgmma<1, 1, OS, OutT>(dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s);
    default: return cudaErrorInvalidValue;
  }
}

// The tile whose busiest SM has the least work: (blocks per SM, rounded
// up) x rows x (columns + 64), a block's forming of q counted as 64 columns
// of products (on an H100 at the flagship cells, 64x1 tiles ran 5% behind
// 64x2 and 128x2, which the count without it had put first); of equals,
// the earliest.
int choose_tile(int m, int k, int i) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                 cudaSuccess)
    sms = 132;
  int best = 0;
  long best_work = -1;
  for (int tile = 0; tile < kTiles; ++tile) {
    const long blocks = (long)((m + kTileRows[tile] - 1) / kTileRows[tile]) *
                        ((k + kTileKG[tile] - 1) / kTileKG[tile]) * ((i + 63) / 64);
    const long work = (blocks + sms - 1) / sms * kTileRows[tile] * (64 * kTileKG[tile] + 64);
    if (best_work < 0 || work < best_work) best = tile, best_work = work;
  }
  return best;
}

cudaError_t launch_bf16(const void* dpre, const void* e, const void* pool_t, void* dhh, int b, int k, int n, int i,
                        int d, int o, int bf16_out, int tile, int fault, cudaStream_t s) {
  if (o > kMaxO || tile >= kTiles) return cudaErrorInvalidValue;
  if (tile < 0) tile = choose_tile(b * n, k, i);
  if (o <= 128)
    return bf16_out ? launch_tile<8, bf16>(tile, dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s)
                    : launch_tile<8, float>(tile, dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s);
  return bf16_out ? launch_tile<16, bf16>(tile, dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s)
                  : launch_tile<16, float>(tile, dpre, e, pool_t, dhh, b, k, n, i, d, o, fault, s);
}

}  // namespace

// The bf16 kernel's tile for these dimensions (0: 128 x 2, 1: 128 x 1, 2:
// 64 x 2, 3: 64 x 1, rows x k a block).
extern "C" int node_factored_t_tile(int b, int k, int n, int i) { return choose_tile(b * n, k, i); }

// The f32 kernel's tile for these dimensions: O split over 2^tile blocks of
// a cluster.
extern "C" int node_factored_t_f32_tile(int b, int k, int n, int i, int o) { return choose_f32_tile(o); }

// As node_factored_t_bwd, with the kernel's tile given (-1: chosen from the
// grid; bf16 operands: node_factored_t_tile's codes, f32:
// node_factored_t_f32_tile's) and a fault planted in it (0: none, 1: the d
// = 0 term dropped, 2: the contraction's last k16 slice dropped, in f32 the
// 16 o holding the last).
extern "C" int node_factored_t_bwd_tile(const void* dpre, const void* e, const void* pool_t, void* dhh, int b,
                                        int k, int n, int i, int d, int o, int bf16_in, int bf16_out, int tile,
                                        int fault, void* stream) {
  if (b == 0 || n == 0 || k == 0 || i == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_in) return (int)launch_bf16(dpre, e, pool_t, dhh, b, k, n, i, d, o, bf16_out, tile, fault, st);
  return (int)launch_f32_tile(dpre, e, pool_t, dhh, b, k, n, i, d, o, bf16_out, tile, fault, st);
}

// Launches on `stream`; returns cudaGetLastError() after the launch, or the
// error of pool_t's TMA view where the bf16 kernel takes one (I % 8 == 0)
// and it cannot be encoded. bf16_in: dpre, e and pool_t are bf16 (else
// f32); bf16_out: dhh is bf16 (else f32). bf16 operands take O <= 256.
extern "C" int node_factored_t_bwd(const void* dpre, const void* e, const void* pool_t, void* dhh,
                                   int b, int k, int n, int i, int d, int o, int bf16_in, int bf16_out,
                                   void* stream) {
  return node_factored_t_bwd_tile(dpre, e, pool_t, dhh, b, k, n, i, d, o, bf16_in, bf16_out, -1, 0, stream);
}
