// Factored node-conditioned weight apply for Hopper (sm_90a): kernel B1.
//
//   out[t][(b,n), o] = epi( sum_d e[n,d] * sum_{k,i} hh[t][b,k,n,i] * pool[k,i,d*O+o] )
//
// hh (steps,B,K,N,I), e (N,D) f32, pool (K,I,D*O) of hh's type (f32 or
// bf16), out (B,N,O) f32, or bf16 with bf16 operands; all contiguous. epi
// adds the scalar *s (0 without one) and stores in the output's type,
// rounding once. Each of `steps` steps overwrites out, so the last step's
// result stays.
//
// Replaces two Pallas kernels that compute one product:
// multistgraph_tpu/ops/node_apply.py: _apply_kernel / node_factored_apply
// (steps=1, no scalar, f32 out) and tools/bench_node_dots.py: _b_kernel /
// make_b (B=1, K=1, N = B*NP rows with a per-row embedding, steps=T, the
// chained scalar and a bf16 store). In bf16 it is one GEMM with M = B*N rows,
// O columns and a D*K*I contraction whose A operand e (x) hh is never
// formed: for each d, r_d = hh @ pool[:, d*O:(d+1)*O] is summed over the
// whole (k,i) contraction in f32 before e[n,d] * r_d is added, the order
// of the Pallas kernel (r never leaves VMEM there, registers here). Forming
// e (x) hh in bf16 would round products that the Pallas kernel keeps exact.
//
// Bound on an H100: operations. At the flagship gate (B=16, N=237, K=5,
// I=64, D=20, O=128) one call in that order is 6.21 GFLOP: 6.3 us on bf16
// tensor cores (989 TFLOP/s), against ~10 MB of operands (f32: below);
// the harness's rows form (4096 rows, KI=320, D=20, O=192, 24 steps) is
// 241.6 GFLOP, 244 us on bf16 tensor cores.
//
// bf16 operands: tensor cores (wgmma). A block of 64 WG rows and OT output
// columns has WG consumer warpgroups (64 rows each) and one producer warp.
// The consumers stage their rows' activations once per step, in bf16,
// gathered from the (B,K,N,I) layout by 16-byte cp.async of I-contiguous
// runs into K-major core matrices (two threads a row, walking (k, i)
// without dividing: the divisions had cost 6% of the harness's time). The producer streams the pool through a
// ring of kStages chunks (64 contraction rows x DG*OT columns), handed over
// by mbarriers, by TMA: a 5-d view of the pool gathers the columns o0 ..
// o0 + OT of DG consecutive d into one wgmma's N = DG*OT, so one m64nNk16
// product advances r_d for DG values of d at once (N = 128 to 192, where
// one d's OT columns alone would give a small, inefficient N). Each chunk's
// products are issued while the previous chunk's finish. After a group's
// last chunk the consumers fold acc += e[row, d] * r_d in f32 for its DG d
// (two e values per thread, one for each of its two rows) into sums kept in
// shared memory, a column per thread, so that only r_d holds registers.
// Row tiles start at different d, so fewer blocks read one pool line at a
// time. The tile is chosen from the grid: the one whose busiest SM has the
// least work (192x32 with 5 d a product for the harness rows, 128x32 and
// 128x16 with 4 and 8 d at the flagship cells). What keeps this design
// above its tensor-core time is the step boundary: the consumers reload
// their rows with the tensor cores idle (no room for a second copy beside
// the ring), and each fold drains the products. TMA fills past the ragged
// M, O and K*I edges with zeros; where O or K*I is not a multiple of 8 the
// producer loads elements.
//
// f32 operands: plain f32 FMAs (tensor cores would take them in TF32, three
// decimal digits), in the expanded order, which f32 is free to take (the
// orders differ by rounding alone): the per-node weight W[n,(k,i),o] =
// sum_d e[n,d] pool[k,i,d O + o], then out[b,n,o] = sum_{k,i} hh[b,k,n,i]
// W[n,(k,i),o]: 0.388 + 0.311 = 0.699 GFLOP at the flagship gate (0.349 at
// the update, O = 64), 10.4 / 5.2 us at 67 TFLOP/s, against 6.21 GFLOP in
// the factored order. B1t's f32 design (node_factored_t.cu) with the
// contraction and the columns swapped, fed by a producer warp. A block of
// 256 consumer threads and one producer warp takes 16 nodes, 32 columns o
// and 16 b, and walks the contraction in chunks of 16 rows (k, i0 .. i0 +
// 16, padded past I). The producer streams each chunk's pieces through a
// 4-stage mbarrier ring: the chunk's pool rows at the block's columns for 8
// d at a time (TMA, a 4-d view (O, D, I, K) that fills past O, D and I
// with zeros) with e's columns of those d (loaded before it waits for the
// stage), then the chunk's hh for the 16 b and nodes (TMA, a 5-d view (4 i,
// B, I / 4, N, K) landing [n][i / 4][b][4 i]); by 4-byte cp.async where a
// row is no whole 16-byte units. The consumers form W for the 16 nodes in
// registers (8 nodes x 4 o of one row a thread: three 16-byte shared reads
// per 32 FMAs, e's a broadcast), put it in shared memory, and fold the
// chunk's hh into 4 b x 8 o of one node a thread (12 16-byte reads per 128
// FMAs). W never reaches device memory (38.8 MB at the gate); each node
// group reads the pool from L2 once (49 MB at the gate, 777 MB in the
// factored order). The blocks of a thread block cluster (2^s of them,
// chosen from the grid: 60 items at the gate, 30 at the update for 132
// SMs) split an item's chunks, and each adds its share of the item's sums
// over the cluster's partials in rank order through distributed shared
// memory (the same sums at every call). On an H100 80GB HBM3 at 700 W
// (PERF.md §6): 37.5 / 27.9 us at the gate / update against 471.8 / 472.0
// for the factored SIMT design this replaces and 0.15-0.26 ms for the f32
// torch.einsum; 3.6x / 5.3x the FMA bound. Two blocks an SM leave 96
// registers a thread (nine warps a block): forming W one d at a time keeps
// the 64 sums there without spills (unrolled, 6-7% slower); one block an
// SM with 128 registers ran 1.3x slower at the gate. The planted faults:
// the d = 0 term left out of W; the last chunk left out of the sums; rank
// 0's partial left out (where the chunks are split).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "simt_f32.cuh"
#include "wgmma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace wgmma_sm90;

// ---------------------------------------------------------------- f32 operands: the expanded order

constexpr int kFaultD = 1;                 // the d = 0 term left out of W
constexpr int kFaultChunk = 2;             // the contraction's last 16-row chunk left out of the sums
constexpr int kFaultRank = 3;              // cluster rank 0's partial left out of the sums (split > 1)
constexpr int kF32Nodes = 16;              // nodes of a block
constexpr int kF32Ot = 32;                 // output columns o of a block
constexpr int kF32Rows = 16;               // b of a block
constexpr int kF32Kc = 16;                 // contraction rows (k, i0 .. i0 + 16) of a chunk
constexpr int kF32Dc = 8;                  // d of a pool piece
constexpr int kF32Consumers = 256;         // 8 nodes x 4 o of one row a thread forming W; 4 b x 8 o folding
constexpr int kF32Threads = kF32Consumers + 32;   // and one producer warp
constexpr int kF32Stages = 4;
constexpr int kF32P = kF32Kc * kF32Dc * kF32Ot;   // floats of a piece's pool rows: [i][d][o]
constexpr int kF32H = kF32Nodes * kF32Kc * kF32Rows;   // floats of a chunk's hh: [n][i / 4][b][4 i]
constexpr int kF32Stage = kF32P + kF32Dc * kF32Nodes;  // a stage: a pool piece and its e columns [d][n], or hh
constexpr int kF32W = kF32Nodes * kF32Kc * kF32Ot;     // floats of a chunk's W: [n][row][o]
constexpr size_t kF32Smem =
    1024 + ((size_t)kF32Stages * kF32Stage + kF32W) * sizeof(float) + 2 * kF32Stages * sizeof(uint64_t);
static_assert(kF32H <= kF32Stage, "a chunk's hh fits a stage");
static_assert(kF32Consumers * 32 <= kF32Stages * kF32Stage, "the cluster's partial sums fit the ring");
static_assert(kF32Stage * sizeof(float) % 128 == 0, "every stage starts where TMA may write");

// out for nodes n0 .. n0 + 16, columns o0 .. o0 + 32 and b0 .. b0 + 16 of
// item blockIdx.x / split = (b tile * column tiles + column tile) * node
// groups + node group; the item's chunks (k, 16 i from i0) split over the
// cluster's blocks. Pieces in order, for each of the block's chunks: its
// pool rows pool[k, i0 + i, d O + o] at the block's columns for kF32Dc d at
// a time, with e's columns of those d, then its hh. The producer warp
// streams them through a ring of kF32Stages stages handed over by
// mbarriers: pool by TMA where ptma (O % 4 == 0, pool 16-byte aligned; a
// 4-d view (O, D, I, K), box 32 o x 8 d x 16 i), hh where htma (I % 4 == 0,
// hh 16-byte aligned; a 5-d view (4 i, B, I / 4, N, K), box 4 x 16 b x 4 x
// 16 n, landing [n][i / 4][b][4 i]), else by 4-byte cp.async; e's columns
// by its own loads, issued before it waits for the stage. Past the edges
// (i >= I, d >= D, o >= O, n >= N, b >= B) everything reads as zero.
__global__ void __launch_bounds__(kF32Threads, 2)
node_factored_f32_kernel(const __grid_constant__ CUtensorMap pool_map, const __grid_constant__ CUtensorMap hh_map,
                         const float* __restrict__ hh, const float* __restrict__ e, const float* __restrict__ pool,
                         float* __restrict__ out, int B, int K, int N, int I, int D, int O, int ptma, int htma,
                         int fault) {
  constexpr int G = kF32Nodes, S = kF32Stages, DC = kF32Dc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(aligned_smem(smem_raw));
  float* ws = ring + (size_t)S * kF32Stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + kF32W);
  uint64_t* empty = full + S;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const unsigned item = blockIdx.x / split;
  const int groups = (N + G - 1) / G, otiles = (O + kF32Ot - 1) / kF32Ot;
  const int n0 = (int)(item % groups) * G, o0 = (int)(item / groups % otiles) * kF32Ot;
  const int b0 = (int)(item / groups / otiles) * kF32Rows;
  // this block's chunks c0 .. c0 + ncb of the item's nch, each in ppc pieces
  const int icn = (I + kF32Kc - 1) / kF32Kc, nch = K * icn;
  const int per = (nch + split - 1) / split, c0 = min(nch, rank * per), ncb = min(nch, c0 + per) - c0;
  const int ndc = (D + DC - 1) / DC, ppc = ndc + 1, total = ncb * ppc;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 33);             // each producer lane's copies, then lane 0's arrival
      mbar_init(empty + s, kF32Consumers / 32);   // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  float acc[4][8];   // the fold: b fb + 4 j of node fn, columns fc .. fc + 3 and fc + 16 .. fc + 19
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int l = 0; l < 8; ++l) acc[j][l] = 0.f;
  const int fn = tid / 16, fb = tid / 4 % 4, fc = 4 * (tid % 4);

  if (tid >= kF32Consumers) {
    const int lane = tid - kF32Consumers;
    for (int g = 0; g < total; ++g) {
      const int c = c0 + g / ppc, r = g % ppc, k = c / icn, i0 = (c - k * icn) * kF32Kc, slot = g % S;
      float* st = ring + (size_t)slot * kF32Stage;
      // e's columns 8 r .. 8 r + 8 of the nodes, [d][n] (d = 0 left out under the planted fault)
      float ev[DC * G / 32];
      if (r < ndc) {
#pragma unroll
        for (int t = 0; t < DC * G / 32; ++t) {
          const int q = lane + 32 * t, d = r * DC + q / G, n = n0 + q % G;
          ev[t] = d < D && n < N && !(fault == kFaultD && d == 0) ? __ldg(e + (size_t)n * D + d) : 0.f;
        }
      }
      if (g >= S) mbar_wait(empty + slot, ((g / S) & 1) ^ 1);
      if (r < ndc) {
#pragma unroll
        for (int t = 0; t < DC * G / 32; ++t) st[kF32P + lane + 32 * t] = ev[t];
        if (!ptma) {
          for (int q = lane; q < kF32P; q += 32) {
            const int i = i0 + q / (DC * kF32Ot), d = r * DC + q / kF32Ot % DC, o = o0 + q % kF32Ot;
            const bool ok = i < I && d < D && o < O;
            simt_f32::cp_async4(st + q, ok ? pool + ((size_t)(k * I + i) * D + d) * O + o : pool, ok);
          }
        }
      } else if (!htma) {
        for (int q = lane; q < kF32H; q += 32) {
          const int n = n0 + q / 256, i = i0 + 4 * (q / 64 % 4) + q % 4, b = b0 + q / 4 % 16;
          const bool ok = n < N && i < I && b < B;
          simt_f32::cp_async4(st + q, ok ? hh + (((size_t)b * K + k) * N + n) * I + i : hh, ok);
        }
      }
      simt_f32::cp_async_mbar_arrive(full + slot);   // this lane's copies land (at once where it has none)
      __syncwarp();                                   // every lane's e columns are written
      if (lane == 0) {
        if (r < ndc ? ptma : htma) {
          mbar_arrive_tx(full + slot, (r < ndc ? kF32P : kF32H) * sizeof(float));
          if (r < ndc)
            tma_load_4d(st, &pool_map, o0, r * DC, i0, k, full + slot);
          else
            tma_load_5d(st, &hh_map, 0, b0, i0 / 4, n0, k, full + slot);
        } else {
          mbar_arrive(full + slot);
        }
      }
    }
  } else {
    // forming W[n, row, o] += e[n, d] pool[row, d, o]: nodes 8 wn .. 8 wn + 7,
    // chunk row wk, columns wo .. wo + 3
    const int wn = tid / 128, wk = tid % 128 / 8, wo = 4 * (tid % 8);
    float wacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int l = 0; l < 4; ++l) wacc[j][l] = 0.f;
    auto release = [&](int slot) {
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(empty + slot);
    };
    auto consumers_sync = [] { asm volatile("bar.sync 1, %0;\n" ::"n"(kF32Consumers) : "memory"); };
    int g = 0;
    for (int lc = 0; lc < ncb; ++lc) {
      for (int r = 0; r < ndc; ++r, ++g) {
        const int slot = g % S;
        mbar_wait(full + slot, (g / S) & 1);
        const float* st = ring + (size_t)slot * kF32Stage;
        auto step = [&](int dd) {
          const float4 p = *reinterpret_cast<const float4*>(st + (wk * DC + dd) * kF32Ot + wo);
          const float4 e0 = *reinterpret_cast<const float4*>(st + kF32P + dd * G + 8 * wn);
          const float4 e1 = *reinterpret_cast<const float4*>(st + kF32P + dd * G + 8 * wn + 4);
          const float ev[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            wacc[j][0] = fmaf(ev[j], p.x, wacc[j][0]);
            wacc[j][1] = fmaf(ev[j], p.y, wacc[j][1]);
            wacc[j][2] = fmaf(ev[j], p.z, wacc[j][2]);
            wacc[j][3] = fmaf(ev[j], p.w, wacc[j][3]);
          }
        };
        // one d at a time: the 64 sums of forming and folding stay in the 96
        // registers that two blocks an SM leave (unrolled, ptxas spilled them)
        const int dn = min(DC, D - r * DC);
#pragma unroll 1
        for (int dd = 0; dd < dn; ++dd) step(dd);
        release(slot);
      }
      // the chunk's W into shared memory, then out[b, n, o] += hh[b, k, n, i] W[n, (k, i), o]
      consumers_sync();   // the previous chunk's fold no longer reads ws
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float4*>(ws + ((8 * wn + j) * kF32Kc + wk) * kF32Ot + wo) =
            make_float4(wacc[j][0], wacc[j][1], wacc[j][2], wacc[j][3]);
        wacc[j][0] = wacc[j][1] = wacc[j][2] = wacc[j][3] = 0.f;
      }
      consumers_sync();
      const int slot = g % S;
      mbar_wait(full + slot, (g / S) & 1);
      if (!(fault == kFaultChunk && c0 + lc == nch - 1)) {
        const float* hs = ring + (size_t)slot * kF32Stage + fn * (kF32Kc * kF32Rows);
        const float* wt = ws + fn * (kF32Kc * kF32Ot);
#pragma unroll 1
        for (int ig = 0; ig < kF32Kc / 4; ++ig) {
          float4 hv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) hv[j] = *reinterpret_cast<const float4*>(hs + (ig * kF32Rows + fb + 4 * j) * 4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 w0 = *reinterpret_cast<const float4*>(wt + (4 * ig + u) * kF32Ot + fc);
            const float4 w1 = *reinterpret_cast<const float4*>(wt + (4 * ig + u) * kF32Ot + 16 + fc);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float a = u == 0 ? hv[j].x : u == 1 ? hv[j].y : u == 2 ? hv[j].z : hv[j].w;
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
      release(slot);
      ++g;
    }
  }

  const bool consumer = tid < kF32Consumers;
  if (split > 1) {
    // each block leaves its sums in its ring (every piece was waited for: no
    // copy is in flight); block r adds the 16-byte groups q = 2 j + h of
    // every consumer with q % split == r over the cluster's blocks in rank
    // order (the same sums at every call)
    float* red = ring;
    __syncthreads();   // the ring is read
    if (consumer) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(red + ((2 * j + h) * kF32Consumers + tid) * 4) =
              make_float4(acc[j][4 * h], acc[j][4 * h + 1], acc[j][4 * h + 2], acc[j][4 * h + 3]);
    }
    cluster.sync();
    if (consumer) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if ((2 * j + h) % split != rank) continue;
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int q = fault == kFaultRank ? 1 : 0; q < split; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) +
                                                              ((2 * j + h) * kF32Consumers + tid) * 4);
            sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
          }
          acc[j][4 * h] = sum.x, acc[j][4 * h + 1] = sum.y, acc[j][4 * h + 2] = sum.z, acc[j][4 * h + 3] = sum.w;
        }
    }
  }

  const int n = n0 + fn;
  if (consumer && n < N) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + fb + 4 * j;
      if (b >= B) continue;
      float* row = out + ((size_t)b * N + n) * O;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + fc + 16 * h;
        if (o >= O || (2 * j + h) % split != rank) continue;
        if (O % 4 == 0) {   // four columns at once: rows and column groups start 16-byte aligned
          *reinterpret_cast<float4*>(row + o) =
              make_float4(acc[j][4 * h], acc[j][4 * h + 1], acc[j][4 * h + 2], acc[j][4 * h + 3]);
        } else {
          for (int l = 0; l < 4 && o + l < O; ++l) row[o + l] = acc[j][4 * h + l];
        }
      }
    }
  }
  if (split > 1) cluster.sync();   // the partials are read before any block of the cluster leaves
}

// f32 tiles: the item's chunks split over 2^s blocks of a cluster, s = 0 .. 3
constexpr int kF32Tiles = 4;

// The f32 tile for these dimensions: the split whose busiest SM has the
// least work, (blocks per SM, rounded up) x chunks a block; of equals, the
// larger split (more blocks an SM hide more latency).
int choose_f32_tile(int b, int k, int n, int i, int o) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                 cudaSuccess)
    sms = 132;
  const long items = (long)((n + kF32Nodes - 1) / kF32Nodes) * ((o + kF32Ot - 1) / kF32Ot) *
                     ((b + kF32Rows - 1) / kF32Rows);
  const int nch = k * ((i + kF32Kc - 1) / kF32Kc);
  int best = 0;
  long best_work = -1;
  for (int s = 0; s < kF32Tiles && (1 << s) <= (nch > 1 ? nch : 1); ++s) {
    const long per = (nch + (1 << s) - 1) >> s, blocks = items << s;
    const long work = (blocks + sms - 1) / sms * per;
    if (best_work < 0 || work <= best_work) best = s, best_work = work;
  }
  return best;
}

cudaError_t launch_f32(const void* hh, const void* e, const void* pool, void* out, int b, int k, int n, int i, int d,
                       int o, int tile, int fault, cudaStream_t stream) {
  if (tile >= kF32Tiles) return cudaErrorInvalidValue;
  if (k * i == 0) return cudaMemsetAsync(out, 0, (size_t)b * n * o * sizeof(float), stream);
  if (tile < 0) tile = choose_f32_tile(b, k, n, i, o);
  const int split = 1 << tile;
  auto kernel = node_factored_f32_kernel;
  static unsigned long long ready = 0;   // the devices whose attributes are set (the first 64)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(ready >> dev & 1)) {
    err = allow_smem(kernel, kF32Smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready |= 1ull << dev;
  }
  const long blocks = (long)split * ((n + kF32Nodes - 1) / kF32Nodes) * ((o + kF32Ot - 1) / kF32Ot) *
                      ((b + kF32Rows - 1) / kF32Rows);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  // the views, where the rows are whole 16-byte units; a view that the shape
  // allows and cuTensorMapEncodeTiled refuses is an error
  CUtensorMap pool_map = {}, hh_map = {};
  const int ptma = o % 4 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  const int htma = i % 4 == 0 && reinterpret_cast<uintptr_t>(hh) % 16 == 0;
  if (ptma) {
    const cuuint64_t dims[4] = {(cuuint64_t)o, (cuuint64_t)d, (cuuint64_t)i, (cuuint64_t)k};
    const cuuint64_t strides[3] = {(cuuint64_t)o * 4, (cuuint64_t)d * o * 4, (cuuint64_t)i * d * o * 4};
    const cuuint32_t box[4] = {kF32Ot, kF32Dc, kF32Kc, 1};
    err = encode_tiled<4>(&pool_map, pool, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (err != cudaSuccess) return err;
  }
  if (htma) {
    const cuuint64_t dims[5] = {4, (cuuint64_t)b, (cuuint64_t)i / 4, (cuuint64_t)n, (cuuint64_t)k};
    const cuuint64_t strides[4] = {(cuuint64_t)k * n * i * 4, 16, (cuuint64_t)i * 4, (cuuint64_t)n * i * 4};
    const cuuint32_t box[5] = {4, kF32Rows, kF32Kc / 4, kF32Nodes, 1};
    err = encode_tiled<5>(&hh_map, hh, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (err != cudaSuccess) return err;
  }
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
  err = cudaLaunchKernelEx(&cfg, kernel, pool_map, hh_map, static_cast<const float*>(hh),
                           static_cast<const float*>(e), static_cast<const float*>(pool), static_cast<float*>(out), b,
                           k, n, i, d, o, ptma, htma, fault);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

// ---------------------------------------------------------------- bf16 operands: tensor cores

constexpr size_t kMaxSmem = 227 * 1024;   // shared memory one block may use on an H100
constexpr int kChunk = 64;    // contraction rows of one pool chunk; the contraction is padded to it
constexpr int kStages = 4;    // pool chunks in the ring

__host__ __device__ constexpr int pad_k(int x) { return (x + kChunk - 1) / kChunk * kChunk; }

template <int WG, int DG, int OT>
size_t wgmma_smem_bytes(int ki) {
  return ((size_t)64 * WG * pad_k(ki) + (size_t)kStages * kChunk * DG * OT) * sizeof(__nv_bfloat16) +
         (size_t)OT / 2 * WG * 128 * sizeof(float) + 2 * kStages * sizeof(uint64_t);
}

// WG consumer warpgroups of 64 rows each and one producer warp; OT output
// columns per block. One wgmma's N = DG * OT columns gathers the pool's
// columns o0 .. o0 + OT of DG consecutive d: r_d for DG values of d at once.
// The producer streams chunks (kChunk rows x those N columns) through the
// ring, by TMA where `tma` is set (a 5-d view of the pool that lands a chunk
// in MN-major cores: dims (8 columns, 8 rows, O/8 column groups, D, K*I/8
// row groups)), else by element loads.
template <int WG, int DG, int OT, typename OutT>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
node_factored_wgmma_kernel(const __grid_constant__ CUtensorMap pool_map, int tma,
                           const __nv_bfloat16* __restrict__ hh, const float* __restrict__ e,
                           const __nv_bfloat16* __restrict__ pool, const float* __restrict__ s,
                           OutT* __restrict__ out, int steps, int B, int K, int N, int I, int D, int O) {
  constexpr int BM = 64 * WG;
  constexpr int BN = DG * OT;                    // the wgmma's N
  constexpr int kConsumers = WG * 128;
  constexpr int kR = BN / 2, kAcc = OT / 2;      // f32 accumulators of one thread: r of DG d, their sum
  constexpr int kChunkElems = kChunk * BN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int KI = K * I, KIc = pad_k(KI), KG = KIc / 8;
  const int M = B * N;
  const int chunks_per_d = KIc / kChunk;         // chunks of one group of DG d
  const int d_groups = (D + DG - 1) / DG;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BM x KIc, K-major cores
  __nv_bfloat16* ps = as + (size_t)BM * KIc;     // kStages chunks, core (kg, ng) at (kg BN/8 + ng) 64
  float* acc_s = reinterpret_cast<float*>(ps + (size_t)kStages * kChunkElems);   // kAcc x kConsumers sums
  uint64_t* full = reinterpret_cast<uint64_t*>(acc_s + kAcc * kConsumers);
  uint64_t* empty = full + kStages;

  const int m0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * OT;
  const int rot = blockIdx.x % d_groups;         // row tiles start at different d: fewer readers per pool line
  const int tid = threadIdx.x;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, WG);                // one arrival per consumer warpgroup
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: chunk g = ((t d_groups + j) chunks_per_d + kc) holds pool
    // rows kChunk kc .. of d = DG ((j + rot) % d_groups) + 0 .. DG-1, columns
    // o0 .. o0 + OT of each; rows past K*I, d past D and columns past O are 0
    const int lane = tid - kConsumers;
    const int total = steps * d_groups * chunks_per_d;
    for (int g = 0; g < total; ++g) {
      const int slot = g % kStages;
      if (g >= kStages) mbar_wait(empty + slot, ((g / kStages) & 1) ^ 1);
      const int kc = g % chunks_per_d, d0 = DG * ((g / chunks_per_d % d_groups + rot) % d_groups);
      __nv_bfloat16* dst = ps + (size_t)slot * kChunkElems;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_tx(full + slot, kChunkElems * sizeof(__nv_bfloat16));
          tma_load_5d(dst, &pool_map, 0, 0, o0 / 8, d0, kChunk / 8 * kc, full + slot);
        }
      } else {
        const int k0 = kChunk * kc;
        for (int q = lane; q < kChunkElems; q += 32) {
          const int k = q / BN, c = q - k * BN, d = d0 + c / OT, o = o0 + c % OT;
          dst[(k / 8 * (BN / 8) + c / 8) * 64 + (k % 8) * 8 + c % 8] =
              (k0 + k < KI && d < D && o < O) ? pool[(size_t)(k0 + k) * D * O + (size_t)d * O + o] : zero;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + slot);
      }
    }
  } else {
    // consumers
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    // the block's rows of step t: row m = (b, n), column (k, i) at
    // hh[t][b][k][n][i]; rows past M and columns past K*I are 0. Two threads
    // a row, each taking every other 8-column group, walk (k, i) without
    // dividing.
    auto load_rows = [&](int t) {
      const int r = tid % BM, half = tid / BM;
      const int m = m0 + r;
      const int b = m / N, n = m - b * N;
      const __nv_bfloat16* row = hh + (size_t)t * M * KI + ((size_t)b * K * N + n) * I;
      int k = (8 * half) / I, i = 8 * half - k * I;
      for (int c = 8 * half; c < KIc; c += 16) {
        if (I % 8 == 0) {
          const bool ok = m < M && c < KI;
          cp_async16(as + core_offset(r, c, KG), ok ? row + (size_t)k * N * I + i : hh, ok);
        } else {
          int kl = k, il = i;
#pragma unroll
          for (int l = 0; l < 8; ++l) {
            as[core_offset(r, c + l, KG)] = m < M && c + l < KI ? row[(size_t)kl * N * I + il] : zero;
            if (++il == I) il = 0, ++kl;
          }
        }
        for (i += 16; i >= I && I > 0; i -= I) ++k;
      }
    };
    auto consumers_sync = [] { asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory"); };
    // the slot's products are done: its warpgroup frees it for the producer
    auto release = [&](int slot) {
      if (tid % 128 == 0) mbar_arrive(empty + slot);
    };

    // this thread's two rows (16 warp + lane/4, + 8) of its warpgroup's 64,
    // and e's row of each (-1 past M)
    int erow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
      erow[h] = m < M ? (m % N) * D : -1;
    }
    const float sv = s != nullptr ? *s : 0.f;
    const __nv_bfloat16* a_wg = as + (size_t)64 * wg * KIc;   // this warpgroup's rows: 8 row groups of KG cores

    int g = 0;
    for (int t = 0; t < steps; ++t) {
      consumers_sync();             // the previous step's products no longer read the rows
      load_rows(t);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      consumers_sync();

      // the sum over d lives in shared memory (a column per thread), so that
      // only r holds registers across the products
      float r[kR] = {};
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc_s[i * kConsumers + tid] = 0.f;
      for (int j = 0; j < d_groups; ++j) {
        const int d0 = DG * ((j + rot) % d_groups);
        // r_d = rows @ pool_d over the whole contraction, in f32, for d0 .. d0 + DG:
        // each chunk's products go out while the previous chunk's finish, whose
        // buffer is then released to the producers
        for (int kc = 0; kc < chunks_per_d; ++kc, ++g) {
          const int slot = g % kStages;
          mbar_wait(full + slot, (g / kStages) & 1);
          const __nv_bfloat16* p = ps + (size_t)slot * kChunkElems;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kChunk / 16; ++ks)
            Wgmma<BN>::mma(r, desc(a_wg + (size_t)(kChunk / 8 * kc + 2 * ks) * 64, KG),
                           desc(p + (size_t)2 * ks * (BN / 8) * 64, BN / 8 * 128u, 128u), kc > 0 || ks > 0);
          wgmma_commit();
          if (kc > 0) {
            wgmma_wait<1>();
            release((g - 1) % kStages);
          }
        }
        wgmma_wait<0>();
        release((g - 1) % kStages);
        // acc += e[., d] * r_d for the group's d: r[dl kAcc + 4 i + v] is column
        // 8 i + 2 (lane % 4) + v % 2 of d0 + dl, of the row of v / 2
#pragma unroll
        for (int dl = 0; dl < DG; ++dl) {
          if (d0 + dl >= D) break;
          const float e0 = erow[0] >= 0 ? __ldg(e + erow[0] + d0 + dl) : 0.f;
          const float e1 = erow[1] >= 0 ? __ldg(e + erow[1] + d0 + dl) : 0.f;
#pragma unroll
          for (int i = 0; i < kAcc; ++i)
            acc_s[i * kConsumers + tid] = fmaf(i % 4 < 2 ? e0 : e1, r[dl * kAcc + i], acc_s[i * kConsumers + tid]);
        }
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
        if (m >= M) continue;
        OutT* row = out + (size_t)m * O + o0;
#pragma unroll
        for (int i = 0; i < OT / 8; ++i)
          store_pair(row, 8 * i + 2 * (lane % 4), O - o0, acc_s[(4 * i + 2 * h) * kConsumers + tid] + sv,
                     acc_s[(4 * i + 2 * h + 1) * kConsumers + tid] + sv);
      }
    }
  }
}

template <int WG, int DG, int OT, typename OutT>
cudaError_t launch_wgmma(const void* hh, const void* e, const void* pool, const void* s, void* out, int steps,
                         int b, int k, int n, int i, int d, int o, cudaStream_t stream) {
  auto kernel = node_factored_wgmma_kernel<WG, DG, OT, OutT>;
  const size_t smem = wgmma_smem_bytes<WG, DG, OT>(k * i);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  // the pool's chunks by TMA where whole 16-byte column groups and row
  // groups allow the view, else by the producer warp's element loads; a
  // view that the shape allows and cuTensorMapEncodeTiled refuses is an error
  CUtensorMap map = {};
  const int tma = o % 8 == 0 && k * i % 8 == 0;
  if (tma) {
    const cuuint64_t dims[5] = {8, 8, (cuuint64_t)o / 8, (cuuint64_t)d, (cuuint64_t)k * i / 8};
    const cuuint64_t strides[4] = {(cuuint64_t)d * o * 2, 16, (cuuint64_t)o * 2, (cuuint64_t)d * o * 16};
    const cuuint32_t box[5] = {8, 8, OT / 8, DG, kChunk / 8};
    err = encode_tiled<5>(&map, pool, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((b * n + 64 * WG - 1) / (64 * WG)), (unsigned)((o + OT - 1) / OT));
  kernel<<<grid, WG * 128 + 32, smem, stream>>>(
      map, tma, static_cast<const __nv_bfloat16*>(hh), static_cast<const float*>(e),
      static_cast<const __nv_bfloat16*>(pool), static_cast<const float*>(s), static_cast<OutT*>(out), steps, b, k, n,
      i, d, o);
  return cudaGetLastError();
}

// tiles (rows x columns, d per wgmma): 0: 192x32 (5), 1: 128x48 (4), 2: 128x32 (4), 3: 128x16 (8)
constexpr int kTiles = 4;
constexpr int kTileRows[kTiles] = {192, 128, 128, 128}, kTileCols[kTiles] = {32, 48, 32, 16};

template <typename OutT>
cudaError_t launch_tile(int tile, const void* hh, const void* e, const void* pool, const void* s, void* out,
                        int steps, int b, int k, int n, int i, int d, int o, cudaStream_t stream) {
  switch (tile) {
    case 0: return launch_wgmma<3, 5, 32, OutT>(hh, e, pool, s, out, steps, b, k, n, i, d, o, stream);
    case 1: return launch_wgmma<2, 4, 48, OutT>(hh, e, pool, s, out, steps, b, k, n, i, d, o, stream);
    case 2: return launch_wgmma<2, 4, 32, OutT>(hh, e, pool, s, out, steps, b, k, n, i, d, o, stream);
    case 3: return launch_wgmma<2, 8, 16, OutT>(hh, e, pool, s, out, steps, b, k, n, i, d, o, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The tile whose busiest SM has the least work, (blocks per SM, rounded up)
// x rows x columns, of those whose activations fit beside their ring; of
// equals, the earliest (larger tiles read the pool fewer times).
int choose_tile(int m, int o, int ki) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                 cudaSuccess)
    sms = 132;
  const size_t smem[kTiles] = {wgmma_smem_bytes<3, 5, 32>(ki), wgmma_smem_bytes<2, 4, 48>(ki),
                               wgmma_smem_bytes<2, 4, 32>(ki), wgmma_smem_bytes<2, 8, 16>(ki)};
  int best = kTiles - 1;
  long best_work = -1;
  for (int tile = 0; tile < kTiles; ++tile) {
    if (smem[tile] > kMaxSmem) continue;
    const long blocks = (long)((m + kTileRows[tile] - 1) / kTileRows[tile]) *
                        ((o + kTileCols[tile] - 1) / kTileCols[tile]);
    const long work = (blocks + sms - 1) / sms * kTileRows[tile] * kTileCols[tile];
    if (best_work < 0 || work < best_work) best = tile, best_work = work;
  }
  return best;
}

}  // namespace

// As node_factored_fwd, with the kernel's tile given, for measuring it: bf16
// operands 0: 192x32, 1: 128x48, 2: 128x32, 3: 128x16; f32 operands the
// chunks split over 2^tile blocks of a cluster (node_factored_f32_tile's
// code); -1: chosen from the grid.
extern "C" int node_factored_fwd_tile(const void* hh, const void* e, const void* pool, const void* s, void* out,
                                      int steps, int b, int k, int n, int i, int d, int o,
                                      int bf16_in, int bf16_out, int tile, void* stream) {
  if (steps == 0 || b == 0 || n == 0 || o == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16_in) {
    if (bf16_out || steps != 1 || s != nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_f32(hh, e, pool, out, b, k, n, i, d, o, tile, 0, st);
  }
  if (tile < 0) tile = choose_tile(b * n, o, k * i);
  return (int)(bf16_out ? launch_tile<__nv_bfloat16>(tile, hh, e, pool, s, out, steps, b, k, n, i, d, o, st)
                        : launch_tile<float>(tile, hh, e, pool, s, out, steps, b, k, n, i, d, o, st));
}

// Launches on `stream`; returns cudaGetLastError() after the launch, or the
// error of a TMA view where the shape takes TMA (bf16 operands: the pool's,
// O and K*I multiples of 8; f32: the pool's where O % 4 == 0, hh's where I %
// 4 == 0, each 16-byte aligned) and the view cannot be encoded. `s` may
// be null (no scalar). bf16_in: hh and pool are bf16 (else f32); bf16_out:
// out is bf16 (else f32), taken only with bf16_in (the harness's rows mode).
// f32 operands take one step and no scalar (cudaErrorInvalidValue else).
extern "C" int node_factored_fwd(const void* hh, const void* e, const void* pool, const void* s, void* out,
                                 int steps, int b, int k, int n, int i, int d, int o,
                                 int bf16_in, int bf16_out, void* stream) {
  return node_factored_fwd_tile(hh, e, pool, s, out, steps, b, k, n, i, d, o, bf16_in, bf16_out, -1, stream);
}

// The f32 kernel's tile for these dimensions: the chunks split over 2^tile
// blocks of a cluster.
extern "C" int node_factored_f32_tile(int b, int k, int n, int i, int o) { return choose_f32_tile(b, k, n, i, o); }

// f32 operands (hh (B,K,N,I), e (N,D), pool (K,I,D*O), out (B,N,O)), the
// tile as node_factored_fwd_tile's (-1: chosen) and a fault planted in the
// kernel (0: none, 1: the d = 0 term left out of W, 2: the contraction's
// last 16-row chunk left out of the sums, 3: cluster rank 0's partial left
// out of the sums, where the tile splits the chunks).
extern "C" int node_factored_fwd_f32(const void* hh, const void* e, const void* pool, void* out, int b, int k,
                                     int n, int i, int d, int o, int tile, int fault, void* stream) {
  if (b == 0 || n == 0 || o == 0) return (int)cudaSuccess;
  return (int)launch_f32(hh, e, pool, out, b, k, n, i, d, o, tile, fault, static_cast<cudaStream_t>(stream));
}
