// int8 node-conditioned weight apply for Hopper (sm_90a): kernel B2.
//
//   out[n,b,o] = (sum_ki hh[n,b,ki] * wq[n,ki,o]) * scale[n,0,o]
//
// hh (N,B,KI) bf16, f32 or f16, wq (Nw,KI,O) int8 with Nw >= N (rows past N
// are never read), scale (Nw,1,O) f32, out (N,B,O) f32; all contiguous.
//
// Replaces the Pallas kernel multistgraph_tpu/ops/node_apply.py:
// _apply_q8_kernel / node_apply_q8, which takes hh of any float type. The
// per-(n,o) scale commutes with the (k,i) contraction, so one multiply
// after the f32 dot gives exact dequantized math; the int8 -> bf16
// widening is exact, and so is the split of an f32 (f16) hh into three
// (two) bf16 pieces, so every product is exact and the f32 sums round.
//
// Bound on an H100: bytes. At the flagship gate (N=237, B=16, KI=320,
// O=128) the call moves 14.2 MB with bf16 hh (the int8 weights are 9.7 MB
// of it) for 0.31 GFLOP, 4.2 us at 3.35 TB/s against 0.3 us of bf16
// tensor-core time; with f32 hh 16.5 MB, 4.9 us, against 0.9 us for the
// three pieces. At B=256 it moves 80 MB with bf16 hh (hh 39 MB, out 31 MB),
// 23.8 us, for 5 GFLOP; with f32 hh about 118 MB, 35 us.
// The design (node_apply_q8.cuh, shared with B2t): out[n]^T = wq[n]^T .
// hh[n]^T on wgmma, the weights widened on chip into MN-major A, hh by TMA
// as K-major B with the batch on N (f32 and f16 hh split into its bf16
// pieces on chip), each node's weights streamed once through an mbarrier
// ring.

#include "node_apply_q8.cuh"

// The batch tile (wgmma's N) the kernel takes for a batch of b with hh of
// element type hh_type (0: bf16, 1: f32, 2: f16).
extern "C" int node_apply_q8_bn(int b, int hh_type) { return q8_sm90::choose_bn(b, hh_type != q8_sm90::kTypeBf16); }

// Launches on `stream` with hh of element type hh_type (0: bf16, 1: f32,
// 2: f16), the batch tile bn (0: chosen from b; else 8, 16, 24, 32, 64 or
// 128) and a fault planted in the kernel (0: none, 1: the contraction's
// last k16 slice dropped, 2: the batch columns past the first 8 of a tile
// written as zeros); returns cudaGetLastError() after the launch, or the
// error of a TMA view that cannot be encoded (a base that is not 16-byte
// aligned where O % 16 == 0, or where hh's rows are whole 16-byte units,
// takes TMA).
extern "C" int node_apply_q8_fwd_typed(const void* hh, const void* wq, const void* scale, void* out, int n, int b,
                                       int ki, int o, int bn, int fault, int hh_type, void* stream) {
  return (int)q8_sm90::launch_q8<false>(hh, wq, scale, out, n, b, ki, o, bn, fault, hh_type,
                                        static_cast<cudaStream_t>(stream));
}

// As node_apply_q8_fwd_typed with bf16 hh, the chosen tile and no fault:
// the interface that builds of the kernel share (tools/ab_node_apply.py).
extern "C" int node_apply_q8_fwd(const void* hh, const void* wq, const void* scale, void* out,
                                 int n, int b, int ki, int o, void* stream) {
  return node_apply_q8_fwd_typed(hh, wq, scale, out, n, b, ki, o, 0, 0, q8_sm90::kTypeBf16, stream);
}
