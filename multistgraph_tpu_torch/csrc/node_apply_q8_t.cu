// Transposed int8 node-conditioned weight apply for Hopper (sm_90a): kernel B2t.
//
//   dhh[n,b,ki] = T( sum_o bf16(dpre[n,b,o] * scale[n,0,o]) * wq[n,ki,o] )
//
// dpre (N,B,O) of type T (bf16, f32 or f16), wq (Nw,KI,O) int8 with Nw >= N
// (rows past N are never read), scale (Nw,1,O) f32, dhh (N,B,KI) of type T;
// all contiguous.
//
// Replaces the Pallas kernel multistgraph_tpu/ops/node_apply.py:
// _apply_q8_t_kernel / node_apply_q8_t, the cotangent of node_apply_q8 in
// the int8 reverse scan, at its rounding points: the cotangent is widened
// to f32 and scaled (the per-(n,o) scale lies on the contraction dim here,
// so it folds into the cotangent before the dot), rounded to bf16,
// contracted over O against the exactly widened int8 weights in f32, and
// the sum is cast to the cotangent's type (out_dtype's default there, the
// only one the model asks for).
//
// Bound on an H100: bytes. At the flagship gate (N=237, B=16, KI=320,
// O=128) the call reads 0.97 MB of bf16 cotangent and 9.7 MB of int8
// weights and writes 2.4 MB of bf16, 13.2 MB in all: 3.9 us at 3.35 TB/s,
// against 0.3 us of bf16 tensor-core time (2.3 us at the update, O=64);
// with an f32 cotangent and result 16.5 MB, 4.9 us (3.2 us at the update).
// The design (node_apply_q8.cuh, shared with B2): dhh[n]^T = wq[n] . q[n]^T
// on wgmma, the weights widened on chip into K-major A (64 ki rows a block),
// the cotangent by TMA as K-major B with the batch on N, scaled and rounded
// in shared memory (in place for bf16, from the raw rows for f32 and f16).

#include "node_apply_q8.cuh"

// Launches on `stream` with dpre and dhh of element type dpre_type (0:
// bf16, 1: f32, 2: f16), the batch tile bn (0: chosen from b;
// else 8, 16, 24, 32, 64 or 128) and a fault planted in the kernel (0:
// none, 1: the contraction's last k16 slice dropped, 2: the batch columns
// past the first 8 of a tile written as zeros); returns cudaGetLastError()
// after the launch, or the error of a TMA view that cannot be encoded (a
// base that is not 16-byte aligned where O % 16 == 0, or where dpre's rows
// are whole 16-byte units, takes TMA).
extern "C" int node_apply_q8_t_bwd_typed(const void* dpre, const void* wq, const void* scale, void* dhh, int n, int b,
                                         int ki, int o, int bn, int fault, int dpre_type, void* stream) {
  return (int)q8_sm90::launch_q8<true>(dpre, wq, scale, dhh, n, b, ki, o, bn, fault, dpre_type,
                                       static_cast<cudaStream_t>(stream));
}

// As node_apply_q8_t_bwd_typed with a bf16 dpre and dhh, the chosen tile
// and no fault: the interface that builds of the kernel share
// (tools/ab_node_apply.py).
extern "C" int node_apply_q8_t_bwd(const void* dpre, const void* wq, const void* scale, void* dhh,
                                   int n, int b, int ki, int o, void* stream) {
  return node_apply_q8_t_bwd_typed(dpre, wq, scale, dhh, n, b, ki, o, 0, 0, q8_sm90::kTypeBf16, stream);
}
