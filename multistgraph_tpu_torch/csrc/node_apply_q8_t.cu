// Transposed int8 node-conditioned weight apply for Hopper (sm_90a): kernel B2t.
//
//   dhh[n,b,ki] = bf16( sum_o bf16(dpre[n,b,o] * scale[n,0,o]) * wq[n,ki,o] )
//
// dpre (N,B,O) bf16, wq (Nw,KI,O) int8 with Nw >= N (rows past N are never
// read), scale (Nw,1,O) f32, dhh (N,B,KI) bf16; all contiguous.
//
// Replaces the Pallas kernel multistgraph_tpu/ops/node_apply.py:
// _apply_q8_t_kernel / node_apply_q8_t, the cotangent of node_apply_q8 in
// the int8 reverse scan, at its rounding points: the bf16 cotangent is
// widened to f32 and scaled (the per-(n,o) scale lies on the contraction
// dim here, so it folds into the cotangent before the dot), rounded to
// bf16, contracted over O against the exactly widened int8 weights in f32,
// and the sum is rounded to bf16.
//
// Bound on an H100: bytes. At the flagship gate (N=237, B=16, KI=320,
// O=128) the call reads 0.97 MB of cotangent and 9.7 MB of int8 weights
// and writes 2.4 MB, 13.2 MB in all: 3.9 us at 3.35 TB/s, against 0.3 us
// of bf16 tensor-core time (2.3 us at the update, O=64). The design
// (node_apply_q8.cuh, shared with B2): dhh[n]^T = wq[n] . q[n]^T on wgmma,
// the weights widened on chip into K-major A (64 ki rows a block), the
// cotangent by TMA as K-major B with the batch on N, scaled and rounded in
// shared memory.

#include "node_apply_q8.cuh"

// As node_apply_q8_t_bwd, with the batch tile given (0: chosen from b; else
// 8, 16, 24, 32, 64 or 128) and a fault planted in the kernel (0:
// none, 1: the contraction's last k16 slice dropped, 2: the batch columns
// past the first 8 of a tile written as zeros).
extern "C" int node_apply_q8_t_bwd_tile(const void* dpre, const void* wq, const void* scale, void* dhh, int n, int b,
                                        int ki, int o, int bn, int fault, void* stream) {
  return (int)q8_sm90::launch_q8<true>(dpre, wq, scale, dhh, n, b, ki, o, bn, fault,
                                       static_cast<cudaStream_t>(stream));
}

// Launches on `stream`; returns cudaGetLastError() after the launch, or the
// error of a TMA view that cannot be encoded (a base that is not 16-byte
// aligned where O % 16 == 0 or O % 8 == 0 takes TMA).
extern "C" int node_apply_q8_t_bwd(const void* dpre, const void* wq, const void* scale, void* dhh,
                                   int n, int b, int ki, int o, void* stream) {
  return node_apply_q8_t_bwd_tile(dpre, wq, scale, dhh, n, b, ki, o, 0, 0, stream);
}
