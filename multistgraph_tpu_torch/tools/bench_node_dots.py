"""Node-apply design harness on the card: expanded weights against factored.

Counterpart of tools/bench_node_dots.py. The ATGRU recurrence applies a
different (K*I, O) weight to every node at each step (reference MultiSTGraph
MultiATGCN.py:104-108). The harness measures its formulations at the
DC-237 flagship encoder step with gate and update fused (O = 2H + H = 192):

  A  per-node dots: the expanded weights (31.5 MB in bf16, which fits the
     H100's 50 MB L2) read at every step against B = 16 rows per node
     (``ops.node_dots``, csrc/node_dots.cu)
  B  factored pool: one full-M product of the (B*NP, KI) rows against the
     (KI, D*O) pool, then the e-contraction (D-fold FLOPs, no weight
     stream; ``ops.node_apply.node_factored_rows``, B1's kernel)
  C  library baseline: the step loop of the bf16 einsum the model uses,
     with its bf16 carry (torch.einsum)
  D  read floor: every byte of A's operands read, ~no compute
     (``ops.stream_read.node_dots_floor``, csrc/stream_read.cu)

Each variant takes a chained scalar folded into its output, and each timed
run chains REPEAT calls, feeding each output's mean back into the next
scalar, as the TPU harness did. A, B and D run all T steps inside one call;
C launches one einsum per step. The kernels tile their own way, so the TPU
harness's RB (rows per grid step) has no counterpart.

Then B1 and B1t at the model's own layout, the flagship gate (O = 128) and
update (O = 64) cells at N = 237 nodes, against the einsum of the expanded
weights they replace, in bf16: the factored-against-expanded question at
D = 20 on this card.

Run from the repository root:
    python -m multistgraph_tpu_torch.tools.bench_node_dots              (on the card)
    python -m multistgraph_tpu_torch.tools.bench_node_dots --device cpu (numerics only)
``--small`` takes reduced shapes (T=3, B=4, NP=64, KI=24, O=16, D=3) for a
quick numerics run. On the card it prints the ranking, the card's name and
power limit, and one JSON line; without a card and without --device cpu it
raises.
"""

import argparse
import json
from collections import namedtuple

import numpy as np
import torch

from multistgraph_tpu_torch.ops.node_apply import (
    node_factored_apply,
    node_factored_apply_t,
    node_factored_rows,
    pool_to_kernel_layout,
)
from multistgraph_tpu_torch.ops.node_dots import node_dots
from multistgraph_tpu_torch.ops.stream_read import node_dots_floor
from multistgraph_tpu_torch.tools import timing
from multistgraph_tpu_torch.utils.device import resolve_device

Shapes = namedtuple("Shapes", "T B NP K H O D BLK N")
# tools/bench_node_dots.py:41-46 (B, N, NP, H, K, D, T; O = 3H; BLK = 32
# nodes per TPU grid step) and the DC-237 node count for the B1/B1t cells
FULL = Shapes(T=24, B=16, NP=256, K=5, H=64, O=192, D=20, BLK=32, N=237)
SMALL = Shapes(T=3, B=4, NP=64, K=3, H=8, O=16, D=3, BLK=32, N=40)
REPEAT = 16


def make_inputs(shapes, device, seed=0):
    """hh (T,B,NP,KI), w (NP,KI,O), e (NP,D), pool (KI,D*O), bf16, drawn
    in the TPU harness's order and scale."""
    rng = np.random.default_rng(seed)
    ki = shapes.K * shapes.H

    def f16(*s):
        return (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16) * 0.1).to(device)

    hh = f16(shapes.T, shapes.B, shapes.NP, ki)
    w = f16(shapes.NP, ki, shapes.O)
    e = f16(shapes.NP, shapes.D)
    pool = f16(ki, shapes.D * shapes.O)
    return hh, w, e, pool


def variants(shapes, hh, w, e, pool):
    """{name: call(s) -> output} of variants A to D on the given inputs."""
    sh = shapes
    ki = sh.K * sh.H
    hh_flat = hh.reshape(sh.T, sh.B, sh.NP * ki)
    hh_rows = hh.reshape(sh.T, sh.B * sh.NP, ki)
    e_rows = e.repeat(sh.B, 1)
    hh_t = hh.reshape(sh.T, sh.B, sh.NP, sh.K, sh.H).permute(0, 1, 3, 2, 4).contiguous()
    w4 = w.reshape(sh.NP, sh.K, sh.H, sh.O)

    def c_einsum(s):
        carry = torch.zeros(sh.B, sh.NP, sh.O, dtype=torch.bfloat16, device=hh.device) + s.to(torch.bfloat16)
        for t in range(sh.T):
            carry = carry + torch.einsum("bkni,nkio->bno", hh_t[t], w4)
        return carry

    return {
        "A_node_dots": lambda s: node_dots(hh_flat, w, s),
        "B_factored_resident_pool": lambda s: node_factored_rows(hh_rows, e_rows, pool, s),
        "C_library_einsum_steps": c_einsum,
        "D_read_floor": lambda s: node_dots_floor(hh_flat, w, s, sh.BLK)[0],
    }


def check_numerics(shapes, hh, w, e, pool, calls):
    """The TPU harness's consistency checks (tools/bench_node_dots.py:
    204-233): A against the reference contraction at the last step (atol
    0.5, rtol 0.1), B against its own pool's expansion (atol 1.0, rtol 0.15)."""
    sh = shapes
    ki = sh.K * sh.H
    zero = torch.zeros(1, 1, dtype=torch.float32, device=hh.device)
    ref = torch.einsum("bni,nio->bno", hh[-1].float(), w.float())
    got = calls["A_node_dots"](zero).float().reshape(sh.B, sh.NP, sh.O)
    torch.testing.assert_close(got, ref, atol=0.5, rtol=0.1)
    w_expanded = torch.einsum("nd,dio->nio", e.float(), pool.float().reshape(ki, sh.D, sh.O).permute(1, 0, 2))
    ref_b = torch.einsum("bni,nio->bno", hh[-1].float(), w_expanded)
    got_b = calls["B_factored_resident_pool"](zero).float().reshape(sh.B, sh.NP, sh.O)
    torch.testing.assert_close(got_b, ref_b, atol=1.0, rtol=0.15)


def cell_inputs(shapes, o, device, seed):
    """hh (B,K,N,H), e (N,D), pool (D,K,H,o) and dpre (B,N,o) in bf16 for one
    model cell, with the expanded weights (N,K,H,o) its einsum applies."""
    sh = shapes
    rng = np.random.default_rng(seed)

    def f16(*s):
        return (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16) * 0.1).to(device)

    hh, e = f16(sh.B, sh.K, sh.N, sh.H), f16(sh.N, sh.D)
    pool, dpre = f16(sh.D, sh.K, sh.H, o), f16(sh.B, sh.N, o)
    w = torch.einsum("nd,dkio->nkio", e.float(), pool.float()).to(torch.bfloat16)
    return hh, e, pool, dpre, w


def model_cells(shapes, device):
    """{cell: {name: call()}} of B1 and B1t at the model's gate and update
    cells, beside the einsums of the expanded weights; raises unless B1
    agrees with the f32 einsum of the same expansion (rtol 1e-3, atol 1e-3
    max|ref|: bf16 operands, only the rounding of the expanded weights and
    the summation order differ)."""
    cells = {}
    for seed, (cell, o) in enumerate((("gate", 2 * shapes.H), ("update", shapes.H))):
        hh, e, pool, dpre, w = cell_inputs(shapes, o, device, seed + 1)
        mat, mat_t = pool_to_kernel_layout(pool)
        got = node_factored_apply(hh, e, mat)
        ref = torch.einsum("bkni,nkio->bno", hh.float(), torch.einsum("nd,dkio->nkio", e.float(), pool.float()))
        torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3 * ref.abs().max().item())
        cells[cell] = {
            "B1_factored_apply": lambda hh=hh, e=e, mat=mat: node_factored_apply(hh, e, mat),
            "expanded_einsum": lambda hh=hh, w=w: torch.einsum("bkni,nkio->bno", hh, w),
            "B1t_factored_apply_t": lambda dpre=dpre, e=e, mat_t=mat_t: node_factored_apply_t(dpre, e, mat_t),
            "expanded_einsum_t": lambda dpre=dpre, w=w: torch.einsum("bno,nkio->bkni", dpre, w),
        }
    return cells


def _chain(call):
    def run():
        s = torch.zeros(1, 1, dtype=torch.float32, device="cuda")
        for _ in range(REPEAT):
            s = call(s).float().mean().reshape(1, 1) * 1e-6
        return s

    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="'cpu' for the numerics alone; default: the CUDA device")
    ap.add_argument("--small", action="store_true", help="reduced shapes (T=3, B=4, NP=64, KI=24, O=16, D=3)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    shapes = SMALL if args.small else FULL
    hh, w, e, pool = make_inputs(shapes, device)
    calls = variants(shapes, hh, w, e, pool)
    check_numerics(shapes, hh, w, e, pool, calls)
    cells = model_cells(shapes, device)
    print("numerics OK", flush=True)
    if device.type == "cpu":
        return None

    card = timing.card()
    results = {name: timing.event_ms(_chain(call), reps=5, flush=False) / REPEAT for name, call in calls.items()}
    print("node-apply harness, T={} B={} NP={} KI={} O={} D={}; {}".format(
        shapes.T, shapes.B, shapes.NP, shapes.K * shapes.H, shapes.O, shapes.D, card), flush=True)
    for name, ms in sorted(results.items(), key=lambda kv: kv[1]):
        print("  {:28s} {:9.3f} ms  ({:.1f} us/step)".format(name, ms, ms * 1e3 / shapes.T), flush=True)
    cell_ms = {cell: {name: timing.event_ms(fn, reps=20) for name, fn in fns.items()}
               for cell, fns in cells.items()}
    for cell, times in cell_ms.items():
        print("  {} cell (B={} K={} N={} I={} D={}), L2 flushed:".format(
            cell, shapes.B, shapes.K, shapes.N, shapes.H, shapes.D), flush=True)
        for name, ms in sorted(times.items(), key=lambda kv: kv[1]):
            print("    {:26s} {:9.3f} ms".format(name, ms), flush=True)
    record = {"card": card, "ms_per_call": results, "us_per_step": {k: v * 1e3 / shapes.T for k, v in results.items()},
              "model_cells_ms": cell_ms}
    print(json.dumps({"bench_node_dots": record}), flush=True)
    return record


if __name__ == "__main__":
    main()
