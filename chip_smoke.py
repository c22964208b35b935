#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, all at
once), holds each kernel against its plain PyTorch version at the shapes
the serving and training paths give it (and B2 and B2t at batch 256; both
on bf16 and on f32 activations, and on f16 at batch 16) and times both,
with faults planted inside B2's and B2t's kernels (the last k16 slice of
the contraction dropped, B2's batch columns past the first 8 zeroed) that
must fail the hold, then drives MultiATGCN's two paths at the DC-237
flagship width
(bench.py's arguments, the port's synthetic DC-237 dataset, random weights
from a seeded generator):
  * serving: MultiATGCN in the int8 weight-stream configuration, served by
    ``PredictService.from_experiment`` over HTTP at buckets 1, 4 and 16,
    plus one f32 request at bucket 16, and the int8 stream at f32
    activations (compute_dtype float32: B2's f32 form only) through
    ``PredictService`` at each bucket. The encoder states and model-space
    outputs of the int8, int8 f32, bf16 and f32 runs, and the int8 f32
    replies, are held against the same weights on the CPU, and faults
    planted in B2 (two in its wrapper, two inside its kernel) must fail
    those checks; the int8 f32 model's per-forward int8 weights are
    compared with the CPU's, level by level;
  * training: the int8 configuration trained through ``get_executor`` (3
    warm-up and 20 timed steps at batch 16, one validation pass), the same
    at f32 activations (B2's and B2t's f32 forms only), then a few f32 and
    bf16 steps, each with exact launch counts per step. One step's loss and
    every parameter gradient on the card are held against the CPU at the
    same weights and batch in int8, int8 f32, bf16 and f32, and faults
    planted in B2t (in its wrapper and inside its kernel), inside B2's
    kernel and in B3's backward must fail those checks. The validation
    passes replay a captured forward after one eager batch; their
    windows count the replays' launches (``StepGraph.replayed_launches``);
  * CUDA graphs (``graph_phase``, right after training): in int8, int8
    f32, bf16 and f32, 3 replays of the captured train step held bit for
    bit against 3 eager steps (mean loss, every parameter, Adam's state),
    the median of 10 replays, one replay's device time by kernel (its
    q8_kernel and strided_copy_kernel counts must be the eager counters'
    per step: 96 + 96 B2/B2t, 4 + 4 B3) beside one eager step's; in int8
    a graphed validation pass against an eager one, a graphed epoch
    against eager steps, and ``PredictService``'s bucket graphs (also at
    f32 activations) at buckets 1, 4 and 16 against eager replies, bit for
    bit, with their latency; then a ``profile_dir`` run whose trace must
    hold every replayed B2/B2t kernel of its epoch.
  * multi-seed training (``multiseed_phase``, right after the graphs):
    B2 and B2t at S*237 nodes (S = 2, 4, 8) and B3 at the f32 form's
    widened stacks against their plain versions, with B2/B2t's planted
    faults; the int8 form at 4 seeds (0, 10, 100, 1000) and the f32 form
    at 2 as one widened step, whose capture must launch exactly one
    seed's kernels (96 + 96 B2/B2t, 4 + 4 B3), each seed of 3 replays
    held against single-seed steps on the card from its slice of the
    state (``MS_BOUND``; a planted fault, half a seed's batch left out,
    must fail them), one seed's rate drop read by the same graph;
    ``train_multiseed`` for one epoch at the 4 int8 seeds on 6 batches,
    its train step, validation and predict captured with one seed's
    launches, each seed's saved checkpoint loaded into a single-seed
    executor whose validation loss and predictions hold the trainer's;
    replayed int8 steps at S = 1, 2, 4, 8 against S single-seed replays,
    the widened validation forward at each S launching 96 B2, and one S=4
    replay's device time; ``bench.py --multiseed 4
    --quant-stream`` at one timed epoch; and ``PredictService`` with
    ``quantize='int8'`` and ``'bfloat16'`` on the f32 model at buckets
    1, 4 and 16 (graph replays, JAX's 1% relative L1 against the
    unquantized service, the stored bytes, graphed against eager).
Then the sparse path, SparseATGCN at its defaults' full width on the
synthetic large graph of 49,152 nodes (4,946 tiles of 128x128):
  * the SpMM (B4/B6) and SDDMM (B5) kernels against their plain versions
    at every width the path gives them, timed, beside their bounds and a
    PyTorch library call each; B4/B6 on the model's segment schedules (the
    transposed graph's hub rows split over blocks: a line gives each
    transposed schedule's segments and longest segment), two calls
    bit-identical, and faults planted inside the f32 kernels of B4/B6 and
    B5 (a k16 slice dropped, a tile skipped, a row block zeroed; on B4/B6's
    transposed graph also a split row's last segment dropped) must fail
    the holds;
  * training through ``get_executor`` (2 warm-up and 10 timed steps at
    batch 2) with exact launch counts derived from the model and the
    step's device time by kernel name, one validation and one evaluation
    pass, and serving the saved experiment through ``from_experiment`` at
    buckets 1 and 2;
  * at 4,096 nodes, the model output and one step's loss and gradients on
    the card against the CPU, failed by faults planted in each kernel.
Then the band form of the same graph (graph_split 'band': diagonals -2..2,
1,914 tiles, hub columns):
  * the band kernels B7 (planes), B8 (packed rows), B9 dX and B9 dV against
    their plain versions at every width the path gives them, timed, beside
    their bounds and a torch.bmm library call each; three faults planted
    inside B9 dV's f32 kernel (a k16 slice dropped, the main diagonal
    skipped, the graph's last row block read as outside it) must fail the
    holds;
  * training on the planes through ``get_executor`` (2 warm-up and 10 timed
    steps) with exact launch counts, one validation and one evaluation
    pass, and the saved experiment served from packed rows
    (graph_band_packed) at buckets 1 and 2, launching B8 and no B7, its
    replies held against the planes';
  * at 4,096 nodes, output, loss and gradients on the card against the CPU
    in both storage forms, failed by faults planted in B7, B8 and B9 dX.
Then SparseATGCN in bf16 at 49,152 nodes with the adaptive view (the JAX
package's headline sparse configuration), on the BSR form and on the band's
planes:
  * B4/B6 (bsr_spmm) and B5 (sampled_matmul) in bf16 on the tensor cores
    against their plain versions at every width those paths give them
    (B4/B6 forward and on the transposed graph, f32 sums; B5 bf16 tiles
    within one bf16 step), timed beside their bounds and a library call
    each, each B4/B6 row naming how x came in (TMA, or at F = 12 one bulk
    copy a chunk); three faults planted inside each kernel (a k16 slice
    dropped, a tile skipped, a row block zeroed; B4/B6 on its transposed
    graph also a split row's last segment dropped) must fail the holds;
  * for each form, training through ``get_executor`` (2 warm-up and 5
    timed steps) with exact launch counts of the bf16 kernels, one
    validation pass, and the saved experiment served through
    ``from_experiment`` at buckets 1 and 2, with device busy time, idle
    share and peak memory; on the BSR form one bucket-1 request's
    bsr_spmm launches counted by width;
  * at 4,096 nodes, bf16 output, loss and gradients on the card against
    the CPU on the BSR, hub and tail forms (faults planted inside B4/B6 and
    B5 must fail the checks) and on the band's planes and packed rows with
    the adaptive view (faults in B7, B8 and B9 dX).
Then the same in f16 (compute_dtype 'float16'), on the same two forms:
  * B4/B6 and B5 in f16 (f32 sums; B5 writes f32 tiles for f16 operands,
    two calls bit-identical, timed beside the f32-out torch.bmm that
    computes its function and the f16-out one) and B7, B8, B9 dX and B9 dV
    in f16 on the 49,152-node band, against their plain versions at every
    width of the f16 paths (the f32 sums held as the bf16 forms' are; f16
    outputs within one f16 step, each row with its +-inf outputs and the
    nonzero sums it rounded to 0), timed beside their bounds and a library
    call each; the faults planted inside each kernel must fail the holds;
  * for each form, training (2 warm-up and 5 timed steps) with exact launch
    counts on the f16 counters (the SDDMM's dE1 and dE2 on the f32 B4/B6:
    their dS is f32), one step with the range of every f16 product watched
    and its loss and gradients held finite, one validation pass, and the
    saved experiment served at buckets 1 and 2 (the band form from packed
    rows: B8 in f16, no B7), with device busy time, idle share and peak
    memory;
  * at 4,096 nodes, f16 output, loss and gradients on the card against the
    CPU on the BSR, hub and tail forms (the tail run twice on the card: its
    sums in a fixed order, the runs bit for bit) and on the band's planes
    and packed rows, failed by the same planted faults.
The sparse phases' validation and evaluation passes and their services
replay captured forwards after one eager batch or request (CUDA graphs,
executor/graphs.py); their windows count the replays' launches. Then
SparseATGCN's steps as CUDA graphs at 49,152 nodes (``sparse_graph_phase``),
on the executors of the f32 BSR, bf16 BSR, bf16 band planes, f16 BSR and
f16 band planes phases and on a bf16 tail form built there:
  * 3 replays of the captured train step (``train_epoch``) against 3
    eager steps from the same state, bit for bit where 3 eager re-runs
    from that state agree bit for bit, else within 2x their largest gap
    (atomic sums), by loss, parameters and Adam's state; the captured
    launches equal to the eager per-step counts;
  * the median of 10 replays beside the eager steps, with one replay's and
    one eager step's device busy time and idle share;
  * a graphed validation pass on 4 batches and requests at buckets 1 and 2
    held against eager ones by the same rule, graphed and eager latency.
Then the node-apply design harness and the card's stream calibration:
  * B1 and B1t (the factored node apply and its transpose) at the
    flagship gate and update cells in f32 and bf16, B11 A (per-node dots),
    B (B1's kernel on rows) and D (the read floor) at the harness shapes,
    B10 (the column-sum read) over 256 MB at three block shapes and one
    point of B12's stream-rate sweep, each against its plain version,
    timed beside its bound and a library call (B1's and B1t's einsums with
    the order torch contracts them in and that order's FLOPs; the f32 rows
    bounded by the expanded order's operations, the bf16 ones by the
    factored order's, both given; B1 f32's two calls bit-identical); faults
    planted in B1 (the d = 0 term dropped; inside its f32 kernel d = 0
    dropped, the contraction's last 16-row chunk dropped and cluster rank
    0's partial dropped), B1t (a node block zeroed, and
    inside both its kernels d = 0 dropped and the contraction's last k16
    slice dropped), B11 A (the last 16-wide
    slice of the contraction dropped) and B11 B (the same, and e's last
    column zeroed) must fail the checks; B11 A and B's 24 steps must outlast
    their one step by the least time 23 steps take at the card's peaks, and
    a planted step-skip must fail that;
  * the port's bench_node_dots, bench_hbm_peak and bench_stream_rate run on
    the card with the launch counts from 0: each of those kernels must be
    launched in that window.
Then SparseATGCN in bf16 on the band form at 1,000,000 nodes (the JAX
package's 1M configuration, at T=12 and batch 2, no adaptive view):
  * B7, B8, B9 dX and B9 dV in bf16 (on the tensor cores) against their
    plain versions at every width the path gives them, within one bf16
    step, each row naming how x came in (TMA, one bulk copy a chunk or
    element loads), and the probe kernels window_dot (P1, P3) and
    band_slab (P2, per-row and batched) at the probe tool's shapes, each
    timed beside its bound and a
    library call (window_dot also beside an empty kernel's launch, and two
    of its calls bit-identical); three faults planted inside the bf16 band
    kernels (a k16 slice dropped, the main diagonal skipped, the graph's
    last row block read as outside it) at F = 12, 24 and 128, a wrong
    window start and a stale row block planted in the probes' outputs, one
    fault planted inside window_dot's kernel (the last slice's partial
    dropped) and two inside band_slab's (a k16 slice dropped, the window
    read one row block late) must fail the checks;
  * the port's probe_band_stream on the card, every probe launched and OK;
  * bench_large_graph's training (2 eager warm-up steps, then 5 timed
    replays of its captured step) with exact launch counts and finite
    losses, and its packed serving at buckets 1 and 2 (B8, no B7; replays
    of a captured call), the replies held against the planes'; each timed
    eagerly too, with the peak memory of both forms, and its replays held
    against 3 eager re-runs from one state by the sparse graphs' rule;
  * at 4,096 nodes, bf16 output, loss and gradients on the card against
    the CPU on planes and packed rows, failed by faults planted in B7, B8
    and B9 dX.
Last, the model zoo (zoo_phase, then zoo_check_phase), each of the 12 ported names (RNN,
LSTM, GRU, FNN, Seq2Seq, AGCRN, TGCN, STGCN, GWNET, DCRNN, ASTGCN, MSTGCN)
built at its defaults through load_config, TrafficStatePointDataset,
get_model and get_executor on the DC-237 series (24 in, 24 out, batch 16):
  * training steps replayed from a CUDA graph bit for bit against eager
    steps, validation likewise, an evaluation, PredictService's graphed
    replies at buckets 1 and 16 bit for bit against eager ones, with the
    eager and replayed ms per step, the request ms, one replay's device
    time and the peak memory, beside the card's name and power limit;
  * DCRNN's forced teacher-forcing ratios, 1 against teacher forcing and
    0 against the autoregressive forward, bit for bit;
  * the output, loss and gradients on the card against the CPU at seed 0's
    weights, and a swapped pair of GRU gates planted in the GRU's card run
    that must fail that hold;
  * no kernel of the port launches (the zoo runs torch ops only), so the
    kernels line has no zoo row.
ptxas may serialize the wgmma of a kernel (C7520, C7515): the run fails
where it does, but for the three kernels whose serialization is known and
queued (band_dv_tc_kernel, band_slab_tc_kernel,
node_factored_t_wgmma_kernel), which it only reports.
Every phase raises on failure; nothing is caught. The output ends with a
JSON line listing the kernels and a JSON line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the repository around it, it exits with
an error and prints no result.
"""

import collections
import concurrent.futures
import functools
import importlib
import itertools
import json
import math
import os
import re
import shutil
import statistics
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "outputs", "chip_smoke")
sys.path.insert(0, ROOT)

# H100 SXM data-sheet peaks (dense): HBM bandwidth and bf16 tensor cores
from multistgraph_tpu_torch.tools.timing import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S  # noqa: E402

PEAK_NOTE = "H100 SXM data sheet: 3.35 TB/s HBM, 989 TFLOP/s bf16 dense"

N, B, T, H, K = 237, 16, 24, 64, 5            # flagship DC-237 widths
NUM_LAYERS = 2
BUCKETS = (1, 4, B)                           # the batch buckets the main path serves
TIMING_REPS = 30
# At the initialiser's scale the node-conditioned weights put about 1% of the
# gate biases into the pre-activations, so a wrong B2 would move the states
# by under 1%. The smoke model's AGCN weight pools are drawn at this gain
# instead, which makes both the x- and h-side terms (B2's) comparable to
# the biases.
POOL_GAIN = 30.0
# End-to-end bounds on the relative max error (normalised by the reference's
# max |value|) of the encoder states and of the model-space output (before
# the scaler inverse and the group de-z-scoring), whichever is larger. Each
# is a few times its reading on an H100 and far below what a planted fault
# in B2 gives (see _fault_controls). Runs that round to bf16 (int8 and bf16)
# differ between the card and the CPU by more than f32 runs do: a last-bit
# difference in f32 can move a bf16 rounding by one step (2^-8 relative),
# which the recurrence carries on. The bf16 run on the card against the CPU,
# which launches no kernel of the port, shows the size of that effect.
BOUND_F32 = 1e-5               # f32 on the card vs on the CPU
BOUND_BF16 = 5e-3              # int8 or bf16 on the card vs on the CPU; int8 vs bf16

TRAIN_WARMUP, TRAIN_STEPS = 3, 20   # int8 training steps at batch B
MODE_STEPS = 3                      # timed f32 and bf16 training steps (after 1 warm-up)
LEARNING_RATE = 3e-3                # bench.py's fixed rate
LARGE_BATCH = 256                   # B2 and B2t at a batch the first B2 kernel refused
DESIGN_Q8 = ("tensor cores: wgmma m64n{}k16 bf16->f32 with the batch on N and 64 rows of {} a block; the int8 "
             "weights streamed once by TMA into an mbarrier ring and widened to bf16 in shared memory{}; "
             "persistent blocks")
GRAD_BATCH = 4                      # the gradient check's batch
# Gradient check, card vs CPU: the relative max error of every parameter
# gradient (max |card - CPU| over max |CPU|), the largest over the
# parameters, and of the loss. Each bound is a few times its reading on an
# H100 and far below what a fault planted in B2t or in B3's backward gives.
# The check model's AGCN pools are drawn at POOL_GAIN, as the serving
# check's: at the initialiser's scale the h-side weights are so small that
# zeroing B2t's output moves the gradients by little more than bf16
# rounding does (see PERF.md).
BOUND_GRAD_F32 = 3e-6
BOUND_GRAD_BF16 = 3e-2
# The int8 stream at f32 activations (compute_dtype float32) on the card
# against the CPU: its only rounding points are the int8 weights and B2t's
# bf16 cotangent, which a last f32 bit can move by a step. Read on an H100:
# model space 8.97e-5 at every bucket, gradients 2.2e-5; each bound is
# 3.3x and 4.5x that, far below the int8 bounds and what planted faults
# give (1.4e-2 and 4.7e-2 at least). The model-space gap is int8 levels
# flipped by one step (50 of 29.1M per forward, _quant_agreement): run
# with the CPU's (wq, scale), the card reads 9.4e-7 of the CPU.
BOUND_INT8_F32 = 3e-4
BOUND_GRAD_INT8_F32 = 1e-4


# kernels whose wgmma ptxas is known to serialize, queued for a redesign:
# their line is reported; any other kernel's fails the run (the tensor-core
# kernels of B4/B6, B5 and B7-B9 dX run every wgmma unconditionally)
SERIALIZED_WGMMA_QUEUED = ("band_dv_tc_kernel", "band_slab_tc_kernel", "node_factored_t_wgmma_kernel")


def say(msg):
    print(msg, flush=True)


def _bound_ms(num_bytes, flops, peak_flops=PEAK_BF16_FLOPS):
    t_bytes = num_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(torch, fn, reps=TIMING_REPS):
    """Median device time of one call (CUDA events), L2 flushed before each."""
    from multistgraph_tpu_torch.tools.timing import event_ms

    return event_ms(fn, reps=reps)


def _ptxas_summary(report):
    """One line from nvcc's -Xptxas -v report: kernels, most registers, spill bytes."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", report))
    return "{} kernel(s), at most {} registers, {} bytes of spills".format(
        len(regs), max(regs, default=0), spills)


def _ptxas_kernels(report, marker):
    """[kernel, registers, spill bytes] from nvcc's -Xptxas -v report for
    each entry function whose mangled name holds `marker`."""
    rows = []
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if marker in name:
            regs = re.search(r"Used (\d+) registers", block)
            spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", block))
            short = re.search(r"[a-z_]*" + re.escape(marker) + r"\w{0,16}", name).group(0)
            rows.append([short, int(regs.group(1)) if regs else None, spills])
    return rows


def _over_bound(got, want, rel=1e-5, bf16_step=False, step=None, sums_rel=0.0):
    """The largest |got - want| over its elementwise bound (inf where the
    shapes or dtypes differ). By default rtol rel with atol rel*max|want|:
    the same products summed in another order. bf16_step: one bf16 step,
    2^-7 |want| + 2^-7 * 1e-3 max|want| (8 significant bits, with a floor
    for sums that cancel); step: the same with another step (2^-10 for
    f16's 11 bits), plus sums_rel (|want| + max|want|) for the f32 sums
    before the rounding where their own rule shows at that step."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    got, want = got.float(), want.float()
    step = 2.0 ** -7 if bf16_step else step
    if step is not None:
        bound = step * (want.abs() + 1e-3 * want.abs().max()) + sums_rel * (want.abs() + want.abs().max())
    else:
        bound = rel * (want.abs() + want.abs().max())
    diff = (got - want).abs()
    # 0 where equal, so a zero bound divides nothing; a NaN stays a NaN
    return (diff / bound).masked_fill(diff == 0, 0.0).max().item()


def _hold(ratio, what):
    if not ratio <= 1.0:
        raise AssertionError("{}: {:.3g} of its bound".format(what, ratio))


def _q8_faults(node_apply, fn, name, args, want, batch, step=None):
    """Each fault planted inside B2's or B2t's kernel that reaches `batch`,
    over the bound of the check the unfaulted kernel passes."""
    faults = {}
    for kind, (target, code) in sorted(node_apply.Q8_FAULTS.items()):
        if target != name or (code == 2 and batch <= 8):   # no columns past the first 8
            continue
        with node_apply.planted_q8_fault(kind):
            bad = fn(*args)
        faults[kind] = _over_bound(bad, want, step=step)
    return faults


# B2's and B2t's activation dtypes: (suffix of the rows' and counters' names,
# bf16 pieces B2 splits the activation into, the batches its rows run at);
# f32 runs on the main path (the int8 stream at compute_dtype float32),
# f16 at the training batch only, off the path
Q8_FORMS = {"bfloat16": ("", 1, BUCKETS + (LARGE_BATCH,)), "float32": ("_f32", 3, BUCKETS + (LARGE_BATCH,)),
            "float16": ("_f16", 2, (B,))}
# one step of each result dtype B2t writes, for its hold (None: the f32 rule)
Q8_STEPS = {"bfloat16": 2.0 ** -7, "float32": None, "float16": 2.0 ** -10}


def _q8_rows(torch, node_apply, g, dtype_name, nodes=N, batches=None, on_path=None, label=""):
    """B2's and B2t's rows for activations of one dtype (at `nodes` nodes
    and `batches`, by default the main path's; `on_path` overrides which
    rows the main path runs, `label` heads their shapes), each held against
    its plain version (B2's f32 sums and B2t's f32 results at rtol 1e-5
    with atol 1e-5 max|plain|, B2t's bf16 and f16 results within one step)
    and timed beside its bound and library call; and the faults planted
    inside the kernels, each over the bound of that hold."""
    from multistgraph_tpu_torch.ops.node_apply import (
        _pad_nodes, node_apply_q8, node_apply_q8_plain, node_apply_q8_t, node_apply_q8_t_plain,
        quantize_node_weights)

    dtype = getattr(torch, dtype_name)
    suffix, pieces, form_batches = Q8_FORMS[dtype_name]
    batches = batches or form_batches
    size = dtype.itemsize
    dev = torch.device("cuda")
    lines, faults = [], {}
    ki = K * H
    n_pad = -(-nodes // 32) * 32
    split = {1: "", 3: ", hh split on chip into three bf16 pieces (hi, mid, lo: exact), one product each",
             2: ", hh split on chip into two bf16 pieces (exact), one product each"}[pieces]
    # the int8 requests of the main path launch B2 at buckets 1, 4 and 16,
    # int8 training at 16; batch 256 shows that any batch runs
    for b, (cell, o) in itertools.product(batches, (("gate", 2 * H), ("update", H))):
        hh = torch.randn(nodes, b, ki, generator=g, device=dev).to(dtype)
        w = torch.randn(nodes, ki, o, generator=g, device=dev) * 0.1
        wq, s = quantize_node_weights(w.to(torch.bfloat16))
        wq, s = _pad_nodes(wq, 0, n_pad), _pad_nodes(s, 0, n_pad)
        got = node_apply_q8(hh, wq, s)
        want = node_apply_q8_plain(hh, wq, s)
        torch.cuda.synchronize()
        # the same exact products in f32; only the summation order differs
        _hold(_over_bound(got, want), "node_apply_q8{} vs its plain version on {}".format(suffix, cell))
        if dtype == torch.bfloat16:
            w_deq = (wq[:nodes].float() * s[:nodes]).to(torch.bfloat16)
            library, call = "torch.bmm on pre-dequantized bf16 weights", lambda: torch.bmm(hh, w_deq)
        else:
            # f32 (TF32 off) on the weights widened ahead of time, times the scale
            w32, hh32 = wq[:nodes].float(), hh.float()
            library = "torch.bmm of the {} activations against the int8 weights pre-widened to f32, times the " \
                      "scale (TF32 off)".format("f32" if dtype == torch.float32 else "f16 (pre-widened)")
            call = lambda: torch.bmm(hh32, w32).mul_(s[:nodes])  # noqa: E731
        num_bytes = nodes * b * ki * size + nodes * ki * o + nodes * o * 4 + nodes * b * o * 4
        bound, by = _bound_ms(num_bytes, pieces * 2 * nodes * b * ki * o)
        lines.append({
            "name": "node_apply_q8" + suffix, "shape": "{}{} N={} B={} KI={} O={}".format(label, cell, nodes, b, ki, o),
            "replaces": "multistgraph_tpu/ops/node_apply.py:238 node_apply_q8",
            "max_abs_err": (got - want).abs().max().item(), "tolerance": "rtol 1e-5, atol 1e-5*max|plain|",
            "kernel_ms": _time_ms(torch, lambda: node_apply_q8(hh, wq, s)),
            "plain_ms": _time_ms(torch, lambda: node_apply_q8_plain(hh, wq, s)),
            "library_ms": _time_ms(torch, call), "library": library,
            "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "peak": PEAK_NOTE,
            "bound_ops": "{} x 2NBKO at the bf16 tensor-core peak".format(pieces) if pieces > 1 else "2NBKO",
            "main_path": (b in BUCKETS and dtype != torch.float16) if on_path is None else on_path,
            "design": DESIGN_Q8.format(node_apply.q8_batch_tile(b, dtype), "O", split),
            "loads": node_apply.q8_load_path(ki, o, dtype=dtype),
        })
        for kind, ratio in _q8_faults(node_apply, node_apply_q8, "node_apply_q8", (hh, wq, s), want, b).items():
            faults["{} planted in the kernel, {} {} B={}".format(kind, dtype_name, cell, b)] = ratio
    # the int8 reverse scan launches B2t at the training batch, gate and
    # update; batch 256 shows that any batch runs
    for bt, (cell, o) in itertools.product([b for b in batches if b >= B], (("gate", 2 * H), ("update", H))):
        dpre = torch.randn(nodes, bt, o, generator=g, device=dev).to(dtype)
        w = torch.randn(nodes, ki, o, generator=g, device=dev) * 0.1
        wq, s = quantize_node_weights(w.to(torch.bfloat16))
        wq, s = _pad_nodes(wq, 0, n_pad), _pad_nodes(s, 0, n_pad)
        got = node_apply_q8_t(dpre, wq, s)
        want = node_apply_q8_t_plain(dpre, wq, s)
        torch.cuda.synchronize()
        # the same rounded products in f32; only the summation order
        # differs, which can move a final bf16 or f16 rounding by one step
        step = Q8_STEPS[dtype_name]
        _hold(_over_bound(got, want, step=step), "node_apply_q8_t{} vs its plain version on {}".format(suffix, cell))
        d_lib = (dpre.float() * s[:nodes]).to(torch.bfloat16)
        # the scale lies on the cotangent, so the library call takes the int8
        # weights widened (exact), transposed ahead of time
        if dtype == torch.bfloat16:
            w_t = wq[:nodes].to(torch.bfloat16).transpose(1, 2).contiguous()
            library = "torch.bmm of the scaled bf16 cotangent with the int8 weights pre-widened to bf16, transposed"
        else:
            w_t, d_lib = wq[:nodes].float().transpose(1, 2).contiguous(), d_lib.float()
            library = "torch.bmm of the scaled cotangent rounded to bf16 and widened, with the int8 weights " \
                      "pre-widened to f32, transposed (TF32 off)"
        num_bytes = nodes * bt * o * size + nodes * ki * o + nodes * o * 4 + nodes * bt * ki * size
        bound, by = _bound_ms(num_bytes, 2 * nodes * bt * ki * o)
        lines.append({
            "name": "node_apply_q8_t" + suffix, "shape": "{}{} N={} B={} KI={} O={}".format(label, cell, nodes, bt, ki, o),
            "replaces": "multistgraph_tpu/ops/node_apply.py:267 node_apply_q8_t",
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "tolerance": "rtol 1e-5, atol 1e-5*max|plain|" if step is None else
                         "one {} step: {} |plain| + {} * 1e-3 max|plain|".format(dtype_name, step, step),
            "kernel_ms": _time_ms(torch, lambda: node_apply_q8_t(dpre, wq, s)),
            "plain_ms": _time_ms(torch, lambda: node_apply_q8_t_plain(dpre, wq, s)),
            "library_ms": _time_ms(torch, lambda: torch.bmm(d_lib, w_t)), "library": library,
            "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "peak": PEAK_NOTE,
            "main_path": (bt == B and dtype != torch.float16) if on_path is None else on_path,
            "design": DESIGN_Q8.format(node_apply.q8_batch_tile(bt, dtype), "KI",
                                       ", the cotangent scaled and rounded to bf16 there"),
            "loads": node_apply.q8_load_path(ki, o, transposed=True, dtype=dtype),
        })
        for kind, ratio in _q8_faults(node_apply, node_apply_q8_t, "node_apply_q8_t", (dpre, wq, s), want,
                                      bt, step=step).items():
            faults["{} planted in the kernel, {} {} B={}".format(kind, dtype_name, cell, bt)] = ratio
    return lines, faults


def kernel_phase(torch):
    """Each kernel vs its plain version at the main path's shapes, timed;
    the faults planted inside B2's and B2t's kernels."""
    from multistgraph_tpu_torch.ops import node_apply
    from multistgraph_tpu_torch.ops.layout import (
        _ForceDefaultLayout, force_default_layout, force_default_layout_plain)

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    lines = []
    faults = {}
    for dtype_name in Q8_FORMS:
        rows, form_faults = _q8_rows(torch, node_apply, g, dtype_name)
        lines += rows
        faults.update(form_faults)
    # each f32 and f16 form's time over its bf16 form's at the same shape
    bf16_ms = {(r["name"], r["shape"]): r["kernel_ms"] for r in lines}
    say(json.dumps({"B2/B2t over their bf16 forms (kernel ms ratio)": {
        "{} {}".format(r["name"], r["shape"]): r["kernel_ms"] / bf16_ms[(r["name"][:-4], r["shape"])]
        for r in lines if r["name"].endswith(("_f32", "_f16"))}}))
    for fault, ratio in faults.items():
        if not ratio > 1.0:
            raise AssertionError("{} passes its check ({:.3g} of the bound)".format(fault, ratio))
    # the int8 path quantizes each layer's h-side weights (gate and update)
    # in every forward, beside its 2 T launches each of B2
    from multistgraph_tpu_torch.models.multi_atgcn import _quantize_h_weights

    wg_h = torch.randn(N, K, H, 2 * H, generator=g, device=dev)
    wu_h = torch.randn(N, K, H, H, generator=g, device=dev)
    say(json.dumps({"int8 h-side weight quantization, one layer": {
        "ms": _time_ms(torch, lambda: _quantize_h_weights(wg_h, wu_h)),
        "shapes": "gate (N={}, K={}, I={}, O={}) and update (O={}) f32".format(N, K, H, 2 * H, H)}}))
    xw = torch.randn(T, B, N, 3 * H, generator=g, device=dev)
    for cell, view in (("gate_x", xw[..., : 2 * H]), ("upd_x", xw[..., 2 * H:])):
        got = force_default_layout(view)
        want = force_default_layout_plain(view)
        torch.cuda.synchronize()
        if not (got.is_contiguous() and torch.equal(got, want)):
            raise AssertionError("layout_copy differs from its plain version on " + cell)
        num_bytes = 2 * view.numel() * view.element_size()
        bound, by = _bound_ms(num_bytes, 0)
        lines.append({
            "name": "force_default_layout", "shape": "{} {} f32 view of (...,{})".format(
                cell, tuple(view.shape), 3 * H),
            "replaces": "multistgraph_tpu/ops/layout.py:40 _launder/force_default_layout",
            "max_abs_err": (got - want).abs().max().item(), "tolerance": "bit-identical",
            "kernel_ms": _time_ms(torch, lambda: force_default_layout(view)),
            "plain_ms": _time_ms(torch, lambda: force_default_layout_plain(view)),
            "library_ms": _time_ms(torch, lambda: view.contiguous()),
            "library": "x.contiguous()",
            "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "peak": PEAK_NOTE,
            "main_path": True,
        })
    # the f32 backward copies the reverse scan's cotangents of gate_x/upd_x,
    # dense (T,B,N,2H) and (T,B,N,H) stacks
    for cell, width in (("d gate_x", 2 * H), ("d upd_x", H)):
        cot = torch.randn(T, B, N, width, generator=g, device=dev)
        got = _ForceDefaultLayout.backward(None, cot)
        want = force_default_layout_plain(cot)
        torch.cuda.synchronize()
        if not (got.is_contiguous() and got.data_ptr() != cot.data_ptr() and torch.equal(got, want)):
            raise AssertionError("layout_copy backward differs from its plain version on " + cell)
        num_bytes = 2 * cot.numel() * cot.element_size()
        bound, by = _bound_ms(num_bytes, 0)
        lines.append({
            "name": "force_default_layout_bwd", "shape": "{} {} f32 cotangent".format(cell, tuple(cot.shape)),
            "replaces": "multistgraph_tpu/ops/layout.py:40 _launder via force_default_layout's VJP (:60-61)",
            "max_abs_err": (got - want).abs().max().item(), "tolerance": "bit-identical",
            "kernel_ms": _time_ms(torch, lambda: _ForceDefaultLayout.backward(None, cot)),
            "plain_ms": _time_ms(torch, lambda: force_default_layout_plain(cot)),
            # x.contiguous() returns a contiguous cotangent itself; clone copies
            "library_ms": _time_ms(torch, lambda: cot.clone()),
            "library": "x.clone() (x.contiguous() copies nothing for a dense cotangent)",
            "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "peak": PEAK_NOTE,
            "main_path": True,
        })
    for line in lines:
        say(json.dumps(line))
    say(json.dumps({"B2/B2t planted_faults_over_bound": faults}))
    return lines


def _serving_args(raw_dir):
    """bench.py's DC-237 configuration plus the int8 weight stream."""
    return {
        "data_dir": raw_dir,
        "cache_dir": os.path.join(WORK, "dataset_cache"),
        "output_dir": os.path.join(WORK, "outputs"),
        "exp_id": "chip_smoke", "cache_dataset": False,
        "input_window": T, "output_window": T,
        "len_closeness": 2, "len_period": 1, "len_trend": 1,
        "interval_period": 7, "interval_trend": 28,
        "load_external": True, "load_dynamic": False, "add_time_in_day": True,
        "groupstd": True, "add_static": True,
        "adjtype": "multi", "adpadj": "bidirection",
        "rnn_units": H, "num_layers": NUM_LAYERS, "embed_dim_node": 20,
        "batch_size": B, "train_rate": 0.7, "eval_rate": 0.15, "seed": 0,
        "compute_dtype": "bfloat16", "weight_stream_quant": "int8",
    }


def _post(url, x):
    body = json.dumps({"x": x.tolist()}).encode()
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        reply = json.loads(r.read())
    import numpy as np

    return np.asarray(reply["prediction"], np.float32)


def _rel_err(a, b):
    import numpy as np

    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _model_out(torch, service, x):
    """The model's encoder states (B, T, N, H) and its output in model space
    (before the scaler inverse, the group de-z-scoring and the clip). At
    random weights the output varies little with the input, so a wrong B2
    shows far more in the states, on which it acts."""
    from unittest import mock

    model = service.model
    encoder = model._encoder
    states = []

    def spy(*args):
        states.append(encoder(*args))
        return states[-1]

    with torch.no_grad(), mock.patch.object(model, "_encoder", spy):
        y = model(torch.tensor(x, device=service.device))
    return {"states": states[0].float().cpu().numpy(), "output": y.float().cpu().numpy()}


def _errs(a, b):
    """Relative max error of the states and of the output, and the larger."""
    e = {k: _rel_err(a[k], b[k]) for k in ("states", "output")}
    return dict(e, max=max(e.values()))


def _fault_controls(torch, service, x_all, refs):
    """Show that the end-to-end checks fail a wrong B2: plant a fault in the
    model's B2 calls (in the wrapper, or inside the kernel), rerun the int8
    model of `service` on the card at every bucket the fault reaches (the
    batch columns past the first 8: bucket 16), and return, for each fault,
    the smallest error over those buckets against each of `refs` ({check:
    outputs by bucket})."""
    from unittest import mock

    from multistgraph_tpu_torch.models import multi_atgcn
    from multistgraph_tpu_torch.ops import node_apply
    from multistgraph_tpu_torch.ops.node_apply import node_apply_q8

    faults = {
        "B2 scale dropped": (mock.patch.object(
            multi_atgcn, "node_apply_q8", lambda hh, wq, s: node_apply_q8(hh, wq, s) / s[: hh.shape[0]]), BUCKETS),
        "B2 output zeroed": (mock.patch.object(
            multi_atgcn, "node_apply_q8", lambda hh, wq, s: torch.zeros_like(node_apply_q8(hh, wq, s))), BUCKETS),
        "B2 k16 planted in the kernel": (node_apply.planted_q8_fault("B2 k16"), BUCKETS),
        "B2 columns planted in the kernel": (node_apply.planted_q8_fault("B2 columns"), (B,)),
    }
    errs = {}
    for name, (patch, buckets) in faults.items():
        with patch:
            ys = {b: _model_out(torch, service, x_all[:b]) for b in buckets}
        errs[name] = {check: min(_errs(ys[b], ref[b])["max"] for b in buckets) for check, ref in refs.items()}
    return errs


def _bucket_ms(service, x, reps=20):
    service.predict(x)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        service.predict(x)  # returns host numpy: the device work is done
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _device_time(torch, fn, wall_ms, by_kernel=False):
    """Device time of one call of `fn` by kernel (torch.profiler), against
    its unprofiled wall time; with by_kernel, every kernel's count and time
    by name (PERF.md's breakdowns), not only the top 8."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernels and copies only: a CPU op's self device time repeats its kernels'
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if rows else "not measured",
        "device_idle_share": 1.0 - busy_ms / wall_ms if rows else "not measured",
        # the same against the profiled call's own wall time (the profiler's overhead included)
        "profiled_wall_ms": profiled_ms,
        "profiled_idle_share": 1.0 - busy_ms / profiled_ms if rows else "not measured",
        "device_ops": sum(r[1] for r in rows),
        "top": [{"name": k[:70], "count": c, "ms": ms} for ms, c, k in rows[:8]],
        # B2 and B2t (csrc/node_apply_q8.cuh), wherever they rank
        "q8_kernels": {"count": sum(c for _, c, k in rows if "q8_kernel" in k),
                       "ms": sum(ms for ms, _, k in rows if "q8_kernel" in k)},
        **({"by_kernel": [{"name": k[:90], "count": c, "ms": ms} for ms, c, k in rows]} if by_kernel else {}),
    }


def _device_share(torch, service, x, wall_ms):
    """Device time of one request by kernel, against its wall time."""
    return dict(bucket=service._bucket(len(x)), **_device_time(torch, lambda: service.predict(x), wall_ms))


def make_dataset():
    """The port's synthetic DC-237 dataset (bench.py's: 237 nodes, 151 days
    hourly, seed 42) under WORK, read by the training and serving phases."""
    from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset

    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.time()
    make_synthetic_dataset(os.path.join(WORK, "raw_data"), "SYN_DC237", num_nodes=N,
                           len_time=24 * 151, node_mean=30.169, node_std=84.023, seed=42)
    say("dataset written in {:.1f}s".format(time.time() - t0))


def _quant_agreement(torch, card, cpu, x, cpu_out):
    """The per-forward int8 weights (wq, scale) of `card`'s model against
    `cpu`'s on batch x: for each layer, the int8 levels that differ and the
    largest difference, the scales' and the unquantised weights' largest
    relative difference; and the card's model space run again with the
    CPU's (wq, scale), against `cpu_out` (the CPU's model space on x). Where
    the levels differ by one step at most and the second run agrees with
    the CPU at the f32 bound, the int8 model's card-vs-CPU gap is the
    quantisation's rounding of a last f32 bit, not the kernels'."""
    from unittest import mock

    from multistgraph_tpu_torch.models import multi_atgcn

    real = multi_atgcn._quantize_h_weights
    seen = {"card": [], "cpu": []}

    def recording(store):
        def fn(wg_h, wu_h, *args, **kwargs):
            q = real(wg_h, wu_h, *args, **kwargs)
            store.append(((wg_h, wu_h), q))
            return q
        return fn

    for name, svc in (("card", card), ("cpu", cpu)):
        with mock.patch.object(multi_atgcn, "_quantize_h_weights", recording(seen[name])):
            _model_out(torch, svc, x)
    layers = []
    for (w_card, q_card), (w_cpu, q_cpu) in zip(seen["card"], seen["cpu"]):
        for half, (wi, qi) in enumerate(((0, 0), (1, 2))):   # gate: wg_h, (wgq, wgs); update: wu_h, (wuq, wus)
            w_a, w_b = w_card[wi].float().cpu(), w_cpu[wi].float()
            n = w_b.shape[:-3].numel()   # the nodes; the rows past them pad to a block
            wq_card, wq_cpu = q_card[qi][:n].cpu().int(), q_cpu[qi][:n].int()
            s_card, s_cpu = q_card[qi + 1][:n].cpu(), q_cpu[qi + 1][:n]
            layers.append({"layer": len(layers) // 2, "half": ("gate", "update")[half],
                           "levels": wq_cpu.numel(), "levels_differ": int((wq_card != wq_cpu).sum()),
                           "max_level_diff": int((wq_card - wq_cpu).abs().max()),
                           "scale_max_rel_diff": float(((s_card - s_cpu).abs() / s_cpu.abs().clamp_min(1e-30)).max()),
                           "weights_max_rel_diff": float((w_a - w_b).abs().max() / w_b.abs().max())})
    feed = iter([tuple(t.to(card.device) for t in q) for _, q in seen["cpu"]])
    with mock.patch.object(multi_atgcn, "_quantize_h_weights", lambda *args, **kwargs: next(feed)):
        swapped = _model_out(torch, card, x)
    return {"layers": layers, "card with the CPU's (wq, scale) vs CPU": _errs(swapped, cpu_out)}


def serving_phase(torch):
    import numpy as np

    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.models import get_model
    from multistgraph_tpu_torch.ops.layout import force_default_layout
    from multistgraph_tpu_torch.ops.node_apply import node_apply_q8
    from multistgraph_tpu_torch.serving import PredictService, make_server

    args = _serving_args(os.path.join(WORK, "raw_data"))
    task, model_name, ds_name = "traffic_state_pred", "MultiATGCN", "SYN_DC237"
    config = load_config(task, model_name, ds_name, other_args=args)
    t0 = time.time()
    dataset = get_dataset(config)
    _, _, test_loader = dataset.get_data()
    feature = dataset.get_data_feature()
    say("dataset read in {:.1f}s: test x {}".format(time.time() - t0, tuple(test_loader.x.shape)))
    model = get_model(config, feature, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weights_pool"):
                p.mul_(POOL_GAIN)
    state_dict = {k: v.cpu() for k, v in model.state_dict().items()}
    cache = os.path.join(args["output_dir"], "chip_smoke", "model_cache",
                         "{}_{}.pt".format(model_name, ds_name))
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    torch.save((state_dict, {}), cache)

    t0 = time.time()
    service = PredictService.from_experiment(task, model_name, ds_name, other_args=args, max_batch=B)
    say("from_experiment in {:.1f}s".format(time.time() - t0))
    if not service.model.uses_int8_stream:
        raise AssertionError("the served model does not take the int8 weight-stream path")
    x_all = test_loader.x[:B].cpu().numpy()

    def variant(device=None, **overrides):
        cfg = load_config(task, model_name, ds_name, other_args=dict(args, **overrides))
        m = get_model(cfg, feature, device=device)
        m.load_state_dict(state_dict)
        return PredictService(m, feature["scaler"], max_batch=B,
                              ct_visit_mstd=feature["ct_visit_mstd"], device=device)

    f32_service = variant(compute_dtype=None, weight_stream_quant=None)
    bf16_service = variant(weight_stream_quant=None)
    # the int8 stream at f32 activations (B2's f32 form)
    int8_f32_service = variant(compute_dtype="float32")
    if not int8_f32_service.model.uses_int8_stream:
        raise AssertionError("the int8 f32 model does not take the int8 weight-stream path")

    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://{}:{}/predict".format(*server.server_address)
        # ---- the main path: counts from 0, three int8 requests (buckets 1,
        # 4, 16), one f32 request (bucket 16)
        node_apply_q8.launches = 0
        force_default_layout.launches = 0
        replies = {}
        for batch in (1, 3, B):
            replies[batch] = _post(url, x_all[:batch])
        int8_counts = (node_apply_q8.launches, force_default_layout.launches)
        y_f32 = f32_service.predict(x_all)
        launches = {"node_apply_q8": node_apply_q8.launches,
                    "force_default_layout": force_default_layout.launches}
        # ----
        per_forward = 2 * T * NUM_LAYERS
        if int8_counts != (3 * per_forward, 0):
            raise AssertionError("int8 requests launched (B2, B3) = {}, want ({}, 0)".format(
                int8_counts, 3 * per_forward))
        if launches != {"node_apply_q8": 3 * per_forward, "force_default_layout": 2 * NUM_LAYERS}:
            raise AssertionError("f32 request launched {}".format(launches))
        say("launches on the main path: {} (B2 {} per int8 forward, B3 {} per f32 forward)".format(
            launches, per_forward, 2 * NUM_LAYERS))

        for batch, y in replies.items():
            if y.shape != (batch, T, N, 1) or not np.isfinite(y).all() or (y < 0).any():
                raise AssertionError("bad reply for batch {}: shape {}".format(batch, y.shape))
            np.testing.assert_allclose(y, service.predict(x_all[:batch]), rtol=1e-5, atol=1e-4)
        if y_f32.shape != (B, T, N, 1) or not np.isfinite(y_f32).all() or (y_f32 < 0).any():
            raise AssertionError("bad f32 reply")
        np.testing.assert_allclose(y_f32, f32_service.predict(x_all), rtol=1e-5, atol=1e-4)
        health = json.loads(urllib.request.urlopen(url.replace("/predict", "/health"), timeout=60).read())
        say("health: " + json.dumps(health))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    # ---- the int8 stream at f32 activations: counts from 0, one request at
    # each bucket, B2's f32 form only
    _reset_counts()
    f32_replies = {batch: int8_f32_service.predict(x_all[:batch]) for batch in (1, 3, B)}
    f32_window = _read_counts()
    want = dict(dict.fromkeys(f32_window, 0), node_apply_q8_f32=3 * per_forward)
    if f32_window != want:
        raise AssertionError("int8 f32 requests launched {}, want {}".format(
            {k: v for k, v in f32_window.items() if v}, {k: v for k, v in want.items() if v}))
    for batch, y in f32_replies.items():
        if y.shape != (batch, T, N, 1) or not np.isfinite(y).all() or (y < 0).any():
            raise AssertionError("bad int8 f32 reply for batch {}: shape {}".format(batch, y.shape))
    say("launches of the int8 f32 requests: {}".format({k: v for k, v in f32_window.items() if v}))

    # ---- request latency per bucket, before any work on the host's CPU
    # threads (the CPU runs below) can compete with the launching thread
    latency = {}
    for name, svc in (("int8", service), ("bf16", bf16_service), ("f32", f32_service),
                      ("int8 f32", int8_f32_service)):
        latency[name] = {str(svc._bucket(batch)): _bucket_ms(svc, x_all[:batch], GRAPH_TIMED) for batch in (1, 3, B)}
    say(json.dumps({"ms_per_request_by_bucket": latency}))
    for name, svc in (("int8", service), ("f32", f32_service), ("int8 f32", int8_f32_service)):
        share = _device_share(torch, svc, x_all[:B], latency[name][str(B)])
        say(json.dumps({"device_time_per_request": name, **share}))

    # ---- correctness in model space at every bucket, against the same
    # weights on the CPU (plain versions of the kernels) and in bf16
    int8_f32_cpu = variant("cpu", compute_dtype="float32")
    out = {name: {b: _model_out(torch, svc, x_all[:b]) for b in BUCKETS}
           for name, svc in (("int8", service), ("bf16", bf16_service), ("f32", f32_service),
                             ("int8 f32", int8_f32_service),
                             ("int8 CPU", variant("cpu")),
                             ("bf16 CPU", variant("cpu", weight_stream_quant=None)),
                             ("f32 CPU", variant("cpu", compute_dtype=None, weight_stream_quant=None)),
                             ("int8 f32 CPU", int8_f32_cpu))}
    pairs = {"int8 card vs CPU": ("int8", "int8 CPU", BOUND_BF16),
             "bf16 card vs CPU": ("bf16", "bf16 CPU", BOUND_BF16),
             "f32 card vs CPU": ("f32", "f32 CPU", BOUND_F32),
             "int8 f32 card vs CPU": ("int8 f32", "int8 f32 CPU", BOUND_INT8_F32),
             "int8 vs bf16": ("int8", "bf16", BOUND_BF16),
             "int8 vs f32": ("int8", "f32", None),
             "int8 f32 vs f32": ("int8 f32", "f32", None)}
    errs = {check: {str(b): _errs(out[a][b], out[ref][b]) for b in BUCKETS}
            for check, (a, ref, _) in pairs.items()}
    # the int8 f32 replies against the CPU's replies to the same batches
    # (both de-scaled and clipped), at the model-space bound
    reply_errs = {str(batch): _rel_err(y, int8_f32_cpu.predict(x_all[:batch])) for batch, y in f32_replies.items()}
    say(json.dumps({"int8 f32 replies card vs CPU rel err": reply_errs, "bound": BOUND_INT8_F32}))
    if not max(reply_errs.values()) < BOUND_INT8_F32:
        raise AssertionError("int8 f32 replies: rel max err {} over the bound {}".format(reply_errs, BOUND_INT8_F32))
    say(json.dumps({"int8 f32 quantised weights card vs CPU": _quant_agreement(
        torch, int8_f32_service, int8_f32_cpu, x_all[:B], out["int8 f32 CPU"][B])}))
    controls = _fault_controls(torch, service, x_all, {"int8 card vs CPU": out["int8 CPU"],
                                                       "int8 vs bf16": out["bf16"]})
    controls.update({"int8 f32: " + name: e for name, e in _fault_controls(
        torch, int8_f32_service, x_all, {"int8 f32 card vs CPU": out["int8 f32 CPU"]}).items()})
    say(json.dumps({"model_space_rel_err": errs, "bounds": {c: p[2] for c, p in pairs.items()},
                    "planted_faults_min_rel_err": controls}))
    for check, (_, _, bound) in pairs.items():
        if bound is not None and not max(e["max"] for e in errs[check].values()) < bound:
            raise AssertionError("{}: rel max err {} over the bound {}".format(check, errs[check], bound))
    for fault, fault_errs in controls.items():
        for check, err in fault_errs.items():
            if not err > pairs[check][2]:
                raise AssertionError("{} passes the check {} ({:.3e})".format(fault, check, err))
    return launches, f32_window


# ------------------------------------------------------------------ training

_MODES = {  # config overrides of the int8 serving/training arguments
    "int8": {},
    "int8 f32": {"compute_dtype": "float32"},   # the int8 stream at f32 activations
    "bf16": {"weight_stream_quant": None},
    "f32": {"compute_dtype": None, "weight_stream_quant": None},
}


# the band kernels' wrappers (ops/band.py), each with its own launch count
BAND_WRAPPERS = ("band_spmm", "band_spmm_packed", "band_dx", "band_dx_packed", "band_dv", "band_dv_packed")
# bsr_spmm and sampled_matmul count their bf16 and f16 (tensor-core) kernels'
# launches apart; the band wrappers their f16 ones (bf16 beside f32: the
# bf16 band paths' windows are keyed 'band bf16')
SPARSE_KERNELS = (("bsr_spmm", "sampled_matmul", "bsr_spmm_bf16", "sampled_matmul_bf16", "bsr_spmm_f16",
                   "sampled_matmul_f16") + BAND_WRAPPERS + tuple(name + "_f16" for name in BAND_WRAPPERS))


def _counters():
    """{name: (object holding the count, attribute)} of every kernel wrapper."""
    from multistgraph_tpu_torch.ops import band, band_probe
    from multistgraph_tpu_torch.ops.layout import force_default_layout
    from multistgraph_tpu_torch.ops.node_apply import node_apply_q8, node_apply_q8_t
    from multistgraph_tpu_torch.ops.spmm import bsr_spmm, sampled_matmul

    # B2 and B2t count each activation dtype's launches apart (bf16 in .launches)
    counters = {"node_apply_q8": (node_apply_q8, "launches"), "node_apply_q8_t": (node_apply_q8_t, "launches"),
                "node_apply_q8_f32": (node_apply_q8, "launches_f32"),
                "node_apply_q8_t_f32": (node_apply_q8_t, "launches_f32"),
                "node_apply_q8_f16": (node_apply_q8, "launches_f16"),
                "node_apply_q8_t_f16": (node_apply_q8_t, "launches_f16"),
                "force_default_layout": (force_default_layout, "launches"),
                "force_default_layout_bwd": (force_default_layout, "backward_launches"),
                "bsr_spmm": (bsr_spmm, "launches"), "sampled_matmul": (sampled_matmul, "launches"),
                "bsr_spmm_bf16": (bsr_spmm, "bf16_launches"), "sampled_matmul_bf16": (sampled_matmul, "bf16_launches"),
                "bsr_spmm_f16": (bsr_spmm, "f16_launches"), "sampled_matmul_f16": (sampled_matmul, "f16_launches")}
    counters.update({name: (getattr(band, name), "launches") for name in BAND_WRAPPERS})
    counters.update({name + "_f16": (getattr(band, name), "f16_launches") for name in BAND_WRAPPERS})
    counters.update({"window_dot": (band_probe.window_dot, "launches"),
                     "band_slab": (band_probe.band_slab, "launches"),
                     "band_slab_batched": (band_probe.band_slab, "batched_launches")})
    counters.update({name: (getattr(importlib.import_module("multistgraph_tpu_torch." + module), name), "launches")
                     for name, module in HARNESS_WRAPPERS})
    return counters


def _reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _read_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def _replayed(graphs):
    """The launches of every replay so far of `graphs` (StepGraph objects),
    under the names of ``_counters``: a replay launches what its capture
    recorded, and bumps no counter."""
    out = dict.fromkeys(_counters(), 0)
    for graph in graphs:
        out = _plus(out, _named(graph.replayed_launches()))
    return out


def _plus(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def _executor(torch, mode, feature, state_dict, device=None, **extra):
    """An executor for `mode` on the smoke's training arguments (and `extra`
    config keys), holding `state_dict`."""
    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.executor import get_executor
    from multistgraph_tpu_torch.executor.optimizers import set_learning_rate
    from multistgraph_tpu_torch.models import get_model

    args = dict(_serving_args(os.path.join(WORK, "raw_data")), exp_id="chip_smoke_train",
                saved_model=False, tensorboard=False, **_MODES[mode])
    cfg = load_config("traffic_state_pred", "MultiATGCN", "SYN_DC237", other_args=dict(args, **extra))
    model = get_model(cfg, feature, device=device)
    model.load_state_dict(state_dict)
    executor = get_executor(cfg, model, feature, device=device)
    set_learning_rate(executor.optimizer, LEARNING_RATE)
    return executor


def _timed_steps(torch, executor, batches, warmup, want_per_step):
    """`warmup` steps, then the rest timed on the host clock with the
    launch counts from 0; raises unless every count is exactly
    want_per_step x steps and every loss is finite."""
    losses = [float(executor.train_step(b)) for b in batches[:warmup]]
    torch.cuda.synchronize()
    _reset_counts()
    timed, marks = [], [time.perf_counter()]
    for b in batches[warmup:]:
        timed.append(executor.train_step(b))
        torch.cuda.synchronize()  # per-step times; the step's own loss read is deferred
        marks.append(time.perf_counter())
    counts = _read_counts()
    steps = len(batches) - warmup
    want = {k: want_per_step.get(k, 0) * steps for k in counts}
    if counts != want:
        raise AssertionError("{} training steps launched {}, want {}".format(steps, counts, want))
    losses += [float(v) for v in timed]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite training loss: {}".format(losses))
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return statistics.median(step_ms), losses, counts, step_ms


def training_phase(torch):
    """int8 training through get_executor at the flagship width (the main
    path), one validation pass, then f32 and bf16 steps; the launch counts
    of each window, and the weights and batch for the gradient check."""
    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.models import get_model

    args = dict(_serving_args(os.path.join(WORK, "raw_data")), exp_id="chip_smoke_train")
    cfg = load_config("traffic_state_pred", "MultiATGCN", "SYN_DC237", other_args=args)
    dataset = get_dataset(cfg)
    train, val, _ = dataset.get_data()
    feature = dataset.get_data_feature()
    # the seeded initialiser's weights, at their own scale
    init = get_model(cfg, feature, device="cpu", generator=torch.Generator().manual_seed(0))
    state_dict = {k: v.clone() for k, v in init.state_dict().items()}
    executor = _executor(torch, "int8", feature, state_dict)
    if not executor.model.uses_int8_stream:
        raise AssertionError("the trained model does not take the int8 weight-stream path")
    perm = train.epoch_permutation()
    batches = [executor.batch(train, idx) for idx in perm[: TRAIN_WARMUP + TRAIN_STEPS]]
    per_step = 2 * T * NUM_LAYERS
    windows = {}
    ms, losses, windows["int8 training"], step_ms = _timed_steps(
        torch, executor, batches, TRAIN_WARMUP,
        {"node_apply_q8": per_step, "node_apply_q8_t": per_step})
    record = {"train_batches": len(train), "batch": B, "steps": TRAIN_STEPS, "ms_per_step": ms,
              "step_ms": step_ms,
              "epochs_per_hour": 3600.0 / (ms / 1e3 * len(train)),
              "first_loss": losses[0], "last_loss": losses[-1],
              "device_time_per_step": _device_time(torch, lambda: executor.train_step(batches[-1]), ms)}

    _reset_counts()
    t0 = time.perf_counter()
    val_loss = executor._valid_epoch(val)
    record["validation"] = {"batches": len(val), "loss": val_loss,
                            "seconds": time.perf_counter() - t0}
    # its first batch eager, the rest replays of the captured forward
    windows["validation"] = _plus(_read_counts(), _replayed(executor.graphs.values()))
    if windows["validation"] != dict(dict.fromkeys(windows["validation"], 0), node_apply_q8=per_step * len(val)):
        raise AssertionError("validation launched {}".format(windows["validation"]))
    if not math.isfinite(val_loss):
        raise AssertionError("non-finite validation loss")

    # the int8 stream at f32 activations: as many steps, B2's and B2t's f32
    # forms only, and one validation pass
    ex = _executor(torch, "int8 f32", feature, state_dict)
    if not ex.model.uses_int8_stream:
        raise AssertionError("the int8 f32 model does not take the int8 weight-stream path")
    ms, f32_losses, windows["int8 f32 training"], f32_step_ms = _timed_steps(
        torch, ex, batches, TRAIN_WARMUP, {"node_apply_q8_f32": per_step, "node_apply_q8_t_f32": per_step})
    record["int8 f32"] = {"steps": TRAIN_STEPS, "ms_per_step": ms, "step_ms": f32_step_ms,
                          "epochs_per_hour": 3600.0 / (ms / 1e3 * len(train)),
                          "first_loss": f32_losses[0], "last_loss": f32_losses[-1],
                          "device_time_per_step": _device_time(torch, lambda: ex.train_step(batches[-1]), ms)}
    _reset_counts()
    t0 = time.perf_counter()
    val_loss = ex._valid_epoch(val)
    record["int8 f32"]["validation"] = {"batches": len(val), "loss": val_loss, "seconds": time.perf_counter() - t0}
    windows["int8 f32 validation"] = _plus(_read_counts(), _replayed(ex.graphs.values()))
    if windows["int8 f32 validation"] != dict(dict.fromkeys(windows["int8 f32 validation"], 0),
                                              node_apply_q8_f32=per_step * len(val)):
        raise AssertionError("int8 f32 validation launched {}".format(windows["int8 f32 validation"]))
    if not math.isfinite(val_loss):
        raise AssertionError("non-finite int8 f32 validation loss")

    for mode, want in (("f32", {"force_default_layout": 2 * NUM_LAYERS,
                                "force_default_layout_bwd": 2 * NUM_LAYERS}), ("bf16", {})):
        ex = _executor(torch, mode, feature, state_dict)
        ms, mode_losses, windows[mode + " training"], mode_step_ms = _timed_steps(
            torch, ex, batches[: 1 + MODE_STEPS], 1, want)
        record[mode] = {"steps": MODE_STEPS, "ms_per_step": ms, "step_ms": mode_step_ms,
                        "losses": mode_losses,
                        "epochs_per_hour": 3600.0 / (ms / 1e3 * len(train))}
    say(json.dumps({"training": record}))
    say("launches per window: " + json.dumps(windows))
    grad_batch = {k: v[:GRAD_BATCH].cpu() for k, v in batches[0].items()}
    return windows, feature, state_dict, grad_batch, (train, val)


# ------------------------------------------------------------------ graphs
GRAPH_CHECK_REPLAYS = 3     # replayed steps held bit for bit against as many eager steps
GRAPH_TIMED = 10            # replayed steps timed (after 3), and the requests per bucket
GRAPH_EAGER_EPOCH = 24      # batches of the eager int8 epoch (the graphed one runs them all)
PROFILE_BATCHES = 8         # the profile_dir run's epochs: the first 8 batches
# kernels of one captured step, by profiler name: B2 and B2t are q8_kernel
# instantiations, B3 strided_copy_kernel (csrc/layout_copy.cu)
GRAPH_KERNELS = {"int8": {"q8_kernel": 4 * T * NUM_LAYERS, "strided_copy_kernel": 0},
                 "int8 f32": {"q8_kernel": 4 * T * NUM_LAYERS, "strided_copy_kernel": 0},
                 "bf16": {"q8_kernel": 0, "strided_copy_kernel": 0},
                 "f32": {"q8_kernel": 0, "strided_copy_kernel": 4 * NUM_LAYERS}}
# the launches one captured step records, by counter
GRAPH_CAPTURED = {"int8": {"node_apply_q8": 2 * T * NUM_LAYERS, "node_apply_q8_t": 2 * T * NUM_LAYERS},
                  "int8 f32": {"node_apply_q8_f32": 2 * T * NUM_LAYERS, "node_apply_q8_t_f32": 2 * T * NUM_LAYERS},
                  "bf16": {}, "f32": {"force_default_layout": 2 * NUM_LAYERS, "force_default_layout_bwd": 2 * NUM_LAYERS}}


class _Rows:
    """The batches `rows` (a slice of a loader's permutation) of its split,
    in that order."""

    def __init__(self, loader, rows):
        self.x, self.y, self.batch_size = loader.x, loader.y, loader.batch_size
        self._perm = rows

    def __len__(self):
        return len(self._perm)

    def epoch_permutation(self):
        return self._perm

    ordered_permutation = epoch_permutation


def _First(loader, k, ordered=False):
    """The first `k` batches of a loader's permutation, on its split."""
    return _Rows(loader, (loader.ordered_permutation() if ordered else loader.epoch_permutation())[:k])


def _same_state(torch, a, b):
    """Whether two executors hold the same parameters and optimizer state, bit for bit."""
    if not all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters())):
        return False
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    return sa.keys() == sb.keys() and all(
        torch.equal(torch.as_tensor(v), torch.as_tensor(sb[k][key])) for k, st in sa.items() for key, v in st.items())


def _ms_each(torch, fn, n):
    """Host ms of each of n calls fn(i), each ended by a synchronize."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _eager_validation(torch, executor, loader):
    with torch.no_grad():
        return float(torch.stack([executor.loss_fn(executor.batch(loader, idx), train=False)
                                  for idx in loader.ordered_permutation()]).mean())


def _graph_serving(torch, model, scaler, feature, x_all, eager_latency):
    """PredictService's bucket graphs against eager replies (bit for bit) at
    buckets 1, 4 and 16, the median of 10 requests each (and of 10 eager
    ones with `eager_latency`), one bucket-16 request's device time; and
    the service's graphs."""
    import numpy as np

    from multistgraph_tpu_torch.serving import PredictService

    svc = PredictService(model, scaler, max_batch=B, ct_visit_mstd=feature["ct_visit_mstd"])
    ref = PredictService(model, scaler, max_batch=B, ct_visit_mstd=feature["ct_visit_mstd"])
    ref.graphed = False
    latency = {}
    for batch in BUCKETS:
        want = ref.predict(x_all[:batch])
        for _ in range(2):   # the capture, then a replay
            if not np.array_equal(svc.predict(x_all[:batch]), want):
                raise AssertionError("graphed reply at bucket {} differs from the eager one".format(batch))
        latency[str(batch)] = {"graphed": _bucket_ms(svc, x_all[:batch], GRAPH_TIMED)}
        if eager_latency:
            latency[str(batch)]["eager"] = _bucket_ms(ref, x_all[:batch], GRAPH_TIMED)
    if svc.stats()["compiled_buckets"] != list(BUCKETS):
        raise AssertionError("captured buckets {}".format(svc.stats()["compiled_buckets"]))
    share = _device_share(torch, svc, x_all, latency[str(B)]["graphed"])
    return latency, share, list(svc.graphs.values())


def _adam_gap(torch, steps=5, lr=3e-3, b1=0.9, b2=0.999, eps=1e-8):
    """Adam's bias correction on the card (ROADMAP.md §C item 14): `steps`
    steps on the same parameters and gradients of the capturable Adam the
    executor builds (a device rate, 1-beta^t in f32 on the device) and of
    torch's host-rate Adam (1-beta^t in f64 on the host), each against
    optax's rule written out in f32; the largest difference over max |p|."""
    g = torch.Generator(device="cuda").manual_seed(0)
    p0 = torch.randn(1 << 16, device="cuda", generator=g)
    grads = [torch.randn(1 << 16, device="cuda", generator=g) for _ in range(steps)]

    def torch_adam(**kw):
        p = torch.nn.Parameter(p0.clone())
        opt = torch.optim.Adam([p], betas=(b1, b2), eps=eps, **kw)
        for grad in grads:
            p.grad = grad.clone()
            opt.step()
        return p.detach()

    p, m, v = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
    for t, grad in enumerate(grads, 1):  # optax.adam: f32 moments and corrections
        m = b1 * m + (1 - b1) * grad
        v = b2 * v + (1 - b2) * grad * grad
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
        p = p - lr * (m / c1.cuda()) / (torch.sqrt(v / c2.cuda()) + eps)

    def gap(a):
        return float((a - p).abs().max() / p.abs().max())

    return {"steps": steps, "capturable_vs_optax_f32": gap(torch_adam(lr=torch.tensor(lr, device="cuda"),
                                                                       capturable=True, foreach=True)),
            "host_rate_vs_optax_f32": gap(torch_adam(lr=lr))}


def graph_phase(torch, feature, state_dict, loaders):
    """The executor's and the service's CUDA graphs at the flagship width.
    For each configuration: 3 replayed steps against 3 eager steps, bit for
    bit (mean loss, parameters, optimizer state); the median of 10 replays
    after 3; one replay's device time by kernel, whose B2/B2t/B3 kernels
    must be the eager counts, beside one eager step's. In int8 also a
    graphed validation pass against an eager one (bit for bit, and timed),
    a graphed epoch against eager steps over its first 24 batches, and the
    service at buckets 1, 4 and 16 (replies bit for bit, latency graphed
    and eager); in int8 f32 the service, graphed. Then a profile_dir run.
    Returns the window of launches: the eager counters plus every replay's
    captured launches."""
    import gc

    from multistgraph_tpu_torch.executor.executor import GRAPH_WARMUP_STEPS

    train, val = loaders
    replays = {}   # the launches of every replay of the phase's graphs
    _reset_counts()
    record = {}
    for mode in _MODES:
        graphed = _executor(torch, mode, feature, state_dict)
        eager = _executor(torch, mode, feature, state_dict)
        if not graphed.graphs_train:
            raise AssertionError("{}: the executor does not capture its train step".format(mode))
        first = _First(train, GRAPH_WARMUP_STEPS + GRAPH_CHECK_REPLAYS)
        got = graphed.train_epoch(first, LEARNING_RATE)
        losses = []
        eager_ms = _ms_each(torch, lambda i: losses.append(eager.train_step(
            eager.batch(train, first.epoch_permutation()[i]))), len(first))[GRAPH_WARMUP_STEPS:]
        want = float(torch.stack(losses).mean())
        graph = graphed.graphs["train"]
        if got != want or not _same_state(torch, graphed, eager):
            raise AssertionError("{}: {} replayed steps differ from eager ones (mean loss {} vs {})".format(
                mode, GRAPH_CHECK_REPLAYS, got, want))
        captured = {k: v for k, v in _replayed([graph]).items() if v}
        if captured != {k: GRAPH_CHECK_REPLAYS * v for k, v in GRAPH_CAPTURED[mode].items()}:
            raise AssertionError("{}: the captured step recorded {}".format(mode, graph.captured))
        if mode == "int8":
            # validation on the same state: the capture (first batch eager), then replays
            val_graphed = graphed._valid_epoch(val)
            if val_graphed != _eager_validation(torch, eager, val):
                raise AssertionError("graphed validation {} differs from eager".format(val_graphed))

        perm = torch.as_tensor(train.epoch_permutation(), device=graphed.device)
        _ms_each(torch, lambda i: graph.run(idx=perm[i]), 3)
        replay_ms = _ms_each(torch, lambda i: graph.run(idx=perm[3 + i]), GRAPH_TIMED)
        ms, ms_eager = statistics.median(replay_ms), statistics.median(eager_ms)
        dev = _device_time(torch, lambda: graph.run(idx=perm[0]), ms, by_kernel=True)
        batch0 = eager.batch(train, first.epoch_permutation()[0])
        dev_eager = _device_time(torch, lambda: eager.train_step(batch0), ms_eager)
        counted = {name: sum(k["count"] for k in dev["by_kernel"] if name in k["name"]) for name in GRAPH_KERNELS[mode]}
        if counted != GRAPH_KERNELS[mode]:
            raise AssertionError("{}: one replay's profile holds {}, the eager counts give {}".format(
                mode, counted, GRAPH_KERNELS[mode]))
        record[mode] = {"replayed_ms_per_step": ms, "replay_step_ms": replay_ms,
                        "eager_ms_per_step": ms_eager, "eager_step_ms": eager_ms,
                        "epochs_per_hour_graphed": 3600.0 / (ms / 1e3 * len(train)),
                        "epochs_per_hour_eager": 3600.0 / (ms_eager / 1e3 * len(train)),
                        "kernels_in_one_replay": counted}
        if mode == "int8":
            # the validation graph's capture came at the check; now all replays
            t0 = time.perf_counter()
            graphed._valid_epoch(val)
            t1 = time.perf_counter()
            _eager_validation(torch, eager, val)
            record[mode]["validation_s"] = {"batches": len(val), "graphed": t1 - t0,
                                            "eager": time.perf_counter() - t1}
            # a whole epoch, every step a replay, against eager steps
            t0 = time.perf_counter()
            graphed.train_epoch(train, LEARNING_RATE)
            epoch_s = time.perf_counter() - t0
            part = _First(train, GRAPH_EAGER_EPOCH)
            t0 = time.perf_counter()
            float(torch.stack([eager.train_step(eager.batch(train, idx)) for idx in part.epoch_permutation()]).mean())
            eager_step_s = (time.perf_counter() - t0) / len(part)
            record["int8 epoch"] = {"batches": len(train), "graphed_s": epoch_s,
                                    "graphed_ms_per_step": 1e3 * epoch_s / len(train),
                                    "epochs_per_hour_graphed": 3600.0 / epoch_s,
                                    "eager_batches": len(part), "eager_ms_per_step": 1e3 * eager_step_s,
                                    "epochs_per_hour_eager": 3600.0 / (eager_step_s * len(train))}
        if mode in ("int8", "int8 f32"):
            latency, share, service_graphs = _graph_serving(torch, graphed.model, graphed._scaler, feature,
                                                            val.x[:B].cpu().numpy(), eager_latency=mode == "int8")
            replays = _plus(replays, _replayed(service_graphs))
            record[mode]["ms_per_request_by_bucket"] = latency
            record[mode]["device_time_per_request"] = share
        say(json.dumps({"graph": mode, **record[mode]}))
        say(json.dumps({"graph device time": mode, "replay": dev, "eager step": dev_eager}))
        replays = _plus(replays, _replayed(graphed.graphs.values()))
        del graphed, eager, graph
        gc.collect()
        torch.cuda.empty_cache()
    say(json.dumps({"graph epoch": record["int8 epoch"]}))
    say(json.dumps({"adam_bias_correction_gap": _adam_gap(torch)}))

    # profile_dir: a 2-epoch run on the first 8 batches, epoch 1 traced (no
    # reload of the best epoch at the end, which would drop the graphs)
    profile_dir = os.path.join(WORK, "profile")
    shutil.rmtree(profile_dir, ignore_errors=True)
    ex = _executor(torch, "int8", feature, state_dict, profile_dir=profile_dir, max_epoch=2,
                   load_best_epoch=False)
    ex.train(_First(train, PROFILE_BATCHES), _First(val, PROFILE_BATCHES, ordered=True))
    replays = _plus(replays, _replayed(ex.graphs.values()))
    (trace,) = os.listdir(profile_dir)
    with open(os.path.join(profile_dir, trace)) as f:
        events = json.load(f)["traceEvents"]
    q8 = sum(1 for e in events if e.get("cat") == "kernel" and "q8_kernel" in e.get("name", ""))
    # epoch 1: every train step (96 B2 + 96 B2t) and validation batch (96 B2) a replay
    want_q8 = PROFILE_BATCHES * 3 * 2 * T * NUM_LAYERS
    say(json.dumps({"profile_dir": {"trace": trace, "events": len(events), "q8_kernels": q8, "want": want_q8}}))
    if trace != "epoch1.pt.trace.json" or q8 != want_q8:
        raise AssertionError("profile_dir trace {} holds {} q8 kernels, want {}".format(trace, q8, want_q8))
    window = _plus(_read_counts(), replays)
    say(json.dumps({"graph phase launches": {k: v for k, v in window.items() if v}}))
    return window


def _grads(torch, mode, feature, state_dict, batch, device=None):
    """One step's loss (dropout off) and every parameter gradient, on the CPU."""
    executor = _executor(torch, mode, feature, state_dict, device=device)
    dev = executor.device
    loss = executor.loss_fn({k: v.to(dev) for k, v in batch.items()}, train=False)
    loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).float().cpu()
             for n, p in executor.model.named_parameters()}
    return loss.detach().float().cpu(), grads


def _grad_err(a, b):
    """Relative max error of the loss and of every gradient (over the
    reference's max |value|; parameters the loss does not reach are
    skipped). A non-finite value counts as an infinite error."""
    loss_a, grads_a = a
    loss_b, grads_b = b

    def rel(x, ref):
        e = float((x - ref).abs().max() / ref.abs().max())
        return e if math.isfinite(e) else float("inf")

    errs = {n: rel(grads_a[n], g) for n, g in grads_b.items() if g.abs().max() > 0}
    worst = max(errs, key=errs.get)
    loss_err = rel(loss_a, loss_b)
    return {"loss": loss_err, "worst_param": worst, "max": max(errs[worst], loss_err)}


def gradient_phase(torch, feature, state_dict, batch):
    """Card vs CPU gradients in int8, bf16 and f32, and the planted faults."""
    from unittest import mock

    from multistgraph_tpu_torch.models import multi_atgcn
    from multistgraph_tpu_torch.ops import layout as layout_ops
    from multistgraph_tpu_torch.ops import node_apply
    from multistgraph_tpu_torch.ops.node_apply import node_apply_q8_t

    gained = {k: v * POOL_GAIN if k.endswith("weights_pool") else v for k, v in state_dict.items()}
    bounds = {"int8": BOUND_GRAD_BF16, "int8 f32": BOUND_GRAD_INT8_F32, "bf16": BOUND_GRAD_BF16,
              "f32": BOUND_GRAD_F32}
    cpu = {m: _grads(torch, m, feature, gained, batch, device="cpu") for m in _MODES}
    errs = {m: _grad_err(_grads(torch, m, feature, gained, batch), cpu[m]) for m in _MODES}

    def b3_zeroed(ctx, g):
        return torch.zeros_like(layout_ops._copy(g, "backward_launches"))

    faults = {
        "B2t scale dropped": ("int8", mock.patch.object(
            multi_atgcn, "node_apply_q8_t", lambda d, wq, s: node_apply_q8_t(d, wq, torch.ones_like(s)))),
        "B2t output zeroed": ("int8", mock.patch.object(
            multi_atgcn, "node_apply_q8_t", lambda d, wq, s: torch.zeros_like(node_apply_q8_t(d, wq, s)))),
        "B3 cotangent zeroed": ("f32", mock.patch.object(
            layout_ops._ForceDefaultLayout, "backward", staticmethod(b3_zeroed))),
        # inside the kernels; the check's batch (GRAD_BATCH = 4) has no
        # columns past the first 8, where B2's third fault lies
        "B2t k16 planted in the kernel": ("int8", node_apply.planted_q8_fault("B2t k16")),
        "B2 k16 planted in the kernel": ("int8", node_apply.planted_q8_fault("B2 k16")),
        # the same in the f32 forms
        "int8 f32: B2t scale dropped": ("int8 f32", mock.patch.object(
            multi_atgcn, "node_apply_q8_t", lambda d, wq, s: node_apply_q8_t(d, wq, torch.ones_like(s)))),
        "int8 f32: B2t k16 planted in the kernel": ("int8 f32", node_apply.planted_q8_fault("B2t k16")),
        "int8 f32: B2 k16 planted in the kernel": ("int8 f32", node_apply.planted_q8_fault("B2 k16")),
    }
    controls = {}
    for name, (mode, patch) in faults.items():
        with patch:
            controls[name] = _grad_err(_grads(torch, mode, feature, gained, batch), cpu[mode])
    say(json.dumps({"gradient_rel_err_card_vs_cpu": errs, "bounds": bounds,
                    "planted_faults": controls, "pool_gain": POOL_GAIN, "batch": GRAD_BATCH}))
    for mode, err in errs.items():
        if not err["max"] < bounds[mode]:
            raise AssertionError("{} gradients, card vs CPU: {} over the bound {}".format(mode, err, bounds[mode]))
    for name, (mode, _) in faults.items():
        if not controls[name]["max"] > bounds[mode]:
            raise AssertionError("{} passes the {} gradient check ({})".format(name, mode, controls[name]))
    return errs, controls


# ------------------------------------------------------------------ sparse
# SparseATGCN at the scale point of BASELINE.json config 4 and
# tools/bench_large_graph.py: 49,152 nodes at degree 16 (4,946 nonzero
# 128x128 tiles), the model and data defaults of config/defaults.py
# (hidden 64, 2 layers, embed_dim_adj 16, the unidirectional adaptive view
# with the sampled softmax, remat, batch 2, 12 steps in, 3 out, len_time
# 240), f32, random weights from the config's seed.
SP_TASK, SP_MODEL, SP_DATASET = "traffic_state_pred", "SparseATGCN", "SYN_LARGE_49K"
SP_NODES, SP_CHECK_NODES = 49152, 4096
SP_T, SP_B, SP_H = 12, 2, 64
SP_WARMUP, SP_STEPS = 2, 10
SP_SPMM_WIDTHS = (16, 24, 64, 128, 1536)   # sddmm dE, layer-0 hoist, serving step, step, layer-1 hoist
SP_DX_WIDTHS = (128, 1536)                 # transposed (dX) of the per-step aggregations and of layer 1's hoist
SP_FAULT_WIDTH = 128                       # faults planted inside B4/B6 (f32) must fail the holds at this width
SP_B5_WIDTHS = (16, 24, 128, 1536)         # forward scores, then adaptive dV at each SpMM width
SP_B5_FAULT_WIDTHS = (16, 128)             # faults planted inside B5 (f32): one chunk of d, then four
PEAK_F32_FLOPS = 67e12
PEAK_F32_NOTE = "H100 SXM data sheet: 3.35 TB/s HBM, 67 TFLOP/s f32 (CUDA cores; TF32 is off)"
# Card vs CPU at 4,096 nodes (373 tiles), same configuration and weights:
# the relative max error (max |card - CPU| over max |CPU|) of the model
# output, and of one step's loss and every parameter gradient (largest over
# the parameters). 1e-4 each before the first run; an H100 read 4.45e-7
# (output) and 1.72e-6 (node_vec2's gradient), f32 sums in other orders
# over 24 recurrent steps, so the bounds are 4.5x and 4.1x those readings.
# The planted faults read 0.587 (output) and 0.356 / 0.217 (gradients).
BOUND_SPARSE_OUT = 2e-6
BOUND_SPARSE_GRAD = 7e-6


def _sparse_args(num_nodes, exp_id):
    return {"output_dir": os.path.join(WORK, "outputs"), "exp_id": exp_id, "num_nodes": num_nodes,
            "avg_degree": 16, "seed": 0, "tensorboard": False}


def _sparse_launches(model, steps=1, train=False, t=SP_T):
    """Launches of every sparse kernel wrapper in `steps` forwards (or
    training steps) of `model` at `t` input steps, derived from the code:
      forward, per layer: one hoisted aggregation of the input and two per
        step (h and z*h); each applies every static support's BSR part
        (bsr_spmm) or band (band_spmm on planes, band_spmm_packed on packed
        rows), and the adaptive view (bsr_spmm); one sampled matmul for the
        adaptive scores;
      training adds: the per-step aggregations again under remat
        (torch.utils.checkpoint recomputes each step); dX of every product
        whose input needs a gradient, i.e. all but layer 0's hoisted input
        (the data) and h at t=0 (zeros): bsr_spmm on the transposed graph,
        band_dx for a band; dV, a sampled matmul, of every adaptive SpMM
        (the static supports' values are constants: no band_dv); and the
        SDDMM's backward, dE1 and dE2, two SpMMs.
    A bf16 model's BSR products launch the bf16 kernels, counted under
    bsr_spmm_bf16 and sampled_matmul_bf16; its band products count under
    the band wrappers' names, as f32 ones do. An f16 model's BSR and band
    products count under the names with _f16, but for the SDDMM's dE1 and
    dE2: their dS is f32 (the f16 scores are f32), so they run the f32
    bsr_spmm on the embeddings widened to f32."""
    layers = model.num_layers
    aggs = layers * (1 + 2 * t)
    recompute = layers * 2 * t if train and model.remat else 0
    dx = layers * (2 * t - 1) + (layers - 1) if train else 0
    supports = [model._support(i) for i in range(model.num_static)]
    bsr = sum(model._has_bsr(sv) for sv in supports) + int(model.has_adaptive)
    planes = sum("band_values" in sv for sv in supports)
    packed = sum("band_packed" in sv for sv in supports)
    f16 = str(model.compute_dtype) == "torch.float16"
    bf16 = "_f16" if f16 else "_bf16" if model.compute_dtype is not None else ""
    band16 = "_f16" if f16 else ""
    sddmm_de = 2 if train and model.has_adaptive else 0
    counts = dict.fromkeys(SPARSE_KERNELS, 0)
    counts.update({
        "bsr_spmm" + bf16: bsr * (aggs + recompute + dx) + (0 if f16 else sddmm_de),
        "sampled_matmul" + bf16: int(model.has_adaptive) * (1 + (aggs if train else 0)),
        "band_spmm" + band16: planes * (aggs + recompute), "band_dx" + band16: planes * dx,
        "band_spmm_packed" + band16: packed * (aggs + recompute), "band_dx_packed" + band16: packed * dx,
    })
    if f16:
        counts["bsr_spmm"] += sddmm_de
    return {k: v * steps for k, v in counts.items()}


def _bsr_csr_pattern(torch, row_ptr, col_of, nb):
    """The CSR expansion (crow, col) of a BSR block pattern, every entry of
    every tile (for torch.sparse.sampled_addmm)."""
    block = 128
    cols = (col_of.long()[:, None] * block + torch.arange(block, device=col_of.device)).reshape(-1)
    counts = (row_ptr[1:] - row_ptr[:-1]).long() * block                 # entries per node row
    crow = torch.zeros(nb * block + 1, dtype=torch.long, device=col_of.device)
    crow[1:] = torch.cumsum(counts.repeat_interleave(block), 0)
    bounds = row_ptr.tolist()
    parts = [cols[bounds[r] * block: bounds[r + 1] * block].repeat(block) for r in range(nb)]
    return crow, torch.cat(parts)


def sparse_kernel_phase(torch):
    """bsr_spmm and sampled_matmul vs their plain versions on the 49,152-node
    graph at the widths the main path gives them, timed, with their bounds
    and one PyTorch library call each (for sampled_matmul also
    torch.sparse.sampled_addmm), and faults planted inside both f32
    kernels."""
    import ctypes

    from multistgraph_tpu_torch.ops import _cuda
    from multistgraph_tpu_torch.ops import spmm as sp
    from multistgraph_tpu_torch.ops.bsr import random_spatial_graph

    t0 = time.time()
    graph, _ = random_spatial_graph(SP_NODES, 16, seed=0)
    say("49,152-node graph built in {:.1f}s: {} tiles in {} row blocks".format(
        time.time() - t0, graph.nnz_blocks, graph.num_row_blocks))
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    nb, nnz, n_pad = graph.num_row_blocks, graph.nnz_blocks, graph.padded_nodes
    values = torch.from_numpy(graph.values).to(dev)
    row = torch.from_numpy(graph.row_of).to(dev)
    col = torch.from_numpy(graph.col_of).to(dev)
    row_ptr = sp.row_ptr_of(row, nb)
    tile_bytes = nnz * 128 * 128 * 4
    index_bytes = (2 * nnz + nb + 1) * 4
    lines, faults = [], {}

    def spmm_rows(values, row, row_ptr, col, schedule, widths, what, fault_kinds=()):
        bsr = torch.sparse_bsr_tensor(row_ptr, col, values, size=(n_pad, n_pad))
        for feat in widths:
            x = torch.randn(n_pad, feat, generator=g, device=dev)
            got = sp.bsr_spmm(values, row, row_ptr, col, x, nb, schedule)
            want = sp.spmm_plain(values, row, col, x, out_blocks=nb)
            torch.cuda.synchronize()
            # the same f32 products, summed in another order
            _hold(_over_bound(got, want), "bsr_spmm vs its plain version at F={}{}".format(feat, what))
            max_abs_err = (got - want).abs().max().item()
            if feat == SP_FAULT_WIDTH:
                if not torch.equal(got, sp.bsr_spmm(values, row, row_ptr, col, x, nb, schedule)):
                    raise AssertionError("bsr_spmm at F={}{}: two calls differ".format(feat, what))
                for kind in fault_kinds:
                    with sp.planted_fault(kind, "bsr_spmm"):
                        bad = sp.bsr_spmm(values, row, row_ptr, col, x, nb, schedule)
                    faults["bsr_spmm F={}{}: {}".format(feat, what, kind)] = _over_bound(bad, want)
                    del bad
            del got, want
            num_bytes = tile_bytes + index_bytes + 2 * n_pad * feat * 4
            flops = 2 * nnz * 128 * 128 * feat
            bound, by = _bound_ms(num_bytes, flops, PEAK_F32_FLOPS)
            library_ms, library = _library_ms(torch, lambda: bsr @ x,
                                              "torch.sparse_bsr_tensor(row_ptr, col_of, values) @ x")
            stream = feat % 128 == 0  # the width JAX sends to spmm_stream (B6), else the block-grid kernel (B4)
            lines.append({
                "name": "bsr_spmm", "shape": "N={} nnz={} F={}{}".format(n_pad, nnz, feat, what),
                "replaces": ("multistgraph_tpu/ops/spmm_stream.py:303 spmm_stream" if stream
                             else "multistgraph_tpu/ops/spmm.py:87 _spmm_blockgrid"),
                "max_abs_err": max_abs_err, "tolerance": "rtol 1e-5, atol 1e-5*max|plain|",
                "kernel_ms": _time_ms(torch, lambda: sp.bsr_spmm(values, row, row_ptr, col, x, nb, schedule)),
                "plain_ms": _time_ms(torch, lambda: sp.spmm_plain(values, row, col, x, out_blocks=nb), reps=10),
                "library_ms": library_ms, "library": library,
                "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "flops": flops,
                "peak": PEAK_F32_NOTE, "main_path": True,
            })

    # the model's schedule of the pattern (built once, as models/sparse_atgcn.py does)
    spmm_rows(values, row, row_ptr, col, sp.bsr_schedule(row_ptr, nnz, exact=True), SP_SPMM_WIDTHS, "",
              sorted(sp.FAULTS))
    # the backward's dX walks the block-transposed graph, whose hub-column
    # row blocks hold a tile from every row block: split into segments, on
    # the schedule the model builds once for the transposed pattern
    v_t, r_t, c_t = sp.bsr_transpose(values, row, col, nb)
    ptr_t, sched_t = sp.bsr_transpose_schedule(row, col, nb, exact=True)
    say(json.dumps({"bsr_schedule f32 transposed": _schedule_summary(torch, sched_t)}))
    spmm_rows(v_t, r_t, ptr_t, c_t, sched_t, SP_DX_WIDTHS, " transposed (backward dX)", sorted(sp.SPMM_FAULTS))
    del v_t
    crow, ccol = _bsr_csr_pattern(torch, row_ptr, col, nb)
    blocks = _cuda.library("sampled_matmul").sampled_matmul_f32_blocks   # the f32 kernel's grid for nnz tiles
    blocks.argtypes, blocks.restype = [ctypes.c_int], ctypes.c_int
    for d in SP_B5_WIDTHS:
        a = torch.randn(n_pad, d, generator=g, device=dev)
        bt = torch.randn(n_pad, d, generator=g, device=dev)
        got = sp.sampled_matmul(a, bt, row, col)
        want = sp.sampled_matmul_plain(a, bt, row, col)
        torch.cuda.synchronize()
        _hold(_over_bound(got, want), "sampled_matmul vs its plain version at D={}".format(d))
        if d in SP_B5_FAULT_WIDTHS:
            for kind in sorted(sp.FAULTS):
                with sp.planted_fault(kind, "sampled_matmul"):
                    bad = sp.sampled_matmul(a, bt, row, col)
                faults["sampled_matmul d={}: {}".format(d, kind)] = _over_bound(bad, want)
                del bad
        num_bytes = 2 * n_pad * d * 4 + 2 * nnz * 4 + tile_bytes
        flops = 2 * nnz * 128 * 128 * d
        bound, by = _bound_ms(num_bytes, flops, PEAK_F32_FLOPS)
        # the library call: one f32 torch.bmm of the tiles' row blocks, gathered outside the timed window
        a_t = a.reshape(-1, 128, d).index_select(0, row)
        b_t = bt.reshape(-1, 128, d).index_select(0, col)
        library_ms = _time_ms(torch, lambda: torch.bmm(a_t, b_t.transpose(1, 2)), reps=10)
        del a_t, b_t
        csr = torch.sparse_csr_tensor(crow, ccol, torch.ones(ccol.numel(), device=dev), size=(n_pad, n_pad))
        addmm_ms, addmm = _library_ms(
            torch, lambda: torch.sparse.sampled_addmm(csr, a, bt.t(), beta=0.0),
            "torch.sparse.sampled_addmm on the CSR expansion of the pattern")
        n_blocks = blocks(nnz)
        lines.append({
            "name": "sampled_matmul", "shape": "N={} nnz={} d={}".format(n_pad, nnz, d),
            "replaces": "multistgraph_tpu/ops/spmm.py:129 _sampled_matmul_impl",
            "max_abs_err": (got - want).abs().max().item(), "tolerance": "rtol 1e-5, atol 1e-5*max|plain|",
            "kernel_ms": _time_ms(torch, lambda: sp.sampled_matmul(a, bt, row, col)),
            "plain_ms": _time_ms(torch, lambda: sp.sampled_matmul_plain(a, bt, row, col), reps=10),
            "library_ms": library_ms, "library": "torch.bmm of the pre-gathered row blocks (the gathers not timed)",
            "sampled_addmm_ms": addmm_ms, "sampled_addmm": addmm,
            "design": "simt_f32.cuh sampled kernel, {} persistent blocks".format(n_blocks),
            "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "flops": flops, "peak": PEAK_F32_NOTE,
            "main_path": True,
        })
        del a, bt, got, want, csr
    del crow, ccol, values
    torch.cuda.empty_cache()
    for line in lines:
        say(json.dumps(line))
    say(json.dumps({"sparse_f32_planted_faults_over_bound": faults}))
    for fault, ratio in faults.items():
        if not ratio > 1.0:
            raise AssertionError("{} passes its check ({:.3g} of the bound)".format(fault, ratio))
    return lines


def _schedule_summary(torch, schedule):
    """Segments, split rows, and the longest segment and row (in tiles) of a
    bsr_spmm schedule, read on the host outside any timed window."""
    from multistgraph_tpu_torch.ops.spmm import SEGMENT_TILES

    seg = schedule.segments.cpu().long()
    live = seg[seg[:, 0] >= 0]
    tiles = live[:, 2] - live[:, 1]
    rows = torch.zeros(int(live[:, 0].max()) + 1, dtype=torch.long).index_add_(0, live[:, 0], tiles)
    return {"segment_tiles": SEGMENT_TILES, "segments": int(live.shape[0]), "padded_to": int(seg.shape[0]),
            "split_rows": int(((live[:, 3] == 0) & (live[:, 4] > 1)).sum()), "longest_segment": int(tiles.max()),
            "longest_row": int(rows.max()), "workspace_slots": schedule.ws_slots}


def _warm_library_bsr(torch):
    """Call torch.sparse's f32 BSR product (the library call timed beside
    B4/B6 in sparse_kernel_phase) once at each of that phase's shapes, on
    the same 49,152-node pattern: it compiles its Triton kernels at first
    use, several seconds a width, and main() runs this while nvcc builds
    the port's kernels. Launches no kernel of the port; returns seconds."""
    from multistgraph_tpu_torch.ops import spmm as sp
    from multistgraph_tpu_torch.ops.bsr import random_spatial_graph

    t0 = time.time()
    graph, _ = random_spatial_graph(SP_NODES, 16, seed=0)
    nb, n_pad = graph.num_row_blocks, graph.padded_nodes
    values = torch.from_numpy(graph.values).cuda()
    row = torch.from_numpy(graph.row_of).cuda()
    col = torch.from_numpy(graph.col_of).cuda()
    v_t, r_t, c_t = sp.bsr_transpose(values, row, col, nb)
    for v, r, c, widths in ((values, row, col, SP_SPMM_WIDTHS), (v_t, r_t, c_t, SP_DX_WIDTHS)):
        bsr = torch.sparse_bsr_tensor(sp.row_ptr_of(r, nb), c, v, size=(n_pad, n_pad))
        for feat in widths:
            _library_ms(torch, lambda: bsr @ torch.ones(n_pad, feat, device="cuda"), "warm-up")
    torch.cuda.synchronize()
    return time.time() - t0


def _library_ms(torch, fn, label):
    """Time one PyTorch library call, or (None, the reason) if it refuses
    these inputs: a yardstick only, never called by the port."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        return None, "{} refused: {}".format(label, str(exc).splitlines()[0][:160])
    return _time_ms(torch, fn, reps=10), label


def sparse_phase(torch):
    """SparseATGCN's main path at 49,152 nodes: training through
    get_executor with exact launch counts per step, one validation and one
    evaluation pass, and serving the saved experiment through
    from_experiment at buckets 1 and 2."""
    import numpy as np

    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.executor import get_executor
    from multistgraph_tpu_torch.models import get_model
    from multistgraph_tpu_torch.serving import PredictService

    args = _sparse_args(SP_NODES, "chip_smoke_sparse")
    cfg = load_config(SP_TASK, SP_MODEL, SP_DATASET, other_args=args)
    t0 = time.time()
    dataset = get_dataset(cfg)
    train, val, test = dataset.get_data()
    feature = dataset.get_data_feature()
    graph = feature["bsr_graph"]
    setup = {"dataset_s": time.time() - t0, "nodes": graph.num_nodes, "padded": graph.padded_nodes,
             "tiles": graph.nnz_blocks, "train_batches": len(train), "val_batches": len(val),
             "test_batches": len(test)}
    model = get_model(cfg, feature)
    executor = get_executor(cfg, model, feature)
    if (model.hidden_dim, model.num_layers, model.embed_dim_adj, model.remat, model.has_adaptive,
            model.adaptive_softmax, cfg["batch_size"], cfg["input_window"]) != (
            SP_H, 2, 16, True, True, "sampled", SP_B, SP_T):
        raise AssertionError("the sparse configuration is not the defaults' full width")
    setup["model_s"] = time.time() - t0 - setup["dataset_s"]
    say(json.dumps({"sparse_setup": setup}))

    windows = {}
    perm = train.epoch_permutation()
    batches = [executor.batch(train, idx) for idx in perm[: SP_WARMUP + SP_STEPS]]
    torch.cuda.reset_peak_memory_stats()
    losses = [float(executor.train_step(b)) for b in batches[:SP_WARMUP]]
    torch.cuda.synchronize()
    _reset_counts()
    timed, marks = [], [time.perf_counter()]
    for b in batches[SP_WARMUP:]:
        timed.append(executor.train_step(b))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    windows["sparse training"] = _read_counts()
    want = dict(dict.fromkeys(windows["sparse training"], 0), **_sparse_launches(model, SP_STEPS, train=True))
    if windows["sparse training"] != want:
        raise AssertionError("{} sparse training steps launched {}, want {}".format(
            SP_STEPS, windows["sparse training"], want))
    losses += [float(v) for v in timed]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite sparse training loss: {}".format(losses))
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    ms = statistics.median(step_ms)
    record = {"steps": SP_STEPS, "batch": SP_B, "ms_per_step": ms, "step_ms": step_ms,
              "epochs_per_hour": 3600.0 / (ms / 1e3 * len(train)), "losses": losses,
              "launches_per_step": _sparse_launches(model, train=True),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "device_time_per_step": _device_time(torch, lambda: executor.train_step(batches[-1]), ms,
                                                   by_kernel=True)}

    per_forward = _sparse_launches(model)
    _reset_counts()
    t0 = time.perf_counter()
    val_loss = executor._valid_epoch(val)
    record["validation"] = {"batches": len(val), "loss": val_loss, "seconds": time.perf_counter() - t0}
    # its first batch eager, the rest replays of the captured forward
    windows["sparse validation"] = _plus(_read_counts(), _replayed([executor.graphs["valid"]]))
    _reset_counts()
    t0 = time.perf_counter()
    result = executor.evaluate(test)
    record["evaluation"] = {"batches": len(test), "seconds": time.perf_counter() - t0,
                            "masked_MAE": [float(v) for v in result["masked_MAE"]]}
    windows["sparse evaluation"] = _plus(_read_counts(), _replayed([executor.graphs["predict"]]))
    for name, n in (("sparse validation", len(val)), ("sparse evaluation", len(test))):
        if _sparse_counts_of(windows[name]) != {k: v * n for k, v in per_forward.items()}:
            raise AssertionError("{} launched {}, want {} per batch".format(name, windows[name], per_forward))
    if not (math.isfinite(val_loss) and np.isfinite(result["masked_MAE"]).all()):
        raise AssertionError("non-finite sparse validation loss or test metrics")

    cache = os.path.join(args["output_dir"], args["exp_id"], "model_cache",
                         "{}_{}.pt".format(SP_MODEL, SP_DATASET))
    executor.save_model(cache)
    t0 = time.perf_counter()
    service = PredictService.from_experiment(SP_TASK, SP_MODEL, SP_DATASET, other_args=args, max_batch=SP_B)
    record["from_experiment_s"] = time.perf_counter() - t0
    x = test.x[:SP_B].cpu().numpy()
    _reset_counts()
    replies = {b: service.predict(x[:b]) for b in (1, SP_B)}
    windows["sparse serving"] = _read_counts()
    if _sparse_counts_of(windows["sparse serving"]) != {k: 2 * v for k, v in per_forward.items()}:
        raise AssertionError("sparse serving launched {}, want {} per request".format(
            windows["sparse serving"], per_forward))
    with torch.no_grad():
        direct = executor.model(test.x[:SP_B])
    want_y = np.maximum(feature["scaler"].inverse_transform(direct).cpu().numpy(), 0.0)
    for b, y in replies.items():
        if y.shape != (b, 3, graph.padded_nodes, 1) or not np.isfinite(y).all():
            raise AssertionError("bad sparse reply for batch {}: {}".format(b, y.shape))
        np.testing.assert_allclose(y, want_y[:b], rtol=1e-5, atol=1e-4)
    latency = {str(b): _bucket_ms(service, x[:b], reps=5) for b in (1, SP_B)}
    record["serving"] = {"ms_per_request_by_bucket": latency,
                         "device_time_per_request": _device_time(
                             torch, lambda: service.predict(x), latency[str(SP_B)])}
    say(json.dumps({"sparse": record}))
    say("sparse launches per window: " + json.dumps(windows))
    handle = {"executor": executor, "train": train, "val": val, "test": test, "scaler": feature["scaler"]}
    del service, model, dataset, batches
    torch.cuda.empty_cache()
    return windows, handle


def _sparse_counts_of(counts):
    return {k: counts[k] for k in SPARSE_KERNELS}


def _sparse_output(torch, model, batch):
    """The model output on batch X (no autograd), as a host tensor."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        return model(batch["X"].to(dev)).float().cpu()


def _sparse_grads(torch, model, scaler, batch):
    """One step's loss and every parameter gradient, as host tensors."""
    from multistgraph_tpu_torch.ops.losses import make_loss_fn

    dev = next(model.parameters()).device
    b = {k: v.to(dev) for k, v in batch.items()}
    model.zero_grad(set_to_none=True)
    loss = make_loss_fn(model, scaler)(b, train=True)
    loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).float().cpu()
             for n, p in model.named_parameters()}
    return loss.detach().float().cpu(), grads


def _sparse_run(torch, model, scaler, batch):
    """The model output on batch X (no autograd), then one step's loss and
    every parameter gradient, as host tensors."""
    return _sparse_output(torch, model, batch), _sparse_grads(torch, model, scaler, batch)


def _cpu_runs(torch, jobs):
    """_sparse_run of each CPU model of `jobs` ({name: (model, scaler,
    batch)}), its output and its gradients each in a thread of its own
    (the output on a copy of the model): the CPU's f16 matrix products
    take a single-threaded path (about a minute a run at 4,096 nodes on
    the card's host), and its ops release the interpreter lock, so the
    runs overlap. Returns {name: ((output, (loss, gradients)), seconds)}
    once every thread has ended; the seconds are the longer thread's."""
    import copy

    def timed(fn, *args):
        t0 = time.perf_counter()
        return fn(torch, *args), time.perf_counter() - t0

    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // (2 * len(jobs))))   # the cores shared out among the runs
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=2 * len(jobs)) as pool:
            futures = {name: (pool.submit(timed, _sparse_output, copy.deepcopy(model), batch),
                              pool.submit(timed, _sparse_grads, model, scaler, batch))
                       for name, (model, scaler, batch) in jobs.items()}
            out = {}
            for name, (output, grads) in futures.items():
                (o, o_s), (g, g_s) = output.result(), grads.result()
                out[name] = ((o, g), max(o_s, g_s))
            return out
    finally:
        torch.set_num_threads(threads)


def sparse_check_phase(torch):
    """Card vs CPU at 4,096 nodes, same configuration and weights: the model
    output, one step's loss and every gradient; faults planted in each
    kernel must fail the checks."""
    from unittest import mock

    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.models import get_model
    from multistgraph_tpu_torch.ops import spmm as sp

    args = _sparse_args(SP_CHECK_NODES, "chip_smoke_sparse_check")
    cfg = load_config(SP_TASK, SP_MODEL, SP_DATASET, other_args=args)
    dataset = get_dataset(cfg, device="cpu")
    train, _, _ = dataset.get_data()
    feature = dataset.get_data_feature()
    cpu_model = get_model(cfg, feature, device="cpu")
    state_dict = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    card_model = get_model(cfg, feature)
    card_model.load_state_dict(state_dict)
    batch = {"X": train.x[:SP_B], "y": train.y[:SP_B]}
    scaler = feature["scaler"]
    t0 = time.perf_counter()
    cpu_out, cpu_grads = _sparse_run(torch, cpu_model, scaler, batch)
    cpu_s = time.perf_counter() - t0
    card_out, card_grads = _sparse_run(torch, card_model, scaler, batch)
    errs = {"output": _rel_err(card_out.numpy(), cpu_out.numpy()), "gradients": _grad_err(card_grads, cpu_grads)}

    real_forward, real_backward = sp._SpMM.forward, sp._SpMM.backward

    def spmm_row_block_zeroed(ctx, *a):
        y = real_forward(ctx, *a)  # bsr_spmm's output
        y[:128] = 0.0
        return y

    def dv_tile_dropped(ctx, dy):
        dvalues, *rest = real_backward(ctx, dy)
        if dvalues is not None:  # sampled_matmul's dV of an adaptive SpMM
            dvalues[0] = 0.0
        return (dvalues, *rest)

    faults = {"bsr_spmm row block 0 zeroed": mock.patch.object(sp._SpMM, "forward",
                                                               staticmethod(spmm_row_block_zeroed)),
              "sampled_matmul dV tile 0 dropped": mock.patch.object(sp._SpMM, "backward",
                                                                    staticmethod(dv_tile_dropped))}
    controls = {}
    for name, patch in faults.items():
        with patch:
            out, grads = _sparse_run(torch, card_model, scaler, batch)
        controls[name] = {"output": _rel_err(out.numpy(), cpu_out.numpy()),
                          "gradients": _grad_err(grads, cpu_grads)}
    say(json.dumps({"sparse_card_vs_cpu": {"nodes": SP_CHECK_NODES, "tiles": feature["bsr_graph"].nnz_blocks,
                                           "errors": errs, "cpu_seconds": cpu_s},
                    "bounds": {"output": BOUND_SPARSE_OUT, "gradients": BOUND_SPARSE_GRAD},
                    "planted_faults": controls}))
    if not errs["output"] < BOUND_SPARSE_OUT:
        raise AssertionError("sparse output, card vs CPU: {} over {}".format(errs["output"], BOUND_SPARSE_OUT))
    if not errs["gradients"]["max"] < BOUND_SPARSE_GRAD:
        raise AssertionError("sparse gradients, card vs CPU: {} over {}".format(errs["gradients"], BOUND_SPARSE_GRAD))
    if not controls["bsr_spmm row block 0 zeroed"]["output"] > BOUND_SPARSE_OUT:
        raise AssertionError("the planted SpMM fault passes the sparse output check")
    for name, c in controls.items():
        if not c["gradients"]["max"] > BOUND_SPARSE_GRAD:
            raise AssertionError("{} passes the sparse gradient check ({})".format(name, c["gradients"]))
    return errs, controls


# ------------------------------------------------------------------- band
# The band form of the same 49,152-node graph (graph_split 'band', the JAX
# package's fastest trainable form): diagonals -2..2 over 384 row blocks
# (1,914 tiles, 126 MB of f32 planes), the 8 hub columns of the 38,787
# edges left, no COO tail; the adaptive view samples the band's tiles. The
# same model defaults, trained on the planes and served from packed rows
# (graph_band_packed). Widths each kernel takes on the main path:
BAND_B7_WIDTHS = (24, 128, 1536)                 # layer-0 hoist, per-step h and z*h, layer-1 hoist
BAND_B8_WIDTHS = (12, 64, 768, 24, 128, 1536)    # the same at serving buckets 1 and 2
BAND_DX_WIDTHS = (128, 1536)                     # dX of the per-step aggregations and of layer 1's hoist
BAND_DV_WIDTHS = (128, 1536)                     # B9 dV: off the path (the support's values are
                                                 # constants), held at the path's widths
# Card vs CPU at 4,096 nodes in the band form (planes and packed rows), the
# same relative max errors as BOUND_SPARSE_*: 1e-4 until first read; an
# H100 read 5.09e-7 / 3.82e-7 (output, planes / packed) and 7.36e-7 /
# 8.41e-7 (gradients, node_vec2), so the bounds are 3.9x and 4.2x the
# larger readings. The planted faults read 0.041 / 0.421 (output, B7
# without its first diagonal / B8) and 0.995 (gradients, B9 dX); B7's fault
# now drops the main diagonal.
BOUND_BAND_OUT = 2e-6
BOUND_BAND_GRAD = 3.5e-6


def band_kernel_phase(torch):
    """B7, B8, B9 dX and B9 dV vs their plain versions on the 49,152-node
    band at every width the main path gives them, timed, with their bounds
    and one PyTorch library call each (torch.bmm of packed rows against
    overlapping windows of the zero-padded operand), and faults planted
    inside B9 dV's f32 kernel."""
    import numpy as np

    from multistgraph_tpu_torch.ops import band
    from multistgraph_tpu_torch.ops.bsr import random_spatial_graph

    t0 = time.time()
    graph, _ = random_spatial_graph(SP_NODES, 16, seed=0, split="band")
    offsets = tuple(int(o) for o in graph.offsets)
    radius = band.band_radius(offsets)
    nb, n_pad, block = graph.num_row_blocks, graph.padded_nodes, graph.block
    tiles = int(np.any(graph.band_values != 0, axis=(2, 3)).sum())  # the tiles this graph holds
    say("49,152-node band built in {:.1f}s: offsets {}, {} tiles in {} row blocks, {} edges left".format(
        time.time() - t0, offsets, tiles, nb, graph.rest_w.shape[0]))
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    planes = torch.from_numpy(graph.band_values).to(dev)
    packed = torch.from_numpy(band.pack_band_rows(graph.band_values, offsets, radius)).to(dev)
    packed_t = torch.from_numpy(band.pack_band_rows_transposed(graph.band_values, offsets, radius)).to(dev)
    width = (2 * radius + 1) * block
    tile_bytes = tiles * block * block * 4
    lines = []

    def windows(x):
        """(R, W, F) view: the 2 radius + 1 row blocks around each row block of the zero-padded x."""
        feat = x.shape[1]
        xp = torch.nn.functional.pad(x.reshape(nb, block, feat), (0, 0, 0, 0, radius, radius))
        return xp.as_strided((nb, width, feat), (block * feat, feat, 1))

    def row(name, replaces, feat, kernel, plain, library, label, main_path=True, library_check=True):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        # the same f32 products, summed in another order
        _hold(_over_bound(got, want), "{} vs its plain version at F={}".format(name, feat))
        if library_check:  # the yardstick computes the same function
            _hold(_over_bound(library().reshape(want.shape), want, rel=1e-4),
                  "{}'s library call vs its plain version at F={}".format(name, feat))
        # tiles read (or, for dV, written) once, the two (N_pad, F) operands once
        num_bytes = tile_bytes + 2 * n_pad * feat * 4
        flops = 2 * tiles * block * block * feat
        bound, by = _bound_ms(num_bytes, flops, PEAK_F32_FLOPS)
        library_ms, label = _library_ms(torch, library, label)
        lines.append({
            "name": name, "shape": "R={} offsets={} tiles={} F={}".format(nb, offsets, tiles, feat),
            "replaces": replaces, "max_abs_err": (got - want).abs().max().item(),
            "tolerance": "rtol 1e-5, atol 1e-5*max|plain|",
            "kernel_ms": _time_ms(torch, kernel), "plain_ms": _time_ms(torch, plain, reps=10),
            "library_ms": library_ms, "library": label,
            "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "flops": flops, "peak": PEAK_F32_NOTE,
            "main_path": main_path,
        })

    for feat in BAND_B7_WIDTHS:
        x = torch.randn(n_pad, feat, generator=g, device=dev)
        xw = windows(x)
        row("band_spmm", "multistgraph_tpu/ops/band.py:222 band_fwd_pallas", feat,
            lambda: band.band_spmm(planes, offsets, x), lambda: band.band_plain(planes, offsets, x),
            lambda: torch.bmm(packed, xw), "torch.bmm(packed rows, windows of the padded x)")
    for feat in BAND_B8_WIDTHS:
        x = torch.randn(n_pad, feat, generator=g, device=dev)
        xw = windows(x)
        row("band_spmm_packed", "multistgraph_tpu/ops/band.py:352 band_fwd_slab_pallas", feat,
            lambda: band.band_spmm_packed(packed, radius, x), lambda: band.band_packed_plain(packed, radius, x),
            lambda: torch.bmm(packed, xw), "torch.bmm(packed rows, windows of the padded x)")
    for feat in BAND_DX_WIDTHS:
        dy = torch.randn(n_pad, feat, generator=g, device=dev)
        dyw = windows(dy)
        row("band_dx", "multistgraph_tpu/ops/band.py:462 band_dx_pallas", feat,
            lambda: band.band_dx(planes, offsets, dy), lambda: band.band_dx_plain(planes, offsets, dy),
            lambda: torch.bmm(packed_t, dyw), "torch.bmm(transposed packed rows, windows of the padded dy)")
    faults = {}
    for feat in BAND_DV_WIDTHS:
        x = torch.randn(n_pad, feat, generator=g, device=dev)
        dy = torch.randn(n_pad, feat, generator=g, device=dev)
        xw, dyb = windows(x), dy.reshape(nb, block, feat)
        row("band_dv", "multistgraph_tpu/ops/band.py:405 band_dv_pallas", feat,
            lambda: band.band_dv(dy, x, offsets), lambda: band.band_dv_plain(dy, x, offsets),
            lambda: torch.bmm(dyb, xw.transpose(1, 2)), "torch.bmm(dy blocks, windows of the padded x transposed)",
            main_path=False, library_check=False)
        # faults planted inside dV's f32 kernel, on the planes and on packed rows
        for what, run, plain in (
                ("planes", lambda: band.band_dv(dy, x, offsets), lambda: band.band_dv_plain(dy, x, offsets)),
                ("packed", lambda: band.band_dv_packed(dy, x, radius),
                 lambda: band.band_dv_packed_plain(dy, x, radius))):
            want = plain()
            for kind in sorted(band.FAULTS):
                with band.planted_fault(kind):
                    bad = run()
                faults["band_dv F={} {}: {}".format(feat, what, kind)] = _over_bound(bad, want)
                del bad
            del want
    del planes, packed, packed_t
    torch.cuda.empty_cache()
    for line in lines:
        say(json.dumps(line))
    say(json.dumps({"band_f32_planted_faults_over_bound": faults}))
    for fault, ratio in faults.items():
        if not ratio > 1.0:
            raise AssertionError("{} passes its check ({:.3g} of the bound)".format(fault, ratio))
    return lines


def band_phase(torch):
    """SparseATGCN's band form at 49,152 nodes: training on the planes
    through get_executor with exact launch counts per step, one validation
    and one evaluation pass, then the saved experiment served from packed
    rows through from_experiment at buckets 1 and 2 (B8, no B7), its replies
    held against the planes'."""
    import numpy as np

    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.executor import get_executor
    from multistgraph_tpu_torch.models import get_model
    from multistgraph_tpu_torch.ops.band import BandGraph
    from multistgraph_tpu_torch.serving import PredictService

    args = dict(_sparse_args(SP_NODES, "chip_smoke_band"), graph_split="band")
    cfg = load_config(SP_TASK, SP_MODEL, SP_DATASET, other_args=args)
    t0 = time.time()
    dataset = get_dataset(cfg)
    train, val, test = dataset.get_data()
    feature = dataset.get_data_feature()
    graph = feature["bsr_graph"]
    if not isinstance(graph, BandGraph):
        raise AssertionError("graph_split='band' gave a {}".format(type(graph).__name__))
    setup = {"dataset_s": time.time() - t0, "nodes": graph.num_nodes, "padded": graph.padded_nodes,
             "offsets": [int(o) for o in graph.offsets], "edges_left": int(graph.rest_w.shape[0]),
             "train_batches": len(train), "val_batches": len(val), "test_batches": len(test)}
    model = get_model(cfg, feature)
    executor = get_executor(cfg, model, feature)
    if (model.hidden_dim, model.num_layers, model.embed_dim_adj, model.remat, model.has_adaptive,
            model.adaptive_softmax, cfg["batch_size"], cfg["input_window"]) != (
            SP_H, 2, 16, True, True, "sampled", SP_B, SP_T):
        raise AssertionError("the band configuration is not the defaults' full width")
    setup["support"] = {n: list(b.shape) for n, b in model.named_buffers()}
    setup["model_s"] = time.time() - t0 - setup["dataset_s"]
    say(json.dumps({"band_setup": setup}))

    windows = {}
    perm = train.epoch_permutation()
    batches = [executor.batch(train, idx) for idx in perm[: SP_WARMUP + SP_STEPS]]
    torch.cuda.reset_peak_memory_stats()
    losses = [float(executor.train_step(b)) for b in batches[:SP_WARMUP]]
    torch.cuda.synchronize()
    _reset_counts()
    timed, marks = [], [time.perf_counter()]
    for b in batches[SP_WARMUP:]:
        timed.append(executor.train_step(b))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    windows["band training"] = _read_counts()
    want = dict(dict.fromkeys(windows["band training"], 0), **_sparse_launches(model, SP_STEPS, train=True))
    if windows["band training"] != want:
        raise AssertionError("{} band training steps launched {}, want {}".format(
            SP_STEPS, windows["band training"], want))
    losses += [float(v) for v in timed]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite band training loss: {}".format(losses))
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    ms = statistics.median(step_ms)
    record = {"steps": SP_STEPS, "batch": SP_B, "ms_per_step": ms, "step_ms": step_ms,
              "epochs_per_hour": 3600.0 / (ms / 1e3 * len(train)), "losses": losses,
              "launches_per_step": {k: v for k, v in _sparse_launches(model, train=True).items() if v},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "device_time_per_step": _device_time(torch, lambda: executor.train_step(batches[-1]), ms,
                                                   by_kernel=True)}

    per_forward = _sparse_launches(model)
    _reset_counts()
    t0 = time.perf_counter()
    val_loss = executor._valid_epoch(val)
    record["validation"] = {"batches": len(val), "loss": val_loss, "seconds": time.perf_counter() - t0}
    windows["band validation"] = _plus(_read_counts(), _replayed([executor.graphs["valid"]]))
    _reset_counts()
    t0 = time.perf_counter()
    result = executor.evaluate(test)
    record["evaluation"] = {"batches": len(test), "seconds": time.perf_counter() - t0,
                            "masked_MAE": [float(v) for v in result["masked_MAE"]]}
    windows["band evaluation"] = _plus(_read_counts(), _replayed([executor.graphs["predict"]]))
    for name, n in (("band validation", len(val)), ("band evaluation", len(test))):
        if _sparse_counts_of(windows[name]) != {k: v * n for k, v in per_forward.items()}:
            raise AssertionError("{} launched {}, want {} per batch".format(name, windows[name], per_forward))
    if not (math.isfinite(val_loss) and np.isfinite(result["masked_MAE"]).all()):
        raise AssertionError("non-finite band validation loss or test metrics")

    cache = os.path.join(args["output_dir"], args["exp_id"], "model_cache",
                         "{}_{}.pt".format(SP_MODEL, SP_DATASET))
    executor.save_model(cache)
    t0 = time.perf_counter()
    service = PredictService.from_experiment(SP_TASK, SP_MODEL, SP_DATASET,
                                             other_args=dict(args, graph_band_packed=True), max_batch=SP_B)
    record["from_experiment_s"] = time.perf_counter() - t0
    if not hasattr(service.model, "support0_band_packed") or hasattr(service.model, "support0_band_values"):
        raise AssertionError("the served band model does not hold packed rows only")
    x = test.x[:SP_B].cpu().numpy()
    served_per_forward = _sparse_launches(service.model)
    _reset_counts()
    replies = {b: service.predict(x[:b]) for b in (1, SP_B)}
    windows["band serving"] = _read_counts()
    if _sparse_counts_of(windows["band serving"]) != {k: 2 * v for k, v in served_per_forward.items()} \
            or windows["band serving"]["band_spmm"] or not windows["band serving"]["band_spmm_packed"]:
        raise AssertionError("packed band serving launched {}, want {} per request".format(
            windows["band serving"], served_per_forward))
    with torch.no_grad():
        planes_out = executor.model(test.x[:SP_B])  # the plane form, the same weights
    want_y = np.maximum(feature["scaler"].inverse_transform(planes_out).cpu().numpy(), 0.0)
    for b, y in replies.items():
        if y.shape != (b, 3, graph.padded_nodes, 1) or not np.isfinite(y).all():
            raise AssertionError("bad packed band reply for batch {}: {}".format(b, y.shape))
        # planes and packed rows: the same products summed in another order
        np.testing.assert_allclose(y, want_y[:b], rtol=1e-5, atol=1e-4)
    record["packed_vs_planes_max_abs"] = max(float(np.abs(y - want_y[:b]).max()) for b, y in replies.items())
    latency = {str(b): _bucket_ms(service, x[:b], reps=5) for b in (1, SP_B)}
    record["serving"] = {"ms_per_request_by_bucket": latency,
                         "device_time_per_request": _device_time(
                             torch, lambda: service.predict(x), latency[str(SP_B)])}
    say(json.dumps({"band": record}))
    say("band launches per window: " + json.dumps(windows))
    del executor, service, model, dataset, train, val, test, batches
    torch.cuda.empty_cache()
    return windows


def _band_check_forms(torch, label, overrides):
    """The band check's models at 4,096 nodes: (feature, batch, the card
    models by form, the CPU jobs by form for _cpu_runs)."""
    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.models import get_model

    args = dict(_sparse_args(SP_CHECK_NODES, "chip_smoke_{}_check".format(label.replace(" ", "_"))),
                graph_split="band", **overrides)
    dataset = get_dataset(load_config(SP_TASK, SP_MODEL, SP_DATASET, other_args=args), device="cpu")
    train, _, _ = dataset.get_data()
    feature = dataset.get_data_feature()
    batch = {"X": train.x[:SP_B], "y": train.y[:SP_B]}
    models, cpu_models = {}, {}
    for form, packed in (("planes", False), ("packed", True)):
        cfg = load_config(SP_TASK, SP_MODEL, SP_DATASET, other_args=dict(args, graph_band_packed=packed))
        cpu_model = get_model(cfg, feature, device="cpu")
        if models:  # the planes model's weights
            cpu_model.load_state_dict(models["planes"].state_dict())
        card_model = get_model(cfg, feature)
        card_model.load_state_dict(cpu_model.state_dict())
        models[form], cpu_models[form] = card_model, (cpu_model, feature["scaler"], batch)
    return feature, batch, models, cpu_models


def band_check_phase(torch, label="band", bound_out=BOUND_BAND_OUT, bound_grad=BOUND_BAND_GRAD, prepared=None,
                     **overrides):
    """Card vs CPU at 4,096 nodes in the band form, on planes and on packed
    rows, same configuration and weights: the model output, one step's loss
    and every gradient; a fault planted in each band kernel of the path must
    fail its check. `overrides` change the configuration (the bf16 phase's
    compute_dtype and adpadj), `label` names the record. `prepared`: the
    forms of _band_check_forms with their CPU runs already taken, (forms,
    timed runs), where a caller ran them beside its own."""
    from unittest import mock

    from multistgraph_tpu_torch.ops import band

    if prepared is None:
        forms = _band_check_forms(torch, label, overrides)
        prepared = (forms[:3] + (None,), _cpu_runs(torch, forms[3]))
        del forms   # the CPU models are done with
    (feature, batch, models, _), timed_runs = prepared
    scaler = feature["scaler"]
    cpu_runs = {form: run for form, (run, _) in timed_runs.items()}
    errs = {}
    del prepared
    for form, card_model in models.items():
        out, grads = _sparse_run(torch, card_model, scaler, batch)
        errs[form] = {"output": _rel_err(out.numpy(), cpu_runs[form][0].numpy()),
                      "gradients": _grad_err(grads, cpu_runs[form][1]), "cpu_seconds": timed_runs[form][1]}

    real_forward, real_backward = band._BandSpMM.forward, band._BandSpMM.backward

    def diagonal_dropped(ctx, values, x, offsets, radius):  # B7 skips the main diagonal
        keep = [i for i, o in enumerate(offsets) if o != 0]
        return real_forward(ctx, values[keep], x, tuple(offsets[i] for i in keep), radius)

    def slot_zeroed(ctx, values, x, offsets, radius):  # B8 skips the main diagonal's slot
        values = values.clone()
        values[:, :, radius * 128:(radius + 1) * 128] = 0.0
        return real_forward(ctx, values, x, offsets, radius)

    def row_block_zeroed(ctx, dy):  # B9 dX loses row block 0
        dvalues, dx, *rest = real_backward(ctx, dy)
        if dx is not None:
            dx[:128] = 0.0
        return (dvalues, dx, *rest)

    def patch(fn, which="forward"):
        return mock.patch.object(band._BandSpMM, which, staticmethod(fn))

    faults = {"B7 main diagonal dropped": ("planes", "output", patch(diagonal_dropped)),
              "B9 dX row block 0 zeroed": ("planes", "gradients", patch(row_block_zeroed, "backward")),
              "B8 slot zeroed": ("packed", "output", patch(slot_zeroed))}
    controls = {}
    for name, (form, _, fault) in faults.items():
        with fault:
            out, grads = _sparse_run(torch, models[form], scaler, batch)
        controls[name] = {"output": _rel_err(out.numpy(), cpu_runs[form][0].numpy()),
                          "gradients": _grad_err(grads, cpu_runs[form][1])}
    say(json.dumps({label + " card vs CPU": {"nodes": SP_CHECK_NODES, "config": overrides,
                                             "offsets": [int(o) for o in feature["bsr_graph"].offsets],
                                             "errors": errs},
                    "bounds": {"output": bound_out, "gradients": bound_grad},
                    "planted_faults": controls}))
    for form, e in errs.items():
        if not e["output"] < bound_out:
            raise AssertionError("{} {} output, card vs CPU: {} over {}".format(label, form, e["output"], bound_out))
        if not e["gradients"]["max"] < bound_grad:
            raise AssertionError("{} {} gradients, card vs CPU: {} over {}".format(
                label, form, e["gradients"], bound_grad))
    for name, (_, check, _) in faults.items():
        err = controls[name][check] if check == "output" else controls[name][check]["max"]
        if not err > (bound_out if check == "output" else bound_grad):
            raise AssertionError("{} passes the {} {} check ({})".format(name, label, check, err))
    return errs, controls


# ----------------------------------------------------------- sparse, bf16
# SparseATGCN in bf16 at 49,152 nodes: the sparse defaults above (hidden 64,
# 2 layers, T=12, batch 2, the unidirectional adaptive view with the sampled
# softmax, remat) with compute_dtype 'bfloat16', the JAX package's headline
# sparse configuration (docs/DESIGN.md:122, "bf16 with the adaptive view"),
# on the BSR form and on the band's planes. Widths the bf16 BSR kernels take
# on those paths:
SPB_SPMM_WIDTHS = (12, 16, 24, 64, 128, 768, 1536)  # bucket-1 layer-0 hoist, sddmm dE, layer-0 hoist,
#                                                     bucket-1 step, step, bucket-1 layer-1 hoist, layer-1 hoist
SPB_DX_WIDTHS = (128, 1536)                # transposed (dX) of the per-step aggregations and of layer 1's hoist
SPB_B5_WIDTHS = (16, 24, 128, 1536)        # forward scores, then the adaptive dV at each training width
SPB_STEPS = 5                              # timed bf16 training steps (after SP_WARMUP)
# widths at which each fault planted in the bf16 kernels must fail the hold:
# x by element loads (F=12) and by TMA (F=128); B5 at d = 16 and 24 (the
# second k16 slice half past d)
SPB_FAULT_WIDTHS, SPB_B5_FAULT_WIDTHS = (12, 128), (16, 24)
# bsr_spmm's bf16 form against its plain version: both sum exact products of
# bf16 values in f32, so the f32 rule (rtol 1e-5, atol 1e-5 max|plain|)
# held at first; an H100 read 1.17 of it on the transposed graph at
# F=1536 (hub rows of 384 tiles: 49,152 products a sum, in the tensor
# cores' own f32 accumulation), 0.82 at F=128 and at most 0.009 forward, so
# the bound is rtol 4e-5 (3.4x that reading).
SPB_SPMM_REL = 4e-5
# Card vs CPU at 4,096 nodes in bf16 (the BSR, hub and tail forms, and the
# band's planes and packed rows with the adaptive view), relative max errors
# as BOUND_BF16_*: both sides round to bf16 at every op, in other orders.
BOUND_SPARSE_BF16_OUT = 3e-2
BOUND_SPARSE_BF16_GRAD = 1.5e-2


def _bf16_spmm_design(feat, ty="bf16"):
    from multistgraph_tpu_torch.ops.spmm import x_load_path

    n = next((n for n in (16, 24, 32, 64, 128) if feat <= n), 256)
    loads = x_load_path(feat)
    if loads == "one bulk copy a chunk":
        loads += " (64 contiguous rows, issued two chunks ahead) moved into place by four producer warps"
    return ("tensor cores: wgmma m64n{}k16 {}->f32, f32 sums stored once; the row's tiles in K=64 chunks by TMA as "
            "K-major A; x's block col_of[p] by {} as MN-major B, under the 128-byte swizzle; a producer warp and an "
            "mbarrier ring; two consumer warpgroups of 64 rows").format(n, ty, loads)


def _b5_design(d, ty="bf16"):
    from multistgraph_tpu_torch.ops.spmm import bf16_load_path

    common = ("tensor cores: wgmma m64n128k16 {}->f32 per tile over d in K=64 chunks, a[row_of] and bt[col_of] "
              "K-major under the 128-byte swizzle by {}; a producer warp and a two-stage mbarrier ring; ").format(
                  ty, bf16_load_path(d))
    if ty != "f16":
        return common + "one block per tile, two an SM; bf16 tiles staged per warp for 16-byte stores"
    if d <= 128:  # csrc/sampled_matmul.cu: where the ring's two stages hold a tile's operands
        return common + ("persistent blocks, one an SM, the next tiles' chunks loading while a tile leaves; f32 tiles "
                         "staged in two 64 KB stagings (four boxes of 32 columns by 64 rows a warpgroup, 128-byte "
                         "swizzle) and stored by TMA")
    return common + "one block per tile, two an SM; f32 tiles stored from the registers, 32 bytes a lane quad"


def sparse_bf16_kernel_phase(torch, ty="bf16"):
    """bsr_spmm (B4/B6) and sampled_matmul (B5) in bf16 (or, with ty 'f16',
    in f16) against their plain versions on the 49,152-node graph at every
    width the bf16 (f16) paths give them, timed beside their bounds and a
    PyTorch library call each; the faults planted in both kernels must fail
    the holds. B5's f16 form writes f32 tiles, held as B4/B6's f32 sums."""
    from multistgraph_tpu_torch.ops import spmm as sp
    from multistgraph_tpu_torch.ops.bsr import random_spatial_graph

    half = ty == "f16"
    dtype = torch.float16 if half else torch.bfloat16
    spmm_widths, b5_widths = (SPH_SPMM_WIDTHS, SPH_B5_WIDTHS) if half else (SPB_SPMM_WIDTHS, SPB_B5_WIDTHS)
    graph, _ = random_spatial_graph(SP_NODES, 16, seed=0)
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    nb, nnz, n_pad = graph.num_row_blocks, graph.nnz_blocks, graph.padded_nodes
    values = torch.from_numpy(graph.values).to(dev).to(dtype)
    row = torch.from_numpy(graph.row_of).to(dev)
    col = torch.from_numpy(graph.col_of).to(dev)
    row_ptr = sp.row_ptr_of(row, nb)
    tile_bytes = nnz * 128 * 128 * 2
    index_bytes = (2 * nnz + nb + 1) * 4
    lines, faults = [], {}

    def randn(feat):
        return torch.randn(n_pad, feat, generator=g, device=dev).to(dtype)

    def spmm_hold(got, want):
        return _over_bound(got, want, rel=SPB_SPMM_REL)

    def b5_hold(got, want):  # bf16 tiles within one bf16 step; f16's f32 tiles as f32 sums
        return spmm_hold(got, want) if half else _over_bound(got, want, bf16_step=True)

    def spmm_rows(values, row, row_ptr, col, schedule, widths, what, fault_kinds, fault_widths):
        try:
            bsr = torch.sparse_bsr_tensor(row_ptr, col, values, size=(n_pad, n_pad))
        except (RuntimeError, TypeError) as exc:
            bsr = exc
        for feat in widths:
            x = randn(feat)
            got = sp.bsr_spmm(values, row, row_ptr, col, x, nb, schedule)
            want = sp.spmm_plain(values, row, col, x, out_blocks=nb)
            torch.cuda.synchronize()
            _hold(spmm_hold(got, want), "bsr_spmm {} vs its plain version at F={}{}".format(ty, feat, what))
            if feat in fault_widths:
                if not torch.equal(got, sp.bsr_spmm(values, row, row_ptr, col, x, nb, schedule)):
                    raise AssertionError("bsr_spmm {} at F={}{}: two calls differ".format(ty, feat, what))
                for kind in fault_kinds:
                    with sp.planted_fault(kind, "bsr_spmm"):
                        bad = sp.bsr_spmm(values, row, row_ptr, col, x, nb, schedule)
                    faults["bsr_spmm F={}{} ({}): {}".format(feat, what, sp.x_load_path(feat), kind)] = spmm_hold(
                        bad, want)
                    del bad
            max_abs_err = (got - want).abs().max().item()
            del got, want
            num_bytes = tile_bytes + index_bytes + n_pad * feat * (2 + 4)
            flops = 2 * nnz * 128 * 128 * feat
            bound, by = _bound_ms(num_bytes, flops, PEAK_BF16_FLOPS)
            label = "torch.sparse_bsr_tensor(row_ptr, col_of, values) @ x in {}".format(ty)
            if isinstance(bsr, Exception):
                library_ms, library = None, "{} refused: {}".format(label, str(bsr).splitlines()[0][:160])
            else:
                library_ms, library = _library_ms(torch, lambda: bsr @ x, label)
            if library_ms is None:
                xg = x.reshape(-1, 128, feat).index_select(0, col)
                library_ms = _time_ms(torch, lambda: torch.bmm(values, xg), reps=10)
                library = ("torch.bmm of the tiles and the pre-gathered x blocks in {} (the gather and the row sums "
                           "not timed; {})".format(ty, library))
                del xg
            stream = feat % 128 == 0  # the width JAX sends to spmm_stream (B6), else the block-grid kernel (B4)
            lines.append({
                "name": "bsr_spmm_" + ty, "shape": "N={} nnz={} F={} {}{}".format(n_pad, nnz, feat, ty, what),
                "replaces": ("multistgraph_tpu/ops/spmm_stream.py:303 spmm_stream" if stream
                             else "multistgraph_tpu/ops/spmm.py:87 _spmm_blockgrid"),
                "design": _bf16_spmm_design(feat, ty), "loads": sp.x_load_path(feat),
                "max_abs_err": max_abs_err,
                "tolerance": "rtol {0:g}, atol {0:g}*max|plain| (f32 sums)".format(SPB_SPMM_REL),
                "kernel_ms": _time_ms(torch, lambda: sp.bsr_spmm(values, row, row_ptr, col, x, nb, schedule)),
                "plain_ms": _time_ms(torch, lambda: sp.spmm_plain(values, row, col, x, out_blocks=nb), reps=10),
                "library_ms": library_ms, "library": library,
                "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "flops": flops, "peak": PEAK_NOTE,
                "main_path": True,
            })
            del x

    spmm_rows(values, row, row_ptr, col, sp.bsr_schedule(row_ptr, nnz, exact=True), spmm_widths, "",
              sorted(sp.FAULTS), SPB_FAULT_WIDTHS)
    # the backward's dX on the block-transposed graph (hub rows of up to 384
    # tiles, split into segments); its split rows must catch the segment fault
    v_t, r_t, c_t = sp.bsr_transpose(values, row, col, nb)
    ptr_t, sched_t = sp.bsr_transpose_schedule(row, col, nb, exact=True)
    say(json.dumps({"bsr_schedule {} transposed".format(ty): _schedule_summary(torch, sched_t)}))
    spmm_rows(v_t, r_t, ptr_t, c_t, sched_t, SPB_DX_WIDTHS, " transposed (backward dX)", sorted(sp.SPMM_FAULTS),
              (128,))
    del v_t
    for d in b5_widths:
        a, bt = randn(d), randn(d)
        got = sp.sampled_matmul(a, bt, row, col)
        want = sp.sampled_matmul_plain(a, bt, row, col)
        torch.cuda.synchronize()
        _hold(b5_hold(got, want), "sampled_matmul {} vs its plain version at d={}".format(ty, d))
        if not torch.equal(got, sp.sampled_matmul(a, bt, row, col)):
            raise AssertionError("sampled_matmul {} at d={}: two calls differ".format(ty, d))
        if d in SPB_B5_FAULT_WIDTHS:
            for kind in sp.FAULTS:
                with sp.planted_fault(kind, "sampled_matmul"):
                    bad = sp.sampled_matmul(a, bt, row, col)
                faults["sampled_matmul {} d={} ({}): {}".format(ty, d, sp.bf16_load_path(d), kind)] = b5_hold(
                    bad, want)
                del bad
        max_abs_err = (got.float() - want.float()).abs().max().item()
        del got, want
        # 16-bit operands; bf16 tiles, or f32 tiles for f16
        num_bytes = 2 * n_pad * d * 2 + 2 * nnz * 4 + tile_bytes * (2 if half else 1)
        flops = 2 * nnz * 128 * 128 * d
        bound, by = _bound_ms(num_bytes, flops, PEAK_BF16_FLOPS)
        a_t = a.reshape(-1, 128, d).index_select(0, row)
        b_t = bt.reshape(-1, 128, d).index_select(0, col)
        bmm16_ms = _time_ms(torch, lambda: torch.bmm(a_t, b_t.transpose(1, 2)), reps=10)
        bmm16 = "torch.bmm of the pre-gathered row blocks in {} ({} out; the gathers not timed)".format(ty, ty)
        extra = {}
        if half:  # the call that computes B5 f16's function writes f32 tiles, twice the f16-out call's bytes
            library_ms, library = _library_ms(
                torch, lambda: torch.bmm(a_t, b_t.transpose(1, 2), out_dtype=torch.float32),
                "torch.bmm(a_t, b_t^T, out_dtype=torch.float32) of the pre-gathered row blocks in f16 (f32 "
                "tiles, the kernel's function; the gathers not timed)")
            if library_ms is None:  # this torch has no f32-out bmm of f16: the f16-out call bounds it from below
                library_ms, library = bmm16_ms, "{}: a lower bound of the library's time ({})".format(bmm16, library)
            extra = {"library_f16_out_ms": bmm16_ms, "library_f16_out": bmm16}
        else:
            library_ms, library = bmm16_ms, bmm16
        lines.append({
            "name": "sampled_matmul_" + ty, "shape": "N={} nnz={} d={} {}".format(n_pad, nnz, d, ty),
            "replaces": "multistgraph_tpu/ops/spmm.py:129 _sampled_matmul_impl",
            "design": _b5_design(d, ty), "loads": sp.bf16_load_path(d), "max_abs_err": max_abs_err,
            "tolerance": ("rtol {0:g}, atol {0:g}*max|plain| (f32 tiles); two calls bit-identical".format(
                SPB_SPMM_REL) if half else "one bf16 step: 2^-7 |plain| + 2^-7 * 1e-3 max|plain|; two calls "
                "bit-identical"),
            "kernel_ms": _time_ms(torch, lambda: sp.sampled_matmul(a, bt, row, col)),
            "plain_ms": _time_ms(torch, lambda: sp.sampled_matmul_plain(a, bt, row, col), reps=10),
            "library_ms": library_ms, "library": library, **extra,
            "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "flops": flops, "peak": PEAK_NOTE,
            "main_path": True,
        })
        del a, bt, a_t, b_t
    del values
    torch.cuda.empty_cache()
    for line in lines:
        say(json.dumps(line))
    say(json.dumps({"sparse_{}_planted_faults_over_bound".format(ty): faults}))
    for fault, ratio in faults.items():
        if not ratio > 1.0:
            raise AssertionError("{} passes its check ({:.3g} of the bound)".format(fault, ratio))
    return lines


def _bsr_widths(fn):
    """{'<entry> F=<width>': launches} of the bsr_spmm launches that fn makes."""
    from multistgraph_tpu_torch.ops import spmm

    run, seen = spmm._run, collections.Counter()

    def recording(name, entry, tensors, ints, device):
        if name == "bsr_spmm":
            seen["{} F={}".format(entry, ints[1])] += 1
        return run(name, entry, tensors, ints, device)

    spmm._run = recording
    try:
        fn()
    finally:
        spmm._run = run
    return dict(sorted(seen.items()))


def sparse_bf16_phase(torch, split, ty="bf16"):
    """SparseATGCN in bf16 (or, with ty 'f16', in f16) at 49,152 nodes with
    the adaptive view, on the BSR form (split 'none') or the band's planes
    ('band'): 2 warm-up and 5 timed training steps through get_executor
    with exact launch counts, one validation pass, and the saved experiment
    served through from_experiment at buckets 1 and 2 (in f16 the band form
    from packed rows: B8, no B7); device busy time, idle share and peak
    memory; in f16 also one more step with the range of every f16 product
    watched (_f16_range) and its gradients held finite. The bf16 band run's
    windows are keyed 'band bf16 ...', with the 1M path's, so its band
    launches count as bf16 ones; the f16 ones have counters of their own."""
    import numpy as np

    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.executor import get_executor
    from multistgraph_tpu_torch.models import get_model
    from multistgraph_tpu_torch.serving import PredictService

    half = ty == "f16"
    dtype, name = (torch.float16, "float16") if half else (torch.bfloat16, "bfloat16")
    bound_out = BOUND_SPARSE_F16_OUT if half else BOUND_SPARSE_BF16_OUT
    label = "sparse " + ty if split == "none" else "band {} adaptive 49k".format(ty)
    args = dict(_sparse_args(SP_NODES, "chip_smoke_" + label.replace(" ", "_")), graph_split=split,
                compute_dtype=name)
    cfg = load_config(SP_TASK, SP_MODEL, SP_DATASET, other_args=args)
    t0 = time.time()
    dataset = get_dataset(cfg)
    train, val, test = dataset.get_data()
    feature = dataset.get_data_feature()
    graph = feature["bsr_graph"]
    setup = {"split": split, "dataset_s": time.time() - t0, "nodes": graph.num_nodes, "padded": graph.padded_nodes,
             "train_batches": len(train), "val_batches": len(val)}
    model = get_model(cfg, feature)
    executor = get_executor(cfg, model, feature)
    if (model.compute_dtype, model.hidden_dim, model.num_layers, model.embed_dim_adj, model.remat,
            model.has_adaptive, model.adaptive_softmax, cfg["batch_size"], cfg["input_window"]) != (
            dtype, SP_H, 2, 16, True, True, "sampled", SP_B, SP_T):
        raise AssertionError("the {} configuration is not the defaults' full width in {}".format(label, ty))
    setup["support"] = {n: [list(b.shape), str(b.dtype)] for n, b in model.named_buffers()}
    setup["model_s"] = time.time() - t0 - setup["dataset_s"]
    say(json.dumps({label + " setup": setup}))

    windows = {}
    batches = [executor.batch(train, idx) for idx in train.epoch_permutation()[: SP_WARMUP + SPB_STEPS]]
    per_step = _sparse_launches(model, train=True)
    torch.cuda.reset_peak_memory_stats()
    ms, losses, windows[label + " training"], step_ms = _timed_steps(torch, executor, batches, SP_WARMUP, per_step)
    record = {"steps": SPB_STEPS, "batch": SP_B, "ms_per_step": ms, "step_ms": step_ms,
              "epochs_per_hour": 3600.0 / (ms / 1e3 * len(train)), "losses": losses,
              "launches_per_step": {k: v for k, v in per_step.items() if v},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "device_time_per_step": _device_time(torch, lambda: executor.train_step(batches[-1]), ms,
                                                   by_kernel=True)}
    if half:
        record["f16_range"] = _f16_range(torch, model, feature["scaler"], batches[-1])

    per_forward = _sparse_launches(model)
    _reset_counts()
    t0 = time.perf_counter()
    val_loss = executor._valid_epoch(val)
    record["validation"] = {"batches": len(val), "loss": val_loss, "seconds": time.perf_counter() - t0}
    windows[label + " validation"] = _plus(_read_counts(), _replayed([executor.graphs["valid"]]))
    if _sparse_counts_of(windows[label + " validation"]) != {k: v * len(val) for k, v in per_forward.items()}:
        raise AssertionError("{} validation launched {}, want {} per batch".format(
            label, windows[label + " validation"], per_forward))
    if not math.isfinite(val_loss):
        raise AssertionError("non-finite {} validation loss".format(label))

    cache = os.path.join(args["output_dir"], args["exp_id"], "model_cache", "{}_{}.pt".format(SP_MODEL, SP_DATASET))
    executor.save_model(cache)
    t0 = time.perf_counter()
    packed = half and split == "band"   # the f16 band form serves from packed rows
    service = PredictService.from_experiment(SP_TASK, SP_MODEL, SP_DATASET, max_batch=SP_B,
                                             other_args=dict(args, graph_band_packed=packed))
    record["from_experiment_s"] = time.perf_counter() - t0
    if service.model.compute_dtype != dtype:
        raise AssertionError("the served {} model does not compute in {}".format(label, ty))
    x = test.x[:SP_B].cpu().numpy()
    per_request = _sparse_launches(service.model)
    _reset_counts()
    replies = {b: service.predict(x[:b]) for b in (1, SP_B)}
    windows[label + " serving"] = _read_counts()
    if split == "none":  # the widths of one bucket-1 request's bsr_spmm launches (F=12: the x by one bulk copy)
        eager = PredictService(service.model, service.scaler, max_batch=SP_B)
        eager.graphed = False   # a replay calls no wrapper
        record["bsr_spmm_launches_by_width_bucket_1"] = _bsr_widths(lambda: eager.predict(x[:1]))
    if _sparse_counts_of(windows[label + " serving"]) != {k: 2 * v for k, v in per_request.items()} \
            or (packed and not windows[label + " serving"]["band_spmm_packed_f16"]):
        raise AssertionError("{} serving launched {}, want {} per request".format(
            label, windows[label + " serving"], per_request))
    with torch.no_grad():
        direct = executor.model(test.x[:SP_B])
    want_y = np.maximum(feature["scaler"].inverse_transform(direct).cpu().numpy(), 0.0)
    errs = {}
    for b, y in replies.items():
        if y.shape != (b, 3, graph.padded_nodes, 1) or not np.isfinite(y).all():
            raise AssertionError("bad {} reply for batch {}: {}".format(label, b, y.shape))
        # bucket 2 is the same call (in f16 on packed rows, B8 in place of
        # B7); bucket 1 rounds its narrower products otherwise
        errs[b] = _rel_err(y, want_y[:b])
        if not errs[b] < bound_out:
            raise AssertionError("{} reply at bucket {} differs from the executor's model by {}".format(
                label, b, errs[b]))
    record["replies_vs_executor_rel"] = errs
    latency = {str(b): _bucket_ms(service, x[:b], reps=5) for b in (1, SP_B)}
    record["serving"] = {"ms_per_request_by_bucket": latency,
                         "device_time_per_request": _device_time(
                             torch, lambda: service.predict(x), latency[str(SP_B)])}
    say(json.dumps({label: record}))
    say("{} launches per window: {}".format(label, json.dumps(windows)))
    handle = {"executor": executor, "train": train, "val": val, "test": test, "scaler": feature["scaler"]}
    del service, model, dataset, batches
    torch.cuda.empty_cache()
    return windows, handle


# ------------------------------------------------------------ sparse graphs
SPG_REPLAYS = 3          # replayed steps held against as many eager steps from one state
SPG_EAGER_RUNS = 3       # eager re-runs from one state: the gap that atomic sums would leave between them
SPG_TIMED = 10           # replays timed (after 3), and graphed requests per bucket
SPG_VAL_BATCHES = 4      # validation batches held against eager ones
SPG_EAGER_REQUESTS = 5   # eager requests timed per bucket
# the forms the phase replays: the sparse phases' executors, and the bf16
# tail form, which no other phase trains at 49k (built here)
SPG_FORMS = ("sparse", "sparse bf16", "band bf16 adaptive 49k", "sparse f16", "band f16 adaptive 49k",
             "tail bf16 49k")


def _named(counts):
    """Launch counts keyed as executor/graphs.launch_counters() keys them,
    under the names of ``_counters`` (every name present)."""
    from multistgraph_tpu_torch.executor.graphs import launch_counters

    names = {(id(fn), attr): name for name, (fn, attr) in _counters().items()}
    counters = launch_counters()
    out = dict.fromkeys(_counters(), 0)
    for key, count in counts.items():
        fn, attr = counters[key]
        out[names[(id(fn), attr)]] += count
    return out


def _train_state(torch, model, optimizer):
    """The parameters of `model` and the optimizer's state tensors, in a
    fixed order, by group."""
    params = list(model.parameters())
    state = [v for p in params for _, v in sorted(optimizer.state.get(p, {}).items()) if isinstance(v, torch.Tensor)]
    return {"params": params, "adam": state}


def _copy_state(torch, state):
    return {group: [t.detach().clone() for t in tensors] for group, tensors in state.items()}


def _load_state(torch, state, saved):
    """Write `saved` into the tensors of `state` in place: the captured
    steps keep reading the same tensors."""
    with torch.no_grad():
        for group, tensors in state.items():
            for t, v in zip(tensors, saved[group]):
                t.copy_(v)


def _max_gap(torch, a, b):
    """{group: the largest |a - b| over its values}; a and b map each group
    to a list of tensors, arrays or floats."""
    import numpy as np

    def gap(x, y):
        if isinstance(x, torch.Tensor):
            return float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
        return float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())

    return {group: max((gap(x, y) for x, y in zip(a[group], b[group])), default=0.0) for group in a}


def _hold_replay(torch, what, replay, eager_runs):
    """The replay against the first eager run, each group within 2x the
    largest gap between any two eager runs from the same state (bit for bit
    where the eager runs agree bit for bit); returns the gaps."""
    eager_gap = {group: 0.0 for group in replay}
    for a, b in itertools.combinations(eager_runs, 2):
        eager_gap = {g: max(v, _max_gap(torch, a, b)[g]) for g, v in eager_gap.items()}
    got = _max_gap(torch, replay, eager_runs[0])
    out = {"eager_runs": len(eager_runs), "eager_gap": eager_gap, "replay_vs_eager": got,
           "bit_for_bit": not any(eager_gap.values())}
    if any(got[g] > 2.0 * eager_gap[g] for g in got):
        raise AssertionError("{}: the replay differs from the eager run by more than 2x the gap between eager "
                             "runs: {}".format(what, out))
    return out


def _sparse_graph_form(torch, label, executor, train, val, test, scaler):
    """One form's executor and service graphs at 49,152 nodes (see
    sparse_graph_phase). Returns (record, window)."""
    from multistgraph_tpu_torch.executor.executor import GRAPH_WARMUP_STEPS
    from multistgraph_tpu_torch.executor.optimizers import get_learning_rate
    from multistgraph_tpu_torch.serving import PredictService

    ex, model = executor, executor.model
    if not (ex.graphs_train and ex.graphs_forward):
        raise AssertionError("{}: the executor does not capture SparseATGCN's steps".format(label))
    ex.drop_graphs()   # the phase's validation and evaluation graphs
    per_step = {k: v for k, v in _sparse_launches(model, train=True).items() if v}
    per_forward = {k: v for k, v in _sparse_launches(model).items() if v}
    lr = get_learning_rate(ex.optimizer)
    perm = train.epoch_permutation()
    warm = _Rows(train, perm[:GRAPH_WARMUP_STEPS])
    steps = _Rows(train, perm[GRAPH_WARMUP_STEPS:GRAPH_WARMUP_STEPS + SPG_REPLAYS])
    record = {"launches_per_step": per_step}
    _reset_counts()
    graphs = []

    # 3 replayed steps against 3 eager steps from the same state (after the
    # executor's 2 eager warm-up steps), and SPG_EAGER_RUNS eager re-runs from it
    ex.train_epoch(warm, lr)
    state = _train_state(torch, model, ex.optimizer)
    start = _copy_state(torch, state)
    eager_counts = _read_counts()
    got = ex.train_epoch(steps, lr)
    graph = ex.graphs["train"]
    graphs.append(graph)
    replay = dict(_copy_state(torch, state), loss=[got])
    if _read_counts() != eager_counts:
        raise AssertionError("{}: the capture or a replay bumped a launch counter".format(label))
    captured = {k: v for k, v in _named(graph.captured).items() if v}
    if captured != per_step or graph.replays != SPG_REPLAYS:
        raise AssertionError("{}: the captured step recorded {}, the eager step launches {}".format(
            label, captured, per_step))
    runs, eager_ms, rows = [], [], steps.epoch_permutation()
    for k in range(SPG_EAGER_RUNS):
        _load_state(torch, state, start)
        before = _read_counts()
        losses = []
        eager_ms += _ms_each(torch, lambda i: losses.append(ex.train_step(ex.batch(train, rows[i]))), SPG_REPLAYS)
        if k == 0 and _sparse_counts_of(_plus(_read_counts(), {n: -v for n, v in before.items()})) != {
                n: SPG_REPLAYS * per_step.get(n, 0) for n in SPARSE_KERNELS}:
            raise AssertionError("{}: {} eager steps launched other counts than {} each".format(
                label, SPG_REPLAYS, per_step))
        runs.append(dict(_copy_state(torch, state), loss=[float(torch.stack(losses).mean())]))
    record["train_replay_vs_eager"] = _hold_replay(torch, label + " training", replay, runs)

    # timing: the median of SPG_TIMED replays after 3, eager steps from the runs
    # above; one replay's and one eager step's device time
    idx = torch.as_tensor(perm, device=ex.device)
    _ms_each(torch, lambda i: graph.run(idx=idx[i]), 3)
    replay_ms = _ms_each(torch, lambda i: graph.run(idx=idx[3 + i % (len(idx) - 3)]), SPG_TIMED)
    ms, ms_eager = statistics.median(replay_ms), statistics.median(eager_ms)
    dev = _device_time(torch, lambda: graph.run(idx=idx[0]), ms)
    batch0 = ex.batch(train, perm[0])
    dev_eager = _device_time(torch, lambda: ex.train_step(batch0), ms_eager)
    record.update({"replayed_ms_per_step": ms, "replay_step_ms": replay_ms, "eager_ms_per_step": ms_eager,
                   "eager_step_ms": eager_ms,
                   "replay_device": {k: dev[k] for k in ("device_busy_ms", "device_idle_share", "device_ops")},
                   "eager_device": {k: dev_eager[k] for k in ("device_busy_ms", "device_idle_share",
                                                              "device_ops")},
                   "replay_top": dev["top"]})

    # validation on its first batches: the capture (first batch eager), then
    # every batch a replay, against eager passes
    rows = _Rows(val, val.ordered_permutation()[:SPG_VAL_BATCHES])
    ex._valid_epoch(rows)
    got = ex._valid_epoch(rows)
    graphs.append(ex.graphs["valid"])
    runs = [{"loss": [_eager_validation(torch, ex, rows)]} for _ in range(SPG_EAGER_RUNS)]
    record["validation_replay_vs_eager"] = _hold_replay(torch, label + " validation", {"loss": [got]}, runs)
    captured = {k: v for k, v in _named(ex.graphs["valid"].captured).items() if v}
    if captured != per_forward:
        raise AssertionError("{}: the validation graph recorded {}, want {}".format(label, captured, per_forward))

    # requests at buckets 1 and 2: a capture, then replies held against eager ones
    svc = PredictService(model, scaler, max_batch=SP_B)
    ref = PredictService(model, scaler, max_batch=SP_B)
    ref.graphed = False
    x = test.x[:SP_B].cpu().numpy()
    record["requests"] = {}
    for b in (1, SP_B):
        runs = [{"reply": [ref.predict(x[:b])]} for _ in range(SPG_EAGER_RUNS)]
        svc.predict(x[:b])
        hold = _hold_replay(torch, "{} request at bucket {}".format(label, b), {"reply": [svc.predict(x[:b])]}, runs)
        captured = {k: v for k, v in _named(svc.graphs[b].captured).items() if v}
        if captured != per_forward:
            raise AssertionError("{}: bucket {} recorded {}, want {}".format(label, b, captured, per_forward))
        record["requests"][str(b)] = {"graphed_ms": _bucket_ms(svc, x[:b], SPG_TIMED),
                                      "eager_ms": _bucket_ms(ref, x[:b], SPG_EAGER_REQUESTS),
                                      "replay_vs_eager": hold}
    share = _device_time(torch, lambda: svc.predict(x), record["requests"][str(SP_B)]["graphed_ms"])
    record["requests"]["device_bucket_{}".format(SP_B)] = {k: share[k] for k in ("device_busy_ms",
                                                                                 "device_idle_share")}
    graphs += list(svc.graphs.values())
    window = _plus(_read_counts(), _replayed(graphs))
    ex.drop_graphs()
    return record, window


def _tail_bf16_handle(torch):
    """The bf16 tail form at 49,152 nodes with the adaptive view: the
    executor and loaders the other forms' phases build for theirs."""
    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.executor import get_executor
    from multistgraph_tpu_torch.models import get_model
    from multistgraph_tpu_torch.ops.hybrid import TailGraph

    args = dict(_sparse_args(SP_NODES, "chip_smoke_tail_bf16"), graph_split="tail", compute_dtype="bfloat16")
    cfg = load_config(SP_TASK, SP_MODEL, SP_DATASET, other_args=args)
    dataset = get_dataset(cfg)
    train, val, test = dataset.get_data()
    feature = dataset.get_data_feature()
    if not isinstance(feature["bsr_graph"], TailGraph):
        raise AssertionError("graph_split='tail' gave a {}".format(type(feature["bsr_graph"]).__name__))
    model = get_model(cfg, feature)
    if (model.compute_dtype, model.hidden_dim, model.has_adaptive, model.remat, cfg["batch_size"]) != (
            torch.bfloat16, SP_H, True, True, SP_B) or "tail_w" not in model._support(0):
        raise AssertionError("the tail form is not the defaults' full width in bf16 with a tail")
    return {"executor": get_executor(cfg, model, feature), "train": train, "val": val, "test": test,
            "scaler": feature["scaler"]}


def sparse_graph_phase(torch, handles):
    """SparseATGCN's steps as CUDA graphs at 49,152 nodes, on the executors
    (model, weights and optimizer state as their phases left them) and
    loaders of the f32 BSR, bf16 BSR, bf16 band planes, f16 BSR and f16
    band planes phases, all with the adaptive view, and of the bf16 tail
    form, built here. For each: 3 replayed steps of ``train_epoch`` against
    3 eager steps from the same state, bit for bit where SPG_EAGER_RUNS eager re-runs
    from that state agree bit for bit, else within 2x their largest gap
    (atomic sums), by loss, parameters and Adam's
    state; the captured step's launches equal to the eager per-step
    counts; the median of SPG_TIMED
    replays beside the eager steps, with one replay's and one eager step's
    busy time and idle share; a graphed validation pass on 4 batches and
    requests at buckets 1 and 2 held to eager ones in the same way.
    Returns the windows: eager launches plus every replay's."""
    import gc

    handles["tail bf16 49k"] = _tail_bf16_handle(torch)
    windows, record = {}, {}
    for label in SPG_FORMS:
        record[label], windows[label + " graphs"] = _sparse_graph_form(torch, label, **handles.pop(label))
        say(json.dumps({"sparse graph": label, **record[label]}))
        gc.collect()
        torch.cuda.empty_cache()
    say(json.dumps({"sparse graph summary (ms per step: replayed, eager; idle: replay, eager)": {
        label: [r["replayed_ms_per_step"], r["eager_ms_per_step"], r["replay_device"]["device_idle_share"],
                r["eager_device"]["device_idle_share"], r["train_replay_vs_eager"]["bit_for_bit"]]
        for label, r in record.items()}}))
    say("sparse graph launches per window: " + json.dumps({k: {n: c for n, c in w.items() if c}
                                                            for k, w in windows.items()}))
    return windows


def sparse_bf16_check_phase(torch, ty="bf16"):
    """Card vs CPU at 4,096 nodes in bf16 (or, with ty 'f16', in f16) with
    the adaptive view: the model output, one step's loss (finite) and every
    gradient on the BSR, hub and tail forms, faults planted inside B4/B6 and
    B5 (on the BSR form) failing the checks; then the band's planes and
    packed rows (band_check_phase, faults in B7, B8 and B9 dX). In f16 the
    tail form runs twice on the card, and the two runs' difference is
    printed: 0 since its sums run in a fixed order (ops/hybrid.spmm_tail's
    `order`), where index_add_'s atomics changed them from run to run. The
    CPU runs of all five forms (BSR, hub, tail, band planes and packed
    rows) run at once (_cpu_runs)."""
    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.models import get_model
    from multistgraph_tpu_torch.ops import spmm as sp

    half = ty == "f16"
    name = "float16" if half else "bfloat16"
    bound_out, bound_grad = ((BOUND_SPARSE_F16_OUT, BOUND_SPARSE_F16_GRAD) if half
                             else (BOUND_SPARSE_BF16_OUT, BOUND_SPARSE_BF16_GRAD))
    errs, controls, cpu_s = {}, {}, {}
    faults = {"B4/B6 row block 0 zeroed": ("row", "bsr_spmm"), "B4/B6 k16 slice dropped": ("k16", "bsr_spmm"),
              "B4/B6 last tile of each row skipped": ("tile", "bsr_spmm"),
              "B5 k16 slice dropped": ("k16", "sampled_matmul"),
              "B5 row block 0's tiles zeroed": ("row", "sampled_matmul")}
    forms = {}
    for split in ("none", "hub", "tail"):
        args = dict(_sparse_args(SP_CHECK_NODES, "chip_smoke_sparse_{}_check".format(ty)), graph_split=split,
                    compute_dtype=name)
        cfg = load_config(SP_TASK, SP_MODEL, SP_DATASET, other_args=args)
        dataset = get_dataset(cfg, device="cpu")
        train, _, _ = dataset.get_data()
        feature = dataset.get_data_feature()
        cpu_model = get_model(cfg, feature, device="cpu")
        card_model = get_model(cfg, feature)
        card_model.load_state_dict(cpu_model.state_dict())
        forms[split] = (cpu_model, card_model, feature, {"X": train.x[:SP_B], "y": train.y[:SP_B]})
    # the band form's CPU runs beside these: every CPU run of the check at once
    band_label, band_overrides = "band {} adaptive".format(ty), dict(compute_dtype=name, adpadj="unidirection")
    band_forms = _band_check_forms(torch, band_label, band_overrides)
    cpu_runs = _cpu_runs(torch, dict({split: (f[0], f[2]["scaler"], f[3]) for split, f in forms.items()},
                                     **{"band " + form: job for form, job in band_forms[3].items()}))
    band_runs = {form: cpu_runs.pop("band " + form) for form in band_forms[3]}
    band_forms = band_forms[:3] + (None,)   # the CPU models are done with
    for split, (cpu_model, card_model, feature, batch) in forms.items():
        scaler = feature["scaler"]
        (cpu_out, cpu_grads), cpu_s[split] = cpu_runs[split]
        out, grads = _sparse_run(torch, card_model, scaler, batch)
        if not (math.isfinite(float(grads[0])) and math.isfinite(float(cpu_grads[0]))):
            raise AssertionError("{} {} loss is not finite: card {}, CPU {}".format(ty, split, grads[0], cpu_grads[0]))
        errs[split] = {"graph": type(feature["bsr_graph"]).__name__, "output": _rel_err(out.numpy(), cpu_out.numpy()),
                       "gradients": _grad_err(grads, cpu_grads)}
        if half and split == "tail":
            again, again_grads = _sparse_run(torch, card_model, scaler, batch)
            errs[split]["card_run_to_run"] = {"output": _rel_err(again.numpy(), out.numpy()),
                                              "gradients": _grad_err(again_grads, grads)}
        if split == "none":
            for fault, (kind, kernel) in faults.items():
                with sp.planted_fault(kind, kernel):
                    out, grads = _sparse_run(torch, card_model, scaler, batch)
                controls[fault] = {"output": _rel_err(out.numpy(), cpu_out.numpy()),
                                   "gradients": _grad_err(grads, cpu_grads)}
    del forms, cpu_runs
    say(json.dumps({"sparse {} card vs CPU".format(ty): {"nodes": SP_CHECK_NODES, "errors": errs,
                                                         "cpu_seconds": cpu_s},
                    "bounds": {"output": bound_out, "gradients": bound_grad},
                    "planted_faults": controls}))
    for split, e in errs.items():
        if not e["output"] < bound_out:
            raise AssertionError("{} {} output, card vs CPU: {} over {}".format(ty, split, e["output"], bound_out))
        if not e["gradients"]["max"] < bound_grad:
            raise AssertionError("{} {} gradients, card vs CPU: {} over {}".format(ty, split, e["gradients"],
                                                                                   bound_grad))
    for fault, c in controls.items():
        if not (c["output"] > bound_out or c["gradients"]["max"] > bound_grad):
            raise AssertionError("{} passes both {} checks ({})".format(fault, ty, c))
    band = band_check_phase(torch, label=band_label, bound_out=bound_out, bound_grad=bound_grad,
                            prepared=(band_forms, band_runs), **band_overrides)
    return errs, controls, band


# ----------------------------------------------------------- sparse, f16
# SparseATGCN with compute_dtype 'float16' at 49,152 nodes: the bf16
# phases' configuration (the defaults' full width, the adaptive view) in
# f16, which JAX passes through to the same kernels, on the BSR form and on
# the band's planes, the band served from packed rows. Widths the f16
# kernels take on those paths (the SDDMM's dE at F = 16 runs the f32
# bsr_spmm, its dS being f32; the band's are BAND_*_WIDTHS):
SPH_SPMM_WIDTHS = (12, 24, 64, 128, 768, 1536)   # SPB_SPMM_WIDTHS but F = 16
SPH_B5_WIDTHS = SPB_B5_WIDTHS
SPH_BAND_FAULT_WIDTHS = (12, 24, 128)            # x by element loads (12) and by TMA
F16_STEP = 2.0 ** -10                            # one f16 step: 11 significant bits
# B9 dV f16 sums F = 1536 products a tile entry (B7, B8, dX at most 640):
# there the tensor cores' f32 accumulation, off the plain version's f32
# sums by about 1e-6 of the largest entry, shows at one f16 step's floor
# (2^-10 * 1e-3 = 9.8e-7 of it): an H100 read 1.14 of the step alone at
# F = 1536. Its f16 hold adds the f32 rule of its sums (rtol 1e-5, atol
# 1e-5 max|plain|, the f32 kernels' hold) to the step.
F16_DV_SUMS_REL = 1e-5
# Card vs CPU at 4,096 nodes in f16, relative max errors as BOUND_BF16_*.
# An H100 read 1.04e-3 for the output on the BSR, hub and tail forms (one
# f16 step of the largest output, 2^-10) and 1.12e-2 / 1.43e-2 / 1.43e-2
# for the gradients, node_vec2's each time: the adaptive embeddings'
# gradients sum softmax terms that cancel (ROADMAP.md §C), and the tail
# form's two card runs differed from each other by as much (1.04e-3 and
# 1.43e-2, while its index_add_ added atomically; 0 since its sums run in a
# fixed order). The bounds
# are 2.9x and 2.8x the largest readings; the planted faults read at least
# 0.125 (output) and 0.459 (gradients).
BOUND_SPARSE_F16_OUT = 3e-3
BOUND_SPARSE_F16_GRAD = 4e-2


def _f16_range(torch, model, scaler, batch):
    """One forward and backward of the f16 model on `batch` with the range of
    every sparse product watched: bsr_spmm and sampled_matmul return f32,
    which their callers cast to f16 (but for the SDDMM's scores, which the
    softmax takes in f32), so for each, by caller, the outputs that the cast
    takes to +-inf and the nonzero sums it takes to 0; the band kernels
    return f16, so their +-inf outputs and the nonzero sums of the same
    kernel's f32 form on the widened operands that came out 0. Raises unless
    the loss and every gradient are finite. Returns the tallies by kernel
    and operand dtype."""
    from unittest import mock

    from multistgraph_tpu_torch.ops import band
    from multistgraph_tpu_torch.ops import spmm as sp

    stats = {}

    def tally(key, out, f32):
        """out as the path keeps it (f16), f32 the sums before the rounding."""
        st = stats.setdefault(key, {"calls": 0, "outputs": 0, "nonzero": 0, "inf": 0, "nonzero_to_zero": 0})
        st["calls"] += 1
        st["outputs"] += out.numel()
        st["nonzero"] += int((f32 != 0).sum())
        st["inf"] += int(torch.isinf(out).sum())
        st["nonzero_to_zero"] += int(((f32 != 0) & (out == 0)).sum())

    def f32_out(module, name):
        real = getattr(module, name)

        @functools.wraps(real)   # the wrapper's launch counters too: the wrapped function counts on them
        def watched(*args, **kwargs):
            out = real(*args, **kwargs)
            ty = "f16" if any(isinstance(a, torch.Tensor) and a.dtype == torch.float16 for a in args) else "f32"
            # by caller: the SpMM's forward and backward and the SDDMM's
            # backward cast the result to f16; the SDDMM's scores stay f32
            tally("{} {} in {}".format(name, ty, sys._getframe(1).f_code.co_qualname), out.half(), out)
            return out
        return mock.patch.object(module, name, watched)

    def f16_out(name):
        real = getattr(band, name)

        @functools.wraps(real)
        def watched(*args, **kwargs):
            out = real(*args, **kwargs)
            wide = [a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.float16 else a for a in args]
            tally(name + " f16", out, real(*wide, **kwargs))
            return out
        return mock.patch.object(band, name, watched)

    patches = [f32_out(sp, "bsr_spmm"), f32_out(sp, "sampled_matmul")]
    patches += [f16_out(name) for name in ("band_spmm", "band_spmm_packed", "band_dx", "band_dx_packed")]
    for p in patches:
        p.start()
    try:
        _, (loss, grads) = _sparse_run(torch, model, scaler, batch)
    finally:
        for p in patches:
            p.stop()
    bad = [n for n, g in grads.items() if not torch.isfinite(g).all()]
    if not math.isfinite(float(loss)) or bad:
        raise AssertionError("f16 step: loss {}, non-finite gradients {}".format(float(loss), bad))
    return {"loss": float(loss), "gradients_finite": True, "products": stats}


def sparse_f16_kernel_phase(torch):
    """The f16 kernels against their plain versions at every width of the
    f16 paths: bsr_spmm (B4/B6) and sampled_matmul (B5) on the 49,152-node
    graph (sparse_bf16_kernel_phase in f16), then B7, B8, B9 dX and B9 dV on
    its band (_f16_band_rows); faults planted in each must fail its hold."""
    return sparse_bf16_kernel_phase(torch, "f16") + _f16_band_rows(torch)


def _f16_band_rows(torch):
    """B7, B8, B9 dX and B9 dV in f16 on the 49,152-node band at every width
    the f16 path gives them (BAND_*_WIDTHS), within one f16 step of their
    plain versions, timed beside their bounds and an f16 torch.bmm library
    call each; each fault the kernels plant must fail the hold, and each
    row reports its +-inf outputs and the nonzero f32 sums it rounded to 0."""
    import numpy as np

    from multistgraph_tpu_torch.ops import band
    from multistgraph_tpu_torch.ops.bsr import random_spatial_graph

    graph, _ = random_spatial_graph(SP_NODES, 16, seed=0, split="band")
    offsets = tuple(int(o) for o in graph.offsets)
    radius = band.band_radius(offsets)
    nb, n_pad, block = graph.num_row_blocks, graph.padded_nodes, graph.block
    tiles = int(np.any(graph.band_values != 0, axis=(2, 3)).sum())
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(12)
    planes = torch.from_numpy(graph.band_values).to(dev).half()
    packed = band.pack_band_rows(planes, offsets, radius)
    packed_t = band.pack_band_rows_transposed(planes, offsets, radius)
    width = (2 * radius + 1) * block
    lines, faults = [], {}

    def windows(x):
        feat = x.shape[1]
        xp = torch.nn.functional.pad(x.reshape(nb, block, feat), (0, 0, 0, 0, radius, radius))
        return xp.as_strided((nb, width, feat), (block * feat, feat, 1))

    def row(name, replaces, feat, kernel, plain, wide, library, label, main_path=True):
        def f16_step(got, want):
            return _over_bound(got, want, step=F16_STEP, sums_rel=F16_DV_SUMS_REL if name == "band_dv" else 0.0)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        # the same exact products summed in f32 in another order, then rounded once
        _hold(f16_step(got, want), "{} f16 vs its plain version at F={}".format(name, feat))
        sums = wide()  # the f32 sums before the rounding
        rng = {"inf": int(torch.isinf(got).sum()), "nonzero_to_zero": int(((sums != 0) & (got == 0)).sum()),
               "outputs": got.numel()}
        max_abs_err = (got.float() - want.float()).abs().max().item()
        if feat in SPH_BAND_FAULT_WIDTHS:  # each fault the kernel can plant must fail the same check
            for kind in band.FAULTS:
                with band.planted_fault(kind):
                    bad = kernel()
                faults["{} f16 F={} ({}): {}".format(name, feat, _band_loads(band, name, feat), kind)] = f16_step(
                    bad, want)
                del bad
        del got, want, sums
        num_bytes = tiles * block * block * 2 + 2 * n_pad * feat * 2
        flops = 2 * tiles * block * block * feat
        bound, by = _bound_ms(num_bytes, flops, PEAK_BF16_FLOPS)
        library_ms, label = _library_ms(torch, library, label)
        lines.append({
            "name": name + "_f16", "shape": "R={} offsets={} tiles={} F={} f16".format(nb, offsets, tiles, feat),
            "design": _band_design(band, name, feat, "f16"), "loads": _band_loads(band, name, feat),
            "replaces": replaces, "max_abs_err": max_abs_err, "f16_range": rng,
            "tolerance": "one f16 step: 2^-10 |plain| + 2^-10 * 1e-3 max|plain|" + (
                ", + 1e-5 (|plain| + max|plain|) for the f32 sums" if name == "band_dv" else ""),
            "kernel_ms": _time_ms(torch, kernel), "plain_ms": _time_ms(torch, plain, reps=10),
            "library_ms": library_ms, "library": label,
            "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "flops": flops, "peak": PEAK_NOTE,
            "main_path": main_path,
        })

    def randn(feat):
        return torch.randn(n_pad, feat, generator=g, device=dev).half()

    lib_label = "torch.bmm(packed rows, windows of the padded x) in f16"
    for feat in BAND_B7_WIDTHS:
        x = randn(feat)
        xw = windows(x)
        row("band_spmm", "multistgraph_tpu/ops/band.py:222 band_fwd_pallas", feat,
            lambda: band.band_spmm(planes, offsets, x), lambda: band.band_plain(planes, offsets, x),
            lambda: band.band_spmm(planes.float(), offsets, x.float()), lambda: torch.bmm(packed, xw), lib_label)
    for feat in BAND_B8_WIDTHS:
        x = randn(feat)
        xw = windows(x)
        row("band_spmm_packed", "multistgraph_tpu/ops/band.py:352 band_fwd_slab_pallas", feat,
            lambda: band.band_spmm_packed(packed, radius, x), lambda: band.band_packed_plain(packed, radius, x),
            lambda: band.band_spmm_packed(packed.float(), radius, x.float()), lambda: torch.bmm(packed, xw),
            lib_label)
    for feat in BAND_DX_WIDTHS:
        dy = randn(feat)
        dyw = windows(dy)
        row("band_dx", "multistgraph_tpu/ops/band.py:462 band_dx_pallas", feat,
            lambda: band.band_dx(planes, offsets, dy), lambda: band.band_dx_plain(planes, offsets, dy),
            lambda: band.band_dx(planes.float(), offsets, dy.float()), lambda: torch.bmm(packed_t, dyw),
            "torch.bmm(transposed packed rows, windows of the padded dy) in f16")
    for feat in BAND_DV_WIDTHS:
        x, dy = randn(feat), randn(feat)
        xw, dyb = windows(x), dy.reshape(nb, block, feat)
        row("band_dv", "multistgraph_tpu/ops/band.py:405 band_dv_pallas", feat,
            lambda: band.band_dv(dy, x, offsets), lambda: band.band_dv_plain(dy, x, offsets),
            lambda: band.band_dv(dy.float(), x.float(), offsets), lambda: torch.bmm(dyb, xw.transpose(1, 2)),
            "torch.bmm(dy blocks, windows of the padded x transposed) in f16", main_path=False)
    del planes, packed, packed_t
    torch.cuda.empty_cache()
    for line in lines:
        say(json.dumps(line))
    say(json.dumps({"band_f16_planted_faults_over_bound": faults}))
    for fault, ratio in faults.items():
        if not ratio > 1.0:
            raise AssertionError("{} passes its check ({:.3g} of the bound)".format(fault, ratio))
    return lines


# ------------------------------------------------------------- band, bf16
# SparseATGCN in bf16 on the band form at 1,000,000 nodes: the JAX package's
# 1M training and serving configuration (BASELINE.json config 5; its
# tools/bench_large_graph.py `1000000 16 8 1 band --dtype bf16 --adpadj
# none`), here at the defaults' T = 12 and batch 2, hidden 64, 2 layers,
# remat, through the port's bench_large_graph: diagonals -2..2 over 7,813
# row blocks (1.28 GB of bf16 planes), 8 hub columns, no COO tail, no
# adaptive view. Widths each band kernel takes on that path:
BF_ARGV = ["1000000", "16", "12", "2", "band", "--dtype", "bf16", "--adpadj", "none"]
BF_T, BF_B = 12, 2
BF_STEPS, BF_CALLS = 5, 3                        # timed training steps and serving calls per bucket
BF_B7_WIDTHS = (24, 128, 1536)                   # layer-0 hoist T*B, per-step B*H, layer-1 hoist T*B*H
BF_B8_WIDTHS = (12, 64, 768, 24, 128, 1536)      # the same at serving buckets 1 and 2
BF_DX_WIDTHS = (128, 1536)                       # dX of the per-step aggregations and of layer 1's hoist
BF_DV_WIDTHS = (128, 1536)                       # B9 dV: off the path (constant values), held at its widths
# widths at which each fault the bf16 kernels can plant must fail the check:
# F=12 takes x by element loads, F=24 and 128 by TMA
BF_FAULT_WIDTHS = (12, 24, 128)
# The plain versions run on 128-column slices of x (the same function,
# column by column): at F = 1536 their f32 stack of windows would be 30.7 GB.
BF_PLAIN_COLUMNS = 128
# the probe tool's shapes (tools/probe_band_stream.py): P1 C=4 b=128 W=384
# F=128, P3 one window of 640 rows, P2 R=8192 radius 2 F=128 chunk_rows 8
PROBE_ROWS, PROBE_RADIUS, PROBE_FEAT, PROBE_CHUNK = 8192, 2, 128, 8
# Card vs CPU at 4,096 nodes in bf16 (planes and packed rows), relative max
# errors as BOUND_BAND_*: both sides round to bf16 at every op, the card's
# sums (kernels, cuBLAS) in other orders, so a last-bit difference moves a
# bf16 rounding by one step (2^-8) and the recurrence carries it on. An
# H100 read 8.77e-3 (output) and 3.32e-3 (gradients, l1_update_pool), the
# same on planes and packed rows, so the bounds are 3.4x and 4.5x those
# readings. The planted faults read 0.346 (output, B8 main slot zeroed) and
# 0.085 / 0.737 (gradients, B9 dX row block 0 / B8); B7 without its first
# diagonal (-4, sparse at 4,096 nodes) read only 0.038, so the B7 fault
# drops the main diagonal.
BOUND_BF16_OUT = 3e-2
BOUND_BF16_GRAD = 1.5e-2


def _bf16_kernel_rows(torch, graph):
    """B7, B8, B9 dX and B9 dV in bf16 against their plain versions on the
    1M band at every width the path gives them, within one bf16 step,
    timed beside their bounds and a bf16 torch.bmm library call each."""
    from multistgraph_tpu_torch.ops import band

    offsets = tuple(int(o) for o in graph.offsets)
    radius = band.band_radius(offsets)
    nb, n_pad, block = graph.num_row_blocks, graph.padded_nodes, graph.block
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    planes = torch.from_numpy(graph.band_values).to(dev)
    tiles = int((planes != 0).any(dim=3).any(dim=2).sum())  # the tiles this graph holds
    planes = planes.bfloat16()
    packed = band.pack_band_rows(planes, offsets, radius)
    packed_t = band.pack_band_rows_transposed(planes, offsets, radius)
    width = (2 * radius + 1) * block
    lines, faults = [], {}

    def windows(x):
        feat = x.shape[1]
        xp = torch.nn.functional.pad(x.reshape(nb, block, feat), (0, 0, 0, 0, radius, radius))
        return xp.as_strided((nb, width, feat), (block * feat, feat, 1))

    def by_columns(fn, *xs):
        """fn on 128-column slices of its (N_pad, F) operands, concatenated."""
        feat = xs[0].shape[1]
        return torch.cat([fn(*(a[:, c:c + BF_PLAIN_COLUMNS].contiguous() for a in xs))
                          for c in range(0, feat, BF_PLAIN_COLUMNS)], dim=1)

    def dv_by_columns(fn, dy, x):
        """dV summed over 128-column slices in f32, rounded once to bf16."""
        total = None
        for c in range(0, x.shape[1], BF_PLAIN_COLUMNS):
            part = fn(dy[:, c:c + BF_PLAIN_COLUMNS].contiguous(), x[:, c:c + BF_PLAIN_COLUMNS].contiguous())
            total = part if total is None else total + part
        return total.to(torch.bfloat16)

    def row(name, replaces, feat, kernel, plain, library, label, main_path=True, plant=False):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        # the same exact products summed in f32 in another order, then rounded once
        _hold(_bf16_step(got, want), "{} bf16 vs its plain version at F={}".format(name, feat))
        max_abs_err = (got.float() - want.float()).abs().max().item()
        if plant:  # each fault the kernel can plant must fail the same check
            for kind in band.FAULTS:
                with band.planted_fault(kind):
                    bad = kernel()
                faults["{} F={} ({}): {}".format(name, feat, _band_loads(band, name, feat), kind)] = _bf16_step(
                    bad, want)
                del bad
        del got, want
        num_bytes = tiles * block * block * 2 + 2 * n_pad * feat * 2
        flops = 2 * tiles * block * block * feat
        bound, by = _bound_ms(num_bytes, flops, PEAK_BF16_FLOPS)
        library_ms, label = _library_ms(torch, library, label)
        lines.append({
            "name": name, "bf16_path": True, "shape": "R={} offsets={} tiles={} F={} bf16".format(
                nb, offsets, tiles, feat),
            "design": _band_design(band, name, feat), "loads": _band_loads(band, name, feat),
            "replaces": replaces, "max_abs_err": max_abs_err,
            "tolerance": "one bf16 step: 2^-7 |plain| + 2^-7 * 1e-3 max|plain|",
            "kernel_ms": _time_ms(torch, kernel), "plain_ms": _time_ms(torch, plain, reps=10),
            "library_ms": library_ms, "library": label,
            "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "flops": flops, "peak": PEAK_NOTE,
            "main_path": main_path,
        })

    def randn(feat):
        return torch.randn(n_pad, feat, generator=g, device=dev).bfloat16()

    lib_label = "torch.bmm(packed rows, windows of the padded x) in bf16"
    for feat in BF_B7_WIDTHS:
        x = randn(feat)
        xw = windows(x)
        row("band_spmm", "multistgraph_tpu/ops/band.py:222 band_fwd_pallas", feat,
            lambda: band.band_spmm(planes, offsets, x),
            lambda: by_columns(lambda xc: band.band_plain(planes, offsets, xc), x),
            lambda: torch.bmm(packed, xw), lib_label, plant=feat in BF_FAULT_WIDTHS)
    for feat in BF_B8_WIDTHS:
        x = randn(feat)
        xw = windows(x)
        row("band_spmm_packed", "multistgraph_tpu/ops/band.py:352 band_fwd_slab_pallas", feat,
            lambda: band.band_spmm_packed(packed, radius, x),
            lambda: by_columns(lambda xc: band.band_packed_plain(packed, radius, xc), x),
            lambda: torch.bmm(packed, xw), lib_label, plant=feat in BF_FAULT_WIDTHS)
    for feat in BF_DX_WIDTHS:
        dy = randn(feat)
        dyw = windows(dy)
        row("band_dx", "multistgraph_tpu/ops/band.py:462 band_dx_pallas", feat,
            lambda: band.band_dx(planes, offsets, dy),
            lambda: by_columns(lambda dc: band.band_dx_plain(planes, offsets, dc), dy),
            lambda: torch.bmm(packed_t, dyw), "torch.bmm(transposed packed rows, windows of the padded dy) in bf16",
            plant=feat in BF_FAULT_WIDTHS)
    for feat in BF_DV_WIDTHS:
        x, dy = randn(feat), randn(feat)
        xw, dyb = windows(x), dy.reshape(nb, block, feat)
        row("band_dv", "multistgraph_tpu/ops/band.py:405 band_dv_pallas", feat,
            lambda: band.band_dv(dy, x, offsets),
            lambda: dv_by_columns(lambda dc, xc: band.band_dv_plain(dc, xc, offsets, out_dtype=torch.float32), dy, x),
            lambda: torch.bmm(dyb, xw.transpose(1, 2)), "torch.bmm(dy blocks, windows of the padded x transposed) in bf16",
            main_path=False, plant=feat in BF_FAULT_WIDTHS)
    del planes, packed, packed_t
    torch.cuda.empty_cache()
    for fault, ratio in faults.items():
        if not ratio > 1.0:
            raise AssertionError("{} passes its check ({:.3g} of the bound)".format(fault, ratio))
    return lines, tiles, faults


def _band_loads(band, name, feat):
    """How the 16-bit band kernel takes x (dV: dy and x) at width feat, on
    the smoke's 16-byte aligned operands."""
    return band.bf16_load_path(feat) if name == "band_dv" else band.x_load_path(feat)


def _band_design(band, name, feat, ty="bf16"):
    """What the 16-bit band kernel runs at width feat (csrc/band_spmm.cu)."""
    loads = _band_loads(band, name, feat)
    if name == "band_dv":
        return ("tensor cores: wgmma m64n128k16 {}->f32 per (slot, row block) tile over F in K=64 chunks, dy[r] "
                "and x[r+o] K-major under the 128-byte swizzle by {}; one block per row block; a producer warp and "
                "an mbarrier ring; tiles staged per warp for 16-byte stores").format(ty, loads)
    n = next((n for n in (16, 24, 32, 64, 128) if feat <= n), 256)
    return ("tensor cores: wgmma m64n{}k16 {}->f32; tile chunks (K=64) by TMA as {} A; x's rows by {} as MN-major "
            "B{}, all under the 128-byte swizzle; a producer warp and an mbarrier ring; two consumer warpgroups of 64 "
            "rows").format(n, ty, "MN-major (transposed)" if name == "band_dx" else "K-major", loads,
                           "" if loads != "one bulk copy a chunk" else " (each chunk's 64 rows, one contiguous span, "
                           "on the tile's barrier into a raw staging that the 256 consumers rearrange before their "
                           "wgmma)")


def _probe_kernel_rows(torch):
    """window_dot (P1, P3) and band_slab per-row and batched (P2) against
    their plain versions at the probe tool's shapes, timed beside their
    bounds and a library call (window_dot also beside an empty kernel's
    launch, the floor under its time, and held bit-identical across two
    calls); a wrong window start planted in window_dot's input and its last
    slice dropped inside its kernel, and a stale row block planted in
    band_slab's output and two faults inside its kernel must fail the
    checks. Returns (rows, {fault: its error over the bound})."""
    import numpy as np

    from multistgraph_tpu_torch.ops import band_probe as bp

    dev = torch.device("cuda")
    lines, faults = [], {}

    def row(name, replaces, shape, got, want, kernel, plain, library, label, num_bytes, flops, peak, note):
        torch.cuda.synchronize()
        _hold(_over_bound(got, want), "{} vs its plain version at {}".format(name, shape))
        bound, by = _bound_ms(num_bytes, flops, peak)
        lines.append({
            "name": name, "bf16_path": True, "shape": shape, "replaces": replaces,
            "max_abs_err": (got - want).abs().max().item(),
            "tolerance": "rtol 1e-5, atol 1e-5*max|plain|", "kernel_ms": _time_ms(torch, kernel),
            "plain_ms": _time_ms(torch, plain, reps=10), "library_ms": _time_ms(torch, library, reps=10),
            "library": label, "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "flops": flops,
            "peak": note, "main_path": True,
        })

    floor_ms = _time_ms(torch, bp.empty_launch)

    def window_extras(v, x, starts, want, label):
        rows, slices = bp.window_plan(v.shape[0], v.shape[1], v.shape[2], x.shape[1])
        lines[-1].update(design=_window_design(rows, slices), launch_floor_ms=floor_ms,
                         launch_floor="an empty kernel of one warp (ops/band_probe.empty_launch), timed alike")
        first, second = bp.window_dot(v, x, starts), bp.window_dot(v, x, starts)
        if not torch.equal(first, second):
            raise AssertionError("window_dot {}: two calls differ".format(label))
        lines[-1]["bit_identical"] = True
        for kind in sorted(bp.WINDOW_FAULTS):
            with bp.planted_fault(kind):
                faults["window_dot {}, planted in the kernel: {}".format(label, kind)] = _over_bound(
                    bp.window_dot(v, x, starts), want)

    # P1: the JAX tool's inputs (numpy seed 0), windows of the stacked operand
    c, w, f = 4, 384, 128
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=(c, 128, w)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(c * w, f)).astype(np.float32)).to(dev)
    starts = [i * w for i in range(c)]
    want = bp.window_dot_plain(v, x, starts)
    row("window_dot", "tools/probe_band_stream.py:58 probe_batched_dot", "P1 C=4 b=128 W=384 F=128 f32",
        bp.window_dot(v, x, starts), want, lambda: bp.window_dot(v, x, starts),
        lambda: bp.window_dot_plain(v, x, starts), lambda: torch.bmm(v, x.view(c, w, f)),
        "torch.bmm(v, x as (C, W, F))", (v.numel() + x.numel() + c * 128 * f) * 4, 2 * c * 128 * w * f,
        PEAK_F32_FLOPS, PEAK_F32_NOTE)
    window_extras(v, x, starts, want, "P1")
    faults["window_dot, window start one row late"] = _over_bound(bp.window_dot(v, x, [s + 1 for s in starts[:-1]]
                                                                                + starts[-1:]), want)
    # P3: the JAX tool's inputs (numpy seed 1), one window at row 128
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.normal(size=(8 * 128, 128)).astype(np.float32)).to(dev)
    v3 = torch.from_numpy(rng.normal(size=(1, 128, 640)).astype(np.float32)).to(dev)
    want = bp.window_dot_plain(v3, xs, [128])
    row("window_dot", "tools/probe_band_stream.py:86 probe_slice_reshape", "P3 b=128 W=640 F=128 f32",
        bp.window_dot(v3, xs, [128]), want, lambda: bp.window_dot(v3, xs, [128]),
        lambda: bp.window_dot_plain(v3, xs, [128]), lambda: v3[0] @ xs[128:768],
        "v @ x[1:6].reshape(640, 128) (torch.mm)", (v3.numel() + 640 * 128 + 128 * 128) * 4,
        2 * 128 * 640 * 128, PEAK_F32_FLOPS, PEAK_F32_NOTE)
    window_extras(v3, xs, [128], want, "P3")
    faults["window_dot P3, window start at 0"] = _over_bound(bp.window_dot(v3, xs, [0]), want)
    # P2 at the 1M point: the tool's generator seed 2
    r, radius, f = PROBE_ROWS, PROBE_RADIUS, PROBE_FEAT
    gen = torch.Generator(device=dev).manual_seed(2)
    v_pack = torch.randn(r, 128, (2 * radius + 1) * 128, generator=gen, device=dev).bfloat16()
    xp = torch.randn(r + 2 * radius, 128, f, generator=gen, device=dev).bfloat16()
    xw = xp.as_strided((r, (2 * radius + 1) * 128, f), (128 * f, f, 1))
    want = bp.band_slab_plain(v_pack, xp, radius)
    num_bytes = v_pack.numel() * 2 + xp.numel() * 2 + r * 128 * f * 4
    for name, batched in (("band_slab", False), ("band_slab_batched", True)):
        got = bp.band_slab(v_pack, xp, radius, PROBE_CHUNK, batched)
        row(name, "tools/probe_band_stream.py:182 probe_streams", "P2 R={} radius={} F={} chunk_rows={} bf16{}".format(
            r, radius, f, PROBE_CHUNK, " batched" if batched else ""), got, want,
            lambda b=batched: bp.band_slab(v_pack, xp, radius, PROBE_CHUNK, b),
            lambda: bp.band_slab_plain(v_pack, xp, radius), lambda: torch.bmm(v_pack, xw),
            "torch.bmm(packed rows, overlapping windows of xp) in bf16", num_bytes,
            2 * r * 128 * (2 * radius + 1) * 128 * f, PEAK_BF16_FLOPS, PEAK_NOTE)
        lines[-1]["design"] = _slab_design(bp.slab_tile(f, radius, PROBE_CHUNK, batched), batched)
        # one row block of a slab left holding a stale buffer: another input's output
        stale = got.clone()
        stale[PROBE_CHUNK + 3] = bp.band_slab(v_pack, xp.roll(1, dims=0), radius, PROBE_CHUNK, batched)[PROBE_CHUNK + 3]
        faults["{}, row block {} stale".format(name, PROBE_CHUNK + 3)] = _over_bound(stale, want)
        del got, stale
        # the faults the kernel plants inside itself
        for kind in sorted(bp.FAULTS):
            with bp.planted_fault(kind):
                bad = bp.band_slab(v_pack, xp, radius, PROBE_CHUNK, batched)
            faults["{}, planted in the kernel: {}".format(name, kind)] = _over_bound(bad, want)
            del bad
    del v_pack, xp, xw, want
    torch.cuda.empty_cache()
    for fault, ratio in faults.items():
        if not ratio > 1.0:
            raise AssertionError("{} passes its check ({:.3g} of the bound)".format(fault, ratio))
    return lines, faults


def _window_design(rows, slices):
    """What window_dot's kernel runs (csrc/band_probe.cu) at this plan."""
    return ("f32 FMAs: the window split into {} slices, one block each, the blocks of a {}x64 output tile one thread "
            "block cluster; each block's loads issued at once by cp.async (two 64-row stages), its partial kept in "
            "shared memory and summed in slice order over the cluster's distributed shared memory (no atomics, no "
            "workspace)").format(slices, rows)


def _slab_design(tile, batched):
    """What band_slab's kernel runs (csrc/band_probe.cu) at feature tile `tile`."""
    return ("tensor cores: wgmma m64n{}k16 bf16->f32; packed-row chunks (K=64) as K-major A and the window's rows of "
            "xp as MN-major B by TMA under the 128-byte swizzle; {}; f32 sums staged per warp for 16-byte "
            "stores").format(tile, "two rings, each with its producer warp and one warpgroup taking whole row blocks "
                                   "(two m64 products a k16 slice)" if batched else
                             "one ring of four stages and one producer warp; two warpgroups share each row block "
                             "and walk the slab's row blocks in turn")


def band_bf16_phase(torch):
    """SparseATGCN in bf16 on the band form at 1,000,000 nodes: the bf16
    band kernels and the probe kernels against their plain versions, the
    port's probe tool on the card, bench_large_graph's training steps with
    exact launch counts and its packed serving at buckets 1 and 2 (B8, no
    B7) held against the planes, and card vs CPU at 4,096 nodes in bf16
    with faults planted in B7, B8 and B9 dX (band_bf16_check_phase, run
    after the timed phases). Returns (rows, windows)."""
    import numpy as np

    from multistgraph_tpu_torch.tools import bench_large_graph, probe_band_stream

    cli = bench_large_graph.parse_args(BF_ARGV + ["--iters", str(BF_STEPS)])
    t0 = time.time()
    graph = bench_large_graph.build_graph(cli)
    setup = {"graph_s": time.time() - t0, "nodes": graph.num_nodes, "padded": graph.padded_nodes,
             "offsets": [int(o) for o in graph.offsets], "edges_left": int(graph.rest_w.shape[0])}
    t0 = time.time()
    lines, setup["tiles"], band_faults = _bf16_kernel_rows(torch, graph)
    setup["kernel_rows_s"] = time.time() - t0
    t0 = time.time()
    probe_lines, probe_faults = _probe_kernel_rows(torch)
    lines += probe_lines
    setup["probe_rows_s"] = time.time() - t0
    for line in lines:
        say(json.dumps(line))
    say(json.dumps({"band_bf16_setup": setup, "band_planted_faults_over_bound": band_faults,
                    "probe_planted_faults_over_bound": probe_faults}))

    windows = {}
    _reset_counts()
    t0 = time.time()
    probe = probe_band_stream.main([])
    windows["band bf16 probe tool"] = _read_counts()
    say("probe tool ran in {:.1f}s; launches: {}".format(time.time() - t0, json.dumps(
        {k: v for k, v in windows["band bf16 probe tool"].items() if v})))
    if not probe["ok"] or not all(probe[p]["launches"] for p in ("P1", "P3")) or not all(
            probe["P2"][v]["launches"] for v in ("per-c dots", "batched dot")):
        raise AssertionError("the probe tool failed or skipped a probe: {}".format(probe))
    for name in ("window_dot", "band_slab", "band_slab_batched"):
        if not windows["band bf16 probe tool"][name]:
            raise AssertionError("{} was launched no time by the probe tool".format(name))

    # training through the tool (replays of its captured step), launch
    # counts from 0 before the timed steps
    train = bench_large_graph.run(cli, graph=graph, before_timed=_reset_counts)
    step_graph = train["graph"]
    windows["band bf16 training"] = _plus(_read_counts(), _replayed([step_graph]))
    model, record, optimizer, x, y = (train[k] for k in ("model", "record", "optimizer", "x", "y"))
    per_step = _sparse_launches(model, train=True, t=BF_T)
    want = dict(dict.fromkeys(windows["band bf16 training"], 0), **{k: v * BF_STEPS for k, v in per_step.items()})
    if windows["band bf16 training"] != want or record["extras"]["train_step"] != "cuda graph" \
            or _named(step_graph.captured) != dict(dict.fromkeys(_counters(), 0), **per_step):
        raise AssertionError("{} replayed bf16 band training steps launched {} (captured {}), want {}".format(
            BF_STEPS, windows["band bf16 training"], step_graph.captured, want))
    losses = record["extras"]["losses"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite bf16 band training loss: {}".format(losses))
    step_ms = record["extras"]["step_seconds"] * 1e3
    record["extras"]["device_time_per_step"] = _device_time(torch, train["again"], step_ms)
    record["extras"]["launches_per_step"] = {k: v for k, v in per_step.items() if v}
    # the same steps eagerly (timed, with their peak memory), and the replay
    # held against SPG_EAGER_RUNS eager re-runs from one state
    _reset_counts()
    held_from = step_graph.replays
    torch.cuda.reset_peak_memory_stats()
    eager_losses, eager_s = bench_large_graph.train_steps(model, optimizer, x, y, BF_STEPS)
    eager = {"step_seconds": sum(eager_s) / len(eager_s), "step_seconds_each": eager_s, "losses": eager_losses,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if _sparse_counts_of(_read_counts()) != {k: v * BF_STEPS for k, v in per_step.items()}:
        raise AssertionError("{} eager bf16 band steps launched {}".format(BF_STEPS, _read_counts()))
    eager["device_time_per_step"] = _device_time(
        torch, lambda: bench_large_graph.train_steps(model, optimizer, x, y, 1), eager["step_seconds"] * 1e3)
    state = _train_state(torch, model, optimizer)
    start = _copy_state(torch, state)
    runs = []
    for _ in range(SPG_EAGER_RUNS):
        _load_state(torch, state, start)
        runs.append(dict(loss=bench_large_graph.train_steps(model, optimizer, x, y, 1)[0]))
        runs[-1].update(_copy_state(torch, state))
    _load_state(torch, state, start)
    replayed = dict(loss=bench_large_graph.replays(step_graph, 1)[0], **_copy_state(torch, state))
    record["extras"]["replay_vs_eager"] = _hold_replay(torch, "1M bf16 band training", replayed, runs)
    record["extras"]["eager"] = eager
    windows["band bf16 training eager"] = _plus(_read_counts(), {
        k: v * (step_graph.replays - held_from) for k, v in _named(step_graph.captured).items()})
    say(json.dumps({"band bf16 training": record}))
    del train, step_graph, optimizer, state, start, runs, replayed

    # packed serving through the tool at buckets 1 and 2 (replays of its
    # captured call), held against eager calls and against the planes at
    # the same weights
    model.eval()
    serving = {}
    for b in (1, BF_B):
        scli = bench_large_graph.parse_args(["1000000", "16", str(BF_T), str(b), "band", "--dtype", "bf16",
                                             "--adpadj", "none", "--serve", "--band-packed",
                                             "--iters", str(BF_CALLS)])
        served = bench_large_graph.run(scli, graph=graph, before_timed=_reset_counts)
        key = "band bf16 serving b{}".format(b)
        windows[key] = _plus(_read_counts(), _replayed([served["graph"]]))
        per_call = _sparse_launches(served["model"], t=BF_T)
        if _sparse_counts_of(windows[key]) != {k: v * BF_CALLS for k, v in per_call.items()} \
                or windows[key]["band_spmm"] or not windows[key]["band_spmm_packed"] \
                or served["record"]["extras"]["serve_call"] != "cuda graph":
            raise AssertionError("packed bf16 serving launched {}, want {} per call".format(windows[key], per_call))
        out = served["out"]
        if out.shape != (b, 3, graph.padded_nodes, 1) or out.dtype != torch.float32 or not torch.isfinite(out).all():
            raise AssertionError("bad packed bf16 reply for batch {}: {} {}".format(b, out.shape, out.dtype))
        rec = served["record"]
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        runs = [{"reply": [bench_large_graph.serve_calls(served["model"], served["x"], 1)[0]]}
                for _ in range(SPG_EAGER_RUNS)]
        rec["extras"]["replay_vs_eager"] = _hold_replay(torch, "1M packed request at bucket {}".format(b),
                                                        {"reply": [out]}, runs)
        _, eager_s = bench_large_graph.serve_calls(served["model"], served["x"], BF_CALLS)
        rec["extras"]["eager"] = {"ms": 1e3 * sum(eager_s) / len(eager_s), "call_seconds": eager_s,
                                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        windows[key + " eager"] = _read_counts()
        model.load_state_dict(served["model"].state_dict())
        with torch.no_grad():
            planes_out = model(served["x"])
        diff = (out - planes_out).abs().max().item()
        scale = planes_out.abs().max().item()
        # the same products in the same order: one bf16 step of the largest reply at most
        if not diff <= 2.0 ** -7 * scale:
            raise AssertionError("packed bf16 replies differ from the planes' by {} (largest {})".format(diff, scale))
        rec["extras"]["packed_vs_planes_max_abs"] = diff
        rec["extras"]["device_time_per_call"] = _device_time(torch, served["again"], rec["value"])
        windows[key] = _plus(windows[key], {k: v * (served["graph"].replays - BF_CALLS)
                                            for k, v in _named(served["graph"].captured).items()})
        serving[b] = rec
        say(json.dumps({key: rec}))
        del served, planes_out, out, runs
    del model
    torch.cuda.empty_cache()
    return lines, windows


def band_bf16_check_phase(torch):
    """Card vs CPU at 4,096 nodes in bf16 on the band form without the
    adaptive view, planes and packed rows, faults planted in B7, B8, B9 dX."""
    return band_check_phase(torch, label="band bf16", bound_out=BOUND_BF16_OUT, bound_grad=BOUND_BF16_GRAD,
                            compute_dtype="bfloat16", adpadj="none")


# ------------------------------------------------------------ node-apply harness

# B1/B1t cells: the DC-237 flagship encoder's gate (O = 2H) and update (O = H)
FACTORED_D = 20                       # embed_dim_node at the flagship
# the harness's shapes (tools/bench_node_dots.py:41-46): T, B, NP, KI, O, D, BLK
HARNESS = dict(T=24, B=16, NP=256, KI=320, O=192, D=20, BLK=32)
B10_MB, B10_BLOCKS = 256, ((512, 512), (2048, 512), (2048, 1024))   # tools/bench_hbm_peak.py:230-232
RATE_STREAMS, RATE_BLOCK_MB, RATE_TOTAL_MB = 4, 2, 512              # one point of the stream-rate sweep
HARNESS_WRAPPERS = (("node_factored_apply", "ops.node_apply"), ("node_factored_apply_t", "ops.node_apply"),
                    ("node_factored_rows", "ops.node_apply"), ("node_dots", "ops.node_dots"),
                    ("node_dots_floor", "ops.stream_read"), ("column_sum_read", "ops.stream_read"),
                    ("stream_rate_read", "ops.stream_read"))


DESIGN_B11_A = ("tensor cores: wgmma m64n192k16 bf16->f32; the node's weight tile resident in shared memory for "
                "all steps; 64-row tiles of four steps' rows by TMA from a producer warp through an mbarrier ring; "
                "results staged for 16-byte stores in step order")
DESIGN_B11_B = ("tensor cores: wgmma m64nNk16 bf16->f32, N = several d x the column tile gathered by a 5-d TMA view "
                "of the pool; a producer warp and an mbarrier ring; each step's rows staged once by cp.async; "
                "e folded in f32 per d")
DESIGN_B1_BF16 = DESIGN_B11_B
DESIGN_B1_F32 = ("f32 FMAs in the expanded order: per 16-row chunk of (k, i), a producer warp streams the pool's rows "
                 "at the block's 32 columns 8 d at a time (TMA, a 4-d view) with e's columns, then the chunk's hh "
                 "(TMA, a 5-d view landing [n][i/4][b][4 i]) through a 4-stage mbarrier ring; 256 consumers form "
                 "W[n,(k,i),o] = sum_d e[n,d] pool[k,i,dO+o] in registers (8 nodes x 4 o a thread), stage it, and "
                 "fold hh[b,k,n,i] W into 4 b x 8 o a thread; W never in device memory; tile {} (nodes x columns a "
                 "block, 16 b; the chunks split over the blocks of a cluster, their partials summed in rank order "
                 "over distributed shared memory); loads {}")
DESIGN_B1T_F32 = ("f32 FMAs in the expanded order: per 16-o chunk, pool_t's rows of the block's 32 (k, i) columns "
                  "and e's columns streamed by cp.async through a 4-stage ring, the per-node weights W[n,o,c] = "
                  "sum_d e[n,d] pool_t[k,dO+o,i] formed in registers (8 nodes x 4 columns a thread), then "
                  "dpre[b,n,o] W folded into 4 b x 8 columns a thread; W never in device memory; tile {} (nodes x "
                  "columns a block, 16 b; the 16-o chunks split over the blocks of a cluster, their partials "
                  "summed in rank order over distributed shared memory)")
DESIGN_B1T_BF16 = ("tensor cores: wgmma m64nNk16 bf16->f32 with A from registers: each thread's dpre fragments "
                   "loaded once, multiplied by its rows' e[n,d] in bf16 (q, the Pallas rounding) per d; pool_t's "
                   "chunks (64 o of one d x several k x 64 i) by a 4-d TMA view under the 128-byte swizzle, each "
                   "d's o zero-padded on its own; a producer warp and an mbarrier ring; results staged per warp "
                   "for 16-byte stores along I; tile {} (rows x k a block)")


def _bf16_step(got, want):
    return _over_bound(got, want, bf16_step=True)


def node_harness_phase(torch):
    """B1, B1t, B11 A/B/D, B10 and B12's stream rate against their plain
    versions at the flagship and harness shapes, timed beside their bounds
    and library calls; faults planted in B1, B1t, B11 A and B11 B; every
    step of B11 A and B shown to run; then the port's three
    tools driven on the card with the launch counts from 0. Returns (rows,
    launches in the tools' window)."""
    from multistgraph_tpu_torch.ops import node_apply, stream_read
    from multistgraph_tpu_torch.ops.node_dots import node_dots, node_dots_plain
    from multistgraph_tpu_torch.tools import timing

    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    lines = []

    def randn(*shape, dtype=torch.float32, scale=0.1):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def row(name, replaces, shape, got, want, check, tolerance, kernel, plain, library, label,
            num_bytes, flops, peak_flops, peak_note, main_path=True, reps=TIMING_REPS, design=None):
        torch.cuda.synchronize()
        _hold(check(got, want), "{} vs its plain version at {}".format(name, shape))
        bound, by = _bound_ms(num_bytes, flops, peak_flops)
        lines.append(({"design": design} if design else {}) | {
            "name": name, "shape": shape, "replaces": replaces,
            "max_abs_err": (got.float() - want.float()).abs().max().item(), "tolerance": tolerance,
            "kernel_ms": _time_ms(torch, kernel, reps=reps), "plain_ms": _time_ms(torch, plain, reps=reps),
            "library_ms": None if library is None else _time_ms(torch, library, reps=reps), "library": label,
            "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "flops": flops, "peak": peak_note,
            "main_path": main_path,
        })

    # B1 and B1t at the flagship cells, f32 and bf16 operands (the harness
    # runs them in bf16, its main path)
    ki = K * H
    faults = {}
    for (cell, o), dtype in itertools.product((("gate", 2 * H), ("update", H)), (torch.float32, torch.bfloat16)):
        bf = dtype == torch.bfloat16
        peak, note = (PEAK_BF16_FLOPS, PEAK_NOTE) if bf else (PEAK_F32_FLOPS, PEAK_F32_NOTE)
        size = 2 if bf else 4
        hh = randn(B, K, N, H, dtype=dtype)
        e = randn(N, FACTORED_D)
        pool = randn(FACTORED_D, K, H, o, dtype=dtype)
        mat, mat_t = node_apply.pool_to_kernel_layout(pool)
        shape = "{} {} B={} K={} N={} I={} D={} O={}".format(cell, str(dtype)[6:], B, K, N, H, FACTORED_D, o)
        # the factored order's operations (in bf16 the function's own: the
        # Pallas kernels round q, or sum r, in it) and the expanded order's
        # (W = sum_d e pool first, then the per-node product), which f32 is
        # free to take: each row's bound is its dtype's
        flops_factored = 2 * B * N * ki * FACTORED_D * o
        flops_expanded = 2 * N * FACTORED_D * ki * o + 2 * B * N * ki * o
        flops = flops_factored if bf else flops_expanded
        orders = {"bound_order": "factored (bf16: the Pallas kernel's rounding points)" if bf else
                  "expanded (f32: the order is free)",
                  "bound_factored_us": _bound_ms(0, flops_factored, peak)[0] * 1e3,
                  "bound_expanded_us": _bound_ms(0, flops_expanded, peak)[0] * 1e3}
        got = node_apply.node_factored_apply(hh, e, mat)
        want = node_apply.node_factored_apply_plain(hh, e, mat)
        pool4, e_lib = mat.reshape(K, H, FACTORED_D, o), e.to(dtype)
        if not bf and not torch.equal(got, node_apply.node_factored_apply(hh, e, mat)):
            raise AssertionError("B1 f32 at {}: two calls differ".format(shape))
        row("node_factored_apply", "multistgraph_tpu/ops/node_apply.py:107 node_factored_apply", shape,
            got, want, _over_bound, "rtol 1e-5, atol 1e-5*max|plain|" + ("" if bf else "; two calls bit-identical"),
            lambda: node_apply.node_factored_apply(hh, e, mat),
            lambda: node_apply.node_factored_apply_plain(hh, e, mat),
            lambda: torch.einsum("bkni,nd,kido->bno", hh, e_lib, pool4),
            "torch.einsum('bkni,nd,kido->bno') in the operands' dtype",
            hh.numel() * size + e.numel() * 4 + mat.numel() * size + B * N * o * 4, flops, peak, note,
            main_path=bf, design=DESIGN_B1_BF16 if bf else DESIGN_B1_F32.format(
                node_apply.factored_tile(B, K, N, H, o), node_apply.factored_load_path(H, o)))
        lines[-1]["library_order"] = timing.einsum_order("bkni,nd,kido->bno", hh, e_lib, pool4)
        lines[-1].update(orders)
        # planted faults: B1 without its d = 0 term (from its inputs), and in
        # f32 the faults the kernel plants inside itself
        e0 = e.clone()
        e0[:, 0] = 0
        faults["B1 d=0 term dropped, " + shape] = _over_bound(node_apply.node_factored_apply(hh, e0, mat), want)
        if not bf:
            for kind in sorted(node_apply.B1_FAULTS):
                with node_apply.planted_fault(kind):
                    bad = node_apply.node_factored_apply(hh, e, mat)
                faults["B1 planted in the kernel: {}, {}".format(kind, shape)] = _over_bound(bad, want)
        dpre = randn(B, N, o, dtype=dtype)
        got = node_apply.node_factored_apply_t(dpre, e, mat_t)
        want = node_apply.node_factored_apply_t_plain(dpre, e, mat_t)
        check, tol = (_bf16_step, "one bf16 step: 2^-7 |plain| + 2^-7 * 1e-3 max|plain|") if bf else (
            _over_bound, "rtol 1e-5, atol 1e-5*max|plain|")
        pool4t = mat_t.reshape(K, FACTORED_D, o, H)
        row("node_factored_apply_t", "multistgraph_tpu/ops/node_apply.py:137 node_factored_apply_t", shape,
            got, want, check, tol,
            lambda: node_apply.node_factored_apply_t(dpre, e, mat_t),
            lambda: node_apply.node_factored_apply_t_plain(dpre, e, mat_t),
            lambda: torch.einsum("bno,nd,kdoi->bkni", dpre, e_lib, pool4t),
            "torch.einsum('bno,nd,kdoi->bkni') in the operands' dtype",
            dpre.numel() * size + e.numel() * 4 + mat_t.numel() * size + B * ki * N * size, flops, peak, note,
            main_path=bf, design=(DESIGN_B1T_BF16 if bf else DESIGN_B1T_F32).format(
                node_apply.factored_t_tile(B, K, N, H, dtype, o)))
        lines[-1]["library_order"] = timing.einsum_order("bno,nd,kdoi->bkni", dpre, e_lib, pool4t)
        lines[-1].update(orders)
        if bf:  # how the bf16 kernel took pool_t
            lines[-1]["loads"] = node_apply.factored_t_load_path(H)
        # planted fault: B1t with its first node block (64 rows) zeroed
        bad = got.clone()
        bad[:, :, :64] = 0
        faults["B1t node block 0 zeroed, " + shape] = check(bad, want)
        for kind in sorted(node_apply.FAULTS):  # the faults each form plants inside itself
            with node_apply.planted_fault(kind):
                bad = node_apply.node_factored_apply_t(dpre, e, mat_t)
            faults["B1t planted in the kernel: {}, {}".format(kind, shape)] = check(bad, want)
        del bad

    # B11 A, B and D at the harness shapes
    hs = HARNESS
    hh = randn(hs["T"], hs["B"], hs["NP"] * hs["KI"], dtype=torch.bfloat16)
    w = randn(hs["NP"], hs["KI"], hs["O"], dtype=torch.bfloat16)
    s = torch.full((1, 1), 0.0123, device=dev)
    in_bytes = (hh.numel() + w.numel()) * 2
    harness_shape = "T={T} B={B} NP={NP} KI={KI} O={O}".format(**hs)
    dots_flops = 2 * hs["T"] * hs["B"] * hs["NP"] * hs["KI"] * hs["O"]
    hh_nodes = hh.reshape(hs["T"] * hs["B"], hs["NP"], hs["KI"]).transpose(0, 1).contiguous()
    want_a = node_dots_plain(hh, w, s)
    row("node_dots", "tools/bench_node_dots.py:91 make_a", harness_shape,
        node_dots(hh, w, s), want_a, _bf16_step,
        "one bf16 step: 2^-7 |plain| + 2^-7 * 1e-3 max|plain|",
        lambda: node_dots(hh, w, s), lambda: node_dots_plain(hh, w, s), lambda: torch.bmm(hh_nodes, w),
        "torch.bmm over nodes of all T steps' rows (NP, T*B, KI) @ (NP, KI, O), hh pre-permuted",
        in_bytes + hs["B"] * hs["NP"] * hs["O"] * 2, dots_flops, PEAK_BF16_FLOPS, PEAK_NOTE,
        design=DESIGN_B11_A)
    # planted fault: B11 A without the last 16-wide slice of its contraction
    w_bad = w.clone()
    w_bad[:, -16:] = 0
    faults["B11 A last k16 slice dropped, " + harness_shape] = _bf16_step(node_dots(hh, w_bad, s), want_a)
    del w_bad
    rows_n = hs["B"] * hs["NP"]
    hh_rows = hh.reshape(hs["T"], rows_n, hs["KI"])
    e_rows = randn(hs["NP"], hs["D"], dtype=torch.bfloat16).repeat(hs["B"], 1)
    pool = randn(hs["KI"], hs["D"] * hs["O"], dtype=torch.bfloat16)
    pool3 = pool.view(hs["KI"], hs["D"], hs["O"])
    want_b = node_apply.node_factored_rows_plain(hh_rows, e_rows, pool, s)
    row("node_factored_rows", "tools/bench_node_dots.py:127 make_b", harness_shape + " D={D} rows".format(**hs),
        node_apply.node_factored_rows(hh_rows, e_rows, pool, s), want_b, _bf16_step,
        "one bf16 step: 2^-7 |plain| + 2^-7 * 1e-3 max|plain|",
        lambda: node_apply.node_factored_rows(hh_rows, e_rows, pool, s),
        lambda: node_apply.node_factored_rows_plain(hh_rows, e_rows, pool, s),
        lambda: torch.einsum("tri,rd,ido->tro", hh_rows, e_rows, pool3),
        "torch.einsum('tri,rd,ido->tro') in bf16 over all T steps, no scalar",
        hh.numel() * 2 + e_rows.numel() * 2 + pool.numel() * 2 + rows_n * hs["O"] * 2,
        dots_flops * hs["D"], PEAK_BF16_FLOPS, PEAK_NOTE, reps=10, design=DESIGN_B11_B)
    # planted faults: B11 B without the last 16-wide slice of its
    # contraction, and without e's last column
    pool_bad = pool.clone()
    pool_bad[-16:] = 0
    e_bad = e_rows.clone()
    e_bad[:, -1] = 0
    faults["B11 B last k16 slice dropped, " + harness_shape] = _bf16_step(
        node_apply.node_factored_rows(hh_rows, e_rows, pool_bad, s), want_b)
    faults["B11 B e's last d column zeroed, " + harness_shape] = _bf16_step(
        node_apply.node_factored_rows(hh_rows, e_bad, pool, s), want_b)
    del pool_bad, e_bad
    for fault, ratio in faults.items():
        if not ratio > 1.0:
            raise AssertionError("{} passes its check ({:.3g} of the bound)".format(fault, ratio))
    say(json.dumps({"planted_faults_over_bound": faults}))
    # The plain versions of A and B compute only the last step, the one that
    # reaches the output; the kernels compute all T, as the TPU grid does. A
    # kernel that skipped the overwritten steps would take about its one-step
    # time at T steps, so the T - 1 extra steps must take at least their own
    # bytes or operations at the card's peaks (timing.every_step_ran). The
    # planted step-skip, the one-step time in the T-step time's place, must
    # fail that check.
    # The T-step and one-step times are taken in turns (5 rounds of 10
    # calls each, the median of the rounds' medians), so that a drift of
    # the card between the two readings does not decide the check.
    step_rows = hs["B"] * hs["NP"] * hs["KI"]
    for line, all_steps, one_step, step_flops in (
            (lines[-2], lambda: node_dots(hh, w, s), lambda: node_dots(hh[-1:], w, s), dots_flops // hs["T"]),
            (lines[-1], lambda: node_apply.node_factored_rows(hh_rows, e_rows, pool, s),
             lambda: node_apply.node_factored_rows(hh_rows[-1:], e_rows, pool, s),
             dots_flops // hs["T"] * hs["D"])):
        rounds = [(_time_ms(torch, all_steps, reps=10), _time_ms(torch, one_step, reps=10)) for _ in range(5)]
        line["kernel_ms_in_turns"] = [a for a, _ in rounds]
        line["kernel_ms_one_step_in_turns"] = [o for _, o in rounds]
        every = statistics.median(line["kernel_ms_in_turns"])
        one = line["kernel_ms_one_step"] = statistics.median(line["kernel_ms_one_step_in_turns"])
        floor = line["extra_steps_floor_ms"] = timing.step_floor_ms(hs["T"], step_rows * 2, step_flops)
        if not timing.every_step_ran(every, one, hs["T"], step_rows * 2, step_flops):
            raise AssertionError("{}: {} steps take {:.4g} ms, one step {:.4g} ms, under the {:.4g} ms the "
                                 "extra steps need: not every step ran ({})".format(
                                     line["name"], hs["T"], every, one, floor, rounds))
        if timing.every_step_ran(one, one, hs["T"], step_rows * 2, step_flops):
            raise AssertionError("{}: the planted step-skip passes the every-step check".format(line["name"]))

    def bit_equal(got, want):
        return 0.0 if torch.equal(got, want) else float("inf")

    def same_checksum(name, got, want):
        if stream_read.checksum_value(got[1]) != stream_read.checksum_value(want[1]):
            raise AssertionError("{}'s checksum differs: not every byte was read".format(name))
        return got[0], want[0]

    got, want = same_checksum("node_dots_floor", stream_read.node_dots_floor(hh, w, s, hs["BLK"]),
                              stream_read.node_dots_floor_plain(hh, w, s, hs["BLK"]))
    row("node_dots_floor", "tools/bench_node_dots.py:158 make_d", harness_shape, got, want,
        bit_equal, "bit-identical, checksum exact",
        lambda: stream_read.node_dots_floor(hh, w, s, hs["BLK"]),
        lambda: stream_read.node_dots_floor_plain(hh, w, s, hs["BLK"]),
        lambda: (hh.sum(dtype=torch.float32), w.sum(dtype=torch.float32)),
        "hh.sum() and w.sum() (two calls) over the same bytes",
        in_bytes + hs["B"] * hs["O"] * 2, 0, PEAK_BF16_FLOPS, PEAK_NOTE)
    del hh, w, hh_nodes, hh_rows, e_rows, pool, pool3

    # B10 at the TPU bench's three block shapes over 256 MB of bf16
    for block_rows, width in B10_BLOCKS:
        rows = B10_MB * 1024 * 1024 // (2 * width)
        x = randn(rows, width, dtype=torch.bfloat16, scale=1.0)
        got, want = same_checksum("column_sum_read", stream_read.column_sum_read(x, s, block_rows),
                                  stream_read.column_sum_read_plain(x, s, block_rows))
        row("column_sum_read", "tools/bench_hbm_peak.py:156 pallas_read",
            "{} MB bf16 ({}, {}) blocks {}x{}".format(B10_MB, rows, width, block_rows, width), got, want,
            _over_bound, "rtol 1e-5, atol 1e-5*max|plain| (f32 column sums in another order); checksum exact",
            lambda: stream_read.column_sum_read(x, s, block_rows),
            lambda: stream_read.column_sum_read_plain(x, s, block_rows),
            lambda: x.sum(dtype=torch.float32), "x.sum() over the same bytes",
            x.numel() * 2 + stream_read.COLUMNS * 4, 0, PEAK_BF16_FLOPS, PEAK_NOTE, reps=10)
        del x
    # one point of the stream-rate sweep: 4 streams of 2 MB blocks, 512 MB
    rows_per_block = RATE_BLOCK_MB * 1024 * 1024 // (2 * 512)
    grid = RATE_TOTAL_MB * 1024 * 1024 // (2 * 512 * RATE_STREAMS) // rows_per_block
    arrays = [randn(grid, rows_per_block, 512, dtype=torch.bfloat16, scale=1.0) for _ in range(RATE_STREAMS)]
    got, want = same_checksum("stream_rate_read", stream_read.stream_rate_read(arrays, s),
                              stream_read.stream_rate_read_plain(arrays, s))
    row("stream_rate_read", "tools/bench_stream_rate.py:57 make",
        "{} streams x ({}, {}, 512) bf16, {} MB".format(RATE_STREAMS, grid, rows_per_block, RATE_TOTAL_MB),
        got, want, bit_equal, "bit-identical, checksum exact",
        lambda: stream_read.stream_rate_read(arrays, s), lambda: stream_read.stream_rate_read_plain(arrays, s),
        None, "none: no one PyTorch call reads n arrays", RATE_TOTAL_MB * 1024 * 1024 + 512 * 4, 0,
        PEAK_BF16_FLOPS, PEAK_NOTE, reps=10)
    del arrays
    torch.cuda.empty_cache()
    for line in lines:
        say(json.dumps(line))

    # the port's three tools on the card, launches counted from 0
    _reset_counts()
    t0 = time.time()
    for tool in ("bench_node_dots", "bench_hbm_peak", "bench_stream_rate"):
        record = importlib.import_module("multistgraph_tpu_torch.tools." + tool).main([])
        if not record:
            raise AssertionError("{} returned no record".format(tool))
    window = _read_counts()
    say("node-apply harness and stream tools ran in {:.1f}s; launches: {}".format(time.time() - t0, json.dumps(
        {k: v for k, v in window.items() if v})))
    for name, _ in HARNESS_WRAPPERS:
        if window[name] == 0:
            raise AssertionError("{} was launched no time by the harness tools".format(name))
    return lines, window


# ---------------------------------------------------------------- multi-seed
MS_FORMS = {"int8": 4, "f32": 2}    # seeds each form trains in one widened step
MS_SCALING = (1, 2, 4, 8)           # seeds of the timed int8 steps
MS_WIDTHS = (2, 4, 8)               # seeds of B2/B2t's rows at S*N nodes (4: the int8 form's)
MS_CHECK_REPLAYS = 3                # replayed steps held against single-seed steps from one state
MS_TIMED = 10                       # replays timed at each S
MS_BENCH_EPOCHS = 1                 # bench.py --multiseed's timed epochs (after its warm-up)
MS_EPOCH_BATCHES = 6                # train_multiseed's epoch: the first 6 batches' samples, shuffled per seed
MS_EVAL_BATCHES = 4                 # its validation and predict passes: the first 4 batches, in order
# Each seed of a replayed widened step against a single-seed step on the
# card from that seed's slice of the state: the relative max error (max
# |a - b| over max |b|, the worst leaf) of the losses, of the parameters,
# of their update (parameters after less parameters before, over the
# single-seed update's max), of Adam's moments in gradient units
# (exp_avg and the root of exp_avg_sq) and of the last gradients. Bit for
# bit where the seed's arithmetic is unchanged; it is not: the seeds'
# batched contractions take other batch counts, which can reorder sums.
# So each is held to a card-vs-CPU bound of the dtype: the losses to the
# model output's (BOUND_F32, BOUND_BF16), the gradients of the rate-drop
# step, taken from one state, to the gradients' (BOUND_GRAD_F32,
# BOUND_GRAD_BF16), and the parameters and moments, made of gradient
# steps taken at parameters that drift apart, to the larger of the two
# (BOUND_F32, BOUND_GRAD_BF16). In int8 a last f32 bit flips bf16
# roundings, and Adam takes a step of about the rate on every near-zero
# gradient, as between card and CPU: there the parameters' bound is about
# a whole update, so int8 also holds the parameters by their update in
# the rate-drop step, one step from one state (MS_UPDATE_BOUND); the
# updates of the 3 replays are reported, not held. In f32 the parameters'
# bound is far under an update, and an update's relative gap is no f32
# bound's: Adam divides each element's gradient gap by that element's own
# root mean square. A planted fault, half of the first seed's batch left
# out of its single-seed steps, must put one of the held numbers over its
# bound. Read on an H100 80GB HBM3 at 700 W over 3 replays / the
# rate-drop step: f32 losses <= 1.4e-7 / 2.2e-7, parameters 9.7e-7 /
# 1.2e-7, update 7.9e-6 / 5.7e-5, moments 1.8e-6 / 1.1e-6, gradients 1.5e-6
# / 1.6e-6; int8 losses 2.2e-7 / 1.5e-7, parameters 1.8e-2 / 4.3e-4, update
# 5.7e-2 / 3.3e-3, moments 9.5e-3 / 1.7e-3, gradients 2.6e-2 / 3.2e-3. The
# planted fault read losses 1.2e-2 / 1.1e-2 (int8 / f32), parameters 0.61
# / 0.63, moments 0.51 / 0.44.
MS_BOUND = {"int8": {"loss": BOUND_BF16, "parameters": BOUND_GRAD_BF16, "adam_state": BOUND_GRAD_BF16},
            "f32": {"loss": BOUND_F32, "parameters": BOUND_F32, "adam_state": BOUND_F32}}
MS_GRAD_BOUND = {"int8": BOUND_GRAD_BF16, "f32": BOUND_GRAD_F32}
MS_UPDATE_BOUND = {"int8": BOUND_GRAD_BF16}
MS_FORWARD_CAPTURED = {"node_apply_q8": 2 * T * NUM_LAYERS}   # one int8 forward, at any S
# kernel names of the parts of a widened step that may loop over seeds:
# the parameters' stacking (SeedStack, and the model's own cat), the
# clip's scales and Adam's foreach updates, reductions (the clip's norms
# among every other sum), dropout's draws
MS_KERNEL_GROUPS = {"cat": "CatArrayBatchedCopy", "foreach": "multi_tensor_apply",
                    "reduce": "reduce_kernel", "random": "distribution"}


def _rel_gap(torch, a, b):
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _seed_gaps(torch, trainer, i, ref, got_losses, want_losses, start):
    """Seed i of `trainer` against the single-seed executor `ref`, both
    stepped from the parameters `start`: the largest relative gap of the
    losses, the parameters, their update, the last step's gradients and
    Adam's moments in gradient units (exp_avg and the root of exp_avg_sq;
    the step counts must agree), and whether all are bit for bit."""
    names = [name for name, _ in ref.model.named_parameters()]
    params = [(p.detach(), q.detach()) for p, q in zip(trainer.model.members[i].parameters(),
                                                        ref.model.parameters())]
    updates = [(p - s, q - s) for (p, q), s in zip(params, start) if bool((q != s).any())]
    grads = [(p.grad, q.grad) for p, q in zip(trainer.model.members[i].parameters(), ref.model.parameters())
             if q.grad is not None]
    grad_names = [n for n, q in zip(names, ref.model.parameters()) if q.grad is not None]
    mine = trainer.seed_state(i)[1]["state"]
    theirs = ref.optimizer.state_dict()["state"]
    if any(not torch.equal(torch.as_tensor(st["step"]), torch.as_tensor(theirs[j]["step"]))
           for j, st in mine.items()):
        raise AssertionError("seed {}: Adam's step counts differ from its single-seed run's".format(i))
    moments = [(st[key], theirs[j][key]) for j, st in mine.items() for key in ("exp_avg", "exp_avg_sq")]
    gaps = {"loss": _rel_gap(torch, got_losses, want_losses),
            "parameters": max(_rel_gap(torch, a, b) for a, b in params),
            "update": max(_rel_gap(torch, a, b) for a, b in updates),
            "gradients": max(_rel_gap(torch, a, b) for a, b in grads),
            "adam_state": max(_rel_gap(torch, a.sqrt() if k % 2 else a, b.sqrt() if k % 2 else b)
                              for k, (a, b) in enumerate(moments))}
    # where each largest gap lies
    gaps["largest"] = {"parameters": names[max(range(len(params)), key=lambda k: _rel_gap(torch, *params[k]))],
                       "gradients": grad_names[max(range(len(grads)), key=lambda k: _rel_gap(torch, *grads[k]))]}
    gaps["bit_for_bit"] = (torch.equal(torch.as_tensor(got_losses), torch.as_tensor(want_losses))
                           and all(torch.equal(a, b) for a, b in params + grads + moments))
    return gaps


def _seed_perm(train, count, steps, seed=0):
    """(steps, count, B) sample indices: each seed's own shuffle of the split."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(train.num_samples)[: steps * B].reshape(steps, B) for _ in range(count)],
                    axis=1)


def _ms_rows(torch, node_apply, g):
    """B2/B2t at the seed-widened node counts (S*N, batch B) and B3 at the
    f32 form's widened stacks, each held against its plain version (planted
    faults included in B2/B2t) and timed beside its bound and library call."""
    from multistgraph_tpu_torch.ops.layout import (
        _ForceDefaultLayout, force_default_layout, force_default_layout_plain)

    lines, faults = [], {}
    for s in MS_WIDTHS:
        rows, found = _q8_rows(torch, node_apply, g, "bfloat16", nodes=s * N, batches=(B,),
                               on_path=s == MS_FORMS["int8"], label="{} seeds: ".format(s))
        lines += rows
        faults.update({"{} seeds, {}".format(s, k): v for k, v in found.items()})
    s = MS_FORMS["f32"]
    xw = torch.randn(T, s * B, N, 3 * H, generator=g, device="cuda")
    for name, cell, width in (("force_default_layout", "gate_x", 2 * H), ("force_default_layout", "upd_x", H),
                              ("force_default_layout_bwd", "d gate_x", 2 * H),
                              ("force_default_layout_bwd", "d upd_x", H)):
        if name == "force_default_layout":
            x = xw[..., : 2 * H] if cell == "gate_x" else xw[..., 2 * H:]
            fn = lambda x=x: force_default_layout(x)  # noqa: E731
        else:
            x = torch.randn(T, s * B, N, width, generator=g, device="cuda")
            fn = lambda x=x: _ForceDefaultLayout.backward(None, x)  # noqa: E731
        got, want = fn(), force_default_layout_plain(x)
        torch.cuda.synchronize()
        if not (got.is_contiguous() and torch.equal(got, want)):
            raise AssertionError("{} differs from its plain version on {} seeds' {}".format(name, s, cell))
        num_bytes = 2 * x.numel() * x.element_size()
        bound, by = _bound_ms(num_bytes, 0)
        lines.append({
            "name": name, "shape": "{} seeds: {} {} f32 (seeds x batch on one axis)".format(s, cell, tuple(x.shape)),
            "replaces": "multistgraph_tpu/ops/layout.py:40 _launder/force_default_layout",
            "max_abs_err": (got - want).abs().max().item(), "tolerance": "bit-identical",
            "kernel_ms": _time_ms(torch, fn), "plain_ms": _time_ms(torch, lambda: force_default_layout_plain(x)),
            "library_ms": _time_ms(torch, lambda: x.clone()), "library": "x.clone()",
            "bound_us": bound * 1e3, "bound_by": by, "bytes": num_bytes, "peak": PEAK_NOTE, "main_path": True,
        })
    for line in lines:
        say(json.dumps(line))
    say(json.dumps({"B2/B2t at S*N nodes: planted_faults_over_bound": faults}))
    for fault, ratio in faults.items():
        if not ratio > 1.0:
            raise AssertionError("{} passes its check ({:.3g} of the bound)".format(fault, ratio))
    return lines


def _ms_check(torch, mode, feature, state_dict, train):
    """`mode`'s widened step of MS_FORMS[mode] seeds: 2 eager warm-up steps,
    then MS_CHECK_REPLAYS replays of the captured step, each seed held
    against a single-seed executor stepped from that seed's slice of the
    state on the same batches; then one replay with the second seed's rate
    dropped tenfold (a plateau drop), held the same way, with no second
    capture. The launch counts of the capture must be one seed's step's.
    Returns the record and the phase's launches."""
    import numpy as np

    from multistgraph_tpu_torch.executor.executor import GRAPH_WARMUP_STEPS
    from multistgraph_tpu_torch.executor.optimizers import load_optimizer_state, set_learning_rate
    from multistgraph_tpu_torch.parallel.multiseed import MultiSeedTrainer, protocol_seeds

    seeds = protocol_seeds(MS_FORMS[mode])
    trainer = MultiSeedTrainer(_executor(torch, mode, feature, state_dict), seeds)
    if not trainer.graphs_train:
        raise AssertionError("{}: the multi-seed step is not captured".format(mode))
    perm = _seed_perm(train, len(seeds), GRAPH_WARMUP_STEPS + MS_CHECK_REPLAYS + 1)
    lrs = [LEARNING_RATE] * len(seeds)
    set_learning_rate(trainer.optimizer, lrs)
    _reset_counts()
    trainer.train_steps(train, perm[:GRAPH_WARMUP_STEPS], tuple(lrs))
    eager = _read_counts()
    one_step = GRAPH_CAPTURED[mode]
    if {k: v for k, v in eager.items() if v} != {k: GRAPH_WARMUP_STEPS * v for k, v in one_step.items()}:
        raise AssertionError("{}: {} eager widened steps launched {}".format(mode, GRAPH_WARMUP_STEPS, eager))
    def single_seed(i):
        model_state, opt_state = trainer.seed_state(i)
        ref = _executor(torch, mode, feature, model_state)
        load_optimizer_state(ref.optimizer, opt_state)
        ref.dropout_generator.set_state(trainer.generators[i].get_state())
        return ref

    refs = [single_seed(i) for i in range(len(seeds))]
    # the planted fault: the first seed's single-seed steps with the second
    # half of each batch replaced by its first half (half the batch left out)
    faulty = single_seed(0)
    start = [[p.detach().clone() for p in m.parameters()] for m in trainer.model.members]
    rows = perm[GRAPH_WARMUP_STEPS: GRAPH_WARMUP_STEPS + MS_CHECK_REPLAYS]
    got = trainer.train_steps(train, rows, tuple(lrs))
    graph = trainer.graphs["train"]
    if {k: v for k, v in _named(graph.captured).items() if v} != one_step:
        raise AssertionError("{}: the captured widened step recorded {}, one seed's step {}".format(
            mode, graph.captured, one_step))
    want = torch.stack([torch.stack([ref.train_step(ref.batch(train, idx)) for idx in rows[:, i]])
                        for i, ref in enumerate(refs)], dim=1)
    gaps = [_seed_gaps(torch, trainer, i, ref, got[:, i], want[:, i], start[i]) for i, ref in enumerate(refs)]
    half = B // 2
    want_faulty = torch.stack([faulty.train_step(faulty.batch(train, np.concatenate([idx[:half], idx[:half]])))
                               for idx in rows[:, 0]])
    faulty_gaps = _seed_gaps(torch, trainer, 0, faulty, got[:, 0], want_faulty, start[0])
    del faulty
    # the second seed's plateau drop: its rate alone, read by the same
    # graph, one step from one state (each seed's parameters and Adam's
    # state copied in place from its single-seed run: the graph reads them)
    with torch.no_grad():
        for member, ref in zip(trainer.model.members, refs):
            for p, q in zip(member.parameters(), ref.model.parameters()):
                p.copy_(q)
                for key, value in trainer.optimizer.state.get(p, {}).items():
                    value.copy_(ref.optimizer.state[q][key])
    before = [[p.detach().clone() for p in m.parameters()] for m in trainer.model.members]
    ref_before = [[p.detach().clone() for p in ref.model.parameters()] for ref in refs]
    dropped = list(lrs)
    dropped[1] *= 0.1
    set_learning_rate(trainer.optimizer, dropped)
    got_drop = trainer.train_steps(train, perm[-1:], tuple(dropped))
    if trainer.graphs["train"] is not graph:
        raise AssertionError("{}: a rate drop captured the step again".format(mode))
    want_drop = []
    for i, ref in enumerate(refs):
        set_learning_rate(ref.optimizer, dropped[i])
        want_drop.append(ref.train_step(ref.batch(train, perm[-1, i])))
    drop_gaps, update_ratio = [], []
    for i, ref in enumerate(refs):
        drop_gaps.append(_seed_gaps(torch, trainer, i, ref, got_drop[0, i], want_drop[i], before[i]))
        step = max(float((p.detach() - q).abs().max()) for p, q in zip(trainer.model.members[i].parameters(),
                                                                       before[i]))
        ref_step = max(float((p.detach() - q).abs().max()) for p, q in zip(ref.model.parameters(), ref_before[i]))
        update_ratio.append(step / ref_step)
    bound = MS_BOUND[mode]
    drop_bound = dict(bound, gradients=MS_GRAD_BOUND[mode])
    if mode in MS_UPDATE_BOUND:
        drop_bound["update"] = MS_UPDATE_BOUND[mode]
    for what, rows_, held in (("replayed steps", gaps, bound), ("rate drop", drop_gaps, drop_bound)):
        for seed, gap in zip(seeds, rows_):
            if not all(gap[k] <= held[k] for k in held):
                raise AssertionError("{} seed {} ({}) against its single-seed step: {} over the bound {}".format(
                    mode, seed, what, gap, held))
    faults_caught = sorted(k for k in bound if faulty_gaps[k] > bound[k])
    if not faults_caught:
        raise AssertionError("{}: the first seed held against single-seed steps on half its batches passes "
                             "every bound: {}".format(mode, faulty_gaps))
    if not all(0.5 < r < 2.0 for r in update_ratio):
        raise AssertionError("{}: after one seed's rate drop, the largest update of each seed over its "
                             "single-seed step's is {}".format(mode, update_ratio))
    window = _plus(eager, _replayed(trainer.graphs.values()))
    record = {"seeds": seeds, "replays": MS_CHECK_REPLAYS + 1, "captured": graph.captured,
              "replayed_launches": graph.replayed_launches(), "bound": bound, "rate_drop_bound": drop_bound,
              "planted_fault_half_batch": {"gaps": faulty_gaps, "over_the_bound": faults_caught},
              "per_seed_gaps": dict(zip(map(str, seeds), gaps)),
              "after_rate_drop": {"rates": dropped, "gaps": dict(zip(map(str, seeds), drop_gaps)),
                                  "largest_update_over_single_seed": update_ratio}}
    return record, window


def _ms_scaling(torch, feature, state_dict, loaders):
    """Replayed int8 steps at S = 1, 2, 4, 8 seeds (MS_TIMED each, after
    the warm-up and the capture) against the single-seed executor's
    replayed step; at each S the captured step and validation forward
    must record one seed's launches (96 + 96 B2/B2t, 96 B2), and one
    replay's device time (S=4: by kernel) holds 192 q8 kernels, beside the
    kernels of MS_KERNEL_GROUPS."""
    import gc
    import statistics as st

    from multistgraph_tpu_torch.executor.executor import GRAPH_WARMUP_STEPS
    from multistgraph_tpu_torch.parallel.multiseed import MultiSeedTrainer, protocol_seeds

    from multistgraph_tpu_torch.executor.optimizers import set_learning_rate

    train, val = loaders
    _reset_counts()
    base = _executor(torch, "int8", feature, state_dict)
    base.train_epoch(_First(train, GRAPH_WARMUP_STEPS + 1), LEARNING_RATE)
    graph = base.graphs["train"]
    perm1 = torch.as_tensor(train.epoch_permutation(), device="cuda")
    single = st.median(_ms_each(torch, lambda i: graph.run(idx=perm1[i]), MS_TIMED))
    window = _plus(_read_counts(), _replayed([graph]))
    record = {"single_seed_replay_ms": single}
    for count in MS_SCALING:
        _reset_counts()
        trainer = MultiSeedTrainer(base, protocol_seeds(count))
        set_learning_rate(trainer.optimizer, [LEARNING_RATE] * count)
        perm = _seed_perm(train, count, GRAPH_WARMUP_STEPS + 1 + MS_TIMED, seed=count)
        trainer.train_steps(train, perm[: GRAPH_WARMUP_STEPS + 1], (LEARNING_RATE,) * count)
        steps = torch.as_tensor(perm[GRAPH_WARMUP_STEPS + 1:], device="cuda")
        g = trainer.graphs["train"]
        ms = st.median(_ms_each(torch, lambda i: g.run(idx=steps[i]), MS_TIMED))
        # the widened validation forward: its first batch eager, then one replay
        trainer.valid_epoch(_Head(val, 2, shuffle=False))
        captured = {name: {k: v for k, v in _named(trainer.graphs[name].captured).items() if v}
                    for name in ("train", "valid")}
        if captured != {"train": GRAPH_CAPTURED["int8"], "valid": MS_FORWARD_CAPTURED}:
            raise AssertionError("{} seeds: the captured widened step and forward recorded {}, one seed's "
                                 "{} and {}".format(count, captured, GRAPH_CAPTURED["int8"], MS_FORWARD_CAPTURED))
        record[str(count)] = {"replay_ms": ms, "ms_per_seed_step": ms / count,
                              "sequential_ms": count * single, "over_sequential": count * single / ms,
                              "captured": captured}
        dev = _device_time(torch, lambda: g.run(idx=steps[0]), ms, by_kernel=True)
        q8 = sum(k["count"] for k in dev["by_kernel"] if "q8_kernel" in k["name"])
        if q8 != 4 * T * NUM_LAYERS:
            raise AssertionError("one {}-seed replay ran {} q8 kernels, one seed's step {}".format(
                count, q8, 4 * T * NUM_LAYERS))
        # the kernels whose count could grow with S outside B2/B2t and B3
        groups = {label: {"count": sum(k["count"] for k in dev["by_kernel"] if marker in k["name"]),
                          "ms": sum(k["ms"] for k in dev["by_kernel"] if marker in k["name"])}
                  for label, marker in MS_KERNEL_GROUPS.items()}
        record[str(count)]["device_time"] = dict(dev, by_kernel=dev["by_kernel"][:12], by_group=groups)
        if count != MS_FORMS["int8"]:
            record[str(count)]["device_time"] = {k: record[str(count)]["device_time"][k]
                                                 for k in ("device_busy_ms", "device_idle_share", "device_ops",
                                                           "by_group")}
        window = _plus(window, _plus(_read_counts(), _replayed(trainer.graphs.values())))
        del trainer, g
        gc.collect()
        torch.cuda.empty_cache()
    return record, window


class _Head:
    """A loader of the first `batches` batches' samples of a split, as
    train_multiseed reads one (each seed shuffles them itself when
    `shuffle`; validation and predict take them in order)."""

    def __init__(self, loader, batches, shuffle):
        self.batch_size, self.shuffle = loader.batch_size, shuffle
        self.num_samples = batches * loader.batch_size
        self.x, self.y = loader.x[: self.num_samples], loader.y[: self.num_samples]

    def __len__(self):
        return self.num_samples // self.batch_size

    def ordered_permutation(self):
        import numpy as np

        return np.arange(self.num_samples).reshape(len(self), self.batch_size)


def _ms_train_multiseed(torch, feature, state_dict, loaders):
    """train_multiseed, the slice's entry point, for one epoch of the int8
    form at MS_FORMS['int8'] seeds (each seed drawn at its own seed) on the
    first MS_EPOCH_BATCHES training batches, validated on the first
    MS_EVAL_BATCHES validation batches; then the trainer's predict, and its
    validation again (all replays: the loop's losses bit for bit). The
    captured train step, validation and predict forwards must record one
    seed's launches. Each seed's saved best checkpoint loads into a
    single-seed executor (its parameters the trainer's, bit for bit, and
    Adam's step count the epoch's) whose validation loss and predictions
    hold the trainer's at the model output's bound (MS_BOUND's loss).
    Returns the record and the trainer's launches."""
    import numpy as np

    from multistgraph_tpu_torch.parallel.multiseed import (
        MultiSeedTrainer, protocol_seeds, seed_cache_path, train_multiseed)

    train, val = loaders
    seeds = protocol_seeds(MS_FORMS["int8"])
    executor = _executor(torch, "int8", feature, state_dict, exp_id="chip_smoke_ms", max_epoch=1,
                         use_early_stop=False)
    for seed in seeds:
        shutil.rmtree(os.path.dirname(os.path.dirname(seed_cache_path(executor.config, seed))), ignore_errors=True)
    small_train, small_val = _Head(train, MS_EPOCH_BATCHES, shuffle=True), _Head(val, MS_EVAL_BATCHES, shuffle=False)
    _reset_counts()
    t0 = time.perf_counter()
    trainer = MultiSeedTrainer(executor, seeds)
    results = train_multiseed(executor, small_train, small_val, seeds, trainer=trainer)
    epoch_s = time.perf_counter() - t0
    preds = trainer.predict(small_val)
    again = trainer.valid_epoch(small_val)
    window = _plus(_read_counts(), _replayed(trainer.graphs.values()))
    captured = {name: {k: v for k, v in _named(g.captured).items() if v} for name, g in trainer.graphs.items()}
    want = {"train": GRAPH_CAPTURED["int8"], "valid": MS_FORWARD_CAPTURED, "predict": MS_FORWARD_CAPTURED}
    if captured != want:
        raise AssertionError("train_multiseed's graphs recorded {}, one seed's {}".format(captured, want))
    loop_val = [r.min_val_loss for r in results]
    if [float(v) for v in again] != loop_val:
        raise AssertionError("a second widened validation pass gives {}, the epoch loop's {}".format(
            again.tolist(), loop_val))
    bound = MS_BOUND["int8"]["loss"]
    per_seed = {}
    for i, (seed, result) in enumerate(zip(seeds, results)):
        if (result.seed != seed or result.best_epoch != 0 or result.stopped_epoch is not None
                or len(result.history) != 1 or result.history[0]["val_loss"] != result.min_val_loss
                or result.checkpoint != seed_cache_path(executor.config, seed)
                or not os.path.exists(result.checkpoint) or not math.isfinite(result.min_val_loss)):
            raise AssertionError("seed {}: train_multiseed's result {}".format(seed, result))
        ref = _executor(torch, "int8", feature, state_dict)
        ref.load_model(result.checkpoint)
        if not all(torch.equal(p, q) for p, q in zip(trainer.model.members[i].parameters(),
                                                     ref.model.parameters())):
            raise AssertionError("seed {}: the saved best parameters are not the trainer's".format(seed))
        steps = {int(st["step"]) for st in ref.optimizer.state.values()}
        if steps != {MS_EPOCH_BATCHES}:
            raise AssertionError("seed {}: the saved Adam state counts {} steps".format(seed, steps))
        want_val, want_pred = ref._valid_epoch(small_val), ref.predict(small_val)
        gaps = {"valid_loss": _rel_gap(torch, result.min_val_loss, want_val),
                "predictions": _rel_gap(torch, preds[i], want_pred)}
        if not (np.isfinite(preds[i]).all() and preds[i].shape == want_pred.shape
                and all(v <= bound for v in gaps.values())):
            raise AssertionError("seed {}: the widened validation and predict against the single-seed "
                                 "executor's on the saved state: {} over the bound {}".format(seed, gaps, bound))
        per_seed[str(seed)] = dict(gaps, val_loss=result.min_val_loss, train_loss=result.history[0]["train_loss"],
                                   single_seed_val_loss=want_val)
        del ref
    record = {"seeds": seeds, "train_batches": MS_EPOCH_BATCHES, "eval_batches": MS_EVAL_BATCHES,
              "epoch_s": epoch_s, "captured": captured, "bound": bound, "per_seed": per_seed,
              "predictions_shape": list(preds.shape)}
    return record, window


def _ms_quantized_serving(torch, feature, state_dict, x_all):
    """PredictService(quantize='int8' | 'bfloat16') on the f32 model: each
    bucket captured and replayed (replies bit for bit), held against the
    unquantized service by JAX's bound (relative L1 < 1%,
    tests/test_serving_quantized.py), the stored bytes, and the latency
    graphed and eager."""
    import numpy as np

    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.models import get_model
    from multistgraph_tpu_torch.ops.quantize import quantized_nbytes
    from multistgraph_tpu_torch.serving import PredictService

    args = dict(_serving_args(os.path.join(WORK, "raw_data")), **_MODES["f32"])
    cfg = load_config("traffic_state_pred", "MultiATGCN", "SYN_DC237", other_args=args)

    def service(quantize):
        model = get_model(cfg, feature)
        model.load_state_dict(state_dict)
        return PredictService(model, feature["scaler"], max_batch=B, ct_visit_mstd=feature["ct_visit_mstd"],
                              quantize=quantize)

    full = service(None)
    want = {b: full.predict(x_all[:b]) for b in BUCKETS}
    full_bytes = full.stats()["param_bytes"]
    large = {name for name, p in full.params.items() if p.numel() >= 256}
    record, replays = {}, dict.fromkeys(_counters(), 0)
    _reset_counts()
    for quantize, ratio_range in (("int8", (3.9, 4.0)), ("bfloat16", (2.0, 2.0))):
        svc = service(quantize)
        rows = {}
        for b in BUCKETS:
            first, again = svc.predict(x_all[:b]), svc.predict(x_all[:b])   # the capture, then a replay
            if not np.array_equal(first, again):
                raise AssertionError("{} service: replayed reply at bucket {} differs from the eager one".format(
                    quantize, b))
            rel = float(np.abs(again - want[b]).mean() / max(np.abs(want[b]).mean(), 1e-9))
            if not rel < 0.01:
                raise AssertionError("{} weight-only replies at bucket {}: relative L1 {:.4%}".format(
                    quantize, b, rel))
            graphed = _bucket_ms(svc, x_all[:b], GRAPH_TIMED)
            svc.graphed = False
            eager = _bucket_ms(svc, x_all[:b], GRAPH_TIMED)
            svc.graphed = True
            rows[str(b)] = {"rel_l1_vs_unquantized": rel, "graphed_ms": graphed, "eager_ms": eager}
        stats = svc.stats()
        large_ratio = (sum(full.params[n].numel() * 4 for n in large)
                       / quantized_nbytes({n: svc.params[n] for n in large}))
        if (stats["quantize"] != quantize or stats["compiled_buckets"] != list(BUCKETS)
                or sorted(svc.graphs) != sorted(BUCKETS) or stats["param_bytes"] >= full_bytes
                or not ratio_range[0] <= large_ratio <= ratio_range[1]):
            raise AssertionError("{} service: stats {}, {} bytes unquantized, {:.4f}x on tensors of >= 256 "
                                 "elements".format(quantize, stats, full_bytes, large_ratio))
        record[quantize] = {"buckets": rows, "param_bytes": stats["param_bytes"], "unquantized_bytes": full_bytes,
                            "bytes_ratio_tensors_of_256_or_more": large_ratio,
                            "device_time_bucket_16": _device_share(torch, svc, x_all, rows[str(B)]["graphed_ms"])}
        replays = _plus(replays, _replayed(svc.graphs.values()))
    return record, _plus(_read_counts(), replays)


def multiseed_phase(torch, feature, state_dict, loaders):
    """Multi-seed training at the flagship width (parallel/multiseed.py):
    B2/B2t at S*N nodes and B3 at the widened f32 stacks against their
    plain versions; the int8 form at 4 seeds and the f32 form at 2, each
    seed of the replayed widened step held against single-seed steps, one
    seed's rate drop without a second capture, and exact launch counts
    (one seed's step's, at any S); train_multiseed for one epoch, its
    validation and predict held against single-seed executors loaded from
    its checkpoints; replayed steps at S = 1, 2, 4, 8 against sequential
    single-seed replays; bench.py --multiseed 4 --quant-stream; and the
    quantized service. Returns the kernel rows and the launches."""
    from multistgraph_tpu_torch import bench
    from multistgraph_tpu_torch.ops import node_apply

    train, val = loaders
    lines = _ms_rows(torch, node_apply, torch.Generator(device="cuda").manual_seed(2))
    windows, record = {}, {}
    for mode in MS_FORMS:
        record[mode], windows["multiseed " + mode] = _ms_check(torch, mode, feature, state_dict, train)
        say(json.dumps({"multiseed check": mode, **record[mode]}))
    record["train_multiseed"], windows["multiseed train_multiseed"] = _ms_train_multiseed(
        torch, feature, state_dict, loaders)
    say(json.dumps({"multiseed train_multiseed": record["train_multiseed"]}))
    record["scaling"], windows["multiseed scaling"] = _ms_scaling(torch, feature, state_dict, loaders)
    say(json.dumps({"multiseed int8 replayed steps by seeds": record["scaling"]}))
    record["bench"] = bench.main(["--multiseed", str(MS_FORMS["int8"]), "--quant-stream", "--work-dir", WORK,
                                  "--timed-epochs", str(MS_BENCH_EPOCHS)])
    record["quantized serving"], windows["quantized serving"] = _ms_quantized_serving(
        torch, feature, state_dict, val.x[:B].cpu().numpy())
    say(json.dumps({"quantized serving": record["quantized serving"]}))
    say(json.dumps({"multiseed phase launches": windows}))
    return lines, windows

# ---------------------------------------------------------------- the zoo

ZOO_STEPS = 5            # the graphed executor's first steps: 2 eager warm-ups, then 3 replays
ZOO_EAGER_TIMED = 5      # eager steps timed after the check, beside the 3 held ones
ZOO_VAL_HELD = 8         # validation batches held bit for bit against eager ones
ZOO_TIMED = 10           # replays timed, and graphed requests per bucket
ZOO_BUCKETS = (1, B)     # the service's buckets
ZOO_CHECK_BATCH = 4      # card vs CPU: the first 4 samples of the first training batch
# faults planted in a second card run of these families, each of which must
# fail the hold: the GRU's z and r halves swapped; MTGNN's learned graph
# keeping k - 1 neighbours a row (its top-k threshold one place late)
ZOO_FAULTS = ("GRU", "MTGNN")
# Card vs CPU in f32 (TF32 off), the relative max error (over the CPU's
# max |value|) of the model-space output and loss, and of each gradient,
# at the same weights (seed 0) and batch. Read on an H100: outputs at most
# 1.1e-6 and losses 1.4e-7 in every family; gradients at most 1.9e-6 but
# AGCRN's (7.7e-6, its weight pools), STTN's (2.2e-5, b1_tffn_w1) and
# ASTGCN's (8.9e-4, b1_tat_u1). Those three lose as much to f32 rounding
# on the CPU alone ("cpu_f32_vs_f64" of zoo_check_phase: 5.9e-6 for AGCRN,
# 3.2e-3 for ASTGCN, whose attention softmaxes cancel and whose block-0
# gradients pass through block 1). Each bound is 5-8x its reading; the
# planted faults read 7e-2 (GRU) and 0.44 (MTGNN).
BOUND_ZOO_OUT = 5e-6
BOUND_ZOO_GRAD = 5e-6
BOUND_ZOO_GRAD_OF = {"AGCRN": 4e-5, "STTN": 1.5e-4, "ASTGCN": 5e-3}


def _zoo_args(raw_dir, name):
    """The DC-237 windows of bench.py's series for the zoo: 24 steps in and
    out, batch 16, the time of day as a second feature; every model key
    at the family's defaults."""
    return {"data_dir": raw_dir, "output_dir": os.path.join(WORK, "outputs"), "exp_id": "zoo_" + name,
            "cache_dataset": False, "input_window": T, "output_window": T, "batch_size": B,
            "load_external": True, "load_dynamic": False, "add_time_in_day": True,
            "train_rate": 0.7, "eval_rate": 0.15, "seed": 0, "tensorboard": False}


def _zoo_run(torch, model, scaler, x, y):
    """The model-space output on x (eval mode), and the model's own loss
    (masked MAE, executor's default) and every gradient of it, on the CPU."""
    from multistgraph_tpu_torch.ops.losses import make_pred_loss

    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        out = model(x)
    loss = make_pred_loss(model, scaler)(model(x), y)
    loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
             for n, p in model.named_parameters()}
    return out.cpu(), loss.detach().cpu(), grads


def _dcrnn_teacher_forced(torch, model, x, targets):
    """DCRNN's rollout with the truth of step t - 1 as step t's input (the
    GO symbol at step 0), written out from the model's cells."""
    b, _, n, _ = x.shape
    states = [x.new_zeros((b, n, model.hidden_dim)) for _ in range(model.num_layers)]
    for inp in x[..., : model.input_dim].permute(1, 0, 2, 3):
        states, _ = model._stack("e", states, inp)
    truth = targets[..., : model.output_dim]
    inputs = torch.cat([torch.zeros_like(truth[:, :1]), truth[:, :-1]], dim=1)
    ys = []
    for step in range(model.output_window):
        states, top = model._stack("d", states, inputs[:, step])
        ys.append(model.linear(top, "proj"))
    return torch.stack(ys, dim=1)


def _zoo_dcrnn_ratios(torch, model, x, y):
    """A forced ratio of 1 against teacher forcing and of 0 against the
    autoregressive forward, bit for bit, on the card."""
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        free = model(x)
        one = model(x, train=True, generator=g, targets=y, tf_ratio=torch.tensor(1.0, device="cuda"))
        zero = model(x, train=True, generator=g, targets=y, tf_ratio=torch.tensor(0.0, device="cuda"))
        forced = _dcrnn_teacher_forced(torch, model, x, y)
    if not torch.equal(one, forced) or not torch.equal(zero, free) or torch.equal(one, free):
        raise AssertionError("DCRNN: tf_ratio 1 / 0 differ from teacher forcing / the autoregressive forward")
    return {"ratio_1_is_teacher_forcing": True, "ratio_0_is_autoregressive": True,
            "teacher_forcing_moves_output": float((one - free).abs().max())}


def _zoo_fault(torch, name):
    """The context under which ZOO_FAULTS' card run of `name` computes."""
    from unittest import mock

    if name == "GRU":
        from multistgraph_tpu_torch.models import baselines

        def swapped(hidden, x_t, wk, wb, _step=baselines.gru_step):
            h = hidden.shape[-1]   # z and r trade places: the gate columns' halves swapped
            return _step(hidden, x_t, torch.cat([wk[:, h: 2 * h], wk[:, :h], wk[:, 2 * h:]], dim=1),
                         torch.cat([wb[h: 2 * h], wb[:h], wb[2 * h:]]))

        return mock.patch.object(baselines, "gru_step", swapped)
    from multistgraph_tpu_torch.models import mtgnn

    def late(e1, e2, w1, w2, alpha, k, _adjacency=mtgnn.learned_adjacency):
        return _adjacency(e1, e2, w1, w2, alpha, k - 1)

    return mock.patch.object(mtgnn, "learned_adjacency", late)


def zoo_phase(torch):
    """The model zoo's ported families on the card, each built through
    load_config -> TrafficStatePointDataset -> get_model -> get_executor at
    its defaults on bench.py's DC-237 series (24 in, 24 out, batch 16):
    5 training steps of the graphed executor (2 eager, 3 replays) held bit
    for bit against 5 eager steps (mean loss, parameters, Adam state),
    graphed validation over the first 8 batches held bit for bit against
    eager and then over the split, 10 timed replays beside 8 eager steps,
    one replay's device time, an evaluation, PredictService at buckets 1
    and 16 (graphed replies against eager ones, bit for bit, and timed),
    the peak memory above what the family found allocated; DCRNN's forced
    ratios. The zoo launches no kernel of
    the port (every launch count stays 0). Returns, per family, what
    zoo_check_phase holds against the CPU."""
    import gc

    import numpy as np

    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.config.defaults import ZOO_MODELS
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.data.dataset import TrafficStatePointDataset
    from multistgraph_tpu_torch.executor import get_executor
    from multistgraph_tpu_torch.executor.executor import GRAPH_WARMUP_STEPS
    from multistgraph_tpu_torch.executor.optimizers import set_learning_rate
    from multistgraph_tpu_torch.models import get_model
    from multistgraph_tpu_torch.serving import PredictService
    from multistgraph_tpu_torch.tools.timing import card

    raw = os.path.join(WORK, "raw_data")
    _reset_counts()
    shared, records, checks = None, {}, {}
    for name in ZOO_MODELS:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()   # what earlier phases (and the windows) still hold
        t_family = time.perf_counter()
        cfg = load_config("traffic_state_pred", name, "SYN_DC237", other_args=_zoo_args(raw, name))
        ds = get_dataset(cfg, device="cuda")
        if not isinstance(ds, TrafficStatePointDataset):
            raise AssertionError("{}: dataset {}".format(name, type(ds).__name__))
        if shared is None:   # one set of windows: every family's data keys are the same
            shared = (ds.cache_file_name, ds.get_data(), ds.get_data_feature())
        elif ds.cache_file_name != shared[0]:
            raise AssertionError("{}'s windows are not the first family's".format(name))
        _, (train, val, test), feature = shared
        state0 = get_model(cfg, feature, device="cpu").state_dict()   # seed 0's weights
        graphed, eager = [get_executor(cfg, get_model(cfg, feature, device="cuda"), feature, device="cuda")
                          for _ in range(2)]
        for ex in (graphed, eager):
            ex.model.load_state_dict(state0)
        if not graphed.graphs_train:
            raise AssertionError("{}: the executor does not capture its train step".format(name))
        lr = cfg.get("learning_rate")
        first = _First(train, ZOO_STEPS)
        got = graphed.train_epoch(first, lr)
        set_learning_rate(eager.optimizer, lr)
        losses = []
        rows = np.concatenate([first.epoch_permutation(), train.epoch_permutation()[:ZOO_EAGER_TIMED]])

        def eager_step(i):
            eager.before_train_step()
            losses.append(eager.train_step(eager.batch(train, rows[i])))

        eager_ms = _ms_each(torch, eager_step, ZOO_STEPS)[GRAPH_WARMUP_STEPS:]
        want = float(torch.stack(losses).mean())
        if got != want or not _same_state(torch, graphed, eager):
            raise AssertionError("{}: replayed steps differ from eager ones (mean loss {} vs {})".format(
                name, got, want))
        # validation: the capture and replays over the first batches against
        # eager ones, then the whole split on the same graph
        head = _First(val, ZOO_VAL_HELD, ordered=True)
        val_graphed, val_eager = graphed._valid_epoch(head), _eager_validation(torch, eager, head)
        if val_graphed != val_eager:
            raise AssertionError("{}: graphed validation {} differs from eager {}".format(
                name, val_graphed, val_eager))
        val_graphed = graphed._valid_epoch(val)
        eager_ms += _ms_each(torch, lambda i: eager_step(ZOO_STEPS + i), ZOO_EAGER_TIMED)
        graph = graphed.graphs["train"]
        perm = torch.as_tensor(train.epoch_permutation(), device="cuda")

        def replay(i):
            graphed.before_train_step()
            graph.run(idx=perm[i % len(perm)])

        replay_ms = _ms_each(torch, replay, ZOO_TIMED)
        ms, ms_eager = statistics.median(replay_ms), statistics.median(eager_ms)
        dev = _device_time(torch, lambda: replay(0), ms)
        result = graphed.evaluate(test)
        if not np.isfinite(result["masked_MAE"]).all():
            raise AssertionError("{}: evaluation {}".format(name, result["masked_MAE"]))

        svc = PredictService(graphed.model, feature["scaler"], max_batch=B)
        ref = PredictService(graphed.model, feature["scaler"], max_batch=B)
        ref.graphed = False
        x_all = val.x[:B].cpu().numpy()
        latency = {}
        for batch in ZOO_BUCKETS:
            want_reply = ref.predict(x_all[:batch])
            for _ in range(2):   # the capture, then a replay
                if not np.array_equal(svc.predict(x_all[:batch]), want_reply):
                    raise AssertionError("{}: graphed reply at bucket {} differs from the eager one".format(
                        name, batch))
            latency[str(batch)] = _bucket_ms(svc, x_all[:batch], ZOO_TIMED)
        if svc.stats()["compiled_buckets"] != list(ZOO_BUCKETS) or not np.isfinite(want_reply).all():
            raise AssertionError("{}: service {}".format(name, svc.stats()))

        idx = torch.as_tensor(train.ordered_permutation()[0][:ZOO_CHECK_BATCH], device="cuda")
        x, y = train.x.index_select(0, idx), train.y.index_select(0, idx)
        check_model = get_model(cfg, feature, device="cuda")
        check_model.load_state_dict(state0)
        card_run = _zoo_run(torch, check_model, feature["scaler"], x, y)
        record = {"eager_ms_per_step": ms_eager, "eager_step_ms": eager_ms,
                  "replayed_ms_per_step": ms, "replay_step_ms": replay_ms, "graph_speedup": ms_eager / ms,
                  "replay_device_busy_ms": dev["device_busy_ms"], "replay_device_idle_share": dev["device_idle_share"],
                  "replay_device_ops": dev["device_ops"], "ms_per_request_by_bucket": latency,
                  "val_loss": val_graphed, "test_masked_MAE_h1": float(result["masked_MAE"][0]),
                  "params": sum(p.numel() for p in check_model.parameters())}
        if name == "DCRNN":
            record["scheduled_sampling"] = _zoo_dcrnn_ratios(torch, check_model, x, y)
        record["peak_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9
        record["seconds"] = time.perf_counter() - t_family
        say(json.dumps({"zoo": name, **record}))
        records[name] = record
        checks[name] = (cfg, feature, state0, (x.cpu(), y.cpu()), card_run)
        if name in ZOO_FAULTS:
            with _zoo_fault(torch, name):
                checks[name] += (_zoo_run(torch, check_model, feature["scaler"], x, y),)
        del graphed, eager, svc, ref, graph, check_model
        gc.collect()
        torch.cuda.empty_cache()
    launched = {k: v for k, v in _read_counts().items() if v}
    say(json.dumps({"zoo kernels": "none: the zoo's families run torch ops only (no Pallas kernel on their "
                                   "JAX path either), so the kernels line holds no zoo row",
                    "port kernel launches in zoo_phase": launched}))
    if launched:
        raise AssertionError("the zoo launched kernels of the port: {}".format(launched))
    summary = {n: {"eager_ms": r["eager_ms_per_step"], "graphed_ms": r["replayed_ms_per_step"],
                   "request_ms": r["ms_per_request_by_bucket"], "peak_gb": r["peak_gb"]} for n, r in records.items()}
    say(json.dumps({"zoo on the card": summary, "card": card()}))
    return checks


def zoo_check_phase(torch, checks):
    """Each family's model-space output, loss and gradients on the card
    against the port on the CPU, at the same weights (seed 0) and batch (4
    samples), f32 (TF32 off) within BOUND_ZOO_OUT and the family's
    gradient bound; the faults planted in ZOO_FAULTS' card runs must fail
    the hold. Beside a gradient bound of the family's own, the CPU's f32
    run against its f64 run."""
    from multistgraph_tpu_torch.models import get_model

    def rel(a, ref):
        e = float((a - ref).abs().max() / ref.abs().max())
        return e if math.isfinite(e) else float("inf")

    def errs(name, card_run, cpu_run):
        """The errors, and the largest of them over its bound."""
        grads = {n: rel(card_run[2][n], g) for n, g in cpu_run[2].items() if g.abs().max() > 0}
        worst = max(grads, key=grads.get)
        e = {"out": rel(card_run[0], cpu_run[0]), "loss": rel(card_run[1], cpu_run[1]),
             "grad": grads[worst], "worst_param": worst}
        e["of_bound"] = max(max(e["out"], e["loss"]) / BOUND_ZOO_OUT,
                            grads[worst] / BOUND_ZOO_GRAD_OF.get(name, BOUND_ZOO_GRAD))
        return e

    readings, failed = {}, []
    for name, (cfg, feature, state0, (x, y), card_run, *fault) in checks.items():
        t0 = time.perf_counter()
        model = get_model(cfg, feature, device="cpu")
        model.load_state_dict(state0)
        cpu_run = _zoo_run(torch, model, feature["scaler"], x, y)
        readings[name] = dict(errs(name, card_run, cpu_run), cpu_s=time.perf_counter() - t0)
        if name in BOUND_ZOO_GRAD_OF:
            # what f32 rounding alone costs these gradients: the CPU's f32 against its f64
            exact = _zoo_run(torch, model.double(), feature["scaler"], x.double(), y.double())
            readings[name]["cpu_f32_vs_f64"] = errs(name, cpu_run, exact)
        if readings[name]["of_bound"] > 1:
            failed.append("{}: card vs CPU over the bounds".format(name))
        if fault:
            readings[name + " (planted fault)"] = errs(name, fault[0], cpu_run)
            if readings[name + " (planted fault)"]["of_bound"] <= 1:
                failed.append("{}: the planted fault passed the hold".format(name))
    say(json.dumps({"zoo card vs cpu": readings, "bounds": {"out": BOUND_ZOO_OUT, "grad": BOUND_ZOO_GRAD,
                                                            **BOUND_ZOO_GRAD_OF}}))
    if failed:
        raise AssertionError("; ".join(failed))



def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from multistgraph_tpu_torch.ops import _cuda
    from multistgraph_tpu_torch.tools.timing import card

    smi = card()
    say(smi)
    say("torch {} cuda {}".format(torch.__version__, torch.version.cuda))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as beside:
        warm = beside.submit(_warm_library_bsr, torch)
        reports = _cuda.build()
        say("kernels built in {:.1f}s".format(time.time() - t0))
        say("torch.sparse's BSR products compiled beside the build in {:.1f}s".format(warm.result()))
    for name in _cuda.SOURCES:
        say("  {}: {}".format(name, _ptxas_summary(reports[name]) if name in reports else "built before this run"))
    # the tensor-core and SIMT f32 kernels of the sources, one by one, and
    # any wgmma the assembler had to serialize
    for name, marker in (("band_spmm", "_tc_kernel"), ("band_probe", "_tc_kernel"), ("bsr_spmm", "_tc_kernel"),
                         ("sampled_matmul", "_tc_kernel"), ("band_spmm", "band_f32_kernel"),
                         ("bsr_spmm", "bsr_spmm_f32_kernel"), ("sampled_matmul", "sampled_f32_kernel"),
                         ("band_spmm", "sampled_f32_kernel"),
                         ("node_factored_t", "_wgmma_kernel"), ("node_factored_t", "_f32_kernel"),
                         ("node_factored", "_f32_kernel"),
                         ("band_probe", "window_dot_kernel"), ("node_apply_q8", "q8_kernel"),
                         ("node_apply_q8_t", "q8_kernel")):
        if name in reports:
            say(json.dumps({"{} {} kernels [name, registers, spill bytes]".format(name, marker.strip("_")):
                            _ptxas_kernels(reports[name], marker)}))
    for name, report in reports.items():
        for line in report.splitlines():
            if "Performance Loss" in line:
                say("  {}: {}".format(name, line.strip()))
                function = re.search(r"function '([^']*)'", line)
                if not (function and any(k in function.group(1) for k in SERIALIZED_WGMMA_QUEUED)):
                    raise AssertionError("ptxas serialized wgmma in {}: {}".format(name, line.strip()))

    phase_s = {}   # seconds each phase took, to keep the run inside its time limit

    def run(name, phase, *args):
        t0 = time.time()
        result = phase(torch, *args)
        phase_s[name] = round(time.time() - t0, 1)
        return result

    lines = run("kernel", kernel_phase)
    lines += run("sparse kernel", sparse_kernel_phase)
    lines += run("sparse bf16 kernel", sparse_bf16_kernel_phase)
    lines += run("sparse f16 kernel", sparse_f16_kernel_phase)
    lines += run("band kernel", band_kernel_phase)
    make_dataset()
    # the training paths are timed before any phase runs a model on the
    # host's CPU, which slows the launching thread afterwards
    windows, feature, state_dict, grad_batch, train_loaders = run("training", training_phase)
    windows["graphs"] = run("graphs", graph_phase, feature, state_dict, train_loaders)
    ms_lines, ms_windows = run("multiseed", multiseed_phase, feature, state_dict, train_loaders)
    lines += ms_lines
    windows.update(ms_windows)
    handles = {}   # the sparse phases' executors and loaders, for their graphs
    for name, phase, args in (("sparse", sparse_phase, ()), ("band", band_phase, ()),
                              ("sparse bf16", sparse_bf16_phase, ("none",)),
                              ("band bf16 adaptive 49k", sparse_bf16_phase, ("band",)),
                              ("sparse f16", sparse_bf16_phase, ("none", "f16")),
                              ("band f16 adaptive 49k", sparse_bf16_phase, ("band", "f16"))):
        result = run(name, phase, *args)
        if name != "band":
            result, handles[name] = result
        windows.update(result)
    windows.update(run("sparse graphs", sparse_graph_phase, handles))
    del handles
    bf16_lines, bf16_windows = run("band bf16 1M", band_bf16_phase)
    lines += bf16_lines
    windows.update(bf16_windows)
    serving_launches, windows["int8 f32 serving"] = run("serving", serving_phase)
    run("gradient", gradient_phase, feature, state_dict, grad_batch)
    windows["serving"] = dict(serving_launches, node_apply_q8_t=0, force_default_layout_bwd=0)
    run("sparse check", sparse_check_phase)
    run("band check", band_check_phase)
    run("band bf16 check", band_bf16_check_phase)
    run("sparse bf16 check", sparse_bf16_check_phase)
    run("sparse f16 check", sparse_bf16_check_phase, "f16")
    harness_lines, windows["node harness"] = run("node harness", node_harness_phase)
    lines += harness_lines
    # the zoo last: every earlier phase runs as it ran before the zoo came
    run("zoo check", zoo_check_phase, run("zoo", zoo_phase))
    say(json.dumps({"phase_seconds": phase_s}))

    kernels = []
    csrc = "multistgraph_tpu_torch/csrc/"
    # (entry, launch counter and rows' name, source, whether the entry is the
    # bf16 band path's): the bf16 band forms count the launches and rows of the
    # 'band bf16' windows (1M, and 49k with the adaptive view) and the rest
    # those of the other paths; the probe kernels launch only in the 1M bf16
    # phase; the bf16 BSR kernels and every f16 kernel have counters of their
    # own (None: every window)
    for entry, name, source, bf16_path in (
            ("node_apply_q8", "node_apply_q8", "node_apply_q8.cu", False),
            ("node_apply_q8_t", "node_apply_q8_t", "node_apply_q8_t.cu", False),
            ("node_apply_q8_f32", "node_apply_q8_f32", "node_apply_q8.cu", False),
            ("node_apply_q8_t_f32", "node_apply_q8_t_f32", "node_apply_q8_t.cu", False),
            ("force_default_layout", "force_default_layout", "layout_copy.cu", False),
            ("force_default_layout_bwd", "force_default_layout_bwd", "layout_copy.cu", False),
            ("bsr_spmm", "bsr_spmm", "bsr_spmm.cu", False),
            ("sampled_matmul", "sampled_matmul", "sampled_matmul.cu", False),
            ("bsr_spmm_bf16", "bsr_spmm_bf16", "bsr_spmm.cu", None),
            ("sampled_matmul_bf16", "sampled_matmul_bf16", "sampled_matmul.cu", None),
            ("bsr_spmm_f16", "bsr_spmm_f16", "bsr_spmm.cu", None),
            ("sampled_matmul_f16", "sampled_matmul_f16", "sampled_matmul.cu", None),
            ("band_spmm", "band_spmm", "band_spmm.cu", False),
            ("band_spmm_packed", "band_spmm_packed", "band_spmm.cu", False),
            ("band_dx", "band_dx", "band_spmm.cu", False),
            ("band_spmm_bf16", "band_spmm", "band_spmm.cu", True),
            ("band_spmm_packed_bf16", "band_spmm_packed", "band_spmm.cu", True),
            ("band_dx_bf16", "band_dx", "band_spmm.cu", True),
            ("band_spmm_f16", "band_spmm_f16", "band_spmm.cu", None),
            ("band_spmm_packed_f16", "band_spmm_packed_f16", "band_spmm.cu", None),
            ("band_dx_f16", "band_dx_f16", "band_spmm.cu", None),
            ("window_dot", "window_dot", "band_probe.cu", True),
            ("band_slab", "band_slab", "band_probe.cu", True),
            ("band_slab_batched", "band_slab_batched", "band_probe.cu", True),
            ("node_factored_apply", "node_factored_apply", "node_factored.cu", False),
            ("node_factored_apply_t", "node_factored_apply_t", "node_factored_t.cu", False),
            ("node_factored_rows", "node_factored_rows", "node_factored.cu", False),
            ("node_dots", "node_dots", "node_dots.cu", False),
            ("node_dots_floor", "node_dots_floor", "stream_read.cu", False),
            ("column_sum_read", "column_sum_read", "stream_read.cu", False),
            ("stream_rate_read", "stream_rate_read", "stream_read.cu", False)):
        rows = [r for r in lines if r["name"] == name and r["main_path"]
                and (bf16_path is None or r.get("bf16_path", False) == bf16_path)]
        launches = sum(w.get(name, 0) for key, w in windows.items()
                       if bf16_path is None or key.startswith("band bf16") == bf16_path)
        if launches == 0 or not rows:
            raise AssertionError("{} was launched no time on the main path, or has no row".format(entry))
        library = [r["library_ms"] for r in rows]
        kernels.append({
            "name": entry, "route": "cuda", "source": csrc + source,
            "replaces": rows[0]["replaces"].split()[0],
            "launches": launches,
            "shapes": [r["shape"] for r in rows],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # one call at each of the main path's shapes, summed
            "ms": sum(r["kernel_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_us"] for r in rows) / 1e3,
            "bound_by": max(rows, key=lambda r: r["bound_us"])["bound_by"],
            "library_ms": None if None in library else sum(library),
        })
        also = sorted({r["replaces"].split()[0] for r in rows} - {kernels[-1]["replaces"]})
        if also:
            kernels[-1]["also_replaces"] = also
        loads = sorted({r["loads"] for r in rows if "loads" in r})
        if loads:  # how the TMA kernels took their operands at the path's shapes
            kernels[-1]["loads"] = loads
    say(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
