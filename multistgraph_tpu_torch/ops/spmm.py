"""Block-sparse SpMM and SDDMM with autograd: kernels B4/B6 and B5.

Counterpart of multistgraph_tpu/ops/spmm.py on the plain BSR form
(ops/bsr.py). Two kernels carry every sparse product of the SparseATGCN
path, forward and backward:

  * ``bsr_spmm``: Y = A X with A in BSR form, the hand-written CUDA kernel
    of csrc/bsr_spmm.cu. It replaces both Pallas SpMM kernels of the JAX
    package, multistgraph_tpu/ops/spmm.py:_spmm_blockgrid (B4) and
    multistgraph_tpu/ops/spmm_stream.py:spmm_stream (B6), which compute the
    same function and between which JAX chooses by a TPU alignment rule;
  * ``sampled_matmul``: (A B^T) at the graph's nonzero blocks, the
    hand-written CUDA kernel of csrc/sampled_matmul.cu, which replaces
    multistgraph_tpu/ops/spmm.py:_sampled_matmul_impl (B5). Its second
    operand comes as rows (n_pad, d), so no caller passes a strided view.

``bsr_spmm`` runs every row block's tiles in segments of at most
SEGMENT_TILES tiles, one thread block each, from a schedule that
``bsr_schedule`` builds on the tensors' device (no host sync); a split
row's partial sums meet in a workspace and are added in segment order, so
two calls give bit-identical results. The model builds the schedules of
its static patterns and of their block transposes once, at construction
(``bsr_schedule``, ``bsr_transpose_schedule``), and passes them on; a call
without one builds its own.

Each wrapper launches its kernel for CUDA tensors, counts the launch in
``.launches`` (float32 operands), ``.bf16_launches`` or ``.f16_launches``
(bfloat16 or float16 operands, the tensor-core kernels), and raises on what
the kernel does not take; for CPU tensors it takes its plain PyTorch
version (``spmm_plain``, ``sampled_matmul_plain``). There is no fall back
from one to the other: a 16-bit operand on the card launches its own
tensor-core kernel or raises, never the f32 one. ``planted_fault`` plants a
fault in the kernels for the checks that must catch one.

Types, as the JAX package's (spmm.py:90,122-128, spmm_stream.py:306):
float32, bfloat16 or float16 operands of one dtype. ``bsr_spmm`` returns
float32 sums in every case; ``sampled_matmul`` returns bfloat16 tiles for
bf16 operands (the f32 sums rounded once) and float32 otherwise, f16
operands included. Products of two bf16 or two f16 values are exact in
f32, so the kernels and the plain versions (which widen to f32 and sum in
f32) differ only in summation order.

The backward passes close under the same two kernels, term for term as the
JAX custom VJPs (spmm.py:183-206, 234-252, 287-298):
  * d/dX  SpMM  = SpMM with the block-transposed graph;
  * d/dA  SpMM  = sampled_matmul(dY, X) at the graph pattern;
  * d/dE1 SDDMM = SpMM(mask.dS, E2^T);  d/dE2 = SpMM(transpose(mask.dS), E1)^T.
With bf16 x the SpMM's backward rounds dY to bf16 once before both kernels
(JAX spmm.py:193-194, 239-240), and with f16 x to f16 (see _SpMM.backward);
the SDDMM's backward at f16 runs its f32 dS against the embeddings widened
to f32 (see _SDDMMReLU.backward); every term is cast to its primal's dtype.
A term whose input needs no gradient is skipped (``ctx.needs_input_grad``):
XLA drops the same terms from the JAX program, e.g. dA of a static support,
whose values the model stops gradients at.
"""

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from multistgraph_tpu_torch.ops import _cuda

BLOCK = 128  # the kernels' tile edge; the plain versions take any block
DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # operand dtypes of the kernels
# Most tiles one segment of bsr_spmm multiplies: longer row blocks are split
# (the transposed graph's hub rows hold 384 tiles at 49,152 nodes). Chosen
# on an H100 with tools/ab_bsr.py among 8-64 (PERF.md): the only length at
# which both forms' transposed products meet their targets at F = 128 and
# 1536; 24 is within 4% and 16 within 12% of it on every row.
SEGMENT_TILES = 32


def row_ptr_of(row_of: torch.Tensor, num_row_blocks: int) -> torch.Tensor:
    """CSR-of-blocks offsets (num_row_blocks + 1,) int32 of a row-major-sorted
    row index array, on its device (ops/bsr.py:row_ptr_from_rows on the host)."""
    bounds = torch.arange(num_row_blocks + 1, dtype=row_of.dtype, device=row_of.device)
    return torch.searchsorted(row_of, bounds, side="left", out_int32=True)


class BsrSchedule(NamedTuple):
    """bsr_spmm's segment schedule of one pattern: ``segments`` (M, 8) int32
    on the pattern's device, one row per segment (row block, first tile, end
    tile, index in its row, the row's segment count, the row's first
    workspace slot; row -1 pads M to a bound of the shapes), and
    ``ws_slots``, a bound on the workspace slots its split rows use."""

    segments: torch.Tensor
    ws_slots: int


def bsr_schedule(row_ptr: torch.Tensor, nnz: int, seg_tiles: int = SEGMENT_TILES, exact: bool = False) -> BsrSchedule:
    """Cut each row block's tiles [row_ptr[r], row_ptr[r+1]) into segments of
    at most `seg_tiles` tiles (a row with none gets one empty segment, which
    writes its zeros), on row_ptr's device with no host sync. The segments
    are listed longest first, so the card starts the long ones first and no
    hub row's segment is left to run alone at the end; among equals by
    their index in the row, then by row.

    Sizes from the shapes alone: a row of n tiles takes max(1, ceil(n/S))
    <= 1 + floor(n/S) segments, so M = out_blocks + nnz // S rows hold them
    all; a split row (n > S) takes ceil(n/S) <= 2n/(S+1) workspace slots,
    so 2 nnz // (S+1) slots hold every split row's partials. `exact` counts
    the slots instead, with one host sync: for a pattern built once (0 where
    no row is split, which spares each call its workspace and counters)."""
    if seg_tiles < 1:
        raise ValueError("bsr_schedule takes segments of at least one tile, got {}".format(seg_tiles))
    nb = row_ptr.shape[0] - 1
    ws_slots = 2 * nnz // (seg_tiles + 1)
    m = nb + nnz // seg_tiles
    dev = row_ptr.device
    if nb <= 0:
        return BsrSchedule(torch.full((m, 8), -1, dtype=torch.int32, device=dev), 0 if exact else ws_slots)
    ptr = row_ptr.long()
    nseg = ((ptr[1:] - ptr[:-1] + seg_tiles - 1) // seg_tiles).clamp_min(1)
    ends = torch.cumsum(nseg, 0)
    j = torch.arange(m, device=dev)
    row = torch.searchsorted(ends, j, right=True)            # nb past the last segment
    r = row.clamp(max=nb - 1)
    k = j - (ends[r] - nseg[r])
    first = ptr[r] + k * seg_tiles
    end = torch.minimum(first + seg_tiles, ptr[r + 1])
    split = torch.where(nseg > 1, nseg, 0)
    split_start = torch.cumsum(split, 0) - split
    ws_base = torch.where(nseg[r] > 1, split_start[r], -1)
    seg = torch.stack([row, first, end, k, nseg[r], ws_base, torch.zeros_like(k), torch.zeros_like(k)], 1)
    valid = row < nb
    seg = torch.where(valid[:, None], seg, -1)
    # longest first; among equals by index in the row, so the hub rows'
    # k-th segments, which read the same x blocks, run together; padding last
    key = torch.where(valid, (seg_tiles - (end - first)) * m + k, (seg_tiles + 1) * m)
    seg = seg[torch.argsort(key, stable=True)]
    if exact:
        ws_slots = int(split.sum())
    return BsrSchedule(seg.to(torch.int32).contiguous(), ws_slots)


# ----------------------------------------------------------- plain versions
def spmm_plain(values, row_of, col_of, x, block: int = BLOCK, out_blocks=None):
    """Y = A X by gather, batched matmul and index_add_ (JAX spmm_jax,
    spmm.py:142-155), float32: bf16 and f16 operands are widened, so the exact
    products are summed in f32 with no rounding in between; contributions
    are added in nnz order, as the Pallas kernel accumulates them."""
    n_pad, feat = x.shape
    nb = out_blocks if out_blocks is not None else n_pad // block
    contrib = torch.bmm(values.float(), x.reshape(-1, block, feat).index_select(0, col_of).float())
    out = torch.zeros(nb, block, feat, dtype=torch.float32, device=x.device).index_add_(0, row_of, contrib)
    return out.reshape(nb * block, feat)


def sampled_matmul_plain(a, bt, row_of, col_of, block: int = BLOCK):
    """(a @ bt^T) at the nonzero blocks: (nnz, block, block), summed in f32
    and rounded once to bf16 for bf16 operands, float32 otherwise (f16
    operands too, as JAX's kernel emits them, spmm.py:128)."""
    d = a.shape[1]
    ab = a.reshape(-1, block, d).index_select(0, row_of).float()
    bb = bt.reshape(-1, block, d).index_select(0, col_of).float()
    return torch.bmm(ab, bb.transpose(1, 2)).to(_tile_dtype(a.dtype))


def _tile_dtype(dtype):
    """sampled_matmul's output dtype: bf16 for bf16 operands, else f32."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def bsr_transpose(values, row_of, col_of, n_blocks: int):
    """Block transpose: swap row and column, transpose the tiles, re-sort
    row-major (JAX spmm.py:158-167). One gather-copy of the values."""
    key = col_of.long() * n_blocks + row_of.long()
    perm = torch.argsort(key, stable=True)
    v_t = torch.index_select(values.transpose(1, 2), 0, perm).contiguous()
    return v_t, col_of[perm], row_of[perm]


def bsr_transpose_schedule(row_of, col_of, n_blocks: int, exact: bool = False):
    """The row offsets (n_blocks + 1,) and segment schedule of the pattern
    bsr_transpose gives (row_of, col_of), from the pattern alone: its row
    block c holds the tiles of column block c. For a pattern built once,
    `exact` counts the schedule's workspace (one host sync)."""
    ptr_t = row_ptr_of(torch.sort(col_of).values, n_blocks)
    return ptr_t, bsr_schedule(ptr_t, col_of.shape[0], exact=exact)


def bsr_transpose_plan(values, row_of, col_of, n_blocks: int):
    """bsr_transpose with what the backward's dX SpMM needs besides:
    (v_t, r_t, c_t, row_ptr_t, schedule_t), the transposed graph's row
    offsets over n_blocks row blocks and its segment schedule, all on the
    values' device, with no host sync."""
    return (*bsr_transpose(values, row_of, col_of, n_blocks), *bsr_transpose_schedule(row_of, col_of, n_blocks))


# ------------------------------------------------------------ CUDA wrappers
# Faults the kernels plant on request, for checks that must fail them
# (chip_smoke.py): the k16 slice holding the contraction's last element
# dropped; a tile skipped (bsr_spmm: each row block's last; sampled_matmul:
# tile 0); row block 0 zeroed (bsr_spmm: its output rows; sampled_matmul:
# its tiles). Both kernels plant them in every form (f32, bf16, f16);
# bsr_spmm also takes SPMM_FAULTS' "segment": a split row's last segment
# left out of its sum.
FAULTS = {"k16": 1, "tile": 2, "row": 3}
SPMM_FAULTS = dict(FAULTS, segment=4)
_KERNELS = ("bsr_spmm", "sampled_matmul")
_planted = {}


@contextlib.contextmanager
def planted_fault(kind: str, kernel: str = None):
    """Launch the kernels (or only `kernel`, 'bsr_spmm' or 'sampled_matmul')
    with the fault FAULTS[kind] (for bsr_spmm alone also SPMM_FAULTS[kind])
    planted in them while the block runs."""
    global _planted
    if kernel not in (None,) + _KERNELS:
        raise ValueError("planted_fault takes a kernel of {}, got {!r}".format(_KERNELS, kernel))
    if kind not in FAULTS and not (kind in SPMM_FAULTS and kernel == "bsr_spmm"):
        raise ValueError("planted_fault has no fault {!r} for {}".format(kind, kernel or "both kernels"))
    _planted = dict.fromkeys(_KERNELS if kernel is None else (kernel,), SPMM_FAULTS[kind])
    try:
        yield
    finally:
        _planted = {}


def bf16_load_path(feat: int) -> str:
    """How the 16-bit (bf16 and f16) kernels here and in ops/band.py bring in an operand of
    `feat` columns (x, dy, or both of sampled_matmul's): by TMA where its
    rows are whole 16-byte units, else by element loads."""
    return "TMA" if feat % 8 == 0 else "element loads"


@functools.cache
def _kernel(name: str, entry: str, n_ptrs: int, n_ints: int):
    fn = getattr(_cuda.library(name), entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _run(name, entry, tensors, ints, device):
    """Launch `entry` of csrc/<name>.cu on the current stream; a None tensor
    passes a null pointer."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [None if t is None else t.data_ptr() for t in tensors]
        rc = _kernel(name, entry, len(ptrs), len(ints))(*ptrs, *ints, stream)
    if rc != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(name, rc))


@functools.cache
def feature_tile(feat: int, bf16: bool) -> int:
    """The feature columns one bsr_spmm block computes at width `feat` in the
    tensor-core form (`bf16`: bf16 and f16 operands) or the f32 one
    (csrc/bsr_spmm.cu's rule), which sizes a workspace slot."""
    fn = _cuda.library("bsr_spmm").bsr_spmm_feature_tile
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(feat, int(bf16))


def _check_common(name, floats, ints, dtypes=DTYPES):
    """Floating operands of one dtype from `dtypes` and int32 indices,
    contiguous, on one CPU or CUDA device."""
    for t in floats:
        if t.dtype not in dtypes or t.dtype != floats[0].dtype:
            names = [str(d).replace("torch.", "") for d in dtypes]
            allowed = " or ".join([", ".join(names[:-1]), names[-1]] if len(names) > 1 else names)
            raise TypeError("{} takes {} operands of one dtype, got {}".format(
                name, allowed, [str(f.dtype) for f in floats]))
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError("{} takes int32 block indices, got {}".format(name, t.dtype))
    tensors = list(floats) + list(ints)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("{} operands lie on different devices".format(name))
    if tensors[0].device.type not in ("cpu", "cuda"):
        raise ValueError("{} runs on CUDA or CPU tensors, not {}".format(name, tensors[0].device))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("{} takes contiguous tensors".format(name))


def bsr_spmm(values, row_of, row_ptr, col_of, x, out_blocks: int, schedule: BsrSchedule = None):
    """Y = A X: (out_blocks*block, F) float32, for float32, bfloat16 or
    float16 operands.

    values (nnz, block, block), row_of/col_of (nnz,) and row_ptr
    (out_blocks+1,) int32 of a row-major-sorted pattern, x (n_in, F) with
    n_in a multiple of block, values and x of one dtype; `schedule`, the
    pattern's bsr_schedule(row_ptr, nnz) (built here if None). CPU tensors
    take the plain version; CUDA tensors launch csrc/bsr_spmm.cu (block 128;
    its tensor-core kernel for bf16 and f16) or raise. The kernel's split rows meet
    in a workspace and a zeroed counter per (row block, feature tile), both
    allocated here on the current stream.
    """
    _check_common("bsr_spmm", (values, x), (row_of, row_ptr, col_of))
    if values.dim() != 3 or values.shape[1] != values.shape[2] or x.dim() != 2:
        raise ValueError("bsr_spmm takes values (nnz,b,b) and x (n,F), got {} and {}".format(
            tuple(values.shape), tuple(x.shape)))
    nnz, block = values.shape[0], values.shape[1]
    if x.shape[0] % block or tuple(row_of.shape) != (nnz,) or tuple(col_of.shape) != (nnz,) \
            or tuple(row_ptr.shape) != (out_blocks + 1,):
        raise ValueError("bsr_spmm shape mismatch: values {}, row_of {}, row_ptr {}, col_of {}, "
                         "x {}, out_blocks {}".format(tuple(values.shape), tuple(row_of.shape),
                                                      tuple(row_ptr.shape), tuple(col_of.shape),
                                                      tuple(x.shape), out_blocks))
    if x.device.type == "cpu":
        return spmm_plain(values, row_of, col_of, x, block=block, out_blocks=out_blocks)
    if block != BLOCK:
        raise ValueError("the bsr_spmm kernel takes {0}x{0} tiles, got {1}".format(BLOCK, block))
    feat = x.shape[1]
    out = torch.empty((out_blocks * block, feat), dtype=torch.float32, device=x.device)
    if not out.numel():
        return out
    if schedule is None:
        schedule = bsr_schedule(row_ptr, nnz)
    seg = schedule.segments
    if seg.dtype != torch.int32 or seg.dim() != 2 or seg.shape[1] != 8 or seg.device != x.device:
        raise ValueError("bsr_spmm takes a schedule of (M, 8) int32 segments on the operands' device")
    tensor_cores = x.dtype != torch.float32
    tile = feature_tile(feat, tensor_cores)
    tiles = -(-feat // tile)
    ws = counters = None
    if schedule.ws_slots:
        ws = torch.empty(schedule.ws_slots * tiles * block * tile, dtype=torch.float32, device=x.device)
        counters = torch.zeros(out_blocks * tiles, dtype=torch.int32, device=x.device)
    entry, counter = _FORMS[x.dtype]
    _run("bsr_spmm", "bsr_spmm" + entry, (values, col_of, x, out, seg, ws, counters),
         (out_blocks, feat, nnz, x.shape[0], seg.shape[0], _planted.get("bsr_spmm", 0)), x.device)
    setattr(bsr_spmm, counter, getattr(bsr_spmm, counter) + 1)
    return out


def sampled_matmul(a, bt, row_of, col_of):
    """(a @ bt^T) at the nonzero blocks: (nnz, 128, 128), bfloat16 for
    bfloat16 operands and float32 for float32 or float16 ones.

    a (n_a, d) and bt (n_b, d) of one dtype with n_a, n_b multiples of 128;
    row_of and col_of (nnz,) int32 index a's and bt's 128-row blocks. CPU
    tensors take the plain version; CUDA tensors launch
    csrc/sampled_matmul.cu (its tensor-core kernel for bf16 and f16; for f32 the
    sampled kernel of csrc/simt_f32.cuh, which B9 dV shares) or raise.
    """
    _check_common("sampled_matmul", (a, bt), (row_of, col_of))
    if a.dim() != 2 or bt.dim() != 2 or a.shape[1] != bt.shape[1] or a.shape[0] % BLOCK \
            or bt.shape[0] % BLOCK or row_of.shape != col_of.shape or row_of.dim() != 1:
        raise ValueError("sampled_matmul shape mismatch: a {}, bt {}, row_of {}, col_of {}".format(
            tuple(a.shape), tuple(bt.shape), tuple(row_of.shape), tuple(col_of.shape)))
    if a.device.type == "cpu":
        return sampled_matmul_plain(a, bt, row_of, col_of)
    nnz = row_of.shape[0]
    out = torch.empty((nnz, BLOCK, BLOCK), dtype=_tile_dtype(a.dtype), device=a.device)
    if not nnz:
        return out
    entry, counter = _FORMS[a.dtype]
    _run("sampled_matmul", "sampled_matmul" + entry, (a, bt, row_of, col_of, out),
         (nnz, a.shape[1], a.shape[0], bt.shape[0], _planted.get("sampled_matmul", 0)), a.device)
    setattr(sampled_matmul, counter, getattr(sampled_matmul, counter) + 1)
    return out


# each operand dtype's C entry suffix and launch counter
_FORMS = {torch.float32: ("_fwd", "launches"), torch.bfloat16: ("_bf16", "bf16_launches"),
          torch.float16: ("_f16", "f16_launches")}
for _fn in (bsr_spmm, sampled_matmul):
    for _, _counter in _FORMS.values():
        setattr(_fn, _counter, 0)


# ---------------------------------------------------------------- autograd
class _SpMM(torch.autograd.Function):
    """Y = A X; A's tiles and X differentiable. ``graph`` = (row_of, row_ptr,
    col_of, schedule); ``pre_t`` = a precomputed bsr_transpose_plan of A,
    detached, or None to transpose in the backward."""

    @staticmethod
    def forward(ctx, values, x, graph, pre_t, out_blocks):
        row_of, row_ptr, col_of, schedule = graph
        ctx.graph, ctx.pre_t = graph, pre_t
        ctx.x_blocks = x.shape[0] // values.shape[1]
        ctx.dtypes = (values.dtype, x.dtype)
        need_v, need_x = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        ctx.save_for_backward(values if need_x and pre_t is None else None, x if need_v else None)
        return bsr_spmm(values, row_of, row_ptr, col_of, x, out_blocks, schedule)

    @staticmethod
    def backward(ctx, dy):
        values, x = ctx.saved_tensors
        row_of, _, col_of, _ = ctx.graph
        v_dtype, x_dtype = ctx.dtypes
        # With bf16 x, dy is rounded once before both kernels (JAX
        # spmm.py:193-194). With f16 x JAX keeps dy f32, but there dy is the
        # cotangent of the model's cast of this f32 output to f16
        # (sparse_atgcn.py:376), so f16-exact: rounding it loses nothing, and
        # the f16 kernels' exact products with f32 sums are JAX's
        # f32-promoted products.
        dy = dy.to(x_dtype if x_dtype != torch.float32 else dy.dtype).contiguous()
        dvalues = dx = None
        if ctx.needs_input_grad[1]:
            nb = ctx.x_blocks
            pre_t = ctx.pre_t
            if pre_t is None:
                # sort-key multiplier must exceed every row id (rectangular A)
                pre_t = (*bsr_transpose(values, row_of, col_of, max(nb, dy.shape[0] // values.shape[1])),
                         *bsr_transpose_schedule(row_of, col_of, nb))
            v_t, r_t, c_t, ptr_t, sched_t = pre_t
            dx = bsr_spmm(v_t, r_t, ptr_t, c_t, dy, nb, sched_t).to(x_dtype)
        if ctx.needs_input_grad[0]:
            dvalues = sampled_matmul(dy, x, row_of, col_of).to(v_dtype)
        return dvalues, dx, None, None, None


def _graph(row_of, col_of, row_ptr, out_blocks, schedule=None):
    return (row_of, row_ptr if row_ptr is not None else row_ptr_of(row_of, out_blocks), col_of, schedule)


def spmm(values, row_of, col_of, x, block: int = BLOCK, out_blocks=None, row_ptr=None, schedule=None):
    """Y = A X (float32); values (nnz, b, b) and x (padded_nodes, F) of one
    dtype, float32, bfloat16 or float16, row_of/col_of (nnz,) int32 sorted by row.
    Differentiable in values and x. out_blocks
    sets the output's row-block count when it differs from x's; row_ptr, if
    given, is row_ptr_of(row_of, out_blocks), and schedule its
    bsr_schedule (built at each launch on the card if None)."""
    nb = out_blocks if out_blocks is not None else x.shape[0] // block
    return _SpMM.apply(values, x, _graph(row_of, col_of, row_ptr, nb, schedule), None, nb)


def spmm_pret(values, pre_t, row_of, col_of, x, block: int = BLOCK, out_blocks=None, row_ptr=None, schedule=None):
    """``spmm`` with a precomputed block transpose ``pre_t`` steering the
    backward dX pass, so a loop-invariant operand is transposed once per
    forward, not per step: bsr_transpose_plan's (v_t, r_t, c_t, row_ptr_t,
    schedule_t), detached, which leaves the backward nothing to build.
    ``pre_t=None`` (no backward to come) is ``spmm``."""
    nb = out_blocks if out_blocks is not None else x.shape[0] // block
    return _SpMM.apply(values, x, _graph(row_of, col_of, row_ptr, nb, schedule), pre_t, nb)


class _SDDMMReLU(torch.autograd.Function):
    """relu(E1 E2) at the pattern; e1 (n_pad, d), e2 (d, n_pad). The scores
    come in sampled_matmul's dtype (bf16 for bf16 embeddings, f32 for f32
    or f16 ones); dE1 and dE2 are cast to the embeddings' dtypes (JAX
    spmm.py:287-298). ``transpose``
    = (row_ptr_t, schedule_t) of the pattern's block transpose, or None to
    build them in the backward."""

    @staticmethod
    def forward(ctx, e1, e2, graph, transpose, block):
        row_of, _, col_of, _ = graph
        ctx.graph, ctx.transpose, ctx.block = graph, transpose, block
        out = sampled_matmul(e1, e2.t().contiguous(), row_of, col_of).clamp_min_(0.0)
        ctx.save_for_backward(e1, e2, out)
        return out

    @staticmethod
    def backward(ctx, ds):
        e1, e2, out = ctx.saved_tensors
        row_of, row_ptr, col_of, schedule = ctx.graph
        dm = torch.where(out > 0, ds, 0.0)
        n_blocks = e1.shape[0] // ctx.block
        # dM comes in the scores' dtype. For f16 embeddings that is f32 and
        # not f16-exact: JAX's dot promotes the pair to f32, so the
        # embeddings are widened (exactly) and dM is never rounded to f16.
        de1 = de2 = None
        if ctx.needs_input_grad[0]:
            e2t = e2.t().to(dm.dtype).contiguous()
            de1 = bsr_spmm(dm, row_of, row_ptr, col_of, e2t, n_blocks, schedule).to(e1.dtype)
        if ctx.needs_input_grad[1]:
            m_t, r_t, c_t = bsr_transpose(dm, row_of, col_of, n_blocks)
            ptr_t, sched_t = ctx.transpose or bsr_transpose_schedule(row_of, col_of, n_blocks)
            e1w = e1.to(dm.dtype).contiguous()
            de2 = bsr_spmm(m_t, r_t, ptr_t, c_t, e1w, n_blocks, sched_t).t().to(e2.dtype)
        return de1, de2, None, None, None


def sddmm_relu(e1, e2, row_of, col_of, block: int = BLOCK, row_ptr=None, schedule=None, transpose=None):
    """relu(E1 @ E2) at the graph's nonzero blocks -> (nnz, block, block):
    the adaptive-adjacency scores before row normalisation. Differentiable
    in e1 (n_pad, d) and e2 (d, n_pad); `schedule`, the pattern's
    bsr_schedule, steers the backward's dE1, and `transpose`, the
    bsr_transpose_schedule of the pattern (row_ptr_t, schedule_t), its dE2
    (each built in the backward if None)."""
    nb = e1.shape[0] // block
    return _SDDMMReLU.apply(e1, e2, _graph(row_of, col_of, row_ptr, nb, schedule), transpose, block)


# ---------------------------------------------------------------- softmaxes
def _row_sums(per_block_rowsum, row_of, num_row_blocks):
    """segment_sum over the tiles of each row block: (num_row_blocks, block)."""
    zeros = per_block_rowsum.new_zeros(num_row_blocks, per_block_rowsum.shape[1])
    return zeros.index_add(0, row_of, per_block_rowsum)


def sparse_row_softmax(values, row_of, num_row_blocks: int):
    """Row-normalise BSR scores: exp(v) / sum over the row's sampled entries
    with v > 0 (JAX spmm.py:311-331; the deviation from the dense
    reference's softmax is documented there). exp stays in the input dtype,
    the row sums are f32, and the denominator is cast to the input dtype
    before the division, as JAX places the roundings."""
    exp_vals = torch.where(values > 0, torch.exp(values), 0.0)
    totals = _row_sums(exp_vals.sum(dim=2, dtype=torch.float32), row_of, num_row_blocks)
    denom = totals.index_select(0, row_of).clamp_min(1e-9)
    return exp_vals / denom.to(exp_vals.dtype)[:, :, None]


def sparse_row_softmax_dense_corrected(values, row_of, num_row_blocks: int, num_nodes: int):
    """The exact sparse form of the dense softmax(relu(E1 E2)) (JAX
    spmm.py:334-353): (exp(v)-1)/Z_i at the pattern plus the rank-1
    background 1/Z_i, Z_i = N + sum (exp(v)-1), Z in f32. Returns (values,
    background (num_row_blocks, block)), both in the input dtype."""
    expm1 = torch.where(values > 0, torch.expm1(values), 0.0)
    z = num_nodes + _row_sums(expm1.sum(dim=2, dtype=torch.float32), row_of, num_row_blocks)
    return expm1 / z.index_select(0, row_of).to(expm1.dtype)[:, :, None], (1.0 / z).to(expm1.dtype)
