"""Node-conditioned weight apply: kernels B1, B1t (factored), B2, B2t (int8).

Counterpart of multistgraph_tpu/ops/node_apply.py. The AGCN recurrence
applies a different (K*I, O) weight matrix W[n] = sum_d e[n,d] pool[d] to
every graph node.

The factored form never expands the weights:

    out[b,n,o]   = sum_d e[n,d] sum_{k,i} hh[b,k,n,i] poolmat[k,i,d*O+o]      (B1)
    dhh[b,k,n,i] = sum_{d,o} T(e[n,d] dpre[b,n,o]) poolmat_t[k,d*O+o,i]    (B1t)

with ``pool_to_kernel_layout`` giving the two pool matrices, the gate
folded in. ``node_factored_apply`` and ``node_factored_apply_t`` launch
csrc/node_factored.cu and csrc/node_factored_t.cu for CUDA tensors (they
replace the Pallas kernels _apply_kernel / node_factored_apply and
_apply_t_kernel / node_factored_apply_t; both run bf16 operands on the
tensor cores and f32 operands in the expanded order, the per-node weights
formed on chip; ``planted_fault`` plants a fault in B1t's and in B1's f32
one) and take the plain versions for CPU tensors. No model path of the JAX
package launches them: their caller is the node-apply design harness (tools/bench_node_dots.py),
whose factored variant ``node_factored_rows`` runs on B1's kernel too. They have no VJP, as
in JAX: B1t is the transpose a hand-written BPTT would call.

The int8 weight-stream path keeps the expanded per-node weights in int8
with per-(node, out-channel) absmax scales, and

    out[n,b,o] = (sum_ki hh[n,b,ki] * wq[n,ki,o]) * scale[n,0,o]

is exact dequantized math, since the scale commutes with the (k,i) sum. The
reverse scan applies the transpose to the cotangent,

    dhh[n,b,ki] = T(sum_o bf16(dpre[n,b,o] * scale[n,0,o]) * wq[n,ki,o]),

T the cotangent's dtype (the default of JAX's ``out_dtype``, the only one
its model asks for). As in JAX, the activation may be any float the model
computes in: bf16, f32 or f16, each contracted in full against the int8
weights with f32 sums.

``node_apply_q8`` and ``node_apply_q8_t`` launch the hand-written CUDA
kernels of csrc/node_apply_q8.cu and csrc/node_apply_q8_t.cu for CUDA
tensors (which replace the Pallas kernels _apply_q8_kernel / node_apply_q8
and _apply_q8_t_kernel / node_apply_q8_t) and take the plain PyTorch
versions ``node_apply_q8_plain`` / ``node_apply_q8_t_plain`` only for CPU
tensors. Both run on the tensor cores (csrc/node_apply_q8.cuh: the int8
weights widened to bf16 on chip, the batch on wgmma's N; an f32 or f16
activation split on chip into the bf16 pieces that hold it exactly, B2t's
rounded to bf16 after its scale as in JAX) and walk the contraction through
a ring and the batch in tiles, so any contraction and any batch run; each
activation dtype counts its launches apart (``launches`` for bf16,
``launches_f32``, ``launches_f16``); ``planted_q8_fault`` plants a fault in
either.

There is no fall back from a kernel to its plain version; the source notes
give each kernel's bound on an H100 and its design.
"""

import contextlib
import ctypes
import functools

import torch

from multistgraph_tpu_torch.ops import _cuda

_MAX_SMEM = 227 * 1024  # shared memory one block may use on an H100
# B2 and B2t (csrc/node_apply_q8.cuh) stream any contraction through a
# ring and walk any number of (64-row tile, batch tile, node) items with
# persistent blocks; their C entries take each dimension as an int.
_MAX_DIM = 2 ** 31 - 1


def quantize_node_weights(w: torch.Tensor):
    """(N, KI, O) float -> ((N, KI, O) int8, (N, 1, O) f32 scales).

    Symmetric absmax per (node, output channel). The scale is computed in
    w's dtype and then widened to f32, as the JAX package computes it.
    """
    a = w.abs().amax(dim=1, keepdim=True)
    scale = (torch.clamp_min(a, 1e-12) / 127.0).float()
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def _pad_nodes(a: torch.Tensor, axis: int, n_pad: int) -> torch.Tensor:
    """Zero-pad `axis` to length n_pad."""
    extra = n_pad - a.shape[axis]
    if extra == 0:
        return a
    shape = list(a.shape)
    shape[axis] = extra
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def node_apply_q8_plain(hh: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: (hh @ wq) * scale in f32, hh of any
    float dtype widened to f32 (exact), as the Pallas kernel computes it."""
    n = hh.shape[0]
    return (hh.float() @ wq[:n].float()) * scale[:n]


def node_apply_q8_t_plain(dpre: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the transposed apply, at the Pallas
    kernel's rounding points for dpre of any float dtype: bf16(dpre * s)
    formed in f32, against the widened weights, summed in f32, cast to
    dpre's dtype."""
    n = dpre.shape[0]
    d = (dpre.float() * scale[:n]).to(torch.bfloat16).float()
    return (d @ wq[:n].float().transpose(1, 2)).to(dpre.dtype)


# the activation dtypes B2 and B2t take (B2t writes its own), by their code in
# the kernels' C entries (csrc/node_apply_q8.cuh), and the launch counter
# of each activation dtype's form
_Q8_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
_Q8_COUNTERS = {torch.bfloat16: "launches", torch.float32: "launches_f32", torch.float16: "launches_f16"}


def _check(name, act, wq, scale, act_axis):
    """act (N,B,X) bfloat16, float32 or float16 against wq (Nw,KI,O) int8
    and scale (Nw,1,O) float32, contiguous, on one device; X is wq's dim
    `act_axis`."""
    if act.dtype not in _Q8_TYPES or wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("{} takes a bfloat16, float32 or float16 activation, wq int8, scale float32; got {}, {}, "
                        "{}".format(name, act.dtype, wq.dtype, scale.dtype))
    if act.dim() != 3 or wq.dim() != 3 or scale.dim() != 3:
        raise ValueError("{} takes a rank-3 activation, wq (Nw,KI,O), scale (Nw,1,O)".format(name))
    n = act.shape[0]
    nw, _, o = wq.shape
    if act.shape[2] != wq.shape[act_axis] or nw < n or tuple(scale.shape) != (nw, 1, o):
        raise ValueError("{} shape mismatch: activation {}, wq {}, scale {}".format(
            name, tuple(act.shape), tuple(wq.shape), tuple(scale.shape)))
    if max(n, act.shape[1], wq.shape[1], o) > _MAX_DIM:
        raise ValueError("{} takes N, B, KI and O of at most {} (the kernel's int arguments), got {}, {}, {}, "
                         "{}".format(name, _MAX_DIM, n, act.shape[1], wq.shape[1], o))
    if not (act.device == wq.device == scale.device):
        raise ValueError("{} operands lie on different devices".format(name))
    if not (act.is_contiguous() and wq.is_contiguous() and scale.is_contiguous()):
        raise ValueError("{} takes contiguous tensors".format(name))
    if act.device.type not in ("cpu", "cuda"):
        raise ValueError("{} runs on CUDA or CPU tensors, not {}".format(name, act.device))


# Faults B2's and B2t's kernels plant on request, for checks that must
# fail them (chip_smoke.py): the contraction's last k16 slice dropped (over
# KI in B2, over O in B2t); B2's batch columns past the first 8 of a tile
# written as zeros.
Q8_FAULTS = {"B2 k16": ("node_apply_q8", 1), "B2t k16": ("node_apply_q8_t", 1),
             "B2 columns": ("node_apply_q8", 2)}
_q8_planted = {}


@contextlib.contextmanager
def planted_q8_fault(kind: str):
    """Launch B2's or B2t's kernel with the fault Q8_FAULTS[kind] planted in
    it while the block runs (CPU tensors then raise: the plain versions
    carry no fault)."""
    name, code = Q8_FAULTS[kind]
    _q8_planted[name] = code
    try:
        yield
    finally:
        _q8_planted.pop(name, None)


def _q8_fault(name, device):
    fault = _q8_planted.get(name, 0)
    if fault and device.type != "cuda":
        raise RuntimeError("{}: a planted fault runs only in the CUDA kernel".format(name))
    return fault


def q8_load_path(ki: int, o: int, transposed: bool = False, dtype: torch.dtype = torch.bfloat16) -> str:
    """How B2's (transposed: B2t's) kernel brings its operands in: the int8
    weights by TMA where their rows of O are whole 16-byte units, the
    activation (hh, or B2t's dpre) of `dtype` where its rows of KI (O) are
    (8 elements of bf16 or f16, 4 of f32); else by element loads."""
    act = (o if transposed else ki) * dtype.itemsize
    return "weights {}, activations {}".format("TMA" if o % 16 == 0 else "element loads",
                                               "TMA" if act % 16 == 0 else "element loads")


def q8_batch_tile(b: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The batch tile (wgmma's N) B2's and B2t's kernels take for a batch
    of b at activations of `dtype`, read from csrc/node_apply_q8.cuh."""
    return _entry("node_apply_q8", "node_apply_q8_bn", 0, 2, stream=False)(b, _Q8_TYPES[dtype])


def _launch(fn, entry, act, wq, scale, out, fault):
    """Launches B2's or B2t's kernel (`fn` its wrapper) at the activation's
    dtype and counts the launch in that dtype's counter."""
    n, b, _ = act.shape
    _, ki, o = wq.shape
    _launch_entry(fn.__name__, entry, (act.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr()),
                  (n, b, ki, o, 0, fault, _Q8_TYPES[act.dtype]), act.device)
    counter = _Q8_COUNTERS[act.dtype]
    setattr(fn, counter, getattr(fn, counter) + 1)


def node_apply_q8(hh: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """out[n,b,o] = (sum_ki hh[n,b,ki] wq[n,ki,o]) * scale[n,0,o]; (N, B, O) f32.

    hh: (N, B, KI) bf16, f32 or f16, contracted in full (f32 and f16 are not
    rounded to bf16); wq: (Nw, KI, O) int8 and scale: (Nw, 1, O) f32 with
    Nw >= N (rows past N, such as block padding, are ignored). Any KI, O
    and B (each, and N, below 2^31). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise, also where a tensor
    whose rows take TMA (``q8_load_path``) does not start on a 16-byte
    boundary.
    """
    _check("node_apply_q8", hh, wq, scale, act_axis=1)
    fault = _q8_fault("node_apply_q8", hh.device)
    if hh.device.type == "cpu":
        return node_apply_q8_plain(hh, wq, scale)
    n, b, _ = hh.shape
    out = torch.empty((n, b, wq.shape[2]), dtype=torch.float32, device=hh.device)
    _launch(node_apply_q8, "node_apply_q8_fwd_typed", hh, wq, scale, out, fault)
    return out


def node_apply_q8_t(dpre: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """dhh[n,b,ki] = T(sum_o bf16(dpre[n,b,o] scale[n,0,o]) wq[n,ki,o]); (N, B, KI) of T.

    dpre: (N, B, O) of T, bf16, f32 or f16; wq, scale as ``node_apply_q8``
    (Nw >= N). Any KI, O and B (each, and N, below 2^31). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise, also where a
    tensor whose rows take TMA (``q8_load_path``) does not start on a
    16-byte boundary.
    """
    _check("node_apply_q8_t", dpre, wq, scale, act_axis=2)
    fault = _q8_fault("node_apply_q8_t", dpre.device)
    if dpre.device.type == "cpu":
        return node_apply_q8_t_plain(dpre, wq, scale)
    n, b, _ = dpre.shape
    out = torch.empty((n, b, wq.shape[1]), dtype=dpre.dtype, device=dpre.device)
    _launch(node_apply_q8_t, "node_apply_q8_t_bwd_typed", dpre, wq, scale, out, fault)
    return out


node_apply_q8.launches = node_apply_q8.launches_f32 = node_apply_q8.launches_f16 = 0
node_apply_q8_t.launches = node_apply_q8_t.launches_f32 = node_apply_q8_t.launches_f16 = 0


# ---------------------------------------------------------------- factored form (B1, B1t)

_FLOATS = (torch.float32, torch.bfloat16)
# Shared memory of B1's bf16 kernel (csrc/node_factored.cu): its tile's rows
# x K*I activations (K*I padded to a multiple of 64), a ring of 4 pool chunks
# of 64 x (d x columns) bf16, the f32 sums over d of its rows x columns and
# 8 mbarriers; of its tiles (rows, columns, d a chunk), the kernel takes one
# that fits. B1's f32 kernel (a 4-stage ring of 16-row chunks of the
# contraction, 8 d a piece, and one chunk's W) and B1t's keep shared memory
# that does not grow with their dimensions: any K*I.
_WG_CHUNK, _WG_STAGES = 64, 4
_WG_TILES = ((192, 32, 5), (128, 48, 4), (128, 32, 4), (128, 16, 8))


def _wg_smem(ki, rows, cols, dg):
    kic = -(-ki // _WG_CHUNK) * _WG_CHUNK
    return (rows * kic + _WG_STAGES * _WG_CHUNK * dg * cols) * 2 + rows * cols * 4 + 2 * _WG_STAGES * 8


def _factored_smem(ki):
    """Shared memory of B1's bf16 kernel at K*I = ki, its smallest tile."""
    return min(_wg_smem(ki, *tile) for tile in _WG_TILES)


@functools.cache
def factored_max_ki(dtype: torch.dtype) -> int:
    """The largest K*I that node_factored_apply takes in `dtype`: in bf16
    the most whose activations fit a block's shared memory beside the ring
    (576); in f32 any that the kernel's int arguments hold."""
    if dtype == torch.bfloat16:
        return max(ki for ki in range(_WG_CHUNK, 4096, _WG_CHUNK) if _factored_smem(ki) <= _MAX_SMEM)
    return _MAX_DIM


# B1t in bf16 (csrc/node_factored_t.cu, tensor cores) holds its rows' dpre
# as register fragments, 16 k16 slices at most.
_FACTORED_T_MAX_O_BF16 = 256
# Faults the factored kernels plant on request, for checks that must fail
# them (chip_smoke.py): the d = 0 term dropped; the contraction's last k16
# slice dropped (in B1t's f32 form the 16 o holding the last, in B1's f32
# form the last 16-row chunk of (k, i)). B1's f32 form also takes
# B1_FAULTS' "rank": cluster rank 0's partial left out of the sums (where
# its tile splits the chunks over a cluster; B1t's kernels plant nothing
# for it). B1's bf16 kernel plants none.
FAULTS = {"d": 1, "k16": 2}
B1_FAULTS = dict(FAULTS, rank=3)
_planted = 0


@contextlib.contextmanager
def planted_fault(kind: str):
    """Launch B1t's kernel (either form) and B1's f32 kernel with the fault
    B1_FAULTS[kind] planted in them while the block runs (CPU tensors take
    the plain versions, which carry none)."""
    global _planted
    code = B1_FAULTS[kind]
    _planted = code
    try:
        yield
    finally:
        _planted = 0


def factored_t_max_o(dtype: torch.dtype) -> int:
    """The largest O that node_factored_apply_t takes in `dtype`: 256 in
    bf16 (dpre in registers); in f32 any O the kernel's int arguments hold
    (it walks O in chunks of 16)."""
    return _FACTORED_T_MAX_O_BF16 if dtype == torch.bfloat16 else _MAX_DIM


def factored_t_load_path(i: int) -> str:
    """How B1t's bf16 kernel brings pool_t in at width I: by TMA where its
    rows are whole 16-byte units, else by element loads."""
    return "TMA" if i % 8 == 0 else "element loads"


def factored_t_tile(b: int, k: int, n: int, i: int, dtype: torch.dtype = torch.bfloat16, o: int = 0) -> str:
    """The tile B1t's kernel takes at these dimensions on this card, read
    from csrc/node_factored_t.cu: in bf16 rows x k a block; in f32 nodes x
    columns of (k, i) a block and the blocks of a cluster that split O
    between them (which reads O)."""
    if dtype == torch.bfloat16:
        fn = _entry("node_factored_t", "node_factored_t_tile", 0, 4, stream=False)
        return ("128x2", "128x1", "64x2", "64x1")[fn(b, k, n, i)]
    return factored_t_f32_tile_name(_entry("node_factored_t", "node_factored_t_f32_tile", 0, 5, stream=False)(
        b, k, n, i, o))


def factored_tile(b: int, k: int, n: int, i: int, o: int) -> str:
    """The tile B1's f32 kernel takes at these dimensions on this card, read
    from csrc/node_factored.cu: 16 nodes x 32 o x 16 b a block, the chunks
    of (k, i) split over the blocks of a cluster."""
    return factored_f32_tile_name(_entry("node_factored", "node_factored_f32_tile", 0, 5, stream=False)(
        b, k, n, i, o))


def factored_f32_tile_name(code: int) -> str:
    """The name of B1's f32 tile `code` (node_factored_fwd_tile's tile
    argument for f32 operands, 0 .. 3: the chunks split over 2^code blocks)."""
    return "16x32, chunks over {}".format(1 << code)


def factored_load_path(i: int, o: int) -> str:
    """How B1's f32 kernel brings its operands in: the pool's rows of O and
    hh's of I each by TMA where they are whole 16-byte units, else by 4-byte
    cp.async (16-byte aligned tensors assumed, as the wrapper's are)."""
    return "pool {}, hh {}".format("TMA" if o % 4 == 0 else "cp.async", "TMA" if i % 4 == 0 else "cp.async")


def factored_t_f32_tile_name(code: int) -> str:
    """The name of B1t's f32 tile `code` (node_factored_t_bwd_tile's tile
    argument for f32 operands, 0 .. 3: O split over 2^code blocks)."""
    return "16x32, O over {}".format(1 << code)


def pool_to_kernel_layout(pool: torch.Tensor, gate: torch.Tensor = None):
    """(D, K, I, O) parameter pool -> ((K, I, D*O), (K, D*O, I)) kernel mats.

    gate: optional (K,) per-support scale folded into the pool. A pure
    permute, reshape and scale, so the pool's gradient flows through
    autograd.
    """
    d, kk, ii, oo = pool.shape
    if gate is not None:
        pool = pool * gate[None, :, None, None]
    mat = pool.permute(1, 2, 0, 3).reshape(kk, ii, d * oo).contiguous()
    mat_t = pool.permute(1, 0, 3, 2).reshape(kk, d * oo, ii).contiguous()
    return mat, mat_t


def node_factored_apply_plain(hh: torch.Tensor, e: torch.Tensor, poolmat: torch.Tensor) -> torch.Tensor:
    """The plain version of B1 at the Pallas kernel's rounding points: e
    widened to f32, r = sum_k hh[k] @ pool[k] summed in f32, then
    sum_d e[:, d] r_d; (B, N, O) f32."""
    b, _, n, _ = hh.shape
    dd = e.shape[1]
    r = torch.einsum("bkni,kic->bnc", hh.float(), poolmat.float())
    return torch.einsum("nd,bndo->bno", e.float(), r.reshape(b, n, dd, -1))


def node_factored_apply_t_plain(dpre: torch.Tensor, e: torch.Tensor, poolmat_t: torch.Tensor,
                                out_dtype: torch.dtype = None) -> torch.Tensor:
    """The plain version of B1t at the Pallas kernel's rounding points:
    q = e.to(dpre.dtype) * dpre formed in dpre's dtype (bf16 rounds there),
    the dot summed in f32, cast to out_dtype (dpre's dtype by default)."""
    b, n, _ = dpre.shape
    q = e.to(dpre.dtype)[None, :, :, None] * dpre[:, :, None, :]
    dhh = torch.einsum("bnc,kci->bkni", q.reshape(b, n, -1).float(), poolmat_t.float())
    return dhh.to(out_dtype or dpre.dtype)


def node_factored_rows_plain(hh_rows: torch.Tensor, e_rows: torch.Tensor, pool: torch.Tensor,
                             s: torch.Tensor) -> torch.Tensor:
    """The plain version of the harness's factored variant: its last step,
    the only one that reaches the output (the kernel computes every step
    and overwrites); bf16(sum_d e_rows[:, d] r_d + s), r = hh @ pool in f32."""
    rows, dd = e_rows.shape
    r = hh_rows[-1].float() @ pool.float()
    acc = torch.einsum("rd,rdo->ro", e_rows.float(), r.reshape(rows, dd, -1))
    return (acc + s.reshape(())).to(torch.bfloat16)


def _check_same_place(name, *tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("{} operands lie on different devices".format(name))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("{} runs on CUDA or CPU tensors, not {}".format(name, dev))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("{} takes contiguous tensors".format(name))


def _check_factored(name, act, e, mat, act_rank, mat_rank=3):
    """act (act_rank dims) and the pool mat (mat_rank dims) in one dtype,
    f32 or bf16, and e (N, D) f32 or bf16, contiguous, on one device."""
    if act.dtype not in _FLOATS or mat.dtype != act.dtype or e.dtype not in _FLOATS:
        raise TypeError("{} takes the activation and the pool in one dtype, float32 or bfloat16, and a "
                        "float32 or bfloat16 e; got {}, {}, {}".format(name, act.dtype, mat.dtype, e.dtype))
    if act.dim() != act_rank or e.dim() != 2 or mat.dim() != mat_rank:
        raise ValueError("{} takes a rank-{} activation, e (N, D) and a rank-{} pool".format(
            name, act_rank, mat_rank))
    _check_same_place(name, act, e, mat)


def _factored_shapes(name, n_act, n_e, dd, d_o, ki_act, ki_mat):
    if n_act != n_e or dd == 0 or d_o % dd != 0 or ki_act != ki_mat:
        raise ValueError("{} shape mismatch: N {} vs {}, D {} against D*O {}, K*I {} vs {}".format(
            name, n_act, n_e, dd, d_o, ki_act, ki_mat))
    return d_o // dd


@functools.cache
def _entry(name: str, entry: str, pointers: int, ints: int, stream: bool = True):
    fn = getattr(_cuda.library(name), entry)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p] * stream
    fn.restype = ctypes.c_int
    return fn


def _launch_entry(name, entry, pointers, ints, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(name, entry, len(pointers), len(ints))(*pointers, *ints, stream)
    if rc != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(name, rc))


def _fwd(hh, e, pool, s, out, steps, b, kk, n, ii, dd, oo):
    _launch_entry("node_factored", "node_factored_fwd",
                     (hh.data_ptr(), e.data_ptr(), pool.data_ptr(), None if s is None else s.data_ptr(),
                      out.data_ptr()),
                     (steps, b, kk, n, ii, dd, oo, int(hh.dtype == torch.bfloat16),
                      int(out.dtype == torch.bfloat16)), hh.device)


def node_factored_apply(hh: torch.Tensor, e: torch.Tensor, poolmat: torch.Tensor) -> torch.Tensor:
    """out[b,n,o] = sum_{d,k,i} e[n,d] hh[b,k,n,i] poolmat[k,i,d*O+o]; (B, N, O) f32.

    hh: (B, K, N, I) and poolmat: (K, I, D*O) in one dtype, f32 or bf16;
    e: (N, D) f32 or bf16, widened to f32. Any N: the kernel masks the
    ragged node edge; K*I up to ``factored_max_ki`` (in f32 any). CPU
    tensors take the plain version; CUDA tensors launch the kernel (f32
    operands: in the expanded order, with a fault of ``planted_fault``) or
    raise.
    """
    name = "node_factored_apply"
    _check_factored(name, hh, e, poolmat, 4)
    b, kk, n, ii = hh.shape
    dd = e.shape[1]
    oo = _factored_shapes(name, n, e.shape[0], dd, poolmat.shape[2], kk * ii,
                          poolmat.shape[0] * poolmat.shape[1])
    if poolmat.shape[:2] != (kk, ii):
        raise ValueError("{} shape mismatch: hh {}, poolmat {}".format(name, tuple(hh.shape), tuple(poolmat.shape)))
    if kk * ii > factored_max_ki(hh.dtype):
        raise ValueError("{} takes K*I of at most {}, got {}".format(name, factored_max_ki(hh.dtype), kk * ii))
    if hh.device.type == "cpu":
        return node_factored_apply_plain(hh, e, poolmat)
    out = torch.empty((b, n, oo), dtype=torch.float32, device=hh.device)
    if hh.dtype == torch.float32:
        _launch_entry("node_factored", "node_factored_fwd_f32",
                      (hh.data_ptr(), e.float().contiguous().data_ptr(), poolmat.data_ptr(), out.data_ptr()),
                      (b, kk, n, ii, dd, oo, -1, _planted), hh.device)
    else:
        _fwd(hh, e.float().contiguous(), poolmat, None, out, 1, b, kk, n, ii, dd, oo)
    node_factored_apply.launches += 1
    return out


def node_factored_apply_t(dpre: torch.Tensor, e: torch.Tensor, poolmat_t: torch.Tensor,
                          out_dtype: torch.dtype = None) -> torch.Tensor:
    """dhh[b,k,n,i] = sum_{d,o} T(e[n,d] dpre[b,n,o]) poolmat_t[k,d*O+o,i]; (B, K, N, I).

    dpre: (B, N, O) and poolmat_t: (K, D*O, I) in one dtype T, f32 or bf16;
    e: (N, D), cast to T first as JAX casts it; the result in out_dtype
    (f32 or bf16, T by default). O up to ``factored_t_max_o(T)``. CPU
    tensors take the plain version; CUDA tensors launch the kernel or raise.
    """
    name = "node_factored_apply_t"
    _check_factored(name, dpre, e, poolmat_t, 3)
    out_dtype = out_dtype or dpre.dtype
    if out_dtype not in _FLOATS:
        raise TypeError("{} writes float32 or bfloat16, not {}".format(name, out_dtype))
    b, n, oo = dpre.shape
    kk, d_o, ii = poolmat_t.shape
    dd = e.shape[1]
    if n != e.shape[0] or d_o != dd * oo:
        raise ValueError("{} shape mismatch: dpre {}, e {}, poolmat_t {}".format(
            name, tuple(dpre.shape), tuple(e.shape), tuple(poolmat_t.shape)))
    if oo > factored_t_max_o(dpre.dtype):
        raise ValueError("{} takes O of at most {} in {}, got {}".format(
            name, factored_t_max_o(dpre.dtype), dpre.dtype, oo))
    if dpre.device.type == "cpu":
        return node_factored_apply_t_plain(dpre, e, poolmat_t, out_dtype)
    out = torch.empty((b, kk, n, ii), dtype=out_dtype, device=dpre.device)
    _launch_entry("node_factored_t", "node_factored_t_bwd_tile",
                     (dpre.data_ptr(), e.to(dpre.dtype).contiguous().data_ptr(), poolmat_t.data_ptr(),
                      out.data_ptr()),
                     (b, kk, n, ii, dd, oo, int(dpre.dtype == torch.bfloat16),
                      int(out_dtype == torch.bfloat16), -1, _planted), dpre.device)
    node_factored_apply_t.launches += 1
    return out


def node_factored_rows(hh_rows: torch.Tensor, e_rows: torch.Tensor, pool: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """The node-apply harness's factored variant on B1's kernel; (R, O) bf16.

    out[r,o] = bf16(sum_d e_rows[r,d] sum_ki hh_rows[t,r,ki] pool[ki,d*O+o] + s)
    for every step t, each overwriting out, so the last step's stays (the
    TPU grid of tools/bench_node_dots.py:make_b revisits its output block at
    every step). hh_rows: (T, R, KI) and pool: (KI, D*O) bf16; e_rows: (R, D)
    f32 or bf16; s: (1, 1) f32, read on the device. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.
    """
    name = "node_factored_rows"
    _check_factored(name, hh_rows, e_rows, pool, 3, mat_rank=2)
    if hh_rows.dtype != torch.bfloat16 or s.dtype != torch.float32 or s.numel() != 1:
        raise TypeError("{} takes bf16 rows and pool and a one-element f32 scalar".format(name))
    steps, rows, ki = hh_rows.shape
    dd = e_rows.shape[1]
    oo = _factored_shapes(name, rows, e_rows.shape[0], dd, pool.shape[1], ki, pool.shape[0])
    _check_same_place(name, hh_rows, s)
    if ki > factored_max_ki(hh_rows.dtype):
        raise ValueError("{} takes KI of at most {}, got {}".format(name, factored_max_ki(hh_rows.dtype), ki))
    if hh_rows.device.type == "cpu":
        return node_factored_rows_plain(hh_rows, e_rows, pool, s)
    out = torch.empty((rows, oo), dtype=torch.bfloat16, device=hh_rows.device)
    _fwd(hh_rows, e_rows.float().contiguous(), pool, s, out, steps, 1, 1, rows, ki, dd, oo)
    node_factored_rows.launches += 1
    return out


node_factored_apply.launches = 0
node_factored_apply_t.launches = 0
node_factored_rows.launches = 0
