"""Stream read: one kernel for B11 D, B10 and B12's stream rate.

Counterpart of three Pallas kernels that stream arrays through a grid and
write a small output defined by a slice of them:
  * ``node_dots_floor``: tools/bench_node_dots.py's variant D (_d_kernel /
    make_d), the DMA floor of the node-apply harness;
  * ``column_sum_read``: tools/bench_hbm_peak.py's ``pallas_read`` (B10), a
    grid read with a column-sum poke;
  * ``stream_rate_read``: tools/bench_stream_rate.py's multi-stream read.
Each launches csrc/stream_read.cu for CUDA tensors, which reads every byte
of its operands and also returns a checksum: int32 words (one per block)
whose sum mod 2^32 (``checksum_value``) is the sum of all the operands'
32-bit words, as ``checksum_plain`` computes it. CPU tensors take the plain
versions, whose checksum is that sum as one word; there is no fall back
from one to the other. The operands are bf16 arrays of a multiple of 8 elements.
"""

import ctypes
import functools

import torch

from multistgraph_tpu_torch.ops import _cuda

_FLOOR, _COLUMN_SUM, _RATE = 0, 1, 2
_MAX_STREAMS = 8
COLUMNS = 128  # the columns B10's poke sums


def checksum_plain(*arrays: torch.Tensor) -> int:
    """The sum of the arrays' 32-bit words, mod 2^32."""
    return sum(int(a.reshape(-1).view(torch.int32).to(torch.int64).sum()) for a in arrays) % 2 ** 32


def checksum_value(words: torch.Tensor) -> int:
    """A checksum's words summed, mod 2^32."""
    return int(words.to(torch.int64).sum()) % 2 ** 32


def _word(*arrays):
    """checksum_plain of the arrays as one int32 word on their device."""
    v = checksum_plain(*arrays)
    return torch.tensor([v - 2 ** 32 if v >= 2 ** 31 else v], dtype=torch.int32, device=arrays[0].device)


def _floor_slice(hh, w, blk):
    """The last grid step's operands of variant D: hh's first O lanes of
    the last node block at the last step, and the block's first weight row."""
    np_, ki, o = w.shape
    last = (np_ // blk - 1) * blk
    return hh[-1, :, last * ki: last * ki + o], w[last, 0, :], last


def node_dots_floor_plain(hh, w, s, blk):
    h, wr, _ = _floor_slice(hh, w, blk)
    out = ((h.float() + wr.float()) + s.reshape(())).to(torch.bfloat16)
    return out, _word(hh, w)


def column_sum_read_plain(x, s, block_rows):
    """sum over grid steps of (s + the block's column sums), columns < 128."""
    rows, width = x.shape
    cols = x[:, :COLUMNS].float().reshape(rows // block_rows, block_rows, COLUMNS).sum(1)
    return (s.reshape(()) + cols).sum(0, keepdim=True), _word(x)


def stream_rate_read_plain(arrays, s):
    """((s + a_0[-1, 0]) + a_1[-1, 0]) + ... in f32, as (1, W)."""
    acc = s.reshape(()) + arrays[0][-1, 0].float()
    for a in arrays[1:]:
        acc = acc + a[-1, 0].float()
    return acc.reshape(1, -1), _word(*arrays)


@functools.cache
def _lib():
    lib = _cuda.library("stream_read")
    lib.stream_read.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
                                ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.stream_read.restype = ctypes.c_int
    lib.stream_read_max_blocks.argtypes = []
    lib.stream_read_max_blocks.restype = ctypes.c_int
    return lib


@functools.cache
def _max_blocks(device_index):
    """The most blocks a launch on this device uses: the checksum's length."""
    with torch.cuda.device(device_index):
        blocks = _lib().stream_read_max_blocks()
    if blocks < 1:
        raise RuntimeError("stream_read: cannot read the device's multiprocessor count")
    return blocks


def _check(name, arrays, s):
    if len(arrays) < 1 or len(arrays) > _MAX_STREAMS:
        raise ValueError("{} reads 1 to {} arrays, got {}".format(name, _MAX_STREAMS, len(arrays)))
    if any(a.dtype != torch.bfloat16 for a in arrays) or s.dtype != torch.float32 or s.numel() != 1:
        raise TypeError("{} takes bf16 arrays and a one-element f32 scalar".format(name))
    dev = s.device
    if any(a.device != dev for a in arrays) or dev.type not in ("cpu", "cuda"):
        raise ValueError("{} operands lie on different devices or not on CPU or CUDA".format(name))
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("{} takes contiguous tensors".format(name))
    if any(a.numel() % 8 for a in arrays):
        raise ValueError("{} reads whole 16-byte words: each array needs a multiple of 8 elements".format(name))


def _launch(name, mode, arrays, offsets, s, out, rows_out=0, cols_out=0, ld0=0, width=0, grid_count=0.0):
    lib = _lib()
    blocks = _max_blocks(s.device.index if s.device.index is not None else torch.cuda.current_device())
    with torch.cuda.device(s.device):
        words = torch.empty(blocks, dtype=torch.int32, device=s.device)
        count = len(arrays)
        ptrs = (ctypes.c_void_p * count)(*[a.data_ptr() for a in arrays])
        n16 = (ctypes.c_longlong * count)(*[a.numel() // 8 for a in arrays])
        offs = (ctypes.c_longlong * count)(*offsets)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stream_read(mode, ptrs, n16, offs, count, s.data_ptr(), out.data_ptr(), words.data_ptr(),
                             blocks, rows_out, cols_out, ld0, width, grid_count, stream)
    if rc != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(name, rc))
    return words


def node_dots_floor(hh: torch.Tensor, w: torch.Tensor, s: torch.Tensor, blk: int):
    """Variant D: reads all of hh (T, B, NP*KI) and w (NP, KI, O), returns
    ((B, O) bf16, checksum) with out = bf16((hh[T-1, :, L*KI : L*KI + O] +
    w[L, 0, :]) + s), L = NP - blk the last node block's first node."""
    name = "node_dots_floor"
    _check(name, (hh, w), s)
    if hh.dim() != 3 or w.dim() != 3:
        raise ValueError("{} takes hh (T, B, NP*KI) and w (NP, KI, O)".format(name))
    t, b, width = hh.shape
    np_, ki, o = w.shape
    if width != np_ * ki or blk < 1 or np_ % blk or o > blk * ki:
        raise ValueError("{} shape mismatch: hh {}, w {}, blk {}".format(name, tuple(hh.shape), tuple(w.shape), blk))
    if hh.device.type == "cpu":
        return node_dots_floor_plain(hh, w, s, blk)
    _, _, last = _floor_slice(hh, w, blk)
    out = torch.empty((b, o), dtype=torch.bfloat16, device=hh.device)
    words = _launch(name, _FLOOR, (hh, w), ((t - 1) * b * width + last * ki, last * ki * o), s, out,
                    rows_out=b, cols_out=o, ld0=width)
    node_dots_floor.launches += 1
    return out, words


def column_sum_read(x: torch.Tensor, s: torch.Tensor, block_rows: int):
    """B10: reads all of x (rows, width), returns ((1, 128) f32, checksum)
    with out = (rows / block_rows) s + sum_r x[r, :128]: the TPU grid of
    rows / block_rows steps, each adding s and its block's column sums. The
    kernel tiles the rows its own way and adds in another order. width is a
    power of two from 128 to 2048."""
    name = "column_sum_read"
    _check(name, (x,), s)
    if x.dim() != 2:
        raise ValueError("{} takes a rank-2 array".format(name))
    rows, width = x.shape
    if width < COLUMNS or width > 2048 or width & (width - 1) or block_rows < 1 or rows % block_rows:
        raise ValueError("{} takes a power-of-two width in [128, 2048] and rows a multiple of block_rows; "
                         "got {} rows, width {}, block_rows {}".format(name, rows, width, block_rows))
    if x.device.type == "cpu":
        return column_sum_read_plain(x, s, block_rows)
    out = torch.zeros((1, COLUMNS), dtype=torch.float32, device=x.device)
    words = _launch(name, _COLUMN_SUM, (x,), (0,), s, out, width=width, grid_count=float(rows // block_rows))
    column_sum_read.launches += 1
    return out, words


def stream_rate_read(arrays, s: torch.Tensor):
    """B12's stream rate: reads all of n arrays of one shape (grid, rows,
    W), returns ((1, W) f32, checksum) with out = s + sum_r a_r[grid-1, 0, :]
    in that order."""
    name = "stream_rate_read"
    arrays = tuple(arrays)
    _check(name, arrays, s)
    shape = arrays[0].shape
    if len(shape) != 3 or any(a.shape != shape for a in arrays):
        raise ValueError("{} takes arrays of one shape (grid, rows, W)".format(name))
    grid, rows, width = shape
    if s.device.type == "cpu":
        return stream_rate_read_plain(arrays, s)
    out = torch.empty((1, width), dtype=torch.float32, device=s.device)
    off = (grid - 1) * rows * width
    words = _launch(name, _RATE, arrays, (off,) * len(arrays), s, out, cols_out=width)
    stream_rate_read.launches += 1
    return out, words


node_dots_floor.launches = 0
column_sum_read.launches = 0
stream_rate_read.launches = 0
