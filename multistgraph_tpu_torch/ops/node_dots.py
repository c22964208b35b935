"""Per-node dots over T steps: kernel B11 A of the node-apply design harness.

Counterpart of tools/bench_node_dots.py's variant A (_a_kernel / make_a):
the expanded per-node weights applied at every step of the recurrence,

    out[b, n*O + o] = bf16(sum_ki hh[t, b, n*KI + ki] w[n, ki, o] + s),

each step overwriting out, so the last step's result stays. ``node_dots``
launches csrc/node_dots.cu for CUDA tensors and takes ``node_dots_plain``
only for CPU tensors; there is no fall back from one to the other.
"""

import ctypes
import functools

import torch

from multistgraph_tpu_torch.ops import _cuda

_MAX_SMEM = 227 * 1024
# csrc/node_dots.cu keeps a node's (KI x 192)-column weight tile resident in
# shared memory, streams 64-row activation tiles (four 16-row units) in
# 64-column chunks through a ring of 4 buffers and stages each tile's 64 x
# (192 + 8) results, KI padded to a multiple of 64, bf16, beside the ring's
# mbarriers
_TILE_O, _CHUNK, _STAGES = 192, 64, 4
_FIXED = (_STAGES * 64 * _CHUNK + 64 * (_TILE_O + 8)) * 2 + 2 * _STAGES * 8   # and 8 mbarriers


def _smem(ki: int) -> int:
    return -(-ki // _CHUNK) * _CHUNK * _TILE_O * 2 + _FIXED


# the largest KI whose tiles fit a block's shared memory
_MAX_KI = (_MAX_SMEM - _FIXED) // (_TILE_O * 2) // _CHUNK * _CHUNK


def node_dots_plain(hh: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The last step, the only one that reaches the output: per-node dots of
    bf16 operands summed in f32, plus s, rounded once to bf16."""
    _, b, _ = hh.shape
    np_, ki, o = w.shape
    h = hh[-1].reshape(b, np_, ki).transpose(0, 1).float()
    out = torch.bmm(h, w.float()) + s.reshape(())
    return out.transpose(0, 1).reshape(b, np_ * o).to(torch.bfloat16)


@functools.cache
def _kernel():
    fn = _cuda.library("node_dots").node_dots_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def node_dots(hh: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(B, NP*O) bf16 from hh (T, B, NP*KI) bf16, w (NP, KI, O) bf16 and s
    (1, 1) f32 read on the device. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if hh.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or s.dtype != torch.float32:
        raise TypeError("node_dots takes bf16 hh and w and an f32 scalar; got {}, {}, {}".format(
            hh.dtype, w.dtype, s.dtype))
    if hh.dim() != 3 or w.dim() != 3 or s.numel() != 1:
        raise ValueError("node_dots takes hh (T, B, NP*KI), w (NP, KI, O) and a one-element scalar")
    t, b, width = hh.shape
    np_, ki, o = w.shape
    if width != np_ * ki:
        raise ValueError("node_dots shape mismatch: hh {}, w {}".format(tuple(hh.shape), tuple(w.shape)))
    if _smem(ki) > _MAX_SMEM:
        raise ValueError("node_dots takes KI of at most {}, got {}".format(_MAX_KI, ki))
    if not (hh.device == w.device == s.device) or hh.device.type not in ("cpu", "cuda"):
        raise ValueError("node_dots operands lie on different devices or not on CPU or CUDA")
    if not (hh.is_contiguous() and w.is_contiguous()):
        raise ValueError("node_dots takes contiguous tensors")
    if hh.device.type == "cpu":
        return node_dots_plain(hh, w, s)
    out = torch.empty((b, np_ * o), dtype=torch.bfloat16, device=hh.device)
    with torch.cuda.device(hh.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(hh.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), t, b, np_, ki, o, stream)
    if rc != 0:
        raise RuntimeError("node_dots kernel launch failed: CUDA error {}".format(rc))
    node_dots.launches += 1
    return out


node_dots.launches = 0
