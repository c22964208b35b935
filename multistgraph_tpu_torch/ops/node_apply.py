"""int8 node-conditioned weight apply (kernel B2, forward).

Counterpart of the int8 part of multistgraph_tpu/ops/node_apply.py. The
AGCN recurrence applies a different (K*I, O) weight matrix to every graph
node. The int8 weight-stream path keeps those expanded per-node weights in
int8 with per-(node, out-channel) absmax scales, and

    out[n,b,o] = (sum_ki hh[n,b,ki] * wq[n,ki,o]) * scale[n,0,o]

is exact dequantized math, since the scale commutes with the (k,i) sum.

``node_apply_q8`` launches the hand-written CUDA kernel of
csrc/node_apply_q8.cu for CUDA tensors (which replaces the Pallas kernel
multistgraph_tpu/ops/node_apply.py: _apply_q8_kernel / node_apply_q8; the
source note there gives its bound on an H100 and its design) and takes the
plain PyTorch version ``node_apply_q8_plain`` only for CPU tensors. There
is no fall back from one to the other.
"""

import ctypes
import functools

import torch

from multistgraph_tpu_torch.ops import _cuda

_MAX_SMEM = 227 * 1024  # shared memory one block may use on an H100


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
    """The plain PyTorch version: (hh @ wq) * scale in f32."""
    n = hh.shape[0]
    return (hh.float() @ wq[:n].float()) * scale[:n]


def _check(hh, wq, scale):
    if hh.dtype != torch.bfloat16 or wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("node_apply_q8 takes hh bfloat16, wq int8, scale float32; got {}, {}, {}".format(
            hh.dtype, wq.dtype, scale.dtype))
    if hh.dim() != 3 or wq.dim() != 3 or scale.dim() != 3:
        raise ValueError("node_apply_q8 takes hh (N,B,KI), wq (Nw,KI,O), scale (Nw,1,O)")
    n, _, ki = hh.shape
    nw, ki_w, o = wq.shape
    if ki_w != ki or nw < n or tuple(scale.shape) != (nw, 1, o):
        raise ValueError("node_apply_q8 shape mismatch: hh {}, wq {}, scale {}".format(
            tuple(hh.shape), tuple(wq.shape), tuple(scale.shape)))
    if not (hh.device == wq.device == scale.device):
        raise ValueError("node_apply_q8 operands lie on different devices")
    if not (hh.is_contiguous() and wq.is_contiguous() and scale.is_contiguous()):
        raise ValueError("node_apply_q8 takes contiguous tensors")


@functools.cache
def _kernel():
    lib = _cuda.library("node_apply_q8")
    lib.node_apply_q8_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.node_apply_q8_smem_bytes.restype = ctypes.c_size_t
    fn = lib.node_apply_q8_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def node_apply_q8(hh: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """out[n,b,o] = (sum_ki hh[n,b,ki] wq[n,ki,o]) * scale[n,0,o]; (N, B, O) f32.

    hh: (N, B, KI) bf16; wq: (Nw, KI, O) int8 and scale: (Nw, 1, O) f32 with
    Nw >= N (rows past N, such as block padding, are ignored). CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise.
    """
    _check(hh, wq, scale)
    if hh.device.type == "cpu":
        return node_apply_q8_plain(hh, wq, scale)
    if hh.device.type != "cuda":
        raise ValueError("node_apply_q8 runs on CUDA or CPU tensors, not {}".format(hh.device))
    n, b, ki = hh.shape
    o = wq.shape[2]
    lib = _kernel()
    smem = lib.node_apply_q8_smem_bytes(b, ki)
    if smem > _MAX_SMEM:
        raise ValueError("node_apply_q8: B={} x KI={} needs {} bytes of shared memory, over {}".format(
            b, ki, smem, _MAX_SMEM))
    out = torch.empty((n, b, o), dtype=torch.float32, device=hh.device)
    with torch.cuda.device(hh.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.node_apply_q8_fwd(hh.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                   n, b, ki, o, stream)
    if rc != 0:
        raise RuntimeError("node_apply_q8 kernel launch failed: CUDA error {}".format(rc))
    node_apply_q8.launches += 1
    return out


node_apply_q8.launches = 0
