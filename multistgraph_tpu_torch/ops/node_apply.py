"""int8 node-conditioned weight apply: kernels B2 (forward) and B2t (transposed).

Counterpart of the int8 part of multistgraph_tpu/ops/node_apply.py. The
AGCN recurrence applies a different (K*I, O) weight matrix to every graph
node. The int8 weight-stream path keeps those expanded per-node weights in
int8 with per-(node, out-channel) absmax scales, and

    out[n,b,o] = (sum_ki hh[n,b,ki] * wq[n,ki,o]) * scale[n,0,o]

is exact dequantized math, since the scale commutes with the (k,i) sum. The
reverse scan applies the transpose to the bf16 cotangent,

    dhh[n,b,ki] = bf16(sum_o bf16(dpre[n,b,o] * scale[n,0,o]) * wq[n,ki,o]).

``node_apply_q8`` and ``node_apply_q8_t`` launch the hand-written CUDA
kernels of csrc/node_apply_q8.cu and csrc/node_apply_q8_t.cu for CUDA
tensors (which replace the Pallas kernels multistgraph_tpu/ops/node_apply.py:
_apply_q8_kernel / node_apply_q8 and _apply_q8_t_kernel / node_apply_q8_t;
the source notes give their bounds on an H100 and their designs) and take
the plain PyTorch versions ``node_apply_q8_plain`` / ``node_apply_q8_t_plain``
only for CPU tensors. There is no fall back from one to the other. Both
kernels walk the batch in tiles, so any batch runs.
"""

import ctypes
import functools

import torch

from multistgraph_tpu_torch.ops import _cuda

_MAX_SMEM = 227 * 1024  # shared memory one block may use on an H100
# Each kernel stages one weight tile and a 32-row batch tile whose size
# grows with the contraction length (KI forward, O transposed):
# 32*4 + 64 bytes per unit of it.
_MAX_CONTRACTION = _MAX_SMEM // (32 * 4 + 64)


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


def node_apply_q8_t_plain(dpre: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the transposed apply, at the Pallas
    kernel's rounding points: bf16(dpre * s) against the widened weights,
    summed in f32, rounded to dpre's dtype."""
    n = dpre.shape[0]
    d = (dpre.float() * scale[:n]).to(torch.bfloat16).float()
    return (d @ wq[:n].float().transpose(1, 2)).to(dpre.dtype)


def _check(name, act, wq, scale, act_axis):
    """act (N,B,X) bfloat16 against wq (Nw,KI,O) int8 and scale (Nw,1,O)
    float32, contiguous, on one device; X is wq's dim `act_axis`."""
    if act.dtype != torch.bfloat16 or wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("{} takes a bfloat16 activation, wq int8, scale float32; got {}, {}, {}".format(
            name, act.dtype, wq.dtype, scale.dtype))
    if act.dim() != 3 or wq.dim() != 3 or scale.dim() != 3:
        raise ValueError("{} takes a rank-3 activation, wq (Nw,KI,O), scale (Nw,1,O)".format(name))
    n = act.shape[0]
    nw, _, o = wq.shape
    if act.shape[2] != wq.shape[act_axis] or nw < n or tuple(scale.shape) != (nw, 1, o):
        raise ValueError("{} shape mismatch: activation {}, wq {}, scale {}".format(
            name, tuple(act.shape), tuple(wq.shape), tuple(scale.shape)))
    if act.shape[2] > _MAX_CONTRACTION:
        raise ValueError("{} takes a contraction of at most {}, got {}".format(
            name, _MAX_CONTRACTION, act.shape[2]))
    if not (act.device == wq.device == scale.device):
        raise ValueError("{} operands lie on different devices".format(name))
    if not (act.is_contiguous() and wq.is_contiguous() and scale.is_contiguous()):
        raise ValueError("{} takes contiguous tensors".format(name))
    if act.device.type not in ("cpu", "cuda"):
        raise ValueError("{} runs on CUDA or CPU tensors, not {}".format(name, act.device))


@functools.cache
def _kernel(name: str, entry: str):
    fn = getattr(_cuda.library(name), entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, entry, act, wq, scale, out):
    n, b, _ = act.shape
    _, ki, o = wq.shape
    with torch.cuda.device(act.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel(name, entry)(act.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                  n, b, ki, o, stream)
    if rc != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(name, rc))


def node_apply_q8(hh: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """out[n,b,o] = (sum_ki hh[n,b,ki] wq[n,ki,o]) * scale[n,0,o]; (N, B, O) f32.

    hh: (N, B, KI) bf16; wq: (Nw, KI, O) int8 and scale: (Nw, 1, O) f32 with
    Nw >= N (rows past N, such as block padding, are ignored). CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise.
    """
    _check("node_apply_q8", hh, wq, scale, act_axis=1)
    if hh.device.type == "cpu":
        return node_apply_q8_plain(hh, wq, scale)
    n, b, _ = hh.shape
    out = torch.empty((n, b, wq.shape[2]), dtype=torch.float32, device=hh.device)
    _launch("node_apply_q8", "node_apply_q8_fwd", hh, wq, scale, out)
    node_apply_q8.launches += 1
    return out


def node_apply_q8_t(dpre: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """dhh[n,b,ki] = bf16(sum_o bf16(dpre[n,b,o] scale[n,0,o]) wq[n,ki,o]); (N, B, KI) bf16.

    dpre: (N, B, O) bf16; wq, scale as ``node_apply_q8`` (Nw >= N). CPU
    tensors take the plain version; CUDA tensors launch the kernel or raise.
    """
    _check("node_apply_q8_t", dpre, wq, scale, act_axis=2)
    if dpre.device.type == "cpu":
        return node_apply_q8_t_plain(dpre, wq, scale)
    n, b, _ = dpre.shape
    out = torch.empty((n, b, wq.shape[1]), dtype=torch.bfloat16, device=dpre.device)
    _launch("node_apply_q8_t", "node_apply_q8_t_bwd", dpre, wq, scale, out)
    node_apply_q8_t.launches += 1
    return out


node_apply_q8.launches = 0
node_apply_q8_t.launches = 0
